"""Plain-PyTorch restatement of the GNNome edge classifier, its loss and Adam.

The model is the reference's ``GraphGatedGCNModel`` (lvrcek/GNNome-assembly
``models/full_graph.py:11-29``, ``layers/gated_gcn_full.py:99-157``,
``layers/score_predictor.py:5-25``), written from those equations alone,
on the edge list in its own order, with ``index_add_`` sums. For a directed
edge ``j -> i``::

    gate     = B1 h[j] + B2 h[i] + B3 e
    e'       = ReLU(Norm_e(gate)) + e
    s        = sigmoid(e')
    h_fwd[i] = sum_{j->i} s * A2 h[j] / (sum_{j->i} s + 1e-6)
    h_bwd[j] = sum_{j->i} s * A3 h[i] / (sum_{j->i} s + 1e-6)
    h'       = ReLU(Norm_h(A1 h + h_fwd + h_bwd)) + h

``Norm`` is BatchNorm with the batch's own statistics (biased variance,
eps 1e-5) over all edges or nodes, or, with ``batch_norm=False``, LayerNorm
over the features (eps 1e-5). The node encoder is one linear on
``[in_deg | out_deg | PE]``, the edge encoder ``2 -> 16 -> D`` with a ReLU,
and the score head ``ReLU([h_src | h_dst | e] W1 + b1) W2 + b2``.

Parameters are a flat ``{name: tensor}`` with the checkpoint's names
(``layers.3.A1.w``; ``w`` is ``[fan_in, fan_out]``). Each layer is
recomputed in the backward (``torch.utils.checkpoint``) so that a step at
chromosome scale fits beside nothing else on one card.

``bits=k`` rounds both operands of every matrix product to ``k`` stored
significand bits (to nearest) and multiplies them exactly in float32,
forward and backward: what the tensor cores do with inputs of that
precision. ``TF32_BITS`` (10) is the control of a float32 configuration,
the nearest precision below it; ``E4M3_BITS`` (3, fp8 E4M3's significand,
with no limit on the exponent: an ideally scaled fp8 product) that of a
bfloat16 one, the fp8 step below its 7. The comparison has to refuse
both. This file imports nothing of the program.

**The contract of a reference** (``benchmark/reference/__init__.py``
``load``): a configuration's key ``reference`` names a file beside this one,
and its cells, control and FLOP count use that module alone. Each function
takes the configuration's dict as ``model``:

* ``init_params(gen, model, device)``: seeded parameters, a flat
  ``{name: tensor}`` under the program's checkpoint names;
* ``forward(p, graph, model, bits=None, remat=True)``: logits f32[E];
* ``train_step(p, opt, graph, pos_weight, model, bits=None)``: the loss
  (a float) and every leaf's gradient, ``p`` updated by ``opt``; the loss
  through the module's own ``bce_loss``, which the half-batch control
  swaps;
* ``Adam(params, lr)``, ``bce_loss(logits, y, pos_weight)``;
* ``CONTROL_BITS``: ``compute_dtype`` -> the ``bits`` of its control;
* ``exact_f32_products()``: run before the program's set-up;
* ``forward_flops(model, n, e)``: model FLOPs of one forward over ``n``
  real nodes and ``e`` real edges (``benchmark/flops.py`` counts a step as
  three).

Another architecture's reference may import ``Adam``, ``bce_loss`` and the
rounding helpers from this module.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

BN_EPS = LN_EPS = 1e-5
AGG_EPS = 1e-6
LINEARS = ("A1", "A2", "A3", "B1", "B2", "B3")
TF32_BITS, E4M3_BITS = 10, 3
# the control of each compute_dtype: the nearest precision below it
CONTROL_BITS = {"float32": TF32_BITS, "bfloat16": E4M3_BITS}


def exact_f32_products() -> None:
    """Matrix products in full float32 on the card (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_significand(x: torch.Tensor, bits: int) -> torch.Tensor:
    """float32 rounded to the nearest value of ``bits`` stored significand
    bits (the low ``23 - bits`` cleared, half up), the exponent as it is."""
    drop = 23 - bits
    raw = x.contiguous().view(torch.int32)
    return ((raw + (1 << (drop - 1))) & ~((1 << drop) - 1)).view(torch.float32)


class _RoundedMatMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, bits):
        a, b = round_significand(a, bits), round_significand(b, bits)
        ctx.save_for_backward(a, b)
        ctx.bits = bits
        return a @ b

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = round_significand(g, ctx.bits)
        return g @ b.t(), a.t() @ g, None


def _mm(a, b, bits):
    return a @ b if bits is None else _RoundedMatMul.apply(a, b, bits)


def _linear(p, name, x, bits):
    return _mm(x, p[name + ".w"], bits) + p[name + ".b"]


def _batch_norm(x, scale, bias):
    mean = x.mean(0)
    var = ((x - mean) ** 2).mean(0)
    return (x - mean) / torch.sqrt(var + BN_EPS) * scale + bias


def _layer_norm(x, scale, bias):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + LN_EPS) * scale + bias


def _gated_mean(s, rows, key, n):
    num = torch.zeros((n, rows.shape[1]), dtype=rows.dtype, device=rows.device)
    den = torch.zeros_like(num)
    num = num.index_add(0, key, s * rows)
    den = den.index_add(0, key, s)
    return num / (den + AGG_EPS)


def layer(p, prefix, src, dst, h, e, batch_norm: bool, bits):
    """One GatedGCN layer; ``src``/``dst`` int64 [E], ``h`` [N, D], ``e`` [E, D]."""
    n = h.shape[0]
    a1h, a2h, a3h, b1h, b2h = (_linear(p, f"{prefix}.{k}", h, bits) for k in LINEARS[:5])
    gate = b1h[src] + b2h[dst] + _linear(p, f"{prefix}.B3", e, bits)
    norm = _batch_norm if batch_norm else _layer_norm
    e_new = torch.relu(norm(gate, p[f"{prefix}.norm_e.scale"], p[f"{prefix}.norm_e.bias"])) + e
    s = torch.sigmoid(e_new)
    h_fwd = _gated_mean(s, a2h[src], dst, n)
    h_bwd = _gated_mean(s, a3h[dst], src, n)
    h_new = norm(a1h + h_fwd + h_bwd, p[f"{prefix}.norm_h.scale"], p[f"{prefix}.norm_h.bias"])
    return torch.relu(h_new) + h, e_new


def forward(p: dict, graph: dict, model: dict, bits=None, remat: bool = True) -> torch.Tensor:
    """Logits f32[E] in the graph's edge-list order. ``graph``: ``src``,
    ``dst`` (int64 tensors), ``e_feat`` [E, 2], ``pe`` [N, PE + 2];
    ``model``: ``batch_norm`` and ``num_gnn_layers``."""
    batch_norm, n_layers = model["batch_norm"], model["num_gnn_layers"]
    src, dst = graph["src"], graph["dst"]
    h = _linear(p, "linear_pe", graph["pe"], bits)
    e = torch.relu(_linear(p, "linear1_edge", graph["e_feat"], bits))
    e = _linear(p, "linear2_edge", e, bits)
    for i in range(n_layers):
        args = (p, f"layers.{i}", src, dst, h, e, batch_norm, bits)
        if remat and torch.is_grad_enabled():
            h, e = checkpoint(layer, *args, use_reentrant=False)
        else:
            h, e = layer(*args)
    d = h.shape[1]
    w1 = p["score1.w"]
    pre = (_mm(h, w1[:d], bits)[src] + _mm(h, w1[d:2 * d], bits)[dst]
           + _mm(e, w1[2 * d:], bits) + p["score1.b"])
    return _linear(p, "score2", torch.relu(pre), bits)[:, 0]


def bce_loss(logits, y, pos_weight: float) -> torch.Tensor:
    """Mean BCE-with-logits with ``pos_weight`` on the positive terms
    (``torch.nn.BCEWithLogitsLoss(pos_weight=...)``, the reference's
    ``train.py:210-211``)."""
    log_p = torch.nn.functional.logsigmoid(logits)
    log_not_p = torch.nn.functional.logsigmoid(-logits)
    return -(pos_weight * y * log_p + (1.0 - y) * log_not_p).mean()


class Adam:
    """Adam with betas (0.9, 0.999) and eps 1e-8 added to the corrected
    second moment's square root, as ``torch.optim.Adam`` defines it."""

    def __init__(self, params: dict, lr: float, betas=(0.9, 0.999), eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps, self.t = lr, betas[0], betas[1], eps, 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> None:
        self.t += 1
        c1, c2 = 1.0 - self.b1 ** self.t, 1.0 - self.b2 ** self.t
        for k, g in grads.items():
            self.m[k].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            denom = (self.v[k] / c2).sqrt() + self.eps
            params[k].sub_(self.lr * (self.m[k] / c1) / denom)


def train_step(params: dict, opt: Adam, graph: dict, pos_weight: float, model: dict,
               bits=None):
    """One full step on ``graph`` (``y`` among its keys): the loss and the
    gradient of every leaf, after which ``params`` hold Adam's update."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    loss = bce_loss(forward(leaves, graph, model, bits), graph["y"], pos_weight)
    names = list(leaves)
    grads = dict(zip(names, torch.autograd.grad(loss, [leaves[k] for k in names])))
    opt.step(params, grads)
    return float(loss.detach()), grads


def init_params(gen: torch.Generator, model: dict, device) -> dict:
    """Seeded parameters in one large draw on ``device``: weights uniform in
    +-sqrt(3 / fan_in), biases in +-1/sqrt(fan_in) (the program's own
    initialisation), norm scales 1 and biases 0. ``model``: the
    configuration's widths."""
    d, k = model["hidden_features"], model["nb_pos_enc"]
    shapes = {"linear_pe": (k + 2, d),
              "linear1_edge": (model["edge_features"], model["hidden_edge_features"]),
              "linear2_edge": (model["hidden_edge_features"], d)}
    for i in range(model["num_gnn_layers"]):
        shapes.update({f"layers.{i}.{n}": (d, d) for n in LINEARS})
    shapes["score1"] = (3 * d, model["hidden_edge_scores"])
    shapes["score2"] = (model["hidden_edge_scores"], 1)
    sizes = [fi * fo + fo for fi, fo in shapes.values()]
    flat = torch.rand(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    flat = flat * 2 - 1
    params, at = {}, 0
    for (name, (fi, fo)), size in zip(shapes.items(), sizes):
        chunk = flat[at: at + size] / math.sqrt(fi)
        params[name + ".w"] = (chunk[: fi * fo] * math.sqrt(3)).reshape(fi, fo)
        params[name + ".b"] = chunk[fi * fo:].clone()
        at += size
    for i in range(model["num_gnn_layers"]):
        for norm in ("norm_h", "norm_e"):
            params[f"layers.{i}.{norm}.scale"] = torch.ones(d, device=device)
            params[f"layers.{i}.{norm}.bias"] = torch.zeros(d, device=device)
    return params


def forward_flops(model: dict, n: int, e: int) -> int:
    """Model FLOPs of one forward over ``n`` real nodes and ``e`` real edges.

    Only the matrix products count, at 2 operations a multiply-add: per
    layer five node products ``2 N D^2`` (A1, A2, A3, B1, B2) and one edge
    product ``2 E D^2`` (B3); the node encoder ``2 N (PE + 2) D``, the edge
    encoder ``2 E (2 H_e + H_e D)``, and the score head
    ``2 (2 N D S + E D S + E S)`` with ``S`` its hidden width."""
    d, k = model["hidden_features"], model["nb_pos_enc"]
    he, s = model["hidden_edge_features"], model["hidden_edge_scores"]
    layers = model["num_gnn_layers"] * (5 * 2 * n * d * d + 2 * e * d * d)
    encoders = 2 * n * (k + 2) * d + 2 * e * (model["edge_features"] * he + he * d)
    head = 2 * (2 * n * d * s + e * d * s + e * s)
    return layers + encoders + head
