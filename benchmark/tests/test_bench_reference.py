"""The plain reference against a small dense float64 restatement of the
same model (every edge an entry of an N x N table), Adam against
``torch.optim.Adam``, TF32 rounding, and the reference decoder against a
hand-worked graph and the program's own restatement of the reference."""
import numpy as np
import pytest
import torch

from benchmark.reference import compare, decode, model

N, D, K = 9, 8, 4
MODEL = dict(hidden_features=D, nb_pos_enc=K, hidden_edge_features=3, hidden_edge_scores=5,
             edge_features=2, num_gnn_layers=2)


def small_graph(seed=0):
    rng = np.random.default_rng(seed)
    pairs = sorted({(int(a), int(b)) for a, b in rng.integers(0, N, (40, 2)) if a != b})
    src = torch.tensor([a for a, _ in pairs])
    dst = torch.tensor([b for _, b in pairs])
    e = len(pairs)
    return dict(src=src, dst=dst, e_feat=torch.from_numpy(rng.standard_normal((e, 2))),
                pe=torch.from_numpy(rng.standard_normal((N, K + 2))),
                y=torch.from_numpy((rng.random(e) < 0.7).astype(np.float64)))


def params64(seed=0):
    p = model.init_params(torch.Generator().manual_seed(seed), MODEL, "cpu")
    gen = torch.Generator().manual_seed(seed + 1)
    for k in p:  # norms away from 1 / 0 so that they matter
        if ".norm_" in k:
            p[k] = p[k] + 0.3 * torch.randn(p[k].shape, generator=gen)
    return {k: v.double() for k, v in p.items()}


def dense_forward(p, g, batch_norm):
    """The same equations on dense tables: mask[i, j] = 1 for edge j -> i."""
    src, dst = g["src"], g["dst"]
    mask = torch.zeros(N, N, dtype=torch.float64)
    mask[dst, src] = 1.0
    m = mask[..., None]
    ef = torch.zeros(N, N, 2, dtype=torch.float64)
    ef[dst, src] = g["e_feat"]

    def lin(name, x):
        return x @ p[name + ".w"] + p[name + ".b"]

    def norm_e(x, pre):
        if batch_norm:
            mean = (x * m).sum((0, 1)) / mask.sum()
            var = (((x - mean) ** 2) * m).sum((0, 1)) / mask.sum()
            return (x - mean) / torch.sqrt(var + 1e-5) * p[pre + ".scale"] + p[pre + ".bias"]
        mean = x.mean(-1, keepdim=True)
        var = ((x - mean) ** 2).mean(-1, keepdim=True)
        return (x - mean) / torch.sqrt(var + 1e-5) * p[pre + ".scale"] + p[pre + ".bias"]

    def norm_h(x, pre):
        if batch_norm:
            mean = x.mean(0)
            var = ((x - mean) ** 2).mean(0)
        else:
            mean = x.mean(-1, keepdim=True)
            var = ((x - mean) ** 2).mean(-1, keepdim=True)
        return (x - mean) / torch.sqrt(var + 1e-5) * p[pre + ".scale"] + p[pre + ".bias"]

    h = lin("linear_pe", g["pe"])
    e = lin("linear2_edge", torch.relu(lin("linear1_edge", ef)))
    for i in range(MODEL["num_gnn_layers"]):
        q = f"layers.{i}"
        a1, a2, a3, b1, b2 = (lin(f"{q}.{k}", h) for k in ("A1", "A2", "A3", "B1", "B2"))
        gate = b1[None, :, :] + b2[:, None, :] + lin(f"{q}.B3", e)
        e = torch.relu(norm_e(gate, f"{q}.norm_e")) + e
        s = torch.sigmoid(e) * m
        h_fwd = (s * a2[None, :, :]).sum(1) / (s.sum(1) + 1e-6)
        h_bwd = (s * a3[:, None, :]).sum(0) / (s.sum(0) + 1e-6)
        h = torch.relu(norm_h(a1 + h_fwd + h_bwd, f"{q}.norm_h")) + h
    w1 = p["score1.w"]
    pre = (h @ w1[:D])[None, :, :] + (h @ w1[D:2 * D])[:, None, :] + e @ w1[2 * D:] + p["score1.b"]
    scores = lin("score2", torch.relu(pre))[..., 0]
    return scores[dst, src]


@pytest.mark.parametrize("batch_norm", [True, False])
def test_forward_and_gradients_match_dense_f64(batch_norm):
    g, p = small_graph(), params64()
    got = model.forward(p, g, batch_norm, 2)
    want = dense_forward(p, g, batch_norm)
    assert torch.allclose(got, want, rtol=1e-10, atol=1e-10)
    leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    loss = model.bce_loss(model.forward(leaves, g, batch_norm, 2), g["y"], 0.5)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    leaves2 = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    log_p = torch.nn.functional.logsigmoid(dense_forward(leaves2, g, batch_norm))
    log_q = torch.nn.functional.logsigmoid(-dense_forward(leaves2, g, batch_norm))
    loss2 = -(0.5 * g["y"] * log_p + (1 - g["y"]) * log_q).mean()
    grads2 = torch.autograd.grad(loss2, list(leaves2.values()))
    assert torch.allclose(loss, loss2, rtol=1e-12)
    for a, b in zip(grads, grads2):
        assert torch.allclose(a, b, rtol=1e-8, atol=1e-12)


def test_float32_reference_near_f64():
    g, p = small_graph(1), params64(1)
    g32 = {k: (v.float() if v.is_floating_point() else v) for k, v in g.items()}
    got = model.forward({k: v.float() for k, v in p.items()}, g32, True, 2)
    assert torch.allclose(got.double(), dense_forward(p, g, True), rtol=1e-4, atol=1e-5)


def test_adam_matches_torch():
    gen = torch.Generator().manual_seed(3)
    p = {"a": torch.randn(5, 4, generator=gen), "b": torch.randn(3, generator=gen)}
    q = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    ours, theirs = model.Adam(p, 1e-3), torch.optim.Adam(list(q.values()), lr=1e-3)
    for _ in range(3):
        grads = {k: torch.randn(v.shape, generator=gen) for k, v in p.items()}
        ours.step(p, grads)
        for k, v in q.items():
            v.grad = grads[k].clone()
        theirs.step()
    for k in p:
        assert torch.allclose(p[k], q[k].detach(), rtol=1e-6, atol=1e-8)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-10, 1.0 + 3 * 2**-12, -3.14159265])
    r = model.round_significand(x, model.TF32_BITS)
    assert r[0] == 1.0 and r[2] == 1.0 + 2**-10
    assert r[1] == 1.0 + 2**-10  # half way rounds up (away from zero)
    assert r[3] == 1.0 + 2**-10
    assert abs(float(r[4]) + 3.14159265) < 2**-9 * 4
    bits = r.view(torch.int32) & 0x1FFF
    assert int(bits.abs().sum()) == 0


def test_e4m3_rounding():
    """The bf16 cell's control: 3 stored significand bits, to nearest."""
    x = torch.tensor([1.0, 1.0 + 2**-4, 1.0 + 3 * 2**-5, -1.2, 300.0, 1e-30])
    r = model.round_significand(x, model.E4M3_BITS)
    assert r.tolist()[:5] == [1.0, 1.125, 1.125, -1.25, 288.0]  # half way rounds up
    assert int((r.view(torch.int32) & 0xFFFFF).abs().sum()) == 0


def test_training_numbers_worst_leaf():
    theta0 = {"a": torch.zeros(4), "b": torch.zeros(4), "c": torch.zeros(4)}
    ref = dict(losses=[1.0, 0.9, 0.8], grad1={"a": torch.ones(4), "b": 2 * torch.ones(4),
                                                "c": torch.full((4,), 1e-9)},
               theta3={"a": torch.ones(4), "b": torch.ones(4), "c": torch.ones(4)})
    same = compare.training_numbers(ref, ref, theta0)
    assert same["loss_gap"] == same["grad_gap"] == same["change_gap"] == 0.0
    frozen = dict(ref, theta3=theta0)
    assert compare.training_numbers(frozen, ref, theta0)["change_gap"] == 1.0  # c left out
    assert same["grad_cos_gap"] == same["grad_cos_gap_median"] == pytest.approx(0.0, abs=1e-12)
    turned = dict(ref, grad1=dict(ref["grad1"], b=torch.tensor([2.0, -2.0, 2.0, -2.0]),
                                  c=-ref["grad1"]["c"]))
    numbers = compare.training_numbers(turned, ref, theta0)
    assert numbers["grad_cos_gap"] == 1.0  # c left out
    assert numbers["grad_cos_gap_median"] == 0.5  # of a: 0, b: 1


def test_decoder_on_a_chain():
    """Two strands of a 12-read chain with skip edges: one contig, the
    forward strand or its mate, of all 12 reads."""
    edges = [(2 * i, 2 * i + 2) for i in range(11)] + [(2 * i + 3, 2 * i + 1) for i in range(11)]
    edges += [(2 * i, 2 * i + 4) for i in range(10)]
    src = np.array([a for a, _ in edges])
    dst = np.array([b for _, b in edges])
    succs = {i: [] for i in range(24)}
    preds = {i: [] for i in range(24)}
    for a, b in edges:
        succs[a].append(b)
        preds[b].append(a)
    ids = {e: k for k, e in enumerate(edges)}
    scores = np.where([b - a == 2 or a - b == 2 for a, b in edges], 3.0, -3.0)
    walks = decode.get_contigs(src, dst, scores, succs, preds, ids, np.full(len(edges), 100),
                               np.full(24, 1000), nb_paths=5, len_threshold=5, seed=0)
    assert len(walks) == 1 and len(walks[0]) == 12
    assert walks[0] in ([2 * i for i in range(12)], [2 * i + 1 for i in range(11, -1, -1)])


def test_decoder_agrees_with_the_programs_restatement():
    from benchmark.traffic import graphs
    from gnnome_tpu_torch.decode import greedy

    src, dst = graphs.distinct_edges(*graphs.bench_edges(3000, 20000, 5, 0.15), 3000)
    adj = graphs.adjacency_lists(src, dst, 3000)
    lengths = graphs.read_lengths(np.random.default_rng(5), src, 3000)
    scores = np.random.default_rng(6).standard_normal(len(src))
    args = (src, dst, scores, adj["succs"], adj["preds"], adj["edges"],
            lengths["prefix_length"], lengths["read_length"])
    ours = decode.get_contigs(*args, nb_paths=50, len_threshold=20, seed=0)
    theirs = greedy.get_contigs(*args, nb_paths=50, len_threshold=20, seed=0,
                                engine="sequential")
    assert len(ours) > 3 and ours == theirs
