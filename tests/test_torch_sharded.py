"""The port's sharded training step (``gnnome_tpu_torch/parallel/``) on the
CPU: gloo process groups of 2 and 4 ranks, the kernels' plain versions.

Each world runs as separate processes of this file
(``python tests/test_torch_sharded.py <job.json> <rank>``), started
together by a module fixture; the parent meanwhile computes the JAX
package's sharded losses and steps on the 8-device CPU mesh of
``tests/conftest.py``, and the port's single-device references. JAX is
imported only inside the functions that run the JAX side, so a worker
imports none of it. The model is ``tests/test_sharded.py``'s (2 layers,
D = 32) on random graphs of its kind, but of 700-1,800 nodes, so that
every shard owns nodes (``N_pad`` is a multiple of 512·P: at 100 nodes
one shard would own all of them and the halo would be empty) and most
edges cross shards.

Worlds: P = 2 and P = 4 ranks on the graph axis, and data = 2 × graph = 2
(two graphs). Cases: the BatchNorm and the LayerNorm model under remat
``"none"``, ``"layer"`` and ``"unroll_group"`` (``remat_group=2``: one
checkpoint around both layers, whose recompute runs every collective of
both again), and the BatchNorm model in bf16, all at P = 2; at P = 4 the
BatchNorm model under "layer" and the LayerNorm model under
"unroll_group"; at 2 × 2 the BatchNorm model under "layer". JAX's one
sharded step is the BatchNorm model's at P = 2.

Tolerances, and why:
  * losses rtol = atol = 2e-5, as ``tests/test_sharded.py`` holds JAX's
    sharded loss to its single-device loss: the shards sum their edges and
    the all-reduces sum the shards, in another order than one device;
  * gradients per leaf, rtol = atol = 1e-5, and for the leaves summed over
    every edge (the edge encoder, ``B3``, ``norm_e``, the score head)
    rtol = 1e-5, atol = 1e-6·max|ref|: the tolerances
    ``tests/test_torch_train.py`` holds the port's per-op gradients to
    (its ``TOL`` and ``close_all``), for the same reason;
  * one Adam step: ``tests/test_torch_train.py``'s rule (elements whose
    first gradient is within 10·eps of zero, and the biases a BatchNorm
    cancels, are held to lr of their start; the rest to 1e-5);
  * bf16: the port's sharded loss against JAX's sharded loss within the
    bound ``tests/test_torch_bf16.py`` states (BCE is max(1,
    pos_weight)-Lipschitz in each logit, so the loss is within the mean
    |Δlogit|), taken through JAX's single-device bf16 forward:
    |port − JAX sharded| ≤ max(1, pw)·mean|port logits − JAX logits|
    + |JAX single-device − JAX sharded| + 1e-6;
  * P = 1, the halo pair and the replicas: exact.
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1e-3
POS_WEIGHT = 2.0
REMAT_GROUP = 2
NB_POS_ENC = 8
LOSS_TOL = dict(rtol=2e-5, atol=2e-5)
TOL = dict(rtol=1e-5, atol=1e-5)
EDGE_SUMMED = ("['linear1_edge']", "['linear2_edge']", "['B3']", "['norm_e']",
               "['score1']", "['score2']")
CASES = {  # name: (batch_norm, remat, compute_dtype)
    "bn_none": (True, "none", "float32"),
    "bn_layer": (True, "layer", "float32"),
    "bn_unroll_group": (True, "unroll_group", "float32"),
    "ln_none": (False, "none", "float32"),
    "ln_layer": (False, "layer", "float32"),
    "ln_unroll_group": (False, "unroll_group", "float32"),
    "bn_bf16": (True, "layer", "bfloat16"),
}
WORLDS = {  # name: (data, graph, cases)
    "p2": (1, 2, tuple(CASES)),
    "p4": (1, 4, ("bn_layer", "ln_unroll_group")),
    "d2g2": (2, 2, ("bn_layer",)),
}
F32_RUNS = [(w, c) for w, (_, _, cases) in WORLDS.items() for c in cases
            if CASES[c][2] == "float32"]
JOIN_TIMEOUT_S = 240


def graph_arrays(seed: int, n: int, e: int) -> dict:
    """A graph of ``tests/test_sharded.py``'s ``make_sample`` kind, as numpy
    arrays in parser order."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, size=e).astype(np.int32)
    dst = rng.integers(0, n, size=e).astype(np.int32)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    return dict(src=src, dst=dst, n=np.int64(n),
                e_feat=rng.standard_normal((len(src), 2)).astype(np.float32),
                pe=rng.standard_normal((n, NB_POS_ENC + 2)).astype(np.float32),
                y=(rng.random(len(src)) < 0.3).astype(np.float32))


# (seed, nodes, edges) of each world's graphs: nodes past 512·(P − 1), so
# every shard owns nodes (N_pad is a multiple of 512·P) and most edges
# cross shards
GRAPHS = {"p2": [(0, 700, 4000)], "p4": [(3, 1800, 9000)],
          "d2g2": [(1, 700, 3500), (2, 900, 4500)]}


def port_sample(a: dict):
    from gnnome_tpu_torch.core.graph import build_graph, pad_features, prepare_edge_features
    from gnnome_tpu_torch.data.dataset import GraphSample

    g = build_graph(a["src"], a["dst"], int(a["n"]), node_pad_multiple=512,
                    edge_pad_multiple=1024, device="cpu")
    return GraphSample(idx=0, graph=g, e_feat=prepare_edge_features(g, a["e_feat"]),
                       pe=torch.from_numpy(pad_features(a["pe"], g.n_nodes_padded)),
                       y=prepare_edge_features(g, a["y"]), prefix_length=None,
                       read_length=None, overlap_length=None, overlap_similarity=None,
                       src=a["src"], dst=a["dst"])


def leaves_np(params, attr=None) -> dict:
    from gnnome_tpu_torch.train.checkpoint import iter_leaves

    return {k: (getattr(v, attr) if attr else v).detach().numpy().copy()
            for k, v in iter_leaves(params)}


# ---------------------------------------------------------------------------
# the worker: one rank of one world
# ---------------------------------------------------------------------------


def _worker(job_path: str, rank: int) -> None:
    torch.set_num_threads(1)
    sys.path.insert(0, REPO)
    from gnnome_tpu_torch.parallel.mesh import initialize_distributed, make_mesh
    from gnnome_tpu_torch.parallel.sharded import (
        halo_exchange, halo_reduce, make_sharded_train_step, prepare_batch,
        shard_batch, sharded_forward)
    from gnnome_tpu_torch.train.checkpoint import params_from_jax
    from gnnome_tpu_torch.train.loop import make_optimizer

    job = json.loads(open(job_path).read())
    world = job["data"] * job["graph"]
    dev = initialize_distributed(f"tcp://127.0.0.1:{job['port']}", world, rank,
                                 device="cpu", timeout_s=60)
    mesh = make_mesh(job["data"], job["graph"], timeout_s=60)
    assert mesh.device == dev  # the rank's, as initialize_distributed bound it
    batch = prepare_batch([port_sample(dict(np.load(p))) for p in job["graphs"]], mesh)
    shard = shard_batch(batch, mesh)
    arrays = dict(np.load(job["params"]))
    out = {"n_real": np.int64(shard.n_real)}
    for name in job["cases"]:
        batch_norm, remat, cdt = CASES[name]
        params = params_from_jax(arrays, device="cpu")
        with torch.no_grad():
            out[f"{name}/logits"] = sharded_forward(
                params, shard, mesh, batch_norm=batch_norm, compute_dtype=cdt).numpy()
        opt = make_optimizer(params, LR)
        step = make_sharded_train_step(mesh, batch_norm=batch_norm, remat=remat,
                                       compute_dtype=cdt, remat_group=REMAT_GROUP)
        out[f"{name}/loss"] = step(params, opt, shard, POS_WEIGHT).numpy()
        for k, v in leaves_np(params, "grad").items():
            out[f"{name}/grad{k}"] = v
        for k, v in leaves_np(params).items():
            out[f"{name}/param{k}"] = v
    # the halo pair on small integers (every product and sum exact in f32)
    rng = np.random.default_rng(100 + rank)
    x = torch.from_numpy(rng.integers(-4, 5, (shard.n_local, 8)).astype(np.float32))
    y = torch.from_numpy(rng.integers(-4, 5, (shard.n_local + shard.n_halo, 8))
                         .astype(np.float32))
    (ex,) = halo_exchange([x], shard, mesh)
    out["halo/exchange_dot"] = (ex * y).sum().numpy()
    out["halo/reduce_dot"] = (x * halo_reduce(y, shard, mesh)).sum().numpy()
    np.savez(os.path.join(job["out"], f"rank{rank}.npz"), **out)
    import torch.distributed as dist

    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# fixtures: the worlds (started first), the JAX side, the port references
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """This module's torch work in one thread, as its workers run: its ops
    are small, and under the suite's parallel workers more threads only
    contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The graphs and the JAX-initialized parameters, written for the
    workers: the same numpy arrays reach both packages."""
    import jax

    from gnnome_tpu.config import ModelConfig
    from gnnome_tpu.models.model import init_model_params
    from gnnome_tpu.train.checkpoint import _flatten

    root = tmp_path_factory.mktemp("sharded")
    graphs = {}
    for w, specs in GRAPHS.items():
        graphs[w] = []
        for seed, n, e in specs:
            path = root / f"graph_{seed}.npz"
            if not path.exists():
                np.savez(path, **graph_arrays(seed, n, e))
            graphs[w].append(str(path))
    cfg = ModelConfig(num_gnn_layers=2, hidden_features=32, hidden_edge_features=8,
                      hidden_edge_scores=16, nb_pos_enc=NB_POS_ENC)
    jparams = init_model_params(jax.random.PRNGKey(0), cfg)
    params = {k: np.asarray(v) for k, v in _flatten(jparams).items()}
    np.savez(root / "params.npz", **params)
    return dict(root=root, graphs=graphs, cfg=cfg, jparams=jparams, params=params)


@pytest.fixture(scope="module")
def started(inputs):
    """Every world's ranks, started together: ``{world: (procs, out_dir)}``."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    worlds = {}
    for w, (data, graph, cases) in WORLDS.items():
        out = inputs["root"] / f"out_{w}"
        out.mkdir()
        job = inputs["root"] / f"job_{w}.json"
        job.write_text(json.dumps(dict(data=data, graph=graph, cases=list(cases),
                                       port=_free_port(), graphs=inputs["graphs"][w],
                                       params=str(inputs["root"] / "params.npz"),
                                       out=str(out))))
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(job),
                                   str(r)], env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT)
                 for r in range(data * graph)]
        worlds[w] = (procs, out)
    yield worlds
    for procs, _ in worlds.values():
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _jax_samples(inputs, world):
    import jax.numpy as jnp

    from gnnome_tpu.core.graph import build_graph, pad_features, prepare_edge_features
    from gnnome_tpu.data.dataset import GraphSample

    out = []
    for i, path in enumerate(inputs["graphs"][world]):
        a = dict(np.load(path))
        g = build_graph(a["src"], a["dst"], int(a["n"]))
        out.append(GraphSample(
            idx=i, graph=g, e_feat=prepare_edge_features(g, a["e_feat"]),
            pe=jnp.asarray(pad_features(a["pe"], g.n_nodes_padded)),
            y=prepare_edge_features(g, a["y"]), prefix_length=None, read_length=None,
            overlap_length=None, overlap_similarity=None, src=a["src"], dst=a["dst"]))
    return out


def _jax_mesh(world):
    import jax

    from gnnome_tpu.parallel.mesh import make_mesh

    data, graph, _ = WORLDS[world]
    return make_mesh(data=data, graph=graph, devices=jax.devices()[: data * graph])


@pytest.fixture(scope="module")
def jax_side(inputs, started):
    """JAX's sharded losses per (world, model, dtype), its sharded step's
    parameters for P = 2 (the BatchNorm model), and its single-device bf16 forward
    (logits, loss) for the bf16 bound; computed while the workers run."""
    import jax
    import jax.numpy as jnp

    from gnnome_tpu.evaluation.metrics import bce_with_logits
    from gnnome_tpu.models.model import model_forward
    from gnnome_tpu.parallel.sharded import (
        make_sharded_loss, make_sharded_train_step, prepare_batch)
    from gnnome_tpu.train.checkpoint import _flatten
    from gnnome_tpu.train.loop import make_optimizer, set_lr

    jparams, pw = inputs["jparams"], jnp.float32(POS_WEIGHT)
    losses, stepped = {}, {}
    for w, (_, _, cases) in WORLDS.items():
        mesh = _jax_mesh(w)
        batch = prepare_batch(_jax_samples(inputs, w), mesh)
        for batch_norm, cdt in sorted({CASES[c][::2] for c in cases}):
            fn = make_sharded_loss(mesh, batch_norm=batch_norm, compute_dtype=cdt)
            losses[(w, batch_norm, cdt)] = float(jax.jit(fn)(jparams, batch, pw))
        if w == "p2":
            p = jax.tree_util.tree_map(jnp.array, jparams)  # the step donates
            state = set_lr(make_optimizer().init(p), LR)
            p, _, _ = make_sharded_train_step(mesh)(p, state, batch, pw)
            stepped = {k: np.asarray(v) for k, v in _flatten(p).items()}
    (s,) = _jax_samples(inputs, "p2")
    logits = model_forward(jparams, s.graph, s.e_feat, s.pe, backend="xla",
                           compute_dtype="bfloat16")
    single_bf16 = dict(logits=np.asarray(logits)[: s.graph.n_edges],
                       loss=float(bce_with_logits(logits, s.y, s.graph.edge_mask, pw)))
    return dict(losses=losses, stepped=stepped, single_bf16=single_bf16)


@pytest.fixture(scope="module")
def runs(started, jax_side):
    """Every world's outputs: ``{world: [rank outputs]}``; a worker that fails
    or outlives the join timeout fails every test of its world."""
    out = {}
    for w, (procs, out_dir) in started.items():
        logs = []
        for p in procs:
            try:
                logs.append(p.communicate(timeout=JOIN_TIMEOUT_S)[0].decode())
            except subprocess.TimeoutExpired:
                p.kill()
                logs.append(p.communicate()[0].decode() + "\n(killed at the join timeout)")
        bad = [(r, log) for r, (p, log) in enumerate(zip(procs, logs)) if p.returncode != 0]
        out[w] = ([dict(np.load(out_dir / f"rank{r}.npz")) for r in range(len(procs))]
                  if not bad else f"rank {bad[0][0]} failed:\n{bad[0][1][-3000:]}")
    return out


def world_runs(runs, w):
    if isinstance(runs[w], str):
        pytest.fail(runs[w])
    return runs[w]


@pytest.fixture(scope="module")
def single(inputs):
    """The port's single-device references per (world, case): the loss (the
    mean over the world's graphs), its gradients, and the parameters after
    one Adam step of ``train_step``'s rule on them."""
    from gnnome_tpu_torch.evaluation.metrics import bce_with_logits
    from gnnome_tpu_torch.models.model import model_forward
    from gnnome_tpu_torch.train.checkpoint import params_from_jax
    from gnnome_tpu_torch.train.loop import make_optimizer

    cache = {}

    def get(w, case):
        key = (tuple(inputs["graphs"][w]), case)
        if key not in cache:
            batch_norm, remat, cdt = CASES[case]
            samples = [port_sample(dict(np.load(p))) for p in inputs["graphs"][w]]
            params = params_from_jax(inputs["params"], device="cpu")
            opt = make_optimizer(params, LR)
            opt.zero_grad(set_to_none=True)
            loss = sum(bce_with_logits(model_forward(
                params, s.graph, s.e_feat, s.pe, batch_norm=batch_norm, remat=remat,
                remat_group=REMAT_GROUP, compute_dtype=cdt), s.y, s.graph.edge_mask,
                POS_WEIGHT) for s in samples) / len(samples)
            loss.backward()
            grads = leaves_np(params, "grad")
            opt.step()
            cache[key] = dict(loss=float(loss.detach()), grads=grads, params=leaves_np(params))
        return cache[key]

    return get


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world,case", F32_RUNS)
def test_sharded_loss_matches_jax_and_single_device(runs, jax_side, single, world, case):
    ranks = world_runs(runs, world)
    batch_norm, _, cdt = CASES[case]
    loss = float(ranks[0][f"{case}/loss"])
    assert all(float(r[f"{case}/loss"]) == loss for r in ranks)
    np.testing.assert_allclose(loss, jax_side["losses"][(world, batch_norm, cdt)],
                               **LOSS_TOL)
    np.testing.assert_allclose(loss, single(world, case)["loss"], **LOSS_TOL)


def _grad_tol(key, ref):
    if any(part in key for part in EDGE_SUMMED):
        return dict(rtol=1e-5, atol=1e-6 * float(np.abs(ref).max()))
    return TOL


@pytest.mark.parametrize("world,case", F32_RUNS)
def test_sharded_gradients_match_single_device(runs, single, world, case):
    """Per leaf as the module docstring says; the leaves whose reference
    gradient is f32 rounding noise (below ``NOISE`` of the whole gradient's
    norm: the biases a BatchNorm cancels) are held in absolute terms, as
    ``tests/test_torch_train.py``'s ``grad_errors`` holds them."""
    from test_torch_train import BN_CANCELLED, NOISE

    ranks = world_runs(runs, world)
    want = single(world, case)["grads"]
    total = np.sqrt(sum(float(np.sum(w.astype(np.float64) ** 2)) for w in want.values()))
    noise = {k for k, w in want.items() if np.linalg.norm(w) <= NOISE * total}
    if CASES[case][0]:
        assert {k for k in want if k.endswith(BN_CANCELLED)} <= noise
    for k, w in want.items():
        got = ranks[0][f"{case}/grad{k}"]
        if k in noise:
            assert np.linalg.norm(got) <= 10 * NOISE * total, k
        else:
            np.testing.assert_allclose(got, w, **_grad_tol(k, w), err_msg=k)


@pytest.mark.parametrize("world,case", F32_RUNS)
def test_sharded_step_matches_train_step(runs, single, jax_side, inputs, world, case):
    """One Adam step: against the port's single-device step, and for the
    BatchNorm model at P = 2 under remat "layer" also against JAX's sharded
    step."""
    from test_torch_train import _check_params

    ranks = world_runs(runs, world)
    ref = single(world, case)
    got = {k: ranks[0][f"{case}/param{k}"] for k in ref["params"]}
    _check_params(got, ref["params"], inputs["params"], ref["grads"], 1)
    if (world, case) == ("p2", "bn_layer"):
        _check_params(got, jax_side["stepped"], inputs["params"], ref["grads"], 1)


@pytest.mark.parametrize("world,case", [(w, c) for w, (_, _, cs) in WORLDS.items()
                                        for c in cs])
def test_ranks_end_bit_equal(runs, world, case):
    ranks = world_runs(runs, world)
    keys = [k for k in ranks[0] if k.startswith(f"{case}/param")]
    assert keys
    for r in ranks[1:]:
        for k in keys:
            assert np.array_equal(r[k], ranks[0][k]), k


def test_bf16_sharded_loss_matches_jax(runs, jax_side):
    """The bf16 case (BatchNorm, P = 2, remat "layer") within the bound of
    ``tests/test_torch_bf16.py``, through JAX's single-device bf16 forward
    (module docstring)."""
    ranks = world_runs(runs, "p2")
    loss = float(ranks[0]["bn_bf16/loss"])
    logits = np.concatenate([r["bn_bf16/logits"][: int(r["n_real"])] for r in ranks])
    ref = jax_side["single_bf16"]
    assert logits.shape == ref["logits"].shape and np.isfinite(logits).all()
    jax_sharded = jax_side["losses"][("p2", True, "bfloat16")]
    bound = (max(1.0, POS_WEIGHT) * np.abs(logits - ref["logits"]).mean()
             + abs(ref["loss"] - jax_sharded) + 1e-6)
    assert abs(loss - jax_sharded) <= bound, (loss, jax_sharded, bound)
    # the logits within the ceiling tests/test_torch_bf16.py puts on bf16's
    # own spread (JAX's two backends), so the bound is bf16's
    assert np.abs(logits - ref["logits"]).max() < 0.1


@pytest.mark.parametrize("world", list(WORLDS))
def test_halo_pair_is_adjoint(runs, world):
    """⟨exchange(x), y⟩ = ⟨x, reduce(y)⟩ summed over the ranks, exactly."""
    ranks = world_runs(runs, world)
    lhs = sum(float(r["halo/exchange_dot"]) for r in ranks)
    rhs = sum(float(r["halo/reduce_dot"]) for r in ranks)
    assert lhs == rhs and lhs != 0.0


@pytest.mark.parametrize("batch_norm", [True, False])
def test_p1_equals_single_device(inputs, batch_norm):
    """At world size 1 (no process group) the sharded forward, loss and
    gradients are the single-device ones bit for bit: the same kernels on
    the same layouts (the graph padded as the sharded batch pads it)."""
    from gnnome_tpu_torch.evaluation.metrics import bce_with_logits
    from gnnome_tpu_torch.models.model import model_forward
    from gnnome_tpu_torch.parallel.mesh import make_mesh
    from gnnome_tpu_torch.parallel.sharded import (
        make_sharded_loss, prepare_batch, shard_batch, sharded_forward)
    from gnnome_tpu_torch.train.checkpoint import iter_leaves, params_from_jax

    assert make_mesh().device.type == "cuda"  # the CPU only when asked for
    mesh = make_mesh(device="cpu")
    assert mesh.size == 1 and mesh.world_group is None
    s = port_sample(dict(np.load(inputs["graphs"]["p2"][0])))
    shard = shard_batch(prepare_batch([s], mesh), mesh)
    assert shard.n_halo == 0 and shard.mask.shape == s.graph.edge_mask.shape
    params = params_from_jax(inputs["params"], device="cpu")
    with torch.no_grad():
        got = sharded_forward(params, shard, mesh, batch_norm=batch_norm)
        want = model_forward(params, s.graph, s.e_feat, s.pe, batch_norm=batch_norm)
    assert torch.equal(got, want)

    def grads_of(loss_fn):
        params = params_from_jax(inputs["params"], device="cpu")
        for _, leaf in iter_leaves(params):
            leaf.requires_grad_(True)
        loss = loss_fn(params)
        loss.backward()
        return loss.detach(), leaves_np(params, "grad")

    sharded_loss = make_sharded_loss(mesh, batch_norm=batch_norm)
    loss, grads = grads_of(lambda p: sharded_loss(p, shard, POS_WEIGHT)[1])
    ref, ref_grads = grads_of(lambda p: bce_with_logits(
        model_forward(p, s.graph, s.e_feat, s.pe, batch_norm=batch_norm), s.y,
        s.graph.edge_mask, POS_WEIGHT))
    assert torch.equal(loss, ref)
    for k, w in ref_grads.items():
        assert np.array_equal(grads[k], w), k



def _span_tree(prof):
    """The program spans a profiler recorded, as ``[(name, children)]``
    in the order they opened (``gnnome.`` dropped)."""
    from gnnome_tpu_torch.utils.profiling import SPAN_PREFIX
    from test_torch_spans import _parents

    spans, parent = _parents(prof.events())
    kids = {}
    for s in sorted(spans, key=lambda s: s.time_range.start):
        kids.setdefault(id(parent[id(s)]), []).append(s)

    def walk(key):
        return [(s.name[len(SPAN_PREFIX):], walk(id(s))) for s in kids.get(key, [])]

    return walk(id(None))


@pytest.mark.parametrize("batch_norm", [True, False])
def test_p1_step_opens_the_layer_spans(inputs, batch_norm):
    """A training step of the sharded loss at world size 1 opens the spans
    of ``model_forward``'s on the same graph, recompute included: per layer
    ``model.layer`` ⊃ ``gate``, ``norm``, ``aggregate``, ``norm``."""
    from gnnome_tpu_torch.evaluation.metrics import bce_with_logits
    from gnnome_tpu_torch.models.model import model_forward
    from gnnome_tpu_torch.parallel.mesh import make_mesh
    from gnnome_tpu_torch.parallel.sharded import make_sharded_loss, prepare_batch, shard_batch
    from gnnome_tpu_torch.train.checkpoint import iter_leaves, params_from_jax

    mesh = make_mesh(device="cpu")
    s = port_sample(dict(np.load(inputs["graphs"]["p2"][0])))
    shard = shard_batch(prepare_batch([s], mesh), mesh)
    sharded_loss = make_sharded_loss(mesh, batch_norm=batch_norm)

    def tree_of(loss_fn):
        params = params_from_jax(inputs["params"], device="cpu")
        for _, leaf in iter_leaves(params):
            leaf.requires_grad_(True)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            loss_fn(params).backward()
        return _span_tree(prof)

    got = tree_of(lambda p: sharded_loss(p, shard, POS_WEIGHT)[1])
    want = tree_of(lambda p: bce_with_logits(
        model_forward(p, s.graph, s.e_feat, s.pe, batch_norm=batch_norm), s.y,
        s.graph.edge_mask, POS_WEIGHT))
    n_layers = inputs["cfg"].num_gnn_layers
    assert [name for name, _ in want] == ["model.layer"] * (2 * n_layers)  # forward, recompute
    assert all([c for c, _ in kids] == ["gate", "norm", "aggregate", "norm"]
               for _, kids in want)
    assert got == want

if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]))
