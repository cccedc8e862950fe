"""The port's graph core and the plain (CPU) forms of its four kernels,
held against the JAX package.

Inputs are made with numpy from a seed and fed to both packages. Each
kernel function is compared with the JAX op that reaches the Pallas kernel
it replaces, twice: with ``backend="pallas_interpret"`` on a banded graph
(so the Pallas kernel itself runs, in interpret mode) and with
``backend="xla"`` on a random, non-banded graph. Both graphs carry
trailing pad nodes and PAD edges (the JAX package's default padding).

Tolerance: rtol = atol = 1e-5. Both sides compute in f32 (JAX matmuls at
``highest`` precision, tests/conftest.py), but sum in different orders —
the Pallas kernels by one-hot matmul blocks, XLA by segment_sum, the port
by index_add_ — so sums agree to a few f32 ulps of their magnitude, not
bit for bit. Gathers move bits and must be exact.

Also here: the graph arrays against the JAX graph field by field, the
last-segment case with trailing pad nodes, the masked norms, and the check
that no module of the port (nor chip_smoke.py) imports JAX or gnnome_tpu.
"""
import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnnome_tpu.core.graph import build_graph as jax_build_graph
from gnnome_tpu.core.graph import degrees as jax_degrees
from gnnome_tpu.ops import norm as jax_norm
from gnnome_tpu.ops.banded import take_rows as jax_take_rows
from gnnome_tpu.ops.segment import (
    _fused_sigma_reverse_unsorted,
    fused_gate_front as jax_gate_front,
    fused_gate_sigma_gather as jax_gate_sigma_gather,
    gate_front_supported,
    reverse_unsorted_supported,
)
from gnnome_tpu_torch.core.graph import PAD_SEGMENT, build_graph, degrees
from gnnome_tpu_torch.ops import norm
from gnnome_tpu_torch.ops.gate_epilog import gate_sigma_gather
from gnnome_tpu_torch.ops.gate_front import gate_front
from gnnome_tpu_torch.ops.reverse_sum import sigma_reverse_sum
from gnnome_tpu_torch.ops.segment import gated_mean_by_src
from gnnome_tpu_torch.ops.take import take_rows

ROOT = Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-5, atol=1e-5)
D = 128  # the Pallas kernels' lane width


def banded_edges(rng, n=510):
    """Locality-ordered chain + short-range tangles (the fixture of
    tests/test_reverse_unsorted.py): every Pallas path of the forward runs."""
    src, dst = [], []
    for i in range(n - 1):
        src.append(i)
        dst.append(i + 1)
    for i in range(0, n - 4, 3):
        src += [i, i + 2]
        dst += [i + 2, i]
    for i in rng.integers(0, n - 16, 200):
        src.append(int(i))
        dst.append(int(i) + int(rng.integers(1, 12)))
    return np.array(src, np.int32), np.array(dst, np.int32), n


def random_edges(rng, n=300, e=2500):
    """Uniform random endpoints: no band structure at all."""
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    keep = src != dst
    return src[keep], dst[keep], n


def both_graphs(src, dst, n):
    jg = jax_build_graph(src, dst, n)
    tg = build_graph(src, dst, n, node_pad_multiple=512, edge_pad_multiple=1024,
                     device="cpu")
    assert tg.n_nodes_padded == jg.n_nodes_padded > n
    assert tg.n_edges_padded == jg.n_edges_padded > jg.n_edges
    return jg, tg


@pytest.fixture(params=["pallas_interpret", "xla"])
def case(request):
    """(backend, JAX graph, port graph, rng): the banded graph for the
    Pallas kernels, a random graph for XLA."""
    rng = np.random.default_rng(7)
    if request.param == "pallas_interpret":
        jg, tg = both_graphs(*banded_edges(rng))
        assert gate_front_supported(jg, "pallas_interpret")
        assert reverse_unsorted_supported(jg, D, 4, "pallas_interpret")
    else:
        jg, tg = both_graphs(*random_edges(rng))
    return request.param, jg, tg, rng


def f32(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def t(x):
    return torch.from_numpy(np.array(x, copy=True))


def close(got, want, **tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **(tol or TOL))


# ---------------------------------------------------------------------------
# graph core
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("make", [banded_edges, random_edges])
def test_graph_arrays_match_jax(make):
    jg, tg = both_graphs(*make(np.random.default_rng(3)))
    assert (tg.n_nodes, tg.n_edges) == (jg.n_nodes, jg.n_edges)
    pairs = [
        (tg.src, jg.src), (tg.dst, jg.dst),
        (tg.node_mask, jg.node_mask), (tg.edge_mask, jg.edge_mask),
        (tg.by_dst.offsets, jg.by_dst.offsets),
        (tg.by_dst.segment_ids, jg.by_dst.segment_ids),
        (tg.by_src.order, jg.by_src.order),
        (tg.by_src.offsets, jg.by_src.offsets),
        (tg.by_src.segment_ids, jg.by_src.segment_ids),
        (tg.by_src.key, jg.by_src.key_canonical),
        (tg.by_src.inv_order, jg.by_src.inv_order),
        (tg.by_src.opp_ids, jg.by_src.opp_ids),
    ]
    for ours, theirs in pairs:
        np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    assert tg.by_dst.inv_order is None and tg.by_dst.opp_ids is None
    np.testing.assert_array_equal(tg.edge_perm, np.asarray(jg.edge_perm))
    np.testing.assert_array_equal(tg.edge_inv_perm, np.asarray(jg.edge_inv_perm))
    for ours, theirs in zip(degrees(tg), jax_degrees(jg)):
        np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))


def test_last_real_segment_kept_with_trailing_pad_nodes():
    """The fault the JAX package hit in its canonical bounds: with trailing
    pad nodes, the last real node's final edge was dropped. Here the by_src
    offsets of every node, and the reverse sum of the last real node (which
    has the largest src of all), must match a brute-force count."""
    rng = np.random.default_rng(11)
    for _ in range(10):
        n = int(rng.integers(5, 120))
        src, dst, _ = random_edges(rng, n, int(rng.integers(5, 400)))
        src = np.append(src, [n - 1, n - 1]).astype(np.int32)
        dst = np.append(dst, [0, 1]).astype(np.int32)
        g = build_graph(src, dst, n, node_pad_multiple=64, edge_pad_multiple=128,
                        device="cpu")
        assert g.n_nodes_padded > n
        counts = np.bincount(src, minlength=g.n_nodes_padded)
        np.testing.assert_array_equal(np.diff(g.by_src.offsets.numpy()), counts)
        np.testing.assert_array_equal(np.diff(g.by_dst.offsets.numpy()),
                                      np.bincount(dst, minlength=g.n_nodes_padded))
        e_new = t(f32(rng, g.n_edges_padded, 4))
        values = t(f32(rng, g.n_nodes_padded, 4))
        sums = sigma_reverse_sum(e_new, values, g.by_src, g.dst)
        last = g.by_src.key.numpy() == n - 1
        sig = torch.sigmoid(e_new[last])
        want = torch.cat([(sig * values[g.dst[last]]).sum(0), sig.sum(0)])
        torch.testing.assert_close(sums[n - 1], want, **TOL)
        assert sums[n:].abs().max() == 0  # pad nodes own no edge


# ---------------------------------------------------------------------------
# the four kernel functions (plain CPU forms) against the JAX ops
# ---------------------------------------------------------------------------


def test_take_rows_matches_jax(case):
    backend, jg, tg, rng = case
    table = f32(rng, jg.n_nodes_padded, D)
    plan = jg.by_src.key_plan
    got = take_rows(t(table), tg.src)
    close(got, jax_take_rows(jnp.asarray(table), jg.src, plan, backend), rtol=0, atol=0)
    # PAD-marked ids give zero rows on both sides
    got = take_rows(t(table), tg.by_src.key)
    want = jax_take_rows(jnp.asarray(table), jg.by_src.key_canonical, plan, backend,
                         masked=True)
    close(got, want, rtol=0, atol=0)
    assert got[tg.n_edges:].abs().max() == 0


def test_gate_front_matches_jax(case):
    backend, jg, tg, rng = case
    n, e = jg.n_nodes_padded, jg.n_edges_padded
    b1h, b2h, ein = f32(rng, n, D), f32(rng, n, D), f32(rng, e, D)
    w3, b3 = f32(rng, D, D, scale=D ** -0.5), f32(rng, D)
    gate, mom = gate_front(t(b1h), t(b2h), t(ein), t(w3), t(b3), tg.src, tg.dst,
                           tg.n_edges)
    jgate, jmom = jax_gate_front(
        jnp.asarray(b1h), jnp.asarray(b2h), jnp.asarray(ein), jnp.asarray(w3),
        jnp.asarray(b3), jg.src, jg.dst, (jg.by_src, jg.by_dst), n, jg.n_edges,
        backend)
    close(gate, jgate)
    close(mom / tg.n_edges, np.asarray(jmom) / jg.n_edges)


def test_gate_sigma_gather_matches_jax(case):
    backend, jg, tg, rng = case
    n, e = jg.n_nodes_padded, jg.n_edges_padded
    gate, ein, values = f32(rng, e, D), f32(rng, e, D), f32(rng, n, D)
    affine = np.stack([rng.uniform(0.5, 1.5, D), rng.standard_normal(D)]).astype(np.float32)
    sums, e_new = gate_sigma_gather(t(gate), t(ein), t(values), t(affine), tg.by_dst, tg.src)
    dst_key = jnp.where(jg.edge_mask, jg.dst, int(PAD_SEGMENT))
    jsums, je_new = jax_gate_sigma_gather(
        jnp.asarray(gate), jnp.asarray(ein), jnp.asarray(values), jnp.asarray(affine),
        (dst_key, jg.src), jg.by_dst, jg.by_src, n, backend)
    close(e_new, je_new)
    close(sums, jsums)


def test_sigma_reverse_sum_matches_jax(case):
    backend, jg, tg, rng = case
    n, e = jg.n_nodes_padded, jg.n_edges_padded
    e_new, values = f32(rng, e, D), f32(rng, n, D)
    sums = sigma_reverse_sum(t(e_new), t(values), tg.by_src, tg.dst)
    jsums = _fused_sigma_reverse_unsorted(
        jnp.asarray(values), jnp.asarray(e_new), jg.by_src.key_canonical, jg.dst,
        jg.by_src, jg.by_dst, n, backend)
    close(sums, jsums)
    mean = gated_mean_by_src(t(values), t(e_new), tg)
    close(mean, np.asarray(jsums)[:, :D] / (np.asarray(jsums)[:, D:] + 1e-6))


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def test_masked_norms_match_jax():
    rng = np.random.default_rng(5)
    x = f32(rng, 300, 24, scale=3.0) + 1.0
    mask = rng.random(300) < 0.8
    scale, bias = f32(rng, 24), f32(rng, 24)
    for ours, theirs in zip(norm.masked_moments(t(x), t(mask)),
                            jax_norm.masked_moments(jnp.asarray(x), jnp.asarray(mask))):
        close(ours, theirs)
    close(norm.masked_batch_norm(t(x), t(mask), t(scale), t(bias)),
          jax_norm.masked_batch_norm(jnp.asarray(x), jnp.asarray(mask),
                                     jnp.asarray(scale), jnp.asarray(bias)))
    close(norm.masked_layer_norm(t(x), t(scale), t(bias)),
          jax_norm.masked_layer_norm(jnp.asarray(x), jnp.asarray(scale),
                                     jnp.asarray(bias)))


# ---------------------------------------------------------------------------
# the port stands alone
# ---------------------------------------------------------------------------


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_no_jax():
    paths = [*ROOT.glob("gnnome_tpu_torch/**/*.py"), ROOT / "chip_smoke.py"]
    assert len(paths) > 20
    assert {ROOT / "gnnome_tpu_torch" / m for m in (
        "decode/device_walker.py", "decode/greedy.py", "utils/profiling.py",
        "data/pe.py", "core/collectives.py", "parallel/mesh.py",
        "parallel/sharded.py")} <= set(paths)
    bad = {
        str(p.relative_to(ROOT)): m for p in paths for m in _imports(p)
        if m in ("jax", "jaxlib", "gnnome_tpu")
        or m.startswith(("jax.", "jaxlib.", "gnnome_tpu."))
    }
    assert not bad, f"the port imports JAX or the JAX package: {bad}"
