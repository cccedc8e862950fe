"""The three σ wrappers on a value table whose row count is not the segment
count, on the CPU: ``SigmaReverseSum`` (row 3), ``GateSigmaGather`` with
its gather (row 2) and ``SigmaAggregate``'s gather form (row 10), forward
and backward, against a dense f64 reference.

The sharded layer (``gnnome_tpu_torch/parallel/sharded.py``) keys its
reverse sums on the combined ``[N_local + P·H]`` table while it reads
``N_local`` value rows, and reads its forward values from that combined
table while it sums into ``N_local`` segments. Each wrapper takes the
segment count from its CSR's offsets and any row count for the values. The
case with fewer value rows than segments sums edges keyed into the
segments past the table's rows (the halo rows).

Tolerance rtol = atol = 1e-5 (the plain versions sum in f32, the reference
in f64), and for ``d_affine``, summed over every edge, atol = 1e-6·max|ref|,
as ``tests/test_torch_train.py`` holds the port's per-op gradients.
"""
import numpy as np
import pytest
import torch

from gnnome_tpu_torch.ops.gate_epilog import GateSigmaGather
from gnnome_tpu_torch.ops.reverse_sum import SigmaReverseSum
from gnnome_tpu_torch.ops.sigma_aggregate import SigmaAggregate
from test_torch_cuda import VALUE_ROWS, value_table_case

N_SEG, D = 96, 24
TOL = dict(rtol=1e-5, atol=1e-5)


def one_hots(csr, n_rows, ids, n_val):
    """``S`` [n_rows, E]: edge k in the sum of its key's row (padded edges in
    none); ``V`` [E, n_val]: edge k reads value row ``ids[k]``; f64."""
    key = csr.key.long()
    e = key.shape[0]
    S = torch.zeros(n_rows, e, dtype=torch.float64)
    live = key < n_rows
    S[key[live], torch.arange(e)[live]] = 1.0
    V = torch.zeros(e, n_val, dtype=torch.float64)
    V[torch.arange(e), ids.long()] = 1.0
    return S, V


def sigma_sums(S, V, e_new, values):
    sig = torch.sigmoid(e_new)
    return torch.cat([S @ (sig * (V @ values)), S @ sig], dim=-1)


def run(fn, inputs, cotangents):
    """Outputs and input gradients of ``fn`` for the given cotangents."""
    leaves = [x.clone().requires_grad_(True) for x in inputs]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    torch.autograd.backward(outs, [c.to(o.dtype) for o, c in zip(outs, cotangents)])
    return [o.detach() for o in outs], [x.grad for x in leaves]


def check(port, ref, edge_summed=()):
    for i, (got, want) in enumerate(zip(port, ref)):
        assert got.shape == want.shape, (i, got.shape, want.shape)
        tol = dict(rtol=1e-5, atol=1e-6 * float(want.abs().max())) if i in edge_summed \
            else TOL
        torch.testing.assert_close(got.double(), want, **tol)


def inputs(c, rng, n_val, e_pad):
    def f(*shape):
        return torch.from_numpy(rng.standard_normal(shape))

    affine = torch.stack([torch.from_numpy(rng.uniform(0.5, 1.5, D)),
                          torch.from_numpy(rng.standard_normal(D))])
    return dict(gate=f(e_pad, D), e=f(e_pad, D), values=f(n_val, D), affine=affine,
                g_sums=f(N_SEG, 2 * D), g_e=f(e_pad, D))


@pytest.fixture(params=VALUE_ROWS, ids=lambda n: f"{n}_value_rows")
def case(request):
    n_val = request.param
    c = value_table_case(31, N_SEG, n_val, "cpu")
    e_pad = c["ids"].shape[0]
    return n_val, c, inputs(c, c["rng"], n_val, e_pad)


def test_reverse_sum_on_a_combined_table(case):
    """Row 3 keyed on ``N_SEG`` segments over an ``n_val``-row table:
    with 40 value rows, the edges keyed into segments 40-95 are summed
    (before, the plain version took the segment count from the table and
    dropped them)."""
    n_val, c, x = case
    S, V = one_hots(c["by_rkey"], N_SEG, c["ids"], n_val)
    ins = [x["e"], x["values"]]
    port = run(lambda en, v: SigmaReverseSum.apply(en, v, c["by_rkey"], c["ids"], c["by_ids"]),
               [t.float() for t in ins], [x["g_sums"]])
    ref = run(lambda en, v: sigma_sums(S, V, en, v), ins, [x["g_sums"]])
    check(port[0], ref[0])
    check(port[1], ref[1])
    live = c["by_rkey"].key < N_SEG
    assert (c["by_rkey"].key[live] >= n_val).any() or n_val > N_SEG


def test_gate_sigma_gather_on_a_combined_table(case):
    n_val, c, x = case
    S, V = one_hots(c["by_key"], N_SEG, c["ids"], n_val)

    def dense(gate, e_in, values, affine):
        e_new = torch.relu(gate * affine[0] + affine[1]) + e_in
        return sigma_sums(S, V, e_new, values), e_new

    ins = [x["gate"], x["e"], x["values"], x["affine"]]
    cot = [x["g_sums"], x["g_e"]]
    port = run(lambda *a: GateSigmaGather.apply(*a, c["by_key"], c["ids"], c["by_ids"]),
               [t.float() for t in ins], cot)
    ref = run(dense, ins, cot)
    check(port[0], ref[0])
    check(port[1], ref[1], edge_summed=(3,))


def test_sigma_aggregate_on_a_combined_table(case):
    n_val, c, x = case
    S, V = one_hots(c["by_key"], N_SEG, c["ids"], n_val)
    ins = [x["e"], x["values"]]
    port = run(lambda en, v: SigmaAggregate.apply(en, v, c["by_key"], c["ids"], c["by_ids"]),
               [t.float() for t in ins], [x["g_sums"]])
    ref = run(lambda en, v: sigma_sums(S, V, en, v), ins, [x["g_sums"]])
    check(port[0], ref[0])
    check(port[1], ref[1])
