"""The bf16 gate front's launch plan (``ops/gate_front.py``
``gate_front_bf16_plan``), for every width from 1 to 4096, on the CPU.

The plan is computed in Python from the shape and passed to the CUDA
entry, which takes the shared memory of its own layout and refuses a plan
past the H100's 232,448 bytes a block. These tests hold what the card
cannot show cheaply: that every TMA plan fits them with its W3 column
slice resident (the whole K extent, loaded once a block, never for each
row tile), and that the element-wise instance runs exactly where TMA
cannot read e (d % 8 != 0, or a base not 16-byte aligned) or where even
BN = 32 does not fit (d > 2944).
"""
import numpy as np
import pytest
import torch

from gnnome_tpu_torch.ops import gate_front as gf
from gnnome_tpu_torch.ops.gate_front import SMEM_MAX, gate_front_bf16_plan, tma_smem

SMS = 132  # the H100's SMs
WIDTHS = range(1, 2049)
WIDEST_TMA = 2944  # the widest d whose BN = 32 slice fits beside a ring of 4


@pytest.mark.parametrize("widths", [WIDTHS, range(2049, 4097)], ids=["to2048", "to4096"])
@pytest.mark.parametrize("vec", [True, False])
def test_every_width_fits_and_tma_exactly_where_it_can_read_e(vec, widths):
    for d in widths:
        plan = gate_front_bf16_plan(d, 1_000_000, SMS, vec)
        tma_ok = vec and d % 8 == 0 and d <= WIDEST_TMA
        assert (plan.bn > 0) == tma_ok, (d, vec, plan)
        if tma_ok:
            assert tma_smem(d, plan.bn, plan.stages) <= SMEM_MAX, (d, plan)
        else:
            assert plan.stages == 0, (d, plan)


def test_tma_plan_keeps_w3_resident():
    for d in range(8, WIDEST_TMA + 1, 8):
        plan = gate_front_bf16_plan(d, 1_000_000, SMS, True)
        assert plan.bn in (32, 64, 128, 256) and 4 <= plan.stages <= 8, (d, plan)
        # the whole K extent of the slice is in shared memory, once: a block's
        # bytes grow by the slice's rows, 64 K at a time, and nothing else
        assert (tma_smem(d, plan.bn, plan.stages) - tma_smem(64, plan.bn, plan.stages)
                == (-(-d // 64) - 1) * 64 * plan.bn * 2), (d, plan)
        # the widest BN that fits: a wider one would not, or is wider than d needs
        wider = 2 * plan.bn
        if wider <= 256 and wider // 2 < d:
            assert tma_smem(d, wider, 4) > SMEM_MAX, (d, plan)
        # as many stages as fit, up to 8
        if plan.stages < 8:
            assert tma_smem(d, plan.bn, plan.stages + 1) > SMEM_MAX, (d, plan)


@pytest.mark.parametrize("n_rows", [1, 64, 1037, 91_136, 1_000_000])
def test_grid_covers_columns_and_rows(n_rows):
    n_tiles = -(-n_rows // 64)
    for d in WIDTHS:
        for vec in (True, False):
            plan = gate_front_bf16_plan(d, n_rows, SMS, vec)
            parts, n_cb = plan.grid
            bn = plan.bn or 128
            assert (n_cb - 1) * bn < d <= n_cb * bn, (d, plan)
            assert 1 <= parts <= max(1, n_tiles), (d, n_rows, plan)
            if plan.bn:
                # one block an SM: every block of the grid is resident at once
                assert parts * n_cb <= SMS, (d, plan)


def test_elementwise_instance_past_the_widest_tma_width():
    """Past d = 2944 not even BN = 32 fits beside a ring of 4, so every
    width, aligned or not, takes the element-wise instance (its loads
    element by element there, its W3 slice in K tiles of 256 rows)."""
    assert gate_front_bf16_plan(WIDEST_TMA, 1_000_000, SMS, True).bn == 32
    assert tma_smem(WIDEST_TMA, 32, 4) <= SMEM_MAX < tma_smem(WIDEST_TMA + 8, 32, 4)
    for d in range(WIDEST_TMA + 1, 8193):
        plan = gate_front_bf16_plan(d, 1_000_000, SMS, True)
        assert plan.bn == 0 and plan.grid[1] == -(-d // 128), (d, plan)


@pytest.mark.parametrize("d,offset", [(256, 0), (256, 4), (640, 0), (30, 0), (3000, 0)])
def test_wrapper_passes_the_plan_to_the_entry(d, offset, monkeypatch):
    """``_gate_front_bf16`` hands the entry the plan for its tensors: an e
    whose base is 8 bytes off 16-byte alignment (a view 4 bf16 into a
    buffer) takes the element-wise instance, as do d = 30 and d = 3000."""
    calls = []
    monkeypatch.setattr(gf, "GATE_FRONT_BF16", lambda device, *args: calls.append(args))
    rng = np.random.default_rng(0)
    n, rows = 40, 300

    def bf(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(torch.bfloat16)

    buf = bf(rows * d + offset)
    e = buf[offset:].view(rows, d)
    ids = torch.from_numpy(rng.integers(0, n, rows).astype(np.int32))
    gf._gate_front_bf16(bf(n, d), bf(n, d), e, bf(d, d), bf(d), ids, ids, rows, SMS)
    (args,) = calls
    n_rows, n_real, width, n_parts, bn, stages = args[10:]
    aligned = offset == 0 and e.data_ptr() % 16 == 0
    plan = gate_front_bf16_plan(d, rows, SMS, aligned and d % 8 == 0)
    assert (n_rows, n_real, width) == (rows, rows, d)
    assert (n_parts, bn, stages) == (plan.grid[0], plan.bn, plan.stages)
    assert (bn > 0) == (aligned and d % 8 == 0 and d <= WIDEST_TMA)
