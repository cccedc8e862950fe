"""The split-TF32 arithmetic of ``csrc/gate_front.cu``, emulated on the CPU.

The gate front's kernel runs ``e·W3`` on the tensor cores as three TF32
products: x = x_hi + x_lo with x_hi = tf32(x), x_lo = tf32(x - x_hi), both
rounded to nearest (``cvt.rna.tf32.f32``), and

    e·W3 ~ e_lo·W_hi + e_hi·W_lo + e_hi·W_hi

accumulated in f32, the two cross terms in an accumulator of their own.
The kernel rounds with the same two integer operations as ``tf32_rna``
below. The card test and ``chip_smoke.py`` hold the kernel to
rtol = atol = 1e-5 against the plain f32 product. These tests argue that
tolerance before any card run: emulating the rounding with integer
operations on the f32 bits (a product of two TF32 values is exact in f32,
so ``torch.matmul`` of the rounded parts is the tensor core's product up to
the order of the f32 sums), the 3-pass product lies within the card
tolerance of the f64 product, as the plain f32 product does, and a single
TF32 pass does not.
"""
import numpy as np
import pytest
import torch

TOL = 1e-5  # rtol = atol: tests/test_torch_cuda.py, chip_smoke.py:KERNEL_TOL
ROWS = 2048


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32 (10 mantissa bits), to nearest with ties away from
    zero, as ``cvt.rna.tf32.f32``: add half of the 13 dropped bits to the
    magnitude, then clear them (sign-magnitude bits: the same for both
    signs)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def three_pass(e: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    e_hi, e_lo = split(e)
    w_hi, w_lo = split(w)
    return (e_lo @ w_hi + e_hi @ w_lo) + e_hi @ w_hi


def inputs(d: int, seed: int):
    rng = np.random.default_rng(seed)
    e = rng.standard_normal((ROWS, d)).astype(np.float32)
    w = (rng.standard_normal((d, d)) * d ** -0.5).astype(np.float32)
    return torch.from_numpy(e), torch.from_numpy(w)


def excess(got: torch.Tensor, ref64: torch.Tensor) -> float:
    """max |got - ref| / (atol + rtol·|ref|): at most 1 within tolerance."""
    return float(((got.double() - ref64).abs() / (TOL + TOL * ref64.abs())).max())


def test_tf32_rounding_is_round_to_nearest():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(np.concatenate([
        rng.standard_normal(100_000), rng.standard_normal(1000) * 1e-30,
        rng.standard_normal(1000) * 1e30]).astype(np.float32))
    hi = tf32_rna(x)
    # the numpy reference: mantissa in [0.5, 1), scaled to 11 bits, rounded half away
    m, ex = np.frexp(x.numpy().astype(np.float64))
    ref = np.ldexp(np.sign(m) * np.floor(np.abs(m) * 2 ** 11 + 0.5) / 2 ** 11, ex)
    np.testing.assert_array_equal(hi.numpy().astype(np.float64), ref)
    assert (hi.view(torch.int32) & 0x1FFF == 0).all()
    # the split: hi + lo represents x to 2^-22 with rounding; truncated
    # parts would leave up to 2^-21
    _, lo = split(x)
    rel = ((hi.double() + lo.double() - x.double()).abs() / x.double().abs()).max()
    assert rel <= 2.0 ** -22
    exact = torch.tensor([1.0, -1.5, 3.0 * 2 ** -20, 0.0])
    assert torch.equal(tf32_rna(exact), exact)


@pytest.mark.parametrize("d", [64, 256])
def test_three_pass_product_within_card_tolerance(d):
    e, w = inputs(d, seed=d)
    ref64 = e.double() @ w.double()
    assert excess(e @ w, ref64) <= 1.0  # the plain f32 product, the card's reference
    assert excess(three_pass(e, w), ref64) <= 1.0
    # and against the plain f32 product itself, as the card test compares
    torch.testing.assert_close(three_pass(e, w), e @ w, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("d", [64, 256])
def test_single_tf32_pass_misses_card_tolerance(d):
    e, w = inputs(d, seed=d)
    ref64 = e.double() @ w.double()
    assert excess(tf32_rna(e) @ tf32_rna(w), ref64) > 10.0
