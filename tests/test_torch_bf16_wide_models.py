"""bf16 compute for the wide-gather models on the CPU, held against the JAX
package's bf16: the BatchNorm model with ``wide_gathers=True`` and
``"src"`` and the LayerNorm model with ``wide_gathers=True`` (2 layers,
D = 128, banded graph), their logits, gradients and one training step, with
the checks and tolerances of tests/test_torch_bf16_wide.py (the port within
twice the spread of JAX's ``xla`` and ``pallas_interpret`` backends,
measured here). A file of its own, so that the two run on two test workers.
"""
import pytest

from test_torch_bf16 import check_grads, check_logits
from test_torch_bf16_wide import BN_CANCELLED, bf16_model_runs, check_train_step

VARIANTS = {  # name: (batch_norm, wide_gathers)
    "wide": (True, True), "wide_src": (True, "src"), "layernorm_wide": (False, True)}


@pytest.fixture(scope="module", params=list(VARIANTS))
def wide_runs(request):
    return bf16_model_runs(*VARIANTS[request.param])


def test_wide_bf16_logits_match_jax(wide_runs):
    check_logits(wide_runs)


def test_wide_bf16_grads_match_jax(wide_runs):
    check_grads(wide_runs, BN_CANCELLED if wide_runs["batch_norm"] else ())


def test_wide_bf16_train_step_matches_jax(wide_runs):
    check_train_step(wide_runs)
