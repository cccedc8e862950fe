"""train.mfu (%): the model FLOPs of the traced optimizer steps
(``benchmark/flops.py``: forward and backward, recompute not counted) over
the traced window and the H100's tensor-core peak of the configuration's
``compute_dtype``: bf16's for a bfloat16 model, TF32's for a float32 one.
TF32's and not float32's: the port's f32 gate product already runs
split-TF32 on the tensor cores, so a share of the f32 peak could pass 100%
for a sound program."""
from benchmark.flops import step_flops
from benchmark.peaks import BF16_TC_OPS_PER_S, TF32_TC_OPS_PER_S

PEAKS = {"float32": TF32_TC_OPS_PER_S, "bfloat16": BF16_TC_OPS_PER_S}


def read(view):
    if not view.steps:
        return None
    flops = sum(step_flops(view.model, g["nr"], g["er"]) for g in view.steps)
    return 100.0 * flops / view.window_s / PEAKS[view.model["compute_dtype"]]
