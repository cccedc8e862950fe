"""dense.torch_ms.train (ms): device time a traced optimizer step of the
kernels that are neither the program's own nor cuBLAS's: PyTorch's
elementwise work, norms, reductions and Adam (``chip_smoke.py``
``kernel_group``'s "other PyTorch kernels" and its Adam group)."""


def read(view):
    if not view.steps:
        return None
    return 1e3 * sum(s for _, group, s in view.kernels if group == "other") / len(view.steps)
