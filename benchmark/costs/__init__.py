"""Operations and bytes of one launch of each kernel entry of the program,
one file an entry, named as the entry (``gnnome_tpu_torch/ops/*.py``
``Kernel`` names).

Each file's ``cost(ints, g)`` returns ``(bytes, operations, peak
operations/s)``: ``ints`` are the launch's integer arguments in the
entry's own order, ``g`` the graph it ran on (``n``/``e``: padded nodes
and edge rows, ``er`` real edges, ``u_src``/``u_dst`` the distinct
endpoints of the real edges). Each input byte is counted once and each
output byte once, 4 bytes a float32 element or id, whatever the kernel
reads again (the byte counts of ``chip_smoke.py``'s parity phase, which
gave ``PERF.md``'s kernel table its bound column).
"""
import importlib.util
from pathlib import Path

HERE = Path(__file__).resolve().parent


def load(entry: str):
    """The ``cost`` function of ``entry``, or None where it has no file."""
    path = HERE / f"{entry}.py"
    if not path.is_file():
        return None
    spec = importlib.util.spec_from_file_location(f"benchmark_cost_{entry}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.cost


def distinct(g: dict, side: str) -> int:
    """Distinct rows the real edges read on one side; the node count where
    the graph's endpoints were not counted (never more than are there)."""
    return g.get(f"u_{side}", g["nr"])
