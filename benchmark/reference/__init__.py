"""The plain references the benchmark holds the program to. Nothing in this package imports the program.

Each configuration names its reference model by the key ``reference``: a
``.py`` file directly under this directory, imported as
``benchmark.reference.<stem>``. ``load`` gives that module, checked against
``CONTRACT`` (stated in ``model.py``'s docstring); every cell, control and
FLOP count of the configuration takes its reference from it, so a new
architecture comes as new files.
"""
from __future__ import annotations

import importlib
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent.parent
DIR = Path(__file__).resolve().parent  # where a configuration's reference lives
CONTRACT = ("init_params", "forward", "train_step", "Adam", "bce_loss", "CONTROL_BITS",
            "exact_f32_products", "forward_flops")


def load(config: dict):
    """The reference module of ``config``; raises ValueError, naming the
    configuration and the key, where ``config["reference"]`` is no ``.py``
    file under ``DIR`` or its module lacks part of ``CONTRACT``."""
    key = config.get("reference")
    where = f"configuration {config.get('name')!r}, key 'reference' ({key!r})"
    path = (ROOT / key).resolve() if isinstance(key, str) else None
    if path is None or path.parent != DIR or path.suffix != ".py" or not path.is_file():
        raise ValueError(f"{where}: not a .py file under {DIR.relative_to(ROOT)}/")
    module = importlib.import_module(".".join(DIR.relative_to(ROOT).parts + (path.stem,)))
    missing = [name for name in CONTRACT if not hasattr(module, name)]
    if missing:
        raise ValueError(f"{where}: the module lacks {', '.join(missing)}")
    return module
