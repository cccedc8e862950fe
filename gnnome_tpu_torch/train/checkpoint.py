"""Model parameters in the JAX package's ``.npz`` format.

``gnnome_tpu/train/checkpoint.py:24-38`` stores a parameter tree as one
``.npz`` of leaves keyed by JAX tree paths, e.g. ``['layers'][3]['A1']['w']``.
The port keeps the same tree (nested dicts and a list of layers) and the
same weight layout (``w`` is ``[fan_in, fan_out]``), so a file moves between
the packages key for key: :func:`params_from_jax` reads one,
:func:`flatten_params` / :func:`save_params` write one.
"""
from __future__ import annotations

import os
import re
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

_KEY_PART = re.compile(r"\['([^']*)'\]|\[(\d+)\]")


def _parse_key(key: str) -> list:
    parts, pos = [], 0
    for m in _KEY_PART.finditer(key):
        if m.start() != pos:
            raise KeyError(f"not a JAX tree-path key: {key!r}")
        parts.append(m.group(1) if m.group(1) is not None else int(m.group(2)))
        pos = m.end()
    if pos != len(key) or not parts:
        raise KeyError(f"not a JAX tree-path key: {key!r}")
    return parts


def iter_leaves(tree: Any, prefix: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    """(JAX tree-path key, leaf) pairs in the JAX package's flatten order
    (dict keys sorted, list items in order)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from iter_leaves(tree[k], f"{prefix}['{k}']")
    elif isinstance(tree, (list, tuple)):
        for i, item in enumerate(tree):
            yield from iter_leaves(item, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def params_from_jax(arrays: Dict[str, np.ndarray], device="cuda") -> Dict:
    """JAX tree-path keyed arrays (a loaded ``.npz``) → the port's parameter
    tree, as float tensors on ``device``. Integer path parts become list
    indices, which must run 0..n-1 without gaps."""
    root: Dict = {}
    for key, arr in arrays.items():
        parts = _parse_key(key)
        node = root
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = torch.from_numpy(np.array(arr, copy=True)).to(device)

    def listify(node):
        if not isinstance(node, dict):
            return node
        if node and all(isinstance(k, int) for k in node):
            if sorted(node) != list(range(len(node))):
                raise KeyError(f"list indices with gaps: {sorted(node)}")
            return [listify(node[i]) for i in range(len(node))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def flatten_params(params: Any) -> Dict[str, np.ndarray]:
    """The port's parameter tree → JAX tree-path keyed numpy arrays."""
    return {k: v.detach().cpu().numpy() for k, v in iter_leaves(params)}


def save_params(path: str, params: Any) -> None:
    """Write parameters as the JAX package's ``.npz`` (tmp + rename)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **flatten_params(params))
    os.replace(tmp, path)


def load_params(path: str, params_template: Any) -> Dict:
    """Load a JAX-format ``.npz`` into the layout of ``params_template``.

    Every template leaf must be in the file with its shape, and every array
    in the file must be a template leaf: a file for another model size or
    config raises instead of loading partly. Leaves take the template's
    dtype and device."""
    with np.load(path, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    template = dict(iter_leaves(params_template))
    missing = sorted(set(template) - set(arrays))
    unused = sorted(set(arrays) - set(template))
    if missing or unused:
        raise KeyError(f"{path}: missing leaves {missing[:5]}, unused arrays {unused[:5]}")
    for key, leaf in template.items():
        if tuple(arrays[key].shape) != tuple(leaf.shape):
            raise ValueError(f"{path}: {key} has shape {arrays[key].shape}, "
                             f"expected {tuple(leaf.shape)}")
    return _fill(params_template, arrays)


def _fill(template: Any, arrays: Dict[str, np.ndarray], prefix: str = "") -> Any:
    if isinstance(template, dict):
        return {k: _fill(v, arrays, f"{prefix}['{k}']") for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return [_fill(v, arrays, f"{prefix}[{i}]") for i, v in enumerate(template)]
    return torch.from_numpy(np.array(arrays[prefix], copy=True)).to(
        device=template.device, dtype=template.dtype)
