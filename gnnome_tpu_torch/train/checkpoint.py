"""Model parameters and training checkpoints in the JAX package's ``.npz``
format.

``gnnome_tpu/train/checkpoint.py:24-38`` stores a parameter tree as one
``.npz`` of leaves keyed by JAX tree paths, e.g. ``['layers'][3]['A1']['w']``.
The port keeps the same tree (nested dicts and a list of layers) and the
same weight layout (``w`` is ``[fan_in, fan_out]``), so a file moves between
the packages key for key: :func:`params_from_jax` reads one,
:func:`flatten_params` / :func:`save_params` write one.

A training checkpoint (``gnnome_tpu/train/checkpoint.py:41-75``) is one
``.npz`` of ``params``-prefixed parameter leaves and ``opt``-prefixed
optimizer leaves, plus a ``<path>.json`` sidecar of scalars (epoch, lr,
scheduler, loss histories). The optimizer leaves are those
``optax.inject_hyperparams(optax.adam)`` flattens to; they map onto
``torch.optim.Adam``'s state as ``mu`` → ``exp_avg``, ``nu`` →
``exp_avg_sq``, ``count`` → ``step`` and ``hyperparams['learning_rate']``
→ the group's lr (:func:`opt_state_to_jax`, :func:`opt_state_from_jax`),
so a run resumes in either package from the other's checkpoint.
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Iterator, Optional, Tuple

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


def _check_leaves(path: str, what: str, arrays: Dict[str, np.ndarray],
                  expected: Dict[str, tuple]) -> None:
    """Raise unless ``arrays`` holds exactly the ``expected`` leaves, each
    with its shape: a file for another model size or config is refused,
    never loaded partly or broadcast."""
    missing = sorted(set(expected) - set(arrays))
    unused = sorted(set(arrays) - set(expected))
    if missing or unused:
        raise KeyError(f"{path}: {what}: missing leaves {missing[:5]}, "
                       f"unused arrays {unused[:5]}")
    for key, shape in expected.items():
        if tuple(np.shape(arrays[key])) != tuple(shape):
            raise ValueError(f"{path}: {what}{key} has shape {np.shape(arrays[key])}, "
                             f"expected {tuple(shape)}")


def load_params(path: str, params_template: Any) -> Dict:
    """Load a JAX-format ``.npz`` into the layout of ``params_template``.

    Every template leaf must be in the file with its shape, and every array
    in the file must be a template leaf: a file for another model size or
    config raises instead of loading partly. Leaves take the template's
    dtype and device."""
    with np.load(path, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    _check_leaves(path, "params", arrays,
                  {k: tuple(leaf.shape) for k, leaf in iter_leaves(params_template)})
    return _fill(params_template, arrays)


def _fill(template: Any, arrays: Dict[str, np.ndarray], prefix: str = "") -> Any:
    if isinstance(template, dict):
        return {k: _fill(v, arrays, f"{prefix}['{k}']") for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return [_fill(v, arrays, f"{prefix}[{i}]") for i, v in enumerate(template)]
    return torch.from_numpy(np.array(arrays[prefix], copy=True)).to(
        device=template.device, dtype=template.dtype)


_ADAM = ".inner_state[0]"  # optax.adam's ScaleByAdamState inside inject_hyperparams


def opt_state_to_jax(opt: torch.optim.Adam, params: Any) -> Dict[str, np.ndarray]:
    """``torch.optim.Adam`` state → the JAX package's optimizer-state arrays,
    keyed as ``jax.tree_util.keystr`` names them (no ``opt`` prefix)."""
    group = opt.param_groups[0]
    b1, b2 = group["betas"]
    out: Dict[str, np.ndarray] = {}
    step = 0
    for key, leaf in iter_leaves(params):
        st = opt.state.get(leaf, {})
        zeros = np.zeros(tuple(leaf.shape), np.float32)
        out[f"{_ADAM}.mu{key}"] = st["exp_avg"].detach().cpu().numpy() if st else zeros
        out[f"{_ADAM}.nu{key}"] = st["exp_avg_sq"].detach().cpu().numpy() if st else zeros
        step = int(st["step"]) if st else 0
    out[".count"] = out[f"{_ADAM}.count"] = np.int32(step)
    hyper = {"b1": b1, "b2": b2, "eps": group["eps"], "eps_root": 0.0,
             "learning_rate": group["lr"]}
    for name, value in hyper.items():
        out[f".hyperparams['{name}']"] = np.float32(value)
    return out


def opt_state_from_jax(arrays: Dict[str, np.ndarray], params: Any,
                       opt: torch.optim.Adam) -> None:
    """Load the JAX package's optimizer-state arrays (keys as
    :func:`opt_state_to_jax` writes them) into ``opt``, whose parameters
    are the leaves of ``params``."""
    group = opt.param_groups[0]
    group["lr"] = float(arrays[".hyperparams['learning_rate']"])
    group["betas"] = (float(arrays[".hyperparams['b1']"]),
                      float(arrays[".hyperparams['b2']"]))
    group["eps"] = float(arrays[".hyperparams['eps']"])
    if float(arrays[".hyperparams['eps_root']"]) != 0.0:
        raise ValueError("torch.optim.Adam has no eps_root; the state needs eps_root=0")
    step = int(arrays[f"{_ADAM}.count"])
    opt.state.clear()
    if step == 0:
        return
    for key, leaf in iter_leaves(params):
        opt.state[leaf] = {
            "step": torch.tensor(float(step), dtype=torch.float32),
            "exp_avg": torch.from_numpy(np.array(arrays[f"{_ADAM}.mu{key}"])).to(
                device=leaf.device, dtype=leaf.dtype),
            "exp_avg_sq": torch.from_numpy(np.array(arrays[f"{_ADAM}.nu{key}"])).to(
                device=leaf.device, dtype=leaf.dtype),
        }


def save_checkpoint(path: str, params: Any, opt: torch.optim.Adam, epoch: int,
                    scalars: Optional[Dict[str, Any]] = None) -> None:
    """Write a training checkpoint the JAX package's ``load_checkpoint``
    reads (npz via tmp + rename, then the JSON sidecar)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    arrays = {f"params{k}": v for k, v in flatten_params(params).items()}
    arrays.update({f"opt{k}": v for k, v in opt_state_to_jax(opt, params).items()})
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)
    with open(path + ".json", "w") as f:
        json.dump({"epoch": epoch, **(scalars or {})}, f)


def load_checkpoint(path: str, params: Any,
                    opt: torch.optim.Adam) -> Tuple[int, Dict[str, Any]]:
    """Restore a training checkpoint of either package into ``params`` (in
    place, so ``opt`` keeps its parameters) and ``opt``. Returns
    ``(epoch, meta)``; ``epoch`` is -1 when the file has no sidecar.

    As strict as :func:`load_params`: the ``params`` leaves and the ``opt``
    leaves must be exactly those of this model and optimizer, shapes
    included, or it raises naming the leaf, before anything is changed.
    (The JAX package's ``load_checkpoint`` is laxer: a checkpoint of another
    depth would load partly there.)"""
    with np.load(path, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    stray = sorted(k for k in arrays if not k.startswith(("params", "opt")))
    if stray:
        raise KeyError(f"{path}: arrays that are neither params nor opt: {stray[:5]}")
    file_params = {k[len("params"):]: v for k, v in arrays.items() if k.startswith("params")}
    file_opt = {k[len("opt"):]: v for k, v in arrays.items() if k.startswith("opt")}
    _check_leaves(path, "params", file_params,
                  {k: tuple(leaf.shape) for k, leaf in iter_leaves(params)})
    _check_leaves(path, "opt", file_opt,
                  {k: np.shape(v) for k, v in opt_state_to_jax(opt, params).items()})
    with torch.no_grad():
        for key, leaf in iter_leaves(params):
            leaf.copy_(torch.from_numpy(np.array(file_params[key])))
    opt_state_from_jax(file_opt, params, opt)
    meta: Dict[str, Any] = {}
    if os.path.exists(path + ".json"):
        with open(path + ".json") as f:
            meta = json.load(f)
    return int(meta.get("epoch", -1)), meta
