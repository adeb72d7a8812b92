"""Weight interop with the reference's parameter trees.

``flatten_params_to_torch_layout`` is the port's own numpy copy of the
reference's ``engine/compat.py`` function of the same name: convs exported
OIHW under ``<path>.weight``, BatchNorm as weight / bias / running_mean /
running_var, Dense as (out, in).  The port's ``state_dict()`` keys are
exactly these keys, so the reference checkpoint layout is the port's own
``state_dict``.  ``load_flax_variables`` loads a reference model's
``params`` / ``batch_stats`` trees (nested dicts of numpy arrays) into a
port model.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.nn as nn


def conv_flax_to_torch(w: np.ndarray) -> np.ndarray:
    """(H, W, I, O) -> (O, I, H, W)."""
    return np.ascontiguousarray(np.transpose(w, (3, 2, 0, 1)))


def conv_torch_to_flax(w: np.ndarray) -> np.ndarray:
    """(O, I, H, W) -> (H, W, I, O)."""
    return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))


def flatten_params_to_torch_layout(params: Any, batch_stats: Any) -> Dict[str, np.ndarray]:
    """Flatten a flax variable tree into a flat torch-convention dict."""
    out: Dict[str, np.ndarray] = {}

    def emit(path, leaf_name, arr):
        out[".".join(path + [leaf_name])] = np.asarray(arr)

    def walk(prefix, node, stats_node):
        for k, v in node.items():
            stats_v = stats_node.get(k, {}) if isinstance(stats_node, dict) else {}
            if isinstance(v, dict):
                if set(v) >= {"scale", "bias"} and not isinstance(v["scale"], dict):
                    base = prefix + [k]
                    emit(base, "weight", v["scale"])
                    emit(base, "bias", v["bias"])
                    if isinstance(stats_v, dict) and "mean" in stats_v:
                        emit(base, "running_mean", stats_v["mean"])
                        emit(base, "running_var", stats_v["var"])
                elif set(v) >= {"kernel"} and not isinstance(v["kernel"], dict):
                    base = prefix + [k]
                    kern = np.asarray(v["kernel"])
                    if kern.ndim == 4:
                        emit(base, "weight", conv_flax_to_torch(kern))
                    elif kern.ndim == 2:
                        emit(base, "weight", np.ascontiguousarray(kern.T))
                    else:
                        emit(base, "weight", kern)
                    if "bias" in v:
                        emit(base, "bias", v["bias"])
                else:
                    walk(prefix + [k], v, stats_v)
            else:
                emit(prefix, k, v)

    walk([], params, batch_stats if isinstance(batch_stats, dict) else {})
    return out


def _as_dict(tree: Any) -> Any:
    """FrozenDict / Mapping trees -> plain nested dicts of numpy arrays."""
    if hasattr(tree, "items"):
        return {k: _as_dict(v) for k, v in tree.items()}
    return np.asarray(tree)


def load_flax_variables(model: nn.Module, params: Any, batch_stats: Any) -> None:
    """Load reference ``params`` / ``batch_stats`` into ``model`` in place.
    The key sets must be equal and every shape must match."""
    flat = flatten_params_to_torch_layout(_as_dict(params), _as_dict(batch_stats or {}))
    sd = model.state_dict()
    missing, extra = sorted(set(sd) - set(flat)), sorted(set(flat) - set(sd))
    if missing or extra:
        raise KeyError(f"state_dict mismatch: missing {missing[:5]}, unexpected {extra[:5]}")
    new = {}
    for k, v in sd.items():
        src = torch.from_numpy(np.array(flat[k], dtype=np.float32))
        if tuple(src.shape) != tuple(v.shape):
            raise ValueError(f"{k}: shape {tuple(src.shape)} != {tuple(v.shape)}")
        new[k] = src.to(dtype=v.dtype, device=v.device)
    model.load_state_dict(new)
