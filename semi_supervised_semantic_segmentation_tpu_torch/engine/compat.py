"""Weight and checkpoint interop with the reference (counterpart of the
reference's ``engine/compat.py``).

``flatten_params_to_torch_layout`` is the port's own numpy copy of the
reference's function of the same name: convs exported OIHW under
``<path>.weight``, BatchNorm as weight / bias / running_mean /
running_var, Dense as (out, in).  The port's ``state_dict()`` keys are
exactly these keys, so the reference checkpoint layout is the port's own
``state_dict``.  ``load_flax_variables`` loads a reference model's
``params`` / ``batch_stats`` trees (nested dicts of numpy arrays) into a
port model.

Reference-layout checkpoint files: ``export_reference_checkpoint`` writes
``torch.save({'model', 'ema_model' | 'model2', 'optimizer', 'epoch',
'best_miou', 'step'})`` (:func:`reference_checkpoint`, which the port's
checkpoint manager also writes into its slots) with the optimizer in
torch's ``state_dict()`` layout (two param groups per net, backbone and
head at ``lr * head_lr_mult``, the momentum buffers indexed in the
reference's parameter order, CPS's net1 then net2);
``import_reference_checkpoint`` reads such a file back (a file without
``optimizer`` restarts momentum).  ``load_pretrained_encoder`` maps a
torchvision ResNet or an official HRNet state dict onto the encoder.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List

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


def _to_numpy(v) -> np.ndarray:
    return v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


def load_flat(model: nn.Module, flat: Dict[str, Any]) -> None:
    """Load a flat torch-layout dict into ``model`` in place.  The key sets
    must be equal and every shape must match."""
    sd = model.state_dict()
    missing, extra = sorted(set(sd) - set(flat)), sorted(set(flat) - set(sd))
    if missing or extra:
        raise KeyError(f"state_dict mismatch: missing {missing[:5]}, unexpected {extra[:5]}")
    new = {}
    for k, v in sd.items():
        src = torch.from_numpy(np.array(_to_numpy(flat[k]), dtype=np.float32))
        if tuple(src.shape) != tuple(v.shape):
            raise ValueError(f"{k}: shape {tuple(src.shape)} != {tuple(v.shape)}")
        new[k] = src.to(dtype=v.dtype, device=v.device)
    model.load_state_dict(new)


def load_flax_variables(model: nn.Module, params: Any, batch_stats: Any) -> None:
    """Load reference ``params`` / ``batch_stats`` into ``model`` in place."""
    load_flat(model, flatten_params_to_torch_layout(_as_dict(params),
                                                    _as_dict(batch_stats or {})))


# ---------------------------------------------------------------------------
# torchvision ResNet / official HRNet state dicts -> the encoder
# ---------------------------------------------------------------------------

_TV_BLOCK = re.compile(r"^layer(\d+)\.(\d+)\.(.+)$")
_HR_LAYER1 = re.compile(r"^layer1\.(\d+)\.(.+)$")
_HR_TRANS = re.compile(r"^transition(\d)\.(\d+)\.(.+)$")
_HR_STAGE = re.compile(r"^stage(\d)\.(\d+)\.(.+)$")


class _Flat:
    """Collects encoder names (the reference's flat torch-layout names)
    from a source state dict."""

    def __init__(self, sd: Dict[str, Any]):
        self.sd, self.out = sd, {}

    def conv(self, base: str, w) -> None:
        self.out[f"{base}.Conv_0.weight"] = _to_numpy(w)

    def bn(self, base: str, src: str) -> None:
        bn = f"{base}.Norm_0.BatchNorm_0"
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            self.out[f"{bn}.{leaf}"] = _to_numpy(self.sd[f"{src}.{leaf}"])

    def block(self, ours: str, src: str, rest: str, w) -> None:
        """convK / bnK / downsample.{0,1} of a torchvision-style block."""
        if rest.startswith("conv") and rest.endswith(".weight"):
            self.conv(f"{ours}.conv{rest[4]}", w)
        elif rest.startswith("bn") and rest.endswith(".weight"):
            self.bn(f"{ours}.conv{rest[2]}", f"{src}.bn{rest[2]}")
        elif rest == "downsample.0.weight":
            self.conv(f"{ours}.downsample", w)
        elif rest == "downsample.1.weight":
            self.bn(f"{ours}.downsample", f"{src}.downsample.1")


def torchvision_resnet_to_port(sd: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """torchvision ResNet names -> the encoder's: conv1/bn1 -> stem,
    layerL.B.* -> layerL_B.*; fc.* dropped."""
    f = _Flat(sd)
    f.conv("stem", sd["conv1.weight"])
    f.bn("stem", "bn1")
    for key in sd:
        m = _TV_BLOCK.match(key)
        if m:
            stage, blk, rest = m.groups()
            f.block(f"layer{stage}_{blk}", f"layer{stage}.{blk}", rest, sd[key])
    return f.out


def hrnet_to_port(sd: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Official HRNet names -> the encoder's: conv1/bn1, conv2/bn2 -> stem1,
    stem2; layer1.B.* -> layer1_B.*; transitionT.I.[0.]{0,1} ->
    transitionT_I; stageS.M.branches.I.B.* -> stageS_mM.branchI_blockB.*;
    stageS.M.fuse_layers.I.J.{0,1} -> fuse_up_J_to_I (J > I) and
    .I.J.K.{0,1} -> fuse_down_J_to_I_K (J < I).  Classification heads are
    dropped."""
    f = _Flat(sd)
    f.conv("stem1", sd["conv1.weight"])
    f.bn("stem1", "bn1")
    f.conv("stem2", sd["conv2.weight"])
    f.bn("stem2", "bn2")
    for key in sd:
        if not key.endswith(".weight"):
            continue  # BN biases and statistics come with their .weight
        w = sd[key]
        m = _HR_LAYER1.match(key)
        if m:
            f.block(f"layer1_{m.group(1)}", f"layer1.{m.group(1)}", m.group(2), w)
            continue
        m = _HR_TRANS.match(key)
        if m:
            t, idx, rest = m.groups()
            base, src = f"transition{t}_{idx}", f"transition{t}.{idx}"
            if rest.startswith("0.") and rest.count(".") == 2:
                rest, src = rest[2:], src + ".0"  # a new branch nests one Sequential more
            if rest == "0.weight":
                f.conv(base, w)
            elif rest == "1.weight":
                f.bn(base, f"{src}.1")
            continue
        m = _HR_STAGE.match(key)
        if not m:
            continue
        s, mod, rest = m.groups()
        ours = f"stage{s}_m{mod}"
        bm = re.match(r"^branches\.(\d+)\.(\d+)\.(.+)$", rest)
        if bm:
            i, b, r2 = bm.groups()
            f.block(f"{ours}.branch{i}_block{b}", f"stage{s}.{mod}.branches.{i}.{b}", r2, w)
            continue
        fm = re.match(r"^fuse_layers\.(\d+)\.(\d+)\.(.+)$", rest)
        if not fm:
            continue
        i, j, r2 = int(fm.group(1)), int(fm.group(2)), fm.group(3)
        src = f"stage{s}.{mod}.fuse_layers.{i}.{j}"
        if j > i:
            if r2 == "0.weight":
                f.conv(f"{ours}.fuse_up_{j}_to_{i}", w)
            elif r2 == "1.weight":
                f.bn(f"{ours}.fuse_up_{j}_to_{i}", f"{src}.1")
            continue
        km = re.match(r"^(\d+)\.([01])\.weight$", r2)
        if km:
            base = f"{ours}.fuse_down_{j}_to_{i}_{km.group(1)}"
            if km.group(2) == "0":
                f.conv(base, w)
            else:
                f.bn(base, f"{src}.{km.group(1)}.1")
    return f.out


def load_pretrained_encoder(path: str, model: nn.Module) -> None:
    """Load a torch encoder state-dict file (.pt/.pth through
    ``torch.load``, or .npz) into ``model.encoder`` in place, routed by its
    keys: official HRNet or torchvision ResNet.  Every encoder parameter
    must be in the file; BatchNorm statistics the file lacks keep their
    values; names the encoder lacks are dropped, as in the reference."""
    if path.endswith(".npz"):
        sd = dict(np.load(path))
    else:
        obj = torch.load(path, map_location="cpu", weights_only=True)
        sd = obj.get("state_dict", obj) if isinstance(obj, dict) else obj
        sd = {k: v for k, v in sd.items() if torch.is_tensor(v)}
    if "transition1.0.0.weight" in sd:
        flat = hrnet_to_port(sd)
    elif "conv1.weight" in sd and "layer1.0.conv1.weight" in sd:
        flat = torchvision_resnet_to_port(sd)
    else:
        raise ValueError("model.pretrained: unrecognized state-dict layout (expected a "
                         f"torchvision ResNet or an official HRNet); got keys like {sorted(sd)[:5]}")
    enc = model.encoder
    missing = sorted(n for n, _ in enc.named_parameters() if n not in flat)
    if missing:
        raise KeyError(f"model.pretrained: the file lacks encoder parameters {missing[:5]}")
    sd_enc = enc.state_dict()
    new = {}
    for k, v in flat.items():
        if k not in sd_enc:
            continue
        src = torch.from_numpy(np.array(v, dtype=np.float32))
        if tuple(src.shape) != tuple(sd_enc[k].shape):
            raise ValueError(f"model.pretrained: {k}: shape {tuple(src.shape)} != "
                             f"{tuple(sd_enc[k].shape)}")
        new[k] = src
    enc.load_state_dict(new, strict=False)


# ---------------------------------------------------------------------------
# Optimizer state (torch SGD momentum_buffer <-> the port's SGD buffers)
# ---------------------------------------------------------------------------


def reference_param_order(model: nn.Module) -> List[str]:
    """Parameter names in the reference's enumeration: its flat
    torch-layout walk over a parameter tree whose dict keys are sorted at
    every level (as ``jax.device_get`` returns them), a module's weight
    (kernel or scale) before its bias."""
    rank = {"weight": 0, "bias": 1}
    names = [n for n, _ in model.named_parameters()]
    bad = [n for n in names if n.rsplit(".", 1)[-1] not in rank]
    if bad:
        raise ValueError(f"parameters outside the reference layout: {bad[:5]}")
    return sorted(names, key=lambda n: (n.split(".")[:-1], rank[n.rsplit(".", 1)[-1]]))


def _named_buffers(state, net: nn.Module = None) -> Dict[str, torch.Tensor]:
    """Parameter name of ``net`` (default: the student, ``state.model``) ->
    the SGD momentum buffer of that parameter."""
    opt = state.optimizer
    by_id = {id(p): b for (params, _), bufs in zip(opt.groups, opt.bufs)
             for p, b in zip(params, bufs)}
    return {n: by_id[id(p)] for n, p in (state.model if net is None else net).named_parameters()}


def _indexed_params(state) -> List[tuple]:
    """(net, parameter name) in the reference's index space: each net's
    parameters in :func:`reference_param_order`, net1's before net2's."""
    return [(net, n) for net in state.nets() for n in reference_param_order(net)]


def export_optimizer_state(state, optim) -> Dict[str, Any]:
    """The reference's ``state_dict(opt)``: ``{'state': {idx:
    {'momentum_buffer'}}, 'param_groups': [backbone, head] per net}``,
    indexed by :func:`_indexed_params` (CPS: both nets in one index space,
    four groups), with the group lrs at ``optim.lr`` and ``optim.lr *
    head_lr_mult`` (``optim``: the run's ``cfg.optim``)."""
    from semi_supervised_semantic_segmentation_tpu_torch.engine.state import is_head

    out, param_groups, idx = {}, [], 0
    for net in state.nets():
        bufs = _named_buffers(state, net)
        groups = {"backbone": [], "head": []}
        for name in reference_param_order(net):
            out[idx] = {"momentum_buffer": bufs[name].detach().float().cpu().clone()}
            groups["head" if is_head(name) else "backbone"].append(idx)
            idx += 1
        param_groups += [{
            "params": groups[g], "lr": float(optim.lr) * mult,
            "momentum": float(optim.momentum), "weight_decay": float(optim.weight_decay),
            "nesterov": bool(optim.nesterov), "dampening": 0.0,
        } for g, mult in (("backbone", 1.0), ("head", float(optim.head_lr_mult)))]
    return {"state": out, "param_groups": param_groups}


def import_optimizer_state(opt_dict: Dict[str, Any], state) -> None:
    """Inverse of :func:`export_optimizer_state`: copy the momentum buffers
    into the port's SGD in place."""
    raw = {int(k): v["momentum_buffer"] for k, v in opt_dict["state"].items()}
    names = _indexed_params(state)
    if len(raw) != len(names):
        raise ValueError(f"optimizer state has {len(raw)} buffers but the model enumerates "
                         f"{len(names)} parameters")
    bufs = {id(net): _named_buffers(state, net) for net in state.nets()}
    with torch.no_grad():
        for idx, (net, name) in enumerate(names):
            if idx not in raw:
                raise ValueError(f"optimizer state missing index {idx} (param {name!r})")
            src = torch.as_tensor(_to_numpy(raw[idx]))
            dst = bufs[id(net)][name]
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"momentum of {name}: shape {tuple(src.shape)} != "
                                 f"{tuple(dst.shape)}")
            dst.copy_(src.to(dst.dtype))


# ---------------------------------------------------------------------------
# Reference-layout checkpoint files (torch.save dict)
# ---------------------------------------------------------------------------


def _cpu_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    return {k: v.detach().float().cpu().clone() for k, v in model.state_dict().items()}


def reference_checkpoint(state, meta: dict, optim) -> Dict[str, Any]:
    """``{'model', 'ema_model' | 'model2', 'optimizer', 'epoch',
    'best_miou', 'step'}`` as CPU copies of the state (the optimizer's
    groups from ``optim``, the run's ``cfg.optim``)."""
    out: Dict[str, Any] = {
        "epoch": int(meta.get("epoch", 0)),
        "best_miou": float(meta.get("best_miou", 0.0)),
        "step": int(state.step),
        "model": _cpu_state_dict(state.model),
    }
    if state.ema_model is not None:
        out["ema_model"] = _cpu_state_dict(state.ema_model)
    if state.model2 is not None:
        out["model2"] = _cpu_state_dict(state.model2)
    out["optimizer"] = export_optimizer_state(state, optim)
    return out


def export_reference_checkpoint(path: str, state, meta: dict, cfg) -> None:
    """Write :func:`reference_checkpoint` with ``torch.save``."""
    torch.save(reference_checkpoint(state, meta, cfg.optim), path)


def load_reference_checkpoint(obj: Dict[str, Any], state) -> None:
    """Load a reference-layout checkpoint dict into ``state`` in place: the
    model, the EMA teacher or CPS's second net when both sides have one, the
    step and, when the dict has ``optimizer``, the momentum buffers (else
    momentum restarts)."""
    load_flat(state.model, obj["model"])
    if "ema_model" in obj and state.ema_model is not None:
        load_flat(state.ema_model, obj["ema_model"])
    if "model2" in obj and state.model2 is not None:
        load_flat(state.model2, obj["model2"])
    state.step = int(obj.get("step", 0))
    if "optimizer" in obj:
        import_optimizer_state(obj["optimizer"], state)


def import_reference_checkpoint(path: str, state):
    """Read a reference-layout checkpoint file into ``state`` in place
    (:func:`load_reference_checkpoint`).  Returns the file's ``{'epoch',
    'best_miou'}``."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(obj, dict) or "model" not in obj:
        raise ValueError(f"{path}: not a reference-layout checkpoint (no 'model' entry)")
    load_reference_checkpoint(obj, state)
    return {"epoch": int(obj.get("epoch", 0)), "best_miou": float(obj.get("best_miou", 0.0))}
