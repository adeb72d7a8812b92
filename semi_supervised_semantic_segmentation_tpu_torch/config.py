"""Config system: frozen dataclass tree <- YAML / ``--set`` overrides.

Counterpart of the JAX package's ``config.py``: the same sections, fields,
defaults, flat reference aliases and validation rules, so the five
``configs/*.yaml`` load into equal values on both sides.

The machine that runs the port has no PyYAML, so the YAML the configs use is
read by :func:`parse_yaml`, a small reader of its own: nested mappings by
indentation, scalars (int, float, bool, null, plain and quoted strings),
``#`` comments, flow lists such as ``eval_scales: [0.5, 0.75]`` and block
lists of scalars (``- 0.5`` lines under their key, at its indent or deeper,
as ``yaml.safe_dump`` writes them).  Flow mappings, nested lists, anchors
and multi-line scalars are refused.  One deliberate difference from YAML
1.1: an unquoted digit string with underscores (``1_16``) stays a string,
as the split names need.  :func:`save_config` writes ``config.yaml`` in the
layout of the reference's ``yaml.safe_dump``, which both this reader and
PyYAML read back.
"""

from __future__ import annotations

import dataclasses
import math
import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple


@dataclass(frozen=True)
class DataConfig:
    dataset: str = "voc"  # voc | cityscapes | synthetic
    data_root: str = "./data"
    split: str = "1_8"  # labeled fraction: 1_16 | 1_8 | 1_4 | full
    num_classes: int = 21
    ignore_index: int = 255
    crop_size: int = 512
    scale_min: float = 0.5
    scale_max: float = 2.0
    hflip_prob: float = 0.5
    mean: Tuple[float, float, float] = (0.485, 0.456, 0.406)
    std: Tuple[float, float, float] = (0.229, 0.224, 0.225)
    jitter_brightness: float = 0.5
    jitter_contrast: float = 0.5
    jitter_saturation: float = 0.5
    jitter_hue: float = 0.25
    jitter_prob: float = 0.8
    grayscale_prob: float = 0.2
    blur_prob: float = 0.5
    # The port has one weak-aug formulation (a two-tap gather); both values
    # are accepted so every reference config loads.
    aug_impl: str = "matmul"
    # CutMix+normalize: 'xla' = plain torch ops, 'pallas' = the Triton
    # kernel of ops/cutmix_normalize.py (the name is the reference's switch).
    cutmix_impl: str = "xla"
    num_workers: int = 4
    synthetic_size: int = 64
    synthetic_gapped: bool = False
    synthetic_canvas: int = 0
    eval_mode: str = "whole"
    eval_size: int = 0
    eval_stride: int = 0
    eval_flip: bool = False
    eval_scales: Tuple[float, ...] = (1.0,)
    eval_impl: str = "auto"
    eval_window_batch: int = 0


@dataclass(frozen=True)
class ModelConfig:
    backbone: str = "resnet50"
    decoder: str = "deeplabv3plus"
    output_stride: int = 16
    pretrained: str = ""
    norm: str = "batchnorm"
    bn_momentum: float = 0.9  # flax convention: ra = m*ra + (1-m)*x
    remat: str = "none"
    # 'pallas' runs the stem through the CUDA kernels of ops/stem.py.
    stem_impl: str = "conv"
    fuse_impl: str = "conv"
    branch_conv: str = "xla"
    head_fuse: str = "conv_first"
    compute_dtype: str = "bfloat16"
    aspp_dilations: Tuple[int, ...] = (6, 12, 18)
    decoder_channels: int = 256
    hrnet_width: int = 48
    hrnet_modules: Tuple[int, int, int] = (1, 4, 3)


@dataclass(frozen=True)
class MethodConfig:
    name: str = "supervised"
    ema_alpha: float = 0.99
    conf_thresh: float = 0.95
    consistency_weight: float = 1.0
    rampup_iters: int = 0
    rampup_kind: str = "sigmoid"
    cps_weight: float = 1.5
    cps_impl: str = "stacked"
    cutmix_prob: float = 1.0
    sup_loss: str = "ce"
    ohem_thresh: float = 0.7
    ohem_min_kept: int = 100000
    consistency_reduction: str = "mean"


@dataclass(frozen=True)
class OptimConfig:
    optimizer: str = "sgd"
    lr: float = 0.01
    momentum: float = 0.9
    weight_decay: float = 1e-4
    nesterov: bool = False
    poly_power: float = 0.9
    head_lr_mult: float = 10.0
    grad_clip_norm: float = 0.0


@dataclass(frozen=True)
class TrainConfig:
    epochs: int = 80
    labeled_batch_size: int = 8
    unlabeled_batch_size: int = 8
    eval_batch_size: int = 8
    iters_per_epoch: int = 0
    eval_interval: int = 1
    log_interval: int = 50
    seed: int = 0
    resume: str = ""
    init_from_torch: str = ""
    work_dir: str = "./runs/default"
    checkpoint_interval: int = 1
    keep_checkpoints: int = 3
    async_checkpoint: bool = True
    debug_nans: bool = False
    profile_steps: int = 0


@dataclass(frozen=True)
class ParallelConfig:
    data_parallel: int = -1
    model_parallel: int = 1
    mesh_axes: Tuple[str, str] = ("data", "model")


@dataclass(frozen=True)
class Config:
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    method: MethodConfig = field(default_factory=MethodConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    name: str = "experiment"

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


_SECTIONS = {
    "data": DataConfig,
    "model": ModelConfig,
    "method": MethodConfig,
    "optim": OptimConfig,
    "train": TrainConfig,
    "parallel": ParallelConfig,
}

# Flat reference-style key aliases -> (section, field).
_FLAT_ALIASES = {
    "dataset": ("data", "dataset"),
    "data_root": ("data", "data_root"),
    "split": ("data", "split"),
    "num_classes": ("data", "num_classes"),
    "ignore_index": ("data", "ignore_index"),
    "crop_size": ("data", "crop_size"),
    "backbone": ("model", "backbone"),
    "decoder": ("model", "decoder"),
    "output_stride": ("model", "output_stride"),
    "pretrained": ("model", "pretrained"),
    "method": ("method", "name"),
    "ema_alpha": ("method", "ema_alpha"),
    "ema_decay": ("method", "ema_alpha"),
    "conf_thresh": ("method", "conf_thresh"),
    "confidence_threshold": ("method", "conf_thresh"),
    "consistency_weight": ("method", "consistency_weight"),
    "lambda_u": ("method", "consistency_weight"),
    "cps_weight": ("method", "cps_weight"),
    "rampup_iters": ("method", "rampup_iters"),
    "lr": ("optim", "lr"),
    "base_lr": ("optim", "lr"),
    "momentum": ("optim", "momentum"),
    "weight_decay": ("optim", "weight_decay"),
    "poly_power": ("optim", "poly_power"),
    "epochs": ("train", "epochs"),
    "batch_size": ("train", "labeled_batch_size"),
    "labeled_batch_size": ("train", "labeled_batch_size"),
    "unlabeled_batch_size": ("train", "unlabeled_batch_size"),
    "seed": ("train", "seed"),
    "resume": ("train", "resume"),
    "work_dir": ("train", "work_dir"),
    "eval_interval": ("train", "eval_interval"),
}


# ---------------------------------------------------------------------------
# The YAML subset reader
# ---------------------------------------------------------------------------

_INT = re.compile(r"^[-+]?[0-9]+$")
_FLOAT = re.compile(r"^[-+]?([0-9]+\.[0-9]*|\.[0-9]+|[0-9]+)([eE][-+]?[0-9]+)?$")
_BOOLS = {
    "true": True, "yes": True, "on": True,
    "false": False, "no": False, "off": False,
}


def _strip_comment(line: str) -> str:
    """Drop a ``#`` comment that starts the line or follows whitespace,
    outside quotes."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "\"'":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _unquote(s: str) -> str:
    if s[0] == '"':
        return s[1:-1].replace('\\"', '"').replace("\\\\", "\\")
    return s[1:-1].replace("''", "'")


def parse_scalar(s: str) -> Any:
    """One YAML scalar: quoted string, null, bool, int, float or string."""
    s = s.strip()
    if len(s) >= 2 and s[0] == s[-1] and s[0] in "\"'":
        return _unquote(s)
    if s in ("", "~", "null", "Null", "NULL"):
        return None
    if s.lower() in _BOOLS:
        return _BOOLS[s.lower()]
    if _INT.match(s):
        return int(s)
    if _FLOAT.match(s):
        return float(s)
    if s.lower() in (".inf", "+.inf"):
        return float("inf")
    if s.lower() == "-.inf":
        return float("-inf")
    if s.lower() == ".nan":
        return float("nan")
    return s


def _split_flow(inner: str) -> List[str]:
    items, cur, quote = [], [], None
    for ch in inner:
        if quote:
            cur.append(ch)
            if ch == quote:
                quote = None
        elif ch in "\"'":
            quote = ch
            cur.append(ch)
        elif ch == ",":
            items.append("".join(cur))
            cur = []
        elif ch in "[]{}":
            raise ValueError(f"nested flow collections are not supported: [{inner}]")
        else:
            cur.append(ch)
    items.append("".join(cur))
    if len(items) == 1 and not items[0].strip():
        return []
    return items


def parse_value(s: str) -> Any:
    """A scalar or a flow list of scalars (also used for ``--set`` values)."""
    s = s.strip()
    if s.startswith("["):
        if not s.endswith("]"):
            raise ValueError(f"unterminated flow list: {s!r}")
        return [parse_scalar(x) for x in _split_flow(s[1:-1])]
    if s.startswith("{") or s.startswith("&") or s.startswith("*") or s[:1] in "|>":
        raise ValueError(f"unsupported YAML construct: {s!r}")
    return parse_scalar(s)


def _split_key(content: str) -> Tuple[str, str]:
    quote = None
    for i, ch in enumerate(content):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "\"'":
            quote = ch
        elif ch == ":" and (i + 1 == len(content) or content[i + 1] == " "):
            key = content[:i].strip()
            if len(key) >= 2 and key[0] == key[-1] and key[0] in "\"'":
                key = _unquote(key)
            return key, content[i + 1:]
    raise ValueError(f"expected 'key: value', got {content!r}")


def parse_yaml(text: str) -> Dict[str, Any]:
    """Parse the YAML subset the configs use into nested dicts."""
    lines = []
    for raw in text.splitlines():
        line = _strip_comment(raw).rstrip()
        if not line.strip() or line.strip() == "---":
            continue
        body = line.lstrip(" ")
        if body.startswith("\t"):
            raise ValueError(f"tab indentation is not supported: {raw!r}")
        lines.append((len(line) - len(body), body))
    root: Dict[str, Any] = {}
    # (the opening key's indent, the mapping, the indent of its keys)
    stack: List[list] = [[-1, root, None]]
    i = 0
    while i < len(lines):
        indent, content = lines[i]
        if _is_item(content):
            raise ValueError(f"a list item outside a key's block list: {content!r}")
        while stack[-1][0] >= indent:
            stack.pop()
        if stack[-1][2] is None:
            stack[-1][2] = indent
        elif stack[-1][2] != indent:
            raise ValueError(f"inconsistent indentation: {content!r}")
        parent = stack[-1][1]
        key, rest = _split_key(content)
        if key in parent:
            raise ValueError(f"duplicate key {key!r}")
        i += 1
        if rest.strip():
            parent[key] = parse_value(rest)
        elif i < len(lines) and _is_item(lines[i][1]) and lines[i][0] >= indent:
            # a block list: its items share one indent, the key's or deeper
            items, item_indent = [], lines[i][0]
            while i < len(lines) and lines[i][0] == item_indent and _is_item(lines[i][1]):
                item = lines[i][1][1:].strip()
                if item.startswith("- ") or item == "-":
                    raise ValueError(f"nested block lists are not supported: {lines[i][1]!r}")
                if _is_mapping(item):
                    raise ValueError(f"lists of mappings are not supported: {lines[i][1]!r}")
                items.append(parse_value(item))
                i += 1
            parent[key] = items
        elif i < len(lines) and lines[i][0] > indent:
            child: Dict[str, Any] = {}
            parent[key] = child
            stack.append([indent, child, None])
        else:
            parent[key] = None
    return root


def _is_item(content: str) -> bool:
    return content.startswith("- ") or content == "-"


def _is_mapping(content: str) -> bool:
    try:
        _split_key(content)
    except ValueError:
        return False
    return True


# ---------------------------------------------------------------------------
# Dataclass construction
# ---------------------------------------------------------------------------


def _coerce(cls: type, value: Any, fname: str) -> Any:
    ftypes = {f.name: f.type for f in dataclasses.fields(cls)}
    t = ftypes[fname]
    if isinstance(value, list):
        return tuple(value)
    if t in ("float", float) and isinstance(value, int) and not isinstance(value, bool):
        return float(value)
    return value


def _build_section(cls: type, d: Dict[str, Any], path: str):
    known = {f.name for f in dataclasses.fields(cls)}
    unknown = set(d) - known
    if unknown:
        raise ValueError(f"Unknown config keys in '{path}': {sorted(unknown)}")
    return cls(**{k: _coerce(cls, v, k) for k, v in d.items()})


def config_from_dict(raw: Dict[str, Any]) -> Config:
    raw = dict(raw or {})
    name = raw.pop("name", "experiment")
    sections: Dict[str, Dict[str, Any]] = {}
    for k in _SECTIONS:
        v = raw.pop(k, {}) or {}
        if not isinstance(v, dict):
            # ``method: fixmatch_cutmix`` is the reference's flat spelling.
            raw[k] = v
            v = {}
        sections[k] = dict(v)
    for key, value in raw.items():
        if key not in _FLAT_ALIASES:
            raise ValueError(f"Unknown config key: '{key}'")
        section, fname = _FLAT_ALIASES[key]
        sections[section].setdefault(fname, value)
    built = {sec: _build_section(cls, sections[sec], sec) for sec, cls in _SECTIONS.items()}
    cfg = Config(name=name, **built)
    validate(cfg)
    return cfg


def _apply_overrides(raw: Dict[str, Any], overrides: Dict[str, Any], create: bool):
    for dotted, value in overrides.items():
        parts = dotted.split(".")
        node = raw
        for p in parts[:-1]:
            node = node.setdefault(p, {}) if create else node[p]
        node[parts[-1]] = value


def load_config(path: str, overrides: Optional[Dict[str, Any]] = None) -> Config:
    """Load a YAML config file, optionally applying dotted-key overrides
    such as ``{"optim.lr": 0.02, "train.epochs": 1}``."""
    with open(path) as f:
        raw = parse_yaml(f.read())
    if overrides:
        _apply_overrides(raw, overrides, create=True)
    return config_from_dict(raw)


def update_config(cfg: Config, overrides: Dict[str, Any]) -> Config:
    """Return a new Config with dotted-path overrides applied."""
    raw = cfg.to_dict()
    raw["name"] = cfg.name
    _apply_overrides(raw, overrides, create=False)
    return config_from_dict(raw)


def parse_overrides(pairs) -> Dict[str, Any]:
    """``["optim.lr=0.02", ...]`` -> ``{"optim.lr": 0.02, ...}``."""
    out = {}
    for pair in pairs:
        if "=" not in pair:
            raise ValueError(f"override must be key=value, got: {pair}")
        k, v = pair.split("=", 1)
        out[k] = parse_value(v)
    return out


_VALID = {
    "data.dataset": {"voc", "cityscapes", "synthetic"},
    "data.split": {"1_16", "1_8", "1_4", "full"},
    "data.aug_impl": {"matmul", "gather"},
    "data.cutmix_impl": {"xla", "pallas"},
    "data.eval_mode": {"whole", "sliding"},
    "data.eval_impl": {"auto", "fused", "staged"},
    "model.backbone": {"resnet18", "resnet50", "resnet101", "hrnet_w48"},
    "model.decoder": {"unet", "deeplabv3plus", "hrnet_head"},
    "model.stem_impl": {"conv", "s2d", "pallas"},
    "model.fuse_impl": {"conv", "s2d"},
    "model.head_fuse": {"conv_first", "up_first"},
    "model.branch_conv": {"xla", "pallas"},
    "method.name": {"supervised", "mean_teacher", "fixmatch_cutmix", "cps"},
    "method.sup_loss": {"ce", "ohem"},
    "method.cps_impl": {"stacked", "separate"},
}


def data_parallel_size(parallel: ParallelConfig, world_size: int) -> int:
    """``parallel.*`` against the number of processes: the data axis's size.

    The processes form a ``(data, model)`` mesh of D x M ranks, M =
    ``model_parallel`` (the reference's spatial H-sharding of HRNet's stem
    over the model axis, ``parallel/spatial.py``).  ``data_parallel: -1`` is
    the world size over M; any other value times M must equal the world size
    (one process per device of the reference's mesh)."""
    m = parallel.model_parallel
    if m < 1 or world_size % m:
        raise ValueError(
            f"parallel.model_parallel={m} but {world_size} process(es) run: the world size "
            "must be data_parallel x model_parallel")
    dp, d = parallel.data_parallel, world_size // m
    if dp == -1:
        return d
    if dp != d:
        raise ValueError(
            f"parallel.data_parallel={dp} but {world_size} process(es) run with "
            f"model_parallel={m}: set it to {d} or -1 (the world size over model_parallel)")
    return dp


def validate(cfg: Config) -> None:
    if not cfg.data.eval_scales or any(
        not isinstance(s, (int, float)) or s <= 0 for s in cfg.data.eval_scales
    ):
        raise ValueError(
            f"data.eval_scales must be positive numbers, got {cfg.data.eval_scales!r}"
        )
    for dotted, allowed in _VALID.items():
        sec, fname = dotted.split(".")
        val = getattr(getattr(cfg, sec), fname)
        if val not in allowed:
            raise ValueError(f"{dotted}={val!r} not in {sorted(allowed)}")
    if cfg.model.output_stride not in (8, 16, 32):
        raise ValueError(f"output_stride must be 8, 16 or 32, got {cfg.model.output_stride}")
    if cfg.parallel.model_parallel < 1:
        raise ValueError("model_parallel must be >= 1")
    if cfg.parallel.model_parallel > 1 and cfg.model.backbone != "hrnet_w48":
        raise ValueError(
            "parallel.model_parallel > 1 (spatial stem sharding) is only "
            "wired for backbone hrnet_w48"
        )
    if cfg.data.crop_size % 32 != 0:
        raise ValueError("crop_size must be a multiple of 32 (encoder stride)")
    if cfg.data.eval_window_batch < 0:
        raise ValueError("data.eval_window_batch must be >= 0 (0 = no chunking)")
    r = cfg.model.remat
    stages_ok = False
    for prefix in ("stages:", "branches:"):
        if r.startswith(prefix):
            tokens = r[len(prefix):].split(",")
            stages_ok = bool(tokens) and all(s in {"1", "2", "3", "4"} for s in tokens)
    if not (r in ("none", "", "blocks", "branches") or stages_ok):
        raise ValueError(
            f"model.remat={r!r}: expected 'none', 'blocks', 'branches', "
            "'stages:i,j', or 'branches:i,j' with single-digit stages from 1-4"
        )
    if r in ("branches",) or r.startswith("stages:") or r.startswith("branches:"):
        if cfg.model.backbone != "hrnet_w48":
            raise ValueError(
                f"model.remat={r!r} is an HRNet-only plan; use 'blocks' or "
                f"'none' with backbone={cfg.model.backbone!r}"
            )
    if cfg.model.branch_conv == "pallas" and cfg.model.backbone != "hrnet_w48":
        raise ValueError(
            "model.branch_conv=pallas is the HRNet branch-chain conv path; "
            f"it has no effect with backbone={cfg.model.backbone!r}"
        )
    if tuple(cfg.data.eval_scales) != (1.0,) and cfg.data.eval_size > 0:
        raise ValueError(
            "data.eval_scales with data.eval_size > 0 makes every scale a "
            "near-duplicate forward (views are re-resized to eval_size); "
            "set eval_size: 0 for multi-scale TTA"
        )


def _yaml_scalar(v: Any) -> str:
    """One scalar as ``yaml.safe_dump`` would resolve it back: strings
    single-quoted (so none reads as a number, bool or null), floats with a
    '.' in the mantissa and a signed exponent (YAML 1.1's float pattern)."""
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        r = repr(v).lower()
        return r.replace("e", ".0e", 1) if "." not in r and "e" in r else r
    if isinstance(v, str):
        return "'" + v.replace("'", "''") + "'"
    raise TypeError(f"cannot write {type(v).__name__} {v!r} as a YAML scalar")


def dump_yaml(d: Dict[str, Any], indent: int = 0) -> str:
    """Nested dicts of scalars and lists of scalars as block YAML, in the
    layout of ``yaml.safe_dump(d, sort_keys=False)``: two spaces per level,
    list items at their key's indent."""
    pad, out = " " * indent, []
    for k, v in d.items():
        if isinstance(v, dict):
            out.append(f"{pad}{k}:\n" + dump_yaml(v, indent + 2))
        elif isinstance(v, (list, tuple)):
            out.append(f"{pad}{k}:\n" + "".join(f"{pad}- {_yaml_scalar(x)}\n" for x in v)
                       if v else f"{pad}{k}: []\n")
        else:
            out.append(f"{pad}{k}: {_yaml_scalar(v)}\n")
    return "".join(out)


def save_config(cfg: Config, path: str) -> None:
    """Write the resolved config as YAML (the reference writes it to
    ``<work_dir>/config.yaml``); :func:`load_config` and the reference's
    ``yaml.safe_load`` both read it back to the same ``Config``."""
    d = cfg.to_dict()
    d["name"] = cfg.name
    with open(path, "w") as f:
        f.write(dump_yaml(d))
