"""Method registry: config name -> method module (init_state / make_train_step)."""

from __future__ import annotations

from types import ModuleType

_ALL = ("supervised", "mean_teacher", "fixmatch_cutmix", "cps")


def get_method(name: str) -> ModuleType:
    if name not in _ALL:
        raise ValueError(f"unknown method {name!r}; valid: {list(_ALL)}")
    from semi_supervised_semantic_segmentation_tpu_torch.methods import (
        cps,
        fixmatch,
        mean_teacher,
        supervised,
    )

    return {"supervised": supervised, "mean_teacher": mean_teacher,
            "fixmatch_cutmix": fixmatch, "cps": cps}[name]
