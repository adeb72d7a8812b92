"""The port's two eval paths (``engine/evaluator.py``: staged and fused) on
config 5's protocol at a small size, a width-8 HRNet + HRNetV2 head with
``branch_conv: pallas`` (its plain versions here).  Kept in a file of its
own so that ``--dist loadfile`` runs it beside tests/test_torch_evaluator.py
on another worker."""

import pytest

from semi_supervised_semantic_segmentation_tpu_torch import config
from semi_supervised_semantic_segmentation_tpu_torch.models import build_model
from tests.test_torch_evaluator import (
    NCLS,
    _batch,
    _port_weights_as_reference,
    _raw,
    assert_confusion_agrees,
    port_eval,
)
from tests.test_torch_hrnet import JSeg


@pytest.fixture(scope="module")
def hrnet_pair():
    jmodels = {b: JSeg(branch_conv=b, fuse_order="up_first") for b in ("pallas", "xla")}
    model = build_model(config.config_from_dict(_raw()))
    params, stats = _port_weights_as_reference(model, jmodels["xla"], 1)
    return jmodels, params, stats, model


def test_staged_equals_fused_in_the_port(hrnet_pair):
    """Both paths of the port on config 5's protocol at a small size: the
    same arithmetic in a different order of batching."""
    model = hrnet_pair[3]
    data = dict(crop_size=128, eval_mode="sliding", eval_stride=96, eval_flip=True,
                eval_scales=[0.75, 1.0, 1.25], eval_window_batch=5)
    batch = _batch(2, 128, 192, seed=7)
    cm_s, prob_s = port_eval(_raw(**data, eval_impl="staged"), model, batch)
    cm_f, prob_f = port_eval(_raw(**data, eval_impl="fused"), model, batch)
    assert_confusion_agrees(cm_s, cm_f, prob_s, prob_f, batch["label"], NCLS, tol=1e-5)
