"""The port's metrics (``ops/metrics.py``) against the JAX package's, on
inputs made from a seed: the confusion matrix as exact integers against
both of the reference's forms (its default bf16 one-hot product, exact
below 2^24 per cell, and its bincount), with an ignore label and blank
rows; IoU, mIoU and pixel accuracy (exact float64 arithmetic on both
sides, compared at 1e-12), absent classes included; the class names and
the IoU table."""

import numpy as np
import pytest
import torch

from semi_supervised_semantic_segmentation_tpu.ops import metrics as jmetrics
from semi_supervised_semantic_segmentation_tpu_torch.ops import metrics


@pytest.mark.parametrize("ncls,shape,seed", [(4, (2, 16, 24), 0), (21, (3, 40, 40), 1),
                                             (19, (2, 64, 128), 2)])
def test_confusion_matrix_equals_both_reference_impls(ncls, shape, seed):
    rng = np.random.RandomState(seed)
    pred = rng.randint(0, ncls, shape).astype(np.int32)
    label = rng.randint(0, ncls, shape).astype(np.int32)
    label[rng.rand(*shape) < 0.2] = 255  # ignored pixels
    label[-1] = 255  # a blank eval pad row
    got = metrics.confusion_matrix(torch.from_numpy(pred), torch.from_numpy(label), ncls, 255)
    assert got.dtype == torch.int64 and tuple(got.shape) == (ncls, ncls)
    for impl in ("matmul", "bincount"):
        want = np.asarray(jmetrics.confusion_matrix(pred, label, ncls, 255, impl=impl))
        np.testing.assert_array_equal(got.numpy(), want)
    assert int(got.sum()) == int((label != 255).sum())


def test_iou_and_accuracy_equal_the_reference_with_absent_classes():
    rng = np.random.RandomState(3)
    for cm in (rng.randint(0, 50, (5, 5)),
               np.diag([7, 0, 3, 0, 0]),  # classes 1, 3 and 4 absent (union 0)
               np.zeros((4, 4), np.int64)):  # everything absent: mIoU 0.0
        iou, miou = metrics.iou_from_confusion(cm)
        jiou, jmiou = jmetrics.iou_from_confusion(cm)
        np.testing.assert_allclose(iou, jiou, rtol=1e-12, atol=0)
        np.testing.assert_array_equal(np.isnan(iou), np.isnan(jiou))
        assert miou == pytest.approx(jmiou, rel=1e-12, abs=0)
        assert metrics.pixel_accuracy(cm) == pytest.approx(jmetrics.pixel_accuracy(cm),
                                                           rel=1e-12, abs=0)
    assert metrics.iou_from_confusion(np.zeros((3, 3)))[1] == 0.0


def test_class_names_and_iou_table_equal_the_reference():
    assert metrics.VOC_CLASSES == jmetrics.VOC_CLASSES
    assert metrics.CITYSCAPES_CLASSES == jmetrics.CITYSCAPES_CLASSES
    for ds, n in (("voc", 21), ("cityscapes", 19), ("synthetic", 4), ("voc", 5)):
        names = metrics.class_names(ds, n)
        assert names == jmetrics.class_names(ds, n)
        iou = np.linspace(0.0, 1.0, n)
        iou[1] = np.nan
        assert metrics.format_iou_table(iou, names) == jmetrics.format_iou_table(iou, names)
