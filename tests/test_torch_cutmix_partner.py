"""Kernel A with row 0's partner from outside the batch, as data
parallelism gives it (the previous rank's last row): the kernel reads the
partner through the batch's pointer plus the distance between the two
allocations, which may be negative.  Needs a CUDA card; skipped without
one (the CPU path is the plain version, which these tests hold it to)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from semi_supervised_semantic_segmentation_tpu_torch.ops import augment
from semi_supervised_semantic_segmentation_tpu_torch.ops import cutmix_normalize as cmn

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("where", ["below", "above", "own_allocation"])
def test_cutmix_kernel_reads_a_partner_row_from_another_allocation(where):
    """Kernel A reads row 0's partner through the batch's pointer plus the
    (signed, 64-bit) distance between the two allocations: a partner row
    placed below the batch (a negative distance), above it, and in a
    cudaMalloc of its own, against the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    b, h, w = 3, 37, 100
    g = torch.Generator(device=dev).manual_seed(2)
    row = h * w * 3
    # one pool per dtype; the partner row at its start ("below") or its end
    pools = [torch.empty((b + 1) * n, dtype=dt, device=dev)
             for n, dt in ((row, torch.float32), (h * w, torch.int32), (h * w, torch.bool))]
    if where == "own_allocation":  # > 1 MB each: a segment of their own
        pools = [torch.empty(2 << 20, dtype=p.dtype, device=dev) for p in pools]
    lo = where == "below"
    shapes = ((h, w, 3), (h, w), (h, w))
    batch, partner = [], []
    for p, shape in zip(pools, shapes):
        n = int(np.prod(shape))
        if where == "own_allocation":
            batch.append(torch.empty((b,) + shape, dtype=p.dtype, device=dev))
            partner.append(p[:n].view(shape))
        else:
            batch.append(p[n:] if lo else p[:b * n])
            partner.append(p[:n] if lo else p[b * n:])
            batch[-1], partner[-1] = batch[-1].view((b,) + shape), partner[-1].view(shape)
    for t in batch + partner:
        if t.dtype == torch.bool:
            t.copy_(torch.rand(t.shape, generator=g, device=dev) > 0.5)
        elif t.dtype == torch.int32:
            t.copy_(torch.randint(0, 21, t.shape, generator=g, device=dev))
        else:
            t.copy_(torch.rand(t.shape, generator=g, device=dev))
    delta = partner[0].data_ptr() - batch[0].data_ptr()
    assert where == "own_allocation" or (delta < 0) == lo
    boxes = augment.cutmix_boxes(torch.rand(b, 4, generator=g, device=dev), h, w, 1.0)
    assert int(boxes[0, 1] - boxes[0, 0]) > 0 and int(boxes[0, 3] - boxes[0, 2]) > 0
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    oi, ol, oc = cmn.cutmix_normalize_triton(*batch, boxes, mean, std, torch.bfloat16,
                                             tuple(partner))
    pi, pl, pc = cmn.cutmix_normalize_plain(*batch, boxes, mean, std, torch.bfloat16,
                                        tuple(partner))
    assert bool(((oi.float() - pi.float()).abs() <= 2.0 ** -7 * pi.float().abs() + 1e-6).all())
    assert torch.equal(ol, pl) and torch.equal(oc, pc)
