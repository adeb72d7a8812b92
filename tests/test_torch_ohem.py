"""The port's OHEM cross-entropy and its exact k-th order statistic
(``ops/losses.py``) against the JAX package's, from the same numpy logits
and labels, within 1e-5 relative: the kept set is the same, so only the
f32 summation order differs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semi_supervised_semantic_segmentation_tpu.ops import losses as jlosses
from semi_supervised_semantic_segmentation_tpu_torch.ops import losses

N, C, H, W = 2, 5, 16, 12


def _both(logits_nhwc, labels, thresh, min_kept):
    want = float(jlosses.ohem_cross_entropy(jnp.asarray(logits_nhwc), jnp.asarray(labels), 255,
                                            thresh, min_kept))
    lt = torch.from_numpy(np.ascontiguousarray(logits_nhwc.transpose(0, 3, 1, 2)))
    got = float(losses.ohem_cross_entropy(lt, torch.from_numpy(labels), 255, thresh, min_kept))
    return got, want


def _case(seed, ignore_frac):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(N, H, W, C) * 2).astype(np.float32)
    labels = rng.randint(0, C, (N, H, W)).astype(np.int32)
    labels[rng.rand(N, H, W) < ignore_frac] = 255
    return logits, labels


@pytest.mark.parametrize("thresh,min_kept", [(0.7, 50), (0.7, 100000), (0.2, 10), (0.99, 0)])
def test_ohem_matches_jax(thresh, min_kept):
    """min_kept 100000 > n_valid: p_k is the largest valid probability."""
    logits, labels = _case(0, 0.2)
    got, want = _both(logits, labels, thresh, min_kept)
    assert got == pytest.approx(want, rel=1e-5)


def test_ohem_ties_and_edge_cases_match_jax():
    # ties: every pixel of a sample has the same logits, so whole blocks of
    # pixels share one true-class probability at the threshold
    logits = np.zeros((N, H, W, C), np.float32)
    logits[..., 0] = 1.0
    labels = np.zeros((N, H, W), np.int32)
    labels[:, ::2] = 1
    for thresh, min_kept in [(0.1, 40), (0.9, 40), (0.5, 200)]:
        got, want = _both(logits, labels, thresh, min_kept)
        assert got == pytest.approx(want, rel=1e-5)
    # every pixel ignored: 0, not NaN
    got, want = _both(logits, np.full((N, H, W), 255, np.int32), 0.7, 100)
    assert got == want == 0.0
    # one valid pixel
    one = np.full((N, H, W), 255, np.int32)
    one[1, 3, 4] = 2
    got, want = _both(_case(1, 0.0)[0], one, 0.7, 100)
    assert got == pytest.approx(want, rel=1e-5) and got > 0


def test_ohem_gradient_flows_through_kept_pixels_only():
    logits, labels = _case(2, 0.1)
    lt = torch.from_numpy(np.ascontiguousarray(logits.transpose(0, 3, 1, 2))).requires_grad_()
    losses.ohem_cross_entropy(lt, torch.from_numpy(labels), 255, 0.7, 30).backward()
    g = lt.grad.abs().sum(dim=1)
    assert bool((g[torch.from_numpy(labels) == 255] == 0).all())
    assert int((g > 0).sum()) >= 30


def test_kth_smallest_bit_search_equals_sort():
    rng = np.random.RandomState(3)
    x = np.abs(rng.randn(1000)).astype(np.float32)
    x[::7] = x[3]  # ties
    x[::11] = np.inf
    x[5] = 0.0
    xs = np.sort(x)
    for k in (0, 1, 5, 500, 998, 999):
        got = losses.kth_smallest_nonneg_f32(torch.from_numpy(x), torch.tensor(k))
        assert float(got) == xs[k]
        assert float(jlosses._kth_smallest_nonneg_f32(jnp.asarray(x), jnp.int32(k))) == xs[k]
