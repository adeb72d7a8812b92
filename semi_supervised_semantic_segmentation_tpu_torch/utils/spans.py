"""Named ranges of the program, on the clock of whatever profiler runs.

``span(name)`` is a ``torch.profiler.record_function`` range while
:func:`recording` is active and one shared no-op context otherwise, so a
span site costs one flag test when nothing records (a bare
``record_function`` costs ~13 us a range even with no profiler running,
and the branch-conv wrappers are entered ~580 times a HRNet step).  A
profiler that records CPU activity at ``RecordScope.USER_SCOPE`` (or all of
it) sees the ranges with the kernels they launched.  The module keeps no
buffer and writes nothing: the profiler is the exporter.

The spans:

- ``fixmatch.step`` (``methods/fixmatch.py``), the whole step, and nested
  in it ``fixmatch.draw``, ``fixmatch.views``, ``fixmatch.teacher`` (forward,
  pseudo-labels, the ignore fill), ``fixmatch.cutmix`` (partner rows,
  CutMix and normalize, the labeled batch's normalize), ``fixmatch.student``,
  ``fixmatch.loss`` (OHEM included), ``fixmatch.backward`` (``zero_grad``,
  ``backward``, a remat plan's re-run), ``fixmatch.optimizer`` and
  ``fixmatch.ema``;
- ``branch_conv.d``, ``branch_conv.d_post`` and ``branch_conv.e``
  (``ops/branch_conv.py``): kernels D, D's post mode and E with their
  checks, weight pack, plan and reduction (the backward's run on the
  autograd engine's thread);
- ``data.wait`` (``engine/trainer.py::_Prefetcher.get``): the wait on the
  prefetch queue.
"""

from __future__ import annotations

import contextlib

import torch

_recording = False
_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager: the named range while recording, else a no-op."""
    return torch.profiler.record_function(name) if _recording else _OFF


@contextlib.contextmanager
def recording():
    """Turn the spans on for the ``with`` block (and back as they were)."""
    global _recording
    was, _recording = _recording, True
    try:
        yield
    finally:
        _recording = was
