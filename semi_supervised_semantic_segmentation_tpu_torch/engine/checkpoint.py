"""Checkpoint manager of the port (counterpart of the reference's
``engine/checkpoint.py``, without Orbax: the card's machine has no JAX).

A slot is ``<directory>/<step>/`` and holds

- ``checkpoint.pth``: :func:`compat.reference_checkpoint`'s dict (``model``,
  ``ema_model`` or CPS's ``model2``, ``optimizer``, ``epoch``,
  ``best_miou``, ``step``), which
  the JAX package's ``compat.import_reference_checkpoint`` also reads;
- ``meta.json``: the caller's meta (``epoch``, ``best_miou``, ``miou``,
  ``config``);
- ``rng.pth``: the global torch (and CUDA) generator states.  The methods
  draw their randomness from per-step generators (``common.step_generator``),
  so a resume needs none of it; it is restored all the same, so that a
  draw from the global generators resumes where it stopped too.

A slot is written under a hidden temporary name and renamed at the end, so
a slot half written at a crash is never :meth:`CheckpointManager.latest_step`.
The newest ``max_to_keep`` slots are kept.  With ``async_save`` the state
is copied to the CPU at once and the files are written on a thread;
:meth:`CheckpointManager.wait` joins it and raises its error, if any.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import torch

from semi_supervised_semantic_segmentation_tpu_torch.engine import compat

CKPT_FILE = "checkpoint.pth"
META_FILE = "meta.json"
RNG_FILE = "rng.pth"


def _rng_state() -> Dict[str, Any]:
    cuda = torch.cuda.get_rng_state_all() if torch.cuda.is_initialized() else []
    return {"torch": torch.get_rng_state(), "cuda": cuda}


def _set_rng_state(rng: Dict[str, Any]) -> None:
    torch.set_rng_state(rng["torch"])
    if rng["cuda"] and torch.cuda.is_available() and len(rng["cuda"]) == torch.cuda.device_count():
        torch.cuda.set_rng_state_all(rng["cuda"])


def parse_checkpoint_arg(arg: str) -> Tuple[str, Optional[int]]:
    """A checkpoint directory, or ``dir:step`` -> (directory, step or None)."""
    head, sep, tail = arg.rpartition(":")
    return (head, int(tail)) if sep and tail.isdigit() else (arg, None)


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3, async_save: bool = True):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def steps(self) -> List[int]:
        """Steps of the complete slots, ascending."""
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit() and os.path.isfile(os.path.join(self.directory, n, META_FILE)))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state, meta: dict, force: bool = False) -> None:
        """Write slot ``step`` of ``state`` (a ``TrainState``) with ``meta``.
        ``force`` is the reference's signature: the port has no save
        interval, so every call writes."""
        self.wait()
        payload = compat.reference_checkpoint(state, meta, state.optimizer.cfg)
        args = (step, payload, _rng_state(), json.loads(json.dumps(meta)))
        if self.async_save:
            self._thread = threading.Thread(target=self._write_caught, args=args)
            self._thread.start()
        else:
            self._write(*args)

    def _write_caught(self, *args) -> None:
        try:
            self._write(*args)
        except BaseException as e:  # raised at wait()
            self._error = e

    def _write(self, step: int, payload: dict, rng: dict, meta: dict) -> None:
        final = os.path.join(self.directory, str(step))
        tmp = os.path.join(self.directory, f".{step}.tmp")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(payload, os.path.join(tmp, CKPT_FILE))
        torch.save(rng, os.path.join(tmp, RNG_FILE))
        with open(os.path.join(tmp, META_FILE), "w") as f:
            json.dump(meta, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        if self.max_to_keep > 0:
            for old in self.steps()[:-self.max_to_keep]:
                shutil.rmtree(os.path.join(self.directory, str(old)))

    def wait(self) -> None:
        """Join the save in flight; raise its error, if it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(f"saving a checkpoint to {self.directory} failed: "
                               f"{type(err).__name__}: {err}") from err

    def close(self) -> None:
        self.wait()

    def restore(self, state, step: Optional[int] = None) -> dict:
        """Load slot ``step`` (default: the latest) into ``state`` in place:
        weights (teacher or second net included), momentum, step and the
        generator states.  Returns
        the slot's meta."""
        self.wait()
        step = self.latest_step() if step is None else step
        slot = os.path.join(self.directory, str(step))
        if step is None or not os.path.isfile(os.path.join(slot, META_FILE)):
            raise FileNotFoundError(f"no checkpoint{'' if step is None else f' at step {step}'} "
                                    f"in {self.directory}")
        obj = torch.load(os.path.join(slot, CKPT_FILE), map_location="cpu", weights_only=True)
        problems = self._mismatch(obj, state)
        if not problems:
            try:
                compat.load_reference_checkpoint(obj, state)
            except (KeyError, ValueError) as e:
                problems = [str(e)]
        if problems:
            raise RuntimeError(
                f"failed to restore checkpoint step {step} from {self.directory}: the stored "
                f"state does not match the current train state (model/method/config "
                f"mismatch?): {'; '.join(problems)}")
        _set_rng_state(torch.load(os.path.join(slot, RNG_FILE), weights_only=True))
        with open(os.path.join(slot, META_FILE)) as f:
            return json.load(f)

    @staticmethod
    def _mismatch(obj: Dict[str, Any], state) -> List[str]:
        """The missing and unexpected keys of each net of the slot against
        ``state``'s."""
        out = []
        for part, net in (("model", state.model), ("ema_model", state.ema_model),
                          ("model2", state.model2)):
            if net is None or part not in obj:
                if (net is None) != (part not in obj):
                    out.append(f"'{part}' is in the {'slot' if net is None else 'state'} only")
                continue
            want, have = set(net.state_dict()), set(obj[part])
            missing, unexpected = sorted(want - have), sorted(have - want)
            if missing or unexpected:
                out.append(f"{part}: missing keys {_few(missing)}, "
                           f"unexpected keys {_few(unexpected)}")
        return out


def _few(keys: List[str], n: int = 8) -> str:
    return f"{keys[:n]}" + (f" (+{len(keys) - n} more)" if len(keys) > n else "")
