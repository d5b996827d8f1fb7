# The port's copy of ray_tpu/tune/trainable.py
"""Class-based Trainable API (parity: ``tune/trainable/trainable.py``).

A class Trainable expresses resumable, stepwise training the function
API can't: ``setup(config)`` once, ``step()`` per iteration,
``save_checkpoint``/``load_checkpoint`` for pause/resume under
schedulers (ASHA stops, PBT/PB2 exploit-clones) and ``Tuner.restore``.

The Tuner adapts a Trainable subclass to the function protocol with
:func:`wrap_trainable`: each ``step()`` result is reported with a
checkpoint carrying the iteration counter, and a trial (re)started from
a checkpoint resumes from the saved iteration via ``load_checkpoint``.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Callable, Dict, Optional


class Trainable:
    """Subclass and implement ``step`` (and optionally the rest)."""

    def __init__(self):
        self.config: Dict[str, Any] = {}
        self.iteration = 0

    # -- lifecycle hooks (reference: trainable.py:293) ------------------
    def setup(self, config: Dict[str, Any]) -> None:
        """One-time initialization with the trial's hyperparams."""

    def step(self) -> Dict[str, Any]:
        """One training iteration; returns the metrics to report."""
        raise NotImplementedError

    def save_checkpoint(self, checkpoint_dir: str) -> Optional[Dict]:
        """Persist state into ``checkpoint_dir`` (optional)."""
        return None

    def load_checkpoint(self, checkpoint_dir: str) -> None:
        """Restore state saved by :meth:`save_checkpoint` (optional)."""

    def cleanup(self) -> None:
        """Teardown after the final step or external stop."""

    # -- conveniences ---------------------------------------------------
    @property
    def training_iteration(self) -> int:
        return self.iteration


_META = "_trainable_meta.json"


def wrap_trainable(cls) -> Callable:
    """Adapt a :class:`Trainable` subclass to the function protocol."""

    def fn(config: Dict[str, Any]):
        from ray_tpu_torch import train
        from ray_tpu_torch.train.checkpoint import Checkpoint

        t = cls()
        t.config = dict(config)
        t.setup(t.config)
        start = train.get_checkpoint()
        if start is not None:
            with start.as_directory() as d:
                meta_path = os.path.join(d, _META)
                if os.path.exists(meta_path):
                    with open(meta_path) as f:
                        t.iteration = json.load(f).get("iteration", 0)
                t.load_checkpoint(d)
        try:
            while True:
                result = t.step() or {}
                t.iteration += 1
                result.setdefault("training_iteration", t.iteration)
                ckpt_dir = tempfile.mkdtemp(prefix="trainable_ckpt_")
                t.save_checkpoint(ckpt_dir)
                with open(os.path.join(ckpt_dir, _META), "w") as f:
                    json.dump({"iteration": t.iteration}, f)
                ckpt = Checkpoint.from_directory(ckpt_dir)
                # report() is queued: the consumer persists a durable
                # copy, then deletes this source dir (one tempdir per
                # iteration must not accumulate for the trial's life)
                ckpt._ephemeral_source = True
                train.report(result, checkpoint=ckpt)
                if result.get("done"):
                    break
        finally:
            t.cleanup()

    fn.__name__ = getattr(cls, "__name__", "trainable")
    resources = getattr(cls, "_tune_resources", None)
    if resources is not None:
        fn._tune_resources = resources
    return fn


def is_trainable_class(obj: Any) -> bool:
    return isinstance(obj, type) and issubclass(obj, Trainable)
