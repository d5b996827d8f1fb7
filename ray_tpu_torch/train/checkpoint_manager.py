"""Keep-top-k checkpoint bookkeeping.

The port's copy of ``ray_tpu/train/checkpoint_manager.py`` (parity:
the reference's ``python/ray/train/_internal/checkpoint_manager.py``,
driven by ``CheckpointConfig``: keep the ``num_to_keep`` best by a score
attribute).
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.config import CheckpointConfig
from ray_tpu_torch.train.storage import delete_uri, is_remote_uri, list_uri


class CheckpointManager:
    def __init__(self, storage_dir: str, config: CheckpointConfig,
                 resume: bool = False):
        self.storage_dir = storage_dir
        self.config = config
        self._index = 0
        # list of (score, index, checkpoint, metrics)
        self.best: List[Tuple[float, int, Checkpoint, Dict]] = []
        self.latest: Optional[Checkpoint] = None
        if resume:
            # only a restored trainer adopts prior checkpoints: a fresh
            # run reusing an experiment name must not warm-start from a
            # previous run's weights
            self._rehydrate()

    def _score(self, metrics: Dict[str, Any], fallback: float) -> float:
        attr = self.config.checkpoint_score_attribute
        score = (float(metrics[attr]) if attr is not None and attr in metrics
                 else fallback)
        return score if self.config.checkpoint_score_order == "max" \
            else -score

    def _rehydrate(self) -> None:
        """Adopt checkpoints a previous run left in the directory, so a
        restored trainer resumes from its latest."""
        import glob
        import re
        found = []
        if is_remote_uri(self.storage_dir):
            base = self.storage_dir.rstrip("/")
            entries = [(name, f"{base}/{name}")
                       for name in list_uri(self.storage_dir)]
        else:
            entries = [(os.path.basename(p), p) for p in glob.glob(
                os.path.join(self.storage_dir, "checkpoint_*"))
                if os.path.isdir(p)]
        for name, path in entries:
            m = re.search(r"checkpoint_(\d+)", name)
            if m:
                found.append((int(m.group(1)), path))
        for idx, path in sorted(found):
            ckpt = Checkpoint(path)
            self.latest = ckpt
            self._index = max(self._index, idx + 1)
            try:
                metrics = ckpt.get_metadata().get("metrics", {})
            except Exception:  # noqa: BLE001 — torn metadata write
                metrics = {}
            self.best.append((self._score(metrics, float(idx + 1)),
                              idx + 1, ckpt, metrics))
        self.best.sort(key=lambda t: (t[0], t[1]), reverse=True)

    def register(self, checkpoint: Checkpoint,
                 metrics: Dict[str, Any]) -> Checkpoint:
        clean = {k: v for k, v in metrics.items()
                 if isinstance(v, (int, float, str, bool))}

        def stamp(ckpt: Checkpoint) -> None:
            try:
                meta = ckpt.get_metadata()
                meta["metrics"] = clean
                ckpt.set_metadata(meta)
            except Exception:  # noqa: BLE001 — metadata is best-effort
                import logging
                logging.getLogger(__name__).warning(
                    "checkpoint metadata stamp failed for %s",
                    ckpt.path, exc_info=True)

        # a local destination: stamp the persisted copy (the caller's
        # directory stays as it was); a remote one: stamp the local
        # source just before the upload carries it
        dest_remote = is_remote_uri(self.storage_dir)
        if dest_remote and not is_remote_uri(checkpoint.path):
            stamp(checkpoint)
        persisted = checkpoint.persist(
            self.storage_dir, f"checkpoint_{self._index:06d}")
        if not dest_remote:
            stamp(persisted)
        self._index += 1
        self.latest = persisted
        self.best.append((self._score(metrics, float(self._index)),
                          self._index, persisted, dict(metrics)))
        self.best.sort(key=lambda t: (t[0], t[1]), reverse=True)
        keep = self.config.num_to_keep
        if keep is not None and len(self.best) > keep:
            for _, _, ckpt, _ in self.best[keep:]:
                if ckpt.path == self.latest.path:
                    continue
                if is_remote_uri(ckpt.path):
                    delete_uri(ckpt.path)
                else:
                    shutil.rmtree(ckpt.path, ignore_errors=True)
            self.best = self.best[:keep] + [
                b for b in self.best[keep:]
                if b[2].path == self.latest.path]
        return persisted

    @staticmethod
    def _exists(ckpt: Checkpoint) -> bool:
        if is_remote_uri(ckpt.path):
            return bool(list_uri(ckpt.path))
        return os.path.exists(ckpt.path)

    def best_checkpoint(self) -> Optional[Checkpoint]:
        for _, _, ckpt, _ in self.best:
            if self._exists(ckpt):
                return ckpt
        return self.latest

    def best_checkpoints(self) -> List[Tuple[Checkpoint, Dict]]:
        return [(c, m) for _, _, c, m in self.best if self._exists(c)]
