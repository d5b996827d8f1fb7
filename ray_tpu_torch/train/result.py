"""Result type (the port's copy of ``ray_tpu/train/result.py``; parity:
``python/ray/air/result.py``)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ray_tpu_torch.train.checkpoint import Checkpoint


@dataclass
class Result:
    metrics: Dict[str, Any] = field(default_factory=dict)
    checkpoint: Optional[Checkpoint] = None
    path: Optional[str] = None
    error: Optional[BaseException] = None
    metrics_history: List[Dict[str, Any]] = field(default_factory=list)
    best_checkpoints: List[tuple] = field(default_factory=list)

    @property
    def metrics_dataframe(self):
        import pandas as pd
        return pd.DataFrame(self.metrics_history)

    @property
    def config(self) -> Optional[Dict[str, Any]]:
        return self.metrics.get("config")
