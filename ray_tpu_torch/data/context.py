"""DataContext: process-wide execution options for Datasets.

Counterpart of ``ray_tpu/data/context.py`` (parity role: Ray's
``python/ray/data/context.py``): the knobs the streaming executor reads
when it builds its operators.  Reach it through
``DataContext.get_current()``; tests and jobs mutate the singleton.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass
class DataContext:
    # per-operator cap on OUTSTANDING bytes (in-flight task outputs plus
    # completed outputs not yet released downstream); None = task-count
    # budgets only
    op_bytes_budget: Optional[int] = None
    # default per-operator in-flight task cap
    op_task_budget: int = 8

    _current: "Optional[DataContext]" = None

    @classmethod
    def get_current(cls) -> "DataContext":
        if cls._current is None:
            cls._current = cls()
        return cls._current
