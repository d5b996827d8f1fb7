"""Chrome-trace (Perfetto) events from the local span recorder.

The part of ``ray_tpu/telemetry/chrome_trace.py`` that
:func:`ray_tpu_torch.telemetry.trace.dump` needs; merging the training
step recorder's events waits for it (ROADMAP Queue 1 item 7).
"""

from __future__ import annotations

from typing import Any, Dict, List


def _span_events(spans) -> List[Dict[str, Any]]:
    """``util.tracing`` recorder spans -> Chrome complete events."""
    evs = []
    for s in spans:
        start = s.get("start")
        if start is None:
            continue
        dur = s.get("dur")
        if dur is None:
            end = s.get("end")
            if end is None:
                continue
            dur = max(end - start, 0.0)
        evs.append({
            "name": s.get("name", "?"), "cat": "host", "ph": "X",
            "ts": start * 1e6, "dur": dur * 1e6,
            "pid": "host", "tid": str(s.get("tid", "main")),
            "args": dict(s.get("attributes") or {}),
        })
    return evs
