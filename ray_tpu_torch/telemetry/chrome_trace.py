"""Chrome-trace (Perfetto) events from the local span recorder.

Counterpart of ``ray_tpu/telemetry/chrome_trace.py``: one timeline of
the span recorder's host spans, every live step recorder's steps
(:mod:`ray_tpu_torch.telemetry.step`: step, dispatch, sync and compile
events) and the request flight recorder's spans, as
:func:`ray_tpu_torch.telemetry.trace.dump` and the runtime's
``timeline()`` read it; :func:`export` writes the JSON-object form
(``{"traceEvents": [...]}``) that Perfetto loads.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional


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


def trace_events(include_host: bool = True,
                 include_steps: bool = True,
                 include_requests: bool = True) -> List[Dict[str, Any]]:
    """Every exportable event held in this process: the span recorder's,
    the step recorders' and the request flight recorder's, by start
    time."""
    evs: List[Dict[str, Any]] = []
    if include_host:
        from ray_tpu_torch.util import tracing
        evs.extend(_span_events(tracing.recorded_spans()))
    if include_steps:
        from ray_tpu_torch.telemetry.step import recorders
        for rec in recorders():
            evs.extend(rec.chrome_events())
    if include_requests:
        from ray_tpu_torch.telemetry import trace
        evs.extend(trace.chrome_events())
    evs.sort(key=lambda e: e.get("ts", 0))
    return evs


def export(path: Optional[str] = None, *,
           extra_events: Optional[List[Dict[str, Any]]] = None) -> str:
    """Perfetto JSON-object trace of everything recorded so far."""
    evs = trace_events()
    if extra_events:
        evs = sorted(evs + list(extra_events), key=lambda e: e.get("ts", 0))
    out = json.dumps({"traceEvents": evs, "displayTimeUnit": "ms"})
    if path:
        with open(path, "w") as f:
            f.write(out)
    return out
