"""Local span recorder.

Counterpart of the in-process half of ``ray_tpu/util/tracing.py``: with
tracing enabled, :func:`span` records ``{name, start, dur, end, tid,
attributes}`` (epoch start, duration from the monotonic clock) into a
bounded list that tests and :mod:`ray_tpu_torch.telemetry.chrome_trace`
read.  Disabled (the default) a span costs one flag read.

Export to OpenTelemetry, publishing the flag to a cluster and the
worker-side task spans wait for the runtime (ROADMAP Queue 1 item 6c).
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Dict, List

_lock = threading.Lock()
_enabled = False
_records: List[Dict[str, Any]] = []
_MAX_RECORDS = 10_000


def enable_tracing() -> None:
    global _enabled
    with _lock:
        _enabled = True


def disable_tracing() -> None:
    global _enabled
    with _lock:
        _enabled = False


def is_enabled() -> bool:
    return _enabled


def recorded_spans() -> List[Dict[str, Any]]:
    with _lock:
        return list(_records)


def clear_recorded() -> None:
    with _lock:
        _records.clear()


@contextlib.contextmanager
def span(name: str, **attributes):
    """Trace one operation; a no-op when tracing is off.

    The record's ``start`` is on the epoch axis for timeline placement;
    ``dur`` (and the derived ``end``) come from the monotonic clock, which
    never steps backwards."""
    if not _enabled:
        yield None
        return
    rec = {"name": name, "start": time.time(),
           "tid": threading.get_ident(), "attributes": attributes}
    t0 = time.monotonic()
    try:
        yield rec
    finally:
        rec["dur"] = time.monotonic() - t0
        rec["end"] = rec["start"] + rec["dur"]
        with _lock:
            _records.append(rec)
            if len(_records) > _MAX_RECORDS:
                del _records[:len(_records) - _MAX_RECORDS]
