# The port's copy of ray_tpu/util/tracing.py
"""Tracing hooks (parity: ``python/ray/util/tracing/tracing_helper.py``).

The reference patches every remote call with OpenTelemetry spans when
``ray.init(_tracing_startup_hook=...)`` is set.  Here tracing is a
light seam over the same points: if ``opentelemetry`` is importable the
spans are real OTel spans (exported by whatever provider the user
configured); otherwise an in-process recorder keeps (name, start, end,
attributes) tuples so tests and the timeline can still observe the
graph.  Zero overhead when never enabled.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Dict, List, Optional

_lock = threading.Lock()
_enabled = False
_tracer = None          # otel tracer when available
_records: List[Dict[str, Any]] = []   # fallback recorder
_MAX_RECORDS = 10_000


def enable_tracing() -> bool:
    """Turn on span emission; True if real OpenTelemetry is active.

    The flag is process-local, so it is ALSO published to the control
    plane: worker processes check it at startup (``worker_proc``) and
    emit execute-side spans.  Workers already running before the enable
    keep tracing off until restarted (same init-time contract as the
    reference's ``_tracing_startup_hook``)."""
    _publish("1")
    global _enabled, _tracer
    with _lock:
        _enabled = True
        if _tracer is None:
            try:
                from opentelemetry import trace as otel_trace

                # only route spans to OTel when the user actually
                # configured a provider — the library default
                # (ProxyTracerProvider with no SDK behind it) swallows
                # spans silently, which would also starve the
                # in-process recorder that tests and the timeline read
                provider = otel_trace.get_tracer_provider()
                if type(provider).__name__ not in (
                        "ProxyTracerProvider", "NoOpTracerProvider"):
                    _tracer = otel_trace.get_tracer("ray_tpu_torch")
            except Exception:  # noqa: BLE001 — recorder fallback
                _tracer = None
        return _tracer is not None


def disable_tracing() -> None:
    global _enabled
    _publish("0")
    with _lock:
        _enabled = False


_KV_KEY = b"__ray_tpu_torch_tracing__"


def _publish(val: str) -> None:
    """Best-effort cluster-wide flag (no-op outside a session)."""
    try:
        from ray_tpu_torch._private.worker import global_worker
        global_worker().cp.kv_put(_KV_KEY, val.encode(), True, "_sys")
    except Exception:  # noqa: BLE001 — local-only tracing still works
        pass


_cluster_cp = None
_cluster_checked = 0.0
_CLUSTER_TTL_S = 5.0


def maybe_enable_from_cluster(cp) -> None:
    """Worker-startup hook: adopt (and keep polling, via the TTL check
    in :func:`_refresh`) the cluster-wide tracing flag."""
    global _cluster_cp
    _cluster_cp = cp
    _refresh(force=True)


def _refresh(force: bool = False) -> None:
    """Re-read the cluster flag at most every ``_CLUSTER_TTL_S`` so an
    ``enable_tracing()`` on the driver reaches already-running workers
    within seconds (one KV read per worker per TTL — off the hot path
    unless tracing state actually changes anything)."""
    global _enabled, _cluster_checked
    if _cluster_cp is None:
        return
    now = time.monotonic()
    if not force and now - _cluster_checked < _CLUSTER_TTL_S:
        return
    _cluster_checked = now
    try:
        val = _cluster_cp.kv_get(_KV_KEY, namespace="_sys")
    except Exception:  # noqa: BLE001
        return
    if val == b"1" and not _enabled:
        with _lock:
            _enabled = True
    elif val == b"0" and _enabled:
        with _lock:
            _enabled = False


def is_enabled() -> bool:
    return _enabled


def recorded_spans() -> List[Dict[str, Any]]:
    """Fallback-recorder contents (OTel-less environments/tests)."""
    with _lock:
        return list(_records)


def clear_recorded() -> None:
    with _lock:
        _records.clear()


@contextlib.contextmanager
def span(name: str, **attributes):
    """Trace one operation.  No-op (two attr reads) when disabled.

    The fallback record keeps an *epoch* ``start`` for timeline
    placement but computes ``dur`` (and the derived ``end``) from the
    monotonic clock: ``time.time()`` can step backwards under NTP
    slew, which used to yield negative/garbage durations for spans
    straddling a clock adjustment."""
    if not _enabled:
        yield None
        return
    if _tracer is not None:
        with _tracer.start_as_current_span(name) as s:
            for k, v in attributes.items():
                try:
                    s.set_attribute(k, v)
                except Exception:  # noqa: BLE001
                    pass
            yield s
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


def task_span(spec) -> "contextlib.AbstractContextManager":
    """Span for one task/actor-method execution (worker side)."""
    _refresh()
    if not _enabled:
        return contextlib.nullcontext()
    return span(
        f"task::{getattr(spec, 'name', '?')}",
        task_id=getattr(spec, 'task_id', b'').hex()[:16],
        actor_method=getattr(spec, 'actor_method', None) or "",
    )


def submit_span(name: str) -> "contextlib.AbstractContextManager":
    """Span for a submission on the caller side."""
    if not _enabled:
        return contextlib.nullcontext()
    return span(f"submit::{name}")
