"""Per-request tracing and the anomaly flight recorder.

Counterpart of ``ray_tpu/telemetry/trace.py``:

- :class:`TraceContext` — ``(trace_id, parent_id, sampled)``, minted at
  submission (head-based sampling, ``RAY_TPU_TRACE_SAMPLE``) and carried
  by the request through the engine's queue, prefix walk, tier fetch,
  prefill and verify, and across engines on the ``KVHandoff`` payload
  (``to_wire``/``from_wire``), so the importer's spans join the
  exporter's tree.
- :class:`FlightRecorder` — a bounded per-process ring
  (``RAY_TPU_TRACE_RING`` spans) that every span lands in.  An unsampled
  request records nothing.
- :func:`anomaly` — deadline expiries, watchdog wedges and every
  injected chaos fault call it; with ``RAY_TPU_TRACE_DIR`` set the ring
  is dumped as a Perfetto chrome-trace JSON.

Spans are flat records ``{name, trace_id, span_id, parent_id, start
(epoch seconds), dur, attributes}``; a request's tree is rebuilt from
the parent links.  Times are host times: the engine records them after
the step's one synchronisation (the sampled tokens reaching the host),
so no span adds a device sync.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import json
import os
import sys
import threading
import time
import uuid
from typing import Any, Dict, List, Optional


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    """Tracing knobs, resolved once from the environment.

    - ``RAY_TPU_TRACE_SAMPLE`` (default ``1``): head-based sampling
      probability in [0, 1], decided at mint time for the whole request
      (every ``1/rate``-th mint samples, so a fixed workload traces the
      same requests every run).  ``0`` records no spans; anomalies still
      record.
    - ``RAY_TPU_TRACE_RING`` (default ``4096``): the ring's capacity in
      spans; old spans fall off and ``dropped`` counts them.
    - ``RAY_TPU_TRACE_DIR`` (default unset): where anomalies dump the
      ring (``flight-<kind>-<n>.json``); unset, they only record.
    """
    sample: float = 1.0
    ring: int = 4096
    dir: Optional[str] = None


_CONFIG: Optional[TraceConfig] = None


def trace_config(refresh: bool = False) -> TraceConfig:
    """The process-wide :class:`TraceConfig` (env read once)."""
    global _CONFIG
    if _CONFIG is None or refresh:
        raw = os.environ.get("RAY_TPU_TRACE_SAMPLE", "1")
        try:
            sample = float(raw)
        except ValueError:
            print(f"RAY_TPU_TRACE_SAMPLE={raw!r} is not a number; "
                  "using 1", file=sys.stderr)
            sample = 1.0
        if not 0.0 <= sample <= 1.0:
            print(f"RAY_TPU_TRACE_SAMPLE={sample} outside [0, 1]; "
                  "clamping", file=sys.stderr)
            sample = min(max(sample, 0.0), 1.0)
        raw = os.environ.get("RAY_TPU_TRACE_RING", "4096")
        try:
            ring = int(raw)
        except ValueError:
            print(f"RAY_TPU_TRACE_RING={raw!r} is not an int; "
                  "using 4096", file=sys.stderr)
            ring = 4096
        if ring < 1:
            print(f"RAY_TPU_TRACE_RING={ring} < 1; using 4096",
                  file=sys.stderr)
            ring = 4096
        _CONFIG = TraceConfig(
            sample=sample, ring=ring,
            dir=os.environ.get("RAY_TPU_TRACE_DIR") or None)
    return _CONFIG


class TraceContext:
    """One request's identity on the wire: the trace its spans join
    (``trace_id``), the span new children hang off (``parent_id``), and
    whether it records at all (``sampled``, decided once at mint)."""

    __slots__ = ("trace_id", "parent_id", "sampled")

    def __init__(self, trace_id: str, parent_id: Optional[str] = None,
                 sampled: bool = True):
        self.trace_id = trace_id
        self.parent_id = parent_id
        self.sampled = sampled

    def child(self, parent_id: Optional[str]) -> "TraceContext":
        """The same trace, with new spans parented at ``parent_id``."""
        return TraceContext(self.trace_id, parent_id, self.sampled)

    def to_wire(self) -> Dict[str, Any]:
        """The serialisable form the ``KVHandoff`` payload carries."""
        return {"trace_id": self.trace_id, "parent_id": self.parent_id,
                "sampled": self.sampled}

    @classmethod
    def from_wire(cls, wire: Optional[Dict[str, Any]]
                  ) -> Optional["TraceContext"]:
        if not wire:
            return None
        return cls(wire["trace_id"], wire.get("parent_id"),
                   bool(wire.get("sampled", True)))

    def __repr__(self) -> str:
        return (f"TraceContext({self.trace_id!r}, "
                f"parent={self.parent_id!r}, sampled={self.sampled})")


_span_seq = itertools.count(1)
_mint_lock = threading.Lock()
_minted = 0
_sampled_count = 0


def new_span_id() -> str:
    return f"s{next(_span_seq):x}"


def mint(sampled: Optional[bool] = None) -> TraceContext:
    """A fresh root context.  With sampling rate ``r`` every ``1/r``-th
    mint samples; ``sampled`` forces the verdict."""
    global _minted, _sampled_count
    if sampled is None:
        rate = trace_config().sample
        with _mint_lock:
            _minted += 1
            want = int(_minted * rate)
            sampled = want > _sampled_count
            if sampled:
                _sampled_count = want
    return TraceContext(uuid.uuid4().hex[:16], None, bool(sampled))


class FlightRecorder:
    """Bounded per-process span ring: old spans fall off the back, and an
    anomaly dump captures whatever it holds."""

    def __init__(self, capacity: int):
        self._ring: "collections.deque[Dict[str, Any]]" = \
            collections.deque(maxlen=capacity)
        self._lock = threading.Lock()
        self.capacity = capacity
        self.recorded = 0

    def record(self, rec: Dict[str, Any]) -> None:
        with self._lock:
            self._ring.append(rec)
            self.recorded += 1

    @property
    def dropped(self) -> int:
        with self._lock:
            return self.recorded - len(self._ring)

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def spans(self) -> List[Dict[str, Any]]:
        """The ring, oldest first."""
        with self._lock:
            return list(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    def chrome_events(self) -> List[Dict[str, Any]]:
        """Ring spans as chrome "X" events: ``pid`` by the span's
        replica, ``tid`` by trace (one request reads as one lane); point
        events get a 1 µs floor so Perfetto draws them."""
        out = []
        for rec in self.spans():
            attrs = rec.get("attributes") or {}
            tid = rec["trace_id"][:8] if rec.get("trace_id") else "global"
            out.append({
                "name": rec["name"], "cat": "trace", "ph": "X",
                "ts": rec["start"] * 1e6,
                "dur": max(rec.get("dur", 0.0) * 1e6, 1.0),
                "pid": str(attrs.get("replica", "fleet")),
                "tid": tid,
                "args": {"trace_id": rec.get("trace_id"),
                         "span_id": rec.get("span_id"),
                         "parent_id": rec.get("parent_id"), **attrs},
            })
        return out


_RECORDER: Optional[FlightRecorder] = None


def recorder() -> FlightRecorder:
    """The process-wide ring (capacity from ``RAY_TPU_TRACE_RING``)."""
    global _RECORDER
    if _RECORDER is None:
        _RECORDER = FlightRecorder(trace_config().ring)
    return _RECORDER


def reset() -> None:
    """A fresh recorder and sampling counters under the current env."""
    global _RECORDER, _minted, _sampled_count
    _RECORDER = FlightRecorder(trace_config().ring)
    with _mint_lock:
        _minted = 0
        _sampled_count = 0


def epoch_of(mono_ts: float) -> float:
    """A ``time.monotonic()`` stamp on the epoch axis every span uses."""
    return time.time() - (time.monotonic() - mono_ts)


class SpanHandle:
    """Yielded by :func:`span`: the live span's id (to parent children
    at) and its attributes (mutable inside the block)."""

    __slots__ = ("id", "attrs")

    def __init__(self, span_id: str, attrs: Dict[str, Any]):
        self.id = span_id
        self.attrs = attrs


@contextlib.contextmanager
def span(trace: Optional[TraceContext], name: str,
         parent_id: Optional[str] = None, **attrs):
    """Record a timed span under ``trace`` (a no-op for None or
    unsampled contexts), parented at ``parent_id`` when given, else at
    the context's parent."""
    if trace is None or not trace.sampled:
        yield None
        return
    handle = SpanHandle(new_span_id(), attrs)
    start = time.time()
    m0 = time.monotonic()
    try:
        yield handle
    finally:
        recorder().record({
            "name": name, "trace_id": trace.trace_id,
            "span_id": handle.id,
            "parent_id": (parent_id if parent_id is not None
                          else trace.parent_id),
            "start": start, "dur": time.monotonic() - m0,
            "attributes": handle.attrs})


def record_span(name: str, trace: Optional[TraceContext], *,
                start: float, dur: float,
                span_id: Optional[str] = None,
                parent_id: Optional[str] = None,
                **attrs) -> Optional[str]:
    """Record a span with explicit times (``start`` on the epoch axis:
    :func:`epoch_of` maps monotonic stamps).  ``trace=None`` records a
    global span (no trace id, e.g. the decode tick that serves every
    active request at once).  Returns the span id, or None when the
    context is unsampled."""
    if trace is not None and not trace.sampled:
        return None
    sid = span_id or new_span_id()
    recorder().record({
        "name": name,
        "trace_id": trace.trace_id if trace is not None else None,
        "span_id": sid,
        "parent_id": (parent_id if parent_id is not None
                      else (trace.parent_id if trace is not None
                            else None)),
        "start": start, "dur": dur, "attributes": attrs})
    return sid


def event(name: str, trace: Optional[TraceContext] = None,
          **attrs) -> Optional[str]:
    """An instant (zero-duration span) at now."""
    return record_span(name, trace, start=time.time(), dur=0.0, **attrs)


_anomaly_seq = itertools.count(1)


def anomaly(kind: str, trace: Optional[TraceContext] = None,
            **attrs) -> Optional[str]:
    """Record an anomaly event (also for unsampled contexts) and, with
    ``RAY_TPU_TRACE_DIR`` set, dump the ring as a Perfetto JSON; returns
    the dump's path or None.  Kinds: ``deadline``, ``wedge``,
    ``injected_fault``."""
    recorder().record({
        "name": f"anomaly/{kind}",
        "trace_id": trace.trace_id if trace is not None else None,
        "span_id": new_span_id(),
        "parent_id": trace.parent_id if trace is not None else None,
        "start": time.time(), "dur": 0.0, "attributes": dict(attrs)})
    cfg = trace_config()
    if not cfg.dir:
        return None
    path = os.path.join(cfg.dir,
                        f"flight-{kind}-{next(_anomaly_seq):04d}.json")
    try:
        return dump(path, trigger=kind)
    except OSError as exc:  # a full or read-only disk must not stop serving
        print(f"flight-recorder dump to {path} failed: {exc}",
              file=sys.stderr)
        return None


def on_injected_fault(site: str, hit: int) -> Optional[str]:
    """The chaos seam: every :class:`~ray_tpu_torch.util.chaos.
    InjectedFault` raise calls through here."""
    return anomaly("injected_fault", site=site, hit=hit)


def dump(path: str, trigger: Optional[str] = None) -> str:
    """Write the ring, merged with the ``util.tracing`` host spans, as a
    self-contained Perfetto chrome-trace JSON; returns ``path``."""
    from ray_tpu_torch.telemetry.chrome_trace import _span_events
    from ray_tpu_torch.util import tracing
    events = recorder().chrome_events()
    events.extend(_span_events(tracing.recorded_spans()))
    events.sort(key=lambda e: e.get("ts", 0))
    rec = recorder()
    doc = {"traceEvents": events, "displayTimeUnit": "ms",
           "metadata": {"trigger": trigger, "recorded": rec.recorded,
                        "dropped": rec.dropped,
                        "ring_capacity": rec.capacity}}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


def chrome_events() -> List[Dict[str, Any]]:
    """The ring as chrome events (no ring is made just to read it)."""
    if _RECORDER is None:
        return []
    return _RECORDER.chrome_events()


def spans_for(trace_id: str) -> List[Dict[str, Any]]:
    """All ring spans of one trace, oldest first."""
    return [r for r in recorder().spans()
            if r.get("trace_id") == trace_id]


def span_tree(trace_id: str) -> Dict[Optional[str], List[Dict[str, Any]]]:
    """parent_id -> children for one trace (roots under ``None``)."""
    tree: Dict[Optional[str], List[Dict[str, Any]]] = {}
    for rec in spans_for(trace_id):
        tree.setdefault(rec.get("parent_id"), []).append(rec)
    return tree


def format_tree(trace_id: str) -> str:
    """Indented text rendering of one trace's span tree."""
    tree = span_tree(trace_id)
    lines: List[str] = []

    def walk(parent: Optional[str], depth: int) -> None:
        for rec in sorted(tree.get(parent, ()),
                          key=lambda r: r["start"]):
            attrs = rec.get("attributes") or {}
            extras = " ".join(f"{k}={v}" for k, v in attrs.items()
                              if k not in ("trace_id",))
            lines.append(f"{'  ' * depth}{rec['name']} "
                         f"[{rec.get('dur', 0.0) * 1e3:.2f}ms]"
                         + (f" {extras}" if extras else ""))
            walk(rec["span_id"], depth + 1)

    walk(None, 0)
    return "\n".join(lines)
