"""Inference telemetry: TTFT, queue waits, prefill and decode times,
speculative accepts, prefix hits by tier, spill and fetch traffic.

Counterpart of ``ray_tpu/telemetry/infer.py``.  The engine records one
entry per prefill, decode step and verify step, each timed on the host
to the sampled tokens reaching it (the step's one synchronisation, so
the figure is the blocking one and recording adds no sync), plus each
request's TTFT at its first token.  :meth:`InferTelemetry.summary` is
the reference's ``telemetry`` block, key for key.

The reference also feeds Prometheus series through the runtime's
metrics when a runtime session is up, and emits nothing without one.
The port has no runtime (ROADMAP Queue 1 item 6c), so it emits nothing:
the calls that only move a gauge (:meth:`~InferTelemetry.
record_queue_depth`, :meth:`~InferTelemetry.record_tier_occupancy`)
record nothing here.

``RAY_TPU_TELEMETRY=0`` (or ``telemetry=False``) disables recording;
the engine checks ``enabled`` before it calls a recorder.
"""

from __future__ import annotations

import statistics
from typing import Any, Dict, List, Optional

from ray_tpu_torch.telemetry.config import telemetry_config


class InferTelemetry:
    """Per-engine recorder for prefill, decode and TTFT records."""

    _MAX_RECORDS = 10_000
    _MAX_EXEMPLARS = 64

    def __init__(self, *, label: str = "infer", config=None):
        tcfg = config or telemetry_config()
        self.enabled: bool = tcfg.enabled
        self.label = label
        self.prefills: List[Dict[str, Any]] = []
        self.decodes: List[Dict[str, Any]] = []
        self.ttfts: List[float] = []
        # (ttft_s, trace_id) of traced requests: from a slow TTFT to its
        # span tree
        self.ttft_exemplars: List[Any] = []
        # TTFT split by prefix-cache outcome (a hit pays only the suffix)
        self.ttfts_hit: List[float] = []
        self.ttfts_miss: List[float] = []
        self.queue_waits: List[float] = []
        self.prefill_count = 0
        self.decode_count = 0
        self.requests_done = 0
        self.decode_tokens = 0
        self.prompt_tokens = 0
        self.prefix_hit_tokens = 0
        self.deadline_exceeded: Dict[str, int] = {}
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.spec_verify_steps = 0
        # tiered KV cache: prefix hits by tier, demote bytes, promotes
        self.tier_hits: Dict[str, int] = {}
        self.kv_spill_bytes = 0
        self.kv_fetches = 0
        self.kv_fetch_seconds = 0.0
        self.kv_store_evictions = 0
        self.adapter_cache_hits = 0
        self.adapter_cache_misses = 0
        self.adapter_loads = 0
        self.adapter_load_seconds = 0.0
        self.cache_info: Dict[str, Any] = {}

    # ---------------------------------------------------------- records
    def record_prefill(self, wall_s: float, *, prompt_tokens: int,
                       bucket: int, cached_tokens: int = 0) -> None:
        if not self.enabled:
            return
        self.prefill_count += 1
        self.prompt_tokens += prompt_tokens
        self.prefix_hit_tokens += cached_tokens
        self.prefills.append({"wall_s": wall_s,
                              "prompt_tokens": prompt_tokens,
                              "cached_tokens": cached_tokens,
                              "bucket": bucket})
        del self.prefills[:-self._MAX_RECORDS]

    def record_decode(self, wall_s: float, *, active: int) -> None:
        if not self.enabled:
            return
        self.decode_count += 1
        self.decode_tokens += active
        self.decodes.append({"wall_s": wall_s, "active": active})
        del self.decodes[:-self._MAX_RECORDS]

    def record_verify(self, wall_s: float, *, proposed: int,
                      accepted: int, emitted: int) -> None:
        """One speculative verify: ``proposed`` drafts scored,
        ``accepted`` kept, ``emitted`` tokens delivered.  It folds into
        the decode series (more than one token per dispatch), so
        ``decode_tokens_per_sec`` stays the engine-wide figure."""
        if not self.enabled:
            return
        self.decode_count += 1
        self.decode_tokens += emitted
        self.spec_verify_steps += 1
        self.spec_proposed += proposed
        self.spec_accepted += accepted
        self.decodes.append({"wall_s": wall_s, "active": emitted})
        del self.decodes[:-self._MAX_RECORDS]

    def record_ttft(self, ttft_s: float, *, prefix_hit: bool = False,
                    trace_id: Optional[str] = None) -> None:
        if not self.enabled:
            return
        self.ttfts.append(ttft_s)
        del self.ttfts[:-self._MAX_RECORDS]
        split = self.ttfts_hit if prefix_hit else self.ttfts_miss
        split.append(ttft_s)
        del split[:-self._MAX_RECORDS]
        if trace_id:
            self.ttft_exemplars.append((ttft_s, trace_id))
            del self.ttft_exemplars[:-self._MAX_EXEMPLARS]

    def record_queue(self, wait_s: float, *, depth: int) -> None:
        """At admission: how long the request waited (``depth``, the
        queue behind it, only moves the reference's gauge)."""
        if not self.enabled:
            return
        self.queue_waits.append(wait_s)
        del self.queue_waits[:-self._MAX_RECORDS]

    def record_queue_depth(self, depth: int) -> None:
        """At submit: the queue-depth gauge, which needs the runtime's
        metrics (nothing is recorded here)."""

    def record_request_done(self) -> None:
        if self.enabled:
            self.requests_done += 1

    def record_deadline_exceeded(self, *, kind: str) -> None:
        """One request retired past its deadline (``ttft``: never
        admitted in time; ``total``: expired mid-flight)."""
        if not self.enabled:
            return
        self.deadline_exceeded[kind] = \
            self.deadline_exceeded.get(kind, 0) + 1

    def record_prefix_hits(self, n_pages: int, *, tier: str) -> None:
        """``n_pages`` prefix pages served from ``tier`` (``hbm``:
        resident; ``dram``: promoted from the host pool; ``store``:
        fetched from the shared page store)."""
        if not self.enabled:
            return
        self.tier_hits[tier] = self.tier_hits.get(tier, 0) + n_pages

    def record_kv_spill(self, nbytes: int) -> None:
        """One page demoted out of device memory, ``nbytes`` in its spill
        encoding."""
        if not self.enabled:
            return
        self.kv_spill_bytes += nbytes

    def record_kv_fetch(self, wall_s: float, *, tier: str) -> None:
        """One page promoted back into the cache from a lower tier."""
        if not self.enabled:
            return
        self.kv_fetches += 1
        self.kv_fetch_seconds += wall_s

    def record_kv_store_evictions(self, n: int) -> None:
        """``n`` entries evicted from the byte-capped page store."""
        if not self.enabled or n <= 0:
            return
        self.kv_store_evictions += n

    def record_adapter_cache(self, *, hit: bool) -> None:
        if not self.enabled:
            return
        if hit:
            self.adapter_cache_hits += 1
        else:
            self.adapter_cache_misses += 1

    def record_adapter_load(self, wall_s: float, *,
                            resident: int) -> None:
        if not self.enabled:
            return
        self.adapter_loads += 1
        self.adapter_load_seconds += wall_s

    def record_tier_occupancy(self, *, hbm: int, dram: int,
                              store: int) -> None:
        """Per-tick pages resident per tier, the reference's gauges
        (nothing is recorded here)."""

    def record_cache_info(self, *, kv_dtype: str, cache_bytes: int,
                          kv_bytes_per_slot: int) -> None:
        """The cache's geometry, once at construction."""
        if self.enabled:
            self.cache_info = {"kv_dtype": kv_dtype,
                               "kv_cache_bytes": int(cache_bytes),
                               "kv_bytes_per_slot":
                                   int(kv_bytes_per_slot)}

    # ---------------------------------------------------------- summary
    def summary(self) -> Dict[str, Any]:
        if not self.enabled:
            return {"enabled": False}
        out: Dict[str, Any] = {
            "enabled": True, "label": self.label,
            "requests_done": self.requests_done,
            "prefills": self.prefill_count,
            "decode_steps": self.decode_count,
            "decode_tokens": self.decode_tokens,
            **self.cache_info,
        }
        out["prompt_tokens"] = self.prompt_tokens
        out["prefill_tokens_skipped"] = self.prefix_hit_tokens
        out["deadline_exceeded"] = dict(self.deadline_exceeded)
        if self.spec_verify_steps:
            out["spec"] = {
                "verify_steps": self.spec_verify_steps,
                "proposed": self.spec_proposed,
                "accepted": self.spec_accepted,
                "accept_rate": (self.spec_accepted
                                / self.spec_proposed
                                if self.spec_proposed else 0.0),
            }
        if self.prompt_tokens:
            out["prefix_hit_rate"] = (self.prefix_hit_tokens
                                      / self.prompt_tokens)
        if self.adapter_cache_hits or self.adapter_cache_misses:
            looked = self.adapter_cache_hits + self.adapter_cache_misses
            out["adapters"] = {
                "cache_hits": self.adapter_cache_hits,
                "cache_misses": self.adapter_cache_misses,
                "cache_hit_rate": self.adapter_cache_hits / looked,
                "loads": self.adapter_loads,
                "load_seconds": self.adapter_load_seconds,
            }
        if self.tier_hits or self.kv_fetches or self.kv_spill_bytes:
            out["tiers"] = {
                "hits": dict(self.tier_hits),
                "spill_bytes": self.kv_spill_bytes,
                "fetches": self.kv_fetches,
                "fetch_seconds": self.kv_fetch_seconds,
                "store_evictions": self.kv_store_evictions,
            }
        if self.ttfts:
            out["ttft_s"] = statistics.median(self.ttfts)
            out["ttft_mean_s"] = statistics.fmean(self.ttfts)
            out["ttft_max_s"] = max(self.ttfts)
        if self.ttft_exemplars:
            worst = max(self.ttft_exemplars, key=lambda e: e[0])
            out["ttft_worst_trace"] = {"ttft_s": worst[0],
                                       "trace_id": worst[1]}
        if self.ttfts_hit:
            out["ttft_prefix_hit_s"] = statistics.median(self.ttfts_hit)
        if self.ttfts_miss:
            out["ttft_prefix_miss_s"] = statistics.median(
                self.ttfts_miss)
        if self.queue_waits:
            out["queue_wait_s"] = statistics.median(self.queue_waits)
            out["queue_wait_max_s"] = max(self.queue_waits)
        if self.prefills:
            out["prefill_s"] = statistics.median(
                r["wall_s"] for r in self.prefills)
        if self.decodes:
            # steady decode: the first step dropped, as the reference
            # does (it carries the compile there, the kernel build here)
            steady = self.decodes[1:] or self.decodes
            out["decode_step_s"] = statistics.median(
                r["wall_s"] for r in steady)
            tok = sum(r["active"] for r in steady)
            wall = sum(r["wall_s"] for r in steady)
            if wall > 0:
                out["decode_tokens_per_sec"] = tok / wall
        return out
