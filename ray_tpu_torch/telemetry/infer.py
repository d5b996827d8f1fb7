# The port's copy of ray_tpu/telemetry/infer.py
"""Inference telemetry: TTFT, queue waits, prefill and decode times,
speculative accepts, prefix hits by tier, spill and fetch traffic.

The engine records one entry per prefill, decode step and verify step,
each timed on the host to the sampled tokens reaching it (the step's one
synchronisation, so the figure is the blocking one and recording adds no
sync), plus each request's TTFT at its first token.  Sinks:

- Prometheus series through the runtime's metrics
  (:mod:`ray_tpu_torch.util.metrics`) when a ``ray_tpu_torch`` session is
  up, and nothing without one (``infer_ttft_seconds`` /
  ``infer_decode_step_seconds`` / ``infer_queue_wait_seconds``
  histograms, ``infer_decode_tokens_per_sec`` / ``infer_queue_depth``
  gauges, the spec, prefix-tier, spill/fetch and adapter series),
  throttled and dead on the first failure;
- :meth:`InferTelemetry.summary`, the ``telemetry`` block, key for key
  the reference's.

``RAY_TPU_TELEMETRY=0`` (or ``telemetry=False``) disables recording;
the engine checks ``enabled`` before it calls a recorder.
"""

from __future__ import annotations

import statistics
import time
from typing import Any, Dict, List, Optional

from ray_tpu_torch.telemetry.config import telemetry_config

_TTFT_BOUNDARIES = [0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                    1.0, 2.5, 5.0, 10.0, 30.0]
_STEP_BOUNDARIES = [0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005,
                    0.01, 0.025, 0.05, 0.1, 0.25, 1.0]


class InferTelemetry:
    """Per-engine recorder for prefill/decode/TTFT records."""

    _MAX_RECORDS = 10_000
    _MAX_EXEMPLARS = 64
    _EMIT_INTERVAL_S = 0.5

    def __init__(self, *, label: str = "infer", config=None):
        tcfg = config or telemetry_config()
        self.enabled: bool = tcfg.enabled
        self.label = label
        self.prefills: List[Dict[str, Any]] = []
        self.decodes: List[Dict[str, Any]] = []
        self.ttfts: List[float] = []
        # (ttft_s, trace_id) exemplars — the histogram-to-trace bridge
        self.ttft_exemplars: List[Any] = []
        # TTFT split by prefix-cache outcome: a hit request's first
        # token only pays the suffix prefill, so the two populations
        # have different distributions worth reporting separately
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
        # speculative decoding (r21): cumulative proposed/accepted
        # draft counts and verify-step count — the accept rate is the
        # one number that decides whether speculation pays
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.spec_verify_steps = 0
        # tiered KV cache (r23): prefix hits by serving tier, plus the
        # demote (spill bytes) and promote (fetch latency) legs
        self.tier_hits: Dict[str, int] = {}
        self.kv_spill_bytes = 0
        self.kv_fetches = 0
        self.kv_fetch_seconds = 0.0
        self.kv_store_evictions = 0
        # multi-tenant LoRA (r25): per-replica adapter-cache outcomes
        # and load latency — the hit rate is what the router's
        # adapter-affinity scoring is supposed to move
        self.adapter_cache_hits = 0
        self.adapter_cache_misses = 0
        self.adapter_loads = 0
        self.adapter_load_seconds = 0.0
        self.cache_info: Dict[str, Any] = {}
        self._metrics = None
        self._metrics_dead = False
        self._metrics_last = 0.0
        self._queue_last = 0.0
        self._tier_last = 0.0

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
        self._emit_decode(wall_s, active)

    def record_verify(self, wall_s: float, *, proposed: int,
                      accepted: int, emitted: int) -> None:
        """One speculative verify step: ``proposed`` drafts scored,
        ``accepted`` of them kept, ``emitted`` real tokens delivered
        (accepted + the correction/bonus row, clipped by EOS/max_new).
        The step folds into the decode series — its wall time and
        emitted tokens are decode throughput, just > 1 token per
        dispatch — so ``decode_tokens_per_sec`` stays the honest
        engine-wide figure with speculation on."""
        if not self.enabled:
            return
        self.decode_count += 1
        self.decode_tokens += emitted
        self.spec_verify_steps += 1
        self.spec_proposed += proposed
        self.spec_accepted += accepted
        self.decodes.append({"wall_s": wall_s, "active": emitted})
        del self.decodes[:-self._MAX_RECORDS]
        self._emit_verify(wall_s, proposed, accepted, emitted)

    def record_ttft(self, ttft_s: float, *, prefix_hit: bool = False,
                    trace_id: Optional[str] = None) -> None:
        """``trace_id`` (when the request was trace-sampled) rides the
        Prometheus histogram as an exemplar — the jump from a p99
        bucket to the one request's flight-recorder span tree."""
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
        self._emit_ttft(ttft_s, trace_id)

    def record_queue(self, wait_s: float, *, depth: int) -> None:
        """Admission-time record: how long the request waited in the
        queue and how deep the queue stands behind it (the load-
        shedding signals: ``RAY_TPU_INFER_MAX_QUEUE`` caps the depth,
        these series say how close traffic runs to the cap)."""
        if not self.enabled:
            return
        self.queue_waits.append(wait_s)
        del self.queue_waits[:-self._MAX_RECORDS]
        self._emit_queue(wait_s, depth)

    def record_queue_depth(self, depth: int) -> None:
        """Submit-time gauge update: admissions stall exactly when the
        queue is backing up, so the depth gauge must also move on
        enqueue or it reads 0 through the whole overload.  Throttled
        like the decode emitter — high-QPS submits must not pay a
        metric emission each."""
        if not self.enabled or self._metrics_dead:
            return
        now = time.monotonic()
        if now - self._queue_last < self._EMIT_INTERVAL_S:
            return
        self._queue_last = now
        self._emit_queue(None, depth)

    def record_request_done(self) -> None:
        if self.enabled:
            self.requests_done += 1

    def record_deadline_exceeded(self, *, kind: str) -> None:
        """One request retired past its deadline (``kind`` = ``ttft``
        — never admitted in time — or ``total`` — expired mid-flight).
        Shed work is the load-limit signal, so it gets a Prometheus
        counter (``infer_deadline_exceeded_total``) operators can rate
        and alarm on."""
        if not self.enabled:
            return
        self.deadline_exceeded[kind] = \
            self.deadline_exceeded.get(kind, 0) + 1
        self._emit_deadline(kind)

    def record_prefix_hits(self, n_pages: int, *, tier: str) -> None:
        """``n_pages`` prefix pages served from ``tier`` (``hbm`` —
        resident refcount bump; ``dram`` — promoted from the host
        pool; ``store`` — fetched from the fleet-shared object store).
        The per-tier split is the whole point of the r23 hierarchy:
        a flat hit rate cannot say which tier is earning its bytes."""
        if not self.enabled:
            return
        self.tier_hits[tier] = self.tier_hits.get(tier, 0) + n_pages
        self._emit_prefix_hits(n_pages, tier)

    def record_kv_spill(self, nbytes: int) -> None:
        """One page demoted out of HBM (``nbytes`` in the spill
        encoding — int8 codes + scales by default, ~half the model-
        dtype figure)."""
        if not self.enabled:
            return
        self.kv_spill_bytes += nbytes
        self._emit_kv_spill(nbytes)

    def record_kv_fetch(self, wall_s: float, *, tier: str) -> None:
        """One page promoted back into HBM from a lower tier — the
        latency the admission paid instead of prefill FLOPs."""
        if not self.enabled:
            return
        self.kv_fetches += 1
        self.kv_fetch_seconds += wall_s
        self._emit_kv_fetch(wall_s, tier)

    def record_kv_store_evictions(self, n: int) -> None:
        """``n`` entries LRU-evicted from the capped fleet page store
        (``RAY_TPU_KV_STORE_CAP``) — the churn signal: a high rate says
        the cap is below the working set and re-admits are paying
        suffix prefills for pages the fleet once held."""
        if not self.enabled or n <= 0:
            return
        self.kv_store_evictions += n
        self._emit_store_evictions(n)

    def record_adapter_cache(self, *, hit: bool) -> None:
        """One adapter-resolution outcome: ``hit`` means the tenant's
        factors were already resident in the engine's bank (zero-cost
        resolution); a miss pays a store fetch + bank install before
        the request can admit."""
        if not self.enabled:
            return
        if hit:
            self.adapter_cache_hits += 1
        else:
            self.adapter_cache_misses += 1
        self._emit_adapter_cache(hit)

    def record_adapter_load(self, wall_s: float, *,
                            resident: int) -> None:
        """One adapter fetched from the store and installed into the
        bank (``wall_s`` = checkout + host ``.at[].set``), plus the
        resident-tenant count after the install (the gauge operators
        watch against ``RAY_TPU_ADAPTER_CACHE``)."""
        if not self.enabled:
            return
        self.adapter_loads += 1
        self.adapter_load_seconds += wall_s
        self._emit_adapter_load(wall_s, resident)

    def record_tier_occupancy(self, *, hbm: int, dram: int,
                              store: int) -> None:
        """Per-tick tier occupancy gauges (pages resident per tier),
        throttled like the decode emitter — the engine calls this every
        tick."""
        if not self.enabled or self._metrics_dead:
            return
        now = time.monotonic()
        if now - self._tier_last < self._EMIT_INTERVAL_S:
            return
        self._tier_last = now
        self._emit_tier_occupancy(hbm, dram, store)

    def record_cache_info(self, *, kv_dtype: str, cache_bytes: int,
                          kv_bytes_per_slot: int) -> None:
        """Static KV-cache geometry the engine reports once at
        construction: the storage dtype and the *true* per-slot
        footprint (codes + scale arrays for int8 caches) — the figures
        the ``bench.py --infer`` headline carries."""
        if self.enabled:
            self.cache_info = {"kv_dtype": kv_dtype,
                               "kv_cache_bytes": int(cache_bytes),
                               "kv_bytes_per_slot":
                                   int(kv_bytes_per_slot)}

    # ---------------------------------------------------------- summary
    def summary(self) -> Dict[str, Any]:
        """The ``telemetry`` block for ``bench.py --infer`` JSON."""
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
            # the worst traced request — where tail diagnosis starts
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
            # steady decode: drop the first step (carries the compile
            # on cold engines), same policy as StepTelemetry step 0
            steady = self.decodes[1:] or self.decodes
            step_s = statistics.median(r["wall_s"] for r in steady)
            out["decode_step_s"] = step_s
            tok = sum(r["active"] for r in steady)
            wall = sum(r["wall_s"] for r in steady)
            if wall > 0:
                out["decode_tokens_per_sec"] = tok / wall
        return out

    # ------------------------------------------------------- prometheus
    def _metric_objects(self):
        from ray_tpu_torch._private.worker import is_initialized
        if not is_initialized():
            return None
        if self._metrics is None:
            from ray_tpu_torch.util.metrics import Counter, Gauge, Histogram
            tags = ("label",)
            self._metrics = {
                "ttft": Histogram(
                    "infer_ttft_seconds",
                    "time from request submit to first token",
                    boundaries=_TTFT_BOUNDARIES, tag_keys=tags),
                "step": Histogram(
                    "infer_decode_step_seconds",
                    "decode step wall seconds (to sampled tokens)",
                    boundaries=_STEP_BOUNDARIES, tag_keys=tags),
                "tok": Gauge("infer_decode_tokens_per_sec",
                             "decode throughput", tag_keys=tags),
                "queue_wait": Histogram(
                    "infer_queue_wait_seconds",
                    "time from request submit to slot admission",
                    boundaries=_TTFT_BOUNDARIES, tag_keys=tags),
                "queue_depth": Gauge(
                    "infer_queue_depth",
                    "requests waiting for a decode slot",
                    tag_keys=tags),
                "deadline": Counter(
                    "infer_deadline_exceeded_total",
                    "requests retired past their TTFT/total deadline",
                    tag_keys=("label", "kind")),
                "spec_proposed": Counter(
                    "infer_spec_proposed_total",
                    "speculative draft tokens proposed",
                    tag_keys=tags),
                "spec_accepted": Counter(
                    "infer_spec_accepted_total",
                    "speculative draft tokens accepted",
                    tag_keys=tags),
                "spec_rate": Gauge(
                    "infer_spec_accept_rate",
                    "cumulative speculative accept rate",
                    tag_keys=tags),
                # a gauge, not a histogram: draft counts are neither
                # seconds nor bytes, and the naming lint
                # (tests/test_metrics_naming.py) holds histograms to
                # those units — the accept *distribution* lives in
                # ``stats()["spec"]["k_hist"]``
                "spec_hist": Gauge(
                    "infer_spec_accepted_tokens",
                    "drafts accepted in the most recent verify step",
                    tag_keys=tags),
                "prefix_hits": Counter(
                    "infer_prefix_hits_total",
                    "prefix pages served, by tier",
                    tag_keys=("label", "tier")),
                "kv_spill": Counter(
                    "infer_kv_spill_bytes_total",
                    "KV page bytes demoted out of HBM",
                    tag_keys=tags),
                "kv_fetch": Histogram(
                    "infer_kv_fetch_seconds",
                    "KV page promote latency, by source tier",
                    boundaries=_STEP_BOUNDARIES,
                    tag_keys=("label", "tier")),
                "tier_pages": Gauge(
                    "infer_kv_tier_pages",
                    "prefix pages resident, by tier",
                    tag_keys=("label", "tier")),
                "store_evictions": Counter(
                    "infer_kv_store_evictions_total",
                    "entries LRU-evicted from the capped fleet "
                    "KV page store",
                    tag_keys=tags),
                "adapter_hits": Counter(
                    "serve_adapter_cache_hits_total",
                    "adapter resolutions served from the resident bank",
                    tag_keys=tags),
                "adapter_misses": Counter(
                    "serve_adapter_cache_misses_total",
                    "adapter resolutions that paid a store fetch",
                    tag_keys=tags),
                "adapter_load": Histogram(
                    "serve_adapter_load_seconds",
                    "adapter store-fetch + bank-install latency",
                    boundaries=_TTFT_BOUNDARIES, tag_keys=tags),
                "adapter_resident": Gauge(
                    "serve_adapter_resident",
                    "tenant adapters resident in the bank",
                    tag_keys=tags),
            }
        return self._metrics

    def _emit_ttft(self, ttft_s: float,
                   trace_id: Optional[str] = None):
        if self._metrics_dead:
            return
        try:
            metrics = self._metric_objects()
            if metrics is not None:
                metrics["ttft"].observe(
                    ttft_s, tags={"label": self.label},
                    exemplar=({"trace_id": trace_id}
                              if trace_id else None))
        except Exception:  # noqa: BLE001 — never tax the serve loop
            self._metrics_dead = True

    def _emit_queue(self, wait_s, depth: int):
        if self._metrics_dead:
            return
        try:
            metrics = self._metric_objects()
            if metrics is not None:
                tags = {"label": self.label}
                if wait_s is not None:
                    metrics["queue_wait"].observe(wait_s, tags=tags)
                metrics["queue_depth"].set(depth, tags=tags)
        except Exception:  # noqa: BLE001 — never tax the serve loop
            self._metrics_dead = True

    def _emit_deadline(self, kind: str):
        if self._metrics_dead:
            return
        try:
            metrics = self._metric_objects()
            if metrics is not None:
                metrics["deadline"].inc(
                    1.0, tags={"label": self.label, "kind": kind})
        except Exception:  # noqa: BLE001 — never tax the serve loop
            self._metrics_dead = True

    def _emit_verify(self, wall_s: float, proposed: int,
                     accepted: int, emitted: int):
        if self._metrics_dead:
            return
        try:
            metrics = self._metric_objects()
            if metrics is None:
                return
            tags = {"label": self.label}
            # counters are exact (never throttled — rates must add up);
            # the gauge/histograms ride the decode emitter's throttle
            metrics["spec_proposed"].inc(float(proposed), tags=tags)
            metrics["spec_accepted"].inc(float(accepted), tags=tags)
            now = time.monotonic()
            if (self.spec_verify_steps > 1
                    and now - self._metrics_last
                    < self._EMIT_INTERVAL_S):
                return
            self._metrics_last = now
            metrics["spec_hist"].set(float(accepted), tags=tags)
            if self.spec_proposed:
                metrics["spec_rate"].set(
                    self.spec_accepted / self.spec_proposed, tags=tags)
            metrics["step"].observe(wall_s, tags=tags)
            if wall_s > 0:
                metrics["tok"].set(emitted / wall_s, tags=tags)
        except Exception:  # noqa: BLE001 — never tax the serve loop
            self._metrics_dead = True

    def _emit_prefix_hits(self, n_pages: int, tier: str):
        if self._metrics_dead:
            return
        try:
            metrics = self._metric_objects()
            if metrics is not None:
                metrics["prefix_hits"].inc(
                    float(n_pages),
                    tags={"label": self.label, "tier": tier})
        except Exception:  # noqa: BLE001 — never tax the serve loop
            self._metrics_dead = True

    def _emit_kv_spill(self, nbytes: int):
        if self._metrics_dead:
            return
        try:
            metrics = self._metric_objects()
            if metrics is not None:
                metrics["kv_spill"].inc(float(nbytes),
                                        tags={"label": self.label})
        except Exception:  # noqa: BLE001 — never tax the serve loop
            self._metrics_dead = True

    def _emit_kv_fetch(self, wall_s: float, tier: str):
        if self._metrics_dead:
            return
        try:
            metrics = self._metric_objects()
            if metrics is not None:
                metrics["kv_fetch"].observe(
                    wall_s, tags={"label": self.label, "tier": tier})
        except Exception:  # noqa: BLE001 — never tax the serve loop
            self._metrics_dead = True

    def _emit_store_evictions(self, n: int):
        if self._metrics_dead:
            return
        try:
            metrics = self._metric_objects()
            if metrics is not None:
                metrics["store_evictions"].inc(
                    float(n), tags={"label": self.label})
        except Exception:  # noqa: BLE001 — never tax the serve loop
            self._metrics_dead = True

    def _emit_adapter_cache(self, hit: bool):
        if self._metrics_dead:
            return
        try:
            metrics = self._metric_objects()
            if metrics is not None:
                key = "adapter_hits" if hit else "adapter_misses"
                metrics[key].inc(1.0, tags={"label": self.label})
        except Exception:  # noqa: BLE001 — never tax the serve loop
            self._metrics_dead = True

    def _emit_adapter_load(self, wall_s: float, resident: int):
        if self._metrics_dead:
            return
        try:
            metrics = self._metric_objects()
            if metrics is not None:
                tags = {"label": self.label}
                metrics["adapter_load"].observe(wall_s, tags=tags)
                metrics["adapter_resident"].set(resident, tags=tags)
        except Exception:  # noqa: BLE001 — never tax the serve loop
            self._metrics_dead = True

    def _emit_tier_occupancy(self, hbm: int, dram: int, store: int):
        try:
            metrics = self._metric_objects()
            if metrics is None:
                return
            for tier, n in (("hbm", hbm), ("dram", dram),
                            ("store", store)):
                metrics["tier_pages"].set(
                    n, tags={"label": self.label, "tier": tier})
        except Exception:  # noqa: BLE001 — never tax the serve loop
            self._metrics_dead = True

    def _emit_decode(self, wall_s: float, active: int):
        if self._metrics_dead:
            return
        now = time.monotonic()
        if (self.decode_count > 1
                and now - self._metrics_last < self._EMIT_INTERVAL_S):
            return
        self._metrics_last = now
        try:
            metrics = self._metric_objects()
            if metrics is None:
                return
            tags = {"label": self.label}
            metrics["step"].observe(wall_s, tags=tags)
            if wall_s > 0:
                metrics["tok"].set(active / wall_s, tags=tags)
        except Exception:  # noqa: BLE001 — never tax the serve loop
            self._metrics_dead = True
