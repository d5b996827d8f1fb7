"""Continuous-batching inference engine for the GPT family, in PyTorch.

Counterpart of ``ray_tpu/inference/engine.py``.  ``submit()`` enqueues a
request; ``step()`` is one engine tick: admit waiting requests into free
slots (one bucketed prefill each), then one batched decode over every
slot; ``generate()`` runs a batch of prompts to completion.

- **Prefill**, one request at a time, pads the prompt to the smallest
  length bucket that fits and runs the layer stack with a cache hook:
  the rotated K and V are written into the slot's pages, then the
  prefill kernel (``ops/attention.py:flash_attention``) attends over the
  bucket, and the fused out-proj + residual + RMSNorm kernel
  (``ops/fused_norm.py``) closes each layer's attention block.
- **Prefix caching** (on by default, as in the JAX package): admission
  installs the pages of a cached prompt prefix into the slot
  (``scheduler.py``), and the prefill of such a request runs only the
  suffix: its queries attend over the cached pages and causally over
  the suffix itself in one softmax (:func:`_cached_context_attention`,
  plain PyTorch, as the reference's is plain XLA).  Every prefill then
  registers the prompt's full pages for later requests.
- **Decode** runs all ``slots`` rows at once: each slot's token K/V is
  written at its length, and the decode-attention kernel attends over
  each slot's pages up to its length, reading them in place through the
  page table (``decode_attention_paged``; no gathered context).
  Inactive slots ride along writing into the garbage page.
- **int8 KV cache** (``kv_dtype="int8"``): K/V are stored as int8 codes
  with one f32 scale per (position, head) (``quant.quantize_block``);
  prefill attention reads the full-precision prompt K/V, a cached
  prefix is dequantized to the model dtype, and decode runs the int8
  decode-attention kernel, which dequantizes inside its strips.
- **Sampling** is ``inference/sampling.py``, row-independent.
- **Speculative decoding** (``spec=`` / ``RAY_TPU_INFER_SPEC``, or a
  per-request ``SamplingParams.spec``): each tick the self-drafter
  (``inference/spec.py``, n-gram copy over the request's own tokens)
  proposes up to ``spec_k`` tokens per slot, and ONE verify forward per
  speculating slot scores ``[last_token, d1..dk]`` at the slot's length:
  the cached-context prefill in all-rows mode, whose context is the
  slot's first ``L`` positions (:meth:`InferenceEngine._verify_step`).
  Row i is sampled with the noise of ``(seed, len(generated) + i)``,
  the noise plain decode draws at that position, so accepting a draft
  iff the sampled token equals it reproduces plain decode (greedy
  bit-exact, sampled trajectory-exact).  A rejected tail rolls back by
  not advancing the slot's length; its K/V stays behind the length
  mask and the next writes overwrite it.  Plain slots co-batch in the
  decode step beside the speculating slots' dead rows, whose page-table
  rows are masked to the garbage page.
- **Disaggregated handoff.**  A prefill engine runs first-token-stop
  submissions (``submit(max_new_tokens=1, hold_pages=True)``) whose
  pages outlive retirement; :meth:`InferenceEngine.export_request` copies
  them to the host as a ``kv_cache.KVHandoff`` and releases them.  A
  decode engine's :meth:`InferenceEngine.import_submit` admits the
  handoff like any request, takes the pages it already holds by chain
  hash as prefix hits, writes the rest from the payload, and seeds the
  slot at the context's length, so the ordinary decode step continues
  the sequence.
- **Tiered KV cache** (``host_pages``, ``store``, ``spill_dtype``):
  pressure on the device pages demotes an idle prefix page to a host
  pool and on to a shared page store (``kv_cache.HostPagePool``,
  ``KVPageStore``), int8-coded by default; admission promotes a
  lower-tier hit back into fresh pages before the suffix prefill.
- **Deadlines** (``ttft_deadline``/``deadline`` and per request): at
  the start of each tick an expired request is retired, everything
  released, with a terminal ``StepEvent`` carrying a
  ``DeadlineExceededError``.
- **Telemetry** (``telemetry=``, ``RAY_TPU_TELEMETRY``) records what the
  JAX engine records (``telemetry.infer.InferTelemetry``), and a request
  submitted with ``trace_ctx`` leaves its queue, prefix-walk,
  tier-fetch, prefill, install and verify spans in the flight recorder
  (``telemetry.trace``); the context rides the handoff.  Both read the
  host clock after the step's one synchronisation (the sampled tokens
  reaching the host), so neither adds a device sync.
- **Chaos sites** (``util.chaos``): ``infer.decode`` before a decode
  step launches anything, ``kv.spill`` and ``kv.fetch`` on the tier
  legs.

PyTorch runs eagerly, so there is nothing to compile: per-kind call
counters (``call_counts``) and wall seconds (``seconds``) take the place
of the JAX engine's compile counters.  CUDA-graph capture of the steps
is later work.

LoRA adapter banks are not ported yet: ``lora=`` raises
``NotImplementedError`` (ROADMAP Queue 1 item 11) and a request or
handoff naming a ``model_id`` raises ``AdapterUnavailableError``, as the
JAX engine does without adapter support.  The engine runs on the card
unless the caller passes ``device="cpu"``; without a card it raises.
"""

from __future__ import annotations

import collections
import functools
import threading
import time
from typing import Any, Dict, List, Optional, Set, Tuple, Union

import numpy as np
import torch

from ray_tpu_torch.adapters import AdapterUnavailableError
from ray_tpu_torch.convert import array_to_tensor
from ray_tpu_torch.inference import kv_cache as kvc
from ray_tpu_torch.inference.config import default_buckets, infer_config
from ray_tpu_torch.inference.sampling import (SamplingParams,
                                              accept_drafts,
                                              sample_tokens_logprobs)
from ray_tpu_torch.inference.scheduler import (DeadlineExceededError,
                                               Request, SlotScheduler)
from ray_tpu_torch.inference.spec import DraftState
from ray_tpu_torch.models import gpt as gpt_mod
from ray_tpu_torch.ops.attention import (decode_attention_paged,
                                         flash_attention)
from ray_tpu_torch.ops.substrate import NEG_INF, resolve_device
from ray_tpu_torch.quant import quantize_block
from ray_tpu_torch.telemetry import trace as trace_mod
from ray_tpu_torch.telemetry.config import TelemetryConfig
from ray_tpu_torch.telemetry.infer import InferTelemetry
from ray_tpu_torch.util import chaos, tracing


class StepEvent(tuple):
    """One ``step()`` event: unpacks and compares as ``(rid, token,
    done)``, with the sampled token's model logprob as ``ev.logprob``
    and the failure channel as ``ev.error``: a request retired by a
    deadline, or an import whose resident pages went missing, ends with
    one event ``(rid, -1, True)`` carrying the typed error, which
    :meth:`InferenceEngine.generate` raises."""

    def __new__(cls, rid: int, token: int, done: bool, logprob: float,
                error: Optional[BaseException] = None):
        self = super().__new__(cls, (rid, token, done))
        self.logprob = logprob
        self.error = error
        return self

    def __getnewargs__(self):
        return (self[0], self[1], self[2], self.logprob, self.error)


def _params_to(tree, device, dtype) -> Dict[str, Any]:
    """A parameter tree (tensors or numpy leaves) on ``device``."""
    if isinstance(tree, dict):
        return {k: _params_to(v, device, dtype) for k, v in tree.items()}
    t = tree.to(device) if isinstance(tree, torch.Tensor) else \
        array_to_tensor(tree, device)
    if t.dtype != dtype:
        raise ValueError(f"parameter of dtype {t.dtype} for a {dtype} "
                         "model")
    return t


def _cached_context_attention(q, kctx, vctx, ks, vs, cached_len: int):
    """Suffix queries over (cached context + causal suffix self).

    q/ks/vs: [1, S, H, D], the suffix's (post-RoPE) queries and its own
    full-precision keys/values; kctx/vctx: [1, C, H, D], the slot's
    gathered pages, of which only the first ``cached_len`` positions are
    context.  The rest (the tail of a partial page, where the suffix's
    own copy was just written, or rolled-back drafts) is cut off before
    any product, so it contributes exactly nothing whatever it holds.
    One softmax over the concatenated [ctx | self] score axis gives
    attention over the full ``cached + suffix`` sequence, as
    ``ray_tpu/inference/engine.py:_cached_context_attention`` computes it
    with its length mask: scores in f32, ``p`` rounded to the value dtype
    before each product, products accumulated in f32, ``l`` clamped at
    1e-30."""
    kctx, vctx = kctx[:, :cached_len], vctx[:, :cached_len]
    S, D = q.shape[1], q.shape[3]
    C = cached_len
    scale = D ** -0.5
    qf = q.float()
    sc = torch.einsum("bqhd,bkhd->bhqk", qf, kctx.float()) * scale
    ss = torch.einsum("bqhd,bkhd->bhqk", qf, ks.float()) * scale
    causal = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    s = torch.cat([sc, torch.where(causal, ss, NEG_INF)], -1)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)                         # [B, H, S, 1]
    o = (torch.einsum("bhqk,bkhd->bqhd",
                      p[..., :C].to(vctx.dtype).float(), vctx.float())
         + torch.einsum("bhqk,bkhd->bqhd",
                        p[..., C:].to(vs.dtype).float(), vs.float()))
    l = l.transpose(1, 2)                               # [B, S, H, 1]
    return (o / l.clamp_min(1e-30)).to(q.dtype)


class InferenceEngine:
    """Continuous-batching decode engine over one GPT parameter set.

    Knobs default to :func:`~ray_tpu_torch.inference.config.infer_config`
    (``RAY_TPU_INFER_*``); constructor arguments pin them.
    ``debug_logits`` keeps each request's logits rows in
    ``logits_trace[rid]`` for the parity tests."""

    def __init__(self, cfg: "gpt_mod.GPTConfig", params, *,
                 device=None,
                 slots: Optional[int] = None,
                 page_size: Optional[int] = None,
                 num_pages: Optional[int] = None,
                 buckets: Optional[Tuple[int, ...]] = None,
                 prefix: Optional[bool] = None,
                 max_queue: Optional[int] = None,
                 kv_dtype: Optional[str] = None,
                 spec: Optional[bool] = None,
                 spec_k: Optional[int] = None,
                 host_pages: Optional[int] = None,
                 store: Union["kvc.KVPageStore", bool, None] = None,
                 spill_dtype: Optional[str] = None,
                 lora=None,
                 telemetry: Optional[bool] = None,
                 ttft_deadline: Optional[float] = None,
                 deadline: Optional[float] = None,
                 debug_logits: bool = False):
        gpt_mod.check_supported(cfg)
        icfg = infer_config()
        if lora:
            raise NotImplementedError(
                "LoRA adapter banks are not ported yet (ROADMAP Queue 1 "
                "item 11: adapters and RL)")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = _params_to(params, self.device, cfg.dtype)
        self.slots = slots if slots is not None else icfg.slots
        self.page_size = (page_size if page_size is not None
                          else icfg.page_size)
        self.max_queue = (icfg.max_queue if max_queue is None
                          else max_queue)
        self.prefix = icfg.prefix if prefix is None else bool(prefix)
        # speculative-decoding defaults; a request's SamplingParams
        # override them (resolved once at submit onto Request.spec_k)
        self.spec = icfg.spec if spec is None else bool(spec)
        self.spec_k = icfg.spec_k if spec_k is None else int(spec_k)
        if self.spec_k < 1:
            raise ValueError(f"spec_k must be >= 1, got {self.spec_k} "
                             "(check RAY_TPU_INFER_SPEC_K)")
        if self.slots < 1:
            raise ValueError(f"need >= 1 decode slot, got {self.slots} "
                             "(check RAY_TPU_INFER_SLOTS)")
        if self.page_size < 1:
            raise ValueError(f"page_size must be >= 1, got "
                             f"{self.page_size}")
        if self.max_queue < 0:
            raise ValueError(f"max_queue must be >= 0, got "
                             f"{self.max_queue}")
        self.buckets = tuple(sorted(
            b for b in (buckets or icfg.buckets
                        or default_buckets(cfg.max_seq))
            if b <= cfg.max_seq)) or (cfg.max_seq,)
        max_pages_per_slot = kvc.pages_needed(cfg.max_seq, self.page_size)
        num_pages = num_pages or icfg.pages or (
            self.slots * max_pages_per_slot + 1)
        self.max_pages_per_slot = max_pages_per_slot
        self.scheduler = SlotScheduler(
            slots=self.slots, page_size=self.page_size,
            num_pages=num_pages, max_pages_per_slot=max_pages_per_slot,
            prefix=self.prefix, max_queue=self.max_queue)
        self.cache = kvc.KVCache(
            n_layers=cfg.n_layers, num_pages=num_pages,
            page_size=self.page_size, n_heads=cfg.n_heads,
            head_dim=cfg.head_dim, dtype=cfg.dtype, device=self.device,
            kv_dtype=kv_dtype or icfg.kv_dtype)
        self.kv_dtype = self.cache.kv_dtype
        # default per-request deadlines, None or positive; per-submit
        # budgets win
        self.ttft_deadline = (icfg.ttft_deadline if ttft_deadline
                              is None else float(ttft_deadline)) or None
        self.deadline = (icfg.deadline if deadline is None
                         else float(deadline)) or None
        # the tiered cache: device pages (tier 0) -> this engine's host
        # pool (tier 1) -> a page store (tier 2; a shared KVPageStore,
        # True for a private one, None to follow RAY_TPU_KV_STORE when
        # tiering is on).  Entries are keyed by the prefix index's chain
        # hashes, so tiering needs prefix caching.
        self.host_pages = (icfg.host_pages if host_pages is None
                           else int(host_pages))
        self.spill_dtype = spill_dtype or icfg.spill_dtype
        if self.spill_dtype not in kvc.SPILL_DTYPES:
            raise ValueError(
                f"unknown spill_dtype {self.spill_dtype!r} "
                "(check RAY_TPU_KV_SPILL_DTYPE)")
        if self.host_pages < 0:
            raise ValueError(f"host_pages must be >= 0, got "
                             f"{self.host_pages} "
                             "(check RAY_TPU_KV_HOST_PAGES)")
        if isinstance(store, kvc.KVPageStore):
            self.store: Optional[kvc.KVPageStore] = store
        elif store is True or (store is None and icfg.store
                               and self.host_pages > 0):
            self.store = kvc.KVPageStore()
        else:
            self.store = None
        self.tiered = self.prefix and (self.host_pages > 0
                                       or self.store is not None)
        if self.tiered:
            self.host_pool: Optional[kvc.HostPagePool] = \
                kvc.HostPagePool(self.host_pages, store=self.store)
            self.scheduler.allocator.spill_hook = self._spill_page
            self.scheduler.tier_lookup = self._tier_probe
        else:
            self.host_pool = None
        self.tier_hits = {"hbm": 0, "dram": 0, "store": 0}
        self.spill_bytes = 0
        self.spill_faults = 0
        self.fetches = 0
        self.fetch_seconds = 0.0
        self.fetch_faults = 0
        kinds = ("prefill", "prefill_cached", "decode", "verify")
        self.call_counts: Dict[str, int] = {k: 0 for k in kinds}
        self.seconds: Dict[str, float] = {k: 0.0 for k in kinds}
        self._requests: Dict[int, Request] = {}
        # per-request drafter indexes (popped when the request retires,
        # cleared by drain_requests) and the cumulative draft accounting:
        # spec_k_hist[m] counts the verifies that accepted m drafts
        self._drafts: Dict[int, DraftState] = {}
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.spec_k_hist: Dict[int, int] = {}
        # retired requests whose pages wait for export_request or
        # release_held (the leak audit counts them)
        self._held: Dict[int, Request] = {}
        self.exports = 0
        self.imports = 0
        # the replica id spans carry (None for a bare engine)
        self.trace_label: Optional[str] = None
        # the store's eviction counter is cumulative and may be shared:
        # step() reports its deltas
        self._store_evictions_seen = (self.store.evictions
                                      if self.store is not None else 0)
        self._next_rid = 0
        self._cancelled: set = set()
        self._lock = threading.Lock()   # submit()/cancel() vs step()
        # liveness for the watchdog: completed step() calls and the time
        # of the last one
        self.ticks = 0
        self.last_tick_ts = time.monotonic()
        self.deadline_exceeded = 0
        self.param_version = 0
        self.debug_logits = debug_logits
        self.logits_trace: Dict[int, List[np.ndarray]] = {}
        config = (TelemetryConfig(enabled=True) if telemetry is True
                  else TelemetryConfig(enabled=False)
                  if telemetry is False else None)
        self.telemetry = InferTelemetry(config=config)
        self.telemetry.record_cache_info(
            kv_dtype=self.kv_dtype, cache_bytes=self.cache.bytes,
            kv_bytes_per_slot=self.cache.bytes_per_slot(
                max_pages_per_slot))

    # --------------------------------------------------------- requests
    def submit(self, prompt, max_new_tokens: int = 16,
               sampling: Optional[SamplingParams] = None,
               eos_token: Optional[int] = None,
               ttft_deadline_s: Optional[float] = None,
               deadline_s: Optional[float] = None,
               hold_pages: bool = False, trace_ctx=None) -> int:
        """Enqueue one request and return its id.  ``hold_pages`` keeps
        its pages past retirement for :meth:`export_request` (a
        first-token-stop submission is ``max_new_tokens=1`` with it set);
        ``trace_ctx`` (a ``telemetry.trace.TraceContext``) hangs the
        request's spans off that trace.  Deadlines default to the
        engine's; 0 turns one off."""
        sampling = sampling or SamplingParams()
        if sampling.model_id:
            raise AdapterUnavailableError(
                sampling.model_id, "engine built without adapter "
                "support (adapters are ROADMAP Queue 1 item 11)")
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if len(prompt) + max_new_tokens > self.cfg.max_seq:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens "
                f"({max_new_tokens}) exceeds max_seq {self.cfg.max_seq}")
        if len(prompt) > self.buckets[-1]:
            raise ValueError(f"prompt length {len(prompt)} exceeds the "
                             f"largest prefill bucket {self.buckets[-1]}")
        spec_k = self._resolve_spec_k(sampling)
        with self._lock:
            rid = self._next_rid
            self._next_rid += 1
            req = Request(rid=rid, prompt=prompt,
                          max_new_tokens=max_new_tokens,
                          sampling=sampling, eos_token=eos_token,
                          ttft_deadline_s=(self.ttft_deadline
                                           if ttft_deadline_s is None
                                           else ttft_deadline_s or None),
                          deadline_s=(self.deadline if deadline_s is None
                                      else deadline_s or None),
                          hold_pages=bool(hold_pages), spec_k=spec_k,
                          trace=trace_ctx)
            self.scheduler.submit(req)    # validates; may raise
            self._requests[rid] = req
            depth = len(self.scheduler.waiting)
        if self.telemetry.enabled:
            self.telemetry.record_queue_depth(depth)
        return rid

    def _resolve_spec_k(self, sampling: SamplingParams) -> int:
        """The request's draft budget (0 = plain decode): the request's
        ``SamplingParams.spec``/``spec_k`` over the engine's defaults."""
        on = self.spec if sampling.spec is None else bool(sampling.spec)
        if not on:
            return 0
        k = (self.spec_k if sampling.spec_k is None
             else int(sampling.spec_k))
        if k < 1:
            raise ValueError(f"spec_k must be >= 1, got {k}")
        return k

    def cancel(self, rid: int) -> None:
        """Retire ``rid`` at the start of the next :meth:`step` (a no-op
        for finished or unknown ids)."""
        with self._lock:
            if rid in self._requests:
                self._cancelled.add(rid)

    def _process_cancels(self) -> None:
        with self._lock:
            cancelled, self._cancelled = self._cancelled, set()
            if not cancelled:
                return
            sched = self.scheduler
            for slot, req in list(sched.active.items()):
                if req.rid in cancelled:
                    sched.retire(slot)
                    self._requests.pop(req.rid, None)
                    self._drafts.pop(req.rid, None)
            for req in [r for r in sched.waiting if r.rid in cancelled]:
                sched.waiting.remove(req)
                req.done = True
                self._requests.pop(req.rid, None)

    def _expire_deadlines(self, events) -> None:
        """Retire every request past its deadline, at the tick's start
        (where cancels run: nothing is in flight over a slot).  A waiting
        request can blow either budget, an active one only the total
        (admission delivered its first token).  Retirement releases the
        slot, pages and prefix references and emits a terminal event
        with the :class:`DeadlineExceededError`."""
        now = time.monotonic()

        def expiry(req: Request, waiting: bool):
            waited = now - req.submitted_ts
            if waiting and req.ttft_deadline_s is not None \
                    and waited > req.ttft_deadline_s:
                return DeadlineExceededError(req.rid, "ttft",
                                             req.ttft_deadline_s, waited)
            if req.deadline_s is not None and waited > req.deadline_s:
                return DeadlineExceededError(req.rid, "total",
                                             req.deadline_s, waited)
            return None

        expired: List[Request] = []
        with self._lock:
            sched = self.scheduler
            for req, err in [(r, e) for r in sched.waiting
                             if (e := expiry(r, True)) is not None]:
                sched.waiting.remove(req)
                req.error = err
                req.done = True
                self._requests.pop(req.rid, None)
                expired.append(req)
            for slot, req in list(sched.active.items()):
                err = expiry(req, False)
                if err is not None:
                    sched.retire(slot)
                    req.error = err
                    self._requests.pop(req.rid, None)
                    self._drafts.pop(req.rid, None)
                    expired.append(req)
        for req in expired:
            self.deadline_exceeded += 1
            if self.telemetry.enabled:
                self.telemetry.record_deadline_exceeded(
                    kind=req.error.kind)
            trace_mod.anomaly("deadline", trace=req.trace, rid=req.rid,
                              budget=req.error.kind,
                              budget_s=req.error.budget_s,
                              waited_s=req.error.waited_s,
                              replica=self.trace_label)
            events.append(StepEvent(req.rid, -1, True, 0.0,
                                    error=req.error))

    def drain_requests(self) -> int:
        """Retire every known request now, host-side, with no device
        step: the teardown path when nothing will step this engine
        again.  Held exports are released and drafter state goes with
        the requests.  Safe only while no :meth:`step` runs.  Returns how
        many requests were retired."""
        with self._lock:
            rids = list(self._requests)
        for rid in rids:
            self.cancel(rid)
        self._process_cancels()
        held = list(self._held)
        for rid in held:
            self.release_held(rid)
        self._drafts.clear()
        return len(rids) + len(held)

    # ------------------------------------------- disaggregated handoff
    def export_request(self, rid: int) -> "kvc.KVHandoff":
        """Export a retired, held request's cached K/V as a
        ``kv_cache.KVHandoff`` on the host and release its pages (the
        prefill side of the split).  The payload covers every cached
        context token (``prompt + generated[:-1]``: the prompt, for a
        first-token-stop submission) and carries the last sampled token,
        which the decode side feeds next.  Registered full pages park
        idle in the prefix pool, so a later handoff of the same prefix
        prefills nothing here."""
        req = self._held.pop(rid)
        context = list(req.prompt) + list(req.generated[:-1])
        n_pages = kvc.pages_needed(len(context), self.page_size)
        arrays = kvc.export_pages(self.cache, req.pages[:n_pages])
        handoff = kvc.KVHandoff(
            context=context, page_size=self.page_size,
            kv_dtype=self.kv_dtype, dtype=kvc.dtype_name(self.cache.k.dtype),
            chain_hashes=kvc.PrefixIndex.chain_hashes(
                context, self.page_size, salt=req.hash_salt),
            next_token=int(req.generated[-1]),
            next_logprob=float(req.logprobs[-1]),
            trace=(req.trace.to_wire() if req.trace is not None
                   else None),
            model_id=req.model_id,
            adapter_version=req.adapter_version, **arrays)
        self.scheduler.allocator.release(req.pages)
        req.pages = None
        self.exports += 1
        return handoff

    def release_held(self, rid: int) -> bool:
        """Release a held request's pages without exporting them (the
        handoff failed, or the engine is being torn down).  True if
        ``rid`` was held."""
        req = self._held.pop(rid, None)
        if req is None:
            return False
        self.scheduler.allocator.release(req.pages)
        req.pages = None
        return True

    def import_submit(self, handoff: "kvc.KVHandoff", *,
                      max_new_tokens: int,
                      sampling: Optional[SamplingParams] = None,
                      eos_token: Optional[int] = None,
                      deadline_s: Optional[float] = None) -> int:
        """Enqueue a handoff on the decode side of the split.

        It admits through the scheduler like any request (slot and pages
        reserved up front; it waits under pressure), but admission
        installs the payload instead of prefilling: pages resident by
        chain hash are taken as hits with no write, the rest are written
        from the handoff, and the slot starts at the context's length
        with the handoff's token as input.  ``max_new_tokens`` counts the
        tokens still to come: the prefill side's token is this request's
        first, so sampling counts and EOS/length arithmetic match a
        co-located run."""
        if handoff.page_size != self.page_size:
            raise ValueError(
                f"handoff page_size {handoff.page_size} != engine "
                f"page_size {self.page_size} — one fleet geometry")
        if handoff.kv_dtype != self.kv_dtype \
                or (handoff.k is not None
                    and kvc.dtype_name(handoff.k.dtype)
                    != kvc.dtype_name(self.cache.k.dtype)):
            raise ValueError(
                f"handoff kv_dtype {handoff.kv_dtype!r} "
                f"(storage {handoff.dtype}) != engine "
                f"{self.kv_dtype!r} ({kvc.dtype_name(self.cache.k.dtype)})"
                " — the contents would be reinterpreted, not converted")
        if max_new_tokens < 1:
            raise ValueError("a handoff needs >= 1 token left to "
                             "decode — a finished stream has nothing "
                             "to hand off")
        context = [int(t) for t in handoff.context]
        if len(context) + 1 + max_new_tokens > self.cfg.max_seq:
            raise ValueError(
                f"context ({len(context)}) + remaining tokens "
                f"({1 + max_new_tokens}) exceeds max_seq "
                f"{self.cfg.max_seq}")
        if handoff.model_id:
            raise AdapterUnavailableError(
                handoff.model_id, "decode-side engine built without "
                "adapter support (adapters are ROADMAP Queue 1 item 11)")
        sampling = sampling or SamplingParams()
        with self._lock:
            rid = self._next_rid
            self._next_rid += 1
            req = Request(rid=rid, prompt=context,
                          max_new_tokens=max_new_tokens + 1,
                          sampling=sampling, eos_token=eos_token,
                          ttft_deadline_s=None,
                          deadline_s=(self.deadline if deadline_s is None
                                      else deadline_s or None),
                          chain_hashes=list(handoff.chain_hashes),
                          import_payload=handoff,
                          spec_k=self._resolve_spec_k(sampling),
                          trace=trace_mod.TraceContext.from_wire(
                              handoff.trace))
            self.scheduler.submit(req)    # validates; may raise
            self._requests[rid] = req
            depth = len(self.scheduler.waiting)
        if self.telemetry.enabled:
            self.telemetry.record_queue_depth(depth)
        return rid

    def load_adapter(self, model_id: str, adapter, **kw):
        raise AdapterUnavailableError(
            model_id, "engine built without adapter support (adapters "
            "are ROADMAP Queue 1 item 11)")

    def set_params(self, params, *, version: Optional[int] = None) -> int:
        """Swap in a new parameter snapshot (tensors or numpy leaves, same
        tree and dtype) between ticks; returns the new version.  The
        prefix cache is flushed and the host pool dropped: their pages
        hold K/V of the old weights, and the index is keyed by tokens
        alone.  The store's entries carry the old version in their key
        and never match again."""
        self.scheduler.flush_prefix()
        if self.host_pool is not None:
            self.host_pool.clear()
        self.params = _params_to(params, self.device, self.cfg.dtype)
        self.param_version = (self.param_version + 1 if version is None
                              else int(version))
        return self.param_version

    def has_work(self) -> bool:
        with self._lock:
            return self.scheduler.has_work

    def prefix_digest(self) -> frozenset:
        """The registered prefix chain hashes: a prompt whose chained
        page hashes appear here would hit this engine's cache."""
        with self._lock:
            return self.scheduler.prefix_digest()

    def stats(self) -> Dict[str, Any]:
        return {
            "calls": dict(self.call_counts),
            "seconds": dict(self.seconds),
            "free_slots": len(self.scheduler.free_slots),
            "free_pages": self.scheduler.allocator.free_count,
            "waiting": len(self.scheduler.waiting),
            "active": len(self.scheduler.active),
            "cache_bytes": self.cache.bytes,
            "kv_dtype": self.kv_dtype,
            "kv_bytes_per_slot": self.cache.bytes_per_slot(
                self.max_pages_per_slot),
            "max_queue": self.max_queue,
            "param_version": self.param_version,
            "prefix": self.scheduler.prefix_stats(),
            "deadline_exceeded": self.deadline_exceeded,
            "ticks": self.ticks,
            # disaggregated handoffs served, and retired requests whose
            # pages still wait for export
            "exports": self.exports,
            "imports": self.imports,
            "held": len(self._held),
            # cumulative draft accounting and the live drafter states (a
            # drained engine reads drafts == 0)
            "spec": {
                "proposed": self.spec_proposed,
                "accepted": self.spec_accepted,
                "accept_rate": (self.spec_accepted / self.spec_proposed
                                if self.spec_proposed else 0.0),
                "k_hist": dict(sorted(self.spec_k_hist.items())),
                "drafts": len(self._drafts),
            },
            # prefix hits per tier, and the demote/promote legs' bytes,
            # seconds and faults
            "tiers": {
                "enabled": self.tiered,
                "hits": dict(self.tier_hits),
                "spill_dtype": self.spill_dtype,
                "spill_bytes": self.spill_bytes,
                "spill_faults": self.spill_faults,
                "fetches": self.fetches,
                "fetch_seconds": self.fetch_seconds,
                "fetch_faults": self.fetch_faults,
                "host": (self.host_pool.stats()
                         if self.host_pool is not None else None),
                "store": (self.store.stats()
                          if self.store is not None else None),
            },
        }

    def leak_free(self) -> bool:
        """Page and tier audit: the usable pages partition exactly into
        free, idle (registered, refcount 0) and held; each held page's
        refcount is the number of active or export-held requests that
        hold it; the host pool is within its capacity and holds no hash
        that is also resident (a demoted entry lives in exactly one
        local tier); and no store fetch is in flight."""
        alloc = self.scheduler.allocator
        holders = list(self.scheduler.active.values()) + \
            list(self._held.values())
        held = collections.Counter(p for r in holders for p in r.pages)
        if not alloc.leak_free() or dict(held) != alloc._refcount:
            return False
        if self.host_pool is not None:
            if len(self.host_pool) > self.host_pool.capacity:
                return False
            if self.scheduler.prefix_index is not None:
                resident = {(h, self.param_version) for h in
                            self.scheduler.prefix_index.digest()}
                if resident & set(self.host_pool._entries):
                    return False
        return self.store is None or self.store.in_flight == 0

    # ------------------------------------------------------ engine tick
    @torch.inference_mode()
    def step(self) -> List[StepEvent]:
        """One engine tick -> [(rid, token, done), ...] events."""
        events: List[StepEvent] = []
        self._process_cancels()
        self._expire_deadlines(events)
        while True:
            with self._lock:
                req = self.scheduler.try_admit()
            if req is None:
                break
            if req.import_payload is not None:
                self._install_import(req, events)
                continue
            if req.n_hit_pages:
                self.tier_hits["hbm"] += req.n_hit_pages
                if self.telemetry.enabled:
                    self.telemetry.record_prefix_hits(req.n_hit_pages,
                                                      tier="hbm")
            if req.tier_plan:
                self._install_tier_hits(req)
            self._prefill(req, events)
        if self.scheduler.active:
            # speculating slots leave the decode batch for this tick
            # (their verify is their decode); a tick where every slot
            # speculates makes no decode dispatch
            plan = self._plan_speculation()
            if len(plan) < len(self.scheduler.active):
                self._decode(events, skip=set(plan))
            for slot, drafts in plan.items():
                self._verify(slot, drafts, events)
        self.ticks += 1
        self.last_tick_ts = time.monotonic()
        if self.store is not None:
            ev = self.store.evictions
            if ev > self._store_evictions_seen:
                self.telemetry.record_kv_store_evictions(
                    ev - self._store_evictions_seen)
                self._store_evictions_seen = ev
        if self.tiered and self.telemetry.enabled:
            self.telemetry.record_tier_occupancy(
                hbm=len(self.scheduler.prefix_index or ()),
                dram=len(self.host_pool),
                store=len(self.store) if self.store else 0)
        return events

    def generate(self, prompts, max_new_tokens: int = 16,
                 sampling: Optional[SamplingParams] = None,
                 eos_token: Optional[int] = None,
                 return_logprobs: bool = False,
                 ttft_deadline_s: Optional[float] = None,
                 deadline_s: Optional[float] = None
                 ) -> Union[List[List[int]],
                            Tuple[List[List[int]], List[List[float]]]]:
        """Run a batch of prompts to completion (ordered results).  A
        deadline expiry raises its :class:`DeadlineExceededError` after
        the other requests are cancelled."""
        rids = [self.submit(p, max_new_tokens, sampling, eos_token,
                            ttft_deadline_s=ttft_deadline_s,
                            deadline_s=deadline_s)
                for p in prompts]
        out: Dict[int, List[int]] = {r: [] for r in rids}
        lps: Dict[int, List[float]] = {r: [] for r in rids}
        err: Optional[BaseException] = None
        while err is None and self.has_work():
            for ev in self.step():
                rid, tok, _done = ev
                if ev.error is not None:
                    if err is None and rid in out:
                        err = ev.error
                    continue
                if rid in out:
                    out[rid].append(tok)
                    lps[rid].append(ev.logprob)
        if err is not None:
            for r in rids:
                self.cancel(r)
            self._process_cancels()
            raise err
        if return_logprobs:
            return ([out[r] for r in rids], [lps[r] for r in rids])
        return [out[r] for r in rids]

    # ---------------------------------------------------------- prefill
    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(f"no prefill bucket fits length {n}")

    def _prefill(self, req: Request, events) -> None:
        """Cold (the whole prompt) or cached (only the suffix past the
        prefix hits), then the first token, then the prompt's full pages
        are registered: their K/V are in the cache from here on."""
        sched = self.scheduler
        slot = req.slot
        plen = len(req.prompt)
        cached = req.cached_tokens
        fill = req.prompt[cached:]
        bucket = self._bucket_for(len(fill))
        tokens = torch.zeros((1, bucket), dtype=torch.int64)
        tokens[0, :len(fill)] = torch.tensor(fill, dtype=torch.int64)
        kind = "prefill_cached" if cached else "prefill"
        t0 = time.monotonic()
        with tracing.span(f"infer/{kind}", rid=req.rid, bucket=bucket,
                          cached=cached):
            sampling = self._sampling_inputs([req])
            page_row = torch.from_numpy(sched.page_table[slot]).to(
                self.device)
            if cached:
                kvc.assert_tail_private(sched.allocator,
                                        sched.prefix_index, req.pages,
                                        cached, plen - 1, self.page_size)
                logits = self._prefill_cached_step(
                    tokens.to(self.device), cached, len(fill), page_row)
            else:
                logits = self._prefill_step(tokens.to(self.device), plen,
                                            page_row)
            toks, logps = self._sample(logits, sampling)
        now = time.monotonic()
        self.seconds[kind] += now - t0
        self.call_counts[kind] += 1
        self._register_prefix(req)
        if self.debug_logits:
            self.logits_trace.setdefault(req.rid, []).append(
                logits[0].cpu().numpy())
        sched.lengths[slot] = plen
        tr = req.trace
        if tr is not None and tr.sampled:
            trace_mod.record_span(
                "queue", tr, start=trace_mod.epoch_of(req.submitted_ts),
                dur=req.admitted_ts - req.submitted_ts, rid=req.rid,
                replica=self.trace_label)
            trace_mod.record_span(
                "prefill", tr, start=trace_mod.epoch_of(t0),
                dur=now - t0, rid=req.rid, bucket=bucket,
                cached=cached, kind=kind, replica=self.trace_label)
            trace_mod.event("first_token", tr, rid=req.rid,
                            ttft_s=now - req.submitted_ts,
                            replica=self.trace_label)
        if self.telemetry.enabled:
            self.telemetry.record_queue(
                req.admitted_ts - req.submitted_ts,
                depth=len(sched.waiting))
            self.telemetry.record_prefill(now - t0, prompt_tokens=plen,
                                          bucket=bucket,
                                          cached_tokens=cached)
            self.telemetry.record_ttft(
                now - req.submitted_ts, prefix_hit=cached > 0,
                trace_id=tr.trace_id if tr is not None else None)
        self._deliver(req, toks[0], logps[0], events)

    def _install_import(self, req: Request, events) -> None:
        """Seed an admitted import's slot from its handoff, with no
        forward: resident pages are already hits, missing pages are
        written from the payload, and the next decode step takes the
        slot up at the context's length with the handoff's token as
        input."""
        handoff = req.import_payload
        sched = self.scheduler
        slot = req.slot
        t0 = time.monotonic()
        n_ctx = len(req.prompt)
        n_pages = kvc.pages_needed(n_ctx, self.page_size)
        present = handoff.page_list
        needed = list(range(req.n_hit_pages, n_pages))
        missing = [i for i in needed if i not in present]
        if missing:
            # a stripped handoff whose resident pages were evicted between
            # the sender's digest check and this admission: release
            # everything and surface the typed re-prefill signal, never
            # decode over pages nobody wrote
            sched.retire(slot)
            req.error = kvc.HandoffContentMissing(req.rid, len(missing))
            self._requests.pop(req.rid, None)
            events.append(StepEvent(req.rid, -1, True, 0.0,
                                    error=req.error))
            return
        if needed:
            # the pages written are this request's alone (fresh,
            # unregistered), never a shared or the garbage page
            kvc.assert_tail_private(sched.allocator, sched.prefix_index,
                                    req.pages, req.n_hit_pages
                                    * self.page_size, n_ctx - 1,
                                    self.page_size)
            kvc.import_pages(self.cache, [req.pages[i] for i in needed],
                             handoff, [present.index(i) for i in needed])
        # the contents are in the cache: the imported full pages are
        # immutable from here on and registrable
        self._register_prefix(req)
        sched.lengths[slot] = n_ctx
        req.generated = [int(handoff.next_token)]
        req.logprobs = [float(handoff.next_logprob)]
        req.cached_tokens = n_ctx
        req.import_payload = None      # drop the content reference
        self.imports += 1
        if req.trace is not None and req.trace.sampled:
            trace_mod.record_span(
                "handoff.install", req.trace,
                start=trace_mod.epoch_of(t0),
                dur=time.monotonic() - t0, rid=req.rid,
                pages_written=len(needed), hit_pages=req.n_hit_pages,
                replica=self.trace_label)

    # ------------------------------------------------------ tiered cache
    def _register_prefix(self, req: Request) -> None:
        """Register the request's freshly written full pages, then drop
        those hashes from the host pool (a degraded fetch left the page
        to the prefill): no hash may sit in two local tiers."""
        self.scheduler.register_prefix(req)
        if self.host_pool is not None and req.chain_hashes:
            for h in req.chain_hashes[req.n_hit_pages:]:
                self.host_pool.discard((h, self.param_version))

    def _tier_probe(self, chain_hash: bytes) -> bool:
        """Whether a lower tier holds this hash under the live params
        (the scheduler's ``tier_lookup``; advisory, the install resolves
        each page again)."""
        key = (chain_hash, self.param_version)
        if self.host_pool is not None and key in self.host_pool:
            return True
        return self.store is not None and key in self.store

    def _spill_page(self, page: int, chain_hash: bytes) -> None:
        """The demote leg (the allocator's ``spill_hook``, called as
        pressure reclaims a registered idle page, before anything
        overwrites it): one gather on the card, encoded in the spill
        dtype there, one synchronous copy to the host, keyed by (chain
        hash, param version).  An injected ``kv.spill`` fault forgets the
        page instead; a later request re-prefills it."""
        try:
            chaos.maybe_fail("kv.spill")
        except chaos.InjectedFault:
            self.spill_faults += 1
            return
        entry = kvc.encode_spill_page(
            kvc.page_contents(self.cache, [page]),
            quantized=self.cache.quantized, spill_dtype=self.spill_dtype)
        nb = kvc.spill_entry_bytes(entry)
        self.spill_bytes += nb
        self.host_pool.put((chain_hash, self.param_version), entry)
        if self.telemetry.enabled:
            self.telemetry.record_kv_spill(nb)

    def _install_tier_hits(self, req: Request) -> None:
        """Promote the admission plan's lower-tier pages into the
        request's fresh pages, front to back, before its prefill.  The
        first failure (an injected ``kv.fetch`` fault, a plan gone stale,
        an entry of another geometry) stops the walk and the suffix
        prefill covers the rest, so a fault costs compute, never
        correctness.  Each installed page registers at once and counts
        as a prefix hit (``note_tier_hits``)."""
        sched = self.scheduler
        installed = 0
        for i in range(req.n_hit_pages, req.n_hit_pages + req.tier_plan):
            key = (req.chain_hashes[i], self.param_version)
            t0 = time.monotonic()
            try:
                chaos.maybe_fail("kv.fetch")
            except chaos.InjectedFault:
                self.fetch_faults += 1
                break
            tier = "dram"
            entry = (self.host_pool.take(key)
                     if self.host_pool is not None else None)
            checked_out = False
            if entry is None and self.store is not None:
                entry = self.store.checkout(key)
                checked_out = entry is not None
                tier = "store"
            if entry is None:
                break           # the plan went stale: prefill
            try:
                if not kvc.spill_entry_matches(self.cache, entry):
                    break       # another geometry reads as a miss
                kvc.install_spill_page(self.cache, req.pages[i], entry)
            finally:
                if checked_out:
                    self.store.checkin(key)
            if sched.prefix_index is not None:
                sched.prefix_index.register(req.chain_hashes[i],
                                            req.pages[i])
            wall = time.monotonic() - t0
            self.tier_hits[tier] += 1
            self.fetches += 1
            self.fetch_seconds += wall
            if req.trace is not None and req.trace.sampled:
                trace_mod.record_span(
                    "tier_fetch", req.trace,
                    start=trace_mod.epoch_of(t0), dur=wall,
                    rid=req.rid, tier=tier, page_index=i,
                    replica=self.trace_label)
            if self.telemetry.enabled:
                self.telemetry.record_kv_fetch(wall, tier=tier)
                self.telemetry.record_prefix_hits(1, tier=tier)
            installed += 1
        req.tier_plan = 0
        sched.note_tier_hits(req, installed)

    def _quantize_kv(self, kv):
        """[..., H, D] post-RoPE K or V -> (int8 codes, [..., H] f32
        scales): one scale per head_dim vector, rounded to nearest."""
        q, s = quantize_block(kv, block=self.cfg.head_dim, axis=-1)
        return q, s[..., 0]

    def _cache_entries(self, k, v):
        """K/V [..., H, D] as the cache stores them, in the order of
        ``KVCache.layer``: ``(k, v)``, or the int8 codes and scales."""
        if not self.cache.quantized:
            return (k, v)
        (kq, ks), (vq, vs) = self._quantize_kv(k), self._quantize_kv(v)
        return (kq, vq, ks, vs)

    def _write_prompt(self, cache, k, v, page_row, start: int,
                      valid_len: int) -> None:
        """Write a prompt's (or suffix's) K/V [S, H, D] at positions
        ``start..`` of one slot's pages."""
        for page, new in zip(cache, self._cache_entries(k, v)):
            kvc.write_prefill_at(page, new, page_row, start, valid_len,
                                 self.page_size)

    def _prefill_attention(self, q, k, v, cache, *, page_row):
        """Write the rotated prompt K/V into the slot's pages, then
        attend causally over the bucket.  The prompt is the whole
        context, so nothing is read back from the cache, and attention
        reads the full-precision K/V even when the cache is int8."""
        self._write_prompt(cache, k[0], v[0], page_row, 0, k.shape[1])
        return flash_attention(q, k, v, causal=True), cache

    def _prefill_step(self, tokens, length: int, page_row):
        """(tokens [1, bucket], valid length, page_row [max_pages]) ->
        the last valid token's logits [1, V] f32."""
        cfg = self.cfg
        positions = torch.arange(tokens.shape[1], device=self.device)
        hook = functools.partial(self._prefill_attention, page_row=page_row)
        x = self._run_layers(self._embed(tokens), positions, hook)
        h = x[0, length - 1][None]                        # [1, d]
        return torch.matmul(h, gpt_mod.lm_head(self.params, cfg)).float()

    def _cached_prefill_attention(self, q, k, v, cache, *, page_row,
                                  cached: int, suffix_len: int):
        """Write the suffix K/V at ``cached..``, then attend over the
        slot's first ``cached`` positions (read back from its pages,
        dequantized when int8) and the suffix's own full-precision K/V.
        Only the ``ceil(cached / page)`` pages that hold context are
        gathered."""
        self._write_prompt(cache, k[0], v[0], page_row, cached, suffix_len)
        row = page_row[None, :kvc.pages_needed(cached, self.page_size)]
        kctx = kvc.gather_pages(cache[0], row)
        vctx = kvc.gather_pages(cache[1], row)
        if self.cache.quantized:
            kctx = (kctx.float() * kvc.gather_pages(cache[2], row)[..., None]
                    ).to(q.dtype)
            vctx = (vctx.float() * kvc.gather_pages(cache[3], row)[..., None]
                    ).to(q.dtype)
        return _cached_context_attention(q, kctx, vctx, k, v, cached), cache

    def _cached_layers(self, tokens, cached: int, suffix_len: int,
                       page_row):
        """The layer stack over a suffix at positions ``cached..`` of one
        slot, its context read back from the cache -> the final hidden
        states [1, S, d]."""
        positions = cached + torch.arange(tokens.shape[1],
                                          device=self.device)
        hook = functools.partial(
            self._cached_prefill_attention, page_row=page_row,
            cached=cached, suffix_len=suffix_len)
        return self._run_layers(self._embed(tokens), positions, hook)

    def _prefill_cached_step(self, tokens, cached: int, suffix_len: int,
                             page_row):
        """(suffix tokens [1, bucket], cached prefix length, valid suffix
        length, page_row) -> the last suffix token's logits [1, V] f32."""
        x = self._cached_layers(tokens, cached, suffix_len, page_row)
        h = x[0, suffix_len - 1][None]
        return torch.matmul(h, gpt_mod.lm_head(self.params,
                                                self.cfg)).float()

    # ----------------------------------------------------------- decode
    def _decode(self, events, skip: Optional[Set[int]] = None) -> None:
        """One batched decode over every slot.  The slots in ``skip``
        speculate this tick: they ride the fixed-shape batch as dead
        rows, their page-table rows masked to the garbage page (on a
        copy of the table) so the batch's K/V write cannot touch the
        positions their verify is about to fill; their lengths do not
        advance and their outputs are never delivered.  The
        ``infer.decode`` chaos site fires first, before anything is
        launched or changed, so an injected fault leaves the cache and
        the scheduler as they were and the engine drainable."""
        chaos.maybe_fail("infer.decode")
        skip = skip or set()
        sched = self.scheduler
        tokens = np.zeros((self.slots,), np.int64)
        reqs: List[Optional[Request]] = [None] * self.slots
        for slot, req in sched.active.items():
            if slot not in skip:
                tokens[slot] = req.generated[-1]
                reqs[slot] = req
        page_table = sched.page_table
        if skip:
            page_table = page_table.copy()
            page_table[list(skip), :] = kvc.GARBAGE_PAGE
        active = [r for r in reqs if r is not None]
        t0 = time.monotonic()
        with tracing.span("infer/decode", active=len(active)):
            sampling = self._sampling_inputs(reqs)
            logits = self._decode_step(
                torch.from_numpy(tokens).to(self.device),
                torch.from_numpy(sched.lengths).to(self.device),
                torch.from_numpy(page_table).to(self.device))
            sampled, logps = self._sample(logits, sampling)
        wall = time.monotonic() - t0
        self.seconds["decode"] += wall
        self.call_counts["decode"] += 1
        traced = [r.trace.trace_id for r in active
                  if r.trace is not None and r.trace.sampled]
        if traced:
            # one global span per tick listing the traces it served: a
            # span per (tick, request) would swamp the ring
            trace_mod.record_span(
                "decode_tick", None, start=trace_mod.epoch_of(t0),
                dur=wall, active=len(active), trace_ids=traced,
                replica=self.trace_label)
        if self.telemetry.enabled:
            self.telemetry.record_decode(wall, active=len(active))
        host_logits = logits.cpu().numpy() if self.debug_logits else None
        for slot in list(sched.active):
            if slot in skip:
                continue
            req = sched.active[slot]
            sched.lengths[slot] += 1     # the input token is now cached
            if host_logits is not None:
                self.logits_trace.setdefault(req.rid, []).append(
                    host_logits[slot])
            self._deliver(req, sampled[slot], logps[slot], events)

    def _decode_attention(self, q, k, v, cache, *, page_table, table32,
                          lengths, ctx_lengths):
        """Write each slot's new K/V at its length, then attend over each
        slot's pages up to its length, read in place through the page
        table (int8 codes and their scales when the cache is int8)."""
        for page, new in zip(cache, self._cache_entries(k[:, 0], v[:, 0])):
            kvc.write_decode(page, new, page_table, lengths, self.page_size)
        scales = (dict(k_scale_pages=cache[2], v_scale_pages=cache[3])
                  if self.cache.quantized else {})
        o = decode_attention_paged(q[:, 0], cache[0], cache[1], table32,
                                   ctx_lengths, **scales)
        return o[:, None], cache

    def _decode_step(self, tokens, lengths, page_table):
        """(tokens [slots], lengths [slots] = the new token's position,
        page_table [slots, max_pages]) -> logits [slots, V] f32."""
        hook = functools.partial(
            self._decode_attention, page_table=page_table,
            table32=page_table.to(torch.int32), lengths=lengths,
            ctx_lengths=(lengths + 1).to(torch.int32))
        x = self._run_layers(self._embed(tokens[:, None]),
                             lengths[:, None], hook)
        logits = torch.matmul(x, gpt_mod.lm_head(self.params, self.cfg))
        return logits[:, 0].float()

    # ------------------------------------------------------ speculation
    def _plan_speculation(self) -> Dict[int, List[int]]:
        """slot -> this tick's drafted tokens (empty = plain decode for
        every slot).  A slot speculates when its request opted in
        (``spec_k > 0``) and its drafter finds a match in the request's
        own tokens.  The budget is clipped to the tokens left to
        generate, so the verify's writes stay inside the pages reserved
        at admission (the last written position is ``len(prompt) +
        max_new_tokens - 1``)."""
        plan: Dict[int, List[int]] = {}
        for slot, req in self.scheduler.active.items():
            k = min(req.spec_k, req.max_new_tokens - len(req.generated))
            if k < 1:
                continue
            ds = self._drafts.get(req.rid)
            if ds is None:
                ds = self._drafts[req.rid] = DraftState(req.prompt)
            ds.sync(req.prompt, req.generated)
            drafts = ds.propose(k)
            if drafts:
                plan[slot] = drafts
        return plan

    @staticmethod
    def _verify_bucket(n_drafts: int) -> int:
        """The power of two at or above ``n_drafts``: a verify runs
        ``bucket + 1`` rows, as the JAX engine's per-bucket executables
        do, so its shapes (N = 2, 3, 5 or 9 rows through the epilogue
        kernel at k <= 8) are the reference's, and a captured step would
        need one graph per bucket."""
        kb = 1
        while kb < n_drafts:
            kb *= 2
        return kb

    def _verify(self, slot: int, drafts: List[int], events) -> None:
        """Score ``[last_token, d1..dk, pad]`` in one all-rows forward
        at the slot's length ``L``, sample every row with the request's
        own noise, and emit the accepted drafts plus one more real token
        (``sampling.accept_drafts``).  The length advances over emitted
        tokens only: the rejected tail stays behind the length mask,
        which is the rollback."""
        sched = self.scheduler
        req = sched.active[slot]
        L = int(sched.lengths[slot])
        n_drafts = len(drafts)
        kb = self._verify_bucket(n_drafts)
        # the verify writes positions L .. L + n_drafts: all past every
        # shared or registered page (those are full prompt pages before
        # the first decode position), so a rollback corrupts no page
        # another request reads
        kvc.assert_tail_private(sched.allocator, sched.prefix_index,
                                req.pages, L, L + n_drafts, self.page_size)
        tokens = torch.zeros((1, kb + 1), dtype=torch.int64)
        tokens[0, :n_drafts + 1] = torch.tensor(
            [req.generated[-1]] + list(drafts), dtype=torch.int64)
        t0 = time.monotonic()
        with tracing.span("infer/verify", rid=req.rid, k=n_drafts):
            # row i lands when the request has len(generated) + i
            # tokens: the (seed, count) plain decode would sample that
            # position with
            c = len(req.generated)
            sampling = self._sampling_rows(
                [(req.sampling, c + i) for i in range(n_drafts + 1)])
            page_row = torch.from_numpy(sched.page_table[slot]).to(
                self.device)
            logits = self._verify_step(tokens.to(self.device), L,
                                       n_drafts + 1, page_row)
            toks, logps = self._sample(logits[:n_drafts + 1], sampling)
        wall = time.monotonic() - t0
        self.seconds["verify"] += wall
        self.call_counts["verify"] += 1
        m, emitted = accept_drafts(toks, drafts)
        self.spec_proposed += n_drafts
        self.spec_accepted += m
        self.spec_k_hist[m] = self.spec_k_hist.get(m, 0) + 1
        if req.trace is not None and req.trace.sampled:
            trace_mod.record_span(
                "verify", req.trace, start=trace_mod.epoch_of(t0),
                dur=wall, rid=req.rid, proposed=n_drafts, accepted=m,
                replica=self.trace_label)
        host_logits = logits.cpu().numpy() if self.debug_logits else None
        delivered = 0
        for i, tok in enumerate(emitted):
            # row i's input token (last_token or draft i) is now cached
            # at L + i; a retire inside the block (EOS, max_new_tokens)
            # resets the slot anyway
            sched.lengths[slot] = L + i + 1
            if host_logits is not None:
                self.logits_trace.setdefault(req.rid, []).append(
                    host_logits[i])
            self._deliver(req, tok, logps[i], events)
            delivered += 1
            if req.done:
                break
        if self.telemetry.enabled:
            self.telemetry.record_verify(wall, proposed=n_drafts,
                                         accepted=m, emitted=delivered)

    def _verify_step(self, tokens, cached: int, n_rows: int, page_row):
        """The verify forward: the cached-context prefill in all-rows
        mode.  (tokens [1, kb + 1] = [last_token, drafts, pad], the
        slot's length ``cached``, valid rows ``n_rows``, page_row) ->
        logits [kb + 1, V] f32, row i scoring the token after input i.
        Its N = kb + 1 rows go through the fused out-proj epilogue like
        any prefill's; the head runs over every row."""
        x = self._cached_layers(tokens, cached, n_rows, page_row)
        return torch.matmul(x[0], gpt_mod.lm_head(self.params,
                                                   self.cfg)).float()

    # ------------------------------------------------------------ shared
    def _embed(self, tokens):
        return gpt_mod.embed_tokens(self.params, tokens, self.cfg)

    def _run_layers(self, x, positions, attn_hook):
        """The layer stack with each layer's cache slice handed to the
        attention hook, then the final norm."""
        cfg = self.cfg
        for i in range(cfg.n_layers):
            x, _aux, _cache = gpt_mod.layer_apply(
                gpt_mod.layer_params(self.params, i), x, cfg,
                positions=positions, attn_fn=attn_hook,
                cache=self.cache.layer(i))
        return gpt_mod._norm(x, self.params["ln_f"], cfg.norm,
                             eps=gpt_mod.norm_eps(cfg))

    def _deliver(self, req: Request, tok: int, logp: float,
                 events) -> None:
        req.generated.append(tok)
        req.logprobs.append(logp)
        done = (len(req.generated) >= req.max_new_tokens
                or (req.eos_token is not None and tok == req.eos_token))
        if done:
            if req.hold_pages:
                # the slot frees, the pages wait for export_request or
                # release_held
                self.scheduler.retire_hold(req.slot)
                self._held[req.rid] = req
            else:
                self.scheduler.retire(req.slot)
            if self.telemetry.enabled:
                self.telemetry.record_request_done()
            self._drafts.pop(req.rid, None)
            if not self.debug_logits:
                # finished requests must not accumulate (debug engines
                # keep them so parity tests can read trajectories)
                self._requests.pop(req.rid, None)
        events.append(StepEvent(req.rid, tok, done, logp))

    def _sampling_inputs(self, reqs: List[Optional[Request]]):
        """The sampler's inputs for one row per request, each at its
        generation count (None rows are inactive; their result is
        discarded)."""
        null = SamplingParams()
        return self._sampling_rows([
            (r.sampling, len(r.generated)) if r is not None else (null, 0)
            for r in reqs])

    def _sampling_rows(self, rows: List[Tuple[SamplingParams, int]]):
        """The sampler's per-row inputs on the device from ``(sampling
        params, count)`` rows.  Built before the forward is queued: a
        host-to-device copy waits for the stream to drain."""
        host = np.array([[s.seed, c, s.top_k] for s, c in rows], np.int64)
        hostf = np.array([[s.temperature, s.top_p] for s, _c in rows],
                         np.float32)
        ints = torch.from_numpy(host).to(self.device)
        floats = torch.from_numpy(hostf).to(self.device)
        return ints[:, 0], ints[:, 1], floats[:, 0], ints[:, 2], floats[:, 1]

    def _sample(self, logits, sampling) -> Tuple[List[int], List[float]]:
        """One token per logits row -> (tokens, model logprobs) on the
        host."""
        toks, logps = sample_tokens_logprobs(logits, *sampling)
        return toks.tolist(), logps.tolist()
