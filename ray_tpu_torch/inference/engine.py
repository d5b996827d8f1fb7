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
- **Decode** runs all ``slots`` rows at once: each slot's token K/V is
  written at its length, the slot contexts are gathered from the pages,
  and the decode-attention kernel attends over each context up to its
  length.  Inactive slots ride along writing into the garbage page.
- **Sampling** is ``inference/sampling.py``, row-independent.

PyTorch runs eagerly, so there is nothing to compile: per-kind call
counters (``call_counts``) and wall seconds (``seconds``) take the place
of the JAX engine's compile counters.  CUDA-graph capture of the steps
is later work.

Not ported yet; each raises ``NotImplementedError`` where the JAX engine
accepts it: prefix caching, the int8 KV cache, speculative decoding,
LoRA adapter banks, the tiered cache, disaggregated export/import,
telemetry and deadlines.  The engine runs on the card unless the caller
passes ``device="cpu"``; without a card it raises.
"""

from __future__ import annotations

import functools
import threading
import time
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ray_tpu_torch.convert import array_to_tensor
from ray_tpu_torch.inference import kv_cache as kvc
from ray_tpu_torch.inference.config import default_buckets, infer_config
from ray_tpu_torch.inference.sampling import (SamplingParams,
                                              sample_tokens_logprobs)
from ray_tpu_torch.inference.scheduler import Request, SlotScheduler
from ray_tpu_torch.models import gpt as gpt_mod
from ray_tpu_torch.ops.attention import decode_attention, flash_attention
from ray_tpu_torch.ops.substrate import resolve_device


def _unported(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported yet (ROADMAP Queue 1: {item})")


class StepEvent(tuple):
    """One ``step()`` event: unpacks and compares as ``(rid, token,
    done)``, with the sampled token's model logprob as ``ev.logprob``
    and the failure channel as ``ev.error`` (None here: deadline
    retirement is not ported yet)."""

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
                 host_pages: Optional[int] = None,
                 lora=None,
                 telemetry: Optional[bool] = None,
                 ttft_deadline: Optional[float] = None,
                 deadline: Optional[float] = None,
                 debug_logits: bool = False):
        gpt_mod.check_supported(cfg)
        icfg = infer_config()
        if icfg.prefix if prefix is None else prefix:
            _unported("prefix caching", "prefix caching")
        if spec:
            _unported("speculative decoding", "speculative decoding")
        if host_pages:
            _unported("the tiered KV cache", "serve_gpt and the fleet")
        if lora:
            _unported("LoRA adapter banks", "adapters and RL")
        if telemetry or ttft_deadline or deadline:
            _unported("telemetry and deadlines", "serve_gpt and the fleet")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = _params_to(params, self.device, cfg.dtype)
        self.slots = slots if slots is not None else icfg.slots
        self.page_size = (page_size if page_size is not None
                          else icfg.page_size)
        self.max_queue = (icfg.max_queue if max_queue is None
                          else max_queue)
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
            max_queue=self.max_queue)
        self.cache = kvc.KVCache(
            n_layers=cfg.n_layers, num_pages=num_pages,
            page_size=self.page_size, n_heads=cfg.n_heads,
            head_dim=cfg.head_dim, dtype=cfg.dtype, device=self.device,
            kv_dtype=kv_dtype or "model")
        self.kv_dtype = self.cache.kv_dtype
        self.call_counts: Dict[str, int] = {"prefill": 0, "decode": 0}
        self.seconds: Dict[str, float] = {"prefill": 0.0, "decode": 0.0}
        self._requests: Dict[int, Request] = {}
        self._next_rid = 0
        self._cancelled: set = set()
        self._lock = threading.Lock()   # submit()/cancel() vs step()
        self.ticks = 0
        self.param_version = 0
        self.debug_logits = debug_logits
        self.logits_trace: Dict[int, List[np.ndarray]] = {}

    # --------------------------------------------------------- requests
    def submit(self, prompt, max_new_tokens: int = 16,
               sampling: Optional[SamplingParams] = None,
               eos_token: Optional[int] = None,
               ttft_deadline_s: Optional[float] = None,
               deadline_s: Optional[float] = None,
               hold_pages: bool = False, trace_ctx=None) -> int:
        """Enqueue one request and return its id."""
        if ttft_deadline_s or deadline_s:
            _unported("deadlines", "serve_gpt and the fleet")
        if hold_pages:
            _unported("disaggregated export", "serve_gpt and the fleet")
        if trace_ctx is not None:
            _unported("request tracing", "serve_gpt and the fleet")
        sampling = sampling or SamplingParams()
        if sampling.spec:
            _unported("speculative decoding", "speculative decoding")
        if sampling.model_id:
            _unported("LoRA adapters", "adapters and RL")
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
        with self._lock:
            rid = self._next_rid
            self._next_rid += 1
            req = Request(rid=rid, prompt=prompt,
                          max_new_tokens=max_new_tokens,
                          sampling=sampling, eos_token=eos_token)
            self.scheduler.submit(req)    # validates; may raise
            self._requests[rid] = req
        return rid

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
            for req in [r for r in sched.waiting if r.rid in cancelled]:
                sched.waiting.remove(req)
                req.done = True
                self._requests.pop(req.rid, None)

    def export_request(self, rid: int):
        _unported("disaggregated export", "serve_gpt and the fleet")

    def import_submit(self, handoff, **kw):
        _unported("disaggregated import", "serve_gpt and the fleet")

    def load_adapter(self, model_id: str, adapter, **kw):
        _unported("LoRA adapters", "adapters and RL")

    def set_params(self, params, *, version: Optional[int] = None) -> int:
        """Swap in a new parameter snapshot (tensors or numpy leaves, same
        tree and dtype) between ticks; returns the new version."""
        self.params = _params_to(params, self.device, self.cfg.dtype)
        self.param_version = (self.param_version + 1 if version is None
                              else int(version))
        return self.param_version

    def has_work(self) -> bool:
        with self._lock:
            return self.scheduler.has_work

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
            "ticks": self.ticks,
        }

    def leak_free(self) -> bool:
        """Page audit: the usable pages partition exactly into free and
        held, and the held pages are exactly the active requests'."""
        alloc = self.scheduler.allocator
        held = sorted(p for r in self.scheduler.active.values()
                      for p in r.pages)
        return alloc.leak_free() and held == sorted(alloc._refcount)

    # ------------------------------------------------------ engine tick
    @torch.inference_mode()
    def step(self) -> List[StepEvent]:
        """One engine tick -> [(rid, token, done), ...] events."""
        events: List[StepEvent] = []
        self._process_cancels()
        while True:
            with self._lock:
                req = self.scheduler.try_admit()
            if req is None:
                break
            self._prefill(req, events)
        if self.scheduler.active:
            self._decode(events)
        self.ticks += 1
        return events

    def generate(self, prompts, max_new_tokens: int = 16,
                 sampling: Optional[SamplingParams] = None,
                 eos_token: Optional[int] = None,
                 return_logprobs: bool = False
                 ) -> Union[List[List[int]],
                            Tuple[List[List[int]], List[List[float]]]]:
        """Run a batch of prompts to completion (ordered results)."""
        rids = [self.submit(p, max_new_tokens, sampling, eos_token)
                for p in prompts]
        out: Dict[int, List[int]] = {r: [] for r in rids}
        lps: Dict[int, List[float]] = {r: [] for r in rids}
        while self.has_work():
            for ev in self.step():
                rid, tok, _done = ev
                if rid in out:
                    out[rid].append(tok)
                    lps[rid].append(ev.logprob)
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
        sched = self.scheduler
        slot = req.slot
        plen = len(req.prompt)
        bucket = self._bucket_for(plen)
        tokens = torch.zeros((1, bucket), dtype=torch.int64)
        tokens[0, :plen] = torch.tensor(req.prompt, dtype=torch.int64)
        t0 = time.monotonic()
        sampling = self._sampling_inputs([req])
        logits = self._prefill_step(
            tokens.to(self.device), plen,
            torch.from_numpy(sched.page_table[slot]).to(self.device))
        toks, logps = self._sample(logits, sampling)
        self.seconds["prefill"] += time.monotonic() - t0
        self.call_counts["prefill"] += 1
        if self.debug_logits:
            self.logits_trace.setdefault(req.rid, []).append(
                logits[0].cpu().numpy())
        sched.lengths[slot] = plen
        self._deliver(req, toks[0], logps[0], events)

    def _prefill_attention(self, q, k, v, cache, *, page_row):
        """Write the rotated prompt K/V into the slot's pages, then
        attend causally over the bucket (the prompt is the whole
        context, so nothing is read back from the cache)."""
        ck, cv = cache
        kvc.write_prefill(ck, k[0], page_row, self.page_size)
        kvc.write_prefill(cv, v[0], page_row, self.page_size)
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

    # ----------------------------------------------------------- decode
    def _decode(self, events) -> None:
        sched = self.scheduler
        tokens = np.zeros((self.slots,), np.int64)
        reqs: List[Optional[Request]] = [None] * self.slots
        for slot, req in sched.active.items():
            tokens[slot] = req.generated[-1]
            reqs[slot] = req
        t0 = time.monotonic()
        sampling = self._sampling_inputs(reqs)
        logits = self._decode_step(
            torch.from_numpy(tokens).to(self.device),
            torch.from_numpy(sched.lengths).to(self.device),
            torch.from_numpy(sched.page_table).to(self.device))
        sampled, logps = self._sample(logits, sampling)
        self.seconds["decode"] += time.monotonic() - t0
        self.call_counts["decode"] += 1
        host_logits = logits.cpu().numpy() if self.debug_logits else None
        for slot in list(sched.active):
            req = sched.active[slot]
            sched.lengths[slot] += 1     # the input token is now cached
            if host_logits is not None:
                self.logits_trace.setdefault(req.rid, []).append(
                    host_logits[slot])
            self._deliver(req, sampled[slot], logps[slot], events)

    def _decode_attention(self, q, k, v, cache, *, page_table, lengths,
                          ctx_lengths):
        """Write each slot's new K/V at its length, gather the slot
        contexts and attend over each up to its length."""
        ck, cv = cache
        kvc.write_decode(ck, k[:, 0], page_table, lengths, self.page_size)
        kvc.write_decode(cv, v[:, 0], page_table, lengths, self.page_size)
        o = decode_attention(q[:, 0], kvc.gather_pages(ck, page_table),
                             kvc.gather_pages(cv, page_table), ctx_lengths)
        return o[:, None], cache

    def _decode_step(self, tokens, lengths, page_table):
        """(tokens [slots], lengths [slots] = the new token's position,
        page_table [slots, max_pages]) -> logits [slots, V] f32."""
        hook = functools.partial(
            self._decode_attention, page_table=page_table,
            lengths=lengths, ctx_lengths=(lengths + 1).to(torch.int32))
        x = self._run_layers(self._embed(tokens[:, None]),
                             lengths[:, None], hook)
        logits = torch.matmul(x, gpt_mod.lm_head(self.params, self.cfg))
        return logits[:, 0].float()

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
                cache=(self.cache.k[i], self.cache.v[i]))
        return gpt_mod._norm(x, self.params["ln_f"], cfg.norm,
                             eps=gpt_mod.norm_eps(cfg))

    def _deliver(self, req: Request, tok: int, logp: float,
                 events) -> None:
        req.generated.append(tok)
        req.logprobs.append(logp)
        done = (len(req.generated) >= req.max_new_tokens
                or (req.eos_token is not None and tok == req.eos_token))
        if done:
            self.scheduler.retire(req.slot)
            if not self.debug_logits:
                # finished requests must not accumulate (debug engines
                # keep them so parity tests can read trajectories)
                self._requests.pop(req.rid, None)
        events.append(StepEvent(req.rid, tok, done, logp))

    def _sampling_inputs(self, reqs: List[Optional[Request]]):
        """The sampler's per-row inputs on the device (None rows are
        inactive; their result is discarded).  Built before the forward
        is queued: a host-to-device copy waits for the stream to drain."""
        null = SamplingParams()
        rows = [r.sampling if r is not None else null for r in reqs]
        host = np.array([[s.seed, len(r.generated) if r is not None else 0,
                          s.top_k] for s, r in zip(rows, reqs)], np.int64)
        hostf = np.array([[s.temperature, s.top_p] for s in rows],
                         np.float32)
        ints = torch.from_numpy(host).to(self.device)
        floats = torch.from_numpy(hostf).to(self.device)
        return ints[:, 0], ints[:, 1], floats[:, 0], ints[:, 2], floats[:, 1]

    def _sample(self, logits, sampling) -> Tuple[List[int], List[float]]:
        """One token per logits row -> (tokens, model logprobs) on the
        host."""
        toks, logps = sample_tokens_logprobs(logits, *sampling)
        return toks.tolist(), logps.tolist()
