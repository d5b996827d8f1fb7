"""GPT serving: the inference engine behind a ``serve`` deployment.

Counterpart of ``ray_tpu/inference/serve_gpt.py``.  One replica owns one
:class:`~ray_tpu_torch.inference.engine.InferenceEngine` and a single
*pump* task that advances ``engine.step()`` in an executor thread (the
step blocks on its one synchronisation; the event loop must keep
accepting requests while it runs) and fans the ``(rid, token, done)``
events out to per-request asyncio queues.  Each handle request is an
async generator that drains its queue: tokens flow through
``ServeReplica.handle_request_streaming``, one object-ref slot per
token, and the handle-side ``DeploymentResponseGenerator`` yields them
as they land.  Continuous batching happens inside the engine: requests
arriving mid-stream join free decode slots without disturbing running
sequences.

The engine runs on the replica's card (``ray_actor_options={"num_gpus":
1}``).  A caller asks for the CPU with ``engine_config={"device":
"cpu"}``; with no such request and no card, building the engine raises.

Abandoned streams: closing the request's (replica-side) generator
cancels the sequence in the engine so its decode slot frees within a
tick.  A *handle* consumer that silently drops its
``DeploymentResponseGenerator`` does **not** close the replica-side
generator (the object-ref streaming protocol carries no
consumer-liveness signal), but the handle's credit window stops the
replica a window ahead of its reader, so the unread tokens wait in this
deployment's queue; the **idle-stream reaper**
(``RAY_TPU_INFER_STREAM_IDLE``, default off) covers that hole: a
request whose stream has tokens waiting but has not been pumped for
the budget is cancelled (slot, pages and prefix references released, a
typed :class:`StreamIdleError` left on the queue for any late reader)
instead of decoding to ``max_new_tokens`` for a reader that is gone.
A consumer merely *waiting* on a slow engine (empty queue) is never
reaped.

The fleet (:mod:`ray_tpu_torch.fleet`) imports :func:`parse_request`
and the two errors from here, so this module imports without a card.

Usage::

    import ray_tpu_torch, ray_tpu_torch.serve as serve
    from ray_tpu_torch.inference.serve_gpt import GPTDeployment

    ray_tpu_torch.init()
    handle = serve.run(GPTDeployment.options(
        ray_actor_options={"num_gpus": 1}).bind(model="gpt2"), name="gpt")
    stream = handle.options(stream=True).remote(
        {"tokens": [1, 2, 3], "max_new_tokens": 8})
    for token in stream:
        ...
"""

from __future__ import annotations

import asyncio
import time
from typing import Any, Dict, Optional

import ray_tpu_torch.serve as serve
from ray_tpu_torch.inference.sampling import SamplingParams

_PRESETS = ("tiny", "gpt2", "gpt2_medium", "gpt2_large")


class ReplicaDrainingError(RuntimeError):
    """Typed admission rejection while the replica drains: new
    requests must go to another replica (the router's retry signal);
    in-flight streams keep decoding to completion."""


class StreamIdleError(RuntimeError):
    """Typed cancellation of an abandoned stream: tokens sat unread
    past ``RAY_TPU_INFER_STREAM_IDLE``, so the request was retired
    (everything released).  A late consumer sees this instead of a
    silent hang on a queue nothing feeds anymore."""


def parse_request(request: Dict[str, Any]) -> Dict[str, Any]:
    """The one parser for the serving payload dict: the deployment and
    the fleet routers route requests through it, so a field added to
    the payload can never exist in one path and not the other."""
    spec = request.get("speculation")
    spec_k = request.get("speculation_k")
    return {
        "max_new_tokens": int(request.get("max_new_tokens", 16)),
        "sampling": SamplingParams(
            temperature=float(request.get("temperature", 0.0)),
            top_k=int(request.get("top_k", 0)),
            top_p=float(request.get("top_p", 1.0)),
            seed=int(request.get("seed", 0)),
            # absent = the engine's defaults (RAY_TPU_INFER_SPEC{,_K});
            # explicit values pin this request on or off
            spec=None if spec is None else bool(spec),
            spec_k=None if spec_k is None else int(spec_k),
            # the LoRA adapter the request decodes under; None = base
            model_id=request.get("model_id")),
        "want_logprobs": bool(request.get("logprobs", False)),
        "eos_token": request.get("eos_token"),
        "ttft_deadline_s": request.get("ttft_deadline_s"),
        "deadline_s": request.get("deadline_s"),
    }


def _build_engine(model: str, model_config: Optional[Dict[str, Any]],
                  engine_config: Optional[Dict[str, Any]], seed: int):
    """``GPTConfig.<model>(**model_config)`` with random weights drawn
    from a CPU generator seeded ``seed``, and the engine over them on
    ``engine_config["device"]`` (the card when absent).  The config's
    ``dtype`` may be a torch dtype or its name (``"bfloat16"``): a name
    keeps torch out of the serve controller, which unpickles the
    deployment's arguments on their way to the replica."""
    import torch

    from ray_tpu_torch.inference.engine import InferenceEngine
    from ray_tpu_torch.models.gpt import GPTConfig, init_params

    if model not in _PRESETS:
        raise ValueError(f"unknown model preset {model!r}; "
                         f"expected one of {_PRESETS}")
    model_config = dict(model_config or {})
    if isinstance(model_config.get("dtype"), str):
        model_config["dtype"] = getattr(torch, model_config["dtype"])
    cfg = getattr(GPTConfig, model)(**model_config)
    engine_config = dict(engine_config or {})
    params = init_params(cfg, torch.Generator().manual_seed(seed),
                         device=engine_config.get("device"))
    return cfg, InferenceEngine(cfg, params, **engine_config)


class GPTDeployment:
    """Streaming GPT deployment over the continuous-batching engine.

    ``model``: a ``GPTConfig`` preset name (random-init weights);
    ``model_config`` / ``engine_config``: kwargs forwarded to
    ``GPTConfig.<preset>()`` / :class:`InferenceEngine`
    (``engine_config={"device": "cpu"}`` runs it on the CPU).

    Request payload (one dict): ``{"tokens": [...], "max_new_tokens":
    int, "temperature": float, "top_k": int, "top_p": float, "seed":
    int, "eos_token": int | None, "logprobs": bool,
    "ttft_deadline_s": float | None, "deadline_s": float | None,
    "speculation": bool | None, "speculation_k": int | None,
    "model_id": str | None}``; yields generated token ids, or with
    ``"logprobs": True`` ``{"token": int, "logprob": float}`` items (the
    sampled token's ``log_softmax`` of the raw logits).  The deadline
    keys override ``RAY_TPU_INFER_TTFT_DEADLINE`` /
    ``RAY_TPU_INFER_DEADLINE`` per request; an expired request is
    retired and its stream raises
    :class:`~ray_tpu_torch.inference.scheduler.DeadlineExceededError`.

    **Load shedding**: with ``RAY_TPU_INFER_MAX_QUEUE`` set, an
    over-cap submit raises
    :class:`~ray_tpu_torch.inference.scheduler.QueueFullError` from the
    request's async generator, which the streaming path delivers as the
    stream's error at its first item.
    """

    def __init__(self, model: str = "tiny",
                 model_config: Optional[Dict[str, Any]] = None,
                 engine_config: Optional[Dict[str, Any]] = None,
                 seed: int = 0,
                 watchdog_s: Optional[float] = None,
                 stream_idle_s: Optional[float] = None):
        self.cfg, self.engine = _build_engine(model, model_config,
                                              engine_config, seed)
        self._queues: Dict[int, asyncio.Queue] = {}
        self._pump_task: Optional[asyncio.Task] = None
        self._draining = False
        from ray_tpu_torch.inference.config import infer_config
        icfg = infer_config()
        watchdog_s = (icfg.watchdog if watchdog_s is None
                      else watchdog_s)
        # idle-stream reaper: rid -> when the consumer last took an
        # item (or the request was submitted); swept by the pump
        self.stream_idle_s = (icfg.stream_idle if stream_idle_s is None
                              else stream_idle_s) or None
        self._last_pumped: Dict[int, float] = {}
        self.streams_reaped = 0
        self._watchdog = None
        if watchdog_s:
            from ray_tpu_torch.resilience.watchdog import EngineWatchdog
            self._watchdog = EngineWatchdog(
                self.engine, timeout_s=watchdog_s).start()

    async def __call__(self, request: Dict[str, Any]):
        if self._draining:
            raise ReplicaDrainingError(
                "replica is draining: admission stopped, in-flight "
                "requests finishing — retry on another replica")
        parsed = parse_request(request)
        want_logprobs = parsed["want_logprobs"]
        # a bare deployment request (no fleet router in front) mints its
        # own trace here, so the engine's spans land in the flight
        # recorder
        from ray_tpu_torch.telemetry import trace as trace_mod
        ctx = trace_mod.mint()
        root_id = trace_mod.record_span(
            "request", ctx, start=time.time(), dur=0.0,
            prompt_tokens=len(request["tokens"]),
            max_new=parsed["max_new_tokens"])
        trace_ctx = ctx.child(root_id) if root_id is not None else ctx
        rid = self.engine.submit(
            request["tokens"],
            max_new_tokens=parsed["max_new_tokens"],
            sampling=parsed["sampling"],
            eos_token=parsed["eos_token"],
            ttft_deadline_s=parsed["ttft_deadline_s"],
            deadline_s=parsed["deadline_s"],
            trace_ctx=trace_ctx)
        queue: asyncio.Queue = asyncio.Queue()
        self._queues[rid] = queue
        self._last_pumped[rid] = time.monotonic()
        self._ensure_pump()
        try:
            while True:
                item = await queue.get()
                # the consumer is live: it just took an item (one
                # waiting on an empty queue is told by the queue being
                # empty, not by this stamp)
                self._last_pumped[rid] = time.monotonic()
                if isinstance(item, BaseException):
                    raise item       # pump died: surface, don't hang
                token, done, logprob = item
                yield ({"token": token, "logprob": logprob}
                       if want_logprobs else token)
                if done:
                    return
        finally:
            self._queues.pop(rid, None)
            self._last_pumped.pop(rid, None)
            # abandoned mid-stream (client disconnect): retire the
            # sequence instead of decoding to max_new_tokens in a slot
            # nobody is reading (a no-op for normal completion)
            self.engine.cancel(rid)

    def _ensure_pump(self) -> None:
        if self._pump_task is None or self._pump_task.done():
            self._pump_task = asyncio.get_running_loop().create_task(
                self._pump())

    async def _pump(self) -> None:
        """Advance the engine while any request is in flight; the step
        runs in an executor thread so the event loop keeps admitting
        new requests mid-stream.  A step failure fans out to every
        waiting consumer: a hung stream is worse than a failed one."""
        loop = asyncio.get_running_loop()
        try:
            while True:
                await self._pump_engine(loop)
                if not (self.stream_idle_s and self._queues):
                    return
                # engine idle but unread streams remain (abandoned
                # consumers): keep the reaper alive until they drain
                # or age out, or their queues would persist on a
                # quiescent replica until new traffic revives the
                # pump.  New work re-enters the step loop above.
                self._reap_idle_streams()
                await asyncio.sleep(min(self.stream_idle_s / 4, 0.02))
        except BaseException as e:  # noqa: BLE001 — deliver, then die
            for queue in self._queues.values():
                queue.put_nowait(e)
            raise

    async def _pump_engine(self, loop) -> None:
        while self.engine.has_work():
            events = await loop.run_in_executor(None,
                                                self.engine.step)
            for ev in events:
                rid, token, done = ev
                queue = self._queues.get(rid)
                if queue is None:
                    continue
                if queue.qsize() == 0:
                    # empty -> nonempty: the idle clock measures how
                    # long tokens sit UNREAD, so it starts when the
                    # first unread token lands, not at the last
                    # consumer read (a consumer blocked in get()
                    # through a slow step would otherwise look idle
                    # the moment the token arrives)
                    self._last_pumped[rid] = time.monotonic()
                if ev.error is not None:
                    # deadline expiry: the engine already released the
                    # slot and pages; the typed error is the stream's
                    # failure
                    queue.put_nowait(ev.error)
                else:
                    queue.put_nowait((token, done, ev.logprob))
            self._reap_idle_streams()

    def _reap_idle_streams(self) -> None:
        """Cancel requests whose stream has tokens waiting but whose
        consumer has not taken one for ``stream_idle_s`` (a silently
        dropped generator).  An empty queue (a consumer blocked on a
        slow engine) never reaps; only unread tokens aging out do."""
        if self.stream_idle_s is None:
            return
        now = time.monotonic()
        for rid, queue in list(self._queues.items()):
            if queue.qsize() == 0:
                continue
            if now - self._last_pumped.get(rid, now) \
                    <= self.stream_idle_s:
                continue
            if rid in self.engine._requests:
                self.engine.cancel(rid)
                # a late reader must raise, not hang on a queue the
                # pump no longer feeds
                queue.put_nowait(StreamIdleError(
                    f"request {rid}: stream not pumped for "
                    f"{self.stream_idle_s:.3f}s with tokens waiting "
                    "(RAY_TPU_INFER_STREAM_IDLE) — request "
                    "cancelled, slot/pages released"))
                self.streams_reaped += 1
            # else: the engine already finished it — nothing held and
            # nothing to count; just stop tracking the unread queue (a
            # late reader still drains its buffered tokens to done)
            self._queues.pop(rid, None)
            self._last_pumped.pop(rid, None)

    # ------------------------------------------------------------ drain
    async def drain(self, poll_s: float = 0.05,
                    timeout_s: Optional[float] = None) -> Dict[str, Any]:
        """Graceful shutdown: stop admission (``__call__`` raises a
        typed :class:`ReplicaDrainingError` from now on), let every
        in-flight request decode to completion, then report.  The
        engine's own clean-idle invariants (no held slots or pages) are
        what "finished" means.

        ``timeout_s`` bounds the wait on a pump that is alive but not
        finishing (a wedged step, the watchdog's scenario): past it,
        drain gives up WITHOUT touching engine state (the stuck step
        may still hold it) and reports ``drained: False``."""
        self._draining = True
        deadline = (None if timeout_s is None
                    else time.monotonic() + timeout_s)
        while True:
            pump_alive = (self._pump_task is not None
                          and not self._pump_task.done())
            if pump_alive:
                if deadline is not None and \
                        time.monotonic() > deadline:
                    # the watchdog stays armed: the replica still runs
                    # with a possibly wedged engine
                    stats = self.engine.stats()
                    return {"drained": False,
                            "reason": "pump still running past the "
                                      "drain timeout (wedged step?)",
                            "free_slots": stats["free_slots"],
                            "active": stats["active"],
                            "waiting": stats["waiting"]}
                await asyncio.sleep(poll_s)
                continue
            if self.engine.has_work():
                # the pump is dead (step failure) or never ran, so
                # nothing will tick the engine again: retire every
                # leftover request host-side (consumers already got
                # the pump's error fan-out)
                self.engine.drain_requests()
            break
        if self._watchdog is not None:
            self._watchdog.stop()
        stats = self.engine.stats()
        return {"drained": True,
                "requests_done":
                    self.engine.telemetry.summary().get(
                        "requests_done", 0)
                    if self.engine.telemetry.enabled else None,
                "free_slots": stats["free_slots"],
                "active": stats["active"],
                "waiting": stats["waiting"]}

    def telemetry_summary(self) -> Dict[str, Any]:
        summary = self.engine.telemetry.summary()
        summary["stats"] = self.engine.stats()
        summary["draining"] = self._draining
        summary["streams_reaped"] = self.streams_reaped
        if self._watchdog is not None:
            summary["watchdog_wedges"] = self._watchdog.wedges
        return summary


GPTDeployment = serve.deployment(max_ongoing_requests=32)(GPTDeployment)
# The module's name ``GPTDeployment`` is the Deployment; give the class
# the dotted path that reaches it from the module, so cloudpickle ships
# it by reference (the replica imports this module) instead of by value,
# where torch's module objects do not pickle.
GPTDeployment.func_or_class.__qualname__ = "GPTDeployment.func_or_class"
