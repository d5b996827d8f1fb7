"""Step-level training telemetry: the :class:`StepTelemetry` recorder.

Counterpart of ``ray_tpu/telemetry/step.py``.  Wraps a train step
(``build_gpt_train``'s ``step_fn``) and writes one record per step:

- ``step``, ``ts`` (epoch start), ``wall_s``, split into ``dispatch_s``
  (the step returns on the host) and ``sync_s`` (the device drains: one
  ``torch.cuda.synchronize`` of the output's card per step, the
  reference's ``block_until_ready``, and no other sync; nothing to wait
  for on the CPU);
- ``tokens``, and ``loss`` when the step returns one;
- ``tokens_per_sec`` and ``mfu`` (:mod:`ray_tpu_torch.telemetry.flops`,
  against the H100's dense bf16 peak) on steady steps only: step 0's
  wall carries the first call's one-time costs.  Both are the rank's
  own: the port runs one controller per rank, whose recorder counts
  only that rank's rows, so its tokens/s is already the per-device
  figure (the single-controller reference sees the global batch and
  divides by the mesh's size);
- ``compile_s`` on step 0 only.  Eager PyTorch compiles nothing ahead
  of time (no ``lower().compile()``): the first step's one-time costs
  are loading the kernel library and the kernel modules, cuBLAS's
  handles and workspaces, and the allocator's first blocks.  The port
  therefore records ``compile_s`` as step 0's wall minus step 1's, set
  on step 0's record once step 1 has run (at least 0).  No step runs
  twice to measure it: no extra optimizer update touches the state.

With ``aot=True`` the summary's ``hbm`` holds ``argument_bytes`` (the
bytes of every tensor in step 0's arguments: the state and batch trees)
and, on the card, ``peak_bytes``: ``torch.cuda.max_memory_allocated``
over step 0 (the allocator's peak is reset before it).  The reference
reads both from ``memory_analysis()``, which eager PyTorch has not.

Records flow to three sinks: the Chrome-trace exporter
(:mod:`ray_tpu_torch.telemetry.chrome_trace`), Prometheus series through
the runtime's metrics (``train_step_seconds``, ``train_mfu``,
``train_tokens_per_sec``, ``train_collective_bytes``: the ``total`` of
:meth:`StepTelemetry.collective_bytes`) when a runtime is up, and
:meth:`StepTelemetry.summary`.  ``RAY_TPU_TELEMETRY=0`` makes
the wrapper the identity.  ``RAY_TPU_PROFILE=<dir>`` captures a
``torch.profiler`` trace of the first steady steps into that directory.
"""

from __future__ import annotations

import dataclasses
import functools
import statistics
import sys
import time
import weakref
from typing import Any, Dict, List, Optional

from ray_tpu_torch.telemetry import flops as flops_mod
from ray_tpu_torch.telemetry.config import telemetry_config

# live recorders, so the chrome-trace exporter merges every in-process
# training loop without explicit plumbing
_RECORDERS: "weakref.WeakSet[StepTelemetry]" = weakref.WeakSet()


def recorders() -> List["StepTelemetry"]:
    return list(_RECORDERS)


def _tensors(tree):
    """Every tensor in a tree of dicts, lists, tuples and NamedTuples."""
    import torch
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        yield from _tensors(vars(tree))


def _find_tokens(args, kwargs):
    """The [B, S] token tensor of a step call, if one is recognizable."""
    for a in list(args) + list(kwargs.values()):
        if isinstance(a, dict) and "tokens" in a:
            tok = a["tokens"]
            if hasattr(tok, "shape") and len(tok.shape) == 2:
                return tok
    return None


def _cuda_device(out):
    """The card of the step's first CUDA output tensor, or None."""
    for t in _tensors(out):
        if t.device.type == "cuda":
            return t.device
    return None


class StepTelemetry:
    """Per-step telemetry recorder around one train step."""

    _MAX_RECORDS = 10_000

    def __init__(self, cfg=None, mesh=None, *,
                 comm_mode: Optional[str] = None,
                 comm_quant: Optional[str] = None,
                 ce_mode: Optional[str] = None,
                 label: str = "train",
                 aot: bool = False,
                 chip_peak_tflops: Optional[float] = None,
                 batch_axes=("dcn", "dp", "fsdp"),
                 config=None):
        tcfg = config or telemetry_config()
        self.enabled: bool = tcfg.enabled
        self.cfg = cfg
        self.mesh = mesh
        self.comm_mode = comm_mode
        self.comm_quant = comm_quant
        self.ce_mode = ce_mode
        self.label = label
        self.batch_axes = tuple(batch_axes)
        self.records: List[Dict[str, Any]] = []
        self.step_count = 0      # total steps seen (survives trimming)
        self.compile_s: Optional[float] = None
        self.first_step_s: Optional[float] = None
        self.memory: Optional[Dict[str, int]] = None
        self._aot = aot
        self._cfgobj = tcfg
        self._tokens_per_step: Optional[int] = None
        self._seq: Optional[int] = None
        self._batch: Optional[int] = None
        self._peak = chip_peak_tflops
        self._fpt: Optional[float] = None   # cached; -1 = unavailable
        self._metrics = None          # lazily-created metric objects
        self._metrics_dead = False    # no runtime / emission failed
        self._metrics_last = 0.0      # last emission (monotonic)
        self._bytes_emitted = False
        self._profiler = None
        self._profile_done = False
        if self.enabled:
            _RECORDERS.add(self)

    # ------------------------------------------------------------- wrap --

    def wrap(self, step_fn):
        """``step_fn -> step_fn`` (identity when telemetry is off)."""
        if not self.enabled:
            return step_fn

        @functools.wraps(step_fn)
        def wrapped(*args, **kwargs):
            return self._call(step_fn, args, kwargs)

        wrapped.telemetry = self
        return wrapped

    def _call(self, step_fn, args, kwargs):
        from ray_tpu_torch.util import tracing
        i = self.step_count
        self.step_count += 1
        self._note_tokens(args, kwargs)
        self._profile(i, before=True)
        peak_dev = self._memory_before(args, kwargs) if i == 0 else None
        ts = time.time()
        t0 = time.monotonic()
        with tracing.span(f"{self.label}/step", step=i):
            with tracing.span(f"{self.label}/dispatch", step=i):
                out = step_fn(*args, **kwargs)
            t_disp = time.monotonic()
            with tracing.span(f"{self.label}/sync", step=i):
                dev = _cuda_device(out)
                if dev is not None:
                    import torch
                    torch.cuda.synchronize(dev)
        t_end = time.monotonic()
        self._profile(i, before=False)
        if peak_dev is not None:
            import torch
            self.memory["peak_bytes"] = int(
                torch.cuda.max_memory_allocated(peak_dev))
        rec: Dict[str, Any] = {
            "step": i,
            "ts": ts,
            "wall_s": t_end - t0,
            "dispatch_s": t_disp - t0,
            "sync_s": t_end - t_disp,
        }
        if i == 0:
            self.first_step_s = rec["wall_s"]
        elif i == 1 and self.first_step_s is not None:
            # the first call's one-time costs: step 0's wall over step 1's
            self.compile_s = max(self.first_step_s - rec["wall_s"], 0.0)
            if self.records and self.records[0]["step"] == 0:
                self.records[0]["compile_s"] = self.compile_s
        if self._tokens_per_step:
            rec["tokens"] = self._tokens_per_step
            if i > 0:
                rec["tokens_per_sec"] = self._tokens_per_step / rec["wall_s"]
                fpt = self.flops_per_token()
                if fpt is not None:
                    rec["mfu"] = flops_mod.mfu(rec["tokens_per_sec"], fpt,
                                               self.chip_peak())
        loss = self._maybe_loss(out)
        if loss is not None:
            rec["loss"] = loss
        self.records.append(rec)
        if len(self.records) > self._MAX_RECORDS:
            # bounded: a long run must not grow host memory without
            # limit; first_step_s and compile_s live as attributes
            del self.records[:len(self.records) - self._MAX_RECORDS]
        self._emit(rec)
        return out

    def _memory_before(self, args, kwargs):
        """With ``aot``: the argument bytes, and on the card the
        allocator's peak reset before step 0; returns that card."""
        if not self._aot:
            return None
        seen, n = set(), 0
        for t in _tensors((args, kwargs)):
            if id(t) not in seen:
                seen.add(id(t))
                n += t.numel() * t.element_size()
        self.memory = {"argument_bytes": n}
        dev = _cuda_device((args, kwargs))
        if dev is not None:
            import torch
            torch.cuda.reset_peak_memory_stats(dev)
        return dev

    # ------------------------------------------------------- accounting --

    def _note_tokens(self, args, kwargs):
        if self._tokens_per_step is not None:
            return
        tok = _find_tokens(args, kwargs)
        if tok is not None:
            self._tokens_per_step = int(tok.shape[0]) * int(tok.shape[1])
            self._seq = int(tok.shape[1])
            self._batch = int(tok.shape[0])

    def _maybe_loss(self, out) -> Optional[float]:
        try:
            if (isinstance(out, tuple) and len(out) == 2
                    and isinstance(out[1], dict) and "loss" in out[1]):
                return float(out[1]["loss"])
        except Exception:  # noqa: BLE001 — loss stays optional
            pass
        return None

    def chip_peak(self) -> float:
        if self._peak is None:
            self._peak = flops_mod.H100_PEAK_TFLOPS
        return self._peak

    def _ce_recompute(self) -> Optional[bool]:
        """Whether the CE path recomputes the head matmul: the flash-CE
        formulation does (where its gate takes the shape); the dense
        modes do when ``ce_chunk >= 0``."""
        chunk_remat = getattr(self.cfg, "ce_chunk", 0) >= 0
        if self.ce_mode not in (None, "flash") or chunk_remat \
                or self._seq is None or self._batch is None:
            return chunk_remat
        from ray_tpu_torch.ops.flash_ce import supports
        return bool(supports(self._batch * self._seq, self.cfg.d_model,
                             self.cfg.vocab_size))

    def flops_per_token(self) -> Optional[float]:
        if self.cfg is None or self._seq is None:
            return None
        if self._fpt is None:     # constant once the batch shape is known
            try:
                self._fpt = flops_mod.gpt_train_flops_per_token(
                    self.cfg, self._seq, ce_recompute=self._ce_recompute())
            except Exception:  # noqa: BLE001 — non-GPT cfg
                self._fpt = -1.0
        return None if self._fpt < 0 else self._fpt

    def collective_bytes(self) -> Optional[Dict[str, Any]]:
        """The step's collective bytes per tier,
        ``parallel.overlap.collective_bytes_per_step`` under this
        recorder's schedule and wire, as the reference's recorder gives
        them; None before a step has run or for a non-GPT config.  The
        recorder sees this rank's batch, so the global batch and
        sequence it passes are the rank's times the mesh's batch axes
        (``batch_axes``: dcn, dp and fsdp, but a pipeline's stage axis)
        and sp."""
        if self.cfg is None or self.mesh is None or self._seq is None:
            return None
        try:
            from ray_tpu_torch.parallel import overlap as ovl
            from ray_tpu_torch.parallel.mesh import mesh_axis_size
            rows = 1
            for a in self.batch_axes:
                rows *= mesh_axis_size(self.mesh, a)
            return ovl.collective_bytes_per_step(
                self.cfg, self.mesh, batch=self._batch * rows,
                seq=self._seq * mesh_axis_size(self.mesh, "sp"),
                comm_mode=self.comm_mode or "gspmd",
                quant=self.comm_quant or "none")
        except Exception:  # noqa: BLE001 — non-GPT cfg / odd mesh
            return None

    # ---------------------------------------------------------- summary --

    def summary(self) -> Dict[str, Any]:
        """The aggregate ``telemetry`` block."""
        if not self.enabled:
            return {"enabled": False}
        out: Dict[str, Any] = {"enabled": True, "label": self.label,
                               "steps": self.step_count}
        if not self.records:
            return out
        out["compile_s"] = self.compile_s
        out["first_step_s"] = self.first_step_s
        steady = [r for r in self.records if r["step"] > 0]
        if steady:
            wall = statistics.median(r["wall_s"] for r in steady)
            out.update({
                "steady_step_s": wall,
                "steady_dispatch_s": statistics.median(
                    r["dispatch_s"] for r in steady),
                "steady_sync_s": statistics.median(
                    r["sync_s"] for r in steady),
            })
            if self._tokens_per_step:
                tok_s = self._tokens_per_step / wall
                out["tokens_per_step"] = self._tokens_per_step
                out["tokens_per_sec"] = tok_s
                out["tokens_per_sec_per_device"] = tok_s
                fpt = self.flops_per_token()
                if fpt is not None:
                    out["flops_per_token"] = fpt
                    out["chip_peak_tflops"] = self.chip_peak()
                    out["mfu"] = flops_mod.mfu(tok_s, fpt, self.chip_peak())
        out["hbm"] = self.memory
        cb = self.collective_bytes()
        out["collective_bytes_per_step"] = cb
        if cb is not None:
            # each tier's total and priced seconds, flattened
            for tier in ("ici", "dcn"):
                t = cb.get(tier) or {}
                out[f"collective_bytes_{tier}"] = t.get("total", 0)
                out[f"collective_seconds_{tier}"] = t.get("seconds", 0.0)
            red = (cb.get("dcn") or {}).get("reduction_vs_flat")
            if red is not None:
                out["dcn_reduction_vs_flat"] = red
        if self.comm_mode is not None:
            out["comm_mode"] = self.comm_mode
        if self.comm_quant is not None:
            out["comm_quant"] = self.comm_quant
        return out

    # ------------------------------------------------------ chrome trace --

    def chrome_events(self) -> List[Dict[str, Any]]:
        """This recorder's steps as Chrome-trace complete events."""
        evs: List[Dict[str, Any]] = []
        pid, tid = "train", self.label
        first = self.records[0] if self.records else None
        if (self.compile_s is not None and first is not None
                and first["step"] == 0):
            evs.append({"name": f"{self.label}/compile", "cat": "train",
                        "ph": "X", "ts": first["ts"] * 1e6,
                        "dur": self.compile_s * 1e6,
                        "pid": pid, "tid": tid, "args": {}})
        for r in self.records:
            args = {k: r[k] for k in ("loss", "tokens_per_sec", "mfu")
                    if k in r}
            args["sync_ms"] = r["sync_s"] * 1e3
            evs.append({"name": f"{self.label}/step {r['step']}",
                        "cat": "train_step", "ph": "X",
                        "ts": r["ts"] * 1e6, "dur": r["wall_s"] * 1e6,
                        "pid": pid, "tid": tid, "args": args})
            evs.append({"name": f"{self.label}/dispatch", "cat": "train",
                        "ph": "X", "ts": r["ts"] * 1e6,
                        "dur": r["dispatch_s"] * 1e6,
                        "pid": pid, "tid": f"{tid}/phases", "args": {}})
            evs.append({"name": f"{self.label}/sync", "cat": "train",
                        "ph": "X",
                        "ts": (r["ts"] + r["dispatch_s"]) * 1e6,
                        "dur": r["sync_s"] * 1e6,
                        "pid": pid, "tid": f"{tid}/phases", "args": {}})
        return evs

    # --------------------------------------------------------- profiler --

    _PROFILE_FIRST, _PROFILE_STEPS = 1, 3

    def _profile(self, i: int, *, before: bool):
        pdir = self._cfgobj.profile_dir
        if not pdir or self._profile_done:
            return
        last = self._PROFILE_FIRST + self._PROFILE_STEPS - 1
        try:
            if before and self._profiler is None \
                    and i >= self._PROFILE_FIRST:
                import torch
                acts = [torch.profiler.ProfilerActivity.CPU]
                if torch.cuda.is_available():
                    acts.append(torch.profiler.ProfilerActivity.CUDA)
                self._profiler = torch.profiler.profile(activities=acts)
                self._profiler.__enter__()
                if torch.cuda.is_available():
                    from ray_tpu_torch.util.profiling import session_warmup
                    session_warmup()
            elif not before and self._profiler is not None and i >= last:
                self.stop()
        except Exception as e:  # noqa: BLE001 — profiling is best-effort
            print(f"telemetry: profiler capture failed ({e!r})",
                  file=sys.stderr)
            self._profile_done = True

    def stop(self):
        """Finalize: stop a still-running profiler capture and write its
        trace into the profile directory."""
        prof, self._profiler = self._profiler, None
        if prof is None:
            return
        self._profile_done = True
        import os
        prof.__exit__(None, None, None)
        os.makedirs(self._cfgobj.profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            self._cfgobj.profile_dir, f"{self.label}_steps.json"))

    # ------------------------------------------------------- prometheus --

    _STEP_BOUNDARIES = [0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                        0.25, 0.5, 1.0, 2.5, 5.0, 10.0]

    _EMIT_INTERVAL_S = 0.5

    def _emit(self, rec):
        """Per-step Prometheus series through the runtime's metrics.

        Only while a runtime is up; the first failure turns emission off
        for the rest of the run.  Steps 0 and 1 always emit, the rest at
        most once a ``_EMIT_INTERVAL_S``: the control plane is an RPC
        away."""
        if self._metrics_dead:
            return
        now = time.monotonic()
        if rec["step"] > 1 and now - self._metrics_last \
                < self._EMIT_INTERVAL_S:
            return
        self._metrics_last = now
        try:
            from ray_tpu_torch._private.worker import is_initialized
            if not is_initialized():
                return            # a runtime may start later; retry then
            if self._metrics is None:
                from ray_tpu_torch.util.metrics import Gauge, Histogram
                tags = ("label",)
                self._metrics = {
                    "step_s": Histogram(
                        "train_step_seconds",
                        "train step wall seconds (one device sync)",
                        boundaries=self._STEP_BOUNDARIES, tag_keys=tags),
                    "mfu": Gauge("train_mfu",
                                 "analytic-FLOPs model FLOPs utilization",
                                 tag_keys=tags),
                    "tok": Gauge("train_tokens_per_sec",
                                 "training throughput", tag_keys=tags),
                    "bytes": Gauge("train_collective_bytes",
                                   "logical collective bytes/rank/step",
                                   tag_keys=tags),
                }
            tags = {"label": self.label}
            if rec["step"] > 0:
                self._metrics["step_s"].observe(rec["wall_s"], tags=tags)
            if "mfu" in rec:
                self._metrics["mfu"].set(rec["mfu"], tags=tags)
            if "tokens_per_sec" in rec:
                self._metrics["tok"].set(rec["tokens_per_sec"], tags=tags)
            if not self._bytes_emitted:
                cb = self.collective_bytes()
                if cb is not None:
                    self._metrics["bytes"].set(cb["total"], tags=tags)
                self._bytes_emitted = True
        except Exception:  # noqa: BLE001 — never tax the step loop
            self._metrics_dead = True


def instrument(fns: Dict[str, Any], cfg=None, mesh=None, *,
               comm_mode: Optional[str] = None,
               comm_quant: Optional[str] = None,
               ce_mode: Optional[str] = None, label: str = "train",
               aot: bool = False, batch_axes=("dcn", "dp", "fsdp"),
               config=None) -> Dict[str, Any]:
    """Wrap the ``step_fn`` of a train-fns dict with a fresh recorder.

    Returns the same dict with ``step_fn`` wrapped and two extra keys:
    ``telemetry`` (the :class:`StepTelemetry`) and ``raw_step_fn`` (the
    unwrapped step).  No-op (no extra keys) when telemetry is off."""
    rec = StepTelemetry(cfg, mesh, comm_mode=comm_mode,
                        comm_quant=comm_quant, ce_mode=ce_mode,
                        label=label, aot=aot, batch_axes=batch_axes,
                        config=config)
    if not rec.enabled:
        return fns
    fns["raw_step_fn"] = fns["step_fn"]
    fns["step_fn"] = rec.wrap(fns["step_fn"])
    fns["telemetry"] = rec
    return fns
