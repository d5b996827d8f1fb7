"""Async checkpoint/resume for training: survive preemption bit-exactly.

Counterpart of ``ray_tpu/resilience/checkpoint.py``.  Two pieces:

- :class:`TrainCheckpointer` — snapshots the **full** resume state (the
  :class:`~ray_tpu_torch.models.training.TrainState` — parameters,
  optimizer state, step — plus caller extras such as the stream cursor
  and ``torch.Generator`` states) to host memory on the training
  thread, then hands the disk write to a **background thread**: the
  step loop pays only the device-to-host copy every
  ``RAY_TPU_CKPT_EVERY`` steps, never the filesystem.  Writes go
  through ``train/checkpoint.py:save_pytree`` into
  ``train/checkpoint_manager.py`` retention (keep ``RAY_TPU_CKPT_KEEP``
  newest), the same ``checkpoint_NNNNNN`` directories every trainer
  here writes.

- :meth:`TrainCheckpointer.restore_latest` — walks the retained
  snapshots newest-first, **validating** each restored tree against the
  live state's structure, shapes and dtypes, and falls back *loudly* to
  the previous retained snapshot on a torn or corrupt one.

The port's step updates its tensors in place (the JAX step donates a
new tree), so the snapshot is a copy: :func:`_host_tree` copies every
tensor to fresh host memory before returning — on the card a blocking
copy on the current stream, which orders it after the step that made
the state and before the next ``optimizer.step`` writes over it.  A
snapshot that aliased the live tensors would hold a later step's
weights (and on the CPU ``.cpu()`` is no copy at all).

Resume is bit-exact where the step is deterministic: the snapshot is
taken between steps, and the data cursor restores the exact batch
sequence, so the resumed loss sequence equals an uninterrupted run's.

Failure policy: a checkpoint write that raises (disk full, injected
``ckpt.write`` fault) is counted and warned, never propagated.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ray_tpu_torch.resilience.config import resilience_config
from ray_tpu_torch.train.checkpoint import (Checkpoint, load_pytree,
                                            map_tensors, save_pytree)
from ray_tpu_torch.train.checkpoint_manager import CheckpointManager
from ray_tpu_torch.train.config import CheckpointConfig
from ray_tpu_torch.util import chaos

_STATE_NAME = "train_state"


def _mesh_spec(mesh):
    """Mesh / MeshSpec / None -> MeshSpec or None (the sidecar form)."""
    if mesh is None:
        return None
    from ray_tpu_torch.parallel.mesh import MeshSpec
    return mesh if isinstance(mesh, MeshSpec) else MeshSpec.from_mesh(mesh)


def _host_tree(tree):
    """A copy of ``tree`` with every tensor in fresh host memory (a
    consistent cut: the copy completes before this returns)."""
    return map_tensors(tree, lambda t: t.detach().to("cpu", copy=True))


def _leaves(tree, path=()):
    """(path, leaf) pairs of a state tree in a fixed order: dicts by
    key, sequences, NamedTuples and dataclasses by position."""
    if isinstance(tree, dict):
        for k in sorted(tree, key=str):
            yield from _leaves(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (str(i),))
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name), path + (f.name,))
    else:
        yield path, tree


def _shape_dtype(x):
    if hasattr(x, "shape") and hasattr(x, "dtype"):
        return tuple(x.shape), str(x.dtype)
    return (), type(x).__name__


def _validate_tree(restored, example) -> None:
    """Raise ``ValueError`` unless ``restored`` matches ``example``'s
    structure and per-leaf shape and dtype (a wrong tree loads without
    error; training on it is worse than falling back)."""
    got, want = list(_leaves(restored)), list(_leaves(example))
    if [p for p, _ in got] != [p for p, _ in want]:
        raise ValueError(f"checkpoint tree structure mismatch: "
                         f"{[p for p, _ in got]} != {[p for p, _ in want]}")
    for (path, r), (_, e) in zip(got, want):
        if _shape_dtype(r) != _shape_dtype(e):
            raise ValueError(
                f"checkpoint leaf {'/'.join(path)} mismatch: restored "
                f"{_shape_dtype(r)} vs expected {_shape_dtype(e)}")


def _load_into(live, restored):
    """``restored`` (host) placed like ``live``: each tensor on the live
    leaf's device; other leaves as restored."""
    import torch
    if isinstance(live, torch.Tensor):
        return restored.to(live.device)
    if isinstance(live, dict):
        return type(live)((k, _load_into(v, restored[k]))
                          for k, v in live.items())
    if isinstance(live, tuple) and hasattr(live, "_fields"):
        return type(live)(*(_load_into(a, b)
                            for a, b in zip(live, restored)))
    if isinstance(live, (list, tuple)):
        return type(live)(_load_into(a, b) for a, b in zip(live, restored))
    if dataclasses.is_dataclass(live) and not isinstance(live, type):
        return dataclasses.replace(live, **{
            f.name: _load_into(getattr(live, f.name),
                               getattr(restored, f.name))
            for f in dataclasses.fields(live) if f.init})
    return restored


def _truncate_dir(path: str) -> None:
    """Corrupt a just-written checkpoint (the ``ckpt.truncate`` fault
    action): delete the second half of its files, depth-first."""
    files: List[str] = []
    for root, _dirs, names in os.walk(path):
        files.extend(os.path.join(root, n) for n in sorted(names))
    for f in files[len(files) // 2:] or files:
        try:
            os.remove(f)
        except OSError:
            pass


class TrainCheckpointer:
    """Async snapshot writer + corrupt-tolerant restorer.

    ``maybe_save(state, step=...)`` is the hot-path call: a no-op
    unless ``step`` is a multiple of ``every``; on trigger it copies the
    state to host (the only cost the step loop sees) and enqueues the
    write.  The background thread persists through ``save_pytree`` and
    registers with a :class:`~ray_tpu_torch.train.checkpoint_manager.
    CheckpointManager` (``resume=True``: a restarted process adopts the
    prior run's snapshots), which prunes to the ``keep`` newest.
    ``flush()`` blocks until the write queue drains; ``close()`` flushes
    and stops the thread.  The write queue is bounded at 2: writes
    slower than the cadence block ``save`` rather than buffer an
    unbounded trail of host snapshots.
    """

    def __init__(self, directory: Optional[str] = None, *,
                 every: Optional[int] = None,
                 keep: Optional[int] = None,
                 mesh=None,
                 accum_steps: Optional[int] = None,
                 label: str = "train",
                 telemetry=None):
        rcfg = resilience_config()
        self.directory = directory or rcfg.ckpt_dir
        if self.directory is None:
            raise ValueError("TrainCheckpointer needs a directory "
                             "(argument or RAY_TPU_CKPT_DIR)")
        self.every = rcfg.ckpt_every if every is None else int(every)
        if self.every < 0:
            raise ValueError(f"every must be >= 0, got {self.every} "
                             "(check RAY_TPU_CKPT_EVERY)")
        keep = rcfg.ckpt_keep if keep is None else int(keep)
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep} "
                             "(check RAY_TPU_CKPT_KEEP)")
        os.makedirs(self.directory, exist_ok=True)
        self.manager = CheckpointManager(
            self.directory, CheckpointConfig(num_to_keep=keep),
            resume=True)
        from ray_tpu_torch.telemetry.ckpt import CkptTelemetry
        from ray_tpu_torch.telemetry.config import TelemetryConfig
        config = (TelemetryConfig(enabled=bool(telemetry))
                  if isinstance(telemetry, bool) else None)
        self.telemetry = CkptTelemetry(label=label, config=config)
        self.mesh_spec = _mesh_spec(mesh)
        self.accum_steps = (None if accum_steps is None
                            else int(accum_steps))
        self.write_errors: List[str] = []
        self.snapshot_s: List[float] = []
        self._q: "queue.Queue" = queue.Queue(maxsize=2)
        self._lock = threading.Lock()   # manager index/registration
        self._thread = threading.Thread(target=self._writer,
                                        daemon=True,
                                        name="ckpt-writer")
        self._thread.start()

    # -------------------------------------------------------- hot path
    def due(self, step: int) -> bool:
        """Whether ``step`` is a snapshot step."""
        return bool(self.every) and step % self.every == 0

    def maybe_save(self, state, *, step: int,
                   extras: Optional[Dict[str, Any]] = None,
                   mesh=None,
                   accum_steps: Optional[int] = None) -> bool:
        """Checkpoint iff ``every`` is on and ``step % every == 0``.
        Returns True when a snapshot was taken (write still async)."""
        if not self.due(step):
            return False
        self.save(state, step=step, extras=extras, mesh=mesh,
                  accum_steps=accum_steps)
        return True

    def save(self, state, *, step: int,
             extras: Optional[Dict[str, Any]] = None,
             mesh=None,
             accum_steps: Optional[int] = None) -> None:
        """Snapshot now: host copy on this thread, write in background.
        ``mesh``/``accum_steps`` override the constructor's for this
        snapshot's elastic sidecar."""
        t0 = time.monotonic()
        payload = {"state": _host_tree(state),
                   "extras": _host_tree(dict(extras or {}))}
        self.snapshot_s.append(time.monotonic() - t0)
        spec = _mesh_spec(mesh) if mesh is not None else self.mesh_spec
        accum = self.accum_steps if accum_steps is None \
            else int(accum_steps)
        sidecar: Dict[str, Any] = {}
        if spec is not None:
            sidecar["mesh"] = spec.to_dict()
        if accum is not None:
            sidecar["accum_steps"] = accum
        self._q.put((payload, int(step), sidecar))

    # ------------------------------------------------------- background
    def _writer(self) -> None:
        while True:
            job = self._q.get()
            if job is None:
                self._q.task_done()
                return
            payload, step, sidecar = job
            try:
                t0 = time.monotonic()
                chaos.maybe_fail("ckpt.write")
                with self._lock:
                    idx = self.manager._index
                    dest = os.path.join(self.directory,
                                        f"checkpoint_{idx:06d}")
                    save_pytree(payload, dest, name=_STATE_NAME)
                    ckpt_obj = Checkpoint(dest)
                    if sidecar:
                        ckpt_obj.set_metadata({"elastic": sidecar})
                    if chaos.should_fire("ckpt.truncate"):
                        _truncate_dir(dest)
                    self.manager.register(ckpt_obj,
                                          metrics={"step": step})
                self.telemetry.record_write(time.monotonic() - t0,
                                            step=step)
            except Exception as e:  # noqa: BLE001 — never kill the run
                self.telemetry.record_failure()
                self.write_errors.append(f"step {step}: {e!r}")
                print(f"checkpoint write for step {step} failed "
                      f"({e!r}); training continues on the previous "
                      "retained snapshot", file=sys.stderr)
            finally:
                self._q.task_done()

    def flush(self) -> None:
        """Block until every enqueued write has been attempted."""
        self._q.join()

    def close(self) -> None:
        self.flush()
        self._q.put(None)
        self._thread.join(timeout=30)

    def __enter__(self) -> "TrainCheckpointer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ---------------------------------------------------------- restore
    def restore_latest(self, example=None, *, mesh=None,
                       reshard: bool = False
                       ) -> Optional[Dict[str, Any]]:
        """Newest restorable snapshot, or None when the directory holds
        nothing usable.

        Walks retained checkpoints newest-first; each candidate is
        loaded and (when ``example`` — a live payload-shaped tree — is
        given) validated leaf by leaf.  A candidate that fails to load
        **or** validate is skipped with a loud stderr warning, and the
        walk falls back to the previous retained snapshot.

        ``mesh``: the topology the caller restores onto.  A snapshot
        whose sidecar records a *different* writing mesh raises
        :class:`~ray_tpu_torch.resilience.elastic.MeshMismatchError`
        unless ``reshard=True``.  Snapshots with no sidecar restore as
        before.

        Returns ``{"state", "extras", "step", "path", "mesh",
        "accum_steps"}`` with host tensors.
        """
        self.flush()
        with self._lock:
            candidates = list(self.manager.best_checkpoints())
        for ckpt, metrics in candidates:     # newest first (recency)
            sidecar = ckpt.get_metadata().get("elastic", {})
            recorded = sidecar.get("mesh")
            if recorded is not None:
                from ray_tpu_torch.parallel.mesh import MeshSpec
                recorded = MeshSpec.from_dict(recorded)
                if mesh is not None and not reshard:
                    current = _mesh_spec(mesh)
                    if recorded != current:
                        # not a fall-back case: every retained snapshot
                        # of this run was written on the same mesh
                        from ray_tpu_torch.resilience.elastic import \
                            MeshMismatchError
                        raise MeshMismatchError(recorded, current)
            try:
                payload = load_pytree(ckpt.path, name=_STATE_NAME,
                                      target=example)
                if example is not None:
                    _validate_tree(payload, example)
            except Exception as e:  # noqa: BLE001 — fall back, loudly
                print(f"checkpoint restore from {ckpt.path} failed "
                      f"({e!r}); falling back to the previous "
                      "retained snapshot", file=sys.stderr)
                continue
            return {"state": payload["state"],
                    "extras": payload.get("extras", {}),
                    "step": int(metrics.get("step", -1)),
                    "path": ckpt.path,
                    "mesh": recorded,
                    "accum_steps": sidecar.get("accum_steps")}
        return None


def _generator(seed: int):
    import torch
    return torch.Generator().manual_seed(int(seed))


def run_train_ckpt_loop(cfg, mesh=None, *, steps: int,
                        batch_size: int = 4, seq_len: int = 32,
                        seed: int = 0,
                        ckpt: Optional[TrainCheckpointer] = None,
                        resume: bool = False,
                        fns: Optional[Dict[str, Callable]] = None,
                        on_step: Optional[Callable[[int], None]] = None,
                        device=None) -> Dict[str, Any]:
    """A checkpointed synthetic-LM training loop, the resume-proof
    driver (``checkpoint.py:run_train_ckpt_loop``).

    Batches come from one ``torch.Generator`` seeded with ``seed + 1``
    (``training.synthetic_lm_batch``): its state and the step cursor
    ride the checkpoint extras, so a resumed run draws the same batches
    and its loss sequence equals the uninterrupted run's, bit for bit
    where the step is deterministic.  ``resume=True`` restores the
    newest valid snapshot from ``ckpt`` (corrupt ones fall back) and
    continues from its cursor; with nothing restorable it starts from
    scratch.  ``on_step(cursor)`` is a post-step hook (kill points).
    Runs on the card unless ``device="cpu"``."""
    from ray_tpu_torch.models import training

    fns = fns or training.build_gpt_train(cfg, mesh, telemetry=False,
                                          device=device)
    state = fns["init_fn"](_generator(seed))
    data_rng = _generator(seed + 1)
    cursor = 0
    restored_from = None
    if resume:
        if ckpt is None:
            raise ValueError("resume=True needs a TrainCheckpointer")
        example = {"state": _host_tree(state),
                   "extras": {"data_cursor": np.asarray(0),
                              "data_rng": data_rng.get_state()}}
        restored = ckpt.restore_latest(example=example, mesh=mesh)
        if restored is not None:
            state = _load_into(state, restored["state"])
            cursor = int(restored["extras"]["data_cursor"])
            data_rng.set_state(restored["extras"]["data_rng"])
            restored_from = restored["path"]
    start = cursor
    losses: List[float] = []
    step_fn = fns.get("raw_step_fn", fns["step_fn"])
    while cursor < steps:
        batch = training.synthetic_lm_batch(
            data_rng, batch_size, seq_len, cfg.vocab_size, device=device)
        state, metrics = step_fn(state, fns["shard_batch"](batch))
        losses.append(float(metrics["loss"]))
        cursor += 1
        if ckpt is not None:
            ckpt.maybe_save(state, step=cursor,
                            extras={"data_cursor": np.asarray(cursor),
                                    "data_rng": data_rng.get_state()},
                            mesh=mesh, accum_steps=fns.get("accum_steps"))
        if on_step is not None:
            on_step(cursor)
    if ckpt is not None:
        ckpt.flush()
    return {
        "losses": losses,
        "start_step": start,
        "steps_run": cursor - start,
        "restored_from": restored_from,
        "final_step": int(state.step),
        "state": state,
        "checkpoint": (ckpt.telemetry.summary() if ckpt is not None
                       else {"enabled": False}),
    }


def run_train_stream_loop(cfg, mesh=None, *, steps: int,
                          batch_size: int = 4, seq_len: int = 32,
                          seed: int = 0,
                          source=None,
                          ckpt: Optional[TrainCheckpointer] = None,
                          resume: bool = False,
                          fns: Optional[Dict[str, Callable]] = None,
                          on_step: Optional[Callable[[int], None]] = None,
                          loader_kwargs: Optional[Dict[str, Any]] = None,
                          device=None,
                          step_hook: Optional[Callable] = None
                          ) -> Dict[str, Any]:
    """:func:`run_train_ckpt_loop` with a **streaming** source
    (``checkpoint.py:run_train_stream_loop``).

    Batches come from :class:`ray_tpu_torch.data.StreamingLoader` —
    shard readers, sample packing (segment-masked ``[B, S]``), the
    bounded prefetch queue, the pinned double buffer — and every
    delivered batch carries the :class:`~ray_tpu_torch.data.
    StreamCursor` that regenerates its successors.  That cursor's
    fixed-capacity uint8 image rides the checkpoint ``extras``, so a run
    killed at any step, SIGKILL with reads in flight included, resumes
    with a loss sequence float-equal to the uninterrupted run's.

    ``source`` defaults to a :class:`~ray_tpu_torch.data.SyntheticDocs`
    corpus from ``seed`` (the reference's).  ``loader_kwargs`` forwards
    to the loader (``readers=``, ``pack=``, ``prefetch=``,
    ``telemetry=``, ...).  ``step_hook(step, fn)`` wraps each
    step call (``chip_smoke.py`` times it); the returned dict also
    carries the final ``state``.  Runs on the card unless
    ``device="cpu"``."""
    from ray_tpu_torch.data.source import SyntheticDocs
    from ray_tpu_torch.data.stream import (CURSOR_CAPACITY, DataPlaneError,
                                           StreamCursor, StreamingLoader)
    from ray_tpu_torch.models import training

    fns = fns or training.build_gpt_train(cfg, mesh, telemetry=False,
                                          device=device)
    state = fns["init_fn"](_generator(seed))
    if source is None:
        source = SyntheticDocs(seed + 1, num_shards=4,
                               docs_per_shard=256,
                               vocab=cfg.vocab_size,
                               min_len=max(2, seq_len // 8),
                               max_len=max(3, (3 * seq_len) // 4))
    lkw = dict(loader_kwargs or {})
    capacity = lkw.pop("cursor_capacity", None) or CURSOR_CAPACITY
    cursor = None
    restored_from = None
    if resume:
        if ckpt is None:
            raise ValueError("resume=True needs a TrainCheckpointer")
        example = {"state": _host_tree(state),
                   "extras": {"data_cursor": np.zeros(capacity, np.uint8)}}
        restored = ckpt.restore_latest(example=example, mesh=mesh)
        if restored is not None:
            state = _load_into(state, restored["state"])
            cursor = StreamCursor.from_array(
                restored["extras"]["data_cursor"])
            restored_from = restored["path"]
    start = cursor.batches if cursor is not None else 0
    losses: List[float] = []
    step_fn = fns.get("raw_step_fn", fns["step_fn"])
    sharding = fns["shard_batch"] if mesh is not None else None
    with StreamingLoader(source, batch_size=batch_size,
                         seq_len=seq_len, seed=seed, cursor=cursor,
                         cursor_capacity=capacity, sharding=sharding,
                         device=device, **lkw) as loader:
        step = start
        while step < steps:
            try:
                sb = loader.next()
            except StopIteration:
                raise DataPlaneError(
                    f"streaming source drained at batch {step} "
                    f"before the requested {steps} steps")
            if step_hook is None:
                state, metrics = step_fn(state, sb.batch)
            else:
                state, metrics = step_hook(
                    step, lambda: step_fn(state, sb.batch))
            losses.append(float(metrics["loss"]))
            step = sb.cursor.batches
            if ckpt is not None:
                ckpt.maybe_save(state, step=step,
                                extras={"data_cursor": sb.cursor_array},
                                mesh=mesh,
                                accum_steps=fns.get("accum_steps"))
            if on_step is not None:
                on_step(step)
        data_summary = loader.telemetry.summary()
    if ckpt is not None:
        ckpt.flush()
    return {
        "losses": losses,
        "start_step": start,
        "steps_run": step - start,
        "restored_from": restored_from,
        "final_step": int(state.step),
        "state": state,
        "data": data_summary,
        "checkpoint": (ckpt.telemetry.summary() if ckpt is not None
                       else {"enabled": False}),
    }
