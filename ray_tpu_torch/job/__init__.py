# The port's copy of ray_tpu/job/__init__.py
"""Job submission (parity: ``python/ray/dashboard/modules/job/``).

``JobSubmissionClient.submit_job(entrypoint=...)`` runs a shell
entrypoint on the cluster under a detached supervisor actor
(reference ``job_manager.py:525`` JobSupervisor): the subprocess gets
the job's ``runtime_env`` (env_vars / working_dir), its output is
captured to a per-job log, and lifecycle state
(PENDING → RUNNING → SUCCEEDED/FAILED/STOPPED) lives in the
control-plane KV so any client can query it.

Entrypoints inherit ``RAY_TPU_ADDRESS``, so a script calling
``ray_tpu_torch.init()`` attaches to the submitting cluster as a driver
(``AttachedNode``) — tasks/actors it creates run on the cluster, like
the reference's RAY_ADDRESS injection.
"""

from __future__ import annotations

import json
import os
import time
import uuid
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import ray_tpu_torch

_NS = "_jobs"

VALID_STATUSES = ("PENDING", "RUNNING", "SUCCEEDED", "FAILED", "STOPPED")


@dataclass
class JobInfo:
    submission_id: str
    entrypoint: str
    status: str
    message: str = ""
    start_time: Optional[float] = None
    end_time: Optional[float] = None
    metadata: Optional[Dict[str, str]] = None
    runtime_env: Optional[Dict[str, Any]] = None
    exit_code: Optional[int] = None


def _cp():
    from ray_tpu_torch._private.worker import global_worker
    return global_worker().cp


def _put_info(info: JobInfo) -> None:
    _cp().kv_put(info.submission_id.encode(),
                 json.dumps(info.__dict__).encode(), namespace=_NS)


def _get_info(submission_id: str) -> Optional[JobInfo]:
    raw = _cp().kv_get(submission_id.encode(), namespace=_NS)
    if raw is None:
        return None
    return JobInfo(**json.loads(raw.decode()))


@ray_tpu_torch.remote(num_cpus=0)
class _JobSupervisor:
    """Runs one job's entrypoint subprocess; owns its lifecycle."""

    def __init__(self, submission_id: str, entrypoint: str,
                 runtime_env: Optional[Dict[str, Any]],
                 metadata: Optional[Dict[str, str]]):
        import subprocess
        import threading

        from ray_tpu_torch._private import runtime_env as _renv
        from ray_tpu_torch._private.worker import global_worker
        self.submission_id = submission_id
        self._proc = None
        existing = _get_info(submission_id)
        if existing is not None and existing.status == "FAILED":
            # the client gave up on this submission (tombstone): a
            # late-starting supervisor must not resurrect the job
            raise RuntimeError("job submission was aborted")
        session_dir = global_worker().session_dir if hasattr(
            global_worker(), "session_dir") else os.environ.get(
            "RAY_TPU_SESSION_DIR", "/tmp")
        self.log_path = os.path.join(session_dir, "logs",
                                     f"job-{submission_id}.log")
        os.makedirs(os.path.dirname(self.log_path), exist_ok=True)
        env = dict(os.environ)
        cwd = None
        renv = _renv.validate(runtime_env)
        for k, v in (renv.get("env_vars") or {}).items():
            env[k] = str(v)
        if renv.get("working_dir"):
            cwd = renv["working_dir"]
        # entrypoints that call ray_tpu_torch.init() attach to THIS cluster
        # instead of starting their own (parity: RAY_ADDRESS injection;
        # supervisors are workers, so the CP address is in their env)
        cp_addr = os.environ.get("RAY_TPU_CP_SOCK", "")
        if cp_addr:
            env.setdefault("RAY_TPU_ADDRESS", cp_addr)
        info = JobInfo(submission_id=submission_id, entrypoint=entrypoint,
                       status="RUNNING", start_time=time.time(),
                       metadata=metadata, runtime_env=runtime_env)
        _put_info(info)
        log_f = open(self.log_path, "ab")
        self._proc = subprocess.Popen(
            entrypoint, shell=True, env=env, cwd=cwd, stdout=log_f,
            stderr=subprocess.STDOUT)
        log_f.close()
        self._info = info
        self._waiter = threading.Thread(target=self._wait, daemon=True)
        self._waiter.start()

    def _wait(self) -> None:
        rc = self._proc.wait()
        self._info.end_time = time.time()
        self._info.exit_code = rc
        if self._info.status != "STOPPED":
            self._info.status = "SUCCEEDED" if rc == 0 else "FAILED"
            if rc != 0:
                self._info.message = f"entrypoint exited with code {rc}"
        _put_info(self._info)

    def stop(self) -> bool:
        if self._proc.poll() is None:
            self._info.status = "STOPPED"
            self._info.message = "stopped by user"
            _put_info(self._info)
            self._proc.terminate()
            try:
                self._proc.wait(timeout=5)
            except Exception:  # noqa: BLE001
                self._proc.kill()
            return True
        return False

    def logs(self) -> str:
        try:
            with open(self.log_path, "rb") as f:
                return f.read().decode(errors="replace")
        except OSError:
            return ""

    def ping(self) -> str:
        return self.submission_id


class JobSubmissionClient:
    """Parity surface of ``ray.job_submission.JobSubmissionClient``."""

    def __init__(self, address: Optional[str] = None):
        # address accepted for API parity; the client talks to the
        # in-process runtime
        if not ray_tpu_torch.is_initialized():
            raise RuntimeError("ray_tpu_torch.init() first")

    def submit_job(self, *, entrypoint: str,
                   submission_id: Optional[str] = None,
                   runtime_env: Optional[Dict[str, Any]] = None,
                   metadata: Optional[Dict[str, str]] = None) -> str:
        submission_id = submission_id or \
            f"raysubmit_{uuid.uuid4().hex[:12]}"
        if _get_info(submission_id) is not None:
            raise ValueError(f"job {submission_id!r} already exists")
        # validate the runtime_env before anything is recorded — a bad
        # env must fail the submit call, not strand a PENDING record
        from ray_tpu_torch._private import runtime_env as _renv
        _renv.validate(runtime_env)
        _put_info(JobInfo(submission_id=submission_id,
                          entrypoint=entrypoint, status="PENDING",
                          metadata=metadata, runtime_env=runtime_env))
        try:
            supervisor = _JobSupervisor.options(
                name=f"__job_{submission_id}",
                lifetime="detached").remote(submission_id, entrypoint,
                                            runtime_env, metadata)
            ray_tpu_torch.get(supervisor.ping.remote(), timeout=60)
        except BaseException as e:
            _put_info(JobInfo(submission_id=submission_id,
                              entrypoint=entrypoint, status="FAILED",
                              message=f"supervisor failed: {e}",
                              end_time=time.time(), metadata=metadata,
                              runtime_env=runtime_env))
            # a slow supervisor may still come up later: kill it so it
            # can't resurrect the job behind the caller's back
            try:
                ray_tpu_torch.kill(ray_tpu_torch.get_actor(
                    f"__job_{submission_id}"))
            except Exception:  # noqa: BLE001
                pass
            raise
        return submission_id

    def get_job_status(self, submission_id: str) -> str:
        info = _get_info(submission_id)
        if info is None:
            raise ValueError(f"no job {submission_id!r}")
        return info.status

    def get_job_info(self, submission_id: str) -> JobInfo:
        info = _get_info(submission_id)
        if info is None:
            raise ValueError(f"no job {submission_id!r}")
        return info

    def list_jobs(self) -> List[JobInfo]:
        out = []
        for key in _cp().kv_keys(namespace=_NS):
            info = _get_info(key.decode())
            if info:
                out.append(info)
        return sorted(out, key=lambda j: j.start_time or 0)

    def get_job_logs(self, submission_id: str) -> str:
        try:
            sup = ray_tpu_torch.get_actor(f"__job_{submission_id}")
        except ValueError:
            return ""
        return ray_tpu_torch.get(sup.logs.remote(), timeout=30)

    def stop_job(self, submission_id: str) -> bool:
        try:
            sup = ray_tpu_torch.get_actor(f"__job_{submission_id}")
        except ValueError:
            return False
        return ray_tpu_torch.get(sup.stop.remote(), timeout=30)

    def delete_job(self, submission_id: str) -> bool:
        info = _get_info(submission_id)
        if info is None or info.status in ("PENDING", "RUNNING"):
            return False
        try:
            ray_tpu_torch.kill(
                ray_tpu_torch.get_actor(f"__job_{submission_id}"))
        except Exception:  # noqa: BLE001
            pass
        return _cp().kv_del(submission_id.encode(), namespace=_NS)

    def wait_until_finished(self, submission_id: str,
                            timeout: float = 300.0) -> str:
        deadline = time.time() + timeout
        while time.time() < deadline:
            status = self.get_job_status(submission_id)
            if status in ("SUCCEEDED", "FAILED", "STOPPED"):
                return status
            time.sleep(0.2)
        raise TimeoutError(
            f"job {submission_id} not finished after {timeout}s")


JobStatus = VALID_STATUSES
