"""Device profiling helpers.

Counterpart of ``ray_tpu/util/profiling.py``: a train loop (or a Serve
replica) captures a ``torch.profiler`` trace of a code block, with CUDA
activity on a process that has a card, viewable in Perfetto or
``chrome://tracing`` beside the cluster-level chrome trace
(``ray-tpu timeline``).  On a process with no card the profiler records
CPU activity, as the reference's profiler does on its CPU backend.
"""

from __future__ import annotations

import contextlib
import os
import socket
import tempfile
import time
from typing import Iterator, Optional

TRACE_SUFFIX = ".pt.trace.json"

# Trivial kernels each session on a card starts with, under
# WARMUP_ANNOTATION.  In a long-lived process that has done much CUDA
# work, the profiler (torch 2.11, CUPTI 12.8, H100) loses the first GPU
# activity records of every session, none in a fresh process: always a
# prefix, whatever the time between the session's start and the first
# launch.  The burst takes that loss, so the block's own kernels and
# copies all reach the trace (``chip_smoke.py``'s gpt2-profile prints
# how many of the burst's records a session kept).
WARMUP_OPS = 1024
WARMUP_ANNOTATION = "profile_device/warmup"


def session_warmup() -> None:
    """The WARMUP_ANNOTATION burst, at the start of a profiler session
    on a card."""
    import torch
    x = torch.zeros(1, device=torch.cuda.current_device())
    with torch.profiler.record_function(WARMUP_ANNOTATION):
        for _ in range(WARMUP_OPS):
            x.add_(1)
    torch.cuda.synchronize()


@contextlib.contextmanager
def profile_device(logdir: Optional[str] = None,
                   host_tracer_level: int = 2) -> Iterator[str]:
    """Capture a device profile around a code block.

    Yields the log directory; afterwards it holds
    ``<host>.<pid>.<ns>.pt.trace.json``, a Chrome/Perfetto trace of the
    block's CPU ops, ``annotate`` ranges and (with a card) CUDA kernels
    and copies, after the ``WARMUP_ANNOTATION`` burst that takes the
    records a session can lose at its start.  ``host_tracer_level``
    follows the reference's levels: 0 records no host activity where a
    card is traced, 3 also records input shapes and Python stacks.
    """
    import torch
    from torch.profiler import ProfilerActivity
    logdir = logdir or os.path.join(
        tempfile.gettempdir(), f"ray_tpu_torch_profile_{int(time.time())}")
    os.makedirs(logdir, exist_ok=True)
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CUDA] if cuda else []
    if host_tracer_level > 0 or not cuda:
        activities.append(ProfilerActivity.CPU)
    verbose = host_tracer_level >= 3
    with torch.profiler.profile(activities=activities, record_shapes=verbose,
                                with_stack=verbose) as prof:
        if cuda:
            session_warmup()
        yield logdir
        if cuda:
            # the block's last kernels end inside the session
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        logdir, f"{socket.gethostname()}.{os.getpid()}.{time.time_ns()}"
        f"{TRACE_SUFFIX}"))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region inside a device profile (``record_function``)."""
    import torch
    with torch.profiler.record_function(name):
        yield


def device_memory_stats() -> dict:
    """Per-device live-memory stats (device memory pressure at a glance),
    from ``torch.cuda.memory_stats``; a process with no card reports its
    CPU device with no figures, as the reference's CPU backend does."""
    import torch
    if not torch.cuda.is_available():
        return {"cpu": {"bytes_in_use": None, "peak_bytes_in_use": None,
                        "bytes_limit": None}}
    out = {}
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": stats.get("allocated_bytes.all.current"),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak"),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
        }
    return out
