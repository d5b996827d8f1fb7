# The port's copy of ray_tpu/workflow/events.py
"""Workflow events (parity: ``python/ray/workflow/event_listener.py``).

An *event* is an external happening a durable workflow waits on —
a timer, a file landing, a message — expressed as an
:class:`EventListener` whose ``poll_for_event`` blocks until the event
occurs.  ``workflow.wait_for_event(Listener, *args)`` runs the listener
as a workflow step: the wait participates in durable replay, so a
resumed workflow that already observed the event does NOT wait again —
the recorded payload replays instead (checkpointed like any other step
result).
"""

from __future__ import annotations

import time
from typing import Any


class EventListener:
    """Subclass with an async (or sync) ``poll_for_event``."""

    async def poll_for_event(self, *args, **kwargs) -> Any:
        raise NotImplementedError

    async def event_checkpointed(self, event: Any) -> None:
        """Commit hook: called after the event payload is durably
        recorded (override for exactly-once sources needing acks)."""


class TimerListener(EventListener):
    """Fires at an absolute unix timestamp (reference example)."""

    async def poll_for_event(self, fire_at: float) -> float:
        import asyncio
        delay = fire_at - time.time()
        if delay > 0:
            await asyncio.sleep(delay)
        return fire_at


class FileEventListener(EventListener):
    """Fires when a path exists; payload is the file's contents."""

    async def poll_for_event(self, path: str,
                             poll_interval_s: float = 0.1) -> bytes:
        import asyncio
        import os
        while not os.path.exists(path):
            await asyncio.sleep(poll_interval_s)
        with open(path, "rb") as f:
            return f.read()


def wait_for_event(listener_cls, *args, **kwargs):
    """Workflow step wrapper: returns a bound step callable for use
    inside ``workflow.run`` graphs (the listener's poll result is the
    step's durable output)."""
    import asyncio

    def _wait(*a, **kw):
        listener = listener_cls()
        event = asyncio.run(listener.poll_for_event(*args, **kwargs))
        asyncio.run(listener.event_checkpointed(event))
        return event

    _wait.__name__ = f"wait_for_event[{listener_cls.__name__}]"
    return _wait
