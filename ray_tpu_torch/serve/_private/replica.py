# The port's copy of ray_tpu/serve/_private/replica.py
"""Replica actor wrapping the user's deployment callable.

Parity: reference ``serve/_private/replica.py`` (compressed): executes
requests against the user class, tracks in-flight count for
power-of-two-choices routing, supports async and sync callables.

Streams carry a credit flow the reference's do not.  The object-ref
streaming protocol tells the producer nothing of its reader, so a replica
would drain its deployment's generator into the object store however
slowly (or not at all) the consumer reads.  Here a stream runs at most
``_STREAM_WINDOW`` items ahead of what the consumer has taken; the
consumer (``handle.DeploymentResponseGenerator``) acknowledges every
``_STREAM_ACK_EVERY`` items through :meth:`ServeReplica.stream_ack`.  So
a consumer that holds its stream but stops reading leaves the
deployment's items unread, where ``GPTDeployment``'s idle-stream reaper
sees them.  A stream whose consumer acknowledges nothing for
``_STREAM_STALL_S`` while the window is full is closed, which runs the
user generator's cleanup, and ends in :class:`StreamStalledError`, so a
reader that comes back sees the cut.
"""

from __future__ import annotations

import asyncio
import inspect
import time
from typing import Any, Dict, Tuple

import ray_tpu_torch

_STREAM_WINDOW = 32
_STREAM_ACK_EVERY = 8
_STREAM_STALL_S = 30.0


class StreamStalledError(RuntimeError):
    """The stream's consumer took nothing for ``_STREAM_STALL_S`` with a
    full credit window: the replica closed the deployment's generator,
    and the items before this error are all the stream delivered."""


def get_multiplexed_model_id() -> str:
    from ray_tpu_torch.serve._private.mux_context import get_model_id
    return get_model_id()


@ray_tpu_torch.remote
class ServeReplica:
    def __init__(self, app_name: str, deployment_name: str,
                 cls_blob: bytes, init_args: Tuple, init_kwargs: Dict,
                 user_config=None):
        import cloudpickle
        cls = cloudpickle.loads(cls_blob)
        if inspect.isfunction(cls):
            self.instance = cls
        else:
            self.instance = cls(*init_args, **init_kwargs)
        self.app_name = app_name
        self.deployment_name = deployment_name
        self._ongoing = 0
        # stream id -> [items acknowledged, event set on each ack]
        self._stream_acks: Dict[str, list] = {}
        if user_config is not None and hasattr(self.instance,
                                               "reconfigure"):
            # applied synchronously: the replica must not serve requests
            # (or report ready) with the config unapplied, and a failing
            # reconfigure must fail the replica like the reference does.
            # Actor __init__ runs before the actor's event loop starts,
            # so asyncio.run is safe for async reconfigure.
            out = self.instance.reconfigure(user_config)
            if inspect.iscoroutine(out):
                import asyncio
                asyncio.run(out)

    def ping(self):
        return "pong"

    def num_ongoing(self) -> int:
        return self._ongoing

    async def handle_request(self, method_name: str, args, kwargs,
                             mux_model_id: str = ""):
        from ray_tpu_torch.serve._private import mux_context
        self._ongoing += 1
        token = mux_context.set_model_id(mux_model_id)
        try:
            if callable(self.instance) and method_name == "__call__":
                fn = self.instance
            else:
                fn = getattr(self.instance, method_name)
            result = fn(*args, **kwargs)
            if inspect.iscoroutine(result):
                result = await result
            return result
        finally:
            mux_context.reset(token)
            self._ongoing -= 1

    async def handle_request_streaming(self, method_name: str, args,
                                       kwargs, mux_model_id: str = "",
                                       stream_id: str = ""):
        """Streaming variant: the user callable's (a)sync generator is
        re-yielded item by item; called with ``num_returns="streaming"``
        each item becomes an object-ref slot as produced (parity:
        reference replica.py streaming via ObjectRefGenerator).  With a
        ``stream_id`` the next item is pulled only while the consumer
        is inside the credit window."""
        from ray_tpu_torch.serve._private import mux_context
        self._ongoing += 1
        token = mux_context.set_model_id(mux_model_id)
        if stream_id:
            self._stream_acks[stream_id] = [0, asyncio.Event()]
        try:
            if callable(self.instance) and method_name == "__call__":
                fn = self.instance
            else:
                fn = getattr(self.instance, method_name)
            result = fn(*args, **kwargs)
            if inspect.iscoroutine(result):
                result = await result
            sent = 0
            if inspect.isasyncgen(result):
                async for item in result:
                    yield item
                    sent += 1
                    if not await self._stream_credit(stream_id, sent):
                        await result.aclose()
                        raise self._stalled(sent)
            elif inspect.isgenerator(result) or (
                    hasattr(result, "__iter__")
                    and not isinstance(result,
                                       (list, tuple, dict, str, bytes))):
                for item in result:
                    yield item
                    sent += 1
                    if not await self._stream_credit(stream_id, sent):
                        getattr(result, "close", lambda: None)()
                        raise self._stalled(sent)
            else:
                yield result
        finally:
            self._stream_acks.pop(stream_id, None)
            mux_context.reset(token)
            self._ongoing -= 1

    def _stalled(self, sent: int) -> StreamStalledError:
        return StreamStalledError(
            f"{self.deployment_name}: the stream's consumer took nothing "
            f"for {_STREAM_STALL_S} s with {_STREAM_WINDOW} items unread; "
            f"closed after {sent} items")

    async def _stream_credit(self, stream_id: str, sent: int) -> bool:
        """Wait while ``sent`` items are a full window ahead of the
        consumer's acknowledgements; False once it has acknowledged
        nothing new for ``_STREAM_STALL_S`` (the consumer is gone)."""
        state = self._stream_acks.get(stream_id)
        if state is None:
            return True
        acked, deadline = state[0], time.monotonic() + _STREAM_STALL_S
        while sent - state[0] >= _STREAM_WINDOW:
            if state[0] != acked:            # progress: a fresh budget
                acked, deadline = state[0], \
                    time.monotonic() + _STREAM_STALL_S
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return False
            state[1].clear()
            try:
                await asyncio.wait_for(state[1].wait(), remaining)
            except asyncio.TimeoutError:
                pass
        return True

    async def stream_ack(self, stream_id: str, taken: int) -> None:
        """The consumer of ``stream_id`` has taken ``taken`` items."""
        state = self._stream_acks.get(stream_id)
        if state is not None and taken > state[0]:
            state[0] = taken
            state[1].set()

    async def reconfigure(self, user_config):
        if hasattr(self.instance, "reconfigure"):
            out = self.instance.reconfigure(user_config)
            if inspect.iscoroutine(out):
                await out
        return True
