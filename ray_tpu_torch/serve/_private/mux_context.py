# The port's copy of ray_tpu/serve/_private/mux_context.py
"""Request-scoped multiplexed-model id.

Lives in its own module (imported inside functions at call time):
cloudpickle ships the replica class by value, and a ContextVar captured
in its globals is unpicklable.
"""

from __future__ import annotations

import contextvars

_mux_model_id: contextvars.ContextVar = contextvars.ContextVar(
    "ray_tpu_torch_serve_mux_model_id", default="")


def set_model_id(model_id: str):
    return _mux_model_id.set(model_id)


def reset(token) -> None:
    _mux_model_id.reset(token)


def get_model_id() -> str:
    return _mux_model_id.get()
