"""``ray_tpu_torch.adapters`` — multi-tenant LoRA serving.

Only the typed error is here so far: the port's engine runs no adapter
bank (ROADMAP Queue 1 item 11), so a request or handoff naming a
``model_id`` is refused with :class:`AdapterUnavailableError`, as the
JAX engine refuses it when built without adapter support.
"""

from typing import Optional


class AdapterUnavailableError(RuntimeError):
    """Typed failure for a request's ``model_id``: the adapter is not
    resident and cannot be loaded (here: the engine has no adapter bank).
    A terminal typed error, never a hang; ``__reduce__`` rebuilds it from
    its constructor arguments."""

    def __init__(self, model_id: Optional[str], reason: str):
        super().__init__(f"adapter {model_id!r} unavailable: {reason}")
        self.model_id = model_id
        self.reason = reason

    def __reduce__(self):
        return (AdapterUnavailableError, (self.model_id, self.reason))


__all__ = ["AdapterUnavailableError"]
