"""The serving payload's parser and the deployment's typed errors.

Counterpart of the three names of ``ray_tpu/inference/serve_gpt.py``
that the fleet imports (:mod:`ray_tpu_torch.fleet`): the typed
admission rejection of a draining replica, the typed cancellation of an
abandoned stream, and :func:`parse_request`, the one parser of the
request dict.  The deployment itself (``GPTDeployment``, its
``_build_engine`` and ``RAY_TPU_INFER_STREAM_IDLE``) sits on
``ray_tpu.serve`` and the runtime under it, and comes with them
(ROADMAP Queue 1 item 6c).
"""

from __future__ import annotations

from typing import Any, Dict

from ray_tpu_torch.inference.sampling import SamplingParams


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
