# The port's copy of ray_tpu/remote_function.py
"""``@ray_tpu_torch.remote`` functions.

Parity target: ``python/ray/remote_function.py`` — decorator builds a
RemoteFunction whose ``.remote()`` submits a task and returns ObjectRef(s);
``.options(...)`` overrides per-call.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional

from ray_tpu_torch._private.task_spec import (SchedulingStrategy,
                                             normalize_resources)
from ray_tpu_torch._private.worker import global_worker


def normalize_strategy(strategy) -> SchedulingStrategy:
    if strategy is None:
        return SchedulingStrategy()
    if isinstance(strategy, SchedulingStrategy):
        return strategy
    if isinstance(strategy, str):
        if strategy in ("DEFAULT", "default"):
            return SchedulingStrategy()
        if strategy in ("SPREAD", "spread"):
            return SchedulingStrategy(kind="spread")
        raise ValueError(f"unknown scheduling strategy {strategy!r}")
    # duck-typed strategy objects from ray_tpu_torch.util.scheduling_strategies
    kind = type(strategy).__name__
    if kind == "NodeAffinitySchedulingStrategy":
        node_id = strategy.node_id
        if isinstance(node_id, str):
            node_id = bytes.fromhex(node_id)
        return SchedulingStrategy(kind="node_affinity", node_id=node_id,
                                  soft=strategy.soft)
    if kind == "PlacementGroupSchedulingStrategy":
        pg = strategy.placement_group
        return SchedulingStrategy(
            kind="placement_group", pg_id=pg.id.binary(),
            bundle_index=strategy.placement_group_bundle_index,
            capture_child_tasks=bool(
                strategy.placement_group_capture_child_tasks))
    raise TypeError(f"unsupported scheduling strategy: {strategy!r}")


def _apply_pg_resources(resources: Dict[str, float],
                        strategy: SchedulingStrategy) -> Dict[str, float]:
    """Rewrite resources to placement-group bundle resources.

    Mirrors the reference's formatted-resource trick: PG bundles publish
    ``pg_<id>_<index>_<name>`` custom resources; PG-scheduled tasks consume
    those instead of the raw node resources.
    """
    if strategy.kind != "placement_group":
        return resources
    pg_hex = strategy.pg_id.hex()
    out = {}
    for name, qty in resources.items():
        if qty <= 0:
            continue
        if strategy.bundle_index >= 0:
            out[f"pg_{pg_hex}_{strategy.bundle_index}_{name}"] = qty
        else:
            out[f"pg_{pg_hex}_{name}"] = qty
    return out


class RemoteFunction:
    def __init__(self, fn, **default_opts):
        self._function = fn
        self._default_opts = default_opts
        self._prepared = None   # submit_opts template (built once:
        #                         options are per-RemoteFunction static)
        functools.update_wrapper(self, fn)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Remote function '{getattr(self._function, '__name__', '?')}' "
            "cannot be called directly; use .remote().")

    def options(self, **opts) -> "RemoteFunction":
        merged = dict(self._default_opts)
        merged.update(opts)
        return RemoteFunction(self._function, **merged)

    def remote(self, *args, **kwargs):
        return self._remote(args, kwargs, self._default_opts)

    def _remote(self, args, kwargs, opts: Dict[str, Any]):
        worker = global_worker()
        # opts are fixed per RemoteFunction (options() returns a new
        # one), so the normalized submit template is built exactly once
        # — .remote() in a tight submission loop skips the dict churn
        submit_opts = self._prepared if opts is self._default_opts \
            else None
        if submit_opts is None:
            resources = normalize_resources(
                opts.get("num_cpus"), opts.get("num_gpus"),
                opts.get("resources"), opts.get("memory"),
                default_cpus=1.0, num_tpus=opts.get("num_tpus"))
            strategy = normalize_strategy(opts.get("scheduling_strategy"))
            resources = _apply_pg_resources(resources, strategy)
            submit_opts = {
                "num_returns": opts.get("num_returns", 1),
                "resources": resources,
                "scheduling_strategy": strategy,
                "name": opts.get("name"),
                "max_retries": opts.get("max_retries"),
                "retry_exceptions": opts.get("retry_exceptions", False),
                "runtime_env": opts.get("runtime_env"),
            }
            if submit_opts["max_retries"] is None:
                from ray_tpu_torch._private.config import GLOBAL_CONFIG
                submit_opts["max_retries"] = \
                    GLOBAL_CONFIG.task_default_max_retries
            if opts is self._default_opts:
                self._prepared = submit_opts
        return worker.submit_task(self._function, args, kwargs, submit_opts)

    @property
    def func(self):
        return self._function

    def bind(self, *args, **kwargs):
        """DAG-building entrypoint (compiled DAGs / Serve graphs)."""
        from ray_tpu_torch.dag import FunctionNode
        return FunctionNode(self, args, kwargs)
