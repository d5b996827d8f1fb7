"""TransformersTrainer: an HF checkpoint in, a fine-tune on the card out.

Counterpart of ``ray_tpu/train/huggingface/transformers_trainer.py``
(parity: ``python/ray/train/huggingface/transformers/``).  The HF GPT-2
checkpoint is ported once, on the driver, into the port's GPT in its
exact-architecture mode (``weights.port_gpt2``), shipped to the workers
as numpy arrays through the object store, and trained with
``build_gpt_train`` over the workers' mesh: the same kernels and
sharding rules as the port's own GPT.

Three-line user path::

    trainer = TransformersTrainer(model=hf_model,
                                  datasets={"train": ds},
                                  scaling_config=ScalingConfig(
                                      num_workers=1, use_gpu=True))
    result = trainer.fit()

``datasets["train"]`` rows need an ``input_ids`` field (a tokenizer's
output); ``fit()`` reports ``loss``, ``step``, ``grad_norm`` and
``epoch`` every ``logging_steps``, and a checkpoint (the parameters,
``train.save_pytree``) every ``save_steps``.  Each report also carries
``step_ms`` (the logged step's host time, which ends in the loss's copy
to the host), ``kernel_launches`` (the port's kernel launches in the
worker since the previous report, ``ops._build.launch_counts``) and, on
the card, ``peak_memory_gib`` (``torch.cuda.max_memory_allocated``).

One difference from the reference: there, one worker's jitted step
spans a mesh of virtual devices (``"mesh": {"dp": 4, "tp": 2}`` with
``num_workers=1``); in the port a mesh spans the process world, one
rank a worker, so the mesh's size must equal ``num_workers``.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional

from ray_tpu_torch.train.config import RunConfig, ScalingConfig
from ray_tpu_torch.train.data_parallel_trainer import DataParallelTrainer
from ray_tpu_torch.train.torch.config import TorchConfig


def _pack_token_stream(row_iter, seq_len: int, batch_size: int,
                       eos_id: int):
    """Pack variable-length ``input_ids`` rows into dense LM batches:
    rows joined by ``eos_id`` into one stream, cut into ``[batch_size,
    seq_len + 1]`` windows; yields (tokens, targets) int32."""
    import numpy as np
    need = batch_size * (seq_len + 1)
    buf: list = []
    for row in row_iter:
        ids = row["input_ids"] if isinstance(row, dict) else row
        buf.extend(int(t) for t in ids)
        buf.append(eos_id)
        while len(buf) >= need:
            chunk = np.asarray(buf[:need], dtype=np.int32).reshape(
                batch_size, seq_len + 1)
            buf = buf[need:]
            yield chunk[:, :-1], chunk[:, 1:]


def _mesh_size(mesh_axes: Dict[str, int], num_workers: int) -> int:
    """The number of ranks ``mesh_axes`` holds (a ``-1`` axis takes what
    the others leave of ``num_workers``)."""
    fixed = math.prod(n for n in mesh_axes.values() if n != -1)
    if any(n == -1 for n in mesh_axes.values()):
        return num_workers if fixed and num_workers % fixed == 0 else -1
    return fixed


def _default_hf_train_loop(config: Dict[str, Any]) -> None:
    """The reference's ``_default_hf_train_loop`` on the port: pack the
    stream, ``build_gpt_train`` on the ported config with optax's
    ``clip_by_global_norm(1) -> adamw(warmup_cosine, b2=0.999)``, report
    and checkpoint."""
    import os
    import tempfile
    import time

    import numpy as np
    import torch

    from ray_tpu_torch import train
    from ray_tpu_torch.models import gpt as gpt_mod
    from ray_tpu_torch.models import training as training_mod
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops.substrate import resolve_device
    from ray_tpu_torch.parallel import sharding
    from ray_tpu_torch.parallel.mesh import make_mesh, mesh_groups
    from ray_tpu_torch.train.checkpoint import load_pytree, save_pytree

    args = config.get("training_args", {})
    cfg = gpt_mod.GPTConfig(**config["model_config"])
    dev = resolve_device(config.get("device"))
    seq_len = int(args.get("seq_len") or min(cfg.max_seq, 1024))
    per_device_bs = int(args.get("per_device_train_batch_size", 8))
    lr = float(args.get("learning_rate", 5e-5))
    max_steps = int(args.get("max_steps", 100))
    log_steps = int(args.get("logging_steps", 10))
    save_steps = int(args.get("save_steps", max_steps))
    weight_decay = float(args.get("weight_decay", 0.01))
    warmup = int(args.get("warmup_steps", 0))
    eos_id = int(args.get("eos_token_id", 50256) % cfg.vocab_size)
    mesh = make_mesh(**dict(args.get("mesh") or {"dp": -1}))
    groups = mesh_groups(mesh)
    n_data = groups.size("dp") * groups.size("fsdp")
    batch = per_device_bs * n_data

    tx = training_mod.default_optimizer(
        lr=lr, weight_decay=weight_decay, warmup=max(warmup, 1),
        total_steps=max(max_steps, warmup + 1), grad_clip=1.0, b2=0.999)
    fns = training_mod.build_gpt_train(cfg, mesh, optimizer=tx, device=dev)
    params = config["model_params"]
    ckpt = train.get_checkpoint()
    if ckpt is not None:
        with ckpt.as_directory() as d:
            params = load_pytree(d)

    def place(node):
        if isinstance(node, dict):
            return {k: place(v) for k, v in node.items()}
        # (a copy: the object store's arrays are read-only)
        t = node if isinstance(node, torch.Tensor) else \
            torch.from_numpy(np.array(node))
        return t.to(dev, cfg.dtype)

    state = fns["init_fn"](params=place(params))

    world = torch.distributed.get_world_size() \
        if torch.distributed.is_initialized() else 1
    shard = train.get_dataset_shard("train")
    if shard is not None:
        if world > 1 and (groups.size("tp") > 1 or groups.size("sp") > 1):
            raise ValueError(
                "datasets= gives every worker its own rows, but a tp or sp "
                "group needs the same rows on each of its ranks; pass "
                "token_stream= for such a mesh")
        rows_per_rank = batch // world

        def rows():
            while True:  # re-iterate epochs until max_steps
                n = 0
                for r in shard.iter_rows():
                    n += 1
                    yield r
                if n == 0:
                    return
    else:
        rows_per_rank = None
        stream = np.asarray(config["token_stream"], dtype=np.int32)

        def rows():
            while True:
                yield stream

    packer = _pack_token_stream(rows(), seq_len, rows_per_rank or batch,
                                eos_id)
    step_fn = fns["step_fn"]
    _build.reset_launches()
    for step in range(1, max_steps + 1):
        try:
            tokens, targets = next(packer)
        except StopIteration:
            break
        b = {"tokens": torch.from_numpy(tokens).long().to(dev),
             "targets": torch.from_numpy(targets).long().to(dev)}
        if rows_per_rank is None:
            b = fns["shard_batch"](b)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, b)
        if step % log_steps == 0 or step == max_steps:
            m = {"loss": float(metrics["loss"]),
                 "step_ms": (time.perf_counter() - t0) * 1e3,
                 "step": step,
                 "grad_norm": float(metrics["grad_norm"]),
                 "epoch": 0,
                 "kernel_launches": {k: n for k, n in
                                     _build.launch_counts().items() if n}}
            if dev.type == "cuda":
                m["peak_memory_gib"] = \
                    torch.cuda.max_memory_allocated(dev) / 2 ** 30
            _build.reset_launches()
            checkpoint = None
            if step % save_steps == 0 or step == max_steps:
                full = state.params if world == 1 else \
                    sharding.gather_params(state.params, mesh,
                                           gpt_mod.param_logical_axes(cfg))
                if train.get_context().get_world_rank() == 0:
                    d = tempfile.mkdtemp(prefix="hf_ckpt_")
                    save_pytree(full, d)
                    checkpoint = train.Checkpoint.from_directory(
                        os.fspath(d))
            train.report(m, checkpoint=checkpoint)


class TransformersTrainer(DataParallelTrainer):
    """Fine-tune an HF Transformers GPT-2 checkpoint on the card.

    ``model``: an HF model instance, a local checkpoint directory, or a
    ``(state_dict, config)`` pair, ported on the driver by
    ``weights.port_gpt2``.  ``training_args`` mirrors HF's names
    (``per_device_train_batch_size``, ``learning_rate``, ``max_steps``,
    ``logging_steps``, ``save_steps``, ``seq_len``, ``warmup_steps``,
    ``weight_decay``, ``eos_token_id``) plus ``mesh`` ({axis: size},
    whose size must be ``scaling_config.num_workers``).  The workers
    take a card each with ``ScalingConfig(use_gpu=True)``, as
    ``TorchTrainer``'s do; ``device="cpu"`` trains on the workers' CPUs
    instead (default: the card, which raises where there is none).  Pass
    ``train_loop_per_worker`` to replace the built-in loop."""

    def __init__(self, *, model: Any = None,
                 training_args: Optional[Dict[str, Any]] = None,
                 train_loop_per_worker: Optional[Callable] = None,
                 train_loop_config: Optional[Dict[str, Any]] = None,
                 token_stream: Any = None,
                 dtype: Any = None,
                 device: Optional[str] = None,
                 scaling_config: Optional[ScalingConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 datasets: Optional[Dict[str, Any]] = None,
                 **kwargs):
        loop_config = dict(train_loop_config or {})
        scaling_config = scaling_config or ScalingConfig()
        if train_loop_per_worker is None:
            if model is None:
                raise ValueError(
                    "TransformersTrainer needs `model=` (an HF model, a "
                    "local checkpoint directory, or (state_dict, config)) "
                    "unless a custom train_loop_per_worker is given")
            mesh_axes = dict((training_args or {}).get("mesh")
                             or {"dp": -1})
            size = _mesh_size(mesh_axes, scaling_config.num_workers)
            if size != scaling_config.num_workers:
                raise ValueError(
                    f"training_args['mesh'] = {mesh_axes} holds {size} "
                    f"ranks, but a mesh spans the process world, one rank "
                    f"a worker: it must hold num_workers = "
                    f"{scaling_config.num_workers}")
            from ray_tpu_torch.train.huggingface import weights as hfw
            if isinstance(model, tuple):
                cfg, params = hfw.port_gpt2(model[0], hf_config=model[1],
                                            dtype=dtype)
            else:
                cfg, params = hfw.load_model(model, dtype=dtype)
            import dataclasses

            import numpy as np
            loop_config.update({
                "model_config": dataclasses.asdict(cfg),
                "model_params": params,
                "training_args": dict(training_args or {}),
                "device": device,
            })
            if token_stream is not None:
                loop_config["token_stream"] = np.asarray(
                    token_stream, dtype=np.int32)
            train_loop_per_worker = _default_hf_train_loop
        super().__init__(
            train_loop_per_worker,
            train_loop_config=loop_config,
            backend_config=kwargs.pop("backend_config", None)
            or TorchConfig(),
            scaling_config=scaling_config,
            run_config=run_config,
            datasets=datasets,
            **kwargs)
