# The port's copy of ray_tpu/dag/compiled.py
"""Compiled DAG execution over mutable channels.

Parity: ``python/ray/dag/compiled_dag_node.py:174`` — compiling an actor
DAG replaces per-call task submission (control-plane round trips, object
commits, scheduling) with standing *executor loops*: each actor blocks
in a loop reading its input channels, invoking its bound method, and
writing its output channel.  After compilation a call is just shm
writes/reads — the mechanism for tight same-host actor pipelines (on a
GPU host: the host-side step loop around device computation).

Supported graph shape: ``MethodNode``s over distinct actors whose args
are the ``InputNode``, other MethodNodes, or constants; single output
node (or ``MultiOutputNode`` of MethodNodes).  ``experimental_compile``
on such a DAG returns a :class:`CompiledDAG`.
"""

from __future__ import annotations

import os
import uuid
from typing import Any, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.experimental.channel import Channel, ChannelClosed


class _DagError:
    """An exception captured in one stage, forwarded through channels so
    the driver (not a 60s channel timeout) surfaces it."""

    def __init__(self, exc: BaseException, tb: str):
        self.exc = exc
        self.tb = tb


def _executor_loop(instance, method_name: str, in_channels,
                   in_kinds, consts, out_channel, reader_indices):
    """Standing loop run inside the actor via ``__ray_call__``."""
    import traceback
    method = getattr(instance, method_name)
    try:
        while True:
            args = []
            failed = None
            for ch, kind, idx in zip(in_channels, in_kinds,
                                     reader_indices):
                if kind == "const":
                    args.append(ch)     # ch is the constant itself
                else:
                    value = ch.read(reader_index=idx, timeout=None)
                    if isinstance(value, _DagError) and failed is None:
                        failed = value
                    args.append(value)
            if failed is not None:
                out_channel.write(failed, timeout=None)
                continue        # poisoned input: forward, stay alive
            try:
                result = method(*args)
            except BaseException as e:  # noqa: BLE001 — ship to driver
                result = _DagError(e, traceback.format_exc())
            out_channel.write(result, timeout=None)
    except ChannelClosed:
        out_channel.close()     # propagate shutdown downstream
        return "closed"


class CompiledDAGFuture:
    """Result handle for one ``execute`` (read once, in order)."""

    def __init__(self, dag: "CompiledDAG", seq: int):
        self._dag = dag
        self._seq = seq

    def get(self, timeout: Optional[float] = 60.0):
        return self._dag._read_result(self._seq, timeout)


class CompiledDAG:
    def __init__(self, output_node, channel_capacity: int = 1 << 20):
        from ray_tpu_torch.dag import (InputNode, MethodNode, MultiOutputNode)
        self._chan_dir = None
        self._channels: List[Channel] = []
        self._loop_refs = []
        self._submitted = 0
        self._read = 0
        self._results: Dict[int, Any] = {}

        if isinstance(output_node, MultiOutputNode):
            outputs = list(output_node.outputs)
        else:
            outputs = [output_node]
        if not all(isinstance(o, MethodNode) for o in outputs):
            raise TypeError("compiled DAG outputs must be actor method "
                            "nodes")

        # ---- walk the graph: topological order over MethodNodes ------
        order: List[Any] = []
        seen: Dict[int, bool] = {}

        def visit(node):
            if id(node) in seen:
                return
            seen[id(node)] = True
            if node.kwargs:
                raise TypeError(
                    "compiled DAGs support positional args only "
                    f"(node {node.method!r} binds kwargs "
                    f"{sorted(node.kwargs)})")
            for a in node.args:
                if isinstance(a, MethodNode):
                    visit(a)
                elif isinstance(a, InputNode):
                    pass
                elif isinstance(a, (list, dict, set)):
                    raise TypeError(
                        "compiled DAGs take leaf args only")
            order.append(node)

        for o in outputs:
            visit(o)

        # one actor per node (an actor's loop serves exactly one node)
        actors = {}
        for node in order:
            handle = node.class_node._get_handle({}, ())
            if id(node.class_node) in actors:
                raise ValueError(
                    "compiled DAGs currently bind one method per actor")
            actors[id(node.class_node)] = handle

        # ---- channels -------------------------------------------------
        session_tmp = os.environ.get("TMPDIR", "/dev/shm")
        self._chan_dir = os.path.join(
            session_tmp, f"ray_tpu_dag_{uuid.uuid4().hex[:8]}")
        os.makedirs(self._chan_dir, exist_ok=True)

        def new_channel(name: str, num_readers: int) -> Channel:
            ch = Channel(os.path.join(self._chan_dir, name),
                         capacity=channel_capacity,
                         num_readers=num_readers)
            self._channels.append(ch)
            return ch

        # readers per producer: downstream nodes + driver (for outputs)
        consumers: Dict[int, int] = {}
        for node in order:
            for a in node.args:
                if isinstance(a, MethodNode):
                    consumers[id(a)] = consumers.get(id(a), 0) + 1
        input_consumers = sum(
            1 for node in order for a in node.args
            if isinstance(a, InputNode))
        for o in outputs:
            consumers[id(o)] = consumers.get(id(o), 0) + 1

        self._input_channel = new_channel("input", max(input_consumers,
                                                       1))
        out_channels: Dict[int, Channel] = {}
        for i, node in enumerate(order):
            out_channels[id(node)] = new_channel(
                f"node{i}", consumers.get(id(node), 1))

        # ---- start executor loops ------------------------------------
        input_reader_next = [0]

        def claim_input_reader() -> int:
            idx = input_reader_next[0]
            input_reader_next[0] += 1
            return idx

        reader_claims: Dict[int, int] = {}   # producer id -> next index

        for node in order:
            in_chs, kinds, idxs = [], [], []
            for a in node.args:
                from ray_tpu_torch.dag import InputNode, MethodNode
                if isinstance(a, InputNode):
                    in_chs.append(self._input_channel)
                    kinds.append("chan")
                    idxs.append(claim_input_reader())
                elif isinstance(a, MethodNode):
                    producer = out_channels[id(a)]
                    nxt = reader_claims.get(id(a), 0)
                    reader_claims[id(a)] = nxt + 1
                    in_chs.append(producer)
                    kinds.append("chan")
                    idxs.append(nxt)
                else:
                    in_chs.append(a)
                    kinds.append("const")
                    idxs.append(0)
            handle = actors[id(node.class_node)]
            ref = handle.__ray_call__.remote(
                _executor_loop, node.method, in_chs, kinds, None,
                out_channels[id(node)], idxs)
            self._loop_refs.append(ref)

        # driver reads each output with the producer's last reader index
        self._output_readers = []
        for o in outputs:
            nxt = reader_claims.get(id(o), 0)
            reader_claims[id(o)] = nxt + 1
            self._output_readers.append((out_channels[id(o)], nxt))
        self._multi = isinstance(output_node, MultiOutputNode)

    # ------------------------------------------------------------------
    def execute(self, value: Any) -> CompiledDAGFuture:
        self._input_channel.write(value)
        fut = CompiledDAGFuture(self, self._submitted)
        self._submitted += 1
        return fut

    def _read_result(self, seq: int, timeout: Optional[float]):
        if seq in self._results:
            out = self._results.pop(seq)
        else:
            out = None
            while self._read <= seq:
                vals = [ch.read(reader_index=idx, timeout=timeout)
                        for ch, idx in self._output_readers]
                got = vals if self._multi else vals[0]
                if self._read == seq:
                    self._read += 1
                    out = got
                    break
                self._results[self._read] = got
                self._read += 1
            else:
                raise RuntimeError(f"result {seq} already consumed")
        errs = out if isinstance(out, list) else [out]
        for e in errs:
            if isinstance(e, _DagError):
                raise RuntimeError(
                    f"compiled DAG stage raised:\n{e.tb}") from e.exc
        return out

    def teardown(self) -> None:
        for ch in self._channels:
            ch.close()
        # loops observe the poison and return; collect them briefly
        for ref in self._loop_refs:
            try:
                ray_tpu_torch.get(ref, timeout=10)
            except Exception:  # noqa: BLE001
                pass
        for ch in self._channels:
            ch.unlink()
        try:
            if self._chan_dir:
                os.rmdir(self._chan_dir)
        except OSError:
            pass

    def __del__(self):
        # close (unblocks loops) AND unlink: a dropped CompiledDAG must
        # not leak nodes+1 shm files per compile
        try:
            for ch in self._channels:
                ch.unlink()
            if self._chan_dir:
                os.rmdir(self._chan_dir)
        except Exception:  # noqa: BLE001
            pass
