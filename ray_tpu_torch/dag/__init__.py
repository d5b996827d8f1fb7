# The port's copy of ray_tpu/dag/__init__.py
"""DAG building (parity: ``python/ray/dag``): ``fn.bind(...)`` /
``Cls.bind(...)`` build a lazy graph; ``.execute()`` submits it as
regular tasks, ``.experimental_compile()`` turns an actor DAG into a
standing pipeline over mutable shm channels
(``ray_tpu_torch.dag.compiled``, parity: ``compiled_dag_node.py``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple


class DAGNode:
    def execute(self, *args):
        refs = self._resolve({}, args)
        return refs

    def _resolve(self, cache: Dict[int, Any], exec_args: Tuple):
        raise NotImplementedError

    def experimental_compile(self, channel_capacity: int = 1 << 20):
        """Compile an actor DAG into a standing channel pipeline."""
        from ray_tpu_torch.dag.compiled import CompiledDAG
        return CompiledDAG(self, channel_capacity=channel_capacity)


class InputNode(DAGNode):
    """Placeholder for execute()-time arguments: ``with InputNode() as x``."""

    _CURRENT: List["InputNode"] = []

    def __init__(self, index: int = 0):
        self.index = index

    def __enter__(self):
        InputNode._CURRENT.append(self)
        return self

    def __exit__(self, *exc):
        InputNode._CURRENT.pop()

    def _resolve(self, cache, exec_args):
        return exec_args[self.index]


class FunctionNode(DAGNode):
    def __init__(self, remote_fn, args: Tuple, kwargs: Dict[str, Any]):
        self.remote_fn = remote_fn
        self.args = args
        self.kwargs = kwargs

    def _resolve(self, cache, exec_args):
        key = id(self)
        if key in cache:
            return cache[key]

        def value_of(a):
            return (a._resolve(cache, exec_args)
                    if isinstance(a, DAGNode) else a)

        ref = self.remote_fn.remote(
            *[value_of(a) for a in self.args],
            **{k: value_of(v) for k, v in self.kwargs.items()})
        cache[key] = ref
        return ref

    def execute(self, *args):
        return self._resolve({}, args)


class ClassNode(DAGNode):
    def __init__(self, actor_cls, args: Tuple, kwargs: Dict[str, Any]):
        self.actor_cls = actor_cls
        self.args = args
        self.kwargs = kwargs
        self._handle = None

    def _get_handle(self, cache, exec_args):
        if self._handle is None:
            def value_of(a):
                return (a._resolve(cache, exec_args)
                        if isinstance(a, DAGNode) else a)
            self._handle = self.actor_cls.remote(
                *[value_of(a) for a in self.args],
                **{k: value_of(v) for k, v in self.kwargs.items()})
        return self._handle

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return _MethodNodeFactory(self, name)

    def _resolve(self, cache, exec_args):
        return self._get_handle(cache, exec_args)


class _MethodNodeFactory:
    def __init__(self, class_node: ClassNode, method: str):
        self.class_node = class_node
        self.method = method

    def bind(self, *args, **kwargs) -> "MethodNode":
        return MethodNode(self.class_node, self.method, args, kwargs)


class MethodNode(DAGNode):
    def __init__(self, class_node: ClassNode, method: str, args, kwargs):
        self.class_node = class_node
        self.method = method
        self.args = args
        self.kwargs = kwargs

    def _resolve(self, cache, exec_args):
        key = id(self)
        if key in cache:
            return cache[key]
        handle = self.class_node._get_handle(cache, exec_args)

        def value_of(a):
            return (a._resolve(cache, exec_args)
                    if isinstance(a, DAGNode) else a)

        ref = getattr(handle, self.method).remote(
            *[value_of(a) for a in self.args],
            **{k: value_of(v) for k, v in self.kwargs.items()})
        cache[key] = ref
        return ref

    def execute(self, *args):
        return self._resolve({}, args)


class MultiOutputNode(DAGNode):
    """Bundle several leaves into one executable DAG (parity:
    ``python/ray/dag/output_node.py``): ``execute()`` resolves every
    branch against one shared cache, so diamond dependencies submit
    each upstream task exactly once, and returns one ref per output."""

    def __init__(self, outputs):
        self.outputs = list(outputs)

    def __iter__(self):
        return iter(self.outputs)

    def __len__(self):
        return len(self.outputs)

    def __getitem__(self, i):
        return self.outputs[i]

    def _resolve(self, cache, exec_args):
        return [o._resolve(cache, exec_args) if isinstance(o, DAGNode)
                else o for o in self.outputs]
