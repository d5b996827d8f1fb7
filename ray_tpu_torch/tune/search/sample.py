# The port's copy of ray_tpu/tune/search/sample.py
"""Search-space primitives (parity: ``python/ray/tune/search/sample.py``).

``grid_search`` expands combinatorially; domains sample per trial.
"""

from __future__ import annotations

import random
from typing import Any, Callable, Dict, List, Sequence


class Domain:
    def sample(self, rng: random.Random) -> Any:
        raise NotImplementedError


class Categorical(Domain):
    def __init__(self, categories: Sequence[Any]):
        self.categories = list(categories)

    def sample(self, rng):
        return rng.choice(self.categories)


class Uniform(Domain):
    def __init__(self, lower: float, upper: float):
        self.lower, self.upper = lower, upper

    def sample(self, rng):
        return rng.uniform(self.lower, self.upper)


class LogUniform(Domain):
    def __init__(self, lower: float, upper: float, base: float = 10.0):
        import math
        self.lo = math.log(lower, base)
        self.hi = math.log(upper, base)
        self.base = base

    def sample(self, rng):
        return self.base ** rng.uniform(self.lo, self.hi)


class RandInt(Domain):
    def __init__(self, lower: int, upper: int):
        self.lower, self.upper = lower, upper

    def sample(self, rng):
        return rng.randrange(self.lower, self.upper)


class QUniform(Domain):
    def __init__(self, lower: float, upper: float, q: float):
        self.lower, self.upper, self.q = lower, upper, q

    def sample(self, rng):
        value = rng.uniform(self.lower, self.upper)
        return round(value / self.q) * self.q


class Function(Domain):
    def __init__(self, fn: Callable):
        self.fn = fn

    def sample(self, rng):
        return self.fn(None)


class GridSearch:
    def __init__(self, values: Sequence[Any]):
        self.values = list(values)


# public constructors (ray.tune API names)
def choice(categories):
    return Categorical(categories)


def uniform(lower, upper):
    return Uniform(lower, upper)


def loguniform(lower, upper, base=10.0):
    return LogUniform(lower, upper, base)


def randint(lower, upper):
    return RandInt(lower, upper)


def quniform(lower, upper, q):
    return QUniform(lower, upper, q)


def sample_from(fn):
    return Function(fn)


def grid_search(values):
    return GridSearch(values)


def _expand_grid(space: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Cross product of all GridSearch entries; other values pass through."""
    import itertools
    grid_keys = [k for k, v in space.items() if isinstance(v, GridSearch)]
    if not grid_keys:
        return [dict(space)]
    combos = itertools.product(*(space[k].values for k in grid_keys))
    out = []
    for combo in combos:
        cfg = dict(space)
        for k, v in zip(grid_keys, combo):
            cfg[k] = v
        out.append(cfg)
    return out


def resolve(space: Dict[str, Any], num_samples: int,
            seed: int = 0) -> List[Dict[str, Any]]:
    """Expand a param space into concrete trial configs.

    grid entries cross-multiply; Domain entries are sampled once per
    (sample index, grid point) — reference BasicVariantGenerator shape.
    """
    rng = random.Random(seed)
    grids = _expand_grid(space)
    configs = []
    for _ in range(num_samples):
        for g in grids:
            cfg = {}
            for k, v in g.items():
                if isinstance(v, Domain):
                    cfg[k] = v.sample(rng)
                else:
                    cfg[k] = v
            configs.append(cfg)
    return configs
