# The port's copy of ray_tpu/tune/search/searcher.py
"""Pluggable search algorithms (parity:
``python/ray/tune/search/searcher.py``).

A :class:`Searcher` proposes trial configs one at a time and learns from
completed results; the Tuner drives it when ``TuneConfig.search_alg`` is
set.  Unlike the reference's thin wrappers over external libraries
(Optuna/HyperOpt/BayesOpt...), the model-based searchers here are
implemented natively (`tpe.py`, `bayesopt.py`) so the framework has no
extra dependencies.
"""

from __future__ import annotations

import random
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.tune.search.sample import (Categorical, Domain, GridSearch,
                                              LogUniform, QUniform, RandInt,
                                              Uniform, resolve)


class Searcher:
    """Suggest/observe interface.

    Lifecycle per trial: ``suggest(trial_id) -> config`` (or None when
    the searcher has nothing to propose right now), zero or more
    ``on_trial_result``, then exactly one ``on_trial_complete``.
    """

    def __init__(self, metric: Optional[str] = None, mode: str = "max"):
        self.metric = metric
        self.mode = mode

    def set_search_properties(self, metric: Optional[str], mode: str,
                              space: Dict[str, Any],
                              num_samples: Optional[int] = None) -> None:
        if metric:
            self.metric = metric
        if mode:
            self.mode = mode
        self.space = space
        self.tuner_num_samples = num_samples

    def total_suggestions(self) -> Optional[int]:
        """How many configs this searcher will propose in total; None =
        unbounded (the Tuner stops at its own num_samples)."""
        return None

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        raise NotImplementedError

    def on_trial_result(self, trial_id: str,
                        result: Dict[str, Any]) -> None:
        pass

    def on_trial_complete(self, trial_id: str,
                          result: Optional[Dict[str, Any]] = None,
                          error: bool = False) -> None:
        pass

    # ------------------------------------------------------------------
    def _score(self, result: Optional[Dict[str, Any]]) -> Optional[float]:
        """Normalized 'bigger is better' objective from a result dict."""
        if not result or self.metric not in result:
            return None
        value = float(result[self.metric])
        return value if self.mode == "max" else -value


class BasicVariantGenerator(Searcher):
    """Grid/random search expressed as a Searcher (the default when
    ``search_alg`` is unset — same semantics as ``sample.resolve``)."""

    def __init__(self, metric: Optional[str] = None, mode: str = "max",
                 num_samples: int = 1, seed: int = 0):
        super().__init__(metric, mode)
        self.num_samples = num_samples
        self.seed = seed
        self._configs: Optional[List[Dict[str, Any]]] = None
        self._next = 0

    def _resolve(self) -> List[Dict[str, Any]]:
        if self._configs is None:
            # TuneConfig.num_samples (passed via set_search_properties)
            # wins unless this generator was built with an explicit one
            n = self.num_samples
            if n == 1 and getattr(self, "tuner_num_samples", None):
                n = self.tuner_num_samples
            self._configs = resolve(self.space, n, self.seed)
        return self._configs

    def total_suggestions(self) -> Optional[int]:
        return len(self._resolve())

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        configs = self._resolve()
        if self._next >= len(configs):
            return None
        cfg = configs[self._next]
        self._next += 1
        return cfg


def numeric_dims(space: Dict[str, Any]) -> List[Tuple[str, Domain]]:
    """The dimensions a model-based searcher can model."""
    dims = []
    for key, dom in space.items():
        if isinstance(dom, GridSearch):
            raise ValueError(
                f"{key}: grid_search cannot be combined with a "
                "model-based searcher; use tune.choice instead")
        if isinstance(dom, (Uniform, LogUniform, QUniform, RandInt,
                            Categorical)):
            dims.append((key, dom))
    return dims


def to_unit(dom: Domain, value: Any) -> Optional[float]:
    """Map a sampled value into [0, 1] for modeling; None if unmappable."""
    import math
    if isinstance(dom, Uniform):
        span = dom.upper - dom.lower
        return (float(value) - dom.lower) / span if span else 0.5
    if isinstance(dom, QUniform):
        span = dom.upper - dom.lower
        return (float(value) - dom.lower) / span if span else 0.5
    if isinstance(dom, LogUniform):
        lv = math.log(float(value), dom.base)
        span = dom.hi - dom.lo
        return (lv - dom.lo) / span if span else 0.5
    if isinstance(dom, RandInt):
        span = dom.upper - 1 - dom.lower
        return ((float(value) - dom.lower) / span) if span > 0 else 0.5
    return None


def from_unit(dom: Domain, u: float) -> Any:
    """Inverse of :func:`to_unit` (clipped to the domain)."""
    u = min(1.0, max(0.0, u))
    if isinstance(dom, Uniform):
        return dom.lower + u * (dom.upper - dom.lower)
    if isinstance(dom, QUniform):
        value = dom.lower + u * (dom.upper - dom.lower)
        return round(value / dom.q) * dom.q
    if isinstance(dom, LogUniform):
        return dom.base ** (dom.lo + u * (dom.hi - dom.lo))
    if isinstance(dom, RandInt):
        hi = max(dom.lower, dom.upper - 1)
        return int(round(dom.lower + u * (hi - dom.lower)))
    raise TypeError(f"not a numeric domain: {dom!r}")


def sample_config(space: Dict[str, Any], rng: random.Random
                  ) -> Dict[str, Any]:
    """One random config from the space (passthrough for constants)."""
    cfg = {}
    for key, dom in space.items():
        cfg[key] = dom.sample(rng) if isinstance(dom, Domain) else dom
    return cfg
