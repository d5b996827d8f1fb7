# The port's copy of ray_tpu/tune/search/tpe.py
"""Native Tree-structured Parzen Estimator search.

Parity role: the reference integrates HyperOpt/Optuna for TPE
(``python/ray/tune/search/hyperopt/``, ``search/optuna/``); this is the
algorithm itself (Bergstra et al., NeurIPS 2011), dependency-free.

Model: completed trials are split at the gamma-quantile of the
objective into "good" (l) and "bad" (g) sets.  Each numeric dimension
gets a per-set Parzen window (Gaussian KDE over the observed unit-mapped
values); categoricals get Laplace-smoothed count distributions.
Candidates are drawn from l and ranked by the acquisition l(x)/g(x) —
the candidate most characteristic of good trials and least like bad
ones wins.
"""

from __future__ import annotations

import math
import random
from typing import Any, Dict, List, Optional

from ray_tpu_torch.tune.search.sample import Categorical, Domain
from ray_tpu_torch.tune.search.searcher import (Searcher, numeric_dims,
                                                sample_config, to_unit,
                                                from_unit)


def _kde_logpdf(x: float, points: List[float], bw: float) -> float:
    """log of a mixture of Gaussians centered at ``points``."""
    if not points:
        return 0.0
    acc = 0.0
    inv = 1.0 / (2.0 * bw * bw)
    for p in points:
        acc += math.exp(-(x - p) * (x - p) * inv)
    acc = max(acc / (len(points) * bw * math.sqrt(2 * math.pi)), 1e-300)
    return math.log(acc)


class TPESearcher(Searcher):
    def __init__(self, metric: Optional[str] = None, mode: str = "max",
                 n_initial_points: int = 8, gamma: float = 0.25,
                 n_candidates: int = 24, seed: int = 0):
        super().__init__(metric, mode)
        self.n_initial = n_initial_points
        self.gamma = gamma
        self.n_candidates = n_candidates
        self._rng = random.Random(seed)
        self._observed: List[Dict[str, Any]] = []   # {config, score}
        self._live: Dict[str, Dict[str, Any]] = {}  # trial_id -> config

    # ------------------------------------------------------------------
    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        if len(self._observed) < self.n_initial:
            cfg = sample_config(self.space, self._rng)
        else:
            cfg = self._suggest_tpe()
        self._live[trial_id] = cfg
        return cfg

    def on_trial_complete(self, trial_id: str,
                          result: Optional[Dict[str, Any]] = None,
                          error: bool = False) -> None:
        cfg = self._live.pop(trial_id, None)
        score = self._score(result)
        if cfg is None or error or score is None:
            return
        self._observed.append({"config": cfg, "score": score})

    # ------------------------------------------------------------------
    def _split(self):
        ranked = sorted(self._observed, key=lambda o: -o["score"])
        n_good = max(1, int(math.ceil(self.gamma * len(ranked))))
        return ranked[:n_good], ranked[n_good:]

    def _suggest_tpe(self) -> Dict[str, Any]:
        good, bad = self._split()
        dims = numeric_dims(self.space)
        cfg: Dict[str, Any] = {
            k: v for k, v in self.space.items()
            if not isinstance(v, Domain)}

        for key, dom in dims:
            if isinstance(dom, Categorical):
                cfg[key] = self._suggest_categorical(key, dom, good, bad)
            else:
                cfg[key] = self._suggest_numeric(key, dom, good, bad)
        # any remaining Domain (Function etc.): plain sample
        for key, dom in self.space.items():
            if key not in cfg and isinstance(dom, Domain):
                cfg[key] = dom.sample(self._rng)
        return cfg

    def _suggest_numeric(self, key, dom, good, bad):
        good_pts = [u for o in good
                    if (u := to_unit(dom, o["config"].get(key))) is not None]
        bad_pts = [u for o in bad
                   if (u := to_unit(dom, o["config"].get(key))) is not None]
        if not good_pts:
            return dom.sample(self._rng)
        # Scott-style bandwidth on the unit interval, floored so early
        # iterations keep exploring
        bw = max(0.1, 1.0 / max(2, len(good_pts)) ** 0.5 * 0.5)
        best_u, best_acq = None, -math.inf
        for _ in range(self.n_candidates):
            center = self._rng.choice(good_pts)
            u = min(1.0, max(0.0, self._rng.gauss(center, bw)))
            acq = (_kde_logpdf(u, good_pts, bw)
                   - _kde_logpdf(u, bad_pts, bw))
            if acq > best_acq:
                best_u, best_acq = u, acq
        return from_unit(dom, best_u)

    def _suggest_categorical(self, key, dom, good, bad):
        cats = dom.categories

        def weights(observations):
            counts = {repr(c): 1.0 for c in cats}   # Laplace smoothing
            for o in observations:
                r = repr(o["config"].get(key))
                if r in counts:
                    counts[r] += 1.0
            total = sum(counts.values())
            return {k: v / total for k, v in counts.items()}

        wg, wb = weights(good), weights(bad)
        scored = [(wg[repr(c)] / wb[repr(c)], c) for c in cats]
        # sample proportional to the acquisition ratio
        total = sum(s for s, _ in scored)
        pick = self._rng.uniform(0, total)
        for s, c in scored:
            pick -= s
            if pick <= 0:
                return c
        return scored[-1][1]
