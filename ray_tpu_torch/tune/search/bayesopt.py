# The port's copy of ray_tpu/tune/search/bayesopt.py
"""Native Gaussian-process Bayesian optimization.

Parity role: ``python/ray/tune/search/bayesopt/`` wraps the external
``bayesian-optimization`` package; here the GP (RBF kernel, Cholesky
solve) and the Expected-Improvement acquisition are implemented directly
on numpy so the searcher runs dependency-free.

Numeric dimensions are unit-mapped ([0,1]; log-scaled for loguniform);
categoricals are handled by conditioning: EI is maximized per category
combination drawn randomly (categoricals rarely dominate HPO spaces).
"""

from __future__ import annotations

import math
import random
from typing import Any, Dict, List, Optional

import numpy as np

from ray_tpu_torch.tune.search.sample import Categorical, Domain
from ray_tpu_torch.tune.search.searcher import (Searcher, numeric_dims,
                                                sample_config, to_unit,
                                                from_unit)


def _rbf(a: np.ndarray, b: np.ndarray, ls: float) -> np.ndarray:
    d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
    return np.exp(-0.5 * d2 / (ls * ls))


class GPSearcher(Searcher):
    def __init__(self, metric: Optional[str] = None, mode: str = "max",
                 n_initial_points: int = 6, n_candidates: int = 512,
                 length_scale: float = 0.25, noise: float = 1e-4,
                 xi: float = 0.01, seed: int = 0):
        super().__init__(metric, mode)
        self.n_initial = n_initial_points
        self.n_candidates = n_candidates
        self.ls = length_scale
        self.noise = noise
        self.xi = xi
        self._rng = random.Random(seed)
        self._np_rng = np.random.default_rng(seed)
        self._X: List[List[float]] = []    # unit-mapped numeric rows
        self._y: List[float] = []
        self._cats: List[Dict[str, Any]] = []  # categorical part per row
        self._live: Dict[str, Dict[str, Any]] = {}

    # ------------------------------------------------------------------
    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        if len(self._y) < self.n_initial:
            cfg = sample_config(self.space, self._rng)
        else:
            cfg = self._suggest_gp()
        self._live[trial_id] = cfg
        return cfg

    def on_trial_complete(self, trial_id: str,
                          result: Optional[Dict[str, Any]] = None,
                          error: bool = False) -> None:
        cfg = self._live.pop(trial_id, None)
        score = self._score(result)
        if cfg is None or error or score is None:
            return
        row, cats = self._encode(cfg)
        if row is None:
            return
        self._X.append(row)
        self._y.append(score)
        self._cats.append(cats)

    # ------------------------------------------------------------------
    def _dims(self):
        return [(k, d) for k, d in numeric_dims(self.space)
                if not isinstance(d, Categorical)]

    def _cat_dims(self):
        return [(k, d) for k, d in numeric_dims(self.space)
                if isinstance(d, Categorical)]

    def _encode(self, cfg):
        row = []
        for key, dom in self._dims():
            u = to_unit(dom, cfg.get(key))
            if u is None:
                return None, None
            row.append(u)
        cats = {k: cfg.get(k) for k, _ in self._cat_dims()}
        return row, cats

    def _suggest_gp(self) -> Dict[str, Any]:
        X = np.asarray(self._X, dtype=np.float64)
        y = np.asarray(self._y, dtype=np.float64)
        y_mean, y_std = y.mean(), y.std() or 1.0
        yn = (y - y_mean) / y_std

        K = _rbf(X, X, self.ls) + self.noise * np.eye(len(X))
        L = np.linalg.cholesky(K)
        alpha = np.linalg.solve(L.T, np.linalg.solve(L, yn))

        cand = self._np_rng.uniform(
            0, 1, (self.n_candidates, X.shape[1]))
        Ks = _rbf(cand, X, self.ls)                    # [C, N]
        mu = Ks @ alpha
        v = np.linalg.solve(L, Ks.T)                   # [N, C]
        var = np.clip(1.0 - (v * v).sum(0), 1e-12, None)
        sigma = np.sqrt(var)

        best = yn.max()
        imp = mu - best - self.xi
        z = imp / sigma
        # standard-normal cdf/pdf without scipy
        cdf = 0.5 * (1.0 + np.vectorize(math.erf)(z / math.sqrt(2.0)))
        pdf = np.exp(-0.5 * z * z) / math.sqrt(2.0 * math.pi)
        ei = imp * cdf + sigma * pdf

        u = cand[int(np.argmax(ei))]
        cfg: Dict[str, Any] = {
            k: v for k, v in self.space.items()
            if not isinstance(v, Domain)}
        for (key, dom), uv in zip(self._dims(), u):
            cfg[key] = from_unit(dom, float(uv))
        for key, dom in self._cat_dims():
            cfg[key] = dom.sample(self._rng)
        for key, dom in self.space.items():
            if key not in cfg and isinstance(dom, Domain):
                cfg[key] = dom.sample(self._rng)
        return cfg
