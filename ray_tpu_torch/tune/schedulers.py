# The port's copy of ray_tpu/tune/schedulers.py
"""Trial schedulers (parity: ``python/ray/tune/schedulers/``).

FIFOScheduler runs everything to completion; ASHAScheduler implements
async successive halving (``async_hyperband.py``): rungs at
grace_period * reduction_factor^k, trials below the rung's top-1/rf
quantile are stopped at that rung.
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict, List, Optional

CONTINUE = "CONTINUE"
STOP = "STOP"


class FIFOScheduler:
    def on_result(self, trial_id: str, result: Dict) -> str:
        return CONTINUE

    def on_trial_complete(self, trial_id: str):
        pass


class ASHAScheduler:
    def __init__(self, metric: Optional[str] = None, mode: str = "max",
                 time_attr: str = "training_iteration",
                 grace_period: int = 1, reduction_factor: int = 4,
                 max_t: int = 100):
        self.metric = metric
        self.mode = mode
        self.time_attr = time_attr
        self.grace_period = grace_period
        self.rf = reduction_factor
        self.max_t = max_t
        # rung milestones: grace * rf^k below max_t
        self.milestones: List[int] = []
        t = grace_period
        while t < max_t:
            self.milestones.append(t)
            t *= reduction_factor
        # rung -> list of recorded metric values
        self._rungs: Dict[int, List[float]] = defaultdict(list)
        self._trial_rung: Dict[str, int] = {}

    def _norm(self, value: float) -> float:
        return value if self.mode == "max" else -value

    def on_result(self, trial_id: str, result: Dict) -> str:
        t = result.get(self.time_attr)
        metric = result.get(self.metric) if self.metric else None
        if t is None or metric is None:
            return CONTINUE
        if t >= self.max_t:
            return STOP
        decision = CONTINUE
        for rung_idx, milestone in enumerate(self.milestones):
            if t >= milestone and \
                    self._trial_rung.get(trial_id, -1) < rung_idx:
                self._trial_rung[trial_id] = rung_idx
                values = self._rungs[milestone]
                values.append(self._norm(float(metric)))
                if len(values) >= self.rf:
                    cutoff_index = max(
                        0, int(math.ceil(len(values) / self.rf)) - 1)
                    cutoff = sorted(values, reverse=True)[cutoff_index]
                    if self._norm(float(metric)) < cutoff:
                        decision = STOP
        return decision

    def on_trial_complete(self, trial_id: str):
        self._trial_rung.pop(trial_id, None)


AsyncHyperBandScheduler = ASHAScheduler


class MedianStoppingRule:
    """Stop a trial whose running-average objective falls below the
    median of the other trials' running averages at the same step
    (parity: ``python/ray/tune/schedulers/median_stopping_rule.py``)."""

    def __init__(self, metric: Optional[str] = None, mode: str = "max",
                 time_attr: str = "training_iteration",
                 grace_period: int = 4, min_samples_required: int = 3):
        self.metric = metric
        self.mode = mode
        self.time_attr = time_attr
        self.grace_period = grace_period
        self.min_samples = min_samples_required
        # trial -> list of normalized metric values (one per report)
        self._history: Dict[str, List[float]] = defaultdict(list)

    def _norm(self, value: float) -> float:
        return value if self.mode == "max" else -value

    def on_result(self, trial_id: str, result: Dict) -> str:
        t = result.get(self.time_attr)
        metric = result.get(self.metric) if self.metric else None
        if t is None or metric is None:
            return CONTINUE
        hist = self._history[trial_id]
        hist.append(self._norm(float(metric)))
        if t < self.grace_period:
            return CONTINUE
        step = len(hist)
        other_avgs = [
            sum(h[:step]) / min(step, len(h))
            for tid, h in self._history.items()
            if tid != trial_id and h]
        if len(other_avgs) < self.min_samples:
            return CONTINUE
        # lower median: lenient on ties/even counts
        median = sorted(other_avgs)[(len(other_avgs) - 1) // 2]
        best_so_far = max(hist)
        return STOP if best_so_far < median else CONTINUE

    def on_trial_complete(self, trial_id: str):
        # completed histories stay: they keep informing the median
        pass


class HyperBandScheduler:
    """Bracketed successive halving (parity:
    ``python/ray/tune/schedulers/hyperband.py``), adapted to this
    controller's async report stream.

    Trials are assigned round-robin to brackets; bracket ``s`` starts
    its trials with budget ``r0 = max_t / eta^s`` and halves at rungs
    ``r0 * eta^k``.  A rung's cutoff activates once the rung has seen
    ``eta`` results (the async adaptation — the reference pauses trials
    at rung boundaries instead, which needs checkpoint/pause support in
    the executor).
    """

    def __init__(self, metric: Optional[str] = None, mode: str = "max",
                 time_attr: str = "training_iteration",
                 max_t: int = 81, eta: int = 3, num_brackets: int = 3):
        self.metric = metric
        self.mode = mode
        self.time_attr = time_attr
        self.max_t = max_t
        self.eta = eta
        # brackets from most to least aggressive: bracket i halves from
        # r0 = max_t / eta^(s_max - i) (s_max = log_eta max_t), so the
        # first bracket starts at the smallest budget
        s_max = max(1, int(math.log(max_t) / math.log(eta)))
        self.brackets: List[List[int]] = []
        for i in range(num_brackets):
            s = max(0, s_max - i)
            r = max(1, round(max_t / (eta ** s)))
            rungs = []
            while r < max_t:
                rungs.append(r)
                r *= eta
            self.brackets.append(rungs)
        self._trial_bracket: Dict[str, int] = {}
        self._next_bracket = 0
        # (bracket, milestone) -> recorded values
        self._rungs: Dict[tuple, List[float]] = defaultdict(list)
        self._trial_rung: Dict[str, int] = {}

    def _norm(self, value: float) -> float:
        return value if self.mode == "max" else -value

    def on_trial_add(self, trial_id: str, config: Dict) -> None:
        self._trial_bracket[trial_id] = self._next_bracket
        self._next_bracket = (self._next_bracket + 1) % len(self.brackets)

    def on_result(self, trial_id: str, result: Dict) -> str:
        t = result.get(self.time_attr)
        metric = result.get(self.metric) if self.metric else None
        if t is None or metric is None:
            return CONTINUE
        if t >= self.max_t:
            return STOP
        b = self._trial_bracket.setdefault(trial_id, 0)
        rungs = self.brackets[b]
        decision = CONTINUE
        # >=: time_attr need not step by 1 (seconds, stride-k reports);
        # the rung guard ensures each rung records once per trial
        for rung_idx, milestone in enumerate(rungs):
            if t >= milestone and \
                    self._trial_rung.get(trial_id, -1) < rung_idx:
                self._trial_rung[trial_id] = rung_idx
                values = self._rungs[(b, milestone)]
                values.append(self._norm(float(metric)))
                if len(values) >= self.eta:
                    keep = max(1, len(values) // self.eta)
                    cutoff = sorted(values, reverse=True)[keep - 1]
                    if self._norm(float(metric)) < cutoff:
                        decision = STOP
        return decision

    def on_trial_complete(self, trial_id: str):
        self._trial_rung.pop(trial_id, None)
        self._trial_bracket.pop(trial_id, None)


EXPLOIT = "EXPLOIT"


class PopulationBasedTraining:
    """PBT (parity: ``python/ray/tune/schedulers/pbt.py:1``).

    Every ``perturbation_interval`` iterations a trial compares itself
    against the population: bottom-quantile trials *exploit* (clone a
    top-quantile trial's checkpoint + config) and *explore* (mutate the
    cloned hyperparams — resample with ``resample_probability``, else
    perturb by 1.2x / 0.8x, or step within a list).  The controller
    enacts the decision by relaunching the trial from the donor's
    checkpoint with the mutated config.
    """

    def __init__(self, metric: Optional[str] = None, mode: str = "max",
                 time_attr: str = "training_iteration",
                 perturbation_interval: int = 5,
                 hyperparam_mutations: Optional[Dict] = None,
                 quantile_fraction: float = 0.25,
                 resample_probability: float = 0.25, seed: int = 0):
        import random
        self.metric = metric
        self.mode = mode
        self.time_attr = time_attr
        self.interval = perturbation_interval
        self.mutations = hyperparam_mutations or {}
        self.quantile = quantile_fraction
        self.resample_prob = resample_probability
        self._rng = random.Random(seed)
        self._scores: Dict[str, float] = {}
        self._configs: Dict[str, Dict] = {}
        self._last_perturb: Dict[str, int] = {}

    def _norm(self, value: float) -> float:
        return value if self.mode == "max" else -value

    def on_trial_add(self, trial_id: str, config: Dict) -> None:
        self._configs[trial_id] = dict(config)
        self._last_perturb.setdefault(trial_id, 0)

    def _mutate(self, config: Dict) -> Dict:
        out = dict(config)
        for key, spec in self.mutations.items():
            old = out.get(key)
            if isinstance(spec, list):
                if self._rng.random() < self.resample_prob \
                        or old not in spec:
                    out[key] = self._rng.choice(spec)
                else:  # step to a neighbour value
                    i = spec.index(old)
                    j = i + self._rng.choice((-1, 1))
                    out[key] = spec[max(0, min(len(spec) - 1, j))]
            elif callable(spec):
                if self._rng.random() < self.resample_prob \
                        or not isinstance(old, (int, float)):
                    out[key] = spec()
                else:
                    out[key] = old * self._rng.choice((0.8, 1.2))
            elif hasattr(spec, "sample"):  # tune.uniform etc.
                if self._rng.random() < self.resample_prob \
                        or not isinstance(old, (int, float)):
                    out[key] = spec.sample(self._rng)
                else:
                    out[key] = old * self._rng.choice((0.8, 1.2))
        return out

    def on_result(self, trial_id: str, result: Dict):
        t = result.get(self.time_attr)
        metric = result.get(self.metric) if self.metric else None
        if t is None or metric is None:
            return CONTINUE
        self._scores[trial_id] = self._norm(float(metric))
        self._configs.setdefault(trial_id, {}).update(
            result.get("config") or {})
        if t - self._last_perturb.get(trial_id, 0) < self.interval:
            return CONTINUE
        self._last_perturb[trial_id] = t
        population = sorted(self._scores, key=self._scores.get,
                            reverse=True)
        if len(population) < 2:
            return CONTINUE
        k = max(1, int(len(population) * self.quantile))
        top, bottom = population[:k], population[-k:]
        if trial_id not in bottom or trial_id in top:
            return CONTINUE
        src = self._rng.choice(top)
        new_config = self._mutate(self._configs.get(src, {}))
        return (EXPLOIT, src, new_config)

    def on_trial_complete(self, trial_id: str):
        self._scores.pop(trial_id, None)


class PB2(PopulationBasedTraining):
    """Population-Based Bandits (parity: ``tune/schedulers/pb2.py``).

    PBT with the random explore step replaced by a GP-bandit: observed
    (time, hyperparams) -> reward-improvement transitions from the whole
    population fit a Gaussian process, and the exploited trial's new
    config maximizes UCB within ``hyperparam_bounds`` — data-efficient
    mutation for small populations (Parker-Holder et al., NeurIPS '20).
    """

    def __init__(self, metric: Optional[str] = None, mode: str = "max",
                 time_attr: str = "training_iteration",
                 perturbation_interval: int = 5,
                 hyperparam_bounds: Optional[Dict] = None,
                 quantile_fraction: float = 0.25, seed: int = 0,
                 ucb_kappa: float = 2.0, n_candidates: int = 256):
        super().__init__(metric=metric, mode=mode, time_attr=time_attr,
                         perturbation_interval=perturbation_interval,
                         hyperparam_mutations={},
                         quantile_fraction=quantile_fraction, seed=seed)
        self.bounds = dict(hyperparam_bounds or {})
        self.kappa = ucb_kappa
        self.n_candidates = n_candidates
        # transition dataset: rows [t, *hyperparams] -> reward delta
        self._transitions: List = []
        self._last_metric: Dict[str, float] = {}

    def _record_transition(self, trial_id: str, t: float,
                           metric: float) -> None:
        prev = self._last_metric.get(trial_id)
        self._last_metric[trial_id] = metric
        if prev is None:
            return
        cfg = self._configs.get(trial_id, {})
        try:
            x = [float(t)] + [float(cfg[k]) for k in self.bounds]
        except (KeyError, TypeError, ValueError):
            return
        self._transitions.append((x, metric - prev))

    def on_result(self, trial_id: str, result: Dict):
        t = result.get(self.time_attr)
        metric = result.get(self.metric) if self.metric else None
        if t is not None and metric is not None:
            self._record_transition(trial_id, float(t),
                                    self._norm(float(metric)))
        return super().on_result(trial_id, result)

    def _mutate(self, config: Dict) -> Dict:
        """GP-UCB explore (overrides PBT's random perturbation)."""
        import numpy as np
        out = dict(config)
        keys = list(self.bounds)
        if not keys:
            return out
        lows = np.array([self.bounds[k][0] for k in keys], float)
        highs = np.array([self.bounds[k][1] for k in keys], float)
        span = np.maximum(highs - lows, 1e-12)
        rng = np.random.default_rng(self._rng.randrange(2 ** 31))
        cand = rng.uniform(size=(self.n_candidates, len(keys)))
        data = self._transitions[-256:]
        if len(data) >= 4:
            X = np.array([row for row, _ in data], float)
            y = np.array([dy for _, dy in data], float)
            # normalize: time to [0,1] over observed range, hps by bounds
            t0, t1 = X[:, 0].min(), max(X[:, 0].max(), X[:, 0].min() + 1)
            Xn = np.empty_like(X)
            Xn[:, 0] = (X[:, 0] - t0) / (t1 - t0)
            Xn[:, 1:] = (X[:, 1:] - lows) / span
            ystd = y.std() or 1.0
            yn = (y - y.mean()) / ystd
            ls, noise = 0.3, 1e-3
            K = _pb2_rbf(Xn, Xn, ls) + noise * np.eye(len(Xn))
            try:
                L = np.linalg.cholesky(K)
                alpha = np.linalg.solve(L.T, np.linalg.solve(L, yn))
                # candidates evaluated at the *next* time step (1.0)
                C = np.concatenate(
                    [np.ones((len(cand), 1)), cand], axis=1)
                Ks = _pb2_rbf(C, Xn, ls)
                mu = Ks @ alpha
                v = np.linalg.solve(L, Ks.T)
                var = np.maximum(1.0 - (v ** 2).sum(0), 1e-9)
                score = mu + self.kappa * np.sqrt(var)
                best = cand[int(np.argmax(score))]
            except np.linalg.LinAlgError:
                best = cand[0]
        else:
            best = cand[0]
        for i, k in enumerate(keys):
            val = lows[i] + best[i] * span[i]
            if isinstance(config.get(k), int):
                val = int(round(val))
            out[k] = val
        return out


def _pb2_rbf(a, b, ls):
    import numpy as np
    d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
    return np.exp(-0.5 * d2 / (ls * ls))
