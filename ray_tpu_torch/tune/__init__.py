# The port's copy of ray_tpu/tune/__init__.py
"""``ray_tpu_torch.tune`` — hyperparameter tuning (parity: ``ray.tune``)."""

from typing import Any, Callable, Dict, Optional

from ray_tpu_torch.train.session import get_checkpoint, get_context
from ray_tpu_torch.train.session import report as _train_report
from ray_tpu_torch.tune.schedulers import (ASHAScheduler, FIFOScheduler,
                                           HyperBandScheduler,
                                           MedianStoppingRule,
                                           PB2,
                                           PopulationBasedTraining)
from ray_tpu_torch.tune.search.bayesopt import GPSearcher
from ray_tpu_torch.tune.search.sample import (choice, grid_search, loguniform,
                                              quniform, randint, sample_from,
                                              uniform)
from ray_tpu_torch.tune.search.searcher import BasicVariantGenerator, Searcher
from ray_tpu_torch.tune.search.tpe import TPESearcher
from ray_tpu_torch.tune.trainable import Trainable
from ray_tpu_torch.tune.tuner import ResultGrid, TuneConfig, Tuner


def report(metrics: Dict[str, Any], *, checkpoint=None) -> None:
    """Report metrics from inside a trial (parity: ``ray.tune.report``)."""
    _train_report(metrics, checkpoint=checkpoint)


def with_resources(trainable: Callable,
                   resources: Dict[str, float]) -> Callable:
    trainable._tune_resources = dict(resources)
    return trainable


def with_parameters(trainable: Callable, **params) -> Callable:
    import functools

    @functools.wraps(trainable)
    def wrapped(config):
        return trainable(config, **params)

    if hasattr(trainable, "_tune_resources"):
        wrapped._tune_resources = trainable._tune_resources
    return wrapped


def run(trainable: Callable, *, config: Optional[Dict] = None,
        num_samples: int = 1, metric: Optional[str] = None,
        mode: str = "max", scheduler=None, name: Optional[str] = None,
        storage_path: Optional[str] = None, **kwargs) -> ResultGrid:
    """Classic ``tune.run`` entrypoint built on Tuner."""
    from ray_tpu_torch.train.config import RunConfig
    tuner = Tuner(
        trainable,
        param_space=config or {},
        tune_config=TuneConfig(metric=metric, mode=mode,
                               num_samples=num_samples,
                               scheduler=scheduler),
        run_config=RunConfig(name=name, storage_path=storage_path))
    return tuner.fit()


__all__ = [
    "Tuner", "TuneConfig", "ResultGrid", "report", "get_context",
    "get_checkpoint", "choice", "uniform", "loguniform", "randint",
    "quniform", "sample_from", "grid_search", "with_resources",
    "with_parameters", "run", "ASHAScheduler", "FIFOScheduler",
    "HyperBandScheduler", "MedianStoppingRule",
    "PB2", "PopulationBasedTraining", "Searcher", "BasicVariantGenerator",
    "TPESearcher", "GPSearcher",
]
