"""``ray_tpu_torch.resilience`` — the engine watchdog (:mod:`.watchdog`);
checkpointing and elastic training come with ROADMAP Queue 1 item 10."""

from ray_tpu_torch.resilience.watchdog import EngineWatchdog  # noqa: F401

__all__ = ["EngineWatchdog"]
