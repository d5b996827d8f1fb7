"""``ray_tpu_torch.util`` — fault injection (:mod:`.chaos`) and the local
span recorder (:mod:`.tracing`)."""
