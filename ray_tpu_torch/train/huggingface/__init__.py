"""``ray_tpu_torch.train.huggingface``: HF Transformers fine-tuning on
the card (counterpart of ``ray_tpu/train/huggingface``).

An HF GPT-2 checkpoint is ported once into the port's GPT in its
exact-architecture mode (``weights.port_gpt2``) and trained through
``build_gpt_train`` in ``TorchTrainer`` workers
(``transformers_trainer.py``).  ``transformers`` is imported only by the
calls that take an HF model.
"""

from ray_tpu_torch.train.huggingface.transformers_trainer import (
    TransformersTrainer)
from ray_tpu_torch.train.huggingface.weights import (export_gpt2,
                                                     gpt2_config,
                                                     load_model, port_gpt2)

__all__ = ["TransformersTrainer", "port_gpt2", "export_gpt2",
           "gpt2_config", "load_model"]
