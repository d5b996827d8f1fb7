"""``ray_tpu_torch.data`` — the streaming training data plane: document
shard sources (:mod:`.source`), sample packing (:mod:`.packer`), and the
deterministic, preemption-proof stream with its cursor, readers and
double-buffered loader (:mod:`.stream`); knobs in :mod:`.config`.

Counterpart of the data-plane half of ``ray_tpu/data``.  The
``ray.data`` parity half (``Dataset``, the streaming executor, the
readers and connectors) is ROADMAP Queue 1 item 10b."""

from ray_tpu_torch.data.config import DataConfig, data_config
from ray_tpu_torch.data.packer import PackedBatch, SamplePacker
from ray_tpu_torch.data.source import (DocumentSource, SyntheticDocs,
                                       TokenFileSource, write_token_shards)
from ray_tpu_torch.data.stream import (DataPlaneError, StreamBatch,
                                       StreamCursor, StreamingLoader)

__all__ = [
    "DataConfig", "data_config",
    "DocumentSource", "SyntheticDocs", "TokenFileSource",
    "write_token_shards",
    "SamplePacker", "PackedBatch",
    "StreamCursor", "StreamBatch", "StreamingLoader", "DataPlaneError",
]
