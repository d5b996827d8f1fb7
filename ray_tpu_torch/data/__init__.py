"""``ray_tpu_torch.data`` — distributed datasets (parity: ``ray.data``)
and the streaming training data plane.

Counterpart of ``ray_tpu/data``, with the same names:

- the ``ray.data`` half: :class:`Dataset` over numpy blocks
  (:mod:`.block`), the streaming executor, ``streaming_split`` and its
  :class:`DataIterator` (the trainer's ingest, with
  ``iter_torch_batches`` landing batches on the card), the readers and
  the connectors.  It needs no pyarrow and no pandas: they are imported
  only by the calls that read or return their formats;
- the data plane: document shard sources (:mod:`.source`), sample
  packing (:mod:`.packer`), and the deterministic, preemption-proof
  stream with its cursor, readers and double-buffered loader
  (:mod:`.stream`); knobs in :mod:`.config`.
"""

from ray_tpu_torch.data.block import Block, BlockAccessor
from ray_tpu_torch.data.config import DataConfig, data_config
from ray_tpu_torch.data.connectors import (from_huggingface, from_torch,
                                           read_sql, read_webdataset)
from ray_tpu_torch.data.context import DataContext
from ray_tpu_torch.data.dataset import Dataset, GroupedData
from ray_tpu_torch.data.io_extra import range_tensor, read_tfrecords
from ray_tpu_torch.data.iterator import DataIterator
from ray_tpu_torch.data.packer import PackedBatch, SamplePacker
from ray_tpu_torch.data.read_api import (from_arrow, from_items, from_numpy,
                                         from_pandas, range,
                                         read_binary_files, read_csv,
                                         read_images, read_json,
                                         read_numpy, read_parquet,
                                         read_text)
from ray_tpu_torch.data.source import (DocumentSource, SyntheticDocs,
                                       TokenFileSource, write_token_shards)
from ray_tpu_torch.data.stream import (DataPlaneError, StreamBatch,
                                       StreamCursor, StreamingLoader)

__all__ = [
    "Block", "BlockAccessor", "DataContext", "Dataset", "DataIterator",
    "GroupedData",
    "range", "range_tensor",
    "from_items", "from_numpy", "from_arrow", "from_pandas",
    "from_torch", "from_huggingface",
    "read_parquet", "read_csv", "read_json", "read_text",
    "read_binary_files", "read_numpy", "read_images",
    "read_webdataset", "read_sql", "read_tfrecords",
    # streaming training data plane
    "DataConfig", "data_config",
    "DocumentSource", "SyntheticDocs", "TokenFileSource",
    "write_token_shards",
    "SamplePacker", "PackedBatch",
    "StreamCursor", "StreamBatch", "StreamingLoader", "DataPlaneError",
]
