"""Additional Dataset connectors.

Counterpart of ``ray_tpu/data/io_extra.py`` (parity: Ray's
``python/ray/data/read_api.py`` ``range_tensor`` and the
``datasource/`` writers): ``range_tensor`` and the TFRecord reader and
writer are plain Python; ``write_parquet``/``write_csv`` write through
pyarrow, imported inside the call.  Writers fan out one task per block.
"""

from __future__ import annotations

import os
import struct
from typing import List, Optional

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data.block import BlockAccessor, _object_column, require
from ray_tpu_torch.data.dataset import Dataset


def range_tensor(n: int, *, shape=(1,),
                 override_num_blocks: Optional[int] = None) -> Dataset:
    """Rows ``{"data": values, "__shape__": shape}`` with arange values,
    ``data`` flattened as the reference stores it (parity:
    ``ray.data.range_tensor``)."""
    blocks = override_num_blocks or min(max(1, n // 10_000), 32)
    parts = np.array_split(np.arange(n, dtype=np.int64), blocks)
    width = int(np.prod(shape))
    refs = []
    for p in parts:
        if not len(p):
            continue
        refs.append(ray_tpu_torch.put({
            "data": np.repeat(p[:, None], width, axis=1),
            "__shape__": np.tile(np.asarray(shape, np.int64), (len(p), 1))}))
    if not refs:
        refs = [ray_tpu_torch.put({"data": _object_column([])})]
    return Dataset(refs)


@ray_tpu_torch.remote(max_retries=3)
def _write_parquet_block(block, path: str) -> str:
    pq = require("pyarrow.parquet", "write_parquet")
    pq.write_table(BlockAccessor(block).to_arrow(), path)
    return path


@ray_tpu_torch.remote(max_retries=3)
def _write_csv_block(block, path: str) -> str:
    pacsv = require("pyarrow.csv", "write_csv")
    pacsv.write_csv(BlockAccessor(block).to_arrow(), path)
    return path


def write_parquet(ds: Dataset, path: str) -> List[str]:
    """One parquet file per block under ``path`` (parity:
    ``Dataset.write_parquet``)."""
    require("pyarrow.parquet", "write_parquet")
    os.makedirs(path, exist_ok=True)
    refs = [
        _write_parquet_block.remote(
            ref, os.path.join(path, f"part-{i:05d}.parquet"))
        for i, ref in enumerate(ds._execute())]
    return ray_tpu_torch.get(refs, timeout=600)


def write_csv(ds: Dataset, path: str) -> List[str]:
    """One csv file per block under ``path``."""
    require("pyarrow.csv", "write_csv")
    os.makedirs(path, exist_ok=True)
    refs = [
        _write_csv_block.remote(
            ref, os.path.join(path, f"part-{i:05d}.csv"))
        for i, ref in enumerate(ds._execute())]
    return ray_tpu_torch.get(refs, timeout=600)


# ---------------------------------------------------------- TFRecord ----
# Wire format (no TF dependency): each record is
#   uint64 length | uint32 masked-crc(length) | bytes | uint32 crc(bytes)
# The framing is read and written directly; payloads are raw bytes rows
# (``{"bytes": ...}``), tf.data's record-level view.  The CRC is crc32c
# when the ``crc32c`` module is importable, else zlib's crc32 (the
# reference's fallback, so both write the same bytes), and is NOT
# verified on read (tf.io's default).

def _masked_crc(data: bytes) -> int:
    try:
        import crc32c  # type: ignore
        crc = crc32c.crc32c(data)
    except Exception:  # noqa: BLE001 — deterministic fallback
        import zlib
        crc = zlib.crc32(data)
    return ((((crc >> 15) | (crc << 17)) + 0xa282ead8) & 0xFFFFFFFF)


@ray_tpu_torch.remote(max_retries=3)
def _read_tfrecord_file(path: str):
    records = []
    with open(path, "rb") as f:
        while True:
            head = f.read(8)
            if len(head) < 8:
                break
            (length,) = struct.unpack("<Q", head)
            f.read(4)                      # length crc (unverified)
            payload = f.read(length)
            f.read(4)                      # data crc (unverified)
            if len(payload) < length:
                break
            records.append(payload)
    return {"bytes": _object_column(records)}


def read_tfrecords(paths) -> Dataset:
    """TFRecord files -> rows ``{"bytes": record}`` (parity:
    ``ray.data.read_tfrecords`` at the record level; decode Examples
    with ``map_batches`` and your schema)."""
    if isinstance(paths, str):
        paths = [paths]
    expanded: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            expanded.extend(
                os.path.join(p, n) for n in sorted(os.listdir(p)))
        else:
            expanded.append(p)
    return Dataset([_read_tfrecord_file.remote(p) for p in expanded])


@ray_tpu_torch.remote(max_retries=3)
def _write_tfrecord_block(block, path: str) -> str:
    acc = BlockAccessor.for_block(block)
    with open(path, "wb") as f:
        for row in acc.to_pylist():
            payload = row.get("bytes")
            if payload is None:
                import json
                payload = json.dumps(row).encode()
            head = struct.pack("<Q", len(payload))
            f.write(head)
            f.write(struct.pack("<I", _masked_crc(head)))
            f.write(payload)
            f.write(struct.pack("<I", _masked_crc(payload)))
    return path


def write_tfrecords(ds: Dataset, path: str) -> List[str]:
    os.makedirs(path, exist_ok=True)
    refs = [
        _write_tfrecord_block.remote(
            ref, os.path.join(path, f"part-{i:05d}.tfrecords"))
        for i, ref in enumerate(ds._execute())]
    return ray_tpu_torch.get(refs, timeout=600)
