"""Additional datasource connectors.

Counterpart of ``ray_tpu/data/connectors.py`` (parity targets under
Ray's ``python/ray/data``: ``read_webdataset``, ``read_sql``,
``from_torch`` / ``from_huggingface`` and the matching writers).  Each
builds numpy blocks; ``from_huggingface`` reads the dataset's arrow
table, importing pyarrow inside the call.
"""

from __future__ import annotations

import io
import json
import os
import tarfile
from typing import Any, Callable, Dict

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data.block import (BlockAccessor, Block, _object_column,
                                      batch_to_block, from_arrow_table)
from ray_tpu_torch.data.dataset import Dataset
from ray_tpu_torch.data.read_api import _expand_paths


# ------------------------------------------------------------ webdataset
def _decode_wds_sample(sample: Dict[str, bytes]) -> Dict[str, Any]:
    """Decode one webdataset sample by extension (the reference's
    subset of the auto-decoders: json/txt/cls decode, images stay
    bytes)."""
    out: Dict[str, Any] = {}
    for key, data in sample.items():
        ext = key.rsplit(".", 1)[-1]
        if ext == "json":
            out[key] = json.loads(data)
        elif ext in ("txt", "text"):
            out[key] = data.decode()
        elif ext in ("cls", "index"):
            out[key] = int(data)
        elif ext == "npy":
            out[key] = np.load(io.BytesIO(data))
        else:
            out[key] = data          # images etc: raw bytes
    return out


@ray_tpu_torch.remote(max_retries=3)
def _read_wds_shard(path: str) -> Block:
    """One tar shard -> one block.  Samples are files sharing a basename
    prefix: ``0001.jpg`` + ``0001.cls`` is one sample with two fields."""
    samples: Dict[str, Dict[str, bytes]] = {}
    with tarfile.open(path) as tf:
        for member in tf:
            if not member.isfile():
                continue
            base, _, ext = member.name.partition(".")
            fh = tf.extractfile(member)
            if fh is None:
                continue
            samples.setdefault(base, {"__key__": base.encode()})[ext] = \
                fh.read()
    rows = []
    for base in sorted(samples):
        raw = samples[base]
        key = raw.pop("__key__").decode()
        row = _decode_wds_sample(raw)
        row["__key__"] = key
        rows.append(row)
    return batch_to_block(rows) if rows else {}


def read_webdataset(paths) -> Dataset:
    """Read webdataset tar shards, one block per shard."""
    return Dataset([_read_wds_shard.remote(p)
                    for p in _expand_paths(paths)])


def write_webdataset(ds: Dataset, path: str) -> None:
    """Write each block as one tar shard; bytes columns become files
    named ``<row_key>.<column>``."""
    os.makedirs(path, exist_ok=True)
    for i, ref in enumerate(ds._execute()):
        block = ray_tpu_torch.get(ref, timeout=600)
        shard = os.path.join(path, f"shard-{i:05d}.tar")
        with tarfile.open(shard, "w") as tf:
            for r, row in enumerate(BlockAccessor(block).to_pylist()):
                key = str(row.pop("__key__", f"{i:05d}{r:06d}"))
                for col, value in row.items():
                    if isinstance(value, bytes):
                        data = value
                    elif isinstance(value, str):
                        data = value.encode()
                    else:
                        data = json.dumps(value).encode()
                        col = f"{col}.json" if "." not in col else col
                    info = tarfile.TarInfo(f"{key}.{col}")
                    info.size = len(data)
                    tf.addfile(info, io.BytesIO(data))


# ------------------------------------------------------------------ sql
def read_sql(sql: str, connection_factory: Callable[[], Any], *,
             override_num_blocks: int = 1) -> Dataset:
    """Read a DB-API 2.0 query result (parity: ``ray.data.read_sql``).
    ``connection_factory`` must be picklable (e.g. ``lambda:
    sqlite3.connect(path)``); the query runs inside a task."""

    @ray_tpu_torch.remote(max_retries=3)
    def _query() -> Block:
        conn = connection_factory()
        try:
            cur = conn.cursor()
            cur.execute(sql)
            cols = [d[0] for d in cur.description]
            rows = cur.fetchall()
        finally:
            conn.close()
        return batch_to_block([dict(zip(cols, r)) for r in rows]) \
            if rows else {c: _object_column([]) for c in cols}

    table_ref = _query.remote()
    if override_num_blocks <= 1:
        return Dataset([table_ref])
    acc = BlockAccessor(ray_tpu_torch.get(table_ref, timeout=600))
    rows = acc.num_rows()
    n = max(1, rows // override_num_blocks)
    refs = [ray_tpu_torch.put(acc.slice(off, min(off + n, rows)))
            for off in range(0, rows, n)]
    return Dataset(refs)


# ------------------------------------------------- framework ingestion
def from_torch(torch_dataset) -> Dataset:
    """Materialize a (map-style) ``torch.utils.data.Dataset``
    (parity: ``ray.data.from_torch``)."""
    def to_plain(v: Any) -> Any:
        if hasattr(v, "numpy"):                  # torch.Tensor
            v = v.numpy()
        if isinstance(v, np.ndarray):
            return v.tolist()
        return v

    rows = []
    for i in range(len(torch_dataset)):
        item = torch_dataset[i]
        if isinstance(item, dict):
            rows.append({k: to_plain(v) for k, v in item.items()})
        elif isinstance(item, (tuple, list)):
            rows.append({f"item_{j}": to_plain(v)
                         for j, v in enumerate(item)})
        else:
            rows.append({"item": to_plain(item)})
    if not rows:
        return Dataset([ray_tpu_torch.put({"item": _object_column([])})])
    return Dataset([ray_tpu_torch.put(batch_to_block(rows))])


def from_huggingface(hf_dataset) -> Dataset:
    """A 🤗 ``datasets.Dataset`` through its arrow table (parity:
    ``ray.data.from_huggingface``)."""
    try:
        table = hf_dataset.data.table
    except AttributeError as e:
        raise TypeError(
            "from_huggingface expects a `datasets.Dataset` (install the "
            "`datasets` package in the image)") from e
    return Dataset([ray_tpu_torch.put(
        from_arrow_table(table.combine_chunks()))])


# ---------------------------------------------------------------- write
def write_json(ds: Dataset, path: str) -> None:
    """One JSON-lines file per block (parity: ``Dataset.write_json``)."""
    os.makedirs(path, exist_ok=True)
    for i, ref in enumerate(ds._execute()):
        block = ray_tpu_torch.get(ref, timeout=600)
        with open(os.path.join(path, f"part-{i:05d}.jsonl"), "w") as f:
            for row in BlockAccessor(block).to_pylist():
                f.write(json.dumps(_json_row(row)) + "\n")


def _json_row(row: Dict[str, Any]) -> Dict[str, Any]:
    out = {}
    for k, v in row.items():
        if isinstance(v, np.ndarray):
            out[k] = v.tolist()
        elif isinstance(v, bytes):
            out[k] = v.hex()
        elif isinstance(v, np.generic):
            out[k] = v.item()
        else:
            out[k] = v
    return out


def write_numpy(ds: Dataset, path: str, column: str) -> None:
    """One ``.npy`` per block from ``column`` (parity:
    ``Dataset.write_numpy``)."""
    os.makedirs(path, exist_ok=True)
    for i, ref in enumerate(ds._execute()):
        col = ray_tpu_torch.get(ref, timeout=600)[column]
        np.save(os.path.join(path, f"part-{i:05d}.npy"), np.stack(col)
                if col.dtype == object else col)
