"""Datasource read/create APIs.

Counterpart of ``ray_tpu/data/read_api.py`` (parity: Ray's
``python/ray/data/read_api.py``): ``range``, ``from_items``,
``from_numpy`` and the text, binary and ``.npy`` readers need nothing
but numpy; ``read_parquet``, ``read_csv`` and ``read_json`` read through
pyarrow (``pyarrow.parquet``, ``.csv`` and ``.json``, as the reference
reads them), ``from_arrow``/``from_pandas`` take their tables, and
``read_images`` reads through PIL, each imported only inside the call.
File reads run in tasks at execution time.
"""

from __future__ import annotations

import glob as _glob
import os
from typing import Any, Dict, List, Optional

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data.block import (_object_column, batch_to_block,
                                      from_arrow_table, require)
from ray_tpu_torch.data.dataset import Dataset


def _expand_paths(paths) -> List[str]:
    if isinstance(paths, str):
        paths = [paths]
    files: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            files.extend(sorted(
                f for f in _glob.glob(os.path.join(p, "**", "*"),
                                      recursive=True)
                if os.path.isfile(f)))
        elif any(c in p for c in "*?["):
            files.extend(sorted(_glob.glob(p)))
        else:
            files.append(p)
    if not files:
        raise FileNotFoundError(f"no files matched {paths}")
    return files


def range(n: int, *, override_num_blocks: Optional[int] = None) -> Dataset:
    blocks = override_num_blocks or min(max(1, n // 1000), 64)
    bounds = np.linspace(0, n, blocks + 1).astype(int)
    refs = []
    for i in np.arange(blocks):
        lo, hi = int(bounds[i]), int(bounds[i + 1])
        refs.append(ray_tpu_torch.put({"id": np.arange(lo, hi)}))
    return Dataset(refs)


def from_items(items: List[Any], *,
               override_num_blocks: Optional[int] = None) -> Dataset:
    if items and not isinstance(items[0], dict):
        items = [{"item": x} for x in items]
    blocks = override_num_blocks or min(max(1, len(items) // 1000), 16)
    parts = np.array_split(np.arange(len(items)), blocks)
    refs = [ray_tpu_torch.put(batch_to_block(
        [items[i] for i in part])) for part in parts if len(part)]
    if not refs:
        refs = [ray_tpu_torch.put({"item": _object_column([])})]
    return Dataset(refs)


def from_numpy(arr: np.ndarray, column: str = "data") -> Dataset:
    return Dataset([ray_tpu_torch.put(batch_to_block({column: arr}))])


def from_arrow(table) -> Dataset:
    return Dataset([ray_tpu_torch.put(from_arrow_table(table))])


def from_pandas(df) -> Dataset:
    require("pandas", "from_pandas")
    return Dataset([ray_tpu_torch.put(batch_to_block(df))])


# ------------------------------------------------------------ file readers
@ray_tpu_torch.remote(max_retries=3)
def _read_file_task(path: str, fmt: str, kwargs: Dict[str, Any]):
    if fmt == "parquet":
        pq = require("pyarrow.parquet", "read_parquet")
        return from_arrow_table(pq.read_table(path, **kwargs))
    if fmt == "csv":
        pacsv = require("pyarrow.csv", "read_csv")
        return from_arrow_table(pacsv.read_csv(path, **kwargs))
    if fmt == "json":
        pajson = require("pyarrow.json", "read_json")
        return from_arrow_table(pajson.read_json(path, **kwargs))
    if fmt == "text":
        with open(path) as f:
            lines = [line.rstrip("\n") for line in f]
        return {"text": _object_column(lines)}
    if fmt == "binary":
        with open(path, "rb") as f:
            data = f.read()
        return {"bytes": _object_column([data]),
                "path": _object_column([path])}
    if fmt == "numpy":
        arr = np.load(path)
        return batch_to_block({"data": arr})
    if fmt == "image":
        image = require("PIL.Image", "read_images")
        img = np.asarray(image.open(path))
        return batch_to_block({"image": img[None, ...]})
    raise ValueError(f"unknown format {fmt}")


def _read_files(paths, fmt: str, **kwargs) -> Dataset:
    files = _expand_paths(paths)
    refs = [_read_file_task.remote(f, fmt, kwargs) for f in files]
    return Dataset(refs)


def read_parquet(paths, **kwargs) -> Dataset:
    require("pyarrow.parquet", "read_parquet")
    return _read_files(paths, "parquet", **kwargs)


def read_csv(paths, **kwargs) -> Dataset:
    require("pyarrow.csv", "read_csv")
    return _read_files(paths, "csv", **kwargs)


def read_json(paths, **kwargs) -> Dataset:
    require("pyarrow.json", "read_json")
    return _read_files(paths, "json", **kwargs)


def read_text(paths, **kwargs) -> Dataset:
    return _read_files(paths, "text", **kwargs)


def read_binary_files(paths, **kwargs) -> Dataset:
    return _read_files(paths, "binary", **kwargs)


def read_numpy(paths, **kwargs) -> Dataset:
    return _read_files(paths, "numpy", **kwargs)


def read_images(paths, **kwargs) -> Dataset:
    require("PIL.Image", "read_images")
    return _read_files(paths, "image", **kwargs)
