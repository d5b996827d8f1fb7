"""Blocks: the unit of data movement.

Counterpart of ``ray_tpu/data/block.py``, whose block is a
``pyarrow.Table``.  The port's machines may have neither pyarrow nor
pandas, so its block is columnar numpy: a ``Dict[str, np.ndarray]``
whose columns all have the same number of rows.  A tensor column keeps
its trailing shape (``[n, 8]``, ``[n, 4, 4]``); strings, bytes and other
Python values live in object columns.  The dict pickles through the
object store (large numeric columns zero-copy).

:class:`BlockAccessor` has the reference's methods.  pyarrow and pandas
are imported only where a caller asks for their formats (``to_arrow``,
``to_pandas``, ``batch_format="pyarrow"``/``"pandas"``, ``from_arrow``),
and each raises an ``ImportError`` naming the missing package.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional

import numpy as np

Block = Dict[str, np.ndarray]


def require(package: str, what: str):
    """Import ``package`` for ``what``, or raise an ``ImportError`` that
    names it (the port's data path runs without it)."""
    import importlib
    try:
        return importlib.import_module(package)
    except ImportError as e:
        raise ImportError(
            f"{what} needs the {package.split('.')[0]!r} package, which is "
            "not installed; the port's blocks are numpy columns and need "
            "it only for this format") from e


class Schema:
    """Column names and their numpy dtypes (the reference returns a
    ``pyarrow.Schema``; ``names`` is what callers read)."""

    def __init__(self, names: List[str], types: List[np.dtype]):
        self.names = list(names)
        self.types = list(types)

    def __repr__(self) -> str:
        return "\n".join(f"{n}: {t}" for n, t in zip(self.names,
                                                      self.types))


def _object_column(values: List[Any]) -> np.ndarray:
    out = np.empty(len(values), dtype=object)
    for i, v in enumerate(values):
        out[i] = v
    return out


def column(values: Any) -> np.ndarray:
    """Values of one column -> its numpy array.  Numbers and arrays of
    one shape become a numeric (tensor) column; strings, bytes, ``None``
    and anything ragged an object column of the values themselves (a
    bytes column keeps trailing zero bytes, which numpy's ``S`` dtype
    would drop)."""
    if isinstance(values, np.ndarray):
        arr = values
    else:
        values = list(values)
        if any(v is None or isinstance(v, (str, bytes, dict))
               for v in values):
            return _object_column(values)
        try:
            arr = np.asarray(values)
        except ValueError:          # ragged nesting
            return _object_column(values)
        if arr.dtype == object and arr.ndim > 1:
            return _object_column(values)
    if arr.dtype.kind in "US":
        return _object_column(arr.tolist())
    if arr.ndim == 0:
        arr = arr.reshape(1)
    return arr


def _from_rows(rows: List[Dict[str, Any]]) -> Block:
    """Row dicts -> a block (``pa.Table.from_pylist``): columns in the
    order their keys first appear, a missing key is ``None``."""
    names: List[str] = []
    seen = set()
    for r in rows:
        for k in r:
            if k not in seen:
                seen.add(k)
                names.append(k)
    return {k: column([r.get(k) for r in rows]) for k in names}


def from_arrow_table(table) -> Block:
    """A ``pyarrow.Table`` -> a block, column by column as the
    reference's ``to_numpy`` reads them (a fixed-size list column
    becomes a 2-D tensor column)."""
    pa = require("pyarrow", "reading an arrow table")
    out: Block = {}
    for name in table.column_names:
        col = table.column(name)
        if pa.types.is_fixed_size_list(col.type):
            width = col.type.list_size
            flat = col.combine_chunks().flatten().to_numpy(
                zero_copy_only=False)
            out[name] = flat.reshape(-1, width)
        elif (pa.types.is_list(col.type)
              or pa.types.is_large_list(col.type)):
            out[name] = column(col.to_pylist())
        else:
            out[name] = column(col.to_numpy(zero_copy_only=False))
    return out


def _to_block(data: Any) -> Block:
    if isinstance(data, dict):
        return {k: column(v) for k, v in data.items()}
    if isinstance(data, list):
        if data and isinstance(data[0], dict):
            return _from_rows(data)
        return {"item": column(data)}
    mod = type(data).__module__.split(".")[0]
    if mod == "pyarrow":
        return from_arrow_table(data)
    if mod == "pandas":
        return {str(k): column(data[k].to_numpy()) for k in data.columns}
    raise TypeError(f"cannot convert {type(data)} to a block")


def num_rows(block: Block) -> int:
    for v in block.values():
        return len(v)
    return 0


class BlockAccessor:
    def __init__(self, block: Block):
        self.block = block

    @staticmethod
    def for_block(block: Any) -> "BlockAccessor":
        return BlockAccessor(_to_block(block))

    def num_rows(self) -> int:
        return num_rows(self.block)

    def size_bytes(self) -> int:
        total = 0
        for v in self.block.values():
            if v.dtype == object:
                total += sum(len(x) if isinstance(x, (str, bytes)) else 8
                             for x in v)
            else:
                total += v.nbytes
        return total

    def schema(self) -> Schema:
        return Schema(list(self.block), [v.dtype for v in
                                         self.block.values()])

    def to_arrow(self):
        pa = require("pyarrow", "to_arrow / batch_format='pyarrow'")
        cols = {}
        for k, v in self.block.items():
            if v.ndim > 1:
                flat = v.reshape(len(v), -1)
                cols[k] = pa.FixedSizeListArray.from_arrays(
                    pa.array(flat.ravel()), flat.shape[1])
            elif v.dtype == object:
                cols[k] = pa.array(v.tolist())
            else:
                cols[k] = pa.array(v)
        return pa.table(cols)

    def to_pandas(self):
        pd = require("pandas", "to_pandas / batch_format='pandas'")
        return pd.DataFrame({k: (list(v) if v.ndim > 1 else v)
                             for k, v in self.block.items()})

    def to_numpy(self, columns: Optional[List[str]] = None
                 ) -> Dict[str, np.ndarray]:
        return {name: self.block[name] for name in
                (columns or list(self.block))}

    def to_pylist(self) -> List[Dict[str, Any]]:
        names = list(self.block)
        cols = [self.block[k].tolist() for k in names]
        return [dict(zip(names, vals)) for vals in zip(*cols)]

    def slice(self, start: int, end: int) -> Block:
        return {k: v[start:end] for k, v in self.block.items()}

    def take_rows(self, indices) -> Block:
        idx = np.asarray(indices, dtype=np.int64)
        return {k: v[idx] for k, v in self.block.items()}

    def filter_mask(self, mask) -> Block:
        return {k: v[mask] for k, v in self.block.items()}

    def iter_batches(self, batch_size: Optional[int],
                     batch_format: str = "numpy") -> Iterator[Any]:
        n = self.num_rows()
        if batch_size is None or batch_size >= n:
            ranges = [(0, n)] if n else []
        else:
            ranges = [(i, min(i + batch_size, n))
                      for i in range(0, n, batch_size)]
        for start, end in ranges:
            yield format_batch(self.slice(start, end), batch_format)


def format_batch(block: Block, batch_format: str):
    acc = BlockAccessor(block)
    if batch_format in ("numpy", "default", None):
        return acc.to_numpy()
    if batch_format == "pandas":
        return acc.to_pandas()
    if batch_format in ("pyarrow", "arrow"):
        return acc.to_arrow()
    raise ValueError(f"unknown batch_format {batch_format!r}")


def batch_to_block(batch: Any) -> Block:
    return _to_block(batch)


def concat_blocks(blocks: List[Block]) -> Block:
    """Row-wise concatenation (``pa.concat_tables(promote_options=
    "default")``): blocks with no rows drop out, a column some block
    lacks is ``None`` there."""
    tables = [b for b in blocks if num_rows(b) > 0]
    if not tables:
        return blocks[0] if blocks else {}
    if len(tables) == 1:
        return tables[0]
    names: List[str] = []
    for b in tables:
        names.extend(k for k in b if k not in names)
    out: Block = {}
    for k in names:
        parts = [b[k] if k in b else _object_column([None] * num_rows(b))
                 for b in tables]
        if any(p.dtype == object for p in parts) and \
                not all(p.dtype == object for p in parts):
            parts = [p if p.dtype == object else _object_column(p.tolist())
                     for p in parts]
        out[k] = np.concatenate(parts)
    return out


def is_null(col: np.ndarray) -> np.ndarray:
    """The rows of ``col`` that hold no value: ``None`` in an object
    column (a numeric column has none)."""
    if col.dtype == object:
        return np.array([v is None for v in col], dtype=bool)
    return np.zeros(len(col), dtype=bool)


def arrow_sum(values: np.ndarray):
    """The sum ``pyarrow.compute.sum`` takes over one array chunk: for
    floats its pairwise summation (blocks of 16 summed in order, merged
    up a binary tree, arrow's ``SumArray``), so the result is
    bit-equal; integers sum exactly."""
    if values.dtype.kind != "f":
        total = 0
        for v in values.tolist():
            if v is not None:
                total += v
        return total
    x = values.astype(np.float64, copy=False)
    n = len(x)
    if n == 0:
        return 0.0
    full = n // 16
    block_sums: List[float] = []
    if full:
        m = x[:full * 16].reshape(full, 16)
        s = np.zeros(full, np.float64) + m[:, 0]
        for j in range(1, 16):
            s = s + m[:, j]
        block_sums.extend(s.tolist())
    if n % 16:
        s = 0.0
        for v in x[full * 16:].tolist():
            s += v
        block_sums.append(s)
    levels = int(n).bit_length()           # floor(log2 n) + 1
    sums = [0.0] * (levels + 1)
    mask = 0
    root = 0
    for block_sum in block_sums:
        level, bit = 0, 1
        sums[level] += block_sum
        mask ^= bit
        while (mask & bit) == 0:
            block_sum = sums[level]
            sums[level] = 0.0
            level += 1
            bit <<= 1
            sums[level] += block_sum
            mask ^= bit
        root = max(root, level)
    for i in range(1, root + 1):
        sums[i] += sums[i - 1]
    return sums[root]

