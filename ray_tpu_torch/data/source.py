"""Document shard sources for the streaming training data plane.

The port's copy of ``ray_tpu/data/source.py``: documents come from the
same blake2b-seeded numpy ``RandomState``, so every document, and every
batch packed from them, is bit-equal to the reference's.

A :class:`DocumentSource` is the deterministic substrate everything
upstream of the packer stands on: ``num_shards`` ordered shards, each an
ordered list of token sequences, addressed by ``(shard, index)``.
``read(shard, start, count)`` is a **pure function** — same arguments,
same documents, every process, every time.  That purity is the whole
robustness story: a reader that dies mid-fetch is restarted and the
fetch re-issued verbatim with exactly-once semantics for free, and the
stream cursor (per-shard offsets + packer residue) pins the entire
batch sequence.

Documents carry a globally unique ``doc_id`` (``shard * stride + index``)
so the chaos fuzz can assert no-drop/no-dup sample accounting across
kills and resumes.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

Doc = Tuple[int, np.ndarray]     # (doc_id, tokens int32 [n])


class DocumentSource:
    """Base: ordered shards of ordered token documents.

    Subclasses implement :meth:`docs_in_shard` and :meth:`read`; both
    must be pure (no hidden per-process state) — the data plane
    re-issues reads after reader deaths and replays them after
    cross-process resume.
    """

    num_shards: int = 1

    def docs_in_shard(self, shard: int) -> int:
        raise NotImplementedError

    def read(self, shard: int, start: int, count: int) -> List[Doc]:
        """Documents ``[start, start+count)`` of ``shard`` (short reads
        at shard end are fine; past-the-end reads return [])."""
        raise NotImplementedError

    def doc_stride(self) -> int:
        """doc_id = shard * stride + index; stride bounds any shard."""
        return max((self.docs_in_shard(s)
                    for s in range(self.num_shards)), default=1)

    def total_docs(self) -> int:
        return sum(self.docs_in_shard(s) for s in range(self.num_shards))


class SyntheticDocs(DocumentSource):
    """Deterministic synthetic corpus: ``doc(shard, idx)`` is a pure
    function of ``(seed, shard, idx)`` — the host-sim stand-in for a
    tokenized web corpus, with variable document lengths so the packer
    has real work (padding to reclaim).

    Lengths and contents derive from a blake2b-seeded ``RandomState``
    per document, so any document is addressable without materializing
    its shard.
    """

    def __init__(self, seed: int = 0, *, num_shards: int = 4,
                 docs_per_shard: int = 64, vocab: int = 256,
                 min_len: int = 4, max_len: int = 24):
        if num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {num_shards}")
        if not (1 <= min_len <= max_len):
            raise ValueError(f"need 1 <= min_len <= max_len, got "
                             f"{min_len}..{max_len}")
        self.seed = int(seed)
        self.num_shards = int(num_shards)
        self.docs_per_shard = int(docs_per_shard)
        self.vocab = int(vocab)
        self.min_len = int(min_len)
        self.max_len = int(max_len)

    def docs_in_shard(self, shard: int) -> int:
        return self.docs_per_shard if 0 <= shard < self.num_shards else 0

    def doc_stride(self) -> int:
        return self.docs_per_shard

    def _doc(self, shard: int, idx: int) -> np.ndarray:
        h = hashlib.blake2b(
            f"{self.seed}/{shard}/{idx}".encode(), digest_size=4)
        rng = np.random.RandomState(
            int.from_bytes(h.digest(), "little"))
        n = int(rng.randint(self.min_len, self.max_len + 1))
        return rng.randint(0, self.vocab, n).astype(np.int32)

    def read(self, shard: int, start: int, count: int) -> List[Doc]:
        end = min(start + count, self.docs_in_shard(shard))
        return [(shard * self.docs_per_shard + i, self._doc(shard, i))
                for i in range(start, end)]


class TokenFileSource(DocumentSource):
    """Pre-tokenized corpus on disk: one ``.jsonl`` file per shard,
    one JSON token list per line (the layout ``write_token_shards``
    emits).  Files are read lazily per fetch — a reader actor holds no
    shard state beyond the path list, so restarting one is free."""

    def __init__(self, paths: Sequence[str]):
        if not paths:
            raise ValueError("TokenFileSource needs at least one shard "
                             "file")
        self.paths = [str(p) for p in paths]
        self.num_shards = len(self.paths)
        # byte offset of each document line, built on the shard's first
        # touch — chunked fetches then seek directly instead of
        # rescanning from line 0 (O(shard) per epoch, not O(shard^2))
        self._offsets: List[Optional[List[int]]] = \
            [None] * self.num_shards
        self._stride: Optional[int] = None

    def _shard_offsets(self, shard: int) -> List[int]:
        if self._offsets[shard] is None:
            offsets: List[int] = []
            with open(self.paths[shard], "rb") as f:
                pos = f.tell()
                for line in f:
                    if line.strip():
                        offsets.append(pos)
                    pos = f.tell()
            self._offsets[shard] = offsets
        return self._offsets[shard]

    def docs_in_shard(self, shard: int) -> int:
        if not (0 <= shard < self.num_shards):
            return 0
        return len(self._shard_offsets(shard))

    def doc_stride(self) -> int:
        # the stride (max shard size) needs every shard's count once;
        # cache it so per-fetch id assignment doesn't re-touch the
        # whole corpus (each shard file is still scanned at most once
        # per process, for its offset index)
        if self._stride is None:
            self._stride = super().doc_stride()
        return self._stride

    def read(self, shard: int, start: int, count: int) -> List[Doc]:
        stride = self.doc_stride()
        offsets = self._shard_offsets(shard)
        out: List[Doc] = []
        with open(self.paths[shard], "rb") as f:   # offsets are binary
            for idx in range(start, min(start + count, len(offsets))):
                f.seek(offsets[idx])
                toks = np.asarray(json.loads(f.readline()), np.int32)
                out.append((shard * stride + idx, toks))
        return out


def write_token_shards(directory: str, shards: Sequence[Sequence[Sequence[int]]]
                       ) -> List[str]:
    """Write ``shards`` (list of shards, each a list of token lists) as
    ``shard_NNN.jsonl`` files; returns the paths for
    :class:`TokenFileSource`."""
    os.makedirs(directory, exist_ok=True)
    paths = []
    for s, docs in enumerate(shards):
        p = os.path.join(directory, f"shard_{s:03d}.jsonl")
        with open(p, "w") as f:
            for doc in docs:
                f.write(json.dumps([int(t) for t in doc]) + "\n")
        paths.append(p)
    return paths
