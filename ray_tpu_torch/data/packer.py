"""Sample packing: documents -> fixed ``[B, S]`` batches with
segment-aware masking.

The port's copy of ``ray_tpu/data/packer.py`` (numpy, so its batches
are bit-equal to the reference's).  A padded-per-document batch wastes
every pad position's FLOPs, so the packer fills each ``[S]`` row with as many whole documents as
fit, and the attention mask (threaded through ``models/gpt.py`` /
``ops/attention.py`` as ``segment_ids``) keeps co-packed documents
from attending to each other.  Each batch carries:

- ``tokens``      [B, S] int32 — concatenated documents, 0-padded;
- ``targets``     [B, S] int32 — next token *within the same segment*;
  the last position of every document and all padding are ``-1`` (the
  CE masking convention);
- ``segment_ids`` [B, S] int32 — 1-based per-row document index, 0 on
  padding (the attention-mask key: attend iff equal and nonzero);
- ``positions``   [B, S] int32 — position *within the document* (RoPE
  restarts at every document start), 0 on padding.

Determinism/robustness contract: the packer is a plain state machine
over an ordered document stream — its full state (open rows + the
partial row) serializes into the stream cursor via :meth:`state_dict`
/ :meth:`load_state`, so a resumed stream rebuilds mid-batch residue
exactly and replays the identical batch sequence.  Documents longer
than ``S`` are truncated to ``S`` (counted in ``truncated``); a
document is never split across rows — exactly-once accounting stays
document-granular.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class PackedBatch:
    """One assembled batch plus the bookkeeping the tests audit."""
    tokens: np.ndarray        # [B, S] int32
    targets: np.ndarray       # [B, S] int32 (-1 = masked)
    segment_ids: np.ndarray   # [B, S] int32 (0 = pad)
    positions: np.ndarray     # [B, S] int32
    # (row, col, doc_id, n_tokens) per packed document — the
    # exactly-once audit trail, host-side only
    spans: List[Tuple[int, int, int, int]]

    @property
    def packed_tokens(self) -> int:
        """Non-pad tokens in the batch (the FLOPs actually spent on
        data; pad positions are the reclaimable waste)."""
        return int((self.segment_ids > 0).sum())

    def as_train_batch(self, *, with_segments: bool = True
                       ) -> Dict[str, np.ndarray]:
        """The train-step batch dict.  ``with_segments=False`` (the
        unpacked one-doc-per-row arm) omits ``segment_ids``/
        ``positions``: trailing padding behind a single causal segment
        is already unreachable and its targets are ``-1``, so the
        plain-batch pytree works everywhere — including the pipeline-
        parallel and overlap trainers that decline the mask."""
        if not with_segments:
            return {"tokens": self.tokens, "targets": self.targets}
        return {"tokens": self.tokens, "targets": self.targets,
                "segment_ids": self.segment_ids,
                "positions": self.positions}


class SamplePacker:
    """Greedy whole-document packer with serializable residue.

    ``add(doc_id, tokens)`` feeds one document; ``ready`` /
    ``pop_batch()`` emit once ``batch_size`` rows have closed.  A row
    closes only when the next document does not fit (greedy,
    deterministic); ``flush()`` force-closes the residue at end of
    stream.  ``pack=False`` gives every document its own row — the
    unpacked A/B arm, same interface.
    """

    def __init__(self, batch_size: int, seq_len: int, *,
                 pack: bool = True):
        if batch_size < 1 or seq_len < 2:
            raise ValueError(f"need batch_size >= 1 and seq_len >= 2, "
                             f"got B={batch_size} S={seq_len}")
        self.B = int(batch_size)
        self.S = int(seq_len)
        self.pack = bool(pack)
        self.truncated = 0
        # closed rows waiting for a full batch; each row is a list of
        # (doc_id, [tokens...]) segments
        self._rows: List[List[Tuple[int, List[int]]]] = []
        self._cur: List[Tuple[int, List[int]]] = []
        self._cur_len = 0

    # ----------------------------------------------------------- feed
    def _close_row(self) -> None:
        self._rows.append(self._cur)
        self._cur = []
        self._cur_len = 0

    def add(self, doc_id: int, tokens: np.ndarray) -> None:
        toks = [int(t) for t in tokens[:self.S]]
        if len(tokens) > self.S:
            self.truncated += 1
        if not toks:
            return
        if not self.pack:
            self._rows.append([(int(doc_id), toks)])
            return
        if self._cur_len + len(toks) > self.S:
            self._close_row()
        self._cur.append((int(doc_id), toks))
        self._cur_len += len(toks)

    def flush(self) -> None:
        """End of stream: close the partial row so a final short batch
        can drain (padded with all-pad rows by :meth:`pop_batch`)."""
        if self._cur:
            self._close_row()

    # ----------------------------------------------------------- emit
    @property
    def ready(self) -> bool:
        return len(self._rows) >= self.B

    def pending_rows(self) -> int:
        return len(self._rows) + (1 if self._cur else 0)

    def pop_batch(self, *, allow_partial: bool = False
                  ) -> Optional[PackedBatch]:
        """Assemble ``[B, S]`` arrays from the oldest ``B`` closed rows
        (``allow_partial`` pads the batch with empty rows — the
        end-of-stream drain)."""
        if not self.ready and not (allow_partial and self._rows):
            return None
        rows, self._rows = self._rows[:self.B], self._rows[self.B:]
        B, S = self.B, self.S
        tokens = np.zeros((B, S), np.int32)
        targets = np.full((B, S), -1, np.int32)
        segment_ids = np.zeros((B, S), np.int32)
        positions = np.zeros((B, S), np.int32)
        spans: List[Tuple[int, int, int, int]] = []
        for r, row in enumerate(rows):
            col = 0
            for seg, (doc_id, toks) in enumerate(row, start=1):
                n = len(toks)
                tokens[r, col:col + n] = toks
                targets[r, col:col + n - 1] = toks[1:]
                segment_ids[r, col:col + n] = seg
                positions[r, col:col + n] = np.arange(n)
                spans.append((r, col, doc_id, n))
                col += n
        return PackedBatch(tokens, targets, segment_ids, positions,
                           spans)

    # ---------------------------------------------------------- cursor
    def state_dict(self) -> Dict[str, Any]:
        """JSON-able residue: closed-but-unemitted rows + the partial
        row + the truncation counter (everything a resumed stream
        needs to replay the identical next batch)."""
        return {
            "rows": [[[d, list(t)] for d, t in row]
                     for row in self._rows],
            "cur": [[d, list(t)] for d, t in self._cur],
            "truncated": self.truncated,
        }

    def load_state(self, state: Dict[str, Any]) -> None:
        self._rows = [[(int(d), [int(x) for x in t]) for d, t in row]
                      for row in state.get("rows", [])]
        self._cur = [(int(d), [int(x) for x in t])
                     for d, t in state.get("cur", [])]
        self._cur_len = sum(len(t) for _, t in self._cur)
        self.truncated = int(state.get("truncated", 0))
