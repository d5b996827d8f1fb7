"""Token sampling for the decode loop: greedy / temperature / top-k / top-p.

Counterpart of ``ray_tpu/inference/sampling.py``.  The masking is the
reference's ``_sample_one`` row for row, vectorised over the batch:
temperature scaling, a top-k threshold at the k-th largest logit, a
top-p nucleus mask computed on the sorted distribution and mapped back
by probability threshold, then a Gumbel argmax; ``temperature <= 0``
takes the plain argmax.  The returned logprob is ``log_softmax`` of the
raw f32 logits at the chosen id.

The Gumbel noise cannot be the reference's (``jax.random`` threefry
bits are not reproducible with torch's generators).  It is drawn per
row from a counter-based hash keyed by ``(seed, count)``, so a row's
tokens are a function of its own seed and generation count only, never
of its slot or its neighbours, and the same on the CPU and the card.
:func:`sample_from_noise` takes the noise as an argument so tests can
feed both packages the same noise.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling configuration.

    ``temperature <= 0`` is greedy.  ``top_k = 0`` disables the top-k
    filter; ``top_p = 1.0`` disables the nucleus filter.  ``spec``,
    ``spec_k`` and ``model_id`` mirror the JAX package's fields; the
    engine raises while speculative decoding and adapters are not
    ported."""
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0
    spec: Optional[bool] = None
    spec_k: Optional[int] = None
    model_id: Optional[str] = None


_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for x holding uint32 values in int64, split in
    16-bit halves so no product leaves int64's range."""
    lo = (x & 0xFFFF) * c
    hi = (((x >> 16) * c) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    """MurmurHash3's 32-bit finaliser (a bijection on uint32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def gumbel_noise(seeds: torch.Tensor, counts: torch.Tensor, V: int
                 ) -> torch.Tensor:
    """[B] seeds, [B] counts -> [B, V] f32 Gumbel noise; row b depends on
    (seeds[b], counts[b]) only."""
    key = _fmix32((_fmix32(seeds.long() & _M32)
                   + _mul32(counts.long() & _M32, 0x9E3779B9)) & _M32)
    idx = torch.arange(V, device=seeds.device, dtype=torch.int64)
    h = _fmix32((key[:, None] ^ _fmix32(_mul32(idx, 0x27D4EB2F)))
                & _M32)
    u = ((h >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))
    return -torch.log(-torch.log(u))


def sample_from_noise(logits, gumbel, temps, top_ks, top_ps
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits [B, V]; gumbel [B, V] f32; temps/top_ps [B] f32; top_ks
    [B] int -> (token ids [B] int64, chosen-token model logprobs [B]
    f32), each row computed as the reference's ``_sample_one``."""
    l = logits.float()
    V = l.shape[-1]
    greedy = l.argmax(-1)
    model_logp = torch.log_softmax(l, -1)
    z = l / temps.clamp_min(1e-6)[:, None]
    zs = torch.sort(z, -1, descending=True).values
    kth = zs.gather(1, (top_ks.long() - 1).clamp(0, V - 1)[:, None])
    z = torch.where((top_ks[:, None] > 0) & (z < kth), -torch.inf, z)
    probs = torch.softmax(z, -1)
    sp = torch.sort(probs, -1, descending=True).values
    cum = sp.cumsum(-1)
    keep = (cum - sp) < top_ps[:, None]
    thresh = torch.where(keep, sp, torch.inf).amin(-1, keepdim=True)
    z = torch.where(probs >= thresh, z, -torch.inf)
    sampled = (z + gumbel).argmax(-1)
    tok = torch.where(temps <= 0.0, greedy, sampled)
    return tok, model_logp.gather(1, tok[:, None])[:, 0]


def sample_tokens_logprobs(logits, seeds, counts, temps, top_ks, top_ps
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits [B, V] f32; seeds/counts/top_ks [B] int; temps/top_ps [B]
    f32 -> (token ids [B], chosen-token model logprobs [B]),
    row-independent."""
    g = gumbel_noise(seeds, counts, logits.shape[-1])
    return sample_from_noise(logits, g, temps, top_ks, top_ps)


def accept_drafts(sampled: Sequence[int], drafts: Sequence[int]
                  ) -> Tuple[int, List[int]]:
    """Accept/reject for one verify step, as the JAX package's
    ``accept_drafts``.

    ``sampled`` [k+1]: the token sampled at each verify row (row i
    conditioned on the drafts before it and drawn with the noise of
    ``(seed, count + i)``, i.e. exactly the token plain decode would
    produce at that position); ``drafts`` [k]: the drafter's proposals.
    Draft i is accepted iff every earlier draft was and ``sampled[i] ==
    drafts[i]``, so a full-prefix match reproduces the plain trajectory:
    greedy bit-exact, sampled trajectory-exact.

    Returns ``(n_accepted, sampled[:n_accepted + 1])``: the accepted
    drafts plus one more real token (the correction on a reject, the
    bonus row on a full accept)."""
    sampled = [int(t) for t in sampled]
    n_acc = 0
    for tok, draft in zip(sampled, drafts):
        if tok != int(draft):
            break
        n_acc += 1
    return n_acc, sampled[:n_acc + 1]
