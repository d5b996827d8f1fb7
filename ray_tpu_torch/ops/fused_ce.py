"""Cross-entropy over a large vocab with bf16 logit residuals.

Counterpart of ``ray_tpu/ops/fused_ce.py``: the no-remat CE
(``ce_mode="fused"``, ``ce_chunk < 0``) that keeps the [N, V] logits
alive between forward and backward in bf16 instead of f32, halving the
resident bytes and every pass over them.

- forward: ``logits = (x @ head)`` rounded to bf16 (f32 accumulation);
  the lse and true-logit reductions read the bf16 tensor in f32; exactly
  that bf16 tensor is saved.
- backward: ``p = exp(logits - lse)`` recomputed from the bf16 logits;
  ``dlogits = (p - onehot) * g`` rounded to bf16 feeds the two gradient
  matmuls (f32 accumulation, results in x's and head's dtypes).

lse and the loss accumulate in f32, as in the reference.  The reference
is plain XLA (no Pallas kernel), so the port is its plain PyTorch
formulation, not a kernel: the matmuls are cuBLAS on the card.  The
row-wise passes run over row blocks of ``_ROWS`` so the f32 transients
stay a block's size, not [N, V].
"""

from __future__ import annotations

import torch

# rows per block of the f32 row passes (lse, p - onehot): the transient
# is _ROWS x V f32, the saved logits stay [N, V] bf16
_ROWS = 4096


def _matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the two operands' promoted dtype (bf16 x bf16 stays
    bf16 with f32 accumulation; a f32 operand makes it f32)."""
    ct = torch.promote_types(a.dtype, b.dtype)
    return torch.matmul(a.to(ct), b.to(ct))


class _CESumBF16(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, head, targets):
        logits = _matmul(x, head).to(torch.bfloat16)        # [N, V]
        N = logits.shape[0]
        lse = torch.empty(N, dtype=torch.float32, device=x.device)
        for i in range(0, N, _ROWS):
            lse[i:i + _ROWS] = torch.logsumexp(
                logits[i:i + _ROWS].float(), -1)
        tgt = targets.clamp_min(0).long()
        true = logits.gather(1, tgt[:, None])[:, 0].float()
        mask = (targets >= 0).float()
        ctx.save_for_backward(x, head, targets, logits, lse)
        ctx.mark_non_differentiable(targets)
        return ((lse - true) * mask).sum(), mask.sum()

    @staticmethod
    def backward(ctx, gs, _gn):
        x, head, targets, logits, lse = ctx.saved_tensors
        N = logits.shape[0]
        scale = gs.float() * (targets >= 0).float()           # [N]
        tgt = targets.clamp_min(0).long()
        dl = torch.empty_like(logits)
        for i in range(0, N, _ROWS):
            p = torch.exp(logits[i:i + _ROWS].float()
                          - lse[i:i + _ROWS, None])
            rows = torch.arange(p.shape[0], device=p.device)
            p[rows, tgt[i:i + _ROWS]] -= 1.0                 # p - onehot
            p.mul_(scale[i:i + _ROWS, None])
            dl[i:i + _ROWS] = p.to(torch.bfloat16)
        dx = _matmul(dl, head.t()).to(x.dtype)
        dh = _matmul(x.t(), dl).to(head.dtype)
        return dx, dh, None


def ce_sum_bf16(x: torch.Tensor, head: torch.Tensor,
                targets: torch.Tensor):
    """x [N, d], head [d, V], targets [N] (-1 = masked) -> (sum_nll,
    n_valid) in f32, with the logits kept in bf16 for the backward."""
    return _CESumBF16.apply(x, head, targets)
