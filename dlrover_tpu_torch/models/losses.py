"""Shared loss functions (port of ``dlrover_tpu/models/losses.py``)."""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

IGNORE_INDEX = -100  # HF convention: masked label positions


def masked_lm_loss(logits: torch.Tensor, labels: torch.Tensor,
                   z_loss_weight: float = 0.0) -> torch.Tensor:
    """Causal-LM cross entropy with ``IGNORE_INDEX`` masking and optional
    z-loss on the logsumexp."""
    mask = (labels != IGNORE_INDEX).float()
    labels_safe = torch.where(labels == IGNORE_INDEX,
                              torch.zeros_like(labels), labels)
    logprobs = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logprobs, -1, labels_safe[..., None])[..., 0]
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = (nll * mask).sum() / denom
    if z_loss_weight > 0.0:
        z = torch.logsumexp(logits, dim=-1)
        loss = loss + z_loss_weight * ((z ** 2) * mask).sum() / denom
    return loss


def chunked_lm_head_loss(
    hidden: torch.Tensor,  # [B, S, D] final hidden states (compute dtype)
    kernel: torch.Tensor,  # [D, V] lm head
    labels: torch.Tensor,  # [B, S]
    chunk_size: int = 512,
    z_loss_weight: float = 0.0,
) -> torch.Tensor:
    """Fused lm-head + cross entropy over sequence chunks: each chunk's
    f32 logits exist only inside its checkpointed call and are
    recomputed in the backward, so the [B, S, V] logits never do."""
    b, s, d = hidden.shape
    if s % chunk_size:
        # largest divisor of S <= requested, as the reference
        chunk_size = min(chunk_size, s)
        while s % chunk_size:
            chunk_size -= 1
    kernel_c = kernel.to(hidden.dtype)

    def chunk_fn(xc, lc):
        logits = (xc @ kernel_c).float()  # [B, C, V]
        mask = (lc != IGNORE_INDEX).float()
        safe = torch.where(lc == IGNORE_INDEX, torch.zeros_like(lc), lc)
        logprobs = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logprobs, -1, safe[..., None])[..., 0]
        z_sum = torch.zeros((), device=hidden.device)
        if z_loss_weight > 0.0:
            z = torch.logsumexp(logits, dim=-1)
            z_sum = ((z ** 2) * mask).sum()
        return (nll * mask).sum(), mask.sum(), z_sum

    nll_sum = mask_sum = z_sum = torch.zeros((), device=hidden.device)
    for start in range(0, s, chunk_size):
        n, m, z = checkpoint(
            chunk_fn, hidden[:, start:start + chunk_size],
            labels[:, start:start + chunk_size], use_reentrant=False)
        nll_sum, mask_sum, z_sum = nll_sum + n, mask_sum + m, z_sum + z
    denom = torch.clamp(mask_sum, min=1.0)
    loss = nll_sum / denom
    if z_loss_weight > 0.0:
        loss = loss + z_loss_weight * z_sum / denom
    return loss
