"""Reference attention: the oracle for all attention work in the port.

Port of ``dlrover_tpu/ops/attention_ref.py``: f32 logits, a
``finfo(float32).min`` mask, an f32 softmax whose probabilities are cast
to ``v.dtype`` for the second product, GQA by repeating KV heads, and
an optional additive ``bias``.
"""

from __future__ import annotations

from typing import Optional

import torch


def mha_reference(
    q: torch.Tensor,  # [B, H, S, D]
    k: torch.Tensor,  # [B, H_kv, S, D] (H_kv divides H)
    v: torch.Tensor,
    causal: bool = True,
    scale: Optional[float] = None,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    head_dim = q.shape[-1]
    scale = scale if scale is not None else 1.0 / (head_dim ** 0.5)
    if k.shape[1] != q.shape[1]:  # GQA: query head h reads kv head h // rep
        rep = q.shape[1] // k.shape[1]
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    # bf16 x bf16 products are exact in f32: upcasting first gives the
    # f32-accumulated logits the reference's preferred_element_type asks for
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias
    if causal:
        s_q, s_k = logits.shape[-2], logits.shape[-1]
        mask = torch.ones((s_q, s_k), dtype=torch.bool,
                          device=q.device).tril(s_k - s_q)
        logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype), v)
