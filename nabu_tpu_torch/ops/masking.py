"""Sequence masking utilities.

Everything stays densely padded and ops mask by length. ``NEG_INF`` is
the finite large negative the JAX package masks with; fp16 cannot hold
it, so the port computes in f32 or bf16 only, never fp16.
"""

from __future__ import annotations

import torch

NEG_INF = -1.0e30


def sequence_mask(lengths: torch.Tensor, maxlen: int) -> torch.Tensor:
    """[B] int lengths -> [B, maxlen] bool validity mask."""
    pos = torch.arange(maxlen, dtype=lengths.dtype, device=lengths.device)
    return pos[None, :] < lengths[:, None]


def mask_logits(logits: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Set masked-out positions to ``NEG_INF`` (pre-softmax), in the
    logits' dtype."""
    return torch.where(mask, logits, torch.full((), NEG_INF, dtype=logits.dtype,
                                                device=logits.device))
