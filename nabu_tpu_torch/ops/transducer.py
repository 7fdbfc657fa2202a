"""RNN-T (transducer) loss over a materialized joint lattice, plain torch.

Port of the JAX package's ``ops/transducer.py``. The forward variable

    alpha[t, u] = logaddexp(alpha[t-1, u] + blank[t-1, u],
                            alpha[t,   u-1] + emit[t, u-1])

is closed out per time step: with ``base[u] = alpha[t-1, u] + blank[t-1,
u]`` and ``e[u] = emit[t, u-1]``,

    alpha[t, u] = E[u] + cumlogsumexp(base - E)[u],   E = cumsum(e),

so one loop over T does a whole [B, U+1] row per step. Gradients come from
autograd through that loop. Emit log-probs at u >= target_length are
masked to the finite ``NEG`` (not -inf: E picks the mask up through the
cumsum and ``base - E`` would form inf - inf).

This is the CPU path of a transducer head with ``use_pallas = false`` and
the oracle of the fused joint+loss kernels (``ops.transducer_fused``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG = -1e9  # "log zero" that is safe under cumsum/cumlogsumexp in f32


def _lattice_logprobs(
    logits: torch.Tensor,  # [B, T, U+1, V]
    targets: torch.Tensor,  # [B, U]
    target_lengths: torch.Tensor,  # [B]
    blank_id: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (lp_blank [B, T, U+1], lp_emit [B, T, U]); emit positions at
    u >= target_length are masked to NEG. The (possibly bf16) lattice is
    upcast inside the one log-softmax."""
    logprobs = torch.log_softmax(logits.to(torch.float32), dim=-1)
    lp_blank = logprobs[..., blank_id]
    B, T = logits.shape[:2]
    U = targets.shape[1]
    tgt = targets.to(device=logits.device, dtype=torch.int64)[:, None, :, None]
    lp_emit = torch.gather(logprobs[:, :, :U, :], 3, tgt.expand(B, T, U, 1))[..., 0]
    u_mask = (torch.arange(U, device=logits.device)[None, None, :]
              < target_lengths.to(logits.device)[:, None, None])
    return lp_blank, torch.where(u_mask, lp_emit, NEG)


def transducer_loss(
    logits: torch.Tensor,  # [B, T, U+1, V] joint lattice (V includes blank)
    logit_lengths: torch.Tensor,  # [B] valid encoder frames
    targets: torch.Tensor,  # [B, U] label ids (no blank)
    target_lengths: torch.Tensor,  # [B]
    blank_id: Optional[int] = None,
) -> torch.Tensor:
    """Per-example RNN-T negative log likelihood, shape [B].

    ``logits[b, t, u]`` scores the next output after consuming encoder
    frames 0..t and emitting the first u target labels; blank defaults
    to the last index."""
    B, T, _, V = logits.shape
    if blank_id is None:
        blank_id = V - 1
    blank_id = blank_id % V
    dev = logits.device
    lp_blank, lp_emit = _lattice_logprobs(logits, targets, target_lengths, blank_id)
    zeros = torch.zeros((B, 1), dtype=torch.float32, device=dev)

    # alpha at t = 0: only emissions from frame 0 reach (0, u)
    alpha = torch.clamp(torch.cat([zeros, torch.cumsum(lp_emit[:, 0], -1)], -1), min=NEG)
    alphas = [alpha]
    for t in range(1, T):
        base = alpha + lp_blank[:, t - 1]
        E = torch.cumsum(torch.cat([zeros, lp_emit[:, t]], -1), -1)
        alpha = torch.clamp(E + torch.logcumsumexp(base - E, dim=1), min=NEG)
        alphas.append(alpha)
    alphas = torch.stack(alphas, dim=1)  # [B, T, U+1]

    # the path ends by emitting blank from (t = T_b - 1, u = U_b)
    u_final = target_lengths.to(device=dev, dtype=torch.int64)[:, None, None].expand(B, T, 1)
    ll_t = (torch.gather(alphas, 2, u_final) + torch.gather(lp_blank, 2, u_final))[..., 0]
    t_final = torch.clamp(logit_lengths.to(device=dev, dtype=torch.int64) - 1, 0, T - 1)
    return -torch.gather(ll_t, 1, t_final[:, None])[:, 0]
