"""CTC loss in plain PyTorch (the oracle of the CTC kernels) and the
greedy collapse used in decoding.

Port of the JAX package's ``ops/ctc.py``: a log-space forward
algorithm over densely padded targets, gradients by autograd through
the loop over T. The kernel path is ``ops/ctc_batched.py``.

Blank convention: configurable ``blank_id``; the CTC head uses blank =
num_labels (last index). Infeasible alignments (logit_len < label_len +
the blanks needed between adjacent repeats) get a clamped NLL of
``CTC_NLL_CLAMP`` with zero gradient; ``ctc_feasible`` is the exact
predicate the loss computers use to leave such examples out.
"""

from __future__ import annotations

import torch

from nabu_tpu_torch.ops.masking import NEG_INF, sequence_mask

# Per-example NLL ceiling: far above any real alignment's NLL, it keeps
# an infeasible example's loss finite and its gradient zero.
CTC_NLL_CLAMP = 1.0e4


def ctc_feasible(logit_lengths, labels, label_lengths) -> torch.Tensor:
    """[B] bool: a CTC alignment exists, i.e. logit_len >= label_len +
    the number of adjacent repeated labels."""
    L = labels.shape[1]
    valid = torch.arange(L, device=labels.device)[None, :] < label_lengths[:, None]
    rep = (labels[:, 1:] == labels[:, :-1]) & valid[:, 1:] & valid[:, :-1]
    need = label_lengths + rep.sum(dim=1).to(label_lengths.dtype)
    return logit_lengths >= need


def extended_labels(labels: torch.Tensor, blank_id: int) -> torch.Tensor:
    """[B, L] -> blank-interleaved [B, 2L+1]: blank l0 blank l1 ... blank."""
    B, L = labels.shape
    ext = torch.full((B, 2 * L + 1), blank_id, dtype=labels.dtype, device=labels.device)
    ext[:, 1::2] = labels
    return ext


def can_skip(ext: torch.Tensor, blank_id: int) -> torch.Tensor:
    """[B, S] bool: the skip transition into lane s is allowed (a label
    that differs from the one two lanes back)."""
    prev2 = torch.nn.functional.pad(ext[:, :-2], (2, 0), value=-1)
    return (ext != blank_id) & (ext != prev2)


def _logaddexp3(a, b, c):
    return torch.logaddexp(torch.logaddexp(a, b), c)


def ctc_forward_log_alpha(logprobs, logit_lengths, labels, blank_id: int):
    """The forward DP. logprobs [B, T, V] -> (log alpha [T, B, S], ext)."""
    B, T, V = logprobs.shape
    ext = extended_labels(labels, blank_id)
    S = ext.shape[1]
    lp_ext = torch.gather(logprobs, 2, ext[:, None, :].expand(B, T, S).long())  # [B, T, S]
    skip = can_skip(ext, blank_id)
    neg = torch.full((B, S), NEG_INF, dtype=logprobs.dtype, device=logprobs.device)
    first = torch.zeros((B, S), dtype=torch.bool, device=logprobs.device)
    first[:, : min(2, S)] = True
    alpha = torch.where(first, lp_ext[:, 0], neg)
    time_mask = sequence_mask(logit_lengths, T)
    alphas = [alpha]
    for t in range(1, T):
        shift1 = torch.nn.functional.pad(alpha[:, :-1], (1, 0), value=NEG_INF)
        shift2 = torch.nn.functional.pad(alpha[:, :-2], (2, 0), value=NEG_INF)
        shift2 = torch.where(skip, shift2, neg)
        new = _logaddexp3(alpha, shift1, shift2) + lp_ext[:, t]
        alpha = torch.where(time_mask[:, t, None], new, alpha)
        alphas.append(alpha)
    return torch.stack(alphas, dim=0), ext


def ctc_loss(logits, logit_lengths, labels, label_lengths, blank_id=None) -> torch.Tensor:
    """Per-example negative log likelihood [B]; requires logit_lengths
    >= 1. Infeasible examples get ``CTC_NLL_CLAMP`` with zero gradient."""
    B, T, V = logits.shape
    if blank_id is None:
        blank_id = V - 1
    logprobs = torch.log_softmax(logits, dim=-1)
    alphas, _ = ctc_forward_log_alpha(logprobs, logit_lengths, labels, blank_id)
    t_last = torch.clamp(logit_lengths.long() - 1, min=0)
    alpha_T = alphas[t_last, torch.arange(B, device=logits.device)]  # [B, S]
    s_last = (2 * label_lengths.long())[:, None]
    a_blank = torch.gather(alpha_T, 1, s_last)[:, 0]
    s_label = torch.clamp(2 * label_lengths.long() - 1, min=0)[:, None]
    a_label = torch.gather(alpha_T, 1, s_label)[:, 0]
    a_label = torch.where(label_lengths > 0, a_label, torch.full_like(a_label, NEG_INF))
    ll = torch.logaddexp(a_blank, a_label)
    # max() stops gradient flow whenever the clamp binds
    return -torch.clamp(ll, min=-CTC_NLL_CLAMP)


def ctc_greedy_collapse(
    frame_ids: torch.Tensor,  # [B, T] argmax frame labels
    logit_lengths: torch.Tensor,  # [B]
    blank_id: int,
):
    """Collapse repeats then remove blanks; static-shape output.

    Returns (collapsed [B, T] padded with blank_id at the tail,
    collapsed lengths [B] int32).
    """
    B, T = frame_ids.shape
    time_mask = sequence_mask(logit_lengths, T)
    prev = torch.nn.functional.pad(frame_ids[:, :-1], (1, 0), value=-1)
    keep = (frame_ids != prev) & (frame_ids != blank_id) & time_mask
    # stable compaction: position of each kept symbol in the output;
    # dropped frames scatter into an extra column that is cut off
    pos = torch.cumsum(keep.to(torch.int64), dim=1) - 1
    out_len = keep.sum(dim=1).to(torch.int32)
    out = torch.full(
        (B, T + 1), blank_id, dtype=frame_ids.dtype, device=frame_ids.device
    )
    scatter_pos = torch.where(keep, pos, torch.full_like(pos, T))
    out.scatter_(1, scatter_pos, frame_ids)
    return out[:, :T], out_len
