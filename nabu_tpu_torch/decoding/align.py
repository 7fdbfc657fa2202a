"""CTC forced alignment: Viterbi over the blank-expanded label lattice.

Port of the JAX package's ``decoding/align.py``. Given the CTC head's frame
log-probs and a label sequence, it finds the most probable frame-to-label
alignment: the 2U + 1-state CTC Viterbi (blank, y1, blank, ..., yU, blank)
with stay, advance and skip transitions, the skip allowed only into a
non-blank label that differs from the label two states back, as in the
CTC forward recursion.

The forward pass is a loop over T on the log-probs' device with [B, S]
f32 scores and int8 back-pointers; the backtrace walks the stored choices
backwards. Variable lengths freeze the recursion past ``logit_lengths``
(those frames record "stay"), and each sequence ends in its own final
state. It is plain PyTorch, as JAX's ``lax.scan`` is not a Pallas kernel:
the loop is bound by the host's launches (one step is a few small
element-wise kernels).
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from nabu_tpu_torch.ops.masking import NEG_INF


def _expand(targets: torch.Tensor, blank_id: int) -> torch.Tensor:
    """[B, U] labels -> [B, 2U + 1] blank-interleaved state symbols."""
    B, U = targets.shape
    z = torch.full((B, 2 * U + 1), blank_id, dtype=torch.int64, device=targets.device)
    z[:, 1::2] = targets
    return z


def transitions(z: torch.Tensor, s_len: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (may skip into state s [B, S], s inside the sequence [B, S]): a
    skip s - 2 -> s only into a non-blank label that differs from the
    label two states back."""
    S = z.shape[1]
    states = torch.arange(S, device=z.device)[None, :]
    prev2 = torch.nn.functional.pad(z[:, :-2], (2, 0), value=-1)
    return (states % 2 == 1) & (z != prev2), states < s_len[:, None]


def ctc_forced_align(
    logprobs: torch.Tensor,  # [B, T, V] frame log-probs (post log_softmax)
    logit_lengths: torch.Tensor,  # [B]
    targets: torch.Tensor,  # [B, U] label ids (padded arbitrarily)
    target_lengths: torch.Tensor,  # [B]
    blank_id: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The most probable CTC alignment of each sequence: ``(frame_labels
    [B, T] int32, scores [B] f32)``, ``frame_labels[b, t]`` the symbol
    (label or blank) of the Viterbi path at frame t, blank from
    ``logit_lengths[b]`` on, and ``scores`` the path's log-probability.
    Ties go to the first of stay, advance, skip."""
    logprobs = logprobs.to(torch.float32)
    B, T, V = logprobs.shape
    dev = logprobs.device
    z = _expand(targets.to(dev).long(), blank_id)  # [B, S]
    S = z.shape[1]
    s_len = 2 * target_lengths.to(dev).long() + 1
    lengths = logit_lengths.to(dev)
    can_skip, in_seq = transitions(z, s_len)
    emit = torch.gather(logprobs, 2, z[:, None, :].expand(B, T, S))  # log p_t(z_s)
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=dev)

    # delta in a buffer with two NEG_INF columns in front, so that the
    # advance and skip predecessors are views of it
    buf = torch.full((B, S + 2), NEG_INF, dtype=torch.float32, device=dev)
    first = torch.arange(S, device=dev)[None, :] < 2  # only blank and y1 may start
    buf[:, 2:] = torch.where(first & in_seq, emit[:, 0], neg)
    choices = torch.zeros((max(T - 1, 0), B, S), dtype=torch.int8, device=dev)
    for t in range(1, T):
        delta = buf[:, 2:]
        skip = torch.where(can_skip, buf[:, :S], neg)
        best, choice = torch.max(torch.stack([delta, buf[:, 1:S + 1], skip]), dim=0)
        new = torch.where(in_seq, best + emit[:, t], neg)
        # frozen past each sequence's end: delta carried, "stay" recorded
        valid = (t < lengths)[:, None]
        buf[:, 2:] = torch.where(valid, new, delta)
        choices[t - 1] = torch.where(valid, choice, 0).to(torch.int8)
    delta = buf[:, 2:]

    # the final state: the last blank, or the last label where it is better
    last_blank = s_len - 1
    last_label = torch.clamp(s_len - 2, min=0)
    fb = torch.gather(delta, 1, last_blank[:, None])[:, 0]
    fl = torch.gather(delta, 1, last_label[:, None])[:, 0]
    s = torch.where(fb >= fl, last_blank, last_label)
    scores = torch.maximum(fb, fl)

    # backtrace: s_{t-1} = s_t - choice_t(s_t)
    path = torch.empty((B, T), dtype=torch.int64, device=dev)
    path[:, T - 1] = s
    for t in range(T - 1, 0, -1):
        s = s - torch.gather(choices[t - 1], 1, s[:, None])[:, 0].long()
        path[:, t - 1] = s
    frame_labels = torch.gather(z, 1, path)
    t_ids = torch.arange(T, device=dev)[None, :]
    frame_labels = torch.where(t_ids < lengths[:, None], frame_labels, blank_id)
    return frame_labels.to(torch.int32), scores


def segments_from_frames(frame_labels, length, blank_id) -> List[Tuple[int, int, int]]:
    """Host side: a frame-label row collapsed into ``(label, start_frame,
    end_frame_exclusive)`` segments (consecutive equal non-blank frames
    are one segment, as CTC reads them)."""
    segs = []
    prev = blank_id
    start = 0
    for t in range(int(length)):
        lab = int(frame_labels[t])
        if lab != prev:
            if prev != blank_id:
                segs.append((prev, start, t))
            start = t
            prev = lab
    if prev != blank_id:
        segs.append((prev, start, int(length)))
    return segs
