"""CTC helpers for decoding (the loss comes with the training slice)."""

from __future__ import annotations

import torch

from nabu_tpu_torch.ops.masking import sequence_mask


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
