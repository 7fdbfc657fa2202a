"""RNN-T decoding: batched greedy and beam search, fixed shapes.

Port of the JAX package's ``decoding/transducer.py``, the beam search's
LM fusion (n-gram or neural) included. Both searches run on the model's
device as a loop over the encoder frames with the per-frame emission
loop unrolled ``max_symbols`` times; every lane of the batch (and every
hypothesis of the beam) takes each step, with masks, so the shapes never
depend on the data. The joint inside the loop
is the head's ``joint_step`` in plain torch, as it lies outside any Pallas
kernel in JAX. The log-softmax runs in f32, or in the logits' own dtype
where that is wider (float64 makes two devices' searches comparable bit
for bit in practice). Ties follow ``lax.top_k`` / ``argmax`` / stable
``argsort`` (the lower index first).
"""

from __future__ import annotations

from typing import Tuple

import torch

from nabu_tpu_torch.decoding.beam import gather_beams as _gather_beams
from nabu_tpu_torch.decoding.beam import tree_map
from nabu_tpu_torch.decoding.ctc_beam import _top_w
from nabu_tpu_torch.decoding.lm import state_where
from nabu_tpu_torch.ops.masking import sequence_mask


def _log_softmax(logits: torch.Tensor) -> torch.Tensor:
    return torch.log_softmax(logits.to(torch.promote_types(logits.dtype, torch.float32)), -1)


def _where_state(mask, new, old):
    """Per-lane select over a prediction-net state (a list of (h, c))."""
    return [(torch.where(mask, nh, h), torch.where(mask, nc, c))
            for (nh, nc), (h, c) in zip(new, old)]


def transducer_greedy_search(
    decoder,
    params: dict,
    encoded: torch.Tensor,  # [B, T, D]
    enc_lengths: torch.Tensor,  # [B]
    max_symbols: int = 4,
    init_carry=None,
    return_carry: bool = False,
):
    """-> (ids [B, T*max_symbols], lengths [B], scores [B]): at each frame
    emit the argmax symbol, stepping the prediction net after each, until
    the joint says blank or the frame's budget runs out. ``scores`` is the
    log-probability of that alignment (every emitted symbol plus every
    consumed blank, at valid frames).

    ``init_carry`` / ``return_carry`` expose the running decode state
    (pred vector, prediction-net state, score), so a streaming caller
    decodes chunk by chunk to the same result as one offline pass
    (``decoding.streaming``); with ``return_carry`` the carry is the
    fourth result."""
    B, T, _ = encoded.shape
    dev = encoded.device
    enc_proj = decoder.precompute(params, encoded)  # [B, T, J]
    enc_mask = sequence_mask(enc_lengths.to(dev), T)
    blank = decoder.blank_id
    if init_carry is None:
        init_carry = initial_carry(decoder, params, B, encoded.dtype, dev)
    pred_vec, state, score = init_carry
    toks, valid = [], []
    for t in range(T):
        frame_open = enc_mask[:, t]  # lanes still allowed to act this frame
        for _ in range(max_symbols):
            logits = decoder.joint_step(params, enc_proj[:, t], pred_vec)
            logprobs = _log_softmax(logits)
            best_lp, best = torch.max(logprobs, dim=-1)
            best = best.to(torch.int32)
            emit = frame_open & (best != blank)
            # acting lanes score their choice (blank or emission) once
            score = score + torch.where(frame_open, best_lp, 0.0)
            new_pred, new_state = decoder.pred_step(params, best, state)
            pred_vec = torch.where(emit[:, None], new_pred, pred_vec)
            state = _where_state(emit[:, None], new_state, state)
            toks.append(torch.where(emit, best, blank))
            valid.append(emit)
            frame_open = emit  # a blank closes the frame; emitting keeps it open
    carry = (pred_vec, state, score)
    if not toks:
        ids = torch.zeros((B, 0), dtype=torch.int32, device=dev)
        lengths = torch.zeros((B,), dtype=torch.int32, device=dev)
    else:
        toks = torch.stack(toks, dim=1)  # [B, T*K], frame-major
        valid = torch.stack(valid, dim=1)
        # left-pack the emitted symbols (the stable sort keeps emission order)
        order = torch.argsort((~valid).to(torch.int8), dim=1, stable=True)
        ids = torch.gather(toks, 1, order)
        lengths = valid.sum(dim=1).to(torch.int32)
    if return_carry:
        return ids, lengths, score, carry
    return ids, lengths, score


def initial_carry(decoder, params: dict, batch: int, dtype, device):
    """The decode state before the first frame: the prediction net after
    the start symbol, and a zero score."""
    state = decoder.pred_init_state(batch, dtype, device)
    pred_vec, state = decoder.pred_step(
        params, torch.full((batch,), decoder.sos_id, dtype=torch.int32, device=device), state)
    return pred_vec, state, torch.zeros((batch,), dtype=torch.float32, device=device)


def transducer_beam_search(
    decoder,
    params: dict,
    encoded: torch.Tensor,  # [B, T, D]
    enc_lengths: torch.Tensor,  # [B]
    beam_width: int = 4,
    max_symbols: int = 4,
    length_norm_power: float = 0.0,
    lm=None,
    lm_weight: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched time-synchronous alignment-path beam search: keeps the
    ``beam_width`` best alignment paths (no equal-prefix merging). Per
    frame each open hypothesis either emits (staying open, at most
    ``max_symbols`` times) or takes blank (closing the frame); closed ones
    carry over. Each expansion is one top-W over W * (1 + V+1) candidates
    (a no-op and every joint action). ``length_norm_power`` changes only
    the ranking key ``score / max(len, 1)^power``; the scores returned are
    raw path log-probs. ``lm`` (a DenseLM or DenseRnnLM on the encoder
    output's device) with ``lm_weight`` not 0 fuses the LM into the emissions only:
    each label below the blank gains ``lm_weight * log p_lm``, blank
    moves carry no LM cost, and a hypothesis's context advances only
    where it emits.

    Returns (seqs [B, W, T*max_symbols], lengths [B, W], scores [B, W]),
    best first."""
    fuse = lm is not None and lm_weight != 0.0
    B, T, _ = encoded.shape
    W = beam_width
    dev = encoded.device
    enc_proj = decoder.precompute(params, encoded)  # [B, T, J]
    J = enc_proj.shape[-1]
    enc_mask = sequence_mask(enc_lengths.to(dev), T)
    blank = decoder.blank_id
    L = T * max_symbols
    NEG = -1e30

    def flat_pred_step(ids, state):
        """pred_step over the flattened [B*W] beam."""
        vec, new = decoder.pred_step(
            params, ids.reshape(B * W),
            [(h.reshape(B * W, -1), c.reshape(B * W, -1)) for h, c in state])
        return vec.reshape(B, W, -1), [(h.reshape(B, W, -1), c.reshape(B, W, -1))
                                       for h, c in new]

    # hypothesis 0 live, the rest parked at NEG
    state0 = decoder.pred_init_state(B * W, encoded.dtype, dev)
    pred, state = decoder.pred_step(
        params, torch.full((B * W,), decoder.sos_id, dtype=torch.int32, device=dev), state0)
    pred = pred.reshape(B, W, -1)
    state = [(h.reshape(B, W, -1), c.reshape(B, W, -1)) for h, c in state]
    score = torch.where(torch.arange(W, device=dev)[None, :] == 0, 0.0, NEG) * torch.ones(
        (B, 1), device=dev)
    seqs = torch.full((B, W, L), blank, dtype=torch.int32, device=dev)
    lens = torch.zeros((B, W), dtype=torch.int32, device=dev)
    pos = torch.arange(L, device=dev)[None, None, :]
    if fuse:
        lm_state = lm.init_state((B, W))

    for t in range(T):
        # at an invalid frame every hypothesis takes the no-op
        open_ = enc_mask[:, t, None].expand(B, W)
        enc_t = enc_proj[:, t, None, :].expand(B, W, J).reshape(B * W, J)
        for _ in range(max_symbols):
            logits = decoder.joint_step(params, enc_t, pred.reshape(B * W, -1)).reshape(B, W, -1)
            nV = logits.shape[-1]
            lp = _log_softmax(logits)
            if fuse:
                # fusion on emissions; the blank column stays AM-only
                lm_lp = lm.logprobs(lm_state)[..., :blank].to(lp.dtype)
                lp = torch.cat([lp[..., :blank] + lm_weight * lm_lp, lp[..., blank:]], dim=-1)
            # candidates [B, W, 1 + nV]: column 0 the no-op, 1 + v action v
            noop = torch.where(open_, NEG, 0.0) + score
            acts = torch.where(open_[..., None], lp, NEG) + score[..., None]
            flat = torch.cat([noop[..., None], acts], dim=-1).reshape(B, W * (1 + nV))
            top_score, top_idx = _top_w(flat, W)
            parent = top_idx // (1 + nV)
            action = top_idx % (1 + nV)
            tok = (action - 1).to(torch.int32)
            is_emit = (action >= 1) & (tok != blank)
            pred = _gather_beams(pred, parent)
            state = [(_gather_beams(h, parent), _gather_beams(c, parent)) for h, c in state]
            seqs = _gather_beams(seqs, parent)
            lens = _gather_beams(lens, parent)
            open_ = is_emit  # blank and the no-op both close the frame
            tok = torch.clamp(tok, min=0)
            if fuse:
                lm_state = tree_map(lambda x: _gather_beams(x, parent), lm_state)
                lm_state = state_where(is_emit, lm.step(lm_state, tok), lm_state)
            seqs = torch.where(is_emit[..., None] & (pos == lens[..., None]),
                               tok[..., None], seqs)
            lens = lens + is_emit.to(torch.int32)
            new_pred, new_state = flat_pred_step(tok, state)
            pred = torch.where(is_emit[..., None], new_pred, pred)
            state = _where_state(is_emit[..., None], new_state, state)
            score = top_score

    if length_norm_power > 0.0:
        rank_key = score / torch.clamp(lens.to(torch.float32), min=1.0) ** length_norm_power
    else:
        rank_key = score
    order = torch.argsort(-rank_key, dim=1, stable=True)
    return (_gather_beams(seqs, order), torch.gather(lens, 1, order),
            torch.gather(score, 1, order))
