"""One-pass joint CTC/attention beam search (hybrid decoding).

Port of the JAX package's ``decoding/joint.py``. Every beam expansion is
scored with

    (1 - ctc_weight) * log P_att(c | g) + ctc_weight * dPsi_ctc(g, c)
        [+ lm_weight * log P_lm(c | g)]

where dPsi is the increment of the CTC prefix log-probability (the
probability that the CTC output starts with g + c, from the gamma^n /
gamma^b forward recursions; Watanabe et al., "Hybrid CTC/Attention
Architecture for End-to-End Speech Recognition"). The attention head
proposes and orders the candidates; the CTC head scores the K best of
each hypothesis.

The scorer state rides the beam as two [B, W, T] log arrays (gamma^n /
gamma^b over the frames of each hypothesis). Scoring one expansion step
is one walk over the T frames for all B*W*K candidates at once: a Python
loop of small tensor ops on the device, in place of ``lax.scan``, run at
every decode step (about T_enc^2 small steps a decode). Everything else
mirrors ``beam.attention_beam_search``: fixed shapes, frozen finished
beams, one top-W a step, the exit at the first step where every beam is
finished.
"""

from __future__ import annotations

from typing import Tuple

import torch

from nabu_tpu_torch.decoding.beam import (
    _all_finished,
    decoder_step,
    gather_beams,
    initial_beam,
    ranked,
    score_dtype,
    tree_map,
)
from nabu_tpu_torch.decoding.ctc_beam import _top_w
from nabu_tpu_torch.decoding.lm import state_where
from nabu_tpu_torch.ops.masking import NEG_INF, sequence_mask


def _init_ctc_state(ctc_lp: torch.Tensor, enc_mask: torch.Tensor, blank_id: int, W: int):
    """Scorer state of the EMPTY prefix: gamma^n = NEG_INF, gamma^b[t] =
    the sum of the blank log-probs through t (emit nothing), NEG_INF past
    the length."""
    B, T, _ = ctc_lp.shape
    zero = torch.zeros((), dtype=ctc_lp.dtype, device=ctc_lp.device)
    r_b = torch.cumsum(torch.where(enc_mask, ctc_lp[:, :, blank_id], zero), dim=1)
    r_b = torch.where(enc_mask, r_b, NEG_INF)
    r_n = torch.full_like(r_b, NEG_INF)
    return {
        "r_n": r_n[:, None].expand(B, W, T).clone(),
        "r_b": r_b[:, None].expand(B, W, T).clone(),
        "psi": torch.zeros((B, W), dtype=ctc_lp.dtype, device=ctc_lp.device),
        "last": torch.full((B, W), -1, dtype=torch.int32, device=ctc_lp.device),
    }


def _ctc_extend(state: dict, cand: torch.Tensor, ctc_lp: torch.Tensor,
                enc_mask: torch.Tensor, blank_id: int):
    """Score K candidate extensions of each hypothesis.

    state: the parents' scorer state; cand [B, W, K] token ids (non-eos).
    Returns (psi_new [B, W, K], r_n_new, r_b_new [B, W, K, T])."""
    B, W, K = cand.shape
    T = ctc_lp.shape[1]
    neg = torch.full((), NEG_INF, dtype=ctc_lp.dtype, device=ctc_lp.device)
    # xs[t, b, w, k] = log p_t(cand) (NEG past the length): one gather of
    # [B, T, W*K], no [B, W, K, T, V] blow-up
    xs = torch.gather(ctc_lp, 2, cand.reshape(B, 1, W * K).to(torch.int64).expand(B, T, W * K))
    xs = torch.where(enc_mask[..., None], xs, neg).permute(1, 0, 2).reshape(T, B, W, K)
    blank = torch.where(enc_mask, ctc_lp[:, :, blank_id], neg).t()  # [T, B]
    # phi_t = gamma^b_t(g) (+ gamma^n_t(g) unless c repeats last(g))
    repeat = cand == state["last"][..., None]  # [B, W, K]
    phi = torch.logaddexp(
        state["r_b"][:, :, None, :],
        torch.where(repeat[..., None], neg, state["r_n"][:, :, None, :]),
    ).permute(3, 0, 1, 2)  # [T, B, W, K]
    # at t = 0 phi_{-1} is 0 for the empty parent (start of output), else
    # NEG; then phi_{t-1}
    is_empty = (state["last"] < 0)[..., None].expand(B, W, K)
    phi_prev = torch.cat([torch.where(is_empty, 0.0, neg)[None], phi[:-1]], dim=0)

    r_n = torch.full((B, W, K), NEG_INF, dtype=ctc_lp.dtype, device=ctc_lp.device)
    r_b = psi = r_n
    r_n_t = torch.empty((T, B, W, K), dtype=ctc_lp.dtype, device=ctc_lp.device)
    r_b_t = torch.empty_like(r_n_t)
    for t in range(T):  # each frame's rows written in place: 7 launches a frame
        x, ph = xs[t], phi_prev[t]
        torch.add(x, torch.logaddexp(r_n, ph), out=r_n_t[t])
        torch.add(blank[t, :, None, None], torch.logaddexp(r_b, r_n), out=r_b_t[t])
        psi = torch.logaddexp(psi, ph + x)
        r_n, r_b = r_n_t[t], r_b_t[t]
    return psi, r_n_t.permute(1, 2, 3, 0), r_b_t.permute(1, 2, 3, 0)


def joint_ctc_att_beam_search(
    decoder,
    dparams: dict,
    encoded: torch.Tensor,  # [B, T, D]
    enc_lengths: torch.Tensor,  # [B]
    ctc_logprobs: torch.Tensor,  # [B, T, V] log-softmax of the CTC head
    beam_width: int,
    max_steps: int,
    ctc_weight: float = 0.3,
    pre_beam: int = 0,
    length_norm_power: float = 0.0,
    blank_id: int | None = None,
    lm=None,
    lm_weight: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (seqs [B, W, max_steps], lengths, scores) best-first.

    ``decoder`` is the Speller head; the CTC head enters only through its
    frame log-probs. ``pre_beam`` (default ``max(int(1.5 W), 2)``, at
    most V - 1) is the number K of non-eos attention candidates a
    hypothesis that get a CTC score. With ``ctc_weight = 0`` the ranking
    is attention_beam_search's; the scores are the combined (1 - w) * att
    + w * ctc totals (raw: ``length_norm_power`` only re-ranks). ``lm`` (a
    DenseLM or DenseRnnLM on the encoder output's device, fused where
    ``lm_weight`` is not 0) adds ``lm_weight * log p_lm`` unscaled by the attention weight,
    to the pruning proposal and to every candidate, eos included."""
    fuse = lm is not None and lm_weight != 0.0
    B, T, _ = encoded.shape
    W = beam_width
    V = decoder.output_dim
    eos = decoder.eos_id
    dev = encoded.device
    if blank_id is None:
        blank_id = ctc_logprobs.shape[-1] - 1
    K = min(pre_beam or max(int(1.5 * W), 2), V - 1)
    aw, cw = 1.0 - ctc_weight, ctc_weight
    enc_mask = sequence_mask(enc_lengths.to(dev), T)
    keys = decoder.precompute(dparams, encoded)
    s = initial_beam(decoder, encoded, W, max_steps, score_dtype(encoded.dtype))
    ctc_lp = ctc_logprobs.to(s["scores"].dtype)
    ctc = _init_ctc_state(ctc_lp, enc_mask, blank_id, W)
    frozen = torch.full((K + 1,), NEG_INF, dtype=s["scores"].dtype, device=dev)
    frozen[K] = 0.0
    pos = torch.arange(max_steps, device=dev)
    # the full-utterance CTC log-prob of a hypothesis as COMPLETE output
    # (the score of eos): logaddexp of gamma^n and gamma^b at t = len - 1
    t_last = torch.clamp(enc_lengths.to(dev, torch.int64) - 1, min=0)[:, None, None].expand(
        B, W, 1)

    def full_ctc(c):
        return torch.logaddexp(torch.gather(c["r_n"], 2, t_last)[..., 0],
                               torch.gather(c["r_b"], 2, t_last)[..., 0])

    if fuse:
        s["lm"] = lm.init_state((B, W))
    t = 0
    while t < max_steps and not _all_finished(s["finished"]):
        att_lp, new_state = decoder_step(decoder, dparams, s, encoded, enc_mask, keys)

        # the LM term stays unscaled by the attention weight, in its own array
        lm_lp = lm_weight * lm.logprobs(s["lm"]).to(att_lp.dtype) if fuse else None

        # candidate pruning by the combined proposal (non-eos)
        noneos = att_lp.clone() if lm_lp is None else att_lp + lm_lp
        noneos[..., eos] = NEG_INF
        _, cand = _top_w(noneos, K)  # [B, W, K]
        top_att = torch.gather(att_lp, 2, cand)

        # CTC prefix scores of the pruned candidates
        psi_new, r_n_new, r_b_new = _ctc_extend(ctc, cand, ctc_lp, enc_mask, blank_id)
        d_psi = psi_new - ctc["psi"][..., None]  # [B, W, K]

        # the combined candidate matrix [B, W, K + 1], the last column eos
        step_tok = aw * top_att + cw * d_psi
        step_eos = aw * att_lp[..., eos] + cw * (full_ctc(ctc) - ctc["psi"])
        if fuse:
            step_tok = step_tok + torch.gather(lm_lp, 2, cand)
            step_eos = step_eos + lm_lp[..., eos]
        cand_scores = torch.cat([step_tok, step_eos[..., None]], dim=-1) + s["scores"][..., None]
        cand_scores = torch.where(s["finished"][..., None], frozen + s["scores"][..., None],
                                  cand_scores)
        top_scores, top_flat = _top_w(cand_scores.reshape(B, W * (K + 1)), W)
        parent = top_flat // (K + 1)
        slot = top_flat % (K + 1)
        is_eos = slot == K
        # the picked candidate's flat index in [B, W*K] (eos picks clamp)
        flat_k = parent * K + slot % K
        token = torch.where(is_eos, eos, torch.gather(cand.reshape(B, W * K), 1, flat_k)).to(
            torch.int32)

        seqs = gather_beams(s["seqs"], parent)
        lengths = gather_beams(s["lengths"], parent)
        finished = gather_beams(s["finished"], parent)
        # the CTC scorer state: non-eos picks of live parents adopt their
        # extension's arrays, the rest keep the parent's
        keep = is_eos | finished
        idx_t = flat_k[..., None].expand(B, W, T)
        ctc = {
            "r_n": torch.where(keep[..., None], gather_beams(ctc["r_n"], parent),
                               torch.gather(r_n_new.reshape(B, W * K, T), 1, idx_t)),
            "r_b": torch.where(keep[..., None], gather_beams(ctc["r_b"], parent),
                               torch.gather(r_b_new.reshape(B, W * K, T), 1, idx_t)),
            "psi": torch.where(keep, gather_beams(ctc["psi"], parent),
                               torch.gather(psi_new.reshape(B, W * K), 1, flat_k)),
            "last": torch.where(keep, gather_beams(ctc["last"], parent), token),
        }
        write = ~finished
        seqs = torch.where(write[..., None] & (pos == t), token[..., None], seqs)
        lengths = torch.where(write & ~is_eos, lengths + 1, lengths)
        new = {"seqs": seqs, "scores": top_scores, "finished": finished | is_eos,
               "lengths": lengths, "prev": token,
               "state": tree_map(lambda x: gather_beams(x, parent), new_state)}
        if fuse:
            lm_state = tree_map(lambda x: gather_beams(x, parent), s["lm"])
            new["lm"] = state_where(finished, lm_state, lm.step(lm_state, token))
        s = new
        t += 1
    return ranked(s["seqs"], s["lengths"], s["scores"], s["finished"], length_norm_power)
