"""Batched CTC prefix beam search with fixed-shape state.

Port of the JAX package's ``decoding/ctc_beam.py``: beams are
``[B, W, Lmax]`` prefixes with separate blank / non-blank
log-probabilities (Hannun-style prefix beam search). Each frame expands
every beam with {stay, extend-with-c} candidates vectorized over the
vocab, merges equal prefixes via rolling-hash sort + segment-logsumexp,
and keeps the top W. The Python loop over frames takes the place of
``lax.scan``; every op inside is a batched tensor op on the logits'
device.

Shallow fusion with an LM (``decoding.lm.DenseLM``, the n-gram's, or
``decoding.neural_lm.DenseRnnLM``, whose state is a dict of tensors,
gathered and selected leaf by leaf): each prefix extension adds
``lm_weight * log p_lm(tok | prefix)``; stay and blank moves add
nothing, and a hypothesis's LM context advances only on an extension, so
equal prefixes carry equal LM terms and the merge stays exact.

Scores are f32, or float64 where the log-probs are float64 (which makes
two devices' searches comparable).

Orderings mirror the JAX functions exactly: ``jnp.argsort`` is stable,
and ``lax.top_k`` breaks ties by the lower index, so both become a
stable sort (``torch.topk`` does not promise that order, and dead beams
all tie at ``NEG_INF``). The rolling hashes are int32 and rely on
wraparound, as in JAX.
"""

from __future__ import annotations

from typing import Tuple

import torch

from nabu_tpu_torch.ops.masking import NEG_INF

# rolling-hash multipliers (int32 wraparound; two independent hashes)
_HASH_M1 = 1000003
_HASH_M2 = 8191
_PAD_HASH = -(2**31) + 1


def _segment_logsumexp_sorted(
    values: torch.Tensor, segment_start: torch.Tensor
) -> torch.Tensor:
    """Log-sum-exp within runs of equal keys in a sorted array.

    values, segment_start: [B, C] with segment_start True at each run
    head. Returns an array where each run head holds the run's logsumexp
    and all other positions are NEG_INF. Sums are anchored at the
    per-row max (see the JAX function)."""
    B, C = values.shape
    seg_id = torch.cumsum(segment_start.to(torch.int64), dim=-1) - 1
    row_max = values.max(dim=-1, keepdim=True).values
    row_max = torch.where(
        row_max > NEG_INF / 2, row_max, torch.zeros_like(row_max)
    )
    expv = torch.where(
        values > NEG_INF / 2, torch.exp(values - row_max),
        torch.zeros_like(values),
    )
    totals = torch.zeros_like(expv).scatter_add_(1, seg_id, expv)
    run_total = torch.gather(totals, 1, seg_id)
    return torch.where(
        segment_start & (run_total > 0),
        torch.log(torch.clamp(run_total, min=1e-38)) + row_max,
        torch.full_like(values, NEG_INF),
    )


def _top_w(total: torch.Tensor, W: int):
    """lax.top_k over the last axis: descending, ties broken by the lower
    index."""
    vals, idx = torch.sort(total, dim=-1, descending=True, stable=True)
    return vals[..., :W], idx[..., :W]


def ctc_prefix_beam_search(
    logprobs: torch.Tensor,  # [B, T, V] log-softmax output, blank included
    logit_lengths: torch.Tensor,  # [B]
    beam_width: int,
    blank_id: int,
    max_label_len: int | None = None,
    lm=None,
    lm_weight: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (seqs [B, W, Lmax] int32, lengths [B, W] int32, scores
    [B, W] f32, or float64 from float64 log-probs) sorted best-first;
    scores are total log P(prefix) = logaddexp(p_b, p_nb), with the
    fused LM terms where ``lm`` (a DenseLM or DenseRnnLM on the log-probs'
    device) is given and ``lm_weight`` is not 0."""
    B, T, V = logprobs.shape
    W = beam_width
    Lmax = max_label_len or T
    dev = logprobs.device
    i32 = torch.int32
    sdt = torch.promote_types(logprobs.dtype, torch.float32)
    logprobs = logprobs.to(sdt)
    fuse = lm is not None and lm_weight != 0.0

    slot = torch.arange(1, W + 1, dtype=i32, device=dev)[None, :]
    neg = torch.full((B, W), NEG_INF, dtype=sdt, device=dev)
    # beam 0 = empty prefix (p_b=0, canonical empty hash 0); others dead
    # with unique negative per-slot hashes so they never merge
    pb = neg.clone()
    pb[:, 0] = 0.0
    pnb = neg.clone()
    hash1 = (-slot).repeat(B, 1)
    hash1[:, 0] = 0
    hash2 = hash1.clone()
    seqs = torch.zeros((B, W, Lmax), dtype=i32, device=dev)
    lengths = torch.zeros((B, W), dtype=i32, device=dev)
    last = torch.full((B, W), -1, dtype=i32, device=dev)
    if fuse:
        # (beam.py imports this module: its helpers are imported here)
        from nabu_tpu_torch.decoding.beam import gather_beams, tree_map
        from nabu_tpu_torch.decoding.lm import state_where

        lm_state = lm.init_state((B, W))

    _ids = torch.arange(V - 1, dtype=i32, device=dev)
    nonblank_ids = torch.where(_ids >= blank_id, _ids + 1, _ids)
    nonblank_long = nonblank_ids.to(torch.int64)
    C = W * V
    cand_parent = (
        torch.arange(W, dtype=i32, device=dev)[None, :, None]
        .expand(B, W, V).reshape(B, C)
    )
    cand_tok = torch.cat(
        [
            nonblank_ids[None, None, :].expand(B, W, V - 1),
            torch.full((B, W, 1), -1, dtype=i32, device=dev),  # stay
        ],
        dim=-1,
    ).reshape(B, C)
    tok32 = (nonblank_ids + 1)[None, None, :]
    pad_h = torch.full((B, 1), _PAD_HASH, dtype=i32, device=dev)
    pos_l = torch.arange(Lmax, device=dev)[None, None, :]
    valid_t = (
        torch.arange(T, device=dev)[:, None]
        < logit_lengths.to(dev)[None, :]
    )  # [T, B]

    for t in range(T):
        lp = logprobs[:, t]  # [B, V]
        valid = valid_t[t]  # [B]
        ptot = torch.logaddexp(pb, pnb)  # [B, W]

        lp_blank = lp[:, blank_id][:, None]
        lp_tok = lp[:, nonblank_long]  # [B, V-1]

        # --- stay candidates (prefix unchanged) ------------------------
        stay_pb = ptot + lp_blank
        lp_last = torch.where(
            last >= 0,
            torch.gather(lp, 1, torch.clamp(last, min=0).to(torch.int64)),
            neg,
        )
        stay_pnb = pnb + lp_last

        # --- extension candidates [B, W, V-1] --------------------------
        is_last = nonblank_ids[None, None, :] == last[..., None]
        base = torch.where(is_last, pb[..., None], ptot[..., None])
        ext_pnb = base + lp_tok[:, None, :]
        if fuse:
            lm_lp = lm.logprobs(lm_state)[..., nonblank_long].to(sdt)  # [B, W, V-1]
            ext_pnb = ext_pnb + lm_weight * lm_lp
        ext_pb = torch.full_like(ext_pnb, NEG_INF)

        cand_pnb = torch.cat([ext_pnb, stay_pnb[..., None]], -1).reshape(B, C)
        cand_pb = torch.cat([ext_pb, stay_pb[..., None]], -1).reshape(B, C)
        # hashes: extended = h * M + (tok + 1); stay = h
        h1 = hash1[..., None]
        h2 = hash2[..., None]
        cand_h = torch.cat([h1 * _HASH_M1 + tok32, h1], -1).reshape(B, C)
        cand_h2 = torch.cat([h2 * _HASH_M2 + tok32, h2], -1).reshape(B, C)

        # --- merge equal prefixes: sort by hash, segment-logsumexp -----
        order = torch.argsort(cand_h, dim=-1, stable=True)
        cand_h = torch.gather(cand_h, 1, order)
        cand_h2 = torch.gather(cand_h2, 1, order)
        s_pb = torch.gather(cand_pb, 1, order)
        s_pnb = torch.gather(cand_pnb, 1, order)
        s_parent = torch.gather(cand_parent, 1, order)
        s_tok = torch.gather(cand_tok, 1, order)

        prev_h = torch.cat([pad_h, cand_h[:, :-1]], dim=1)
        prev_h2 = torch.cat([pad_h, cand_h2[:, :-1]], dim=1)
        seg_start = (cand_h != prev_h) | (cand_h2 != prev_h2)
        m_pb = _segment_logsumexp_sorted(s_pb, seg_start)
        m_pnb = _segment_logsumexp_sorted(s_pnb, seg_start)
        total = torch.logaddexp(m_pb, m_pnb)

        # --- top-W candidates -----------------------------------------
        top_total, top_idx = _top_w(total, W)
        new_pb = torch.gather(m_pb, 1, top_idx)
        new_pnb = torch.gather(m_pnb, 1, top_idx)
        new_h = torch.gather(cand_h, 1, top_idx)
        new_h2 = torch.gather(cand_h2, 1, top_idx)
        parent = torch.gather(s_parent, 1, top_idx).to(torch.int64)
        tok = torch.gather(s_tok, 1, top_idx)

        # --- materialize prefixes -------------------------------------
        old_seqs = torch.gather(
            seqs, 1, parent[..., None].expand(B, W, Lmax)
        )
        old_len = torch.gather(lengths, 1, parent)
        old_last = torch.gather(last, 1, parent)
        is_ext = tok >= 0
        # at capacity the stored prefix truncates (scoring stays exact
        # via the hashes; only storage is truncated)
        can_write = is_ext & (old_len < Lmax)
        write_pos = torch.clamp(old_len, max=Lmax - 1)
        onehot = pos_l == write_pos[..., None]
        new_seqs = torch.where(
            can_write[..., None] & onehot, tok[..., None], old_seqs
        )
        new_len = torch.where(can_write, old_len + 1, old_len)
        new_last = torch.where(is_ext, tok, old_last)
        if fuse:
            # the context is a function of the prefix: stepping the chosen
            # (parent, tok) after the selection equals stepping every
            # candidate before it
            parent_lm = tree_map(lambda x: gather_beams(x, parent), lm_state)
            new_lm = state_where(is_ext, lm.step(parent_lm, torch.clamp(tok, min=0)),
                                 parent_lm)

        dead = top_total < NEG_INF / 2
        new_h = torch.where(dead, -slot, new_h)
        new_h2 = torch.where(dead, -slot, new_h2)

        # frames past logit_length leave the state untouched
        v2 = valid[:, None]
        seqs = torch.where(valid[:, None, None], new_seqs, seqs)
        lengths = torch.where(v2, new_len, lengths)
        pb = torch.where(v2, new_pb, pb)
        pnb = torch.where(v2, new_pnb, pnb)
        hash1 = torch.where(v2, new_h, hash1)
        hash2 = torch.where(v2, new_h2, hash2)
        last = torch.where(v2, new_last, last)
        if fuse:
            lm_state = state_where(v2, new_lm, lm_state)

    scores = torch.logaddexp(pb, pnb)
    ranked = torch.argsort(-scores, dim=1, stable=True)
    seqs = torch.gather(seqs, 1, ranked[..., None].expand(B, W, Lmax))
    lengths = torch.gather(lengths, 1, ranked)
    scores = torch.gather(scores, 1, ranked)
    return seqs, lengths, scores
