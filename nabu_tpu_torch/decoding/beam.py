"""Batched attention beam search with fixed-shape beam state.

Port of the JAX package's ``decoding/beam.py``. The whole beam is a ``[B, W, ...]`` tensor program: the decoder state rides
along flattened to ``[B*W, ...]``, each step is one batched
``decoder.step`` and one top-W over the ``W*V`` candidates, and the
encoding, its mask and its attention keys stay ``[B, ...]``, shared by the
beam (``Speller._attend`` maps hypothesis w of utterance b to row
``b*W + w``, this file's flattening order).

The Python loop takes the place of ``lax.while_loop``: it ends at the
first step where every beam is finished, as JAX's does, which costs one
host sync a step (``_all_finished``); steps past that point could reorder
tied beams before the final ranking. Ties follow ``lax.top_k`` and the
stable ``jnp.argsort`` (the lower index first): at step 0 every dead
beam's candidates read ``NEG_INF``, and frozen finished beams tie the same
way.

Scoring: sums of token log-probs in f32 (float64 where the model runs in
float64, which makes two devices' searches comparable); finished beams
stop accumulating and are ranked by ``score / max(len, 1)^power``, and
finished hypotheses outrank unfinished ones. Shallow fusion with an
LM (``decoding.lm.DenseLM``, or ``decoding.neural_lm.DenseRnnLM``, whose
state is a dict of tensors) adds ``lm_weight * log p_lm(token |
history)`` to every candidate; the LM context rides the beam gather and
advances while a hypothesis is live.
"""

from __future__ import annotations

from typing import Tuple

import torch

from nabu_tpu_torch.decoding.ctc_beam import _top_w
from nabu_tpu_torch.decoding.lm import state_where
from nabu_tpu_torch.ops.masking import NEG_INF, sequence_mask


def tree_map(fn, tree):
    """``fn`` over the tensors of a decoder state (dicts, lists and tuples
    of tensors)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def gather_beams(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Reindex the beam axis (axis 1) of a [B, W, ...] tensor."""
    idx = idx.to(torch.int64).reshape(idx.shape + (1,) * (x.dim() - 2))
    return torch.gather(x, 1, idx.expand(idx.shape[:2] + x.shape[2:]))


def score_dtype(dtype: torch.dtype) -> torch.dtype:
    """f32 scores, or the model's own dtype where that is wider."""
    return torch.promote_types(dtype, torch.float32)


def _all_finished(finished: torch.Tensor) -> bool:
    """The loop's exit test: one host sync a step."""
    return bool(finished.all())


def initial_beam(decoder, encoded: torch.Tensor, W: int, max_steps: int, sdt) -> dict:
    """Beam 0 live (score 0), the others at ``NEG_INF``; the decoder state
    [B, W, ...]."""
    B, T, _ = encoded.shape
    dev = encoded.device
    scores = torch.full((B, W), NEG_INF, dtype=sdt, device=dev)
    scores[:, 0] = 0.0
    state = decoder.init_state(B * W, encoded.dtype, enc_frames=T, device=dev)
    return {
        "seqs": torch.zeros((B, W, max_steps), dtype=torch.int32, device=dev),
        "scores": scores,
        "finished": torch.zeros((B, W), dtype=torch.bool, device=dev),
        "lengths": torch.zeros((B, W), dtype=torch.int32, device=dev),
        "prev": torch.full((B, W), decoder.sos_id, dtype=torch.int32, device=dev),
        "state": tree_map(lambda x: x.reshape((B, W) + x.shape[1:]), state),
    }


def decoder_step(decoder, dparams, s: dict, encoded, enc_mask, keys):
    """One ``decoder.step`` over the flattened beam -> (log-probs [B, W, V]
    in the score dtype, new state [B, W, ...])."""
    B, W = s["prev"].shape
    flat = tree_map(lambda x: x.reshape((B * W,) + x.shape[2:]), s["state"])
    logits, new_state = decoder.step(dparams, s["prev"].reshape(B * W), flat, encoded,
                                     enc_mask, keys=keys)
    new_state.pop("attn_weights", None)
    new_state = tree_map(lambda x: x.reshape((B, W) + x.shape[1:]), new_state)
    logprobs = torch.log_softmax(
        logits.reshape(B, W, -1).to(s["scores"].dtype), dim=-1)
    return logprobs, new_state


def ranked(seqs, lengths, scores, finished, length_norm_power: float):
    """The final order: length-normalized score (eos left out of the
    length), finished hypotheses before unfinished ones, whose scores lack
    the final eos term."""
    norm = torch.clamp(lengths, min=1).to(scores.dtype) ** length_norm_power
    rank_key = scores / norm + torch.where(finished, 0.0, NEG_INF / 2)
    order = torch.argsort(-rank_key, dim=1, stable=True)
    return gather_beams(seqs, order), torch.gather(lengths, 1, order), torch.gather(
        scores, 1, order)


def attention_beam_search(
    decoder,
    dparams: dict,
    encoded: torch.Tensor,  # [B, T, D]
    enc_lengths: torch.Tensor,  # [B]
    beam_width: int,
    max_steps: int,
    length_norm_power: float = 0.0,
    eos_bonus: float = 0.0,
    lm=None,
    lm_weight: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (seqs [B, W, max_steps], lengths [B, W], scores [B, W]),
    beams sorted best-first by length-normalized score. ``decoder`` is a
    Speller-like head (step / init_state / precompute / sos_id / eos_id);
    ``lm`` a DenseLM or DenseRnnLM on the encoder output's device, fused
    where ``lm_weight`` is not 0."""
    fuse = lm is not None and lm_weight != 0.0
    B, T, _ = encoded.shape
    W = beam_width
    V = decoder.output_dim
    eos = decoder.eos_id
    dev = encoded.device
    enc_mask = sequence_mask(enc_lengths.to(dev), T)
    keys = decoder.precompute(dparams, encoded)  # step-invariant
    s = initial_beam(decoder, encoded, W, max_steps, score_dtype(encoded.dtype))
    # finished beams may only "extend" with eos, at zero cost
    frozen = torch.full((V,), NEG_INF, dtype=s["scores"].dtype, device=dev)
    frozen[eos] = 0.0
    pos = torch.arange(max_steps, device=dev)
    if fuse:
        s["lm"] = lm.init_state((B, W))

    t = 0
    while t < max_steps and not _all_finished(s["finished"]):
        logprobs, new_state = decoder_step(decoder, dparams, s, encoded, enc_mask, keys)
        if eos_bonus:
            logprobs[..., eos] += eos_bonus
        if fuse:
            logprobs = logprobs + lm_weight * lm.logprobs(s["lm"]).to(logprobs.dtype)
        cand = s["scores"][..., None] + torch.where(s["finished"][..., None], frozen, logprobs)
        top_scores, top_flat = _top_w(cand.reshape(B, W * V), W)
        parent = top_flat // V
        token = (top_flat % V).to(torch.int32)
        seqs = gather_beams(s["seqs"], parent)
        lengths = gather_beams(s["lengths"], parent)
        finished = gather_beams(s["finished"], parent)
        # the token goes to position t of the live beams
        write = ~finished
        seqs = torch.where(write[..., None] & (pos == t), token[..., None], seqs)
        lengths = torch.where(write & (token != eos), lengths + 1, lengths)
        new = {"seqs": seqs, "scores": top_scores, "finished": finished | (token == eos),
               "lengths": lengths, "prev": token,
               "state": tree_map(lambda x: gather_beams(x, parent), new_state)}
        if fuse:
            lm_state = tree_map(lambda x: gather_beams(x, parent), s["lm"])
            new["lm"] = state_where(finished, lm_state, lm.step(lm_state, token))
        s = new
        t += 1
    return ranked(s["seqs"], s["lengths"], s["scores"], s["finished"], length_norm_power)
