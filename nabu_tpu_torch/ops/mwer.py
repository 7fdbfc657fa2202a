"""MWER (minimum word error rate) sequence training.

Port of the JAX package's ``ops/mwer.py`` (Prabhavalkar et al. 2018,
"Minimum Word Error Rate Training for Attention-based Sequence-to-Sequence
Models"): an attention model fine-tuned on its own N-best lists. Per step,
for each utterance:

1. an N-best list from ``decoding.beam.attention_beam_search`` over an
   encoder pass without gradients (``torch.no_grad``, dropout off: the
   inference kernels);
2. every hypothesis re-scored teacher-forced: one ``apply`` of the head
   over B * N sequences that repeat the differentiable encoder pass (the
   training kernels, dropout on); like JAX's, that ``apply`` gets neither
   ``train`` nor a generator, so the Speller runs without dropout there;
3. each hypothesis's token edit distance to the reference on the device
   (``token_edit_distance``: a loop over hypothesis positions whose
   insertion chain is closed by one ``torch.cummin`` a position);
4. loss = sum_n p̂_n (W_n − W̄): p̂ the softmax of the sequence log-probs
   over the N-best (eos term included), W̄ the list's mean error count.

The cross-entropy interpolation (``mwer_ce_weight``) runs every configured
head, through ``ops.losses.LOSSES`` with its label smoothing, from the same
differentiable encoder pass, so a step costs two encoder passes.

Conf keys (``[trainer]``, with ``mwer = true``): ``mwer_beam`` (N, default
4), ``mwer_ce_weight`` (0.01), ``mwer_head`` (default: the first decoder
with ``step`` and ``init_state``, in the model's decoder order) and
``mwer_extra_steps`` (the decode budget beyond the reference length, 4).

Data-parallel training (``parallel.mesh``): the denominators (the real
examples, and each head's ``ops.losses.COUNTS``) are summed over the ranks
in one collective before any rank divides, so each rank's loss and
metrics are its shares of the global batch's, as in ``make_loss_computer``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from nabu_tpu_torch.decoding.beam import attention_beam_search
from nabu_tpu_torch.ops.losses import COUNTS
from nabu_tpu_torch.registry import LOSSES


def token_edit_distance(
    hyps: torch.Tensor,  # [B, L] int
    hyp_lengths: torch.Tensor,  # [B]
    refs: torch.Tensor,  # [B, U] int
    ref_lengths: torch.Tensor,  # [B]
) -> torch.Tensor:
    """Batched Levenshtein distance (substitution, insertion and deletion
    cost 1) between padded id sequences; returns [B] int32."""
    B, L = hyps.shape
    U = refs.shape[1]
    dev = hyps.device
    refs = refs.to(dev)
    j = torch.arange(U + 1, dtype=torch.int32, device=dev)
    hyp_lengths = hyp_lengths.to(dev)
    # row[j] = d(hyp[:i], ref[:j]); row 0 = j (delete the whole ref prefix)
    row = j.expand(B, U + 1).clone()
    for i in range(1, L + 1):
        sub = (hyps[:, i - 1, None] != refs).to(torch.int32)  # [B, U]
        # base[j] = min(row[j] + 1, row[j-1] + sub_j) for j >= 1; j = 0: i deletions
        base = torch.minimum(row[:, 1:] + 1, row[:, :-1] + sub)
        base = torch.cat([torch.full((B, 1), i, dtype=torch.int32, device=dev), base], dim=1)
        # the insertion chain new[j] = min(base[j], new[j-1] + 1), closed:
        # new[j] = j + cummin_{k<=j}(base[k] - k)
        new = torch.cummin(base - j, dim=1).values + j
        # rows past each hypothesis's length stay frozen
        row = torch.where((i <= hyp_lengths)[:, None], new, row)
    return torch.gather(row, 1, ref_lengths.to(dev).long()[:, None])[:, 0]


def mwer_head(model, conf) -> str:
    """The configured ``mwer_head``, else the first decoder with ``step``
    and ``init_state``."""
    head = conf.get("mwer_head") or next(
        (name for name, dec in model.decoders.items()
         if hasattr(dec, "step") and hasattr(dec, "init_state")), None)
    if head is None:
        raise ValueError("MWER needs an autoregressive (speller) head to decode N-best "
                         "lists from; this model has none")
    return head


def make_mwer_loss_computer(model, conf, sum_over_ranks: Optional[Callable] = None) -> Callable:
    """Loss computer with ``ops.losses.make_loss_computer``'s contract,
    ``loss_fn(params, batch, generator, train) -> (scalar, metrics)``, over
    the model's attention head. ``loss_fn(..., nbest=(seqs, lengths))``
    re-scores a given N-best ([B, N, U + extra], [B, N]) instead of
    searching; ``loss_fn.search(params, batch)`` returns the one it would
    search."""
    head = mwer_head(model, conf)
    dec = model.decoders[head]
    N = conf.getint("mwer_beam", 4)
    ce_weight = conf.getfloat("mwer_ce_weight", 0.01)
    extra = conf.getint("mwer_extra_steps", 4)
    head_specs = {}
    for name in model.decoders:
        loss_name, weight = model.head_loss(name)
        head_specs[name] = (
            LOSSES.get(loss_name), weight,
            model.head_confs[name].getfloat("label_smoothing", 0.0),
            getattr(model.decoders[name], "blank_id", None),
        )

    @torch.no_grad()
    def search(params, batch):
        """Step 1: the N-best, without gradients (the inference kernels) and
        dropout off."""
        enc, enc_lens = model.encode(params, batch["features"], batch["feature_lengths"],
                                     train=False)
        seqs, lens, _ = attention_beam_search(
            dec, model._cast_in(params["decoders"][head]), enc, enc_lens, beam_width=N,
            max_steps=batch["targets"].shape[1] + extra)
        return seqs, lens

    def loss_fn(params, batch, generator, train: bool, nbest=None):
        tgts, tlens = batch["targets"], batch["target_lengths"]
        emask = batch["example_mask"].to(torch.float32)
        B = tgts.shape[0]
        seqs, hyp_lens = search(params, batch) if nbest is None else nbest
        max_steps = seqs.shape[2]

        # 2. teacher-forced re-scoring over the differentiable encoder pass
        encoded, enc_lens = model.encode(params, batch["features"], batch["feature_lengths"],
                                         train=train, generator=generator)
        dev = encoded.device
        hyp = seqs.reshape(B * N, max_steps).to(dev)
        hyp_len = hyp_lens.reshape(B * N).to(dev)
        logits, _ = dec.apply(
            model._cast_in(params["decoders"][head]),
            torch.repeat_interleave(encoded, N, dim=0),
            torch.repeat_interleave(enc_lens, N, dim=0), targets=hyp, target_lengths=hyp_len,
        )  # [B*N, max_steps+1, V]
        logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
        # the token at position t: hyp_t for t < len, eos at t == len
        pos = torch.arange(max_steps + 1, device=dev)[None, :]
        tok = torch.cat([hyp.long(), torch.full((B * N, 1), dec.eos_id, device=dev)], dim=1)
        tok = torch.where(pos == hyp_len[:, None], dec.eos_id, tok)
        tok_lp = torch.gather(logp, -1, tok[..., None])[..., 0]
        seq_logp = torch.where(pos <= hyp_len[:, None], tok_lp, 0.0).sum(dim=1).reshape(B, N)

        # 3. token errors against the reference
        errs = token_edit_distance(
            hyp, hyp_len, torch.repeat_interleave(tgts.to(dev), N, dim=0),
            torch.repeat_interleave(tlens.to(dev), N, dim=0),
        ).reshape(B, N).to(torch.float32)

        # 5's head outputs first: their denominators travel with emask's
        heads = {}
        if ce_weight != 0.0:
            for name in head_specs:
                hlogits, hlens = model.decoders[name].apply(
                    model._cast_in(params["decoders"][name]), encoded, enc_lens,
                    targets=tgts, target_lengths=tlens, train=train, generator=generator)
                if not isinstance(hlogits, dict) and hlogits.dim() < 4:
                    hlogits = hlogits.to(torch.float32)
                heads[name] = (hlogits, hlens)
        counts = dict.fromkeys(heads)
        local = [emask.sum()[None]]
        if sum_over_ranks is not None:
            local += [COUNTS[head_specs[name][0]](*out, tgts, tlens, batch["example_mask"])
                      for name, out in heads.items()]
            summed = sum_over_ranks(torch.cat(local))
            local = summed.split([len(c) for c in local])
            counts = dict(zip(heads, local[1:]))
        denom = torch.clamp(local[0][0], min=1.0)

        # 4. expected relative risk over the renormalized N-best
        p_hat = torch.softmax(seq_logp, dim=1)
        w_bar = errs.mean(dim=1, keepdim=True)
        mwer = torch.sum((p_hat * (errs - w_bar)).sum(dim=1) * emask) / denom
        total = mwer
        metrics: Dict[str, torch.Tensor] = {
            "loss/mwer": mwer.detach(),
            "mwer/expected_errors": torch.sum((p_hat * errs).sum(dim=1) * emask).detach() / denom,
            "mwer/oracle_errors": torch.sum(errs.min(dim=1).values * emask) / denom,
        }

        # 5. the cross-entropy interpolation and the auxiliary heads
        for name, (hlogits, hlens) in heads.items():
            fn, weight, smoothing, blank_id = head_specs[name]
            loss, m = fn(hlogits, hlens, tgts, tlens, batch["example_mask"],
                         label_smoothing=smoothing, blank_id=blank_id, counts=counts[name])
            total = total + ce_weight * weight * loss
            metrics[f"loss/{name}"] = loss.detach()
            for k, v in m.items():
                metrics[f"{name}/{k}"] = v
        metrics["loss"] = total.detach()
        return total, metrics

    loss_fn.search = search
    return loss_fn
