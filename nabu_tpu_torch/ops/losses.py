"""Loss computers: CTC, RNN-T, label-smoothed cross-entropy, and the weighted
multi-head combination.

Port of the JAX package's ``ops/losses.py``. Every loss masks padding by
sequence length and fill examples by ``example_mask``; the CTC loss
reduces to a mean over real, feasible examples, the transducer loss over
real examples, the label-smoothed cross-entropy over real target tokens.

Data-parallel training (``parallel.mesh``) needs the JAX package's mean
over the GLOBAL batch, which a mean of the ranks' means is not where the
ranks hold different numbers of real examples or tokens. So each loss
has a function of its denominators (``COUNTS``: a small f32 vector of
the examples, tokens and frames its means divide by) and takes them as
``counts``: a rank that divides its own sums by the global counts holds
its share of the global loss and of each metric, and the sum of the
ranks' gradients is the global gradient. Without ``counts`` a loss
divides by its own batch's, as before.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from nabu_tpu_torch.ops import ctc as ctc_ops
from nabu_tpu_torch.ops.ctc_batched import ctc_loss_batched
from nabu_tpu_torch.ops.transducer import transducer_loss
from nabu_tpu_torch.ops.transducer_fused import transducer_loss_fused
from nabu_tpu_torch.registry import LOSSES


@LOSSES.register("ctc")
def ctc_loss_fn(
    logits: torch.Tensor,  # [B, T, V+1] f32
    logit_lengths: torch.Tensor,
    targets: torch.Tensor,  # [B, L]
    target_lengths: torch.Tensor,
    example_mask: torch.Tensor,  # [B] float
    label_smoothing: float = 0.0,
    blank_id: int | None = None,
    counts: torch.Tensor | None = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean per-example CTC negative log likelihood, always through the
    CTC kernels (``ops.ctc_batched``; their plain versions for CPU
    tensors), whatever the recipe's ``use_pallas`` says: the plain
    oracle ``ops.ctc.ctc_loss`` serves the tests only.

    Examples with no feasible alignment are left out of the loss mean
    and counted in ``ctc_infeasible_frac``. ``counts``: ``ctc_counts``
    summed over the ranks (data-parallel training)."""
    del label_smoothing  # not applicable to CTC
    feasible, mask = _ctc_masks(logit_lengths, targets, target_lengths, example_mask)
    if counts is None:
        counts = ctc_counts(logits, logit_lengths, targets, target_lengths, example_mask)
    if blank_id is None:
        blank_id = logits.shape[-1] - 1
    nll = ctc_loss_batched(logits, logit_lengths, targets, target_lengths, blank_id)
    denom, real, frames = torch.clamp(counts, min=1.0).unbind()
    loss = torch.sum(nll * mask) / denom
    return loss, {
        "ctc_nll_per_frame": torch.sum(nll * mask).detach() / frames,
        "ctc_infeasible_frac": torch.sum(example_mask * (1.0 - feasible)) / real,
    }


def _ctc_masks(logit_lengths, targets, target_lengths, example_mask):
    """-> (feasible [B], real and feasible [B]), in the mask's dtype."""
    feasible = ctc_ops.ctc_feasible(
        logit_lengths, targets, target_lengths).to(example_mask.dtype)
    return feasible, example_mask * feasible


def ctc_counts(logits, logit_lengths, targets, target_lengths, example_mask) -> torch.Tensor:
    """CTC's denominators: [real feasible examples, real examples, the
    real feasible examples' frames]."""
    _, mask = _ctc_masks(logit_lengths, targets, target_lengths, example_mask)
    return torch.stack([mask.sum(), example_mask.sum(), torch.sum(logit_lengths * mask)])


@LOSSES.register("transducer")
@LOSSES.register("rnnt")
def transducer_loss_fn(
    logits,  # [B, T, U+1, V+1] lattice, or the head's projection dict
    logit_lengths: torch.Tensor,  # [B] valid encoder frames
    targets: torch.Tensor,  # [B, U]
    target_lengths: torch.Tensor,
    example_mask: torch.Tensor,
    label_smoothing: float = 0.0,
    blank_id: int | None = None,
    counts: torch.Tensor | None = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean per-example RNN-T negative log likelihood. A dict (the
    transducer head's projection handle, always on CUDA) goes through the
    fused joint+loss kernels (``ops.transducer_fused``; their plain
    versions for CPU tensors); a materialized lattice (the CPU path with
    ``use_pallas = false``) through ``ops.transducer.transducer_loss``."""
    del label_smoothing  # not applicable to the transducer
    if isinstance(logits, dict):
        nll = transducer_loss_fused(
            logits["enc_proj"], logits["pred_proj"], logits["w_out"], logits["b_out"],
            logit_lengths, targets, target_lengths, blank_id,
        )
    else:
        nll = transducer_loss(logits, logit_lengths, targets, target_lengths, blank_id)
    if counts is None:
        counts = transducer_counts(None, logit_lengths, targets, target_lengths, example_mask)
    denom, frames = torch.clamp(counts, min=1.0).unbind()
    loss = torch.sum(nll * example_mask) / denom
    return loss, {
        "transducer_nll_per_frame": torch.sum(nll * example_mask).detach() / frames
    }


def transducer_counts(logits, logit_lengths, targets, target_lengths,
                      example_mask) -> torch.Tensor:
    """The transducer's denominators: [real examples, their frames]."""
    return torch.stack([example_mask.sum(), torch.sum(logit_lengths * example_mask)])


@LOSSES.register("cross_entropy")
@LOSSES.register("ce")
def cross_entropy_loss_fn(
    logits: torch.Tensor,  # [B, L+1, V+1] f32 (the speller's output, eos step included)
    logit_lengths: torch.Tensor,  # [B] == target_lengths + 1
    targets: torch.Tensor,  # [B, L] (no eos)
    target_lengths: torch.Tensor,
    example_mask: torch.Tensor,
    label_smoothing: float = 0.0,
    blank_id=None,
    counts: torch.Tensor | None = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Label-smoothed sequence cross-entropy with <eos> (the last output,
    V) appended at ``target_lengths``; smoothing spreads over all V + 1
    outputs. The token mean over real (non-pad, non-fill) positions, eos
    included, and the ``token_accuracy`` metric over the same positions."""
    del blank_id
    B, Lp1, V = logits.shape
    eos_id = V - 1
    dev = logits.device
    pad_tgt = torch.nn.functional.pad(targets.to(dev).long(), (0, Lp1 - targets.shape[1]))
    pos, tl, valid = _ce_positions(Lp1, target_lengths, example_mask, dev)
    tgt_ext = torch.where(pos == tl, eos_id, pad_tgt)
    logprobs = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logprobs, -1, tgt_ext[..., None])[..., 0]
    if label_smoothing > 0.0:
        nll = (1.0 - label_smoothing) * nll + label_smoothing * -logprobs.mean(dim=-1)
    if counts is None:
        counts = valid.sum().to(torch.float32)[None]
    denom = torch.clamp(counts[0], min=1.0)
    loss = torch.where(valid, nll, 0.0).sum() / denom
    hits = valid & (torch.argmax(logits.detach(), dim=-1) == tgt_ext)
    return loss, {"token_accuracy": hits.sum() / denom}


def _ce_positions(Lp1: int, target_lengths, example_mask, dev):
    """-> (positions [1, L+1], target lengths [B, 1], real positions [B,
    L+1], eos included)."""
    pos = torch.arange(Lp1, device=dev)[None, :]
    tl = target_lengths.to(dev).long()[:, None]
    return pos, tl, (pos <= tl) & (example_mask.to(dev)[:, None] > 0)


def cross_entropy_counts(logits, logit_lengths, targets, target_lengths,
                         example_mask) -> torch.Tensor:
    """The cross-entropy's denominator: [real target positions] (f32)."""
    _, _, valid = _ce_positions(logits.shape[1], target_lengths, example_mask, logits.device)
    return valid.sum().to(torch.float32)[None]


# each registered loss's denominators (same arguments, smoothing and
# blank aside), for data-parallel training's global counts
COUNTS = {ctc_loss_fn: ctc_counts, transducer_loss_fn: transducer_counts,
          cross_entropy_loss_fn: cross_entropy_counts}


def make_loss_computer(model, sum_over_ranks: Optional[Callable] = None) -> Callable:
    """The multi-head weighted loss of a Model:
    ``loss_fn(params, batch, generator, train) -> (scalar, metrics)``,
    batch the dict of ``data.pipeline.batch_to_device``; ``train``
    switches dropout. Gradients flow to the parameters.

    ``sum_over_ranks`` (data-parallel training: ``parallel.mesh.
    sum_over_ranks``) sums a small tensor over the ranks. Every head's
    denominators then go through it together, one collective after the
    forward, and the loss and metrics are this rank's shares of the
    global batch's: summed over the ranks they are the global values."""
    head_specs = {}
    for name in model.decoders:
        loss_name, weight = model.head_loss(name)
        blank_id = getattr(model.decoders[name], "blank_id", None)
        smoothing = model.head_confs[name].getfloat("label_smoothing", 0.0)
        head_specs[name] = (LOSSES.get(loss_name), weight, smoothing, blank_id)

    def loss_fn(params, batch, generator, train: bool):
        outputs = model.apply_train(
            params,
            batch["features"],
            batch["feature_lengths"],
            targets=batch.get("targets"),
            target_lengths=batch.get("target_lengths"),
            train=train,
            generator=generator,
        )
        counts = dict.fromkeys(head_specs)
        if sum_over_ranks is not None:
            local = [COUNTS[fn](*outputs[name], batch["targets"], batch["target_lengths"],
                                batch["example_mask"])
                     for name, (fn, *_) in head_specs.items()]
            summed = sum_over_ranks(torch.cat(local))
            counts = dict(zip(head_specs, summed.split([len(c) for c in local])))
        total = 0.0
        metrics: Dict[str, torch.Tensor] = {}
        for name, (fn, weight, smoothing, blank_id) in head_specs.items():
            logits, logit_lengths = outputs[name]
            loss, m = fn(
                logits, logit_lengths, batch["targets"], batch["target_lengths"],
                batch["example_mask"], label_smoothing=smoothing, blank_id=blank_id,
                counts=counts[name],
            )
            total = total + weight * loss
            metrics[f"loss/{name}"] = loss.detach()
            for k, v in m.items():
                metrics[f"{name}/{k}"] = v
        metrics["loss"] = total.detach()
        return total, metrics

    return loss_fn
