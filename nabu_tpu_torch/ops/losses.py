"""Loss computers: CTC, RNN-T, and the weighted multi-head combination.

Port of the JAX package's ``ops/losses.py``. Every loss masks padding by
sequence length and fill examples by ``example_mask``; the CTC loss
reduces to a mean over real, feasible examples, the transducer loss over
real examples. The cross-entropy loss is registered but not ported yet.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

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
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean per-example CTC negative log likelihood, always through the
    CTC kernels (``ops.ctc_batched``; their plain versions for CPU
    tensors), whatever the recipe's ``use_pallas`` says: the plain
    oracle ``ops.ctc.ctc_loss`` serves the tests only.

    Examples with no feasible alignment are left out of the loss mean
    and counted in ``ctc_infeasible_frac``."""
    del label_smoothing  # not applicable to CTC
    feasible = ctc_ops.ctc_feasible(
        logit_lengths, targets, target_lengths).to(example_mask.dtype)
    if blank_id is None:
        blank_id = logits.shape[-1] - 1
    nll = ctc_loss_batched(logits, logit_lengths, targets, target_lengths, blank_id)
    real = torch.clamp(example_mask.sum(), min=1.0)
    mask = example_mask * feasible
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = torch.sum(nll * mask) / denom
    frames = torch.clamp(torch.sum(logit_lengths * mask), min=1.0)
    return loss, {
        "ctc_nll_per_frame": torch.sum(nll * mask).detach() / frames,
        "ctc_infeasible_frac": torch.sum(example_mask * (1.0 - feasible)) / real,
    }


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
    denom = torch.clamp(example_mask.sum(), min=1.0)
    loss = torch.sum(nll * example_mask) / denom
    frames = torch.clamp(torch.sum(logit_lengths * example_mask), min=1.0)
    return loss, {
        "transducer_nll_per_frame": torch.sum(nll * example_mask).detach() / frames
    }


def _not_ported(name):
    def loss(*args, **kwargs):
        raise NotImplementedError(f"loss {name!r} not ported yet")
    return loss


for _name in ("cross_entropy", "ce"):
    LOSSES.register(_name)(_not_ported(_name))


def make_loss_computer(model) -> Callable:
    """The multi-head weighted loss of a Model:
    ``loss_fn(params, batch, generator, train) -> (scalar, metrics)``,
    batch the dict of ``data.pipeline.batch_to_device``; ``train``
    switches dropout. Gradients flow to the parameters."""
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
        total = 0.0
        metrics: Dict[str, torch.Tensor] = {}
        for name, (fn, weight, smoothing, blank_id) in head_specs.items():
            logits, logit_lengths = outputs[name]
            loss, m = fn(
                logits, logit_lengths, batch["targets"], batch["target_lengths"],
                batch["example_mask"], label_smoothing=smoothing, blank_id=blank_id,
            )
            total = total + weight * loss
            metrics[f"loss/{name}"] = loss.detach()
            for k, v in m.items():
                metrics[f"{name}/{k}"] = v
        metrics["loss"] = total.detach()
        return total, metrics

    return loss_fn
