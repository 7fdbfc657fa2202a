"""Loss computers: CTC, and the weighted multi-head combination.

Port of the JAX package's ``ops/losses.py``. Every loss masks padding by
sequence length and fill examples by ``example_mask``; the CTC loss
reduces to a mean over real, feasible examples. The cross-entropy and
transducer losses are registered but not ported yet.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from nabu_tpu_torch.ops import ctc as ctc_ops
from nabu_tpu_torch.ops.ctc_batched import ctc_loss_batched
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


def _not_ported(name):
    def loss(*args, **kwargs):
        raise NotImplementedError(f"loss {name!r} not ported yet")
    return loss


for _name in ("cross_entropy", "ce", "transducer", "rnnt"):
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
