"""Evaluators: dev-set loss and decode-based error rate.

Port of the JAX package's ``evaluators.py``: an evaluator is built from
a validation/test evaluator config section and maps trained params to a
scalar metric (lower is better), used for validation-driven early
stopping and for scoring.

In data-parallel training each rank is given a loader of its shard of
the dev set (``host_id`` / ``num_hosts``) and scores it on its own
device; the loss or error counts are summed over the ranks
(``parallel.mesh.all_reduce_sum``), so every rank returns the same
metric of the whole set. The JAX package's model-parallel evaluation
mesh is not ported yet.
"""

from __future__ import annotations

from typing import List

import torch

from nabu_tpu_torch.config import Conf
from nabu_tpu_torch.data.pipeline import BucketedLoader, batch_to_arrays, batch_to_device
from nabu_tpu_torch.decoding.recognizers import build_recognizer
from nabu_tpu_torch.decoding.scorer import error_rate
from nabu_tpu_torch.ops.losses import make_loss_computer
from nabu_tpu_torch.parallel import mesh
from nabu_tpu_torch.params import flatten
from nabu_tpu_torch.registry import EVALUATORS


class Evaluator:
    def __init__(self, conf: Conf, model, loader: BucketedLoader):
        self.conf = conf
        self.model = model
        self.loader = loader

    def evaluate(self, params) -> float:
        raise NotImplementedError

    def __call__(self, params) -> float:
        return self.evaluate(params)


def _device_of(params) -> torch.device:
    return next(iter(flatten(params).values())).device


@EVALUATORS.register("loss")
class LossEvaluator(Evaluator):
    """Mean loss over the dev set (dropout off)."""

    def __init__(self, conf, model, loader):
        super().__init__(conf, model, loader)
        self.loss_fn = make_loss_computer(model)

    @torch.no_grad()
    def evaluate(self, params) -> float:
        device = _device_of(params)
        total = 0.0
        count = 0.0
        for batch in self.loader.epoch(0, shuffle=False):
            arrays = batch_to_device(batch_to_arrays(batch), device,
                                     self.model.compute_dtype)
            loss = self.loss_fn(params, arrays, None, False)[0]
            n = float(arrays["example_mask"].sum())
            total += float(loss) * n
            count += n
        total, count = mesh.all_reduce_sum((total, count))
        return total / max(count, 1.0)


@EVALUATORS.register("decoder")
@EVALUATORS.register("error_rate")
class DecoderEvaluator(Evaluator):
    """Run a recognizer over the dev set, return the token error rate
    (CER/PER/WER depending on the target unit)."""

    def __init__(self, conf, model, loader):
        super().__init__(conf, model, loader)
        self.recognizer = build_recognizer(conf, model)

    def evaluate(self, params) -> float:
        refs: List[List[int]] = []
        hyps: List[List[int]] = []
        for batch in self.loader.epoch(0, shuffle=False):
            result = self.recognizer(params, batch.features, batch.feature_lengths)
            for b in range(len(batch.utt_ids)):
                if not batch.example_mask[b]:
                    continue
                refs.append(list(batch.targets[b, : batch.target_lengths[b]]))
                hyps.append(result.best(b))
        _, errors, tokens = error_rate(refs, hyps)
        errors, tokens = mesh.all_reduce_sum((errors, tokens))
        return errors / max(tokens, 1.0)


def build_evaluator(conf: Conf, model, loader) -> Evaluator:
    """Factory by conf['evaluator']."""
    name = conf.get("evaluator", "loss")
    if name.lower() not in EVALUATORS.names():
        raise NotImplementedError(f"evaluator {name!r} not ported yet")
    return EVALUATORS.build(name, conf, model, loader)
