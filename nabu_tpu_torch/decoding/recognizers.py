"""Recognizers: batched decoders over a model.

Port of the CTC recognizers of the JAX package's
``decoding/recognizers.py``. Every recognizer maps ``(params, features,
feature_lengths) -> Nbest``; features may be a numpy array or a tensor
already on the model's device (the device frontend's output).
Attention, transducer and joint recognizers are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from nabu_tpu_torch.config import Conf
from nabu_tpu_torch.decoding.ctc_beam import ctc_prefix_beam_search
from nabu_tpu_torch.ops import ctc as ctc_ops
from nabu_tpu_torch.ops.masking import sequence_mask
from nabu_tpu_torch.registry import RECOGNIZERS


@dataclasses.dataclass
class Nbest:
    """Decode result: ids [B, N, L], lengths [B, N], scores [B, N]."""

    ids: np.ndarray
    lengths: np.ndarray
    scores: np.ndarray

    def best(self, b: int) -> List[int]:
        return list(self.ids[b, 0, : self.lengths[b, 0]])


def _as_tensor(x, device, dtype=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


class Recognizer:
    """Base recognizer built from a recognizer.cfg section."""

    def __init__(self, conf: Conf, model, head: Optional[str] = None):
        self.conf = conf
        self.model = model
        self.head = head or conf.get("head") or next(iter(model.decoders))
        self.decoder = model.decoders[self.head]
        self.lm_weight = conf.getfloat("lm_weight", 0.0)
        if conf.get("lm_path") and self.lm_weight != 0.0:
            raise NotImplementedError("LM fusion not ported yet")
        if not hasattr(self.decoder, "blank_id"):
            raise ValueError(
                f"head {self.head!r} ({type(self.decoder).__name__}) is "
                "not a frame-synchronous CTC head — point this "
                "recognizer at the CTC head (`head = ctc`)"
            )
        self.blank_id = self.decoder.blank_id

    def _logprobs(self, params, features, feature_lengths, device):
        feats = _as_tensor(features, device, torch.float32)
        lens = _as_tensor(feature_lengths, device, torch.int32)
        outputs = self.model.apply(params, feats, lens, heads=(self.head,))
        logits, logit_lengths = outputs[self.head]
        return torch.log_softmax(logits, dim=-1), logit_lengths

    def __call__(self, params, features, feature_lengths) -> Nbest:
        raise NotImplementedError


@RECOGNIZERS.register("ctc_greedy")
@RECOGNIZERS.register("max")
class CTCGreedyRecognizer(Recognizer):
    """Per-frame argmax + CTC collapse."""

    @torch.no_grad()
    def __call__(self, params, features, feature_lengths) -> Nbest:
        device = params["decoders"][self.head]["out"]["w"].device
        logprobs, logit_lengths = self._logprobs(
            params, features, feature_lengths, device
        )
        best, frame_ids = logprobs.max(dim=-1)
        score = torch.sum(
            best * sequence_mask(logit_lengths, logprobs.shape[1]), dim=-1
        )
        ids, lengths = ctc_ops.ctc_greedy_collapse(
            frame_ids, logit_lengths, self.blank_id
        )
        return Nbest(
            ids=ids.cpu().numpy()[:, None, :],
            lengths=lengths.cpu().numpy()[:, None],
            scores=score.cpu().numpy()[:, None],
        )


@RECOGNIZERS.register("ctc_beam")
class CTCBeamRecognizer(Recognizer):
    """Batched CTC prefix beam search. conf: beam_width, nbest,
    max_label_len."""

    def __init__(self, conf, model, head=None):
        super().__init__(conf, model, head)
        self.beam_width = conf.getint("beam_width", 4)
        self.nbest = min(conf.getint("nbest", 1), self.beam_width)
        self.max_label_len = conf.getint("max_label_len", 0)

    def decode_logprobs(self, logprobs, logit_lengths):
        return ctc_prefix_beam_search(
            logprobs,
            logit_lengths,
            beam_width=self.beam_width,
            blank_id=self.blank_id,
            max_label_len=self.max_label_len or None,
        )

    @torch.no_grad()
    def __call__(self, params, features, feature_lengths) -> Nbest:
        device = params["decoders"][self.head]["out"]["w"].device
        logprobs, logit_lengths = self._logprobs(
            params, features, feature_lengths, device
        )
        seqs, lengths, scores = self.decode_logprobs(logprobs, logit_lengths)
        n = self.nbest
        return Nbest(
            ids=seqs[:, :n].cpu().numpy(),
            lengths=lengths[:, :n].cpu().numpy(),
            scores=scores[:, :n].cpu().numpy(),
        )


def build_recognizer(conf: Conf, model) -> Recognizer:
    """Factory by conf['recognizer']."""
    name = conf.get("recognizer", "ctc_greedy")
    if name.lower() not in RECOGNIZERS.names():
        raise NotImplementedError(f"recognizer {name!r} not ported yet")
    return RECOGNIZERS.build(name, conf, model)
