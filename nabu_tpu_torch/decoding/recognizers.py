"""Recognizers: batched decoders over a model.

Port of the JAX package's ``decoding/recognizers.py``: CTC greedy and
prefix beam, attention greedy and beam, the joint CTC/attention one-pass
beam and two-pass rescoring, transducer greedy, beam and streaming. The
four beam searches (``ctc_beam``, ``attention_beam``,
``joint_ctc_att_beam``, ``transducer_beam``) fuse an LM named by
``lm_path`` with ``lm_weight`` (``cli lm`` writes one, n-gram or neural);
it is loaded on the CPU and moves to the device of each search
(``lm_on``), in its own dtype. Every recognizer maps ``(params, features,
feature_lengths) -> Nbest``; features may be a numpy array or a tensor
already on the model's device (the device frontend's output). The beam
recognizers over an encoder output split into ``_encode``, ``search``
(tensors on the model's device) and ``nbest_of``, so one search can run
on two devices over the same encoder output.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from nabu_tpu_torch.config import Conf
from nabu_tpu_torch.decoding.beam import attention_beam_search, gather_beams, score_dtype
from nabu_tpu_torch.decoding.ctc_beam import ctc_prefix_beam_search
from nabu_tpu_torch.decoding.joint import joint_ctc_att_beam_search
from nabu_tpu_torch.decoding.streaming import StreamingTransducer
from nabu_tpu_torch.decoding.transducer import (
    transducer_beam_search,
    transducer_greedy_search,
)
from nabu_tpu_torch.ops import ctc as ctc_ops
from nabu_tpu_torch.ops.masking import NEG_INF, sequence_mask
from nabu_tpu_torch.registry import RECOGNIZERS


@dataclasses.dataclass
class Nbest:
    """Decode result: ids [B, N, L], lengths [B, N], scores [B, N]."""

    ids: np.ndarray
    lengths: np.ndarray
    scores: np.ndarray

    def best(self, b: int) -> List[int]:
        return list(self.ids[b, 0, : self.lengths[b, 0]])

    def nbest(self, b: int):
        return [
            (float(self.scores[b, n]), list(self.ids[b, n, : self.lengths[b, n]]))
            for n in range(self.ids.shape[1])
        ]


def _as_tensor(x, device, dtype=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


class Recognizer:
    """Base recognizer built from a recognizer.cfg section; but for the
    attention recognizer, the head must be frame-synchronous (CTC or
    transducer: it has a ``blank_id``).

    Beam recognizers accept ``lm_path`` (an n-gram or neural LM ``.npz``
    of ``cli lm``) and ``lm_weight`` for shallow fusion; naming them on a
    recognizer without fusion is an error, not a silent no-op, and so is
    an LM of another vocabulary than the head's."""

    frame_synchronous = True
    supports_lm_fusion = False

    def __init__(self, conf: Conf, model, head: Optional[str] = None):
        self.conf = conf
        self.model = model
        self.head = head or conf.get("head") or next(iter(model.decoders))
        self.decoder = model.decoders[self.head]
        self.lm = None
        self.lm_weight = conf.getfloat("lm_weight", 0.0)
        lm_path = conf.get("lm_path")
        if lm_path and self.lm_weight != 0.0:
            if not self.supports_lm_fusion:
                raise ValueError(
                    f"recognizer {type(self).__name__} does not support "
                    "LM shallow fusion (lm_path/lm_weight); use a beam "
                    "recognizer or `run rescore`"
                )
            from nabu_tpu_torch.decoding.lm import load_dense_lm

            self.lm = load_dense_lm(lm_path, "cpu")
            if self.lm.vocab != self.decoder.output_dim:
                raise ValueError(
                    f"LM vocab {self.lm.vocab} != model output vocab "
                    f"{self.decoder.output_dim} — the LM must be "
                    "trained on this recipe's alphabet (`run lm`)"
                )
        if not self.frame_synchronous:
            return
        if not hasattr(self.decoder, "blank_id"):
            raise ValueError(
                f"head {self.head!r} ({type(self.decoder).__name__}) is "
                "not a frame-synchronous CTC head — point this "
                "recognizer at the CTC head (`head = ctc`)"
            )
        self.blank_id = self.decoder.blank_id

    def _encode(self, params, features, feature_lengths):
        """-> (encoder output, its lengths, the head's parameters in the
        compute dtype), on the head's device."""
        device = params["decoders"][self.head]["out"]["w"].device
        encoded, enc_lengths = self.model.encode(
            params, _as_tensor(features, device, torch.float32),
            _as_tensor(feature_lengths, device, torch.int32))
        return encoded, enc_lengths, self.model._cast_in(params["decoders"][self.head])

    def lm_on(self, device):
        """The fused LM on ``device`` (None without fusion)."""
        return None if self.lm is None else self.lm.to(device)

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
    max_label_len, lm_path / lm_weight."""

    supports_lm_fusion = True

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
            lm=self.lm_on(logprobs.device),
            lm_weight=self.lm_weight,
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


@RECOGNIZERS.register("attention_greedy")
class AttentionGreedyRecognizer(Recognizer):
    """Autoregressive argmax decode of an attention Speller head: the
    encoder once, then up to ``max_steps`` (default ``max(int(T_enc *
    max_length_ratio), 8)``, ratio 1.0) steps of the head, each scored by
    an f32 log-softmax; a hypothesis emits <eos> from its first <eos> on
    and its score stops there. On the card it is a Python loop of steps,
    as the transducer greedy search is. conf: max_steps,
    max_length_ratio."""

    frame_synchronous = False

    def __init__(self, conf, model, head=None):
        super().__init__(conf, model, head)
        if not hasattr(self.decoder, "step"):
            raise ValueError(f"head {self.head!r} is not autoregressive")
        self.max_steps = conf.getint("max_steps", 0)
        self.length_ratio = conf.getfloat("max_length_ratio", 1.0)

    @torch.no_grad()
    def search(self, params, features, feature_lengths):
        """-> (ids [B, max_steps], lengths [B], scores [B]) tensors on the
        model's device."""
        encoded, enc_lengths, dparams = self._encode(params, features, feature_lengths)
        B, T, _ = encoded.shape
        device = encoded.device
        dec = self.decoder
        enc_mask = sequence_mask(enc_lengths, T)
        max_steps = self.max_steps or max(int(T * self.length_ratio), 8)
        keys = dec.precompute(dparams, encoded)
        prev = torch.full((B,), dec.sos_id, dtype=torch.int64, device=device)
        state = dec.init_state(B, encoded.dtype, enc_frames=T, device=device)
        finished = torch.zeros((B,), dtype=torch.bool, device=device)
        score = torch.zeros((B,), dtype=torch.float32, device=device)
        ids = []
        for _ in range(max_steps):
            logits, state = dec.step(dparams, prev, state, encoded, enc_mask, keys=keys)
            state.pop("attn_weights", None)
            logprobs = torch.log_softmax(logits.float(), dim=-1)
            best, nxt = logprobs.max(dim=-1)
            score = score + torch.where(finished, 0.0, best)
            prev = torch.where(finished, dec.eos_id, nxt)
            finished = finished | (nxt == dec.eos_id)
            ids.append(prev)
        ids = torch.stack(ids, dim=1)
        is_eos = ids == dec.eos_id
        lengths = torch.where(is_eos.any(dim=1), torch.argmax(is_eos.int(), dim=1),
                              ids.shape[1])
        return ids, lengths, score

    def __call__(self, params, features, feature_lengths) -> Nbest:
        ids, lengths, scores = (x.cpu().numpy() for x in
                                self.search(params, features, feature_lengths))
        return Nbest(ids=ids[:, None, :], lengths=lengths[:, None], scores=scores[:, None])


def _attention_head(conf, model, head, what: str) -> str:
    """The attention head of a multi-head recognizer: ``head``, else
    ``att_head`` / ``head`` in the conf, else the first head that steps."""
    att = head or conf.get("att_head") or conf.get("head") or next(
        (n for n, d in model.decoders.items() if hasattr(d, "step")), None)
    if att is None or not hasattr(model.decoders[att], "step"):
        raise ValueError(f"{what} needs an attention head")
    return att


def _ctc_head(conf, model, what: str) -> str:
    """``ctc_head`` of the conf, else the first head that trains with CTC."""
    ctc = conf.get("ctc_head") or next(
        (n for n, d in model.decoders.items() if getattr(d, "default_loss", None) == "ctc"),
        None)
    if ctc is None:
        raise ValueError(f"{what} needs a CTC head")
    return ctc


class _AttentionBeam(Recognizer):
    """Base of the attention head's beam searches: conf beam_width, nbest,
    max_steps (default ``max(int(T_enc * max_length_ratio), 8)``, ratio
    1.0), length_norm_power, lm_path / lm_weight. ``__call__`` is
    ``nbest_of(search(_encode(...)))``."""

    frame_synchronous = False
    supports_lm_fusion = True

    def __init__(self, conf, model, head=None):
        super().__init__(conf, model, head)
        if not hasattr(self.decoder, "step"):
            raise ValueError(f"head {self.head!r} is not autoregressive")
        self.beam_width = conf.getint("beam_width", 4)
        self.nbest = min(conf.getint("nbest", 1), self.beam_width)
        self.max_steps = conf.getint("max_steps", 0)
        self.length_ratio = conf.getfloat("max_length_ratio", 1.0)
        self.length_norm_power = conf.getfloat("length_norm_power", 0.0)

    def steps(self, encoded) -> int:
        return self.max_steps or max(int(encoded.shape[1] * self.length_ratio), 8)

    def nbest_of(self, seqs, lengths, scores) -> Nbest:
        n = self.nbest
        return Nbest(ids=seqs[:, :n].cpu().numpy(), lengths=lengths[:, :n].cpu().numpy(),
                     scores=scores[:, :n].cpu().numpy())

    @torch.no_grad()
    def __call__(self, params, features, feature_lengths) -> Nbest:
        encoded, enc_lengths, head_params = self._encode(params, features, feature_lengths)
        return self.nbest_of(*self.search(head_params, encoded, enc_lengths))


@RECOGNIZERS.register("attention_beam")
@RECOGNIZERS.register("beam")
class AttentionBeamRecognizer(_AttentionBeam):
    """Batched attention beam search (``decoding.beam``): the encoder once,
    then the beam of each utterance over its shared encoding. conf:
    beam_width, nbest, max_steps / max_length_ratio, length_norm_power,
    eos_bonus."""

    def __init__(self, conf, model, head=None):
        super().__init__(conf, model, head)
        self.eos_bonus = conf.getfloat("eos_bonus", 0.0)

    @torch.no_grad()
    def search(self, head_params, encoded, enc_lengths):
        """The beam search over an encoder output: (seqs, lengths, scores)
        tensors on its device, best first."""
        return attention_beam_search(
            self.decoder, head_params, encoded, enc_lengths, beam_width=self.beam_width,
            max_steps=self.steps(encoded), length_norm_power=self.length_norm_power,
            eos_bonus=self.eos_bonus, lm=self.lm_on(encoded.device), lm_weight=self.lm_weight)


@RECOGNIZERS.register("joint_ctc_att_beam")
@RECOGNIZERS.register("joint_beam")
class JointCTCAttBeamRecognizer(_AttentionBeam):
    """One-pass hybrid CTC/attention beam search over a multi-head model
    (``decoding.joint``). conf: att_head, ctc_head, ctc_weight (0.3),
    beam_width, nbest, pre_beam, max_steps / max_length_ratio,
    length_norm_power. ``_encode``'s head parameters hold both heads'."""

    def __init__(self, conf, model, head=None):
        super().__init__(conf, model, _attention_head(conf, model, head, "joint decoding"))
        self.ctc_head = _ctc_head(conf, model, "joint decoding")
        self.ctc_decoder = model.decoders[self.ctc_head]
        self.ctc_weight = conf.getfloat("ctc_weight", 0.3)
        self.pre_beam = conf.getint("pre_beam", 0)

    def _encode(self, params, features, feature_lengths):
        encoded, enc_lengths, att = super()._encode(params, features, feature_lengths)
        return encoded, enc_lengths, {
            self.head: att, self.ctc_head: self.model._cast_in(params["decoders"][self.ctc_head])}

    @torch.no_grad()
    def search(self, head_params, encoded, enc_lengths):
        ctc_logits, _ = self.ctc_decoder.apply(head_params[self.ctc_head], encoded, enc_lengths)
        ctc_lp = torch.log_softmax(ctc_logits.to(score_dtype(ctc_logits.dtype)), dim=-1)
        return joint_ctc_att_beam_search(
            self.decoder, head_params[self.head], encoded, enc_lengths, ctc_lp,
            beam_width=self.beam_width, max_steps=self.steps(encoded),
            ctc_weight=self.ctc_weight, pre_beam=self.pre_beam,
            length_norm_power=self.length_norm_power,
            blank_id=getattr(self.ctc_decoder, "blank_id", ctc_lp.shape[-1] - 1),
            lm=self.lm_on(encoded.device), lm_weight=self.lm_weight)


@RECOGNIZERS.register("attention_rescoring")
@RECOGNIZERS.register("ctc_att_rescoring")
class AttentionRescoringRecognizer(Recognizer):
    """Two-pass decoding over a multi-head model: the CTC prefix beam's
    n-best, then every hypothesis scored by the attention head
    teacher-forced in one batched call over [B*W] hypotheses (the encoding
    repeated W-fold, as in the JAX package) and re-ranked by ctc_weight *
    ctc + (1 - ctc_weight) * attention. conf: beam_width (8), nbest,
    ctc_weight (0.5), att_head, ctc_head, max_label_len."""

    frame_synchronous = False

    def __init__(self, conf, model, head=None):
        super().__init__(conf, model, _attention_head(conf, model, head, "attention rescoring"))
        self.ctc_head = _ctc_head(conf, model, "attention rescoring")
        ctc = model.decoders[self.ctc_head]
        self.ctc_decoder = ctc
        self.blank_id = getattr(ctc, "blank_id", ctc.output_dim - 1)
        self.ctc_weight = conf.getfloat("ctc_weight", 0.5)
        self.beam_width = conf.getint("beam_width", 8)
        self.nbest = min(conf.getint("nbest", 1), self.beam_width)
        self.max_label_len = conf.getint("max_label_len", 0)

    @torch.no_grad()
    def __call__(self, params, features, feature_lengths) -> Nbest:
        encoded, enc_lengths, dparams = self._encode(params, features, feature_lengths)
        ctc_logits, logit_lengths = self.ctc_decoder.apply(
            self.model._cast_in(params["decoders"][self.ctc_head]), encoded, enc_lengths)
        seqs, lengths, ctc_scores = ctc_prefix_beam_search(
            torch.log_softmax(ctc_logits.float(), dim=-1), logit_lengths,
            beam_width=self.beam_width, blank_id=self.blank_id,
            max_label_len=self.max_label_len or None)  # [B, W, L], [B, W], [B, W]

        # pass 2: the teacher-forced attention score of every hypothesis;
        # step t predicts hyp[t], step len(hyp) predicts eos
        B, W, L = seqs.shape
        dec = self.decoder
        hyp = seqs.reshape(B * W, L)
        hyp_len = lengths.reshape(B * W)
        logits, _ = dec.apply(dparams, torch.repeat_interleave(encoded, W, dim=0),
                              torch.repeat_interleave(enc_lengths, W, dim=0), hyp, hyp_len)
        lp = torch.log_softmax(logits.float(), dim=-1)  # [B*W, L+1, V]
        pos = torch.arange(L + 1, device=lp.device)[None, :]
        tgt = torch.nn.functional.pad(hyp.to(torch.int64), (0, 1))
        tgt = torch.where(pos == hyp_len[:, None], dec.eos_id, tgt)
        tok_lp = torch.gather(lp, 2, tgt[..., None])[..., 0]
        att_scores = torch.where(pos <= hyp_len[:, None], tok_lp, 0.0).sum(dim=1).reshape(B, W)

        combined = self.ctc_weight * ctc_scores + (1.0 - self.ctc_weight) * att_scores
        combined = torch.where(ctc_scores < NEG_INF / 2, NEG_INF, combined)  # dead slots
        order = torch.argsort(-combined, dim=1, stable=True)[:, : self.nbest]
        return Nbest(ids=gather_beams(seqs, order).cpu().numpy(),
                     lengths=torch.gather(lengths, 1, order).cpu().numpy(),
                     scores=torch.gather(combined, 1, order).cpu().numpy())


class _TransducerRecognizer(Recognizer):
    """Base of the transducer searches: the head must be a transducer head;
    the encoder runs once, then the search over its output."""

    def __init__(self, conf, model, head=None):
        super().__init__(conf, model, head)
        if not hasattr(self.decoder, "joint_step"):
            raise ValueError(f"head {self.head!r} is not a transducer head")
        self.max_symbols = conf.getint("max_symbols", 4)
        self.max_label_len = conf.getint("max_label_len", 0)


@RECOGNIZERS.register("transducer_greedy")
@RECOGNIZERS.register("rnnt_greedy")
class TransducerGreedyRecognizer(_TransducerRecognizer):
    """Batched RNN-T greedy search over a transducer head
    (``decoding.transducer``). conf: max_symbols (per-frame emission
    budget, default 4), max_label_len (output cap)."""

    @torch.no_grad()
    def __call__(self, params, features, feature_lengths) -> Nbest:
        encoded, enc_lengths, head_params = self._encode(params, features, feature_lengths)
        ids, lengths, scores = transducer_greedy_search(
            self.decoder, head_params, encoded, enc_lengths, max_symbols=self.max_symbols)
        ids, lengths = ids.cpu().numpy(), lengths.cpu().numpy()
        if self.max_label_len and ids.shape[1] > self.max_label_len:
            ids = ids[:, : self.max_label_len]
            lengths = np.minimum(lengths, self.max_label_len)
        return Nbest(ids=ids[:, None, :], lengths=lengths[:, None],
                     scores=scores.cpu().numpy()[:, None])


def _distinct_first_order(seqs: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Per-row beam reordering that moves duplicate label sequences behind
    the distinct ones (stable within each group): an alignment-path beam
    can hold one label sequence in several slots through other blank
    placements. Returns order [B, W] of slot indices."""
    B, W = lengths.shape
    order = np.empty((B, W), np.int64)
    for b in range(B):
        seen, distinct, dups = set(), [], []
        for w in range(W):
            key = tuple(seqs[b, w, : lengths[b, w]])
            (dups if key in seen else distinct).append(w)
            seen.add(key)
        order[b] = distinct + dups
    return order


@RECOGNIZERS.register("transducer_beam")
@RECOGNIZERS.register("rnnt_beam")
class TransducerBeamRecognizer(_TransducerRecognizer):
    """Batched time-synchronous RNN-T beam search (``decoding.transducer``).
    conf: beam_width, nbest, max_symbols, length_norm_power,
    max_label_len, lm_path / lm_weight."""

    supports_lm_fusion = True

    def __init__(self, conf, model, head=None):
        super().__init__(conf, model, head)
        self.beam_width = conf.getint("beam_width", 4)
        self.nbest = min(conf.getint("nbest", 1), self.beam_width)
        self.length_norm_power = conf.getfloat("length_norm_power", 0.0)

    def search(self, head_params, encoded, enc_lengths):
        """The beam search over an encoder output: (seqs, lengths,
        scores) tensors on its device."""
        return transducer_beam_search(
            self.decoder, head_params, encoded, enc_lengths, beam_width=self.beam_width,
            max_symbols=self.max_symbols, length_norm_power=self.length_norm_power,
            lm=self.lm_on(encoded.device), lm_weight=self.lm_weight)

    def nbest_of(self, seqs, lengths, scores) -> Nbest:
        seqs, lengths, scores = (x.cpu().numpy() for x in (seqs, lengths, scores))
        take = _distinct_first_order(seqs, lengths)[:, : self.nbest]
        seqs = np.take_along_axis(seqs, take[..., None], axis=1)
        lengths = np.take_along_axis(lengths, take, axis=1)
        scores = np.take_along_axis(scores, take, axis=1)
        if self.max_label_len and seqs.shape[2] > self.max_label_len:
            seqs = seqs[:, :, : self.max_label_len]
            lengths = np.minimum(lengths, self.max_label_len)
        return Nbest(ids=seqs, lengths=lengths, scores=scores)

    @torch.no_grad()
    def __call__(self, params, features, feature_lengths) -> Nbest:
        encoded, enc_lengths, head_params = self._encode(params, features, feature_lengths)
        return self.nbest_of(*self.search(head_params, encoded, enc_lengths))


@RECOGNIZERS.register("transducer_streaming")
@RECOGNIZERS.register("rnnt_streaming")
class TransducerStreamingRecognizer(Recognizer):
    """Chunked streaming RNN-T greedy decode (``decoding.streaming``) as a
    batch recognizer: the padded batch is fed ``chunk_frames`` at a time.
    Its output equals ``transducer_greedy``'s (the forward-only encoder has
    no lookahead). conf: chunk_frames, max_symbols."""

    def __init__(self, conf, model, head=None):
        super().__init__(conf, model, head)
        self.streamer = StreamingTransducer(
            model, head=self.head, chunk_frames=conf.getint("chunk_frames", 32),
            max_symbols=conf.getint("max_symbols", 4))

    def __call__(self, params, features, feature_lengths) -> Nbest:
        toks, state = self.streamer.stream(params, features, feature_lengths)
        B = len(toks)
        L = max(max((len(t) for t in toks), default=1), 1)
        ids = np.zeros((B, 1, L), np.int64)
        lens = np.zeros((B, 1), np.int64)
        for b, t in enumerate(toks):
            ids[b, 0, : len(t)] = t
            lens[b, 0] = len(t)
        return Nbest(ids=ids, lengths=lens, scores=state["dec"][2].cpu().numpy()[:, None])


def build_recognizer(conf: Conf, model) -> Recognizer:
    """Factory by conf['recognizer']."""
    name = conf.get("recognizer", "ctc_greedy")
    if name.lower() not in RECOGNIZERS.names():
        raise NotImplementedError(f"recognizer {name!r} not ported yet")
    return RECOGNIZERS.build(name, conf, model)
