"""Model-side decoders: the linear CTC head and the attention Speller.

Port of ``LinearCTC`` and ``Speller`` of the JAX package's
``models/decoders.py``. ``LinearCTC``: a per-frame projection of the
encoder output to ``num_labels + 1`` logits with blank = ``num_labels``
(last index). ``Speller``: the LAS attention decoder, whose one extra id
``num_labels`` is both <sos> (input side) and <eos> (output side). The
transducer head is in ``models.transducer`` (registered as ``rnnt`` /
``transducer`` when the package is imported); the transformer head is not
ported yet.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from nabu_tpu_torch.config import Conf
from nabu_tpu_torch.models import core
from nabu_tpu_torch.ops.masking import mask_logits, sequence_mask
from nabu_tpu_torch.registry import DECODERS


class Decoder:
    """Base decoder built from a config section. ``default_loss`` is the
    loss the head trains with when its section has no ``loss`` key."""

    default_loss = "cross_entropy"

    def __init__(self, conf: Conf, encoder_dim: int, num_labels: int):
        self.conf = conf
        self.encoder_dim = encoder_dim
        self.num_labels = num_labels
        self.output_dim = num_labels + 1


@DECODERS.register("linear_ctc")
@DECODERS.register("ctc")
class LinearCTC(Decoder):
    """Per-frame projection to label+blank logits; blank = num_labels.
    ``num_units`` adds a ReLU hidden layer."""

    default_loss = "ctc"

    def __init__(self, conf: Conf, encoder_dim: int, num_labels: int):
        super().__init__(conf, encoder_dim, num_labels)
        self.hidden = conf.getint("num_units", 0)
        self.blank_id = self.num_labels

    def init(self, generator) -> dict:
        if self.hidden:
            return {
                "hidden": core.linear_init(generator, self.encoder_dim, self.hidden),
                "out": core.linear_init(generator, self.hidden, self.output_dim),
            }
        return {"out": core.linear_init(generator, self.encoder_dim, self.output_dim)}

    def apply(self, params, encoded, enc_lengths, targets=None, target_lengths=None,
              train=False, generator=None):
        x = encoded
        if self.hidden:
            x = torch.relu(core.linear_apply(params["hidden"], x))
        return core.linear_apply(params["out"], x), enc_lengths


@DECODERS.register("speller")
class Speller(Decoder):
    """LAS attention decoder. Per step: x_t = [embed(prev_label);
    context_{t-1}] -> LSTM stack -> attention over the encoder output ->
    logits = W_o [h_top; context_t]. Training is teacher-forced with
    scheduled sampling: with probability ``sample_prob`` a step is fed the
    model's own previous argmax instead of the ground truth.

    ``attention``: ``bahdanau`` (additive, default), ``dot`` (scaled dot
    product) or ``location`` (the additive score also sees the previous
    step's weights through a 1-D conv of ``location_filters`` channels of
    width ``location_width``; the decode state then carries ``attn_prev``
    [B, T], so ``init_state`` needs ``enc_frames``). Parameters as the JAX
    tree: ``embed``, ``lstm_{i}``, ``attn_enc``, ``attn_state``,
    ``attn_v {v [A, 1]}``, ``attn_loc {conv [W, 1, F], proj}``, ``out``.
    The step is eager PyTorch (the JAX package has no kernel here); its
    attention takes one query a row of the encoder batch, or (a beam
    search's) W queries a row over the same encoding (``_attend``)."""

    def __init__(self, conf: Conf, encoder_dim: int, num_labels: int):
        super().__init__(conf, encoder_dim, num_labels)
        self.num_layers = conf.getint("num_layers", 1)
        self.num_units = conf.getint("num_units", 256)
        self.embed_dim = conf.getint("embed_dim", self.num_units)
        self.attn_dim = conf.getint("attention_units", self.num_units)
        self.attention = conf.get("attention", "bahdanau")
        if self.attention not in ("bahdanau", "dot", "location"):
            raise ValueError(f"unknown attention {self.attention!r} (bahdanau|dot|location)")
        self.loc_filters = conf.getint("location_filters", 10)
        self.loc_width = conf.getint("location_width", 11)
        self.sample_prob = conf.getfloat("sample_prob", 0.0)
        self.sos_id = self.num_labels
        self.eos_id = self.num_labels

    # -- params ----------------------------------------------------------
    def init(self, generator) -> dict:
        params: Dict[str, dict] = {
            "embed": core.embedding_init(generator, self.output_dim, self.embed_dim)}
        in_dim = self.embed_dim + self.encoder_dim
        for i in range(self.num_layers):
            params[f"lstm_{i}"] = core.lstm_init(generator, in_dim, self.num_units)
            in_dim = self.num_units
        params["attn_enc"] = core.linear_init(generator, self.encoder_dim, self.attn_dim)
        params["attn_state"] = core.linear_init(generator, self.num_units, self.attn_dim)
        params["attn_v"] = {"v": core.glorot(generator, (self.attn_dim, 1))}
        if self.attention == "location":
            params["attn_loc"] = {
                "conv": core.glorot(generator, (self.loc_width, 1, self.loc_filters)),
                "proj": core.linear_init(generator, self.loc_filters, self.attn_dim),
            }
        params["out"] = core.linear_init(generator, self.num_units + self.encoder_dim,
                                         self.output_dim)
        return params

    # -- state -----------------------------------------------------------
    def init_state(self, batch: int, dtype=torch.float32, enc_frames: int = None,
                   device=None) -> dict:
        def zeros(*shape):
            return torch.zeros(shape, dtype=dtype, device=device)

        state = {
            "lstm": [(zeros(batch, self.num_units), zeros(batch, self.num_units))
                     for _ in range(self.num_layers)],
            "context": zeros(batch, self.encoder_dim),
        }
        if self.attention == "location":
            if enc_frames is None:
                raise ValueError(
                    "location attention carries the previous attention weights in the "
                    "decode state: pass init_state(..., enc_frames=T)")
            state["attn_prev"] = zeros(batch, enc_frames)
        return state

    # -- attention -------------------------------------------------------
    def _attend(self, params, h_top, keys, encoded, enc_mask, prev_weights=None):
        """keys = the precomputed W_enc @ encoded [Be, T, A].

        Beam sharing: the query batch Bq may be W = Bq / Be times the
        encoder batch Be (a [B, W] beam flattened to B*W hypotheses over
        one encoding an utterance), hypothesis w of utterance b at row
        b * W + w. encoded, keys and enc_mask stay [Be, ...], never tiled
        W-fold; the scores and the context carry the beam on an axis of
        their own. W = 1 is one query a row of the encoder batch."""
        Bq, Be = h_top.shape[0], encoded.shape[0]
        if Bq % Be:
            raise ValueError(f"{Bq} queries are not a multiple of {Be} encodings")
        W = Bq // Be
        q = core.linear_apply(params["attn_state"], h_top).reshape(Be, W, -1)  # [Be, W, A]
        if self.attention == "dot":
            scale = torch.sqrt(torch.tensor(float(self.attn_dim), dtype=h_top.dtype))
            scores = torch.einsum("bta,bwa->bwt", keys, q) / scale.to(h_top.device)
        else:
            e = keys[:, None] + q[:, :, None, :]  # [Be, W, T, A]
            if self.attention == "location":
                # XLA's SAME cross-correlation over each hypothesis'
                # previous weights: pad (K - 1) // 2 before and K // 2 after
                K = params["attn_loc"]["conv"].shape[0]
                f = torch.nn.functional.conv1d(
                    torch.nn.functional.pad(prev_weights[:, None, :].to(e.dtype),
                                            ((K - 1) // 2, K // 2)),
                    params["attn_loc"]["conv"].to(e.dtype).permute(2, 1, 0),
                ).transpose(1, 2)  # [Bq, T, F]
                loc = core.linear_apply(params["attn_loc"]["proj"], f)  # [Bq, T, A]
                e = e + loc.reshape(Be, W, *loc.shape[1:])
            scores = (torch.tanh(e) @ params["attn_v"]["v"])[..., 0]  # [Be, W, T]
        weights = torch.softmax(mask_logits(scores, enc_mask[:, None, :]), dim=-1)
        context = torch.einsum("bwt,btd->bwd", weights, encoded)
        return context.reshape(Bq, -1), weights.reshape(Bq, -1)

    def precompute(self, params, encoded):
        """Step-invariant attention keys (W_enc @ encoded), computed once
        before a decode loop and passed to every step()."""
        return core.linear_apply(params["attn_enc"], encoded)

    # -- one autoregressive step ------------------------------------------
    def step(self, params, prev_ids, state, encoded, enc_mask, keys=None):
        """(logits [B, V+1], new state) of one step from the previous ids
        [B]."""
        if keys is None:
            keys = self.precompute(params, encoded)
        emb = core.embedding_apply(params["embed"], prev_ids)
        x = torch.cat([emb, state["context"]], dim=-1)
        new_lstm = []
        for i in range(self.num_layers):
            h, c = state["lstm"][i]
            p = params[f"lstm_{i}"]
            h, c = core.lstm_cell(x @ p["wx"] + p["b"], h, c, p["wh"])
            new_lstm.append((h, c))
            x = h
        context, weights = self._attend(params, x, keys, encoded, enc_mask,
                                        prev_weights=state.get("attn_prev"))
        logits = core.linear_apply(params["out"], torch.cat([x, context], dim=-1))
        new_state = {"lstm": new_lstm, "context": context, "attn_weights": weights}
        if self.attention == "location":
            new_state["attn_prev"] = weights
        return logits, new_state

    # -- teacher-forced training pass --------------------------------------
    def apply(self, params, encoded, enc_lengths, targets=None, target_lengths=None,
              train=False, generator=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """(logits [B, L+1, V+1], logit lengths = target_lengths + 1). Step t
        consumes target t - 1 (or, under scheduled sampling, the previous
        step's argmax) and predicts target t; step L predicts <eos>. The
        sampling draws are one [L + 1, B] uniform draw from ``generator``."""
        B, L = targets.shape
        T = encoded.shape[1]
        dev = encoded.device
        targets = targets.to(device=dev, dtype=torch.int64)
        enc_mask = sequence_mask(enc_lengths.to(dev), T)
        keys = self.precompute(params, encoded)
        sos = torch.full((B, 1), self.sos_id, dtype=torch.int64, device=dev)
        inputs = torch.cat([sos, targets], dim=1)  # [B, L+1]
        state = self.init_state(B, encoded.dtype, enc_frames=T, device=dev)
        sample_prob = self.sample_prob if train else 0.0
        sampled = None
        if sample_prob > 0.0:
            if generator is None:
                generator = torch.Generator(device=dev).manual_seed(0)
            sampled = torch.rand((L + 1, B), generator=generator, device=dev) < sample_prob
        prev_pred = inputs[:, 0]
        logits = []
        for t in range(L + 1):
            prev_ids = inputs[:, t]
            if sampled is not None:
                prev_ids = torch.where(sampled[t], prev_pred, prev_ids)
            step_logits, state = self.step(params, prev_ids, state, encoded, enc_mask, keys)
            state.pop("attn_weights")
            prev_pred = torch.argmax(step_logits.detach(), dim=-1)
            logits.append(step_logits)
        return torch.stack(logits, dim=1), target_lengths + 1


def build_decoder(conf: Conf, encoder_dim: int, num_labels: int) -> Decoder:
    name = conf.get("decoder", "linear_ctc")
    if name.lower() not in DECODERS.names():
        raise NotImplementedError(f"decoder {name!r} not ported yet")
    return DECODERS.build(name, conf, encoder_dim, num_labels)
