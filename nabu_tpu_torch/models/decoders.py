"""Model-side decoders: the linear CTC head, the attention Speller and the
transformer decoder.

Port of ``LinearCTC``, ``Speller`` and ``TransformerDecoder`` of the JAX
package's ``models/decoders.py``. ``LinearCTC``: a per-frame projection of
the encoder output to ``num_labels + 1`` logits with blank = ``num_labels``
(last index). ``Speller`` (the LAS attention decoder) and
``TransformerDecoder``: one extra id ``num_labels`` is both <sos> (input
side) and <eos> (output side); both have the ``init_state`` / ``step`` /
``precompute`` contract of the beam searches. The transducer head is in
``models.transducer`` (registered as ``rnnt`` / ``transducer`` when the
package is imported).
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


@DECODERS.register("transformer")
class TransformerDecoder(Decoder):
    """Transformer attention decoder: embeddings scaled by sqrt(d) plus
    sinusoidal positions, ``num_layers`` pre-LN blocks (causal
    self-attention, cross-attention over the encoder output, a GELU FFN),
    an output layer norm and projection. Training is one teacher-forced
    parallel pass over [<sos>; targets].

    Decoding has the Speller's contract: ``precompute`` projects each
    block's cross-attention K / V once; the state holds per-block
    self-attention caches ``k_{i}`` / ``v_{i}`` [B, H, cap, hd] (cap = the
    encoder's frames, ``init_state(..., enc_frames=T)``) and the position
    ``pos`` [B] (every hypothesis advances in lockstep). ``step`` writes
    this token's K / V into slot ``pos`` (the last slot past the cap, as
    JAX's clamped update) out of place, so no earlier state is changed, and
    reads ``pos`` on the device only (no host sync). Its cross-attention
    takes B = W x Be queries over Be encodings (a beam over one untiled
    encoding an utterance, hypothesis w of utterance b at row b W + w).

    Config: ``num_layers`` (4), ``num_units`` (256), ``num_heads`` (4),
    ``ffn_dim`` (4 x num_units), ``dropout`` (after each block in
    training). The attention scores and softmax are f32
    (``core.attention``)."""

    def __init__(self, conf: Conf, encoder_dim: int, num_labels: int):
        super().__init__(conf, encoder_dim, num_labels)
        self.num_layers = conf.getint("num_layers", 4)
        self.d = conf.getint("num_units", 256)
        self.num_heads = conf.getint("num_heads", 4)
        if self.d % self.num_heads:
            raise ValueError(f"num_units {self.d} not divisible by num_heads {self.num_heads}")
        self.ffn_dim = conf.getint("ffn_dim", 4 * self.d)
        self.dropout = conf.getfloat("dropout", 0.0)
        self.sos_id = self.num_labels
        self.eos_id = self.num_labels

    def init(self, generator) -> dict:
        d, f = self.d, self.ffn_dim
        dev = generator.device
        params: Dict[str, dict] = {"embed": core.embedding_init(generator, self.output_dim, d)}
        for i in range(self.num_layers):
            params[f"block_{i}"] = {
                "ln1_g": torch.ones((d,), device=dev), "ln1_b": torch.zeros((d,), device=dev),
                "wqkv": core.glorot(generator, (d, 3 * d)),
                "wo": core.linear_init(generator, d, d),
                "ln2_g": torch.ones((d,), device=dev), "ln2_b": torch.zeros((d,), device=dev),
                "wq_x": core.glorot(generator, (d, d)),
                "wkv_enc": core.glorot(generator, (self.encoder_dim, 2 * d)),
                "wo_x": core.linear_init(generator, d, d),
                "ln3_g": torch.ones((d,), device=dev), "ln3_b": torch.zeros((d,), device=dev),
                "ffn1": core.linear_init(generator, d, f),
                "ffn2": core.linear_init(generator, f, d),
            }
        params["ln_out_g"] = torch.ones((d,), device=dev)
        params["ln_out_b"] = torch.zeros((d,), device=dev)
        params["out"] = core.linear_init(generator, d, self.output_dim)
        return params

    # -- pieces ------------------------------------------------------------
    def _heads(self, x, B, n):
        """[B, n, d] -> [B, H, n, hd]."""
        return x.reshape(B, n, self.num_heads, self.d // self.num_heads).transpose(1, 2)

    def _merge(self, x, B, n):
        return x.transpose(1, 2).reshape(B, n, self.d)

    def _cross_kv(self, p, encoded):
        """A block's cross-attention K / V of the encoder output."""
        B, T, _ = encoded.shape
        k, v = (encoded @ p["wkv_enc"]).chunk(2, dim=-1)
        return self._heads(k, B, T), self._heads(v, B, T)

    def precompute(self, params, encoded):
        return {f"block_{i}": self._cross_kv(params[f"block_{i}"], encoded)
                for i in range(self.num_layers)}

    def _embed(self, params, ids, pe, dtype):
        x = core.embedding_apply(params["embed"], ids)
        x = x * torch.sqrt(torch.tensor(float(self.d), dtype=x.dtype))
        return (x + pe.to(x.dtype)).to(dtype)

    def _block(self, p, x, self_bias, cross_kv, cross_bias, cache=None):
        """One block on x [B, n, d] -> (x, its self-attention K / V).
        ``cache`` = (k_cache, v_cache, slot): the step path's K / V are the
        caches with this token's written at ``slot`` (out of place)."""
        B, n, _ = x.shape
        y = core.layer_norm(x, p["ln1_g"], p["ln1_b"])
        q, k, v = (self._heads(t, B, n) for t in (y @ p["wqkv"]).chunk(3, dim=-1))
        if cache is not None:
            k_cache, v_cache, slot = cache
            k = k_cache.index_copy(2, slot, k)
            v = v_cache.index_copy(2, slot, v)
        x = x + core.linear_apply(p["wo"], self._merge(core.attention(q, k, v, self_bias), B, n))
        y = core.layer_norm(x, p["ln2_g"], p["ln2_b"])
        q = self._heads(y @ p["wq_x"], B, n)
        ck, cv = cross_kv
        Be = ck.shape[0]
        if Be != B:
            # a beam over shared encodings: only the step path (n = 1)
            # lands here; the W hypotheses of an utterance become its
            # query positions
            if B % Be or n != 1:
                raise ValueError(f"{B} queries of {n} positions over {Be} encodings")
            W, H = B // Be, self.num_heads
            q = q.reshape(Be, W, H, -1).transpose(1, 2)  # [Be, H, W, hd]
            att = core.attention(q, ck, cv, cross_bias)
            att = att.transpose(1, 2).reshape(B, H, 1, -1)
        else:
            att = core.attention(q, ck, cv, cross_bias)
        x = x + core.linear_apply(p["wo_x"], self._merge(att, B, n))
        y = core.layer_norm(x, p["ln3_g"], p["ln3_b"])
        y = core.gelu(y @ p["ffn1"]["w"] + p["ffn1"]["b"])
        return x + core.linear_apply(p["ffn2"], y), (k, v)

    # -- state / step (beam-search contract) --------------------------------
    def init_state(self, batch: int, dtype=torch.float32, enc_frames: int = None,
                   device=None) -> dict:
        if enc_frames is None:
            raise ValueError("the transformer decoder sizes its KV cache from the encoder: "
                             "pass init_state(..., enc_frames=T)")
        shape = (batch, self.num_heads, enc_frames, self.d // self.num_heads)
        state = {"pos": torch.zeros((batch,), dtype=torch.int32, device=device)}
        for i in range(self.num_layers):
            state[f"k_{i}"] = torch.zeros(shape, dtype=dtype, device=device)
            state[f"v_{i}"] = torch.zeros(shape, dtype=dtype, device=device)
        return state

    @staticmethod
    def cache_slot(pos: torch.Tensor, cap: int) -> torch.Tensor:
        """The cache slot [1] (int64) of position ``pos`` [1]: ``pos``, the
        last slot past the cap (JAX's clamped ``dynamic_update_slice``)."""
        return torch.clamp(pos, max=cap - 1).to(torch.int64)

    def step(self, params, prev_ids, state, encoded, enc_mask, keys=None):
        """(logits [B, V+1], new state) of one step from the previous ids
        [B]; ``keys`` is ``precompute``'s output."""
        if keys is None:
            keys = self.precompute(params, encoded)
        cap = state["k_0"].shape[2]
        pos = state["pos"][:1]  # every hypothesis at the same position
        pe = core.sinusoidal_rows(pos.to(torch.float32), self.d)  # [1, d]
        x = self._embed(params, prev_ids, pe, encoded.dtype)[:, None, :]
        # self-attention over cache slots [0, pos]
        slots = torch.arange(cap, device=pos.device)
        self_bias = torch.where(slots <= pos, 0.0, -1e9).to(torch.float32)[None, None, None, :]
        cross_bias = torch.where(enc_mask, 0.0, -1e9).to(torch.float32)[:, None, None, :]
        slot = self.cache_slot(pos, cap)
        new_state = {"pos": state["pos"] + 1}
        for i in range(self.num_layers):
            x, (new_state[f"k_{i}"], new_state[f"v_{i}"]) = self._block(
                params[f"block_{i}"], x, self_bias, keys[f"block_{i}"], cross_bias,
                cache=(state[f"k_{i}"], state[f"v_{i}"], slot))
        x = core.layer_norm(x, params["ln_out_g"], params["ln_out_b"])
        return core.linear_apply(params["out"], x)[:, 0, :], new_state

    # -- teacher-forced training pass ---------------------------------------
    def apply(self, params, encoded, enc_lengths, targets=None, target_lengths=None,
              train=False, generator=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """(logits [B, L+1, V+1], target_lengths + 1): position t attends
        causally over [<sos>; targets] up to t and predicts target t
        (position L predicts <eos>)."""
        B, L = targets.shape
        T = encoded.shape[1]
        n = L + 1
        dev = encoded.device
        targets = targets.to(device=dev, dtype=torch.int64)
        inputs = torch.cat([torch.full((B, 1), self.sos_id, dtype=torch.int64, device=dev),
                            targets], dim=1)
        pe = core.sinusoidal_rows(torch.arange(n, dtype=torch.float32, device=dev), self.d)
        x = self._embed(params, inputs, pe[None], encoded.dtype)
        causal = torch.ones((n, n), dtype=torch.bool, device=dev).tril()
        self_bias = torch.where(causal, 0.0, -1e9).to(torch.float32)[None, None]
        enc_mask = sequence_mask(enc_lengths.to(dev), T)
        cross_bias = torch.where(enc_mask, 0.0, -1e9).to(torch.float32)[:, None, None, :]
        for i in range(self.num_layers):
            p = params[f"block_{i}"]
            x, _ = self._block(p, x, self_bias, self._cross_kv(p, encoded), cross_bias)
            x = core.dropout(x, self.dropout, train, generator)
        x = core.layer_norm(x, params["ln_out_g"], params["ln_out_b"])
        return core.linear_apply(params["out"], x), target_lengths + 1


def build_decoder(conf: Conf, encoder_dim: int, num_labels: int) -> Decoder:
    name = conf.get("decoder", "linear_ctc")
    if name.lower() not in DECODERS.names():
        raise NotImplementedError(f"decoder {name!r} not ported yet")
    return DECODERS.build(name, conf, encoder_dim, num_labels)
