"""Encoders: DBLSTM, the pyramidal Listener, DNN, transformer, conformer.

Port of the JAX package's ``models/encoders.py``. Each encoder maps
``(features [B, T, F], lengths) -> (encoded [B, T', D], lengths')`` and is
selected by the ``[encoder]`` config section. The recurrent encoders run
the CUDA LSTM kernels on the card; the attention encoders (transformer,
conformer and its expert-choice MoE option) and DNN are plain PyTorch
ops, as the JAX package computes them outside any Pallas kernel.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from nabu_tpu_torch.config import Conf
from nabu_tpu_torch.models import core
from nabu_tpu_torch.ops import lstm as lstm_ops
from nabu_tpu_torch.registry import ENCODERS


class Encoder:
    """Base encoder: hyperparams from an [encoder] config section."""

    def __init__(self, conf: Conf, input_dim: int):
        self.conf = conf
        self.input_dim = input_dim
        self.output_dim: int = 0  # set by subclasses

    def init(self, generator) -> dict:
        raise NotImplementedError

    def apply(self, params, features, lengths, train=False, generator=None):
        raise NotImplementedError


@ENCODERS.register("dblstm")
class DBLSTM(Encoder):
    """Deep bidirectional LSTM, no subsampling (the CTC workhorse).

    ``use_pallas = true`` (the recipe's key) selects the CUDA BLSTM
    kernels, time-major end to end. ``bidirectional = false`` builds a
    forward-only stack, the streaming-capable variant: it also has
    ``stream_init`` / ``stream_step``, which encode a chunk at a time with
    the LSTM carries threaded through, equal to one offline pass. On a
    CUDA device the stack always runs the kernels, time-major: the BLSTM
    kernels, or for a forward-only stack the LSTM kernels of
    ``ops.lstm`` (f32 carries, as ``lstm_scan_pallas``). The plain scan
    mirrors the JAX package's path (``core.lstm_scan`` for a forward-only
    stack, as JAX always runs it) for CPU tensors only. With ``train`` and
    ``dropout`` > 0, dropout follows every layer, the last one included."""

    def __init__(self, conf: Conf, input_dim: int):
        super().__init__(conf, input_dim)
        self.num_layers = conf.getint("num_layers", 2)
        self.num_units = conf.getint("num_units", 128)
        self.dropout = conf.getfloat("dropout", 0.0)
        self.bidirectional = conf.getbool("bidirectional", True)
        self.impl = (
            "kernel"
            if conf.getbool("use_pallas", False) and self.bidirectional
            else "scan"
        )
        self.layer_norm = conf.getbool("layer_norm", False)
        self.output_dim = (2 if self.bidirectional else 1) * self.num_units

    def init(self, generator) -> dict:
        if self.layer_norm:
            raise NotImplementedError("layer-norm LSTM init is not ported yet")
        params = {}
        in_dim = self.input_dim
        for i in range(self.num_layers):
            init = core.blstm_init if self.bidirectional else core.lstm_init
            params[f"layer_{i}"] = init(generator, in_dim, self.num_units)
            in_dim = self.output_dim
        return params

    def apply(self, params, features, lengths, train=False, generator=None):
        def drop(x):
            return core.dropout(x, self.dropout, train, generator)

        if features.is_cuda and not self.bidirectional:
            # time-major end to end through the LSTM kernels
            x = features.transpose(0, 1)
            for i in range(self.num_layers):
                x = drop(lstm_ops.lstm_tm_apply(params[f"layer_{i}"], x, lengths)[0])
            return x.transpose(0, 1), lengths
        impl = "kernel" if features.is_cuda else self.impl
        if impl == "kernel":
            # time-major end to end: one transpose in, one out
            x = features.transpose(0, 1)
            for i in range(self.num_layers):
                x = drop(core.blstm_apply_tm(params[f"layer_{i}"], x, lengths, impl))
            return x.transpose(0, 1), lengths
        x = features
        for i in range(self.num_layers):
            if self.bidirectional:
                x = core.blstm_apply(params[f"layer_{i}"], x, lengths)
            else:
                x = core.lstm_scan(params[f"layer_{i}"], x, lengths)
            x = drop(x)
        return x, lengths

    # -- streaming (forward-only stacks) ----------------------------------
    def stream_init(self, batch: int, dtype=torch.float32, device=None):
        """Per-layer (h, c) carries for a chunked encode: f32 on a CUDA
        device (the LSTM kernel's carries), else ``dtype`` (the scan's)."""
        if self.bidirectional:
            raise ValueError("streaming needs bidirectional = false")
        device = torch.device("cpu") if device is None else torch.device(device)
        if device.type == "cuda":
            dtype = torch.float32
        return [
            (torch.zeros((batch, self.num_units), dtype=dtype, device=device),
             torch.zeros((batch, self.num_units), dtype=dtype, device=device))
            for _ in range(self.num_layers)
        ]

    def stream_step(self, params, chunk, lengths, state):
        """Encode one chunk: ([B, C, F], valid lengths, carries) -> ([B, C,
        D], carries). Frames past ``lengths`` output zeros and leave the
        carries untouched."""
        if self.bidirectional:
            raise ValueError("streaming needs bidirectional = false")
        new_state = []
        if chunk.is_cuda:
            x = chunk.transpose(0, 1)
            for i in range(self.num_layers):
                x, carry = lstm_ops.lstm_tm_apply(params[f"layer_{i}"], x, lengths, state[i])
                new_state.append(carry)
            return x.transpose(0, 1), new_state
        x = chunk
        for i in range(self.num_layers):
            x, carry = core.lstm_scan(params[f"layer_{i}"], x, lengths,
                                      init_carry=state[i], return_carry=True)
            new_state.append(carry)
        return x, new_state


@ENCODERS.register("listener")
class Listener(Encoder):
    """Pyramidal BLSTM stack, the LAS "Listen" encoder: a bottom BLSTM,
    then ``num_layers`` BLSTM layers each after a pyramid stack that halves
    the time resolution (time / 2^num_layers), parameters ``bottom`` and
    ``pyramid_{i}``. On a CUDA device the stack runs the CUDA BLSTM
    kernels, time-major end to end, whatever ``use_pallas`` says; the
    scan mirrors the JAX package's ``use_pallas = false`` path for CPU
    tensors only. ``remat`` only trades memory for recomputation in JAX
    and is not read. With ``train`` and ``dropout`` > 0, dropout follows
    every layer, the last one included."""

    def __init__(self, conf: Conf, input_dim: int):
        super().__init__(conf, input_dim)
        self.num_layers = conf.getint("num_layers", 3)
        self.num_units = conf.getint("num_units", 256)
        self.dropout = conf.getfloat("dropout", 0.0)
        self.impl = "kernel" if conf.getbool("use_pallas", False) else "scan"
        self.layer_norm = conf.getbool("layer_norm", False)
        self.output_dim = 2 * self.num_units

    def init(self, generator) -> dict:
        if self.layer_norm:
            raise NotImplementedError("layer-norm LSTM init is not ported yet")
        params = {"bottom": core.blstm_init(generator, self.input_dim, self.num_units)}
        for i in range(self.num_layers):
            # pyramid-stacked pairs of the 2U outputs
            params[f"pyramid_{i}"] = core.blstm_init(generator, 4 * self.num_units,
                                                     self.num_units)
        return params

    def apply(self, params, features, lengths, train=False, generator=None):
        def drop(x):
            return core.dropout(x, self.dropout, train, generator)

        impl = "kernel" if features.is_cuda else self.impl
        if impl == "kernel":
            # time-major end to end: one transpose in, one out
            x = drop(core.blstm_apply_tm(params["bottom"], features.transpose(0, 1), lengths,
                                         impl))
            for i in range(self.num_layers):
                x, lengths = core.pyramid_stack_tm(x, lengths)
                x = drop(core.blstm_apply_tm(params[f"pyramid_{i}"], x, lengths, impl))
            return x.transpose(0, 1), lengths
        x = drop(core.blstm_apply(params["bottom"], features, lengths))
        for i in range(self.num_layers):
            x, lengths = core.pyramid_stack(x, lengths)
            x = drop(core.blstm_apply(params[f"pyramid_{i}"], x, lengths))
        return x, lengths


@ENCODERS.register("dnn")
class DNN(Encoder):
    """Per-frame feed-forward encoder: ``num_layers`` linear layers of
    ``num_units``, each followed by ``activation`` (a ``jax.nn`` name,
    ``core.activation``) and, in training, dropout."""

    def __init__(self, conf: Conf, input_dim: int):
        super().__init__(conf, input_dim)
        self.num_layers = conf.getint("num_layers", 2)
        self.num_units = conf.getint("num_units", 256)
        self.dropout = conf.getfloat("dropout", 0.0)
        self.activation = conf.get("activation", "relu")
        self.act = core.activation(self.activation)
        self.output_dim = self.num_units

    def init(self, generator) -> dict:
        params = {}
        in_dim = self.input_dim
        for i in range(self.num_layers):
            params[f"layer_{i}"] = core.linear_init(generator, in_dim, self.num_units)
            in_dim = self.num_units
        return params

    def apply(self, params, features, lengths, train=False, generator=None):
        x = features
        for i in range(self.num_layers):
            x = self.act(core.linear_apply(params[f"layer_{i}"], x))
            x = core.dropout(x, self.dropout, train, generator)
        return x, lengths


def expert_choice(scores: torch.Tensor, capacity: int):
    """Expert-choice selection: scores [S, E] -> (gate [E, C], token
    indices [E, C]), each expert's ``capacity`` best tokens, best first,
    ties toward the lower token index (``jax.lax.top_k``'s order; a stable
    descending sort, where ``torch.topk`` promises no order)."""
    gate, idx = torch.sort(scores.t(), dim=-1, descending=True, stable=True)
    return gate[:, :capacity], idx[:, :capacity]


@ENCODERS.register("transformer")
class TransformerEncoder(Encoder):
    """Self-attention encoder: a pyramid stack by ``subsample`` (1, 2, 4 or
    8), ``in_proj``, sinusoidal positions, ``num_layers`` pre-LN blocks
    (length-masked multi-head self-attention, then a GELU FFN), an output
    layer norm, padded frames zeroed.

    Config as the JAX package's: ``num_layers`` (6), ``num_units`` (256),
    ``num_heads`` (4), ``ffn_dim`` (4 x num_units), ``dropout``,
    ``subsample``, ``remat`` (each block under ``torch.utils.checkpoint``;
    its dropout masks are drawn before the block, so the recomputation sees
    them), ``scan_layers`` (not read: the blocks run as a loop, the
    numerics of JAX's scan), ``moe_experts`` / ``moe_capacity`` (every
    block's FFN an expert-choice mixture of experts: each of E experts
    takes its C = ceil(capacity x tokens / E) best tokens of the flattened
    batch). ``pipeline_stages > 1`` (the 'pipe' mesh axis) is not ported.

    The attention scores and softmax are f32 whatever the compute dtype
    (``core.attention``); the products, layer norms and FFNs run in it."""

    drops_per_block = 2

    def __init__(self, conf: Conf, input_dim: int):
        super().__init__(conf, input_dim)
        self.num_layers = conf.getint("num_layers", 6)
        self.d = conf.getint("num_units", 256)
        self.num_heads = conf.getint("num_heads", 4)
        if self.d % self.num_heads:
            raise ValueError(f"num_units {self.d} not divisible by num_heads {self.num_heads}")
        self.ffn_dim = conf.getint("ffn_dim", 4 * self.d)
        self.dropout = conf.getfloat("dropout", 0.0)
        self.subsample = conf.getint("subsample", 1)
        if self.subsample not in (1, 2, 4, 8):
            raise ValueError("subsample must be 1, 2, 4 or 8")
        self.remat = conf.getbool("remat", False)
        self.moe_experts = conf.getint("moe_experts", 0)
        self.moe_capacity = conf.getfloat("moe_capacity", 2.0)
        stages = conf.getint("pipeline_stages", 0)
        if stages > 1:
            if self.num_layers % stages:
                raise ValueError(f"num_layers {self.num_layers} not divisible by "
                                 f"pipeline_stages {stages}")
            raise NotImplementedError("pipeline_stages > 1 (the 'pipe' mesh axis) not ported yet")
        self.output_dim = self.d

    # -- params ----------------------------------------------------------
    def init(self, generator) -> dict:
        d, f = self.d, self.ffn_dim
        params = {"in_proj": core.linear_init(generator, self.input_dim * self.subsample, d)}
        for i in range(self.num_layers):
            blk = {
                "ln1_g": torch.ones((d,), device=generator.device),
                "ln1_b": torch.zeros((d,), device=generator.device),
                "wqkv": core.glorot(generator, (d, 3 * d)),
                "wo": core.linear_init(generator, d, d),
                "ln2_g": torch.ones((d,), device=generator.device),
                "ln2_b": torch.zeros((d,), device=generator.device),
            }
            if self.moe_experts > 0:
                blk.update(self._moe_init(generator))
            else:
                blk["ffn1"] = core.linear_init(generator, d, f)
                blk["ffn2"] = core.linear_init(generator, f, d)
            params[f"block_{i}"] = blk
        params["ln_out_g"] = torch.ones((d,), device=generator.device)
        params["ln_out_b"] = torch.zeros((d,), device=generator.device)
        return params

    def _moe_init(self, generator) -> dict:
        """The router ``wg [d, E]`` and the expert-stacked FFN ``we1 [E, d,
        f]``, ``be1 [E, f]``, ``we2 [E, f, d]``, ``be2 [E, d]``."""
        E, d, f = self.moe_experts, self.d, self.ffn_dim
        return {
            "wg": core.glorot(generator, (d, E)),
            "we1": core.glorot(generator, (E, d, f)),
            "be1": torch.zeros((E, f), device=generator.device),
            "we2": core.glorot(generator, (E, f, d)),
            "be2": torch.zeros((E, d), device=generator.device),
        }

    # -- pieces ----------------------------------------------------------
    def _moe_ffn(self, p, y, valid):
        """Expert-choice MoE FFN on pre-normed y [B, T, d]: the router in
        f32 (a softmax over experts, padded tokens scored 0), each expert's
        C tokens through its GELU FFN in one batched product, the outputs
        weighted by their gates and added back to their tokens one expert
        at a time in expert order (an expert's C tokens are distinct, so
        the sums, and their bits, repeat on the card). Tokens no expert
        picks get zeros (the residual carries them)."""
        B, T, d = y.shape
        E = self.moe_experts
        S = B * T
        C = min(S, -(-int(self.moe_capacity * S) // E))  # ceil
        yt = y.reshape(S, d)
        logits = (yt @ p["wg"].to(y.dtype)).float()
        scores = torch.softmax(logits, dim=-1)
        scores = torch.where(valid.reshape(S, 1), scores, 0.0)
        gate, idx = expert_choice(scores, C)  # [E, C]
        xe = yt[idx]  # [E, C, d]
        h = core.gelu(torch.bmm(xe, p["we1"].to(y.dtype)) + p["be1"].to(y.dtype)[:, None, :])
        out = torch.bmm(h, p["we2"].to(y.dtype)) + p["be2"].to(y.dtype)[:, None, :]
        out = out * gate.to(y.dtype)[..., None]
        combined = torch.zeros((S, d), dtype=y.dtype, device=y.device)
        for e in range(E):
            combined = combined.index_add(0, idx[e], out[e])
        return combined.reshape(B, T, d)

    def _mhsa(self, p, y, bias):
        """Length-masked multi-head self-attention on pre-normed y."""
        B, T, d = y.shape
        nh = self.num_heads
        q, k, v = (t.reshape(B, T, nh, d // nh).transpose(1, 2)
                   for t in (y @ p["wqkv"]).chunk(3, dim=-1))
        att = core.attention(q, k, v, bias).transpose(1, 2).reshape(B, T, d)
        return core.linear_apply(p["wo"], att)

    def _ffn(self, x, ln_g, ln_b, p1, p2):
        y = core.layer_norm(x, ln_g, ln_b)
        return core.linear_apply(p2, core.gelu(y @ p1["w"] + p1["b"]))

    def _drop(self, x, keep_mask):
        """Inverted dropout by a mask drawn ahead (``_drop_masks``)."""
        if keep_mask is None:
            return x
        keep = 1.0 - self.dropout
        return torch.where(keep_mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))

    def _drop_masks(self, x, train, generator):
        """A block's dropout keep-masks, drawn before it runs (a block under
        ``remat`` recomputes with the same masks), or Nones."""
        if not train or self.dropout <= 0.0:
            return (None,) * self.drops_per_block
        keep = 1.0 - self.dropout
        return tuple(torch.rand(x.shape, generator=generator, device=x.device) < keep
                     for _ in range(self.drops_per_block))

    def _block(self, p, x, bias, valid, drops):
        y = core.layer_norm(x, p["ln1_g"], p["ln1_b"])
        x = x + self._drop(self._mhsa(p, y, bias), drops[0])
        if self.moe_experts > 0:
            y = self._moe_ffn(p, core.layer_norm(x, p["ln2_g"], p["ln2_b"]), valid)
        else:
            y = self._ffn(x, p["ln2_g"], p["ln2_b"], p["ffn1"], p["ffn2"])
        return x + self._drop(y, drops[1])

    def apply(self, params, features, lengths, train=False, generator=None):
        x = features
        lengths = lengths.to(x.device)
        for _ in range(self.subsample.bit_length() - 1):
            x, lengths = core.pyramid_stack(x, lengths)
        B, T, _ = x.shape
        x = core.linear_apply(params["in_proj"], x)
        x = x + core.sinusoidal_pe(T, self.d, x.dtype, x.device)[None]
        valid = torch.arange(T, dtype=lengths.dtype, device=x.device)[None, :] < lengths[:, None]
        # [B, 1, 1, T] additive attention bias: -1e9 at padded keys
        bias = torch.where(valid, 0.0, -1e9).to(torch.float32)[:, None, None, :]
        remat = self.remat and torch.is_grad_enabled()
        for i in range(self.num_layers):
            drops = self._drop_masks(x, train, generator)
            if remat:
                x = checkpoint(self._block, params[f"block_{i}"], x, bias, valid, drops,
                               use_reentrant=False)
            else:
                x = self._block(params[f"block_{i}"], x, bias, valid, drops)
        x = core.layer_norm(x, params["ln_out_g"], params["ln_out_b"])
        # zero padded frames (the recurrent encoders' contract)
        return x * valid[:, :, None].to(x.dtype), lengths


@ENCODERS.register("conformer")
class ConformerEncoder(TransformerEncoder):
    """Conformer blocks: a half-step FFN, masked MHSA, the convolution
    module (layer norm, padding zeroed, pointwise ``pw1``, GLU, depthwise
    ``dw [K, d]`` with XLA's SAME padding, layer norm, swish, pointwise
    ``pw2``), a second half-step FFN. ``kernel_size`` (15) sets K. With
    ``moe_experts`` the second half-step FFN is the expert layer and the
    dense first one takes ``ffn1`` / ``ffn2`` (the JAX package's leaf
    names); without, the second is ``ff2_1`` / ``ff2_2``."""

    drops_per_block = 4

    def __init__(self, conf: Conf, input_dim: int):
        super().__init__(conf, input_dim)
        self.kernel_size = conf.getint("kernel_size", 15)

    def init(self, generator) -> dict:
        params = super().init(generator)
        d, f, K = self.d, self.ffn_dim, self.kernel_size
        dev = generator.device
        for i in range(self.num_layers):
            blk = params[f"block_{i}"]
            blk["ln_ff2_g"] = torch.ones((d,), device=dev)
            blk["ln_ff2_b"] = torch.zeros((d,), device=dev)
            if self.moe_experts > 0:
                blk["ffn1"] = core.linear_init(generator, d, f)
                blk["ffn2"] = core.linear_init(generator, f, d)
            else:
                blk["ff2_1"] = core.linear_init(generator, d, f)
                blk["ff2_2"] = core.linear_init(generator, f, d)
            blk["ln_conv_g"] = torch.ones((d,), device=dev)
            blk["ln_conv_b"] = torch.zeros((d,), device=dev)
            blk["pw1"] = core.linear_init(generator, d, 2 * d)
            blk["dw"] = core.uniform_scale(generator, (K, d), 1.0 / math.sqrt(K))
            blk["ln_dw_g"] = torch.ones((d,), device=dev)
            blk["ln_dw_b"] = torch.zeros((d,), device=dev)
            blk["pw2"] = core.linear_init(generator, d, d)
        return params

    def _conv_module(self, p, x, valid):
        y = core.layer_norm(x, p["ln_conv_g"], p["ln_conv_b"])
        # a SAME window must see zeros, not padding's values
        y = y * valid[:, :, None].to(y.dtype)
        a, b = core.linear_apply(p["pw1"], y).chunk(2, dim=-1)
        y = a * torch.sigmoid(b)  # GLU
        # dw [K, d] -> conv1d's [d, 1, K]; XLA's SAME pads (K - 1) // 2
        # before and K // 2 after (one more after for an even K)
        K = p["dw"].shape[0]
        w = p["dw"].to(y.dtype).t()[:, None, :]
        y = y.transpose(1, 2)
        if K % 2:
            y = F.conv1d(y, w, padding=K // 2, groups=self.d)
        else:
            y = F.conv1d(F.pad(y, ((K - 1) // 2, K // 2)), w, groups=self.d)
        y = y.transpose(1, 2)
        y = core.layer_norm(y, p["ln_dw_g"], p["ln_dw_b"])
        y = y * torch.sigmoid(y)  # swish
        return core.linear_apply(p["pw2"], y)

    def _block(self, p, x, bias, valid, drops):
        # macaron: half-step FFN - MHSA - conv - half-step FFN
        y = self._ffn(x, p["ln2_g"], p["ln2_b"], p["ffn1"], p["ffn2"])
        x = x + 0.5 * self._drop(y, drops[0])
        y = core.layer_norm(x, p["ln1_g"], p["ln1_b"])
        x = x + self._drop(self._mhsa(p, y, bias), drops[1])
        x = x + self._drop(self._conv_module(p, x, valid), drops[2])
        if self.moe_experts > 0:
            y = self._moe_ffn(p, core.layer_norm(x, p["ln_ff2_g"], p["ln_ff2_b"]), valid)
        else:
            y = self._ffn(x, p["ln_ff2_g"], p["ln_ff2_b"], p["ff2_1"], p["ff2_2"])
        return x + 0.5 * self._drop(y, drops[3])


def build_encoder(conf: Conf, input_dim: int) -> Encoder:
    name = conf.get("encoder", "dblstm")
    if name.lower() not in ENCODERS.names():
        raise NotImplementedError(f"encoder {name!r} not ported yet")
    return ENCODERS.build(name, conf, input_dim)
