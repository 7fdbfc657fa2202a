"""Encoders: DBLSTM and the pyramidal Listener.

Port of the ``DBLSTM`` and ``Listener`` of the JAX package's
``models/encoders.py``.
Each encoder maps ``(features [B, T, F], lengths) -> (encoded [B, T', D],
lengths')`` and is selected by the ``[encoder]`` config section. The
other encoders of the JAX package are not ported yet.
"""

from __future__ import annotations

import torch

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


def build_encoder(conf: Conf, input_dim: int) -> Encoder:
    name = conf.get("encoder", "dblstm")
    if name.lower() not in ENCODERS.names():
        raise NotImplementedError(f"encoder {name!r} not ported yet")
    return ENCODERS.build(name, conf, input_dim)
