"""Encoders: DBLSTM.

Port of the ``DBLSTM`` of the JAX package's ``models/encoders.py``.
Each encoder maps ``(features [B, T, F], lengths) -> (encoded [B, T', D],
lengths')`` and is selected by the ``[encoder]`` config section. The
other encoders of the JAX package are not ported yet.
"""

from __future__ import annotations

from nabu_tpu_torch.config import Conf
from nabu_tpu_torch.models import core
from nabu_tpu_torch.registry import ENCODERS


class Encoder:
    """Base encoder: hyperparams from an [encoder] config section."""

    def __init__(self, conf: Conf, input_dim: int):
        self.conf = conf
        self.input_dim = input_dim
        self.output_dim: int = 0  # set by subclasses

    def apply(self, params, features, lengths):
        raise NotImplementedError


@ENCODERS.register("dblstm")
class DBLSTM(Encoder):
    """Deep bidirectional LSTM, no subsampling (the CTC workhorse).

    ``use_pallas = true`` (the recipe's key) selects the CUDA BLSTM
    kernels, time-major end to end; ``bidirectional = false`` builds a
    forward-only stack on the plain scan. Dropout is a training option
    and has no effect here."""

    def __init__(self, conf: Conf, input_dim: int):
        super().__init__(conf, input_dim)
        self.num_layers = conf.getint("num_layers", 2)
        self.num_units = conf.getint("num_units", 128)
        self.bidirectional = conf.getbool("bidirectional", True)
        self.impl = (
            "kernel"
            if conf.getbool("use_pallas", False) and self.bidirectional
            else "scan"
        )
        self.output_dim = (2 if self.bidirectional else 1) * self.num_units

    def apply(self, params, features, lengths):
        if self.impl == "kernel":
            # time-major end to end: one transpose in, one out
            x = features.transpose(0, 1)
            for i in range(self.num_layers):
                x = core.blstm_apply_tm(params[f"layer_{i}"], x, lengths, self.impl)
            return x.transpose(0, 1), lengths
        x = features
        for i in range(self.num_layers):
            if self.bidirectional:
                x = core.blstm_apply(params[f"layer_{i}"], x, lengths)
            else:
                x = core.lstm_scan(params[f"layer_{i}"], x, lengths)
        return x, lengths


def build_encoder(conf: Conf, input_dim: int) -> Encoder:
    name = conf.get("encoder", "dblstm")
    if name.lower() not in ENCODERS.names():
        raise NotImplementedError(f"encoder {name!r} not ported yet")
    return ENCODERS.build(name, conf, input_dim)
