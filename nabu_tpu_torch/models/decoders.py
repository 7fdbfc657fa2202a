"""Model-side decoders: the linear CTC head.

Port of ``LinearCTC`` of the JAX package's ``models/decoders.py``: a
per-frame projection of the encoder output to ``num_labels + 1``
logits with blank = ``num_labels`` (last index). The transducer head is
in ``models.transducer`` (registered as ``rnnt`` / ``transducer`` when the
package is imported); the attention and transformer heads are not ported
yet.
"""

from __future__ import annotations

import torch

from nabu_tpu_torch.config import Conf
from nabu_tpu_torch.models import core
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


def build_decoder(conf: Conf, encoder_dim: int, num_labels: int) -> Decoder:
    name = conf.get("decoder", "linear_ctc")
    if name.lower() not in DECODERS.names():
        raise NotImplementedError(f"decoder {name!r} not ported yet")
    return DECODERS.build(name, conf, encoder_dim, num_labels)
