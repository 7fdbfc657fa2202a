"""Model container: encoder + one-or-more decoder heads from model.cfg.

Port of the JAX package's ``models/model.py``. Parameters are the JAX
tree as nested dicts of tensors (``params.from_jax_params``).
``compute_dtype`` (``[model] compute_dtype = bfloat16``) casts every f32
parameter and the features at the model boundary, so the forward runs in
bf16 while the stored parameters (and their gradients, through the
casts) stay f32; logits come back in f32 for the losses and decoding.
``apply`` is the inference forward (no autograd graph); ``apply_train``
is the same forward with gradients, ``train`` switching dropout on, and
with ``[model] spec_augment = true`` SpecAugment of the features before
the encoder (``ops.augment``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from nabu_tpu_torch.config import Conf, ConfigFile
from nabu_tpu_torch.models.decoders import Decoder, build_decoder
from nabu_tpu_torch.models.encoders import Encoder, build_encoder
from nabu_tpu_torch.ops.augment import parse_spec_augment_conf, spec_augment

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _cast_tree(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor) and tree.dtype == torch.float32:
        return tree.to(dtype)
    return tree


class Model:
    """Encoder + named decoder heads."""

    def __init__(
        self,
        encoder: Encoder,
        decoders: Dict[str, Decoder],
        head_confs: Dict[str, Conf],
        compute_dtype: str = "float32",
        spec_augment: Optional[dict] = None,
    ):
        self.encoder = encoder
        self.decoders = decoders
        self.head_confs = head_confs
        if compute_dtype not in _DTYPES:
            raise ValueError(
                f"compute_dtype {compute_dtype!r} not supported "
                f"(one of {sorted(_DTYPES)})"
            )
        self.compute_dtype = _DTYPES[compute_dtype]
        # SpecAugment params (parse_spec_augment_conf), train time only
        self.spec_augment = spec_augment

    def _cast_in(self, tree):
        if self.compute_dtype == torch.float32:
            return tree
        return _cast_tree(tree, self.compute_dtype)

    # loss spec per head: (loss name, weight)
    def head_loss(self, name: str) -> Tuple[str, float]:
        conf = self.head_confs[name]
        default = getattr(self.decoders[name], "default_loss", "cross_entropy")
        return conf.get("loss", default), conf.getfloat("loss_weight", 1.0)

    def init(self, generator: torch.Generator) -> dict:
        """f32 parameters drawn from ``generator`` (encoder first, then the
        heads in order)."""
        return {
            "encoder": self.encoder.init(generator),
            "decoders": {name: dec.init(generator) for name, dec in self.decoders.items()},
        }

    def encode(self, params, features, lengths, train=False, generator=None):
        return self.encoder.apply(
            self._cast_in(params["encoder"]), self._cast_in(features), lengths,
            train=train, generator=generator,
        )

    def apply_train(
        self,
        params: dict,
        features: torch.Tensor,
        feature_lengths: torch.Tensor,
        targets: Optional[torch.Tensor] = None,
        target_lengths: Optional[torch.Tensor] = None,
        train: bool = True,
        generator: Optional[torch.Generator] = None,
        heads: Optional[Tuple[str, ...]] = None,
    ) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
        """Returns {head name: (logits, logit_lengths)}, with gradients to
        the parameters (logits f32, but for a transducer head's projection
        dict or lattice); ``heads`` restricts which decoder heads run."""
        if train and self.spec_augment is not None:
            if generator is None:
                generator = torch.Generator(device=features.device).manual_seed(0)
            features = spec_augment(generator, features, feature_lengths, **self.spec_augment)
        encoded, enc_lengths = self.encode(
            params, features, feature_lengths, train=train, generator=generator)
        outputs = {}
        for name, dec in self.decoders.items():
            if heads is not None and name not in heads:
                continue
            logits, logit_lengths = dec.apply(
                self._cast_in(params["decoders"][name]), encoded, enc_lengths,
                targets=targets, target_lengths=target_lengths, train=train,
                generator=generator,
            )
            # losses and decoding run in f32, except a dict (the transducer
            # head's projection handle for the fused kernels) and a 4-D
            # transducer lattice, which stays in the compute dtype (its
            # loss upcasts inside the log-softmax; a cast here would add an
            # f32 copy of the largest tensor of the step)
            if not isinstance(logits, dict) and logits.dim() < 4:
                logits = logits.to(torch.float32)
            outputs[name] = (logits, logit_lengths)
        return outputs

    @torch.no_grad()
    def apply(
        self,
        params: dict,
        features: torch.Tensor,
        feature_lengths: torch.Tensor,
        heads: Optional[Tuple[str, ...]] = None,
    ) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
        """The inference forward: {head name: (logits f32, logit_lengths)}."""
        return self.apply_train(params, features, feature_lengths, train=False,
                                heads=heads)


def build_model(model_cfg: ConfigFile, input_dim: int, num_labels: int) -> Model:
    """Build a Model from a model.cfg file: ``[encoder]`` configures the
    encoder; ``[model] decoders = name...`` lists head sections (default:
    the single ``[decoder]`` section)."""
    encoder = build_encoder(model_cfg.section("encoder"), input_dim)
    model_section = model_cfg.get_section("model")
    if model_section is not None and "decoders" in model_section:
        head_names = model_section.getlist("decoders")
    else:
        head_names = ["decoder"]
    compute_dtype = (
        model_section.get("compute_dtype", "float32")
        if model_section is not None
        else "float32"
    )
    decoders: Dict[str, Decoder] = {}
    head_confs: Dict[str, Conf] = {}
    for name in head_names:
        conf = model_cfg.section(name)
        decoders[name] = build_decoder(conf, encoder.output_dim, num_labels)
        head_confs[name] = conf
    return Model(encoder, decoders, head_confs, compute_dtype,
                 spec_augment=parse_spec_augment_conf(model_section))
