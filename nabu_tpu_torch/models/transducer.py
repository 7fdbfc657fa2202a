"""RNN-T (transducer) decoder head: prediction network + joint network.

Port of the JAX package's ``models/transducer.py``. The head plugs into
the ``[decoder]``-section registry and the multi-head Model container:

- the training ``apply`` returns the projection handle
  ``{"enc_proj", "pred_proj", "w_out", "b_out"}`` that the fused joint+loss
  kernels consume (``loss = transducer``, ``ops.transducer_fused``),
  always on a CUDA device and with ``use_pallas = true`` on the CPU; with
  ``use_pallas = false`` on the CPU it returns the joint lattice
  ``logits [B, T, U+1, V+1]`` as the JAX package does. ``remat`` only
  trades memory for recomputation in JAX and is not read;
- decode-time recognizers (``decoding.transducer``) drive ``pred_step`` and
  ``joint_step`` frame by frame.

The prediction net is the plain masked ``core.lstm_scan`` on every device
(the JAX package runs it through ``lax.scan``, no Pallas kernel). Label ids
follow the CTC head: targets in [0, num_labels), blank = num_labels (the
last index); the start symbol reuses embedding row num_labels.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from nabu_tpu_torch.config import Conf
from nabu_tpu_torch.models import core
from nabu_tpu_torch.models.decoders import Decoder
from nabu_tpu_torch.ops.masking import sequence_mask
from nabu_tpu_torch.registry import DECODERS

PredState = List[Tuple[torch.Tensor, torch.Tensor]]


@DECODERS.register("rnnt")
@DECODERS.register("transducer")
class TransducerDecoder(Decoder):
    """Prediction LSTM stack + additive-tanh joint network (Graves 2012)."""

    default_loss = "transducer"

    def __init__(self, conf: Conf, encoder_dim: int, num_labels: int):
        super().__init__(conf, encoder_dim, num_labels)
        self.num_layers = conf.getint("num_layers", 1)
        self.num_units = conf.getint("num_units", 256)
        self.embed_dim = conf.getint("embed_dim", self.num_units)
        self.joint_dim = conf.getint("joint_units", self.num_units)
        self.use_pallas = conf.getbool("use_pallas", False)
        self.blank_id = self.num_labels
        self.sos_id = self.num_labels  # embedding row, never emitted

    # -- params ----------------------------------------------------------
    def init(self, generator) -> dict:
        params = {"embed": core.embedding_init(generator, self.output_dim, self.embed_dim)}
        in_dim = self.embed_dim
        for i in range(self.num_layers):
            params[f"lstm_{i}"] = core.lstm_init(generator, in_dim, self.num_units)
            in_dim = self.num_units
        params["joint_enc"] = core.linear_init(generator, self.encoder_dim, self.joint_dim)
        params["joint_pred"] = core.linear_init(generator, self.num_units, self.joint_dim)
        params["out"] = core.linear_init(generator, self.joint_dim, self.output_dim)
        return params

    # -- prediction network ------------------------------------------------
    def pred_init_state(self, batch: int, dtype=torch.float32, device=None) -> PredState:
        return [
            (torch.zeros((batch, self.num_units), dtype=dtype, device=device),
             torch.zeros((batch, self.num_units), dtype=dtype, device=device))
            for _ in range(self.num_layers)
        ]

    def pred_step(self, params: dict, prev_ids: torch.Tensor,
                  state: PredState) -> Tuple[torch.Tensor, PredState]:
        """One prediction-net step: prev label id [B] -> ([B, P], state),
        the arithmetic of ``_pred_sequence``'s scan."""
        x = core.embedding_apply(params["embed"], prev_ids)
        new_state: PredState = []
        for i in range(self.num_layers):
            h, c = state[i]
            p = params[f"lstm_{i}"]
            h, c = core.lstm_cell(x @ p["wx"] + p["b"], h, c, p["wh"])
            new_state.append((h, c))
            x = h
        return x, new_state

    def _pred_sequence(self, params: dict, targets: torch.Tensor,
                       target_lengths: torch.Tensor) -> torch.Tensor:
        """Teacher-forced prediction net over [<s>; targets] -> [B, U+1, P]."""
        B = targets.shape[0]
        dev = params["embed"]["table"].device
        targets = targets.to(dev)
        sos = torch.full((B, 1), self.sos_id, dtype=targets.dtype, device=dev)
        x = core.embedding_apply(params["embed"], torch.cat([sos, targets], dim=1))
        for i in range(self.num_layers):
            x = core.lstm_scan(params[f"lstm_{i}"], x, target_lengths.to(dev) + 1)
        return x

    # -- joint network ------------------------------------------------------
    def joint_step(self, params: dict, enc_proj_t: torch.Tensor,
                   pred_vec: torch.Tensor) -> torch.Tensor:
        """Joint over one (frame, prediction) pair: ``enc_proj_t`` [B, J]
        (a frame of ``precompute``), ``pred_vec`` [B, P] -> logits [B, V+1]."""
        hidden = torch.tanh(enc_proj_t + core.linear_apply(params["joint_pred"], pred_vec))
        return core.linear_apply(params["out"], hidden)

    def precompute(self, params: dict, encoded: torch.Tensor) -> torch.Tensor:
        """Step-invariant encoder projection [B, T, J] for decode loops."""
        return core.linear_apply(params["joint_enc"], encoded)

    # -- teacher-forced training pass ---------------------------------------
    def apply(self, params, encoded, enc_lengths, targets=None, target_lengths=None,
              train=False, generator=None):
        """-> (the projection handle, or the lattice [B, T, U+1, V+1];
        enc_lengths)."""
        pred = self._pred_sequence(params, targets, target_lengths)
        # zero padded frames so masked-lane garbage cannot reach the loss
        mask = sequence_mask(enc_lengths.to(encoded.device), encoded.shape[1])
        encoded = encoded * mask[..., None].to(encoded.dtype)
        enc_proj = core.linear_apply(params["joint_enc"], encoded)
        pred_proj = core.linear_apply(params["joint_pred"], pred)
        if self.use_pallas or encoded.is_cuda:
            return {
                "enc_proj": enc_proj,
                "pred_proj": pred_proj,
                "w_out": params["out"]["w"],
                "b_out": params["out"]["b"],
            }, enc_lengths
        hidden = torch.tanh(enc_proj[:, :, None, :] + pred_proj[:, None, :, :])
        return core.linear_apply(params["out"], hidden), enc_lengths
