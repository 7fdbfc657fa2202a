"""Core neural building blocks: initializers, Linear, embedding, dropout,
LSTM cell, masked LSTM scan, BLSTM, pyramid stack.

Port of the JAX package's ``models/core.py``. Initializers draw from an
explicit ``torch.Generator`` (the JAX package's ``jax.random`` keys give
other numbers from the same seed). Parameters are plain dicts of tensors with
the JAX layout: ``linear {w [in, out], b [out]}``, LSTM direction
``{wx [D, 4H], wh [H, 4H], b [4H]}`` with gate order i, f, g, o and
``forget_bias`` added inside the f sigmoid — not ``nn.LSTM``'s
semantics.

Variable lengths are handled by mask-gated state updates: padding
frames leave the carried state untouched and output zeros, so the
reversed scan over a padded batch equals a per-sequence reversal.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

Params = Dict[str, torch.Tensor]


# -- initializers ----------------------------------------------------------

def glorot(generator: torch.Generator, shape) -> torch.Tensor:
    """Uniform(-l, l), l = sqrt(6 / (fan_in + fan_out)), f32 on the
    generator's device."""
    limit = math.sqrt(6.0 / (shape[-2] + shape[-1]))
    u = torch.rand(shape, generator=generator, device=generator.device)
    return (2.0 * u - 1.0) * limit


def linear_init(generator: torch.Generator, in_dim: int, out_dim: int) -> Params:
    return {
        "w": glorot(generator, (in_dim, out_dim)),
        "b": torch.zeros((out_dim,), device=generator.device),
    }


def embedding_init(generator: torch.Generator, vocab: int, dim: int) -> Params:
    return {"table": torch.randn((vocab, dim), generator=generator,
                                 device=generator.device) * 0.02}


def lstm_init(generator: torch.Generator, in_dim: int, hidden: int) -> Params:
    """One LSTM direction. Gate order along the 4H axis: i, f, g, o. (The
    layer-norm variant has no init here: it is not on a ported path.)"""
    return {
        "wx": glorot(generator, (in_dim, 4 * hidden)),
        "wh": glorot(generator, (hidden, 4 * hidden)),
        "b": torch.zeros((4 * hidden,), device=generator.device),
    }


def blstm_init(generator: torch.Generator, in_dim: int, hidden: int) -> Params:
    return {
        "fw": lstm_init(generator, in_dim, hidden),
        "bw": lstm_init(generator, in_dim, hidden),
    }


# -- dropout ---------------------------------------------------------------

def dropout(x: torch.Tensor, rate: float, train: bool,
            generator: torch.Generator | None = None) -> torch.Tensor:
    """Inverted dropout in x's dtype: ``where(keep_mask, x / keep, 0)``
    (the JAX package's ``core.dropout``). The mask is drawn from
    ``generator`` on x's device."""
    if not train or rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def linear_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    return x @ p["w"] + p["b"]


def embedding_apply(p: Params, ids: torch.Tensor) -> torch.Tensor:
    return p["table"][ids.to(device=p["table"].device, dtype=torch.int64)]


def lstm_cell(
    xw_t: torch.Tensor,  # [B, 4H] precomputed x @ wx (+ b)
    h: torch.Tensor,  # [B, H]
    c: torch.Tensor,  # [B, H]
    wh: torch.Tensor,  # [H, 4H]
    forget_bias: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    gates = xw_t + h @ wh
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    c_new = torch.sigmoid(f + forget_bias) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new


def layer_norm(
    x: torch.Tensor, g: torch.Tensor, b: torch.Tensor | None = None,
    eps: float = 1e-5,
) -> torch.Tensor:
    """Layer norm over the last axis with learned gain (and bias)."""
    mu = x.mean(dim=-1, keepdim=True)
    var = torch.square(x - mu).mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps) * g
    return y + b if b is not None else y


def lstm_ln_cell(
    xw_ln_t: torch.Tensor,  # [B, 4H] layer-normed x projection (+ b)
    h: torch.Tensor,
    c: torch.Tensor,
    p: Params,  # needs wh, ln_h_g, ln_c_g, ln_c_b
    forget_bias: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Layer-norm LSTM cell (Ba et al. 2016)."""
    gates = xw_ln_t + layer_norm(h @ p["wh"], p["ln_h_g"])
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    c_new = torch.sigmoid(f + forget_bias) * c + torch.sigmoid(i) * torch.tanh(g)
    c_out = layer_norm(c_new, p["ln_c_g"], p["ln_c_b"])
    h_new = torch.sigmoid(o) * torch.tanh(c_out)
    return h_new, c_new


def lstm_scan(
    p: Params,
    x: torch.Tensor,  # [B, T, D]
    lengths: torch.Tensor,  # [B]
    reverse: bool = False,
    forget_bias: float = 1.0,
) -> torch.Tensor:
    """Unidirectional masked LSTM over a padded batch -> [B, T, H].

    For ``reverse=True`` the padded array is flipped wholesale; the mask
    gate keeps the carried state at its initial zeros through the
    leading padding. Everything runs in x's dtype, as the JAX scan."""
    B, T, _ = x.shape
    H = p["wh"].shape[0]
    mask = (
        torch.arange(T, device=x.device)[None, :] < lengths.to(x.device)[:, None]
    )
    if reverse:
        x = torch.flip(x, dims=(1,))
        mask = torch.flip(mask, dims=(1,))
    ln = "ln_x_g" in p
    if ln:
        xw = layer_norm(x @ p["wx"], p["ln_x_g"]) + p["b"]
    else:
        xw = x @ p["wx"] + p["b"]  # [B, T, 4H]
    h = torch.zeros((B, H), dtype=x.dtype, device=x.device)
    c = torch.zeros((B, H), dtype=x.dtype, device=x.device)
    ys = []
    for t in range(T):
        m = mask[:, t, None]
        if ln:
            h_new, c_new = lstm_ln_cell(xw[:, t], h, c, p, forget_bias)
        else:
            h_new, c_new = lstm_cell(xw[:, t], h, c, p["wh"], forget_bias)
        h = torch.where(m, h_new, h)
        c = torch.where(m, c_new, c)
        ys.append(h * m.to(h.dtype))
    y = torch.stack(ys, dim=1) if ys else xw.new_zeros((B, 0, H))
    if reverse:
        y = torch.flip(y, dims=(1,))
    return y


def blstm_apply(
    p: Params, x: torch.Tensor, lengths: torch.Tensor, impl: str = "scan"
) -> torch.Tensor:
    """Bidirectional LSTM -> [B, T, 2H] (fw ++ bw).

    impl="kernel" runs the CUDA BLSTM kernels (their plain versions for
    CPU tensors); the layer-norm variant has no kernel and keeps the
    scan."""
    if impl == "kernel" and "ln_x_g" not in p["fw"]:
        y = blstm_apply_tm(p, x.transpose(0, 1), lengths, impl)
        return y.transpose(0, 1)
    fw = lstm_scan(p["fw"], x, lengths, reverse=False)
    bw = lstm_scan(p["bw"], x, lengths, reverse=True)
    return torch.cat([fw, bw], dim=-1)


def blstm_apply_tm(
    p: Params, x_tm: torch.Tensor, lengths: torch.Tensor, impl: str = "scan"
) -> torch.Tensor:
    """Time-major bidirectional LSTM: [T, B, D] -> [T, B, 2H].

    impl="kernel" takes the kernel path (ops.blstm.blstm_tm_apply), which
    reads and writes time-major tensors directly; "scan" transpose-wraps
    the batch-major scan."""
    if impl == "kernel" and "ln_x_g" not in p["fw"]:
        from nabu_tpu_torch.ops.blstm import blstm_tm_apply

        return blstm_tm_apply(p, x_tm, lengths)
    y = blstm_apply(p, x_tm.transpose(0, 1), lengths, "scan")
    return y.transpose(0, 1)


# -- pyramid stack ---------------------------------------------------------

def pyramid_stack(x: torch.Tensor, lengths: torch.Tensor):
    """Concatenate adjacent frame pairs: [B, T, D] -> [B, ceil(T/2), 2D]
    (a zero frame appended for odd T); new lengths ceil(len / 2)."""
    B, T, D = x.shape
    if T % 2:
        x = torch.nn.functional.pad(x, (0, 0, 0, 1))
        T += 1
    return x.reshape(B, T // 2, 2 * D), (lengths + 1) // 2


def pyramid_stack_tm(x_tm: torch.Tensor, lengths: torch.Tensor):
    """Time-major pyramid stack: [T, B, D] -> [ceil(T/2), B, 2D],
    concatenating frames (2t, 2t+1) exactly like ``pyramid_stack``."""
    if x_tm.shape[0] % 2:
        x_tm = torch.nn.functional.pad(x_tm, (0, 0, 0, 0, 0, 1))
    return torch.cat([x_tm[0::2], x_tm[1::2]], dim=-1), (lengths + 1) // 2
