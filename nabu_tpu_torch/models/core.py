"""Core neural building blocks: initializers, Linear, embedding, dropout,
activations, LSTM cell, masked LSTM scan, BLSTM, pyramid stack.

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


def uniform_scale(generator: torch.Generator, shape, scale: float) -> torch.Tensor:
    """Uniform(-scale, scale), f32 on the generator's device."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    return (2.0 * u - 1.0) * scale


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


# -- activations -----------------------------------------------------------

# ``jax.nn``'s functions by name, with its defaults: ``gelu`` is the tanh
# approximation (``jax.nn.gelu(x, approximate=True)``), not the erf GELU
_ACTIVATIONS = {
    "relu": torch.relu,
    "relu6": torch.nn.functional.relu6,
    "gelu": lambda x: torch.nn.functional.gelu(x, approximate="tanh"),
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "silu": torch.nn.functional.silu,
    "swish": torch.nn.functional.silu,
    "elu": torch.nn.functional.elu,
    "softplus": torch.nn.functional.softplus,
    "leaky_relu": torch.nn.functional.leaky_relu,
}


def activation(name: str):
    """The activation a config names after its ``jax.nn`` function."""
    if name not in _ACTIVATIONS:
        raise ValueError(f"unknown activation {name!r} (one of {sorted(_ACTIVATIONS)})")
    return _ACTIVATIONS[name]


def gelu(x: torch.Tensor) -> torch.Tensor:
    return _ACTIVATIONS["gelu"](x)


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
    init_carry: Tuple[torch.Tensor, torch.Tensor] | None = None,
    return_carry: bool = False,
):
    """Unidirectional masked LSTM over a padded batch -> [B, T, H].

    For ``reverse=True`` the padded array is flipped wholesale; the mask
    gate keeps the carried state at its initial zeros through the
    leading padding. Everything runs in x's dtype, as the JAX scan.

    ``init_carry`` / ``return_carry`` (forward direction only) expose the
    (h, c) state, so a sequence fed in chunks with the carry threaded
    through equals one scan: the mask freezes the carry at each lane's
    last valid frame."""
    if init_carry is not None and reverse:
        raise ValueError("init_carry only supports the forward direction")
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
    if init_carry is None:
        h = torch.zeros((B, H), dtype=x.dtype, device=x.device)
        c = torch.zeros((B, H), dtype=x.dtype, device=x.device)
    else:
        h, c = init_carry
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
    return (y, (h, c)) if return_carry else y


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


# -- attention -------------------------------------------------------------

def sinusoidal_rows(pos: torch.Tensor, d: int) -> torch.Tensor:
    """Sinusoidal position rows [n, d] in f32 at positions ``pos`` [n]
    (f32): sin at the even columns, cos at the odd ones, of pos / 10000^(2i
    / d). One function for a whole sequence and for one decode position,
    so a cached step sees its row's bits."""
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=pos.device)[None, :]
    angle = pos[:, None] / torch.pow(10000.0, dim / d)
    pe = torch.zeros((pos.shape[0], d), dtype=torch.float32, device=pos.device)
    pe[:, 0::2] = torch.sin(angle)
    pe[:, 1::2] = torch.cos(angle[:, : d // 2])
    return pe


def sinusoidal_pe(T: int, d: int, dtype, device=None) -> torch.Tensor:
    """The standard sinusoidal position encoding [T, d] in ``dtype``."""
    return sinusoidal_rows(torch.arange(T, dtype=torch.float32, device=device), d).to(dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              bias: torch.Tensor) -> torch.Tensor:
    """Scaled dot-product attention of q [..., n, hd] over k / v [..., m,
    hd] with an additive f32 ``bias`` broadcastable to [..., n, m]: the
    scores in f32 from the inputs as they are (the f32 product of bf16 q
    and k, as ``preferred_element_type=f32``; float64 inputs keep float64),
    the softmax in that type, the weights cast to v's dtype for the value
    product."""
    sdt = torch.promote_types(q.dtype, torch.float32)
    hd = torch.tensor(float(q.shape[-1]), dtype=torch.float32)
    scores = torch.matmul(q.to(sdt), k.to(sdt).transpose(-1, -2)) / torch.sqrt(hd)
    weights = torch.softmax(scores + bias, dim=-1).to(v.dtype)
    return torch.matmul(weights, v)


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
