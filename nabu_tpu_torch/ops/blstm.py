"""Bidirectional LSTM layer forward: CUDA kernel wrappers and their plain
PyTorch versions.

Port of the forward of the JAX package's ``ops/pallas/blstm.py``
(``blstm_tm_apply`` -> ``_tm_fwd`` -> ``_fwd_train_kernel2``), as two
kernels in ``csrc/blstm.cu``:

- ``blstm_proj``: ``xw_d = cast(cast(x @ wx_d) + b_d)`` for both
  directions, f32 accumulation, the bias added after the cast to the
  compute type (``_proj_block``);
- ``blstm_recur``: one persistent launch that walks the whole sequence
  for both directions with the masked cell of ``_cell`` (f32 gates and
  c, h in the compute type; the backward direction walks time
  descending) and writes masked h in natural time order into one
  ``[T, B, 2H]`` output (fw ++ bw).

Each wrapper launches its kernel for CUDA tensors and takes its plain
version only for CPU tensors. The TPU kernel's xw and c residuals serve
its backward kernel; inference does not need them.
"""

from __future__ import annotations

import ctypes

import torch

from nabu_tpu_torch.ops import kernels
from nabu_tpu_torch.ops.kernels import build

_DTYPES = {torch.bfloat16: "bf16", torch.float32: "f32"}
_fns: dict = {}

# hidden units owned by one block of the recurrence kernel
UNITS_PER_BLOCK = 8


def _launcher(name: str):
    if name not in _fns:
        fn = getattr(build.load("blstm"), f"nabu_{name}")
        if name.startswith("blstm_proj"):
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        else:
            fn.argtypes = (
                [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                + [ctypes.c_float, ctypes.c_void_p]
            )
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return _fns[name]


def _check_cuda(what: str, ref: torch.Tensor, **tensors) -> str:
    if ref.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {ref.device}")
    if ref.dtype not in _DTYPES:
        raise TypeError(f"{what}: dtype {ref.dtype} not supported (bf16 or f32)")
    for name, t in tensors.items():
        if t.device != ref.device:
            raise ValueError(f"{what}: {name} is on {t.device}, not {ref.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    return _DTYPES[ref.dtype]


# ---------------------------------------------------------------------------
# projection
# ---------------------------------------------------------------------------

def blstm_proj_plain(x, wx, b) -> torch.Tensor:
    """x [M, D], wx [2, D, 4H], b [2, 4H] -> xw [2, M, 4H] in x's dtype:
    cast(x @ wx) with f32 accumulation, then + b in the compute type."""
    acc = torch.matmul(x.to(torch.float32), wx.to(torch.float32))
    return acc.to(x.dtype) + b[:, None, :]


def blstm_proj(x, wx, b) -> torch.Tensor:
    if x.device.type == "cpu":
        return blstm_proj_plain(x, wx, b)
    tag = _check_cuda("blstm_proj", x, x=x, wx=wx, b=b)
    M, D = x.shape
    if wx.dim() != 3 or wx.shape[0] != 2 or wx.shape[1] != D:
        raise ValueError(f"blstm_proj: wx {tuple(wx.shape)} is not [2, {D}, 4H]")
    N = wx.shape[2]
    if tuple(b.shape) != (2, N):
        raise ValueError(f"blstm_proj: b {tuple(b.shape)} is not [2, {N}]")
    if wx.dtype != x.dtype or b.dtype != x.dtype:
        raise TypeError("blstm_proj: x, wx and b must share one dtype")
    out = torch.empty((2, M, N), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = _launcher(f"blstm_proj_{tag}")(
            x.data_ptr(), wx.data_ptr(), b.data_ptr(), out.data_ptr(),
            M, D, N, torch.cuda.current_stream().cuda_stream,
        )
    build.check(err, "blstm_proj")
    kernels.LAUNCHES["blstm_proj"] += 1
    return out


# ---------------------------------------------------------------------------
# recurrence
# ---------------------------------------------------------------------------

def blstm_recur_plain(xw, lengths, wh, forget_bias: float = 1.0) -> torch.Tensor:
    """xw [2, T, B, 4H] (fw, bw), lengths [B], wh [2, H, 4H] -> masked
    h [T, B, 2H] in xw's dtype: the masked lstm_scan pair with the
    cell of the TPU kernel (f32 gates and c, h in the compute type)."""
    _, T, B, H4 = xw.shape
    H = H4 // 4
    dt = xw.dtype
    mask = (
        torch.arange(T, device=xw.device)[:, None]
        < lengths.to(xw.device)[None, :]
    )[..., None]  # [T, B, 1]
    y = torch.zeros((T, B, 2 * H), dtype=dt, device=xw.device)
    for d in range(2):
        whf = wh[d].to(torch.float32)
        h = torch.zeros((B, H), dtype=dt, device=xw.device)
        c = torch.zeros((B, H), dtype=torch.float32, device=xw.device)
        steps = range(T) if d == 0 else range(T - 1, -1, -1)
        for t in steps:
            gates = xw[d, t].to(torch.float32) + h.to(torch.float32) @ whf
            gi = torch.sigmoid(gates[:, :H])
            gf = torch.sigmoid(gates[:, H: 2 * H] + forget_bias)
            gg = torch.tanh(gates[:, 2 * H: 3 * H])
            go = torch.sigmoid(gates[:, 3 * H:])
            c_new = gf * c + gi * gg
            h_new = (go * torch.tanh(c_new)).to(dt)
            m = mask[t]
            h = torch.where(m, h_new, h)
            c = torch.where(m, c_new, c)
            y[t, :, d * H: (d + 1) * H] = h * m.to(dt)
    return y


def blstm_recur(xw, lengths, wh, forget_bias: float = 1.0) -> torch.Tensor:
    if xw.device.type == "cpu":
        return blstm_recur_plain(xw, lengths, wh, forget_bias)
    tag = _check_cuda("blstm_recur", xw, xw=xw, wh=wh, lengths=lengths)
    if xw.dim() != 4 or xw.shape[0] != 2:
        raise ValueError(f"blstm_recur: xw {tuple(xw.shape)} is not [2, T, B, 4H]")
    _, T, B, H4 = xw.shape
    H = H4 // 4
    if H4 != 4 * H or tuple(wh.shape) != (2, H, H4):
        raise ValueError(f"blstm_recur: wh {tuple(wh.shape)} is not [2, {H}, {H4}]")
    if wh.dtype != xw.dtype:
        raise TypeError("blstm_recur: xw and wh must share one dtype")
    if lengths.dtype != torch.int32 or tuple(lengths.shape) != (B,):
        raise TypeError("blstm_recur: lengths must be int32 [B]")
    y = torch.empty((T, B, 2 * H), dtype=xw.dtype, device=xw.device)
    hbuf = torch.empty((2, 2, B, H), dtype=xw.dtype, device=xw.device)
    counters = torch.zeros((2,), dtype=torch.int32, device=xw.device)
    with torch.cuda.device(xw.device):
        err = _launcher(f"blstm_recur_{tag}")(
            xw.data_ptr(), lengths.data_ptr(), wh.data_ptr(), y.data_ptr(),
            hbuf.data_ptr(), counters.data_ptr(), T, B, H,
            UNITS_PER_BLOCK, float(forget_bias),
            torch.cuda.current_stream().cuda_stream,
        )
    build.check(err, "blstm_recur")
    kernels.LAUNCHES["blstm_recur"] += 1
    return y


# ---------------------------------------------------------------------------
# layer
# ---------------------------------------------------------------------------

def stack_directions(p):
    """BLSTM layer params {fw, bw: {wx, wh, b}} -> (wx [2, D, 4H],
    b [2, 4H], wh [2, H, 4H]) as the kernels take them."""
    return tuple(
        torch.stack([p["fw"][k], p["bw"][k]]).contiguous()
        for k in ("wx", "b", "wh")
    )


def blstm_tm_apply(p, x_tm, lengths, forget_bias: float = 1.0) -> torch.Tensor:
    """Time-major BLSTM layer: x [T, B, D] -> [T, B, 2H] in x's dtype."""
    T, B, D = x_tm.shape
    wx, b, wh = stack_directions(p)
    H4 = wx.shape[2]
    xw = blstm_proj(x_tm.reshape(T * B, D).contiguous(), wx, b)
    lengths = lengths.to(device=x_tm.device, dtype=torch.int32).contiguous()
    return blstm_recur(xw.view(2, T, B, H4), lengths, wh, forget_bias)
