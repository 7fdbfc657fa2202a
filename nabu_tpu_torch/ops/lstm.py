"""Unidirectional masked LSTM, forward and backward: CUDA kernel wrappers
and their plain PyTorch versions.

Port of the JAX package's ``ops/pallas/lstm.py`` (``lstm_scan_pallas`` ->
``lstm_seq_pallas``: ``_fwd`` -> ``_fwd_kernel`` and ``_bwd`` ->
``_bwd_kernel``), as the kernels of ``csrc/lstm.cu`` and two launches of
``csrc/blstm.cu``'s GEMM:

- ``lstm_proj``: ``xw = cast(cast(x @ wx) + b)`` (f32 accumulation, the
  bias added in the compute type, as ``x @ wx + b`` in that type) through
  the GEMM with one operand pair. It lies outside the Pallas kernel in
  JAX; the port runs it through its own fixed-order GEMM on the
  inference paths because each row's bits must not depend on the number
  of rows: a stream projects chunks, the offline pass whole utterances,
  and the two must agree bit for bit. The head's ``precompute`` takes it
  for the same reason;
- ``lstm_fwd``: the masked walk in f32 (gates, c and the carried h),
  reading xw and wh in their own type (bf16 or f32; the conversion is
  exact, so it computes ``lstm_scan_pallas``'s upcast function), writing
  the masked h in xw's type. It takes an optional initial carry (h0, c0)
  and returns the final one, both f32. ``lstm_fwd_train`` is the same
  walk storing the backward's residuals: f32 pre-activation gates, carry
  c and carried h (the TPU stores the post-step (h, c) and recomputes the
  gates in its backward). Its blocks own 16 mt rows x units
  (``walk_plan``) and meet only their row group each step; the carried h
  goes through an f32 exchange of its own. The step product is the f32
  function in both types: on the FMA pipes in f32, on tensor cores in bf16
  (h split exactly into three bf16 pieces, each product exact), summed in
  an order set by H alone, so a row's bits depend neither on B, T nor a
  chunk's start;
- ``lstm_bwd_recur``: the backward's serial chain (``_bwd_kernel``'s
  per-step arithmetic), dh and dc carried in f32, dxw written in f32; its
  blocks own 16-row groups x 8 units (``chain_plan``) and meet only their
  row group each step;
- ``lstm_bwd_dwh``: ``h_prev^T @ dxw`` in f32 (accumulated inside
  ``_bwd_kernel`` on the TPU), one launch of the f32 GEMM over all
  (T - 1) B rows, whose split plan (``ops.blstm.split_k_f32``) cuts K
  into slices added in a fixed order.

``LSTMLayer`` is the ``torch.autograd.Function`` over the walk and the
chain; the projection's gradients (dx, dwx, db) come from autograd
through ``x @ wx + b``, which lies outside the kernel in JAX too.
``lstm_tm_apply`` / ``lstm_scan_kernel`` mirror ``lstm_scan_pallas``
(forward direction), with ``init_carry`` / ``return_carry`` as
``core.lstm_scan`` has them.

Each wrapper launches its kernel for CUDA tensors and takes its plain
version only for CPU tensors. A shape beyond a kernel's design (the walk's
and the chain's blocks on the card's SMs, see ``check_design``) raises
before any launch.
"""

from __future__ import annotations

import ctypes

import torch

from nabu_tpu_torch.ops import kernels
from nabu_tpu_torch.ops.blstm import (
    _PROJ,
    _TN,
    PROBE_PARTS,
    SMEM_LIMIT,
    SMS,
    UNITS_PER_BLOCK,
    _aligned,
    _check_cuda,
    _check_shape,
    _first_form,
    _gemm,
    _stream,
)
from nabu_tpu_torch.ops.kernels import build

_fns: dict = {}
_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {
    "fwd": [_P] * 13 + [_I] * 5 + [ctypes.c_float, _P],
    "bwd_recur": [_P] * 7 + [_I] * 4 + [ctypes.c_float, _P],
}


def _launcher(kind: str, tag: str):
    name = f"lstm_{kind}_{tag}"
    if name not in _fns:
        fn = getattr(build.load("lstm"), f"nabu_{name}")
        fn.argtypes = _ARGTYPES[kind]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return _fns[name]


CHAIN_ROWS = 16  # rows of an m-tile; a walk or chain block owns 16 mt rows
CHAIN_MAX_MT = 2  # one cell pair a thread: 16 mt x 8 units <= 256 threads


def chain_bytes(H: int, mt: int) -> int:
    """Shared memory of a chain block: wh rows of its 8 units [8, 4H] f32
    and the 8 warps' reduced partial sums [8, 32 mt] (csrc/lstm.cu)."""
    return 4 * (UNITS_PER_BLOCK * 4 * H + 8 * 32 * mt)


def chain_plan(B: int, H: int):
    """-> (mt, blocks, shared memory bytes) of the chain: the fewest
    m-tiles of 16 rows a block (1 or 2) whose ceil(B / 16 mt) row groups
    x ceil(H / 8) unit groups fit the card one block an SM (its registers
    allow no more) with their shared memory (``ops.blstm._first_form``,
    one direction); None if none does."""
    forms = tuple((UNITS_PER_BLOCK, mt) for mt in range(1, CHAIN_MAX_MT + 1))
    plan = _first_form(B, H, forms, lambda units, mt: chain_bytes(H, mt), dirs=1)
    return None if plan is None else plan[1:]


# the walk (csrc/lstm.cu): a block owns 16 mt rows x units, and each of its
# threads runs one cell pair, two in 16 x 2 (512 pairs on 256 threads):
# min(256, 16 mt units) threads. In f32 a half warp sums 4 rows x 4 units'
# 4 gates over one of 16 K slices, its lanes the tile's 16 pairs; in bf16
# 4 K groups a warp, and (256 threads) two halves of the n-tiles. The forms
# (units, mt) in the order walk_plan tries them, the fastest first at B =
# 32, H = 320: 8 x 1 and 8 x 2 hold every shape the chain's plan holds, 16
# x 2 the largest inference batches (B <= 192 at H = 320)
WALK_FORMS = ((8, 1), (16, 1), (8, 2), (16, 2))


def walk_bytes(H: int, units: int, mt: int) -> int:
    """Shared memory of a walk block, the larger of the two element types'
    (``walk_bytes`` of csrc/lstm.cu): in f32 the four gate columns of wh
    of its units, [4 units, ceil4(H) + 4] f32; in bf16 the same columns as
    mma B fragments, ceil(H / 16) k16 steps x units / 2 n-tiles x 32 lanes
    x 8 bytes, and the 4 K groups' partial sums [4, 16 mt, 4 units + 8]
    f32."""
    f32 = 16 * units * (-(-H // 4) * 4 + 4)
    bf16 = -(-H // 16) * (units // 2) * 32 * 8 + 4 * 4 * 16 * mt * (4 * units + 8)
    return max(f32, bf16)


def walk_plan(B: int, H: int, forms=WALK_FORMS):
    """-> (units, mt, blocks, shared memory bytes) of the walk: the first
    of ``forms`` whose ceil(B / 16 mt) row groups x ceil(H / units) unit
    groups fit the card one block an SM (its registers allow no more)
    with their shared memory (``ops.blstm._first_form``, one direction);
    None if none does. A pure function of (B, H), the same in both
    element types, for the inference and the training walk."""
    return _first_form(B, H, forms, lambda units, mt: walk_bytes(H, units, mt), dirs=1)


def smem_bytes(B: int, H: int):
    """-> (forward walk, backward chain) shared memory of one block, each
    of its plan (``walk_plan``, ``chain_plan``; None where no plan holds B
    and H)."""
    return tuple(None if plan is None else plan[-1]
                 for plan in (walk_plan(B, H), chain_plan(B, H)))


def check_design(what: str, B: int, H: int, chain: bool):
    """-> the walk's ``walk_plan``; raises for a batch and width the
    kernels cannot hold: no walk form (16 mt rows x units a block) whose
    row groups x unit groups are co-resident one an SM, and (chain) no
    ``chain_plan``."""
    plan = walk_plan(B, H)
    if plan is None:
        raise ValueError(
            f"{what}: B = {B}, H = {H} is beyond the kernel's design (no walk form of 16 mt "
            f"rows x units, {WALK_FORMS}, fits the card's {SMS} SMs one block an SM)")
    if chain and chain_plan(B, H) is None:
        raise ValueError(
            f"{what}: B = {B}, H = {H} is beyond the kernel's design (no split of "
            f"16 mt rows x {UNITS_PER_BLOCK} units, mt <= {CHAIN_MAX_MT}, fits the card's "
            f"{SMS} SMs one block an SM)")
    return plan


# ---------------------------------------------------------------------------
# projection
# ---------------------------------------------------------------------------

def lstm_proj_plain(x, w, b) -> torch.Tensor:
    """x [M, D], w [D, N], b [N] -> cast(x @ w) + b in x's dtype (f32
    accumulation)."""
    acc = torch.matmul(x.to(torch.float32), w.to(torch.float32))
    return acc.to(x.dtype) + b


def lstm_proj(x, w, b) -> torch.Tensor:
    if x.device.type == "cpu":
        return lstm_proj_plain(x, w, b)
    tag = _check_cuda("lstm_proj", x, x=x, w=w, b=b)
    M, D = x.shape
    if w.dim() != 2 or w.shape[0] != D:
        raise ValueError(f"lstm_proj: w {tuple(w.shape)} is not [{D}, N]")
    N = w.shape[1]
    _check_shape("lstm_proj: b", b, (N,), x.dtype)
    if w.dtype != x.dtype:
        raise TypeError("lstm_proj: x and w must share one dtype")
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    x = _aligned(x)
    _gemm("lstm_proj", tag, (x.data_ptr(), x.data_ptr()), (w.data_ptr(), w.data_ptr()),
          D, N, M, N, D, _PROJ, bias=b, out=out, dirs=1)
    return out


# ---------------------------------------------------------------------------
# forward walk
# ---------------------------------------------------------------------------

def lstm_walk_plain(xw, lengths, wh, h0=None, c0=None, forget_bias: float = 1.0):
    """xw [T, B, 4H], lengths [B], wh [H, 4H], optional f32 carry (h0, c0)
    [B, H] -> (masked h [T, B, H] in xw's dtype, the final (h, c) f32,
    the backward's residuals (f32 pre-activation gates [T, B, 4H], carry c
    [T, B, H], carried h [T, B, H])): ``_fwd_kernel`` in f32."""
    T, B, H4 = xw.shape
    H = H4 // 4
    dev = xw.device
    f32 = torch.float32
    whf = wh.to(f32)
    h = torch.zeros((B, H), dtype=f32, device=dev) if h0 is None else h0.to(f32)
    c = torch.zeros((B, H), dtype=f32, device=dev) if c0 is None else c0.to(f32)
    mask = (torch.arange(T, device=dev)[:, None] < lengths.to(dev)[None, :])[..., None]
    y = torch.zeros((T, B, H), dtype=xw.dtype, device=dev)
    gs = torch.zeros((T, B, H4), dtype=f32, device=dev)
    cs = torch.zeros((T, B, H), dtype=f32, device=dev)
    hs = torch.zeros((T, B, H), dtype=f32, device=dev)
    for t in range(T):
        z = xw[t].to(f32) + h @ whf
        gi = torch.sigmoid(z[:, :H])
        gf = torch.sigmoid(z[:, H: 2 * H] + forget_bias)
        gg = torch.tanh(z[:, 2 * H: 3 * H])
        go = torch.sigmoid(z[:, 3 * H:])
        c_new = gf * c + gi * gg
        h_new = go * torch.tanh(c_new)
        m = mask[t]
        h = torch.where(m, h_new, h)
        c = torch.where(m, c_new, c)
        y[t] = torch.where(m, h_new, 0.0).to(xw.dtype)
        gs[t], cs[t], hs[t] = z, c, h
    return y, (h, c), (gs, cs, hs)


def _launch_fwd(name, xw, lengths, wh, h0, c0, forget_bias, store: bool, probe: bool = False):
    tag = _check_cuda(name, xw, xw=xw, wh=wh, lengths=lengths)
    if xw.dim() != 3:
        raise ValueError(f"{name}: xw {tuple(xw.shape)} is not [T, B, 4H]")
    T, B, H4 = xw.shape
    H = H4 // 4
    if H4 != 4 * H:
        raise ValueError(f"{name}: xw's last axis {H4} is not 4H")
    _check_shape(f"{name}: wh", wh, (H, H4), xw.dtype)
    _check_shape(f"{name}: lengths", lengths, (B,), torch.int32)
    for what, t in (("h0", h0), ("c0", c0)):
        if t is not None:
            _check_shape(f"{name}: {what}", t, (B, H), torch.float32)
            if t.device != xw.device or not t.is_contiguous():
                raise ValueError(f"{name}: {what} must be contiguous on {xw.device}")
    units, mt, blocks, _ = check_design(name, B, H, chain=store)
    dev = xw.device
    f32 = torch.float32
    # the exchange of the carried h, [slot, B, ceil4(H)] (rows of whole
    # 16-byte loads): slot 0 holds h0, the padding columns stay zero
    hx = torch.zeros((2, B, -(-H // 4) * 4), dtype=f32, device=dev)
    if h0 is not None:
        hx[0, :, :H].copy_(h0)
    if T == 0:  # nothing to walk: the carry passes through
        h_last = hx[0, :, :H].clone()
        c_last = torch.zeros((B, H), dtype=f32, device=dev) if c0 is None else c0.clone()
    else:
        h_last = torch.empty((B, H), dtype=f32, device=dev)
        c_last = torch.empty((B, H), dtype=f32, device=dev)
    y = torch.empty((T, B, H), dtype=xw.dtype, device=dev)
    # one counter a row group
    counters = torch.zeros((-(-B // (CHAIN_ROWS * mt)),), dtype=torch.int32, device=dev)
    res = (None, None, None)
    if store:
        res = (torch.empty((T, B, H4), dtype=f32, device=dev),
               torch.empty((T, B, H), dtype=f32, device=dev),
               torch.empty((T, B, H), dtype=f32, device=dev))
    cycles = torch.zeros((blocks, 4), dtype=torch.int64, device=dev) if probe else None
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(dev):
        err = _launcher("fwd", tag)(
            xw.data_ptr(), lengths.data_ptr(), wh.data_ptr(), ptr(c0), y.data_ptr(),
            hx.data_ptr(), h_last.data_ptr(), c_last.data_ptr(), counters.data_ptr(),
            ptr(res[0]), ptr(res[1]), ptr(res[2]), ptr(cycles),
            T, B, H, units, mt, float(forget_bias), _stream(),
        )
    build.check(err, name)
    if probe:
        return y, res, cycles
    kernels.LAUNCHES[name] += 1
    return y, (h_last, c_last), res


def lstm_fwd_plain(xw, lengths, wh, h0=None, c0=None, forget_bias: float = 1.0):
    """The walk without residuals: (masked h [T, B, H], final (h, c))."""
    return lstm_walk_plain(xw, lengths, wh, h0, c0, forget_bias)[:2]


def lstm_fwd(xw, lengths, wh, h0=None, c0=None, forget_bias: float = 1.0):
    if xw.device.type == "cpu":
        return lstm_fwd_plain(xw, lengths, wh, h0, c0, forget_bias)
    return _launch_fwd("lstm_fwd", xw, lengths, wh, h0, c0, forget_bias, store=False)[:2]


def lstm_fwd_train_plain(xw, lengths, wh, forget_bias: float = 1.0):
    """The walk from a zero carry with the backward's residuals: (masked h,
    gates, c, carried h) as ``lstm_walk_plain`` gives them."""
    y, _, res = lstm_walk_plain(xw, lengths, wh, forget_bias=forget_bias)
    return (y, *res)


def lstm_fwd_train(xw, lengths, wh, forget_bias: float = 1.0):
    if xw.device.type == "cpu":
        return lstm_fwd_train_plain(xw, lengths, wh, forget_bias)
    y, _, res = _launch_fwd("lstm_fwd_train", xw, lengths, wh, None, None, forget_bias,
                            store=True)
    return (y, *res)


def lstm_fwd_train_probe(xw, lengths, wh, forget_bias: float = 1.0):
    """The training walk on the card built with its step probe, for
    measurement only (no path calls it, and it counts no launch): -> (y,
    gates, c, h, cycles [blocks, 4] int64), each block's clock64 cycles
    of all T steps summed by ``PROBE_PARTS``: waiting at its row group's
    counter, pulling h_{t-1} (to its first use), the product (to the
    gates' sums), the cell and its stores (to the next step). The probe
    adds two block barriers a step."""
    y, res, cycles = _launch_fwd("lstm_fwd_train_probe", xw, lengths, wh, None, None,
                                 forget_bias, store=True, probe=True)
    return (y, *res, cycles)


# ---------------------------------------------------------------------------
# backward
# ---------------------------------------------------------------------------

def lstm_bwd_recur_plain(gates, c, gy, lengths, wh, forget_bias: float = 1.0):
    """The backward's serial chain (``_bwd_kernel``, lstm.py:106-147)
    from the forward's residuals: gates [T, B, 4H] and c [T, B, H] f32, gy
    [T, B, H] the output cotangent, wh [H, 4H] -> dxw [T, B, 4H] f32,
    walking time descending with dh and dc carried in f32."""
    T, B, H4 = gates.shape
    H = H4 // 4
    dev = gates.device
    f32 = torch.float32
    whf = wh.to(f32)
    mask = (torch.arange(T, device=dev)[:, None]
            < lengths.to(dev)[None, :]).to(f32)[..., None]
    dxw = torch.zeros((T, B, H4), dtype=f32, device=dev)
    zeros = torch.zeros((B, H), dtype=f32, device=dev)
    dh, dc = zeros, zeros
    for t in range(T - 1, -1, -1):
        c_prev = c[t - 1] if t > 0 else zeros
        m = mask[t]
        keep = m > 0.5
        z = gates[t]
        gi = torch.sigmoid(z[:, :H])
        gf = torch.sigmoid(z[:, H: 2 * H] + forget_bias)
        gg = torch.tanh(z[:, 2 * H: 3 * H])
        go = torch.sigmoid(z[:, 3 * H:])
        tanh_c = torch.tanh(c[t])
        dh_total = gy[t].to(f32) * m + dh
        dh_new = torch.where(keep, dh_total, 0.0)
        dc_new = torch.where(keep, dc, 0.0) + dh_new * go * (1.0 - tanh_c * tanh_c)
        dgates = torch.cat([dc_new * gg * gi * (1.0 - gi),
                            dc_new * c_prev * gf * (1.0 - gf),
                            dc_new * gi * (1.0 - gg * gg),
                            dh_new * tanh_c * go * (1.0 - go)], dim=-1)
        dxw[t] = dgates
        dh = dgates @ whf.t() + torch.where(keep, 0.0, dh_total)
        dc = dc_new * gf + torch.where(keep, 0.0, dc)
    return dxw


def lstm_bwd_recur(gates, c, gy, lengths, wh, forget_bias: float = 1.0):
    if gates.device.type == "cpu":
        return lstm_bwd_recur_plain(gates, c, gy, lengths, wh, forget_bias)
    name = "lstm_bwd_recur"
    tag = _check_cuda(name, gy, gy=gy, gates=gates, c=c, wh=wh, lengths=lengths)
    T, B, H = gy.shape
    _check_shape(f"{name}: gates", gates, (T, B, 4 * H), torch.float32)
    _check_shape(f"{name}: c", c, (T, B, H), torch.float32)
    _check_shape(f"{name}: wh", wh, (H, 4 * H), gy.dtype)
    _check_shape(f"{name}: lengths", lengths, (B,), torch.int32)
    check_design(name, B, H, chain=True)
    mt = chain_plan(B, H)[0]
    dev = gy.device
    dxw = torch.empty((T, B, 4 * H), dtype=torch.float32, device=dev)
    # one counter a row group
    counters = torch.zeros((-(-B // CHAIN_ROWS),), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = _launcher("bwd_recur", tag)(
            gates.data_ptr(), c.data_ptr(), gy.data_ptr(), lengths.data_ptr(),
            wh.data_ptr(), dxw.data_ptr(), counters.data_ptr(),
            T, B, H, mt, float(forget_bias), _stream(),
        )
    build.check(err, name)
    kernels.LAUNCHES[name] += 1
    return dxw


def lstm_bwd_dwh_plain(hs, dxw) -> torch.Tensor:
    """hs [T, B, H] the carried h, dxw [T, B, 4H] -> dwh = h_prev^T @ dxw
    [H, 4H] f32, h_prev the carry one step back (zero at the first)."""
    T, B, H = hs.shape
    hprev = torch.zeros((T, B, H), dtype=torch.float32, device=hs.device)
    hprev[1:] = hs[:-1].to(torch.float32)
    return torch.matmul(hprev.reshape(T * B, H).t(), dxw.reshape(T * B, 4 * H).to(torch.float32))


def lstm_bwd_dwh(hs, dxw) -> torch.Tensor:
    if dxw.device.type == "cpu":
        return lstm_bwd_dwh_plain(hs, dxw)
    name = "lstm_bwd_dwh"
    _check_cuda(name, dxw, dxw=dxw, hs=hs)
    T, B, H4 = dxw.shape
    H = H4 // 4
    _check_shape(f"{name}: hs", hs, (T, B, H), torch.float32)
    _check_shape(f"{name}: dxw", dxw, (T, B, H4), torch.float32)
    if T <= 1:  # h_prev is zero throughout
        return torch.zeros((H, H4), dtype=torch.float32, device=dxw.device)
    # one launch over the (T - 1) B rows of h_prev^T @ dxw[1:]; the GEMM's
    # split plan cuts K
    out = torch.empty((H, H4), dtype=torch.float32, device=dxw.device)
    a, b = hs.data_ptr(), dxw.data_ptr() + B * H4 * 4
    _gemm(name, "f32", (a, a), (b, b), H, H4, H, H4, (T - 1) * B, _TN, outf=out, dirs=1)
    return out


# ---------------------------------------------------------------------------
# layer
# ---------------------------------------------------------------------------

class LSTMLayer(torch.autograd.Function):
    """The trainable walk (``lstm_seq_pallas``): xw [T, B, 4H] -> masked h
    [T, B, H] in xw's dtype, from a zero carry; gradients dxw in xw's
    dtype and dwh in wh's."""

    @staticmethod
    def forward(ctx, xw, lengths, wh, forget_bias):
        lengths = lengths.to(device=xw.device, dtype=torch.int32).contiguous()
        wh = wh.contiguous()
        y, gates, c, hs = lstm_fwd_train(xw.contiguous(), lengths, wh, forget_bias)
        ctx.save_for_backward(lengths, wh, gates, c, hs)
        ctx.forget_bias = forget_bias
        ctx.dtype = xw.dtype
        return y

    @staticmethod
    def backward(ctx, gy):
        lengths, wh, gates, c, hs = ctx.saved_tensors
        gy = gy.to(ctx.dtype).contiguous()
        dxw = lstm_bwd_recur(gates, c, gy, lengths, wh, ctx.forget_bias)
        dwh = lstm_bwd_dwh(hs, dxw)
        return dxw.to(ctx.dtype), None, dwh.to(wh.dtype), None


def _wants_grad(p, x) -> bool:
    return torch.is_grad_enabled() and (
        x.requires_grad or any(p[k].requires_grad for k in ("wx", "wh", "b")))


def lstm_tm_apply(p, x_tm, lengths, carry=None, forget_bias: float = 1.0):
    """Time-major forward-direction layer {wx, wh, b}: x [T, B, D] ->
    (masked h [T, B, H] in x's dtype, final f32 carry (h, c) or None).
    Through ``LSTMLayer`` (from a zero carry; no final carry) when a
    gradient is wanted, else the projection and walk kernels."""
    if "ln_x_g" in p:
        raise NotImplementedError("layer-norm LSTM: no kernel, not ported yet")
    T, B, D = x_tm.shape
    lengths = lengths.to(device=x_tm.device, dtype=torch.int32).contiguous()
    if _wants_grad(p, x_tm):
        if carry is not None:
            raise ValueError("an initial carry is not differentiated: training walks "
                             "start at zero")
        xw = x_tm @ p["wx"] + p["b"]
        return LSTMLayer.apply(xw, lengths, p["wh"], forget_bias), None
    xw = lstm_proj(x_tm.reshape(T * B, D).contiguous(), p["wx"], p["b"])
    h0, c0 = (None, None) if carry is None else carry
    return lstm_fwd(xw.view(T, B, -1), lengths, p["wh"].contiguous(), h0, c0, forget_bias)


def lstm_scan_kernel(p, x, lengths, init_carry=None, return_carry: bool = False,
                     forget_bias: float = 1.0):
    """Counterpart of ``lstm_scan_pallas`` (forward direction): x [B, T, D]
    -> [B, T, H] in x's dtype, with ``core.lstm_scan``'s ``init_carry`` /
    ``return_carry`` (an f32 carry (h, c) [B, H] each)."""
    y, carry = lstm_tm_apply(p, x.transpose(0, 1), lengths, init_carry, forget_bias)
    y = y.transpose(0, 1)
    if return_carry:
        if carry is None:
            raise ValueError("return_carry: no final carry on the gradient path")
        return y, carry
    return y
