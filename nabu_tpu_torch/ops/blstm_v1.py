"""Bidirectional LSTM layer, v1 kernel family: CUDA kernel wrappers and
their plain PyTorch versions.

Port of the JAX package's v1 kernels in ``ops/pallas/blstm.py``
(``blstm_apply_fused_v1`` -> ``blstm_seq_fused``), which its
``blstm_tm_apply`` takes for the shapes the v2 kernels cannot hold, as
the kernels of ``csrc/blstm_v1.cu``:

- ``blstm_v1_recur`` (``blstm_fused_forward`` -> ``_blstm_kernel``): the
  inference walk, masked h [T, B, 2H] only; its blocks own a row group x
  a unit group of one direction, 2 or 4 cells a thread, split by
  ``walk_plan``, and form a step's product on tensor cores in bf16, on
  the FMA pipes in f32;
- ``blstm_v1_recur_train`` (``_fused_fwd`` -> ``_fwd_train_kernel``): the
  same walk storing v1's residuals, the post-mask h carries in the
  compute type and c in f32, per step. The carries are stored as
  ``hs [2, T + 1, B, H]`` with a zero slot at each direction's start (fw
  slot 0, bw slot T): ``hs[0, :T]`` and ``hs[1, 1:]`` are then each
  direction's "hprev" (the carry a step reads), one contiguous matrix;
- ``blstm_v1_bwd`` (``_fused_bwd`` -> ``_bwd_train_kernel``) as three
  launches: ``blstm_v1_bwd_gates``, the gates recomputed as one batched
  product f32(xw) + hprev @ wh (``prep``); ``blstm_v1_bwd_recur``, the
  serial chain dgates @ wh^T (``direction()``: dh and dc carried in f32,
  dgates cast to the compute type before the product); and
  ``blstm_v1_bwd_dwh``, dwh = hprev^T @ dgates in f32 (``accum_dwh``).
  The recompute and dwh run on ``csrc/blstm.cu``'s GEMM (kinds 3 and 2).

The input projection and dx / dwx / db lie on XLA's side of JAX's v1;
here they are the v2 family's own launches (``ops.blstm.blstm_proj``,
``blstm_bwd_dx``, ``blstm_bwd_dwx``), so the projection has the same bits
in both families.

``BLSTMLayerV1`` is the ``torch.autograd.Function`` over them; its
gradients come back as ``_fused_bwd``'s do: dxw in the compute type, dwh
(and dwx, db) cast to the weights' dtype. Inference (no gradient
wanted) takes the residual-free walk of row 4.

Each wrapper launches its kernel for CUDA tensors and takes its plain
version only for CPU tensors. ``check_design`` raises before any launch
for a shape beyond the kernels' design (``csrc/blstm_v1.cu``'s note).
"""

from __future__ import annotations

import ctypes

import torch

from nabu_tpu_torch.ops import blstm as v2
from nabu_tpu_torch.ops import kernels
from nabu_tpu_torch.ops.blstm import PROBE_PARTS
from nabu_tpu_torch.ops.kernels import build

# csrc/blstm_v1.cu: threads a block, and the batches the forms are sized
# for (16 x 4 holds every B <= 128 at H <= 528)
THREADS = 256
MAX_BATCH = 128
# the chain: rows of an m-tile; by element type the units a block owns,
# the K chunk a warp pulls at once, the row stride of the warps' partial
# sums, the m-tiles a block at most; bf16's K chunks a warp at most (its A
# fragments), f32's staged row stride
CHAIN_ROWS = 16
CHAIN_WARPS = THREADS // 32
CHAIN_UNITS = {"bf16": 32, "f32": 8}
CHAIN_K_CHUNK = {"bf16": 32, "f32": 16}
CHAIN_PART_LD = {"bf16": 40, "f32": 8}
CHAIN_MAX_MT = {"bf16": 2, "f32": 8}
CHAIN_MAX_CHUNKS = 8
CHAIN_STAGE_LD = 20

_fns: dict = {}
_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {
    "walk": [_P] * 9 + [_I] * 5 + [ctypes.c_float, _P],
    "chain": [_P] * 7 + [_I] * 4 + [ctypes.c_float, _P],
}


def _launcher(kind: str, tag: str):
    name = f"blstm_v1_{kind}_{tag}"
    if name not in _fns:
        fn = getattr(build.load("blstm_v1"), f"nabu_{name}")
        fn.argtypes = _ARGTYPES[kind]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return _fns[name]


def chain_bytes(tag: str, mt: int, H: int) -> int:
    """Shared memory of one chain block of 16 mt rows (``chain_bytes`` of
    csrc/blstm_v1.cu): wh of its units (bf16 in the B fragments' order, 16
    bytes a (chunk, n-tile, lane); f32 [8][chain_wld]), f32's staged K
    chunks, the warps' partial sums."""
    chunks = -(-4 * H // CHAIN_K_CHUNK[tag])
    rows = CHAIN_ROWS * mt
    part = 4 * CHAIN_WARPS * rows * CHAIN_PART_LD[tag]
    if tag == "bf16":
        return chunks * 4 * 32 * 16 + part
    wld = -(-chunks * 16 // 32) * 32 + 4
    return 4 * (CHAIN_UNITS[tag] * wld + CHAIN_WARPS * rows * CHAIN_STAGE_LD) + part


def chain_plan(B: int, H: int, tag: str):
    """-> (mt, blocks, shared memory bytes) of the chain: the fewest
    m-tiles of 16 rows a block (1, 2, 4 or 8, at most CHAIN_MAX_MT) whose
    2 ceil(B / 16 mt) ceil(H / U) blocks fit the card one an SM (its
    registers allow no more) with their shared memory; None if none does,
    or (bf16) 4H is beyond the A fragments of CHAIN_MAX_CHUNKS K chunks a
    warp."""
    if tag == "bf16" and -(-4 * H // CHAIN_K_CHUNK[tag]) > CHAIN_WARPS * CHAIN_MAX_CHUNKS:
        return None
    for mt in (1, 2, 4, 8):
        if mt > CHAIN_MAX_MT[tag]:
            break
        blocks = 2 * -(-B // (CHAIN_ROWS * mt)) * -(-H // CHAIN_UNITS[tag])
        need = chain_bytes(tag, mt, H)
        if blocks <= v2.SMS and need <= v2.SMEM_LIMIT:
            return mt, blocks, need
    return None


# the walk (csrc/blstm_v1.cu (a)): a block owns 16 mt rows x units of one
# direction, 512 or 1024 cells, 2 or 4 a thread; in f32 a half warp sums 4
# rows x 4 units' 4 gates a tile over one of 16 K slices, in bf16 the 8
# warps split K. The forms (units, mt) in the order walk_plan tries them:
# 32 x 1 pulls the fewest rows a block (bf16's at B = 64, H = 512, where
# f32's wh of 32 units takes 256 KB), 16 x 4 holds every B <= 128 at H <=
# 528
WALK_FORMS = ((32, 1), (16, 2), (8, 4), (16, 4))


def walk_xp(H: int) -> int:
    """The exchange's row stride: H rounded up to whole 16-byte vectors of
    bf16."""
    return -(-H // 8) * 8


def walk_bytes(H: int, units: int, mt: int, tag: str) -> int:
    """Shared memory of a walk block in the element type ``tag``
    (``walk_bytes`` of csrc/blstm_v1.cu): in f32 the four gate columns of
    wh of its units, [4 units, ceil4(H)] f32; in bf16 the same columns as
    mma B fragments, ceil(H / 32) chunks x units / 2 n-tiles x 32 lanes x
    16 bytes, and the 8 warps' partial sums [8, 16 mt, 4 units + 8] f32."""
    if tag == "f32":
        return 16 * units * (-(-H // 4) * 4)
    return -(-H // 32) * (units // 2) * 32 * 16 + 4 * 8 * CHAIN_ROWS * mt * (4 * units + 8)


def walk_plan(B: int, H: int, tag: str, forms=WALK_FORMS):
    """-> (units, mt, blocks, shared memory bytes) of the walk in the
    element type ``tag``: the first of ``forms`` whose 2 ceil(B / 16 mt)
    row groups x ceil(H / units) unit groups fit the card one block an SM
    with their shared memory (``ops.blstm._first_form``); None if none
    does. A pure function of (B, H, tag), for the inference and the
    training walk: bf16 32 x 1 and f32 16 x 2 at B = 64, H = 512."""
    return v2._first_form(B, H, forms, lambda units, mt: walk_bytes(H, units, mt, tag))


def smem_bytes(B: int, H: int, tag: str):
    """-> (walk, chain) shared memory of one block, each of its plan
    (``walk_plan``, ``chain_plan``; None where no plan holds B and H)."""
    walk, chain = walk_plan(B, H, tag), chain_plan(B, H, tag)
    return None if walk is None else walk[3], None if chain is None else chain[2]


def check_design(what: str, B: int, H: int, tag: str):
    """-> the walk's ``walk_plan``; raises for a batch and width the v1
    kernels cannot hold in the element type ``tag``: B past
    ``MAX_BATCH``, no walk form whose blocks fit the card one an SM with
    their shared memory, and no ``chain_plan`` (which also bounds bf16 at
    H <= 512, the walk's A fragments of 2 K chunks a warp)."""
    if B > MAX_BATCH:
        raise ValueError(f"{what}: B = {B} is beyond the kernel's design (B <= {MAX_BATCH})")
    plan = walk_plan(B, H, tag)
    if plan is None:
        raise ValueError(
            f"{what}: B = {B}, H = {H} is beyond the walk's design in {tag} (no block of 16 "
            f"mt rows x units of one direction, {WALK_FORMS}, fits the card's {v2.SMS} SMs "
            f"one block an SM)")
    if chain_plan(B, H, tag) is None:
        raise ValueError(
            f"{what}: B = {B}, H = {H} is beyond the chain's design in {tag} (no split "
            f"of 16 mt rows x {CHAIN_UNITS[tag]} units fits the card one block an SM)")
    return plan


def _walk(name, xw, lengths, wh, forget_bias, store: bool, probe: bool = False):
    tag = v2._check_cuda(name, xw, xw=xw, wh=wh, lengths=lengths)
    if xw.dim() != 4 or xw.shape[0] != 2:
        raise ValueError(f"{name}: xw {tuple(xw.shape)} is not [2, T, B, 4H]")
    _, T, B, H4 = xw.shape
    H = H4 // 4
    v2._check_shape(f"{name}: wh", wh, (2, H, H4), xw.dtype)
    v2._check_shape(f"{name}: lengths", lengths, (B,), torch.int32)
    units, mt, blocks, _ = check_design(name, B, H, tag)
    dev = xw.device
    y = torch.empty((T, B, 2 * H), dtype=xw.dtype, device=dev)
    # the exchange of the carried h, [direction, slot, B, ceil8(H)] (rows
    # of whole 16-byte loads): the padding columns stay zero
    hx = torch.zeros((2, 2, B, walk_xp(H)), dtype=xw.dtype, device=dev)
    hs = c = cycles = None
    if store:
        hs = torch.empty((2, T + 1, B, H), dtype=xw.dtype, device=dev)
        c = torch.empty((2, T, B, H), dtype=torch.float32, device=dev)
    if probe:
        cycles = torch.zeros((blocks, len(PROBE_PARTS)), dtype=torch.int64, device=dev)
    # one counter a direction and row group
    counters = torch.zeros((2 * -(-B // (CHAIN_ROWS * mt)),), dtype=torch.int32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(dev):
        err = _launcher("walk", tag)(
            xw.data_ptr(), lengths.data_ptr(), wh.data_ptr(), y.data_ptr(), hx.data_ptr(),
            ptr(hs), ptr(c), counters.data_ptr(), ptr(cycles), T, B, H, units, mt,
            float(forget_bias), v2._stream(),
        )
    build.check(err, name)
    if probe:
        return y, hs, c, cycles
    kernels.LAUNCHES[name] += 1
    return y, hs, c


# ---------------------------------------------------------------------------
# the walk (rows 4 and 5)
# ---------------------------------------------------------------------------

def blstm_v1_recur_train_plain(xw, lengths, wh, forget_bias: float = 1.0):
    """xw [2, T, B, 4H] (fw, bw; natural time), lengths [B], wh [2, H,
    4H] -> (masked h [T, B, 2H] in xw's dtype, post-mask h carries hs [2,
    T + 1, B, H] in xw's dtype with the zero slots, post-mask c [2, T, B,
    H] f32): the masked cell of ``_cell`` (f32 gates and c, h in the
    compute type), the bw direction walking time descending."""
    _, T, B, H4 = xw.shape
    H = H4 // 4
    dt = xw.dtype
    dev = xw.device
    mask = (torch.arange(T, device=dev)[:, None] < lengths.to(dev)[None, :])[..., None]
    y = torch.zeros((T, B, 2 * H), dtype=dt, device=dev)
    hs = torch.zeros((2, T + 1, B, H), dtype=dt, device=dev)
    cs = torch.zeros((2, T, B, H), dtype=torch.float32, device=dev)
    for d in range(2):
        whf = wh[d].to(torch.float32)
        h = torch.zeros((B, H), dtype=dt, device=dev)
        c = torch.zeros((B, H), dtype=torch.float32, device=dev)
        for t in range(T) if d == 0 else range(T - 1, -1, -1):
            gates = xw[d, t].to(torch.float32) + h.to(torch.float32) @ whf
            go, c_new = v2._cell(gates, c, forget_bias, H)
            h_new = (go * torch.tanh(c_new)).to(dt)
            m = mask[t]
            h = torch.where(m, h_new, h)
            c = torch.where(m, c_new, c)
            y[t, :, d * H: (d + 1) * H] = h * m.to(dt)
            hs[d, t + 1 if d == 0 else t] = h
            cs[d, t] = c
    return y, hs, cs


def blstm_v1_recur_plain(xw, lengths, wh, forget_bias: float = 1.0) -> torch.Tensor:
    """The inference walk: masked h [T, B, 2H] of
    ``blstm_v1_recur_train_plain``."""
    return blstm_v1_recur_train_plain(xw, lengths, wh, forget_bias)[0]


def blstm_v1_recur(xw, lengths, wh, forget_bias: float = 1.0) -> torch.Tensor:
    if xw.device.type == "cpu":
        return blstm_v1_recur_plain(xw, lengths, wh, forget_bias)
    return _walk("blstm_v1_recur", xw, lengths, wh, forget_bias, store=False)[0]


def blstm_v1_recur_train(xw, lengths, wh, forget_bias: float = 1.0):
    if xw.device.type == "cpu":
        return blstm_v1_recur_train_plain(xw, lengths, wh, forget_bias)
    return _walk("blstm_v1_recur_train", xw, lengths, wh, forget_bias, store=True)


def blstm_v1_recur_train_probe(xw, lengths, wh, forget_bias: float = 1.0):
    """The training walk on the card built with its step probe, for
    measurement only (no path calls it, and it counts no launch): -> (y,
    hs, c, cycles [blocks, 4] int64), each block's clock64 cycles of the
    steps after the first summed by ``PROBE_PARTS``: waiting at its
    counter, pulling h_{t-1} (to its first use), the product (to the gates'
    sums), the cell and its stores (to the next step). The probe adds two
    block barriers a step."""
    return _walk("blstm_v1_recur_train_probe", xw, lengths, wh, forget_bias, store=True,
                 probe=True)


# ---------------------------------------------------------------------------
# the backward (row 6)
# ---------------------------------------------------------------------------

def _hprev(hs):
    """Each direction's carries entering its steps, [2, T, B, H] views."""
    return torch.stack([hs[0, :-1], hs[1, 1:]])


def blstm_v1_bwd_gates_plain(xw, hs, wh) -> torch.Tensor:
    """The gates recompute (``prep``): xw [2, T, B, 4H], hs [2, T + 1, B,
    H], wh [2, H, 4H] -> f32(xw) + hprev @ wh, [2, T, B, 4H] f32 (f32
    accumulation)."""
    _, T, B, H4 = xw.shape
    H = H4 // 4
    acc = torch.matmul(_hprev(hs).reshape(2, T * B, H).to(torch.float32),
                       wh.to(torch.float32))
    return xw.to(torch.float32) + acc.reshape(2, T, B, H4)


def blstm_v1_bwd_gates(xw, hs, wh) -> torch.Tensor:
    if xw.device.type == "cpu":
        return blstm_v1_bwd_gates_plain(xw, hs, wh)
    name = "blstm_v1_bwd_gates"
    tag = v2._check_cuda(name, xw, xw=xw, hs=hs, wh=wh)
    _, T, B, H4 = xw.shape
    H = H4 // 4
    v2._check_shape(f"{name}: hs", hs, (2, T + 1, B, H), xw.dtype)
    v2._check_shape(f"{name}: wh", wh, (2, H, H4), xw.dtype)
    gates = torch.empty((2, T, B, H4), dtype=torch.float32, device=xw.device)
    a = (hs[0].data_ptr(), hs[1].data_ptr() + B * H * hs.element_size())
    v2._gemm(name, tag, a, (wh[0].data_ptr(), wh[1].data_ptr()), H, H4, T * B, H4, H,
             v2._ADD, bias=xw, outf=gates)
    return gates


def blstm_v1_bwd_recur_plain(gates, c, gy, lengths, wh, forget_bias: float = 1.0):
    """The serial chain (``_bwd_train_kernel`` ``direction()``) on the
    recomputed gates and the stored carries: the same arithmetic as the
    v2 chain's, ``ops.blstm.blstm_bwd_recur_plain``."""
    return v2.blstm_bwd_recur_plain(gates, c, gy, lengths, wh, forget_bias)


def blstm_v1_bwd_recur(gates, c, gy, lengths, wh, forget_bias: float = 1.0):
    if gates.device.type == "cpu":
        return blstm_v1_bwd_recur_plain(gates, c, gy, lengths, wh, forget_bias)
    name = "blstm_v1_bwd_recur"
    tag = v2._check_cuda(name, gy, gy=gy, gates=gates, c=c, wh=wh, lengths=lengths)
    T, B, H2 = gy.shape
    H = H2 // 2
    v2._check_shape(f"{name}: gates", gates, (2, T, B, 4 * H), torch.float32)
    v2._check_shape(f"{name}: c", c, (2, T, B, H), torch.float32)
    v2._check_shape(f"{name}: wh", wh, (2, H, 4 * H), gy.dtype)
    v2._check_shape(f"{name}: lengths", lengths, (B,), torch.int32)
    check_design(name, B, H, tag)
    mt = chain_plan(B, H, tag)[0]
    dev = gy.device
    dg = torch.empty((2, T, B, 4 * H), dtype=gy.dtype, device=dev)
    # one counter a direction and row group
    counters = torch.zeros((2 * -(-B // CHAIN_ROWS),), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = _launcher("chain", tag)(
            gates.data_ptr(), c.data_ptr(), gy.data_ptr(), lengths.data_ptr(), wh.data_ptr(),
            dg.data_ptr(), counters.data_ptr(), T, B, H, mt, float(forget_bias), v2._stream(),
        )
    build.check(err, name)
    kernels.LAUNCHES[name] += 1
    return dg


def blstm_v1_bwd_dwh_plain(hs, dg) -> torch.Tensor:
    """dwh (``accum_dwh``): hs [2, T + 1, B, H], dg [2, T, B, 4H] ->
    hprev^T @ dg, [2, H, 4H] f32."""
    _, T, B, H4 = dg.shape
    H = H4 // 4
    return torch.matmul(_hprev(hs).reshape(2, T * B, H).to(torch.float32).transpose(1, 2),
                        dg.reshape(2, T * B, H4).to(torch.float32))


def blstm_v1_bwd_dwh(hs, dg) -> torch.Tensor:
    if dg.device.type == "cpu":
        return blstm_v1_bwd_dwh_plain(hs, dg)
    name = "blstm_v1_bwd_dwh"
    tag = v2._check_cuda(name, dg, dg=dg, hs=hs)
    _, T, B, H4 = dg.shape
    H = H4 // 4
    v2._check_shape(f"{name}: hs", hs, (2, T + 1, B, H), dg.dtype)
    dwh = torch.empty((2, H, H4), dtype=torch.float32, device=dg.device)
    a = (hs[0].data_ptr(), hs[1].data_ptr() + B * H * hs.element_size())
    v2._gemm(name, tag, a, (dg[0].data_ptr(), dg[1].data_ptr()), H, H4, H, H4, T * B,
             v2._TN, outf=dwh)
    return dwh


def blstm_v1_bwd_plain(xw, hs, c, gy, lengths, wh, forget_bias: float = 1.0):
    """Row 6 as a whole, written out: (dxw [2, T, B, 4H] in gy's dtype,
    dwh [2, H, 4H] f32)."""
    gates = blstm_v1_bwd_gates_plain(xw, hs, wh)
    dg = blstm_v1_bwd_recur_plain(gates, c, gy, lengths, wh, forget_bias)
    return dg, blstm_v1_bwd_dwh_plain(hs, dg)


def blstm_v1_bwd(xw, hs, c, gy, lengths, wh, forget_bias: float = 1.0):
    """Row 6 through its launches (the plain versions for CPU tensors):
    the gates recompute, the chain, dwh."""
    gates = blstm_v1_bwd_gates(xw, hs, wh)
    dg = blstm_v1_bwd_recur(gates, c, gy, lengths, wh, forget_bias)
    del gates
    return dg, blstm_v1_bwd_dwh(hs, dg)


# ---------------------------------------------------------------------------
# layer
# ---------------------------------------------------------------------------

class BLSTMLayerV1(torch.autograd.Function):
    """The trainable layer of the v1 family (``blstm_seq_fused`` with the
    projection): x [T, B, D] -> masked h [T, B, 2H] in x's dtype, keeping
    x, xw and the walk's carries for the backward."""

    @staticmethod
    def forward(ctx, x_tm, lengths, wx_fw, b_fw, wh_fw, wx_bw, b_bw, wh_bw, forget_bias):
        T, B, D = x_tm.shape
        wx = torch.stack([wx_fw, wx_bw]).contiguous()
        b = torch.stack([b_fw, b_bw]).contiguous()
        wh = torch.stack([wh_fw, wh_bw]).contiguous()
        x = x_tm.contiguous()
        lengths = lengths.to(device=x.device, dtype=torch.int32).contiguous()
        xw = v2.blstm_proj(x.view(T * B, D), wx, b).view(2, T, B, wx.shape[2])
        y, hs, c = blstm_v1_recur_train(xw, lengths, wh, forget_bias)
        ctx.save_for_backward(x, lengths, wx, wh, xw, hs, c)
        ctx.forget_bias = forget_bias
        ctx.b_dtype = b.dtype
        return y

    @staticmethod
    def backward(ctx, gy):
        x, lengths, wx, wh, xw, hs, c = ctx.saved_tensors
        gy = gy.to(xw.dtype).contiguous()
        dg, dwh = blstm_v1_bwd(xw, hs, c, gy, lengths, wh, ctx.forget_bias)
        dx = None
        if ctx.needs_input_grad[0]:
            dxd = v2.blstm_bwd_dx(dg, wx)
            dx = dxd[0] + dxd[1]
        dwx, db = v2.blstm_bwd_dwx(x, dg)
        dwx, dwh, db = dwx.to(wx.dtype), dwh.to(wh.dtype), db.to(ctx.b_dtype)
        return dx, None, dwx[0], db[0], dwh[0], dwx[1], db[1], dwh[1], None


def blstm_v1_tm_apply(p, x_tm, lengths, forget_bias: float = 1.0) -> torch.Tensor:
    """Time-major BLSTM layer on the v1 kernels: x [T, B, D] -> [T, B, 2H]
    in x's dtype. Through ``BLSTMLayerV1`` when a gradient is wanted, else
    the projection and the inference walk."""
    if v2._wants_grad(p, x_tm):
        return BLSTMLayerV1.apply(
            x_tm, lengths, p["fw"]["wx"], p["fw"]["b"], p["fw"]["wh"],
            p["bw"]["wx"], p["bw"]["b"], p["bw"]["wh"], forget_bias,
        )
    T, B, D = x_tm.shape
    wx, b, wh = v2.stack_directions(p)
    xw = v2.blstm_proj(x_tm.reshape(T * B, D).contiguous(), wx, b)
    lengths = lengths.to(device=x_tm.device, dtype=torch.int32).contiguous()
    return blstm_v1_recur(xw.view(2, T, B, wx.shape[2]), lengths, wh, forget_bias)
