"""Bidirectional LSTM layer, forward and backward: CUDA kernel wrappers and
their plain PyTorch versions.

Port of the JAX package's ``ops/pallas/blstm.py`` (``blstm_tm_apply`` ->
``blstm_tm_fused``: ``_tm_fwd`` -> ``_fwd_train_kernel2`` and ``_tm_bwd``
-> ``_bwd_train_kernel2``), as the kernels of ``csrc/blstm.cu``:

- ``blstm_proj``: ``xw_d = cast(cast(x @ wx_d) + b_d)`` for both
  directions, f32 accumulation, the bias added after the cast to the
  compute type (``_proj_block``);
- ``blstm_recur``: one persistent launch that walks the whole sequence
  for both directions with the masked cell of ``_cell`` (f32 gates and
  c, h in the compute type; the backward direction walks time
  descending) and writes masked h in natural time order into one
  ``[T, B, 2H]`` output (fw ++ bw); its blocks own a row group x a unit
  group of one direction, split by ``walk_plan``, and form a step's
  product on tensor cores in bf16, on the FMA pipes in f32.
  ``blstm_recur_train`` is the same walk writing the backward's residuals
  too: the f32 carry c and the f32 pre-activation gates, which stand in
  for the TPU backward's recompute ``hprev @ wh``;
- ``blstm_bwd_recur``: the backward's serial chain (``direction()`` of
  ``_bwd_train_kernel2``) for both directions: dgates in the compute
  type, dh and dc carried in f32; its blocks own a row group x a unit
  group of one direction, split by ``chain_plan``;
- ``blstm_bwd_dx``, ``blstm_bwd_dwx`` (with db) and ``blstm_bwd_dwh``:
  the backward's block-batched products (``finish``), f32 accumulation.

``BLSTMLayer`` is the ``torch.autograd.Function`` over them; its
gradients come back as the TPU kernel's do (``_tm_bwd``): dwx and dwh in
the weights' dtype, db and dx in the compute type. Inference (no
gradient wanted) keeps the residual-free ``blstm_recur``.

Each wrapper launches its kernel for CUDA tensors and takes its plain
version only for CPU tensors.

Kernel family. ``blstm_tm_apply`` first asks ``kernel_family(B, H)``,
a pure function of the batch and the width, in training and in inference
alike (as the JAX package's ``blstm_tm_apply`` decides by shape), so one
layer never mixes families. It answers "v2" when the v2 training pair
can hold the layer: a ``walk_plan`` for the walk and a ``chain_plan`` for
the chain, each a split of the batch and the units into blocks of 16 mt
rows x units of one direction, all co-resident one an SM on the H100's
132 SMs, with their units' wh in shared memory. Else "v1", the kernels of
``ops.blstm_v1`` (``csrc/blstm_v1.cu``), whose walk blocks hold 2 or 4
cells a thread and whose chain blocks 32 units (bf16). The v2 limit is
the card's SMs: at H = 320 the v2 pair holds B <= 48, at H = 256 B <=
64, at H = 512 B <= 32 (the walk holds every shape the chain holds). So
the 4x320 and 3x256 recipes at B = 32 run v2, and las_large's 512-unit
Listener at B = 64 runs v1 (at its validation batch, 32, v2). The rule
is the same on the CPU, where each family runs its plain versions. It is
decided before any launch and is not a fallback: a launch that fails
raises.

GEMM kernel. The products (``blstm_proj``, dx, dwx, dwh, the v1 gates
recompute and dwh, ``ops.lstm.lstm_proj``) run on ``blstm.cu``'s GEMM.
In bf16, ``gemm_variant`` picks its kernel from the operand layouts alone,
before the launch: "wgmma" (TMA loads, ``wgmma``) when every operand base
is 16-byte aligned and both leading dimensions are multiples of 8
elements, which TMA needs; else "wmma", the earlier tiled kernel. It never
reads M, so a row's kernel, and its bits, do not depend on how many rows a
call has; ``blstm_proj`` and ``lstm_proj`` copy an input that starts off
such a base. The recipes' shapes (D in {80, 120, 640, 1280, 2048}, H in
{320, 512}, B in {32, 64}) all take "wgmma"; ``kernels.VARIANT_LAUNCHES``
counts the launches of each. The weight gradients (dwx, dwh, v1 dwh) cut
K into ``split_k`` slices of whole K tiles when their output tiles fill
the card poorly; the slices' f32 sums are added in a fixed order, so a
result repeats bit for bit. The other products never split. In f32 every
launch takes one kernel, the register-blocked FFMA GEMM (no TF32), which
reads every layout (16-byte copies where it can, 4-byte ones elsewhere),
and its weight gradients split by ``split_k_f32``, the same rule over its
own 16-deep K tiles.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from nabu_tpu_torch.ops import kernels
from nabu_tpu_torch.ops.kernels import build

_DTYPES = {torch.bfloat16: "bf16", torch.float32: "f32"}
_fns: dict = {}

# hidden units owned by one block of the LSTM walk and chain (``ops.lstm``)
UNITS_PER_BLOCK = 8

# GEMM layouts of csrc/blstm.cu: projection, A @ B^T, A^T @ B, and the v1
# gates recompute (f32 A @ B plus an addend)
_PROJ, _NT, _TN, _ADD = 0, 1, 2, 3

# the H100's SMs, shared memory a block may have and an SM holds (1 KB of
# it reserved a block), and the blocks of 256 threads an SM holds
SMS = 132
SMEM_LIMIT = 232448
SMEM_PER_SM = 233472
BLOCKS_PER_SM = 8

_P = ctypes.c_void_p
_I = ctypes.c_int
# the GEMM entries with K slices and their workspaces (bf16 wgmma, f32)
_SPLIT_GEMM = [_P] * 4 + [_I] * 8 + [_P] * 7
_ARGTYPES = {
    "gemm_bf16": [_P] * 4 + [_I] * 7 + [_P] * 5,
    "gemm_f32": _SPLIT_GEMM,
    "gemm_wgmma_bf16": _SPLIT_GEMM,
    "recur": [_P] * 9 + [_I] * 5 + [ctypes.c_float, _P],
    "bwd_recur": [_P] * 7 + [_I] * 5 + [ctypes.c_float, _P],
}


def coresident(smem: int, blocks: int) -> bool:
    """Whether ``blocks`` blocks of 256 threads and ``smem`` bytes of shared
    memory fit the card at once (a cooperative launch)."""
    if smem > SMEM_LIMIT:
        return False
    return blocks <= SMS * min(BLOCKS_PER_SM, SMEM_PER_SM // (smem + 1024))


# the chain (csrc/blstm.cu (c)): rows of an m-tile, and its forms (units,
# m-tiles) a block in the order chain_plan tries them, least work first (a
# thread sums 4 mt rows x units, at most 64; a block's 16 mt x units cell
# pairs, at most its 256 threads): 4 x 4 holds the batches of the
# narrowest layers (B <= 4224 at H <= 4)
CHAIN_ROWS = 16
CHAIN_FORMS = ((8, 1), (16, 1), (8, 2), (4, 4))


def chain_bytes(H: int, units: int, mt: int) -> int:
    """Shared memory of a chain block (``chain_bytes`` of csrc/blstm.cu):
    the wh rows of its units [units, 4H] f32 and the 8 warps' partial
    sums [8, 4 units mt]."""
    return 4 * (units * 4 * H + 8 * 4 * units * mt)


def _first_form(B: int, H: int, forms, smem, dirs: int = 2):
    """-> (units, mt, blocks, shared memory bytes) of the first of
    ``forms`` (units x 16 mt rows a block, ``smem(units, mt)`` bytes) whose
    dirs ceil(B / 16 mt) ceil(H / units) blocks fit the card one an SM
    (the serial kernels' registers allow no more) with their shared
    memory; None if none does."""
    for units, mt in forms:
        blocks = dirs * -(-B // (CHAIN_ROWS * mt)) * -(-H // units)
        need = smem(units, mt)
        if blocks <= SMS and need <= SMEM_LIMIT:
            return units, mt, blocks, need
    return None


def _check_plan(what: str, kernel: str, B: int, H: int, plan, forms):
    if plan is None:
        raise ValueError(
            f"{what}: B = {B}, H = {H} is beyond the {kernel}'s design (no block of 16 mt "
            f"rows x units of one direction, {forms}, fits the card's {SMS} SMs "
            f"one block an SM)")
    return plan


def chain_plan(B: int, H: int, forms=CHAIN_FORMS):
    """-> (units, mt, blocks, shared memory bytes) of the chain: the first
    of ``forms`` that fits (``_first_form``). A pure function of (B, H),
    the same in both element types."""
    return _first_form(B, H, forms, lambda units, mt: chain_bytes(H, units, mt))


def check_chain_design(what: str, B: int, H: int):
    """-> the chain's ``chain_plan``; raises for a batch and width beyond
    it."""
    return _check_plan(what, "chain", B, H, chain_plan(B, H), CHAIN_FORMS)


# the walk (csrc/blstm.cu (b)): a thread runs one cell pair and, in f32,
# sums 4 rows x 4 units' 4 gates over one of 16 K slices (a half warp), so a
# block's 16 mt rows x units fill its 256 threads only at units x mt = 16:
# the chain's forms but 8 x 1, in its order
WALK_FORMS = tuple(f for f in CHAIN_FORMS if f[0] * f[1] == 16)


def walk_bytes(H: int, units: int, mt: int) -> int:
    """Shared memory of a walk block, the larger of the two element types'
    (``walk_bytes`` of csrc/blstm.cu): in f32 the four gate columns of wh
    of its units, [4 units, ceil4(H)] f32; in bf16 the same columns as
    mma B fragments, ceil(H / 32) chunks x units / 2 n-tiles x 32 lanes x
    16 bytes, and the 8 warps' partial sums [8, 16 mt, 4 units + 8] f32."""
    f32 = 16 * units * (-(-H // 4) * 4)
    bf16 = -(-H // 32) * (units // 2) * 32 * 16 + 4 * 8 * 16 * mt * (4 * units + 8)
    return max(f32, bf16)


def walk_plan(B: int, H: int, forms=WALK_FORMS):
    """-> (units, mt, blocks, shared memory bytes) of the walk: the first
    of ``forms`` that fits (``_first_form``). A pure function of (B,
    H), the same in both element types. It holds every (B, H)
    ``chain_plan`` holds: at the same units its blocks are as many, 8 x 2
    has no more blocks than 8 x 1, and its shared memory fits wherever the
    chain's does."""
    return _first_form(B, H, forms, lambda units, mt: walk_bytes(H, units, mt))


def check_walk_design(what: str, B: int, H: int):
    """-> the walk's ``walk_plan``; raises for a batch and width beyond
    it."""
    return _check_plan(what, "walk", B, H, walk_plan(B, H), WALK_FORMS)


def v2_smem_bytes(B: int, H: int):
    """-> (walk, chain) shared memory of one block of the v2 kernels, each
    of its plan (``walk_plan``, ``chain_plan``; None where no plan holds B
    and H)."""
    walk, chain = walk_plan(B, H), chain_plan(B, H)
    return tuple(None if plan is None else plan[3] for plan in (walk, chain))


def kernel_family(B: int, H: int) -> str:
    """"v2" when the v2 walk and chain can hold a layer of batch B and
    width H on the card, else "v1" (see the module docstring)."""
    return "v1" if None in v2_smem_bytes(B, H) else "v2"


# the wgmma GEMM: 128 x 128 output tiles, 64-deep K tiles; kind 2 runs
# two blocks resident an SM
GEMM_TILE = 128
GEMM_TILE_K = 64
GEMM_RESIDENT = 2 * SMS
MAX_SPLITS = 16
MIN_SLICE_TILES = 8
# split_k's cost model: one K tile of one block while the card is full (a
# 128 x 128 x 64 product at ~600 TFLOP/s over 264 blocks), and the rate at
# which the slices' f32 sums are written and read back
_TILE_STEP_MS = 0.93e-3
_SUM_BYTES_PER_MS = 2.5e9


def gemm_variant(lda: int, ldb: int, ptrs) -> str:
    """The bf16 GEMM kernel of a launch: "wgmma" when TMA can read every
    operand (each base in ``ptrs`` 16-byte aligned, lda and ldb multiples
    of 8 elements), else "wmma". A pure function of the operand layouts:
    it never reads M."""
    ok = lda % 8 == 0 and ldb % 8 == 0 and all(p % 16 == 0 for p in ptrs)
    return "wgmma" if ok else "wmma"


# the f32 GEMM (FFMA): 64 x 128 output tiles, 16-deep K tiles, two blocks
# resident an SM; split_k_f32's cost model: one K tile of one block while
# the card is full (1.69 us: a 64 x 128 x 16 product at ~40 TFLOP/s over
# 264 blocks; ``chip_smoke.py --sweep`` on an H100 reads 1.15-1.83 us at the
# plan's S of the recipes' kind-2 launches, 1.62-1.73 at lstm_bwd_dwh's and
# the v2 and v1 dwh, and the plan's S within 4% of the fastest S it times)
F32_TILE_M, F32_TILE_K = 64, 16
F32_MIN_SLICE_TILES = 16
_F32_TILE_STEP_MS = 1.69e-3
# (tile rows, tile columns, tile depth, resident blocks, ms a K tile)
_BF16_MODEL = (GEMM_TILE, GEMM_TILE, GEMM_TILE_K, GEMM_RESIDENT, _TILE_STEP_MS)
_F32_MODEL = (F32_TILE_M, GEMM_TILE, F32_TILE_K, 2 * SMS, _F32_TILE_STEP_MS)


def _split_cost(M, N, K, dirs, S, model=_BF16_MODEL) -> float:
    tile_m, tile_n, tile_k, resident, step_ms = model
    tiles = -(-M // tile_m) * -(-N // tile_n) * dirs
    waves = -(-tiles * S // resident)
    ms = waves * -(-K // (tile_k * S)) * step_ms
    if S > 1:
        ms += (2 * S + 1) * dirs * M * N * 4 / _SUM_BYTES_PER_MS
    return ms


def _best_split(kind, M, N, K, dirs, model, min_slice_tiles) -> int:
    if kind != _TN:
        return 1
    ktiles = -(-K // model[2])
    best, best_ms = 1, _split_cost(M, N, K, dirs, 1, model)
    for S in range(2, MAX_SPLITS + 1):
        if ktiles // S < min_slice_tiles:
            break
        ms = _split_cost(M, N, K, dirs, S, model)
        if ms < 0.97 * best_ms:
            best, best_ms = S, ms
    return best


@functools.lru_cache(maxsize=1024)
def split_k(kind: int, M: int, N: int, K: int, dirs: int) -> int:
    """The K slices of a wgmma launch: 1 for kinds 0, 1 and 3, whose rows
    must keep their bits whatever M; for kind 2 (the weight gradients: few
    output tiles, K = T x B) the S of at most ``MAX_SPLITS``, each slice at
    least ``MIN_SLICE_TILES`` K tiles, that minimizes the modelled time
    (waves of resident blocks times K tiles a slice, plus writing and
    reading back the slices' sums), a smaller S unless a larger one saves
    3%. A pure function of (kind, M, N, K, dirs)."""
    return _best_split(kind, M, N, K, dirs, _BF16_MODEL, MIN_SLICE_TILES)


@functools.lru_cache(maxsize=1024)
def split_k_f32(kind: int, M: int, N: int, K: int, dirs: int) -> int:
    """``split_k`` for the f32 GEMM: the same rule over its 64 x 128
    output tiles and 16-deep K tiles, each slice at least
    ``F32_MIN_SLICE_TILES`` of them, with its own time a K tile. A pure
    function of (kind, M, N, K, dirs)."""
    return _best_split(kind, M, N, K, dirs, _F32_MODEL, F32_MIN_SLICE_TILES)


def split_bounds(K: int, S: int, tile_k: int = GEMM_TILE_K):
    """-> the [k0, k1) of each of S slices, in order: slice s takes K
    tiles [s n / S, (s + 1) n / S) of the n = ceil(K / tile_k) (64 for the
    bf16 kernel, ``F32_TILE_K`` for the f32 one), as the kernels do."""
    n = -(-K // tile_k)
    return [((s * n // S) * tile_k, min(K, ((s + 1) * n // S) * tile_k)) for s in range(S)]


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t, or a copy on a fresh (aligned) base when t starts off a 16-byte
    boundary, so a projection's kernel never depends on where a view of
    its input starts."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launcher(kind: str, tag: str):
    name = f"blstm_{kind}_{tag}"
    if name not in _fns:
        fn = getattr(build.load("blstm"), f"nabu_{name}")
        fn.argtypes = _ARGTYPES.get(f"{kind}_{tag}") or _ARGTYPES[kind]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return _fns[name]


def _stream():
    return torch.cuda.current_stream().cuda_stream


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


def _check_shape(what: str, t: torch.Tensor, shape, dtype=None) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: shape {tuple(t.shape)}, want {tuple(shape)}")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{what}: dtype {t.dtype}, want {dtype}")


def _gemm(name, tag, a, b, lda, ldb, M, N, K, kind, bias=None, out=None, outf=None,
          colsum=None, dirs=2) -> None:
    """One launch of the GEMM of csrc/blstm.cu over ``dirs`` (1 or 2)
    operand pairs; ``a`` and ``b`` are (fw, bw) pointer pairs. bf16 takes
    the kernel ``gemm_variant`` names, with ``split_k``'s slices; f32 takes
    the FFMA kernel (every layout) with ``split_k_f32``'s. The wrapper
    allocates the slices' workspaces."""
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    dev = out.device if out is not None else outf.device
    variant = gemm_variant(lda, ldb, a + b) if tag == "bf16" else None
    with torch.cuda.device(dev):
        if variant == "wmma":
            err = _launcher("gemm", tag)(
                a[0], a[1], b[0], b[1], lda, ldb, M, N, K, kind, dirs,
                ptr(bias), ptr(out), ptr(outf), ptr(colsum), _stream(),
            )
        else:
            f32 = torch.float32
            S = (split_k if variant else split_k_f32)(kind, M, N, K, dirs)
            ws = torch.empty((S, dirs, M, N), dtype=f32, device=dev) if S > 1 else None
            cws = None if colsum is None else torch.empty((S, dirs, N), dtype=f32, device=dev)
            err = _launcher("gemm_wgmma" if variant else "gemm", tag)(
                a[0], a[1], b[0], b[1], lda, ldb, M, N, K, kind, dirs, S,
                ptr(bias), ptr(out), ptr(outf), ptr(colsum), ptr(cws), ptr(ws), _stream(),
            )
    build.check(err, name)
    kernels.LAUNCHES[name] += 1
    if variant is not None:
        kernels.VARIANT_LAUNCHES[f"gemm_bf16_{variant}"] += 1


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
    x = _aligned(x)
    _gemm("blstm_proj", tag, (x.data_ptr(), x.data_ptr()),
          (wx[0].data_ptr(), wx[1].data_ptr()), D, N, M, N, D, _PROJ, bias=b, out=out)
    return out


# ---------------------------------------------------------------------------
# recurrence (forward)
# ---------------------------------------------------------------------------

def _cell(gates, c, forget_bias, H):
    """The masked LSTM cell's activations from f32 pre-activation gates."""
    gi = torch.sigmoid(gates[:, :H])
    gf = torch.sigmoid(gates[:, H: 2 * H] + forget_bias)
    gg = torch.tanh(gates[:, 2 * H: 3 * H])
    go = torch.sigmoid(gates[:, 3 * H:])
    c_new = gf * c + gi * gg
    return go, c_new


def blstm_recur_train_plain(xw, lengths, wh, forget_bias: float = 1.0):
    """xw [2, T, B, 4H] (fw, bw), lengths [B], wh [2, H, 4H] -> (masked
    h [T, B, 2H] in xw's dtype, f32 carries c [2, T, B, H], f32
    pre-activation gates [2, T, B, 4H] without the forget bias): the
    masked lstm_scan pair with the cell of the TPU kernel (f32 gates and
    c, h in the compute type)."""
    _, T, B, H4 = xw.shape
    H = H4 // 4
    dt = xw.dtype
    dev = xw.device
    mask = (
        torch.arange(T, device=dev)[:, None] < lengths.to(dev)[None, :]
    )[..., None]  # [T, B, 1]
    y = torch.zeros((T, B, 2 * H), dtype=dt, device=dev)
    cs = torch.zeros((2, T, B, H), dtype=torch.float32, device=dev)
    gs = torch.zeros((2, T, B, H4), dtype=torch.float32, device=dev)
    for d in range(2):
        whf = wh[d].to(torch.float32)
        h = torch.zeros((B, H), dtype=dt, device=dev)
        c = torch.zeros((B, H), dtype=torch.float32, device=dev)
        steps = range(T) if d == 0 else range(T - 1, -1, -1)
        for t in steps:
            gates = xw[d, t].to(torch.float32) + h.to(torch.float32) @ whf
            go, c_new = _cell(gates, c, forget_bias, H)
            h_new = (go * torch.tanh(c_new)).to(dt)
            m = mask[t]
            h = torch.where(m, h_new, h)
            c = torch.where(m, c_new, c)
            y[t, :, d * H: (d + 1) * H] = h * m.to(dt)
            cs[d, t] = c
            gs[d, t] = gates
    return y, cs, gs


def blstm_recur_plain(xw, lengths, wh, forget_bias: float = 1.0) -> torch.Tensor:
    """The inference forward: masked h [T, B, 2H] of
    ``blstm_recur_train_plain``."""
    return blstm_recur_train_plain(xw, lengths, wh, forget_bias)[0]


def _launch_recur(name, xw, lengths, wh, forget_bias, store: bool, probe: bool = False):
    tag = _check_cuda(name, xw, xw=xw, wh=wh, lengths=lengths)
    if xw.dim() != 4 or xw.shape[0] != 2:
        raise ValueError(f"{name}: xw {tuple(xw.shape)} is not [2, T, B, 4H]")
    _, T, B, H4 = xw.shape
    H = H4 // 4
    if H4 != 4 * H or tuple(wh.shape) != (2, H, H4):
        raise ValueError(f"{name}: wh {tuple(wh.shape)} is not [2, {H}, {H4}]")
    if wh.dtype != xw.dtype:
        raise TypeError(f"{name}: xw and wh must share one dtype")
    if lengths.dtype != torch.int32 or tuple(lengths.shape) != (B,):
        raise TypeError(f"{name}: lengths must be int32 [B]")
    units, mt, blocks = check_walk_design(name, B, H)[:3]
    dev = xw.device
    y = torch.empty((T, B, 2 * H), dtype=xw.dtype, device=dev)
    # the exchange of the carried h, [direction, slot, B, ceil8(H)] (rows
    # of whole 16-byte loads): the padding columns stay zero
    hx = torch.zeros((2, 2, B, -(-H // 8) * 8), dtype=xw.dtype, device=dev)
    # one counter a direction and row group
    counters = torch.zeros((2 * -(-B // (CHAIN_ROWS * mt)),), dtype=torch.int32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    c = g = cycles = None
    if store:
        c = torch.empty((2, T, B, H), dtype=torch.float32, device=dev)
        g = torch.empty((2, T, B, H4), dtype=torch.float32, device=dev)
    if probe:
        cycles = torch.zeros((blocks, 4), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        err = _launcher("recur", tag)(
            xw.data_ptr(), lengths.data_ptr(), wh.data_ptr(), y.data_ptr(),
            hx.data_ptr(), counters.data_ptr(), ptr(c), ptr(g), ptr(cycles),
            T, B, H, units, mt, float(forget_bias), _stream(),
        )
    build.check(err, name)
    if probe:
        return y, c, g, cycles
    kernels.LAUNCHES[name] += 1
    return y, c, g


def blstm_recur(xw, lengths, wh, forget_bias: float = 1.0) -> torch.Tensor:
    if xw.device.type == "cpu":
        return blstm_recur_plain(xw, lengths, wh, forget_bias)
    return _launch_recur("blstm_recur", xw, lengths, wh, forget_bias, store=False)[0]


def blstm_recur_train(xw, lengths, wh, forget_bias: float = 1.0):
    if xw.device.type == "cpu":
        return blstm_recur_train_plain(xw, lengths, wh, forget_bias)
    return _launch_recur("blstm_recur_train", xw, lengths, wh, forget_bias, store=True)


# the step probe's parts, in the order of its cycle sums
PROBE_PARTS = ("wait", "pull", "product", "cell")


def blstm_recur_train_probe(xw, lengths, wh, forget_bias: float = 1.0):
    """The training walk on the card built with its step probe, for
    measurement only (no path calls it, and it counts no launch): ->
    (y, c, gates, cycles [blocks, 4] int64), each block's clock64 cycles
    of the steps after the first summed by ``PROBE_PARTS``: waiting at its
    counter, pulling h_{t-1} (to its first use), the product (to the gates'
    sums), the cell and its stores (to the next step). The probe adds two
    block barriers a step."""
    return _launch_recur("blstm_recur_train_probe", xw, lengths, wh, forget_bias,
                         store=True, probe=True)


# ---------------------------------------------------------------------------
# backward chain
# ---------------------------------------------------------------------------

def blstm_bwd_recur_plain(gates, c, gy, lengths, wh, forget_bias: float = 1.0):
    """The backward's serial chain, written out (``_bwd_train_kernel2``
    ``direction()``). gates [2, T, B, 4H] and c [2, T, B, H] f32 from
    the forward, gy [T, B, 2H] the output cotangent, wh [2, H, 4H] ->
    dgates [2, T, B, 4H] in gy's dtype. The fw direction walks time
    descending, the bw one ascending; dh and dc are carried in f32 and
    the dgates cast to the compute type before the chain product."""
    _, T, B, H4 = gates.shape
    H = H4 // 4
    cdt = gy.dtype
    dev = gates.device
    mask = (
        torch.arange(T, device=dev)[:, None] < lengths.to(dev)[None, :]
    ).to(torch.float32)[..., None]  # [T, B, 1]
    dg = torch.zeros((2, T, B, H4), dtype=cdt, device=dev)
    zeros = torch.zeros((B, H), dtype=torch.float32, device=dev)
    for d in range(2):
        whc = wh[d]
        dh = zeros
        dc = zeros
        steps = range(T - 1, -1, -1) if d == 0 else range(T)
        for t in steps:
            t_prev = t - 1 if d == 0 else t + 1  # the forward's previous step
            c_prev = c[d, t_prev] if 0 <= t_prev < T else zeros
            m = mask[t]
            keep = m > 0.5
            z = gates[d, t]
            gi = torch.sigmoid(z[:, :H])
            gf = torch.sigmoid(z[:, H: 2 * H] + forget_bias)
            gg = torch.tanh(z[:, 2 * H: 3 * H])
            go = torch.sigmoid(z[:, 3 * H:])
            tanh_c = torch.tanh(c[d, t])
            dh_total = gy[t, :, d * H: (d + 1) * H].to(torch.float32) * m + dh
            dh_new = torch.where(keep, dh_total, 0.0)
            dc_new = torch.where(keep, dc, 0.0) + dh_new * go * (1.0 - tanh_c * tanh_c)
            dgi = dc_new * gg * gi * (1.0 - gi)
            dgf = dc_new * c_prev * gf * (1.0 - gf)
            dgg = dc_new * gi * (1.0 - gg * gg)
            dgo = dh_new * tanh_c * go * (1.0 - go)
            dgates_c = torch.cat([dgi, dgf, dgg, dgo], dim=-1).to(cdt)
            dg[d, t] = dgates_c
            dh_prev = torch.matmul(dgates_c.to(torch.float32), whc.to(torch.float32).t())
            dh = dh_prev + torch.where(keep, 0.0, dh_total)
            dc = dc_new * gf + torch.where(keep, 0.0, dc)
    return dg


def blstm_bwd_recur(gates, c, gy, lengths, wh, forget_bias: float = 1.0):
    if gates.device.type == "cpu":
        return blstm_bwd_recur_plain(gates, c, gy, lengths, wh, forget_bias)
    name = "blstm_bwd_recur"
    tag = _check_cuda(name, gy, gy=gy, gates=gates, c=c, wh=wh, lengths=lengths)
    T, B, H2 = gy.shape
    H = H2 // 2
    _check_shape(f"{name}: gates", gates, (2, T, B, 4 * H), torch.float32)
    _check_shape(f"{name}: c", c, (2, T, B, H), torch.float32)
    _check_shape(f"{name}: wh", wh, (2, H, 4 * H), gy.dtype)
    _check_shape(f"{name}: lengths", lengths, (B,), torch.int32)
    units, mt = check_chain_design(name, B, H)[:2]
    dev = gy.device
    dg = torch.empty((2, T, B, 4 * H), dtype=gy.dtype, device=dev)
    # one counter a direction and row group
    counters = torch.zeros((2 * -(-B // (CHAIN_ROWS * mt)),), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = _launcher("bwd_recur", tag)(
            gates.data_ptr(), c.data_ptr(), gy.data_ptr(), lengths.data_ptr(),
            wh.data_ptr(), dg.data_ptr(), counters.data_ptr(),
            T, B, H, units, mt, float(forget_bias), _stream(),
        )
    build.check(err, name)
    kernels.LAUNCHES[name] += 1
    return dg


# ---------------------------------------------------------------------------
# backward products
# ---------------------------------------------------------------------------

def blstm_bwd_dx_plain(dg, wx) -> torch.Tensor:
    """dg [2, T, B, 4H], wx [2, D, 4H] -> dx_d = cast(dg_d @ wx_d^T),
    [2, T, B, D] in dg's dtype (f32 accumulation)."""
    _, T, B, H4 = dg.shape
    acc = torch.matmul(dg.reshape(2, T * B, H4).to(torch.float32),
                       wx.to(torch.float32).transpose(1, 2))
    return acc.to(dg.dtype).reshape(2, T, B, -1)


def blstm_bwd_dx(dg, wx) -> torch.Tensor:
    if dg.device.type == "cpu":
        return blstm_bwd_dx_plain(dg, wx)
    name = "blstm_bwd_dx"
    tag = _check_cuda(name, dg, dg=dg, wx=wx)
    _, T, B, H4 = dg.shape
    D = wx.shape[1]
    _check_shape(f"{name}: wx", wx, (2, D, H4), dg.dtype)
    out = torch.empty((2, T, B, D), dtype=dg.dtype, device=dg.device)
    _gemm(name, tag, (dg[0].data_ptr(), dg[1].data_ptr()),
          (wx[0].data_ptr(), wx[1].data_ptr()), H4, H4, T * B, D, H4, _NT, out=out)
    return out


def blstm_bwd_dwx_plain(x, dg):
    """x [T, B, D], dg [2, T, B, 4H] -> (dwx_d = x^T @ dg_d [2, D, 4H],
    db_d = sum of dg_d over rows [2, 4H]), both f32."""
    _, T, B, H4 = dg.shape
    dgf = dg.reshape(2, T * B, H4).to(torch.float32)
    dwx = torch.matmul(x.reshape(T * B, -1).to(torch.float32).t(), dgf)
    return dwx, dgf.sum(dim=1)


def blstm_bwd_dwx(x, dg):
    if dg.device.type == "cpu":
        return blstm_bwd_dwx_plain(x, dg)
    name = "blstm_bwd_dwx"
    tag = _check_cuda(name, dg, dg=dg, x=x)
    _, T, B, H4 = dg.shape
    D = x.shape[2]
    _check_shape(f"{name}: x", x, (T, B, D), dg.dtype)
    dwx = torch.empty((2, D, H4), dtype=torch.float32, device=dg.device)
    db = torch.empty((2, H4), dtype=torch.float32, device=dg.device)
    _gemm(name, tag, (x.data_ptr(), x.data_ptr()), (dg[0].data_ptr(), dg[1].data_ptr()),
          D, H4, D, H4, T * B, _TN, outf=dwx, colsum=db)
    return dwx, db


def blstm_bwd_dwh_plain(y, dg) -> torch.Tensor:
    """y [T, B, 2H] (the layer output), dg [2, T, B, 4H] -> dwh_d =
    hprev_d^T @ dg_d [2, H, 4H] f32, hprev the stored masked h one step
    back along each direction's recurrence (zero at its first step)."""
    _, T, B, H4 = dg.shape
    H = H4 // 4
    hprev = torch.zeros((2, T, B, H), dtype=torch.float32, device=dg.device)
    hprev[0, 1:] = y[:-1, :, :H].to(torch.float32)
    hprev[1, :-1] = y[1:, :, H:].to(torch.float32)
    return torch.matmul(hprev.reshape(2, T * B, H).transpose(1, 2),
                        dg.reshape(2, T * B, H4).to(torch.float32))


def blstm_bwd_dwh(y, dg) -> torch.Tensor:
    if dg.device.type == "cpu":
        return blstm_bwd_dwh_plain(y, dg)
    name = "blstm_bwd_dwh"
    tag = _check_cuda(name, dg, dg=dg, y=y)
    _, T, B, H4 = dg.shape
    H = H4 // 4
    _check_shape(f"{name}: y", y, (T, B, 2 * H), dg.dtype)
    dwh = torch.empty((2, H, H4), dtype=torch.float32, device=dg.device)
    if T == 1:
        return dwh.zero_()
    es = y.element_size()
    # fw: hprev at t is y[t - 1, :, :H], paired with dg_fw[t] for t >= 1;
    # bw: hprev at t is y[t + 1, :, H:], paired with dg_bw[t] for t <= T-2
    a = (y.data_ptr(), y.data_ptr() + (B * 2 * H + H) * es)
    b = (dg[0].data_ptr() + B * H4 * dg.element_size(), dg[1].data_ptr())
    _gemm(name, tag, a, b, 2 * H, H4, H, H4, (T - 1) * B, _TN, outf=dwh)
    return dwh


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


class BLSTMLayer(torch.autograd.Function):
    """The trainable layer (``blstm_tm_fused``): x [T, B, D] -> masked
    h [T, B, 2H] in x's dtype, with the forward's residuals (x, the
    output, c and the gates) kept for the backward kernels."""

    @staticmethod
    def forward(ctx, x_tm, lengths, wx_fw, b_fw, wh_fw, wx_bw, b_bw, wh_bw,
                forget_bias):
        T, B, D = x_tm.shape
        wx = torch.stack([wx_fw, wx_bw]).contiguous()
        b = torch.stack([b_fw, b_bw]).contiguous()
        wh = torch.stack([wh_fw, wh_bw]).contiguous()
        x = x_tm.contiguous()
        lengths = lengths.to(device=x.device, dtype=torch.int32).contiguous()
        xw = blstm_proj(x.view(T * B, D), wx, b)
        y, c, gates = blstm_recur_train(
            xw.view(2, T, B, wx.shape[2]), lengths, wh, forget_bias)
        ctx.save_for_backward(x, lengths, wx, wh, y, c, gates)
        ctx.forget_bias = forget_bias
        ctx.b_dtype = b.dtype
        return y

    @staticmethod
    def backward(ctx, gy):
        x, lengths, wx, wh, y, c, gates = ctx.saved_tensors
        gy = gy.to(y.dtype).contiguous()
        dg = blstm_bwd_recur(gates, c, gy, lengths, wh, ctx.forget_bias)
        dx = None
        if ctx.needs_input_grad[0]:
            dxd = blstm_bwd_dx(dg, wx)
            dx = dxd[0] + dxd[1]
        dwx, db = blstm_bwd_dwx(x, dg)
        dwh = blstm_bwd_dwh(y, dg)
        dwx, dwh, db = dwx.to(wx.dtype), dwh.to(wh.dtype), db.to(ctx.b_dtype)
        return dx, None, dwx[0], db[0], dwh[0], dwx[1], db[1], dwh[1], None


def _wants_grad(p, x) -> bool:
    return torch.is_grad_enabled() and (
        x.requires_grad
        or any(p[d][k].requires_grad for d in ("fw", "bw") for k in ("wx", "b", "wh"))
    )


def blstm_tm_apply(p, x_tm, lengths, forget_bias: float = 1.0) -> torch.Tensor:
    """Time-major BLSTM layer: x [T, B, D] -> [T, B, 2H] in x's dtype, on
    the family ``kernel_family`` picks. On v2: through ``BLSTMLayer`` when
    a gradient is wanted, else the residual-free inference kernels."""
    if kernel_family(x_tm.shape[1], p["fw"]["wh"].shape[0]) == "v1":
        from nabu_tpu_torch.ops.blstm_v1 import blstm_v1_tm_apply

        return blstm_v1_tm_apply(p, x_tm, lengths, forget_bias)
    if _wants_grad(p, x_tm):
        return BLSTMLayer.apply(
            x_tm, lengths, p["fw"]["wx"], p["fw"]["b"], p["fw"]["wh"],
            p["bw"]["wx"], p["bw"]["b"], p["bw"]["wh"], forget_bias,
        )
    T, B, D = x_tm.shape
    wx, b, wh = stack_directions(p)
    H4 = wx.shape[2]
    xw = blstm_proj(x_tm.reshape(T * B, D).contiguous(), wx, b)
    lengths = lengths.to(device=x_tm.device, dtype=torch.int32).contiguous()
    return blstm_recur(xw.view(2, T, B, H4), lengths, wh, forget_bias)
