"""The pure Python parts that decide how ``csrc/blstm.cu``'s GEMMs run on
the card: the bf16 kernel a launch takes (``gemm_variant``) and the K
slices of the weight gradients (``split_k`` for bf16, ``split_k_f32`` for
the f32 FFMA kernel, ``split_bounds``).

The launches below are the ones the wrappers of ``ops.blstm``,
``ops.blstm_v1`` and ``ops.lstm`` make (leading dimensions and each
operand's start, in elements, from a 16-byte-aligned allocation), at the
widths of the four recipes' main paths: D in {80, 120, 640, 1280, 2048},
H in {320, 512}, B in {32, 64}. Each is parametrised over the sequence
length, so over M: the answer must not move with it. The split-K slices
are held to the plain products: the plain weight gradients summed slice by
slice in f32 agree with the whole at rtol 1e-5 (f32 sums of the same
products in another order; atol 1e-5 of the largest value for the entries
near zero).
"""

import numpy as np
import pytest
import torch

from nabu_tpu_torch.ops import blstm as bo
from nabu_tpu_torch.ops import blstm_v1 as v1

BASE = 1 << 20  # a 16-byte-aligned allocation's address


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _launches(T, B, D, H):
    """-> {launch: (lda, ldb, element offsets of a0, a1, b0, b1)} of one
    BLSTM layer's GEMM launches, as the wrappers compute them."""
    H4 = 4 * H
    M = T * B
    return {
        # blstm_proj: x [M, D] (one operand for both directions), wx [2, D, 4H]
        "blstm_proj": (D, H4, (0, 0, 0, D * H4)),
        # blstm_bwd_dx: dg [2, T, B, 4H], wx [2, D, 4H] read as [4H, D]^T
        "blstm_bwd_dx": (H4, H4, (0, M * H4, 0, D * H4)),
        # blstm_bwd_dwx: x [T, B, D] read as x^T, dg
        "blstm_bwd_dwx": (D, H4, (0, 0, 0, M * H4)),
        # blstm_bwd_dwh: h_prev from y [T, B, 2H] (the bw half H elements
        # into the row one step on), the fw dg one step on
        "blstm_bwd_dwh": (2 * H, H4, (0, B * 2 * H + H, B * H4, M * H4)),
        # v1 gates recompute and dwh: hs [2, T + 1, B, H] (the bw carries one
        # slot on), wh [2, H, 4H] / dg
        "blstm_v1_bwd_gates": (H, H4, (0, (T + 1) * B * H + B * H, 0, H * H4)),
        "blstm_v1_bwd_dwh": (H, H4, (0, (T + 1) * B * H + B * H, 0, M * H4)),
        # lstm_proj (dirs 1): x [rows, D] on an aligned base, w [D, 4H]
        "lstm_proj": (D, H4, (0, 0, 0, 0)),
    }


def _variant(lda, ldb, offsets):
    return bo.gemm_variant(lda, ldb, tuple(BASE + 2 * o for o in offsets))


@pytest.mark.parametrize("T", [1, 2, 7, 250, 1024, 1111])
@pytest.mark.parametrize("B,H", [(32, 320), (64, 512), (17, 320)])
@pytest.mark.parametrize("D", [80, 120, 640, 1280, 2048])
def test_recipe_layouts_take_the_wgmma_kernel(T, B, H, D):
    """Every launch of the recipes' widths takes the TMA + wgmma kernel,
    whatever the sequence length (M) or a short last batch."""
    for name, (lda, ldb, offsets) in _launches(T, B, D, H).items():
        assert _variant(lda, ldb, offsets) == "wgmma", (name, T, B, D, H)


@pytest.mark.parametrize("T", [1, 7, 37, 1024])
def test_unaligned_widths_take_the_wmma_kernel(T):
    """The card tests' H = 9 (4H = 36, not a multiple of 8) sends every
    launch to the WMMA kernel; H = 12 sends its dwh (the bw h_prev starts
    12 elements, 24 bytes, into a row) and the v1 launches (h_prev rows of
    12 elements), while its other launches at D = 16 keep wgmma. M never
    moves the answer."""
    for name, (lda, ldb, offsets) in _launches(T, 4, 11, 9).items():
        assert _variant(lda, ldb, offsets) == "wmma", name
    twelve = _launches(T, 4, 16, 12)
    for name, (lda, ldb, offsets) in twelve.items():
        want = "wmma" if name in ("blstm_bwd_dwh", "blstm_v1_bwd_gates",
                                  "blstm_v1_bwd_dwh") else "wgmma"
        assert _variant(lda, ldb, offsets) == want, name


def test_lstm_proj_aligns_a_view_that_starts_off_a_boundary():
    """A chunk's x that starts 2 bytes off a 16-byte boundary is copied to
    an aligned base, so its launch takes the same kernel as the offline
    pass's."""
    flat = torch.zeros(8 * 320 + 1, dtype=torch.bfloat16)
    x = flat[1:].view(8, 320)
    assert x.data_ptr() % 16 != 0
    y = bo._aligned(x)
    assert y.data_ptr() % 16 == 0 and torch.equal(x, y)
    aligned = flat[:-1].view(8, 320)
    assert bo._aligned(aligned).data_ptr() == aligned.data_ptr()


@pytest.mark.parametrize("K", [1, 63, 64, 65, 80, 2048, 4100, 32736, 65536])
@pytest.mark.parametrize("S", [1, 2, 3, 5, 13, 16])
def test_split_bounds_cover_k_in_whole_tiles(K, S):
    tiles = -(-K // bo.GEMM_TILE_K)
    if S > tiles:
        return
    bounds = bo.split_bounds(K, S)
    assert len(bounds) == S and bounds[0][0] == 0 and bounds[-1][1] == K
    for (a0, a1), (b0, _) in zip(bounds, bounds[1:]):
        assert a1 == b0 and a1 % bo.GEMM_TILE_K == 0
    assert all(k0 % bo.GEMM_TILE_K == 0 and k1 > k0 for k0, k1 in bounds)


@pytest.mark.parametrize("M", [1, 128, 1000, 32768, 65536, 1 << 20])
@pytest.mark.parametrize("kind", [0, 1, 3])
def test_only_kind_2_splits(kind, M):
    """Kinds 0, 1 and 3 never split, whatever M: each output's sum runs
    over K in one order."""
    for N, K in ((1280, 80), (1280, 1280), (2048, 512), (2048, 32768)):
        assert bo.split_k(kind, M, N, K, 2) == 1


@pytest.mark.parametrize("M,N,K,dirs,want", [
    (80, 1280, 32768, 2, 13),     # dwx, D = 80
    (640, 1280, 32768, 2, 5),     # dwx, D = 640
    (1280, 1280, 32768, 2, 5),    # dwx, D = 1280
    (320, 1280, 32736, 2, 4),     # dwh, H = 320
    (512, 2048, 65536, 2, 2),     # v1 dwh, bottom layer
    (2048, 2048, 32768, 2, 1),    # las_large pyramid_0 dwx: enough tiles
    (2048, 2048, 640, 2, 1),      # short K
])
def test_split_k_of_the_weight_gradients(M, N, K, dirs, want):
    """S is a pure function of (M, N, K, dirs): the recipes' weight
    gradients split where their output tiles fill the card poorly, each
    slice at least MIN_SLICE_TILES K tiles, at most MAX_SPLITS slices."""
    S = bo.split_k(2, M, N, K, dirs)
    assert S == want == bo.split_k(2, M, N, K, dirs)
    assert 1 <= S <= bo.MAX_SPLITS
    assert S == 1 or -(-K // bo.GEMM_TILE_K) // S >= bo.MIN_SLICE_TILES


def _u(rng, *shape):
    """Uniform +-1 inputs, rounded to bf16 and held in f32."""
    return torch.as_tensor(rng.uniform(-1, 1, shape).astype(np.float32)).to(
        torch.bfloat16).float()


def _close(got, ref):
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5 * float(ref.abs().max()))


def test_split_dwx_and_db_agree_with_the_whole():
    rng = np.random.default_rng(0)
    T, B, D, H = 64, 32, 80, 32
    K = T * B
    S = bo.split_k(2, D, 4 * H, K, 2)
    assert S > 1
    x, dg = _u(rng, T, B, D), _u(rng, 2, T, B, 4 * H)
    xr, dgr = x.reshape(1, K, D), dg.reshape(2, 1, K, 4 * H)
    dwx = db = 0.0
    for k0, k1 in bo.split_bounds(K, S):
        part_w, part_b = bo.blstm_bwd_dwx_plain(xr[:, k0:k1], dgr[:, :, k0:k1])
        dwx, db = dwx + part_w, db + part_b
    ref_w, ref_b = bo.blstm_bwd_dwx_plain(x, dg)
    _close(dwx, ref_w)
    _close(db, ref_b)


def test_split_dwh_agrees_with_the_whole():
    """dwh's K axis: the (T - 1) B tokens with an h_prev in each direction
    (fw: y[t - 1] with dg[t]; bw: y[t + 1] with dg[t])."""
    rng = np.random.default_rng(1)
    T, B, H = 65, 32, 32
    K = (T - 1) * B
    S = bo.split_k(2, H, 4 * H, K, 2)
    assert S > 1
    y, dg = _u(rng, T, B, 2 * H), _u(rng, 2, T, B, 4 * H)
    a = torch.stack([y[:-1, :, :H], y[1:, :, H:]]).reshape(2, K, H)
    b = torch.stack([dg[0, 1:], dg[1, :-1]]).reshape(2, K, 4 * H)
    dwh = sum(torch.matmul(a[:, k0:k1].transpose(1, 2), b[:, k0:k1])
              for k0, k1 in bo.split_bounds(K, S))
    _close(dwh, bo.blstm_bwd_dwh_plain(y, dg))


def test_split_v1_dwh_agrees_with_the_whole():
    rng = np.random.default_rng(2)
    T, B, H = 32, 64, 64
    K = T * B
    S = bo.split_k(2, H, 4 * H, K, 2)
    assert S > 1
    hs, dg = _u(rng, 2, T + 1, B, H), _u(rng, 2, T, B, 4 * H)
    a = v1._hprev(hs).reshape(2, K, H)
    b = dg.reshape(2, K, 4 * H)
    dwh = sum(torch.matmul(a[:, k0:k1].transpose(1, 2), b[:, k0:k1])
              for k0, k1 in bo.split_bounds(K, S))
    _close(dwh, v1.blstm_v1_bwd_dwh_plain(hs, dg))


# --- the f32 GEMM's split plan ------------------------------------------------

@pytest.mark.parametrize("M", [1, 128, 1000, 32768, 1 << 20])
@pytest.mark.parametrize("kind", [0, 1, 3])
def test_f32_plan_splits_only_kind_2(kind, M):
    """The f32 plan never splits kinds 0, 1 and 3, whatever M (lstm_proj's
    rows keep their bits chunk by chunk)."""
    for N, K, dirs in ((512, 40, 2), (1024, 1024, 2), (1280, 320, 1), (2048, 32768, 2)):
        assert bo.split_k_f32(kind, M, N, K, dirs) == 1


@pytest.mark.parametrize("K", [1, 15, 16, 17, 3840, 32736, 65536])
@pytest.mark.parametrize("S", [1, 2, 8, 13, 16])
def test_f32_split_bounds_cover_k_in_whole_tiles(K, S):
    tiles = -(-K // bo.F32_TILE_K)
    if S > tiles:
        return
    bounds = bo.split_bounds(K, S, bo.F32_TILE_K)
    assert len(bounds) == S and bounds[0][0] == 0 and bounds[-1][1] == K
    for (a0, a1), (b0, _) in zip(bounds, bounds[1:]):
        assert a1 == b0 and a1 % bo.F32_TILE_K == 0
    assert all(k0 % bo.F32_TILE_K == 0 and k1 > k0 for k0, k1 in bounds)


# (M, N, K, dirs) of the recipes' f32 kind-2 launches at B = 32 (v1: 64),
# T = 1024
_F32_KIND2 = [
    # lstm_bwd_dwh (dirs 1), the streaming encoder and the prediction net
    (320, 1280, 1023 * 32, 1),
    (320, 1280, 120 * 32, 1),
    # dwx + db at H = 320: the first layers (D = 40, 80), 2H, the pyramids
    (40, 1280, 32768, 2),
    (80, 1280, 32768, 2),
    (256, 1280, 32768, 2),
    (640, 1280, 32768, 2),
    (1024, 1280, 32768, 2),
    (1280, 1280, 32768, 2),
    (2048, 1280, 32768, 2),
    # dwh at H = 128 (ctc_blstm_timit), 256 (las_timit), 320, 512
    (128, 512, 1023 * 32, 2),
    (256, 1024, 1023 * 32, 2),
    (320, 1280, 1023 * 32, 2),
    (512, 2048, 1023 * 32, 2),
    # v1 dwh at B = 64
    (512, 2048, 1024 * 64, 2),
    (512, 2048, 512 * 64, 2),
]


@pytest.mark.parametrize("shape", _F32_KIND2)
def test_split_k_f32_of_the_recipes(shape):
    """S is a pure function of (M, N, K, dirs), at most MAX_SPLITS slices
    of at least F32_MIN_SLICE_TILES 16-deep K tiles each, and K is split
    wherever the output tiles fill at most half of one wave of resident
    blocks and K holds two such slices."""
    M, N, K, dirs = shape
    S = bo.split_k_f32(2, M, N, K, dirs)
    assert S == bo.split_k_f32(2, M, N, K, dirs)
    assert 1 <= S <= bo.MAX_SPLITS
    ktiles = -(-K // bo.F32_TILE_K)
    assert S == 1 or ktiles // S >= bo.F32_MIN_SLICE_TILES
    tiles = -(-M // bo.F32_TILE_M) * -(-N // bo.GEMM_TILE) * dirs
    # half a wave: the kernel keeps two blocks resident an SM
    if tiles <= bo.SMS and ktiles >= 2 * bo.F32_MIN_SLICE_TILES:
        assert S > 1


@pytest.mark.parametrize("T", [2, 9, 121])
def test_lstm_bwd_dwh_split_agrees_with_the_whole(T):
    """lstm_bwd_dwh's one launch over K = (T - 1) B rows (h_prev at t with
    dxw at t, t >= 1): the plain product summed slice by slice over the f32
    plan's slices equals the whole."""
    from nabu_tpu_torch.ops import lstm as lo

    rng = np.random.default_rng(3)
    B, H = 32, 16
    K = (T - 1) * B
    hs = torch.as_tensor(rng.uniform(-1, 1, (T, B, H)).astype(np.float32))
    dxw = torch.as_tensor(rng.uniform(-1, 1, (T, B, 4 * H)).astype(np.float32))
    S = max(2, min(bo.split_k_f32(2, H, 4 * H, K, 1), -(-K // bo.F32_TILE_K)))
    a, b = hs[:-1].reshape(K, H), dxw[1:].reshape(K, 4 * H)
    dwh = sum(torch.matmul(a[k0:k1].t(), b[k0:k1])
              for k0, k1 in bo.split_bounds(K, S, bo.F32_TILE_K))
    _close(dwh, lo.lstm_bwd_dwh_plain(hs, dxw))


def test_f32_split_dwx_and_db_agree_with_the_whole():
    """dwx and db summed over the f32 plan's slices of K = T B tokens (16-deep
    K tiles) agree with the whole."""
    rng = np.random.default_rng(4)
    T, B, D, H = 64, 32, 40, 32
    K = T * B
    S = bo.split_k_f32(2, D, 4 * H, K, 2)
    assert S > 1
    x, dg = _u(rng, T, B, D), _u(rng, 2, T, B, 4 * H)
    xr, dgr = x.reshape(1, K, D), dg.reshape(2, 1, K, 4 * H)
    dwx = db = 0.0
    for k0, k1 in bo.split_bounds(K, S, bo.F32_TILE_K):
        part_w, part_b = bo.blstm_bwd_dwx_plain(xr[:, k0:k1], dgr[:, :, k0:k1])
        dwx, db = dwx + part_w, db + part_b
    ref_w, ref_b = bo.blstm_bwd_dwx_plain(x, dg)
    _close(dwx, ref_w)
    _close(db, ref_b)
