"""The unidirectional LSTM module of the port (``ops/lstm.py``) against the
JAX package's Pallas LSTM kernel and its masked scan.

The same seeded numpy inputs go through ``lstm_scan_pallas`` (interpret
mode, ``block_t = 4``, so T = 11 leaves a partial block) or
``core.lstm_scan`` and through the port's plain versions, which are what
its kernel wrappers take for CPU tensors:

- the walk (``lstm_walk_plain`` and ``lstm_scan_kernel``) in f32, rtol 1e-4
  / atol 1e-5 (JAX's own tolerance for this kernel), ragged lengths with a
  length 0; bf16 inputs within one bf16 step of the output;
- ``init_carry`` / ``return_carry`` against ``core.lstm_scan``'s;
- ``LSTMLayer``'s gradients (dx, dwx, dwh, db) against ``jax.grad`` through
  ``lstm_scan_pallas``, rtol 1e-4;
- the chain's dxw and ``dwh`` against the custom VJP of ``lstm_seq_pallas``;
- the walk's and the chain's plans (forms of 16 mt rows x units a block
  on the card's SMs) and the limits they set.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nabu_tpu.models import core as jcore
from nabu_tpu.ops.pallas.lstm import lstm_scan_pallas, lstm_seq_pallas
from nabu_tpu_torch.models import core
from nabu_tpu_torch.ops import lstm as lo

torch.set_num_threads(1)  # Tier-1 runs several xdist workers

D, H = 5, 6


def _layer(seed, d=D, h=H, scale=0.4):
    rng = np.random.default_rng(seed)
    return {"wx": rng.uniform(-scale, scale, (d, 4 * h)).astype(np.float32),
            "wh": rng.uniform(-scale, scale, (h, 4 * h)).astype(np.float32),
            "b": rng.uniform(-0.3, 0.3, 4 * h).astype(np.float32)}


def _inputs(seed, T, lengths):
    rng = np.random.default_rng(seed + 100)
    x = rng.standard_normal((len(lengths), T, D)).astype(np.float32)
    return x, np.asarray(lengths, np.int32)


def _j(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def _t(p, dtype=torch.float32):
    return {k: torch.from_numpy(v).to(dtype) for k, v in p.items()}


def _close(got, want, rtol=1e-4, atol=1e-5, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=rtol, atol=atol, err_msg=what)


@pytest.mark.parametrize("T,lengths", [(11, [11, 7, 4, 0]), (8, [8, 8, 3, 1])])
def test_walk_matches_pallas_and_scan(T, lengths):
    p = _layer(0)
    x, L = _inputs(0, T, lengths)
    want = np.asarray(lstm_scan_pallas(_j(p), jnp.asarray(x), jnp.asarray(L), interpret=True,
                                       block_t=4))
    scan = np.asarray(jcore.lstm_scan(_j(p), jnp.asarray(x), jnp.asarray(L)))
    got = lo.lstm_scan_kernel(_t(p), torch.from_numpy(x), torch.from_numpy(L))
    _close(got.numpy(), want, what="lstm_scan_kernel vs pallas")
    _close(got.numpy(), scan, what="lstm_scan_kernel vs scan")
    # the walk alone, on the projection
    xw = torch.from_numpy(x).transpose(0, 1) @ _t(p)["wx"] + _t(p)["b"]
    y, (h, c), (gates, cs, hs) = lo.lstm_walk_plain(xw, torch.from_numpy(L), _t(p)["wh"])
    _close(y.transpose(0, 1).numpy(), want, what="lstm_walk_plain")
    for b, n in enumerate(L):  # the final carry is the carry at each lane's last frame
        if n:
            _close(h[b].numpy(), hs[n - 1, b].numpy(), 0, 0)
            _close(c[b].numpy(), cs[n - 1, b].numpy(), 0, 0)
        else:
            assert float(h[b].abs().max()) == float(c[b].abs().max()) == 0.0
        assert float(y[n:, b].abs().max() if n < T else 0.0) == 0.0  # padding outputs zeros
    assert gates.shape == (T, len(L), 4 * H)


def test_bf16_inputs():
    """bf16 x and weights: both sides walk in f32 on the bf16 projection and
    return bf16; outputs within one bf16 step (|h| < 1)."""
    p = _layer(1)
    x, L = _inputs(1, 11, [11, 6, 2])
    jp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in p.items()}
    want = lstm_scan_pallas(jp, jnp.asarray(x, jnp.bfloat16), jnp.asarray(L), interpret=True,
                            block_t=4)
    got = lo.lstm_scan_kernel(_t(p, torch.bfloat16), torch.from_numpy(x).to(torch.bfloat16),
                              torch.from_numpy(L))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    _close(got.float().numpy(), np.asarray(want, np.float32), rtol=0, atol=8e-3)


def test_carry_threading_matches_scan():
    """init_carry / return_carry: two chunks with the carry threaded equal
    core.lstm_scan's chunks and the port's own full walk."""
    p = _layer(2)
    x, L = _inputs(2, 11, [11, 7, 3])
    c1 = np.minimum(L, 5)
    c2 = np.clip(L - 5, 0, 6)
    jy1, jcarry = jcore.lstm_scan(_j(p), jnp.asarray(x[:, :5]), jnp.asarray(c1),
                                  return_carry=True)
    jy2, jlast = jcore.lstm_scan(_j(p), jnp.asarray(x[:, 5:]), jnp.asarray(c2),
                                 init_carry=jcarry, return_carry=True)
    tp = _t(p)
    y1, carry = lo.lstm_scan_kernel(tp, torch.from_numpy(x[:, :5]), torch.from_numpy(c1),
                                    return_carry=True)
    y2, last = lo.lstm_scan_kernel(tp, torch.from_numpy(x[:, 5:]), torch.from_numpy(c2),
                                   init_carry=carry, return_carry=True)
    for got, want in ((y1, jy1), (y2, jy2), (carry[0], jcarry[0]), (carry[1], jcarry[1]),
                      (last[0], jlast[0]), (last[1], jlast[1])):
        _close(got.numpy(), np.asarray(want))
    full = lo.lstm_scan_kernel(tp, torch.from_numpy(x), torch.from_numpy(L))
    assert torch.equal(torch.cat([y1, y2], 1), full)
    # the port's scan threads its carry the same way
    sy1, scarry = core.lstm_scan(tp, torch.from_numpy(x[:, :5]), torch.from_numpy(c1),
                                 return_carry=True)
    sy2 = core.lstm_scan(tp, torch.from_numpy(x[:, 5:]), torch.from_numpy(c2),
                         init_carry=scarry)
    _close(torch.cat([sy1, sy2], 1).numpy(), full.numpy())
    with pytest.raises(ValueError, match="forward direction"):
        core.lstm_scan(tp, torch.from_numpy(x), torch.from_numpy(L), reverse=True,
                       init_carry=scarry)


def test_layer_gradients_match_pallas():
    """dx, dwx, dwh, db of LSTMLayer (through x @ wx + b) against jax.grad
    through lstm_scan_pallas in interpret mode."""
    p = _layer(3)
    x, L = _inputs(3, 11, [11, 9, 4, 0])
    g = np.random.default_rng(33).standard_normal((4, 11, H)).astype(np.float32)

    def f(pp, xx):
        return (lstm_scan_pallas(pp, xx, jnp.asarray(L), interpret=True, block_t=4) * g).sum()

    jgp, jgx = jax.grad(f, argnums=(0, 1))(_j(p), jnp.asarray(x))
    leaves = {k: v.clone().requires_grad_(True) for k, v in _t(p).items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    y = lo.lstm_scan_kernel(leaves, xt, torch.from_numpy(L))
    (y * torch.from_numpy(g)).sum().backward()
    _close(xt.grad.numpy(), jgx, what="dx")
    for k in ("wx", "wh", "b"):
        _close(leaves[k].grad.numpy(), jgp[k], what=k)
    with pytest.raises(ValueError, match="not differentiated"):
        lo.lstm_scan_kernel(leaves, xt, torch.from_numpy(L),
                            init_carry=(torch.zeros(4, H), torch.zeros(4, H)))


def test_chain_and_dwh_match_the_custom_vjp():
    """The chain's dxw and dwh against lstm_seq_pallas's VJP (_bwd) on the
    same xw, mask, wh and output cotangent."""
    rng = np.random.default_rng(4)
    T, B = 11, 4
    L = np.asarray([11, 8, 2, 0], np.int32)
    xw = rng.uniform(-1.0, 1.0, (T, B, 4 * H)).astype(np.float32)
    wh = rng.uniform(-0.4, 0.4, (H, 4 * H)).astype(np.float32)
    g = rng.standard_normal((T, B, H)).astype(np.float32)
    mask = (np.arange(T)[:, None] < L[None, :]).astype(np.float32)
    y, vjp = jax.vjp(lambda a, w: lstm_seq_pallas(a, jnp.asarray(mask), w, 1.0, True, 4),
                     jnp.asarray(xw), jnp.asarray(wh))
    want_dxw, want_dwh = vjp(jnp.asarray(g))
    yt, gates, cs, hs = lo.lstm_fwd_train(torch.from_numpy(xw), torch.from_numpy(L),
                                          torch.from_numpy(wh))
    _close(yt.numpy(), np.asarray(y))
    dxw = lo.lstm_bwd_recur(gates, cs, torch.from_numpy(g), torch.from_numpy(L),
                            torch.from_numpy(wh))
    dwh = lo.lstm_bwd_dwh(hs, dxw)
    assert dxw.dtype == dwh.dtype == torch.float32
    _close(dxw.numpy(), want_dxw, what="dxw")
    _close(dwh.numpy(), want_dwh, what="dwh")
    assert float(dxw[:, 3].abs().max()) == 0.0  # a lane of length 0 has no gradient
    assert float(lo.lstm_bwd_dwh(hs[:1], dxw[:1]).abs().max()) == 0.0  # T = 1: no h_prev


def test_projection_is_the_compute_type_sum():
    """lstm_proj = cast(x @ w) + b in x's dtype, x @ w + b in f32."""
    p = _layer(5)
    x = torch.from_numpy(_inputs(5, 3, [3, 3])[0]).reshape(6, D)
    tp = _t(p)
    _close(lo.lstm_proj(x, tp["wx"], tp["b"]).numpy(), (x @ tp["wx"] + tp["b"]).numpy(), 1e-6)
    xb = x.to(torch.bfloat16)
    got = lo.lstm_proj(xb, tp["wx"].to(torch.bfloat16), tp["b"].to(torch.bfloat16))
    want = (xb.float() @ tp["wx"].to(torch.bfloat16).float()).to(torch.bfloat16) + tp["b"].to(
        torch.bfloat16)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


def test_design_limits():
    """The recipes' shapes fit the walk's and the chain's plans, their
    blocks co-resident on the card's SMs; a batch beyond either plan raises
    before any launch."""
    fwd, chain = lo.smem_bytes(32, 320)
    # the walk (8 units x 16 rows): wh's gate columns of 8 units [32, 320 + 4]
    # f32; the chain: wh rows of 8 units [8, 1280] f32 and 8 warps' partials
    # [8, 32]
    assert fwd == 4 * 32 * 324 and chain == 4 * (8 * 1280 + 8 * 32) and chain <= lo.SMEM_LIMIT
    lo.check_design("lstm_fwd_train", 32, 320, chain=True)
    lo.check_design("lstm_fwd", 64, 320, chain=False)  # inference holds B = 64 (16 x 1)
    lo.check_design("lstm_fwd", 144, 320, chain=False)  # and B = 144 (16 x 2, two pairs a thread)
    lo.check_design("lstm_fwd_train", 96, 320, chain=True)  # 6 groups of 16 rows x 20 of 16
    with pytest.raises(ValueError, match="beyond the kernel's design"):
        lo.check_design("lstm_bwd_recur", 97, 320, chain=True)
    with pytest.raises(ValueError, match="beyond the kernel's design"):
        lo.check_design("lstm_fwd", 33, 1024, chain=False)


@pytest.mark.parametrize("B, H, plan", [
    # the recipes' batch (the streaming encoder's layers and the prediction
    # net of both RNN-T recipes, 320 units): 2 row groups of 16 x 40 unit
    # groups of 8, 128 threads a block
    (32, 320, (8, 1, 80, 4 * 32 * 324)),
    (1, 320, (8, 1, 40, 4 * 32 * 324)),  # the streamed feed at batch 1
    (4, 320, (8, 1, 40, 4 * 32 * 324)),  # serve(streaming=True) on 4
    (48, 320, (8, 1, 120, 4 * 32 * 324)),
    (64, 320, (16, 1, 80, 4 * 64 * 324)),  # 4 groups of 8 units would be 160 blocks
    (96, 320, (16, 1, 120, 4 * 64 * 324)),
    (144, 320, (16, 2, 100, 4 * 64 * 324)),
    (192, 320, (16, 2, 120, 4 * 64 * 324)),
    (32, 1024, (8, 2, 128, 4 * 32 * 1028)),  # 16 x 2's 263 KB is over the limit
    # narrow layers: the bf16 layout's K groups' partial sums set the bytes
    (1, 9, (8, 1, 2, 256 * 4 + 4 * 4 * 16 * 40)),
    (4, 12, (8, 1, 2, 256 * 4 + 4 * 4 * 16 * 40)),
    (1100, 12, (16, 1, 69, 256 * 8 + 4 * 4 * 16 * 72)),
    (193, 320, None),
    (33, 1024, None),
])
def test_walk_plan(B, H, plan):
    assert lo.walk_plan(B, H) == plan


@pytest.mark.parametrize("units, mt", lo.WALK_FORMS)
def test_walk_forms_fill_a_block(units, mt):
    """A half warp sums a tile of 4 rows x 4 units and each of its lanes
    runs one cell pair of it: every form is whole tiles on whole warps,
    one or two pairs a thread, at most 256 threads."""
    pairs = 16 * mt * units
    threads = min(256, pairs)  # csrc/lstm.cu's WalkForm
    assert units % 4 == 0 and threads % 32 == 0 and threads <= 256
    assert pairs % threads == 0 and pairs // threads in (1, 2)
    assert lo.walk_bytes(320, units, mt) <= lo.SMEM_LIMIT


@pytest.mark.parametrize("H", [9, 12, 16, 24, 64, 320])
def test_walk_plan_holds_every_chain_shape(H):
    """Every batch up to 96 that the chain's plan holds at the widths the
    tests and recipes use, the walk's plan holds too: its blocks fit the
    card one an SM with their shared memory, and smem_bytes reports it."""
    held = 0
    for B in range(1, 97):
        if lo.chain_plan(B, H) is None:
            continue
        units, mt, blocks, smem = lo.check_design("lstm_fwd_train", B, H, chain=True)
        assert (units, mt) in lo.WALK_FORMS
        assert blocks == -(-B // (16 * mt)) * -(-H // units) and blocks <= lo.SMS
        assert smem == lo.walk_bytes(H, units, mt) <= lo.SMEM_LIMIT
        assert lo.smem_bytes(B, H)[0] == smem
        held += 1
    assert held == 96


@pytest.mark.parametrize("B, H", [(193, 320), (33, 1024), (32, 2048), (4300, 9)])
def test_walk_beyond_its_plan_raises(B, H):
    """One batch past the walk's limits (192 at H = 320, 32 at 1024; at
    2048 no form's shared memory fits): raises with the design message."""
    assert lo.walk_plan(B, H) is None and lo.smem_bytes(B, H)[0] is None
    with pytest.raises(ValueError, match=r"beyond the kernel's design \(no walk form"):
        lo.check_design("lstm_fwd", B, H, chain=False)


@pytest.mark.parametrize("B, H, plan", [
    # the recipes' batch: 2 row groups of 16 x 40 unit groups of 8
    (32, 320, (1, 80, 4 * (8 * 1280 + 8 * 32))),
    (1, 320, (1, 40, 4 * (8 * 1280 + 8 * 32))),
    (17, 320, (1, 80, 4 * (8 * 1280 + 8 * 32))),
    (48, 320, (1, 120, 4 * (8 * 1280 + 8 * 32))),
    (49, 320, (2, 80, 4 * (8 * 1280 + 8 * 64))),  # 4 groups of 16 would be 160 blocks
    (96, 320, (2, 120, 4 * (8 * 1280 + 8 * 64))),
    (96, 640, None),  # 3 groups x 80 unit groups
    (4, 9, (1, 2, 4 * (8 * 36 + 8 * 32))),
])
def test_chain_plan(B, H, plan):
    assert lo.chain_plan(B, H) == plan


@pytest.mark.parametrize("H", [9, 12, 16, 24, 64, 320])
def test_chain_plan_admits_the_tests_and_recipes_batches(H):
    """Every batch up to 96 at the widths the tests and recipes use has a
    chain split whose blocks fit the card one an SM, and smem_bytes
    reports that split's shared memory."""
    for B in (1, 4, 5, 16, 17, 23, 32, 33, 48, 64, 96):
        lo.check_design("layer", B, H, chain=True)
        mt, blocks, smem = lo.chain_plan(B, H)
        assert mt <= lo.CHAIN_MAX_MT and blocks <= lo.SMS and smem <= lo.SMEM_LIMIT
        assert blocks == -(-B // (16 * mt)) * -(-H // 8)
        assert lo.smem_bytes(B, H)[1] == smem
