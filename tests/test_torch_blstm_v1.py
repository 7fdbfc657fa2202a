"""The port's v1 BLSTM kernel family (``ops.blstm_v1``) against the JAX
package's v1 kernels, and the family dispatch.

Same seeded weights (a JAX init, converted through the export layout) and
inputs through both, f32. The port's plain versions (what the CPU runs in
place of the CUDA kernels of ``csrc/blstm_v1.cu``) are held to
``blstm_fused_forward`` (row 4) and to ``jax.grad`` of
``blstm_apply_fused_v1`` (rows 5-6), both in interpret mode, on ragged
lengths with T not a multiple of 8: rtol 1e-4 / atol 1e-5, as the JAX
kernel tests. The two families are one function: a layer through v1 and
through v2 agrees to the same tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nabu_tpu.models import core as jcore
from nabu_tpu.ops.pallas.blstm import blstm_apply_fused_v1, blstm_fused_forward
from nabu_tpu_torch.ops import blstm as blstm_ops
from nabu_tpu_torch.ops import blstm_v1
from nabu_tpu_torch.ops import kernels
from test_torch_blstm import to_torch_tree

torch.set_num_threads(1)  # Tier-1 runs several xdist workers

T, D, H = 21, 10, 12
LENGTHS = [T, 13, 6, 1]
TOL = dict(rtol=1e-4, atol=1e-5)


def _inputs(seed):
    p = jcore.blstm_init(jax.random.PRNGKey(seed), D, H)
    rng = np.random.default_rng(seed)
    for d in ("fw", "bw"):
        p[d]["b"] = jnp.asarray(rng.uniform(-0.5, 0.5, 4 * H).astype(np.float32))
    x = rng.standard_normal((len(LENGTHS), T, D)).astype(np.float32)
    return p, x, np.asarray(LENGTHS, np.int32)


def test_inference_walk_matches_row4_kernel():
    p, x, lengths = _inputs(1)
    want = blstm_fused_forward(p, jnp.asarray(x), jnp.asarray(lengths), interpret=True,
                               block_t=8)
    before = kernels.launch_counts()
    with torch.no_grad():
        got = blstm_v1.blstm_v1_tm_apply(
            to_torch_tree(p), torch.from_numpy(x).transpose(0, 1), torch.from_numpy(lengths))
    assert kernels.launch_counts() == before  # CPU: plain versions
    np.testing.assert_allclose(got.transpose(0, 1).numpy(), np.asarray(want), **TOL)
    assert float(got[6:, 2].abs().max()) == 0.0  # padded frames are exact zeros


def _torch_loss_and_grads(p, x, lengths, g, apply):
    tp = {d: {k: v.requires_grad_(True) for k, v in q.items()}
          for d, q in to_torch_tree(p).items()}
    xt = torch.from_numpy(x).transpose(0, 1).requires_grad_(True)
    y = apply(tp, xt, torch.from_numpy(lengths))
    loss = (y.transpose(0, 1) * torch.from_numpy(g)).sum()
    loss.backward()
    grads = {f"{d}/{k}": tp[d][k].grad.numpy() for d in tp for k in tp[d]}
    grads["x"] = xt.grad.transpose(0, 1).numpy()
    return float(loss.detach()), grads


def test_training_layer_matches_row5_row6_gradients():
    """BLSTMLayerV1 (training walk, gates recompute, chain, dwh) against
    jax.grad of blstm_apply_fused_v1: dx, dwx, dwh, db."""
    p, x, lengths = _inputs(2)
    g = np.random.default_rng(3).standard_normal((len(LENGTHS), T, 2 * H)).astype(np.float32)

    def jloss(p, x):
        y = blstm_apply_fused_v1(p, x, jnp.asarray(lengths), interpret=True, block_t=8)
        return jnp.sum(y * g)

    want_loss, (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1))(p, jnp.asarray(x))
    got_loss, grads = _torch_loss_and_grads(p, x, lengths, g, blstm_v1.blstm_v1_tm_apply)
    np.testing.assert_allclose(got_loss, float(want_loss), rtol=1e-5)
    np.testing.assert_allclose(grads["x"], np.asarray(jgx), **TOL)
    for d in ("fw", "bw"):
        for k in ("wx", "wh", "b"):
            np.testing.assert_allclose(grads[f"{d}/{k}"], np.asarray(jgp[d][k]), **TOL,
                                       err_msg=f"{d}/{k}")


def test_both_families_compute_one_function():
    p, x, lengths = _inputs(4)
    g = np.random.default_rng(5).standard_normal((len(LENGTHS), T, 2 * H)).astype(np.float32)

    def v2_apply(tp, xt, lens):
        return blstm_ops.BLSTMLayer.apply(
            xt, lens, tp["fw"]["wx"], tp["fw"]["b"], tp["fw"]["wh"],
            tp["bw"]["wx"], tp["bw"]["b"], tp["bw"]["wh"], 1.0)

    l1, g1 = _torch_loss_and_grads(p, x, lengths, g, blstm_v1.blstm_v1_tm_apply)
    l2, g2 = _torch_loss_and_grads(p, x, lengths, g, v2_apply)
    np.testing.assert_allclose(l1, l2, rtol=1e-5)
    for k in g2:
        np.testing.assert_allclose(g1[k], g2[k], **TOL, err_msg=k)


def test_plain_pieces_of_row6():
    """The stored carries' layout (zero slot at each direction's start)
    and the recompute: the gates the v2 walk stores equal the v1
    recompute from the v1 walk's carries."""
    rng = np.random.default_rng(6)
    xw = torch.from_numpy(rng.uniform(-1, 1, (2, T, 4, 4 * H)).astype(np.float32))
    wh = torch.from_numpy(rng.uniform(-0.3, 0.3, (2, H, 4 * H)).astype(np.float32))
    lens = torch.as_tensor(LENGTHS, dtype=torch.int32)
    y, hs, c = blstm_v1.blstm_v1_recur_train_plain(xw, lens, wh)
    y2, c2, gates2 = blstm_ops.blstm_recur_train_plain(xw, lens, wh)
    assert hs.shape == (2, T + 1, 4, H)
    assert float(hs[0, 0].abs().max()) == 0.0 and float(hs[1, T].abs().max()) == 0.0
    torch.testing.assert_close(y, y2, rtol=0, atol=0)
    torch.testing.assert_close(c, c2, rtol=0, atol=0)
    torch.testing.assert_close(blstm_v1.blstm_v1_bwd_gates_plain(xw, hs, wh), gates2,
                               rtol=1e-5, atol=1e-6)
    gy = torch.from_numpy(rng.standard_normal((T, 4, 2 * H)).astype(np.float32))
    dg, dwh = blstm_v1.blstm_v1_bwd_plain(xw, hs, c, gy, lens, wh)
    dg2 = blstm_ops.blstm_bwd_recur_plain(gates2, c2, gy, lens, wh)
    torch.testing.assert_close(dg, dg2, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(dwh, blstm_ops.blstm_bwd_dwh_plain(y2, dg2), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("B, H, family", [
    (64, 512, "v1"),  # las_large's Listener in training
    # its validation batch: v2 since the v2 chain's blocks own a row group
    # (16 rows x 16 units of one direction, 128 blocks); v1 before, when
    # each chain block staged all B rows (B <= 20 at H = 512)
    (32, 512, "v2"),
    (32, 320, "v2"), (32, 256, "v2"),  # dblstm_ctc_wsj / rnnt_char_wsj, las_timit
    (4, 12, "v2"),                     # the tests' tiny layers
])
def test_kernel_family(B, H, family):
    assert blstm_ops.kernel_family(B, H) == family
    if family == "v1":
        blstm_v1.check_design("layer", B, H, "bf16")  # v1 holds what v2 cannot


def test_check_design_raises_beyond_the_design():
    with pytest.raises(ValueError, match="beyond"):
        blstm_v1.check_design("layer", 129, 512, "bf16")
    with pytest.raises(ValueError, match="beyond"):
        blstm_v1.check_design("layer", 64, 1024, "bf16")
    with pytest.raises(ValueError, match="chain's design"):  # 4H past 8 K chunks a warp
        blstm_v1.check_design("layer", 64, 520, "bf16")


@pytest.mark.parametrize("tag", ["bf16", "f32"])
@pytest.mark.parametrize("H", [9, 12, 16, 320, 512])
def test_design_admits_the_tests_and_recipes_shapes(tag, H):
    """Every batch up to 128 at the widths the tests and recipes use has a
    chain split whose blocks fit the card one an SM, and smem_bytes reports
    that split's shared memory."""
    for B in (1, 4, 5, 23, 32, 64, 128):
        blstm_v1.check_design("layer", B, H, tag)
        mt, blocks, smem = blstm_v1.chain_plan(B, H, tag)
        assert mt <= blstm_v1.CHAIN_MAX_MT[tag]
        assert blocks <= blstm_ops.SMS and smem <= blstm_ops.SMEM_LIMIT
        assert blstm_v1.smem_bytes(B, H, tag)[1] == smem


@pytest.mark.parametrize("B, H, tag, plan", [
    # las_large's Listener: 16 rows x 32 units a block, 4 row groups x 16
    # unit groups x 2 directions; wh 64 K chunks x 2 KB, partials 8 x 16 x 40
    (64, 512, "bf16", (1, 128, 64 * 2048 + 4 * 8 * 16 * 40)),
    (128, 512, "bf16", (2, 128, 64 * 2048 + 4 * 8 * 32 * 40)),
    (64, 512, "f32", (4, 128, 4 * (8 * 2052 + 8 * 64 * 20 + 8 * 64 * 8))),
    (32, 512, "bf16", (1, 64, 64 * 2048 + 4 * 8 * 16 * 40)),  # its validation batch
])
def test_chain_plan_at_las_large(B, H, tag, plan):
    assert blstm_v1.chain_plan(B, H, tag) == plan


# walk bytes: bf16 ceil(H / 32) K chunks x units / 2 n-tiles x 512 bytes
# of B fragments and the 8 warps' partial sums [16 mt, 4 units + 8] f32;
# f32 wh's 4 gate columns of the units, [4 units, ceil4(H)] f32
def _walk_bf16_bytes(H, units, mt):
    return -(-H // 32) * units // 2 * 512 + 4 * 8 * 16 * mt * (4 * units + 8)


def _walk_f32_bytes(H, units):
    return 16 * units * (-(-H // 4) * 4)


@pytest.mark.parametrize("B, H, tag, plan", [
    # las_large's Listener: 32 units x 16 rows in bf16 (2 directions x 4
    # row groups x 16 unit groups); in f32 32 x 1 would stage 256 KB of wh,
    # past a block's 227 KB, so 16 x 2
    (64, 512, "bf16", (32, 1, 128, _walk_bf16_bytes(512, 32, 1))),
    (64, 512, "f32", (16, 2, 128, _walk_f32_bytes(512, 16))),
    # the largest batch at its width: 4 cells a thread
    (128, 512, "bf16", (16, 4, 128, _walk_bf16_bytes(512, 16, 4))),
    (32, 512, "bf16", (32, 1, 64, _walk_bf16_bytes(512, 32, 1))),  # its validation batch
    (1, 9, "bf16", (32, 1, 2, _walk_bf16_bytes(9, 32, 1))),        # the tests' narrow layers
    (5, 12, "f32", (32, 1, 2, _walk_f32_bytes(12, 32))),
    (128, 528, "f32", (16, 4, 132, _walk_f32_bytes(528, 16))),     # f32's widest: 132 blocks
])
def test_walk_plan(B, H, tag, plan):
    assert blstm_v1.walk_plan(B, H, tag) == plan
    assert blstm_v1.smem_bytes(B, H, tag)[0] == plan[3]
    assert plan[3] <= blstm_ops.SMEM_LIMIT and plan[2] <= blstm_ops.SMS


@pytest.mark.parametrize("units, mt", blstm_v1.WALK_FORMS)
def test_walk_forms_fill_a_block(units, mt):
    """Each form's 16 mt rows x units cells are 2 or 4 a thread of the
    block's 256, in tiles of 4 rows x 4 units (the f32 product's half
    warps)."""
    cells = 16 * mt * units
    assert cells % blstm_v1.THREADS == 0 and cells // blstm_v1.THREADS in (2, 4)
    assert units % 4 == 0


def _admitted_before(B, H, tag):
    """check_design before the walk's row groups: B <= 128 (8 units a
    block, all B rows, 4 cells a thread), the walk's shared memory (wh's
    gate columns of 8 units in f32, a K tile of 128 columns of h, two [B,
    8] carries) with its 2 ceil(H / 8) blocks co-resident, and a chain
    plan."""
    walk = 4 * ((H + 3) // 4 * 4 * 8 * 4 + B * (128 + 4) + 2 * B * 8)
    return (B <= 128 and blstm_ops.coresident(walk, 2 * -(-H // 8))
            and blstm_v1.chain_plan(B, H, tag) is not None)


@pytest.mark.parametrize("tag", ["bf16", "f32"])
@pytest.mark.parametrize("b_lo", [1, 33, 65, 97])
def test_walk_plan_holds_every_shape_admitted_before(tag, b_lo):
    """Every (B, H) the design admitted before the row groups, B <= 128,
    H <= 600 (so bf16 H <= 512, f32 H <= 528), still has a walk plan in
    its element type and passes check_design; smem_bytes reports the
    plan's bytes."""
    seen = 0
    for B in range(b_lo, b_lo + 32):
        for H in range(1, 601):
            if not _admitted_before(B, H, tag):
                continue
            seen += 1
            units, mt, blocks, smem = blstm_v1.check_design("layer", B, H, tag)
            assert (units, mt) in blstm_v1.WALK_FORMS
            assert blocks <= blstm_ops.SMS and smem <= blstm_ops.SMEM_LIMIT
            assert blstm_v1.smem_bytes(B, H, tag)[0] == smem
    assert seen == 32 * (512 if tag == "bf16" else 528)


@pytest.mark.parametrize("B, H, tag, match", [
    (129, 512, "bf16", "beyond the kernel's design"),
    (129, 16, "f32", "beyond the kernel's design"),
    (128, 529, "f32", "beyond the walk's design"),  # 16 x 4 needs 136 blocks
    (64, 513, "bf16", "beyond the chain's design"),  # 4H past 8 K chunks a warp
    (64, 529, "f32", "beyond the chain's design"),
])
def test_one_past_the_limits_raises(B, H, tag, match):
    with pytest.raises(ValueError, match=match):
        blstm_v1.check_design("layer", B, H, tag)


def test_dispatch_takes_v1_at_las_large_width():
    """blstm_tm_apply at B = 33, H = 512 (past the v2 chain's limit) runs
    the v1 walk; at B = 32 the v2 one (monkeypatched walks record it)."""
    rng = np.random.default_rng(7)
    seen = []
    saved = (blstm_v1.blstm_v1_recur, blstm_ops.blstm_recur)
    blstm_v1.blstm_v1_recur = lambda *a, **k: seen.append("v1") or saved[0](*a, **k)
    blstm_ops.blstm_recur = lambda *a, **k: seen.append("v2") or saved[1](*a, **k)
    try:
        for B in (33, 32):
            p = {d: {"wx": torch.from_numpy(rng.uniform(-0.1, 0.1, (3, 2048)).astype(np.float32)),
                     "wh": torch.zeros((512, 2048)), "b": torch.zeros((2048,))}
                 for d in ("fw", "bw")}
            with torch.no_grad():
                blstm_ops.blstm_tm_apply(p, torch.ones((2, B, 3)), torch.full((B,), 2))
    finally:
        blstm_v1.blstm_v1_recur, blstm_ops.blstm_recur = saved
    assert seen == ["v1", "v2"]
