"""The port's BLSTM backward against the JAX package's.

Same seeded weights (a JAX init with a nonzero bias, converted through
the export layout), inputs and output cotangent through both. The
port's ``BLSTMLayer`` (which runs the forward and backward kernels'
plain versions on the CPU) gives dx, dwx, dwh and db; they are held to
``jax.grad`` through the Pallas v2 kernels in interpret mode
(``blstm_tm_apply(interpret=True, block_t=8)``) and through the scan
oracle ``core.blstm_apply``, on ragged lengths [T, mid, 8, 1] with T not
a multiple of the block. f32 rtol 1e-4 / atol 1e-5. bf16: against the
Pallas kernel in bf16, 3e-2 of each gradient's largest entry (the carry
and the dgates are rounded to bf16 every step on both sides, and a
one-step rounding difference propagates along the chain).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nabu_tpu.models import core as jcore
from nabu_tpu.ops.pallas import blstm as jblstm
from nabu_tpu_torch.models import core
from nabu_tpu_torch.ops import blstm as blstm_ops
from nabu_tpu_torch.ops import kernels
from nabu_tpu_torch.params import from_jax_params

torch.set_num_threads(1)  # Tier-1 runs several xdist workers

T, D, H = 29, 11, 9
LENGTHS = [T, 17, 8, 1]
NAMES = ["x"] + [f"{d}/{k}" for d in ("fw", "bw") for k in ("wx", "wh", "b")]


def _inputs(seed):
    p = jcore.blstm_init(jax.random.PRNGKey(seed), D, H)
    rng = np.random.default_rng(seed)
    for d in ("fw", "bw"):
        p[d]["b"] = jnp.asarray(rng.uniform(-0.5, 0.5, 4 * H).astype(np.float32))
    x = rng.standard_normal((T, len(LENGTHS), D)).astype(np.float32)
    gy = rng.standard_normal((T, len(LENGTHS), 2 * H)).astype(np.float32)
    return p, x, gy, np.asarray(LENGTHS, np.int32)


def _flat(p):
    return {f"{d}/{k}": np.asarray(p[d][k]) for d in ("fw", "bw") for k in ("wx", "wh", "b")}


def _jax_grads(fn, p, x, gy):
    """Gradients of sum(fn(p, x) * gy) w.r.t. x and every weight, f32."""
    def f(p, x):
        return jnp.sum(fn(p, x).astype(jnp.float32) * gy)
    gp, gx = jax.grad(f, argnums=(0, 1))(p, x)
    out = {"x": np.asarray(gx.astype(jnp.float32))}
    out.update({k: v.astype(np.float32) for k, v in _flat(gp).items()})
    return out


def _torch_grads(fn, p, x, gy, dtype=torch.float32):
    tp = {d: {k: torch.tensor(np.asarray(v, np.float32)).to(dtype).requires_grad_(True)
              for k, v in p[d].items()} for d in p}
    xt = torch.tensor(x).to(dtype).requires_grad_(True)
    before = kernels.launch_counts()
    y = fn(tp, xt)
    (y.float() * torch.from_numpy(gy)).sum().backward()
    assert kernels.launch_counts() == before  # CPU: plain versions
    out = {"x": xt.grad.float().numpy()}
    out.update({f"{d}/{k}": tp[d][k].grad.float().numpy() for d in tp for k in tp[d]})
    return y, out


def _port_layer(tp, xt):
    return blstm_ops.blstm_tm_apply(tp, xt, torch.as_tensor(LENGTHS))


@pytest.mark.parametrize("name", NAMES)
def test_gradients_match_pallas_kernel_f32(name):
    p, x, gy, lengths = _inputs(1)
    want = _jax_grads(lambda p, x: jblstm.blstm_tm_apply(
        p, x, jnp.asarray(lengths), interpret=True, block_t=8), p, jnp.asarray(x), gy)
    _, got = _torch_grads(_port_layer, p, x, gy)
    np.testing.assert_allclose(got[name], want[name], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", NAMES)
def test_gradients_match_scan_oracle_f32(name):
    p, x, gy, lengths = _inputs(2)
    want = _jax_grads(lambda p, x: jcore.blstm_apply(
        p, x.swapaxes(0, 1), jnp.asarray(lengths)).swapaxes(0, 1), p, jnp.asarray(x), gy)
    _, got = _torch_grads(_port_layer, p, x, gy)
    np.testing.assert_allclose(got[name], want[name], rtol=1e-4, atol=1e-5)


def test_gradients_match_pallas_kernel_bf16():
    p, x, gy, lengths = _inputs(3)
    pb = jax.tree.map(lambda a: a.astype(jnp.bfloat16), p)
    want = _jax_grads(lambda p, x: jblstm.blstm_tm_apply(
        p, x, jnp.asarray(lengths), interpret=True, block_t=8),
        pb, jnp.asarray(x, jnp.bfloat16), gy)
    y, got = _torch_grads(_port_layer, p, x, gy, torch.bfloat16)
    assert y.dtype == torch.bfloat16
    for name in NAMES:
        scale = np.abs(want[name]).max()
        np.testing.assert_allclose(got[name], want[name], rtol=0, atol=3e-2 * scale,
                                   err_msg=name)


def test_gradients_match_autograd_through_the_plain_forward():
    """Second oracle: autograd through blstm_proj_plain + blstm_recur_plain
    (the forward kernels' plain versions) gives BLSTMLayer's gradients."""
    p, x, gy, _ = _inputs(4)

    def autograd_layer(tp, xt):
        wx, b, wh = blstm_ops.stack_directions(tp)
        xw = blstm_ops.blstm_proj_plain(xt.reshape(-1, D), wx, b)
        return blstm_ops.blstm_recur_plain(xw.view(2, T, -1, 4 * H),
                                           torch.as_tensor(LENGTHS), wh)

    y0, want = _torch_grads(autograd_layer, p, x, gy)
    y1, got = _torch_grads(_port_layer, p, x, gy)
    np.testing.assert_array_equal(y1.detach().numpy(), y0.detach().numpy())
    for name in NAMES:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-4, atol=1e-5,
                                   err_msg=name)


def test_forward_residuals_match_pallas_kernel():
    """The residual-writing forward's c equals the TPU kernel's stored c,
    and its masked h the kernel's output."""
    p, x, _, lengths = _inputs(5)
    mask = (jnp.arange(T)[:, None] < jnp.asarray(lengths)[None, :]).astype(jnp.float32)
    out, res = jblstm._tm_fwd(
        jnp.asarray(x), mask, p["fw"]["wx"], p["fw"]["b"], p["fw"]["wh"],
        p["bw"]["wx"], p["bw"]["b"], p["bw"]["wh"], 1.0, True, 8)
    c_fw, c_bw = np.asarray(res[10])[:T], np.asarray(res[11])[:T]
    tp = from_jax_params({f"{d}/{k}": v for d, q in p.items() for k, v in q.items()})
    wx, b, wh = blstm_ops.stack_directions(tp)
    xw = blstm_ops.blstm_proj(torch.from_numpy(x).reshape(-1, D), wx, b)
    y, c, gates = blstm_ops.blstm_recur_train(
        xw.view(2, T, -1, 4 * H), torch.from_numpy(lengths), wh)
    np.testing.assert_allclose(c[0].numpy(), c_fw, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(c[1].numpy(), c_bw, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(y[..., :H].numpy(), np.asarray(out[0]), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(y[..., H:].numpy(), np.asarray(out[1]), rtol=1e-4, atol=1e-5)
    assert gates.shape == (2, T, len(LENGTHS), 4 * H) and gates.dtype == torch.float32


def test_layer_takes_the_inference_path_without_gradients():
    """No gradient wanted: the residual-free inference forward, equal to
    the training forward's output."""
    p, x, _, _ = _inputs(6)
    tp = from_jax_params({f"{d}/{k}": v for d, q in p.items() for k, v in q.items()})
    xt = torch.from_numpy(x)
    with torch.no_grad():
        inference = blstm_ops.blstm_tm_apply(tp, xt, torch.as_tensor(LENGTHS))
    for q in tp.values():
        for v in q.values():
            v.requires_grad_(True)
    train = blstm_ops.blstm_tm_apply(tp, xt, torch.as_tensor(LENGTHS))
    assert inference.grad_fn is None and train.grad_fn is not None
    np.testing.assert_array_equal(train.detach().numpy(), inference.numpy())


def test_dropout_statistics():
    """Inverted dropout: about `rate` of the entries zeroed, the rest
    scaled by 1/keep exactly, in the activation dtype; off outside
    training; the same generator seed gives the same mask."""
    x = torch.ones((200, 500), dtype=torch.bfloat16) * 0.75
    gen = torch.Generator().manual_seed(3)
    y = core.dropout(x, 0.2, True, gen)
    assert y.dtype == torch.bfloat16
    dropped = float((y == 0).float().mean())
    assert abs(dropped - 0.2) < 0.01  # 1e5 draws: 4 standard deviations
    kept = y[y != 0]
    assert torch.equal(kept, torch.full_like(kept, 0.75) / 0.8)
    assert torch.equal(core.dropout(x, 0.2, False, gen), x)
    assert torch.equal(core.dropout(x, 0.0, True, gen), x)
    again = core.dropout(x, 0.2, True, torch.Generator().manual_seed(3))
    assert torch.equal(again, y)
    # the same masks on both sides give JAX's where(mask, x / keep, 0)
    keep = (y != 0).numpy()
    want = jnp.where(keep, jnp.asarray(x.float().numpy(), jnp.bfloat16) / 0.8, 0.0)
    np.testing.assert_array_equal(y.float().numpy(), np.asarray(want.astype(jnp.float32)))
