"""The port's RNN-T loss against the JAX package's.

Same seeded numpy projections, output layer, lengths and targets through
both packages. The fused path (``ops.transducer_fused``, which runs the
transducer kernels' plain versions on the CPU) is held to JAX's
``transducer_loss_fused`` with its Pallas kernels in interpret mode, and
each plain version to its piece of that computation; the port's oracle
(``ops.transducer.transducer_loss`` over the materialized bf16 joint) to
the JAX oracle. Both sides run the joint in bf16 with f32 accumulation,
so the tolerance is rtol 1e-4 with an absolute floor of 1e-4 of each
array's largest entry, as in JAX's own test: f32 sums taken in another
order, and now and then a dlogit within its f32 error of a bf16 rounding
boundary, which moves its bf16 cast by one step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nabu_tpu.ops import losses as jlosses
from nabu_tpu.ops.pallas.transducer import transducer_loss_fused as jfused
from nabu_tpu.ops.transducer import transducer_loss as jloss
from nabu_tpu_torch.ops import kernels
from nabu_tpu_torch.ops import losses as tlosses
from nabu_tpu_torch.ops import transducer_fused as tf
from nabu_tpu_torch.ops.transducer import NEG, transducer_loss

torch.set_num_threads(1)  # Tier-1 runs several xdist workers

RTOL = 1e-4


def _close(got, want, what=""):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL,
                               atol=RTOL * max(float(np.abs(want).max()), 1e-6), err_msg=what)


def _case(seed=0, B=3, T=7, U=4, J=16, V=5):
    """(enc_proj, pred_proj, w_out, b_out, targets, target_lengths,
    logit_lengths); logit lengths >= 1, target lengths down to 0."""
    rng = np.random.RandomState(seed)
    enc = (rng.randn(B, T, J) * 0.5).astype(np.float32)
    pred = (rng.randn(B, U + 1, J) * 0.5).astype(np.float32)
    w = (rng.randn(J, V) * 0.3).astype(np.float32)
    b = (rng.randn(V) * 0.1).astype(np.float32)
    targets = rng.randint(0, V - 1, (B, U)).astype(np.int32)
    tlen = rng.randint(0, U + 1, (B,)).astype(np.int32)
    llen = rng.randint(1, T + 1, (B,)).astype(np.int32)
    return enc, pred, w, b, targets, tlen, llen


def _jax_fused(enc, pred, w, b, targets, tlen, llen, blank_id=None):
    def f(*x):
        return jfused(*x, jnp.asarray(llen), jnp.asarray(targets), jnp.asarray(tlen),
                      blank_id)

    x = [jnp.asarray(a) for a in (enc, pred, w, b)]
    return np.asarray(f(*x)), jax.grad(lambda *x: f(*x).sum(), argnums=(0, 1, 2, 3))(*x)


def _port_fused(enc, pred, w, b, targets, tlen, llen, blank_id=None):
    x = [torch.tensor(a, requires_grad=True) for a in (enc, pred, w, b)]
    nll = tf.transducer_loss_fused(*x, *(torch.from_numpy(a) for a in (llen, targets, tlen)),
                                   blank_id)
    nll.sum().backward()
    return nll.detach().numpy(), [a.grad.numpy() for a in x]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fused_matches_jax_fused(seed):
    case = _case(seed, T=9 if seed == 2 else 7)
    want, want_g = _jax_fused(*case)
    before = kernels.launch_counts()
    got, got_g = _port_fused(*case)
    assert kernels.launch_counts() == before  # CPU: plain versions
    _close(got, want, "nll")
    for name, g, w in zip(("denc", "dpred", "dw", "db"), got_g, want_g):
        _close(g, w, name)


def test_empty_lanes_match_jax_and_stay_finite():
    """A lane with logit length 0 gives the finite nll -NEG and no gradient;
    a lane with target length 0 sums blanks only."""
    enc, pred, w, b, targets, tlen, llen = _case(3, B=4)
    llen[:] = [5, 0, 3, 0]
    tlen[:] = [3, 0, 0, 2]
    want, want_g = _jax_fused(enc, pred, w, b, targets, tlen, llen)
    got, got_g = _port_fused(enc, pred, w, b, targets, tlen, llen)
    assert np.isfinite(got).all() and got[1] == -NEG and got[3] == -NEG
    _close(got, want, "nll")
    for name, g, wg in zip(("denc", "dpred", "dw", "db"), got_g, want_g):
        assert np.isfinite(g).all()
        _close(g, wg, name)
    assert np.abs(got_g[0][1]).max() == 0.0 and np.abs(got_g[1][3]).max() == 0.0


def test_padding_invariance():
    """Extra padded frames and target slots change nothing."""
    enc, pred, w, b, targets, tlen, llen = _case(4)
    got, got_g = _port_fused(enc, pred, w, b, targets, tlen, llen)
    rng = np.random.RandomState(9)
    enc_p = np.concatenate([enc, rng.randn(3, 4, 16).astype(np.float32)], 1)
    pred_p = np.concatenate([pred, rng.randn(3, 2, 16).astype(np.float32)], 1)
    tg_p = np.concatenate([targets, rng.randint(0, 4, (3, 2)).astype(np.int32)], 1)
    padded, padded_g = _port_fused(enc_p, pred_p, w, b, tg_p, tlen, llen)
    np.testing.assert_allclose(padded, got, rtol=1e-6)
    np.testing.assert_allclose(padded_g[0][:, :7], got_g[0], rtol=1e-5, atol=1e-7)
    assert np.abs(padded_g[0][:, 7:]).max() == 0.0
    np.testing.assert_allclose(padded_g[1][:, :5], got_g[1], rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(padded_g[2], got_g[2], rtol=1e-5, atol=1e-6)


def test_default_blank_is_the_last_index():
    case = _case(5)
    a, _ = _port_fused(*case)
    c, _ = _port_fused(*case, blank_id=-1)
    d, _ = _port_fused(*case, blank_id=0)
    want, _ = _jax_fused(*case, blank_id=0)
    np.testing.assert_array_equal(a, c)
    assert not np.allclose(a, d)
    _close(d, want, "blank 0")


def test_plain_versions_match_the_pallas_pieces():
    """Each plain version against its piece of the JAX computation: the
    joint's log-probs against ``_joint_rows``, the alpha walk's
    log-likelihood against the JAX forward, and the beta walk's blank
    occupancies, which add up to 1 at every frame inside the lattice (each
    path leaves each frame by exactly one blank) and are 0 past it."""
    from nabu_tpu.ops.pallas.transducer import _joint_rows, _prepare

    enc, pred, w, b, targets, tlen, llen = _case(6)
    B, T, J = enc.shape
    U1, V = pred.shape[1], w.shape[1]
    bf = torch.bfloat16
    tenc, tpred, tw = (torch.from_numpy(a).to(bf) for a in (enc, pred, w))
    args = [torch.from_numpy(a) for a in (targets, tlen, llen)]
    lpb, lpe = tf.rnnt_joint_fwd_plain(tenc, tpred, tw, torch.from_numpy(b), *args, V - 1)
    encp, predp, wp, bp, onehot, umask, *_ = _prepare(
        jnp.asarray(enc), jnp.asarray(pred), jnp.asarray(w), jnp.asarray(b),
        jnp.asarray(targets), jnp.asarray(tlen))
    _, _, jlpb, jlpe = _joint_rows(encp, predp, wp, bp, onehot, umask, V - 1)
    jlpb = np.asarray(jlpb)[:, :B, :U1]
    jlpe = np.asarray(jlpe)[:, :B, :U1]
    inside = (np.arange(T)[:, None, None] < llen[None, :, None]) & (
        np.arange(U1)[None, None, :] <= tlen[None, :, None])
    _close(lpb.numpy()[inside], jlpb[inside], "lp_blank")
    emit = inside & (np.arange(U1)[None, None, :] < tlen[None, :, None])
    _close(lpe.numpy()[emit], jlpe[emit], "lp_emit")
    assert (lpb.numpy()[~inside] == 0).all() and (lpe.numpy()[~emit] == NEG).all()

    alphas, ll = tf.rnnt_alpha_plain(lpb, lpe, args[2], args[1])
    want = jfused(*(jnp.asarray(a) for a in (enc, pred, w, b, llen, targets, tlen)))
    _close(-ll.numpy(), want, "ll")
    gb, ge = tf.rnnt_beta_plain(lpb, lpe, alphas, ll, torch.ones(B), args[2], args[1])
    for bi in range(B):
        for t in range(llen[bi]):
            np.testing.assert_allclose(float(gb[t, bi].sum()), 1.0, rtol=1e-4)
        assert float(gb[llen[bi]:, bi].abs().sum() + ge[llen[bi]:, bi].abs().sum()) == 0.0


def test_oracle_matches_jax_oracle():
    """ops.transducer.transducer_loss and its autograd against the JAX
    oracle and jax.grad, f32 lattice."""
    rng = np.random.RandomState(7)
    B, T, U, V = 3, 6, 3, 5
    logits = rng.randn(B, T, U + 1, V).astype(np.float32)
    targets = rng.randint(0, V - 1, (B, U)).astype(np.int32)
    tlen = np.asarray([3, 0, 2], np.int32)
    llen = np.asarray([6, 4, 1], np.int32)
    jargs = [jnp.asarray(a) for a in (llen, targets, tlen)]
    want = jloss(jnp.asarray(logits), *jargs)
    want_g = jax.grad(lambda x: jloss(x, *jargs).sum())(jnp.asarray(logits))
    x = torch.tensor(logits, requires_grad=True)
    got = transducer_loss(x, *(torch.from_numpy(a) for a in (llen, targets, tlen)))
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g), atol=1e-5)


def test_fused_matches_the_oracle_over_the_bf16_joint():
    """The fused path against the oracle over the materialized bf16 joint
    (JAX tests/test_pallas_kernels.py builds it the same way)."""
    enc, pred, w, b, targets, tlen, llen = _case(8)
    got, _ = _port_fused(enc, pred, w, b, targets, tlen, llen)
    bf = torch.bfloat16
    enc_b, pred_b = torch.from_numpy(enc).to(bf), torch.from_numpy(pred).to(bf)
    h = torch.tanh(enc_b[:, :, None] + pred_b[:, None])
    logits = h.float() @ torch.from_numpy(w).to(bf).float() + torch.from_numpy(b)
    want = transducer_loss(logits, *(torch.from_numpy(a) for a in (llen, targets, tlen)))
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("fused", [True, False])
def test_transducer_loss_fn_matches_jax(fused):
    """Loss and transducer_nll_per_frame of the loss computer against
    JAX's, through the projection handle (fused) or a lattice; the fill
    example is left out of the mean."""
    enc, pred, w, b, targets, tlen, llen = _case(9)
    mask = np.asarray([1.0, 1.0, 0.0], np.float32)
    if fused:
        jlogits = {"enc_proj": jnp.asarray(enc), "pred_proj": jnp.asarray(pred),
                   "w_out": jnp.asarray(w), "b_out": jnp.asarray(b)}
        tlogits = {"enc_proj": torch.from_numpy(enc), "pred_proj": torch.from_numpy(pred),
                   "w_out": torch.from_numpy(w), "b_out": torch.from_numpy(b)}
    else:
        lat = np.tanh(enc[:, :, None] + pred[:, None]) @ w + b
        jlogits, tlogits = jnp.asarray(lat), torch.from_numpy(lat)
    jl, jm = jlosses.transducer_loss_fn(
        jlogits, *(jnp.asarray(a) for a in (llen, targets, tlen, mask)), blank_id=4,
        use_pallas=fused)
    tl_, tm = tlosses.transducer_loss_fn(
        tlogits, *(torch.from_numpy(a) for a in (llen, targets, tlen, mask)), blank_id=4)
    np.testing.assert_allclose(float(tl_), float(jl), rtol=RTOL)
    assert set(tm) == set(jm) == {"transducer_nll_per_frame"}
    np.testing.assert_allclose(float(tm["transducer_nll_per_frame"]),
                               float(jm["transducer_nll_per_frame"]), rtol=RTOL)


def test_kernel_wrappers_refuse_what_they_cannot_take():
    """The wrappers take their plain versions only for CPU tensors and
    check every other device; shapes beyond the kernels' design raise
    with a clear message (there is no fallback on the card)."""
    enc = torch.zeros((2, 3, 16), dtype=torch.bfloat16, device="meta")
    ints = [torch.zeros((2, 2), dtype=torch.int32), torch.ones(2, dtype=torch.int32),
            torch.ones(2, dtype=torch.int32)]
    with pytest.raises(ValueError, match="unsupported device"):
        tf.rnnt_joint_fwd(enc, enc, enc[0, :, :5], torch.zeros(5), *ints, 4)
    with pytest.raises(ValueError, match="unsupported device"):
        tf.rnnt_alpha(torch.zeros((3, 2, 4), device="meta"), None, *ints[1:])
    tf.check_design("rnnt", J=320, V=29, U1=512)  # the recipe's widths, and U + 1 to 512
    for bad in (dict(J=24), dict(J=tf.JOINT_MAX + 16), dict(V=tf.VOCAB_MAX + 1),
                dict(U1=tf.LANES_MAX + 1)):
        with pytest.raises(ValueError, match="beyond the kernel's design"):
            tf.check_design("rnnt", **bad)
