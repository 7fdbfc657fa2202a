"""The port's CTC loss against the JAX package's.

Same seeded numpy logits, lengths and labels through both packages. The
kernel path (``ops.ctc_batched``, which runs the CTC kernels' plain
versions on the CPU) is held to ``ctc_loss_pallas_batched`` in interpret
mode; the port's plain oracle ``ops.ctc.ctc_loss`` (autograd through the
loop over T) to the JAX oracle ``ops.ctc.ctc_loss`` (autodiff through
its scan). f32; loss rtol 1e-5, dlogits atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nabu_tpu.ops import ctc as jctc
from nabu_tpu.ops import losses as jlosses
from nabu_tpu.ops.pallas.ctc_batched import ctc_loss_pallas_batched
from nabu_tpu_torch.ops import ctc as tctc
from nabu_tpu_torch.ops import ctc_batched as tcb
from nabu_tpu_torch.ops import kernels
from nabu_tpu_torch.ops import losses as tlosses

torch.set_num_threads(1)  # Tier-1 runs several xdist workers

V = 6  # 5 labels + blank (last)


def _case(name, seed=0):
    """(logits [B, T, V], logit lengths, labels [B, L], label lengths)."""
    rng = np.random.default_rng(seed)
    if name == "ragged":  # logit lengths down to 1
        T, tl, ll = 40, [40, 23, 1, 9], [7, 5, 1, 3]
    elif name == "empty_label":  # a label of length 0 among others
        T, tl, ll = 33, [33, 20, 12], [0, 6, 0]
    elif name == "repeats":  # adjacent repeats need a blank between them
        T, tl, ll = 30, [30, 14, 9], [8, 6, 4]
    elif name == "infeasible":  # 4 repeats of one label in 6 frames
        T, tl, ll = 25, [25, 6, 18], [5, 4, 6]
    else:  # "t_not_multiple": T past one 64-frame block, not a multiple
        T, tl, ll = 70, [70, 65, 31], [12, 9, 4]
    B, L = len(tl), max(max(ll), 1)
    labels = rng.integers(0, V - 1, (B, L)).astype(np.int32)
    if name == "repeats":
        labels[0, :4] = [2, 2, 3, 3]
        labels[1, :3] = 1
    if name == "infeasible":
        labels[1, :4] = 4
    logits = (2.0 * rng.standard_normal((B, T, V))).astype(np.float32)
    return logits, np.asarray(tl, np.int32), labels, np.asarray(ll, np.int32)


CASES = ["ragged", "empty_label", "repeats", "infeasible", "t_not_multiple"]


def _jax_grad(fn, logits, *args):
    return jax.value_and_grad(lambda lg: jnp.sum(fn(lg, *args)))(jnp.asarray(logits))


def _torch(fn, logits, *args):
    x = torch.tensor(logits, requires_grad=True)
    nll = fn(x, *(torch.from_numpy(a) for a in args))
    nll.sum().backward()
    return nll.detach().numpy(), x.grad.numpy()


@pytest.mark.parametrize("name", CASES)
def test_kernel_path_matches_pallas(name):
    logits, tl, labels, ll = _case(name)
    jargs = tuple(jnp.asarray(a) for a in (tl, labels, ll))
    want = ctc_loss_pallas_batched(jnp.asarray(logits), *jargs, V - 1, True)
    _, want_g = _jax_grad(lambda lg, *a: ctc_loss_pallas_batched(lg, *a, V - 1, True),
                          logits, *jargs)
    before = kernels.launch_counts()
    got, got_g = _torch(tcb.ctc_loss_batched, logits, tl, labels, ll)
    assert kernels.launch_counts() == before  # CPU: plain versions
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5)
    np.testing.assert_allclose(got_g, np.asarray(want_g), atol=1e-5)
    if name == "infeasible":
        assert got[1] == tctc.CTC_NLL_CLAMP
        assert np.abs(got_g[1]).max() == 0.0


@pytest.mark.parametrize("name", CASES)
def test_oracle_matches_jax_oracle(name):
    logits, tl, labels, ll = _case(name, seed=1)
    jargs = tuple(jnp.asarray(a) for a in (tl, labels, ll))
    want, want_g = _jax_grad(jctc.ctc_loss, logits, *jargs)
    got, got_g = _torch(tctc.ctc_loss, logits, tl, labels, ll)
    np.testing.assert_allclose(got.sum(), float(want), rtol=1e-5)
    np.testing.assert_allclose(got, np.asarray(jctc.ctc_loss(jnp.asarray(logits), *jargs)),
                               rtol=1e-5)
    np.testing.assert_allclose(got_g, np.asarray(want_g), atol=1e-5)
    np.testing.assert_array_equal(
        tctc.ctc_feasible(*(torch.from_numpy(a) for a in (tl, labels, ll))).numpy(),
        np.asarray(jctc.ctc_feasible(*jargs)))


@pytest.mark.parametrize("name", ["ragged", "t_not_multiple"])
def test_kernel_path_matches_library_ctc_on_feasible_examples(name):
    """F.ctc_loss as an extra oracle (feasible examples, blank last)."""
    logits, tl, labels, ll = _case(name, seed=2)
    got, _ = _torch(tcb.ctc_loss_batched, logits, tl, labels, ll)
    lp = torch.log_softmax(torch.from_numpy(logits), -1).transpose(0, 1)
    ref = torch.nn.functional.ctc_loss(
        lp, torch.from_numpy(labels).long(), torch.from_numpy(tl).long(),
        torch.from_numpy(ll).long(), blank=V - 1, reduction="none")
    np.testing.assert_allclose(got, ref.numpy(), rtol=1e-5)


def test_alpha_and_beta_plain_versions_match_the_oracle_alphas():
    """The alpha kernel's plain version equals the oracle's DP rows inside
    each logit length, and its posteriors sum to 1 over the lanes at
    every valid frame of a feasible example."""
    logits, tl, labels, ll = _case("ragged", seed=3)
    lp = torch.log_softmax(torch.from_numpy(logits), -1)
    args = (lp, torch.from_numpy(tl), torch.from_numpy(labels), torch.from_numpy(ll))
    alphas, lik = tcb.ctc_alpha(*args, V - 1)
    want, _ = tctc.ctc_forward_log_alpha(lp, args[1], args[2], V - 1)
    for b, n in enumerate(tl):
        fin = want[:n, b] > -1e29
        np.testing.assert_allclose(alphas[:n, b][fin].numpy(), want[:n, b][fin].numpy(),
                                   rtol=1e-6, atol=1e-5)
    posts = tcb.ctc_beta(*args, alphas, lik, V - 1)
    for b, n in enumerate(tl):
        np.testing.assert_allclose(posts[:n, b].sum(-1).numpy(), 1.0, rtol=1e-4)
        assert float(posts[n:, b].abs().sum()) == 0.0


@pytest.mark.parametrize("use_pallas", [True, False])
def test_ctc_loss_fn_matches_jax(use_pallas):
    """Loss and metrics of the loss computer against JAX's, with either
    of JAX's CTC paths (the port's always runs its kernels): infeasible
    and fill examples left out of the mean, counted in
    ctc_infeasible_frac."""
    logits, tl, labels, ll = _case("infeasible", seed=4)
    mask = np.asarray([1.0, 1.0, 0.0], np.float32)  # the last is a fill example
    jl, jm = jlosses.ctc_loss_fn(
        jnp.asarray(logits), *(jnp.asarray(a) for a in (tl, labels, ll, mask)),
        blank_id=V - 1, use_pallas=use_pallas)
    tl_, tm = tlosses.ctc_loss_fn(
        torch.from_numpy(logits), *(torch.from_numpy(a) for a in (tl, labels, ll, mask)),
        blank_id=V - 1)
    np.testing.assert_allclose(float(tl_), float(jl), rtol=1e-5)
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5)
    assert float(tm["ctc_infeasible_frac"]) == 0.5


def test_other_losses_not_ported():
    """Every loss of the JAX package is ported: cross_entropy (alias ce)
    computes the label-smoothed token mean with <eos> appended; a name
    no package registers is refused."""
    assert set(jlosses.LOSSES.names()) <= set(tlosses.LOSSES.names())
    logits = torch.zeros((1, 2, V))  # uniform: nll log(V) at each of 2 tokens
    loss, metrics = tlosses.LOSSES.get("cross_entropy")(
        logits, torch.tensor([2]), torch.tensor([[3]]), torch.tensor([1]),
        torch.tensor([1.0]), label_smoothing=0.1)
    np.testing.assert_allclose(float(loss), np.log(V), rtol=1e-6)
    assert set(metrics) == {"token_accuracy"}
    with pytest.raises(KeyError, match="unknown"):
        tlosses.LOSSES.get("mwer")
