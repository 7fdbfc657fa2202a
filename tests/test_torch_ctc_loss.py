"""The port's CTC loss against the JAX package's.

Same seeded numpy logits, lengths and labels through both packages. The
kernel path (``ops.ctc_batched``, which runs the CTC kernels' plain
versions on the CPU) is held to ``ctc_loss_pallas_batched`` in interpret
mode; the port's plain oracle ``ops.ctc.ctc_loss`` (autograd through the
loop over T) to the JAX oracle ``ops.ctc.ctc_loss`` (autodiff through
its scan). f32; loss rtol 1e-5, dlogits atol 1e-5, posteriors atol
1e-5. Also the kernels' plan (``ctc_plan``), which the CUDA side reads.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nabu_tpu.ops import ctc as jctc
from nabu_tpu.ops import losses as jlosses
from nabu_tpu.ops.pallas.ctc_batched import _ctc_forward, ctc_loss_pallas_batched
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


# ---------------------------------------------------------------------------
# the kernels' plan
# ---------------------------------------------------------------------------

OLD_LIMIT = 232448 // 13  # S the kernels took before: 13 S bytes of shared memory


@pytest.mark.parametrize("lo,hi", [(1, 512), (513, 2048), (2049, 8192), (8193, OLD_LIMIT)])
def test_ctc_plan_holds_every_s_the_kernels_took(lo, hi):
    """Every S up to the old limit has a plan: its chain warps hold the
    S lanes within the form's limit, its block within the form's threads,
    its buffers within a block's shared memory."""
    for S in range(lo, hi + 1):
        k, chain, helpers, tc, smem = tcb.ctc_plan(S)
        assert k in tcb.CTC_FORMS and 1 <= chain <= tcb.CHAIN_WARPS[k]
        assert 32 * k * (chain - 1) < S <= 32 * k * chain
        assert (chain + helpers) * 32 <= (512 if k <= 8 else 704)
        assert 1 <= tc <= tcb.CHUNK
        assert smem == tcb.ctc_smem_bytes(32 * k * chain, tc, chain) <= tcb.SMEM_LIMIT


@pytest.mark.parametrize("S,plan", [
    (1, (2, 1, 8, 32, 17680)),
    (201, (2, 4, 8, 32, 70672)),   # the bench line's L = 100
    (241, (2, 4, 8, 32, 70672)),   # chip_smoke's L = 120
    (513, (4, 5, 8, 32, 171536)),
    (2401, (16, 5, 4, 8, 175376)),
    (OLD_LIMIT, (32, 18, 4, 1, 221776)),
    (18432, (32, 18, 4, 1, 221776)),
])
def test_ctc_plan(S, plan):
    assert tcb.ctc_plan(S) == plan


@pytest.mark.parametrize("S,forms", [(18433, tcb.CTC_FORMS), (513, (2,)), (2049, (2, 4, 8))])
def test_ctc_plan_raises_beyond_what_it_admits(S, forms):
    with pytest.raises(ValueError, match="beyond the CTC kernels' design"):
        tcb.ctc_plan(S, forms)


def test_wrappers_raise_before_any_launch_beyond_the_plan():
    """A device tensor with L = 9217 (S = 18435) is refused by both
    wrappers before anything is checked or launched; an admitted L on a
    device the kernels do not run on is refused by the device check."""
    meta = torch.device("meta")
    B, T, V = 2, 5, 7
    lp = torch.empty((B, T, V), device=meta)
    tl = torch.empty((B,), dtype=torch.int32, device=meta)
    before = kernels.launch_counts()
    for L, match in ((9217, "beyond the CTC kernels' design"), (20, "unsupported device")):
        labels = torch.empty((B, L), dtype=torch.int32, device=meta)
        alphas = torch.empty((T, B, 2 * L + 1), device=meta)
        with pytest.raises(ValueError, match=f"ctc_alpha: .*{match}"):
            tcb.ctc_alpha(lp, tl, labels, tl, V - 1)
        with pytest.raises(ValueError, match=f"ctc_beta: .*{match}"):
            tcb.ctc_beta(lp, tl, labels, tl, alphas, tl.float(), V - 1)
    assert kernels.launch_counts() == before


@pytest.mark.parametrize("lengths", ["tc_minus_one_to_plus_one", "tc_plus_two_and_longer"])
def test_plain_versions_match_pallas_at_chunk_boundaries(lengths):
    """Logit lengths at the kernels' chunk boundaries (TC - 1, TC, TC + 1;
    TC + 2, 2 TC, 2 TC + 1: the beta walk's chunks count from tlen - 1),
    0 and 1, T not a multiple of TC: the loss, its gradient and the
    posteriors of the plain versions against the JAX kernel path in
    interpret mode."""
    tc = tcb.ctc_plan(2 * 6 + 1)[3]
    T = 2 * tc + 3
    if lengths == "tc_minus_one_to_plus_one":
        tl, ll = [tc - 1, tc, tc + 1, 0, 1], [6, 5, 6, 2, 0]
    else:
        tl, ll = [tc + 2, 2 * tc, 2 * tc + 1, T], [6, 4, 6, 5]
    rng = np.random.default_rng(len(tl))
    logits = (2.0 * rng.standard_normal((len(tl), T, V))).astype(np.float32)
    labels = rng.integers(0, V - 1, (len(tl), 6)).astype(np.int32)
    tl, ll = np.asarray(tl, np.int32), np.asarray(ll, np.int32)
    jargs = tuple(jnp.asarray(a) for a in (tl, labels, ll))
    want = ctc_loss_pallas_batched(jnp.asarray(logits), *jargs, V - 1, True)
    _, want_g = _jax_grad(lambda lg, *a: ctc_loss_pallas_batched(lg, *a, V - 1, True),
                          logits, *jargs)
    got, got_g = _torch(tcb.ctc_loss_batched, logits, tl, labels, ll)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5)
    np.testing.assert_allclose(got_g, np.asarray(want_g), atol=1e-5)
    lp = jax.nn.log_softmax(jnp.asarray(logits), axis=-1)
    _, want_p, _ = _ctc_forward(lp, *jargs, V - 1, True)
    args = tuple(torch.from_numpy(np.array(a)) for a in (lp, tl, labels, ll))
    alphas, lik = tcb.ctc_alpha_plain(*args, V - 1)
    posts = tcb.ctc_beta_plain(*args, alphas, lik, V - 1)
    np.testing.assert_allclose(posts.numpy(), np.asarray(want_p)[..., :13], atol=1e-5)
