"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device and skips without one. The file
imports neither jax nor the JAX package, so it also runs where only
PyTorch is installed:

    python -m pytest tests/test_torch_gpu.py -q --noconftest

(``--noconftest``: the suite's conftest configures JAX). Small shapes,
including ones off the kernels' fast paths: H and D not multiples of 8,
S = 2L + 1 larger than a block's threads, logit length 1, label length
0, an infeasible CTC example; for the RNN-T kernels U + 1 over one
32-row tile, T over one 32-frame block, target lengths 0 and a logit
length 0, and every form of the alpha and beta kernels up to U + 1 =
1024. Each kernel is held to its plain version for values, and the
layer and the CTC and RNN-T losses on the card to the same through the
plain versions on the CPU for gradients. Tolerances as in
``chip_smoke.py``: log-mel and BLSTM f32 1e-4; BLSTM bf16 one rounding
step of the carried h or dgates, propagated (stated per test); CTC f32
1e-5; RNN-T log-probs 1e-4, log-likelihood 1e-3, occupancies 1e-4,
joint gradients 1e-3 + 1e-3 |x|; the bf16 log-mel as ``chip_smoke.TOL``;
the RNN LM's gradients 1e-4 relative, its grouped scores bit for bit.
Data parallelism (``-k dp``) spawns its ranks as processes: two gloo ranks
over CUDA tensors against one process on their batches together, and an
NCCL group of one (gradients rtol 1e-4, atol 1e-5; the collectives' bits).
Sequence training and forced alignment (``-k "mwer or align"``): an MWER
step of a small f32 joint model on the card against the CPU over one fed
N-best (loss rtol 1e-5, gradients rtol 1e-4, atol 1e-5), the edit
distance's integers, and the Viterbi's frame labels (identical) and path
scores (1e-5) with chip_smoke's planted skip into a repeated label caught.
"""

import io
import json

import numpy as np
import pytest
import torch

from nabu_tpu_torch.data import audio_io
from nabu_tpu_torch.decoding.ctc_beam import ctc_prefix_beam_search
from nabu_tpu_torch.features import torch_frontend as tf
from nabu_tpu_torch.ops import blstm as blstm_ops
from nabu_tpu_torch.ops import kernels
from nabu_tpu_torch.ops import stft_mel as stft_ops
from nabu_tpu_torch.ops import transducer_fused as rnnt_ops


@pytest.fixture
def cuda_device():
    """A CUDA device, or a skip: decided when the test runs, never at
    import, so every worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _layer(rng, D, H, device, dtype, glorot=False):
    """Uniform +-0.3 weights, or with ``glorot`` the model's init scale
    for wx and wh (uniform +-sqrt(6 / (fan_in + fan_out)))."""
    def u(*shape, scale=None):
        if scale is None:
            scale = np.sqrt(6.0 / (shape[-2] + shape[-1])) if glorot else 0.3
        return torch.as_tensor(
            rng.uniform(-scale, scale, shape).astype(np.float32)).to(device, dtype)

    return {
        d: {"wx": u(D, 4 * H), "wh": u(H, 4 * H), "b": u(4 * H, scale=0.3)}
        for d in ("fw", "bw")
    }


def _readings(checks, tol_of):
    """-> ({name: (max |err|, max |ref|)} of the checks beyond their
    tolerance, the same of all checks)."""
    over, seen = {}, {}
    for name, (got, ref) in checks.items():
        got, ref = got.float().cpu().numpy(), ref.float().cpu().numpy()
        err = np.abs(got - ref)
        seen[name] = (float(err.max()), float(np.abs(ref).max()))
        if float((err - tol_of(name, ref)).max()) > 0:
            over[name] = seen[name]
    return over, seen


@pytest.mark.parametrize("rate,n_frames", [
    (16000.0, 297),        # N not a multiple of a block's 8 frames
    (16000.0, 1),
    (16000.0, 32 * 1026),  # a served batch of 32 at the 1026-frame bucket
    (32000.0, 97),         # W = 800 > nfft: the DFT rows past 512 are zero
])
def test_stft_mel_kernel_matches_plain(cuda_device, rate, n_frames):
    fp = tf.make_frontend_params(rate, nfft=512, nfilt=40, device=cuda_device)
    cossin, mel, mr = fp.folded()
    rng = np.random.default_rng(0)
    n = (n_frames - 1) * fp.frame_step + fp.frame_len
    sig = torch.as_tensor((1000.0 * rng.standard_normal(n)).astype(np.float32))
    frames = tf.frame_signal(sig, fp.frame_len, fp.frame_step, n_frames)
    frames = frames.contiguous().to(cuda_device)
    before = kernels.launch_counts()["stft_mel"]
    got = stft_ops.stft_mel(frames, cossin, mel, mr)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["stft_mel"] == before + 1
    ref = stft_ops.stft_mel_plain(frames, cossin, mel)
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), atol=1e-4, rtol=0)


def test_stft_mel_rejects_constants_beyond_its_design(cuda_device):
    """nfft = 1024 (512 bins) is beyond the kernel's design: the wrapper
    raises before any launch (and never falls back to the plain version)."""
    fp = tf.make_frontend_params(16000.0, nfft=1024, nfilt=40, device=cuda_device)
    cossin, mel, mr = fp.folded()
    frames = torch.zeros((8, fp.frame_len), device=cuda_device)
    before = kernels.launch_counts()["stft_mel"]
    with pytest.raises(ValueError, match="beyond the kernel's design"):
        stft_ops.stft_mel(frames, cossin, mel, mr)
    assert kernels.launch_counts()["stft_mel"] == before


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4), (torch.bfloat16, 4e-2)])
@pytest.mark.parametrize("D,H", [(11, 9), (16, 24), (80, 320)])
def test_blstm_kernels_match_plain(cuda_device, monkeypatch, dtype, atol, D, H):
    rng = np.random.default_rng(D + H)
    p = _layer(rng, D, H, cuda_device, dtype)
    T, lengths = 37, [37, 20, 8, 1]
    x = torch.as_tensor(rng.standard_normal((T, len(lengths), D)).astype(np.float32))
    x = x.to(cuda_device, dtype)
    lt = torch.as_tensor(lengths, dtype=torch.int32, device=cuda_device)
    before = kernels.launch_counts()
    got = blstm_ops.blstm_tm_apply(p, x, lt)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert after["blstm_proj"] == before["blstm_proj"] + 1
    assert after["blstm_recur"] == before["blstm_recur"] + 1
    # the same layer through the kernels' plain versions
    monkeypatch.setattr(blstm_ops, "blstm_proj", blstm_ops.blstm_proj_plain)
    monkeypatch.setattr(blstm_ops, "blstm_recur", blstm_ops.blstm_recur_plain)
    ref = blstm_ops.blstm_tm_apply(p, x, lt)
    assert kernels.launch_counts() == after
    assert got.dtype == dtype and got.shape == (T, 4, 2 * H)
    np.testing.assert_allclose(got.float().cpu().numpy(), ref.float().cpu().numpy(),
                               atol=atol, rtol=0)
    assert float(got[8:, 2].abs().max()) == 0.0  # padded frames are zeros


def _ctc_inputs(rng, device, T=37, V=7, L=150):
    """Ragged logit lengths with a length-1 utterance, a label of length 0,
    repeats, one infeasible example, and S = 2L + 1 > the block's threads."""
    logits = torch.as_tensor(rng.standard_normal((5, T, V)).astype(np.float32))
    tl = torch.as_tensor([T, 30, 1, 25, 3], dtype=torch.int32)
    labels = torch.as_tensor(rng.integers(0, V - 1, (5, L)), dtype=torch.int32)
    labels[3, :4] = torch.as_tensor([2, 2, 3, 3], dtype=torch.int32)
    labels[4, :3] = 1  # three repeats need 5 frames: infeasible in 3
    ll = torch.as_tensor([L, 12, 0, 10, 3], dtype=torch.int32)
    return logits.to(device), tl.to(device), labels.to(device), ll.to(device)


def test_ctc_kernels_match_plain(cuda_device):
    from nabu_tpu_torch.ops import ctc_batched as cb

    rng = np.random.default_rng(5)
    logits, tl, labels, ll = _ctc_inputs(rng, cuda_device)
    lp = torch.log_softmax(logits, -1).contiguous()
    before = kernels.launch_counts()
    alphas, lik = cb.ctc_alpha(lp, tl, labels, ll, 6)
    posts = cb.ctc_beta(lp, tl, labels, ll, alphas, lik, 6)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert after["ctc_alpha"] == before["ctc_alpha"] + 1
    assert after["ctc_beta"] == before["ctc_beta"] + 1
    ref_a, ref_l = cb.ctc_alpha_plain(lp, tl, labels, ll, 6)
    ref_p = cb.ctc_beta_plain(lp, tl, labels, ll, ref_a, ref_l, 6)
    finite = ref_a > -1e29  # NEG_INF lanes may drift by a few units
    np.testing.assert_allclose(alphas[finite].cpu().numpy(), ref_a[finite].cpu().numpy(),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(lik.cpu().numpy(), ref_l.cpu().numpy(), rtol=1e-5)
    assert float(lik[4]) == -1e4  # infeasible: clamped
    np.testing.assert_allclose(posts.cpu().numpy(), ref_p.cpu().numpy(), atol=1e-5)


def test_ctc_loss_gradient_on_card_matches_cpu(cuda_device):
    from nabu_tpu_torch.ops import ctc_batched as cb

    rng = np.random.default_rng(6)
    inputs = _ctc_inputs(rng, torch.device("cpu"))
    out = []
    for dev in (cuda_device, torch.device("cpu")):
        logits, tl, labels, ll = (t.to(dev) for t in inputs)
        logits.requires_grad_(True)
        nll = cb.ctc_loss_batched(logits, tl, labels, ll)
        nll.sum().backward()
        out.append((nll.detach().cpu().numpy(), logits.grad.cpu().numpy()))
    np.testing.assert_allclose(out[0][0], out[1][0], rtol=1e-5)
    np.testing.assert_allclose(out[0][1], out[1][1], atol=1e-5)
    assert np.abs(out[0][1][4]).max() == 0.0  # infeasible: zero gradient


def _ctc_batch(rng, device, T, V, L, tl, ll, scale=1.0):
    """Log-probs of seeded logits with the given logit and label lengths,
    random labels (adjacent repeats at the start of the second label)."""
    B = len(tl)
    logits = torch.as_tensor(scale * rng.standard_normal((B, T, V)).astype(np.float32))
    labels = torch.as_tensor(rng.integers(0, V - 1, (B, L)), dtype=torch.int32)
    if B > 1 and L >= 4:
        labels[1, :4] = torch.as_tensor([3, 3, 2, 2], dtype=torch.int32)
    lp = torch.log_softmax(logits, -1).contiguous().to(device)
    return (lp, torch.as_tensor(tl, dtype=torch.int32).to(device), labels.to(device),
            torch.as_tensor(ll, dtype=torch.int32).to(device))


def _ctc_held_to_plain(cb, lp, tl, labels, ll, blank):
    """Both kernels at their plan against the plain versions (chip_smoke's
    card-test tolerances: ll rtol 1e-5, finite alphas rtol 1e-5 + 1e-4,
    posteriors 1e-5), one launch of each counted, and a second launch of
    each giving the first one's bits. -> (alphas, ll, posteriors)."""
    before = kernels.launch_counts()
    alphas, lik = cb.ctc_alpha(lp, tl, labels, ll, blank)
    posts = cb.ctc_beta(lp, tl, labels, ll, alphas, lik, blank)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert after["ctc_alpha"] == before["ctc_alpha"] + 1
    assert after["ctc_beta"] == before["ctc_beta"] + 1
    ref_a, ref_l = cb.ctc_alpha_plain(lp, tl, labels, ll, blank)
    ref_p = cb.ctc_beta_plain(lp, tl, labels, ll, ref_a, ref_l, blank)
    finite = ref_a > -1e29  # NEG_INF lanes may drift by a few units
    np.testing.assert_allclose(alphas[finite].cpu().numpy(), ref_a[finite].cpu().numpy(),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(lik.cpu().numpy(), ref_l.cpu().numpy(), rtol=1e-5)
    np.testing.assert_allclose(posts.cpu().numpy(), ref_p.cpu().numpy(), atol=1e-5)
    again_a, again_l = cb.ctc_alpha(lp, tl, labels, ll, blank)
    assert torch.equal(again_a, alphas) and torch.equal(again_l, lik)
    assert torch.equal(cb.ctc_beta(lp, tl, labels, ll, alphas, lik, blank), posts)
    return alphas, lik, posts


@pytest.mark.parametrize("L,forced,form", [
    (20, None, (2, 1)),      # one chain warp
    (120, 8, (8, 1)),        # S = 241 on one warp of 8 lanes a thread
    (150, None, (2, 5)),     # several chain warps (S = 301)
    (150, 4, (4, 3)),
    (1200, None, (16, 5)),   # S = 2401: past 8 warps of 8 lanes a thread
    (8939, None, (32, 18)),  # the largest form: S = 17879, one-frame chunks
])
def test_ctc_kernels_each_form(cuda_device, monkeypatch, L, forced, form):
    """Each form of ``ctc_plan`` against the plain versions: ragged logit
    lengths with 0 and 1, a label of length 0, an infeasible example.
    A form forced in place of the plan's gives the plan's bits."""
    from nabu_tpu_torch.ops import ctc_batched as cb

    rng = np.random.default_rng(L)
    T, V = 37, 7
    lp, tl, labels, ll = _ctc_batch(rng, cuda_device, T, V, L, [T, 30, 1, 0, 25, 3],
                                    [L, 12, 0, 3, 10, 3])
    labels[5, :3] = 1  # three repeats need 5 frames: infeasible in 3
    planned = _ctc_held_to_plain(cb, lp, tl, labels, ll, V - 1)
    assert float(planned[1][5]) == -1e4
    plan = cb.ctc_plan(2 * L + 1, (forced,) if forced else cb.CTC_FORMS)
    assert plan[:2] == form
    if forced:
        monkeypatch.setattr(cb, "ctc_plan", lambda S, forms=None: plan)
        for x, y in zip(_ctc_held_to_plain(cb, lp, tl, labels, ll, V - 1), planned):
            assert torch.equal(x, y)


def test_ctc_kernels_at_the_bench_shape(cuda_device):
    """The bench line's CTC loss: B = 32, T = 1000, V = 31, L = 100, full
    lengths (S = 201)."""
    from nabu_tpu_torch.ops import ctc_batched as cb

    rng = np.random.default_rng(11)
    args = _ctc_batch(rng, cuda_device, 1000, 31, 100, [1000] * 32, [100] * 32, scale=3.0)
    _ctc_held_to_plain(cb, *args, 30)


def test_ctc_kernels_with_a_large_vocabulary(cuda_device):
    """V = 5000, as a BPE vocabulary: the gather reads S values a frame,
    whatever V is."""
    from nabu_tpu_torch.ops import ctc_batched as cb

    rng = np.random.default_rng(12)
    args = _ctc_batch(rng, cuda_device, 60, 5000, 24, [60, 41, 33, 1], [24, 20, 0, 1])
    _ctc_held_to_plain(cb, *args, 4999)


def test_ctc_log_matches_logf_bit_for_bit(cuda_device):
    """The kernels' logarithm gives logf's bits on every float of [1, 4),
    the range of lse3's sums."""
    from nabu_tpu_torch.ops import ctc_batched as cb

    assert cb.ctc_log_mismatches(cuda_device) == 0


def test_ctc_probe_keeps_the_bits_and_counts_no_launch(cuda_device):
    """The step probe's builds give the kernels' bits, count no launch and
    record each block's steps: tlen for alpha, tlen - 1 for beta."""
    from nabu_tpu_torch.ops import ctc_batched as cb

    rng = np.random.default_rng(14)
    tl = [70, 33, 1, 0]
    args = _ctc_batch(rng, cuda_device, 70, 9, 40, tl, [30, 12, 0, 2])
    alphas, lik = cb.ctc_alpha(*args, 8)
    posts = cb.ctc_beta(*args, alphas, lik, 8)
    before = kernels.launch_counts()
    pa, pl, ca = cb.ctc_alpha_probe(*args, 8)
    pp, cbeta = cb.ctc_beta_probe(*args, alphas, lik, 8)
    torch.cuda.synchronize()
    assert kernels.launch_counts() == before
    assert torch.equal(pa, alphas) and torch.equal(pl, lik) and torch.equal(pp, posts)
    assert ca[:, -1].tolist() == tl and cbeta[:, -1].tolist() == [69, 32, 0, 0]
    assert int(ca[0, :-1].sum()) > 0 and int(cbeta[0, :-1].sum()) > 0


def test_ctc_kernels_at_chunk_boundaries(cuda_device):
    """T not a multiple of the plan's chunk, logit lengths at TC - 1, TC,
    TC + 1 and TC + 2 (the beta walk's chunks count from tlen - 1), 0
    and 1."""
    from nabu_tpu_torch.ops import ctc_batched as cb

    rng = np.random.default_rng(13)
    L = 12
    tc = cb.ctc_plan(2 * L + 1)[3]
    T = 3 * tc + 5
    tl = [T, tc - 1, tc, tc + 1, tc + 2, 2 * tc, 2 * tc + 1, 0, 1]
    args = _ctc_batch(rng, cuda_device, T, 9, L, tl, [L, 8, 9, 10, 11, 12, 12, 2, 0])
    _ctc_held_to_plain(cb, *args, 8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,H", [(11, 9), (16, 24), (80, 320)])
def test_blstm_backward_kernels_match_plain(cuda_device, dtype, D, H):
    """Each training kernel against its plain version on the same inputs,
    and a planted fault per output that the tolerance must reject: the
    residual-writing forward (h of 8 units read one step late, c stored
    one step late, gates stored with the forget bias folded in), the
    backward chain (the dgates of 8 units read one step stale) and the
    products (the last term of the reduction dropped). wx and wh at the
    model's glorot scale."""
    import chip_smoke

    rng = np.random.default_rng(D * H)
    T, lengths = 37, [37, 20, 8, 1]
    B = len(lengths)
    lt = torch.as_tensor(lengths, dtype=torch.int32, device=cuda_device)

    def u(*shape, scale=1.0):
        return torch.as_tensor(
            rng.uniform(-scale, scale, shape).astype(np.float32)).to(cuda_device, dtype)

    def glorot(*shape):
        return u(*shape, scale=float(np.sqrt(6.0 / (shape[-2] + shape[-1]))))

    xw, wh, wx = u(2, T, B, 4 * H), glorot(2, H, 4 * H), glorot(2, D, 4 * H)
    x, gy = u(T, B, D), u(T, B, 2 * H)
    y, c, g = blstm_ops.blstm_recur_train(xw, lt, wh)
    ry, rc, rg = blstm_ops.blstm_recur_train_plain(xw, lt, wh)
    # the chain on the plain forward's residuals, so each kernel sees the
    # same inputs as its plain version; the products on uniform dgates
    dg = blstm_ops.blstm_bwd_recur(rg, rc, gy, lt, wh)
    rdg = blstm_ops.blstm_bwd_recur_plain(rg, rc, gy, lt, wh)
    dgr = u(2, T, B, 4 * H)
    dwx, db = blstm_ops.blstm_bwd_dwx(x, dgr)
    ref_dwx, ref_db = blstm_ops.blstm_bwd_dwx_plain(x, dgr)
    checks = {"y": (y, ry), "c": (c, rc), "gates": (g, rg), "dgates": (dg, rdg),
              "dx": (blstm_ops.blstm_bwd_dx(dgr, wx), blstm_ops.blstm_bwd_dx_plain(dgr, wx)),
              "dwx": (dwx, ref_dwx), "db": (db, ref_db),
              "dwh": (blstm_ops.blstm_bwd_dwh(ry, dgr), blstm_ops.blstm_bwd_dwh_plain(ry, dgr))}
    torch.cuda.synchronize()

    # planted faults, each through the plain arithmetic
    c_late = torch.zeros_like(rc)
    c_late[0, 1:], c_late[1, :-1] = rc[0, :-1], rc[1, 1:]
    g_bias = rg.clone()
    g_bias[..., H: 2 * H] += 1.0
    last = lengths[0] - 1  # the last valid token, (t, b) = (36, 0)
    dg_col, dg_tok = dgr.clone(), dgr.clone()
    dg_col[..., -1] = 0
    dg_tok[:, last, 0] = 0
    x_tok = x.clone()
    x_tok[last, 0] = 0
    faults = {
        "y": (chip_smoke.stale_recur(torch)(xw, lt, wh), ry),
        "c": (c_late, rc), "gates": (g_bias, rg),
        "dgates": (chip_smoke.faulty_chain(torch, stale_units=8)(rg, rc, gy, lt, wh), rdg),
        "dx": (blstm_ops.blstm_bwd_dx_plain(dg_col, wx), checks["dx"][1]),
        "dwx": (blstm_ops.blstm_bwd_dwx_plain(x_tok, dgr)[0], ref_dwx),
        "db": (blstm_ops.blstm_bwd_dwx_plain(x, dg_tok)[1], ref_db),
        "dwh": (blstm_ops.blstm_bwd_dwh_plain(ry, dg_tok), checks["dwh"][1]),
    }

    # f32: sums in another order. bf16: outputs one rounding step apart,
    # and in the recurrences such steps in the carried h or dgates
    # propagate (relative to the largest value); c and the gates are f32
    # stores computed from those h
    def tol(name, ref):
        if dtype == torch.float32:
            return 1e-4 * (1.0 + np.abs(ref))
        if name == "y":
            return 3e-2 * max(1.0, float(np.abs(ref).max()))
        if name == "dgates":
            return 2e-2 * max(1.0, float(np.abs(ref).max()))
        if name in ("c", "gates"):
            return 1e-2 * max(1.0, float(np.abs(ref).max()))
        return 1e-2 * (1.0 + np.abs(ref))

    over, sound = _readings(checks, tol)
    over_f, fault = _readings(faults, tol)
    passed = sorted(set(faults) - set(over_f))
    assert not over and not passed, {"beyond tolerance": over, "faults passing": passed,
                                     "sound": sound, "fault": fault}


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("D,H", [(11, 9), (80, 320)])
def test_blstm_layer_gradients_on_card_match_cpu(cuda_device, monkeypatch, dtype, rtol, D, H):
    """BLSTMLayer through the kernels on the card against the same layer
    through the plain versions on the CPU: output and every gradient,
    lengths [T, mid, 8, 1], glorot-scale weights. A planted fault, the
    bw direction's dx left out of the sum over directions, must fail the
    tolerance."""
    rng = np.random.default_rng(D + 7 * H)
    T, lengths = 37, [37, 20, 8, 1]
    p32 = _layer(rng, D, H, "cpu", torch.float32, glorot=True)
    x32 = torch.as_tensor(rng.standard_normal((T, len(lengths), D)).astype(np.float32))
    gy = torch.as_tensor(rng.standard_normal((T, len(lengths), 2 * H)).astype(np.float32))

    def run(dev):
        p = {d: {k: v.to(dev, dtype, copy=True).requires_grad_(True) for k, v in q.items()}
             for d, q in p32.items()}
        x = x32.to(dev, dtype, copy=True).requires_grad_(True)
        y = blstm_ops.blstm_tm_apply(p, x, torch.as_tensor(lengths, dtype=torch.int32))
        (y.float() * gy.to(dev)).sum().backward()
        grads = [x.grad] + [p[d][k].grad for d in ("fw", "bw") for k in ("wx", "wh", "b")]
        return [y] + grads

    before = kernels.launch_counts()
    got = run(cuda_device)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    for name in ("blstm_proj", "blstm_recur_train", "blstm_bwd_recur",
                 "blstm_bwd_dx", "blstm_bwd_dwx", "blstm_bwd_dwh"):
        assert after[name] == before[name] + 1, name
    ref = run(torch.device("cpu"))
    dx_kernel = blstm_ops.blstm_bwd_dx

    def fw_dx_only(dg, wx):
        dx = dx_kernel(dg, wx)
        dx[1] = 0
        return dx

    monkeypatch.setattr(blstm_ops, "blstm_bwd_dx", fw_dx_only)
    faulty = run(cuda_device)
    names = ["y", "dx"] + [f"{d}/{k}" for d in ("fw", "bw") for k in ("wx", "wh", "b")]

    def tol(name, ref):
        return rtol * (np.abs(ref) + np.abs(ref).max())

    over, sound = _readings({n: (a.detach(), b.detach()) for n, a, b in zip(names, got, ref)},
                            tol)
    over_f, fault = _readings({"dx": (faulty[1], ref[1])}, tol)
    assert not over and over_f, {"beyond tolerance": over, "sound": sound, "fault": fault}


def _chain_inputs(rng, device, dtype, T, B, H):
    """Ragged lengths from T down, f32 gates and carries at scale 2, gy,
    and wh at the model's glorot scale, for the v2 chain."""
    def u(*shape, scale=1.0, dt=dtype):
        return torch.as_tensor(
            rng.uniform(-scale, scale, shape).astype(np.float32)).to(device, dt)

    lengths = torch.as_tensor(_lengths(T, B), dtype=torch.int32, device=device)
    gates = u(2, T, B, 4 * H, scale=2.0, dt=torch.float32)
    c = u(2, T, B, H, scale=2.0, dt=torch.float32)
    wh = u(2, H, 4 * H, scale=float(np.sqrt(6.0 / (5 * H))))
    return gates, c, u(T, B, 2 * H), lengths, wh


def _chain_excess(got, ref, tag):
    import chip_smoke

    atol, rtol = chip_smoke.TOL[("blstm_bwd_recur", tag)]
    return float(((got.float() - ref.float()).abs() - atol - rtol * ref.float().abs()).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,B,H,form", [
    (64, 4, 320, (8, 1)),    # one row group of 8 units
    (64, 32, 320, (16, 1)),  # dblstm_ctc_wsj / rnnt_char_wsj: 2 groups x 20 x 2 blocks
    (40, 36, 320, (16, 1)),  # the old chain's limit at each width
    (40, 47, 256, (16, 1)),
    (40, 20, 512, (16, 1)),
    (24, 48, 320, (16, 1)),  # the new limits: 3 groups x 20 x 2, 128 blocks
    (24, 32, 512, (16, 1)),
])
def test_blstm_chain_matches_plain_at_its_plans(cuda_device, dtype, T, B, H, form):
    """The v2 chain at the split ``chain_plan`` picks for each shape,
    ragged lengths: within chip_smoke.py's tolerance of the plain version,
    and a second launch gives the first one's bits."""
    tag = "bf16" if dtype == torch.bfloat16 else "f32"
    assert blstm_ops.chain_plan(B, H)[:2] == form
    args = _chain_inputs(np.random.default_rng(T + B + H), cuda_device, dtype, T, B, H)
    before = kernels.launch_counts()["blstm_bwd_recur"]
    first = blstm_ops.blstm_bwd_recur(*args)
    second = blstm_ops.blstm_bwd_recur(*args)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["blstm_bwd_recur"] == before + 2
    assert first.dtype == dtype and torch.equal(first, second)
    excess = _chain_excess(first, blstm_ops.blstm_bwd_recur_plain(*args), tag)
    assert excess <= 0, excess


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,B,H", [(37, 37, 24), (29, 33, 9)])
def test_blstm_chain_forms_give_one_result(cuda_device, monkeypatch, dtype, T, B, H):
    """Every form of the chain (units x 16 mt rows a block), forced at one
    shape: each within the tolerance of the plain version, all with the
    same bits (a row's sums do not depend on the form); H = 9 (rows of 36
    values: 9 quads, a partial unit group)."""
    tag = "bf16" if dtype == torch.bfloat16 else "f32"
    args = _chain_inputs(np.random.default_rng(T * B + H), cuda_device, dtype, T, B, H)
    ref = blstm_ops.blstm_bwd_recur_plain(*args)
    outs = []
    for units, mt in blstm_ops.CHAIN_FORMS:
        blocks = 2 * -(-B // (16 * mt)) * -(-H // units)
        form = (units, mt, blocks, blstm_ops.chain_bytes(H, units, mt))
        monkeypatch.setattr(blstm_ops, "chain_plan", lambda *_, f=form: f)
        outs.append(blstm_ops.blstm_bwd_recur(*args))
        excess = _chain_excess(outs[-1], ref, tag)
        assert excess <= 0, (units, mt, excess)
    assert all(torch.equal(o, outs[0]) for o in outs[1:])


def test_blstm_chain_rejects_shapes_beyond_its_plan(cuda_device):
    """B = 49 at H = 320: no split fits the card's SMs one block an SM;
    the wrapper raises before any launch."""
    args = _chain_inputs(np.random.default_rng(3), cuda_device, torch.bfloat16, 3, 49, 320)
    before = kernels.launch_counts()
    with pytest.raises(ValueError, match="beyond the chain's design"):
        blstm_ops.blstm_bwd_recur(*args)
    assert kernels.launch_counts() == before


def _walk_inputs(rng, device, dtype, T, B, H):
    """Ragged lengths from T down, xw uniform in [-1, 1] and wh at the
    model's glorot scale, for the v2 walk."""
    def u(*shape, scale=1.0):
        return torch.as_tensor(
            rng.uniform(-scale, scale, shape).astype(np.float32)).to(device, dtype)

    lengths = torch.as_tensor(_lengths(T, B), dtype=torch.int32, device=device)
    return u(2, T, B, 4 * H), lengths, u(2, H, 4 * H, scale=float(np.sqrt(6.0 / (5 * H))))


def _walk_excess(got, ref, tag):
    """The largest excess of the training walk's outputs over chip_smoke.py's
    tolerances: h at the walk's, c and the gates at the stores'."""
    import chip_smoke

    tols = [chip_smoke.TOL[("blstm_recur", tag)]] + 2 * [
        chip_smoke.TOL[("blstm_recur_train_stores", tag)]]
    return max(float(((g.float() - r.float()).abs() - atol - rtol * r.float().abs()).max())
               for g, r, (atol, rtol) in zip(got, ref, tols))


# T in {1, 3, 67} at the recipes' widths, their batches and the limits at
# 320 and 512, and the tests' narrow layers (H = 9, 12: rows of whole quads
# but the last, a partial unit group); then a shape of each later form
WALK_SHAPES = [(T, B, H) for T in (1, 3, 67)
               for B, H in ((1, 9), (17, 12), (32, 320), (48, 320), (17, 512), (32, 512))]
WALK_SHAPES += [(3, 49, 260), (3, 1100, 12)]  # 8 units x 2 m-tiles, 4 x 4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,B,H", WALK_SHAPES)
def test_blstm_walk_matches_plain_at_its_plans(cuda_device, dtype, T, B, H):
    """The v2 walk, inference and training forms, at the split
    ``walk_plan`` picks for each shape, ragged lengths: within
    chip_smoke.py's tolerances of the plain version; a second launch gives
    the first one's bits, and both forms give one h."""
    tag = "bf16" if dtype == torch.bfloat16 else "f32"
    plan = blstm_ops.walk_plan(B, H)
    assert plan is not None and (plan[0], plan[1]) in blstm_ops.WALK_FORMS
    args = _walk_inputs(np.random.default_rng(T + B + H), cuda_device, dtype, T, B, H)
    before = kernels.launch_counts()
    y = [blstm_ops.blstm_recur(*args) for _ in range(2)]
    train = [blstm_ops.blstm_recur_train(*args) for _ in range(2)]
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert after["blstm_recur"] == before["blstm_recur"] + 2
    assert after["blstm_recur_train"] == before["blstm_recur_train"] + 2
    assert y[0].dtype == dtype and torch.equal(y[0], y[1])
    assert all(torch.equal(a, b) for a, b in zip(*train))
    assert torch.equal(train[0][0], y[0])
    excess = _walk_excess(train[0], blstm_ops.blstm_recur_train_plain(*args), tag)
    assert excess <= 0, (plan, excess)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,B,H", [(37, 37, 24), (29, 33, 9)])
def test_blstm_walk_forms_give_one_result(cuda_device, monkeypatch, dtype, T, B, H):
    """Every form of the walk (units x 16 mt rows a block), forced at one
    shape: each within the tolerances of the plain version, all with the
    same bits (a row's sums do not depend on the form); H = 9 (rows of 3
    quads, the last one partial, a partial unit group)."""
    tag = "bf16" if dtype == torch.bfloat16 else "f32"
    args = _walk_inputs(np.random.default_rng(T * B + H), cuda_device, dtype, T, B, H)
    ref = blstm_ops.blstm_recur_train_plain(*args)
    outs = []
    for units, mt in blstm_ops.WALK_FORMS:
        blocks = 2 * -(-B // (16 * mt)) * -(-H // units)
        form = (units, mt, blocks, blstm_ops.walk_bytes(H, units, mt))
        monkeypatch.setattr(blstm_ops, "walk_plan", lambda *_, f=form: f)
        outs.append(blstm_ops.blstm_recur_train(*args))
        excess = _walk_excess(outs[-1], ref, tag)
        assert excess <= 0, (units, mt, excess)
    assert all(torch.equal(a, b) for o in outs[1:] for a, b in zip(o, outs[0]))


@pytest.mark.parametrize("B,H", [(49, 320), (65, 256), (33, 512)])
def test_blstm_walk_rejects_shapes_beyond_its_plan(cuda_device, B, H):
    """One batch past the walk's limits (48 at H = 320, 64 at 256, 32 at
    512): no split fits the card's SMs one block an SM; both forms raise
    before any launch."""
    args = _walk_inputs(np.random.default_rng(3), cuda_device, torch.bfloat16, 3, B, H)
    before = kernels.launch_counts()
    for walk in (blstm_ops.blstm_recur, blstm_ops.blstm_recur_train):
        with pytest.raises(ValueError, match="beyond the walk's design"):
            walk(*args)
    assert kernels.launch_counts() == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_blstm_walk_probe_keeps_the_walks_bits(cuda_device, dtype):
    """The step probe's build of the training walk gives the walk's bits,
    counts no launch, and sums positive cycles of every part in every
    block (T = 9, B = 32, H = 320: 80 blocks)."""
    args = _walk_inputs(np.random.default_rng(5), cuda_device, dtype, 9, 32, 320)
    want = blstm_ops.blstm_recur_train(*args)
    before = kernels.launch_counts()
    *got, cycles = blstm_ops.blstm_recur_train_probe(*args)
    torch.cuda.synchronize()
    assert kernels.launch_counts() == before
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert tuple(cycles.shape) == (80, len(blstm_ops.PROBE_PARTS))
    assert bool((cycles > 0).all()), cycles


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("B,H", [(32, 512), (48, 320)])
def test_shapes_moved_to_v2_match_cpu(cuda_device, dtype, rtol, B, H):
    """Shapes that left v1 for v2 with the chain's row groups (las_large's
    validation batch, B = 32 at H = 512; B = 37-48 at H = 320):
    blstm_tm_apply forward and backward through the v2 kernels on the
    card against the same layer on the CPU (plain versions), ragged
    lengths; output and every gradient within the layer test's
    tolerance."""
    assert blstm_ops.kernel_family(B, H) == "v2"
    rng = np.random.default_rng(B + H)
    T, D = 24, 40
    lengths = _lengths(T, B)
    p32 = _layer(rng, D, H, "cpu", torch.float32, glorot=True)
    x32 = torch.as_tensor(rng.standard_normal((T, B, D)).astype(np.float32))
    gy = torch.as_tensor(rng.standard_normal((T, B, 2 * H)).astype(np.float32))

    def run(dev):
        p = {d: {k: v.to(dev, dtype, copy=True).requires_grad_(True) for k, v in q.items()}
             for d, q in p32.items()}
        x = x32.to(dev, dtype, copy=True).requires_grad_(True)
        y = blstm_ops.blstm_tm_apply(p, x, torch.as_tensor(lengths, dtype=torch.int32))
        (y.float() * gy.to(dev)).sum().backward()
        return [y, x.grad] + [p[d][k].grad for d in ("fw", "bw") for k in ("wx", "wh", "b")]

    kernels.reset_launch_counts()
    got = run(cuda_device)
    torch.cuda.synchronize()
    counts = {k: v for k, v in kernels.launch_counts().items() if v}
    assert counts == {"blstm_proj": 1, "blstm_recur_train": 1, "blstm_bwd_recur": 1,
                      "blstm_bwd_dx": 1, "blstm_bwd_dwx": 1, "blstm_bwd_dwh": 1}, counts
    ref = run(torch.device("cpu"))
    names = ["y", "dx"] + [f"{d}/{k}" for d in ("fw", "bw") for k in ("wx", "wh", "b")]

    def tol(name, r):
        return rtol * (np.abs(r) + np.abs(r).max())

    over, sound = _readings({n: (a.detach(), b.detach()) for n, a, b in zip(names, got, ref)},
                            tol)
    assert not over, {"beyond tolerance": over, "sound": sound}


def test_untagged_recipe_trains_through_the_kernels_on_card(cuda_device, tmp_path):
    """A dblstm_ctc model that sets no ``use_pallas`` still runs the BLSTM
    and CTC kernels on the card, forward and backward; a forward-only
    stack runs the LSTM kernels (walk, chain, dwh) and no BLSTM kernel."""
    from nabu_tpu_torch.config import ConfigFile
    from nabu_tpu_torch.models.model import build_model
    from nabu_tpu_torch.ops.losses import make_loss_computer
    from nabu_tpu_torch.params import flatten, unflatten

    cfg = ("[encoder]\nencoder = dblstm\nnum_layers = 2\nnum_units = 12\n"
           "bidirectional = {}\n[decoder]\ndecoder = linear_ctc\n")
    rng = np.random.default_rng(8)
    lengths = [20, 13, 1]
    batch = {
        "features": torch.as_tensor(rng.standard_normal((3, 20, 6)).astype(np.float32)),
        "feature_lengths": torch.as_tensor(lengths, dtype=torch.int32),
        "targets": torch.as_tensor(rng.integers(0, 4, (3, 5)), dtype=torch.int32),
        "target_lengths": torch.as_tensor([5, 3, 0], dtype=torch.int32),
        "example_mask": torch.ones(3),
    }
    batch = {k: v.to(cuda_device) for k, v in batch.items()}
    for bidirectional in ("true", "false"):
        path = tmp_path / f"model_{bidirectional}.cfg"
        path.write_text(cfg.format(bidirectional))
        model = build_model(ConfigFile.read(str(path)), 6, 4)
        flat = {k: v.to(cuda_device).requires_grad_(True)
                for k, v in flatten(model.init(torch.Generator().manual_seed(0))).items()}
        loss_fn = make_loss_computer(model)
        kernels.reset_launch_counts()
        loss, _ = loss_fn(unflatten(flat), batch, None, False)
        grads = torch.autograd.grad(loss, list(flat.values()))
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        assert all(bool(torch.isfinite(g).all()) for g in grads)
        blstm = ("blstm_proj", "blstm_recur_train", "blstm_bwd_recur", "blstm_bwd_dx",
                 "blstm_bwd_dwx", "blstm_bwd_dwh")
        lstm = ("lstm_fwd_train", "lstm_bwd_recur", "lstm_bwd_dwh")
        ran, idle = (blstm, lstm) if bidirectional == "true" else (lstm, blstm)
        for name in ran + ("ctc_alpha", "ctc_beta"):
            assert counts[name] > 0, (name, counts)
        for name in idle:
            assert counts[name] == 0, (name, counts)


def test_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, device=cuda_device, dtype=dtype)

    with pytest.raises(TypeError):  # fp16 is never taken
        blstm_ops.blstm_proj(z(8, 4, dtype=torch.float16),
                             z(2, 4, 8, dtype=torch.float16), z(2, 8, dtype=torch.float16))
    with pytest.raises(ValueError):
        blstm_ops.blstm_proj(z(8, 4), z(2, 3, 8), z(2, 8))
    with pytest.raises(ValueError):  # not contiguous
        blstm_ops.blstm_proj(z(4, 8).t(), z(2, 4, 8), z(2, 8))
    with pytest.raises(TypeError):
        blstm_ops.blstm_recur(z(2, 5, 3, 8), torch.zeros(3, dtype=torch.int64,
                                                         device=cuda_device), z(2, 2, 8))
    with pytest.raises(TypeError):
        stft_ops.stft_mel(z(4, 400, dtype=torch.bfloat16), z(400, 512), z(256, 40),
                          stft_ops.mel_ranges(z(256, 40)))


def test_beam_search_on_card_matches_cpu(cuda_device):
    rng = np.random.default_rng(4)
    lp = torch.log_softmax(torch.as_tensor(
        3.0 * rng.standard_normal((3, 40, 29)).astype(np.float32)), -1)
    lengths = torch.as_tensor([40, 31, 7], dtype=torch.int32)
    cpu = ctc_prefix_beam_search(lp, lengths, 16, 28)
    gpu = ctc_prefix_beam_search(lp.to(cuda_device), lengths.to(cuda_device), 16, 28)
    for a, b in zip(cpu[:2], gpu[:2]):
        np.testing.assert_array_equal(a.numpy(), b.cpu().numpy())
    np.testing.assert_allclose(cpu[2].numpy(), gpu[2].cpu().numpy(), atol=1e-4)


def _artifact(d, seed=0):
    """A small dblstm-ctc export artifact with seeded numpy weights."""
    d.mkdir()
    (d / "model.cfg").write_text(
        "[encoder]\nencoder = dblstm\nnum_layers = 2\nnum_units = 16\n"
        "use_pallas = true\n[decoder]\ndecoder = linear_ctc\n")
    (d / "frontend.cfg").write_text(
        "[features]\nfeature = fbank\nnfilt = 10\ndynamic = delta\n"
        "[targets]\nprocessor = text\nalphabet = a b c\ntokenizer = word\n")
    (d / "recognizer.cfg").write_text(
        "[recognizer]\nrecognizer = ctc_beam\nbeam_width = 4\n")
    (d / "manifest.json").write_text(json.dumps({"input_dim": 20, "num_labels": 3}))
    rng = np.random.default_rng(seed)
    flat, din = {}, 20
    for i in range(2):
        for dr in ("fw", "bw"):
            for k, shape in (("wx", (din, 64)), ("wh", (16, 64)), ("b", (64,))):
                flat[f"encoder/layer_{i}/{dr}/{k}"] = rng.uniform(-0.3, 0.3, shape).astype(np.float32)
        din = 32
    flat["decoders/decoder/out/w"] = rng.uniform(-0.3, 0.3, (32, 4)).astype(np.float32)
    flat["decoders/decoder/out/b"] = rng.uniform(-0.3, 0.3, (4,)).astype(np.float32)
    np.savez(str(d / "params.npz"), **flat)
    return str(d)


def test_serving_on_card_matches_cpu(cuda_device, tmp_path):
    from nabu_tpu_torch.serving import load_exported, serve

    art = _artifact(tmp_path / "export")
    rng = np.random.default_rng(1)
    lines = []
    for i in range(5):
        n = int(rng.integers(4000, 20000))
        t = np.arange(n) / 16000.0
        sig = 6000.0 * np.sin(2 * np.pi * rng.uniform(200, 3000) * t)
        path = tmp_path / f"utt{i}.wav"
        audio_io.write_wav(str(path), sig + 50.0 * rng.standard_normal(n), 16000)
        lines.append(f"utt{i} {path}")
    paths = [line.split()[1] for line in lines]
    want = load_exported(art, batch_size=4, device="cpu").recognize_files(paths)
    model = load_exported(art, batch_size=4)
    assert model.device.type == "cuda"
    kernels.reset_launch_counts()
    out = io.StringIO()
    assert serve(art, io.StringIO("\n".join(lines) + "\n"), out, batch_size=4,
                 model=model) == 5
    counts = kernels.launch_counts()
    assert all(counts[name] > 0 for name in ("stft_mel", "blstm_proj", "blstm_recur")), counts
    got = [line.split(" ", 1)[1] if " " in line else "" for line in out.getvalue().splitlines()]
    assert got == want


def _rnnt_inputs(rng, device, B, T, U, J, V):
    """bf16 projections, ragged lengths: the first lane full, a target
    length 0, a logit length 0 (its lattice is empty)."""
    tl = rng.integers(1, T + 1, B)
    ul = rng.integers(0, U + 1, B)
    tl[0], ul[0], ul[1], tl[2] = T, U, 0, 0

    def f(a, dtype=torch.float32):
        return torch.as_tensor(a.astype(np.float32)).to(device, dtype)

    return (f(0.5 * rng.standard_normal((B, T, J)), torch.bfloat16),
            f(0.5 * rng.standard_normal((B, U + 1, J)), torch.bfloat16),
            f(0.3 * rng.standard_normal((J, V)), torch.bfloat16),
            f(0.1 * rng.standard_normal(V)),
            torch.as_tensor(rng.integers(0, V - 1, (B, U)), dtype=torch.int32, device=device),
            torch.as_tensor(ul, dtype=torch.int32, device=device),
            torch.as_tensor(tl, dtype=torch.int32, device=device))


@pytest.mark.parametrize("B,T,U,J,V", [
    (4, 9, 5, 16, 6), (5, 37, 40, 48, 29),
    # the joint backward's chunks (F = 32): every lattice shorter than a
    # chunk; T' = 70 not a multiple of F with U + 1 = 131 over 128 (five u
    # tiles) at the narrowest joint; the widest joint and vocabulary with a
    # one-frame last chunk
    (4, 20, 10, 320, 29), (6, 70, 130, 16, 29), (3, 33, 20, 368, 32)])
def test_rnnt_kernels_match_plain(cuda_device, B, T, U, J, V):
    """Each RNN-T kernel against its plain version on the same inputs, and
    each planted fault of chip_smoke.py rejected by the tolerance: the
    last of the J products dropped (joint forward), the emit term dropped
    from the prefix and, in the anti-diagonal walk, the lane below read
    one diagonal late (alpha), the blank occupancy read with beta[t] (beta),
    each lane's last frame left out of d_pred_proj (joint backward). The
    joint backward repeats bit for bit across two launches (fixed-order
    sums over its chunks)."""
    import chip_smoke

    rng = np.random.default_rng(B * T)
    joint = _rnnt_inputs(rng, cuda_device, B, T, U, J, V)
    lens = (joint[6], joint[5])
    blank = V - 1
    before = kernels.launch_counts()
    lpb, lpe = rnnt_ops.rnnt_joint_fwd(*joint, blank)
    rb, re = rnnt_ops.rnnt_joint_fwd_plain(*joint, blank)
    alphas, ll = rnnt_ops.rnnt_alpha(rb, re, *lens)
    ra, rll = rnnt_ops.rnnt_alpha_plain(rb, re, *lens)
    g = torch.linspace(0.5, 1.5, B, device=cuda_device)
    gb, ge = rnnt_ops.rnnt_beta(rb, re, ra, rll, g, *lens)
    rgb, rge = rnnt_ops.rnnt_beta_plain(rb, re, ra, rll, g, *lens)
    bwd = (*joint, rgb, rge, blank)
    grads = rnnt_ops.rnnt_joint_bwd(*bwd)
    again = rnnt_ops.rnnt_joint_bwd(*bwd)
    ref = rnnt_ops.rnnt_joint_bwd_plain(*bwd)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert [after[n] - before[n] for n in
            ("rnnt_joint_fwd", "rnnt_alpha", "rnnt_beta", "rnnt_joint_bwd")] == [1, 1, 1, 2]
    assert all(torch.equal(a, c) for a, c in zip(grads, again))
    assert float(ll[2]) == rnnt_ops.NEG  # the empty lattice
    lane_ok = torch.arange(U + 1, device=cuda_device)[None, None, :] <= joint[5][None, :, None]
    lane_ok = lane_ok.expand(T, B, U + 1)
    checks = {"lp_blank": (lpb, rb), "lp_emit": (lpe, re), "ll": (ll, rll),
              "alphas": (alphas[lane_ok], ra[lane_ok]), "gb": (gb, rgb), "ge": (ge, rge),
              **{n: (a, r) for n, a, r in zip(("denc", "dpred", "dw", "db"), grads, ref)}}
    w_cut = joint[2].clone()
    w_cut[-1] = 0
    faults = {
        "lp_blank": (rnnt_ops.rnnt_joint_fwd_plain(joint[0], joint[1], w_cut, *joint[3:],
                                                   blank)[0], rb),
        "ll": (chip_smoke.rnnt_emit_dropped(rnnt_ops)(rb, re, *lens)[1], rll),
        "ll_neighbour_late": (
            chip_smoke.rnnt_alpha_neighbour_late(torch, rnnt_ops)(rb, re, *lens)[1], rll),
        "gb": (chip_smoke.rnnt_beta_read_early(torch, rnnt_ops)(rb, re, ra, rll, g, *lens)[0],
               rgb),
        "dpred": (chip_smoke.rnnt_last_frame_out_of_dpred(torch, rnnt_ops)(*bwd)[1], ref[1]),
    }

    def tol(name, r):
        if name in ("lp_blank", "lp_emit"):
            return 1e-4 + 1e-5 * np.abs(r)
        if name in ("ll", "alphas", "ll_neighbour_late"):
            return 1e-3 + 1e-5 * np.abs(r)
        if name in ("gb", "ge"):
            return 1e-4
        return 1e-3 + 1e-3 * np.abs(r)

    over, sound = _readings(checks, tol)
    over_f, fault = _readings(faults, tol)
    passed = sorted(set(faults) - set(over_f))
    assert not over and not passed, {"beyond tolerance": over, "faults passing": passed,
                                     "sound": sound, "fault": fault}


@pytest.mark.parametrize("T,U", [(9, 5), (37, 40), (20, 10), (70, 130), (33, 20), (21, 1023)])
def test_rnnt_beta_each_form_equals_plain(cuda_device, monkeypatch, T, U):
    """Every form of ``beta_plan`` that holds U + 1 lanes gives the plain
    version's gb and ge bit for bit: the lattice widths of
    test_rnnt_kernels_match_plain and U + 1 = 1024 (8 chain warps of 4
    lanes a thread), ragged lengths with a target length 0 and an empty
    lattice."""
    rng = np.random.default_rng(T * U)
    B, V = 5, 6
    joint = _rnnt_inputs(rng, cuda_device, B, T, U, 16, V)
    lens = (joint[6], joint[5])
    rb, re = rnnt_ops.rnnt_joint_fwd_plain(*joint, V - 1)
    ra, rll = rnnt_ops.rnnt_alpha_plain(rb, re, *lens)
    g = torch.linspace(0.5, 1.5, B, device=cuda_device)
    want = rnnt_ops.rnnt_beta_plain(rb, re, ra, rll, g, *lens)
    plan_of = rnnt_ops.beta_plan
    forms = [f for f in rnnt_ops.BETA_FORMS if 32 * f[0] * f[1] >= U + 1]
    assert forms
    for form in forms:
        plan = plan_of(U + 1, (form,))
        monkeypatch.setattr(rnnt_ops, "beta_plan", lambda U1, forms=None, p=plan: p)
        gb, ge = rnnt_ops.rnnt_beta(rb, re, ra, rll, g, *lens)
        assert torch.equal(gb, want[0]) and torch.equal(ge, want[1]), form


@pytest.mark.parametrize("T,U", [(9, 5), (37, 40), (20, 10), (70, 130), (33, 20), (21, 1023)])
def test_rnnt_alpha_each_form_agrees(cuda_device, monkeypatch, T, U):
    """Every form of ``alpha_plan`` that holds U + 1 lanes gives the plan's
    alphas and ll bit for bit, at the lattice widths of
    test_rnnt_kernels_match_plain and U + 1 = 1024 (8 warps of 4 lanes a
    thread), ragged lengths with a target length 0 and an empty lattice; a
    second launch repeats the bits; rows t >= T_b hold row T_b - 1 and the
    lanes past U_b NEG, exactly; the empty lattice is NEG throughout."""
    import chip_smoke

    rng = np.random.default_rng(T * U + 1)
    B, V = 5, 6
    joint = _rnnt_inputs(rng, cuda_device, B, T, U, 16, V)
    lens = (joint[6], joint[5])
    rb, re = rnnt_ops.rnnt_joint_fwd_plain(*joint, V - 1)
    want = rnnt_ops.rnnt_alpha(rb, re, *lens)
    again = rnnt_ops.rnnt_alpha(rb, re, *lens)
    assert torch.equal(want[0], again[0]) and torch.equal(want[1], again[1])
    assert chip_smoke.alpha_layout_ok(torch, rnnt_ops, want[0], *lens)
    assert float(want[1][2]) == rnnt_ops.NEG and bool((want[0][:, 2] == rnnt_ops.NEG).all())
    plan_of = rnnt_ops.alpha_plan
    forms = [f for f in rnnt_ops.ALPHA_FORMS if 32 * f[0] * f[1] >= U + 1]
    assert rnnt_ops.alpha_plan(U + 1) in forms
    for form in forms:
        plan = plan_of(U + 1, (form,))
        monkeypatch.setattr(rnnt_ops, "alpha_plan", lambda U1, forms=None, p=plan: p)
        alphas, ll = rnnt_ops.rnnt_alpha(rb, re, *lens)
        assert torch.equal(alphas, want[0]) and torch.equal(ll, want[1]), form


def test_rnnt_joint_fwd_repeats_its_bits(cuda_device):
    rng = np.random.default_rng(23)
    joint = _rnnt_inputs(rng, cuda_device, 6, 70, 130, 320, 29)
    first = rnnt_ops.rnnt_joint_fwd(*joint, 28)
    again = rnnt_ops.rnnt_joint_fwd(*joint, 28)
    assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])


def test_rnnt_joint_fwd_refuses_a_misaligned_view(cuda_device):
    """A contiguous enc or pred view off the kernel's 16- / 4-byte loads
    raises before any launch; a view at a whole 16 bytes gives the same
    bits."""
    rng = np.random.default_rng(25)
    joint = list(_rnnt_inputs(rng, cuda_device, 3, 20, 12, 48, 29))
    first = rnnt_ops.rnnt_joint_fwd(*joint, 28)

    def offset(t, elems):
        view = torch.empty(t.numel() + elems, dtype=t.dtype, device=t.device)[elems:]
        return view.view(t.shape).copy_(t)

    before = kernels.launch_counts()
    for i in (0, 1):
        bad = list(joint)
        bad[i] = offset(joint[i], 1)
        with pytest.raises(ValueError, match="must lie at a multiple"):
            rnnt_ops.rnnt_joint_fwd(*bad, 28)
    assert kernels.launch_counts() == before
    good = list(joint)
    good[0], good[1] = offset(joint[0], 8), offset(joint[1], 2)
    again = rnnt_ops.rnnt_joint_fwd(*good, 28)
    assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])


def test_rnnt_tanh_and_log1p_give_the_math_librarys_bits(cuda_device):
    """The joint forward's table tanh gives bf16(tanhf(x)) on all 65536
    bf16 inputs; the beta kernel's log1p gives log1pf's bits on every
    float of [0, 1]."""
    assert rnnt_ops.rnnt_tanh_mismatches(cuda_device) == 0
    assert rnnt_ops.rnnt_log1p_mismatches(cuda_device) == 0


def test_rnnt_probes_keep_the_bits_and_count_no_launch(cuda_device):
    """The probes' builds of the joint forward, alpha and beta give the
    kernels' bits, count no launch and record each block's steps (beta:
    T_b frames; alpha: the steps of its walk, 0 for the empty lattice)."""
    rng = np.random.default_rng(24)
    B, T, U = 4, 45, 40
    joint = _rnnt_inputs(rng, cuda_device, B, T, U, 48, 29)
    lens = (joint[6], joint[5])
    lpb, lpe = rnnt_ops.rnnt_joint_fwd(*joint, 28)
    alphas, ll = rnnt_ops.rnnt_alpha(lpb, lpe, *lens)
    g = torch.ones(B, device=cuda_device)
    gb, ge = rnnt_ops.rnnt_beta(lpb, lpe, alphas, ll, g, *lens)
    before = kernels.launch_counts()
    pb, pe, jc = rnnt_ops.rnnt_joint_fwd_probe(*joint, 28)
    qb, qe, bc = rnnt_ops.rnnt_beta_probe(lpb, lpe, alphas, ll, g, *lens)
    qa, qll, ac = rnnt_ops.rnnt_alpha_probe(lpb, lpe, *lens)
    torch.cuda.synchronize()
    assert kernels.launch_counts() == before
    assert torch.equal(qa, alphas) and torch.equal(qll, ll)
    Tb, Ub, D = joint[6].long(), joint[5].long(), rnnt_ops.ALPHA_AHEAD
    steps = torch.where(Tb > 0, Tb + Ub, 0)
    assert ac[:, -1].tolist() == ((steps + D - 1) // D * D).tolist()
    assert int(ac[0, :-1].sum()) > 0
    assert torch.equal(pb, lpb) and torch.equal(pe, lpe)
    assert torch.equal(qb, gb) and torch.equal(qe, ge)
    assert bc[:, -1].tolist() == joint[6].tolist()
    assert int(bc[0, :-1].sum()) > 0 and int(jc[:, :-1].sum()) > 0 and int(jc[:, -1].sum()) > 0


def test_rnnt_loss_gradient_on_card_matches_cpu(cuda_device):
    """transducer_loss_fused through the kernels on the card against the
    same through the plain versions on the CPU: nll and the four
    gradients, in the inputs' dtypes."""
    rng = np.random.default_rng(11)
    args = _rnnt_inputs(rng, torch.device("cpu"), 4, 21, 35, 32, 29)
    out = []
    for dev in (cuda_device, torch.device("cpu")):
        x = [a.to(dev).requires_grad_(True) for a in args[:4]]
        nll = rnnt_ops.transducer_loss_fused(*x, args[6].to(dev), args[4].to(dev),
                                             args[5].to(dev))
        (nll * torch.arange(1, 5, device=dev)).sum().backward()
        out.append([nll.detach().cpu()] + [a.grad.cpu() for a in x])
        assert [a.grad.dtype for a in x] == [a.dtype for a in args[:4]]
    assert float(out[0][0][2]) == -rnnt_ops.NEG and float(out[0][1][2].abs().max()) == 0.0
    for name, a, c in zip(("nll", "denc", "dpred", "dw", "db"), *out):
        a, c = a.float().numpy(), c.float().numpy()
        np.testing.assert_allclose(a, c, rtol=1e-3, atol=1e-3 * max(1.0, np.abs(c).max()),
                                   err_msg=name)


def test_rnnt_never_takes_a_plain_version_on_card(cuda_device, monkeypatch):
    """The no-fallback rule: with every plain version of the RNN-T kernels
    made to raise, the loss and its gradient on CUDA tensors still run
    (through the kernels); shapes beyond the kernels' design raise."""
    for name in ("rnnt_joint_fwd", "rnnt_alpha", "rnnt_beta", "rnnt_joint_bwd"):
        def refuse(*a, _name=name, **k):
            raise AssertionError(f"{_name}: plain version taken on the card")
        monkeypatch.setattr(rnnt_ops, f"{name}_plain", refuse)
    rng = np.random.default_rng(12)
    enc, pred, w, b, tg, ul, tl = _rnnt_inputs(rng, cuda_device, 3, 8, 4, 16, 5)
    x = [a.requires_grad_(True) for a in (enc, pred, w, b)]
    before = kernels.launch_counts()
    rnnt_ops.transducer_loss_fused(*x, tl, tg, ul).sum().backward()
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert all(counts[n] == before[n] + 1 for n in
               ("rnnt_joint_fwd", "rnnt_alpha", "rnnt_beta", "rnnt_joint_bwd"))
    with pytest.raises(ValueError, match="beyond the kernel's design"):
        rnnt_ops.rnnt_joint_fwd(enc, pred, torch.zeros((16, 33), dtype=torch.bfloat16,
                                                       device=cuda_device),
                                torch.zeros(33, device=cuda_device), tg, ul, tl, 32)
    with pytest.raises(TypeError):  # the joint kernels take bf16 operands only
        rnnt_ops.rnnt_joint_fwd(enc.float(), pred, w, b, tg, ul, tl, 4)


def test_rnnt_model_trains_through_the_kernels_on_card(cuda_device, tmp_path):
    """A tiny Listener + transducer model on the card, use_pallas off in
    both sections: the Listener still runs the BLSTM kernels and the head
    hands the fused kernels its projections (no lattice on the card); the
    loss and every gradient are finite and match the CPU's scan encoder
    and fused plain path (the head switched to it: the same bf16 joint)."""
    from nabu_tpu_torch.config import ConfigFile
    from nabu_tpu_torch.models.model import build_model
    from nabu_tpu_torch.ops.losses import make_loss_computer
    from nabu_tpu_torch.params import flatten, unflatten

    path = tmp_path / "model.cfg"
    path.write_text("[model]\ncompute_dtype = float32\n[encoder]\nencoder = listener\n"
                    "num_layers = 2\nnum_units = 12\n[decoder]\ndecoder = rnnt\n"
                    "num_units = 10\nembed_dim = 6\njoint_units = 16\n")
    model = build_model(ConfigFile.read(str(path)), 6, 4)
    init = flatten(model.init(torch.Generator().manual_seed(0)))
    rng = np.random.default_rng(9)
    batch = {
        "features": torch.as_tensor(rng.standard_normal((3, 29, 6)).astype(np.float32)),
        "feature_lengths": torch.as_tensor([29, 17, 6], dtype=torch.int32),
        "targets": torch.as_tensor(rng.integers(0, 4, (3, 5)), dtype=torch.int32),
        "target_lengths": torch.as_tensor([5, 2, 0], dtype=torch.int32),
        "example_mask": torch.ones(3),
    }
    loss_fn = make_loss_computer(model)
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        model.decoders["decoder"].use_pallas = dev.type == "cpu"
        flat = {k: v.to(dev).requires_grad_(True) for k, v in init.items()}
        kernels.reset_launch_counts()
        loss, _ = loss_fn(unflatten(flat), {k: v.to(dev) for k, v in batch.items()}, None,
                          False)
        grads = torch.autograd.grad(loss, list(flat.values()))
        counts = kernels.launch_counts()
        out[dev.type] = (float(loss), [g.cpu() for g in grads], counts)
    loss_c, grads_c, counts = out["cuda"]
    assert all(counts[n] > 0 for n in ("blstm_proj", "blstm_recur_train", "blstm_bwd_recur",
                                       "rnnt_joint_fwd", "rnnt_alpha", "rnnt_beta",
                                       "rnnt_joint_bwd")), counts
    assert sum(out["cpu"][2].values()) == 0
    np.testing.assert_allclose(loss_c, out["cpu"][0], rtol=1e-3)
    for name, a, c in zip(init, grads_c, out["cpu"][1]):
        assert bool(torch.isfinite(a).all()), name
        np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=1e-2,
                                   atol=1e-2 * max(1e-6, float(c.abs().max())), err_msg=name)


# ---------------------------------------------------------------------------
# the unidirectional LSTM kernels (ops/lstm.py)
# ---------------------------------------------------------------------------

def _lstm_tol(name, tag):
    import chip_smoke

    return {"y": chip_smoke.TOL[("lstm_fwd", tag)], "carry": chip_smoke.TOL["lstm_carry"],
            "stores": chip_smoke.TOL["lstm_stores"], "dxw": chip_smoke.TOL["lstm_bwd_recur"],
            "dwh": chip_smoke.TOL["lstm_bwd_dwh"],
            "proj": chip_smoke.TOL[("lstm_proj", tag)]}[name]


def _lengths(T, B):
    """B ragged lengths from T down, the first the full T."""
    return [T - (7 * i) % T for i in range(B)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,H,lengths", [
    (37, 9, [37, 20, 8, 1]), (20, 24, [20, 3, 0]), (37, 320, [37, 30, 12, 5, 1]),
    # the chain's row groups of 16: one row, one whole group, a group and
    # one row, the recipes' two groups, and the largest batch its plan
    # admits at H = 320 (three groups of 32 rows)
    (29, 320, [23]), (29, 320, _lengths(29, 16)), (29, 320, _lengths(29, 17)),
    (29, 320, _lengths(29, 32)), (13, 320, _lengths(13, 96))])
def test_lstm_kernels_match_plain(cuda_device, dtype, T, H, lengths):
    """Each LSTM kernel against its plain version on the same inputs, with
    chip_smoke.py's tolerances and planted faults, which must fail them:
    8 units reading h one step late (walk), the carry not held past a
    length (final carry), the dgates of 8 units one step stale (chain), the
    last token's term dropped (dwh), the last product dropped (proj). A
    projection's rows keep their bits whatever the number of rows."""
    import chip_smoke
    from nabu_tpu_torch.ops import lstm as lo

    tag = "bf16" if dtype == torch.bfloat16 else "f32"
    rng = np.random.default_rng(T * H)
    B = len(lengths)
    lt = torch.as_tensor(lengths, dtype=torch.int32, device=cuda_device)

    def u(*shape, scale=1.0, dt=dtype):
        return torch.as_tensor(
            rng.uniform(-scale, scale, shape).astype(np.float32)).to(cuda_device, dt)

    xw = u(T, B, 4 * H)
    wh = u(H, 4 * H, scale=float(np.sqrt(6.0 / (5 * H))))
    h0, c0 = u(B, H, scale=0.5, dt=torch.float32), u(B, H, scale=0.5, dt=torch.float32)
    gy = u(T, B, H)
    before = kernels.launch_counts()
    y, (hT, cT) = lo.lstm_fwd(xw, lt, wh, h0, c0)
    ry, (rh, rc) = lo.lstm_fwd_plain(xw, lt, wh, h0, c0)
    got = lo.lstm_fwd_train(xw, lt, wh)
    ref = lo.lstm_fwd_train_plain(xw, lt, wh)
    dxw = lo.lstm_bwd_recur(ref[1], ref[2], gy, lt, wh)
    rdxw = lo.lstm_bwd_recur_plain(ref[1], ref[2], gy, lt, wh)
    dwh = lo.lstm_bwd_dwh(ref[3], rdxw)
    rdwh = lo.lstm_bwd_dwh_plain(ref[3], rdxw)
    x, wx, b = u(T * B, 16), u(16, 4 * H, scale=0.3), u(4 * H, scale=0.1)
    proj = lo.lstm_proj(x, wx, b)
    part = lo.lstm_proj(x[: 3 * B].contiguous(), wx, b)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    for name, n in (("lstm_fwd", 1), ("lstm_fwd_train", 1), ("lstm_bwd_recur", 1),
                    ("lstm_bwd_dwh", 1), ("lstm_proj", 2)):
        assert after[name] == before[name] + n, name
    assert torch.equal(part, proj[: 3 * B])
    assert y.dtype == dtype and hT.dtype == cT.dtype == dxw.dtype == dwh.dtype == torch.float32

    checks = {"y": (y, ry), "h_final": (hT, rh), "c_final": (cT, rc), "y_train": (got[0], ref[0]),
              "gates": (got[1], ref[1]), "c": (got[2], ref[2]), "h": (got[3], ref[3]),
              "dxw": (dxw, rdxw), "dwh": (dwh, rdwh),
              "proj": (proj, lo.lstm_proj_plain(x, wx, b))}
    cut = rdxw.clone()
    cut[lengths[0] - 1, 0] = 0  # lane 0's last token (T but in the one-row case)
    x_cut = x.clone()
    x_cut[:, -1] = 0
    faults = {
        "y": (chip_smoke.lstm_stale_walk(torch)(xw, lt, wh, h0, c0)[0], ry),
        "c_final": (chip_smoke.lstm_carry_not_held(torch)(xw, lt, wh, h0, c0)[1][1], rc),
        "dxw": (chip_smoke.lstm_faulty_chain(torch)(ref[1], ref[2], gy, lt, wh), rdxw),
        "dwh": (lo.lstm_bwd_dwh_plain(ref[3], cut), rdwh),
        "proj": (lo.lstm_proj_plain(x_cut, wx, b), checks["proj"][1]),
    }
    kind = {"y": "y", "y_train": "y", "h_final": "carry", "c_final": "carry", "gates": "stores",
            "c": "stores", "h": "stores", "dxw": "dxw", "dwh": "dwh", "proj": "proj"}

    def tol(name, r):
        atol, rtol = _lstm_tol(kind[name], tag)
        return atol + rtol * np.abs(r)

    over, sound = _readings(checks, tol)
    over_f, fault = _readings(faults, tol)
    passed = sorted(set(faults) - set(over_f))
    assert not over and not passed, {"beyond tolerance": over, "faults passing": passed,
                                     "sound": sound, "fault": fault}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,B,H", [(64, 32, 320), (16, 96, 320), (40, 17, 24)])
def test_lstm_chain_repeats_its_bits(cuda_device, dtype, T, B, H):
    """The chain adds its K slices and warps in a fixed order: a second
    launch gives the first one's bits, at the recipes' split (16 rows x 8
    units a block), at B = 96 (32 rows a block) and with a partial row
    group, each within the chain's tolerance of the plain version."""
    import chip_smoke
    from nabu_tpu_torch.ops import lstm as lo

    rng = np.random.default_rng(T + B + H)
    lt = torch.as_tensor(_lengths(T, B), dtype=torch.int32, device=cuda_device)

    def u(*shape, scale=1.0, dt=dtype):
        return torch.as_tensor(
            rng.uniform(-scale, scale, shape).astype(np.float32)).to(cuda_device, dt)

    wh = u(H, 4 * H, scale=float(np.sqrt(6.0 / (5 * H))))
    gates = u(T, B, 4 * H, scale=2.0, dt=torch.float32)
    c = u(T, B, H, scale=2.0, dt=torch.float32)
    gy = u(T, B, H)
    assert lo.chain_plan(B, H)[0] == (1 if B <= 48 else 2)
    first = lo.lstm_bwd_recur(gates, c, gy, lt, wh)
    second = lo.lstm_bwd_recur(gates, c, gy, lt, wh)
    ref = lo.lstm_bwd_recur_plain(gates, c, gy, lt, wh)
    assert torch.equal(first, second)
    atol, rtol = chip_smoke.TOL["lstm_bwd_recur"]
    excess = float(((first - ref).abs() - atol - rtol * ref.abs()).max())
    assert excess <= 0, excess


def _lstm_walk_inputs(rng, device, dtype, T, B, H):
    """The LSTM walk's inputs: xw uniform in [-1, 1], wh at the model's
    glorot scale, an f32 carry (h0, c0) uniform in [-0.5, 0.5], ragged
    lengths from T down with a last lane of length 0 (B > 1)."""
    def u(*shape, scale=1.0, dt=dtype):
        return torch.as_tensor(
            rng.uniform(-scale, scale, shape).astype(np.float32)).to(device, dt)

    lengths = _lengths(T, B)
    if B > 1:
        lengths[-1] = 0
    lt = torch.as_tensor(lengths, dtype=torch.int32, device=device)
    xw, wh = u(T, B, 4 * H), u(H, 4 * H, scale=float(np.sqrt(6.0 / (5 * H))))
    h0 = u(B, H, scale=0.5, dt=torch.float32)
    c0 = u(B, H, scale=0.5, dt=torch.float32)
    return xw, lt, wh, h0, c0


def _lstm_walk_excess(got, ref, tag):
    """The largest excess of the walk's outputs over chip_smoke.py's
    tolerances: (y, final h, final c) or (y, gates, c, carried h)."""
    tols = [_lstm_tol("y", tag)] + [_lstm_tol("carry" if len(got) == 3 else "stores", tag)] * (
        len(got) - 1)
    return max(float(((g.float() - r.float()).abs() - atol - rtol * r.float().abs()).max())
               for g, r, (atol, rtol) in zip(got, ref, tols))


def _walk_out(out):
    """(y, (h, c)) of lstm_fwd, flattened."""
    return (out[0], *out[1])


# T in {1, 3, 37}: the tests' narrow layers (H = 9, 12: rows of 3 quads,
# the last partial, a partial unit group), one row, a whole row group, a
# group and one row, the recipes' batch and the training limit at H = 320;
# then the inference batch of the two-pair form (16 x 2)
LSTM_WALK_SHAPES = [(T, B, H) for T in (1, 3, 37)
                    for B, H in ((1, 9), (17, 12), (16, 320), (32, 320), (96, 320))]
LSTM_WALK_SHAPES += [(5, 1, 320), (9, 144, 320)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,B,H", LSTM_WALK_SHAPES)
def test_lstm_walk_matches_plain_at_its_plans(cuda_device, dtype, T, B, H):
    """The LSTM walk with a carry (lstm_fwd) and, where the chain's plan
    holds the batch, its training form, at the form ``walk_plan`` picks,
    ragged lengths with a lane of length 0: within chip_smoke.py's
    tolerances of the plain version; a second launch gives the first one's
    bits, and both forms give one y from a zero carry."""
    from nabu_tpu_torch.ops import lstm as lo

    tag = "bf16" if dtype == torch.bfloat16 else "f32"
    plan = lo.walk_plan(B, H)
    assert plan is not None and (plan[0], plan[1]) in lo.WALK_FORMS
    xw, lt, wh, h0, c0 = _lstm_walk_inputs(np.random.default_rng(T + B + H), cuda_device, dtype,
                                           T, B, H)
    train = lo.chain_plan(B, H) is not None
    before = kernels.launch_counts()
    y = [_walk_out(lo.lstm_fwd(xw, lt, wh, h0, c0)) for _ in range(2)]
    y0 = lo.lstm_fwd(xw, lt, wh)[0]
    got = [lo.lstm_fwd_train(xw, lt, wh) for _ in range(2)] if train else []
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert after["lstm_fwd"] == before["lstm_fwd"] + 3
    assert after["lstm_fwd_train"] == before["lstm_fwd_train"] + 2 * train
    assert y[0][0].dtype == dtype and all(torch.equal(a, b) for a, b in zip(*y))
    excess = _lstm_walk_excess(y[0], _walk_out(lo.lstm_fwd_plain(xw, lt, wh, h0, c0)), tag)
    assert excess <= 0, (plan, excess)
    if train:
        assert all(torch.equal(a, b) for a, b in zip(*got))
        assert torch.equal(got[0][0], y0)
        excess = _lstm_walk_excess(got[0], lo.lstm_fwd_train_plain(xw, lt, wh), tag)
        assert excess <= 0, (plan, excess)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,B,H", [(37, 37, 24), (29, 33, 9)])
def test_lstm_walk_forms_give_one_result(cuda_device, monkeypatch, dtype, T, B, H):
    """Every form of the LSTM walk (units x 16 mt rows a block), forced at
    one shape: each within the tolerances of the plain version, all with
    the same bits, with a carry and in the training form (a row's sums do
    not depend on the form); H = 9 (rows of 3 quads, the last partial, a
    partial unit group)."""
    from nabu_tpu_torch.ops import lstm as lo

    tag = "bf16" if dtype == torch.bfloat16 else "f32"
    xw, lt, wh, h0, c0 = _lstm_walk_inputs(np.random.default_rng(T * B + H), cuda_device, dtype,
                                           T, B, H)
    ref_y = _walk_out(lo.lstm_fwd_plain(xw, lt, wh, h0, c0))
    ref_t = lo.lstm_fwd_train_plain(xw, lt, wh)
    outs = []
    for units, mt in lo.WALK_FORMS:
        blocks = -(-B // (16 * mt)) * -(-H // units)
        form = (units, mt, blocks, lo.walk_bytes(H, units, mt))
        monkeypatch.setattr(lo, "walk_plan", lambda *_, f=form: f)
        outs.append((_walk_out(lo.lstm_fwd(xw, lt, wh, h0, c0)), lo.lstm_fwd_train(xw, lt, wh)))
        for got, ref in zip(outs[-1], (ref_y, ref_t)):
            excess = _lstm_walk_excess(got, ref, tag)
            assert excess <= 0, (units, mt, excess)
    assert all(torch.equal(a, b) for o in outs[1:] for i in range(2)
               for a, b in zip(o[i], outs[0][i]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lstm_walk_row_alone_equals_row_in_batch(cuda_device, dtype):
    """The streaming contract: a row walked alone (B = 1, its own plan)
    gives the same bits as inside a batch of 32 (8 x 1) or 144 (16 x 2),
    with a carry (output, final carry) and in the training form."""
    from nabu_tpu_torch.ops import lstm as lo

    T, H = 33, 320
    xw, lt, wh, h0, c0 = _lstm_walk_inputs(np.random.default_rng(31), cuda_device, dtype,
                                           T, 144, H)
    full = {B: (_walk_out(lo.lstm_fwd(xw[:, :B].contiguous(), lt[:B].contiguous(), wh,
                                      h0[:B].contiguous(), c0[:B].contiguous())),
                lo.lstm_fwd_train(xw[:, :32].contiguous(), lt[:32].contiguous(), wh))
            for B in (32, 144)}
    for b in (0, 5, 17, 31):
        one = lambda t: t[:, b:b + 1].contiguous()  # noqa: E731
        alone = _walk_out(lo.lstm_fwd(one(xw), lt[b:b + 1].contiguous(), wh,
                                      h0[b:b + 1].contiguous(), c0[b:b + 1].contiguous()))
        for B in (32, 144):
            y, hT, cT = full[B][0]
            assert torch.equal(alone[0], y[:, b:b + 1]), (b, B)
            assert torch.equal(alone[1], hT[b:b + 1]) and torch.equal(alone[2], cT[b:b + 1])
        train = lo.lstm_fwd_train(one(xw), lt[b:b + 1].contiguous(), wh)
        assert all(torch.equal(a, one(r)) for a, r in zip(train, full[32][1])), b


@pytest.mark.parametrize("B,H,train", [(193, 320, False), (33, 1024, False), (97, 320, True)])
def test_lstm_walk_rejects_shapes_beyond_its_plan(cuda_device, B, H, train):
    """A batch past the walk's limits (192 at H = 320, 32 at 1024) raises
    before any launch, and so does the training form past the chain's (96
    at H = 320)."""
    from nabu_tpu_torch.ops import lstm as lo

    xw, lt, wh, h0, c0 = _lstm_walk_inputs(np.random.default_rng(3), cuda_device,
                                           torch.bfloat16, 3, B, H)
    before = kernels.launch_counts()
    with pytest.raises(ValueError, match="beyond the kernel's design"):
        if train:
            lo.lstm_fwd_train(xw, lt, wh)
        else:
            lo.lstm_fwd(xw, lt, wh, h0, c0)
    assert kernels.launch_counts() == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lstm_walk_probe_keeps_the_walks_bits(cuda_device, dtype):
    """The step probe's build of the training walk gives the walk's bits,
    counts no launch, and sums positive cycles of every part in every
    block (T = 9, B = 32, H = 320: the plan's 80 blocks)."""
    from nabu_tpu_torch.ops import lstm as lo

    xw, lt, wh, _, _ = _lstm_walk_inputs(np.random.default_rng(5), cuda_device, dtype,
                                         9, 32, 320)
    want = lo.lstm_fwd_train(xw, lt, wh)
    before = kernels.launch_counts()
    *got, cycles = lo.lstm_fwd_train_probe(xw, lt, wh)
    torch.cuda.synchronize()
    assert kernels.launch_counts() == before
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert tuple(cycles.shape) == (lo.walk_plan(32, 320)[2], len(lo.PROBE_PARTS))
    assert bool((cycles > 0).all()), cycles


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
def test_lstm_layer_gradients_on_card_match_cpu(cuda_device, monkeypatch, dtype, rtol):
    """lstm_scan_kernel with a gradient (x @ wx + b, then LSTMLayer) on the
    card against the same on the CPU through the plain versions: output,
    dx, dwx, dwh, db. A planted fault, dwh paired with h one step late,
    must fail the tolerance."""
    import chip_smoke
    from nabu_tpu_torch.ops import lstm as lo

    rng = np.random.default_rng(21)
    T, D, H, lengths = 29, 12, 40, [29, 17, 5, 1]
    p32 = {"wx": rng.uniform(-0.3, 0.3, (D, 4 * H)), "wh": rng.uniform(-0.2, 0.2, (H, 4 * H)),
           "b": rng.uniform(-0.3, 0.3, 4 * H)}
    x32 = rng.standard_normal((len(lengths), T, D))
    gy = torch.as_tensor(rng.standard_normal((len(lengths), T, H)).astype(np.float32))

    def run(dev):
        p = {k: torch.as_tensor(v.astype(np.float32)).to(dev, dtype).requires_grad_(True)
             for k, v in p32.items()}
        x = torch.as_tensor(x32.astype(np.float32)).to(dev, dtype).requires_grad_(True)
        y = lo.lstm_scan_kernel(p, x, torch.as_tensor(lengths, dtype=torch.int32))
        (y.float() * gy.to(dev)).sum().backward()
        return [y, x.grad, p["wx"].grad, p["wh"].grad, p["b"].grad]

    before = kernels.launch_counts()
    got = run(cuda_device)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    for name in ("lstm_fwd_train", "lstm_bwd_recur", "lstm_bwd_dwh"):
        assert after[name] == before[name] + 1, name
    ref = run(torch.device("cpu"))
    monkeypatch.setattr(lo, "lstm_bwd_dwh", chip_smoke.lstm_dwh_h_late(torch))
    faulty = run(cuda_device)

    def tol(name, r):
        return rtol * (np.abs(r) + np.abs(r).max())

    names = ("y", "dx", "dwx", "dwh", "db")
    over, sound = _readings({n: (a.detach(), b.detach()) for n, a, b in zip(names, got, ref)},
                            tol)
    over_f, fault = _readings({"dwh": (faulty[3], ref[3])}, tol)
    assert not over and over_f, {"beyond tolerance": over, "sound": sound, "fault": fault}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lstm_carry_threading_on_card_is_exact(cuda_device, dtype):
    """Chunks of 8 frames with the f32 carry threaded through give the
    full walk's output and final carry bit for bit (projection included)."""
    from nabu_tpu_torch.ops import lstm as lo

    rng = np.random.default_rng(22)
    T, D, H, lengths = 37, 20, 64, [37, 30, 9, 0]
    p = {k: torch.as_tensor(rng.uniform(-0.3, 0.3, s).astype(np.float32)).to(cuda_device, dtype)
         for k, s in (("wx", (D, 4 * H)), ("wh", (H, 4 * H)), ("b", (4 * H,)))}
    x = torch.as_tensor(rng.standard_normal((T, len(lengths), D)).astype(np.float32)).to(
        cuda_device, dtype)
    lt = torch.as_tensor(lengths, dtype=torch.int32, device=cuda_device)
    with torch.no_grad():
        full, (hf, cf) = lo.lstm_tm_apply(p, x, lt)
        outs, carry = [], None
        for c0 in range(0, T, 8):
            y, carry = lo.lstm_tm_apply(p, x[c0:c0 + 8], torch.clamp(lt - c0, 0, 8), carry)
            outs.append(y)
    assert torch.equal(torch.cat(outs), full)
    assert torch.equal(carry[0], hf) and torch.equal(carry[1], cf)
    assert float(cf[3].abs().max()) == 0.0  # a lane of length 0 keeps its zero carry


_STREAM_CFG = ("[model]\ncompute_dtype = {dtype}\n[encoder]\nencoder = dblstm\n"
               "bidirectional = false\nnum_layers = 2\nnum_units = 24\n[decoder]\n"
               "decoder = rnnt\nnum_units = 16\nembed_dim = 8\njoint_units = 32\n")


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_streaming_equals_offline_on_card(cuda_device, tmp_path, dtype):
    """A tiny streaming model on the card: transducer_streaming (chunks of
    8) gives the ids and the scores of transducer_greedy exactly, through
    the LSTM kernels."""
    from nabu_tpu_torch.config import Conf, ConfigFile
    from nabu_tpu_torch.decoding.recognizers import build_recognizer
    from nabu_tpu_torch.models.model import build_model
    from nabu_tpu_torch.params import flatten, unflatten

    path = tmp_path / "model.cfg"
    path.write_text(_STREAM_CFG.format(dtype=dtype))
    model = build_model(ConfigFile.read(str(path)), 6, 4)
    flat = flatten(model.init(torch.Generator().manual_seed(3)))
    rng = np.random.default_rng(23)
    flat["decoders/decoder/out/b"] = torch.as_tensor(
        rng.uniform(-1.0, 1.0, 5).astype(np.float32))
    params = unflatten({k: v.to(cuda_device) for k, v in flat.items()})
    feats = (2.0 * rng.standard_normal((4, 45, 6))).astype(np.float32)
    lengths = np.asarray([45, 30, 9, 1], np.int32)
    kernels.reset_launch_counts()
    stream = build_recognizer(Conf({"recognizer": "transducer_streaming", "chunk_frames": "8",
                                    "max_symbols": "3"}, "r"), model)(params, feats, lengths)
    greedy = build_recognizer(Conf({"recognizer": "transducer_greedy", "max_symbols": "3"},
                                   "r"), model)(params, feats, lengths)
    counts = kernels.launch_counts()
    assert counts["lstm_fwd"] > 0 and counts["lstm_proj"] > 0, counts
    assert counts["blstm_recur"] == counts["lstm_fwd_train"] == 0, counts
    for b in range(4):
        assert stream.best(b) == greedy.best(b), b
    assert np.array_equal(stream.scores, greedy.scores)
    assert sum(len(stream.best(b)) for b in range(4)) > 0


def test_lstm_never_takes_a_plain_version_on_card(cuda_device, monkeypatch, tmp_path):
    """The no-fallback rule: with the LSTM kernels' plain versions and the
    masked scan made to raise, a forward-only stack and the prediction net
    train on the card (through the kernels) and the streaming model
    decodes; a batch beyond the chain's row groups on the card's SMs (97
    rows at H = 320) raises."""
    from nabu_tpu_torch.config import ConfigFile
    from nabu_tpu_torch.models import core
    from nabu_tpu_torch.models.model import build_model
    from nabu_tpu_torch.ops import lstm as lo
    from nabu_tpu_torch.ops.losses import make_loss_computer
    from nabu_tpu_torch.params import flatten, unflatten

    def refuse(*a, **k):
        raise AssertionError("a plain LSTM path taken on the card")

    for name in ("lstm_walk_plain", "lstm_fwd_plain", "lstm_fwd_train_plain",
                 "lstm_bwd_recur_plain", "lstm_bwd_dwh_plain", "lstm_proj_plain"):
        monkeypatch.setattr(lo, name, refuse)
    monkeypatch.setattr(core, "lstm_scan", refuse)
    path = tmp_path / "model.cfg"
    path.write_text(_STREAM_CFG.format(dtype="bfloat16"))
    model = build_model(ConfigFile.read(str(path)), 6, 4)
    flat = {k: v.to(cuda_device).requires_grad_(True)
            for k, v in flatten(model.init(torch.Generator().manual_seed(0))).items()}
    rng = np.random.default_rng(24)
    batch = {
        "features": torch.as_tensor(rng.standard_normal((3, 21, 6)).astype(np.float32)),
        "feature_lengths": torch.as_tensor([21, 13, 4], dtype=torch.int32),
        "targets": torch.as_tensor(rng.integers(0, 4, (3, 5)), dtype=torch.int32),
        "target_lengths": torch.as_tensor([5, 2, 0], dtype=torch.int32),
        "example_mask": torch.ones(3),
    }
    batch = {k: v.to(cuda_device) for k, v in batch.items()}
    kernels.reset_launch_counts()
    loss, _ = make_loss_computer(model)(unflatten(flat), batch, None, False)
    grads = torch.autograd.grad(loss, list(flat.values()))
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    # 2 encoder layers and the prediction net
    for name in ("lstm_fwd_train", "lstm_bwd_recur", "lstm_bwd_dwh"):
        assert counts[name] == 3, (name, counts)
    with torch.no_grad():
        enc, _ = model.encode(unflatten(flat), batch["features"], batch["feature_lengths"])
    assert enc.shape == (3, 21, 24) and kernels.launch_counts()["lstm_fwd"] == 2
    z = torch.zeros((3, 97, 4 * 320), dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError, match="beyond the kernel's design"):
        lo.lstm_fwd_train(z, torch.full((97,), 3, dtype=torch.int32, device=cuda_device),
                          torch.zeros((320, 4 * 320), dtype=torch.bfloat16, device=cuda_device))
    with pytest.raises(TypeError):  # lengths must be int32
        lo.lstm_fwd(z[:, :4].contiguous(), torch.full((4,), 3, dtype=torch.int64, device=cuda_device),
                    torch.zeros((320, 4 * 320), dtype=torch.bfloat16, device=cuda_device))


# ---------------------------------------------------------------------------
# the v1 BLSTM kernel family (rows 4-6) and the LAS modules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,B,H", [(37, 4, 9), (37, 5, 12), (23, 128, 16), (64, 64, 512)])
def test_blstm_v1_kernels_match_plain(cuda_device, dtype, T, B, H):
    """Each v1 kernel against its plain version on the same inputs, and a
    planted fault per output that the tolerance must reject: the walks (h
    of 8 units read one step late; the stored h and c one step late), the
    gates recompute (the last of the H products dropped), the chain (the
    dgates of 8 units read one step stale) and dwh (the last token's term
    dropped). Shapes off the 16-byte paths (H = 9, 12), the largest batch
    (B = 128) and las_large's width (H = 512, B = 64); wh at glorot scale."""
    import chip_smoke
    from nabu_tpu_torch.ops import blstm_v1 as v1

    rng = np.random.default_rng(T * B + H)
    lengths = rng.integers(1, T + 1, B).astype(np.int32)
    lengths[0], lengths[-1] = T, 1
    lt = torch.as_tensor(lengths, device=cuda_device)

    def u(*shape, scale=1.0):
        return torch.as_tensor(
            rng.uniform(-scale, scale, shape).astype(np.float32)).to(cuda_device, dtype)

    xw, gy = u(2, T, B, 4 * H), u(T, B, 2 * H)
    wh = u(2, H, 4 * H, scale=float(np.sqrt(6.0 / (5 * H))))
    before = kernels.launch_counts()
    y_inf = v1.blstm_v1_recur(xw, lt, wh)
    y, hs, c = v1.blstm_v1_recur_train(xw, lt, wh)
    ry, rhs, rc = v1.blstm_v1_recur_train_plain(xw, lt, wh)
    gates = v1.blstm_v1_bwd_gates(xw, rhs, wh)
    rgates = v1.blstm_v1_bwd_gates_plain(xw, rhs, wh)
    dg = v1.blstm_v1_bwd_recur(rgates, rc, gy, lt, wh)
    rdg = v1.blstm_v1_bwd_recur_plain(rgates, rc, gy, lt, wh)
    dgr = u(2, T, B, 4 * H)
    dwh, rdwh = v1.blstm_v1_bwd_dwh(rhs, dgr), v1.blstm_v1_bwd_dwh_plain(rhs, dgr)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    for name in ("blstm_v1_recur", "blstm_v1_recur_train", "blstm_v1_bwd_gates",
                 "blstm_v1_bwd_recur", "blstm_v1_bwd_dwh"):
        assert after[name] == before[name] + 1, name
    checks = {"y_inference": (y_inf, ry), "y": (y, ry), "h": (hs, rhs), "c": (c, rc),
              "gates": (gates, rgates), "dgates": (dg, rdg), "dwh": (dwh, rdwh)}
    hs_cut = rhs.clone()
    hs_cut[..., -1] = 0
    dg_tok = dgr.clone()
    dg_tok[0, T - 1, 0] = 0
    stale = chip_smoke.stale_recur(torch, units=min(8, H))(xw, lt, wh)
    faults = {
        "y_inference": (stale, ry), "y": (stale, ry),
        "h": (chip_smoke.hs_one_step_late(torch, rhs), rhs),
        "c": (chip_smoke.c_one_step_late(torch, rc), rc),
        "gates": (v1.blstm_v1_bwd_gates_plain(xw, hs_cut, wh), rgates),
        "dgates": (chip_smoke.faulty_chain(torch, stale_units=min(8, H))(rgates, rc, gy, lt, wh),
                   rdg),
        "dwh": (v1.blstm_v1_bwd_dwh_plain(rhs, dg_tok), rdwh),
    }

    def tol(name, ref):
        if name == "gates":  # f32 sums of the same products in another order
            return 1e-4 * (1.0 + np.abs(ref))
        if dtype == torch.float32:
            return 1e-4 * (1.0 + np.abs(ref))
        if name in ("y_inference", "y", "h"):
            return 3e-2 * max(1.0, float(np.abs(ref).max()))
        if name == "dgates":
            return 2e-2 * max(1.0, float(np.abs(ref).max()))
        if name == "c":
            return 1e-2 * max(1.0, float(np.abs(ref).max()))
        return 1e-2 * (1.0 + np.abs(ref))

    over, sound = _readings(checks, tol)
    over_f, fault = _readings(faults, tol)
    passed = sorted(set(faults) - set(over_f))
    assert not over and not passed, {"beyond tolerance": over, "faults passing": passed,
                                     "sound": sound, "fault": fault}
    assert float(y[1:, -1].float().abs().max()) == 0.0  # the length-1 lane's padding


@pytest.mark.parametrize("T,B,H", [(64, 64, 512), (16, 128, 512)])
def test_blstm_v1_chain_repeats_its_bits(cuda_device, T, B, H):
    """The bf16 chain's step product adds the warps' partial sums in a
    fixed order: a second launch gives the first one's bits, at las_large's
    split (16 rows x 32 units a block) and at B = 128 (32 rows a block),
    both within the chain's tolerance of the plain version."""
    from nabu_tpu_torch.ops import blstm_v1 as v1

    rng = np.random.default_rng(T + B + H)
    lengths = rng.integers(1, T + 1, B).astype(np.int32)
    lengths[0] = T
    lt = torch.as_tensor(lengths, device=cuda_device)

    def u(*shape, scale=1.0, dtype=torch.bfloat16):
        return torch.as_tensor(
            rng.uniform(-scale, scale, shape).astype(np.float32)).to(cuda_device, dtype)

    wh = u(2, H, 4 * H, scale=float(np.sqrt(6.0 / (5 * H))))
    gates = u(2, T, B, 4 * H, scale=2.0, dtype=torch.float32)
    c = u(2, T, B, H, scale=2.0, dtype=torch.float32)
    gy = u(T, B, 2 * H)
    assert v1.chain_plan(B, H, "bf16")[0] == (1 if B <= 64 else 2)
    first = v1.blstm_v1_bwd_recur(gates, c, gy, lt, wh)
    second = v1.blstm_v1_bwd_recur(gates, c, gy, lt, wh)
    ref = v1.blstm_v1_bwd_recur_plain(gates, c, gy, lt, wh)
    assert torch.equal(first, second)
    err = float((first.float() - ref.float()).abs().max())
    assert err <= 2e-2 * max(1.0, float(ref.float().abs().max())), err


def _v1_walk_inputs(rng, device, dtype, T, B, H):
    """The v1 walk's inputs: xw uniform in [-1, 1], wh at the model's
    glorot scale, ragged lengths from T down with a last lane of length 0
    (B > 1)."""
    def u(*shape, scale=1.0):
        return torch.as_tensor(
            rng.uniform(-scale, scale, shape).astype(np.float32)).to(device, dtype)

    lengths = _lengths(T, B)
    if B > 1:
        lengths[-1] = 0
    lt = torch.as_tensor(lengths, dtype=torch.int32, device=device)
    return u(2, T, B, 4 * H), lt, u(2, H, 4 * H, scale=float(np.sqrt(6.0 / (5 * H))))


def _v1_walk_excess(got, ref, tag):
    """The largest excess of the training walk's outputs (y, hs, c) over
    chip_smoke.py's tolerances: y and the stored h at the walk's, c at the
    stores'."""
    import chip_smoke

    tols = 2 * [chip_smoke.TOL[("blstm_v1_recur", tag)]] + [
        chip_smoke.TOL[("blstm_v1_stores", tag)]]
    return max(float(((g.float() - r.float()).abs() - atol - rtol * r.float().abs()).max())
               for g, r, (atol, rtol) in zip(got, ref, tols))


# T in {1, 3, 37}: the tests' narrow layers (H = 9, 12: exchange rows of
# one 16-byte vector, a partial unit group), the largest batch at a narrow
# width (B = 128), a batch one past the v2 limit at H = 512, las_large's
# Listener and the largest batch at its width (16 x 4: 4 cells a thread)
V1_WALK_SHAPES = [(T, B, H) for T in (1, 3, 37)
                  for B, H in ((4, 9), (5, 12), (128, 16), (33, 512), (64, 512), (128, 512))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,B,H", V1_WALK_SHAPES)
def test_blstm_v1_walk_matches_plain_at_its_plans(cuda_device, dtype, T, B, H):
    """The v1 walks, inference and training, at the form ``walk_plan``
    picks, ragged lengths with a lane of length 0: within chip_smoke.py's
    tolerances of the plain version; a second launch gives the first one's
    bits, and the inference y equals the training y."""
    from nabu_tpu_torch.ops import blstm_v1 as v1

    tag = "bf16" if dtype == torch.bfloat16 else "f32"
    plan = v1.walk_plan(B, H, tag)
    assert plan is not None and (plan[0], plan[1]) in v1.WALK_FORMS
    args = _v1_walk_inputs(np.random.default_rng(T + B + H), cuda_device, dtype, T, B, H)
    before = kernels.launch_counts()
    y = [v1.blstm_v1_recur(*args) for _ in range(2)]
    train = [v1.blstm_v1_recur_train(*args) for _ in range(2)]
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert after["blstm_v1_recur"] == before["blstm_v1_recur"] + 2
    assert after["blstm_v1_recur_train"] == before["blstm_v1_recur_train"] + 2
    assert y[0].dtype == dtype and torch.equal(y[0], y[1])
    assert all(torch.equal(a, b) for a, b in zip(*train))
    assert torch.equal(train[0][0], y[0])
    excess = _v1_walk_excess(train[0], v1.blstm_v1_recur_train_plain(*args), tag)
    assert excess <= 0, (plan, excess)
    if B > 1:  # the length-0 lane: y and every stored h zero
        assert float(y[0][:, -1].float().abs().max()) == 0.0
        assert float(train[0][1][:, :, -1].float().abs().max()) == 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,B,H", [(37, 37, 24), (29, 33, 9)])
def test_blstm_v1_walk_forms_give_one_result(cuda_device, monkeypatch, dtype, T, B, H):
    """Every form of the v1 walk (units x 16 mt rows a block), forced at
    one shape: each within the tolerances of the plain version, all with
    the same bits, inference and training (a row's sums do not depend on
    the form); H = 9 (an exchange row of one 16-byte vector, a partial unit
    group)."""
    from nabu_tpu_torch.ops import blstm_v1 as v1

    tag = "bf16" if dtype == torch.bfloat16 else "f32"
    args = _v1_walk_inputs(np.random.default_rng(T * B + H), cuda_device, dtype, T, B, H)
    ref = v1.blstm_v1_recur_train_plain(*args)
    outs = []
    for units, mt in v1.WALK_FORMS:
        form = v1.walk_plan(B, H, tag, ((units, mt),))
        assert form is not None, (units, mt)
        monkeypatch.setattr(v1, "walk_plan", lambda *_, f=form: f)
        outs.append((v1.blstm_v1_recur(*args), *v1.blstm_v1_recur_train(*args)))
        assert torch.equal(outs[-1][0], outs[-1][1]), (units, mt)
        excess = _v1_walk_excess(outs[-1][1:], ref, tag)
        assert excess <= 0, (units, mt, excess)
    assert all(torch.equal(a, b) for o in outs[1:] for a, b in zip(o, outs[0]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_blstm_v1_walk_row_alone_equals_row_in_batch(cuda_device, dtype):
    """A row walked alone (B = 1, its own plan) gives the same bits as
    inside the batch of 64 at H = 512 (128 blocks: 32 units x 16 rows in
    bf16, 16 x 32 in f32), in both walks."""
    from nabu_tpu_torch.ops import blstm_v1 as v1

    T, H = 33, 512
    xw, lt, wh = _v1_walk_inputs(np.random.default_rng(41), cuda_device, dtype, T, 64, H)
    y = v1.blstm_v1_recur(xw, lt, wh)
    train = v1.blstm_v1_recur_train(xw, lt, wh)
    for b in (0, 5, 17, 63):
        one = xw[:, :, b:b + 1].contiguous()
        lb = lt[b:b + 1].contiguous()
        assert torch.equal(v1.blstm_v1_recur(one, lb, wh), y[:, b:b + 1]), b
        alone = v1.blstm_v1_recur_train(one, lb, wh)
        assert torch.equal(alone[0], train[0][:, b:b + 1]), b
        assert all(torch.equal(a, r[:, :, b:b + 1]) for a, r in zip(alone[1:], train[1:])), b


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_blstm_v1_walk_probe_keeps_the_walks_bits(cuda_device, dtype):
    """The step probe's build of the training walk gives the walk's bits,
    counts no launch, and sums positive cycles of every part in every
    block (T = 9, B = 64, H = 512: the plan's 128 blocks)."""
    from nabu_tpu_torch.ops import blstm_v1 as v1

    tag = "bf16" if dtype == torch.bfloat16 else "f32"
    args = _v1_walk_inputs(np.random.default_rng(5), cuda_device, dtype, 9, 64, 512)
    want = v1.blstm_v1_recur_train(*args)
    before = kernels.launch_counts()
    *got, cycles = v1.blstm_v1_recur_train_probe(*args)
    torch.cuda.synchronize()
    assert kernels.launch_counts() == before
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert tuple(cycles.shape) == (v1.walk_plan(64, 512, tag)[2], len(v1.PROBE_PARTS))
    assert bool((cycles > 0).all()), cycles


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
def test_blstm_v1_layer_gradients_on_card_match_cpu(cuda_device, dtype, rtol):
    """BLSTMLayerV1 through the kernels on the card against the same layer
    through the plain versions on the CPU: output and every gradient."""
    from nabu_tpu_torch.ops import blstm_v1 as v1

    rng = np.random.default_rng(21)
    T, lengths, D, H = 37, [37, 20, 8, 1], 11, 12
    p32 = _layer(rng, D, H, "cpu", torch.float32, glorot=True)
    x32 = torch.as_tensor(rng.standard_normal((T, len(lengths), D)).astype(np.float32))
    gy = torch.as_tensor(rng.standard_normal((T, len(lengths), 2 * H)).astype(np.float32))

    def run(dev):
        p = {d: {k: v.to(dev, dtype, copy=True).requires_grad_(True) for k, v in q.items()}
             for d, q in p32.items()}
        x = x32.to(dev, dtype, copy=True).requires_grad_(True)
        y = v1.blstm_v1_tm_apply(p, x, torch.as_tensor(lengths, dtype=torch.int32))
        (y.float() * gy.to(dev)).sum().backward()
        return [y] + [x.grad] + [p[d][k].grad for d in ("fw", "bw") for k in ("wx", "wh", "b")]

    got = run(cuda_device)
    ref = run(torch.device("cpu"))
    names = ["y", "dx"] + [f"{d}/{k}" for d in ("fw", "bw") for k in ("wx", "wh", "b")]

    def tol(name, ref):
        return rtol * (np.abs(ref) + np.abs(ref).max())

    over, sound = _readings({n: (a.detach(), b.detach()) for n, a, b in zip(names, got, ref)},
                            tol)
    assert not over, {"beyond tolerance": over, "sound": sound}


def test_listener_at_512_units_runs_only_v1(cuda_device):
    """kernel_family at las_large's width: a two-layer time-major stack of
    512-unit layers at B = 64 launches the v1 walks (inference and
    training), the gates recomputes, chains and dwh, and no v2 walk or
    chain; the projections and dx / dwx are shared."""
    from nabu_tpu_torch.models import core

    rng = np.random.default_rng(22)
    T, B, D, H = 20, 64, 40, 512
    layers = [_layer(rng, D, H, cuda_device, torch.bfloat16, glorot=True),
              _layer(rng, 4 * H, H, cuda_device, torch.bfloat16, glorot=True)]
    for q in layers:
        for d in q.values():
            for v in d.values():
                v.requires_grad_(True)
    x = torch.as_tensor(rng.standard_normal((T, B, D)).astype(np.float32)).to(
        cuda_device, torch.bfloat16)
    lengths = torch.as_tensor(rng.integers(1, T + 1, B), dtype=torch.int32)

    def stack():
        y = core.blstm_apply_tm(layers[0], x, lengths, "kernel")
        y, lens = core.pyramid_stack_tm(y, lengths)
        return core.blstm_apply_tm(layers[1], y, lens, "kernel")

    kernels.reset_launch_counts()
    with torch.no_grad():
        stack()
    torch.cuda.synchronize()
    infer = kernels.launch_counts()
    stack().float().sum().backward()
    torch.cuda.synchronize()
    train = {k: v - infer[k] for k, v in kernels.launch_counts().items()}
    assert {k: v for k, v in infer.items() if v} == {"blstm_proj": 2, "blstm_v1_recur": 2}
    assert {k: v for k, v in train.items() if v} == {
        "blstm_proj": 2, "blstm_v1_recur_train": 2, "blstm_v1_bwd_gates": 2,
        "blstm_v1_bwd_recur": 2, "blstm_v1_bwd_dwh": 2, "blstm_bwd_dx": 1, "blstm_bwd_dwx": 2}


def test_blstm_v1_rejects_shapes_beyond_its_design(cuda_device):
    from nabu_tpu_torch.ops import blstm_v1 as v1

    xw = torch.zeros((2, 3, 129, 64), device=cuda_device)
    wh = torch.zeros((2, 16, 64), device=cuda_device)
    before = kernels.launch_counts()
    with pytest.raises(ValueError, match="beyond the kernel's design"):
        v1.blstm_v1_recur(xw, torch.ones(129, dtype=torch.int32, device=cuda_device), wh)
    assert kernels.launch_counts() == before


def test_speller_loss_and_gradients_on_card_match_cpu(cuda_device, tmp_path):
    """A tiny LAS model (location attention, label smoothing) in f32: the
    loss, token accuracy and every gradient on the card against the CPU
    (rtol 1e-4 of each parameter's largest gradient; TF32 off)."""
    from nabu_tpu_torch.config import ConfigFile
    from nabu_tpu_torch.models.model import build_model
    from nabu_tpu_torch.ops.losses import make_loss_computer
    from nabu_tpu_torch.params import flatten, unflatten

    torch.backends.cudnn.allow_tf32 = False
    path = tmp_path / "model.cfg"
    path.write_text(
        "[encoder]\nencoder = listener\nnum_layers = 1\nnum_units = 12\nuse_pallas = true\n"
        "[decoder]\ndecoder = speller\nnum_layers = 2\nnum_units = 10\nembed_dim = 6\n"
        "attention = location\nlocation_width = 5\nlocation_filters = 3\n"
        "loss = cross_entropy\nlabel_smoothing = 0.1\n")
    model = build_model(ConfigFile.read(str(path)), 6, 5)
    flat = flatten(model.init(torch.Generator().manual_seed(0)))
    rng = np.random.default_rng(23)
    batch = {"features": rng.standard_normal((3, 19, 6)).astype(np.float32),
             "feature_lengths": np.asarray([19, 12, 5], np.int32),
             "targets": rng.integers(0, 5, (3, 6)).astype(np.int32),
             "target_lengths": np.asarray([6, 3, 0], np.int32),
             "example_mask": np.ones(3, np.float32)}
    loss_fn = make_loss_computer(model)

    def run(dev):
        leaves = {k: v.to(dev).requires_grad_(True) for k, v in flat.items()}
        b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        loss, metrics = loss_fn(unflatten(leaves), b, None, False)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return (float(loss.detach()), float(metrics["decoder/token_accuracy"]),
                {k: g.cpu().numpy() for k, g in zip(leaves, grads)})

    got, ref = run(cuda_device), run(torch.device("cpu"))
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-5)
    assert got[1] == ref[1]
    for k, g in ref[2].items():
        np.testing.assert_allclose(got[2][k], g, rtol=0, atol=1e-4 * np.abs(g).max() + 1e-12,
                                   err_msg=k)


_JOINT_CFG = (
    "[model]\ndecoders = att ctc\n"
    "[encoder]\nencoder = listener\nnum_layers = 1\nnum_units = 12\nuse_pallas = true\n"
    "[att]\ndecoder = speller\nnum_layers = 2\nnum_units = 10\nembed_dim = 6\n"
    "attention = {attention}\nlocation_width = 5\nlocation_filters = 3\n"
    "[ctc]\ndecoder = linear_ctc\nloss = ctc\n")


def _float64_search(tmp_path, attention, conf):
    """A recognizer of a tiny two-head model (Listener output 24 wide, a
    2 x 10 Speller, a CTC head, 5 labels) and its search over one seeded
    encoder output, in float64 on a device: -> search(device)."""
    from nabu_tpu_torch.config import Conf, ConfigFile
    from nabu_tpu_torch.decoding.recognizers import build_recognizer
    from nabu_tpu_torch.models.model import build_model

    path = tmp_path / "model.cfg"
    path.write_text(_JOINT_CFG.format(attention=attention))
    model = build_model(ConfigFile.read(str(path)), 6, 5)
    params = model.init(torch.Generator().manual_seed(3))["decoders"]
    rec = build_recognizer(Conf(conf, "recognizer"), model)
    rng = np.random.default_rng(31)
    enc = torch.as_tensor(rng.standard_normal((3, 21, 24)))
    lengths = torch.as_tensor([21, 14, 3], dtype=torch.int32)

    def to(tree, dev):
        if isinstance(tree, dict):
            return {k: to(v, dev) for k, v in tree.items()}
        return tree.to(dev, torch.float64)

    def search(dev):
        heads = to(params, dev)
        head_params = heads[rec.head] if not hasattr(rec, "ctc_head") else heads
        return [x.cpu() for x in rec.search(head_params, enc.to(dev), lengths.to(dev))]

    search.rec = rec
    return search


@pytest.mark.parametrize("attention", ["location", "bahdanau", "dot"])
@pytest.mark.parametrize("recognizer", ["attention_beam", "joint_ctc_att_beam"])
def test_attention_beams_on_card_match_cpu_in_float64(cuda_device, tmp_path, attention,
                                                      recognizer):
    """The attention beam and the joint CTC/attention beam (beam 6 over 3
    utterances, 21 frames, length norm 1) on the card against the same
    search on the CPU, both in float64: ids and lengths identical, scores
    within 1e-6 (as chip_smoke's serve checks)."""
    search = _float64_search(tmp_path, attention, {
        "recognizer": recognizer, "beam_width": "6", "length_norm_power": "1.0",
        "att_head": "att", "ctc_head": "ctc", "ctc_weight": "0.3"})
    got, want = search(cuda_device), search(torch.device("cpu"))
    assert got[2].dtype == torch.float64 and got[0].shape == (3, 6, 21)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    np.testing.assert_allclose(got[2].numpy(), want[2].numpy(), rtol=0, atol=1e-6)


_RNNT_CFG = (
    "[encoder]\nencoder = listener\nnum_layers = 1\nnum_units = 12\nuse_pallas = true\n"
    "[decoder]\ndecoder = rnnt\nnum_layers = 1\nnum_units = 8\nembed_dim = 6\n"
    "joint_units = 16\nloss = transducer\n")


def _fused_search(tmp_path, recognizer, kind="ngram"):
    """A beam recognizer of a tiny model (5 labels) fusing a 3-gram
    (``chip_smoke.phase_text_lm``), or with ``kind`` "rnn" an RNN LM
    (``chip_smoke.phase_rnn_lm``, 1 x 32, 30 steps, trained on the CPU),
    at lm_weight 0.3, and its search over one seeded input (the CTC head's
    log-probs, or an encoder output) in float64 on a device: ->
    search(device), (ids, lengths, scores) on the CPU; ``search.rec`` is
    the recognizer."""
    import chip_smoke
    from nabu_tpu_torch.config import Conf, ConfigFile
    from nabu_tpu_torch.decoding.recognizers import build_recognizer
    from nabu_tpu_torch.models.model import build_model
    from nabu_tpu_torch.params import flatten, unflatten

    lm_path = str(tmp_path / "lm.npz")
    if kind == "rnn":
        chip_smoke.phase_rnn_lm(lm_path, 5, 29, device="cpu", num_units=32, num_steps=30)
    else:
        chip_smoke.phase_text_lm(lm_path, 5, 29)
    conf = {"recognizer": recognizer, "beam_width": "6", "nbest": "6",
            "length_norm_power": "1.0", "att_head": "att", "ctc_head": "ctc",
            "ctc_weight": "0.3", "lm_path": lm_path, "lm_weight": "0.3"}
    if recognizer == "ctc_beam":
        return _ctc_fused_search(tmp_path, dict(conf, head="ctc"))
    if recognizer != "transducer_beam":
        return _float64_search(tmp_path, "bahdanau", dict(conf, head="att"))
    path = tmp_path / "rnnt.cfg"
    path.write_text(_RNNT_CFG)
    model = build_model(ConfigFile.read(str(path)), 6, 5)
    params = model.init(torch.Generator().manual_seed(3))["decoders"]["decoder"]
    rec = build_recognizer(Conf(conf, "recognizer"), model)
    rng = np.random.default_rng(37)
    enc = torch.as_tensor(rng.standard_normal((3, 21, 24)))
    lengths = torch.as_tensor([21, 14, 3], dtype=torch.int32)

    def search(dev):
        head = unflatten({k: v.to(dev, torch.float64) for k, v in flatten(params).items()})
        return [x.cpu() for x in rec.search(head, enc.to(dev), lengths.to(dev))]

    search.rec = rec
    return search


def _ctc_fused_search(tmp_path, conf):
    from nabu_tpu_torch.config import Conf, ConfigFile
    from nabu_tpu_torch.decoding.recognizers import build_recognizer
    from nabu_tpu_torch.models.model import build_model

    path = tmp_path / "model.cfg"
    path.write_text(_JOINT_CFG.format(attention="bahdanau"))
    rec = build_recognizer(Conf(conf, "recognizer"), build_model(ConfigFile.read(str(path)),
                                                                 6, 5))
    rng = np.random.default_rng(41)
    lp = torch.log_softmax(torch.as_tensor(3.0 * rng.standard_normal((3, 40, 6))), -1)
    lengths = torch.as_tensor([40, 31, 7], dtype=torch.int32)

    def search(dev):
        return [x.cpu() for x in rec.decode_logprobs(lp.to(dev), lengths.to(dev))]

    search.rec = rec
    return search


@pytest.mark.parametrize("recognizer", ["ctc_beam", "attention_beam", "joint_ctc_att_beam",
                                        "transducer_beam"])
def test_lm_fused_beams_on_card_match_cpu_in_float64(cuda_device, tmp_path, recognizer):
    """Each beam with a 3-gram fused at lm_weight 0.3 (beam 6 over 3
    utterances) on the card against the same search on the CPU, both in
    float64: ids and lengths identical, scores within 1e-6 (as
    chip_smoke's LM-fused passes); the planted stale LM context on the
    card (``chip_smoke.lm_stale_context``) moves the scores beyond it."""
    import chip_smoke

    search = _fused_search(tmp_path, recognizer)
    got, want = search(cuda_device), search(torch.device("cpu"))
    assert got[2].dtype == torch.float64
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    np.testing.assert_allclose(got[2].numpy(), want[2].numpy(), rtol=0, atol=1e-6)
    with chip_smoke.lm_stale_context():
        stale = search(cuda_device)
    assert not torch.equal(stale[0], want[0]) or float(
        (stale[2] - want[2]).abs().max()) > 1e-6


@pytest.mark.parametrize("recognizer", ["ctc_beam", "attention_beam", "joint_ctc_att_beam",
                                        "transducer_beam"])
def test_neural_lm_fused_beams_on_card_match_cpu_in_float64(cuda_device, tmp_path, recognizer):
    """Each beam with an RNN LM fused at lm_weight 0.3, the LM moved to
    float64 (``DenseRnnLM.to``), on the card against the same search on
    the CPU: ids and lengths identical, scores within 1e-6; the planted
    stale LM state on the card (``chip_smoke.rnn_lm_stale_state``) moves
    the scores beyond it."""
    import chip_smoke
    from nabu_tpu_torch.decoding.neural_lm import DenseRnnLM

    search = _fused_search(tmp_path, recognizer, kind="rnn")
    assert isinstance(search.rec.lm, DenseRnnLM)
    search.rec.lm = search.rec.lm.to("cpu", torch.float64)
    got, want = search(cuda_device), search(torch.device("cpu"))
    assert got[2].dtype == torch.float64
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    np.testing.assert_allclose(got[2].numpy(), want[2].numpy(), rtol=0, atol=1e-6)
    with chip_smoke.rnn_lm_stale_state():
        stale = search(cuda_device)
    assert not torch.equal(stale[0], want[0]) or float(
        (stale[2] - want[2]).abs().max()) > 1e-6


def _lm_text(seed=3, n=300, vocab=30):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(0, vocab - 1, int(rng.integers(1, 60)))]
            for _ in range(n)]


def test_neural_lm_training_step_on_card_matches_plain(cuda_device):
    """One batch of the RNN LM at the JAX defaults' widths (1 x 256, embed
    64, B = 64, 31 labels) through the training kernels against the same
    through their plain versions on the card: the worst parameter's
    ||kernel - plain|| / ||plain|| within 1e-4 (f32 on both sides); the
    planted dwh fault (h two steps back) is rejected. Then 3 steps of
    ``RnnLM.train`` launch each training kernel once a step."""
    import chip_smoke
    from nabu_tpu_torch.decoding.neural_lm import RnnLM

    text = _lm_text()
    lm = RnnLM.create(30, device=cuda_device)
    reading = chip_smoke.rnn_lm_gradients(torch, lm, text)
    assert reading["launches"] == {"lstm_fwd_train": 1, "lstm_bwd_recur": 1, "lstm_bwd_dwh": 1}
    assert reading["rel_err"] <= 1e-4, reading
    assert reading["fault_rel_err"] > 1e-4, reading
    kernels.reset_launch_counts()
    RnnLM.train(text, 30, num_steps=3, device=cuda_device)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert [counts[k] for k in ("lstm_fwd_train", "lstm_bwd_recur", "lstm_bwd_dwh")] == [3] * 3


def test_neural_lm_beyond_the_chain_raises_on_card(cuda_device):
    """--lm_units 1024 --lm_batch 64 is beyond the chain's design: training
    raises before any launch."""
    from nabu_tpu_torch.decoding.neural_lm import RnnLM

    before = kernels.launch_counts()
    with pytest.raises(ValueError, match="beyond the kernel's design"):
        RnnLM.train(_lm_text(n=80), 30, num_units=1024, batch_size=64, device=cuda_device)
    assert kernels.launch_counts() == before


def test_neural_lm_grouped_scores_keep_their_bits_on_card(cuda_device):
    """300 lines (more than the walk's 256 rows at H = 256) scored in
    groups equal each line scored alone, bit for bit, through lstm_proj and
    lstm_fwd; and the CPU's plain versions within 1e-4 relative."""
    from nabu_tpu_torch.decoding.neural_lm import RnnLM, walk_rows

    text = _lm_text(5)
    lm = RnnLM.create(30, device=cuda_device, seed=2)
    assert walk_rows(256) == 256 < len(text)
    kernels.reset_launch_counts()
    grouped = lm.seq_logprobs(text)
    counts = kernels.launch_counts()
    assert counts["lstm_fwd"] == 2 and counts["lstm_proj"] == 4
    alone = np.concatenate([lm.seq_logprobs([s]) for s in text])
    np.testing.assert_array_equal(grouped, alone)
    host = RnnLM({k: {kk: vv.cpu() for kk, vv in v.items()} for k, v in lm.params.items()},
                 1, 256, 64, 30)
    np.testing.assert_allclose(grouped, host.seq_logprobs(text), rtol=1e-4)


@pytest.mark.parametrize("rate,n_frames", [
    (16000.0, 297),        # N not a multiple of a block's 64 frames
    (16000.0, 1),
    (16000.0, 32 * 1026),  # a served batch of 32 at the 1026-frame bucket
    (32000.0, 97),         # W = 800 > nfft: the DFT rows past 512 are zero
    (11025.0, 50),         # W = 276, K = 252: the 2-byte copies
])
def test_stft_bf16_kernel_matches_plain(cuda_device, rate, n_frames):
    """The bf16 mode against its plain version (the f32 product of the
    bf16 operands) at chip_smoke's tolerance; the planted dropped tap is
    rejected where the last tap is one of the DFT's (W <= nfft: past nfft
    the table's rows are zero)."""
    import chip_smoke

    fp = tf.make_frontend_params(rate, nfft=512, nfilt=40, device=cuda_device)
    cossin, mel, mr = fp.folded("bf16")
    assert cossin.dtype == torch.bfloat16
    rng = np.random.default_rng(0)
    n = (n_frames - 1) * fp.frame_step + fp.frame_len
    sig = torch.as_tensor((1000.0 * rng.standard_normal(n)).astype(np.float32))
    frames = tf.frame_signal(sig, fp.frame_len, fp.frame_step, n_frames)
    frames = frames.contiguous().to(cuda_device, torch.bfloat16)
    before = kernels.launch_counts()
    got = stft_ops.stft_mel(frames, cossin, mel, mr)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert after["stft_mel_bf16"] == before["stft_mel_bf16"] + 1
    assert after["stft_mel"] == before["stft_mel"]
    ref = stft_ops.stft_mel_plain(frames, cossin, mel)
    atol = chip_smoke.TOL["stft_mel_bf16"][0]
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), atol=atol, rtol=0)
    if fp.frame_len <= fp.nfft:
        fault = chip_smoke.drop_last_tap(stft_ops.stft_mel_plain)(frames, cossin, mel, mr)
        assert float((fault - ref).abs().max()) > atol
    with pytest.raises(TypeError, match="cossin"):
        stft_ops.stft_mel(frames, cossin.float(), mel, mr)


# ---------------------------------------------------------------------------
# the bf16 GEMM of csrc/blstm.cu (TMA + wgmma, split-K for kind 2)
# ---------------------------------------------------------------------------

_GEMM_NAME = {0: "blstm_proj", 1: "blstm_bwd_dx", 2: "blstm_bwd_dwx", 3: "blstm_v1_bwd_gates"}


def _gemm_case(device, kind, dirs, M, N, K, seed=0):
    """Operands of one GEMM launch of ``kind`` in the layouts the wrappers
    hand it (A: [M, K], or [K, M] for kind 2; B: [K, N], or [N, K] for
    kind 1), one per direction, bf16, B scaled by 1 / sqrt(K) so the sums
    stay near 1; -> (launch, reference), each returning (out, colsum)."""
    rng = np.random.default_rng(seed)

    def u(*shape, scale=1.0):
        return torch.as_tensor(
            rng.uniform(-scale, scale, shape).astype(np.float32)).to(device, torch.bfloat16)

    a = u(dirs, K, M) if kind == 2 else u(dirs, M, K)
    b = u(dirs, N, K, scale=K ** -0.5) if kind == 1 else u(dirs, K, N, scale=K ** -0.5)
    bias = u(dirs, N, scale=0.1) if kind == 0 else u(dirs, M, N) if kind == 3 else None
    lda = M if kind == 2 else K
    ldb = K if kind == 1 else N
    f32 = torch.float32

    def launch():
        out = outf = colsum = None
        if kind in (0, 1):
            out = torch.empty((dirs, M, N), dtype=torch.bfloat16, device=device)
        else:
            outf = torch.empty((dirs, M, N), dtype=f32, device=device)
        if kind == 2:
            colsum = torch.empty((dirs, N), dtype=f32, device=device)
        pa = tuple(a[min(d, dirs - 1)].data_ptr() for d in range(2))
        pb = tuple(b[min(d, dirs - 1)].data_ptr() for d in range(2))
        blstm_ops._gemm(_GEMM_NAME[kind], "bf16", pa, pb, lda, ldb, M, N, K, kind,
                        bias=bias, out=out, outf=outf, colsum=colsum, dirs=dirs)
        return (out if out is not None else outf), colsum

    def reference():
        af = a.to(f32).transpose(1, 2) if kind == 2 else a.to(f32)
        bf = b.to(f32).transpose(1, 2) if kind == 1 else b.to(f32)
        acc = torch.matmul(af, bf)
        if kind == 0:
            return acc.to(torch.bfloat16) + bias[:, None, :], None
        if kind == 1:
            return acc.to(torch.bfloat16), None
        if kind == 2:
            return acc, b.to(f32).sum(dim=1)
        return bias.to(f32) + acc, None

    return launch, reference


def _gemm_tol(kind):
    """bf16 outputs (kinds 0, 1): one rounding step where the f32 sums
    differ in their last bits; f32 outputs: sums of the same products in
    another order."""
    return (1e-2, 1e-2) if kind in (0, 1) else (1e-4, 1e-4)


def _assert_close(got, ref, tol, what):
    atol, rtol = tol
    err = (got.float() - ref.float()).abs()
    over = float((err - (atol + rtol * ref.float().abs())).max())
    assert over <= 0, (what, float(err.max()))


@pytest.mark.parametrize("dirs", [1, 2])
@pytest.mark.parametrize("kind,M,N,K", [
    (0, 1000, 1280, 80), (0, 1000, 2048, 120), (0, 77, 1000, 640),
    (1, 1000, 1280, 1280), (1, 1000, 2048, 2048), (1, 300, 1000, 120),
    (2, 80, 1280, 32736), (2, 1000, 2048, 640), (2, 320, 1000, 4100),
    (3, 1000, 2048, 512), (3, 1000, 1280, 2048),
])
def test_gemm_wgmma_matches_plain(cuda_device, kind, M, N, K, dirs):
    """Each kind of the TMA + wgmma GEMM against the same product in f32 on
    the card, with M, N and K off the 128 x 128 x 64 tiles, one and two
    operand pairs; kind 2 with its column sums and, where ``split_k``
    cuts K, its split path."""
    launch, reference = _gemm_case(cuda_device, kind, dirs, M, N, K)
    kernels.reset_launch_counts()
    got, colsum = launch()
    ref, ref_colsum = reference()
    torch.cuda.synchronize()
    assert kernels.variant_counts() == {"gemm_bf16_wgmma": 1, "gemm_bf16_wmma": 0}
    _assert_close(got, ref, _gemm_tol(kind), "out")
    if kind == 2:
        _assert_close(colsum, ref_colsum, (1e-4, 1e-4), "colsum")


@pytest.mark.parametrize("M,N,K", [(320, 1280, 32736), (80, 1280, 32768), (2048, 2048, 640)])
def test_gemm_kind2_split_and_repeat(cuda_device, M, N, K):
    """Kind 2, split (S > 1) and unsplit (S = 1): right against the f32
    product, and a second launch gives the same bits."""
    S = blstm_ops.split_k(2, M, N, K, 2)
    assert (S > 1) == (K > 640), S
    launch, reference = _gemm_case(cuda_device, 2, 2, M, N, K, seed=1)
    first, first_cs = launch()
    second, second_cs = launch()
    ref, ref_cs = reference()
    torch.cuda.synchronize()
    _assert_close(first, ref, _gemm_tol(2), f"S = {S}")
    _assert_close(first_cs, ref_cs, (1e-4, 1e-4), "colsum")
    assert torch.equal(first, second) and torch.equal(first_cs, second_cs)


def test_gemm_variants_of_the_recipe_shapes(cuda_device):
    """The recipes' layouts (v2 at D = 80, H = 320, B = 32; v1 at H = 512,
    B = 64; lstm_proj at D = 320) take only the wgmma kernel; H = 12's dwh
    (the bw h_prev starts H elements into a row: 24 bytes) and H = 9
    (4H = 36) take the wmma kernel, by the same predicate."""
    from nabu_tpu_torch.ops import blstm_v1 as v1
    from nabu_tpu_torch.ops import lstm as lo

    rng = np.random.default_rng(5)

    def u(*shape):
        return torch.as_tensor(rng.uniform(-1, 1, shape).astype(np.float32)).to(
            cuda_device, torch.bfloat16)

    T = 9
    kernels.reset_launch_counts()
    for D, H, B in ((80, 320, 32), (640, 320, 32), (1280, 320, 32)):
        x, dg, y, wx = u(T, B, D), u(2, T, B, 4 * H), u(T, B, 2 * H), u(2, D, 4 * H)
        blstm_ops.blstm_proj(x.view(T * B, D), wx, u(2, 4 * H))
        blstm_ops.blstm_bwd_dx(dg, wx)
        blstm_ops.blstm_bwd_dwx(x, dg)
        blstm_ops.blstm_bwd_dwh(y, dg)
    H, B = 512, 64
    hs, wh = u(2, T + 1, B, H), u(2, H, 4 * H)
    v1.blstm_v1_bwd_gates(u(2, T, B, 4 * H), hs, wh)
    v1.blstm_v1_bwd_dwh(hs, u(2, T, B, 4 * H))
    lo.lstm_proj(u(32 * 8, 320), u(320, 1280), u(1280))
    # a view that starts 2 bytes off a 16-byte boundary: copied, then wgmma
    lo.lstm_proj(u(32 * 8 * 320 + 1)[1:].view(32 * 8, 320), u(320, 1280), u(1280))
    torch.cuda.synchronize()
    assert kernels.variant_counts() == {"gemm_bf16_wgmma": 16, "gemm_bf16_wmma": 0}

    for H, want in ((12, {"gemm_bf16_wgmma": 0, "gemm_bf16_wmma": 1}),
                    (9, {"gemm_bf16_wgmma": 0, "gemm_bf16_wmma": 1})):
        kernels.reset_launch_counts()
        dg, y = u(2, T, 4, 4 * H), u(T, 4, 2 * H)
        got = blstm_ops.blstm_bwd_dwh(y, dg)
        _assert_close(got, blstm_ops.blstm_bwd_dwh_plain(y, dg), (1e-4, 1e-4), f"H = {H}")
        assert kernels.variant_counts() == want, H


def test_gemm_failures_raise_with_the_launch_name(cuda_device, monkeypatch):
    """A tensor map CUDA refuses to encode (the predicate forced to
    pass on H = 12's unaligned bw h_prev) and a launch that fails (three
    operand pairs) raise with the launch's name; nothing runs on the other
    kernel instead."""
    rng = np.random.default_rng(6)
    T, B, H = 9, 4, 12
    dg = torch.as_tensor(rng.uniform(-1, 1, (2, T, B, 4 * H)).astype(np.float32)).to(
        cuda_device, torch.bfloat16)
    y = torch.as_tensor(rng.uniform(-1, 1, (T, B, 2 * H)).astype(np.float32)).to(
        cuda_device, torch.bfloat16)
    kernels.reset_launch_counts()
    with monkeypatch.context() as m:
        m.setattr(blstm_ops, "gemm_variant", lambda lda, ldb, ptrs: "wgmma")
        with pytest.raises(RuntimeError, match="blstm_bwd_dwh: CUDA refused a tensor map"):
            blstm_ops.blstm_bwd_dwh(y, dg)
    launch, _ = _gemm_case(cuda_device, 1, 2, 256, 256, 64)
    with monkeypatch.context() as m:
        m.setattr(blstm_ops, "_gemm", lambda *a, **kw: _gemm_dirs3(*a, **kw))
        with pytest.raises(RuntimeError, match="blstm_bwd_dx: CUDA error"):
            launch()
    torch.cuda.synchronize()
    assert kernels.variant_counts() == {"gemm_bf16_wgmma": 0, "gemm_bf16_wmma": 0}
    assert kernels.launch_counts()["blstm_bwd_dwh"] == kernels.launch_counts()["blstm_bwd_dx"] == 0


_real_gemm = blstm_ops._gemm


def _gemm_dirs3(*args, **kw):
    kw["dirs"] = 3
    return _real_gemm(*args, **kw)


# ---------------------------------------------------------------------------
# the f32 GEMM of csrc/blstm.cu (register-blocked FFMA, split-K for kind 2)
# ---------------------------------------------------------------------------

def _f32_case(device, kind, dirs, M, N, K, seed=0):
    """Operands of one f32 GEMM launch of ``kind`` in the wrappers' layouts
    (as ``_gemm_case``), B scaled by 1 / sqrt(K); -> (launch, reference),
    launch(rows) running the output rows [r0, r1) (A's rows and the addend
    cut to them; every row by default), reference in float64."""
    rng = np.random.default_rng(seed)

    def u(*shape, scale=1.0):
        return torch.as_tensor(rng.uniform(-scale, scale, shape).astype(np.float32)).to(device)

    a = u(dirs, K, M) if kind == 2 else u(dirs, M, K)
    b = u(dirs, N, K, scale=K ** -0.5) if kind == 1 else u(dirs, K, N, scale=K ** -0.5)
    bias = u(dirs, N, scale=0.1) if kind == 0 else u(dirs, M, N) if kind == 3 else None
    lda = M if kind == 2 else K
    ldb = K if kind == 1 else N

    def launch(rows=(0, M)):
        r0, r1 = rows
        m = r1 - r0
        out = torch.empty((dirs, m, N), dtype=torch.float32, device=device)
        colsum = torch.empty((dirs, N), dtype=torch.float32, device=device) if kind == 2 else None
        add = bias[:, r0:r1].contiguous() if kind == 3 else bias
        pa = tuple(a[min(d, dirs - 1), r0:].data_ptr() for d in range(2))
        pb = tuple(b[min(d, dirs - 1)].data_ptr() for d in range(2))
        blstm_ops._gemm(_GEMM_NAME[kind], "f32", pa, pb, lda, ldb, m, N, K, kind, bias=add,
                        out=out if kind <= 1 else None, outf=out if kind >= 2 else None,
                        colsum=colsum, dirs=dirs)
        return out, colsum

    def reference():
        f64 = torch.float64
        af = a.to(f64).transpose(1, 2) if kind == 2 else a.to(f64)
        bf = b.to(f64).transpose(1, 2) if kind == 1 else b.to(f64)
        acc = torch.matmul(af, bf)
        if kind == 0:
            return acc + bias.to(f64)[:, None, :], None
        if kind == 2:
            return acc, b.to(f64).sum(dim=1)
        if kind == 3:
            return acc + bias.to(f64), None
        return acc, None

    return launch, reference


# f32 sums of K products in order (or in S slices) against float64: the
# rounding of a running sum of order 1, ~1e-7 a step
_F32_TOL = (1e-4, 1e-4)


@pytest.mark.parametrize("dirs", [1, 2])
@pytest.mark.parametrize("kind,M,N,K", [
    (0, 1000, 1280, 80), (0, 77, 1001, 640), (0, 300, 36, 11),
    (1, 1000, 1280, 1280), (1, 300, 11, 36), (1, 129, 1000, 120),
    (2, 320, 1280, 32736), (2, 9, 36, 150), (2, 1000, 2048, 640), (2, 321, 1001, 4100),
    (3, 1000, 2048, 512), (3, 150, 36, 9), (3, 130, 1001, 320),
])
def test_gemm_f32_matches_float64(cuda_device, kind, M, N, K, dirs):
    """Each kind of the f32 FFMA GEMM against the float64 product, with M, N
    and K off the 128 x 128 x 16 tiles, one and two operand pairs, leading
    dimensions that are and are not multiples of 4 (16- and 4-byte
    copies); kind 2 with its column sums, split where ``split_k_f32``
    cuts K. No bf16 GEMM runs."""
    launch, reference = _f32_case(cuda_device, kind, dirs, M, N, K)
    kernels.reset_launch_counts()
    got, colsum = launch()
    ref, ref_colsum = reference()
    torch.cuda.synchronize()
    assert kernels.launch_counts()[_GEMM_NAME[kind]] == 1
    assert kernels.variant_counts() == {"gemm_bf16_wgmma": 0, "gemm_bf16_wmma": 0}
    _assert_close(got, ref, _F32_TOL, "out")
    if kind == 2:
        _assert_close(colsum, ref_colsum, _F32_TOL, "colsum")


@pytest.mark.parametrize("M,N,K,dirs", [(320, 1280, 32736, 1), (320, 1280, 32736, 2),
                                        (128, 512, 3840, 2), (2048, 2048, 640, 2)])
def test_gemm_f32_kind2_split_and_repeat(cuda_device, M, N, K, dirs):
    """Kind 2, split (S > 1) and unsplit: right against float64, and a
    second launch gives the same bits, column sums included."""
    S = blstm_ops.split_k_f32(2, M, N, K, dirs)
    assert (S > 1) == (K > 640), S
    launch, reference = _f32_case(cuda_device, 2, dirs, M, N, K, seed=1)
    first, first_cs = launch()
    second, second_cs = launch()
    ref, ref_cs = reference()
    torch.cuda.synchronize()
    _assert_close(first, ref, _F32_TOL, f"S = {S}")
    _assert_close(first_cs, ref_cs, _F32_TOL, "colsum")
    assert torch.equal(first, second) and torch.equal(first_cs, second_cs)


@pytest.mark.parametrize("kind,M,N,K", [(0, 1000, 1280, 320), (1, 1000, 36, 1280),
                                        (3, 1000, 1280, 320), (0, 700, 1001, 9)])
def test_gemm_f32_rows_keep_their_bits_whatever_m(cuda_device, kind, M, N, K):
    """Kinds 0, 1 and 3 never split: rows [37, 237) of an M-row launch
    equal, bit for bit, the same rows launched alone (other tile origins,
    another M), as a streamed chunk's projection must equal the offline
    one's."""
    launch, _ = _f32_case(cuda_device, kind, 2, M, N, K, seed=2)
    whole, _ = launch()
    part, _ = launch((37, 237))
    torch.cuda.synchronize()
    assert torch.equal(whole[:, 37:237], part)


@pytest.mark.parametrize("T,B,H", [(9, 4, 9), (9, 5, 12), (121, 32, 16)])
def test_gemm_f32_wrappers_at_odd_widths(cuda_device, T, B, H):
    """H = 9 and 12: the bw h_prev of dwh starts H elements into a row and
    the leading dimensions (2H, H, 4H = 36) are off 16 bytes, so the
    MN-major operands take the 4-byte copies; every f32 wrapper on the
    GEMM against its plain version."""
    from nabu_tpu_torch.ops import blstm_v1 as v1
    from nabu_tpu_torch.ops import lstm as lo

    rng = np.random.default_rng(7)

    def u(*shape):
        return torch.as_tensor(rng.uniform(-1, 1, shape).astype(np.float32)).to(cuda_device)

    D, H4 = 11, 4 * H
    x, dg, y, wx = u(T, B, D), u(2, T, B, H4), u(T, B, 2 * H), u(2, D, H4)
    hs, wh, xw = u(2, T + 1, B, H), u(2, H, H4), u(2, T, B, H4)
    bias = u(2, H4)
    hl, dxw = hs[0, 1:], xw[0]
    checks = {
        "proj": (blstm_ops.blstm_proj(x.view(T * B, D), wx, bias),
                 blstm_ops.blstm_proj_plain(x.view(T * B, D), wx, bias)),
        "dx": (blstm_ops.blstm_bwd_dx(dg, wx), blstm_ops.blstm_bwd_dx_plain(dg, wx)),
        "dwx": (blstm_ops.blstm_bwd_dwx(x, dg)[0], blstm_ops.blstm_bwd_dwx_plain(x, dg)[0]),
        "db": (blstm_ops.blstm_bwd_dwx(x, dg)[1], blstm_ops.blstm_bwd_dwx_plain(x, dg)[1]),
        "dwh": (blstm_ops.blstm_bwd_dwh(y, dg), blstm_ops.blstm_bwd_dwh_plain(y, dg)),
        "v1_gates": (v1.blstm_v1_bwd_gates(xw, hs, wh), v1.blstm_v1_bwd_gates_plain(xw, hs, wh)),
        "v1_dwh": (v1.blstm_v1_bwd_dwh(hs, dg), v1.blstm_v1_bwd_dwh_plain(hs, dg)),
        "lstm_dwh": (lo.lstm_bwd_dwh(hl, dxw), lo.lstm_bwd_dwh_plain(hl, dxw)),
    }
    torch.cuda.synchronize()
    # both f32, sums in another order (as test_blstm_backward_kernels_match_plain)
    for name, (got, ref) in checks.items():
        _assert_close(got, ref, _F32_TOL, name)


def test_gemm_f32_failures_raise_with_the_launch_name(cuda_device, monkeypatch):
    """A launch the kernel refuses (three operand pairs) and one CUDA
    refuses (a grid of more than 65,535 row tiles) raise with the launch's
    name; nothing is retried and no bf16 GEMM runs instead."""
    kernels.reset_launch_counts()
    launch, _ = _f32_case(cuda_device, 1, 2, 256, 256, 64)
    with monkeypatch.context() as m:
        m.setattr(blstm_ops, "_gemm", lambda *a, **kw: _gemm_dirs3(*a, **kw))
        with pytest.raises(RuntimeError, match="blstm_bwd_dx: CUDA error"):
            launch()
    M = 65536 * 128 + 1
    a = torch.zeros((M, 1), dtype=torch.float32, device=cuda_device)
    b = torch.zeros((1, 1), dtype=torch.float32, device=cuda_device)
    out = torch.empty((1, M, 1), dtype=torch.float32, device=cuda_device)
    with pytest.raises(RuntimeError, match="blstm_bwd_dx: CUDA error"):
        blstm_ops._gemm("blstm_bwd_dx", "f32", (a.data_ptr(),) * 2, (b.data_ptr(),) * 2, 1, 1,
                        M, 1, 1, 1, out=out, dirs=1)
    torch.cuda.synchronize()
    assert kernels.variant_counts() == {"gemm_bf16_wgmma": 0, "gemm_bf16_wmma": 0}
    assert kernels.launch_counts()["blstm_bwd_dx"] == 0


# ---------------------------------------------------------------------------
# the attention encoders and the transformer decoder (PyTorch ops, no kernel
# of their own), and the kernels behind them
# ---------------------------------------------------------------------------

def _conformer_moe(capacity, layers=2, d=64):
    from nabu_tpu_torch.config import Conf
    from nabu_tpu_torch.models.encoders import ConformerEncoder

    return ConformerEncoder(Conf({
        "encoder": "conformer", "num_layers": str(layers), "num_units": str(d),
        "num_heads": "4", "ffn_dim": str(4 * d), "kernel_size": "15", "subsample": "4",
        "moe_experts": "4", "moe_capacity": str(capacity)}, "encoder"), 80)


def _cast(tree, device, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, device, dtype) for k, v in tree.items()}
    return tree.to(device, dtype)


@pytest.mark.parametrize("dtype,capacity,tol", [(torch.float32, 2.0, 1e-4),
                                                (torch.bfloat16, 4.0, 2e-2)])
def test_conformer_moe_encoder_on_card_matches_cpu(cuda_device, dtype, capacity, tol):
    """A conformer of 2 x 64 units with an expert-choice MoE of 4 experts
    (B = 4, T = 400 -> 100 frames, ragged) on the card against the CPU in
    the same dtype: f32 within 1e-4, bf16 within 2e-2 (both relative to
    the output's largest value; padded frames 0 on both). The bf16 case
    runs at capacity 4 = E, where every expert takes every token: each
    device rounds the router's bf16 product in its own order, so at a
    capacity cut a near-tie may pick another token on each."""
    enc = _conformer_moe(capacity)
    params = enc.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(40)
    x = torch.as_tensor(rng.standard_normal((4, 400, 80)).astype(np.float32))
    lengths = torch.as_tensor([400, 311, 150, 9], dtype=torch.int32)
    got, gl = enc.apply(_cast(params, cuda_device, dtype), x.to(cuda_device, dtype),
                        lengths.to(cuda_device))
    ref, rl = enc.apply(_cast(params, "cpu", dtype), x.to(dtype), lengths)
    assert torch.equal(gl.cpu(), rl) and got.dtype == dtype
    got, ref = got.float().cpu(), ref.float()
    err = float((got - ref).abs().max() / ref.abs().max())
    assert err <= tol, err
    for b, n in enumerate(rl.tolist()):
        assert not got[b, n:].any()


def test_moe_output_bits_repeat_on_card(cuda_device):
    """The MoE layer's scatter-add runs one expert at a time (each expert's
    tokens distinct), so two launches give the same bits: the layer alone at
    B x T = 32 x 250 tokens, 8 experts at capacity 2 (tokens picked by
    several experts), and a bf16 conformer with it."""
    from nabu_tpu_torch.config import Conf
    from nabu_tpu_torch.models.encoders import ConformerEncoder

    conf = {"encoder": "conformer", "num_layers": "1", "num_units": "256", "num_heads": "4",
            "ffn_dim": "1024", "subsample": "4", "moe_experts": "8", "moe_capacity": "2.0"}
    enc = ConformerEncoder(Conf(conf, "encoder"), 80)
    p = _cast(enc.init(torch.Generator().manual_seed(1)), cuda_device, torch.bfloat16)
    y = torch.randn((32, 250, 256), generator=torch.Generator().manual_seed(2)).to(
        cuda_device, torch.bfloat16)
    valid = torch.arange(250, device=cuda_device)[None] < torch.randint(
        100, 251, (32, 1), generator=torch.Generator().manual_seed(3)).to(cuda_device)
    runs = [enc._moe_ffn(p["block_0"], y, valid) for _ in range(2)]
    assert torch.equal(runs[0], runs[1]) and bool(runs[0].abs().sum() > 0)
    x = torch.randn((4, 400, 80), generator=torch.Generator().manual_seed(4)).to(
        cuda_device, torch.bfloat16)
    lengths = torch.as_tensor([400, 300, 200, 100], device=cuda_device)
    outs = [enc.apply(p, x, lengths)[0] for _ in range(2)]
    assert torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 5e-2)])
def test_transformer_decoder_cached_step_matches_apply_on_card(cuda_device, dtype, tol):
    """chip_smoke's cache check on the card at conformer_aed's decoder width
    (4 x 256, 4 heads, 30 outputs), 4 utterances of 120 encoder frames and
    60 labels: the cached step chain within ``tol`` of the parallel apply
    (relative to its largest logit), and the planted fault (each step's K
    / V one slot late) beyond the bf16 tolerance."""
    import chip_smoke
    from nabu_tpu_torch.config import Conf
    from nabu_tpu_torch.models.decoders import TransformerDecoder

    dec = TransformerDecoder(Conf({"decoder": "transformer", "num_layers": "4",
                                   "num_units": "256", "num_heads": "4", "ffn_dim": "1024"},
                                  "att"), 256, 29)
    p = _cast(dec.init(torch.Generator().manual_seed(5)), cuda_device, dtype)
    g = torch.Generator().manual_seed(6)
    enc = torch.randn((4, 120, 256), generator=g).to(cuda_device, dtype)
    lengths = torch.as_tensor([120, 97, 64, 61], device=cuda_device)
    targets = torch.randint(0, 29, (4, 60), generator=g).to(cuda_device)
    reading = chip_smoke.cache_check(torch, dec, p, enc, lengths, targets)
    with chip_smoke.kv_one_slot_late(dec):
        fault = chip_smoke.cache_check(torch, dec, p, enc, lengths, targets)
    print(json.dumps({"dtype": str(dtype), "cache_step_vs_apply": reading, "fault": fault}))
    assert reading <= tol and fault > chip_smoke.TOL["aed_cache_bf16"], (reading, fault)


def test_conformer_rnnt_training_step_on_card_matches_plain(cuda_device, tmp_path):
    """A conformer_rnnt-shaped model (2 conformer blocks of 64 units, K =
    15, time / 4; the 1 x 320 prediction LSTM, 128-wide embeddings, the
    320-wide joint, 29 outputs) in bf16, B = 8, T = 400, 40 labels: one
    training step's loss and gradients through the RNN-T kernels and the
    prediction net's LSTM kernels (each launched) against the same step
    through their plain versions on the card: the loss within chip_smoke's
    train_loss tolerance, every gradient within 0.02 ||k - p|| / ||p||, and
    the planted fault (the prediction net's dwh paired with h one step
    late) beyond it; each lane's last frame out of dpred is reported (its
    share of dpred over ~100 frames a lane sits near the tolerance)."""
    import chip_smoke
    from nabu_tpu_torch.config import ConfigFile
    from nabu_tpu_torch.models.model import build_model
    from nabu_tpu_torch.ops import transducer_fused
    from nabu_tpu_torch.ops.losses import make_loss_computer
    from nabu_tpu_torch.params import flatten, unflatten

    path = tmp_path / "model.cfg"
    path.write_text(
        "[model]\ncompute_dtype = bfloat16\n"
        "[encoder]\nencoder = conformer\nnum_layers = 2\nnum_units = 64\nnum_heads = 4\n"
        "ffn_dim = 256\nkernel_size = 15\nsubsample = 4\ndropout = 0.1\n"
        "[decoder]\ndecoder = rnnt\nnum_layers = 1\nnum_units = 320\nembed_dim = 128\n"
        "joint_units = 320\nloss = transducer\nuse_pallas = true\n")
    model = build_model(ConfigFile.read(str(path)), 80, 28)
    flat = {k: v.to(cuda_device) for k, v in
            flatten(model.init(torch.Generator().manual_seed(7))).items()}
    rng = np.random.default_rng(8)
    batch = {"features": torch.as_tensor(rng.standard_normal((8, 400, 80)).astype(np.float32),
                                         device=cuda_device, dtype=torch.bfloat16),
             "feature_lengths": torch.as_tensor([400, 380, 350, 300, 260, 220, 200, 160],
                                                device=cuda_device, dtype=torch.int32),
             "targets": torch.as_tensor(rng.integers(0, 28, (8, 40)), device=cuda_device,
                                        dtype=torch.int32),
             "target_lengths": torch.as_tensor([40, 38, 35, 30, 26, 22, 20, 0],
                                               device=cuda_device, dtype=torch.int32),
             "example_mask": torch.ones(8, device=cuda_device)}
    loss_fn = make_loss_computer(model)

    def step():
        leaves = {k: v.clone().requires_grad_(True) for k, v in flat.items()}
        loss, _ = loss_fn(unflatten(leaves), batch, None, False)
        return loss.detach(), dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))

    kernels.reset_launch_counts()
    loss_k, grads_k = step()
    launched = {k: v for k, v in kernels.launch_counts().items() if v}
    assert launched == {"lstm_fwd_train": 1, "lstm_bwd_recur": 1, "lstm_bwd_dwh": 1,
                        "rnnt_joint_fwd": 1, "rnnt_alpha": 1, "rnnt_beta": 1,
                        "rnnt_joint_bwd": 1}, launched
    with chip_smoke.plain_versions():
        loss_p, grads_p = step()
    with chip_smoke.plain_versions(lstm_bwd_dwh=chip_smoke.lstm_dwh_h_late(torch)):
        _, grads_f = step()
    with chip_smoke.plain_versions(
            rnnt_joint_bwd=chip_smoke.rnnt_last_frame_out_of_dpred(torch, transducer_fused)):
        _, grads_s = step()

    def rel(grads):
        return {k: float((grads[k] - grads_p[k]).float().norm()
                         / grads_p[k].float().norm().clamp(min=1e-30)) for k in grads_p}

    atol, rtol = chip_smoke.TOL["train_loss"]
    assert abs(float(loss_k) - float(loss_p)) <= atol + rtol * abs(float(loss_p))
    worst = max(rel(grads_k).values())
    fault = max(rel(grads_f).values())
    print(json.dumps({"grads_max_rel_err": worst, "fault": fault,
                      "last_frame_out_of_dpred": max(rel(grads_s).values())}))
    assert worst <= chip_smoke.TOL["train_grads"] < fault, (worst, fault)


# a training step's and a recognizer call's launches of each attention
# recipe: the CTC loss, or the prediction net's LSTM kernels and the four
# RNN-T kernels; decoding, the transducer joint's encoder projection only
_RECIPE_LAUNCHES = {
    "transformer_ctc_wsj": ({"ctc_alpha": 1, "ctc_beta": 1}, {}),
    "moe_conformer_ctc_wsj": ({"ctc_alpha": 1, "ctc_beta": 1}, {}),
    "conformer_aed_wsj": ({"ctc_alpha": 1, "ctc_beta": 1}, {}),
    "conformer_rnnt_wsj": ({"lstm_fwd_train": 1, "lstm_bwd_recur": 1, "lstm_bwd_dwh": 1,
                            "rnnt_joint_fwd": 1, "rnnt_alpha": 1, "rnnt_beta": 1,
                            "rnnt_joint_bwd": 1}, {"lstm_proj": 1}),
}


@pytest.mark.parametrize("recipe", sorted(_RECIPE_LAUNCHES))
def test_attention_recipes_launch_their_kernels_on_card(cuda_device, recipe):
    """Each attention recipe's model.cfg as committed (full widths, bf16,
    seeded weights), B = 4 utterances of 1-4 s: one training step (loss and
    gradients, dropout on) launches the head's kernels once each and no
    other, with finite loss and gradients; the recipe's recognizer.cfg
    (beam 16 or 8) over the same batch launches only the decode kernels
    of ``_RECIPE_LAUNCHES`` and returns finite scores."""
    import os

    from nabu_tpu_torch.config import Recipe
    from nabu_tpu_torch.decoding.recognizers import build_recognizer
    from nabu_tpu_torch.models.model import build_model
    from nabu_tpu_torch.ops.losses import make_loss_computer
    from nabu_tpu_torch.params import flatten, unflatten

    step_launches, decode_launches = _RECIPE_LAUNCHES[recipe]
    r = Recipe(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                            "config", "recipes", recipe))
    model = build_model(r.model, 80, 28)
    flat = {k: v.to(cuda_device) for k, v in
            flatten(model.init(torch.Generator().manual_seed(9))).items()}
    rng = np.random.default_rng(10)
    flen = np.asarray([400, 310, 200, 100], np.int32)
    feats = rng.standard_normal((4, 400, 80)).astype(np.float32)
    batch = {"features": torch.as_tensor(feats, device=cuda_device, dtype=model.compute_dtype),
             "feature_lengths": torch.as_tensor(flen, device=cuda_device),
             "targets": torch.as_tensor(rng.integers(0, 28, (4, 20)), device=cuda_device,
                                        dtype=torch.int32),
             "target_lengths": torch.as_tensor([20, 15, 10, 5], device=cuda_device,
                                               dtype=torch.int32),
             "example_mask": torch.ones(4, device=cuda_device)}
    leaves = {k: v.clone().requires_grad_(True) for k, v in flat.items()}
    kernels.reset_launch_counts()
    loss, _ = make_loss_computer(model)(unflatten(leaves), batch,
                                        torch.Generator(device=cuda_device).manual_seed(0), True)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    torch.cuda.synchronize()
    assert {k: v for k, v in kernels.launch_counts().items() if v} == step_launches
    assert bool(torch.isfinite(loss)) and all(bool(torch.isfinite(g).all()) for g in grads)
    rec = build_recognizer(r.recognizer.section("recognizer"), model)
    kernels.reset_launch_counts()
    nb = rec(unflatten(flat), feats, flen)
    assert {k: v for k, v in kernels.launch_counts().items() if v} == decode_launches
    assert np.isfinite(nb.scores[:, 0]).all()


# ---------------------------------------------------------------------------
# data-parallel training (parallel.mesh) on the card
# ---------------------------------------------------------------------------

_DP_MODEL = """[model]
compute_dtype = float32
decoders = att ctc

[encoder]
encoder = listener
num_layers = 2
num_units = 64
dropout = 0.0
use_pallas = true

[att]
decoder = speller
num_layers = 1
num_units = 48
embed_dim = 16
attention = bahdanau
sample_prob = 0.0
loss = cross_entropy
label_smoothing = 0.1
loss_weight = 0.7

[ctc]
decoder = linear_ctc
loss = ctc
use_pallas = true
loss_weight = 0.3
"""

_DP_WORKER = """
import sys
import numpy as np
import torch
import torch.distributed as dist
from nabu_tpu_torch.config import ConfigFile
from nabu_tpu_torch.models.model import build_model
from nabu_tpu_torch.ops.losses import make_loss_computer
from nabu_tpu_torch.parallel import mesh
from nabu_tpu_torch.params import flatten, load_npz, unflatten

rank, world, backend, root = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
device = mesh.init_distributed(sys.argv[5], world, rank, backend=backend)
assert dist.get_backend() == backend and device.type == "cuda", (dist.get_backend(), device)
model = build_model(ConfigFile.read(f"{root}/model.cfg"), 12, 7)
with np.load(f"{root}/batch.npz") as z:
    n = len(z["example_mask"]) // world
    batch = {k: torch.as_tensor(z[k][n * rank:n * (rank + 1)], device=device) for k in z.files}
out = {}
for name, loss_fn in (("dp", make_loss_computer(model, mesh.sum_over_ranks)),
                      ("naive", make_loss_computer(model))):
    leaves = {k: v.requires_grad_(True)
              for k, v in flatten(load_npz(f"{root}/params.npz", device)).items()}
    loss, _ = loss_fn(unflatten(leaves), batch, None, False)
    grads = list(torch.autograd.grad(loss, list(leaves.values())))
    local = [g.clone() for g in grads]
    mesh.all_reduce_sum_(grads)
    # a group of one: the sum is a copy, bit for bit
    out[f"{name}_kept_bits"] = np.asarray(
        world == 1 and all(torch.equal(a, b) for a, b in zip(local, grads)))
    scale = 1.0 if name == "dp" else 1.0 / world
    out.update({f"{name}/{k}": (g * scale).cpu().numpy() for k, g in zip(leaves, grads)})
counts = torch.tensor([3.0, 17.0, 123456.0], device=device)
out["counts"] = mesh.sum_over_ranks(counts).cpu().numpy()
np.savez(f"{root}/{backend}_rank{rank}.npz", **out)
mesh.destroy()
print("DP_DONE", rank, flush=True)
"""


def _dp_ranks(tmp_path, world, backend):
    import os
    import socket
    import subprocess
    import sys

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _DP_WORKER, str(r), str(world), backend,
                               str(tmp_path), f"127.0.0.1:{port}"],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env) for r in range(world)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"DP_DONE {r}" in out, out[-3000:]
    return [dict(np.load(tmp_path / f"{backend}_rank{r}.npz")) for r in range(world)]


def _dp_inputs(tmp_path, device):
    """The small joint model's parameters and a batch of 8 lanes (rank 0
    holds an example CTC cannot align, the last rank's last lane is a
    fill lane), and their one-process gradient on the card."""
    from nabu_tpu_torch.config import ConfigFile
    from nabu_tpu_torch.models.model import build_model
    from nabu_tpu_torch.ops.losses import make_loss_computer
    from nabu_tpu_torch.params import flatten, to_flat_numpy, unflatten

    (tmp_path / "model.cfg").write_text(_DP_MODEL)
    model = build_model(ConfigFile.read(str(tmp_path / "model.cfg")), 12, 7)
    params = to_flat_numpy(model.init(torch.Generator().manual_seed(4)))
    np.savez(tmp_path / "params.npz", **params)
    rng = np.random.default_rng(6)
    T = 96
    lengths = np.asarray([96, 8, 70, 50, 96, 81, 33, 0], np.int32)
    tl = np.asarray([7, 9, 5, 4, 8, 6, 2, 0], np.int32)
    feats = rng.standard_normal((8, T, 12)).astype(np.float32)
    feats[np.arange(T)[None, :] >= lengths[:, None]] = 0.0
    targets = rng.integers(0, 7, (8, 9)).astype(np.int32)
    targets[np.arange(9)[None, :] >= tl[:, None]] = 0
    batch = {"features": feats, "feature_lengths": lengths, "targets": targets,
             "target_lengths": tl, "example_mask": (lengths > 0).astype(np.float32)}
    np.savez(tmp_path / "batch.npz", **batch)
    leaves = {k: torch.as_tensor(v, device=device).requires_grad_(True)
              for k, v in params.items()}
    loss, _ = make_loss_computer(model)(
        unflatten(leaves), {k: torch.as_tensor(v, device=device) for k, v in batch.items()},
        None, False)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return {k: g.cpu().numpy() for k, g in zip(flatten(unflatten(leaves)), grads)}


def test_dp_two_gloo_ranks_match_the_concatenated_batch(cuda_device, tmp_path):
    """Two ranks (gloo over CUDA tensors on one card) on the two halves:
    their summed gradient is the one-process gradient of the whole batch
    (rtol 1e-4, atol 1e-5), the same bits on both ranks; the mean of the
    ranks' mean gradients misses it."""
    want = _dp_inputs(tmp_path, cuda_device)
    r0, r1 = _dp_ranks(tmp_path, 2, "gloo")
    assert all(np.array_equal(r0[k], r1[k]) for k in r0)
    assert r0["counts"].tolist() == [6.0, 34.0, 246912.0]
    for k, g in want.items():
        np.testing.assert_allclose(r0[f"dp/{k}"], g, rtol=1e-4, atol=1e-5, err_msg=k)
    assert any(not np.allclose(r0[f"naive/{k}"], g, rtol=1e-4, atol=1e-5)
               for k, g in want.items())


def test_dp_nccl_world_of_one_keeps_the_bits(cuda_device, tmp_path):
    """One NCCL rank: the gradients' all-reduce leaves their bits as they
    are, the counts' all-reduce gives the counts exactly, and the rank's
    gradient is the one-process gradient (rtol 1e-4, atol 1e-5: the CTC
    backward's scatter_add_ sums a label's posteriors with atomics, so two
    runs of the backward may differ in the last bits)."""
    want = _dp_inputs(tmp_path, cuda_device)
    (got,) = _dp_ranks(tmp_path, 1, "nccl")
    assert bool(got["dp_kept_bits"]) and bool(got["naive_kept_bits"])
    assert got["counts"].tolist() == [3.0, 17.0, 123456.0]
    for k, g in want.items():
        for name in ("dp", "naive"):
            np.testing.assert_allclose(got[f"{name}/{k}"], g, rtol=1e-4, atol=1e-5,
                                       err_msg=f"{name} {k}")


# -- MWER and forced alignment ------------------------------------------------

_MWER_MODEL = """[model]
compute_dtype = float32
decoders = att ctc

[encoder]
encoder = listener
num_layers = 1
num_units = 24
dropout = 0.0
use_pallas = true

[att]
decoder = speller
num_layers = 2
num_units = 32
embed_dim = 16
attention = bahdanau
sample_prob = 0.0
loss = cross_entropy
label_smoothing = 0.1
loss_weight = 0.7

[ctc]
decoder = linear_ctc
loss = ctc
use_pallas = true
loss_weight = 0.3
"""


def test_mwer_step_on_card_matches_cpu(cuda_device, tmp_path):
    """One MWER step (beam 4, mwer_ce_weight 0.5) of a small f32 joint
    model, B = 6, T = 80: its N-best searched on the card launches the
    inference walks and no training kernel; fed the same N-best, the step
    on the card (training walks, chain, CTC kernels) gives the CPU's loss,
    metrics and gradients."""
    from nabu_tpu_torch.config import Conf, ConfigFile
    from nabu_tpu_torch.models.model import build_model
    from nabu_tpu_torch.ops.mwer import make_mwer_loss_computer
    from nabu_tpu_torch.params import flatten, unflatten

    (tmp_path / "model.cfg").write_text(_MWER_MODEL)
    model = build_model(ConfigFile.read(str(tmp_path / "model.cfg")), 10, 9)
    flat = flatten(model.init(torch.Generator().manual_seed(21)))
    rng = np.random.default_rng(22)
    T = 80
    lengths = np.asarray([80, 71, 64, 50, 33, 0], np.int32)
    tl = np.asarray([12, 10, 9, 7, 4, 0], np.int32)
    feats = rng.standard_normal((6, T, 10)).astype(np.float32)
    feats[np.arange(T)[None, :] >= lengths[:, None]] = 0.0
    targets = rng.integers(0, 9, (6, 12)).astype(np.int32)
    targets[np.arange(12)[None, :] >= tl[:, None]] = 0
    batch = {"features": feats, "feature_lengths": lengths, "targets": targets,
             "target_lengths": tl, "example_mask": (lengths > 0).astype(np.float32)}
    loss_fn = make_mwer_loss_computer(model, Conf({"mwer_beam": "4", "mwer_ce_weight": "0.5"}))

    def on(device):
        return ({k: v.to(device) for k, v in flat.items()},
                {k: torch.as_tensor(v, device=device) for k, v in batch.items()})

    cpu_flat, cpu_batch = on("cpu")
    nbest = loss_fn.search(unflatten(cpu_flat), cpu_batch)
    kernels.reset_launch_counts()
    card_flat, card_batch = on(cuda_device)
    card_nbest = loss_fn.search(unflatten(card_flat), card_batch)
    searched = {k: v for k, v in kernels.launch_counts().items() if v}
    assert searched == {"blstm_proj": 2, "blstm_recur": 2}, searched
    assert card_nbest[0].shape == nbest[0].shape

    def step(leaves, b, fed):
        leaves = {k: v.clone().requires_grad_(True) for k, v in leaves.items()}
        loss, metrics = loss_fn(unflatten(leaves), b, None, False, nbest=fed)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return (float(loss), {k: float(v) for k, v in metrics.items()},
                {k: g.cpu() for k, g in zip(leaves, grads)})

    want = step(cpu_flat, cpu_batch, nbest)
    kernels.reset_launch_counts()
    got = step(card_flat, card_batch, tuple(x.to(cuda_device) for x in nbest))
    launched = {k: v for k, v in kernels.launch_counts().items() if v}
    assert launched == {"blstm_proj": 2, "blstm_recur_train": 2, "blstm_bwd_recur": 2,
                        "blstm_bwd_dx": 1, "blstm_bwd_dwx": 2, "blstm_bwd_dwh": 2,
                        "ctc_alpha": 1, "ctc_beta": 1}, launched
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    for k, v in want[1].items():
        np.testing.assert_allclose(got[1][k], v, rtol=1e-5, atol=1e-7, err_msg=k)
    assert want[1]["mwer/expected_errors"] > want[1]["mwer/oracle_errors"]
    for k, g in want[2].items():
        np.testing.assert_allclose(got[2][k].numpy(), g.numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    assert float(sum(g.norm() for g in got[2].values())) > 0.0


def test_mwer_token_edit_distance_on_card_matches_cpu(cuda_device):
    from nabu_tpu_torch.ops.mwer import token_edit_distance

    rng = np.random.default_rng(23)
    B, L, U = 256, 60, 50
    args = [rng.integers(0, 6, (B, L)), rng.integers(0, L + 1, B),
            rng.integers(0, 6, (B, U)), rng.integers(0, U + 1, B)]
    args = [torch.as_tensor(a.astype(np.int32)) for a in args]
    want = token_edit_distance(*args)
    got = token_edit_distance(*(a.to(cuda_device) for a in args))
    assert got.device.type == "cuda" and torch.equal(got.cpu(), want)


@pytest.mark.parametrize("whole", [False, True], ids=["real", "ties"])
def test_align_viterbi_on_card_matches_cpu(cuda_device, whole):
    """B = 16, T = 400, U <= 80 labels with repeats, V = 30: the frame
    labels identical and the path scores within 1e-5 (ties: log-probs of
    whole numbers); chip_smoke's planted skip into a repeated label merges
    a repeat on the card, where emissions favor the labels."""
    import chip_smoke
    from nabu_tpu_torch.decoding.align import ctc_forced_align

    rng = np.random.default_rng(24 + int(whole))
    B, T, U, V = 16, 400, 80, 30
    logits = 3.0 * rng.standard_normal((B, T, V))
    lp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    lp = np.round(lp) if whole else lp
    lengths = rng.integers(2 * U + 10, T + 1, B)
    tl = rng.integers(U // 2, U + 1, B)
    targets = rng.integers(0, V - 1, (B, U))
    targets[:, 5] = targets[:, 4]
    args = [torch.as_tensor(a) for a in (lp.astype(np.float32), lengths.astype(np.int32),
                                         targets.astype(np.int32), tl.astype(np.int32))]
    want = ctc_forced_align(*args, V - 1)
    got = ctc_forced_align(*(a.to(cuda_device) for a in args), V - 1)
    assert torch.equal(got[0].cpu(), want[0])
    np.testing.assert_allclose(got[1].cpu().numpy(), want[1].numpy(), rtol=0, atol=1e-5)
    assert all(chip_smoke.collapses_to(want[0][b], lengths[b], targets[b, :tl[b]], V - 1)
               for b in range(B))

    sharp = torch.as_tensor(chip_smoke.label_emissions(targets, tl, lengths, T, V))
    sargs = [sharp.to(cuda_device), *(a.to(cuda_device) for a in args[1:])]
    frames, _ = ctc_forced_align(*sargs, V - 1)
    assert all(chip_smoke.collapses_to(frames[b], lengths[b], targets[b, :tl[b]], V - 1)
               for b in range(B))
    with chip_smoke.align_repeat_skip():
        faulty, _ = ctc_forced_align(*sargs, V - 1)
    assert not all(chip_smoke.collapses_to(faulty[b], lengths[b], targets[b, :tl[b]], V - 1)
                   for b in range(B))

