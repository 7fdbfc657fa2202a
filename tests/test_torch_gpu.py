"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device and skips without one. The file
imports neither jax nor the JAX package, so it also runs where only
PyTorch is installed:

    python -m pytest tests/test_torch_gpu.py -q --noconftest

(``--noconftest``: the suite's conftest configures JAX). Small shapes,
including ones off the kernels' fast paths: H and D not multiples of 8,
S = 2L + 1 larger than a block's threads, logit length 1, label length
0, an infeasible CTC example; for the RNN-T kernels U + 1 over one
32-row tile, T over one 16-frame block, target lengths 0 and a logit
length 0. Each kernel is held to its plain version for values, and the
layer and the CTC and RNN-T losses on the card to the same through the
plain versions on the CPU for gradients. Tolerances as in
``chip_smoke.py``: log-mel and BLSTM f32 1e-4; BLSTM bf16 one rounding
step of the carried h or dgates, propagated (stated per test); CTC f32
1e-5; RNN-T log-probs 1e-4, log-likelihood 1e-3, occupancies 1e-4,
joint gradients 1e-3 + 1e-3 |x|.
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


def test_stft_mel_kernel_matches_plain(cuda_device):
    fp = tf.make_frontend_params(16000.0, nfft=512, nfilt=40, device=cuda_device)
    cossin, mel = fp.folded()
    rng = np.random.default_rng(0)
    sig = torch.as_tensor((1000.0 * rng.standard_normal(48000)).astype(np.float32))
    frames = tf.frame_signal(sig, 400, 160, 297).contiguous().to(cuda_device)  # N % 32 != 0
    before = kernels.launch_counts()["stft_mel"]
    got = stft_ops.stft_mel(frames, cossin, mel)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["stft_mel"] == before + 1
    ref = stft_ops.stft_mel_plain(frames, cossin, mel)
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), atol=1e-4, rtol=0)


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


def test_untagged_recipe_trains_through_the_kernels_on_card(cuda_device, tmp_path):
    """A dblstm_ctc model that sets no ``use_pallas`` still runs the BLSTM
    and CTC kernels on the card, forward and backward; a forward-only
    stack, whose LSTM kernel is not ported, raises there."""
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
        if bidirectional == "false":
            with pytest.raises(NotImplementedError, match="not ported yet"):
                loss_fn(unflatten(flat), batch, None, False)
            continue
        kernels.reset_launch_counts()
        loss, _ = loss_fn(unflatten(flat), batch, None, False)
        grads = torch.autograd.grad(loss, list(flat.values()))
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        assert all(bool(torch.isfinite(g).all()) for g in grads)
        for name in ("blstm_proj", "blstm_recur_train", "blstm_bwd_recur", "blstm_bwd_dx",
                     "blstm_bwd_dwx", "blstm_bwd_dwh", "ctc_alpha", "ctc_beta"):
            assert counts[name] > 0, (name, counts)


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
        stft_ops.stft_mel(z(4, 400, dtype=torch.bfloat16), z(400, 512), z(256, 40))


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


@pytest.mark.parametrize("B,T,U,J,V", [(4, 9, 5, 16, 6), (5, 37, 40, 48, 29)])
def test_rnnt_kernels_match_plain(cuda_device, B, T, U, J, V):
    """Each RNN-T kernel against its plain version on the same inputs, and
    each planted fault of chip_smoke.py rejected by the tolerance: the
    last of the J products dropped (joint forward), the emit term dropped
    from the prefix (alpha), the blank occupancy read with beta[t] (beta),
    each lane's last frame left out of d_pred_proj (joint backward). The
    joint backward repeats bit for bit (fixed-order sums)."""
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
        "gb": (chip_smoke.rnnt_beta_read_early(torch, rnnt_ops)(rb, re, ra, rll, g, *lens)[0],
               rgb),
        "dpred": (chip_smoke.rnnt_last_frame_out_of_dpred(torch, rnnt_ops)(*bwd)[1], ref[1]),
    }

    def tol(name, r):
        if name in ("lp_blank", "lp_emit"):
            return 1e-4 + 1e-5 * np.abs(r)
        if name in ("ll", "alphas"):
            return 1e-3 + 1e-5 * np.abs(r)
        if name in ("gb", "ge"):
            return 1e-4
        return 1e-3 + 1e-3 * np.abs(r)

    over, sound = _readings(checks, tol)
    over_f, fault = _readings(faults, tol)
    passed = sorted(set(faults) - set(over_f))
    assert not over and not passed, {"beyond tolerance": over, "faults passing": passed,
                                     "sound": sound, "fault": fault}


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
