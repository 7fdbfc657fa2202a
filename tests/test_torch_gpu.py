"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device and skips without one. The file
imports neither jax nor the JAX package, so it also runs where only
PyTorch is installed:

    python -m pytest tests/test_torch_gpu.py -q --noconftest

(``--noconftest``: the suite's conftest configures JAX). Small shapes,
including ones off the kernels' fast paths (H and D not multiples of 8).
Tolerances as in ``chip_smoke.py``: log-mel and BLSTM f32 1e-4; BLSTM
bf16 one rounding step of the carried h, propagated (4e-2).
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


@pytest.fixture
def cuda_device():
    """A CUDA device, or a skip: decided when the test runs, never at
    import, so every worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _layer(rng, D, H, device, dtype):
    def u(*shape, scale):
        return torch.as_tensor(
            rng.uniform(-scale, scale, shape).astype(np.float32)).to(device, dtype)

    return {
        d: {"wx": u(D, 4 * H, scale=0.3), "wh": u(H, 4 * H, scale=0.3),
            "b": u(4 * H, scale=0.3)}
        for d in ("fw", "bw")
    }


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
    assert all(counts[name] > 0 for name in kernels.KERNELS), counts
    got = [line.split(" ", 1)[1] if " " in line else "" for line in out.getvalue().splitlines()]
    assert got == want
