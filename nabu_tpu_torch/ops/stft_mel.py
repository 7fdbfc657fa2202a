"""Fused STFT power spectrum + Mel + log: CUDA kernel wrapper and its
plain PyTorch version.

Port of the JAX package's ``ops/pallas/stft_mel.py``. The window is
folded into the DFT matrix and 1/nfft into the mel matrix on the host,
once per sample rate (``fold_constants``), exactly as the TPU wrapper
folds them; the kernel then computes ``log(max((f @ C)^2 + (f @ S)^2)
@ mel', 1e-30))`` for a batch of frames, in f32 throughout.

``stft_mel`` launches ``csrc/stft_mel.cu`` for CUDA tensors and takes the
plain version only for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from nabu_tpu_torch.ops import kernels
from nabu_tpu_torch.ops.kernels import build

_fn = None


def fold_constants(window, dft_cos, dft_sin, mel, nfft: int):
    """-> (cossin [W, 2K] window-folded cos|sin, mel / nfft [K, M]),
    both f32."""
    wcol = window.to(torch.float32)[:, None]
    cossin = torch.cat([dft_cos * wcol, dft_sin * wcol], dim=1)
    return (
        cossin.to(torch.float32).contiguous(),
        (mel.to(torch.float32) / nfft).contiguous(),
    )


def stft_mel_plain(frames, cossin, mel_scaled) -> torch.Tensor:
    """[N, W] frames -> [N, M] log-mel, the kernel's arithmetic as
    matrix products."""
    K = cossin.shape[1] // 2
    cs = frames.to(torch.float32) @ cossin
    re, im = cs[:, :K], cs[:, K:]
    power = re * re + im * im
    return torch.log(torch.clamp(power @ mel_scaled, min=1e-30))


def _launcher():
    global _fn
    if _fn is None:
        fn = build.load("stft_mel").nabu_stft_mel_f32
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def stft_mel(frames, cossin, mel_scaled) -> torch.Tensor:
    """[N, W] raw frames (f32) -> [N, M] log-mel (f32)."""
    if frames.device.type == "cpu":
        return stft_mel_plain(frames, cossin, mel_scaled)
    if frames.device.type != "cuda":
        raise ValueError(f"stft_mel: unsupported device {frames.device}")
    N, W = frames.shape
    W2, K2 = cossin.shape
    K, M = mel_scaled.shape
    if W2 != W or K2 != 2 * K:
        raise ValueError(
            f"stft_mel: shapes frames {tuple(frames.shape)}, cossin "
            f"{tuple(cossin.shape)}, mel {tuple(mel_scaled.shape)} disagree"
        )
    for name, t in (("frames", frames), ("cossin", cossin), ("mel", mel_scaled)):
        if t.dtype != torch.float32:
            raise TypeError(f"stft_mel: {name} must be float32, got {t.dtype}")
        if t.device != frames.device:
            raise ValueError(f"stft_mel: {name} is on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"stft_mel: {name} must be contiguous")
    out = torch.empty((N, M), dtype=torch.float32, device=frames.device)
    with torch.cuda.device(frames.device):
        err = _launcher()(
            frames.data_ptr(), cossin.data_ptr(), mel_scaled.data_ptr(),
            out.data_ptr(), N, W, K, M,
            torch.cuda.current_stream().cuda_stream,
        )
    build.check(err, "stft_mel")
    kernels.LAUNCHES["stft_mel"] += 1
    return out
