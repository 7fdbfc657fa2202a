"""Fused STFT power spectrum + Mel + log: CUDA kernel wrapper and its
plain PyTorch version.

Port of the JAX package's ``ops/pallas/stft_mel.py``. The window is
folded into the DFT matrix and 1/nfft into the mel matrix on the host,
once per sample rate (``fold_constants``), exactly as the TPU wrapper
folds them; the plain version then computes ``log(max((f @ C)^2 + (f @
S)^2) @ mel', 1e-30))`` for a batch of frames, in f32 throughout.

The kernel (``csrc/stft_mel.cu``) computes the same products in the same
order, fused with the power, a sparse Mel product and the log. Besides
the folded operands it reads each filter's bin range and weights
(``mel_ranges``, made beside ``fold_constants``).

``stft_mel`` launches the kernel for CUDA tensors and takes the plain
version only for CPU tensors.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from nabu_tpu_torch.ops import kernels
from nabu_tpu_torch.ops.kernels import build

# csrc/stft_mel.cu: the bins a block holds, and the largest filter count
# and packed weight count its shared memory is sized for
MAX_BINS = 256
MAX_FILTERS = 512
MAX_WEIGHTS = 8192

_fn = None


@dataclasses.dataclass(frozen=True)
class MelRanges:
    """The Mel matrix as the kernel reads it: each filter's bin range and
    its weights."""

    ranges: torch.Tensor  # [M, 3] int32: first bin, end bin, offset in weights
    weights: torch.Tensor  # [nnz] f32: mel / nfft over each filter's range


def fold_constants(window, dft_cos, dft_sin, mel, nfft: int):
    """-> (cossin [W, 2K] window-folded cos|sin, mel / nfft [K, M]),
    both f32."""
    wcol = window.to(torch.float32)[:, None]
    cossin = torch.cat([dft_cos * wcol, dft_sin * wcol], dim=1)
    return (
        cossin.to(torch.float32).contiguous(),
        (mel.to(torch.float32) / nfft).contiguous(),
    )


def mel_ranges(mel_scaled) -> MelRanges:
    """[K, M] mel / nfft -> each filter's first and end bin, from its
    first to its last non-zero, with the offset of its weights, and the
    weights, the filters' ranges one after another (on mel_scaled's
    device). A filter with no non-zero has the empty range (0, 0)."""
    mel = mel_scaled.detach().cpu().numpy()
    K, M = mel.shape
    ranges = np.zeros((M, 3), np.int32)
    weights = []
    off = 0
    for m in range(M):
        nz = np.flatnonzero(mel[:, m])
        lo, hi = (int(nz[0]), int(nz[-1]) + 1) if nz.size else (0, 0)
        ranges[m] = (lo, hi, off)
        weights.append(mel[lo:hi, m])
        off += hi - lo
    dev = mel_scaled.device
    return MelRanges(
        ranges=torch.as_tensor(ranges, device=dev),
        weights=torch.as_tensor(np.concatenate(weights).astype(np.float32), device=dev),
    )


def stft_mel_plain(frames, cossin, mel_scaled) -> torch.Tensor:
    """[N, W] frames -> [N, M] log-mel, the kernel's arithmetic as
    matrix products."""
    K = cossin.shape[1] // 2
    cs = frames.to(torch.float32) @ cossin
    re, im = cs[:, :K], cs[:, K:]
    power = re * re + im * im
    return torch.log(torch.clamp(power @ mel_scaled, min=1e-30))


def check_design(K: int, M: int, mr: MelRanges) -> None:
    """Raise for a shape the kernel's design does not hold: more than
    MAX_BINS bins (a block holds all of a frame's), more filters or
    weights than its shared memory is sized for, ranges of another
    filter count. (``mel_ranges`` keeps each filter's bins within the K
    rows of its mel matrix.)"""
    nnz = mr.weights.shape[0]
    if K > MAX_BINS or M > MAX_FILTERS or nnz > MAX_WEIGHTS:
        raise ValueError(f"stft_mel: K = {K} bins, M = {M} filters, {nnz} weights are beyond "
                         f"the kernel's design ({MAX_BINS}, {MAX_FILTERS}, {MAX_WEIGHTS})")
    if tuple(mr.ranges.shape) != (M, 3):
        raise ValueError(f"stft_mel: ranges {tuple(mr.ranges.shape)}, want ({M}, 3)")


def _launcher():
    global _fn
    if _fn is None:
        fn = build.load("stft_mel").nabu_stft_mel_f32
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def stft_mel(frames, cossin, mel_scaled, mr: MelRanges) -> torch.Tensor:
    """[N, W] raw frames (f32) -> [N, M] log-mel (f32). CPU tensors take
    the plain version; CUDA tensors launch the kernel, which reads the Mel
    matrix as ``mr`` (``mel_ranges`` of the same mel_scaled)."""
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
    for name, t, dtype in (("frames", frames, torch.float32), ("cossin", cossin, torch.float32),
                           ("mel", mel_scaled, torch.float32), ("ranges", mr.ranges, torch.int32),
                           ("weights", mr.weights, torch.float32)):
        if t.dtype != dtype:
            raise TypeError(f"stft_mel: {name} must be {dtype}, got {t.dtype}")
        if t.device != frames.device:
            raise ValueError(f"stft_mel: {name} is on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"stft_mel: {name} must be contiguous")
    check_design(K, M, mr)
    out = torch.empty((N, M), dtype=torch.float32, device=frames.device)
    with torch.cuda.device(frames.device):
        err = _launcher()(
            frames.data_ptr(), cossin.data_ptr(), mr.ranges.data_ptr(), mr.weights.data_ptr(),
            out.data_ptr(), N, W, K, M, mr.weights.shape[0],
            torch.cuda.current_stream().cuda_stream,
        )
    build.check(err, "stft_mel")
    kernels.LAUNCHES["stft_mel"] += 1
    return out
