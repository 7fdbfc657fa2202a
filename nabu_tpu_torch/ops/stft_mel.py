"""Fused STFT power spectrum + Mel + log: CUDA kernel wrapper and its
plain PyTorch version.

Port of the JAX package's ``ops/pallas/stft_mel.py``. The window is
folded into the DFT matrix and 1/nfft into the mel matrix on the host,
once per sample rate (``fold_constants``), exactly as the TPU wrapper
folds them; the plain version then computes ``log(max((f @ C)^2 + (f @
S)^2) @ mel', 1e-30))`` for a batch of frames, in f32 from the DFT
product on.

Two modes, by the operands' dtype, as the TPU kernel's ``dft_dtype``:

- f32 frames and table: the kernel (``csrc/stft_mel.cu``,
  ``nabu_stft_mel_f32``) computes the same products in the same order on
  the FMA pipes, fused with the power, a sparse Mel product and the log;
- bf16 frames and table (the table rounded once, after the window fold):
  the exact products of the bf16 values summed in f32, on the tensor cores
  (``nabu_stft_mel_bf16``, counted as ``stft_mel_bf16``), then the f32
  kernel's power, Mel product and log. The plain version widens both
  operands (exactly) and takes their f32 product, the JAX kernel's
  ``preferred_element_type=f32`` function. A bf16 DFT puts more noise
  into near-silent mel bins than the f32 one: serving opts into it
  (``frontend_dft_dtype = bf16``); f32 stays the default.

Besides the folded operands the kernels read each filter's bin range and
weights (``mel_ranges``, made beside ``fold_constants``).

``stft_mel`` launches a kernel for CUDA tensors and takes the plain
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

_fns: dict = {}
DFT_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class MelRanges:
    """The Mel matrix as the kernel reads it: each filter's bin range and
    its weights."""

    ranges: torch.Tensor  # [M, 3] int32: first bin, end bin, offset in weights
    weights: torch.Tensor  # [nnz] f32: mel / nfft over each filter's range


def fold_constants(window, dft_cos, dft_sin, mel, nfft: int, dft_dtype=torch.float32):
    """-> (cossin [W, 2K] window-folded cos|sin in ``dft_dtype``, folded in
    f32 and rounded once after the fold, mel / nfft [K, M] f32)."""
    wcol = window.to(torch.float32)[:, None]
    cossin = torch.cat([dft_cos * wcol, dft_sin * wcol], dim=1)
    return (
        cossin.to(torch.float32).to(dft_dtype).contiguous(),
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
    matrix products: the f32 product of the operands as they are (f32, or
    bf16 widened exactly)."""
    K = cossin.shape[1] // 2
    cs = frames.to(torch.float32) @ cossin.to(torch.float32)
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


def _launcher(tag: str):
    if tag not in _fns:
        fn = getattr(build.load("stft_mel"), f"nabu_stft_mel_{tag}")
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[tag] = fn
    return _fns[tag]


def stft_mel(frames, cossin, mel_scaled, mr: MelRanges) -> torch.Tensor:
    """[N, W] raw frames -> [N, M] log-mel (f32), frames and cossin both
    f32 or both bf16 (the mode). CPU tensors take the plain version; CUDA
    tensors launch the mode's kernel, which reads the Mel matrix as ``mr``
    (``mel_ranges`` of the same mel_scaled)."""
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
    dft = frames.dtype
    if dft not in (torch.float32, torch.bfloat16):
        raise TypeError(f"stft_mel: frames must be float32 or bfloat16, got {dft}")
    for name, t, dtype in (("frames", frames, dft), ("cossin", cossin, dft),
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
    tag = "bf16" if dft == torch.bfloat16 else "f32"
    name = "stft_mel_bf16" if tag == "bf16" else "stft_mel"
    with torch.cuda.device(frames.device):
        err = _launcher(tag)(
            frames.data_ptr(), cossin.data_ptr(), mr.ranges.data_ptr(), mr.weights.data_ptr(),
            out.data_ptr(), N, W, K, M, mr.weights.shape[0],
            torch.cuda.current_stream().cuda_stream,
        )
    build.check(err, name)
    kernels.LAUNCHES[name] += 1
    return out
