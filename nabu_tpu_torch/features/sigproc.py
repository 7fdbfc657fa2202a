"""Numpy signal-processing primitives for feature extraction.

Capability parity with the reference's sigproc layer
(nabu/processing/feature_computers/base.py, itself derived from
python_speech_features): pre-emphasis, framing, windowing,
magnitude/power spectra, mel scale, filterbanks, DCT and liftering.
These are the golden oracles for the device-side STFT+Mel kernel.
"""

from __future__ import annotations

import numpy as np


def preemphasis(signal: np.ndarray, coeff: float = 0.97) -> np.ndarray:
    """y[t] = x[t] - coeff * x[t-1] (y[0] = x[0])."""
    if coeff == 0.0:
        return signal.astype(np.float32)
    signal = np.asarray(signal, dtype=np.float32)
    return np.concatenate([signal[:1], signal[1:] - coeff * signal[:-1]])


def framesig(
    signal: np.ndarray, frame_len: int, frame_step: int
) -> np.ndarray:
    """Slice a 1-D signal into overlapping frames, zero-padding the tail.

    Returns [num_frames, frame_len]; num_frames = 1 for signals shorter
    than one frame, else 1 + ceil((len - frame_len) / frame_step).
    """
    signal = np.asarray(signal, dtype=np.float32)
    slen = len(signal)
    if slen <= frame_len:
        num_frames = 1
    else:
        num_frames = 1 + int(np.ceil((slen - frame_len) / frame_step))
    pad_len = (num_frames - 1) * frame_step + frame_len
    padded = np.concatenate(
        [signal, np.zeros(pad_len - slen, dtype=np.float32)]
    )
    idx = (
        np.arange(frame_len)[None, :]
        + np.arange(num_frames)[:, None] * frame_step
    )
    return padded[idx]


def window(frame_len: int, kind: str = "hamming") -> np.ndarray:
    kind = kind.lower()
    if kind in ("none", "rect", "rectangular"):
        return np.ones(frame_len, dtype=np.float32)
    if kind == "hamming":
        return np.hamming(frame_len).astype(np.float32)
    if kind in ("hanning", "hann"):
        return np.hanning(frame_len).astype(np.float32)
    if kind == "povey":  # Kaldi's povey window: hann^0.85
        n = np.arange(frame_len)
        hann = 0.5 - 0.5 * np.cos(2 * np.pi * n / (frame_len - 1))
        return (hann ** 0.85).astype(np.float32)
    raise ValueError(f"unknown window {kind!r}")


def magspec(frames: np.ndarray, nfft: int) -> np.ndarray:
    """|rFFT| of each frame -> [num_frames, nfft//2 + 1]."""
    return np.abs(np.fft.rfft(frames, nfft)).astype(np.float32)


def powspec(frames: np.ndarray, nfft: int) -> np.ndarray:
    """Power spectrum (1/nfft)*|rFFT|^2 -> [num_frames, nfft//2 + 1]."""
    return (1.0 / nfft) * np.square(magspec(frames, nfft))


def hz2mel(hz):
    return 2595.0 * np.log10(1.0 + np.asarray(hz, dtype=np.float64) / 700.0)


def mel2hz(mel):
    return 700.0 * (10.0 ** (np.asarray(mel, dtype=np.float64) / 2595.0) - 1.0)


def get_filterbanks(
    nfilt: int,
    nfft: int,
    samplerate: float,
    lowfreq: float = 0.0,
    highfreq: float | None = None,
) -> np.ndarray:
    """Triangular mel filterbank matrix [nfilt, nfft//2 + 1]."""
    highfreq = highfreq or samplerate / 2.0
    if highfreq > samplerate / 2.0:
        raise ValueError("highfreq is greater than samplerate/2")
    lowmel = hz2mel(lowfreq)
    highmel = hz2mel(highfreq)
    melpoints = np.linspace(lowmel, highmel, nfilt + 2)
    # fft bin indices of the filter corner frequencies
    bins = np.floor((nfft + 1) * mel2hz(melpoints) / samplerate).astype(int)

    fbank = np.zeros([nfilt, nfft // 2 + 1], dtype=np.float64)
    for j in range(nfilt):
        for i in range(bins[j], bins[j + 1]):
            fbank[j, i] = (i - bins[j]) / max(bins[j + 1] - bins[j], 1)
        for i in range(bins[j + 1], bins[j + 2]):
            fbank[j, i] = (bins[j + 2] - i) / max(bins[j + 2] - bins[j + 1], 1)
    return fbank.astype(np.float32)


def dct_matrix(numcep: int, nfilt: int) -> np.ndarray:
    """Orthonormal DCT-II matrix [numcep, nfilt] (scipy.fftpack.dct norm='ortho')."""
    n = np.arange(nfilt)
    k = np.arange(numcep)[:, None]
    mat = np.cos(np.pi * k * (2 * n + 1) / (2.0 * nfilt))
    mat *= np.sqrt(2.0 / nfilt)
    mat[0] /= np.sqrt(2.0)
    return mat.astype(np.float32)


def lifter(cepstra: np.ndarray, ceplifter: int = 22) -> np.ndarray:
    """Sinusoidal liftering of cepstral coefficients."""
    if ceplifter <= 0:
        return cepstra
    n = np.arange(cepstra.shape[1])
    lift = 1.0 + (ceplifter / 2.0) * np.sin(np.pi * n / ceplifter)
    return (cepstra * lift).astype(np.float32)


def delta(feat: np.ndarray, n: int = 2) -> np.ndarray:
    """Delta features with +-N regression window (Kaldi/HTK convention)."""
    if n < 1:
        raise ValueError("delta window must be >= 1")
    num_frames = len(feat)
    denom = 2.0 * sum(i * i for i in range(1, n + 1))
    padded = np.pad(feat, ((n, n), (0, 0)), mode="edge")
    out = np.zeros_like(feat, dtype=np.float32)
    for t in range(num_frames):
        out[t] = (
            np.arange(-n, n + 1)[:, None] * padded[t : t + 2 * n + 1]
        ).sum(axis=0) / denom
    return out


def add_dynamics(feat: np.ndarray, kind: str) -> np.ndarray:
    """Append delta / delta-delta features per the `dynamic` config."""
    kind = (kind or "nodelta").lower()
    if kind in ("nodelta", "none", ""):
        return feat
    d1 = delta(feat)
    if kind == "delta":
        return np.concatenate([feat, d1], axis=1)
    if kind in ("ddelta", "deltadelta", "delta-delta"):
        d2 = delta(d1)
        return np.concatenate([feat, d1, d2], axis=1)
    raise ValueError(f"unknown dynamic kind {kind!r}")


def cmvn(feat: np.ndarray, variance: bool = True) -> np.ndarray:
    """Per-utterance cepstral mean (and variance) normalization."""
    mean = feat.mean(axis=0, keepdims=True)
    out = feat - mean
    if variance:
        std = feat.std(axis=0, keepdims=True)
        out = out / np.maximum(std, 1e-10)
    return out.astype(np.float32)
