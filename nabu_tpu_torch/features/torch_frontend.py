"""Device-side feature extraction: batched STFT + log-Mel on tensors.

Port of the JAX package's ``features/jax_frontend.py``. The spectrum is
computed against precomputed DFT cos/sin matrices (frames [N, W] @ dft
[W, K]); the STFT+Mel step runs as the CUDA kernel
(``ops.stft_mel``, f32 or bf16 DFT operands: the ``dft_dtype`` of the JAX
package's Pallas kernel) on the card, while pre-emphasis, framing, DCT,
energy, deltas and CMVN stay plain torch around it, as they are XLA
around the Pallas call in JAX. Golden-tested against the numpy
computers and against the JAX frontend.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from nabu_tpu_torch.features import sigproc
from nabu_tpu_torch.ops import stft_mel as stft_mel_ops


@dataclasses.dataclass(frozen=True)
class FrontendParams:
    """Non-trainable frontend constants (f32 tensors on one device)."""

    window: torch.Tensor  # [frame_len]
    dft_cos: torch.Tensor  # [frame_len, K]
    dft_sin: torch.Tensor  # [frame_len, K]
    mel: torch.Tensor  # [K, nfilt]
    frame_len: int
    frame_step: int
    nfft: int
    preemph: float

    def folded(self, dft_dtype: str = "f32"):
        """(cossin [W, 2K] in the ``dft_dtype`` ("f32" or "bf16"), mel /
        nfft [K, M], the Mel matrix as the kernel reads it) for
        ``stft_mel``."""
        cossin, mel = stft_mel_ops.fold_constants(
            self.window, self.dft_cos, self.dft_sin, self.mel, self.nfft,
            dft_torch_dtype(dft_dtype),
        )
        return cossin, mel, stft_mel_ops.mel_ranges(mel)


def dft_torch_dtype(dft_dtype: str) -> torch.dtype:
    """"f32" or "bf16" (``frontend_dft_dtype``) -> the DFT operands'
    dtype; any other value raises."""
    if dft_dtype not in stft_mel_ops.DFT_DTYPES:
        raise ValueError(
            f"dft_dtype {dft_dtype!r}: one of {sorted(stft_mel_ops.DFT_DTYPES)}")
    return stft_mel_ops.DFT_DTYPES[dft_dtype]


def make_frontend_params(
    rate: float,
    winlen: float = 0.025,
    winstep: float = 0.010,
    nfft: int = 512,
    nfilt: int = 40,
    window: str = "hamming",
    preemph: float = 0.97,
    lowfreq: float = 0.0,
    highfreq: float | None = None,
    device="cpu",
) -> FrontendParams:
    frame_len = int(round(winlen * rate))
    frame_step = int(round(winstep * rate))
    k = nfft // 2 + 1
    n = np.arange(frame_len)[:, None]  # frames are zero-padded to nfft
    freqs = np.arange(k)[None, :]
    ang = 2.0 * np.pi * n * freqs / nfft
    # rfft(x, nfft) truncates frames longer than nfft: samples past nfft
    # contribute nothing, so zero their DFT rows
    trunc = (n < nfft).astype(np.float32)
    dft_cos = np.cos(ang) * trunc
    dft_sin = -np.sin(ang) * trunc
    melmat = sigproc.get_filterbanks(nfilt, nfft, rate, lowfreq, highfreq).T
    # drop trailing DFT bins whose mel rows are exactly zero (the Nyquist
    # bin always is): numerically inert, and K goes from nfft//2+1 = 257
    # to 256
    while melmat.shape[0] > 1 and not melmat[-1].any():
        melmat = melmat[:-1]
        dft_cos = dft_cos[:, :-1]
        dft_sin = dft_sin[:, :-1]

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return FrontendParams(
        window=f32(sigproc.window(frame_len, window)),
        dft_cos=f32(dft_cos),
        dft_sin=f32(dft_sin),
        mel=f32(melmat),
        frame_len=frame_len,
        frame_step=frame_step,
        nfft=nfft,
        preemph=preemph,
    )


def num_frames(num_samples: int, frame_len: int, frame_step: int) -> int:
    if num_samples <= frame_len:
        return 1
    return 1 + int(np.ceil((num_samples - frame_len) / frame_step))


def frame_signal(
    signal: torch.Tensor, frame_len: int, frame_step: int, n_frames: int
) -> torch.Tensor:
    """[..., S] -> [..., n_frames, frame_len] (zero-padded tail)."""
    pad_len = (n_frames - 1) * frame_step + frame_len
    S = signal.shape[-1]
    if pad_len > S:
        signal = torch.nn.functional.pad(signal, (0, pad_len - S))
    return signal[..., :pad_len].unfold(-1, frame_len, frame_step)


def log_mel_spectrogram(
    fp: FrontendParams, signal: torch.Tensor, n_frames: int, dft_dtype: str = "f32"
) -> torch.Tensor:
    """One utterance [S] -> log-mel features [n_frames, nfilt] through the
    STFT+Mel kernel (its plain version for CPU tensors), with f32 or bf16
    DFT operands: "bf16" is the JAX package's ``use_pallas=True`` path
    (the Pallas kernel's default ``dft_dtype``), "f32" its jnp path."""
    consts = fp.folded(dft_dtype)
    sig = signal.to(torch.float32)
    if fp.preemph:
        sig = torch.cat([sig[:1], sig[1:] - fp.preemph * sig[:-1]])
    frames = frame_signal(sig, fp.frame_len, fp.frame_step, n_frames)
    return stft_mel_ops.stft_mel(frames.to(consts[0].dtype).contiguous(), *consts)


def _delta_clip(feat: torch.Tensor, lens: torch.Tensor, n: int = 2):
    """Per-utterance delta with edge handling at the TRUE length:
    out[t] = sum_i i * feat[clip(t+i, 0, len-1)] / (2 * sum i^2)."""
    B, T, D = feat.shape
    t = torch.arange(T, device=feat.device)[None, :]
    denom = 2.0 * sum(i * i for i in range(1, n + 1))
    hi = torch.clamp(lens.to(feat.device).long() - 1, min=0)[:, None]
    acc = torch.zeros_like(feat)
    for i in range(-n, n + 1):
        if i == 0:
            continue
        idx = torch.minimum(torch.clamp(t + i, min=0), hi)  # [B, T]
        acc = acc + i * torch.gather(feat, 1, idx[..., None].expand(B, T, D))
    return acc / denom


def _cmvn_masked(feat: torch.Tensor, lens: torch.Tensor):
    """Per-utterance mean/variance normalization over the true frames."""
    T = feat.shape[1]
    lens = lens.to(feat.device)
    mask = (torch.arange(T, device=feat.device)[None, :] < lens[:, None])[..., None]
    cnt = torch.clamp(lens, min=1).to(feat.dtype)[:, None, None]
    zero = torch.zeros((), dtype=feat.dtype, device=feat.device)
    mean = torch.where(mask, feat, zero).sum(1, keepdim=True) / cnt
    centered = feat - mean
    std = torch.sqrt(
        torch.where(mask, centered * centered, zero).sum(1, keepdim=True) / cnt
    )
    return torch.where(mask, centered / torch.clamp(std, min=1e-10), zero)


def frame_lengths(slens: np.ndarray, frame_len: int, frame_step: int) -> np.ndarray:
    slen = np.asarray(slens)
    return np.where(
        slen <= frame_len,
        1,
        1 + np.ceil((slen - frame_len) / frame_step).astype(np.int64),
    ).astype(np.int32)


def device_features(
    fp: FrontendParams,
    consts,  # (cossin, mel_scaled, mel ranges) from fp.folded(dft_dtype)
    dct,  # [numcep, nfilt] or None (fbank)
    lift,  # [numcep] or None
    signals: torch.Tensor,  # [B, S] zero-padded float32
    slens: torch.Tensor,  # [B] true sample counts
    n_frames: int,
    norm,  # None | (mean [dim], std [dim])
    *,
    energy: bool,
    dynamic: str,
    mvn: bool,
) -> torch.Tensor:
    """The whole feature pipeline of features/computers.py on tensors:
    preemphasis -> framing -> STFT+Mel [-> DCT+lifter] [-> +energy]
    [-> +deltas] [-> CMVN]. The frames go to the STFT+Mel kernel in the
    table's dtype (the mode); the energy reads them in f32. Frames past
    each utterance's true frame count are zeros past CMVN/normalization
    (masked downstream by the frame lengths)."""
    B, S = signals.shape
    dev = signals.device
    slens = slens.to(dev)
    pos = torch.arange(S, device=dev)[None, :]
    if fp.preemph:
        pre = torch.cat(
            [signals[:, :1], signals[:, 1:] - fp.preemph * signals[:, :-1]], dim=1
        )
    else:
        pre = signals
    # the host path preemphasizes the UNPADDED signal then zero-pads
    pre = torch.where(pos < slens[:, None], pre, torch.zeros((), device=dev))
    frames = frame_signal(pre, fp.frame_len, fp.frame_step, n_frames)
    flat = frames.reshape(B * n_frames, fp.frame_len)
    base = stft_mel_ops.stft_mel(flat.to(consts[0].dtype).contiguous(), *consts)
    if dct is not None:
        base = base @ dct.T
        if lift is not None:
            base = base * lift[None, :]
    feat = base.reshape(B, n_frames, -1)
    if energy:
        e = torch.log(
            torch.clamp(torch.sum(flat * flat, dim=-1), min=1e-30)
        ).reshape(B, n_frames, 1)
        feat = torch.cat([e, feat], dim=-1)
    flens = torch.where(
        slens <= fp.frame_len,
        torch.ones_like(slens),
        1 + torch.ceil((slens - fp.frame_len) / fp.frame_step).to(slens.dtype),
    )
    if dynamic not in ("nodelta", "none", ""):
        d1 = _delta_clip(feat, flens)
        if dynamic == "delta":
            feat = torch.cat([feat, d1], dim=-1)
        elif dynamic in ("ddelta", "deltadelta", "delta-delta"):
            feat = torch.cat([feat, d1, _delta_clip(d1, flens)], dim=-1)
    if mvn:
        feat = _cmvn_masked(feat, flens)
    if norm is not None:
        mean, std = norm
        t_mask = (torch.arange(n_frames, device=dev)[None, :] < flens[:, None])[..., None]
        feat = torch.where(
            t_mask, (feat - mean[None, None]) / std[None, None],
            torch.zeros((), device=dev),
        )
    return feat


class DeviceFrontend:
    """Feature extraction on the device for the serving hot path.

    Built from a database.conf ``[features]`` section when its options
    are exactly representable on the device (``make`` returns None
    otherwise and callers fall back to the host computers): ``feature =
    fbank | mfcc`` with ``include_energy``, ``dynamic = delta | ddelta``
    and per-utterance CMVN (``mvn``). The STFT+Mel runs as the CUDA
    kernel for CUDA tensors, with ``frontend_dft_dtype`` operands: f32,
    the default (features as the host f32 computers give them, which
    training read), or bf16, the opt-in mode on the tensor cores, which
    puts more noise into near-silent mel bins. Any other value raises.
    """

    def __init__(self, sec, device="cpu"):
        from nabu_tpu_torch.features.computers import make_feature_computer

        self.computer = make_feature_computer(sec)
        self.feature = sec.get("feature", "fbank")
        self.device = torch.device(device)
        self.dft_dtype = sec.get("frontend_dft_dtype", "f32")
        dft_torch_dtype(self.dft_dtype)  # raises on another value
        self._consts_cache = {}
        self._norm = None

    def set_normalization(self, mean, std) -> None:
        """Apply corpus-level CMVN stats after feature computation."""
        self._norm = (
            torch.as_tensor(np.asarray(mean, np.float32), device=self.device),
            torch.clamp(
                torch.as_tensor(np.asarray(std, np.float32), device=self.device),
                min=1e-10,
            ),
        )

    @classmethod
    def make(cls, sec, device="cpu") -> "DeviceFrontend | None":
        if sec.get("processor", "audio") not in ("audio", "audio_processor"):
            return None
        if sec.get("feature", "fbank") not in ("fbank", "mfcc"):
            return None
        fe = cls(sec, device)
        if (fe.computer.dynamic or "nodelta").lower() not in (
            "nodelta", "none", "", "delta", "ddelta", "deltadelta",
            "delta-delta",
        ):
            return None
        return fe

    @property
    def dim(self) -> int:
        return self.computer.dim

    def _consts(self, rate: float):
        if rate not in self._consts_cache:
            c = self.computer
            fp = make_frontend_params(
                rate, c.winlen, c.winstep, c.nfft,
                getattr(c, "nfilt", 40), c.window, c.preemph,
                getattr(c, "lowfreq", 0.0), getattr(c, "highfreq", None),
                device=self.device,
            )
            dct = lift = None
            if self.feature == "mfcc":
                dct = torch.as_tensor(
                    sigproc.dct_matrix(c.numcep, c.nfilt), device=self.device
                )
                if c.ceplifter > 0:
                    n = np.arange(c.numcep)
                    lift = torch.as_tensor(
                        (1.0 + (c.ceplifter / 2.0) * np.sin(np.pi * n / c.ceplifter))
                        .astype(np.float32),
                        device=self.device,
                    )
            self._consts_cache[rate] = (fp, fp.folded(self.dft_dtype), dct, lift)
        return self._consts_cache[rate]

    def frame_geometry(self, rate: float):
        fp = self._consts(rate)[0]
        return fp.frame_len, fp.frame_step

    def __call__(self, signals, sample_lengths, rate: float):
        """[B, S] zero-padded signals + true sample counts -> (features
        [B, NF, dim] tensor on the frontend's device, frame lengths [B]
        numpy)."""
        fp, consts, dct, lift = self._consts(rate)
        nf = num_frames(signals.shape[1], fp.frame_len, fp.frame_step)
        c = self.computer
        feats = device_features(
            fp, consts, dct, lift,
            torch.as_tensor(np.asarray(signals, np.float32), device=self.device),
            torch.as_tensor(np.asarray(sample_lengths, np.int64), device=self.device),
            nf,
            self._norm,
            energy=c.include_energy,
            dynamic=(c.dynamic or "nodelta").lower(),
            mvn=c.mvn,
        )
        return feats, frame_lengths(sample_lengths, fp.frame_len, fp.frame_step)

    def batch_features(self, signals, rate: float, batch_rows: int,
                       t_bucket: int = 512):
        """Pad a list of same-rate 1-D signals into one [batch_rows, S]
        array (S bucketed as in the JAX frontend) and compute features.
        Rows past len(signals) are zero fill with sample length 1."""
        frame_len, frame_step = self.frame_geometry(rate)
        s_bucket = (t_bucket - 1) * frame_step + frame_len
        S = max(len(s) for s in signals)
        S = ((S + s_bucket - 1) // s_bucket) * s_bucket
        batch = np.zeros((batch_rows, S), np.float32)
        slens = np.ones((batch_rows,), np.int32)
        for i, s in enumerate(signals):
            batch[i, : len(s)] = s
            slens[i] = len(s)
        return self(batch, slens, rate)
