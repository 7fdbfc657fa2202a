"""Config-driven feature computers (fbank / mfcc / frames / spec).

Host-side numpy computers, copied from the JAX package's
``features/computers.py``: a ``FeatureComputer`` is built from a config
section and maps ``(signal, rate) -> [T, dim] float32``, with optional
energy append, delta/delta-delta dynamics, and per-utterance CMVN.

The JAX package's fbank may take a native C++ fast path
(``use_native``); the port always takes the numpy path, whose output
equals the native one to tolerance. ``use_native`` is accepted and
ignored.
"""

from __future__ import annotations

import numpy as np

from nabu_tpu_torch.config import Conf
from nabu_tpu_torch.features import sigproc
from nabu_tpu_torch.registry import FEATURE_COMPUTERS


class FeatureComputer:
    """Base feature computer: framing/window config + post-processing."""

    def __init__(self, conf: Conf):
        self.conf = conf
        self.winlen = conf.getfloat("winlen", 0.025)
        self.winstep = conf.getfloat("winstep", 0.010)
        self.nfft = conf.getint("nfft", 512)
        self.preemph = conf.getfloat("preemph", 0.97)
        self.window = conf.get("window", "hamming")
        self.include_energy = conf.getbool("include_energy", False)
        self.dynamic = conf.get("dynamic", "nodelta")
        self.mvn = conf.getbool("mvn", False)

    # -- hooks -----------------------------------------------------------
    def comp_feat(self, frames: np.ndarray, rate: float) -> np.ndarray:
        """Map windowed frames [N, winlen] to features [N, base_dim]."""
        raise NotImplementedError

    def base_dim(self) -> int:
        raise NotImplementedError

    # -- main entry ------------------------------------------------------
    def __call__(self, signal: np.ndarray, rate: float) -> np.ndarray:
        signal = np.asarray(signal, dtype=np.float32)
        frame_len = int(round(self.winlen * rate))
        frame_step = int(round(self.winstep * rate))
        emph = sigproc.preemphasis(signal, self.preemph)
        frames = sigproc.framesig(emph, frame_len, frame_step)
        win = sigproc.window(frame_len, self.window)
        feat = self.comp_feat(frames * win[None, :], rate)
        if self.include_energy:
            # log frame energy of the un-windowed frames, Kaldi-style
            energy = np.log(
                np.maximum(np.sum(np.square(frames), axis=1), 1e-30)
            ).astype(np.float32)
            feat = np.concatenate([energy[:, None], feat], axis=1)
        feat = sigproc.add_dynamics(feat, self.dynamic)
        if self.mvn:
            feat = sigproc.cmvn(feat)
        return feat.astype(np.float32)

    @property
    def dim(self) -> int:
        d = self.base_dim() + (1 if self.include_energy else 0)
        mult = {"nodelta": 1, "none": 1, "": 1, "delta": 2}.get(
            (self.dynamic or "nodelta").lower(), 3
        )
        return d * mult


@FEATURE_COMPUTERS.register("fbank")
class Fbank(FeatureComputer):
    """Log-Mel filterbank features."""

    def __init__(self, conf: Conf):
        super().__init__(conf)
        self.nfilt = conf.getint("nfilt", 40)
        self.lowfreq = conf.getfloat("lowfreq", 0.0)
        self.highfreq = conf.getfloat("highfreq", None)

    def comp_feat(self, frames: np.ndarray, rate: float) -> np.ndarray:
        pspec = sigproc.powspec(frames, self.nfft)
        fb = sigproc.get_filterbanks(
            self.nfilt, self.nfft, rate, self.lowfreq, self.highfreq
        )
        energies = pspec @ fb.T
        return np.log(np.maximum(energies, 1e-30)).astype(np.float32)

    def base_dim(self) -> int:
        return self.nfilt


@FEATURE_COMPUTERS.register("mfcc")
class Mfcc(Fbank):
    """MFCCs: DCT of log-fbank + liftering."""

    def __init__(self, conf: Conf):
        super().__init__(conf)
        self.numcep = conf.getint("numcep", 13)
        self.ceplifter = conf.getint("ceplifter", 22)

    def comp_feat(self, frames: np.ndarray, rate: float) -> np.ndarray:
        logfb = super().comp_feat(frames, rate)
        dct = sigproc.dct_matrix(self.numcep, self.nfilt)
        cep = logfb @ dct.T
        return sigproc.lifter(cep, self.ceplifter)

    def base_dim(self) -> int:
        return self.numcep


@FEATURE_COMPUTERS.register("frames")
class Frames(FeatureComputer):
    """Raw windowed frames, no spectral transform."""

    def comp_feat(self, frames: np.ndarray, rate: float) -> np.ndarray:
        return frames.astype(np.float32)

    @property
    def dim(self) -> int:
        raise NotImplementedError(
            "Frames dim depends on sample rate; read from produced features"
        )


@FEATURE_COMPUTERS.register("spec")
class Spec(FeatureComputer):
    """Log power-spectrum features."""

    def comp_feat(self, frames: np.ndarray, rate: float) -> np.ndarray:
        pspec = sigproc.powspec(frames, self.nfft)
        return np.log(np.maximum(pspec, 1e-30)).astype(np.float32)

    def base_dim(self) -> int:
        return self.nfft // 2 + 1


def make_feature_computer(conf: Conf) -> FeatureComputer:
    """Factory: builds the computer named by conf['feature']."""
    return FEATURE_COMPUTERS.build(conf.get("feature", "fbank"), conf)
