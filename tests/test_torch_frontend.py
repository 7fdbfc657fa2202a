"""The port's STFT+Mel and device frontend against the JAX package's.

Same seeded numpy audio through both: the plain STFT+Mel against the
Pallas kernel (interpret mode, f32 and bf16 DFT operands) and the port's
DeviceFrontend against the JAX DeviceFrontend across the option surface,
on ragged lengths. Tolerance: abs 1e-4 on log features (f32 on both
sides; the audio has a noise floor, so no mel band is near-silent), with
a relative 1e-5 on top for MFCCs, whose magnitudes reach ~1e2.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nabu_tpu.config import Conf as JConf
from nabu_tpu.features import jax_frontend as jf
from nabu_tpu.ops.pallas.stft_mel import stft_mel_pallas
from nabu_tpu_torch.config import Conf
from nabu_tpu_torch.features import torch_frontend as tf
from nabu_tpu_torch.ops import kernels
from nabu_tpu_torch.ops import stft_mel as stft_ops

torch.set_num_threads(1)  # Tier-1 runs several xdist workers

RATE = 16000.0


def _signals(seed=0, lens=(5200, 16000, 9333, 400)):
    """Tones over a white-noise floor, plus a 33 Hz hum: pre-emphasis
    takes ~30 dB off the lowest mel band (one 31 Hz bin), and the hum
    keeps that band far from silent."""
    rng = np.random.default_rng(seed)
    out = []
    for n in lens:
        t = np.arange(n) / RATE
        f = rng.uniform(200.0, 3000.0, 3)
        sig = 500.0 * sum(np.sin(2 * np.pi * fi * t) for fi in f)
        sig = sig + 2000.0 * np.sin(2 * np.pi * 33.0 * t)
        out.append((sig + 1000.0 * rng.standard_normal(n)).astype(np.float32))
    return out


def _frames(seed=1, n_frames=75):
    sig = np.concatenate(_signals(seed, (16000,)))
    pre = np.concatenate([sig[:1], sig[1:] - 0.97 * sig[:-1]])
    idx = np.arange(400)[None, :] + 160 * np.arange(n_frames)[:, None]
    return pre[idx].astype(np.float32)


class TestStftMel:
    def test_constants_match_jax(self):
        fpj = jf.make_frontend_params(RATE, nfft=512, nfilt=40)
        fpt = tf.make_frontend_params(RATE, nfft=512, nfilt=40)
        assert fpt.dft_cos.shape == (400, 256)  # Nyquist row trimmed
        for name in ("window", "dft_cos", "dft_sin", "mel"):
            np.testing.assert_array_equal(
                getattr(fpt, name).numpy(), np.asarray(getattr(fpj, name)), name
            )

    def test_plain_matches_pallas_kernel(self):
        fpj = jf.make_frontend_params(RATE, nfft=512, nfilt=40)
        frames = _frames()
        want = stft_mel_pallas(
            jnp.asarray(frames), fpj.window, fpj.dft_cos, fpj.dft_sin,
            fpj.mel, fpj.nfft, interpret=True, dft_dtype=jnp.float32,
        )
        fpt = tf.make_frontend_params(RATE, nfft=512, nfilt=40)
        before = kernels.launch_counts()["stft_mel"]
        got = stft_ops.stft_mel(torch.from_numpy(frames), *fpt.folded())
        # CPU tensors take the plain version, which is no kernel launch
        assert kernels.launch_counts()["stft_mel"] == before
        assert got.shape == (75, 40) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)

    def test_bf16_plain_matches_pallas_kernel(self):
        """The bf16 mode (the Pallas kernel's default dft_dtype): the table
        folded in f32 and rounded once, the frames rounded, their exact
        products summed in f32; against the Pallas kernel in interpret
        mode at the f32 mode's 1e-4."""
        fpj = jf.make_frontend_params(RATE, nfft=512, nfilt=40)
        frames = _frames(2)
        want = stft_mel_pallas(
            jnp.asarray(frames), fpj.window, fpj.dft_cos, fpj.dft_sin,
            fpj.mel, fpj.nfft, interpret=True, dft_dtype=jnp.bfloat16,
        )
        fpt = tf.make_frontend_params(RATE, nfft=512, nfilt=40)
        cossin, mel, mr = fpt.folded("bf16")
        assert cossin.dtype == torch.bfloat16 and mel.dtype == torch.float32
        # rounded once, after the window fold, as the JAX wrapper rounds it
        wcol = np.asarray(fpj.window, np.float32)[:, None]
        jcs = jnp.concatenate([fpj.dft_cos * wcol, fpj.dft_sin * wcol], axis=1)
        np.testing.assert_array_equal(cossin.float().numpy(),
                                      np.asarray(jcs.astype(jnp.bfloat16).astype(jnp.float32)))
        before = kernels.launch_counts()
        got = stft_ops.stft_mel(torch.from_numpy(frames).to(torch.bfloat16), cossin, mel, mr)
        assert kernels.launch_counts() == before
        assert got.shape == (75, 40) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
        # the mode is a different function: bf16 rounding moves the features
        f32 = stft_ops.stft_mel(torch.from_numpy(frames), *fpt.folded())
        assert float((f32 - got).abs().max()) > 1e-3
        with pytest.raises(ValueError, match="dft_dtype"):
            fpt.folded("f16")


    @pytest.mark.parametrize("rate,nfilt", [(RATE, 40), (8000.0, 23), (44100.0, 80)])
    def test_mel_ranges_cover_the_mel_matrix(self, rate, nfilt):
        """The kernel's sparse Mel product: each filter's bin range runs
        from its first to its last non-zero, no non-zero lies outside the
        ranges, the packed weights are the matrix's, and summing over the
        ranges gives power @ mel (1e-6: positive terms in another order)."""
        fp = tf.make_frontend_params(rate, nfft=512, nfilt=nfilt)
        _, mel, mr = fp.folded()
        m, r, w = mel.numpy(), mr.ranges.numpy(), mr.weights.numpy()
        K, M = m.shape
        assert r.shape == (M, 3)
        covered = np.zeros(m.shape, bool)
        for j, (lo, hi, off) in enumerate(r):
            covered[lo:hi, j] = True
            if hi > lo:
                assert m[lo, j] != 0 and m[hi - 1, j] != 0
            np.testing.assert_array_equal(w[off: off + hi - lo], m[lo:hi, j])
        assert not (m != 0)[~covered].any()
        assert w.shape == (int((r[:, 1] - r[:, 0]).sum()),)
        power = np.random.default_rng(0).uniform(0.0, 1e6, (7, K)).astype(np.float32)
        sparse = np.zeros((7, M), np.float32)
        for j, (lo, hi, off) in enumerate(r):
            for k in range(lo, hi):
                sparse[:, j] += power[:, k] * w[off + k - lo]
        np.testing.assert_allclose(sparse, power @ m, rtol=1e-6, atol=0)

    def test_kernel_design_limits_raise(self):
        """What the kernel holds (checked before any launch): at most 256
        bins (a block holds all of a frame's), MAX_FILTERS filters, ranges
        of the filter count."""
        _, mel, mr = tf.make_frontend_params(RATE, nfft=512).folded()
        stft_ops.check_design(256, 40, mr)  # every recipe's constants
        _, mel2, mr2 = tf.make_frontend_params(RATE, nfft=1024).folded()
        with pytest.raises(ValueError, match="beyond the kernel's design"):
            stft_ops.check_design(mel2.shape[0], 40, mr2)
        with pytest.raises(ValueError, match="ranges"):
            stft_ops.check_design(256, 39, mr)
        many = stft_ops.MAX_FILTERS + 1
        wide = dataclasses.replace(mr, ranges=torch.zeros((many, 3), dtype=torch.int32))
        with pytest.raises(ValueError, match="beyond the kernel's design"):
            stft_ops.check_design(256, many, wide)

    @pytest.mark.parametrize("dft_dtype", ["f32", "bf16"])
    def test_log_mel_spectrogram_matches_jax(self, dft_dtype):
        """One utterance through the port's log_mel_spectrogram and the
        JAX one: its jnp path (f32), its Pallas path (use_pallas, the
        kernel's bf16 default)."""
        sig = _signals(2, (8000,))[0]
        fpj = jf.make_frontend_params(RATE, nfft=512, nfilt=40)
        fpt = tf.make_frontend_params(RATE, nfft=512, nfilt=40)
        got = tf.log_mel_spectrogram(fpt, torch.from_numpy(sig), 48, dft_dtype)
        want = jf.log_mel_spectrogram(fpj, jnp.asarray(sig), 48,
                                      use_pallas=dft_dtype == "bf16")
        assert got.shape == (48, 40)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


RECIPE = {"feature": "fbank", "nfilt": "40", "nfft": "512", "dynamic": "delta"}
CASES = [
    RECIPE,
    {"feature": "fbank", "nfilt": "12", "include_energy": "true",
     "dynamic": "delta", "nfft": "256"},
    {"feature": "fbank", "nfilt": "10", "dynamic": "ddelta", "mvn": "true",
     "nfft": "512"},
    {"feature": "mfcc", "nfilt": "20", "numcep": "13", "nfft": "512"},
    {"feature": "mfcc", "nfilt": "20", "numcep": "13", "dynamic": "delta",
     "mvn": "true", "include_energy": "true", "nfft": "512"},
]


def _pad(sigs, bucket=1600):
    S = max(len(s) for s in sigs)
    S = ((S + bucket - 1) // bucket) * bucket
    batch = np.zeros((len(sigs), S), np.float32)
    lens = np.zeros((len(sigs),), np.int32)
    for i, s in enumerate(sigs):
        batch[i, : len(s)] = s
        lens[i] = len(s)
    return batch, lens


def _pair(case):
    vals = dict(case, winlen="0.025", winstep="0.01", use_native="false")
    jfe = jf.DeviceFrontend.make(JConf(vals, "features"))
    tfe = tf.DeviceFrontend.make(Conf(vals, "features"), "cpu")
    assert jfe is not None and tfe is not None
    assert tfe.dim == jfe.dim
    return jfe, tfe


def _assert_feats(got, want, feature):
    rtol = 1e-5 if feature == "mfcc" else 0.0
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=rtol)


class TestDeviceFrontend:
    @pytest.mark.parametrize("case", CASES)
    def test_matches_jax_frontend(self, case):
        jfe, tfe = _pair(case)
        batch, lens = _pad(_signals())
        want, wl = jfe(batch, lens, RATE)
        got, gl = tfe(batch, lens, RATE)
        np.testing.assert_array_equal(gl, np.asarray(wl))
        assert got.shape == want.shape
        _assert_feats(got.numpy(), np.asarray(want), case["feature"])

    @pytest.mark.parametrize("case", [CASES[0], CASES[3]])
    def test_bf16_frontend_matches_jax_pallas_path(self, case):
        """frontend_dft_dtype = bf16 against JAX's bf16 Pallas path
        (interpret mode), at 1e-4 but on the frames (and, with deltas, the
        frames within 2 of them) that hold a sample whose bf16 rounding
        differs between the two pre-emphases: jitted XLA contracts x[t] -
        0.97 x[t - 1] into one FMA, the port rounds the product first, and
        where the two f32 results straddle a bf16 rounding boundary the
        frame's sample moves by a bf16 step. Such frames are held to 2e-3
        (measured: 3.0e-4 fbank with deltas, 8.4e-4 MFCC, from one sample of
        9600); in f32 the one-ulp difference stays below 1e-5."""
        import jax

        vals = dict(case, winlen="0.025", winstep="0.01", use_native="false",
                    frontend_dft_dtype="bf16")
        jfe = jf.DeviceFrontend.make(JConf(vals, "features"))
        tfe = tf.DeviceFrontend.make(Conf(vals, "features"), "cpu")
        assert tfe.dft_dtype == jfe.dft_dtype == "bf16"
        batch, lens = _pad(_signals(9, (4000, 2411)))
        want, wl = jfe(batch, lens, RATE, use_pallas=True)
        got, gl = tfe(batch, lens, RATE)
        np.testing.assert_array_equal(gl, np.asarray(wl))
        assert got.shape == want.shape

        def bf16_pre(pre):
            return np.asarray(jnp.asarray(pre).astype(jnp.bfloat16).astype(jnp.float32))

        xla = bf16_pre(jax.jit(lambda s: s[:, 1:] - 0.97 * s[:, :-1])(batch))
        port = torch.from_numpy(batch)
        port = bf16_pre((port[:, 1:] - 0.97 * port[:, :-1]).numpy())
        flipped = np.argwhere(xla != port)
        assert len(flipped) <= 2
        near = np.zeros(got.shape[:2], bool)
        spread = 2 if case.get("dynamic") else 0
        for b, s in flipped:  # sample s + 1 of utterance b
            for t in range(got.shape[1]):
                if 160 * t <= s + 1 < 160 * t + 400:
                    near[b, max(0, t - spread): t + spread + 1] = True
        g, w = got.numpy(), np.asarray(want)
        _assert_feats(g[~near], w[~near], case["feature"])
        np.testing.assert_allclose(g[near], w[near], atol=2e-3, rtol=0)

    def test_recipe_matches_jax_pallas_path(self):
        """JAX's Pallas STFT+Mel (interpret mode) on the recipe's features."""
        jfe, tfe = _pair(RECIPE)
        batch, lens = _pad(_signals(3, (4000, 2411)))
        want, _ = jfe(batch, lens, RATE, use_pallas=True)
        got, _ = tfe(batch, lens, RATE)
        _assert_feats(got.numpy(), np.asarray(want), "fbank")

    def test_set_normalization(self):
        jfe, tfe = _pair(RECIPE)
        rng = np.random.default_rng(5)
        mean = rng.standard_normal(80).astype(np.float32)
        std = rng.uniform(0.5, 2.0, 80).astype(np.float32)
        std[3] = 0.0  # clamped to 1e-10 on both sides: never divides by 0
        mean[3] = 0.0
        jfe.set_normalization(mean, std)
        tfe.set_normalization(mean, std)
        batch, lens = _pad(_signals(4, (3000, 7000)))
        want, _ = jfe(batch, lens, RATE)
        got, _ = tfe(batch, lens, RATE)
        w = np.asarray(want)
        keep = np.ones(80, bool)
        keep[3] = False  # x / 1e-10 is ~1e11: compared relatively below
        np.testing.assert_allclose(got.numpy()[..., keep], w[..., keep], atol=1e-4, rtol=1e-5)
        np.testing.assert_allclose(got.numpy()[..., 3], w[..., 3], rtol=1e-4)

    def test_batch_features_bucketing_matches_jax(self):
        jfe, tfe = _pair(RECIPE)
        sigs = _signals(6, (12000, 90000, 5000))
        want, wl = jfe.batch_features(sigs, RATE, 4, 512)
        got, gl = tfe.batch_features(sigs, RATE, 4, 512)
        assert got.shape == want.shape  # same sample bucket -> same frames
        np.testing.assert_array_equal(gl, np.asarray(wl))
        assert gl[3] == 1  # fill row
        _assert_feats(got.numpy(), np.asarray(want), "fbank")

    def test_host_computer_path_matches_numpy_computers(self):
        """The copied host computers equal the JAX package's numpy path."""
        from nabu_tpu.features.computers import make_feature_computer as jmake
        from nabu_tpu_torch.features.computers import make_feature_computer

        for case in CASES:
            vals = dict(case, use_native="false")
            sig = _signals(7, (6000,))[0]
            want = jmake(JConf(vals, "f"))(sig, RATE)
            got = make_feature_computer(Conf(vals, "f"))(sig, RATE)
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)

    def test_device_frontend_declines_raw_frames(self):
        assert tf.DeviceFrontend.make(Conf({"feature": "frames"}, "f")) is None
        assert tf.DeviceFrontend.make(Conf({"processor": "text"}, "f")) is None
        # the DFT operands: f32 (the default) or bf16; another value raises
        assert tf.DeviceFrontend(Conf({}, "f")).dft_dtype == "f32"
        assert tf.DeviceFrontend(Conf({"frontend_dft_dtype": "bf16"}, "f")).dft_dtype == "bf16"
        with pytest.raises(ValueError, match="dft_dtype 'f16'"):
            tf.DeviceFrontend(Conf({"frontend_dft_dtype": "f16"}, "f"))
