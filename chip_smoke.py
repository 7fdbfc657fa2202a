#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (nabu_tpu_torch) on one GPU and check it.

    python3 chip_smoke.py            # all phases, one card
    python3 chip_smoke.py --quick    # build + one check of each kernel

Phases, each printing one JSON line:

1. build   — nvcc builds every kernel source from the checkout, one
             process per source, all started together;
2. device  — the card's name and power limit (nvidia-smi);
3. kernels — each CUDA kernel against its plain PyTorch version on the
             card at the serving path's full shapes: max error against
             the stated tolerance, and a planted fault's error, which the
             tolerance must reject; kernel / plain / library times (CUDA
             events) and the bound (least time for the same work);
4. serve   — a full-width dblstm_ctc_wsj artifact (4x320 BLSTM, bf16,
             seeded random weights) serves 64 synthesized utterances of
             1-15 s through ``serving.serve`` at batch 32; launch counts
             are zeroed just before and read just after, and every kernel
             must have run. One batch is then checked: kernel path
             against the same path through the plain versions (features
             and logits, each with a planted fault) and the beam search
             on the card against the same search on the CPU.

Then one JSON line with every kernel's numbers, the nvidia-smi line, and
last ``{"ok": true, "device": {...}}``. Any failed check exits non-zero.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
RECIPE = os.path.join(REPO, "config", "recipes", "dblstm_ctc_wsj")

# H100 SXM published peaks (dense): HBM bytes/s, bf16 tensor-core and
# f32 non-tensor FLOP/s
PEAK_BYTES = 3.35e12
PEAK_BF16 = 989e12
PEAK_F32 = 67e12

# serving shapes of the 4x320 recipe at batch 32
B, T, H, NFILT = 32, 1024, 320, 40
W, K = 400, 256

# tolerances (max |kernel - plain| <= atol + rtol * |plain|). Each lies
# between the sound reading and the reading of a planted fault, both
# printed by every run (PERF.md records them):
# - stft_mel, log-mel f32: both sides f32, summation orders differ over
#   W = 400 products (sound: about one f32 step of the log); fault: the
#   last tap of W dropped
# - blstm_proj: bf16 outputs may land one bf16 rounding step apart when
#   the f32 sums differ in their last bits, and the bias add after the
#   cast keeps that step where the sum is smaller; fault: the last
#   product of the reduction dropped
# - blstm_recur: over 1024 dependent steps such one-step differences in
#   the bf16 carry propagate; f32 stays tight; fault: 8 hidden units
#   read h one step late (a missed barrier or fence)
# - features, logits: the serving path with the kernels against the same
#   path through the plain versions; features fault as above, logits
#   fault the carry not held past a length
TOL = {
    "stft_mel": (1e-4, 0.0),
    ("blstm_proj", "bf16"): (1e-2, 1e-2),
    ("blstm_proj", "f32"): (1e-4, 1e-5),
    ("blstm_recur", "bf16"): (4e-2, 0.0),
    ("blstm_recur", "f32"): (1e-4, 0.0),
    "features": (1e-4, 0.0),
    "logits_bf16": (0.03, 0.0),
}

TPU_KERNELS = {
    "stft_mel": "nabu_tpu/ops/pallas/stft_mel.py:78",
    "blstm_proj": "nabu_tpu/ops/pallas/blstm.py:867",
    "blstm_recur": "nabu_tpu/ops/pallas/blstm.py:867",
}
SOURCES = {
    "stft_mel": "nabu_tpu_torch/ops/kernels/csrc/stft_mel.cu",
    "blstm_proj": "nabu_tpu_torch/ops/kernels/csrc/blstm.cu",
    "blstm_recur": "nabu_tpu_torch/ops/kernels/csrc/blstm.cu",
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class CheckFailed(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


# tolerance checks of the current phase that failed: the phase prints all
# its readings first, then fails
FAILURES: list = []


def raise_failures() -> None:
    if FAILURES:
        raise CheckFailed("; ".join(FAILURES))


def time_ms(torch, fn, reps: int, warmup: int = 1) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def excess(got, ref, tol):
    """-> (max |got - ref|, max of |got - ref| - (atol + rtol |ref|))."""
    atol, rtol = tol
    got = got.float()
    ref = ref.float()
    err = (got - ref).abs()
    return float(err.max()), float((err - (atol + rtol * ref.abs())).max())


def compare(torch, got, ref, tol, what: str) -> float:
    check(bool(torch.isfinite(got.float()).all()), f"{what}: non-finite output")
    max_err, over = excess(got, ref, tol)
    if over > 0.0:
        FAILURES.append(f"{what}: max |err| {max_err} beyond tolerance {tol}")
    return max_err


def fault_reading(faulty, ref, tol, what: str) -> float:
    """The reading of a planted fault, which the tolerance must reject."""
    max_err, over = excess(faulty, ref, tol)
    if not over > 0.0:
        FAILURES.append(
            f"{what}: a planted fault (max |err| {max_err}) passes tolerance {tol}")
    return max_err


def bound(bytes_, ops, peak_ops):
    t_bytes = bytes_ / PEAK_BYTES * 1e3
    t_ops = ops / peak_ops * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# plain references and planted faults
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def plain_versions(stft=None, recur=None):
    """Run the serving path through the kernels' plain versions (the
    reference the kernel path is held to), or through a planted fault in
    place of one of them, by swapping the module attributes the path
    calls. No kernel may launch meanwhile."""
    from nabu_tpu_torch.ops import blstm, kernels, stft_mel

    swaps = [(stft_mel, "stft_mel", stft or stft_mel.stft_mel_plain),
             (blstm, "blstm_proj", blstm.blstm_proj_plain),
             (blstm, "blstm_recur", recur or blstm.blstm_recur_plain)]
    saved = [getattr(mod, name) for mod, name, _ in swaps]
    before = kernels.launch_counts()
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for (mod, name, _), fn in zip(swaps, saved):
            setattr(mod, name, fn)
    check(kernels.launch_counts() == before, "a plain run launched a kernel")


def drop_last_tap(stft_plain):
    """Planted STFT+Mel fault: the last of the W taps is skipped (an
    off-by-one in the loop over the window)."""
    def faulty(frames, cossin, mel):
        cut = cossin.clone()
        cut[-1] = 0.0
        return stft_plain(frames, cut, mel)
    return faulty


def stale_recur(torch, units: int = 8):
    """Planted recurrence fault: the gates of the first ``units`` hidden
    units read h one step late (h_{t-2}), as the block owning them would
    after passing the step barrier before the others' h was visible.
    Otherwise the plain masked cell."""
    def recur(xw, lengths, wh, forget_bias: float = 1.0):
        _, T, B, H4 = xw.shape
        H = H4 // 4
        dt = xw.dtype
        cols = torch.cat([torch.arange(g * H, g * H + units) for g in range(4)])
        cols = cols.to(xw.device)
        mask = (torch.arange(T, device=xw.device)[:, None]
                < lengths.to(xw.device)[None, :])[..., None]
        y = torch.zeros((T, B, 2 * H), dtype=dt, device=xw.device)
        for d in range(2):
            whf = wh[d].float()
            h = torch.zeros((B, H), dtype=dt, device=xw.device)
            h_late = h
            c = torch.zeros((B, H), dtype=torch.float32, device=xw.device)
            for t in range(T) if d == 0 else range(T - 1, -1, -1):
                gates = xw[d, t].float() + h.float() @ whf
                gates[:, cols] = xw[d, t, :, cols].float() + h_late.float() @ whf[:, cols]
                gi = torch.sigmoid(gates[:, :H])
                gf = torch.sigmoid(gates[:, H: 2 * H] + forget_bias)
                gg = torch.tanh(gates[:, 2 * H: 3 * H])
                go = torch.sigmoid(gates[:, 3 * H:])
                c_new = gf * c + gi * gg
                h_new = (go * torch.tanh(c_new)).to(dt)
                m = mask[t]
                h_late = h
                h = torch.where(m, h_new, h)
                c = torch.where(m, c_new, c)
                y[t, :, d * H: (d + 1) * H] = h * m.to(dt)
        return y
    return recur


def carry_not_held(torch):
    """Planted recurrence fault: the carry is not held past each
    utterance's length, only the output is masked, so the backward walk
    enters every shorter utterance with the padding's state."""
    from nabu_tpu_torch.ops.blstm import blstm_recur_plain

    def recur(xw, lengths, wh, forget_bias: float = 1.0):
        T = xw.shape[1]
        y = blstm_recur_plain(xw, torch.full_like(lengths, T), wh, forget_bias)
        keep = torch.arange(T, device=xw.device)[:, None] < lengths[None, :]
        return y * keep[..., None].to(y.dtype)
    return recur


# ---------------------------------------------------------------------------
# synthesized audio and weights (numpy, seeded)
# ---------------------------------------------------------------------------

def synth_utterance(rng, seconds: float, rate: int = 16000) -> np.ndarray:
    """Tone sequence with envelopes plus a noise floor (no silent bins)."""
    n = int(seconds * rate)
    sig = np.zeros(n, np.float64)
    pos = 0
    while pos < n:
        dur = int(rng.uniform(0.06, 0.2) * rate)
        t = np.arange(min(dur, n - pos)) / rate
        f0 = rng.uniform(100.0, 3500.0)
        env = np.minimum(1.0, np.minimum(t, t[::-1]) / 0.01)
        sig[pos: pos + len(t)] = np.sin(2 * np.pi * f0 * t) * env
        pos += len(t)
    return (6000.0 * sig + 40.0 * rng.standard_normal(n)).astype(np.float32)


def glorot(rng, shape):
    limit = np.sqrt(6.0 / (shape[-2] + shape[-1]))
    return rng.uniform(-limit, limit, shape).astype(np.float32)


def recipe_params(rng, input_dim: int, num_layers: int, units: int, num_labels: int):
    """Seeded weights in the JAX package's flattened tree layout."""
    flat = {}
    d = input_dim
    for i in range(num_layers):
        for direction in ("fw", "bw"):
            key = f"encoder/layer_{i}/{direction}"
            flat[f"{key}/wx"] = glorot(rng, (d, 4 * units))
            flat[f"{key}/wh"] = glorot(rng, (units, 4 * units))
            flat[f"{key}/b"] = rng.uniform(-0.1, 0.1, (4 * units,)).astype(np.float32)
        d = 2 * units
    flat["decoders/decoder/out/w"] = glorot(rng, (d, num_labels + 1))
    flat["decoders/decoder/out/b"] = rng.uniform(
        -0.1, 0.1, (num_labels + 1,)).astype(np.float32)
    return flat


def write_artifact(out_dir: str, seed: int) -> dict:
    """A full-width dblstm_ctc_wsj export artifact: model.cfg from the
    recipe, frontend.cfg from its [testfeatures]/[testtargets],
    recognizer.cfg from its recognizer.cfg, seeded weights."""
    from nabu_tpu_torch.config import Conf, ConfigFile

    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(RECIPE, "model.cfg")) as f:
        model_cfg = f.read()
    with open(os.path.join(out_dir, "model.cfg"), "w") as f:
        f.write(model_cfg)
    db = ConfigFile.read(os.path.join(RECIPE, "database.conf"))
    drop = ("datafile", "dir", "speed_perturb")
    sections = {}
    for src, dst in (("testfeatures", "features"), ("testtargets", "targets")):
        vals = {k: v for k, v in db.section(src).items() if k not in drop}
        sections[dst] = Conf(vals, dst)
    ConfigFile(sections).write(os.path.join(out_dir, "frontend.cfg"))
    rconf = ConfigFile.read(os.path.join(RECIPE, "recognizer.cfg")).section("recognizer")
    rvals = dict(rconf.items(), features="features", targets="targets")
    ConfigFile({"recognizer": Conf(rvals, "recognizer")}).write(
        os.path.join(out_dir, "recognizer.cfg"))

    mcfg = ConfigFile.read(os.path.join(out_dir, "model.cfg"))
    enc = mcfg.section("encoder")
    alphabet = sections["targets"].getlist("alphabet")
    from nabu_tpu_torch.features.computers import make_feature_computer

    input_dim = make_feature_computer(sections["features"]).dim
    flat = recipe_params(
        np.random.default_rng(seed), input_dim, enc.getint("num_layers"),
        enc.getint("num_units"), len(alphabet),
    )
    np.savez(os.path.join(out_dir, "params.npz"), **flat)
    manifest = {"framework": "nabu_tpu", "input_dim": input_dim,
                "num_labels": len(alphabet)}
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    return manifest


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_build(verbose: bool) -> None:
    from nabu_tpu_torch.ops.kernels import build

    t0 = time.perf_counter()
    info = build.build_all(verbose=verbose)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": {k: v["seconds"] for k, v in info.items()}})
    if verbose:
        for name, v in info.items():
            print(f"--- nvcc {name}.cu\n{v['log']}", flush=True)


def phase_device(torch) -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    return smi


def phase_kernels(torch, quick: bool) -> dict:
    from nabu_tpu_torch.features import torch_frontend as tf
    from nabu_tpu_torch.ops import blstm as blstm_ops
    from nabu_tpu_torch.ops import stft_mel as stft_ops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    reps = 0 if quick else 20
    rows = {}

    def timed(fn, n):
        return time_ms(torch, fn, n) if n else None

    # --- STFT + Mel at N = 32 x 1024 frames ------------------------------
    fp = tf.make_frontend_params(16000.0, nfilt=NFILT, device=dev)
    cossin, mel = fp.folded()
    sig = torch.as_tensor(
        np.stack([synth_utterance(rng, 10.3) for _ in range(B)]), device=dev)
    frames = tf.frame_signal(sig, fp.frame_len, fp.frame_step, T)
    frames = frames.reshape(B * T, fp.frame_len).contiguous()
    N = frames.shape[0]
    check(tuple(cossin.shape) == (W, 2 * K), f"stft_mel: cossin {tuple(cossin.shape)}")
    got = stft_ops.stft_mel(frames, cossin, mel)
    ref = stft_ops.stft_mel_plain(frames, cossin, mel)
    err = compare(torch, got, ref, TOL["stft_mel"], "stft_mel")
    fault = fault_reading(drop_last_tap(stft_ops.stft_mel_plain)(frames, cossin, mel),
                          ref, TOL["stft_mel"], "stft_mel")

    def fft_log_mel():
        # the same function through a real FFT of nfft points
        spec = torch.fft.rfft(frames * fp.window, n=fp.nfft)[:, :K]
        power = spec.real * spec.real + spec.imag * spec.imag
        return torch.log(torch.clamp(power @ mel, min=1e-30))

    # least work: the window, a real FFT (~2.5 nfft log2 nfft operations a
    # frame), the power, the mel product over its nonzeros, the log
    nnz = int((mel != 0).sum())
    ops = N * (W + 2.5 * fp.nfft * math.log2(fp.nfft) + 3 * K + NFILT) + 2 * N * nnz
    bytes_ = 4 * (N * W + W * 2 * K + K * NFILT + N * NFILT)
    b_ms, b_by = bound(bytes_, ops, PEAK_F32)
    rows["stft_mel"] = {
        "shape": [N, W, K, NFILT], "dtype": "f32", "max_abs_err": err,
        "tol": TOL["stft_mel"], "fault_max_abs_err": fault,
        "ms": timed(lambda: stft_ops.stft_mel(frames, cossin, mel), reps),
        "plain_ms": timed(lambda: stft_ops.stft_mel_plain(frames, cossin, mel), reps),
        "library_ms": timed(lambda: torch.matmul(frames, cossin), reps),
        "library": "torch.matmul frames @ cossin (the DFT product only)",
        "fft_ms": timed(fft_log_mel, reps),
        "fft_max_abs_err": float((fft_log_mel() - ref).abs().max()),
        "fft": "torch.fft.rfft, power, mel product, log",
        "bound_ms": b_ms, "bound_by": b_by, "mel_nonzeros": nnz,
    }
    emit({"phase": "kernels", "kernel": "stft_mel", **rows["stft_mel"]})

    # --- BLSTM projection and recurrence ----------------------------------
    lengths = np.full((B,), T, np.int32)
    lengths[1:] = rng.integers(T // 8, T + 1, B - 1)
    lens_t = torch.as_tensor(lengths, device=dev)
    valid = int(lengths.sum())
    for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        es = 2 if tag == "bf16" else 4
        peak = PEAK_BF16 if tag == "bf16" else PEAK_F32
        for D in (2 * NFILT, 2 * H):
            x = torch.as_tensor(
                rng.standard_normal((T * B, D)).astype(np.float32), device=dev).to(dtype)
            wx = torch.as_tensor(glorot(rng, (2, D, 4 * H)), device=dev).to(dtype)
            bias = torch.as_tensor(
                rng.uniform(-0.1, 0.1, (2, 4 * H)).astype(np.float32), device=dev).to(dtype)
            got = blstm_ops.blstm_proj(x, wx, bias)
            ref = blstm_ops.blstm_proj_plain(x, wx, bias)
            tol = TOL[("blstm_proj", tag)]
            err = compare(torch, got, ref, tol, f"blstm_proj {tag} D={D}")
            x_cut = x.clone()
            x_cut[:, -1] = 0
            fault = fault_reading(blstm_ops.blstm_proj_plain(x_cut, wx, bias), ref, tol,
                                  f"blstm_proj {tag} D={D}")
            M = T * B
            b_ms, b_by = bound(es * (M * D + 2 * D * 4 * H + 2 * 4 * H + 2 * M * 4 * H),
                               2 * 2 * M * D * 4 * H, peak)
            row = {
                "shape": [M, D, 4 * H], "dtype": tag, "max_abs_err": err, "tol": tol,
                "fault_max_abs_err": fault,
                "ms": timed(lambda: blstm_ops.blstm_proj(x, wx, bias), reps),
                "plain_ms": timed(lambda: blstm_ops.blstm_proj_plain(x, wx, bias), reps),
                "library_ms": timed(lambda: torch.matmul(x, wx), reps),
                "library": "torch.matmul x @ wx (both directions)",
                "bound_ms": b_ms, "bound_by": b_by,
            }
            emit({"phase": "kernels", "kernel": "blstm_proj", **row})
            rows[("blstm_proj", tag, D)] = row
        # recurrence on the projection of the widest layer's input
        xw = got.view(2, T, B, 4 * H).contiguous()
        wh = torch.as_tensor(glorot(rng, (2, H, 4 * H)), device=dev).to(dtype)
        got_r = blstm_ops.blstm_recur(xw, lens_t, wh)
        ref_r = blstm_ops.blstm_recur_plain(xw, lens_t, wh)
        tol = TOL[("blstm_recur", tag)]
        err = compare(torch, got_r, ref_r, tol, f"blstm_recur {tag}")
        fault = fault_reading(stale_recur(torch)(xw, lens_t, wh), ref_r, tol,
                              f"blstm_recur {tag}")
        b_ms, b_by = bound(
            es * (2 * valid * 4 * H + 2 * H * 4 * H + T * B * 2 * H) + 4 * B,
            2 * valid * (2 * H * 4 * H + 12 * H), peak)
        # library yardstick: cuDNN bidirectional LSTM (projection included)
        # on a packed sequence, forget_bias folded into bias_ih
        lstm = torch.nn.LSTM(D, H, bidirectional=True).to(dev, dtype)
        with torch.no_grad():
            for d, sfx in enumerate(("", "_reverse")):
                getattr(lstm, f"weight_ih_l0{sfx}").copy_(wx[d].t())
                getattr(lstm, f"weight_hh_l0{sfx}").copy_(wh[d].t())
                b_ih = bias[d].float().clone()
                b_ih[H: 2 * H] += 1.0
                getattr(lstm, f"bias_ih_l0{sfx}").copy_(b_ih.to(dtype))
                getattr(lstm, f"bias_hh_l0{sfx}").zero_()
        lstm.flatten_parameters()
        packed = torch.nn.utils.rnn.pack_padded_sequence(
            x.view(T, B, D), torch.as_tensor(lengths), enforce_sorted=False)

        def run_cudnn():
            with torch.no_grad():
                return lstm(packed)[0]

        cudnn_out, _ = torch.nn.utils.rnn.pad_packed_sequence(run_cudnn(), total_length=T)
        ours = blstm_ops.blstm_tm_apply(
            {"fw": {"wx": wx[0], "wh": wh[0], "b": bias[0]},
             "bw": {"wx": wx[1], "wh": wh[1], "b": bias[1]}},
            x.view(T, B, D), lens_t)
        cudnn_err = float((cudnn_out.float() - ours.float()).abs().max())
        row = {
            "shape": [T, B, H], "dtype": tag, "max_abs_err": err, "tol": tol,
            "fault_max_abs_err": fault,
            "ms": timed(lambda: blstm_ops.blstm_recur(xw, lens_t, wh), reps),
            "plain_ms": timed(lambda: blstm_ops.blstm_recur_plain(xw, lens_t, wh),
                              min(reps, 2)),
            "library_ms": timed(run_cudnn, reps),
            "library": "cuDNN nn.LSTM bidirectional, packed (projection included)",
            "cudnn_layer_max_abs_err": cudnn_err,
            "bound_ms": b_ms, "bound_by": b_by,
        }
        emit({"phase": "kernels", "kernel": "blstm_recur", **row})
        rows[("blstm_recur", tag)] = row
    torch.cuda.synchronize()
    raise_failures()
    return rows


def phase_serve(torch, smi: str) -> dict:
    from nabu_tpu_torch.data import audio_io
    from nabu_tpu_torch.ops import kernels
    from nabu_tpu_torch.ops import stft_mel as stft_ops
    from nabu_tpu_torch.serving import load_exported, serve

    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        art = os.path.join(tmp, "export")
        manifest = write_artifact(art, seed=2)
        # the backlog sorted by duration, as a batch scorer sorts it: the
        # short half and the long half land in two T buckets
        lines, audio_seconds = [], 0.0
        for i, seconds in enumerate(np.sort(rng.uniform(1.0, 15.0, 64))):
            sig = synth_utterance(rng, float(seconds))
            path = os.path.join(tmp, f"utt{i:03d}.wav")
            audio_io.write_wav(path, sig, 16000)
            audio_seconds += len(sig) / 16000.0
            lines.append(f"utt{i:03d} {path}")

        t0 = time.perf_counter()
        model = load_exported(art, batch_size=B)
        load_s = time.perf_counter() - t0
        check(model.device.type == "cuda", "serve: model not on the card")
        check(model.device_fe is not None, "serve: no device frontend")

        # per-stage wall time: wrap the three stages with synchronizing timers
        stage = {"frontend": 0.0, "encoder": 0.0, "decode": 0.0}

        def timer(name, fn):
            def wrapped(*a, **kw):
                torch.cuda.synchronize()
                s = time.perf_counter()
                out = fn(*a, **kw)
                torch.cuda.synchronize()
                stage[name] += time.perf_counter() - s
                return out
            return wrapped

        fe, mdl, rec = model.device_fe, model.model, model.recognizer
        fe.batch_features = timer("frontend", fe.batch_features)
        frames_seen = set()
        apply = mdl.apply

        def apply_seen(params, feats, *a, **kw):
            frames_seen.add(int(feats.shape[1]))
            return apply(params, feats, *a, **kw)

        mdl.apply = timer("encoder", apply_seen)
        rec.decode_logprobs = timer("decode", rec.decode_logprobs)

        # requests arrive as a file: select() reports it readable, so
        # serve() micro-batches them up to batch_size, as it would a pipe
        # holding a queue's backlog
        requests = os.path.join(tmp, "requests.scp")
        with open(requests, "w") as f:
            f.write("\n".join(lines) + "\n")
        out = io.StringIO()
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with open(requests) as in_stream:
            served = serve(art, in_stream=in_stream, out_stream=out,
                           batch_size=B, model=model)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernels.launch_counts()

        texts = out.getvalue().splitlines()
        check(served == 64 and len(texts) == 64, f"serve: {served} served, {len(texts)} lines")
        alphabet = set(model.text_proc.alphabet) | {" "}
        for line, want in zip(texts, lines):
            utt = want.split()[0]
            check(line.split(" ", 1)[0] == utt, f"serve: line {line!r} is not for {utt}")
            check(set(line[len(utt):].replace("<space>", " ")) <= alphabet,
                  f"serve: unexpected symbols in {line!r}")
        for name in kernels.KERNELS:
            check(launches[name] > 0, f"serve: kernel {name} never launched")
        batches = (64 + B - 1) // B
        check(len(frames_seen) == 2, f"serve: T buckets {sorted(frames_seen)}, want 2")
        check(launches["stft_mel"] == batches,
              f"serve: {launches['stft_mel']} frontend launches for {batches} batches")
        emit({
            "phase": "serve", "utterances": served, "audio_seconds": audio_seconds,
            "wall_seconds": wall, "load_seconds": load_s,
            "rtf": wall / audio_seconds, "utterances_per_second": served / wall,
            "stage_seconds": stage, "launches": launches, "batches": batches,
            "frames_per_batch": sorted(frames_seen),
            "batch_size": B, "card": smi, "manifest": manifest,
        })

        # one batch: kernel path against plain path, card decode against CPU
        from nabu_tpu_torch.data.audio_io import load_audio

        sigs = [load_audio(line.split()[1])[0] for line in lines[:B]]
        del rec.decode_logprobs, mdl.apply, fe.batch_features  # drop the timers
        fe = model.device_fe

        def features():
            return fe.batch_features(sigs, 16000.0, B, model.T_BUCKET)

        feats_k, flens = features()
        with plain_versions():
            feats_p, _ = features()
        with plain_versions(stft=drop_last_tap(stft_ops.stft_mel_plain)):
            feats_f, _ = features()
        feat_err = compare(torch, feats_k, feats_p, TOL["features"], "serve features")
        feat_fault = fault_reading(feats_f, feats_p, TOL["features"], "serve features")
        lens = torch.as_tensor(flens, device=dev)
        mask = (torch.arange(feats_k.shape[1], device=dev)[None, :] < lens[:, None])[..., None]

        def logits(feats):
            return mdl.apply(model.params, feats, lens)["decoder"]

        # encoder + head, kernel path against plain path. The planted fault
        # it must reject is the carry not held past a length; an h read one
        # step late is read too but not required to fail here: through
        # these weights its trace in the logits is about one bf16 step
        # (PERF.md), and the recurrence check above is its guard
        def logits():
            return mdl.apply(model.params, feats_k, lens)["decoder"]

        logits_k, llen = logits()
        with plain_versions():
            logits_p, _ = logits()
        with plain_versions(recur=carry_not_held(torch)):
            logits_f, _ = logits()
        with plain_versions(recur=stale_recur(torch)):
            logits_s, _ = logits()
        mask = (torch.arange(logits_k.shape[1], device=dev)[None, :] < lens[:, None])[..., None]
        logit_err = compare(torch, logits_k * mask, logits_p * mask,
                            TOL["logits_bf16"], "serve logits (bf16)")
        logit_fault = fault_reading(logits_f * mask, logits_p * mask,
                                    TOL["logits_bf16"], "serve logits (bf16)")
        logit_stale = excess(logits_s * mask, logits_p * mask, TOL["logits_bf16"])[0]
        logprobs = torch.log_softmax(logits_k, -1)
        seq_g, len_g, sc_g = rec.decode_logprobs(logprobs, llen)
        seq_c, len_c, sc_c = rec.decode_logprobs(logprobs.cpu(), llen.cpu())
        same = sum(
            int(torch.equal(len_g[b, 0].cpu(), len_c[b, 0])
                and torch.equal(seq_g[b, 0, : int(len_c[b, 0])].cpu(),
                                seq_c[b, 0, : int(len_c[b, 0])]))
            for b in range(B)
        )
        score_err = float((sc_g[:, 0].cpu() - sc_c[:, 0]).abs().max())
        check(same == B, f"serve: card and CPU beam search differ on {B - same}/{B}")
        check(score_err <= 1e-3, f"serve: beam scores differ by {score_err}")
        emit({"phase": "serve_check", "feature_max_abs_err": feat_err,
              "feature_fault_max_abs_err": feat_fault, "features_tol": TOL["features"],
              "logit_max_abs_err": logit_err, "logit_fault_max_abs_err": logit_fault,
              "logit_stale_h_max_abs_err": logit_stale,
              "logits_tol": TOL["logits_bf16"],
              "beam_best_identical": same, "beam_score_max_abs_err": score_err,
              "frames": int(feats_k.shape[1])})
    raise_failures()
    return {"launches": launches, "batches": batches}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="build (with the compiler's resource report) and check "
                         "each kernel once at full shape; no timing, no serve")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import nabu_tpu_torch  # noqa: F401  (fails outside a checkout)

    t0 = time.perf_counter()
    phase_build(verbose=args.quick)
    smi = phase_device(torch)
    t1 = time.perf_counter()
    rows = phase_kernels(torch, args.quick)
    t2 = time.perf_counter()
    if args.quick:
        print("chip_smoke: quick check done (no result)", file=sys.stderr)
        return 0
    served = phase_serve(torch, smi)
    emit({"phase": "seconds", "build_device": t1 - t0, "kernels": t2 - t1,
          "serve": time.perf_counter() - t2})

    kernels_line = []
    for name, key in (("stft_mel", "stft_mel"),
                      ("blstm_proj", ("blstm_proj", "bf16", 2 * H)),
                      ("blstm_recur", ("blstm_recur", "bf16"))):
        r = rows[key]
        kernels_line.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": TPU_KERNELS[name], "launches": served["launches"][name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
        })
    emit({"kernels": kernels_line})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
