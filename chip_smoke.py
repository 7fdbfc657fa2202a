#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (nabu_tpu_torch) on one GPU and check it.

    python3 chip_smoke.py            # all phases, one card
    python3 chip_smoke.py --quick    # build + one check of each kernel

Phases, each printing JSON lines:

1. build    — nvcc builds every kernel source from the checkout, one
              process per source, all started together;
2. device   — the card's name and power limit (nvidia-smi);
3. kernels  — each CUDA kernel against its plain PyTorch version on the
              card at the full shapes of the serving and training paths:
              max error against the stated tolerance, and a planted
              fault's error, which the tolerance must reject; kernel /
              plain / library times (CUDA events) and the bound (least
              time for the same work);
4. serve    — a full-width dblstm_ctc_wsj artifact (4x320 BLSTM, bf16,
              seeded random weights) serves 64 synthesized utterances of
              1-15 s through ``serving.serve`` at batch 32; launch counts
              are zeroed just before and read just after, and every
              serving kernel must have run. One batch is then checked:
              kernel path against the same path through the plain
              versions (features and logits, each with a planted fault)
              and the beam search on the card against the same search on
              the CPU;
5. train    — a synthesized character corpus (512 utterances of 2-10 s,
              the recipe's 28 symbols at ~12 a second) goes through
              ``cli data`` and ``cli train`` with the dblstm_ctc_wsj
              recipe, unchanged but for its datafiles and 40 steps: the
              loss at each step, the step time split into forward, loss,
              backward and optimizer, audio seconds trained per second
              of the wall time of steps 2-40 end to end (loader, copy
              to the device and logging included) and of the phases
              alone, peak device memory; launch counts must equal steps x the
              per-step launches; ``latest/`` must reload into the same
              logits; then one full-width batch's loss and every
              parameter gradient, dropout off, through the kernels
              against the plain versions (with a planted fault).

Then one JSON line with every kernel's numbers, the nvidia-smi line, and
last ``{"ok": true, "device": {...}}``. A failed tolerance check is
reported by its phase, which finishes its readings; the run then fails
at the end. Any other failed check fails the run at once. Either way it
exits non-zero and prints no result.
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
# - blstm_proj, blstm_bwd_dx: bf16 outputs may land one bf16 rounding
#   step apart when the f32 sums differ in their last bits (and the bias
#   add after the cast keeps that step where the sum is smaller); fault:
#   the last product of the reduction dropped
# - blstm_bwd_dwx / db / dwh: f32 sums over T x B = 32768 tokens in
#   another order (the bf16 products' sums reach ~100, where f32 keeps
#   ~1e-5 of them); fault: the last token's term dropped
# - blstm_recur, blstm_recur_train: over 1024 dependent steps such
#   one-step differences in the bf16 carry propagate; f32 stays tight;
#   fault: 8 hidden units read h one step late (a missed barrier or
#   fence)
# - blstm_recur_train's f32 stores of c and the pre-activation gates,
#   computed from the carried h (sound: f32 sums over h that may differ
#   by such a step); faults: c stored one step late, gates stored with the
#   forget bias folded in
# - blstm_bwd_recur: the same propagation through the bf16 dgates
#   (relative to the largest dgate); fault: the dgates of 8 units read one
#   step stale
# - ctc_alpha (log-likelihood, f32 over T = 1000 steps) and ctc_beta
#   (posteriors in [0, 1]); fault: the skip transition dropped
# - features, logits: the serving path with the kernels against the same
#   path through the plain versions; features fault as above, logits
#   fault the carry not held past a length
# - train_grads (||kernel - plain|| / ||plain|| per parameter, the
#   largest over parameters, one full-width bf16 batch): bf16 rounding of
#   h and dgates differs between the two paths; fault: the bw direction's
#   dx left out of the sum over directions. The chain's stale exchange is
#   read too but not required to fail here: its trace in the gradients is
#   below the bf16 noise (PERF.md); the chain check above is its guard
TOL = {
    "stft_mel": (1e-4, 0.0),
    ("blstm_proj", "bf16"): (1e-2, 1e-2),
    ("blstm_proj", "f32"): (1e-4, 1e-5),
    ("blstm_recur", "bf16"): (4e-2, 0.0),
    ("blstm_recur", "f32"): (1e-4, 0.0),
    ("blstm_recur_train", "bf16"): (4e-2, 0.0),
    ("blstm_recur_train", "f32"): (1e-4, 0.0),
    ("blstm_recur_train_stores", "bf16"): (1e-2, 0.0),
    ("blstm_recur_train_stores", "f32"): (1e-4, 0.0),
    ("blstm_bwd_recur", "bf16"): (2e-2, 0.0),
    ("blstm_bwd_recur", "f32"): (1e-4, 0.0),
    ("blstm_bwd_dx", "bf16"): (1e-2, 1e-2),
    ("blstm_bwd_dx", "f32"): (1e-4, 1e-5),
    ("blstm_bwd_dw", "bf16"): (1e-2, 1e-3),
    ("blstm_bwd_dw", "f32"): (1e-3, 1e-4),
    "ctc_ll": (1e-3, 1e-5),
    "ctc_posts": (1e-4, 0.0),
    "features": (1e-4, 0.0),
    "logits_bf16": (0.03, 0.0),
    "train_loss": (1e-2, 1e-3),
    "train_grads": 0.02,
}

_BLSTM_FWD = "nabu_tpu/ops/pallas/blstm.py:867"
_BLSTM_BWD = "nabu_tpu/ops/pallas/blstm.py:952"
TPU_KERNELS = {
    "stft_mel": "nabu_tpu/ops/pallas/stft_mel.py:78",
    "blstm_proj": _BLSTM_FWD,
    "blstm_recur": _BLSTM_FWD,
    "blstm_recur_train": _BLSTM_FWD,
    "blstm_bwd_recur": _BLSTM_BWD,
    "blstm_bwd_dx": _BLSTM_BWD,
    "blstm_bwd_dwx": _BLSTM_BWD,
    "blstm_bwd_dwh": _BLSTM_BWD,
    "ctc_alpha": "nabu_tpu/ops/pallas/ctc_batched.py:67",
    "ctc_beta": "nabu_tpu/ops/pallas/ctc_batched.py:115",
}
SOURCES = {name: "nabu_tpu_torch/ops/kernels/csrc/blstm.cu" for name in TPU_KERNELS}
SOURCES["stft_mel"] = "nabu_tpu_torch/ops/kernels/csrc/stft_mel.cu"
SOURCES["ctc_alpha"] = SOURCES["ctc_beta"] = "nabu_tpu_torch/ops/kernels/csrc/ctc.cu"

# the kernels each path launches, and per training step of the 4-layer
# recipe (layer 0's input, the features, needs no gradient: no dx there)
SERVE_KERNELS = ("stft_mel", "blstm_proj", "blstm_recur")
TRAIN_STEP_LAUNCHES = {
    "blstm_proj": 4, "blstm_recur_train": 4, "blstm_bwd_recur": 4, "blstm_bwd_dx": 3,
    "blstm_bwd_dwx": 4, "blstm_bwd_dwh": 4, "ctc_alpha": 1, "ctc_beta": 1,
}
TRAIN_STEPS = 40
TRAIN_UTTS = 512


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

# every kernel wrapper the paths call, by module, with its plain version
_WRAPPERS = {
    "stft_mel": ("stft_mel", "stft_mel"),
    "blstm_proj": ("blstm", "blstm_proj"),
    "blstm_recur": ("blstm", "blstm_recur"),
    "blstm_recur_train": ("blstm", "blstm_recur_train"),
    "blstm_bwd_recur": ("blstm", "blstm_bwd_recur"),
    "blstm_bwd_dx": ("blstm", "blstm_bwd_dx"),
    "blstm_bwd_dwx": ("blstm", "blstm_bwd_dwx"),
    "blstm_bwd_dwh": ("blstm", "blstm_bwd_dwh"),
    "ctc_alpha": ("ctc_batched", "ctc_alpha"),
    "ctc_beta": ("ctc_batched", "ctc_beta"),
}


@contextlib.contextmanager
def swapped(mod, name, fn):
    """Temporarily replace a module attribute (a planted fault)."""
    saved = getattr(mod, name)
    setattr(mod, name, fn)
    try:
        yield
    finally:
        setattr(mod, name, saved)


@contextlib.contextmanager
def plain_versions(**faults):
    """Run the paths through the kernels' plain versions (the reference
    the kernel path is held to), or through a planted fault in place of
    one of them (``faults``: wrapper name -> function), by swapping the
    module attributes the paths call. No kernel may launch meanwhile."""
    import importlib

    from nabu_tpu_torch.ops import kernels

    with contextlib.ExitStack() as stack:
        for name, (modname, attr) in _WRAPPERS.items():
            mod = importlib.import_module(f"nabu_tpu_torch.ops.{modname}")
            fn = faults.get(name) or getattr(mod, f"{attr}_plain")
            stack.enter_context(swapped(mod, attr, fn))
        before = kernels.launch_counts()
        yield
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


def faulty_chain(torch, stale_units: int):
    """Planted backward-chain fault (otherwise ``blstm_bwd_recur_plain``'s
    arithmetic): dh_prev reads the dgates of the first ``stale_units``
    hidden units (their 4 gate columns) one step stale, as a block would
    after passing the step barrier before the block owning them had
    published (all units: a barrier that does not wait at all)."""

    def chain(gates, c, gy, lengths, wh, forget_bias: float = 1.0):
        _, T, B, H4 = gates.shape
        H = H4 // 4
        cdt = gy.dtype
        dev = gates.device
        cols = torch.cat([torch.arange(g * H, g * H + stale_units) for g in range(4)])
        wh_now = wh.float().clone()
        wh_now[:, :, cols] = 0
        wh_late = torch.zeros_like(wh_now)
        wh_late[:, :, cols] = wh[:, :, cols].float()
        mask = (torch.arange(T, device=dev)[:, None]
                < lengths.to(dev)[None, :]).to(torch.float32)[..., None]
        dg = torch.zeros((2, T, B, H4), dtype=cdt, device=dev)
        zeros = torch.zeros((B, H), dtype=torch.float32, device=dev)
        for d in range(2):
            dh, dc = zeros, zeros
            prev = torch.zeros((B, H4), dtype=torch.float32, device=dev)
            for t in (range(T - 1, -1, -1) if d == 0 else range(T)):
                t_prev = t - 1 if d == 0 else t + 1
                c_prev = c[d, t_prev] if 0 <= t_prev < T else zeros
                m = mask[t]
                keep = m > 0.5
                z = gates[d, t]
                gi = torch.sigmoid(z[:, :H])
                gf = torch.sigmoid(z[:, H: 2 * H] + forget_bias)
                gg = torch.tanh(z[:, 2 * H: 3 * H])
                go = torch.sigmoid(z[:, 3 * H:])
                tanh_c = torch.tanh(c[d, t])
                dh_total = gy[t, :, d * H: (d + 1) * H].float() * m + dh
                dh_new = torch.where(keep, dh_total, 0.0)
                dc_new = torch.where(keep, dc, 0.0) + dh_new * go * (1.0 - tanh_c * tanh_c)
                dgates = torch.cat([dc_new * gg * gi * (1.0 - gi),
                                    dc_new * c_prev * gf * (1.0 - gf),
                                    dc_new * gi * (1.0 - gg * gg),
                                    dh_new * tanh_c * go * (1.0 - go)], dim=-1).to(cdt)
                dg[d, t] = dgates
                dh_prev = dgates.float() @ wh_now[d].t() + prev @ wh_late[d].t()
                prev = dgates.float()
                dh = dh_prev + torch.where(keep, 0.0, dh_total)
                dc = dc_new * gf + torch.where(keep, 0.0, dc)
        return dg
    return chain


def c_one_step_late(torch, c):
    """Planted store fault: each step's f32 c written in the next step's
    row (the walk's order: t + 1 forward, t - 1 backward), zeros where
    nothing was written."""
    late = torch.zeros_like(c)
    late[0, 1:], late[1, :-1] = c[0, :-1], c[1, 1:]
    return late


def forget_bias_folded(gates, forget_bias: float = 1.0):
    """Planted store fault: the pre-activation gates stored after the
    forget bias was added to the forget gate's columns."""
    H = gates.shape[-1] // 4
    out = gates.clone()
    out[..., H: 2 * H] += forget_bias
    return out


def skip_dropped(cb):
    """Planted CTC fault: the skip transition between distinct labels is
    never taken (the plain versions' lanes with every skip flag off)."""
    lanes = cb._lanes

    def no_skip(labels, blank_id):
        ext, skip = lanes(labels, blank_id)
        return ext, skip & False
    return no_skip


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
        rows.update(training_kernel_rows(torch, rng, tag, dtype, xw, lengths, wh, lstm,
                                         packed, timed, reps))
    rows.update(ctc_rows(torch, timed, reps))
    torch.cuda.synchronize()
    return rows


def training_kernel_rows(torch, rng, tag, dtype, xw, lengths, wh, lstm, packed, timed,
                         reps) -> dict:
    """The training path's BLSTM kernels at T = 1024, B = 32, H = 320: the
    residual-writing forward, the backward chain, and the products at
    D = 80 and 640, each against its plain version with a planted fault."""
    from nabu_tpu_torch.ops import blstm as bo

    dev = xw.device
    es = 2 if tag == "bf16" else 4
    peak = PEAK_BF16 if tag == "bf16" else PEAK_F32
    lens_t = torch.as_tensor(lengths, device=dev)
    valid = int(lengths.sum())
    M, H4 = T * B, 4 * H
    rows = {}

    def u(*shape):
        return torch.as_tensor(rng.uniform(-1.0, 1.0, shape).astype(np.float32),
                               device=dev).to(dtype)

    # library yardsticks: cuDNN's bidirectional LSTM, training forward and
    # its backward (fwd + bwd minus fwd), projection included
    x_lib = packed.data.detach().requires_grad_(True)
    packed_g = torch.nn.utils.rnn.PackedSequence(
        x_lib, packed.batch_sizes, packed.sorted_indices, packed.unsorted_indices)
    g_lib = torch.ones((x_lib.shape[0], 2 * H), device=dev, dtype=dtype)

    def lib_fwd():
        return lstm(packed_g)[0].data

    def lib_fwd_bwd():
        lib_fwd().backward(g_lib)

    lib_f = timed(lib_fwd, reps)
    lib_fb = timed(lib_fwd_bwd, reps)

    # --- residual-writing forward ------------------------------------------
    got = bo.blstm_recur_train(xw, lens_t, wh)
    ref = bo.blstm_recur_train_plain(xw, lens_t, wh)
    tol = TOL[("blstm_recur_train", tag)]
    s_tol = TOL[("blstm_recur_train_stores", tag)]
    err = compare(torch, got[0], ref[0], tol, f"blstm_recur_train {tag} h")
    c_err = compare(torch, got[1], ref[1], s_tol, f"blstm_recur_train {tag} c")
    g_err = compare(torch, got[2], ref[2], s_tol, f"blstm_recur_train {tag} gates")
    fault = fault_reading(stale_recur(torch)(xw, lens_t, wh), ref[0], tol,
                          f"blstm_recur_train {tag}")
    c_fault = fault_reading(c_one_step_late(torch, ref[1]), ref[1], s_tol,
                            f"blstm_recur_train {tag} c")
    g_fault = fault_reading(forget_bias_folded(ref[2]), ref[2], s_tol,
                            f"blstm_recur_train {tag} gates")
    b_ms, b_by = bound(
        es * (2 * valid * H4 + 2 * H * H4 + M * 2 * H) + 4 * B + 4 * 2 * M * (H + H4),
        2 * valid * (2 * H * H4 + 12 * H), peak)
    row = {
        "shape": [T, B, H], "dtype": tag, "max_abs_err": err, "c_max_abs_err": c_err,
        "gates_max_abs_err": g_err, "tol": tol, "fault_max_abs_err": fault,
        "stores_tol": s_tol, "c_fault_max_abs_err": c_fault,
        "gates_fault_max_abs_err": g_fault,
        "ms": timed(lambda: bo.blstm_recur_train(xw, lens_t, wh), reps),
        "plain_ms": timed(lambda: bo.blstm_recur_train_plain(xw, lens_t, wh), min(reps, 1)),
        "library_ms": lib_f,
        "library": "cuDNN nn.LSTM bidirectional training forward, packed (projection "
                   "included)",
        "bound_ms": b_ms, "bound_by": b_by,
    }
    emit({"phase": "kernels", "kernel": "blstm_recur_train", **row})
    rows[("blstm_recur_train", tag)] = row

    # --- backward chain, on the plain forward's residuals -------------------
    _, c, gates = ref
    del got, ref
    gy = u(T, B, 2 * H)
    dg = bo.blstm_bwd_recur(gates, c, gy, lens_t, wh)
    ref_dg = bo.blstm_bwd_recur_plain(gates, c, gy, lens_t, wh)
    tol = TOL[("blstm_bwd_recur", tag)]
    err = compare(torch, dg, ref_dg, tol, f"blstm_bwd_recur {tag}")
    fault = fault_reading(faulty_chain(torch, stale_units=8)(gates, c, gy, lens_t, wh),
                          ref_dg, tol, f"blstm_bwd_recur {tag}")
    b_ms, b_by = bound(
        4 * 2 * M * (H4 + H) + es * (M * 2 * H + 2 * H * H4 + 2 * M * H4) + 4 * B,
        2 * valid * (2 * H4 * H + 30 * H), peak)
    row = {
        "shape": [T, B, H], "dtype": tag, "max_abs_err": err, "tol": tol,
        "ref_max_abs": float(ref_dg.float().abs().max()), "fault_max_abs_err": fault,
        "ms": timed(lambda: bo.blstm_bwd_recur(gates, c, gy, lens_t, wh), reps),
        "plain_ms": timed(lambda: bo.blstm_bwd_recur_plain(gates, c, gy, lens_t, wh),
                          min(reps, 1)),
        "library_ms": None if lib_f is None else lib_fb - lib_f,
        "library": "cuDNN nn.LSTM bidirectional backward, packed (fwd+bwd minus fwd; "
                   "input projection included)",
        "bound_ms": b_ms, "bound_by": b_by,
    }
    emit({"phase": "kernels", "kernel": "blstm_bwd_recur", **row})
    rows[("blstm_bwd_recur", tag)] = row
    del gates, c, dg, ref_dg

    # --- products: dx, dwx + db, dwh ---------------------------------------
    dgr = u(2, T, B, H4)
    y = u(T, B, 2 * H)
    hprev = torch.zeros((2, T, B, H), device=dev, dtype=dtype)
    hprev[0, 1:] = y[:-1, :, :H]
    hprev[1, :-1] = y[1:, :, H:]
    dg2 = dgr.view(2, M, H4)
    tol_dw = TOL[("blstm_bwd_dw", tag)]
    for D in (2 * NFILT, 2 * H):
        x = u(T, B, D)
        wx = torch.as_tensor(glorot(rng, (2, D, H4)), device=dev).to(dtype)
        # dx: the last product of the reduction over 4H dropped
        tol = TOL[("blstm_bwd_dx", tag)]
        ref = bo.blstm_bwd_dx_plain(dgr, wx)
        err = compare(torch, bo.blstm_bwd_dx(dgr, wx), ref, tol, f"blstm_bwd_dx {tag} D={D}")
        cut = dgr.clone()
        cut[..., -1] = 0
        fault = fault_reading(bo.blstm_bwd_dx_plain(cut, wx), ref, tol,
                              f"blstm_bwd_dx {tag} D={D}")
        b_ms, b_by = bound(es * (2 * M * H4 + 2 * D * H4 + 2 * M * D),
                           2 * 2 * M * H4 * D, peak)
        wxt = wx.transpose(1, 2)
        row = {
            "shape": [M, H4, D], "dtype": tag, "max_abs_err": err, "tol": tol,
            "fault_max_abs_err": fault,
            "ms": timed(lambda: bo.blstm_bwd_dx(dgr, wx), reps),
            "plain_ms": timed(lambda: bo.blstm_bwd_dx_plain(dgr, wx), reps),
            "library_ms": timed(lambda: torch.matmul(dg2, wxt), reps),
            "library": "torch.matmul dg @ wx^T (both directions)",
            "bound_ms": b_ms, "bound_by": b_by,
        }
        emit({"phase": "kernels", "kernel": "blstm_bwd_dx", **row})
        rows[("blstm_bwd_dx", tag, D)] = row

        # dwx and db: the last token's term dropped
        dwx, db = bo.blstm_bwd_dwx(x, dgr)
        ref_w, ref_b = bo.blstm_bwd_dwx_plain(x, dgr)
        err = compare(torch, dwx, ref_w, tol_dw, f"blstm_bwd_dwx {tag} D={D}")
        db_err = compare(torch, db, ref_b, tol_dw, f"blstm_bwd_dwx {tag} D={D} db")
        x_cut = x.clone()
        x_cut[-1, -1] = 0
        fault = fault_reading(bo.blstm_bwd_dwx_plain(x_cut, dgr)[0], ref_w, tol_dw,
                              f"blstm_bwd_dwx {tag} D={D}")
        cut = dgr.clone()
        cut[:, -1, -1] = 0
        db_fault = fault_reading(bo.blstm_bwd_dwx_plain(x, cut)[1], ref_b, tol_dw,
                                 f"blstm_bwd_dwx {tag} D={D} db")
        b_ms, b_by = bound(es * (M * D + 2 * M * H4) + 4 * (2 * D * H4 + 2 * H4),
                           2 * (2 * M * D * H4 + M * H4), peak)
        xt = x.view(M, D).t()
        row = {
            "shape": [D, M, H4], "dtype": tag, "max_abs_err": err, "db_max_abs_err": db_err,
            "tol": tol_dw, "fault_max_abs_err": fault, "db_fault_max_abs_err": db_fault,
            "ms": timed(lambda: bo.blstm_bwd_dwx(x, dgr), reps),
            "plain_ms": timed(lambda: bo.blstm_bwd_dwx_plain(x, dgr), reps),
            "library_ms": timed(lambda: torch.matmul(xt, dg2), reps),
            "library": "torch.matmul x^T @ dg (both directions; db not included)",
            "bound_ms": b_ms, "bound_by": b_by,
        }
        emit({"phase": "kernels", "kernel": "blstm_bwd_dwx", **row})
        rows[("blstm_bwd_dwx", tag, D)] = row

    # dwh: the last token's term dropped
    dwh = bo.blstm_bwd_dwh(y, dgr)
    ref = bo.blstm_bwd_dwh_plain(y, dgr)
    err = compare(torch, dwh, ref, tol_dw, f"blstm_bwd_dwh {tag}")
    cut = dgr.clone()
    cut[0, -1, -1] = 0
    fault = fault_reading(bo.blstm_bwd_dwh_plain(y, cut), ref, tol_dw, f"blstm_bwd_dwh {tag}")
    b_ms, b_by = bound(es * (M * 2 * H + 2 * M * H4) + 4 * 2 * H * H4,
                       2 * 2 * (M - B) * H * H4, peak)
    hpt = hprev.view(2, M, H).transpose(1, 2)
    row = {
        "shape": [H, M - B, H4], "dtype": tag, "max_abs_err": err, "tol": tol_dw,
        "fault_max_abs_err": fault,
        "ms": timed(lambda: bo.blstm_bwd_dwh(y, dgr), reps),
        "plain_ms": timed(lambda: bo.blstm_bwd_dwh_plain(y, dgr), reps),
        "library_ms": timed(lambda: torch.matmul(hpt, dg2), reps),
        "library": "torch.matmul hprev^T @ dg (both directions)",
        "bound_ms": b_ms, "bound_by": b_by,
    }
    emit({"phase": "kernels", "kernel": "blstm_bwd_dwh", **row})
    rows[("blstm_bwd_dwh", tag)] = row
    return rows


def ctc_rows(torch, timed, reps) -> dict:
    """The CTC kernels at B = 32, T = 1000, V = 29, L = 120 (S = 241):
    ragged logit lengths, one label of length 0, one infeasible example."""
    from nabu_tpu_torch.ops import ctc_batched as cb

    dev = torch.device("cuda")
    rng = np.random.default_rng(4)
    Bc, Tc, V, L = 32, 1000, 29, 120
    S = 2 * L + 1
    tl = rng.integers(Tc // 4, Tc + 1, Bc)
    tl[0] = Tc
    ll = np.minimum(rng.integers(L // 4, L + 1, Bc), tl // 3)
    ll[0] = L
    ll[1] = 0
    tl[2], ll[2] = 50, L  # infeasible
    labels = torch.as_tensor(rng.integers(0, V - 1, (Bc, L)), dtype=torch.int32, device=dev)
    tl_t = torch.as_tensor(tl, dtype=torch.int32, device=dev)
    ll_t = torch.as_tensor(ll, dtype=torch.int32, device=dev)
    logits = torch.as_tensor(3.0 * rng.standard_normal((Bc, Tc, V)).astype(np.float32),
                             device=dev)
    lp = torch.log_softmax(logits, -1).contiguous()
    args = (lp, tl_t, labels, ll_t)
    alphas, lik = cb.ctc_alpha(*args, V - 1)
    posts = cb.ctc_beta(*args, alphas, lik, V - 1)
    ref_a, ref_l = cb.ctc_alpha_plain(*args, V - 1)
    ref_p = cb.ctc_beta_plain(*args, ref_a, ref_l, V - 1)
    check(float(lik[2]) == -1e4, f"ctc_alpha: infeasible ll {float(lik[2])}")
    err = compare(torch, lik, ref_l, TOL["ctc_ll"], "ctc_alpha ll")
    finite = ref_a > -1e29
    a_err = compare(torch, alphas[finite], ref_a[finite], TOL["ctc_ll"], "ctc_alpha alphas")
    p_err = compare(torch, posts, ref_p, TOL["ctc_posts"], "ctc_beta")
    with swapped(cb, "_lanes", skip_dropped(cb)):
        fault_a, fault_l = cb.ctc_alpha_plain(*args, V - 1)
        fault_p = cb.ctc_beta_plain(*args, ref_a, ref_l, V - 1)
    fault = fault_reading(fault_l, ref_l, TOL["ctc_ll"], "ctc_alpha ll")
    p_fault = fault_reading(fault_p, ref_p, TOL["ctc_posts"], "ctc_beta")
    del fault_a

    # library yardstick: F.ctc_loss (time-major log-probs), forward and
    # forward + backward
    lp_lib = lp.transpose(0, 1).detach().requires_grad_(True)
    tl_lib, ll_lib = torch.as_tensor(tl, device=dev), torch.as_tensor(ll, device=dev)

    def lib_fwd():
        return torch.nn.functional.ctc_loss(
            lp_lib, labels, tl_lib, ll_lib, blank=V - 1, reduction="sum", zero_infinity=True)

    def lib_fwd_bwd():
        lib_fwd().backward()

    lib_f = timed(lib_fwd, reps)
    lib_fb = timed(lib_fwd_bwd, reps)
    valid = int(tl.sum())
    rows = {}
    b_ms, b_by = bound(4 * (Bc * Tc * V + Bc * L + 3 * Bc + Tc * Bc * S), valid * S * 10,
                       PEAK_F32)
    rows["ctc_alpha"] = {
        "shape": [Bc, Tc, V, S], "dtype": "f32", "max_abs_err": err,
        "alphas_max_abs_err": a_err, "tol": TOL["ctc_ll"], "fault_max_abs_err": fault,
        "ms": timed(lambda: cb.ctc_alpha(*args, V - 1), reps),
        "plain_ms": timed(lambda: cb.ctc_alpha_plain(*args, V - 1), min(reps, 2)),
        "library_ms": lib_f, "library": "F.ctc_loss forward",
        "bound_ms": b_ms, "bound_by": b_by,
    }
    emit({"phase": "kernels", "kernel": "ctc_alpha", **rows["ctc_alpha"]})
    b_ms, b_by = bound(4 * (Bc * Tc * V + Bc * L + 3 * Bc + 2 * Tc * Bc * S), valid * S * 14,
                       PEAK_F32)
    rows["ctc_beta"] = {
        "shape": [Bc, Tc, V, S], "dtype": "f32", "max_abs_err": p_err,
        "tol": TOL["ctc_posts"], "fault_max_abs_err": p_fault,
        "ms": timed(lambda: cb.ctc_beta(*args, alphas, lik, V - 1), reps),
        "plain_ms": timed(lambda: cb.ctc_beta_plain(*args, alphas, lik, V - 1),
                          min(reps, 2)),
        "library_ms": None if lib_f is None else lib_fb - lib_f,
        "library": "F.ctc_loss backward (forward + backward minus forward)",
        "bound_ms": b_ms, "bound_by": b_by,
    }
    emit({"phase": "kernels", "kernel": "ctc_beta", **rows["ctc_beta"]})
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
        for name in SERVE_KERNELS:
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
        with plain_versions(stft_mel=drop_last_tap(stft_ops.stft_mel_plain)):
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
        with plain_versions(blstm_recur=carry_not_held(torch)):
            logits_f, _ = logits()
        with plain_versions(blstm_recur=stale_recur(torch)):
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
    return {"launches": launches, "batches": batches}


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def synth_corpus(root: str, rng, num_utts: int, alphabet, rate: int = 16000):
    """Character utterances of 2-10 s at ~12 symbols a second, each symbol
    a tone of its own frequency (with a noise floor), written as wavs
    with Kaldi-style wav.scp and text. Returns (scp, text, audio s)."""
    from nabu_tpu_torch.data import audio_io

    os.makedirs(root, exist_ok=True)
    freqs = np.geomspace(150.0, 4000.0, len(alphabet))
    chars = [" " if a == "<space>" else a for a in alphabet]
    scp, text, total = [], [], 0.0
    for i in range(num_utts):
        seconds = rng.uniform(2.0, 10.0)
        syms = rng.integers(0, len(alphabet), max(1, int(round(12.0 * seconds))))
        seg = int(seconds * rate) // len(syms)
        t = np.arange(seg) / rate
        env = np.minimum(1.0, np.minimum(t, t[::-1]) / 0.01)
        sig = np.concatenate([np.sin(2 * np.pi * freqs[k] * t) * env for k in syms])
        sig = 6000.0 * sig + 40.0 * rng.standard_normal(len(sig))
        path = os.path.join(root, f"utt{i:04d}.wav")
        audio_io.write_wav(path, sig.astype(np.float32), rate)
        total += len(sig) / rate
        scp.append(f"utt{i:04d} {path}")
        text.append(f"utt{i:04d} {''.join(chars[k] for k in syms)}")
    scp_path, text_path = os.path.join(root, "wav.scp"), os.path.join(root, "text")
    with open(scp_path, "w") as f:
        f.write("\n".join(scp) + "\n")
    with open(text_path, "w") as f:
        f.write("\n".join(text) + "\n")
    return scp_path, text_path, total


def write_train_recipe(out_dir: str, train, dev) -> str:
    """The dblstm_ctc_wsj recipe with its datafiles pointed at the
    synthesized corpus and TRAIN_STEPS steps; nothing else changed."""
    from nabu_tpu_torch.config import ConfigFile

    os.makedirs(out_dir, exist_ok=True)
    for fname in os.listdir(RECIPE):
        with open(os.path.join(RECIPE, fname)) as f:
            text = f.read()
        with open(os.path.join(out_dir, fname), "w") as f:
            f.write(text)
    db = ConfigFile.read(os.path.join(out_dir, "database.conf"))
    for split, (scp, txt) in (("train", train), ("dev", dev), ("test", dev)):
        db.section(f"{split}features").set("datafile", scp)
        db.section(f"{split}targets").set("datafile", txt)
    db.write(os.path.join(out_dir, "database.conf"))
    tc = ConfigFile.read(os.path.join(out_dir, "trainer.cfg"))
    tc.section("trainer").set("num_steps", TRAIN_STEPS)
    tc.write(os.path.join(out_dir, "trainer.cfg"))
    return out_dir


@contextlib.contextmanager
def step_timers(torch, record: dict):
    """Synchronized host timers around the trainer's step phases:
    forward (Model.apply_train), forward + loss (Trainer._loss), backward
    (Trainer._backward) and optimizer (Trainer._apply_grads), and the
    synchronized clock at each step's end (``step_end``: the window
    between two such readings holds everything the loop does, loader,
    copy to the device and logging included). Also keeps each step's loss
    and audio frames, the trainer, the model, the live parameters and the
    longest batch."""
    from nabu_tpu_torch.models.model import Model
    from nabu_tpu_torch.training.trainer import Trainer

    def timed(name, fn):
        def wrapped(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            record.setdefault(name, []).append(time.perf_counter() - t0)
            return out
        return wrapped

    saved = {(Model, "apply_train"): Model.apply_train, (Trainer, "_loss"): Trainer._loss,
             (Trainer, "_backward"): Trainer._backward,
             (Trainer, "_apply_grads"): Trainer._apply_grads}
    fwd = timed("forward", saved[(Model, "apply_train")])
    loss = timed("forward_loss", saved[(Trainer, "_loss")])

    def apply_train(self, *a, **kw):
        record["model"] = self
        return fwd(self, *a, **kw)

    def _loss(self, params, batch, generator):
        record["trainer"] = self
        out = loss(self, params, batch, generator)
        record.setdefault("loss", []).append(float(out[0].detach()))
        mask = batch["example_mask"]
        record.setdefault("frames", []).append(
            float((batch["feature_lengths"].float() * mask).sum()))
        if batch["features"].shape[1] >= record.get("batch_T", 0):
            record["batch_T"] = int(batch["features"].shape[1])
            record["batch"] = batch
        return out

    apply_grads = timed("optimizer", saved[(Trainer, "_apply_grads")])

    def _apply_grads(self, params, *a, **kw):
        record["params"] = params
        out = apply_grads(self, params, *a, **kw)
        record.setdefault("step_end", []).append(time.perf_counter())
        return out

    Model.apply_train = apply_train
    Trainer._loss = _loss
    Trainer._backward = timed("backward", saved[(Trainer, "_backward")])
    Trainer._apply_grads = _apply_grads
    try:
        yield
    finally:
        for (cls, name), fn in saved.items():
            setattr(cls, name, fn)


def gradient_check(torch, trainer, params, batch):
    """One full-width batch, dropout off: loss and every parameter
    gradient through the kernels against the same step through the plain
    versions, and through two planted faults: the bw direction's dx left
    out of the sum (which the tolerance must reject) and the backward
    chain's barrier not waiting (every dgates exchange one step stale,
    reported). Per parameter the reading is ||kernel - plain|| /
    ||plain||."""
    from nabu_tpu_torch.ops import blstm as bo
    from nabu_tpu_torch.params import flatten, unflatten

    flat = {k: v.detach() for k, v in flatten(params).items()}

    def loss_and_grads():
        leaves = {k: v.clone().requires_grad_(True) for k, v in flat.items()}
        loss, _ = trainer.loss_fn(unflatten(leaves), batch, None, False)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return loss.detach(), dict(zip(leaves, grads))

    t0 = time.perf_counter()
    loss_k, grads_k = loss_and_grads()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with plain_versions():
        loss_p, grads_p = loss_and_grads()
    torch.cuda.synchronize()
    t2 = time.perf_counter()

    def fw_dx_only(dg, wx):
        dx = bo.blstm_bwd_dx_plain(dg, wx)
        dx[1] = 0
        return dx

    with plain_versions(blstm_bwd_dx=fw_dx_only):
        _, grads_f = loss_and_grads()
    hidden = flat["encoder/layer_0/fw/wh"].shape[0]
    with plain_versions(blstm_bwd_recur=faulty_chain(torch, stale_units=hidden)):
        _, grads_s = loss_and_grads()

    def rel(grads):
        return {k: float(torch.linalg.vector_norm((grads[k] - grads_p[k]).float())
                         / torch.linalg.vector_norm(grads_p[k].float()).clamp(min=1e-30))
                for k in grads_p}

    rel_k, rel_f, rel_s = rel(grads_k), rel(grads_f), rel(grads_s)
    for k, g in grads_k.items():
        check(bool(torch.isfinite(g).all()), f"train gradient {k}: non-finite")
    loss_err = compare(torch, loss_k, loss_p, TOL["train_loss"], "train batch loss")
    worst = max(rel_k.values())
    fault = max(rel_f.values())
    if worst > TOL["train_grads"]:
        FAILURES.append(f"train gradients: max relative error {worst} beyond "
                        f"{TOL['train_grads']}")
    if not fault > TOL["train_grads"]:
        FAILURES.append(f"train gradients: a planted fault ({fault}) passes "
                        f"{TOL['train_grads']}")
    return {
        "batch_shape": list(batch["features"].shape), "loss_kernels": float(loss_k),
        "loss_plain": float(loss_p), "loss_max_abs_err": loss_err,
        "loss_tol": TOL["train_loss"], "grads_max_rel_err": worst,
        "grads_rel_err": rel_k, "grads_tol": TOL["train_grads"],
        "fault_grads_max_rel_err": fault,
        "stale_exchange_grads_max_rel_err": max(rel_s.values()),
        "kernel_step_s": t1 - t0, "plain_step_s": t2 - t1,
    }


def phase_train(torch, smi: str) -> dict:
    from nabu_tpu_torch import cli
    from nabu_tpu_torch.config import ConfigFile
    from nabu_tpu_torch.ops import kernels
    from nabu_tpu_torch.params import load_npz

    rng = np.random.default_rng(5)
    alphabet = ConfigFile.read(os.path.join(RECIPE, "database.conf")).section(
        "traintargets").getlist("alphabet")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        t0 = time.perf_counter()
        train = synth_corpus(os.path.join(tmp, "train"), rng, TRAIN_UTTS, alphabet)
        dev = synth_corpus(os.path.join(tmp, "dev"), rng, 32, alphabet)
        recipe = write_train_recipe(os.path.join(tmp, "recipe"), train[:2], dev[:2])
        expdir = os.path.join(tmp, "exp")
        t1 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            cli.main(["data", "--recipe", recipe, "--expdir", expdir,
                      "--num_workers", str(min(8, os.cpu_count() or 1))])
        t2 = time.perf_counter()

        record: dict = {}
        kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        with step_timers(torch, record), contextlib.redirect_stdout(sys.stderr):
            cli.main(["train", "--recipe", recipe, "--expdir", expdir])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t3
        launches = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated()

        losses = record["loss"]
        steps = len(losses)
        phases = {
            "forward": record["forward"],
            "loss": [a - b for a, b in zip(record["forward_loss"], record["forward"])],
            "backward": record["backward"], "optimizer": record["optimizer"],
        }
        step_s = [sum(v[i] for v in phases.values()) for i in range(steps)]
        for i in range(steps):
            emit({"phase": "train_step", "step": i + 1, "loss": losses[i],
                  "ms": {k: 1e3 * v[i] for k, v in phases.items()}})
        median_ms = {k: 1e3 * float(np.median(v[1:])) for k, v in phases.items()}
        audio_s = sum(record["frames"][1:]) * 0.01
        # steps 2..N end to end: from step 1's synchronized end to step N's
        ends = record["step_end"]
        window = ends[-1] - ends[0]
        check(steps == TRAIN_STEPS, f"train: {steps} steps, want {TRAIN_STEPS}")
        check(all(math.isfinite(v) for v in losses), "train: a non-finite loss")
        first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
        check(last < first, f"train: loss not falling ({first} -> {last})")
        for name in kernels.KERNELS:
            want = steps * TRAIN_STEP_LAUNCHES.get(name, 0)
            check(launches[name] == want,
                  f"train: {launches[name]} launches of {name}, want {want}")
        check(os.path.exists(os.path.join(expdir, "logs", "train_complete.json")),
              "train: no train_complete.json")

        # latest/ reloads into parameters that give the same logits
        model, params, batch = record["model"], record["params"], record["batch"]
        loaded = load_npz(os.path.join(expdir, "checkpoints", "latest", "params.npz"),
                          device=batch["features"].device)
        feats, lens = batch["features"], batch["feature_lengths"]
        live = model.apply(params, feats, lens)["decoder"][0]
        again = model.apply(loaded, feats, lens)["decoder"][0]
        check(torch.equal(live, again), "train: latest/ gives other logits")

        grad = gradient_check(torch, record["trainer"], params, batch)
        result = {
            "phase": "train", "steps": steps, "utterances": TRAIN_UTTS,
            "corpus_audio_seconds": train[2], "synth_seconds": t1 - t0,
            "data_seconds": t2 - t1, "train_wall_seconds": wall,
            "loss_first5_mean": first, "loss_last5_mean": last,
            "median_step_ms": median_ms,
            "median_step_total_ms": 1e3 * float(np.median(step_s[1:])),
            "first_step_ms": 1e3 * step_s[0],
            "median_step_wall_ms": 1e3 * float(np.median(np.diff(ends))),
            "window_seconds": window, "window_phases_seconds": sum(step_s[1:]),
            "train_audio_seconds_per_second": audio_s / window,
            "phases_audio_seconds_per_second": audio_s / sum(step_s[1:]),
            "peak_device_memory_bytes": peak, "launches": launches,
            "per_step_launches": TRAIN_STEP_LAUNCHES, "card": smi,
        }
        emit(result)
        emit({"phase": "train_check", **grad})
    return result


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
        raise_failures()
        print("chip_smoke: quick check done (no result)", file=sys.stderr)
        return 0
    served = phase_serve(torch, smi)
    t3 = time.perf_counter()
    trained = phase_train(torch, smi)
    emit({"phase": "seconds", "build_device": t1 - t0, "kernels": t2 - t1,
          "serve": t3 - t2, "train": time.perf_counter() - t3})
    raise_failures()

    kernels_line = []
    for name, key in (("stft_mel", "stft_mel"),
                      ("blstm_proj", ("blstm_proj", "bf16", 2 * H)),
                      ("blstm_recur", ("blstm_recur", "bf16")),
                      ("blstm_recur_train", ("blstm_recur_train", "bf16")),
                      ("blstm_bwd_recur", ("blstm_bwd_recur", "bf16")),
                      ("blstm_bwd_dx", ("blstm_bwd_dx", "bf16", 2 * H)),
                      ("blstm_bwd_dwx", ("blstm_bwd_dwx", "bf16", 2 * H)),
                      ("blstm_bwd_dwh", ("blstm_bwd_dwh", "bf16")),
                      ("ctc_alpha", "ctc_alpha"),
                      ("ctc_beta", "ctc_beta")):
        r = rows[key]
        kernels_line.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": TPU_KERNELS[name],
            "launches": served["launches"][name] + trained["launches"][name],
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
