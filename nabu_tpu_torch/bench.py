"""Training throughput of the bench models' steps on one GPU.

Port of the JAX package's ``bench.py`` training measurement for its
models, through the kernels (``use_pallas = true`` in the encoder and
CTC sections), in bf16 by default:

- ``--model dblstm`` (the default): BASELINE config 2's 4x320 DBLSTM
  encoder, the linear CTC head and the CTC loss;
- ``--model rnnt``: the transducer of ``bench.py``'s ``rnnt`` line, a
  Listener of 2 pyramid layers over a bottom layer, 320 units (time / 4),
  a 1x320 prediction LSTM with 128-wide embeddings, a 320-wide joint and
  the RNN-T loss (31 labels and the blank: V = 32);
- ``--model las``: the joint CTC/attention model of ``bench.py``'s ``las``
  line, a Listener of 4 pyramid layers over a bottom layer, 512 units
  (time / 16), a 2x512 bahdanau Speller with 256-wide embeddings
  (scheduled sampling 0.1, label smoothing 0.1, loss weight 0.7) and a
  linear CTC head (loss weight 0.3);
- ``--model transformer`` / ``conformer`` / ``moe_conformer``: the
  attention encoders of ``bench.py``'s lines, 6 blocks of 512 units, 8
  heads, a 2048-wide FFN, a time / 4 pyramid stack before the blocks
  (``moe_conformer``: the second half-step FFN of each conformer block 8
  expert-choice experts at capacity 2.0), the linear CTC head and the CTC
  loss;
- ``--model conformer_rnnt``: ``bench.py``'s conformer-transducer, 8
  conformer blocks of 256 units, 4 heads, a 1024-wide FFN, kernel 15,
  time / 4, and the transducer head of the ``rnnt`` line (a 1 x 320
  prediction LSTM, 128-wide embeddings, a 320-wide joint).

The attention encoders are PyTorch ops (the JAX package computes them
outside any Pallas kernel); their lines launch the CTC kernels, or the
RNN-T kernels and the prediction net's LSTM kernels. ``--scan_layers``
(JAX's flag; on by default for the attention encoders, as the recipes
set it) only sets the encoder's key: the port runs the blocks as a loop
either way, JAX's scan's numerics.

The batch is ``make_batch``'s (B = 32, T = 1000, 80 features, 100 labels,
every length full), made from ``--seed`` with numpy and put on the device
once, outside the timed loop. A step is forward, loss, backward, then the
optimizer of ``training.trainer.Optimizer``: global-norm clipping at 5.0,
then Adam at 1e-3. Defaults: 2 warmup steps, then 3 repeats of 8 timed
steps.

Run on the card (the default device), or on the CPU only when asked:

    python -m nabu_tpu_torch.bench [--mode train|decode]
        [--model dblstm|rnnt|las|transformer|conformer|moe_conformer|conformer_rnnt]
        [--head att|ctc|joint] [--device cpu] [--batch 32] [--frames 1000]
        [--steps 8] [--warmup 2] [--repeats 3] [--beam_width 8] [--seed 0]
        [--no-bf16] [--[no-]scan_layers]

It prints ONE JSON line:

- ``metric`` ``train_audio_seconds_per_second_per_chip``, ``value`` the
  median over the repeats of the audio trained per second (B x T x 10 ms
  a step), ``unit`` ``audio_s/s``;
- ``median_step_ms``, the median of the timed steps, and its split
  ``forward_ms`` (``Model.apply_train``), ``loss_ms``, ``backward_ms``
  and ``optimizer_ms`` (each the median of its phase); on a GPU each is
  taken between CUDA events recorded on the stream, on the CPU by the
  host clock;
- ``peak_memory_bytes`` of the timed steps (null on the CPU);
- ``device`` and ``power_limit_w`` as ``nvidia-smi --query-gpu=name,
  power.limit`` reports them (the CPU: ``cpu`` and null);
- ``first_loss`` (the loss of the first step, on the initial weights) and
  ``last_loss``, the model, the shape, the dtype and the kernels'
  launches.

The JAX line's ``vs_baseline`` is left out: its denominator is a naive
JAX port (per-step input projection inside an XLA scan) timed on the same
TPU, and that has no counterpart on the GPU.

``--mode decode`` times decoding instead, as the JAX bench's ``--mode
decode`` does, on the same batch and the seeded weights: ``--model
dblstm`` runs the encoder, the log-softmax and ``ctc_prefix_beam_search``
(blank last, at most 128 labels) over the full batch, as do the
attention-encoder CTC models; ``--model rnnt`` and ``conformer_rnnt``
the ``transducer_beam`` recognizer; ``--model las`` by ``--head`` (JAX's
``--head``): ``att`` (the default) the ``attention_beam`` recognizer on
the Speller, ``ctc`` the prefix search on the CTC head, ``joint`` the
``joint_ctc_att_beam`` recognizer (``ctc_weight`` 0.3). One untimed
decode first, then
``--repeats`` measurements of ``max(steps // 4, 1)`` decodes, each ended
on the host (the n-best read back, the device synchronized). It prints
ONE JSON line with the JAX line's keys: ``metric``
(``ctc_beam_decode_rtf``, ``transducer_beam_decode_rtf``,
``attention_beam_decode_rtf`` or ``joint_ctc_att_beam_decode_rtf``), ``value``
the median RTF (decode time over B x T x 10 ms of audio), ``unit``
``rtf``, ``vs_baseline`` 1.0, ``beam_width_realized`` (the width of the
search's output; the run fails when it is not ``--beam_width``) and
``batch``; then ``device``, ``power_limit_w``, the model, the shape and
the kernels' launches over the timed decodes.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time
from typing import Dict, Optional

import numpy as np
import torch

from nabu_tpu_torch.config import Conf, ConfigFile
from nabu_tpu_torch.data.pipeline import batch_to_device
from nabu_tpu_torch.device import resolve_device
from nabu_tpu_torch.models.model import build_model
from nabu_tpu_torch.ops import kernels
from nabu_tpu_torch.ops.losses import make_loss_computer
from nabu_tpu_torch.params import flatten, unflatten
from nabu_tpu_torch.training.trainer import Optimizer

METRIC = "train_audio_seconds_per_second_per_chip"
FEATURES, LABELS, NUM_LABELS = 80, 100, 31
FRAME_SHIFT = 0.01
# the encoder's layers and units of each model's line in bench.py
MODELS = {"dblstm": (4, 320), "rnnt": (2, 320), "las": (4, 512), "transformer": (6, 512),
          "conformer": (6, 512), "moe_conformer": (6, 512), "conformer_rnnt": (8, 256)}
# the attention encoders' heads; their FFN is 4x the units wide
ATTENTION_HEADS = {"transformer": 8, "conformer": 8, "moe_conformer": 8, "conformer_rnnt": 4}
# the decode line's metric of each (model, --head); the head matters for las only
DECODE_METRICS = {"att": "attention_beam_decode_rtf", "ctc": "ctc_beam_decode_rtf",
                  "joint": "joint_ctc_att_beam_decode_rtf"}


def line_shape(model: str, num_layers: Optional[int], num_units: Optional[int]) -> tuple:
    """-> (layers, units) of ``model``'s encoder, the line's own where None."""
    if model not in MODELS:
        raise ValueError(f"bench: unknown model {model!r} (one of {sorted(MODELS)})")
    return num_layers or MODELS[model][0], num_units or MODELS[model][1]


def build_model_and_loss(bf16: bool = True, num_layers: Optional[int] = None,
                         num_units: Optional[int] = None, model: str = "dblstm",
                         scan_layers: Optional[bool] = None):
    """-> (model, loss_fn) of ``bench.py``'s ``build_model_and_loss`` for
    a model of ``MODELS`` with the kernels on; ``num_layers`` x
    ``num_units`` (``MODELS``) sets the encoder (an attention encoder's
    FFN 4 x ``num_units`` wide), and the rnnt head's prediction LSTM and
    joint, and the las Speller's layers, take ``num_units`` too (``None``:
    the line's own); conformer_rnnt's head is the line's, 1 x 320.
    ``scan_layers`` (``None``: on for the attention encoders) sets their
    key."""
    num_layers, num_units = line_shape(model, num_layers, num_units)
    model_sec = {"compute_dtype": "bfloat16" if bf16 else "float32"}
    ctc = {"decoder": "linear_ctc", "loss": "ctc", "use_pallas": "true"}
    if model in ATTENTION_HEADS:
        encoder = {"encoder": "transformer" if model == "transformer" else "conformer",
                   "num_heads": str(ATTENTION_HEADS[model]), "ffn_dim": str(4 * num_units),
                   "subsample": "4",
                   "scan_layers": "false" if scan_layers is False else "true"}
        if model == "moe_conformer":
            encoder.update(moe_experts="8", moe_capacity="2.0")
        if model == "conformer_rnnt":
            encoder["kernel_size"] = "15"
            heads = {"decoder": {"decoder": "rnnt", "num_layers": "1", "num_units": "320",
                                 "embed_dim": "128", "joint_units": "320",
                                 "loss": "transducer", "use_pallas": "true"}}
        else:
            heads = {"decoder": ctc}
    elif model == "dblstm":
        encoder = {"encoder": "dblstm"}
        heads = {"decoder": ctc}
    elif model == "rnnt":
        encoder = {"encoder": "listener"}
        heads = {"decoder": {"decoder": "rnnt", "num_layers": "1", "num_units": str(num_units),
                             "embed_dim": "128", "joint_units": str(num_units),
                             "loss": "transducer", "use_pallas": "true"}}
    elif model == "las":
        encoder = {"encoder": "listener"}
        model_sec["decoders"] = "att ctc"
        heads = {"att": {"decoder": "speller", "num_layers": "2", "num_units": str(num_units),
                         "embed_dim": "256", "sample_prob": "0.1", "label_smoothing": "0.1",
                         "loss": "cross_entropy", "loss_weight": "0.7"},
                 "ctc": {**ctc, "loss_weight": "0.3"}}
    cfg = ConfigFile({
        "model": Conf(model_sec, "model"),
        "encoder": Conf({**encoder, "num_layers": str(num_layers), "num_units": str(num_units),
                         "use_pallas": "true"}, "encoder"),
        **{name: Conf(sec, name) for name, sec in heads.items()},
    })
    net = build_model(cfg, input_dim=FEATURES, num_labels=NUM_LABELS)
    return net, make_loss_computer(net)


def describe(model: str, num_layers: int, num_units: int) -> str:
    if model in ATTENTION_HEADS:
        enc = (f"{model.replace('_rnnt', '')} {num_layers}x{num_units}, "
               f"{ATTENTION_HEADS[model]} heads, ffn {4 * num_units}, time/4")
        if model == "moe_conformer":
            enc += ", 8 experts at capacity 2.0"
        if model == "conformer_rnnt":
            return f"{enc} + prediction 1x320, joint 320, transducer loss"
        return f"{enc} + linear_ctc, ctc loss"
    if model == "dblstm":
        return f"dblstm {num_layers}x{num_units} + linear_ctc, ctc loss"
    if model == "las":
        return (f"las: listener {num_layers}x{num_units} + speller 2x{num_units} bahdanau, "
                "linear_ctc; 0.7 cross_entropy + 0.3 ctc loss")
    return (f"rnnt: listener {num_layers}x{num_units} + prediction 1x{num_units}, joint "
            f"{num_units}, transducer loss")


def make_batch(B: int, T: int, F: int, L: int, rng) -> Dict[str, np.ndarray]:
    """``bench.py``'s ``make_batch``: the same arrays from the same rng."""
    return {
        "features": rng.standard_normal((B, T, F)).astype(np.float32),
        "feature_lengths": np.full((B,), T, np.int32),
        "targets": rng.integers(0, NUM_LABELS, (B, L)).astype(np.int32),
        "target_lengths": np.full((B,), L, np.int32),
        "example_mask": np.ones((B,), np.float32),
    }


def card() -> tuple:
    """-> (name, power limit in W) of GPU 0 from nvidia-smi."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    name, limit = out.strip().splitlines()[0].rsplit(",", 1)
    return name.strip(), float(limit.strip().split()[0])


class _Clock:
    """Marks on the device's stream (CUDA events) or the host clock (CPU)."""

    def __init__(self, dev: torch.device):
        self.cuda = dev.type == "cuda"

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    def ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else 1e3 * (b - a)


def train_line(batch: int = 32, frames: int = 1000, steps: int = 8, warmup: int = 2,
               repeats: int = 3, seed: int = 0, device=None, bf16: bool = True,
               num_layers: Optional[int] = None, num_units: Optional[int] = None,
               labels: int = LABELS, params: Optional[dict] = None,
               model_name: str = "dblstm", scan_layers: Optional[bool] = None) -> dict:
    """Time the training step of ``model_name`` (``MODELS``); -> the JSON
    line's fields. ``params`` (f32, the model's tree) replaces the seeded
    initial weights."""
    dev = resolve_device(device)
    num_layers, num_units = line_shape(model_name, num_layers, num_units)
    model, loss_fn = build_model_and_loss(bf16, num_layers, num_units, model_name, scan_layers)
    rng = np.random.default_rng(seed)
    arrays = make_batch(batch, frames, FEATURES, labels, rng)
    data = batch_to_device(arrays, dev, feature_dtype=model.compute_dtype)
    if params is None:
        params = model.init(torch.Generator().manual_seed(seed))
    flat = {k: v.detach().to(dev, torch.float32).clone().requires_grad_(True)
            for k, v in flatten(params).items()}
    tree = unflatten(flat)
    leaves = list(flat.values())
    optimizer = Optimizer(Conf({"optimizer": "adam", "learning_rate": "1e-3",
                                "clip_grad_norm": "5.0"}, "bench"))
    opt_state = optimizer.init(tree)
    clock = _Clock(dev)
    marks: list = []

    forward = model.apply_train

    def timed_forward(*args, **kwargs):
        out = forward(*args, **kwargs)
        marks.append(clock.mark())
        return out

    model.apply_train = timed_forward  # the loss computer calls it

    def step():
        """One step; -> its loss and its five marks (start, forward, loss,
        backward, optimizer)."""
        marks.clear()
        start = clock.mark()
        loss, _ = loss_fn(tree, data, None, True)
        after_loss = clock.mark()
        grads = torch.autograd.grad(loss, leaves)
        after_backward = clock.mark()
        optimizer.step(tree, dict(zip(flat, grads)), opt_state, 1.0)
        end = clock.mark()
        return loss.detach(), (start, marks[0], after_loss, after_backward, end)

    kernels.reset_launch_counts()
    first_loss = None
    for _ in range(warmup):
        loss, _ = step()
        if first_loss is None:
            first_loss = float(loss)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    timed, values = [], []
    for _ in range(max(repeats, 1)):
        run = [step() for _ in range(steps)]
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        if first_loss is None:
            first_loss = float(run[0][0])
        timed += [m for _, m in run]
        elapsed_ms = clock.ms(run[0][1][0], run[-1][1][-1])
        values.append(batch * frames * FRAME_SHIFT * steps / (1e-3 * elapsed_ms))
    last_loss = float(run[-1][0])

    def median(i, j):
        return statistics.median(clock.ms(m[i], m[j]) for m in timed)

    if dev.type == "cuda":
        name, limit = card()
        peak = torch.cuda.max_memory_allocated(dev)
    else:
        name, limit, peak = "cpu", None, None
    return {
        "metric": METRIC,
        "value": statistics.median(values),
        "unit": "audio_s/s",
        "median_step_ms": median(0, 4),
        "forward_ms": median(0, 1),
        "loss_ms": median(1, 2),
        "backward_ms": median(2, 3),
        "optimizer_ms": median(3, 4),
        "peak_memory_bytes": peak,
        "device": name,
        "power_limit_w": limit,
        "first_loss": first_loss,
        "last_loss": last_loss,
        "model": describe(model_name, num_layers, num_units),
        "dtype": "bfloat16" if bf16 else "float32",
        "batch": batch, "frames": frames, "labels": labels,
        "warmup": warmup, "steps": steps, "repeats": max(repeats, 1), "seed": seed,
        "launches": {k: v for k, v in kernels.launch_counts().items() if v},
    }


def decode_line(batch: int = 32, frames: int = 1000, steps: int = 8, repeats: int = 3,
                beam_width: int = 8, seed: int = 0, device=None, bf16: bool = True,
                num_layers: Optional[int] = None, num_units: Optional[int] = None,
                model_name: str = "dblstm", head: str = "att",
                scan_layers: Optional[bool] = None) -> dict:
    """Time the beam-search decode of ``model_name`` (``MODELS``; for
    ``las`` of ``head``, ``DECODE_METRICS``); -> the JSON line's fields
    (the JAX bench's ``time_decode`` for ``dblstm``, las ``ctc`` and the
    attention-encoder CTC models, ``time_transducer_decode`` for ``rnnt``
    and ``conformer_rnnt``, ``time_attention_decode`` and
    ``time_joint_decode`` for las ``att`` and ``joint``)."""
    from nabu_tpu_torch.decoding.ctc_beam import ctc_prefix_beam_search
    from nabu_tpu_torch.decoding.recognizers import (
        AttentionBeamRecognizer,
        JointCTCAttBeamRecognizer,
        TransducerBeamRecognizer,
    )

    dev = resolve_device(device)
    num_layers, num_units = line_shape(model_name, num_layers, num_units)
    if head not in DECODE_METRICS:
        raise ValueError(f"bench: unknown head {head!r} (one of {sorted(DECODE_METRICS)})")
    model, _ = build_model_and_loss(bf16, num_layers, num_units, model_name, scan_layers)
    arrays = make_batch(batch, frames, FEATURES, LABELS, np.random.default_rng(seed))
    params = unflatten({k: v.to(dev) for k, v in flatten(
        model.init(torch.Generator().manual_seed(seed))).items()})
    feats = torch.as_tensor(arrays["features"], device=dev)
    flen = torch.as_tensor(arrays["feature_lengths"], device=dev)
    conf = {"beam_width": str(beam_width)}

    transducer = model_name in ("rnnt", "conformer_rnnt")
    if (model_name == "las" and head == "ctc") or (model_name != "las" and not transducer):
        metric = "ctc_beam_decode_rtf"
        ctc_head = "ctc" if model_name == "las" else "decoder"

        @torch.no_grad()
        def decode():
            logits, logit_lengths = model.apply(params, feats, flen, heads=(ctc_head,))[ctc_head]
            out = ctc_prefix_beam_search(torch.log_softmax(logits, dim=-1), logit_lengths,
                                         beam_width, logits.shape[-1] - 1, max_label_len=128)
            return [x.cpu() for x in out]

        width = int(decode()[2].shape[1])
    else:
        if transducer:
            metric = "transducer_beam_decode_rtf"
            rec = TransducerBeamRecognizer(Conf(conf, "recognizer"), model)
        elif head == "att":
            metric = DECODE_METRICS[head]
            rec = AttentionBeamRecognizer(Conf(conf, "recognizer"), model, head="att")
        else:
            metric = DECODE_METRICS[head]
            rec = JointCTCAttBeamRecognizer(Conf(
                {**conf, "att_head": "att", "ctc_head": "ctc", "ctc_weight": "0.3"},
                "recognizer"), model)

        def decode():
            return rec(params, feats, flen)

        decode()
        with torch.no_grad():
            # the search's raw output, before the n-best is cut from it
            encoded, enc_lengths, head_params = rec._encode(params, feats, flen)
            width = int(rec.search(head_params, encoded, enc_lengths)[2].shape[1])
    if width != beam_width:
        raise SystemExit(f"--beam_width {beam_width} did not reach the search "
                         f"(realized width {width})")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    calls = max(steps // 4, 1)
    audio_s = batch * frames * FRAME_SHIFT * calls
    kernels.reset_launch_counts()
    rtfs = []
    for _ in range(max(repeats, 1)):
        sync()
        t0 = time.perf_counter()
        for _ in range(calls):
            decode()
        sync()
        rtfs.append((time.perf_counter() - t0) / audio_s)
    name, limit = card() if dev.type == "cuda" else ("cpu", None)
    return {
        "metric": metric,
        "value": round(statistics.median(rtfs), 5),
        "unit": "rtf",
        "vs_baseline": 1.0,
        "beam_width_realized": width,
        "batch": batch,
        "rtfs": rtfs,
        "device": name,
        "power_limit_w": limit,
        "model": describe(model_name, num_layers, num_units),
        "dtype": "bfloat16" if bf16 else "float32",
        "frames": frames, "decodes_per_repeat": calls, "repeats": max(repeats, 1),
        "seed": seed,
        "launches": {k: v for k, v in kernels.launch_counts().items() if v},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", default="train", choices=["train", "decode"])
    ap.add_argument("--model", default="dblstm", choices=sorted(MODELS))
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--frames", type=int, default=1000)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--repeats", type=int, default=3,
                    help="measurements; the median is reported")
    ap.add_argument("--beam_width", type=int, default=8, help="decode mode's beam")
    ap.add_argument("--head", default="att", choices=sorted(DECODE_METRICS),
                    help="decode mode, --model las: the attention beam, the CTC head's "
                         "prefix beam, or the joint CTC/attention beam")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--bf16", action=argparse.BooleanOptionalAction, default=True,
                    help="bfloat16 compute dtype")
    ap.add_argument("--scan_layers", action=argparse.BooleanOptionalAction, default=None,
                    help="the attention encoders' scan_layers key (default on, as the "
                         "recipes; the port loops over the blocks either way)")
    args = ap.parse_args(argv)
    common = dict(batch=args.batch, frames=args.frames, steps=args.steps,
                  repeats=args.repeats, seed=args.seed, device=args.device, bf16=args.bf16,
                  model_name=args.model, scan_layers=args.scan_layers)
    if args.mode == "decode":
        line = decode_line(beam_width=args.beam_width, head=args.head, **common)
    else:
        line = train_line(warmup=args.warmup, **common)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
