"""`decode`: dump n-best hypotheses for the recognizer's dataset.

Port of the JAX package's ``scripts/decode.py``: ``recognizer.cfg``'s
recognizer over its prepared dataset with the best checkpoint, on the
GPU unless ``device="cpu"``. Writes ``<expdir>/decoded/nbest.txt``, one
``utt score text`` line per hypothesis, and prints the steady-state RTF.
"""

from __future__ import annotations

import os
import time

import torch

from nabu_tpu_torch.config import Recipe
from nabu_tpu_torch.data.processors import ids_to_text
from nabu_tpu_torch.decoding.recognizers import build_recognizer
from nabu_tpu_torch.device import resolve_device
from nabu_tpu_torch.scripts.common import make_loader, model_from_recipe
from nabu_tpu_torch.scripts.test import load_best_params


def steady_rtf(shape_times: dict):
    """-> (decode seconds, audio seconds, shapes excluded) over the calls
    of ``shape_times`` ({batch shape: [(seconds, audio seconds)]}) that
    carry no first-call cost: the slowest call of each shape is dropped,
    and a shape decoded once is left out entirely."""
    steady_t = steady_audio = 0.0
    excluded = 0
    for calls in shape_times.values():
        if len(calls) == 1:
            excluded += 1
            continue
        drop = max(range(len(calls)), key=lambda i: calls[i][0])
        kept = [c for i, c in enumerate(calls) if i != drop]
        steady_t += sum(t for t, _ in kept)
        steady_audio += sum(a for _, a in kept)
    return steady_t, steady_audio, excluded


def main(recipe_path: str, expdir: str, device=None) -> str:
    device = resolve_device(device)
    recipe = Recipe(recipe_path)
    rconf = recipe.recognizer.section("recognizer")
    model, tgt_meta = model_from_recipe(recipe, expdir, rconf["features"], rconf["targets"])
    loader, _, _ = make_loader(
        recipe, expdir, rconf, batch_size=rconf.getint("batch_size", 16),
        num_buckets=rconf.getint("num_buckets", 2),
    )
    params = load_best_params(expdir, device)
    recognizer = build_recognizer(rconf, model)
    alphabet = tgt_meta["alphabet"]
    tokenizer = tgt_meta.get("tokenizer", "word")
    frame_shift = recipe.database.section(rconf["features"]).getfloat("winstep", 0.01)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    out_dir = os.path.join(expdir, "decoded")
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, "nbest.txt")
    # per-batch decode time and audio seconds by batch shape: the first
    # call of a shape (and of the process, which loads the kernels'
    # libraries) is dropped from the steady-state RTF
    shape_times: dict = {}
    audio_total = 0.0
    with open(out_path, "w") as f:
        for batch in loader.epoch(0, shuffle=False):
            sync()
            t0 = time.perf_counter()
            result = recognizer(params, batch.features, batch.feature_lengths)
            sync()  # the n-best is on the host; the device's queue is empty too
            dt = time.perf_counter() - t0
            audio_s = float(batch.feature_lengths[batch.example_mask].sum()) * frame_shift
            shape_times.setdefault(batch.features.shape, []).append((dt, audio_s))
            audio_total += audio_s
            for b, utt in enumerate(batch.utt_ids):
                if not batch.example_mask[b]:
                    continue
                for score, ids in result.nbest(b):
                    f.write(f"{utt} {score:.4f} {ids_to_text(ids, alphabet, tokenizer)}\n")
    steady_t, steady_audio, excluded = steady_rtf(shape_times)
    if steady_audio > 0:
        note = f", {excluded} single-call shapes excluded entirely" if excluded else ""
        print(f"[decode] steady-state RTF {steady_t / steady_audio:.5f} "
              f"({steady_audio:.0f}s audio, first calls excluded{note})")
    elif shape_times:
        print(f"[decode] no steady-state RTF: every batch shape was decoded exactly "
              f"once ({excluded} shapes)")
    print(f"[decode] wrote {out_path} ({audio_total:.0f}s audio)")
    return out_path
