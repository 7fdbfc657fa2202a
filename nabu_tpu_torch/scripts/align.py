"""`align`: CTC forced alignment of a dataset against its targets.

Port of the JAX package's ``scripts/align.py``: the model's CTC head over
a features + targets dataset pair (``recognizer.cfg``'s by default), the
best checkpoint's weights, on the GPU unless ``device="cpu"``; the
alignment is ``decoding.align.ctc_forced_align`` over the head's f32
log-probs. Writes CTM lines

    <utt> 1 <start_seconds> <duration_seconds> <token>

to ``<expdir>/aligned/align.ctm``, the seconds of an output frame being
winstep x the utterance's feature frames / its logit frames (the
encoder's actual subsampling).
"""

from __future__ import annotations

import os

import torch

from nabu_tpu_torch.config import Conf, Recipe
from nabu_tpu_torch.data.pipeline import batch_to_arrays, batch_to_device
from nabu_tpu_torch.decoding.align import ctc_forced_align, segments_from_frames
from nabu_tpu_torch.device import resolve_device
from nabu_tpu_torch.scripts.common import make_loader, model_from_recipe
from nabu_tpu_torch.scripts.test import load_best_params


def ctc_head(model, head=None) -> str:
    """``head``, else the first decoder with a ``blank_id``."""
    head = head or next((name for name, dec in model.decoders.items()
                         if hasattr(dec, "blank_id")), None)
    if head is None:
        raise ValueError("forced alignment needs a CTC head (a decoder with a blank_id); "
                         "this model has none")
    return head


def head_logprobs(model, params, head: str, batch: dict):
    """One batch on the parameters' device -> (the head's f32 log-probs
    [B, T', V], logit lengths [B])."""
    with torch.no_grad():
        logits, logit_lengths = model.apply(params, batch["features"], batch["feature_lengths"],
                                            heads=(head,))[head]
    return torch.log_softmax(logits.to(torch.float32), dim=-1), logit_lengths


def main(recipe_path: str, expdir: str, features: str = None, targets: str = None,
         head: str = None, device=None) -> str:
    device = resolve_device(device)
    recipe = Recipe(recipe_path)
    rconf = recipe.recognizer.section("recognizer")
    features = features or rconf["features"]
    targets = targets or rconf["targets"]
    model, tgt_meta = model_from_recipe(recipe, expdir, features, targets)
    head = ctc_head(model, head)
    blank_id = model.decoders[head].blank_id
    winstep = recipe.database.section(features).getfloat("winstep", 0.01)
    loader, _, _ = make_loader(
        recipe, expdir, Conf({"features": features, "targets": targets}),
        batch_size=rconf.getint("batch_size", 16), num_buckets=rconf.getint("num_buckets", 1),
    )
    params = load_best_params(expdir, device)
    alphabet = tgt_meta["alphabet"]

    out_dir = os.path.join(expdir, "aligned")
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, "align.ctm")
    n = 0
    with open(out_path, "w") as f:
        for batch in loader.epoch(0, shuffle=False):
            arrays = batch_to_device(batch_to_arrays(batch), device, model.compute_dtype)
            logprobs, logit_lengths = head_logprobs(model, params, head, arrays)
            frames, _ = ctc_forced_align(logprobs, logit_lengths, arrays["targets"],
                                         arrays["target_lengths"], blank_id)
            frames, logit_lengths = frames.cpu().numpy(), logit_lengths.cpu().numpy()
            for b, utt in enumerate(batch.utt_ids):
                if not batch.example_mask[b]:
                    continue
                # seconds an output frame: winstep x the actual subsampling
                spf = winstep * float(batch.feature_lengths[b]) / max(int(logit_lengths[b]), 1)
                for lab, t0, t1 in segments_from_frames(frames[b], logit_lengths[b], blank_id):
                    f.write(f"{utt} 1 {t0 * spf:.3f} {(t1 - t0) * spf:.3f} {alphabet[lab]}\n")
                n += 1
    print(f"[align] wrote {out_path} ({n} utterances)")
    return out_path
