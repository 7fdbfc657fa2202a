"""`rescore`: LM-rescore a decoded n-best list.

Port of the JAX package's ``scripts/rescore.py``: reads
``<expdir>/decoded/nbest.txt`` (written by ``decode``), re-ranks each
utterance's hypotheses by ``am + lm_weight * lm + length_bonus * len``
and writes ``decoded/rescored.txt`` in the same format. An n-gram LM
scores on the host; a neural LM (``lm_rnn.npz``) on ``device`` (the GPU
unless "cpu"), in groups of rows the LSTM walk holds.
"""

from __future__ import annotations

import os

from nabu_tpu_torch.config import Recipe
from nabu_tpu_torch.data.processors import TextProcessor, ids_to_text
from nabu_tpu_torch.decoding.lm import load_lm, rescore_nbest


def _text_to_ids(proc: TextProcessor, tokenizer: str, text: str):
    """Invert ids_to_text losslessly.

    The char tokenizer's output joins tokens with no separator, so a
    multi-char alphabet token (``<unk>``, ``<space>`` rendered as a
    space) is recovered by greedy longest-match over the alphabet:
    re-running the char TextProcessor would split ``<unk>`` into five
    character tokens and corrupt the LM score."""
    if tokenizer != "char":
        return list(proc.process(text))
    literals = sorted(
        ((" " if t == "<space>" else t, i)
         for i, t in enumerate(proc.alphabet)),
        key=lambda p: -len(p[0]),
    )
    ids, i = [], 0
    while i < len(text):
        for lit, tid in literals:
            if lit and text.startswith(lit, i):
                ids.append(tid)
                i += len(lit)
                break
        else:
            i += 1  # character outside the alphabet: drop
    return ids


def main(recipe_path: str, expdir: str, lm_path: str | None = None, lm_weight: float = 0.3,
         length_bonus: float = 0.0, device=None) -> str:
    recipe = Recipe(recipe_path)
    rconf = recipe.recognizer.section("recognizer")
    tconf = recipe.database.section(rconf["targets"])
    proc = TextProcessor(tconf)
    tokenizer = tconf.get("tokenizer", "word")

    if lm_path is None:
        lm_path = rconf.get("lm_path")
    if lm_path is None:
        for name in ("lm_3gram.npz", "lm_rnn.npz"):
            cand = os.path.join(expdir, "lm", name)
            if os.path.exists(cand):
                lm_path = cand
                break
        else:
            lm_path = os.path.join(expdir, "lm", "lm_3gram.npz")
    lm = load_lm(lm_path, device)  # n-gram or neural, by file contents
    if lm.vocab != proc.num_labels + 1:
        raise ValueError(
            f"LM vocab {lm.vocab} != recipe alphabet "
            f"{proc.num_labels} + 1"
        )

    nbest_path = os.path.join(expdir, "decoded", "nbest.txt")
    entries = []
    with open(nbest_path) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line.strip():
                continue
            utt, score, text = (line.split(" ", 2) + [""])[:3]
            entries.append((utt, float(score), _text_to_ids(proc, tokenizer, text)))

    rescored = rescore_nbest(entries, lm, lm_weight, length_bonus)
    out_path = os.path.join(expdir, "decoded", "rescored.txt")
    with open(out_path, "w") as f:
        for utt, score, ids in rescored:
            text = ids_to_text(ids, proc.alphabet, tokenizer)
            f.write(f"{utt} {score:.4f} {text}\n")
    print(f"[rescore] wrote {out_path} (lm_weight={lm_weight})")
    return out_path
