"""`bpe`: train a subword (BPE) vocabulary from transcriptions.

Port of the JAX package's ``scripts/bpe.py`` (host work): learns merges
from a targets datafile, after the section's normalizer, and writes the
model JSON (default ``<expdir>/bpe/bpe.json``). Point the targets
sections at it with ``tokenizer = bpe`` + ``bpe_model = <path>`` and the
BPE vocabulary becomes the recipe's alphabet.
"""

from __future__ import annotations

import os

from nabu_tpu_torch.config import Recipe
from nabu_tpu_torch.data.bpe import BPEModel
from nabu_tpu_torch.data.processors import read_datafile
from nabu_tpu_torch.registry import TARGET_NORMALIZERS


def main(recipe_path: str, expdir: str, vocab_size: int = 500,
         targets: str = "traintargets", out: str | None = None) -> str:
    recipe = Recipe(recipe_path)
    conf = recipe.database.section(targets)
    normalizer = TARGET_NORMALIZERS.get(conf.get("normalizer", "none"))
    texts = [normalizer(value) for _, value in read_datafile(conf.get("datafile"))]

    model = BPEModel.train(texts, vocab_size)
    path = out or os.path.join(expdir, "bpe", "bpe.json")
    model.save(path)

    tokens = sum(len(model.encode(t)) for t in texts)
    words = sum(len(t.split()) for t in texts)
    print(f"[bpe] {len(model.vocab)} subwords ({len(model.merges)} merges) "
          f"from {len(texts)} utterances -> {path} "
          f"({tokens / max(words, 1):.2f} tokens/word). Use with:\n"
          f"  tokenizer = bpe\n  bpe_model = {path}")
    return path
