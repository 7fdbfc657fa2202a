"""`lm`: train a language model from a recipe's transcriptions.

Port of the JAX package's ``scripts/lm.py``. The LM is trained over the
same alphabet ids as the acoustic model (the recipe's targets
TextProcessor), so the saved ``.npz`` plugs straight into beam-search
shallow fusion (``recognizer.cfg``: ``lm_path`` / ``lm_weight``) and
``rescore``. ``lm_type = "ngram"`` trains the Witten-Bell n-gram of
``decoding/lm.py`` into ``<expdir>/lm/lm_{order}gram.npz`` (host work, no
device); ``lm_type = "rnn"`` trains the LSTM LM of
``decoding/neural_lm.py`` on ``device`` (the GPU unless "cpu") into
``<expdir>/lm/lm_rnn.npz``, with the JAX package's hyperparameters and
defaults.
"""

from __future__ import annotations

import math
import os

from nabu_tpu_torch.config import Recipe
from nabu_tpu_torch.data.processors import TextProcessor, read_datafile
from nabu_tpu_torch.decoding.lm import NgramLM


def main(recipe_path: str, expdir: str, order: int = 3, targets: str = "traintargets",
         lm_type: str = "ngram", num_units: int = 256, num_layers: int = 1,
         embed_dim: int = 64, num_steps: int = 500, batch_size: int = 64,
         learning_rate: float = 1e-3, device=None) -> str:
    if lm_type not in ("ngram", "rnn"):
        raise ValueError(f"unknown LM type {lm_type!r} (ngram|rnn)")
    recipe = Recipe(recipe_path)
    conf = recipe.database.section(targets)
    proc = TextProcessor(conf)
    entries = read_datafile(conf.get("datafile"))
    sequences = [list(proc.process(value)) for _, value in entries]
    vocab = proc.num_labels + 1  # boundary symbol shares the eos id

    if lm_type == "rnn":
        from nabu_tpu_torch.decoding.neural_lm import RnnLM

        lm = RnnLM.train(sequences, vocab, num_units=num_units, num_layers=num_layers,
                         embed_dim=embed_dim, num_steps=num_steps, batch_size=batch_size,
                         learning_rate=learning_rate, device=device)
        path = os.path.join(expdir, "lm", "lm_rnn.npz")
        lm.save(path)
        ppl = lm.perplexity(sequences)
        print(
            f"[lm] rnn ({num_layers}x{num_units}) over {vocab} ids from "
            f"{len(sequences)} utterances -> {path} (train ppl {ppl:.2f})"
        )
        return path

    lm = NgramLM.train(sequences, vocab, order)
    path = os.path.join(expdir, "lm", f"lm_{order}gram.npz")
    lm.save(path)

    # training-set perplexity as a sanity number (includes </s> events)
    total_lp, total_events = 0.0, 0
    for seq in sequences:
        total_lp += lm.logprob(seq)
        total_events += len(seq) + 1
    ppl = math.exp(-total_lp / max(total_events, 1))
    print(
        f"[lm] {order}-gram over {vocab} ids from {len(sequences)} "
        f"utterances -> {path} (train ppl {ppl:.2f})"
    )
    return path
