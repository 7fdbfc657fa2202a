"""`recognize`: decode audio files straight off the disk (no data prep).

Port of the JAX package's ``scripts/recognize.py``: takes wav/SPHERE
paths (or one Kaldi-style ``.scp`` datafile) and prints ``utt_id
hypothesis`` lines from the best-validated checkpoint, with the recipe's
frontend and recognizer. The decoding is ``serving.ExportedModel``'s,
over the parts ``export`` would freeze. Runs on the GPU unless
``device="cpu"``.
"""

from __future__ import annotations

import os
from typing import List, Tuple

from nabu_tpu_torch.data.processors import read_datafile
from nabu_tpu_torch.serving import ExportedModel


def main(recipe_path: str, expdir: str, audio: List[str], batch_size: int = 8,
         device=None) -> List[Tuple[str, str]]:
    """``audio``: wav/sph paths, or a single ``*.scp`` datafile path.
    Returns (and prints) [(utt_id, hypothesis text)]."""
    model = ExportedModel.from_recipe(recipe_path, expdir, batch_size, device)
    if len(audio) == 1 and audio[0].endswith(".scp"):
        entries = read_datafile(audio[0])
    else:
        entries = [(os.path.splitext(os.path.basename(p))[0], p) for p in audio]
    texts = model.recognize_files([value for _, value in entries])
    results = list(zip([utt for utt, _ in entries], texts))
    for utt, text in results:
        print(f"{utt} {text}")
    return results
