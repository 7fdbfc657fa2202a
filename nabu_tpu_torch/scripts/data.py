"""`data`: prepare every dataset section of database.conf (a copy of the
JAX package's scripts/data.py).

For each section: build its processor, process every datafile line
(with speed perturbation copies where the section asks), write shards +
metadata with the CMVN statistics. A process pool splits the
per-utterance loop across CPUs when ``num_workers > 1``: one pool for
all the sections (each worker builds a section's processor at its first
utterance of it), since a spawned worker's start, which imports torch,
costs more than a small section's work.
"""

from __future__ import annotations

import contextlib
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from typing import Tuple

import numpy as np

from nabu_tpu_torch.config import Recipe
from nabu_tpu_torch.data.processors import make_processor, read_datafile
from nabu_tpu_torch.data.storage import ShardWriter
from nabu_tpu_torch.scripts.common import data_dir

_SECTIONS: dict = {}  # a worker's sections' values, then their processors


def _init_worker(sections: dict):
    _SECTIONS.update(sections)


def _process_one(task: Tuple[str, Tuple[str, str, float]]):
    name, (utt, value, speed) = task
    if isinstance(_SECTIONS[name], dict):
        from nabu_tpu_torch.config import Conf

        _SECTIONS[name] = make_processor(Conf(_SECTIONS[name]))
    return utt, _SECTIONS[name].process(value, speed=speed)


def _expand_speed(entries, section):
    """3-way speed perturbation (``speed_perturb = 0.9 1.0 1.1``):
    replicate every entry per factor, suffixing ids with ``#sp<f>``
    (factor 1.0 keeps the plain id). Feature AND target sections of a
    split must carry the same factors so ids stay paired."""
    factors = [
        float(f) for f in section.getlist("speed_perturb", ["1.0"])
    ]
    out = []
    for utt, value in entries:
        for f in factors:
            uid = utt if f == 1.0 else f"{utt}#sp{f:g}"
            out.append((uid, value, f))
    return out


class CMVNAccumulator:
    """Corpus- (and optionally speaker-) level feature mean/variance
    statistics, accumulated over the prep hot loop (reference anchor:
    CMVN stats at prep time, SURVEY.md §2 "Dynamic features" row —
    the reference computes normalization stats when features are
    prepared and applies them when data is loaded).

    Speaker ids derive from utterance ids when the section sets
    ``cmvn_speaker_separator`` (speaker = id up to the first
    separator, the usual <spk><sep><utt> corpus convention).
    """

    def __init__(self, speaker_separator: str | None = None):
        self.sep = speaker_separator
        self._stats: dict = {}  # key -> [sum, sumsq, frames]

    def add(self, utt_id: str, arr: np.ndarray) -> None:
        if arr.ndim != 2 or not np.issubdtype(arr.dtype, np.floating):
            return
        s = arr.sum(axis=0, dtype=np.float64)
        ss = np.square(arr.astype(np.float64)).sum(axis=0)
        n = arr.shape[0]
        keys = ["__global__"]
        if self.sep:
            # speed-perturbed copies ("utt#sp0.9") share the speaker
            keys.append(utt_id.split("#")[0].split(self.sep)[0])
        for key in keys:
            slot = self._stats.get(key)
            if slot is None:
                self._stats[key] = [s.copy(), ss.copy(), n]
            else:
                slot[0] += s
                slot[1] += ss
                slot[2] += n

    @staticmethod
    def _mean_std(slot):
        s, ss, n = slot
        mean = s / max(n, 1)
        var = np.maximum(ss / max(n, 1) - mean * mean, 1e-20)
        return mean, np.sqrt(var)

    def metadata(self) -> dict:
        if "__global__" not in self._stats:
            return {}
        gm, gs = self._mean_std(self._stats["__global__"])
        out = {
            "mean": gm.tolist(),
            "std": gs.tolist(),
            "frames": int(self._stats["__global__"][2]),
        }
        speakers = {}
        for key, slot in self._stats.items():
            if key == "__global__":
                continue
            m, s = self._mean_std(slot)
            speakers[key] = {
                "mean": m.tolist(), "std": s.tolist(),
                "frames": int(slot[2]),
            }
        if speakers:
            out["speakers"] = speakers
        meta = {"cmvn": out}
        if self.sep:
            # loaders re-derive speaker keys from utt ids with this
            meta["cmvn_speaker_separator"] = self.sep
        return meta


def prepare_section(
    recipe: Recipe, expdir: str, name: str, pool: ProcessPoolExecutor | None = None
) -> dict:
    """One section into shards: in this process, or over ``pool`` (made by
    ``main`` with every section's values)."""
    section = recipe.database.section(name)
    out_dir = data_dir(expdir, section, name)
    entries = _expand_speed(read_datafile(section["datafile"]), section)
    processor = make_processor(section)
    writer = ShardWriter(out_dir)
    cmvn = CMVNAccumulator(section.get("cmvn_speaker_separator"))
    if pool is not None:
        tasks = [(name, entry) for entry in entries]
        for utt, arr in pool.map(_process_one, tasks, chunksize=16):
            arr = np.asarray(arr)
            cmvn.add(utt, arr)
            writer.write(utt, arr)
        # metadata from writer stats; processor-side metadata (alphabet
        # etc.) comes from a fresh processor instance's static config
        extra = processor.metadata()
    else:
        for utt, value, speed in entries:
            arr = np.asarray(processor.process(value, speed=speed))
            cmvn.add(utt, arr)
            writer.write(utt, arr)
        extra = processor.metadata()
    # stats are always recorded (cheap); global_cmvn = true on the
    # section makes the loaders/serving APPLY them
    extra = dict(extra)
    extra.update(cmvn.metadata())
    if section.getbool("global_cmvn", False):
        if "cmvn" not in extra:
            raise ValueError(
                f"[{name}] global_cmvn = true but the section produces "
                "no float feature matrices to accumulate stats over"
            )
        extra["apply_global_cmvn"] = True
    return writer.close(extra)


def main(recipe_path: str, expdir: str, num_workers: int = 0) -> None:
    recipe = Recipe(recipe_path)
    os.makedirs(expdir, exist_ok=True)
    names = recipe.database.sections()
    with contextlib.ExitStack() as stack:
        pool = None
        if num_workers > 1:
            # spawn, not fork: the parent has imported torch and its threads
            pool = stack.enter_context(ProcessPoolExecutor(
                max_workers=num_workers,
                mp_context=multiprocessing.get_context("spawn"),
                initializer=_init_worker,
                initargs=({n: recipe.database.section(n).as_dict() for n in names},),
            ))
        for name in names:
            meta = prepare_section(recipe, expdir, name, pool)
            print(
                f"[data] {name}: {meta['num_utts']} utts, dim={meta.get('dim')}, "
                f"max_length={meta['max_length']}"
            )
