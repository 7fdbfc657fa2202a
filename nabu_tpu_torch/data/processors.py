"""Dataset processors: audio -> features, text -> integer targets (a copy
of the JAX package's data/processors.py).

A Processor is built from a ``database.conf`` section and maps one
datafile value to an array; ``TextProcessor.ids_to_text`` turns decoded
label ids back into text.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from nabu_tpu_torch.config import Conf
from nabu_tpu_torch.data import audio_io
from nabu_tpu_torch.features import make_feature_computer
from nabu_tpu_torch.registry import PROCESSORS, TARGET_NORMALIZERS


# --------------------------------------------------------------------------
# target normalizers (reference: nabu/processing/target_normalizers/)
# --------------------------------------------------------------------------

@TARGET_NORMALIZERS.register("none")
def normalize_none(text: str) -> str:
    return text.strip()


@TARGET_NORMALIZERS.register("lower")
def normalize_lower(text: str) -> str:
    return text.strip().lower()


# TIMIT 61 -> 39 phone folding (Lee & Hon 1989), the standard evaluation
# mapping used by TIMIT recipes. Phones mapped to None are deleted (glottal
# stop q).
_TIMIT_FOLD: Dict[str, Optional[str]] = {
    "ao": "aa", "ax": "ah", "ax-h": "ah", "axr": "er", "hv": "hh",
    "ix": "ih", "el": "l", "em": "m", "en": "n", "nx": "n",
    "eng": "ng", "zh": "sh", "ux": "uw", "q": None,
    "pcl": "sil", "tcl": "sil", "kcl": "sil", "bcl": "sil",
    "dcl": "sil", "gcl": "sil", "h#": "sil", "pau": "sil", "epi": "sil",
}


@TARGET_NORMALIZERS.register("timit_39")
def normalize_timit39(text: str) -> str:
    out = []
    for phone in text.strip().lower().split():
        folded = _TIMIT_FOLD.get(phone, phone)
        if folded is not None:
            out.append(folded)
    return " ".join(out)


@TARGET_NORMALIZERS.register("aurora4")
@TARGET_NORMALIZERS.register("character")
def normalize_character(text: str) -> str:
    """Uppercase, strip non-alphabetic except space/apostrophe (WSJ-ish)."""
    text = text.strip().upper()
    return "".join(c for c in text if c.isalpha() or c in " '")


def resample_speed(signal: np.ndarray, factor: float) -> np.ndarray:
    """Sox-style ``speed`` perturbation: play the signal ``factor``
    times faster by linear-interpolation resampling (duration scales by
    1/factor, pitch by factor — the standard Kaldi/ESPnet 3-way
    augmentation)."""
    n = max(int(round(len(signal) / factor)), 1)
    idx = np.arange(n, dtype=np.float64) * factor
    return np.interp(
        idx, np.arange(len(signal), dtype=np.float64), signal
    ).astype(signal.dtype if signal.dtype.kind == "f" else np.float64)


# --------------------------------------------------------------------------
# processors
# --------------------------------------------------------------------------

class Processor:
    """Base processor: one datafile line -> array + metadata tracking.

    ``process`` takes an optional ``speed`` factor (3-way speed
    perturbation, ``speed_perturb = 0.9 1.0 1.1`` in the section —
    data.py replicates entries per factor). Only audio reacts to it;
    target processors return identical labels for every copy.
    """

    def __init__(self, conf: Conf):
        self.conf = conf
        self.max_length = 0
        self.dim: Optional[int] = None

    def process(self, line_value: str, speed: float = 1.0):
        raise NotImplementedError

    def metadata(self) -> Dict:
        # dim / max_length / histogram stats come from the ShardWriter,
        # which sees every array even under multiprocess data prep
        return {}


@PROCESSORS.register("audio")
@PROCESSORS.register("audio_processor")
class AudioProcessor(Processor):
    """Audio path/pipe -> feature matrix [T, dim] float32."""

    def __init__(self, conf: Conf):
        super().__init__(conf)
        self.computer = make_feature_computer(conf)

    def process(self, line_value: str, speed: float = 1.0) -> np.ndarray:
        signal, rate = audio_io.load_audio(line_value)
        if speed != 1.0:
            signal = resample_speed(signal, speed)
        feat = self.computer(signal, rate)
        self.max_length = max(self.max_length, feat.shape[0])
        self.dim = feat.shape[1]
        return feat

    def metadata(self) -> Dict:
        meta = super().metadata()
        meta["type"] = "audio"
        return meta


@PROCESSORS.register("text")
@PROCESSORS.register("text_processor")
class TextProcessor(Processor):
    """Transcription -> int32 label ids via a config alphabet.

    conf keys: ``alphabet`` (space-separated tokens), ``normalizer``
    (registry name), ``tokenizer`` = char|word|bpe (how to split the
    normalized text into alphabet tokens). Unknown tokens map to the
    index of '<unk>' when present, else are dropped.

    ``tokenizer = bpe`` additionally needs ``bpe_model`` (a JSON from
    ``run bpe``); the BPE vocabulary then IS the alphabet, so the
    ``alphabet`` key may be omitted.
    """

    def __init__(self, conf: Conf):
        super().__init__(conf)
        self.tokenizer = conf.get("tokenizer", "word")
        self.bpe = None
        if self.tokenizer == "bpe":
            from nabu_tpu_torch.data.bpe import BPEModel

            path = conf.get("bpe_model")
            if not path:
                raise ValueError("tokenizer = bpe requires 'bpe_model'")
            self.bpe = BPEModel.load(path)
            self.alphabet = list(self.bpe.vocab)
        else:
            self.alphabet: List[str] = conf.getlist("alphabet")
        if not self.alphabet:
            raise ValueError("text processor requires an 'alphabet'")
        self.normalizer = TARGET_NORMALIZERS.get(
            conf.get("normalizer", "none")
        )
        self.token_to_id = {tok: i for i, tok in enumerate(self.alphabet)}
        self.unk_id = self.token_to_id.get("<unk>")
        self.dim = 1
        self.num_dropped = 0

    @property
    def num_labels(self) -> int:
        return len(self.alphabet)

    def tokenize(self, text: str) -> List[str]:
        if self.tokenizer == "bpe":
            return self.bpe.encode(text)
        if self.tokenizer == "char":
            # represent space as the token '<space>' when in the alphabet
            toks = []
            for ch in text:
                if ch == " " and "<space>" in self.token_to_id:
                    toks.append("<space>")
                else:
                    toks.append(ch)
            return toks
        return text.split()

    def process(self, line_value: str, speed: float = 1.0) -> np.ndarray:
        # speed is ignored: every perturbed copy keeps the same labels
        text = self.normalizer(line_value)
        ids = []
        for tok in self.tokenize(text):
            if tok in self.token_to_id:
                ids.append(self.token_to_id[tok])
            elif self.unk_id is not None:
                ids.append(self.unk_id)
            else:
                self.num_dropped += 1
        arr = np.array(ids, dtype=np.int32)
        self.max_length = max(self.max_length, len(arr))
        return arr

    def ids_to_text(self, ids) -> str:
        return ids_to_text(ids, self.alphabet, self.tokenizer)

    def metadata(self) -> Dict:
        meta = super().metadata()
        meta.update(
            type="text",
            alphabet=self.alphabet,
            num_labels=self.num_labels,
            tokenizer=self.tokenizer,
        )
        return meta


def ids_to_text(ids, alphabet, tokenizer: str = "word") -> str:
    """Canonical label-id detokenization (the ONE copy every consumer
    delegates to: TextProcessor.ids_to_text, scripts.common)."""
    toks = [alphabet[i] for i in ids if 0 <= i < len(alphabet)]
    if tokenizer == "bpe":
        from nabu_tpu_torch.data.bpe import BPEModel

        return BPEModel.decode(toks)
    if tokenizer == "char":
        return "".join(" " if t == "<space>" else t for t in toks)
    return " ".join(toks)


def make_processor(conf: Conf) -> Processor:
    """Factory by conf['processor'] (reference: processor_factory.py)."""
    return PROCESSORS.build(conf.get("processor", "audio"), conf)


def read_datafile(path: str) -> List:
    """Parse a Kaldi-style datafile: ``utt_id value...`` per line."""
    entries = []
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line.strip():
                continue
            utt, _, value = line.partition(" ")
            entries.append((utt, value))
    return entries
