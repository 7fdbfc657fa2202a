"""Byte-pair-encoding subword tokenization (train / encode / decode).

Beyond-parity: the reference's text processing stops at characters,
phones, and words; modern end-to-end ASR targets are subwords. This is
the classic BPE of Sennrich et al. ("Neural Machine Translation of Rare
Words with Subword Units"): train greedily merges the most frequent
adjacent symbol pair over a word-frequency table until the vocabulary
reaches the requested size; encoding applies the learned merges in rank
order. Word endings use the suffix-marker convention (the last
character of each word carries ``</w>``), so decoding is a plain join +
marker-to-space substitution.

Trained with the JAX package's ``run bpe``; consumed by the text
processor via ``tokenizer = bpe`` + ``bpe_model = <path>`` — the BPE
vocabulary then IS the recipe's alphabet. The port loads, encodes and
decodes (a copy of the JAX package's data/bpe.py without training).
"""

from __future__ import annotations

import json
from typing import Dict, Iterable, List, Tuple

EOW = "</w>"
UNK = "<unk>"


def _word_symbols(word: str) -> Tuple[str, ...]:
    return tuple(list(word[:-1]) + [word[-1] + EOW])


class BPEModel:
    """An ordered merge list + the resulting subword vocabulary."""

    def __init__(self, merges: List[Tuple[str, str]], vocab: List[str]):
        self.merges = [tuple(m) for m in merges]
        self.vocab = list(vocab)
        self.ranks: Dict[Tuple[str, str], int] = {
            pair: i for i, pair in enumerate(self.merges)
        }
        self._cache: Dict[str, List[str]] = {}

    # -- encoding ------------------------------------------------------------
    def encode_word(self, word: str) -> List[str]:
        if word in self._cache:
            return self._cache[word]
        syms = list(_word_symbols(word))
        while len(syms) > 1:
            best, best_rank = None, None
            for i, pair in enumerate(zip(syms, syms[1:])):
                r = self.ranks.get(pair)
                if r is not None and (best_rank is None or r < best_rank):
                    best, best_rank = i, r
            if best is None:
                break
            syms[best: best + 2] = [syms[best] + syms[best + 1]]
        self._cache[word] = syms
        return syms

    def encode(self, text: str) -> List[str]:
        out: List[str] = []
        for word in text.split():
            out.extend(self.encode_word(word))
        return out

    @staticmethod
    def decode(tokens: Iterable[str]) -> str:
        return (
            "".join(t for t in tokens if t != UNK)
            .replace(EOW, " ")
            .strip()
        )

    # -- persistence -----------------------------------------------------------
    @classmethod
    def load(cls, path: str) -> "BPEModel":
        with open(path) as f:
            d = json.load(f)
        return cls(d["merges"], d["vocab"])
