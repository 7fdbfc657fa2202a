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

Trained with ``cli bpe`` (scripts/bpe.py); consumed by the text
processor via ``tokenizer = bpe`` + ``bpe_model = <path>`` — the BPE
vocabulary then IS the recipe's alphabet. A copy of the JAX package's
data/bpe.py.
"""

from __future__ import annotations

import json
import os
from collections import Counter
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

    # -- training ----------------------------------------------------------
    @classmethod
    def train(
        cls, texts: Iterable[str], vocab_size: int
    ) -> "BPEModel":
        """Learn merges until the vocab reaches ``vocab_size`` (base
        characters + merged units + <unk>) or no pair repeats."""
        words = Counter()
        for text in texts:
            words.update(text.split())
        if not words:
            raise ValueError("cannot train BPE on an empty corpus")
        table: Dict[Tuple[str, ...], int] = {
            _word_symbols(w): c for w, c in words.items()
        }
        base = sorted({s for syms in table for s in syms})
        merges: List[Tuple[str, str]] = []
        merged_units: List[str] = []
        while len(base) + len(merged_units) + 1 < vocab_size:
            pairs: Counter = Counter()
            for syms, c in table.items():
                for a, b in zip(syms, syms[1:]):
                    pairs[(a, b)] += c
            if not pairs:
                break
            (a, b), count = max(
                pairs.items(), key=lambda kv: (kv[1], kv[0])
            )
            if count < 2:
                break  # merging singletons only memorizes the corpus
            merges.append((a, b))
            merged_units.append(a + b)
            new_table: Dict[Tuple[str, ...], int] = {}
            for syms, c in table.items():
                out: List[str] = []
                i = 0
                while i < len(syms):
                    if (
                        i + 1 < len(syms)
                        and syms[i] == a
                        and syms[i + 1] == b
                    ):
                        out.append(a + b)
                        i += 2
                    else:
                        out.append(syms[i])
                        i += 1
                new_table[tuple(out)] = new_table.get(tuple(out), 0) + c
            table = new_table
        vocab = base + merged_units + [UNK]
        return cls(merges, vocab)

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
    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(
                {"merges": [list(m) for m in self.merges],
                 "vocab": self.vocab},
                f,
            )

    @classmethod
    def load(cls, path: str) -> "BPEModel":
        with open(path) as f:
            d = json.load(f)
        return cls(d["merges"], d["vocab"])
