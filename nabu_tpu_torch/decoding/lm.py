"""N-gram language model: Witten-Bell interpolation, dense-table
shallow fusion, n-best rescoring.

Port of the JAX package's ``decoding/lm.py``:

- ``NgramLM.train`` builds a Witten-Bell interpolated n-gram model from
  integer label sequences (``cli lm`` trains one from a recipe's
  training transcriptions with the same alphabet ids as the acoustic
  model). It is numpy, the JAX package's code as it is, and saves the
  same ``.npz`` layout, so each package reads the other's LM file.
- ``DenseLM`` is the device view: the full conditional table
  ``logprobs [V^(order-1), V]`` is one tensor on an explicit device, the
  LM state of a hypothesis is one integer context index, and a step is
  one integer update and one gather, on the table's device. ``to``
  gives the same LM on another device (one copy a device).
- ``state_where`` selects between two LM states (a tensor, or a tuple or
  dict of tensors) per hypothesis.
- ``rescore_nbest`` re-ranks a decoded n-best list on the host with
  ``am_score + lm_weight * lm_score + length_bonus * len``.

Conventions: LM vocab = num_labels + 1; the last id doubles as the
sentence boundary (<s> as context, </s> as an event), the id the
attention Speller uses for <sos> / <eos>, so fusion needs no id remap.
CTC and transducer fusion never query the boundary column for emissions.

Witten-Bell (interpolated): p_k(w|h) = (c(h,w) + T(h) p_{k-1}(w|h')) /
(N(h) + T(h)) with T(h) = distinct continuations of h, h' = h minus its
oldest token; the unigram base interpolates with the uniform 1/V.

``load_lm`` / ``load_dense_lm`` read either kind of LM file by its
contents: a ``kind = rnn`` file is the neural LM of ``neural_lm.py``,
whose fusion state is a dict of tensors (the beams gather and select it
leaf by leaf).
"""

from __future__ import annotations

import os
from collections import defaultdict
from typing import List, Sequence, Tuple

import numpy as np
import torch


class NgramLM:
    """Host-side n-gram LM: dense conditional table + train/save/load."""

    def __init__(self, table: np.ndarray, order: int, vocab: int):
        assert table.shape == (vocab ** (order - 1), vocab)
        self.table = table.astype(np.float32)  # logprobs [S, V]
        self.order = int(order)
        self.vocab = int(vocab)
        self.boundary = vocab - 1

    # -- training ----------------------------------------------------------
    @classmethod
    def train(
        cls, sequences: Sequence[Sequence[int]], vocab: int, order: int = 3
    ) -> "NgramLM":
        """``sequences`` hold label ids in [0, vocab-1); id vocab-1 is
        reserved for the sentence boundary."""
        if order < 1:
            raise ValueError("order must be >= 1")
        if not sequences:
            raise ValueError(
                "cannot train an LM on an empty corpus (no sequences)"
            )
        V = vocab
        b = V - 1

        # unigram level: Witten-Bell against the uniform distribution
        c1 = np.zeros(V, np.float64)
        for seq in sequences:
            for t in seq:
                if not 0 <= int(t) < V - 1:
                    raise ValueError(f"label id {t} out of range")
                c1[int(t)] += 1
            c1[b] += 1  # </s> event per sentence
        N1, T1 = c1.sum(), float((c1 > 0).sum())
        prev = (c1 + T1 / V) / (N1 + T1)  # [V], sums to 1

        for k in range(2, order + 1):
            S = V ** (k - 1)
            # context index: oldest token is the most-significant digit,
            # so dropping it (backoff) = idx mod V^(k-2)
            table = np.tile(prev.reshape(-1, V), (V, 1))
            counts: dict = defaultdict(lambda: np.zeros(V, np.float64))
            for seq in sequences:
                stream = [b] * (k - 1) + [int(t) for t in seq] + [b]
                idx = 0
                for j in range(k - 1):
                    idx = idx * V + stream[j]
                for j in range(k - 1, len(stream)):
                    tok = stream[j]
                    counts[idx][tok] += 1
                    idx = (idx % (S // V)) * V + tok if S > V else tok
            for idx, cvec in counts.items():
                N, T = cvec.sum(), float((cvec > 0).sum())
                backoff = table[idx]  # pre-filled with p_{k-1}(·|h')
                table[idx] = (cvec + T * backoff) / (N + T)
            prev = table

        return cls(np.log(prev.reshape(V ** (order - 1), V)), order, V)

    # -- persistence ---------------------------------------------------------
    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        np.savez(path, table=self.table, order=self.order, vocab=self.vocab)

    @classmethod
    def load(cls, path: str) -> "NgramLM":
        with np.load(path) as z:
            return cls(z["table"], int(z["order"]), int(z["vocab"]))

    # -- host-side scoring (rescoring) ---------------------------------------
    def logprob(self, seq: Sequence[int], include_eos: bool = True) -> float:
        V, S = self.vocab, self.vocab ** (self.order - 1)
        idx = self._boundary_state()
        total = 0.0
        events = list(int(t) for t in seq)
        if include_eos:
            events.append(self.boundary)
        for tok in events:
            total += float(self.table[idx, tok])
            idx = (idx % max(S // V, 1)) * V + tok if S > 1 else 0
        return total

    def _boundary_state(self) -> int:
        idx = 0
        for _ in range(self.order - 1):
            idx = idx * self.vocab + self.boundary
        return idx

    def dense(self, device) -> "DenseLM":
        """The table as a tensor on ``device``."""
        return DenseLM(
            torch.as_tensor(self.table, device=device), self.order, self.vocab,
            self._boundary_state(),
        )


class DenseLM:
    """Device view of an n-gram LM used inside the beam searches: the
    state of a hypothesis is one integer context index."""

    def __init__(self, table: torch.Tensor, order: int, vocab: int, boundary_state: int):
        self.table = table  # [S, V] logprobs
        self.order = order
        self.vocab = vocab
        self.boundary_state = boundary_state
        self.num_states = table.shape[0]
        self._copies = {table.device: self}

    def to(self, device) -> "DenseLM":
        """This LM with its table on ``device`` (made once a device)."""
        device = torch.empty(0, device=device).device  # "cuda" -> "cuda:0"
        if device not in self._copies:
            copy = DenseLM(self.table.to(device), self.order, self.vocab,
                           self.boundary_state)
            copy._copies = self._copies
            self._copies[device] = copy
        return self._copies[device]

    def init_state(self, shape: Tuple[int, ...], dtype=torch.int64) -> torch.Tensor:
        """Contexts of ``shape`` (int64 or int32) at the sentence boundary."""
        return torch.full(shape, self.boundary_state, dtype=dtype, device=self.table.device)

    def step(self, state: torch.Tensor, token: torch.Tensor) -> torch.Tensor:
        """Shift ``token`` into the context window (vectorized)."""
        if self.order == 1:
            return state
        keep = self.num_states // self.vocab  # V^(order-2)
        return (state % keep) * self.vocab + token.to(state.dtype)

    def logprobs(self, state: torch.Tensor) -> torch.Tensor:
        """Gather conditional logprob rows: state [...] -> [..., V]."""
        return self.table[state.to(torch.int64)]


def state_where(cond: torch.Tensor, a, b):
    """Per-leaf ``where`` over an LM state (a tensor, or a tuple / list /
    dict of them): ``a`` where ``cond`` (shaped like the beam, e.g.
    [B, W]) else ``b``; the condition broadcasts over each leaf's
    trailing state dims."""
    if isinstance(a, dict):
        return {k: state_where(cond, a[k], b[k]) for k in a}
    if isinstance(a, (tuple, list)):
        return type(a)(state_where(cond, x, y) for x, y in zip(a, b))
    return torch.where(cond.reshape(cond.shape + (1,) * (a.dim() - cond.dim())), a, b)


def load_lm(path: str, device=None):
    """The LM of a file, by its contents: an ``NgramLM`` (host numpy;
    ``device`` unused) or a neural ``RnnLM`` on ``device`` (the GPU unless
    "cpu")."""
    with np.load(path) as z:
        kind = str(z["kind"]) if "kind" in z.files else "ngram"
    if kind == "rnn":
        from nabu_tpu_torch.decoding.neural_lm import RnnLM

        return RnnLM.load(path, device)
    return NgramLM.load(path)


def load_dense_lm(path: str, device):
    """The fusion view of an LM file on ``device``: a ``DenseLM`` or a
    ``neural_lm.DenseRnnLM``."""
    return load_lm(path, device).dense(device)


def rescore_nbest(
    entries: List[Tuple[str, float, List[int]]],
    lm,
    lm_weight: float,
    length_bonus: float = 0.0,
) -> List[Tuple[str, float, List[int]]]:
    """Re-rank (utt, am_score, ids) entries by
    ``am + lm_weight * lm + length_bonus * len``; stable within utt.
    Batched scoring is used when the LM provides it (``seq_logprobs``)."""
    if hasattr(lm, "seq_logprobs") and entries:
        lm_scores = lm.seq_logprobs([ids for _, _, ids in entries])
    else:
        lm_scores = [lm.logprob(ids) for _, _, ids in entries]
    rescored = [
        (
            utt,
            am + lm_weight * float(lp) + length_bonus * len(ids),
            ids,
        )
        for (utt, am, ids), lp in zip(entries, lm_scores)
    ]
    by_utt: dict = defaultdict(list)
    for e in rescored:
        by_utt[e[0]].append(e)
    out: List[Tuple[str, float, List[int]]] = []
    for utt in dict.fromkeys(e[0] for e in entries):  # keep utt order
        out.extend(
            sorted(by_utt[utt], key=lambda e: -e[1])
        )
    return out
