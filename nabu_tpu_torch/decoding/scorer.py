"""Error-rate scoring: edit distance, CER/WER (a copy of the JAX
package's decoding/scorer.py, numpy only)."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def edit_distance(ref: Sequence, hyp: Sequence) -> int:
    """Levenshtein distance with two-row DP."""
    n, m = len(ref), len(hyp)
    if n == 0:
        return m
    if m == 0:
        return n
    prev = np.arange(m + 1)
    cur = np.zeros(m + 1, dtype=np.int64)
    ref = list(ref)
    hyp_arr = np.array(list(hyp))
    for i in range(1, n + 1):
        cur[0] = i
        sub = prev[:-1] + (hyp_arr != ref[i - 1])
        # vectorized over deletions/substitutions; insertions need a scan
        dele = prev[1:] + 1
        best = np.minimum(sub, dele)
        run = cur[0]
        for j in range(m):
            run = min(run + 1, best[j])
            cur[j + 1] = run
        prev, cur = cur, prev
    return int(prev[m])


def error_rate(
    refs: List[Sequence], hyps: List[Sequence]
) -> Tuple[float, int, int]:
    """Token error rate over a corpus: (rate, total_errors, total_tokens).

    The numpy DP for every pair (the JAX package's native C++ batch
    scorer is not ported).
    """
    if len(refs) != len(hyps):
        raise ValueError("refs and hyps length mismatch")
    tokens = sum(len(r) for r in refs)
    errors = 0
    for r, h in zip(refs, hyps):
        errors += edit_distance(r, h)
    return errors / max(tokens, 1), errors, tokens


def wer_from_texts(ref_texts: List[str], hyp_texts: List[str]) -> float:
    """Word error rate from whitespace-tokenized strings."""
    return error_rate(
        [r.split() for r in ref_texts], [h.split() for h in hyp_texts]
    )[0]


def cer_from_texts(ref_texts: List[str], hyp_texts: List[str]) -> float:
    """Character error rate (spaces included as characters)."""
    return error_rate(
        [list(r) for r in ref_texts], [list(h) for h in hyp_texts]
    )[0]
