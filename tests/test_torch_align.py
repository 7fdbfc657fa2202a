"""CTC forced alignment against the JAX package's ``decoding/align.py``
and ``run align``.

- ``ctc_forced_align`` on seeded f32 log-probs: frame labels identical and
  path scores within 1e-5, with ragged frames and labels, an empty label
  sequence, repeated labels, and log-probs rounded to whole numbers so
  that stay, advance and skip tie (the first wins in both);
- each path score at most the CTC log-likelihood of the same log-probs
  (``ops.ctc``'s plain recursion), and each feasible sequence's
  segments collapsing to its labels; ``chip_smoke``'s planted fault (a
  skip into a repeated label) breaks the collapse;
- ``segments_from_frames`` equal to JAX's;
- ``cli align --device cpu`` on a tiny DBLSTM-CTC recipe writes JAX
  ``run align``'s CTM on the same weights, and raises without a GPU
  unless asked for the CPU.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tests.corpus_utils import make_corpus, write_recipe
from nabu_tpu.decoding import align as jalign
from nabu_tpu_torch import cli
from nabu_tpu_torch.decoding import align
from nabu_tpu_torch.ops.ctc import ctc_forward_log_alpha
from nabu_tpu_torch.params import from_jax_params
from nabu_tpu_torch.training.checkpoints import CheckpointManager

torch.set_num_threads(1)  # Tier-1 runs several xdist workers

V, BLANK = 5, 4


def _case(seed, B=6, T=14, U=5, whole=False):
    """Log-probs [B, T, V], ragged lengths, labels with repeats; lane 1
    has no labels, lane 2 is infeasible (more labels than frames)."""
    rng = np.random.default_rng(seed)
    logits = 2.0 * rng.standard_normal((B, T, V))
    if whole:
        logits = np.round(logits)  # many ties between the three moves
    lp = (logits - np.log(np.exp(logits).sum(-1, keepdims=True))).astype(np.float32)
    if whole:
        lp = np.round(lp).astype(np.float32)
    lengths = rng.integers(U + 2, T + 1, B).astype(np.int32)
    lengths[2] = 3
    targets = rng.integers(0, V - 1, (B, U)).astype(np.int32)
    targets[:, 2] = targets[:, 1]  # a repeated label in every sequence
    tl = rng.integers(3, U + 1, B).astype(np.int32)
    tl[1] = 0
    return lp, lengths, targets, tl


def _ctc_ll(lp, lengths, targets, tl) -> np.ndarray:
    """log sum over the CTC paths of the scores ``lp`` (the plain oracle's
    recursion, without its log-softmax: the rounded scores are not
    normalized)."""
    alphas, _ = ctc_forward_log_alpha(torch.from_numpy(lp), torch.from_numpy(lengths),
                                      torch.from_numpy(targets), BLANK)
    b = np.arange(len(lp))
    end = alphas[lengths - 1, b].numpy()
    last = np.where(tl > 0, end[b, np.maximum(2 * tl - 1, 0)], -np.inf)
    return np.logaddexp(end[b, 2 * tl], last)


@pytest.mark.parametrize("seed,whole", [(0, False), (1, False), (2, True), (3, True)])
def test_forced_align_matches_jax(seed, whole):
    lp, lengths, targets, tl = _case(seed, whole=whole)
    want_f, want_s = jalign.ctc_forced_align(*map(jnp.asarray, (lp, lengths, targets, tl)),
                                             BLANK)
    got_f, got_s = align.ctc_forced_align(*map(torch.from_numpy, (lp, lengths, targets, tl)),
                                          BLANK)
    assert got_f.dtype == torch.int32 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=0, atol=1e-5)
    # the path is one of the alignments the CTC likelihood sums over
    feasible = np.asarray([b != 2 for b in range(len(lp))])
    ll = _ctc_ll(lp, lengths, targets, tl)
    assert np.all(got_s.numpy()[feasible] <= ll[feasible] + 1e-5)
    for b in np.flatnonzero(feasible):
        segs = align.segments_from_frames(got_f[b].numpy(), lengths[b], BLANK)
        assert [lab for lab, _, _ in segs] == list(targets[b, :tl[b]])
        assert np.all(got_f[b, lengths[b]:].numpy() == BLANK)


def test_planted_repeated_label_skip_is_caught():
    """chip_smoke's fault (a skip allowed into a repeated label) on frames
    that favor the label throughout: the fault's path merges the repeat."""
    lp = np.log(np.full((1, 4, V), 0.02, np.float32))
    lp[0, :, 1] = np.log(0.9)
    args = [torch.from_numpy(x) for x in (lp, np.asarray([4], np.int32),
                                           np.asarray([[1, 1]], np.int32),
                                           np.asarray([2], np.int32))]
    frames, _ = align.ctc_forced_align(*args, BLANK)
    assert chip_smoke.collapses_to(frames[0], 4, [1, 1], BLANK)
    with chip_smoke.align_repeat_skip():
        faulty, _ = align.ctc_forced_align(*args, BLANK)
    assert not chip_smoke.collapses_to(faulty[0], 4, [1, 1], BLANK)
    again, _ = align.ctc_forced_align(*args, BLANK)  # the fault is gone after the block
    assert torch.equal(again, frames)


def test_segments_from_frames_matches_jax():
    rng = np.random.default_rng(9)
    for _ in range(20):
        row = rng.integers(0, 3, 12)
        length = int(rng.integers(0, 13))
        assert align.segments_from_frames(row, length, 2) == jalign.segments_from_frames(
            row, length, 2)


MODEL_CFG = """[model]
compute_dtype = float32

[encoder]
encoder = dblstm
num_layers = 2
num_units = 8
use_pallas = true

[decoder]
decoder = linear_ctc
loss = ctc
use_pallas = true
"""
TRAINER_CFG = "[trainer]\nfeatures = trainfeatures\ntargets = traintargets\nbatch_size = 4\n"


@pytest.fixture(scope="module")
def exp(tmp_path_factory):
    """A prepared tone corpus and the same seeded weights in a JAX and a
    port checkpoint: -> (recipe, JAX expdir, port expdir)."""
    from nabu_tpu.config import ConfigFile as JConfigFile
    from nabu_tpu.models.model import build_model as jbuild_model
    from nabu_tpu.serving import _flatten_params, _unflatten_params
    from nabu_tpu.training.checkpoints import CheckpointManager as JCheckpointManager

    root = tmp_path_factory.mktemp("torch_align")
    corpus = {"train": make_corpus(str(root / "train"), 4, seed=70),
              "dev": make_corpus(str(root / "dev"), 6, seed=71, min_len=3, max_len=8)}
    recipe = str(root / "recipe")
    write_recipe(recipe, corpus, MODEL_CFG, TRAINER_CFG)
    texp, jexp = str(root / "exp_torch"), str(root / "exp_jax")
    cli.main(["data", "--recipe", recipe, "--expdir", texp, "--device", "cpu"])
    shutil.copytree(os.path.join(texp, "data"), os.path.join(jexp, "data"))
    model = jbuild_model(JConfigFile.read(os.path.join(recipe, "model.cfg")), 10, 3)
    rng = np.random.default_rng(72)
    flat = {k: (rng.uniform(-0.5, 0.5, v.shape).astype(np.float32) if k.endswith("/b") else v)
            for k, v in _flatten_params(model.init(jax.random.PRNGKey(7))).items()}
    JCheckpointManager(os.path.join(jexp, "checkpoints")).save(
        "best", {"params": _unflatten_params(flat)})
    CheckpointManager(os.path.join(texp, "checkpoints")).save(
        "best", {"params": from_jax_params(flat)})
    return recipe, jexp, texp


def test_cli_align_writes_the_jax_ctm(exp):
    from nabu_tpu.scripts import align as jscript

    recipe, jexp, texp = exp
    want = jscript.main(recipe, jexp)
    cli.main(["align", "--recipe", recipe, "--expdir", texp, "--device", "cpu"])
    with open(want) as f:
        want_lines = f.read().splitlines()
    with open(os.path.join(texp, "aligned", "align.ctm")) as f:
        got_lines = f.read().splitlines()
    assert got_lines == want_lines
    assert {line.split()[0] for line in got_lines} == {f"utt{i:04d}" for i in range(6)}
    # every utterance's tokens are its transcription, in order
    texts = dict(line.split(" ", 1) for line in open(
        os.path.join(os.path.dirname(recipe), "dev", "text")).read().splitlines())
    by_utt = {}
    for line in got_lines:
        utt, _, start, dur, tok = line.split()
        assert float(dur) > 0.0 and float(start) >= 0.0
        by_utt.setdefault(utt, []).append(tok)
    assert {u: " ".join(t) for u, t in by_utt.items()} == texts


def test_cli_align_raises_without_gpu(exp, monkeypatch):
    recipe, _, texp = exp
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["align", "--recipe", recipe, "--expdir", texp])
