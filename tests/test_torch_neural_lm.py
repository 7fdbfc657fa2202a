"""The port's neural LM (``decoding/neural_lm.py``) against the JAX
package's, on the CPU (the LSTM kernels' plain versions).

- ``seq_logprobs`` / ``perplexity`` on JAX ``RnnLM.create`` weights (rtol
  1e-5, atol 1e-4), grouped scoring equal to one-at-a-time scoring bit for
  bit;
- three ``train`` steps from the same ``create(seed)`` weights against
  JAX ``RnnLM.train(num_steps=3)`` (rtol 1e-4, atol 1e-5 on every
  parameter);
- each package loads the other's ``lm_rnn.npz``;
- the ``DenseRnnLM`` chain of ``init_state`` / ``step`` / ``logprobs``
  against JAX's (atol 1e-5), and its copies by device and dtype;
- the four beam recognizers fused with an RNN LM at ``lm_weight`` 0.5 over
  the same carried-over weights: JAX's n-best ids and lengths, scores
  within rtol 1e-5 + atol 1e-4;
- ``cli lm --type rnn`` and ``cli rescore`` against JAX's scripts, and an
  export artifact carrying an RNN LM served by both packages;
- chip_smoke's RNN-LM training and its planted stale LM state.
"""

import os
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from tests.corpus_utils import make_corpus, write_recipe
from nabu_tpu.config import Conf as JConf
from nabu_tpu.decoding import lm as jlm
from nabu_tpu.decoding import neural_lm as jnlm
from nabu_tpu.decoding.recognizers import build_recognizer as jbuild_recognizer
from nabu_tpu_torch import cli
from nabu_tpu_torch.config import Conf
from nabu_tpu_torch.decoding import lm, neural_lm
from nabu_tpu_torch.decoding.recognizers import build_recognizer
from nabu_tpu_torch.params import flatten
from test_torch_lm import FUSED, _same_nbest

torch.set_num_threads(1)  # Tier-1 runs several xdist workers

V = 7


def _sequences(seed, vocab=V, n=30, max_len=20):
    rng = np.random.default_rng(seed)
    return [[int(x) for x in rng.integers(0, vocab - 1, size=int(rng.integers(0, max_len)))]
            for _ in range(n)]


def _jax_params(jm):
    return jax.tree.map(np.asarray, jm.params)


def _port_of(jm) -> neural_lm.RnnLM:
    """The JAX LM's weights in the port, on the CPU."""
    return neural_lm.RnnLM(neural_lm._tree_to(_jax_params(jm), "cpu"), jm.num_layers,
                           jm.num_units, jm.embed_dim, jm.vocab)


@pytest.mark.parametrize("num_layers", [1, 2])
def test_seq_logprobs_and_perplexity_match_jax(num_layers):
    jm = jnlm.RnnLM.create(V, num_units=16, num_layers=num_layers, embed_dim=8, seed=4)
    tm = _port_of(jm)
    seqs = _sequences(num_layers, n=12, max_len=14)
    for eos in (True, False):
        got = tm.seq_logprobs(seqs, include_eos=eos)
        assert got.dtype == np.float64 and got.shape == (len(seqs),)
        np.testing.assert_allclose(got, jm.seq_logprobs(seqs, include_eos=eos),
                                   rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(tm.perplexity(seqs), jm.perplexity(seqs), rtol=1e-5)
    np.testing.assert_allclose(tm.logprob(seqs[3]), jm.logprob(seqs[3]), rtol=1e-5, atol=1e-4)
    assert tm.seq_logprobs([]).shape == (0,)


def test_grouped_scores_equal_one_at_a_time(monkeypatch):
    """Groups of the walk's rows (here 4) give each row the bits it has
    alone, whatever the group's padded width."""
    tm = _port_of(jnlm.RnnLM.create(V, num_units=16, embed_dim=8, seed=1))
    seqs = _sequences(5, n=11, max_len=40)
    assert neural_lm.walk_rows(256) == 256 and neural_lm.walk_rows(1024) == 32
    whole = tm.seq_logprobs(seqs)
    monkeypatch.setattr(neural_lm, "walk_rows", lambda H: 4)
    grouped = tm.seq_logprobs(seqs)
    alone = np.concatenate([tm.seq_logprobs([s]) for s in seqs])
    np.testing.assert_array_equal(grouped, alone)
    np.testing.assert_array_equal(whole, alone)


@pytest.mark.parametrize("num_layers", [1, 2])
def test_three_training_steps_match_jax(num_layers):
    seqs = _sequences(7 + num_layers)
    kw = dict(num_units=16, num_layers=num_layers, embed_dim=8, num_steps=3, batch_size=8,
              learning_rate=3e-3, seed=5)
    want = jnlm.RnnLM.train(seqs, V, **kw)
    start = jnlm.RnnLM.create(V, 16, num_layers, 8, seed=5)
    got = neural_lm.RnnLM.train(seqs, V, device="cpu", params=_jax_params(start), **kw)
    flat_w, flat_g = flatten(want.params), flatten(got.params)
    assert sorted(flat_w) == sorted(flat_g)
    for k, w in flat_w.items():
        assert not flat_g[k].requires_grad
        np.testing.assert_allclose(flat_g[k].numpy(), np.asarray(w), rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    # the steps moved the weights
    assert not np.allclose(np.asarray(flat_w["proj/w"]), np.asarray(start.params["proj"]["w"]))
    with pytest.raises(ValueError, match="empty corpus"):
        neural_lm.RnnLM.train([], V, device="cpu")


def test_training_beyond_the_chain_raises_before_a_step():
    from nabu_tpu_torch.ops import lstm

    assert lstm.chain_plan(64, 256) is not None and lstm.chain_plan(64, 1024) is None
    with pytest.raises(ValueError, match="beyond the kernel's design"):
        lstm.check_design("RnnLM.train", 64, 1024, chain=True)


def test_each_package_loads_the_others_file(tmp_path):
    jm = jnlm.RnnLM.create(V, num_units=16, num_layers=2, embed_dim=8, seed=6)
    jm.save(str(tmp_path / "jax.npz"))
    got = lm.load_lm(str(tmp_path / "jax.npz"), "cpu")
    assert isinstance(got, neural_lm.RnnLM)
    assert (got.num_layers, got.num_units, got.embed_dim, got.vocab) == (2, 16, 8, V)
    seqs = _sequences(3, n=10, max_len=14)
    np.testing.assert_allclose(got.seq_logprobs(seqs), jm.seq_logprobs(seqs), rtol=1e-5,
                               atol=1e-4)
    got.save(str(tmp_path / "torch.npz"))
    with np.load(str(tmp_path / "jax.npz")) as a, np.load(str(tmp_path / "torch.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k])
    back = jlm.load_lm(str(tmp_path / "torch.npz"))
    assert isinstance(back, jnlm.RnnLM)
    np.testing.assert_array_equal(back.seq_logprobs(seqs), jm.seq_logprobs(seqs))
    assert isinstance(lm.load_dense_lm(str(tmp_path / "jax.npz"), "cpu"), neural_lm.DenseRnnLM)


def test_dense_chain_matches_jax():
    jm = jnlm.RnnLM.train(_sequences(6), V, num_units=16, num_layers=2, embed_dim=8,
                          num_steps=10, batch_size=8)
    jd, td = jm.dense(), _port_of(jm).dense()
    js, ts = jd.init_state((2, 3)), td.init_state((2, 3))
    assert sorted(ts) == sorted(js) == ["c_0", "c_1", "h_0", "h_1", "logp"]
    rng = np.random.default_rng(0)
    for _ in range(6):
        for k in js:
            assert ts[k].dtype == torch.float32
            np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]), rtol=0, atol=1e-5)
        np.testing.assert_allclose(td.logprobs(ts).numpy(), np.asarray(jd.logprobs(js)),
                                   rtol=0, atol=1e-5)
        tok = rng.integers(0, V, (2, 3)).astype(np.int32)
        js, ts = jd.step(js, tok), td.step(ts, torch.from_numpy(tok))
    # a copy a (device, dtype): float64 computes the same chain wider
    wide = td.to("cpu", torch.float64)
    assert wide is td.to("cpu", torch.float64) and td.to("cpu") is td
    assert wide.to("cpu", torch.float32) is td
    s64 = wide.init_state((2,))
    assert s64["logp"].dtype == torch.float64
    np.testing.assert_allclose(s64["logp"].numpy(), td.init_state((2,))["logp"].numpy(),
                               atol=1e-5)


# -- fusion in the four beam recognizers -----------------------------------

@pytest.fixture(scope="module")
def rnn_lm_file(tmp_path_factory):
    """-> a JAX-trained RNN LM file of a vocabulary, one a vocabulary."""
    root, files = tmp_path_factory.mktemp("rnn_lms"), {}

    def make(vocab):
        if vocab not in files:
            files[vocab] = str(root / f"lm_rnn_{vocab}.npz")
            jnlm.RnnLM.train(_sequences(11, vocab, n=40), vocab, num_units=16, embed_dim=8,
                             num_steps=40, batch_size=16, learning_rate=1e-2,
                             seed=2).save(files[vocab])
        return files[vocab]
    return make


@pytest.mark.parametrize("name", sorted(FUSED))
def test_rnn_fused_beam_matches_jax(tmp_path, rnn_lm_file, name):
    make, conf = FUSED[name]
    jm, tm, jparams, tparams, b = make(tmp_path)
    head = conf.get("head") or conf.get("att_head") or "decoder"
    conf = dict(conf, lm_path=rnn_lm_file(tm.decoders[head].output_dim),
                lm_weight="0.5")
    want = jbuild_recognizer(JConf(conf, "recognizer"), jm)(
        jparams, b["features"], b["feature_lengths"])
    rec = build_recognizer(Conf(conf, "recognizer"), tm)
    assert isinstance(rec.lm, neural_lm.DenseRnnLM) and rec.lm.device.type == "cpu"
    got = rec(tparams, b["features"], b["feature_lengths"])
    np.testing.assert_array_equal(got.lengths, np.asarray(want.lengths))
    for bi in range(got.ids.shape[0]):
        for n in range(got.ids.shape[1]):
            L = int(want.lengths[bi, n])
            np.testing.assert_array_equal(got.ids[bi, n, :L], np.asarray(want.ids)[bi, n, :L])
    np.testing.assert_allclose(got.scores, np.asarray(want.scores), rtol=1e-5, atol=1e-4)
    plain = build_recognizer(Conf({k: v for k, v in conf.items()
                                   if k not in ("lm_path", "lm_weight")}, "recognizer"), tm)
    assert not np.array_equal(got.scores, plain(tparams, b["features"],
                                                b["feature_lengths"]).scores)


def test_ngram_state_is_a_one_leaf_tree(tmp_path):
    """The n-gram LM's int state goes through the same tree code: its fused
    n-best is JAX's as before."""
    from test_torch_lm import _decode

    rec, want, got, _ = _decode(tmp_path, "ctc_beam", 0.5)
    assert isinstance(rec.lm, lm.DenseLM)
    _same_nbest(got, want)


# -- cli lm --type rnn, cli rescore, an artifact with an RNN LM ---------------

@pytest.fixture(scope="module")
def recipe(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_rnnlm")
    corpus = {s: make_corpus(str(root / s), n, seed=50 + k)
              for k, (s, n) in enumerate((("train", 12), ("dev", 4)))}
    r = str(root / "recipe")
    write_recipe(r, corpus, "[model]\n", "[trainer]\n")
    return r


def test_cli_lm_rnn_and_rescore_against_jax(tmp_path, recipe, capsys):
    from nabu_tpu.scripts import lm as jscript
    from nabu_tpu.scripts import rescore as jrescore

    flags = dict(num_units=16, embed_dim=8, num_steps=10, batch_size=8)
    want = jscript.main(recipe, str(tmp_path / "jax"), lm_type="rnn", **flags)
    jline = capsys.readouterr().out.splitlines()[-1]
    assert cli.main(["lm", "--recipe", recipe, "--expdir", str(tmp_path / "torch"),
                     "--type", "rnn", "--lm_units", "16", "--lm_embed", "8", "--lm_steps",
                     "10", "--lm_batch", "8", "--device", "cpu"]) == 0
    line = capsys.readouterr().out.splitlines()[-1]
    got = str(tmp_path / "torch" / "lm" / "lm_rnn.npz")
    assert os.path.basename(want) == "lm_rnn.npz" and os.path.exists(got)
    # the same line but for the perplexity (torch's initial draws differ)
    jhead = jline.replace(str(tmp_path / "jax"), str(tmp_path / "torch")).rsplit(" ppl ", 1)
    head = line.rsplit(" ppl ", 1)
    assert head[0] == jhead[0] and float(head[1].rstrip(")")) > 1.0
    with np.load(want) as w, np.load(got) as g:
        assert sorted(w.files) == sorted(g.files)
        assert all(w[k].shape == g[k].shape and w[k].dtype == g[k].dtype for k in w.files)
    assert isinstance(jlm.load_lm(got), jnlm.RnnLM)

    # rescore both expdirs with JAX's LM: the same ranking and scores
    lines = "utt0 -1.0 a b\nutt0 -1.1 b a\nutt0 -1.3 c a b\nutt1 -0.5 c\nutt1 -0.7 a\n"
    for side in ("jax", "torch"):
        (tmp_path / side / "decoded").mkdir(parents=True)
        (tmp_path / side / "decoded" / "nbest.txt").write_text(lines)
    os.replace(want, got)
    jrescore.main(recipe, str(tmp_path / "jax"), lm_path=got, lm_weight=0.5)
    assert cli.main(["rescore", "--recipe", recipe, "--expdir", str(tmp_path / "torch"),
                     "--lm_weight", "0.5", "--device", "cpu"]) == 0
    w = [x.split(" ", 2) for x in
         (tmp_path / "jax" / "decoded" / "rescored.txt").read_text().splitlines()]
    g = [x.split(" ", 2) for x in
         (tmp_path / "torch" / "decoded" / "rescored.txt").read_text().splitlines()]
    assert [(u, t) for u, _, t in g] == [(u, t) for u, _, t in w] and len(g) == 5
    np.testing.assert_allclose([float(s) for _, s, _ in g], [float(s) for _, s, _ in w],
                               atol=2e-4)
    assert float(g[-1][1]) not in (-0.5, -0.7)


def test_artifact_with_an_rnn_lm_serves_the_same_lines(tmp_path):
    from test_torch_serving import _artifact

    from nabu_tpu.serving import load_exported as jload
    from nabu_tpu_torch.serving import load_exported

    scp, _ = make_corpus(str(tmp_path / "wavs"), 6, seed=41)
    paths = [line.split()[1] for line in open(scp).read().splitlines()]
    art = Path(_artifact(tmp_path, "float32", "beam", seed=5))
    jnlm.RnnLM.create(4, num_units=16, embed_dim=8, seed=3).save(str(art / "lm.npz"))
    plain = load_exported(str(art), device="cpu").recognize_files(paths)
    (art / "recognizer.cfg").write_text(
        "[recognizer]\nrecognizer = ctc_beam\nbeam_width = 4\nnbest = 2\n"
        "lm_path = lm.npz\nlm_weight = 2.0\n")
    model = load_exported(str(art), device="cpu")
    assert isinstance(model.recognizer.lm, neural_lm.DenseRnnLM)
    got = model.recognize_files(paths)
    assert got == jload(str(art)).recognize_files(paths)
    assert got != plain


def test_chip_smoke_rnn_lm_and_its_planted_fault(tmp_path):
    """chip_smoke's RNN LM (trained on the phase's text, loadable by both
    packages) and its planted stale state: fused, the ctc_beam's scores
    move; under the fault they move again, and the fault is lifted after."""
    import chip_smoke

    from nabu_tpu_torch.decoding.ctc_beam import ctc_prefix_beam_search

    path = str(tmp_path / "lm_rnn.npz")
    host = chip_smoke.phase_rnn_lm(path, 5, 3, device="cpu", num_units=16, num_steps=5)
    assert (host.num_units, host.vocab) == (16, 6)
    assert isinstance(jlm.load_lm(path), jnlm.RnnLM)
    rng = np.random.default_rng(8)
    lp = torch.log_softmax(torch.as_tensor(3.0 * rng.standard_normal((2, 30, 6))), -1)
    lengths = torch.as_tensor([30, 17], dtype=torch.int32)
    dense = lm.load_dense_lm(path, "cpu").to("cpu", torch.float64)

    def search():
        return ctc_prefix_beam_search(lp, lengths, 6, 5, lm=dense, lm_weight=0.3)

    fused = search()
    assert fused[2].dtype == torch.float64
    with chip_smoke.rnn_lm_stale_state():
        stale = search()
    assert float((stale[2] - fused[2]).abs().max()) > 1e-3
    again = search()
    assert torch.equal(again[0], fused[0]) and torch.equal(again[2], fused[2])
