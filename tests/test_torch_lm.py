"""The port's n-gram LM and LM shallow fusion against the JAX package's.

- ``NgramLM.train`` on seeded sequences gives JAX's table bit for bit at
  orders 1-4, and each package loads the other's ``.npz``;
  ``DenseLM.init_state`` / ``step`` / ``logprobs`` give JAX's answers on
  every state and token; ``state_where`` over a tensor, a tuple and a
  dict; ``rescore_nbest`` gives JAX's output;
- the four beam recognizers (``ctc_beam``, ``attention_beam``,
  ``joint_ctc_att_beam``, ``transducer_beam``) built from a conf that
  names a 3-gram LM at ``lm_weight`` 0.5, over the same carried-over
  weights: JAX's n-best ids and lengths, scores within rtol 1e-5 (f32);
  at ``lm_weight`` 0 the output is the unfused recognizer's, bit for bit;
- an RNN LM file of the head's vocabulary is fused; an LM of another
  vocabulary raises, and so does an LM on a recognizer that cannot fuse;
- ``cli lm`` writes JAX ``scripts/lm.main``'s ``.npz``, ``cli rescore``
  JAX ``scripts/rescore.main``'s ``rescored.txt``; an export artifact
  with an ``lm.npz`` serves the same lines in both packages;
- chip_smoke's phase LM and its planted stale LM context.
"""

import os
import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.corpus_utils import make_corpus, write_recipe
from nabu_tpu.config import Conf as JConf
from nabu_tpu.decoding import lm as jlm
from nabu_tpu.decoding.recognizers import build_recognizer as jbuild_recognizer
from nabu_tpu_torch import cli
from nabu_tpu_torch.config import Conf
from nabu_tpu_torch.decoding import lm
from nabu_tpu_torch.decoding.ctc_beam import ctc_prefix_beam_search
from nabu_tpu_torch.decoding.recognizers import build_recognizer
from nabu_tpu_torch.params import from_jax_params
from test_torch_blstm import to_torch_tree

torch.set_num_threads(1)  # Tier-1 runs several xdist workers

SCORE_RTOL = 1e-5


def _sequences(seed, vocab, n=40, max_len=12):
    rng = np.random.default_rng(seed)
    return [list(rng.integers(0, vocab - 1, size=int(rng.integers(0, max_len))))
            for _ in range(n)]


def _lm_file(tmp_path, vocab, order=3, seed=0, name="lm.npz"):
    path = str(tmp_path / name)
    lm.NgramLM.train(_sequences(seed, vocab), vocab, order).save(path)
    return path


@pytest.mark.parametrize("order", [1, 2, 3, 4])
def test_ngram_train_is_jax_bit_for_bit(tmp_path, order):
    seqs = _sequences(order, 7)
    want = jlm.NgramLM.train(seqs, 7, order)
    got = lm.NgramLM.train(seqs, 7, order)
    assert got.table.dtype == np.float32 and got.table.shape == (7 ** (order - 1), 7)
    np.testing.assert_array_equal(got.table, want.table)
    assert (got.order, got.vocab, got.boundary) == (want.order, want.vocab, want.boundary)
    assert got._boundary_state() == want._boundary_state()
    for seq in seqs[:5]:
        assert got.logprob(seq) == want.logprob(seq)
        assert got.logprob(seq, include_eos=False) == want.logprob(seq, include_eos=False)
    # each package reads the other's file
    got.save(str(tmp_path / "torch.npz"))
    want.save(str(tmp_path / "jax.npz"))
    np.testing.assert_array_equal(jlm.NgramLM.load(str(tmp_path / "torch.npz")).table,
                                  want.table)
    np.testing.assert_array_equal(lm.NgramLM.load(str(tmp_path / "jax.npz")).table, got.table)
    assert lm.load_lm(str(tmp_path / "jax.npz")).order == order


def test_ngram_train_refuses_what_jax_refuses():
    with pytest.raises(ValueError, match="order"):
        lm.NgramLM.train([[0]], 3, 0)
    with pytest.raises(ValueError, match="empty corpus"):
        lm.NgramLM.train([], 3, 2)
    with pytest.raises(ValueError, match="out of range"):
        lm.NgramLM.train([[0, 2]], 3, 2)


@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("dtype", [torch.int64, torch.int32])
def test_dense_lm_matches_jax_on_every_state(order, dtype):
    V = 5
    host = lm.NgramLM.train(_sequences(7, V), V, order)
    jdense = jlm.NgramLM.train(_sequences(7, V), V, order).dense()
    dense = host.dense("cpu")
    assert dense.table.device.type == "cpu" and dense.num_states == jdense.num_states
    init = dense.init_state((2, 3), dtype)
    assert init.dtype == dtype
    np.testing.assert_array_equal(init.numpy(), np.asarray(jdense.init_state((2, 3))))
    states = np.repeat(np.arange(dense.num_states), V)
    tokens = np.tile(np.arange(V), dense.num_states)
    got = dense.step(torch.from_numpy(states).to(dtype), torch.from_numpy(tokens))
    assert got.dtype == dtype
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jdense.step(jnp.asarray(states), jnp.asarray(tokens))))
    np.testing.assert_array_equal(
        dense.logprobs(torch.from_numpy(states).to(dtype)).numpy(),
        np.asarray(jdense.logprobs(jnp.asarray(states))))
    # the same LM on the same device is the same object
    assert dense.to("cpu") is dense


def test_state_where_over_a_tensor_tuple_and_dict():
    cond = torch.tensor([[True, False], [False, True]])
    a, b = torch.arange(4).reshape(2, 2), -torch.arange(4).reshape(2, 2)
    assert lm.state_where(cond, a, b).tolist() == [[0, -1], [-2, 3]]
    ha, hb = torch.ones((2, 2, 3)), torch.zeros((2, 2, 3))
    h, c = lm.state_where(cond, (ha, a), (hb, b))
    assert h[:, :, 0].tolist() == [[1.0, 0.0], [0.0, 1.0]] and c.tolist() == [[0, -1], [-2, 3]]
    d = lm.state_where(cond, {"h": ha, "s": [a]}, {"h": hb, "s": [b]})
    assert torch.equal(d["h"], h) and d["s"][0].tolist() == [[0, -1], [-2, 3]]


def test_rescore_nbest_matches_jax():
    seqs = _sequences(3, 6)
    host, jhost = lm.NgramLM.train(seqs, 6, 3), jlm.NgramLM.train(seqs, 6, 3)
    rng = np.random.default_rng(5)
    entries = [(f"u{i // 4}", float(rng.normal(-10, 3)), [int(x) for x in s])
               for i, s in enumerate(_sequences(9, 6, n=16))]
    for weight, bonus in ((0.3, 0.0), (1.0, 0.5), (0.0, 0.0)):
        assert (lm.rescore_nbest(entries, host, weight, bonus)
                == jlm.rescore_nbest(entries, jhost, weight, bonus))


# -- fusion in the four beam recognizers -----------------------------------

def _joint_model(tmp_path, attention="bahdanau"):
    from test_torch_joint import _batch, _models

    jm, tm, params = _models(tmp_path, attention)
    return jm, tm, params, to_torch_tree(params), _batch(6)


def _transducer_model(tmp_path):
    from test_torch_transducer import _batch, _models, _params

    jm, tm = _models(tmp_path)
    jparams, flat = _params(jm, 3)
    return jm, tm, jparams, from_jax_params(flat), _batch(3)


FUSED = {
    "ctc_beam": (_joint_model, {"recognizer": "ctc_beam", "head": "ctc", "beam_width": "4",
                                "nbest": "3"}),
    "attention_beam": (_joint_model, {"recognizer": "attention_beam", "head": "att",
                                      "beam_width": "4", "nbest": "3",
                                      "length_norm_power": "1.0"}),
    "joint_ctc_att_beam": (_joint_model, {"recognizer": "joint_ctc_att_beam",
                                          "att_head": "att", "ctc_head": "ctc",
                                          "ctc_weight": "0.3", "beam_width": "4",
                                          "nbest": "3", "length_norm_power": "1.0"}),
    "transducer_beam": (_transducer_model, {"recognizer": "transducer_beam",
                                            "beam_width": "4", "nbest": "3",
                                            "max_symbols": "3"}),
}


def _decode(tmp_path, name, weight):
    make, conf = FUSED[name]
    jm, tm, jparams, tparams, b = make(tmp_path)
    head = conf.get("head") or conf.get("att_head") or "decoder"
    vocab = tm.decoders[head].output_dim
    conf = dict(conf, lm_path=_lm_file(tmp_path, vocab), lm_weight=str(weight))
    want = jbuild_recognizer(JConf(conf, "recognizer"), jm)(
        jparams, b["features"], b["feature_lengths"])
    rec = build_recognizer(Conf(conf, "recognizer"), tm)
    got = rec(tparams, b["features"], b["feature_lengths"])
    plain = build_recognizer(Conf({k: v for k, v in conf.items()
                                   if k not in ("lm_path", "lm_weight")}, "recognizer"), tm)
    return rec, want, got, plain(tparams, b["features"], b["feature_lengths"])


def _same_nbest(got, want):
    np.testing.assert_array_equal(got.lengths, np.asarray(want.lengths))
    for b in range(got.ids.shape[0]):
        for n in range(got.ids.shape[1]):
            L = int(want.lengths[b, n])
            np.testing.assert_array_equal(got.ids[b, n, :L], np.asarray(want.ids)[b, n, :L])
    np.testing.assert_allclose(got.scores, np.asarray(want.scores), rtol=SCORE_RTOL)


@pytest.mark.parametrize("name", sorted(FUSED))
def test_fused_beam_matches_jax(tmp_path, name):
    rec, want, got, plain = _decode(tmp_path, name, 0.5)
    assert rec.supports_lm_fusion and rec.lm is not None and rec.lm_weight == 0.5
    _same_nbest(got, want)
    # the LM moved the scores
    assert not np.array_equal(got.scores, plain.scores)


@pytest.mark.parametrize("name", sorted(FUSED))
def test_lm_weight_zero_is_the_unfused_beam(tmp_path, name):
    rec, want, got, plain = _decode(tmp_path, name, 0.0)
    assert rec.lm is None
    _same_nbest(got, want)
    np.testing.assert_array_equal(got.ids, plain.ids)
    np.testing.assert_array_equal(got.scores, plain.scores)


def test_an_rnn_lm_and_a_vocab_mismatch_raise(tmp_path):
    """An RNN LM of the head's vocabulary is fused (the neural LM is
    ported: ``tests/test_torch_neural_lm.py`` holds its searches to
    JAX's); an RNN LM or an n-gram of another vocabulary raises, as JAX's
    recognizer does, and so does an LM on a recognizer that cannot
    fuse."""
    from nabu_tpu.decoding.neural_lm import RnnLM as JRnnLM
    from nabu_tpu_torch.decoding.neural_lm import DenseRnnLM

    jm, tm, _, _, _ = _joint_model(tmp_path)
    conf = dict(FUSED["attention_beam"][1], lm_weight="0.5")
    for vocab in (6, 5):
        JRnnLM.create(vocab, num_units=8, embed_dim=4).save(str(tmp_path / f"rnn{vocab}.npz"))
    rec = build_recognizer(Conf(dict(conf, lm_path=str(tmp_path / "rnn6.npz")), "recognizer"),
                           tm)
    assert isinstance(rec.lm, DenseRnnLM) and rec.lm.vocab == 6
    assert isinstance(lm.load_dense_lm(str(tmp_path / "rnn6.npz"), "cpu"), DenseRnnLM)
    rnn5 = dict(conf, lm_path=str(tmp_path / "rnn5.npz"))
    with pytest.raises(ValueError, match="LM vocab 5 != model output vocab 6"):
        jbuild_recognizer(JConf(rnn5, "recognizer"), jm)
    with pytest.raises(ValueError, match="LM vocab 5 != model output vocab 6"):
        build_recognizer(Conf(rnn5, "recognizer"), tm)
    with pytest.raises(ValueError, match="LM vocab 5 != model output vocab 6"):
        build_recognizer(Conf(dict(conf, lm_path=_lm_file(tmp_path, 5)), "recognizer"), tm)
    with pytest.raises(ValueError, match="does not support LM shallow fusion"):
        build_recognizer(Conf({"recognizer": "attention_greedy", "head": "att",
                               "lm_path": _lm_file(tmp_path, 6), "lm_weight": "0.5"},
                              "recognizer"), tm)


# -- cli lm, cli rescore, an artifact with its LM ---------------------------

@pytest.fixture(scope="module")
def recipe(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_lm")
    corpus = {s: make_corpus(str(root / s), n, seed=k)
              for k, (s, n) in enumerate((("train", 30), ("dev", 4)))}
    r = str(root / "recipe")
    write_recipe(r, corpus, "", "[trainer]\n", recognizer_lines="recognizer = ctc_beam")
    return r


@pytest.mark.parametrize("order", [2, 3])
def test_cli_lm_writes_the_jax_npz(tmp_path, recipe, capsys, order):
    from nabu_tpu.scripts import lm as jscript

    want = jscript.main(recipe, str(tmp_path / "jax"), order=order)
    jline = capsys.readouterr().out.splitlines()[-1]
    assert cli.main(["lm", "--recipe", recipe, "--expdir", str(tmp_path / "torch"),
                     "--order", str(order)]) == 0
    line = capsys.readouterr().out.splitlines()[-1]
    got = str(tmp_path / "torch" / "lm" / f"lm_{order}gram.npz")
    assert os.path.basename(want) == os.path.basename(got)
    assert line == jline.replace(str(tmp_path / "jax"), str(tmp_path / "torch"))
    with np.load(want) as w, np.load(got) as g:
        assert sorted(w.files) == sorted(g.files) == ["order", "table", "vocab"]
        for k in w.files:
            assert w[k].dtype == g[k].dtype
            np.testing.assert_array_equal(g[k], w[k])


def test_cli_rescore_writes_the_jax_rescored_txt(tmp_path, recipe):
    from nabu_tpu.scripts import rescore as jscript

    rng = np.random.default_rng(2)
    lines = []
    for u in range(5):
        for _ in range(3):
            words = " ".join(rng.choice(["a", "b", "c"], int(rng.integers(0, 6))))
            lines.append(f"utt{u:04d} {rng.normal(-8, 2):.4f} {words}".rstrip())
    for side in ("jax", "torch"):
        d = tmp_path / side / "decoded"
        d.mkdir(parents=True)
        (d / "nbest.txt").write_text("\n".join(lines) + "\n")
    cli.main(["lm", "--recipe", recipe, "--expdir", str(tmp_path / "torch")])
    shutil.copytree(tmp_path / "torch" / "lm", tmp_path / "jax" / "lm")
    for weight, bonus in (("0.3", "0.0"), ("1.5", "0.25")):
        jscript.main(recipe, str(tmp_path / "jax"), lm_weight=float(weight),
                     length_bonus=float(bonus))
        assert cli.main(["rescore", "--recipe", recipe, "--expdir", str(tmp_path / "torch"),
                         "--lm_weight", weight, "--length_bonus", bonus]) == 0
        want = (tmp_path / "jax" / "decoded" / "rescored.txt").read_text()
        got = (tmp_path / "torch" / "decoded" / "rescored.txt").read_text()
        assert got == want and len(got.splitlines()) == 15


def test_artifact_with_an_lm_serves_the_same_lines(tmp_path):
    from test_torch_serving import _artifact

    from nabu_tpu.serving import load_exported as jload
    from nabu_tpu_torch.serving import load_exported

    scp, _ = make_corpus(str(tmp_path / "wavs"), 6, seed=41)
    paths = [line.split()[1] for line in open(scp).read().splitlines()]
    art = Path(_artifact(tmp_path, "float32", "beam", seed=5))
    lm.NgramLM.train([[0, 1, 2, 1], [2, 2, 0], [1]], 4, 3).save(str(art / "lm.npz"))
    plain = load_exported(str(art), device="cpu").recognize_files(paths)
    (art / "recognizer.cfg").write_text(
        "[recognizer]\nrecognizer = ctc_beam\nbeam_width = 4\nnbest = 2\n"
        "lm_path = lm.npz\nlm_weight = 2.0\n")
    model = load_exported(str(art), device="cpu")
    assert model.recognizer.lm is not None
    got = model.recognize_files(paths)
    assert got == jload(str(art)).recognize_files(paths)
    assert got != plain


def test_chip_smoke_lm_and_its_planted_fault(tmp_path):
    """chip_smoke's phase LM (a 3-gram over the alphabet plus the
    boundary, loadable by both packages) and its planted stale context:
    fused, the ctc_beam's scores move; under the fault they move again,
    and the fault is lifted after."""
    import chip_smoke

    path = str(tmp_path / "lm.npz")
    host = chip_smoke.phase_text_lm(path, 5, 3)
    assert (host.order, host.vocab) == (3, 6)
    np.testing.assert_array_equal(jlm.NgramLM.load(path).table, host.table)
    rng = np.random.default_rng(8)
    lp = torch.log_softmax(torch.as_tensor(3.0 * rng.standard_normal((2, 30, 6))), -1)
    lengths = torch.as_tensor([30, 17], dtype=torch.int32)
    dense = lm.load_dense_lm(path, "cpu")

    def search():
        return ctc_prefix_beam_search(lp, lengths, 6, 5, lm=dense, lm_weight=0.3)

    fused = search()
    assert fused[2].dtype == torch.float64
    with chip_smoke.lm_stale_context():
        stale = search()
    assert float((stale[2] - fused[2]).abs().max()) > 1e-3
    again = search()
    assert torch.equal(again[0], fused[0]) and torch.equal(again[2], fused[2])
