"""The port's parity legs and corpus against the JAX campaign's.

- ``tools.synth_corpus`` writes byte-identical wavs and the same texts as
  the JAX module for the same seed and sizes (phone40 v1 / v2 / v3 and
  the demo profile), at a tiny size;
- ``build_campaign_recipe`` writes the JAX campaign's recipe files for
  both CTC configs and the joint CTC/attention config, with the trainer
  overrides that JAX's ``run_config`` builds for each (the attention
  config's validation cadence, sortagrad and backoff grace included),
  with and without ``model_overrides``; ``_exp_tag``, ``row_filename``
  and ``_train_metrics`` give JAX's answers, and a seed other than 0 is
  named in the expdir, the row's file and the corpus marker;
- the corpus marker records the version and both split sizes, and a
  corpus of another scale is synthesized anew, not reused;
- a ``--smoke`` leg (a 30 s corpus, ``model_overrides`` shrinking the
  encoder to 1 x 8) runs ``data``, ``train``, ``test`` and ``decode`` in
  fresh processes on the CPU and writes a row with every field.
"""

import json
import math
import os

import pytest
import torch

from nabu_tpu.tools import parity_campaign as jcampaign
from nabu_tpu.tools import synth_corpus as jsynth
from nabu_tpu_torch.tools import parity_legs, synth_corpus

torch.set_num_threads(1)  # Tier-1 runs several xdist workers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROW_KEYS = {"config", "platform", "corpus_h", "corpus_version", "test_error",
            "train_audio_s_per_s", "steps", "train_wall_s", "decode_rtf", "rtf_kind",
            "card", "test_tokens", "binomial_sigma"}


def _files(root):
    """{relative path: bytes} of a corpus, its own root cut out of the texts."""
    out = {}
    for d, _, names in os.walk(root):
        for name in names:
            path = os.path.join(d, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read().replace(
                    str(root).encode(), b"ROOT")
    return out


@pytest.mark.parametrize("version", [1, 2, 3])
def test_phone40_corpus_is_byte_identical(tmp_path, version):
    kw = dict(train_seconds=8.0, dev_seconds=4.0, test_seconds=4.0, seed=7, version=version)
    jsplits, jalpha = jsynth.make_phone40_corpus(str(tmp_path / "jax"), **kw)
    splits, alpha = synth_corpus.make_phone40_corpus(str(tmp_path / "torch"), **kw)
    assert alpha == jalpha and len(alpha) == 40
    assert set(splits) == set(jsplits) == {"train", "dev", "test"}
    want, got = _files(tmp_path / "jax"), _files(tmp_path / "torch")
    assert sorted(got) == sorted(want)
    assert sum(name.endswith(".wav") for name in got) >= 3
    for name in want:
        assert got[name] == want[name], name


def test_demo_split_is_byte_identical(tmp_path):
    jsynth.make_split(str(tmp_path / "jax"), 3, 5, ["a", "b", "c"])
    synth_corpus.make_split(str(tmp_path / "torch"), 3, 5, ["a", "b", "c"])
    assert _files(tmp_path / "torch") == _files(tmp_path / "jax")


def _splits(tmp_path):
    splits = {}
    for split in ("train", "dev", "test"):
        d = tmp_path / "corpus" / split
        d.mkdir(parents=True)
        (d / "wav.scp").write_text("u1 /x.wav\n")
        (d / "text").write_text("u1 a b\n")
        splits[split] = (str(d / "wav.scp"), str(d / "text"))
    return splits


# run_config's trainer overrides of the CTC configs in the JAX campaign
JAX_CTC_OVERRIDES = {"ckpt_frequency": 0, "log_frequency": 20, "num_buckets": 4,
                     "num_epochs": 120, "resume": "true"}


class _Built(Exception):
    pass


def jax_campaign_overrides(monkeypatch, tmp_path, config, quick=False):
    """The trainer overrides JAX's ``run_config`` passes to
    ``build_campaign_recipe`` for ``config`` at 2 h (stopped there, before
    any stage runs)."""
    seen = {}

    def build(src, out, splits, alphabet, overrides, **kw):
        seen.update(overrides)
        raise _Built

    monkeypatch.setattr(jcampaign, "build_campaign_recipe", build)
    with pytest.raises(_Built):
        jcampaign.run_config(config, {}, [], str(tmp_path / "jax_campaign"), quick=quick)
    monkeypatch.undo()
    return seen


@pytest.mark.parametrize("config", parity_legs.CONFIGS)
@pytest.mark.parametrize("model_overrides", [None, {"encoder": {"num_units": 16}}])
def test_campaign_recipe_is_the_jax_campaigns(tmp_path, monkeypatch, config, model_overrides):
    assert parity_legs.leg_overrides() == JAX_CTC_OVERRIDES
    overrides = parity_legs.leg_overrides(name=config)
    want = jax_campaign_overrides(monkeypatch, tmp_path, config)
    assert overrides == want and list(overrides) == list(want)
    splits = _splits(tmp_path)
    src = os.path.join(REPO, "config", "recipes", config)
    args = (splits, [f"p{i}" for i in range(40)], overrides)
    jout = jcampaign.build_campaign_recipe(src, str(tmp_path / "jax"), *args,
                                           model_overrides=model_overrides)
    out = parity_legs.build_campaign_recipe(src, str(tmp_path / "torch"), *args,
                                            model_overrides=model_overrides)
    assert sorted(os.listdir(out)) == sorted(os.listdir(jout))
    assert len(os.listdir(out)) == 6
    for name in os.listdir(jout):
        with open(os.path.join(out, name)) as a, open(os.path.join(jout, name)) as b:
            assert a.read() == b.read(), name


def test_joint_leg_trains_as_the_campaign_does(tmp_path, monkeypatch):
    """The joint leg's recipe: the committed model and evaluators, the
    campaign's attention overrides on the recipe's trainer; its smoke leg
    keeps them but for 2 epochs without validation, as JAX's does."""
    name = "joint_ctc_att_multihost"
    assert name in parity_legs.ATTENTION_CONFIGS
    assert parity_legs.leg_overrides(name=name) == {
        **JAX_CTC_OVERRIDES, "valid_frequency": 1000, "sortagrad": "true",
        "backoff_warmup_steps": 4000}
    quick = parity_legs.leg_overrides(quick=True, name=name)
    assert quick == jax_campaign_overrides(monkeypatch, tmp_path, name, quick=True)
    out = parity_legs.build_campaign_recipe(
        os.path.join(REPO, "config", "recipes", name), str(tmp_path / "r"), _splits(tmp_path),
        [f"p{i}" for i in range(40)], parity_legs.leg_overrides(name=name))
    from nabu_tpu_torch.config import Recipe

    r = Recipe(out)
    t = r.trainer.section("trainer")
    assert (t["sortagrad"], t["backoff_warmup_steps"], t["valid_frequency"],
            t["num_epochs"], t["batch_size"]) == ("true", "4000", "1000", "120", "64")
    assert r.recognizer.section("recognizer")["recognizer"] == "joint_ctc_att_beam"
    ev = r.test_evaluator.section("evaluator")
    assert (ev["recognizer"], ev["head"], ev["beam_width"]) == ("attention_beam", "att", "16")
    with open(os.path.join(out, "model.cfg")) as a, open(
            os.path.join(REPO, "config", "recipes", name, "model.cfg")) as b:
        assert a.read() == b.read()


def test_a_second_seed_is_named_apart():
    assert parity_legs._exp_tag("dblstm_ctc_wsj", "h100", 2, 7200.0, seed=1) == \
        "exp_dblstm_ctc_wsj_seed1_h100"
    assert parity_legs._exp_tag("dblstm_ctc_wsj", "h100", 2, 7200.0, seed=0) == \
        jcampaign._exp_tag("dblstm_ctc_wsj", "h100", 2, 7200.0)
    assert parity_legs.row_filename({"config": "ctc_blstm_timit", "platform": "h100",
                                     "seed": 1}) == "ctc_blstm_timit_h100_seed1.json"
    assert parity_legs.corpus_marker(2, 7200.0, 600.0, seed=1) == "v2 7200 600 seed1"
    assert parity_legs.corpus_marker(2, 7200.0, 600.0) == "v2 7200 600"


def test_smoke_overrides_and_names_are_the_jax_campaigns():
    assert parity_legs.leg_overrides(quick=True) == {
        **JAX_CTC_OVERRIDES, "num_epochs": 2, "valid_frequency": 0}
    for args in (("dblstm_ctc_wsj", None, 2, 7200.0), ("ctc_blstm_timit", "h100", 2, 7200.0),
                 ("dblstm_ctc_wsj", "h100", 3, 72000.0), ("x", "cpu", 2, 60.0)):
        assert parity_legs._exp_tag(*args) == jcampaign._exp_tag(*args)
    for row in ({"config": "dblstm_ctc_wsj", "platform": "h100"},
                {"config": "c", "platform": "h100", "corpus_h": 20.0, "corpus_version": 3},
                {"config": "c", "platform": "cpu", "corpus_h": 0.0}):
        assert parity_legs.row_filename(row) == jcampaign.row_filename(row)
    assert parity_legs.row_filename({"config": "dblstm_ctc_wsj", "platform": "h100",
                                     "corpus_h": 2.0, "corpus_version": 2}) == \
        "dblstm_ctc_wsj_h100.json"
    assert parity_legs.platform_of(None) == "cpu"
    assert parity_legs.platform_of("NVIDIA H100 80GB HBM3, 700.00 W") == "h100"
    assert parity_legs.binomial_sigma(0.1, 900) == pytest.approx(0.01)


def test_train_metrics_are_the_jax_campaigns(tmp_path):
    logs = tmp_path / "logs"
    logs.mkdir()
    rows = [{"step": 20 * i, "time": 100.0 + 7 * i, "train/audio_s_per_s": 50.0 + i * i}
            for i in range(1, 8)] + [{"step": 140, "time": 151.5, "valid/metric": 0.5}]
    (logs / "metrics.jsonl").write_text("".join(json.dumps(r) + "\n" for r in rows))
    assert parity_legs._train_metrics(str(tmp_path)) == jcampaign._train_metrics(str(tmp_path))


def test_corpus_marker_rejects_another_scale(tmp_path, capsys):
    corpus = str(tmp_path / "corpus")
    splits, alphabet = parity_legs.ensure_corpus(corpus, 1, 4.0, 3.0, seed=1)
    marker = os.path.join(corpus, ".complete")
    assert open(marker).read().strip() == "v1 4 3 seed1"  # a seed other than 0 is named
    wavs = len(open(splits["train"][0]).read().splitlines())
    # the same version and sizes: reused
    assert parity_legs.ensure_corpus(corpus, 1, 4.0, 3.0, seed=1) == (splits, alphabet)
    assert "reusing corpus" in capsys.readouterr().out
    # another train scale, another eval scale, another version: made anew
    for version, train_s, eval_s in ((1, 12.0, 3.0), (1, 12.0, 4.0), (2, 12.0, 4.0)):
        splits2, _ = parity_legs.ensure_corpus(corpus, version, train_s, eval_s, seed=1)
        out = capsys.readouterr().out
        assert "reusing corpus" not in out and "synthesizing" in out
        assert open(marker).read().strip() == f"v{version} {train_s:g} {eval_s:g} seed1"
    assert len(open(splits2["train"][0]).read().splitlines()) > wavs
    # another seed: made anew; seed 0's marker is the JAX campaign's
    parity_legs.ensure_corpus(corpus, 2, 12.0, 4.0, seed=0)
    assert "synthesizing" in capsys.readouterr().out
    assert open(marker).read().strip() == "v2 12 4"
    # a marker from a crash or of the legacy version-only form is not trusted
    with open(marker, "w") as f:
        f.write("v1")
    parity_legs.ensure_corpus(corpus, 1, 12.0, 4.0, seed=1)
    assert "synthesizing" in capsys.readouterr().out


def test_smoke_leg_writes_a_full_row(tmp_path, monkeypatch):
    # the stages' fresh processes take one thread each, as this one does
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    rows = tmp_path / "rows"
    assert parity_legs.main([
        "--out", str(tmp_path / "out"), "--rows", str(rows), "--configs", "ctc_blstm_timit",
        "--train_seconds", "30", "--eval_seconds", "10", "--smoke", "--device", "cpu",
        "--num_workers", "0",
        "--model_overrides", json.dumps({"encoder": {"num_layers": 1, "num_units": 8}}),
    ]) == 0
    assert os.listdir(rows) == ["ctc_blstm_timit_cpu_0h.json"]
    row = json.loads((rows / "ctc_blstm_timit_cpu_0h.json").read_text())
    assert set(row) == ROW_KEYS
    assert row["config"] == "ctc_blstm_timit" and row["platform"] == "cpu"
    assert row["card"] is None and row["corpus_version"] == 2
    assert row["steps"] > 0 and math.isfinite(row["test_error"]) and row["test_error"] >= 0
    assert row["test_tokens"] > 0 and row["rtf_kind"] in ("steady", "wall")
    e = row["test_error"]
    assert row["binomial_sigma"] == pytest.approx(
        math.sqrt(max(e * (1 - e), 0.0) / row["test_tokens"]))
    expdir = tmp_path / "out" / parity_legs._exp_tag("ctc_blstm_timit", "cpu", 2, 30.0)
    assert (expdir / "logs" / "train_complete.json").exists()
    model_cfg = tmp_path / "out" / "recipe_ctc_blstm_timit" / "model.cfg"
    assert "num_units = 8" in model_cfg.read_text()
    nbest = (expdir / "decoded" / "nbest.txt").read_text().splitlines()
    assert nbest and all(len(line.split(" ", 2)) >= 2 for line in nbest)
    tokens = sum(len(line.split()) - 1 for line in
                 open(tmp_path / "out" / "corpus" / "test" / "text").read().splitlines())
    assert row["test_tokens"] == tokens


def test_attention_legs_are_not_ported_yet(tmp_path):
    with pytest.raises(NotImplementedError):
        parity_legs.run_config("las_timit", {}, [], str(tmp_path), device="cpu")
