"""``cli bpe`` and ``cli sweep`` against the JAX package's ``run bpe`` and
``run sweep``.

- ``cli bpe --device cpu`` writes a ``bpe.json`` identical to JAX
  ``scripts/bpe.main``'s on the same transcriptions (and prints its usage
  lines);
- ``config.parse_sweep_file`` reads a sweep file (comments, blank lines)
  as JAX's does;
- a two-variant ``cli sweep --device cpu`` over a tiny DNN-CTC recipe
  materializes each variant's recipe files byte for byte as JAX's sweep
  does (its data, train and test stages stubbed out), then prepares,
  trains and scores each variant (``sweep_<i>/test_result.json``);
- both raise without a GPU unless asked for the CPU.
"""

import json
import os

import numpy as np
import pytest
import torch

from tests.corpus_utils import make_corpus, write_recipe
from nabu_tpu.config import parse_sweep_file as jparse_sweep_file
from nabu_tpu_torch import cli
from nabu_tpu_torch.config import RECIPE_FILES, parse_sweep_file

torch.set_num_threads(1)  # Tier-1 runs several xdist workers

WORDS = ["the", "then", "there", "this", "that", "these", "other", "another", "bother"]


def _bpe_recipe(root) -> str:
    rng = np.random.default_rng(13)
    text = root / "text"
    text.write_text("".join(
        f"u{i} {' '.join(rng.choice(WORDS, int(rng.integers(2, 8))))}\n" for i in range(40)))
    recipe = root / "recipe"
    recipe.mkdir()
    (recipe / "database.conf").write_text(
        f"[traintargets]\ndatafile = {text}\nnormalizer = lower\n")
    return str(recipe)


def test_cli_bpe_writes_the_jax_model(tmp_path, capsys):
    from nabu_tpu.scripts import bpe as jscript

    recipe = _bpe_recipe(tmp_path)
    want = jscript.main(recipe, str(tmp_path / "jexp"), vocab_size=30)
    capsys.readouterr()
    cli.main(["bpe", "--recipe", recipe, "--expdir", str(tmp_path / "texp"),
              "--vocab_size", "30", "--device", "cpu"])
    out = capsys.readouterr().out
    got = tmp_path / "texp" / "bpe" / "bpe.json"
    assert got.read_bytes() == open(want, "rb").read()
    model = json.loads(got.read_text())
    assert len(model["vocab"]) == 30 and model["merges"]
    assert "tokenizer = bpe" in out and f"bpe_model = {got}" in out
    other = tmp_path / "other.json"
    cli.main(["bpe", "--recipe", recipe, "--expdir", str(tmp_path / "texp"), "--out",
              str(other), "--vocab_size", "30", "--device", "cpu"])
    assert other.read_bytes() == got.read_bytes()


SWEEP = """# learning rates
trainer/trainer/learning_rate 0.02
trainer/trainer/num_steps 2

model/encoder/num_units 6
"""


def test_parse_sweep_file_matches_jax(tmp_path):
    path = tmp_path / "sweep.txt"
    path.write_text(SWEEP + "\n\n# two blank lines end no block twice\n"
                    "test_evaluator/evaluator/batch_size 2\n")
    got = parse_sweep_file(str(path))
    assert got == jparse_sweep_file(str(path))
    assert got == [{"trainer/trainer/learning_rate": "0.02", "trainer/trainer/num_steps": "2"},
                   {"model/encoder/num_units": "6"},
                   {"test_evaluator/evaluator/batch_size": "2"}]


MODEL_CFG = """[encoder]
encoder = dnn
num_layers = 1
num_units = 4

[decoder]
decoder = linear_ctc
loss = ctc
"""
TRAINER_CFG = """[trainer]
features = trainfeatures
targets = traintargets
batch_size = 2
num_buckets = 1
num_steps = 3
learning_rate = 1e-2
log_frequency = 1
"""


def test_cli_sweep_materializes_the_jax_recipes_and_scores_each(tmp_path, monkeypatch):
    import nabu_tpu.scripts.data as jdata
    import nabu_tpu.scripts.test as jtest
    import nabu_tpu.scripts.train as jtrain
    from nabu_tpu.scripts import sweep as jsweep

    corpus = {"train": make_corpus(str(tmp_path / "train"), 4, seed=80),
              "dev": make_corpus(str(tmp_path / "dev"), 2, seed=81)}
    recipe = str(tmp_path / "recipe")
    write_recipe(recipe, corpus, MODEL_CFG, TRAINER_CFG)
    sweep = tmp_path / "sweep.txt"
    sweep.write_text(SWEEP)
    # JAX's sweep only materializes here: its stages are stubbed out
    monkeypatch.setattr(jdata, "main", lambda *a, **kw: None)
    monkeypatch.setattr(jtrain, "main", lambda *a, **kw: None)
    monkeypatch.setattr(jtest, "main", lambda *a, **kw: 0.0)
    jsweep.main(recipe, str(tmp_path / "jexp"), str(sweep))
    assert cli.main(["sweep", "--recipe", recipe, "--expdir", str(tmp_path / "texp"),
                     "--sweep", str(sweep), "--device", "cpu"]) == 0
    for i in range(2):
        want_dir = tmp_path / "jexp" / f"sweep_{i}" / "recipe"
        got_dir = tmp_path / "texp" / f"sweep_{i}" / "recipe"
        assert sorted(os.listdir(got_dir)) == sorted(os.listdir(want_dir)) == sorted(
            RECIPE_FILES.values())
        for fname in os.listdir(want_dir):
            assert (got_dir / fname).read_bytes() == (want_dir / fname).read_bytes(), fname
        with open(tmp_path / "texp" / f"sweep_{i}" / "test_result.json") as f:
            assert np.isfinite(json.load(f)["metric"])
    assert "learning_rate = 0.02" in (tmp_path / "texp" / "sweep_0" / "recipe" /
                                      "trainer.cfg").read_text()
    steps = [json.load(open(tmp_path / "texp" / f"sweep_{i}" / "logs" /
                            "train_complete.json"))["step"] for i in range(2)]
    assert steps == [2, 3]  # variant 0 sets num_steps, variant 1 keeps the recipe's


@pytest.mark.parametrize("command", ["bpe", "sweep"])
def test_raise_without_gpu(tmp_path, monkeypatch, command):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    recipe = _bpe_recipe(tmp_path)
    extra = ["--sweep", str(tmp_path / "none.txt")] if command == "sweep" else []
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([command, "--recipe", recipe, "--expdir", str(tmp_path / "exp"), *extra])
