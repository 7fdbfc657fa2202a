"""The LAS recipe's data prep and training through the port's CLI, on the
CPU at a few units.

The speed-perturbed prep (``speed_perturb = 0.9 1.0 1.1``) writes the same
utterance ids, targets and features (to f32 rounding of the log-mel, rtol
1e-5) as the JAX package's ``scripts/data.py``; a
tiny las_large_wsj-shaped recipe (pyramid Listener, location-attention
Speller with scheduled sampling, label-smoothed cross-entropy, SpecAugment,
bf16 compute, speed perturbation) goes through ``cli data`` and ``cli
train --device cpu`` with the recipe's ``attention_greedy`` validation.
"""

import json
import os

import numpy as np
import torch

from corpus_utils import make_corpus, write_recipe
from nabu_tpu.config import Recipe as JRecipe
from nabu_tpu.scripts import data as jdata
from nabu_tpu.scripts.common import open_dataset as jopen_dataset
from nabu_tpu_torch import cli
from nabu_tpu_torch.config import ConfigFile, Recipe
from nabu_tpu_torch.models.model import build_model
from nabu_tpu_torch.params import flatten, load_npz
from nabu_tpu_torch.scripts import data as tdata
from nabu_tpu_torch.scripts.common import open_dataset

torch.set_num_threads(1)  # Tier-1 runs several xdist workers

MODEL_CFG = """[model]
compute_dtype = bfloat16
spec_augment = true
spec_time_width = 5

[encoder]
encoder = listener
num_layers = 2
num_units = 8
dropout = 0.0
use_pallas = true

[decoder]
decoder = speller
num_layers = 2
num_units = 8
embed_dim = 4
attention = location
sample_prob = 0.1
loss = cross_entropy
label_smoothing = 0.1
"""

TRAINER = """[trainer]
features = trainfeatures
targets = traintargets
batch_size = 4
num_buckets = 1
num_steps = 6
learning_rate = 1e-2
valid_frequency = 3
log_frequency = 1
ckpt_frequency = 3
async_checkpoint = true
"""


def _perturbed_recipe(tmp_path, model=MODEL_CFG, trainer=TRAINER):
    corpus = {"train": make_corpus(str(tmp_path / "train"), 4, seed=2),
              "dev": make_corpus(str(tmp_path / "dev"), 4, seed=3)}
    recipe = str(tmp_path / "recipe")
    write_recipe(recipe, corpus, model, trainer)
    db = open(f"{recipe}/database.conf").read()
    # both train sections perturbed, as las_large_wsj's database.conf
    db = db.replace("dir = trainfeatures\n", "dir = trainfeatures\nspeed_perturb = 0.9 1.0 1.1\n")
    db = db.replace("dir = traintargets\n", "dir = traintargets\nspeed_perturb = 0.9 1.0 1.1\n")
    open(f"{recipe}/database.conf", "w").write(db)
    return recipe


def test_speed_perturb_prep_matches_jax(tmp_path):
    recipe = _perturbed_recipe(tmp_path)
    jdata.main(recipe, str(tmp_path / "jexp"))
    tdata.main(recipe, str(tmp_path / "texp"))
    for section in ("trainfeatures", "traintargets", "devfeatures"):
        want = jopen_dataset(JRecipe(recipe), str(tmp_path / "jexp"), section)
        got = open_dataset(Recipe(recipe), str(tmp_path / "texp"), section)
        assert got.utt_ids == want.utt_ids, section
        for utt in want.utt_ids:
            if section.endswith("targets"):
                np.testing.assert_array_equal(got[utt], want[utt], err_msg=f"{section} {utt}")
            else:  # log-mel ~10: the two fbanks round their f32 sums apart
                np.testing.assert_allclose(got[utt], want[utt], rtol=1e-5, atol=1e-5,
                                           err_msg=f"{section} {utt}")
    got = open_dataset(Recipe(recipe), str(tmp_path / "texp"), "trainfeatures")
    assert len(got) == 12 and "utt0001#sp0.9" in got.utt_ids
    assert got["utt0001#sp0.9"].shape[0] > got["utt0001"].shape[0] > got["utt0001#sp1.1"].shape[0]


def test_cli_train_las_recipe(tmp_path):
    """`cli data` and `cli train --device cpu` of the tiny LAS recipe: 12
    training utterances after perturbation, 6 finite losses starting near
    the uniform one, token accuracy logged, validation through
    attention_greedy twice, every parameter of the Speller's and the
    Listener's trees updated in the checkpoint. (Whether the loss falls is
    the card's check, over 40 full-width steps: at 8 units on 4 utterances
    6 steps move it by less than the batches differ.)"""
    recipe = _perturbed_recipe(tmp_path)
    with open(os.path.join(recipe, "validation_evaluator.cfg"), "w") as f:
        f.write("[evaluator]\nevaluator = decoder\nrecognizer = attention_greedy\n"
                "features = devfeatures\ntargets = devtargets\n"
                "batch_size = 4\nnum_buckets = 1\n")
    expdir = str(tmp_path / "exp")
    cli.main(["data", "--recipe", recipe, "--expdir", expdir, "--device", "cpu"])
    cli.main(["train", "--recipe", recipe, "--expdir", expdir, "--device", "cpu"])
    with open(os.path.join(expdir, "logs", "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    losses = [r["train/loss"] for r in records if "train/loss" in r]
    assert len(losses) == 6 and all(np.isfinite(losses))
    assert abs(losses[0] - np.log(4)) < 0.3, losses  # near uniform over a, b, c, <eos>
    acc = [r["train/decoder/token_accuracy"] for r in records
           if "train/decoder/token_accuracy" in r]
    assert len(acc) == 6 and all(0.0 <= a <= 1.0 for a in acc)
    metrics = [r["valid/metric"] for r in records if "valid/metric" in r]
    assert len(metrics) == 2 and all(0.0 <= m for m in metrics)
    params = flatten(load_npz(os.path.join(expdir, "checkpoints", "latest", "params.npz")))
    assert {"decoders/decoder/embed/table", "decoders/decoder/lstm_1/wh",
            "decoders/decoder/attn_loc/conv", "decoders/decoder/attn_v/v",
            "encoder/pyramid_1/bw/wh"} <= set(params)
    # every parameter moved from the trainer's initial draw (seed 0)
    init = flatten(build_model(ConfigFile.read(os.path.join(recipe, "model.cfg")), 10, 3).init(
        torch.Generator().manual_seed(0)))
    assert set(init) == set(params)
    assert all(not torch.equal(params[k], init[k]) for k in init)
    assert os.path.exists(os.path.join(expdir, "logs", "train_complete.json"))
