"""`train`: build model + loaders + evaluator + trainer, train.

Port of the JAX package's ``scripts/train.py`` for one device (the GPU
unless ``device="cpu"``). Multi-process training and the mesh flags are
not ported yet. Writes ``logs/train_complete.json`` when training
finishes, so a run that ended can be told from one that was killed.
"""

from __future__ import annotations

import json
import os

from nabu_tpu_torch.config import Recipe
from nabu_tpu_torch.device import resolve_device
from nabu_tpu_torch.evaluators import build_evaluator
from nabu_tpu_torch.scripts.common import copy_recipe, make_loader, model_from_recipe
from nabu_tpu_torch.training.trainer import build_trainer


def main(recipe_path: str, expdir: str, device=None, rng_seed: int = 0) -> dict:
    """Train the recipe into ``expdir``."""
    device = resolve_device(device)
    recipe = Recipe(recipe_path)
    os.makedirs(expdir, exist_ok=True)
    copy_recipe(recipe, expdir)

    trainer_conf = recipe.trainer.section("trainer")
    batch_size = trainer_conf.getint("batch_size", 16)
    num_buckets = trainer_conf.getint("num_buckets", 4)
    model, _ = model_from_recipe(
        recipe, expdir, trainer_conf["features"], trainer_conf["targets"])
    loader, _, _ = make_loader(
        recipe, expdir, trainer_conf, batch_size=batch_size, num_buckets=num_buckets,
        seed=trainer_conf.getint("shuffle_seed", 0),
    )
    valid_fn = None
    if recipe.has("validation_evaluator"):
        vconf = recipe.validation_evaluator.section("evaluator")
        vloader, _, _ = make_loader(
            recipe, expdir, vconf, batch_size=vconf.getint("batch_size", batch_size),
            num_buckets=vconf.getint("num_buckets", 2),
        )
        valid_fn = build_evaluator(vconf, model, vloader)
    trainer = build_trainer(trainer_conf, model, loader, expdir, valid_fn=valid_fn,
                            device=device)
    result = trainer.train(rng_seed)
    print(f"[train] finished at step {result['step']}, "
          f"best metric {result['best_metric']:.4f}, "
          f"early stop: {result['stopped_early']}")
    marker = os.path.join(expdir, "logs", "train_complete.json")
    os.makedirs(os.path.dirname(marker), exist_ok=True)
    with open(marker, "w") as f:
        json.dump({"step": result["step"], "best_metric": float(result["best_metric"]),
                   "stopped_early": bool(result["stopped_early"])}, f)
    return result
