"""`train`: build model + loaders + evaluator + trainer, train.

Port of the JAX package's ``scripts/train.py``: one process a device
(the GPU unless ``device="cpu"``). With ``distributed`` the process
joins a data-parallel group (``parallel.mesh.init_distributed``: the
coordinator flags, or torchrun's environment without them), loads its
strided shard of the training and dev sets, and trains its slice of
every global batch of ``num_processes x batch_size``. The mesh flags
(model, expert, pipe, seq axes) are not ported yet. Rank 0 writes
``logs/train_complete.json`` when training finishes, so a run that
ended can be told from one that was killed.
"""

from __future__ import annotations

import json
import os
from typing import Optional

from nabu_tpu_torch.config import Recipe
from nabu_tpu_torch.device import resolve_device
from nabu_tpu_torch.evaluators import build_evaluator
from nabu_tpu_torch.parallel import mesh
from nabu_tpu_torch.scripts.common import copy_recipe, make_loader, model_from_recipe
from nabu_tpu_torch.training.trainer import build_trainer


def main(recipe_path: str, expdir: str, device=None, rng_seed: int = 0,
         distributed: bool = False, coordinator: Optional[str] = None,
         num_processes: Optional[int] = None, process_id: Optional[int] = None) -> dict:
    """Train the recipe into ``expdir`` (NCCL between GPUs, gloo between
    CPU processes)."""
    if distributed:
        device = mesh.init_distributed(coordinator, num_processes, process_id, device)
    else:
        device = resolve_device(device)
    try:
        return _train(recipe_path, expdir, device, rng_seed)
    finally:
        if distributed:
            mesh.destroy()


def _train(recipe_path: str, expdir: str, device, rng_seed: int) -> dict:
    host_id, num_hosts = mesh.rank(), mesh.world_size()
    recipe = Recipe(recipe_path)
    os.makedirs(expdir, exist_ok=True)
    if host_id == 0:
        copy_recipe(recipe, expdir)

    trainer_conf = recipe.trainer.section("trainer")
    batch_size = trainer_conf.getint("batch_size", 16)
    num_buckets = trainer_conf.getint("num_buckets", 4)
    model, _ = model_from_recipe(
        recipe, expdir, trainer_conf["features"], trainer_conf["targets"])
    loader, _, _ = make_loader(
        recipe, expdir, trainer_conf, batch_size=batch_size, num_buckets=num_buckets,
        seed=trainer_conf.getint("shuffle_seed", 0), host_id=host_id, num_hosts=num_hosts,
    )
    valid_fn = None
    if recipe.has("validation_evaluator"):
        vconf = recipe.validation_evaluator.section("evaluator")
        # the dev set is sharded like the training set: each rank scores
        # its part and the evaluator sums the counts
        vloader, _, _ = make_loader(
            recipe, expdir, vconf, batch_size=vconf.getint("batch_size", batch_size),
            num_buckets=vconf.getint("num_buckets", 2), host_id=host_id, num_hosts=num_hosts,
        )
        valid_fn = build_evaluator(vconf, model, vloader)
    trainer = build_trainer(trainer_conf, model, loader, expdir, valid_fn=valid_fn,
                            device=device)
    result = trainer.train(rng_seed)
    print(f"[train] finished at step {result['step']}, "
          f"best metric {result['best_metric']:.4f}, "
          f"early stop: {result['stopped_early']}")
    if host_id == 0:
        marker = os.path.join(expdir, "logs", "train_complete.json")
        os.makedirs(os.path.dirname(marker), exist_ok=True)
        with open(marker, "w") as f:
            json.dump({"step": result["step"], "best_metric": float(result["best_metric"]),
                       "stopped_early": bool(result["stopped_early"])}, f)
    return result
