"""`test`: score the best-validated model on the test set.

Port of the JAX package's ``scripts/test.py``: the test evaluator of
``test_evaluator.cfg`` over the prepared test data, on the GPU unless
``device="cpu"``. Writes ``<expdir>/test_result.json``.
"""

from __future__ import annotations

import json
import os

from nabu_tpu_torch.config import Recipe
from nabu_tpu_torch.device import resolve_device
from nabu_tpu_torch.evaluators import build_evaluator
from nabu_tpu_torch.params import load_npz
from nabu_tpu_torch.scripts.common import make_loader, model_from_recipe


def load_best_params(expdir: str, device="cpu") -> dict:
    """The best-on-dev params of ``expdir`` (``checkpoints/best``, else
    ``checkpoints/latest``) as tensors on ``device``."""
    ckpt = os.path.join(expdir, "checkpoints")
    name = "best" if os.path.isdir(os.path.join(ckpt, "best")) else "latest"
    path = os.path.join(ckpt, name, "params.npz")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no checkpoint in {ckpt}")
    return load_npz(path, device)


def main(recipe_path: str, expdir: str, device=None) -> float:
    device = resolve_device(device)
    recipe = Recipe(recipe_path)
    tconf = recipe.test_evaluator.section("evaluator")
    model, _ = model_from_recipe(recipe, expdir, tconf["features"], tconf["targets"])
    loader, _, _ = make_loader(
        recipe, expdir, tconf, batch_size=tconf.getint("batch_size", 16),
        num_buckets=tconf.getint("num_buckets", 2),
    )
    params = load_best_params(expdir, device)
    evaluator = build_evaluator(tconf, model, loader)
    metric = evaluator.evaluate(params)
    result = {"metric": metric, "evaluator": tconf.get("evaluator", "loss")}
    with open(os.path.join(expdir, "test_result.json"), "w") as f:
        json.dump(result, f, indent=2)
    print(f"[test] {result['evaluator']} = {metric:.4f}")
    return metric
