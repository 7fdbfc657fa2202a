"""`sweep`: train and test model variants from a sweep file.

Port of the JAX package's ``scripts/sweep.py``: each block of ``file/
section/key value`` lines in the sweep file patches the recipe; variant i
materializes its patched recipe under ``<expdir>/sweep_<i>/recipe`` (so
it is reproducible), then runs the port's ``data``, ``train`` and
``test`` into ``<expdir>/sweep_<i>``, on the GPU unless ``device="cpu"``.
"""

from __future__ import annotations

import os
import shutil
from typing import List

from nabu_tpu_torch.config import (
    RECIPE_FILES,
    Recipe,
    apply_sweep_overrides,
    parse_sweep_file,
)
from nabu_tpu_torch.device import resolve_device


def main(recipe_path: str, expdir: str, sweep_path: str, device=None) -> List[float]:
    """-> each variant's test metric, in the sweep file's order."""
    from nabu_tpu_torch.scripts import data as data_script
    from nabu_tpu_torch.scripts import test as test_script
    from nabu_tpu_torch.scripts import train as train_script

    device = resolve_device(device)
    blocks = parse_sweep_file(sweep_path)
    os.makedirs(expdir, exist_ok=True)
    metrics = []
    for i, overrides in enumerate(blocks):
        sub_expdir = os.path.join(expdir, f"sweep_{i}")
        sub_recipe = os.path.join(sub_expdir, "recipe")
        os.makedirs(sub_recipe, exist_ok=True)
        for fname in RECIPE_FILES.values():
            src = os.path.join(recipe_path, fname)
            if os.path.exists(src):
                shutil.copy(src, os.path.join(sub_recipe, fname))
        recipe = Recipe(sub_recipe)
        apply_sweep_overrides(recipe, overrides)
        for kind, f in recipe._files.items():
            f.write(os.path.join(sub_recipe, RECIPE_FILES.get(kind, kind)))

        print(f"[sweep] variant {i}: {overrides}")
        data_script.main(sub_recipe, sub_expdir)
        train_script.main(sub_recipe, sub_expdir, device=device)
        metric = test_script.main(sub_recipe, sub_expdir, device=device)
        print(f"[sweep] variant {i} metric: {metric:.4f}")
        metrics.append(metric)
    return metrics
