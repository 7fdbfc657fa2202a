"""Shared experiment plumbing for the pipeline scripts (a copy of the JAX
package's scripts/common.py): expdir layout, dataset resolution from
database.conf, model construction from prepared metadata."""

from __future__ import annotations

import os
import shutil
from typing import Optional, Tuple

from nabu_tpu_torch.config import RECIPE_FILES, Conf, Recipe
from nabu_tpu_torch.data.pipeline import BucketedLoader
from nabu_tpu_torch.data.storage import ShardedDataset
from nabu_tpu_torch.models.model import Model, build_model


def data_dir(expdir: str, section: Conf, name: str) -> str:
    """Output directory for a database.conf section: its ``dir`` key,
    relative paths resolved under <expdir>/data."""
    d = section.get("dir", name)
    if not os.path.isabs(d):
        d = os.path.join(expdir, "data", d)
    return d


def copy_recipe(recipe: Recipe, expdir: str) -> None:
    """Record the recipe in the expdir (the reference's experiment-record
    contract: expdir holds the exact configs that produced it)."""
    dst = os.path.join(expdir, "config")
    os.makedirs(dst, exist_ok=True)
    for fname in RECIPE_FILES.values():
        src = os.path.join(recipe.path, fname)
        if os.path.exists(src):
            shutil.copy(src, os.path.join(dst, fname))


def open_dataset(recipe: Recipe, expdir: str, section_name: str) -> ShardedDataset:
    section = recipe.database.section(section_name)
    return ShardedDataset(data_dir(expdir, section, section_name))


def make_loader(
    recipe: Recipe,
    expdir: str,
    conf: Conf,
    batch_size: int,
    num_buckets: int = 1,
    seed: int = 0,
    host_id: int = 0,
    num_hosts: int = 1,
) -> Tuple[BucketedLoader, ShardedDataset, Optional[ShardedDataset]]:
    """Build a loader from a config section naming ``features`` and
    (optionally) ``targets`` database sections."""
    feats = open_dataset(recipe, expdir, conf["features"])
    tgts = (
        open_dataset(recipe, expdir, conf["targets"])
        if conf.get("targets")
        else None
    )
    loader = BucketedLoader(
        feats,
        tgts,
        batch_size=batch_size,
        num_buckets=num_buckets,
        seed=seed,
        host_id=host_id,
        num_hosts=num_hosts,
    )
    return loader, feats, tgts


def model_from_recipe(
    recipe: Recipe, expdir: str, features_section: str, targets_section: str
) -> Tuple[Model, dict]:
    """Build the model with input_dim / num_labels from prepared data
    metadata. Returns (model, targets metadata)."""
    feats = open_dataset(recipe, expdir, features_section)
    tgts = open_dataset(recipe, expdir, targets_section)
    input_dim = feats.metadata["dim"]
    num_labels = tgts.metadata["num_labels"]
    model = build_model(recipe.model, input_dim, num_labels)
    return model, tgts.metadata
