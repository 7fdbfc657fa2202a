"""Parameters: the JAX package's flattened parameter tree <-> tensors.

An export artifact's ``params.npz`` (and the port's checkpoints) holds the model's parameter tree
flattened to ``/``-joined keys, e.g. ``encoder/layer_0/fw/wx`` and
``decoders/decoder/out/w``. The port keeps that tree and every array's
layout as it is: a linear ``w`` stays ``[in, out]`` (never transposed
into ``nn.Linear``'s ``[out, in]``) and an LSTM direction keeps
``wx [D, 4H]``, ``wh [H, 4H]``, ``b [4H]`` with gate order i, f, g, o.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def unflatten(flat: Dict[str, object]) -> dict:
    tree: dict = {}
    for key, value in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree


def flatten(tree: dict, prefix: str = "") -> Dict[str, object]:
    """Nested dict -> {"a/b/c": leaf}."""
    flat: Dict[str, object] = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, dict):
            flat.update(flatten(value, f"{name}/"))
        else:
            flat[name] = value
    return flat


def to_flat_numpy(tree: dict) -> Dict[str, np.ndarray]:
    """Nested dict of tensors -> {"a/b/c": numpy array} on the host, the
    inverse of ``from_jax_params`` (dtypes and layouts unchanged)."""
    return {
        k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        for k, v in flatten(tree).items()
    }


def from_jax_params(flat: Dict[str, np.ndarray], device="cpu") -> dict:
    """{"a/b/c": array} -> nested dict of tensors on ``device``, dtypes
    and layouts unchanged."""
    return unflatten({
        k: torch.tensor(np.asarray(v), device=device) for k, v in flat.items()
    })


def load_npz(path: str, device="cpu") -> dict:
    with np.load(path) as z:
        return from_jax_params({k: z[k] for k in z.files}, device)
