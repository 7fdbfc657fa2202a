"""Training-time augmentation: SpecAugment.

Port of the JAX package's ``ops/augment.py``: masks random frequency bands
and time spans of the [B, T, F] feature batch (Park et al., 2019), set to
0.0 (features are CMVN-normalized log-mel, so zero is the per-channel
mean). Configured in ``[model]``::

    spec_augment = true
    spec_freq_masks = 2     # number of frequency masks
    spec_freq_width = 10    # max bins per frequency mask
    spec_time_masks = 2     # number of time masks
    spec_time_width = 50    # max frames per time mask
    spec_time_ratio = 0.2   # cap: max fraction of the utterance length

The random numbers come from an explicit ``torch.Generator``
(``spec_augment_draws``) and the masks from a deterministic builder that
takes them (``spec_augment_masks``), in JAX's order: for each mask its
width first, then its start uniform over what the width leaves, the time
widths capped per utterance. ``jax.random`` gives other numbers from the
same seed, so a test feeds the builder JAX's own draws.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch


def parse_spec_augment_conf(conf) -> Optional[dict]:
    """[model] section -> SpecAugment params (None if disabled)."""
    if conf is None or not conf.getbool("spec_augment", False):
        return None
    return {
        "freq_masks": conf.getint("spec_freq_masks", 2),
        "freq_width": conf.getint("spec_freq_width", 10),
        "time_masks": conf.getint("spec_time_masks", 2),
        "time_width": conf.getint("spec_time_width", 50),
        "time_ratio": conf.getfloat("spec_time_ratio", 0.2),
    }


def spec_augment_draws(generator: torch.Generator, B: int, F: int, freq_masks: int = 2,
                       freq_width: int = 10, time_masks: int = 2, device=None,
                       **_) -> Dict[str, torch.Tensor]:
    """The random numbers of one batch's masks: ``freq_w`` [freq_masks, B]
    integer widths in [0, min(freq_width, F - 1)], ``freq_u`` [freq_masks,
    B] and ``time_u_w``, ``time_u_s`` [time_masks, B] uniforms in [0, 1)."""
    fw = min(freq_width, F - 1)

    def uniform(n):
        return torch.rand((n, B), generator=generator, device=device)

    return {
        "freq_w": torch.randint(0, fw + 1, (freq_masks, B), generator=generator, device=device),
        "freq_u": uniform(freq_masks),
        "time_u_w": uniform(time_masks),
        "time_u_s": uniform(time_masks),
    }


def spec_augment_masks(features: torch.Tensor, lengths: torch.Tensor, draws: dict,
                       time_width: int = 50, time_ratio: float = 0.2, **_) -> torch.Tensor:
    """Apply the masks the draws give; returns the features with the masked
    regions 0 (the arithmetic of the JAX package's ``spec_augment``)."""
    B, T, F = features.shape
    dev = features.device
    f32 = torch.float32
    keep = torch.ones((B, T, F), dtype=torch.bool, device=dev)
    t_pos = torch.arange(T, device=dev)[None, :, None]
    f_pos = torch.arange(F, device=dev)[None, None, :]
    for w, u in zip(draws["freq_w"].to(dev), draws["freq_u"].to(dev)):
        w = w.to(torch.int32)[:, None, None]
        start = (u[:, None, None].to(f32) * (F - w + 1).to(f32)).to(torch.int32)
        keep &= ~((f_pos >= start) & (f_pos < start + w))
    lens = lengths.to(dev)
    max_t = torch.clamp(torch.minimum(
        torch.full_like(lens, time_width, dtype=torch.int32),
        (time_ratio * lens.to(f32)).to(torch.int32)), min=0)[:, None, None]
    for u_w, u_s in zip(draws["time_u_w"].to(dev), draws["time_u_s"].to(dev)):
        w = (u_w[:, None, None].to(f32) * (max_t + 1).to(f32)).to(torch.int32)
        span = torch.clamp(lens[:, None, None].to(torch.int32) - w + 1, min=1)
        start = (u_s[:, None, None].to(f32) * span.to(f32)).to(torch.int32)
        keep &= ~((t_pos >= start) & (t_pos < start + w))
    return torch.where(keep, features, torch.zeros((), dtype=features.dtype, device=dev))


def spec_augment(generator: torch.Generator, features: torch.Tensor, lengths: torch.Tensor,
                 **conf) -> torch.Tensor:
    """SpecAugment of a [B, T, F] batch with draws from ``generator`` (on
    the features' device)."""
    B, _, F = features.shape
    draws = spec_augment_draws(generator, B, F, device=features.device, **conf)
    return spec_augment_masks(features, lengths, draws, **conf)
