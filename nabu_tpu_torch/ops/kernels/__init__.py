"""Hand-written CUDA kernels for Hopper (sources in ``csrc/``, built by
``build.py``) and their launch counts.

Each kernel wrapper adds one to ``LAUNCHES[name]`` where it launches its
kernel, and nowhere else, so a run can show that its main path went
through the kernels. The plain versions (CPU tensors) do not count.
"""

from __future__ import annotations

from typing import Dict

KERNELS = (
    "stft_mel",
    "blstm_proj",
    "blstm_recur",
    "blstm_recur_train",
    "blstm_bwd_recur",
    "blstm_bwd_dx",
    "blstm_bwd_dwx",
    "blstm_bwd_dwh",
    "ctc_alpha",
    "ctc_beta",
    "rnnt_joint_fwd",
    "rnnt_alpha",
    "rnnt_beta",
    "rnnt_joint_bwd",
)

LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}


def reset_launch_counts() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)
