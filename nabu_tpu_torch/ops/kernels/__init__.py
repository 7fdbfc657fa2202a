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
    "stft_mel_bf16",
    "blstm_proj",
    "blstm_recur",
    "blstm_recur_train",
    "blstm_bwd_recur",
    "blstm_bwd_dx",
    "blstm_bwd_dwx",
    "blstm_bwd_dwh",
    "blstm_v1_recur",
    "blstm_v1_recur_train",
    "blstm_v1_bwd_gates",
    "blstm_v1_bwd_recur",
    "blstm_v1_bwd_dwh",
    "ctc_alpha",
    "ctc_beta",
    "rnnt_joint_fwd",
    "rnnt_alpha",
    "rnnt_beta",
    "rnnt_joint_bwd",
    "lstm_proj",
    "lstm_fwd",
    "lstm_fwd_train",
    "lstm_bwd_recur",
    "lstm_bwd_dwh",
)

LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}

# launches of each bf16 GEMM of csrc/blstm.cu (the wrappers above that run
# on it count here too, once a launch, by the kernel the shape took)
VARIANTS = ("gemm_bf16_wgmma", "gemm_bf16_wmma")
VARIANT_LAUNCHES: Dict[str, int] = {name: 0 for name in VARIANTS}


def reset_launch_counts() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0
    for name in VARIANTS:
        VARIANT_LAUNCHES[name] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def variant_counts() -> Dict[str, int]:
    return dict(VARIANT_LAUNCHES)
