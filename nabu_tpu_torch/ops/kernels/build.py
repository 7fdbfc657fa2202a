"""Build the CUDA kernels with nvcc at first use and load them with ctypes.

Each source in ``csrc/`` becomes one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), compiled for
Hopper (``sm_90a``) into ``_build/`` (git-ignored). The library's file
name carries a hash of its source, the headers of ``csrc/`` and the
flags, so an edited source or header is rebuilt and a stale library is
never loaded. Wrappers pass pointers from
``tensor.data_ptr()`` and the stream from
``torch.cuda.current_stream().cuda_stream``.

``python -m nabu_tpu_torch.ops.kernels.build`` builds every kernel in
parallel and prints the compiler's register and shared-memory report.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("stft_mel", "blstm", "blstm_v1", "ctc", "transducer", "lstm")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    for cand in (
        os.environ.get("NVCC"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: the CUDA kernels are built at first use with the "
        "CUDA toolkit (set NVCC or put nvcc on PATH)"
    )


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    key = hashlib.sha256(src + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{key}.so"


def _command(name: str, out: Path, verbose: bool) -> list:
    cmd = [nvcc_path(), *NVCC_FLAGS]
    if verbose:
        cmd.append("-Xptxas=-v")
    return cmd + ["-o", str(out), str(CSRC / f"{name}.cu")]


def build_all(
    names: Iterable[str] = SOURCES, verbose: bool = False
) -> Dict[str, dict]:
    """Build the named kernels that are not built yet, one nvcc process
    per source, all started together. Returns {name: {"seconds",
    "built", "log"}}; raises with the compiler's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    result: Dict[str, dict] = {}
    for name in names:
        out = library_path(name)
        if out.exists() and not verbose:
            result[name] = {"seconds": 0.0, "built": False, "log": ""}
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        procs[name] = (
            subprocess.Popen(
                _command(name, tmp, verbose),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ),
            tmp, out,
        )
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name}.cu (exit {proc.returncode})\n{log}")
            continue
        os.replace(tmp, out)  # atomic: concurrent builds are safe
        result[name] = {
            "seconds": time.perf_counter() - t0, "built": True, "log": log,
        }
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return result


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel source, built if needed."""
    with _lock:
        if name not in _libs:
            path = library_path(name)
            if not path.exists():
                build_all([name])
            _libs[name] = ctypes.CDLL(str(path))
        return _libs[name]


# codes of blstm.cu's TMA GEMM beyond cudaError_t
NO_ENCODER_ERR = 999
TENSOR_MAP_ERR = 1000


def check(err: int, what: str) -> None:
    """Raise on a non-zero code returned by a launch function: a
    cudaError_t, or a tensor map CUDA would not encode."""
    if err == NO_ENCODER_ERR:
        raise RuntimeError(f"{what}: cuTensorMapEncodeTiled is not available")
    if err >= TENSOR_MAP_ERR:
        raise RuntimeError(
            f"{what}: CUDA refused a tensor map (CUresult {err - TENSOR_MAP_ERR})")
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


if __name__ == "__main__":
    for name, info in build_all(verbose=True).items():
        print(f"== {name}: {info['seconds']:.1f} s")
        print(info["log"])
    sys.exit(0)
