#!/usr/bin/env python3
"""Profile the port's CTC prefix beam search on the GPU.

    python3 tools/profile_torch_decode.py [--frames 300] [--batch 32] [--beam 16]

Runs ``nabu_tpu_torch.decoding.ctc_beam.ctc_prefix_beam_search`` on
seeded random log-probs (vocab 29, the dblstm_ctc_wsj alphabet plus
blank) once to warm up, then under ``torch.profiler`` and prints the
wall time per frame, the device's busy time (kernel rows only) and idle
share, and the top operators by device time and by host time.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=300)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--beam", type=int, default=16)
    ap.add_argument("--vocab", type=int, default=29)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("profile_torch_decode: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from nabu_tpu_torch.decoding.ctc_beam import ctc_prefix_beam_search

    rng = np.random.default_rng(0)
    B, T, V = args.batch, args.frames, args.vocab
    logits = torch.as_tensor(3.0 * rng.standard_normal((B, T, V)).astype(np.float32))
    lp = torch.log_softmax(logits, -1).cuda()
    lens = torch.full((B,), T, dtype=torch.int32, device="cuda")

    def run():
        out = ctc_prefix_beam_search(lp, lens, args.beam, V - 1)
        torch.cuda.synchronize()
        return out

    run()
    t0 = time.perf_counter()
    run()
    wall = time.perf_counter() - t0
    print(f"wall {wall:.4f} s for {T} frames: {wall / T * 1e3:.4f} ms/frame "
          f"(B={B}, W={args.beam}, V={V}, Lmax={T}) on {torch.cuda.get_device_name(0)}")

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        prof_wall = time.perf_counter() - t0
    events = prof.key_averages()
    # device time is counted on the kernel rows only: an aten op's row
    # repeats the time of the kernels it launched
    dev_s = sum(
        e.self_device_time_total for e in events
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation
    ) / 1e6
    # the profiler slows the host side, so the idle share is taken against
    # the unprofiled wall time
    print(f"device busy {dev_s:.4f} s (profiled run: {prof_wall:.4f} s wall); "
          f"idle share {1.0 - dev_s / wall:.4f} of the {wall:.4f} s unprofiled run")
    print(events.table(sort_by="self_device_time_total", row_limit=15))
    print(events.table(sort_by="self_cpu_time_total", row_limit=15))
    return 0


if __name__ == "__main__":
    sys.exit(main())
