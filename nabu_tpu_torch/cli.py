"""Command line of the port.

    python -m nabu_tpu_torch.cli serve --export_dir D [--batch_size N] [--device cpu]

``serve`` reads ``utt_id wav_path`` lines on stdin and writes ``utt_id
hypothesis`` lines on stdout, on the GPU unless ``--device cpu`` is
given. The other subcommands of the JAX package's ``run`` are not ported
yet.
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m nabu_tpu_torch.cli",
        description="nabu_tpu_torch: the PyTorch/CUDA port of nabu_tpu",
    )
    sub = p.add_subparsers(dest="command", required=True)
    sp = sub.add_parser(
        "serve", help="line-protocol decoding worker over an export artifact"
    )
    sp.add_argument("--export_dir", required=True,
                    help="artifact directory written by `run export`")
    sp.add_argument("--batch_size", type=int, default=8)
    sp.add_argument("--streaming", action="store_true",
                    help="chunked incremental decoding (not ported yet)")
    sp.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.command == "serve":
        from nabu_tpu_torch.serving import serve

        serve(
            args.export_dir,
            batch_size=args.batch_size,
            streaming=args.streaming,
            device=args.device,
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
