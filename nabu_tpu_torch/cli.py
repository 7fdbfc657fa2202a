"""Command line of the port.

    python -m nabu_tpu_torch.cli data      --recipe R --expdir E [--num_workers N] [--device cpu]
    python -m nabu_tpu_torch.cli train     --recipe R --expdir E [--device cpu]
                                           [--distributed [--coordinator H:P --num_processes N
                                                           --process_id I]]
                                           [--computing local|ssh|condor --computing_conf C]
    python -m nabu_tpu_torch.cli kill      --computing ssh|condor --computing_conf C --expdir E
    python -m nabu_tpu_torch.cli test      --recipe R --expdir E [--device cpu]
    python -m nabu_tpu_torch.cli decode    --recipe R --expdir E [--device cpu]
    python -m nabu_tpu_torch.cli export    --recipe R --expdir E [--output D] [--device cpu]
    python -m nabu_tpu_torch.cli recognize --recipe R --expdir E AUDIO... [--batch_size N] [--device cpu]
    python -m nabu_tpu_torch.cli serve     --export_dir D [--batch_size N] [--streaming] [--device cpu]
    python -m nabu_tpu_torch.cli lm        --recipe R --expdir E [--order 3] [--targets S]
                                           [--type ngram|rnn] [--lm_units 256] [--lm_layers 1]
                                           [--lm_embed 64] [--lm_steps 500] [--lm_batch 64]
                                           [--lm_lr 1e-3] [--device cpu]
    python -m nabu_tpu_torch.cli rescore   --recipe R --expdir E [--lm P] [--lm_weight 0.3]
                                           [--length_bonus 0] [--device cpu]
    python -m nabu_tpu_torch.cli align     --recipe R --expdir E [--features S] [--targets S]
                                           [--head H] [--device cpu]
    python -m nabu_tpu_torch.cli bpe       --recipe R --expdir E [--vocab_size 500]
                                           [--targets traintargets] [--out P] [--device cpu]
    python -m nabu_tpu_torch.cli sweep     --recipe R --expdir E --sweep F [--device cpu]

``data`` prepares every dataset section of the recipe's database.conf
into ``E/data`` (host work). ``train`` trains the recipe into ``E``
(checkpoints in ``E/checkpoints/{best,latest}``, metrics in
``E/logs/metrics.jsonl``). With ``--distributed`` it is one rank of a
data-parallel group (``parallel.mesh``; one process a GPU, NCCL, or gloo
with ``--device cpu``): the coordinator flags, or torchrun's environment
(``torchrun --nproc_per_node K -m nabu_tpu_torch.cli train --distributed
...``); each rank trains its shard, the global batch is K times the
recipe's. ``--computing ssh|condor`` launches the ranks of a cluster
instead (``computing``, one a line of the ssh cluster file, or one
HTCondor job a GPU), and ``kill`` stops them by their recorded pids or
job ids. ``test`` scores the best checkpoint with
``test_evaluator.cfg`` (``E/test_result.json``); ``decode`` writes
``recognizer.cfg``'s n-best lists to ``E/decoded/nbest.txt`` and prints
the steady-state RTF. ``export`` freezes the best checkpoint and the
configs into a serving artifact (default ``E/export``, the JAX package's
layout); ``recognize`` decodes wav/SPHERE files (or one ``.scp``) with
the best checkpoint and prints ``utt_id hypothesis`` lines. ``serve``
reads ``utt_id wav_path`` lines on stdin and writes ``utt_id
hypothesis`` lines on stdout (with ``--streaming``, ``utt_id PARTIAL
text`` lines as a stream decodes and ``utt_id FINAL text`` at its end).
``lm`` trains an n-gram LM on the recipe's training transcriptions
(``E/lm/lm_{order}gram.npz``, host work) or, with ``--type rnn``, the
LSTM LM (``E/lm/lm_rnn.npz``, on the device), which a beam recognizer
fuses through ``recognizer.cfg``'s ``lm_path`` / ``lm_weight``;
``rescore`` re-ranks ``E/decoded/nbest.txt`` with an LM into
``E/decoded/rescored.txt`` (an n-gram on the host, a neural LM on the
device). ``align`` writes the CTC head's forced alignment of a dataset
(``recognizer.cfg``'s features and targets by default) as CTM lines to
``E/aligned/align.ctm``. ``bpe`` trains a subword vocabulary on a targets
section's transcriptions (``E/bpe/bpe.json``, host work). ``sweep`` runs
``data``, ``train`` and ``test`` for each block of ``file/section/key
value`` overrides in a sweep file, variant i in ``E/sweep_<i>`` with its
patched recipe in ``E/sweep_<i>/recipe``. Whatever runs on a device runs
on the GPU unless ``--device cpu`` is given, and raises without a GPU
otherwise. The JAX package's mesh flags of the model, expert, pipe and
seq axes are not ported yet.
"""

from __future__ import annotations

import argparse
import sys

# the JAX package's mesh flags of the axes beyond data: 1 or not ported yet
_NOT_PORTED_TRAIN_FLAGS = (
    "num_model_parallel", "num_expert_parallel", "num_pipeline", "num_seq_parallel",
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m nabu_tpu_torch.cli",
        description="nabu_tpu_torch: the PyTorch/CUDA port of nabu_tpu",
    )
    sub = p.add_subparsers(dest="command", required=True)
    for name, help_ in (("data", "prepare datasets"), ("train", "train a model"),
                        ("test", "score the trained model"),
                        ("decode", "dump n-best hypotheses"),
                        ("export", "freeze the best model and its configs into a "
                                   "serving artifact"),
                        ("recognize", "decode audio files directly (no data prep)")):
        sp = sub.add_parser(name, help=help_)
        sp.add_argument("--recipe", required=True, help="recipe config dir")
        sp.add_argument("--expdir", required=True, help="experiment dir")
        sp.add_argument("--device", default=None, help="cuda (default) or cpu")
        if name == "data":
            sp.add_argument("--num_workers", type=int, default=0)
        elif name == "export":
            sp.add_argument("--output", default=None,
                            help="artifact directory (default: <expdir>/export)")
        elif name == "recognize":
            sp.add_argument("audio", nargs="+",
                            help="wav/sph paths, or one Kaldi-style .scp file")
            sp.add_argument("--batch_size", type=int, default=8)
        elif name == "train":
            sp.add_argument("--distributed", action="store_true",
                            help="one rank of a data-parallel group")
            sp.add_argument("--coordinator", default=None,
                            help="rank 0's host:port (else torchrun's environment)")
            sp.add_argument("--num_processes", type=int, default=None)
            sp.add_argument("--process_id", type=int, default=None)
            sp.add_argument("--computing", default="local", choices=["local", "ssh", "condor"],
                            help="where the ranks run (see config/computing/)")
            sp.add_argument("--computing_conf", default=None,
                            help="INI file with a [computing] section")
            for flag in _NOT_PORTED_TRAIN_FLAGS:
                sp.add_argument(f"--{flag}", type=int, default=None, help="not ported yet")
    sp = sub.add_parser("kill", help="stop a cluster run launched with --computing")
    sp.add_argument("--computing", required=True, choices=["ssh", "condor"])
    sp.add_argument("--computing_conf", default=None,
                    help="(ssh) INI file with the [computing] section it was launched with")
    sp.add_argument("--expdir", required=True,
                    help="the run's expdir (its pidfiles or condor job ids)")
    sp = sub.add_parser(
        "serve", help="line-protocol decoding worker over an export artifact"
    )
    sp.add_argument("--export_dir", required=True,
                    help="artifact directory written by `export` (either package)")
    sp.add_argument("--batch_size", type=int, default=8)
    sp.add_argument("--streaming", action="store_true",
                    help="chunked incremental decoding (streaming-transducer "
                         "artifacts): PARTIAL and FINAL lines")
    sp.add_argument("--device", default=None,
                    help="cuda (default) or cpu")

    sp = sub.add_parser("lm", help="train an LM from the training transcriptions")
    sp.add_argument("--recipe", required=True, help="recipe config dir")
    sp.add_argument("--expdir", required=True, help="experiment dir")
    sp.add_argument("--order", type=int, default=3)
    sp.add_argument("--targets", default="traintargets",
                    help="database.conf targets section to train on")
    sp.add_argument("--type", dest="lm_type", default="ngram", choices=["ngram", "rnn"],
                    help="ngram (Witten-Bell, host) or rnn (LSTM, trained on the device)")
    # the JAX package's neural-LM hyperparameters (read by --type rnn only)
    for flag, kind, default, help_ in (
            ("lm_units", int, 256, "LSTM units"), ("lm_layers", int, 1, "LSTM layers"),
            ("lm_embed", int, 64, "embedding width"), ("lm_steps", int, 500, "Adam steps"),
            ("lm_batch", int, 64, "sequences a step"),
            ("lm_lr", float, 1e-3, "Adam's constant rate")):
        sp.add_argument(f"--{flag}", type=kind, default=default, help=f"(rnn) {help_}")
    sp.add_argument("--device", default=None, help="(rnn) cuda (default) or cpu")

    sp = sub.add_parser("rescore", help="LM-rescore a decoded n-best list")
    sp.add_argument("--recipe", required=True, help="recipe config dir")
    sp.add_argument("--expdir", required=True, help="experiment dir")
    sp.add_argument("--lm", default=None, help="LM .npz (from `lm`)")
    sp.add_argument("--lm_weight", type=float, default=0.3)
    sp.add_argument("--length_bonus", type=float, default=0.0)
    sp.add_argument("--device", default=None,
                    help="a neural LM's device: cuda (default) or cpu")

    sp = sub.add_parser("align", help="CTC forced alignment of a dataset (CTM output)")
    sp.add_argument("--recipe", required=True, help="recipe config dir")
    sp.add_argument("--expdir", required=True, help="experiment dir")
    sp.add_argument("--features", default=None,
                    help="database.conf features section (default: recognizer.cfg's)")
    sp.add_argument("--targets", default=None,
                    help="database.conf targets section (default: recognizer.cfg's)")
    sp.add_argument("--head", default=None,
                    help="CTC head name (default: the first head with a blank_id)")
    sp.add_argument("--device", default=None, help="cuda (default) or cpu")

    sp = sub.add_parser("bpe", help="train a BPE subword vocabulary")
    sp.add_argument("--recipe", required=True, help="recipe config dir")
    sp.add_argument("--expdir", required=True, help="experiment dir")
    sp.add_argument("--vocab_size", type=int, default=500)
    sp.add_argument("--targets", default="traintargets")
    sp.add_argument("--out", default=None, help="model path (default <expdir>/bpe/bpe.json)")
    sp.add_argument("--device", default=None,
                    help="cuda (default) or cpu; host work, the device is only checked")

    sp = sub.add_parser("sweep", help="train and test recipe variants")
    sp.add_argument("--recipe", required=True, help="recipe config dir")
    sp.add_argument("--expdir", required=True, help="experiment dir")
    sp.add_argument("--sweep", required=True,
                    help="sweep file: blocks of `file/section/key value` lines")
    sp.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p


def _computing_conf(path):
    """The [computing] section of an INI file (config/computing/*.cfg)."""
    from nabu_tpu_torch.config import Conf, ConfigFile

    if path is None:
        return Conf({}, "computing")
    return ConfigFile.read(path).section("computing")


def _cluster_file(conf) -> str:
    cluster_file = conf.get("cluster_file")
    if not cluster_file:
        raise SystemExit("--computing ssh needs cluster_file in --computing_conf")
    return cluster_file


def _launch_cluster(args) -> int:
    """``train --computing ssh|condor``: start one ``train --distributed``
    rank a GPU of the cluster."""
    import os

    conf = _computing_conf(args.computing_conf)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    os.makedirs(args.expdir, exist_ok=True)
    python = conf.get("python", sys.executable)
    if args.computing == "ssh":
        from nabu_tpu_torch.computing import ssh_cluster

        procs = ssh_cluster.launch(_cluster_file(conf), args.recipe, args.expdir, repo,
                                   coordinator_port=conf.getint("port", 29500), python=python)
        for proc in procs:
            proc.wait()
        # any nonzero (a signal's negative code too) is a failure
        return 1 if any(proc.returncode for proc in procs) else 0
    from nabu_tpu_torch.computing import condor

    num_processes = conf.getint("num_processes", args.num_processes or 0)
    coordinator_host = conf.get("coordinator_host")
    if not num_processes or not coordinator_host:
        raise SystemExit("--computing condor needs num_processes and coordinator_host "
                         "in --computing_conf")
    jobids = condor.launch(
        args.expdir, args.recipe, repo, num_processes, coordinator_host,
        coordinator_port=conf.getint("port", 29500), dry_run=conf.getbool("dry_run", False),
        request_cpus=conf.getint("request_cpus", 4),
        request_memory=conf.get("request_memory", "8G"),
        requirements=conf.get("requirements", ""), python=python,
    )
    print("submitted:", " ".join(jobids) if jobids else "(dry run)")
    return 0


def _kill_cluster(args) -> int:
    """``kill``: stop a cluster run by its recorded pids or job ids."""
    if args.computing == "ssh":
        from nabu_tpu_torch.computing import ssh_cluster

        ssh_cluster.kill(_cluster_file(_computing_conf(args.computing_conf)), args.expdir)
    else:
        from nabu_tpu_torch.computing import condor

        condor.remove(args.expdir)
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.command == "data":
        from nabu_tpu_torch.device import resolve_device
        from nabu_tpu_torch.scripts import data

        resolve_device(args.device)
        data.main(args.recipe, args.expdir, num_workers=args.num_workers)
    elif args.command == "train":
        used = [f for f in _NOT_PORTED_TRAIN_FLAGS if getattr(args, f) not in (None, 1)]
        if used:
            raise NotImplementedError(
                f"train flags not ported yet: {', '.join('--' + f for f in used)}")
        if args.computing != "local":
            return _launch_cluster(args)
        from nabu_tpu_torch.scripts import train

        train.main(args.recipe, args.expdir, device=args.device,
                   distributed=args.distributed, coordinator=args.coordinator,
                   num_processes=args.num_processes, process_id=args.process_id)
    elif args.command == "kill":
        return _kill_cluster(args)
    elif args.command == "test":
        from nabu_tpu_torch.scripts import test

        test.main(args.recipe, args.expdir, device=args.device)
    elif args.command == "decode":
        from nabu_tpu_torch.scripts import decode

        decode.main(args.recipe, args.expdir, device=args.device)
    elif args.command == "export":
        from nabu_tpu_torch.serving import export_model

        out = export_model(args.recipe, args.expdir, args.output, device=args.device)
        print(f"[export] wrote serving artifact to {out}")
    elif args.command == "recognize":
        from nabu_tpu_torch.scripts import recognize

        recognize.main(args.recipe, args.expdir, args.audio, args.batch_size,
                       device=args.device)
    elif args.command == "lm":
        from nabu_tpu_torch.scripts import lm

        lm.main(args.recipe, args.expdir, args.order, args.targets, lm_type=args.lm_type,
                num_units=args.lm_units, num_layers=args.lm_layers, embed_dim=args.lm_embed,
                num_steps=args.lm_steps, batch_size=args.lm_batch, learning_rate=args.lm_lr,
                device=args.device)
    elif args.command == "rescore":
        from nabu_tpu_torch.scripts import rescore

        rescore.main(args.recipe, args.expdir, args.lm, args.lm_weight, args.length_bonus,
                     device=args.device)
    elif args.command == "align":
        from nabu_tpu_torch.scripts import align

        align.main(args.recipe, args.expdir, features=args.features, targets=args.targets,
                   head=args.head, device=args.device)
    elif args.command == "bpe":
        from nabu_tpu_torch.device import resolve_device
        from nabu_tpu_torch.scripts import bpe

        resolve_device(args.device)
        bpe.main(args.recipe, args.expdir, vocab_size=args.vocab_size, targets=args.targets,
                 out=args.out)
    elif args.command == "sweep":
        from nabu_tpu_torch.scripts import sweep

        sweep.main(args.recipe, args.expdir, args.sweep, device=args.device)
    elif args.command == "serve":
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
