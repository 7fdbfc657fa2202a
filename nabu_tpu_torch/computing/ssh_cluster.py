"""Static SSH cluster launcher (the port's copy of the JAX package's
``computing/ssh_cluster.py``).

Reads a cluster file of one line a process (a host with k GPUs listed k
times), starts ``python -m nabu_tpu_torch.cli train --distributed`` on
each line's host with its ``--process_id`` (the first line's host is the
coordinator), and records each remote pid in ``<expdir>/ssh/proc_<i>.pid``
(the expdir is shared by the hosts). ``kill`` stops exactly those pids,
never by pattern.
"""

from __future__ import annotations

import argparse
import os
import shlex
import subprocess
import sys
from typing import List


def read_cluster_file(path: str) -> List[str]:
    hosts = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                hosts.append(line)
    return hosts


def pidfile(expdir: str, rank: int) -> str:
    return os.path.join(expdir, "ssh", f"proc_{rank}.pid")


def launch(
    cluster_file: str,
    recipe: str,
    expdir: str,
    repo_dir: str,
    coordinator_port: int = 29500,
    extra_args: str = "",
    python: str = sys.executable,
) -> List[subprocess.Popen]:
    """Start one training process a line of the cluster file; returns the
    Popens of the ssh processes (each remote pid goes to its pidfile)."""
    hosts = read_cluster_file(cluster_file)
    coordinator = f"{hosts[0]}:{coordinator_port}"
    q = shlex.quote
    procs = []
    for rank, host in enumerate(hosts):
        remote_cmd = (
            f"cd {q(repo_dir)} && mkdir -p {q(os.path.join(expdir, 'ssh'))} && "
            f"nohup {q(python)} -m nabu_tpu_torch.cli train --recipe={q(recipe)} "
            f"--expdir={q(expdir)} --distributed --coordinator={coordinator} "
            f"--num_processes={len(hosts)} --process_id={rank} {extra_args} "
            f"> {q(os.path.join(expdir, f'proc_{rank}.log'))} 2>&1 & "
            f"echo $! > {q(pidfile(expdir, rank))}"
        )
        procs.append(subprocess.Popen(["ssh", "-o", "BatchMode=yes", host, remote_cmd]))
    return procs


def kill(cluster_file: str, expdir: str) -> None:
    """Kill each line's process by its recorded pid (pid-exact, never by
    pattern) and remove the pidfile."""
    for rank, host in enumerate(read_cluster_file(cluster_file)):
        path = shlex.quote(pidfile(expdir, rank))
        subprocess.run(
            ["ssh", "-o", "BatchMode=yes", host,
             f"[ -f {path} ] && kill $(cat {path}) && rm {path} || true"],
            check=False,
        )


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="ssh_cluster")
    sub = p.add_subparsers(dest="command", required=True)
    lp = sub.add_parser("launch")
    lp.add_argument("--cluster", required=True, help="machine-list file")
    lp.add_argument("--recipe", required=True)
    lp.add_argument("--expdir", required=True)
    lp.add_argument("--repo", default=os.getcwd())
    lp.add_argument("--port", type=int, default=29500)
    kp = sub.add_parser("kill")
    kp.add_argument("--cluster", required=True)
    kp.add_argument("--expdir", required=True)
    args = p.parse_args(argv)
    if args.command == "launch":
        procs = launch(args.cluster, args.recipe, args.expdir, args.repo, args.port)
        for proc in procs:
            proc.wait()
        return 1 if any(proc.returncode for proc in procs) else 0
    kill(args.cluster, args.expdir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
