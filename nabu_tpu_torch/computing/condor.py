"""HTCondor cluster launcher (the port's copy of the JAX package's
``computing/condor.py``).

One job a torch.distributed process, each asking for one GPU, all
running ``python -m nabu_tpu_torch.cli train --distributed`` with their
own ``--process_id``. The submit descriptions go to ``<expdir>/condor/``
so a run can be reproduced and debugged; the job ids ``condor_submit``
returns are recorded in ``<expdir>/condor/jobids`` and ``remove``
``condor_rm``s exactly those (never by pattern or owner).
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
from typing import List, Optional

SUBMIT_TEMPLATE = """\
# written by nabu_tpu_torch.computing.condor
universe = vanilla
executable = {python}
arguments = "-m nabu_tpu_torch.cli train --recipe={recipe} --expdir={expdir} \
--distributed --coordinator={coordinator} --num_processes={num_processes} \
--process_id={process_id}{extra}"
initialdir = {repo_dir}
output = {condor_dir}/proc_{process_id}.out
error = {condor_dir}/proc_{process_id}.err
log = {condor_dir}/proc_{process_id}.log
getenv = True
request_gpus = 1
request_cpus = {request_cpus}
request_memory = {request_memory}
{requirements_line}queue
"""


def write_submit_files(
    expdir: str,
    recipe: str,
    repo_dir: str,
    num_processes: int,
    coordinator: str,
    request_cpus: int = 4,
    request_memory: str = "8G",
    requirements: str = "",
    extra_args: str = "",
    python: str = sys.executable,
) -> List[str]:
    """Write one HTCondor submit description a process; returns paths."""
    condor_dir = os.path.join(expdir, "condor")
    os.makedirs(condor_dir, exist_ok=True)
    requirements_line = f"requirements = {requirements}\n" if requirements else ""
    extra = f" {extra_args}" if extra_args else ""
    paths = []
    for rank in range(num_processes):
        path = os.path.join(condor_dir, f"proc_{rank}.job")
        with open(path, "w") as f:
            f.write(SUBMIT_TEMPLATE.format(
                python=python, recipe=recipe, expdir=expdir, coordinator=coordinator,
                num_processes=num_processes, process_id=rank, repo_dir=repo_dir,
                condor_dir=condor_dir, request_cpus=request_cpus,
                request_memory=request_memory, requirements_line=requirements_line,
                extra=extra,
            ))
        paths.append(path)
    return paths


def _jobids_path(expdir: str) -> str:
    return os.path.join(expdir, "condor", "jobids")


def _recorded(expdir: str) -> Optional[List[str]]:
    path = _jobids_path(expdir)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]


def submit(submit_files: List[str], expdir: str) -> List[str]:
    """condor_submit each file; record and return the job cluster ids."""
    jobids = []
    for path in submit_files:
        out = subprocess.run(["condor_submit", path], check=True, capture_output=True,
                             text=True).stdout
        m = re.search(r"submitted to cluster (\d+)", out)
        if m:
            jobids.append(m.group(1))
    with open(_jobids_path(expdir), "w") as f:
        f.write("\n".join(jobids) + "\n")
    return jobids


def launch(
    expdir: str,
    recipe: str,
    repo_dir: str,
    num_processes: int,
    coordinator_host: str,
    coordinator_port: int = 29500,
    dry_run: bool = False,
    **submit_kwargs,
) -> List[str]:
    """Write the submit files and (unless ``dry_run``) submit them.
    ``coordinator_host`` must be reachable from every node (process 0's
    node, or a head node forwarding to it)."""
    files = write_submit_files(expdir, recipe, repo_dir, num_processes,
                               f"{coordinator_host}:{coordinator_port}", **submit_kwargs)
    if dry_run:
        return []
    return submit(files, expdir)


def remove(expdir: str) -> None:
    """condor_rm exactly the job ids recorded at submit time."""
    jobids = _recorded(expdir)
    if jobids is None:
        return
    if jobids:
        subprocess.run(["condor_rm", *jobids], check=False)
    os.remove(_jobids_path(expdir))


def status(expdir: str) -> Optional[str]:
    """condor_q output for the recorded job ids (None without a record)."""
    jobids = _recorded(expdir)
    if jobids is None:
        return None
    return subprocess.run(["condor_q", *jobids], check=False, capture_output=True,
                          text=True).stdout


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="condor")
    sub = p.add_subparsers(dest="command", required=True)
    lp = sub.add_parser("launch")
    lp.add_argument("--recipe", required=True)
    lp.add_argument("--expdir", required=True)
    lp.add_argument("--repo", default=os.getcwd())
    lp.add_argument("--num_processes", type=int, required=True)
    lp.add_argument("--coordinator_host", required=True)
    lp.add_argument("--port", type=int, default=29500)
    lp.add_argument("--request_cpus", type=int, default=4)
    lp.add_argument("--request_memory", default="8G")
    lp.add_argument("--requirements", default="")
    lp.add_argument("--dry_run", action="store_true",
                    help="write submit files only, do not condor_submit")
    for name in ("rm", "status"):
        sub.add_parser(name).add_argument("--expdir", required=True)
    args = p.parse_args(argv)
    if args.command == "launch":
        jobids = launch(
            args.expdir, args.recipe, args.repo, args.num_processes, args.coordinator_host,
            args.port, dry_run=args.dry_run, request_cpus=args.request_cpus,
            request_memory=args.request_memory, requirements=args.requirements,
        )
        print("submitted:", " ".join(jobids) if jobids else "(dry run)")
    elif args.command == "rm":
        remove(args.expdir)
    else:
        print(status(args.expdir) or "no recorded jobs")
    return 0


if __name__ == "__main__":
    sys.exit(main())
