"""The port's cluster launchers (``nabu_tpu_torch.computing``) and ``cli
train --computing ssh|condor`` / ``cli kill``, mirroring
``tests/test_computing.py`` and the JAX CLI's ssh and condor tests. No
cluster: ``ssh``, ``condor_submit`` and ``condor_rm`` are stub
executables on PATH that record their arguments."""

import os
import stat
import sys

import pytest

from nabu_tpu.computing import condor as jcondor
from nabu_tpu.computing import ssh_cluster as jssh_cluster
from nabu_tpu_torch import cli
from nabu_tpu_torch.computing import condor, ssh_cluster

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _stubs(tmp_path, monkeypatch, **scripts):
    """Executables ``name`` with shell bodies on PATH."""
    bindir = tmp_path / "bin"
    bindir.mkdir(exist_ok=True)
    for name, body in scripts.items():
        path = bindir / name
        path.write_text(f"#!/bin/sh\n{body}\n")
        path.chmod(path.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{bindir}:{os.environ['PATH']}")


def test_read_cluster_file_is_the_jax_packages(tmp_path):
    p = tmp_path / "cluster"
    p.write_text("# head node\nhost-a\n\nhost-b\n  host-c  \nhost-c\n")
    assert ssh_cluster.read_cluster_file(str(p)) == jssh_cluster.read_cluster_file(str(p)) == [
        "host-a", "host-b", "host-c", "host-c"]


def test_condor_submit_files(tmp_path):
    expdir = str(tmp_path / "exp")
    files = condor.write_submit_files(
        expdir, recipe="/r/recipe", repo_dir="/repo", num_processes=3,
        coordinator="head:29500", request_cpus=8, request_memory="16G",
        requirements='(Machine != "badnode")', extra_args="--device cuda",
        python="/venv/bin/python")
    assert len(files) == 3
    text = open(files[1]).read()
    for want in ("executable = /venv/bin/python", '"-m nabu_tpu_torch.cli train',
                 "--process_id=1", "--num_processes=3", "--coordinator=head:29500",
                 "--distributed", "initialdir = /repo", "request_gpus = 1",
                 "request_cpus = 8", "request_memory = 16G",
                 'requirements = (Machine != "badnode")', "--device cuda"):
        assert want in text, want
    ranks = {open(f).read().split("--process_id=")[1].split()[0] for f in files}
    assert ranks == {"0", "1", "2"}
    # the JAX package's description of the same run differs in the program
    # and the GPU request only
    jfiles = jcondor.write_submit_files(
        str(tmp_path / "jexp"), recipe="/r/recipe", repo_dir="/repo", num_processes=3,
        coordinator="head:29500", request_cpus=8, request_memory="16G",
        requirements='(Machine != "badnode")', extra_args="--device cuda")
    jtext = open(jfiles[1]).read()
    assert "request_gpus" not in jtext and "executable = /repo/run" in jtext


def test_condor_dry_run_submit_and_remove(tmp_path, monkeypatch):
    expdir = str(tmp_path / "exp")
    assert condor.launch(expdir, recipe="/r", repo_dir="/repo", num_processes=2,
                         coordinator_host="head", dry_run=True) == []
    assert sorted(os.listdir(os.path.join(expdir, "condor"))) == ["proc_0.job", "proc_1.job"]
    assert condor.status(expdir) is None

    _stubs(tmp_path, monkeypatch,
           condor_submit="echo '1 job(s) submitted to cluster 4'",
           condor_rm=f'echo "$@" > {tmp_path}/rm_args',
           condor_q='echo "q $@"')
    files = [os.path.join(expdir, "condor", f"proc_{r}.job") for r in range(2)]
    assert condor.submit(files, expdir) == ["4", "4"]
    assert condor.status(expdir).split() == ["q", "4", "4"]
    assert cli.main(["kill", "--computing", "condor", "--expdir", expdir]) == 0
    assert open(tmp_path / "rm_args").read().split() == ["4", "4"]
    assert not os.path.exists(os.path.join(expdir, "condor", "jobids"))


def test_train_computing_condor_dry_run(tmp_path):
    """``cli train --computing condor`` writes one submit description a
    rank, each of this interpreter and one GPU."""
    conf = tmp_path / "condor.cfg"
    conf.write_text("[computing]\nnum_processes = 3\ncoordinator_host = head\n"
                    "dry_run = true\nrequest_cpus = 2\n")
    expdir = str(tmp_path / "exp")
    assert cli.main(["train", "--recipe=/r", f"--expdir={expdir}", "--computing=condor",
                     f"--computing_conf={conf}"]) == 0
    jobs = sorted(os.listdir(os.path.join(expdir, "condor")))
    assert jobs == ["proc_0.job", "proc_1.job", "proc_2.job"]
    text = open(os.path.join(expdir, "condor", "proc_2.job")).read()
    assert "--process_id=2" in text and "--coordinator=head:29500" in text
    assert f"executable = {sys.executable}" in text and f"initialdir = {REPO}" in text
    assert "request_gpus = 1" in text and "request_cpus = 2" in text


def test_train_computing_ssh_and_kill(tmp_path, monkeypatch):
    """``cli train --computing ssh``: one remote rank a line of the
    machine list (a host with two cards listed twice), each recording its
    pid; ``cli kill --computing ssh`` kills exactly those pids."""
    _stubs(tmp_path, monkeypatch, ssh=f'echo "$@" >> {tmp_path}/ssh_calls')
    machines = tmp_path / "machines.txt"
    machines.write_text("host-a\nhost-a\nhost-b\n")
    conf = tmp_path / "ssh.cfg"
    conf.write_text(f"[computing]\ncluster_file = {machines}\nport = 1234\n"
                    "python = /venv/bin/python\n")
    expdir = str(tmp_path / "exp")
    assert cli.main(["train", "--recipe=/r", f"--expdir={expdir}", "--computing=ssh",
                     f"--computing_conf={conf}"]) == 0
    calls = open(tmp_path / "ssh_calls").read().strip().splitlines()
    assert len(calls) == 3
    for rank, (call, host) in enumerate(zip(calls, ("host-a", "host-a", "host-b"))):
        assert call.startswith(f"-o BatchMode=yes {host} "), call
        for want in ("/venv/bin/python -m nabu_tpu_torch.cli train", "--distributed",
                     "--coordinator=host-a:1234", "--num_processes=3",
                     f"--process_id={rank}", f"cd {REPO}",
                     f"echo $! > {ssh_cluster.pidfile(expdir, rank)}"):
            assert want in call, (rank, want)

    os.remove(tmp_path / "ssh_calls")
    assert cli.main(["kill", "--computing", "ssh", f"--computing_conf={conf}",
                     "--expdir", expdir]) == 0
    calls = open(tmp_path / "ssh_calls").read().strip().splitlines()
    assert len(calls) == 3
    for rank, call in enumerate(calls):
        path = ssh_cluster.pidfile(expdir, rank)
        assert f"kill $(cat {path})" in call and f"rm {path}" in call
        assert "pkill" not in call and "killall" not in call


def test_ssh_launch_reports_a_failed_ssh(tmp_path, monkeypatch):
    _stubs(tmp_path, monkeypatch, ssh="exit 255")
    machines = tmp_path / "machines.txt"
    machines.write_text("host-a\n")
    conf = tmp_path / "ssh.cfg"
    conf.write_text(f"[computing]\ncluster_file = {machines}\n")
    assert cli.main(["train", "--recipe=/r", f"--expdir={tmp_path / 'exp'}",
                     "--computing=ssh", f"--computing_conf={conf}"]) == 1


@pytest.mark.parametrize("name", ["condor.cfg", "ssh.cfg"])
def test_the_repos_computing_confs_are_read_as_they_are(name):
    conf = cli._computing_conf(os.path.join(REPO, "config", "computing", name))
    if name == "condor.cfg":
        assert conf.getint("num_processes") == 4 and conf.get("coordinator_host") == "head-node"
        assert conf.getint("request_cpus") == 8 and conf.get("request_memory") == "16G"
    else:
        assert cli._cluster_file(conf) == "config/computing/machines.txt"
    assert conf.getint("port") == 29500


def test_missing_settings_and_unported_axes_raise(tmp_path):
    conf = tmp_path / "empty.cfg"
    conf.write_text("[computing]\n")
    for computing in ("ssh", "condor"):
        with pytest.raises(SystemExit, match="needs"):
            cli.main(["train", "--recipe=/r", f"--expdir={tmp_path / 'exp'}",
                      f"--computing={computing}", f"--computing_conf={conf}"])
    with pytest.raises(SystemExit, match="needs cluster_file"):
        cli.main(["kill", "--computing", "ssh", f"--computing_conf={conf}",
                  "--expdir", str(tmp_path)])
    for flag in ("num_model_parallel", "num_expert_parallel", "num_pipeline",
                 "num_seq_parallel"):
        with pytest.raises(NotImplementedError, match=f"--{flag}"):
            cli.main(["train", "--recipe=/r", "--expdir=/e", "--computing=condor",
                      f"--{flag}", "2"])
