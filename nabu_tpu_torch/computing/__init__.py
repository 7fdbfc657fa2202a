"""Cluster launchers of the port (its own copies of the JAX package's
``computing`` modules).

Every process runs the same ``python -m nabu_tpu_torch.cli train
--distributed --coordinator H:P --num_processes N --process_id i``; the
processes form one torch.distributed group (``parallel.mesh``), one
process a GPU. Where the JAX package runs one process a host, a host
with k cards here runs k processes.

- ``ssh_cluster``: one process a line of a machine-list file (a host
  with k cards listed k times; its processes take ``cuda:0..k-1`` in
  line order), each pid in ``<expdir>/ssh/proc_<i>.pid``, killed by
  that pid, never by pattern;
- ``condor``: one HTCondor job a process (``request_gpus = 1``), the
  submit files in ``<expdir>/condor/``, removed by the recorded job ids.

On one host, ``torchrun --nproc_per_node K -m nabu_tpu_torch.cli train
--distributed ...`` starts the same group without a launcher.
"""
