"""Distributed execution of the port: the JAX package's ``data`` mesh
axis as a torch.distributed process group (one process per GPU, NCCL on
the card, gloo on the CPU). The ``model``, ``expert``, ``pipe`` and
``seq`` axes are not ported yet."""
