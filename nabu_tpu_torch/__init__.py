"""nabu_tpu_torch — the PyTorch/CUDA port of nabu_tpu.

A second package beside the JAX one, with the same module layout so
each counterpart is easy to find. It imports ``torch`` and never
``jax``, and nothing of ``nabu_tpu``: the JAX-free modules it needs
(config, registry, audio I/O, numpy feature computers, processors) are
its own copies. The TPU's Pallas kernels become hand-written CUDA
kernels for Hopper (``ops/kernels/csrc``), each with a plain PyTorch
version beside it that the CPU path and the tests use.

Ported so far: the serving path of the DBLSTM-CTC recipe
(``serving.load_exported`` / ``serving.serve`` / ``cli serve``).
"""

__version__ = "0.1.0"
