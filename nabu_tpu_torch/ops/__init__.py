"""Tensor ops: masking, CTC helpers, and the wrappers of the CUDA kernels
(``stft_mel``, ``blstm``), each beside its plain PyTorch version."""
