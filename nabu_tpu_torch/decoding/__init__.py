"""Inference-side decoding: CTC greedy and CTC prefix beam search."""

from nabu_tpu_torch.decoding import recognizers as _recognizers  # noqa: F401
from nabu_tpu_torch.decoding.recognizers import build_recognizer  # noqa: F401
