"""Audio loading and dataset processors (audio -> features, text <-> ids)."""

from nabu_tpu_torch.data import processors as _processors  # noqa: F401 (registers)
