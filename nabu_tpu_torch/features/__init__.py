"""Feature extraction: numpy ``sigproc`` primitives, config-driven host
``computers`` and the device-side ``torch_frontend`` (STFT+Mel kernel)."""

from nabu_tpu_torch.features import computers as _computers  # noqa: F401  (registers)
from nabu_tpu_torch.features.computers import make_feature_computer  # noqa: F401
