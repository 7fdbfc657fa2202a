"""Model components: parameters are nested dicts of tensors with the JAX
package's tree layout; ``apply`` functions are plain functions on
tensors."""

from nabu_tpu_torch.models import encoders as _encoders  # noqa: F401 (registers)
from nabu_tpu_torch.models import decoders as _decoders  # noqa: F401 (registers)
from nabu_tpu_torch.models import transducer as _transducer  # noqa: F401 (registers)
from nabu_tpu_torch.models.model import Model, build_model  # noqa: F401
