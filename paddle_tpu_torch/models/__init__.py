"""Model definitions of the port (``paddle_tpu/models/``, imports switched)."""

from paddle_tpu_torch.models import bert  # noqa: F401
from paddle_tpu_torch.models import deepfm  # noqa: F401
from paddle_tpu_torch.models import mnist  # noqa: F401
from paddle_tpu_torch.models import resnet  # noqa: F401
from paddle_tpu_torch.models import transformer  # noqa: F401
from paddle_tpu_torch.models import word2vec  # noqa: F401
