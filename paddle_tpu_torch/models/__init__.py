"""Model definitions of the port (``paddle_tpu/models/``, imports
switched), and the book programs of ``tests/book/`` (``book``)."""

from paddle_tpu_torch.models import bert  # noqa: F401
from paddle_tpu_torch.models import book  # noqa: F401
from paddle_tpu_torch.models import deepfm  # noqa: F401
from paddle_tpu_torch.models import lstm  # noqa: F401
from paddle_tpu_torch.models import mnist  # noqa: F401
from paddle_tpu_torch.models import mobilenet  # noqa: F401
from paddle_tpu_torch.models import resnet  # noqa: F401
from paddle_tpu_torch.models import se_resnext  # noqa: F401
from paddle_tpu_torch.models import transformer  # noqa: F401
from paddle_tpu_torch.models import vgg  # noqa: F401
from paddle_tpu_torch.models import word2vec  # noqa: F401
