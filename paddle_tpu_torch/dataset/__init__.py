"""Dataset readers (reference: python/paddle/dataset/ — all 13 reader
modules). Port of ``paddle_tpu/dataset/``. Nothing is downloaded: a
reader reads real files under the ``data`` flag's root
(``PADDLE_GPU_DATA``, read each time a reader starts) when they are
there, in the layout each module names, and otherwise serves the JAX
package's seeded synthetic samples, with the real shapes and
vocabularies."""

from paddle_tpu_torch.dataset import mnist  # noqa: F401
from paddle_tpu_torch.dataset import cifar  # noqa: F401
from paddle_tpu_torch.dataset import imdb  # noqa: F401
from paddle_tpu_torch.dataset import uci_housing  # noqa: F401
from paddle_tpu_torch.dataset import flowers  # noqa: F401
from paddle_tpu_torch.dataset import wmt14  # noqa: F401
from paddle_tpu_torch.dataset import wmt16  # noqa: F401
from paddle_tpu_torch.dataset import movielens  # noqa: F401
from paddle_tpu_torch.dataset import imikolov  # noqa: F401
from paddle_tpu_torch.dataset import conll05  # noqa: F401
from paddle_tpu_torch.dataset import sentiment  # noqa: F401
from paddle_tpu_torch.dataset import mq2007  # noqa: F401
from paddle_tpu_torch.dataset import voc2012  # noqa: F401
