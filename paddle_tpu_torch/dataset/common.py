"""Where the dataset readers look for real files: under the ``data``
flag's root (``PADDLE_GPU_DATA``), read each time a reader starts."""

import os

from paddle_tpu_torch import flags


def data_path(*parts):
    """The path of ``parts`` under the ``data`` flag's root, or '' (which
    names no file) when the flag is empty."""
    root = flags.get_flag("data")
    return os.path.join(root, *parts) if root else ""
