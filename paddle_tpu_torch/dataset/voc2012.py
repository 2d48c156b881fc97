"""VOC2012 segmentation reader (reference:
python/paddle/dataset/voc2012.py — yields (CHW float32 image, HW int32
label map, 21 classes)). Reads ``$PADDLE_GPU_DATA/voc2012/{split}.npz``
(``images`` [N, 3, H, W], ``labels`` [N, H, W]) when present, else
synthesizes images whose segmentation is recoverable from color (each
class painted with its template color + noise).
Port of ``paddle_tpu/dataset/voc2012.py``: the same seeded samples.
"""

import os

import numpy as np

from paddle_tpu_torch.dataset.common import data_path

_CLASSES = 21
_SIZE = 32


def _synthetic(n, seed):
    rng = np.random.RandomState(seed)
    colors = np.random.RandomState(5).rand(_CLASSES, 3).astype(np.float32)
    for _ in range(n):
        # label map: up to 3 rectangles of random classes over background 0
        lbl = np.zeros((_SIZE, _SIZE), np.int32)
        for _ in range(int(rng.randint(1, 4))):
            c = int(rng.randint(1, _CLASSES))
            y0, x0 = rng.randint(0, _SIZE - 8, 2)
            h, w = rng.randint(4, 12, 2)
            lbl[y0:y0 + h, x0:x0 + w] = c
        img = colors[lbl].transpose(2, 0, 1)
        img = img + 0.05 * rng.randn(3, _SIZE, _SIZE).astype(np.float32)
        yield np.clip(img, 0, 1).astype(np.float32), lbl


def _reader(split, n_synth, seed):
    def reader():
        path = data_path("voc2012", split + ".npz")
        if os.path.exists(path):
            d = np.load(path)
            for img, lbl in zip(d["images"], d["labels"]):
                img = img.astype(np.float32)
                if img.max() > 1.5:
                    img = img / 255.0
                yield img, lbl.astype(np.int32)
        else:
            for sample in _synthetic(n_synth, seed):
                yield sample

    return reader


def train():
    return _reader("train", 256, 0)


def test():
    return _reader("test", 64, 1)


def val():
    return _reader("val", 64, 2)
