"""Counterpart of paddle_tpu/dataset/cifar.py (Paddle: python/paddle/dataset/cifar.py):
reader creators yielding
(image[3072] float32 in [0,1], label int)."""
import numpy as np


def _reader(mode, cls):
    from ..vision import datasets as vd

    ds = (vd.Cifar100 if cls == 100 else vd.Cifar10)(mode=mode)

    def reader():
        for i in range(len(ds)):
            img, label = ds[i]
            arr = np.asarray(img, np.float32).reshape(-1)
            if arr.max() > 1.5:
                arr = arr / 255.0
            yield arr, int(np.asarray(label).reshape(()))

    return reader


def train10():
    return _reader("train", 10)


def test10():
    return _reader("test", 10)


def train100():
    return _reader("train", 100)


def test100():
    return _reader("test", 100)
