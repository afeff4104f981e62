"""Counterpart of paddle_tpu/dataset/mnist.py (Paddle: python/paddle/dataset/mnist.py):
reader creators yielding
(image[784] float32 in [-1,1], label int) samples."""
import numpy as np


def _reader(mode):
    from ..vision.datasets import MNIST

    ds = MNIST(mode=mode)

    def reader():
        for i in range(len(ds)):
            img, label = ds[i]  # vision MNIST already scales to [-1, 1]
            yield (np.asarray(img, np.float32).reshape(-1),
                   int(np.asarray(label).reshape(())))

    return reader


def train():
    return _reader("train")


def test():
    return _reader("test")
