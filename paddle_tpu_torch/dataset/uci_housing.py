"""Counterpart of paddle_tpu/dataset/uci_housing.py (Paddle: python/paddle/dataset/uci_housing.py):
(13-feature, price)
regression samples, feature-normalized."""
import numpy as np


def _reader(mode):
    from ..text import UCIHousing

    ds = UCIHousing(mode=mode)

    def reader():
        for i in range(len(ds)):
            x, y = ds[i]
            yield np.asarray(x, np.float32), np.asarray(y, np.float32)

    return reader


def train():
    return _reader("train")


def test():
    return _reader("test")
