"""Counterpart of paddle_tpu/dataset/imdb.py (Paddle: python/paddle/dataset/imdb.py):
word_dict() + train/test
readers yielding (word-id sequence, 0/1 label).

Synthetic fallback: a two-class unigram language with class-dependent
token distributions — classifiers can genuinely learn it, mirroring the
learnable-template convention of vision/datasets."""
import numpy as np

_VOCAB = 2048
_UNK = _VOCAB - 1


def word_dict():
    return {f"w{i}".encode(): i for i in range(_VOCAB - 1)} | {b"<unk>": _UNK}


def _gen(seed, n):
    rng = np.random.RandomState(seed)
    # class-conditional unigram tables (shared templates across splits)
    trng = np.random.RandomState(7)
    table = trng.dirichlet(np.ones(_VOCAB) * 0.05, size=2)

    def reader():
        for i in range(n):
            label = int(rng.randint(0, 2))
            length = int(rng.randint(16, 64))
            seq = rng.choice(_VOCAB, size=length, p=table[label])
            yield seq.astype(np.int64).tolist(), label

    return reader


def train(word_idx=None):
    return _gen(0, 2000)


def test(word_idx=None):
    return _gen(1, 400)
