"""paddle.dataset (counterpart of paddle_tpu/dataset): the legacy
reader-generator corpora (mnist, cifar, imdb, uci_housing, movielens) over
the vision and text datasets. Nothing is downloaded: the readers give the
reference's deterministic synthetic samples, bitwise. Each submodule keeps
the generator-of-samples contract: ``train()``/``test()`` return a
callable yielding sample tuples of host numpy arrays and numbers.
"""
from . import cifar, common, imdb, mnist, movielens, uci_housing  # noqa: F401

__all__ = ["mnist", "cifar", "imdb", "uci_housing", "movielens", "common"]
