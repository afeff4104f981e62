"""Vision datasets (counterpart of paddle_tpu/vision/datasets.py): MNIST,
FashionMNIST, Cifar10/100, VOC2012, Flowers, DatasetFolder, ImageFolder.

Nothing is downloaded. MNIST reads the IDX files under
``$PADDLE_TPU_DATA_HOME/mnist`` (default ``~/.cache/paddle_tpu/dataset``,
the reference's, so both packages find the same local files) when they are
there, else, like every other dataset here, a deterministic synthetic
fallback bitwise the reference's arrays (class-conditional templates shared
between the splits, the same ``RandomState`` seeds), on which models learn.
``DatasetFolder`` and ``ImageFolder`` read real image trees through PIL,
imported when the first image is loaded. Samples are host numpy arrays.
"""
import gzip
import os
import struct

import numpy as np

from ..io.dataset import Dataset

_DATA_HOME = os.path.expanduser(os.environ.get("PADDLE_TPU_DATA_HOME",
                                               "~/.cache/paddle_tpu/dataset"))


def _synthetic_images(n, num_classes, hw, channels, seed, template_seed=1234):
    """Class-conditional Gaussian-blob images: class k has a fixed random
    template (shared between train/test splits — template_seed), samples are
    template + per-split noise (seed). Linearly separable enough for smoke
    training, hard enough that accuracy tracks learning."""
    h, w = hw
    t_rng = np.random.RandomState(template_seed + num_classes * h)
    templates = t_rng.uniform(0.0, 1.0, size=(num_classes, channels, h, w)).astype(
        np.float32)
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, num_classes, size=n).astype(np.int64)
    noise = rng.normal(0, 0.35, size=(n, channels, h, w)).astype(np.float32)
    images = np.clip(templates[labels] + noise, 0.0, 1.0)
    return images, labels


class MNIST(Dataset):
    """reference: vision/datasets/mnist.py (IDX file format)."""

    _DIR = "mnist"
    _SEEDS = (42, 43)          # (train, test) sample noise seeds
    _TEMPLATE_SEED = 1234      # class templates (shared across splits)

    def __init__(self, image_path=None, label_path=None, mode="train",
                 transform=None, download=True, backend="cv2"):
        self.mode = mode
        self.transform = transform
        base = os.path.join(_DATA_HOME, self._DIR)
        prefix = "train" if mode == "train" else "t10k"
        image_path = image_path or os.path.join(base, f"{prefix}-images-idx3-ubyte.gz")
        label_path = label_path or os.path.join(base, f"{prefix}-labels-idx1-ubyte.gz")
        if os.path.exists(image_path) and os.path.exists(label_path):
            self.images, self.labels = self._parse_idx(image_path, label_path)
        else:
            n = 8192 if mode == "train" else 1024
            imgs, labels = _synthetic_images(
                n, 10, (28, 28), 1,
                seed=self._SEEDS[0] if mode == "train" else self._SEEDS[1],
                template_seed=self._TEMPLATE_SEED)
            self.images = (imgs[:, 0] * 255).astype(np.uint8)
            self.labels = labels

    @staticmethod
    def _parse_idx(image_path, label_path):
        with gzip.open(image_path, "rb") as f:
            magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
            images = np.frombuffer(f.read(), np.uint8).reshape(n, rows, cols)
        with gzip.open(label_path, "rb") as f:
            magic, n = struct.unpack(">II", f.read(8))
            labels = np.frombuffer(f.read(), np.uint8).astype(np.int64)
        return images, labels

    def __getitem__(self, idx):
        img = self.images[idx].astype(np.float32)[None]  # [1, 28, 28]
        img = img / 127.5 - 1.0
        if self.transform is not None:
            img = self.transform(img)
        return img, np.asarray(self.labels[idx], np.int64)

    def __len__(self):
        return len(self.labels)


class FashionMNIST(MNIST):
    """reference: vision/datasets/mnist.py:180 — same IDX format, its own
    files/cache dir; the synthetic fallback uses distinct class templates
    so MNIST- and FashionMNIST-trained models are not interchangeable."""

    _DIR = "fashion-mnist"
    _SEEDS = (52, 53)
    _TEMPLATE_SEED = 5678


class Cifar10(Dataset):
    """reference: vision/datasets/cifar.py."""

    NUM_CLASSES = 10

    def __init__(self, data_file=None, mode="train", transform=None, download=True,
                 backend="cv2"):
        self.mode = mode
        self.transform = transform
        n = 8192 if mode == "train" else 1024
        imgs, labels = _synthetic_images(n, self.NUM_CLASSES, (32, 32), 3,
                                         seed=44 if mode == "train" else 45)
        self.images = imgs
        self.labels = labels

    def __getitem__(self, idx):
        img = self.images[idx]
        if self.transform is not None:
            img = self.transform(img)
        return img, np.asarray(self.labels[idx], np.int64)

    def __len__(self):
        return len(self.labels)


class Cifar100(Cifar10):
    NUM_CLASSES = 100


class VOC2012(Dataset):
    """Semantic segmentation pairs (image [3,H,W] float, mask [H,W] int64
    in 0..20) (reference: vision/datasets/voc2012.py). Synthetic
    fallback: class-colored rectangles on background 0 — the mask is
    exactly recoverable from the image, so segmentation models can fit."""

    NUM_CLASSES = 21

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=True, backend="cv2"):
        if mode not in ("train", "valid", "test"):
            raise ValueError(f"mode must be train/valid/test, got {mode!r}")
        self.transform = transform
        n = 512 if mode == "train" else 128
        hw = 64
        rng = np.random.RandomState({"train": 60, "valid": 61,
                                     "test": 62}[mode])
        trng = np.random.RandomState(4321)
        palette = trng.uniform(0.2, 1.0, size=(self.NUM_CLASSES, 3)) \
            .astype(np.float32)
        palette[0] = 0.05  # background
        self.images = np.zeros((n, 3, hw, hw), np.float32)
        self.masks = np.zeros((n, hw, hw), np.int64)
        for i in range(n):
            img = np.broadcast_to(palette[0].reshape(3, 1, 1),
                                  (3, hw, hw)).copy()
            mask = np.zeros((hw, hw), np.int64)
            for _ in range(int(rng.randint(1, 4))):
                cls = int(rng.randint(1, self.NUM_CLASSES))
                y0, x0 = rng.randint(0, hw - 8, size=2)
                dy, dx = rng.randint(8, 24, size=2)
                img[:, y0:y0 + dy, x0:x0 + dx] = palette[cls].reshape(3, 1, 1)
                mask[y0:y0 + dy, x0:x0 + dx] = cls
            noise = rng.normal(0, 0.02, size=img.shape).astype(np.float32)
            self.images[i] = np.clip(img + noise, 0, 1)
            self.masks[i] = mask

    def __getitem__(self, idx):
        img = self.images[idx]
        if self.transform is not None:
            img = self.transform(img)
        return img, self.masks[idx]

    def __len__(self):
        return len(self.images)


IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".pgm", ".tif",
                  ".tiff", ".webp")


def _pil_loader(path):
    from PIL import Image

    with open(path, "rb") as f:
        img = Image.open(f)
        return np.asarray(img.convert("RGB"))


class DatasetFolder(Dataset):
    """``root/class_x/xxx.ext`` directory-tree dataset (reference:
    vision/datasets/folder.py:65). Fully real — no synthetic fallback;
    images load via PIL as HWC uint8 arrays."""

    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        self.root = root
        self.loader = loader or _pil_loader
        self.transform = transform
        extensions = extensions or IMG_EXTENSIONS
        classes = sorted(e.name for e in os.scandir(root) if e.is_dir())
        if not classes:
            raise RuntimeError(f"no class folders found in {root}")
        self.classes = classes
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        if is_valid_file is None:
            def is_valid_file(p):
                return p.lower().endswith(tuple(extensions))
        self.samples = []
        for c in classes:
            d = os.path.join(root, c)
            for dirpath, _, fnames in sorted(os.walk(d)):
                for fname in sorted(fnames):
                    p = os.path.join(dirpath, fname)
                    if is_valid_file(p):
                        self.samples.append((p, self.class_to_idx[c]))
        if not self.samples:
            raise RuntimeError(f"no valid files found under {root}")

    def __getitem__(self, idx):
        path, target = self.samples[idx]
        img = self.loader(path)
        if self.transform is not None:
            img = self.transform(img)
        return img, np.asarray(target, np.int64)

    def __len__(self):
        return len(self.samples)


class ImageFolder(Dataset):
    """Flat (unlabeled) image-folder dataset yielding ``[img]`` rows
    (reference: vision/datasets/folder.py:222)."""

    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        self.root = root
        self.loader = loader or _pil_loader
        self.transform = transform
        extensions = extensions or IMG_EXTENSIONS
        if is_valid_file is None:
            def is_valid_file(p):
                return p.lower().endswith(tuple(extensions))
        self.samples = []
        for dirpath, _, fnames in sorted(os.walk(root)):
            for fname in sorted(fnames):
                p = os.path.join(dirpath, fname)
                if is_valid_file(p):
                    self.samples.append(p)
        if not self.samples:
            raise RuntimeError(f"no valid files found under {root}")

    def __getitem__(self, idx):
        img = self.loader(self.samples[idx])
        if self.transform is not None:
            img = self.transform(img)
        return [img]

    def __len__(self):
        return len(self.samples)


class Flowers(Dataset):
    def __init__(self, data_file=None, label_file=None, setid_file=None,
                 mode="train", transform=None, download=True, backend="cv2"):
        n = 2048 if mode == "train" else 512
        imgs, labels = _synthetic_images(n, 102, (64, 64), 3, seed=46)
        self.images = imgs
        self.labels = labels
        self.transform = transform

    def __getitem__(self, idx):
        img = self.images[idx]
        if self.transform is not None:
            img = self.transform(img)
        return img, np.asarray(self.labels[idx], np.int64)

    def __len__(self):
        return len(self.labels)


from ..core.module_alias import alias_submodules as _alias

_alias(__name__, "mnist", "cifar", "flowers", "folder", "voc2012")
