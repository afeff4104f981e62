"""The port's vision transforms and datasets, text datasets and the legacy
``paddle.dataset`` readers against the JAX package's, on the CPU: every
transform and functional on the same seeded images (numpy's global
generator seeded alike before each) bitwise, or within 1e-6 where the
reference computes in float32 (hue's HSV round trip); the synthetic MNIST,
FashionMNIST, Cifar10/100, Flowers and VOC2012 arrays bitwise; MNIST's IDX
parser on written files; DatasetFolder/ImageFolder over a temporary tree
(needs PIL); the text datasets' and readers' first samples equal."""
import gzip
import os
import struct

import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu_torch.core import place as tplace

TOL_HUE = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu():
    prev = tplace._CURRENT
    tp.set_device("cpu")
    yield
    tplace._CURRENT = prev


def _np(v):
    v = getattr(v, "_value", v)
    return np.array(v.detach() if isinstance(v, torch.Tensor) else v)


IMG_U8 = np.random.RandomState(0).randint(0, 256, (12, 10, 3)).astype(np.uint8)
IMG_F = np.random.RandomState(1).rand(3, 12, 10).astype(np.float32)

TRANSFORMS = [
    ("ToTensor", (), {}),
    ("Normalize", ([0.5, 0.4, 0.3], [0.2, 0.25, 0.3]), {}),
    ("Resize", (7,), {}),
    ("Resize", ((5, 9),), {}),
    ("CenterCrop", (6,), {}),
    ("RandomCrop", (8,), {"padding": 2}),
    ("RandomHorizontalFlip", (), {"prob": 0.5}),
    ("RandomVerticalFlip", (), {"prob": 0.5}),
    ("RandomResizedCrop", (6,), {}),
    ("Transpose", (), {}),
    ("BrightnessTransform", (0.4,), {}),
    ("Pad", (2,), {}),
    ("ContrastTransform", (0.5,), {}),
    ("SaturationTransform", ((0.2, 1.5),), {}),
    ("HueTransform", (0.3,), {}),
    ("ColorJitter", (0.3, 0.3, 0.3, 0.2), {}),
    ("Grayscale", (3,), {}),
    ("RandomRotation", (30,), {}),
]


def _apply(pkg, name, args, kw, img, seed):
    np.random.seed(seed)
    t = getattr(pkg.vision.transforms, name)(*args, **kw)
    return [_np(t(img)) for _ in range(3)]


@pytest.mark.parametrize("name,args,kw", TRANSFORMS, ids=lambda v: str(v)[:24])
@pytest.mark.parametrize("kind", ["uint8_hwc", "float_chw"])
def test_transform_matches_the_reference(name, args, kw, kind):
    img = IMG_U8 if kind == "uint8_hwc" else IMG_F
    if name == "Transpose" and kind == "float_chw":
        img = np.transpose(IMG_F, (1, 2, 0))
    want = _apply(jp, name, args, kw, img, 3)
    got = _apply(tp, name, args, kw, img, 3)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        if name in ("HueTransform", "ColorJitter"):
            assert np.abs(g.astype(np.float64) - w).max() <= TOL_HUE * max(np.abs(w).max(), 1)
        else:
            assert np.array_equal(g, w), name


FUNCTIONALS = [
    ("to_tensor", ()), ("normalize", ([0.1, 0.2, 0.3], [0.5, 0.5, 0.5])), ("resize", (6,)),
    ("hflip", ()), ("vflip", ()), ("to_grayscale", (1,)), ("adjust_brightness", (1.3,)),
    ("adjust_contrast", (0.7,)), ("adjust_hue", (0.2,)), ("rotate", (17.0,)),
]


@pytest.mark.parametrize("name,args", FUNCTIONALS, ids=lambda v: str(v)[:20])
def test_functional_matches_the_reference(name, args):
    for img in (IMG_U8, IMG_F):
        want = _np(getattr(jp.vision.transforms, name)(img, *args))
        got = _np(getattr(tp.vision.transforms, name)(img, *args))
        assert got.shape == want.shape and got.dtype == want.dtype
        if name == "adjust_hue":
            assert np.abs(got - want).max() <= TOL_HUE * max(np.abs(want).max(), 1)
        else:
            assert np.array_equal(got, want), name
    assert tp.vision.transforms.functional is tp.vision.transforms


def test_to_tensor_gives_a_host_tensor_and_unread_knobs_raise():
    out = tp.vision.transforms.ToTensor()(IMG_U8)
    assert isinstance(out, tp.Tensor) and out.place == tp.CPUPlace() and out.shape == [3, 12, 10]
    for make in (lambda T: T.ToTensor(data_format="HWC"), lambda T: T.Resize(4, "nearest"),
                 lambda T: T.Normalize(0.5, 0.5, to_rgb=True),
                 lambda T: T.RandomHorizontalFlip(keys=("image",)),
                 lambda T: T.RandomRotation(10, expand=True)):
        with pytest.raises(NotImplementedError):
            make(tp.vision.transforms)


@pytest.mark.parametrize("name,kw", [
    ("MNIST", {"mode": "train"}), ("MNIST", {"mode": "test"}), ("FashionMNIST", {}),
    ("Cifar10", {}), ("Cifar100", {"mode": "test"}), ("Flowers", {}),
    ("VOC2012", {"mode": "valid"}),
])
def test_synthetic_datasets_bitwise(name, kw):
    j = getattr(jp.vision.datasets, name)(**kw)
    t = getattr(tp.vision.datasets, name)(**kw)
    assert len(t) == len(j)
    assert np.array_equal(t.images, j.images) and t.images.dtype == j.images.dtype
    labels = "masks" if name == "VOC2012" else "labels"
    assert np.array_equal(getattr(t, labels), getattr(j, labels))
    for i in (0, len(j) - 1):
        for a, b in zip(t[i], j[i]):
            assert np.array_equal(_np(a), _np(b))


def _write_idx(tmp, images, labels):
    ip, lp = str(tmp / "img-idx3-ubyte.gz"), str(tmp / "lbl-idx1-ubyte.gz")
    with gzip.open(ip, "wb") as f:
        f.write(struct.pack(">IIII", 2051, *images.shape) + images.tobytes())
    with gzip.open(lp, "wb") as f:
        f.write(struct.pack(">II", 2049, len(labels)) + labels.tobytes())
    return ip, lp


def test_mnist_reads_idx_files(tmp_path):
    rng = np.random.RandomState(2)
    images = rng.randint(0, 256, (5, 28, 28)).astype(np.uint8)
    labels = rng.randint(0, 10, 5).astype(np.uint8)
    ip, lp = _write_idx(tmp_path, images, labels)
    t = tp.vision.datasets.MNIST(image_path=ip, label_path=lp, mode="test")
    j = jp.vision.datasets.MNIST(image_path=ip, label_path=lp, mode="test")
    assert np.array_equal(t.images, images) and np.array_equal(t.labels, j.labels)
    assert np.array_equal(t[3][0], _np(j[3][0])) and t[3][0].shape == (1, 28, 28)


def test_dataset_folder_and_image_folder(tmp_path):
    Image = pytest.importorskip("PIL.Image")
    rng = np.random.RandomState(3)
    for cls in ("cat", "dog"):
        os.makedirs(tmp_path / cls)
        for k in range(2):
            Image.fromarray(rng.randint(0, 256, (6, 5, 3)).astype(np.uint8)).save(
                tmp_path / cls / f"{k}.png")
    (tmp_path / "cat" / "notes.txt").write_text("skipped")
    t = tp.vision.datasets.DatasetFolder(str(tmp_path))
    j = jp.vision.datasets.DatasetFolder(str(tmp_path))
    assert t.classes == j.classes == ["cat", "dog"] and len(t) == len(j) == 4
    for i in range(4):
        assert np.array_equal(t[i][0], j[i][0]) and int(t[i][1]) == int(j[i][1])
    ti, ji = tp.vision.datasets.ImageFolder(str(tmp_path)), jp.vision.datasets.ImageFolder(
        str(tmp_path))
    assert len(ti) == len(ji) == 4 and np.array_equal(ti[2][0], ji[2][0])


@pytest.mark.parametrize("name,kw", [
    ("UCIHousing", {}), ("Imdb", {"mode": "test"}), ("Imikolov", {"data_type": "NGRAM",
                                                                  "window_size": 3}),
    ("Movielens", {"mode": "test"}), ("WMT14", {"mode": "gen"}), ("WMT16", {}),
    ("Conll05st", {}),
])
def test_text_datasets_first_samples(name, kw):
    j = getattr(jp.text, name)(**kw)
    t = getattr(tp.text, name)(**kw)
    assert len(t) == len(j)
    for i in (0, 1, len(j) - 1):
        got, want = t[i], j[i]
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("reader", ["mnist.train", "mnist.test", "cifar.train10",
                                    "cifar.test100", "imdb.train", "uci_housing.test",
                                    "movielens.train"])
def test_legacy_readers_first_samples(reader):
    mod, fn = reader.split(".")
    want = getattr(getattr(jp.dataset, mod), fn)()()
    got = getattr(getattr(tp.dataset, mod), fn)()()
    for _ in range(3):
        for a, b in zip(next(got), next(want)):
            assert np.array_equal(np.asarray(a), np.asarray(b))
    assert tp.dataset.imdb.word_dict() == jp.dataset.imdb.word_dict()
    with pytest.raises(RuntimeError, match="downloads are disabled"):
        tp.dataset.common.download("http://example.invalid/x.tar", "nowhere")


def test_batch_reader():
    def reader():
        yield from range(5)

    assert list(tp.batch(reader, 2)()) == [[0, 1], [2, 3], [4]]
    assert list(tp.batch(reader, 2, drop_last=True)()) == [[0, 1], [2, 3]]
