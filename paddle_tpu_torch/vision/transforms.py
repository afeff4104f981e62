"""Transforms (counterpart of paddle_tpu/vision/transforms.py): every
transform and functional of the reference, on numpy (CHW arrays; an HWC
image is turned to CHW by ``_chw``), with the reference's arithmetic and
its draws from numpy's global generator, so a seeded pipeline gives the
reference's arrays. They run where the DataLoader's workers run, so none
touches CUDA: ``ToTensor`` gives a host Tensor, which the loader moves to
the current place in the parent.

Knobs the reference accepts and never reads (``keys``, ``ToTensor``'s and
``Normalize``'s ``data_format``, ``to_rgb``, the ``interpolation`` of
``Resize`` and ``RandomResizedCrop``, ``RandomCrop``'s ``pad_if_needed``,
``fill`` and ``padding_mode``, ``Pad``'s ``fill`` and ``padding_mode``,
``RandomRotation``'s ``interpolation``, ``expand`` and ``center``) raise
at a value other than their default.
"""
import numpy as np
import torch

from ..core.errors import reject_unread as _unread
from ..core.tensor import wrap


def _host(img):
    """A host ndarray of an image (a Tensor or torch tensor included)."""
    if isinstance(img, torch.Tensor):
        return torch.Tensor.numpy(torch.Tensor.detach(img).cpu())
    return np.asarray(img)


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, data):
        for t in self.transforms:
            data = t(data)
        return data


class BaseTransform:
    def __call__(self, img):
        return self._apply_image(_host(img))

    def _apply_image(self, img):
        raise NotImplementedError


def _chw(img):
    if img.ndim == 2:
        return img[None]
    if img.shape[0] in (1, 3, 4):
        return img
    return np.transpose(img, (2, 0, 1))


class ToTensor(BaseTransform):
    def __init__(self, data_format="CHW", keys=None):
        _unread("ToTensor", data_format=(data_format, "CHW"), keys=(keys, None))
        self.data_format = data_format

    def _apply_image(self, img):
        img = _chw(np.asarray(img))
        if img.dtype == np.uint8:
            img = img.astype(np.float32) / 255.0
        return wrap(torch.from_numpy(np.ascontiguousarray(img, dtype=np.float32)))


class Normalize(BaseTransform):
    def __init__(self, mean=0.0, std=1.0, data_format="CHW", to_rgb=False, keys=None):
        _unread("Normalize", data_format=(data_format, "CHW"), to_rgb=(to_rgb, False),
                keys=(keys, None))
        self.mean = np.asarray(mean, np.float32).reshape(-1, 1, 1)
        self.std = np.asarray(std, np.float32).reshape(-1, 1, 1)

    def _apply_image(self, img):
        arr = np.asarray(_host(img), np.float32)
        arr = _chw(arr)
        return (arr - self.mean) / self.std


class Resize(BaseTransform):
    def __init__(self, size, interpolation="bilinear", keys=None):
        _unread("Resize", interpolation=(interpolation, "bilinear"), keys=(keys, None))
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def _apply_image(self, img):
        img = _chw(np.asarray(img))
        c, h, w = img.shape
        oh, ow = self.size
        ys = (np.arange(oh) * (h / oh)).astype(np.int64).clip(0, h - 1)
        xs = (np.arange(ow) * (w / ow)).astype(np.int64).clip(0, w - 1)
        return img[:, ys][:, :, xs]


class CenterCrop(BaseTransform):
    def __init__(self, size, keys=None):
        _unread("CenterCrop", keys=(keys, None))
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def _apply_image(self, img):
        img = _chw(np.asarray(img))
        c, h, w = img.shape
        th, tw = self.size
        i = max((h - th) // 2, 0)
        j = max((w - tw) // 2, 0)
        return img[:, i:i + th, j:j + tw]


class RandomCrop(BaseTransform):
    def __init__(self, size, padding=None, pad_if_needed=False, fill=0,
                 padding_mode="constant", keys=None):
        _unread("RandomCrop", pad_if_needed=(pad_if_needed, False), fill=(fill, 0),
                padding_mode=(padding_mode, "constant"), keys=(keys, None))
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.padding = padding

    def _apply_image(self, img):
        img = _chw(np.asarray(img))
        if self.padding:
            p = self.padding if isinstance(self.padding, int) else self.padding[0]
            img = np.pad(img, ((0, 0), (p, p), (p, p)))
        c, h, w = img.shape
        th, tw = self.size
        i = np.random.randint(0, h - th + 1)
        j = np.random.randint(0, w - tw + 1)
        return img[:, i:i + th, j:j + tw]


class RandomHorizontalFlip(BaseTransform):
    def __init__(self, prob=0.5, keys=None):
        _unread("RandomHorizontalFlip", keys=(keys, None))
        self.prob = prob

    def _apply_image(self, img):
        img = _chw(np.asarray(img))
        if np.random.rand() < self.prob:
            return img[:, :, ::-1].copy()
        return img


class RandomVerticalFlip(BaseTransform):
    def __init__(self, prob=0.5, keys=None):
        _unread("RandomVerticalFlip", keys=(keys, None))
        self.prob = prob

    def _apply_image(self, img):
        img = _chw(np.asarray(img))
        if np.random.rand() < self.prob:
            return img[:, ::-1].copy()
        return img


class RandomResizedCrop(BaseTransform):
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation="bilinear", keys=None):
        _unread("RandomResizedCrop", interpolation=(interpolation, "bilinear"),
                keys=(keys, None))
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.scale = scale
        self.ratio = ratio

    def _apply_image(self, img):
        img = _chw(np.asarray(img))
        c, h, w = img.shape
        area = h * w
        for _ in range(10):
            target_area = np.random.uniform(*self.scale) * area
            ar = np.exp(np.random.uniform(np.log(self.ratio[0]), np.log(self.ratio[1])))
            tw = int(round(np.sqrt(target_area * ar)))
            th = int(round(np.sqrt(target_area / ar)))
            if 0 < tw <= w and 0 < th <= h:
                i = np.random.randint(0, h - th + 1)
                j = np.random.randint(0, w - tw + 1)
                crop = img[:, i:i + th, j:j + tw]
                return Resize(self.size)._apply_image(crop)
        return Resize(self.size)._apply_image(img)


class Transpose(BaseTransform):
    def __init__(self, order=(2, 0, 1), keys=None):
        _unread("Transpose", keys=(keys, None))
        self.order = order

    def _apply_image(self, img):
        return np.transpose(np.asarray(img), self.order)


def _jitter_range(value, name, center=1.0):
    """Normalize a jitter knob to a (lo, hi) sample range (reference
    transforms.py _check_input): a float v maps to
    [max(0, center-v), center+v]; a (lo, hi) pair is used directly."""
    if isinstance(value, (list, tuple)):
        lo, hi = float(value[0]), float(value[1])
        if lo > hi or lo < 0:
            raise ValueError(f"{name} range must satisfy 0 <= lo <= hi, "
                             f"got {value}")
        return lo, hi
    if value < 0:
        raise ValueError(f"{name} value must be non-negative")
    return max(0.0, center - float(value)), center + float(value)


def _ceiling(img):
    """Value ceiling for clipping: integer images (uint8 PIL/ndarray) live
    in [0, 255] by dtype; for floats the value heuristic is the only
    signal left, so a dark [0, 255]-float image must be passed here
    BEFORE any float32 conversion of an integer original."""
    img = np.asarray(img)
    if np.issubdtype(img.dtype, np.integer):
        return 255.0
    return 255.0 if img.size and img.max() > 1.5 else 1.0


class BrightnessTransform(BaseTransform):
    def __init__(self, value, keys=None):
        _unread("BrightnessTransform", keys=(keys, None))
        self.range = _jitter_range(value, "brightness")

    def _apply_image(self, img):
        raw = np.asarray(img)
        img = raw.astype(np.float32)
        return np.clip(img * np.random.uniform(*self.range), 0,
                       _ceiling(raw))


class Pad(BaseTransform):
    def __init__(self, padding, fill=0, padding_mode="constant", keys=None):
        _unread("Pad", fill=(fill, 0), padding_mode=(padding_mode, "constant"),
                keys=(keys, None))
        self.padding = padding if isinstance(padding, int) else padding[0]

    def _apply_image(self, img):
        img = _chw(np.asarray(img))
        p = self.padding
        return np.pad(img, ((0, 0), (p, p), (p, p)))


def _gray(img):
    """Luminance over a CHW image (Rec.601 weights, reference:
    transforms/functional_tensor.py to_grayscale)."""
    if img.shape[0] == 1:
        return img[0]
    w = np.asarray([0.299, 0.587, 0.114], np.float32)
    return np.tensordot(w, img[:3].astype(np.float32), axes=1)


class ContrastTransform(BaseTransform):
    """reference: transforms.py:737 — blend with the mean gray level."""

    def __init__(self, value, keys=None):
        _unread("ContrastTransform", keys=(keys, None))
        self.range = _jitter_range(value, "contrast")

    def _apply_image(self, img):
        raw = np.asarray(img)
        img = _chw(raw.astype(np.float32))
        alpha = np.random.uniform(*self.range)
        mean = _gray(img).mean()
        return np.clip(alpha * img + (1 - alpha) * mean, 0, _ceiling(raw))


class SaturationTransform(BaseTransform):
    """reference: transforms.py:775 — blend with per-pixel grayscale."""

    def __init__(self, value, keys=None):
        _unread("SaturationTransform", keys=(keys, None))
        self.range = _jitter_range(value, "saturation")

    def _apply_image(self, img):
        raw = np.asarray(img)
        img = _chw(raw.astype(np.float32))
        alpha = np.random.uniform(*self.range)
        gray = _gray(img)[None]
        return np.clip(alpha * img + (1 - alpha) * gray, 0, _ceiling(raw))


def _rgb_to_hsv(img):
    """img: [3, H, W] in [0, 1] -> h, s, v arrays."""
    r, g, b = img
    maxc = np.max(img, axis=0)
    minc = np.min(img, axis=0)
    v = maxc
    delta = maxc - minc
    s = np.where(maxc > 0, delta / np.maximum(maxc, 1e-12), 0.0)
    safe = np.maximum(delta, 1e-12)
    h = np.where(maxc == r, (g - b) / safe % 6,
                 np.where(maxc == g, (b - r) / safe + 2,
                          (r - g) / safe + 4)) / 6.0
    return np.where(delta == 0, 0.0, h), s, v


def _hsv_to_rgb(h, s, v):
    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i.astype(np.int64) % 6
    choices = [(v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v),
               (v, p, q)]
    r = np.select([i == k for k in range(6)], [c[0] for c in choices])
    g = np.select([i == k for k in range(6)], [c[1] for c in choices])
    b = np.select([i == k for k in range(6)], [c[2] for c in choices])
    return np.stack([r, g, b]).astype(np.float32)


class HueTransform(BaseTransform):
    """reference: transforms.py:811 — shift hue in HSV space."""

    def __init__(self, value, keys=None):
        _unread("HueTransform", keys=(keys, None))
        if isinstance(value, (list, tuple)):
            lo, hi = float(value[0]), float(value[1])
            if not -0.5 <= lo <= hi <= 0.5:
                raise ValueError(f"hue range must be within [-0.5, 0.5], "
                                 f"got {value}")
            self.range = (lo, hi)
        else:
            if not 0 <= value <= 0.5:
                raise ValueError("hue value must be in [0, 0.5]")
            self.range = (-float(value), float(value))

    def _apply_image(self, img):
        raw = np.asarray(img)
        img = _chw(raw.astype(np.float32))
        if img.shape[0] == 1:
            return img
        scale = _ceiling(raw)
        h, s, v = _rgb_to_hsv(img[:3] / scale)
        shift = np.random.uniform(*self.range)
        out = _hsv_to_rgb((h + shift) % 1.0, s, v) * scale
        return np.concatenate([out, img[3:]]) if img.shape[0] > 3 else out


class ColorJitter(BaseTransform):
    """reference: transforms.py:848 — random-order composition of
    brightness/contrast/saturation/hue perturbations."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0,
                 keys=None):
        _unread("ColorJitter", keys=(keys, None))
        self.parts = []
        if brightness:
            self.parts.append(BrightnessTransform(brightness))
        if contrast:
            self.parts.append(ContrastTransform(contrast))
        if saturation:
            self.parts.append(SaturationTransform(saturation))
        if hue:
            self.parts.append(HueTransform(hue))

    def _apply_image(self, img):
        for k in np.random.permutation(len(self.parts)):
            img = self.parts[k]._apply_image(img)
        return img


class Grayscale(BaseTransform):
    """reference: transforms.py:1176."""

    def __init__(self, num_output_channels=1, keys=None):
        _unread("Grayscale", keys=(keys, None))
        if num_output_channels not in (1, 3):
            raise ValueError("num_output_channels must be 1 or 3")
        self.num_output_channels = num_output_channels

    def _apply_image(self, img):
        img = _chw(np.asarray(img))
        g = _gray(img.astype(np.float32))[None]
        if self.num_output_channels == 3:
            g = np.repeat(g, 3, axis=0)
        return g.astype(img.dtype) if img.dtype == np.uint8 else g


class RandomRotation(BaseTransform):
    """reference: transforms.py:1090 — rotate by a random angle in
    ``degrees`` about the center (nearest-neighbor resampling,
    expand=False semantics: output keeps the input size)."""

    def __init__(self, degrees, interpolation="nearest", expand=False,
                 center=None, fill=0, keys=None):
        _unread("RandomRotation", interpolation=(interpolation, "nearest"),
                expand=(expand, False), center=(center, None), keys=(keys, None))
        if isinstance(degrees, (int, float)):
            if degrees < 0:
                raise ValueError("degrees must be non-negative")
            self.degrees = (-degrees, degrees)
        else:
            self.degrees = tuple(degrees)
        self.fill = fill

    def _apply_image(self, img):
        img = _chw(np.asarray(img))
        angle = np.deg2rad(np.random.uniform(*self.degrees))
        c, h, w = img.shape
        cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
        yy, xx = np.mgrid[0:h, 0:w]
        # inverse mapping: sample source = R(-angle) @ (dst - center)
        cos, sin = np.cos(angle), np.sin(angle)
        sy = cos * (yy - cy) - sin * (xx - cx) + cy
        sx = sin * (yy - cy) + cos * (xx - cx) + cx
        syi = np.round(sy).astype(np.int64)
        sxi = np.round(sx).astype(np.int64)
        valid = (syi >= 0) & (syi < h) & (sxi >= 0) & (sxi < w)
        out = np.full_like(img, self.fill)
        out[:, valid] = img[:, syi[valid], sxi[valid]]
        return out


def to_tensor(pic, data_format="CHW"):
    return ToTensor(data_format)(pic)


def normalize(img, mean, std, data_format="CHW", to_rgb=False):
    return Normalize(mean, std, data_format)(img)


def resize(img, size, interpolation="bilinear"):
    return Resize(size, interpolation)(img)


def hflip(img):
    return _chw(np.asarray(img))[:, :, ::-1].copy()


def vflip(img):
    return _chw(np.asarray(img))[:, ::-1].copy()


def to_grayscale(img, num_output_channels=1):
    return Grayscale(num_output_channels)(img)


def adjust_brightness(img, brightness_factor):
    img = _chw(np.asarray(img, np.float32))
    return np.clip(img * brightness_factor, 0,
                   255.0 if img.max() > 1.5 else 1.0)


def adjust_contrast(img, contrast_factor):
    img = _chw(np.asarray(img, np.float32))
    mean = _gray(img).mean()
    return np.clip(contrast_factor * img + (1 - contrast_factor) * mean, 0,
                   255.0 if img.max() > 1.5 else 1.0)


def adjust_hue(img, hue_factor):
    if not -0.5 <= hue_factor <= 0.5:
        raise ValueError("hue_factor must be in [-0.5, 0.5]")
    img = _chw(np.asarray(img, np.float32))
    if img.shape[0] == 1:
        return img
    scale = 255.0 if img.max() > 1.5 else 1.0
    h, s, v = _rgb_to_hsv(img[:3] / scale)
    return _hsv_to_rgb((h + hue_factor) % 1.0, s, v) * scale


def rotate(img, angle, interpolation="nearest", expand=False, center=None,
           fill=0):
    t = RandomRotation((angle, angle), fill=fill)
    return t._apply_image(np.asarray(img))


from ..core.module_alias import alias_submodules as _alias

_alias(__name__, "functional", "transforms")
