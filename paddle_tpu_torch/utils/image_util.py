"""paddle.utils.image_util (counterpart of paddle_tpu/utils/image_util.py;
reference: python/paddle/utils/image_util.py
— simple image array helpers used by legacy examples)."""
import numpy as np

__all__ = ["resize_image", "flip_image", "crop_img"]


def resize_image(img, target_size):
    """Nearest-neighbor resize of an HWC/CHW array to target_size."""
    arr = np.asarray(img)
    chw = arr.ndim == 3 and arr.shape[0] in (1, 3, 4)
    h_ax, w_ax = (1, 2) if chw else (0, 1)
    h, w = arr.shape[h_ax], arr.shape[w_ax]
    ys = (np.arange(target_size) * (h / target_size)).astype(np.int64)
    xs = (np.arange(target_size) * (w / target_size)).astype(np.int64)
    return np.take(np.take(arr, ys, axis=h_ax), xs, axis=w_ax)


def flip_image(img):
    arr = np.asarray(img)
    chw = arr.ndim == 3 and arr.shape[0] in (1, 3, 4)
    return arr[:, :, ::-1] if chw else arr[:, ::-1]


def crop_img(img, size, center=True):
    arr = np.asarray(img)
    chw = arr.ndim == 3 and arr.shape[0] in (1, 3, 4)
    h_ax, w_ax = (1, 2) if chw else (0, 1)
    h, w = arr.shape[h_ax], arr.shape[w_ax]
    if center:
        y0, x0 = (h - size) // 2, (w - size) // 2
    else:
        y0 = np.random.randint(0, h - size + 1)
        x0 = np.random.randint(0, w - size + 1)
    sl = [slice(None)] * arr.ndim
    sl[h_ax] = slice(y0, y0 + size)
    sl[w_ax] = slice(x0, x0 + size)
    return arr[tuple(sl)]
