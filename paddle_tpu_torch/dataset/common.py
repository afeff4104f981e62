"""DATA_HOME, download and md5file (counterpart of
paddle_tpu/dataset/common.py). Nothing is downloaded: ``download`` returns
the target path when the file is already there (and its md5 matches) and
raises otherwise. ``DATA_HOME`` is ``$PADDLE_TPU_DATA_HOME``, as in the
reference, else a directory beside this package."""
import hashlib
import os

DATA_HOME = os.path.expanduser(
    os.environ.get("PADDLE_TPU_DATA_HOME",
                   os.path.join(os.path.dirname(os.path.dirname(
                       os.path.abspath(__file__))), "_dataset_cache")))


def md5file(fname):
    h = hashlib.md5()
    with open(fname, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def download(url, module_name, md5sum=None, save_name=None):
    dirname = os.path.join(DATA_HOME, module_name)
    filename = os.path.join(dirname,
                            save_name or url.split("/")[-1])
    if os.path.exists(filename):
        if md5sum is None or md5file(filename) == md5sum:
            return filename
    raise RuntimeError(
        f"dataset file {filename} not present and downloads are disabled in "
        f"this environment; place the file there manually or use the "
        f"synthetic fallback readers")
