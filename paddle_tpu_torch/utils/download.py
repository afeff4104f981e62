"""Download helper (counterpart of paddle_tpu/utils/download.py;
reference: python/paddle/utils/download.py). Like the reference, it
resolves a file already in place (in ``root_dir``, checked against its
md5 when one is given, or at the path ``url`` names) and raises on
anything it would have to fetch: the port fetches nothing."""
import hashlib
import os

from ..resilience import chaos
from ..resilience.retry import retry

WEIGHTS_HOME = os.path.expanduser("~/.cache/paddle_tpu_torch/hapi/weights")


@retry(retry_on=(OSError,), base_delay=0.05)
def md5check(fullname, md5sum=None):
    if md5sum is None:
        return True
    chaos.hit("download.md5check")
    md5 = hashlib.md5()
    with open(fullname, "rb") as f:
        for chunk in iter(lambda: f.read(4096), b""):
            md5.update(chunk)
    return md5.hexdigest() == md5sum


def get_path_from_url(url, root_dir=WEIGHTS_HOME, md5sum=None, check_exist=True):
    fname = os.path.join(root_dir, url.split("/")[-1])
    if os.path.exists(fname) and md5check(fname, md5sum):
        return fname
    if os.path.exists(url):
        return url
    raise RuntimeError(f"cannot download {url}: the port fetches nothing; place the file at "
                       f"{fname}")


def get_weights_path_from_url(url, md5sum=None):
    return get_path_from_url(url, WEIGHTS_HOME, md5sum)
