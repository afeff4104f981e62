"""Filesystem abstraction (counterpart of
paddle_tpu/distributed/fleet/utils/fs.py; reference: fleet/utils/fs.py LocalFS:115,
HDFSClient:419).

Data-moving operations (upload/download/cat/mv) retry transient
OSErrors with backoff (resilience.retry) — these run against shared
filesystems that hiccup under checkpoint storms at pod scale."""
import os
import shutil

from ....resilience import chaos
from ....resilience.retry import retry

_io_retry = retry(retry_on=(OSError,), base_delay=0.05)


class FS:
    def ls_dir(self, path):
        raise NotImplementedError


class LocalFS(FS):
    def ls_dir(self, path):
        if not self.is_exist(path):
            return [], []
        dirs, files = [], []
        for name in os.listdir(path):
            if os.path.isdir(os.path.join(path, name)):
                dirs.append(name)
            else:
                files.append(name)
        return dirs, files

    def mkdirs(self, path):
        os.makedirs(path, exist_ok=True)

    def is_exist(self, path):
        return os.path.exists(path)

    def is_dir(self, path):
        return os.path.isdir(path)

    def is_file(self, path):
        return os.path.isfile(path)

    def delete(self, path):
        if os.path.isdir(path):
            shutil.rmtree(path, ignore_errors=True)
        elif os.path.exists(path):
            os.remove(path)

    @_io_retry
    def mv(self, src, dst, overwrite=False):
        if overwrite and os.path.exists(dst):
            self.delete(dst)
        shutil.move(src, dst)

    @_io_retry
    def upload(self, local_path, fs_path):
        chaos.hit("fs.upload")
        shutil.copy(local_path, fs_path)

    @_io_retry
    def download(self, fs_path, local_path):
        chaos.hit("fs.download")
        shutil.copy(fs_path, local_path)

    @_io_retry
    def touch(self, path, exist_ok=True):
        open(path, "a").close()

    @_io_retry
    def cat(self, path):
        chaos.hit("fs.cat")
        with open(path) as f:
            return f.read()

    def list_dirs(self, path):
        return self.ls_dir(path)[0]


class HDFSClient(FS):
    """HDFS via CLI (reference fs.py:419). Unavailable without a hadoop
    install; raises on use, keeping the API importable."""

    def __init__(self, hadoop_home=None, configs=None, time_out=300000,
                 sleep_inter=1000):
        self._hadoop_home = hadoop_home or os.environ.get("HADOOP_HOME")

    def _unavailable(self):
        raise RuntimeError("HDFS requires a hadoop client (HADOOP_HOME); "
                           "not present in this environment")

    def ls_dir(self, path):
        self._unavailable()

    def is_exist(self, path):
        self._unavailable()

    def upload(self, local_path, fs_path):
        self._unavailable()

    def download(self, fs_path, local_path):
        self._unavailable()
