"""paddle.utils (counterpart of paddle_tpu/utils; reference:
python/paddle/utils/)."""
from . import cpp_extension  # noqa: F401
from . import dlpack  # noqa: F401
from . import download  # noqa: F401
from . import install_check  # noqa: F401
from . import monitor  # noqa: F401
from . import profiler  # noqa: F401
from .deprecated import deprecated  # noqa: F401
from .install_check import run_check  # noqa: F401
from .lazy_import import try_import  # noqa: F401
from . import image_util  # noqa: F401
from . import unique_name  # noqa: F401
from .profiler import Profiler, ProfilerOptions, get_profiler  # noqa: F401

#: the framework version this build reports itself compatible with (the
#: reference's)
COMPAT_VERSION = (2, 1, 0)


def require_version(min_version, max_version=None):
    """reference: fluid/framework.py require_version: raise unless the
    compatible version (2.1.0) lies in [min_version, max_version]."""
    import re

    def parse(v):
        nums = []
        for p in (str(v).split(".") + ["0", "0"])[:3]:
            m = re.match(r"\d+", p)  # '0rc1'/'dev0' -> numeric prefix
            nums.append(int(m.group()) if m else 0)
        return tuple(nums)

    if parse(min_version) > COMPAT_VERSION:
        raise Exception(f"paddle_tpu_torch (compat 2.1.0) does not satisfy minimum required "
                        f"version {min_version}")
    if max_version is not None and parse(max_version) < COMPAT_VERSION:
        raise Exception(f"paddle_tpu_torch (compat 2.1.0) exceeds maximum required version "
                        f"{max_version}")


class OpLastCheckpointChecker:
    """reference: utils/op_version.py: the last upgrade checkpoint
    recorded for an op (``framework.op_version``'s registry)."""

    def __init__(self):
        from ..framework import op_version

        self.checkpoints_map = dict(op_version.all_op_versions())

    def get_version(self, op_name, default=1):
        return self.checkpoints_map.get(op_name, default)
