"""paddle.hub (counterpart of paddle_tpu/hub.py; reference:
python/paddle/hub.py): torch-hub-style model loading through a repo's
``hubconf.py``. Only ``source='local'``, as in the reference: the port
fetches nothing, and a github/gitee source raises."""
import importlib.util
import os
import sys

__all__ = ["list", "help", "load"]

_HUBCONF = "hubconf.py"


def _load_hubconf(repo_dir):
    path = os.path.join(repo_dir, _HUBCONF)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {_HUBCONF} in {repo_dir}")
    spec = importlib.util.spec_from_file_location("paddle_tpu_torch_hubconf", path)
    module = importlib.util.module_from_spec(spec)
    sys.path.insert(0, repo_dir)
    try:
        spec.loader.exec_module(module)
    finally:
        sys.path.remove(repo_dir)
    return module


def _check_source(source):
    if source != "local":
        raise NotImplementedError(
            f"hub source {source!r}: the port fetches nothing; clone the repo and use "
            "source='local'")


def list(repo_dir, source="local", force_reload=False):  # noqa: A001
    """Entrypoint names exposed by the repo's hubconf.py."""
    _check_source(source)
    module = _load_hubconf(repo_dir)
    return [n for n in dir(module)
            if callable(getattr(module, n)) and not n.startswith("_")]


def help(repo_dir, model, source="local", force_reload=False):  # noqa: A001
    _check_source(source)
    module = _load_hubconf(repo_dir)
    if not hasattr(module, model):
        raise ValueError(f"{model!r} not found in {repo_dir}/{_HUBCONF}")
    return getattr(module, model).__doc__


def load(repo_dir, model, *args, source="local", force_reload=False,
         **kwargs):
    """Instantiate ``model`` from the repo's hubconf.py entrypoint."""
    _check_source(source)
    module = _load_hubconf(repo_dir)
    if not hasattr(module, model):
        raise ValueError(f"{model!r} not found in {repo_dir}/{_HUBCONF}")
    return getattr(module, model)(*args, **kwargs)
