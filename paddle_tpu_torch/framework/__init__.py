"""paddle.framework (counterpart of paddle_tpu/framework): ``save``/``load``,
``ParamAttr``, ``in_dygraph_mode`` and the default dtype.

``save(obj, path)`` pickles a nested dict/list/tuple in the reference's
format, so files pass between the two packages: a ``Tensor`` or
``Parameter`` becomes ``{"__tensor__": True, "data": ndarray, "name",
"stop_gradient"}``, any other torch tensor (a layer's buffer, an
optimizer's accumulator) a plain ndarray, as the reference's optimizer
state is; ndarrays, numbers and strings stay as they are. Tensors are
copied to the host first. A bfloat16 tensor, which numpy cannot hold
without ml_dtypes (the card's machine has none), is written as its raw
16-bit words with ``"dtype": "bfloat16"`` in its dict, and read back
bitwise by the port (the reference reads such a file as uint16). The write
is atomic: a temp file in the same directory, fsynced, then
``os.replace``d, so a crash or a pickling error leaves the previous file.

``load(path, return_numpy=False)`` gives the tensors back as ``Tensor``s
on the current place (the card unless ``set_device`` said otherwise), or
as ndarrays with ``return_numpy=True`` (a bfloat16 one as its float32
upcast); plain ndarrays stay ndarrays, as in the reference. A
reference-written bfloat16 array (ml_dtypes) loads through its raw words.
"""
import os
import pickle

import numpy as np
import torch

from ..core import place as place_mod
from ..core.tensor import Parameter, Tensor, to_tensor
from .param_attr import ParamAttr, WeightNormParamAttr  # noqa: F401


def _host_array(t):
    """(ndarray, dtype tag or None) of a torch tensor, on the host."""
    t = torch.Tensor.detach(t).cpu()
    if t.dtype == torch.bfloat16:
        return torch.Tensor.numpy(t.view(torch.int16)).view(np.uint16).copy(), "bfloat16"
    return torch.Tensor.numpy(t).copy(), None


def _to_saveable(obj):
    if isinstance(obj, (Tensor, Parameter)):
        data, tag = _host_array(obj)
        out = {"__tensor__": True, "data": data, "name": obj.name,
               "stop_gradient": obj.stop_gradient}
        if tag:
            out["dtype"] = tag
        return out
    if isinstance(obj, torch.Tensor):
        data, tag = _host_array(obj)
        if tag:
            return {"__tensor__": True, "data": data, "name": None, "stop_gradient": True,
                    "dtype": tag}
        return data
    if isinstance(obj, dict):
        return {k: _to_saveable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_saveable(v) for v in obj)
    return obj


def _stored(obj):
    """The torch tensor (host) a saved tensor dict holds."""
    data = obj["data"]
    if obj.get("dtype") == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(data).view(np.int16)).view(torch.bfloat16)
    return data


def _from_saveable(obj, return_numpy=False):
    if isinstance(obj, dict):
        if obj.get("__tensor__"):
            data = _stored(obj)
            if return_numpy:
                if isinstance(data, torch.Tensor):
                    return torch.Tensor.numpy(data.float())
                return data
            if isinstance(data, np.ndarray) and data.dtype.name == "bfloat16":
                data = torch.from_numpy(data.view(np.uint16).astype(np.int16)).view(
                    torch.bfloat16)
            t = to_tensor(data, stop_gradient=obj.get("stop_gradient", True))
            t.name = obj.get("name")
            return t
        return {k: _from_saveable(v, return_numpy) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_from_saveable(v, return_numpy) for v in obj)
    return obj


def save(obj, path, protocol=4, **configs):
    """paddle.save: the reference's pickle of a (nested) state, written
    atomically (see the module docstring)."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = os.path.join(d or ".", f".{os.path.basename(path)}.tmp.{os.getpid()}")
    try:
        with open(tmp, "wb") as f:
            pickle.dump(_to_saveable(obj), f, protocol=protocol)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise


def load(path, **configs):
    """paddle.load: the inverse of ``save`` (see the module docstring)."""
    with open(path, "rb") as f:
        obj = pickle.load(f)
    return _from_saveable(obj, return_numpy=configs.get("return_numpy", False))


def get_default_dtype():
    from ..core.dtype import get_default_dtype as g

    return g()


def set_default_dtype(d):
    from ..core.dtype import set_default_dtype as s

    return s(d)


# compat names
CPUPlace = place_mod.CPUPlace
CUDAPlace = place_mod.CUDAPlace


def in_dygraph_mode():
    """False after ``paddle.enable_static()``: the one flag that
    ``paddle.in_dynamic_mode`` reads (jit/__init__.py)."""
    from ..jit import in_dynamic_mode

    return in_dynamic_mode()
