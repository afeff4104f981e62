"""Register a module under dotted child names in sys.modules (a copy of
paddle_tpu/core/module_alias.py), so that the reference's
``import paddle.x.y.z`` spellings resolve where one module packs several of
the reference's submodules."""
import sys


def alias_submodules(module_name, *child_names, target=None):
    """Alias dotted child names of ``module_name`` to ``target`` (default:
    the module itself)."""
    mod = sys.modules[module_name]
    tgt = target if target is not None else mod
    for child in child_names:
        sys.modules[f"{module_name}.{child}"] = tgt
        setattr(mod, child, tgt)
