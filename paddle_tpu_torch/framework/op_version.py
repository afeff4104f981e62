"""Op version registry (a copy of paddle_tpu/framework/op_version.py; reference:
paddle/fluid/framework/op_version_registry.h:395 REGISTER_OP_VERSION +
op_compatible_info.cc): per-op semantic version + change notes, saved
into model artifacts and checked on load so old programs fail loudly
(not silently wrong) when an op's semantics moved."""
import warnings

_REGISTRY = {}


class OpVersion:
    def __init__(self, op, version=1):
        self.op = op
        self.version = version
        self.changes = []  # list of (version, note)

    def mod(self, note):
        """Record a semantic change, bumping the version
        (REGISTER_OP_VERSION(...).AddCheckpoint analog)."""
        self.version += 1
        self.changes.append((self.version, note))
        return self


def register_op_version(op, note=None):
    """Register (or bump, when note is given) an op's version."""
    entry = _REGISTRY.setdefault(op, OpVersion(op))
    if note is not None:
        entry.mod(note)
    return entry


def get_op_version(op):
    entry = _REGISTRY.get(op)
    return entry.version if entry else 1


def all_op_versions():
    return {op: e.version for op, e in _REGISTRY.items()}


def check_compat(saved_versions, where="model"):
    """Loaded-artifact check (op_compatible_info.cc analog): warn when
    the saved program used a different op version than the runtime."""
    mismatches = {}
    for op, v in (saved_versions or {}).items():
        cur = get_op_version(op)
        if cur != v:
            mismatches[op] = (v, cur)
    if mismatches:
        warnings.warn(
            f"op version mismatch loading {where}: "
            + ", ".join(f"{op} saved v{sv} vs runtime v{cv}"
                        for op, (sv, cv) in mismatches.items()),
            RuntimeWarning, stacklevel=2)
    return mismatches


# seed versions for ops whose semantics changed across this framework's
# rounds (the registry is additive; plain v1 ops need no entry)
register_op_version("batch_norm_train",
                    "running stats update under traced training (r3)")
register_op_version("take_along_axis")
