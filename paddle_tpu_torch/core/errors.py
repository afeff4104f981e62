"""Structured error taxonomy (a copy of paddle_tpu/core/errors.py): typed
exceptions carrying the reference's error codes, and ``enforce*``."""


class EnforceNotMet(RuntimeError):
    """Base error with an error-code taxonomy mirroring error_codes.proto."""

    code = "LEGACY"

    def __init__(self, message, code=None):
        if code is not None:
            self.code = code
        super().__init__(f"[{self.code}] {message}")


class InvalidArgumentError(EnforceNotMet, ValueError):
    code = "INVALID_ARGUMENT"


class NotFoundError(EnforceNotMet, KeyError):
    code = "NOT_FOUND"


class OutOfRangeError(EnforceNotMet, IndexError):
    code = "OUT_OF_RANGE"


class AlreadyExistsError(EnforceNotMet):
    code = "ALREADY_EXISTS"


class ResourceExhaustedError(EnforceNotMet, MemoryError):
    code = "RESOURCE_EXHAUSTED"


class PreconditionNotMetError(EnforceNotMet):
    code = "PRECONDITION_NOT_MET"


class PermissionDeniedError(EnforceNotMet):
    code = "PERMISSION_DENIED"


class ExecutionTimeoutError(EnforceNotMet, TimeoutError):
    code = "EXECUTION_TIMEOUT"


class UnimplementedError(EnforceNotMet, NotImplementedError):
    code = "UNIMPLEMENTED"


class UnavailableError(EnforceNotMet):
    code = "UNAVAILABLE"


class FatalError(EnforceNotMet):
    code = "FATAL"


class ExternalError(EnforceNotMet):
    code = "EXTERNAL"


def enforce(cond, message="enforce failed", exc=InvalidArgumentError):
    """Analog of PADDLE_ENFORCE: raise ``exc`` when ``cond`` is falsy."""
    if not cond:
        raise exc(message)


def enforce_eq(a, b, message=""):
    if a != b:
        raise InvalidArgumentError(f"expected {a!r} == {b!r}. {message}")


def enforce_shape(shape, expected, message=""):
    if tuple(shape) != tuple(expected):
        raise InvalidArgumentError(
            f"shape mismatch: got {tuple(shape)}, expected {tuple(expected)}. {message}"
        )


def reject_unread(where, **knobs):
    """Raise NotImplementedError for the knobs, given as ``name=(value,
    default)``, whose value is not their default: the reference accepts
    them and never reads them, so the port refuses a value it would
    silently ignore."""
    bad = [name for name, (value, default) in knobs.items() if value != default]
    if bad:
        raise NotImplementedError(f"{where}: {', '.join(bad)} accepted and never read by the "
                                  "reference; leave at the default")
