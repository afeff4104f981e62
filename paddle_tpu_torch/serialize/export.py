"""The one program wire format (counterpart of paddle_tpu/serialize/
export.py): ``torch.export`` programs, where the reference speaks
``jax.export``'s StableHLO.

- ``serialize_exported`` / ``deserialize_exported``: an
  ``ExportedProgram`` to and from bytes through ``torch.export.save`` /
  ``load``. The example inputs ``torch.export`` keeps on the program are
  dropped before the save: a jit.save program takes its weights as
  runtime inputs, and they would otherwise be written into the program
  (and into its identity). Two saves of one program give the same bytes
  (held by tests/test_torch_jit.py, on the CPU's torch and the card's),
  so the fingerprint hashes the bytes themselves, as the reference does,
  and needs no canonical form.
- ``model_fingerprint``: sha256 over the serialized bytes with the quant
  mode folded in, exactly as the reference hashes.
- ``runtime_version``: the runtime an artifact is tied to, the port's
  triple ``torch-<ver>/cuda-<ver>/<device>`` (``sm_90`` on an H100,
  ``cpu`` without a card) where the reference names jax, jaxlib and its
  backend. It is part of the artifact store's key, so an artifact of
  another runtime is a clean miss.

The programs call the port's kernels as ``torch.library`` custom ops
(``paddle_tpu_torch::flash_attention_fwd``, ``::flash_attention_bwd``,
``::wq_matmul``): ``deserialize_exported`` imports the modules that
register them first. As with the reference's blobs, a reader that cannot
trust the bytes must verify a hash over them before deserializing.
"""
import hashlib
import io


def _register_ops():
    # the ops the programs may name must exist before torch.export.load
    from ..ops import flash_attention, quant_matmul  # noqa: F401


def serialize_exported(exported):
    """``torch.export.ExportedProgram`` -> bytes (the one on-disk format)."""
    import torch

    exported._example_inputs = None
    buf = io.BytesIO()
    torch.export.save(exported, buf)
    return buf.getvalue()


def deserialize_exported(blob):
    """bytes -> ``torch.export.ExportedProgram``. Raises on a malformed or
    incompatible payload."""
    import torch

    _register_ops()
    return torch.export.load(io.BytesIO(blob))


def model_fingerprint(module_bytes, quant=None):
    """Content identity of a saved model: sha256 hex over its serialized
    program bytes, with a serving quant mode (not None/"f32") folded in,
    so a quantized save is a distinct identity."""
    h = hashlib.sha256(module_bytes)
    if quant is not None and quant != "f32":
        h.update(b"\x00quant:" + str(quant).encode("utf-8"))
    return h.hexdigest()


def runtime_version(device=None):
    """The runtime an artifact is tied to, as one stable string:
    ``torch-<ver>/cuda-<ver>/<device>``, the device ``sm_<major><minor>``
    of the current card (or of ``device``, a torch device on a card) or
    ``cpu``. Part of the artifact-store key, so artifacts written by a
    different runtime are never found (a miss, not a corruption)."""
    import torch

    cuda = torch.version.cuda or "none"
    dev = torch.device(device) if device is not None else None
    if dev is not None and dev.type != "cuda":
        where = "cpu"
    elif torch.cuda.is_available():
        major, minor = torch.cuda.get_device_capability(dev)
        where = f"sm_{major}{minor}"
    else:
        where = "cpu"
    return f"torch-{torch.__version__}/cuda-{cuda}/{where}"
