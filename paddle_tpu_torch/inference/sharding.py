"""Serving mesh: split a served model's weights over shards once at load
(counterpart of paddle_tpu/inference/sharding.py).

- :class:`ServingMesh` is the reference's canonical descriptor
  (``"single"``, ``"tp2"``, ``"fsdp2"``, ``"fsdp2xtp2"``; ``"mp<k>"`` is
  an alias of ``"tp<k>"``), parsed from ``serve_model(mesh=)``,
  ``DecodeEngine(mesh=)``, ``BatchingEngine.for_layer(mesh=)`` or the
  ``PADDLE_TPU_SERVING_MESH`` environment variable (:func:`resolve`). The
  descriptor is its identity in stats, metrics labels, ledger events and
  kv-snapshot headers.
- **The placement rule** (:meth:`ServingMesh.param_spec`, the
  reference's): an array of 2 or more dims has its first dim over fsdp
  (the topology's "sharding" axis) and its last over tp (its "mp" axis),
  each only where it divides; a 1-D array goes over tp where it divides;
  a 0-D array is replicated. The port gives the rule as a tuple of axis
  names or None per dim where the reference gives a ``PartitionSpec``.
- **Two backings** (:meth:`ServingMesh.build`). (a) Devices in one
  process: shard ``(f, t)`` lives on ``devices[f * tp + t]``, by default
  ``cuda:0 .. cuda:n-1``; a list that repeats a device (``["cpu"] * n``,
  ``["cuda:0"] * n``) is the counterpart of the reference's
  ``--xla_force_host_platform_device_count`` and is only ever explicit.
  (b) Launcher ranks: in a ``torch.distributed`` job whose world is the
  mesh's shard count, through ``distributed.topology.build_mesh`` with tp
  on "mp" and fsdp on "sharding" (the reference's mapping); each rank
  holds only its own blocks.
- :class:`ShardedWeight` is a weight the mesh splits: its blocks, their
  devices and the split axis per dim. ``wmatmul`` (ops/quant_matmul.py)
  and ``x @ w`` run its products per shard: an output dim split over tp
  computes each shard's columns and joins them in shard order on the
  first device (in backing (b): an ``all_gather`` over "mp"); a
  contraction dim split over fsdp multiplies each shard's slice of x and
  adds the partial sums in shard order (backing (b): an ``all_reduce``
  over "sharding"). ``w[idx]`` gathers rows from the blocks (an
  embedding lookup). Any other use reads the whole weight,
  :meth:`ShardedWeight.joined`; a torch function the type does not handle
  raises a TypeError, as ``QuantWeight``'s do.

**Determinism** (the reference's contract, measured again here): sharding
a contraction adds partial sums in another order than one GEMM, so float
replies agree within :data:`SHARDED_FLOAT_TOL`. The reference holds
output-dim-only (tp) replies bitwise; a GEMM library picks its kernel by
shape, and a column block is another shape, so the port holds f32 tp
replies to the same tolerance and records whether they were bitwise.
Integer and bool replies, and decode solo-vs-batch under one mesh, stay
bitwise.
"""
import os
import re

import numpy as np
import torch

SINGLE = "single"

#: relative tolerance of a sharded float reply against the single mesh's
SHARDED_FLOAT_TOL = 1e-5

#: the environment variable :func:`resolve` reads
ENV = "PADDLE_TPU_SERVING_MESH"

# canonical axis order in descriptors: fsdp (the topology's 'sharding'
# axis) before tp (its 'mp' axis)
_DESCRIPTOR_RE = re.compile(r"^(?:fsdp(?P<fsdp>[0-9]+))?(?:x?tp(?P<tp>[0-9]+))?$")
_ALIAS_RE = re.compile(r"^mp(?P<tp>[0-9]+)$")
_AXIS = {"sharding": "fsdp", "mp": "tp"}


class ServingMesh:
    """One serving mesh: fsdp x tp shard counts. Immutable; the canonical
    ``descriptor`` is its identity (module docstring)."""

    __slots__ = ("fsdp", "tp")

    def __init__(self, fsdp=1, tp=1):
        fsdp, tp = int(fsdp), int(tp)
        if fsdp < 1 or tp < 1:
            raise ValueError(f"mesh axis sizes must be >= 1 (got fsdp={fsdp}, tp={tp})")
        self.fsdp = fsdp
        self.tp = tp

    @property
    def descriptor(self):
        if self.is_single:
            return SINGLE
        parts = []
        if self.fsdp > 1:
            parts.append(f"fsdp{self.fsdp}")
        if self.tp > 1:
            parts.append(f"tp{self.tp}")
        return "x".join(parts)

    @property
    def is_single(self):
        return self.fsdp == 1 and self.tp == 1

    @property
    def n_shards(self):
        """The shards (devices or ranks) this mesh spans."""
        return self.fsdp * self.tp

    def __repr__(self):
        return f"ServingMesh({self.descriptor!r})"

    def __eq__(self, other):
        return isinstance(other, ServingMesh) and (other.fsdp, other.tp) == (self.fsdp, self.tp)

    def __hash__(self):
        return hash((self.fsdp, self.tp))

    @classmethod
    def parse(cls, spec):
        """Descriptor -> ServingMesh: None, "" and "single" are the single
        mesh; "tp<k>", "fsdp<m>", "fsdp<m>xtp<k>", the "mp<k>" alias; a
        ServingMesh passes through. "f32" (a quant mode) raises naming the
        swap."""
        if isinstance(spec, ServingMesh):
            return spec
        if spec is None:
            return cls()
        s = str(spec).strip().lower()
        if s == "f32":
            raise ValueError("'f32' is a quant mode, not a mesh descriptor: did you swap "
                             "PADDLE_TPU_SERVING_QUANT and PADDLE_TPU_SERVING_MESH?")
        if s in ("", SINGLE):
            return cls()
        m = _ALIAS_RE.match(s)
        if m:
            return cls(tp=int(m.group("tp")))
        m = _DESCRIPTOR_RE.match(s)
        if not m or (m.group("fsdp") is None and m.group("tp") is None):
            raise ValueError(f"unknown serving mesh descriptor {spec!r}: expected 'single', "
                             "'tp<k>', 'mp<k>', 'fsdp<m>' or 'fsdp<m>xtp<k>' (e.g. "
                             "mesh='tp2', mesh='fsdp2xtp2')")
        return cls(fsdp=int(m.group("fsdp") or 1), tp=int(m.group("tp") or 1))

    # ------------------------------------------------------------ layout
    def param_spec(self, shape):
        """The placement rule for one array (module docstring): a tuple of
        "sharding" (fsdp), "mp" (tp) or None per dim."""
        shape = tuple(int(d) for d in shape)
        if not shape:
            return ()
        if len(shape) == 1:
            return ("mp",) if self.tp > 1 and shape[0] % self.tp == 0 else (None,)
        dims = [None] * len(shape)
        if self.fsdp > 1 and shape[0] % self.fsdp == 0:
            dims[0] = "sharding"
        if self.tp > 1 and shape[-1] % self.tp == 0:
            dims[-1] = "mp"
        return tuple(dims)

    def shard_fraction(self, shape):
        """1 / (the shards one array is split over): its residency per
        shard."""
        frac = 1.0
        for axis in self.param_spec(shape):
            if axis is not None:
                frac /= getattr(self, _AXIS[axis])
        return frac

    def per_shard_bytes(self, arrays):
        """The weight bytes one shard holds under the placement rule."""
        total = 0.0
        for a in arrays:
            shape = tuple(getattr(a, "shape", ()))
            if isinstance(a, torch.Tensor):
                nbytes = a.numel() * a.element_size()
            else:
                nbytes = (getattr(a, "nbytes", None)
                          or int(np.prod(shape or (1,)))
                          * np.dtype(getattr(a, "dtype", np.float32)).itemsize)
            total += nbytes * self.shard_fraction(shape)
        return int(total)

    # ------------------------------------------------------------- build
    def build(self, devices=None):
        """The mesh's backing (module docstring): a :class:`RankPlacement`
        in a ``torch.distributed`` job of ``n_shards`` ranks when no
        ``devices`` are given, else a :class:`DevicePlacement` over
        ``devices`` (default ``cuda:0 .. cuda:n-1``). Raises ValueError
        naming the remedy when there are too few."""
        if self.is_single:
            raise ValueError("a single mesh has no placement; callers branch on is_single")
        if devices is None:
            import torch.distributed as dist

            if (dist.is_available() and dist.is_initialized()
                    and dist.get_world_size() == self.n_shards):
                return RankPlacement(self)
            have = torch.cuda.device_count() if torch.cuda.is_available() else 0
            if have < self.n_shards:
                raise ValueError(
                    f"serving mesh {self.descriptor!r} needs {self.n_shards} devices but this "
                    f"process has {have} card(s): pass mesh_devices=['cuda:0'] * "
                    f"{self.n_shards} to put every shard on one card (['cpu'] * "
                    f"{self.n_shards} on the CPU), or serve from a launcher job of "
                    f"{self.n_shards} ranks")
            devices = [f"cuda:{i}" for i in range(self.n_shards)]
        devices = [torch.device(d) for d in devices]
        if len(devices) != self.n_shards:
            raise ValueError(f"serving mesh {self.descriptor!r} needs {self.n_shards} devices, "
                             f"got a list of {len(devices)}")
        return DevicePlacement(self, devices)

    def shard_arrays(self, arrays, placement):
        """Commit ``arrays`` to ``placement`` once, at load: each array the
        rule splits becomes a :class:`ShardedWeight` of its blocks, each
        other one stays whole on the first device."""
        return [placement.shard(a) for a in arrays]


def declared(mesh=None):
    """The mesh a deployment declares: the argument, else
    ``PADDLE_TPU_SERVING_MESH``, parsed (a bad descriptor raises); None
    when neither is set."""
    if mesh is None:
        mesh = os.environ.get(ENV) or None
    return None if mesh is None else ServingMesh.parse(mesh)


def resolve(mesh=None):
    """The resolution rule of every entry point: the argument, else
    ``PADDLE_TPU_SERVING_MESH``, else the single mesh."""
    return declared(mesh) or ServingMesh()


def serving_mesh(recorded, want, where=""):
    """The mesh a server serves a save under (the reference's
    ``serve_model`` rule): ``want`` (the declared mesh, else the one pinned
    at the first load) when given, else the save's ``recorded`` one, else
    the single mesh -> its descriptor. A recorded mesh that differs from
    ``want`` raises ValueError."""
    want = None if want is None else ServingMesh.parse(want)
    recorded = None if recorded is None else ServingMesh.parse(recorded)
    if want is not None and recorded is not None and recorded != want:
        raise ValueError(
            f"{where}saved serving mesh {recorded.descriptor!r} does not match the declared "
            f"mesh {want.descriptor!r} (PADDLE_TPU_SERVING_MESH / serve_model(mesh=)); "
            "re-save with jit.save(..., mesh=...) or fix the deployment knob")
    return (want or recorded or ServingMesh()).descriptor


def check_nr_devices(recorded, mesh):
    """Gate a loaded program on the shard count its save recorded
    (``recorded``: a descriptor, a count, or None for none recorded)
    against the engine's ``mesh``; ValueError on skew."""
    if recorded is None:
        return
    want = 1 if mesh is None else ServingMesh.parse(mesh).n_shards
    got = recorded if isinstance(recorded, int) else ServingMesh.parse(recorded).n_shards
    if got != want:
        desc = SINGLE if mesh is None else ServingMesh.parse(mesh).descriptor
        raise ValueError(f"mesh skew: the program was saved for {got} device(s) but the "
                         f"engine's mesh {desc!r} expects {want}")


# --------------------------------------------------------------- backings
class DevicePlacement:
    """Backing (a): every shard in this process, shard ``(f, t)`` on
    ``devices[f * tp + t]``."""

    ranks = False

    def __init__(self, mesh, devices):
        self.mesh = mesh
        self.devices = list(devices)
        self.first = self.devices[0]

    def device_of(self, f, t):
        return self.devices[f * self.mesh.tp + t]

    def shard(self, a):
        """``a`` (a tensor) as this placement holds it: a ShardedWeight
        when the rule splits it, else whole on the first device."""
        spec = self.mesh.param_spec(a.shape)
        if not any(spec):
            return a.to(self.first)
        nf, nt = _counts(self.mesh, spec)
        blocks = {(f, t): _block(a, spec, f, nf, t, nt).to(self.device_of(f, t)).contiguous()
                  for f in range(nf) for t in range(nt)}
        return ShardedWeight(self, spec, tuple(a.shape), a.dtype, blocks)

    def describe(self):
        return [str(d) for d in self.devices]


class RankPlacement:
    """Backing (b): one shard a rank of the job's ``topology.build_mesh(
    sharding=fsdp, mp=tp)``; this rank's blocks on its current device."""

    ranks = True

    def __init__(self, mesh):
        from ..core import place
        from ..distributed import topology

        # the current place, which never turns to the CPU on its own: it
        # raises without a card unless set_device("cpu") asked for the CPU;
        # a card is the rank's own (init_parallel_env selected it)
        first = place.resolve_device(None)
        if first.type == "cuda":
            first = torch.device("cuda", torch.cuda.current_device())
        self.first = first
        self.mesh = mesh
        self.topology = topology.build_mesh(sharding=mesh.fsdp, mp=mesh.tp)
        self.f = self.topology.rank_in("sharding")
        self.t = self.topology.rank_in("mp")

    def group(self, axis):
        return self.topology.group(axis)

    def shard(self, a):
        spec = self.mesh.param_spec(a.shape)
        if not any(spec):
            return a.to(self.first)
        nf, nt = _counts(self.mesh, spec)
        f, t = (self.f if nf > 1 else 0), (self.t if nt > 1 else 0)
        return ShardedWeight(self, spec, tuple(a.shape), a.dtype,
                             {(f, t): _block(a, spec, f, nf, t, nt).to(self.first).contiguous()})

    def describe(self):
        return f"{self.topology} rank f{self.f} t{self.t} on {self.first}"


def _counts(mesh, spec):
    """(blocks along fsdp, blocks along tp) of an array of ``spec``."""
    return (mesh.fsdp if "sharding" in spec else 1), (mesh.tp if "mp" in spec else 1)


def _block(a, spec, f, nf, t, nt):
    """Block (f, t) of ``a``: its f-th of nf along the "sharding" dim and
    its t-th of nt along the "mp" dim."""
    for dim, axis in enumerate(spec):
        if axis is not None:
            i, n = (f, nf) if axis == "sharding" else (t, nt)
            size = a.shape[dim] // n
            a = a.narrow(dim, i * size, size)
    return a


def _all_gather(part, group, n):
    import torch.distributed as dist

    parts = [torch.empty_like(part) for _ in range(n)]
    dist.all_gather(parts, part.contiguous(), group=group)
    return parts


class ShardedWeight:
    """One weight a serving mesh splits (module docstring): ``blocks``
    maps a shard ``(f, t)`` to its block (every block in backing (a), this
    rank's in backing (b)); ``spec`` is the split axis per dim; ``shape``
    and ``dtype`` are the whole weight's. ``matmul(x)`` is ``x @ w`` per
    shard, ``rows(idx)`` is ``w[idx]``, ``joined()`` the whole weight on
    the first device."""

    def __init__(self, placement, spec, shape, dtype, blocks):
        self.placement = placement
        self.spec = tuple(spec)
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.blocks = blocks
        self.nf, self.nt = _counts(placement.mesh, self.spec)

    def dim(self):
        return len(self.shape)

    def _local(self):
        ((key, blk),) = self.blocks.items()
        return key, blk

    # ------------------------------------------------------------ products
    def matmul(self, x):
        """``x [..., K] @ w [K, N]``: each shard's product over its slice
        of x, partial sums over fsdp added in shard order, column blocks
        over tp joined in shard order, on the first device."""
        if len(self.shape) != 2:
            raise TypeError(f"ShardedWeight.matmul needs a 2-D weight, this one is "
                            f"{tuple(self.shape)}")
        k = self.shape[0] // self.nf if self.spec[0] == "sharding" else None
        first = self.placement.first
        if self.placement.ranks:
            (f, _), blk = self._local()
            xs = x if k is None else x[..., f * k:(f + 1) * k]
            part = torch.matmul(xs.to(blk.device), blk)
            if self.nf > 1:
                import torch.distributed as dist

                dist.all_reduce(part, group=self.placement.group("sharding"))
            if self.nt > 1:
                part = torch.cat(_all_gather(part, self.placement.group("mp"), self.nt), -1)
            return part
        cols = []
        for t in range(self.nt):
            acc = None
            for f in range(self.nf):
                blk = self.blocks[(f, t)]
                xs = x if k is None else x[..., f * k:(f + 1) * k]
                part = torch.matmul(xs.to(blk.device), blk).to(first)
                acc = part if acc is None else acc + part
            cols.append(acc)
        return cols[0] if self.nt == 1 else torch.cat(cols, -1)

    def rows(self, idx):
        """``w[idx]`` along dim 0, gathered from the blocks (selection
        only: the whole weight's bits)."""
        if len(self.shape) != 2:
            raise TypeError(f"ShardedWeight.rows needs a 2-D weight, this one is "
                            f"{tuple(self.shape)}")
        first = self.placement.first
        r = self.shape[0] // self.nf if self.spec[0] == "sharding" else None

        def gather(blk, f):
            if r is None:
                return blk[idx.to(blk.device)].to(first)
            local = idx.to(blk.device) - f * r
            return local, blk[local.clamp(0, r - 1)].to(first)

        def pick(pieces):
            # the fsdp pieces: each row from the block that holds it
            out = None
            for local, rows in pieces:
                valid = ((local >= 0) & (local < r)).to(first)
                valid = valid.reshape(valid.shape + (1,) * (rows.dim() - valid.dim()))
                out = rows if out is None else torch.where(valid, rows, out)
            return out

        if self.placement.ranks:
            (f, _), blk = self._local()
            if r is None:
                part = gather(blk, f)
            else:
                local, rows = gather(blk, f)
                locals_ = _all_gather(local, self.placement.group("sharding"), self.nf)
                rows_ = _all_gather(rows, self.placement.group("sharding"), self.nf)
                part = pick(zip(locals_, rows_))
            if self.nt > 1 and self.spec[-1] == "mp":
                part = torch.cat(_all_gather(part, self.placement.group("mp"), self.nt), -1)
            return part
        cols = []
        for t in range(self.nt):
            if r is None:
                cols.append(gather(self.blocks[(0, t)], 0))
            else:
                cols.append(pick(gather(self.blocks[(f, t)], f) for f in range(self.nf)))
        return cols[0] if self.nt == 1 else torch.cat(cols, -1)

    def joined(self):
        """The whole weight on the first device (blocks concatenated in
        shard order; in backing (b) gathered from the ranks)."""
        first = self.placement.first
        fdim = 0
        tdim = self.spec.index("mp") if "mp" in self.spec else None
        if self.placement.ranks:
            _, blk = self._local()
            out = blk
            if self.nt > 1:
                out = torch.cat(_all_gather(out, self.placement.group("mp"), self.nt), tdim)
            if self.nf > 1:
                out = torch.cat(_all_gather(out, self.placement.group("sharding"), self.nf),
                                fdim)
            return out
        rows = []
        for f in range(self.nf):
            parts = [self.blocks[(f, t)].to(first) for t in range(self.nt)]
            rows.append(parts[0] if self.nt == 1 else torch.cat(parts, tdim))
        return rows[0] if self.nf == 1 else torch.cat(rows, fdim)

    def nbytes_here(self):
        """The bytes of the blocks this process holds."""
        return sum(b.numel() * b.element_size() for b in self.blocks.values())

    def __getitem__(self, idx):
        return self.rows(idx)

    def __rmatmul__(self, x):
        return self.matmul(x)

    def __repr__(self):
        return (f"ShardedWeight({tuple(self.shape)}, {self.dtype}, spec={self.spec}, "
                f"{len(self.blocks)} block(s))")

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        if (func in _MATMULS and len(args) == 2 and not kwargs
                and isinstance(args[1], ShardedWeight) and isinstance(args[0], torch.Tensor)):
            return args[1].matmul(args[0])
        return NotImplemented


_MATMULS = (torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__)


def shard_decode_model(model, placement):
    """A NEW ``DecodeModel`` serving ``model``'s computation over
    ``placement`` (a serving mesh's backing), as
    ``quantization.quantize_decode_model`` serves it under a quant mode:
    Llama's weights (``_LlamaWeights``) become their ``sharded`` form under
    the same fill and step functions; a flat param list (or dict) has each
    array the rule splits replaced by its ``ShardedWeight``, which the
    functions' ``x @ w``, ``torch.matmul`` and ``w[idx]`` read per shard.
    The weights digest, a function of the values, carries over."""
    from .decode import DecodeModel

    params = model.params
    if hasattr(params, "sharded"):
        new_params = params.sharded(placement)
    elif isinstance(params, dict):
        new_params = {n: placement.shard(p) for n, p in params.items()}
    else:
        new_params = placement.mesh.shard_arrays(list(params), placement)
    out = DecodeModel(new_params, model.fill_fn, model.step_fn, kv_spec=model.kv_spec,
                      vocab_size=model.vocab_size, feature_spec=model.feature_spec,
                      eos_token_id=model.eos_token_id, kv_seq_axis=model.kv_seq_axis,
                      device=placement.first, max_slots=model.max_slots,
                      max_seq_len=model.max_seq_len, quant=model.quant)
    out._digest = model._digest
    return out
