"""Host-sharded checkpoints of a training step's state over several ranks
(counterpart of paddle_tpu/distributed/checkpoint.py; reference: the
fleet sharding checkpoints, incubate auto_checkpoint).

A checkpoint holds one logical copy of each global array; every rank
writes only the blocks it holds, and a load re-slices the global arrays
onto whatever layout the reader asks for, at any world size (a 2-rank
ZeRO checkpoint restores onto one rank, or onto 4).

The format is the JAX package's host-sharded one, so that either package
assembles the other's directories:

    <ckpt>/
      SHARDS.json            # {"format": 1, "world": N, "step": S,
                             #  "leaves": {path: {"shape", "dtype"}}}
      shard-00000/           # rank 0's blocks
        data.npz             # one array per block ("a0", "a1", ...)
        index.json           # {"format": 1, "rank": 0, "entries":
                             #  [{"leaf", "key", "index": [[start, stop], ...]}]}
      shard-00001/ ...

Leaf paths are ``resilience.checkpoint.flatten_tree``'s. A 16-bit float
block is written with the bits of the reference's ml_dtypes array: a
float16 block as float16, a bfloat16 block as its 16-bit words under
numpy's ``|V2`` (what ``np.savez`` stores for an ml_dtypes bfloat16
array), with ``"dtype": "bfloat16"`` in SHARDS.json. The port reads a
bfloat16 leaf by that dtype, as its words (uint16, the port's bf16
convention on the host), and gives a torch bfloat16 tensor where the
reader's template holds one.

A rank's blocks carry their global index: ``place(state, layout)`` wraps
every block of ``{"params": ..., "opt_state": ...}`` as a :class:`Shard`
by a step's ``step_fn.layout`` (``spmd.build_train_step``,
``build_fsdp_train_step``, ``pipeline.build_pipeline_train_step``: each
leaf's cuts ``(dimension, rank, ranks)`` of the global array, outer
first, the mapping ``convert.to_rank_state`` makes). A leaf that is not
a Shard is whole; every rank holding it writes it, and the assembly keeps
one copy. The same wrapping of the reader's own state is the template a
load re-slices onto.

The JAX package writes a single-process checkpoint through orbax; the
port has no orbax, so ``save_sharded`` writes the host format with a
world of 1 and ``load_sharded`` reads the host format only.

``MultiProcessShardedManager``: each rank stages its blocks, rank 0
commits them through ``resilience.CheckpointManager`` (manifest with
per-file sha256, one ``os.replace`` publishes, retention GC, verified
load with fallback), and a publish barrier holds every rank until the
step is durable. The barrier is the active elastic client's
(``resilience.elastic``: dead ranks excluded), else a shared-filesystem
one under the root.
"""
import json
import os
import shutil
import time

import numpy as np
import torch

from ..resilience.checkpoint import flatten_tree

HOST_SHARDS_NAME = "SHARDS.json"
HOST_FORMAT_VERSION = 1


class Shard:
    """A rank's block ``data`` (a tensor or an array) of a global array of
    ``shape``, at ``index`` ([[start, stop], ...] per dimension)."""

    __slots__ = ("data", "shape", "index")

    def __init__(self, data, shape, index):
        self.data = data
        self.shape = tuple(int(d) for d in shape)
        self.index = [[int(a), int(b)] for a, b in index]

    def __repr__(self):
        return f"Shard({tuple(self.data.shape)} of {self.shape} at {self.index})"


def cut_index(block_shape, cuts):
    """(global shape, index) of a block cut from its global array by
    ``cuts``, each ``(dimension, rank, ranks)``, outer first."""
    shape = list(block_shape)
    for d, _, n in reversed(cuts):
        shape[d] *= n
    start, size = [0] * len(shape), list(shape)
    for d, r, n in cuts:
        size[d] //= n
        start[d] += r * size[d]
    return shape, [[a, a + k] for a, k in zip(start, size)]


def _place_leaf(leaf, cuts):
    if not cuts or not isinstance(leaf, (torch.Tensor, np.ndarray)) or not np.ndim(leaf):
        return leaf
    shape, index = cut_index(tuple(leaf.shape), cuts)
    return Shard(leaf, shape, index)


def place(state, layout):
    """``state`` with every block wrapped as a :class:`Shard`: its
    ``"params"`` ({name: tensor}) and ``"opt_state"`` ({name: tuple of
    tensors}; a scalar state tensor is whole) by ``layout`` (a step's
    ``step_fn.layout``); other entries as they are. DGC's per-rank
    ``opt_state["__comm__"]`` has no global array and raises."""
    out = dict(state)
    for part in ("params", "opt_state"):
        if part not in state:
            continue
        cuts = layout.get(part, {})
        tree = {}
        for name, v in state[part].items():
            if name == "__comm__":
                raise NotImplementedError(
                    "opt_state['__comm__'] (DGC's state) is each rank's own, with no global "
                    "array to shard; checkpoint it per rank")
            c = cuts.get(name, ())
            tree[name] = (type(v)(_place_leaf(t, c) for t in v) if isinstance(v, (tuple, list))
                          else _place_leaf(v, c))
        out[part] = tree
    return out


def _host(leaf):
    """(ndarray, dtype name) of a leaf on the host: a bfloat16 tensor as
    its 16-bit words named "bfloat16"."""
    if isinstance(leaf, torch.Tensor):
        from ..framework import _host_array

        arr, tag = _host_array(leaf)
        return arr, tag or str(arr.dtype)
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _blob(arr, dtype):
    """The array as the reference's npz holds it: bfloat16 words as |V2."""
    arr = np.asarray(arr, order="C")  # (ascontiguousarray makes a 0-d array 1-d)
    return arr.view("V2") if dtype == "bfloat16" else arr


def _np_dtype(name):
    """The host dtype a leaf of dtype ``name`` is assembled in: uint16
    words for bfloat16 (numpy has none)."""
    return np.dtype(np.uint16) if name == "bfloat16" else np.dtype(name)


def _dtype_name(t):
    """A tensor's dtype as the reference names it (jax's, ml_dtypes')."""
    return "bfloat16" if t.dtype == torch.bfloat16 else str(t.dtype).replace("torch.", "")


def write_host_shards(state, out_dir, rank=0):
    """Write this rank's blocks of every leaf into ``out_dir`` (one
    ``data.npz`` and ``index.json``). A whole leaf is written whole by
    every rank that holds it; the assembly keeps one copy, and the
    redundancy lets a pod that lost a host still publish a complete
    checkpoint when the survivors cover every block."""
    os.makedirs(out_dir, exist_ok=True)
    entries, arrays = [], {}
    for path, leaf in flatten_tree(state).items():
        key = f"a{len(arrays)}"
        if isinstance(leaf, Shard):
            arr, dtype = _host(leaf.data)
            index = leaf.index
        else:
            arr, dtype = _host(leaf)
            index = [[0, d] for d in arr.shape]
        arrays[key] = _blob(arr, dtype)
        entries.append({"leaf": path, "key": key, "index": index})
    np.savez(os.path.join(out_dir, "data.npz"), **arrays)
    with open(os.path.join(out_dir, "index.json"), "w") as f:
        json.dump({"format": HOST_FORMAT_VERSION, "rank": int(rank), "entries": entries}, f,
                  sort_keys=True)
    return out_dir


def write_host_manifest(state, ckpt_dir, world, step=None):
    """SHARDS.json: every leaf's global shape and dtype (what the
    assembly allocates and its coverage check measures against)."""
    leaves = {}
    for path, leaf in flatten_tree(state).items():
        if isinstance(leaf, Shard):
            dtype = (_dtype_name(leaf.data) if isinstance(leaf.data, torch.Tensor)
                     else str(np.asarray(leaf.data).dtype))
            leaves[path] = {"shape": list(leaf.shape), "dtype": dtype}
        else:
            arr, dtype = _host(leaf)
            leaves[path] = {"shape": list(arr.shape), "dtype": dtype}
    payload = {"format": HOST_FORMAT_VERSION, "world": int(world), "leaves": leaves}
    if step is not None:
        payload["step"] = int(step)
    with open(os.path.join(ckpt_dir, HOST_SHARDS_NAME), "w") as f:
        json.dump(payload, f, sort_keys=True)
    return payload


def assemble_host_checkpoint(path):
    """A host-sharded checkpoint directory as ({leaf path: global
    ndarray}, SHARDS.json's dict), in numpy; a bfloat16 leaf as its
    16-bit words (uint16). Raises ``CheckpointCorrupt`` when the shards
    present do not cover every element of a leaf (a host died before
    staging and no survivor held its blocks)."""
    from ..resilience.checkpoint import CheckpointCorrupt

    try:
        with open(os.path.join(path, HOST_SHARDS_NAME)) as f:
            meta = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise CheckpointCorrupt(f"{path}: {HOST_SHARDS_NAME} unreadable: {e}") from e
    leaves = {p: np.zeros(tuple(spec["shape"]), _np_dtype(spec["dtype"]))
              for p, spec in meta["leaves"].items()}
    covered = {p: set() for p in leaves}
    shard_dirs = sorted(n for n in os.listdir(path)
                        if n.startswith("shard-") and os.path.isdir(os.path.join(path, n)))
    for name in shard_dirs:
        d = os.path.join(path, name)
        try:
            with open(os.path.join(d, "index.json")) as f:
                index = json.load(f)
            with np.load(os.path.join(d, "data.npz")) as blobs:
                for e in index["entries"]:
                    leaf = e["leaf"]
                    if leaf not in leaves:
                        continue  # a leaf the manifest does not name
                    blob = blobs[e["key"]]
                    if blob.dtype.kind == "V":  # 16-bit words (bfloat16)
                        blob = blob.view(leaves[leaf].dtype)
                    leaves[leaf][tuple(slice(a, b) for a, b in e["index"])] = blob
                    covered[leaf].add(tuple(map(tuple, e["index"])))
        except (OSError, ValueError, KeyError) as e:
            raise CheckpointCorrupt(f"{d}: shard unreadable: {e}") from e
    for p, spec in meta["leaves"].items():
        total = int(np.prod(spec["shape"])) if spec["shape"] else 1
        got = sum(int(np.prod([b - a for a, b in idx])) if idx else 1 for idx in covered[p])
        if got < total:
            raise CheckpointCorrupt(f"{path}: leaf {p!r} covers {got}/{total} elements; a "
                                    "rank's shards are missing (host lost before staging?)")
    return leaves, meta


def _as_target(buf, dtype_name, target):
    """``buf`` (a host array of a leaf of ``dtype_name``) as the template
    leaf ``target`` holds it: a tensor of its dtype on its device, or an
    array of its dtype."""
    if isinstance(target, torch.Tensor):
        buf = np.asarray(buf, order="C")
        if dtype_name == "bfloat16":
            t = torch.from_numpy(buf.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(buf)
        return t.to(device=target.device, dtype=target.dtype)
    arr = np.asarray(target)
    if dtype_name == "bfloat16" and arr.dtype != np.uint16:
        # the words as float32 (their upper halves), then the target's dtype
        buf = (buf.astype(np.uint32) << 16).view(np.float32)
    out = buf.astype(arr.dtype) if arr.dtype != buf.dtype else buf
    if isinstance(target, (int, float, bool, np.generic)):
        return out[()] if out.shape == () else out
    return out


def load_host_sharded(path, like):
    """Restore a host-sharded checkpoint onto ``like``: each leaf is
    assembled into its global host array, then cut to the template's
    block (a :class:`Shard`'s index, from ``place``) or taken whole,
    and given the template leaf's dtype and device (a Shard: its
    ``data``'s)."""
    from ..resilience.checkpoint import CheckpointCorrupt

    leaves, meta = assemble_host_checkpoint(os.path.abspath(path))

    def one(prefix, target):
        key = prefix.rstrip(".") or "<root>"
        if key not in leaves:
            raise CheckpointCorrupt(f"{path}: leaf {key!r} missing from checkpoint")
        buf, dtype = leaves[key], meta["leaves"][key]["dtype"]
        if isinstance(target, Shard):
            if tuple(target.shape) != tuple(buf.shape):
                raise ValueError(f"{key}: checkpoint shape {tuple(buf.shape)} != template "
                                 f"shape {target.shape}")
            return _as_target(buf[tuple(slice(a, b) for a, b in target.index)], dtype,
                              target.data)
        shape = tuple(getattr(target, "shape", np.shape(target)))
        if shape != tuple(buf.shape):
            raise ValueError(f"{key}: checkpoint shape {tuple(buf.shape)} != template shape "
                             f"{shape}")
        return _as_target(buf, dtype, target)

    def walk(node, prefix=""):
        if isinstance(node, dict):
            return {k: walk(v, f"{prefix}{k}.") for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, f"{prefix}{i}.") for i, v in enumerate(node))
        return one(prefix, node)

    return walk(like)


# ------------------------------------------------ single-process surface

def save_sharded(state, path, force=True, atomic=True):
    """Save a state tree (tensors, arrays, :class:`Shard` blocks,
    scalars) in the host format with a world of 1; returns the path.
    ``atomic`` stages the directory beside ``path`` and publishes it with
    one ``os.replace`` (the previous checkpoint moved aside first, put
    back if the publish fails)."""
    from ..resilience import chaos

    path = os.path.abspath(path)

    def write(d):
        write_host_shards(state, os.path.join(d, "shard-00000"), rank=0)
        write_host_manifest(state, d, 1, step=state.get("step") if isinstance(state, dict)
                            and isinstance(state.get("step"), (int, np.integer)) else None)

    if not atomic:
        if os.path.isdir(path) and force:
            shutil.rmtree(path)
        write(path)
        return path
    if os.path.isdir(path) and not force:
        raise FileExistsError(f"checkpoint exists: {path}")
    parent, base = os.path.dirname(path), os.path.basename(path)
    tmp = os.path.join(parent, f".tmp-{base}-{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    try:
        chaos.hit("checkpoint.write")
        write(tmp)
        chaos.hit("checkpoint.rename")
        old = None
        if os.path.isdir(path):
            old = os.path.join(parent, f".old-{base}-{os.getpid()}")
            shutil.rmtree(old, ignore_errors=True)
            os.replace(path, old)
        try:
            os.replace(tmp, path)
        except BaseException:
            if old is not None and not os.path.isdir(path):
                os.replace(old, path)
            raise
        if old is not None:
            shutil.rmtree(old, ignore_errors=True)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return path


def load_sharded(path, like):
    """Restore ``path`` onto ``like`` (``load_host_sharded``). A
    directory without SHARDS.json (the JAX package's orbax payload) is
    not readable here and raises ValueError."""
    path = os.path.abspath(path)
    if not os.path.isfile(os.path.join(path, HOST_SHARDS_NAME)):
        raise ValueError(f"{path}: no {HOST_SHARDS_NAME}; the port reads the host-sharded "
                         "format only (no orbax)")
    return load_host_sharded(path, like)


def save_train_state(params, opt_state, path, step=0, extra=None, layout=None):
    """``{"params", "opt_state", "step"}`` (and ``extra``) through
    ``save_sharded``; ``layout``: the step's ``step_fn.layout`` when the
    tensors are a rank's blocks."""
    state = {"params": params, "opt_state": opt_state, "step": np.int64(step)}
    if extra:
        state["extra"] = extra
    if layout is not None:
        state = place(state, layout)
    return save_sharded(state, path)


def load_train_state(path, params_like, opt_state_like, layout=None):
    """(params, opt_state, step) restored onto the templates (cut by
    ``layout`` where they are a rank's blocks)."""
    like = {"params": params_like, "opt_state": opt_state_like, "step": np.int64(0)}
    if layout is not None:
        like = place(like, layout)
    state = load_sharded(path, like)
    return state["params"], state["opt_state"], int(state["step"])


def _default_world():
    try:
        world = int(os.environ.get("PADDLE_TRAINERS_NUM") or 0)
    except ValueError:
        world = 0
    if world <= 0:
        world = (torch.distributed.get_world_size()
                 if torch.distributed.is_available() and torch.distributed.is_initialized()
                 else 1)
    return world


def sharded_checkpoint_manager(root, like=None, keep=3, io_retries=3, rank=None, world=None,
                               barrier=None):
    """A ``resilience.CheckpointManager`` whose payload is host-sharded
    global arrays (atomic publish, manifest with per-file checksums,
    retention, verified load with fallback). ``like``: the template a
    load restores onto (``place``d by the reader's layout); set or
    replace it later as ``manager.reader_like``.

    ``world`` (default ``PADDLE_TRAINERS_NUM``, else the process group's
    size, else 1) > 1 gives a :class:`MultiProcessShardedManager`;
    otherwise one process writes the host format with a world of 1 under
    each checkpoint's ``state/``, and loads a pod's checkpoint too (a
    restore onto one rank)."""
    world = _default_world() if world is None else int(world)
    if world > 1:
        return MultiProcessShardedManager(root, like=like, keep=keep, io_retries=io_retries,
                                          rank=rank, world=world, barrier=barrier)
    from ..resilience.checkpoint import CheckpointManager

    def writer(state, ckpt_dir):
        # the manager's temp directory is the staging area: one rename
        # publishes the payload and the manifest
        save_sharded(state, os.path.join(ckpt_dir, "state"), atomic=False)
        return None

    def reader(ckpt_dir):
        template = manager.reader_like
        if template is None:
            raise ValueError("sharded_checkpoint_manager needs `like` (or set "
                             "manager.reader_like) to restore sharded arrays")
        # one process's checkpoint holds its payload under state/; a
        # pod's (MultiProcessShardedManager's) at the top
        sub = os.path.join(ckpt_dir, "state")
        return load_sharded(sub if os.path.isdir(sub) else ckpt_dir, template)

    manager = CheckpointManager(root, keep=keep, writer=writer, reader=reader,
                                io_retries=io_retries)
    manager.reader_like = like
    return manager


# --------------------------------------------------- multi-process manager

def _fs_barrier(root, name, rank, world, timeout):
    """A shared-filesystem barrier: each rank writes ``.sync/<name>.<rank>``
    and polls for ``world`` of them. Names are unique per save (the
    manager tags them step.seq)."""
    from ..resilience.checkpoint import atomic_write_bytes

    d = os.path.join(root, ".sync")
    os.makedirs(d, exist_ok=True)
    atomic_write_bytes(os.path.join(d, f"{name}.{rank}"), b"1")
    deadline = time.monotonic() + timeout
    want = int(world)
    while True:
        n = sum(1 for fn in os.listdir(d) if fn.startswith(name + "."))
        if n >= want:
            return
        if time.monotonic() >= deadline:
            raise TimeoutError(f"fs barrier {name!r}: {n}/{want} ranks arrived within "
                               f"{timeout:.0f}s")
        time.sleep(0.02)


class MultiProcessShardedManager:
    """Multi-process sharded checkpoints with one committer.

    1. every rank writes its blocks into ``<root>/.stage-ckpt-<step>-rank<r>``;
    2. barrier "stage": nothing is visible yet;
    3. rank 0 link-copies every staged directory into its
       ``CheckpointManager`` temp directory beside its own blocks, writes
       SHARDS.json and MANIFEST.json, and publishes with one
       ``os.replace`` and the LATEST flip (so retention, verified load and
       the fallback past corruption all apply);
    4. barrier "publish": only then does any rank go on, so a preemption
       mid-save never leaves ranks disagreeing on the durable step. A
       rank whose coordinator vanishes in this barrier (rank 0 published,
       exited 143 and took its coordinator along) waits for LATEST to
       name its step on disk instead.

    ``save(state, step)`` takes the rank's state with its blocks
    ``place``d (a :class:`Shard` carries its global index). Loads run on
    every rank alone: verify the manifest, assemble the global host
    arrays (coverage-checked), cut them to ``reader_like``.
    """

    def __init__(self, root, like=None, keep=3, io_retries=3, rank=None, world=None,
                 barrier=None, barrier_timeout=None):
        from ..resilience.checkpoint import CheckpointManager
        from ..resilience.retry import _env_float

        self.root = os.path.abspath(root)
        self.rank = int(os.environ.get("PADDLE_TRAINER_ID", 0) if rank is None else rank)
        self.world = int(world if world is not None
                         else os.environ.get("PADDLE_TRAINERS_NUM", 1))
        self.reader_like = like
        self._barrier_fn = barrier
        self._barrier_timeout = (_env_float("PADDLE_TPU_ELASTIC_BARRIER_TIMEOUT", 120.0)
                                 if barrier_timeout is None else float(barrier_timeout))
        self._seq = 0
        self._inner = CheckpointManager(self.root, keep=keep, writer=self._commit_writer,
                                        reader=self._reader, io_retries=io_retries)
        self._commit_ctx = None  # (step, tag) during rank 0's save

    def _barrier(self, name):
        fn = self._barrier_fn
        if fn is None:
            from ..resilience import elastic

            client = elastic.active_client()
            if client is not None and not isinstance(client, elastic.LocalElastic):
                fn = client.barrier
        if fn is not None:
            return fn(name)
        return _fs_barrier(self.root, name, self.rank, self.world, self._barrier_timeout)

    def _stage_dir(self, step, rank):
        return os.path.join(self.root, f".stage-{self._inner._name(step)}-rank{rank}")

    def _commit_writer(self, state, tmp):
        """Rank 0's writer: its own blocks, every other rank's staged
        directory and SHARDS.json, inside the manager's temp directory.
        The staged directories are link-copied, not moved: the manager
        retries this writer after wiping the temp directory on a
        transient OSError, and a move would lose the other ranks' blocks
        on the first attempt. ``save`` removes them once published."""
        step, tag = self._commit_ctx
        write_host_shards(state, os.path.join(tmp, "shard-00000"), rank=0)
        self._barrier(f"stage-{tag}")
        for r in range(1, self.world):
            staged = self._stage_dir(step, r)
            if not os.path.isdir(staged):
                # a dead host never staged: publish anyway; the coverage
                # check on load decides whether the survivors' blocks
                # make a complete checkpoint
                continue
            dst = os.path.join(tmp, f"shard-{r:05d}")
            try:
                shutil.copytree(staged, dst, copy_function=os.link)
            except OSError:
                shutil.rmtree(dst, ignore_errors=True)
                shutil.copytree(staged, dst)  # a filesystem without hard links
        write_host_manifest(state, tmp, self.world, step=step)
        return None

    def _reader(self, ckpt_dir):
        if self.reader_like is None:
            raise ValueError("MultiProcessShardedManager needs `like` (or set "
                             "manager.reader_like) to restore sharded arrays")
        return load_host_sharded(ckpt_dir, self.reader_like)

    def _await_publish(self, step, tag):
        from ..resilience import elastic

        try:
            self._barrier(f"publish-{tag}")
            return
        except elastic.CoordinatorLost:
            deadline = time.monotonic() + self._barrier_timeout
            while time.monotonic() < deadline:
                latest = self._inner.latest_step()
                if latest is not None and latest >= int(step):
                    return
                time.sleep(0.05)
            raise

    def save(self, state, step, extra=None):
        """Collective: every rank calls ``save(state, step)`` with the same
        step (the elastic consensus gives exactly that)."""
        self._seq += 1
        tag = f"{step}.{self._seq}"
        if self.rank == 0:
            self._commit_ctx = (step, tag)
            try:
                path = self._inner.save(state, step, extra=extra)
            finally:
                self._commit_ctx = None
            for r in range(1, self.world):
                shutil.rmtree(self._stage_dir(step, r), ignore_errors=True)
            self._barrier(f"publish-{tag}")
            return path
        staged = self._stage_dir(step, self.rank)
        shutil.rmtree(staged, ignore_errors=True)
        write_host_shards(state, staged, rank=self.rank)
        self._barrier(f"stage-{tag}")
        self._await_publish(step, tag)
        return self._inner.path(step)

    def load(self, verify=True):
        return self._inner.load(verify=verify)

    def verify(self, ckpt_dir):
        return self._inner.verify(ckpt_dir)

    def latest_step(self):
        return self._inner.latest_step()

    def all_steps(self):
        return self._inner.all_steps()

    def path(self, step):
        return self._inner.path(step)

    def gc(self):
        return self._inner.gc()
