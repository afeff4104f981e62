"""The port's host-sharded checkpoints (paddle_tpu_torch/distributed/
checkpoint.py) against the JAX package's format, on the CPU.

Two ranks of ``tests/torch_dist_moe_worker.py`` (mode ``ckpt``, the
port's launcher over gloo) save through ``MultiProcessShardedManager``: a
ZeRO-1 Adam run over dp=2 with a bfloat16 leaf (steps 2 and 3), the three
mp layers at mp=2, the MoE capacity net at ep=2 and an MoE pipeline at
pp=2. Each checkpoint assembles to the ranks' state gathered with
``convert.from_rank_states``, bitwise, and restores onto one rank, onto
four and onto each rank's own layout, bitwise. Each package's
``assemble_host_checkpoint`` reads the other's directories bitwise; a
bfloat16 block holds the same bits in both (the JAX package cannot read
its own bfloat16 block back: numpy has no cast from the ``|V2`` that
``np.savez`` stores for an ml_dtypes array to bfloat16, the caveat
ROADMAP records). A missing shard raises ``CheckpointCorrupt``; a
corrupt published step falls back to the one before.
"""
import json
import shutil

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from paddle_tpu.distributed import checkpoint as jckpt
from paddle_tpu.resilience.checkpoint import CheckpointCorrupt as JCorrupt
import paddle_tpu_torch as ptt
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.convert import from_rank_states, to_rank_state
from paddle_tpu_torch.distributed import checkpoint as tckpt
from paddle_tpu_torch.distributed import spmd as tspmd
from paddle_tpu_torch.distributed.spmd import zero_dim
from paddle_tpu_torch.resilience.checkpoint import CheckpointCorrupt

import torch_dist_moe_worker as M
import torch_dist_worker as W
from test_torch_dist_model_parallel import _tree

SPAWN_TIMEOUT = 240
MP_DIMS = {"0.weight": 0, "1.weight": 1, "1.bias": 0, "3.weight": 0, "3.bias": None,
           "4.weight": 1, "4.bias": 0}
EP_DIMS = {"moe.w_up": 0, "moe.w_down": 0}


@pytest.fixture(autouse=True, scope="module")
def _cpu_place():
    saved = ptt.core.place._CURRENT
    ptt.set_device("cpu")
    yield
    ptt.core.place._CURRENT = saved


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ckpt")
    rc, log = W.run_ranks("ckpt", tmp, nproc=2, timeout=SPAWN_TIMEOUT, worker=M.__file__)
    assert rc == 0, log[-6000:]
    return tmp, [dict(np.load(tmp / f"rank{r}.npz")) for r in range(2)]


def _assembled(path):
    leaves, meta = tckpt.assemble_host_checkpoint(str(path))
    tree = {}
    for p, a in leaves.items():
        part, _, rest = p.partition(".")
        if part in ("params", "bf16"):
            tree.setdefault(part, {})[rest] = a
        elif part == "opt_state":
            name, _, i = rest.rpartition(".")
            lst = tree.setdefault(part, {}).setdefault(name, [])
            lst.extend([None] * (int(i) + 1 - len(lst)))
            lst[int(i)] = a
        else:
            tree[p] = a
    tree["opt_state"] = {n: tuple(v) for n, v in tree.get("opt_state", {}).items()}
    return tree, meta


def _template(rank, tag):
    """A rank's own state as the template of a load (its blocks'
    shapes), wrapped by its layout."""
    params = {n: torch.zeros(a.shape, dtype=torch.float32)
              for n, a in _tree(rank, f"{tag}/param/").items()}
    state = {n: tuple(torch.zeros(np.shape(a), dtype=torch.from_numpy(np.asarray(a)).dtype)
                      for a in v) for n, v in _tree(rank, f"{tag}/state/").items()}
    layout = json.loads(str(rank[f"{tag}/layout"]))
    return tckpt.place({"params": params, "opt_state": state}, layout)


def _assert_tree_equal(got, want, what):
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _assert_tree_equal(got[k], want[k], f"{what}.{k}")
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_tree_equal(g, w, f"{what}.{i}")
    else:
        g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
        np.testing.assert_array_equal(g, np.asarray(want), err_msg=what)


def test_zero1_checkpoint_restores_onto_one_rank_bitwise(run):
    tmp, ranks = run
    ckpt = tmp / "ckpt-zero1" / "ckpt-2"
    tree, meta = _assembled(ckpt)
    assert meta["world"] == 2 and meta["step"] == 2
    assert meta["leaves"]["bf16.0.weight"]["dtype"] == "bfloat16"
    params = _tree(ranks[0], "zero1/param/")
    for r in ranks[1:]:  # ZeRO-1: whole parameters on every rank
        _assert_tree_equal(_tree(r, "zero1/param/"), params, "params")
    _assert_tree_equal(tree["params"], params, "params")
    state = from_rank_states([_tree(r, "zero1/state/") for r in ranks], tree["opt_state"])
    _assert_tree_equal(tree["opt_state"], state, "opt_state")
    assert any(a.ndim and a.shape != _tree(ranks[0], "zero1/state/")[n][i].shape
               for n, v in state.items() for i, a in enumerate(v))  # blocks were cut
    # the bf16 leaf holds the parameters' bfloat16 words
    for n, p in params.items():
        words = torch.from_numpy(p).to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
        np.testing.assert_array_equal(tree["bf16"][n], words)
    # restored onto one rank of the port's own step (no mesh): its layout
    # has no cuts, so every leaf comes back whole
    model = M.zero1_model()
    step, init = tspmd.build_train_step(model, M.mse, topt.Adam(1e-2,
                                                                parameters=model.parameters()))
    p1, s1 = init()
    like = tckpt.place({"params": p1, "opt_state": s1}, step.layout)
    like["bf16"] = {n: t.to(torch.bfloat16) for n, t in p1.items()}
    like["step"] = np.int64(0)
    got = tckpt.load_host_sharded(str(ckpt), like)
    _assert_tree_equal(got["params"], params, "params")
    _assert_tree_equal(got["opt_state"], state, "opt_state")
    assert int(got["step"]) == 2
    for n, p in params.items():
        assert got["bf16"][n].dtype == torch.bfloat16
        np.testing.assert_array_equal(got["bf16"][n].float().numpy(),
                                      torch.from_numpy(p).to(torch.bfloat16).float().numpy())
    # and onto four ranks: each rank's ZeRO block of the global state
    for r in range(4):
        cuts = {n: [(zero_dim(a.shape, 4), r, 4)] if zero_dim(a.shape, 4) is not None else []
                for n, a in params.items()}
        want = to_rank_state(state, r, 4)
        like4 = tckpt.place({"opt_state": {n: tuple(torch.zeros(a.shape) for a in v)
                                           for n, v in want.items()}}, {"opt_state": cuts})
        got4 = tckpt.load_host_sharded(str(ckpt), like4)
        _assert_tree_equal(got4["opt_state"], want, f"rank {r} of 4")


@pytest.mark.parametrize("tag,layout,dims", [("mp2", "mp", MP_DIMS),
                                             ("ep2_capacity", "ep", EP_DIMS),
                                             ("pp2", "pp", None)])
def test_mp_ep_and_pp_layouts_round_trip(run, tag, layout, dims):
    tmp, ranks = run
    ckpt = tmp / f"ckpt-{tag}" / "ckpt-2"
    tree, _ = _assembled(ckpt)
    params = from_rank_states([_tree(r, f"{tag}/param/") for r in ranks], tree["params"],
                              layout, dims)
    _assert_tree_equal(tree["params"], params, "params")
    state = from_rank_states([_tree(r, f"{tag}/state/") for r in ranks], tree["opt_state"],
                             layout, dims)
    _assert_tree_equal(tree["opt_state"], state, "opt_state")
    for r in ranks:  # each rank's layout cuts back its own blocks
        got = tckpt.load_host_sharded(str(ckpt), _template(r, tag))
        _assert_tree_equal(got["params"], _tree(r, f"{tag}/param/"), "params")
        _assert_tree_equal(got["opt_state"], _tree(r, f"{tag}/state/"), "opt_state")


def test_packages_read_each_others_directories_bitwise(run, tmp_path):
    tmp, _ = run
    # the reference assembles the port's mp=2 checkpoint (float32 blocks)
    ckpt = tmp / "ckpt-mp2" / "ckpt-2"
    theirs, _ = jckpt.assemble_host_checkpoint(str(ckpt))
    ours, _ = tckpt.assemble_host_checkpoint(str(ckpt))
    assert set(theirs) == set(ours)
    for p in ours:
        np.testing.assert_array_equal(ours[p], theirs[p], err_msg=p)
    # the port assembles the reference's checkpoint of arrays sharded over
    # two devices, with a bfloat16 leaf
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:2]), ("dp",))
    rng = np.random.RandomState(0)
    w = rng.randn(4, 6).astype(np.float32)
    b16 = rng.randn(4, 3).astype(np.float32)
    state = {"w": jax.device_put(w, NamedSharding(mesh, PartitionSpec("dp"))),
             "h": jax.device_put(jnp.asarray(b16, jnp.bfloat16),
                                 NamedSharding(mesh, PartitionSpec(None, None))),
             "f16": np.arange(5, dtype=np.float16), "step": np.int64(7)}
    ref_dir = tmp_path / "ref"
    jckpt.write_host_shards(state, str(ref_dir / "shard-00000"))
    jckpt.write_host_manifest(state, str(ref_dir), 1, step=7)
    ours, meta = tckpt.assemble_host_checkpoint(str(ref_dir))
    np.testing.assert_array_equal(ours["w"], w)
    words = np.asarray(jnp.asarray(b16, jnp.bfloat16)).view(np.uint16)
    np.testing.assert_array_equal(ours["h"], words)
    np.testing.assert_array_equal(ours["f16"], state["f16"])
    got = tckpt.load_host_sharded(str(ref_dir), {"w": torch.zeros(4, 6),
                                                 "h": torch.zeros(4, 3, dtype=torch.bfloat16),
                                                 "f16": torch.zeros(5, dtype=torch.float16),
                                                 "step": np.int64(0)})
    np.testing.assert_array_equal(got["h"].view(torch.int16).numpy().view(np.uint16), words)
    assert got["f16"].dtype == torch.float16 and int(got["step"]) == 7
    # a bfloat16 block: the port writes the reference's bits
    port_dir = tmp_path / "port"
    tckpt.save_sharded({"h": torch.from_numpy(b16).to(torch.bfloat16)}, str(port_dir))
    with np.load(port_dir / "shard-00000" / "data.npz") as a, \
            np.load(ref_dir / "shard-00000" / "data.npz") as b:
        key = json.load(open(ref_dir / "shard-00000" / "index.json"))["entries"]
        key = next(e["key"] for e in key if e["leaf"] == "h")
        assert a["a0"].dtype == b[key].dtype == np.dtype("V2")
        assert a["a0"].tobytes() == b[key].tobytes()
    assert json.load(open(port_dir / "SHARDS.json"))["leaves"]["h"]["dtype"] == "bfloat16"
    # the reference cannot read a bfloat16 block back, its own or the port's
    for d in (ref_dir, port_dir):
        with pytest.raises(JCorrupt, match="cast"):
            jckpt.assemble_host_checkpoint(str(d))
    assert np.dtype(ml_dtypes.bfloat16).itemsize == 2


def test_missing_shard_raises(run, tmp_path):
    tmp, _ = run
    torn = tmp_path / "torn"
    shutil.copytree(tmp / "ckpt-mp2" / "ckpt-2", torn)
    shutil.rmtree(torn / "shard-00001")
    with pytest.raises(CheckpointCorrupt, match="covers"):
        tckpt.assemble_host_checkpoint(str(torn))
    with pytest.raises(JCorrupt, match="covers"):
        jckpt.assemble_host_checkpoint(str(torn))


def test_corrupt_published_step_falls_back(run, tmp_path):
    tmp, ranks = run
    root = tmp_path / "root"
    shutil.copytree(tmp / "ckpt-zero1", root)
    blob = root / "ckpt-3" / "shard-00001" / "data.npz"
    data = bytearray(blob.read_bytes())
    data[len(data) // 2] ^= 0xFF
    blob.write_bytes(bytes(data))
    tree, _ = _assembled(tmp / "ckpt-zero1" / "ckpt-2")
    like = {"params": {n: torch.zeros(a.shape) for n, a in tree["params"].items()},
            "opt_state": {n: tuple(torch.zeros(a.shape, dtype=torch.from_numpy(a).dtype)
                                   for a in v) for n, v in tree["opt_state"].items()},
            "bf16": {n: torch.zeros(a.shape, dtype=torch.bfloat16)
                     for n, a in tree["bf16"].items()},
            "step": np.int64(0)}
    manager = tckpt.sharded_checkpoint_manager(str(root), like=like, world=2, rank=0)
    assert isinstance(manager, tckpt.MultiProcessShardedManager)
    assert manager.latest_step() == 3 and manager.all_steps() == [2, 3]
    with pytest.warns(UserWarning, match="falling back"):
        state, step = manager.load()
    assert step == 2
    _assert_tree_equal(state["params"], tree["params"], "params")
    with pytest.raises(CheckpointCorrupt, match="checksum"):
        manager.verify(str(root / "ckpt-3"))


def test_single_process_manager_writes_the_host_format(tmp_path):
    """One process: ``sharded_checkpoint_manager`` with world 1 writes the
    host format under ``state/`` (no orbax), keeps ``keep`` steps and
    loads the newest."""
    manager = tckpt.sharded_checkpoint_manager(str(tmp_path), keep=2, world=1)
    state = {"params": {"w": torch.arange(6.0).reshape(2, 3)}, "step": np.int64(0)}
    for s in range(3):
        state["params"]["w"] += 1
        manager.save(state, s)
    assert manager.all_steps() == [1, 2]
    assert (tmp_path / "ckpt-2" / "state" / tckpt.HOST_SHARDS_NAME).is_file()
    manager.reader_like = {"params": {"w": torch.zeros(2, 3)}, "step": np.int64(0)}
    got, step = manager.load()
    assert step == 2
    np.testing.assert_array_equal(got["params"]["w"].numpy(), state["params"]["w"].numpy())
    with pytest.raises(ValueError, match="host-sharded"):
        tckpt.load_sharded(str(tmp_path / "ckpt-2"), manager.reader_like)
    params, opt_state, step = tckpt.load_train_state(
        tckpt.save_train_state({"w": torch.ones(2)}, {"w": (torch.zeros(2),)},
                               str(tmp_path / "ts"), step=5),
        {"w": torch.zeros(2)}, {"w": (torch.ones(2),)})
    assert step == 5 and params["w"].tolist() == [1.0, 1.0]
    assert opt_state["w"][0].tolist() == [0.0, 0.0]
