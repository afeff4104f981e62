"""The port's CheckpointManager (paddle_tpu_torch/resilience/checkpoint.py):
the JAX package's tests/test_resilience_checkpoint.py cases run on the
port (atomic publish, manifest verification with fallback, retention,
chaos-injected write failures, leaf checksums), and checkpoints that cross
between the two packages: written by either, loaded by the other bitwise,
with manifests of the same keys and the same file and leaf checksums for
the same state. Tolerance: none, bitwise.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu.resilience import CheckpointManager as JaxManager
from paddle_tpu.resilience import chaos as jchaos
from paddle_tpu_torch.core import place as tplace
from paddle_tpu_torch.obs import goodput, tracing
from paddle_tpu_torch.resilience import (CheckpointCorrupt, CheckpointManager, RetryError,
                                         chaos)
from paddle_tpu_torch.resilience.checkpoint import (LATEST_NAME, MANIFEST_NAME,
                                                    atomic_write_json, file_sha256,
                                                    flatten_tree, leaf_checksums)

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _clean():
    chaos.reset()
    jchaos.reset()
    saved = tplace._CURRENT
    tp.set_device("cpu")
    yield
    chaos.reset()
    jchaos.reset()
    tplace._CURRENT = saved


def _state(v):
    return {"params": {"w": np.full((2, 3), v, np.float32),
                       "b": np.arange(3, dtype=np.float32)},
            "step": int(v)}


def _array(x):
    return x.numpy() if hasattr(x, "numpy") else np.asarray(x)


class TestAtomicSave:
    def test_save_load_roundtrip(self, tmp_path):
        m = CheckpointManager(tmp_path)
        m.save(_state(7), 7)
        state, step = m.load()
        assert step == 7
        np.testing.assert_array_equal(_array(state["params"]["w"]),
                                      np.full((2, 3), 7, np.float32))

    def test_manifest_has_files_and_leaves(self, tmp_path):
        m = CheckpointManager(tmp_path, leaf_manifest=True)
        path = m.save(_state(1), 1)
        with open(os.path.join(path, MANIFEST_NAME)) as f:
            manifest = json.load(f)
        assert manifest["step"] == 1
        rec = manifest["files"]["state.pdparams"]
        full = os.path.join(path, "state.pdparams")
        assert rec["sha256"] == file_sha256(full)
        assert rec["size"] == os.path.getsize(full)
        assert manifest["leaves"]["params.w"]["shape"] == [2, 3]

    def test_leaf_manifest_off_by_default(self, tmp_path):
        m = CheckpointManager(tmp_path)
        path = m.save(_state(1), 1)
        with open(os.path.join(path, MANIFEST_NAME)) as f:
            manifest = json.load(f)
        assert "leaves" not in manifest
        assert m.load()[1] == 1

    def test_latest_pointer_tracks_newest(self, tmp_path):
        m = CheckpointManager(tmp_path)
        for s in (1, 5, 9):
            m.save(_state(s), s)
        assert m.latest_step() == 9
        with open(os.path.join(tmp_path, LATEST_NAME)) as f:
            assert f.read().strip() == "ckpt-9"

    def test_no_partial_state_visible_after_crash(self, tmp_path):
        m = CheckpointManager(tmp_path, io_retries=1)
        m.save(_state(1), 1)
        with chaos.fault("checkpoint.rename", exc=OSError("killed"), times=99):
            with pytest.raises((OSError, RetryError)):
                m.save(_state(2), 2)
        assert m.latest_step() == 1 and m.all_steps() == [1]
        assert m.load()[1] == 1

    def test_resave_of_a_step_replaces_it(self, tmp_path):
        m = CheckpointManager(tmp_path)
        m.save(_state(3), 3)
        m.save(_state(4), 3)
        state, step = m.load()
        assert step == 3 and int(state["step"]) == 4
        assert [n for n in os.listdir(tmp_path) if n.startswith(".")] == []

    def test_torch_tensors_and_telemetry(self, tmp_path):
        """A state of torch tensors (a bfloat16 one as its 16-bit words)
        comes back bitwise; a save counts, is accounted as goodput's
        checkpoint time and leaves a checkpoint.save span."""
        from paddle_tpu_torch.resilience import checkpoint as ck

        def saves():
            fam = ck._SAVES.collect()
            assert fam.name == "paddle_checkpoint_saves_total"
            return fam.samples[0][2]

        saves0 = saves()
        acct0 = goodput.report()["checkpoint_s"]
        state = {"w": torch.randn(4, 3), "h": torch.randn(5).to(torch.bfloat16),
                 "t": torch.tensor(2.0)}
        m = CheckpointManager(tmp_path, leaf_manifest=True)
        m.save(state, 2)
        got, step = m.load()
        assert step == 2
        for k, v in state.items():
            g = got[k]
            g = g if isinstance(g, torch.Tensor) else torch.from_numpy(np.asarray(g))
            assert g.dtype == v.dtype and torch.equal(g, v), k
        assert saves() == saves0 + 1
        assert goodput.report()["checkpoint_s"] > acct0
        assert any(s["name"] == "checkpoint.save" for s in tracing.finished())
        with open(os.path.join(m.path(2), MANIFEST_NAME)) as f:
            leaves = json.load(f)["leaves"]
        assert leaves["h"]["dtype"] == "bfloat16" and leaves["w"]["shape"] == [4, 3]


class TestVerifyFallback:
    def test_corrupt_payload_falls_back(self, tmp_path):
        m = CheckpointManager(tmp_path)
        m.save(_state(1), 1)
        m.save(_state(2), 2)
        with open(os.path.join(m.path(2), "state.pdparams"), "wb") as f:
            f.write(b"bitrot")
        with pytest.warns(UserWarning, match="falling back"):
            _, step = m.load()
        assert step == 1

    def test_corrupt_manifest_falls_back(self, tmp_path):
        m = CheckpointManager(tmp_path)
        m.save(_state(1), 1)
        m.save(_state(2), 2)
        with open(os.path.join(m.path(2), MANIFEST_NAME), "w") as f:
            f.write('{"truncated')
        with pytest.warns(UserWarning):
            _, step = m.load()
        assert step == 1

    def test_verify_raises_on_tamper(self, tmp_path):
        m = CheckpointManager(tmp_path)
        path = m.save(_state(3), 3)
        with open(os.path.join(path, "state.pdparams"), "ab") as f:
            f.write(b"x")
        with pytest.raises(CheckpointCorrupt):
            m.verify(path)

    def test_all_corrupt_returns_none(self, tmp_path):
        m = CheckpointManager(tmp_path)
        m.save(_state(1), 1)
        with open(os.path.join(m.path(1), "state.pdparams"), "wb") as f:
            f.write(b"")
        with pytest.warns(UserWarning):
            state, step = m.load()
        assert state is None and step == -1

    def test_empty_dir_loads_none(self, tmp_path):
        state, step = CheckpointManager(tmp_path).load()
        assert state is None and step == -1


class TestRetentionGC:
    def test_keeps_newest_n(self, tmp_path):
        m = CheckpointManager(tmp_path, keep=2)
        for s in range(1, 6):
            m.save(_state(s), s)
        assert m.all_steps() == [4, 5]

    def test_stale_tmp_dirs_cleaned(self, tmp_path):
        m = CheckpointManager(tmp_path)
        stale = os.path.join(tmp_path, ".tmp-ckpt-99-12345")
        os.makedirs(stale)
        m.save(_state(1), 1)
        assert not os.path.exists(stale)


class TestChaosInjectedWrites:
    @pytest.mark.chaos
    def test_transient_write_error_retries_and_succeeds(self, tmp_path):
        m = CheckpointManager(tmp_path, io_retries=3)
        with chaos.fault("checkpoint.write", exc=OSError("EIO"), at=1):
            m.save(_state(4), 4)
        assert m.load()[1] == 4

    @pytest.mark.chaos
    def test_persistent_write_error_leaves_previous_good(self, tmp_path):
        m = CheckpointManager(tmp_path, io_retries=2)
        m.save(_state(1), 1)
        with chaos.fault("checkpoint.write", exc=OSError("EIO"), times=99):
            with pytest.raises(RetryError):
                m.save(_state(2), 2)
        assert [n for n in os.listdir(tmp_path) if n.startswith(".tmp")] == []
        assert m.load()[1] == 1

    @pytest.mark.chaos
    def test_a_failed_latest_flip_keeps_the_published_checkpoint(self, tmp_path):
        m = CheckpointManager(tmp_path)
        m.save(_state(1), 1)
        with chaos.fault("checkpoint.latest", exc=OSError("killed"),
                         at=chaos.visits("checkpoint.latest") + 1):
            with pytest.raises(OSError):
                m.save(_state(2), 2)
        # published but LATEST still names 1: the load takes LATEST's first
        assert m.all_steps() == [1, 2] and m.load()[1] == 1


class TestLeafChecksums:
    def test_distinct_leaves_distinct_hashes(self):
        sums = leaf_checksums({"a": np.zeros(3), "b": np.ones(3)})
        assert sums["a"]["sha256"] != sums["b"]["sha256"]

    def test_atomic_write_json_replaces(self, tmp_path):
        p = os.path.join(tmp_path, "m.json")
        atomic_write_json(p, {"v": 1})
        atomic_write_json(p, {"v": 2})
        with open(p) as f:
            assert json.load(f)["v"] == 2
        assert [n for n in os.listdir(tmp_path) if "tmp" in n] == []

    def test_flatten_names_match_the_reference(self):
        from paddle_tpu.resilience.checkpoint import flatten_tree as jflatten

        tree = {"a": [np.zeros(2), (np.ones(1), {"x": 3})], "b": {"c": np.arange(4)}}
        assert list(flatten_tree(tree)) == list(jflatten(tree))
        assert list(flatten_tree(np.zeros(1))) == ["<root>"]


# ------------------------------------------------------------- cross-package


def _cross_state(seed):
    rng = np.random.RandomState(seed)
    return {"params": {"w": rng.randn(4, 3).astype(np.float32),
                       "b": rng.randn(3).astype(np.float32)},
            "opt": {"w": [rng.randn(4, 3).astype(np.float32), np.float32(3.0)]},
            "step": 5}


def _manifest(path):
    with open(os.path.join(path, MANIFEST_NAME)) as f:
        return json.load(f)


@pytest.mark.parametrize("as_tensors", [False, True], ids=["arrays", "tensors"])
def test_reference_checkpoint_loads_in_the_port_bitwise(tmp_path, as_tensors):
    state = _cross_state(0)
    saved = state
    if as_tensors:  # the reference's own Tensors in the tree
        saved = {"params": {k: jp.to_tensor(v) for k, v in state["params"].items()},
                 "opt": state["opt"], "step": state["step"]}
    jm = JaxManager(tmp_path / "ref", leaf_manifest=True)
    path = jm.save(saved, 5, extra={"by": "reference"})
    tm = CheckpointManager(tmp_path / "ref")
    got, step = tm.load()
    assert step == 5 and _manifest(path)["extra"] == {"by": "reference"}
    for k in ("w", "b"):
        np.testing.assert_array_equal(_array(got["params"][k]), state["params"][k])
        assert _array(got["params"][k]).dtype == np.float32
    np.testing.assert_array_equal(_array(got["opt"]["w"][0]), state["opt"]["w"][0])
    assert int(got["step"]) == 5
    tm.verify(path)


def test_port_checkpoint_loads_in_the_reference_bitwise(tmp_path):
    state = _cross_state(1)
    tstate = {"params": {k: tp.to_tensor(v) for k, v in state["params"].items()},
              "opt": {"w": [torch.from_numpy(state["opt"]["w"][0]), torch.tensor(3.0)]},
              "step": 5}
    path = CheckpointManager(tmp_path / "port", leaf_manifest=True).save(tstate, 5)
    jm = JaxManager(tmp_path / "port")
    got, step = jm.load()
    assert step == 5
    for k in ("w", "b"):
        v = got["params"][k]
        np.testing.assert_array_equal(np.asarray(v._value if hasattr(v, "_value") else v),
                                      state["params"][k])
    np.testing.assert_array_equal(np.asarray(got["opt"]["w"][0]), state["opt"]["w"][0])
    assert np.asarray(got["opt"]["w"][1]) == np.float32(3.0)
    jm.verify(path)


def test_manifests_of_the_two_packages_agree(tmp_path):
    """The same state through either package: manifests with the same keys,
    the same files, and the same per-leaf checksums, dtypes and shapes."""
    state = _cross_state(2)
    pj = JaxManager(tmp_path / "j", leaf_manifest=True).save(state, 9)
    pt = CheckpointManager(tmp_path / "t", leaf_manifest=True).save(state, 9)
    mj, mt = _manifest(pj), _manifest(pt)
    assert set(mj) == set(mt) == {"format", "step", "ts", "files", "leaves"}
    assert mj["format"] == mt["format"] and mj["step"] == mt["step"] == 9
    assert set(mj["files"]) == set(mt["files"]) == {"state.pdparams"}
    assert mj["leaves"] == mt["leaves"]
    assert sorted(os.listdir(tmp_path / "j")) == sorted(os.listdir(tmp_path / "t"))
    # a torch tensor leaf hashes as the reference hashes the same array
    tsums = leaf_checksums({"params": {k: torch.from_numpy(v)
                                       for k, v in state["params"].items()}})
    assert tsums["params.w"] == mj["leaves"]["params.w"]


def test_both_packages_fall_back_past_the_same_corruption(tmp_path):
    jm = JaxManager(tmp_path)
    jm.save(_cross_state(3), 1)
    CheckpointManager(tmp_path).save(_cross_state(4), 2)
    with open(os.path.join(tmp_path, "ckpt-2", "state.pdparams"), "r+b") as f:
        f.seek(10)
        f.write(b"\x00\x01")
    with pytest.warns(UserWarning):
        _, tstep = CheckpointManager(tmp_path).load()
    with pytest.warns(UserWarning):
        _, jstep = jm.load()
    assert tstep == jstep == 1
    assert jnp.asarray(1) == 1  # jax stays on the CPU here
