"""paddle_tpu_torch.utils, hub, autograd.backward_mode and
nn.layer.HookRemoveHelper against the JAX package's on the CPU: each case
runs the same calls through both packages and compares what they return
(names, docstrings, warnings, counters, arrays bitwise; the custom op's
gradient and the hub model's output within 1e-6).

- ``cpp_extension`` builds the reference's own test source
  (tests/test_cpp_extension.py ``RELU2_SRC``) with g++ into a directory
  under ``tmp_path``; forward and backward against torch's formula and
  the reference's op; a missing ``_grad`` raises on backward as in the
  reference; the same sources load the built library again.
- ``download``: a local file, the md5 check both ways, the path itself,
  and the refusal to fetch; nothing is fetched.
- ``profiler``: RecordEvent spans in the summary table, a
  ``torch.profiler`` window's trace read back into the per-op table.
"""
import hashlib
import os
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu import utils as jutils
from paddle_tpu_torch import utils as tutils
from paddle_tpu_torch.core import place as tplace
from paddle_tpu_torch.utils import cpp_extension, dlpack, download, image_util, monitor
from paddle_tpu_torch.utils import profiler, unique_name

from test_cpp_extension import RELU2_SRC

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def on_the_cpu():
    prev = tplace._CURRENT
    tp.set_device("cpu")
    yield
    tplace._CURRENT = prev


@pytest.mark.parametrize("pkg", [jutils, tutils], ids=["reference", "port"])
def test_unique_name(pkg):
    un = pkg.unique_name
    with un.guard():
        assert [un.generate("fc"), un.generate("fc"), un.generate("conv")] == \
            ["fc_0", "fc_1", "conv_0"]
        with un.guard("blk/"):
            assert un.generate("fc") == "blk/fc_0"
        assert un.generate("fc") == "fc_2"


def test_deprecated_matches_the_reference():
    def make(pkg):
        @pkg.deprecated(update_to="paddle.new_api", since="2.0", reason="renamed")
        def old_api(x):
            """Adds one."""
            return x + 1
        return old_api

    results = []
    for pkg in (jutils, tutils):
        fn = make(pkg)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn(1)
        results.append((out, fn.__doc__.replace(pkg.deprecated.__module__, "M"),
                        [str(w.message).replace(pkg.deprecated.__module__, "M") for w in caught],
                        [w.category for w in caught]))
    assert results[0] == results[1]
    assert results[1][0] == 2 and results[1][3] == [DeprecationWarning]


def test_try_import():
    assert tutils.try_import("json") is __import__("json")
    with pytest.raises(ImportError, match="custom message"):
        tutils.try_import("no_such_module_here", "custom message")
    with pytest.raises(ImportError, match="not found"):
        jutils.try_import("no_such_module_here")
    with pytest.raises(ImportError, match="not found"):
        tutils.try_import("no_such_module_here")


def test_image_util_bitwise():
    rng = np.random.RandomState(0)
    for img in (rng.randint(0, 255, (3, 10, 12)).astype(np.uint8),
                rng.rand(9, 7, 3).astype(np.float32)):
        for fn, args in (("resize_image", (5,)), ("flip_image", ()), ("crop_img", (4,))):
            got = getattr(image_util, fn)(img, *args)
            want = getattr(jutils.image_util, fn)(img, *args)
            assert got.dtype == want.dtype and np.array_equal(got, want), fn


def test_monitor_counters():
    for mon in (jutils.monitor, monitor):
        mon.stat_reset()
        mon.stat_add("reader_queue", 5)
        mon.stat_add("reader_queue", 2)
        assert mon.stat_sub("reader_queue", 1) == 6
        assert mon.stat_registry() == {"reader_queue": 6}
        mon.stat_reset("reader_queue")
        assert mon.stat_get("reader_queue") == 0


def test_dlpack_round_trip_shares_memory():
    t = tp.to_tensor(np.arange(6, dtype=np.float32).reshape(2, 3))
    back = dlpack.from_dlpack(dlpack.to_dlpack(t))
    assert type(back) is tp.Tensor and back.data_ptr() == t.data_ptr()
    assert np.array_equal(back.numpy(), t.numpy())
    src = torch.arange(4, dtype=torch.int64)
    view = dlpack.from_dlpack(src)  # an object with __dlpack__
    assert view.data_ptr() == src.data_ptr() and view.dtype == torch.int64
    # across the packages: the reference's array into the port
    jt = jp.to_tensor(np.arange(5, dtype=np.float32))
    assert np.array_equal(dlpack.from_dlpack(jutils.dlpack.to_dlpack(jt)).numpy(),
                          np.arange(5, dtype=np.float32))


def test_download_resolves_local_files_only(tmp_path):
    f = tmp_path / "weights.pdparams"
    f.write_bytes(b"paddle weights")
    md5 = hashlib.md5(b"paddle weights").hexdigest()
    url = "https://example.invalid/models/weights.pdparams"
    for mod in (jutils.download, download):
        assert mod.get_path_from_url(url, str(tmp_path)) == str(f)
        assert mod.get_path_from_url(url, str(tmp_path), md5sum=md5) == str(f)
        assert mod.md5check(str(f), md5) and not mod.md5check(str(f), "0" * 32)
        assert mod.md5check(str(f), None)
        with pytest.raises(RuntimeError, match="cannot download"):
            mod.get_path_from_url(url, str(tmp_path), md5sum="0" * 32)
        with pytest.raises(RuntimeError, match="cannot download"):
            mod.get_path_from_url(url, str(tmp_path / "elsewhere"))
        assert mod.get_path_from_url(str(f), str(tmp_path / "elsewhere")) == str(f)


@pytest.mark.parametrize("lo,hi,ok", [("2.0.0", None, True), ("2.1", "2.2", True),
                                      ("2.1.0rc1", None, True), ("2.2.0", None, False),
                                      ("1.8", "2.0.5", False)])
def test_require_version(lo, hi, ok):
    for pkg in (jutils, tutils):
        if ok:
            pkg.require_version(lo, hi)
        else:
            with pytest.raises(Exception, match="required version"):
                pkg.require_version(lo, hi)


def test_op_last_checkpoint_checker(monkeypatch):
    from paddle_tpu.framework import op_version as jver
    from paddle_tpu_torch.framework import op_version as tver

    assert tutils.OpLastCheckpointChecker().checkpoints_map == tver.all_op_versions()
    for ver in (jver, tver):  # a registry of this test's own
        monkeypatch.setattr(ver, "_REGISTRY", dict(ver._REGISTRY))
        ver.register_op_version("utils_test_op").mod("first")
    got, want = tutils.OpLastCheckpointChecker(), jutils.OpLastCheckpointChecker()
    assert got.get_version("utils_test_op") == want.get_version("utils_test_op") == 2
    assert got.get_version("never_registered", 7) == want.get_version("never_registered", 7)


def test_profiler_summary_and_trace(tmp_path):
    profiler.reset_summary()
    with profiler.Profiler() as prof:
        for _ in range(3):
            with profiler.RecordEvent("my_span"):
                torch.ones(8).sum()
    rows = {r["name"]: r for r in profiler.summary(printer=None)}
    assert rows["my_span"]["calls"] == 3 and rows["Profiler"]["calls"] == 1
    assert rows["Profiler"]["total"] >= rows["my_span"]["total"]
    printed = []
    profiler.summary(sorted_by="calls", printer=printed.append)
    assert printed[0].split()[:2] == ["Event", "Calls"] and "my_span" in printed[1]
    prof.reset()
    assert profiler.summary(printer=None) == []
    with profiler.profiler(profile_path=str(tmp_path)):
        with profiler.RecordEvent("traced_step"):
            torch.mm(torch.ones(16, 16), torch.ones(16, 16))
    names = [r["name"] for r in profiler.op_summary_from_trace(str(tmp_path), top=0)]
    assert "traced_step" in names and any("mm" in n for n in names)
    profiler.start_profiler(profile_path=str(tmp_path / "b"))
    torch.ones(4).add_(1)
    path = profiler.stop_profiler()
    assert path.startswith(str(tmp_path / "b")) and path.endswith(".trace.json.gz")
    assert profiler.print_op_summary(str(tmp_path / "b"), printer=lambda s: None)
    assert profiler.get_profiler() is profiler.get_profiler()
    with pytest.raises(RuntimeError):
        profiler.stop_profiler()


@pytest.fixture(scope="module")
def custom_ops(tmp_path_factory):
    d = tmp_path_factory.mktemp("custom_op")
    src = d / "relu2.cc"
    src.write_text(RELU2_SRC)
    jops = jutils.cpp_extension.load("test_ops", [str(src)], build_directory=str(d / "jbuild"))
    tops = cpp_extension.load("test_ops", [str(src)], build_directory=str(d / "tbuild"))
    return jops, tops, src


def test_cpp_extension_forward_and_backward(custom_ops):
    jops, tops, _ = custom_ops
    assert set(tops.op_names) == set(jops.op_names) == {"relu2", "plus_one"}
    xv = np.random.RandomState(0).randn(3, 5).astype(np.float32)
    x = tp.to_tensor(xv, stop_gradient=False)
    y = tops.relu2(x)
    assert type(y) is tp.Tensor
    (y * y).sum().backward()
    jx = jp.to_tensor(xv, stop_gradient=False)
    jy = jops.relu2(jx)
    (jy * jy).sum().backward()
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy.numpy()))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jx.grad.numpy()), rtol=1e-6)
    # against the same formula in torch
    tx = torch.tensor(xv, requires_grad=True)
    ty = torch.where(tx > 0, tx * tx, 0.0)
    (ty * ty).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), tx.grad.numpy(), rtol=1e-6)
    # plain torch tensors in, torch tensors out
    out = tops.plus_one(torch.tensor([1.5, -2.0]))
    assert type(out) is torch.Tensor and out.tolist() == [2.5, -1.0]


def test_cpp_extension_missing_grad_raises_and_cache_reused(custom_ops):
    _, tops, src = custom_ops
    x = tp.to_tensor(np.array([1.0], np.float32), stop_gradient=False)
    y = tops.plus_one(x)
    assert y.numpy().tolist() == [2.0]
    with pytest.raises(NotImplementedError, match="plus_one_grad"):
        y.sum().backward()
    lib = tops._lib_path
    mtime = os.path.getmtime(lib)
    again = cpp_extension.load("test_ops", [str(src)], build_directory=os.path.dirname(lib))
    assert again._lib_path == lib and os.path.getmtime(lib) == mtime


def test_cpp_extension_setup_api(tmp_path):
    src = tmp_path / "neg.cc"
    src.write_text('#include <cstdint>\nextern "C" void negate(const float* x, float* y, '
                   'int64_t n) { for (int64_t i = 0; i < n; ++i) y[i] = -x[i]; }\n')
    mods = cpp_extension.setup(name="neg_ops_port",
                               ext_modules=cpp_extension.CppExtension(sources=[str(src)]))
    assert mods[0].negate(tp.to_tensor(np.array([1.5], np.float32))).numpy().tolist() == [-1.5]
    assert os.path.dirname(os.path.dirname(mods[0]._lib_path)) == \
        cpp_extension._DEFAULT_BUILD_ROOT
    ext = cpp_extension.CUDAExtension([str(src), "kernel.cu", "kernel.cuh"])
    assert ext.sources == [str(src)]


HUBCONF = '''
import paddle_tpu_torch as paddle

def tiny_model(out=2):
    """A tiny test model."""
    return paddle.nn.Linear(3, out)

def _private():
    pass
'''


def test_hub_over_a_local_hubconf(tmp_path):
    (tmp_path / "hubconf.py").write_text(HUBCONF)
    jdir = tmp_path / "ref"
    jdir.mkdir()
    (jdir / "hubconf.py").write_text(HUBCONF.replace("paddle_tpu_torch", "paddle_tpu"))
    assert tp.hub.list(str(tmp_path)) == jp.hub.list(str(jdir)) == ["tiny_model"]
    assert tp.hub.help(str(tmp_path), "tiny_model") == jp.hub.help(str(jdir), "tiny_model")
    net = tp.hub.load(str(tmp_path), "tiny_model", out=4)
    assert isinstance(net, tp.nn.Linear) and tuple(net.weight.shape) == (3, 4)
    for fn in (tp.hub.list, jp.hub.list):
        with pytest.raises(NotImplementedError, match="source='local'"):
            fn("owner/repo", source="github")
    with pytest.raises(ValueError, match="not found"):
        tp.hub.load(str(tmp_path), "missing")
    with pytest.raises(FileNotFoundError):
        tp.hub.list(str(tmp_path / "nowhere"))


def test_hook_remove_helper():
    """A forward pre/post hook's handle is a HookRemoveHelper whose
    remove() undoes the hook, in both packages alike."""
    results = []
    for pkg in (jp, tp):
        from importlib import import_module

        helper = import_module(pkg.__name__ + ".nn.layer").HookRemoveHelper
        lin = pkg.nn.Linear(2, 2)
        x = pkg.to_tensor(np.ones((1, 2), np.float32))
        base = np.asarray(lin(x).numpy())
        pre = lin.register_forward_pre_hook(lambda layer, inp: (inp[0] * 2,))
        post = lin.register_forward_post_hook(lambda layer, inp, out: out + 1.0)
        assert isinstance(pre, helper) and isinstance(post, helper)
        hooked = np.asarray(lin(x).numpy())
        pre.remove()
        mid = np.asarray(lin(x).numpy())
        post.remove()
        post.remove()  # twice is harmless
        results.append((base, hooked, mid, np.asarray(lin(x).numpy())))
    (jb, jh, jm, ja), (tb, th, tm, ta) = results
    np.testing.assert_allclose(tm, tb + 1.0, rtol=1e-6)
    np.testing.assert_array_equal(ta, tb)
    assert not np.allclose(th, tm)
    np.testing.assert_array_equal(ja, jb)
    np.testing.assert_allclose(jm, jb + 1.0, rtol=1e-6)


def test_backward_mode_is_the_tape_backward():
    from paddle_tpu.autograd import backward_mode as jbm
    from paddle_tpu_torch.autograd import backward_mode as tbm

    assert tbm.__all__ == jbm.__all__ == ["backward"]
    assert tbm.backward is tp.autograd.backward
    grads = []
    for pkg, bm in ((jp, jbm), (tp, tbm)):
        x = pkg.to_tensor(np.array([1.0, -2.0, 3.0], np.float32), stop_gradient=False)
        y = (x * x).sum()
        z = (x * 3).sum()
        bm.backward([y, z], [pkg.to_tensor(np.float32(1.0)), pkg.to_tensor(np.float32(2.0))])
        grads.append(np.asarray(x.grad.numpy()))
    np.testing.assert_array_equal(grads[1], grads[0])
    np.testing.assert_array_equal(grads[1], [8.0, 2.0, 12.0])
