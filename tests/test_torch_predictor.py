"""paddle_tpu_torch.inference: Config, create_predictor, the Predictor's
handles, clone and enable_dynamic_batching, against the reference's on
the CPU (tests/test_inference.py's SmallNet, and a tiny BERT of 2 layers,
width 64), and the coalescing contract of inference/batching.py:88-99
held bitwise: a request of >= 2 rows through the engine, and a solo
1-row one, give Predictor.run's bits for the same rows."""
import os
import threading

import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu import inference as jinf
from paddle_tpu.static import InputSpec as JSpec
from paddle_tpu_torch import inference as tinf
from paddle_tpu_torch import jit as tjit
from paddle_tpu_torch.convert import load_numpy_state
from paddle_tpu_torch.core import place as tplace
from paddle_tpu_torch.inference.batching import AotLayerRunner, BatchingEngine
from paddle_tpu_torch.static import InputSpec
from paddle_tpu_torch.text.models import BertModel

torch.set_num_threads(1)

SEQ = 16
TINY = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
            intermediate_size=128)


@pytest.fixture(autouse=True, scope="module")
def on_the_cpu():
    prev = tplace._CURRENT
    tp.set_device("cpu")
    yield
    tplace._CURRENT = prev


def small_net(pkg):
    class SmallNet(pkg.nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = pkg.nn.Linear(8, 16)
            self.fc2 = pkg.nn.Linear(16, 3)

        def forward(self, x):
            return pkg.nn.functional.softmax(self.fc2(pkg.nn.functional.relu(self.fc1(x))),
                                             axis=-1)

    return SmallNet()


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """The reference's SmallNet saved by both packages (same weights) at
    [4, 8]; a tiny BERT saved by the port batch-polymorphic."""
    d = tmp_path_factory.mktemp("pred")
    jp.seed(7)
    jm = small_net(jp)
    jm.eval()
    tm = small_net(tp).eval()
    load_numpy_state(tm, {n: np.asarray(p.numpy()) for n, p in jm.named_parameters()})
    ref, port = str(d / "ref" / "model"), str(d / "port" / "model")
    jp.jit.save(jm, ref, input_spec=[JSpec([4, 8], "float32")])
    tjit.save(tm, port, input_spec=[InputSpec([4, 8], "float32")])
    bert = BertModel(**TINY, device="cpu", generator=torch.Generator().manual_seed(0)).eval()
    bpath = str(d / "bert" / "model")
    tjit.save(bert, bpath, input_spec=[InputSpec([None, SEQ], "int32")])
    x = np.random.RandomState(0).randn(4, 8).astype(np.float32)
    return ref, port, bpath, x


def _pred(pkg_inf, prefix):
    cfg = pkg_inf.Config(prefix)
    cfg.disable_gpu()
    return pkg_inf.create_predictor(cfg)


def test_config_matches_the_reference(saved):
    ref, port, _, _ = saved
    for inf, prefix in ((jinf, ref), (tinf, port)):
        cfg = inf.Config(prefix)
        assert cfg.model_prefix() == prefix and cfg.is_valid()
        assert inf.Config(os.path.dirname(prefix)).model_prefix() == prefix
        assert cfg.use_gpu()  # the accelerator by default
        cfg.disable_gpu()
        assert not cfg.use_gpu()
        cfg.enable_use_gpu(100, 0)
        assert cfg.use_gpu() and cfg.gpu_device_id() == 0
        cfg.enable_tensorrt_engine(max_batch_size=4, precision_mode=inf.PrecisionType.Bfloat16)
        assert cfg.tensorrt_engine_enabled() and cfg.max_batch_size() == 4
        assert cfg.precision() == inf.PrecisionType.Bfloat16
        cfg.enable_dynamic_batching(max_batch_size=8, max_wait_ms=3.0)
        assert cfg.max_batch_size() == 8 and cfg.dynamic_batching_enabled()
        assert "model_prefix" in cfg.summary()
        assert not inf.Config().is_valid()
    assert [m.name for m in tinf.PrecisionType] == [m.name for m in jinf.PrecisionType]
    assert [m.name for m in tinf.PlaceType] == [m.name for m in jinf.PlaceType]
    assert set(tinf.__all__) >= {"Config", "Predictor", "create_predictor", "Tensor",
                                 "DataType", "PrecisionType", "PlaceType"}


def test_handles_and_run_match_the_reference(saved):
    ref, port, _, x = saved
    outs = {}
    for name, inf, prefix in (("ref", jinf, ref), ("port", tinf, port)):
        pred = _pred(inf, prefix)
        assert pred.get_input_names() == ["x0"] and pred.get_output_names() == []
        h = pred.get_input_handle("x0")
        h.reshape([4, 8])
        h.copy_from_cpu(x)
        assert h.shape() == [4, 8] and h.name() == "x0"
        assert pred.run() is True
        assert pred.get_output_names() == ["out0"]
        o = pred.get_output_handle("out0")
        assert o.shape() == [4, 3] and o.type() == "float32"
        outs[name] = (o.copy_to_cpu(), pred.run([x])[0])
        with pytest.raises(KeyError):
            pred.get_input_handle("nope")
        with pytest.raises(RuntimeError):
            h.copy_to_cpu()
        with pytest.raises(ValueError):
            pred.run([x, x])
    for a, b in zip(outs["port"], outs["ref"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


def test_clone_shares_the_loaded_layer(saved):
    _, port, _, x = saved
    pred = _pred(tinf, port)
    twin = pred.clone()
    assert twin._layer is pred._layer and twin._device == pred._device
    got = []

    def run(p):
        got.append(p.run([x])[0])

    threads = [threading.Thread(target=run, args=(p,)) for p in (pred, twin)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert np.array_equal(got[0], got[1])


def test_predictor_needs_a_card_unless_the_cpu_is_asked_for(saved):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the no-card behaviour is not observable")
    _, port, _, _ = saved
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tinf.create_predictor(tinf.Config(port))
    with pytest.raises(TypeError):
        tinf.create_predictor(port)


def test_enable_dynamic_batching_matches_the_reference(saved):
    _, _, bpath, _ = saved
    pred = _pred(tinf, bpath)
    eng = pred.enable_dynamic_batching(max_batch_size=4, max_wait_ms=5.0)
    try:
        assert pred.batching_engine() is eng
        assert pred.clone().batching_engine() is eng
        assert eng.stats()["declared_buckets"] == [1, 2, 4]
        with pytest.warns(RuntimeWarning):
            assert pred.enable_dynamic_batching(max_batch_size=8) is eng
        ids = np.random.RandomState(1).randint(0, 128, (3, SEQ)).astype(np.int32)
        outs = pred.run([ids])
        h = pred.get_input_handle("x0")
        h.copy_from_cpu(ids)
        assert pred.run() is True
        assert np.array_equal(pred.get_output_handle("out0").copy_to_cpu(), outs[0])
    finally:
        pred.disable_dynamic_batching()
    assert pred.batching_engine() is None and eng.health()["closed"]
    direct = pred.run([ids])
    assert all(np.array_equal(a, b) for a, b in zip(direct, outs))


def test_the_runner_takes_batch_polymorphic_saves_only(saved, tmp_path):
    _, port, bpath, _ = saved
    with pytest.raises(ValueError, match="batch-polymorphic"):
        AotLayerRunner(tjit.load(port))
    runner = AotLayerRunner(tjit.load(bpath))
    assert runner.default_signature() == (("<i4", (SEQ,)),)
    assert runner.quant_mode is None


@pytest.mark.parametrize("slab", [2, 8])
def test_coalesced_requests_are_bitwise_predictor_run(saved, slab):
    """The contract: 2- and 3-row requests coalesced into one batch, a
    solo 1-row request, and the rows of a split request, each bitwise
    Predictor.run of the same rows; slabs keep every program call at one
    row count."""
    _, _, bpath, _ = saved
    pred = _pred(tinf, bpath)
    pred._layer.set_slab_rows(slab)
    layer = tjit.load(bpath, slab_rows=slab)
    eng = BatchingEngine.for_layer(layer, max_batch_size=8, max_wait_ms=50.0)
    eng.warmup()
    rng = np.random.RandomState(5)
    reqs = [rng.randint(0, 128, (n, SEQ)).astype(np.int32) for n in (2, 3, 2)]
    try:
        got = [None] * len(reqs)
        gate = threading.Barrier(len(reqs))

        def client(i):
            gate.wait()
            got[i] = eng.infer([reqs[i]], timeout=60)

        threads = [threading.Thread(target=client, args=(i,)) for i in range(len(reqs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert sum(d["batches"] for ds in eng.stats()["buckets"].values() for d in ds) < 3
        solo = rng.randint(0, 128, (1, SEQ)).astype(np.int32)
        big = rng.randint(0, 128, (11, SEQ)).astype(np.int32)  # split into 8 + 3
        for ids, outs in list(zip(reqs, got)) + [(solo, eng.infer([solo])),
                                                 (big, eng.infer([big]))]:
            want = pred.run([ids])
            assert all(np.array_equal(a, b) for a, b in zip(outs, want)), ids.shape
    finally:
        eng.close()
