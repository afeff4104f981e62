"""dy2static in the port (paddle_tpu_torch/jit/dy2static.py): the ``if`` and
``while`` cases of tests/test_dy2static.py, each run through the port's
``to_static`` and the reference's on the same numpy inputs, on the CPU.
A tensor predicate inside a capture lowers to torch's ``cond`` /
``while_loop``; the same source runs eagerly outside one. Gradients flow
through both operators, and a construct the capture cannot take raises
the explained ``TraceSafetyError``. Then ``to_static`` of whole models,
equal to dygraph and to the reference's ``to_static`` (mirroring
tests/test_to_static_models.py and test_jit_static_amp.py): tiny BERT,
resnet18 at 32 x 32, GPT tokens, auto_cast, dropout keys."""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu.text.models import BertModel as JaxBert
from paddle_tpu_torch import jit as tjit
from paddle_tpu_torch.convert import load_numpy_state
from paddle_tpu_torch.core import place as tplace
from paddle_tpu_torch.jit import dy2static, to_static
from paddle_tpu_torch.text.models import BertModel

TINY = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
            intermediate_size=128)
SEQ = 16

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def on_the_cpu():
    prev = tplace._CURRENT
    tp.set_device("cpu")
    yield
    tplace._CURRENT = prev


def _np(t):
    return np.asarray(t.numpy())


def both(make, *arrays):
    """``make(pkg)`` builds the function for a package; it runs through
    both packages' to_static -> (port outputs, reference outputs), numpy."""
    outs = []
    for pkg in (tp, jp):
        out = pkg.jit.to_static(make(pkg))(*[pkg.to_tensor(a) for a in arrays])
        out = out if isinstance(out, tuple) else (out,)
        outs.append([_np(o) if hasattr(o, "numpy") else np.asarray(o) for o in out])
    return outs


def relu_abs(pkg):
    def f(x):
        if pkg.sum(x) > 0:
            y = x * 2.0
        else:
            y = -x
        return y + 1.0

    return f


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_ifelse_matches_the_reference_and_eager(sign):
    x = np.full((3,), sign, np.float32)
    got, want = both(relu_abs, x)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[0], _np(relu_abs(tp)(tp.to_tensor(x))))


def test_one_capture_serves_both_branches():
    calls = {"n": 0}

    def g(x):
        calls["n"] += 1
        if tp.mean(x) > 0:
            out = x + 10.0
        else:
            out = x - 10.0
        return out

    f = to_static(g)
    a = _np(f(tp.to_tensor(np.ones(2, np.float32))))
    b = _np(f(tp.to_tensor(-np.ones(2, np.float32))))
    np.testing.assert_allclose(a, [11.0, 11.0])
    np.testing.assert_allclose(b, [-11.0, -11.0])
    assert calls["n"] == 1  # one capture, a cond inside


def test_new_var_defined_in_both_branches():
    def make(pkg):
        def g(x):
            if pkg.sum(x) > 0:
                flag = x * 1.0
            else:
                flag = x * 0.0
            return flag

        return g

    got, want = both(make, np.ones(2, np.float32))
    np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.parametrize("v", [10.0, 1.0, -1.0])
def test_elif_chain(v):
    def make(pkg):
        def g(x):
            s = pkg.sum(x)
            if s > 10:
                out = x * 3.0
            elif s > 0:
                out = x * 2.0
            else:
                out = x * 0.0
            return out

        return g

    got, want = both(make, np.full(2, v, np.float32))
    np.testing.assert_array_equal(got[0], want[0])


def test_python_pred_untouched():
    def make(pkg):
        def g(x, flag=True):
            if flag:
                return x + 1.0
            return x - 1.0

        return g

    got, want = both(make, np.zeros(2, np.float32))
    np.testing.assert_array_equal(got[0], [1.0, 1.0])
    np.testing.assert_array_equal(got[0], want[0])


def test_data_dependent_while():
    def make(pkg):
        def g(x):
            while pkg.sum(x) < 100.0:
                x = x * 2.0
            return x

        return g

    got, want = both(make, np.ones(4, np.float32))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[0], np.full(4, 32.0))


def test_while_with_counter():
    def make(pkg):
        def g(x):
            i = 0
            while pkg.max(x) < 50.0:
                x = x + float(1.0)
                i = i + 1
            return x, i

        return g

    got, want = both(make, np.zeros(2, np.float32))
    np.testing.assert_array_equal(got[0], want[0])
    assert int(got[1]) == int(want[1]) == 50


def test_nested_if_in_while():
    def make(pkg):
        def g(x):
            while pkg.sum(x) < 10.0:
                if pkg.min(x) < 1.0:
                    x = x + 1.0
                else:
                    x = x * 1.5
            return x

        return g

    got, want = both(make, np.zeros(2, np.float32))
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)


_module_scale = 100.0


def test_closure_shadows_module_global():
    def outer():
        _module_scale = 2.0  # the module global's name

        def inner(x):
            if tp.sum(x) > 0:
                y = x * _module_scale
            else:
                y = x
            return y

        return inner

    out = _np(to_static(outer())(tp.to_tensor(np.ones(2, np.float32))))
    np.testing.assert_allclose(out, [2.0, 2.0])  # the closure, not 100.0


def test_del_in_branch_keeps_python_semantics():
    def make(pkg):
        def g(x, flag=True):
            if flag:
                tmp = x + 1.0
                out = tmp * 2.0
                del tmp
            else:
                out = x
            return out

        return g

    got, want = both(make, np.zeros(2, np.float32))
    np.testing.assert_array_equal(got[0], want[0])


def test_layer_with_data_dependent_branch():
    def make_gate(pkg):
        class Gate(pkg.nn.Layer):
            def __init__(self):
                super().__init__()
                self.fc = pkg.nn.Linear(4, 4)

            def forward(self, x):
                h = self.fc(x)
                if pkg.mean(h) > 0:
                    out = h * 2.0
                else:
                    out = h * 0.5
                return out

        return Gate()

    tp.seed(0)
    m = make_gate(tp)
    jm = make_gate(jp)
    jm.set_state_dict({n: p.detach().numpy() for n, p in m.state_dict().items()})
    for sign in (1.0, -1.0):
        x = np.full((2, 4), sign, np.float32)
        ref = _np(m(tp.to_tensor(x)))
        got = _np(to_static(m)(tp.to_tensor(x)))
        want = _np(jp.jit.to_static(jm)(jp.to_tensor(x)))
        np.testing.assert_allclose(got, ref, rtol=1e-6)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_gradients_flow_through_cond_and_while():
    def g(x, w):
        if tp.sum(x) > 0:
            y = x * w * 3.0
        else:
            y = x - w
        while tp.max(tp.abs(y)) < 20.0:
            y = y * 2.0
        return y.sum()

    f = to_static(g)
    for sign, want_x in ((1.0, 3.0 * 8), (-1.0, 1.0 * 16)):
        x = torch.full((3,), sign, requires_grad=True)
        w = torch.full((3,), 1.0, requires_grad=True)
        f(x, w).backward()
        xe = torch.full((3,), sign, requires_grad=True)
        we = torch.full((3,), 1.0, requires_grad=True)
        g(xe, we).backward()
        assert torch.equal(x.grad, xe.grad) and torch.equal(w.grad, we.grad)
        assert float(x.grad[0]) == want_x


def test_bounded_while_stops_at_maximum_iterations():
    def cond(v):
        return tp.max(v) > 4.0

    def body(v):
        return (v * 0.5,)

    from paddle_tpu_torch.core.tensor import capture_scope

    x = torch.tensor([16.0, 2.0], requires_grad=True)

    class Loop(torch.nn.Module):
        def forward(self, v):
            with capture_scope():
                return dy2static.convert_while(cond, body, (v,), maximum_iterations=1)[0]

    ep = torch.export.export(Loop(), (torch.tensor([16.0, 2.0]),), strict=False)
    out = ep.module()(x)
    assert out.tolist() == [8.0, 1.0]  # one step, then the bound
    out.sum().backward()
    assert x.grad.tolist() == [0.5, 0.5]
    eager = dy2static.convert_while(cond, body, (torch.tensor([16.0, 2.0]),),
                                    maximum_iterations=8)[0]
    assert eager.tolist() == [4.0, 0.5]


def test_undefined_var_raises_name_error():
    u = dy2static.UndefinedVar("y")
    with pytest.raises(NameError, match="'y'"):
        bool(u)
    with pytest.raises(NameError):
        u.shape  # noqa: B018
    assert dy2static.pack_inputs({"a": 1}, ["a", "b"])[0] == 1


def test_a_host_read_is_explained():
    def bad(x):
        if float(x.sum().item()) > 0:
            return x * 2.0
        return x

    with pytest.raises(dy2static.TraceSafetyError) as info:
        to_static(bad)(tp.to_tensor(np.ones(2, np.float32)))
    codes = [d.code for d in info.value.diagnostics]
    assert codes[0] == "host-read" and "TPU001" in codes
    assert "to_static failed while tracing" in str(info.value)
    assert dy2static.explain_trace_failure(lambda x: x, RuntimeError("x")) is None


# ------------------------------------------------- to_static of whole models


def _train_traj(pkg, model_fn, data_fn, steps=4, use_to_static=False, seed=21, opt_fn=None):
    pkg.seed(seed)
    model = model_fn()
    opt = (opt_fn(model) if opt_fn is not None
           else pkg.optimizer.Adam(1e-3, parameters=model.parameters()))
    fwd = pkg.jit.to_static(model) if use_to_static else model
    losses = []
    for i in range(steps):
        x, y, loss_fn = data_fn(i)
        loss = loss_fn(fwd(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.numpy()))
    return losses


def _head(pkg, **kw):
    def model_fn():
        mod = __import__(pkg.__name__ + ".text.models", fromlist=["BertModel"])
        bert = mod.BertModel(vocab_size=128, hidden_size=32, num_hidden_layers=2,
                             num_attention_heads=2, intermediate_size=64,
                             hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0, **kw)

        class Head(pkg.nn.Layer):
            def __init__(self):
                super().__init__()
                self.bert = bert
                self.cls = pkg.nn.Linear(32, 2)

            def forward(self, ids):
                seq, pooled = self.bert(ids)
                return self.cls(pooled)

        return Head()

    return model_fn


def test_bert_tiny_to_static_equals_dygraph_and_the_reference():
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 128, (4, 16)).astype(np.int32)
    labels = rng.randint(0, 2, (4,)).astype(np.int64)

    def data(pkg):
        ce = pkg.nn.CrossEntropyLoss()
        return lambda i: (pkg.to_tensor(ids), pkg.to_tensor(labels), lambda out, y: ce(out, y))

    eager = _train_traj(tp, _head(tp), data(tp))
    static = _train_traj(tp, _head(tp), data(tp), use_to_static=True)
    np.testing.assert_allclose(static, eager, rtol=1e-5, atol=1e-6)
    ref = _train_traj(jp, _head(jp), data(jp), use_to_static=True)
    # initializations differ between the packages: the reference's
    # trajectory is held in its own right (it falls) and the port's first
    # loss is its dygraph's
    assert ref[-1] < ref[0] and static[-1] < static[0]


def test_bert_to_static_matches_the_references_to_static_from_its_weights():
    jp.seed(0)
    jm = JaxBert(**TINY)
    jm.eval()
    tm = BertModel(**TINY, device="cpu").eval()
    load_numpy_state(tm, {n: np.asarray(p.numpy()) for n, p in jm.named_parameters()})
    ids = np.random.RandomState(11).randint(0, TINY["vocab_size"], (3, SEQ)).astype(np.int32)
    jf = jp.jit.to_static(jm.forward)
    tf = tjit.to_static(tm.forward)
    want = [np.asarray(o.numpy()) for o in jf(jp.to_tensor(ids))]
    got = tf(tp.to_tensor(ids))
    for g, w in zip(got, want):
        assert isinstance(g, tp.Tensor)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4)
    with torch.no_grad():
        direct = tm(torch.from_numpy(ids))
    for g, d in zip(tf(torch.from_numpy(ids)), direct):
        assert torch.equal(g, d)


def test_resnet18_forward_parity_and_both_train():
    from paddle_tpu.vision.models import resnet18 as jresnet18
    from paddle_tpu_torch.vision.models import resnet18

    rng = np.random.RandomState(1)
    x = rng.rand(4, 3, 32, 32).astype(np.float32)
    y = rng.randint(0, 4, (4,)).astype(np.int64)
    tp.seed(21)
    m = resnet18(num_classes=4)
    out_e = m(tp.to_tensor(x)).numpy()
    out_s = tjit.to_static(m)(tp.to_tensor(x)).numpy()
    assert np.array_equal(out_e, out_s)

    def data(pkg):
        ce = pkg.nn.CrossEntropyLoss()
        return lambda i: (pkg.to_tensor(x), pkg.to_tensor(y), lambda out, t: ce(out, t))

    sgd = lambda mm: tp.optimizer.SGD(0.05, parameters=mm.parameters())  # noqa: E731
    eager = _train_traj(tp, lambda: resnet18(num_classes=4), data(tp), steps=6, opt_fn=sgd)
    static = _train_traj(tp, lambda: resnet18(num_classes=4), data(tp), steps=6,
                         use_to_static=True, opt_fn=sgd)
    assert eager[-1] < eager[0] * 0.8 and static[-1] < static[0] * 0.8
    np.testing.assert_allclose(static, eager, rtol=1e-5)
    # BatchNorm's running statistics are written back by the captured step
    jsgd = lambda mm: jp.optimizer.SGD(0.05, parameters=mm.parameters())  # noqa: E731
    ref = _train_traj(jp, lambda: jresnet18(num_classes=4), data(jp), steps=6,
                      use_to_static=True, opt_fn=jsgd)
    assert ref[-1] < ref[0] * 0.8


def test_to_static_writes_batchnorm_statistics_back():
    from paddle_tpu_torch.vision.models import resnet18

    x = np.random.RandomState(2).rand(2, 3, 32, 32).astype(np.float32)
    tp.seed(4)
    a = resnet18(num_classes=3)
    tp.seed(4)
    b = tjit.to_static(resnet18(num_classes=3))
    a(tp.to_tensor(x))
    b(tp.to_tensor(x))
    for (n, ba), (_, bb) in zip(a.named_buffers(), b.named_buffers()):
        assert torch.equal(ba, bb), n


def test_gpt_tiny_generation_same_tokens():
    from paddle_tpu_torch.text import GPTModel, generation

    tp.seed(7)
    model = GPTModel(vocab_size=61, hidden_size=32, num_layers=2, num_heads=4, max_seq_len=32,
                     device="cpu")
    prompt = np.array([[5, 9, 2]], np.int32)
    eager_out = np.asarray(generation.generate(model, prompt, max_new_tokens=5))
    fwd = tjit.to_static(model)
    ids = prompt.copy()
    for _ in range(5):
        logits = fwd(tp.to_tensor(ids)).numpy()
        nxt = logits[:, -1].argmax(-1).astype(np.int32)
        ids = np.concatenate([ids, nxt[:, None]], axis=1)
    np.testing.assert_array_equal(eager_out, ids)


def test_to_static_under_auto_cast_is_its_own_program():
    tp.seed(3)
    m = tp.nn.Linear(8, 8)
    f = tjit.to_static(m)
    x = tp.to_tensor(np.random.RandomState(0).rand(2, 8).astype(np.float32))
    plain = f(x)
    with tp.amp.auto_cast(level="O1", dtype="bfloat16"):
        cast = f(x)
        eager = tp.nn.Linear.forward(m, x)
    assert plain.dtype == torch.float32 and cast.dtype == eager.dtype == torch.bfloat16
    assert torch.equal(cast, eager)
    assert len(f.forward.concrete_program_specs()) == 2


def test_to_static_dropout_takes_the_references_keys():
    """A captured program's random ops take fold_in(call key, i), the
    reference's order: its dropout masks are the reference's."""
    jp.seed(5)
    tp.seed(5)
    x = np.ones((4, 64), np.float32)

    def jdrop(t):
        return jp.nn.functional.dropout(t, p=0.5, training=True)

    def tdrop(t):
        return tp.nn.functional.dropout(t, p=0.5, training=True)

    jf, tf = jp.jit.to_static(jdrop), tjit.to_static(tdrop)
    for _ in range(2):
        want = np.asarray(jf(jp.to_tensor(x)).numpy())
        got = tf(tp.to_tensor(x)).numpy()
        assert np.array_equal(got, want)


def test_program_translator_switches_to_static_off():
    calls = {"n": 0}

    def g(x):
        calls["n"] += 1
        return x * 2.0

    f = tjit.to_static(g)
    x = tp.to_tensor(np.ones(2, np.float32))
    f(x)
    f(x)
    assert calls["n"] == 1  # captured once, the program runs after
    tjit.ProgramTranslator().enable(False)
    try:
        f(x)
        assert calls["n"] == 2 and not tjit.ProgramTranslator.get_instance().enable_to_static
    finally:
        tjit.ProgramTranslator().enable(True)
