"""The port's BertModel (paddle_tpu_torch/text/models.py) against the JAX
package's at the smoke config of bench.py (vocab 1024, hidden 128, 2
layers, 4 heads, FFN 256, seq 64), in eval mode, with the JAX model's
weights carried across. On the CPU the JAX side takes its plain
``_sdpa_ref``; the port's unmasked attention takes the flash kernel's
plain version, its masked attention its own ``_sdpa_ref``. Tolerance
1e-4 abs."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.text.models import BertModel as JaxBert
from paddle_tpu_torch.convert import load_numpy_state
from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.text.models import BertModel

torch.set_num_threads(1)

SMOKE = dict(vocab_size=1024, hidden_size=128, num_hidden_layers=2,
             num_attention_heads=4, intermediate_size=256)
SEQ = 64
TOL = 1e-4


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JaxBert(**SMOKE)
    jm.eval()
    tm = BertModel(**SMOKE, device="cpu")
    tm.eval()
    load_numpy_state(tm, {n: np.asarray(p.numpy()) for n, p in jm.named_parameters()})
    return jm, tm


def _ids(b, seed=0):
    return np.random.RandomState(seed).randint(0, SMOKE["vocab_size"],
                                               (b, SEQ)).astype(np.int32)


def _both(models, ids, **kw):
    jm, tm = models
    jkw = {k: paddle.to_tensor(v) for k, v in kw.items()}
    js, jp = jm(paddle.to_tensor(ids), **jkw)
    with torch.inference_mode():
        ts, tp = tm(torch.from_numpy(ids), **{k: torch.from_numpy(v) for k, v in kw.items()})
    return (np.asarray(js.numpy()), np.asarray(jp.numpy())), (ts.numpy(), tp.numpy())


def test_parameter_names_shapes_and_dtypes_match(models):
    jm, tm = models
    jp = {n: p for n, p in jm.named_parameters()}
    tp = dict(tm.named_parameters())
    assert list(jp) == list(tp)
    for n in jp:
        assert tuple(jp[n].shape) == tuple(tp[n].shape), n
        assert tp[n].dtype == torch.float32


@pytest.mark.parametrize("batch", [1, 3])
def test_bert_matches_without_mask(models, batch):
    (js, jp), (ts, tp) = _both(models, _ids(batch))
    assert ts.shape == (batch, SEQ, SMOKE["hidden_size"])
    assert tp.shape == (batch, SMOKE["hidden_size"])
    np.testing.assert_allclose(ts, js, rtol=0, atol=TOL)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=TOL)


@pytest.mark.parametrize("kind", ["float", "bool"])
def test_bert_matches_with_attention_mask(models, kind):
    keep = np.ones((2, 1, 1, SEQ), bool)
    keep[1, ..., 40:] = False
    mask = keep if kind == "bool" else np.where(keep, 0.0, -1e4).astype(np.float32)
    (js, jp), (ts, tp) = _both(models, _ids(2, seed=1), attention_mask=mask)
    np.testing.assert_allclose(ts, js, rtol=0, atol=TOL)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=TOL)


def test_bert_token_types_and_positions(models):
    ids = _ids(2, seed=2)
    tt = (np.arange(SEQ)[None, :] >= SEQ // 2).astype(np.int32).repeat(2, 0)
    pos = np.arange(SEQ)[::-1].copy()[None, :].repeat(2, 0).astype(np.int32)
    (js, jp), (ts, tp) = _both(models, ids, token_type_ids=tt, position_ids=pos)
    np.testing.assert_allclose(ts, js, rtol=0, atol=TOL)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=TOL)


def test_cpu_forward_launches_no_kernel(models):
    before = tfa.launches
    _both(models, _ids(1))
    assert tfa.launches == before


def test_training_mode_refuses_dropout(models):
    _, tm = models
    tm.train()
    try:
        with pytest.raises(NotImplementedError, match="training slice"):
            with torch.no_grad():
                tm(torch.from_numpy(_ids(1)))
    finally:
        tm.eval()
