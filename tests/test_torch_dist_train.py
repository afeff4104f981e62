"""The port's data-parallel training step (``build_train_step(mesh=
build_mesh(dp=2))`` over two gloo ranks on the CPU, started by the port's
launcher from tests/torch_dist_worker.py) against the JAX package's
one-device step on the global batch, and the dropout masks a rank draws
against the reference's global masks.

The reference's mesh step is one program over the global batch; the
port's rank r holds rows [r * B, (r + 1) * B) and draws its slice of the
global masks (``dp_shard_guard``: ``fast_keep_mask``'s flat index and the
flash kernels' ``bh_offset``). Tolerances, each with its reason:
- losses: the reference's own two-process tolerance (rtol 2e-5, atol
  1e-6, tests/test_distributed.py);
- the first step's clipped gradients (AdamW's first moment / (1 - beta1))
  within 1e-4 of each tensor's max plus 1e-8, and the parameters after
  three steps within 2.5 * lr: tests/test_torch_train.py's one-device
  bounds;
- the masks and the two ranks' parameters: bitwise.
The JAX side runs its Pallas kernels in interpret mode (``_use_pallas``
patched, ``pallas_attention_min_seq`` 0) so both sides drop by the kernel
hash. Each spawned run has its own timeout (torch_dist_worker.RANK_TIMEOUT).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.core import random as jrandom
from paddle_tpu.distributed import spmd as jspmd
from paddle_tpu.distributed import topology as jtopology
from paddle_tpu.ops import attention as jattention
from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu.text.models import BertForPretraining as JaxPretraining
from paddle_tpu_torch.core import random as trandom
from paddle_tpu_torch.ops import flash_attention as tfa

import torch_dist_worker as W

torch.set_num_threads(2)


class _JaxWrapper(jnn.Layer):
    def __init__(self, inner, seq_len):
        super().__init__()
        self.inner = inner
        self.seq_len = seq_len

    def forward(self, packed):
        return self.inner(packed[:, :self.seq_len],
                          masked_positions=packed[:, self.seq_len:])[0]


def _jax_loss(logits, labels):
    logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
    return -jnp.mean(jnp.take_along_axis(logp, labels[..., None], axis=-1)[..., 0])


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The JAX one-device step on the global batch: its weights (saved for
    the ranks), losses, first-step gradients and final parameters."""
    tmp = tmp_path_factory.mktemp("mesh_ref")
    saved = jattention._use_pallas
    jattention._use_pallas = lambda: True
    paddle.set_flags({"pallas_attention_min_seq": 0})
    try:
        paddle.seed(0)
        jw = _JaxWrapper(JaxPretraining(**W.BERT), W.SEQ)
        state = {n: np.asarray(p.numpy()) for n, p in jw.named_parameters()}
        np.savez(tmp / "weights.npz", **state)
        opt = jopt.AdamW(W.LR, parameters=jw.parameters(), weight_decay=0.01,
                         grad_clip=jnn.ClipGradByGlobalNorm(1.0))
        step, init = jspmd.build_train_step(
            jw, _jax_loss, opt, mesh=jtopology.build_mesh(dp=1, devices=jax.devices()[:1]))
        params, st = init()
        x, y = W.mesh_batch()
        losses, grads = [], None
        for i in range(W.STEPS):
            loss, params, st = step(params, st, jnp.asarray(x), jnp.asarray(y),
                                    key=jax.random.fold_in(jax.random.PRNGKey(0), i))
            losses.append(float(loss))
            if i == 0:
                grads = {n: np.asarray(s[0]) / (1 - 0.9) for n, s in st.items()}
    finally:
        paddle.set_flags({"pallas_attention_min_seq": 1024})
        jattention._use_pallas = saved
    return dict(weights=tmp / "weights.npz", losses=losses, grads=grads,
                params={n: np.asarray(p) for n, p in params.items()})


def test_mesh_step_over_two_ranks_is_the_reference_global_step(reference, tmp_path):
    rc, log = W.run_ranks("mesh_step", tmp_path, reference["weights"])
    assert rc == 0, log[-6000:]
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in (0, 1)]
    for r in ranks:
        got = [float(r[f"loss{i}"]) for i in range(W.STEPS)]
        np.testing.assert_allclose(got, reference["losses"], rtol=2e-5, atol=1e-6)
    assert reference["losses"][-1] != reference["losses"][0]
    for n, want in reference["grads"].items():
        got = ranks[0][f"grad0/{n}"]
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max() + 1e-8,
                                   err_msg=n)
    names = [k for k in ranks[0].files if k.startswith("param/")]
    assert len(names) == len(reference["params"])
    for k in names:
        n = k[len("param/"):]
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=n)
        np.testing.assert_allclose(ranks[0][k], reference["params"][n], rtol=0,
                                   atol=2.5 * W.LR, err_msg=n)


def test_a_nan_on_one_rank_drops_the_step_on_both(reference, tmp_path):
    rc, log = W.run_ranks("bad_step", tmp_path, reference["weights"])
    assert rc == 0, log[-6000:]
    got = [json.load(open(tmp_path / f"rank{r}.json")) for r in (0, 1)]
    for g in got:
        assert g["bad"] == [False, True], g
        assert g["kept"] and g["word_equal"] and g["first_step_moved"], g
        assert np.isfinite(g["loss0"]) and not np.isfinite(g["loss1"]), g
    assert got[0]["loss0"] == got[1]["loss0"]
    np.testing.assert_allclose(got[0]["loss0"], reference["losses"][0], rtol=2e-5, atol=1e-6)


@pytest.mark.parametrize("shape,keep", [((8, 16, 64), 0.9), ((6, 4, 16, 16), 0.5), ((4, 7), 0.9)])
def test_rank_fast_keep_masks_concatenate_to_the_global_mask(shape, keep):
    key = jax.random.fold_in(jax.random.PRNGKey(11), 3)
    want = np.asarray(jrandom.fast_keep_mask(key, keep, shape))
    tkey = trandom.fold_in(trandom.PRNGKey(11), 3)
    for world in (2, shape[0]):
        b = shape[0] // world
        parts = []
        for r in range(world):
            with trandom.dp_shard_guard(r, b):
                parts.append(trandom.fast_keep_mask(tkey, keep, (b,) + shape[1:], "cpu").numpy())
        np.testing.assert_array_equal(np.concatenate(parts), want)
    # rank 0 draws what no guard draws; a leading axis that is not the
    # local batch raises instead of drawing a mask that is not the global one
    with trandom.dp_shard_guard(0, shape[0]):
        np.testing.assert_array_equal(
            trandom.fast_keep_mask(tkey, keep, shape, "cpu").numpy(), want)
    with trandom.dp_shard_guard(1, 3), pytest.raises(ValueError, match="local batch"):
        trandom.fast_keep_mask(tkey, keep, (5,) + shape[1:], "cpu")


@pytest.mark.parametrize("seed", [0, 12345, 2**31 - 1])
def test_kernel_masks_with_bh_offset_are_slices_of_the_global_mask(seed):
    """The plain versions' hash with ``bh_offset`` (K1's ``_dropout_keep``)
    for each rank's batch-heads, concatenated, is the reference kernel's
    ``_keep_mask`` over the global batch-heads; and K1's and K2/K3's plain
    versions on a rank's rows with its offset are bitwise the rows of the
    global call."""
    bh_global, sq, sk, world, p = 8 * 4, 16, 16, 2, 0.1
    thresh = jfa._keep_thresh(p)  # takes the dropout rate
    rows_j = jnp.arange(sq, dtype=jnp.int32)[:, None] + jnp.zeros((1, sk), jnp.int32)
    cols_j = jnp.arange(sk, dtype=jnp.int32)[None, :] + jnp.zeros((sq, 1), jnp.int32)
    seed_u = jnp.asarray(seed, jnp.int32).astype(jnp.uint32)
    want = np.stack([np.asarray(jfa._keep_mask(seed_u, jnp.asarray(b, jnp.int32), rows_j,
                                               cols_j, sq, sk, thresh))
                     for b in range(bh_global)])
    local = bh_global // world
    rows, cols = torch.arange(sq)[:, None], torch.arange(sk)[None, :]
    got = np.concatenate([tfa._dropout_keep(seed, local, rows, cols, sk, p, r * local).numpy()
                          for r in range(world)])
    np.testing.assert_array_equal(got, want)

    rng = np.random.RandomState(seed % 1000)
    q, k, v, do = (torch.from_numpy(rng.randn(bh_global, sq, 16).astype(np.float32))
                   for _ in range(4))
    o, lse = tfa.mha_reference(q, k, v, seed, dropout_p=p)
    grads = tfa.mha_bwd_reference(q, k, v, o, lse, do, seed, dropout_p=p)
    for r in range(world):
        s = slice(r * local, (r + 1) * local)
        ol, lsel = tfa._fwd(q[s], k[s], v[s], seed, 0.25, False, p, bh_offset=r * local)
        assert torch.equal(ol, o[s]) and torch.equal(lsel, lse[s])
        gl = tfa._bwd(q[s], k[s], v[s], ol, lsel, do[s], seed, 0.25, False, p,
                      bh_offset=r * local)
        for a, b in zip(gl, grads):
            assert torch.equal(a, b[s])


def test_mha_takes_the_rank_offset_inside_the_guard():
    """mha under dp_shard_guard(r, b) passes bh_offset = r * b * heads: a
    rank's output is the global output's rows; outside the guard, offset 0."""
    rng = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rng.randn(4, 2, 16, 16).astype(np.float32)) for _ in range(3))
    full = tfa.mha(q, k, v, dropout_p=0.1, seed=7)
    for r in range(2):
        with trandom.dp_shard_guard(r, 2):
            part = tfa.mha(q[2 * r:2 * r + 2], k[2 * r:2 * r + 2], v[2 * r:2 * r + 2],
                           dropout_p=0.1, seed=7)
        assert torch.equal(part, full[2 * r:2 * r + 2])
    assert torch.equal(tfa.mha(q[:2], k[:2], v[:2], dropout_p=0.1, seed=7), full[:2])
    with trandom.dp_shard_guard(1, 3), pytest.raises(ValueError, match="local batch"):
        tfa.mha(q[:2], k[:2], v[:2], dropout_p=0.1, seed=7)
