"""Ring attention in the port (paddle_tpu_torch/ops/ring_attention.py)
against the JAX package's ``ring_attention`` on its 8-device CPU mesh and
against dense attention: causal and not, the output and dQ/dK/dV, at
head_dim 8 and 128, over two and four gloo ranks (sp = the world; the
ranks run tests/torch_dist_model_parallel_worker.py modes ``ring2`` and
``ring4`` through the port's launcher, one spawn each with its own
timeout), with one shard in this process, and over ``fleet``'s
``sep_degree``. Each rank holds its sequence shard; the test joins the
ranks' shards along the sequence. On the CPU each block runs K1-K3's plain
versions; the plain fold (``ring_attention_reference``) is held beside.

Tolerances: 1e-5 absolute (and relative) for the output and the
gradients, the reference's own ring-vs-dense bound
(tests/test_ring_attention.py); float64 dense attention is the oracle
both sides are held to.
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.distributed import topology as jtopology
from paddle_tpu.ops import ring_attention as jra
from paddle_tpu_torch.distributed import topology as ttopology
from paddle_tpu_torch.ops import ring_attention as tra

import torch_dist_model_parallel_worker as M
import torch_dist_worker as W

torch.set_num_threads(2)
SPAWN_TIMEOUT = 180  # seconds one spawn of ranks may take before its tests fail
TOL = 1e-5


def _dense(q, k, v, do, causal):
    """float64 attention and its gradients (the oracle)."""
    q, k, v = (torch.from_numpy(a).double().requires_grad_(True) for a in (q, k, v))
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(q.shape[-1])
    if causal:
        n = s.shape[-1]
        s = s.masked_fill(torch.ones(n, n, dtype=torch.bool).triu(1), float("-inf"))
    out = torch.einsum("bhqk,bhkd->bhqd", s.softmax(-1), v)
    grads = torch.autograd.grad(out, (q, k, v), torch.from_numpy(do).double())
    return [t.detach().numpy() for t in (out, *grads)]


def _jax_ring(n, q, k, v, do, causal):
    mesh = jtopology.build_mesh(sp=n, devices=jax.devices()[:n])

    def f(q, k, v):
        return jra.ring_attention(q, k, v, mesh=mesh, causal=causal)

    out, vjp = jax.vjp(jax.jit(f), *(jnp.asarray(a) for a in (q, k, v)))
    return [np.asarray(a) for a in (out, *vjp(jnp.asarray(do)))]


class _Spawn(threading.Thread):
    def __init__(self, mode, tmp, nproc):
        super().__init__(daemon=True)
        self.args = (mode, tmp, nproc)
        self.result = self.log = None

    def run(self):
        mode, tmp, nproc = self.args
        rc, self.log = W.run_ranks(mode, tmp, nproc=nproc, timeout=SPAWN_TIMEOUT,
                                   worker=M.__file__)
        if rc == 0:
            self.result = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(nproc)]

    def get(self):
        self.join()
        assert self.result is not None, self.log[-6000:]
        return self.result


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    spawns = {n: _Spawn(f"ring{n}", tmp_path_factory.mktemp(f"ring{n}"), n) for n in (2, 4)}
    for t in spawns.values():
        t.start()
    saved = jtopology._GLOBAL_MESH
    try:
        ref = {}
        for shape in M.RING_SHAPES:
            for causal in (False, True):
                data = M.ring_data(shape, 5)
                ref[(shape[-1], causal)] = dict(
                    dense=_dense(*data, causal),
                    **{f"jax{n}": _jax_ring(n, *data, causal) for n in (2, 4)})
    finally:
        jtopology._GLOBAL_MESH = saved
    return dict(ref=ref, ranks={n: t.get() for n, t in spawns.items()})


def _joined(ranks, prefix):
    return [np.concatenate([r[f"{prefix}{n}"] for r in ranks], axis=2)
            for n in ("out", "dq", "dk", "dv")]


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("head_dim", [8, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_ring_is_the_reference_ring_and_dense_attention(run, world, head_dim, causal):
    ref = run["ref"][(head_dim, causal)]
    ranks = run["ranks"][world]
    for how in ("kernel", "plain"):
        got = _joined(ranks, f"ring/{head_dim}/{int(causal)}/{how}/")
        for name, g, d, j in zip(("out", "dq", "dk", "dv"), got, ref["dense"],
                                 ref[f"jax{world}"]):
            np.testing.assert_allclose(g, d, rtol=TOL, atol=TOL, err_msg=f"{how} {name}")
            np.testing.assert_allclose(g, j, rtol=TOL, atol=TOL, err_msg=f"{how} {name}")
    # n - 1 hops of K/V forward; backward n - 1 of K/V and n of dK/dV
    for r in ranks:
        hops = list(r[f"ring/{head_dim}/{int(causal)}/kernel/hops"])
        assert hops == [world - 1, 2 * world - 1], hops


def test_sep_degree_rings_over_the_global_mesh(run):
    for world, ranks in run["ranks"].items():
        for r in ranks:
            assert int(r["ring/sep/degree"]) == world
            np.testing.assert_array_equal(r["ring/sep/out"], r["ring/8/1/kernel/out"])


@pytest.mark.parametrize("causal", [False, True])
def test_one_shard_is_local_attention(causal):
    """One shard: ``ring_attention`` is one K1 block (its plain version on
    the CPU), ``ring_attention_in_shard_map`` outside a sequence scope is
    the same, and the plain version is ``_ring_attn_local``; all are the
    reference's one-device ring."""
    q, k, v, do = M.ring_data((2, 2, 16, 8), 7)
    mesh1 = jtopology.build_mesh(dp=1, devices=jax.devices()[:1])
    want = np.asarray(jra.ring_attention(*(jnp.asarray(a) for a in (q, k, v)), mesh=mesh1,
                                         causal=causal))
    one = ttopology.Mesh((1,) * 6)
    args = [torch.from_numpy(a) for a in (q, k, v)]
    for got in (tra.ring_attention(*args, mesh=one, causal=causal),
                tra.ring_attention_in_shard_map(*args, causal=causal),
                tra.ring_attention_reference(*args, mesh=one, causal=causal)):
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    dense = _dense(q, k, v, do, causal)
    leaves = [a.clone().requires_grad_(True) for a in args]
    out = tra.ring_attention(*leaves, mesh=one, causal=causal)
    for g, d in zip((out, *torch.autograd.grad(out, leaves, torch.from_numpy(do))), dense):
        np.testing.assert_allclose(g.detach().numpy(), d, rtol=TOL, atol=TOL)


def test_ring_refuses_shards_of_other_shapes():
    q = torch.zeros(1, 2, 8, 8)
    with pytest.raises(ValueError, match="one shape"):
        tra.ring_attention(q, q[:, :, :4], q, mesh=ttopology.Mesh((1,) * 6))
