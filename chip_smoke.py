#!/usr/bin/env python3
"""chip_smoke.py: drive the PyTorch/CUDA port (paddle_tpu_torch) on one
NVIDIA card and check it.

    python3 chip_smoke.py

Phases, each fatal on failure (exit code 1):
  1. card     refuse to run without CUDA; print the card's name and power
              limit as nvidia-smi reports them
  2. build    build every CUDA kernel of the main paths from the sources in
              this checkout (one nvcc per source, started together): K1
              flash_attention_fwd, K2 flash_attention_bwd_dq, K3
              flash_attention_bwd_dkv
  3. kernels  hold K1 against mha_reference, and K2/K3 against
              mha_bwd_reference, on the card at the shapes the main paths
              give them and at the other forms they take, each form in
              float32 and bfloat16; check that dropout lands exactly where
              the counter hash keeps (K1's O, K2's dQ, K3's dV); time
              kernel, plain version and the nearest PyTorch call (a
              yardstick only: the port never calls it) both by CUDA events
              over back-to-back calls and by device time (the durations of
              the kernels each call ran, from a torch.profiler window)
  4. serving  full-width BERT-base (random weights from a seed, float32)
              behind PredictorServer + BatchingEngine on localhost: 1-, 2-
              and 3-row requests at seq 128 and 512, then a burst of 8
              concurrent 1-row clients at seq 512. Every reply is held
              against the same weights run on the CPU through the plain
              versions; the kernel launch counts must equal 12 per fired
              batch (one per encoder layer)
  5. training full-width BertForPretraining (bench.py's BERT-base
              pretraining configuration: dropout 0.1/0.1, AdamW 1e-4 with
              weight decay 0.01, ClipGradByGlobalNorm(1.0), seq 128, 20
              masked positions, the packed [ids | positions] input) through
              build_train_step: (a) one O0 float32 step at batch 4 on the
              card and on the CPU from the same weights, batch and key,
              compared; (b) 20 O1 bf16 steps at batch 64 on one batch with
              a fresh key per step, whose loss must be finite and fall;
              (c) K1, K2 and K3 each launched 12 times per step on the
              card; (d) a torch.profiler breakdown of one O1 step
  6. summary  a {"kernels": [...]} line, then as the last line
              {"ok": true, "device": {"platform": "gpu", ...}}

It imports nothing of JAX or the JAX package. Run from a directory that
holds only this file it fails at the import of paddle_tpu_torch.
"""
import copy
import json
import os
import socket
import struct
import subprocess
import sys
import threading
import time

import numpy as np

# published dense peaks of one H100 SXM at its 700 W limit (NVIDIA data
# sheet): the bound of a kernel is the larger of bytes / HBM rate and
# operations / the peak rate of the unit its dtype runs on
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12}

SEQ_OUT_TOL = 1e-3  # served sequence output vs the CPU run, float32
TOL_O = {"float32": 1e-4, "bfloat16": 2e-2}
TOL_LSE = 1e-4
# K2/K3 gradients vs mha_bwd_reference, relative to the gradient's max
# magnitude (the kernels round dS and P to bf16 at the same points)
TOL_GRAD = {"float32": 1e-4, "bfloat16": 2e-2}
# training parity step, card vs CPU, float32 (GEMM sums in another order):
# loss relative; clipped gradients relative to each tensor's max
# magnitude; updated parameters absolute, 2.5 * lr because AdamW's first
# step is about lr * sign(g) and a gradient near 0 may flip its sign
TOL_STEP_LOSS = 1e-4
TOL_STEP_GRAD = 1e-3
LR = 1e-4
TOL_STEP_PARAM = 2.5 * LR


def log(msg=""):
    print(msg, flush=True)


def fail(msg):
    print(f"CHIP_SMOKE FAILED: {msg}", flush=True)
    sys.exit(1)


def cuda_ms(torch, fn, iters=20, warmup=3):
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA
    events, after ``warmup`` calls)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# ------------------------------------------------------------------ phase 1
def phase_card(torch):
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: chip_smoke needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"devices {torch.cuda.device_count()}")
    # the plain versions are the references: full float32 products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


# ------------------------------------------------------------------ phase 2
def phase_build(torch, cuda_build, fa, kernels):
    t0 = time.perf_counter()
    cuda_build.build([k["lib"] for k in kernels])
    log(f"[build] {len(kernels)} kernel source(s) in {time.perf_counter() - t0:.2f} s")
    for k in kernels:
        info = cuda_build.build_info.get(k["lib"])
        if info is None:
            log(f"[build] {k['lib']}: already built")
            continue
        log(f"[build] {k['lib']}: nvcc {info['seconds']:.2f} s")
        for line in info["log"].splitlines():
            if "Used" in line or "spill" in line or "Compiling entry" in line:
                log(f"    {line.strip()}")
    for k in kernels:
        log(f"[build] {k['lib']} dynamic shared memory per block: "
            + ", ".join(f"head_dim {d} {str(dt)[6:]}: {fa.smem_bytes(d, k['lib'], dt)} bytes"
                        for d in fa.HEAD_DIMS for dt in (torch.float32, torch.bfloat16)))


# ------------------------------------------------------------------ phase 3
def attention_pairs(sq, sk, causal):
    """(row, col) pairs of one head the kernels compute: all of them, or
    under causal masking only the unmasked ones these shapes have."""
    if not causal:
        return sq * sk
    off = sk - sq
    return sum(max(0, min(sk, r + off + 1)) for r in range(sq))


def attention_bound_ms(bh, sq, sk, d, dtype, causal, kernel="fwd"):
    """Least time for one launch of ``kernel``: bytes (each input read
    once, each output written once) over the HBM rate vs operations over
    the dtype's peak. fwd reads q, k, v and writes O, LSE; 4 * pairs * d
    operations (QK^T, PV). bwd_dq reads q, k, v, dO, LSE, delta and writes
    dQ; 6 * pairs * d (S, dP, dQ). bwd_dkv reads the same and writes dK,
    dV; 8 * pairs * d (S, dP, dV, dK)."""
    elem = 2 if dtype == "bfloat16" else 4
    tensors, floats, per_pair = {
        "fwd": ((2 * sq + 2 * sk), sq, 4),
        "bwd_dq": ((3 * sq + 2 * sk), 2 * sq, 6),
        "bwd_dkv": ((2 * sq + 4 * sk), 2 * sq, 8)}[kernel]
    nbytes = bh * (tensors * d * elem + floats * 4)
    ops = per_pair * bh * attention_pairs(sq, sk, causal) * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def device_us(events, calls=1):
    """Device time, in microseconds, summed over the profiler events (a
    ``key_averages()`` list) that ran on the card: kernels, copies and
    fills. Host-side events are left out. None where a kernel ran a number
    of times that is not a multiple of ``calls``: the profiler lost some of
    the calls' records, and the sum would read low."""
    total = 0.0
    for ev in events:
        if "CUDA" not in str(getattr(ev, "device_type", "")):
            continue
        if getattr(ev, "count", calls) % calls:
            return None
        t = getattr(ev, "self_device_time_total", None)
        if t is None:
            t = getattr(ev, "self_cuda_time_total", 0.0)
        total += t
    return total


def device_ms(torch, fn, iters=20, warmup=3):
    """Mean device time of one call of ``fn``: the durations of the
    kernels it ran, from a torch.profiler window over ``iters`` calls,
    divided by ``iters``. Unlike ``cuda_ms`` it does not count the gaps
    in which the card waits for the host. None where the profiler saw no
    device time or lost some of the calls' records (not measured)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = device_us(prof.key_averages(), iters)
    return us / 1e3 / iters if us else None


def timed(torch, fn, iters=20):
    """(CUDA-event ms, device ms) of one call of ``fn``. Where the profiler
    window read nothing or lost records it is taken once more; None after
    that prints as "not measured"."""
    ms = cuda_ms(torch, fn, iters=iters)
    dev = device_ms(torch, fn, iters=iters)
    if dev is None:
        dev = device_ms(torch, fn, iters=iters)
    return ms, dev


def _fmt(ms):
    return "not measured" if ms is None else f"{ms:.4f}"


def _share(bound_ms, dev_ms):
    """" = x% of bound" for a measured device time, else ""."""
    return f" = {100 * bound_ms / dev_ms:.1f}% of bound" if dev_ms else ""


# the forms the kernels take besides the main paths' shapes, each run in
# float32 and in bfloat16 (the bf16 forms are separate kernels)
FORMS = [
    dict(b=2, h=12, sq=512, sk=512, d=64, causal=True, p=0.0),
    dict(b=2, h=12, sq=200, sk=512, d=64, causal=True, p=0.0),
    dict(b=2, h=12, sq=512, sk=200, d=64, causal=True, p=0.0),  # fully masked rows
    dict(b=2, h=12, sq=384, sk=384, d=64, causal=False, p=0.1),
    dict(b=2, h=4, sq=100, sk=77, d=64, causal=False, p=0.0),   # ragged tiles
    dict(b=2, h=8, sq=512, sk=512, d=128, causal=True, p=0.1),
    dict(b=2, h=8, sq=512, sk=512, d=128, causal=False, p=0.0),
]


def library_reason(c):
    """Why no single PyTorch call computes this case, or None."""
    if c["causal"] and c["sq"] != c["sk"]:
        return "sdpa aligns its causal mask top-left, the kernels bottom-right"
    return None


def phase_kernels(torch, fa):
    """K1 against mha_reference at the shapes BERT-base serving gives it
    ([batch*12, seq, 64], float32 and bfloat16), at the shape training
    gives it ([64*12, 128, 64] bfloat16, with and without dropout) and at
    the other forms the kernel takes (causal, cross lengths, fully masked
    rows, ragged tiles, dropout, head_dim 128, single-query decode), each
    in both dtypes. The library yardstick is one scaled_dot_product_attention
    call (with dropout_p where the case drops, whose RNG differs)."""
    F = torch.nn.functional
    cases = []
    for b in (1, 8):
        for s in (128, 512):
            for dt in ("float32", "bfloat16"):
                cases.append(dict(b=b, h=12, sq=s, sk=s, d=64, dtype=dt, causal=False,
                                  p=0.0))
    cases += [
        # the shape BERT-base training gives K1 under O1 (batch 64, seq 128)
        dict(b=64, h=12, sq=128, sk=128, d=64, dtype="bfloat16", causal=False, p=0.0),
        dict(b=64, h=12, sq=128, sk=128, d=64, dtype="bfloat16", causal=False, p=0.1),
    ]
    forms = FORMS + [dict(b=8, h=1, sq=1, sk=257, d=128, causal=True, p=0.0)]  # decode
    cases += [dict(f, dtype=dt) for f in forms for dt in ("float32", "bfloat16")]
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = []
    log("[kernels] flash_attention_fwd vs mha_reference "
        f"(tolerance O {TOL_O['float32']} f32 / {TOL_O['bfloat16']} bf16, LSE {TOL_LSE}); "
        "times: CUDA events / device (profiler)")
    for c in cases:
        bh = c["b"] * c["h"]
        tdt = getattr(torch, c["dtype"])
        q, k, v = (torch.randn(bh, n, c["d"], device="cuda", generator=gen).to(tdt)
                   for n in (c["sq"], c["sk"], c["sk"]))
        scale = c["d"] ** -0.5
        seed = 1234
        args = (q, k, v, seed, scale, c["causal"], c["p"])
        o, lse = fa._fwd(*args)
        torch.cuda.synchronize()
        ro, rlse = fa.mha_reference(*args)
        err_o = (o.float() - ro.float()).abs().max().item()
        err_lse = (lse - rlse).abs().max().item()
        ms, dev = timed(torch, lambda: fa._fwd(*args))
        plain_ms, plain_dev = timed(torch, lambda: fa.mha_reference(*args), iters=5)
        library_ms = library_dev = None
        reason = library_reason(c)
        if reason is None:
            # one PyTorch call computing the same O (it returns no LSE)
            q4, k4, v4 = (x.view(c["b"], c["h"], -1, c["d"]) for x in (q, k, v))
            library_ms, library_dev = timed(torch, lambda: F.scaled_dot_product_attention(
                q4, k4, v4, is_causal=c["causal"], dropout_p=c["p"], scale=scale))
        bound, bound_by = attention_bound_ms(bh, c["sq"], c["sk"], c["d"], c["dtype"],
                                             c["causal"])
        ok = err_o <= TOL_O[c["dtype"]] and err_lse <= TOL_LSE
        r = dict(c, max_abs_err=err_o, max_lse_err=err_lse, ms=ms, device_ms=dev,
                 plain_ms=plain_ms, plain_device_ms=plain_dev, library_ms=library_ms,
                 library_device_ms=library_dev, library_null_reason=reason, bound_ms=bound,
                 bound_by=bound_by, ok=ok)
        results.append(r)
        lib = (f"{_fmt(library_ms)} / {_fmt(library_dev)}" if reason is None
               else f"null ({reason})")
        log(f"  b={c['b']} h={c['h']} sq={c['sq']} sk={c['sk']} d={c['d']} "
            f"{c['dtype']} causal={c['causal']} p={c['p']}: O err {err_o:.3e} "
            f"LSE err {err_lse:.3e} | kernel {ms:.4f} / {_fmt(dev)} ms"
            f"{_share(bound, dev)}; plain {plain_ms:.4f} / {_fmt(plain_dev)} ms; "
            f"library {lib} ms; bound {bound:.4f} "
            f"ms ({bound_by}) {'ok' if ok else 'DISAGREES'}")
    bad = [r for r in results if not r["ok"]]
    if bad:
        fail(f"flash_attention_fwd disagrees with mha_reference in {len(bad)} case(s)")
    return results


def _rel_err(torch, got, want):
    """max |got - want| over max |want| (the gradient's own scale)."""
    scale = want.float().abs().max().clamp_min(1e-30)
    return ((got.float() - want.float()).abs().max() / scale).item()


def phase_bwd_kernels(torch, fa):
    """K2 and K3 against mha_bwd_reference at the shape BERT-base training
    gives them ([batch 64 * 12 heads, 128, 64], bfloat16 under O1, and
    float32) and at the other forms they take, each in both dtypes. The
    library yardstick is one torch.autograd.grad through
    scaled_dot_product_attention (with dropout_p where the case drops; it
    computes dQ, dK and dV together, as does the plain version)."""
    F = torch.nn.functional
    cases = [dict(b=64, h=12, sq=128, sk=128, d=64, dtype=dt, causal=False, p=0.0)
             for dt in ("bfloat16", "float32")]
    cases.append(dict(b=64, h=12, sq=128, sk=128, d=64, dtype="bfloat16", causal=False,
                      p=0.1))
    cases += [dict(f, dtype=dt) for f in FORMS for dt in ("float32", "bfloat16")]
    gen = torch.Generator(device="cuda").manual_seed(1)
    results = []
    log("[bwd kernels] flash_attention_bwd_dq (K2) / _dkv (K3) vs mha_bwd_reference "
        f"(tolerance {TOL_GRAD['float32']} f32 / {TOL_GRAD['bfloat16']} bf16 of the "
        "gradient's max magnitude); times: CUDA events / device (profiler)")
    for c in cases:
        bh = c["b"] * c["h"]
        tdt = getattr(torch, c["dtype"])
        q, k, v, do = (torch.randn(bh, n, c["d"], device="cuda", generator=gen).to(tdt)
                       for n in (c["sq"], c["sk"], c["sk"], c["sq"]))
        scale = c["d"] ** -0.5
        o, lse = fa._fwd(q, k, v, 4321, scale, c["causal"], c["p"])
        args = (q, k, v, o, lse, do, 4321, scale, c["causal"], c["p"])
        got = fa._bwd(*args)
        torch.cuda.synchronize()
        want = fa.mha_bwd_reference(*args)
        errs = [_rel_err(torch, g, w) for g, w in zip(got, want)]
        abs_errs = [(g.float() - w.float()).abs().max().item() for g, w in zip(got, want)]
        again = fa._bwd(*args)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        delta = (do.float() * o.float()).sum(-1).contiguous()
        lse2 = lse.view(bh, c["sq"])
        # each kernel alone, from the same delta the wrapper computes
        ptrs = [t.data_ptr() for t in (q, k, v, do, lse2, delta)]
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        kargs = fa._kernel_args(4321, scale, c["causal"], c["p"], q.dtype, q.device)
        dims = (bh, c["sq"], c["sk"], c["d"])
        ms_dq, dev_dq = timed(torch, lambda: fa._launch("flash_attention_bwd_dq", *ptrs,
                                                        dq.data_ptr(), *dims, *kargs))
        ms_dkv, dev_dkv = timed(torch, lambda: fa._launch(
            "flash_attention_bwd_dkv", *ptrs, dk.data_ptr(), dv.data_ptr(), *dims, *kargs))
        plain_ms, plain_dev = timed(torch, lambda: fa.mha_bwd_reference(*args), iters=5)
        library_ms = library_dev = None
        reason = library_reason(c)
        if reason is None:
            q4, k4, v4 = (x.view(c["b"], c["h"], -1, c["d"]).detach().requires_grad_(True)
                          for x in (q, k, v))
            out = F.scaled_dot_product_attention(q4, k4, v4, is_causal=c["causal"],
                                                 dropout_p=c["p"], scale=scale)
            do4 = do.view_as(out)
            library_ms, library_dev = timed(torch, lambda: torch.autograd.grad(
                out, (q4, k4, v4), do4, retain_graph=True))
        bound_dq = attention_bound_ms(bh, c["sq"], c["sk"], c["d"], c["dtype"],
                                      c["causal"], "bwd_dq")
        bound_dkv = attention_bound_ms(bh, c["sq"], c["sk"], c["d"], c["dtype"],
                                       c["causal"], "bwd_dkv")
        ok = max(errs) <= TOL_GRAD[c["dtype"]] and same
        r = dict(c, err_dq=errs[0], err_dk=errs[1], err_dv=errs[2],
                 abs_err_dq=abs_errs[0], abs_err_dkv=max(abs_errs[1:]), ms_dq=ms_dq,
                 device_ms_dq=dev_dq, ms_dkv=ms_dkv, device_ms_dkv=dev_dkv,
                 plain_ms=plain_ms, plain_device_ms=plain_dev, library_ms=library_ms,
                 library_device_ms=library_dev, library_null_reason=reason,
                 bound_dq=bound_dq, bound_dkv=bound_dkv, ok=ok)
        results.append(r)
        lib = (f"{_fmt(library_ms)} / {_fmt(library_dev)}" if reason is None
               else f"null ({reason})")
        log(f"  b={c['b']} h={c['h']} sq={c['sq']} sk={c['sk']} d={c['d']} {c['dtype']} "
            f"causal={c['causal']} p={c['p']}: err dq {errs[0]:.3e} dk {errs[1]:.3e} "
            f"dv {errs[2]:.3e} | K2 {ms_dq:.4f} / {_fmt(dev_dq)} ms (bound "
            f"{bound_dq[0]:.4f} {bound_dq[1]}{_share(bound_dq[0], dev_dq)}) K3 {ms_dkv:.4f} / "
            f"{_fmt(dev_dkv)} ms (bound {bound_dkv[0]:.4f} {bound_dkv[1]}"
            f"{_share(bound_dkv[0], dev_dkv)}) plain {plain_ms:.4f} / "
            f"{_fmt(plain_dev)} ms library {lib} ms "
            f"{'' if same else 'NOT REPEATABLE '}{'ok' if ok else 'DISAGREES'}")
    bad = [r for r in results if not r["ok"]]
    if bad:
        fail(f"K2/K3 disagree with mha_bwd_reference (or are not repeatable) in "
             f"{len(bad)} case(s)")
    return results


def phase_dropout_placement(torch, fa):
    """The dropout mask lands exactly where ``_keep_mask`` keeps: with q =
    k = 0 every p is 1/sk, so with V = I (sk = d) K1's O is non-zero
    exactly at the kept (row, col); with dO = I (sq = d) K3's dV is
    non-zero exactly at the transposed mask. For K2, q = 0, K = V = I,
    dO = ones, O = 0 (delta = 0) and LSE = log d give P = 1/d, dS =
    P * keep / (1 - p) and dQ = scale * dS, non-zero exactly where kept. A
    tolerance on values alone could miss a mask placed one element off."""
    p, seed = 0.3, 2024
    for d in fa.HEAD_DIMS:
        for dt in (torch.float32, torch.bfloat16):
            bh = 6
            zeros = torch.zeros(bh, d, d, device="cuda", dtype=dt)
            eye = torch.eye(d, device="cuda", dtype=dt).expand(bh, d, d).contiguous()
            o, lse = fa._fwd(zeros, zeros, eye, seed, d ** -0.5, False, p)
            _, _, dv = fa._bwd(zeros, zeros, eye, o, lse, eye, seed, d ** -0.5, False, p)
            ones = torch.ones_like(zeros)
            lse_d = torch.full((bh, d, 1), float(np.log(d)), device="cuda")
            dq, _, _ = fa._bwd(zeros, eye, eye, zeros, lse_d, ones, seed, d ** -0.5, False, p)
            torch.cuda.synchronize()
            idx = torch.arange(d, device="cuda")
            keep = fa._dropout_keep(seed, bh, idx[:, None], idx[None, :], d, p)
            o_ok = torch.equal(o != 0, keep)
            dq_ok = torch.equal(dq != 0, keep)
            dv_ok = torch.equal(dv != 0, keep.transpose(1, 2))
            kept = keep.float().mean().item()
            log(f"[dropout placement] d={d} {str(dt)[6:]} p={p}: K1 O non-zero exactly "
                f"where kept {o_ok}, K2 dQ exactly where kept {dq_ok}, K3 dV at the "
                f"transposed mask {dv_ok} (kept share {kept:.3f})")
            if not (o_ok and dq_ok and dv_ok):
                fail(f"dropout placement differs from _keep_mask (d={d}, {dt})")


# ------------------------------------------------------------------ phase 4
def _recv(s, n):
    buf = b""
    while len(buf) < n:
        chunk = s.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("server closed the connection")
        buf += chunk
    return buf


def _call(port, frame):
    with socket.create_connection(("127.0.0.1", port), timeout=300) as s:
        s.sendall(frame)
        (blen,) = struct.unpack("<I", _recv(s, 4))
        body = _recv(s, blen)
    return body[0], body[1:]


def phase_serving(torch, fa, port_mods):
    BertModel, BatchingEngine, PredictorServer, wire_spec = port_mods
    torch.set_num_threads(os.cpu_count() or 1)
    t0 = time.perf_counter()
    model = BertModel(device="cuda", generator=torch.Generator().manual_seed(0)).eval()
    n_layers = len(model.encoder.layers)
    cpu_model = copy.deepcopy(model).to("cpu")
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[serving] BERT-base: {n_layers} layers, hidden {model.hidden_size}, "
        f"{n_params} parameters, float32, built in {time.perf_counter() - t0:.1f} s")

    def run(ids):
        with torch.inference_mode():
            return list(model(torch.from_numpy(np.array(ids)).to("cuda")))

    engine = BatchingEngine.for_callable(run, max_batch_size=8, max_wait_ms=20.0,
                                         max_queue=64)
    for seq in (128, 512):
        engine.warmup(signature=[("int32", (seq,))])
    server = PredictorServer(run, engine=engine, own_engine=True)
    rng = np.random.RandomState(0)

    def request(ids):
        frame = wire_spec.build_request(wire_spec.CMD_INFER, wire_spec.encode_arrays([ids]))
        t = time.perf_counter()
        status, payload = _call(server.port, frame)
        ms = (time.perf_counter() - t) * 1e3
        if status != wire_spec.STATUS_OK:
            fail(f"infer of {ids.shape} answered status {status}: {payload[:200]!r}")
        return wire_spec.decode_arrays(payload), ms

    def batches():
        return sum(d["batches"] for ds in engine.stats()["buckets"].values() for d in ds)

    sent = []  # (ids, outputs, latency ms, label)
    fa.launches = 0  # count the main path's launches only
    for seq in (128, 512):
        for rows in (1, 2, 3):
            ids = rng.randint(0, model.vocab_size, (rows, seq)).astype(np.int32)
            outs, ms = request(ids)
            sent.append((ids, outs, ms, f"{rows} row(s) seq {seq}"))
    before_burst = batches()
    burst = [rng.randint(0, model.vocab_size, (1, 512)).astype(np.int32) for _ in range(8)]
    burst_out = [None] * len(burst)
    gate = threading.Barrier(len(burst))

    def client(i):
        gate.wait()
        burst_out[i] = request(burst[i])

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(burst))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
        if t.is_alive():
            fail("a burst client did not finish within 300 s")
    launches = fa.launches
    fired = batches()
    burst_batches = fired - before_burst
    for i, (outs, ms) in enumerate(burst_out):
        sent.append((burst[i], outs, ms, f"burst client {i} seq 512"))

    if launches != n_layers * fired:
        fail(f"flash_attention_fwd launched {launches} times for {fired} batches; "
             f"expected {n_layers} per batch")
    log(f"[serving] {len(sent)} requests, {fired} batches fired, "
        f"flash_attention_fwd launches {launches} = {n_layers} x {fired}")
    if burst_batches >= len(burst):
        fail(f"the burst of {len(burst)} 1-row requests did not coalesce "
             f"({burst_batches} batches)")
    log(f"[serving] burst of {len(burst)} concurrent 1-row requests -> "
        f"{burst_batches} batch(es)")

    worst = 0.0
    for ids, (seq_out, pooled), ms, label in sent:
        with torch.inference_mode():
            ref_seq, ref_pooled = cpu_model(torch.from_numpy(ids))
        err = float(np.abs(seq_out - ref_seq.numpy()).max())
        err_p = float(np.abs(pooled - ref_pooled.numpy()).max())
        ok = (seq_out.shape == tuple(ref_seq.shape) and np.isfinite(seq_out).all()
              and err <= SEQ_OUT_TOL)
        worst = max(worst, err)
        log(f"  {label}: {ms:.1f} ms, seq-output err {err:.3e}, pooled err "
            f"{err_p:.3e} {'ok' if ok else 'DISAGREES'}")
        if not ok:
            fail(f"served output for {label} disagrees with the CPU run "
                 f"(max abs err {err} > {SEQ_OUT_TOL})")

    # the reference's contract (batched rows bitwise equal to a direct
    # 1-row call), recorded here and not yet required
    same = []
    for ids, (seq_out, _), _, _ in sent[-len(burst):]:
        (direct, _) = run(ids)
        same.append(bool(np.array_equal(seq_out, direct.cpu().numpy())))
    log(f"[serving] batched rows bitwise equal to a direct 1-row call: "
        f"{sum(same)}/{len(same)} (recorded, not required)")

    profile_forward(torch, run, np.stack([b[0] for b in burst]))

    status, body = _call(server.port, wire_spec.build_request(wire_spec.CMD_HEALTH))
    if status != wire_spec.STATUS_OK or not json.loads(body)["ok"]:
        fail(f"cmd 3 health answered status {status}: {body[:200]!r}")
    status, body = _call(server.port, wire_spec.build_request(wire_spec.CMD_STATS))
    stats = json.loads(body)
    if status != wire_spec.STATUS_OK or stats["requests"] != len(sent):
        fail(f"cmd 5 stats answered status {status}: {body[:300]!r}")
    log(f"[serving] cmd 5 stats: {json.dumps(stats['buckets'])}")
    status, _ = _call(server.port, wire_spec.build_request(wire_spec.CMD_STOP))
    if status != wire_spec.STATUS_OK:
        fail(f"cmd 7 stop answered status {status}")
    server._thread.join(30)
    t_end = time.monotonic() + 30
    while not engine.health()["closed"]:
        if time.monotonic() > t_end:
            fail("cmd 7 did not close the engine within 30 s")
        time.sleep(0.05)
    log(f"[serving] cmd 3/5/7 answered; worst seq-output err {worst:.3e} "
        f"(tolerance {SEQ_OUT_TOL})")
    return launches


def profile_device(torch, fn, label, top=8):
    """Where one call of ``fn`` spends its device time: its CUDA-event time,
    then the same call traced with torch.profiler (kernel device time by
    name, the top 8)."""
    from torch.profiler import ProfilerActivity, profile

    ms = cuda_ms(torch, fn, iters=1, warmup=0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = []
    for ev in prof.key_averages():
        if "CUDA" not in str(getattr(ev, "device_type", "")):
            continue
        t = getattr(ev, "self_device_time_total", None)
        if t is None:
            t = getattr(ev, "self_cuda_time_total", 0.0)
        if t > 0:
            kernels.append((t / 1e3, ev.count, ev.key))
    busy = sum(t for t, _, _ in kernels)
    log(f"[profile] {label}: {ms:.3f} ms (CUDA events); kernels {busy:.3f} ms in the "
        "traced call"
        + ("" if kernels else " (the profiler saw no device time: not measured)"))
    for t, n, name in sorted(kernels, reverse=True)[:top]:
        log(f"    {t:8.3f} ms {100 * t / busy:5.1f}% x{n:<4d} {name[:90]}")
    groups = {}
    for t, n, name in kernels:
        group = next((g for g, keys in KERNEL_GROUPS if any(k in name for k in keys)),
                     "other elementwise, reductions, copies")
        tot, cnt = groups.get(group, (0.0, 0))
        groups[group] = (tot + t, cnt + n)
    for group, (t, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        log(f"    [group] {t:8.3f} ms {100 * t / max(busy, 1e-9):5.1f}% x{n:<5d} {group}")
    # what the host spent handing work to the card
    calls = [(ev.key, ev.count, ev.self_cpu_time_total / 1e3) for ev in prof.key_averages()
             if ev.key in ("cudaLaunchKernel", "cuLaunchKernel", "cuLaunchKernelEx",
                           "cudaMemcpyAsync")]
    log("    [host] " + (", ".join(f"{k} x{n} {t:.3f} ms" for k, n, t in calls)
                         or "no launch calls traced"))
    return ms, busy


# kernel-name fragments -> the layer of the port that launched them
KERNEL_GROUPS = (
    ("K1 flash_attention_fwd", ("fwd_f32_kernel", "fwd_bf16_kernel")),
    ("K2 flash_attention_bwd_dq", ("dq_f32_kernel", "dq_bf16_kernel")),
    ("K3 flash_attention_bwd_dkv", ("dkv_f32_kernel", "dkv_bf16_kernel")),
    ("GEMMs (cuBLAS/CUTLASS)", ("gemm", "xmma", "cutlass", "sm90_", "sm80_", "nvjet")),
    ("int64 elementwise (counter-hash dropout masks)", ("<long",)),
)


def profile_forward(torch, run, ids):
    """Where a served batch's device time goes."""
    run(ids)  # warm
    profile_device(torch, lambda: run(ids), f"forward of {ids.shape[0]} x {ids.shape[1]}")


# ------------------------------------------------------------------ phase 5
TRAIN_SEQ, TRAIN_PRED, O1_BATCH, O1_STEPS = 128, 20, 64, 20
# tensors whose clipped gradients the parity step compares
WATCH = ("inner.bert.embeddings.word_embeddings.weight",
         "inner.bert.encoder.layers.0.self_attn.q_proj.weight",
         "inner.bert.encoder.layers.0.self_attn.k_proj.weight",
         "inner.bert.encoder.layers.0.self_attn.v_proj.weight",
         "inner.bert.encoder.layers.11.linear1.weight",
         "inner.bert.encoder.layers.11.linear2.weight",
         "inner.cls.decoder_bias")


def phase_training(torch, fa, mods, card):
    BertForPretraining, nn, optimizer, spmd, prandom = mods
    torch.set_num_threads(os.cpu_count() or 1)

    class TrainWrapper(torch.nn.Module):
        """bench.py's wrapper: one packed [B, S + P] int32 input, split
        into ids and masked positions; returns the MLM logits."""

        def __init__(self, inner, seq_len):
            super().__init__()
            self.inner = inner
            self.seq_len = seq_len

        def forward(self, packed):
            mlm_logits, _ = self.inner(packed[:, :self.seq_len],
                                       masked_positions=packed[:, self.seq_len:])
            return mlm_logits

    def loss_fn(mlm_logits, labels):
        # bench.py's loss: mean NLL of the labels at the masked positions
        logp = torch.log_softmax(mlm_logits.float(), dim=-1)
        return -torch.take_along_dim(logp, labels[..., None].long(), dim=-1)[..., 0].mean()

    def batch(b, vocab, seed=0):
        rng = np.random.RandomState(seed)
        ids = rng.randint(0, vocab, (b, TRAIN_SEQ)).astype(np.int32)
        pos = np.stack([rng.choice(TRAIN_SEQ, TRAIN_PRED, replace=False)
                        for _ in range(b)]).astype(np.int32)
        labels = rng.randint(0, vocab, (b, TRAIN_PRED)).astype(np.int32)
        return torch.from_numpy(np.concatenate([ids, pos], 1)), torch.from_numpy(labels)

    def build(model, amp_level):
        wrapper = TrainWrapper(model, TRAIN_SEQ)
        opt = optimizer.AdamW(LR, parameters=wrapper.parameters(), weight_decay=0.01,
                              grad_clip=nn.ClipGradByGlobalNorm(1.0))
        return spmd.build_train_step(wrapper, loss_fn, opt, amp_level=amp_level)

    t0 = time.perf_counter()
    model = BertForPretraining(hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1,
                               device="cuda", generator=torch.Generator().manual_seed(0))
    n_layers = len(model.bert.encoder.layers)
    vocab = model.bert.vocab_size
    cpu_model = copy.deepcopy(model).to("cpu")
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[training] BertForPretraining: {n_layers} layers, hidden "
        f"{model.bert.hidden_size}, vocab {vocab}, {n_params} parameters (decoder tied "
        f"to the word embeddings), built in {time.perf_counter() - t0:.1f} s")

    fa.launches = fa.dq_launches = fa.dkv_launches = 0  # count the main path only
    steps_on_card = 0

    # (a) one O0 float32 step on the card and on the CPU
    x, y = batch(4, vocab)
    res = {}
    for dev, m in (("cuda", model), ("cpu", cpu_model)):
        step, init = build(m, "O0")
        params, state = init()
        t = time.perf_counter()
        loss, params, state = step(params, state, x.to(dev), y.to(dev),
                                   key=prandom.PRNGKey(0))
        loss = float(loss)  # a readback: the step has finished
        secs = time.perf_counter() - t
        steps_on_card += dev == "cuda"
        res[dev] = (loss, {n: (state[n][0] / (1 - 0.9)).cpu() for n in WATCH},
                    {n: p.cpu() for n, p in params.items()}, secs)
    (gl, gg, gp, gs), (cl, cg, cp, cs) = res["cuda"], res["cpu"]
    loss_err = abs(gl - cl) / abs(cl)
    log(f"[training] O0 parity step, batch 4: loss card {gl:.6f} cpu {cl:.6f} "
        f"(rel err {loss_err:.2e}, tolerance {TOL_STEP_LOSS}); card {gs:.2f} s, cpu "
        f"{cs:.2f} s (first step, allocation included)")
    bad = [] if loss_err <= TOL_STEP_LOSS and np.isfinite(gl) else ["loss"]
    for n in WATCH:
        err = _rel_err(torch, gg[n], cg[n])
        ok = err <= TOL_STEP_GRAD
        bad += [] if ok else [f"grad {n}"]
        log(f"  clipped grad {n}: rel err {err:.2e} (max |g| "
            f"{cg[n].abs().max().item():.3e}) {'ok' if ok else 'DISAGREES'}")
    worst = max((gp[n] - cp[n]).abs().max().item() for n in cp)
    bad += [] if worst <= TOL_STEP_PARAM else ["updated parameters"]
    log(f"  updated parameters ({len(cp)} tensors): max abs err {worst:.3e} "
        f"(tolerance {TOL_STEP_PARAM:.1e} = 2.5 lr)")
    if bad:
        fail(f"the card's training step disagrees with the CPU's: {', '.join(bad)}")
    del cpu_model, res, gg, gp, cg, cp

    # (b) O1 bf16 steps on one batch, a fresh key per step
    step, init = build(model, "O1")
    params, state = init()
    x, y = (t.to("cuda") for t in batch(O1_BATCH, vocab))
    torch.cuda.reset_peak_memory_stats()
    losses, secs = [], []
    for i in range(O1_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss, params, state = step(params, state, x, y,
                                   key=prandom.fold_in(prandom.PRNGKey(0), i))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
        losses.append(loss)
    steps_on_card += O1_STEPS
    losses = [float(v) for v in losses]
    steady = sorted(secs[1:])[len(secs[1:]) // 2]
    tokens = O1_BATCH * TRAIN_SEQ
    log(f"[training] O1 bf16, batch {O1_BATCH} x seq {TRAIN_SEQ}: loss "
        + " ".join(f"{v:.4f}" for v in losses))
    log(f"[training] O1 step (median of steps 2-{O1_STEPS}, host clock to synchronize): "
        f"{steady * 1e3:.2f} ms, {tokens / steady:.0f} tokens/s; first step "
        f"{secs[0] * 1e3:.1f} ms; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB | {card}")
    if not all(np.isfinite(losses)):
        fail(f"O1 training loss is not finite: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"O1 training loss did not fall over {O1_STEPS} steps: {losses}")

    # (c) every step on the card ran K1, K2 and K3 once per encoder layer
    counts = dict(fwd=fa.launches, bwd_dq=fa.dq_launches, bwd_dkv=fa.dkv_launches)
    want = n_layers * steps_on_card
    log(f"[training] launches over {steps_on_card} steps on the card: "
        + ", ".join(f"{k} {v}" for k, v in counts.items()) + f" (expected {want} each)")
    if any(v != want for v in counts.values()):
        fail(f"kernel launches {counts} != {n_layers} x {steps_on_card} steps")

    # (d) where an O1 step's device time goes
    def one_step():
        nonlocal params, state
        _, params, state = step(params, state, x, y, key=prandom.PRNGKey(999))

    step_ms, busy_ms = profile_device(torch, one_step,
                                      f"O1 training step, batch {O1_BATCH} x {TRAIN_SEQ}",
                                      top=16)
    idle = (f"{100 * (1 - busy_ms / step_ms):.1f}%" if busy_ms > 0 else "not measured")
    log(f"[profile] device idle {idle} of an O1 step (kernel time summed over the "
        "traced step against the CUDA-event time of the step before it)")
    return dict(counts=counts, steps=steps_on_card, step_ms=steady * 1e3,
                tokens_per_s=tokens / steady, losses=losses)


# ------------------------------------------------------------------ main
def main():
    try:
        import torch
    except ImportError as e:
        fail(f"torch is not importable: {e}")
    card = phase_card(torch)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from paddle_tpu_torch import nn, optimizer
        from paddle_tpu_torch.core import cuda_build
        from paddle_tpu_torch.core import random as prandom
        from paddle_tpu_torch.distributed import spmd
        from paddle_tpu_torch.inference import wire_spec
        from paddle_tpu_torch.inference.batching import BatchingEngine
        from paddle_tpu_torch.inference.server import PredictorServer
        from paddle_tpu_torch.ops import flash_attention as fa
        from paddle_tpu_torch.text.models import BertForPretraining, BertModel
    except ImportError as e:
        fail(f"the port is not importable from this directory: {e}")

    src = "paddle_tpu_torch/csrc/"
    tpu = "paddle_tpu/ops/pallas/flash_attention.py:"
    kernels = [
        dict(name="flash_attention_fwd", lib="flash_attention_fwd", route="cuda",
             source=src + "flash_attention_fwd.cu", replaces=tpu + "208"),
        dict(name="flash_attention_bwd_dq", lib="flash_attention_bwd_dq", route="cuda",
             source=src + "flash_attention_bwd_dq.cu", replaces=tpu + "435"),
        dict(name="flash_attention_bwd_dkv", lib="flash_attention_bwd_dkv", route="cuda",
             source=src + "flash_attention_bwd_dkv.cu", replaces=tpu + "458"),
    ]
    phase_build(torch, cuda_build, fa, kernels)
    cases = phase_kernels(torch, fa)
    bwd_cases = phase_bwd_kernels(torch, fa)
    phase_dropout_placement(torch, fa)
    serving_launches = phase_serving(torch, fa, (BertModel, BatchingEngine, PredictorServer,
                                                 wire_spec))
    train = phase_training(torch, fa, (BertForPretraining, nn, optimizer, spmd, prandom),
                           card)

    # K1 at the largest shape BERT-base serving gives it (a full batch of 8
    # at seq 512, float32); K2 and K3 at the shape BERT-base training gives
    # them under O1 ([64 * 12, 128, 64] bfloat16), and in float32 (the O0
    # step's form) under f32_*. Launches: every main path run, each counted
    # from 0 just before it.
    main = next(r for r in cases if r["b"] == 8 and r["sq"] == 512
                and r["dtype"] == "float32")
    bmain, bf32 = (next(r for r in bwd_cases if r["b"] == 64 and r["dtype"] == dt
                        and r["p"] == 0.0) for dt in ("bfloat16", "float32"))
    train_fwd = next(r for r in cases if r["b"] == 64 and r["dtype"] == "bfloat16"
                     and r["p"] == 0.0)

    def timing(r, suffix=""):
        # ms: CUDA events over back-to-back calls; device_ms: the kernels'
        # own durations from the profiler (what the table in PERF.md uses)
        return dict(ms=r["ms" + suffix], device_ms=r["device_ms" + suffix],
                    plain_ms=r["plain_ms"], plain_device_ms=r["plain_device_ms"],
                    library_ms=r["library_ms"], library_device_ms=r["library_device_ms"])

    def bwd(r, which, prefix=""):
        # K2 ("dq") or K3 ("dkv") fields of one backward case
        return {prefix + k: v for k, v in dict(
            max_abs_err=r["abs_err_" + which], **timing(r, "_" + which),
            bound_ms=r["bound_" + which][0], bound_by=r["bound_" + which][1]).items()}

    line = [
        dict(name=kernels[0]["name"], route="cuda", source=kernels[0]["source"],
             replaces=kernels[0]["replaces"],
             launches=serving_launches + train["counts"]["fwd"],
             max_abs_err=main["max_abs_err"], **timing(main), bound_ms=main["bound_ms"],
             bound_by=main["bound_by"],
             # K1 at the training shape, [64 * 12, 128, 64] bfloat16
             **{"train_bf16_" + k: v for k, v in dict(
                 max_abs_err=train_fwd["max_abs_err"], **timing(train_fwd),
                 bound_ms=train_fwd["bound_ms"], bound_by=train_fwd["bound_by"]).items()}),
        dict(name=kernels[1]["name"], route="cuda", source=kernels[1]["source"],
             replaces=kernels[1]["replaces"], launches=train["counts"]["bwd_dq"],
             **bwd(bmain, "dq"), **bwd(bf32, "dq", "f32_")),
        dict(name=kernels[2]["name"], route="cuda", source=kernels[2]["source"],
             replaces=kernels[2]["replaces"], launches=train["counts"]["bwd_dkv"],
             **bwd(bmain, "dkv"), **bwd(bf32, "dkv", "f32_")),
    ]
    log(card)
    log(json.dumps({"kernels": line}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
