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
              the kernels each call ran, from a torch.profiler window); K1's
              length form (per-row key lengths in device memory) at the
              decode engine's step and prefill shapes and llama_generate's
              step, whose rows keep their bits at twice the pool's width
              and beside other lengths
  4. serving  full-width BERT-base (random weights from a seed, float32)
              behind PredictorServer + BatchingEngine on localhost: 1-, 2-
              and 3-row requests at seq 128 and 512, then a burst of 8
              concurrent 1-row clients at seq 512, then a 2-row and a 3-row
              request together. Every reply is held against the same weights
              run on the CPU through the plain versions; the kernel launch
              counts must equal 12 per fired batch (one per encoder layer)
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
  6. generation  Llama-2-7B's KV-cached decode, its step captured as one
              CUDA graph per call and replayed (random weights from a
              seed): (a) at full width and depth 2, float32 then bfloat16,
              prefill logits and generated tokens held against the same
              weights on the CPU (a token may differ only at a near-tie of
              the CPU's teacher-forced logits), and in float32 a sampled
              call (temperature 0.8, top-k 50, top-p 0.9, seed 0) whose
              tokens may differ from the CPU's only at a near-tie (1e-4) of
              the CPU's perturbed scores; (b) at full width and depth in
              bfloat16 (weights drawn on the card), bench.py's decode
              shape, 16 prompts x 128 tokens and 128 new tokens: greedy
              tokens bitwise equal to the same call with the steps run
              eagerly, K1 launched exactly 32 x 128 times (the replays
              credit theirs), every chosen token within 3e-2 of the row's
              max |logit| of the top logit of one full forward over the
              output; the sampled call, graphed and eager, bitwise equal;
              (c) the generic full-width path, 4 tokens at batch 2, 32 x 4
              launches; (d) prefill ms; the decode loop eager and graphed,
              tokens/s over each whole window beside the two-term bound,
              median step, capture ms and the graph pool's bytes; one
              replay profiled (32 K1 records, the idle share)
  7. engine   the continuous-batching decode engine: (e) full width,
              depth 2, float32, the same 4 requests through the engine on
              the card and on the CPU (tokens equal, or a near-tie of the
              CPU's logits); then Llama-2-7B bf16 at full width and depth
              (weights drawn on the card), 16 slots x 256 positions, behind
              PredictorServer on localhost: 24 streams (16 at once, 8 more
              as the first retire; prompts 16-128, 16-96 new tokens, seeded),
              one client hanging up after its 4th chunk, one with a 1 ms
              per-token budget, one one-shot. It fails unless (a) every
              stream is well formed with exactly its tokens, the 1 ms one
              ends in status 2 and every slot is free after; (b) four
              sequences decoded again alone give the same tokens, bitwise;
              (c) every token lies within 3e-2 of the row's max |logit| of
              the top logit of a full forward; (d) K1 ran 32 x (prefills +
              steps) times, credited by as many graph replays, and warmup
              captured each program once. Then tokens/s over the whole
              window beside the two-term bound, time to the first token,
              one replayed engine step profiled; then the same streams
              through the same engine run eagerly (cuda_graph=False), whose
              tokens must equal the graphed window's bitwise
  8. summary  a {"kernels": [...]} line, then as the last line
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


def _na(flag):
    return "n/a" if flag is None else str(flag)


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


# the prefix form Llama-2-7B's cached generation gives K1 (phase 6): the
# causal prefill of 16 prompts x 128 tokens over 32 heads of head_dim 128
# (its decode step takes the length form, LENGTH_FORMS)
LLAMA_FORMS = [
    dict(b=16, h=32, sq=128, sk=128, d=128, causal=True, p=0.0),
]


def library_reason(c):
    """Why no single PyTorch call computes this case, or None."""
    if c["causal"] and c["sq"] not in (1, c["sk"]):
        return "sdpa aligns its causal mask top-left, the kernels bottom-right"
    return None


def library_causal(c):
    """``is_causal`` of the sdpa call that computes case ``c``: a single
    query under the kernels' bottom-right mask sees every key, so that
    case is sdpa's non-causal one."""
    return c["causal"] and c["sq"] > 1


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
    forms += LLAMA_FORMS
    cases += [dict(f, dtype=dt) for f in forms for dt in ("float32", "bfloat16")]
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = []
    log("[kernels] flash_attention_fwd vs mha_reference "
        f"(tolerance O {TOL_O['float32']} f32 / {TOL_O['bfloat16']} bf16, LSE {TOL_LSE}); "
        "times: CUDA events / device (profiler)")
    for c in cases:
        bh = c["b"] * c["h"]
        tdt = getattr(torch, c["dtype"])
        # K/V of a cached form: the first sk rows of a `total`-row buffer
        rows = c.get("total", c["sk"])
        q, k, v = (torch.randn(bh, n, c["d"], device="cuda", generator=gen).to(tdt)
                   for n in (c["sq"], rows, rows))
        k, v = k[:, :c["sk"]], v[:, :c["sk"]]
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
                q4, k4, v4, is_causal=library_causal(c), dropout_p=c["p"], scale=scale))
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
        view = f" (K/V: rows of a {c['total']}-row cache)" if "total" in c else ""
        log(f"  b={c['b']} h={c['h']} sq={c['sq']} sk={c['sk']} d={c['d']}{view} "
            f"{c['dtype']} causal={c['causal']} p={c['p']}: O err {err_o:.3e} "
            f"LSE err {err_lse:.3e} | kernel {ms:.4f} / {_fmt(dev)} ms"
            f"{_share(bound, dev)}; plain {plain_ms:.4f} / {_fmt(plain_dev)} ms; "
            f"library {lib} ms; bound {bound:.4f} "
            f"ms ({bound_by}) {'ok' if ok else 'DISAGREES'}")
    bad = [r for r in results if not r["ok"]]
    if bad:
        fail(f"flash_attention_fwd disagrees with mha_reference in {len(bad)} case(s)")
    return results


# K1's length form at the decode paths' shapes, float32 and bfloat16: the
# decode engine's (phase 7) step of 16 slots x 32 heads, a single query
# each over its own slot of a 256-row pool at a seeded length in 1..256,
# and one joiner's prefill of 128 positions (its prompt bucket) at length
# 77, causal; and llama_generate's (phase 6) step, 16 rows over the whole
# 256-row cache at one length, 192 (the mean of the steps' 129..255)
LENGTH_FORMS = [
    dict(name="engine_step", b=16, h=32, sq=1, sk=256, d=128, causal=True, lens=None),
    dict(name="engine_prefill", b=1, h=32, sq=128, sk=128, d=128, causal=True, lens=[77]),
    dict(name="llama_decode", b=16, h=32, sq=1, sk=256, d=128, causal=True, lens=[192] * 16),
]


def length_pairs(sq, sk, k_len, causal):
    """(row, col) pairs of one head K1's length form computes: keys below
    ``k_len``, and under causal masking (bottom-right over the operand's
    sk) only the unmasked ones."""
    if not causal:
        return sq * k_len
    return sum(max(0, min(k_len, r + sk - sq + 1)) for r in range(sq))


def length_bound_ms(h, sq, sk, d, dtype, causal, k_lens):
    """Least time of one launch of K1's length form over ``len(k_lens)``
    batch rows of ``h`` heads: q, O and LSE of every row and only each
    row's k_len valid K/V rows (the rows past a length are never read),
    over the HBM rate; vs 4 * d operations a computed pair over the peak."""
    elem = 2 if dtype == "bfloat16" else 4
    b = len(k_lens)
    nbytes = b * h * (2 * sq * d * elem + sq * 4) + 2 * h * sum(k_lens) * d * elem
    ops = 4 * d * h * sum(length_pairs(sq, sk, n, causal) for n in k_lens)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_length_kernels(torch, fa):
    """K1 with per-row key lengths read from device memory (``k_len``)
    against mha_reference with the same lengths, at LENGTH_FORMS. The pool
    rows past each length hold NaN: a stale row read into a product would
    show. In the step form a row's O and LSE must keep their bits when the
    pool is twice as wide (the new rows NaN too) and when the other rows'
    lengths change.
    The library yardstick is one scaled_dot_product_attention call with a
    boolean key mask over the whole pool."""
    F = torch.nn.functional
    gen = torch.Generator(device="cuda").manual_seed(1)
    lens_rng = np.random.RandomState(7)
    nan = float("nan")
    results = []
    log("[kernels] flash_attention_fwd with per-row key lengths (k_len) vs mha_reference "
        f"with k_len (tolerance O {TOL_O['float32']} f32 / {TOL_O['bfloat16']} bf16, LSE "
        f"{TOL_LSE}); pool rows past a length hold NaN; times: CUDA events / device")
    for form in LENGTH_FORMS:
        b, h, sq, sk, d, causal = (form[k] for k in ("b", "h", "sq", "sk", "d", "causal"))
        k_lens = form["lens"] or lens_rng.randint(1, sk + 1, b).tolist()
        for dt in ("float32", "bfloat16"):
            tdt = getattr(torch, dt)
            q = torch.randn(b * h, sq, d, device="cuda", generator=gen).to(tdt)
            k, v = (torch.randn(b * h, sk, d, device="cuda", generator=gen).to(tdt)
                    for _ in range(2))
            kl = torch.tensor(k_lens, dtype=torch.int32, device="cuda")
            stale = (torch.arange(sk, device="cuda")[None, :]
                     >= kl.repeat_interleave(h)[:, None])
            clean = [t.clone() for t in (k, v)]
            k[stale] = nan
            v[stale] = nan
            scale = d ** -0.5
            args = (q, k, v, 0, scale, causal, 0.0)
            o, lse = fa._fwd(*args, k_len=kl, heads=h)
            torch.cuda.synchronize()
            ro, rlse = fa.mha_reference(*args, k_len=kl, heads=h)
            err_o = (o.float() - ro.float()).abs().max().item()
            err_lse = (lse - rlse).abs().max().item()
            same_width = same_neighbours = None
            if sq == 1:
                # a single query sees every key below its length under the
                # bottom-right causal mask at any width (a wider prefill
                # operand would move the causal diagonal instead)
                wide = [torch.cat([t, torch.full_like(t, nan)], 1) for t in (k, v)]
                o2, lse2 = fa._fwd(q, *wide, 0, scale, causal, 0.0, k_len=kl, heads=h)
                same_width = torch.equal(o2, o) and torch.equal(lse2, lse)
            if b > 1:
                # row 0 keeps its length; the others take other lengths
                # (over clean rows, so their own outputs stay finite)
                other = kl.clone()
                other[1:] = sk + 1 - kl[1:]
                o3, lse3 = fa._fwd(q, *clean, 0, scale, causal, 0.0, k_len=other, heads=h)
                same_neighbours = (torch.equal(o3[:h], o[:h])
                                   and torch.equal(lse3[:h], lse[:h]))
            torch.cuda.synchronize()
            ms, dev = timed(torch, lambda: fa._fwd(*args, k_len=kl, heads=h))
            plain_ms, plain_dev = timed(
                torch, lambda: fa.mha_reference(*args, k_len=kl, heads=h), iters=5)
            cols = torch.arange(sk, device="cuda")
            mask = cols[None, :] < kl[:, None, None, None]  # [b, 1, 1, sk]
            if causal:
                mask = mask & (cols[None, :] <= torch.arange(sq, device="cuda")[:, None]
                               + (sk - sq))
            q4, k4, v4 = (x.view(b, h, -1, d) for x in (q, *clean))
            library_ms, library_dev = timed(torch, lambda: F.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=mask, scale=scale))
            bound, bound_by = length_bound_ms(h, sq, sk, d, dt, causal, k_lens)
            ok = (err_o <= TOL_O[dt] and err_lse <= TOL_LSE and bool(torch.isfinite(o).all())
                  and same_width is not False and same_neighbours is not False)
            results.append(dict(form, dtype=dt, k_lens=k_lens, max_abs_err=err_o,
                                max_lse_err=err_lse, same_bits_wider=same_width,
                                same_bits_other_lengths=same_neighbours, ms=ms,
                                device_ms=dev, plain_ms=plain_ms, plain_device_ms=plain_dev,
                                library_ms=library_ms, library_device_ms=library_dev,
                                bound_ms=bound, bound_by=bound_by, ok=ok))
            lens = (f"k_len {k_lens[0]}" if min(k_lens) == max(k_lens) else
                    f"k_len {min(k_lens)}..{max(k_lens)} (mean {np.mean(k_lens):.1f})")
            log(f"  {form['name']}: b={b} h={h} sq={sq} pool {sk} rows d={d} {dt} "
                f"causal={causal} {lens}: "
                f"O err {err_o:.3e} LSE err {err_lse:.3e}; same bits at pool {2 * sk}: "
                f"{_na(same_width)}; same bits beside other lengths: {_na(same_neighbours)} | "
                "kernel "
                f"{ms:.4f} / {_fmt(dev)} ms{_share(bound, dev)}; plain {plain_ms:.4f} / "
                f"{_fmt(plain_dev)} ms; library (sdpa, boolean key mask) {_fmt(library_ms)} / "
                f"{_fmt(library_dev)} ms; bound {bound:.4f} ms ({bound_by}) "
                f"{'ok' if ok else 'DISAGREES'}")
    if any(not r["ok"] for r in results):
        fail("flash_attention_fwd's length form disagrees with mha_reference or changes "
             "a row's bits with the pool's width or the other rows' lengths")
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
            out = F.scaled_dot_product_attention(q4, k4, v4, is_causal=library_causal(c),
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
    burst_batches = batches() - before_burst
    for i, (outs, ms) in enumerate(burst_out):
        sent.append((burst[i], outs, ms, f"burst client {i} seq 512"))
    # the reference's contract (inference/batching.py:88-99): a request of
    # >= 2 rows coalesced with others is bitwise its direct call. A 2-row
    # and a 3-row request sent together
    pair = [rng.randint(0, model.vocab_size, (n, 128)).astype(np.int32) for n in (2, 3)]
    pair_out = [None, None]
    gate2 = threading.Barrier(2)

    def pair_client(i):
        gate2.wait()
        pair_out[i] = request(pair[i])

    before_pair = batches()
    threads = [threading.Thread(target=pair_client, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    pair_batches = batches() - before_pair
    for i, (outs, ms) in enumerate(pair_out):
        sent.append((pair[i], outs, ms, f"coalesced {pair[i].shape[0]}-row seq 128"))
    launches = fa.launches
    fired = batches()

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

    # recorded, not required: the reference's contract rests on XLA's CPU
    # programs being row-stable across batch sizes >= 2; on the card cuBLAS
    # picks its GEMM kernels per M (here 8 x 128 coalesced rows against 2 x
    # 128 and 3 x 128). Coalesced 1-row requests are the contract's own
    # exemption and are not compared
    same = []
    for ids, (seq_out, _) in zip(pair, pair_out):
        (direct, _) = run(ids)
        same.append(bool(np.array_equal(seq_out, direct.cpu().numpy())))
    log(f"[serving] a 2-row and a 3-row request coalesced into {pair_batches} batch(es): "
        f"bitwise equal to their direct calls {sum(same)}/{len(same)} (recorded, not "
        "required)")

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


def profile_device(torch, fn, label, top=8, groups=None):
    """Where one call of ``fn`` spends its device time: its CUDA-event time,
    then the same call traced with torch.profiler (kernel device time by
    name, the top 8, and by ``groups``, KERNEL_GROUPS by default). Returns
    (events ms, kernel ms, kernels launched, {group: (ms, kernels)})."""
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
    sums = {}
    for t, n, name in kernels:
        group = next((g for g, keys in groups or KERNEL_GROUPS
                      if any(k in name for k in keys)),
                     "other elementwise, reductions, copies")
        tot, cnt = sums.get(group, (0.0, 0))
        sums[group] = (tot + t, cnt + n)
    for group, (t, n) in sorted(sums.items(), key=lambda kv: -kv[1][0]):
        log(f"    [group] {t:8.3f} ms {100 * t / max(busy, 1e-9):5.1f}% x{n:<5d} {group}")
    launched = sum(n for _, n, _ in kernels)
    # what the host spent handing work to the card
    calls = [(ev.key, ev.count, ev.self_cpu_time_total / 1e3) for ev in prof.key_averages()
             if ev.key in ("cudaLaunchKernel", "cuLaunchKernel", "cuLaunchKernelEx",
                           "cudaMemcpyAsync")]
    log("    [host] " + (", ".join(f"{k} x{n} {t:.3f} ms" for k, n, t in calls)
                         or "no launch calls traced") + f"; {launched} kernels on the card")
    return ms, busy, launched, sums


# kernel-name fragments -> the layer of the port that launched them
KERNEL_GROUPS = (
    ("K1 flash_attention_fwd", ("fwd_f32_kernel", "fwd_bf16_kernel")),
    ("K2 flash_attention_bwd_dq", ("dq_f32_kernel", "dq_bf16_kernel")),
    ("K3 flash_attention_bwd_dkv", ("dkv_f32_kernel", "dkv_bf16_kernel")),
    ("GEMMs (cuBLAS/CUTLASS)", ("gemm", "xmma", "cutlass", "sm90_", "sm80_", "nvjet")),
    ("int64 elementwise (counter-hash dropout masks)", ("<long",)),
)
# a decode step's kernels: the cache writes and layout changes apart
DECODE_GROUPS = KERNEL_GROUPS[:1] + KERNEL_GROUPS[3:4] + (
    ("copies (cache rows, head layouts, RoPE interleave)",
     ("copy", "Copy", "Memcpy", "cat", "Cat")),
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

    step_ms, busy_ms, _, _ = profile_device(torch, one_step,
                                      f"O1 training step, batch {O1_BATCH} x {TRAIN_SEQ}",
                                      top=16)
    idle = (f"{100 * (1 - busy_ms / step_ms):.1f}%" if busy_ms > 0 else "not measured")
    log(f"[profile] device idle {idle} of an O1 step (kernel time summed over the "
        "traced step against the CUDA-event time of the step before it)")
    return dict(counts=counts, steps=steps_on_card, step_ms=steady * 1e3,
                tokens_per_s=tokens / steady, losses=losses)


# ------------------------------------------------------------------ phase 6
GEN_BATCH, GEN_PROMPT, GEN_NEW = 16, 128, 128  # bench.py's decode shape
# depth-2 prefill logits, card vs CPU: float32 max abs; bfloat16 relative
# to the row's max |logit|
TOL_GEN_LOGITS = {"float32": 1e-3, "bfloat16": 2e-2}
# a generated token may differ from the CPU's only where the CPU's
# teacher-forced logits show a near-tie: float32 absolute, bfloat16
# relative to the row's max |logit|
TIE = {"float32": 1e-4, "bfloat16": 2e-2}
# 7B cross-check: the cached path's token at most this share of the row's
# max |logit| below the top logit of one full forward over the output
TOL_XCHECK = 3e-2
# the sampled calls (llama_generate's keywords)
SAMPLED = dict(do_sample=True, temperature=0.8, top_k=50, top_p=0.9, seed=0)
# a sampled token at depth 2, float32, may differ from the CPU's only where
# the CPU's perturbed scores (filtered logits plus the step's Gumbel noise)
# put it within this of their maximum
SAMPLE_TIE = 1e-4


def decode_bound(n_params, vocab, hidden, layers, kv_width, batch, mean_len, itemsize=2):
    """The two-term bound of one decode step in bench.py's terms: the step
    reads every weight but the embedding table once (the table only for
    the batch's rows) and every row's valid K/V cache, over the HBM rate.
    Returns (ms per step, tokens/s)."""
    weights = (n_params - vocab * hidden + batch * hidden) * itemsize
    kv = 2 * layers * kv_width * mean_len * itemsize
    secs = (weights + batch * kv) / HBM_BYTES_PER_S
    return secs * 1e3, batch / secs


def token_gaps(torch, logits, out, t0):
    """For each generated position of ``out`` [B, T] (t0 on): the top logit
    of the forward ``logits`` [B, T, V] at the position before it minus
    the chosen token's logit, the row's max |logit|, and whether the token
    is the argmax. Numpy arrays [B, T - t0]."""
    lg = logits[:, t0 - 1:-1].float()
    chosen = torch.from_numpy(np.ascontiguousarray(out[:, t0:])).to(lg.device).long()
    pick = lg.gather(-1, chosen[..., None])[..., 0]
    return ((lg.amax(-1) - pick).cpu().numpy(), lg.abs().amax(-1).cpu().numpy(),
            (lg.argmax(-1) == chosen).cpu().numpy())


def _forward(torch, model, ids, dev):
    with torch.inference_mode():
        return model(torch.from_numpy(np.ascontiguousarray(ids)).to(dev))


def sample_keys(prandom, seed, n):
    """The keys llama_generate draws its n tokens with: PRNGKey(seed) for
    the first, then ``sub`` of ``key, sub = split(key)`` for each later."""
    key = prandom.PRNGKey(seed)
    keys = [key]
    for _ in range(1, n):
        key, sub = prandom.split(key)
        keys.append(sub)
    return keys


def sampled_gaps(torch, generation, prandom, logits, out, t0, cfg):
    """For each sampled position of ``out`` [B, T] (t0 on): the top
    perturbed score (the teacher-forced ``logits`` [B, T, V] at the position
    before it, filtered, plus that step's Gumbel noise, the scores
    jax.random.categorical takes the first maximum of) minus the chosen
    token's. Numpy [B, T - t0]."""
    opts = {k: cfg[k] for k in ("temperature", "top_k", "top_p")}
    gaps = []
    for i, key in enumerate(sample_keys(prandom, cfg["seed"], out.shape[1] - t0)):
        filtered = generation._filter_logits(logits[:, t0 - 1 + i], **opts)
        scores = prandom.gumbel(key, filtered.shape, filtered.device) + filtered
        chosen = torch.from_numpy(np.ascontiguousarray(out[:, t0 + i])).to(scores.device)
        pick = scores.gather(-1, chosen.long()[:, None])[:, 0]
        gaps.append((scores.amax(-1) - pick).cpu().numpy())
    return np.stack(gaps, 1)


def timed_loop(torch, steps, run_step):
    """``run_step()`` ``steps`` times with a CUDA event after each: (the
    window's ms from the first event to the last, the median step ms,
    min, max)."""
    events = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
    torch.cuda.synchronize()
    events[0].record()
    for i in range(steps):
        run_step()
        events[i + 1].record()
    torch.cuda.synchronize()
    each = sorted(a.elapsed_time(b) for a, b in zip(events, events[1:]))
    return events[0].elapsed_time(events[-1]), each[len(each) // 2], each[0], each[-1]


def profile_replay(torch, replay, label, n_layers):
    """One replay profiled: (events ms, kernel ms, kernels, K1 records).
    The window is taken again once if it shows no K1 record per layer."""
    for _ in range(2):
        ms, busy, kernels, groups = profile_device(torch, replay, label, top=12,
                                                   groups=DECODE_GROUPS)
        k1 = groups.get(KERNEL_GROUPS[0][0], (0.0, 0))[1]
        if k1 == n_layers:
            break
    return ms, busy, kernels, k1


def phase_generation(torch, fa, mods, card):
    LlamaModel, generation, prandom, Graph, pool_bytes = mods
    t_phase = time.perf_counter()
    torch.set_num_threads(os.cpu_count() or 1)
    torch.cuda.empty_cache()
    rng = np.random.RandomState(0)
    launched = 0  # K1 launches of the phase's main-path runs on the card

    # (a) full width, depth 2: the card against the CPU, float32 then bf16;
    # in float32 a sampled call too
    t = time.perf_counter()
    model = LlamaModel(num_layers=2, device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(0)).eval()
    cpu_model = copy.deepcopy(model).to("cpu")
    vocab = model.embed_tokens.weight.shape[0]
    log(f"[generation] Llama-2-7B width at depth 2: "
        f"{sum(p.numel() for p in model.parameters())} parameters, built in "
        f"{time.perf_counter() - t:.1f} s (a CPU copy beside it)")
    prompts = rng.randint(0, vocab, (2, 32)).astype(np.int32)
    for dt in ("float32", "bfloat16"):
        if dt == "bfloat16":  # the reference's model.to(dtype="bfloat16")
            model.to(torch.bfloat16)
            cpu_model.to(torch.bfloat16)
        fa.launches = 0
        gl = _forward(torch, model, prompts, "cuda").float().cpu()
        cl = _forward(torch, cpu_model, prompts, "cpu").float()
        err = (gl - cl).abs()
        if dt == "float32":
            lerr = err.max().item()
        else:
            lerr = (err.amax(-1) / cl.abs().amax(-1)).max().item()
        t = time.perf_counter()
        gout = model.generate(prompts, max_new_tokens=8)
        g_s = time.perf_counter() - t
        launched += fa.launches
        t = time.perf_counter()
        cout = cpu_model.generate(prompts, max_new_tokens=8)
        c_s = time.perf_counter() - t
        gap, scale, agree = token_gaps(torch, _forward(torch, cpu_model, gout, "cpu"),
                                       gout, prompts.shape[1])
        tie = TIE[dt] * (1.0 if dt == "float32" else scale)
        bad = gap > tie
        excused = int((~agree & ~bad).sum())
        log(f"[generation] depth 2 {dt}: prefill logits of 2 x 32, card vs CPU: "
            f"{'max abs err' if dt == 'float32' else 'max err / row max |logit|'} "
            f"{lerr:.3e} (tolerance {TOL_GEN_LOGITS[dt]}); generate(8), graphed: tokens equal "
            f"{np.array_equal(gout, cout)}, {excused} excused at a near-tie of the "
            f"CPU's teacher-forced logits ({'' if dt == 'float32' else 'share '}"
            f"{TIE[dt]}), {int(bad.sum())} beyond it; card {g_s:.2f} s, CPU {c_s:.2f} s")
        if lerr > TOL_GEN_LOGITS[dt] or bad.any() or gout.shape != (2, 40):
            fail(f"depth-2 Llama {dt} on the card disagrees with the CPU")
        if dt == "float32":
            fa.launches = 0
            sout = model.generate(prompts, max_new_tokens=8, **SAMPLED)
            launched += fa.launches
            scout = cpu_model.generate(prompts, max_new_tokens=8, **SAMPLED)
            sgap = sampled_gaps(torch, generation, prandom,
                                _forward(torch, cpu_model, sout, "cpu"), sout,
                                prompts.shape[1], SAMPLED)
            near = int(((sgap > 0) & (sgap <= SAMPLE_TIE)).sum())
            sbad = int((sgap > SAMPLE_TIE).sum())
            log(f"[generation] depth 2 float32, sampled ({SAMPLED}): card tokens equal the "
                f"CPU's {np.array_equal(sout, scout)}; {near} near-tie(s) of the CPU's "
                f"perturbed scores (top two within {SAMPLE_TIE}), {sbad} token(s) beyond one")
            if sbad or sout.shape != (2, 40):
                fail("depth-2 sampled Llama on the card disagrees with the CPU")
    del model, cpu_model
    torch.cuda.empty_cache()

    # (b) Llama-2-7B at full width and depth, bfloat16
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    model = LlamaModel(device="cuda", generator=torch.Generator(device="cuda").manual_seed(0))
    model.to(torch.bfloat16).eval()
    torch.cuda.synchronize()
    n_layers = len(model.layers)
    n_params = sum(p.numel() for p in model.parameters())
    attn = model.layers[0].self_attn
    vocab, hidden = model.embed_tokens.weight.shape
    log(f"[generation] Llama-2-7B: {n_layers} layers, hidden {hidden}, {attn.num_heads} "
        f"heads of {attn.head_dim}, vocab {vocab}, {n_params} parameters drawn on the card "
        f"in float32 and cast to bfloat16 in {time.perf_counter() - t:.1f} s; peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    prompts = rng.randint(0, vocab, (GEN_BATCH, GEN_PROMPT)).astype(np.int32)
    # K1 launches of the generate, split by where they ran: the prefill, and
    # the steps (the warm-up step and the replays, each credited)
    split = {"prefill": 0}
    base_prefill = generation._CachedLlama.prefill

    def counted_prefill(self, prompt):
        before = fa.launches
        base_prefill(self, prompt)
        split["prefill"] += fa.launches - before

    generation._CachedLlama.prefill = counted_prefill
    fa.launches = 0  # count the main path only
    try:
        t = time.perf_counter()
        out = model.generate(prompts, max_new_tokens=GEN_NEW)
        gen_s = time.perf_counter() - t
    finally:
        generation._CachedLlama.prefill = base_prefill
    gen_launches = fa.launches
    launched += gen_launches
    split["decode"] = gen_launches - split["prefill"]
    want = n_layers * GEN_NEW
    gen_tps = GEN_BATCH * GEN_NEW / gen_s
    log(f"[generation] generate({GEN_BATCH} x {GEN_PROMPT}, max_new_tokens={GEN_NEW}), the "
        f"step captured as a CUDA graph: {gen_s:.3f} s by host clock = {gen_tps:.1f} tokens/s "
        f"over the whole call (the prefill and the capture included); K1 launches "
        f"{gen_launches} (expected {n_layers} x {GEN_NEW} = {want}): prefill "
        f"{split['prefill']} (expected {n_layers}), decode steps {split['decode']} (expected "
        f"{n_layers} x {GEN_NEW - 1}: the warm-up step and {GEN_NEW - 2} replays)")
    if (gen_launches != want or split["prefill"] != n_layers
            or split["decode"] != n_layers * (GEN_NEW - 1)):
        fail(f"the cached generate launched K1 {gen_launches} times (prefill "
             f"{split['prefill']}, decode {split['decode']}), not {want}")
    if (out.shape != (GEN_BATCH, GEN_PROMPT + GEN_NEW) or not np.array_equal(
            out[:, :GEN_PROMPT], prompts) or out.min() < 0 or out.max() >= vocab):
        fail(f"generate returned {out.shape} ids out of shape or range")
    t = time.perf_counter()
    eager = generation.llama_generate(model, prompts, GEN_NEW, cuda_graph=False)
    eager_s = time.perf_counter() - t
    log(f"[generation] the same call with the steps run eagerly: {eager_s:.3f} s; greedy "
        f"tokens bitwise equal to the graphed call's: {np.array_equal(out, eager)}")
    if not np.array_equal(out, eager):
        fail("the graphed llama_generate's greedy tokens differ from the eager steps'")
    fa.launches = 0
    gap, scale, agree = token_gaps(torch, _forward(torch, model, out, "cuda"), out,
                                   GEN_PROMPT)
    launched += fa.launches
    worst = (gap / (TOL_XCHECK * scale)).max()
    log(f"[generation] teacher-forced cross-check, one forward over [{GEN_BATCH}, "
        f"{out.shape[1]}]: argmax agrees at {100 * agree.mean():.2f}% of {agree.size} "
        f"positions; worst gap {worst:.3f} of the limit ({TOL_XCHECK} of the row's "
        f"max |logit|)")
    if worst > 1.0:
        fail("a cached-path token lies further below the full forward's top logit "
             "than the limit")
    fa.launches = 0
    sampled = model.generate(prompts, max_new_tokens=GEN_NEW, **SAMPLED)
    launched += fa.launches
    sampled_launches = fa.launches
    sampled_eager = generation.llama_generate(model, prompts, GEN_NEW, cuda_graph=False,
                                              **SAMPLED)
    same_sampled = np.array_equal(sampled, sampled_eager)
    log(f"[generation] sampled ({SAMPLED}): graphed tokens bitwise equal to the eager "
        f"steps' {same_sampled}; K1 launches {sampled_launches}; "
        f"{100 * np.mean(sampled[:, GEN_PROMPT:] == out[:, GEN_PROMPT:]):.1f}% of the "
        "tokens equal the greedy run's")
    if (not same_sampled or sampled.shape != out.shape or sampled_launches != want
            or sampled.min() < 0 or sampled.max() >= vocab):
        fail("the graphed sampled llama_generate differs from its eager steps")

    # (c) the generic full-width path on the card
    fa.launches = 0
    gout = model.generate(prompts[:2], max_new_tokens=4, use_cache=False)
    generic_launches = fa.launches
    launched += generic_launches
    ggap, gscale, gagree = token_gaps(torch, _forward(torch, model, gout, "cuda"), gout,
                                      GEN_PROMPT)
    gworst = (ggap / (TOL_XCHECK * gscale)).max()
    log(f"[generation] generic path (use_cache=False), batch 2, 4 tokens: K1 launches "
        f"{generic_launches} (expected {n_layers} x 4); argmax agrees "
        f"{int(gagree.sum())}/{gagree.size}, worst gap {gworst:.3f} of the limit")
    if generic_launches != n_layers * 4 or gout.shape != (2, GEN_PROMPT + 4) or gworst > 1:
        fail("the generic generate path disagrees or took another path")

    # (d) times: the prefill; the decode loop eager, then graphed (the
    # steps after the warm-up step, each a replay); one replay profiled
    ids = torch.from_numpy(prompts).cuda()
    prefill_bound = 2.0 * (n_params - vocab * hidden) * GEN_BATCH * GEN_PROMPT / \
        PEAK_OPS_PER_S["bfloat16"] * 1e3
    mean_len = GEN_PROMPT + GEN_NEW // 2  # steps read 129..255 rows
    bound_ms, bound_tps = decode_bound(n_params, vocab, hidden, n_layers,
                                       attn.num_kv_heads * attn.head_dim, GEN_BATCH, mean_len)
    with torch.inference_mode():
        run = generation._CachedLlama(model, GEN_BATCH, GEN_PROMPT, GEN_NEW)
        prefill_ms, prefill_busy, _, _ = profile_device(
            torch, lambda: run.forward(ids, 0), f"prefill of {GEN_BATCH} x {GEN_PROMPT} "
            f"(bound {prefill_bound:.3f} ms, operations)", top=6, groups=DECODE_GROUPS)
        run.prefill(ids)
        eager_window, eager_step, lo, hi = timed_loop(torch, GEN_NEW - 1, run.step)
        eager_tps = GEN_BATCH * (GEN_NEW - 1) / eager_window * 1e3
        eager_same = torch.equal(run.tokens.cpu(), torch.from_numpy(out[:, GEN_PROMPT:]).long())
        log(f"[generation] eager decode loop: steps 2-{GEN_NEW} in {eager_window:.3f} ms by "
            f"CUDA events = {eager_tps:.1f} tokens/s over the window; median step "
            f"{eager_step:.3f} ms (min {lo:.3f}, max {hi:.3f}); tokens equal the call's "
            f"{eager_same}")
        run = generation._CachedLlama(model, GEN_BATCH, GEN_PROMPT, GEN_NEW)
        run.prefill(ids)
        torch.cuda.synchronize()
        t = time.perf_counter()
        graph = Graph(run.step, ids.device)  # the warm-up is step 2
        torch.cuda.synchronize()
        build_ms = (time.perf_counter() - t) * 1e3
        pool = pool_bytes(graph.pool())
        window_ms, step_ms, lo, hi = timed_loop(torch, GEN_NEW - 2, graph.replay)
        decode_tps = GEN_BATCH * (GEN_NEW - 2) / window_ms * 1e3
        graph_same = torch.equal(run.tokens.cpu(), torch.from_numpy(out[:, GEN_PROMPT:]).long())
        log(f"[generation] graphed decode loop: warm-up step and capture {build_ms:.1f} ms "
            f"(capture and instantiation {graph.capture_ms:.1f} ms), graph pool "
            f"{pool} bytes; steps 3-{GEN_NEW} ({GEN_NEW - 2} replays) in {window_ms:.3f} ms by "
            f"CUDA events = {decode_tps:.1f} tokens/s over the window, "
            f"{100 * decode_tps / bound_tps:.1f}% of the two-term bound {bound_ms:.3f} ms a "
            f"step = {bound_tps:.0f} tokens/s at a mean cache length of {mean_len} (weights "
            f"{(n_params - vocab * hidden) * 2 / 1e9:.2f} GB + KV, data-sheet HBM rate, not "
            f"measured); median step {step_ms:.3f} ms (min {lo:.3f}, max {hi:.3f}); tokens "
            f"equal the call's {graph_same}; the generate call {gen_tps:.1f} tokens/s with "
            f"its prefill | {card}")
        if not (eager_same and graph_same):
            fail("the timed decode loops' tokens differ from the generate call's")
        # one replay at the mean cache length, profiled
        run.pos.fill_(mean_len - 1)
        run.k_len.fill_(mean_len)
        run.index.fill_(1)
        dec_ms, dec_busy, dec_kernels, k1_records = profile_replay(
            torch, graph.replay, f"one decode step replayed, batch {GEN_BATCH}, cache "
            f"length {mean_len}", n_layers)
    idle = f"{100 * (1 - dec_busy / dec_ms):.1f}%" if dec_busy > 0 else "not measured"
    log(f"[profile] device idle {idle} of a replayed decode step; {dec_kernels} kernels on "
        f"the card, {dec_kernels / n_layers:.1f} a layer; K1 records {k1_records} (expected "
        f"{n_layers})")
    if k1_records != n_layers:
        fail(f"a profiled replay shows {k1_records} K1 kernels, not {n_layers}")
    capture_ms = graph.capture_ms
    del graph, run
    log(f"[generation] the phase took {time.perf_counter() - t_phase:.1f} s")
    return dict(launches=launched, prefill_launches=split["prefill"],
                decode_launches=split["decode"], prefill_ms=prefill_ms,
                prefill_kernel_ms=prefill_busy, step_ms=step_ms, tokens_per_s=decode_tps,
                eager_tokens_per_s=eager_tps, eager_step_ms=eager_step,
                generate_tokens_per_s=gen_tps, bound_step_ms=bound_ms,
                bound_tokens_per_s=bound_tps, argmax_share=float(agree.mean()), idle=idle,
                capture_ms=capture_ms, pool_bytes=pool)


# ------------------------------------------------------------------ phase 7
ENGINE_SLOTS, ENGINE_SEQ, ENGINE_PROMPT = 16, 256, 128
ENGINE_FIRST, ENGINE_LATER = 16, 8  # streaming clients: all at once, then as the first retire


def _decode_call(wire_spec, port, prompt, n, budget_ms=None, oneshot=False, close_after=None):
    """One decode request over the wire: -> (statuses of its frames, the
    token chunks they carried, seconds from the send to the first frame).
    ``close_after``: hang up after that many frames, mid-stream."""
    tail = wire_spec.encode_decode_opts(n, oneshot=oneshot)
    if budget_ms is not None:
        tail = wire_spec.encode_deadline(budget_ms) + tail
    frame = wire_spec.build_request(wire_spec.CMD_INFER,
                                    wire_spec.encode_arrays([prompt]) + tail)
    statuses, chunks, first_s = [], [], None
    with socket.create_connection(("127.0.0.1", port), timeout=600) as s:
        t0 = time.perf_counter()
        s.sendall(frame)
        while True:
            (blen,) = struct.unpack("<I", _recv(s, 4))
            body = _recv(s, blen)
            if first_s is None:
                first_s = time.perf_counter() - t0
            statuses.append(body[0])
            if len(body) > 1:
                chunks.append(wire_spec.decode_arrays(body[1:])[0])
            if body[0] != wire_spec.STATUS_STREAM or len(statuses) == close_after:
                return statuses, chunks, first_s


def engine_tokens(torch, generation, DecodeEngine, model, device, prompts, n):
    """Greedy tokens of ``prompts`` decoded together through a 4-slot
    engine over ``model`` on ``device``."""
    dm = generation.llama_decode_model(model, 4, 64)
    with DecodeEngine(dm, device=device, max_prompt_len=32, name=f"llama-{device}") as eng:
        reqs = [eng.submit(p, max_new_tokens=n) for p in prompts]
        return [r.result(timeout=600) for r in reqs]


def serve_window(torch, fa, engine, PredictorServer, wire_spec, base):
    """The engine behind PredictorServer on localhost, serving the streams
    of ``base`` (a list of dicts with prompt and n; the first ENGINE_FIRST
    all at once, the next ENGINE_LATER as the first retire) and the three
    extras after them: one hangs up after its 4th chunk, one has a 1 ms
    per-token budget, one is one-shot. The window runs from the first
    submit to the last terminal frame, timed by CUDA events; K1 is counted
    from 0 over it. Returns (the streams with statuses, chunks and time to
    the first frame, the server, a dict of the window's numbers and stats
    deltas, every DecodeRequest submitted)."""
    work = [dict(prompt=w["prompt"], n=w["n"]) for w in base]
    requests = []  # every DecodeRequest the server submits, to read its peak batch
    submit = engine.submit

    def recording_submit(*args, **kw):
        req = submit(*args, **kw)
        requests.append(req)
        return req

    engine.submit = recording_submit
    server = PredictorServer(None, decode_engine=engine, own_decode_engine=True)
    n_streams = ENGINE_FIRST + ENGINE_LATER
    hang, tiny, oneshot = work[n_streams:]
    retired = threading.Semaphore(0)
    gate = threading.Barrier(ENGINE_FIRST + 2)  # the first wave, the 1 ms one, this thread
    errors = []

    def client(w, first, **kw):
        try:
            if first:
                gate.wait()
            else:
                retired.acquire()
            w["statuses"], w["chunks"], w["first_s"] = _decode_call(
                wire_spec, server.port, w["prompt"], w["n"], **kw)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(f"{type(e).__name__}: {e}")
        finally:
            retired.release()

    threads = [threading.Thread(target=client, args=(w, i < ENGINE_FIRST))
               for i, w in enumerate(work[:n_streams])]
    threads += [threading.Thread(target=client, args=(hang, False), kwargs=dict(close_after=4)),
                threading.Thread(target=client, args=(tiny, True), kwargs=dict(budget_ms=1.0)),
                threading.Thread(target=client, args=(oneshot, False),
                                 kwargs=dict(oneshot=True))]
    for t in threads:
        t.start()
    before = engine.stats()
    fa.launches = 0  # count the window's launches only
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    gate.wait()
    start.record()
    t0 = time.perf_counter()
    for t in threads:
        t.join(900)
        if t.is_alive():
            fail("a decode client did not finish within 900 s")
    end.record()
    end.synchronize()
    host_s = time.perf_counter() - t0
    launches = fa.launches
    after = engine.stats()
    if errors:
        fail(f"decode clients failed: {errors[:3]}")
    # wait for the hung-up stream's slot: the server cancels it at its next send
    t_end = time.monotonic() + 30
    while engine.health()["active"] or engine.health()["free_slots"] != ENGINE_SLOTS:
        if time.monotonic() > t_end:
            fail(f"the engine did not free its slots: {engine.health()}")
        time.sleep(0.05)
    st = engine.stats()
    delta = {k: after[k] - before[k] for k in ("prefills", "steps", "tokens", "step_rows",
                                               "k1_launches", "graph_replays")}
    for w in work[:n_streams]:
        w["tokens"] = np.concatenate(w["chunks"]) if w["chunks"] else np.zeros(0, np.int32)
    oneshot["tokens"] = oneshot["chunks"][0] if oneshot["chunks"] else None
    window = dict(window_ms=start.elapsed_time(end), host_s=host_s, launches=launches,
                  delta=delta, stats=st,
                  ttft_ms=1e3 * float(np.median([w["first_s"] for w in work[:n_streams]])))
    return work, server, window, requests


def stop_server(server, engine, wire_spec):
    status, _ = _call(server.port, wire_spec.build_request(wire_spec.CMD_STOP))
    if status != wire_spec.STATUS_OK:
        fail(f"cmd 7 stop answered status {status}")
    server._thread.join(30)
    t_end = time.monotonic() + 30
    while not engine.health()["closed"]:
        if time.monotonic() > t_end:
            fail("cmd 7 did not close the decode engine within 30 s")
        time.sleep(0.05)


def phase_engine(torch, fa, mods, card, gen6):
    LlamaModel, generation, DecodeEngine, seq_bucket, PredictorServer, wire_spec = mods
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    rng = np.random.RandomState(6)

    # (e) full width, depth 2, float32: the same engine on the card (its
    # programs captured at first use) and on the CPU, 4 requests decoded
    # together on each
    model = LlamaModel(num_layers=2, device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(0)).eval()
    cpu_model = copy.deepcopy(model).to("cpu")
    vocab = model.embed_tokens.weight.shape[0]
    prompts = [rng.randint(0, vocab, (n,)).astype(np.int32) for n in (5, 17, 32, 9)]
    t = time.perf_counter()
    card_out = engine_tokens(torch, generation, DecodeEngine, model, "cuda", prompts, 8)
    card_s = time.perf_counter() - t
    t = time.perf_counter()
    cpu_out = engine_tokens(torch, generation, DecodeEngine, cpu_model, "cpu", prompts, 8)
    cpu_s = time.perf_counter() - t
    equal = excused = beyond = 0
    for p, g, c in zip(prompts, card_out, cpu_out):
        ids = np.concatenate([p, g])[None]
        gap, _, agree = token_gaps(torch, _forward(torch, cpu_model, ids, "cpu"), ids, p.size)
        equal += int(np.array_equal(g, c))
        excused += int((~agree & (gap <= TIE["float32"])).sum())
        beyond += int((gap > TIE["float32"]).sum())
    log(f"[engine] (e) depth 2 float32, 4 requests through the engine on the card (graphed) "
        f"and on the CPU: {equal}/4 token streams equal, {excused} token(s) excused at a "
        f"near-tie of the CPU's teacher-forced logits ({TIE['float32']}), {beyond} beyond it; "
        f"card {card_s:.2f} s, CPU {cpu_s:.2f} s")
    if beyond or any(g.shape != (8,) for g in card_out):
        fail("the decode engine on the card disagrees with the same engine on the CPU")
    del model, cpu_model
    torch.cuda.empty_cache()

    # Llama-2-7B at full width and depth, bfloat16, behind PredictorServer
    torch.cuda.reset_peak_memory_stats()
    model = LlamaModel(device="cuda", generator=torch.Generator(device="cuda").manual_seed(0))
    model.to(torch.bfloat16).eval()
    n_layers = len(model.layers)
    n_params = sum(p.numel() for p in model.parameters())
    attn = model.layers[0].self_attn
    vocab, hidden = model.embed_tokens.weight.shape
    dm = generation.llama_decode_model(model, ENGINE_SLOTS, ENGINE_SEQ)
    engine = DecodeEngine(dm, max_prompt_len=ENGINE_PROMPT, max_queue=64, name="llama-7b")
    t = time.perf_counter()
    buckets = engine.warmup()
    torch.cuda.synchronize()
    st0 = engine.stats()
    log(f"[engine] Llama-2-7B bf16, {ENGINE_SLOTS} slots x {ENGINE_SEQ} positions: KV pools "
        f"{st0['kv_pool_bytes'] / 1e9:.2f} GB; warmup (prompt buckets {buckets} and the step, "
        f"each warmed up and captured) {time.perf_counter() - t:.2f} s; captures "
        + ", ".join(f"{k} {v['capture_ms']:.1f} ms" for k, v in st0["programs"].items())
        + f"; graph pool {st0['graph_pool_bytes']} bytes; peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    n_streams = ENGINE_FIRST + ENGINE_LATER
    plens = rng.randint(16, ENGINE_PROMPT + 1, n_streams + 3)
    news = rng.randint(16, 97, n_streams + 3)
    base = [dict(prompt=rng.randint(0, vocab, (int(pl),)).astype(np.int32), n=int(nn))
            for pl, nn in zip(plens, news)]
    base[n_streams]["n"] = 96  # the one that hangs up
    work, server, win, requests = serve_window(torch, fa, engine, PredictorServer, wire_spec,
                                               base)
    hang, tiny, oneshot = work[n_streams:]
    st, delta = win["stats"], win["delta"]
    # (a) every stream well formed and whole; the 1 ms request shed; all
    # slots free again
    bad = [i for i, w in enumerate(work[:n_streams])
           if (w["statuses"][-1] != wire_spec.STATUS_OK
               or any(x != wire_spec.STATUS_STREAM for x in w["statuses"][:-1])
               or w["tokens"].size != w["n"] or w["tokens"].dtype != np.int32)]
    log(f"[engine] (a) graphed window, {n_streams} streams: {n_streams - len(bad)} well formed "
        f"with exactly their max_new_tokens; one-shot statuses {oneshot['statuses']}; 1 ms "
        f"budget statuses {tiny['statuses']}; hung up after {len(hang['chunks'])} chunk(s); "
        f"after the run {st['active']} active, {engine.health()['free_slots']}/"
        f"{ENGINE_SLOTS} slots free, retired {st['retired']}")
    if (bad or oneshot["statuses"] != [wire_spec.STATUS_OK]
            or oneshot["tokens"].size != oneshot["n"]
            or tiny["statuses"] != [wire_spec.STATUS_RETRYABLE]
            or len(hang["chunks"]) != 4 or st["retired"]["cancelled"] != 1):
        fail(f"decode streams malformed (streams {bad}) or the extras misbehaved")
    # (d) K1 ran once per layer in every prefill and every step, credited by
    # the replays; every program was captured once, by warmup
    want = n_layers * (delta["prefills"] + delta["steps"])
    used = {f"prefill1x{seq_bucket(w['prompt'].size, 8, ENGINE_SEQ)}" for w in work} | {
        f"step{ENGINE_SLOTS}x{ENGINE_SEQ}"}
    log(f"[engine] (d) K1 launches {win['launches']} = {n_layers} x ({delta['prefills']} "
        f"prefills + {delta['steps']} steps) = {want}; the engine counted "
        f"{delta['k1_launches']}; graph replays {delta['graph_replays']}; programs "
        f"{st['programs']}")
    if (win["launches"] != want or delta["k1_launches"] != want
            or delta["graph_replays"] != delta["prefills"] + delta["steps"]
            or not used <= set(st["programs"])
            or any(v["compiles"] != 1 for v in st["programs"].values())):
        fail("the engine's K1 launches, replays or captures do not match its prefill and "
             "step calls")
    # (c) every token against one full forward over prompt + output
    decoded = work[:n_streams] + [oneshot]
    worst, agree_n, total_n = 0.0, 0, 0
    for w in decoded:
        ids = np.concatenate([w["prompt"], w["tokens"]])[None]
        gap, scale, agree = token_gaps(torch, _forward(torch, model, ids, "cuda"), ids,
                                       w["prompt"].size)
        worst = max(worst, float((gap / (TOL_XCHECK * scale)).max()))
        agree_n += int(agree.sum())
        total_n += agree.size
    log(f"[engine] (c) {len(decoded)} sequences against a full forward over prompt + "
        f"output: argmax agrees at {100 * agree_n / total_n:.2f}% of {total_n} tokens; worst "
        f"gap {worst:.3f} of the limit ({TOL_XCHECK} of the row's max |logit|)")
    if worst > 1.0:
        fail("an engine token lies further below the full forward's top logit than the limit")
    # (b) solo = batch, bitwise: four sequences decoded again alone
    for w in decoded:
        req = next(r for r in requests if r.prompt.size == w["prompt"].size
                   and np.array_equal(r.prompt, w["prompt"]))
        w["peak_batch"] = req.peak_batch
    first = work[:ENGINE_FIRST]
    beside15 = [w for w in first if w["peak_batch"] == ENGINE_SLOTS]
    if not beside15:
        fail(f"no first-wave sequence ran in a full batch of {ENGINE_SLOTS}")
    picks = {"the longest prompt": max(work[:n_streams], key=lambda w: w["prompt"].size),
             "the shortest prompt": min(work[:n_streams], key=lambda w: w["prompt"].size),
             "joined mid-flight": work[ENGINE_FIRST],
             f"ran beside {ENGINE_SLOTS - 1} others": max(beside15, key=lambda w: w["n"])}
    solo_ok = []
    for label, w in picks.items():
        alone = engine.generate(w["prompt"], max_new_tokens=w["n"], timeout=600)
        same = bool(np.array_equal(alone, w["tokens"]))
        solo_ok.append(same)
        log(f"[engine] (b) {label}: prompt {w['prompt'].size}, {w['n']} tokens, peak batch "
            f"{w['peak_batch']}; decoded alone {'bitwise equal' if same else 'DIFFERS'}")
    if not all(solo_ok):
        fail("a sequence decoded alone differs from the same sequence decoded in the batch")

    # the numbers: tokens/s over the whole window, the bound, the steps
    mean_len = (sum(sum(w["prompt"].size + i for i in range(w["tokens"].size))
                    for w in decoded) / sum(w["tokens"].size for w in decoded))
    occupancy = delta["step_rows"] / (delta["steps"] * ENGINE_SLOTS)
    bound_ms, bound_tps = decode_bound(n_params, vocab, hidden, n_layers,
                                       attn.num_kv_heads * attn.head_dim,
                                       occupancy * ENGINE_SLOTS, mean_len)
    tps = delta["tokens"] / win["window_ms"] * 1e3
    log(f"[engine] graphed: {delta['tokens']} tokens in {win['window_ms']:.1f} ms by CUDA "
        f"events from the first submit to the last terminal frame = {tps:.1f} tokens/s "
        f"({delta['tokens'] / win['host_s']:.1f} by host clock), {100 * tps / bound_tps:.1f}% "
        f"of the two-term bound {bound_ms:.3f} ms a step = {bound_tps:.0f} tokens/s at that "
        f"occupancy and the mean cache length {mean_len:.1f}; {delta['prefills']} prefills, "
        f"{delta['steps']} steps, mean occupancy {occupancy:.3f} of {ENGINE_SLOTS} rows, "
        f"median step {st['step_ms_median']:.3f} ms (host clock, argmax read back included); "
        f"time to first token median {win['ttft_ms']:.1f} ms over the {n_streams} streams "
        f"| {card}")
    # one replayed engine step at full occupancy at the mean length, profiled
    key = ("step", ENGINE_SLOTS, ENGINE_SEQ)
    with torch.inference_mode(), engine._exec_lock:
        tokens, pos, _ = engine._graphs.inputs(key)
        tokens.zero_()
        pos.fill_(int(mean_len) - 1)
        run = engine._program(key)
        step_ms, step_busy, step_kernels, k1_records = profile_replay(
            torch, lambda: run().cpu(), f"one engine step replayed, {ENGINE_SLOTS} rows "
            f"at cache length {int(mean_len)}", n_layers)
    idle = f"{100 * (1 - step_busy / step_ms):.1f}%" if step_busy > 0 else "not measured"
    log(f"[profile] device idle {idle} of a replayed engine step; {step_kernels} kernels on "
        f"the card, {step_kernels / n_layers:.1f} a layer; K1 records {k1_records} "
        f"(expected {n_layers})")
    if k1_records != n_layers:
        fail(f"a profiled engine replay shows {k1_records} K1 kernels, not {n_layers}")
    stop_server(server, engine, wire_spec)

    # the same streams through the same engine run eagerly (no graph)
    eager_engine = DecodeEngine(dm, max_prompt_len=ENGINE_PROMPT, max_queue=64,
                                name="llama-7b-eager", cuda_graph=False)
    eager_engine.warmup()
    ework, eserver, ewin, _ = serve_window(torch, fa, eager_engine, PredictorServer,
                                           wire_spec, base)
    est, edelta = ewin["stats"], ewin["delta"]
    same = [np.array_equal(a["tokens"], b["tokens"])
            for a, b in zip(work[:n_streams] + [oneshot], ework[:n_streams] + [ework[-1]])]
    eocc = edelta["step_rows"] / (edelta["steps"] * ENGINE_SLOTS)
    etps = edelta["tokens"] / ewin["window_ms"] * 1e3
    ewant = n_layers * (edelta["prefills"] + edelta["steps"])
    log(f"[engine] eager window, the same streams: {sum(same)}/{len(same)} token streams "
        f"bitwise equal to the graphed window's; {edelta['tokens']} tokens in "
        f"{ewin['window_ms']:.1f} ms = {etps:.1f} tokens/s; {edelta['prefills']} prefills, "
        f"{edelta['steps']} steps, mean occupancy {eocc:.3f}, median step "
        f"{est['step_ms_median']:.3f} ms; time to first token median {ewin['ttft_ms']:.1f} "
        f"ms; K1 launches {ewin['launches']} (expected {ewant}); graph replays "
        f"{edelta['graph_replays']} | {card}")
    stop_server(eserver, eager_engine, wire_spec)
    if not all(same) or ewin["launches"] != ewant or edelta["graph_replays"]:
        fail("the graphed engine's tokens differ from the eager engine's, or the eager "
             "engine replayed a graph")
    log(f"[engine] phase 6's llama_generate loop for comparison (batch {GEN_BATCH}, full "
        f"occupancy): graphed {gen6['tokens_per_s']:.1f} tokens/s, median step "
        f"{gen6['step_ms']:.3f} ms, idle {gen6['idle']}; eager {gen6['eager_tokens_per_s']:.1f} "
        f"tokens/s, median step {gen6['eager_step_ms']:.3f} ms; bound "
        f"{gen6['bound_tokens_per_s']:.0f} tokens/s")
    log(f"[engine] the phase took {time.perf_counter() - t_phase:.1f} s")
    return dict(launches=win["launches"], prefill_launches=n_layers * delta["prefills"],
                step_launches=n_layers * delta["steps"], tokens_per_s=tps,
                eager_tokens_per_s=etps, bound_tokens_per_s=bound_tps,
                step_ms=st["step_ms_median"], eager_step_ms=est["step_ms_median"], idle=idle,
                ttft_ms=win["ttft_ms"], eager_ttft_ms=ewin["ttft_ms"],
                pool_bytes=st["graph_pool_bytes"])


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
        from paddle_tpu_torch.core.cuda_graph import Graph, pool_bytes
        from paddle_tpu_torch.distributed import spmd
        from paddle_tpu_torch.inference import wire_spec
        from paddle_tpu_torch.inference.batching import BatchingEngine
        from paddle_tpu_torch.inference.decode import DecodeEngine, seq_bucket
        from paddle_tpu_torch.inference.server import PredictorServer
        from paddle_tpu_torch.ops import flash_attention as fa
        from paddle_tpu_torch.text import generation
        from paddle_tpu_torch.text.models import BertForPretraining, BertModel, LlamaModel
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
    length_cases = phase_length_kernels(torch, fa)
    bwd_cases = phase_bwd_kernels(torch, fa)
    phase_dropout_placement(torch, fa)
    serving_launches = phase_serving(torch, fa, (BertModel, BatchingEngine, PredictorServer,
                                                 wire_spec))
    train = phase_training(torch, fa, (BertForPretraining, nn, optimizer, spmd, prandom),
                           card)
    gen = phase_generation(torch, fa, (LlamaModel, generation, prandom, Graph, pool_bytes),
                           card)
    eng = phase_engine(torch, fa, (LlamaModel, generation, DecodeEngine, seq_bucket,
                                   PredictorServer, wire_spec), card, gen)

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
    # K1 at Llama-2-7B's two forms, bfloat16: the prefill (prefix form) and a
    # decode step at the mean cache length (length form over the whole
    # cache), with the launches the 7B generate made in each (the step's
    # credited by the replays)
    prefill = next(r for r in cases if r["h"] == 32 and r["dtype"] == "bfloat16"
                   and r["sq"] == GEN_PROMPT)
    # K1's length form at the decode engine's two shapes, bfloat16, with the
    # launches phase 7's run made in each (32 per prefill, 32 per step)
    decode, eng_step, eng_prefill = (
        next(r for r in length_cases if r["dtype"] == "bfloat16" and r["name"] == name)
        for name in ("llama_decode", "engine_step", "engine_prefill"))

    def timing(r, suffix=""):
        # ms: CUDA events over back-to-back calls; device_ms: the kernels'
        # own durations from the profiler (what the table in PERF.md uses)
        return dict(ms=r["ms" + suffix], device_ms=r["device_ms" + suffix],
                    plain_ms=r["plain_ms"], plain_device_ms=r["plain_device_ms"],
                    library_ms=r["library_ms"], library_device_ms=r["library_device_ms"])

    def fields(r, prefix, **more):
        # one K1 case's fields under a prefix
        return {prefix + k: v for k, v in dict(
            **more, max_abs_err=r["max_abs_err"], **timing(r), bound_ms=r["bound_ms"],
            bound_by=r["bound_by"]).items()}

    def bwd(r, which, prefix=""):
        # K2 ("dq") or K3 ("dkv") fields of one backward case
        return {prefix + k: v for k, v in dict(
            max_abs_err=r["abs_err_" + which], **timing(r, "_" + which),
            bound_ms=r["bound_" + which][0], bound_by=r["bound_" + which][1]).items()}

    line = [
        dict(name=kernels[0]["name"], route="cuda", source=kernels[0]["source"],
             replaces=kernels[0]["replaces"],
             launches=(serving_launches + train["counts"]["fwd"] + gen["launches"]
                       + eng["launches"]),
             max_abs_err=main["max_abs_err"], **timing(main), bound_ms=main["bound_ms"],
             bound_by=main["bound_by"],
             # K1 at the training shape, [64 * 12, 128, 64] bfloat16
             **fields(train_fwd, "train_bf16_"),
             **fields(prefill, "llama_prefill_bf16_", launches=gen["prefill_launches"]),
             **fields(decode, "llama_decode_bf16_", launches=gen["decode_launches"]),
             **fields(eng_step, "engine_step_bf16_", launches=eng["step_launches"],
                      same_bits_wider=eng_step["same_bits_wider"],
                      same_bits_other_lengths=eng_step["same_bits_other_lengths"]),
             **fields(eng_prefill, "engine_prefill_bf16_", launches=eng["prefill_launches"])),
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
