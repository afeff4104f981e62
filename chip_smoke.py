#!/usr/bin/env python3
"""chip_smoke.py: drive the PyTorch/CUDA port (paddle_tpu_torch) on one
NVIDIA card and check it.

    python3 chip_smoke.py

Phases, each fatal on failure (exit code 1):
  1. card     refuse to run without CUDA; print the card's name and power
              limit as nvidia-smi reports them
  2. build    build every CUDA kernel of the main path from the sources in
              this checkout (one nvcc per source, started together)
  3. kernels  hold each kernel against its plain PyTorch version on the
              card at the shapes the main path gives it; time kernel, plain
              version and the nearest single PyTorch call (a yardstick only:
              the port never calls it)
  4. serving  full-width BERT-base (random weights from a seed, float32)
              behind PredictorServer + BatchingEngine on localhost: 1-, 2-
              and 3-row requests at seq 128 and 512, then a burst of 8
              concurrent 1-row clients at seq 512. Every reply is held
              against the same weights run on the CPU through the plain
              versions; the kernel launch counts must equal 12 per fired
              batch (one per encoder layer)
  5. summary  a {"kernels": [...]} line, then as the last line
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
def phase_build(cuda_build, fa, kernels):
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
    log("[build] flash_attention_fwd dynamic shared memory per block: "
        + ", ".join(f"head_dim {d}: {fa.smem_bytes(d)} bytes" for d in fa.HEAD_DIMS))


# ------------------------------------------------------------------ phase 3
def attention_bound_ms(bh, sq, sk, d, dtype, causal):
    """Least time for one flash forward: bytes (q, k, v read once, O and LSE
    written once) over HBM rate vs operations over the dtype's peak. Causal
    work counts only the unmasked (row, col) pairs these shapes have."""
    elem = 2 if dtype == "bfloat16" else 4
    nbytes = bh * ((sq + 2 * sk) * d * elem + sq * d * elem + sq * 4)
    if causal:
        off = sk - sq
        pairs = sum(max(0, min(sk, r + off + 1)) for r in range(sq))
    else:
        pairs = sq * sk
    ops = 4 * bh * pairs * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_kernels(torch, fa):
    """K1 against mha_reference at the shapes BERT-base serving gives it
    ([batch*12, seq, 64], float32 and bfloat16) and at the other forms the
    kernel takes (causal, cross lengths, dropout, head_dim 128)."""
    F = torch.nn.functional
    cases = []
    for b in (1, 8):
        for s in (128, 512):
            for dt in ("float32", "bfloat16"):
                cases.append(dict(b=b, h=12, sq=s, sk=s, d=64, dtype=dt, causal=False,
                                  p=0.0))
    cases += [
        dict(b=2, h=12, sq=512, sk=512, d=64, dtype="float32", causal=True, p=0.0),
        dict(b=2, h=12, sq=200, sk=512, d=64, dtype="float32", causal=True, p=0.0),
        dict(b=2, h=12, sq=512, sk=200, d=64, dtype="float32", causal=True, p=0.0),
        dict(b=2, h=12, sq=384, sk=384, d=64, dtype="float32", causal=False, p=0.1),
        dict(b=2, h=8, sq=512, sk=512, d=128, dtype="float32", causal=True, p=0.0),
        dict(b=2, h=8, sq=512, sk=512, d=128, dtype="bfloat16", causal=False, p=0.0),
    ]
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = []
    log("[kernels] flash_attention_fwd vs mha_reference "
        f"(tolerance O {TOL_O['float32']} f32 / {TOL_O['bfloat16']} bf16, LSE {TOL_LSE})")
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
        ms = cuda_ms(torch, lambda: fa._fwd(*args))
        plain_ms = cuda_ms(torch, lambda: fa.mha_reference(*args), iters=5)
        library_ms = None
        if c["p"] == 0.0 and (not c["causal"] or c["sq"] == c["sk"]):
            # one PyTorch call computing the same O (it returns no LSE)
            q4, k4, v4 = (x.view(c["b"], c["h"], -1, c["d"]) for x in (q, k, v))
            library_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                q4, k4, v4, is_causal=c["causal"], scale=scale))
        bound, bound_by = attention_bound_ms(bh, c["sq"], c["sk"], c["d"], c["dtype"],
                                             c["causal"])
        ok = err_o <= TOL_O[c["dtype"]] and err_lse <= TOL_LSE
        r = dict(c, max_abs_err=err_o, max_lse_err=err_lse, ms=ms, plain_ms=plain_ms,
                 library_ms=library_ms, bound_ms=bound, bound_by=bound_by, ok=ok)
        results.append(r)
        lib = "null" if library_ms is None else f"{library_ms:.4f}"
        log(f"  b={c['b']} h={c['h']} sq={c['sq']} sk={c['sk']} d={c['d']} "
            f"{c['dtype']} causal={c['causal']} p={c['p']}: O err {err_o:.3e} "
            f"LSE err {err_lse:.3e} | kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
            f"library {lib} ms bound {bound:.4f} ms ({bound_by}) "
            f"{'ok' if ok else 'DISAGREES'}")
    bad = [r for r in results if not r["ok"]]
    if bad:
        fail(f"flash_attention_fwd disagrees with mha_reference in {len(bad)} case(s)")
    return results


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


def profile_forward(torch, run, ids):
    """Where a served batch's device time goes: one forward traced with
    torch.profiler (kernel device time by name) beside its CUDA-event time."""
    from torch.profiler import ProfilerActivity, profile

    fwd_ms = cuda_ms(torch, lambda: run(ids), iters=5, warmup=1)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run(ids)
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
    log(f"[profile] forward of {ids.shape[0]} x {ids.shape[1]}: {fwd_ms:.3f} ms "
        f"(CUDA events); kernels {busy:.3f} ms in the traced forward"
        + ("" if kernels else " (the profiler saw no device time: not measured)"))
    for t, n, name in sorted(kernels, reverse=True)[:8]:
        log(f"    {t:8.3f} ms {100 * t / busy:5.1f}% x{n:<4d} {name[:90]}")


# ------------------------------------------------------------------ main
def main():
    try:
        import torch
    except ImportError as e:
        fail(f"torch is not importable: {e}")
    card = phase_card(torch)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from paddle_tpu_torch.core import cuda_build
        from paddle_tpu_torch.inference import wire_spec
        from paddle_tpu_torch.inference.batching import BatchingEngine
        from paddle_tpu_torch.inference.server import PredictorServer
        from paddle_tpu_torch.ops import flash_attention as fa
        from paddle_tpu_torch.text.models import BertModel
    except ImportError as e:
        fail(f"the port is not importable from this directory: {e}")

    kernels = [dict(name="flash_attention_fwd", lib="flash_attention_fwd", route="cuda",
                    source="paddle_tpu_torch/csrc/flash_attention_fwd.cu",
                    replaces="paddle_tpu/ops/pallas/flash_attention.py:208")]
    phase_build(cuda_build, fa, kernels)
    cases = phase_kernels(torch, fa)
    launches = phase_serving(torch, fa, (BertModel, BatchingEngine, PredictorServer,
                                         wire_spec))

    # the kernel line reads the largest shape BERT-base serving gives K1:
    # a full batch of 8 at seq 512, float32
    main = next(r for r in cases if r["b"] == 8 and r["sq"] == 512
                and r["dtype"] == "float32")
    line = [dict(name=k["name"], route=k["route"], source=k["source"],
                 replaces=k["replaces"], launches=launches,
                 max_abs_err=main["max_abs_err"], ms=main["ms"],
                 plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
                 bound_by=main["bound_by"], library_ms=main["library_ms"])
            for k in kernels]
    log(card)
    log(json.dumps({"kernels": line}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
