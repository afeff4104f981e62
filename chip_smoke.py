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
              flash_attention_bwd_dkv, and wq_matmul (quant_matmul, the
              weight-only dequantizing product of quantized serving)
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
              decode engine's step and llama_generate's step, whose rows
              keep their bits at twice the pool's width
              and beside other lengths; K1's chunk form (the engine's
              fill: 64 queries of head_dim 128 over 32 heads, causal over
              the first 64 or 128 rows of a longer staging buffer, read
              in place), whose rows keep their bits when the operand is 64
              rows wider; the training forms of phases 13 and 14
              (TRAIN_FORMS: causal head_dim 128 at seq 2048, and 48 or 64
              queries over 64 keys with dropout 0.1), K1, K2 and K3; the
              dropout placement at Sq != Sk too
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
              launches; (d) prefill ms; the decode loop eager (its first
              31 steps only, to keep the script inside its time) and
              graphed (all 126 replays), tokens/s over each whole window
              beside the two-term bound, median step, capture ms and the
              graph pool's bytes; one replay profiled (32 K1 records, the
              idle share)
  7. engine   the continuous-batching decode engine, filling each prompt
              in one chunk of 128 (its traffic shares no prefix, and a
              fill costs about the same at any chunk up to 128, so the
              fewest fills win; `--fill-sweep`): (e) full width,
              depth 2, float32, the same 4 requests through the engine on
              the card and on the CPU (tokens equal, or a near-tie of the
              CPU's logits), then phase 8's (a); then Llama-2-7B bf16 at full width and depth
              (weights drawn on the card), 16 slots x 256 positions, behind
              PredictorServer on localhost: 24 streams (16 at once, 8 more
              as the first retire; prompts 16-128, 16-96 new tokens, seeded),
              one client hanging up after its 4th chunk, one with a 1 ms
              per-token budget, one one-shot. It fails unless (a) every
              stream is well formed with exactly its tokens, the 1 ms one
              ends in status 2 and every slot is free after; (b) four
              sequences decoded again alone give the same tokens, bitwise;
              (c) every token lies within 3e-2 of the row's max |logit| of
              the top logit of a full forward; (d) K1 ran 32 x (fill
              replays + steps) times, credited by as many graph replays,
              and warmup captured each program once. Then tokens/s over the
              whole window beside the two-term bound, time to the first
              token, one replayed engine step profiled; then the first
              12 streams (8 at once, 4 as they retire; half, to keep the
              script inside its time) and the extras through the same
              engine run eagerly (cuda_graph=False), whose tokens must
              equal the graphed window's bitwise
  8. reuse    the engine's KV reuse and resume: (a) depth 2, float32,
              prompts sharing a 32-token prefix, the later ones cache hits,
              through the engine on the card and on the CPU (tokens equal,
              or a near-tie of the CPU's logits); then with phase 7's
              Llama-2-7B weights, two engines of phase 7's configuration
              but for a chunk and page of 64 (the largest at which a
              96-token prefix can hit), behind PredictorServer on
              localhost, one with the prefix cache (a 1 GiB page budget,
              which holds the shared prefix's entries) and one without:
              (b) 24 seeded streams sharing a 96-token system prompt
              (8-32-token suffixes, 16-64 new tokens) through each; it
              fails unless every stream's tokens are bitwise equal across
              the two, at least 23 streams hit,
              K1 ran 32 x (fill replays + steps) and each program was
              captured once; tokens/s over each window, first-token
              medians (in the windows, and alone on an idle engine, hit
              and cold), fill replays per joiner, one fill replay profiled;
              (c) 4 streams with snapshot cadence 32 (0x5C bits 32-47):
              every snapshot frame decodes; each stream's middle snapshot
              is put (cmd 9, status 0) and resumed (cmd 10) on the other
              engine, streamed (the suffix bitwise the unbroken stream's)
              and one-shot (the whole sequence); a handoff (bit 62) gives
              one snapshot frame and the first token, and its resume the
              rest, bitwise; snapshots with a skewed weights digest,
              fingerprint or position answer status 2 and no token.
              Snapshot bytes, the scheduler's copy ms and the consumer's
              build ms, resume-to-first-token ms and the weights digest's
              ms are printed
  9. spec     speculative decoding (spec_k 4) in engines of phase 7's
              configuration (no prefix cache) over phase 7's Llama-2-7B
              weights, behind PredictorServer on localhost, with two
              drafts: (a) a self-draft (llama_decode_model over the same
              model: its own pools and programs, the target's functions at
              the target's M, so every proposal must be the target's greedy
              token) and (b) a layer-skip draft (the target's first 2
              decoder layers, its embedding, norm and head, shared). Each
              engine is warmed up (fill, step, verify, draft step, draft
              fill captured once), then serves 24 seeded streams (prompts
              16-128, 16-64 new) three times: plain, opted (0x5C bit 61)
              and mixed (every other stream opted, so bursts share verify
              replays with plain rows). It fails unless every opted and
              mixed stream equals its plain stream bitwise, both opted
              windows took bursts and verify replays, the self-draft had
              no proposal rejected (acceptance exactly 1.0), K1 ran
              32 x (fills + steps + 4 x verify replays) + draft layers x
              (draft fills + draft steps) times in every window, no
              program failed and every breaker stayed closed untripped,
              and each program was captured once. Printed: tokens/s of
              each window, acceptance, a verify replay's device ms against
              4 step replays fed the same columns, a draft step's device
              ms for each draft, capture ms and the graph pool's bytes
              before and after the speculative programs, one verify
              replay profiled (128 K1 records, the idle share)
 10. robust   the serving engines' watchdog, restarts, chaos sites and
              telemetry: an engine of phase 7's configuration over its
              Llama-2-7B weights (watchdog every 0.05 s, wedge timeout
              2 s) behind PredictorServer serves 24 seeded streams at once
              (16 fill the slots, 8 wait in its queue) unbroken, then (a)
              with serving.decode.loop armed to raise once 16 rows run and
              (b) with serving.decode.step armed to sleep 3 s: it fails
              unless every stream in flight ends with status 2 and a prefix
              of its unbroken tokens, the 8 queued ones and the 16 retried
              are bitwise the unbroken run's, each fault makes one restart,
              the wedged thread ends at its next call (stale_unwinds) without
              a replay, no program is captured again, no breaker trips, no
              slot leaks and K1 ran 32 x (fill replays + steps); (c) phase
              7-style traffic with stream 0 traced (0x1D), scraped by cmd 6
              and by a MetricsServer: the decode, batching and server
              families present in both, no series from two collectors,
              paddle_decode_tokens_total and the TTFT count moved by the
              tokens streamed and the sequences served, the step timer's
              mean within 25% of the window's CUDA-event median step
              replay, one serving.decode.token span per token under the
              traced id and none for the others (printed: the fill timer's
              mean, tokens/s beside phase 7's); (d) phase 4's BERT-base
              behind a BatchingEngine: its scheduler killed holding one
              request, the two queued behind it and the retried one
              bitwise their replies before the fault; bucket 4 failed to
              its breaker's threshold (2) answers status 1, 1, then 2
              (quarantined) while bucket 2 serves; K1 = 12 x batches
 11. quant    quantized serving: (a) wq_matmul against its plain version
              (dequantize, then matmul; 1e-4 of the output's max) at every
              (M, K, N) of Llama-2-7B's path (M 16 and 128; K x N 4096 x
              4096, 4096 x 11008, 11008 x 4096, 4096 x 32000), int8 with
              per-column scales and bf16 weights, a row's bits the same at M
              = 1, 16, 37 and 128, timed beside the plain version,
              torch.matmul over the f32 weight (the library yardstick), its
              bound (an f32-accurate product: the three bf16 tensor-core
              passes vs the bytes) and the f32 CUDA cores' bound beside it;
              the kernel's shared memory and each shape's split count;
              (b) Llama-2-7B in float32 (weights from seed 0, 27 GB; phase
              10's bf16 weights freed first), engines of phase 7's
              configuration under quant f32, then w8, then bf16w, one at a
              time, each behind PredictorServer serving phase 7's 24 streams
              and extras: streams whole, 3 re-decoded alone bitwise, each
              program captured once, no breaker tripped, the mode on
              stats()["quant"] and the compiles' quant label, K1 = 32 x
              (fill replays + steps), wq_matmul = 225 x step replays + 224 x
              fill replays (0 under f32); the last prompt token's logits of
              4 prompts under w8 and bf16w within ACCURACY_BOUNDS[mode]
              (max|d| / max|f32|) of the f32 model's; a w8 snapshot (a
              handoff) refused with status 2 by an f32 and the bf16w
              engine. Printed per mode: tokens/s over the window, the median
              step and fill replay (CUDA events), a profiled step replay's
              kernel time and idle share, weight_bytes, the weights
              digest's ms. (c) phase 4's BERT-base converted in place by
              quantize_weights (73 Int8Linear) answers phase 4's requests
              through the BatchingEngine, its sequence output within
              ACCURACY_BOUNDS["w8"] of phase 4's f32 replies and its pooled
              output within the reference's documented w8 bound for its
              depth (2 x 13 / 127), both within TOL_WQ of the same
              requests through the same model with wq_matmul's plain
              version in its place, wq_matmul 73 x batches, K1 12 x batches
 12. translation  Transformer-base (nn.Transformer's defaults: 6 + 6
              layers, d_model 512, 8 heads, FFN 2048; float32, weights from
              seed 0) with a 37,000-token embedding tied to the output
              projection and sinusoidal positions, translating by
              BeamSearchDecoder + dynamic_decode (beam 4, at most source +
              50 steps) through TranslationCell, whose states are the
              decoder's per-layer MHA caches as tuples of tensors: (a) 2
              sentences of 64 seeded tokens, the card's beams (tokens and
              parents of every step) equal to the same weights' CPU run,
              each sentence whole or up to a step where the CPU's beam-th
              and beam+1-th candidates are within 1e-4, final scores within
              1e-4 relative; (b) sentence 0's best beam decoded step by step
              through the caches (K1 at one query) against one
              teacher-forced forward under the causal mask (the masked
              path), within 1e-4 of each row's max |logit|; (c) K1 launched
              6 (the encoder) + 12 x steps; (d) 4 padded sentences of 40-64
              tokens under src_mask/memory_mask: K1 only in the decoder's
              self-attention, 6 x steps; (e) 16 sentences x 64 tokens:
              sentences/s, generated tokens/s, the encoder's ms, the steps'
              ms (CUDA events as each step starts) beside their least time
              (weights, caches read, the concat and the reorder's copies),
              the decode profiled by kernel group (K1, products, concat,
              reorder, selection) and its idle share
 13. lm training  Llama-374M pretraining at bench.py's shape (run_llama:
              LLAMA_374M = vocab 32000, hidden 1024, 24 layers, 8 heads of
              128, FFN 2816; seq 2048, batch 8, O1 bf16, AdamW(3e-4, weight
              decay 0.1, ClipGradByGlobalNorm(1.0)), the mean NLL of seeded
              random labels; weights from seed 0) through build_train_step,
              the causal attention through K1 forward and K2/K3 backward at
              [64, 2048, 128]: (a) full width at depth 2, one O0 float32
              step of batch 1 on the card and on the CPU from the same
              weights, batch and key, held to phase 5's bounds; (b) 3
              warm-up and 20 O1 steps at batch 8 on one batch, the loss
              finite and falling; (c) K1, K2 and K3 each launched 24 times
              a step; (d) one recompute=True step against the plain step
              on (b)'s state: the loss bitwise equal, the gradients within
              1e-5 of their max, K1 twice a layer, each step's peak memory;
              (e) one O1 step profiled (kernels by group, the idle share).
              Printed: the step's ms (median of the timed steps 2-20),
              tokens/s, the share of the dense bf16 peak by bench.py's
              FLOP count, peak memory
 14. mt training  Transformer-base (phase 12's model, translation_model)
              trained on the paper's recipe: teacher forcing, label
              smoothing 0.1 (label_smooth over one_hot, soft-label cross
              entropy), Adam(0.9, 0.98, 1e-9) under NoamDecay(512, 4000)
              started at its peak (last_epoch 3999), dropout 0.1
              everywhere, attention included: (a) one O0 float32 step of 4
              pairs on the card and on the CPU, held to phase 5's bounds;
              (b) 20 O1 steps of 64 pairs of 64 source and 48 target
              tokens, the scheduler stepped after each, the loss finite and
              falling and every step's rate NoamDecay's; (c) K1, K2 and K3
              each launched 12 times a step (the encoder's self-attention
              at [512, 64, 64] and the cross-attention at [512, 48, 64
              keys, 64], with dropout; the decoder's masked self-attention
              takes the plain softmax); (d) one O1 step profiled. Printed:
              step ms, source + target tokens/s, peak memory
 15. dygraph  BERT-base pretraining in dygraph through the eager Tensor
              API, written as a Paddle user writes it (import
              paddle_tpu_torch as paddle; set_device("gpu"), to_tensor,
              amp.auto_cast, loss.backward(), opt.step(), opt.clear_grad(),
              loss.numpy()), phase 5's model, loss, AdamW and batches: (a)
              one O0 float32 step at depth 2, batch 4, dropout 0.1, on the
              card and on the CPU from the same weights and seed, held to
              phase 5's bounds; (b) the same step with dropout 0 against
              phase 5's build_train_step from the same weights and batch,
              held to the same bounds, whether bitwise printed; (c) 20 O1
              bf16 steps at full depth on phase 5's batch of 64 x 128 with
              dropout 0.1, the loss finite and falling, K1, K2 and K3 each
              launched 12 times a step (the counters and form_launches);
              printed the step ms (median of steps 2-20), tokens/s, phase
              5's build_train_step step ms of this run beside it, one step
              profiled (kernel groups, kernel count, idle share); (d) under
              paddle.no_grad(), phase 4's serving batch ([8, 512], float32)
              through model(paddle.to_tensor(ids)), bitwise phase 4's direct
              call; (e) every paddle.* op case of tests/test_torch_api_cases.py
              on the card against the CPU (dtypes equal; integer, bool,
              index, creation and manipulation results bitwise; float results
              at the CPU tests' tolerances), one double grad and one PyLayer
              backward within 1e-5 of their max
 16. vision   the layer zoo's conv path (conv, BatchNorm, pooling: cuDNN
              and ATen kernels, none of the port's own; K1-K3 and wq_matmul
              are not on it): (a) bench.py's smoke model, resnet18(10
              classes) at 32 x 32, batch 4, Momentum(0.1, 0.9, weight decay
              1e-4): one O0 float32 build_train_step step on the card and on
              the CPU from the same weights, held to phase 5's bounds (each
              velocity, the gradient plus the decay, within 1e-3 of its
              max), the BatchNorm running statistics within 1e-4 of their
              max and an eval() forward after the step within 1e-3; (b)
              bench.py's run_resnet50: ResNet-50 at 224 x 224, 1000
              classes, O1 bf16 through build_train_step with bench.py's
              loss, random images and labels from RandomState(0), the batch
              found as bench.py finds it (512, then down its candidates on
              an out-of-memory error), 3 warmup and 20 timed steps, the loss
              finite; printed: the batch, images/s, the median step, the
              share of the dense bf16 peak (3 x the forward's conv and
              linear FLOPs), peak memory, one step profiled (kernels, idle
              share, kernel time by group, the update's span); (c) the same
              step in dygraph (to_tensor, amp.auto_cast, loss.backward(),
              opt.step(), opt.clear_grad()) at (b)'s batch for 10 steps,
              its median step beside (b)'s, and one O0 dygraph step at (a)'s
              size held to (a)'s bounds against (a)'s build_train_step step
              on the card; (d) eval() float32 forwards, card vs CPU within
              1e-3 of the max: LeNet at 28 x 28 batch 4, mobilenet_v2 and
              vgg11 at 224 x 224 batch 2
 17. data     the data path and the high-level API, after phase 16 and at
              its batch (none of the port's kernels but wq_matmul, once,
              in (d)(iii)'s classifier): (a) BASELINE config 1, LeNet
              through paddle.Model (Adam 1e-3, CrossEntropyLoss, Accuracy),
              fit one epoch of the synthetic MNIST train split (8,192
              images) at batch 64, shuffled from numpy seed 0, 2 workers, on
              the card and on the CPU from the same weights: the batches
              bitwise equal (a digest of each), the first 20 step losses
              within 1e-4 relative, evaluate's acc on the test split > 0.9
              on both; printed the ms a step and the share of the loop
              waiting in next(loader); (b) on (a)'s model: paddle.save then
              paddle.load of its state dict bitwise; Model.save into a fresh
              Model's load: evaluate equal and Adam's accumulators bitwise;
              fit(save_dir, epochs=2) against a fit stopped by SIGTERM
              (resilience.chaos) at step 10 of epoch 2 and then
              fit(resume=True) (each epoch's order from its own numpy seed):
              the marker written and then cleared, no final snapshot after
              the stop, every parameter within 1e-6 of its max of the
              uninterrupted run (bitwise printed; cuDNN is not bitwise run
              to run, the CPU test holds it bitwise); (c) phase 16 (b)'s
              ResNet-50 O1 step fed by paddle.io.DataLoader: 2,048 uint8
              224 x 224 x 3 images from RandomState(0) (index modulo 2,048,
              23 batches long), RandomHorizontalFlip + Normalize (ImageNet's
              mean and std) in min(8, cores) workers, shuffle, drop_last,
              prefetch_factor 2; 3 + 20 steps, the loss finite, the first
              batch bitwise a single-process loader's and on the card;
              printed images/s and the median step beside phase 16 (b)'s,
              the share of the window waiting in next(loader), the bytes
              of a batch; (d)(i) ImperativeQuantAware().quantize(LeNet()):
              one float32 step card vs CPU at phase 5's bounds, its
              act_scale buffers within 1e-6 relative, then Model.fit one
              epoch of (a)'s data, acc > 0.9; (ii) quantize(resnet50()) O1
              through build_train_step, 3 + 10 steps on two batches in
              turn at the first of bench.py's candidates (from phase 16's
              batch down) that fits: the loss finite, every act_scale
              (halved before the timed steps) written by them, images/s
              printed;
              (iii) quantize_weights(resnet50()): every conv an Int8Conv2D
              and the classifier an Int8Linear, an eval() float32 forward
              at batch 8 card vs CPU within 1e-3 of the max; printed the
              gap to the float model's logits (no bound: random weights)
              and weight_bytes against the float model's
 18. summary  a {"kernels": [...]} line, then as the last line
              {"ok": true, "device": {"platform": "gpu", ...}}

Each phase's seconds are printed as "[time]" lines.

    python3 chip_smoke.py --fill-sweep 32,64,128

instead builds the kernels and measures the 7B engine at each fill chunk
(fill_chunk_sweep): the numbers the chunks above were chosen by.

It imports nothing of JAX or the JAX package. Run from a directory that
holds only this file it fails at the import of paddle_tpu_torch.
"""
import copy
import gc
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
        if "smem" in k:  # a kernel of its own module
            log(f"[build] {k['lib']} dynamic shared memory per block: {k['smem']()}")
            continue
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
        if "CUDA" not in str(getattr(ev, "device_type", "")) or ev.key in ANNOTATIONS:
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


# the forms Transformer-base's translation (phase 12) gives K1, float32 on
# its path: a decode step's single query over the self-attention cache
# (1..114 rows after the concat) and the cross-attention's static cache (64
# source rows), 16 sentences x beam 4 x 8 heads of 64; and the encoder's
# self-attention over 16 sentences of 64 tokens
TRANSLATION_FORMS = [dict(b=64, h=8, sq=1, sk=sk, d=64, causal=False, p=0.0)
                     for sk in (1, 37, 64, 114)] + [
    dict(b=16, h=8, sq=64, sk=64, d=64, causal=False, p=0.0)]


# the training forms of this slice, each in float32 and bfloat16 (the main
# paths run the first form's bf16 under O1 and the O0 parity steps' f32):
# Llama-374M pretraining (phase 13), 8 heads of head_dim 128 at seq 2048,
# causal, at batch 8 and at the parity step's batch 1; Transformer-base
# training (phase 14) at 64 pairs x 8 heads of 64 with attention dropout
# 0.1, the encoder's self-attention over 64 source tokens and the
# cross-attention from 48 target tokens to them (Sq != Sk)
LM_TRAIN_FORMS = [dict(b=b, h=8, sq=2048, sk=2048, d=128, causal=True, p=0.0)
                  for b in (8, 1)]
MT_TRAIN_FORMS = [dict(b=64, h=8, sq=sq, sk=64, d=64, causal=False, p=0.1)
                  for sq in (64, 48)]
TRAIN_FORMS = LM_TRAIN_FORMS + MT_TRAIN_FORMS


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
    rows, ragged tiles, dropout, head_dim 128, single-query decode, Llama's
    prefill, translation's TRANSLATION_FORMS, the training paths'
    TRAIN_FORMS), each in both dtypes. The library yardstick is one scaled_dot_product_attention
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
    forms += LLAMA_FORMS + TRANSLATION_FORMS + TRAIN_FORMS
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
# each over its own slot of a 256-row pool at a seeded length in 1..256
# (the engine's prompts take the chunk form, CHUNK_FORMS); and
# llama_generate's (phase 6) step, 16 rows over the whole 256-row cache at
# one length, 192 (the mean of the steps' 129..255)
LENGTH_FORMS = [
    dict(name="engine_step", b=16, h=32, sq=1, sk=256, d=128, causal=True, lens=None),
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


# K1's chunk form, the decode engine's fill: one chunk of C queries of a
# joiner over 32 heads of head_dim 128, causal bottom-right over the first
# start + C rows of the engine's 128-row staging buffer, read in place by
# its head stride. Phase 7's engine fills in one chunk of ENGINE_CHUNK = 128
# (its unrelated prompts gain nothing from a smaller page), phase 8's in
# chunks of REUSE_CHUNK = 64 (the largest that lets its 96-token system
# prompt hit); both chosen from `--fill-sweep 32,64,128` (PERF.md). The
# (C, start + C) pairs the two engines run:
ENGINE_CHUNK, REUSE_CHUNK = 128, 64
CHUNK_FORMS = ((ENGINE_CHUNK, 128), (REUSE_CHUNK, 64), (REUSE_CHUNK, 128))


def phase_chunk_kernels(torch, fa):
    """K1's chunk form at CHUNK_FORMS against mha_reference (float32 and
    bfloat16), over prefix views of a staging buffer C rows longer than
    the engine's (the room for the width check): a row's O and LSE must
    keep their bits when the same query rows, as the first C of 2C, run
    over C more keys. The library yardstick is one
    scaled_dot_product_attention call with a boolean bottom-right causal
    mask (its own is_causal aligns top-left)."""
    F = torch.nn.functional
    gen = torch.Generator(device="cuda").manual_seed(2)
    h, d = 32, 128
    results = []
    log("[kernels] flash_attention_fwd, chunk form (the engine's fill) vs mha_reference "
        f"(tolerance O {TOL_O['float32']} f32 / {TOL_O['bfloat16']} bf16, LSE {TOL_LSE}); "
        "times: CUDA events / device")
    for c, end in CHUNK_FORMS:
        total = ENGINE_PROMPT + c
        for dt in ("float32", "bfloat16"):
            tdt = getattr(torch, dt)
            k, v = (torch.randn(h, total, d, device="cuda", generator=gen).to(tdt)
                    for _ in range(2))
            q2 = torch.randn(h, 2 * c, d, device="cuda", generator=gen).to(tdt)
            q = q2[:, :c].contiguous()
            scale = d ** -0.5
            args = (q, k[:, :end], v[:, :end], 0, scale, True, 0.0)
            o, lse = fa._fwd(*args)
            torch.cuda.synchronize()
            ro, rlse = fa.mha_reference(*args)
            err_o = (o.float() - ro.float()).abs().max().item()
            err_lse = (lse - rlse).abs().max().item()
            wide, wlse = fa._fwd(q2, k[:, :end + c], v[:, :end + c], 0, scale, True, 0.0)
            same = bool(torch.equal(wide[:, :c], o) and torch.equal(wlse[:, :c], lse))
            ms, dev = timed(torch, lambda: fa._fwd(*args))
            plain_ms, plain_dev = timed(torch, lambda: fa.mha_reference(*args), iters=5)
            cols = torch.arange(end, device="cuda")
            mask = cols[None, :] <= torch.arange(c, device="cuda")[:, None] + (end - c)
            q4, k4, v4 = q[None], k[None, :, :end], v[None, :, :end]
            library_ms, library_dev = timed(torch, lambda: F.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=mask, scale=scale))
            bound, bound_by = attention_bound_ms(h, c, end, d, dt, True)
            ok = err_o <= TOL_O[dt] and err_lse <= TOL_LSE and same
            results.append(dict(b=1, h=h, sq=c, sk=end, d=d, dtype=dt, causal=True,
                                max_abs_err=err_o, max_lse_err=err_lse, same_bits_wider=same,
                                ms=ms, device_ms=dev, plain_ms=plain_ms,
                                plain_device_ms=plain_dev, library_ms=library_ms,
                                library_device_ms=library_dev, bound_ms=bound,
                                bound_by=bound_by, ok=ok))
            log(f"  chunk: h={h} sq={c} over rows 0..{end - 1} of a {total}-row buffer d={d} "
                f"{dt} causal: O err {err_o:.3e} LSE err {err_lse:.3e}; same bits {c} rows "
                f"wider: {same} | kernel {ms:.4f} / {_fmt(dev)} ms{_share(bound, dev)}; plain "
                f"{plain_ms:.4f} / {_fmt(plain_dev)} ms; library (sdpa, boolean causal mask) "
                f"{_fmt(library_ms)} / {_fmt(library_dev)} ms; bound {bound:.4f} ms "
                f"({bound_by}) {'ok' if ok else 'DISAGREES'}")
    if any(not r["ok"] for r in results):
        fail("flash_attention_fwd's chunk form disagrees with mha_reference or changes a "
             "row's bits with the operand's width")
    return results


def _rel_err(torch, got, want):
    """max |got - want| over max |want| (the gradient's own scale)."""
    scale = want.float().abs().max().clamp_min(1e-30)
    return ((got.float() - want.float()).abs().max() / scale).item()


def phase_bwd_kernels(torch, fa):
    """K2 and K3 against mha_bwd_reference at the shape BERT-base training
    gives them ([batch 64 * 12 heads, 128, 64], bfloat16 under O1, and
    float32), at the training forms of phases 13 and 14 (TRAIN_FORMS) and
    at the other forms they take, each in both dtypes. The
    library yardstick is one torch.autograd.grad through
    scaled_dot_product_attention (with dropout_p where the case drops; it
    computes dQ, dK and dV together, as does the plain version)."""
    F = torch.nn.functional
    cases = [dict(b=64, h=12, sq=128, sk=128, d=64, dtype=dt, causal=False, p=0.0)
             for dt in ("bfloat16", "float32")]
    cases.append(dict(b=64, h=12, sq=128, sk=128, d=64, dtype="bfloat16", causal=False,
                      p=0.1))
    cases += [dict(f, dtype=dt) for f in FORMS + TRAIN_FORMS
              for dt in ("float32", "bfloat16")]
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
    exactly at the kept (row, col); with dO = I (its first min(sq, d)
    columns) K3's dV is non-zero exactly at the transposed mask there. For
    K2, q = 0, K = V = I, dO = ones, O = 0 (delta = 0) and LSE = log sk
    give P = 1/sk, dS = P * keep / (1 - p) and dQ = scale * dS, non-zero
    exactly where kept. Each head_dim at sq = sk = d, and the
    cross-attention's Sq != Sk form of phase 14 (48 queries over 64 keys,
    d = 64): the hash is indexed by sk there. A tolerance on values alone
    could miss a mask placed one element off."""
    p, seed = 0.3, 2024
    for d, sq in [(d, d) for d in fa.HEAD_DIMS] + [(64, 48)]:
        sk = d
        for dt in (torch.float32, torch.bfloat16):
            bh = 6
            q0 = torch.zeros(bh, sq, d, device="cuda", dtype=dt)
            k0 = torch.zeros(bh, sk, d, device="cuda", dtype=dt)
            eye = torch.eye(d, device="cuda", dtype=dt).expand(bh, d, d).contiguous()
            do_eye = eye[:, :sq].contiguous()
            o, lse = fa._fwd(q0, k0, eye, seed, d ** -0.5, False, p)
            _, _, dv = fa._bwd(q0, k0, eye, o, lse, do_eye, seed, d ** -0.5, False, p)
            ones = torch.ones_like(q0)
            lse_d = torch.full((bh, sq, 1), float(np.log(sk)), device="cuda")
            dq, _, _ = fa._bwd(q0, eye, eye, q0, lse_d, ones, seed, d ** -0.5, False, p)
            torch.cuda.synchronize()
            keep = fa._dropout_keep(seed, bh, torch.arange(sq, device="cuda")[:, None],
                                    torch.arange(sk, device="cuda")[None, :], sk, p)
            o_ok = torch.equal(o != 0, keep)
            dq_ok = torch.equal(dq != 0, keep)
            dv_ok = (torch.equal(dv[:, :, :sq] != 0, keep.transpose(1, 2))
                     and not bool(dv[:, :, sq:].any()))
            kept = keep.float().mean().item()
            log(f"[dropout placement] sq={sq} sk={sk} d={d} {str(dt)[6:]} p={p}: K1 O non-zero "
                f"exactly where kept {o_ok}, K2 dQ exactly where kept {dq_ok}, K3 dV at the "
                f"transposed mask {dv_ok} (kept share {kept:.3f})")
            if not (o_ok and dq_ok and dv_ok):
                fail(f"dropout placement differs from _keep_mask (sq={sq}, sk={sk}, d={d}, "
                     f"{dt})")


# ------------------------------------------------------------------ phase 4
def _recv(s, n):
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = s.recv_into(view[got:], n - got)
        if not k:
            raise ConnectionError("server closed the connection")
        got += k
    return bytes(buf)


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

    # the serving batch (the burst's 8 rows at seq 512) and its direct call,
    # which phase 15 (d) holds the Tensor API's call to
    serving_batch = np.stack([b[0] for b in burst])
    batch_out = tuple(t.cpu().numpy() for t in run(serving_batch))
    profile_forward(torch, run, serving_batch)

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
    return dict(launches=launches, model=model,
                replies=[(ids, outs) for ids, outs, _, _ in sent], batch=serving_batch,
                batch_out=batch_out)


def profile_device(torch, fn, label, top=8, groups=None, records=None, spans=None):
    """Where one call of ``fn`` spends its device time: its CUDA-event time,
    then the same call traced with torch.profiler (kernel device time by
    name, the top 8, and by ``groups``, KERNEL_GROUPS by default). Returns
    (events ms, kernel ms, kernels launched, {group: (ms, kernels)}); each
    kernel's (ms, count, full name) is appended to ``records`` if given,
    and each key of ``spans`` (a record_function's name) gets the device
    time of the kernels launched inside that range (None: not seen)."""
    from torch.profiler import ProfilerActivity, profile

    ms = cuda_ms(torch, fn, iters=1, warmup=0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = []
    for ev in prof.key_averages():
        # a record_function range shows on the device track as well: not a kernel
        if "CUDA" not in str(getattr(ev, "device_type", "")) or ev.key in ANNOTATIONS:
            continue
        t = getattr(ev, "self_device_time_total", None)
        if t is None:
            t = getattr(ev, "self_cuda_time_total", 0.0)
        if t > 0:
            kernels.append((t / 1e3, ev.count, ev.key))
    busy = sum(t for t, _, _ in kernels)
    if records is not None:
        records.extend(kernels)
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
    for name in spans or ():
        ev = next((e for e in prof.key_averages() if e.key == name
                   and "CUDA" not in str(getattr(e, "device_type", ""))), None)
        t = None if ev is None else getattr(ev, "device_time_total",
                                            getattr(ev, "cuda_time_total", 0.0))
        spans[name] = t / 1e3 if t else None
    # what the host spent handing work to the card
    calls = [(ev.key, ev.count, ev.self_cpu_time_total / 1e3) for ev in prof.key_averages()
             if ev.key in ("cudaLaunchKernel", "cuLaunchKernel", "cuLaunchKernelEx",
                           "cudaMemcpyAsync")]
    log("    [host] " + (", ".join(f"{k} x{n} {t:.3f} ms" for k, n, t in calls)
                         or "no launch calls traced") + f"; {launched} kernels on the card")
    return ms, busy, launched, sums


# the port's record_function ranges (distributed/spmd.py): spans, not kernels
ANNOTATIONS = ("build_train_step.update",)
# kernel-name fragments -> the layer of the port that launched them
KERNEL_GROUPS = (
    ("K1 flash_attention_fwd", ("fwd_f32_kernel", "fwd_bf16_kernel")),
    ("K2 flash_attention_bwd_dq", ("dq_f32_kernel", "dq_bf16_kernel")),
    ("K3 flash_attention_bwd_dkv", ("dkv_f32_kernel", "dkv_bf16_kernel")),
    ("GEMMs (cuBLAS/CUTLASS)", ("gemm", "xmma", "cutlass", "sm90_", "sm80_", "nvjet")),
    ("int64 elementwise (counter-hash dropout masks)", ("<long",)),
)
# a decode step's kernels: the cache writes and layout changes apart, and
# the quantized products (phase 11)
DECODE_GROUPS = KERNEL_GROUPS[:1] + (
    ("wq_matmul (w8 / bf16w products)", ("wq_matmul_kernel",)),) + KERNEL_GROUPS[3:4] + (
    ("copies (cache rows, head layouts, RoPE interleave)",
     ("copy", "Copy", "Memcpy", "cat", "Cat")),
)


def profile_forward(torch, run, ids):
    """Where a served batch's device time goes."""
    run(ids)  # warm
    profile_device(torch, lambda: run(ids), f"forward of {ids.shape[0]} x {ids.shape[1]}")


# --------------------------------------------- training: phases 5, 13 and 14
# a gradient that is 0 but for rounding (the key projection's bias:
# softmax ignores a per-row constant) is held to this share of the model's
# largest gradient, as tests/test_torch_seq2seq.py holds it
TOL_ZERO_GRAD = 1e-5
# a ReLU gate that the card's and the CPU's runs set apart is a rounding
# flip when its pre-activation is within this share of the layer's largest
RELU_FLIP = 1e-6


def parity_step(torch, fa, build, model, make_batch, key, lr, label, zero_grads=(),
                record=None, exempt=None):
    """One O0 float32 step of ``build(model)`` on the card and of the same
    weights on the CPU, from the same batch and key, held to phase 5's
    bounds: loss TOL_STEP_LOSS relative, every first moment / (1 - 0.9)
    (the clipped gradients) within TOL_STEP_GRAD of its max, every updated
    parameter within 2.5 * lr. Gradients named by a suffix in
    ``zero_grads`` are held to TOL_ZERO_GRAD of the model's largest
    gradient instead. ``record(model)`` names the modules whose outputs
    both runs keep: ``outputs[device][name]`` lists a module's outputs, one
    per call, and ``outputs[device][name + ".grad"]`` their gradients.
    ``exempt(outputs, the CPU batch)`` returns ({parameter: (index, parts)},
    failures) for the gradient elements that a rounding-level discontinuity
    explains: where ``parts`` is None those elements are left out of the
    gradient check; else ``parts[device]`` is the share of them that the
    discontinuity reaches, taken off each run's gradient at ``index``
    before the check (in the gradient's units: the step must not clip).
    Returns the card's kernel launches (K1, K2, K3) and the card's and the
    CPU's seconds."""
    cpu_model = copy.deepcopy(model).to("cpu")
    res, outputs = {}, {}

    def keep(kept, name, out):
        outs = kept.setdefault(name, [])
        grads = kept.setdefault(name + ".grad", [])
        outs.append(out.detach().cpu())
        grads.append(None)
        if out.requires_grad:
            i = len(grads) - 1
            out.register_hook(lambda g: grads.__setitem__(i, g.detach().cpu()))

    for dev, m in (("cuda", model), ("cpu", cpu_model)):
        kept = outputs[dev] = {}
        hooks = [mod.register_forward_hook(
            lambda mod, args, out, name=name: keep(kept, name, out))
            for name, mod in (record(m) if record else ())]
        step, init = build(m)
        params, state = init()
        x, y = make_batch(dev)
        fa.launches = fa.dq_launches = fa.dkv_launches = 0
        t = time.perf_counter()
        loss, params, state = step(params, state, x, y, key=key)
        loss = float(loss)  # a readback: the step has finished
        secs = time.perf_counter() - t
        counts = (fa.launches, fa.dq_launches, fa.dkv_launches)
        for h in hooks:
            h.remove()
        res[dev] = (loss, {n: (st[0] / (1 - 0.9)).cpu() for n, st in state.items()},
                    {n: p.cpu() for n, p in params.items()}, secs, counts)
        del step, init, params, state
    (gl, gg, gp, gs, counts), (cl, cg, cp, cs, _) = res["cuda"], res["cpu"]
    skip, bad = exempt(outputs, x) if exempt else ({}, [])
    loss_err = abs(gl - cl) / abs(cl)
    model_max = max(g.abs().max().item() for g in cg.values())
    grad_err = {}
    for n in cg:
        a, b = gg[n].clone(), cg[n].clone()
        if n in skip:
            index, parts = skip[n]
            if parts is None:
                a[index] = b[index] = 0.0
            else:
                a[index] -= parts["cuda"]
                b[index] -= parts["cpu"]
        scale = model_max if n.endswith(tuple(zero_grads)) else b.abs().max().item()
        tol = TOL_ZERO_GRAD if n.endswith(tuple(zero_grads)) else TOL_STEP_GRAD
        grad_err[n] = ((a - b).abs().max().item() / max(scale, 1e-30), tol)
    worst = max(grad_err, key=lambda n: grad_err[n][0] / grad_err[n][1])
    param_err = max((gp[n] - cp[n]).abs().max().item() for n in cp)
    log(f"[{label}] (a) O0 parity step: loss card {gl:.6f} cpu {cl:.6f} (rel err "
        f"{loss_err:.2e}, tolerance {TOL_STEP_LOSS}); clipped gradients of {len(cg)} tensors, "
        f"worst {grad_err[worst][0]:.2e} ({worst}; tolerance {grad_err[worst][1]} of its "
        f"{'model' if grad_err[worst][1] == TOL_ZERO_GRAD else 'own'} max); updated "
        f"parameters max abs err {param_err:.3e} (tolerance 2.5 lr = {2.5 * lr:.2e}); card "
        f"{gs:.2f} s, cpu {cs:.2f} s (first step, allocation included); launches K1/K2/K3 "
        f"{counts}")
    bad += [] if loss_err <= TOL_STEP_LOSS and np.isfinite(gl) else ["loss"]
    bad += [f"grad {n}" for n, (e, tol) in grad_err.items() if not e <= tol]
    bad += [] if param_err <= 2.5 * lr else ["updated parameters"]
    if bad:
        fail(f"{label} (a): the card's O0 step disagrees with the CPU's: {', '.join(bad)}")
    return counts, gs, cs


def ffn_and_embedding(m):
    """What ``relu_flip_exemption`` reads from a translation_model's runs:
    each FFN's pre-activation (``linear1``) and the embedding's lookups."""
    return [(n, mod) for n, mod in m.named_modules() if n.endswith(".linear1")] + [
        ("embed", m.embed)]


def relu_flip_exemption(torch, model, label):
    """``parity_step``'s ``exempt`` for a translation_model (recorded by
    ``ffn_and_embedding``). The FFN's ReLU is not smooth: where the two
    runs' roundings put a pre-activation of ~1e-7 on either side of 0, the
    gate passes its gradient on one run only. Such a flip is exempt when it
    is at the rounding's scale (RELU_FLIP of the layer's largest): the
    unit's column of linear1's weight gradient and its bias are left out,
    and so is the lookup side of the tied embedding's rows of the tokens
    at the flipped positions (their input gradient passes through the gate
    undiluted): each run's lookup gradient there, its embedding outputs'
    gradients summed by token, is taken off its own gradient, so the
    output projection's share of those rows is still held to the bound."""
    vocab, d_model = model.embed.weight.shape

    def exempt(outputs, x):
        skip, bad, found = {}, [], []
        rows = []
        for name, outs in outputs["cpu"].items():
            if not name.endswith(".linear1"):
                continue
            (h_cpu,), (h_card,) = outs, outputs["cuda"][name]
            flip = (h_card > 0) != (h_cpu > 0)
            if not flip.any():
                continue
            size = (torch.maximum(h_card.abs(), h_cpu.abs())[flip].max()
                    / h_cpu.abs().max()).item()
            b, t, u = flip.nonzero(as_tuple=True)
            units = sorted(set(u.tolist()))
            found.append(f"{name} units {units} at |h| {size:.1e} of its max")
            if size > RELU_FLIP:
                bad.append(f"ReLU gates of {name} set apart at |h| {size:.1e} of its max")
            skip[name + ".weight"] = ((slice(None), units), None)
            skip[name + ".bias"] = ((units,), None)
            off = 0 if ".encoder." in name else model.src_len
            rows += x[b, off + t].tolist()
        rows = torch.tensor(sorted(set(rows)), dtype=torch.long)
        if len(rows):
            # the embedding's calls: the source's ids, then the decoder's
            ids = (x[:, :model.src_len], x[:, model.src_len:])
            parts = {}
            for dev, kept in outputs.items():
                lookup = torch.zeros(vocab, d_model, dtype=torch.float64)
                for i, g in zip(ids, kept["embed.grad"]):
                    lookup.index_add_(0, i.reshape(-1).long(), g.reshape(-1, d_model).double())
                parts[dev] = lookup[rows].float()
            skip["embed.weight"] = ((rows,), parts)
        log(f"[{label}] (a) ReLU gates the card and the CPU set apart: "
            f"{'; '.join(found) or 'none'} (a rounding flip when |h| <= {RELU_FLIP} of the "
            f"layer's max); the embedding rows of {len(rows)} tokens held without their "
            "lookup side")
        return skip, bad

    return exempt


def train_steps(torch, step, params, state, x, y, keys, after=None):
    """One step per key, each timed on the host clock to a synchronize;
    ``after()`` runs after each step. Returns (params, state, losses as
    floats, seconds)."""
    losses, secs = [], []
    for key in keys:
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss, params, state = step(params, state, x, y, key=key)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
        losses.append(loss)
        if after is not None:
            after()
    return params, state, [float(v) for v in losses], secs


def _median(v):
    return sorted(v)[len(v) // 2]


def _fmt_pct(share):
    return "not measured" if share is None else f"{100 * share:.1f}%"


# ------------------------------------------------------------------ phase 5
TRAIN_SEQ, TRAIN_PRED, O1_BATCH, O1_STEPS = 128, 20, 64, 20


def bert_pretraining_parts(torch, nn, optimizer, spmd):
    """bench.py's BERT-base pretraining pieces (phases 5 and 15): ``batch(b,
    vocab)`` -> (the packed [ids | masked positions] int32 input, the
    labels), ``build(model, amp_level)`` -> build_train_step's (step,
    init) over the TrainWrapper with AdamW(LR, weight decay 0.01,
    ClipGradByGlobalNorm(1.0))."""

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

    return batch, build


def phase_training(torch, fa, mods, card):
    BertForPretraining, nn, optimizer, spmd, prandom = mods
    torch.set_num_threads(os.cpu_count() or 1)
    batch, build = bert_pretraining_parts(torch, nn, optimizer, spmd)

    t0 = time.perf_counter()
    model = BertForPretraining(hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1,
                               device="cuda", generator=torch.Generator().manual_seed(0))
    n_layers = len(model.bert.encoder.layers)
    vocab = model.bert.vocab_size
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[training] BertForPretraining: {n_layers} layers, hidden "
        f"{model.bert.hidden_size}, vocab {vocab}, {n_params} parameters (decoder tied "
        f"to the word embeddings), built in {time.perf_counter() - t0:.1f} s")

    # (a) one O0 float32 step on the card and on the CPU, every gradient
    # held (the key projections' biases, zero but for rounding, to the
    # model's largest)
    a_counts, _, _ = parity_step(
        torch, fa, lambda m: build(m, "O0"), model,
        lambda dev: tuple(t.to(dev) for t in batch(4, vocab)), prandom.PRNGKey(0), LR,
        "training", zero_grads=("k_proj.bias",))

    # (b) O1 bf16 steps on one batch, a fresh key per step
    step, init = build(model, "O1")
    params, state = init()
    x, y = (t.to("cuda") for t in batch(O1_BATCH, vocab))
    torch.cuda.reset_peak_memory_stats()
    fa.launches = fa.dq_launches = fa.dkv_launches = 0  # count the main path only
    params, state, losses, secs = train_steps(
        torch, step, params, state, x, y,
        [prandom.fold_in(prandom.PRNGKey(0), i) for i in range(O1_STEPS)])
    steps_on_card = 1 + O1_STEPS
    steady = _median(secs[1:])
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
    counts = dict(fwd=fa.launches + a_counts[0], bwd_dq=fa.dq_launches + a_counts[1],
                  bwd_dkv=fa.dkv_launches + a_counts[2])
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
    idle = _fmt_pct(1 - busy_ms / step_ms if busy_ms > 0 else None)
    log(f"[profile] device idle {idle} of an O1 step (kernel time summed over the "
        "traced step against the CUDA-event time of the step before it)")
    return dict(counts=counts, steps=steps_on_card, step_ms=steady * 1e3,
                tokens_per_s=tokens / steady, losses=losses)


# ------------------------------------------------------------------ phase 6
GEN_BATCH, GEN_PROMPT, GEN_NEW = 16, 128, 128  # bench.py's decode shape
GEN_EAGER_STEPS = 31  # the timed eager loop's steps (the graphed loop runs all)
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
        eager_window, eager_step, lo, hi = timed_loop(torch, GEN_EAGER_STEPS, run.step)
        eager_tps = GEN_BATCH * GEN_EAGER_STEPS / eager_window * 1e3
        n = GEN_EAGER_STEPS + 1
        eager_same = torch.equal(run.tokens[:, :n].cpu(),
                                 torch.from_numpy(out[:, GEN_PROMPT:GEN_PROMPT + n]).long())
        log(f"[generation] eager decode loop: steps 2-{n} in {eager_window:.3f} ms by "
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


def _decode_call(wire_spec, port, prompt, n, budget_ms=None, oneshot=False, close_after=None,
                 speculative=False, trace_id=None):
    """One decode request over the wire: -> (statuses of its frames, the
    token chunks they carried, seconds from the send to the first frame).
    ``close_after``: hang up after that many frames, mid-stream;
    ``speculative``: opt in (0x5C bit 61); ``trace_id``: the 0x1D field."""
    tail = wire_spec.encode_decode_opts(n, oneshot=oneshot, speculative=speculative)
    if budget_ms is not None:
        tail = wire_spec.encode_deadline(budget_ms) + tail
    if trace_id is not None:
        tail = wire_spec.encode_trace(trace_id) + tail
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


def serve_window(torch, fa, engine, PredictorServer, wire_spec, base, first=ENGINE_FIRST,
                 later=ENGINE_LATER, qmm=None):
    """The engine behind PredictorServer on localhost, serving the streams
    of ``base`` (a list of dicts with prompt and n; the first ``first``
    all at once, the next ``later`` as the first retire) and the three
    extras after them: one hangs up after its 4th chunk, one has a 1 ms
    per-token budget, one is one-shot. The window runs from the first
    submit to the last terminal frame, timed by CUDA events; K1 (and,
    given ``qmm``, ops/quant_matmul.py's wq_matmul) is counted from 0
    over it. Returns (the streams with statuses, chunks and time to
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
    n_streams = first + later
    hang, tiny, oneshot = work[n_streams:]
    retired = threading.Semaphore(0)
    gate = threading.Barrier(first + 2)  # the first wave, the 1 ms one, this thread
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

    threads = [threading.Thread(target=client, args=(w, i < first))
               for i, w in enumerate(work[:n_streams])]
    threads += [threading.Thread(target=client, args=(hang, False), kwargs=dict(close_after=4)),
                threading.Thread(target=client, args=(tiny, True), kwargs=dict(budget_ms=1.0)),
                threading.Thread(target=client, args=(oneshot, False),
                                 kwargs=dict(oneshot=True))]
    for t in threads:
        t.start()
    before = engine.stats()
    fa.launches = 0  # count the window's launches only
    if qmm is not None:
        qmm.launches = 0
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
    wq_launches = None if qmm is None else qmm.launches
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
    delta = {k: after[k] - before[k] for k in ("prefix_fill_steps", "steps", "tokens",
                                               "step_rows", "k1_launches", "graph_replays")}
    for w in work[:n_streams]:
        w["tokens"] = np.concatenate(w["chunks"]) if w["chunks"] else np.zeros(0, np.int32)
    oneshot["tokens"] = oneshot["chunks"][0] if oneshot["chunks"] else None
    window = dict(window_ms=start.elapsed_time(end), host_s=host_s, launches=launches,
                  wq_launches=wq_launches, delta=delta, stats=st,
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
    LlamaModel, generation, DecodeEngine, PredictorServer, wire_spec = mods
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
    reuse_depth2(torch, generation, DecodeEngine, model, cpu_model, rng)
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
    engine = DecodeEngine(dm, max_prompt_len=ENGINE_PROMPT, min_seq_bucket=ENGINE_CHUNK,
                          max_queue=64, name="llama-7b")
    t = time.perf_counter()
    buckets = engine.warmup()
    torch.cuda.synchronize()
    st0 = engine.stats()
    log(f"[engine] Llama-2-7B bf16, {ENGINE_SLOTS} slots x {ENGINE_SEQ} positions: KV pools "
        f"{st0['kv_pool_bytes'] / 1e9:.2f} GB, staging {st0['staging_bytes']} bytes; warmup "
        f"(the fills ending at {buckets} and the step, each warmed up and captured, and the "
        f"weights digest, {st0['weights_digest_ms']:.1f} ms) {time.perf_counter() - t:.2f} s; "
        "captures "
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
    # (d) K1 ran once per layer in every fill replay and every step,
    # credited by the replays; every program was captured once, by warmup
    fills = delta["prefix_fill_steps"]
    want = n_layers * (fills + delta["steps"])
    used = {f"fill1x{end}" for w in work
            for end in range(ENGINE_CHUNK, w["prompt"].size + ENGINE_CHUNK, ENGINE_CHUNK)}
    used.add(f"step{ENGINE_SLOTS}x{ENGINE_SEQ}")
    log(f"[engine] (d) K1 launches {win['launches']} = {n_layers} x ({fills} fill replays + "
        f"{delta['steps']} steps) = {want}; the engine counted "
        f"{delta['k1_launches']}; graph replays {delta['graph_replays']}; programs "
        f"{st['programs']}")
    if (win["launches"] != want or delta["k1_launches"] != want
            or delta["graph_replays"] != fills + delta["steps"]
            or not used <= set(st["programs"])
            or any(v["compiles"] != 1 for v in st["programs"].values())):
        fail("the engine's K1 launches, replays or captures do not match its fill and step "
             "calls")
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
        hits = engine.stats()["prefix"]["hits"]
        alone = engine.generate(w["prompt"], max_new_tokens=w["n"], timeout=600)
        same = bool(np.array_equal(alone, w["tokens"]))
        solo_ok.append(same)
        hit = engine.stats()["prefix"]["hits"] > hits
        log(f"[engine] (b) {label}: prompt {w['prompt'].size}, {w['n']} tokens, peak batch "
            f"{w['peak_batch']}; decoded alone ({'a prefix-cache hit' if hit else 'cold'}) "
            f"{'bitwise equal' if same else 'DIFFERS'}")
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
        f"occupancy and the mean cache length {mean_len:.1f}; {fills} fill replays, "
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

    # the first half of the streams (8 at once, 4 as they retire) and the
    # extras through the same engine run eagerly (no graph); half, to keep
    # the script inside its time
    eager_engine = DecodeEngine(dm, max_prompt_len=ENGINE_PROMPT, min_seq_bucket=ENGINE_CHUNK,
                                max_queue=64, name="llama-7b-eager", cuda_graph=False)
    eager_engine.warmup()
    ef, el = ENGINE_FIRST // 2, ENGINE_LATER // 2
    ework, eserver, ewin, _ = serve_window(torch, fa, eager_engine, PredictorServer,
                                           wire_spec, base[:ef + el] + base[n_streams:], ef, el)
    est, edelta = ewin["stats"], ewin["delta"]
    same = [np.array_equal(a["tokens"], b["tokens"])
            for a, b in zip(work[:ef + el] + [oneshot], ework[:ef + el] + [ework[-1]])]
    eocc = edelta["step_rows"] / (edelta["steps"] * ENGINE_SLOTS)
    etps = edelta["tokens"] / ewin["window_ms"] * 1e3
    ewant = n_layers * (edelta["prefix_fill_steps"] + edelta["steps"])
    log(f"[engine] eager window, the first {ef + el} streams and the extras: {sum(same)}/"
        f"{len(same)} token streams "
        f"bitwise equal to the graphed window's; {edelta['tokens']} tokens in "
        f"{ewin['window_ms']:.1f} ms = {etps:.1f} tokens/s; {edelta['prefix_fill_steps']} "
        "fill replays, "
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
    return dict(launches=win["launches"], fill_launches=n_layers * fills,
                step_launches=n_layers * delta["steps"], tokens_per_s=tps,
                eager_tokens_per_s=etps, bound_tokens_per_s=bound_tps,
                step_ms=st["step_ms_median"], eager_step_ms=est["step_ms_median"], idle=idle,
                ttft_ms=win["ttft_ms"], eager_ttft_ms=ewin["ttft_ms"],
                pool_bytes=st["graph_pool_bytes"], model=model, dm=dm, base=base)


# ------------------------------------------------------------------ phase 8
REUSE_SYSTEM, REUSE_STREAMS = 96, 24  # a shared system prompt, its streams
REUSE_BUDGET = 1 << 30  # prefix_max_bytes: 32 pages of 32 MiB at C = 64
REUSE_CADENCE, REUSE_NEW = 32, 100  # (c): snapshots at 32, 64 and 96 tokens
MAX_BODY = 1 << 30  # a 7B snapshot is ~1 MiB a position in f32


def reuse_depth2(torch, generation, DecodeEngine, model, cpu_model, rng):
    """Phase 8 (a): phase 7's depth-2 float32 pair, prompts sharing a
    32-token prefix through a prefix-cached engine (C = 16) on the card
    and on the CPU: the first seeds the cache, the other four hit. Tokens
    equal, or a near-tie of the CPU's teacher-forced logits."""
    vocab = model.embed_tokens.weight.shape[0]
    shared = rng.randint(0, vocab, 32).astype(np.int32)
    prompts = [np.concatenate([shared, rng.randint(0, vocab, n).astype(np.int32)])
               for n in (5, 3, 12, 16, 9)]
    out, hits = {}, {}
    for dev, m in (("cuda", model), ("cpu", cpu_model)):
        dm = generation.llama_decode_model(m, 4, 64)
        with DecodeEngine(dm, device=dev, max_prompt_len=48, min_seq_bucket=16,
                          name=f"reuse-{dev}") as eng:
            first = eng.generate(prompts[0], max_new_tokens=6, timeout=600)
            reqs = [eng.submit(p, max_new_tokens=6) for p in prompts[1:]]
            out[dev] = [first] + [r.result(timeout=600) for r in reqs]
            hits[dev] = eng.stats()["prefix"]["hits"]
    equal = excused = beyond = 0
    for p, g, c in zip(prompts, out["cuda"], out["cpu"]):
        ids = np.concatenate([p, g])[None]
        gap, _, agree = token_gaps(torch, _forward(torch, cpu_model, ids, "cpu"), ids, p.size)
        equal += int(np.array_equal(g, c))
        excused += int((~agree & (gap <= TIE["float32"])).sum())
        beyond += int((gap > TIE["float32"]).sum())
    log(f"[reuse] (a) depth 2 float32, {len(prompts)} prompts sharing a 32-token prefix "
        f"(cache hits: card {hits['cuda']}, CPU {hits['cpu']}), card vs CPU: {equal}/"
        f"{len(prompts)} token streams equal, {excused} token(s) excused at a near-tie "
        f"({TIE['float32']}), {beyond} beyond it")
    if beyond or hits["cuda"] != len(prompts) - 1 or hits["cpu"] != len(prompts) - 1:
        fail("the prefix-cached engine on the card disagrees with the CPU, or missed")


def _frames(wire_spec, port, frame, timeout=900):
    """One request over the wire: -> ([(status, payload)] up to the
    terminal frame, seconds from the send to the first frame, seconds to
    the first token frame or None)."""
    frames, first_s, token_s = [], None, None
    with socket.create_connection(("127.0.0.1", port), timeout=timeout) as s:
        t0 = time.perf_counter()
        s.sendall(frame)
        while True:
            (blen,) = struct.unpack("<I", _recv(s, 4))
            body = _recv(s, blen)
            now = time.perf_counter() - t0
            first_s = now if first_s is None else first_s
            if token_s is None and len(body) > 1 and not wire_spec.is_kv_snapshot(body[1:]):
                token_s = now
            frames.append((body[0], body[1:]))
            if body[0] != wire_spec.STATUS_STREAM:
                return frames, first_s, token_s


def _split(wire_spec, frames):
    """-> (terminal status, token list, [snapshot blocks])."""
    tokens, snaps = [], []
    for _, payload in frames:
        if wire_spec.is_kv_snapshot(payload):
            snaps.append(payload)
        elif payload:
            tokens.extend(int(t) for t in wire_spec.decode_arrays(payload)[0])
    return frames[-1][0], tokens, snaps


def burst_window(torch, fa, engine, port, wire_spec, work, trace_id=None):
    """Every stream of ``work`` at once through the server at ``port``
    (the engine queues what its slots cannot hold); ``trace_id`` tags
    stream 0 (0x1D). The window runs from the first send to the last
    terminal frame, timed by CUDA events; K1 is counted from 0 over it.
    Returns (per stream: terminal status, tokens, seconds to the first
    frame, the host clock at its first token frame (None without one) and
    at its end; the window's numbers and stats deltas)."""
    results = [None] * len(work)
    errors = []
    gate = threading.Barrier(len(work) + 1)

    def client(i, w):
        try:
            tail = wire_spec.encode_decode_opts(w["n"])
            if trace_id is not None and i == 0:
                tail = wire_spec.encode_trace(trace_id) + tail
            frame = wire_spec.build_request(wire_spec.CMD_INFER,
                                            wire_spec.encode_arrays([w["prompt"]]) + tail)
            gate.wait()
            t_send = time.perf_counter()  # a local connect takes microseconds
            frames, first_s, token_s = _frames(wire_spec, port, frame)
            status, tokens, _ = _split(wire_spec, frames)
            results[i] = dict(status=status, tokens=tokens, first_s=first_s,
                              t_first=None if token_s is None else t_send + token_s,
                              t_end=time.perf_counter())
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(f"{type(e).__name__}: {e}")

    threads = [threading.Thread(target=client, args=(i, w)) for i, w in enumerate(work)]
    for t in threads:
        t.start()
    before = engine.stats()
    fa.launches = 0
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
    if errors:
        fail(f"decode clients failed: {errors[:3]}")
    after = engine.stats()
    delta = {k: after[k] - before[k] for k in ("prefix_fill_steps", "steps", "tokens",
                                               "k1_launches", "graph_replays")}
    if after["prefix"] is not None:
        delta["hits"] = after["prefix"]["hits"] - before["prefix"]["hits"]
    return results, dict(window_ms=start.elapsed_time(end), host_s=host_s,
                         launches=fa.launches, delta=delta, stats=after)


def first_token_alone(engine, prompts, n=4):
    """Seconds from submit to the first token of each prompt, each alone
    on an idle engine (host clock)."""
    out = []
    for p in prompts:
        t0 = time.perf_counter()
        req = engine.submit(p, max_new_tokens=n)
        req.next_tokens(timeout=600)
        out.append(time.perf_counter() - t0)
        req.result(timeout=600)
    return out


def phase_reuse(torch, fa, mods, card, eng7):
    """Phase 8 (b) and (c) with phase 7's 7B weights (module docstring)."""
    import gc

    generation, DecodeEngine, PredictorServer, wire_spec = mods
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    model, dm = eng7["model"], eng7["dm"]
    n_layers = len(model.layers)
    vocab = model.embed_tokens.weight.shape[0]
    rng = np.random.RandomState(8)
    kw = dict(max_prompt_len=ENGINE_PROMPT, min_seq_bucket=REUSE_CHUNK, max_queue=64)
    hot = DecodeEngine(dm, prefix_max_bytes=REUSE_BUDGET, name="llama-7b-prefix", **kw)
    cold = DecodeEngine(dm, prefix=False, name="llama-7b-cold", **kw)
    t = time.perf_counter()
    hot.warmup()
    cold.warmup()
    torch.cuda.synchronize()
    log(f"[reuse] two engines of phase 7's configuration ({ENGINE_SLOTS} slots x "
        f"{ENGINE_SEQ}, but chunk and page {REUSE_CHUNK}), one with the prefix cache "
        f"({REUSE_BUDGET >> 20} MiB budget = {hot.stats()['prefix']['max_pages']} pages of "
        f"{hot._pages.page_bytes()} bytes, as the reference counts them), warmed up in "
        f"{time.perf_counter() - t:.2f} s; the weights digest was taken once, in phase 7, "
        f"in {hot.stats()['weights_digest_ms']:.1f} ms | {card}")
    servers = [PredictorServer(None, decode_engine=e, own_decode_engine=True,
                               max_body=MAX_BODY) for e in (hot, cold)]
    system = rng.randint(0, vocab, REUSE_SYSTEM).astype(np.int32)

    def stream(n_new):
        suffix = rng.randint(0, vocab, rng.randint(8, 33)).astype(np.int32)
        return dict(prompt=np.concatenate([system, suffix]), n=n_new)

    # (b) the same 24 streams through both engines
    work = [stream(int(rng.randint(16, 65))) for _ in range(REUSE_STREAMS)]
    got, won = {}, {}
    for name, eng, srv in (("prefix", hot, servers[0]), ("cold", cold, servers[1])):
        got[name], won[name] = burst_window(torch, fa, eng, srv.port, wire_spec, work)
    bad = [i for i, w in enumerate(work) for name in got
           if got[name][i]["status"] != wire_spec.STATUS_OK
           or len(got[name][i]["tokens"]) != w["n"]]
    same = sum(got["prefix"][i]["tokens"] == got["cold"][i]["tokens"] for i in range(len(work)))
    hits = won["prefix"]["delta"]["hits"]
    counts_ok = True
    for name in got:
        d, win = won[name]["delta"], won[name]
        want = n_layers * (d["prefix_fill_steps"] + d["steps"])
        counts_ok &= (win["launches"] == want == d["k1_launches"]
                      and d["graph_replays"] == d["prefix_fill_steps"] + d["steps"]
                      and all(v["compiles"] == 1 for v in win["stats"]["programs"].values()))
        tps = d["tokens"] / win["window_ms"] * 1e3
        ttft = 1e3 * float(np.median([r["first_s"] for r in got[name]]))
        log(f"[reuse] (b) {name} engine, {len(work)} streams sharing a {REUSE_SYSTEM}-token "
            f"system prompt: {d['tokens']} tokens in {win['window_ms']:.1f} ms by CUDA events "
            f"= {tps:.1f} tokens/s ({d['tokens'] / win['host_s']:.1f} by host clock); "
            f"{d['prefix_fill_steps']} fill replays = {d['prefix_fill_steps'] / len(work):.2f} "
            f"a joiner, {d['steps']} steps; first token median {ttft:.1f} ms in the window; "
            f"K1 {win['launches']} (expected {want}), replays {d['graph_replays']}; "
            f"programs {sorted(win['stats']['programs'])} | {card}")
    log(f"[reuse] (b) {same}/{len(work)} streams bitwise equal across the two engines; "
        f"{hits} of {len(work)} streams hit; malformed {bad}")
    if bad or same != len(work) or hits < len(work) - 1 or not counts_ok:
        fail("a prefix-cache hit differs from its cold stream, too few hits, or the engines' "
             "K1 launches, replays or captures do not match their calls")
    # first tokens alone on an idle engine: cold (no cache) and hit
    probes = [stream(4)["prompt"] for _ in range(4)]
    cold_s = first_token_alone(cold, probes)
    hit_s = first_token_alone(hot, probes)
    log(f"[reuse] (b) first token alone on an idle engine, {len(probes)} prompts of "
        f"{[p.size for p in probes]} tokens: cold median {1e3 * np.median(cold_s):.1f} ms "
        f"({', '.join(f'{1e3 * x:.1f}' for x in cold_s)}), hit median "
        f"{1e3 * np.median(hit_s):.1f} ms ({', '.join(f'{1e3 * x:.1f}' for x in hit_s)}) "
        f"(host clock: the fills, the finishing step and the read back) | {card}")
    key = ("fill", 1, ENGINE_PROMPT)
    with torch.inference_mode(), hot._exec_lock:
        run = hot._program(key)
        fill_ms, fill_busy, fill_kernels, fill_k1 = profile_replay(
            torch, run, f"one fill replay, rows {ENGINE_PROMPT - REUSE_CHUNK}.."
            f"{ENGINE_PROMPT - 1}", n_layers)
    fill_idle = (f"{100 * (1 - fill_busy / fill_ms):.1f}%" if fill_busy > 0
                 else "not measured")
    log(f"[profile] device idle {fill_idle} of a fill replay; {fill_kernels} kernels, K1 "
        f"records {fill_k1} (expected {n_layers})")
    if fill_k1 != n_layers:
        fail(f"a profiled fill replay shows {fill_k1} K1 kernels, not {n_layers}")

    # (c) cadence-32 streams; their middle snapshots put and resumed on the
    # other engine; a handoff; skewed snapshots
    t_c = time.perf_counter()
    cad = [stream(REUSE_NEW) for _ in range(4)]
    out = [None] * len(cad)

    def cadence_client(i):
        frame = wire_spec.build_request(wire_spec.CMD_INFER, wire_spec.encode_arrays(
            [cad[i]["prompt"]]) + wire_spec.encode_decode_opts(
                REUSE_NEW, snapshot_every=REUSE_CADENCE))
        out[i] = _split(wire_spec, _frames(wire_spec, servers[0].port, frame)[0])

    threads = [threading.Thread(target=cadence_client, args=(i,)) for i in range(len(cad))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(900)
    if any(o is None for o in out):
        fail("a cadence stream failed")
    # the snapshots' n_generated; a frame goes out between token frames once
    # its tokens are on the wire, so the last may miss the stream's end
    marks = list(range(REUSE_CADENCE, REUSE_NEW, REUSE_CADENCE))
    middle = marks[len(marks) // 2]
    put_ok = resumed_ok = oneshot_ok = 0
    resume_first_ms, sizes = [], []
    for w, (status, tokens, snaps) in zip(cad, out):
        heads = [wire_spec.decode_kv_snapshot_off(b)[0] for b in snaps]
        gens = [h["n_generated"] for h in heads]
        if (status != wire_spec.STATUS_OK or len(tokens) != REUSE_NEW
                or not set(gens) <= set(marks) or middle not in gens
                or any(h["pos"] != w["prompt"].size + h["n_generated"] - 1 for h in heads)):
            fail(f"a cadence stream is malformed: status {status}, {len(tokens)} tokens, "
                 f"snapshots at {gens}")
        w["tokens"] = tokens
        w["snapshots"] = gens
        mid = snaps[gens.index(middle)]
        g = middle
        sizes.append(len(mid))
        st, body = _call(servers[1].port, wire_spec.build_request(wire_spec.CMD_KV_PUT, mid))
        put_ok += int(st == wire_spec.STATUS_OK
                      and json.loads(body) == heads[gens.index(middle)])
        frames, _, token_s = _frames(wire_spec, servers[1].port, wire_spec.build_request(
            wire_spec.CMD_KV_RESUME, mid + wire_spec.encode_decode_opts(REUSE_NEW)))
        rst, rest, _ = _split(wire_spec, frames)
        resumed_ok += int(rst == wire_spec.STATUS_OK and rest == tokens[g:])
        resume_first_ms.append(1e3 * token_s)
        frames, _, _ = _frames(wire_spec, servers[1].port, wire_spec.build_request(
            wire_spec.CMD_KV_RESUME, mid + wire_spec.encode_decode_opts(REUSE_NEW,
                                                                        oneshot=True)))
        ost, whole, _ = _split(wire_spec, frames)
        oneshot_ok += int(ost == wire_spec.STATUS_OK and len(frames) == 1 and whole == tokens)
    costs = hot.stats()["snapshot_costs"]
    log(f"[reuse] (c) {len(cad)} streams of {REUSE_NEW} tokens at cadence {REUSE_CADENCE}: "
        f"every snapshot frame decodes, at n_generated {[w['snapshots'] for w in cad]}; "
        f"middle snapshots put {put_ok}/{len(cad)} status 0, resumed streamed "
        f"{resumed_ok}/{len(cad)} and one-shot {oneshot_ok}/{len(cad)} bitwise; middle "
        f"snapshot bytes {sizes}; a snapshot's medians: {costs['copy_ms']:.1f} ms of the "
        f"scheduler's (queueing the copy), {costs['encode_ms']:.1f} ms to build the block on "
        f"the server's thread, {costs['bytes']} bytes; resume to first token "
        f"{', '.join(f'{x:.1f}' for x in resume_first_ms)} ms (cmd 10 sent to the first "
        f"token frame) | {card}")
    if put_ok != len(cad) or resumed_ok != len(cad) or oneshot_ok != len(cad):
        fail("a snapshot was not accepted, or a resumed stream differs from the unbroken one")
    w = cad[0]
    frames, _, _ = _frames(wire_spec, servers[0].port, wire_spec.build_request(
        wire_spec.CMD_INFER, wire_spec.encode_arrays([w["prompt"]])
        + wire_spec.encode_decode_opts(REUSE_NEW, handoff=True)))
    hst, first, hsnaps = _split(wire_spec, frames)
    st, _ = _call(servers[1].port, wire_spec.build_request(wire_spec.CMD_KV_PUT, hsnaps[0])) \
        if hsnaps else (None, None)
    rst, rest, _ = _split(wire_spec, _frames(wire_spec, servers[1].port, wire_spec.build_request(
        wire_spec.CMD_KV_RESUME, hsnaps[0] + wire_spec.encode_decode_opts(REUSE_NEW)))[0]) \
        if hsnaps else (None, [], [])
    handoff_ok = ([f[0] for f in frames] == [wire_spec.STATUS_STREAM, wire_spec.STATUS_OK]
                  and len(hsnaps) == 1 and st == wire_spec.STATUS_OK
                  and rst == wire_spec.STATUS_OK and first + rest == w["tokens"])
    log(f"[reuse] (c) handoff (bit 62): frames {[f[0] for f in frames]}, one snapshot of "
        f"{len(hsnaps[0]) if hsnaps else 0} bytes and the first token; put status {st}; "
        f"its resume gives the other {len(rest)} tokens: "
        f"{'bitwise the unbroken stream' if handoff_ok else 'DIFFERS'}")
    if not handoff_ok:
        fail("the prefill handoff and its resume do not give the unbroken stream")
    hdr, arrays, _ = wire_spec.decode_kv_snapshot_off(out[0][2][0])
    skews = {"weights digest": (dict(hdr, weights="0" * 64), arrays),
             "fingerprint": (dict(hdr, fingerprint="0" * 64), arrays),
             "position (kv rows short of pos)": (
                 hdr, arrays[:2] + [a[:hdr["pos"] - 1] for a in arrays[2:]])}
    refused = {}
    for label, (h, a) in skews.items():
        blob = wire_spec.encode_kv_snapshot(h, a)
        pst, _ = _call(servers[1].port, wire_spec.build_request(wire_spec.CMD_KV_PUT, blob))
        rframes, _, _ = _frames(wire_spec, servers[1].port, wire_spec.build_request(
            wire_spec.CMD_KV_RESUME, blob + wire_spec.encode_decode_opts(REUSE_NEW)))
        refused[label] = (pst, _split(wire_spec, rframes)[:2])
    log(f"[reuse] (c) skewed snapshots, (kv_put status, (kv_resume status, tokens)): "
        f"{refused}; resumes on the cold engine {cold.stats()['resumes']}; (c) took "
        f"{time.perf_counter() - t_c:.1f} s")
    if any(v != (wire_spec.STATUS_RETRYABLE, (wire_spec.STATUS_RETRYABLE, []))
           for v in refused.values()):
        fail("a skewed snapshot was not refused with status 2, or gave tokens")
    for srv in servers:
        srv.stop()
    log(f"[reuse] the phase took {time.perf_counter() - t_phase:.1f} s")
    # K1's launches in the two windows, and in their fills alone
    return dict(launches=sum(won[n]["launches"] for n in won),
                fill_launches=sum(n_layers * won[n]["delta"]["prefix_fill_steps"] for n in won))


# ------------------------------------------------------------------ phase 9
SPEC_K = 4  # tokens a verify replay checks: the last one and 3 proposals
SPEC_STREAMS, SPEC_FIRST = 24, 16  # a window's streams: 16 at once, 8 as the first retire
SPEC_SKIP_LAYERS = 2  # the layer-skip draft: the target's first 2 decoder layers
SPEC_DELTAS = ("prefix_fill_steps", "steps", "tokens", "k1_launches", "graph_replays",
               "program_failures")
SPEC_COUNTS = ("iterations", "accepted", "rejected", "verify_steps", "draft_steps",
               "draft_prefills")


def spec_window(torch, fa, engine, port, wire_spec, work, opted):
    """The streams ``work`` (dicts with prompt and n) over the wire, the
    first SPEC_FIRST at once and the rest as the first retire, stream i
    opted in (0x5C bit 61) where ``opted[i]``. CUDA events time the window
    from the first send to the last terminal frame; K1 is counted from 0
    over it. -> (tokens per stream, window ms, K1 launches, deltas of the
    engine's counters and of its ``spec`` counters)."""
    out, errors = [None] * len(work), []
    retired = threading.Semaphore(0)
    gate = threading.Barrier(SPEC_FIRST + 1)

    def client(i):
        try:
            if i < SPEC_FIRST:
                gate.wait()
            else:
                retired.acquire()
            statuses, chunks, _ = _decode_call(wire_spec, port, work[i]["prompt"], work[i]["n"],
                                               speculative=opted[i])
            if (statuses[-1] != wire_spec.STATUS_OK
                    or any(x != wire_spec.STATUS_STREAM for x in statuses[:-1])):
                errors.append(f"stream {i}: statuses {statuses}")
            out[i] = np.concatenate(chunks) if chunks else np.zeros(0, np.int32)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(f"stream {i}: {type(e).__name__}: {e}")
        finally:
            retired.release()

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(work))]
    for t in threads:
        t.start()
    before = engine.stats()
    fa.launches = 0  # count the window's launches only
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    gate.wait()
    start.record()
    for t in threads:
        t.join(600)
        if t.is_alive():
            fail("a speculative decode client did not finish within 600 s")
    end.record()
    end.synchronize()
    launches = fa.launches
    after = engine.stats()
    if errors:
        fail(f"speculative decode streams failed: {errors[:3]}")
    bad = [i for i, (w, t) in enumerate(zip(work, out)) if t.size != w["n"]]
    if bad:
        fail(f"speculative decode streams {bad} did not carry exactly their max_new_tokens")
    delta = {k: after[k] - before[k] for k in SPEC_DELTAS}
    delta.update({k: after["spec"][k] - before["spec"][k] for k in SPEC_COUNTS})
    return out, start.elapsed_time(end), launches, delta


def one_call_device_ms(torch, fn):
    """The summed durations of the kernels one call of ``fn`` ran, from a
    torch.profiler window around that call alone (a window over many
    7B replays loses records), or None where it saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    us = device_us(prof.key_averages())
    return us / 1e3 if us else None


def spec_replays(torch, engine, n_layers, mean_len, card, verify):
    """On the idle engine, every row at ``mean_len``: with ``verify``, one
    verify replay (the k calls of one graph) against k replays of the
    step's graph fed the verify's columns (by device copies), and one
    verify replay profiled (n_layers x k K1 records, the idle share); one
    draft step replay. Each timed by CUDA events over back-to-back calls
    and by the device time of one call. -> {name: (events ms, device
    ms)}."""
    g = engine._graphs
    out = {}
    with torch.inference_mode(), engine._exec_lock:
        v_tok, v_pos, _ = g.inputs(engine._verify_key)
        s_tok, s_pos, _ = g.inputs(engine._step_key)
        d_tok, d_pos, _ = engine._draft_graphs.inputs(engine._draft_step_key)
        v_tok.zero_()
        v_pos.copy_(mean_len + torch.arange(SPEC_K, dtype=torch.int32, device=v_pos.device))
        d_tok.zero_()
        d_pos.fill_(mean_len)
        run_v = engine._program(engine._verify_key)
        run_s = engine._program(engine._step_key)
        run_d = engine._program(engine._draft_step_key)

        def k_steps():
            for i in range(SPEC_K):
                s_tok.copy_(v_tok[:, i])
                s_pos.copy_(v_pos[:, i])
                run_s()

        fns = {"draft_step": run_d}
        if verify:
            fns = {"verify": run_v, "k_steps": k_steps, **fns}
        for name, fn in fns.items():
            out[name] = (cuda_ms(torch, fn, iters=5, warmup=1), one_call_device_ms(torch, fn))
        if verify:
            v_ms, v_busy, v_kernels, k1 = profile_replay(
                torch, lambda: run_v().cpu(), f"one verify replay, {ENGINE_SLOTS} rows x "
                f"{SPEC_K} positions from cache length {mean_len}", n_layers * SPEC_K)
            idle = f"{100 * (1 - v_busy / v_ms):.1f}%" if v_busy > 0 else "not measured"
            log(f"[profile] device idle {idle} of a verify replay; {v_kernels} kernels; K1 "
                f"records {k1} (expected {n_layers * SPEC_K}) | {card}")
            if k1 != n_layers * SPEC_K:
                fail(f"a profiled verify replay shows {k1} K1 kernels, not {n_layers * SPEC_K}")
    return out


def phase_spec(torch, fa, mods, card, eng7):
    """Phase 9 (module docstring) with phase 7's 7B weights."""
    import gc

    generation, DecodeEngine, PredictorServer, wire_spec = mods
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    model, dm7 = eng7["model"], eng7["dm"]
    n_layers = len(model.layers)
    vocab = model.embed_tokens.weight.shape[0]
    rng = np.random.RandomState(9)
    work = [dict(prompt=rng.randint(0, vocab, int(rng.randint(16, ENGINE_PROMPT + 1)))
                 .astype(np.int32), n=int(rng.randint(16, 65))) for _ in range(SPEC_STREAMS)]
    mean_len = int(np.mean([w["prompt"].size + w["n"] / 2 for w in work]))
    drafts = {
        "self-draft": (generation.llama_decode_model(model, ENGINE_SLOTS, ENGINE_SEQ), n_layers),
        "layer-skip": (generation.llama_decode_model(
            generation.llama_layer_skip(model, SPEC_SKIP_LAYERS), ENGINE_SLOTS, ENGINE_SEQ),
            SPEC_SKIP_LAYERS),
    }
    res = dict(launches=0, verify_launches=0, draft_launches=0)
    for label, (draft, d_layers) in drafts.items():
        t = time.perf_counter()
        dm = copy.copy(dm7)  # phase 7's model (its weights digest taken), with a draft
        dm.draft = draft
        # no prefix cache: every window fills its prompts cold, so the
        # windows' tokens/s compare
        engine = DecodeEngine(dm, max_prompt_len=ENGINE_PROMPT, min_seq_bucket=ENGINE_CHUNK,
                              max_queue=64, spec_k=SPEC_K, prefix=False, name=f"llama-7b-{label}")
        with torch.inference_mode():  # the plain programs first: the pool before the rest
            for key in (("fill", 1, ENGINE_CHUNK), engine._step_key):
                engine._program(key)
        pool_plain = engine.stats()["graph_pool_bytes"]
        engine.warmup()
        torch.cuda.synchronize()
        st = engine.stats()
        log(f"[spec] {label} ({d_layers} layers, weights shared with the target): spec_k "
            f"{SPEC_K}, draft KV pools {st['draft_kv_pool_bytes'] / 1e9:.3f} GB; captures "
            + ", ".join(f"{k} {v.get('capture_ms', float('nan')):.1f} ms"
                        for k, v in st["programs"].items())
            + f"; graph pool {pool_plain} bytes after the fill and the step, "
            f"{st['graph_pool_bytes']} with the verify and the draft's programs; engine up in "
            f"{time.perf_counter() - t:.2f} s | {card}")
        server = PredictorServer(None, decode_engine=engine, own_decode_engine=True)
        wins = {}
        for name, opted in (("plain", [False] * SPEC_STREAMS), ("opted", [True] * SPEC_STREAMS),
                            ("mixed", [i % 2 == 0 for i in range(SPEC_STREAMS)])):
            wins[name] = spec_window(torch, fa, engine, server.port, wire_spec, work, opted)
        plain = wins["plain"][0]
        for name, (toks, ms, k1, d) in wins.items():
            same = sum(np.array_equal(a, b) for a, b in zip(toks, plain))
            want = (n_layers * (d["prefix_fill_steps"] + d["steps"] + SPEC_K * d["verify_steps"])
                    + d_layers * (d["draft_prefills"] + d["draft_steps"]))
            checked = d["accepted"] + d["rejected"]
            acc = d["accepted"] / checked if checked else float("nan")
            mean_acc = (d["accepted"] / (d["iterations"] * (SPEC_K - 1))
                        if d["iterations"] else float("nan"))
            log(f"[spec] {label}, {name} window: {same}/{SPEC_STREAMS} streams bitwise the "
                f"plain window's; {d['tokens']} tokens in {ms:.1f} ms (CUDA events) = "
                f"{d['tokens'] / ms * 1e3:.1f} tokens/s; {d['prefix_fill_steps']} fills, "
                f"{d['steps']} steps, {d['verify_steps']} verify replays, {d['draft_prefills']} "
                f"draft fills, {d['draft_steps']} draft steps; bursts {d['iterations']}, "
                f"accepted {d['accepted']}, rejected {d['rejected']}: acceptance {acc:.4f} of "
                f"the proposals checked, {mean_acc:.4f} a burst (the reference's metric); K1 "
                f"launches {k1} = {n_layers} x ({d['prefix_fill_steps']} + {d['steps']} + "
                f"{SPEC_K} x {d['verify_steps']}) + {d_layers} x ({d['draft_prefills']} + "
                f"{d['draft_steps']}) = {want}, the engine counted {d['k1_launches']}; "
                f"program failures {d['program_failures']} | {card}")
            if same != SPEC_STREAMS:
                fail(f"{label}: a stream of the {name} window differs from its plain tokens")
            if k1 != want or d["k1_launches"] != want or d["program_failures"]:
                fail(f"{label}: the {name} window's K1 launches do not match its programs' "
                     "calls, or a program failed")
            if name != "plain" and not (d["iterations"] > 0 and d["verify_steps"] > 0):
                fail(f"{label}: the {name} window took no speculative burst")
            if name != "plain" and label == "self-draft" and (d["rejected"] or not d["accepted"]):
                fail("the self-draft's acceptance is not exactly 1.0: the verify or the draft "
                     "does not compute what the step computes")
            res["launches"] += k1
            res["verify_launches"] += n_layers * SPEC_K * d["verify_steps"]
            res["draft_launches"] += d_layers * (d["draft_prefills"] + d["draft_steps"])
        # the verify is the target's program, the same in both engines:
        # timed in the first
        times = spec_replays(torch, engine, n_layers, mean_len, card,
                             verify=label == "self-draft")
        if "verify" in times:
            (v_ev, v_dev), (s_ev, s_dev) = times["verify"], times["k_steps"]
            log(f"[spec] the engine idle, every row at cache length {mean_len}: a verify replay "
                f"({SPEC_K} step calls in one graph) {_fmt(v_dev)} ms device ({v_ev:.3f} ms "
                f"events) against {SPEC_K} step replays fed the same columns {_fmt(s_dev)} ms "
                f"device ({s_ev:.3f} events) | {card}")
        d_ev, d_dev = times["draft_step"]
        log(f"[spec] {label}: a draft step replay, every row at cache length {mean_len}, "
            f"{_fmt(d_dev)} ms device ({d_ev:.3f} ms events) | {card}")
        st = engine.stats()
        broken = {k: v["breaker"] for k, v in st["programs"].items()
                  if v.get("breaker", {}).get("state", "closed") != "closed"
                  or v.get("breaker", {}).get("trips", 0)}
        if (broken or st["program_failures"] or st["quarantine_shed"]
                or any(v["compiles"] != 1 for v in st["programs"].values())):
            fail(f"{label}: a breaker opened or tripped, a program failed or was built twice: "
                 f"{broken}, {st['program_failures']} failures, programs {st['programs']}")
        server.stop()
        del engine, server
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[spec] {label}: its engine's part of the phase took "
            f"{time.perf_counter() - t:.1f} s")
    log(f"[spec] the phase took {time.perf_counter() - t_phase:.1f} s")
    return res


# ------------------------------------------------------------------ phase 10
ROBUST_INTERVAL, ROBUST_WEDGE, ROBUST_DELAY = 0.05, 2.0, 3.0  # watchdog s, wedge s, chaos delay s
# the first iteration of a fault window holds (below the wedge timeout)
# while every stream arrives, so the next one joins all it can hold
ROBUST_HOLD = 0.5
ROBUST_STREAMS = ENGINE_FIRST + ENGINE_LATER  # 16 fill the slots, 8 wait in the engine's queue
STEP_TIMER_TOL = 0.25  # the step timer's mean against the CUDA-event median step


def check_calls(win, n_layers, label):
    """K1 ran once per layer in every fill replay and step a
    ``burst_window`` counted, credited by as many graph replays (a
    superseded thread makes none). -> the calls."""
    d = win["delta"]
    calls = d["prefix_fill_steps"] + d["steps"]
    want = n_layers * calls
    if win["launches"] != want or d["k1_launches"] != want or d["graph_replays"] != calls:
        fail(f"{label}: K1 launches {win['launches']}, engine's count {d['k1_launches']}, "
             f"graph replays {d['graph_replays']}; expected {n_layers} x {calls} launches "
             "and one replay per fill and step")
    return calls


def parse_exposition(text):
    """-> {series: value} of a Prometheus text exposition, failing on a
    series that appears twice."""
    series = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        key, value = line.rsplit(" ", 1)
        if key in series:
            fail(f"the exposition repeats the series {key}")
        series[key] = float(value)
    return series


def robust_faults(torch, fa, engine, port, wire_spec, chaos, work, unbroken, n_layers, label,
                  site, visit, **fault):
    """One window of ``work`` with ``fault`` armed at the ``visit``-th
    visit of ``site`` from now, once 16 rows run: the scheduler's first
    iteration holds ROBUST_HOLD s at serving.decode.loop (below the wedge
    timeout) while every stream arrives, its next joins the rest up to 16
    slots, and 8 wait in the queue. The streams in flight must end with
    status 2 and a prefix of their unbroken tokens, the queued ones be
    served whole by the replacement scheduler, and the failed ones,
    retried, give their unbroken tokens. -> (window numbers, K1
    launches over both runs)."""
    st0 = engine.stats()
    chaos.arm("serving.decode.loop", delay=ROBUST_HOLD, at=chaos.visits("serving.decode.loop") + 1)
    chaos.arm(site, at=chaos.visits(site) + visit, **fault)
    res, win = burst_window(torch, fa, engine, port, wire_spec, work)
    chaos.reset()
    launches = win["launches"]
    calls = check_calls(win, n_layers, label)
    failed = [i for i, r in enumerate(res) if r["status"] == wire_spec.STATUS_RETRYABLE]
    served = [i for i, r in enumerate(res) if r["status"] == wire_spec.STATUS_OK]
    prefix_ok = all(res[i]["tokens"] == unbroken[i][:len(res[i]["tokens"])] for i in failed)
    whole_ok = all(res[i]["tokens"] == unbroken[i] for i in served)
    # the restart fails the streams in flight at once; the queued ones get
    # their first token from the replacement (client clock)
    restart_ms = 1e3 * (min(res[i]["t_first"] for i in served)
                        - min(res[i]["t_end"] for i in failed)) if failed and served else None
    retry, rwin = burst_window(torch, fa, engine, port, wire_spec, [work[i] for i in failed])
    launches += rwin["launches"]
    calls += check_calls(rwin, n_layers, label + " retry")
    retried_ok = all(r["status"] == wire_spec.STATUS_OK and r["tokens"] == unbroken[i]
                     for i, r in zip(failed, retry))
    st = engine.stats()
    broken = {k: v.get("breaker") for k, v in st["programs"].items()
              if v.get("breaker", {}).get("state", "closed") != "closed"
              or v.get("breaker", {}).get("trips", 0)}
    log(f"[robust] {label}: {len(failed)} streams in flight ended with status 2 (their tokens "
        f"a prefix of the unbroken run's: {prefix_ok}), {len(served)} queued ones served by "
        f"the replacement (bitwise: {whole_ok}), the {len(failed)} retried bitwise: "
        f"{retried_ok}; scheduler restarts {st['scheduler_restarts'] - st0['scheduler_restarts']}"
        f", superseded threads unwound {st['stale_unwinds'] - st0['stale_unwinds']}; "
        f"{calls} fill and step replays, K1 {launches} = {n_layers} x {calls}; captures "
        f"{st['compiles']} (before {st0['compiles']}), program failures "
        f"{st['program_failures']}; active {st['active']}, "
        f"{engine.health()['free_slots']}/{ENGINE_SLOTS} slots free; from the restart (the "
        f"first status 2) to the first token of a queued stream {restart_ms:.1f} ms; window "
        f"{win['window_ms']:.1f} ms")
    if (len(failed) != ENGINE_SLOTS or len(served) != len(work) - ENGINE_SLOTS
            or not (prefix_ok and whole_ok and retried_ok)):
        fail(f"{label}: the streams in flight, the queued ones or the retries misbehaved")
    if (st["scheduler_restarts"] != st0["scheduler_restarts"] + 1
            or st["programs"] != st0["programs"] or st["compiles"] != st0["compiles"]
            or broken or st["program_failures"] or st["active"]
            or engine.health()["free_slots"] != ENGINE_SLOTS):
        fail(f"{label}: no single restart, a program captured again, a breaker tripped or a "
             f"slot leaked: {broken}, {st['programs']}")
    return dict(win, restart_ms=restart_ms), launches


def metrics_cost_us(obs, rows=ENGINE_SLOTS, reps=2000):
    """Host us of the telemetry one decode step of ``rows`` untraced rows
    records (the step's counter, timer, summary row and occupancy; each
    row's gap and token), on instruments of the engine's kinds."""
    M = obs.metrics
    lat = M.log_buckets(0.0001, 4.0, 10)
    steps, timer = M.Counter("s_total", labelnames=("phase",)), M.Histogram(
        "s_seconds", labelnames=("phase",), buckets=lat)
    tokens, gaps = M.Counter("t_total"), M.Histogram("g_seconds", buckets=lat)
    occupancy = M.Histogram("o", buckets=(0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0))
    t0 = time.perf_counter()
    for _ in range(reps):
        steps.inc(phase="step")
        timer.observe(0.01, phase="step")
        obs.tracing.observe("chip_smoke.metrics_cost", 0.01)
        occupancy.observe(1.0)
        for _ in range(rows):
            gaps.observe(0.01)
            tokens.inc()
    return (time.perf_counter() - t0) / reps * 1e6


def phase_robust(torch, fa, mods, card, eng7, bert):
    """Phase 10 (module docstring) with phase 7's 7B weights and phase 4's
    BERT-base."""
    import gc
    import urllib.request

    generation, DecodeEngine, BatchingEngine, PredictorServer, wire_spec, chaos, obs = mods
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    model, dm7 = eng7["model"], eng7["dm"]
    n_layers = len(model.layers)
    vocab = model.embed_tokens.weight.shape[0]
    rng = np.random.RandomState(10)
    work = [dict(prompt=rng.randint(0, vocab, int(rng.randint(16, ENGINE_PROMPT + 1)))
                 .astype(np.int32), n=int(rng.randint(16, 65))) for _ in range(ROBUST_STREAMS)]
    engine = DecodeEngine(dm7, max_prompt_len=ENGINE_PROMPT, min_seq_bucket=ENGINE_CHUNK,
                          max_queue=64, watchdog_interval=ROBUST_INTERVAL,
                          wedge_timeout=ROBUST_WEDGE, name="llama-7b-robust")
    t = time.perf_counter()
    engine.warmup()
    server = PredictorServer(None, decode_engine=engine, own_decode_engine=True)
    log(f"[robust] Llama-2-7B bf16 engine of phase 7's configuration, watchdog every "
        f"{ROBUST_INTERVAL} s, wedge timeout {ROBUST_WEDGE} s; warmup {time.perf_counter() - t:.2f}"
        f" s, programs {sorted(engine.stats()['programs'])}")
    chaos.reset()
    launches = 0

    # the unbroken run
    res, win = burst_window(torch, fa, engine, server.port, wire_spec, work)
    launches += win["launches"]
    check_calls(win, n_layers, "unbroken run")
    if any(r["status"] != wire_spec.STATUS_OK or len(r["tokens"]) != w["n"]
           for r, w in zip(res, work)):
        fail("the unbroken run's streams are not whole")
    unbroken = [r["tokens"] for r in res]
    log(f"[robust] unbroken run: {ROBUST_STREAMS} streams, {sum(map(len, unbroken))} tokens in "
        f"{win['window_ms']:.1f} ms")

    # (a) a dead scheduler, (b) a wedged one
    dead, n = robust_faults(torch, fa, engine, server.port, wire_spec, chaos, work, unbroken,
                            n_layers, "(a) scheduler killed at serving.decode.loop",
                         "serving.decode.loop", 3, exc=RuntimeError("chaos: the scheduler dies"))
    launches += n
    stale0 = engine.stats()["stale_unwinds"]
    t_wedge = time.perf_counter()
    wedged, n = robust_faults(torch, fa, engine, server.port, wire_spec, chaos, work, unbroken,
                         n_layers, f"(b) step wedged {ROBUST_DELAY} s at serving.decode.step",
                         "serving.decode.step", 2, delay=ROBUST_DELAY)
    launches += n
    t_end = t_wedge + ROBUST_DELAY + 30
    while engine.stats()["stale_unwinds"] == stale0:
        if time.perf_counter() > t_end:
            fail("(b) the superseded scheduler never ended at its next program call")
        time.sleep(0.01)
    st = engine.stats()
    log(f"[robust] (b) the superseded thread woke and ended at its next call's generation check "
        f"(stale_unwinds {st['stale_unwinds']}), no replay after its generation ended: K1 and "
        f"replays above match the calls the replacement made")
    if st["stale_unwinds"] != stale0 + 1 or st["scheduler_restarts"] != 2:
        fail(f"(b) expected one superseded thread and two restarts in all: {st}")
    chaos.reset()

    # the BERT-base batching engine behind its own server (alive through
    # (c), whose scrape holds its families)
    def run(ids):
        with torch.inference_mode():
            return list(bert(torch.from_numpy(np.array(ids)).to("cuda")))

    bengine = BatchingEngine.for_callable(
        run, max_batch_size=8, max_wait_ms=20.0, max_queue=64, name="bert-robust",
        breaker_threshold=2, breaker_cooldown=600.0, watchdog_interval=ROBUST_INTERVAL,
        wedge_timeout=ROBUST_WEDGE)
    bengine.warmup(signature=[("int32", (128,))])
    bserver = PredictorServer(run, engine=bengine, own_engine=True)
    bert_layers = len(bert.encoder.layers)
    brng = np.random.RandomState(11)
    bvocab = bert.vocab_size
    reqs = {"A 1x128": brng.randint(0, bvocab, (1, 128)), "B 2x512": brng.randint(
        0, bvocab, (2, 512)), "C 3x256": brng.randint(0, bvocab, (3, 256)),
        "D 4x128": brng.randint(0, bvocab, (4, 128)), "E 2x128": brng.randint(0, bvocab, (2, 128))}
    reqs = {k: v.astype(np.int32) for k, v in reqs.items()}

    def infer(ids):
        status, payload = _call(bserver.port, wire_spec.build_request(
            wire_spec.CMD_INFER, wire_spec.encode_arrays([ids])))
        return status, (wire_spec.decode_arrays(payload) if status == wire_spec.STATUS_OK
                        else None)

    def fired_since(st0):
        return sum(x["batches"] for xs in bengine.stats()["buckets"].values() for x in xs) - sum(
            x["batches"] for xs in st0["buckets"].values() for x in xs)

    b0 = bengine.stats()
    fa.launches = 0  # (d)'s path: every batch, counted in two parts around (c)
    before = {k: infer(v) for k, v in reqs.items()}
    blaunches = fa.launches
    if any(s != wire_spec.STATUS_OK for s, _ in before.values()):
        fail(f"BERT requests before the faults failed: {[s for s, _ in before.values()]}")

    # (c) the decode telemetry over phase 7-style traffic, one stream traced
    def scrape():
        status, body = _call(server.port, wire_spec.build_request(wire_spec.CMD_METRICS))
        if status != wire_spec.STATUS_OK:
            fail(f"cmd 6 answered status {status}")
        return body.decode()

    eng_label = f'engine="{engine.name}"'
    obs.tracing.reset()
    tid = 0x5EED0A11
    # the step's and the fill's replays timed by CUDA events over the window
    keys = {"step": engine._step_key, "fill": ("fill", 1, ENGINE_CHUNK)}
    real = {p: engine._programs[k] for p, k in keys.items()}
    events = {p: [] for p in keys}

    def timed(phase):
        def run():
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            out = real[phase]()
            e.record()
            events[phase].append((s, e))
            return out
        return run

    m0 = parse_exposition(scrape())
    for p, k in keys.items():
        engine._programs[k] = timed(p)
    res, win = burst_window(torch, fa, engine, server.port, wire_spec, work, trace_id=tid)
    for p, k in keys.items():
        engine._programs[k] = real[p]
    launches += win["launches"]
    check_calls(win, n_layers, "(c) telemetry window")
    text = scrape()
    m1 = parse_exposition(text)
    with obs.MetricsServer() as ms:
        with urllib.request.urlopen(f"http://127.0.0.1:{ms.port}/metrics", timeout=60) as r:
            http = r.read().decode()
    parse_exposition(http)
    types = {line for line in text.splitlines() if line.startswith("# TYPE ")}
    http_types = {line for line in http.splitlines() if line.startswith("# TYPE ")}
    seen, dups = set(), set()
    for f in obs.REGISTRY.collect():  # the families before the exposition merges them
        for sfx, lab, _ in f.samples:
            k = (f.name + sfx, tuple(sorted(lab.items())))
            (dups if k in seen else seen).add(k)
    dups = sorted(dups)

    def d(name, **labels):
        lab = ",".join(f'{k}="{v}"' for k, v in sorted(dict(engine=engine.name, **labels)
                                                       .items()))
        return m1.get(f"{name}{{{lab}}}", 0.0) - m0.get(f"{name}{{{lab}}}", 0.0)

    streamed = sum(len(r["tokens"]) for r in res)
    served = sum(1 for r in res if r["status"] == wire_spec.STATUS_OK)
    step_mean = d("paddle_decode_step_seconds_sum", phase="step") / d(
        "paddle_decode_step_seconds_count", phase="step")
    fill_n = d("paddle_decode_step_seconds_count", phase="fill")
    fill_mean = d("paddle_decode_step_seconds_sum", phase="fill") / fill_n
    ev_median = {p: float(np.median([s.elapsed_time(e) for s, e in evs])) / 1e3
                 for p, evs in events.items()}
    cost_us = metrics_cost_us(obs)
    token_spans = obs.tracing.finished(name="serving.decode.token")
    traced = [s for s in token_spans if s["trace_id"] == tid]
    tps = d("paddle_decode_tokens_total") / win["window_ms"] * 1e3
    families = ("paddle_decode_tokens_total", "paddle_decode_ttft_seconds",
                "paddle_decode_intertoken_seconds", "paddle_decode_step_seconds",
                "paddle_decode_scheduler_restarts_total", "paddle_decode_compiles_total",
                "paddle_serving_requests_total", "paddle_serving_batch_exec_seconds",
                "paddle_server_frames_total", "paddle_server_responses_total",
                "paddle_server_connections_open", "paddle_server_stream_chunks_total")
    missing = [f for f in families if not any(t.startswith(f"# TYPE {f} ") for t in types)]
    log(f"[robust] (c) cmd 6 scrape: {len(m1)} series in {len(types)} families (the "
        f"/metrics scrape: {len(http_types)} families, the same: {types == http_types}), "
        f"missing {missing}, series repeated across collectors {dups}; the window streamed "
        f"{streamed} tokens, paddle_decode_tokens_total moved {d('paddle_decode_tokens_total'):.0f}"
        f"; {served} sequences served, paddle_decode_ttft_seconds_count moved "
        f"{d('paddle_decode_ttft_seconds_count'):.0f}; restarts in all "
        f"{m1.get(f'paddle_decode_scheduler_restarts_total{{{eng_label}}}')}")
    log(f"[robust] (c) paddle_decode_step_seconds{{phase=\"step\"}} mean {1e3 * step_mean:.3f} ms "
        f"over {d('paddle_decode_step_seconds_count', phase='step'):.0f} steps against the "
        f"window's CUDA-event median step replay {1e3 * ev_median['step']:.3f} ms "
        f"({len(events['step'])} steps): ratio {step_mean / ev_median['step']:.3f} (limit 1 +- "
        f"{STEP_TIMER_TOL}); fill phase mean {1e3 * fill_mean:.3f} ms over {fill_n:.0f} fills "
        f"against the median fill replay {1e3 * ev_median['fill']:.3f} ms: ratio "
        f"{fill_mean / ev_median['fill']:.3f} (recorded); the metrics' host cost of a "
        f"{ENGINE_SLOTS}-row step {cost_us:.1f} us, {cost_us / 10 / step_mean / 1e3:.3f}% of "
        f"the step timer's mean (recorded); the traced stream's "
        f"{len(res[0]['tokens'])} tokens gave {len(traced)} serving.decode.token spans under its"
        f" id, the untraced {len(token_spans) - len(traced)}; {tps:.1f} tokens/s over the window"
        f" (phase 7's window {eng7['tokens_per_s']:.1f}, recorded, not required) | {card}")
    if (missing or dups or types != http_types or served != ROBUST_STREAMS
            or d("paddle_decode_tokens_total") != streamed
            or d("paddle_decode_ttft_seconds_count") != served
            or abs(step_mean / ev_median["step"] - 1) > STEP_TIMER_TOL
            or len(traced) != len(res[0]["tokens"]) or len(token_spans) != len(traced)):
        fail("(c) the decode telemetry disagrees with the traffic it measured")

    # (d) the BERT engine: its scheduler killed with A in flight and B, C
    # queued behind it; then bucket 4 failed to its breaker's threshold
    # and quarantined while bucket 2 keeps serving
    out = {}

    def send(k):
        out[k] = infer(reqs[k])

    fa.launches = 0
    chaos.arm("serving.scheduler.loop", exc=RuntimeError("chaos: the scheduler dies"),
              at=chaos.visits("serving.scheduler.loop") + 1)
    threads = [threading.Thread(target=send, args=(k,)) for k in ("A 1x128", "B 2x512",
                                                                  "C 3x256")]
    for t in threads:
        t.start()
        time.sleep(0.005)  # A first: the group the dying scheduler holds
    for t in threads:
        t.join(300)
    retried = infer(reqs["A 1x128"])
    chaos.arm("serving.execute.bucket4", exc=RuntimeError("chaos: bucket 4 fails"), times=2,
              at=chaos.visits("serving.execute.bucket4") + 1)
    sick = [infer(reqs["D 4x128"])[0] for _ in range(3)]
    healthy = infer(reqs["E 2x128"])
    bst, bh = bengine.stats(), bengine.health()
    fired = fired_since(b0)
    blaunches += fa.launches
    same = {k: bool(out[k][0] == wire_spec.STATUS_OK and all(
        np.array_equal(a, b) for a, b in zip(out[k][1], before[k][1])))
        for k in ("B 2x512", "C 3x256")}
    same["A retried"] = bool(retried[0] == wire_spec.STATUS_OK and all(
        np.array_equal(a, b) for a, b in zip(retried[1], before["A 1x128"][1])))
    same["E"] = bool(healthy[0] == wire_spec.STATUS_OK and all(
        np.array_equal(a, b) for a, b in zip(healthy[1], before["E 2x128"][1])))
    log(f"[robust] (d) BERT-base batching engine: the scheduler killed holding A: statuses "
        f"{ {k: v[0] for k, v in out.items()} }, bitwise the replies before the fault "
        f"{same}; restarts {bst['scheduler_restarts']}; bucket 4 failed twice, then "
        f"statuses {sick} (quarantined buckets {bh['quarantined_buckets']}, shed "
        f"{bst['quarantine_shed']}); bucket 2 served; K1 {blaunches} = {bert_layers} x {fired} "
        "batches")
    if (out["A 1x128"][0] != wire_spec.STATUS_RETRYABLE or not all(same.values())
            or bst["scheduler_restarts"] != 1 or sick != [wire_spec.STATUS_ERROR] * 2
            + [wire_spec.STATUS_RETRYABLE] or bh["quarantined_buckets"] != [4]
            or blaunches != bert_layers * fired):
        fail("(d) the BERT engine's restart or quarantine misbehaved")
    launches += blaunches
    chaos.reset()
    bserver.stop()
    server.stop()
    if not (engine.health()["closed"] and bengine.health()["closed"]):
        fail("the robust phase's engines did not close")
    del engine, server, bengine, bserver
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[robust] the phase took {time.perf_counter() - t_phase:.1f} s")
    return dict(launches=launches, tokens_per_s=tps, step_timer_ratio=step_mean / ev_median[
        "step"], fill_timer_ratio=fill_mean / ev_median["fill"], metrics_cost_us=cost_us,
        dead_restart_ms=dead["restart_ms"], wedged_restart_ms=wedged["restart_ms"])


# ------------------------------------------------------------------ phase 11
# wq_matmul on Llama-2-7B's path, (K, N): the attention projections, gate
# and up, down, and the head (the step's only); M is 16 in a step (every
# slot) and C = 128 in a fill
QUANT_SHAPES = ((4096, 4096, "wq wk wv wo"), (4096, 11008, "gate up"), (11008, 4096, "down"),
                (4096, 32000, "head"))
QUANT_MS = (ENGINE_SLOTS, ENGINE_CHUNK)
QUANT_BITS_MS = (1, ENGINE_SLOTS, 37, ENGINE_CHUNK)  # a row's bits held the same at these M
TOL_WQ = 1e-4  # wq_matmul vs its plain version, relative to the output's max |value|
QUANT_MODE_ORDER = ("f32", "w8", "bf16w")
QUANT_SOLO = 3  # streams of each window decoded again alone
QUANT_LOGIT_PROMPTS = 4  # prompts whose finishing logits are held against f32's


def wq_bound_ms(m, k, n, wbytes, unit="tensor"):
    """Least time of one wq_matmul launch: x and the weights (and int8's
    scales) read once and the output written once, over the HBM rate; vs
    the operations of an f32-accurate product over their unit's peak. On
    the tensor cores (``unit="tensor"``, the kernel's) that is three bf16
    passes, 3 x 2 M K N (x split exactly into three bf16 pieces, each
    times exact bf16 weights); on the f32 CUDA cores (``"cuda_core"``, the
    bound of the kernel before its redesign) 2 M K N, an FMA a weight and
    row."""
    nbytes = 4 * m * k + k * n * wbytes + (4 * n if wbytes == 1 else 0) + 4 * m * n
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    if unit == "tensor":
        t_ops = 3 * 2 * m * k * n / PEAK_OPS_PER_S["bfloat16"] * 1e3
    else:
        t_ops = 2 * m * k * n / PEAK_OPS_PER_S["float32"] * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def graph_ms(torch, Graph, fn, calls=20, reps=5):
    """(CUDA-event ms over back-to-back calls, device ms) of one call of
    ``fn``. The device ms: ``calls`` calls captured in one CUDA graph
    (core/cuda_graph.py), replayed ``reps`` times between CUDA events, so
    no host time sits between the kernels. This late in the run the
    profiler's windows over such short calls often come back empty, and
    a graph needs no profiler."""
    ms = cuda_ms(torch, fn)

    def many():
        for _ in range(calls):
            fn()

    graph = Graph(many, torch.device("cuda"))
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return ms, start.elapsed_time(end) / (reps * calls)


def phase_quant_kernels(torch, qmm, quantize_array, Graph):
    """wq_matmul against its plain version (dequantize, then matmul) at
    every (M, K, N) of the quantized 7B path, int8 (w8) and bf16 (bf16w)
    weights; a row's bits must be the same in a 1-, 16-, 37- and 128-row
    call, and the built kernel's split count that of ``qmm.splits``. Timed
    beside the plain version and the library yardstick:
    torch.matmul of x with the weight already dequantized to float32, what
    the f32 engine pays per product (no single PyTorch call computes the
    dequantizing product; the port never calls this one with a reduced
    weight). Device times from CUDA graphs of 20 calls (``graph_ms``)."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    results = []
    log(f"[quant] wq_matmul vs its plain version (tolerance {TOL_WQ} of the output's max "
        "|value|); times: CUDA events over back-to-back calls / device (events around a CUDA "
        "graph of 20 calls)")
    log(f"[quant] dynamic shared memory per block: int8 weights "
        f"{qmm.smem_bytes(torch.int8)} bytes, bf16 {qmm.smem_bytes(torch.bfloat16)} bytes")
    for k, n, names in QUANT_SHAPES:
        splits = qmm.kernel_splits(k, n)
        log(f"[quant] K={k} N={n}: {splits} splits (a cluster of {splits} blocks per "
            f"{qmm.NT}-column tile; twin {qmm.splits(k, n)}), "
            f"{-(-n // qmm.NT) * splits} blocks at M <= 16")
        if splits != qmm.splits(k, n):
            fail(f"wq_matmul's split count at K={k} N={n} is not its twin's")
        w = torch.randn(k, n, device="cuda", generator=gen) * 0.02
        x_all = torch.randn(max(QUANT_BITS_MS), k, device="cuda", generator=gen)
        for form in ("w8", "bf16w"):
            if form == "w8":
                data, scale = quantize_array(w, channel_axis=1)
            else:
                data, scale = w.to(torch.bfloat16), None
            wdq = qmm.dequantize(data, scale)
            outs = {m: qmm.wq_matmul(x_all[:m], data, scale) for m in QUANT_BITS_MS}
            torch.cuda.synchronize()
            widest = outs[max(QUANT_BITS_MS)]
            same_bits = all(torch.equal(o, widest[:m]) for m, o in outs.items())
            for m in QUANT_MS:
                x = x_all[:m]
                out = outs[m]
                ref = qmm.wq_matmul_reference(x, data, scale)
                abs_err = (out - ref).abs().max().item()
                rel = abs_err / ref.abs().max().item()
                ms, dev = graph_ms(torch, Graph, lambda: qmm.wq_matmul(x, data, scale))
                plain_ms, plain_dev = graph_ms(
                    torch, Graph, lambda: qmm.wq_matmul_reference(x, data, scale))
                library_ms, library_dev = graph_ms(torch, Graph, lambda: torch.matmul(x, wdq))
                bound, bound_by = wq_bound_ms(m, k, n, data.element_size())
                core_bound, core_by = wq_bound_ms(m, k, n, data.element_size(), "cuda_core")
                ok = rel <= TOL_WQ and same_bits and bool(torch.isfinite(out).all())
                results.append(dict(form=form, m=m, k=k, n=n, names=names, splits=splits,
                                    max_abs_err=abs_err, rel_err=rel, same_bits_m=same_bits,
                                    ms=ms, device_ms=dev, plain_ms=plain_ms,
                                    plain_device_ms=plain_dev, library_ms=library_ms,
                                    library_device_ms=library_dev, bound_ms=bound,
                                    bound_by=bound_by, cuda_core_bound=core_bound,
                                    cuda_core_bound_by=core_by, ok=ok))
                log(f"  {form} M={m} K={k} N={n} ({names}): err {abs_err:.3e} ({rel:.2e} of "
                    f"max); row bits same at M = {', '.join(map(str, QUANT_BITS_MS))}: "
                    f"{same_bits} | kernel {ms:.4f} / {_fmt(dev)} ms{_share(bound, dev)}; "
                    f"plain {plain_ms:.4f} / {_fmt(plain_dev)} ms; library (torch.matmul, f32 "
                    f"weight) {library_ms:.4f} / {_fmt(library_dev)} ms; bound {bound:.4f} ms "
                    f"({bound_by}; cuda_core_bound {core_bound:.4f} ms, {core_by}) "
                    f"{'ok' if ok else 'DISAGREES'}")
            del wdq, data, scale
        del w, x_all
    if any(not r["ok"] for r in results):
        fail("wq_matmul disagrees with its plain version or changes a row's bits with M")
    return results


def quant_window(torch, fa, qmm, engine, mods, base, n_layers, mode):
    """One quantized (or f32) 7B engine behind PredictorServer serving
    phase 7's streams, its step and fill replays timed by CUDA events;
    the checks of phase 7's (a) and (d), the launches of both kernels, the
    programs and breakers, and the mode's labels. Returns (the streams,
    the server, the window, the requests, the events' medians)."""
    PredictorServer, wire_spec, obs = mods
    keys = {"step": engine._step_key, "fill": ("fill", 1, ENGINE_CHUNK)}
    real = {p: engine._programs[key] for p, key in keys.items()}
    events = {p: [] for p in keys}

    def timed_run(phase):
        def run():
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            out = real[phase]()
            e.record()
            events[phase].append((s, e))
            return out
        return run

    for p, key in keys.items():
        engine._programs[key] = timed_run(p)
    work, server, win, requests = serve_window(torch, fa, engine, PredictorServer, wire_spec,
                                               base, qmm=qmm)
    for p, key in keys.items():
        engine._programs[key] = real[p]
    n_streams = ENGINE_FIRST + ENGINE_LATER
    hang, tiny, oneshot = work[n_streams:]
    st, delta = win["stats"], win["delta"]
    bad = [i for i, w in enumerate(work[:n_streams])
           if (w["statuses"][-1] != wire_spec.STATUS_OK
               or any(x != wire_spec.STATUS_STREAM for x in w["statuses"][:-1])
               or w["tokens"].size != w["n"] or w["tokens"].dtype != np.int32)]
    fills, steps = delta["prefix_fill_steps"], delta["steps"]
    want_k1 = n_layers * (fills + steps)
    per_step, per_fill = 7 * n_layers + 1, 7 * n_layers  # 7 products a layer, the head
    want_wq = 0 if mode == "f32" else per_step * steps + per_fill * fills
    broken = {k: v["breaker"] for k, v in st["programs"].items()
              if v.get("breaker", {}).get("state", "closed") != "closed"
              or v.get("breaker", {}).get("trips", 0)}
    line = next((ln for ln in obs.render().splitlines()
                 if ln.startswith("paddle_decode_compiles_total{")
                 and f'engine="{engine.name}"' in ln), "")
    labelled = st["quant"] == mode and f'quant="{mode}"' in line
    log(f"[quant] {mode}: {n_streams - len(bad)}/{n_streams} streams well formed with exactly "
        f"their max_new_tokens; one-shot {oneshot['statuses']}, 1 ms budget {tiny['statuses']},"
        f" hung up after {len(hang['chunks'])} chunk(s); {fills} fill replays, {steps} steps; "
        f"K1 {win['launches']} (expected {want_k1}), wq_matmul {win['wq_launches']} (expected "
        f"{want_wq} = {per_step} x {steps} + {per_fill} x {fills}); graph replays "
        f"{delta['graph_replays']}; programs {st['programs']}; stats quant {st['quant']!r}, "
        f"the compiles' label {line.split('{')[1].split('}')[0] if line else None}")
    if (bad or oneshot["statuses"] != [wire_spec.STATUS_OK]
            or tiny["statuses"] != [wire_spec.STATUS_RETRYABLE] or len(hang["chunks"]) != 4):
        fail(f"{mode}: decode streams malformed (streams {bad}) or the extras misbehaved")
    if (win["launches"] != want_k1 or delta["k1_launches"] != want_k1
            or win["wq_launches"] != want_wq or delta["graph_replays"] != fills + steps
            or any(v["compiles"] != 1 for v in st["programs"].values())):
        fail(f"{mode}: the kernels' launches, the replays or the captures do not match the "
             "engine's fill and step calls")
    if broken or st["program_failures"] or st["quarantine_shed"] or not labelled:
        fail(f"{mode}: a breaker tripped ({broken}), a program failed, or the quant mode is "
             "not on the stats and the metrics")
    medians = {p: float(np.median([s.elapsed_time(e) for s, e in evs])) for p, evs in
               events.items()}
    return work, server, win, requests, medians


def phase_quant(torch, fa, qmm, mods, card, eng7, serving):
    """Phase 11 (module docstring): quantized decode serving of an f32
    Llama-2-7B, then BERT-base w8 through the batching engine."""
    import gc

    (LlamaModel, generation, DecodeEngine, BatchingEngine, PredictorServer, wire_spec, obs,
     quantization, Graph) = mods
    from paddle_tpu_torch.quantization import post_training
    from paddle_tpu_torch.quantization.post_training import Int8Linear, _quantize_array
    from paddle_tpu_torch.quantization.serving import weight_bytes

    t_phase = time.perf_counter()
    kcases = phase_quant_kernels(torch, qmm, _quantize_array, Graph)
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    model = LlamaModel(device="cuda", generator=torch.Generator(device="cuda").manual_seed(0))
    model.eval()
    n_layers = len(model.layers)
    dm = generation.llama_decode_model(model, ENGINE_SLOTS, ENGINE_SEQ)
    torch.cuda.synchronize()
    log(f"[quant] Llama-2-7B float32 (weights from seed 0, {weight_bytes(dm.params) / 1e9:.2f} "
        f"GB), built in {time.perf_counter() - t:.1f} s; engines of phase 7's configuration "
        f"({ENGINE_SLOTS} slots x {ENGINE_SEQ}, C = {ENGINE_CHUNK}) one mode at a time, "
        f"{', then '.join(QUANT_MODE_ORDER)}")
    base = eng7["base"]
    n_streams = ENGINE_FIRST + ENGINE_LATER
    logit_prompts = [w["prompt"] for w in base[:QUANT_LOGIT_PROMPTS]]
    modes, f32_logits, w8_snap = {}, None, None
    launches = wq_launches = 0
    for mode in QUANT_MODE_ORDER:
        t = time.perf_counter()
        engine = DecodeEngine(dm, max_prompt_len=ENGINE_PROMPT, min_seq_bucket=ENGINE_CHUNK,
                              max_queue=64, name=f"llama-7b-{mode}", quant=mode)
        quantize_s = time.perf_counter() - t
        t = time.perf_counter()
        engine.warmup()
        torch.cuda.synchronize()
        st0 = engine.stats()
        wbytes = weight_bytes(engine._model.params)
        log(f"[quant] {mode}: weights {wbytes / 1e9:.3f} GB (weight_bytes), quantized in "
            f"{quantize_s:.2f} s; warmup {time.perf_counter() - t:.2f} s (captures "
            + ", ".join(f"{k} {v['capture_ms']:.1f} ms" for k, v in st0["programs"].items())
            + f"; the weights digest {st0['weights_digest_ms']:.1f} ms); KV pools "
            f"{st0['kv_pool_bytes'] / 1e9:.2f} GB ({engine._model.kv_spec[0][1]}); peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        work, server, win, requests, medians = quant_window(
            torch, fa, qmm, engine, (PredictorServer, wire_spec, obs), base, n_layers, mode)
        launches += win["launches"]
        wq_launches += win["wq_launches"]
        delta, st = win["delta"], win["stats"]
        # solo = batch: three streams decoded again alone, bitwise
        for w in work[:n_streams]:
            req = next(r for r in requests if r.prompt.size == w["prompt"].size
                       and np.array_equal(r.prompt, w["prompt"]))
            w["peak_batch"] = req.peak_batch
        full = [w for w in work[:ENGINE_FIRST] if w["peak_batch"] == ENGINE_SLOTS]
        if not full:
            fail(f"{mode}: no first-wave sequence ran in a full batch of {ENGINE_SLOTS}")
        picks = {"the longest prompt": max(work[:n_streams], key=lambda w: w["prompt"].size),
                 "joined mid-flight": work[ENGINE_FIRST],
                 f"ran beside {ENGINE_SLOTS - 1} others": max(full, key=lambda w: w["n"])}
        solo = {label: bool(np.array_equal(
            engine.generate(w["prompt"], max_new_tokens=w["n"], timeout=600), w["tokens"]))
            for label, w in list(picks.items())[:QUANT_SOLO]}
        log(f"[quant] {mode}: decoded again alone, bitwise the window's tokens: {solo}")
        if not all(solo.values()):
            fail(f"{mode}: a sequence decoded alone differs from the same sequence in the batch")
        # the finishing logits against the f32 engine's (the reference's measure)
        logits = [generation.llama_prompt_logits(engine._model, p) for p in logit_prompts]
        rel = None
        if mode == "f32":
            f32_logits = logits
        else:
            rel = max(((a - b).abs().max() / b.abs().max()).item()
                      for a, b in zip(logits, f32_logits))
            bound = quantization.ACCURACY_BOUNDS[mode]
            log(f"[quant] {mode}: the last prompt token's logits of {len(logits)} prompts "
                f"against the f32 model's: max|d| / max|f32| = {rel:.3e} (bound {bound})")
            if not rel < bound:
                fail(f"{mode}: logits beyond ACCURACY_BOUNDS[{mode!r}] of the f32 model's")
        # quant skew: a w8 snapshot (the handoff of a 16-token prompt) is
        # refused with status 2 by the f32 and the bf16w engines
        if mode == "w8":
            prompt = base[0]["prompt"][:16]
            frames, _, _ = _frames(wire_spec, server.port, wire_spec.build_request(
                wire_spec.CMD_INFER, wire_spec.encode_arrays([prompt])
                + wire_spec.encode_decode_opts(8, handoff=True)))
            _, _, snaps = _split(wire_spec, frames)
            if len(snaps) != 1:
                fail(f"w8: the handoff gave {len(snaps)} snapshots")
            w8_snap = snaps[0]
            f32_engine = DecodeEngine(dm, max_prompt_len=ENGINE_PROMPT,
                                      min_seq_bucket=ENGINE_CHUNK, name="llama-7b-f32-identity")
            f32_server = PredictorServer(None, decode_engine=f32_engine,
                                         own_decode_engine=True)
            pst, _ = _call(f32_server.port, wire_spec.build_request(wire_spec.CMD_KV_PUT,
                                                                    w8_snap))
            f32_server.stop()
            del f32_engine, f32_server
            log(f"[quant] a w8 snapshot ({len(w8_snap)} bytes, header quant "
                f"{wire_spec.decode_kv_snapshot_header(w8_snap)['quant']!r}) put to an f32 "
                f"engine: status {pst}")
            if pst != wire_spec.STATUS_RETRYABLE:
                fail("an f32 engine did not refuse a w8 snapshot with status 2")
        if mode == "bf16w":
            pst, _ = _call(server.port, wire_spec.build_request(wire_spec.CMD_KV_PUT, w8_snap))
            log(f"[quant] the w8 snapshot put to the bf16w engine: status {pst}")
            if pst != wire_spec.STATUS_RETRYABLE:
                fail("the bf16w engine did not refuse a w8 snapshot with status 2")
        # one step replay at the window's mean cache length, profiled
        mean_len = (sum(sum(w["prompt"].size + i for i in range(w["tokens"].size))
                        for w in work[:n_streams])
                    / sum(w["tokens"].size for w in work[:n_streams]))
        key = engine._step_key
        with torch.inference_mode(), engine._exec_lock:
            tokens, pos, _ = engine._graphs.inputs(key)
            tokens.zero_()
            pos.fill_(int(mean_len) - 1)
            run = engine._program(key)
            step_ms, busy, kernels, k1 = profile_replay(
                torch, lambda: run().cpu(), f"{mode}: one step replayed, {ENGINE_SLOTS} rows at "
                f"cache length {int(mean_len)}", n_layers)
        idle = f"{100 * (1 - busy / step_ms):.1f}%" if busy > 0 else "not measured"
        tps = delta["tokens"] / win["window_ms"] * 1e3
        modes[mode] = dict(tokens_per_s=tps, step_ms=medians["step"], fill_ms=medians["fill"],
                           kernel_ms=busy, idle=idle, weight_bytes=wbytes, logit_rel=rel,
                           digest_ms=st["weights_digest_ms"], fills=delta["prefix_fill_steps"],
                           steps=delta["steps"], k1_step=n_layers * delta["steps"],
                           k1_fill=n_layers * delta["prefix_fill_steps"], kernels=kernels)
        log(f"[quant] {mode}: {delta['tokens']} tokens in {win['window_ms']:.1f} ms by CUDA "
            f"events = {tps:.1f} tokens/s; median step replay {medians['step']:.3f} ms, median "
            f"fill replay {medians['fill']:.3f} ms (CUDA events); a profiled step replay "
            f"{_fmt(busy)} ms of kernels ({kernels} kernels, K1 records {k1}), device idle "
            f"{idle}; weights {wbytes} bytes; the weights digest {st['weights_digest_ms']:.1f} "
            f"ms | {card}")
        stop_server(server, engine, wire_spec)
        del engine, server, work, requests
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[quant] {mode}: its engine's part of the phase took {time.perf_counter() - t:.1f} s")
    del model, dm
    gc.collect()
    torch.cuda.empty_cache()

    # BERT-base, phase 4's weights converted in place, through the batching engine
    bert, replies = serving["model"], serving["replies"]
    t = time.perf_counter()
    _, scales = quantization.quantize_weights(bert)
    n_int8 = sum(isinstance(m, Int8Linear) for m in bert.modules())
    bert_layers = len(bert.encoder.layers)

    def run(ids):
        with torch.inference_mode():
            return list(bert(torch.from_numpy(np.array(ids)).to("cuda")))

    bengine = BatchingEngine.for_callable(run, max_batch_size=8, max_wait_ms=20.0,
                                          max_queue=64, name="bert-w8")
    for seq in (128, 512):
        bengine.warmup(signature=[("int32", (seq,))])
    bserver = PredictorServer(run, engine=bengine, own_engine=True)
    b0 = sum(x["batches"] for xs in bengine.stats()["buckets"].values() for x in xs)
    fa.launches = qmm.launches = 0
    served = []
    for ids, _ in replies:
        status, payload = _call(bserver.port, wire_spec.build_request(
            wire_spec.CMD_INFER, wire_spec.encode_arrays([ids])))
        if status != wire_spec.STATUS_OK:
            fail(f"BERT w8: a request answered status {status}")
        served.append(wire_spec.decode_arrays(payload))
    fired = sum(x["batches"] for xs in bengine.stats()["buckets"].values() for x in xs) - b0
    bk1, bwq = fa.launches, qmm.launches
    bserver.stop()
    # the same requests through the same quantized BERT on the card with
    # the kernel's plain version in its place: the kernel held at BERT's
    # shapes (M = rows x seq, K x N of 768 x 768, 768 x 3072, 3072 x 768)
    # within TOL_WQ of the output's max, and the quantization's own error
    # against the f32 replies, beside the kernel path's
    post_training.wq_matmul = qmm.wq_matmul_reference
    try:
        plain = [[o.cpu().numpy() for o in run(ids)] for ids, _ in replies]
    finally:
        post_training.wq_matmul = qmm.wq_matmul
    if qmm.launches != bwq:
        fail("BERT w8: the plain run launched wq_matmul")

    def worst_rel(outs, refs):  # per output (sequence, pooled): max over requests
        return [max(float(np.abs(o[i] - r[i]).max() / np.abs(r[i]).max())
                    for o, r in zip(outs, refs)) for i in range(2)]

    f32 = [outs for _, outs in replies]
    worst, plain_worst, kernel_plain = (worst_rel(served, f32), worst_rel(plain, f32),
                                        worst_rel(served, plain))
    # the sequence output is held to ACCURACY_BOUNDS["w8"] (the reference's
    # bound, measured on its one- and two-layer toys); the pooled output, one
    # more quantized product and a tanh past 12 quantized layers, to the
    # reference's documented w8 bound for its depth, 2 x depth / 127
    # (quantization/serving.py's module docstring); the kernel path to the
    # plain path within TOL_WQ
    bounds = (quantization.ACCURACY_BOUNDS["w8"], 2 * (bert_layers + 1) / 127)
    log(f"[quant] BERT-base w8 ({n_int8} Int8Linear, {len(scales)} scale sets) through the "
        f"batching engine: {len(replies)} of phase 4's requests in {fired} batches; "
        f"max|d| / max|f32| against phase 4's f32 replies: sequence output {worst[0]:.3e} "
        f"(bound ACCURACY_BOUNDS['w8'] {bounds[0]}), pooled output {worst[1]:.3e} (bound 2 x "
        f"{bert_layers + 1} / 127 = {bounds[1]:.3f}); the plain path's (wq_matmul_reference "
        f"on the card) {plain_worst[0]:.3e} and {plain_worst[1]:.3e}; the kernel path against "
        f"the plain path {kernel_plain[0]:.3e} and {kernel_plain[1]:.3e} of max (tolerance "
        f"{TOL_WQ}); wq_matmul {bwq} = {n_int8} x {fired}, K1 {bk1} = {bert_layers} x "
        f"{fired}; {time.perf_counter() - t:.1f} s")
    if (worst[0] >= bounds[0] or worst[1] >= bounds[1] or max(kernel_plain) > TOL_WQ
            or bwq != n_int8 * fired or bk1 != bert_layers * fired):
        fail("BERT w8: replies beyond the accuracy bounds, the kernel path off its plain "
             "version, or the kernels' launches do not match the batches")
    log(f"[quant] the phase took {time.perf_counter() - t_phase:.1f} s")
    return dict(kernel_cases=kcases, modes=modes, launches=launches + bk1,
                wq_launches=wq_launches + bwq, bert_wq_launches=bwq, bert_rel=worst,
                bert_plain_rel=plain_worst, bert_kernel_plain=kernel_plain)


# ----------------------------------------------------------------- phase 12
# Transformer-base (Vaswani et al. 2017, "Attention Is All You Need",
# Table 3 "base": nn.Transformer's defaults) translating by beam search:
# the WMT14 en-de shared BPE vocabulary of 37,000 tokens (§5.1), tied
# embedding and output projection scaled by sqrt(d_model) (§3.4),
# sinusoidal positions (§3.5), beam 4, at most source + 50 tokens (§6.1)
MT_VOCAB, MT_SRC, MT_BEAM, MT_EXTRA = 37000, 64, 4, 50
MT_BOS, MT_EOS, MT_PAD = 0, 1, 2  # source tokens are drawn from 3..vocab-1
MT_BATCH = 16  # the throughput run: 16 sentences x 64 tokens
MT_TIE = 1e-4  # (a): a near-tie, two neighbours of a step's beam + 1 best CPU candidates
TOL_MT_SCORE = 1e-4  # (a): final scores, card vs CPU, relative
TOL_MT_INCR = 1e-4  # (b): incremental vs full logits, of the row's max |logit|
# a translation step's kernels: the flash kernel, the products, the cache
# concat, the state reorder and the beam selection apart
MT_GROUPS = KERNEL_GROUPS[:1] + KERNEL_GROUPS[3:4] + (
    # torch.cat: the self-attention K/V caches, and the fused QKV weight
    ("concat (K/V caches; the fused QKV weight)", ("CatArrayBatchedCopy", "cat_", "Cat")),
    # index_select's kernel, which embedding lookups run too (a step's one)
    ("state reorder (index_select), embedding rows", ("vectorized_gather_kernel",
                                                      "indexSelect", "index_select")),
    ("beam selection (topk)", ("topk", "TopK", "Topk", "sort", "Sort", "radix")),
)


def sinusoid_table(n, d):
    """[n, d] float32 sinusoidal positions: sin on the even channels, cos
    on the odd ones, at wavelengths 10000^(i / d)."""
    angle = np.arange(n)[:, None] / np.power(10000.0, np.arange(0, d, 2)[None, :] / d)
    table = np.zeros((n, d), np.float32)
    table[:, 0::2] = np.sin(angle)
    table[:, 1::2] = np.cos(angle)
    return table


class TranslationCell:
    """A Transformer decoder as a beam-search cell, the kind of cell
    Paddle's translation examples define: [rows] token ids in, the
    decoder's output at that position out. Its states are one ((k, v),
    (static_k, static_v)) tuple of tensors per layer (dynamic_decode maps
    tensors, not objects), rebuilt here into MultiHeadAttention's Cache
    and StaticCache. A step's position is its incremental cache's length;
    the token embedding is scaled by sqrt(d_model) and the position added.
    ``memory_mask`` (or None) is already tiled to the rows."""

    def __init__(self, decoder, embed, pos, memory_mask=None):
        self.decoder = decoder
        self.embed = embed
        self.pos = pos
        self.memory_mask = memory_mask
        attn = decoder.layers[0].self_attn
        self.mha = type(attn)
        self.scale = attn.embed_dim ** 0.5

    def __call__(self, ids, states):
        t = states[0][0][0].shape[2]
        x = self.embed(ids[:, None]) * self.scale + self.pos[t]
        caches = [(self.mha.Cache(*inc), self.mha.StaticCache(*st)) for inc, st in states]
        out, new = self.decoder(x, None, None, self.memory_mask, caches)
        return out[:, -1], tuple(((c.k, c.v), (s.k, s.v)) for c, s in new)


def translation_states(decoder, memory):
    """The decoder's initial states over ``memory`` as tuples of tensors."""
    return tuple(((c.k, c.v), (s.k, s.v)) for c, s in decoder.gen_cache(memory))


MT_POSITIONS = 2 * (MT_SRC + MT_EXTRA)  # rows of the sinusoid table


def translation_model(torch, nn, device, generator=None, vocab=MT_VOCAB, src_len=MT_SRC,
                      max_len=MT_POSITIONS, **cfg):
    """Transformer-base for translation, shared by phase 12 (beam search)
    and phase 14 (training): ``nn.Transformer(**cfg)`` (its defaults are
    the base model), a ``vocab``-token embedding scaled by sqrt(d_model) on
    the way in (§3.4) and tied to the output projection, sinusoidal
    positions (§3.5, ``sinusoid_table``) and dropout ``cfg["dropout"]``
    (0.1) on their sum (§5.4). Weights from ``generator``: each 2-D weight
    of the stacks normal(0, sqrt(2 / (fan_in + fan_out))), so each layer
    has its own (the stacks start as copies of one layer), the embedding
    normal(0, d_model^-0.5). ``forward(packed)`` trains by teacher forcing:
    ``packed`` [B, src_len + T] holds the source ids, then the decoder's T
    input ids; it returns the logits [B, T, vocab]. ``.transformer``,
    ``.embed`` and ``.pos(device)`` are what ``translate`` takes."""
    from paddle_tpu_torch.ops import torch_ops as pt

    class TranslationModel(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.transformer = nn.Transformer(**cfg, device=device, generator=generator)
            with torch.no_grad():
                for p in self.transformer.parameters():
                    if p.dim() == 2:
                        p.normal_(0.0, (2.0 / sum(p.shape)) ** 0.5, generator=generator)
            d = self.transformer.d_model
            self.embed = nn.Embedding(vocab, d, device=device, generator=generator)
            with torch.no_grad():
                self.embed.weight.normal_(0.0, d ** -0.5, generator=generator)
            self.scale = d ** 0.5
            self.src_len = src_len
            self.dropout = cfg.get("dropout", 0.1)
            # the positions are no parameter and no buffer (the training
            # step takes no buffers): one copy per device, made at first use
            self.table = sinusoid_table(max_len, d)
            self._pos = {}

        def pos(self, device):
            key = str(torch.device(device))
            if key not in self._pos:
                self._pos[key] = torch.from_numpy(self.table).to(device)
            return self._pos[key]

        def inputs(self, ids):
            x = self.embed(ids) * self.scale + self.pos(ids.device)[:ids.shape[1]]
            return nn.functional.dropout(x, self.dropout, training=self.training)

        def forward(self, packed):
            src, tgt = packed[:, :self.src_len], packed[:, self.src_len:]
            memory = self.transformer.encoder(self.inputs(src))
            mask = nn.Transformer.generate_square_subsequent_mask(tgt.shape[1],
                                                                  device=tgt.device)
            out = self.transformer.decoder(self.inputs(tgt), memory, mask)
            return pt.matmul(out, self.embed.weight, transpose_y=True)

    return TranslationModel()


def encode(model, embed, pos, src, src_mask=None):
    """The encoder's memory of source ids [B, S]."""
    x = embed(src) * (model.d_model ** 0.5) + pos[:src.shape[1]]
    return model.encoder(x, src_mask)


def translate(nn, model, embed, pos, src, src_mask=None, beam=MT_BEAM, max_steps=None,
              on_step=None, output_fn=None):
    """Beam search over source ids [B, S] (``src_mask`` [B, 1, 1, S], true
    where a token is real): (BeamSearchOutput, final states, lengths).
    ``on_step(ids)`` runs before each decoder step; ``output_fn`` maps the
    decoder's output to logits (the tied embedding's product by default)."""
    memory = encode(model, embed, pos, src, src_mask)
    mmask = None if src_mask is None else src_mask.repeat_interleave(beam, dim=0)
    cell = TranslationCell(model.decoder, embed, pos, mmask)
    dec = nn.BeamSearchDecoder(cell, MT_BOS, MT_EOS, beam,
                               output_fn=output_fn or (lambda h: h @ embed.weight.T))
    if on_step is not None:
        step = dec._step

        def _step(ids, states):
            on_step(ids)
            return step(ids, states)
        dec._step = _step
    return nn.dynamic_decode(dec, inits=translation_states(model.decoder, memory),
                             max_step_num=max_steps or src.shape[1] + MT_EXTRA,
                             return_length=True)


def replay_selection(torch, decode_mod, logits, batch, beam, end_token):
    """dynamic_decode's selection replayed over recorded logits (one [B *
    beam, V] tensor a step, on the CPU): (tokens, parents [T, B, beam],
    gaps [T, B]). A step's gap is the least relative distance between two
    neighbours among its beam + 1 best candidates: the beam-th and the
    beam+1-th decide what is kept, and two inside the beam its order (a
    swap there renumbers the beams)."""
    scores = torch.full((batch, beam), -1e9)
    scores[:, 0] = 0.0
    finished = torch.zeros((batch, beam), dtype=torch.bool)
    toks, pars, gaps = [], [], []
    for lg in logits:
        v = lg.shape[-1]
        logp = (lg - decode_mod._logsumexp(lg)).reshape(batch, beam, v)
        eos_only = torch.full((v,), -1e9)
        eos_only[end_token] = 0.0
        logp = torch.where(finished[:, :, None], eos_only, logp)
        vals, top = torch.topk((scores[:, :, None] + logp).reshape(batch, beam * v), beam + 1,
                               dim=1)
        gaps.append(((vals[:, :-1] - vals[:, 1:]).abs() / vals[:, :-1].abs()).amin(dim=1))
        scores, top = vals[:, :beam], top[:, :beam]
        parents, tokens = top // v, top % v
        finished = torch.gather(finished, 1, parents) | (tokens == end_token)
        toks.append(tokens)
        pars.append(parents)
    return torch.stack(toks), torch.stack(pars), torch.stack(gaps)


def raw_tokens(torch, fed, final):
    """Each step's own tokens [T, B, beam]: the ids fed to steps 1..T-1
    (``fed``, one [B * beam] tensor a step from step 0) and the last
    step's, which gather_tree leaves in place (``final`` [T, B, beam])."""
    b, beam = final.shape[1], final.shape[2]
    return torch.stack([f.reshape(b, beam) for f in fed[1:]] + [final[-1]])


def mt_step_cost(rows, t, src, layers, d, ffn, vocab):
    """(bytes, operations) of one float32 decode step at cache length t:
    the step's weights (self-attention q/k/v/out, cross-attention q/out,
    the FFN, the norms; the tied projection) read once, the K/V caches
    read by attention (t rows self, src rows cross), the concat (t - 1
    rows read, t written) and the reorder (every cache read and written);
    operations: 2 per weight a row, 4 * d per attention pair."""
    w = layers * (6 * d * d + 2 * d * ffn + 13 * d + ffn) + vocab * d
    cache = layers * 2 * rows * d * 4
    nbytes = (4 * w + cache * (t + src) + cache * (2 * t - 1) + 2 * cache * (t + src)
              + 4 * rows * (d + vocab))
    ops = 2 * rows * w + 4 * rows * layers * d * (t + src)
    return nbytes, ops


def phase_translation(torch, fa, nn, card):
    """Phase 12 (module docstring): Transformer-base translating by beam
    search, float32, weights from seed 0."""
    from paddle_tpu_torch.nn import decode as decode_mod

    t_phase = time.perf_counter()
    torch.set_num_threads(os.cpu_count() or 1)
    rng = np.random.RandomState(0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    t = time.perf_counter()
    tm = translation_model(torch, nn, "cuda", gen).eval()
    model, embed, pos = tm.transformer, tm.embed, tm.pos("cuda")
    layers, d = model.decoder.num_layers, model.d_model
    heads, ffn = model.nhead, model.decoder.layers[0].linear1.weight.shape[1]
    n_params = sum(p.numel() for p in model.parameters()) + embed.weight.numel()
    max_steps = MT_SRC + MT_EXTRA
    log(f"[translation] Transformer-base: {model.encoder.num_layers} + {layers} layers, "
        f"d_model {d}, {heads} heads, FFN {ffn}, vocab {MT_VOCAB} tied, {n_params} parameters "
        f"(float32, seed 0), built in {time.perf_counter() - t:.1f} s; beam {MT_BEAM}, at most "
        f"{max_steps} steps")

    def src_ids(n, lengths=None):
        ids = rng.randint(3, MT_VOCAB, (n, MT_SRC))
        if lengths is not None:
            ids[np.arange(MT_SRC)[None, :] >= np.asarray(lengths)[:, None]] = MT_PAD
        return torch.from_numpy(ids)

    # (a) the card against the CPU at full width and depth; (c) its launches
    t = time.perf_counter()
    src = src_ids(2)
    fed = []
    with torch.inference_mode():
        torch.cuda.synchronize()
        fa.launches = 0
        out, _, lens = translate(nn, model, embed, pos, src.cuda(),
                                 on_step=lambda ids: fed.append(ids.cpu()))
        torch.cuda.synchronize()
        k1 = fa.launches
    card_s = time.perf_counter() - t
    steps = out.parent_ids.shape[0]
    card_final = out.predicted_ids.transpose(0, 1).cpu()  # [T, B, beam]
    card_tokens = raw_tokens(torch, fed, card_final)
    cpu_model = copy.deepcopy(model).to("cpu")
    cpu_embed = copy.deepcopy(embed).to("cpu")
    cpu_logits = []

    def record(h):
        lg = h @ cpu_embed.weight.T
        cpu_logits.append(lg)
        return lg
    t = time.perf_counter()
    with torch.inference_mode():
        cout, _, clens = translate(nn, cpu_model, cpu_embed, pos.cpu(), src, output_fn=record)
    cpu_s = time.perf_counter() - t
    tokens, parents, gaps = replay_selection(torch, decode_mod, cpu_logits, 2, MT_BEAM, MT_EOS)
    if not (torch.equal(parents, cout.parent_ids)
            and torch.equal(nn.functional.gather_tree(tokens, parents),
                            cout.predicted_ids.transpose(0, 1))):
        fail("translation (a): the replayed selection does not give the CPU run's beams")
    # a sentence is held whole, or up to its first near-tie of the CPU's
    # candidates (its steps from there on may differ, and so may the
    # number of steps, which ends when every beam has finished); where
    # the runs agree throughout, their final scores are held too
    whole = steps == tokens.shape[0]
    worst_score, excused, agree, whole_rows = 0.0, [], True, 0
    for b in range(2):
        near = (gaps[:, b] < MT_TIE).nonzero()
        k = int(near[0]) if len(near) else None
        n = min(tokens.shape[0] if k is None else k, steps, tokens.shape[0])
        agree = agree and torch.equal(card_tokens[:n, b], tokens[:n, b]) and torch.equal(
            out.parent_ids[:n, b].cpu(), parents[:n, b])
        same = whole and torch.equal(card_tokens[:, b], tokens[:, b]) and torch.equal(
            out.parent_ids[:, b].cpu(), parents[:, b])
        if same:
            whole_rows += 1
            rel = ((out.scores[b].cpu() - cout.scores[b]).abs()
                   / cout.scores[b].abs()).max().item()
            worst_score = max(worst_score, rel)
            agree = agree and rel <= TOL_MT_SCORE
        if k is None:
            agree = agree and same
        else:
            excused.append((b, k, gaps[k, b].item()))
    log(f"[translation] (a) 2 x {MT_SRC} tokens, beam {MT_BEAM}: {steps} steps on the card "
        f"({card_s:.2f} s) and {tokens.shape[0]} on the CPU ({cpu_s:.2f} s); tokens and parents "
        f"equal {agree}; near-ties (sentence, step, gap: two neighbours among the CPU's "
        f"{MT_BEAM + 1} best candidates within {MT_TIE}): "
        f"{excused or 'none'}; {whole_rows} of 2 sentences equal at every step, their final "
        f"scores max rel err {worst_score:.3e} (tolerance {TOL_MT_SCORE}); lengths "
        f"{lens.tolist()} | {card}")
    if not agree or not torch.isfinite(out.scores).all():
        fail("translation (a): the card's beams disagree with the CPU's")
    want = layers + 2 * layers * steps
    log(f"[translation] (c) K1 launches {k1} (want {layers} encoder + {2 * layers} x {steps} "
        f"steps = {want})")
    if k1 != want:
        fail("translation (c): K1 was not launched once per unmasked attention")

    # (b) incremental = full for sentence 0's best beam
    y = out.predicted_ids[0, :, 0]
    with torch.inference_mode():
        memory = encode(model, embed, pos, src[:1].cuda())
        cell = TranslationCell(model.decoder, embed, pos)
        states = translation_states(model.decoder, memory)
        ids = torch.full((1,), MT_BOS, dtype=torch.int64, device="cuda")
        fa.launches = 0
        incr = []
        for i in range(steps):
            h, states = cell(ids, states)
            incr.append(h @ embed.weight.T)
            ids = y[i:i + 1]
        incr_k1 = fa.launches
        incr = torch.cat(incr)
        tgt_ids = torch.cat([torch.full((1,), MT_BOS, device="cuda", dtype=torch.int64),
                             y[:-1]])[None]
        tgt = embed(tgt_ids) * (d ** 0.5) + pos[:steps]
        mask = nn.Transformer.generate_square_subsequent_mask(steps, device="cuda")
        full = model.decoder(tgt, memory, mask)[0] @ embed.weight.T
    incr_err = ((incr - full).abs().amax(-1) / full.abs().amax(-1)).max().item()
    log(f"[translation] (b) sentence 0's best beam, {steps} steps: incremental (K1, {incr_k1} "
        f"launches) vs one teacher-forced forward under the causal mask: max err / row max "
        f"|logit| {incr_err:.3e} (tolerance {TOL_MT_INCR})")
    if incr_err > TOL_MT_INCR or incr_k1 != 2 * layers * steps:
        fail("translation (b): incremental decoding disagrees with the full forward")

    # (d) a padded batch: the encoder and cross-attention masked, the
    # decoder's self-attention through K1
    lengths = rng.randint(40, MT_SRC + 1, 4)
    lengths[0] = MT_SRC
    psrc = src_ids(4, lengths).cuda()
    keep = (torch.arange(MT_SRC, device="cuda")[None, :]
            < torch.from_numpy(lengths).cuda()[:, None])[:, None, None, :]
    with torch.inference_mode():
        fa.launches = 0
        pout, _, plens = translate(nn, model, embed, pos, psrc, keep)
        torch.cuda.synchronize()
        pk1 = fa.launches
    psteps = pout.parent_ids.shape[0]
    pok = (tuple(pout.predicted_ids.shape) == (4, psteps, MT_BEAM) and psteps <= max_steps
           and bool(torch.isfinite(pout.scores).all()) and pk1 == layers * psteps)
    log(f"[translation] (d) padded batch, lengths {lengths.tolist()}: {psteps} steps, lengths "
        f"out {plens[:, 0].tolist()}; K1 launches {pk1} (want {layers} x {psteps}: none in the "
        "masked encoder and cross-attention)")
    if not pok:
        fail("translation (d): the padded batch did not decode through the expected paths")

    # (e) throughput at 16 sentences x 64 tokens, beam 4; step times by
    # CUDA events recorded as each step starts
    src = src_ids(MT_BATCH).cuda()
    with torch.inference_mode():
        translate(nn, model, embed, pos, src, max_steps=4)  # warm
        enc_ms = cuda_ms(torch, lambda: encode(model, embed, pos, src), iters=10)
        events = []

        def mark(_ids):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)
        torch.cuda.synchronize()
        fa.launches = 0
        t = time.perf_counter()
        tout, _, tlens = translate(nn, model, embed, pos, src, on_step=mark)
        mark(None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        tk1 = fa.launches
    tsteps = tout.parent_ids.shape[0]
    # spans between step starts; the last one also holds the backtrack
    # (gather_tree) after the loop
    step_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    decode_ms = events[0].elapsed_time(events[-1])
    rows = MT_BATCH * MT_BEAM
    cost = [mt_step_cost(rows, i + 1, MT_SRC, layers, d, ffn, MT_VOCAB)
            for i in range(tsteps)]
    b_bytes = sum(c[0] for c in cost) / HBM_BYTES_PER_S * 1e3
    b_ops = sum(c[1] for c in cost) / PEAK_OPS_PER_S["float32"] * 1e3
    bound, bound_by = (b_ops, "operations") if b_ops > b_bytes else (b_bytes, "bytes")
    gen_tokens = int(tlens[:, 0].sum())
    log(f"[translation] (e) {MT_BATCH} sentences x {MT_SRC} tokens, beam {MT_BEAM}: "
        f"{tsteps} steps in {wall:.3f} s: {MT_BATCH / wall:.2f} sentences/s, {gen_tokens / wall:.1f} "
        f"generated tokens/s (the best beams' lengths, {gen_tokens} tokens; "
        f"{rows * tsteps / wall:.1f} beam-tokens/s); encoder {enc_ms:.3f} ms (CUDA events); "
        f"decode {decode_ms:.3f} ms, a step {decode_ms / tsteps:.3f} ms on average (first "
        f"{step_ms[0]:.3f}, middle {step_ms[tsteps // 2]:.3f}, second last {step_ms[-2]:.3f}, "
        f"last with the backtrack {step_ms[-1]:.3f} ms; CUDA events); the steps' least time {bound:.3f} ms ({bound_by}; bytes {b_bytes:.3f}, "
        f"operations {b_ops:.3f}) = {100 * bound / decode_ms:.1f}% of it; K1 launches {tk1} | "
        f"{card}")
    if tk1 != layers + 2 * layers * tsteps or not torch.isfinite(tout.scores).all():
        fail("translation (e): the throughput run's K1 launches or scores are off")
    records = []
    with torch.inference_mode():
        ms, busy, kernels, groups = profile_device(
            torch, lambda: translate(nn, model, embed, pos, src), "the 16 x 64 translation "
            f"(encoder and {tsteps} steps)", top=12, groups=MT_GROUPS, records=records)
    idle = 1.0 - busy / ms if ms else None
    for t_ms, n, name in sorted(r for r in records if "CatArray" in r[2]):
        log(f"    [concat] {t_ms:8.3f} ms x{n:<5d} {name[:200]}")
    log(f"[translation] a mean step's kernels: {busy / tsteps:.3f} ms in {kernels / tsteps:.1f} "
        "kernels; " + "; ".join(f"{g} {v[0] / tsteps:.3f} ms" for g, v in
                                sorted(groups.items(), key=lambda kv: -kv[1][0]))
        + f"; device idle {100 * idle:.1f}% of the translation's {ms:.3f} ms (CUDA events) | "
        f"{card}")
    del cpu_model, cpu_embed
    log(f"[translation] the phase took {time.perf_counter() - t_phase:.1f} s")
    return dict(launches=k1 + incr_k1 + pk1 + tk1, steps=tsteps, enc_ms=enc_ms,
                decode_ms=decode_ms, step_ms=decode_ms / tsteps, sentences_per_s=MT_BATCH / wall,
                tokens_per_s=gen_tokens / wall, bound_ms=bound, bound_by=bound_by, idle=idle,
                groups={g: v[0] / tsteps for g, v in groups.items()}, score_err=worst_score,
                incr_err=incr_err)


# ----------------------------------------------------------- phases 13 and 14
# Llama-374M pretraining at bench.py's shape (run_llama, bench.py:676-795):
# LLAMA_374M (bench.py:192) = vocab 32000, hidden 1024, 24 layers, 8 heads of
# head_dim 128, FFN 2816; seq 2048, batch 8 (the first candidate of its
# sweep), O1 bf16, AdamW(3e-4, weight decay 0.1, ClipGradByGlobalNorm(1.0)),
# the mean NLL of seeded random labels (bench.py:712-715), one batch
LM_CFG = dict(vocab_size=32000, hidden_size=1024, num_layers=24, num_heads=8,
              intermediate_size=2816)
LM_SEQ, LM_BATCH, LM_LR, LM_WD = 2048, 8, 3e-4, 0.1
LM_WARMUP, LM_STEPS = 3, 20
LM_PARITY_LAYERS = 2  # (a): full width at depth 2, batch 1
TOL_RECOMPUTE_GRAD = 1e-5  # (d): recompute vs not, of each gradient's max
TRAIN_GROUPS = KERNEL_GROUPS + (
    ("casts and copies", ("copy_kernel", "Copy", "Memcpy", "cat_", "Cat")),)


def bench_flops_per_token(n_params, vocab, hidden, layers, seq):
    """bench.py run_llama's count (bench.py:764-772): forward = 2 x the
    matmul parameters (all but the embedding) + causal attention, 4 * seq *
    hidden * layers / 2; forward + backward = 3 x that."""
    matmul_params = n_params - vocab * hidden
    return 3.0 * (2.0 * matmul_params + 4.0 * seq * hidden * layers * 0.5)


def phase_lm_training(torch, fa, mods, card):
    """Phase 13 (module docstring): Llama-374M pretraining."""
    LlamaModel, nn, optimizer, spmd, prandom = mods
    t_phase = time.perf_counter()
    torch.set_num_threads(os.cpu_count() or 1)
    vocab = LM_CFG["vocab_size"]

    def loss_fn(logits, labels):
        # bench.py's loss: the mean NLL of the labels
        logp = torch.log_softmax(logits.float(), dim=-1)
        return -torch.take_along_dim(logp, labels[..., None].long(), dim=-1).mean()

    def make_batch(b):
        def on(dev):
            rng = np.random.RandomState(0)  # bench.py's ids, then labels
            ids = rng.randint(0, vocab, (b, LM_SEQ)).astype(np.int32)
            labels = rng.randint(0, vocab, (b, LM_SEQ)).astype(np.int32)
            return torch.from_numpy(ids).to(dev), torch.from_numpy(labels).to(dev)
        return on

    def build(model, amp_level="O0", **kw):
        opt = optimizer.AdamW(LM_LR, parameters=model.parameters(), weight_decay=LM_WD,
                              grad_clip=nn.ClipGradByGlobalNorm(1.0))
        return spmd.build_train_step(model, loss_fn, opt, amp_level=amp_level, **kw)

    gen = torch.Generator(device="cuda").manual_seed(0)

    # (a) full width at depth 2, one O0 float32 step, card against CPU
    small = LlamaModel(**dict(LM_CFG, num_layers=LM_PARITY_LAYERS), max_seq_len=LM_SEQ,
                       device="cuda", generator=gen)
    a_counts, _, _ = parity_step(torch, fa, build, small, make_batch(1), prandom.PRNGKey(0),
                                 LM_LR, "lm training")
    if a_counts != (LM_PARITY_LAYERS,) * 3:
        fail(f"lm training (a): K1/K2/K3 launches {a_counts}, want {LM_PARITY_LAYERS} each")
    del small
    gc.collect()
    torch.cuda.empty_cache()

    # (b) bench.py's run: 3 warm-up and 20 O1 steps at batch 8 x 2048
    t = time.perf_counter()
    model = LlamaModel(**LM_CFG, max_seq_len=LM_SEQ, device="cuda", generator=gen)
    n_layers = len(model.layers)
    n_params = sum(p.numel() for p in model.parameters())
    fpt = bench_flops_per_token(n_params, vocab, LM_CFG["hidden_size"], n_layers, LM_SEQ)
    tokens = LM_BATCH * LM_SEQ
    least_ms = fpt * tokens / PEAK_OPS_PER_S["bfloat16"] * 1e3
    log(f"[lm training] Llama-374M: {n_layers} layers, hidden {LM_CFG['hidden_size']}, "
        f"{LM_CFG['num_heads']} heads, FFN {LM_CFG['intermediate_size']}, vocab {vocab}, "
        f"{n_params} parameters (seed 0), built in {time.perf_counter() - t:.1f} s; "
        f"{fpt / 1e9:.3f} GFLOP a token by bench.py's count, a step's least time "
        f"{least_ms:.2f} ms at the dense bf16 peak")
    step, init = build(model, "O1")
    params, state = init()
    x, y = make_batch(LM_BATCH)("cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.launches = fa.dq_launches = fa.dkv_launches = 0  # count the main path only
    keys = ([prandom.fold_in(prandom.PRNGKey(0), i) for i in range(LM_WARMUP)]
            + [prandom.fold_in(prandom.PRNGKey(0), 100 + i) for i in range(LM_STEPS)])
    params, state, losses, secs = train_steps(torch, step, params, state, x, y, keys)
    counts = dict(fwd=fa.launches, bwd_dq=fa.dq_launches, bwd_dkv=fa.dkv_launches)
    peak = torch.cuda.max_memory_allocated()
    steady = _median(secs[LM_WARMUP + 1:])
    log(f"[lm training] (b) O1 bf16, batch {LM_BATCH} x seq {LM_SEQ}: loss "
        + " ".join(f"{v:.4f}" for v in losses))
    log(f"[lm training] (b) O1 step (median of timed steps 2-{LM_STEPS}, host clock to "
        f"synchronize): {steady * 1e3:.2f} ms, {tokens / steady:.0f} tokens/s, "
        f"{100 * least_ms / (steady * 1e3):.1f}% of the dense bf16 peak by bench.py's count; "
        f"first step {secs[0] * 1e3:.1f} ms; peak memory {peak / 2**30:.2f} GiB | {card}")
    if not all(np.isfinite(losses)):
        fail(f"lm training (b): the loss is not finite: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"lm training (b): the loss did not fall over {len(losses)} steps: {losses}")

    # (c) every step ran K1, K2 and K3 once per layer
    want = n_layers * len(keys)
    log(f"[lm training] (c) launches over {len(keys)} steps: "
        + ", ".join(f"{k} {v}" for k, v in counts.items()) + f" (want {want} each)")
    if any(v != want for v in counts.values()):
        fail(f"lm training (c): kernel launches {counts} != {n_layers} x {len(keys)} steps")

    # (d) recompute=True against the plain step on (b)'s state, undonated
    plain_step, _ = build(model, "O1", donate=False)
    rc_step, _ = build(model, "O1", donate=False, recompute=True)
    key = prandom.PRNGKey(777)
    out, rc_counts = {}, None
    for name, fn in (("plain", plain_step), ("recompute", rc_step)):
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fa.launches = fa.dq_launches = fa.dkv_launches = 0
        loss, _, new_state = fn(params, state, x, y, key=key)
        torch.cuda.synchronize()
        rc_counts = (fa.launches, fa.dq_launches, fa.dkv_launches)
        out[name] = (loss, {n: st[0] for n, st in new_state.items()},
                     torch.cuda.max_memory_allocated(), resident, rc_counts)
        del new_state
    (lp, mp, pk_p, res_p, _), (lrc, mr, pk_r, res_r, rc_counts) = out["plain"], out["recompute"]
    same_loss = torch.equal(lp, lrc)
    worst = 0.0
    for n, m_old in ((n, st[0]) for n, st in state.items()):
        g = (mp[n] - 0.9 * m_old) / (1 - 0.9)
        worst = max(worst, ((mp[n] - mr[n]).abs().max() / (1 - 0.9)
                            / g.abs().max().clamp_min(1e-30)).item())
    log(f"[lm training] (d) recompute=True vs the plain step on (b)'s state: loss "
        f"{float(lp):.6f} / {float(lrc):.6f} bitwise equal {same_loss}; gradients worst rel err "
        f"{worst:.2e} (tolerance {TOL_RECOMPUTE_GRAD}); K1/K2/K3 launches {rc_counts} (want "
        f"{2 * n_layers}, {n_layers}, {n_layers}); the step's peak above resident memory: plain "
        f"{(pk_p - res_p) / 2**30:.2f} GiB, recompute {(pk_r - res_r) / 2**30:.2f} GiB "
        f"(absolute {pk_p / 2**30:.2f} / {pk_r / 2**30:.2f} GiB) | {card}")
    if not same_loss or worst > TOL_RECOMPUTE_GRAD or rc_counts != (2 * n_layers, n_layers,
                                                                    n_layers):
        fail("lm training (d): the recomputed step differs from the plain one")
    del out, mp, mr

    # (e) where an O1 step's device time goes
    def one_step():
        nonlocal params, state
        _, params, state = step(params, state, x, y, key=prandom.PRNGKey(999))

    ms, busy, kernels, groups = profile_device(
        torch, one_step, f"Llama-374M O1 step, batch {LM_BATCH} x {LM_SEQ}", top=16,
        groups=TRAIN_GROUPS)
    idle = 1.0 - busy / ms if busy else None
    log(f"[lm training] (e) device idle {_fmt_pct(idle)} of a profiled O1 step ({ms:.2f} ms "
        f"by CUDA events, {busy:.2f} ms of kernels, {kernels} kernels); the phase took "
        f"{time.perf_counter() - t_phase:.1f} s")
    del model, step, init, params, state, plain_step, rc_step
    gc.collect()
    torch.cuda.empty_cache()
    return dict(counts=counts, steps=len(keys), parity_counts=a_counts, rc_counts=rc_counts,
                step_ms=steady * 1e3, tokens_per_s=tokens / steady, least_ms=least_ms,
                mfu=least_ms / (steady * 1e3), losses=losses, peak_bytes=peak,
                step_peak_plain=pk_p - res_p, step_peak_recompute=pk_r - res_r, idle=idle,
                groups={g: v[0] for g, v in groups.items()}, recompute_grad_err=worst)


# Transformer-base translation training ("Attention Is All You Need"
# §5.3-5.4): phase 12's model (translation_model) trained by teacher forcing
# with label smoothing 0.1, Adam(0.9, 0.98, 1e-9) under NoamDecay(d_model,
# 4000), dropout 0.1 everywhere; 64 pairs of 64 source and 48 target tokens
# a step (about one GPU's share of the paper's 25k-token batches). The
# scheduler starts at last_epoch 3999, so the steps run at its peak rate
MT_TRAIN_PAIRS, MT_TRAIN_TGT, MT_TRAIN_STEPS, MT_PARITY_PAIRS = 64, 48, 20, 4
MT_SMOOTH, MT_NOAM_WARMUP = 0.1, 4000


def noam_rate(d_model, warmup, step):
    """NoamDecay's rate at ``step``, from the paper's formula (§5.3)."""
    step = max(step, 1)
    return d_model ** -0.5 * min(step ** -0.5, step * warmup ** -1.5)


def phase_mt_training(torch, fa, mods, card):
    """Phase 14 (module docstring): Transformer-base translation training."""
    nn, optimizer, spmd, prandom = mods
    F = nn.functional
    t_phase = time.perf_counter()
    torch.set_num_threads(os.cpu_count() or 1)

    def loss_fn(logits, labels):
        soft = F.label_smooth(F.one_hot(labels, MT_VOCAB), epsilon=MT_SMOOTH)
        return F.cross_entropy(logits, soft, soft_label=True)

    def make_batch(n):
        def on(dev):
            rng = np.random.RandomState(1)
            src = rng.randint(3, MT_VOCAB, (n, MT_SRC))
            tgt = rng.randint(3, MT_VOCAB, (n, MT_TRAIN_TGT))
            # teacher forcing: the decoder reads BOS and the target but its last token
            dec_in = np.concatenate([np.full((n, 1), MT_BOS), tgt[:, :-1]], 1)
            packed = np.concatenate([src, dec_in], 1).astype(np.int32)
            return (torch.from_numpy(packed).to(dev),
                    torch.from_numpy(tgt.astype(np.int32)).to(dev))
        return on

    def noam():
        return optimizer.lr.NoamDecay(d_model, MT_NOAM_WARMUP,
                                      last_epoch=MT_NOAM_WARMUP - 1)

    def build(model):
        opt = optimizer.Adam(noam(), beta1=0.9, beta2=0.98, epsilon=1e-9,
                             parameters=model.parameters())
        return spmd.build_train_step(model, loss_fn, opt)

    gen = torch.Generator(device="cuda").manual_seed(0)
    t = time.perf_counter()
    model = translation_model(torch, nn, "cuda", gen)
    d_model = model.transformer.d_model
    layers = model.transformer.encoder.num_layers + model.transformer.decoder.num_layers
    n_params = sum(p.numel() for p in model.parameters())
    peak_rate = noam_rate(d_model, MT_NOAM_WARMUP, MT_NOAM_WARMUP)
    log(f"[mt training] Transformer-base: {n_params} parameters (the embedding tied to the "
        f"output projection; seed 0), built in {time.perf_counter() - t:.1f} s; label "
        f"smoothing {MT_SMOOTH}, Adam(0.9, 0.98, 1e-9) under NoamDecay({d_model}, "
        f"{MT_NOAM_WARMUP}) from step {MT_NOAM_WARMUP}: rate {peak_rate:.4e}; dropout "
        f"{model.dropout}")

    # (a) one O0 float32 step of 4 pairs, card against CPU, dropout and all,
    # with the ReLU gates the two runs' roundings set apart exempt
    # (relu_flip_exemption)
    a_counts, _, _ = parity_step(torch, fa, build, model, make_batch(MT_PARITY_PAIRS),
                                 prandom.PRNGKey(0), peak_rate, "mt training",
                                 zero_grads=("k_proj.bias",), record=ffn_and_embedding,
                                 exempt=relu_flip_exemption(torch, model, "mt training"))
    if a_counts != (layers,) * 3:
        fail(f"mt training (a): K1/K2/K3 launches {a_counts}, want {layers} each (the "
             "encoder's self-attention and the cross-attention)")

    # (b) 20 O1 steps of 64 pairs, the scheduler stepped after each; the
    # rate a step takes (the optimizer's) is held to the paper's formula
    sched = noam()
    opt = optimizer.Adam(sched, beta1=0.9, beta2=0.98, epsilon=1e-9,
                         parameters=model.parameters())
    step, init = spmd.build_train_step(model, loss_fn, opt, amp_level="O1")
    opt_rates, want_rates = [], []

    def after():
        sched.step()
        opt_rates.append(opt.get_lr())
        want_rates.append(noam_rate(d_model, MT_NOAM_WARMUP, sched.last_epoch))

    opt_rates.append(opt.get_lr())
    want_rates.append(noam_rate(d_model, MT_NOAM_WARMUP, sched.last_epoch))
    params, state = init()
    x, y = make_batch(MT_TRAIN_PAIRS)("cuda")
    keys = [prandom.fold_in(prandom.PRNGKey(0), i) for i in range(MT_TRAIN_STEPS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.launches = fa.dq_launches = fa.dkv_launches = 0  # count the main path only
    fa.form_launches.clear()
    params, state, losses, secs = train_steps(torch, step, params, state, x, y, keys, after)
    counts = dict(fwd=fa.launches, bwd_dq=fa.dq_launches, bwd_dkv=fa.dkv_launches)
    # the same launches by form: the encoder's self-attention (Sq = Sk =
    # source) and the cross-attention (Sq = target, Sk = source)
    forms = {form: {key: fa.form_launches.get((kernel, sq, MT_SRC), 0)
                    for key, kernel in (("fwd", "fwd"), ("bwd_dq", "dq"), ("bwd_dkv", "dkv"))}
             for form, sq in (("encoder", MT_SRC), ("cross", MT_TRAIN_TGT))}
    peak = torch.cuda.max_memory_allocated()
    steady = _median(secs[1:])
    tokens = MT_TRAIN_PAIRS * (MT_SRC + MT_TRAIN_TGT)
    log(f"[mt training] (b) O1 bf16, {MT_TRAIN_PAIRS} pairs x ({MT_SRC} + {MT_TRAIN_TGT}) "
        "tokens: loss " + " ".join(f"{v:.4f}" for v in losses))
    log(f"[mt training] (b) rates: first {opt_rates[0]:.6e}, last {opt_rates[-1]:.6e}, each "
        f"the scheduler's and the paper's formula's: {opt_rates == want_rates}; O1 step "
        f"(median of steps 2-{MT_TRAIN_STEPS}, host clock to synchronize) {steady * 1e3:.2f} "
        f"ms, {tokens / steady:.0f} source + target tokens/s; first step "
        f"{secs[0] * 1e3:.1f} ms; peak memory {peak / 2**30:.2f} GiB | {card}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"mt training (b): the loss is not finite or did not fall: {losses}")
    if opt_rates != want_rates:
        fail("mt training (b): the steps' rates are not NoamDecay's")

    # (c) K1, K2, K3 once per unmasked attention a step: the encoder's
    # self-attention and the decoder's cross-attention (its self-attention
    # carries the causal mask and takes the plain softmax)
    want = layers * MT_TRAIN_STEPS
    bh, head_dim = MT_TRAIN_PAIRS * model.transformer.nhead, d_model // model.transformer.nhead
    want_form = dict(encoder=model.transformer.encoder.num_layers * MT_TRAIN_STEPS,
                     cross=model.transformer.decoder.num_layers * MT_TRAIN_STEPS)
    log(f"[mt training] (c) launches over {MT_TRAIN_STEPS} steps: "
        + ", ".join(f"{k} {v}" for k, v in counts.items()) + f" (want {want} each); by "
        f"form: encoder [{bh}, {MT_SRC}, {head_dim}] {forms['encoder']} (want "
        f"{want_form['encoder']} each), cross [{bh}, {MT_TRAIN_TGT}, {MT_SRC} keys, "
        f"{head_dim}] {forms['cross']} (want {want_form['cross']} each)")
    if any(v != want for v in counts.values()) or any(
            v != want_form[form] for form, c in forms.items() for v in c.values()):
        fail(f"mt training (c): kernel launches {counts}, by form {forms}; want {want} each, "
             f"{want_form} by form")

    # (d) where an O1 step's device time goes
    def one_step():
        nonlocal params, state
        _, params, state = step(params, state, x, y, key=prandom.PRNGKey(999))

    ms, busy, kernels, groups = profile_device(
        torch, one_step, f"Transformer-base O1 step, {MT_TRAIN_PAIRS} pairs", top=16,
        groups=TRAIN_GROUPS)
    idle = 1.0 - busy / ms if busy else None
    log(f"[mt training] (d) device idle {_fmt_pct(idle)} of a profiled O1 step ({ms:.2f} ms "
        f"by CUDA events, {busy:.2f} ms of kernels, {kernels} kernels); the phase took "
        f"{time.perf_counter() - t_phase:.1f} s")
    del model, step, init, params, state
    gc.collect()
    torch.cuda.empty_cache()
    return dict(counts=counts, forms=forms, steps=MT_TRAIN_STEPS, parity_counts=a_counts,
                step_ms=steady * 1e3, tokens_per_s=tokens / steady, losses=losses,
                rates=opt_rates, peak_bytes=peak, idle=idle,
                groups={g: v[0] for g, v in groups.items()})


# ------------------------------------------------------------------ phase 15
DYG_DEPTH = 2  # (a) and (b): BERT-base width at depth 2
TOL_DYG_AUTOGRAD = 1e-5  # (e): double grad and PyLayer, card vs CPU, of the max


def dygraph_mlm_loss(paddle, logits, labels):
    """bench.py's loss (phase 5's) as a Paddle user writes it: the mean
    NLL of the labels at the masked positions, in float32."""
    logits = logits.astype("float32")
    logp = logits - paddle.logsumexp(logits, axis=-1, keepdim=True)
    return -paddle.take_along_axis(logp, labels.unsqueeze(-1), axis=-1).mean()


def dygraph_step(paddle, model, opt, batch, amp):
    """One eager step: forward under auto_cast (O1 bf16 when ``amp``),
    loss.backward(), opt.step(), opt.clear_grad(). Returns the loss."""
    ids, pos, labels = batch
    with paddle.amp.auto_cast(enable=amp, level="O1", dtype="bfloat16"):
        mlm_logits, _ = model(ids, masked_positions=pos)
        loss = dygraph_mlm_loss(paddle, mlm_logits, labels)
    loss.backward()
    opt.step()
    opt.clear_grad()
    return loss


def dygraph_batch(paddle, packed, labels):
    """phase 5's packed batch as the Tensors a user hands the model."""
    packed = packed.numpy()
    return (paddle.to_tensor(packed[:, :TRAIN_SEQ]), paddle.to_tensor(packed[:, TRAIN_SEQ:]),
            paddle.to_tensor(labels.numpy()))


def dygraph_optimizer(paddle, model):
    return paddle.optimizer.AdamW(LR, parameters=model.parameters(), weight_decay=0.01,
                                  grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))


def first_moments(opt, model):
    """AdamW's first moment / (1 - 0.9) of every parameter the step
    updated: after one step, its clipped gradient."""
    return {n: (opt._accumulators[id(p)][0] / (1 - 0.9)).cpu()
            for n, p in model.named_parameters() if id(p) in opt._accumulators}


def hold_step(label, got, want, zero_grads=("k_proj.bias",)):
    """Phase 5's bounds on two runs of one step, each (loss, {name: clipped
    gradient}, {name: updated parameter}): loss TOL_STEP_LOSS relative,
    each gradient within TOL_STEP_GRAD of its max (those named by a suffix
    in ``zero_grads``, zero but for rounding, within TOL_ZERO_GRAD of the
    model's largest), each parameter within 2.5 * lr. Returns the failures
    and whether the two runs are bitwise equal."""
    (gl, gg, gp), (wl, wg, wp) = got, want
    bad = []
    loss_err = abs(gl - wl) / abs(wl)
    if not (loss_err <= TOL_STEP_LOSS and np.isfinite(gl)):
        bad.append("loss")
    if set(gg) != set(wg):
        bad.append(f"updated parameters {sorted(set(gg) ^ set(wg))}")
    model_max = max(g.abs().max().item() for g in wg.values())
    share = {}  # each gradient's error as a share of its bound
    for n in set(gg) & set(wg):
        zero = n.endswith(tuple(zero_grads))
        scale = model_max if zero else wg[n].abs().max().item()
        err = (gg[n] - wg[n]).abs().max().item() / max(scale, 1e-30)
        share[n] = err / (TOL_ZERO_GRAD if zero else TOL_STEP_GRAD)
        if not share[n] <= 1.0:
            bad.append(f"grad {n}")
    worst = max(share, key=share.get)
    param_err = max((gp[n] - wp[n]).abs().max().item() for n in wp)
    if not param_err <= 2.5 * LR:
        bad.append("updated parameters")
    bitwise = (gl == wl and all(np.array_equal(gp[n].numpy(), wp[n].numpy()) for n in wp))
    log(f"[dygraph] {label}: loss {gl:.6f} vs {wl:.6f} (rel err {loss_err:.2e}, tolerance "
        f"{TOL_STEP_LOSS}); clipped gradients of {len(wg)} tensors, the worst at "
        f"{share[worst]:.2e} of its bound ({worst}); updated parameters max abs err {param_err:.3e} "
        f"(tolerance 2.5 lr = {2.5 * LR:.2e}); bitwise equal: {bitwise}")
    return bad, bitwise


def phase_dygraph(torch, fa, mods, card, train, serving):
    """Phase 15: BERT-base dygraph pretraining through the eager Tensor API
    (import paddle_tpu_torch as paddle), its loss.backward() through K1-K3."""
    paddle, BertForPretraining, BertModel, nn, optimizer, spmd = mods
    from paddle_tpu_torch.core import place as pplace

    torch.set_num_threads(os.cpu_count() or 1)
    batch, build = bert_pretraining_parts(torch, nn, optimizer, spmd)
    bert_kw = dict(hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)
    failures = []

    def launches():
        return (fa.launches, fa.dq_launches, fa.dkv_launches)

    # (a) one O0 float32 step at depth 2, card against CPU, dropout 0.1 on
    # the same key stream
    model = BertForPretraining(num_hidden_layers=DYG_DEPTH, **bert_kw, device="cuda",
                               generator=torch.Generator().manual_seed(0))
    vocab = model.bert.vocab_size
    cpu_model = copy.deepcopy(model).to("cpu")
    runs, a_counts, secs = {}, None, {}
    for dev, m in (("gpu", model), ("cpu", cpu_model)):
        paddle.set_device(dev)
        opt = dygraph_optimizer(paddle, m)
        data = dygraph_batch(paddle, *batch(4, vocab))
        paddle.seed(0)
        before = launches()
        t = time.perf_counter()
        loss = float(dygraph_step(paddle, m, opt, data, amp=False).numpy())
        secs[dev] = time.perf_counter() - t
        if dev == "gpu":
            a_counts = tuple(x - y for x, y in zip(launches(), before))
        runs[dev] = (loss, first_moments(opt, m),
                     {n: p.detach().cpu() for n, p in m.named_parameters()})
    paddle.set_device("gpu")
    bad, _ = hold_step(f"(a) O0 step at depth {DYG_DEPTH}, batch 4, dropout 0.1: card vs CPU",
                       runs["gpu"], runs["cpu"])
    log(f"[dygraph] (a) card {secs['gpu']:.2f} s, cpu {secs['cpu']:.2f} s (first step); "
        f"launches K1/K2/K3 {a_counts}")
    failures += [f"(a) {b}" for b in bad]
    if a_counts != (DYG_DEPTH,) * 3:
        failures.append(f"(a) launches {a_counts} != {DYG_DEPTH} each")
    del model, cpu_model, runs, opt

    # (b) the same step against phase 5's build_train_step, dropout 0
    eager = BertForPretraining(num_hidden_layers=DYG_DEPTH, hidden_dropout_prob=0.0,
                               attention_probs_dropout_prob=0.0, device="cuda",
                               generator=torch.Generator().manual_seed(0))
    functional = copy.deepcopy(eager)
    packed, labels = batch(4, vocab)
    opt = dygraph_optimizer(paddle, eager)
    before = launches()
    loss = float(dygraph_step(paddle, eager, opt, dygraph_batch(paddle, packed, labels),
                              amp=False).numpy())
    got = (loss, first_moments(opt, eager),
           {n: p.detach().cpu() for n, p in eager.named_parameters()})
    step, init = build(functional, "O0")
    params, state = init()
    floss, params, state = step(params, state, packed.cuda(), labels.cuda())
    b_counts = tuple(x - y for x, y in zip(launches(), before))
    strip = len("inner.")
    # the eager step leaves a parameter without a gradient (the NSP head and
    # the pooler: the loss does not reach them) as it was; the training step
    # gives it a zero gradient and AdamW's decay moves it by lr * 0.01 * p
    want = (float(floss), {n[strip:]: (st[0] / (1 - 0.9)).cpu() for n, st in state.items()
                           if n[strip:] in got[1]},
            {n[strip:]: p.cpu() for n, p in params.items()})
    unreached = [n for n, st in state.items() if n[strip:] not in got[1]]
    if any(state[n][0].abs().max().item() != 0 for n in unreached):
        failures.append("(b) a parameter the eager step left has a gradient in the training step")
    bad, b_bitwise = hold_step("(b) O0 dygraph step vs build_train_step, dropout 0", got, want)
    failures += [f"(b) {b}" for b in bad]
    if b_counts != (2 * DYG_DEPTH,) * 3:
        failures.append(f"(b) launches {b_counts} != {2 * DYG_DEPTH} each")
    del eager, functional, params, state, step, init, opt

    # (c) O1 bf16 steps at full depth on phase 5's batch of 64 x 128
    model = BertForPretraining(**bert_kw, device="cuda", generator=torch.Generator().manual_seed(0))
    n_layers = len(model.bert.encoder.layers)
    opt = dygraph_optimizer(paddle, model)
    data = dygraph_batch(paddle, *batch(O1_BATCH, vocab))
    paddle.seed(0)
    torch.cuda.reset_peak_memory_stats()
    fa.launches = fa.dq_launches = fa.dkv_launches = 0  # count the main path only
    fa.form_launches.clear()
    losses, step_secs = [], []
    for _ in range(O1_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss = dygraph_step(paddle, model, opt, data, amp=True)
        torch.cuda.synchronize()
        step_secs.append(time.perf_counter() - t)
        losses.append(float(loss.numpy()))
    counts = dict(fwd=fa.launches, bwd_dq=fa.dq_launches, bwd_dkv=fa.dkv_launches)
    forms = {k: fa.form_launches.get((k, TRAIN_SEQ, TRAIN_SEQ), 0) for k in ("fwd", "dq", "dkv")}
    want_n = n_layers * O1_STEPS
    steady = _median(step_secs[1:])
    tokens = O1_BATCH * TRAIN_SEQ
    log(f"[dygraph] (c) O1 bf16, batch {O1_BATCH} x seq {TRAIN_SEQ}, dropout 0.1: loss "
        + " ".join(f"{v:.4f}" for v in losses))
    log(f"[dygraph] (c) O1 dygraph step (median of steps 2-{O1_STEPS}, host clock to "
        f"synchronize): {steady * 1e3:.2f} ms, {tokens / steady:.0f} tokens/s; phase 5's "
        f"build_train_step step in this run {train['step_ms']:.2f} ms "
        f"({train['tokens_per_s']:.0f} tokens/s); first step {step_secs[0] * 1e3:.1f} ms; peak "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB | {card}")
    log(f"[dygraph] (c) launches over {O1_STEPS} steps: " + ", ".join(
        f"{k} {v}" for k, v in counts.items()) + f"; by form (kernel, {TRAIN_SEQ}, "
        f"{TRAIN_SEQ}): {forms} (expected {want_n} each)")
    if not all(np.isfinite(losses)):
        failures.append(f"(c) loss not finite: {losses}")
    if not losses[-1] < losses[0]:
        failures.append(f"(c) loss did not fall over {O1_STEPS} steps: {losses}")
    if any(v != want_n for v in list(counts.values()) + list(forms.values())):
        failures.append(f"(c) launches {counts} / {forms} != {n_layers} x {O1_STEPS}")

    def one_step():
        dygraph_step(paddle, model, opt, data, amp=True)

    step_ms, busy_ms, n_kernels, _ = profile_device(
        torch, one_step, f"O1 dygraph step, batch {O1_BATCH} x {TRAIN_SEQ}", top=16)
    idle = 1 - busy_ms / step_ms if busy_ms > 0 else None
    log(f"[profile] device idle {_fmt_pct(idle)} of an O1 dygraph step, {n_kernels} kernels "
        "(kernel time summed over the traced step against the CUDA-event time of the step "
        "before it)")
    del model, opt, data

    # (d) inference: phase 4's serving batch through the Tensor API, bitwise
    # phase 4's direct call of the same weights
    bert = BertModel(device="cuda", generator=torch.Generator().manual_seed(0)).eval()
    before = fa.launches
    with paddle.no_grad():
        seq, pooled = bert(paddle.to_tensor(serving["batch"]))
    d_launches = fa.launches - before
    same = [np.array_equal(seq.numpy(), serving["batch_out"][0]),
            np.array_equal(pooled.numpy(), serving["batch_out"][1])]
    log(f"[dygraph] (d) model(paddle.to_tensor(ids)) under paddle.no_grad(), batch "
        f"{list(serving['batch'].shape)} float32: {type(seq).__name__} {seq.shape}, bitwise "
        f"phase 4's direct call: sequence {same[0]}, pooled {same[1]}; K1 launches {d_launches}")
    if not all(same) or d_launches != len(bert.encoder.layers):
        failures.append("(d) the Tensor API's call is not bitwise phase 4's direct call")
    del bert, seq, pooled

    # (e) every paddle.* op of the port on the card against the CPU, with
    # tests/test_torch_api_cases.py's cases and tolerances
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    import test_torch_api_cases as cases

    def on(dev):
        def run(case, seed):
            paddle.set_device(dev)
            return cases._run(paddle, case, seed)

        return run

    t = time.perf_counter()
    op_bad = []
    for name in sorted(cases.ALL):
        try:
            cases.check(name, cases.ALL[name], on("gpu"), on("cpu"))
        except Exception as e:  # noqa: BLE001 - every op's failure is listed
            op_bad.append(f"{name}: {str(e).splitlines()[0][:160]}")
    paddle.set_device("gpu")

    def autograd_run(dev):
        paddle.set_device(dev)
        x = paddle.to_tensor(np.array([[0.3, -1.2], [2.0, 0.5]], np.float32), stop_gradient=False)
        (g1,) = paddle.grad(paddle.tanh(x).sum(), x, create_graph=True)
        (g2,) = paddle.grad((g1 ** 2).sum(), x)

        class Cube(paddle.autograd.PyLayer):
            @staticmethod
            def forward(ctx, v):
                ctx.save_for_backward(v)
                return v * v * v

            @staticmethod
            def backward(ctx, grad):
                (v,) = ctx.saved_tensor()
                return grad * 3 * v * v

        y = paddle.to_tensor(np.array([2.0, -1.5, 0.5], np.float32), stop_gradient=False)
        Cube.apply(y).sum().backward()
        return [g1.numpy(), g2.numpy(), y.grad.numpy()]

    for label, a, b in zip(("double grad g1", "double grad g2", "PyLayer backward"),
                           autograd_run("gpu"), autograd_run("cpu")):
        err = float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
        if not err <= TOL_DYG_AUTOGRAD:
            op_bad.append(f"{label}: {err:.2e} of its max > {TOL_DYG_AUTOGRAD}")
    paddle.set_device("gpu")
    log(f"[dygraph] (e) {len(cases.ALL)} paddle.* op cases and the double grad and PyLayer "
        f"backward, card vs CPU: {len(cases.ALL) + 3 - len(op_bad)} held, {len(op_bad)} "
        f"failed ({time.perf_counter() - t:.1f} s)")
    for line in op_bad:
        log(f"  {line}")
    failures += [f"(e) {b}" for b in op_bad]
    pplace._CURRENT = pplace.CUDAPlace(0)
    gc.collect()
    torch.cuda.empty_cache()
    if failures:
        fail("dygraph: " + "; ".join(failures))
    return dict(counts=counts, forms=forms, extra=tuple(a + b for a, b in zip(a_counts, b_counts)),
                step_ms=steady * 1e3, tokens_per_s=tokens / steady, losses=losses,
                idle=idle, kernels=n_kernels, b_bitwise=b_bitwise)


# ------------------------------------------------------------------ phase 16
VIS_LR, VIS_MOMENTUM, VIS_DECAY = 0.1, 0.9, 1e-4  # bench.py's Momentum
VIS_SMOKE = dict(batch=4, hw=32, classes=10)  # bench.py's smoke config
RESNET_HW, RESNET_CLASSES = 224, 1000
BATCH_CANDIDATES = (512, 256, 128, 64, 32)  # bench.py's, tried in order on OOM
RESNET_WARMUP, RESNET_STEPS, RESNET_DYG_STEPS = 3, 20, 10
TOL_BN_STATS = 1e-4  # running statistics, card vs CPU, of their max
TOL_VIS_EVAL = 1e-3  # eval() forwards, card vs CPU, of the output's max
# kernel-name fragments of the conv path, by the layer that launched them
VISION_GROUPS = (
    ("layout transposes (cuDNN's NCHW <-> NHWC)", ("nchwToNhwc", "nhwcToNchw", "ranspose")),
    ("convolutions and the classifier's GEMM (cuDNN, cuBLAS)",
     ("conv", "Conv", "fprop", "dgrad", "wgrad", "implicit", "xmma", "cudnn", "cutlass",
      "sm90_", "sm80_", "gemm", "nvjet")),
    ("BatchNorm (ATen's batch_norm kernels)", ("batch_norm", "bn_fw", "bn_bw", "welford")),
    ("pooling (max pool, adaptive average pool)", ("pool", "Pool")),
)
UPDATE_SPAN = ANNOTATIONS[0]


def vision_loss(torch, logits, labels):
    """bench.py's run_resnet50 loss: log-softmax in float32, the mean of
    minus the picked label's log-probability."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.take_along_dim(logp, labels[..., None].long(), dim=-1).mean()


def vision_data(torch, batch, hw, classes, seed=0):
    """bench.py's random images ([0, 1), NCHW float32) and int32 labels."""
    rng = np.random.RandomState(seed)
    images = rng.rand(batch, 3, hw, hw).astype(np.float32)
    labels = rng.randint(0, classes, (batch,)).astype(np.int32)
    return torch.from_numpy(images), torch.from_numpy(labels)


def vision_step(torch, mods, model, amp_level="O0"):
    """build_train_step's (step, init) over ``model`` with bench.py's loss
    and Momentum."""
    optimizer, spmd = mods
    opt = optimizer.Momentum(VIS_LR, momentum=VIS_MOMENTUM, parameters=model.parameters(),
                             weight_decay=VIS_DECAY)
    return spmd.build_train_step(model, lambda out, y: vision_loss(torch, out, y), opt,
                                 amp_level=amp_level)


def conv_linear_flops(torch, model, x):
    """2 x multiply-adds of one forward's convolutions and linear layers,
    from the shapes a forward hook sees."""
    total = [0]

    def count(mod, args, out):
        if hasattr(mod, "_kernel_size"):  # a conv: out * (in / groups) * k
            k = 1
            for s in mod._kernel_size:
                k *= s
            total[0] += 2 * out.numel() * (mod._in_channels // mod._groups) * k
        else:  # a Linear
            total[0] += 2 * out.numel() * mod.weight.shape[0]

    hooks = [m.register_forward_hook(count) for m in model.modules()
             if type(m).__name__ in ("Conv2D", "Linear")]
    with torch.no_grad():
        model(x)
    for h in hooks:
        h.remove()
    return total[0]


def hold_vision_step(label, got, want):
    """(a)'s bounds on two runs of one step, each (loss, {name: velocity},
    {name: updated parameter}, {name: buffer}, eval output): loss
    TOL_STEP_LOSS relative, each velocity within TOL_STEP_GRAD of its max,
    each parameter within 2.5 * lr, each running statistic within
    TOL_BN_STATS of its max, the eval forward within TOL_VIS_EVAL."""
    (gl, gv, gp, gb, ge), (wl, wv, wp, wb, we) = got, want
    bad = []
    loss_err = abs(gl - wl) / abs(wl)
    if not (loss_err <= TOL_STEP_LOSS and np.isfinite(gl)):
        bad.append("loss")

    def worst(g, w):
        errs = {n: (g[n] - w[n]).abs().max().item() / max(w[n].abs().max().item(), 1e-30)
                for n in w}
        n = max(errs, key=errs.get)
        return n, errs[n]

    vn, verr = worst(gv, wv)
    bn, berr = worst(gb, wb)
    perr = max((gp[n] - wp[n]).abs().max().item() for n in wp)
    eerr = (ge - we).abs().max().item() / we.abs().max().item()
    bad += [] if set(gv) == set(wv) and verr <= TOL_STEP_GRAD else [f"velocity {vn}"]
    bad += [] if perr <= 2.5 * VIS_LR else ["updated parameters"]
    bad += [] if set(gb) == set(wb) and berr <= TOL_BN_STATS else [f"running statistic {bn}"]
    bad += [] if eerr <= TOL_VIS_EVAL else ["eval forward"]
    log(f"[vision] {label}: loss {gl:.6f} vs {wl:.6f} (rel err {loss_err:.2e}, tolerance "
        f"{TOL_STEP_LOSS}); velocities of {len(wv)} parameters, worst {verr:.2e} of its max "
        f"({vn}; tolerance {TOL_STEP_GRAD}); updated parameters max abs err {perr:.3e} "
        f"(tolerance 2.5 lr = {2.5 * VIS_LR}); running statistics of {len(wb)} buffers, worst "
        f"{berr:.2e} of its max ({bn}; tolerance {TOL_BN_STATS}); eval forward after the "
        f"step {eerr:.2e} of its max (tolerance {TOL_VIS_EVAL})")
    return bad


def vision_run(torch, model, step_and_state, x, y):
    """One O0 step (``step_and_state()`` -> (loss, {name: velocity}, {name:
    parameter}) after it), then the model's buffers and an eval forward with
    the updated parameters; all on the CPU for comparing."""
    loss, velocity, params = step_and_state()
    buffers = {n: b.detach().cpu().clone() for n, b in model.named_buffers()}
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(params[n])
        model.eval()
        out = model(x).detach().cpu()
    model.train()
    return (float(loss), {n: v.detach().cpu() for n, v in velocity.items()},
            {n: p.detach().cpu() for n, p in params.items()}, buffers, out)


def built_step(torch, mods, model, x, y):
    """(a)'s build_train_step step of ``model`` as ``vision_run`` takes it."""
    def run():
        step, init = vision_step(torch, mods, model)
        params, state = init()
        loss, params, state = step(params, state, x, y)
        return loss, {n: st[0] for n, st in state.items()}, params

    return run


def dygraph_vision_step(paddle, model, opt, x, y, amp):
    """One eager step: the forward under auto_cast (O1 bf16 when ``amp``),
    bench.py's loss, loss.backward(), opt.step(), opt.clear_grad()."""
    with paddle.amp.auto_cast(enable=amp, level="O1", dtype="bfloat16"):
        logits = model(x)
        logp = paddle.nn.functional.log_softmax(logits.astype("float32"), axis=-1)
        loss = -paddle.take_along_axis(logp, y.unsqueeze(-1), axis=-1).mean()
    loss.backward()
    opt.step()
    opt.clear_grad()
    return loss


def vision_optimizer(paddle, model):
    return paddle.optimizer.Momentum(VIS_LR, momentum=VIS_MOMENTUM,
                                     parameters=model.parameters(), weight_decay=VIS_DECAY)


def _is_oom(torch, e):
    return isinstance(e, torch.cuda.OutOfMemoryError) or "out of memory" in str(e)


def phase_vision(torch, mods, card):
    """Phase 16: the layer zoo's conv path (see the module docstring)."""
    paddle, vision, optimizer, spmd = mods
    from paddle_tpu_torch.core import place as pplace

    torch.set_num_threads(os.cpu_count() or 1)
    paddle.set_device("gpu")
    gc.collect()
    torch.cuda.empty_cache()
    failures = []
    smods = (optimizer, spmd)

    # (a) bench.py's smoke model: one O0 step, card against CPU
    t0 = time.perf_counter()
    sb, hw, classes = VIS_SMOKE["batch"], VIS_SMOKE["hw"], VIS_SMOKE["classes"]
    paddle.seed(0)
    model = vision.models.resnet18(num_classes=classes)
    cpu_model = copy.deepcopy(model).to("cpu")
    x, y = vision_data(torch, sb, hw, classes)
    runs = {}
    for dev, m in (("cuda", model), ("cpu", cpu_model)):
        xd, yd = x.to(dev), y.to(dev)
        runs[dev] = vision_run(torch, m, built_step(torch, smods, m, xd, yd), xd, yd)
    failures += [f"(a) {b}" for b in hold_vision_step(
        f"(a) resnet18({classes} classes) at {hw} x {hw}, batch {sb}, O0 float32 step: card "
        "vs CPU", runs["cuda"], runs["cpu"])]
    a_secs = time.perf_counter() - t0

    # (c), first part: the same step in dygraph on the card, from (a)'s start
    paddle.seed(0)
    eager = vision.models.resnet18(num_classes=classes)
    opt = vision_optimizer(paddle, eager)

    def eager_run():
        loss = dygraph_vision_step(paddle, eager, opt, paddle.to_tensor(x.numpy()),
                                   paddle.to_tensor(y.numpy()), amp=False)
        return (loss, {n: opt._accumulators[id(p)][0] for n, p in eager.named_parameters()},
                dict(eager.named_parameters()))

    dyg_run = vision_run(torch, eager, eager_run, x.cuda(), y.cuda())
    failures += [f"(c) O0 {b}" for b in hold_vision_step(
        "(c) the same O0 step in dygraph vs (a)'s build_train_step step, on the card",
        dyg_run, runs["cuda"])]
    del model, cpu_model, eager, opt, runs, dyg_run
    gc.collect()
    torch.cuda.empty_cache()

    # (b) bench.py's run_resnet50
    paddle.seed(0)
    model = vision.models.resnet50()
    model.train()
    n_params = sum(p.numel() for p in model.parameters())
    probe = torch.zeros(1, 3, RESNET_HW, RESNET_HW, device="cuda")
    flops_per_image = 3 * conv_linear_flops(torch, model, probe)
    model.train()
    del probe
    step, init = vision_step(torch, smods, model, amp_level="O1")
    result = None
    for batch in BATCH_CANDIDATES:
        params = state = images = labels = None
        try:
            torch.cuda.reset_peak_memory_stats()
            params, state = init()
            images, labels = (t.cuda() for t in vision_data(torch, batch, RESNET_HW,
                                                           RESNET_CLASSES))
            t = time.perf_counter()
            for i in range(RESNET_WARMUP):
                loss, params, state = step(params, state, images, labels)
            warm = float(loss)
            warm_s = time.perf_counter() - t
            marks = [torch.cuda.Event(enable_timing=True) for _ in range(RESNET_STEPS + 1)]
            losses = []
            t = time.perf_counter()
            marks[0].record()
            for i in range(RESNET_STEPS):
                loss, params, state = step(params, state, images, labels)
                marks[i + 1].record()
                losses.append(loss)
            losses = [float(v) for v in losses]  # readbacks: the window has ended
            window = time.perf_counter() - t
            result = dict(batch=batch, warm=warm, warm_s=warm_s, window=window, losses=losses,
                          steps_ms=[a.elapsed_time(b) for a, b in zip(marks, marks[1:])],
                          peak=torch.cuda.max_memory_allocated())
            break
        except Exception as e:  # noqa: BLE001 - an OOM moves down the candidates
            if not _is_oom(torch, e) or batch == BATCH_CANDIDATES[-1]:
                raise
            log(f"[vision] (b) batch {batch}: out of memory "
                f"({str(e).splitlines()[0][:120]}); trying a smaller batch")
            del e
            params = state = images = labels = None
            gc.collect()
            torch.cuda.empty_cache()
    batch = result["batch"]
    step_ms = _median(result["steps_ms"])
    images_per_s = batch * RESNET_STEPS / result["window"]
    peak_share = flops_per_image * batch / (step_ms / 1e3) / PEAK_OPS_PER_S["bfloat16"]
    log(f"[vision] (b) ResNet-50 ({n_params} parameters) at {RESNET_HW} x {RESNET_HW}, "
        f"{RESNET_CLASSES} classes, O1 bf16 through build_train_step, batch {batch} (bench.py's "
        f"candidates {list(BATCH_CANDIDATES)}): warmup {RESNET_WARMUP} steps {result['warm_s']:.1f} s "
        f"(loss {result['warm']:.4f}); {RESNET_STEPS} timed steps, loss "
        + " ".join(f"{v:.4f}" for v in result["losses"]))
    log(f"[vision] (b) {images_per_s:.1f} images/s over the {RESNET_STEPS}-step window (host "
        f"clock to the last loss's readback, bench.py's measure); median step {step_ms:.2f} ms "
        f"(CUDA events between steps); {flops_per_image / 3 / 1e9:.3f} GFLOP a forward per image "
        f"(conv and linear), x3 a step: {_fmt_pct(peak_share)} of the dense bf16 peak "
        f"(989 TFLOP/s); peak memory {result['peak'] / 2**30:.2f} GiB | {card}")
    if not all(np.isfinite(result["losses"])):
        failures.append(f"(b) loss not finite: {result['losses']}")

    def one_step():
        nonlocal params, state
        _, params, state = step(params, state, images, labels)

    spans = {UPDATE_SPAN: None}
    prof_ms, busy_ms, n_kernels, sums = profile_device(
        torch, one_step, f"ResNet-50 O1 step, batch {batch}", top=12, groups=VISION_GROUPS,
        spans=spans)
    idle = 1 - busy_ms / prof_ms if busy_ms > 0 else None
    upd = spans[UPDATE_SPAN]
    log(f"[profile] device idle {_fmt_pct(idle)} of a ResNet-50 O1 step, {n_kernels} kernels; "
        f"the Momentum update's kernels (the {UPDATE_SPAN} range): "
        + ("not measured" if upd is None else f"{upd:.3f} ms, {100 * upd / busy_ms:.1f}% of "
           "the kernel time, within the elementwise group above"))
    del params, state, step, init, model
    gc.collect()
    torch.cuda.empty_cache()

    # (c) the same ResNet-50 step in dygraph at (b)'s batch
    paddle.seed(0)
    model = vision.models.resnet50()
    opt = vision_optimizer(paddle, model)
    xi, yi = (paddle.to_tensor(t.numpy()) for t in vision_data(torch, batch, RESNET_HW,
                                                                RESNET_CLASSES))
    torch.cuda.reset_peak_memory_stats()
    dyg_losses, dyg_ms = [], []
    for _ in range(RESNET_DYG_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss = dygraph_vision_step(paddle, model, opt, xi, yi, amp=True)
        dyg_losses.append(float(loss.numpy()))
        dyg_ms.append((time.perf_counter() - t) * 1e3)
    dyg_step = _median(dyg_ms[1:])
    log(f"[vision] (c) ResNet-50 O1 dygraph step at batch {batch} (median of steps 2-"
        f"{RESNET_DYG_STEPS}, host clock to the loss's readback): {dyg_step:.2f} ms, "
        f"{batch / dyg_step * 1e3:.1f} images/s; (b)'s build_train_step step {step_ms:.2f} ms; "
        f"loss " + " ".join(f"{v:.4f}" for v in dyg_losses) + f"; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if not all(np.isfinite(dyg_losses)):
        failures.append(f"(c) dygraph loss not finite: {dyg_losses}")
    del model, opt, xi, yi, loss
    gc.collect()
    torch.cuda.empty_cache()

    # (d) eval() forwards, card against CPU
    fwd = {}
    for name, ctor, shape in (("LeNet", lambda: vision.models.LeNet(), (4, 1, 28, 28)),
                              ("mobilenet_v2", vision.models.mobilenet_v2, (2, 3, 224, 224)),
                              ("vgg11", vision.models.vgg11, (2, 3, 224, 224))):
        paddle.seed(0)
        m = ctor().eval()
        cpu_m = copy.deepcopy(m).to("cpu")
        xin = torch.from_numpy(np.random.RandomState(1).rand(*shape).astype(np.float32))
        with torch.no_grad():
            got, want = m(xin.cuda()).cpu(), cpu_m(xin)
        fwd[name] = (got - want).abs().max().item() / want.abs().max().item()
        if not fwd[name] <= TOL_VIS_EVAL:
            failures.append(f"(d) {name} forward {fwd[name]:.2e} of its max")
        del m, cpu_m
    log("[vision] (d) eval() float32 forwards, card vs CPU (tolerance "
        f"{TOL_VIS_EVAL} of the max): " + ", ".join(f"{k} {v:.2e}" for k, v in fwd.items()))
    pplace._CURRENT = pplace.CUDAPlace(0)
    gc.collect()
    torch.cuda.empty_cache()
    if failures:
        fail("vision: " + "; ".join(failures))
    return dict(batch=batch, images_per_s=images_per_s, step_ms=step_ms,
                peak_share=peak_share, idle=idle, kernels=n_kernels, a_secs=a_secs,
                dygraph_step_ms=dyg_step)


# ------------------------------------------------------------------ phase 17
DATA_BATCH, DATA_WORKERS = 64, 2  # (a): BASELINE config 1's fit
DATA_LR = 1e-3
DATA_PARITY_STEPS = 20  # (a): the first step losses held card vs CPU
DATA_KILL_STEP = 10  # (b): SIGTERM at this step of epoch 2 (1-based)
DATA_IMAGES = 2048  # (c): distinct uint8 images held in memory
IMAGENET_MEAN, IMAGENET_STD = [123.675, 116.28, 103.53], [58.395, 57.12, 57.375]
QAT_WARMUP, QAT_STEPS = 3, 10
TOL_DATA_LOSS = 1e-4  # (a): each of the first 20 step losses, card vs CPU, relative
TOL_DATA_RESUME = 1e-6  # (b): resumed vs uninterrupted, of each parameter's max
TOL_ACT_SCALE = 1e-6  # (d)(i): act_scale, card vs CPU, relative
TOL_INT8_EVAL = 1e-3  # (d)(iii): the int8 ResNet-50's eval forward, card vs CPU


def data_classes(paddle):
    """The Callback, Model and DataLoader subclasses phase 17 measures
    through (a user's extensions of the high-level API)."""
    import hashlib

    class StepLog(paddle.callbacks.Callback):
        def __init__(self, seed_epochs=None):
            super().__init__()
            self.losses, self.times, self.seed_epochs = [], [], seed_epochs

        def on_epoch_begin(self, epoch, logs=None):
            if self.seed_epochs is not None:  # each epoch's order from its own seed
                np.random.seed(self.seed_epochs + epoch)

        def on_train_batch_end(self, step, logs=None):
            self.losses.append(logs["loss"])
            self.times.append(time.perf_counter())

    class DigestModel(paddle.Model):
        """Records a digest of every batch train_batch is given."""

        digests = None

        def train_batch(self, inputs, labels=None, update=True):
            if self.digests is not None:
                h = hashlib.sha256()
                for t in list(inputs) + list(labels or []):
                    h.update(np.ascontiguousarray(t.numpy()).tobytes())
                self.digests.append(h.hexdigest())
            return super().train_batch(inputs, labels, update)

    class TimedLoader(paddle.io.DataLoader):
        """Adds the seconds spent in next() and the loop's seconds."""

        wait_s = loop_s = 0.0
        batches = 0

        def __iter__(self):
            it = super().__iter__()
            t_loop = time.perf_counter()
            try:
                while True:
                    t = time.perf_counter()
                    try:
                        batch = next(it)
                    except StopIteration:
                        return
                    self.wait_s += time.perf_counter() - t
                    self.batches += 1
                    yield batch
            finally:
                self.loop_s += time.perf_counter() - t_loop
                it.close()

    return StepLog, DigestModel, TimedLoader


def lenet_model(paddle, net, cls=None):
    model = (cls or paddle.Model)(net)
    model.prepare(paddle.optimizer.Adam(DATA_LR, parameters=net.parameters()),
                  paddle.nn.CrossEntropyLoss(), paddle.metric.Accuracy())
    return model


def lenet_fit(paddle, classes, net, train, test, place):
    """(a)'s fit of ``net`` on ``place``: one epoch of ``train`` at batch 64,
    shuffled from numpy seed 0, through 2 workers; then ``evaluate``."""
    StepLog, DigestModel, TimedLoader = classes
    paddle.set_device(place)
    model = lenet_model(paddle, net, DigestModel)
    model.digests = []
    loader = TimedLoader(train, batch_size=DATA_BATCH, shuffle=True, num_workers=DATA_WORKERS)
    logger = StepLog()
    np.random.seed(0)
    model.fit(loader, epochs=1, verbose=0, callbacks=[logger])
    ev = model.evaluate(test, batch_size=256, verbose=0)
    return dict(model=model, digests=model.digests, losses=logger.losses, eval=ev,
                step_ms=1e3 * loader.loop_s / loader.batches,
                wait=loader.wait_s / loader.loop_s, steps=loader.batches)


def resume_run(paddle, classes, chaos, start, train, save_dir, kill_at=None, resume=False):
    """(b): LeNet from ``start`` fit 2 epochs with ``save_dir`` (each epoch's
    order from its own numpy seed); SIGTERM through chaos at train step
    ``kill_at`` when given. Returns the parameters after the fit."""
    import signal

    StepLog = classes[0]
    net = paddle.vision.models.LeNet()
    net.set_state_dict(start)
    model = lenet_model(paddle, net)
    if kill_at is not None:
        chaos.arm("train.step", signum=signal.SIGTERM, at=chaos.visits("train.step") + kill_at)
    try:
        model.fit(train, batch_size=DATA_BATCH, epochs=2, shuffle=True,
                  num_workers=DATA_WORKERS, verbose=0, save_dir=save_dir, resume=resume,
                  callbacks=[StepLog(seed_epochs=1000)])
    finally:
        chaos.reset()
    return {n: p.detach().clone() for n, p in net.named_parameters()}


class ImageNetLike:
    """(c)'s dataset: DATA_IMAGES uint8 HWC 224 x 224 x 3 images and 1000
    labels from RandomState(0), index modulo DATA_IMAGES over ``length``
    samples; the sample is ``transform(image)``. (Made a ``paddle.io.Dataset``
    in ``phase_data``.)"""

    def __init__(self, length, transform):
        rng = np.random.RandomState(0)
        self.images = rng.randint(0, 256, (DATA_IMAGES, RESNET_HW, RESNET_HW, 3), dtype=np.uint8)
        self.labels = rng.randint(0, RESNET_CLASSES, DATA_IMAGES).astype(np.int64)
        self.length, self.transform = length, transform

    def __getitem__(self, i):
        j = i % DATA_IMAGES
        return self.transform(self.images[j]), self.labels[j]

    def __len__(self):
        return self.length


def first_batch_alone(paddle, ds, batch, seed):
    """The first batch of a worker DataLoader (shuffle, drop_last, numpy
    seed ``seed``) made by a single-process loader: the parent's draws (the
    workers' seed, then the permutation), then worker 0's generator seeded
    as the worker seeds it, over that batch's indices."""
    np.random.seed(seed)
    wseed = np.random.randint(0, 2 ** 31)
    indices = next(iter(paddle.io.BatchSampler(ds, shuffle=True, batch_size=batch,
                                               drop_last=True)))
    np.random.seed(wseed)
    alone = paddle.io.DataLoader(ds, batch_sampler=paddle.io.BatchSampler(
        sampler=indices, batch_size=batch), use_buffer_reader=False)
    return next(iter(alone))


def quant_codes(torch, net):
    """Forward pre-hooks that record, for each QAT layer of ``net``, the
    integer codes its input takes on the grid of the scale the layer uses
    (a train step: the larger of the updated act_scale and the live
    abs-max). -> (codes by layer name, hook handles)."""
    codes, handles = {}, []
    for name, m in net.named_sublayers():
        if hasattr(m, "act_scale") and hasattr(m, "inner"):
            def hook(layer, inputs, name=name):
                x = torch.Tensor.as_subclass(inputs[0], torch.Tensor).detach().float()
                cur = x.abs().amax()
                prev = layer.act_scale
                new = torch.where(prev > 0, 0.9 * prev + 0.1 * cur, cur)
                s = torch.maximum(new, cur) * float(np.float32(1) / np.float32(127))
                codes[name] = torch.clamp(torch.round(x / s), -127, 127).cpu()
            handles.append(m.register_forward_pre_hook(hook))
    return codes, handles


def hold_qat_step(torch, paddle, qnet, x, y):
    """(d)(i): one float32 eager step of the QAT LeNet on the card and on the
    CPU from the same weights and batch -> (failures, errors, act_scale
    count, flips by layer). Phase 5's bounds, but a layer whose quantized
    input took another code on the card than on the CPU somewhere (a flip:
    the two sides' rounding of x / s fell either side of a half) moves its
    own weight's gradient by up to one quantum, 1/127 of its input's
    abs-max; that gradient is held to 1/127 + 1e-3 of its max instead."""
    cpu_net = copy.deepcopy(qnet).to("cpu")
    runs = {}
    for dev, net in (("cuda", qnet), ("cpu", cpu_net)):
        paddle.set_device("gpu" if dev == "cuda" else "cpu")
        opt = paddle.optimizer.Adam(DATA_LR, parameters=net.parameters())
        codes, handles = quant_codes(torch, net)
        loss = paddle.nn.functional.cross_entropy(net(paddle.to_tensor(x)), paddle.to_tensor(y))
        for h in handles:
            h.remove()
        loss.backward()
        grads = {n: p.grad.detach().cpu().clone() for n, p in net.named_parameters()}
        opt.step()
        opt.clear_grad()
        runs[dev] = (float(loss), grads,
                     {n: p.detach().cpu() for n, p in net.named_parameters()},
                     {n: b.detach().cpu() for n, b in net.named_buffers()
                      if n.endswith("act_scale")}, codes)
    paddle.set_device("gpu")
    (gl, gg, gp, gs, gc_), (wl, wg, wp, ws, wc) = runs["cuda"], runs["cpu"]
    flips = {n: int((gc_[n] != wc[n]).sum()) for n in wc}
    grad_errs = {n: (gg[n] - wg[n]).abs().max().item() / max(wg[n].abs().max().item(), 1e-30)
                 for n in wg}
    flipped = {f"{n}.inner.weight" for n, k in flips.items() if k}
    worst = max((n for n in grad_errs if n not in flipped), key=grad_errs.get)
    errs = dict(loss=abs(gl - wl) / abs(wl), grad=grad_errs[worst], grad_name=worst,
                flipped_grad=max([grad_errs[n] for n in flipped] or [0.0]),
                param=max((gp[n] - wp[n]).abs().max().item() for n in wp),
                act_scale=max(abs(gs[n].item() - ws[n].item()) / ws[n].item() for n in ws))
    bad = [k for k, tol in (("loss", TOL_STEP_LOSS), ("grad", TOL_STEP_GRAD),
                            ("flipped_grad", 1 / 127 + TOL_STEP_GRAD),
                            ("param", 2.5 * DATA_LR), ("act_scale", TOL_ACT_SCALE))
           if not errs[k] <= tol]
    if not ws or min(v.item() for v in ws.values()) <= 0:
        bad.append("act_scale not calibrated")
    return bad, errs, len(ws), flips


def model_bytes(model):
    return sum(t.numel() * t.element_size()
               for t in list(model.parameters()) + list(model.buffers()))


def phase_data(torch, mods, card, vis):
    """Phase 17: the data path and the high-level API (see the module
    docstring). ``vis`` is phase 16's result (its batch, images/s, step)."""
    import shutil
    import tempfile

    paddle, spmd, qmm, chaos = mods
    from paddle_tpu_torch.core import place as pplace
    from paddle_tpu_torch.quantization import (ImperativeQuantAware, Int8Conv2D, Int8Linear,
                                               QuantedConv2D, QuantedLinear, quantize_weights)

    failures = []
    classes = data_classes(paddle)
    smods = (paddle.optimizer, spmd)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_data_")
    paddle.set_device("gpu")
    mnist = paddle.vision.datasets
    train, test = mnist.MNIST(mode="train"), mnist.MNIST(mode="test")

    # (a) LeNet through paddle.Model, card and CPU from the same weights
    t0 = time.perf_counter()
    paddle.seed(0)
    net = paddle.vision.models.LeNet()
    start = {k: v.detach().cpu().clone() for k, v in net.state_dict().items()}
    cpu_net = copy.deepcopy(net).to("cpu")
    card_fit = lenet_fit(paddle, classes, net, train, test, "gpu")
    cpu_fit = lenet_fit(paddle, classes, cpu_net, train, test, "cpu")
    paddle.set_device("gpu")
    same_batches = card_fit["digests"] == cpu_fit["digests"]
    loss_errs = [abs(g - w) / abs(w) for g, w in zip(card_fit["losses"][:DATA_PARITY_STEPS],
                                                     cpu_fit["losses"][:DATA_PARITY_STEPS])]
    log(f"[data] (a) LeNet through Model.fit (Adam {DATA_LR}, CrossEntropyLoss, Accuracy), one "
        f"epoch of the synthetic MNIST train split ({len(train)} images) at batch {DATA_BATCH}, "
        f"shuffle, {DATA_WORKERS} workers: {card_fit['steps']} steps; batches card vs CPU "
        f"{'bitwise equal' if same_batches else 'DIFFERENT'} ({len(card_fit['digests'])} "
        f"digests); the first {DATA_PARITY_STEPS} losses' worst relative gap "
        f"{max(loss_errs):.2e} (tolerance {TOL_DATA_LOSS}); evaluate on the test split "
        f"({len(test)}): card acc {card_fit['eval']['acc']:.4f} loss "
        f"{card_fit['eval']['loss']:.4f}, CPU acc {cpu_fit['eval']['acc']:.4f}")
    log(f"[data] (a) card: {card_fit['step_ms']:.3f} ms a step (host clock over the loop, the "
        f"loss read back each step), {_fmt_pct(card_fit['wait'])} of the loop waiting in "
        f"next(loader); CPU {cpu_fit['step_ms']:.3f} ms | {card}")
    if not same_batches:
        failures.append("(a) the card's batches differ from the CPU's")
    if len(loss_errs) < DATA_PARITY_STEPS or not max(loss_errs) <= TOL_DATA_LOSS:
        failures.append(f"(a) step losses card vs CPU {max(loss_errs):.2e}")
    for name, run in (("card", card_fit), ("CPU", cpu_fit)):
        if not run["eval"]["acc"] > 0.9:
            failures.append(f"(a) {name} acc {run['eval']['acc']}")
    a_secs = time.perf_counter() - t0

    # (b) save, load and resume on (a)'s model
    t0 = time.perf_counter()
    model = card_fit["model"]
    state = net.state_dict()
    paddle.save(state, os.path.join(tmp, "lenet.pdparams"))
    back = paddle.load(os.path.join(tmp, "lenet.pdparams"))
    same_state = set(back) == set(state) and all(
        back[k].dtype == state[k].dtype and torch.equal(back[k].cpu(), state[k].cpu())
        for k in state)
    model.save(os.path.join(tmp, "ck"))
    paddle.seed(123)
    fresh_net = paddle.vision.models.LeNet()
    fresh = lenet_model(paddle, fresh_net)
    fresh.load(os.path.join(tmp, "ck"))
    fresh_eval = fresh.evaluate(test, batch_size=256, verbose=0)
    old_opt, new_opt = model._optimizer, fresh._optimizer
    same_acc = all(all(torch.equal(a, b) for a, b in zip(old_opt._accumulators[id(p)],
                                                         new_opt._accumulators[id(q)]))
                   for p, q in zip(old_opt._params, new_opt._params))
    # cuDNN's default backward algorithms may sum in another order run to
    # run; the three fits take its deterministic ones, so that resume is
    # compared with resume and not with the algorithm's order
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        uninterrupted = resume_run(paddle, classes, chaos, start, train, os.path.join(tmp, "a"))
        steps = len(train) // DATA_BATCH + (len(train) % DATA_BATCH > 0)
        resume_run(paddle, classes, chaos, start, train, os.path.join(tmp, "b"),
                   kill_at=steps + DATA_KILL_STEP)
        marker = paddle.resilience.read_resume_marker(os.path.join(tmp, "b"))
        final_absent = not os.path.exists(os.path.join(tmp, "b", "final.pdparams"))
        resumed = resume_run(paddle, classes, chaos, start, train, os.path.join(tmp, "b"),
                             resume=True)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    cleared = paddle.resilience.read_resume_marker(os.path.join(tmp, "b")) is None
    resume_err = max((resumed[n] - uninterrupted[n]).abs().max().item()
                     / uninterrupted[n].abs().max().item() for n in uninterrupted)
    resume_bitwise = all(torch.equal(resumed[n], uninterrupted[n]) for n in uninterrupted)
    log(f"[data] (b) paddle.save/load of the state dict: {len(state)} tensors "
        f"{'bitwise' if same_state else 'DIFFERENT'}; Model.save -> a fresh Model.load: "
        f"evaluate {'equal' if fresh_eval == card_fit['eval'] else 'DIFFERENT'} "
        f"({fresh_eval['acc']:.4f}), Adam's accumulators {'bitwise' if same_acc else 'DIFFERENT'}; "
        f"fit(save_dir, epochs=2) vs SIGTERM (chaos, train step {steps + DATA_KILL_STEP}, epoch "
        f"2) then fit(resume=True), cuDNN's deterministic algorithms: marker {marker}, no final "
        f"snapshot "
        f"{final_absent}, marker cleared after the resume {cleared}; parameters' worst gap "
        f"{resume_err:.2e} of their max (tolerance {TOL_DATA_RESUME}), bitwise {resume_bitwise}")
    if not (same_state and same_acc and fresh_eval == card_fit["eval"]):
        failures.append("(b) save/load not bitwise")
    if not (marker and marker.get("step") == 1 and final_absent and cleared):
        failures.append(f"(b) preemption marker {marker}, final absent {final_absent}, "
                        f"cleared {cleared}")
    if not resume_err <= TOL_DATA_RESUME:
        failures.append(f"(b) resumed parameters {resume_err:.2e} of their max")
    b_secs = time.perf_counter() - t0
    del model, fresh, fresh_net, cpu_net, card_fit, cpu_fit
    gc.collect()

    # (c) phase 16 (b)'s ResNet-50 O1 step fed by a worker DataLoader
    t0 = time.perf_counter()
    T = paddle.vision.transforms
    batch = vis["batch"]
    workers = min(8, os.cpu_count() or 1)
    Dataset = type("ImageNetLike", (ImageNetLike, paddle.io.Dataset), {})
    ds = Dataset(batch * (RESNET_WARMUP + RESNET_STEPS), T.Compose([
        T.RandomHorizontalFlip(), T.Normalize(mean=IMAGENET_MEAN, std=IMAGENET_STD)]))
    loader = paddle.io.DataLoader(ds, batch_size=batch, shuffle=True, drop_last=True,
                                  num_workers=workers, prefetch_factor=2)
    paddle.seed(0)
    model = paddle.vision.models.resnet50()
    model.train()
    step, init = vision_step(torch, smods, model, amp_level="O1")
    params, state = init()
    np.random.seed(0)
    it = iter(loader)
    waits, losses = [], []
    t_window = None
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(RESNET_STEPS + 1)]
    for i in range(RESNET_WARMUP + RESNET_STEPS):
        if i == RESNET_WARMUP:
            torch.cuda.synchronize()
            t_window = time.perf_counter()
            marks[0].record()
        t = time.perf_counter()
        x, y = (torch.Tensor.as_subclass(v, torch.Tensor) for v in next(it))
        if i >= RESNET_WARMUP:
            waits.append(time.perf_counter() - t)
        if i == 0:
            first = (x.clone(), y.clone())
            batch_bytes = x.numel() * x.element_size() + y.numel() * y.element_size()
            on_card = x.is_cuda and y.is_cuda
        loss, params, state = step(params, state, x, y)
        if i >= RESNET_WARMUP:
            marks[i - RESNET_WARMUP + 1].record()
            losses.append(loss)
    losses = [float(v) for v in losses]
    window = time.perf_counter() - t_window
    host = it.timings()
    it.close()
    del it, loader
    steps_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    alone = first_batch_alone(paddle, ds, batch, 0)
    first_equal = all(torch.equal(a, b.to(a.device)) for a, b in zip(first, alone))
    images_per_s = batch * RESNET_STEPS / window
    wait_share = sum(waits) / window
    log(f"[data] (c) ResNet-50 O1 through build_train_step fed by paddle.io.DataLoader "
        f"({DATA_IMAGES} uint8 224 x 224 x 3 images, RandomHorizontalFlip + Normalize in "
        f"{workers} workers, shuffle, drop_last, prefetch_factor 2), batch {batch}: "
        f"{images_per_s:.1f} images/s over {RESNET_STEPS} steps, median step "
        f"{_median(steps_ms):.2f} ms (CUDA events); phase 16 (b), one resident batch, in this "
        f"run: {vis['images_per_s']:.1f} images/s, {vis['step_ms']:.2f} ms; the loop waits in "
        f"next(loader) {_fmt_pct(wait_share)} of the window; a batch {batch_bytes / 1e6:.1f} MB "
        f"(float32 CHW + labels) on the card {on_card}; the parent's seconds a batch receiving "
        f"from the workers' queue {host['recv_s'] / (RESNET_WARMUP + RESNET_STEPS):.3f} and "
        f"placing (pin, copy calls) {host['place_s'] / (RESNET_WARMUP + RESNET_STEPS):.3f}; loss "
        + " ".join(f"{v:.4f}" for v in losses) + f"; the first batch "
        f"{'bitwise' if first_equal else 'DIFFERENT from'} a single-process loader's | {card}")
    if not all(np.isfinite(losses)):
        failures.append(f"(c) loss not finite: {losses}")
    if not (first_equal and on_card):
        failures.append("(c) the first batch is not the single-process loader's on the card")
    c_secs = time.perf_counter() - t0
    del params, state, step, init, model, first, alone, x, y, ds
    gc.collect()
    torch.cuda.empty_cache()

    # (d)(i) QAT LeNet: one step card vs CPU, then Model.fit one epoch
    t0 = time.perf_counter()
    paddle.seed(0)
    qnet = ImperativeQuantAware().quantize(paddle.vision.models.LeNet())
    xs = np.stack([train[i][0] for i in range(DATA_BATCH)])
    ys = np.stack([train[i][1] for i in range(DATA_BATCH)])
    bad, errs, n_scales, flips = hold_qat_step(torch, paddle, qnet, xs, ys)
    failures += [f"(d)(i) step {b}" for b in bad]
    paddle.set_device("gpu")
    qmodel = lenet_model(paddle, qnet)
    np.random.seed(0)
    qmodel.fit(train, batch_size=DATA_BATCH, epochs=1, shuffle=True, num_workers=DATA_WORKERS,
               verbose=0)
    qeval = qmodel.evaluate(test, batch_size=256, verbose=0)
    log(f"[data] (d)(i) ImperativeQuantAware().quantize(LeNet()): one float32 step card vs CPU: "
        f"loss {errs['loss']:.2e} relative (tolerance {TOL_STEP_LOSS}), gradients {errs['grad']:.2e} "
        f"of their max ({errs['grad_name']}; {TOL_STEP_GRAD}); quantization flips (input codes "
        f"card != CPU) by layer {flips}, the flipped layers' weight gradients "
        f"{errs['flipped_grad']:.2e} (1/127 + {TOL_STEP_GRAD}); parameters {errs['param']:.2e} "
        f"(2.5 lr), {n_scales} "
        f"act_scale buffers {errs['act_scale']:.2e} relative ({TOL_ACT_SCALE}); Model.fit one "
        f"epoch: evaluate acc {qeval['acc']:.4f} loss {qeval['loss']:.4f}")
    if not qeval["acc"] > 0.9:
        failures.append(f"(d)(i) QAT acc {qeval['acc']}")
    del qnet, qmodel

    # (d)(ii) QAT ResNet-50, O1 through build_train_step
    paddle.seed(0)
    model = ImperativeQuantAware().quantize(paddle.vision.models.resnet50())
    model.train()
    quanted = [m for m in model.modules() if isinstance(m, (QuantedConv2D, QuantedLinear))]
    step, init = vision_step(torch, smods, model, amp_level="O1")
    result = None
    for qbatch in [b for b in BATCH_CANDIDATES if b <= batch]:
        params = state = data = None
        try:
            for m in quanted:
                m.act_scale.zero_()
            params, state = init()
            # two batches in turn, so the first conv's input (the images)
            # moves its act_scale too
            data = [[t.cuda() for t in vision_data(torch, qbatch, RESNET_HW, RESNET_CLASSES,
                                                   seed=k)] for k in range(2)]
            for i in range(QAT_WARMUP):
                loss, params, state = step(params, state, *data[i % 2])
            # halve every act_scale: each timed step's forward must write it
            # back toward its input's abs-max (a layer whose input keeps one
            # abs-max, the images, sits at that value otherwise)
            for m in quanted:
                m.act_scale.mul_(0.5)
            before = [m.act_scale.item() for m in quanted]
            torch.cuda.synchronize()
            t = time.perf_counter()
            qlosses = []
            for i in range(QAT_STEPS):
                loss, params, state = step(params, state, *data[(QAT_WARMUP + i) % 2])
                qlosses.append(loss)
            qlosses = [float(v) for v in qlosses]
            qwindow = time.perf_counter() - t
            after = [m.act_scale.item() for m in quanted]
            result = dict(batch=qbatch, losses=qlosses, window=qwindow, before=before,
                          after=after)
            break
        except Exception as e:  # noqa: BLE001 - an OOM moves down the candidates
            if not _is_oom(torch, e) or qbatch == BATCH_CANDIDATES[-1]:
                raise
            log(f"[data] (d)(ii) batch {qbatch}: out of memory; trying a smaller batch")
            del e
            params = state = data = None
            gc.collect()
            torch.cuda.empty_cache()
    updated = sum(a > 0 and a != b for a, b in zip(result["after"], result["before"]))
    qips = result["batch"] * QAT_STEPS / result["window"]
    log(f"[data] (d)(ii) QAT ResNet-50 ({len(quanted)} quantized layers) O1 through "
        f"build_train_step, batch {result['batch']}, two batches in turn: {QAT_WARMUP} + "
        f"{QAT_STEPS} steps, loss "
        + " ".join(f"{v:.4f}" for v in result["losses"])
        + f"; {qips:.1f} images/s (phase 16 (b): {vis['images_per_s']:.1f}); act_scale, halved "
        f"before the timed steps, written by them: {updated} of {len(quanted)} | {card}")
    if not all(np.isfinite(result["losses"])):
        failures.append(f"(d)(ii) loss not finite: {result['losses']}")
    if updated != len(quanted):
        failures.append(f"(d)(ii) {len(quanted) - updated} act_scale buffers not updated")
    del params, state, step, init, model, quanted, data
    gc.collect()
    torch.cuda.empty_cache()

    # (d)(iii) quantize_weights(resnet50()): Int8Conv2D + Int8Linear, eval f32
    paddle.seed(0)
    fmodel = paddle.vision.models.resnet50().eval()
    xin = torch.from_numpy(np.random.RandomState(1).rand(8, 3, RESNET_HW, RESNET_HW)
                           .astype(np.float32))
    with torch.no_grad():
        float_out = fmodel(xin.cuda()).cpu()
    float_bytes = model_bytes(fmodel)
    qm, _ = quantize_weights(fmodel)
    n_conv = sum(isinstance(m, Int8Conv2D) for m in qm.modules())
    n_lin = sum(isinstance(m, Int8Linear) for m in qm.modules())
    left = [n for n, m in qm.named_modules() if type(m).__name__ in ("Conv2D", "Linear")]
    cpu_qm = copy.deepcopy(qm).to("cpu")
    wq0 = qmm.launches
    with torch.no_grad():
        got = qm(xin.cuda()).cpu()
        want = cpu_qm(xin)
    wq_launches = qmm.launches - wq0
    int8_err = (got - want).abs().max().item() / want.abs().max().item()
    gap = (got - float_out).abs().max().item() / float_out.abs().max().item()
    q_bytes = model_bytes(qm)
    log(f"[data] (d)(iii) quantize_weights(resnet50()): {n_conv} Int8Conv2D, {n_lin} Int8Linear, "
        f"float layers left {left}; eval() float32 forward at batch 8, 224 x 224: card vs CPU "
        f"{int8_err:.2e} of the max (tolerance {TOL_INT8_EVAL}); gap to the float model's logits "
        f"{gap:.2e} of their max (random weights, no bound); weight_bytes {q_bytes} vs float "
        f"{float_bytes} ({q_bytes / float_bytes:.3f}x); the classifier's wq_matmul launches "
        f"{wq_launches}")
    if n_lin != 1 or left or not n_conv:
        failures.append(f"(d)(iii) {n_conv} Int8Conv2D, {n_lin} Int8Linear, left {left}")
    if not int8_err <= TOL_INT8_EVAL:
        failures.append(f"(d)(iii) int8 forward card vs CPU {int8_err:.2e}")
    d_secs = time.perf_counter() - t0
    del fmodel, qm, cpu_qm
    pplace._CURRENT = pplace.CUDAPlace(0)
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(tmp, ignore_errors=True)
    log(f"[data] parts: (a) {a_secs:.1f} s, (b) {b_secs:.1f} s, (c) {c_secs:.1f} s, (d) "
        f"{d_secs:.1f} s")
    if failures:
        fail("data: " + "; ".join(failures))
    return dict(wq_launches=wq_launches, images_per_s=images_per_s, wait=wait_share,
                qat_images_per_s=qips, recv_s=host["recv_s"], place_s=host["place_s"])


# ------------------------------------------------------- the chunk sweep
def fill_chunk_sweep(torch, fa, mods, card, chunks):
    """``--fill-sweep C1,C2,...``: what the fill's chunk C costs and buys
    the 7B engine. Llama-2-7B bf16 (phase 7's weights, 16 slots x 256,
    prompts up to 128) at each C in turn: phase 7's traffic (24 seeded
    streams of unrelated prompts, 16-128 tokens and 16-96 new, with its
    three extras) through a graphed engine -> tokens/s over the window,
    first-token median, fill replays a joiner; phase 8's (24 streams
    sharing a 96-token system prompt) through a cached engine -> hits,
    tokens/s, first-token median, fills a joiner; the first token alone on
    an idle engine, cold (unrelated 108-128-token prompts) and hit (the
    system prompt's); one fill replay (the last chunk, rows 128-C..127)
    by CUDA events. One JSON line at the end."""
    import gc

    LlamaModel, generation, DecodeEngine, PredictorServer, wire_spec = mods
    model = LlamaModel(device="cuda", generator=torch.Generator(device="cuda").manual_seed(0))
    model.to(torch.bfloat16).eval()
    vocab = model.embed_tokens.weight.shape[0]
    dm = generation.llama_decode_model(model, ENGINE_SLOTS, ENGINE_SEQ)
    rng = np.random.RandomState(6)
    n_streams = ENGINE_FIRST + ENGINE_LATER
    plens = rng.randint(16, ENGINE_PROMPT + 1, n_streams + 3)
    news = rng.randint(16, 97, n_streams + 3)
    base = [dict(prompt=rng.randint(0, vocab, (int(pl),)).astype(np.int32), n=int(nn))
            for pl, nn in zip(plens, news)]
    base[n_streams]["n"] = 96  # the one that hangs up
    system = rng.randint(0, vocab, REUSE_SYSTEM).astype(np.int32)
    shared = [dict(prompt=np.concatenate([system, rng.randint(0, vocab, rng.randint(8, 33))
                                          .astype(np.int32)]), n=int(rng.randint(16, 65)))
              for _ in range(REUSE_STREAMS)]
    hit_probes = [np.concatenate([system, rng.randint(0, vocab, rng.randint(12, 33))
                                  .astype(np.int32)]) for _ in range(4)]
    cold_probes = [rng.randint(0, vocab, p.size).astype(np.int32) for p in hit_probes]
    rows = []
    for c in chunks:
        kw = dict(max_prompt_len=ENGINE_PROMPT, min_seq_bucket=c, max_queue=64)
        engine = DecodeEngine(dm, name=f"sweep-{c}", **kw)
        engine.warmup()
        _, server, win, _ = serve_window(torch, fa, engine, PredictorServer, wire_spec, base)
        stop_server(server, engine, wire_spec)
        d7 = win["delta"]
        hot = DecodeEngine(dm, prefix_max_bytes=REUSE_BUDGET, name=f"sweep-{c}-prefix", **kw)
        hot.warmup()
        srv = PredictorServer(None, decode_engine=hot, own_decode_engine=True)
        got, w8 = burst_window(torch, fa, hot, srv.port, wire_spec, shared)
        if any(r["status"] != wire_spec.STATUS_OK for r in got):
            fail(f"a shared-prefix stream failed at C = {c}")
        cold_s = first_token_alone(hot, cold_probes)
        hits = hot.stats()["prefix"]["hits"]
        hit_s = first_token_alone(hot, hit_probes)
        hit_probe_hits = hot.stats()["prefix"]["hits"] - hits
        with torch.inference_mode(), hot._exec_lock:
            fill_ms = cuda_ms(torch, hot._program(("fill", 1, ENGINE_PROMPT)), iters=10)
        srv.stop()
        hot.close()
        d8 = w8["delta"]
        row = dict(
            chunk=c, p7_tokens_per_s=d7["tokens"] / win["window_ms"] * 1e3,
            p7_ttft_ms=win["ttft_ms"], p7_fills_per_joiner=d7["prefix_fill_steps"] / (
                n_streams + 3), p7_steps=d7["steps"],
            p8_hits=d8["hits"], p8_tokens_per_s=d8["tokens"] / w8["window_ms"] * 1e3,
            p8_ttft_ms=1e3 * float(np.median([r["first_s"] for r in got])),
            p8_fills_per_joiner=d8["prefix_fill_steps"] / len(shared), p8_steps=d8["steps"],
            alone_cold_ms=1e3 * float(np.median(cold_s)),
            alone_hit_ms=1e3 * float(np.median(hit_s)), alone_hits=hit_probe_hits,
            fill_ms=fill_ms)
        rows.append(row)
        log(f"[sweep] C = {c}: phase 7 traffic {row['p7_tokens_per_s']:.1f} tokens/s, first "
            f"token median {row['p7_ttft_ms']:.1f} ms, {row['p7_fills_per_joiner']:.2f} fills a "
            f"joiner, {d7['steps']} steps; phase 8 traffic {d8['hits']}/{len(shared)} hits, "
            f"{row['p8_tokens_per_s']:.1f} tokens/s, first token median "
            f"{row['p8_ttft_ms']:.1f} ms, {row['p8_fills_per_joiner']:.2f} fills a joiner, "
            f"{d8['steps']} steps; alone cold {row['alone_cold_ms']:.1f} ms, hit "
            f"{row['alone_hit_ms']:.1f} ms ({hit_probe_hits}/{len(hit_probes)} hit); a fill "
            f"replay {fill_ms:.3f} ms | {card}")
        del engine, server, hot, srv
        gc.collect()
        torch.cuda.empty_cache()
    log(card)
    log(json.dumps({"fill_sweep": rows}))


# ------------------------------------------------------------------ main
def main():
    sweep = None
    if len(sys.argv) > 1:
        if len(sys.argv) != 3 or sys.argv[1] != "--fill-sweep":
            fail("usage: chip_smoke.py [--fill-sweep C1,C2,...]")
        sweep = [int(c) for c in sys.argv[2].split(",")]
    try:
        import torch
    except ImportError as e:
        fail(f"torch is not importable: {e}")
    t_run = time.perf_counter()
    card = phase_card(torch)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from paddle_tpu_torch import nn, optimizer, quantization
        from paddle_tpu_torch.core import cuda_build
        from paddle_tpu_torch.core import random as prandom
        from paddle_tpu_torch import obs
        from paddle_tpu_torch.core.cuda_graph import Graph, pool_bytes
        from paddle_tpu_torch.distributed import spmd
        from paddle_tpu_torch.inference import wire_spec
        from paddle_tpu_torch.inference.batching import BatchingEngine
        from paddle_tpu_torch.inference.decode import DecodeEngine
        from paddle_tpu_torch.inference.server import PredictorServer
        from paddle_tpu_torch.ops import flash_attention as fa
        from paddle_tpu_torch.ops import quant_matmul as qmm
        from paddle_tpu_torch.resilience import chaos
        from paddle_tpu_torch.text import generation
        from paddle_tpu_torch.text.models import BertForPretraining, BertModel, LlamaModel
        import paddle_tpu_torch as paddle
        from paddle_tpu_torch import vision
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
        # no TPU kernel: the reference's dequantize (quantize_decode_model's
        # unpack), which XLA fuses into the product's read of the weights
        dict(name="wq_matmul", lib="quant_matmul", route="cuda",
             source=src + "quant_matmul.cu", replaces="paddle_tpu/quantization/serving.py:218",
             smem=lambda: ", ".join(f"{str(dt)[6:]} weights {qmm.smem_bytes(dt)} bytes"
                                    for dt in (torch.int8, torch.bfloat16))),
    ]
    t_phase = [time.perf_counter()]

    def took(name):
        now = time.perf_counter()
        log(f"[time] {name} {now - t_phase[0]:.1f} s (the run so far {now - t_run:.1f} s)")
        t_phase[0] = now

    phase_build(torch, cuda_build, fa, kernels)
    took("build")
    if sweep:
        fill_chunk_sweep(torch, fa, (LlamaModel, generation, DecodeEngine, PredictorServer,
                                     wire_spec), card, sweep)
        took("fill sweep")
        return
    cases = phase_kernels(torch, fa)
    took("kernels: K1")
    length_cases = phase_length_kernels(torch, fa)
    chunk_cases = phase_chunk_kernels(torch, fa)
    took("kernels: K1 length and chunk forms")
    bwd_cases = phase_bwd_kernels(torch, fa)
    phase_dropout_placement(torch, fa)
    took("kernels: K2, K3, dropout")
    serving = phase_serving(torch, fa, (BertModel, BatchingEngine, PredictorServer,
                                        wire_spec))
    took("serving")
    train = phase_training(torch, fa, (BertForPretraining, nn, optimizer, spmd, prandom),
                           card)
    took("training")
    gen = phase_generation(torch, fa, (LlamaModel, generation, prandom, Graph, pool_bytes),
                           card)
    took("generation")
    eng = phase_engine(torch, fa, (LlamaModel, generation, DecodeEngine, PredictorServer,
                                   wire_spec), card, gen)
    took("engine")
    reuse = phase_reuse(torch, fa, (generation, DecodeEngine, PredictorServer, wire_spec),
                        card, eng)
    took("reuse")
    spec = phase_spec(torch, fa, (generation, DecodeEngine, PredictorServer, wire_spec), card,
                      eng)
    took("spec")
    robust = phase_robust(torch, fa, (generation, DecodeEngine, BatchingEngine, PredictorServer,
                                      wire_spec, chaos, obs), card, eng, serving["model"])
    took("robust")
    # phase 10's engines are closed; its (phase 7's) bf16 7B goes before the f32 one comes
    eng.pop("model")
    eng.pop("dm")
    gc.collect()
    torch.cuda.empty_cache()
    quant = phase_quant(torch, fa, qmm, (LlamaModel, generation, DecodeEngine, BatchingEngine,
                                         PredictorServer, wire_spec, obs, quantization, Graph),
                        card, eng, serving)
    took("quant")
    mt = phase_translation(torch, fa, nn, card)
    took("translation")
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[memory] {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated before training")
    lm = phase_lm_training(torch, fa, (LlamaModel, nn, optimizer, spmd, prandom), card)
    took("lm training")
    mtt = phase_mt_training(torch, fa, (nn, optimizer, spmd, prandom), card)
    took("mt training")
    gc.collect()
    torch.cuda.empty_cache()
    dyg = phase_dygraph(torch, fa, (paddle, BertForPretraining, BertModel, nn, optimizer, spmd),
                        card, train, serving)
    took("dygraph")
    vis = phase_vision(torch, (paddle, vision, optimizer, spmd), card)
    took("vision")
    data = phase_data(torch, (paddle, spmd, qmm, chaos), card, vis)
    took("data")

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
    # K1's length form at the decode engine's step, bfloat16, with the
    # launches phase 7's run made in it (32 per step); its chunk form at the
    # fill of a whole 128-token prompt (phase 7's engine, C = 128) and at the
    # last chunk of phase 8's (C = 64, start + C = 128), with the launches
    # each phase made in its fills (32 per replay)
    decode, eng_step = (
        next(r for r in length_cases if r["dtype"] == "bfloat16" and r["name"] == name)
        for name in ("llama_decode", "engine_step"))
    eng_fill, reuse_fill = (
        next(r for r in chunk_cases if r["dtype"] == "bfloat16" and r["sq"] == c
             and r["sk"] == ENGINE_PROMPT) for c in (ENGINE_CHUNK, REUSE_CHUNK))
    # K1's float32 forms at head_dim 128, phase 11's f32 engine's step and
    # fill, with the launches its window made in each
    f32_step = next(r for r in length_cases if r["dtype"] == "float32"
                    and r["name"] == "engine_step")
    f32_fill = next(r for r in chunk_cases if r["dtype"] == "float32" and r["sq"] == ENGINE_CHUNK
                    and r["sk"] == ENGINE_PROMPT)
    # wq_matmul: every (form, M, K, N) of phase 11, the w8 step's gate/up
    # product as the headline
    wq_main = next(r for r in quant["kernel_cases"] if r["form"] == "w8"
                   and r["m"] == ENGINE_SLOTS and r["n"] == 11008)
    # K1's float32 forms in phase 12's translation: the encoder's, a
    # decode step's cross-attention (64 source rows) and its self-attention
    # at the first, a middle and the last cache length of the 114 steps
    mt_forms = {f"mt_{name}_f32_": next(r for r in cases if r["dtype"] == "float32"
                                        and r["h"] == 8 and r["sq"] == sq and r["sk"] == sk)
                for name, sq, sk in (("encoder", 64, 64), ("cross", 1, 64), ("self_sk1", 1, 1),
                                     ("self_sk37", 1, 37), ("self_sk114", 1, 114))}

    # this slice's training forms (phases 13 and 14): K1-K3 at Llama-374M's
    # [8 * 8, 2048, 128] bf16 causal (O1) and its parity step's [1 * 8, 2048,
    # 128] float32, and at Transformer-base's [64 * 8, 64, 64] (encoder) and
    # [64 * 8, 48, 64 keys, 64] (cross-attention) bf16 with dropout 0.1
    def train_form(rows, b, sq, dt):
        return next(r for r in rows if r["h"] == 8 and r["b"] == b and r["sq"] == sq
                    and r["sk"] == (2048 if sq == 2048 else 64) and r["dtype"] == dt
                    and r["d"] == (128 if sq == 2048 else 64))
    lm_o1, lm_o0, mt_enc, mt_cross = (
        (train_form(cases, b, sq, dt), train_form(bwd_cases, b, sq, dt))
        for b, sq, dt in ((8, 2048, "bfloat16"), (1, 2048, "float32"), (64, 64, "bfloat16"),
                          (64, 48, "bfloat16")))
    # launches of each form on the main paths: phase 13's O1 steps (and its
    # recompute step's K1 twice) and parity step; phase 14's O1 steps (one
    # encoder and one cross call a layer each) and parity step (float32)
    lm_launch = dict(fwd=lm["counts"]["fwd"] + lm["rc_counts"][0],
                     bwd_dq=lm["counts"]["bwd_dq"] + lm["rc_counts"][1],
                     bwd_dkv=lm["counts"]["bwd_dkv"] + lm["rc_counts"][2])
    mt_form = mtt["forms"]  # phase 14's O1 launches by form, counted by the wrapper

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
             launches=(serving["launches"] + train["counts"]["fwd"] + gen["launches"]
                       + eng["launches"] + reuse["launches"] + spec["launches"]
                       + robust["launches"] + quant["launches"] + mt["launches"]
                       + lm_launch["fwd"] + lm["parity_counts"][0] + mtt["counts"]["fwd"]
                       + mtt["parity_counts"][0] + dyg["counts"]["fwd"] + dyg["extra"][0]),
             # phase 15's: its O1 dygraph steps (its (a) and (b) steps are in
             # launches above)
             dygraph_launches=dyg["counts"]["fwd"],
             # phase 10's: its 7B windows (faults, retries, telemetry) and
             # its BERT batches
             robust_launches=robust["launches"],
             # phase 9's: in its verify replays (k a layer each) and in its
             # drafts' fills and steps
             spec_verify_launches=spec["verify_launches"],
             spec_draft_launches=spec["draft_launches"],
             max_abs_err=main["max_abs_err"], **timing(main), bound_ms=main["bound_ms"],
             bound_by=main["bound_by"],
             # K1 at the training shape, [64 * 12, 128, 64] bfloat16
             **fields(train_fwd, "train_bf16_"),
             **fields(prefill, "llama_prefill_bf16_", launches=gen["prefill_launches"]),
             **fields(decode, "llama_decode_bf16_", launches=gen["decode_launches"]),
             **fields(eng_step, "engine_step_bf16_", launches=eng["step_launches"],
                      same_bits_wider=eng_step["same_bits_wider"],
                      same_bits_other_lengths=eng_step["same_bits_other_lengths"]),
             **fields(eng_fill, "engine_fill_bf16_", launches=eng["fill_launches"],
                      same_bits_wider=eng_fill["same_bits_wider"]),
             **fields(reuse_fill, "reuse_fill_bf16_", launches=reuse["fill_launches"],
                      same_bits_wider=reuse_fill["same_bits_wider"]),
             # phase 11: its quantized windows, the f32 engine's, BERT w8
             quant_launches=quant["launches"],
             **fields(f32_step, "engine_step_f32_", launches=quant["modes"]["f32"]["k1_step"],
                      same_bits_wider=f32_step["same_bits_wider"],
                      same_bits_other_lengths=f32_step["same_bits_other_lengths"]),
             **fields(f32_fill, "engine_fill_f32_", launches=quant["modes"]["f32"]["k1_fill"],
                      same_bits_wider=f32_fill["same_bits_wider"]),
             # phase 12: its four runs' launches (encoders, 12 a step)
             mt_launches=mt["launches"],
             **{k: v for prefix, r in mt_forms.items() for k, v in fields(r, prefix).items()},
             # phases 13 and 14: the training forms
             **fields(lm_o1[0], "lm_train_bf16_", launches=lm_launch["fwd"]),
             **fields(lm_o0[0], "lm_parity_f32_", launches=lm["parity_counts"][0]),
             **fields(mt_enc[0], "mt_train_encoder_bf16_", launches=mt_form["encoder"]["fwd"]),
             **fields(mt_cross[0], "mt_train_cross_bf16_", launches=mt_form["cross"]["fwd"])),
        *(dict(name=kernels[i]["name"], route="cuda", source=kernels[i]["source"],
               replaces=kernels[i]["replaces"],
               launches=(train["counts"][key] + lm_launch[key] + lm["parity_counts"][i]
                         + mtt["counts"][key] + mtt["parity_counts"][i] + dyg["counts"][key]
                         + dyg["extra"][i]),
               bert_launches=train["counts"][key], dygraph_launches=dyg["counts"][key],
               **bwd(bmain, which), **bwd(bf32, which, "f32_"),
               **bwd(lm_o1[1], which, "lm_train_bf16_"), lm_train_bf16_launches=lm_launch[key],
               **bwd(lm_o0[1], which, "lm_parity_f32_"),
               lm_parity_f32_launches=lm["parity_counts"][i],
               **bwd(mt_enc[1], which, "mt_train_encoder_bf16_"),
               mt_train_encoder_bf16_launches=mt_form["encoder"][key],
               **bwd(mt_cross[1], which, "mt_train_cross_bf16_"),
               mt_train_cross_bf16_launches=mt_form["cross"][key])
          for i, key, which in ((1, "bwd_dq", "dq"), (2, "bwd_dkv", "dkv"))),
        dict(name=kernels[3]["name"], route="cuda", source=kernels[3]["source"],
             replaces=kernels[3]["replaces"],
             launches=quant["wq_launches"] + data["wq_launches"],
             bert_launches=quant["bert_wq_launches"],
             # phase 17 (d)(iii): the int8 ResNet-50's classifier (an Int8Linear)
             data_launches=data["wq_launches"], max_abs_err=wq_main["max_abs_err"],
             **timing(wq_main), bound_ms=wq_main["bound_ms"], bound_by=wq_main["bound_by"],
             cuda_core_bound=wq_main["cuda_core_bound"],
             **{f"{r['form']}_m{r['m']}_k{r['k']}_n{r['n']}_{k}": r[k]
                for r in quant["kernel_cases"]
                for k in ("max_abs_err", "rel_err", "same_bits_m", "ms", "device_ms",
                          "plain_ms", "plain_device_ms", "library_ms", "library_device_ms",
                          "bound_ms", "bound_by", "cuda_core_bound", "splits")}),
    ]
    log(card)
    log(json.dumps({"kernels": line}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
