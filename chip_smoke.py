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
              float32 and bfloat16 (FORMS and TRAIN_FORMS in float16 too,
              phase 21 (a)); check that dropout lands exactly where
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
              the CPU's perturbed scores; (b) at full width, depth 8
              (LLAMA_LAYERS, as phases 7-10), in bfloat16 (weights drawn
              on the card), bench.py's decode
              shape, 16 prompts x 128 tokens and 128 new tokens: greedy
              tokens bitwise equal to the same call with the steps run
              eagerly, K1 launched exactly depth x 128 times (the replays
              credit theirs), every chosen token within 3e-2 of the row's
              max |logit| of the top logit of one full forward over the
              output; the sampled call, graphed and eager, bitwise equal;
              (c) the generic full-width path, 4 tokens at batch 2, depth x
              4 launches; (d) prefill ms; the decode loop eager (its first
              31 steps only, to keep the script inside its time) and
              graphed (all 126 replays), tokens/s over each whole window
              beside the two-term bound, median step, capture ms and the
              graph pool's bytes; one replay profiled (depth K1 records, the
              idle share)
  7. engine   the continuous-batching decode engine, filling each prompt
              in one chunk of 128 (its traffic shares no prefix, and a
              fill costs about the same at any chunk up to 128, so the
              fewest fills win; `--fill-sweep`): (e) full width,
              depth 2, float32, the same 4 requests through the engine on
              the card and on the CPU (tokens equal, or a near-tie of the
              CPU's logits), then phase 8's (a); then Llama-2-7B bf16 at full width, depth 8
              (weights drawn on the card), 16 slots x 256 positions, behind
              PredictorServer on localhost: 24 streams (16 at once, 8 more
              as the first retire; prompts 16-128, 16-96 new tokens, seeded),
              one client hanging up after its 4th chunk, one with a 1 ms
              per-token budget, one one-shot. It fails unless (a) every
              stream is well formed with exactly its tokens, the 1 ms one
              ends in status 2 and every slot is free after; (b) four
              sequences decoded again alone give the same tokens, bitwise;
              (c) every token lies within 3e-2 of the row's max |logit| of
              the top logit of a full forward; (d) K1 ran depth x (fill
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
              (b) Llama-2-7B's width at depth 8 (QUANT_LAYERS) in
              float32 (weights from seed 0, 14 GB; phase 10's
              bf16 weights freed first), engines of phase 7's
              configuration under quant f32, then w8, then bf16w, one at a
              time, each behind PredictorServer serving phase 7's 24 streams
              and extras: streams whole, 3 re-decoded alone bitwise, each
              program captured once, no breaker tripped, the mode on
              stats()["quant"] and the compiles' quant label, K1 = depth x
              (fill replays + steps), wq_matmul = (7 x depth + 1) x step
              replays + 7 x depth x fill replays (0 under f32); the last
              prompt token's logits of
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
 18. deploy   the deployment path on phase 4's BERT-base (float32, seed 0):
              (a) paddle.jit.save at InputSpec([None, 512], "int32") on the
              card, inference.create_predictor(Config(path)): Predictor.run
              of 1, 2 and 8 rows within 1e-3 of the CPU and bitwise the
              eager model's call on the same slabs, K1 12 a slab counted
              through the loaded program; a save made on the CPU loaded
              onto the card; (b) serve_model(dynamic_batching=True,
              max_batch_size=8) at slabs of 2 and of 8 rows: phase 4's 1-,
              2- and 3-row requests, the 8-client burst, a 2-row and a 3-row
              request together; every >= 2-row and solo 1-row reply bitwise
              Predictor.run of its rows (n/n printed), K1 12 a program call,
              each slab's window timed; (c) seed-1 weights saved and swapped
              in by cmd 4 while 8 clients send 2-row requests: no reply
              failed or dropped, each bitwise the p1 or the p2
              Predictor.run, the reload's load and warm seconds; (d) cmd 8:
              health draining, a new request answered status 2;
              jit.save(quant="w8") served by serve_model(quant="w8"): its
              replies within ACCURACY_BOUNDS["w8"] of the f32 ones,
              wq_matmul 73 a program call; an f32 save refused under w8 at
              load and by cmd 4; (e) to_static: a BERT-base O0 float32 step
              at depth 2 against the dygraph step (phase 5's bounds), 20 O1
              steps at 64 x 128 with K1-K3 12 each a step through the
              captured program and the step's ms beside phase 15's,
              resnet18's O0 step against dygraph with TF32 on globally
              (phase 16 (a)'s bounds), ResNet-50 O1 at phase 16 (b)'s batch
              (images/s beside phase 16's); the phase's seconds
 19. static   the static-graph facade, paddle.fluid and ONNX export: (a)
              fluid's classic script (fluid.layers.fc on [None, 3], SGD
              0.1, 25 exe.run on RandomState(0) data) on the card, the
              CPU run's weights carried by static.save/static.load: the
              losses within 1e-5 of the CPU's, falling 10x; (b) a BERT-base
              classifier program (phase 5's O0 shape: batch 4 x 128, depth
              2, float32, dropout 0, Linear(768, 2) on the pooled output,
              AdamW with ClipGradByGlobalNorm), one Executor.run step on the
              card and on the CPU from the same weights (copied by
              position), held to phase 5's bounds, K1-K3 2 each; (c) the
              same program at full depth at 64 x 128, 3 + 20 Executor.run
              steps on one batch: the loss finite and falling, K1, K2 and K3
              12 each a step, the median step, one step profiled (kernels
              by group, idle share), peak memory, and the same model's
              float32 build_train_step step, 5 each in alternating pairs;
              (d) save_inference_model of (c)'s clone(for_test=True), then
              create_predictor(Config(path)): Predictor.run within 1e-3 of
              Executor.run of the clone, K1 12 a call, the save and load
              seconds; (e) ResNet-50 as a static program (float32,
              Momentum(0.1, 0.9, weight decay 1e-4) as bench.py's
              run_resnet50), the first of bench.py's batches from 512 that
              fits, 3 + 10 steps, the loss finite; images/s, peak memory;
              (f) paddle.onnx.export on the card of BERT-base (eval, seed
              0) at [2, 128] and ResNet-50 at batch 2: the bytes parsed and
              run by onnx.run within 1e-3 of the live card forward's max for
              every output, K1 12 in the BERT forward; the export seconds,
              node count and file size; (g) the phase's seconds
 20. fleet    the fleet tier, after the parent released its earlier models
              (gc, empty_cache, mem_get_info printed); (b)'s replica
              processes start first, beside (a): (a) three serve_model
              replicas of phase 18's seed-0 BERT-base save (float32, [None,
              512], max_batch_size 8, slab 8), processes started together
              by subprocess_spawner, behind Fleet (Autoscaler 3..3, supervisor
              tick 0.2 s; router max_inflight 8, 4 tries, backoff 0.01-0.2
              s: bench.py run_fleet's layout) under run_fleet's two tenants
              (noisy: weight 1, queue 8, 16 connections; polite: weight 4,
              queue 64, 4 connections, a 1500 ms wire deadline), client
              threads in closed loop on 1-row seq-512 requests: a healthy
              round of 4 s, then a chaos round of 8 s in which one replica
              is SIGKILLed mid-storm; every reply status 0 and bitwise the
              parent's Predictor.run of its rows at slab 8, or status 2;
              the polite p99 inside its deadline in both rounds; the killed
              replica respawned and routable again (its seconds printed);
              the serving-goodput ratio chaos / healthy; K1 12 a program
              call in every replica (their cmd-5 stats); then
              rolling_reload to the seed-1 save under 8 clients, every
              reply bitwise the seed-0 or the seed-1 Predictor.run, none
              failed; (b) Llama-2-7B's width at depth 8
              (FLEET_LLAMA_LAYERS), bf16 (seed 0, phase 7's engine: 16 slots x
              256, chunk 128) in three `--decode-replica`
              processes started together under Fleet(pools: prefill 1,
              decode 2) with a shared persistent prefix tier, free memory
              printed before and after: 6 streams (16-128-token prompts, 48
              new tokens) each bitwise the same prompt sent plainly to one
              decode replica, taken before any chaos (and one prompt alone
              on each replica, bitwise), handed off (handoffs ok, none
              failed, no snapshot frame leaked); 4 streams of 96 tokens with
              the decode replica whose engine holds most of them (cmd-3
              health) SIGKILLed once every stream holds 12 tokens (each
              then past its handoff), each one unbroken status-0 stream
              bitwise the unbroken one through kv_resume
              (paddle_decode_resumes_total counted); the supervisor's
              respawn, whose first request, the 128-token prompt seen
              before, hits the persistent tier and is bitwise the cold
              stream; K1 32 a fill and a step in every live replica; the
              prefill replica SIGKILLed and 3 new streams degraded to
              colocated serving (counted), bitwise; the router's live
              snapshot count 0 after each round. Printed beside the card:
              time to first token and inter-token p50/p99, the handoff's
              and the resume's ms, respawn to routable, the goodput ratio,
              the phase's seconds
 21. safety   training safety and precision: (a) is part of phase 3 (the
              float16 forms of K1-K3 at FORMS, TRAIN_FORMS and BERT-base's
              fp16 training shape, [64 * 12, 128, 64] with and without
              dropout, held at the bf16 tolerances, the dropout placement
              in fp16 too); (b) BERT-base fp16 O1 dygraph with
              GradScaler(init_loss_scaling 2^15, the reference's defaults):
              a depth-1 step at batch 2 x 128 on the card and on the CPU
              from the same weights (the scaler's skips before the taken
              step equal; then test_torch_train.py's O1 bounds), then 3 +
              20 full-depth steps at 64 x 128 on one batch: the loss finite
              and falling, K1-K3 12 times a step in their fp16 form
              (form_launches), the scale after each step, the steps
              skipped, the median step beside phase 15's bf16 step; (c) an
              inf injected into the loss under a scaler with a
              BadStepMonitor attached: skipped, parameters bitwise, the
              scale halved, counted bad; build_train_step(O1, float16,
              bad_step_guard=True) at depth 2 (batch 4, a loss weighted per
              position, so a batch can carry a NaN): a NaN batch gives bad
              with params and opt_state (donated) bitwise unchanged; a
              BadStepMonitor(threshold 3) over a CheckpointManager: three
              NaN batches -> ROLLBACK, restore() gives the saved params
              bitwise, and 5 more steps lower the loss; (d) Llama-374M at
              phase 13's O1 bf16 step, 3 + 5 steps resident and with
              offload=True from the same weights: losses and final params
              bitwise equal, every non-scalar state tensor pinned on the
              host; step ms and peak memory of both; (e) the phase's
              launches and seconds
 22. leaves   the detection ops, DCN, the flat-list quantized model and
              the small leaves, each card vs the port's CPU run of the same
              call: (a) YOLOv3's three heads (yolov3_darknet53_270e_coco at
              608, batch 8: 22,743 boxes x 80 classes an image) through
              yolo_box on the card (boxes, scores 1e-5), then every image's
              multiclass_nms (its config) and matrix_nms (ppyolo's) on the
              host (a forkserver pool of worker processes, the port
              imported once): the kept rows the CPU run's, a row kept by
              one run only
              exempted only within 1e-5 of a threshold or tie, under 1% of
              the rows; (b) Faster R-CNN FPN at 800 x 1333, batch 2: 1,000
              proposals an image through collect_fpn_proposals,
              distribute_fpn_proposals (bitwise) and roi_align per level
              with boxes_num, [2000, 256, 7, 7] at 1e-5, the four maps'
              gradients at 1e-4 of each max; (c) DeformConv2D(512, 512, 3)
              v2 and v1 at [8, 512, 19, 19]: forward 1e-4, the gradients to
              x, offset, mask, weight and bias 1e-3 of each max, once
              through static.nn.deform_conv2d in a Program; (d) a depth-2
              Llama-2-7B-width model as a flat param list, quantized w8
              and bf16w, 16 streams of 64 + 32 tokens: tokens bitwise
              _LlamaWeights.quantized's, wq_matmul 14 a fill and 15 a step,
              prompt logits within ACCURACY_BOUNDS of f32's, no f32 weight
              copy (the graphs' pool and the window's peak); (e) the
              distributions from one key, hessian, a CUDA dlpack round
              trip, run_check, a g++ custom op with its _grad on CUDA
              tensors, a profiler window naming its step. Printed beside
              the card: each part's ms and the phase's seconds
 23. dp       data-parallel BERT-base (phase 5's config, global batch 64 x
              128) by two ranks of the port's launcher sharing the card
              over gloo (--gpus 0,0 --backend gloo; NCCL refuses two ranks
              on one device), each its half through build_train_step(mesh=
              build_mesh(dp=2)): (a) 3 O0 f32 steps with dropout 0.1
              against the one-device step at 64 x 128 in this process
              (losses 1e-4, step-1 gradients 1e-3 of max, parameters 2.5
              lr), the ranks' parameters bitwise each step, K1-K3 12 a step
              a rank in the f32 form; (b) 8 O1 bf16 steps: the loss falls;
              each rank's step ms (CUDA events), the gradient all-reduce's
              ms (its profiler range on rank 0), rank 0's idle share, peak
              memory a rank, beside the one-rank O1 step at 64 x 128;
              (c) fleet.init, distributed_model, distributed_optimizer, 3
              dygraph O0 steps at dropout 0: the global loss 1e-4 of this
              process's full-batch run; (d) every ReduceOp of all_reduce,
              broadcast, all_gather, reduce, scatter, all_to_all,
              alltoall_single, barrier, send/recv and the p2p Transport
              with two tags on CUDA tensors, bitwise numpy, outputs on
              cuda:0; (e) a one-rank nccl group in this process: the same
              collectives and DataParallel.apply_collective_grads the
              identity, then destroyed; (f) the pods are one
              launch_elastic(max_restarts=1): PADDLE_TPU_CHAOS kills rank 1
              of the first at its second train.step of a 2-layer model at
              full width (the ranks' first work), the watcher tears that
              pod down and raises, and the restarted pod trains the model
              through, its losses bitwise the killed pod's first step and
              an unbroken run of the model at the pod's end; K1-K3 with
              bh_offset at a rank's [32 * 12, 128, 64] (f32, bf16) against
              their plain versions and the global call's rows, timed
 24. meshed   meshed training, run by phase 23's restarted pod after its
              phase-23 work (no second pod), on phase 23's BERT-base and
              each rank's 32 x 128: (a) build_train_step(sharding_stage=0..3)
              on build_mesh(dp=1, sharding=2), 3 O0 f32 steps each with
              AdamW and ClipGradByGlobalNorm(1.0): losses 1e-4 and the
              gathered parameters 2.5 lr of phase 23's one-device run at
              64 x 128, stage 1 bitwise stage 0, the ranks' gathered
              parameters bitwise, a rank's optimizer state <= 0.51 of the
              whole and stage 3's parameters at rest too, peak memory a rank
              beside stage 0's; (b) build_fsdp_train_step over a
              BERT-base-width Sequential (the embeddings, 12 x
              TransformerEncoderLayer(768, 12, 3072), a head from 20
              positions a row to the 30,522 words), 3 O0 steps: losses 1e-4
              and parameters 2.5 lr of the same function by one process
              here, at most one gathered trunk layer alive (counted by the
              gather), the peak below stage 0's; (c) build_mesh(dp=2):
              fp16_allreduce, 3 O0 steps, losses 1e-3 of the f32 exchange's
              (DGC at sparsity 0, which sends each gradient whole), the
              all-reduce's float16 bytes; DGC at sparsity 0.999, 6 O1 steps,
              the loss falls; in both the ranks' parameters bitwise each
              step and their (u, v) not; dgc_sparsify on the card bitwise
              its CPU run; (d) LocalSGD (k_steps 2) and adaptive LocalSGD
              (init_k_steps 2, begin_step 2), 6 O1 steps each: the replicas
              bitwise exactly after each sync, the loss falls, k printed;
              (e) ResNet-50 over the mesh, 2 x 16 images at 224, SGD at
              1e-4, 3 O0 steps in float32 (the first step's loss 1e-4 and
              running statistics 1e-4 of the one-device run at 32 images;
              the later steps printed: ResNet-50's f32 gradients are noise
              at a step's scale, meshed_resnet_step) and in float64 (every
              step's loss, statistics and update 1e-6); (f)
              group_sharded_parallel('os_g') with DataParallel, phase 23
              (c)'s 3 dygraph steps: the parameters bitwise (c)'s, the
              accumulators <= 0.51 of the whole a rank. Every mode's K1-K3
              launches a rank held by form and its step ms a rank printed
 25. model parallel  in phase 23's two ranks after phase 24's modes,
              Llama-374M's width (bench.py:192: vocab 32000, hidden 1024,
              8 heads of 128, FFN 2816) at depth 4 (MP_CFG, a cut), random
              weights from a seed, the one-device references computed in
              this process on the card: (a) LlamaModel(tensor_parallel=True)
              through build_train_step over build_mesh(mp=2), AdamW 1e-4
              with ClipGradByGlobalNorm(1.0), 3 O0 float32 steps at 2 x 512:
              losses within rtol 2e-4 / atol 2e-5 of the one-device step,
              the gathered parameters within 2.5 lr, the RMSNorm weights
              bitwise on both ranks, a rank's stamped bytes 0.50 of the
              whole, K1-K3 4 launches a step each at 4 heads a rank, and
              one SGD step (lr 1e4, no clip) from the same weights, whose
              update is lr times the gradient: within 1e-3 of each tensor's
              one-device gradient's max; (b) fleet's pipe mode (pp_degree
              2, accumulate_steps 4): a PipelineLayer (the embedding, the
              decoder layers, the norm and head) through
              distributed_model(...).train_batch, 3 O0 steps at 4 x 512
              and one SGD step: losses, state_dict and gradient against
              the sequential one-device path (the same bounds), the loss
              bitwise on both ranks, schedule_stats and each rank's ms in
              recv; (c) ring_attention over build_mesh(sp=2) at [2, 8,
              2048, 128] causal, 1024 positions a rank, forward and
              backward in float32 and bfloat16: the ranks' O and dQ/dK/dV
              joined against the one-device K1-K3 on the whole sequence
              (float32 1e-5, bfloat16 2e-2 of the max) and against the plain
              fold on the card; rank 0 runs one block (its diagonal, K1-K3
              causal), rank 1 two (and its earlier block unmasked), as the
              wrapper counts them by mask; the ring's ms a call, each
              hop's ms through the host. K1-K3 are timed first at the
              forms (a)-(c) give them. Every mode's launches held by form
              and mask, its step ms a rank printed
 26. state and experts  in phase 23's two ranks after phase 25's
              modes, and in this process: (a) phase 24 (a)'s ZeRO-1 and
              ZeRO-2 BERT-base steps and phase 25's mp=2 and pp=2 Llama
              steps each save their state through
              MultiProcessShardedManager before their last step
              (distributed/checkpoint.py, the host-sharded format); this
              process verifies each manifest, holds each rank's shard to
              a digest of its blocks, restores the checkpoint onto one
              device bitwise the ranks' blocks gathered by
              convert.from_rank_states, and takes the last step there
              (losses and parameters within phase 24's / 25's bounds; the
              pp stages [2, 2, ...] onto a pp=1 pipeline's [1, 4, ...]);
              (b) the restarted pod ends under a non-blocking elastic
              client (resilience/elastic.py): rank 1 sends itself SIGTERM
              at its third step of (c)'s capacity blocks over ep=2, both
              ranks agree on one step, save it through the manager (the
              client's barriers) and exit 143; launch_elastic raises
              PodPreempted without relaunching; the checkpoint restores
              onto one device bitwise; the consensus latency and each
              rank's save seconds printed; (c) two x + MoELayer(x) blocks
              at Switch-Base-8's expert widths (768, 3072, 8 experts,
              top_k 2, capacity factor 1.25: capacity mode) on 32 x 128
              tokens: f32 forward + backward on the card against the CPU
              (1e-4 of each tensor's max), its ms and peak memory; the two
              ranks over build_mesh(ep=2) in capacity and alltoall mode,
              2 Adam steps: losses 1e-4 of the one-device step, the
              gathered parameters 2.5 lr, a rank holding half the
              experts. No kernel of the port runs in the experts (plain
              products, as the reference leaves them to XLA)
 27. meshed serving  (inference/sharding.py; every shard of (a) and
              (b) on card 0 through mesh_devices=["cuda:0"] * n, so the
              times hold bits and bytes, not cross-card latency): (a)
              phase 18's seed-0 BERT-base save served by serve_model on
              the wire under "single", "tp2" and "fsdp2xtp2": replies
              within SHARDED_FLOAT_TOL of the single engine's (bitwise
              printed), 12 K1 launches a batch, the mesh in cmd-3/5, the
              compile ledger's bucket events tagged with the mesh, the
              per-shard weight bytes against the model's, the card's peak
              memory and a full batch's ms on the wire; (b) phase 7's
              Llama-2-7B-width bf16 weights (depth LLAMA_LAYERS, no new
              init) in a tp2 DecodeEngine, captured: four prompts decoded
              together equal each decoded alone bitwise, and the single
              mesh's tokens or a near-tie (2e-2 of the logits' max, the
              bf16 TIE) where they part; every stream teacher-forced on
              the single mesh's tokens through both meshes' weights, tp2's
              logits within 2e-2 of the single mesh's max at each of the
              4 x 32 positions and its top token the single mesh's or a
              near-tie; K1 = depth x (fill replays + steps); a step
              replay's device ms beside the single mesh's; (c) in phase
              23's two ranks after phase 25: a BERT-base save under tp2
              over the rank backing (each rank its own blocks, the
              products' all_gathers over gloo, eagerly), rank 0's replies
              within SHARDED_FLOAT_TOL of its single engine's
 28. summary  a {"kernels": [...]} line, then as the last line
              {"ok": true, "device": {"platform": "gpu", ...}}

Each phase's seconds are printed as "[time]" lines.

    python3 chip_smoke.py --fill-sweep 32,64,128

instead builds the kernels and measures the 7B engine at each fill chunk
(fill_chunk_sweep): the numbers the chunks above were chosen by.

    python3 chip_smoke.py --depth-sweep 8,16,8

runs phase 5's BERT and then phases 6-10 at each Llama-2-7B depth in turn
on one host (depth_sweep): the seconds LLAMA_LAYERS was chosen by.

    python3 chip_smoke.py --decode-replica PORTFILE PHASE PREFIX_DIR

is one of phase 20 (b)'s replica processes (decode_replica), which the
phase starts itself.

    python3 chip_smoke.py --leaves

builds the kernels and runs phase 22 alone, and

    python3 chip_smoke.py --dp

phases 23-26 (and 27 (c)) alone; ``--dp-rank OUT`` is one of their
ranks, which phase 23 starts through the port's launcher.

    python3 chip_smoke.py --meshed-serving

builds K1 and runs phase 27 (a) and (b) alone, over a seed-0 BERT-base
save and a seed-0 Llama-2-7B-width bf16 model of its own.

It imports nothing of JAX or the JAX package. Run from a directory that
holds only this file it fails at the import of paddle_tpu_torch.
"""
import atexit
import copy
import gc
import json
import multiprocessing as mp
import os
import signal
import socket
import struct
import subprocess
import sys
import threading
import time
import types

import numpy as np

# published dense peaks of one H100 SXM at its 700 W limit (NVIDIA data
# sheet): the bound of a kernel is the larger of bytes / HBM rate and
# operations / the peak rate of the unit its dtype runs on
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12, "float16": 989e12}

SEQ_OUT_TOL = 1e-3  # served sequence output vs the CPU run, float32
TOL_O = {"float32": 1e-4, "bfloat16": 2e-2, "float16": 2e-2}
TOL_LSE = 1e-4
# K2/K3 gradients vs mha_bwd_reference, relative to the gradient's max
# magnitude (the kernels round dS and P to bf16 or fp16 at the same points;
# fp16 is held at bf16's bound)
TOL_GRAD = {"float32": 1e-4, "bfloat16": 2e-2, "float16": 2e-2}
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
    # on both streams: a caller that keeps only the end of one still reads why
    print(f"CHIP_SMOKE FAILED: {msg}", flush=True)
    print(f"CHIP_SMOKE FAILED: {msg}", file=sys.stderr, flush=True)
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
                        for d in fa.HEAD_DIMS
                        for dt in (torch.float32, torch.bfloat16, torch.float16)))


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
    elem = 4 if dtype == "float32" else 2
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
# float32 and in bfloat16 (the bf16 forms are separate kernels), and with
# TRAIN_FORMS in float16 (phase 21 (a): the fp16 forms)
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

# the float16 forms phase 21 (b) runs: BERT-base O1 fp16 training at batch 64
# x seq 128, 12 heads of 64, with attention dropout 0.1 and (for phase 21
# (c)'s dropout-free comparisons) without
F16_CASES = [dict(b=64, h=12, sq=128, sk=128, d=64, dtype="float16", causal=False, p=p)
             for p in (0.1, 0.0)]


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
    cases += F16_CASES + [dict(f, dtype="float16") for f in FORMS + TRAIN_FORMS]
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = []
    log("[kernels] flash_attention_fwd vs mha_reference "
        f"(tolerance O {TOL_O['float32']} f32 / {TOL_O['bfloat16']} bf16 / "
        f"{TOL_O['float16']} fp16, LSE {TOL_LSE}); "
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
    elem = 4 if dtype == "float32" else 2
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
    cases += F16_CASES + [dict(f, dtype="float16") for f in FORMS + TRAIN_FORMS]
    gen = torch.Generator(device="cuda").manual_seed(1)
    results = []
    log("[bwd kernels] flash_attention_bwd_dq (K2) / _dkv (K3) vs mha_bwd_reference "
        f"(tolerance {TOL_GRAD['float32']} f32 / {TOL_GRAD['bfloat16']} bf16 / "
        f"{TOL_GRAD['float16']} fp16 of the "
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
        for dt in (torch.float32, torch.bfloat16, torch.float16):
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

    # recorded, not required (a documented exemption, ROADMAP Queue 3 (b)):
    # the reference's contract rests on XLA's CPU programs being row-stable
    # across batch sizes >= 2; on the card cuBLAS picks its GEMM kernels per
    # M (here 8 x 128 coalesced rows against 2 x 128 and 3 x 128), and the
    # engine cannot fix the M of the caller's direct call. The CPU holds it
    # bitwise (tests/test_torch_serving.py); a loaded program holds it on
    # the card by slabs (phase 18). Coalesced 1-row requests are the
    # contract's own exemption and are not compared
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
ANNOTATIONS = ("build_train_step.update", "build_train_step.grad_allreduce",
               "DataParallel.apply_collective_grads")
# kernel-name fragments -> the layer of the port that launched them
KERNEL_GROUPS = (
    ("K1 flash_attention_fwd", ("fwd_f32_kernel", "fwd_b16_kernel")),
    ("K2 flash_attention_bwd_dq", ("dq_f32_kernel", "dq_b16_kernel")),
    ("K3 flash_attention_bwd_dkv", ("dkv_f32_kernel", "dkv_b16_kernel")),
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
    labels), ``build(model, amp_level, loss=bench.py's loss, **kw)`` ->
    build_train_step's (step, init) over the TrainWrapper with AdamW(LR,
    weight decay 0.01, ClipGradByGlobalNorm(1.0)); ``kw`` goes to
    build_train_step."""

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

    def build(model, amp_level, loss=loss_fn, **kw):
        wrapper = TrainWrapper(model, TRAIN_SEQ)
        opt = optimizer.AdamW(LR, parameters=wrapper.parameters(), weight_decay=0.01,
                              grad_clip=nn.ClipGradByGlobalNorm(1.0))
        return spmd.build_train_step(wrapper, loss, opt, amp_level=amp_level, **kw)

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
# phases 6-10's model: Llama-2-7B's width at this depth (the full 32 layers,
# drawn twice in float32 and digested by each engine, kept the script near
# its 1,200 s limit on slower hosts)
LLAMA_LAYERS = 8  # was 32, then 16: the script's time (--depth-sweep)
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

    # (b) Llama-2-7B at full width, LLAMA_LAYERS deep, bfloat16
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    model = LlamaModel(num_layers=LLAMA_LAYERS, device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(0))
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

    # Llama-2-7B at full width, LLAMA_LAYERS deep, bfloat16, behind PredictorServer
    torch.cuda.reset_peak_memory_stats()
    model = LlamaModel(num_layers=LLAMA_LAYERS, device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(0))
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
# (b)'s model: Llama-2-7B's width at this depth (at the full 32 layers its
# three weights digests alone took 51 s of the script's 1,200 s; 16 until
# phase 24 came)
QUANT_LAYERS = 8


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
    from paddle_tpu_torch.quantization.post_training import Int8Linear, _quantize_array
    from paddle_tpu_torch.quantization.serving import weight_bytes

    t_phase = time.perf_counter()
    kcases = phase_quant_kernels(torch, qmm, _quantize_array, Graph)
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    model = LlamaModel(num_layers=QUANT_LAYERS, device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(0))
    model.eval()
    n_layers = len(model.layers)
    dm = generation.llama_decode_model(model, ENGINE_SLOTS, ENGINE_SEQ)
    torch.cuda.synchronize()
    log(f"[quant] Llama-2-7B's width at depth {n_layers}, float32 (weights from seed 0, "
        f"{weight_bytes(dm.params) / 1e9:.2f} "
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
    kernel_path = qmm.wq_matmul
    qmm.wq_matmul = qmm.wq_matmul_reference  # what QuantWeight.matmul (Int8Linear) calls
    try:
        plain = [[o.cpu().numpy() for o in run(ids)] for ids, _ in replies]
    finally:
        qmm.wq_matmul = kernel_path
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


def lm_parts(torch, nn, optimizer, spmd):
    """bench.py's run_llama pieces (phases 13 and 21): ``make_batch(b)(dev)``
    -> (ids, labels) int32 [b, LM_SEQ] from RandomState(0), ``build(model,
    amp_level, **kw)`` -> build_train_step's (step, init) with AdamW(LM_LR,
    weight decay LM_WD, ClipGradByGlobalNorm(1.0)) on the mean NLL."""
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

    return make_batch, build


def phase_lm_training(torch, fa, mods, card):
    """Phase 13 (module docstring): Llama-374M pretraining."""
    LlamaModel, nn, optimizer, spmd, prandom = mods
    t_phase = time.perf_counter()
    torch.set_num_threads(os.cpu_count() or 1)
    vocab = LM_CFG["vocab_size"]
    make_batch, build = lm_parts(torch, nn, optimizer, spmd)
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
    forms = {form: {key: fa.form_launches.get((kernel, sq, MT_SRC, "bfloat16"), 0)
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


def hold_step(label, got, want, zero_grads=("k_proj.bias",), tol_loss=TOL_STEP_LOSS,
              tol_grad=TOL_STEP_GRAD, tol_zero=TOL_ZERO_GRAD):
    """Phase 5's bounds on two runs of one step, each (loss, {name: clipped
    gradient}, {name: updated parameter}): loss ``tol_loss`` relative,
    each gradient within ``tol_grad`` of its max (those named by a suffix
    in ``zero_grads``, zero but for rounding, within ``tol_zero`` of the
    model's largest), each parameter within 2.5 * lr. Returns the failures
    and whether the two runs are bitwise equal."""
    (gl, gg, gp), (wl, wg, wp) = got, want
    bad = []
    loss_err = abs(gl - wl) / abs(wl)
    if not (loss_err <= tol_loss and np.isfinite(gl)):
        bad.append("loss")
    if set(gg) != set(wg):
        bad.append(f"updated parameters {sorted(set(gg) ^ set(wg))}")
    model_max = max(g.abs().max().item() for g in wg.values())
    share = {}  # each gradient's error as a share of its bound
    for n in set(gg) & set(wg):
        zero = n.endswith(tuple(zero_grads))
        scale = model_max if zero else wg[n].abs().max().item()
        err = (gg[n] - wg[n]).abs().max().item() / max(scale, 1e-30)
        share[n] = err / (tol_zero if zero else tol_grad)
        if not share[n] <= 1.0:
            bad.append(f"grad {n}")
    worst = max(share, key=share.get)
    param_err = max((gp[n] - wp[n]).abs().max().item() for n in wp)
    if not param_err <= 2.5 * LR:
        bad.append("updated parameters")
    bitwise = (gl == wl and all(np.array_equal(gp[n].numpy(), wp[n].numpy()) for n in wp))
    log(f"[dygraph] {label}: loss {gl:.6f} vs {wl:.6f} (rel err {loss_err:.2e}, tolerance "
        f"{tol_loss}); clipped gradients of {len(wg)} tensors, the worst at "
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
    forms = {k: fa.form_launches.get((k, TRAIN_SEQ, TRAIN_SEQ, "bfloat16"), 0)
             for k in ("fwd", "dq", "dkv")}
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
# ------------------------------------------------------------------ phase 18
DEPLOY_SEQ = 512  # phase 4's long requests; the saved spec is [None, 512]
DEPLOY_BATCH = 8  # serve_model(max_batch_size=8), phase 4's engine
DEPLOY_SLABS = (2, DEPLOY_BATCH)  # the row counts the program is run at, compared
DEPLOY_ROWS = (1, 2, 8)  # (a): Predictor.run held against the CPU and the eager call
RELOAD_CLIENTS = 8  # (c): clients sending while cmd 4 swaps the model
RELOAD_AFTER_S = 1.0  # (c): the clients keep sending this long after the swap
TS_RESNET_STEPS = 10  # (e): to_static ResNet-50 O1 steps (phase 16 (c)'s count)
DEPLOY_TIMED = 5  # (a): turns of (direct, loaded, Predictor.run, twice each)


def _served(port, wire_spec, ids):
    """One cmd-1 request -> (status, outputs or None, ms)."""
    frame = wire_spec.build_request(wire_spec.CMD_INFER, wire_spec.encode_arrays([ids]))
    t = time.perf_counter()
    status, payload = _call(port, frame)
    ms = (time.perf_counter() - t) * 1e3
    return status, (wire_spec.decode_arrays(payload) if status == 0 else None), ms


def _bitwise(a, b):
    return all(np.array_equal(x, y) for x, y in zip(a, b))


def deploy_traffic(fa, srv, wire_spec, rng, vocab):
    """(b)'s traffic on ``srv``: phase 4's 1-, 2- and 3-row requests, the
    8-client burst of 1-row requests, a 2-row and a 3-row request together.
    Returns (requests [(ids, outputs, ms, label, held)], the window's
    seconds, K1 launches, program calls): ``held`` marks the requests the
    contract covers (>= 2 rows, or a 1-row request alone)."""
    sent = []
    k1_before = fa.launches
    t0 = time.perf_counter()
    for rows in (1, 2, 3):
        ids = rng.randint(0, vocab, (rows, DEPLOY_SEQ)).astype(np.int32)
        status, outs, ms = _served(srv.port, wire_spec, ids)
        if status != 0:
            fail(f"deploy: a {rows}-row request answered status {status}")
        sent.append((ids, outs, ms, f"{rows} row(s)", True))
    groups = [[rng.randint(0, vocab, (1, DEPLOY_SEQ)).astype(np.int32)
               for _ in range(DEPLOY_BATCH)],
              [rng.randint(0, vocab, (n, DEPLOY_SEQ)).astype(np.int32) for n in (2, 3)]]
    for g, (group, label, held) in enumerate(((groups[0], "burst 1-row", False),
                                              (groups[1], "coalesced", True))):
        got = [None] * len(group)
        gate = threading.Barrier(len(group))

        def client(i, group=group, got=got, gate=gate):
            gate.wait()
            got[i] = _served(srv.port, wire_spec, group[i])

        threads = [threading.Thread(target=client, args=(i,)) for i in range(len(group))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        for ids, (status, outs, ms) in zip(group, got):
            if status != 0:
                fail(f"deploy: a {label} request answered status {status}")
            sent.append((ids, outs, ms, f"{label} {ids.shape[0]}-row", held))
    window = time.perf_counter() - t0
    stats = srv._engine.stats()
    slab = srv._engine._runner._layer._slab_rows
    calls = sum(d["batches"] * -(-int(b) // slab) for b, ds in stats["buckets"].items()
                for d in ds)
    return sent, window, fa.launches - k1_before, calls


def phase_deploy(torch, fa, qmm, mods, card, dyg, vis, tmp):
    """Phase 18: to_static, jit.save/load, the Predictor and serve_model on
    the card (see the module docstring). Its seed-0 and seed-1 saves stay in
    ``tmp`` for phase 20 (``saves`` of the result); the caller removes it."""
    (paddle, jit, inference, serve_model, InputSpec, BertForPretraining, BertModel, nn,
     optimizer, vision, wire_spec, accuracy_bounds) = mods
    from paddle_tpu_torch.core import place as pplace

    t_phase = time.perf_counter()
    paddle.set_device("gpu")
    torch.set_num_threads(os.cpu_count() or 1)
    failures = []
    start = (fa.launches, fa.dq_launches, fa.dkv_launches, qmm.launches)
    p1, p2, p_cpu, p_w8 = (os.path.join(tmp, n) for n in ("p1", "p2", "cpu", "w8"))
    spec = [InputSpec([None, DEPLOY_SEQ], "int32")]
    # phase 4's BERT-base from its seed, float32 (phase 11 (c) quantized
    # phase 4's own model in place)
    model = BertModel(device="cuda", generator=torch.Generator().manual_seed(0)).eval()
    n_layers = len(model.encoder.layers)
    vocab = model.vocab_size
    rng = np.random.RandomState(18)
    try:
        # (a) save on the card, load through the Predictor
        t = time.perf_counter()
        jit.save(model, p1, input_spec=spec)
        save_s = time.perf_counter() - t
        meta = json.load(open(p1 + ".pdmeta.json"))
        if meta["quant"] is not None or not meta["polymorphic"]:
            failures.append(f"(a) the save's meta {meta}")
        t = time.perf_counter()
        pred = inference.create_predictor(inference.Config(p1))
        load_s = time.perf_counter() - t
        log(f"[deploy] (a) jit.save of BERT-base on the card {save_s:.1f} s (format "
            f"{meta['format']}, polymorphic {meta['polymorphic']}, {os.path.getsize(p1 + '.pdmodel')} "
            f"program bytes, {os.path.getsize(p1 + '.pdiparams')} weight bytes); "
            f"create_predictor {load_s:.1f} s; slab {pred._layer._slab_rows} rows")
        cpu_model = copy.deepcopy(model).to("cpu")
        a_rows = {}
        for rows in DEPLOY_ROWS:
            ids = rng.randint(0, vocab, (rows, DEPLOY_SEQ)).astype(np.int32)
            before = fa.launches
            outs = pred.run([ids])
            k1 = fa.launches - before
            slab = pred._layer._slab_rows
            with torch.no_grad():
                ref = [t.numpy() for t in cpu_model(torch.from_numpy(ids))]
                # the eager model on the same slabs (zero rows after the last)
                padded = np.zeros((-(-rows // slab) * slab, DEPLOY_SEQ), np.int32)
                padded[:rows] = ids
                parts = [model(torch.from_numpy(padded[lo:lo + slab]).cuda())
                         for lo in range(0, len(padded), slab)]
                eager = [torch.cat([p[j] for p in parts])[:rows].cpu().numpy()
                         for j in range(len(parts[0]))]
            err = max(float(np.abs(o - r).max()) for o, r in zip(outs, ref))
            same = _bitwise(outs, eager)
            want_k1 = n_layers * -(-rows // slab)
            a_rows[rows] = (err, same, k1)
            log(f"[deploy] (a) Predictor.run of {rows} row(s): max abs err vs the CPU {err:.3e} "
                f"(tolerance {SEQ_OUT_TOL}); bitwise the eager call at the slab: {same}; K1 "
                f"launches {k1} (expected {want_k1})")
            if not (err <= SEQ_OUT_TOL and all(np.isfinite(o).all() for o in outs)):
                failures.append(f"(a) {rows} rows: {err:.3e} from the CPU")
            if not same:
                failures.append(f"(a) {rows} rows not bitwise the eager call at the slab")
            if k1 != want_k1:
                failures.append(f"(a) {rows} rows: K1 {k1} != {want_k1}")
        # phase 4's direct call of 8 rows against the loaded program's, in
        # turns (direct, loaded, loaded, direct), each synchronized
        ids8 = torch.from_numpy(rng.randint(0, vocab, (8, DEPLOY_SEQ)).astype(np.int32)).cuda()
        times = {"direct": [], "loaded": [], "Predictor.run": []}
        runs = {"direct": lambda: model(ids8), "loaded": lambda: pred._layer.run_slabs([ids8]),
                "Predictor.run": lambda: pred.run([ids8.cpu().numpy()])}
        with torch.no_grad():
            for _ in range(DEPLOY_TIMED):
                for name in ("direct", "loaded", "Predictor.run", "Predictor.run", "loaded",
                             "direct"):
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    runs[name]()
                    torch.cuda.synchronize()
                    times[name].append((time.perf_counter() - t) * 1e3)
        a_ms = {k: _median(v) for k, v in times.items()}
        log(f"[deploy] (a) 8 rows at seq {DEPLOY_SEQ}, median of {2 * DEPLOY_TIMED} in turns "
            f"(host clock to synchronize): direct call {a_ms['direct']:.2f} ms, the loaded "
            f"program {a_ms['loaded']:.2f} ms, Predictor.run (host copies included) "
            f"{a_ms['Predictor.run']:.2f} ms | {card}")
        # a save made on the CPU, loaded onto the card
        t = time.perf_counter()
        jit.save(cpu_model, p_cpu, input_spec=spec)
        cpu_save_s = time.perf_counter() - t
        moved = jit.load(p_cpu)
        ids = rng.randint(0, vocab, (2, DEPLOY_SEQ)).astype(np.int32)
        before = fa.launches
        with torch.no_grad():
            got = [o.cpu().numpy() for o in moved(torch.from_numpy(ids).cuda())]
            ref = [t.numpy() for t in cpu_model(torch.from_numpy(ids))]
        k1 = fa.launches - before
        err = max(float(np.abs(o - r).max()) for o, r in zip(got, ref))
        same = _bitwise(got, pred.run([ids]))
        log(f"[deploy] (a) a save made on the CPU ({cpu_save_s:.1f} s) loaded onto the card "
            f"({moved.device}): 2 rows, max abs err vs the CPU {err:.3e}, bitwise the card "
            f"save's Predictor.run: {same}, K1 launches {k1}")
        if not (err <= SEQ_OUT_TOL and k1 == n_layers * -(-2 // moved._slab_rows)):
            failures.append(f"(a) the CPU save on the card: err {err:.3e}, K1 {k1}")
        del moved, cpu_model

        # (b) serve_model under load, at each slab: every >= 2-row and solo
        # 1-row request bitwise Predictor.run of its rows
        b_runs = {}
        for slab in DEPLOY_SLABS:
            srv = serve_model(p1, dynamic_batching=True, max_batch_size=DEPLOY_BATCH,
                              max_wait_ms=20.0, max_queue=64, slab_rows=slab)
            pred._layer.set_slab_rows(slab)
            sent, window, k1, calls = deploy_traffic(fa, srv, wire_spec, rng, vocab)
            held = [(ids, outs) for ids, outs, _, _, h in sent if h]
            same = sum(_bitwise(outs, pred.run([ids])) for ids, outs in held)
            burst_same = sum(_bitwise(outs, pred.run([ids]))
                             for ids, outs, _, _, h in sent if not h)
            ms = [m for _, _, m, _, _ in sent]
            b_runs[slab] = dict(window=window, same=same, n=len(held), k1=k1, calls=calls,
                                ms=ms)
            log(f"[deploy] (b) slab {slab}: {len(sent)} requests in {window:.3f} s, request ms "
                f"median {_median(ms):.1f} / max {max(ms):.1f}; {calls} program calls, K1 "
                f"launches {k1} (expected {n_layers * calls}); bitwise Predictor.run: "
                f"{same}/{len(held)} (>= 2 rows and solo 1-row), burst 1-row "
                f"{burst_same}/{DEPLOY_BATCH} (the contract's exemption, recorded)")
            if same != len(held):
                failures.append(f"(b) slab {slab}: {same}/{len(held)} bitwise")
            if k1 != n_layers * calls:
                failures.append(f"(b) slab {slab}: K1 {k1} != {n_layers} x {calls}")
            srv.stop()
        cheaper = min(DEPLOY_SLABS, key=lambda s: b_runs[s]["window"])
        log(f"[deploy] (b) the cheaper slab at this traffic: {cheaper} rows ("
            + ", ".join(f"slab {s}: {b_runs[s]['window']:.3f} s" for s in DEPLOY_SLABS)
            + f"; the default, jit/save_load.py DEFAULT_SLAB_ROWS, is "
              f"{jit.save_load.DEFAULT_SLAB_ROWS}) | {card}")
        pred._layer.set_slab_rows(jit.save_load.DEFAULT_SLAB_ROWS)

        # (c) hot reload under load: seed-1 weights to p2, cmd 4 while 8
        # clients send; every reply bitwise one model's Predictor.run
        other = BertModel(device="cuda", generator=torch.Generator().manual_seed(1)).eval()
        jit.save(other, p2, input_spec=spec)
        del other
        pred2 = inference.create_predictor(inference.Config(p2))
        srv = serve_model(p1, dynamic_batching=True, max_batch_size=DEPLOY_BATCH,
                          max_wait_ms=20.0, max_queue=64)
        work = [rng.randint(0, vocab, (2, DEPLOY_SEQ)).astype(np.int32)
                for _ in range(RELOAD_CLIENTS)]
        want = [(pred.run([ids]), pred2.run([ids])) for ids in work]
        stop = threading.Event()
        tally = [dict(p1=0, p2=0, mixed=0, failed=0) for _ in work]

        def sender(i):
            while not stop.is_set():
                try:
                    status, outs, _ = _served(srv.port, wire_spec, work[i])
                except OSError:
                    status, outs = -1, None
                if status != 0:
                    tally[i]["failed"] += 1
                elif _bitwise(outs, want[i][0]):
                    tally[i]["p1"] += 1
                elif _bitwise(outs, want[i][1]):
                    tally[i]["p2"] += 1
                else:
                    tally[i]["mixed"] += 1

        threads = [threading.Thread(target=sender, args=(i,)) for i in range(len(work))]
        for t in threads:
            t.start()
        time.sleep(0.5)
        t = time.perf_counter()
        status, body = _call(srv.port, wire_spec.build_request(wire_spec.CMD_RELOAD,
                                                               p2.encode()))
        reload_s = time.perf_counter() - t
        time.sleep(RELOAD_AFTER_S)
        stop.set()
        for t in threads:
            t.join(300)
        total = {k: sum(d[k] for d in tally) for k in tally[0]}
        info = json.loads(body) if status == 0 else body[:200]
        log(f"[deploy] (c) cmd 4 to p2 under {RELOAD_CLIENTS} clients: status {status}, {info}; "
            f"{reload_s:.2f} s (load {srv.last_reload_s['load']:.2f} s, warm "
            f"{srv.last_reload_s['warm']:.2f} s); replies p1 {total['p1']}, p2 {total['p2']}, "
            f"mixed {total['mixed']}, failed or dropped {total['failed']}")
        if status != 0 or total["failed"] or total["mixed"] or not total["p1"] or not total["p2"]:
            failures.append(f"(c) reload: status {status}, replies {total}")

        # (d) drain: health reports it and no new request is admitted
        status, body = _call(srv.port, wire_spec.build_request(wire_spec.CMD_DRAIN))
        health = json.loads(body)
        late, _, _ = _served(srv.port, wire_spec, work[0])
        log(f"[deploy] (d) cmd 8: status {status}, draining {health['draining']}, accepting "
            f"{health['accepting']}; a new request then answered status {late}")
        if status != 0 or not health["draining"] or health["accepting"] or late != 2:
            failures.append(f"(d) drain: status {status}, health {health}, new request {late}")
        srv.stop()
        del pred2

        # (d) w8: jit.save(quant="w8") -> serve_model(quant="w8")
        w8_model = copy.deepcopy(model)
        jit.save(w8_model, p_w8, input_spec=spec, quant="w8")
        del w8_model
        try:
            serve_model(p1, quant="w8", dynamic_batching=True)
            refused_load = False
        except ValueError:
            refused_load = True
        srv = serve_model(p_w8, quant="w8", dynamic_batching=True, max_batch_size=DEPLOY_BATCH,
                          max_wait_ms=20.0, max_queue=64)
        w8_reqs = [rng.randint(0, vocab, (rows, DEPLOY_SEQ)).astype(np.int32)
                   for rows in (1, 2, 3)]
        f32_outs = [pred.run([ids]) for ids in w8_reqs]
        k1_before, wq_before = fa.launches, qmm.launches
        errs, calls = [], 0
        for ids, f32 in zip(w8_reqs, f32_outs):
            rows = ids.shape[0]
            status, outs, _ = _served(srv.port, wire_spec, ids)
            if status != 0:
                failures.append(f"(d) w8 {rows} rows: status {status}")
                continue
            errs.append(float(np.abs(outs[0] - f32[0]).max() / np.abs(f32[0]).max()))
            calls += -(-rows // srv._engine._runner._layer._slab_rows)
        k1, wq = fa.launches - k1_before, qmm.launches - wq_before
        status, body = _call(srv.port, wire_spec.build_request(wire_spec.CMD_RELOAD,
                                                               p1.encode()))
        after, _, _ = _served(srv.port, wire_spec, rng.randint(0, vocab, (2, DEPLOY_SEQ))
                              .astype(np.int32))
        log(f"[deploy] (d) w8 save served under quant='w8': sequence output vs f32 "
            + ", ".join(f"{e:.3e}" for e in errs) + f" of its max (bound "
            f"{accuracy_bounds['w8']}); {calls} program calls, wq_matmul {wq} launches "
            f"(expected {73 * calls}), K1 {k1}; serve_model(f32 save, quant='w8') refused: "
            f"{refused_load}; cmd 4 to the f32 save answered status {status} "
            f"({body[:90]!r}), then a request status {after}")
        if not errs or max(errs) > accuracy_bounds["w8"]:
            failures.append(f"(d) w8 error {errs}")
        if wq != 73 * calls or k1 != n_layers * calls:
            failures.append(f"(d) w8 launches wq {wq}, K1 {k1} for {calls} calls")
        if not refused_load or status != wire_spec.STATUS_ERROR or after != 0:
            failures.append("(d) an f32 save was not refused where w8 is declared")
        srv.stop()
        d_wq = wq
        del pred
    finally:
        for p in (p_cpu, p_w8):
            for ext in (".pdmodel", ".pdiparams", ".pdmeta.json"):
                if os.path.exists(p + ext):
                    os.remove(p + ext)
    a_b_s = time.perf_counter() - t_phase
    gc.collect()
    torch.cuda.empty_cache()

    # (e) to_static: BERT-base O0 against dygraph, 20 O1 steps; resnet18 O0
    # against dygraph (TF32 on globally); ResNet-50 O1 at phase 16 (b)'s batch
    batch, _ = bert_pretraining_parts(torch, nn, optimizer, None)
    eager = BertForPretraining(num_hidden_layers=DYG_DEPTH, hidden_dropout_prob=0.0,
                               attention_probs_dropout_prob=0.0, device="cuda",
                               generator=torch.Generator().manual_seed(0))
    static = jit.to_static(copy.deepcopy(eager))
    packed, labels = batch(4, eager.bert.vocab_size)
    runs = {}
    for name, m in (("static", static), ("eager", eager)):
        opt = dygraph_optimizer(paddle, m)
        before = (fa.launches, fa.dq_launches, fa.dkv_launches)
        loss = float(dygraph_step(paddle, m, opt, dygraph_batch(paddle, packed, labels),
                                  amp=False).numpy())
        counts = tuple(x - y for x, y in zip((fa.launches, fa.dq_launches, fa.dkv_launches),
                                             before))
        runs[name] = ((loss, first_moments(opt, m),
                       {n: p.detach().cpu() for n, p in m.named_parameters()}), counts)
    bad, bitwise = hold_step(f"(e) to_static O0 step at depth {DYG_DEPTH}, batch 4, dropout 0, "
                             "vs the dygraph step", runs["static"][0], runs["eager"][0])
    log(f"[deploy] (e) launches K1/K2/K3 through the captured program {runs['static'][1]}")
    failures += [f"(e) BERT O0 {b}" for b in bad]
    if runs["static"][1] != (DYG_DEPTH,) * 3:
        failures.append(f"(e) BERT O0 launches {runs['static'][1]}")
    del eager, static, runs, opt

    model = jit.to_static(BertForPretraining(hidden_dropout_prob=0.1,
                                             attention_probs_dropout_prob=0.1, device="cuda",
                                             generator=torch.Generator().manual_seed(0)))
    n_layers = len(model.bert.encoder.layers)
    opt = dygraph_optimizer(paddle, model)
    data = dygraph_batch(paddle, *batch(O1_BATCH, model.bert.vocab_size))
    paddle.seed(0)
    before = (fa.launches, fa.dq_launches, fa.dkv_launches)
    losses, secs = [], []
    for _ in range(O1_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss = dygraph_step(paddle, model, opt, data, amp=True)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
        losses.append(float(loss.numpy()))
    ts_counts = tuple(x - y for x, y in zip((fa.launches, fa.dq_launches, fa.dkv_launches),
                                            before))
    ts_ms = _median(secs[1:]) * 1e3
    log(f"[deploy] (e) to_static O1 bf16 BERT-base, batch {O1_BATCH} x {TRAIN_SEQ}, dropout "
        f"0.1: loss " + " ".join(f"{v:.4f}" for v in losses))
    log(f"[deploy] (e) to_static O1 step (median of steps 2-{O1_STEPS}): {ts_ms:.2f} ms, "
        f"{O1_BATCH * TRAIN_SEQ / ts_ms * 1e3:.0f} tokens/s; phase 15's dygraph step in this "
        f"run {dyg['step_ms']:.2f} ms; the first step (the capture) {secs[0]:.1f} s; "
        f"launches K1/K2/K3 {ts_counts} (expected {n_layers * O1_STEPS} each) | {card}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        failures.append(f"(e) to_static O1 loss {losses}")
    if ts_counts != (n_layers * O1_STEPS,) * 3:
        failures.append(f"(e) to_static O1 launches {ts_counts}")
    del model, opt, data
    gc.collect()
    torch.cuda.empty_cache()

    torch.backends.cudnn.allow_tf32 = True  # the captured convolutions keep their IEEE op
    sb, hw, classes = VIS_SMOKE["batch"], VIS_SMOKE["hw"], VIS_SMOKE["classes"]
    paddle.seed(0)
    eager = vision.models.resnet18(num_classes=classes)
    static = jit.to_static(copy.deepcopy(eager))
    x, y = vision_data(torch, sb, hw, classes)
    vruns = {}
    for name, m in (("static", static), ("eager", eager)):
        opt = vision_optimizer(paddle, m)

        def run(m=m, opt=opt):
            loss = dygraph_vision_step(paddle, m, opt, paddle.to_tensor(x.numpy()),
                                       paddle.to_tensor(y.numpy()), amp=False)
            return (loss, {n: opt._accumulators[id(p)][0] for n, p in m.named_parameters()},
                    dict(m.named_parameters()))

        vruns[name] = vision_run(torch, m, run, x.cuda(), y.cuda())
    failures += [f"(e) resnet18 {b}" for b in hold_vision_step(
        "(e) resnet18 O0 step through to_static vs dygraph, on the card, TF32 on globally",
        vruns["static"], vruns["eager"])]
    del eager, static, vruns, opt

    vbatch = vis["batch"]
    paddle.seed(0)
    model = jit.to_static(vision.models.resnet50())
    opt = vision_optimizer(paddle, model)
    xi, yi = (paddle.to_tensor(t.numpy()) for t in vision_data(torch, vbatch, RESNET_HW,
                                                                RESNET_CLASSES))
    r_losses, r_ms = [], []
    for _ in range(TS_RESNET_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss = dygraph_vision_step(paddle, model, opt, xi, yi, amp=True)
        r_losses.append(float(loss.numpy()))
        r_ms.append((time.perf_counter() - t) * 1e3)
    r_step = _median(r_ms[1:])
    log(f"[deploy] (e) to_static ResNet-50 O1 at batch {vbatch} (median of steps 2-"
        f"{TS_RESNET_STEPS}, host clock to the loss's readback): {r_step:.2f} ms, "
        f"{vbatch / r_step * 1e3:.1f} images/s; phase 16 (b) {vis['images_per_s']:.1f} "
        f"images/s, (c) dygraph {vbatch / vis['dygraph_step_ms'] * 1e3:.1f} images/s; loss "
        + " ".join(f"{v:.4f}" for v in r_losses) + f" | {card}")
    if not all(np.isfinite(r_losses)):
        failures.append(f"(e) to_static ResNet-50 loss {r_losses}")
    del model, opt, xi, yi
    pplace._CURRENT = pplace.CUDAPlace(0)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[deploy] the phase took {time.perf_counter() - t_phase:.1f} s ((a)-(d) "
        f"{a_b_s:.1f} s)")
    if failures:
        fail("deploy: " + "; ".join(failures))
    end = (fa.launches, fa.dq_launches, fa.dkv_launches, qmm.launches)
    return dict(k1=a_rows, a_ms=a_ms, b=b_runs, ts_counts=ts_counts, ts_ms=ts_ms, d_wq=d_wq,
                launches=tuple(e - b for e, b in zip(end, start)), saves=(p1, p2),
                vocab=vocab)


# ------------------------------------------------------------------ phase 19
STATIC_WARMUP, STATIC_STEPS = 3, 20  # (c): Executor.run steps of BERT-base, 64 x 128
STATIC_PAIRS = 5  # (c): build_train_step beside it, 5 steps each in alternating pairs
STATIC_RESNET_WARMUP, STATIC_RESNET_STEPS = 3, 10  # (e)
FLUID_STEPS = 25  # (a): the classic fluid script's exe.run calls
# (a): the fc weight's start, the JAX package's seed-0 XavierNormal draw,
# as its tests/test_fluid_compat.py script starts (tests/test_torch_fluid.py
# holds these against paddle_tpu's own draw)
FLUID_W0 = (-1.7270770072937012, -1.4394434690475464, 0.14534172415733337)
TOL_FLUID = 1e-5  # (a): the card's losses against the CPU's
TOL_ONNX = 1e-3  # (f): onnx.run of the file against the live card forward, of its max
ONNX_BERT_SHAPE, ONNX_RESNET_BATCH = (2, 128), 2


def fluid_classic(paddle, fluid, place):
    """tests/test_torch_fluid.py's script: fc on [None, 3], SGD 0.1 ->
    (program, startup, loss)."""
    paddle.set_device(place)
    paddle.enable_static()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", [None, 3])
        y = fluid.layers.data("y", [None, 1])
        pred = fluid.layers.fc(x, 1)
        loss = fluid.layers.reduce_mean(fluid.layers.square(pred - y))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    paddle.disable_static()
    return main, startup, loss


def static_bert(torch, paddle, BertModel, place, depth, batch):
    """A static BERT-base classifier: ids [batch, TRAIN_SEQ], the pooled
    output through Linear(768, 2), cross entropy, AdamW(LR, weight decay
    0.01, ClipGradByGlobalNorm(1.0)); dropout 0; weights from seed 0 ->
    (program, ids, logits, loss, the modules)."""
    paddle.set_device(place)
    paddle.seed(0)
    paddle.enable_static()
    main = paddle.static.Program()
    with paddle.static.program_guard(main, paddle.static.Program()):
        ids = paddle.static.data("ids", [batch, TRAIN_SEQ], "int64")
        label = paddle.static.data("label", [batch], "int64")
        bert = BertModel(num_hidden_layers=depth, hidden_dropout_prob=0.0,
                         attention_probs_dropout_prob=0.0,
                         generator=torch.Generator().manual_seed(0))
        head = paddle.nn.Linear(bert.hidden_size, 2)
        logits = head(bert(ids)[1])
        loss = paddle.nn.functional.cross_entropy(logits, label)
        paddle.optimizer.AdamW(LR, weight_decay=0.01,
                               grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0)).minimize(loss)
    paddle.disable_static()
    return main, ids, logits, loss, (bert, head)


def static_bert_feed(vocab, batch, seed=19):
    rng = np.random.RandomState(seed)
    return {"ids": rng.randint(0, vocab, (batch, TRAIN_SEQ)).astype(np.int64),
            "label": rng.randint(0, 2, (batch,)).astype(np.int64)}


def static_resnet(paddle, vision, batch):
    """ResNet-50 (1000 classes) as a static program at ``batch`` x 224 x
    224, float32, Momentum as bench.py's run_resnet50 sets it."""
    paddle.seed(0)
    paddle.enable_static()
    main = paddle.static.Program()
    try:
        with paddle.static.program_guard(main, paddle.static.Program()):
            image = paddle.static.data("image", [batch, 3, RESNET_HW, RESNET_HW])
            label = paddle.static.data("label", [batch], "int64")
            loss = paddle.nn.functional.cross_entropy(vision.models.resnet50()(image), label)
            paddle.optimizer.Momentum(VIS_LR, momentum=VIS_MOMENTUM,
                                      weight_decay=VIS_DECAY).minimize(loss)
    finally:
        paddle.disable_static()
    return main, loss


def onnx_check(torch, fa, onnx, InputSpec, model, feeds, label, card):
    """Export ``model`` (eval) on the card, parse the bytes, run them with
    the numpy runner and hold every output to the live card forward's
    (within TOL_ONNX of its max) -> (errors, K1 launches of the forward,
    export s, nodes, bytes)."""
    t = time.perf_counter()
    blob = onnx.export_bytes(model, [InputSpec(list(v.shape), str(v.dtype), k)
                                     for k, v in feeds.items()])
    export_s = time.perf_counter() - t
    parsed = onnx.load(blob)
    got = onnx.run(parsed, feeds)
    before = fa.launches
    with torch.no_grad():
        out = model(*[torch.from_numpy(v).cuda() for v in feeds.values()])
    k1 = fa.launches - before
    outs = out if isinstance(out, (tuple, list)) else [out]
    errs = [float(np.abs(g - w.cpu().numpy()).max() / np.abs(w.cpu().numpy()).max())
            for g, w in zip(got, outs)]
    nodes = len(parsed["graph"]["nodes"])
    log(f"[static] (f) onnx.export of {label} on the card {export_s:.1f} s: {nodes} nodes, "
        f"{len(blob)} bytes; onnx.run of the file vs the card forward, of its max: "
        + ", ".join(f"{e:.3e}" for e in errs) + f" (tolerance {TOL_ONNX}); K1 in the forward "
        f"{k1} | {card}")
    return errs, k1, export_s, nodes, len(blob)


def phase_static(torch, fa, mods, card, vis):
    """Phase 19: the static-graph facade, paddle.fluid and ONNX export on
    the card (see the module docstring)."""
    paddle, BertModel, vision, inference, onnx, InputSpec, spmd, optimizer, nn = mods
    import shutil
    import tempfile

    from paddle_tpu_torch import convert
    from paddle_tpu_torch.core import place as pplace

    t_phase = time.perf_counter()
    torch.set_num_threads(os.cpu_count() or 1)
    failures = []
    start = (fa.launches, fa.dq_launches, fa.dkv_launches)
    tmp = tempfile.mkdtemp(prefix="paddle_tpu_torch_static_")
    fluid = paddle.fluid
    try:
        # (a) fluid's classic script from the reference's seed-0 start, the
        # CPU's weights carried by static.save/static.load (its two
        # parameters have distinct names)
        rng = np.random.RandomState(0)
        xs = rng.rand(16, 3).astype(np.float32)
        ys = xs @ rng.rand(3, 1).astype(np.float32)
        hist = {}
        for place in ("cpu", "gpu"):
            paddle.seed(0)
            main, startup, loss = fluid_classic(paddle, fluid, place)
            if place == "cpu":
                w, b = main.all_parameters()
                w.set_value(np.asarray(FLUID_W0, np.float32).reshape(3, 1))
                b.set_value(np.zeros(1, np.float32))
                paddle.static.save(main, os.path.join(tmp, "fluid"))
            else:
                paddle.static.load(main, os.path.join(tmp, "fluid"))
            exe = fluid.Executor(fluid.CUDAPlace(0) if place == "gpu" else fluid.CPUPlace())
            exe.run(startup)
            hist[place] = [float(np.asarray(exe.run(main, feed={"x": xs, "y": ys},
                                                    fetch_list=[loss])[0]).mean())
                           for _ in range(FLUID_STEPS)]
        err = max(abs(a - b) for a, b in zip(hist["gpu"], hist["cpu"]))
        log(f"[static] (a) fluid's classic script, {FLUID_STEPS} exe.run on the card: loss "
            f"{hist['gpu'][0]:.6f} -> {hist['gpu'][-1]:.6f}; max |card - CPU| {err:.2e} "
            f"(tolerance {TOL_FLUID})")
        if not err <= TOL_FLUID:
            failures.append(f"(a) fluid losses {err:.2e} from the CPU")
        if not hist["gpu"][-1] < hist["gpu"][0] / 10:
            failures.append(f"(a) fluid loss did not fall 10x: {hist['gpu']}")

        # (b) BERT-base at depth 2, batch 4: one Executor.run step, card vs
        # CPU. static.save keeps one array per name and the deep-copied
        # encoder layers share their names, so the CPU program's weights
        # cross by position (convert.set_by_position)
        progs = {p: static_bert(torch, paddle, BertModel, p, DYG_DEPTH, 4)
                 for p in ("cpu", "gpu")}
        convert.set_by_position(progs["gpu"][0],
                                [t.numpy() for t in progs["cpu"][0].all_parameters()])
        feed = static_bert_feed(progs["gpu"][4][0].vocab_size, 4)
        before = (fa.launches, fa.dq_launches, fa.dkv_launches)
        step_loss = {p: float(paddle.static.Executor().run(
            progs[p][0], feed=feed, fetch_list=[progs[p][3]])[0]) for p in ("gpu", "cpu")}
        b_counts = tuple(x - y for x, y in zip((fa.launches, fa.dq_launches, fa.dkv_launches),
                                               before))
        loss_err = abs(step_loss["gpu"] - step_loss["cpu"]) / abs(step_loss["cpu"])
        param_err = max(float(np.abs(a.numpy() - b.numpy()).max()) for a, b in zip(
            progs["gpu"][0].all_parameters(), progs["cpu"][0].all_parameters()))
        log(f"[static] (b) BERT-base depth {DYG_DEPTH}, batch 4, one Executor.run step: loss "
            f"card {step_loss['gpu']:.6f} CPU {step_loss['cpu']:.6f} (rel {loss_err:.2e}, "
            f"tolerance {TOL_STEP_LOSS}); {len(progs['gpu'][0].all_parameters())} parameters, "
            f"max abs err {param_err:.3e} (tolerance 2.5 lr = {2.5 * LR:.2e}); K1/K2/K3 "
            f"{b_counts}")
        if not (loss_err <= TOL_STEP_LOSS and param_err <= 2.5 * LR):
            failures.append(f"(b) step: loss {loss_err:.2e}, parameters {param_err:.3e}")
        if b_counts != (DYG_DEPTH,) * 3:
            failures.append(f"(b) launches {b_counts}")
        del progs
        paddle.set_device("gpu")
        gc.collect()
        torch.cuda.empty_cache()

        # (c) full BERT-base at 64 x 128: 3 + 20 Executor.run steps on one batch
        t = time.perf_counter()
        main, ids, logits, loss, (bert, head) = static_bert(torch, paddle, BertModel, "gpu",
                                                            12, O1_BATCH)
        build_s = time.perf_counter() - t
        n_layers = len(bert.encoder.layers)
        feed = static_bert_feed(bert.vocab_size, O1_BATCH)
        exe = paddle.static.Executor(paddle.CUDAPlace(0))
        torch.cuda.reset_peak_memory_stats()
        before = (fa.launches, fa.dq_launches, fa.dkv_launches)
        losses, secs = [], []
        for _ in range(STATIC_WARMUP + STATIC_STEPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = exe.run(main, feed=feed, fetch_list=[loss])[0]
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t)
            losses.append(float(out))
        c_counts = tuple(x - y for x, y in zip((fa.launches, fa.dq_launches, fa.dkv_launches),
                                               before))
        peak = torch.cuda.max_memory_allocated() / 2**30
        step_ms = _median(secs[STATIC_WARMUP:]) * 1e3
        n_steps = STATIC_WARMUP + STATIC_STEPS
        log(f"[static] (c) BERT-base program: {len(main.ops)} recorded calls, "
            f"{len(main.all_parameters())} parameters, built in {build_s:.1f} s; f32, batch "
            f"{O1_BATCH} x {TRAIN_SEQ}, loss " + " ".join(f"{v:.4f}" for v in losses))
        log(f"[static] (c) Executor.run step (median of the {STATIC_STEPS} after "
            f"{STATIC_WARMUP} warm-up, host clock to synchronize): {step_ms:.2f} ms, "
            f"{O1_BATCH * TRAIN_SEQ / step_ms * 1e3:.0f} tokens/s; peak memory {peak:.2f} GiB; "
            f"K1/K2/K3 {c_counts} over {n_steps} steps (expected {n_layers} a step) | {card}")
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            failures.append(f"(c) loss {losses}")
        if c_counts != (n_layers * n_steps,) * 3:
            failures.append(f"(c) launches {c_counts}")

        def static_step():
            exe.run(main, feed=feed, fetch_list=[loss])

        ev_ms, busy_ms, _, _ = profile_device(torch, static_step,
                                              f"Executor.run step, f32, {O1_BATCH} x {TRAIN_SEQ}",
                                              top=12, groups=TRAIN_GROUPS)
        idle = _fmt_pct(1 - busy_ms / ev_ms if busy_ms > 0 else None)
        log(f"[profile] device idle {idle} of an Executor.run step")

        # the same model's float32 build_train_step step, in alternating pairs
        class Classifier(torch.nn.Module):
            def __init__(self):
                super().__init__()
                self.bert, self.head = bert, head

            def forward(self, x):
                return self.head(self.bert(x)[1])

        wrapper = Classifier()
        opt = optimizer.AdamW(LR, parameters=wrapper.parameters(), weight_decay=0.01,
                              grad_clip=nn.ClipGradByGlobalNorm(1.0))
        bstep, binit = spmd.build_train_step(
            wrapper, lambda out, y: torch.nn.functional.cross_entropy(out, y.long()), opt,
            amp_level="O0")
        params, state = binit()
        xb = torch.from_numpy(feed["ids"].astype(np.int32)).cuda()
        yb = torch.from_numpy(feed["label"]).cuda()
        for _ in range(2):
            _, params, state = bstep(params, state, xb, yb)
        times = {"static": [], "build_train_step": []}
        runs = {"static": static_step,
                "build_train_step": lambda: bstep(params, state, xb, yb)}
        for i in range(2 * STATIC_PAIRS):
            for name in (("static", "build_train_step") if i % 2 == 0
                         else ("build_train_step", "static")):
                if len(times[name]) == STATIC_PAIRS:
                    continue
                torch.cuda.synchronize()
                t = time.perf_counter()
                runs[name]()
                torch.cuda.synchronize()
                times[name].append((time.perf_counter() - t) * 1e3)
        s_ms, b_ms = _median(times["static"]), _median(times["build_train_step"])
        log(f"[static] (c) in alternating pairs, {STATIC_PAIRS} each (ms): Executor.run "
            + " ".join(f"{v:.2f}" for v in times["static"]) + "; build_train_step "
            + " ".join(f"{v:.2f}" for v in times["build_train_step"])
            + f"; medians {s_ms:.2f} / {b_ms:.2f} ({s_ms / b_ms:.2f}x) | {card}")
        del params, state, bstep, wrapper, opt

        # (d) the test clone saved by save_inference_model, served by a Predictor
        test = main.clone(for_test=True)
        want = exe.run(test, feed={"ids": feed["ids"]}, fetch_list=[logits])[0]
        path = os.path.join(tmp, "bert_static")
        t = time.perf_counter()
        paddle.static.save_inference_model(path, [ids], [logits], exe, program=test)
        save_s = time.perf_counter() - t
        t = time.perf_counter()
        pred = inference.create_predictor(inference.Config(path))
        load_s = time.perf_counter() - t
        before = fa.launches
        got = pred.run([feed["ids"].astype(np.int32)])[0]
        d_k1 = fa.launches - before
        d_err = float(np.abs(got - want).max())
        log(f"[static] (d) save_inference_model of the test clone {save_s:.1f} s "
            f"({os.path.getsize(path + '.pdmodel')} program bytes), create_predictor "
            f"{load_s:.1f} s; Predictor.run of {O1_BATCH} rows vs Executor.run of the clone: "
            f"max abs err {d_err:.3e} (tolerance {SEQ_OUT_TOL}); K1 {d_k1} (expected "
            f"{n_layers})")
        if not d_err <= SEQ_OUT_TOL:
            failures.append(f"(d) Predictor.run {d_err:.3e} from Executor.run")
        if d_k1 != n_layers:
            failures.append(f"(d) K1 {d_k1} a Predictor.run")
        del main, test, pred, bert, head, exe
        gc.collect()
        torch.cuda.empty_cache()
        a_d_s = time.perf_counter() - t_phase

        # (e) ResNet-50 as a static program, bench.py's batch candidates
        t_e = time.perf_counter()
        rn = None
        for batch in BATCH_CANDIDATES:
            main = rloss = None
            try:
                torch.cuda.reset_peak_memory_stats()
                main, rloss = static_resnet(paddle, vision, batch)
                images, labels = vision_data(torch, batch, RESNET_HW, RESNET_CLASSES)
                rfeed = {"image": images.numpy(), "label": labels.numpy().astype(np.int64)}
                exe = paddle.static.Executor()
                r_losses, r_ms = [], []
                for _ in range(STATIC_RESNET_WARMUP + STATIC_RESNET_STEPS):
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    r_losses.append(float(exe.run(main, feed=rfeed, fetch_list=[rloss])[0]))
                    r_ms.append((time.perf_counter() - t) * 1e3)
                rn = dict(batch=batch, losses=r_losses,
                          step_ms=_median(r_ms[STATIC_RESNET_WARMUP:]),
                          peak=torch.cuda.max_memory_allocated() / 2**30)
                break
            except Exception as e:  # noqa: BLE001 - an OOM moves down the candidates
                if not _is_oom(torch, e) or batch == BATCH_CANDIDATES[-1]:
                    raise
                log(f"[static] (e) batch {batch}: out of memory "
                    f"({str(e).splitlines()[0][:120]}); trying a smaller batch")
            finally:
                del main, rloss
                gc.collect()
                torch.cuda.empty_cache()
        log(f"[static] (e) ResNet-50 static program, f32, batch {rn['batch']} (the first of "
            f"{list(BATCH_CANDIDATES)} that fits; phase 16's O1 batch {vis['batch']}): "
            f"{rn['step_ms']:.2f} ms a step (median of {STATIC_RESNET_STEPS} after "
            f"{STATIC_RESNET_WARMUP}, host clock), {rn['batch'] / rn['step_ms'] * 1e3:.1f} "
            f"images/s; peak memory {rn['peak']:.2f} GiB; loss "
            + " ".join(f"{v:.4f}" for v in rn["losses"]) + f"; {time.perf_counter() - t_e:.1f} "
            f"s | {card}")
        if not all(np.isfinite(rn["losses"])):
            failures.append(f"(e) ResNet-50 loss {rn['losses']}")

        # (f) ONNX export on the card: BERT-base at [2, 128], ResNet-50 at batch 2
        paddle.set_device("gpu")
        rng = np.random.RandomState(20)
        bert = BertModel(device="cuda", generator=torch.Generator().manual_seed(0)).eval()
        f_bert = onnx_check(torch, fa, onnx, InputSpec, bert,
                            {"ids": rng.randint(0, bert.vocab_size, ONNX_BERT_SHAPE)
                             .astype(np.int32)}, f"BERT-base {list(ONNX_BERT_SHAPE)}", card)
        del bert
        paddle.seed(0)
        resnet = vision.models.resnet50().eval()
        f_resnet = onnx_check(torch, fa, onnx, InputSpec, resnet,
                              {"image": rng.rand(ONNX_RESNET_BATCH, 3, RESNET_HW, RESNET_HW)
                               .astype(np.float32)}, f"ResNet-50 batch {ONNX_RESNET_BATCH}",
                              card)
        del resnet
        for name, (errs, k1, *_), want_k1 in (("BERT-base", f_bert, 12),
                                              ("ResNet-50", f_resnet, 0)):
            if not errs or max(errs) > TOL_ONNX:
                failures.append(f"(f) {name} onnx.run errors {errs}")
            if k1 != want_k1:
                failures.append(f"(f) {name} forward K1 {k1} != {want_k1}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        paddle.disable_static()
        pplace._CURRENT = pplace.CUDAPlace(0)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[static] (g) the phase took {time.perf_counter() - t_phase:.1f} s ((a)-(d) "
        f"{a_d_s:.1f} s)")
    if failures:
        fail("static: " + "; ".join(failures))
    end = (fa.launches, fa.dq_launches, fa.dkv_launches)
    return dict(step_ms=step_ms, bts_ms=b_ms, counts=c_counts, d_k1=d_k1, resnet=rn,
                onnx=(f_bert, f_resnet), launches=tuple(e - b for e, b in zip(end, start)))


# ------------------------------------------------------------------ phase 20
# (a): bench.py run_fleet's layout (:1641-1676): three replicas, a
# supervisor tick of 0.2 s, a gate of 8, 4 tries a request; two tenants
FLEET_REPLICAS = 3
FLEET_HEALTHY_S, FLEET_CHAOS_S = 4.0, 8.0  # the rounds' seconds
FLEET_NOISY, FLEET_POLITE = 16, 4  # closed-loop connections per tenant
FLEET_DEADLINE_MS = 1500.0  # the polite tenant's wire deadline
FLEET_KILL_AFTER = 50  # chaos round: grants before the SIGKILL (then 0.5 s more)
FLEET_RELOAD_CLIENTS = 8  # the rolling reload's clients
# (b): phase 7's engine (16 slots x 256, one fill chunk of 128) in three
# replica processes, one prefill and two decode
DISAGG_STREAMS, DISAGG_NEW = 6, 48  # the handed-off streams (one prompt of 128 tokens)
# the kill round: new tokens; the kill once every stream holds this many
# (each then relays from a decode replica: none is still in its handoff)
DISAGG_KILL_NEW, DISAGG_KILL_AT = 96, 12
DISAGG_DEGRADED = 3  # streams sent once the prefill pool is gone
DISAGG_CADENCE = 16  # the router's snapshot cadence: a 7B block is ~134-190 MB
DISAGG_MAX_BODY = 1 << 30  # the replicas' frame cap, phase 8's (a snapshot is one frame)
DISAGG_PREFIX_BYTES = 1 << 30  # prefix_max_bytes: the persistent tier keeps 128-row blocks
# (b)'s replicas: Llama-2-7B's width at this depth (at the full 32 layers a
# replica's respawn, its weights digest most of what is not imports, took
# 34-64 s of the script's 1,200 s)
FLEET_LLAMA_LAYERS = 8


def llama_7b_bf16(torch, models, seed=0, layers=FLEET_LLAMA_LAYERS):
    """Llama-2-7B at full width in bfloat16, ``layers`` deep, weights drawn
    on the card from ``seed``: the embedding, norm and head first, then each
    decoder layer converted as it is drawn, so a process never holds the
    float32 model (three full-depth replicas build at once in 80 GB). The
    same seed gives the same weights in every process."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    model = models.LlamaModel(num_layers=0, device="cuda", generator=g).to(torch.bfloat16)
    for _ in range(layers):
        model.layers.append(models.LlamaDecoderLayer(4096, 32, 11008, device="cuda",
                                                     generator=g).to(torch.bfloat16))
    return model.eval()


def decode_replica(argv):
    """``chip_smoke.py --decode-replica PORTFILE PHASE PREFIX_DIR``: one
    Llama-2-7B decode replica of phase 20 (b): phase 7's engine (16 slots x
    256, chunk 128) with ``phase`` and the persistent prefix tier at
    ``prefix_dir``, seed-0 weights (llama_7b_bf16), warmed up, served by
    PredictorServer; the port is written to PORTFILE atomically once it
    serves, and it serves until cmd 7. It needs the card and the kernels
    the parent built (a missing one is built under cuda_build's file lock,
    never raced)."""
    if len(argv) != 3:
        fail("usage: chip_smoke.py --decode-replica PORTFILE PHASE PREFIX_DIR")
    portfile, phase, prefix_dir = argv
    import torch

    if not torch.cuda.is_available():
        fail("a decode replica needs a CUDA card")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from paddle_tpu_torch.inference.decode import DecodeEngine
    from paddle_tpu_torch.inference.server import PredictorServer
    from paddle_tpu_torch.text import generation, models

    t0 = time.perf_counter()
    model = llama_7b_bf16(torch, models)
    dm = generation.llama_decode_model(model, ENGINE_SLOTS, ENGINE_SEQ)
    engine = DecodeEngine(dm, max_prompt_len=ENGINE_PROMPT, min_seq_bucket=ENGINE_CHUNK,
                          max_queue=64, name=f"llama-7b-{phase}", phase=phase,
                          prefix_dir=prefix_dir, prefix_max_bytes=DISAGG_PREFIX_BYTES)
    engine.warmup()
    srv = PredictorServer(None, decode_engine=engine, own_decode_engine=True,
                          max_body=DISAGG_MAX_BODY)
    with open(portfile + ".tmp", "w") as f:
        f.write(str(srv.port))
    os.replace(portfile + ".tmp", portfile)
    log(f"[replica] {phase} on port {srv.port}, up in {time.perf_counter() - t0:.1f} s")
    srv._thread.join()  # serve until the stop command (cmd 7)


def _stats(wire_spec, port):
    status, body = _call(port, wire_spec.build_request(wire_spec.CMD_STATS))
    if status != 0:
        raise RuntimeError(f"cmd 5 answered status {status}")
    return json.loads(body)


def _pct(v, q):
    return float(np.percentile(np.asarray(v), q)) if v else float("nan")


def fleet_storm(fl, plan, seconds, during=None):
    """(a)'s round: one closed-loop client thread per (tenant, frame,
    expected reply payload) in ``plan`` against the router for ``seconds``.
    -> {tenant: {"lat": [s of each status-0 reply], "shed": n, "bad": [...]}};
    a reply that is not status 0 with the expected bytes or status 2 is bad,
    and so is a dropped connection (the router never drops a client)."""
    stop_at = time.monotonic() + seconds
    out, lock = {}, threading.Lock()

    def client(tenant, frame, want):
        lat, shed, bad = [], 0, []
        try:
            with socket.create_connection(("127.0.0.1", fl.port), timeout=120) as s:
                while time.monotonic() < stop_at:
                    t = time.perf_counter()
                    s.sendall(frame)
                    (blen,) = struct.unpack("<I", _recv(s, 4))
                    body = _recv(s, blen)
                    if body[0] == 0 and body[1:] == want:
                        lat.append(time.perf_counter() - t)
                    elif body[0] == 2:
                        shed += 1
                    else:
                        bad.append(f"status {body[0]}" if body[0] else "wrong bytes")
        except OSError as e:
            bad.append(f"connection: {e!r}")
        with lock:
            d = out.setdefault(tenant, {"lat": [], "shed": 0, "bad": []})
            d["lat"] += lat
            d["shed"] += shed
            d["bad"] += bad

    threads = [threading.Thread(target=client, args=p) for p in plan]
    for t in threads:
        t.start()
    if during is not None:
        during()
    for t in threads:
        t.join(seconds + 300)
    return out


def spawned_at_once(spawn, rids):
    """A spawn_fn over ``spawn`` whose first replicas, ``rids``, are spawned
    at once (a thread each) and handed out as the Fleet asks for them; any
    other rid is spawned when asked. ``leftovers()`` stops what no Fleet
    took (a Fleet that failed to start)."""
    import concurrent.futures

    pool = concurrent.futures.ThreadPoolExecutor(len(rids))
    futs = {rid: pool.submit(spawn, rid) for rid in rids}
    pool.shutdown(wait=False)

    def fn(rid, *phase):
        fut = futs.pop(rid, None)
        return fut.result() if fut is not None else spawn(rid, *phase)

    def leftovers():
        for fut in futs.values():
            try:
                fut.result().stop(timeout=10.0)
            except Exception:  # noqa: BLE001 - a spawn that failed left nothing
                pass
        futs.clear()

    fn.leftovers = leftovers
    return fn


def fleet_bert(torch, mods, card, deploy):
    """Phase 20 (a): the one-shot fleet over phase 18's BERT-base saves."""
    inference, fleet_mod, router_mod, wire_spec, goodput = mods
    p1, p2 = deploy["saves"]
    preds = []
    for p in (p1, p2):
        cfg = inference.Config(p)
        cfg.set_slab_rows(DEPLOY_BATCH)
        preds.append(inference.create_predictor(cfg))
    rng = np.random.RandomState(20)
    inputs = [rng.randint(0, deploy["vocab"], (1, DEPLOY_SEQ)).astype(np.int32)
              for _ in range(FLEET_NOISY + FLEET_POLITE)]
    # the replies each replica owes, as bytes: Predictor.run of the rows on
    # the same slab, in this process, for each save
    want = [[wire_spec.encode_arrays(pr.run([ids])) for ids in inputs] for pr in preds]
    tenants = [router_mod.TenantPolicy("noisy", weight=1.0, max_queue=8),
               router_mod.TenantPolicy("polite", weight=4.0, max_queue=64,
                                       slo_ms=FLEET_DEADLINE_MS)]
    spawn = fleet_mod.subprocess_spawner(p1, max_batch_size=DEPLOY_BATCH, max_wait_ms=2.0,
                                         slab_rows=DEPLOY_BATCH, spawn_timeout=300)
    t = time.perf_counter()
    # the Fleet takes its replicas one after another; their processes are
    # started together (subprocess_spawner's spawn, a thread each), and a
    # respawn calls the spawner itself
    at_once = spawned_at_once(spawn, [f"replica-{i}" for i in range(FLEET_REPLICAS)])
    try:
        fl = fleet_mod.Fleet(at_once, replicas=FLEET_REPLICAS, tenants=tenants,
                             autoscaler=fleet_mod.Autoscaler(min_replicas=FLEET_REPLICAS,
                                                             max_replicas=FLEET_REPLICAS),
                             supervise_interval=0.2,
                             router_kwargs={"max_inflight": 8, "retry_attempts": 4,
                                            "retry_base": 0.01, "retry_max": 0.2})
    finally:
        at_once.leftovers()
    spawn_s = time.perf_counter() - t
    failures, res = [], {}
    try:
        free, _ = torch.cuda.mem_get_info()
        log(f"[fleet] (a) {FLEET_REPLICAS} serve_model replicas of phase 18's BERT-base save "
            f"(float32, [None, {DEPLOY_SEQ}], max_batch_size {DEPLOY_BATCH}, slab "
            f"{DEPLOY_BATCH}) started together by subprocess_spawner and serving in "
            f"{spawn_s:.1f} s (the 7B replicas of (b) starting beside them); free device "
            f"memory {free / 2**30:.2f} GiB")
        tid = {n: router_mod.tenant_id(n) for n in ("noisy", "polite")}
        plan = []
        for i, ids in enumerate(inputs):
            tenant = "noisy" if i < FLEET_NOISY else "polite"
            tail = wire_spec.encode_tenant(tid[tenant])
            if tenant == "polite":
                tail = wire_spec.encode_deadline(FLEET_DEADLINE_MS) + tail
            frame = wire_spec.build_request(wire_spec.CMD_INFER,
                                            wire_spec.encode_arrays([ids]) + tail)
            plan.append((tenant, frame, want[0][i]))
        time.sleep(max(0.5, fl.registry.heartbeat_interval * 3))  # heartbeats settle

        def granted():
            return sum(t["granted"] for t in fl.router.gate.stats().values())

        rounds = {}
        for label, seconds in (("healthy", FLEET_HEALTHY_S), ("chaos", FLEET_CHAOS_S)):
            goodput.SERVING_LEDGER.reset()
            killed = {}
            during = None
            if label == "chaos":
                base = granted()

                def killer():
                    t_end = time.monotonic() + seconds
                    while time.monotonic() < t_end and granted() - base < FLEET_KILL_AFTER:
                        time.sleep(0.02)
                    time.sleep(0.5)  # mid-storm
                    rid, h = sorted(fl.handles().items())[0]
                    killed.update(rid=rid, t=time.monotonic())
                    os.kill(h.pid, signal.SIGKILL)
                    while not (fl.respawns >= 1 and len(fl.registry.routable())
                               == FLEET_REPLICAS):
                        if time.monotonic() - killed["t"] > 300:
                            return
                        time.sleep(0.02)
                    killed["routable_s"] = time.monotonic() - killed["t"]

                watcher = threading.Thread(target=killer)
                during = watcher.start
            got = fleet_storm(fl, plan, seconds, during)
            if label == "chaos":
                watcher.join(320)
            rep = goodput.SERVING_LEDGER.report()
            rounds[label] = dict(got=got, goodput=rep["goodput"], killed=killed, ledger=rep)
            for tenant in ("noisy", "polite"):
                g = got[tenant]
                log(f"[fleet] (a) {label} round {seconds:.0f} s, {tenant}: {len(g['lat'])} "
                    f"replies bitwise Predictor.run, {g['shed']} status 2, {len(g['bad'])} "
                    f"bad; p50 {_pct(g['lat'], 50) * 1e3:.1f} ms, p99 "
                    f"{_pct(g['lat'], 99) * 1e3:.1f} ms | {card}")
                if g["bad"]:
                    failures.append(f"(a) {label} {tenant}: {g['bad'][:3]}")
                if not g["lat"]:
                    failures.append(f"(a) {label} {tenant}: no reply")
            p99 = _pct(got["polite"]["lat"], 99) * 1e3
            if not p99 <= FLEET_DEADLINE_MS:
                failures.append(f"(a) {label}: polite p99 {p99:.1f} ms over its deadline")
        kill = rounds["chaos"]["killed"]
        ratio = (rounds["chaos"]["goodput"] / rounds["healthy"]["goodput"]
                 if rounds["healthy"]["goodput"] else 0.0)
        log(f"[fleet] (a) SIGKILL of {kill.get('rid')} mid-storm: respawned and routable "
            f"again {kill.get('routable_s', float('nan')):.2f} s after the kill "
            f"(respawns {fl.respawns}); serving goodput healthy "
            f"{rounds['healthy']['goodput']:.4f}, chaos {rounds['chaos']['goodput']:.4f}, "
            f"ratio {ratio:.4f} | {card}")
        if "routable_s" not in kill:
            failures.append(f"(a) the killed replica was not routable again: {kill}")
        # K1, 12 a program call, in every replica (the respawned one too)
        k1s = {}
        for rid, h in sorted(fl.handles().items()):
            st = _stats(wire_spec, h.port)
            ds = [d for b in st["buckets"].values() for d in b]
            calls = sum(d["program_calls"] or 0 for d in ds)
            k1 = sum(d["k1_launches"] or 0 for d in ds)
            k1s[rid] = (k1, calls)
        log("[fleet] (a) K1 launches / program calls per replica (cmd-5 stats): "
            + ", ".join(f"{r} {k} / {c}" for r, (k, c) in k1s.items()))
        if any(k != 12 * c for k, c in k1s.values()) or not any(c for _, c in k1s.values()):
            failures.append(f"(a) K1 per program call {k1s}")
        res.update(spawn_s=spawn_s, rounds={k: {t: dict(n=len(v["got"][t]["lat"]),
                                                      shed=v["got"][t]["shed"],
                                                      p99_ms=_pct(v["got"][t]["lat"], 99) * 1e3)
                                                  for t in ("noisy", "polite")}
                                              for k, v in rounds.items()},
                   ratio=ratio, respawn_s=kill.get("routable_s"),
                   k1=sum(k for k, _ in k1s.values()))

        # the rolling reload to the seed-1 save under FLEET_RELOAD_CLIENTS
        # clients: every reply one save's Predictor.run, none failed
        stop = threading.Event()
        tally = [dict(p1=0, p2=0, other=0) for _ in range(FLEET_RELOAD_CLIENTS)]

        def sender(i):
            frame = wire_spec.build_request(wire_spec.CMD_INFER,
                                            wire_spec.encode_arrays([inputs[i]]))
            try:
                with socket.create_connection(("127.0.0.1", fl.port), timeout=300) as s:
                    while not stop.is_set():
                        s.sendall(frame)
                        (blen,) = struct.unpack("<I", _recv(s, 4))
                        body = _recv(s, blen)
                        key = ("p1" if body[0] == 0 and body[1:] == want[0][i] else
                               "p2" if body[0] == 0 and body[1:] == want[1][i] else "other")
                        tally[i][key] += 1
            except OSError:
                tally[i]["other"] += 1

        k1_before = res["k1"]
        threads = [threading.Thread(target=sender, args=(i,))
                   for i in range(FLEET_RELOAD_CLIENTS)]
        for th in threads:
            th.start()
        time.sleep(0.5)
        t = time.perf_counter()
        reloads = fl.rolling_reload(p2, drain_deadline=60.0)
        reload_s = time.perf_counter() - t
        time.sleep(1.0)
        stop.set()
        for th in threads:
            th.join(300)
        total = {k: sum(d[k] for d in tally) for k in tally[0]}
        after = [_call(fl.port, wire_spec.build_request(
            wire_spec.CMD_INFER, wire_spec.encode_arrays([inputs[i]]))) for i in range(3)]
        on_p2 = sum(st == 0 and body == want[1][i] for i, (st, body) in enumerate(after))
        log(f"[fleet] (a) rolling_reload to the seed-1 save under {FLEET_RELOAD_CLIENTS} "
            f"clients: {reload_s:.1f} s, statuses "
            f"{sorted(r['status'] for r in reloads.values())}; replies seed 0 {total['p1']}, "
            f"seed 1 {total['p2']}, failed, dropped or other {total['other']}; after it "
            f"{on_p2}/3 requests bitwise the seed-1 Predictor.run | {card}")
        if (total["other"] or not total["p1"] or not total["p2"] or on_p2 != 3
                or any(r["status"] != 0 for r in reloads.values())):
            failures.append(f"(a) rolling reload: {total}, after {on_p2}/3")
        # the reload swapped each replica's engine: its counts start again
        k1s = {}
        for rid, h in sorted(fl.handles().items()):
            ds = [d for b in _stats(wire_spec, h.port)["buckets"].values() for d in b]
            k1s[rid] = (sum(d["k1_launches"] or 0 for d in ds),
                        sum(d["program_calls"] or 0 for d in ds))
        log("[fleet] (a) after the reload, K1 launches / program calls per replica: "
            + ", ".join(f"{r} {k} / {c}" for r, (k, c) in k1s.items()))
        if any(k != 12 * c for k, c in k1s.values()) or not any(c for _, c in k1s.values()):
            failures.append(f"(a) K1 per program call after the reload {k1s}")
        res["k1"] = k1_before + sum(k for k, _ in k1s.values())
        res["reload_s"] = reload_s
    finally:
        fl.close()
        del preds
    return res, failures


def disagg_spawner(torch, tmp, prefix_dir, phases):
    """Phase 20 (b)'s spawn_fn: ``--decode-replica`` processes of this file.
    The first replica of each phase in ``phases`` is launched at once, all
    together (the Fleet takes them in its order); later calls (a respawn)
    launch a fresh one. Each process's output goes to a file under ``tmp``."""
    from paddle_tpu_torch.inference import fleet as fleet_mod

    me = os.path.abspath(__file__)
    launched = []  # [phase, proc, portfile, taken]

    def launch(phase):
        n = len(launched)
        portfile = os.path.join(tmp, f"replica-{n}.port")
        out = open(os.path.join(tmp, f"replica-{n}-{phase}.log"), "w")
        proc = subprocess.Popen([sys.executable, me, "--decode-replica", portfile, phase,
                                 prefix_dir], stdout=out, stderr=subprocess.STDOUT)
        out.close()
        launched.append([phase, proc, portfile, False])
        return launched[-1]

    t_launch = time.time()
    for phase in phases:
        launch(phase)

    def up_s():
        """Seconds from the launch to the last pre-launched port file."""
        stamps = [os.path.getmtime(e[2]) for e in launched[:len(phases)]
                  if os.path.exists(e[2])]
        return max(stamps) - t_launch if stamps else float("nan")

    def spawn(rid, phase):
        entry = next((e for e in launched if e[0] == phase and not e[3]), None) or launch(phase)
        entry[3] = True
        port = fleet_mod.wait_portfile(entry[2], entry[1], rid, 600)
        return fleet_mod.ReplicaHandle(rid, "127.0.0.1", port, proc=entry[1])

    def reap():
        for _, proc, _, _ in launched:
            if proc.poll() is None:
                proc.kill()
            proc.wait()

    spawn.reap = reap
    spawn.up_s = up_s
    spawn.logs = lambda: sorted(os.path.join(tmp, n) for n in os.listdir(tmp)
                                if n.endswith(".log"))
    return spawn


def disagg_streams(wire_spec, port, work, kill_at=None):
    """Each ``(prompt, n)`` of ``work`` as one decode stream to ``port``,
    all at once, a thread each -> per stream (status, tokens, snapshot
    frames, [seconds of each token frame from the send]). ``kill_at``:
    ``(k, hook)``: the hook runs once, in the stream that is the last to
    hold k tokens, so that every stream is past its first k."""
    out = [None] * len(work)
    fired = threading.Lock()
    state = {"reached": 0}

    def one(i, prompt, n):
        frame = wire_spec.build_request(wire_spec.CMD_INFER, wire_spec.encode_arrays([prompt])
                                        + wire_spec.encode_decode_opts(n))
        tokens, times, snaps, counted = [], [], 0, False
        try:
            with socket.create_connection(("127.0.0.1", port), timeout=900) as s:
                t0 = time.perf_counter()
                s.sendall(frame)
                while True:
                    (blen,) = struct.unpack("<I", _recv(s, 4))
                    body = _recv(s, blen)
                    if len(body) > 1 and wire_spec.is_kv_snapshot(body[1:]):
                        snaps += 1
                    elif len(body) > 1:
                        chunk = wire_spec.decode_arrays(body[1:])[0]
                        tokens += [int(t) for t in chunk]
                        times += [time.perf_counter() - t0] * int(chunk.size)
                    if kill_at is not None and len(tokens) >= kill_at[0] and not counted:
                        counted = True
                        with fired:
                            state["reached"] += 1
                            go = state["reached"] == len(work)
                        if go:
                            kill_at[1]()
                    if body[0] != wire_spec.STATUS_STREAM:
                        out[i] = (body[0], tokens, snaps, times)
                        return
        except OSError as e:
            out[i] = (f"connection: {e!r}", tokens, snaps, times)

    threads = [threading.Thread(target=one, args=(i, p, n)) for i, (p, n) in enumerate(work)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(900)
    return out


def fleet_llama(torch, mods, card, spawn, free0):
    """Phase 20 (b): disaggregated decode over Llama-2-7B replicas, whose
    processes ``spawn`` (disagg_spawner) started at the phase's start;
    ``free0``: the free device memory before them."""
    inference, fleet_mod, router_mod, wire_spec, goodput = mods
    from paddle_tpu_torch.inference.registry import ReplicaRegistry

    failures, res = [], {}
    rng = np.random.RandomState(21)
    vocab = 32000
    # prompts 16-128 tokens, one of exactly 128 (a full page: the persistent tier's)
    lens = [ENGINE_PROMPT] + [int(n) for n in rng.randint(ENGINE_PROMPT // 8, ENGINE_PROMPT,
                                                          DISAGG_STREAMS - 1)]
    prompts = [rng.randint(0, vocab, (n,)).astype(np.int32) for n in lens]
    t = time.perf_counter()
    fl = None
    try:
        fl = fleet_mod.Fleet(spawn, supervise=False, pools={
            "prefill": {"replicas": 1, "autoscaler": fleet_mod.Autoscaler(1, 1)},
            "decode": {"replicas": 2, "autoscaler": fleet_mod.Autoscaler(2, 2)}},
            registry=ReplicaRegistry(heartbeat_interval=0.1),
            router_kwargs=dict(snapshot_every=DISAGG_CADENCE, backend_timeout=300.0,
                               handoff_timeout=120.0, max_body=DISAGG_MAX_BODY))
        spawn_s = time.perf_counter() - t
        free1, _ = torch.cuda.mem_get_info()
        log(f"[fleet] (b) Llama-2-7B's width at depth {FLEET_LLAMA_LAYERS}, bf16 (seed 0, "
            f"phase 7's engine: {ENGINE_SLOTS} slots x "
            f"{ENGINE_SEQ}, chunk {ENGINE_CHUNK}), pools {fl.pools()}, three replica "
            f"processes started together at the phase's start ({spawn.up_s():.1f} s to the "
            f"last port; {spawn_s:.1f} s more wait here); free device memory "
            f"{free0 / 2**30:.2f} GiB before the spawns, {free1 / 2**30:.2f} GiB with them "
            f"up")
        hs = fl.handles()

        def port_of(rid):
            return fl.handles()[rid].port

        # the reference: each prompt's stream sent plainly to one decode
        # replica, before any chaos; one prompt solo to each replica
        work = [(p, DISAGG_NEW) for p in prompts]
        ref = disagg_streams(wire_spec, port_of("decode-0"), work)
        if any(r[0] != 0 or len(r[1]) != DISAGG_NEW for r in ref):
            fail(f"fleet (b): the plain reference streams {[(r[0], len(r[1])) for r in ref]}")
        ref_tokens = [r[1] for r in ref]
        solo = {rid: disagg_streams(wire_spec, h.port, [(prompts[1], DISAGG_NEW)])[0][1]
                for rid, h in sorted(hs.items())}
        same = sum(v == ref_tokens[1] for v in solo.values())
        log(f"[fleet] (b) one prompt alone on each replica: {same}/3 streams bitwise the "
            f"decode-0 reference")
        if same != 3:
            failures.append(f"(b) the replicas disagree alone: {solo}")

        # the handoff round: every stream through the router, prefill pool
        # then decode pool
        before = {k: v for k, v in handoff_counts(router_mod).items()}
        t = time.perf_counter()
        got = disagg_streams(wire_spec, fl.port, work)
        window = time.perf_counter() - t
        moved = {k: v - before[k] for k, v in handoff_counts(router_mod).items()}
        ok = sum(g[0] == 0 and g[1] == r for g, r in zip(got, ref_tokens))
        ttft = [g[3][0] for g in got if g[3]]
        gaps = [b - a for g in got for a, b in zip(g[3], g[3][1:]) if b > a]
        handoff_ms = moved["handoff_sum"] / max(1, moved["handoff_count"]) * 1e3
        log(f"[fleet] (b) {len(work)} streams handed off through the router in {window:.2f} "
            f"s: {ok}/{len(work)} status 0 and bitwise the plain stream; snapshot frames seen "
            f"by the clients {sum(g[2] for g in got)}; handoffs ok {moved['ok']}, retried "
            f"{moved['retried']}, degraded {moved['degraded']}, failed {moved['failed']}; "
            f"time to first token p50 {_pct(ttft, 50) * 1e3:.1f} / p99 "
            f"{_pct(ttft, 99) * 1e3:.1f} ms; inter-token gaps p50 {_pct(gaps, 50) * 1e3:.2f} "
            f"/ p99 {_pct(gaps, 99) * 1e3:.2f} ms; handoff (prefill snapshot held to decode "
            f"replica accepted) mean {handoff_ms:.1f} ms | {card}")
        if ok != len(work) or moved["ok"] + moved["retried"] < 1 or moved["failed"] \
                or any(g[2] for g in got):
            failures.append(f"(b) handoff round: {ok}/{len(work)}, {moved}")
        live = [_settled(fl.router)]
        res.update(handoff_ok=moved["ok"] + moved["retried"], ttft_ms=_pct(ttft, 50) * 1e3,
                   ttft_p99_ms=_pct(ttft, 99) * 1e3, itl_p50_ms=_pct(gaps, 50) * 1e3,
                   itl_p99_ms=_pct(gaps, 99) * 1e3, handoff_ms=handoff_ms)

        # a decode replica SIGKILLed mid-stream: its streams finish on the
        # other through kv_resume, one unbroken status-0 stream each
        kill_work = [(p, DISAGG_KILL_NEW) for p in prompts[:4]]
        kill_ref = disagg_streams(wire_spec, port_of("decode-1"), kill_work)
        killed = {}

        def kill_decode():
            # every stream is past its handoff: the decode replica whose
            # engine holds the most of them (its cmd-3 health) dies
            active = {rid: json.loads(_call(fl.handles()[rid].port, wire_spec.build_request(
                wire_spec.CMD_HEALTH))[1])["decode"]["active"] for rid in ("decode-0", "decode-1")}
            rid = max(active, key=active.get)
            killed.update(rid=rid, active=active[rid], t=time.monotonic())
            os.kill(fl.handles()[rid].pid, signal.SIGKILL)

        k1_pre = {}
        for rid, h in fl.handles().items():
            st = _stats(wire_spec, h.port)["decode"]
            k1_pre[rid] = (st["k1_launches"], st["prefix_fill_steps"] + st["steps"])
        before = handoff_counts(router_mod)
        got = disagg_streams(wire_spec, fl.port, kill_work, kill_at=(DISAGG_KILL_AT,
                                                                     kill_decode))
        moved = {k: v - before[k] for k, v in handoff_counts(router_mod).items()}
        ok = sum(g[0] == 0 and g[1] == r[1] for g, r in zip(got, kill_ref))
        resume_ms = moved["resume_sum"] / max(1, moved["resume_count"]) * 1e3
        log(f"[fleet] (b) SIGKILL of {killed.get('rid')} ({killed.get('active')} streams active "
            f"in its engine) once every stream held {DISAGG_KILL_AT} tokens: {ok}/"
            f"{len(kill_work)} streams status 0 and bitwise the unbroken stream (no token "
            f"duplicated or lost); paddle_decode_resumes_total ok {moved['resume_ok']}, refused "
            f"{moved['resume_refused']}, no_snapshot {moved['resume_none']}; resume (replica "
            f"death to the first resumed frame) mean {resume_ms:.1f} ms | {card}")
        if not killed or ok != len(kill_work) or moved["resume_ok"] < 1:
            failures.append(f"(b) kill round: {ok}/{len(kill_work)}, {moved}, {killed}")
        live.append(_settled(fl.router))
        res.update(resume_ms=resume_ms, resumes=moved["resume_ok"])

        # respawn (the supervisor's tick), then its first request: a
        # prompt seen before, from the persistent prefix tier
        t = time.monotonic()
        tick = fl.supervise_once()
        new = [r for r in fl.pools()["decode"] if r not in hs]
        respawn_s = time.monotonic() - killed.get("t", t)
        routable = len(fl.registry.routable("decode"))
        got = disagg_streams(wire_spec, port_of(new[0]), [(prompts[0], DISAGG_NEW)])[0] \
            if new else (None, [], 0, [])
        pst = _stats(wire_spec, port_of(new[0]))["decode"]["prefix"] if new else {}
        log(f"[fleet] (b) supervise_once: {tick['dead']} dead, respawned {new}, routable "
            f"decode replicas {routable}; respawn to routable {respawn_s:.1f} s after the kill "
            f"(the tick itself {time.monotonic() - t:.1f} s); its first request, the "
            f"{ENGINE_PROMPT}-token prompt seen before: status {got[0]}, bitwise the cold "
            f"stream {got[1] == ref_tokens[0]}, persistent-tier hits "
            f"{pst.get('store_hits')}, refused {pst.get('store_refused')} | {card}")
        if not new or routable != 2 or got[0] != 0 or got[1] != ref_tokens[0] \
                or not pst.get("store_hits"):
            failures.append(f"(b) respawn: {new}, routable {routable}, {got[0]}, {pst}")
        res.update(respawn_s=respawn_s, store_hits=pst.get("store_hits"))

        # K1: one a layer a fill and a step in every live replica
        k1s = {}
        for rid, h in sorted(fl.handles().items()):
            st = _stats(wire_spec, h.port)["decode"]
            k1s[rid] = (st["k1_launches"], st["prefix_fill_steps"] + st["steps"])
        log("[fleet] (b) K1 launches / (fill replays + steps) per live replica (cmd-5 "
            "stats): " + ", ".join(f"{r} {k} / {c}" for r, (k, c) in k1s.items()))
        if any(k != FLEET_LLAMA_LAYERS * c or not c for k, c in k1s.values()):
            failures.append(f"(b) K1 {k1s}")
        res["k1"] = sum(k for k, _ in k1s.values()) + k1_pre.get(killed.get("rid"), (0,))[0]

        # the prefill pool SIGKILLed: new streams degrade to colocated
        # serving on the decode pool, counted, with the same tokens
        pre = fl.pools()["prefill"][0]
        os.kill(fl.handles()[pre].pid, signal.SIGKILL)
        fl.handles()[pre].proc.wait(60)
        before = handoff_counts(router_mod)
        deg_work = [(p, DISAGG_NEW) for p in prompts[1:1 + DISAGG_DEGRADED]]
        got = disagg_streams(wire_spec, fl.port, deg_work)
        moved = {k: v - before[k] for k, v in handoff_counts(router_mod).items()}
        ok = sum(g[0] == 0 and g[1] == r for g, r in zip(got, ref_tokens[1:]))
        log(f"[fleet] (b) prefill pool SIGKILLed: {ok}/{len(deg_work)} new streams status 0 "
            f"and bitwise the plain stream; paddle_handoff_total degraded "
            f"{moved['degraded']}, failed {moved['failed']}")
        if ok != len(deg_work) or moved["degraded"] < len(deg_work) or moved["failed"]:
            failures.append(f"(b) degraded: {ok}/{len(deg_work)}, {moved}")
        live.append(_settled(fl.router))
        log(f"[fleet] (b) the router's live kv snapshots after the handoff, kill and "
            f"degraded rounds: {live}")
        if any(live):
            failures.append(f"(b) live snapshots {live}")
    finally:
        if fl is not None:
            fl.close()
    return res, failures


def _settled(router, timeout=10.0):
    """The router's live kv snapshots once its relays have finished (a
    relay drops its snapshot just after the terminal frame went out)."""
    deadline = time.monotonic() + timeout
    while router.live_snapshots() and time.monotonic() < deadline:
        time.sleep(0.01)
    return router.live_snapshots()


def handoff_counts(router_mod):
    """The router's handoff and resume counters (this process's registry)."""
    M = router_mod
    h, r = M._M_HANDOFF_SECONDS.value(), M._M_RESUME_SECONDS.value()
    return dict(ok=M._M_HANDOFF.value(outcome="ok"), retried=M._M_HANDOFF.value(outcome="retried"),
                degraded=M._M_HANDOFF.value(outcome="degraded"),
                failed=M._M_HANDOFF.value(outcome="failed"), handoff_sum=h["sum"],
                handoff_count=h["count"], resume_ok=M._M_RESUMES.value(outcome="ok"),
                resume_refused=M._M_RESUMES.value(outcome="refused"),
                resume_none=M._M_RESUMES.value(outcome="no_snapshot"), resume_sum=r["sum"],
                resume_count=r["count"])


def phase_fleet(torch, mods, card, deploy):
    """Phase 20: the fleet tier on the card (see the module docstring)."""
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    log(f"[fleet] the parent's earlier models released: {free / 2**30:.2f} GiB free of "
        f"{total / 2**30:.2f} GiB, {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    import shutil
    import tempfile

    # (b)'s three 7B replica processes start now, beside (a): each takes
    # ~45 s (the 13.5 GB weights digest 15-20 s of it), and (a)'s replicas
    # and traffic leave the memory and the card room for them
    tmp = tempfile.mkdtemp(prefix="paddle_tpu_torch_fleet_")
    spawn7 = disagg_spawner(torch, tmp, os.path.join(tmp, "prefix"),
                            ("prefill", "decode", "decode"))
    try:
        a, fa_ = fleet_bert(torch, mods, card, deploy)
        gc.collect()
        torch.cuda.empty_cache()
        t_a = time.perf_counter() - t_phase
        b, fb = fleet_llama(torch, mods, card, spawn7, free)
    except BaseException:
        for path in spawn7.logs():
            with open(path) as f:
                log(f"[fleet] {os.path.basename(path)}: ...{f.read()[-1500:]}")
        raise
    finally:
        spawn7.reap()
        shutil.rmtree(tmp, ignore_errors=True)
    failures = fa_ + fb
    log(f"[fleet] the phase took {time.perf_counter() - t_phase:.1f} s ((a) {t_a:.1f} s) "
        f"| {card}")
    if failures:
        fail("fleet: " + "; ".join(failures))
    return dict(a=a, b=b, launches=a["k1"] + b["k1"])


# ------------------------------------------------------------------ phase 21
F16_WARMUP, F16_STEPS = 3, 20  # (b): BERT-base fp16 O1 dygraph steps on phase 5's batch
F16_INIT_SCALE = 2.0 ** 15  # GradScaler's default init_loss_scaling (the reference's)
F16_PARITY_TRIES = 16  # (b): scaler steps tried until the parity step is taken (scale >= 0.5)
# (b)'s card-vs-CPU step: BERT-base width at depth 1, batch 1 x 128 (at
# depth 2, batch 4 the CPU's fp16 GEMMs took 33-67 s of the script's 1,200 s;
# at depth 1, batch 2, 21.75 s)
F16_PARITY_DEPTH = 1
F16_PARITY_BATCH = 1
# (b) the depth-2 fp16 O1 step, card vs CPU (the CPU runs K1-K3's plain
# versions and its own fp16 GEMMs, which round at other points): test_torch_
# train.py's O1 bounds, loss 2e-3 relative and clipped gradients within 5e-2
# of each tensor's max (the key biases' within 5e-2 of the model's largest),
# updated parameters within 2.5 lr
TOL_F16_LOSS, TOL_F16_GRAD = 2e-3, 5e-2
GUARD_DEPTH, GUARD_BATCH, GUARD_AFTER = 2, 4, 5  # (c): BERT-base width at depth 2; good steps
OFFLOAD_WARMUP, OFFLOAD_STEPS = 3, 5  # (d): Llama-374M steps, resident and offloaded


def f16_dygraph_step(paddle, model, opt, scaler, batch, inject=None):
    """One fp16 O1 eager step with dynamic loss scaling: the forward under
    auto_cast(O1, float16), scaler.scale(loss).backward(), scaler.step(opt)
    (the reference's step unscales, skips on a non-finite gradient and runs
    update() itself), opt.clear_grad(). ``inject`` multiplies the loss
    before it is scaled (an inf makes the loss and every gradient it
    reaches non-finite). Returns the loss."""
    ids, pos, labels = batch
    with paddle.amp.auto_cast(enable=True, level="O1", dtype="float16"):
        mlm_logits, _ = model(ids, masked_positions=pos)
        loss = dygraph_mlm_loss(paddle, mlm_logits, labels)
    scaled = scaler.scale(loss if inject is None else loss * inject)
    scaled.backward()
    scaler.step(opt)
    opt.clear_grad()
    return loss


def phase_safety(torch, fa, mods, card, dyg, lm):
    """Phase 21 (module docstring): the fp16 forms on the training path,
    the loss scaler, the bad-step guard with rollback, optimizer-state
    offload."""
    (paddle, BertForPretraining, LlamaModel, nn, optimizer, spmd, prandom, resilience) = mods
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    torch.set_num_threads(os.cpu_count() or 1)
    batch, build = bert_pretraining_parts(torch, nn, optimizer, spmd)
    bert_kw = dict(hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)
    failures = []
    first = (fa.launches, fa.dq_launches, fa.dkv_launches)

    # (b) BERT-base fp16 O1 dygraph with GradScaler: first a depth-1 step at
    # batch 2, card against CPU from the same weights and key stream (the
    # scaler's skips until the step is taken held equal too)
    model = BertForPretraining(num_hidden_layers=F16_PARITY_DEPTH, **bert_kw, device="cuda",
                               generator=torch.Generator().manual_seed(0))
    vocab = model.bert.vocab_size
    cpu_model = copy.deepcopy(model).to("cpu")
    runs, skips, secs = {}, {}, {}
    for dev, m in (("gpu", model), ("cpu", cpu_model)):
        paddle.set_device(dev)
        opt = dygraph_optimizer(paddle, m)
        scaler = paddle.amp.GradScaler(init_loss_scaling=F16_INIT_SCALE)
        data = dygraph_batch(paddle, *batch(F16_PARITY_BATCH, vocab))
        paddle.seed(0)
        skips[dev] = []
        t = time.perf_counter()
        for _ in range(F16_PARITY_TRIES):
            loss = float(f16_dygraph_step(paddle, m, opt, scaler, data).numpy())
            if opt._accumulators:  # the optimizer stepped: the step was taken
                break
            skips[dev].append(scaler._scale)
        secs[dev] = time.perf_counter() - t
        runs[dev] = (loss, first_moments(opt, m),
                     {n: p.detach().cpu() for n, p in m.named_parameters()})
    paddle.set_device("gpu")
    log(f"[safety] (b) depth-{F16_PARITY_DEPTH} fp16 O1 dygraph step at batch "
        f"{F16_PARITY_BATCH}, dropout 0.1, "
        f"GradScaler(init_loss_scaling=2^15): skips before the taken step card {len(skips['gpu'])} "
        f"(scales after them {skips['gpu']}), cpu {len(skips['cpu'])}; card {secs['gpu']:.2f} s, "
        f"cpu {secs['cpu']:.2f} s")
    if skips["gpu"] != skips["cpu"] or not runs["gpu"][1]:
        failures.append(f"(b) the scaler's skips differ card {skips['gpu']} / cpu "
                        f"{skips['cpu']}, or no step was taken")
    else:
        bad, _ = hold_step(f"(b) fp16 O1 step at depth {F16_PARITY_DEPTH}: card vs CPU",
                           runs["gpu"], runs["cpu"], tol_loss=TOL_F16_LOSS,
                           tol_grad=TOL_F16_GRAD, tol_zero=TOL_F16_GRAD)
        failures += [f"(b) parity {b}" for b in bad]
    del model, cpu_model, runs, opt, scaler, data

    # full depth at phase 5's batch of 64 x 128: 3 warm-up and 20 timed steps
    model = BertForPretraining(**bert_kw, device="cuda", generator=torch.Generator().manual_seed(0))
    n_layers = len(model.bert.encoder.layers)
    opt = dygraph_optimizer(paddle, model)
    scaler = paddle.amp.GradScaler(init_loss_scaling=F16_INIT_SCALE)
    data = dygraph_batch(paddle, *batch(O1_BATCH, vocab))
    paddle.seed(0)
    scales, losses, step_secs, skipped = [], [], [], 0
    for i in range(F16_WARMUP + F16_STEPS):
        if i == F16_WARMUP:
            torch.cuda.reset_peak_memory_stats()
            fa.form_launches.clear()
        before = scaler.state_dict()
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss = f16_dygraph_step(paddle, model, opt, scaler, data)
        torch.cuda.synchronize()
        step_secs.append(time.perf_counter() - t)
        losses.append(float(loss.numpy()))
        scales.append(scaler._scale)
        skipped += scaler._scale < before["scale"]
    forms = {k: fa.form_launches.get((k, TRAIN_SEQ, TRAIN_SEQ, "float16"), 0)
             for k in ("fwd", "dq", "dkv")}
    want_n = n_layers * F16_STEPS
    steady = _median(step_secs[F16_WARMUP:])
    tokens = O1_BATCH * TRAIN_SEQ
    peak = torch.cuda.max_memory_allocated()
    log(f"[safety] (b) fp16 O1 dygraph, batch {O1_BATCH} x seq {TRAIN_SEQ}, dropout 0.1, "
        f"{F16_WARMUP} + {F16_STEPS} steps: loss " + " ".join(f"{v:.4f}" for v in losses))
    log(f"[safety] (b) the scale after each step: {scales}; steps skipped {skipped} (each "
        "halves the scale)")
    log(f"[safety] (b) fp16 O1 dygraph step (median of the {F16_STEPS} timed steps, host clock "
        f"to synchronize): {steady * 1e3:.2f} ms, {tokens / steady:.0f} tokens/s; phase 15's "
        f"bf16 O1 dygraph step in this run {dyg['step_ms']:.2f} ms; peak memory "
        f"{peak / 2**30:.2f} GiB | {card}")
    log(f"[safety] (b) fp16 launches by form (kernel, {TRAIN_SEQ}, {TRAIN_SEQ}, float16) over "
        f"the {F16_STEPS} timed steps: {forms} (expected {want_n} each)")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        failures.append(f"(b) the loss is not finite or did not fall: {losses}")
    if any(v != want_n for v in forms.values()):
        failures.append(f"(b) fp16 launches {forms} != {n_layers} x {F16_STEPS}")

    # (c, last part) the scaler with a monitor attached: an inf multiplied
    # into the loss skips the step, leaves the parameters bitwise, halves the
    # scale and counts as bad
    mon = scaler.attach_bad_step_monitor(resilience.BadStepMonitor(threshold=3))
    snap = {n: p.detach().clone() for n, p in model.named_parameters()}
    scale0 = scaler._scale
    f16_dygraph_step(paddle, model, opt, scaler, data, inject=float("inf"))
    same = all(torch.equal(p.detach(), snap[n]) for n, p in model.named_parameters())
    log(f"[safety] (c) GradScaler + BadStepMonitor, inf injected into the loss: parameters "
        f"bitwise unchanged {same}, scale {scale0} -> {scaler._scale}, monitor total_bad "
        f"{mon.total_bad}, consecutive {mon.consecutive}")
    if not (same and scaler._scale == scale0 / 2 and mon.total_bad == 1):
        failures.append("(c) the scaler's injected inf did not skip, halve and count")
    del model, opt, scaler, data, snap
    gc.collect()
    torch.cuda.empty_cache()

    # (c) build_train_step(O1, float16, bad_step_guard=True) at depth 2: the
    # loss takes per-position weights from the batch, so a batch can carry a
    # NaN (the ids are integers)
    def weighted_loss(mlm_logits, target):
        labels, weight = target
        logp = torch.log_softmax(mlm_logits.float(), dim=-1)
        nll = -torch.take_along_dim(logp, labels[..., None].long(), dim=-1)[..., 0]
        return (nll * weight).sum() / weight.sum()

    model = BertForPretraining(num_hidden_layers=GUARD_DEPTH, hidden_dropout_prob=0.0,
                               attention_probs_dropout_prob=0.0, device="cuda",
                               generator=torch.Generator().manual_seed(1))
    step, init = build(model, "O1", loss=weighted_loss, amp_dtype="float16",
                       bad_step_guard=True)
    params, state = init()
    packed, labels = (t.cuda() for t in batch(GUARD_BATCH, vocab))
    ones = torch.ones(labels.shape, device=labels.device)
    poisoned = ones.clone()
    poisoned[0, 0] = float("nan")
    keys = iter(prandom.fold_in(prandom.PRNGKey(21), i) for i in range(64))
    loss, params, state, bad = step(params, state, packed, (labels, ones), key=next(keys))
    snap_p = {n: p.clone() for n, p in params.items()}
    snap_s = {n: tuple(a.clone() for a in st) for n, st in state.items()}
    given = (params, state)
    loss_bad, params, state, bad = step(params, state, packed, (labels, poisoned), key=next(keys))
    kept = (all(torch.equal(params[n], snap_p[n]) and torch.equal(given[0][n], snap_p[n])
                for n in snap_p)
            and all(torch.equal(a, b) for n in snap_s for a, b in zip(state[n], snap_s[n])))
    log(f"[safety] (c) guarded fp16 O1 step at depth {GUARD_DEPTH}, batch {GUARD_BATCH}: a good "
        f"step's loss {float(loss):.4f}; a NaN batch: loss {float(loss_bad)}, bad {bool(bad)}, "
        f"params and opt_state (donated) bitwise unchanged {kept}")
    if not (bool(bad) and kept):
        failures.append("(c) the NaN batch was not a no-op")
    tmp = tempfile.mkdtemp(prefix="paddle_tpu_torch_safety_")
    try:
        mgr = resilience.CheckpointManager(tmp, keep=2)
        t = time.perf_counter()
        mgr.save({"params": params, "opt": {n: list(st) for n, st in state.items()}}, 1)
        save_s = time.perf_counter() - t
        saved = {n: p.detach().cpu() for n, p in params.items()}
        mon = resilience.BadStepMonitor(threshold=3, manager=mgr)
        actions = []
        for _ in range(3):
            _, params, state, bad = step(params, state, packed, (labels, poisoned),
                                         key=next(keys))
            actions.append(mon.record(bool(bad)))
        t = time.perf_counter()
        restored, at = mon.restore()
        restore_s = time.perf_counter() - t
        params = {n: torch.as_tensor(np.asarray(v)).cuda() for n, v in restored["params"].items()}
        state = {n: tuple(torch.as_tensor(np.asarray(a)).cuda() for a in st)
                 for n, st in restored["opt"].items()}
        back = all(torch.equal(params[n].cpu(), saved[n]) for n in saved)
        after = []
        for _ in range(GUARD_AFTER):
            loss, params, state, bad = step(params, state, packed, (labels, ones), key=next(keys))
            after.append((float(loss), bool(bad)))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[safety] (c) BadStepMonitor(threshold=3, CheckpointManager): three NaN batches -> "
        f"{actions}; restore() -> step {at}, params bitwise the saved step's {back} (save "
        f"{save_s:.2f} s, restore {restore_s:.2f} s, the state {sum(v.numel() for v in saved.values()) * 12 / 2**20:.0f} MiB "
        f"with AdamW's moments); then {GUARD_AFTER} steps: loss "
        + " ".join(f"{v:.4f}" for v, _ in after))
    if actions != [resilience.badstep.SKIP, resilience.badstep.SKIP,
                   resilience.badstep.ROLLBACK] or at != 1 or not back:
        failures.append(f"(c) the rollback did not restore the saved step: {actions}, {at}")
    if any(b for _, b in after) or not after[-1][0] < after[0][0]:
        failures.append(f"(c) training after the rollback: {after}")
    del model, step, init, params, state, restored, saved, given, snap_p, snap_s
    gc.collect()
    torch.cuda.empty_cache()

    # (d) Llama-374M at bench.py's run_llama shape (phase 13's O1 bf16 step):
    # offload=True beside the resident step from the same weights
    make_batch, lm_build = lm_parts(torch, nn, optimizer, spmd)
    x, y = make_batch(LM_BATCH)("cuda")
    lkeys = ([prandom.fold_in(prandom.PRNGKey(0), i) for i in range(OFFLOAD_WARMUP)]
             + [prandom.fold_in(prandom.PRNGKey(0), 100 + i) for i in range(OFFLOAD_STEPS)])
    base = LlamaModel(**LM_CFG, max_seq_len=LM_SEQ, device="cuda",
                      generator=torch.Generator(device="cuda").manual_seed(0))
    lm_layers = len(base.layers)
    out = {}
    for offload in (False, True):
        m = copy.deepcopy(base)
        step, init = lm_build(m, "O1", offload=offload)
        params, state = init()
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        params, state, losses, secs = train_steps(torch, step, params, state, x, y, lkeys)
        peak = torch.cuda.max_memory_allocated()
        pinned = all(a.device.type == "cpu" and a.is_pinned()
                     for st in state.values() for a in st if a.dim()) if offload else None
        out[offload] = dict(losses=losses, ms=_median(secs[OFFLOAD_WARMUP:]) * 1e3, peak=peak,
                            resident=resident, pinned=pinned,
                            params={n: p.cpu() for n, p in params.items()},
                            state_bytes=sum(a.numel() * a.element_size()
                                            for st in state.values() for a in st if a.dim()))
        del m, step, init, params, state
        gc.collect()
        torch.cuda.empty_cache()
    del base
    r, o = out[False], out[True]
    same = r["losses"] == o["losses"] and all(torch.equal(r["params"][n], o["params"][n])
                                              for n in r["params"])
    log(f"[safety] (d) Llama-374M O1 bf16, batch {LM_BATCH} x {LM_SEQ}, {OFFLOAD_WARMUP} + "
        f"{OFFLOAD_STEPS} steps: resident loss " + " ".join(f"{v:.4f}" for v in r["losses"]))
    log(f"[safety] (d) offload=True: losses and final params bitwise the resident run's {same}; "
        f"every non-scalar state tensor pinned on the host {o['pinned']} "
        f"({o['state_bytes'] / 2**30:.2f} GiB); step (median of the timed steps, host clock to "
        f"synchronize) resident {r['ms']:.2f} ms, offload {o['ms']:.2f} ms (phase 13's O1 step "
        f"in this run {lm['step_ms']:.2f} ms); peak memory "
        f"resident {r['peak'] / 2**30:.2f} GiB, offload {o['peak'] / 2**30:.2f} GiB (drop "
        f"{(r['peak'] - o['peak']) / 2**30:.2f} GiB); allocated before the steps "
        f"{r['resident'] / 2**30:.2f} / {o['resident'] / 2**30:.2f} GiB | {card}")
    if not same or not o["pinned"]:
        failures.append("(d) the offloaded run differs from the resident one, or its state "
                        "is not pinned on the host")
    if not all(np.isfinite(r["losses"])) or not r["losses"][-1] < r["losses"][0]:
        failures.append(f"(d) the loss is not finite or did not fall: {r['losses']}")
    launches = tuple(a - b for a, b in zip((fa.launches, fa.dq_launches, fa.dkv_launches), first))
    log(f"[safety] (e) K1/K2/K3 launches over the phase {launches} (of them fp16 (b)'s "
        f"{forms}, Llama's bf16 {lm_layers} x {2 * len(lkeys)} each); the phase took "
        f"{time.perf_counter() - t_phase:.1f} s")
    del out
    gc.collect()
    torch.cuda.empty_cache()
    if failures:
        fail("safety: " + "; ".join(failures))
    return dict(launches=launches, forms=forms, step_ms=steady * 1e3, skipped=skipped,
                scales=scales, losses=losses, offload_ms=o["ms"], resident_ms=r["ms"],
                offload_peak=o["peak"], resident_peak=r["peak"])


# ------------------------------------------------------------------ phase 22
# (a): yolov3_darknet53_270e_coco (PaddleDetection) at a 608 input, batch 8:
# its three heads (grid, downsample, COCO's anchors of the head)
YOLO_BATCH, YOLO_INPUT, YOLO_CLASSES = 8, 608, 80
YOLO_HEADS = ((19, 32, (116, 90, 156, 198, 373, 326)),
              (38, 16, (30, 61, 62, 45, 59, 119)),
              (76, 8, (10, 13, 16, 30, 33, 23)))
YOLO_CONF = 0.01
# the configs' post-processing: yolov3's MultiClassNMS, ppyolo_r50vd_dcn_1x_coco's MatrixNMS
MULTICLASS_NMS = dict(score_threshold=0.01, nms_top_k=1000, keep_top_k=100, nms_threshold=0.45,
                      background_label=-1)
MATRIX_NMS = dict(score_threshold=0.01, post_threshold=0.01, nms_top_k=-1, keep_top_k=100,
                  use_gaussian=False, gaussian_sigma=2.0, background_label=-1, normalized=False)
LEAF_TIE = 1e-5  # (a): a score or IoU this close (relative) to a threshold or another is a tie
LEAF_EXEMPT = 0.01  # (a): exempted rows must stay under this share of the kept rows
TOL_DET = 1e-5  # (a): boxes and scores, card vs CPU, relative to the max
# (b): faster_rcnn_r50_fpn_1x_coco at 800 x 1333 (padded to 800 x 1344), batch 2
FPN_BATCH, FPN_CHANNELS, FPN_IMAGE = 2, 256, (800, 1333)
FPN_SHAPES = ((200, 336), (100, 168), (50, 84), (25, 42))  # P2-P5
FPN_RPN_LEVELS, FPN_RPN_PER_LEVEL, FPN_POST_NMS = 5, 1000, 1000  # RPN's P2-P6 proposals
TOL_ROI_FWD, TOL_ROI_GRAD = 1e-5, 1e-4
# (c): ResNet50-vd-DCN's stage-5 3 x 3 conv (PP-YOLO) at a 608 input, batch 8
DCN_BATCH, DCN_CHANNELS, DCN_HW = 8, 512, 19
TOL_DCN_FWD, TOL_DCN_GRAD = 1e-4, 1e-3
# (d): a flat-list DecodeModel of Llama-2-7B's width at depth 2
FLAT_DEPTH, FLAT_STREAMS, FLAT_PROMPT, FLAT_NEW = 2, 16, 64, 32
# an f32 copy of the smallest matrix (4096 x 4096) is 64 MiB: neither the window's peak
# growth nor the flat list's graph pool over _LlamaWeights.quantized's may reach it
FLAT_PEAK_SLACK = 64 << 20
LEAF_CARD = "cuda"  # where phase 22 runs the card's side (a CPU rehearsal sets "cpu")
# (e)
TOL_HESSIAN = 1e-4
TOL_NORMAL_SAMPLE = 1e-6  # torch.erfinv on the card and on the CPU, relative to the max
CPP_OP_SRC = r"""
#include <cstdint>
extern "C" void cube(const float* x, float* y, int64_t n) { for (int64_t i = 0; i < n; ++i) y[i] = x[i] * x[i] * x[i]; }
extern "C" void cube_grad(const float* x, const float* dy, float* dx, int64_t n) { for (int64_t i = 0; i < n; ++i) dx[i] = 3.f * x[i] * x[i] * dy[i]; }
"""


def leaf_timed(torch, fn, iters=10):
    """(CUDA-event ms, device ms) of one call of ``fn``: ``timed``'s, with
    a one-call profiler window where its window lost records."""
    ms, dev = timed(torch, fn, iters=iters)
    return ms, dev if dev is not None else one_call_device_ms(torch, fn)


def yolo_inputs(rng):
    """The three heads' outputs [8, 3 * (80 + 5), g, g] from seed 0: box
    logits N(0, 1), objectness N(-4, 2), class logits N(-6, 2), so that
    about 2% of the (box, class) scores pass 0.01, as a trained head's."""
    heads = []
    for g, _, _ in YOLO_HEADS:
        x = rng.standard_normal((YOLO_BATCH, 3, YOLO_CLASSES + 5, g, g), dtype=np.float32)
        x[:, :, 4] = -4 + 2 * x[:, :, 4]
        x[:, :, 5:] = -6 + 2 * x[:, :, 5:]
        heads.append(x.reshape(YOLO_BATCH, -1, g, g))
    return heads


def yolo_decode(torch, ops, heads, dev):
    """yolo_box on each head (the image size 608 x 608) -> boxes [8, 22743,
    4], scores [8, 22743, 80] on ``dev``."""
    size = torch.full((YOLO_BATCH, 2), YOLO_INPUT, dtype=torch.int32, device=dev)
    outs = [ops.yolo_box(x, size, anchors, YOLO_CLASSES, YOLO_CONF, ds)
            for x, (_, ds, anchors) in zip(heads, YOLO_HEADS)]
    return torch.cat([b for b, _ in outs], 1), torch.cat([s for _, s in outs], 1)


def _ties(v, refs, tol=LEAF_TIE):
    refs = np.asarray(refs, np.float64)
    return bool(np.any(np.abs(refs - v) <= tol * np.maximum(np.abs(refs), abs(v))))


def _iou_row(box, boxes):
    """IoU of one box with each of ``boxes``, as the greedy NMS computes it."""
    ix = np.clip(np.minimum(box[2], boxes[:, 2]) - np.maximum(box[0], boxes[:, 0]), 0, None)
    iy = np.clip(np.minimum(box[3], boxes[:, 3]) - np.maximum(box[1], boxes[:, 1]), 0, None)
    inter = ix * iy
    area = (box[2] - box[0]) * (box[3] - box[1])
    areas = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    return inter / (area + areas - inter + 1e-12)


def hold_nms(label, runs, scores_cpu, boxes_cpu, thresholds, iou_thr):
    """Card vs CPU rows of one image's NMS: ``runs`` = {"card": (rows,
    index), "cpu": (rows, index)}. Rows kept by both agree at TOL_DET;
    a row kept by one run only is exempt when its score (or decayed
    score) lies within LEAF_TIE of a threshold or of another score, or its
    IoU with a box the CPU kept in its class within LEAF_TIE of
    ``iou_thr`` (greedy NMS; None for matrix NMS, whose decay is
    continuous in the IoU). -> (rows, matched rel error, exempt count);
    fails on an unexempted difference."""
    keyed = {}
    for run, (rows, index) in runs.items():
        keyed[run] = {(int(r[0]), int(i)): r for r, i in zip(rows, index)}
        if len(keyed[run]) != len(rows) or np.any(np.diff(rows[:, 1]) > 0):
            fail(f"{label}: the {run} run's rows are not distinct or not by score")
    card, cpu = keyed["card"], keyed["cpu"]
    both = sorted(set(card) & set(cpu))
    err = 0.0
    if both:
        a = np.stack([card[k] for k in both]).astype(np.float64)
        b = np.stack([cpu[k] for k in both]).astype(np.float64)
        err = float(np.max(np.abs(a[:, 1:] - b[:, 1:])) / max(np.max(np.abs(b[:, 1:])), 1e-30))
    flat = decayed = None
    exempt = 0
    for key in set(card) ^ set(cpu):
        c, i = key
        row = card.get(key, cpu.get(key))
        raw = float(scores_cpu[c, i])
        if flat is None:
            flat = np.sort(scores_cpu.reshape(-1))
            decayed = np.array([r[1] for r in list(card.values()) + list(cpu.values())],
                               np.float64)
        lo, hi = np.searchsorted(flat, [raw * (1 - 2 * LEAF_TIE), raw * (1 + 2 * LEAF_TIE)])
        close = np.abs(decayed - row[1]) <= LEAF_TIE * abs(float(row[1]))
        tied = (hi - lo) > 1 or int(close.sum()) > 1
        near = any(_ties(v, [t]) for v in (raw, float(row[1])) for t in thresholds)
        kept = np.array([cpu[k][2:] for k in cpu if k[0] == c and k != key])
        overlap = (iou_thr is not None and len(kept) > 0
                   and _ties(iou_thr, _iou_row(boxes_cpu[i], kept)))
        if not (tied or near or overlap):
            fail(f"{label}: class {c} box {i} (score {raw}) kept by one run only, and no "
                 "threshold or tie lies within 1e-5 of it")
        exempt += 1
    if err > TOL_DET:
        fail(f"{label}: rows kept by both runs differ by {err:.3g} of the max (> {TOL_DET})")
    return len(cpu), err, exempt


NMS_PRELOAD = ["paddle_tpu_torch.vision.ops"]


def start_nms_server():
    """Start phase 22's forkserver (a fresh interpreter importing the port
    once, ~20 s on the card's host) so that its import overlaps earlier
    phases; phase 22's pool forks its workers from it, then stops it."""
    from multiprocessing import forkserver

    forkserver.set_forkserver_preload(NMS_PRELOAD)
    forkserver.ensure_running()


def nms_image(job):
    """One image's multiclass_nms rows and matrix_nms rows and index, from
    host arrays (boxes [N, 4], scores [C, N]): a pool worker's job."""
    from paddle_tpu_torch.vision import ops

    boxes, scores = job
    mx, index = ops.matrix_nms(boxes, scores, return_index=True, **MATRIX_NMS)
    return (ops.multiclass_nms(boxes, scores, **MULTICLASS_NMS).numpy(), mx.numpy(),
            index.numpy())


def box_index(boxes):
    """Row box -> its index among an image's boxes (a kept row carries
    its box's four floats as they were)."""
    return {b.tobytes(): i for i, b in enumerate(boxes)}


def leaves_yolo(torch, ops, card):
    """(a) yolo_box on the card, then per image multiclass_nms and
    matrix_nms on the host, held against the port's CPU run."""
    rng = np.random.default_rng(0)
    heads = yolo_inputs(rng)
    dev_heads = [torch.from_numpy(h).to(LEAF_CARD) for h in heads]
    boxes, scores = yolo_decode(torch, ops, dev_heads, LEAF_CARD)
    ms, dev_ms = leaf_timed(torch, lambda: yolo_decode(torch, ops, dev_heads, LEAF_CARD))
    torch.cuda.synchronize()
    t = time.perf_counter()
    hb, hs = boxes.cpu().numpy(), scores.cpu().numpy()
    cross_ms = (time.perf_counter() - t) * 1e3
    cb, cs = (a.numpy() for a in yolo_decode(torch, ops, [torch.from_numpy(h) for h in heads],
                                             "cpu"))
    n_box = cb.shape[1]
    err_b = float(np.max(np.abs(hb - cb)) / np.max(np.abs(cb)))
    err_s = float(np.max(np.abs(hs - cs)) / np.max(np.abs(cs)))
    passing = float((cs > MULTICLASS_NMS["score_threshold"]).mean())
    log(f"[leaves] (a) yolo_box x 3 heads on [8, 255, 19|38|76, ...]: {n_box} boxes x "
        f"{YOLO_CLASSES} classes an image; {passing:.2%} of the scores pass 0.01; card vs CPU "
        f"boxes {err_b:.3g}, scores {err_s:.3g} of the max (tolerance {TOL_DET}); device "
        f"{_fmt(dev_ms)} ms ({ms:.3f} ms CUDA events) for the batch; the host crossing of "
        f"boxes and scores ({(hb.nbytes + hs.nbytes) / 2**20:.1f} MiB) {cross_ms:.2f} ms "
        f"[{card}]")
    if n_box != sum(3 * g * g for g, _, _ in YOLO_HEADS) or err_b > TOL_DET or err_s > TOL_DET:
        fail("(a): yolo_box's boxes or scores on the card disagree with the CPU's")
    # one image's NMS on the card's tensors, timed (its host crossing
    # included); then every image's, card-run and CPU-run arrays alike, in
    # a pool of worker processes (the host work of 16 calls; a worker
    # touches no card)
    t = time.perf_counter()
    first_mc = ops.multiclass_nms(boxes[0], scores[0].T, **MULTICLASS_NMS).cpu().numpy()
    mc_ms = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    first_mx = ops.matrix_nms(boxes[0], scores[0].T, return_index=True, **MATRIX_NMS)
    mx_ms = (time.perf_counter() - t) * 1e3
    jobs = [(b[i], s[i].T.copy()) for b, s in ((hb, hs), (cb, cs)) for i in range(YOLO_BATCH)]
    t = time.perf_counter()
    # a forkserver pool: the server process imports the port once and forks
    # the workers from that clean state (spawned workers each imported it:
    # ~35 s of 41 on the card's 8-core host; a fork of this process would
    # copy its CUDA context and its OpenMP threads' state); a full run
    # started the server after the build (start_nms_server)
    start_nms_server()
    ctx = mp.get_context("forkserver")
    with ctx.Pool(min(len(jobs), os.cpu_count() or 1)) as pool:
        results = pool.map(nms_image, jobs)
    from multiprocessing import forkserver

    forkserver._forkserver._stop()  # the server has no other user
    pool_s = time.perf_counter() - t
    if not (np.array_equal(first_mc, results[0][0])
            and np.array_equal(first_mx[0].cpu().numpy(), results[0][1])):
        fail("(a): image 0's NMS on the card's tensors differs from its host arrays'")
    totals = {"multiclass": [0, 0, 0.0], "matrix": [0, 0, 0.0]}
    for i in range(YOLO_BATCH):
        card_r, cpu_r = results[i], results[YOLO_BATCH + i]
        runs = {"multiclass": {}, "matrix": {}}
        for run, r, host_boxes in (("card", card_r, hb[i]), ("cpu", cpu_r, cb[i])):
            where = box_index(host_boxes)
            runs["multiclass"][run] = (r[0], [where[row[2:].tobytes()] for row in r[0]])
            runs["matrix"][run] = (r[1], r[2])
        for name, thr, iou_thr in (
                ("multiclass", (MULTICLASS_NMS["score_threshold"],),
                 MULTICLASS_NMS["nms_threshold"]),
                ("matrix", (MATRIX_NMS["score_threshold"], MATRIX_NMS["post_threshold"]), None)):
            n, err, ex = hold_nms(f"(a) image {i} {name}_nms", runs[name], cs[i].T, cb[i], thr,
                                  iou_thr)
            totals[name][0] += n
            totals[name][1] += ex
            totals[name][2] = max(totals[name][2], err)
    per_image = {"multiclass": mc_ms, "matrix": mx_ms}
    for name, (n, ex, err) in totals.items():
        log(f"[leaves] (a) {name}_nms: {n} rows kept over {YOLO_BATCH} images, the same rows "
            f"as the CPU run's but {ex} exempted near a threshold or tie ({LEAF_EXEMPT:.0%} "
            f"allowed), values within {err:.3g} of the max; {per_image[name]:.1f} ms an image "
            f"on the host (image 0, its inputs' crossing from the card included) [{card}]")
        if n == 0 or ex >= LEAF_EXEMPT * n:
            fail(f"(a): {name}_nms kept no row or exempted {ex} of {n}")
    log(f"[leaves] (a) the {len(jobs)} NMS images (card and CPU runs) in {pool_s:.1f} s over "
        f"a pool of {min(len(jobs), os.cpu_count() or 1)} processes")
    return dict(yolo_ms=dev_ms, cross_ms=cross_ms, nms_ms=per_image)


def fpn_inputs(rng):
    """P2-P5 [2, 256, h, w] and each image's RPN proposals (5 levels x
    1000, sizes log-uniform over 16-512 px, aspect 1:2-2:1, clipped to the
    image) with their scores, from seed 0."""
    maps = [rng.standard_normal((FPN_BATCH, FPN_CHANNELS, h, w), dtype=np.float32)
            for h, w in FPN_SHAPES]
    props = []
    ih, iw = FPN_IMAGE
    for _ in range(FPN_BATCH):
        rois, scores = [], []
        for _ in range(FPN_RPN_LEVELS):
            n = FPN_RPN_PER_LEVEL
            side = np.exp(rng.uniform(np.log(16), np.log(512), n))
            ar = np.exp(rng.uniform(np.log(0.5), np.log(2.0), n))
            cx, cy = rng.uniform(0, iw, n), rng.uniform(0, ih, n)
            w, h = side * np.sqrt(ar), side / np.sqrt(ar)
            box = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], 1)
            box = np.clip(box, 0, [iw - 1, ih - 1, iw - 1, ih - 1]).astype(np.float32)
            rois.append(box)
            scores.append(rng.uniform(0, 1, n).astype(np.float32))
        props.append((rois, scores))
    return maps, props


def fpn_rois(torch, ops, props, dev):
    """collect_fpn_proposals per image (post_nms_top_n 1000), the images'
    RoIs concatenated, then distribute_fpn_proposals (P2-P5, refer level 4
    at scale 224) -> (RoIs per level, restore index, boxes_num per level)."""
    per_image = [ops.collect_fpn_proposals([torch.from_numpy(r).to(dev) for r in rois],
                                           [torch.from_numpy(s).to(dev) for s in scores],
                                           2, 6, FPN_POST_NMS)
                 for rois, scores in props]
    rois = torch.cat(per_image)
    multi, restore = ops.distribute_fpn_proposals(rois, 2, 5, 4, 224)
    order = np.argsort(restore.cpu().numpy(), kind="stable")
    starts = np.cumsum([0] + [len(m) for m in multi])
    image = np.repeat(np.arange(FPN_BATCH), [len(r) for r in per_image])
    nums = [np.bincount(image[order[a:b]], minlength=FPN_BATCH).tolist()
            for a, b in zip(starts[:-1], starts[1:])]
    return multi, restore, nums


def fpn_forward(torch, ops, maps, multi, restore, nums):
    outs = [ops.roi_align(m, r, n, 7, spatial_scale=1.0 / 2 ** (lvl + 2), aligned=True)
            for lvl, (m, r, n) in enumerate(zip(maps, multi, nums))]
    return torch.cat(outs)[restore]


def leaves_fpn(torch, ops, card):
    """(b) collect -> distribute -> roi_align per level at Faster R-CNN FPN's
    shapes, forward and the gradient to the four maps, card vs CPU."""
    rng = np.random.default_rng(1)
    maps, props = fpn_inputs(rng)
    runs = {}
    for dev in (LEAF_CARD, "cpu"):
        multi, restore, nums = fpn_rois(torch, ops, props, dev)
        x = [torch.from_numpy(m).to(dev).requires_grad_() for m in maps]
        out = fpn_forward(torch, ops, x, multi, restore, nums)
        if dev == LEAF_CARD:
            g = torch.from_numpy(rng.standard_normal(tuple(out.shape), dtype=np.float32))
        (out * g.to(dev)).sum().backward()
        runs[dev] = dict(multi=[m.cpu().numpy() for m in multi], restore=restore.cpu().numpy(),
                         nums=nums, out=out.detach().cpu(), grads=[t.grad.cpu() for t in x],
                         x=x, g=g.to(dev), lists=(multi, restore))
    a, b = runs[LEAF_CARD], runs["cpu"]
    same_levels = (all(np.array_equal(p, q) for p, q in zip(a["multi"], b["multi"]))
                   and np.array_equal(a["restore"], b["restore"]) and a["nums"] == b["nums"])
    fwd = _rel_err(torch, a["out"], b["out"])
    grads = [_rel_err(torch, p, q) for p, q in zip(a["grads"], b["grads"])]
    x, g = a["x"], a["g"]
    multi, restore = a["lists"]

    def forward():
        return fpn_forward(torch, ops, x, multi, restore, a["nums"])

    def step():
        for t in x:
            t.grad = None
        (forward() * g).sum().backward()

    fwd_ms, fwd_dev = leaf_timed(torch, forward)
    step_ms = cuda_ms(torch, step, iters=5, warmup=1)
    step_dev = one_call_device_ms(torch, step)
    log(f"[leaves] (b) FPN RoIAlign: RoIs per level {[len(m) for m in a['multi']]} "
        f"(boxes_num {a['nums']}), out {tuple(a['out'].shape)}; level assignment and restore "
        f"index {'bitwise' if same_levels else 'DIFFERENT'}; forward {fwd:.3g} of the max "
        f"(tolerance {TOL_ROI_FWD}), the maps' gradients "
        + ", ".join(f"{e:.3g}" for e in grads) + f" of each max (tolerance {TOL_ROI_GRAD}); "
        f"forward {_fmt(fwd_dev)} ms device ({fwd_ms:.3f} ms CUDA events), forward + "
        f"backward {_fmt(step_dev)} ms device ({step_ms:.3f} ms CUDA events) [{card}]")
    if (not same_levels or tuple(a["out"].shape) != (FPN_BATCH * FPN_POST_NMS, FPN_CHANNELS, 7, 7)
            or fwd > TOL_ROI_FWD or max(grads) > TOL_ROI_GRAD):
        fail("(b): FPN RoIAlign on the card disagrees with the CPU run")
    return dict(fwd_ms=fwd_dev, step_ms=step_dev)


def dcn_inputs(rng):
    x = rng.standard_normal((DCN_BATCH, DCN_CHANNELS, DCN_HW, DCN_HW), dtype=np.float32)
    off = rng.uniform(-2, 2, (DCN_BATCH, 18, DCN_HW, DCN_HW)).astype(np.float32)
    mask = rng.uniform(0, 1, (DCN_BATCH, 9, DCN_HW, DCN_HW)).astype(np.float32)
    w = (rng.standard_normal((DCN_CHANNELS, DCN_CHANNELS, 3, 3), dtype=np.float32)
         / np.float32(np.sqrt(DCN_CHANNELS * 9)))
    b = rng.standard_normal(DCN_CHANNELS, dtype=np.float32) * np.float32(0.1)
    return x, off, mask, w, b


def leaves_dcn(torch, ops, paddle, card):
    """(c) DeformConv2D(512, 512, 3, padding=1) v2 and v1 at PP-YOLO's
    stage-5 width: forward and the gradients to x, offset, mask and the
    weight, card vs CPU; once through static.nn.deform_conv2d in a
    Program."""
    from paddle_tpu_torch import convert

    rng = np.random.default_rng(2)
    arrays = dcn_inputs(rng)
    layer = ops.DeformConv2D(DCN_CHANNELS, DCN_CHANNELS, 3, padding=1)
    convert.load_numpy_state(layer, {"weight": arrays[3], "bias": arrays[4]})
    g = rng.standard_normal((DCN_BATCH, DCN_CHANNELS, DCN_HW, DCN_HW), dtype=np.float32)
    result = {}
    for version in ("v2", "v1"):
        runs = {}
        for dev in (LEAF_CARD, "cpu"):
            t = [torch.from_numpy(a).to(dev).requires_grad_() for a in arrays]
            mask = t[2] if version == "v2" else None
            y = ops.deform_conv2d(t[0], t[1], t[3], t[4], padding=1, mask=mask)
            (y * torch.from_numpy(g).to(dev)).sum().backward()
            runs[dev] = (y.detach().cpu(), [a.grad.cpu() if a.grad is not None else None
                                           for a in t], t)
        (yc, gc, t), (yh, gh, _) = runs[LEAF_CARD], runs["cpu"]
        fwd = _rel_err(torch, yc, yh)
        names = ("x", "offset", "mask", "weight", "bias")
        grads = {n: _rel_err(torch, p, q) for n, p, q in zip(names, gc, gh) if q is not None}
        mask = t[2] if version == "v2" else None

        def forward():
            return ops.deform_conv2d(t[0], t[1], t[3], t[4], padding=1, mask=mask)

        def step():
            for a in t:
                a.grad = None
            forward().sum().backward()

        fwd_ms, fwd_dev = leaf_timed(torch, forward)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        step_ms = cuda_ms(torch, step, iters=5, warmup=1)
        peak = torch.cuda.max_memory_allocated() - base
        step_dev = one_call_device_ms(torch, step)
        log(f"[leaves] (c) DCN{version} [8, 512, 19, 19] 3 x 3: forward {fwd:.3g} of the max "
            f"(tolerance {TOL_DCN_FWD}); gradients "
            + ", ".join(f"{n} {e:.3g}" for n, e in grads.items())
            + f" of each max (tolerance {TOL_DCN_GRAD}); forward {_fmt(fwd_dev)} ms device "
            f"({fwd_ms:.3f} ms CUDA events), forward + backward {_fmt(step_dev)} ms device "
            f"({step_ms:.3f} ms CUDA events); peak memory "
            f"of a step {peak / 2**20:.0f} MiB over its inputs [{card}]")
        if fwd > TOL_DCN_FWD or max(grads.values()) > TOL_DCN_GRAD or len(grads) != (
                5 if version == "v2" else 4):
            fail(f"(c): DCN{version} on the card disagrees with the CPU run")
        result[version] = dict(fwd_ms=fwd_dev, step_ms=step_dev, peak_mib=peak / 2**20)
    # the layer, and static.nn.deform_conv2d in a Program with the same weights
    x, off, mask = (torch.from_numpy(a).to(LEAF_CARD) for a in arrays[:3])
    with torch.no_grad():
        want = layer(x, off, mask)
    paddle.enable_static()
    try:
        prog = paddle.static.Program()
        with paddle.static.program_guard(prog, paddle.static.Program()):
            d = [paddle.static.data(n, list(a.shape)) for n, a in zip(
                ("x", "offset", "mask"), arrays[:3])]
            y = paddle.static.nn.deform_conv2d(d[0], d[1], d[2], DCN_CHANNELS, 3, padding=1)
    finally:
        paddle.disable_static()
    convert.set_by_position(prog, [arrays[3], arrays[4]])
    got, = paddle.static.Executor().run(prog, feed=dict(zip(("x", "offset", "mask"),
                                                            arrays[:3])), fetch_list=[y])
    static_err = _rel_err(torch, torch.from_numpy(np.asarray(got)), want.cpu())
    log(f"[leaves] (c) static.nn.deform_conv2d in a Program on the card vs DeformConv2D: "
        f"{static_err:.3g} of the max")
    if static_err > TOL_DCN_FWD:
        fail("(c): static.nn.deform_conv2d disagrees with DeformConv2D")
    result.update(layer=layer, inputs=(x, off, mask))
    return result


def flat_llama(generation, model, slots, seq_len):
    """A DecodeModel over a flat param list: ``model``'s parameters in its
    (the reference's) order, and fill/step functions that take the list,
    view it as ``_LlamaWeights`` and run llama_decode_model's functions
    (whose products call wmatmul) -> (flat DecodeModel, llama_decode_model,
    view)."""
    from paddle_tpu_torch.inference.decode import DecodeModel

    llama = generation.llama_decode_model(model, slots, seq_len)
    w = llama.params
    names = [n for n, _ in model.named_parameters()]
    where = {id(p): k for k, p in model.named_parameters()}
    top = {k: where[id(v)] for k, v in w.params.items() if k != "layers"}
    per_layer = [{k: where[id(v)] for k, v in lp.items()} for lp in w.params["layers"]]

    def view(plist):
        by_name = dict(zip(names, plist))
        out = copy.copy(w)
        out.params = {k: by_name[n] for k, n in top.items()}
        out.params["layers"] = [{k: by_name[n] for k, n in lp.items()} for lp in per_layer]
        return out

    def fill_fn(plist, tokens, start, *staging):
        return llama.fill_fn(view(plist), tokens, start, *staging)

    def step_fn(plist, tokens, positions, *pools):
        return llama.step_fn(view(plist), tokens, positions, *pools)

    flat = DecodeModel([p.detach() for p in model.parameters()], fill_fn, step_fn,
                       llama.kv_spec, vocab_size=llama.vocab_size, kv_seq_axis=2,
                       device=llama.device, max_slots=slots, max_seq_len=seq_len)
    return flat, llama, view


def flat_window(torch, fa, qmm, engine, prompts):
    """Serve ``prompts`` through ``engine`` (warmed up): tokens, the
    launches of K1 and wq_matmul, the engine's fills and steps, the step
    replays' median ms (CUDA events), tokens/s, the peak memory over the
    window's start."""
    key = engine._step_key
    real = engine._programs[key]
    events = []

    def timed_step():
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        out = real()
        e.record()
        events.append((s, e))
        return out

    engine._programs[key] = timed_step
    st0 = engine.stats()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fa.launches = qmm.launches = 0
    t = time.perf_counter()
    reqs = [engine.submit(p, max_new_tokens=FLAT_NEW) for p in prompts]
    toks = [r.result(timeout=600) for r in reqs]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    k1, wq = fa.launches, qmm.launches
    engine._programs[key] = real
    st1 = engine.stats()
    fills = st1["prefix_fill_steps"] - st0["prefix_fill_steps"]
    steps = st1["steps"] - st0["steps"]
    return dict(tokens=toks, k1=k1, wq=wq, fills=fills, steps=steps,
                step_ms=float(np.median([s.elapsed_time(e) for s, e in events])),
                tokens_per_s=sum(len(x) for x in toks) / wall,
                peak=torch.cuda.max_memory_allocated() - base)


def leaves_flat_list(torch, fa, qmm, mods, card):
    """(d) a depth-2 Llama-2-7B-width flat-list DecodeModel quantized w8 and
    bf16w, 16 streams of 64 + 32 tokens, against llama_decode_model's
    weights quantized in the same mode."""
    LlamaModel, generation, DecodeEngine, quantization = mods
    from paddle_tpu_torch.quantization.serving import ACCURACY_BOUNDS, _flat_params, weight_bytes

    model = LlamaModel(num_layers=FLAT_DEPTH, device=LEAF_CARD,
                       generator=torch.Generator(device=LEAF_CARD).manual_seed(0)).eval()
    flat, llama, view = flat_llama(generation, model, FLAT_STREAMS, FLAT_PROMPT + FLAT_NEW)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, llama.vocab_size, FLAT_PROMPT).astype(np.int32)
               for _ in range(FLAT_STREAMS)]
    f32_logits = generation.llama_prompt_logits(llama, prompts[0])
    out = dict(wq_launches=0, k1_launches=0, modes={})
    per_fill, per_step = 7 * FLAT_DEPTH, 7 * FLAT_DEPTH + 1  # 7 products a layer, the head
    for mode in ("w8", "bf16w"):
        qflat = quantization.quantize_decode_model(flat, mode)
        logits = generation.llama_prompt_logits(
            types.SimpleNamespace(params=view(_flat_params(flat.params, mode)[2](qflat.params))),
            prompts[0])
        rel = float((logits - f32_logits).abs().max() / f32_logits.abs().max())
        wins = {}
        for form, dm in (("flat list", qflat), ("_LlamaWeights.quantized", llama)):
            with DecodeEngine(dm, max_prompt_len=FLAT_PROMPT, min_seq_bucket=FLAT_PROMPT,
                              max_queue=64, name=f"leaves-{mode}-{len(wins)}",
                              quant=mode, prefix=False, device=LEAF_CARD) as eng:
                eng.warmup()
                wins[form] = flat_window(torch, fa, qmm, eng, prompts)
                wins[form]["bytes"] = weight_bytes(eng._model.params)
                wins[form]["pool"] = eng.stats()["graph_pool_bytes"]
        a, b = wins["flat list"], wins["_LlamaWeights.quantized"]
        bitwise = all(np.array_equal(x, y) for x, y in zip(a["tokens"], b["tokens"]))
        want_wq = per_fill * a["fills"] + per_step * a["steps"]
        log(f"[leaves] (d) {mode}: weight_bytes {a['bytes'] / 1e9:.3f} GB (flat list) vs "
            f"{b['bytes'] / 1e9:.3f} GB; {FLAT_STREAMS} streams x {FLAT_PROMPT} + {FLAT_NEW}: "
            f"tokens {'bitwise' if bitwise else 'DIFFERENT from'} _LlamaWeights.quantized's; "
            f"{a['fills']} fills, {a['steps']} steps; wq_matmul {a['wq']} launches (expected "
            f"{want_wq} = {per_fill} x fills + {per_step} x steps), K1 {a['k1']}; prompt "
            f"logits {rel:.3g} of f32's max (bound {ACCURACY_BOUNDS[mode]}); the graphs' pool "
            f"{a['pool'] / 2**20:.1f} MiB ({b['pool'] / 2**20:.1f} MiB), peak memory over the "
            f"window's start {a['peak'] / 2**20:.1f} MiB (an f32 copy of one 4096 x 4096 matrix "
            f"is 64 MiB); {a['tokens_per_s']:.1f} tokens/s, step {a['step_ms']:.3f} ms "
            f"(_LlamaWeights.quantized: {b['tokens_per_s']:.1f} tokens/s, step "
            f"{b['step_ms']:.3f} ms) [{card}]")
        if (not bitwise or a["wq"] != want_wq or b["wq"] != per_fill * b["fills"]
                + per_step * b["steps"] or a["k1"] != FLAT_DEPTH * (a["fills"] + a["steps"])
                or not 0 < rel < ACCURACY_BOUNDS[mode] or a["peak"] >= FLAT_PEAK_SLACK
                or a["pool"] >= b["pool"] + FLAT_PEAK_SLACK or a["bytes"] != b["bytes"]):
            fail(f"(d) {mode}: the flat-list model's tokens, launches, accuracy or memory "
                 "disagree")
        out["wq_launches"] += a["wq"]
        out["k1_launches"] += a["k1"]
        out["modes"][mode] = dict(tokens_per_s=a["tokens_per_s"], step_ms=a["step_ms"],
                                  weight_bytes=a["bytes"], wq=a["wq"])
    return out


def leaves_small(torch, mods, card, dcn):
    """(e) the distributions, hessian, dlpack, run_check, a g++ custom op
    and a profiler window, each on the card against the CPU."""
    import shutil
    import tempfile

    paddle, utils, distribution, incubate_autograd = mods
    t = time.perf_counter()
    samples = {}
    for dev in (LEAF_CARD, "cpu"):
        paddle.seed(0)
        lo = torch.zeros(4, device=dev)
        samples[dev] = [
            distribution.Uniform(lo, lo + 3.0).sample((256,)),
            distribution.Normal(lo + 1.0, lo + 2.0).sample((256,)),
            distribution.Categorical(torch.arange(12.0, device=dev).reshape(2, 6) / 4).sample(
                (512,))]
    u, n, c = ((x.numpy(), y.numpy()) for x, y in zip(samples[LEAF_CARD], samples["cpu"]))
    normal_err = float(np.max(np.abs(n[0] - n[1])) / np.max(np.abs(n[1])))
    same_draws = np.array_equal(*u) and np.array_equal(*c)
    dist_ok = same_draws and normal_err <= TOL_NORMAL_SAMPLE
    dist_ms = (time.perf_counter() - t) * 1e3

    t = time.perf_counter()
    rng = np.random.default_rng(4)
    w1, w2, xv = (rng.standard_normal(s, dtype=np.float32) * np.float32(0.5)
                  for s in ((6, 8), (8, 1), (16, 6)))
    hess = {}
    for dev in (LEAF_CARD, "cpu"):
        place = paddle.CPUPlace() if dev == "cpu" else paddle.CUDAPlace(0)
        xt, a, b = (paddle.to_tensor(v, place=place) for v in (xv, w1, w2))

        def loss(a, b):
            return (paddle.tanh(paddle.matmul(xt, a)).matmul(b) ** 2).mean()

        hess[dev] = incubate_autograd.hessian(loss, [a, b])
    herr = max(_rel_err(torch, hess[LEAF_CARD][i][j].cpu(), hess["cpu"][i][j])
               for i in range(2) for j in range(2))
    hess_ms = (time.perf_counter() - t) * 1e3

    src = torch.arange(1 << 20, dtype=torch.float32, device=LEAF_CARD)
    back = utils.dlpack.from_dlpack(utils.dlpack.to_dlpack(src))
    dl_ok = back.data_ptr() == src.data_ptr() and back.device == src.device

    t = time.perf_counter()
    utils.run_check()
    check_ms = (time.perf_counter() - t) * 1e3

    tmp = tempfile.mkdtemp(prefix="paddle_tpu_torch_leaves_")
    try:
        path = os.path.join(tmp, "cube.cc")
        with open(path, "w") as f:
            f.write(CPP_OP_SRC)
        t = time.perf_counter()
        mod = utils.cpp_extension.load("leaves_cube", [path],
                                       build_directory=os.path.join(tmp, "build"))
        build_ms = (time.perf_counter() - t) * 1e3
        xg = torch.linspace(-2, 2, 1 << 20, device=LEAF_CARD).requires_grad_()
        y = mod.cube(xg)
        y.backward(torch.ones_like(y))
        xr = xg.detach().clone().requires_grad_()
        (xr * xr * xr).backward(torch.ones_like(xr))
        cpp_err = max(_rel_err(torch, y.detach(), (xr * xr * xr).detach()),
                      _rel_err(torch, xg.grad, xr.grad))
        cpp_ms = cuda_ms(torch, lambda: mod.cube(xg.detach()), iters=5, warmup=1)
        torch_ms = cuda_ms(torch, lambda: xg.detach() ** 3, iters=5, warmup=1)

        layer, (x, off, mask) = dcn["layer"], dcn["inputs"]
        utils.profiler.reset_summary()
        with utils.profiler.Profiler():
            with utils.profiler.profiler(profile_path=tmp):
                with utils.profiler.RecordEvent("deform_step"):
                    with torch.no_grad():
                        layer(x, off, mask)
        rows = {r["name"]: r for r in utils.profiler.summary(printer=None)}
        ops_rows = utils.profiler.op_summary_from_trace(tmp, top=3)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[leaves] (e) Uniform/Categorical samples card vs CPU "
        f"{'bitwise' if same_draws else 'DIFFERENT'}, Normal "
        f"{normal_err:.3g} of the max (tolerance {TOL_NORMAL_SAMPLE}), {dist_ms:.1f} ms; "
        f"hessian of an MLP loss card vs CPU {herr:.3g} (tolerance {TOL_HESSIAN}), "
        f"{hess_ms:.1f} ms; dlpack round trip of a CUDA tensor "
        f"{'the same data_ptr' if dl_ok else 'COPIED'}; run_check on the card {check_ms:.1f} "
        f"ms; cpp_extension g++ build {build_ms:.0f} ms, cube and its _grad on 2^20 CUDA "
        f"floats vs torch {cpp_err:.3g}, {cpp_ms:.3f} ms a call through the host vs "
        f"{torch_ms:.3f} ms for x ** 3 on the card; profiler summary "
        f"{sorted(rows)}, the window's top device ops "
        + ", ".join(f"{r['name'][:40]} {r['total_ms']:.3f} ms" for r in ops_rows)
        + f" [{card}]")
    if (not dist_ok or herr > TOL_HESSIAN or not dl_ok or cpp_err > 1e-6
            or rows.get("deform_step", {}).get("calls") != 1 or not ops_rows):
        fail("(e): a small leaf on the card disagrees with the CPU or its contract")
    return dict(cpp_ms=cpp_ms, torch_ms=torch_ms, check_ms=check_ms)


def phase_leaves(torch, fa, qmm, mods, card):
    """Phase 22 (module docstring): the detection ops, DCN, the flat-list
    quantized DecodeModel and the small leaves on the card."""
    (paddle, ops, LlamaModel, generation, DecodeEngine, quantization, utils, distribution,
     incubate_autograd) = mods
    t0 = time.perf_counter()
    paddle.set_device("gpu" if LEAF_CARD == "cuda" else "cpu")
    times = {}
    t = time.perf_counter()
    yolo = leaves_yolo(torch, ops, card)
    times["a"] = time.perf_counter() - t
    t = time.perf_counter()
    fpn = leaves_fpn(torch, ops, card)
    times["b"] = time.perf_counter() - t
    t = time.perf_counter()
    dcn = leaves_dcn(torch, ops, paddle, card)
    times["c"] = time.perf_counter() - t
    t = time.perf_counter()
    flat = leaves_flat_list(torch, fa, qmm, (LlamaModel, generation, DecodeEngine, quantization),
                            card)
    times["d"] = time.perf_counter() - t
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    small = leaves_small(torch, (paddle, utils, distribution, incubate_autograd), card, dcn)
    times["e"] = time.perf_counter() - t
    log(f"[leaves] phase 22: " + ", ".join(f"({k}) {v:.1f} s" for k, v in times.items())
        + f", {time.perf_counter() - t0:.1f} s in all [{card}]")
    return dict(wq_launches=flat["wq_launches"], k1_launches=flat["k1_launches"], yolo=yolo,
                fpn=fpn, dcn={k: dcn[k] for k in ("v1", "v2")}, flat=flat["modes"],
                small=small)


# ------------------------------------------------------------------ phase 23
# BERT-base pretraining (phase 5's config) by two ranks of the port's
# launcher sharing the card over gloo: each rank its half of the global
# 64 x 128 batch. (a) O0 f32 steps against the one-device step, (b) timed
# O1 bf16 steps, (c) the fleet's eager path, (d) the collectives on CUDA
# tensors, (f) the fault paths on a 2-layer model of BERT-base's width.
DP_RANKS, DP_O0_STEPS, DP_O1_STEPS, DP_EAGER_STEPS = 2, 3, 8, 3
DP_FAULT_LAYERS, DP_FAULT_BATCH, DP_FAULT_STEPS = 2, 8, 3
DP_ONE_RANK_O1_STEPS = 10
# the share of the card the parent may hold while the pods run beside
# phases 18-22 (57 of 79 GiB: phase 19 (e)'s batch 256 peaks at 38-39 GiB,
# phase 21's at 39.3; each rank at 6.7 allocated)
DP_PARENT_SHARE = 0.72
DP_KILL = "site=train.step,signum=9,at=2,rank=1"


def dp_values(torch, rank, shape=(3, 5)):
    """Rank r's operand of (d): distinct values, exact in float32."""
    return torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(shape) * (rank + 2) \
        - 5 * rank


def dp_collectives(torch, dist, p2p, rank, world):
    """(d): every op over the two ranks on CUDA tensors; each result held
    bitwise against numpy on the host and each output's device. Returns
    the failures."""
    dev = torch.device("cuda", torch.cuda.current_device())
    xs = [dp_values(torch, r).numpy() for r in range(world)]
    x = dp_values(torch, rank).to(dev)
    bad, got = [], {}

    def hold(name, out, want):
        if out.device != dev:
            bad.append(f"{name} left the card ({out.device})")
        elif not np.array_equal(out.cpu().numpy(), want):
            bad.append(f"{name} differs from numpy")
        got[name] = out

    ops = {"sum": xs[0] + xs[1], "max": np.maximum(*xs), "min": np.minimum(*xs),
           "prod": xs[0] * xs[1], "avg": (xs[0] + xs[1]) / np.float32(2)}
    for op, want in ops.items():
        hold(f"all_reduce {op}", dist.all_reduce(x.clone(), op), want)
    hold("broadcast", dist.broadcast(x.clone(), src=1), xs[1])
    for i, t in enumerate(dist.all_gather([], x)):
        hold(f"all_gather[{i}]", t, xs[i])
    t = x.clone()
    dist.reduce(t, dst=0)
    if rank == 0:
        hold("reduce", t, xs[0] + xs[1])
    t = torch.zeros(2, device=dev)
    dist.scatter(t, [torch.full((2,), 10.0 * i + 1, device=dev) for i in range(world)]
                 if rank == 0 else None, src=0)
    hold("scatter", t, np.full(2, 10.0 * rank + 1, np.float32))
    outs = dist.all_to_all([], [torch.full((2,), 100.0 * rank + j, device=dev)
                                for j in range(world)])
    for i, t in enumerate(outs):
        hold(f"all_to_all[{i}]", t, np.full(2, 100.0 * i + rank, np.float32))
    t = torch.zeros(4, 3, device=dev)
    src = [np.arange(12, dtype=np.float32).reshape(4, 3) + 100 * r for r in range(world)]
    dist.alltoall_single(t, torch.from_numpy(src[rank]).to(dev))
    hold("alltoall_single", t, np.concatenate([s[2 * rank:2 * rank + 2] for s in src]))
    dist.barrier()
    if rank == 0:
        dist.send(x * 3, dst=1)
    else:
        t = torch.zeros_like(x)
        dist.recv(t, src=0)
        hold("send/recv", t, xs[0] * 3)
    tr = p2p.get_transport()  # the p2p transport, two tags on one edge
    if rank == 0:
        tr.send("dp", 1, (x * 7).cpu().numpy(), tag=1)
        tr.send("dp", 1, (x * 8).cpu().numpy(), tag=2)
    else:
        hold("p2p tag 2", torch.from_numpy(tr.recv("dp", 0, tag=2, timeout=60)).to(dev),
             xs[0] * 8)
        hold("p2p tag 1", torch.from_numpy(tr.recv("dp", 0, tag=1, timeout=60)).to(dev),
             xs[0] * 7)
    dist.barrier()
    return bad, sorted(got)


def param_digest(torch, params):
    """Two int64 sums over each parameter's 32-bit words (plain and
    position-weighted): equal digests on two ranks say their parameters
    are equal bit for bit (a sum that collides by chance aside)."""
    out = []
    for p in params.values():
        w = p.detach().reshape(-1).view(torch.int32).long()
        out.append(torch.stack([w.sum(), (w * torch.arange(1, w.numel() + 1,
                                                           device=w.device)).sum()]))
    return torch.stack(out)


def dp_rank(argv):
    """``chip_smoke.py --dp-rank OUT``: one rank of phase 23, started by the
    port's launcher (launch_elastic). It calls chaos.arm_from_env() once
    (after ``CHIP_SMOKE_FAULT_ONCE``'s marker for this rank exists, with
    the fault spec taken out: a restarted pod is not killed again) and
    chaos.hit("train.step") before each step of the fault model, which it
    trains first; then (d), (a), (b), (c) and the fault model once more,
    phases 24 and 25, phase 27 (c) and phase 26 (c). Writes rank{r}.json (and rank 0's
    step-1 tensors) to OUT, then ends with phase 26 (b)'s consensus exit
    (143)."""
    if len(argv) != 1:
        fail("usage: chip_smoke.py --dp-rank OUT")
    out = argv[0]
    t_launch = float(os.environ["CHIP_SMOKE_DP_T0"])
    started = {"interpreter": time.time() - t_launch}
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from paddle_tpu_torch import nn, optimizer
    import paddle_tpu_torch as paddle
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.core import random as prandom
    from paddle_tpu_torch import vision
    from paddle_tpu_torch.distributed import collective, fleet, p2p, sharding, spmd, topology
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.resilience import chaos, elastic, preemption
    from paddle_tpu_torch.text.models import BertEmbeddings, BertForPretraining, LlamaModel
    from paddle_tpu_torch.distributed.meta_parallel import PipelineLayer
    from paddle_tpu_torch.incubate.moe import MoELayer
    from paddle_tpu_torch.ops import ring_attention as ra
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.inference import sharding as psharding
    from paddle_tpu_torch.inference.batching import BatchingEngine
    from paddle_tpu_torch.static import InputSpec
    from paddle_tpu_torch.text.models import BertModel

    started["imports"] = time.time() - t_launch
    env = dict(os.environ)
    once = env.get("CHIP_SMOKE_FAULT_ONCE")
    rank = int(env["PADDLE_TRAINER_ID"])
    if once:
        marker = f"{once}.{rank}"
        if os.path.exists(marker):
            env.pop("PADDLE_TPU_CHAOS", None)
        else:
            open(marker, "w").close()
    armed = chaos.arm_from_env(env)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_parallel_env()
    world = dist.get_world_size()
    mesh = topology.build_mesh(dp=world)
    started["init_parallel_env"] = time.time() - t_launch
    batch, build = bert_pretraining_parts(torch, nn, optimizer, spmd)
    res = dict(rank=rank, world=world, backend=torch.distributed.get_backend(),
               device=str(torch.device("cuda", torch.cuda.current_device())),
               armed=[f.site for f in armed], started=started)

    def local(b, vocab):
        x, y = batch(b, vocab)
        n = b // world
        return x[rank * n:(rank + 1) * n].cuda(), y[rank * n:(rank + 1) * n].cuda()

    def fault_run(progress=None):
        # the 2-layer model of BERT-base's width, dp O0 steps, the chaos
        # site before each; rank 0 appends each loss to ``progress`` (a
        # pod killed mid-run leaves its steps there)
        model = BertForPretraining(num_hidden_layers=DP_FAULT_LAYERS, hidden_dropout_prob=0.1,
                                   attention_probs_dropout_prob=0.1, device="cuda",
                                   generator=torch.Generator().manual_seed(1))
        step, init = build(model, "O0", mesh=mesh)
        params, state = init()
        x, y = local(DP_FAULT_BATCH, model.bert.vocab_size)
        losses = []
        for i in range(DP_FAULT_STEPS):
            chaos.hit("train.step")
            loss, params, state = step(params, state, x, y,
                                       key=prandom.fold_in(prandom.PRNGKey(3), i))
            losses.append(float(loss))
            if progress and rank == 0:
                with open(progress, "a") as f:
                    f.write(f"{os.getpid()} {i} {losses[-1]!r}\n")
        return losses

    # (f) first: the first pod's rank 1 dies at its second step here; the
    # restarted pod trains the fault model through, then does the rest
    t0 = time.perf_counter()
    res["fault_losses"] = fault_run(os.path.join(out, "fault_progress.txt"))
    res["fault_seconds"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    res["collectives_bad"], res["collectives"] = dp_collectives(torch, dist, p2p, rank, world)
    res["d_s"] = time.perf_counter() - t0
    model = BertForPretraining(hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1,
                               device="cuda", generator=torch.Generator().manual_seed(0))
    started["model"] = time.time() - t_launch
    n_layers = len(model.bert.encoder.layers)
    vocab = model.bert.vocab_size
    x, y = local(O1_BATCH, vocab)
    keys = [prandom.fold_in(prandom.PRNGKey(0), i) for i in range(DP_O1_STEPS)]

    # (a) O0 float32 over the dp mesh, every launch counted by form
    t0 = time.perf_counter()
    fa.launches = fa.dq_launches = fa.dkv_launches = 0
    fa.form_launches.clear()
    step, init = build(model, "O0", mesh=mesh)
    params, state = init()
    losses, digests = [], []
    for i in range(DP_O0_STEPS):
        loss, params, state = step(params, state, x, y, key=keys[i])
        losses.append(float(loss))
        digests.append(param_digest(torch, params))
        if i == 0 and rank == 0:
            torch.save(dict(grads={n: (st[0] / (1 - 0.9)).cpu() for n, st in state.items()},
                            params={n: p.cpu() for n, p in params.items()}),
                       os.path.join(out, "rank0_step1.pt"))
    digests = torch.stack(digests)
    other = dist.all_gather([], digests)
    res["a"] = dict(losses=losses, bitwise=[bool(torch.equal(other[0][i], other[1][i]))
                                            for i in range(DP_O0_STEPS)],
                    forms={" ".join(map(str, k)): v for k, v in fa.form_launches.items()},
                    counts=[fa.launches, fa.dq_launches, fa.dkv_launches], n_layers=n_layers,
                    vocab=vocab, seconds=time.perf_counter() - t0)
    counts = list(res["a"]["counts"])
    del step, init, params, state
    gc.collect()
    torch.cuda.empty_cache()

    # (b) O1 bfloat16 steps over the dp mesh, each timed by CUDA events;
    # rank 0 traces one more (the all-reduce's range and the idle share)
    t0 = time.perf_counter()
    fa.launches = fa.dq_launches = fa.dkv_launches = 0
    fa.form_launches.clear()
    step, init = build(model, "O1", mesh=mesh)
    params, state = init()
    torch.cuda.reset_peak_memory_stats()
    losses, ms = [], []
    for i in range(DP_O1_STEPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        loss, params, state = step(params, state, x, y, key=keys[i])
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
        losses.append(float(loss))
    b_forms = {" ".join(map(str, k)): v for k, v in fa.form_launches.items()}
    b_counts = [fa.launches, fa.dq_launches, fa.dkv_launches]
    peak = torch.cuda.max_memory_allocated()

    def traced():
        nonlocal params, state
        _, params, state = step(params, state, x, y, key=prandom.PRNGKey(999))

    prof = {}
    if rank == 0:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            traced()
            end.record()
            end.synchronize()
        ev_ms = start.elapsed_time(end)
        busy = sum((getattr(e, "self_device_time_total", None)
                    or getattr(e, "self_cuda_time_total", 0.0)) / 1e3
                   for e in p.key_averages()
                   if "CUDA" in str(getattr(e, "device_type", "")) and e.key not in ANNOTATIONS)
        rng = next((e for e in p.key_averages() if e.key == "build_train_step.grad_allreduce"
                    and "CUDA" not in str(getattr(e, "device_type", ""))), None)
        prof = dict(step_ms=ev_ms, busy_ms=busy,
                    allreduce_ms=None if rng is None else rng.cpu_time_total / 1e3 / rng.count)
    else:
        traced()
    res["b"] = dict(losses=losses, ms=ms, peak_bytes=peak, forms=b_forms, counts=b_counts,
                    seconds=time.perf_counter() - t0, **prof)
    counts = [a + b for a, b in zip(counts, b_counts)]
    del step, init, params, state
    gc.collect()
    torch.cuda.empty_cache()

    # (c) the fleet's eager path: DataParallel through fleet, O0, dropout 0
    t0 = time.perf_counter()
    fa.launches = fa.dq_launches = fa.dkv_launches = 0
    paddle.set_device("gpu")
    eager = BertForPretraining(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
                               device="cuda", generator=torch.Generator().manual_seed(0))
    fleet.init(is_collective=True)
    dp_model = fleet.distributed_model(eager)
    opt = fleet.distributed_optimizer(dygraph_optimizer(paddle, eager))
    ids, pos, labels = dygraph_batch(paddle, *(t.cpu() for t in (x, y)))
    eager_losses = []
    for _ in range(DP_EAGER_STEPS):
        mlm_logits, _ = dp_model(ids, masked_positions=pos)
        loss = dygraph_mlm_loss(paddle, mlm_logits, labels)
        loss.backward()
        dp_model.apply_collective_grads()
        opt.step()
        opt.clear_grad()
        both = dist.all_gather([], torch.tensor([float(loss)], device="cuda"))
        eager_losses.append(float(torch.cat(both).mean()))
    res["c"] = dict(losses=eager_losses, counts=[fa.launches, fa.dq_launches, fa.dkv_launches],
                    worker_num=fleet.worker_num(), worker_index=fleet.worker_index(),
                    mode=fleet.get_hybrid_communicate_group().get_parallel_mode(),
                    digest=param_digest(torch, dict(eager.named_parameters())).tolist(),
                    seconds=time.perf_counter() - t0)
    counts = [a + b for a, b in zip(counts, res["c"]["counts"])]
    del dp_model, eager, opt
    gc.collect()
    torch.cuda.empty_cache()

    # (f)'s fault model again, a run no fault touched
    res["unbroken_losses"] = fault_run()
    res["counts"] = counts
    gc.collect()
    torch.cuda.empty_cache()
    # phase 24 in the same pod
    res["meshed"] = meshed_rank(
        torch, (nn, optimizer, paddle, dist, spmd, topology, collective, sharding, fleet, fa,
                vision, BertEmbeddings, BertForPretraining),
        rank, out, model, x, y, keys, build, res["c"]["digest"])
    del model
    gc.collect()
    torch.cuda.empty_cache()
    # phase 25 in the same pod
    res["model_parallel"] = mp_rank(
        torch, (LlamaModel, PipelineLayer, nn, optimizer, spmd, topology, fleet, dist, prandom,
                fa, ra), rank, out)
    # phase 27 (c) in the same pod
    res["meshed_serving"] = ms_rank(torch, (BertModel, jit, InputSpec, BatchingEngine, psharding,
                                            dist, fa), rank, out)
    gc.collect()
    torch.cuda.empty_cache()
    # phase 26 in the same pod: (c), then (b), which ends the pod with the
    # consensus exit 143
    t0 = time.perf_counter()
    res["state_experts"] = se_rank(torch, (nn, optimizer, spmd, topology, dist, MoELayer), rank,
                                   out)
    res["state_experts"]["seconds"] = time.perf_counter() - t0
    dist.barrier()
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    se_elastic(torch, (nn, optimizer, spmd, topology, dist, MoELayer, chaos, elastic, preemption),
               rank, out)


def dp_kernel_cases(torch, fa):
    """K1-K3 at a rank's [32 * 12, 128, 64] with dropout 0.1 and bh_offset
    384 (rank 1), float32 and bfloat16: against the plain versions at the
    same offset, the rank's rows of the global call bitwise, and timed
    beside their bound and the library's call (a one-call profiler window
    where a 20-call window lost records: late in the script they do)."""
    F = torch.nn.functional
    gen = torch.Generator(device="cuda").manual_seed(23)
    b, h, s, d, p = O1_BATCH // DP_RANKS, 12, TRAIN_SEQ, 64, 0.1
    bh, off, scale = b * h, b * h, 64 ** -0.5
    rows = []
    for dt in ("float32", "bfloat16"):
        tdt = getattr(torch, dt)
        q, k, v, do = (torch.randn(2 * bh, s, d, device="cuda", generator=gen).to(tdt)
                       for _ in range(4))
        go, glse = fa._fwd(q, k, v, 1234, scale, False, p)
        ggrads = fa._bwd(q, k, v, go, glse, do, 1234, scale, False, p)
        ql, kl, vl, dol = (t[bh:].contiguous() for t in (q, k, v, do))
        o, lse = fa._fwd(ql, kl, vl, 1234, scale, False, p, bh_offset=off)
        grads = fa._bwd(ql, kl, vl, o, lse, dol, 1234, scale, False, p, bh_offset=off)
        torch.cuda.synchronize()
        slice_ok = (torch.equal(o, go[bh:]) and torch.equal(lse, glse[bh:])
                    and all(torch.equal(a, g[bh:]) for a, g in zip(grads, ggrads)))
        ro, rlse = fa.mha_reference(ql, kl, vl, 1234, scale, False, p, bh_offset=off)
        want = fa.mha_bwd_reference(ql, kl, vl, o, lse, dol, 1234, scale, False, p,
                                    bh_offset=off)
        err_o = (o.float() - ro.float()).abs().max().item()
        err_lse = (lse - rlse).abs().max().item()
        errs = [_rel_err(torch, g, w) for g, w in zip(grads, want)]
        abs_errs = [(g.float() - w.float()).abs().max().item() for g, w in zip(grads, want)]
        ms, dev = leaf_timed(torch, lambda: fa._fwd(ql, kl, vl, 1234, scale, False, p,
                                               bh_offset=off))
        plain_ms, plain_dev = leaf_timed(torch, lambda: fa.mha_reference(
            ql, kl, vl, 1234, scale, False, p, bh_offset=off), iters=5)
        q4, k4, v4 = (t.view(b, h, s, d) for t in (ql, kl, vl))
        lib_ms, lib_dev = leaf_timed(torch, lambda: F.scaled_dot_product_attention(
            q4, k4, v4, dropout_p=p, scale=scale))
        delta = (dol.float() * o.float()).sum(-1).contiguous()
        ptrs = [t.data_ptr() for t in (ql, kl, vl, dol, lse.view(bh, s), delta)]
        dq, dk, dv = torch.empty_like(ql), torch.empty_like(kl), torch.empty_like(vl)
        kargs = fa._kernel_args(1234, scale, False, p, ql.dtype, ql.device, off)
        dims = (bh, s, s, d)
        ms_dq, dev_dq = leaf_timed(torch, lambda: fa._launch("flash_attention_bwd_dq", *ptrs,
                                                        dq.data_ptr(), *dims, *kargs))
        ms_dkv, dev_dkv = leaf_timed(torch, lambda: fa._launch(
            "flash_attention_bwd_dkv", *ptrs, dk.data_ptr(), dv.data_ptr(), *dims, *kargs))
        bplain_ms, bplain_dev = leaf_timed(torch, lambda: fa.mha_bwd_reference(
            ql, kl, vl, o, lse, dol, 1234, scale, False, p, bh_offset=off), iters=5)
        q4g, k4g, v4g = (t.detach().requires_grad_(True) for t in (q4, k4, v4))
        out4 = F.scaled_dot_product_attention(q4g, k4g, v4g, dropout_p=p, scale=scale)
        blib_ms, blib_dev = leaf_timed(torch, lambda: torch.autograd.grad(
            out4, (q4g, k4g, v4g), dol.view_as(out4), retain_graph=True))
        bound = attention_bound_ms(bh, s, s, d, dt, False)
        bound_dq = attention_bound_ms(bh, s, s, d, dt, False, "bwd_dq")
        bound_dkv = attention_bound_ms(bh, s, s, d, dt, False, "bwd_dkv")
        ok = (slice_ok and err_o <= TOL_O[dt] and err_lse <= TOL_LSE
              and max(errs) <= TOL_GRAD[dt])
        rows.append(dict(dtype=dt, b=b, h=h, sq=s, sk=s, d=d, p=p, bh_offset=off,
                         slice_bitwise=slice_ok, max_abs_err=err_o, max_lse_err=err_lse,
                         ms=ms, device_ms=dev, plain_ms=plain_ms, plain_device_ms=plain_dev,
                         library_ms=lib_ms, library_device_ms=lib_dev, bound_ms=bound[0],
                         bound_by=bound[1], err_dq=errs[0], err_dk=errs[1], err_dv=errs[2],
                         abs_err_dq=abs_errs[0], abs_err_dkv=max(abs_errs[1:]), ms_dq=ms_dq,
                         device_ms_dq=dev_dq, ms_dkv=ms_dkv, device_ms_dkv=dev_dkv,
                         bwd_plain_ms=bplain_ms, bwd_plain_device_ms=bplain_dev,
                         bwd_library_ms=blib_ms, bwd_library_device_ms=blib_dev,
                         bound_dq=bound_dq, bound_dkv=bound_dkv, ok=ok))
        log(f"  [dp kernels] [{b} * {h}, {s}, {d}] {dt} p={p} bh_offset={off}: the global "
            f"call's rows bitwise {slice_ok}; O err {err_o:.3e} LSE err {err_lse:.3e} dq "
            f"{errs[0]:.3e} dk {errs[1]:.3e} dv {errs[2]:.3e} | K1 {ms:.4f} / {_fmt(dev)} ms"
            f"{_share(bound[0], dev)} (bound {bound[0]:.4f} {bound[1]}), plain {plain_ms:.4f}"
            f" / {_fmt(plain_dev)}, library {lib_ms:.4f} / {_fmt(lib_dev)} | K2 {ms_dq:.4f} / "
            f"{_fmt(dev_dq)} ms (bound {bound_dq[0]:.4f} {bound_dq[1]}"
            f"{_share(bound_dq[0], dev_dq)}) K3 {ms_dkv:.4f} / {_fmt(dev_dkv)} ms (bound "
            f"{bound_dkv[0]:.4f} {bound_dkv[1]}{_share(bound_dkv[0], dev_dkv)}), plain "
            f"{bplain_ms:.4f} / {_fmt(bplain_dev)}, library {blib_ms:.4f} / "
            f"{_fmt(blib_dev)} ms {'ok' if ok else 'DISAGREES'}")
    if not all(r["ok"] for r in rows):
        fail("phase 23: K1-K3 with bh_offset disagree with their plain versions or with the "
             "global call's rows")
    return rows


def dp_launch(launch_mod, out):
    """This file's --dp-rank ranks (two on card 0 over gloo) through the
    port's launch_elastic(max_restarts=1), with PADDLE_TPU_CHAOS killing
    rank 1 at its second train.step in the first pod only. Returns (what
    launch_elastic returned or the error it raised: PodPreempted, the
    restarted pod ending in phase 26 (b)'s consensus exit; the errors its
    pods' watchers raised (seen through launch_collective), seconds)."""
    # CHIP_SMOKE_DP_T0: the ranks report their start-up against it
    env = dict(CHIP_SMOKE_DP_T0=repr(time.time()), PADDLE_TPU_CHAOS=DP_KILL,
               CHIP_SMOKE_FAULT_ONCE=os.path.join(out, "fault_once"))
    grace = os.environ.get("PADDLE_TPU_ELASTIC_EXIT_GRACE")
    os.environ["PADDLE_TPU_ELASTIC_EXIT_GRACE"] = "5"
    raised, real = [], launch_mod.launch_collective

    def watched(*args, **kw):
        try:
            return real(*args, **kw)
        except RuntimeError as e:
            raised.append(e)
            raise

    launch_mod.launch_collective = watched
    t = time.perf_counter()
    try:
        got = launch_mod.launch_elastic(
            os.path.abspath(__file__), ["--dp-rank", out], nproc_per_node=DP_RANKS,
            max_restarts=1, gpus=",".join(["0"] * DP_RANKS), backend="gloo", extra_env=env,
            log_dir=os.path.join(out, "logs"))
    except RuntimeError as e:
        got = e
    finally:
        launch_mod.launch_collective = real
        if grace is None:
            os.environ.pop("PADDLE_TPU_ELASTIC_EXIT_GRACE", None)
        else:
            os.environ["PADDLE_TPU_ELASTIC_EXIT_GRACE"] = grace
    return got, raised, time.perf_counter() - t


def dp_logs(out, tail=3000):
    logs = os.path.join(out, "logs")
    text = ""
    for name in sorted(os.listdir(logs)) if os.path.isdir(logs) else ():
        with open(os.path.join(logs, name), errors="replace") as f:
            text += f"--- {name} ---\n" + f.read()[-tail:]
    return text


def dp_start(torch, fa, launch_mod):
    """Start phase 23: the pods of phases 23-26 (dp_launch, in a thread),
    then K1-K3 at the ranks' forms (dp_kernel_cases, mp_kernel_cases)
    timed while the ranks spend their first ~20 s importing on the host.
    main() calls it before phase 18, so the ranks' work (gloo traffic
    through the host, a few ms of kernels a step) runs beside phases
    18-19 instead of after phase 22; phase_dp waits for them. Returns
    what phase_dp takes as ``started``."""
    import tempfile

    t = time.perf_counter()
    out = tempfile.mkdtemp(prefix="paddle_tpu_torch_dp_")
    pods = {}
    launcher = threading.Thread(target=lambda: pods.update(
        zip(("res", "raised", "secs"), dp_launch(launch_mod, out))), daemon=True)
    launcher.start()
    cases = dp_kernel_cases(torch, fa)
    t_mp = time.perf_counter()
    mp_cases = mp_kernel_cases(torch, fa)
    times = {"phase 25's kernels": time.perf_counter() - t_mp,
             "start": time.perf_counter() - t}
    log(f"[dp] the pods of phases 23-26 started, K1-K3 at their forms timed "
        f"({times['start']:.1f} s); the ranks run beside the next phases")
    return dict(out=out, pods=pods, launcher=launcher, cases=cases, mp_cases=mp_cases,
                times=times)


def phase_dp(torch, fa, mods, card, one_rank_ms=None, started=None):
    """Phase 23 (module docstring). ``one_rank_ms``: phase 5's O1 step at
    64 x 128 in this run, printed beside (b)'s; None measures it here.
    ``started``: what dp_start returned earlier in the run; None starts
    the pods here."""
    (BertForPretraining, nn, optimizer, spmd, prandom, paddle, pdist, launch_mod, parallel,
     topology, vision, BertEmbeddings, LlamaModel) = mods
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.distributed import checkpoint, pipeline
    from paddle_tpu_torch.distributed.meta_parallel import PipelineLayer, PipelineParallel
    from paddle_tpu_torch.incubate.moe import MoELayer
    import shutil

    t_phase = time.perf_counter()
    if started is None:
        started = dp_start(torch, fa, launch_mod)
    out, pods, launcher = started["out"], started["pods"], started["launcher"]
    cases, mp_cases, times = started["cases"], started["mp_cases"], dict(started["times"])
    # the ranks ran beside the phases since dp_start; this process runs the
    # one-device references on the card, then waits for the pods
    batch, build = bert_pretraining_parts(torch, nn, optimizer, spmd)
    keys = [prandom.fold_in(prandom.PRNGKey(0), i)
            for i in range(max(DP_O1_STEPS, DP_ONE_RANK_O1_STEPS))]

    # the one-device runs the ranks are held against: (a)'s O0 steps at
    # the global batch, the one-rank O1 step beside (b)'s, (c)'s dygraph
    t = time.perf_counter()
    model = BertForPretraining(hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1,
                               device="cuda", generator=torch.Generator().manual_seed(0))
    x, y = (a.cuda() for a in batch(O1_BATCH, model.bert.vocab_size))
    step, init = build(model, "O0")
    params, state = init()
    one = dict(losses=[])
    for i in range(DP_O0_STEPS):
        loss, params, state = step(params, state, x, y, key=keys[i])
        one["losses"].append(float(loss))
        if i == 0:
            one["grads"] = {n: (st[0] / (1 - 0.9)).cpu() for n, st in state.items()}
            one["params"] = {n: p.cpu() for n, p in params.items()}
    one["final"] = {n: p.cpu() for n, p in params.items()}  # phase 24 (a)'s reference
    del step, init, params, state
    if one_rank_ms is None:
        step, init = build(model, "O1")
        params, state = init()
        one_ms = []
        for i in range(DP_ONE_RANK_O1_STEPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            _, params, state = step(params, state, x, y, key=keys[i])
            end.record()
            end.synchronize()
            one_ms.append(start.elapsed_time(end))
        one_rank_ms = _median(one_ms[1:])
        del step, init, params, state
    del model
    paddle.set_device("gpu")
    eager = BertForPretraining(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
                               device="cuda", generator=torch.Generator().manual_seed(0))
    opt = dygraph_optimizer(paddle, eager)
    one["eager"] = [float(dygraph_step(paddle, eager, opt, dygraph_batch(paddle, x.cpu(),
                                                                         y.cpu()), False))
                    for _ in range(DP_EAGER_STEPS)]
    del eager, opt
    gc.collect()
    torch.cuda.empty_cache()
    times["one device"] = time.perf_counter() - t
    t = time.perf_counter()
    refs = meshed_references(torch, (nn, optimizer, paddle, spmd, topology, vision,
                                     BertEmbeddings, batch), keys)
    times["phase 24's one device"] = time.perf_counter() - t
    t = time.perf_counter()
    mp_refs = mp_references(torch, (LlamaModel, PipelineLayer, PipelineParallel, nn, optimizer,
                                    spmd, prandom, fa))
    times["phase 25's one device"] = time.perf_counter() - t
    t = time.perf_counter()
    se_refs = se_references(torch, (nn, optimizer, spmd, topology, MoELayer), card)
    times["phase 26's one device"] = time.perf_counter() - t

    try:
        # the pods: the first killed by chaos in (f)'s fault model, the
        # restarted one through (f), (d), (a), (b), (c) and (f) unbroken
        t = time.perf_counter()
        launcher.join()
        times["waited for the pods"] = time.perf_counter() - t
        res, raised, secs = pods["res"], pods["raised"], pods["secs"]
        times["pods"] = secs
        # the restarted pod ends with phase 26 (b)'s consensus exit
        if not isinstance(res, launch_mod.PodPreempted):
            fail(f"phase 23: the two-rank pods failed: {res}\n{dp_logs(out)}")
        raised = [e for e in raised if not isinstance(e, launch_mod.PodPreempted)]
        ranks = [json.load(open(os.path.join(out, f"rank{r}.json"))) for r in range(DP_RANKS)]
        got = torch.load(os.path.join(out, "rank0_step1.pt"))
        bad = []
        for r in ranks:
            bad += [f"rank {r['rank']}: {b}" for b in r["collectives_bad"]]
            if (r["backend"], r["world"], r["device"]) != ("gloo", DP_RANKS, "cuda:0"):
                bad.append(f"rank {r['rank']} ran {r['backend']} x {r['world']} on "
                           f"{r['device']}")
        log(f"[dp] the restarted pod's ranks' start-up, s after the first pod's launch: "
            + "; ".join(f"rank {r['rank']} " + ", ".join(f"{k} {v:.1f}"
                                                          for k, v in r["started"].items())
                        for r in ranks))
        log(f"[dp] pods of {DP_RANKS} ranks on card 0 over gloo ({secs:.1f} s, both): (d) "
            f"{len(ranks[0]['collectives'])} collective results a rank bitwise numpy and on "
            f"cuda:0: {'ok' if not bad else bad} ({ranks[0]['d_s']:.2f} s) [{card}]")

        # (a) the mesh step against the one-device step
        n_layers = ranks[0]["a"]["n_layers"]
        loss_err = max(abs(a - b) / abs(b) for r in ranks
                       for a, b in zip(r["a"]["losses"], one["losses"]))
        model_max = max(g.abs().max().item() for g in one["grads"].values())
        grad_err = {}
        for n, w in one["grads"].items():
            zero = n.endswith("k_proj.bias")
            scale = model_max if zero else w.abs().max().item()
            grad_err[n] = ((got["grads"][n] - w).abs().max().item() / max(scale, 1e-30),
                           TOL_ZERO_GRAD if zero else TOL_STEP_GRAD)
        worst = max(grad_err, key=lambda n: grad_err[n][0] / grad_err[n][1])
        param_err = max((got["params"][n] - w).abs().max().item()
                        for n, w in one["params"].items())
        forms = {f"{k} 128 128 float32": n_layers * DP_O0_STEPS for k in ("fwd", "dq", "dkv")}
        log(f"[dp] (a) O0 f32 dropout 0.1, {DP_O0_STEPS} steps, each rank {O1_BATCH // DP_RANKS}"
            f" x {TRAIN_SEQ} vs one device at {O1_BATCH} x {TRAIN_SEQ}: losses "
            + " / ".join(f"rank {r['rank']} " + " ".join(f"{v:.6f}" for v in r["a"]["losses"])
                         for r in ranks)
            + " one device " + " ".join(f"{v:.6f}" for v in one["losses"])
            + f" (worst rel err {loss_err:.2e}, tolerance {TOL_STEP_LOSS}); step-1 clipped "
            f"gradients worst {grad_err[worst][0]:.2e} ({worst}; tolerance "
            f"{grad_err[worst][1]}); step-1 parameters max abs err {param_err:.3e} (tolerance "
            f"{2.5 * LR:.2e}); the ranks' parameters bitwise after each step "
            f"{ranks[0]['a']['bitwise']}; launches by form rank 0 {ranks[0]['a']['forms']} "
            f"rank 1 {ranks[1]['a']['forms']} (expected {n_layers * DP_O0_STEPS} each) "
            f"[{card}]")
        if not loss_err <= TOL_STEP_LOSS:
            bad.append("(a) losses")
        bad += [f"(a) grad {n}" for n, (e, tol) in grad_err.items() if not e <= tol]
        if not param_err <= 2.5 * LR:
            bad.append("(a) step-1 parameters")
        if not all(all(r["a"]["bitwise"]) for r in ranks):
            bad.append("(a) the ranks' parameters differ")
        if any(r["a"]["forms"] != forms for r in ranks):
            bad.append("(a) launches by form")

        # (b) the timed O1 steps
        b0 = ranks[0]["b"]
        steady = [_median(r["b"]["ms"][1:]) for r in ranks]
        one_rank = one_rank_ms
        idle = (1 - b0["busy_ms"] / b0["step_ms"]) if b0.get("busy_ms") else None
        tokens = O1_BATCH * TRAIN_SEQ
        log(f"[dp] (b) O1 bf16, {DP_O1_STEPS} steps: losses rank 0 "
            + " ".join(f"{v:.4f}" for v in b0["losses"]))
        log(f"[dp] (b) step (median of steps 2-{DP_O1_STEPS}, CUDA events): rank 0 "
            f"{steady[0]:.2f} ms, rank 1 {steady[1]:.2f} ms = {tokens / max(steady) * 1e3:.0f} "
            f"tokens/s over the pod; gradient all-reduce (gloo, {sum(g.numel() for g in one['grads'].values()) * 4 / 1e6:.0f} MB of "
            f"f32) {_fmt(b0.get('allreduce_ms'))} ms a step (rank 0's traced step, the range's "
            f"host time); rank 0's kernels {_fmt(b0.get('busy_ms'))} ms of its "
            f"{_fmt(b0.get('step_ms'))} ms traced step: idle {_fmt_pct(idle)} (the other "
            f"rank's kernels share the card); peak memory rank 0 "
            f"{ranks[0]['b']['peak_bytes'] / 2**30:.2f} GiB, rank 1 "
            f"{ranks[1]['b']['peak_bytes'] / 2**30:.2f} GiB; one rank at {O1_BATCH} x "
            f"{TRAIN_SEQ}: {one_rank:.2f} ms [{card}]")
        if not all(np.isfinite(b0["losses"])) or not b0["losses"][-1] < b0["losses"][0]:
            bad.append("(b) the O1 loss did not fall")
        forms_b = {f"{k} 128 128 bfloat16": n_layers * DP_O1_STEPS for k in ("fwd", "dq", "dkv")}
        if any(r["b"]["forms"] != forms_b for r in ranks):
            bad.append(f"(b) launches by form {[r['b']['forms'] for r in ranks]}")

        # (c) the fleet's eager path against the one-process dygraph run
        c0 = ranks[0]["c"]
        c_err = max(abs(a - b) / abs(b) for r in ranks
                    for a, b in zip(r["c"]["losses"], one["eager"]))
        log(f"[dp] (c) fleet eager O0, dropout 0, {DP_EAGER_STEPS} steps: global losses "
            + " ".join(f"{v:.6f}" for v in c0["losses"]) + " one process "
            + " ".join(f"{v:.6f}" for v in one["eager"])
            + f" (worst rel err {c_err:.2e}, tolerance {TOL_STEP_LOSS}); worker_num "
            f"{c0['worker_num']}, mode {c0['mode']}; launches K1/K2/K3 {c0['counts']} "
            f"({c0['seconds']:.1f} s) [{card}]")
        if not c_err <= TOL_STEP_LOSS or c0["mode"] != "data" or c0["worker_num"] != DP_RANKS:
            bad.append("(c) the fleet's eager path")
        if bad:
            fail(f"phase 23: {'; '.join(bad)}")
        dp_counts = [sum(r["counts"][i] for r in ranks) for i in range(3)]

        # (e) the nccl route: a one-rank group in this process
        t = time.perf_counter()
        os.environ.update(PADDLE_COORDINATOR=f"127.0.0.1:{launch_mod.find_free_port()}",
                          PADDLE_TRAINERS_NUM="1", PADDLE_TRAINER_ID="0")
        try:
            parallel.init_parallel_env(backend="nccl")
            nccl_bad = []
            xe = torch.arange(15.0, device="cuda").reshape(3, 5)
            for op in ("sum", "max", "min", "prod", "avg"):
                if not torch.equal(pdist.all_reduce(xe.clone(), op), xe):
                    nccl_bad.append(f"all_reduce {op}")
            for name, o in (("broadcast", pdist.broadcast(xe.clone())),
                            ("all_gather", pdist.all_gather([], xe)[0]),
                            ("reduce", pdist.reduce(xe.clone())),
                            ("alltoall_single", pdist.alltoall_single(torch.empty_like(xe), xe)),
                            ("psum", pdist.psum(xe, "dp"))):
                if not torch.equal(o, xe) or o.device != xe.device:
                    nccl_bad.append(name)
            lin = nn.Linear(5, 4, device="cuda")
            ddp = pdist.DataParallel(lin)
            ddp(xe).sum().backward()
            before = lin.weight.grad.clone()
            ddp.apply_collective_grads()
            if not torch.equal(lin.weight.grad, before):
                nccl_bad.append("DataParallel.apply_collective_grads")
            backend = torch.distributed.get_backend()
        finally:
            if torch.distributed.is_initialized():
                torch.distributed.destroy_process_group()
            parallel._STORE = None
            topology.set_global_mesh(None)
            for k in ("PADDLE_COORDINATOR", "PADDLE_TRAINERS_NUM", "PADDLE_TRAINER_ID"):
                os.environ.pop(k, None)
        times["e"] = time.perf_counter() - t
        log(f"[dp] (e) a one-rank {backend} group: every ReduceOp, broadcast, all_gather, "
            f"reduce, alltoall_single, psum and DataParallel.apply_collective_grads the "
            f"identity bitwise: {'ok' if not nccl_bad else nccl_bad}; destroyed "
            f"({times['e']:.1f} s) [{card}]")
        if nccl_bad or backend != "nccl":
            fail(f"phase 23 (e): the nccl route: {nccl_bad or backend}")

        # (f) the fault paths: the first pod's watcher raised once; the
        # restarted pod's fault-model losses are bitwise an unbroken run's,
        # and its first step's the killed pod's
        restarted, unbroken = ranks[0]["fault_losses"], ranks[0]["unbroken_losses"]
        with open(os.path.join(out, "fault_progress.txt")) as f:
            progress = [line.split() for line in f]
        pids = list(dict.fromkeys(p for p, _, _ in progress))
        killed = [float(v) for p, _, v in progress if p == pids[0]]
        logs = sorted(os.listdir(os.path.join(out, "logs")))
        log(f"[dp] (f) PADDLE_TPU_CHAOS={DP_KILL}: the first pod's watcher raised "
            f"{[str(e) for e in raised]} after its step(s) " + " ".join(f"{v:.6f}" for v in killed)
            + f"; launch_elastic(max_restarts=1) restarted the pod (worker logs {logs}): "
            "losses " + " ".join(f"{v:.6f}" for v in restarted) + " vs the unbroken run's "
            + " ".join(f"{v:.6f}" for v in unbroken)
            + f": bitwise {restarted == unbroken}, the killed pod's first step bitwise "
            f"{killed[:1] == restarted[:1]} [{card}]")
        if (len(raised) != 1 or len(pids) != 2 or restarted != unbroken or not killed
                or killed != restarted[:len(killed)] or len(killed) >= DP_FAULT_STEPS
                or not any(n.endswith(".r1") for n in logs)):
            fail("phase 23 (f): no single teardown, no restart, or the restarted pod's losses "
                 "are not the unbroken run's (and the killed pod's) bits")
        meshed = phase_meshed(torch, ranks, out, one, refs, card, n_layers)
        model_parallel = phase_model_parallel(torch, ranks, out, mp_refs, mp_cases, card)
        state_experts = phase_state_experts(
            torch, (nn, optimizer, spmd, topology, prandom, checkpoint, convert, pipeline,
                    LlamaModel, PipelineLayer, MoELayer, launch_mod),
            ranks, out, se_refs, res, card,
            (lambda: BertForPretraining(hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1,
                                        device="cuda", generator=torch.Generator().manual_seed(0)),
             build, x, y, keys))
        meshed_serving = ms_ranks_check(ranks, card)
    finally:
        shutil.rmtree(out, ignore_errors=True)
    times["phase"] = time.perf_counter() - t_phase
    log(f"[dp] phase 23: " + ", ".join(f"{k} {v:.1f} s" for k, v in times.items())
        + f"; rank 0's restarted pod: (f) {ranks[0]['fault_seconds']:.1f} (d) "
        f"{ranks[0]['d_s']:.1f} (a) {ranks[0]['a']['seconds']:.1f} (b) "
        f"{ranks[0]['b']['seconds']:.1f} (c) {ranks[0]['c']['seconds']:.1f} s [{card}]")
    return dict(counts=dp_counts, cases=cases, step_ms=steady, one_rank_ms=one_rank,
                allreduce_ms=b0.get("allreduce_ms"), idle=idle, meshed=meshed,
                model_parallel=model_parallel, state_experts=state_experts,
                meshed_serving=meshed_serving)


# ------------------------------------------------------------------ phase 24
# Meshed training, run by phase 23's two ranks after their phase-23 work
# (one pod: a second one costs ~20 s of imports on the card's host), on
# phase 23's BERT-base and local 32 x 128 batch: (a) ZeRO stages 0-3 on
# build_mesh(dp=1, sharding=2), (b) build_fsdp_train_step over a
# BERT-base-width Sequential, (c) the fp16 all-reduce and DGC and (d)
# LocalSGD and adaptive LocalSGD on build_mesh(dp=2), (e) ResNet-50's
# BatchNorm over the mesh, (f) group_sharded_parallel's eager ZeRO.
MESHED_STEPS, MESHED_DGC_STEPS, MESHED_LOCAL_STEPS = 3, 6, 6
MESHED_DGC_SPARSITY = 0.999
MESHED_SHARE = 0.51  # (a), (f): a rank's state (and stage 3's params at rest) of the whole
MESHED_RESNET_IMAGES = 32  # (e): 2 x 16 at RESNET_HW
TOL_MESHED_F16 = 1e-3  # (c): the fp16 exchange's losses against the f32 one's, relative
TOL_MESHED_F64 = 1e-6  # (e): float64's losses, statistics and updates against one device
MESHED_ZERO = ("zero0", "zero1", "zero2", "zero3")
# (b)'s model at BERT-base's widths
FSDP_BERT = dict(vocab=30522, hidden=768, heads=12, ffn=3072, layers=12)


def fsdp_bert(torch, nn, BertEmbeddings, seed=4):
    """(b)'s model: BERT-base's embeddings as the pre layer, 12 x
    TransformerEncoderLayer(768, 12, 3072, gelu, dropout 0.1) as the trunk,
    and a post layer that projects the first TRAIN_PRED positions of a row
    to the 30,522-word vocabulary (FSDP_BERT); weights from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    f = FSDP_BERT

    class Head(nn.Layer):
        def __init__(self):
            super().__init__()
            self.proj = nn.Linear(f["hidden"], f["vocab"], device="cuda", generator=gen)

        def forward(self, h):
            return self.proj(h[:, :TRAIN_PRED])

    return nn.Sequential(
        BertEmbeddings(f["vocab"], f["hidden"], device="cuda", generator=gen),
        *[nn.TransformerEncoderLayer(f["hidden"], f["heads"], f["ffn"], dropout=0.1,
                                     activation="gelu", device="cuda", generator=gen)
          for _ in range(f["layers"])],
        Head())


def meshed_resnet_step(torch, optimizer, spmd, model):
    """(e)'s build_train_step over ResNet-50: bench.py's loss, SGD at LR.

    ResNet-50's float32 gradients at its initial weights are noise at the
    scale of a step: two correct float32 forms of its BatchNorm (ATen's,
    and the two-pass one of the global statistics), in one process on the
    CPU, each differ from float64 by up to ~20% of a conv weight's largest
    gradient, and a float32 mesh step against one device gives a second
    loss 5e-5 apart and a third 1.8e-3 apart even at SGD 1e-4 (AdamW's
    signs, bench.py's Momentum at 0.1: worse). In float64 the mesh step's
    gradients are the one-device step's to 5e-12. So (e) holds float32's
    first step (its loss and the running statistics it leaves: the
    forward, where the global statistics act) and three float64 steps
    (forward and backward), each against one device."""
    opt = optimizer.SGD(LR, parameters=model.parameters())
    return spmd.build_train_step(model, lambda out, y: vision_loss(torch, out, y), opt)


def meshed_resnet(torch, paddle, vision, optimizer, spmd, x, y, steps, dtype):
    """``steps`` of ResNet-50 (seed 0) in ``dtype`` on ``x``: the losses,
    the parameters before and after them and the running statistics
    after the first and the last, on the host."""
    paddle.seed(0)
    model = torch.nn.Module.to(vision.models.resnet50(), dtype)  # (a Layer's ``to`` is Paddle's)
    model.train()
    first = {n: p.detach().cpu().clone() for n, p in model.named_parameters()}
    step, init = meshed_resnet_step(torch, optimizer, spmd, model)
    params, state = init()
    losses, ms = [], []
    for i in range(steps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        loss, params, state = step(params, state, x.to(dtype), y)
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
        losses.append(float(loss))
        if i == 0:
            buffers1 = {n: b.cpu() for n, b in model.named_buffers()}
    return dict(losses=losses, ms=ms, start=first, params={n: p.cpu() for n, p in params.items()},
                buffers1=buffers1, buffers={n: b.cpu() for n, b in model.named_buffers()})


def tree_bytes(tree):
    """Bytes of the tensors of a {name: tensor or tuple of tensors} tree."""
    return sum(t.numel() * t.element_size() for v in tree.values()
               for t in (v if isinstance(v, tuple) else (v,)))


def gather_whole(collective, params, dims, group):
    """The whole parameters of a step whose ``dims[name]`` says where each
    is split over ``group`` (None: whole already)."""
    split = [n for n, p in params.items() if dims.get(n) is not None]
    whole = dict(params)
    for n, t in zip(split, collective.coalesced_all_gather(
            [params[n] for n in split], [dims[n] for n in split], group)):
        whole[n] = t
    return whole


def meshed_rank(torch, mods, rank, out, model, x, y, keys, build, eager_digest):
    """Phase 24's modes in one of phase 23's ranks. Returns {mode: what
    the parent checks}; rank 0 saves the whole parameters of (a)'s stages
    1-3, (b) and (e) (and (e)'s buffers) to OUT for it."""
    (nn, optimizer, paddle, pdist, spmd, topology, collective, sharding, fleet, fa, vision,
     BertEmbeddings, BertForPretraining) = mods
    res = {}

    def counted(name, run):
        fa.launches = fa.dq_launches = fa.dkv_launches = 0
        fa.form_launches.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        got = run()
        torch.cuda.synchronize()
        got.update(counts=[fa.launches, fa.dq_launches, fa.dkv_launches],
                   forms={" ".join(map(str, k)): v for k, v in fa.form_launches.items()},
                   peak_bytes=torch.cuda.max_memory_allocated(),
                   seconds=time.perf_counter() - t0)
        res[name] = got
        gc.collect()
        torch.cuda.empty_cache()

    def steps(step, params, state, n, xs, ys, digest=None, save=None):
        """``n`` steps, each timed by CUDA events; the losses, the ms, the
        ranks' digests (``digest(params, state)``) all-gathered each step;
        ``save``: (tag, k), phase 26 (a)'s checkpoint of the state k steps in."""
        got = dict(losses=[], ms=[], digests=[])
        for i in range(n):
            if save is not None and i == save[1]:
                got["ckpt"] = se_save(torch, out, save[0], step, params, state, i, rank)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            loss, params, state = step(params, state, xs, ys, key=keys[i])
            end.record()
            end.synchronize()
            got["ms"].append(start.elapsed_time(end))
            got["losses"].append(float(loss))
            if digest is not None:
                mine = digest(params, state)
                got["digests"].append([d.tolist() for d in pdist.all_gather([], mine)])
        return got, params, state

    def same(digests):
        return [bool(d[0] == d[1]) for d in digests]

    # (a) ZeRO 0-3 on build_mesh(dp=1, sharding=2): the ranks' whole
    # parameters bitwise each step, stage 1 bitwise stage 0
    mesh_z = topology.build_mesh(dp=1, sharding=2)
    group_z = spmd.DataGroup(mesh_z).group
    for stage in range(4):
        def run(stage=stage):
            step, init = build(model, "O0", mesh=mesh_z, sharding_stage=stage)
            params, state = init()
            sizes = [tree_bytes(params), tree_bytes(state)]
            at_rest = step.zero_dims if stage == 3 else {}  # stage 3 keeps the blocks

            def digest(params, state):
                return param_digest(torch, gather_whole(collective, params, at_rest, group_z))
            # phase 26 (a): stages 1 and 2 save their state before the last step
            save = (f"zero{stage}", MESHED_STEPS - 1) if stage in (1, 2) else None
            got, params, state = steps(step, params, state, MESHED_STEPS, x, y, digest, save)
            if stage >= 1:
                whole = gather_whole(collective, params, at_rest, group_z)
                if rank == 0:
                    torch.save({n: p.cpu() for n, p in whole.items()},
                               os.path.join(out, f"zero{stage}.pt"))
                del whole
            got.update(bytes=sizes, ranks_bitwise=same(got["digests"]),
                       mine=[d[rank] for d in got["digests"]], sharded=sum(
                           d is not None for d in step.zero_dims.values()))
            return got
        counted(f"zero{stage}", run)
    res["zero1"]["stage0_bitwise"] = res["zero1"]["mine"] == res["zero0"]["mine"]

    # (b) FSDP over the BERT-base-width Sequential, one gathered trunk
    # layer at a time (recompute)
    def run_fsdp():
        fmodel = fsdp_bert(torch, nn, BertEmbeddings)
        opt = optimizer.AdamW(LR, parameters=fmodel.parameters(), weight_decay=0.01,
                              grad_clip=nn.ClipGradByGlobalNorm(1.0))
        step, init = spmd.build_fsdp_train_step(
            fmodel, lambda out, t: vision_loss(torch, out, t), opt,
            mesh=topology.build_mesh(dp=2))
        params, state = init()
        group = spmd.DataGroup(topology.build_mesh(dp=2)).group
        xf = x[:, :TRAIN_SEQ].contiguous()
        got = dict(losses=[], ms=[], peaks=[])
        for i in range(MESHED_STEPS):
            step.tracker.reset()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            loss, params, state = step(params, state, xf, y, key=keys[i])
            end.record()
            end.synchronize()
            got["ms"].append(start.elapsed_time(end))
            got["losses"].append(float(loss))
            got["peaks"].append(step.tracker.peak)
        got["alive_after"] = step.tracker.alive
        got["gathers"] = step.tracker.gathers
        whole = gather_whole(collective, params, step.shard_dims, group)
        if rank == 0:
            torch.save({n: p.cpu() for n, p in whole.items()}, os.path.join(out, "fsdp.pt"))
        got["bytes"] = [tree_bytes(params), tree_bytes(state)]
        return got
    counted("fsdp", run_fsdp)

    # (c) fp16 all-reduce, the f32 exchange it is held against (DGC at
    # sparsity 0 sends every gradient whole), DGC at 0.999; the ranks'
    # parameters bitwise each step, their (u, v) not
    mesh_d = topology.build_mesh(dp=2)
    for name, amp, n, kw in (("fp16", "O0", MESHED_STEPS, dict(fp16_allreduce=True)),
                             ("f32_local", "O0", MESHED_STEPS, dict(dgc_configs={
                                 "sparsity": [0.0]})),
                             ("dgc", "O1", MESHED_DGC_STEPS, dict(dgc_configs={
                                 "sparsity": [MESHED_DGC_SPARSITY]}))):
        def run(amp=amp, n=n, kw=kw):
            step, init = build(model, amp, mesh=mesh_d, **kw)
            params, state = init()
            got, params, state = steps(step, params, state, n, x, y,
                                       lambda p, s: param_digest(torch, p))
            got.update(ranks_bitwise=same(got["digests"]), comm_bytes=dict(step.comm_stats))
            if "__comm__" in state:
                uv = param_digest(torch, {f"{k}/{i}": t for k, pair in state["__comm__"].items()
                                          for i, t in enumerate(pair)})
                both = pdist.all_gather([], uv)
                got["uv_differ"] = not torch.equal(both[0], both[1])
            return got
        counted(name, run)
    if rank == 0:  # dgc_sparsify on the card against its CPU run, bitwise
        from paddle_tpu_torch.distributed import comm_opt

        gen = torch.Generator(device="cuda").manual_seed(24)
        g, u, v = (torch.randn(FSDP_BERT["vocab"], FSDP_BERT["hidden"], device="cuda",
                               generator=gen) for _ in range(3))
        on_card = comm_opt.dgc_sparsify(g, u, v, 0.9, MESHED_DGC_SPARSITY)
        on_cpu = comm_opt.dgc_sparsify(g.cpu(), u.cpu(), v.cpu(), 0.9, MESHED_DGC_SPARSITY)
        res["dgc"]["sparsify_bitwise"] = all(torch.equal(a.cpu(), b)
                                             for a, b in zip(on_card, on_cpu))
        del g, u, v, on_card, on_cpu

    # (d) LocalSGD (k_steps 2) and adaptive LocalSGD (init_k_steps 2,
    # begin_step 2), O1: the replicas' digests each step, and adaptive's
    # k and last sync step
    for name, knobs in (("localsgd", dict(localsgd=True, localsgd_configs={"k_steps": 2})),
                        ("adaptive", dict(adaptive_localsgd=True, adaptive_localsgd_configs={
                            "init_k_steps": 2, "begin_step": 2}))):
        def run(knobs=knobs, name=name):
            s = fleet.DistributedStrategy()
            for k, v in knobs.items():
                setattr(s, k, v)
            step, init = build(model, "O1", mesh=mesh_d, strategy=s)
            params, state = init()
            ks, lasts = [], []

            def digest(p, st):
                if name == "adaptive":
                    ks.append(int(step.comm_state["comm"]["k"]))
                    lasts.append(int(step.comm_state["comm"]["last"]))
                return param_digest(torch, p)
            got, params, state = steps(step, params, state, MESHED_LOCAL_STEPS, x, y, digest)
            got.update(ranks_bitwise=same(got["digests"]), k=ks, last=lasts)
            return got
        counted(name, run)

    # (e) ResNet-50 over the mesh (the global mesh: dp over both ranks),
    # BatchNorm on the global batch's statistics
    def run_resnet():
        xr, yr = vision_data(torch, MESHED_RESNET_IMAGES, RESNET_HW, RESNET_CLASSES)
        b = MESHED_RESNET_IMAGES // 2
        xr, yr = xr[rank * b:(rank + 1) * b].cuda(), yr[rank * b:(rank + 1) * b].cuda()
        got = {}
        for dtype in (torch.float32, torch.float64):
            run = meshed_resnet(torch, paddle, vision, optimizer, spmd, xr, yr, MESHED_STEPS,
                                dtype)
            digests = pdist.all_gather([], param_digest(torch, run["params"]))
            tag = str(dtype)[6:]
            got[tag] = dict(losses=run["losses"], ms=run["ms"],
                            ranks_bitwise=torch.equal(digests[0], digests[1]))
            if rank == 0:
                torch.save({k: run[k] for k in ("params", "buffers", "buffers1")},
                           os.path.join(out, f"resnet_{tag}.pt"))
        got["ms"] = got["float32"]["ms"]
        return got
    counted("resnet", run_resnet)

    # (f) group_sharded_parallel('os_g') under eager DataParallel: phase
    # 23 (c)'s three dygraph steps, the parameters bitwise its
    def run_eager():
        paddle.set_device("gpu")
        eager = BertForPretraining(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
                                   device="cuda", generator=torch.Generator().manual_seed(0))
        ddp = pdist.DataParallel(eager)
        opt = dygraph_optimizer(paddle, eager)
        ddp, opt, _ = sharding.group_sharded_parallel(ddp, opt, level="os_g")
        ids, pos, labels = dygraph_batch(paddle, x.cpu(), y.cpu())
        got = dict(losses=[], ms=[])
        for _ in range(DP_EAGER_STEPS):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            mlm_logits, _ = ddp(ids, masked_positions=pos)
            loss = dygraph_mlm_loss(paddle, mlm_logits, labels)
            loss.backward()
            ddp.apply_collective_grads()
            opt.step()
            opt.clear_grad()
            end.record()
            end.synchronize()
            got["ms"].append(start.elapsed_time(end))
            got["losses"].append(float(loss))
        named = dict(eager.named_parameters())
        got["bitwise_unsharded"] = param_digest(torch, named).tolist() == eager_digest
        held = sum(a.numel() * a.element_size() for st in opt._accumulators.values() for a in st)
        whole = sum((p.numel() if a.dim() else 1) * a.element_size() for p in named.values()
                    for a in opt._accumulators.get(id(p), ()))
        got["acc_bytes"] = [held, whole]
        return got
    counted("eager", run_eager)
    return res


def meshed_references(torch, mods, keys):
    """The one-device runs phase 24 holds the ranks against, made in the
    parent while the pods run: (b)'s model by one process at 64 x 128,
    (e)'s ResNet-50 at 32 images. (a)'s is phase 23's one-device run."""
    nn, optimizer, paddle, spmd, topology, vision, BertEmbeddings, batch = mods
    refs = {}
    x, y = (a.cuda() for a in batch(O1_BATCH, FSDP_BERT["vocab"]))
    fmodel = fsdp_bert(torch, nn, BertEmbeddings)
    opt = optimizer.AdamW(LR, parameters=fmodel.parameters(), weight_decay=0.01,
                          grad_clip=nn.ClipGradByGlobalNorm(1.0))
    step, init = spmd.build_fsdp_train_step(fmodel, lambda out, t: vision_loss(torch, out, t),
                                            opt, mesh=topology.Mesh((1,) * 6))
    params, state = init()
    torch.cuda.reset_peak_memory_stats()
    losses = []
    for i in range(MESHED_STEPS):
        loss, params, state = step(params, state, x[:, :TRAIN_SEQ].contiguous(), y, key=keys[i])
        losses.append(float(loss))
    refs["fsdp"] = dict(losses=losses, params={n: p.cpu() for n, p in params.items()},
                        peak_bytes=torch.cuda.max_memory_allocated())
    del fmodel, opt, step, init, params, state
    xr, yr = (a.cuda() for a in vision_data(torch, MESHED_RESNET_IMAGES, RESNET_HW,
                                             RESNET_CLASSES))
    refs["resnet"] = {str(dtype)[6:]: meshed_resnet(torch, paddle, vision, optimizer, spmd, xr,
                                                    yr, MESHED_STEPS, dtype)
                      for dtype in (torch.float32, torch.float64)}
    gc.collect()
    torch.cuda.empty_cache()
    return refs


def _worst_abs(got, want):
    return max((got[n].float() - w.float()).abs().max().item() for n, w in want.items())


def phase_meshed(torch, ranks, out, one, refs, card, n_layers):
    """Phase 24's checks on what the ranks wrote (module docstring)."""
    t0 = time.perf_counter()
    bad = []
    r0 = ranks[0]["meshed"]
    f32 = {f"{k} 128 128 float32": n_layers * MESHED_STEPS for k in ("fwd", "dq", "dkv")}
    bf16 = {f"{k} 128 128 bfloat16": n_layers * MESHED_DGC_STEPS for k in ("fwd", "dq", "dkv")}
    expect = {m: f32 for m in (*MESHED_ZERO, "fp16", "f32_local", "eager")}
    fsdp = {k: v * FSDP_BERT["layers"] // n_layers for k, v in f32.items()}
    fsdp["fwd 128 128 float32"] *= 2  # recompute: each layer's forward again in the backward
    expect.update(dgc=bf16, localsgd=bf16, adaptive=bf16, resnet={}, fsdp=fsdp)
    for mode, forms in expect.items():
        for r in ranks:
            if r["meshed"][mode]["forms"] != forms:
                bad.append(f"{mode}: rank {r['rank']} launched {r['meshed'][mode]['forms']}, "
                           f"expected {forms}")

    def rel(a, b):
        return max(abs(u - v) / abs(v) for u, v in zip(a, b))

    def ms(mode):
        return " / ".join(f"{_median(r['meshed'][mode]['ms']):.1f}" for r in ranks)

    # (a)
    s0 = r0["zero0"]
    for stage, mode in enumerate(MESHED_ZERO):
        m = [r["meshed"][mode] for r in ranks]
        loss_err = max(rel(g["losses"], one["losses"]) for g in m)
        perr = _worst_abs(torch.load(os.path.join(out, f"zero{max(stage, 1)}.pt")), one["final"])
        state_share = max(g["bytes"][1] / s0["bytes"][1] for g in m)
        param_share = max(g["bytes"][0] / s0["bytes"][0] for g in m)
        log(f"[meshed] (a) ZeRO stage {stage} on dp=1 x sharding=2, O0 f32, {MESHED_STEPS} "
            f"steps a rank at 32 x {TRAIN_SEQ}: losses " + " ".join(f"{v:.6f}" for v in m[0]["losses"])
            + f" (worst rel err vs one device {loss_err:.2e}, tolerance {TOL_STEP_LOSS}); "
            f"parameters max abs err {perr:.3e} (tolerance {2.5 * LR:.2e}); the ranks bitwise "
            f"{m[0]['ranks_bitwise']}" + (f"; bitwise stage 0 {m[0]['stage0_bitwise']}"
                                          if stage == 1 else "")
            + f"; {m[0]['sharded']} of the tensors sharded; state {state_share:.3f} and params "
            f"at rest {param_share:.3f} of stage 0's a rank; peak "
            + " / ".join(f"{g['peak_bytes'] / 2**30:.2f}" for g in m) + " GiB (stage 0 "
            + " / ".join(f"{r['meshed']['zero0']['peak_bytes'] / 2**30:.2f}" for r in ranks)
            + f"); step ms a rank {ms(mode)}; K1/K2/K3 a rank {m[0]['counts']} [{card}]")
        if not loss_err <= TOL_STEP_LOSS or not perr <= 2.5 * LR:
            bad.append(f"(a) stage {stage} against one device")
        if not all(all(g["ranks_bitwise"]) for g in m):
            bad.append(f"(a) stage {stage}: the ranks' parameters differ")
        if stage >= 1 and not state_share <= MESHED_SHARE:
            bad.append(f"(a) stage {stage}: state {state_share:.3f} of the whole")
        if stage == 3 and not param_share <= MESHED_SHARE:
            bad.append(f"(a) stage 3: params at rest {param_share:.3f} of the whole")
    if not all(r["meshed"]["zero1"]["stage0_bitwise"] for r in ranks):
        bad.append("(a) stage 1 is not bitwise stage 0")

    # (b)
    m = [r["meshed"]["fsdp"] for r in ranks]
    ref = refs["fsdp"]
    loss_err = max(rel(g["losses"], ref["losses"]) for g in m)
    perr = _worst_abs(torch.load(os.path.join(out, "fsdp.pt")), ref["params"])
    log(f"[meshed] (b) build_fsdp_train_step, BERT-base width (embeddings, 12 encoder layers, a "
        f"{TRAIN_PRED}-position vocabulary head), O0 f32, recompute: losses "
        + " ".join(f"{v:.6f}" for v in m[0]["losses"]) + f" (worst rel err vs one process "
        f"{loss_err:.2e}); parameters max abs err {perr:.3e} (tolerance {2.5 * LR:.2e}); gathered "
        f"trunk layers alive at most {[g['peaks'] for g in m]} a step, {m[0]['alive_after']} "
        f"after, {m[0]['gathers']} gathers in the last step; peak "
        + " / ".join(f"{g['peak_bytes'] / 2**30:.2f}" for g in m) + f" GiB a rank (ZeRO stage "
        f"0's " + " / ".join(f"{r['meshed']['zero0']['peak_bytes'] / 2**30:.2f}" for r in ranks)
        + f"; one process at 64 x 128 {ref['peak_bytes'] / 2**30:.2f}); step ms a rank "
        f"{ms('fsdp')}; K1/K2/K3 a rank {m[0]['counts']} [{card}]")
    if not loss_err <= TOL_STEP_LOSS or not perr <= 2.5 * LR:
        bad.append("(b) against one process")
    if any(max(g["peaks"]) != 1 or g["alive_after"] != 0 for g in m):
        bad.append("(b) more than one gathered trunk layer alive")
    if not all(g["peak_bytes"] < r["meshed"]["zero0"]["peak_bytes"]
               for g, r in zip(m, ranks)):
        bad.append("(b) the rank's peak is not below stage 0's")

    # (c)
    fp16, f32l, dgc = ([r["meshed"][k] for r in ranks] for k in ("fp16", "f32_local", "dgc"))
    f16_err = rel(fp16[0]["losses"], f32l[0]["losses"])
    n_params = sum(p.numel() for p in one["final"].values())
    log(f"[meshed] (c) fp16 all-reduce, O0, {MESHED_STEPS} steps: losses "
        + " ".join(f"{v:.6f}" for v in fp16[0]["losses"]) + " vs the f32 exchange's "
        + " ".join(f"{v:.6f}" for v in f32l[0]["losses"]) + f" (worst rel err {f16_err:.2e}, "
        f"tolerance {TOL_MESHED_F16}) and the global mesh step's (phase 23 (a)) "
        + " ".join(f"{v:.6f}" for v in one["losses"]) + f"; all-reduced bytes a step "
        f"{fp16[0]['comm_bytes']} ({n_params:,} parameters); step ms a rank {ms('fp16')} (f32 "
        f"exchange {ms('f32_local')}); the ranks bitwise {fp16[0]['ranks_bitwise']} [{card}]")
    log(f"[meshed] (c) DGC sparsity {MESHED_DGC_SPARSITY}, O1, {MESHED_DGC_STEPS} steps: "
        "losses " + " ".join(f"{v:.4f}" for v in dgc[0]["losses"]) + f"; the ranks' parameters "
        f"bitwise {dgc[0]['ranks_bitwise']}, their (u, v) differ {dgc[0]['uv_differ']}; "
        f"dgc_sparsify on the card bitwise its CPU run {dgc[0].get('sparsify_bitwise')}; "
        f"step ms a rank {ms('dgc')} [{card}]")
    if not f16_err <= TOL_MESHED_F16:
        bad.append("(c) fp16 losses")
    if (fp16[0]["comm_bytes"].get("float16") != 2 * n_params
            or set(fp16[0]["comm_bytes"]) != {"float16", "float32"}):
        bad.append(f"(c) the fp16 all-reduce moved {fp16[0]['comm_bytes']}")
    for mode, m in (("fp16", fp16), ("f32_local", f32l), ("dgc", dgc)):
        if not all(all(g["ranks_bitwise"]) for g in m):
            bad.append(f"(c) {mode}: the ranks' parameters differ")
    if not all(g["uv_differ"] for g in dgc) or not dgc[0].get("sparsify_bitwise"):
        bad.append("(c) DGC's (u, v) or dgc_sparsify")
    if not dgc[0]["losses"][-1] < dgc[0]["losses"][0]:
        bad.append("(c) the DGC loss did not fall")

    # (d)
    for mode in ("localsgd", "adaptive"):
        m = r0[mode]
        synced = ([i % 2 == 1 for i in range(MESHED_LOCAL_STEPS)] if mode == "localsgd"
                  else [last == i + 1 for i, last in enumerate(m["last"])])
        log(f"[meshed] (d) {mode}, O1, {MESHED_LOCAL_STEPS} steps: losses "
            + " ".join(f"{v:.4f}" for v in m["losses"]) + f"; synced {synced}, the replicas "
            f"bitwise {m['ranks_bitwise']}" + (f"; k {m['k']}, last sync {m['last']}"
                                               if mode == "adaptive" else "")
            + f"; step ms a rank {ms(mode)} [{card}]")
        if m["ranks_bitwise"] != synced or not any(synced) or all(synced):
            bad.append(f"(d) {mode}: the replicas are not equal exactly after each sync")
        if not m["losses"][-1] < m["losses"][0]:
            bad.append(f"(d) {mode}: the loss did not fall")

    # (e)
    def stats_err(got, want):
        return max((got[n] - w).abs().max().item() / max(w.abs().max().item(), 1e-30)
                   for n, w in want.items())

    for tag in ("float32", "float64"):
        m = [r["meshed"]["resnet"][tag] for r in ranks]
        ref = refs["resnet"][tag]
        got = torch.load(os.path.join(out, f"resnet_{tag}.pt"))
        errs = [max(abs(g["losses"][i] - ref["losses"][i]) / abs(ref["losses"][i]) for g in m)
                for i in range(MESHED_STEPS)]
        stat1, stat = stats_err(got["buffers1"], ref["buffers1"]), stats_err(got["buffers"],
                                                                             ref["buffers"])
        perr = _worst_abs(got["params"], ref["params"])
        upd = max(((got["params"][n] - w).abs().max()
                   / (w - ref["start"][n]).abs().max().clamp_min(1e-300)).item()
                  for n, w in ref["params"].items())
        if tag == "float32":  # the first step: the forward's loss and statistics
            ok = errs[0] <= TOL_STEP_LOSS and stat1 <= TOL_BN_STATS
            held = (f"held: step 1's loss ({TOL_STEP_LOSS}) and running statistics "
                    f"({TOL_BN_STATS} of their max)")
        else:  # every step, forward and backward
            ok = (max(errs) <= TOL_MESHED_F64 and stat <= TOL_MESHED_F64
                  and upd <= TOL_MESHED_F64 and perr <= 2.5 * LR)
            held = f"held: all, to {TOL_MESHED_F64} (parameters to 2.5 lr too)"
        log(f"[meshed] (e) ResNet-50 over the mesh, 2 x {MESHED_RESNET_IMAGES // 2} images at "
            f"{RESNET_HW}, O0 {tag}, SGD at {LR}, {MESHED_STEPS} steps: losses "
            + " ".join(f"{v:.6f}" for v in m[0]["losses"]) + " (rel err vs one device at "
            f"{MESHED_RESNET_IMAGES}: " + " ".join(f"{e:.2e}" for e in errs) + "); running "
            f"statistics after step 1 {stat1:.2e}, after step {MESHED_STEPS} {stat:.2e} of their "
            f"max; parameters max abs err {perr:.3e}, the updates' worst {upd:.2e} of their "
            f"max; {held}; the ranks bitwise {[g['ranks_bitwise'] for g in m]}; step ms a rank "
            + " / ".join(f"{_median(g['ms']):.1f}" for g in m) + f" [{card}]")
        if not ok:
            bad.append(f"(e) {tag} against one device")
        if not all(g["ranks_bitwise"] for g in m):
            bad.append(f"(e) {tag}: the ranks' parameters differ")

    # (f)
    m = [r["meshed"]["eager"] for r in ranks]
    share = max(g["acc_bytes"][0] / g["acc_bytes"][1] for g in m)
    log(f"[meshed] (f) group_sharded_parallel('os_g') with DataParallel, {DP_EAGER_STEPS} "
        f"dygraph O0 steps at dropout 0: losses " + " ".join(f"{v:.6f}" for v in m[0]["losses"])
        + f"; parameters bitwise the unsharded run's (phase 23 (c)) "
        f"{[g['bitwise_unsharded'] for g in m]}; accumulators {share:.3f} of the whole a rank; "
        f"step ms a rank {ms('eager')} [{card}]")
    if not all(g["bitwise_unsharded"] for g in m) or not share <= MESHED_SHARE:
        bad.append("(f) the eager ZeRO step")
    if bad:
        fail(f"phase 24: {'; '.join(bad)}")
    counts = [sum(r["meshed"][mode]["counts"][i] for r in ranks for mode in expect)
              for i in range(3)]
    secs = {mode: max(r["meshed"][mode]["seconds"] for r in ranks) for mode in expect}
    log(f"[meshed] phase 24: the ranks' modes " + ", ".join(f"{k} {v:.1f}"
                                                             for k, v in secs.items())
        + f" s ({sum(secs.values()):.1f} s), the checks {time.perf_counter() - t0:.1f} s; "
        f"K1/K2/K3 over both ranks {counts} [{card}]")
    return dict(counts=counts, seconds=sum(secs.values()) + time.perf_counter() - t0)


# ------------------------------------------------------------------ phase 25
# Model parallel, run by phase 23's two ranks after phase 24's modes (the
# same pod), with Llama-374M's width (bench.py:192) at MP_CFG's depth: (a)
# tensor parallel over build_mesh(mp=2), (b) fleet's pipe mode over pp=2,
# (c) ring attention over build_mesh(sp=2). The one-device references are
# computed in this process while the pods run.
MP_CFG = dict(vocab_size=32000, hidden_size=1024, num_layers=4, num_heads=8,
              intermediate_size=2816, max_seq_len=512)
MP_SEQ, MP_TP_BATCH, MP_PP_BATCH, MP_MICRO, MP_STEPS = 512, 2, 4, 4, 3
MP_RING = (2, 8, 2048, 128)  # (c): the global [B, H, S, D], causal
MP_RING_CALLS = 3
MP_RTOL, MP_ATOL = 2e-4, 2e-5  # the reference's own mp/pp tolerance (test_llama_hybrid.py)
# (a) and (b) also take one SGD step (no clip) from the same weights: its
# update is lr times the gradient, which AdamW's step (m / sqrt(v), clipped
# by the global norm) does not scale with; held per tensor relative to the
# one-device gradient's max, as phases 5 and 23 hold theirs. lr 1e4 makes
# the update outweigh the weights' rounding: the embedding's gradient is at
# most ~1e-4 beside weights up to ~5 (drawn with std 1), so at lr 1 the
# weights' ulp alone reads up to ~7e-3 of it
MP_SGD_LR = 1e4
TOL_RING = {"float32": 1e-5, "bfloat16": TOL_O["bfloat16"]}


def mp_llama(torch, LlamaModel, tensor_parallel):
    return LlamaModel(**MP_CFG, tensor_parallel=tensor_parallel, device="cuda",
                      generator=torch.Generator().manual_seed(25))


def mp_batch(torch, b):
    g = torch.Generator().manual_seed(250 + b)
    return tuple(torch.randint(0, MP_CFG["vocab_size"], (b, MP_SEQ), generator=g).cuda()
                 for _ in range(2))


def mp_loss(torch, logits, labels):
    return torch.nn.functional.cross_entropy(logits.float().reshape(-1, logits.shape[-1]),
                                             labels.reshape(-1).long())


def mp_pipe_model(torch, LlamaModel, PipelineLayer, nn):
    """A PipelineLayer of (a)'s plain model: the embedding, the decoder
    layers, the norm and head."""
    m = mp_llama(torch, LlamaModel, False)
    return PipelineLayer([m.embed_tokens, *m.layers, nn.Sequential(m.norm, m.lm_head)],
                         num_stages=2, loss_fn=lambda out, y: mp_loss(torch, out, y))


def mp_strategy(fleet):
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"pp_degree": 2}
    strategy.pipeline_configs = {"accumulate_steps": MP_MICRO}
    return strategy


def mp_ring_data(torch):
    g = torch.Generator(device="cuda").manual_seed(26)
    return [torch.randn(MP_RING, device="cuda", generator=g) for _ in range(4)]  # q k v dO


def mp_kernel_cases(torch, fa):
    """K1-K3 at the forms phase 25 gives them: (a)'s head group ([2 * 4,
    512, 512, 128] causal float32: 4 heads a rank), (b)'s stage
    ([1 * 8, 512, 512, 128] causal float32: a microbatch), and (c)'s ring
    blocks ([2 * 8, 1024, 1024, 128], the causal diagonal and an unmasked
    earlier block, float32 and bfloat16): against their plain versions,
    timed beside their bound and sdpa's time."""
    F = torch.nn.functional
    gen = torch.Generator(device="cuda").manual_seed(25)
    forms = [("tp", 2, 4, 512, True, "float32"), ("pp", 1, 8, 512, True, "float32")]
    forms += [(f"ring_{n}", 2, 8, 1024, c, dt) for dt in ("float32", "bfloat16")
              for n, c in (("diag", True), ("block", False))]
    rows = []
    for name, b, h, s, causal, dt in forms:
        d, scale = 128, 128 ** -0.5
        bh = b * h
        q, k, v, do = (torch.randn(bh, s, d, device="cuda", generator=gen).to(getattr(torch, dt))
                       for _ in range(4))
        o, lse = fa._fwd(q, k, v, 0, scale, causal, 0.0)
        grads = fa._bwd(q, k, v, o, lse, do, 0, scale, causal, 0.0)
        ro, rlse = fa.mha_reference(q, k, v, 0, scale, causal, 0.0)
        want = fa.mha_bwd_reference(q, k, v, o, lse, do, 0, scale, causal, 0.0)
        err_o = (o.float() - ro.float()).abs().max().item()
        err_lse = (lse - rlse).abs().max().item()
        errs = [_rel_err(torch, g, w) for g, w in zip(grads, want)]
        abs_errs = [(g.float() - w.float()).abs().max().item() for g, w in zip(grads, want)]
        ms, dev = leaf_timed(torch, lambda: fa._fwd(q, k, v, 0, scale, causal, 0.0))
        plain_ms, plain_dev = leaf_timed(torch, lambda: fa.mha_reference(
            q, k, v, 0, scale, causal, 0.0), iters=3)
        q4, k4, v4 = (t.view(b, h, s, d) for t in (q, k, v))
        lib_ms, lib_dev = leaf_timed(torch, lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=causal, scale=scale))
        delta = (do.float() * o.float()).sum(-1).contiguous()
        ptrs = [t.data_ptr() for t in (q, k, v, do, lse.view(bh, s), delta)]
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        kargs = fa._kernel_args(0, scale, causal, 0.0, q.dtype, q.device)
        dims = (bh, s, s, d)
        ms_dq, dev_dq = leaf_timed(torch, lambda: fa._launch("flash_attention_bwd_dq", *ptrs,
                                                             dq.data_ptr(), *dims, *kargs))
        ms_dkv, dev_dkv = leaf_timed(torch, lambda: fa._launch(
            "flash_attention_bwd_dkv", *ptrs, dk.data_ptr(), dv.data_ptr(), *dims, *kargs))
        bplain_ms, bplain_dev = leaf_timed(torch, lambda: fa.mha_bwd_reference(
            q, k, v, o, lse, do, 0, scale, causal, 0.0), iters=3)
        q4g, k4g, v4g = (t.detach().requires_grad_(True) for t in (q4, k4, v4))
        out4 = F.scaled_dot_product_attention(q4g, k4g, v4g, is_causal=causal, scale=scale)
        blib_ms, blib_dev = leaf_timed(torch, lambda: torch.autograd.grad(
            out4, (q4g, k4g, v4g), do.view_as(out4), retain_graph=True))
        del out4, q4g, k4g, v4g
        bound = attention_bound_ms(bh, s, s, d, dt, causal)
        bound_dq = attention_bound_ms(bh, s, s, d, dt, causal, "bwd_dq")
        bound_dkv = attention_bound_ms(bh, s, s, d, dt, causal, "bwd_dkv")
        ok = err_o <= TOL_O[dt] and err_lse <= TOL_LSE and max(errs) <= TOL_GRAD[dt]
        rows.append(dict(name=name, dtype=dt, b=b, h=h, sq=s, sk=s, d=d, causal=causal,
                         max_abs_err=err_o, max_lse_err=err_lse, ms=ms, device_ms=dev,
                         plain_ms=plain_ms, plain_device_ms=plain_dev, library_ms=lib_ms,
                         library_device_ms=lib_dev, bound_ms=bound[0], bound_by=bound[1],
                         err_dq=errs[0], err_dk=errs[1], err_dv=errs[2],
                         abs_err_dq=abs_errs[0], abs_err_dkv=max(abs_errs[1:]), ms_dq=ms_dq,
                         device_ms_dq=dev_dq, ms_dkv=ms_dkv, device_ms_dkv=dev_dkv,
                         bwd_plain_ms=bplain_ms, bwd_plain_device_ms=bplain_dev,
                         bwd_library_ms=blib_ms, bwd_library_device_ms=blib_dev,
                         bound_dq=bound_dq, bound_dkv=bound_dkv, ok=ok))
        log(f"  [mp kernels] {name} [{b} * {h}, {s}, {d}] {dt} causal={causal}: O err "
            f"{err_o:.3e} LSE err {err_lse:.3e} dq {errs[0]:.3e} dk {errs[1]:.3e} dv "
            f"{errs[2]:.3e} | K1 {ms:.4f} / {_fmt(dev)} ms{_share(bound[0], dev)} (bound "
            f"{bound[0]:.4f} {bound[1]}), plain {plain_ms:.4f} / {_fmt(plain_dev)}, sdpa "
            f"{lib_ms:.4f} / {_fmt(lib_dev)} | K2 {ms_dq:.4f} / {_fmt(dev_dq)} ms (bound "
            f"{bound_dq[0]:.4f} {bound_dq[1]}{_share(bound_dq[0], dev_dq)}) K3 {ms_dkv:.4f} / "
            f"{_fmt(dev_dkv)} ms (bound {bound_dkv[0]:.4f} {bound_dkv[1]}"
            f"{_share(bound_dkv[0], dev_dkv)}), plain {bplain_ms:.4f} / {_fmt(bplain_dev)}, "
            f"sdpa {blib_ms:.4f} / {_fmt(blib_dev)} ms {'ok' if ok else 'DISAGREES'}")
        del q, k, v, do, o, lse, grads, ro, rlse, want, dq, dk, dv, q4, k4, v4
    torch.cuda.empty_cache()
    if not all(r["ok"] for r in rows):
        fail("phase 25: K1-K3 disagree with their plain versions at phase 25's forms")
    return rows


def mp_rank(torch, mods, rank, out):
    """Phase 25's modes in one of phase 23's ranks. Returns {mode: what the
    parent checks}; rank 0 saves (a)'s gathered parameters, (b)'s
    state_dict and (c)'s joined outputs' halves for it (each rank its own
    half of (c))."""
    (LlamaModel, PipelineLayer, nn, optimizer, spmd, topology, fleet, dist, prandom, fa,
     ra) = mods
    res = {}

    def counted(name, run):
        fa.launches = fa.dq_launches = fa.dkv_launches = 0
        fa.mask_launches.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = run()
        torch.cuda.synchronize()
        # by form and mask: the ring's causal diagonal and unmasked blocks
        got.update(counts=[fa.launches, fa.dq_launches, fa.dkv_launches],
                   masks={" ".join(map(str, k)): v for k, v in fa.mask_launches.items()},
                   seconds=time.perf_counter() - t0)
        res[name] = got
        gc.collect()
        torch.cuda.empty_cache()

    def event_ms(fn):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        got = fn()
        end.record()
        end.synchronize()
        return got, start.elapsed_time(end)

    def run_tp():
        mesh = topology.build_mesh(mp=2)
        model = mp_llama(torch, LlamaModel, True)
        opt = optimizer.AdamW(LR, parameters=model.parameters(), weight_decay=0.01,
                              grad_clip=nn.ClipGradByGlobalNorm(1.0))
        step, init = spmd.build_train_step(model, lambda o, t: mp_loss(torch, o, t), opt,
                                           mesh=mesh)
        params, state = init()
        x, y = mp_batch(torch, MP_TP_BATCH)
        got = dict(losses=[], ms=[])
        for i in range(MP_STEPS):
            if i == MP_STEPS - 1:  # phase 26 (a): the state before the last step
                got["ckpt"] = dict(se_save(torch, out, "tp", step, params, state, i, rank),
                                   dims=step.mp_dims)
            (loss, params, state), ms = event_ms(lambda: step(
                params, state, x, y, key=prandom.fold_in(prandom.PRNGKey(0), i)))
            got["losses"].append(float(loss))
            got["ms"].append(ms)
        stamped = [n for n in params if step.mp_dims[n] is not None]
        held = sum(params[n].numel() * params[n].element_size() for n in stamped)
        whole = sum(p.numel() * p.element_size() for n, p in model.named_parameters()
                    if n in stamped)
        got["share"] = held / whole
        group = dist.Group(axis="mp", process_group=mesh.group("mp"))
        both = dist.all_gather([], torch.cat([params[n].reshape(-1) for n in params
                                              if n not in stamped]), group)
        got["norm_bitwise"] = bool(torch.equal(both[0], both[1]))

        def gathered(params, step):
            return {n: (p if step.mp_dims[n] is None else torch.cat(
                dist.all_gather([], p.contiguous(), group), dim=step.mp_dims[n])).cpu()
                for n, p in params.items()}
        whole = gathered(params, step)
        del model, opt, step, init, params, state
        model = mp_llama(torch, LlamaModel, True)
        step, init = spmd.build_train_step(
            model, lambda o, t: mp_loss(torch, o, t),
            optimizer.SGD(MP_SGD_LR, parameters=model.parameters()), mesh=mesh)
        params, state = init()
        _, params, _ = step(params, state, x, y, key=prandom.fold_in(prandom.PRNGKey(0), 0))
        sgd = gathered(params, step)
        if rank == 0:
            torch.save(whole, os.path.join(out, "mp_a.pt"))
            torch.save(sgd, os.path.join(out, "mp_a_sgd.pt"))
        return got
    counted("tp", run_tp)

    def run_pp():
        fleet.init(is_collective=True, strategy=mp_strategy(fleet))
        model = mp_pipe_model(torch, LlamaModel, PipelineLayer, nn)
        pp_model = fleet.distributed_model(model)
        opt = fleet.distributed_optimizer(optimizer.AdamW(
            LR, parameters=model.parameters(), weight_decay=0.01,
            grad_clip=nn.ClipGradByGlobalNorm(1.0)))
        x, y = mp_batch(torch, MP_PP_BATCH)
        got = dict(losses=[], ms=[], recv_ms=[], wrapper=type(pp_model).__name__)
        for i in range(MP_STEPS):
            if i == MP_STEPS - 1:  # phase 26 (a): the state before the last step
                ctx = pp_model._spmd
                got["ckpt"] = se_save(torch, out, "pp", ctx["step"], ctx["params"], ctx["state"],
                                      i, rank)
            loss, ms = event_ms(lambda: pp_model.train_batch((x, y), opt))
            got["losses"].append(float(loss))
            got["ms"].append(ms)
            got["recv_ms"].append(pp_model._spmd["step"].recv_seconds[-1] * 1e3)
        got["schedule"] = pp_model._spmd["step"].schedule
        both = dist.all_gather([], torch.tensor(got["losses"], dtype=torch.float64,
                                                device="cuda"), "pp")
        got["loss_bitwise"] = bool(torch.equal(both[0], both[1]))
        state = {n: p.detach().cpu() for n, p in pp_model.state_dict().items()}
        del model, pp_model, opt
        model = mp_pipe_model(torch, LlamaModel, PipelineLayer, nn)
        pp_model = fleet.distributed_model(model)
        pp_model.train_batch((x, y), fleet.distributed_optimizer(
            optimizer.SGD(MP_SGD_LR, parameters=model.parameters())))
        sgd = {n: p.detach().cpu() for n, p in pp_model.state_dict().items()}
        if rank == 0:
            torch.save(state, os.path.join(out, "mp_b.pt"))
            torch.save(sgd, os.path.join(out, "mp_b_sgd.pt"))
        topology.set_global_mesh(topology.build_mesh(dp=2))
        return got
    counted("pp", run_pp)

    def run_ring():
        mesh = topology.build_mesh(sp=2)
        s = MP_RING[2] // 2
        q, k, v, do = (t[:, :, rank * s:(rank + 1) * s].contiguous()
                       for t in mp_ring_data(torch))
        got = {}
        for dt in ("float32", "bfloat16"):
            tdt = getattr(torch, dt)
            leaves = [t.to(tdt).requires_grad_(True) for t in (q, k, v)]
            ms, hops = [], []
            for _ in range(MP_RING_CALLS):
                ra.hop_seconds.clear()

                def call():
                    o = ra.ring_attention(*leaves, mesh=mesh, causal=True)
                    return (o, *torch.autograd.grad(o, leaves, do.to(tdt)))
                outs, t = event_ms(call)
                ms.append(t)
                hops.append([h * 1e3 for h in ra.hop_seconds])
            plain_leaves = [t.detach().requires_grad_(True) for t in leaves]
            po = ra.ring_attention_reference(*plain_leaves, mesh=mesh, causal=True)
            plain = (po, *torch.autograd.grad(po, plain_leaves, do.to(tdt)))
            plain_err = max(_rel_err(torch, a, b) for a, b in zip(outs, plain))
            torch.save([a.detach().cpu() for a in outs], os.path.join(out, f"mp_c_{dt}_{rank}.pt"))
            got[dt] = dict(ms=ms, hops_ms=hops, plain_err=plain_err)
        return got
    counted("ring", run_ring)
    return res


def mp_references(torch, mods):
    """The one-device runs phase 25 holds the ranks against, made in this
    process while the pods run: (a)'s plain Llama through build_train_step,
    (b)'s PipelineLayer through PipelineParallel's sequential path (a mesh
    without pp), (c)'s K1-K3 on the whole sequence."""
    LlamaModel, PipelineLayer, PipelineParallel, nn, optimizer, spmd, prandom, fa = mods
    refs = {}
    model = mp_llama(torch, LlamaModel, False)
    opt = optimizer.AdamW(LR, parameters=model.parameters(), weight_decay=0.01,
                          grad_clip=nn.ClipGradByGlobalNorm(1.0))
    step, init = spmd.build_train_step(model, lambda o, t: mp_loss(torch, o, t), opt)
    params, state = init()
    x, y = mp_batch(torch, MP_TP_BATCH)
    losses = []
    for i in range(MP_STEPS):
        loss, params, state = step(params, state, x, y,
                                   key=prandom.fold_in(prandom.PRNGKey(0), i))
        losses.append(float(loss))
    refs["tp"] = dict(losses=losses, params={n: p.cpu() for n, p in params.items()})
    del model, opt, step, init, params, state
    model = mp_llama(torch, LlamaModel, False)
    step, init = spmd.build_train_step(model, lambda o, t: mp_loss(torch, o, t),
                                       optimizer.SGD(MP_SGD_LR, parameters=model.parameters()))
    params, state = init()
    before = {n: p.cpu() for n, p in params.items()}
    _, params, _ = step(params, state, x, y, key=prandom.fold_in(prandom.PRNGKey(0), 0))
    refs["tp"]["sgd"] = (before, {n: p.cpu() for n, p in params.items()})
    del model, step, init, params, state
    model = mp_pipe_model(torch, LlamaModel, PipelineLayer, nn)

    class Strategy:
        pipeline_configs = {"accumulate_steps": MP_MICRO}
        amp = False
    seq = PipelineParallel(model, strategy=Strategy())
    opt = optimizer.AdamW(LR, parameters=model.parameters(), weight_decay=0.01,
                          grad_clip=nn.ClipGradByGlobalNorm(1.0))
    x, y = mp_batch(torch, MP_PP_BATCH)
    losses = [float(seq.train_batch((x, y), opt)) for _ in range(MP_STEPS)]
    refs["pp"] = dict(losses=losses, state={n: p.detach().cpu()
                                            for n, p in seq.state_dict().items()})
    del model, seq, opt
    model = mp_pipe_model(torch, LlamaModel, PipelineLayer, nn)
    seq = PipelineParallel(model, strategy=Strategy())
    before = {n: p.detach().cpu() for n, p in seq.state_dict().items()}
    seq.train_batch((x, y), optimizer.SGD(MP_SGD_LR, parameters=model.parameters()))
    refs["pp"]["sgd"] = (before, {n: p.detach().cpu() for n, p in seq.state_dict().items()})
    del model, seq
    q, k, v, do = (t.flatten(0, 1) for t in mp_ring_data(torch))
    refs["ring"] = {}
    for dt in ("float32", "bfloat16"):
        args = [t.to(getattr(torch, dt)) for t in (q, k, v)]
        scale = MP_RING[3] ** -0.5
        o, lse = fa._fwd(*args, 0, scale, True, 0.0)
        grads = fa._bwd(*args, o, lse, do.to(args[0].dtype), 0, scale, True, 0.0)
        refs["ring"][dt] = [t.view(MP_RING).cpu() for t in (o, *grads)]
    gc.collect()
    torch.cuda.empty_cache()
    return refs


def phase_model_parallel(torch, ranks, out, refs, cases, card):
    """Phase 25's checks on what the ranks wrote (module docstring)."""
    t0 = time.perf_counter()
    bad = []
    m = [r["model_parallel"] for r in ranks]
    layers, heads = MP_CFG["num_layers"], MP_CFG["num_heads"]
    kernels = ("fwd", "dq", "dkv")
    # each mode's AdamW steps and its SGD step
    expect_tp = {f"{k} {MP_SEQ} {MP_SEQ} float32 True": layers * (MP_STEPS + 1)
                 for k in kernels}
    expect_pp = {f"{k} {MP_SEQ} {MP_SEQ} float32 True": layers // 2 * MP_MICRO * (MP_STEPS + 1)
                 for k in kernels}
    half = MP_RING[2] // 2
    for rank, g in enumerate(m):
        # each rank's own diagonal causal, rank 1's earlier block unmasked
        expect_ring = {f"{k} {half} {half} {dt} {c}": n * MP_RING_CALLS
                       for k in kernels for dt in ("float32", "bfloat16")
                       for c, n in ((True, 1), (False, rank)) if n}
        for mode, want in (("tp", expect_tp), ("pp", expect_pp), ("ring", expect_ring)):
            if g[mode]["masks"] != want:
                bad.append(f"{mode}: rank {rank} launched {g[mode]['masks']}, expected {want}")

    def close(got, want):
        return all(abs(a - b) <= MP_ATOL + MP_RTOL * abs(b) for a, b in zip(got, want))

    def sgd_err(name, ref):
        # the SGD step's gradient (p0 - p1) / lr against one device's, each
        # tensor relative to the one-device gradient's max: the worst, and
        # its tensor
        got, (p0, p1) = torch.load(os.path.join(out, name)), ref["sgd"]
        if set(got) != set(p1):
            return float("inf"), "the names differ"
        return max((((got[n].float() - w.float()).abs().max()
                     / (p0[n].float() - w.float()).abs().max().clamp_min(1e-30)).item(), n)
                   for n, w in p1.items())

    # (a)
    ref = refs["tp"]
    got = torch.load(os.path.join(out, "mp_a.pt"))
    perr = _worst_abs(got, ref["params"])
    gerr, gname = sgd_err("mp_a_sgd.pt", ref)
    share = [g["tp"]["share"] for g in m]
    log(f"[model parallel] (a) LlamaModel(tensor_parallel=True), Llama-374M width at depth "
        f"{layers}, build_mesh(mp=2) ({heads // 2} heads a rank), {MP_STEPS} O0 f32 AdamW steps "
        f"at {MP_TP_BATCH} x {MP_SEQ}: losses " + " / ".join(
            f"rank {i} " + " ".join(f"{v:.6f}" for v in g["tp"]["losses"]) for i, g in enumerate(m))
        + " one device " + " ".join(f"{v:.6f}" for v in ref["losses"])
        + f" (rtol {MP_RTOL}, atol {MP_ATOL}); gathered parameters max abs err {perr:.3e} "
        f"(tolerance {2.5 * LR:.1e}); one SGD step's gradient {gerr:.3e} of each tensor's max "
        f"(tolerance {TOL_STEP_GRAD:.0e}; worst {gname}); RMSNorm weights bitwise on both ranks "
        f"{[g['tp']['norm_bitwise'] for g in m]}; a rank's stamped bytes {share} of the whole; "
        f"K1/K2/K3 {[g['tp']['counts'] for g in m]}; step ms a rank (CUDA events) "
        + " / ".join(" ".join(f"{v:.1f}" for v in g["tp"]["ms"]) for g in m) + f" [{card}]")
    if not all(close(g["tp"]["losses"], ref["losses"]) for g in m):
        bad.append("(a) losses")
    if not perr <= 2.5 * LR:
        bad.append("(a) parameters")
    if not gerr <= TOL_STEP_GRAD:
        bad.append("(a) the SGD step's gradient")
    if not all(g["tp"]["norm_bitwise"] for g in m) or any(abs(v - 0.5) > 1e-9 for v in share):
        bad.append("(a) the replicated parameters differ, or a rank holds other than half")

    # (b)
    ref = refs["pp"]
    got = torch.load(os.path.join(out, "mp_b.pt"))
    perr = _worst_abs(got, ref["state"])
    gerr, gname = sgd_err("mp_b_sgd.pt", ref)
    sched = m[0]["pp"]["schedule"]
    log(f"[model parallel] (b) fleet pipe mode ({m[0]['pp']['wrapper']}, pp_degree 2, "
        f"accumulate_steps {MP_MICRO}), {layers // 2} decoder layers a stage, {MP_STEPS} O0 f32 "
        f"AdamW steps at {MP_PP_BATCH} x {MP_SEQ}: losses " + " / ".join(
            f"rank {i} " + " ".join(f"{v:.6f}" for v in g["pp"]["losses"]) for i, g in enumerate(m))
        + " sequential one device " + " ".join(f"{v:.6f}" for v in ref["losses"])
        + f"; bitwise on both ranks {[g['pp']['loss_bitwise'] for g in m]}; state_dict max abs "
        f"err {perr:.3e} (tolerance {2.5 * LR:.1e}); one SGD step's gradient {gerr:.3e} of each "
        f"tensor's max (tolerance {TOL_STEP_GRAD:.0e}; worst {gname}); schedule {sched}; ms in recv a step "
        + " / ".join(" ".join(f"{v:.1f}" for v in g["pp"]["recv_ms"]) for g in m)
        + "; step ms a rank (CUDA events) "
        + " / ".join(" ".join(f"{v:.1f}" for v in g["pp"]["ms"]) for g in m) + f" [{card}]")
    if not all(close(g["pp"]["losses"], ref["losses"]) for g in m):
        bad.append("(b) losses")
    if not perr <= 2.5 * LR or set(got) != set(ref["state"]):
        bad.append("(b) parameters")
    if not gerr <= TOL_STEP_GRAD:
        bad.append("(b) the SGD step's gradient")
    if not all(g["pp"]["loss_bitwise"] for g in m) or abs(sched["bubble_fraction"] - 0.2) > 1e-12:
        bad.append("(b) the loss differs between the ranks, or the schedule")

    # (c)
    for dt in ("float32", "bfloat16"):
        parts = [torch.load(os.path.join(out, f"mp_c_{dt}_{r}.pt")) for r in range(len(ranks))]
        errs = []
        for i, want in enumerate(refs["ring"][dt]):
            joined = torch.cat([p[i] for p in parts], dim=2).float()
            w = want.float()
            if dt == "float32":
                errs.append(((joined - w).abs() - TOL_RING[dt] * w.abs()).max().item())
            else:
                errs.append((joined - w).abs().max().item() / w.abs().max().item())
        hops = [h for g in m for call in g["ring"][dt]["hops_ms"][1:] for h in call]
        tol = TOL_RING[dt]
        held = (f"|err| - {tol} |ref| within {tol}" if dt == "float32"
                else f"within {tol} of the max")
        plain = ", ".join(f"{g['ring'][dt]['plain_err']:.2e}" for g in m)
        log(f"[model parallel] (c) ring_attention over build_mesh(sp=2), {list(MP_RING)} causal, "
            f"{MP_RING[2] // 2} positions a rank, {dt}: O, dQ, dK, dV joined vs one-device K1-K3 "
            f"on the whole " + " ".join(f"{e:.2e}" for e in errs)
            + f" ({held}); vs the plain fold on the card {plain} of the max; a call (forward + "
            f"backward) ms " + " / ".join(
                " ".join(f"{v:.1f}" for v in g["ring"][dt]["ms"]) for g in m)
            + f"; a hop through the host ms median {_median(hops):.2f} max {max(hops):.2f} "
            f"({len(hops) // max(1, 2 * (MP_RING_CALLS - 1))} hops a call a rank); launches "
            f"over {MP_RING_CALLS} calls by kernel and mask (causal) " + " / ".join(
                f"rank {i} " + ", ".join(f"{k.split()[0]} {k.split()[-1]} {n}"
                                         for k, n in g["ring"]["masks"].items() if dt in k)
                for i, g in enumerate(m)) + f" [{card}]")
        if not max(errs) <= tol:
            bad.append(f"(c) {dt} against the one-device kernels")
        if not all(g["ring"][dt]["plain_err"] <= TOL_GRAD[dt] for g in m):
            bad.append(f"(c) {dt} against the plain fold")
    if bad:
        fail(f"phase 25: {'; '.join(bad)}")
    counts = [sum(g[mode]["counts"][i] for g in m for mode in ("tp", "pp", "ring"))
              for i in range(3)]
    secs = {mode: max(g[mode]["seconds"] for g in m) for mode in ("tp", "pp", "ring")}
    log(f"[model parallel] phase 25: the ranks' modes " + ", ".join(
        f"{k} {v:.1f}" for k, v in secs.items()) + f" s ({sum(secs.values()):.1f} s), the checks "
        f"{time.perf_counter() - t0:.1f} s; K1/K2/K3 over both ranks {counts} [{card}]")
    forms = {mode: [sum(g[mode]["counts"][i] for g in m) for i in range(3)]
             for mode in ("tp", "pp")}
    # (c)'s launches by block form, as the wrapper counted them by mask
    ring_forms = {f"ring_{b}_{dt}": [0, 0, 0] for b in ("diag", "block")
                  for dt in ("float32", "bfloat16")}
    for g in m:
        for key, n in g["ring"]["masks"].items():
            kernel, _, _, dt, causal = key.split()
            ring_forms[f"ring_{'diag' if causal == 'True' else 'block'}_{dt}"][
                kernels.index(kernel)] += n
    return dict(counts=counts, cases=cases, forms=dict(forms, **ring_forms),
                seconds=sum(secs.values()) + time.perf_counter() - t0)


# ------------------------------------------------------------------ phase 26
# State, elastic and experts, in phase 23's two ranks after phase 25's modes
# (the same pod) and in this process. (a) Phase 24's ZeRO-1 and ZeRO-2
# BERT-base steps and phase 25's mp=2 and pp=2 Llama steps each save one
# checkpoint through MultiProcessShardedManager after their next-to-last
# step; this process restores each onto one device and takes the last step
# there. (b) At the end of the pod, rank 1 sends itself SIGTERM mid-run:
# both ranks reach the elastic consensus, save that step and exit 143.
# (c) Two pre-norm-free x + moe(x) blocks at Switch-Base-8's expert widths
# (Fedus et al. 2021: d_model 768, d_ff 3072, 8 experts; the reference's
# top_k 2 and capacity_factor 1.25, so capacity mode) on 32 x 128 tokens.
SE_MOE = dict(hidden=768, ffn=3072, experts=8, top_k=2, cf=1.25)
SE_BATCH, SE_SEQ, SE_BLOCKS, SE_STEPS, SE_LR = 32, 128, 2, 2, 1e-3
SE_TOL_CARD = 1e-4  # (c): card vs CPU, of each tensor's max
SE_SIGTERM_AT = 3  # (b): rank 1's SIGTERM, at its third step
SE_ELASTIC_STEPS = 40  # (b): the steps a rank takes at most before consensus
SE_CKPTS = ("zero1", "zero2", "tp", "pp")  # (a)


def se_model(torch, nn, MoELayer, mode, device="cuda"):
    """(c)'s two x + moe(x) blocks, weights from a seed."""

    class Blocks(nn.Layer):
        def __init__(self):
            super().__init__()
            g = torch.Generator().manual_seed(26)
            self.blocks = nn.LayerList([
                MoELayer(SE_MOE["hidden"], SE_MOE["ffn"], num_experts=SE_MOE["experts"],
                         top_k=SE_MOE["top_k"], dispatch_mode=mode,
                         capacity_factor=SE_MOE["cf"], device=device, generator=g)
                for _ in range(SE_BLOCKS)])

        def forward(self, x):
            for block in self.blocks:
                x = x + block(x)
            return x
    return Blocks()


def se_batch(torch, device="cuda"):
    g = torch.Generator().manual_seed(260)
    shape = (SE_BATCH, SE_SEQ, SE_MOE["hidden"])
    return torch.randn(shape, generator=g).to(device), torch.randn(shape, generator=g).to(device)


def se_loss(out, y):
    return ((out - y) ** 2).mean()


def se_save(torch, out, tag, step_fn, params, state, step, rank, world=DP_RANKS):
    """(a): this rank's blocks of a step's state through
    MultiProcessShardedManager (OUT/ckpt-TAG) as checkpoint ``step``.
    Returns what the parent checks: the seconds, a digest of the blocks
    (param_digest over the leaves in their order), the step's layout."""
    from paddle_tpu_torch.distributed import checkpoint
    from paddle_tpu_torch.resilience.checkpoint import flatten_tree

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    placed = checkpoint.place({"params": params, "opt_state": state}, step_fn.layout)
    checkpoint.sharded_checkpoint_manager(os.path.join(out, f"ckpt-{tag}"), rank=rank,
                                          world=world).save(placed, step)
    secs = time.perf_counter() - t0
    blocks = {p: (l.data if isinstance(l, checkpoint.Shard) else l)
              for p, l in flatten_tree(placed).items()}
    return dict(step=step, seconds=secs, digest=param_digest(torch, blocks).tolist(),
                bytes=sum(t.numel() * t.element_size() for t in blocks.values()))


def se_rank(torch, mods, rank, out):
    """(c) in one of phase 23's ranks: the blocks over build_mesh(ep=2) in
    capacity and alltoall mode, Adam, SE_STEPS steps on the whole batch
    (ep splits the experts, not the batch); rank 0 saves the gathered
    parameters for the parent."""
    nn, optimizer, spmd, topology, dist, MoELayer = mods
    mesh = topology.build_mesh(ep=DP_RANKS)
    group = dist.Group(axis="ep", process_group=mesh.group("ep"))
    x, y = se_batch(torch)
    res = {}
    for mode in ("capacity", "alltoall"):
        model = se_model(torch, nn, MoELayer, mode)
        step, init = spmd.build_train_step(
            model, se_loss, optimizer.Adam(SE_LR, parameters=model.parameters()), mesh=mesh)
        params, state = init()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        got = dict(losses=[], ms=[])
        for _ in range(SE_STEPS):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            loss, params, state = step(params, state, x, y)
            end.record()
            end.synchronize()
            got["ms"].append(start.elapsed_time(end))
            got["losses"].append(float(loss))
        got["peak_bytes"] = torch.cuda.max_memory_allocated()
        experts = [n for n in params if step.ep_dims[n] is not None]
        got["share"] = (sum(params[n].numel() for n in experts)
                        / sum(p.numel() for n, p in model.named_parameters() if n in experts))
        whole = {n: (p if step.ep_dims[n] is None else torch.cat(
            dist.all_gather([], p.contiguous(), group), dim=step.ep_dims[n])).cpu()
            for n, p in params.items()}
        if rank == 0:
            torch.save(whole, os.path.join(out, f"se_{mode}.pt"))
        res[mode] = got
        del model, step, init, params, state, whole
        gc.collect()
        torch.cuda.empty_cache()
    return res


def se_elastic(torch, mods, rank, out):
    """(b), the last thing the restarted pod's ranks do: (c)'s capacity
    blocks over ep=2 under a non-blocking elastic client; rank 1's
    chaos site sends it SIGTERM at its SE_SIGTERM_AT-th step; the ranks
    propose, agree, save the agreed step through MultiProcessShardedManager
    (the client's barriers) and exit 143 (PreemptedExit). Writes
    OUT/elastic{rank}.json first."""
    (nn, optimizer, spmd, topology, dist, MoELayer, chaos, elastic, preemption) = mods
    t_start = time.perf_counter()
    mesh = topology.build_mesh(ep=DP_RANKS)
    model = se_model(torch, nn, MoELayer, "capacity")
    step_fn, init = spmd.build_train_step(
        model, se_loss, optimizer.Adam(SE_LR, parameters=model.parameters()), mesh=mesh)
    params, state = init()
    x, y = se_batch(torch)
    handler = preemption.get_preemption_handler()
    handler.install(signals=(signal.SIGTERM,))
    client = elastic.init_from_env(handler=handler, block=False)
    if rank == 1:
        chaos.arm("elastic.step", signum=signal.SIGTERM, at=SE_SIGTERM_AT)
    got = dict(losses=[], t_signal=None, t_consensus=None, target=None)
    for i in range(1, SE_ELASTIC_STEPS + 1):
        t0 = time.perf_counter()
        chaos.hit("elastic.step")
        if handler.requested and got["t_signal"] is None:
            got["t_signal"] = time.time()
        loss, params, state = step_fn(params, state, x, y)
        got["losses"].append(float(loss))
        client.note_step(i, time.perf_counter() - t0)
        target = client.check_boundary(i)
        if target is not None and got["t_consensus"] is None:
            got.update(t_consensus=time.time(), target=target)
        if target is not None and i >= target:
            got.update(se_save(torch, out, "elastic", step_fn, params, state, i, rank),
                       ep_dims=step_fn.ep_dims, run_s=time.perf_counter() - t_start)
            client.saved(i)
            if rank == 0:
                # the coordinator lives in this process: keep it until every
                # rank is past its publish barrier (said "saved"); a rank
                # polling a vanished coordinator waits out dead_timeout
                deadline = time.monotonic() + 30
                while (len(client.status().get("saved", {})) < DP_RANKS
                       and time.monotonic() < deadline):
                    time.sleep(0.02)
            with open(os.path.join(out, f"elastic{rank}.json"), "w") as f:
                json.dump(got, f)
            client.close()
            raise preemption.PreemptedExit(step=i)
    client.close()
    fail(f"phase 26 (b): rank {rank} saw no consensus in {SE_ELASTIC_STEPS} steps")


def se_references(torch, mods, card):
    """(c) in this process, while the pods run: the blocks' f32 forward
    and backward on the card against the CPU (each tensor within
    SE_TOL_CARD of its max), timed, with its peak memory; and the
    one-device steps the ranks' ep=2 steps are held against."""
    nn, optimizer, spmd, topology, MoELayer = mods
    t0 = time.perf_counter()
    res = {}
    cpu = se_model(torch, nn, MoELayer, "capacity", device="cpu")
    card_model = se_model(torch, nn, MoELayer, "capacity")
    xc, yc = se_batch(torch, "cpu")

    def fwd_bwd(model, x, y):
        for p in model.parameters():
            p.grad = None
        out = model(x)
        loss = se_loss(out, y) + sum(b.aux_loss for b in model.blocks)
        loss.backward()
        return [out.detach()] + [p.grad for p in model.parameters()]
    t = time.perf_counter()
    want = fwd_bwd(cpu, xc, yc)
    cpu_s = time.perf_counter() - t
    x, y = xc.cuda(), yc.cuda()
    fwd_bwd(card_model, x, y)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ms = []
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        got = fwd_bwd(card_model, x, y)
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
    peak = torch.cuda.max_memory_allocated() - base
    errs = [_rel_err(torch, g.cpu(), w) for g, w in zip(got, want)]
    dev = device_ms(torch, lambda: fwd_bwd(card_model, x, y), iters=3, warmup=0)
    res["card"] = dict(ms=ms, device_ms=dev, peak_bytes=peak, errs=errs, cpu_s=cpu_s,
                       names=["out"] + [n for n, _ in cpu.named_parameters()])
    del cpu, card_model, got, want
    # the one-device steps: alltoall's token groups come from the global
    # mesh's ep axis, as in the reference's global program
    one = topology.Mesh((1,) * 6)
    saved = topology._GLOBAL_MESH
    res["steps"] = {}
    for mode in ("capacity", "alltoall"):
        topology.set_global_mesh(topology.Mesh((1, 1, 1, 1, DP_RANKS, 1)))
        try:
            model = se_model(torch, nn, MoELayer, mode)
            step, init = spmd.build_train_step(
                model, se_loss, optimizer.Adam(SE_LR, parameters=model.parameters()), mesh=one)
            params, state = init()
            losses = []
            for _ in range(SE_STEPS):
                loss, params, state = step(params, state, x, y)
                losses.append(float(loss))
        finally:
            topology.set_global_mesh(saved)
        res["steps"][mode] = dict(losses=losses, params={n: p.cpu() for n, p in params.items()})
        del model, step, init, params, state
    gc.collect()
    torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t0
    return res


def se_file_blocks(ckpt, rank):
    """{leaf: array} of one rank's shard directory of a checkpoint, in its
    index's (the rank's flatten) order."""
    d = os.path.join(ckpt, f"shard-{rank:05d}")
    with open(os.path.join(d, "index.json")) as f:
        index = json.load(f)
    with np.load(os.path.join(d, "data.npz")) as blobs:
        return {e["leaf"]: blobs[e["key"]] for e in index["entries"]}


def se_tree(leaves):
    """{"params": {name: x}, "opt_state": {name: (x, ...)}} of flattened
    "params.<name>" / "opt_state.<name>.<i>" leaves."""
    tree = {"params": {}, "opt_state": {}}
    for path, a in leaves.items():
        part, _, rest = path.partition(".")
        if part == "params":
            tree["params"][rest] = a
        elif part == "opt_state":
            name, _, i = rest.rpartition(".")
            tree["opt_state"].setdefault(name, {})[int(i)] = a
    tree["opt_state"] = {n: tuple(d[i] for i in sorted(d)) for n, d in tree["opt_state"].items()}
    return tree


def se_restore(torch, mods, out, tag, infos, kinds, dims, like):
    """(a)/(b) for one checkpoint: verify its manifest; each rank's shard
    holds the rank's blocks (their digest); convert.from_rank_states of
    the ranks' blocks (``kinds``: each part's layout, None where every
    rank holds it whole) is bitwise what load_host_sharded restores; the
    restored leaves take the shapes of ``like`` (one device's
    {"params", "opt_state"}; a pipeline's stages differ in shape, not in
    size). Returns (the restored state on the card, what to print, what
    failed)."""
    checkpoint, convert = mods
    step = infos[0]["step"]
    root = os.path.join(out, f"ckpt-{tag}")
    ckpt = os.path.join(root, f"ckpt-{step}")
    bad = []
    t0 = time.perf_counter()
    checkpoint.MultiProcessShardedManager(root, rank=0, world=DP_RANKS).verify(ckpt)
    files = [se_file_blocks(ckpt, r) for r in range(DP_RANKS)]
    for r, f in enumerate(files):
        mine = {k: torch.from_numpy(np.ascontiguousarray(v)).cuda() for k, v in f.items()}
        if param_digest(torch, mine).tolist() != infos[r]["digest"]:
            bad.append(f"rank {r}'s shard is not its blocks")
        del mine
    trees = [se_tree(f) for f in files]
    with open(os.path.join(ckpt, checkpoint.HOST_SHARDS_NAME)) as f:
        meta = json.load(f)["leaves"]
    # the global shapes (convert reads a leaf's .shape, np.empty's is free)
    assembled = se_tree({p: np.empty(spec["shape"], np.uint8) for p, spec in meta.items()})
    gathered = {}
    for part in ("params", "opt_state"):
        if kinds[part] is None:
            if not all(trees_equal(t[part], trees[0][part]) for t in trees[1:]):
                bad.append(f"{part}: the ranks' whole copies differ")
            gathered[part] = trees[0][part]
        else:
            gathered[part] = convert.from_rank_states([t[part] for t in trees], assembled[part],
                                                      kinds[part], dims)

    def empty(a, t):  # the global array's shape, the device leaf's dtype
        return torch.empty(a.shape, dtype=t.dtype, device=t.device)
    template = {"params": {n: empty(a, like["params"][n])
                           for n, a in assembled["params"].items()},
                "opt_state": {n: tuple(empty(a, t) for a, t in zip(v, like["opt_state"][n]))
                              for n, v in assembled["opt_state"].items()}}
    got = checkpoint.load_host_sharded(ckpt, template)
    host = {"params": {n: t.cpu().numpy() for n, t in got["params"].items()},
            "opt_state": {n: tuple(t.cpu().numpy() for t in v)
                          for n, v in got["opt_state"].items()}}
    if not trees_equal(host, gathered):
        bad.append("the restored state is not the ranks' state gathered")
    restored = {"params": {n: t.reshape(like["params"][n].shape)
                           for n, t in got["params"].items()},
                "opt_state": {n: tuple(t.reshape(w.shape) for t, w in zip(v, like["opt_state"][n]))
                              for n, v in got["opt_state"].items()}}
    size = sum(os.path.getsize(os.path.join(dp, fn)) for dp, _, fns in os.walk(ckpt)
               for fn in fns)
    return restored, dict(step=step, seconds=time.perf_counter() - t0, bytes=size), bad


def trees_equal(a, b):
    """Two trees of arrays equal bit for bit."""
    if isinstance(b, dict):
        return set(a) == set(b) and all(trees_equal(a[k], b[k]) for k in b)
    if isinstance(b, (tuple, list)):
        return len(a) == len(b) and all(trees_equal(x, y) for x, y in zip(a, b))
    return np.array_equal(np.asarray(a), np.asarray(b))


def phase_state_experts(torch, mods, ranks, out, refs, pod_exit, card, bert):
    """Phase 26's checks on what the ranks wrote (see its constants).
    ``bert``: phase 23's (a BERT-base maker, build, x, y, keys) in this
    process, the one-device step the ZeRO checkpoints are restored onto;
    ``pod_exit``: what launch_elastic raised for the restarted pod."""
    (nn, optimizer, spmd, topology, prandom, checkpoint, convert, pipe, LlamaModel,
     PipelineLayer, MoELayer, launch_mod) = mods
    t_phase = time.perf_counter()
    bad = []
    make_bert, build, x, y, keys = bert
    model = make_bert()

    def one_device(step_fn, init):
        params, state = init()
        return step_fn, dict(params=params, opt_state=state)

    # (a) ZeRO-1 and ZeRO-2 (phase 24 (a), build_mesh(dp=1, sharding=2)):
    # params whole on both ranks, the optimizer state in blocks; restored
    # and the last step taken on one device at the global batch
    printed = []
    for tag in ("zero1", "zero2"):
        infos = [r["meshed"][tag]["ckpt"] for r in ranks]
        step_fn, like = one_device(*build(model, "O0"))
        state, info, why = se_restore(torch, (checkpoint, convert), out, tag, infos,
                                      {"params": None, "opt_state": "zero"}, None, like)
        loss, params, _ = step_fn(state["params"], state["opt_state"], x, y,
                                  key=keys[MESHED_STEPS - 1])
        want_loss = ranks[0]["meshed"][tag]["losses"][MESHED_STEPS - 1]
        whole = torch.load(os.path.join(out, f"{tag}.pt"))
        loss_err = abs(float(loss) - want_loss) / abs(want_loss)
        param_err = max((params[n].cpu() - w).abs().max().item() for n, w in whole.items())
        printed.append(f"{tag} step {info['step']} {info['bytes'] / 2**30:.2f} GiB: saved in "
                       + " / ".join(f"{i['seconds']:.1f}" for i in infos) + " s a rank, "
                       f"restored {info['seconds']:.1f} s; the last step on one device: loss "
                       f"{float(loss):.6f} vs the ranks' {want_loss:.6f} (rel err {loss_err:.2e}, "
                       f"tolerance {TOL_STEP_LOSS}), parameters max abs err {param_err:.3e} "
                       f"(tolerance {2.5 * LR:.2e})")
        bad += [f"(a) {tag}: {w}" for w in why]
        if not loss_err <= TOL_STEP_LOSS or not param_err <= 2.5 * LR:
            bad.append(f"(a) {tag}: the step from the restored state")
        del step_fn, like, state, params, whole
        gc.collect()
        torch.cuda.empty_cache()
    del model

    # phase 25 (a): LlamaModel(tensor_parallel=True) over mp=2, restored onto
    # the plain model's one-device step
    mp = [r["model_parallel"] for r in ranks]
    infos = [g["tp"]["ckpt"] for g in mp]
    llama = mp_llama(torch, LlamaModel, False)
    step_fn, like = one_device(*spmd.build_train_step(
        llama, lambda o, t: mp_loss(torch, o, t), optimizer.AdamW(
            LR, parameters=llama.parameters(), weight_decay=0.01,
            grad_clip=nn.ClipGradByGlobalNorm(1.0))))
    dims = infos[0]["dims"]
    state, info, why = se_restore(torch, (checkpoint, convert), out, "tp", infos,
                                  {"params": "mp", "opt_state": "mp"}, dims, like)
    xt, yt = mp_batch(torch, MP_TP_BATCH)
    loss, params, _ = step_fn(state["params"], state["opt_state"], xt, yt,
                              key=prandom.fold_in(prandom.PRNGKey(0), MP_STEPS - 1))
    want_loss = mp[0]["tp"]["losses"][MP_STEPS - 1]
    whole = torch.load(os.path.join(out, "mp_a.pt"))
    param_err = max((params[n].cpu() - w).abs().max().item() for n, w in whole.items())
    tp_ok = abs(float(loss) - want_loss) <= MP_ATOL + MP_RTOL * abs(want_loss)
    printed.append(f"tp step {info['step']} {info['bytes'] / 2**30:.2f} GiB: saved in "
                   + " / ".join(f"{i['seconds']:.1f}" for i in infos) + f" s a rank, restored "
                   f"{info['seconds']:.1f} s; the last step on one device: loss "
                   f"{float(loss):.6f} vs the ranks' {want_loss:.6f} (rtol {MP_RTOL}, atol "
                   f"{MP_ATOL}), parameters max abs err {param_err:.3e} (tolerance "
                   f"{2.5 * LR:.2e})")
    bad += [f"(a) tp: {w}" for w in why]
    if not tp_ok or not param_err <= 2.5 * LR:
        bad.append("(a) tp: the step from the restored state")
    del llama, step_fn, like, state, params, whole

    # phase 25 (b): fleet's pipe mode at pp=2; its stages [2, 2, ...] go onto
    # a one-device pipeline's [1, 4, ...] and take the last step there
    infos = [g["pp"]["ckpt"] for g in mp]
    pmodel = mp_pipe_model(torch, LlamaModel, PipelineLayer, nn)
    pre, trunk, post = pipe.split_pre_trunk_post(list(pmodel.run_functions), 1)
    step_fn, like = one_device(*pipe.build_pipeline_train_step(
        pre, trunk, post, pmodel._loss_fn, optimizer.AdamW(
            LR, parameters=pmodel.parameters(), weight_decay=0.01,
            grad_clip=nn.ClipGradByGlobalNorm(1.0)), mesh=topology.Mesh((1,) * 6),
        num_micro=MP_MICRO))
    state, info, why = se_restore(torch, (checkpoint, convert), out, "pp", infos,
                                  {"params": "pp", "opt_state": "pp"}, None, like)
    xp, yp = mp_batch(torch, MP_PP_BATCH)
    loss, _, _ = step_fn(state["params"], state["opt_state"], xp, yp,
                         key=prandom.PRNGKey(MP_STEPS), lr=LR)
    want_loss = mp[0]["pp"]["losses"][MP_STEPS - 1]
    pp_ok = abs(float(loss) - want_loss) <= MP_ATOL + MP_RTOL * abs(want_loss)
    printed.append(f"pp step {info['step']} {info['bytes'] / 2**30:.2f} GiB: saved in "
                   + " / ".join(f"{i['seconds']:.1f}" for i in infos) + f" s a rank, restored "
                   f"{info['seconds']:.1f} s; the last step on one pp=1 device: loss "
                   f"{float(loss):.6f} vs the ranks' {want_loss:.6f} (rtol {MP_RTOL}, atol "
                   f"{MP_ATOL})")
    bad += [f"(a) pp: {w}" for w in why]
    if not pp_ok:
        bad.append("(a) pp: the step from the restored state")
    del pmodel, pre, trunk, post, step_fn, like, state
    gc.collect()
    torch.cuda.empty_cache()
    for line in printed:
        log(f"[state] (a) MultiProcessShardedManager {line} [{card}]")

    # (b) the elastic consensus at the end of the pod
    el = [json.load(open(os.path.join(out, f"elastic{r}.json"))) for r in range(DP_RANKS)]
    codes = getattr(pod_exit, "codes", None)
    agreed = {e["step"] for e in el}
    t_signal = el[1]["t_signal"]
    latency = (max(e["t_consensus"] for e in el) - t_signal
               if t_signal is not None and all(e["t_consensus"] for e in el) else None)
    smodel = se_model(torch, nn, MoELayer, "capacity")
    step_fn, like = one_device(*spmd.build_train_step(
        smodel, se_loss, optimizer.Adam(SE_LR, parameters=smodel.parameters()),
        mesh=topology.Mesh((1,) * 6)))
    state, info, why = se_restore(torch, (checkpoint, convert), out, "elastic", el,
                                  {"params": "ep", "opt_state": "ep"}, el[0]["ep_dims"], like)
    log(f"[state] (b) rank 1's SIGTERM at its step {SE_SIGTERM_AT}: the ranks agreed on step "
        f"{sorted(agreed)} (each saw the consensus {[e['target'] for e in el]}), consensus "
        f"latency {_fmt(None if latency is None else latency * 1e3)} ms after the signal, the "
        "save " + " / ".join(f"{e['seconds']:.2f}" for e in el) + " s a rank "
        f"({info['bytes'] / 2**20:.0f} MiB), exit codes {codes} (launch_elastic raised "
        f"{type(pod_exit).__name__}, no relaunch); restored onto one device bitwise the ranks' "
        f"blocks gathered: {'ok' if not why else why} ({info['seconds']:.1f} s) [{card}]")
    if (not isinstance(pod_exit, launch_mod.PodPreempted) or set(codes.values()) != {143}
            or len(agreed) != 1 or latency is None or min(agreed) < SE_SIGTERM_AT):
        bad.append(f"(b) the consensus exit: codes {codes}, steps {agreed}, latency {latency}")
    bad += [f"(b): {w}" for w in why]
    del smodel, step_fn, like, state

    # (c) the experts: card against the CPU, then the ep=2 steps against
    # the one-device steps
    c = refs["card"]
    worst = max(range(len(c["errs"])), key=lambda i: c["errs"][i])
    tokens = SE_BATCH * SE_SEQ
    log(f"[state] (c) {SE_BLOCKS} x + MoE(x) blocks at Switch-Base-8's widths ({SE_MOE}), "
        f"capacity mode, {SE_BATCH} x {SE_SEQ} tokens, f32 forward + backward: card vs CPU "
        f"worst {c['errs'][worst]:.2e} of the max ({c['names'][worst]}; tolerance "
        f"{SE_TOL_CARD}); card {_median(c['ms']):.2f} ms (CUDA events, median of "
        f"{len(c['ms'])}; {tokens / _median(c['ms']) * 1e3:.0f} tokens/s), device ms "
        f"{_fmt(c['device_ms'])} (a profiler window of 3), peak "
        f"{c['peak_bytes'] / 2**30:.2f} GiB over the weights; the CPU {c['cpu_s']:.1f} s "
        f"[{card}]")
    if not max(c["errs"]) <= SE_TOL_CARD:
        bad.append("(c) card vs CPU")
    se = [r["state_experts"] for r in ranks]
    for mode in ("capacity", "alltoall"):
        want = refs["steps"][mode]
        loss_err = max(abs(a - b) / abs(b) for s in se
                       for a, b in zip(s[mode]["losses"], want["losses"]))
        whole = torch.load(os.path.join(out, f"se_{mode}.pt"))
        param_err = max((whole[n] - w).abs().max().item() for n, w in want["params"].items())
        log(f"[state] (c) {mode} over ep=2, Adam {SE_LR}, {SE_STEPS} steps: losses "
            + " / ".join(" ".join(f"{v:.6f}" for v in s[mode]["losses"]) for s in se)
            + " one device " + " ".join(f"{v:.6f}" for v in want["losses"])
            + f" (worst rel err {loss_err:.2e}, tolerance {TOL_STEP_LOSS}); parameters "
            f"gathered max abs err {param_err:.3e} (tolerance {2.5 * SE_LR:.1e}); a rank's "
            f"experts {se[0][mode]['share']:.2f} of them; step "
            + " / ".join(f"{_median(s[mode]['ms']):.1f}" for s in se) + " ms, peak "
            + " / ".join(f"{s[mode]['peak_bytes'] / 2**30:.2f}" for s in se)
            + f" GiB a rank (gloo through the host) [{card}]")
        if not loss_err <= TOL_STEP_LOSS or not param_err <= 2.5 * SE_LR:
            bad.append(f"(c) {mode} over ep=2")
        if abs(se[0][mode]["share"] - 0.5) > 1e-9:
            bad.append(f"(c) {mode}: a rank holds {se[0][mode]['share']} of the experts")
    if bad:
        fail(f"phase 26: {'; '.join(bad)}")
    secs = time.perf_counter() - t_phase
    saves = [sum(r["meshed"][t]["ckpt"]["seconds"] for t in ("zero1", "zero2"))
             + sum(g[t]["ckpt"]["seconds"] for t in ("tp", "pp")) for r, g in zip(ranks, mp)]
    log(f"[state] phase 26 in the ranks: (a)'s saves " + " / ".join(f"{v:.1f}" for v in saves)
        + " s, (c) " + " / ".join(f"{s['seconds']:.1f}" for s in se) + " s, (b) "
        + " / ".join(f"{e['run_s']:.1f}" for e in el) + f" s a rank; here the checks {secs:.1f} "
        f"s, the references {refs['seconds']:.1f} s [{card}]")
    return dict(seconds=secs + refs["seconds"], latency=latency,
                save_s=[e["seconds"] for e in el])


# ------------------------------------------------------------------ phase 27
# Meshed serving (inference/sharding.py). (a) and (b) put every shard on
# card 0 (mesh_devices=["cuda:0"] * n): the card holds the blocks of every
# shard, so the times below hold bits and bytes, not cross-card latency.
MS_MESHES = ("tp2", "fsdp2xtp2")  # (a)
MS_ROWS = (2, 8, 5)  # (a): the requests held against the single engine's
MS_TIMED = 5  # (a): full-batch requests timed on the wire, each mesh
MS_PROMPTS, MS_NEW = 4, 32  # (b): prompts decoded together, then alone
# (b): where two meshes' greedy bf16 tokens part, the gap between their
# logits, of the row's max |logit|: phase 6's bf16 near-tie
MS_NEAR_TIE = TIE["bfloat16"]
MS_RANK_ROWS = (2, 1)  # (c): a rank's requests (bucket 2 and 1)
MS_RANK_BATCH = 2  # (c): the rank engines' max_batch_size
MS_CARD = "cuda:0"  # the device every shard of (a) and (b) lives on (a CPU rehearsal: "cpu")


def ms_rel_err(got, want):
    """max |got - want| over max(1, max |want|), float64, per output pair."""
    return max(float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())
               / max(1.0, float(np.abs(np.asarray(b, np.float64)).max()))
               for a, b in zip(got, want))


def ms_serve(torch, fa, mods, card, prefix, vocab):
    """Phase 27 (a) (module docstring): ``prefix`` is phase 18's seed-0
    BERT-base save at [None, DEPLOY_SEQ]."""
    (jit, serve_model, wire_spec, sharding, ledger) = mods
    t_phase = time.perf_counter()
    rng = np.random.RandomState(27)
    reqs = [rng.randint(0, vocab, (rows, DEPLOY_SEQ)).astype(np.int32) for rows in MS_ROWS]
    full = rng.randint(0, vocab, (DEPLOY_BATCH, DEPLOY_SEQ)).astype(np.int32)
    params = [p.detach() for p in jit.load(prefix, device="cpu").parameters()]
    whole = sum(p.numel() * p.element_size() for p in params)
    runs, bad = {}, []
    for mesh in ("single",) + MS_MESHES:
        m = sharding.ServingMesh.parse(mesh)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()  # what the card held before this server
        ledger.LEDGER.reset()
        t = time.perf_counter()
        srv = serve_model(prefix, dynamic_batching=True, max_batch_size=DEPLOY_BATCH,
                          mesh=mesh, mesh_devices=None if m.is_single else [MS_CARD] * m.n_shards,
                          watchdog_interval=0)
        try:
            up_s = time.perf_counter() - t
            k0 = fa.launches
            replies = []
            for x in reqs:
                status, outs, _ = _served(srv.port, wire_spec, x)
                if status != 0:
                    bad.append(f"(a) {mesh}: a {x.shape[0]}-row request answered status {status}")
                replies.append(outs)
            before = _stats(wire_spec, srv.port)
            ms = []
            for _ in range(MS_TIMED):
                status, outs, one = _served(srv.port, wire_spec, full)
                if (status != 0 or len(outs) != len(replies[0])
                        or any(o.shape[0] != DEPLOY_BATCH for o in outs)):
                    bad.append(f"(a) {mesh}: a timed {DEPLOY_BATCH}-row request answered "
                               f"status {status}")
                ms.append(one)
            k1 = fa.launches - k0
            stats = _stats(wire_spec, srv.port)
            timed_batches = (sum(b["batches"] for rows in stats["buckets"].values() for b in rows)
                             - sum(b["batches"] for rows in before["buckets"].values()
                                   for b in rows))
            if timed_batches < MS_TIMED:
                bad.append(f"(a) {mesh}: the {MS_TIMED} timed requests ran {timed_batches} "
                           "batches")
            health = json.loads(_call(srv.port, wire_spec.build_request(wire_spec.CMD_HEALTH))[1])
            peak = torch.cuda.max_memory_allocated() - base
        finally:
            srv.stop(drain=False)
            del srv
        buckets = [b for rows in stats["buckets"].values() for b in rows]
        calls = sum(b["program_calls"] or 0 for b in buckets)
        events = ledger.LEDGER.events("serving/")
        runs[mesh] = dict(replies=replies, ms=_median(ms), k1=k1, calls=calls,
                          batches=sum(b["batches"] for b in buckets), peak=peak, up_s=up_s,
                          per_shard=m.per_shard_bytes(params),
                          tags=sorted({str(e.get("mesh")) for e in events}),
                          keys=sorted(e["key"] for e in events), stats_mesh=stats["mesh"],
                          health_mesh=health["engine"]["mesh"])
        if stats["mesh"] != mesh or health["engine"]["mesh"] != mesh:
            bad.append(f"(a) {mesh}: cmd-5 reports mesh {stats['mesh']!r}, cmd-3 "
                       f"{health['engine']['mesh']!r}")
        want_tags = ["None"] if m.is_single else [mesh]
        if runs[mesh]["tags"] != want_tags or not events:
            bad.append(f"(a) {mesh}: the ledger's bucket events carry the tags "
                       f"{runs[mesh]['tags']}, not {want_tags}")
        if k1 != 12 * calls or calls != runs[mesh]["batches"] or not calls:
            bad.append(f"(a) {mesh}: {k1} K1 launches over {calls} program calls of "
                       f"{runs[mesh]['batches']} batches (12 a batch wanted)")
    single = runs["single"]
    for mesh in MS_MESHES:
        r = runs[mesh]
        r["err"] = max(ms_rel_err(g, w) for g, w in zip(r["replies"], single["replies"]))
        r["bitwise"] = [_bitwise(g, w) for g, w in zip(r["replies"], single["replies"])]
        if not r["err"] <= sharding.SHARDED_FLOAT_TOL:
            bad.append(f"(a) {mesh}: replies {r['err']:.3e} of the single engine's (tolerance "
                       f"{sharding.SHARDED_FLOAT_TOL})")
    for mesh, r in runs.items():
        log(f"[meshed] (a) BERT-base f32 behind serve_model(mesh={mesh!r}) on the wire: up in "
            f"{r['up_s']:.1f} s; weights {r['per_shard'] / 2**20:.1f} MiB a shard of "
            f"{whole / 2**20:.1f} MiB; peak {r['peak'] / 2**30:.2f} GiB over what the card held "
            f"before; a {DEPLOY_BATCH}-row "
            f"request {r['ms']:.2f} ms (median of {MS_TIMED}, host clock on the wire); K1 "
            f"{r['k1']} launches over {r['calls']} program calls; ledger {r['keys']} tagged "
            f"{r['tags']}; cmd-3/5 mesh {r['health_mesh']}/{r['stats_mesh']}"
            + ("" if mesh == "single" else f"; replies {r['err']:.3e} of the single engine's, "
               f"bitwise {r['bitwise']}") + f" [{card}]")
    if bad:
        fail("phase 27 (a): " + "; ".join(bad))
    log(f"[meshed] (a) took {time.perf_counter() - t_phase:.1f} s")
    return dict(launches=sum(r["k1"] for r in runs.values()),
                runs={k: {f: v for f, v in r.items() if f != "replies"} for k, r in runs.items()},
                whole_bytes=whole)


def ms_decode(torch, fa, mods, card, dm, n_layers):
    """Phase 27 (b) (module docstring): ``dm`` is phase 7's
    llama_decode_model over its bf16 Llama-2-7B-width model."""
    (generation, DecodeEngine, sharding) = mods
    t_phase = time.perf_counter()
    rng = np.random.RandomState(270)
    vocab = dm.vocab_size
    prompts = [rng.randint(0, vocab, (int(n),)).astype(np.int32)
               for n in rng.randint(16, ENGINE_PROMPT + 1, MS_PROMPTS)]
    kw = dict(max_prompt_len=ENGINE_PROMPT, min_seq_bucket=ENGINE_CHUNK, prefix=False,
              watchdog_interval=0, device=MS_CARD)
    runs, bad = {}, []
    whole = sum(p.numel() * p.element_size() for _, p in dm.params.named_tensors())
    for mesh in ("single", "tp2"):
        m = sharding.ServingMesh.parse(mesh)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()  # phase 7's weights among it
        t = time.perf_counter()
        eng = DecodeEngine(dm, mesh=mesh, name=f"meshed-{mesh}",
                           mesh_devices=None if m.is_single else [MS_CARD] * m.n_shards, **kw)
        try:
            eng.warmup()
            up_s = time.perf_counter() - t
            st0 = eng.stats()
            k0 = fa.launches
            reqs = [eng.submit(p, max_new_tokens=MS_NEW) for p in prompts]
            together = [r.result(timeout=600).tolist() for r in reqs]
            alone = [eng.generate(p, max_new_tokens=MS_NEW, timeout=600).tolist()
                     for p in prompts]
            st = eng.stats()
            k1 = fa.launches - k0
            replay = eng._programs[eng._step_key]
            step_ms = one_call_device_ms(torch, replay)
            del replay
            peak = torch.cuda.max_memory_allocated() - base
            # every stream teacher-forced on the single mesh's tokens, through
            # this engine's weights (its mesh's products): the logits of each
            # of its MS_NEW tokens, held below past the point where the
            # engines' own streams part
            forced = [generation.llama_sequence_logits(
                eng._model, np.concatenate([p, np.asarray(t[:-1], np.int32)]), p.size - 1).cpu()
                for p, t in zip(prompts, (runs.get("single") or {}).get("together", together))]
        finally:
            eng.close()
            del eng
        fills = st["prefix_fill_steps"] - st0["prefix_fill_steps"]
        steps = st["steps"] - st0["steps"]
        runs[mesh] = dict(together=together, alone=alone, k1=k1, fills=fills, steps=steps,
                          forced=forced,
                          step_ms=step_ms, peak=peak, up_s=up_s, stats_mesh=st["mesh"],
                          per_shard=m.per_shard_bytes(
                              [p for _, p in dm.params.named_tensors()]))
        if together != alone:
            bad.append(f"(b) {mesh}: prompts decoded together differ from each alone")
        if k1 != n_layers * (fills + steps) or st["k1_launches"] - st0["k1_launches"] != k1:
            bad.append(f"(b) {mesh}: {k1} K1 launches for {fills} fill replays and {steps} "
                       f"steps at depth {n_layers}")
        if st["mesh"] != mesh:
            bad.append(f"(b) {mesh}: stats report mesh {st['mesh']!r}")
    parts = []  # (token index, gap of the logits' max) where a stream parts
    for p, got, want in zip(prompts, runs["tp2"]["together"], runs["single"]["together"]):
        for i, (a, b) in enumerate(zip(got, want)):
            if a != b:
                logits = generation.llama_prompt_logits(dm, np.concatenate(
                    [p, np.asarray(want[:i], np.int32)]))
                gap = abs(float(logits[a] - logits[b])) / float(logits.abs().max())
                parts.append((i, gap))
                if not gap <= MS_NEAR_TIE:
                    bad.append(f"(b) tp2 parts from the single mesh at token {i} of a "
                               f"{p.size}-token prompt by {gap:.3e} of the logits' max")
                break
    # the whole streams, teacher-forced: at each of the 4 x MS_NEW positions
    # tp2's logits within TOL_GEN_LOGITS of the single mesh's (of the row's
    # max |logit|), and tp2's top token the single mesh's or a near-tie
    forced_err, forced_ties = 0.0, []
    for p, want, lt_all, ls_all in zip(prompts, runs["single"]["together"],
                                       runs["tp2"]["forced"], runs["single"]["forced"]):
        for i, (b, lt, ls) in enumerate(zip(want, lt_all, ls_all)):
            top = float(ls.abs().max())
            err = float((lt - ls).abs().max()) / top
            forced_err = max(forced_err, err)
            a = int(lt.argmax())
            gap = abs(float(ls[a] - ls[b])) / top if a != b else 0.0
            if a != b:
                forced_ties.append((i, gap))
            if not (err <= TOL_GEN_LOGITS["bfloat16"] and gap <= MS_NEAR_TIE):
                bad.append(f"(b) teacher-forced token {i} of a {p.size}-token prompt: tp2's "
                           f"logits {err:.3e} of the single mesh's max (tolerance "
                           f"{TOL_GEN_LOGITS['bfloat16']}), top token {a} vs {b} by {gap:.3e}")
    n_forced = sum(len(t) for t in runs["single"]["together"])
    for mesh, r in runs.items():
        log(f"[meshed] (b) Llama-2-7B width, depth {n_layers}, bf16, DecodeEngine(mesh="
            f"{mesh!r}), {dm.max_slots} slots x {dm.max_seq_len}: warmup (captures; the "
            f"weights digest where not yet taken) {r['up_s']:.1f} s; "
            f"weights {r['per_shard'] / 2**30:.2f} GiB a shard of {whole / 2**30:.2f} GiB; peak "
            f"{r['peak'] / 2**30:.2f} GiB over what the card held before (phase 7's weights); "
            f"a step replay {_fmt(r['step_ms'])} ms device; K1 "
            f"{r['k1']} = {n_layers} x ({r['fills']} fills + {r['steps']} steps); together = "
            f"alone bitwise {r['together'] == r['alone']}; stats mesh {r['stats_mesh']} [{card}]")
    log(f"[meshed] (b) tp2 vs single: {MS_PROMPTS} streams of {MS_NEW} tokens, {len(parts)} "
        "part(s) (token, the two tokens' logit gap of the max): "
        + (", ".join(f"({i}, {g:.2e})" for i, g in parts) or "none")
        + f", each a near-tie ({MS_NEAR_TIE}): {all(g <= MS_NEAR_TIE for _, g in parts)}; "
        f"teacher-forced on the single mesh's tokens, all {n_forced} positions: tp2's logits "
        f"at most {forced_err:.3e} of the row's max (tolerance {TOL_GEN_LOGITS['bfloat16']}), "
        f"{len(forced_ties)} top token(s) differ: "
        + (", ".join(f"({i}, {g:.2e})" for i, g in forced_ties) or "none")
        + f" ({time.perf_counter() - t_phase:.1f} s)")
    if bad:
        fail("phase 27 (b): " + "; ".join(bad))
    return dict(launches=sum(r["k1"] for r in runs.values()),
                runs={k: {f: v for f, v in r.items() if f not in ("together", "alone", "forced")}
                      for k, r in runs.items()}, parts=parts, whole_bytes=whole,
                forced_err=forced_err, forced_ties=forced_ties, n_forced=n_forced)


def ms_rank(torch, mods, rank, out):
    """Phase 27 (c) in one of phase 23's ranks: rank 0 saves a seed-0
    BERT-base at [None, DEPLOY_SEQ]; both ranks serve it through a tp2
    BatchingEngine over the rank backing (one shard a rank, the products'
    all_gathers over gloo, eagerly) in lockstep; rank 0 then serves the same
    requests through a single engine and compares."""
    (BertModel, jit, InputSpec, BatchingEngine, sharding, dist, fa) = mods
    t0 = time.perf_counter()
    prefix = os.path.join(out, "ms_bert")
    if rank == 0:
        model = BertModel(device="cuda", generator=torch.Generator().manual_seed(0)).eval()
        jit.save(model, prefix, input_spec=[InputSpec([None, DEPLOY_SEQ], "int32")])
        del model
    dist.barrier()
    layer = jit.load(prefix, device="cpu")  # the blocks go to the card, the rest stays
    whole = sum(p.numel() * p.element_size() for p in layer.parameters())
    vocab = next(p.shape[0] for p in layer.parameters()
                 if p.param_name == "embeddings.word_embeddings.weight")
    rng = np.random.RandomState(271)
    reqs = [rng.randint(0, vocab, (rows, DEPLOY_SEQ)).astype(np.int32) for rows in MS_RANK_ROWS]
    k0 = fa.launches
    eng = BatchingEngine.for_layer(layer, mesh="tp2", max_batch_size=MS_RANK_BATCH,
                                   watchdog_interval=0, name=f"ms-rank{rank}")
    del layer
    held = sum(w.nbytes_here() if hasattr(w, "nbytes_here") else w.numel() * w.element_size()
               for w in eng._runner._layer._weights)
    try:
        eng.warmup()
        t = time.perf_counter()
        meshed = [eng.infer([x], timeout=600) for x in reqs]
        ms = (time.perf_counter() - t) * 1e3 / len(reqs)
        stats = eng.stats()
        devices = eng._runner.mesh_devices
    finally:
        eng.close()
    res = dict(mesh=stats["mesh"], devices=devices, k1=fa.launches - k0,
               calls=sum(b["program_calls"] or 0 for rows in stats["buckets"].values()
                         for b in rows) + len(eng.declared_buckets()),
               held_bytes=held, whole_bytes=whole, ms=ms)
    if rank == 0:
        single = BatchingEngine.for_layer(jit.load(prefix), max_batch_size=MS_RANK_BATCH,
                                          watchdog_interval=0, name="ms-rank-single")
        try:
            single.warmup()
            want = [single.infer([x], timeout=600) for x in reqs]
        finally:
            single.close()
        res["err"] = max(ms_rel_err(g, w) for g, w in zip(meshed, want))
        res["bitwise"] = [_bitwise(g, w) for g, w in zip(meshed, want)]
        res["tol"] = sharding.SHARDED_FLOAT_TOL
    res["seconds"] = time.perf_counter() - t0
    return res


def ms_ranks_check(ranks, card):
    """Phase 27 (c)'s checks on what the ranks returned."""
    r0, r1 = (r["meshed_serving"] for r in ranks)
    bad = []
    if not r0["err"] <= r0["tol"]:
        bad.append(f"rank 0's replies {r0['err']:.3e} of its single engine's")
    for r in (r0, r1):
        if r["mesh"] != "tp2" or "rank" not in str(r["devices"]):
            bad.append(f"a rank served mesh {r['mesh']!r} over {r['devices']}")
        if r["k1"] != 12 * r["calls"]:
            bad.append(f"a rank made {r['k1']} K1 launches over {r['calls']} program calls")
        if not r["held_bytes"] < r["whole_bytes"]:
            bad.append(f"a rank holds {r['held_bytes']} weight bytes of {r['whole_bytes']}")
    log(f"[meshed] (c) BERT-base f32 under tp2 over two launcher ranks (gloo, eager): rank 0's "
        f"replies {r0['err']:.3e} of its single engine's, bitwise {r0['bitwise']}; a rank holds "
        f"{r0['held_bytes'] / 2**20:.1f} / {r1['held_bytes'] / 2**20:.1f} MiB of "
        f"{r0['whole_bytes'] / 2**20:.1f} MiB; a request {r0['ms']:.1f} ms (host clock, the "
        f"gathers through the host); K1 {r0['k1']} + {r1['k1']} launches over {r0['calls']} + "
        f"{r1['calls']} program calls; rank 0's phase {r0['seconds']:.1f} s [{card}]")
    if bad:
        fail("phase 27 (c): " + "; ".join(bad))
    return dict(launches=r0["k1"] + r1["k1"], err=r0["err"], bitwise=r0["bitwise"])


def meshed_serving_alone(torch, fa, mods, card):
    """``--meshed-serving``: phase 27 (a) and (b) over models of their own:
    a seed-0 BERT-base save and a seed-0 Llama-2-7B-width bf16 model of
    LLAMA_LAYERS layers (phase 7's construction)."""
    (jit, serve_model, wire_spec, sharding, ledger, generation, DecodeEngine, BertModel,
     LlamaModel, InputSpec) = mods
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="paddle_tpu_torch_meshed_")
    try:
        model = BertModel(device="cuda", generator=torch.Generator().manual_seed(0)).eval()
        prefix = os.path.join(tmp, "bert")
        jit.save(model, prefix, input_spec=[InputSpec([None, DEPLOY_SEQ], "int32")])
        vocab = model.vocab_size
        del model
        a = ms_serve(torch, fa, (jit, serve_model, wire_spec, sharding, ledger), card, prefix,
                     vocab)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    model = LlamaModel(num_layers=LLAMA_LAYERS, device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(0))
    model.to(torch.bfloat16).eval()
    dm = generation.llama_decode_model(model, ENGINE_SLOTS, ENGINE_SEQ)
    b = ms_decode(torch, fa, (generation, DecodeEngine, sharding), card, dm, len(model.layers))
    return a, b


def stop_children(grace=5.0):
    """End the processes this one started that are still alive at the end,
    each logged with its command line: the script leaves none running.
    multiprocessing's resource tracker is left to exit with this process
    (it unlinks what it tracks when its pipe closes). Returns their pids."""
    me = str(os.getpid())
    kids = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/stat") as f:
                if f.read().rsplit(")", 1)[1].split()[1] != me:
                    continue
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace").strip()
        except (OSError, IndexError):
            continue
        if "multiprocessing.resource_tracker" in cmd:
            continue
        kids.append(int(pid))
        log(f"[cleanup] pid {pid} still running at the end: {cmd[:200]}")
        try:
            os.kill(int(pid), signal.SIGTERM)
        except OSError:
            pass
    deadline = time.time() + grace
    for pid in kids:
        try:
            while not os.waitpid(pid, os.WNOHANG)[0]:
                if time.time() > deadline:
                    os.kill(pid, signal.SIGKILL)
                    os.waitpid(pid, 0)
                    break
                time.sleep(0.1)
        except OSError:
            pass
    return kids


def depth_sweep(torch, fa, mods, card, depths):
    """``--depth-sweep D1,D2,...``: phases 6-10 (generation, the engine,
    reuse, speculation, faults) at each depth of the 7B in turn, every
    check held, in one process on one host; their seconds at each depth
    in one JSON line at the end."""
    global LLAMA_LAYERS

    serving_mods, gen_mods, eng_mods, robust_mods = mods
    bert = phase_serving(torch, fa, serving_mods)["model"]
    rows = []
    for depth in depths:
        LLAMA_LAYERS = depth
        t0 = time.perf_counter()
        gen = phase_generation(torch, fa, gen_mods, card)
        eng = phase_engine(torch, fa, eng_mods, card, gen)
        phase_reuse(torch, fa, eng_mods[1:], card, eng)
        phase_spec(torch, fa, eng_mods[1:], card, eng)
        phase_robust(torch, fa, robust_mods, card, eng, bert)
        rows.append(dict(depth=depth, seconds=time.perf_counter() - t0))
        log(f"[depth sweep] phases 6-10 at depth {depth}: {rows[-1]['seconds']:.1f} s [{card}]")
        del gen, eng
        gc.collect()
        torch.cuda.empty_cache()
    log(json.dumps({"depth_sweep": rows, "card": card}))


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
    leaves_alone = sys.argv[1:] == ["--leaves"]
    dp_alone = sys.argv[1:] == ["--dp"]
    meshed_alone = sys.argv[1:] == ["--meshed-serving"]
    if len(sys.argv) > 1 and sys.argv[1] == "--decode-replica":
        return decode_replica(sys.argv[2:])
    if len(sys.argv) > 1 and sys.argv[1] == "--dp-rank":
        return dp_rank(sys.argv[2:])
    if len(sys.argv) > 1 and not (leaves_alone or dp_alone or meshed_alone):
        if len(sys.argv) != 3 or sys.argv[1] not in ("--fill-sweep", "--depth-sweep"):
            fail("usage: chip_smoke.py [--fill-sweep C1,C2,... | --depth-sweep D1,D2,... | "
                 "--leaves | --dp | --meshed-serving | "
                 "--decode-replica PORTFILE PHASE PREFIX_DIR | --dp-rank OUT]")
        sweep = [int(c) for c in sys.argv[2].split(",")]
    # a failed check ends the run through sys.exit: the processes it started
    # (the pods of phases 23-26, replicas, the NMS forkserver) end with it
    atexit.register(stop_children)
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
        from paddle_tpu_torch.inference import fleet as fleet_mod
        from paddle_tpu_torch.inference import router as router_mod
        from paddle_tpu_torch.inference import wire_spec
        from paddle_tpu_torch.inference.batching import BatchingEngine
        from paddle_tpu_torch.inference.decode import DecodeEngine
        from paddle_tpu_torch.inference.server import PredictorServer
        from paddle_tpu_torch.ops import flash_attention as fa
        from paddle_tpu_torch.ops import quant_matmul as qmm
        from paddle_tpu_torch.resilience import chaos
        from paddle_tpu_torch.text import generation
        from paddle_tpu_torch.text.models import (BertEmbeddings, BertForPretraining, BertModel,
                                                  LlamaModel)
        import paddle_tpu_torch as paddle
        from paddle_tpu_torch import inference, jit, vision
        from paddle_tpu_torch.inference.server import serve_model
        from paddle_tpu_torch.quantization.serving import ACCURACY_BOUNDS
        from paddle_tpu_torch.static import InputSpec
        from paddle_tpu_torch import onnx as ponnx
        from paddle_tpu_torch.obs import goodput
        from paddle_tpu_torch import resilience
        from paddle_tpu_torch import distribution, utils
        from paddle_tpu_torch.incubate import autograd as incubate_autograd
        from paddle_tpu_torch.vision import ops as vision_ops
        import paddle_tpu_torch.distributed as pdist
        from paddle_tpu_torch.distributed import launch_mod, parallel, topology
        from paddle_tpu_torch.inference import sharding as psharding
        from paddle_tpu_torch.obs import ledger as pledger
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
    if not (dp_alone or sweep or meshed_alone):
        start_nms_server()  # its import overlaps the phases before 22
    leaves_mods = (paddle, vision_ops, LlamaModel, generation, DecodeEngine, quantization, utils,
                   distribution, incubate_autograd)
    dp_mods = (BertForPretraining, nn, optimizer, spmd, prandom, paddle, pdist, launch_mod,
               parallel, topology, vision, BertEmbeddings, LlamaModel)
    if leaves_alone:
        phase_leaves(torch, fa, qmm, leaves_mods, card)
        took("leaves")
        stop_children()
        return
    if dp_alone:
        phase_dp(torch, fa, dp_mods, card)
        took("dp")
        stop_children()
        return
    if meshed_alone:
        meshed_serving_alone(torch, fa, (jit, serve_model, wire_spec, psharding, pledger,
                                         generation, DecodeEngine, BertModel, LlamaModel,
                                         InputSpec), card)
        took("meshed serving")
        return
    if sweep and sys.argv[1] == "--depth-sweep":
        depth_sweep(torch, fa, (
            (BertModel, BatchingEngine, PredictorServer, wire_spec),
            (LlamaModel, generation, prandom, Graph, pool_bytes),
            (LlamaModel, generation, DecodeEngine, PredictorServer, wire_spec),
            (generation, DecodeEngine, BatchingEngine, PredictorServer, wire_spec, chaos, obs)),
            card, sweep)
        took("depth sweep")
        stop_children()
        return
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
    # phase 27 (b) on phase 7's bf16 7B, before it goes
    ms_b = ms_decode(torch, fa, (generation, DecodeEngine, psharding), card, eng["dm"],
                     len(eng["model"].layers))
    took("meshed serving (b)")
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
    import shutil
    import tempfile

    # phases 23-26's pods start here and run beside phases 18-19 (and 20's
    # start when a slow host stretches them); phase_dp collects them
    gc.collect()
    torch.cuda.empty_cache()
    dp_started = dp_start(torch, fa, launch_mod)
    # while the ranks run, this process may fill at most DP_PARENT_SHARE of
    # the card: phase 19 (e)'s batch probe grows until an allocation fails,
    # and a rank allocating at that moment would fail with it
    torch.cuda.set_per_process_memory_fraction(DP_PARENT_SHARE)
    took("dp start")
    saves = tempfile.mkdtemp(prefix="paddle_tpu_torch_deploy_")
    try:
        deploy = phase_deploy(torch, fa, qmm, (paddle, jit, inference, serve_model, InputSpec,
                                               BertForPretraining, BertModel, nn, optimizer,
                                               vision, wire_spec, ACCURACY_BOUNDS),
                              card, dyg, vis, saves)
        took("deploy")
        static = phase_static(torch, fa, (paddle, BertModel, vision, inference, ponnx,
                                          InputSpec, spmd, optimizer, nn), card, vis)
        took("static")
        fleet = phase_fleet(torch, (inference, fleet_mod, router_mod, wire_spec, goodput),
                            card, deploy)
        took("fleet")
        ms_a = ms_serve(torch, fa, (jit, serve_model, wire_spec, psharding, pledger), card,
                        deploy["saves"][0], deploy["vocab"])
        took("meshed serving (a)")
    finally:
        shutil.rmtree(saves, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    safety = phase_safety(torch, fa, (paddle, BertForPretraining, LlamaModel, nn, optimizer, spmd,
                                      prandom, resilience), card, dyg, lm)
    took("safety")
    gc.collect()
    torch.cuda.empty_cache()
    leaves = phase_leaves(torch, fa, qmm, leaves_mods, card)
    took("leaves")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.set_per_process_memory_fraction(1.0)
    dp = phase_dp(torch, fa, dp_mods, card, one_rank_ms=train["step_ms"], started=dp_started)
    took("dp")
    ms_c = dp["meshed_serving"]
    log("[meshed] phase 27: (a) " + ", ".join(
        f"{m} {r['ms']:.2f} ms a {DEPLOY_BATCH}-row reply, {r['per_shard'] / 2**20:.1f} MiB a "
        f"shard, peak +{r['peak'] / 2**30:.2f} GiB" for m, r in ms_a["runs"].items())
        + "; (b) " + ", ".join(f"{m} step {_fmt(r['step_ms'])} ms device, "
                               f"{r['per_shard'] / 2**30:.2f} GiB a shard, peak "
                               f"+{r['peak'] / 2**30:.2f} GiB" for m, r in ms_b["runs"].items())
        + f", tp2 teacher-forced logits {ms_b['forced_err']:.3e} of the single's over "
        f"{ms_b['n_forced']} positions"
        + f"; (c) rank 0 {ms_c['err']:.3e} of the single engine [{card}]")

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
    # this slice's fp16 forms: K1-K3 at BERT-base's fp16 O1 training shape,
    # [64 * 12, 128, 64] with dropout 0.1 (phase 21 (b)), with the launches
    # its timed steps made in that form
    f16_fwd, f16_bwd = (next(r for r in rows if r["dtype"] == "float16" and r["b"] == 64
                             and r["h"] == 12 and r["p"] == 0.1) for rows in (cases, bwd_cases))
    # phase 25's forms and the launches its modes made in each
    mpar = dp["model_parallel"]

    def mp_form(r):
        return r["name"] if r["name"] in ("tp", "pp") else f"{r['name']}_{r['dtype']}"

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
                       + mtt["parity_counts"][0] + dyg["counts"]["fwd"] + dyg["extra"][0]
                       + deploy["launches"][0] + static["launches"][0] + fleet["launches"]
                       + safety["launches"][0] + leaves["k1_launches"] + dp["counts"][0]
                       + dp["meshed"]["counts"][0] + mpar["counts"][0] + ms_a["launches"]
                       + ms_b["launches"] + ms_c["launches"]),
             # phase 27's: (a) the served BERT-base's batches under each mesh
             # (single too), (b) the 7B engines' fills and steps (single and
             # tp2), (c) both ranks' program calls
             meshed_serving_launches=ms_a["launches"] + ms_b["launches"] + ms_c["launches"],
             # phase 23's: both ranks' (a) O0, (b) O1 and (c) eager steps
             dp_launches=dp["counts"][0],
             # phase 24's: both ranks' every mode (FSDP's recompute twice a layer)
             meshed_launches=dp["meshed"]["counts"][0],
             # phase 25's: both ranks' (a) tensor-parallel, (b) pipeline and
             # (c) ring calls
             model_parallel_launches=mpar["counts"][0],
             # phase 22's: the flat-list quantized 7B-width model's fills and
             # steps (float32, head_dim 128)
             leaves_launches=leaves["k1_launches"],
             # phase 21's: its fp16 dygraph steps, guarded steps and Llama steps
             safety_launches=safety["launches"][0],
             # phase 20's: in its replica processes, from their cmd-5 stats
             # (the BERT replicas' batches, 12 a program call; the 7B
             # replicas' fills and steps, 32 each)
             fleet_launches=fleet["launches"],
             # phase 19's: the static programs' builds and Executor.run
             # steps, the saved program's Predictor.run, the ONNX check's
             # live forward
             static_launches=static["launches"][0],
             # phase 18's: through the loaded programs (Predictor.run, the
             # servers, the w8 save) and the to_static steps' captured ones
             deploy_launches=deploy["launches"][0],
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
             **fields(mt_cross[0], "mt_train_cross_bf16_", launches=mt_form["cross"]["fwd"]),
             **fields(f16_fwd, "bert_train_f16_", launches=safety["forms"]["fwd"]),
             # phase 23: a rank's [32 * 12, 128, 64] with dropout 0.1 and
             # bh_offset 384, float32 (O0) and bfloat16 (O1)
             **{k: v for r in dp["cases"] for k, v in fields(
                 r, f"dp_{r['dtype']}_", bh_offset=r["bh_offset"],
                 slice_bitwise=r["slice_bitwise"]).items()},
             # phase 25: (a)'s head group, (b)'s stage, (c)'s ring blocks,
             # each with the launches of its mode in that form
             **{k: v for r in mpar["cases"] for k, v in fields(
                 r, f"mp_{r['name']}_{r['dtype']}_",
                 launches=mpar["forms"][mp_form(r)][0]).items()}),
        *(dict(name=kernels[i]["name"], route="cuda", source=kernels[i]["source"],
               replaces=kernels[i]["replaces"],
               launches=(train["counts"][key] + lm_launch[key] + lm["parity_counts"][i]
                         + mtt["counts"][key] + mtt["parity_counts"][i] + dyg["counts"][key]
                         + dyg["extra"][i] + deploy["launches"][i] + static["launches"][i]
                         + safety["launches"][i] + dp["counts"][i]
                         + dp["meshed"]["counts"][i] + mpar["counts"][i]),
               dp_launches=dp["counts"][i], meshed_launches=dp["meshed"]["counts"][i],
               model_parallel_launches=mpar["counts"][i],
               **{f"mp_{r['name']}_{r['dtype']}_{k}": v for r in mpar["cases"] for k, v in dict(
                   max_abs_err=r["abs_err_" + which], ms=r["ms_" + which],
                   device_ms=r["device_ms_" + which], plain_ms=r["bwd_plain_ms"],
                   plain_device_ms=r["bwd_plain_device_ms"], library_ms=r["bwd_library_ms"],
                   library_device_ms=r["bwd_library_device_ms"],
                   bound_ms=r["bound_" + which][0], bound_by=r["bound_" + which][1]).items()},
               **{f"mp_{r['name']}_{r['dtype']}_launches": mpar["forms"][mp_form(r)][i]
                  for r in mpar["cases"]},
               # phase 23: a rank's [32 * 12, 128, 64] with dropout 0.1 and
               # bh_offset 384, float32 and bfloat16
               **{f"dp_{r['dtype']}_{k}": v for r in dp["cases"] for k, v in dict(
                   max_abs_err=r["abs_err_" + which], ms=r["ms_" + which],
                   device_ms=r["device_ms_" + which], plain_ms=r["bwd_plain_ms"],
                   plain_device_ms=r["bwd_plain_device_ms"], library_ms=r["bwd_library_ms"],
                   library_device_ms=r["bwd_library_device_ms"],
                   bound_ms=r["bound_" + which][0], bound_by=r["bound_" + which][1]).items()},
               safety_launches=safety["launches"][i],
               # phase 19's: the static programs' Executor.run steps
               static_launches=static["launches"][i],
               # phase 18's: the to_static steps, through K1's registered autograd
               deploy_launches=deploy["launches"][i],
               bert_launches=train["counts"][key], dygraph_launches=dyg["counts"][key],
               **bwd(bmain, which), **bwd(bf32, which, "f32_"),
               **bwd(lm_o1[1], which, "lm_train_bf16_"), lm_train_bf16_launches=lm_launch[key],
               **bwd(lm_o0[1], which, "lm_parity_f32_"),
               lm_parity_f32_launches=lm["parity_counts"][i],
               **bwd(mt_enc[1], which, "mt_train_encoder_bf16_"),
               mt_train_encoder_bf16_launches=mt_form["encoder"][key],
               **bwd(mt_cross[1], which, "mt_train_cross_bf16_"),
               mt_train_cross_bf16_launches=mt_form["cross"][key],
               **bwd(f16_bwd, which, "bert_train_f16_"),
               bert_train_f16_launches=safety["forms"][which])
          for i, key, which in ((1, "bwd_dq", "dq"), (2, "bwd_dkv", "dkv"))),
        dict(name=kernels[3]["name"], route="cuda", source=kernels[3]["source"],
             replaces=kernels[3]["replaces"],
             launches=(quant["wq_launches"] + data["wq_launches"] + deploy["launches"][3]
                       + leaves["wq_launches"]),
             # phase 22 (d): the flat-list model's products, w8 and bf16w
             leaves_launches=leaves["wq_launches"],
             # phase 18 (d): the w8 save's program, 73 a program call
             deploy_launches=deploy["launches"][3],
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
    stop_children()
    atexit.unregister(stop_children)
    log(card)
    log(json.dumps({"kernels": line}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
