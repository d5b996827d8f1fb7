#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ray_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                  # the checks below
    python3 chip_smoke.py --profile        # where the serving time goes
    python3 chip_smoke.py --profile int8   # the same on the int8 cache
    python3 chip_smoke.py --profile train  # where a training step's goes
    python3 chip_smoke.py --profile train-pp   # the same for gpt2-train-pp
                                               # (GPipe, 1F1B) and
    python3 chip_smoke.py --profile train-moe  # gpt2-train-moe
    python3 chip_smoke.py --profile train-stream  # gpt2-train-stream
    python3 chip_smoke.py --profile epilogue  # the epilogue entry points'
                                              # kernels at N = 24576
    python3 chip_smoke.py --profile ce     # the flash-CE entry points'
                                           # kernels at the training shape
    python3 chip_smoke.py --profile spec   # one verify forward and one
                                           # co-batched decode step
    python3 chip_smoke.py --spec           # the speculative-decoding
                                           # phase with every arm
    python3 chip_smoke.py --serve          # the serving-surface phases
                                           # (7b-7e) alone
    python3 chip_smoke.py --fleet          # the serving-fleet phase (7d)
                                           # alone
    python3 chip_smoke.py --runtime        # the runtime phase (7f) alone
    python3 chip_smoke.py --serve-deployment  # the serve deployment
                                              # phase (7g) alone
    python3 chip_smoke.py --train-worker   # the default training arm,
                                           # then gpt2-train-worker (8b)
    python3 chip_smoke.py --train-sharded  # the attention checks at tp's
                                           # heads, the default arm, then
                                           # 8b with gpt2-train-sharded
    python3 chip_smoke.py --train-overlap  # the default arm, then 8b with
                                           # gpt2-train-sharded and
                                           # gpt2-train-overlap (8c), and
                                           # the wire codec (8d)
    python3 chip_smoke.py --train-pp       # the kernels at the -pp and
                                           # -moe shapes, the default
                                           # arm, then 8b with
                                           # gpt2-train-pp (8e) and
                                           # gpt2-train-moe (8f)
    python3 chip_smoke.py --train-stream   # the kernels at the -stream
                                           # shapes, the default arm,
                                           # then gpt2-train-stream and
                                           # the accumulation arm (8g)
    python3 chip_smoke.py --train-dataset  # gpt2-train-dataset (11) alone
    python3 chip_smoke.py --serve-lora     # gpt2-serve-lora (12) alone
    python3 chip_smoke.py --train-lora     # gpt2-train-lora (13) alone
    python3 chip_smoke.py --rl             # the attention kernels at the
                                           # RL learner's S = 20, then the
                                           # RL phases (14) alone
    python3 chip_smoke.py --profile-api    # gpt2-profile (15) alone
    python3 chip_smoke.py --rllib          # the rllib learners (16) alone
    python3 chip_smoke.py --hf             # the GPT-2 exact architecture
                                           # (17) alone
    python3 chip_smoke.py --resnet         # resnet50-train and the
                                           # card-against-CPU arm (18)
    python3 chip_smoke.py --tune           # gpt2-tune (19) alone
    python3 chip_smoke.py --microbenchmark # the microbenchmark path (20)
                                           # alone
    python3 chip_smoke.py --scale-probe    # scale_probe.main (host-side
                                           # runtime scaling), its JSON
    python3 chip_smoke.py --multi-gpu      # on four cards: the pipeline
                                           # (with sp too), MoE and
                                           # sharded-LoRA steps and the
                                           # elastic loop over NCCL
                                           # against one process's
    python3 chip_smoke.py --decode         # the decode checks and times
    python3 chip_smoke.py --edges          # the wgmma tile checks, the
                                           # decode checks, the
                                           # attention, epilogue and
                                           # flash-CE kernels' ragged
                                           # edges, and the width checks
                                           # (small; for compute-sanitizer)

1. Start-up: prints the card (``nvidia-smi`` name and power limit), the
   torch and CUDA versions, and builds the kernels from
   ``ray_tpu_torch/ops/csrc`` with ``nvcc`` (timed), then checks the
   ``wgmma`` variants the kernels build on alone (n64 with MN-major
   operands, n128 K-major and MN-major), each on one tile against the
   plain product.
2. Kernel phase: every kernel of the serving and training paths against
   its plain PyTorch version (computed in f32 on the same inputs) at the
   main paths' shapes, in bf16 and in f32, with its time, the plain
   version's, one PyTorch library call's as a yardstick, and the least
   time the card could take (``bound_ms``): the ten entry points, the
   int8 decode attention and the RMSNorm forward and backward included;
   the out-proj epilogue forward also at a verify forward's N = 2, 3, 5
   and 9 rows.
   The decode kernels padded and paged (``decode_checks``): bf16, f32 and
   int8 at [8, 1024, 12, 64] with lengths 1 to 1024 (split counts 1 to
   8), through a shuffled page table at pages of 128, 16 and 1, NaN past
   each length and in the garbage page, two calls and the two input
   modes bit-identical, outputs between guard bands; then timed at those
   lengths and with every row full, padded and paged, against the
   masked SDPA and ``gather_pages`` + SDPA.
   The attention kernels also at their ragged edges: the prefill forward
   at S = 1, 65 and 200, the training forward and backward at [2, S, 12,
   64] with and without RoPE for S = 20 (the RL learner's), 65 and 200, and two bf16 backward
   calls on the same inputs must agree bit for bit.  The out-proj
   epilogue forward and backward likewise at N = 1, 63, 65 and 200 (K =
   768) and K = 384 and 1536 (N = 200), and at d = 1024 and 1280 (the
   widths of gpt2_medium and gpt2_large), bf16 and f32, inputs between
   NaN guard bands, outputs between -7.0 bands, two bf16 backward calls
   bit-identical.  The flash-CE forward and backward likewise at N = 1,
   63, 65 and 200 against V = 1000 and 50257, with and without the norm
   prologue, at d = 768 (bf16 and f32) and at 1024 and 1280 (bf16).
   The epilogue forward and backward also at the RL learner's N = 8 x 20
   = 160 rows.
   The training kernels also at the shapes of the later training arms
   (bf16, against the plain versions in f32, as extra shapes of their
   rows): the attention pair at a tp rank's 6 and 3 heads
   (``tp_attention_phase``), and the attention pair, the epilogue
   forward and backward and flash-CE forward and backward at a
   gpt2-train-pp microbatch's 6 x 1024 rows and gpt2-train-moe's 4 x
   1024 (``stage_shape_phase``), and the attention pair at
   gpt2-train-dataset's and -lora's 8 x 1024 (``dataset_shape_phase``,
   also run by ``--train-dataset`` and ``--train-lora``).
3. Engine phase (gpt2-serve-mixed): GPT-2 124M (random weights from a
   seed, bf16) serves 16 requests through the paged-KV engine with its
   defaults (prefix caching on; the random prompts share no page, so
   nothing hits); every request must finish, the engine must be
   leak-free, and each kernel's launch count must be what the run
   implies; no decode step may gather the paged context
   (``no_gather_in_decode``).
4. Correctness: two greedy requests' logits against the port's
   teacher-forced ``forward`` on the CPU in f32 over the same weights.
5. Engine phase gpt2-serve-int8-prefix: the same model with the int8 KV
   cache serves 16 requests behind 4 shared 512-token system prompts;
   exactly 12 hit the prefix cache, decode runs the int8 kernel only.
6. int8 correctness: a cold and a prefix-hit greedy request on the int8
   engine against the f32 teacher-forced reference, and against each
   other.
7. The RMSNorm kernels (``gpt._PALLAS_NORM``, ``RAY_TPU_PALLAS_NORM=1``)
   in serving: the correctness phase again, with exact norm launches.
7a. Speculative decoding (gpt2-serve-spec, ``spec_phase``): the JAX
   package's spec bench (2 slots, page 16, 4 requests of 256 new tokens,
   the bench's 512 halved, one at a time, greedy; a templated and a
   random mix) with spec off
   and spec_k = 4 (``--spec``: 2, 4 and 8), each arm printing decode
   tokens/s, its speedup, the accept rate and histogram, verify calls
   and ms, decode dispatches and inter-token gaps; every stream equal to
   the off arm's but after a near-tie.  Then spec greedy requests'
   logits, verify rows included, against the f32 reference (bf16 and
   int8), and the serving geometry (8 slots, page 128, 8 templated
   requests half sampled) with spec on for all, half and none of them,
   in bf16 and int8.  Every run: all requests finish, leak-free, no
   drafter state left (also after ``drain_requests``), exact launches
   (the epilogue 12 per verify, decode attention 12 per decode
   dispatch), no decode step gathers.
7b. Disaggregated serving (gpt2-serve-disagg, ``disagg_phase``): a
   prefill engine and a decode engine (8 slots, page 128 each) serve
   gpt2-serve-mixed's 16 requests: a first-token-stop submission with
   ``hold_pages``, ``export_request`` as each finishes, ``import_submit``
   of the remaining 31 tokens; bf16 and the int8 cache.  Every stream
   equal to a co-located engine's, token for token; each handoff
   bit-equal to the exporter's pages, each install to its handoff at the
   context's positions; ``nbytes`` the per-page figure times the pages
   (int8 at most 0.55x bf16); exact launches (the exporter 12 prefill
   attentions per request and no decode, the importer 12 decode
   attentions per decode step and nothing else); importer telemetry
   equal to its counters; one sampled request traced across the handoff
   as one gap-free tree; both engines leak-free with nothing held; then
   a warm import of a whole-page context the importer holds by digest
   (nothing moves, same stream).  Prints ``disagg metrics {...}``.
7c. The tiered KV cache (gpt2-serve-tiers, ``tiers_phase``):
   gpt2-serve-int8-prefix's 16 requests in 8 waves of the 2 requests
   behind one system prompt, twice round the 4 prompts, on 10 usable
   pages with a 16-page host pool and a page store, against an engine
   that keeps every page resident; arms bf16 with the model-dtype spill
   and the int8 cache (streams equal the resident engine's, promoted
   requests included) and bf16 with the int8 spill (promoted greedy
   logits within ``INT8_TOL`` of the f32 reference).  16 promoted pages,
   spill bytes the per-page figure times the spills, exact launches,
   telemetry equal to the counters, leak-free, no fetch in flight.
   Prints ``tiers metrics {...}``.
7d. The serving fleet (gpt2-serve-fleet, ``fleet_phase``): 3 replicas of
   the serving engine (8 slots, page 128) on the card, on the main run's
   parameter tensors, behind ``ray_tpu_torch.fleet``.  Arm 1:
   -int8-prefix's traffic in bf16 in two waves through ``FleetRouter``
   with affinity on (12 hits, 4 cold prefills) and off.  Arm 2:
   -mixed's 16 greedy requests with ``serve.replica@16`` killing a
   replica mid-decode; its streams fail over (32 tokens each, none
   twice), the ``Reconciler`` restarts it (WEDGED -> RESTARTING ->
   RUNNING) and ``memory_allocated`` comes back once the corpse is
   dropped.  Arm 3: the same traffic polled sequentially and with
   ``concurrent_steps``.  Arm 4: a ``serve.tick[<id>]`` slowdown on the
   first request's replica under the concurrent poll with demotion and
   hedging on: the slow replica demoted, every hedge resolved once.  Arm
   5: ``DisaggRouter`` with a prefill pool of 1 and a decode pool of 2,
   bf16 and int8, then a warm request that moves 0 bytes.  Every stream
   whose path (cold or hit, the page producer, the kernels) matches a
   one-engine run equals it token for token, sampled ones included; a
   greedy stream whose path changed may part only below the f32
   reference's 2 x 0.09 margin; exact launches summed over every engine
   an arm built, dead ones included; leak-free, nothing in flight.
   Prints ``fleet arm {...}`` (TTFT mean/p50/p99, decode tokens/s,
   cold prefills and hits, failovers, restarts, hedges, death to the
   first re-homed token, restart time, handoff MB, the fleet telemetry)
   and ``fleet one-engine {...}`` for each traffic.
7e. ``serving_obs_phase``: a TTFT and a total deadline on warm kernels
   (budgets at least 10x and 20x a warm step) with the watchdog running;
   ``infer.decode@1`` raising before any launch with the cache
   bit-identical and a clean drain; ``kv.spill@1``, ``kv.spill@4`` and
   ``kv.fetch@1`` each falling back to a cold prefill with the greedy
   stream unchanged (in f32).
7f. The runtime (gpt2-runtime, ``runtime_phase``):
   ``ray_tpu_torch.init`` finds the card as ``"GPU"`` 1.0; a CPU task
   (forked from the template) sees ``CUDA_VISIBLE_DEVICES=""`` and no
   torch; a ``num_gpus=1`` actor cold-spawns onto the card (``"0"``, the
   card's name, this process's kernel library loaded, not rebuilt),
   reads the bf16 parameters (as host arrays) from the object store,
   builds the serving engine and serves gpt2-serve-mixed's 16 requests:
   streams equal an engine in this process token for token, launches
   (read back from the actor) equal its and ``serve_launches``'; a kill
   -9 of the actor mid-request gives the caller ``ActorDiedError`` and
   the card back in ``available_resources()`` within
   ``RUNTIME_RELEASE_S``; a second 1-card actor pends while a first
   lives and starts after ``kill``; ``shutdown()`` leaves no worker
   process. Prints ``runtime metrics {...}`` (cold start, put and
   in-actor get GB/s, an empty method's round trip, no-op tasks a
   second, TTFT and decode tokens/s in the actor and in this process).
7g. Serving on the runtime (gpt2-serve-deployment,
   ``serve_deployment_phase``): ``serve.run`` deploys ``GPTDeployment``
   (GPT-2 124M bf16 from seed 0, 8 slots, page 128) with
   ``num_gpus=1``: the serve controller, itself an actor, creates the
   replica, which cold-spawns onto the card (``"0"``, this process's
   kernel library, not rebuilt).  gpt2-serve-mixed's 16 requests stream
   through the handle (the replica's first step held until all 16
   wait, as ``serve`` submits them): every stream equals an engine's in
   this process on the same requests, or parts only below the f32
   reference's 2 x 0.09 margin; the replica's launches, read back from
   its process, equal ``serve_launches`` of its calls and this
   process's run.  A handle stream dropped after one token is reaped
   within ``stream_idle_s`` plus a bound, its slot free, and a late
   reader gets ``StreamIdleError``.  One disaggregated handoff goes
   through the runtime's object store (``HandoffStore(use_object_store
   =True)``) and continues as the co-located stream.  ``serve.delete``
   leaves no replica process and the card back in
   ``available_resources()``.  Prints ``serve-deployment metrics
   {...}`` (replica cold start from ``serve.run`` to the first token,
   TTFT mean and p99 and decode tokens/s through the handle and in this
   process, the handoff's put / get GB/s).
8. Training phase: GPT-2 124M in bf16 trains 10 steps at batch 24 x
   1024 through ``build_gpt_train`` (flash attention with in-kernel
   RoPE, the fused epilogue, flash-CE with the norm prologue); prints
   ms/step, tokens/s, MFU and peak memory, checks the loss and the exact
   launch counts of every step.  Then 6 steps with the RMSNorm kernels.
8a. The remat and fused-CE arms (``train_arms_phase``): 2 warm-up and 4
   timed steps each with ``cfg.remat`` (each block's forward kernels run
   twice, exactly; losses equal the default arm's; a lower peak) and with
   ``ce_mode="fused"`` (no flash-CE launch; step-0 loss within 1e-2 of
   the flash arm's); prints ``training arms {...}``.
8b. gpt2-train-worker (``train_worker_phase``; ``--train-worker`` runs
   the default arm and it): a ``TorchTrainer`` of one ``num_gpus=1``
   worker forms an NCCL world of 1 (one ``collective.allreduce`` returns
   its input exactly) and trains the default arm's 10 steps through
   ``build_gpt_train(cfg, make_mesh(dp=-1), telemetry=True)``: launches
   read back from the worker exact, every loss and grad norm equal to
   the driver's, the step recorder's steady step within 10% of the
   median of the loop's own step times and its MFU ``flops.mfu``'s,
   ``compile_s`` on step 0 alone, rank 0's checkpoint loaded here, the
   worker gone and the card free within 5 s of ``fit()``; prints
   ``train-worker metrics {...}`` (fit to first report, NCCL init,
   ms/step and MFU in the worker and here, peaks).
8c. gpt2-train-overlap (``train_overlap_arm``, in the same worker after
   gpt2-train-sharded, on the same mesh of ``ScalingConfig.mesh_axes``,
   every axis 1): the overlap schedule's local program
   (``parallel.overlap.build_overlap_step_fns``) at full width and depth
   against the gspmd arm's ``value_and_grad_fn`` on the same shards and
   batch: the loss within 2e-4 relative, every gradient leaf within 0.06
   of its largest value, and exactly 12 attention forward and backward
   launches a call and nothing else; prints ``train-overlap metrics
   {...}`` (each arm's median ms over 8 calls after 2, and its peak).
8d. The int8 wire's codec (``wire_codec_phase``) over GPT-2 124M's bf16
   tree in the fsdp gathers' layout: nearest codes and scales bit-equal
   to the CPU's on all 85 leaves, a stochastic draw within one step, the
   mean of 512 draws within 0.08 of a step, the wire bytes equal to
   ``collective_bytes_per_step``'s; prints ``wire-codec metrics {...}``
   (ms and GB/s of the largest leaf and of the tree, nearest and
   stochastic).
8e. gpt2-train-pp (``train_pp_arm``, in the same worker after
   gpt2-train-overlap): gpt2-train-b24 through ``build_gpt_train_pp`` on
   ``make_mesh(pp=1)`` (one stage), M = 4 microbatches of 6 rows, GPipe
   and 1F1B, WARMUP_STEPS + TIMED_STEPS steps each from the dp arm's
   seeds: every loss and grad norm against the dp arm's (the first two
   steps, on equal parameters, within 2e-4 and PP_EQUAL_NORM_REL, the
   drifting later ones within PP_LOSS_ABS and PP_NORM_REL), the loss and
   every gradient against the dp step's on the last parameters (2e-4,
   0.06 of each leaf's largest value), exact launches
   (``PP_STEP_LAUNCHES``: the one stage is the last, whose 1F1B forward
   of a microbatch shares the tick of its backward and runs once, under
   autograd, as GPipe's), ``bubble_fraction`` 0 and the
   reference's in-flight count for one stage, and 1F1B's peak memory
   below GPipe's; prints ``train-pp metrics {...}`` (ms/step, tokens/s,
   MFU, peak GiB per schedule).
8f. gpt2-train-moe (``train_moe_arm``, then): GPT-2 124M's widths with 8
   experts a layer (top 2, capacity factor 1.5) in bf16 at batch 4 x
   1024 (the one-hot dispatch grows as T^2).  One step of the kernel
   path against the plain path at full depth, batch 2 x 1024, in f32
   (TRAIN_F32_TOL; the bf16 readings printed), exact launches; 6 steps
   whose loss falls with exact launches; one step at capacity factor 0.5
   whose every layer keeps fewer than T * 2 assignments; prints
   ``train-moe metrics {...}`` (ms/step, peak GiB, the dispatch tensor's
   bytes).
8g. gpt2-train-stream (``train_stream_phase``, after 8a): GPT-2 124M in
   bf16 trains 6 steps from ``data.StreamingLoader`` (packed batches of
   8 x 1024 from ``SyntheticDocs``, through the pinned double buffer)
   with an async checkpoint every 2 (``resilience.TrainCheckpointer``),
   launching per step exactly the epilogue pair per layer and the
   flash-CE pair (packed attention is the plain segment attention, as in
   the reference); the snapshot after step 4 is dropped and a second
   loop resumes from step 4's: its losses and final parameters equal the
   first loop's bit for bit if one whole step is (``determinism step``),
   else within TRAIN_BF16_TOL.  The kernels are held to their plain
   versions at 8 x 1024 first (``stream_shape_phase``, with the packed
   batch's -1 targets), each piece of the step called twice for equal
   bits (``determinism kernels``).  Then the accumulation arm:
   ``accum_steps=2`` against 1 at the same width, unpacked: loss and
   every gradient within TRAIN_BF16_TOL, exact launches.  Prints
   ``train-stream metrics {...}`` (steady ms/step beside the dp arm's,
   checkpoint write seconds on the background thread, the share of
   steps that waited on input, peak GiB) and ``train-accum metrics
   {...}``.
9. Training correctness: one step's loss and every gradient of the
   kernel path against the port's plain path (local attention, unfused
   epilogue, dense CE) at full width and depth, batch 2 x 1024: in f32
   under a summation-order bound, and in bf16 against the f32 plain path,
   and in bf16 with ``ce_mode="fused"`` (loss within 1e-2, gradients at
   the bf16 bound); then the same at 2 layers with the RMSNorm kernels.
10. Width checks: the kernels at the widths of the repo's other presets
   (attention and decode at tiny's head_dim 16, RMSNorm at d = 64, 1024
   and 1280, the epilogue timed at gpt2_medium's and gpt2_large's
   training shapes), then a 2-layer gpt2_medium, gpt2_large and tiny
   step at two seeds, as in 9, with exact launches: every kernel their
   widths take runs, and none of the card's tensors goes to a plain
   version in a kernel's place.
11. gpt2-train-dataset (``train_dataset_phase``): 512 token rows of
   1025 ids (vocab 50304, from a seed) in 8 ``.npy`` shards, read by
   ``data.read_numpy``, feed a ``TorchTrainer`` of one GPU worker
   (``datasets={"train": ds}``: its ``DataIterator`` from
   ``streaming_split``); the worker trains GPT-2 124M 8 steps at 8 x 1024
   on ``iter_torch_batches(batch_size=8, device="cuda")``.  Every row is
   taken at most once, launches exact, every loss within 1e-5 relative
   of the same batches fed by hand to this process's step; prints
   ``train-dataset metrics {...}`` (ms/step, the share of steps that
   waited on input, peak GiB).
12. gpt2-serve-lora (``serve_lora_phase``): the engine with a LoRA bank
   (rank 16 on every target, 4 tenants and the identity), 3 tenants'
   random adapters and base traffic in one co-batch of 8 requests of 16
   greedy tokens, bf16 and int8 KV: every stream equals the plain engine
   over the merged weights under 7a's rule, exact launches with 0 of the
   fused epilogue (declined under LoRA); a republish mid-decode keeps
   the pinned version's tokens, the bank written in place; prints
   ``serve-lora metrics {...}`` (TTFT and tokens/s beside a fresh
   LoRA-off engine's, and of a second co-batch with the tenants
   resident; every timed co-batch prefills cold, 0 prefix hits
   asserted).
13. gpt2-train-lora (``train_lora_phase``): ``build_gpt_train(lora=...)``
   over a frozen GPT-2 124M, 12 steps at 8 x 1024 (10 timed) beside the
   full-parameter arm: step 0 is the base model, the base bit-unchanged,
   exact launches with no epilogue, the adapter's gradients against the
   f32 plain path at 2 x 1024 within 9's bf16 bound; prints
   ``train-lora metrics {...}`` (ms/step and peak beside the full
   arm's).
14. The RL loop (``rl_phases``), GPT-2 124M as ``bench.py --rl`` runs it
   (``RLConfig()``'s defaults: batch 8, horizon 16; prompt 4, seed 1, lr
   1e-4; the engine's default geometry):
   gpt2-rl: ``run_rl_loop`` for 30 steps in-process: every metric
   finite, param_version 31, no drop, the engine clean, exact launches
   (the engine's prefills and decode steps; per learner step the
   attention and epilogue forward and backward; flash-CE 0), after every
   weight swap the engine holding the published tree bit for bit, from
   the second swap on no device allocation and the engine's parameters
   where they were; the first rollout's logprobs against the learner's
   teacher-forced ``log_softmax`` (ENGINE_TOL), ``pg_grad_fn`` against
   the f32 plain path (RL_LOSS_REL, TRAIN_BF16_TOL's gradient bound) and
   ``RLOptimizer`` against a plain clip-then-Adam (RL_OPT_TOL).  At this
   setting every reward is -1, so the learner stands still.
   gpt2-rl-moving: the same loop for 6 steps with a reward that varies
   across a rollout's rows: every swap also changes at least
   RL_MOVED_MIN of the engine's elements.
   gpt2-rl-group: gpt2-rl-moving's loop with its learner in a
   ``num_gpus=1`` actor of a port session: its first step equals
   gpt2-rl-moving's within 1e-5, its version 2 differs in at most
   RL_V2_PARTED of the elements, and every swap moves the engine.
   gpt2-rl-lora: an adapter-only learner over the frozen base trains 4
   steps on a bank engine's rollouts under its tenant with seeded normal
   rewards, publishing the adapter after each: the base bit-unchanged,
   no epilogue on either side, every B moved, the tenant's greedy
   stream the merged weights' under 7a's rule.
   gpt2-rl-supervised: ``run_supervised_rl_loop`` for 8 steps under the
   faults ``rl.rollout@3,rl.learner@5`` with a checkpoint every 2 steps:
   one restart each, 8 records, the engines clean, exact launches (the
   dead engine's included), no kernel built after the replacement.
   Each prints ``<cell> metrics {...}``.
15. gpt2-profile (``profile_api_phase``): ``util.profiling.
   profile_device`` around 2 steps of gpt2-train-b24 with
   ``annotate("train-step")`` around each: the trace file exists, names
   the annotation and the CUDA kernels of the training entry points as
   often as ``_build.launch_counts`` says they launched (exact), in the
   main run's own process after its earlier profiler sessions;
   ``device_memory_stats()`` has the card with ``bytes_in_use`` > 0 and
   the peak at least that; prints the profiled and unprofiled ms/step
   and how many of ``profile_device``'s warm-up records the session kept.
16. rllib (``rllib_phase``), at the reference's default widths: one
   update each of PPO (4 x 256 CartPole-shaped rows, 6 epochs), DQN,
   IMPALA (4 segments of 64, v-trace), SAC (Pendulum-shaped, fed
   noise) and BC on the card against the same learner on the CPU (TF32
   is off: ``torch_flags``): every metric finite and within 1e-4
   relative (1e-6 absolute) of the CPU's, the parameters moved and
   within 1e-4 of each leaf's largest value; then a ``LearnerGroup``
   of one ``num_gpus_per_learner=1`` PPO learner actor, whose two
   updates equal an in-process learner's on the card within 1e-5
   relative; its cold start printed.  The env-driven arm (PPO on
   CartPole) runs where ``gymnasium`` imports, else the line says it did
   not.  Prints ``rllib metrics {...}``.

17. The GPT-2 exact architecture (``hf_phases``; the kernels at its
   training shape first, ``hf_shape_phase``: the attention pair without
   RoPE at [8, 1024, 12, 64] and flash-CE forward and backward at N = 8 x
   1024, V = 50257, no prologue).  gpt2-hf-serve: GPT-2 124M from a
   seeded ``GPT2LMHeadModel(GPT2Config())`` through ``port_gpt2`` (the
   port's ``init_params`` where ``transformers`` is missing), 8 greedy
   requests of 64-512-token prompts through the engine at the main
   path's settings, against the f32 CPU forward at the serving gates,
   launches exact (the epilogue 0).  gpt2-hf-train: ``TransformersTrainer``
   with one ``num_gpus=1`` worker, 10 steps at 8 x 1024 on one repeated
   window; finite losses falling from ~ln 50257, a checkpoint, flash-CE
   forward and backward once a step in the worker and the epilogue
   never.  Prints ``gpt2-hf-serve metrics`` and ``gpt2-hf-train metrics``
   (``--hf`` runs this alone).
18. resnet50-train (``resnet_phases``): ``ResNet50`` in bf16 (f32
   BatchNorm statistics), batch 64 at 224 x 224, 2 + 8 steps in a
   ``TorchTrainer`` worker with one card; finite losses that fall and
   every running statistic finite and moved.  Then one ResNet-18 (32 x
   32, f32, batch 8) and one MLP step (784 -> 128 -> 128 -> 10, batch
   256) on the card against the CPU from the same flax-layout
   parameters, TF32 off (``card-cpu metrics``; ``--resnet`` runs this
   alone).
19. gpt2-tune (``tune_phase``): Ray Tune over GPT-2 124M's training
   step at 8 x 1024 (bf16, ``init_params`` seed 0, one seeded batch,
   AdamW without warm-up).  Arm a: ``tune.with_resources(tune_trial,
   {"GPU": 1})`` over 4 learning rates under ASHA (max_t 8, grace 2,
   rf 2) on ``loss``, a report each step, the trials one at a time on
   the card; every first loss bit-equal to the driver's, every loss
   moving, a stop at a rung that ASHA replayed here repeats, the best
   result the lowest final loss, exact launches in every report, each
   stopped trial's process gone and the card as free for the next.
   Arm b: a ``Tuner`` over a one-worker ``TorchTrainer`` at 2 rates
   (FIFO), each trial's 4 losses bit-equal to the driver's.  Prints
   ``tune metrics {...}`` (``--tune`` runs this alone).
20. The microbenchmark path (``microbenchmark_phase``): first the kernel
   variants it reaches, against their plain versions under the main
   path's tolerances: the attention pair without the causal mask and at
   head dim 128 (causal and not) at ragged S = 300 between guard bands,
   with and without RoPE, bf16 and f32; the decode kernels at head dim
   128, padded and paged, bf16, f32 and int8; then their times at
   ``attention_perf``'s [8, 1024, 12, 64] non-causal and [8, 1024, 12,
   128] causal, both with RoPE, and decode at [8, 1024, 12, 128] (extra
   shapes of the rows).  Then, with the counts at 0, the path:
   ``ray_perf.main`` in a port session, ``attention_perf`` at its
   defaults, non-causal and at head dim 128, ``decode_perf`` at head
   dims 64 and 128 in both ``impl`` arms, ``fused_norm_perf`` and
   ``ce_perf`` in both arms, ``train_step_perf`` and ``collective_perf``
   in a world of 1: every figure finite, launches exact.  Prints
   ``microbenchmark metrics {...}`` (``--microbenchmark`` runs this
   alone); adds ``microbenchmark`` to ``launches_by_path``.

Any failure raises and the script exits non-zero.  The line before the
last is ``{"kernels": [...]}``; the last is ``{"ok": true, "device":
...}``.  Without a CUDA device it exits non-zero and prints no result.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import gc
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

# published peaks of the cards this port targets (NVIDIA data sheets,
# SXM parts, dense): device-memory bytes/s and bf16 tensor-core flop/s
PEAKS = {"H100": (3.35e12, 989e12), "H200": (4.8e12, 989e12)}

# bf16 kernel against its plain version computed in f32 on the same
# inputs.  A value may be off by ``rtol`` of itself (the bf16 rounding of
# the output, 2^-9, with headroom) plus ``row`` of its row's rms: p and
# the product are rounded to bf16 inside the kernel, which moves a value
# by a small share of its own row's scale.  A row of a long prefill has
# values ~0.04, so the bound there is ~1e-3, where a k tile dropped late
# in a 1024-long row moves o by ~1e-2.
BF16_TOL = dict(rtol=2 ** -7, row=2 ** -5)
# the f32 statistics (lse, rstd) from the same bf16 inputs: summation
# order and, for rstd, the bf16 rounding of r (~1.5e-4 of rstd per row,
# ~5e-4 at worst over 1024 rows)
LSE_TOL = dict(atol=2e-4)
RSTD_TOL = dict(rtol=2e-3)
# the f32 instantiations on the same inputs, against the same f32 plain
# version: summation order only (the CPU tests' bounds)
F32_TOL = dict(atol=2e-5, rtol=2e-5)
F32_MATMUL_TOL = dict(atol=1e-4, rtol=1e-4)   # 768-term products


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def peaks(name: str):
    for key, val in PEAKS.items():
        if key in name:
            return val
    raise RuntimeError(f"no published peaks for {name!r}: add them to "
                       "PEAKS before quoting a bound")


def time_ms(fn, iters: int = 20) -> float:
    """Mean device time of one call, from CUDA events over ``iters``
    calls after a warm-up.  A spin kernel queued first keeps the card
    busy while the host enqueues the calls, so the events time the
    device's work and not the host's launch rate."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check(what: str, got, ref, *, atol: float = 0.0, rtol: float = 0.0,
          row: float = 0.0) -> float:
    """Raise unless ``|got - ref| <= atol + rtol |ref| + row rms(ref
    row)`` everywhere (a row is the last dimension); print the largest
    share of that bound used, and return the max abs error."""
    got, ref = got.float(), ref.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite values")
    err = (got - ref).abs()
    tol = atol + rtol * ref.abs()
    if row:
        tol = tol + row * ref.square().mean(-1, keepdim=True).sqrt()
    # an exact zero (a masked row) uses none of a zero bound
    share = torch.where(err > 0, err / tol, 0.0).max().item()
    print(f"  {what}: max_abs_err={err.max().item():.3e} "
          f"share_of_tol={share:.3f}", flush=True)
    if share > 1:
        raise AssertionError(
            f"{what}: {int((err > tol).sum())} values outside atol={atol} "
            f"rtol={rtol} row={row}")
    return err.max().item()


def bound(nbytes: float, flops: float, bw: float, peak: float):
    tb, tf = nbytes / bw * 1e3, flops / peak * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


class Recorder:
    """The ``{"kernels": [...]}`` rows: one per kernel, reporting the
    last (largest main-path) shape measured and the largest error seen
    over all its shapes."""

    def __init__(self, name: str):
        self.bw, self.peak = peaks(name)
        self.rows = {}

    def record(self, kernel, shape, err, ms, plain_ms, lib_ms, nbytes,
               flops, source, replaces, *, own: bool = True, **extra):
        """One measured shape of ``kernel``: printed, added to its row's
        ``by_shape`` and error, and (``own``, the default) made the row's
        own shape; ``own=False`` keeps the row's shape."""
        b_ms, b_by = bound(nbytes, flops, self.bw, self.peak)
        print(f"kernel {kernel} {shape}: max_abs_err={err:.3e} "
              f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"library_ms={lib_ms:.4f} bound_ms={b_ms:.4f} ({b_by})",
              flush=True)
        row = self.rows.setdefault(kernel, {
            "name": kernel, "route": "cuda", "source": source,
            "replaces": replaces, "max_abs_err": 0.0})
        row["max_abs_err"] = max(row["max_abs_err"], err)
        if own:
            row.update(shape=shape, ms=ms, plain_ms=plain_ms,
                       library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                       **extra)
        # every shape measured, the row's own (the last) included
        row.setdefault("by_shape", []).append(dict(
            shape=shape, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
            bound_ms=b_ms, bound_by=b_by, **extra))


def _randn(g, dev):
    def randn(*shape, s=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=g, device=dev) * s).to(dtype)
    return randn


def _f32(*xs):
    return [x.float() for x in xs]


# decode attention: the smoke's lengths (split counts 1, 8, 1, 1, 2, 4, 7,
# 8 at 128 positions a split: most rows' counts differ from their
# neighbours') and the page sizes the paged entry is checked at
DECODE_LENGTHS = (1, 1024, 37, 128, 129, 500, 777, 1000)
DECODE_PAGE_SIZES = (128, 16, 1)
DECODE_SPLIT = 128   # positions a block owns (decode_attention.cu SPLIT),
                     # for the printed split counts only


def decode_context(g, dev, B, S, H, D, lengths) -> dict:
    """q [B, H, D] bf16 and a padded context [B, S, H, D] that holds
    garbage at every position >= its row's length: K, V in bf16 with
    NaN there; int8 codes and f32 scales [B, S, H] of fresh K/V from
    ``quantize_block``, with random codes and NaN scales there."""
    from ray_tpu_torch.quant import quantize_block

    randn = _randn(g, dev)
    dead = (torch.arange(S, device=dev)[None, :]
            >= lengths[:, None].long())[..., None, None]
    c = dict(q=randn(B, H, D))
    for n in ("k", "v"):
        c[n] = randn(B, S, H, D).masked_fill(dead, float("nan"))
        codes, sc = quantize_block(randn(B, S, H, D, dtype=torch.float32),
                                   block=D)
        noise = torch.randint(-128, 128, codes.shape, generator=g,
                              device=dev, dtype=torch.int8)
        c[n + "8"] = torch.where(dead, noise, codes)
        c[n + "s"] = sc[..., 0].masked_fill(dead[..., 0],
                                            float("nan")).contiguous()
    return c


def decode_pages(c: dict, lengths, page_size: int, g) -> tuple:
    """The padded context ``c`` laid out as the engine's cache holds it:
    pages [P, page_size, ...] with the garbage page 0 and each row's
    pages at shuffled ids, and a table [B, max_pages] int32 whose
    entries from ceil(len / page_size) on name the garbage page.  The
    garbage page and the positions past S hold NaN (codes: 127), and
    the float pages sit between NaN guard bands (``_guarded``).
    Returns (pages by name, table, max_pages)."""
    B, S = c["k"].shape[:2]
    mp = -(-S // page_size)
    ids = (torch.randperm(B * mp, generator=g, device=g.device) + 1)
    pages = {}
    for n in ("k", "v", "k8", "v8", "ks", "vs"):
        x = c[n]
        fill = 127 if x.dtype == torch.int8 else float("nan")
        ctx = torch.full((B, mp * page_size) + x.shape[2:], fill,
                         dtype=x.dtype, device=x.device)
        ctx[:, :S] = x
        pool = torch.full((1 + B * mp, page_size) + x.shape[2:], fill,
                          dtype=x.dtype, device=x.device)
        pool[ids] = ctx.reshape((B * mp, page_size) + x.shape[2:])
        pages[n] = pool if x.dtype == torch.int8 else _guarded(pool)
    used = -(-lengths.long() // page_size)
    table = ids.view(B, mp).masked_fill(
        torch.arange(mp, device=ids.device)[None, :] >= used[:, None], 0)
    return pages, table.to(torch.int32).contiguous(), mp


def _raw_decode(A, q, k, v, scales, lengths, table, ps, mp):
    """The decode kernels launched on outputs the caller gives (o, ws):
    for ``_guarded_writes``."""
    B, H, D = q.shape

    def launch(o, ws):
        common = (lengths.data_ptr(), table.data_ptr(), o.data_ptr(),
                  ws.data_ptr(), B, H, D, ps, mp, D ** -0.5,
                  A._DTYPE_CODES[q.dtype], A._stream(q))
        if scales:
            A.decode_attention_int8_kernel(
                q.data_ptr(), k.data_ptr(), v.data_ptr(),
                *(t.data_ptr() for t in scales.values()), *common)
        else:
            A.decode_attention_kernel(q.data_ptr(), k.data_ptr(),
                                      v.data_ptr(), *common)
    return launch


def decode_checks(dev, *, B: int, S: int, H: int, D: int,
                  lengths) -> None:
    """Both decode kernels, padded and paged, against their plain
    versions: bf16 and f32 (model dtype) and int8 codes under q in bf16
    and f32, at the main-path tolerances, over a context whose positions
    past each length hold NaN (int8: random codes, NaN scales).  The
    paged entry reads the same context through a shuffled table at page
    sizes 128, 16 and 1, with NaN in the garbage page every table tail
    names and NaN guard bands around the pages.  Two calls must agree
    bit for bit, and the paged call with the padded one (one body, the
    same order of work); the bf16 and int8 launches, made once more on
    outputs between guard bands, must write nothing else."""
    from ray_tpu_torch.ops import attention as A

    g = torch.Generator(device=dev).manual_seed(11)
    lengths = torch.tensor(lengths, dtype=torch.int32, device=dev)
    c = decode_context(g, dev, B, S, H, D, lengths)
    scale = D ** -0.5
    q, q32 = c["q"], c["q"].float()
    ref = A.plain_decode_attention(*_f32(q, c["k"], c["v"]), lengths,
                                   scale=scale)
    ref8 = A.plain_decode_attention(q32, c["k8"], c["v8"], lengths,
                                    scale=scale, k_scale=c["ks"],
                                    v_scale=c["vs"])
    # name: (q, k name, v name, int8, reference, tolerance)
    variants = {"bf16": (q, "k", "v", False, ref, BF16_TOL),
                "f32": (q32, "k", "v", False, ref, F32_TOL),
                "int8": (q, "k8", "v8", True, ref8, BF16_TOL),
                "int8 f32": (q32, "k8", "v8", True, ref8, F32_TOL)}
    splits = (-(-lengths.long() // DECODE_SPLIT)).tolist()
    for name, (qq, kn, vn, int8, want, tol) in variants.items():
        what = f"decode [{B},{S},{H},{D}] {name}"
        cast = (lambda x: x) if int8 or qq.dtype == torch.bfloat16 \
            else (lambda x: x.float())
        k, v = cast(c[kn]), cast(c[vn])
        sc = dict(k_scale=c["ks"], v_scale=c["vs"]) if int8 else {}
        o = A.decode_attention(qq, k, v, lengths, **sc)
        again = A.decode_attention(qq, k, v, lengths, **sc)
        torch.cuda.synchronize()
        check(f"{what} padded", o, want, **tol)
        if not torch.equal(o, again):
            raise AssertionError(f"{what}: two padded calls differ")
        for ps in DECODE_PAGE_SIZES:
            pages, table, mp = decode_pages(c, lengths, ps, g)
            kp, vp = cast(pages[kn]), cast(pages[vn])
            if not int8 and qq.dtype == torch.float32:
                kp, vp = _guarded(kp), _guarded(vp)
            psc = (dict(k_scale_pages=pages["ks"], v_scale_pages=pages["vs"])
                   if int8 else {})
            op = A.decode_attention_paged(qq, kp, vp, table, lengths, **psc)
            op2 = A.decode_attention_paged(qq, kp, vp, table, lengths, **psc)
            torch.cuda.synchronize()
            check(f"{what} paged page={ps}", op, want, **tol)
            if not (torch.equal(op, op2) and torch.equal(op, o)):
                raise AssertionError(f"{what} page={ps}: two paged calls, "
                                     "or the paged and the padded, differ")
            if qq.dtype == torch.bfloat16:
                ws = torch.empty(A._decode_workspace_elems(
                    B, H, D, mp * ps), dtype=torch.float32, device=dev)
                _guarded_writes(f"{what} paged page={ps}", _raw_decode(
                    A, qq, kp, vp, {"k": pages["ks"], "v": pages["vs"]}
                    if int8 else {}, lengths, table, ps, mp), (op,),
                    scratch=(ws,))
        print(f"  {what}: padded and paged (pages {DECODE_PAGE_SIZES}) "
              f"bit-identical over two calls and to each other; splits "
              f"per row {splits}; guard bands intact", flush=True)


def _kernel_device_ms(fn, iters: int = 20) -> dict:
    """Device time per call of each kernel ``fn`` launches
    (torch.profiler), by kernel name."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1e3 / iters
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0}


def _cold_ms(fn, inputs: tuple, copies: int = 6) -> float:
    """``time_ms`` of ``fn(*inputs)`` with each call on the next of
    ``copies`` clones of the inputs, so that a call finds its inputs out
    of the 50 MB L2 (the engine's cache, ~300 MB, is read once a step)."""
    import itertools
    ring = itertools.cycle([tuple(x.clone() for x in inputs)
                            for _ in range(copies)])
    return time_ms(lambda: fn(*next(ring)))


def decode_timings(rec: Recorder, dev, *, B: int, S: int, H: int,
                   D: int, own: bool = True) -> None:
    """Both decode kernels timed at the smoke's lengths and with every
    row full, padded and paged (page 128, a shuffled table), beside
    their plain versions and the library's yardsticks: the masked SDPA
    (int8: dequantize, then SDPA) for the padded entry, and
    ``gather_pages`` followed by the same call for the paged one.  Each
    row's headline (recorded last) is the paged kernel at the smoke's
    lengths, the engine's decode step.  Also prints each kernel's time
    with its inputs out of L2, the device time of the split and the
    combine kernels apart, and the achieved bandwidth.  ``own=False``
    records the shape as an extra one of the rows (a head-dim variant),
    keeping each row's headline."""
    import torch.nn.functional as F

    from ray_tpu_torch.inference.kv_cache import gather_pages
    from ray_tpu_torch.ops import attention as A

    g = torch.Generator(device=dev).manual_seed(12)
    bf = torch.bfloat16
    scale = D ** -0.5
    src = "ray_tpu_torch/ops/csrc/decode_attention.cu"
    for lens in ((S,) * B, DECODE_LENGTHS):
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        c = decode_context(g, dev, B, S, H, D, lengths)
        ps = 128
        pages, table, _mp = decode_pages(c, lengths, ps, g)
        table64 = table.long()
        q, qs = c["q"], c["q"][:, :, None, :]
        mask = (torch.arange(S, device=dev)[None, :]
                < lengths[:, None].long())[:, None, None, :]
        valid = int(lengths.sum())
        n_tab = int((-(-lengths.long() // ps)).sum())
        blocks = H * int((-(-lengths.long() // DECODE_SPLIT)).sum())
        flops = 4 * H * D * valid
        tag = "full" if len(set(lens)) == 1 else "smoke lengths"

        def sdpa(k, v):
            return F.scaled_dot_product_attention(
                qs, k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask)

        def deq(codes, sc):
            return (codes.float() * sc[..., None]).to(bf)

        sc = dict(k_scale=c["ks"], v_scale=c["vs"])
        psc = dict(k_scale_pages=pages["ks"], v_scale_pages=pages["vs"])
        for row, int8 in (("decode_attention", False),
                          ("decode_attention_int8", True)):
            k, v = (c["k8"], c["v8"]) if int8 else (c["k"], c["v"])
            kp, vp = ((pages["k8"], pages["v8"]) if int8
                      else (pages["k"], pages["v"]))
            kw, pkw = (sc, psc) if int8 else ({}, {})
            nbytes = (2 * B * H * D * 2 + B * 4
                      + valid * H * ((D + 4) * 2 if int8 else D * 2 * 2))
            want = A.plain_decode_attention(
                q.float(), *((k, v) if int8 else _f32(k, v)), lengths,
                scale=scale, **kw)
            if int8:
                def lib_padded():
                    sdpa(deq(k, c["ks"]), deq(v, c["vs"]))

                def lib_paged():
                    sdpa(deq(gather_pages(kp, table64),
                             gather_pages(pages["ks"], table64)),
                         deq(gather_pages(vp, table64),
                             gather_pages(pages["vs"], table64)))
            else:
                def lib_padded():
                    sdpa(k, v)

                def lib_paged():
                    sdpa(gather_pages(kp, table64), gather_pages(vp, table64))
            replaces = ("ray_tpu/ops/attention.py:1387 (quantized=True, "
                        "body :1319-1344)" if int8
                        else "ray_tpu/ops/attention.py:1387")
            for entry in ("decode_attention", "decode_attention_paged"):
                paged = entry == "decode_attention_paged"
                big = (kp, vp, *pkw.values()) if paged \
                    else (k, v, *kw.values())

                def call(kk, vv, *scs, paged=paged):
                    if paged:
                        return A.decode_attention_paged(
                            q, kk, vv, table, lengths,
                            **dict(zip(pkw, scs)))
                    return A.decode_attention(q, kk, vv, lengths,
                                              **dict(zip(kw, scs)))

                def plain_call(paged=paged):
                    if paged:
                        return A.plain_decode_attention_paged(
                            q, kp, vp, table, lengths, scale=scale, **pkw)
                    return A.plain_decode_attention(q, k, v, lengths,
                                                    scale=scale, **kw)

                o = call(*big)
                torch.cuda.synchronize()
                err = check(f"{row} {entry} {tag}", o, want, **BF16_TOL)
                ms = time_ms(lambda: call(*big))
                cold = _cold_ms(call, big)
                split = _kernel_device_ms(lambda: call(*big))
                nb = nbytes + (n_tab * 4 if paged else 0)
                rec.record(row, [B, S, H, D], err, ms, time_ms(plain_call),
                           time_ms(lib_paged if paged else lib_padded), nb,
                           flops, src, replaces, own=own, entry=entry,
                           lengths=list(lens), ms_cold=cold)
                print(f"  {row} {entry} {tag}: cold {cold:.4f} ms; "
                      f"{nb / ms / 1e6:.1f} GB/s warm, "
                      f"{nb / cold / 1e6:.1f} GB/s cold; live split blocks "
                      f"{blocks}; device " + ", ".join(
                          f"{n[:40]} {t:.4f} ms" for n, t in split.items()),
                      flush=True)


def kernel_phase(rec: Recorder, dev) -> None:
    """The serving path's kernels against their plain versions at its
    shapes: the bf16 instantiation (timed) and, on the same inputs, the
    f32 one held to the summation-order bound."""
    import torch.nn.functional as F

    from ray_tpu_torch.ops import attention as A

    g = torch.Generator(device=dev).manual_seed(0)
    randn = _randn(g, dev)
    bf = torch.bfloat16
    print(f"tolerances: bf16 {BF16_TOL}, lse {LSE_TOL}, rstd {RSTD_TOL}, "
          f"f32 {F32_TOL}, f32 matmul {F32_MATMUL_TOL}", flush=True)

    # prefill attention at [1, S, 12, 64]
    H, D = 12, 64
    scale = D ** -0.5
    for S in (1, 32, 65, 128, 200, 1024):
        q, k, v = (randn(1, S, H, D) for _ in range(3))
        o, lse = A.flash_attention_fwd(q, k, v, scale=scale)
        o_ref, lse_ref = A.plain_flash_attention_fwd(*_f32(q, k, v),
                                                     scale=scale)
        o32, lse32 = A.flash_attention_fwd(*_f32(q, k, v), scale=scale)
        torch.cuda.synchronize()
        what = f"flash_attention_fwd S={S}"
        err = max(check(f"{what} o", o, o_ref, **BF16_TOL),
                  check(f"{what} lse", lse, lse_ref, **LSE_TOL))
        check(f"{what} f32 o", o32, o_ref, **F32_TOL)
        check(f"{what} f32 lse", lse32, lse_ref, **F32_TOL)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        rec.record("flash_attention_fwd", [1, S, H, D], err,
                   time_ms(lambda: A.flash_attention_fwd(q, k, v,
                                                         scale=scale)),
                   time_ms(lambda: A.plain_flash_attention_fwd(
                       q, k, v, scale=scale)),
                   time_ms(lambda: F.scaled_dot_product_attention(
                       qt, kt, vt, is_causal=True)),
                   4 * S * H * D * 2 + H * S * 4,
                   4 * H * D * S * (S + 1) / 2,
                   "ray_tpu_torch/ops/csrc/flash_attention_fwd.cu",
                   "ray_tpu/ops/attention.py:477")

    # decode attention at [8, 1024, 12, 64], padded and paged, model
    # dtype and int8: checks, then times
    decode_checks(dev, B=8, S=1024, H=H, D=D, lengths=DECODE_LENGTHS)
    decode_timings(rec, dev, B=8, S=1024, H=H, D=D)

    # out-proj + residual + rmsnorm, K = d = 768: at a verify forward's
    # N = kb + 1 rows (speculative decoding, kb = 1, 2, 4, 8), a cached
    # prefill's 32 and a prefill's 1024
    for N in (2, 3, 5, 9, 32, 1024):
        epilogue_fwd_check(rec, randn, g, dev, N, bf)


def epilogue_fwd_check(rec: Recorder, randn, g, dev, N: int, bf, *,
                       own: bool = True) -> None:
    import torch.nn.functional as F

    from ray_tpu_torch.ops import fused_norm as FN

    K = d = 768
    eps = 1e-6
    a = randn(N, K)
    w = randn(K, d, s=K ** -0.5)
    resid = randn(N, d)
    sc = (1 + 0.1 * torch.randn(d, generator=g, device=dev)).to(bf)
    got = FN.matmul_residual_norm_fwd(a, w, resid, sc, eps=eps)
    want = FN.plain_matmul_residual_norm(*_f32(a, w, resid, sc), eps=eps)
    got32 = FN.matmul_residual_norm_fwd(*_f32(a, w, resid, sc), eps=eps)
    torch.cuda.synchronize()
    what = f"matmul_residual_norm N={N}"
    err = max(check(f"{what} r", got[0], want[0], **BF16_TOL),
              check(f"{what} y", got[1], want[1], **BF16_TOL),
              check(f"{what} rstd", got[2], want[2], **RSTD_TOL))
    for part, x, y in zip("r y rstd".split(), got32, want):
        check(f"{what} f32 {part}", x, y, **F32_MATMUL_TOL)
    rec.record("matmul_residual_norm_fwd", [N, K, d], err,
               time_ms(lambda: FN.matmul_residual_norm_fwd(
                   a, w, resid, sc, eps=eps)),
               time_ms(lambda: FN.plain_matmul_residual_norm(
                   a, w, resid, sc, eps=eps)),
               time_ms(lambda: F.rms_norm(torch.addmm(resid, a, w), (d,),
                                          sc, eps)),
               (N * K + K * d + N * d + d) * 2 + 2 * N * d * 2 + N * 4,
               2 * N * K * d,
               "ray_tpu_torch/ops/csrc/matmul_residual_norm.cu",
               "ray_tpu/ops/fused_norm.py:202", own=own)


def rmsnorm_checks(rec: Recorder, randn, g, dev) -> None:
    """The RMSNorm kernels (``gpt._PALLAS_NORM``): the forward at the
    decode step's N = 8, a prefill's 1024 and the training step's 24576
    rows, the backward at 24576, d = 768."""
    import torch.nn.functional as F

    from ray_tpu_torch.ops import rmsnorm as R

    d, eps, bf = 768, 1e-6, torch.bfloat16
    sc = (1 + 0.1 * torch.randn(d, generator=g, device=dev)).to(bf)
    for N in (8, 1024, TRAIN_N):
        x = randn(N, d)
        y, rstd = R.rmsnorm_fwd(x, sc, eps=eps)
        want = R.plain_rmsnorm_fwd(*_f32(x, sc), eps=eps)
        got32 = R.rmsnorm_fwd(*_f32(x, sc), eps=eps)
        torch.cuda.synchronize()
        what = f"rmsnorm_fwd N={N}"
        err = max(check(f"{what} y", y, want[0], **BF16_TOL),
                  check(f"{what} rstd", rstd, want[1], **RSTD_TOL))
        for part, a_, b_ in zip(("y", "rstd"), got32, want):
            check(f"{what} f32 {part}", a_, b_, **F32_TOL)
        rec.record("rmsnorm_fwd", [N, d], err,
                   time_ms(lambda: R.rmsnorm_fwd(x, sc, eps=eps)),
                   time_ms(lambda: R.plain_rmsnorm_fwd(x, sc, eps=eps)),
                   time_ms(lambda: F.rms_norm(x, (d,), sc, eps)),
                   2 * N * d * 2 + d * 2 + N * 4, 4 * N * d,
                   "ray_tpu_torch/ops/csrc/rmsnorm_fwd.cu",
                   "ray_tpu/ops/rmsnorm.py:86")
    # the backward at N = 24576 with the bf16 forward's rstd
    dy = randn(N, d)
    got = R.rmsnorm_bwd(x, sc, rstd, dy)
    want = R.plain_rmsnorm_bwd(*_f32(x, sc), rstd, dy.float())
    got32 = R.rmsnorm_bwd(*_f32(x, sc), rstd, dy.float())
    torch.cuda.synchronize()
    what = f"rmsnorm_bwd N={N}"
    err = max(check(f"{what} dx", got[0], want[0], **GRAD_BF16_TOL),
              check(f"{what} dscale", got[1], want[1], **DS_BF16_TOL))
    check(f"{what} f32 dx", got32[0], want[0], **F32_GRAD_TOL)
    check(f"{what} f32 dscale", got32[1], want[1], **DS_F32_TOL)

    def lib_norm():
        xx, ss = (t.detach().requires_grad_(True) for t in (x, sc))
        F.rms_norm(xx, (d,), ss, eps).backward(dy)

    rec.record("rmsnorm_bwd", [N, d], err,
               time_ms(lambda: R.rmsnorm_bwd(x, sc, rstd, dy)),
               time_ms(lambda: R.plain_rmsnorm_bwd(x, sc, rstd, dy)),
               time_ms(lib_norm),
               3 * N * d * 2 + N * 4 + 2 * d * 2, 8 * N * d,
               "ray_tpu_torch/ops/csrc/rmsnorm_bwd.cu",
               "ray_tpu/ops/rmsnorm.py:117")


# the training path's shapes (bench.py:1932-1935): GPT-2 124M at batch
# 24 x 1024, so N = 24576 rows, d = 768, V = 50304, 12 heads of 64
TRAIN_B, TRAIN_S, TRAIN_H, TRAIN_D = 24, 1024, 12, 64
TRAIN_N, TRAIN_V = TRAIN_B * TRAIN_S, 50304
# bf16 gradients against their plain version in f32 on the same inputs.
# The kernels round p and ds (attention), dr (the epilogue) and dl
# (flash-CE) to bf16 before their products, as the reference does; each
# moves a gradient by a few 2^-9 of its terms, which sum with random
# signs, so the bound is a share of the row's rms plus a share of the
# value: the forward's bound, doubled for the two rounded products that
# feed each gradient.
GRAD_BF16_TOL = dict(rtol=2 ** -6, row=2 ** -4)
# the flash-CE statistics from bf16 y: lse averages the score errors
# away, the true logit is one score of ~0.55 whose 768 terms each carry
# a 2^-9 rounding of y (~3e-3 at the extreme of 24576 rows)
CE_LSE_TOL = dict(atol=1e-3)
CE_TRUE_TOL = dict(atol=8e-3)
# f32 gradients from products over up to 50304 terms (flash-CE) or 24576
# rows (dw): summation order, ~1e-6 of the row scale
F32_GRAD_TOL = dict(atol=1e-5, rtol=1e-4, row=1e-4)
# RMSNorm's dscale sums dy * xhat over all N = 24576 rows.  The terms are
# products of two unit normals (mean |term| = 2/pi), so |dscale| ~
# sqrt(N) ~ 160, and two errors add: the bf16 rounding of the result, at
# most 2^-9 of the value (rtol 2^-7 leaves headroom, as BF16_TOL does),
# and the f32 summation order, at most N * 2^-24 * mean|term| = 9.4e-4
# for any order (atol 2e-3).  The f32 kernel has the second error only.
DS_BF16_TOL = dict(rtol=2 ** -7, atol=2e-3)
DS_F32_TOL = dict(rtol=1e-5, atol=2e-3)


def bwd_reference(qr, kr, v, o, lse, do, scale, rope32, *,
                  causal: bool = True):
    """The bf16 backward's yardstick: the plain version in f64 on the
    rotated q and k (``qr``, ``kr``), with the transposed rotation of dq
    and dk.  In f64 and not f32 because the first row of a sequence
    attends to one key, so its dq is 0 exactly (ds = p (dp - delta) with
    dp = delta, o being that key's v): the kernel gives 0 there, while an
    f32 plain version leaves its own summation noise (up to ~6e-7 on an
    H100), which no bound relative to that row's rms can carry.  In f64
    the 64-term sums of bf16 products are exact, and the row is 0."""
    from ray_tpu_torch.ops import attention as A

    dq, dk, dv = A.plain_flash_attention_bwd(
        *(x.double() for x in (qr, kr, v, o)), lse, do.double(),
        scale=scale, causal=causal)
    return (A._rot_t(dq, *rope32), A._rot_t(dk, *rope32), dv) \
        if rope32 is not None else (dq, dk, dv)


def _guarded(x, pad: int = 4096):
    """x copied into the middle of a NaN-filled buffer with ``pad``
    elements on each side (a multiple of 8, so the view keeps 16-byte
    alignment): a kernel that reads before or past the tensor meets NaN,
    which ``check`` refuses."""
    buf = torch.full((x.numel() + 2 * pad,), float("nan"), dtype=x.dtype,
                     device=x.device)
    view = buf[pad:pad + x.numel()].view(x.shape)
    view.copy_(x)
    return view


def _guarded_writes(what: str, launch, expect, scratch=()) -> None:
    """``launch(*outs)`` with each output a view between guard bands of
    -7.0, shaped as ``expect`` and then ``scratch``; raise if the kernel
    wrote into a band, or if an output differs in any bit from its entry
    of ``expect`` (the wrapper's own call on the same inputs; a scratch
    output is not compared)."""
    pad = 4096
    like = (*expect, *scratch)
    bufs = [torch.full((x.numel() + 2 * pad,), -7.0, dtype=x.dtype,
                       device=x.device) for x in like]
    outs = [b[pad:-pad].view(x.shape) for b, x in zip(bufs, like)]
    launch(*outs)
    torch.cuda.synchronize()
    for b in bufs:
        if not ((b[:pad] == -7.0).all() and (b[-pad:] == -7.0).all()):
            raise AssertionError(f"{what}: a kernel wrote outside an output")
    if not all(torch.equal(x, y) for x, y in zip(outs, expect)):
        raise AssertionError(f"{what}: outputs differ from the wrapper's")


def ragged_attention_checks(dev, *, B: int = 2, H: int = 12,
                            D: int = 64, lengths=(20, 65, 200),
                            causal: bool = True) -> None:
    """The attention kernels at ragged lengths (S = 20, the RL learner's
    prompt 4 + horizon 16, inside one tile; 65 and 200: a partial last
    tile, rows past S masked in-kernel) with and without RoPE, causal or
    not (``causal=False``: every key attends, so the last key tile's
    zero-filled keys past S are dropped by the kernels' explicit mask
    alone):
    forward and backward in bf16 (against the plain version in f32 / f64)
    and in f32 (against the f32 plain version), under the tolerances of
    the main-path checks.  Every input sits between NaN guard bands
    (``_guarded``), so a read past a tensor's last row or before its first
    shows as a non-finite output, and the bf16 kernels are launched once
    more on outputs between guard bands (``_guarded_writes``), which they
    must leave untouched.  Two bf16 backward calls on the same inputs must
    give the same bits (no atomics, a fixed order)."""
    from ray_tpu_torch.ops import attention as A

    g = torch.Generator(device=dev).manual_seed(5)
    randn = _randn(g, dev)
    bf = torch.bfloat16
    scale = D ** -0.5
    for S in lengths:
        for with_rope in (False, True):
            q, k, v, do = (_guarded(randn(B, S, H, D)) for _ in range(4))
            rope = (tuple(map(_guarded, A.rope_tables(
                torch.arange(S, device=dev), D, 10000.0, bf)))
                if with_rope else None)
            rope32 = None if rope is None else _f32(*rope)
            qr, kr = ((A._rot(x, *rope).float() for x in (q, k))
                      if with_rope else _f32(q, k))
            what = (f"attention ragged [{B},{S},{H},{D}] rope={with_rope}"
                    + ("" if causal else " non-causal"))
            cz = dict(scale=scale, causal=causal)
            o, lse = map(_guarded, A.flash_attention_fwd(
                q, k, v, rope=rope, **cz))
            o_ref, lse_ref = A.plain_flash_attention_fwd(
                qr, kr, v.float(), **cz)
            o32, lse32 = A.flash_attention_fwd(*_f32(q, k, v), rope=rope32,
                                               **cz)
            o_ref32, lse_ref32 = A.plain_flash_attention_fwd(
                *_f32(q, k, v), rope=rope32, **cz)
            grads = A.flash_attention_bwd(q, k, v, o, lse, do, rope=rope,
                                          **cz)
            again = A.flash_attention_bwd(q, k, v, o, lse, do, rope=rope,
                                          **cz)
            refs = bwd_reference(qr, kr, v, o, lse, do, scale, rope32,
                                 causal=causal)
            args32 = (*_f32(q, k, v, o), lse, do.float())
            grads32 = A.flash_attention_bwd(*args32, rope=rope32, **cz)
            refs32 = A.plain_flash_attention_bwd(*args32, rope=rope32, **cz)
            torch.cuda.synchronize()
            check(f"{what} o", o, o_ref, **BF16_TOL)
            check(f"{what} lse", lse, lse_ref, **LSE_TOL)
            check(f"{what} f32 o", o32, o_ref32, **F32_TOL)
            check(f"{what} f32 lse", lse32, lse_ref32, **F32_TOL)
            for n, x, y, x32, y32 in zip(("dq", "dk", "dv"), grads, refs,
                                         grads32, refs32):
                check(f"{what} {n}", x, y, **GRAD_BF16_TOL)
                check(f"{what} f32 {n}", x32, y32, **F32_GRAD_TOL)
            if not all(torch.equal(x, y) for x, y in zip(grads, again)):
                raise AssertionError(f"{what}: two bf16 backward calls on "
                                     "the same inputs differ")
            ptr = [None if t is None else t.data_ptr()
                   for t in (q, k, v, o, do, lse, *(rope or (None, None)))]
            args = (B, S, H, D, scale, A._DTYPE_CODES[bf], int(causal),
                    A._stream(q))
            _guarded_writes(f"{what} forward", lambda o_, lse_:
                            A.flash_attention_kernel(
                                *ptr[:3], *ptr[6:], o_.data_ptr(),
                                lse_.data_ptr(), *args), (o, lse))
            _guarded_writes(f"{what} backward", lambda *outs:
                            A.flash_attention_bwd_kernel(
                                *ptr, *(x.data_ptr() for x in outs), *args),
                            grads, scratch=(lse,))  # delta [B, H, S]
            print(f"  {what}: bf16 backward bit-identical over two calls; "
                  "guard bands intact", flush=True)


def width_kernel_checks(dev) -> None:
    """The kernels at the widths of the repo's other configurations, each
    against its plain version under the main-path tolerances: attention at
    tiny's head_dim 16 (the ragged checks above, and ``decode_checks``:
    the decode kernels padded and paged in bf16, f32 and int8),
    and the RMSNorm kernels at tiny's, gpt2_medium's and gpt2_large's
    d = 64, 1024, 1280 (inputs between NaN guard bands, two bf16 backward
    calls bit-identical).  Then the epilogue at gpt2_medium's and
    gpt2_large's training shapes, timed against its plain version."""
    import torch.nn.functional as F

    from ray_tpu_torch.ops import fused_norm as FN
    from ray_tpu_torch.ops import rmsnorm as R

    ragged_attention_checks(dev, H=4, D=16)
    decode_checks(dev, B=4, S=300, H=4, D=16, lengths=(1, 300, 64, 129))
    g = torch.Generator(device=dev).manual_seed(9)
    randn = _randn(g, dev)
    bf = torch.bfloat16
    eps, N = 1e-6, 200
    for d in (64, 1024, 1280):
        what = f"rmsnorm N={N} d={d}"
        sc = _row_guarded(
            (1 + 0.1 * torch.randn(d, generator=g, device=dev)).to(bf))
        x, dy = (_row_guarded(randn(N, d)) for _ in range(2))
        y, rstd = R.rmsnorm_fwd(x, sc, eps=eps)
        want = R.plain_rmsnorm_fwd(*_f32(x, sc), eps=eps)
        got32 = R.rmsnorm_fwd(*_f32(x, sc), eps=eps)
        grads = R.rmsnorm_bwd(x, sc, rstd, dy)
        again = R.rmsnorm_bwd(x, sc, rstd, dy)
        refs = R.plain_rmsnorm_bwd(*_f32(x, sc), rstd, dy.float())
        grads32 = R.rmsnorm_bwd(*_f32(x, sc), rstd, dy.float())
        torch.cuda.synchronize()
        check(f"{what} y", y, want[0], **BF16_TOL)
        check(f"{what} rstd", rstd, want[1], **RSTD_TOL)
        for part, a_, b_ in zip(("y", "rstd"), got32, want):
            check(f"{what} f32 {part}", a_, b_, **F32_TOL)
        check(f"{what} dx", grads[0], refs[0], **GRAD_BF16_TOL)
        check(f"{what} dscale", grads[1], refs[1], **DS_BF16_TOL)
        check(f"{what} f32 dx", grads32[0], refs[0], **F32_GRAD_TOL)
        check(f"{what} f32 dscale", grads32[1], refs[1], **DS_F32_TOL)
        if not all(torch.equal(a_, b_) for a_, b_ in zip(grads, again)):
            raise AssertionError(f"{what}: two bf16 backward calls on the "
                                 "same inputs differ")

    # the epilogue at gpt2_medium's and gpt2_large's training shapes (N =
    # 24576, K = d): bf16 against the f32 plain version, timed
    for d in (1024, 1280):
        N = TRAIN_N
        sc = (1 + 0.1 * torch.randn(d, generator=g, device=dev)).to(bf)
        a, w, resid, drout, dy = (randn(N, d), randn(d, d, s=d ** -0.5),
                                  randn(N, d), randn(N, d), randn(N, d))
        r, y, rstd = FN.matmul_residual_norm_fwd(a, w, resid, sc, eps=eps)
        want = FN.plain_matmul_residual_norm(*_f32(a, w, resid, sc),
                                             eps=eps)
        grads = FN.matmul_residual_norm_bwd(a, w, r, sc, rstd, drout, dy)
        refs = FN.plain_matmul_residual_norm_bwd(
            *_f32(a, w, r, sc), rstd, *_f32(drout, dy))
        torch.cuda.synchronize()
        what = f"epilogue N={N} K=d={d}"
        for n, x, ref in zip(("r", "y", "rstd"), (r, y, rstd), want):
            check(f"{what} {n}", x, ref,
                  **(RSTD_TOL if n == "rstd" else BF16_TOL))
        for n, x, ref in zip(("da", "dw", "dresid", "dscale"), grads, refs):
            check(f"{what} {n}", x, ref, **GRAD_BF16_TOL)
        del want, refs

        def lib_fwd():
            F.rms_norm(torch.addmm(resid, a, w), (d,), sc, eps)

        def lib_bwd():
            args = [x.detach().requires_grad_(True)
                    for x in (a, w, resid, sc)]
            r_ = torch.addmm(args[2], args[0], args[1])
            y_ = F.rms_norm(r_, (d,), args[3], eps)
            torch.autograd.backward([r_, y_], [drout, dy])

        fwd = (time_ms(lambda: FN.matmul_residual_norm_fwd(
                   a, w, resid, sc, eps=eps)),
               time_ms(lambda: FN.plain_matmul_residual_norm(
                   a, w, resid, sc, eps=eps)), time_ms(lib_fwd))
        bwd = (time_ms(lambda: FN.matmul_residual_norm_bwd(
                   a, w, r, sc, rstd, drout, dy)),
               time_ms(lambda: FN.plain_matmul_residual_norm_bwd(
                   a, w, r, sc, rstd, drout, dy)), time_ms(lib_bwd, 10))
        # the training phase's byte and flop counts at K = d
        bw, peak = peaks(torch.cuda.get_device_name(0))
        fb = bound((2 * N * d + d * d + d) * 2 + 2 * N * d * 2 + N * 4,
                   2 * N * d * d, bw, peak)
        bb = bound((6 * N * d + 2 * d * d + 2 * d) * 2 + N * 4 + d * 4,
                   4 * N * d * d, bw, peak)
        print(f"  {what} bf16: forward {fwd[0]:.4f} ms (plain {fwd[1]:.4f}"
              f", addmm + rms_norm {fwd[2]:.4f}, bound {fb[0]:.4f} "
              f"({fb[1]})); backward {bwd[0]:.4f} ms (plain {bwd[1]:.4f}, "
              f"their forward + backward {bwd[2]:.4f}, bound {bb[0]:.4f} "
              f"({bb[1]}))", flush=True)
        del a, w, resid, drout, dy, r, y, rstd, grads
        torch.cuda.empty_cache()


def wgmma_tile_checks(dev) -> None:
    """The ``wgmma`` variants the kernels build on (``hopper.cuh``), each
    alone on one tile, C = A B over k = 64, against the plain product in
    f32, before the kernels built on them are checked: at n64, ``_tb``
    (A K-major, B MN-major: the epilogue forward's a and w) and ``_tt``
    (both MN-major: the epilogue backward's dw = a^T dresid); at n128,
    both K-major (flash-CE's logits y w^T), ``_tb`` (its dx = dl w, B two
    MN-major atoms) and ``_tt`` (its dw = dl^T y).  A wrong transpose
    bit or descriptor offset moves values by O(1); the bf16 products are
    exact in f32, so only the order of the 64-term sums differs
    (``F32_MATMUL_TOL``)."""
    import ctypes

    from ray_tpu_torch.ops import _build

    fn = _build.load().wgmma_tile_check
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    g = torch.Generator(device=dev).manual_seed(6)

    def rand(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)

    A, B, B2 = rand(64, 64), rand(64, 64), rand(64, 128)
    cases = ((0, A, B, A.float() @ B.float(), "n64 tb (A K-major, B MN-major)"),
             (1, A.T.contiguous(), B, A.float() @ B.float(),
              "n64 tt (A and B MN-major)"),
             (2, A, B2.T.contiguous(), A.float() @ B2.float(),
              "n128 (A and B K-major)"),
             (3, A, B2, A.float() @ B2.float(),
              "n128 tb (A K-major, B MN-major)"),
             (4, A.T.contiguous(), B2, A.float() @ B2.float(),
              "n128 tt (A and B MN-major)"))
    for variant, a_in, b_in, want, name in cases:
        c = torch.empty(want.shape, device=dev)
        rc = fn(a_in.data_ptr(), b_in.data_ptr(), c.data_ptr(), variant,
                torch.cuda.current_stream(dev).cuda_stream)
        if rc:
            raise RuntimeError(f"wgmma_tile_check {variant}: CUDA error {rc}")
        torch.cuda.synchronize()
        check(f"wgmma tile {name}", c, want, **F32_MATMUL_TOL)


# the epilogue kernels' edges (N, K, d): N ragged against their 64-row
# blocks at K = d = 768, the gate's other widths of K around GPT-2's at a
# ragged N, and the widths of gpt2_medium and gpt2_large (the GEMM and
# row-pass design, ragged against its 128-row tiles)
EPILOGUE_EDGES = ((1, 768, 768), (63, 768, 768), (65, 768, 768),
                  (200, 768, 768), (200, 384, 768), (200, 1536, 768),
                  (1, 1024, 1024), (65, 1024, 1024), (200, 1024, 1024),
                  (200, 384, 1024), (63, 1280, 1280), (200, 1280, 1280))


def _row_guarded(x):
    """``_guarded`` with a whole 64-row block of NaN on each side, so a
    kernel block reading rows past the tensor's last meets NaN, not
    memory beyond the buffer."""
    return _guarded(x, pad=64 * x.shape[-1])


def ragged_epilogue_checks(dev) -> None:
    """The out-proj epilogue kernels at ``EPILOGUE_EDGES``: the forward and
    the backward (cotangents into both outputs) in bf16 against the plain
    versions in f32, and in f32 against the same, under the main-path
    tolerances.  Every input sits between NaN guard bands of a 64-row
    block each; both bf16 kernels run once more on outputs between
    guard bands of -7.0 (``_guarded_writes``), and two bf16 backward calls
    must give the same bits (no atomics, ordered partial sums)."""
    from ray_tpu_torch.ops import fused_norm as FN

    g = torch.Generator(device=dev).manual_seed(7)
    randn = _randn(g, dev)
    bf, eps = torch.bfloat16, 1e-6
    code = FN._DTYPE_CODES[bf]
    stream = torch.cuda.current_stream(dev).cuda_stream
    for N, K, d in EPILOGUE_EDGES:
        what = f"epilogue ragged N={N} K={K} d={d}"
        sc = (1 + 0.1 * torch.randn(d, generator=g, device=dev)).to(bf)
        a, w, resid, sc, drout, dy = map(_row_guarded, (
            randn(N, K), randn(K, d, s=K ** -0.5), randn(N, d), sc,
            randn(N, d), randn(N, d)))
        r, y, rstd = FN.matmul_residual_norm_fwd(a, w, resid, sc, eps=eps)
        want = FN.plain_matmul_residual_norm(*_f32(a, w, resid, sc),
                                             eps=eps)
        got32 = FN.matmul_residual_norm_fwd(*_f32(a, w, resid, sc), eps=eps)
        r, rstd = _row_guarded(r), _row_guarded(rstd)
        ins = (a, w, r, sc, rstd, drout, dy)
        grads = FN.matmul_residual_norm_bwd(*ins)
        again = FN.matmul_residual_norm_bwd(*ins)
        ins32 = (*_f32(a, w, r, sc), rstd, *_f32(drout, dy))
        refs = FN.plain_matmul_residual_norm_bwd(*ins32)
        grads32 = FN.matmul_residual_norm_bwd(*ins32)
        torch.cuda.synchronize()
        for n, x, x32, ref in zip(("r", "y", "rstd"), (r, y, rstd), got32,
                                  want):
            check(f"{what} {n}", x, ref,
                  **(RSTD_TOL if n == "rstd" else BF16_TOL))
            check(f"{what} f32 {n}", x32, ref, **F32_MATMUL_TOL)
        for n, x, x32, ref in zip(("da", "dw", "dresid", "dscale"), grads,
                                  grads32, refs):
            check(f"{what} {n}", x, ref, **GRAD_BF16_TOL)
            check(f"{what} f32 {n}", x32, ref, **F32_GRAD_TOL)
        if not all(torch.equal(x, z) for x, z in zip(grads, again)):
            raise AssertionError(f"{what}: two bf16 backward calls on the "
                                 "same inputs differ")
        _guarded_writes(f"{what} forward", lambda r_, y_, s_:
                        FN.matmul_residual_norm_kernel(
                            a.data_ptr(), w.data_ptr(), resid.data_ptr(),
                            sc.data_ptr(), r_.data_ptr(), y_.data_ptr(),
                            s_.data_ptr(), N, K, d, eps, code, stream),
                        (r, y, rstd))

        def bwd(*outs):
            FN.matmul_residual_norm_bwd_kernel(
                *(t.data_ptr() for t in ins), *(t.data_ptr() for t in outs),
                N, K, d, code, stream)

        # the entry point's own outputs: dscale in f32 and the scratch
        outs = (*(torch.empty_like(x) for x in grads[:3]),
                torch.empty(d, device=dev),
                torch.empty(-(-N // FN._BWD_ROWS), d, device=dev),
                torch.empty(FN._BWD_SPLITS, K, d, device=dev))
        bwd(*outs)
        if not (all(torch.equal(x, z) for x, z in zip(outs, grads[:3]))
                and torch.equal(outs[3].to(bf), grads[3])):
            raise AssertionError(f"{what}: the entry point's outputs differ "
                                 "from the wrapper's")
        _guarded_writes(f"{what} backward", bwd, outs[:4],
                        scratch=outs[4:])
        print(f"  {what}: bf16 backward bit-identical over two calls; "
              "guard bands intact", flush=True)


# the flash-CE kernels' edges: N ragged against the 128-row tiles, V ragged
# against the 128-column vocab tiles (1000, and GPT-2's real vocab 50257),
# and the model widths of gpt2_medium and gpt2_large, which the bf16
# kernels take as a runtime K (flash_ce._KERNEL_WIDTHS lists exactly the
# widths checked here and at the main path)
FLASH_CE_EDGES = tuple((N, 768, V) for N in (1, 63, 65, 200)
                       for V in (1000, 50257)) + (
    (200, 1024, 1000), (65, 1024, 50257), (200, 1280, 1000),
    (65, 1280, 50257))


def ragged_flash_ce_checks(dev) -> None:
    """The flash-CE kernels at ``FLASH_CE_EDGES``, with and without the
    norm prologue: the forward and backward in bf16 against the plain
    versions in f32, and (d = 768, the f32 kernels' width) in f32 against
    the same, under the main-path tolerances.  One target in seven is
    masked, the first row's target is column 0 and the last row's
    V - 1.  Every input sits between NaN guard bands of a 64-row block;
    both bf16 entry points run once more on outputs between -7.0 guard
    bands (``_guarded_writes``), and two bf16 backward calls must give
    the same bits (no atomics, ordered sums)."""
    from ray_tpu_torch.ops import flash_ce as FC

    g = torch.Generator(device=dev).manual_seed(8)
    randn = _randn(g, dev)
    bf, eps = torch.bfloat16, 1e-6
    stream = torch.cuda.current_stream(dev).cuda_stream
    for N, d, V in FLASH_CE_EDGES:
        for with_norm in (False, True):
            what = f"flash_ce ragged N={N} d={d} V={V} norm={with_norm}"
            sc = (1 + 0.1 * torch.randn(d, generator=g, device=dev)).to(bf)
            x, w, sc = map(_row_guarded, (randn(N, d), randn(V, d, s=0.02),
                                          sc))
            tgt = torch.randint(0, V, (N,), generator=g, device=dev,
                                dtype=torch.int32)
            tgt[::7] = -1
            tgt[0], tgt[-1] = (0, V - 1) if N > 1 else (0, 0)
            srow = (tgt >= 0).float()
            fnorm = (sc, eps) if with_norm else None
            out = FC.flash_ce_fwd(x, w, tgt, fnorm)
            want = FC.plain_flash_ce_fwd(*_f32(x, w), tgt,
                                         (sc.float(), eps) if with_norm
                                         else None)
            lse = _guarded(out[0], pad=64)
            rstd = _guarded(out[2], pad=64) if with_norm else None
            bnorm = (sc, eps, rstd) if with_norm else None
            bnorm32 = (sc.float(), eps, rstd) if with_norm else None
            grads = FC.flash_ce_bwd(x, w, tgt, lse, srow, bnorm)
            again = FC.flash_ce_bwd(x, w, tgt, lse, srow, bnorm)
            refs = FC.plain_flash_ce_bwd(*_f32(x, w), tgt, lse, srow,
                                         bnorm32)
            torch.cuda.synchronize()
            for n, a_, b_ in zip(("lse", "true", "rstd"), out, want):
                check(f"{what} {n}", a_, b_, **{"lse": CE_LSE_TOL,
                                                "true": CE_TRUE_TOL,
                                                "rstd": RSTD_TOL}[n])
            for n, a_, b_ in zip(("dx", "dw", "dscale"), grads, refs):
                check(f"{what} {n}", a_, b_, **GRAD_BF16_TOL)
            if not all(torch.equal(a_, b_) for a_, b_ in zip(grads, again)):
                raise AssertionError(f"{what}: two bf16 backward calls on "
                                     "the same inputs differ")
            if d in FC._KERNEL_WIDTHS[torch.float32]:
                got32 = FC.flash_ce_fwd(*_f32(x, w), tgt,
                                        (sc.float(), eps) if with_norm
                                        else None)
                grads32 = FC.flash_ce_bwd(*_f32(x, w), tgt, lse, srow,
                                          bnorm32)
                torch.cuda.synchronize()
                for n, a_, b_ in zip(("lse", "true", "rstd"), got32, want):
                    check(f"{what} f32 {n}", a_, b_, **F32_GRAD_TOL)
                for n, a_, b_ in zip(("dx", "dw", "dscale"), grads32, refs):
                    check(f"{what} f32 {n}", a_, b_, **F32_GRAD_TOL)
            code = FC._DTYPE_CODES[bf]
            ptr = (lambda t: None if t is None else t.data_ptr())
            ws = FC._workspace("flash_ce_fwd_workspace", N, d, V, with_norm,
                               bf, dev)

            def fwd(l_, t_, *r_):
                FC.flash_ce_fwd_kernel(
                    x.data_ptr(), w.data_ptr(), tgt.data_ptr(),
                    ptr(sc if with_norm else None), l_.data_ptr(),
                    t_.data_ptr(), r_[0].data_ptr() if r_ else None,
                    ws.data_ptr(), N, d, V, eps, int(with_norm), code,
                    stream)

            _guarded_writes(f"{what} forward", fwd, out)
            wsb = FC._workspace("flash_ce_bwd_workspace", N, d, V,
                                with_norm, bf, dev)
            expect = (grads[0], grads[1],
                      *((grads[2],) if with_norm else ()))

            def bwd(dx_, dw_, *ds_):
                FC.flash_ce_bwd_kernel(
                    x.data_ptr(), w.data_ptr(), tgt.data_ptr(),
                    lse.data_ptr(), srow.data_ptr(),
                    ptr(sc if with_norm else None), ptr(rstd),
                    dx_.data_ptr(), dw_.data_ptr(),
                    ds_[0].data_ptr() if ds_ else None, wsb.data_ptr(), N,
                    d, V, int(with_norm), code, stream)

            _guarded_writes(f"{what} backward", bwd, expect)
            print(f"  {what}: bf16 backward bit-identical over two calls; "
                  "guard bands intact", flush=True)


def attention_kernel_checks(rec: Recorder, randn, dev, H: int, *,
                            main: bool, B: int = None) -> dict:
    """The attention pair at [B, 1024, H, 64] (B: TRAIN_B unless given)
    with the training path's RoPE tables (positions 0..S-1, theta 10000,
    cast to bf16), bf16, against its plain version on the same inputs;
    returns the times.
    ``main``: GPT-2's 12 heads, the kernels' rows (``Recorder.record``)
    with the f32 instantiations and the times without RoPE besides;
    otherwise an extra shape of the rows (``Recorder.record(own=False)``):
    a tp rank's local heads, or a pipeline microbatch's or the MoE arm's
    batch.

    The bf16 kernel rounds the rotated q and k to bf16
    (attention.py:_rot), so its plain version in f32 takes them so
    rounded (qr, kr) and applies the transposed rotation to dq and dk
    itself; the f32 kernel is held to the plain version with the
    rotation inside, in f32."""
    import torch.nn.functional as F

    from ray_tpu_torch.ops import attention as A

    bf = torch.bfloat16
    B, S, D = B or TRAIN_B, TRAIN_S, TRAIN_D
    shape = f"[{B},{S},{H},{D}]"
    record = functools.partial(rec.record, own=main)
    scale = D ** -0.5
    q, k, v, do = (randn(B, S, H, D) for _ in range(4))
    rope = A.rope_tables(torch.arange(S, device=dev), D, 10000.0, bf)
    rope32 = _f32(*rope)
    qr, kr = (A._rot(x, *rope).float() for x in (q, k))
    o, lse = A.flash_attention_fwd(q, k, v, scale=scale, rope=rope)
    o_ref, lse_ref = A.plain_flash_attention_fwd(qr, kr, v.float(),
                                                 scale=scale)
    torch.cuda.synchronize()
    what = f"flash_attention_fwd rope {shape}"
    err = max(check(f"{what} o", o, o_ref, **BF16_TOL),
              check(f"{what} lse", lse, lse_ref, **LSE_TOL))
    del o_ref, lse_ref
    if main:
        o_ref32, lse_ref32 = A.plain_flash_attention_fwd(
            *_f32(q, k, v), scale=scale, rope=rope32)
        o32, lse32 = A.flash_attention_fwd(*_f32(q, k, v), scale=scale,
                                           rope=rope32)
        torch.cuda.synchronize()
        check(f"{what} f32 o", o32, o_ref32, **F32_TOL)
        check(f"{what} f32 lse", lse32, lse_ref32, **F32_TOL)
        del o_ref32, lse_ref32, o32, lse32
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
    tokens = B * S * H * D
    times = {"fwd_ms": time_ms(lambda: A.flash_attention_fwd(
        q, k, v, scale=scale, rope=rope), 5)}
    record("flash_attention_fwd", [B, S, H, D], err, times["fwd_ms"],
           time_ms(lambda: A.plain_flash_attention_fwd(
               q, k, v, scale=scale, rope=rope), 3),
           time_ms(lambda: F.scaled_dot_product_attention(
               qt, kt, vt, is_causal=True), 5),
           4 * tokens * 2 + B * H * S * 4 + 2 * S * D * 2,
           4 * B * H * D * S * (S + 1) / 2,
           "ray_tpu_torch/ops/csrc/flash_attention_fwd.cu",
           "ray_tpu/ops/attention.py:477")

    if main:
        # what the in-kernel RoPE costs: the same calls without it
        o_nr, lse_nr = A.flash_attention_fwd(q, k, v, scale=scale)
        t_f = time_ms(lambda: A.flash_attention_fwd(q, k, v, scale=scale),
                      5)
        t_b = time_ms(lambda: A.flash_attention_bwd(
            q, k, v, o_nr, lse_nr, do, scale=scale), 5)
        print(f"flash_attention {shape} without RoPE: forward {t_f:.4f} "
              f"ms, backward {t_b:.4f} ms", flush=True)
        del o_nr, lse_nr

    # the backward on the same inputs, with the bf16 forward's o and lse
    grads = A.flash_attention_bwd(q, k, v, o, lse, do, scale=scale,
                                  rope=rope)
    refs = bwd_reference(qr, kr, v, o, lse, do, scale, rope32)
    del qr, kr
    torch.cuda.synchronize()
    what = f"flash_attention_bwd rope {shape}"
    err = max(check(f"{what} {n}", x, y, **GRAD_BF16_TOL)
              for n, x, y in zip(("dq", "dk", "dv"), grads, refs))
    del grads, refs
    torch.cuda.empty_cache()
    if main:
        refs32 = A.plain_flash_attention_bwd(*_f32(q, k, v, o), lse,
                                             do.float(), scale=scale,
                                             rope=rope32)
        grads32 = A.flash_attention_bwd(*_f32(q, k, v, o), lse, do.float(),
                                        scale=scale, rope=rope32)
        torch.cuda.synchronize()
        for n, x, y in zip(("dq", "dk", "dv"), grads32, refs32):
            check(f"{what} f32 {n}", x, y, **F32_GRAD_TOL)
        del refs32, grads32
        torch.cuda.empty_cache()

    def sdpa_fwd_bwd():
        a, b, c = (x.detach().requires_grad_(True) for x in (qt, kt, vt))
        F.scaled_dot_product_attention(a, b, c, is_causal=True).backward(dot)

    times["bwd_ms"] = time_ms(lambda: A.flash_attention_bwd(
        q, k, v, o, lse, do, scale=scale, rope=rope), 5)
    record("flash_attention_bwd", [B, S, H, D], err, times["bwd_ms"],
           time_ms(lambda: A.plain_flash_attention_bwd(
               q, k, v, o, lse, do, scale=scale, rope=rope), 3),
           time_ms(sdpa_fwd_bwd, 5),
           8 * tokens * 2 + B * H * S * 4 + 2 * S * D * 2,
           5 * 2 * B * H * D * S * (S + 1) / 2,
           "ray_tpu_torch/ops/csrc/flash_attention_bwd.cu",
           "ray_tpu/ops/attention.py:925")
    del q, k, v, do, o, lse, qt, kt, vt, dot
    torch.cuda.empty_cache()
    return times


# a tp rank's local heads of GPT-2's 12: tp = 2 and tp = 4
TP_HEADS = (6, 3)


def tp_attention_phase(rec: Recorder, dev) -> dict:
    """The attention pair at the per-rank shapes a tp mesh gives GPT-2
    (12 heads over tp = 2 and 4: 6 and 3 local heads), held to its plain
    version as at 12 heads; prints the times beside the card's name and
    power limit and returns them by head count."""
    g = torch.Generator(device=dev).manual_seed(2)
    randn = _randn(g, dev)
    out = {}
    for H in TP_HEADS:
        out[H] = attention_kernel_checks(rec, randn, dev, H, main=False)
    print(f"tp per-rank attention on {card()}: " + json.dumps(
        {f"H={H}": t for H, t in out.items()}), flush=True)
    return out


def train_kernel_phase(rec: Recorder, dev) -> None:
    """The training path's kernels against their plain versions at its
    shapes: the flash forward with its RoPE tables, the attention
    backward, the epilogue forward and backward at N = 24576, flash-CE
    forward and backward with the norm prologue.  bf16 (timed) and f32,
    each against the plain version in f32 on the same inputs."""
    g = torch.Generator(device=dev).manual_seed(1)
    randn = _randn(g, dev)
    bf = torch.bfloat16
    print(f"training tolerances: grads bf16 {GRAD_BF16_TOL}, CE lse "
          f"{CE_LSE_TOL}, CE true {CE_TRUE_TOL}, grads f32 {F32_GRAD_TOL}",
          flush=True)

    attention_kernel_checks(rec, randn, dev, TRAIN_H, main=True)
    # the out-proj epilogue at the RL learner's N = 8 x 20 (extra shapes
    # of its rows) and at the training path's N, forward then backward,
    # then flash-CE
    epilogue_fwd_check(rec, randn, g, dev, RL_N, bf, own=False)
    epilogue_bwd_check(rec, randn, g, dev, RL_N, own=False)
    epilogue_fwd_check(rec, randn, g, dev, TRAIN_N, bf)
    epilogue_bwd_check(rec, randn, g, dev, TRAIN_N)
    rmsnorm_checks(rec, randn, g, dev)
    flash_ce_checks(rec, randn, g, dev, TRAIN_N)


def epilogue_bwd_check(rec: Recorder, randn, g, dev, N: int, *,
                       own: bool = True) -> None:
    """The epilogue's backward at [N, 768] in bf16, with cotangents into
    both outputs, against its plain version in f32 on the same inputs;
    ``own``: the row's shape, with the f32 instantiation checked too."""
    import torch.nn.functional as F

    from ray_tpu_torch.ops import fused_norm as FN

    bf = torch.bfloat16
    K = d = 768
    a = randn(N, K)
    w = randn(K, d, s=K ** -0.5)
    resid = randn(N, d)
    sc = (1 + 0.1 * torch.randn(d, generator=g, device=dev)).to(bf)
    rout, _y, rstd = FN.matmul_residual_norm_fwd(a, w, resid, sc)
    drout, dy = randn(N, d), randn(N, d)
    ins = (a, w, rout, sc, rstd, drout, dy)
    ins32 = (*_f32(a, w, rout, sc), rstd, *_f32(drout, dy))
    got = FN.matmul_residual_norm_bwd(*ins)
    want = FN.plain_matmul_residual_norm_bwd(*ins32)
    torch.cuda.synchronize()
    what = f"matmul_residual_norm_bwd N={N}"
    names = ("da", "dw", "dresid", "dscale")
    err = max(check(f"{what} {n}", x, y, **GRAD_BF16_TOL)
              for n, x, y in zip(names, got, want))
    if own:
        got32 = FN.matmul_residual_norm_bwd(*ins32)
        torch.cuda.synchronize()
        for n, x, y in zip(names, got32, want):
            check(f"{what} f32 {n}", x, y, **F32_GRAD_TOL)
        del got32

    def lib_epilogue():
        args = [x.detach().requires_grad_(True) for x in (a, w, resid, sc)]
        r = torch.addmm(args[2], args[0], args[1])
        y = F.rms_norm(r, (d,), args[3], 1e-6)
        torch.autograd.backward([r, y], [drout, dy])

    rec.record("matmul_residual_norm_bwd", [N, K, d], err,
               time_ms(lambda: FN.matmul_residual_norm_bwd(*ins), 10),
               time_ms(lambda: FN.plain_matmul_residual_norm_bwd(*ins), 5),
               time_ms(lib_epilogue, 10),
               (2 * N * K + 2 * K * d + 4 * N * d + 2 * d) * 2 + N * 4
               + d * 4,
               4 * N * K * d,
               "ray_tpu_torch/ops/csrc/matmul_residual_norm_bwd.cu",
               "ray_tpu/ops/fused_norm.py:247", own=own)
    del a, w, resid, rout, rstd, drout, dy, ins, ins32, got, want
    torch.cuda.empty_cache()


def flash_ce_checks(rec: Recorder, randn, g, dev, N: int, *,
                    own: bool = True, targets=None, V: int = None,
                    norm: bool = True) -> None:
    """flash-CE with the final-norm prologue at N rows: x the raw
    residual stream, w the tied embedding [V, d] at its init scale, one
    target in seven masked (or ``targets``: a packed batch's, ``-1`` at
    every document's end and on padding); the forward, then the backward
    with the cotangent of the summed loss (1), in bf16 against the plain
    versions in f32 on the same inputs; ``own``: the rows' shape, with
    the f32 instantiations checked too.  ``V``: the vocabulary (default
    TRAIN_V); ``norm=False``: no prologue, x the normed hidden itself
    (the GPT-2 exact architecture's LayerNorm with a bias, which the
    prologue declines)."""
    import torch.nn.functional as F

    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops import flash_ce as FC

    bf = torch.bfloat16
    V, d = V or TRAIN_V, 768
    tag = "norm" if norm else "no-norm"
    x = randn(N, d)
    w = randn(V, d, s=0.02)
    sc = (1 + 0.1 * torch.randn(d, generator=g, device=dev)).to(bf)
    if targets is None:
        tgt = torch.randint(0, V, (N,), generator=g, device=dev,
                            dtype=torch.int32)
        tgt[::7] = -1
    else:
        tgt = targets.reshape(N).to(dev, torch.int32)
    srow = (tgt >= 0).float()
    eps = 1e-6
    fnorm, fnorm32 = ((sc, eps), (sc.float(), eps)) if norm else (None, None)
    out = FC.flash_ce_fwd(x, w, tgt, fnorm)
    lse, true = out[0], out[1]
    rstd = out[2] if norm else None
    want = FC.plain_flash_ce_fwd(*_f32(x, w), tgt, fnorm32)
    torch.cuda.synchronize()
    what = f"flash_ce_fwd {tag} N={N} V={V}"
    err = max(check(f"{what} lse", lse, want[0], **CE_LSE_TOL),
              check(f"{what} true", true, want[1], **CE_TRUE_TOL),
              *([check(f"{what} rstd", rstd, want[2], **RSTD_TOL)]
                if norm else []))
    if own:
        got32 = FC.flash_ce_fwd(*_f32(x, w), tgt, fnorm32)
        torch.cuda.synchronize()
        for n, x32, y in zip(("lse", "true", "rstd"), got32, want):
            check(f"{what} f32 {n}", x32, y, **F32_GRAD_TOL)
        del got32
    del want
    torch.cuda.empty_cache()
    mask = tgt >= 0
    tgt_lib = tgt.long().masked_fill(~mask, -100)

    def lib_ce(backward: bool):
        xx, ww = (t.detach().requires_grad_(backward) for t in (x, w))
        y = F.rms_norm(xx, (d,), sc, eps) if norm else xx
        loss = F.cross_entropy(torch.matmul(y, ww.T).float(), tgt_lib,
                               reduction="sum")
        if backward:
            loss.backward()

    shape = [N, d, V] if norm else [N, d, V, "no-norm"]
    rec.record("flash_ce_fwd", shape, err,
               time_ms(lambda: FC.flash_ce_fwd(x, w, tgt, fnorm), 5),
               time_ms(lambda: FC.plain_flash_ce_fwd(x, w, tgt, fnorm), 3),
               time_ms(lambda: lib_ce(False), 3),
               (N * d + V * d + d * norm) * 2 + N * 4 + (2 + norm) * N * 4,
               2 * N * d * V,
               "ray_tpu_torch/ops/csrc/flash_ce_fwd.cu",
               "ray_tpu/ops/flash_ce.py:223", own=own)

    bnorm = (sc, eps, rstd) if norm else None
    bnorm32 = (sc.float(), eps, rstd) if norm else None
    got = FC.flash_ce_bwd(x, w, tgt, lse, srow, bnorm)
    again = FC.flash_ce_bwd(x, w, tgt, lse, srow, bnorm)
    if not all(torch.equal(a_, b_) for a_, b_ in zip(got, again)):
        raise AssertionError("flash_ce_bwd: two bf16 calls on the same "
                             "inputs differ")
    rows = _build.query("flash_ce_bwd_chunk_rows", N, d, V, int(norm), 1)
    print(f"  flash_ce_bwd {tag} N={N} V={V}: bf16 backward bit-identical "
          f"over two calls ({rows}-row chunks, as the library sets them)",
          flush=True)
    del again
    want = FC.plain_flash_ce_bwd(*_f32(x, w), tgt, lse, srow, bnorm32)
    torch.cuda.synchronize()
    what = f"flash_ce_bwd {tag} N={N} V={V}"
    names = ("dx", "dw", "dscale")
    err = max(check(f"{what} {n}", a_, b_, **GRAD_BF16_TOL)
              for n, a_, b_ in zip(names, got, want))
    if own:
        got32 = FC.flash_ce_bwd(*_f32(x, w), tgt, lse, srow, bnorm32)
        torch.cuda.synchronize()
        for n, a_, b_ in zip(names, got32, want):
            check(f"{what} f32 {n}", a_, b_, **F32_GRAD_TOL)
        del got32
    del got, want
    torch.cuda.empty_cache()
    rec.record("flash_ce_bwd", shape, err,
               time_ms(lambda: FC.flash_ce_bwd(x, w, tgt, lse, srow, bnorm),
                       3),
               time_ms(lambda: FC.plain_flash_ce_bwd(x, w, tgt, lse, srow,
                                                     bnorm), 3),
               time_ms(lambda: lib_ce(True), 3),
               (2 * N * d + 2 * V * d + d * norm) * 2
               + (3 + 2 * norm) * N * 4 + d * 4 * norm,
               3 * 2 * N * d * V,
               "ray_tpu_torch/ops/csrc/flash_ce_bwd.cu",
               "ray_tpu/ops/flash_ce.py:352", own=own)
    del x, w, tgt, lse, true, rstd, srow
    torch.cuda.empty_cache()


def stage_shape_phase(rec: Recorder, dev) -> None:
    """The training kernels at the per-call shapes of gpt2-train-pp (a
    microbatch of TRAIN_B / PP_M rows) and gpt2-train-moe (MOE_B rows):
    the attention pair, the epilogue forward and backward and flash-CE
    forward and backward, bf16 against their plain versions in f32 at
    the bounds above, as extra shapes of the rows."""
    g = torch.Generator(device=dev).manual_seed(3)
    randn = _randn(g, dev)
    for B in (TRAIN_B // PP_M, MOE_B):
        N = B * TRAIN_S
        attention_kernel_checks(rec, randn, dev, TRAIN_H, main=False, B=B)
        epilogue_fwd_check(rec, randn, g, dev, N, torch.bfloat16, own=False)
        epilogue_bwd_check(rec, randn, g, dev, N, own=False)
        flash_ce_checks(rec, randn, g, dev, N, own=False)


def dataset_shape_phase(rec: Recorder, dev) -> dict:
    """The attention pair at the per-call shape of gpt2-train-dataset and
    gpt2-train-lora ([DATASET_B, 1024, 12, 64]), bf16 against its plain
    version in f32 at the bounds above, as an extra shape of its rows;
    returns the times."""
    g = torch.Generator(device=dev).manual_seed(7)
    times = attention_kernel_checks(rec, _randn(g, dev), dev, TRAIN_H,
                                    main=False, B=DATASET_B)
    print(f"gpt2-train-dataset/-lora attention [{DATASET_B},{TRAIN_S},"
          f"{TRAIN_H},{TRAIN_D}]: " + json.dumps(times), flush=True)
    return times


GPT2 = dict(vocab_size=50304, max_seq=1024)
ENGINE = dict(slots=8, page_size=128)
# bf16 engine logits vs the f32 reference.  Random-init logits have an
# rms of ~0.55 (embed 0.02 x sqrt(768)).  Sound runs on an H100 left a
# largest error of 4.3e-2 and a mean error of 6.6e-3 (PERF.md); the
# limits are about twice and one and a half times those.  A fault that
# moves every logit a little (a position dropped from a context) shows
# in the mean first.
ENGINE_TOL = dict(atol=0.09)
ENGINE_MEAN_TOL = 0.01
# int8-cache engine logits vs the same f32 reference: K/V read back as
# int8 codes add up to half a step of each (position, head) vector's
# amax / 127 to every cached value.  The first sound run on an H100 read
# a largest error of 5.25e-2 and a mean error of 7.9e-3 (PERF.md); the
# limits are about twice and one and a half times those, as for
# ENGINE_TOL.
INT8_TOL = dict(atol=0.11)
INT8_MEAN_TOL = 0.012


def expect_launches(what: str, launches: dict, want: dict) -> None:
    """Raise unless every kernel launched exactly as ``want`` says, and
    every kernel ``want`` leaves out not at all."""
    full = {k: want.get(k, 0) for k in launches}
    if launches != full:
        raise AssertionError(f"{what}: launches {launches} != implied "
                             f"{full}")


def serve_launches(L: int, calls: dict, kv_dtype: str) -> dict:
    """The launches a serving run implies: per layer one prefill
    attention per cold prefill, one epilogue per prefill of either kind
    and per verify forward, one decode attention per decode dispatch."""
    decode = ("decode_attention_int8" if kv_dtype == "int8"
              else "decode_attention")
    return {"flash_attention_fwd": L * calls["prefill"],
            "matmul_residual_norm_fwd": L * (calls["prefill"]
                                             + calls["prefill_cached"]
                                             + calls["verify"]),
            decode: L * calls["decode"]}


def no_gather_in_decode(engine) -> None:
    """Make every decode step of ``engine`` raise if it gathers the paged
    context (``kv_cache.gather_pages``): the decode kernel reads the
    pages in place.  The cached prefill still gathers, outside the
    step."""
    from ray_tpu_torch.inference import kv_cache as kvc

    step, gather = engine._decode_step, kvc.gather_pages

    def refuse(*_args, **_kw):
        raise AssertionError("a decode step gathered the paged context")

    def decode_step(*args):
        kvc.gather_pages = refuse
        try:
            return step(*args)
        finally:
            kvc.gather_pages = gather

    engine._decode_step = decode_step


def serve(engine, prompts, sampling, max_new_tokens: int = 32) -> dict:
    """Submit every prompt at once (``max_new_tokens`` each), run the
    engine dry, and return what the run took: the launches, first-token
    times, outputs and the engine's call counts and seconds over the
    run."""
    from ray_tpu_torch.ops import _build

    calls0, secs0 = dict(engine.call_counts), dict(engine.seconds)
    _build.reset_launches()
    t0 = time.monotonic()
    rids = [engine.submit(p, max_new_tokens=max_new_tokens, sampling=sp)
            for p, sp in zip(prompts, sampling)]
    submitted = time.monotonic()
    first, last, out = {}, {}, {r: [] for r in rids}
    while engine.has_work():
        for rid, tok, _done in engine.step():
            last[rid] = time.monotonic()
            first.setdefault(rid, last[rid])
            out[rid].append(tok)
    torch.cuda.synchronize()
    run = dict(
        launches=_build.launch_counts(), rids=rids, out=out,
        wall=time.monotonic() - t0,
        ttft={r: first[r] - submitted for r in first},
        spans=[(len(out[r]), first[r], last[r]) for r in first],
        calls={k: v - calls0[k] for k, v in engine.call_counts.items()},
        secs={k: v - secs0[k] for k, v in engine.seconds.items()})
    if any(len(out[r]) != max_new_tokens for r in rids) or \
            len(first) != len(rids):
        raise AssertionError("not every request finished with "
                             f"{max_new_tokens} tokens")
    if not engine.leak_free():
        raise AssertionError("engine is not leak-free after the run")
    return run


def half_sampled(n: int):
    from ray_tpu_torch import SamplingParams
    sampled = SamplingParams(temperature=0.8, top_k=50, top_p=0.95)
    return [None if i % 2 == 0 else dataclasses.replace(sampled, seed=i)
            for i in range(n)]


def mixed_prompts():
    """gpt2-serve-mixed's 16 prompts of 40..900 tokens, from its seed."""
    rng = np.random.default_rng(0)
    lengths = np.linspace(40, 900, 16).astype(int)
    rng.shuffle(lengths)
    return [rng.integers(0, 50257, n).tolist() for n in lengths]


def engine_phase(params, cfg, dev) -> dict:
    """16 requests (prompts of 40..900 tokens, 32 new tokens each, half
    greedy and half sampled) through the engine with its defaults
    (prefix caching on, nothing to hit); prints the serving metrics and
    returns the launch counts of this run."""
    from ray_tpu_torch import InferenceEngine

    engine = InferenceEngine(cfg, params, device=dev, **ENGINE)
    no_gather_in_decode(engine)
    engine.generate([[1, 2, 3]], max_new_tokens=2)        # warm-up
    prompts = mixed_prompts()
    run = serve(engine, prompts, half_sampled(len(prompts)))
    prefills, decodes = run["calls"]["prefill"], run["calls"]["decode"]
    L = cfg.n_layers
    hits = engine.stats()["prefix"]
    if not engine.prefix or hits["requests_hit"] or prefills != 16:
        raise AssertionError(f"expected 16 cold prefills with prefix "
                             f"caching on and no hit: {hits}, {prefills} "
                             "prefills")
    expect_launches("gpt2-serve-mixed", run["launches"],
                    serve_launches(L, run["calls"], "model"))
    dec_s, pre_s = run["secs"]["decode"], run["secs"]["prefill"]
    dec_tokens = sum(len(v) - 1 for v in run["out"].values())
    metrics = {
        "cell": "gpt2-serve-mixed", "requests": len(prompts),
        "prefills": prefills, "decode_steps": decodes,
        "prefix_requests_hit": hits["requests_hit"],
        "mean_ttft_ms": 1e3 * float(np.mean(list(run["ttft"].values()))),
        "prefill_ms": 1e3 * pre_s / prefills,
        "decode_step_ms": 1e3 * dec_s / decodes,
        "decode_tokens_per_s": dec_tokens / dec_s,
        "wall_s": run["wall"],
    }
    print("engine phase: all 16 requests finished, leak-free, prefix cache "
          f"on with 0 hits; launches {run['launches']} == implied; no "
          "decode step gathered the paged context", flush=True)
    print("engine metrics " + json.dumps(metrics), flush=True)
    return run["launches"]


# gpt2-serve-int8-prefix: 4 system prompts of 512 tokens (4 full pages),
# each behind 4 of the 16 requests, with a unique suffix of 40..300 tokens
N_SYSTEM, SYSTEM_LEN = 4, 512


def prefix_traffic():
    """gpt2-serve-int8-prefix's traffic from its seed: a 200-token warm-up
    prompt, then 16 prompts, request i behind system prompt i % 4."""
    rng = np.random.default_rng(3)
    warm = rng.integers(0, 50257, 200).tolist()
    systems = [rng.integers(0, 50257, SYSTEM_LEN).tolist()
               for _ in range(N_SYSTEM)]
    suffixes = rng.integers(40, 301, 16)
    prompts = [systems[i % N_SYSTEM] + rng.integers(0, 50257, n).tolist()
               for i, n in enumerate(suffixes)]
    return warm, prompts


def int8_prefix_phase(params, cfg, dev) -> dict:
    """16 requests behind 4 shared system prompts through the int8-cache
    engine with prefix caching on, all submitted at once: the first
    request of each prompt prefills cold and registers its pages, the
    other 12 hit them and prefill only their suffix.  Checks the hits,
    the exact launches (decode runs the int8 kernel only; cached
    prefills attend in plain PyTorch) and the cache's size; prints TTFT
    for hit and cold requests apart, prefill and decode times."""
    from ray_tpu_torch import InferenceEngine

    engine = InferenceEngine(cfg, params, device=dev, kv_dtype="int8",
                             **ENGINE)
    no_gather_in_decode(engine)
    warm, prompts = prefix_traffic()
    engine.generate([warm, warm], max_new_tokens=2)   # warm-up, one hit
    hits0 = dict(engine.stats()["prefix"])
    run = serve(engine, prompts, half_sampled(len(prompts)))
    st = engine.stats()
    hit_reqs = st["prefix"]["requests_hit"] - hits0["requests_hit"]
    hit_tokens = st["prefix"]["hit_tokens"] - hits0["hit_tokens"]
    calls = run["calls"]
    L = cfg.n_layers
    if (hit_reqs, hit_tokens) != (12, 12 * SYSTEM_LEN) or \
            (calls["prefill"], calls["prefill_cached"]) != (4, 12):
        raise AssertionError(f"expected 12 hits of {SYSTEM_LEN} tokens and "
                             f"4 cold prefills: {hit_reqs} hits, "
                             f"{hit_tokens} tokens, calls {calls}")
    expect_launches("gpt2-serve-int8-prefix", run["launches"],
                    serve_launches(L, calls, "int8"))
    k = engine.cache.k
    bf16_bytes = 2 * k.numel() * 2
    if not st["cache_bytes"] < 0.55 * bf16_bytes:
        raise AssertionError(f"int8 cache {st['cache_bytes']} bytes is not "
                             f"under 0.55 x the bf16 cache's {bf16_bytes}")
    cold = [r for i, r in enumerate(run["rids"]) if i < N_SYSTEM]
    hit = [r for r in run["rids"] if r not in cold]
    metrics = {
        "cell": "gpt2-serve-int8-prefix", "requests": len(prompts),
        "prefix_requests_hit": hit_reqs, "hit_tokens": hit_tokens,
        "mean_ttft_ms_cold": 1e3 * float(np.mean([run["ttft"][r]
                                                  for r in cold])),
        "mean_ttft_ms_hit": 1e3 * float(np.mean([run["ttft"][r]
                                                 for r in hit])),
        "prefill_ms_cold": 1e3 * run["secs"]["prefill"] / calls["prefill"],
        "prefill_ms_cached": (1e3 * run["secs"]["prefill_cached"]
                              / calls["prefill_cached"]),
        "decode_steps": calls["decode"],
        "decode_step_ms": 1e3 * run["secs"]["decode"] / calls["decode"],
        "cache_bytes": st["cache_bytes"], "cache_bytes_bf16": bf16_bytes,
        "wall_s": run["wall"],
    }
    print("int8-prefix phase: all 16 requests finished, leak-free; 12 hits"
          f" of {SYSTEM_LEN} tokens; launches {run['launches']} == implied;"
          " no decode step gathered the paged context", flush=True)
    print("int8-prefix metrics " + json.dumps(metrics), flush=True)
    return run["launches"]


def to_cpu32(tree):
    return {k: to_cpu32(v) if isinstance(v, dict) else v.float().cpu()
            for k, v in tree.items()}


def against_reference(label, engine, params32, cfg32, prompts, outs,
                      tol, mean_tol, rids=None) -> dict:
    """Each request's engine logits against the teacher-forced f32 CPU
    ``forward`` over its own trajectory: every logit within ``tol``, the
    mean error within ``mean_tol``, and greedy tokens equal to the
    reference argmax wherever its top-2 margin is wider than twice the
    tolerance (at least one such token must occur).  ``rids``: the
    engine's ids of the requests (default 0, 1, ...: a fresh engine's
    ``generate``)."""
    from ray_tpu_torch.models.gpt import forward

    worst, errs, checked, agree, total = 0.0, [], 0, 0, 0
    for i, (prompt, gen) in enumerate(zip(prompts, outs)):
        rid = i if rids is None else rids[i]
        full = torch.tensor(prompt + gen[:-1])[None]
        with torch.inference_mode():
            ref = forward(params32, full, cfg32)[0][0, len(prompt) - 1:]
        got = torch.from_numpy(np.stack(engine.logits_trace[rid]))
        worst = max(worst, check(f"{label} logits request {rid}", got, ref,
                                 **tol))
        errs.append((got - ref).abs().flatten())
        top2 = ref.topk(2, -1).values
        sure = top2[:, 0] - top2[:, 1] > 2 * tol["atol"]
        gen_t = torch.tensor(gen)
        if (ref.argmax(-1)[sure] != gen_t[sure]).any():
            raise AssertionError(f"{label} request {rid}: a greedy token "
                                 "differs where the margin is wide")
        checked += int(sure.sum())
        agree += int((ref.argmax(-1) == gen_t).sum())
        total += len(gen)
    mean_err = torch.cat(errs).mean().item()
    if mean_err > mean_tol:
        raise AssertionError(f"{label} logits: mean abs error "
                             f"{mean_err:.3e} > {mean_tol}")
    if checked == 0:
        raise AssertionError("no greedy token has a margin wider than "
                             "twice the tolerance: nothing was checked")
    if not engine.leak_free():
        raise AssertionError(f"{label} engine is not leak-free")
    print(f"{label}: engine logits within atol {tol['atol']} of the f32 CPU "
          f"reference (max_abs_err={worst:.3e}, mean {mean_err:.3e} <= "
          f"{mean_tol}); {checked} greedy tokens with a margin over "
          f"{2 * tol['atol']} all agree; {agree}/{total} equal the "
          "reference argmax", flush=True)
    return dict(max_abs_err=worst, mean_abs_err=mean_err)


def correctness_phase(params, cfg, dev, *, norm_kernel: bool = False
                      ) -> dict:
    """Two greedy requests' engine logits (bf16, on the card) against
    the port's teacher-forced forward on the CPU in f32, same weights,
    under ``ENGINE_TOL`` and ``ENGINE_MEAN_TOL``.  With ``norm_kernel``
    the engine runs the model's RMSNorms through the RMSNorm kernel
    (``gpt._PALLAS_NORM``): once per layer (``ln1``) and for ``ln_f`` in
    a prefill, whose ``ln2`` the fused epilogue takes, and twice per
    layer plus ``ln_f`` in a decode step, where the epilogue declines
    S = 1.  Returns the run's launches."""
    from ray_tpu_torch import InferenceEngine
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.ops import _build

    engine = InferenceEngine(cfg, params, device=dev, debug_logits=True,
                             **ENGINE)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 50257, n).tolist() for n in (40, 300)]
    _build.reset_launches()
    gpt._PALLAS_NORM = norm_kernel
    try:
        outs = engine.generate(prompts, max_new_tokens=16)
    finally:
        gpt._PALLAS_NORM = False
    torch.cuda.synchronize()
    launches = _build.launch_counts()
    L, calls = cfg.n_layers, engine.call_counts
    norms = ((L + 1) * (calls["prefill"] + calls["prefill_cached"])
             + (2 * L + 1) * calls["decode"]) if norm_kernel else 0
    if launches["rmsnorm_fwd"] != norms or launches["rmsnorm_bwd"]:
        raise AssertionError(f"rmsnorm launches {launches} != {norms} "
                             f"implied by {calls}")
    label = "correctness norm kernel" if norm_kernel else "correctness"
    against_reference(label, engine, to_cpu32(params),
                      dataclasses.replace(cfg, dtype=torch.float32), prompts,
                      outs, ENGINE_TOL, ENGINE_MEAN_TOL)
    if norm_kernel:
        print(f"correctness norm kernel: rmsnorm_fwd launched {norms} times "
              f"({L + 1} per prefill, {2 * L + 1} per decode step; "
              f"{calls}), exact", flush=True)
    return launches


def int8_correctness_phase(params, cfg, dev) -> None:
    """A greedy request on the int8-cache engine, then the same prompt
    again as a prefix hit (two of its pages): both against the f32
    teacher-forced reference under ``INT8_TOL``, and the hit's logits
    against its cold run's, under the same bound, up to and including
    the first step where their tokens part (after it their contexts
    differ)."""
    from ray_tpu_torch import InferenceEngine

    engine = InferenceEngine(cfg, params, device=dev, kv_dtype="int8",
                             debug_logits=True, **ENGINE)
    prompt = np.random.default_rng(4).integers(0, 50257, 300).tolist()
    outs = [engine.generate([prompt], max_new_tokens=16)[0]
            for _ in range(2)]
    prefix = engine.stats()["prefix"]
    if (prefix["requests_hit"], prefix["hit_tokens"]) != (1, 256):
        raise AssertionError(f"the second request did not hit: {prefix}")
    against_reference("int8 correctness", engine, to_cpu32(params),
                      dataclasses.replace(cfg, dtype=torch.float32),
                      [prompt, prompt], outs, INT8_TOL, INT8_MEAN_TOL)
    parted = [i for i, (a, b) in enumerate(zip(*outs)) if a != b]
    n = parted[0] + 1 if parted else len(outs[0])
    cold, hit = (np.stack(engine.logits_trace[r][:n]) for r in (0, 1))
    check(f"int8 hit vs cold logits ({n} steps)", torch.from_numpy(hit),
          torch.from_numpy(cold), **INT8_TOL)


# the cell "gpt2-serve-spec": the JAX package's speculative-decoding
# bench (bench.py:1240-1380, bench_infer_spec) on GPT-2 124M at full
# width and depth: 2 slots, page 16, 4 requests of 256 new tokens each
# (the bench's 512 cut in half to keep the main run inside its time
# limit as the script grows) submitted one at a time (the latency-bound
# regime), greedy; two mixes
# from its seed, "templated" (a 48-token shared prefix + a per-request
# 6-token motif repeated 4 times; from the second request on the prefix
# hits) and "random" (72 i.i.d. tokens); arms spec off and k = 2, 4, 8
SPEC = dict(slots=2, page_size=16)
SPEC_REQUESTS, SPEC_NEW = 4, 256
SPEC_ARMS, SPEC_ARMS_FULL = (0, 4), (0, 2, 4, 8)
# then the serving geometry: 8 templated requests in flight, half greedy
# and half sampled, spec_k = 4 for all, half or none of them
SPEC_SERVE_REQUESTS, SPEC_SERVE_NEW = 8, 128


def spec_mixes(vocab: int) -> dict:
    """The reference bench's prompts, from its seed."""
    rng = np.random.RandomState(1)
    shared = rng.randint(0, vocab, 48).tolist()
    return {
        "templated": [shared + rng.randint(0, vocab, 6).tolist() * 4
                      for _ in range(SPEC_REQUESTS)],
        "random": [rng.randint(0, vocab, 72).tolist()
                   for _ in range(SPEC_REQUESTS)]}


def spec_sampling(sp, k: int):
    """``sp`` (None = greedy) with speculation on at ``k``, or pinned off
    (k = 0)."""
    from ray_tpu_torch import SamplingParams
    return dataclasses.replace(sp or SamplingParams(), spec=k > 0,
                               spec_k=k or None)


def spec_audit(what: str, engine) -> None:
    """Leak-free, and no drafter state left after the run and after
    ``drain_requests``."""
    st = engine.stats()
    engine.drain_requests()
    if not engine.leak_free() or st["spec"]["drafts"] or \
            engine.stats()["spec"]["drafts"] or st["active"]:
        raise AssertionError(f"{what}: not clean after the run: {st}")


def serve_one_at_a_time(engine, prompts, sp, max_new: int) -> dict:
    """Each prompt submitted alone and run dry before the next (the
    sequential regime of the reference bench).  Returns the outputs, the
    inter-token gaps (host clock between consecutive token events of a
    request; the tokens of one verify land together), each request's
    time from its first token to its last, the launches and the engine's
    call counts and seconds over the run."""
    from ray_tpu_torch.ops import _build

    calls0, secs0 = dict(engine.call_counts), dict(engine.seconds)
    _build.reset_launches()
    t0 = time.monotonic()
    outs, gaps, after_first = [], [], []
    for p in prompts:
        engine.submit(p, max_new_tokens=max_new, sampling=sp)
        toks, stamps = [], []
        while engine.has_work():
            for _rid, tok, _done in engine.step():
                stamps.append(time.monotonic())
                toks.append(tok)
        gaps += [b - a for a, b in zip(stamps, stamps[1:])]
        after_first.append(stamps[-1] - stamps[0])
        outs.append(toks)
    torch.cuda.synchronize()
    if any(len(o) != max_new for o in outs):
        raise AssertionError(f"not every request finished with {max_new} "
                             "tokens")
    return dict(
        outs=outs, gaps=gaps, after_first=after_first,
        wall=time.monotonic() - t0, launches=_build.launch_counts(),
        calls={k: v - calls0[k] for k, v in engine.call_counts.items()},
        secs={k: v - secs0[k] for k, v in engine.seconds.items()})


def spec_run_metrics(run: dict, spec: dict) -> dict:
    calls, secs = run["calls"], run["secs"]
    gaps = sorted(run["gaps"])
    return {
        "decode_tokens_per_s": (sum(len(o) - 1 for o in run["outs"])
                                / sum(run["after_first"])),
        "accept_rate": spec["accept_rate"], "k_hist": spec["k_hist"],
        "proposed": spec["proposed"], "accepted": spec["accepted"],
        "verify_calls": calls["verify"],
        "verify_ms": (1e3 * secs["verify"] / calls["verify"]
                      if calls["verify"] else None),
        "decode_dispatches": calls["decode"],
        "decode_step_ms": (1e3 * secs["decode"] / calls["decode"]
                           if calls["decode"] else None),
        "inter_token_p50_ms": 1e3 * gaps[len(gaps) // 2],
        "inter_token_p99_ms": 1e3 * gaps[int(0.99 * (len(gaps) - 1))],
        "wall_s": run["wall"]}


def spec_parity(what: str, off_engine, off_outs, outs) -> int:
    """Each greedy stream of a spec arm against the off arm's: equal up to
    their first difference, where the off arm's own top-2 logit margin
    must be under twice ``ENGINE_TOL``'s atol (verify and decode round
    differently in bf16: plain attention against the kernel, so a
    near-tie may flip; nothing else may).  Returns how many streams are
    identical end to end."""
    same = 0
    for rid, (want, got) in enumerate(zip(off_outs, outs)):
        parted = [i for i, (a, b) in enumerate(zip(want, got)) if a != b]
        if not parted:
            same += 1
            continue
        i = parted[0]
        top2 = np.sort(off_engine.logits_trace[rid][i])[-2:]
        margin = float(top2[1] - top2[0])
        print(f"  {what} request {rid}: parts from the off arm at token "
              f"{i}, where the off arm's top-2 margin is {margin:.4f}",
              flush=True)
        if margin >= 2 * ENGINE_TOL["atol"]:
            raise AssertionError(f"{what} request {rid}: the stream parts "
                                 f"from the off arm at token {i} with a "
                                 f"top-2 margin of {margin:.4f}")
    return same


def spec_sequential_phase(params, cfg, dev, arms) -> dict:
    """The reference bench's regime: per mix, the off arm, then each k
    arm, each on a fresh engine (2 slots, page 16, debug logits: the
    off arm's margins decide a parted stream), requests one at a time.
    Gates: every request finishes, leak-free, no drafter state, exact
    launches, proposals and acceptances on the templated mix, streams
    equal to the off arm's but after a near-tie.  Prints one line per
    arm; returns the launches of every arm."""
    from ray_tpu_torch import InferenceEngine

    L = cfg.n_layers
    mixes = spec_mixes(cfg.vocab_size)
    warm = InferenceEngine(cfg, params, device=dev, **SPEC)
    for k in SPEC_ARMS_FULL:                      # warm-up, every shape
        warm.generate(mixes["templated"][:2], max_new_tokens=24,
                      sampling=spec_sampling(None, k))
    del warm
    total = collections.Counter()
    for mix, prompts in mixes.items():
        base = None
        for k in arms:
            engine = InferenceEngine(cfg, params, device=dev,
                                     debug_logits=True, **SPEC)
            no_gather_in_decode(engine)
            run = serve_one_at_a_time(engine, prompts,
                                      spec_sampling(None, k), SPEC_NEW)
            what = f"gpt2-serve-spec {mix} k={k or 'off'}"
            spec = engine.stats()["spec"]
            spec_audit(what, engine)
            expect_launches(what, run["launches"],
                            serve_launches(L, run["calls"], "model"))
            total.update(run["launches"])
            if k and mix == "templated" and not (spec["proposed"]
                                                 and spec["accepted"]):
                raise AssertionError(f"{what}: nothing drafted or "
                                     f"accepted: {spec}")
            metrics = spec_run_metrics(run, spec)
            if base is None:
                base = dict(engine=engine, outs=run["outs"],
                            tps=metrics["decode_tokens_per_s"])
            else:
                metrics["streams_identical"] = spec_parity(
                    what, base["engine"], base["outs"], run["outs"])
            metrics["speedup_vs_off"] = (metrics["decode_tokens_per_s"]
                                         / base["tps"])
            print("spec arm " + json.dumps(dict(
                cell="gpt2-serve-spec", mix=mix, k=k or "off",
                requests=len(prompts), max_new_tokens=SPEC_NEW,
                **metrics)), flush=True)
        del base
    print(f"spec sequential arms {list(arms)}: every request finished, "
          "leak-free, no drafter state left, launches == implied, greedy "
          "streams equal to the off arm's but after a near-tie", flush=True)
    return total


def spec_correctness_phase(params, cfg, dev, kv_dtype: str) -> None:
    """Two templated greedy requests at once (the second hits the first's
    prefix), 64 new tokens, spec_k = 4, on a debug-logits engine: every
    logits row, verify rows included, against the f32 CPU teacher-forced
    reference under ``ENGINE_TOL`` (bf16) or ``INT8_TOL`` (int8)."""
    from ray_tpu_torch import InferenceEngine

    engine = InferenceEngine(cfg, params, device=dev, kv_dtype=kv_dtype,
                             debug_logits=True, **SPEC)
    prompts = spec_mixes(cfg.vocab_size)["templated"][:2]
    outs = engine.generate(prompts, max_new_tokens=64,
                           sampling=spec_sampling(None, 4))
    st = engine.stats()
    if not (st["calls"]["verify"] and st["spec"]["accepted"]
            and st["prefix"]["requests_hit"] == 1):
        raise AssertionError(f"spec correctness {kv_dtype}: no verify, "
                             f"no accepted draft or no hit: {st}")
    tol, mean_tol = ((INT8_TOL, INT8_MEAN_TOL) if kv_dtype == "int8"
                     else (ENGINE_TOL, ENGINE_MEAN_TOL))
    against_reference(f"spec correctness {kv_dtype}", engine,
                      to_cpu32(params),
                      dataclasses.replace(cfg, dtype=torch.float32),
                      prompts, outs, tol, mean_tol)
    print(f"spec correctness {kv_dtype}: {st['calls']['verify']} verifies, "
          f"spec {st['spec']}", flush=True)


def spec_serving_prompts(vocab: int):
    rng = np.random.RandomState(2)
    shared = rng.randint(0, vocab, 48).tolist()
    return [shared + rng.randint(0, vocab, 6).tolist() * 4
            for _ in range(SPEC_SERVE_REQUESTS)]


def spec_serving_phase(params, cfg, dev, kv_dtype: str) -> dict:
    """The serving geometry (8 slots, page 128), 8 templated requests in
    flight, half greedy and half sampled: spec_k = 4 for every request,
    for half of them (the other half co-batched through the decode kernel
    beside the speculating slots' dead rows), and for none.  Gates as in
    the sequential arms; prints each run's wall clock and how many
    streams, greedy and sampled, equal the off run's.  Returns the
    launches."""
    from ray_tpu_torch import InferenceEngine

    L = cfg.n_layers
    prompts = spec_serving_prompts(cfg.vocab_size)
    base = half_sampled(len(prompts))
    runs = {"all": [spec_sampling(sp, 4) for sp in base],
            "half": [spec_sampling(sp, 4 if i % 4 < 2 else 0)
                     for i, sp in enumerate(base)],
            "off": [spec_sampling(sp, 0) for sp in base]}
    total, outs, lines = collections.Counter(), {}, {}
    for name, sampling in runs.items():
        engine = InferenceEngine(cfg, params, device=dev, kv_dtype=kv_dtype,
                                 **ENGINE)
        no_gather_in_decode(engine)
        engine.generate([[1, 2, 3]], max_new_tokens=2)       # warm-up
        run = serve(engine, prompts, sampling, SPEC_SERVE_NEW)
        what = f"gpt2-serve-spec 8 slots {kv_dtype} spec={name}"
        spec = engine.stats()["spec"]
        spec_audit(what, engine)
        expect_launches(what, run["launches"],
                        serve_launches(L, run["calls"], kv_dtype))
        total.update(run["launches"])
        if name != "off" and not (spec["proposed"] and spec["accepted"]):
            raise AssertionError(f"{what}: nothing drafted or accepted: "
                                 f"{spec}")
        outs[name] = [run["out"][r] for r in run["rids"]]
        calls, secs = run["calls"], run["secs"]
        lines[name] = dict(
            cell="gpt2-serve-spec-8", kv_dtype=kv_dtype, spec=name,
            wall_s=run["wall"],
            tokens_per_s=len(prompts) * SPEC_SERVE_NEW / run["wall"],
            decode_dispatches=calls["decode"],
            decode_step_ms=(1e3 * secs["decode"] / calls["decode"]
                            if calls["decode"] else None),
            verify_calls=calls["verify"],
            verify_ms=(1e3 * secs["verify"] / calls["verify"]
                       if calls["verify"] else None),
            accept_rate=spec["accept_rate"], k_hist=spec["k_hist"])
    for name, line in lines.items():
        same = [a == b for a, b in zip(outs[name], outs["off"])]
        line["identical_greedy"] = sum(same[0::2])
        line["identical_sampled"] = sum(same[1::2])
        line["wall_vs_off"] = line["wall_s"] / lines["off"]["wall_s"]
        print("spec serving " + json.dumps(line), flush=True)
    print(f"spec serving {kv_dtype}: 3 runs of {len(prompts)} requests "
          "finished, leak-free, no drafter state left, launches == implied;"
          " no decode step gathered the paged context", flush=True)
    return total


def spec_phase(params, cfg, dev, arms=SPEC_ARMS) -> dict:
    """gpt2-serve-spec: the sequential arms, the correctness of spec
    greedy requests against the f32 reference (bf16 and int8), then the
    serving geometry in bf16 and int8.  Returns the launches of the
    timed runs (each with the counts at 0 just before it)."""
    launches = spec_sequential_phase(params, cfg, dev, arms)
    for kv_dtype in ("model", "int8"):
        spec_correctness_phase(params, cfg, dev, kv_dtype)
    for kv_dtype in ("model", "int8"):
        launches.update(spec_serving_phase(params, cfg, dev, kv_dtype))
    return launches


# ------------------------------------------------- the serving surface
def add_launches(total: dict, run: dict) -> dict:
    """Two runs' launch counts, kernel by kernel."""
    return {k: total.get(k, 0) + run.get(k, 0)
            for k in set(total) | set(run)}


def on_device(a, dev):
    """A handoff's or spill entry's host array (numpy, or a CPU tensor for
    bf16) on the card, for a bit-for-bit comparison there."""
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(a)
    return t.to(dev)


def page_bytes(cfg, int8: bool) -> int:
    """One page's K/V bytes over all layers: the model dtype, or int8
    codes and f32 scales."""
    from ray_tpu_torch.inference import kv_cache as kvc
    return kvc.handoff_page_bytes(
        n_layers=cfg.n_layers, page_size=ENGINE["page_size"],
        n_heads=cfg.n_heads, head_dim=cfg.head_dim,
        itemsize=1 if int8 else cfg.dtype.itemsize, quantized=int8)


def check_installed(what, engine, req, handoff) -> None:
    """The importer's cache pages of ``req`` against the handoff, bit for
    bit, at the context's positions (a page's positions past the context
    hold the exporter's garbage, or decode writes since)."""
    if not handoff.page_list:
        return
    ps, n_ctx = engine.page_size, len(handoff.context)
    names = ("k", "v") + (("k_scale", "v_scale") if engine.cache.quantized
                          else ())
    for name in names:
        cache = getattr(engine.cache, name)
        sent = on_device(getattr(handoff, name), cache.device)
        for i, src in enumerate(handoff.page_list):
            n = min(ps, n_ctx - src * ps)
            if not torch.equal(cache[:, req.pages[src], :n],
                               sent[:, i, :n]):
                raise AssertionError(f"{what}: installed page {src} "
                                     f"({name}) differs from the handoff")


def gap_free_trace(what, trace_mod, trace_id, want_names) -> None:
    """One trace: one root (``request``), every parent present, the span
    names ``want_names``."""
    spans = trace_mod.spans_for(trace_id)
    ids = {s["span_id"] for s in spans}
    roots = [s["name"] for s in spans if s["parent_id"] is None]
    dangling = [s["name"] for s in spans
                if s["parent_id"] is not None and s["parent_id"] not in ids]
    names = sorted(s["name"] for s in spans)
    if roots != ["request"] or dangling or names != sorted(want_names):
        raise AssertionError(f"{what}: trace is not one gap-free tree: "
                             f"roots {roots}, dangling {dangling}, names "
                             f"{names}")


DISAGG_NEW = 32
DISAGG_TRACED = 1        # a sampled request, traced across the handoff


def disagg_pair(what, pre, dec, prompts, sampling, trace_ctx=None,
                ship=None) -> dict:
    """Every request through the pair: a first-token-stop submission on
    ``pre`` (all at once, run dry), each exported (its arrays checked
    against the exporter's pages), then imported into ``dec`` for the
    remaining tokens and run dry, each install checked against its
    handoff.  ``ship`` maps a handoff to the form sent (a strip).
    Returns the streams, the launches of each side (counts at
    0 just before each), TTFTs, export and install times, the
    handoffs."""
    from ray_tpu_torch.inference import kv_cache as kvc
    from ray_tpu_torch.ops import _build

    _build.reset_launches()
    rids = [pre.submit(p, max_new_tokens=1, sampling=sp, hold_pages=True,
                       trace_ctx=trace_ctx if i == DISAGG_TRACED else None)
            for i, (p, sp) in enumerate(zip(prompts, sampling))]
    submitted = time.monotonic()
    first, handoffs, export_s = {}, {}, []
    while pre.has_work():
        for ev in pre.step():
            rid = ev[0]
            first[rid] = (int(ev[1]), time.monotonic() - submitted)
            # export at once: a held request keeps its pages until then
            pages = list(pre._held[rid].pages)
            t0 = time.monotonic()
            h = pre.export_request(rid)
            export_s.append(time.monotonic() - t0)
            # released, but nothing has overwritten them yet
            for name, arr in kvc.page_contents(
                    pre.cache, pages[:h.n_pages]).items():
                if not torch.equal(arr, on_device(getattr(h, name),
                                                  arr.device)):
                    raise AssertionError(f"{what}: handoff {name} of "
                                         f"request {rid} differs from the "
                                         "exporter's pages")
            handoffs[rid] = ship(h) if ship else h
    torch.cuda.synchronize()
    pre_launches = _build.launch_counts()
    handoffs = [handoffs[r] for r in rids]
    install_s = []
    inner = dec._install_import

    def timed_install(req, events):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        inner(req, events)
        torch.cuda.synchronize()
        install_s.append(time.monotonic() - t0)

    dec._install_import = timed_install
    secs0, calls0 = dict(dec.seconds), dict(dec.call_counts)
    _build.reset_launches()
    by_import = {dec.import_submit(h, max_new_tokens=DISAGG_NEW - 1,
                                   sampling=sp): i
                 for i, (h, sp) in enumerate(zip(handoffs, sampling))}
    out = {i: [first[r][0]] for i, r in enumerate(rids)}
    checked = set()
    while dec.has_work():
        for ev in dec.step():
            if ev.error is not None:
                raise AssertionError(f"{what}: import failed: {ev.error!r}")
            out[by_import[ev[0]]].append(int(ev[1]))
        for req in dec.scheduler.active.values():
            if req.rid not in checked:
                checked.add(req.rid)
                check_installed(what, dec, req,
                                handoffs[by_import[req.rid]])
    torch.cuda.synchronize()
    dec._install_import = inner
    return dict(out=[out[i] for i in range(len(prompts))],
                pre_launches=pre_launches,
                dec_launches=_build.launch_counts(),
                ttft=[first[r][1] for r in rids], export_s=export_s,
                install_s=install_s, handoffs=handoffs,
                decode_s=dec.seconds["decode"] - secs0["decode"],
                decode_calls=dec.call_counts["decode"] - calls0["decode"])


def disagg_phase(params, cfg, dev) -> dict:
    """gpt2-serve-disagg: a prefill engine and a decode engine (8 slots,
    page 128 each) on one card serve gpt2-serve-mixed's 16 requests, in
    bf16 and with the int8 cache (codes and scales move as they are),
    against a co-located engine on the same requests: every stream
    equal token for token, the handoff bit-equal to the exporter's pages
    and the installs to the handoff, exact byte figures and launches,
    both engines leak-free with nothing held.  Then one warm import of a
    whole-page context the importer holds by digest: no page moves, same
    stream.  One sampled request is traced across the handoff.  Returns
    the pair's launches (each side's counts at 0 just before it)."""
    from ray_tpu_torch import InferenceEngine
    from ray_tpu_torch.telemetry import trace as trace_mod

    prompts = mixed_prompts()
    sampling = half_sampled(len(prompts))
    L, n = cfg.n_layers, len(prompts)
    path: dict = {}
    for kv_dtype in ("model", "int8"):
        what = f"gpt2-serve-disagg {kv_dtype}"
        colo = InferenceEngine(cfg, params, device=dev, kv_dtype=kv_dtype,
                               **ENGINE)
        colo.generate([[1, 2, 3]], max_new_tokens=2)        # warm-up
        ref = serve(colo, prompts, sampling, DISAGG_NEW)
        want = [ref["out"][r] for r in ref["rids"]]
        pre = InferenceEngine(cfg, params, device=dev, kv_dtype=kv_dtype,
                              **ENGINE)
        dec = InferenceEngine(cfg, params, device=dev, kv_dtype=kv_dtype,
                              telemetry=True, **ENGINE)
        no_gather_in_decode(dec)
        trace_mod.reset()
        ctx = trace_mod.mint(sampled=True)
        root = trace_mod.record_span("request", ctx, start=time.time(),
                                     dur=0.0)
        run = disagg_pair(what, pre, dec, prompts, sampling,
                          trace_ctx=ctx.child(root))
        if run["out"] != want:
            parted = [i for i, (a, b) in enumerate(zip(run["out"], want))
                      if a != b]
            raise AssertionError(f"{what}: requests {parted} part from the "
                                 "co-located streams")
        decode = ("decode_attention_int8" if kv_dtype == "int8"
                  else "decode_attention")
        expect_launches(f"{what} exporter", run["pre_launches"],
                        {"flash_attention_fwd": L * n,
                         "matmul_residual_norm_fwd": L * n})
        expect_launches(f"{what} importer", run["dec_launches"],
                        {decode: L * run["decode_calls"]})
        path = add_launches(add_launches(path, run["pre_launches"]),
                            run["dec_launches"])
        per_page = page_bytes(cfg, kv_dtype == "int8")
        for h in run["handoffs"]:
            if h.nbytes != per_page * h.n_pages:
                raise AssertionError(f"{what}: handoff of {h.n_pages} pages "
                                     f"is {h.nbytes} bytes, not "
                                     f"{per_page} a page")
        if kv_dtype == "int8" and \
                per_page > 0.55 * page_bytes(cfg, False):
            raise AssertionError(f"{what}: an int8 page ({per_page} bytes) "
                                 "is over 0.55x a bf16 page")
        tel = dec.telemetry.summary()
        if (tel["requests_done"], tel["prefills"], tel["decode_steps"],
                tel["decode_tokens"]) != (n, 0, run["decode_calls"],
                                          n * (DISAGG_NEW - 1)):
            raise AssertionError(f"{what}: importer telemetry {tel} does not "
                                 f"count the run ({dec.call_counts})")
        gap_free_trace(what, trace_mod, ctx.trace_id,
                       ["request", "prefix_walk", "queue", "prefill",
                        "first_token", "prefix_walk", "handoff.install"])
        ticks = sum(ctx.trace_id in r["attributes"]["trace_ids"]
                    for r in trace_mod.recorder().spans()
                    if r["name"] == "decode_tick")
        if ticks != DISAGG_NEW - 1:
            raise AssertionError(f"{what}: {ticks} decode ticks name the "
                                 "traced request")
        # a warm import: a whole-page context the importer already holds
        warm = np.random.default_rng(5).integers(0, 50257, 512).tolist()
        greedy = [None]
        cold = disagg_pair(f"{what} warm-up", pre, dec, [warm], greedy)
        pre.scheduler.flush_prefix()        # the exporter prefills cold
        resident = dec.prefix_digest()
        hits0 = dec.scheduler.prefix_hit_pages
        # the sender strips the pages the target holds by digest: all 4
        w = disagg_pair(f"{what} warm", pre, dec, [warm], greedy,
                        ship=lambda h: h.strip_to(
                            [i for i in range(h.n_pages)
                             if i >= len(h.chain_hashes)
                             or h.chain_hashes[i] not in resident]))
        if w["handoffs"][0].nbytes or w["handoffs"][0].page_list:
            raise AssertionError(f"{what}: a warm handoff moves "
                                 f"{w['handoffs'][0].nbytes} bytes")
        if w["out"] != cold["out"] or dec.scheduler.prefix_hit_pages != \
                hits0 + 4:
            raise AssertionError(f"{what}: the warm import's stream "
                                 f"{w['out']} != the cold one's "
                                 f"{cold['out']}, or it did not take the "
                                 "4 resident pages as hits")
        for eng in (pre, dec):
            if not eng.leak_free() or eng.stats()["held"]:
                raise AssertionError(f"{what}: not leak-free after the run")
        dec_tokens = n * (DISAGG_NEW - 1)
        metrics = {
            "cell": "gpt2-serve-disagg", "kv_dtype": kv_dtype,
            "requests": n,
            "export_ms_per_request": 1e3 * float(np.mean(run["export_s"])),
            "install_ms_per_request": 1e3 * float(np.mean(run["install_s"])),
            "handoff_mb_per_request": float(np.mean(
                [h.nbytes for h in run["handoffs"]])) / 1e6,
            "export_gb_per_s": (sum(h.nbytes for h in run["handoffs"])
                                / sum(run["export_s"]) / 1e9),
            "install_gb_per_s": (sum(h.nbytes for h in run["handoffs"])
                                 / sum(run["install_s"]) / 1e9),
            "mean_ttft_ms_pair": 1e3 * float(np.mean(run["ttft"])),
            "mean_ttft_ms_colocated": 1e3 * float(np.mean(
                list(ref["ttft"].values()))),
            "decode_tokens_per_s_pair": dec_tokens / run["decode_s"],
            "decode_tokens_per_s_colocated": dec_tokens
            / ref["secs"]["decode"],
            "decode_steps_pair": run["decode_calls"],
            "decode_steps_colocated": ref["calls"]["decode"],
        }
        print(f"{what}: 16 streams equal the co-located engine's; handoffs "
              "bit-equal to the exporter's pages and installs to the "
              f"handoffs; {per_page} bytes a page; launches exact (exporter "
              f"{launches_line(run['pre_launches'])}, importer "
              f"{launches_line(run['dec_launches'])}); one gap-free trace; "
              "leak-free, nothing held", flush=True)
        print("disagg metrics " + json.dumps(metrics), flush=True)
        del colo, pre, dec
        gc.collect()
        torch.cuda.empty_cache()
    return path


# gpt2-serve-tiers: gpt2-serve-int8-prefix's 16 requests in 8 waves of
# the 2 requests behind one system prompt, each wave run dry before the
# next: round 1 serves systems 0..3 (requests s, s + 4), round 2 the same
# systems again (s + 8, s + 12).  10 usable pages hold about one wave, so
# each wave reclaims the previous waves' idle pages, and every system's 4
# pages are demoted before round 2 comes back to them: 16 promoted pages
# (the host logic decides it; a CPU rehearsal of the same lengths gives 7
# from the host pool and 9 from the store with 16 host pages)
TIER_ENGINE = dict(num_pages=11, host_pages=16, store=True)
TIER_WAVES = [[s, s + 4] for s in range(N_SYSTEM)] + \
    [[s + 8, s + 12] for s in range(N_SYSTEM)]
TIER_PROMOTED = 16
TIER_ARMS = (("bf16-model-spill", dict(kv_dtype="model",
                                       spill_dtype="model")),
             ("int8-cache", dict(kv_dtype="int8")),
             ("bf16-int8-spill", dict(kv_dtype="model",
                                      spill_dtype="int8")))


def serve_waves(engine, prompts, sampling, waves, max_new=32) -> dict:
    """Each wave's requests submitted together and run dry before the
    next; returns the streams by request index, TTFTs, the launches (the
    counts at 0 just before), the call counts and seconds over it."""
    from ray_tpu_torch.ops import _build

    calls0, secs0 = dict(engine.call_counts), dict(engine.seconds)
    _build.reset_launches()
    out, ttft, rid_of = {}, {}, {}
    for wave in waves:
        t0 = time.monotonic()
        for i in wave:
            rid_of[engine.submit(prompts[i], max_new_tokens=max_new,
                                 sampling=sampling[i])] = i
        while engine.has_work():
            for ev in engine.step():
                i = rid_of[ev[0]]
                if i not in out:
                    ttft[i] = time.monotonic() - t0
                out.setdefault(i, []).append(int(ev[1]))
    torch.cuda.synchronize()
    if any(len(out[i]) != max_new for i in range(len(prompts))):
        raise AssertionError("not every request finished")
    return dict(out=out, ttft=ttft, launches=_build.launch_counts(),
                rid_of={i: r for r, i in rid_of.items()},
                calls={k: v - calls0[k] for k, v in
                       engine.call_counts.items()},
                secs={k: v - secs0[k] for k, v in engine.seconds.items()})


def tiers_phase(params, cfg, dev) -> dict:
    """gpt2-serve-tiers: per arm, the waves through an engine whose idle
    prefix pages are demoted to a 16-page host pool and on to a page
    store, against the same waves on an engine that keeps every page
    resident.  In the exact arms (bf16 with the model-dtype spill, the
    int8 cache's own codes) every stream equals the resident engine's,
    the promoted requests' included; with the int8 spill of a bf16
    cache the promoted greedy requests' logits are held to the f32
    reference under ``INT8_TOL``.  Every arm: the 16 promotions, spill
    bytes equal to the per-page figure times the spills, exact
    launches, telemetry equal to the engine's counters, leak-free with
    the host partition, no store fetch in flight.  Returns the tiered
    runs' launches."""
    from ray_tpu_torch import InferenceEngine

    _warm, prompts = prefix_traffic()
    sampling = half_sampled(len(prompts))
    L = cfg.n_layers
    path: dict = {}
    cfg32, params32 = None, None
    for arm, kw in TIER_ARMS:
        what = f"gpt2-serve-tiers {arm}"
        exact = kw.get("spill_dtype") != "int8"
        resident = InferenceEngine(cfg, params, device=dev, prefix=True,
                                   **kw, **ENGINE)
        ref = serve_waves(resident, prompts, sampling, TIER_WAVES)
        engine = InferenceEngine(cfg, params, device=dev, telemetry=True,
                                 debug_logits=not exact, **kw,
                                 **TIER_ENGINE, **ENGINE)
        no_gather_in_decode(engine)
        run = serve_waves(engine, prompts, sampling, TIER_WAVES)
        expect_launches(what, run["launches"],
                        serve_launches(L, run["calls"], engine.kv_dtype))
        path = add_launches(path, run["launches"])
        st = engine.stats()["tiers"]
        promoted = st["hits"]["dram"] + st["hits"]["store"]
        if promoted < TIER_PROMOTED or st["fetches"] != promoted:
            raise AssertionError(f"{what}: {promoted} promoted pages, "
                                 f"{TIER_PROMOTED} implied: {st}")
        per_page = page_bytes(cfg, not (exact
                                        and engine.kv_dtype == "model"))
        spills = st["host"]["spills"]
        if st["spill_bytes"] != per_page * spills or not spills:
            raise AssertionError(f"{what}: spill bytes {st['spill_bytes']} "
                                 f"!= {per_page} x {spills} spills")
        if not engine.leak_free() or engine.store.in_flight:
            raise AssertionError(f"{what}: not leak-free after the run")
        tel = engine.telemetry.summary()["tiers"]
        if (tel["spill_bytes"], tel["fetches"],
                {k: v for k, v in st["hits"].items() if v}) != \
                (st["spill_bytes"], st["fetches"], tel["hits"]):
            raise AssertionError(f"{what}: telemetry {tel} != the engine's "
                                 f"counters {st}")
        promoted_reqs = [s + 8 for s in range(N_SYSTEM)]
        if exact:
            parted = [i for i in range(len(prompts))
                      if run["out"][i] != ref["out"][i]]
            if parted:
                raise AssertionError(f"{what}: requests {parted} part from "
                                     "the resident engine's streams")
            checked = "16 streams equal the resident engine's"
        else:
            if params32 is None:
                params32 = to_cpu32(params)
                cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
            greedy = [i for i in promoted_reqs if sampling[i] is None]
            engine.logits_trace = {
                k: engine.logits_trace[run["rid_of"][i]]
                for k, i in enumerate(greedy)}
            against_reference(f"{what} promoted", engine, params32, cfg32,
                              [prompts[i] for i in greedy],
                              [run["out"][i] for i in greedy], INT8_TOL,
                              INT8_MEAN_TOL)
            checked = (f"promoted greedy requests {greedy} within "
                       f"atol {INT8_TOL['atol']} of the f32 reference")
        cold = [s for s in range(N_SYSTEM)]
        hbm = [s + 4 for s in range(N_SYSTEM)] + \
            [s + 12 for s in range(N_SYSTEM)]
        metrics = {
            "cell": "gpt2-serve-tiers", "arm": arm,
            "spills": spills, "spill_bytes": st["spill_bytes"],
            "promoted_dram": st["hits"]["dram"],
            "promoted_store": st["hits"]["store"],
            "hbm_hits": st["hits"]["hbm"],
            "fetch_ms_per_page": 1e3 * st["fetch_seconds"] / st["fetches"],
            "mean_ttft_ms_cold": 1e3 * float(np.mean(
                [run["ttft"][i] for i in cold])),
            "mean_ttft_ms_hbm_hit": 1e3 * float(np.mean(
                [run["ttft"][i] for i in hbm])),
            "mean_ttft_ms_promoted": 1e3 * float(np.mean(
                [run["ttft"][i] for i in promoted_reqs])),
            "mean_ttft_ms_promoted_resident_engine": 1e3 * float(np.mean(
                [ref["ttft"][i] for i in promoted_reqs])),
            "store": {k: engine.store.stats()[k]
                      for k in ("puts", "gets", "evictions")},
        }
        print(f"{what}: {checked}; {promoted} pages promoted "
              f"({st['hits']['dram']} host, {st['hits']['store']} store), "
              f"{spills} spills of {per_page} bytes; launches "
              f"{launches_line(run['launches'])} == implied; leak-free",
              flush=True)
        print("tiers metrics " + json.dumps(metrics), flush=True)
        del resident, engine
        gc.collect()
        torch.cuda.empty_cache()
    return path


# the chaos legs of the tier cell run the model in f32: a fault turns a
# promoted (cached) prefill into a cold one, and in bf16 the two round
# differently (plain attention against the flash kernel), which moves a
# greedy token at a bf16 tie; in f32 a stream must not move
CHAOS_NEW = 16


def serving_obs_phase(params, cfg, dev) -> None:
    """Deadlines, chaos, telemetry and the watchdog on the card, on warm
    kernels, with every budget well above a warm step."""
    from ray_tpu_torch import InferenceEngine
    from ray_tpu_torch.inference import DeadlineExceededError
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.resilience import EngineWatchdog
    from ray_tpu_torch.util import chaos

    rng = np.random.default_rng(11)
    engine = InferenceEngine(cfg, params, device=dev, slots=1,
                             page_size=128)
    engine.generate([rng.integers(0, 50257, 100).tolist()],
                    max_new_tokens=8)                      # warm-up
    t0 = time.monotonic()
    engine.generate([rng.integers(0, 50257, 100).tolist()],
                    max_new_tokens=9)
    step_s = (time.monotonic() - t0) / 9
    ttft_budget, total_budget = max(0.25, 10 * step_s), max(0.5, 20 * step_s)
    # a queued request's TTFT budget runs out behind a long one
    r1 = engine.submit(rng.integers(0, 50257, 200).tolist(),
                       max_new_tokens=int(3 * ttft_budget / step_s) + 8)
    r2 = engine.submit(rng.integers(0, 50257, 100).tolist(),
                       max_new_tokens=4, ttft_deadline_s=ttft_budget)
    errs, toks = {}, {}
    wd = EngineWatchdog(engine, timeout_s=total_budget)
    with wd:
        while engine.has_work():
            for ev in engine.step():
                if ev.error is not None:
                    errs[ev[0]] = ev.error
                else:
                    toks[ev[0]] = toks.get(ev[0], 0) + 1
    if set(errs) != {r2} or errs[r2].kind != "ttft" or r2 in toks or \
            not isinstance(errs[r2], DeadlineExceededError):
        raise AssertionError(f"ttft deadline: errors {errs}, tokens {toks}")
    # a total budget retires a request mid-decode
    r3 = engine.submit(rng.integers(0, 50257, 100).tolist(),
                       max_new_tokens=int(3 * total_budget / step_s) + 8,
                       deadline_s=total_budget)
    n3, err3 = 0, None
    while engine.has_work():
        for ev in engine.step():
            if ev.error is not None:
                err3 = ev.error
            else:
                n3 += 1
    if not isinstance(err3, DeadlineExceededError) or err3.kind != "total" \
            or err3.rid != r3 or not 1 <= n3:
        raise AssertionError(f"total deadline: {err3!r} after {n3} tokens")
    if not engine.leak_free() or engine.deadline_exceeded != 2 or \
            wd.wedges:
        raise AssertionError("deadlines: not leak-free, or miscounted, or "
                             "the watchdog fired on a live engine")
    print(f"deadlines: a queued request's {ttft_budget:.3f} s TTFT budget "
          f"expired, a {total_budget:.3f} s total budget retired a request "
          f"after {n3} tokens (warm step {1e3 * step_s:.2f} ms); "
          "leak-free; the watchdog saw no wedge", flush=True)
    # infer.decode fires before the decode step launches anything
    engine = InferenceEngine(cfg, params, device=dev, slots=2,
                             page_size=128)
    for n in (300, 40):
        engine.submit(rng.integers(0, 50257, n).tolist(), max_new_tokens=16)
    engine.step()
    engine.step()
    torch.cuda.synchronize()
    before = [engine.cache.k.clone(), engine.cache.v.clone(),
              engine.scheduler.lengths.copy()]
    plan = chaos.install_faults("infer.decode@1")
    _build.reset_launches()
    try:
        engine.step()
        raise AssertionError("infer.decode@1 did not fire")
    except chaos.InjectedFault:
        pass
    finally:
        chaos.clear_faults()
    torch.cuda.synchronize()
    launched = {k: v for k, v in _build.launch_counts().items() if v}
    if launched or plan.fired != [("infer.decode", 1)] or \
            not torch.equal(engine.cache.k, before[0]) or \
            not torch.equal(engine.cache.v, before[1]) or \
            (engine.scheduler.lengths != before[2]).any():
        raise AssertionError(f"infer.decode: launched {launched} or changed "
                             "the cache before raising")
    if engine.drain_requests() != 2 or not engine.leak_free():
        raise AssertionError("infer.decode: the engine did not drain clean")
    print("chaos infer.decode@1: raised before any launch, cache "
          "bit-identical, drained leak-free", flush=True)
    del engine, before
    # the tier legs' faults, in f32
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    params32 = {k: (v.float() if isinstance(v, torch.Tensor) else
                    {kk: vv.float() for kk, vv in v.items()})
                for k, v in params.items()}
    _warm, prompts = prefix_traffic()
    system = prompts[0][:SYSTEM_LEN]
    a = system + rng.integers(0, 50257, 40).tolist()
    revisit = system + rng.integers(0, 50257, 40).tolist()
    pressure = rng.integers(0, 50257, 600).tolist()
    cold = InferenceEngine(cfg32, params32, device=dev, slots=1,
                           page_size=128).generate(
        [revisit], max_new_tokens=CHAOS_NEW)[0]
    legs = {}
    for spec in (None, "kv.spill@1", "kv.spill@4", "kv.fetch@1"):
        eng = InferenceEngine(cfg32, params32, device=dev, slots=1,
                              page_size=128, num_pages=6, host_pages=2,
                              store=True, spill_dtype="model")
        eng.generate([a], max_new_tokens=8)
        plan = chaos.install_faults(spec) if spec else None
        try:
            eng.generate([pressure], max_new_tokens=8)
            out = eng.generate([revisit], max_new_tokens=CHAOS_NEW)[0]
        finally:
            chaos.clear_faults()
        st = eng.stats()["tiers"]
        faults = (st["spill_faults"] + st["host"]["dropped"]
                  + st["fetch_faults"])
        if out != cold or not eng.leak_free() or eng.store.in_flight or \
                (spec and (not plan.fired or not faults)) or \
                (not spec and st["fetches"] != 4):
            raise AssertionError(f"chaos {spec}: stream {out} vs cold "
                                 f"{cold}, tiers {st}")
        legs[spec or "none"] = {"promoted": st["fetches"],
                                "faults": faults}
    print(f"chaos tier legs (f32): {json.dumps(legs)}; every revisit's "
          "greedy stream equals the cold run's; leak-free", flush=True)


# gpt2-serve-fleet: 3 replicas of the serving engine (8 slots, page 128
# each) on the one card, sharing the main run's parameter tensors, behind
# the fleet router (``ray_tpu_torch.fleet``).  Arms 1-3 route with
# ``slow_factor=0`` and no hedging, so their routing is a function of the
# traffic and the seed alone (latency scores are wall-clock EWMAs); arm 4
# turns both on.  Every stream that took the same path as a one-engine
# run (cold or hit, the same page producer, the same kernels) must equal
# it token for token, sampled ones included; a greedy stream whose path
# changed (a failover's re-prefill, a hit on pages another prefill made)
# may part from it only where the f32 reference's top-2 margin is under
# 2 x ENGINE_TOL (ROADMAP Queue 3 (c)).
FLEET_REPLICAS = 3
FLEET_NEW = 32
FLEET_CFG = dict(hedge=False, slow_factor=0.0, dwell=0.0, backoff=0.0)
# arm 2: the 16th replica tick dies: the first poll's 3 ticks admit and
# prefill every request, so this is the first replica's 6th tick, mid
# decode with its streams bound
FLEET_KILL_AT = 16
# arm 4: the slowed replica's ticks sleep this long (a healthy tick is
# ~10-25 ms of host time), and requests arrive this far apart
FLEET_SLOW_S, FLEET_GAP_S = 0.25, 0.05
FLEET_LIMIT_S = 120.0


def fleet_replica(cfg, params, dev, rid, **kw):
    """One replica on the card, on the caller's parameter tensors (the
    engine keeps tensors already on its device: no copy per replica)."""
    from ray_tpu_torch import InferenceEngine
    from ray_tpu_torch.fleet import EngineReplica
    return EngineReplica(rid, InferenceEngine(cfg, params, device=dev,
                                              **kw, **ENGINE))


def fleet_payload(prompt, sp, max_new: int = FLEET_NEW) -> dict:
    """The serving request dict of a prompt and its sampling."""
    p = {"tokens": prompt, "max_new_tokens": max_new}
    if sp is not None:
        p.update(temperature=sp.temperature, top_k=sp.top_k,
                 top_p=sp.top_p, seed=sp.seed)
    return p


def watch_paths(replicas) -> dict:
    """Record each admitted request's path: prompt -> (replica id,
    prefix-hit pages) for every prefill of these replicas' engines."""
    paths = {}
    for rep in replicas:
        eng, rid = rep.engine, rep.id

        def prefill(req, events, _inner=eng._prefill, _rid=rid):
            paths[tuple(req.prompt)] = (_rid, req.n_hit_pages)
            return _inner(req, events)

        eng._prefill = prefill
    return paths


def drive(router, prompts, sampling, waves, *, reconcile=None,
          on_poll=None, on_route=None, gap=0.0) -> dict:
    """Route each wave's requests (at once, or ``gap`` seconds apart) and
    poll the fleet until they end, then quiesce; every stream must end
    with FLEET_NEW tokens and no error.  ``on_route(stream)`` runs after
    each routing, ``reconcile()`` and ``on_poll()`` after each poll."""
    streams = {}
    t0 = time.monotonic()
    for wave in waves:
        pending = list(wave)
        while pending or not all(streams[i].done for i in wave):
            due = time.monotonic() - t0
            while pending and (not gap or len(streams) * gap <= due):
                i = pending.pop(0)
                streams[i] = router.remote(fleet_payload(prompts[i],
                                                         sampling[i]))
                if on_route is not None:
                    on_route(streams[i])
            progressed = router.poll()
            if reconcile is not None:
                reconcile()
            if on_poll is not None:
                on_poll()
            if not progressed:
                time.sleep(0.001)
            if time.monotonic() - t0 > FLEET_LIMIT_S:
                raise AssertionError("a fleet run did not end")
    if not router.quiesce():
        raise AssertionError("the fleet did not quiesce")
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    for i, s in streams.items():
        if s.error is not None or len(s.generated) != FLEET_NEW:
            raise AssertionError(f"fleet stream {i}: {s.error!r}, "
                                 f"{len(s.generated)} tokens")
    return dict(streams=streams, wall=wall,
                out={i: [int(t) for t in s.generated]
                     for i, s in streams.items()})


def fleet_launches(what, engines, kv_dtype: str, L: int) -> dict:
    """The launches since the counts were reset must be what the calls of
    every engine the run built imply, dead ones included."""
    from ray_tpu_torch.ops import _build
    want: dict = {}
    for eng in engines:
        want = add_launches(want, serve_launches(L, eng.call_counts,
                                                 kv_dtype))
    launches = _build.launch_counts()
    expect_launches(what, launches, want)
    return launches


def parted_within_margin(what, prompt, got, want, params32, cfg32):
    """A stream whose path changed may part from the one-engine stream
    only where the f32 reference's top-2 margin over the common context
    is under twice ENGINE_TOL; returns (position, margin) or None."""
    from ray_tpu_torch.models.gpt import forward
    k = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b), None)
    if k is None:
        return None
    with torch.inference_mode():
        logits = forward(params32, torch.tensor(prompt + got[:k])[None],
                         cfg32)[0][0, -1]
    top2 = logits.topk(2).values
    margin = float(top2[0] - top2[1])
    if margin >= 2 * ENGINE_TOL["atol"]:
        raise AssertionError(f"{what}: parts from the one-engine stream at "
                             f"token {k} where the f32 margin is "
                             f"{margin:.4f}")
    return k, margin


def fleet_metrics(arm, run, tel, **extra) -> dict:
    """TTFT (submit to first token) over the streams and decode tokens/s
    over the run's wall time, with the telemetry summary."""
    ss = list(run["streams"].values())
    ttft = sorted(s.first_token_ts - s.submitted_ts for s in ss)

    def pct(q):
        return 1e3 * ttft[min(len(ttft) - 1, int(q * len(ttft)))]

    return {"cell": "gpt2-serve-fleet", "arm": arm, "requests": len(ss),
            "ttft_ms_mean": 1e3 * float(np.mean(ttft)),
            "ttft_ms_p50": pct(0.5), "ttft_ms_p99": pct(0.99),
            "decode_tokens_per_s": sum(len(s.generated) - 1 for s in ss)
            / run["wall"], "wall_s": run["wall"], **extra,
            "telemetry": tel.summary()}


def one_engine_metrics(traffic, run) -> dict:
    """The same figures for a one-engine run (``serve``/``serve_waves``)."""
    ttft = sorted(run["ttft"].values())
    wall = run["wall"]
    return {"cell": "gpt2-serve-fleet", "arm": f"one engine, {traffic}",
            "ttft_ms_mean": 1e3 * float(np.mean(ttft)),
            "ttft_ms_p50": 1e3 * ttft[len(ttft) // 2],
            "ttft_ms_p99": 1e3 * ttft[min(len(ttft) - 1,
                                          int(0.99 * len(ttft)))],
            "decode_tokens_per_s": sum(len(o) - 1 for o in
                                       run["out"].values()) / wall,
            "wall_s": wall}


def fleet_affinity_arm(params, cfg, dev) -> dict:
    """Arm 1: -int8-prefix's traffic in bf16, its first request per
    system prompt run to its end, then the other 12 at once; affinity on
    routes each to the replica holding its system prompt (12 hits, 4
    cold), affinity off is pow-2 alone.  Returns the arm's launches."""
    from ray_tpu_torch import InferenceEngine
    from ray_tpu_torch.fleet import FleetConfig, FleetRouter
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.telemetry.fleet import FleetTelemetry

    _warm, prompts = prefix_traffic()
    sampling = half_sampled(len(prompts))
    waves = [list(range(N_SYSTEM)), list(range(N_SYSTEM, len(prompts)))]
    one = InferenceEngine(cfg, params, device=dev, **ENGINE)
    t0 = time.monotonic()
    ref_hit = serve_waves(one, prompts, sampling, waves)
    ref_hit["wall"] = time.monotonic() - t0
    ref_cold = serve(InferenceEngine(cfg, params, device=dev, prefix=False,
                                     **ENGINE), prompts, sampling)
    print("fleet one-engine " + json.dumps(one_engine_metrics(
        "-int8-prefix waves, bf16", ref_hit)), flush=True)
    del one
    params32 = cfg32 = None
    total: dict = {}
    for affinity in (True, False):
        what = f"gpt2-serve-fleet affinity {'on' if affinity else 'off'}"
        reps = [fleet_replica(cfg, params, dev, f"r{i}")
                for i in range(FLEET_REPLICAS)]
        paths = watch_paths(reps)
        tel = FleetTelemetry()
        router = FleetRouter(reps, cfg=FleetConfig(**FLEET_CFG),
                             affinity=affinity, rng_seed=0, telemetry=tel)
        _build.reset_launches()
        run = drive(router, prompts, sampling, waves)
        engines = [r.engine for r in reps]
        launches = fleet_launches(what, engines, "model", cfg.n_layers)
        total = add_launches(total, launches)
        cold = sum(e.call_counts["prefill"] for e in engines)
        hits = sum(e.stats()["prefix"]["requests_hit"] for e in engines)
        home = {i: run["streams"][i].replica_id for i in waves[0]}
        same, changed, parted = 0, [], []
        for i in range(len(prompts)):
            rid, hit_pages = paths[tuple(prompts[i])]
            if not hit_pages:
                want = ref_cold["out"][ref_cold["rids"][i]]
            elif rid == home[i % N_SYSTEM]:
                want = ref_hit["out"][i]
            else:
                changed.append(i)
                if sampling[i] is None:
                    if params32 is None:
                        params32 = to_cpu32(params)
                        cfg32 = dataclasses.replace(cfg,
                                                    dtype=torch.float32)
                    p = parted_within_margin(f"{what} request {i}",
                                             prompts[i], run["out"][i],
                                             ref_hit["out"][i], params32,
                                             cfg32)
                    if p is not None:
                        parted.append((i,) + p)
                continue
            if run["out"][i] != want:
                raise AssertionError(f"{what}: request {i} (path {rid}, "
                                     f"{hit_pages} hit pages) parts from "
                                     "the one-engine stream of its path")
            same += 1
        if affinity and (cold, hits, changed) != (N_SYSTEM, 12, []):
            raise AssertionError(f"{what}: {cold} cold prefills, {hits} "
                                 f"hits, {changed} off their system's "
                                 "replica; 4, 12 and none implied")
        if not router.leak_free():
            raise AssertionError(f"{what}: not leak-free")
        print(f"{what}: {cold} cold prefills, {hits} HBM hits; {same} "
              "streams equal the one-engine stream of their path, "
              f"{len(changed)} hit pages another prefill made (greedy "
              f"ones parting within the margin: {parted}); launches "
              f"{launches_line(launches)} == implied; leak-free",
              flush=True)
        print("fleet arm " + json.dumps(fleet_metrics(
            what, run, tel, cold_prefills=cold, hbm_hits=hits,
            affinity_hit_rate=tel.affinity_hit_rate,
            routed={i: s.replica_id for i, s in run["streams"].items()})),
            flush=True)
        # the replicas' engines sit in reference cycles (their wrapped
        # methods), so they go with a collection
        del reps, router, engines, run
        gc.collect()
        torch.cuda.empty_cache()
    return total


def fleet_failover_arm(params, cfg, dev, ref) -> dict:
    """Arm 2: -mixed's 16 greedy requests at once; ``serve.replica`` kills
    one replica mid-decode, its streams re-prefill prompt + emitted
    tokens on the others, and the reconciler restarts it (WEDGED ->
    RESTARTING -> RUNNING); every stream ends with 32 tokens, each once;
    the dead engine's cache is returned.  Returns the arm's launches."""
    from ray_tpu_torch.fleet import (FleetConfig, FleetRouter, Reconciler,
                                     RUNNING)
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.telemetry.fleet import FleetTelemetry
    from ray_tpu_torch.util import chaos

    what = "gpt2-serve-fleet failover"
    prompts = mixed_prompts()
    greedy = [None] * len(prompts)
    engines, died, restart_s = [], {}, []

    def watched(rid):
        rep = fleet_replica(cfg, params, dev, rid)
        inner = rep.step

        def step():
            try:
                return inner()
            except BaseException:
                died.setdefault(rep.id, time.monotonic())
                raise

        rep.step = step
        engines.append(rep.engine)
        return rep

    def factory(rid):
        t0 = time.monotonic()
        rep = watched(rid)
        torch.cuda.synchronize()
        restart_s.append(time.monotonic() - t0)
        return rep

    reps = [watched(f"r{i}") for i in range(FLEET_REPLICAS)]
    fcfg = FleetConfig(**FLEET_CFG)
    tel = FleetTelemetry()
    router = FleetRouter(reps, cfg=fcfg, rng_seed=0, telemetry=tel)
    rec = Reconciler(router, factory, target=FLEET_REPLICAS, cfg=fcfg)
    actions = []
    cache_bytes = reps[0].engine.cache.bytes
    gc.collect()                  # nothing of an earlier run left over
    torch.cuda.synchronize()
    mem_before = torch.cuda.memory_allocated()
    _build.reset_launches()
    plan = chaos.install_faults(f"serve.replica@{FLEET_KILL_AT}")
    try:
        run = drive(router, prompts, greedy, [range(len(prompts))],
                    reconcile=lambda: actions.extend(rec.reconcile()))
    finally:
        chaos.clear_faults()
    actions.extend(rec.reconcile())
    launches = fleet_launches(what, engines, "model", cfg.n_layers)
    (dead_id, death), = died.items()
    moved = [i for i, s in run["streams"].items() if s.retries]
    if plan.fired != [("serve.replica", FLEET_KILL_AT)] or not moved:
        raise AssertionError(f"{what}: fired {plan.fired}, failed over "
                             f"{moved}")
    want = [f"{dead_id}: RUNNING->WEDGED", f"RESTARTING (for {dead_id}"]
    if not all(any(w in a for a in actions) for w in want) or \
            not any("RESTARTING->RUNNING" in a for a in actions) or \
            sorted(rec.states().values()) != [RUNNING] * FLEET_REPLICAS \
            or rec.restarts_total != 1:
        raise AssertionError(f"{what}: reconciler actions {actions}, "
                             f"states {rec.states()}")
    parted = []
    for i in range(len(prompts)):
        got, ref_i = run["out"][i], ref["out"][ref["rids"][i]]
        if got == ref_i:
            continue
        if i not in moved:
            raise AssertionError(f"{what}: request {i} never moved but "
                                 "parts from the one-engine stream")
        parted.append((i,) + parted_within_margin(
            f"{what} request {i}", prompts[i], got, ref_i,
            to_cpu32(params), dataclasses.replace(cfg,
                                                  dtype=torch.float32)))
    rehomed = min(ts for i in moved for ts in run["streams"][i].token_ts
                  if ts > death)
    corpse = next(r for r in reps if r.id == dead_id)
    if not (router.leak_free() and corpse.reaped and corpse.leak_free()):
        raise AssertionError(f"{what}: not leak-free")
    mem_run = torch.cuda.memory_allocated()
    del corpse, reps, engines[:]
    gc.collect()
    torch.cuda.synchronize()
    mem_after = torch.cuda.memory_allocated()
    if abs(mem_after - mem_before) >= cache_bytes // 2:
        raise AssertionError(f"{what}: {mem_after - mem_before} bytes "
                             f"allocated over the run's start with the "
                             f"dead engine dropped (one cache is "
                             f"{cache_bytes})")
    print(f"{what}: {dead_id} died at replica tick {FLEET_KILL_AT} with "
          f"requests {moved} bound; every stream 32 tokens, each once; "
          f"{len(moved) - len(parted)} moved streams equal the one-engine "
          f"stream, {parted} part within the margin; reconciler "
          f"{actions}; memory_allocated {mem_before} before the death, "
          f"{mem_run} after the restart, {mem_after} with the dead engine "
          f"dropped (a cache is {cache_bytes}); launches "
          f"{launches_line(launches)} == implied; leak-free", flush=True)
    print("fleet arm " + json.dumps(fleet_metrics(
        what, run, tel, failovers=len(moved),
        retries=sum(s.retries for s in run["streams"].values()),
        restarts=rec.restarts_total,
        death_to_rehomed_token_ms=1e3 * (rehomed - death),
        restart_s=restart_s[0], memory_allocated_before=mem_before,
        memory_allocated_after_restart=mem_run,
        memory_allocated_dead_dropped=mem_after)), flush=True)
    router.close()
    del router, rec, run
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def fleet_concurrent_arm(params, cfg, dev, ref) -> dict:
    """Arm 3: arm 2's traffic without the fault, polled sequentially and
    with ``concurrent_steps`` (each replica stepping on a worker thread):
    every greedy stream equal to the one-engine run's in both, the
    launches exact under threads.  Returns the arm's launches."""
    from ray_tpu_torch.fleet import FleetConfig, FleetRouter
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.telemetry.fleet import FleetTelemetry

    prompts = mixed_prompts()
    greedy = [None] * len(prompts)
    want = [ref["out"][r] for r in ref["rids"]]
    total: dict = {}
    for concurrent in (False, True):
        what = ("gpt2-serve-fleet " + ("concurrent" if concurrent
                                       else "sequential"))
        reps = [fleet_replica(cfg, params, dev, f"r{i}")
                for i in range(FLEET_REPLICAS)]
        tel = FleetTelemetry()
        router = FleetRouter(reps, cfg=FleetConfig(**FLEET_CFG),
                             rng_seed=0, concurrent_steps=concurrent,
                             telemetry=tel)
        _build.reset_launches()
        run = drive(router, prompts, greedy, [range(len(prompts))])
        launches = fleet_launches(what, [r.engine for r in reps], "model",
                                  cfg.n_layers)
        total = add_launches(total, launches)
        got = [run["out"][i] for i in range(len(prompts))]
        if got != want or not router.leak_free():
            raise AssertionError(f"{what}: streams part from the one-engine "
                                 "run's, or not leak-free")
        print(f"{what}: 16 greedy streams equal the one-engine run's; "
              f"launches {launches_line(launches)} == implied; leak-free",
              flush=True)
        print("fleet arm " + json.dumps(fleet_metrics(what, run, tel)),
              flush=True)
        router.close()
        del reps, router, run
        gc.collect()
        torch.cuda.empty_cache()
    return total


def fleet_gray_arm(params, cfg, dev, ref) -> dict:
    """Arm 4: arm 2's traffic arriving FLEET_GAP_S apart through the
    concurrent poll with demotion and hedging on; the replica holding
    the first request ticks FLEET_SLOW_S slower (``serve.tick[<id>]``).
    It must be demoted, every over-deadline first-token waiter hedged and
    the race resolved once, every stream equal to the one-engine run's.
    Returns the arm's launches."""
    from ray_tpu_torch.fleet import FleetConfig, FleetRouter
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.telemetry.fleet import FleetTelemetry
    from ray_tpu_torch.util import chaos

    what = "gpt2-serve-fleet gray"
    prompts = mixed_prompts()
    greedy = [None] * len(prompts)
    reps = [fleet_replica(cfg, params, dev, f"r{i}")
            for i in range(FLEET_REPLICAS)]
    tel = FleetTelemetry()
    router = FleetRouter(reps, cfg=FleetConfig(hedge=True, slow_factor=3.0),
                         rng_seed=0, concurrent_steps=True, telemetry=tel)
    demoted = set()
    slow = {}

    def on_route(stream):
        if not slow:
            # slow the first request's replica before it ever ticks
            slow["id"] = stream.replica_id
            chaos.install_faults(f"serve.tick[{slow['id']}]@1..1000000"
                                 f":delay={FLEET_SLOW_S}")

    _build.reset_launches()
    try:
        run = drive(router, prompts, greedy, [range(len(prompts))],
                    on_route=on_route, gap=FLEET_GAP_S,
                    on_poll=lambda: demoted.update(router.slow_replicas()))
    finally:
        chaos.clear_faults()
    launches = fleet_launches(what, [r.engine for r in reps], "model",
                              cfg.n_layers)
    summ = tel.summary()
    hedges, winners = summ["hedges"], summ["hedge_winners"]
    issued = hedges.get("issued", 0)
    if slow["id"] not in demoted or not issued or \
            issued != hedges.get("won", 0) + hedges.get("wasted", 0) or \
            issued != sum(winners.values()):
        raise AssertionError(f"{what}: slowed {slow['id']}, demoted "
                             f"{demoted}, hedges {hedges} {winners}")
    got = [run["out"][i] for i in range(len(prompts))]
    if got != [ref["out"][r] for r in ref["rids"]] or \
            not router.leak_free():
        raise AssertionError(f"{what}: streams part from the one-engine "
                             "run's, or not leak-free")
    print(f"{what}: {slow['id']} slowed by {FLEET_SLOW_S} s a tick and "
          f"demoted; hedges {hedges}, winners {winners}, each resolved "
          "once; 16 greedy streams equal the one-engine run's; launches "
          f"{launches_line(launches)} == implied; leak-free", flush=True)
    print("fleet arm " + json.dumps(fleet_metrics(
        what, run, tel, slowed=slow["id"], demoted=sorted(demoted),
        hedges_fired=issued, hedges_won=hedges.get("won", 0))),
        flush=True)
    router.close()
    del reps, router, run
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def fleet_disagg_arm(params, cfg, dev) -> dict:
    """Arm 5: -mixed's 16 requests (half sampled) through a DisaggRouter
    with a prefill pool of 1 and a decode pool of 2, bf16 and int8:
    every stream equal to a co-located engine's, nothing left in the
    handoff store, exact launches; then one warm request (a 512-token
    context a decode replica holds by digest) moves 0 bytes.  Returns
    the arm's launches."""
    from ray_tpu_torch import InferenceEngine
    from ray_tpu_torch.fleet import DisaggRouter, FleetConfig
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.telemetry.fleet import FleetTelemetry

    prompts = mixed_prompts()
    sampling = half_sampled(len(prompts))
    warm = np.random.default_rng(5).integers(0, 50257, 512).tolist()
    total: dict = {}
    for kv_dtype in ("model", "int8"):
        what = f"gpt2-serve-fleet disagg {kv_dtype}"
        colo = InferenceEngine(cfg, params, device=dev, kv_dtype=kv_dtype,
                               **ENGINE)
        ref = serve(colo, prompts, sampling, FLEET_NEW)
        print("fleet one-engine " + json.dumps(one_engine_metrics(
            f"-mixed, {kv_dtype}", ref)), flush=True)
        del colo
        pre = [fleet_replica(cfg, params, dev, "p0", kv_dtype=kv_dtype)]
        dec = [fleet_replica(cfg, params, dev, f"d{i}", kv_dtype=kv_dtype)
               for i in range(2)]
        tel = FleetTelemetry()
        router = DisaggRouter(pre, dec, cfg=FleetConfig(**FLEET_CFG),
                              rng_seed=0, telemetry=tel)
        depth = {"prefill": 0, "decode": 0}

        def on_poll():
            for pool, d in tel.pool_depths.items():
                depth[pool] = max(depth[pool], d)

        _build.reset_launches()
        run = drive(router, prompts, sampling, [range(len(prompts))],
                    on_poll=on_poll)
        moved = dict(tel.summary())
        cold = router.remote(fleet_payload(warm, None))
        cold_out = cold.result()
        pre[0].engine.scheduler.flush_prefix()   # the exporter runs cold
        before = tel.summary()
        again = router.remote(fleet_payload(warm, None)).result()
        after = tel.summary()
        engines = [r.engine for r in pre + dec]
        launches = fleet_launches(what, engines, kv_dtype, cfg.n_layers)
        total = add_launches(total, launches)
        got = [run["out"][i] for i in range(len(prompts))]
        if got != [ref["out"][r] for r in ref["rids"]]:
            raise AssertionError(f"{what}: streams part from the co-located "
                                 "engine's")
        warm_moved = (after["handoff_bytes_total"]
                      - before["handoff_bytes_total"])
        if again != cold_out or warm_moved or \
                after["handoffs_skipped"] - before["handoffs_skipped"] != 1:
            raise AssertionError(f"{what}: the warm request moved "
                                 f"{warm_moved} bytes, or its stream parts")
        if not router.quiesce() or router.store.in_flight or \
                not router.leak_free():
            raise AssertionError(f"{what}: handoffs in flight or a leak")
        print(f"{what}: 16 streams equal the co-located engine's; the warm "
              "request moved 0 bytes; 0 handoffs in flight; launches "
              f"{launches_line(launches)} == implied; leak-free",
              flush=True)
        print("fleet arm " + json.dumps(fleet_metrics(
            what, run, tel, handoff_mb_total=moved["handoff_bytes_total"]
            / 1e6, handoff_mb_per_request=moved["handoff_bytes_total"]
            / 1e6 / moved["handoffs"], warm_handoff_bytes=warm_moved,
            max_pool_queue_depth=depth)), flush=True)
        del pre, dec, router, engines, run, cold
        gc.collect()
        torch.cuda.empty_cache()
    return total


def fleet_phase(params, cfg, dev) -> dict:
    """gpt2-serve-fleet: the five arms above on 3 replicas on one card,
    with a one-engine run of each traffic beside them.  Returns the
    launches of arms 1-4 (``serve_fleet``) and of arm 5
    (``serve_fleet_disagg``), each arm's counts reset just before it."""
    from ray_tpu_torch import InferenceEngine

    paths = {"serve_fleet": fleet_affinity_arm(params, cfg, dev)}
    one = InferenceEngine(cfg, params, device=dev, **ENGINE)
    ref = serve(one, mixed_prompts(), [None] * 16, FLEET_NEW)
    print("fleet one-engine " + json.dumps(one_engine_metrics(
        "-mixed greedy, bf16", ref)), flush=True)
    del one
    for arm in (fleet_failover_arm, fleet_concurrent_arm, fleet_gray_arm):
        paths["serve_fleet"] = add_launches(paths["serve_fleet"],
                                            arm(params, cfg, dev, ref))
    paths["serve_fleet_disagg"] = fleet_disagg_arm(params, cfg, dev)
    return paths


# ---------------------------------------------------------- the runtime
# gpt2-runtime: the serving engine behind the runtime, in a GPU actor
RUNTIME_CPUS = 4
RUNTIME_WARM_TASKS, RUNTIME_NOOP_TASKS, RUNTIME_PINGS = 200, 2000, 200
# a second 1-card actor must still pend this long while the first lives
RUNTIME_PENDING_S = 3.0
# the card back in available_resources() this soon after a kill -9 (the
# head notices the dead worker at once; the control plane's view follows
# the node's next heartbeat): PERF.md predicted <= 2 s, four chip runs
# read 0.621-0.836 s
RUNTIME_RELEASE_S = 5.0
# kill -9 this far into a request of this many new tokens behind the
# shortest prompt (40 tokens; ~5-25 ms a decode step, so it still runs)
RUNTIME_KILL_AFTER_S, RUNTIME_LONG_NEW = 1.0, 900
RUNTIME_START_S = 300.0         # bound on any one actor start or call


def torch_flags() -> None:
    """The matmul settings ``start_up`` gives the driver."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def host_tree(params) -> dict:
    """The parameter tree as host numpy arrays, bf16 as its 16-bit
    patterns (numpy has no bf16): zero-copy buffers for the store."""
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out[k] = host_tree(v)
        else:
            bits = v.detach().cpu().contiguous()
            if bits.dtype == torch.bfloat16:
                bits = bits.view(torch.int16)
            out[k] = bits.numpy()
    return out


def device_tree(tree, dtype, dev) -> dict:
    """``host_tree``'s inverse, on ``dev``."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = device_tree(v, dtype, dev)
        else:
            t = torch.from_numpy(np.array(v))
            if dtype == torch.bfloat16:
                t = t.view(torch.bfloat16)
            out[k] = t.to(dev)
    return out


def tree_bytes(tree) -> int:
    return sum(tree_bytes(v) if isinstance(v, dict) else v.nbytes
               for v in tree.values())


class RuntimeServer:
    """gpt2-runtime's GPU actor (``num_gpus=1``, so cold-spawned with
    ``CUDA_VISIBLE_DEVICES`` set to its card): the serving engine, built
    on the card from parameters it reads from the object store."""

    def __init__(self):
        self.dev = torch.device("cuda")
        self.engine = None

    def hello(self) -> dict:
        """Who and where this worker is; loads the kernel library."""
        import os

        from ray_tpu_torch.ops import _build
        main = sys.modules["__main__"]
        info = {"pid": os.getpid(),
                "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                "start": os.path.basename(getattr(main, "__file__", "")),
                "library_built_before": _build.library_path().exists()}
        torch_flags()
        info.update(card=torch.cuda.get_device_name(0),
                    count=torch.cuda.device_count())
        _build.load()
        info["rebuilt"] = bool(_build.build_log)
        return info

    def ping(self) -> None:
        return None

    def load(self, refs, cfg) -> dict:
        """Read the parameters from the store (timed), put them on the
        card and build the engine, warmed as ``engine_phase`` warms it."""
        import ray_tpu_torch
        from ray_tpu_torch import InferenceEngine
        t0 = time.monotonic()
        tree = ray_tpu_torch.get(refs[0])
        get_s = time.monotonic() - t0
        params = device_tree(tree, cfg.dtype, self.dev)
        self.engine = InferenceEngine(cfg, params, device=self.dev,
                                      **ENGINE)
        self.engine.generate([[1, 2, 3]], max_new_tokens=2)
        return {"get_s": get_s, "bytes": tree_bytes(tree)}

    def serve(self, prompts, sampling) -> dict:
        run = serve(self.engine, prompts, sampling)
        return {k: run[k] for k in ("rids", "out", "ttft", "calls", "secs",
                                    "wall", "launches")}

    def launch_counts(self) -> dict:
        from ray_tpu_torch.ops import _build
        return _build.launch_counts()

    def generate(self, prompt, max_new_tokens: int):
        return self.engine.generate([prompt], max_new_tokens=max_new_tokens)


def _alive(pid: int) -> bool:
    """A process that exists and is not a zombie."""
    try:
        with open(f"/proc/{pid}/stat", "rb") as f:
            stat = f.read()
    except OSError:
        return False
    return stat[stat.rindex(b")") + 2:][:1] not in (b"Z", b"X")


def _run_metrics(run: dict) -> dict:
    ttft = sorted(run["ttft"].values())
    dec_s = run["secs"]["decode"]
    return {"mean_ttft_ms": 1e3 * float(np.mean(ttft)),
            "p99_ttft_ms": 1e3 * ttft[min(len(ttft) - 1,
                                          int(0.99 * len(ttft)))],
            "decode_tokens_per_s":
                sum(len(v) - 1 for v in run["out"].values()) / dec_s,
            "wall_s": run["wall"]}


def _nonzero(launches: dict) -> dict:
    return {k: n for k, n in launches.items() if n}


def runtime_phase(params, cfg, dev) -> dict:
    """gpt2-runtime: ``ray_tpu_torch.init`` finds the card as the
    ``"GPU"`` resource; a CPU task runs forked from the template without
    torch and sees no card; a ``num_gpus=1`` actor, cold-spawned onto
    the card, reads the parameters from the object store, builds the
    serving engine and serves gpt2-serve-mixed's 16 requests with
    streams and launches equal to an engine in this process; a kill -9
    mid-request reaches the caller as ``ActorDiedError`` and frees the
    card; a second 1-card actor pends until the first is killed; and
    ``shutdown`` leaves no worker behind.  Prints ``runtime metrics
    {...}``; returns the actor's launches over its serving run."""
    import signal

    import ray_tpu_torch as rt
    from ray_tpu_torch import InferenceEngine
    from ray_tpu_torch._private.worker import global_node
    from ray_tpu_torch.exceptions import ActorDiedError

    metrics = {"cell": "gpt2-runtime"}
    rt.init(num_cpus=RUNTIME_CPUS)
    try:
        total = rt.cluster_resources()
        if total.get("GPU") != 1.0:
            raise AssertionError(f"runtime: the node found {total} "
                                 "(want GPU 1.0)")
        start_res = rt.available_resources()

        def cpu_probe():
            import os
            import sys
            main = sys.modules["__main__"]
            return (os.environ.get("CUDA_VISIBLE_DEVICES"),
                    sorted(m for m in sys.modules
                           if m.split(".")[0] == "torch"),
                    os.path.basename(getattr(main, "__file__", "")))

        def noop():
            return None

        visible, torch_mods, start = rt.get(
            rt.remote(cpu_probe).remote(), timeout=RUNTIME_START_S)
        if visible != "" or torch_mods or start != "worker_forkserver.py":
            raise AssertionError(
                f"runtime: a CPU task saw CUDA_VISIBLE_DEVICES={visible!r}"
                f", torch modules {torch_mods[:3]}, start {start!r}")
        nop = rt.remote(noop)
        rt.get([nop.remote() for _ in range(RUNTIME_WARM_TASKS)],
               timeout=RUNTIME_START_S)
        t0 = time.monotonic()
        rt.get([nop.remote() for _ in range(RUNTIME_NOOP_TASKS)],
               timeout=RUNTIME_START_S)
        metrics["noop_tasks_per_s"] = RUNTIME_NOOP_TASKS / (
            time.monotonic() - t0)
        print(f"runtime: GPU {total['GPU']} detected; a CPU task forked "
              "from the template sees CUDA_VISIBLE_DEVICES='' and no "
              "torch", flush=True)

        # the class by reference (this file as a module, which the
        # worker imports from the repo root), not pickled by value from
        # __main__ with every global its methods touch
        import chip_smoke
        Server = rt.remote(num_gpus=1)(chip_smoke.RuntimeServer)
        want_card = torch.cuda.get_device_name(0)

        def start_server():
            t = time.monotonic()
            actor = Server.remote()
            info = rt.get(actor.hello.remote(), timeout=RUNTIME_START_S)
            if (info["visible"] != "0" or info["start"] != "worker_proc.py"
                    or info.get("card") != want_card
                    or info.get("count") != 1
                    or not info["library_built_before"]
                    or info.get("rebuilt")):
                raise AssertionError(f"runtime: the GPU actor reports "
                                     f"{info} (want CUDA_VISIBLE_DEVICES "
                                     f"'0', a cold spawn, {want_card!r} "
                                     "alone, this process's kernel library)")
            return actor, info, time.monotonic() - t

        a, info, metrics["actor_cold_start_s"] = start_server()
        host = host_tree(params)
        nbytes = tree_bytes(host)
        t0 = time.monotonic()
        ref = rt.put(host)
        put_s = time.monotonic() - t0
        got = rt.get(a.load.remote([ref], cfg), timeout=RUNTIME_START_S)
        if got["bytes"] != nbytes:
            raise AssertionError(f"runtime: the actor read {got['bytes']} "
                                 f"bytes of parameters, {nbytes} put")
        metrics.update(params_mb=nbytes / 1e6, put_gb_per_s=nbytes / 1e9
                       / put_s, actor_get_gb_per_s=nbytes / 1e9
                       / got["get_s"])
        rt.get(a.ping.remote(), timeout=RUNTIME_START_S)
        t0 = time.monotonic()
        for _ in range(RUNTIME_PINGS):
            rt.get(a.ping.remote(), timeout=RUNTIME_START_S)
        metrics["actor_rtt_ms"] = 1e3 * (time.monotonic() - t0) \
            / RUNTIME_PINGS

        prompts = mixed_prompts()
        sampling = half_sampled(len(prompts))
        in_actor = rt.get(a.serve.remote(prompts, sampling),
                          timeout=RUNTIME_START_S)
        actor_launches = rt.get(a.launch_counts.remote(),
                                timeout=RUNTIME_START_S)
        engine = InferenceEngine(cfg, params, device=dev, **ENGINE)
        engine.generate([[1, 2, 3]], max_new_tokens=2)
        local = serve(engine, prompts, sampling)
        del engine
        got_streams = [in_actor["out"][r] for r in in_actor["rids"]]
        want_streams = [local["out"][r] for r in local["rids"]]
        if got_streams != want_streams:
            bad = [i for i, (x, y) in enumerate(zip(got_streams,
                                                    want_streams)) if x != y]
            raise AssertionError(f"runtime: the actor's streams {bad} "
                                 "differ from the driver engine's")
        implied = serve_launches(cfg.n_layers, in_actor["calls"], "model")
        if not (_nonzero(actor_launches) == _nonzero(in_actor["launches"])
                == _nonzero(local["launches"]) == _nonzero(implied)):
            raise AssertionError(
                f"runtime: actor launches {_nonzero(actor_launches)} "
                f"(its run {_nonzero(in_actor['launches'])}), driver "
                f"{_nonzero(local['launches'])}, implied "
                f"{_nonzero(implied)}")
        metrics["actor"] = _run_metrics(in_actor)
        metrics["driver"] = _run_metrics(local)
        print("runtime: the GPU actor's 16 streams equal the driver "
              f"engine's; launches {_nonzero(actor_launches)} == the "
              "driver's == implied", flush=True)

        # kill -9 mid-request: the caller gets ActorDiedError, the card
        # comes back
        long_ref = a.generate.remote(min(prompts, key=len),
                                     RUNTIME_LONG_NEW)
        time.sleep(RUNTIME_KILL_AFTER_S)
        ready, _ = rt.wait([long_ref], timeout=0)
        if ready:
            raise AssertionError("runtime: the long request ended before "
                                 "the kill")
        t0 = time.monotonic()
        os.kill(info["pid"], signal.SIGKILL)
        try:
            rt.get(long_ref, timeout=RUNTIME_START_S)
        except ActorDiedError:
            metrics["kill9_to_error_s"] = time.monotonic() - t0
        else:
            raise AssertionError("runtime: a request on a killed actor "
                                 "returned")
        deadline = t0 + RUNTIME_RELEASE_S
        while rt.available_resources().get("GPU") != 1.0:
            if time.monotonic() > deadline:
                raise AssertionError(
                    f"runtime: GPU not back {RUNTIME_RELEASE_S} s after "
                    f"the kill: {rt.available_resources()}")
            time.sleep(0.02)
        metrics["kill9_to_gpu_free_s"] = time.monotonic() - t0

        # a second 1-card actor pends while the first lives
        first, _info, _s = start_server()
        second = Server.remote()
        hello2 = second.hello.remote()
        ready, _ = rt.wait([hello2], timeout=RUNTIME_PENDING_S)
        if ready:
            raise AssertionError("runtime: a second 1-card actor started "
                                 "while the first held the card")
        t0 = time.monotonic()
        rt.kill(first)
        info2 = rt.get(hello2, timeout=RUNTIME_START_S)
        metrics["kill_to_second_start_s"] = time.monotonic() - t0
        if info2["visible"] != "0" or info2.get("card") != want_card:
            raise AssertionError(f"runtime: the second actor reports "
                                 f"{info2}")
        rt.kill(second)
        deadline = time.monotonic() + RUNTIME_RELEASE_S
        while rt.available_resources() != start_res:
            if time.monotonic() > deadline:
                raise AssertionError(
                    f"runtime: resources {rt.available_resources()} not "
                    f"back to {start_res}")
            time.sleep(0.02)
        node = global_node()
        pids = [w.proc.pid for w in node.node_manager._workers.values()
                if w.proc is not None]
        fsrv = node.node_manager._forksrv_proc
        if fsrv is not None:
            pids.append(fsrv.pid)
    finally:
        rt.shutdown()
    deadline = time.monotonic() + 10.0
    while any(_alive(p) for p in pids) and time.monotonic() < deadline:
        time.sleep(0.05)
    left = [p for p in pids if _alive(p)]
    if left:
        raise AssertionError(f"runtime: worker processes {left} outlived "
                             "shutdown()")
    print(f"runtime: kill -9 mid-request -> ActorDiedError, GPU free "
          f"again; a second actor pended {RUNTIME_PENDING_S} s and started "
          f"after kill; shutdown() left none of {len(pids)} worker "
          "processes", flush=True)
    print("runtime metrics " + json.dumps(metrics), flush=True)
    return actor_launches


# the serving cell "gpt2-serve-deployment": gpt2-serve-mixed through
# serve.run(GPTDeployment) on the runtime, the replica created on the
# card by the serve controller
SERVE_DEP_APP = "gpt2"
SERVE_DEP_IDLE_S = 2.0          # the deployment's stream_idle_s
# a dropped stream: its max_new_tokens behind the shortest prompt (40
# tokens), and the bound on drop -> reaped with its slot free past
# stream_idle_s (the credit window's 32 tokens take ~0.3-0.8 s)
SERVE_DEP_DROP_NEW, SERVE_DEP_REAP_S = 900, 15.0
SERVE_DEP_RELEASE_S = 10.0      # serve.delete -> the card free again
SERVE_DEP_GATE_S = 60.0         # bound on the 16 requests' arrival


def replica_hello(replica) -> dict:
    """Runs in the serve replica's process (``__ray_call__`` on its
    ``ServeReplica``): who and where it is; loads the kernel library."""
    from ray_tpu_torch.ops import _build
    main = sys.modules["__main__"]
    info = {"pid": os.getpid(),
            "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "start": os.path.basename(getattr(main, "__file__", "")),
            "library_built_before": _build.library_path().exists(),
            "card": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "engine_device": str(replica.instance.engine.device)}
    _build.load()
    info["rebuilt"] = bool(_build.build_log)
    return info


def replica_counts(replica, reset: bool = False) -> dict:
    """In the replica's process: its kernel launches (reset to 0 first
    when ``reset``), the engine's calls and seconds, and whether it is
    leak-free."""
    from ray_tpu_torch.ops import _build
    engine = replica.instance.engine
    if reset:
        _build.reset_launches()
    torch.cuda.synchronize()
    return {"launches": _build.launch_counts(),
            "calls": dict(engine.call_counts),
            "secs": dict(engine.seconds),
            "leak_free": engine.leak_free()}


def replica_hold_first_step(replica, n: int) -> None:
    """In the replica's process: its engine's next step waits (in the
    pump's executor thread, so the event loop keeps admitting) until
    ``n`` requests wait, then runs; the steps after it are the engine's
    own.  The batch then forms as ``serve`` forms it in this process."""
    engine = replica.instance.engine
    step = engine.step

    def held():
        engine.step = step
        deadline = time.monotonic() + SERVE_DEP_GATE_S
        while len(engine.scheduler.waiting) < n:
            if time.monotonic() > deadline:
                raise AssertionError(f"serve-deployment: {n} requests "
                                     "did not all reach the replica")
            time.sleep(0.0005)
        return step()

    engine.step = held


def _consume(stream, submitted: float, rec: dict) -> None:
    """Read one handle stream to its end, timing its first and last
    items."""
    try:
        for item in stream:
            rec["last"] = time.monotonic()
            if "first" not in rec:
                rec["first"] = rec["last"] - submitted
                rec["t_first"] = rec["last"]
            rec["out"].append(int(item))
        rec["end"] = time.monotonic()
    except BaseException as e:  # noqa: BLE001 — reported by the phase
        rec["error"] = e


def _seen_rates(spans) -> dict:
    """Decode rates as the streams' readers see them, from each stream's
    (items, first item's time, last item's time): all the tokens after
    each first over the time any stream was between its first and last
    item, and the mean of each stream's own rate."""
    spans = [(n, t0, t1) for n, t0, t1 in spans if n > 1 and t1 > t0]
    busy, end = 0.0, float("-inf")
    for _, t0, t1 in sorted(spans, key=lambda s: s[1]):
        busy += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
    return {"decode_tokens_per_s": sum(n - 1 for n, _, _ in spans) / busy,
            "reader_tokens_per_s_mean": float(np.mean(
                [(n - 1) / (t1 - t0) for n, t0, t1 in spans]))}


def _stream_all(open_stream, payloads) -> tuple:
    """Open a stream per payload, read each on its own thread, and
    return the records and the wall time from the first open to the
    last item; fails on an error or a short stream."""
    import threading
    recs = [{"out": []} for _ in payloads]
    threads = []
    t_sub = time.monotonic()
    for payload, rec in zip(payloads, recs):
        t = time.monotonic()
        th = threading.Thread(target=_consume,
                              args=(open_stream(payload), t, rec))
        th.start()
        threads.append(th)
    for th in threads:
        th.join(timeout=RUNTIME_START_S)
    bad = [i for i, r in enumerate(recs)
           if "error" in r or len(r["out"]) != FLEET_NEW]
    if bad:
        raise AssertionError(
            f"serve-deployment: streams {bad} failed or came short: "
            f"{[recs[i].get('error') for i in bad][:2]!r}")
    return recs, max(r["end"] for r in recs) - t_sub


def _stream_metrics(recs, wall: float) -> dict:
    ttft = sorted(r["first"] for r in recs)
    return {"mean_ttft_ms": 1e3 * float(np.mean(ttft)),
            "p99_ttft_ms": 1e3 * ttft[min(len(ttft) - 1,
                                          int(0.99 * len(ttft)))],
            **_seen_rates([(len(r["out"]), r["t_first"], r["last"])
                           for r in recs]),
            "wall_s": wall}


def serve_deployment_phase(params, cfg, dev) -> dict:
    """gpt2-serve-deployment: ``GPTDeployment`` behind ``serve.run`` on
    the runtime, its replica on the card created by the serve controller;
    gpt2-serve-mixed's 16 requests through the handle against an engine
    in this process; a dropped stream reaped; one handoff through the
    object store; ``serve.delete`` frees the card.  Prints
    ``serve-deployment metrics {...}``; returns the replica's launches
    over the 16 requests."""
    import chip_smoke as cs
    import ray_tpu_torch as rt
    import ray_tpu_torch.serve as serve_api
    from ray_tpu_torch import InferenceEngine
    from ray_tpu_torch._private.worker import global_node
    from ray_tpu_torch.fleet import HandoffStore
    from ray_tpu_torch.inference.serve_gpt import (GPTDeployment,
                                                   StreamIdleError)
    from ray_tpu_torch.serve.handle import DeploymentResponseGenerator

    metrics = {"cell": "gpt2-serve-deployment"}
    prompts = mixed_prompts()
    sampling = half_sampled(len(prompts))
    rt.init(num_cpus=RUNTIME_CPUS)
    try:
        if rt.cluster_resources().get("GPU") != 1.0:
            raise AssertionError("serve-deployment: the node found "
                                 f"{rt.cluster_resources()}")
        start_res = rt.available_resources()
        app = GPTDeployment.options(
            ray_actor_options={"num_gpus": 1}).bind(
                model="gpt2",
                model_config=dict(GPT2, dtype="bfloat16"),
                engine_config=dict(ENGINE),
                seed=0, stream_idle_s=SERVE_DEP_IDLE_S)
        t0 = time.monotonic()
        handle = serve_api.run(app, name=SERVE_DEP_APP)
        metrics["serve_run_s"] = time.monotonic() - t0
        warm = handle.options(stream=True).remote(
            {"tokens": [1, 2, 3], "max_new_tokens": 2})
        warm_out = []
        for tok in warm:
            if not warm_out:
                metrics["replica_cold_start_s"] = time.monotonic() - t0
            warm_out.append(tok)
        (replica,) = handle._get_routing()["replicas"]

        def in_replica(fn, *args):
            return rt.get(replica.__ray_call__.remote(fn, *args),
                          timeout=RUNTIME_START_S)

        info = in_replica(cs.replica_hello)
        want_card = torch.cuda.get_device_name(0)
        if (info["visible"] != "0" or info["start"] != "worker_proc.py"
                or info["card"] != want_card or info["count"] != 1
                or info["engine_device"] != str(dev)
                or not info["library_built_before"] or info["rebuilt"]):
            raise AssertionError(f"serve-deployment: the replica reports "
                                 f"{info} (want CUDA_VISIBLE_DEVICES '0', "
                                 f"a cold spawn, {want_card!r} alone, "
                                 "this process's kernel library)")
        print(f"serve-deployment: the controller's replica runs on "
              f"{info['card']} (CUDA_VISIBLE_DEVICES "
              f"{info['visible']!r}, cold-spawned); cold start "
              f"{metrics['replica_cold_start_s']:.2f} s", flush=True)

        # gpt2-serve-mixed through the handle, the batch formed as serve()
        # forms it
        payloads = [fleet_payload(p, sp) for p, sp in zip(prompts, sampling)]

        def through_handle(payload):
            return handle.options(stream=True).remote(payload)

        def without_acks(payload):
            # the handle's dispatch with no stream id: the replica runs
            # no credit window and the reader sends no acks
            return DeploymentResponseGenerator(
                replica.handle_request_streaming.options(
                    num_returns="streaming").remote(
                        "__call__", (payload,), {}, ""))

        before = in_replica(cs.replica_counts, True)
        in_replica(cs.replica_hold_first_step, len(prompts))
        recs, handle_wall = _stream_all(through_handle, payloads)
        after = in_replica(cs.replica_counts)
        calls = {k: v - before["calls"][k]
                 for k, v in after["calls"].items()}
        secs = {k: v - before["secs"][k] for k, v in after["secs"].items()}
        if not after["leak_free"]:
            raise AssertionError("serve-deployment: the replica's engine "
                                 "is not leak-free")
        # the credit window's acks against none, on the same requests:
        # no acks, then the handle again
        acks = {}
        for what, open_stream in (("handle_no_ack", without_acks),
                                  ("handle_again", through_handle)):
            in_replica(cs.replica_hold_first_step, len(prompts))
            acks[what] = _stream_metrics(*_stream_all(open_stream,
                                                      payloads))

        engine = InferenceEngine(cfg, params, device=dev, **ENGINE)
        engine.generate([[1, 2, 3]], max_new_tokens=2)
        local = serve(engine, prompts, sampling)
        want = [local["out"][r] for r in local["rids"]]
        parted = []
        for i, (rec, w) in enumerate(zip(recs, want)):
            if rec["out"] != w:
                parted.append((i,) + parted_within_margin(
                    f"serve-deployment request {i}", prompts[i],
                    rec["out"], w, to_cpu32(params),
                    dataclasses.replace(cfg, dtype=torch.float32)))
        implied = serve_launches(cfg.n_layers, calls, "model")
        if not (_nonzero(after["launches"]) == _nonzero(implied)
                == _nonzero(local["launches"])):
            raise AssertionError(
                f"serve-deployment: replica launches "
                f"{_nonzero(after['launches'])}, implied "
                f"{_nonzero(implied)}, this process "
                f"{_nonzero(local['launches'])}")
        tokens = sum(len(r["out"]) - 1 for r in recs)
        # "handle": what the handle's readers saw; "replica_engine": the
        # replica's engine over its own decode seconds
        metrics["handle"] = _stream_metrics(recs, handle_wall)
        metrics.update(acks)
        metrics["replica_engine"] = {
            "decode_tokens_per_s": tokens / secs["decode"]}
        metrics["driver"] = dict(
            _run_metrics(local),
            seen=_seen_rates(local["spans"]))
        metrics["handle_extra_ms_per_token"] = 1e3 * (
            handle_wall - local["wall"]) / sum(len(r["out"]) for r in recs)
        metrics["parted"] = parted
        print(f"serve-deployment: {len(prompts) - len(parted)} of "
              f"{len(prompts)} handle streams equal this process's "
              f"engine, {parted} part within the margin; replica launches "
              f"{_nonzero(after['launches'])} == implied == this "
              "process's", flush=True)

        # one handoff through the runtime's object store
        store = HandoffStore(use_object_store=True)
        moved = {}

        def ship(h):
            t = time.monotonic()
            key = store.put(h)
            moved["put_s"] = time.monotonic() - t
            t = time.monotonic()
            got = store.get(key)
            moved["get_s"] = time.monotonic() - t
            moved["key"], moved["bytes"] = key, h.nbytes
            for name in ("k", "v"):
                a, b = getattr(h, name), getattr(got, name)
                if not torch.equal(torch.as_tensor(a).view(torch.uint8),
                                   torch.as_tensor(b).view(torch.uint8)):
                    raise AssertionError(f"serve-deployment: the handoff's "
                                         f"{name} changed in the store")
            return got

        longest = max(prompts, key=len)
        pre = InferenceEngine(cfg, params, device=dev, **ENGINE)
        dec = InferenceEngine(cfg, params, device=dev, **ENGINE)
        pair = disagg_pair("serve-deployment handoff", pre, dec, [longest],
                           [None], ship=ship)
        store.drop(moved["key"])
        # a fresh engine: the served one holds the prompt's pages as
        # prefix hits, which would take the cached-prefill path
        colocated = InferenceEngine(cfg, params, device=dev, **ENGINE) \
            .generate([longest], max_new_tokens=DISAGG_NEW)[0]
        if pair["out"][0] != [int(t) for t in colocated]:
            raise AssertionError("serve-deployment: the object-store "
                                 "handoff's stream differs from the "
                                 "co-located one")
        if store.in_flight or not (pre.leak_free() and dec.leak_free()):
            raise AssertionError("serve-deployment: a handoff left in "
                                 "flight or pages held")
        metrics["handoff"] = {
            "mb": moved["bytes"] / 1e6,
            "export_ms": 1e3 * pair["export_s"][0],
            "put_gb_per_s": moved["bytes"] / 1e9 / moved["put_s"],
            "get_gb_per_s": moved["bytes"] / 1e9 / moved["get_s"],
            "install_ms": 1e3 * pair["install_s"][0]}
        del engine, pre, dec

        # a stream dropped after one token: reaped, its slot free
        held = iter(handle.options(stream=True).remote(
            {"tokens": min(prompts, key=len),
             "max_new_tokens": SERVE_DEP_DROP_NEW}))
        late = [next(held)]
        t0 = time.monotonic()
        while True:
            summary = handle.telemetry_summary.remote().result()
            if summary["streams_reaped"] and not summary["stats"]["active"]:
                break
            if time.monotonic() - t0 > SERVE_DEP_IDLE_S + SERVE_DEP_REAP_S:
                raise AssertionError(f"serve-deployment: the dropped "
                                     f"stream was not reaped: {summary}")
            time.sleep(0.02)
        metrics["drop_to_slot_free_s"] = time.monotonic() - t0
        if summary["streams_reaped"] != 1 or \
                summary["stats"]["free_slots"] != ENGINE["slots"]:
            raise AssertionError(f"serve-deployment: after the reap "
                                 f"{summary}")
        try:
            late.extend(held)
        except Exception as e:  # noqa: BLE001 — the typed error, wrapped
            if StreamIdleError.__name__ not in repr(e) and \
                    "STREAM_IDLE" not in str(e):
                raise
        else:
            raise AssertionError("serve-deployment: a late reader of the "
                                 "reaped stream got no StreamIdleError")
        if not 1 < len(late) < SERVE_DEP_DROP_NEW:
            raise AssertionError(f"serve-deployment: the dropped stream "
                                 f"delivered {len(late)} tokens")
        metrics["dropped_stream_tokens"] = len(late)

        t0 = time.monotonic()
        serve_api.delete(SERVE_DEP_APP)
        while _alive(info["pid"]) or \
                rt.available_resources().get("GPU") != 1.0:
            if time.monotonic() - t0 > SERVE_DEP_RELEASE_S:
                raise AssertionError(
                    f"serve-deployment: {SERVE_DEP_RELEASE_S} s after "
                    f"serve.delete the replica (pid {info['pid']}) alive "
                    f"{_alive(info['pid'])}, resources "
                    f"{rt.available_resources()}")
            time.sleep(0.02)
        metrics["delete_to_gpu_free_s"] = time.monotonic() - t0
        serve_api.shutdown()
        deadline = time.monotonic() + RUNTIME_RELEASE_S
        while rt.available_resources() != start_res:
            if time.monotonic() > deadline:
                raise AssertionError(
                    f"serve-deployment: resources "
                    f"{rt.available_resources()} not back to {start_res}")
            time.sleep(0.02)
        node = global_node()
        pids = [w.proc.pid for w in node.node_manager._workers.values()
                if w.proc is not None]
        fsrv = node.node_manager._forksrv_proc
        if fsrv is not None:
            pids.append(fsrv.pid)
    finally:
        rt.shutdown()
    deadline = time.monotonic() + 10.0
    while any(_alive(p) for p in pids) and time.monotonic() < deadline:
        time.sleep(0.05)
    left = [p for p in pids if _alive(p)]
    if left:
        raise AssertionError(f"serve-deployment: worker processes {left} "
                             "outlived shutdown()")
    print(f"serve-deployment: dropped stream reaped "
          f"{metrics['drop_to_slot_free_s']:.2f} s after its first token "
          f"({len(late)} tokens, then StreamIdleError); serve.delete -> "
          f"card free in {metrics['delete_to_gpu_free_s']:.3f} s, no "
          "replica left; the object-store handoff's stream equals the "
          "co-located one", flush=True)
    print("serve-deployment metrics " + json.dumps(metrics), flush=True)
    return after["launches"]


# the training cell "gpt2-train-b24": the JAX package's single-chip
# recipe (bench.py:1932-1935) at full width and depth, bf16, batch 24 x
# 1024, random weights from a seed, on one repeated synthetic batch
TRAIN_CFG = dict(vocab_size=50304, max_seq=1024, remat=False,
                 unroll_layers=True, ce_chunk=-1)
TRAIN_OPT = dict(lr=1e-3, warmup=2, total_steps=100)
WARMUP_STEPS, TIMED_STEPS = 2, 8
# the run with the RMSNorm kernels: 2 warm-up and 4 timed steps
NORM_TIMED_STEPS = 4
# launches of one training step: per layer one attention forward and
# backward and one epilogue forward and backward; one flash-CE pass each
TRAIN_LAUNCHES = {"flash_attention_fwd": 12, "flash_attention_bwd": 12,
                  "matmul_residual_norm_fwd": 12,
                  "matmul_residual_norm_bwd": 12,
                  "flash_ce_fwd": 1, "flash_ce_bwd": 1}
# with gpt._PALLAS_NORM, one RMSNorm forward and backward per layer
# besides: ln1 (ln2 is the epilogue's, ln_f the flash-CE prologue's)
NORM_LAUNCHES = {"rmsnorm_fwd": 12, "rmsnorm_bwd": 12}


def train_step_launches(*, norm_kernel: bool = False, remat: bool = False,
                        ce_mode=None) -> dict:
    """The launches of one gpt2-train-b24 step: TRAIN_LAUNCHES (and
    NORM_LAUNCHES with the RMSNorm kernels); ``ce_mode="fused"`` takes
    the loss without flash-CE; ``remat`` recomputes each block in the
    backward, so every forward kernel inside a block runs twice (the
    flash-CE pair is outside the blocks)."""
    n = dict(TRAIN_LAUNCHES, **(NORM_LAUNCHES if norm_kernel else {}))
    if ce_mode == "fused":
        n.pop("flash_ce_fwd")
        n.pop("flash_ce_bwd")
    if remat:
        for k in ("flash_attention_fwd", "matmul_residual_norm_fwd",
                  "rmsnorm_fwd"):
            if k in n:
                n[k] *= 2
    return n


def train_phase(dev, *, norm_kernel: bool = False,
                timed_steps: int = TIMED_STEPS, remat: bool = False,
                ce_mode=None) -> dict:
    """GPT-2 124M trains WARMUP_STEPS + ``timed_steps`` steps in bf16 at
    24 x 1024; prints the step metrics and returns them with the launch
    counts of the timed steps, which must be exactly
    ``train_step_launches`` per step: TRAIN_LAUNCHES, and NORM_LAUNCHES
    with ``norm_kernel`` (the RMSNorm kernels through
    ``gpt._PALLAS_NORM``); ``remat`` (each block recomputed in the
    backward) and ``ce_mode="fused"`` (the bf16-resident CE) are the
    remat and fused-CE arms.  The step recorder is off: the phase times
    the steps itself, with one sync at the end."""
    from ray_tpu_torch import GPTConfig
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.models.training import (build_gpt_train,
                                               default_optimizer,
                                               synthetic_lm_batch)
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.telemetry import flops

    # what earlier phases left in reference cycles (the serving engines:
    # no_gather_in_decode's closure) is collected first, so the peak
    # reads this phase's memory alone
    gc.collect()
    torch.cuda.empty_cache()
    cfg = GPTConfig.gpt2(**dict(TRAIN_CFG, remat=remat),
                         dtype=torch.bfloat16)
    fns = build_gpt_train(cfg, optimizer=default_optimizer(**TRAIN_OPT),
                          ce_mode=ce_mode, device=dev, telemetry=False)
    state = fns["init_fn"](torch.Generator().manual_seed(0))
    batch = synthetic_lm_batch(torch.Generator().manual_seed(1), TRAIN_B,
                               TRAIN_S, cfg.vocab_size, device=dev)
    losses, norms = [], []
    torch.cuda.reset_peak_memory_stats()
    gpt._PALLAS_NORM = norm_kernel
    try:
        for _ in range(WARMUP_STEPS):
            state, m = fns["step_fn"](state, batch)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.monotonic()
        timed = []
        for _ in range(timed_steps):
            state, m = fns["step_fn"](state, batch)
            timed.append(m)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    finally:
        gpt._PALLAS_NORM = False
    launches = _build.launch_counts()
    losses += [float(m["loss"]) for m in timed]
    norms += [float(m["grad_norm"]) for m in timed]
    per_step = train_step_launches(norm_kernel=norm_kernel, remat=remat,
                                   ce_mode=ce_mode)
    expect_launches(f"training ({timed_steps} steps)", launches,
                    {k: n * timed_steps for k, n in per_step.items()})
    if not all(math.isfinite(x) for x in losses + norms):
        raise AssertionError(f"non-finite loss or grad norm: {losses}")
    if abs(losses[0] - math.log(cfg.vocab_size)) > 0.5:
        raise AssertionError(f"first loss {losses[0]:.4f} is not near "
                             f"ln V = {math.log(cfg.vocab_size):.4f}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    step_ms = 1e3 * wall / timed_steps
    tok_s = TRAIN_B * TRAIN_S * timed_steps / wall
    fpt = flops.gpt_train_flops_per_token(cfg, TRAIN_S,
                                          ce_recompute=ce_mode != "fused")
    arm = ("norm kernel" if norm_kernel else "remat" if remat
           else "fused CE" if ce_mode == "fused" else "")
    metrics = {
        "cell": "gpt2-train-b24", "arm": arm or "default",
        "norm_kernel": norm_kernel,
        "batch": [TRAIN_B, TRAIN_S],
        "step_ms": step_ms, "tokens_per_s": tok_s,
        "mfu": flops.mfu(tok_s, fpt),
        "train_flops_per_token": fpt,
        "max_memory_allocated_gib":
            torch.cuda.max_memory_allocated() / 2 ** 30,
        "losses": losses, "grad_norms": norms,
    }
    label = "training phase" + (f" {arm}" if arm else "")
    print(f"{label}: {WARMUP_STEPS + timed_steps} steps, loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}; launches per step "
          f"{per_step} exact", flush=True)
    print(f"{label} metrics " + json.dumps(metrics), flush=True)
    return dict(metrics, launches=launches)


# the remat and fused-CE arms of gpt2-train-b24: 2 warm-up and 4 timed
# steps each.  Their losses against the default arm's: remat recomputes
# the same kernels on the same inputs, so its losses equal the default
# arm's (within TRAIN_BF16_TOL's 2e-4; expected 0); the fused CE rounds
# the logits to bf16, so its step-0 loss is held within FUSED_LOSS_TOL of
# the flash arm's, and its gradients in train_correctness_phase
ARM_TIMED_STEPS = 4
FUSED_LOSS_TOL = 1e-2


def train_arms_phase(dev, default: dict) -> dict:
    """The remat and fused-CE arms against ``default`` (``train_phase``'s
    default arm of this run): the remat arm's launches (each block's
    forward kernels twice), losses equal to the default arm's and a peak
    below it; the fused-CE arm's zero flash-CE launches and its step-0
    loss.  Prints ``training arms {...}``; returns each arm's launches."""
    remat = train_phase(dev, remat=True, timed_steps=ARM_TIMED_STEPS)
    fused = train_phase(dev, ce_mode="fused", timed_steps=ARM_TIMED_STEPS)
    n = WARMUP_STEPS + ARM_TIMED_STEPS
    d_remat = max(abs(a - b) for a, b in zip(remat["losses"],
                                             default["losses"][:n]))
    if not d_remat <= TRAIN_BF16_TOL["loss_abs"]:
        raise AssertionError(f"remat arm: losses {remat['losses']} part "
                             f"from the default arm's by {d_remat:.3e}")
    if not (remat["max_memory_allocated_gib"]
            < default["max_memory_allocated_gib"]):
        raise AssertionError(
            f"remat arm: peak {remat['max_memory_allocated_gib']:.3f} GiB "
            f"is not below the default arm's "
            f"{default['max_memory_allocated_gib']:.3f} GiB")
    if fused["launches"].get("flash_ce_fwd") or \
            fused["launches"].get("flash_ce_bwd"):
        raise AssertionError("fused-CE arm launched flash-CE: "
                             f"{_nonzero(fused['launches'])}")
    d_fused = abs(fused["losses"][0] - default["losses"][0])
    if not d_fused <= FUSED_LOSS_TOL:
        raise AssertionError(f"fused-CE arm: step-0 loss "
                             f"{fused['losses'][0]} vs flash "
                             f"{default['losses'][0]}")
    out = {"remat_step_ms": remat["step_ms"],
           "remat_peak_gib": remat["max_memory_allocated_gib"],
           "remat_max_loss_diff": d_remat,
           "fused_ce_step_ms": fused["step_ms"],
           "fused_ce_peak_gib": fused["max_memory_allocated_gib"],
           "fused_ce_step0_loss_diff": d_fused,
           "default_step_ms": default["step_ms"],
           "default_peak_gib": default["max_memory_allocated_gib"]}
    print("training arms " + json.dumps(out), flush=True)
    return {"train_remat": remat["launches"],
            "train_fused_ce": fused["launches"]}


# gpt2-train-stream (8g): GPT-2 124M trains from the streaming data plane
# (``data.StreamingLoader`` over ``run_train_stream_loop``'s
# ``SyntheticDocs`` from the seed: documents of 128 to 768 tokens packed
# whole into rows of 1024) at STREAM_B x 1024, a third of
# gpt2-train-b24's rows: the plain segment attention holds f32 [B, H, S,
# S] scores.  STREAM_STEPS steps, an async checkpoint every
# STREAM_CKPT_EVERY; then the snapshots after step STREAM_STEPS -
# STREAM_RESUMED are dropped (the run died there) and a second loop
# restores the latest one and runs the last STREAM_RESUMED steps again.
STREAM_B = 8
STREAM_STEPS = 6
STREAM_CKPT_EVERY = 2
STREAM_RESUMED = 2
# one packed step launches the epilogue pair per layer and the flash-CE
# pair; attention on a packed batch is the plain segment attention, the
# reference's route (``attention.py:1232-1237``: no Pallas kernel)
STREAM_LAUNCHES = {"matmul_residual_norm_fwd": 12,
                   "matmul_residual_norm_bwd": 12,
                   "flash_ce_fwd": 1, "flash_ce_bwd": 1}
# a pop of the prefetch queue that blocked the trainer longer than this
# counts as a step that waited on input
STREAM_WAIT_S = 1e-3


def stream_packed_batch(dev=None) -> dict:
    """The first batch of gpt2-train-stream's stream (host arrays, or
    tensors on ``dev``)."""
    from ray_tpu_torch.data import StreamingLoader, SyntheticDocs
    S = TRAIN_S
    src = SyntheticDocs(1, num_shards=4, docs_per_shard=256,
                        vocab=TRAIN_V, min_len=S // 8, max_len=3 * S // 4)
    with StreamingLoader(src, batch_size=STREAM_B, seq_len=S, seed=0,
                         device_put=dev is not None, device=dev) as ld:
        return ld.next().batch


def _twice_equal(fn) -> bool:
    """Whether two calls of ``fn`` on the same inputs give equal bits."""
    a, b = fn(), fn()
    a = a if isinstance(a, (tuple, list)) else (a,)
    b = b if isinstance(b, (tuple, list)) else (b,)
    return all(torch.equal(x, y) for x, y in zip(a, b))


def stream_shape_phase(rec: Recorder, dev) -> dict:
    """The training kernels at gpt2-train-stream's shapes, bf16 against
    their plain versions in f32 at the bounds above, as extra shapes of
    their rows: the epilogue forward and backward at N = STREAM_B x 1024
    and flash-CE forward and backward on a packed batch's targets (-1 at
    every document's end and on padding).  Then whether each piece of a
    packed step gives equal bits on two calls (the epilogue pair,
    flash-CE pair, cuBLAS at the step's projection shape, the segment
    attention forward and backward, the embedding's backward); prints
    ``determinism kernels {...}`` and returns it."""
    import torch.nn.functional as F

    from ray_tpu_torch.ops import flash_ce as FC
    from ray_tpu_torch.ops import fused_norm as FN
    from ray_tpu_torch.ops.attention import segment_attention

    g = torch.Generator(device=dev).manual_seed(5)
    randn = _randn(g, dev)
    N = STREAM_B * TRAIN_S
    batch = stream_packed_batch(dev)
    masked = int((batch["targets"] < 0).sum())
    print(f"gpt2-train-stream kernels: N={N}, {masked} of the packed "
          f"batch's targets masked", flush=True)
    epilogue_fwd_check(rec, randn, g, dev, N, torch.bfloat16, own=False)
    epilogue_bwd_check(rec, randn, g, dev, N, own=False)
    flash_ce_checks(rec, randn, g, dev, N, own=False,
                    targets=batch["targets"])
    d, V = 768, TRAIN_V
    a, w, resid = randn(N, d), randn(d, d, s=d ** -0.5), randn(N, d)
    sc = torch.ones(d, device=dev, dtype=torch.bfloat16)
    r, _y, rstd = FN.matmul_residual_norm_fwd(a, w, resid, sc)
    up = randn(d, 4 * d, s=d ** -0.5)
    x, head = randn(N, d), randn(V, d, s=0.02)
    tgt = batch["targets"].reshape(N).to(torch.int32)
    lse, _t, ce_rstd = FC.flash_ce_fwd(x, head, tgt, (sc, 1e-6))
    srow = (tgt >= 0).float()
    q, k, v = (randn(STREAM_B, TRAIN_S, TRAIN_H, TRAIN_D) for _ in range(3))
    do = randn(STREAM_B, TRAIN_S, TRAIN_H, TRAIN_D)
    table = randn(V, d, s=0.02)
    dx = randn(STREAM_B, TRAIN_S, d)

    def seg():
        qq, kk, vv = (t.detach().requires_grad_(True) for t in (q, k, v))
        o = segment_attention(qq, kk, vv, batch["segment_ids"])
        return (o, *torch.autograd.grad(o, (qq, kk, vv), do))

    def embed_bwd():
        t = table.detach().requires_grad_(True)
        return torch.autograd.grad(t[batch["tokens"]], t, dx)[0]

    out = {
        "matmul_residual_norm_fwd": _twice_equal(
            lambda: FN.matmul_residual_norm_fwd(a, w, resid, sc)),
        "matmul_residual_norm_bwd": _twice_equal(
            lambda: FN.matmul_residual_norm_bwd(a, w, r, sc, rstd, resid,
                                                resid)),
        "flash_ce_fwd": _twice_equal(
            lambda: FC.flash_ce_fwd(x, head, tgt, (sc, 1e-6))),
        "flash_ce_bwd": _twice_equal(
            lambda: FC.flash_ce_bwd(x, head, tgt, lse, srow,
                                    (sc, 1e-6, ce_rstd))),
        "cublas_matmul": _twice_equal(lambda: a @ up),
        "segment_attention_fwd_bwd": _twice_equal(seg),
        "embedding_bwd": _twice_equal(embed_bwd),
    }
    torch.cuda.synchronize()
    print("determinism kernels " + json.dumps(out), flush=True)
    del a, w, resid, r, rstd, up, x, head, lse, q, k, v, do, table, dx
    torch.cuda.empty_cache()
    return out


def _stall_log():
    """A data recorder that also keeps each pop's stall (the loader's
    ``telemetry``), for the share of steps that waited on input."""
    from ray_tpu_torch.telemetry import DataTelemetry

    class StallLog(DataTelemetry):
        def __init__(self):
            super().__init__(label="gpt2-train-stream")
            self.each = []

        def record_stall(self, seconds: float) -> None:
            self.each.append(float(seconds))
            super().record_stall(seconds)

    return StallLog()


def _tree_pairs(a, b, prefix=""):
    for k, v in a.items():
        if isinstance(v, dict):
            yield from _tree_pairs(v, b[k], prefix + k + "/")
        else:
            yield prefix + k, v, b[k]


def stream_step_determinism(fns, cfg, dev) -> dict:
    """Whether one whole packed step's loss and every gradient leaf come
    out bit-equal on two calls on the same parameters and batch."""
    params = fns["init_fn"](torch.Generator().manual_seed(3)).params
    batch = stream_packed_batch(dev)
    l1, g1 = fns["value_and_grad_fn"](params, batch)
    l2, g2 = fns["value_and_grad_fn"](params, batch)
    unequal = [n for n, x, y in _tree_pairs(g1, g2) if not torch.equal(x, y)]
    out = {"loss_equal": bool(torch.equal(l1, l2)),
           "grad_leaves": len(list(_tree_pairs(g1, g2))),
           "grad_leaves_unequal": unequal}
    print("determinism step " + json.dumps(out), flush=True)
    del params, g1, g2
    torch.cuda.empty_cache()
    return out


def train_stream_phase(dev, default: dict) -> dict:
    """gpt2-train-stream (above): the uninterrupted loop with its exact
    launches, losses finite near ln V, the checkpoints written on the
    background thread; the resumed loop from the last snapshot before
    step STREAM_STEPS - STREAM_RESUMED, whose losses and final
    parameters must equal the uninterrupted loop's bit for bit when
    ``stream_step_determinism`` finds the step deterministic, and
    otherwise within TRAIN_BF16_TOL's loss bound and its 0.06 of each
    leaf's largest value.  Then the accumulation arm.  Prints
    ``train-stream metrics {...}``; returns each loop's launches."""
    import shutil
    import statistics
    import tempfile

    from ray_tpu_torch import GPTConfig
    from ray_tpu_torch.models.training import (build_gpt_train,
                                               default_optimizer)
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.resilience import (TrainCheckpointer,
                                          run_train_stream_loop)

    gc.collect()
    torch.cuda.empty_cache()
    cfg = GPTConfig.gpt2(**TRAIN_CFG, dtype=torch.bfloat16)
    fns = build_gpt_train(cfg, optimizer=default_optimizer(**TRAIN_OPT),
                          device=dev, telemetry=False)
    determinism = stream_step_determinism(fns, cfg, dev)
    deterministic = determinism["loss_equal"] and \
        not determinism["grad_leaves_unequal"]
    step_s = []

    def timed(_step, fn):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        out = fn()
        torch.cuda.synchronize()
        step_s.append(time.monotonic() - t0)
        return out

    kw = dict(steps=STREAM_STEPS, batch_size=STREAM_B, seq_len=TRAIN_S,
              seed=0, fns=fns, device=dev)
    root = tempfile.mkdtemp(prefix="gpt2-train-stream-")
    try:
        stalls = _stall_log()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        t0 = time.monotonic()
        with TrainCheckpointer(root, every=STREAM_CKPT_EVERY,
                               keep=STREAM_STEPS, telemetry=True) as ck:
            full = run_train_stream_loop(cfg, ckpt=ck, step_hook=timed,
                                         loader_kwargs={"telemetry": stalls},
                                         **kw)
            ck.flush()
            wall = time.monotonic() - t0
            written = ck.telemetry.summary()
            snapshot_s = list(ck.snapshot_s)
            cut = STREAM_STEPS - STREAM_RESUMED
            kept = [c.path for c, m in ck.manager.best_checkpoints()
                    if m["step"] <= cut]
            for c, m in ck.manager.best_checkpoints():
                if m["step"] > cut:          # the run died after step cut
                    shutil.rmtree(c.path)
        launches = _build.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        expect_launches(f"gpt2-train-stream ({STREAM_STEPS} steps)",
                        launches, {k: n * STREAM_STEPS
                                   for k, n in STREAM_LAUNCHES.items()})
        # uniform random documents, each batch new: the loss stays near
        # ln V (chance) rather than falling as on the dp arm's one batch
        losses = full["losses"]
        if not all(math.isfinite(x) and
                   abs(x - math.log(cfg.vocab_size)) <= 0.5 for x in losses):
            raise AssertionError(f"gpt2-train-stream losses {losses}")
        if written["checkpoints"] != STREAM_STEPS // STREAM_CKPT_EVERY or \
                written["failed"]:
            raise AssertionError(f"gpt2-train-stream checkpoints {written}")
        ckpt_bytes = os.path.getsize(os.path.join(kept[0],
                                                  "train_state.pt"))
        _build.reset_launches()
        with TrainCheckpointer(root, every=STREAM_CKPT_EVERY,
                               keep=STREAM_STEPS) as ck2:
            t1 = time.monotonic()
            rest = run_train_stream_loop(cfg, ckpt=ck2, resume=True, **kw)
            resume_wall = time.monotonic() - t1
        rlaunches = _build.launch_counts()
        expect_launches(f"gpt2-train-stream resumed ({STREAM_RESUMED} "
                        "steps)", rlaunches,
                        {k: n * STREAM_RESUMED
                         for k, n in STREAM_LAUNCHES.items()})
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if rest["start_step"] != cut or rest["restored_from"] is None:
        raise AssertionError(f"resume started at {rest['start_step']} "
                             f"from {rest['restored_from']}")
    loss_diff = max(abs(a - b) for a, b in zip(rest["losses"],
                                               losses[cut:]))
    worst_share, worst = 0.0, ""
    params_equal = True
    for name, x, y in _tree_pairs(rest["state"].params,
                                  full["state"].params):
        params_equal &= bool(torch.equal(x, y))
        err = (x.float() - y.float()).abs().max().item()
        share = err / (TRAIN_BF16_TOL["grad"]
                       * y.float().abs().max().item() + 1e-30)
        if share > worst_share:
            worst_share, worst = share, name
    bit_equal = rest["losses"] == losses[cut:] and params_equal
    if deterministic and not bit_equal:
        raise AssertionError(
            "gpt2-train-stream: the step is deterministic but the resumed "
            f"loop parts from the uninterrupted one (losses "
            f"{rest['losses']} vs {losses[cut:]}, worst parameter {worst})")
    if not (loss_diff <= TRAIN_BF16_TOL["loss_abs"] and worst_share <= 1):
        raise AssertionError(f"gpt2-train-stream resume: loss diff "
                             f"{loss_diff:.3e}, parameter {worst} "
                             f"share_of_tol={worst_share:.3f}")
    data = full["data"]
    steady = statistics.median(step_s[2:]) * 1e3
    waited = sum(s > STREAM_WAIT_S for s in stalls.each)
    tokens = STREAM_B * TRAIN_S
    metrics = {
        "cell": "gpt2-train-stream", "card": card(),
        "batch": [STREAM_B, TRAIN_S], "steps": STREAM_STEPS,
        "step_ms": [1e3 * s for s in step_s], "step_ms_steady": steady,
        "ms_per_1k_tokens": steady / tokens * 1e3,
        "dp_step_ms": default["step_ms"],
        "dp_batch": [TRAIN_B, TRAIN_S],
        "dp_ms_per_1k_tokens": default["step_ms"] / (TRAIN_B * TRAIN_S)
        * 1e3,
        "packed_tokens_per_step": data.get("packed_tokens_per_batch"),
        "input_tok_s": data["input_tok_s"],
        "input_wait_share": waited / max(1, len(stalls.each)),
        "stall_s_total": data["stall_s_total"],
        "stall_s_max": data["stall_s_max"],
        "loop_wall_s": wall,
        "ckpt_write_s": written.get("write_s"),
        "ckpt_write_max_s": written.get("write_max_s"),
        "ckpt_snapshot_s": statistics.median(snapshot_s),
        "ckpt_bytes": ckpt_bytes,
        "resume_wall_s": resume_wall,
        "max_memory_allocated_gib": peak,
        "losses": losses,
        "resumed_losses": rest["losses"],
        "resume_bit_equal": bit_equal,
        "resume_max_loss_diff": loss_diff,
        "resume_worst_param_share": worst_share,
        "step_deterministic": deterministic,
    }
    print(f"gpt2-train-stream: {STREAM_STEPS} steps, loss {losses[0]:.4f} "
          f"-> {losses[-1]:.4f}, launches per step {STREAM_LAUNCHES} "
          f"exact; resumed from step {cut}: "
          + ("bit-equal" if bit_equal else
             f"loss within {loss_diff:.3e}, parameters within "
             f"{worst_share:.3f} of the bound"), flush=True)
    print("train-stream metrics " + json.dumps(metrics), flush=True)
    del fns, full, rest
    gc.collect()
    torch.cuda.empty_cache()
    out = {"train_stream": add_launches(dict(launches), rlaunches)}
    out["train_accum"] = train_accum_arm(dev)
    return out


def train_accum_arm(dev) -> dict:
    """gpt2-train-stream's width unpacked at STREAM_B x 1024: one
    ``value_and_grad_fn`` with ``accum_steps=2`` against ``accum_steps=1``
    on the same parameters and batch (global-batch invariance held on
    the gradients, not on an AdamW step: ROADMAP Queue 3 "looked like
    faults" (b)): the loss within TRAIN_BF16_TOL's 2e-4, every gradient
    leaf within its 0.06 of the leaf's largest value, exact launches
    (every kernel once per microbatch); each arm timed on a second, warm
    call.  Prints ``train-accum metrics {...}``; returns the first
    calls' launches."""
    from ray_tpu_torch import GPTConfig, init_params
    from ray_tpu_torch.models.training import (build_gpt_train,
                                               synthetic_lm_batch)
    from ray_tpu_torch.ops import _build

    cfg = GPTConfig.gpt2(**TRAIN_CFG, dtype=torch.bfloat16)
    params = init_params(cfg, torch.Generator().manual_seed(0), device=dev)
    batch = synthetic_lm_batch(torch.Generator().manual_seed(1), STREAM_B,
                               TRAIN_S, cfg.vocab_size, device=dev)
    runs, total = {}, {}
    for k in (1, 2):
        fns = build_gpt_train(cfg, accum_steps=k, device=dev,
                              telemetry=False)
        _build.reset_launches()
        loss, grads = fns["value_and_grad_fn"](params, batch)
        torch.cuda.synchronize()
        launches = _build.launch_counts()
        t0 = time.monotonic()                   # a second call, warm
        fns["value_and_grad_fn"](params, batch)
        torch.cuda.synchronize()
        ms = (time.monotonic() - t0) * 1e3
        expect_launches(f"accum_steps={k}", launches,
                        {n: c * k for n, c in TRAIN_LAUNCHES.items()})
        total = add_launches(total, launches)
        runs[k] = (float(loss), grads, ms)
    dl = abs(runs[2][0] - runs[1][0])
    worst_share, worst = 0.0, ""
    for name, x, y in _tree_pairs(runs[2][1], runs[1][1]):
        err = (x.float() - y.float()).abs().max().item()
        share = err / (TRAIN_BF16_TOL["grad"]
                       * y.float().abs().max().item() + 1e-30)
        if not math.isfinite(share) or share > worst_share:
            worst_share, worst = share, name
    out = {"cell": "gpt2-train-accum", "card": card(),
           "batch": [STREAM_B, TRAIN_S], "loss_k1": runs[1][0],
           "loss_k2": runs[2][0], "loss_diff": dl,
           "worst_grad": worst, "worst_grad_share_of_tol": worst_share,
           "value_and_grad_ms_k1": runs[1][2],
           "value_and_grad_ms_k2": runs[2][2]}
    print("train-accum metrics " + json.dumps(out), flush=True)
    if not (dl <= TRAIN_BF16_TOL["loss_abs"] and worst_share <= 1):
        raise AssertionError(f"accum_steps=2 parts from accum_steps=1: "
                             f"loss {dl:.3e}, {worst} {worst_share:.3f}")
    del params, runs
    torch.cuda.empty_cache()
    return total


# the cell "gpt2-train-worker": gpt2-train-b24 in a TorchTrainer worker
# (num_gpus=1), its gradients reduced over the trainer's NCCL world of 1
TRAIN_WORKER_TEL_TOL = 0.10     # recorder's steady step vs the window's
TRAIN_WORKER_RELEASE_S = 5.0    # fit() returned -> worker gone, card free
# gpt2-train-sharded: the same worker trains gpt2-train-b24 again on the
# mesh of ScalingConfig.mesh_axes, every sharded axis at 1 (a world of 1)
TRAIN_SHARDED_AXES = {"dp": 1, "fsdp": 1, "sp": 1, "tp": 1}


def train_sharded_arm(cfg, dev) -> dict:
    """gpt2-train-sharded, in the train worker after its data-parallel
    arm: the mesh of the trainer's ``ScalingConfig.mesh_axes``
    (``train.get_context().get_mesh_axes()``), the full tree drawn from
    the driver's seed and cut by ``sharding.shard_params`` into this
    rank's shards, and WARMUP_STEPS + TIMED_STEPS steps of the sharded
    gradient path from the same batch; the launches of the timed steps.
    A world of 1: every axis is 1, so each shard is the whole tensor and
    every reduction spans one rank; nothing here measures multi-rank
    speed."""
    from ray_tpu_torch import init_params, train
    from ray_tpu_torch.models.gpt import param_logical_axes
    from ray_tpu_torch.models.training import (build_gpt_train,
                                               default_optimizer,
                                               synthetic_lm_batch)
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.parallel import sharding
    from ray_tpu_torch.parallel.mesh import make_mesh

    axes = train.get_context().get_mesh_axes()
    mesh = make_mesh(**axes)
    fns = build_gpt_train(cfg, mesh, optimizer=default_optimizer(**TRAIN_OPT),
                          device=dev, telemetry=False)
    full = init_params(cfg, torch.Generator().manual_seed(0), device=dev)
    state = fns["init_fn"](params=sharding.shard_params(
        full, mesh, param_logical_axes(cfg)))
    del full
    batch = fns["shard_batch"](synthetic_lm_batch(
        torch.Generator().manual_seed(1), TRAIN_B, TRAIN_S, cfg.vocab_size,
        device=dev))
    losses, norms, walls = [], [], []
    for i in range(WARMUP_STEPS + TIMED_STEPS):
        if i == WARMUP_STEPS:
            torch.cuda.synchronize()
            _build.reset_launches()
            t0 = time.monotonic()
        t_step = time.monotonic()
        state, m = fns["step_fn"](state, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        if i >= WARMUP_STEPS:
            walls.append(1e3 * (time.monotonic() - t_step))
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    return {"axes": axes, "mesh": dict(mesh.shape.items()),
            "losses": losses, "grad_norms": norms,
            "launches": _build.launch_counts(),
            "step_ms": 1e3 * wall / TIMED_STEPS,
            "median_step_ms": float(np.median(walls)),
            "step_walls_ms": walls}


# gpt2-train-overlap: the same worker, after the sharded arm, on the same
# mesh: the overlap schedule's local program (a world of 1, every axis 1)
# through overlap.build_overlap_step_fns, called directly since
# build_gpt_train on one device falls back to gspmd as the reference's
# does, against the gspmd arm's value_and_grad_fn on the same shards and
# batch.  Bounds: TRAIN_BF16_TOL's gradient share; the loss within 2e-4
# relative (the gspmd arm runs the fused epilogue and flash-CE, the
# overlap schedule plain norms, projections and vocabulary CE with f32
# logits).  Each arm: WARMUP_STEPS calls, then OVERLAP_CALLS timed ones.
OVERLAP_CALLS = 8
OVERLAP_LOSS_REL = 2e-4
# launches of one overlap value_and_grad: per layer one attention forward
# and backward; everything else is plain
OVERLAP_LAUNCHES = {"flash_attention_fwd": 12, "flash_attention_bwd": 12}


def _timed_calls(fn) -> dict:
    """The first call's loss and gradients (the gradients on the host),
    then WARMUP_STEPS - 1 more warm-up calls and OVERLAP_CALLS calls each
    ended by a sync: their median ms, the peak memory over them and
    their launches."""
    from ray_tpu_torch.ops import _build
    loss, grads = fn()
    out = {"loss": float(loss), "grads": {
        k: v.detach().cpu() for k, v in _flat_tree(grads).items()}}
    del loss, grads
    for _ in range(WARMUP_STEPS - 1):
        fn()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    walls = []
    for _ in range(OVERLAP_CALLS):
        t = time.monotonic()
        res = fn()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.monotonic() - t))
        del res
    out.update(launches=_build.launch_counts(), walls_ms=walls,
               median_ms=float(np.median(walls)),
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    return out


def _flat_tree(tree, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_tree(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


def train_overlap_arm(cfg, dev) -> dict:
    """gpt2-train-overlap, in the train worker after the sharded arm: the
    mesh of the trainer's ``ScalingConfig.mesh_axes``, the full tree from
    the driver's seed cut into this rank's shards, the batch's rows; the
    gspmd arm's ``value_and_grad_fn`` and then the overlap schedule's
    ``value_and_grad`` (``_timed_calls`` each), the overlap arm's loss
    and every gradient leaf against the gspmd arm's.  A world of 1:
    nothing here measures a collective, NVLink or overlap of transfers
    with compute."""
    from ray_tpu_torch import init_params, train
    from ray_tpu_torch.models.gpt import param_logical_axes
    from ray_tpu_torch.models.training import (build_gpt_train,
                                               synthetic_lm_batch)
    from ray_tpu_torch.parallel import overlap, sharding
    from ray_tpu_torch.parallel.mesh import make_mesh

    axes = train.get_context().get_mesh_axes()
    mesh = make_mesh(**axes)
    full = init_params(cfg, torch.Generator().manual_seed(0), device=dev)
    params = sharding.shard_params(full, mesh, param_logical_axes(cfg))
    del full
    batch = sharding.shard_batch(synthetic_lm_batch(
        torch.Generator().manual_seed(1), TRAIN_B, TRAIN_S, cfg.vocab_size,
        device=dev), mesh)
    gspmd = build_gpt_train(cfg, mesh, device=dev, telemetry=False)
    g = _timed_calls(lambda: gspmd["value_and_grad_fn"](params, batch))
    del gspmd
    gc.collect()
    torch.cuda.empty_cache()
    fns = overlap.build_overlap_step_fns(cfg, mesh, device=dev)
    o = _timed_calls(lambda: fns["value_and_grad"](
        params, batch["tokens"], batch["targets"]))
    shares = {}
    for k, want in g["grads"].items():
        want = want.to(dev).float()
        err = (o["grads"][k].to(dev).float() - want).abs().max().item()
        shares[k] = err / max(want.abs().max().item(), 1e-30)
    return {"axes": axes, "mesh": dict(mesh.shape.items()),
            "gspmd_loss": g["loss"], "overlap_loss": o["loss"],
            "loss_rel": abs(o["loss"] - g["loss"]) / abs(g["loss"]),
            "grad_shares": shares,
            "gspmd_median_ms": g["median_ms"],
            "overlap_median_ms": o["median_ms"],
            "gspmd_walls_ms": g["walls_ms"], "overlap_walls_ms": o["walls_ms"],
            "gspmd_peak_gib": g["peak_gib"], "overlap_peak_gib": o["peak_gib"],
            "gspmd_launches": g["launches"], "launches": o["launches"]}


def _card_check(where: str, want: str) -> None:
    """Raise unless this process sees exactly one card, named ``want``:
    a worker given the card never carries on without it."""
    if not torch.cuda.is_available() or torch.cuda.device_count() != 1 \
            or torch.cuda.get_device_name(0) != want:
        raise AssertionError(
            f"{where} sees {torch.cuda.device_count()} cards, want 1 "
            f"{want!r}")


def train_worker_loop(config: dict) -> None:
    """gpt2-train-worker's loop, in the train worker (by reference from
    this file, as ``RuntimeServer``): gates the card and the NCCL world,
    then trains gpt2-train-b24's WARMUP_STEPS + TIMED_STEPS steps through
    ``build_gpt_train(cfg, make_mesh(dp=-1), telemetry=True)`` from the
    driver's seeds, reporting each step; the last report carries the
    timed steps' launches, the recorder's summary and records, and rank
    0's state as a checkpoint saved in ``config["ckpt_dir"]``.  With
    ``config["sharded"]`` it also carries ``train_sharded_arm``'s run,
    made after the timed steps' launches are read."""
    import torch.distributed as dist

    from ray_tpu_torch import GPTConfig, train
    from ray_tpu_torch.models.training import (build_gpt_train,
                                               default_optimizer,
                                               synthetic_lm_batch)
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.parallel.mesh import make_mesh
    from ray_tpu_torch.train import Checkpoint, save_pytree
    from ray_tpu_torch.train.torch.config import WORLD_GROUP
    from ray_tpu_torch.util import collective

    t_start = time.time()
    torch_flags()
    _card_check("train worker", config["card"])
    if dist.get_backend() != "nccl" or dist.get_world_size() != 1:
        raise AssertionError(f"train worker's world: {dist.get_backend()}"
                             f" of {dist.get_world_size()} (want nccl of 1)")
    probe = torch.arange(1024, dtype=torch.float32, device="cuda") / 7
    got = collective.allreduce(probe, group_name=WORLD_GROUP)
    if not torch.equal(got, probe):
        raise AssertionError("collective.allreduce over the NCCL world of "
                             "1 changed its input")
    dev = torch.device("cuda")
    mesh = make_mesh(dp=-1)
    cfg = GPTConfig.gpt2(**TRAIN_CFG, dtype=torch.bfloat16)
    fns = build_gpt_train(cfg, mesh, optimizer=default_optimizer(**TRAIN_OPT),
                          device=dev, telemetry=True)
    state = fns["init_fn"](torch.Generator().manual_seed(0))
    batch = synthetic_lm_batch(torch.Generator().manual_seed(1), TRAIN_B,
                               TRAIN_S, cfg.vocab_size, device=dev)
    _build.load()
    torch.cuda.reset_peak_memory_stats()
    first = True
    walls = []
    for i in range(WARMUP_STEPS + TIMED_STEPS):
        if i == WARMUP_STEPS:
            torch.cuda.synchronize()
            _build.reset_launches()
            t0 = time.monotonic()
        t_step = time.monotonic()
        state, m = fns["step_fn"](state, batch)
        t_call = time.monotonic()
        rep = {"step": i + 1, "loss": float(m["loss"]),
               "grad_norm": float(m["grad_norm"])}
        if first:
            rep.update(first_report_ts=time.time(), loop_start_ts=t_start)
            first = False
        if i < WARMUP_STEPS + TIMED_STEPS - 1:
            train.report(rep)
        if i >= WARMUP_STEPS:     # (the wrapped call, the whole step)
            walls.append((t_call - t_step, time.monotonic() - t_step))
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    tel = fns["telemetry"]
    rep.update(
        launches=_build.launch_counts(),
        step_ms=1e3 * wall / TIMED_STEPS,
        median_step_ms=1e3 * float(np.median([w for _, w in walls])),
        step_call_ms=[1e3 * c for c, _ in walls],
        step_walls_ms=[1e3 * w for _, w in walls],
        summary=tel.summary(), records=tel.records,
        peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        nccl_init_s=collective.get_group(WORLD_GROUP).init_s,
        pid=os.getpid(), visible=os.environ.get("CUDA_VISIBLE_DEVICES"),
        mesh={"dp": mesh.shape["dp"], "size": int(mesh.size)})
    if config.get("sharded"):
        rep["sharded"] = train_sharded_arm(cfg, dev)
    if config.get("overlap"):
        rep["overlap"] = train_overlap_arm(cfg, dev)
    if config.get("pp"):
        rep["pp"] = train_pp_arm(cfg, dev)
        rep["moe"] = train_moe_arm(dev)
    ckpt = None
    if train.get_context().get_world_rank() == 0:
        path = config["ckpt_dir"]
        t = time.monotonic()
        save_pytree(state, path)
        rep["checkpoint_save_s"] = time.monotonic() - t
        ckpt = Checkpoint.from_directory(path)
    train.report(rep, checkpoint=ckpt)


def _wait_card_back(rt, pids, what: str) -> float:
    """Seconds until every process in ``pids`` is gone and the session
    has its one card back; raises after TRAIN_WORKER_RELEASE_S."""
    t0 = time.monotonic()
    while any(_alive(p) for p in pids) or \
            rt.available_resources().get("GPU") != 1.0:
        if time.monotonic() - t0 > TRAIN_WORKER_RELEASE_S:
            raise AssertionError(
                f"{what}: pids alive {[p for p in pids if _alive(p)]}, "
                f"resources {rt.available_resources()} "
                f"{TRAIN_WORKER_RELEASE_S} s after fit()")
        time.sleep(0.02)
    return time.monotonic() - t0


def train_worker_phase(dev, default: dict, *, sharded: bool = False,
                       overlap: bool = False, pp: bool = False) -> dict:
    """gpt2-train-worker: ``ray_tpu_torch.init`` and a ``TorchTrainer``
    of one ``num_gpus=1`` worker (``ScalingConfig(use_gpu=True)``) whose
    backend forms an NCCL world of 1; its loop (``train_worker_loop``)
    trains gpt2-train-b24 from the driver's seeds with the step recorder
    on.  Gates: the worker's one card and its NCCL world, exact launches
    read back from the worker, every step's loss and grad_norm equal to
    ``default`` (this process's ``train_phase`` run) within
    TRAIN_BF16_TOL's loss bound, the recorder's steady step (a median)
    within TRAIN_WORKER_TEL_TOL of the worker's measured ms/step (the
    timed window's wall over TIMED_STEPS, each step's loss read and
    reported included) and its MFU the ``flops.mfu`` of its tokens/s,
    ``compile_s`` on step 0 alone, rank 0's checkpoint (saved in the
    run's storage, removed here) loaded here at the steps run, and the
    worker gone and the card free within TRAIN_WORKER_RELEASE_S of
    ``fit()``.  Prints ``train-worker metrics {...}``.  ``sharded``: the
    trainer's ``ScalingConfig`` carries TRAIN_SHARDED_AXES and the worker
    also runs gpt2-train-sharded (``train_sharded_arm``), whose every
    loss and grad norm must equal the data-parallel arm's exactly and
    whose launches must equal its launches; prints ``train-sharded
    metrics {...}``.  ``overlap`` (with ``sharded``): the worker then
    runs gpt2-train-overlap (``train_overlap_arm``), whose loss must be
    within OVERLAP_LOSS_REL of the gspmd arm's, every gradient leaf within
    TRAIN_BF16_TOL's share of its largest value, and whose timed calls
    must launch OVERLAP_LAUNCHES each and nothing else; prints
    ``train-overlap metrics {...}``.  ``pp``: the worker then runs
    gpt2-train-pp (``train_pp_arm``: the pipeline trainer on
    ``make_mesh(pp=1)`` with both schedules, gated by ``pp_report``) and
    gpt2-train-moe (``train_moe_arm``, gated by ``moe_report``).  Returns
    the launches of each arm run, by path (``train_worker``,
    ``train_sharded``, ``train_overlap``, ``train_pp_gpipe``,
    ``train_pp_1f1b``, ``train_moe``)."""
    import shutil
    import tempfile

    import ray_tpu_torch as rt
    from ray_tpu_torch import GPTConfig
    from ray_tpu_torch.telemetry import flops
    from ray_tpu_torch.train import RunConfig, ScalingConfig, load_pytree
    from ray_tpu_torch.train.torch import TorchConfig, TorchTrainer

    import chip_smoke
    storage = tempfile.mkdtemp(prefix="gpt2_train_worker_runs_")
    rt.init(num_cpus=RUNTIME_CPUS)
    try:
        if rt.cluster_resources().get("GPU") != 1.0:
            raise AssertionError(f"train worker: the node found "
                                 f"{rt.cluster_resources()}")
        trainer = TorchTrainer(
            chip_smoke.train_worker_loop,
            torch_config=TorchConfig(host_collective=False),
            train_loop_config={"card": torch.cuda.get_device_name(0),
                               "ckpt_dir": os.path.join(storage, "state"),
                               "sharded": sharded,
                               "overlap": overlap, "pp": pp},
            scaling_config=ScalingConfig(
                num_workers=1, use_gpu=True,
                mesh_axes=TRAIN_SHARDED_AXES if sharded else None),
            run_config=RunConfig(name="gpt2-train-worker",
                                 storage_path=storage))
        t_fit = time.time()
        result = trainer.fit()
        fit_s = time.time() - t_fit
        if result.error is not None:
            raise AssertionError(f"train worker failed: {result.error}")
        hist = result.metrics_history
        last = hist[-1]
        release_s = _wait_card_back(rt, [last["pid"]], "train worker")
    finally:
        rt.shutdown()
    steps = WARMUP_STEPS + TIMED_STEPS
    if [h["step"] for h in hist] != list(range(1, steps + 1)):
        raise AssertionError(f"train worker reported steps "
                             f"{[h['step'] for h in hist]}")
    if last["visible"] != "0" or last["mesh"] != {"dp": 1, "size": 1}:
        raise AssertionError(f"train worker: CUDA_VISIBLE_DEVICES "
                             f"{last['visible']!r}, mesh {last['mesh']}")
    expect_launches("train worker", last["launches"],
                    {k: n * TIMED_STEPS for k, n in TRAIN_LAUNCHES.items()})
    d_loss = max(abs(h["loss"] - x) for h, x in zip(hist, default["losses"]))
    d_norm = max(abs(h["grad_norm"] - x)
                 for h, x in zip(hist, default["grad_norms"]))
    print(f"train worker: largest |loss - driver's| {d_loss:.3e}, "
          f"|grad_norm - driver's| {d_norm:.3e} over {steps} steps "
          f"(bound {TRAIN_BF16_TOL['loss_abs']})", flush=True)
    if not (d_loss <= TRAIN_BF16_TOL["loss_abs"]
            and d_norm <= TRAIN_BF16_TOL["loss_abs"]):
        raise AssertionError("train worker: losses or grad norms part from "
                             "the driver's run")
    summ, recs = last["summary"], last["records"]
    step_s = last["step_ms"] / 1e3
    if not abs(summ["steady_step_s"] - step_s) <= TRAIN_WORKER_TEL_TOL \
            * step_s:
        raise AssertionError(f"train worker: recorder's steady step "
                             f"{summ['steady_step_s']:.4f} s vs the "
                             f"window's {step_s:.4f} s a step")
    cfg = GPTConfig.gpt2(**TRAIN_CFG, dtype=torch.bfloat16)
    fpt = flops.gpt_train_flops_per_token(cfg, TRAIN_S, ce_recompute=True)
    want_mfu = flops.mfu(summ["tokens_per_sec"], fpt)
    if summ["flops_per_token"] != fpt or \
            not abs(summ["mfu"] - want_mfu) <= 1e-12 * want_mfu:
        raise AssertionError(f"train worker: recorder's MFU {summ['mfu']} "
                             f"vs flops.mfu {want_mfu}")
    with_compile = [r["step"] for r in recs if "compile_s" in r]
    if with_compile != [0] or len(recs) != steps:
        raise AssertionError(f"train worker: compile_s on steps "
                             f"{with_compile} of {len(recs)} records")
    t = time.monotonic()
    state = load_pytree(result.checkpoint.path)
    load_s = time.monotonic() - t
    shutil.rmtree(storage, ignore_errors=True)
    if state.step != steps:
        raise AssertionError(f"train worker: the checkpoint holds step "
                             f"{state.step}, {steps} were run")
    first_report_s = hist[0]["first_report_ts"] - t_fit
    metrics = {
        "cell": "gpt2-train-worker", "fit_s": fit_s,
        "fit_to_first_report_s": first_report_s,
        "fit_to_loop_start_s": hist[0]["loop_start_ts"] - t_fit,
        "nccl_init_s": last["nccl_init_s"],
        "worker_step_ms": last["step_ms"],
        "worker_median_step_ms": last["median_step_ms"],
        "worker_step_walls_ms": last["step_walls_ms"],
        "worker_step_call_ms": last["step_call_ms"],
        "telemetry_walls_ms": [1e3 * r["wall_s"]
                               for r in recs[WARMUP_STEPS:]],
        "driver_step_ms": default["step_ms"],
        "telemetry_steady_step_ms": 1e3 * summ["steady_step_s"],
        "telemetry_compile_s": summ["compile_s"],
        "worker_mfu": flops.mfu(TRAIN_B * TRAIN_S * 1e3
                                / last["step_ms"], fpt),
        "driver_mfu": default["mfu"], "telemetry_mfu": summ["mfu"],
        "worker_peak_gib": last["peak_gib"],
        "driver_peak_gib": default["max_memory_allocated_gib"],
        "checkpoint_save_s": last["checkpoint_save_s"],
        "checkpoint_load_s": load_s, "release_s": release_s,
        "max_loss_diff": d_loss, "max_grad_norm_diff": d_norm}
    print("train-worker: NCCL world of 1, launches read back exact, "
          f"losses equal the driver's, checkpoint at step {state.step} "
          f"loaded, worker gone and card free {release_s:.3f} s after "
          "fit()", flush=True)
    print("train-worker metrics " + json.dumps(metrics), flush=True)
    paths = {"train_worker": last["launches"]}
    dp_losses = [h["loss"] for h in hist]
    dp_norms = [h["grad_norm"] for h in hist]
    if sharded:
        paths["train_sharded"] = sharded_report(last["sharded"], last,
                                                dp_losses, dp_norms, steps)
    if overlap:
        paths["train_overlap"] = overlap_report(last["overlap"])
    if pp:
        paths.update(pp_report(last["pp"], dp_losses, dp_norms))
        paths.update(moe_report(last["moe"]))
    return paths


def sharded_report(arm: dict, last: dict, dp_losses: list, dp_norms: list,
                   steps: int) -> dict:
    """gpt2-train-sharded's gates and its ``train-sharded metrics`` line;
    returns its launches."""
    if arm["axes"] != TRAIN_SHARDED_AXES or arm["mesh"] != TRAIN_SHARDED_AXES:
        raise AssertionError(f"train-sharded: mesh_axes {arm['axes']} built "
                             f"{arm['mesh']}, want {TRAIN_SHARDED_AXES}")
    if arm["losses"] != dp_losses or arm["grad_norms"] != dp_norms:
        raise AssertionError(
            f"train-sharded: losses {arm['losses']} grad norms "
            f"{arm['grad_norms']} differ from the data-parallel arm's "
            f"{dp_losses} {dp_norms}")
    if _nonzero(arm["launches"]) != _nonzero(last["launches"]):
        raise AssertionError(f"train-sharded: launches "
                             f"{_nonzero(arm['launches'])} vs the data-"
                             f"parallel arm's {_nonzero(last['launches'])}")
    out = {"cell": "gpt2-train-sharded", "card": card(),
           "mesh_axes": arm["axes"], "sharded_step_ms": arm["step_ms"],
           "dp_step_ms": last["step_ms"],
           "sharded_median_step_ms": arm["median_step_ms"],
           "dp_median_step_ms": last["median_step_ms"],
           "sharded_step_walls_ms": arm["step_walls_ms"], "steps": steps,
           "losses_equal": True, "grad_norms_equal": True,
           "launches": _nonzero(arm["launches"])}
    print(f"train-sharded: a world of 1 on {TRAIN_SHARDED_AXES}: {steps} "
          "losses and grad norms equal the data-parallel arm's exactly, "
          "launches equal", flush=True)
    print("train-sharded metrics " + json.dumps(out), flush=True)
    return arm["launches"]


def overlap_report(arm: dict) -> dict:
    """gpt2-train-overlap's gates and its ``train-overlap metrics``
    line; returns its launches."""
    if arm["axes"] != TRAIN_SHARDED_AXES or arm["mesh"] != TRAIN_SHARDED_AXES:
        raise AssertionError(f"train-overlap: mesh_axes {arm['axes']} built "
                             f"{arm['mesh']}, want {TRAIN_SHARDED_AXES}")
    worst = max(arm["grad_shares"], key=arm["grad_shares"].get)
    print(f"train-overlap: loss {arm['overlap_loss']:.6f} vs gspmd "
          f"{arm['gspmd_loss']:.6f} (relative {arm['loss_rel']:.3e}, bound "
          f"{OVERLAP_LOSS_REL}); largest gradient share "
          f"{arm['grad_shares'][worst]:.3e} at {worst} (bound "
          f"{TRAIN_BF16_TOL['grad']})", flush=True)
    if not arm["loss_rel"] <= OVERLAP_LOSS_REL:
        raise AssertionError("train-overlap: the loss parts from the gspmd "
                             "arm's")
    if not arm["grad_shares"][worst] <= TRAIN_BF16_TOL["grad"]:
        raise AssertionError(f"train-overlap: gradient {worst} parts from "
                             "the gspmd arm's")
    expect_launches("train-overlap", arm["launches"],
                    {k: n * OVERLAP_CALLS for k, n in OVERLAP_LAUNCHES.items()})
    out = {"cell": "gpt2-train-overlap", "card": card(),
           "mesh_axes": arm["axes"], "calls": OVERLAP_CALLS,
           **{k: arm[k] for k in (
               "gspmd_loss", "overlap_loss", "loss_rel",
               "gspmd_median_ms", "overlap_median_ms", "gspmd_walls_ms",
               "overlap_walls_ms", "gspmd_peak_gib", "overlap_peak_gib")},
           "max_grad_share": arm["grad_shares"][worst],
           "max_grad_share_leaf": worst,
           "launches_per_call": {k: v // OVERLAP_CALLS for k, v in
                                 _nonzero(arm["launches"]).items()},
           "gspmd_launches_per_call": {
               k: v // OVERLAP_CALLS
               for k, v in _nonzero(arm["gspmd_launches"]).items()}}
    print("train-overlap metrics " + json.dumps(out), flush=True)
    return arm["launches"]


# gpt2-train-pp: the same worker trains gpt2-train-b24 again through the
# pipeline trainer on make_mesh(pp=1) (one stage: a world of 1), both
# schedules at M = 4 microbatches of 6 rows, from the dp arm's seeds.
# Launches of one step: GPipe runs each microbatch's stage forward once
# and its backward once.  1F1B runs a stage's forward at its tick
# without a graph and again, under autograd, at its backward tick, but
# the last stage's two ticks are one and it runs the forward once; the
# one stage here is the last, so both schedules launch alike.
# Bounds against the dp arm: the first two steps run on equal parameters
# (the warmup's lr is 0 at step 0), so their losses hold TRAIN_BF16_TOL's
# 2e-4 (only the loss's f32 summation differs) and their grad norms
# PP_EQUAL_NORM_REL (each microbatch's bf16 gradients are rounded before
# the f32 sum).  Later steps run on parameters that drift apart: AdamW
# turns those roundings into steps of up to lr on near-zero gradients
# (on an H100: 3.7e-3 and 3.9% by step 10, with steps 0-1 equal; PERF.md
# section 6), so the trajectory is held to PP_LOSS_ABS and PP_NORM_REL,
# and the pipeline's gradients are held to the dp step's on the same
# parameters after the last step (``build_gpt_train``'s
# ``value_and_grad_fn``): the loss within TRAIN_BF16_TOL's 2e-4, every
# leaf within its 0.06 share.
PP_M = 4
PP_EQUAL_NORM_REL = 1e-3
PP_LOSS_ABS = 1e-2
PP_NORM_REL = 0.1


PP_STEP_LAUNCHES = {"flash_attention_fwd": 12 * PP_M,
                    "flash_attention_bwd": 12 * PP_M,
                    "matmul_residual_norm_fwd": 12 * PP_M,
                    "matmul_residual_norm_bwd": 12 * PP_M,
                    "flash_ce_fwd": PP_M, "flash_ce_bwd": PP_M}


def train_pp_arm(cfg, dev) -> dict:
    """gpt2-train-pp, in the train worker after the overlap arm:
    ``build_gpt_train_pp(cfg, make_mesh(pp=1), num_microbatches=PP_M)``
    with each schedule, WARMUP_STEPS + TIMED_STEPS steps from the dp
    arm's seeds and batch; each schedule's losses, grad norms, timed
    steps' launches and wall, the peak memory over its steps (the
    allocator's peak reset after its state is made) and the dict's
    schedule figures; then its loss and gradients against the dp step's
    (``build_gpt_train``) on the same final parameters and batch.  One
    stage: nothing here measures a transfer between stages or the
    bubble."""
    from ray_tpu_torch.convert import fold_stages
    from ray_tpu_torch.models.training import (build_gpt_train,
                                               build_gpt_train_pp,
                                               default_optimizer,
                                               synthetic_lm_batch)
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(pp=1)
    dp = build_gpt_train(cfg, device=dev, telemetry=False)
    out = {}
    for schedule in ("gpipe", "1f1b"):
        gc.collect()
        torch.cuda.empty_cache()
        fns = build_gpt_train_pp(cfg, mesh, num_microbatches=PP_M,
                                 schedule=schedule,
                                 optimizer=default_optimizer(**TRAIN_OPT),
                                 device=dev, telemetry=False)
        state = fns["init_fn"](torch.Generator().manual_seed(0))
        batch = fns["shard_batch"](synthetic_lm_batch(
            torch.Generator().manual_seed(1), TRAIN_B, TRAIN_S,
            cfg.vocab_size, device=dev))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, norms, walls = [], [], []
        for i in range(WARMUP_STEPS + TIMED_STEPS):
            if i == WARMUP_STEPS:
                torch.cuda.synchronize()
                _build.reset_launches()
                t0 = time.monotonic()
            t_step = time.monotonic()
            state, m = fns["step_fn"](state, batch)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            if i >= WARMUP_STEPS:
                walls.append(1e3 * (time.monotonic() - t_step))
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = _build.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        loss, grads = fns["value_and_grad_fn"](state.params, batch)
        want_loss, want = dp["value_and_grad_fn"](fold_stages(state.params),
                                                  batch)
        shares = {k: ((g.float() - want_k.float()).abs().max()
                      / want_k.float().abs().max()).item()
                  for (k, g), want_k in zip(
                      _flat_tree(fold_stages(grads)).items(),
                      _flat_tree(want).values())}
        worst = max(shares, key=shares.get)
        del grads, want
        out[schedule] = {
            "losses": losses, "grad_norms": norms,
            "launches": launches,
            "same_params_loss_diff": float(loss) - float(want_loss),
            "same_params_worst_share": shares[worst],
            "same_params_worst_leaf": worst,
            "step_ms": 1e3 * wall / TIMED_STEPS,
            "median_step_ms": float(np.median(walls)),
            "step_walls_ms": walls, "peak_gib": peak,
            **{k: fns[k] for k in ("schedule", "stage_axis",
                                   "num_microbatches", "bubble_fraction",
                                   "in_flight_microbatches")}}
        del state, fns, batch
    return out


def pp_report(arms: dict, dp_losses: list, dp_norms: list) -> dict:
    """gpt2-train-pp's gates and its ``train-pp metrics`` line; returns
    each schedule's launches by path."""
    from ray_tpu_torch import GPTConfig
    from ray_tpu_torch.parallel.pipeline import pipeline_schedule_stats
    from ray_tpu_torch.telemetry import flops
    cfg = GPTConfig.gpt2(**TRAIN_CFG, dtype=torch.bfloat16)
    fpt = flops.gpt_train_flops_per_token(cfg, TRAIN_S, ce_recompute=True)
    metrics = {"cell": "gpt2-train-pp", "card": card(),
               "num_microbatches": PP_M, "batch": [TRAIN_B, TRAIN_S]}
    for schedule, arm in arms.items():
        stats = pipeline_schedule_stats(1, PP_M, schedule)
        if (arm["schedule"], arm["stage_axis"], arm["num_microbatches"]) \
                != (schedule, "pp", PP_M) \
                or arm["bubble_fraction"] != 0.0 \
                or arm["in_flight_microbatches"] != \
                stats["in_flight_microbatches"]:
            raise AssertionError(f"train-pp {schedule}: figures {arm}")
        d_first = max(abs(a - b) for a, b in zip(arm["losses"][:2],
                                                  dp_losses[:2]))
        n_first = max(abs(a - b) / b for a, b in zip(arm["grad_norms"][:2],
                                                     dp_norms[:2]))
        d_loss = max(abs(a - b) for a, b in zip(arm["losses"], dp_losses))
        d_norm = max(abs(a - b) / b for a, b in zip(arm["grad_norms"],
                                                    dp_norms))
        print(f"train-pp {schedule}: steps 0-1 (equal parameters) |loss - "
              f"dp arm's| {d_first:.3e}, grad norm {n_first:.3e} relative "
              f"(bounds {TRAIN_BF16_TOL['loss_abs']}, {PP_EQUAL_NORM_REL}); "
              f"all steps {d_loss:.3e}, {d_norm:.3e} (bounds {PP_LOSS_ABS}, "
              f"{PP_NORM_REL}); on the last parameters loss "
              f"{arm['same_params_loss_diff']:+.3e}, worst gradient share "
              f"{arm['same_params_worst_share']:.3e} at "
              f"{arm['same_params_worst_leaf']} (bounds "
              f"{TRAIN_BF16_TOL['loss_abs']}, {TRAIN_BF16_TOL['grad']})",
              flush=True)
        if not (d_first <= TRAIN_BF16_TOL["loss_abs"]
                and n_first <= PP_EQUAL_NORM_REL
                and d_loss <= PP_LOSS_ABS and d_norm <= PP_NORM_REL
                and abs(arm["same_params_loss_diff"])
                <= TRAIN_BF16_TOL["loss_abs"]
                and arm["same_params_worst_share"] <= TRAIN_BF16_TOL["grad"]):
            raise AssertionError(f"train-pp {schedule}: losses "
                                 f"{arm['losses']} or grad norms "
                                 f"{arm['grad_norms']} part from the dp "
                                 f"arm's {dp_losses} {dp_norms}")
        expect_launches(f"train-pp {schedule}", arm["launches"],
                        {k: n * TIMED_STEPS for k, n in
                         PP_STEP_LAUNCHES.items()})
        tok_s = TRAIN_B * TRAIN_S * 1e3 / arm["step_ms"]
        metrics[schedule] = {
            "step_ms": arm["step_ms"], "median_step_ms":
                arm["median_step_ms"], "step_walls_ms": arm["step_walls_ms"],
            "tokens_per_s": tok_s, "mfu": flops.mfu(tok_s, fpt),
            "peak_gib": arm["peak_gib"], "max_loss_diff": d_loss,
            "max_grad_norm_rel_diff": d_norm,
            **{k: arm[k] for k in ("same_params_loss_diff",
                                   "same_params_worst_share",
                                   "same_params_worst_leaf")},
            "bubble_fraction": arm["bubble_fraction"],
            "in_flight_microbatches": arm["in_flight_microbatches"],
            "launches_per_step": PP_STEP_LAUNCHES}
    if not arms["1f1b"]["peak_gib"] < arms["gpipe"]["peak_gib"]:
        raise AssertionError(f"train-pp: 1F1B's peak "
                             f"{arms['1f1b']['peak_gib']:.3f} GiB is not "
                             f"below GPipe's {arms['gpipe']['peak_gib']:.3f}")
    print("train-pp: both schedules' losses and grad norms hold the dp "
          "arm's, launches exact, 1F1B's peak below GPipe's", flush=True)
    print("train-pp metrics " + json.dumps(metrics), flush=True)
    return {f"train_pp_{s}": arm["launches"] for s, arm in arms.items()}


# gpt2-train-moe: GPT-2 124M's widths with every FFN a MoE of 8 experts
# (top 2, capacity factor 1.5), bf16, in the same worker (a world of 1).
# Batch 4 x 1024, not 24 x 1024: the reference's dispatch and combine are
# one-hot [T, E, C] f32 tensors, T * E * C * 4 bytes each, which grow as
# T^2 (C = 1.5 T 2 / 8): 7.25 GB each at 24,576 tokens (two a layer plus
# temporaries), 201 MB at 4,096.  Launches per step: the dense step's
# (the kernels run around the plain expert matmuls and router).
# Kernel path against plain path (one step, full depth, batch 2 x 1024):
# the router's top-2 choice flips for near-tied tokens when its input
# moves by one bf16 rounding, and each flip moves a token's expert
# gradients whole, kernels or not: on an H100 the bf16 kernel path and
# the plain path in bf16 read worst gradient shares of 0.31 and 0.33
# against the plain path in f32 (PERF.md section 6; a dense model's stay
# under phase 9's 0.06).  So the gate is phase 9's f32 one
# (TRAIN_F32_TOL, kernel path in f32 against the plain path in f32: no
# bf16 rounding moves the router), and the bf16 paths' loss and
# gradient shares are printed, not gated.  Drops: one more step at
# capacity factor 0.5 must keep fewer than T * top_k assignments in
# every layer.
MOE_CFG = dict(n_experts=8, moe_top_k=2, moe_capacity_factor=1.5)
MOE_B = 4
MOE_CHECK_B = 2
MOE_DROP_CF = 0.5


def _moe_correctness(dev) -> dict:
    """One step of the MoE model at full depth, batch MOE_CHECK_B x 1024:
    the kernel path in f32 and bf16 and the plain path in f32 and bf16
    (``gpt.loss_fn(..., fuse_norm=False, ce_mode="xla")`` with local
    attention): losses, the kernel launches of the kernel runs, and the
    largest gradient share of each run against the f32 plain path."""
    from ray_tpu_torch import GPTConfig, init_params
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.models.training import (synthetic_lm_batch,
                                               value_and_grad)
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops.attention import make_flash_attention_fn

    cfg32 = GPTConfig.gpt2(**TRAIN_CFG, **MOE_CFG, dtype=torch.float32)
    cfg16 = dataclasses.replace(cfg32, dtype=torch.bfloat16)
    p32 = init_params(cfg32, torch.Generator().manual_seed(2), device=dev)
    batch = synthetic_lm_batch(torch.Generator().manual_seed(3), MOE_CHECK_B,
                               TRAIN_S, cfg32.vocab_size, device=dev)
    attn = make_flash_attention_fn(rope_theta=cfg32.rope_theta)

    def to(tree, dtype):
        return {k: to(v, dtype) if isinstance(v, dict) else v.to(dtype)
                for k, v in tree.items()}

    def run(cfg, p, kernels):
        _build.reset_launches()
        if kernels:
            fn = (lambda p_, b_: gpt.loss_fn(p_, b_, cfg, attn_fn=attn))
        else:
            fn = (lambda p_, b_: gpt.loss_fn(p_, b_, cfg, fuse_norm=False,
                                             ce_mode="xla"))
        loss, grads = value_and_grad(fn, p, batch)
        torch.cuda.synchronize()
        return float(loss), _flat_tree(grads), _build.launch_counts()

    ref_loss, ref, _ = run(cfg32, p32, False)
    out = {"plain_f32_loss": ref_loss}
    p16 = to(p32, torch.bfloat16)
    for label, cfg, p, kernels in (("kernel_f32", cfg32, p32, True),
                                   ("kernel_bf16", cfg16, p16, True),
                                   ("plain_bf16", cfg16, p16, False)):
        loss, grads, launches = run(cfg, p, kernels)
        shares = {k: ((g.float() - ref[k].float()).abs().max()
                      / ref[k].float().abs().max()).item()
                  for k, g in grads.items()}
        worst = max(shares, key=shares.get)
        out[label] = {"loss": loss, "loss_diff": loss - ref_loss,
                      "worst_share": shares[worst], "worst_leaf": worst,
                      "launches": _nonzero(launches)}
        del grads
        torch.cuda.empty_cache()
    return out


def train_moe_arm(dev) -> dict:
    """gpt2-train-moe, in the train worker after the pipeline arm: the
    correctness step (``_moe_correctness``), then ``build_gpt_train`` of
    the MoE model on ``make_mesh(dp=1, ep=1)``, WARMUP_STEPS +
    ARM_TIMED_STEPS steps at MOE_B x 1024 from seed 0 (the timed steps'
    launches, wall and the peak over the steps), then one step at
    capacity factor MOE_DROP_CF with ``moe.route`` counted: the
    assignments each layer's dispatch kept."""
    from ray_tpu_torch import GPTConfig
    from ray_tpu_torch.models.training import (build_gpt_train,
                                               default_optimizer,
                                               synthetic_lm_batch)
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.parallel import moe
    from ray_tpu_torch.parallel.mesh import make_mesh

    gc.collect()
    torch.cuda.empty_cache()
    out = {"correctness": _moe_correctness(dev)}
    gc.collect()
    torch.cuda.empty_cache()
    cfg = GPTConfig.gpt2(**TRAIN_CFG, **MOE_CFG, dtype=torch.bfloat16)
    mesh = make_mesh(dp=1, ep=1)
    fns = build_gpt_train(cfg, mesh, optimizer=default_optimizer(**TRAIN_OPT),
                          device=dev, telemetry=False)
    state = fns["init_fn"](torch.Generator().manual_seed(0))
    batch = synthetic_lm_batch(torch.Generator().manual_seed(1), MOE_B,
                               TRAIN_S, cfg.vocab_size, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, walls = [], []
    for i in range(WARMUP_STEPS + ARM_TIMED_STEPS):
        if i == WARMUP_STEPS:
            torch.cuda.synchronize()
            _build.reset_launches()
            t0 = time.monotonic()
        t_step = time.monotonic()
        state, m = fns["step_fn"](state, batch)
        losses.append(float(m["loss"]))
        if i >= WARMUP_STEPS:
            walls.append(1e3 * (time.monotonic() - t_step))
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    out.update(losses=losses, launches=_build.launch_counts(),
               step_ms=1e3 * wall / ARM_TIMED_STEPS,
               median_step_ms=float(np.median(walls)), step_walls_ms=walls,
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    T = MOE_B * TRAIN_S
    cap = moe.capacity(T, cfg.n_experts, cfg.moe_top_k,
                       cfg.moe_capacity_factor)
    out.update(tokens=T, capacity=cap,
               dispatch_bytes=T * cfg.n_experts * cap * 4)
    del fns
    drop = build_gpt_train(
        dataclasses.replace(cfg, moe_capacity_factor=MOE_DROP_CF), mesh,
        optimizer=default_optimizer(**TRAIN_OPT), device=dev,
        telemetry=False)
    kept = []
    route = moe.route

    def counted(*args, **kwargs):
        d, c, a = route(*args, **kwargs)
        kept.append(int(d.sum().item()))
        return d, c, a

    moe.route = counted
    try:
        drop["step_fn"](state, batch)
    finally:
        moe.route = route
    out.update(drop_kept=kept, drop_capacity=moe.capacity(
        T, cfg.n_experts, cfg.moe_top_k, MOE_DROP_CF))
    return out


def moe_report(arm: dict) -> dict:
    """gpt2-train-moe's gates and its ``train-moe metrics`` line; returns
    its launches by path."""
    c = arm["correctness"]
    ref = c["plain_f32_loss"]
    f32, b16, p16 = c["kernel_f32"], c["kernel_bf16"], c["plain_bf16"]
    print(f"train-moe correctness: f32 kernel path loss {f32['loss']:.6f} "
          f"vs plain {ref:.6f} (share_of_tol="
          f"{abs(f32['loss_diff']) / (TRAIN_F32_TOL['loss_rel'] * abs(ref)):.3f}),"
          f" worst gradient {f32['worst_leaf']} share_of_tol="
          f"{f32['worst_share'] / TRAIN_F32_TOL['grad']:.3f}; bf16 readings: "
          f"kernel path loss {b16['loss_diff']:+.3e}, worst gradient share "
          f"{b16['worst_share']:.3e} at {b16['worst_leaf']}; plain path in "
          f"bf16 {p16['loss_diff']:+.3e}, {p16['worst_share']:.3e} at "
          f"{p16['worst_leaf']}", flush=True)
    if not (abs(f32["loss_diff"]) <= TRAIN_F32_TOL["loss_rel"] * abs(ref)
            and f32["worst_share"] <= TRAIN_F32_TOL["grad"]):
        raise AssertionError("train-moe: the f32 kernel path disagrees with "
                             "the plain path")
    step = {k: n for k, n in TRAIN_LAUNCHES.items()}
    for label in ("kernel_f32", "kernel_bf16"):
        expect_launches(f"train-moe correctness {label}", c[label]["launches"],
                        step)
    if c["plain_bf16"]["launches"]:
        raise AssertionError(f"train-moe: the plain path launched "
                             f"{c['plain_bf16']['launches']}")
    losses = arm["losses"]
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"train-moe: losses {losses}")
    expect_launches("train-moe", arm["launches"],
                    {k: n * ARM_TIMED_STEPS for k, n in step.items()})
    T, k = arm["tokens"], MOE_CFG["moe_top_k"]
    if not arm["drop_kept"] or not all(n < T * k and n <= MOE_CFG[
            "n_experts"] * arm["drop_capacity"] for n in arm["drop_kept"]):
        raise AssertionError(f"train-moe: at capacity factor {MOE_DROP_CF} "
                             f"the dispatch kept {arm['drop_kept']} of "
                             f"{T * k} assignments")
    metrics = {"cell": "gpt2-train-moe", "card": card(),
               "batch": [MOE_B, TRAIN_S], **MOE_CFG,
               "step_ms": arm["step_ms"],
               "median_step_ms": arm["median_step_ms"],
               "step_walls_ms": arm["step_walls_ms"],
               "tokens_per_s": arm["tokens"] * 1e3 / arm["step_ms"],
               "peak_gib": arm["peak_gib"], "losses": losses,
               "capacity": arm["capacity"],
               "dispatch_bytes": arm["dispatch_bytes"],
               "drop_capacity": arm["drop_capacity"],
               "drop_kept_per_layer": arm["drop_kept"],
               "assignments": T * k, "correctness": c}
    print(f"train-moe: {len(losses)} steps, loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}; launches exact; at capacity factor "
          f"{MOE_DROP_CF} each layer kept {min(arm['drop_kept'])}-"
          f"{max(arm['drop_kept'])} of {T * k} assignments", flush=True)
    print("train-moe metrics " + json.dumps(metrics), flush=True)
    return {"train_moe": arm["launches"]}


# gpt2-multi-gpu (``--multi-gpu``, four cards of one host): the pipeline
# and experts across real NCCL ranks, which a world of 1 cannot reach:
# GPT-2 124M's widths at 4 layers in f32 (the kernels' f32 builds), batch
# 8 x 1024 from the driver's seeds, each rank's loss and gathered
# gradients against the single-process step (``build_gpt_train`` with no
# mesh) on its own card: the pipeline's stage transfers (GPipe and 1F1B
# over pp, 1F1B over dcn, with dp, fsdp and tp inside the stages, GPipe
# and 1F1B over pp with each stage's sequence over sp), the MoE step (8
# experts, capacity factor 0.5, tokens dropped) over dp, ep and tp, and
# adapter-only training on {fsdp 2, tp 2} (MULTI_LORA; in f32, so its
# loss is held to the f32 bound, tighter than the bf16 gates; the base
# bit-unchanged, every B moved, the adapter bit-equal on every rank).
# Bounds: TRAIN_F32_TOL (summation order only).
MULTI_WORLD = 4
MULTI_LAYERS = 4
MULTI_B = 8
MULTI_PP_CASES = [("pp4-gpipe", dict(pp=4), "gpipe"),
                  ("pp4-1f1b", dict(pp=4), "1f1b"),
                  ("pp2-dp2-1f1b", dict(pp=2, dp=2), "1f1b"),
                  ("pp2-tp2-gpipe", dict(pp=2, tp=2), "gpipe"),
                  ("dcn2-fsdp2-1f1b", dict(dcn=2, fsdp=2), "1f1b"),
                  # each stage's sequence over sp (ring attention)
                  ("pp2-sp2-gpipe", dict(pp=2, sp=2), "gpipe"),
                  ("pp2-sp2-1f1b", dict(pp=2, sp=2), "1f1b")]
# adapter-only training over the frozen base sharded on {fsdp 2, tp 2}:
# rank 16 on every target; the gradients of a random-B adapter and
# MULTI_LORA_STEPS steps from the standard init against one process's
MULTI_LORA = ("lora-fsdp2-tp2", dict(fsdp=2, tp=2))
MULTI_LORA_RANK = 16
MULTI_LORA_STEPS = 3
MULTI_MOE_CASES = [("moe-dp4", dict(dp=4)), ("moe-ep4", dict(ep=4)),
                   ("moe-dp2-ep2", dict(dp=2, ep=2)),
                   ("moe-ep2-tp2", dict(ep=2, tp=2))]
MULTI_CALLS = 5
# the elastic loop over the four ranks: {fsdp 4} -> {fsdp 2} (the first
# two ranks, accum_steps 2) -> {fsdp 4} under this plan, against the
# uninterrupted 4-rank run, in f32 with plain SGD (the reference test's
# optimizer, so the losses test the data and state movement); losses
# within the reference test's rel=1e-4, abs=1e-5
ELASTIC_STEPS = 8
ELASTIC_PLAN = "mesh.loss@3,mesh.restore@6"
ELASTIC_TOL = dict(rel=1e-4, abs=1e-5)


class PlainSGD:
    """``optax.sgd(lr)`` on the port's tensors, in place."""

    def __init__(self, lr: float = 1e-2):
        self.lr = lr

    def init(self, params):
        return None

    @torch.no_grad()
    def update(self, grads, state, params, g_norm=None):
        from ray_tpu_torch.models.training import _leaves
        for p, g in zip(_leaves(params), _leaves(grads)):
            p.copy_(p + (-self.lr) * g)
        return state


def _multi_gpu_rank(rank: int, store: str, out: str,
                    device_type: str = "cuda") -> None:
    """One rank of gpt2-multi-gpu: every case in turn on this rank's
    card (NCCL; ``device_type="cpu"`` runs the same on gloo, for a
    rehearsal); rank 0 writes the results to ``out`` as JSON."""
    import torch.distributed as dist

    from ray_tpu_torch import GPTConfig, init_params
    from ray_tpu_torch.convert import fold_stages
    from ray_tpu_torch.models.gpt import param_logical_axes
    from ray_tpu_torch.models.training import (build_gpt_train,
                                               build_gpt_train_pp,
                                               synthetic_lm_batch)
    from ray_tpu_torch.parallel import sharding
    from ray_tpu_torch.parallel.mesh import make_mesh

    cuda = device_type == "cuda"
    if cuda:
        torch.cuda.set_device(rank)
        torch_flags()
    dev = torch.device(device_type, rank if cuda else None)
    dist.init_process_group("nccl" if cuda else "gloo",
                            store=dist.FileStore(store, MULTI_WORLD),
                            rank=rank, world_size=MULTI_WORLD)
    base = dataclasses.replace(
        GPTConfig.gpt2(**TRAIN_CFG, dtype=torch.float32),
        n_layers=MULTI_LAYERS)
    batch = synthetic_lm_batch(torch.Generator().manual_seed(1), MULTI_B,
                               TRAIN_S, base.vocab_size, device=dev)

    def clone(tree):
        return {k: clone(v) if isinstance(v, dict) else v.clone()
                for k, v in tree.items()}

    def compare(cfg, loss, grads, full_params):
        ref = build_gpt_train(cfg, device=dev, telemetry=False)
        want_loss, want = ref["value_and_grad_fn"](full_params, batch)
        shares = {k: ((g.float() - w.float()).abs().max()
                      / w.float().abs().max()).item()
                  for (k, g), w in zip(_flat_tree(grads).items(),
                                       _flat_tree(want).values())}
        worst = max(shares, key=shares.get)
        return {"loss": float(loss), "ref_loss": float(want_loss),
                "loss_rel": abs(float(loss) - float(want_loss))
                / abs(float(want_loss)),
                "worst_share": shares[worst], "worst_leaf": worst}

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def timed(fn) -> float:
        walls = []
        for _ in range(MULTI_CALLS + 1):
            dist.barrier()
            sync()
            t = time.monotonic()
            fn()
            sync()
            walls.append(1e3 * (time.monotonic() - t))
        return float(np.median(walls[1:]))

    from ray_tpu_torch.ops import _build

    results = {}
    full = init_params(base, torch.Generator().manual_seed(0), device=dev)
    for name, axes, schedule in MULTI_PP_CASES:
        _build.reset_launches()
        mesh = make_mesh(**axes)
        fns = build_gpt_train_pp(base, mesh, num_microbatches=4,
                                 schedule=schedule, device=dev,
                                 telemetry=False)
        state = fns["init_fn"](params=clone(full))
        local = fns["shard_batch"](batch)
        loss, grads = fns["value_and_grad_fn"](state.params, local)
        gathered = fold_stages(fns["gather_params"](grads))
        results[name] = compare(base, loss, gathered, full)
        results[name]["ms"] = timed(
            lambda: fns["value_and_grad_fn"](state.params, local))
        results[name]["launches"] = _nonzero(_build.launch_counts())
        del fns, state, grads, gathered
    moe_cfg = dataclasses.replace(base, moe_capacity_factor=MOE_DROP_CF,
                                  **{k: v for k, v in MOE_CFG.items()
                                     if k != "moe_capacity_factor"})
    moe_full = init_params(moe_cfg, torch.Generator().manual_seed(0),
                           device=dev)
    for name, axes in MULTI_MOE_CASES:
        _build.reset_launches()
        mesh = make_mesh(**axes)
        fns = build_gpt_train(moe_cfg, mesh, device=dev, telemetry=False)
        state = fns["init_fn"](params=clone(moe_full))
        local = fns["shard_batch"](batch)
        loss, grads = fns["value_and_grad_fn"](state.params, local)
        gathered = sharding.gather_params(grads, mesh,
                                          param_logical_axes(moe_cfg))
        results[name] = compare(moe_cfg, loss, gathered, moe_full)
        results[name]["ms"] = timed(
            lambda: fns["value_and_grad_fn"](state.params, local))
        results[name]["launches"] = _nonzero(_build.launch_counts())
        del fns, state, grads, gathered
    _build.reset_launches()
    results[MULTI_LORA[0]] = _multi_lora_case(base, full, batch, dev)
    results[MULTI_LORA[0]]["launches"] = _nonzero(_build.launch_counts())
    results["elastic"] = _elastic_case(base, full, dev)
    if rank == 0:
        with open(out, "w") as f:
            json.dump(results, f)
    dist.destroy_process_group()


def _multi_lora_case(cfg, full, batch, dev) -> dict:
    """MULTI_LORA on this world against one process on the same global
    batch: the loss and every factor's gradient of a random-B adapter
    (``value_and_grad_fn``), then MULTI_LORA_STEPS steps from the
    standard init (B zero); the trained adapter's spread over the ranks,
    the smallest change of a B factor and the base's largest change."""
    import torch.distributed as dist

    from ray_tpu_torch.adapters import ALL_TARGETS, LoraConfig
    from ray_tpu_torch.adapters.lora import init_adapter
    from ray_tpu_torch.models.training import (_leaves, _path_order,
                                               build_gpt_train,
                                               default_optimizer)
    from ray_tpu_torch.parallel.mesh import make_mesh
    lcfg = LoraConfig(enabled=True, rank=MULTI_LORA_RANK,
                      targets=ALL_TARGETS)
    snapshot = [t.clone() for t in _leaves(full)]
    start = init_adapter(cfg, lcfg, torch.Generator().manual_seed(5),
                         device=dev)
    probe = init_adapter(cfg, lcfg, torch.Generator().manual_seed(6),
                         random_b=True, device=dev)

    def build(mesh):
        fns = build_gpt_train(cfg, mesh,
                              optimizer=default_optimizer(**TRAIN_OPT),
                              device=dev, telemetry=False, lora=lcfg,
                              base_params=full)
        return fns, (fns["shard_batch"](batch) if mesh is not None
                     else batch)

    def run(mesh):
        fns, local = build(mesh)
        loss, grads = fns["value_and_grad_fn"](
            fns["init_fn"](params=probe).params, local)
        state = fns["init_fn"](params=start)
        losses = []
        for _ in range(MULTI_LORA_STEPS):
            state, m = fns["step_fn"](state, local)
            losses.append(float(m["loss"]))
        return float(loss), grads, losses, state.params

    ref_loss, ref_grads, ref_losses, _p = run(None)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.monotonic()
    loss, grads, losses, trained = run(make_mesh(**MULTI_LORA[1]))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    ms = 1e3 * (time.monotonic() - t0)
    shares = {k: float((grads[k] - ref_grads[k]).abs().max()
                       / ref_grads[k].abs().max()) for k in ref_grads}
    worst = max(shares, key=shares.get)
    leaves = _leaves(trained)
    flat = torch.cat([leaves[i].reshape(-1) for i in _path_order(trained)])
    every = [torch.empty_like(flat) for _ in range(MULTI_WORLD)]
    dist.all_gather(every, flat)
    rel = max(abs(a - b) / abs(b) for a, b in
              zip([loss] + losses, [ref_loss] + ref_losses))
    return {"loss": loss, "ref_loss": ref_loss, "loss_rel": rel,
            "worst_share": shares[worst], "worst_leaf": worst,
            "losses": losses, "ref_losses": ref_losses, "ms": ms,
            "rank_spread": max(float((e - every[0]).abs().max())
                               for e in every),
            "b_moved_min": min(float((trained[k] - start[k]).abs().max())
                               for k in trained if k.endswith("_b")),
            "base_moved": max(float((a - b).abs().max()) for a, b in
                              zip(_leaves(full), snapshot))}


def _elastic_case(cfg, full, dev) -> dict:
    """The elastic loop (``resilience.run_elastic_train_loop``) on this
    world, uninterrupted and under ELASTIC_PLAN, from the same
    parameters and batches."""
    from ray_tpu_torch.resilience import run_elastic_train_loop
    from ray_tpu_torch.util import chaos
    kw = dict(steps=ELASTIC_STEPS, batch_size=MULTI_B, seq_len=TRAIN_S,
              params=full, optimizer=PlainSGD(), device=dev,
              topologies={}, telemetry=True)
    base = run_elastic_train_loop(cfg, **kw)
    plan = chaos.install_faults(ELASTIC_PLAN)
    t0 = time.monotonic()
    rec = run_elastic_train_loop(cfg, **kw)
    wall = time.monotonic() - t0
    chaos.clear_faults()
    # (a rank outside the shrunk mesh has no loss for its steps)
    rel = max(abs(a - b) / max(abs(b), 1e-30)
              for a, b in zip(rec["losses"], base["losses"])
              if a is not None)
    return {"losses": rec["losses"], "base_losses": base["losses"],
            "batch_cursors": rec["batch_cursors"],
            "base_cursors": base["batch_cursors"],
            "fired": [f[0] for f in plan.fired],
            "transitions": rec["transitions"],
            "accum_steps": rec["accum_steps"],
            "final_devices": rec["final_devices"],
            "max_loss_rel": rel, "seconds": wall,
            "elastic": rec["elastic"]}


def multi_gpu_phase() -> dict:
    """gpt2-multi-gpu on MULTI_WORLD cards (``_multi_gpu_rank``): every
    case's loss within TRAIN_F32_TOL's relative bound and every gradient
    leaf within its share of the single-process step's; prints
    ``multi-gpu metrics {...}`` (each case's ms a ``value_and_grad``,
    the median of MULTI_CALLS after one)."""
    import tempfile

    import torch.multiprocessing as mp

    import chip_smoke
    if torch.cuda.device_count() < MULTI_WORLD:
        raise AssertionError(f"--multi-gpu needs {MULTI_WORLD} cards, "
                             f"found {torch.cuda.device_count()}")
    tmp = tempfile.mkdtemp(prefix="gpt2_multi_gpu_")
    out = os.path.join(tmp, "results.json")
    t0 = time.monotonic()
    mp.start_processes(chip_smoke._multi_gpu_rank,
                       args=(os.path.join(tmp, "store"), out),
                       nprocs=MULTI_WORLD, join=True, start_method="spawn")
    with open(out) as f:
        results = json.load(f)
    elastic = results.pop("elastic")
    for name, r in results.items():
        print(f"multi-gpu {name}: loss {r['loss']:.6f} vs single process "
              f"{r['ref_loss']:.6f} (relative {r['loss_rel']:.3e}), worst "
              f"gradient share {r['worst_share']:.3e} at {r['worst_leaf']}; "
              f"{r['ms']:.2f} ms a value_and_grad; rank 0's launches "
              f"{r['launches']}", flush=True)
        if not (r["loss_rel"] <= TRAIN_F32_TOL["loss_rel"]
                and r["worst_share"] <= TRAIN_F32_TOL["grad"]):
            raise AssertionError(f"multi-gpu {name}: parts from the "
                                 "single-process step")
    lora = results[MULTI_LORA[0]]
    print(f"multi-gpu {MULTI_LORA[0]}: {MULTI_LORA_STEPS} steps' losses "
          f"{lora['losses']} vs one process's {lora['ref_losses']}; the "
          f"adapter's spread over the ranks {lora['rank_spread']}, the "
          f"smallest B change {lora['b_moved_min']:.3e}, the base's "
          f"largest change {lora['base_moved']}", flush=True)
    if not (lora["rank_spread"] == 0.0 and lora["b_moved_min"] > 0
            and lora["base_moved"] == 0.0):
        raise AssertionError(f"multi-gpu {MULTI_LORA[0]}: {lora}")
    moves = [(t["kind"], t["from"], t["to"]) for t in elastic["transitions"]]
    print(f"multi-gpu elastic: {moves}, accum_steps back to "
          f"{elastic['accum_steps']}; losses {elastic['losses']} vs "
          f"uninterrupted {elastic['base_losses']} (worst relative "
          f"{elastic['max_loss_rel']:.3e})", flush=True)
    if not (moves == [("shrink", 4, 2), ("expand", 2, 4)]
            and elastic["batch_cursors"] == elastic["base_cursors"]
            and elastic["accum_steps"] == 1
            and all(abs(a - b) <= max(ELASTIC_TOL["abs"],
                                      ELASTIC_TOL["rel"] * abs(b))
                    for a, b in zip(elastic["losses"],
                                    elastic["base_losses"]))):
        raise AssertionError(f"multi-gpu elastic loop: {elastic}")
    metrics = {"cell": "gpt2-multi-gpu", "cards": MULTI_WORLD,
               "card": card(), "batch": [MULTI_B, TRAIN_S],
               "seconds": time.monotonic() - t0, "cases": results,
               "elastic": elastic}
    print("multi-gpu metrics " + json.dumps(metrics), flush=True)
    return metrics


# the int8 wire's codec (parallel/overlap.py's quant_all_gather_start and
# quant_psum run it; plain PyTorch, as the reference's is plain XLA): the
# unbiasedness bound of tests/test_quant.py:89-107 (the mean of 512 draws
# of a [4, 64] block within 0.08 of a step), and the timed calls
CODEC_DRAWS = 512
CODEC_MEAN_TOL = 0.08
CODEC_TREE_ITERS = 5


def _wire_leaves(cfg, params) -> dict:
    """The leaves the fsdp gathers quantize, in ``overlap._to2d``
    layout: the embedding and each layer's slice of every stacked weight
    with an ``embed_fsdp`` dimension, that dimension first and the rest
    flattened."""
    from ray_tpu_torch.models.gpt import param_logical_axes
    from ray_tpu_torch.parallel import overlap
    axes = param_logical_axes(cfg)
    out = {"embed": overlap._to2d(params["embed"],
                                  axes["embed"].index("embed_fsdp"))[0]}
    for k in sorted(params["layers"]):
        lax_ = axes["layers"][k]
        if "embed_fsdp" not in lax_:
            continue
        for i in range(cfg.n_layers):
            out[f"layers/{k}[{i}]"] = overlap._to2d(
                params["layers"][k][i], lax_.index("embed_fsdp") - 1)[0]
    return out


def wire_codec_phase(dev) -> dict:
    """The int8 wire's codec on the card, over GPT-2 124M's bf16 tree from
    seed 0 in the fsdp gathers' layout (``_wire_leaves``): nearest-mode
    codes and scales bit-equal to the CPU's on every leaf; one stochastic
    draw from a device generator within one step of its input on the
    largest leaf (the embedding, 768 x 50,304 in that layout);
    CODEC_DRAWS draws of a [4, 64] block with a mean within
    CODEC_MEAN_TOL of a step; the tree's wire bytes (int8 codes and one
    f32 scale a WIRE_BLOCK) equal to ``collective_bytes_per_step``'s
    payload.  Times (``time_ms``) a nearest and a stochastic quantize +
    dequantize of the largest leaf and of the whole tree; GB/s is the
    bf16 bytes coded over that time.  Prints ``wire-codec metrics
    {...}``."""
    from ray_tpu_torch import GPTConfig, init_params
    from ray_tpu_torch.parallel import overlap
    from ray_tpu_torch.parallel.mesh import MeshSpec
    from ray_tpu_torch.quant import (INT8_MAX, dequantize_block,
                                     quantize_block, stochastic_generator,
                                     wire_bytes)
    B = overlap.WIRE_BLOCK
    cfg = GPTConfig.gpt2(**TRAIN_CFG, dtype=torch.bfloat16)
    leaves = _wire_leaves(cfg, init_params(
        cfg, torch.Generator().manual_seed(0), device=dev))
    for k, x in leaves.items():
        q, sc = quantize_block(x.float(), block=B, mode="nearest")
        cq, cs = quantize_block(x.cpu().float(), block=B, mode="nearest")
        bad_q = int((q.cpu() != cq).sum())
        bad_s = int((sc.cpu().view(torch.int32) != cs.view(torch.int32))
                    .sum())
        if bad_q or bad_s:
            raise AssertionError(f"wire codec: {k}: {bad_q} codes and "
                                 f"{bad_s} scales differ from the CPU's")
    big = leaves["embed"]
    gen = stochastic_generator(1, 0, dev)
    q, sc = quantize_block(big.float(), block=B, mode="stochastic",
                           generator=gen)
    back = dequantize_block(q, sc, block=B)
    step = torch.repeat_interleave(sc, B, dim=-1)[:, :big.shape[1]]
    one_err = ((back - big.float()).abs() / step.clamp_min(1e-30)).max()
    if not one_err.item() <= 1 + 1e-6:
        raise AssertionError(f"wire codec: a stochastic draw moved a value "
                             f"by {one_err.item():.4f} steps")
    x = torch.randn(4, 64, generator=torch.Generator().manual_seed(0)).to(dev)
    g64 = stochastic_generator(5, 0, dev)
    mean = torch.stack([dequantize_block(*quantize_block(
        x, block=64, mode="stochastic", generator=g64), block=64)
        for _ in range(CODEC_DRAWS)]).mean(0)
    scale = x.abs().amax(-1, keepdim=True) / INT8_MAX
    mean_err = ((mean - x).abs().max() / scale.max()).item()
    if not mean_err <= CODEC_MEAN_TOL:
        raise AssertionError(f"wire codec: the mean of {CODEC_DRAWS} draws "
                             f"is {mean_err:.4f} steps from its input")
    wire = sum(t.shape[0] * wire_bytes(t.shape[1], block=B)
               for t in leaves.values())
    bf16 = sum(2 * t.numel() for t in leaves.values())
    cb = overlap.collective_bytes_per_step(
        cfg, MeshSpec.create(fsdp=2), batch=TRAIN_B, seq=TRAIN_S,
        comm_mode="overlap", quant="int8")
    if wire != 2 * cb["ici"]["weight_allgather"]["bytes"]:
        raise AssertionError(f"wire codec: {wire} wire bytes, the "
                             f"accounting's {cb['ici']['weight_allgather']}")

    def codec(t, mode, g=None):
        qq, ss = quantize_block(t.float(), block=B, mode=mode, generator=g)
        return dequantize_block(qq, ss, block=B, dtype=t.dtype)

    def tree(mode, g=None):
        for t in leaves.values():
            codec(t, mode, g)

    times = {"largest_nearest_ms": time_ms(lambda: codec(big, "nearest")),
             "largest_stochastic_ms": time_ms(
                 lambda: codec(big, "stochastic", gen)),
             "tree_nearest_ms": time_ms(lambda: tree("nearest"),
                                        iters=CODEC_TREE_ITERS),
             "tree_stochastic_ms": time_ms(lambda: tree("stochastic", gen),
                                           iters=CODEC_TREE_ITERS)}
    big_bytes = 2 * big.numel()
    out = {"cell": "gpt2-wire-codec", "card": card(),
           "leaves": len(leaves), "largest": list(big.shape),
           "tree_elements": sum(t.numel() for t in leaves.values()),
           "tree_bf16_bytes": bf16, "tree_wire_bytes": wire,
           "wire_vs_bf16": wire / bf16,
           "stochastic_max_steps": one_err.item(),
           "mean_of_draws_steps": mean_err, **times,
           **{k.replace("_ms", "_gbps"): (
               big_bytes if k.startswith("largest") else bf16) / (v * 1e6)
              for k, v in times.items()}}
    print(f"wire codec: {len(leaves)} leaves' nearest codes and scales "
          "bit-equal to the CPU's; a stochastic draw within "
          f"{one_err.item():.4f} steps; the mean of {CODEC_DRAWS} draws "
          f"within {mean_err:.4f} steps (bound {CODEC_MEAN_TOL})",
          flush=True)
    print("wire-codec metrics " + json.dumps(out), flush=True)
    return out


# One step's loss and gradients, kernel path against the port's plain
# path (local attention with RoPE outside, unfused epilogue, dense CE) on
# the same f32 weights and batch, at full width and depth.
# - f32 against f32: summation order only.  The loss within 1e-5 of
#   itself; each gradient leaf within 1e-4 of its own largest value (the
#   JAX suite's grad bound, tests/test_models.py:177, which the CPU tests
#   hold at 2 layers).
# - bf16 kernel path against the f32 plain path: bf16 weights and
#   activations through 12 layers.  Sound runs on an H100 read a loss
#   difference of 9.0e-5 and a worst gradient error of 3.1e-2 of its
#   leaf's largest value (layers/wq; PERF.md section 2); the bounds are
#   about twice those.
TRAIN_F32_TOL = dict(loss_rel=1e-5, grad=1e-4)
TRAIN_BF16_TOL = dict(loss_abs=2e-4, grad=0.06)
# The width checks (``width_checks``: gpt2_medium, gpt2_large and tiny at
# 2 layers, two seeds) hold the f32 step and every gradient to the bounds
# above.  Their bf16 loss is held to TRAIN_BF16_TOL's 2e-4 over and above
# the distance from the f32 plain path of the same configuration's plain
# path in bf16, which runs no kernel, measured beside it: at 2 layers the
# bf16 rounding of weights and activations alone moves the loss by more
# than 2e-4.  Over these 6 configurations and gpt2's at seed 7 (PERF.md
# section 2) the plain path in bf16 read up to 3.5e-4 from f32, the plain
# path in f32 on the bf16-rounded weights up to 3.0e-4, the kernel path
# with attention in f32 (rounded once) up to 3.9e-4; the kernel path
# itself up to 2.2e-4.  Each run prints those readings ("bf16
# readings").  gpt2 keeps the plain 2e-4.
def step_launches(cfg, *, norm_kernel: bool, ce_mode) -> dict:
    """The launches of one loss-and-gradient step of ``cfg`` on the
    kernel path, from the gates' verdicts at its width: per layer the
    attention pair and, where d is lane-aligned, the epilogue pair; one
    flash-CE pair where it takes the loss; with ``norm_kernel`` one
    RMSNorm pair for each norm neither fuses (ln1; ln2 where the epilogue
    declines; ln_f where flash-CE does)."""
    L, d = cfg.n_layers, cfg.d_model
    epi = d % 128 == 0                   # fused_norm.supports, K = d
    ce = d % 128 == 0 and ce_mode is None
    n = {"flash_attention_fwd": L, "flash_attention_bwd": L}
    if epi:
        n.update(matmul_residual_norm_fwd=L, matmul_residual_norm_bwd=L)
    if ce:
        n.update(flash_ce_fwd=1, flash_ce_bwd=1)
    if norm_kernel:
        norms = L + (0 if epi else L) + (0 if ce else 1)
        n.update(rmsnorm_fwd=norms, rmsnorm_bwd=norms)
    return n


# the fused-CE arm's gradients against the f32 plain path: the bf16
# bound; its loss within FUSED_LOSS_TOL (the logits rounded to bf16)
TRAIN_FUSED_TOL = dict(loss_abs=FUSED_LOSS_TOL, grad=TRAIN_BF16_TOL["grad"])


def train_correctness_phase(dev, *, n_layers: int = 12,
                            norm_kernel: bool = False,
                            preset: str = "gpt2", seed: int = 2,
                            fused_ce: bool = False) -> None:
    """The step parity above at ``n_layers``; with ``norm_kernel`` the
    kernel path's RMSNorms go through the RMSNorm kernels while the plain
    path keeps its plain norms.  ``preset`` names the ``GPTConfig``
    preset: ``gpt2_medium`` and ``gpt2_large`` (d = 1024, 1280) and
    ``tiny`` (d = 64, head_dim 16; at its own vocab and 128 positions)
    run the kernels built for their widths.  Each kernel run launches
    exactly ``step_launches``.  The f32 flash-CE kernels are built for
    d = 768 only, so a wider f32 model asks for the dense CE itself
    (``ce_mode="xla"``; its gate would raise, ROADMAP Queue 2 item A).
    ``fused_ce`` adds a bf16 run with ``ce_mode="fused"`` (the
    bf16-resident CE, no flash-CE launch) under TRAIN_FUSED_TOL."""
    from ray_tpu_torch import GPTConfig, init_params
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.models.training import (synthetic_lm_batch,
                                               value_and_grad)
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops import flash_ce as FC
    from ray_tpu_torch.ops.attention import make_flash_attention_fn
    from ray_tpu_torch.parallel.ring_attention import local_attention

    kw = dict(TRAIN_CFG, dtype=torch.float32)
    if preset == "tiny":
        kw.update(vocab_size=512, max_seq=128)
    cfg32 = dataclasses.replace(getattr(GPTConfig, preset)(**kw),
                                n_layers=n_layers)
    cfg16 = dataclasses.replace(cfg32, dtype=torch.bfloat16)
    params = init_params(cfg32, torch.Generator().manual_seed(seed),
                         device=dev)
    batch = synthetic_lm_batch(torch.Generator().manual_seed(seed + 1), 2,
                               cfg32.max_seq, cfg32.vocab_size, device=dev)
    attn = make_flash_attention_fn(rope_theta=cfg32.rope_theta)

    def ce_mode(cfg):
        d = cfg.d_model
        built = FC._KERNEL_WIDTHS[cfg.dtype]
        return "xla" if d % 128 == 0 and d not in built else None

    def plain_loss(cfg):
        return lambda p, b: gpt.loss_fn(p, b, cfg, fuse_norm=False,
                                        ce_mode="xla")

    def leaves(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, prefix + k + "/")
            else:
                yield prefix + k, v

    def to(tree, dtype):
        return {k: to(v, dtype) if isinstance(v, dict) else v.to(dtype)
                for k, v in tree.items()}

    ref_loss, ref_grads = value_and_grad(plain_loss(cfg32), params, batch)
    ref = dict(leaves(ref_grads))
    runs = [("f32", cfg32, params, TRAIN_F32_TOL, ce_mode(cfg32)),
            ("bf16", cfg16, to(params, torch.bfloat16), TRAIN_BF16_TOL,
             ce_mode(cfg16))]
    if fused_ce:
        runs.append(("bf16 fused CE", cfg16, runs[1][2], TRAIN_FUSED_TOL,
                     "fused"))
    for label, cfg, p, tol, ce in runs:
        want_n = step_launches(cfg, norm_kernel=norm_kernel, ce_mode=ce)
        gpt._PALLAS_NORM = norm_kernel
        try:
            _build.reset_launches()
            loss, grads = value_and_grad(
                lambda p_, b_: gpt.loss_fn(p_, b_, cfg, attn_fn=attn,
                                           ce_mode=ce), p, batch)
            torch.cuda.synchronize()
            launches = _build.launch_counts()
            if label == "bf16" and n_layers == 2:
                with torch.no_grad():
                    # the kernel path with the plain attention in bf16,
                    # and with attention in f32 rounded once, in place
                    # of the attention kernels
                    no_attn = float(gpt.loss_fn(p, batch, cfg, ce_mode=ce))
                    f32_attn = float(gpt.loss_fn(
                        p, batch, cfg, ce_mode=ce,
                        attn_fn=lambda q, k, v: local_attention(
                            q.float(), k.float(), v.float(),
                            causal=True).to(q.dtype)))
        finally:
            gpt._PALLAS_NORM = False
        if norm_kernel:
            label = f"{label} norm kernel, {n_layers} layers"
        if preset != "gpt2":
            label = f"{label}, {preset}"
        expect_launches(f"train correctness {label}", launches, want_n)
        dl = abs(float(loss) - float(ref_loss))
        lim = (tol["loss_rel"] * abs(float(ref_loss)) if "loss_rel" in tol
               else tol["loss_abs"])
        if "loss_abs" in tol and n_layers == 2:
            with torch.no_grad():
                plain16 = float(plain_loss(cfg)(p, batch))
                plain32w = float(plain_loss(cfg32)(to(p, torch.float32),
                                                   batch))
            ref_f = float(ref_loss)
            if preset != "gpt2":
                lim += abs(plain16 - ref_f)   # see the width checks above
            print(f"  bf16 readings {preset}, loss minus the f32 plain "
                  f"path's: kernel path {float(loss) - ref_f:+.3e}, with "
                  f"plain attention {no_attn - ref_f:+.3e}, with f32 "
                  f"attention {f32_attn - ref_f:+.3e}, plain path in "
                  f"bf16 {plain16 - ref_f:+.3e}, plain path in f32 on the "
                  f"bf16 weights {plain32w - ref_f:+.3e}", flush=True)
        worst_share, worst = 0.0, ""
        for name, gr in leaves(grads):
            want = ref[name].float()
            err = (gr.float() - want).abs().max().item()
            share = err / (tol["grad"] * want.abs().max().item() + 1e-30)
            if not math.isfinite(share) or share > worst_share:
                worst_share, worst = share, name
        print(f"train correctness {label}: loss {float(loss):.6f} vs plain "
              f"f32 {float(ref_loss):.6f} (|diff| {dl:.3e}, "
              f"share_of_tol={dl / lim:.3f}); worst gradient {worst} "
              f"share_of_tol={worst_share:.3f} (bound {tol['grad']} of "
              f"each leaf's largest value); launches {launches_line(launches)}"
              + ("" if ce is None else f"; ce_mode={ce!r}"),
              flush=True)
        if not dl <= lim or not worst_share <= 1:
            raise AssertionError(f"training step {label}: kernel path "
                                 "disagrees with the plain path")
        del grads
        torch.cuda.empty_cache()


def launches_line(launches: dict) -> str:
    return json.dumps({k: n for k, n in launches.items() if n})


def width_checks(dev) -> None:
    """The kernels at the widths of the other configurations the repo
    supports (``width_kernel_checks``), then a 2-layer ``gpt2_medium``,
    ``gpt2_large`` and ``GPTConfig.tiny()`` on the card at two seeds,
    every gate reached with the RMSNorm kernels on: one step's loss and
    gradients against the plain path at the step-parity tolerances (the
    bf16 loss as the note above the width checks sets out), each kernel the
    width is built for launched exactly as ``step_launches`` says, no
    tensor of the card sent to a plain version in a kernel's place.
    tiny's d = 64 is declined by the epilogue and flash-CE gates as by the
    JAX package's (not lane-aligned): its ln2 and ln_f take the RMSNorm
    kernels instead."""
    width_kernel_checks(dev)
    for seed in (2, 7):
        for preset in ("gpt2_medium", "gpt2_large", "tiny"):
            train_correctness_phase(dev, n_layers=2, norm_kernel=True,
                                    preset=preset, seed=seed)
    # gpt2's 2-layer step at the second seed (the main run holds seed 2)
    train_correctness_phase(dev, n_layers=2, norm_kernel=True, seed=7)


class PhaseClock:
    """Prints each phase's seconds of the main run as it ends, and the
    list of them at the end (``phase seconds {...}``)."""

    def __init__(self):
        self.last = self.start = time.monotonic()
        self.seconds = {}

    def lap(self, phase: str) -> None:
        now = time.monotonic()
        self.seconds[phase] = round(now - self.last, 2)
        self.last = now
        print(f"phase {phase}: {self.seconds[phase]:.2f} s", flush=True)

    def report(self) -> None:
        print("phase seconds " + json.dumps(dict(
            self.seconds, total=round(self.last - self.start, 2))),
              flush=True)


def start_up() -> str:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        sys.exit(2)
    name = card()
    print(name, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    torch_flags()
    from ray_tpu_torch.ops import _build
    t0 = time.monotonic()
    lib = _build.build()
    print(f"built {lib.name} in {time.monotonic() - t0:.1f} s", flush=True)
    # one line per compiled kernel: name, registers, spills
    fn, spill = "", ""
    for line in _build.build_log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"\d+([a-z_]+_kernel)I(.*?)EEv", line)
            if m is None:
                fn = line.split("'")[1][-60:]
                continue
            args = re.sub(r"^f", "f32,", m.group(2))
            args = re.sub(r"Li(\d+)E?", r"\1,", args)
            args = re.sub(r"Lb([01])E?", lambda b: ("false", "true")[
                int(b.group(1))] + ",", args)
            args = args.replace("13__nv_bfloat16", "bf16,")
            fn = f"{m.group(1)}<{args.strip(',')}>"
        elif "spill stores" in line:
            spill = line.strip()
        elif "registers" in line and fn:
            print(f"  {fn}: {line.split(':', 1)[1].strip()}; {spill}",
                  flush=True)
            fn = ""
    return name


def report(what, prof, wall, steps, top=8, groups=None):
    """The busiest device-side events of a profile (kernels, copies; an
    operator's device time is its kernels', and a ``record_function``
    range's (``spec/...``, ``attn/...``) the span of the kernels inside
    it, both of which would count twice) and the device's busy share of
    the wall time.  ``groups`` (label: name substrings) adds each group's
    device time per step, its kernels listed, and the rest's."""
    evs = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and e.self_device_time_total > 0
           and not e.key.startswith(("spec/", "attn/"))]
    busy = sum(e.self_device_time_total for e in evs) / 1e3
    print(f"profile {what}: wall {1e3 * wall / steps:.3f} ms/step, "
          f"device busy {busy / steps:.3f} ms/step "
          f"({100 * busy / (1e3 * wall):.1f}% of wall)", flush=True)
    for e in sorted(evs, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"  {e.self_device_time_total / 1e3 / steps:8.3f} ms/step"
              f"  {e.count // steps:4d} calls/step  {e.key[:90]}",
              flush=True)
    rest = busy
    for label, keys in (groups or {}).items():
        members = [e for e in evs if any(k in e.key for k in keys)]
        ms = sum(e.self_device_time_total for e in members) / 1e3
        rest -= ms
        calls = sum(e.count for e in members) // steps
        print(f"  group {label}: {ms / steps:.4f} ms/step in {calls} "
              "calls/step", flush=True)
        for e in members:
            print(f"    {e.self_device_time_total / 1e3 / steps:.4f} ms/step "
                  f"{e.count // steps:4d} calls/step  {e.key[:80]}",
                  flush=True)
    if groups:
        print(f"  group rest: {rest / steps:.4f} ms/step", flush=True)


# the decode step's device time split for the decode kernel's PRs: the
# attention kernels, and the index kernels (the context gather of the
# padded layout, write_decode's scatter, the embedding's lookup)
DECODE_GROUPS = {"decode attention": ("decode_",),
                 "index kernels": ("index", "gather", "scatter")}


def profile_phase(params, cfg, dev, *, kv_dtype: str = "model") -> None:
    """Where a prefill tick and a decode step spend their time: the
    busiest kernels by device time (torch.profiler), the device's busy
    share of the wall time, and the decode step split into its layer
    stack and its sampling (host clock around synchronised calls).  The
    tick admits 8 prompts of 512 tokens; on the int8 cache they share a
    512-token system prompt and add 64 tokens each, so one prefills cold
    and 7 prefill their suffix over the cached prefix."""
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch import InferenceEngine

    engine = InferenceEngine(cfg, params, device=dev, kv_dtype=kv_dtype,
                             **ENGINE)
    engine.generate([[1, 2, 3]], max_new_tokens=2)        # warm-up
    rng = np.random.default_rng(2)
    system = rng.integers(0, 50257, SYSTEM_LEN).tolist()
    for _ in range(8):
        engine.submit(system + rng.integers(0, 50257, 64).tolist()
                      if kv_dtype == "int8"
                      else rng.integers(0, 50257, 512).tolist(),
                      max_new_tokens=24)

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.monotonic()
        engine.step()              # 8 prefills + 1 decode
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    report(f"admission tick ({kv_dtype} cache: 8 prefills + 1 decode)",
           prof, wall, 1)
    for _ in range(2):
        engine.step()
    with profile(activities=acts) as prof:
        t0 = time.monotonic()
        for _ in range(8):
            engine.step()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    report("decode step (8 slots)", prof, wall, 8, top=12,
           groups=DECODE_GROUPS)
    # the decode step without the profiler: layers vs sampling
    sched = engine.scheduler
    args = [torch.from_numpy(a).to(dev) for a in (
        np.array([r.generated[-1] for r in sched.active.values()]),
        sched.lengths, sched.page_table)]
    with torch.inference_mode():
        logits = engine._decode_step(*args)
        torch.cuda.synchronize()
        sampling = engine._sampling_inputs(list(sched.active.values()))
        n = 20
        t0 = time.monotonic()
        for _ in range(n):
            engine._decode_step(*args)
        torch.cuda.synchronize()
        t1 = time.monotonic()
        for _ in range(n):
            engine._sample(logits, sampling)
        t2 = time.monotonic()
    print(f"profile decode split: layer stack {1e3 * (t1 - t0) / n:.3f} "
          f"ms, sampling {1e3 * (t2 - t1) / n:.3f} ms", flush=True)


# the verify forward's device time split: ranges around the engine's
# methods (record_function, named "spec/..."; not kernels) and the
# epilogue kernels by name
SPEC_RANGES = {"_verify_step": "spec/verify forward",
               "_cached_layers": "spec/verify layers",
               "_cached_prefill_attention": "spec/verify attention",
               "_sample": "spec/sampling"}
VERIFY_GROUPS = {"epilogue": ("mrn_",),
                 "GEMMs": ("gemm", "xmma", "cutlass", "nvjet"),
                 "index kernels": ("index", "gather", "scatter")}


def _range_methods(engine) -> None:
    """Wrap ``engine``'s methods named in ``SPEC_RANGES`` in a profiler
    range each (on the instance; the class is untouched)."""
    for name, label in SPEC_RANGES.items():
        def ranged(*args, _fn=getattr(engine, name), _label=label, **kw):
            with torch.profiler.record_function(_label):
                return _fn(*args, **kw)
        setattr(engine, name, ranged)


def spec_profile_phase(params, cfg, dev, *, kv_dtype: str = "model"
                       ) -> None:
    """One co-batched decode step and one verify forward of the serving
    geometry (8 slots, page 128; 8 templated requests, spec_k = 4 for
    half of them) under torch.profiler, at a tick where both run: the
    busy share of wall time of each, the decode step split as
    ``--profile`` splits it, and the verify's device time split into the
    epilogue kernels, the verify attention (suffix write, gather,
    dequantize, einsums), the lm-head GEMM (the forward's range minus
    its layer stack's), sampling and the rest."""
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch import InferenceEngine

    engine = InferenceEngine(cfg, params, device=dev, kv_dtype=kv_dtype,
                             **ENGINE)
    engine.generate([[1, 2, 3]], max_new_tokens=2)        # warm-up
    for i, p in enumerate(spec_serving_prompts(cfg.vocab_size)):
        engine.submit(p, max_new_tokens=64,
                      sampling=spec_sampling(None, 4 if i % 2 else 0))
    for _ in range(64):
        plan = engine._plan_speculation()
        if plan and len(plan) < len(engine.scheduler.active) and \
                engine.ticks > 4:
            break
        engine.step()
    else:
        raise AssertionError("no tick had both a verify and a decode")
    _range_methods(engine)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    events = []
    torch.cuda.synchronize()
    with torch.inference_mode():
        with profile(activities=acts) as prof:
            t0 = time.monotonic()
            engine._decode(events, skip=set(plan))
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
        report(f"spec co-batched decode step ({kv_dtype} cache, "
               f"{len(engine.scheduler.active) - len(plan)} live rows, "
               f"{len(plan)} dead)", prof, wall, 1, top=6,
               groups=DECODE_GROUPS)
        (slot, drafts), *rest = plan.items()
        with profile(activities=acts) as prof:
            t0 = time.monotonic()
            engine._verify(slot, drafts, events)
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
        n = engine._verify_bucket(len(drafts)) + 1
        report(f"spec verify forward ({kv_dtype} cache, {len(drafts)} "
               f"drafts, N = {n} rows)", prof, wall, 1, top=8,
               groups=VERIFY_GROUPS)
        for s, d in rest:                      # the rest of the tick
            engine._verify(s, d, events)
    ranges = {label: 0.0 for label in SPEC_RANGES.values()}
    for e in prof.events():
        if e.key in ranges and e.device_type == torch.autograd.DeviceType.CPU:
            ranges[e.key] += e.device_time_total / 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0
               and not e.key.startswith("spec/")]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    epilogue = sum(e.self_device_time_total for e in kernels
                   if "mrn_" in e.key) / 1e3
    attention = ranges["spec/verify attention"]
    lm_head = ranges["spec/verify forward"] - ranges["spec/verify layers"]
    sampling = ranges["spec/sampling"]
    if not all(ranges.values()):
        print(f"profile spec verify split: not measured (a range read no "
              f"device time: {ranges})", flush=True)
        return
    print(f"profile spec verify split ({kv_dtype}): device busy "
          f"{busy:.4f} ms; epilogue {epilogue:.4f}, verify attention "
          f"{attention:.4f}, lm-head GEMM {lm_head:.4f}, sampling "
          f"{sampling:.4f}, rest "
          f"{busy - epilogue - attention - lm_head - sampling:.4f} ms",
          flush=True)


# a training step's device time by kind: the port's hand-written kernels
# and cuBLAS's matmuls (nvjet, cutlass and xmma kernels; the rest:
# PyTorch's elementwise, copy, scan and reduction kernels).  No kernel
# name may match both groups (the port's CE GEMM is "ce_gemm_kernel")
# (flash-CE's kernels are matched after a space or "::": a bare "ce_"
# also matches PyTorch's "reduce_kernel")
TRAIN_GROUPS = {"port kernels": ("flash_", "mrn_", " ce_", "::ce_",
                                 "dscale_sum", "rmsnorm"),
                "cuBLAS": ("nvjet", "cutlass", "xmma")}


def train_profile_phase(dev, cell: str = "gpt2-train-b24") -> None:
    """Where one training step of ``cell`` spends its device time
    (torch.profiler), after two unprofiled steps: gpt2-train-b24,
    gpt2-train-pp-gpipe / -1f1b (``build_gpt_train_pp`` on one stage, M =
    PP_M), gpt2-train-moe (batch MOE_B) or gpt2-train-stream (its first
    packed batch), split by TRAIN_GROUPS."""
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch import GPTConfig
    from ray_tpu_torch.models.training import (build_gpt_train,
                                               build_gpt_train_pp,
                                               default_optimizer,
                                               synthetic_lm_batch)
    from ray_tpu_torch.parallel.mesh import make_mesh

    moe_kw = MOE_CFG if cell == "gpt2-train-moe" else {}
    cfg = GPTConfig.gpt2(**TRAIN_CFG, **moe_kw, dtype=torch.bfloat16)
    opt = default_optimizer(**TRAIN_OPT)
    if cell.startswith("gpt2-train-pp-"):
        fns = build_gpt_train_pp(cfg, make_mesh(pp=1), num_microbatches=PP_M,
                                 schedule=cell.rsplit("-", 1)[1],
                                 optimizer=opt, device=dev, telemetry=False)
    else:
        fns = build_gpt_train(cfg, optimizer=opt, device=dev,
                              telemetry=False)
    state = fns["init_fn"](torch.Generator().manual_seed(0))
    if cell == "gpt2-train-stream":
        batch = stream_packed_batch(dev)
    else:
        batch = synthetic_lm_batch(torch.Generator().manual_seed(1),
                                   MOE_B if moe_kw else TRAIN_B, TRAIN_S,
                                   cfg.vocab_size, device=dev)
    for _ in range(2):
        state, _m = fns["step_fn"](state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        state, _m = fns["step_fn"](state, batch)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    report(f"training step ({cell})", prof, wall, 1, top=20,
           groups=TRAIN_GROUPS)


def epilogue_profile_phase(dev) -> None:
    """The out-proj epilogue's two entry points at the training shape (N =
    24576, K = d = 768, bf16): the CUDA kernels each launches, by device
    time per call (torch.profiler over 10 calls)."""
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch.ops import fused_norm as FN

    g = torch.Generator(device=dev).manual_seed(1)
    randn = _randn(g, dev)
    N, d = TRAIN_N, 768
    a, resid = randn(N, d), randn(N, d)
    w = randn(d, d, s=d ** -0.5)
    sc = (1 + 0.1 * torch.randn(d, generator=g, device=dev)).to(
        torch.bfloat16)
    rout, _y, rstd = FN.matmul_residual_norm_fwd(a, w, resid, sc)
    ins = (a, w, rout, sc, rstd, randn(N, d), randn(N, d))
    for what, fn in (
            ("matmul_residual_norm_fwd",
             lambda: FN.matmul_residual_norm_fwd(a, w, resid, sc)),
            ("matmul_residual_norm_bwd",
             lambda: FN.matmul_residual_norm_bwd(*ins))):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
        report(f"{what} [{N}, {d}, {d}] (per call)", prof, wall, 10)


def ce_profile_phase(dev) -> None:
    """The flash-CE entry points at the training shape (N = 24576, d =
    768, V = 50304, bf16, the norm prologue, one target in seven masked):
    the CUDA kernels each launches, by device time per call
    (torch.profiler over 3 calls)."""
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch.ops import flash_ce as FC

    g = torch.Generator(device=dev).manual_seed(1)
    randn = _randn(g, dev)
    N, d, V, eps = TRAIN_N, 768, TRAIN_V, 1e-6
    x, w = randn(N, d), randn(V, d, s=0.02)
    sc = (1 + 0.1 * torch.randn(d, generator=g, device=dev)).to(
        torch.bfloat16)
    tgt = torch.randint(0, V, (N,), generator=g, device=dev,
                        dtype=torch.int32)
    tgt[::7] = -1
    srow = (tgt >= 0).float()
    lse, _true, rstd = FC.flash_ce_fwd(x, w, tgt, (sc, eps))
    for what, fn in (
            ("flash_ce_fwd", lambda: FC.flash_ce_fwd(x, w, tgt, (sc, eps))),
            ("flash_ce_bwd", lambda: FC.flash_ce_bwd(
                x, w, tgt, lse, srow, (sc, eps, rstd)))):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
        report(f"{what} [{N}, {d}, {V}] (per call)", prof, wall, 3)


# ------------------------------------------------------------------ 11-13
# gpt2-train-dataset: token rows of TRAIN_S + 1 ids over the training
# vocabulary, from DATASET_SEED, in DATASET_SHARDS .npy shards read by
# ``data.read_numpy``; a TorchTrainer worker takes DATASET_STEPS steps of
# DATASET_B rows through ``iter_torch_batches(device="cuda")``.  A step
# "waited on input" when its ``next()`` blocked longer than
# DATASET_WAIT_MS.  Its losses are held, within DATASET_LOSS_REL
# relative, to the same batches fed by hand to this process's step.
DATASET_SEED, DATASET_ROWS, DATASET_SHARDS = 19, 512, 8
DATASET_B, DATASET_STEPS = 8, 8
DATASET_WAIT_MS = 1.0
DATASET_LOSS_REL = 1e-5
# gpt2-serve-lora: rank 16 on every target, a bank of 4 tenants plus the
# identity; 3 tenants and base traffic in one co-batch of 8 requests
LORA_RANK, LORA_SLOTS, LORA_NEW = 16, 4, 16
LORA_TENANTS = ("tenant-0", "tenant-1", "tenant-2")
# each tenant's published scale: with init_adapter's random B a delta of
# ~0.25 a unit input per target, the size of the base matmuls' outputs
LORA_SERVE_SCALE = 0.25
# gpt2-train-lora: LORA_TRAIN_STEPS steps at 8 x 1024 in each arm, the
# first LORA_UNTIMED untimed (the first step allocates the optimizer's
# state and warms the allocator); the gradient check at phase 9's
# 2 x 1024 with an adapter whose B factors are drawn and scaled by
# LORA_GRAD_B (a delta of ~0.1 a unit input: the bf16 bound of phase 9
# holds for a perturbation of the base's size)
LORA_TRAIN_STEPS, LORA_UNTIMED, LORA_GRAD_B = 12, 2, 0.1


def dataset_rows() -> np.ndarray:
    return np.random.default_rng(DATASET_SEED).integers(
        0, TRAIN_CFG["vocab_size"], (DATASET_ROWS, TRAIN_S + 1),
        dtype=np.int64)


def train_dataset_loop(config: dict) -> None:
    """gpt2-train-dataset's loop, in the train worker: GPT-2 124M from
    seed 0 takes DATASET_STEPS steps, each on the next batch of
    ``get_dataset_shard("train").iter_torch_batches(batch_size=
    DATASET_B, device="cuda")``; reports each step's loss, the first
    four ids of every row it took, its input wait and wall, and the
    launches and peak of the run."""
    from ray_tpu_torch import GPTConfig, train
    from ray_tpu_torch.models.training import (build_gpt_train,
                                               default_optimizer)
    from ray_tpu_torch.ops import _build

    torch_flags()
    if torch.cuda.get_device_name(0) != config["card"]:
        raise AssertionError("train worker sees "
                             f"{torch.cuda.get_device_name(0)!r}")
    dev = torch.device("cuda")
    cfg = GPTConfig.gpt2(**TRAIN_CFG, dtype=torch.bfloat16)
    fns = build_gpt_train(cfg, optimizer=default_optimizer(**TRAIN_OPT),
                          device=dev, telemetry=False)
    state = fns["init_fn"](torch.Generator().manual_seed(0))
    shard = train.get_dataset_shard("train")
    batches = shard.iter_torch_batches(batch_size=DATASET_B, device="cuda")
    _build.load()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    losses, heads, waits, walls = [], [], [], []
    for _ in range(DATASET_STEPS):
        t0 = time.monotonic()
        rows = next(batches)["data"]
        t_in = time.monotonic()
        if rows.device.type != "cuda" or rows.shape != (DATASET_B,
                                                        TRAIN_S + 1):
            raise AssertionError(f"batch {tuple(rows.shape)} on "
                                 f"{rows.device}")
        state, m = fns["step_fn"](state, {
            "tokens": rows[:, :-1].contiguous(),
            "targets": rows[:, 1:].contiguous()})
        losses.append(float(m["loss"]))
        heads.extend(rows[:, :4].tolist())
        waits.append(t_in - t0)
        walls.append(time.monotonic() - t0)
    torch.cuda.synchronize()
    train.report({"losses": losses, "heads": heads, "waits": waits,
                  "walls": walls, "launches": _build.launch_counts(),
                  "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                  "shard": type(shard).__module__})


def train_dataset_phase(dev) -> dict:
    """gpt2-train-dataset: ``data.read_numpy`` over DATASET_SHARDS token
    shards feeds a ``TorchTrainer`` of one ``num_gpus=1`` worker
    (``datasets={"train": ds}``: ``streaming_split(1, equal=True)``, the
    worker's ``DataIterator``), whose loop (``train_dataset_loop``)
    trains GPT-2 124M at full width for DATASET_STEPS steps of
    DATASET_B x TRAIN_S.  Gates: every row the worker took is a row of
    the data, none twice; the worker's launches exactly TRAIN_LAUNCHES a
    step; every loss within DATASET_LOSS_REL of the same batches fed by
    hand to this process's step from the same seeds.  Prints
    ``train-dataset metrics {...}`` (ms/step over the steps after the
    first, the share of steps that waited on input, peak GiB) and
    returns the worker's launches."""
    import shutil
    import tempfile

    import ray_tpu_torch as rt
    import ray_tpu_torch.data as rdata
    from ray_tpu_torch import GPTConfig
    from ray_tpu_torch.models.training import (build_gpt_train,
                                               default_optimizer)
    from ray_tpu_torch.train import RunConfig, ScalingConfig
    from ray_tpu_torch.train.torch import TorchConfig, TorchTrainer

    import chip_smoke
    rows = dataset_rows()
    where = {tuple(r[:4].tolist()): i for i, r in enumerate(rows)}
    if len(where) != len(rows):
        raise AssertionError("the data's rows are not told apart by their "
                             "first four ids")
    storage = tempfile.mkdtemp(prefix="gpt2_train_dataset_")
    shards = os.path.join(storage, "shards")
    os.makedirs(shards)
    for i, part in enumerate(np.array_split(rows, DATASET_SHARDS)):
        np.save(os.path.join(shards, f"part-{i:02d}.npy"), part)
    rt.init(num_cpus=RUNTIME_CPUS)
    try:
        ds = rdata.read_numpy(shards)
        trainer = TorchTrainer(
            chip_smoke.train_dataset_loop,
            torch_config=TorchConfig(host_collective=False),
            train_loop_config={"card": torch.cuda.get_device_name(0)},
            scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
            run_config=RunConfig(name="gpt2-train-dataset",
                                 storage_path=storage),
            datasets={"train": ds})
        t_fit = time.time()
        result = trainer.fit()
        fit_s = time.time() - t_fit
        if result.error is not None:
            raise AssertionError(f"train-dataset worker failed: "
                                 f"{result.error}")
        rep = result.metrics_history[-1]
    finally:
        rt.shutdown()
        shutil.rmtree(storage, ignore_errors=True)
    if rep["shard"] != "ray_tpu_torch.data.iterator":
        raise AssertionError(f"the worker's shard came from {rep['shard']}")
    taken = [where.get(tuple(h)) for h in rep["heads"]]
    if None in taken or len(set(taken)) != len(taken) \
            or len(taken) != DATASET_B * DATASET_STEPS:
        raise AssertionError(f"rows taken: {taken}")
    expect_launches("train-dataset worker", rep["launches"],
                    {k: n * DATASET_STEPS
                     for k, n in TRAIN_LAUNCHES.items()})
    # the same batches, fed by hand to this process's step
    cfg = GPTConfig.gpt2(**TRAIN_CFG, dtype=torch.bfloat16)
    fns = build_gpt_train(cfg, optimizer=default_optimizer(**TRAIN_OPT),
                          device=dev, telemetry=False)
    state = fns["init_fn"](torch.Generator().manual_seed(0))
    here = []
    for s in range(DATASET_STEPS):
        b = torch.from_numpy(rows[taken[s * DATASET_B:
                                        (s + 1) * DATASET_B]]).to(dev)
        state, m = fns["step_fn"](state, {
            "tokens": b[:, :-1].contiguous(),
            "targets": b[:, 1:].contiguous()})
        here.append(float(m["loss"]))
    del fns, state
    rel = max(abs(a - b) / abs(b) for a, b in zip(rep["losses"], here))
    print(f"train-dataset: losses {rep['losses'][0]:.4f} -> "
          f"{rep['losses'][-1]:.4f}, largest relative difference from the "
          f"same batches fed by hand {rel:.3e} (bound {DATASET_LOSS_REL})",
          flush=True)
    if not rel <= DATASET_LOSS_REL:
        raise AssertionError("train-dataset: the worker's losses part from "
                             "the same batches fed by hand")
    walls = rep["walls"][1:]
    waited = [w * 1e3 > DATASET_WAIT_MS for w in rep["waits"]]
    metrics = {
        "cell": "gpt2-train-dataset", "batch": [DATASET_B, TRAIN_S],
        "steps": DATASET_STEPS, "rows": DATASET_ROWS,
        "shards": DATASET_SHARDS, "fit_s": fit_s,
        "step_ms": 1e3 * float(np.mean(walls)),
        "median_step_ms": 1e3 * float(np.median(walls)),
        "first_step_ms": 1e3 * rep["walls"][0],
        "input_wait_ms": [1e3 * w for w in rep["waits"]],
        "waited_share": sum(waited) / len(waited),
        "waited_share_after_first": sum(waited[1:]) / (len(waited) - 1),
        "peak_gib": rep["peak_gib"], "max_loss_rel_diff": rel}
    print("train-dataset: every row taken once, launches read back exact",
          flush=True)
    print("train-dataset metrics " + json.dumps(metrics), flush=True)
    return rep["launches"]


def lora_engines(cfg, params, adapters, dev, **kw):
    """One plain engine over each tenant's merged weights (and the base
    for base traffic): the streams a banked engine must give."""
    from ray_tpu_torch import InferenceEngine
    from ray_tpu_torch.adapters import lora as lora_mod
    out = {None: InferenceEngine(cfg, params, device=dev, **ENGINE, **kw)}
    for t, a in adapters.items():
        out[t] = InferenceEngine(
            cfg, lora_mod.merge_adapter(params, a, cfg,
                                        scale=LORA_SERVE_SCALE),
            device=dev, **ENGINE, **kw)
    return out


def lora_streams_hold(what, prompts, tenants, got, refs, params32, cfg32,
                      adapters32) -> list:
    """Each stream against its tenant's merged-weights engine, under
    phase 7a's rule (``parted_within_margin`` on the f32 merged
    weights); returns the partings (request, position, margin)."""
    from ray_tpu_torch import SamplingParams
    from ray_tpu_torch.adapters import lora as lora_mod
    greedy = SamplingParams(temperature=0.0)
    partings = []
    merged32 = {}
    changed = 0
    for i, (p, t, g) in enumerate(zip(prompts, tenants, got)):
        want = refs[t].generate([p], LORA_NEW, greedy)[0]
        if t is not None:
            changed += want != refs[None].generate([p], LORA_NEW, greedy)[0]
        if t not in merged32:
            merged32[t] = params32 if t is None else lora_mod.merge_adapter(
                params32, adapters32[t], cfg32, scale=LORA_SERVE_SCALE)
        parted = parted_within_margin(f"{what} request {i} ({t})", p, g,
                                      want, merged32[t], cfg32)
        if parted is not None:
            partings.append((i, *parted))
    if changed < 2:
        raise AssertionError(f"{what}: only {changed} tenant streams "
                             "differ from the base model's")
    return partings


def cold_serve(engine, prompts, sampling) -> dict:
    """``serve`` of LORA_NEW tokens each, raising if any request found a
    prefix hit: a timed arm prefills every prompt."""
    hits0 = engine.stats()["prefix"]["requests_hit"]
    run = serve(engine, prompts, sampling, max_new_tokens=LORA_NEW)
    if engine.stats()["prefix"]["requests_hit"] != hits0:
        raise AssertionError("serve-lora: a timed co-batch hit the "
                             "prefix cache")
    return run


def serve_lora_phase(params, cfg, dev) -> dict:
    """gpt2-serve-lora: GPT-2 124M with a bank of LORA_SLOTS tenants
    (rank LORA_RANK on every target, slot 0 the identity), 8 slots, page
    128.  LORA_TENANTS (random non-zero B factors from a
    ``torch.Generator``, published to an ``AdapterStore``) and base
    traffic in one co-batch of 8 requests of LORA_NEW greedy tokens.
    Gates: every stream equals the plain engine serving
    ``merge_adapter(base, adapter)`` under phase 7a's rule; exact
    launches with 0 of ``matmul_residual_norm`` (declined under LoRA);
    a republish mid-decode keeps the pinned version's tokens while a
    request after it takes the new version, the bank written in place
    (the same tensors); the int8 KV arm against merged int8 engines.
    Prints ``serve-lora metrics {...}`` (TTFT and decode tokens/s beside
    the LoRA-off engine's on the same prompts: each arm a warmed engine
    whose prefix cache holds none of them, asserted by 0 prefix hits;
    the first LoRA co-batch loads its tenants, a second with the prefix
    cache flushed finds them resident) and returns the launches of the
    bf16 and int8 co-batches by path."""
    from ray_tpu_torch import InferenceEngine, SamplingParams
    from ray_tpu_torch.adapters import (ALL_TARGETS, AdapterStore,
                                        LoraConfig)
    from ray_tpu_torch.adapters import lora as lora_mod

    L = cfg.n_layers
    lcfg = LoraConfig(enabled=True, rank=LORA_RANK, targets=ALL_TARGETS,
                      cache_slots=LORA_SLOTS)
    gen = torch.Generator().manual_seed(21)
    adapters = {t: lora_mod.init_adapter(cfg, lcfg, gen, random_b=True,
                                         device=dev) for t in LORA_TENANTS}
    # the f32 references of 7a's rule run on the CPU
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    params32 = to_cpu32(params)
    adapters32 = {t: to_cpu32(a) for t, a in adapters.items()}

    def store_of(pairs):
        store = AdapterStore(use_object_store=False)
        for t, a in pairs:
            store.put(t, a, scale=LORA_SERVE_SCALE)
        return store

    prompts = mixed_prompts()[:8]
    tenants = [LORA_TENANTS[i % 4] if i % 4 < 3 else None
               for i in range(len(prompts))]
    greedy = [SamplingParams(temperature=0.0, model_id=t) for t in tenants]
    report, paths = {}, {}
    for kv_dtype in ("model", "int8"):
        store = store_of(adapters.items())
        engine = InferenceEngine(cfg, params, device=dev, lora=lcfg,
                                 adapter_store=store, kv_dtype=kv_dtype,
                                 **ENGINE)
        engine.generate([[1, 2, 3]], max_new_tokens=2)     # warm-up
        ptrs = {k: v.data_ptr() for k, v in engine.lora_bank.items()}
        run = cold_serve(engine, prompts, greedy)
        launches = run["launches"]
        if launches.get("matmul_residual_norm_fwd", 0):
            raise AssertionError("serve-lora: the fused epilogue launched "
                                 "under LoRA")
        want = serve_launches(L, run["calls"], kv_dtype)
        want.pop("matmul_residual_norm_fwd")
        expect_launches(f"serve-lora {kv_dtype}", launches, want)
        got = [run["out"][r] for r in run["rids"]]
        refs = lora_engines(cfg, params, adapters, dev, kv_dtype=kv_dtype)
        partings = lora_streams_hold(f"serve-lora {kv_dtype}", prompts,
                                     tenants, got, refs, params32, cfg32,
                                     adapters32)
        if len({tuple(g) for g in got}) < 4:
            raise AssertionError("serve-lora: the tenants' streams are "
                                 "not told apart")
        arm = {"launches": launches, "partings": partings,
               "mean_ttft_ms": 1e3 * float(np.mean(list(
                   run["ttft"].values()))),
               "decode_tokens_per_s": sum(len(v) - 1 for v in
                                          run["out"].values())
               / run["secs"]["decode"]}
        if kv_dtype == "model":
            # the same co-batch with every tenant resident
            engine.scheduler.flush_prefix()
            resident = cold_serve(engine, prompts, greedy)
            if [resident["out"][r] for r in resident["rids"]] != got:
                raise AssertionError("serve-lora: the resident co-batch "
                                     "gave other tokens")
            arm["resident_mean_ttft_ms"] = 1e3 * float(np.mean(list(
                resident["ttft"].values())))
            arm["resident_decode_tokens_per_s"] = sum(
                len(v) - 1 for v in resident["out"].values()) \
                / resident["secs"]["decode"]
            # republish mid-decode: tenant-0's v1 request keeps v1's
            # factors; one submitted after the publish takes v2
            rid1 = engine.submit(prompts[0], max_new_tokens=LORA_NEW,
                                 sampling=greedy[0])
            out = {rid1: []}
            rid2 = None
            while engine.has_work():
                for rid, tok, _d in engine.step():
                    out[rid].append(tok)
                if rid2 is None:
                    store.put(LORA_TENANTS[0], adapters[LORA_TENANTS[1]],
                              scale=LORA_SERVE_SCALE)
                    rid2 = engine.submit(prompts[1],
                                         max_new_tokens=LORA_NEW,
                                         sampling=greedy[0])
                    out[rid2] = []
            if out[rid1] != got[0] or out[rid2] != got[1]:
                raise AssertionError(
                    "serve-lora: after a republish mid-decode the pinned "
                    f"request gave {out[rid1]} (v1's {got[0]}) and the "
                    f"next {out[rid2]} (v2's {got[1]})")
            if {k: v.data_ptr() for k, v in engine.lora_bank.items()} \
                    != ptrs or not engine.leak_free():
                raise AssertionError("serve-lora: the republish moved the "
                                     "bank or leaked")
            arm["adapters"] = engine.stats()["adapters"]
            plain = InferenceEngine(cfg, params, device=dev, **ENGINE)
            plain.generate([[1, 2, 3]], max_new_tokens=2)  # warm-up
            base = cold_serve(plain, prompts, [SamplingParams(
                temperature=0.0)] * len(prompts))
            del plain
            arm["lora_off_mean_ttft_ms"] = 1e3 * float(np.mean(list(
                base["ttft"].values())))
            arm["lora_off_decode_tokens_per_s"] = sum(
                len(v) - 1 for v in base["out"].values()) \
                / base["secs"]["decode"]
        report[kv_dtype] = arm
        paths["serve_lora" if kv_dtype == "model"
              else "serve_lora_int8"] = launches
        print(f"serve-lora {kv_dtype}: {len(prompts)} requests of 3 "
              f"tenants and base in one co-batch, launches {launches} == "
              f"implied with 0 epilogue launches, streams equal the "
              f"merged-weights engines' ({len(partings)} partings at "
              "bf16 ties)", flush=True)
        del engine, refs
        gc.collect()
        torch.cuda.empty_cache()
    print("serve-lora: republish mid-decode kept the pinned version's "
          "tokens, the bank written in place", flush=True)
    print("serve-lora metrics " + json.dumps(
        {"cell": "gpt2-serve-lora", "rank": LORA_RANK,
         "bank_slots": lcfg.bank_slots, **report}), flush=True)
    return paths


def train_lora_phase(dev) -> dict:
    """gpt2-train-lora: ``build_gpt_train(lora=..., base_params=...)``
    over GPT-2 124M (rank LORA_RANK on every target) for
    LORA_TRAIN_STEPS steps at DATASET_B x TRAIN_S, beside the
    full-parameter arm at the same batch.  Gates: step 0's loss is the
    base model's; exact launches (the attention and flash-CE pairs, no
    epilogue: declined under LoRA); the base parameters bit-unchanged;
    the loss falls; the adapter's gradients on the kernel path against
    the f32 plain path at 2 x TRAIN_S within phase 9's bf16 bound.
    Prints ``train-lora metrics {...}`` and returns the launches."""
    from ray_tpu_torch import GPTConfig, init_params
    from ray_tpu_torch.adapters import ALL_TARGETS, LoraConfig
    from ray_tpu_torch.adapters import lora as lora_mod
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.models.training import (build_gpt_train,
                                               default_optimizer,
                                               synthetic_lm_batch,
                                               value_and_grad)
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops.attention import make_flash_attention_fn

    gc.collect()
    torch.cuda.empty_cache()
    cfg = GPTConfig.gpt2(**TRAIN_CFG, dtype=torch.bfloat16)
    lcfg = LoraConfig(enabled=True, rank=LORA_RANK, targets=ALL_TARGETS,
                      cache_slots=LORA_SLOTS)
    base = init_params(cfg, torch.Generator().manual_seed(0), device=dev)
    batch = synthetic_lm_batch(torch.Generator().manual_seed(1), DATASET_B,
                               TRAIN_S, cfg.vocab_size, device=dev)
    arms = {}
    for arm in ("full", "lora"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        if arm == "full":
            fns = build_gpt_train(cfg, optimizer=default_optimizer(
                **TRAIN_OPT), device=dev, telemetry=False)
            state = fns["init_fn"](params={k: (
                {n: v.clone() for n, v in t.items()} if isinstance(t, dict)
                else t.clone()) for k, t in base.items()})
            base_loss = float(fns["loss_fn"](state.params, batch))
        else:
            snapshot = {k: ({n: v.clone() for n, v in t.items()}
                            if isinstance(t, dict) else t.clone())
                        for k, t in base.items()}
            fns = build_gpt_train(cfg, optimizer=default_optimizer(
                **TRAIN_OPT), lora=lcfg, base_params=base, device=dev,
                telemetry=False)
            state = fns["init_fn"](torch.Generator().manual_seed(3))
            lora_loss0 = float(fns["loss_fn"](state.params, batch))
        _build.reset_launches()
        losses, walls = [], []
        for _ in range(LORA_TRAIN_STEPS):
            t0 = time.monotonic()
            state, m = fns["step_fn"](state, batch)
            losses.append(float(m["loss"]))
            walls.append(time.monotonic() - t0)
        torch.cuda.synchronize()
        timed = 1e3 * np.array(walls[LORA_UNTIMED:])
        arms[arm] = {"launches": _build.launch_counts(), "losses": losses,
                     "step_ms": float(timed.mean()),
                     "step_ms_min_max": [float(timed.min()),
                                         float(timed.max())],
                     "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        del fns, state
        gc.collect()
        torch.cuda.empty_cache()
    lora = arms["lora"]
    want = {k: n * LORA_TRAIN_STEPS for k, n in TRAIN_LAUNCHES.items()
            if not k.startswith("matmul_residual_norm")}
    expect_launches("train-lora", lora["launches"], want)
    for k, t in base.items():
        for n, v in (t.items() if isinstance(t, dict) else [(k, t)]):
            ref = snapshot[k][n] if isinstance(t, dict) else snapshot[k]
            if not torch.equal(v, ref):
                raise AssertionError(f"train-lora: base parameter {k}/{n} "
                                     "moved")
    d0 = abs(lora_loss0 - base_loss)
    if not d0 <= TRAIN_BF16_TOL["loss_abs"]:
        raise AssertionError(f"train-lora: step 0's loss {lora_loss0} is "
                             f"not the base model's {base_loss}")
    if not lora["losses"][-1] < lora["losses"][0]:
        raise AssertionError(f"train-lora: the loss did not fall "
                             f"{lora['losses']}")
    # gradients: a non-identity adapter, kernel path against plain f32
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    base32 = {k: ({n: v.float() for n, v in t.items()}
                  if isinstance(t, dict) else t.float())
              for k, t in base.items()}
    adapter = lora_mod.init_adapter(cfg32, lcfg,
                                    torch.Generator().manual_seed(5),
                                    random_b=True, device=dev)
    adapter = {k: v * LORA_GRAD_B if k.endswith("_b") else v
               for k, v in adapter.items()}
    small = synthetic_lm_batch(torch.Generator().manual_seed(6), 2,
                               TRAIN_S, cfg.vocab_size, device=dev)
    attn = make_flash_attention_fn(rope_theta=cfg.rope_theta)
    ref_loss, ref_grads = value_and_grad(
        lambda a, b: gpt.loss_fn(base32, b, cfg32, fuse_norm=False,
                                 ce_mode="xla", lora={**a, "scale": 1.0}),
        adapter, small)
    _build.reset_launches()
    loss, grads = value_and_grad(
        lambda a, b: gpt.loss_fn(base, b, cfg, attn_fn=attn,
                                 lora={**a, "scale": 1.0}),
        {k: v.to(torch.bfloat16) for k, v in adapter.items()}, small)
    torch.cuda.synchronize()
    grad_launches = _build.launch_counts()
    expect_launches("train-lora gradient", grad_launches,
                    {k: n for k, n in TRAIN_LAUNCHES.items()
                     if not k.startswith("matmul_residual_norm")})
    dl = abs(float(loss) - float(ref_loss))
    worst_share, worst = 0.0, ""
    for k, g in grads.items():
        want_g = ref_grads[k].float()
        share = (g.float() - want_g).abs().max().item() / (
            TRAIN_BF16_TOL["grad"] * want_g.abs().max().item() + 1e-30)
        if not math.isfinite(share) or share > worst_share:
            worst_share, worst = share, k
    print(f"train-lora gradient: loss {float(loss):.6f} vs plain f32 "
          f"{float(ref_loss):.6f} (|diff| {dl:.3e}); worst adapter "
          f"gradient {worst} share_of_tol={worst_share:.3f} (bound "
          f"{TRAIN_BF16_TOL['grad']} of each leaf's largest value)",
          flush=True)
    if not dl <= TRAIN_BF16_TOL["loss_abs"] or not worst_share <= 1:
        raise AssertionError("train-lora: the adapter's gradients part "
                             "from the plain path")
    metrics = {"cell": "gpt2-train-lora", "batch": [DATASET_B, TRAIN_S],
               "rank": LORA_RANK, "steps": LORA_TRAIN_STEPS,
               "timed_steps": LORA_TRAIN_STEPS - LORA_UNTIMED,
               "step_ms": lora["step_ms"],
               "step_ms_min_max": lora["step_ms_min_max"],
               "peak_gib": lora["peak_gib"], "losses": lora["losses"],
               "full_step_ms": arms["full"]["step_ms"],
               "full_step_ms_min_max": arms["full"]["step_ms_min_max"],
               "full_peak_gib": arms["full"]["peak_gib"],
               "full_losses": arms["full"]["losses"],
               "adapter_params": sum(v.numel() for v in adapter.values()),
               "step0_loss_minus_base": lora_loss0 - base_loss,
               "grad_loss_diff": dl, "grad_worst_share": worst_share}
    print("train-lora: the base bit-unchanged, launches exact with no "
          "epilogue", flush=True)
    print("train-lora metrics " + json.dumps(metrics), flush=True)
    return lora["launches"]


# gpt2-rl, -group, -lora and -supervised: bench.py --rl's setting (GPT-2
# 124M at full width, bf16, random weights from seed 0; RLConfig()'s
# defaults: 1 actor, batch 8, horizon 16, queue 4, max_lag 1, rloo,
# temperature 1.0; prompt length 4, seed 1, lr 1e-4; the engine's default
# geometry)
RL_STEPS, RL_GROUP_STEPS, RL_LORA_STEPS, RL_SUP_STEPS = 30, 6, 4, 8
RL_LR, RL_SEED, RL_PROMPT = 1e-4, 1, 4
RL_N = 8 * (RL_PROMPT + 16)     # the learner's rows: batch x (prompt +
                                # horizon)
RL_FAULTS = "rl.rollout@3,rl.learner@5"
RL_CKPT_EVERY = 2
RL_GROUP_REL = 1e-5
# a swap while the learner moves changes at least this share of the
# engine's elements (a bf16 parameter moves by one Adam step of ~lr =
# 1e-4 unless its spacing is over 2 lr, i.e. |p| >= 2^-5; most of
# GPT-2's are smaller)
RL_MOVED_MIN = 0.1
# gpt2-rl-group's version 2 (one step of its learner actor) against
# gpt2-rl-moving's (one step in-process on the same batch): at most this
# share of the elements may differ (by one bf16 step where a gradient
# sits near Adam's eps)
RL_V2_PARTED = 1e-4
# RLOptimizer on the card against a plain clip-then-Adam in f32, two
# steps: each parameter within this share of the learning rate, beside
# two f32 roundings of the parameter itself (4 * 2^-23 * |p|: a norm
# scale at 1.0 has a spacing of 1.2e-3 lr)
RL_OPT_TOL = 1e-3
# the policy-gradient step on the kernel path against the plain path in
# f32: each gradient leaf within TRAIN_BF16_TOL["grad"] of its largest
# value; the loss within 2e-4 of the scale of its terms, (1/B) sum_b
# |adv_b| sum_t |logp|: the advantages sum to 0, so the loss is a
# cancellation of per-row terms ~100 times its size, and each term
# carries its tokens' bf16 logits (the CE loss's own 2e-4 is against a
# mean of ~10.8)
RL_LOSS_REL = 2e-4
# one learner step's launches: the training step's without flash-CE (the
# RL loss is the reference's plain f32 log_softmax)
RL_STEP_LAUNCHES = {k: n for k, n in TRAIN_LAUNCHES.items()
                    if not k.startswith("flash_ce")}


def rl_config(**over):
    from ray_tpu_torch.rl import RLConfig
    return RLConfig(**over)


def rl_model():
    from ray_tpu_torch import GPTConfig
    return GPTConfig.gpt2(**GPT2, dtype=torch.bfloat16)


def rl_param_ptrs(engine) -> tuple:
    from ray_tpu_torch.models.training import _leaves
    return tuple(t.data_ptr() for t in _leaves(engine.params))


def rl_moving_reward(vocab: int):
    """A reward that varies across a rollout's rows at any vocabulary:
    the share of a completion's tokens in the lower half of it.  (At
    vocab 50304 bench.py's target-token reward is -1 on every row, so
    RLOO's advantages are 0 and Adam moves nothing.)"""
    half = vocab // 2

    def reward(completion) -> float:
        return float(np.mean([t < half for t in completion]))
    return reward


def rl_changed_share(a: list, b: list) -> float:
    """The share of the elements of two like lists of leaves that
    differ."""
    return (sum(int((torch.as_tensor(x) != torch.as_tensor(y)).sum())
                for x, y in zip(a, b))
            / sum(torch.as_tensor(x).numel() for x in a))


class RLProbe:
    """Wraps the RL loop's seams for one phase.  Per swap
    (``RolloutActor.sync``): its seconds and device-memory change, the
    engine's parameter addresses after it, whether the engine then holds
    the published tree bit for bit, and the share of the engine's
    elements it changed.  The engine calls the rollouts made (dead
    engines' too; ``rollout_launches`` reads them), the first rollout
    batch, the first publication's params and the first swap's, each
    injected fault's time and each learner step's end.  ``close()`` puts
    the originals back."""

    def __init__(self):
        from ray_tpu_torch.models.training import _leaves
        from ray_tpu_torch.rl import learner, replay, rollout
        from ray_tpu_torch.util import chaos
        self.swaps, self.faults, self.steps_done = [], [], []
        self.calls = {}
        self.first_batch = self.first_params = self.swap_params = None
        self._orig = [(rollout.RolloutActor, "sync"),
                      (rollout.RolloutActor, "rollout"),
                      (replay.WeightStore, "publish"),
                      (learner.InProcessLearner, "update"),
                      (chaos, "maybe_fail")]
        self._saved = [getattr(o, n) for o, n in self._orig]
        sync, roll, publish, update, maybe_fail = self._saved
        probe = self

        def t_sync(actor, version, params):
            old = [t.clone() for t in _leaves(actor.engine.params)]
            torch.cuda.synchronize()
            before, t0 = torch.cuda.memory_allocated(), time.monotonic()
            sync(actor, version, params)
            torch.cuda.synchronize()
            took = time.monotonic() - t0
            alloc = torch.cuda.memory_allocated() - before
            new, pub = _leaves(actor.engine.params), _leaves(params)
            held = len(new) == len(pub) and all(
                torch.equal(x, torch.as_tensor(y).to(x.device))
                for x, y in zip(new, pub))
            moved = rl_changed_share(old, new)
            del old
            if probe.swap_params is None:
                probe.swap_params = params
            probe.swaps.append({
                "version": version, "s": took, "alloc": alloc,
                "ptrs": rl_param_ptrs(actor.engine), "held": held,
                "moved": moved})

        def t_rollout(actor, *a, **k):
            calls0 = dict(actor.engine.stats()["calls"])
            try:
                batch = roll(actor, *a, **k)
            finally:
                for n, v in actor.engine.stats()["calls"].items():
                    probe.calls[n] = (probe.calls.get(n, 0) + v
                                      - calls0.get(n, 0))
            if probe.first_batch is None:
                probe.first_batch = batch
            return batch

        def t_publish(store, params, **k):
            if probe.first_params is None and isinstance(params, dict):
                probe.first_params = params
            return publish(store, params, **k)

        def t_update(lrn, batch):
            out = update(lrn, batch)
            probe.steps_done.append(time.monotonic())
            return out

        def t_maybe_fail(site):
            try:
                maybe_fail(site)
            except chaos.InjectedFault:
                probe.faults.append((site, time.monotonic()))
                raise

        for (o, n), f in zip(self._orig, (t_sync, t_rollout, t_publish,
                                          t_update, t_maybe_fail)):
            setattr(o, n, f)

    def close(self):
        for (o, n), f in zip(self._orig, self._saved):
            setattr(o, n, f)

    def rollout_launches(self, cfg) -> dict:
        """The launches the rollouts imply: their prefills and decode
        steps (``serve_launches``)."""
        return serve_launches(cfg.n_layers, self.calls, "model")

    def swap_report(self, what, moving: bool) -> dict:
        """Gates: after every swap the engine holds the published tree
        bit for bit; from the second swap on a swap allocates nothing
        and leaves the engine's parameter addresses where they were;
        when the learner moves (``moving``), every swap changes at least
        RL_MOVED_MIN of the engine's elements."""
        later = self.swaps[1:]
        if not later:
            raise AssertionError(f"{what}: fewer than 2 weight swaps")
        moved = [s["version"] for s in later
                 if s["alloc"] != 0 or s["ptrs"] != later[0]["ptrs"]]
        if self.swaps[0]["ptrs"] != later[0]["ptrs"] or moved:
            raise AssertionError(f"{what}: swaps {moved} allocated device "
                                 "memory or moved the engine's parameters")
        stale = [s["version"] for s in self.swaps if not s["held"]]
        if stale:
            raise AssertionError(f"{what}: after the swaps to versions "
                                 f"{stale} the engine does not hold the "
                                 "published weights")
        still = [s["version"] for s in self.swaps
                 if s["moved"] < RL_MOVED_MIN]
        if moving and still:
            raise AssertionError(f"{what}: the swaps to versions {still} "
                                 f"changed under {RL_MOVED_MIN} of the "
                                 "engine's elements")
        shares = [s["moved"] for s in self.swaps]
        return {"swaps": len(self.swaps),
                "first_swap_alloc_bytes": self.swaps[0]["alloc"],
                "swap_alloc_bytes_from_2": max(s["alloc"] for s in later),
                "swap_s_median": float(np.median([s["s"]
                                                  for s in self.swaps])),
                "swap_changed_share_min": min(shares),
                "swap_changed_share_max": max(shares)}


def rl_finite(what, history) -> None:
    for i, h in enumerate(history):
        bad = [k for k, v in h.items() if not math.isfinite(v)]
        if bad:
            raise AssertionError(f"{what}: step {i} has non-finite {bad}")


def rl_thirds(curve) -> list:
    return [float(np.mean(t)) for t in np.array_split(np.array(curve), 3)]


def rl_plain_pg(params32, cfg32, batch, adv):
    """The policy-gradient loss and gradients on the plain path in f32:
    ``gpt.forward`` with the plain attention and epilogue, a plain f32
    ``log_softmax``; and the scale of the loss's terms."""
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.models.training import value_and_grad
    tokens, targets = batch["tokens"], batch["targets"]
    mask = (targets >= 0).float()

    def loss(p, _b):
        logits, _ = gpt.forward(p, tokens, cfg32, fuse_norm=False)
        logp = torch.log_softmax(logits.float(), -1)
        chosen = logp.gather(-1, targets.clamp_min(0)[..., None])[..., 0]
        return -(adv * (chosen * mask).sum(-1)).mean()

    val, grads = value_and_grad(loss, params32, None)
    with torch.no_grad():
        logits, _ = gpt.forward(params32, tokens, cfg32, fuse_norm=False)
        logp = torch.log_softmax(logits.float(), -1)
        chosen = logp.gather(-1, targets.clamp_min(0)[..., None])[..., 0]
        scale = float((adv.abs() * (chosen * mask).abs().sum(-1)).mean())
    return float(val), grads, scale


def rl_optimizer_check(fns, params, grads) -> dict:
    """``RLOptimizer`` through ``apply_grads_fn`` on the card: two steps
    (``grads``, then -0.5 times them) on f32 copies of ``params``,
    against a clip-then-Adam written here from optax's definitions
    (``clip_by_global_norm(1)``, ``adam(RL_LR)``: b1 0.9, b2 0.999, eps
    1e-8).  Gate: each parameter within RL_OPT_TOL of the learning rate
    beside two f32 roundings of itself, and the update not 0."""
    from ray_tpu_torch.models.training import _leaves, _rebuild
    p0 = [p.float() for p in _leaves(params)]
    g1 = [g.float() for g in _leaves(grads)]
    tx = fns["optimizer"]
    live = _rebuild(params, [p.clone() for p in p0])
    state = tx.init(live)
    want = [p.clone() for p in p0]
    mu = [torch.zeros_like(p) for p in p0]
    nu = [torch.zeros_like(p) for p in p0]
    for t, c in ((1, 1.0), (2, -0.5)):
        g = [c * x for x in g1]
        live, state = fns["apply_grads_fn"](live, state,
                                            _rebuild(grads, g))
        norm = torch.sqrt(sum((x * x).sum() for x in g))
        g = [x * (1.0 / torch.clamp(norm, min=1.0)) for x in g]
        mu = [0.9 * m + 0.1 * x for m, x in zip(mu, g)]
        nu = [0.999 * v + 0.001 * x * x for v, x in zip(nu, g)]
        want = [w - RL_LR * (m / (1 - 0.9 ** t))
                / (torch.sqrt(v / (1 - 0.999 ** t)) + 1e-8)
                for w, m, v in zip(want, mu, nu)]
    got = _leaves(live)
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    share = max(float(((a - b).abs() / (RL_OPT_TOL * RL_LR
                                         + 4 * 2.0 ** -23 * p.abs())).max())
                for a, b, p in zip(got, want, p0))
    step = max(float((a - b).abs().max()) for a, b in zip(got, p0))
    print(f"gpt2-rl RLOptimizer: two steps on the card against plain "
          f"clip-then-Adam: max |diff| {err / RL_LR:.3e} lr, "
          f"share_of_tol={share:.3f} (bound {RL_OPT_TOL} lr + two f32 "
          f"roundings of the parameter), largest move {step / RL_LR:.3f} "
          f"lr, grad norm {float(norm):.4f}", flush=True)
    if not share <= 1 or not step > 0:
        raise AssertionError("gpt2-rl: RLOptimizer's update parts from "
                             "the plain clip-then-Adam")
    return {"optimizer_max_abs_err_lr": err / RL_LR,
            "optimizer_share_of_tol": share,
            "optimizer_largest_move_lr": step / RL_LR}


def rl_kernel_checks(probe, cfg, dev) -> dict:
    """gpt2-rl's equalities on its first rollout: the actor's logprobs
    against the learner's teacher-forced ``log_softmax`` at version 1
    (kernel path, ENGINE_TOL); ``pg_grad_fn`` on that rollout's tokens
    with seeded normal rewards against the plain path in f32; and
    ``rl_optimizer_check`` on those gradients."""
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.models.training import _leaves, _paths, _at
    from ray_tpu_torch.models.training import (build_gpt_rl_train,
                                               rl_optimizer)
    from ray_tpu_torch.ops.attention import make_flash_attention_fn
    batch = probe.first_batch
    if batch.param_version != 1:
        raise AssertionError(f"gpt2-rl: the first rollout ran at version "
                             f"{batch.param_version}")
    params = {k: ({n: v.to(dev) for n, v in t.items()}
                  if isinstance(t, dict) else t.to(dev))
              for k, t in probe.first_params.items()}
    tokens = torch.from_numpy(batch.tokens).long().to(dev)
    targets = torch.from_numpy(batch.targets).long().to(dev)
    attn = make_flash_attention_fn(rope_theta=cfg.rope_theta)
    with torch.no_grad():
        logits, _ = gpt.forward(params, tokens, cfg, attn_fn=attn)
        logp = torch.log_softmax(logits.float(), -1).cpu()
    got, want = [], []
    for b, comp in enumerate(batch.completions):
        lo = RL_PROMPT - 1
        for i, tok in enumerate(comp):
            got.append(batch.logprobs[b][i])
            want.append(float(logp[b, lo + i, tok]))
    lp_err = check("gpt2-rl actor logprobs vs learner log_softmax",
                   torch.tensor(got), torch.tensor(want), **ENGINE_TOL)
    rewards = torch.randn(len(batch.completions),
                          generator=torch.Generator().manual_seed(7))
    fns = build_gpt_rl_train(cfg, optimizer=rl_optimizer(RL_LR),
                             device=dev)
    lb = {"tokens": tokens, "targets": targets, "rewards": rewards}
    (loss, _m), grads = fns["pg_grad_fn"](params, lb)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    params32 = {k: ({n: v.float() for n, v in t.items()}
                    if isinstance(t, dict) else t.float())
                for k, t in params.items()}
    from ray_tpu_torch.models.training import rl_advantages
    adv = rl_advantages(rewards).to(dev)
    ref_loss, ref_grads, scale = rl_plain_pg(params32, cfg32,
                                             {"tokens": tokens,
                                              "targets": targets}, adv)
    dl = abs(float(loss) - ref_loss)
    worst_share, worst = 0.0, ""
    for p, g in zip(_paths(grads), _leaves(grads)):
        want_g = _at(ref_grads, p).float()
        share = (g.float() - want_g).abs().max().item() / (
            TRAIN_BF16_TOL["grad"] * want_g.abs().max().item() + 1e-30)
        if not math.isfinite(share) or share > worst_share:
            worst_share, worst = share, "/".join(p)
    print(f"gpt2-rl pg_grad_fn: loss {float(loss):.6f} vs plain f32 "
          f"{ref_loss:.6f} (|diff| {dl:.3e}, {dl / scale:.3e} of the "
          f"terms' scale {scale:.3f}; bound {RL_LOSS_REL}); worst "
          f"gradient {worst} share_of_tol={worst_share:.3f} (bound "
          f"{TRAIN_BF16_TOL['grad']} of each leaf's largest value)",
          flush=True)
    if not dl <= RL_LOSS_REL * scale or not worst_share <= 1:
        raise AssertionError("gpt2-rl: pg_grad_fn on the kernel path parts "
                             "from the plain path")
    del ref_grads, params32
    opt = rl_optimizer_check(fns, params, grads)
    return {"logprob_max_abs_err": lp_err, "pg_loss_diff": dl,
            "pg_loss_term_scale": scale, "pg_grad_worst_share": worst_share,
            **opt}


def rl_phase(dev) -> tuple:
    """gpt2-rl: ``run_rl_loop`` for RL_STEPS learner steps, in-process.
    Gates: every metric finite, param_version RL_STEPS + 1, no drop, the
    engine drained clean, exact launches (the engine's prefills and
    decode steps, and per learner step the attention and epilogue
    forward and backward; flash-CE 0), after every swap the engine
    holding the published tree, from the second on nothing allocated and
    the engine's parameters where they were; then ``rl_kernel_checks``.
    Prints ``gpt2-rl metrics {...}``; returns (the launches, the publish
    seconds)."""
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.rl import run_rl_loop
    gc.collect()
    torch.cuda.empty_cache()
    cfg = rl_model()
    probe = RLProbe()
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        t0 = time.monotonic()
        res = run_rl_loop(cfg, steps=RL_STEPS, rlcfg=rl_config(),
                          prompt_len=RL_PROMPT, seed=RL_SEED, lr=RL_LR,
                          device=dev, telemetry=True)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = _build.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
    finally:
        probe.close()
    rl_finite("gpt2-rl", res["history"])
    if res["param_version"] != RL_STEPS + 1:
        raise AssertionError(f"gpt2-rl: param_version "
                             f"{res['param_version']} != {RL_STEPS + 1}")
    if res["drops_stale"] or res["drops_overflow"]:
        raise AssertionError(f"gpt2-rl: drops stale {res['drops_stale']} "
                             f"overflow {res['drops_overflow']}")
    if not all(e.leak_free() for e in res["actors"]):
        raise AssertionError("gpt2-rl: an engine is not idle at the end")
    want = add_launches(probe.rollout_launches(cfg),
                        {k: n * RL_STEPS for k, n in
                         RL_STEP_LAUNCHES.items()})
    expect_launches("gpt2-rl", launches, want)
    swaps = probe.swap_report("gpt2-rl", moving=False)
    checks = rl_kernel_checks(probe, cfg, dev)
    tel = res["telemetry"]
    curve = res["reward_curve"]
    metrics = {"cell": "gpt2-rl", "steps": RL_STEPS, "wall_s": wall,
               "rollout_tokens_per_sec": tel["rollout_tokens_per_sec"],
               "rollout_s": tel["rollout_s"],
               "learner_ms_per_step": 1e3 * tel["learner_step_s"],
               "publish_host_copy_s_median": tel["publish_s"],
               "publish_host_copy_s_max": tel["publish_max_s"],
               "version_lag_mean": tel["version_lag_mean"],
               "version_lag_max": tel["version_lag_max"],
               "reward_thirds": rl_thirds(curve),
               "reward_first_third": curve[:RL_STEPS // 3],
               "reward_last_third": curve[-(RL_STEPS // 3):],
               "peak_gib": peak, **swaps, **checks}
    print("gpt2-rl: every gate held; launches exact, flash-CE 0",
          flush=True)
    print("gpt2-rl metrics " + json.dumps(metrics), flush=True)
    return launches, tel["publish_s"]


def rl_moving_phase(dev) -> tuple:
    """gpt2-rl-moving: gpt2-rl's loop for RL_GROUP_STEPS steps with
    ``rl_moving_reward``, whose rewards vary across a rollout's rows, so
    RLOO's advantages are not 0 and every learner step moves the weights.
    Gates: every metric finite, param_version RL_GROUP_STEPS + 1, the
    engine clean, exact launches, after every swap the engine holding
    the published tree with at least RL_MOVED_MIN of its elements
    changed.  Prints ``gpt2-rl-moving metrics {...}``; returns (the
    launches, the history, the first swap's published params) for
    gpt2-rl-group."""
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.rl import run_rl_loop
    gc.collect()
    torch.cuda.empty_cache()
    cfg = rl_model()
    probe = RLProbe()
    try:
        _build.reset_launches()
        res = run_rl_loop(cfg, steps=RL_GROUP_STEPS, rlcfg=rl_config(),
                          reward_fn=rl_moving_reward(cfg.vocab_size),
                          prompt_len=RL_PROMPT, seed=RL_SEED, lr=RL_LR,
                          device=dev, telemetry=True)
        torch.cuda.synchronize()
        launches = _build.launch_counts()
    finally:
        probe.close()
    rl_finite("gpt2-rl-moving", res["history"])
    if res["param_version"] != RL_GROUP_STEPS + 1:
        raise AssertionError(f"gpt2-rl-moving: param_version "
                             f"{res['param_version']}")
    if not all(e.leak_free() for e in res["actors"]):
        raise AssertionError("gpt2-rl-moving: an engine is not idle")
    expect_launches("gpt2-rl-moving", launches,
                    add_launches(probe.rollout_launches(cfg),
                                 {k: n * RL_GROUP_STEPS for k, n in
                                  RL_STEP_LAUNCHES.items()}))
    swaps = probe.swap_report("gpt2-rl-moving", moving=True)
    tel = res["telemetry"]
    metrics = {"cell": "gpt2-rl-moving", "steps": RL_GROUP_STEPS,
               "reward_curve": res["reward_curve"],
               "pg_loss": [h["pg_loss"] for h in res["history"]],
               "grad_norm": [h["grad_norm"] for h in res["history"]],
               "learner_ms_per_step": 1e3 * tel["learner_step_s"],
               "publish_host_copy_s_median": tel["publish_s"], **swaps}
    print("gpt2-rl-moving: every gate held; every swap moved the engine's "
          "weights to the published ones", flush=True)
    print("gpt2-rl-moving metrics " + json.dumps(metrics), flush=True)
    return launches, res["history"], probe.swap_params


def rl_group_phase(dev, ref: list, ref_v2, publish_s: float) -> dict:
    """gpt2-rl-group: gpt2-rl-moving's loop (``rl_moving_reward``) for
    RL_GROUP_STEPS steps under a port session, the learner in an actor
    holding the card (``num_gpus=1``), the rollout engine in this
    process on the same card, publications through the object store.
    Gates: its first step's metrics equal gpt2-rl-moving's (``ref``)
    within RL_GROUP_REL relative (the same params and seeds give the same
    first trajectories); its version 2 (one step of the learner actor's
    ``apply_grads``) differs from gpt2-rl-moving's (``ref_v2``) in at
    most RL_V2_PARTED of the elements; every swap moved the engine to the
    published tree; exact rollout launches here.  Prints each later
    step's largest relative difference.  Prints ``gpt2-rl-group metrics
    {...}``; returns this process's launches."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.rl import learner as learner_mod
    from ray_tpu_torch.rl import run_rl_loop
    gc.collect()
    torch.cuda.empty_cache()
    cfg = rl_model()
    cold = []
    real_init = learner_mod.LearnerGroupAdapter.__init__

    def timed_init(self, *a, **k):
        t0 = time.monotonic()
        real_init(self, *a, **k)
        cold.append(time.monotonic() - t0)

    rt.init(num_cpus=RUNTIME_CPUS)
    learner_mod.LearnerGroupAdapter.__init__ = timed_init
    probe = RLProbe()
    try:
        _build.reset_launches()
        res = run_rl_loop(cfg, steps=RL_GROUP_STEPS, rlcfg=rl_config(),
                          reward_fn=rl_moving_reward(cfg.vocab_size),
                          prompt_len=RL_PROMPT, seed=RL_SEED, lr=RL_LR,
                          num_learners=1, device=dev, telemetry=True)
        torch.cuda.synchronize()
        launches = _build.launch_counts()
    finally:
        probe.close()
        learner_mod.LearnerGroupAdapter.__init__ = real_init
        rt.shutdown()
    rl_finite("gpt2-rl-group", res["history"])
    expect_launches("gpt2-rl-group", launches, probe.rollout_launches(cfg))

    def rel(got, want):
        return max((abs(got[k] - want[k]) / max(abs(want[k]), 1e-30)
                    for k in want if k in got), default=0.0)

    got, first = res["history"][0], ref[0]
    if not rel(got, first) <= RL_GROUP_REL:
        raise AssertionError(f"gpt2-rl-group: first step parts from "
                             f"gpt2-rl-moving's: {got} vs {first}")
    from ray_tpu_torch.models.training import _leaves
    v2_parted = rl_changed_share(_leaves(probe.swap_params),
                                 _leaves(ref_v2))
    print(f"gpt2-rl-group: version 2 differs from gpt2-rl-moving's in "
          f"{v2_parted:.3e} of its elements (bound {RL_V2_PARTED})",
          flush=True)
    if not v2_parted <= RL_V2_PARTED:
        raise AssertionError("gpt2-rl-group: the learner actor's first "
                             "update parts from the in-process learner's")
    later = [rel(g, w) for g, w in zip(res["history"], ref)]
    print("gpt2-rl-group: each step's largest relative difference from "
          f"gpt2-rl-moving's: {later}", flush=True)
    swaps = probe.swap_report("gpt2-rl-group", moving=True)
    tel = res["telemetry"]
    metrics = {"cell": "gpt2-rl-group", "steps": RL_GROUP_STEPS,
               "learner_cold_start_s": cold[0],
               "publish_object_store_s_median": tel["publish_s"],
               "publish_object_store_s_max": tel["publish_max_s"],
               "gpt2_rl_publish_host_copy_s_median": publish_s,
               "learner_ms_per_step": 1e3 * tel["learner_step_s"],
               "rollout_tokens_per_sec": tel["rollout_tokens_per_sec"],
               "first_step": {k: got[k] for k in first if k in got},
               "step_rel_diff": later, "v2_parted_share": v2_parted,
               **swaps}
    print("gpt2-rl-group: the first step and version 2 equal "
          "gpt2-rl-moving's", flush=True)
    print("gpt2-rl-group metrics " + json.dumps(metrics), flush=True)
    return launches


def rl_lora_phase(dev) -> dict:
    """gpt2-rl-lora: an adapter-only ``InProcessLearner`` (rank
    LORA_RANK on every target) over a frozen GPT-2 trains RL_LORA_STEPS
    steps on sampled rollouts of a bank engine serving its tenant, with
    seeded normal rewards (so the advantages are not 0), and
    ``publish_adapter``s into an ``AdapterStore`` after each step, which
    the engine serves from its next rollout.  Gates: the base
    bit-unchanged; exact launches with 0 of the epilogue on both sides;
    every B of the published adapter moved from its zeros; the tenant's
    greedy stream equals an engine over ``merge_adapter(base, adapter)``
    under 7a's rule.  Prints how far the adapter moves the f32 logits and
    whether the tenant's stream differs from the base's, and
    ``gpt2-rl-lora metrics {...}``; returns the launches."""
    from ray_tpu_torch import InferenceEngine, SamplingParams, init_params
    from ray_tpu_torch.adapters import (ALL_TARGETS, AdapterStore,
                                        LoraConfig, adapter_nbytes)
    from ray_tpu_torch.adapters import lora as lora_mod
    from ray_tpu_torch.models.gpt import forward
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.rl import InProcessLearner, trajectories_to_batch
    gc.collect()
    torch.cuda.empty_cache()
    cfg = rl_model()
    lcfg = LoraConfig(enabled=True, rank=LORA_RANK, targets=ALL_TARGETS)
    base = init_params(cfg, torch.Generator().manual_seed(0), device=dev)
    snapshot = {k: ({n: v.clone() for n, v in t.items()}
                    if isinstance(t, dict) else t.clone())
                for k, t in base.items()}
    learner = InProcessLearner(cfg, lora=lcfg, base_params=base, lr=RL_LR,
                               seed=RL_SEED, device=dev)
    store = AdapterStore(use_object_store=False)
    engine = InferenceEngine(cfg, base, lora=lcfg, adapter_store=store,
                             device=dev, telemetry=False, ttft_deadline=0,
                             deadline=0)
    rng = np.random.RandomState(RL_SEED)
    prompt = [int(t) for t in rng.randint(0, cfg.vocab_size, RL_PROMPT)]
    rlcfg = rl_config()
    _build.reset_launches()
    calls0 = dict(engine.stats()["calls"])
    walls = []
    for step in range(RL_LORA_STEPS):
        version = learner.publish_adapter(store, "tenant-rl")
        t0 = time.monotonic()
        rids = [engine.submit(prompt, max_new_tokens=rlcfg.horizon,
                              sampling=SamplingParams(
                                  temperature=1.0, seed=1000 * step + i,
                                  model_id="tenant-rl"))
                for i in range(rlcfg.batch)]
        toks = {r: [] for r in rids}
        while engine.has_work():
            for ev in engine.step():
                if ev.error is not None:
                    raise ev.error
                if ev[1] >= 0:
                    toks[ev[0]].append(int(ev[1]))
        comps = [toks[r] for r in rids]
        batch = trajectories_to_batch([prompt] * rlcfg.batch, comps,
                                      RL_PROMPT + rlcfg.horizon)
        batch["rewards"] = torch.randn(
            rlcfg.batch, generator=torch.Generator().manual_seed(
                7 + step)).numpy()
        m = learner.update(batch)
        torch.cuda.synchronize()
        walls.append(time.monotonic() - t0)
        rl_finite("gpt2-rl-lora", [m])
    launches = _build.launch_counts()
    calls = {k: v - calls0.get(k, 0)
             for k, v in engine.stats()["calls"].items()}
    want = serve_launches(cfg.n_layers, calls, "model")
    want.pop("matmul_residual_norm_fwd")
    want = add_launches(want, {k: n * RL_LORA_STEPS for k, n in
                               RL_STEP_LAUNCHES.items()
                               if not k.startswith("matmul_residual_norm")})
    expect_launches("gpt2-rl-lora", launches, want)
    for k, t in base.items():
        for n, v in (t.items() if isinstance(t, dict) else [(k, t)]):
            ref = snapshot[k][n] if isinstance(t, dict) else snapshot[k]
            if not torch.equal(v, ref):
                raise AssertionError(f"gpt2-rl-lora: base parameter {k}/{n} "
                                     "moved")
    version = learner.publish_adapter(store, "tenant-rl")
    _v, adapter, scale = store.get("tenant-rl")
    b_max = {k: float(v.abs().max()) for k, v in adapter.items()
             if k.endswith("_b")}
    if not b_max or not all(v > 0 for v in b_max.values()):
        raise AssertionError(f"gpt2-rl-lora: the published adapter's B "
                             f"did not move: {b_max}")
    greedy = SamplingParams(temperature=0.0, model_id="tenant-rl")
    got = engine.generate([prompt], LORA_NEW, greedy)[0]
    base_toks = engine.generate([prompt], LORA_NEW,
                                SamplingParams(temperature=0.0))[0]
    if not engine.leak_free():
        raise AssertionError("gpt2-rl-lora: the bank engine leaked")
    merged = lora_mod.merge_adapter(base, {k: v.to(dev) for k, v in
                                           adapter.items()}, cfg,
                                    scale=scale)
    ref_engine = InferenceEngine(cfg, merged, device=dev, telemetry=False)
    want_toks = ref_engine.generate([prompt], LORA_NEW,
                                    SamplingParams(temperature=0.0))[0]
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    merged32 = lora_mod.merge_adapter(
        to_cpu32(base), {k: v.float().cpu() for k, v in adapter.items()},
        cfg32, scale=scale)
    parted = parted_within_margin("gpt2-rl-lora tenant stream", prompt,
                                  got, want_toks, merged32, cfg32)
    with torch.inference_mode():
        ctx = torch.tensor(prompt)[None]
        shift = float((forward(merged32, ctx, cfg32)[0]
                       - forward(to_cpu32(base), ctx, cfg32)[0]).abs().max())
    differs = got != base_toks
    print(f"gpt2-rl-lora: the adapter's largest |B| "
          f"{max(b_max.values()):.3e}; it moves the f32 logits at the "
          f"prompt by up to {shift:.4f}; the tenant's greedy stream "
          f"{'differs from' if differs else 'equals'} the base's",
          flush=True)
    nbytes = adapter_nbytes(adapter)
    full = sum(t.numel() * t.element_size() for t in
               (v for x in base.values()
                for v in (x.values() if isinstance(x, dict) else [x])))
    metrics = {"cell": "gpt2-rl-lora", "steps": RL_LORA_STEPS,
               "rank": LORA_RANK, "published_version": version,
               "step_s_median": float(np.median(walls)),
               "adapter_bytes_per_publication": nbytes,
               "full_tree_bytes": full, "parted": parted,
               "adapter_b_max": max(b_max.values()),
               "adapter_logit_shift_f32": shift,
               "stream_differs_from_base": differs}
    print("gpt2-rl-lora: the base bit-unchanged, launches exact with no "
          "epilogue, the adapter moved, the tenant's stream the merged "
          "weights'", flush=True)
    print("gpt2-rl-lora metrics " + json.dumps(metrics), flush=True)
    del engine, ref_engine, learner, base, merged
    return launches


def rl_supervised_phase(dev) -> dict:
    """gpt2-rl-supervised: ``run_supervised_rl_loop`` for RL_SUP_STEPS
    steps under the fault plan RL_FAULTS with a ``TrainCheckpointer``
    every RL_CKPT_EVERY steps.  Gates: both faults fired, one actor and
    one learner restart, RL_SUP_STEPS records after the roll-back, the
    engines clean, exact launches (every engine's rollouts, the dead
    one's too, and every completed learner step), no kernel built after
    the replacement (0 by construction here).  Prints each
    fault's time to the next completed learner step and
    ``gpt2-rl-supervised metrics {...}``; returns the launches."""
    import shutil
    import tempfile

    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.resilience import (TrainCheckpointer,
                                          run_supervised_rl_loop)
    from ray_tpu_torch.util import chaos
    gc.collect()
    torch.cuda.empty_cache()
    cfg = rl_model()
    d = tempfile.mkdtemp(prefix="chip_smoke_rl_")
    probe = RLProbe()
    plan = chaos.install_faults(RL_FAULTS)
    try:
        _build.reset_launches()
        with TrainCheckpointer(d, every=0, keep=3) as ck:
            res = run_supervised_rl_loop(
                cfg, steps=RL_SUP_STEPS, rlcfg=rl_config(),
                prompt_len=RL_PROMPT, seed=RL_SEED, lr=RL_LR, ckpt=ck,
                ckpt_every=RL_CKPT_EVERY, device=dev, telemetry=True)
        torch.cuda.synchronize()
        launches = _build.launch_counts()
    finally:
        chaos.clear_faults()
        probe.close()
        shutil.rmtree(d, ignore_errors=True)
    rl_finite("gpt2-rl-supervised", res["history"])
    fired = sorted(plan.fired)
    if fired != [("rl.learner", 5), ("rl.rollout", 3)]:
        raise AssertionError(f"gpt2-rl-supervised: fired {fired}")
    if (res["actor_restarts"], res["learner_restarts"]) != (1, 1):
        raise AssertionError(f"gpt2-rl-supervised: restarts "
                             f"{res['actor_restarts']} actor, "
                             f"{res['learner_restarts']} learner")
    if len(res["reward_curve"]) != RL_SUP_STEPS:
        raise AssertionError(f"gpt2-rl-supervised: "
                             f"{len(res['reward_curve'])} records")
    stale = [w["version"] for w in probe.swaps if not w["held"]]
    if stale:
        raise AssertionError(f"gpt2-rl-supervised: after the swaps to "
                             f"versions {stale} an engine does not hold "
                             "the published weights")
    if not all(e.leak_free() for e in res["actors"]):
        raise AssertionError("gpt2-rl-supervised: an engine is not idle")
    # the dead engine's rollouts count too (the probe's calls), and only
    # the learner steps that completed launched
    expect_launches("gpt2-rl-supervised", launches,
                    add_launches(probe.rollout_launches(cfg),
                                 {k: n * len(probe.steps_done) for k, n in
                                  RL_STEP_LAUNCHES.items()}))
    # 0 by construction in the eager port (the library is built once per
    # process, before any engine launches): held as the reference holds
    # restart_compiles
    if res["restart_builds"] != [0]:
        raise AssertionError(f"gpt2-rl-supervised: the replacement engine "
                             f"built kernels {res['restart_builds']}")
    recover = {site: next((t - at for t in probe.steps_done if t > at),
                          None) for site, at in probe.faults}
    tel = res["telemetry"]
    metrics = {"cell": "gpt2-rl-supervised", "steps": RL_SUP_STEPS,
               "faults": RL_FAULTS, "fault_to_next_step_s": recover,
               "publishes": res["publishes"],
               "learner_steps_run": len(probe.steps_done),
               "learner_ms_per_step": 1e3 * tel["learner_step_s"],
               "checkpoint": {k: v for k, v in res["checkpoint"].items()
                              if not isinstance(v, (list, dict))},
               "restart_builds": res["restart_builds"]}
    print("gpt2-rl-supervised: both faults survived, one restart each, "
          "launches exact, no kernel built after the replacement",
          flush=True)
    print("gpt2-rl-supervised metrics " + json.dumps(metrics), flush=True)
    return launches


def rl_phases(dev) -> dict:
    """The RL phases, each driven with the counts at 0 just before it;
    returns their launches by path (gpt2-rl-group's are the rollout
    engine's: its learner launches in its actor)."""
    launches, publish_s = rl_phase(dev)
    paths = {"rl": launches}
    paths["rl_moving"], ref, ref_v2 = rl_moving_phase(dev)
    paths["rl_group"] = rl_group_phase(dev, ref, ref_v2, publish_s)
    paths["rl_lora"] = rl_lora_phase(dev)
    paths["rl_supervised"] = rl_supervised_phase(dev)
    return paths


# gpt2-profile: the profiled steps, and the symbol of one CUDA kernel
# each training entry point launches exactly once a call (bf16 at the
# training shape: the tensor-core attention, epilogue and flash-CE)
PROFILE_STEPS = 2
PROFILE_ANNOTATION = "train-step"
PROFILE_SYMBOLS = {
    "flash_attention_fwd": ("flash_fwd_tc_kernel",),
    "flash_attention_bwd": ("flash_dq_tc_kernel", "flash_dkv_tc_kernel"),
    "matmul_residual_norm_fwd": ("mrn_tc_kernel",),
    "matmul_residual_norm_bwd": ("mrn_bwd_da_kernel", "mrn_bwd_dw_kernel"),
    "flash_ce_fwd": ("ce_combine_kernel",),
    "flash_ce_bwd": ("ce_dscale_sum_kernel",)}


def _profile_warmup_kept(events: list, annotation: str) -> int:
    """How many of the launches under ``annotation`` (host side) have
    their GPU record in the trace: ``profile_device``'s warm-up burst
    less the records the session lost at its start."""
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("name") == annotation
             and e.get("cat") == "user_annotation"]
    gpu = {e.get("args", {}).get("correlation") for e in events
           if e.get("cat") in ("kernel", "gpu_memset", "gpu_memcpy")}
    return sum(1 for e in events
               if e.get("cat") in ("cuda_runtime", "cuda_driver")
               and "aunch" in e.get("name", "")
               and any(a <= e["ts"] <= b for a, b in spans)
               and e.get("args", {}).get("correlation") in gpu)


def profile_api_phase(dev) -> dict:
    """gpt2-profile: ``util.profiling.profile_device`` around
    PROFILE_STEPS steps of gpt2-train-b24 (2 unprofiled warm-up steps,
    then PROFILE_STEPS unprofiled and PROFILE_STEPS profiled, each under
    ``annotate(PROFILE_ANNOTATION)``).  Gates: one trace file, naming the
    annotation; each training entry point's kernels (PROFILE_SYMBOLS) in
    it as often as the entry point launched, which is exactly
    ``train_step_launches`` a step; ``device_memory_stats`` with the
    card's bytes in use > 0 and the peak at least that.  The main run
    takes it in its own long-lived process, after earlier profiler
    sessions, where a session loses its first GPU records
    (``profiling.WARMUP_OPS``); it prints how many of the warm-up's
    records the session kept.  Returns the profiled steps' launches."""
    import glob
    import tempfile

    from ray_tpu_torch import GPTConfig
    from ray_tpu_torch.models.training import (build_gpt_train,
                                               default_optimizer,
                                               synthetic_lm_batch)
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.util import profiling

    gc.collect()
    torch.cuda.empty_cache()
    cfg = GPTConfig.gpt2(**TRAIN_CFG, dtype=torch.bfloat16)
    fns = build_gpt_train(cfg, optimizer=default_optimizer(**TRAIN_OPT),
                          device=dev, telemetry=False)
    state = fns["init_fn"](torch.Generator().manual_seed(0))
    batch = synthetic_lm_batch(torch.Generator().manual_seed(1), TRAIN_B,
                               TRAIN_S, cfg.vocab_size, device=dev)

    def steps(n):
        nonlocal state
        losses = []
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for _ in range(n):
            with profiling.annotate(PROFILE_ANNOTATION):
                state, m = fns["step_fn"](state, batch)
            losses.append(m["loss"])
        torch.cuda.synchronize()
        return 1e3 * (time.monotonic() - t0) / n, [float(x) for x in losses]

    steps(2)
    plain_ms, _ = steps(PROFILE_STEPS)
    _build.reset_launches()
    with tempfile.TemporaryDirectory(prefix="gpt2_profile_") as tmp:
        t0 = time.monotonic()
        with profiling.profile_device(tmp) as logdir:
            prof_ms, losses = steps(PROFILE_STEPS)
        export_s = time.monotonic() - t0 - PROFILE_STEPS * prof_ms / 1e3
        launches = _build.launch_counts()
        traces = glob.glob(os.path.join(logdir, "*" + profiling.TRACE_SUFFIX))
        if len(traces) != 1:
            raise AssertionError(f"gpt2-profile: traces {traces}")
        trace_mb = os.path.getsize(traces[0]) / 2 ** 20
        with open(traces[0]) as f:
            events = json.load(f)["traceEvents"]
    expect_launches("gpt2-profile", launches,
                    {k: n * PROFILE_STEPS
                     for k, n in train_step_launches().items()})
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"gpt2-profile: losses {losses}")
    annotated = sum(1 for e in events
                    if e.get("name") == PROFILE_ANNOTATION)
    if annotated < PROFILE_STEPS:
        raise AssertionError(f"gpt2-profile: the trace names "
                             f"{PROFILE_ANNOTATION!r} {annotated} times")
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    counts = {sym: sum(1 for k in kernels if sym in k)
              for symbols in PROFILE_SYMBOLS.values() for sym in symbols}
    want = {sym: launches.get(entry, 0)
            for entry, symbols in PROFILE_SYMBOLS.items() for sym in symbols}
    if counts != want:
        raise AssertionError(f"gpt2-profile: kernels in the trace {counts}, "
                             f"launched {want}")
    warmup_kept = _profile_warmup_kept(events, profiling.WARMUP_ANNOTATION)
    stats = profiling.device_memory_stats()
    if len(stats) != torch.cuda.device_count():
        raise AssertionError(f"gpt2-profile: memory stats {stats}")
    mem = stats["cuda:0"]
    if not (mem["bytes_in_use"] > 0
            and mem["peak_bytes_in_use"] >= mem["bytes_in_use"]
            and mem["bytes_limit"] >= mem["peak_bytes_in_use"]):
        raise AssertionError(f"gpt2-profile: memory stats {mem}")
    metrics = {"cell": "gpt2-profile", "card": card(),
               "batch": [TRAIN_B, TRAIN_S], "steps": PROFILE_STEPS,
               "step_ms_unprofiled": plain_ms, "step_ms_profiled": prof_ms,
               "profiler_overhead": prof_ms / plain_ms - 1.0,
               "trace_export_s": export_s, "trace_mb": trace_mb,
               "kernel_events": len(kernels), "symbol_counts": counts,
               "annotations": annotated, "memory": mem,
               "warmup_ops": profiling.WARMUP_OPS,
               "warmup_records_kept": warmup_kept}
    print(f"gpt2-profile: the trace names {PROFILE_ANNOTATION!r} and each "
          f"training kernel as often as it launched; {plain_ms:.2f} ms a "
          f"step unprofiled, {prof_ms:.2f} profiled; the session kept "
          f"{warmup_kept} of the warm-up's {profiling.WARMUP_OPS} "
          f"records", flush=True)
    print("gpt2-profile metrics " + json.dumps(metrics), flush=True)
    return launches


# rllib on the card: the learners' updates against the CPU's (f32, TF32
# off): metrics within RLLIB_REL (RLLIB_ABS for those near 0), params
# within RLLIB_REL of each leaf's largest value; the learner group's two
# updates within RLLIB_GROUP_REL of the in-process learner's
RLLIB_REL = 1e-4
RLLIB_ABS = 1e-6
RLLIB_GROUP_REL = 1e-5
RLLIB_ENV_ITERS = 5


def _rllib_batches() -> dict:
    """Seeded fed batches at the reference's default shapes: PPO's 4
    runners x 256 CartPole steps, DQN's 64, IMPALA's 4 segments of 64,
    SAC's 256 Pendulum steps, BC's 256."""
    rng = np.random.default_rng(0)

    def f32(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    n = 4 * 256
    adv, values = f32(n), f32(n)
    ppo = {"obs": f32(n, 4), "actions": rng.integers(0, 2, n),
           "logp": np.log(rng.uniform(0.3, 0.7, n)).astype(np.float32),
           "values": values, "advantages": adv,
           "value_targets": adv + values}
    dqn = {"obs": f32(64, 4), "next_obs": f32(64, 4),
           "actions": rng.integers(0, 2, 64),
           "rewards": np.ones(64, np.float32),
           "terminateds": (rng.random(64) < 0.05).astype(np.float32)}
    B, T = 4, 64
    impala = {"obs": f32(B, T, 4), "actions": rng.integers(0, 2, (B, T)),
              "logp": np.log(rng.uniform(0.2, 0.8, (B, T))).astype(
                  np.float32),
              "values": f32(B, T), "rewards": np.ones((B, T), np.float32),
              "terminateds": (rng.random((B, T)) < 0.05).astype(
                  np.float32),
              "bootstrap_value": f32(B)}
    sac = {"obs": f32(256, 3), "next_obs": f32(256, 3),
           "actions": rng.uniform(-2, 2, (256, 1)).astype(np.float32),
           "rewards": f32(256, scale=3.0),
           "terminateds": np.zeros(256, np.float32)}
    bc = {"obs": f32(256, 4), "actions": rng.integers(0, 2, 256)}
    return {"ppo": ppo, "dqn": dqn, "impala": impala, "sac": sac,
            "bc": bc, "sac_noise": f32(2, 256, 1)}


def _rllib_compare(name, run, dev) -> dict:
    """``run(device) -> (params before, params after, metrics)`` on the
    card and on the CPU from the same draws: the gates above; returns the
    card's update ms (a fresh learner's, after one untimed run on the
    card), the CPU's, and the largest shares."""
    from ray_tpu_torch.models.training import _leaves
    t0 = time.monotonic()
    cpu_before, cpu_after, cpu_m = run("cpu")
    cpu_ms = 1e3 * (time.monotonic() - t0)
    run(dev)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    before, after, m = run(dev)
    torch.cuda.synchronize()
    ms = 1e3 * (time.monotonic() - t0)
    for k, v in cpu_m.items():
        got = float(m[k])
        if not (math.isfinite(got)
                and abs(got - float(v)) <= RLLIB_ABS + RLLIB_REL * abs(
                    float(v))):
            raise AssertionError(f"rllib {name}: metric {k} {got} on the "
                                 f"card, {float(v)} on the CPU")
    moved = max(float((a.cpu() - b.cpu()).abs().max())
                for a, b in zip(_leaves(after), _leaves(before)))
    if not moved > 0:
        raise AssertionError(f"rllib {name}: the parameters did not move")
    share = 0.0
    for a, b in zip(_leaves(after), _leaves(cpu_after)):
        top = float(b.abs().max())
        if top:
            share = max(share, float((a.cpu() - b).abs().max()) / top)
    if not share <= RLLIB_REL:
        raise AssertionError(f"rllib {name}: params part from the CPU's by "
                             f"{share:.3e} of a leaf's largest value")
    return {"update_ms": ms, "cpu_update_ms": cpu_ms, "param_share": share,
            "moved": moved}


def _rllib_learners(dev) -> dict:
    """One update of each learner on the card against the CPU's."""
    from ray_tpu_torch.models.training import _leaves, _rebuild
    from ray_tpu_torch.rllib.algorithms import bc, dqn, impala, ppo, sac
    from ray_tpu_torch.rllib.core import rl_module as rm
    data = _rllib_batches()

    def init(module, device):
        return module.init_params(torch.Generator().manual_seed(0),
                                 device=device)

    def snap(tree):
        return _rebuild(tree, [t.detach().clone() for t in _leaves(tree)])

    disc = rm.DiscreteMLPModule(rm.MLPModuleConfig())

    def run_ppo(device):
        lr = ppo.PPOLearner(disc, ppo.PPOConfig(), device=device)
        params = init(disc, device)
        before = snap(params)
        params, _o, m = lr.update(params, lr.tx.init(params), data["ppo"])
        return before, params, m

    def run_dqn(device):
        lr = dqn.DQNLearner(disc, dqn.DQNConfig(), device=device)
        params = init(disc, device)
        target = disc.init_params(torch.Generator().manual_seed(1),
                                  device=device)
        before = snap(params)
        params, _o, m = lr.update(params, target, lr.tx.init(params),
                                  data["dqn"])
        return before, params, m

    def run_impala(device):
        lr = impala.IMPALALearner(disc, impala.IMPALAConfig(), device=device)
        params = init(disc, device)
        before = snap(params)
        params, _o, m = lr.update(params, lr.tx.init(params),
                                  data["impala"])
        return before, params, m

    def run_bc(device):
        lr = bc.BCLearner(disc, bc.BCConfig(), device=device)
        params = init(disc, device)
        before = snap(params)
        params, _o, loss, acc = lr.update(params, lr.tx.init(params),
                                          data["bc"]["obs"],
                                          data["bc"]["actions"])
        return before, params, {"loss": loss, "action_accuracy": acc}

    ccfg = rm.ContinuousModuleConfig(act_low=(-2.0,), act_high=(2.0,))
    actor, critic = rm.SquashedGaussianModule(ccfg), rm.TwinQModule(ccfg)

    def run_sac(device):
        lr = sac.SACLearner(actor, critic, sac.SACConfig(), device=device)
        st = lr.init_state(torch.Generator().manual_seed(0))
        before = snap({"actor": st.actor, "critic": st.critic})
        st, m = lr.update(st, data["sac"], data["sac_noise"])
        return before, {"actor": st.actor, "critic": st.critic}, m

    out = {}
    for name, run in (("ppo", run_ppo), ("dqn", run_dqn),
                      ("impala", run_impala), ("sac", run_sac),
                      ("bc", run_bc)):
        out[name] = _rllib_compare(name, run, dev)
        print(f"rllib {name}: the card's update equals the CPU's (params "
              f"within {out[name]['param_share']:.3e} of a leaf's largest "
              f"value); {out[name]['update_ms']:.2f} ms on the card, "
              f"{out[name]['cpu_update_ms']:.2f} on the CPU", flush=True)
    return out


def _rllib_group(dev) -> dict:
    """A LearnerGroup of one ``num_gpus_per_learner=1`` PPO learner (the
    default learner_cls) under a port session: two updates against an
    in-process PPO learner on the card from the same seed."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.models.training import _leaves
    from ray_tpu_torch.rllib.algorithms.ppo import PPOConfig, PPOLearner
    from ray_tpu_torch.rllib.core.learner_group import LearnerGroup
    from ray_tpu_torch.rllib.core.rl_module import (DiscreteMLPModule,
                                                    MLPModuleConfig)
    data = _rllib_batches()["ppo"]
    cfg = PPOConfig(seed=3)
    module = DiscreteMLPModule(MLPModuleConfig())
    solo = PPOLearner(module, cfg, device=dev)
    params, opt = solo.init_state(torch.Generator().manual_seed(3))
    rt.init(num_cpus=RUNTIME_CPUS)
    try:
        t0 = time.monotonic()
        group = LearnerGroup(module, cfg, num_learners=1,
                             num_gpus_per_learner=1)
        cold = time.monotonic() - t0
        try:
            rows = []
            for i in range(2):
                half = {k: v[i * 512:(i + 1) * 512] for k, v in data.items()}
                got = group.update(half)
                params, opt, want = solo.update(params, opt, half)
                rows.append(max(abs(got[k] - want[k]) / max(abs(want[k]),
                                                            1e-30)
                                for k in want))
            remote = group.get_params()
        finally:
            group.stop()
    finally:
        rt.shutdown()
    share = max(float((a - b.cpu()).abs().max()) / float(b.abs().max())
                for a, b in zip(_leaves(remote), _leaves(params)))
    if not (max(rows) <= RLLIB_GROUP_REL and share <= RLLIB_GROUP_REL):
        raise AssertionError(f"rllib group: metrics {rows}, params {share}")
    print(f"rllib group: one num_gpus_per_learner=1 PPO learner actor, "
          f"two updates equal the in-process learner's (metrics {rows}, "
          f"params {share:.3e}); cold start {cold:.2f} s", flush=True)
    return {"cold_start_s": cold, "metric_rel": rows, "param_share": share}


def _rllib_env_arm(dev) -> dict:
    """PPO on CartPole-v1 for RLLIB_ENV_ITERS iterations with its learner
    on the card, where ``gymnasium`` imports."""
    import importlib.util

    import ray_tpu_torch as rt
    from ray_tpu_torch.rllib.algorithms.ppo import PPOConfig
    if importlib.util.find_spec("gymnasium") is None:
        print("rllib env arm: not run (gymnasium missing)", flush=True)
        return {"run": False, "reason": "gymnasium missing"}
    rt.init(num_cpus=RUNTIME_CPUS)
    try:
        algo = PPOConfig().environment("CartPole-v1").build()
        try:
            t0 = time.monotonic()
            rows = [algo.train() for _ in range(RLLIB_ENV_ITERS)]
            wall = time.monotonic() - t0
        finally:
            algo.stop()
    finally:
        rt.shutdown()
    curve = [r["episode_return_mean"] for r in rows]
    if not all(math.isfinite(r["learner/total_loss"]) for r in rows):
        raise AssertionError(f"rllib env arm: {rows}")
    steps = rows[-1]["timesteps_total"]
    print(f"rllib env arm: PPO on CartPole-v1, returns {curve}, "
          f"{steps / wall:.1f} steps/s", flush=True)
    return {"run": True, "episode_return_mean": curve,
            "steps_per_s": steps / wall}


def rllib_phase(dev) -> None:
    """rllib: the learners on fed batches, the learner group and the
    env arm; prints ``rllib metrics {...}``."""
    gc.collect()
    torch.cuda.empty_cache()
    metrics = {"cell": "rllib", "card": card(),
               "learners": _rllib_learners(dev),
               "group": _rllib_group(dev), "env": _rllib_env_arm(dev)}
    print("rllib metrics " + json.dumps(metrics), flush=True)


# ---------------------------------------------------------------------------
# 17-18. the GPT-2 exact architecture (train/huggingface), ResNet, MLP
# ---------------------------------------------------------------------------

HF_B, HF_S, HF_V = 8, 1024, 50257       # gpt2-hf-train's batch; HF's vocab
HF_SEED = 0
HF_NEW = 32
HF_PROMPTS = (64, 512)                  # gpt2-hf-serve's prompt lengths
HF_ARGS = dict(seq_len=HF_S, per_device_train_batch_size=HF_B,
               max_steps=10, logging_steps=1, save_steps=10,
               learning_rate=1e-3)
HF_TIMED_FROM = 3                       # the steps timed: 3 .. max_steps
# a step of the exact architecture: attention (no RoPE) per layer and
# flash-CE without the prologue (LayerNorm with a bias); the epilogue
# declines LayerNorm and biases
HF_LAUNCHES = {"flash_attention_fwd": 12, "flash_attention_bwd": 12,
               "flash_ce_fwd": 1, "flash_ce_bwd": 1}
RESNET_B, RESNET_IMAGE = 64, 224
RESNET_WARMUP, RESNET_TIMED = 2, 8
# the card against the CPU in f32 (TF32 off): the loss within 1e-4
# relative; each gradient and new running statistic within 1e-4 of its
# leaf's largest value, floor 1e-6 (a bias before a BatchNorm has a zero
# gradient in exact arithmetic and holds only rounding noise)
CARD_CPU_REL, CARD_CPU_FLOOR = 1e-4, 1e-6


def norope_attention_checks(rec: Recorder, randn, dev, B: int,
                            H: int = TRAIN_H) -> dict:
    """The attention pair without RoPE (learned positions) at [B, 1024,
    H, 64], bf16 against its plain version (forward in f32, backward in
    f64, ``bwd_reference``) on the same inputs at the bounds above;
    extra shapes of the rows; returns the times."""
    import torch.nn.functional as F

    from ray_tpu_torch.ops import attention as A

    S, D = TRAIN_S, TRAIN_D
    shape = [B, S, H, D, "no-rope"]
    scale = D ** -0.5
    q, k, v, do = (randn(B, S, H, D) for _ in range(4))
    o, lse = A.flash_attention_fwd(q, k, v, scale=scale)
    o_ref, lse_ref = A.plain_flash_attention_fwd(*_f32(q, k, v),
                                                 scale=scale)
    torch.cuda.synchronize()
    what = f"flash_attention_fwd no-rope [{B},{S},{H},{D}]"
    err = max(check(f"{what} o", o, o_ref, **BF16_TOL),
              check(f"{what} lse", lse, lse_ref, **LSE_TOL))
    del o_ref, lse_ref
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
    tokens = B * S * H * D
    times = {"fwd_ms": time_ms(lambda: A.flash_attention_fwd(
        q, k, v, scale=scale), 5)}
    rec.record("flash_attention_fwd", shape, err, times["fwd_ms"],
               time_ms(lambda: A.plain_flash_attention_fwd(
                   q, k, v, scale=scale), 3),
               time_ms(lambda: F.scaled_dot_product_attention(
                   qt, kt, vt, is_causal=True), 5),
               4 * tokens * 2 + B * H * S * 4,
               4 * B * H * D * S * (S + 1) / 2,
               "ray_tpu_torch/ops/csrc/flash_attention_fwd.cu",
               "ray_tpu/ops/attention.py:477", own=False)
    grads = A.flash_attention_bwd(q, k, v, o, lse, do, scale=scale)
    refs = bwd_reference(q.float(), k.float(), v, o, lse, do, scale, None)
    torch.cuda.synchronize()
    what = f"flash_attention_bwd no-rope [{B},{S},{H},{D}]"
    err = max(check(f"{what} {n}", x, y, **GRAD_BF16_TOL)
              for n, x, y in zip(("dq", "dk", "dv"), grads, refs))
    del grads, refs
    torch.cuda.empty_cache()

    def sdpa_fwd_bwd():
        a, b, c = (x.detach().requires_grad_(True) for x in (qt, kt, vt))
        F.scaled_dot_product_attention(a, b, c, is_causal=True).backward(dot)

    times["bwd_ms"] = time_ms(lambda: A.flash_attention_bwd(
        q, k, v, o, lse, do, scale=scale), 5)
    rec.record("flash_attention_bwd", shape, err, times["bwd_ms"],
               time_ms(lambda: A.plain_flash_attention_bwd(
                   q, k, v, o, lse, do, scale=scale), 3),
               time_ms(sdpa_fwd_bwd, 5),
               8 * tokens * 2 + B * H * S * 4,
               5 * 2 * B * H * D * S * (S + 1) / 2,
               "ray_tpu_torch/ops/csrc/flash_attention_bwd.cu",
               "ray_tpu/ops/attention.py:925", own=False)
    del q, k, v, do, o, lse, qt, kt, vt, dot
    torch.cuda.empty_cache()
    return times


def hf_shape_phase(rec: Recorder, dev) -> None:
    """The kernels at gpt2-hf-train's shapes: the attention pair without
    RoPE at [8, 1024, 12, 64], and flash-CE forward and backward at N =
    8 x 1024, d = 768, V = 50257 (392 full 128-column vocab tiles and
    one of 81) without the prologue, bf16 against the plain versions in
    f32 at the bounds above, as extra shapes of their rows."""
    g = torch.Generator(device=dev).manual_seed(9)
    randn = _randn(g, dev)
    times = norope_attention_checks(rec, randn, dev, HF_B)
    flash_ce_checks(rec, randn, g, dev, HF_B * HF_S, own=False, V=HF_V,
                    norm=False)
    print(f"gpt2-hf-train attention [{HF_B},{TRAIN_S},{TRAIN_H},{TRAIN_D}]"
          f" without RoPE on {card()}: " + json.dumps(times), flush=True)


def hf_model():
    """GPT-2 124M in the exact architecture: (the HF model or None, the
    port's config, its parameters as numpy f32 leaves).  A seeded
    ``GPT2LMHeadModel(GPT2Config())`` through ``port_gpt2`` where
    ``transformers`` imports; else the port's ``init_params`` on the same
    config."""
    from ray_tpu_torch.convert import params_to_numpy
    from ray_tpu_torch.models.gpt import init_params
    from ray_tpu_torch.train.huggingface import gpt2_config, port_gpt2
    try:
        from transformers import GPT2Config, GPT2LMHeadModel
    except ImportError:
        import types
        print("hf arm: transformers missing, port init used", flush=True)
        cfg = gpt2_config(types.SimpleNamespace(
            vocab_size=HF_V, n_embd=768, n_layer=12, n_head=12,
            n_positions=1024))
        params = init_params(cfg, torch.Generator().manual_seed(HF_SEED),
                             device="cpu")
        return None, cfg, params_to_numpy(params)
    import transformers
    torch.manual_seed(HF_SEED)
    hf = GPT2LMHeadModel(GPT2Config()).eval()
    cfg, params = port_gpt2(hf, dtype=torch.bfloat16)
    print(f"hf arm: transformers {transformers.__version__}, a seeded "
          "GPT2LMHeadModel(GPT2Config()) through port_gpt2", flush=True)
    return hf, cfg, params


def hf_state_dict(params, cfg):
    """``port_gpt2``'s inverse on numpy leaves: an HF GPT-2 state dict
    (``Conv1D`` weights ``[in, out]``), for ``TransformersTrainer``'s
    ``(state_dict, config)`` input where ``transformers`` is missing."""
    d = cfg.d_model
    sd = {"transformer.wte.weight": params["embed"],
          "transformer.wpe.weight": params["pos_embed"],
          "transformer.ln_f.weight": params["ln_f"],
          "transformer.ln_f.bias": params["ln_f_b"]}
    names = {"ln_1.weight": "ln1", "ln_1.bias": "ln1_b",
             "ln_2.weight": "ln2", "ln_2.bias": "ln2_b",
             "attn.c_proj.bias": "bo", "mlp.c_fc.weight": "w1",
             "mlp.c_fc.bias": "b1", "mlp.c_proj.weight": "w2",
             "mlp.c_proj.bias": "b2"}
    for i in range(cfg.n_layers):
        lay = {k: v[i] for k, v in params["layers"].items()}
        pre = f"transformer.h.{i}."
        sd[pre + "attn.c_attn.weight"] = np.concatenate(
            [lay[w].reshape(d, d) for w in ("wq", "wk", "wv")], 1)
        sd[pre + "attn.c_attn.bias"] = np.concatenate(
            [lay[b].reshape(d) for b in ("bq", "bk", "bv")])
        sd[pre + "attn.c_proj.weight"] = lay["wo"].reshape(d, d)
        sd.update({pre + hf: lay[ours] for hf, ours in names.items()})
    return sd


def hf_serve_phase(dev, cfg, params_np) -> dict:
    """gpt2-hf-serve: GPT-2 124M in the exact architecture (LayerNorm,
    gelu, learned positions, biases, tied head, V 50257, bf16) serves 8
    greedy requests (prompts of 64-512 tokens, HF_NEW new tokens each)
    through the paged-KV engine at the main path's settings (8 slots,
    page 128; the engine keeps its logits for the check).  Gates: every
    request finished, leak-free, no prefix hit, the engine's logits
    against the f32 CPU forward at the serving gates, greedy tokens its
    argmax where the margin is wide, and exact launches: prefill and
    decode attention as the calls imply, the epilogue 0 (it declines
    LayerNorm and biases).  Prints ``gpt2-hf-serve metrics {...}`` and
    returns the launches."""
    from ray_tpu_torch import InferenceEngine

    params = {k: ({kk: torch.from_numpy(vv).to(dev, cfg.dtype)
                   for kk, vv in v.items()} if isinstance(v, dict)
                  else torch.from_numpy(v).to(dev, cfg.dtype))
              for k, v in params_np.items()}
    engine = InferenceEngine(cfg, params, device=dev, debug_logits=True,
                             **ENGINE)
    no_gather_in_decode(engine)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, HF_V, n).tolist()
               for n in rng.integers(HF_PROMPTS[0], HF_PROMPTS[1] + 1, 8)]
    run = serve(engine, prompts, [None] * len(prompts), HF_NEW)
    calls, L = run["calls"], cfg.n_layers
    if calls["prefill"] != len(prompts) or calls["prefill_cached"]:
        raise AssertionError(f"gpt2-hf-serve: calls {calls}, want "
                             f"{len(prompts)} cold prefills")
    expect_launches("gpt2-hf-serve", run["launches"],
                    {"flash_attention_fwd": L * calls["prefill"],
                     "decode_attention": L * calls["decode"]})
    acc = against_reference(
        "gpt2-hf-serve", engine, to_cpu32(params),
        dataclasses.replace(cfg, dtype=torch.float32), prompts,
        [run["out"][r] for r in run["rids"]], ENGINE_TOL, ENGINE_MEAN_TOL,
        rids=run["rids"])
    dec_s, pre_s = run["secs"]["decode"], run["secs"]["prefill"]
    metrics = {
        "cell": "gpt2-hf-serve", "card": card(), "requests": len(prompts),
        "prompt_tokens": [len(p) for p in prompts],
        "mean_ttft_ms": 1e3 * float(np.mean(list(run["ttft"].values()))),
        "prefill_ms": 1e3 * pre_s / calls["prefill"],
        "decode_step_ms": 1e3 * dec_s / calls["decode"],
        "decode_tokens_per_s": sum(len(v) - 1 for v in
                                   run["out"].values()) / dec_s,
        "debug_logits": True, "wall_s": run["wall"], **acc}
    print(f"gpt2-hf-serve: 8 requests finished, leak-free; launches "
          f"{launches_line(run['launches'])} == implied (the epilogue "
          "declined)", flush=True)
    print("gpt2-hf-serve metrics " + json.dumps(metrics), flush=True)
    return run["launches"]


def hf_train_phase(dev, hf, cfg, params_np) -> dict:
    """gpt2-hf-train: ``TransformersTrainer`` on the same model (the HF
    model itself, or its state dict and config), one ``num_gpus=1``
    worker, its default loop: HF_ARGS over one seeded HF_B x (HF_S + 1)
    window repeated, so that the loss must fall.  Gates: no error, 10
    steps reported with finite losses, the first within 0.5 of ln 50257
    and the last below it, a checkpoint, and in the worker each step
    launching HF_LAUNCHES exactly (flash-CE forward and backward once, the
    epilogue never).  Prints the worker's ms/step over steps 3-10,
    tokens/s, peak GiB and MFU (``gpt_train_flops_per_token`` of the
    exact architecture: gelu's two FFN matmuls, V 50257, the head once
    more for flash-CE's recompute) as ``gpt2-hf-train metrics {...}``;
    returns the launches summed over the steps."""
    import shutil
    import tempfile
    import types

    import ray_tpu_torch as rt
    from ray_tpu_torch.telemetry import flops
    from ray_tpu_torch.train import RunConfig, ScalingConfig
    from ray_tpu_torch.train.huggingface import TransformersTrainer
    from ray_tpu_torch.train.torch import TorchConfig

    rng = np.random.default_rng(HF_SEED + 1)
    # the packer appends eos to every row: one row is one window
    stream = rng.integers(0, HF_V, HF_B * (HF_S + 1) - 1)
    model = hf if hf is not None else (hf_state_dict(params_np, cfg),
                                       types.SimpleNamespace(
                                           vocab_size=cfg.vocab_size,
                                           n_embd=cfg.d_model,
                                           n_layer=cfg.n_layers,
                                           n_head=cfg.n_heads,
                                           n_positions=cfg.max_seq))
    storage = tempfile.mkdtemp(prefix="gpt2_hf_train_runs_")
    rt.init(num_cpus=RUNTIME_CPUS)
    try:
        trainer = TransformersTrainer(
            model=model, token_stream=stream, training_args=HF_ARGS,
            dtype=torch.bfloat16,
            backend_config=TorchConfig(host_collective=False),
            scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
            run_config=RunConfig(name="gpt2-hf-train",
                                 storage_path=storage))
        t0 = time.time()
        result = trainer.fit()
        fit_s = time.time() - t0
    finally:
        rt.shutdown()
    shutil.rmtree(storage, ignore_errors=True)
    if result.error is not None:
        raise AssertionError(f"gpt2-hf-train failed: {result.error}")
    hist = result.metrics_history
    losses = [h["loss"] for h in hist]
    if [h["step"] for h in hist] != list(range(1, HF_ARGS["max_steps"] + 1)):
        raise AssertionError("gpt2-hf-train steps "
                             f"{[h['step'] for h in hist]}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"gpt2-hf-train: non-finite loss {losses}")
    if abs(losses[0] - math.log(HF_V)) > 0.5 or not losses[-1] < losses[0]:
        raise AssertionError(f"gpt2-hf-train: losses {losses} (first not "
                             f"near ln {HF_V}, or no fall)")
    if result.checkpoint is None:
        raise AssertionError("gpt2-hf-train: no checkpoint reported")
    launches = collections.Counter()
    for h in hist:
        if h["kernel_launches"] != HF_LAUNCHES:
            raise AssertionError(f"gpt2-hf-train step {h['step']}: "
                                 f"launches {h['kernel_launches']} != "
                                 f"{HF_LAUNCHES}")
        launches.update(h["kernel_launches"])
    timed = [h["step_ms"] for h in hist[HF_TIMED_FROM - 1:]]
    step_ms = float(np.mean(timed))
    tok_s = HF_B * HF_S * 1e3 / step_ms
    fpt = flops.gpt_train_flops_per_token(cfg, HF_S, ce_recompute=True)
    metrics = {
        "cell": "gpt2-hf-train", "card": card(), "batch": [HF_B, HF_S],
        "source": "transformers" if hf is not None else "port init",
        "fit_s": fit_s, "losses": losses,
        "worker_step_ms": step_ms, "worker_step_ms_each": timed,
        "tokens_per_s": tok_s, "train_flops_per_token": fpt,
        "mfu": flops.mfu(tok_s, fpt),
        "peak_gib": hist[-1].get("peak_memory_gib")}
    print(f"gpt2-hf-train: 10 steps in a num_gpus=1 worker, loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}, checkpoint reported; "
          f"launches per step {HF_LAUNCHES} exact; {fpt:.0f} FLOPs a "
          "token", flush=True)
    print("gpt2-hf-train metrics " + json.dumps(metrics), flush=True)
    return dict(launches)


def hf_phases(dev) -> dict:
    """gpt2-hf-serve and gpt2-hf-train on one model; returns their
    launches by path."""
    hf, cfg, params_np = hf_model()
    paths = {"serve_hf": hf_serve_phase(dev, cfg, params_np)}
    gc.collect()
    torch.cuda.empty_cache()
    paths["train_hf"] = hf_train_phase(dev, hf, cfg, params_np)
    return paths


def resnet_worker_loop(config: dict) -> None:
    """resnet50-train's loop, in the train worker (by reference from this
    file): ``ResNet50(num_classes=1000)`` in bf16 (f32 BatchNorm
    statistics) through ``build_resnet_train(model, make_mesh(dp=-1))``,
    RESNET_WARMUP + RESNET_TIMED steps on one seeded batch of RESNET_B
    224 x 224 x 3 images; reports the losses, the timed ms/step, the
    peak memory and whether every running statistic is finite and
    moved."""
    from ray_tpu_torch import train
    from ray_tpu_torch.models.resnet import ResNet50, build_resnet_train
    from ray_tpu_torch.parallel.mesh import make_mesh

    torch_flags()
    dev = torch.device("cuda")
    model = ResNet50(num_classes=1000, dtype=torch.bfloat16)
    fns = build_resnet_train(model, make_mesh(dp=-1), lr=0.1, device=dev)
    state = fns["init_fn"](torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in
              _flat_tree(state["batch_stats"]).items()}
    g = torch.Generator(device=dev).manual_seed(1)
    images = torch.randn(RESNET_B, RESNET_IMAGE, RESNET_IMAGE, 3,
                         generator=g, device=dev)
    labels = torch.randint(0, 1000, (RESNET_B,), generator=g, device=dev)
    torch.cuda.reset_peak_memory_stats()
    losses = []
    for i in range(RESNET_WARMUP + RESNET_TIMED):
        if i == RESNET_WARMUP:
            torch.cuda.synchronize()
            t0 = time.monotonic()
        state, m = fns["step_fn"](state, (images, labels))
        losses.append(m["loss"])
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    after = _flat_tree(state["batch_stats"])
    train.report({
        "losses": [float(x) for x in losses],
        "step_ms": 1e3 * wall / RESNET_TIMED,
        "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "stats_leaves": len(after),
        "stats_finite": sum(bool(torch.isfinite(v).all())
                            for v in after.values()),
        "stats_moved": sum(bool((v != before[k]).any())
                           for k, v in after.items()),
        "pid": os.getpid()})


def resnet_train_phase(dev) -> None:
    """resnet50-train: BASELINE config 3 at a world of 1, a
    ``TorchTrainer`` of one ``num_gpus=1`` worker running
    ``resnet_worker_loop``.  Gates: finite losses, the last below the
    first, every running statistic finite and moved.  Prints
    ``resnet50-train metrics {...}`` (ms/step, images/s, peak GiB)."""
    import shutil
    import tempfile

    import ray_tpu_torch as rt
    from ray_tpu_torch.train import RunConfig, ScalingConfig
    from ray_tpu_torch.train.torch import TorchConfig, TorchTrainer

    import chip_smoke
    storage = tempfile.mkdtemp(prefix="resnet50_train_runs_")
    rt.init(num_cpus=RUNTIME_CPUS)
    try:
        trainer = TorchTrainer(
            chip_smoke.resnet_worker_loop,
            torch_config=TorchConfig(host_collective=False),
            scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
            run_config=RunConfig(name="resnet50-train",
                                 storage_path=storage))
        t0 = time.time()
        result = trainer.fit()
        fit_s = time.time() - t0
    finally:
        rt.shutdown()
    shutil.rmtree(storage, ignore_errors=True)
    if result.error is not None:
        raise AssertionError(f"resnet50-train failed: {result.error}")
    rep = result.metrics
    losses = rep["losses"]
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"resnet50-train: losses {losses}")
    n = rep["stats_leaves"]
    if rep["stats_finite"] != n or rep["stats_moved"] != n:
        raise AssertionError(f"resnet50-train: of {n} running statistics "
                             f"{rep['stats_finite']} finite, "
                             f"{rep['stats_moved']} moved")
    metrics = {"cell": "resnet50-train", "card": card(),
               "batch": [RESNET_B, RESNET_IMAGE, RESNET_IMAGE, 3],
               "dtype": "bf16, f32 BatchNorm statistics", "fit_s": fit_s,
               "losses": losses, "step_ms": rep["step_ms"],
               "images_per_s": RESNET_B * 1e3 / rep["step_ms"],
               "peak_gib": rep["peak_gib"]}
    print(f"resnet50-train: {len(losses)} steps in a num_gpus=1 worker, "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}, all {n} running "
          "statistics finite and moved", flush=True)
    print("resnet50-train metrics " + json.dumps(metrics), flush=True)


def _card_cpu_close(what, card_tree, cpu_tree) -> float:
    """Raise unless each leaf of the card's tree is within CARD_CPU_REL of
    the CPU leaf's largest value (floor CARD_CPU_FLOOR); returns the
    largest share of that bound used."""
    a, b = _flat_tree(card_tree), _flat_tree(cpu_tree)
    if a.keys() != b.keys():
        raise AssertionError(f"{what}: trees differ")
    share = 0.0
    for k, ref in b.items():
        err = (a[k].cpu().float() - ref.float()).abs().max().item()
        tol = max(CARD_CPU_REL * ref.abs().max().item(), CARD_CPU_FLOOR)
        share = max(share, err / tol)
        if err > tol:
            raise AssertionError(f"{what} {k}: card-CPU error {err:.3e} "
                                 f"> {tol:.3e}")
    return share


def resnet_mlp_card_cpu_arm(dev) -> None:
    """One ``ResNet18(num_classes=10)`` step at 32 x 32, f32, batch 8, and
    one ``build_mlp_train`` step at Fashion-MNIST's shape (784 -> 128 ->
    128 -> 10, batch 256), on the card and on the CPU from the same
    parameters in flax's layout (``convert.resnet_params_from_flax``,
    ``mlp_params_from_flax``), TF32 off: the loss within CARD_CPU_REL,
    every gradient (the SGD trace after one step; Adam's first moment
    over 1 - b1) and new running statistic within CARD_CPU_REL of its
    leaf's largest value.  Prints ``card-cpu metrics {...}``."""
    from ray_tpu_torch.convert import (mlp_params_from_flax,
                                       resnet_params_from_flax)
    from ray_tpu_torch.models import mlp as M
    from ray_tpu_torch.models import resnet as R

    if torch.backends.cudnn.allow_tf32 or \
            torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("card-cpu arm: TF32 is on")
    model = R.ResNet18(num_classes=10)
    port = model.init(torch.Generator().manual_seed(3), device="cpu")
    flax = {part: {k: v.numpy().transpose(2, 3, 1, 0) if v.dim() == 4
                   else v.numpy() for k, v in _flat_tree(tree).items()}
            for part, tree in port.items()}

    def nest(flat):
        out = {}
        for path, v in flat.items():
            node = out
            *head, last = path.split("/")
            for k in head:
                node = node.setdefault(k, {})
            node[last] = v
        return out

    flax = {part: nest(tree) for part, tree in flax.items()}
    rng = np.random.default_rng(4)
    images = torch.from_numpy(rng.standard_normal((8, 32, 32, 3)).astype(
        np.float32))
    labels = torch.from_numpy(rng.integers(0, 10, 8))
    runs = {}
    for where in ("cpu", dev):
        fns = R.build_resnet_train(model, lr=0.1, device=where)
        st = fns["init_fn"](variables=resnet_params_from_flax(
            flax, device=where))
        t0 = time.monotonic()
        st, m = fns["step_fn"](st, (images.to(where), labels.to(where)))
        loss = float(m["loss"])
        runs[str(where)] = (loss, st["opt_state"], st["batch_stats"],
                            1e3 * (time.monotonic() - t0))
    (l_cpu, g_cpu, s_cpu, ms_cpu), (l_card, g_card, s_card, ms_card) = \
        runs["cpu"], runs[str(dev)]
    if abs(l_card - l_cpu) > CARD_CPU_REL * abs(l_cpu):
        raise AssertionError(f"resnet18 card-cpu: loss {l_card} vs {l_cpu}")
    shares = {"resnet18_grads": _card_cpu_close("resnet18 grad", g_card,
                                                g_cpu),
              "resnet18_batch_stats": _card_cpu_close("resnet18 stats",
                                                      s_card, s_cpu)}

    mlp = M.MLP()
    base = mlp.init_params(torch.Generator().manual_seed(5), "cpu")
    flax_mlp = {f"Dense_{i}": {"kernel": base[f"Dense_{i}.weight"].T.numpy(),
                               "bias": base[f"Dense_{i}.bias"].numpy()}
                for i in range(3)}
    x = torch.from_numpy(rng.standard_normal((256, 784)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 10, 256))
    mlp_runs = {}
    for where in ("cpu", dev):
        fns = M.build_mlp_train(M.MLP(), lr=1e-3, device=where)
        st = fns["init_fn"](params=mlp_params_from_flax(flax_mlp,
                                                        device=where))
        st, m = fns["step_fn"](st, (x.to(where), y.to(where)))
        mlp_runs[str(where)] = (float(m["loss"]), {
            k: v / 0.1 for k, v in st["opt_state"].mu.items()})
    (ml_cpu, mg_cpu), (ml_card, mg_card) = mlp_runs["cpu"], \
        mlp_runs[str(dev)]
    if abs(ml_card - ml_cpu) > CARD_CPU_REL * abs(ml_cpu):
        raise AssertionError(f"mlp card-cpu: loss {ml_card} vs {ml_cpu}")
    shares["mlp_grads"] = _card_cpu_close("mlp grad", mg_card, mg_cpu)
    metrics = {"card": card(), "resnet18_loss": [l_card, l_cpu],
               "resnet18_step_ms": [ms_card, ms_cpu],
               "mlp_loss": [ml_card, ml_cpu], "share_of_tol": shares}
    print("card-cpu: ResNet-18 and MLP steps on the card equal the CPU's "
          "(TF32 off)", flush=True)
    print("card-cpu metrics " + json.dumps(metrics), flush=True)


def resnet_phases(dev) -> None:
    resnet_train_phase(dev)
    gc.collect()
    torch.cuda.empty_cache()
    resnet_mlp_card_cpu_arm(dev)


# gpt2-tune (phase 19): Ray Tune over the training step on the card.
# Arm a sweeps TUNE_LRS with ASHA in trial actors that each take the
# card ({"GPU": 1}), so they run one at a time, in this order.  ASHA is
# asynchronous: a rung cuts a trial only against the trials that reached
# it before, so the order decides who stops whom; the phase prints the
# order and the steps each trial ran.  Arm b tunes a one-worker
# TorchTrainer over TUNE_GRID_LRS with FIFO, one trial at a time (a
# trainer's placement group waits 60 s at most for the card).  The
# optimizer has no warm-up: under warm-up the first update is at lr 0,
# and every trial's second loss would equal its first.
TUNE_B = 8
TUNE_LRS = (1e-3, 3e-4, 1e-4, 3e-5)
TUNE_ASHA = dict(max_t=8, grace_period=2, reduction_factor=2)
TUNE_GRID_LRS = (1e-3, 3e-4)            # a subset of TUNE_LRS
TUNE_TRAINER_STEPS = 4
TUNE_OPT = dict(warmup=0, total_steps=100)
# what a trial's process may find used on the card beyond the first
# trial's reading: a lingering trial holds its CUDA context (~0.5 GiB)
# and its model, optimizer and activations (several GiB)
TUNE_MEM_SLACK = 256 << 20


def tune_step_fns(lr: float, dev, mesh=None) -> tuple:
    """gpt2-tune's step at ``lr``: GPT-2 124M (bf16, the default training
    path) from ``init_params`` seed 0, AdamW without warm-up, and the one
    seeded TUNE_B x 1024 batch."""
    from ray_tpu_torch import GPTConfig
    from ray_tpu_torch.models.training import (build_gpt_train,
                                               default_optimizer,
                                               synthetic_lm_batch)
    cfg = GPTConfig.gpt2(**TRAIN_CFG, dtype=torch.bfloat16)
    fns = build_gpt_train(cfg, mesh,
                          optimizer=default_optimizer(lr=lr, **TUNE_OPT),
                          device=dev, telemetry=False)
    state = fns["init_fn"](torch.Generator().manual_seed(0))
    batch = synthetic_lm_batch(torch.Generator().manual_seed(1), TUNE_B,
                               TRAIN_S, cfg.vocab_size, device=dev)
    return fns, state, batch


def tune_trial(config: dict) -> None:
    """gpt2-tune arm a's function trainable, in its trial actor (by
    reference from this file): ``config["steps"]`` steps at
    ``config["lr"]``, a ``tune.report`` after each, carrying the loss,
    the step's wall (the loss read syncs), the launches so far, the
    process and what the card had free when the trial began."""
    import ray_tpu_torch.tune as tune
    from ray_tpu_torch.ops import _build

    t_start = time.time()
    _card_check("a tune trial", config["card"])
    free_at_start = torch.cuda.mem_get_info()[0]
    torch_flags()
    dev = torch.device("cuda")
    fns, state, batch = tune_step_fns(config["lr"], dev)
    _build.load()
    _build.reset_launches()
    for i in range(config["steps"]):
        t0 = time.monotonic()
        state, m = fns["step_fn"](state, batch)
        loss = float(m["loss"])
        rep = {"loss": loss, "step": i + 1,
               "step_ms": 1e3 * (time.monotonic() - t0),
               "launches": _build.launch_counts(), "pid": os.getpid(),
               "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
               "t_start": t_start, "free_at_start": free_at_start}
        tune.report(rep)


def tune_trainer_loop(config: dict) -> None:
    """gpt2-tune arm b's train loop, in the trainer's one worker (by
    reference from this file): TUNE_TRAINER_STEPS steps at
    ``config["lr"]`` on ``make_mesh(dp=-1)`` over the NCCL world of 1;
    one report at the end with every loss and the launches."""
    from ray_tpu_torch import train
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.parallel.mesh import make_mesh

    _card_check("the tuned trainer's worker", config["card"])
    torch_flags()
    dev = torch.device("cuda")
    fns, state, batch = tune_step_fns(config["lr"], dev,
                                      mesh=make_mesh(dp=-1))
    _build.load()
    _build.reset_launches()
    losses = []
    for _ in range(TUNE_TRAINER_STEPS):
        state, m = fns["step_fn"](state, batch)
        losses.append(float(m["loss"]))
    train.report({"loss": losses[-1], "losses": losses,
                  "launches": _build.launch_counts(), "pid": os.getpid()})


def tune_watch():
    """An experiment callback for arm a (``RunConfig.callbacks``): when
    each trial starts and ends on the driver's clock, and when each ended
    trial's process is gone (a thread polls its pid).  Its state is plain
    dicts: the Tuner pickles its run config, callbacks included."""
    import threading

    from ray_tpu_torch.tune.callbacks import Callback

    class TuneWatch(Callback):
        def __init__(self):
            self.started, self.ended, self.gone = {}, {}, {}

        def on_trial_start(self, trial):
            self.started[trial.trial_id] = time.time()

        def on_trial_complete(self, trial):
            tid, pid = trial.trial_id, trial.last_result.get("pid")
            self.ended[tid] = time.time()

            def poll():
                while pid is not None and _alive(pid):
                    time.sleep(0.002)
                self.gone[tid] = time.time()

            threading.Thread(target=poll, daemon=True).start()

        def on_trial_error(self, trial, error):
            self.on_trial_complete(trial)

    return TuneWatch()


def _in_process_losses(lr: float, steps: int, dev) -> tuple:
    """The driver's own run of gpt2-tune's step: every loss and each
    step's wall (the loss read syncs, as in a trial)."""
    fns, state, batch = tune_step_fns(lr, dev)
    losses, walls = [], []
    for _ in range(steps):
        t0 = time.monotonic()
        state, m = fns["step_fn"](state, batch)
        losses.append(float(m["loss"]))
        walls.append(1e3 * (time.monotonic() - t0))
    del fns, state, batch
    gc.collect()
    torch.cuda.empty_cache()
    return losses, walls


def _tune_launches(what: str, rep: dict, steps: int) -> dict:
    got = rep["launches"]
    want = {k: n * steps for k, n in TRAIN_LAUNCHES.items()}
    if any(k not in got for k in want):
        raise AssertionError(f"{what}: kernels {sorted(want)} not all "
                             f"registered in {sorted(got)}")
    expect_launches(what, got, want)
    return got


def tune_sweep_arm(name: str, refs: dict, default_step_ms=None) -> dict:
    """gpt2-tune arm a: ``tune.with_resources(tune_trial, {"GPU": 1})``
    over TUNE_LRS under ``ASHAScheduler(**TUNE_ASHA)`` on ``loss`` (min).
    Gates: (i) every trial's losses bit-equal to the driver's own steps
    at its rate (``refs``), so every first loss to the others'; (ii)
    every trial's loss moves; (iii) a trial
    stopped at a rung, and the port's ASHA replayed on the recorded
    histories in the order the trials ran makes the same decisions;
    (iv) the best result is the trial with the lowest final loss, no
    errors; (v) every report's launches exactly its steps times
    TRAIN_LAUNCHES; (vi) each ended trial's process gone within
    TRAIN_WORKER_RELEASE_S, each trial finding the card as free as the
    first did, and after ``fit()`` the card free and given back.
    Returns the metrics and the launches (path ``tune``)."""
    import shutil
    import tempfile

    import ray_tpu_torch as rt
    import ray_tpu_torch.tune as tune
    from ray_tpu_torch.train import RunConfig

    import chip_smoke
    max_t = TUNE_ASHA["max_t"]
    free0 = torch.cuda.mem_get_info()[0]
    storage = tempfile.mkdtemp(prefix="gpt2_tune_runs_")
    watch = tune_watch()
    rt.init(num_cpus=RUNTIME_CPUS)
    try:
        if rt.cluster_resources().get("GPU") != 1.0:
            raise AssertionError(f"gpt2-tune: the node found "
                                 f"{rt.cluster_resources()}")
        t0 = time.time()
        grid = tune.Tuner(
            tune.with_resources(chip_smoke.tune_trial, {"GPU": 1}),
            param_space={"lr": tune.grid_search(list(TUNE_LRS)),
                         "card": name, "steps": max_t},
            tune_config=tune.TuneConfig(
                metric="loss", mode="min",
                scheduler=tune.ASHAScheduler(metric="loss", mode="min",
                                             **TUNE_ASHA)),
            run_config=RunConfig(name="gpt2-tune", storage_path=storage,
                                 callbacks=[watch])).fit()
        wall = time.time() - t0
        hists = [r.metrics_history for r in grid]
        release_s = _wait_card_back(rt, [h[-1]["pid"] for h in hists],
                                    "gpt2-tune")
    finally:
        rt.shutdown()
    shutil.rmtree(storage, ignore_errors=True)
    if grid.errors:
        raise AssertionError(f"gpt2-tune: trial errors {grid.errors}")
    free1 = torch.cuda.mem_get_info()[0]
    if free1 < free0 - TUNE_MEM_SLACK:
        raise AssertionError(f"gpt2-tune: {(free0 - free1) / 2**30:.2f} "
                             "GiB of the card still held after fit()")
    lrs = [h[0]["config"]["lr"] for h in hists]
    order = sorted(range(len(hists)), key=lambda i: hists[i][0]["t_start"])
    # (i), (ii)
    for lr, h in zip(lrs, hists):
        got = [r["loss"] for r in h]
        if got != refs[lr][0][:len(got)]:
            raise AssertionError(f"gpt2-tune at lr {lr}: losses {got} != "
                                 f"the driver's {refs[lr][0]}")
    if not all(h[-1]["loss"] < h[0]["loss"] for h in hists):
        raise AssertionError("gpt2-tune: a trial's loss did not fall: "
                             f"{[[x['loss'] for x in h] for h in hists]}")
    # (iii): the port's ASHA replayed in the order the trials ran
    replay = tune.ASHAScheduler(metric="loss", mode="min", **TUNE_ASHA)
    replayed = {}
    for i in order:
        for rep in hists[i]:
            if replay.on_result(str(i), rep) == "STOP":
                replayed[i] = rep["training_iteration"]
                break
        replay.on_trial_complete(str(i))
    steps = {i: len(h) for i, h in enumerate(hists)}
    if replayed != steps:
        raise AssertionError(f"gpt2-tune: ASHA replayed stops {replayed} "
                             f"!= the sweep's {steps}")
    stopped = [i for i in steps if steps[i] < max_t]
    if not stopped or any(steps[i] not in (2, 4) for i in stopped):
        raise AssertionError(f"gpt2-tune: steps run {steps}: want a stop "
                             "at a rung (2 or 4)")
    # (iv)
    best = grid.get_best_result()
    lowest = min(range(len(hists)), key=lambda i: hists[i][-1]["loss"])
    if best.metrics["config"]["lr"] != lrs[lowest]:
        raise AssertionError(f"gpt2-tune: best lr {best.metrics['config']}"
                             f" != {lrs[lowest]}")
    # (v)
    launches = {}
    for i, h in enumerate(hists):
        for rep in h:
            _tune_launches(f"gpt2-tune trial {i} step {rep['step']}", rep,
                           rep["step"])
        if h[-1]["visible"] != "0":
            raise AssertionError(f"gpt2-tune: trial {i} sees "
                                 f"CUDA_VISIBLE_DEVICES {h[-1]['visible']}")
        launches = add_launches(launches, h[-1]["launches"])
    # (vi): each ended trial's process gone, each next trial on a free card
    tids = {i: grid[i].metrics["trial_id"] for i in range(len(hists))}
    gone = {i: watch.gone[tids[i]] - watch.ended[tids[i]] for i in tids}
    if max(gone.values()) > TRAIN_WORKER_RELEASE_S:
        raise AssertionError(f"gpt2-tune: an ended trial's process lived "
                             f"on {gone} s")
    free_first = hists[order[0]][0]["free_at_start"]
    short = {i: (free_first - h[0]["free_at_start"]) / 2 ** 20
             for i, h in enumerate(hists)}
    if max(short.values()) > TUNE_MEM_SLACK / 2 ** 20:
        raise AssertionError(f"gpt2-tune: trials found the card short by "
                             f"{short} MiB against the first trial")
    cold = [hists[order[0]][0]["t_start"] - watch.started[tids[order[0]]]]
    cold += [hists[b][0]["t_start"] - watch.gone[tids[a]]
             for a, b in zip(order, order[1:])]
    trial_ms = [float(np.median([r["step_ms"] for r in h[1:]]))
                for h in hists]
    metrics = {
        "cell": "gpt2-tune", "card": card(), "arm": "asha",
        "batch": [TUNE_B, TRAIN_S], "lrs_in_launch_order":
            [lrs[i] for i in order],
        "steps_run": [steps[i] for i in order],
        "losses": [[r["loss"] for r in hists[i]] for i in order],
        "trial_cold_start_s": cold,
        "trial_median_step_ms": [trial_ms[i] for i in order],
        "driver_median_step_ms": float(np.median(
            [w for _, walls in refs.values() for w in walls[1:]])),
        "default_arm_step_ms": default_step_ms,
        "stop_to_card_free_s": [gone[i] for i in order if i in stopped],
        "card_short_mib": [short[i] for i in order],
        "sweep_wall_s": wall, "release_s": release_s}
    print(f"gpt2-tune: {len(hists)} trials one at a time on the card, "
          f"lrs in launch order {metrics['lrs_in_launch_order']}, steps "
          f"{metrics['steps_run']} (ASHA's stops replayed exact), every "
          "loss bit-equal to the driver's steps at its rate, launches "
          "exact, each stopped trial's card free before the next began",
          flush=True)
    return {"metrics": metrics, "launches": launches}


def tune_trainer_arm(name: str, refs: dict) -> dict:
    """gpt2-tune arm b: a ``Tuner`` over a one-worker ``TorchTrainer``
    (``ScalingConfig(num_workers=1, use_gpu=True)``, ``tune_trainer_loop``)
    with a grid over TUNE_GRID_LRS and FIFO.  The trial actor takes a
    CPU, the trainer's worker the card.  Gates: each trial's losses
    bit-equal to the driver's TUNE_TRAINER_STEPS in-process steps at its
    rate, launches exact, the card given back after ``fit()``.  Returns
    the metrics and the launches (path ``tune_trainer``)."""
    import shutil
    import tempfile

    import ray_tpu_torch as rt
    import ray_tpu_torch.tune as tune
    from ray_tpu_torch.train import RunConfig, ScalingConfig
    from ray_tpu_torch.train.torch import TorchConfig, TorchTrainer

    import chip_smoke
    refs = {lr: refs[lr][0][:TUNE_TRAINER_STEPS] for lr in TUNE_GRID_LRS}
    storage = tempfile.mkdtemp(prefix="gpt2_tune_trainer_runs_")
    rt.init(num_cpus=RUNTIME_CPUS)
    try:
        trainer = TorchTrainer(
            chip_smoke.tune_trainer_loop,
            torch_config=TorchConfig(host_collective=False),
            train_loop_config={"card": name},
            scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
            run_config=RunConfig(name="gpt2-tune-trainer",
                                 storage_path=storage))
        t0 = time.time()
        grid = tune.Tuner(
            trainer, param_space={"lr": tune.grid_search(
                list(TUNE_GRID_LRS))},
            tune_config=tune.TuneConfig(metric="loss", mode="min",
                                        max_concurrent_trials=1),
            run_config=RunConfig(name="gpt2-tune-outer",
                                 storage_path=storage)).fit()
        wall = time.time() - t0
        release_s = _wait_card_back(rt, [r.metrics["pid"] for r in grid
                                         if "pid" in r.metrics],
                                    "gpt2-tune trainer")
    finally:
        rt.shutdown()
    shutil.rmtree(storage, ignore_errors=True)
    if grid.errors:
        raise AssertionError(f"gpt2-tune trainer: errors {grid.errors}")
    launches = {}
    for r in grid:
        lr = r.metrics["config"]["lr"]
        if r.metrics["losses"] != refs[lr]:
            raise AssertionError(f"gpt2-tune trainer at lr {lr}: losses "
                                 f"{r.metrics['losses']} != the driver's "
                                 f"{refs[lr]}")
        launches = add_launches(launches, _tune_launches(
            f"gpt2-tune trainer at lr {lr}", r.metrics, TUNE_TRAINER_STEPS))
    metrics = {"cell": "gpt2-tune", "card": card(), "arm": "trainer",
               "lrs": list(TUNE_GRID_LRS),
               "losses": {str(lr): refs[lr] for lr in TUNE_GRID_LRS},
               "sweep_wall_s": wall, "release_s": release_s}
    print(f"gpt2-tune trainer: {len(TUNE_GRID_LRS)} trials of a one-worker "
          "TorchTrainer, losses bit-equal to the driver's "
          f"{TUNE_TRAINER_STEPS} steps at each rate, launches exact",
          flush=True)
    return {"metrics": metrics, "launches": launches}


def tune_phase(dev, default_step_ms=None) -> dict:
    """gpt2-tune (phase 19): the driver's own steps at every rate (the
    losses and walls both arms are held to), then arms a and b; prints
    ``tune metrics {...}`` and returns the launches by path (``tune``,
    ``tune_trainer``)."""
    name = torch.cuda.get_device_name(0)
    gc.collect()
    torch.cuda.empty_cache()
    refs = {lr: _in_process_losses(lr, TUNE_ASHA["max_t"], dev)
            for lr in TUNE_LRS}
    a = tune_sweep_arm(name, refs, default_step_ms)
    b = tune_trainer_arm(name, refs)
    print("tune metrics " + json.dumps(
        {"asha": a["metrics"], "trainer": b["metrics"]}), flush=True)
    return {"tune": a["launches"], "tune_trainer": b["launches"]}

# ---------------------------------------------------------------------------
# 20. the microbenchmark path (_private/ray_perf.py)
# ---------------------------------------------------------------------------

# the attention variants the microbenchmark path reaches beyond the
# training path's: attention_perf's defaults ([8, 1024, 12, 64], RoPE)
# without the causal mask, and head dim 128 (Llama's, Mistral's,
# Qwen2's), causal with RoPE: (label, head dim, causal)
MB_ATTN_VARIANTS = (("non-causal", 64, False), ("head_dim 128", 128, True))
MB_B, MB_S, MB_H = 8, 1024, 12
MB_DURATION = 0.2   # seconds each ray_perf.main metric is timed


def attention_variant_timings(rec: Recorder, dev) -> None:
    """The attention pair at each of MB_ATTN_VARIANTS with the RoPE
    tables, bf16, against its plain version on the same inputs (the
    forward in f32 on the rotated q and k, the backward in f64, as the
    main path's checks), then timed beside the plain version, SDPA with
    the same mask and the bound: extra shapes of the rows
    (``own=False``), each labelled by its variant."""
    import torch.nn.functional as F

    from ray_tpu_torch.ops import attention as A

    g = torch.Generator(device=dev).manual_seed(20)
    randn = _randn(g, dev)
    bf = torch.bfloat16
    B, S, H = MB_B, MB_S, MB_H
    for variant, D, causal in MB_ATTN_VARIANTS:
        shape = [B, S, H, D]
        scale = D ** -0.5
        cz = dict(scale=scale, causal=causal)
        q, k, v, do = (randn(B, S, H, D) for _ in range(4))
        rope = A.rope_tables(torch.arange(S, device=dev), D, 10000.0, bf)
        rope32 = _f32(*rope)
        qr, kr = (A._rot(x, *rope).float() for x in (q, k))
        o, lse = A.flash_attention_fwd(q, k, v, rope=rope, **cz)
        o_ref, lse_ref = A.plain_flash_attention_fwd(qr, kr, v.float(),
                                                     **cz)
        torch.cuda.synchronize()
        what = f"flash_attention_fwd {variant} rope {shape}"
        err_f = max(check(f"{what} o", o, o_ref, **BF16_TOL),
                    check(f"{what} lse", lse, lse_ref, **LSE_TOL))
        del o_ref, lse_ref
        grads = A.flash_attention_bwd(q, k, v, o, lse, do, rope=rope, **cz)
        refs = bwd_reference(qr, kr, v, o, lse, do, scale, rope32,
                             causal=causal)
        torch.cuda.synchronize()
        what = f"flash_attention_bwd {variant} rope {shape}"
        err_b = max(check(f"{what} {n}", x, y, **GRAD_BF16_TOL)
                    for n, x, y in zip(("dq", "dk", "dv"), grads, refs))
        del grads, refs, qr, kr
        torch.cuda.empty_cache()
        qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))

        def sdpa_fwd_bwd():
            a, b, c = (x.detach().requires_grad_(True) for x in (qt, kt, vt))
            F.scaled_dot_product_attention(
                a, b, c, is_causal=causal).backward(dot)

        tokens = B * S * H * D
        live = S * (S + 1) / 2 if causal else S * S
        tables = 2 * S * D * 2
        label = dict(own=False, variant=variant, causal=causal, rope=True)
        rec.record("flash_attention_fwd", shape, err_f,
                   time_ms(lambda: A.flash_attention_fwd(
                       q, k, v, rope=rope, **cz), 5),
                   time_ms(lambda: A.plain_flash_attention_fwd(
                       q, k, v, rope=rope, **cz), 3),
                   time_ms(lambda: F.scaled_dot_product_attention(
                       qt, kt, vt, is_causal=causal), 5),
                   4 * tokens * 2 + B * H * S * 4 + tables,
                   4 * B * H * D * live,
                   "ray_tpu_torch/ops/csrc/flash_attention_fwd.cu",
                   "ray_tpu/ops/attention.py:477", **label)
        rec.record("flash_attention_bwd", shape, err_b,
                   time_ms(lambda: A.flash_attention_bwd(
                       q, k, v, o, lse, do, rope=rope, **cz), 5),
                   time_ms(lambda: A.plain_flash_attention_bwd(
                       q, k, v, o, lse, do, rope=rope, **cz), 3),
                   time_ms(sdpa_fwd_bwd, 5),
                   8 * tokens * 2 + B * H * S * 4 + tables,
                   5 * 2 * B * H * D * live,
                   "ray_tpu_torch/ops/csrc/flash_attention_bwd.cu",
                   "ray_tpu/ops/attention.py:925", **label)
        del q, k, v, do, o, lse, qt, kt, vt, dot
        torch.cuda.empty_cache()


def _numbers(x):
    """Every int and float in a nest of dicts and lists."""
    if isinstance(x, dict):
        for v in x.values():
            yield from _numbers(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _numbers(v)
    elif isinstance(x, (int, float)) and not isinstance(x, bool):
        yield x


def microbenchmark_phase(rec: Recorder, dev) -> dict:
    """The microbenchmark path (``python -m ray_tpu_torch._private.
    ray_perf``, ``ray_tpu_torch microbenchmark``), phase 20.

    First the kernel variants this path adds, each against its plain
    version under the main path's tolerances: the attention pair without
    the causal mask (tensor cores, head dim 64) and at head dim 128
    (causal and not) at ragged S = 300 between guard bands, with and
    without RoPE, bf16 and f32; the decode kernels at head dim 128,
    padded and paged, bf16, f32 and int8 (``decode_checks``); then their
    times at the path's shapes (``attention_variant_timings``,
    ``decode_timings``).  Then, with the launch counts at 0, the path
    itself: ``ray_perf.main`` in a port session (MB_DURATION a metric),
    ``attention_perf`` at its defaults, with ``causal=False`` and with
    ``head_dim=128``; ``decode_perf`` at head dims 64 and 128, both
    ``impl`` arms; ``fused_norm_perf`` and ``ce_perf``, both arms each;
    ``train_step_perf``; ``collective_perf`` in a world of 1.  Every
    figure must be finite, the metric names ``main``'s eleven, and the
    kernels' launches exactly what the probes' steps imply (the plain
    arms launch none).  Prints ``microbenchmark metrics {...}`` and
    returns the launches."""
    import inspect

    import ray_tpu_torch
    from ray_tpu_torch._private import ray_perf as P
    from ray_tpu_torch.ops import _build

    ragged_attention_checks(dev, lengths=(300,), causal=False)
    ragged_attention_checks(dev, D=128, lengths=(300,))
    ragged_attention_checks(dev, D=128, lengths=(300,), causal=False)
    decode_checks(dev, B=MB_B, S=MB_S, H=MB_H, D=128,
                  lengths=DECODE_LENGTHS)
    attention_variant_timings(rec, dev)
    decode_timings(rec, dev, B=MB_B, S=MB_S, H=MB_H, D=128, own=False)
    gc.collect()
    torch.cuda.empty_cache()

    def steps(fn):
        return inspect.signature(fn).parameters["steps"].default

    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.monotonic()
    ray_tpu_torch.init()
    try:
        out = {"main": P.main(duration=MB_DURATION)}
    finally:
        ray_tpu_torch.shutdown()
    out["attention"] = [P.attention_perf(), P.attention_perf(causal=False),
                        P.attention_perf(head_dim=128)]
    out["decode"] = [dict(P.decode_perf(head_dim=d, impl=impl), head_dim=d)
                     for d in (64, 128) for impl in ("pallas", "xla")]
    out["fused_norm"] = [P.fused_norm_perf(fused=f) for f in (True, False)]
    out["ce"] = [P.ce_perf(mode=m) for m in ("flash", "noremat")]
    out["train"] = P.train_step_perf()
    out["collective"] = P.collective_perf()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = _build.launch_counts()

    names = [r["name"] for r in out["main"]]
    if len(names) != 11 or len(set(names)) != 11:
        raise AssertionError(f"ray_perf.main's metrics: {names}")
    bad = [x for x in _numbers(out) if not math.isfinite(x)]
    if bad:
        raise AssertionError(f"non-finite microbenchmark figures: {bad}")
    if not all(r["rate"] > 0 for r in out["main"]):
        raise AssertionError("a ray_perf.main rate is not positive")
    if out["train"].get("metric") != "train_step_telemetry" or \
            not out["train"].get("mfu"):
        raise AssertionError(f"train_step_perf: {out['train']}")
    a, d, n, c = (1 + steps(f) for f in (P.attention_perf, P.decode_perf,
                                         P.fused_norm_perf, P.ce_perf))
    t = steps(P.train_step_perf)
    want = {k: t * v for k, v in train_step_launches().items()}
    for k, extra in (("flash_attention_fwd", 3 * a),
                     ("flash_attention_bwd", 3 * a),
                     ("decode_attention", 2 * d),
                     ("matmul_residual_norm_fwd", n),
                     ("matmul_residual_norm_bwd", n),
                     ("flash_ce_fwd", c), ("flash_ce_bwd", c)):
        want[k] = want.get(k, 0) + extra
    expect_launches("microbenchmark path", launches, want)
    print(f"microbenchmark path on {card()}: {wall:.1f} s; launches "
          f"{_nonzero(launches)} exact", flush=True)
    print("microbenchmark metrics " + json.dumps(out), flush=True)
    return launches


def main() -> None:
    name = start_up()
    dev = torch.device("cuda")
    if sys.argv[1:] == ["--profile", "train"]:
        train_profile_phase(dev)
        return
    if sys.argv[1:] == ["--profile", "train-pp"]:
        for schedule in ("gpipe", "1f1b"):
            train_profile_phase(dev, f"gpt2-train-pp-{schedule}")
            gc.collect()
            torch.cuda.empty_cache()
        return
    if sys.argv[1:] == ["--profile", "train-moe"]:
        train_profile_phase(dev, "gpt2-train-moe")
        return
    if sys.argv[1:] == ["--profile", "train-stream"]:
        train_profile_phase(dev, "gpt2-train-stream")
        return
    if sys.argv[1:] == ["--profile", "epilogue"]:
        epilogue_profile_phase(dev)
        return
    if sys.argv[1:] == ["--profile", "ce"]:
        ce_profile_phase(dev)
        return
    if sys.argv[1:] == ["--decode"]:
        rec = Recorder(name)
        decode_checks(dev, B=8, S=1024, H=12, D=64, lengths=DECODE_LENGTHS)
        decode_checks(dev, B=4, S=300, H=4, D=16, lengths=(1, 300, 64, 129))
        decode_timings(rec, dev, B=8, S=1024, H=12, D=64)
        print(json.dumps({"kernels": list(rec.rows.values())}))
        return
    if sys.argv[1:] == ["--edges"]:
        wgmma_tile_checks(dev)
        decode_checks(dev, B=8, S=1024, H=12, D=64, lengths=DECODE_LENGTHS)
        ragged_attention_checks(dev)
        ragged_epilogue_checks(dev)
        ragged_flash_ce_checks(dev)
        ragged_attention_checks(dev, H=16)
        width_checks(dev)
        print("edges: every check passed", flush=True)
        return
    if sys.argv[1:] in (["--spec"], ["--profile", "spec"]):
        from ray_tpu_torch import GPTConfig, init_params
        cfg = GPTConfig.gpt2(**GPT2, dtype=torch.bfloat16)
        params = init_params(cfg, torch.Generator().manual_seed(0),
                             device=dev)
        if sys.argv[1] == "--spec":
            spec_phase(params, cfg, dev, arms=SPEC_ARMS_FULL)
            print("spec: every check passed", flush=True)
        else:
            for kv_dtype in ("model", "int8"):
                spec_profile_phase(params, cfg, dev, kv_dtype=kv_dtype)
        return
    if sys.argv[1:] == ["--serve"]:
        from ray_tpu_torch import GPTConfig, init_params
        cfg = GPTConfig.gpt2(**GPT2, dtype=torch.bfloat16)
        params = init_params(cfg, torch.Generator().manual_seed(0),
                             device=dev)
        paths = {"serve_disagg": disagg_phase(params, cfg, dev),
                 "serve_tiers": tiers_phase(params, cfg, dev)}
        paths.update(fleet_phase(params, cfg, dev))
        serving_obs_phase(params, cfg, dev)
        print("serve: every check passed; launches "
              + json.dumps({p: {k: v for k, v in n.items() if v}
                            for p, n in paths.items()}), flush=True)
        return
    if sys.argv[1:] == ["--fleet"]:
        from ray_tpu_torch import GPTConfig, init_params
        cfg = GPTConfig.gpt2(**GPT2, dtype=torch.bfloat16)
        params = init_params(cfg, torch.Generator().manual_seed(0),
                             device=dev)
        paths = fleet_phase(params, cfg, dev)
        print("fleet: every check passed; launches "
              + json.dumps({p: {k: v for k, v in n.items() if v}
                            for p, n in paths.items()}), flush=True)
        return
    if sys.argv[1:] == ["--runtime"]:
        from ray_tpu_torch import GPTConfig, init_params
        cfg = GPTConfig.gpt2(**GPT2, dtype=torch.bfloat16)
        params = init_params(cfg, torch.Generator().manual_seed(0),
                             device=dev)
        launches = runtime_phase(params, cfg, dev)
        print("runtime: every check passed; launches "
              + json.dumps(_nonzero(launches)), flush=True)
        return
    if sys.argv[1:] == ["--serve-deployment"]:
        from ray_tpu_torch import GPTConfig, init_params
        cfg = GPTConfig.gpt2(**GPT2, dtype=torch.bfloat16)
        params = init_params(cfg, torch.Generator().manual_seed(0),
                             device=dev)
        launches = serve_deployment_phase(params, cfg, dev)
        print("serve-deployment: every check passed; launches "
              + json.dumps(_nonzero(launches)), flush=True)
        return
    if sys.argv[1:] == ["--train-worker"]:
        train = train_phase(dev)
        train.pop("launches")
        gc.collect()
        torch.cuda.empty_cache()
        launches = train_worker_phase(dev, train)["train_worker"]
        print("train-worker: every check passed; launches "
              + json.dumps(_nonzero(launches)), flush=True)
        return
    if sys.argv[1:] == ["--multi-gpu"]:
        multi_gpu_phase()
        print("multi-gpu: every check passed", flush=True)
        return
    if sys.argv[1:] == ["--train-pp"]:
        stage_shape_phase(Recorder(name), dev)
        train = train_phase(dev)
        train.pop("launches")
        gc.collect()
        torch.cuda.empty_cache()
        paths = train_worker_phase(dev, train, pp=True)
        print("train-pp: every check passed; launches "
              + json.dumps({p: _nonzero(n) for p, n in paths.items()}),
              flush=True)
        return
    if sys.argv[1:] == ["--train-stream"]:
        stream_shape_phase(Recorder(name), dev)
        train = train_phase(dev)
        train.pop("launches")
        gc.collect()
        torch.cuda.empty_cache()
        paths = train_stream_phase(dev, train)
        print("train-stream: every check passed; launches "
              + json.dumps({p: _nonzero(n) for p, n in paths.items()}),
              flush=True)
        return
    if sys.argv[1:] == ["--train-sharded"]:
        rec = Recorder(name)
        randn = _randn(torch.Generator(device=dev).manual_seed(1), dev)
        attention_kernel_checks(rec, randn, dev, TRAIN_H, main=True)
        tp_attention_phase(rec, dev)
        train = train_phase(dev)
        train.pop("launches")
        gc.collect()
        torch.cuda.empty_cache()
        launches = train_worker_phase(dev, train,
                                      sharded=True)["train_sharded"]
        print("train-sharded: every check passed; launches "
              + json.dumps(_nonzero(launches)), flush=True)
        return
    if sys.argv[1:] == ["--train-overlap"]:
        train = train_phase(dev)
        train.pop("launches")
        gc.collect()
        torch.cuda.empty_cache()
        launches = train_worker_phase(dev, train, sharded=True,
                                      overlap=True)["train_overlap"]
        wire_codec_phase(dev)
        print("train-overlap: every check passed; launches "
              + json.dumps(_nonzero(launches)), flush=True)
        return
    if sys.argv[1:] == ["--train-dataset"]:
        dataset_shape_phase(Recorder(name), dev)
        launches = train_dataset_phase(dev)
        print("train-dataset: every check passed; launches "
              + json.dumps(_nonzero(launches)), flush=True)
        return
    if sys.argv[1:] == ["--serve-lora"]:
        from ray_tpu_torch import GPTConfig, init_params
        cfg = GPTConfig.gpt2(**GPT2, dtype=torch.bfloat16)
        params = init_params(cfg, torch.Generator().manual_seed(0),
                             device=dev)
        paths = serve_lora_phase(params, cfg, dev)
        print("serve-lora: every check passed; launches "
              + json.dumps({p: _nonzero(n) for p, n in paths.items()}),
              flush=True)
        return
    if sys.argv[1:] == ["--train-lora"]:
        dataset_shape_phase(Recorder(name), dev)
        launches = train_lora_phase(dev)
        print("train-lora: every check passed; launches "
              + json.dumps(_nonzero(launches)), flush=True)
        return
    if sys.argv[1:] == ["--rl"]:
        ragged_attention_checks(dev, lengths=(RL_PROMPT + 16,))
        paths = rl_phases(dev)
        print("rl: every check passed; launches "
              + json.dumps({p: _nonzero(n) for p, n in paths.items()}),
              flush=True)
        return
    if sys.argv[1:] == ["--profile-api"]:
        # an earlier profiler session, as the main run's process has had
        _kernel_device_ms(lambda: torch.ones(1 << 20, device=dev).sum())
        launches = profile_api_phase(dev)
        print("profile-api: every check passed; launches "
              + json.dumps(_nonzero(launches)), flush=True)
        return
    if sys.argv[1:] == ["--rllib"]:
        rllib_phase(dev)
        print("rllib: every check passed", flush=True)
        return
    if sys.argv[1:] == ["--hf"]:
        hf_shape_phase(Recorder(name), dev)
        paths = hf_phases(dev)
        print("hf: every check passed; launches "
              + json.dumps({p: _nonzero(n) for p, n in paths.items()}),
              flush=True)
        return
    if sys.argv[1:] == ["--resnet"]:
        resnet_phases(dev)
        print("resnet: every check passed", flush=True)
        return
    if sys.argv[1:] == ["--microbenchmark"]:
        rec = Recorder(name)
        launches = microbenchmark_phase(rec, dev)
        print("microbenchmark: every check passed; launches "
              + json.dumps(_nonzero(launches)), flush=True)
        print(json.dumps({"kernels": list(rec.rows.values())}))
        return
    if sys.argv[1:] == ["--scale-probe"]:
        from ray_tpu_torch._private import scale_probe
        scale_probe.main()
        return
    if sys.argv[1:] == ["--tune"]:
        paths = tune_phase(dev)
        print("tune: every check passed; launches "
              + json.dumps({p: _nonzero(n) for p, n in paths.items()}),
              flush=True)
        return
    if sys.argv[1:] in (["--profile"], ["--profile", "int8"]):
        from ray_tpu_torch import GPTConfig, init_params
        cfg = GPTConfig.gpt2(**GPT2, dtype=torch.bfloat16)
        profile_phase(init_params(cfg, torch.Generator().manual_seed(0),
                                  device=dev), cfg, dev,
                      kv_dtype="int8" if "int8" in sys.argv else "model")
        return
    if sys.argv[1:]:
        raise SystemExit(f"unknown arguments {sys.argv[1:]}")
    clock = PhaseClock()
    rec = Recorder(name)
    wgmma_tile_checks(dev)
    kernel_phase(rec, dev)
    clock.lap("kernels")
    ragged_attention_checks(dev)
    ragged_epilogue_checks(dev)
    ragged_flash_ce_checks(dev)
    clock.lap("ragged edges")
    train_kernel_phase(rec, dev)
    tp_attention_phase(rec, dev)
    stage_shape_phase(rec, dev)
    stream_shape_phase(rec, dev)
    dataset_shape_phase(rec, dev)
    hf_shape_phase(rec, dev)
    clock.lap("training kernels")
    from ray_tpu_torch import GPTConfig, init_params
    cfg = GPTConfig.gpt2(**GPT2, dtype=torch.bfloat16)
    params = init_params(cfg, torch.Generator().manual_seed(0), device=dev)
    # launches: each path driven with the counts at 0 just before it
    paths = {"serve": engine_phase(params, cfg, dev)}
    correctness_phase(params, cfg, dev)
    paths["serve_int8_prefix"] = int8_prefix_phase(params, cfg, dev)
    int8_correctness_phase(params, cfg, dev)
    paths["serve_norm"] = correctness_phase(params, cfg, dev,
                                            norm_kernel=True)
    clock.lap("engine (3-6)")
    paths["serve_spec"] = spec_phase(params, cfg, dev)
    clock.lap("spec (7)")
    paths["serve_disagg"] = disagg_phase(params, cfg, dev)
    paths["serve_tiers"] = tiers_phase(params, cfg, dev)
    clock.lap("disagg, tiers (7b, 7c)")
    paths.update(fleet_phase(params, cfg, dev))
    clock.lap("fleet (7d)")
    serving_obs_phase(params, cfg, dev)
    clock.lap("serving obs (7e)")
    paths["serve_runtime"] = runtime_phase(params, cfg, dev)
    clock.lap("runtime (7f)")
    paths["serve_deployment"] = serve_deployment_phase(params, cfg, dev)
    clock.lap("serve deployment (7g)")
    del params
    torch.cuda.empty_cache()
    train = train_phase(dev)
    paths["train"] = train.pop("launches")
    train_norm = train_phase(dev, norm_kernel=True,
                             timed_steps=NORM_TIMED_STEPS)
    paths["train_norm"] = train_norm.pop("launches")
    print(f"training ms/step: {train['step_ms']:.2f} default, "
          f"{train_norm['step_ms']:.2f} with the RMSNorm kernels", flush=True)
    paths.update(train_arms_phase(dev, train))
    clock.lap("training (8, 8a)")
    paths.update(train_stream_phase(dev, train))
    clock.lap("train stream (8g)")
    gc.collect()
    torch.cuda.empty_cache()
    paths.update(train_worker_phase(dev, train, sharded=True, overlap=True,
                                    pp=True))
    clock.lap("train worker (8b, 8c, 8e, 8f)")
    wire_codec_phase(dev)
    clock.lap("wire codec (8d)")
    train_correctness_phase(dev, fused_ce=True)
    train_correctness_phase(dev, n_layers=2, norm_kernel=True)
    clock.lap("training correctness (9)")
    width_checks(dev)
    clock.lap("width checks (10)")
    paths["train_dataset"] = train_dataset_phase(dev)
    clock.lap("train dataset (11)")
    params = init_params(cfg, torch.Generator().manual_seed(0), device=dev)
    paths.update(serve_lora_phase(params, cfg, dev))
    del params
    clock.lap("serve lora (12)")
    paths["train_lora"] = train_lora_phase(dev)
    clock.lap("train lora (13)")
    paths.update(rl_phases(dev))
    clock.lap("rl (14)")
    paths["train_profile"] = profile_api_phase(dev)
    clock.lap("gpt2-profile (15)")
    rllib_phase(dev)
    clock.lap("rllib (16)")
    gc.collect()
    torch.cuda.empty_cache()
    paths.update(hf_phases(dev))
    clock.lap("gpt2-hf-serve, -train (17)")
    resnet_phases(dev)
    clock.lap("resnet50-train, card-cpu (18)")
    paths.update(tune_phase(dev, train["step_ms"]))
    clock.lap("gpt2-tune (19)")
    paths["microbenchmark"] = microbenchmark_phase(rec, dev)
    clock.lap("microbenchmark (20)")
    clock.report()
    for row in rec.rows.values():
        # (a worker process registers only the kernels its path imports)
        by_path = {p: n.get(row["name"], 0) for p, n in paths.items()}
        row["launches"] = sum(by_path.values())
        row["launches_by_path"] = by_path
        if not row["launches"]:
            raise AssertionError(f"{row['name']} never launched on a path")
    if set(rec.rows) != set(paths["serve"]):
        raise AssertionError(f"kernels checked {sorted(rec.rows)} != "
                             f"entry points {sorted(paths['serve'])}")
    print(json.dumps({"kernels": list(rec.rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
