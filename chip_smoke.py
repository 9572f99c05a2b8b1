#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (k8s_gpu_scheduler_tpu_torch).

    python3 chip_smoke.py [--profile [--parent DIR]] [--train-layers N]
                          [--phases N[,N...]]
    python3 chip_smoke.py --kernels-only [--package-root DIR]

Needs one CUDA card and the CUDA toolkit; exits non-zero without them. It
imports nothing of JAX. Phases, each of which fails the run on error:

0. build: compile the kernels from ``ops/csrc`` (one nvcc per source, in
   parallel, linked into one library) and print each kernel's registers,
   shared memory and spills, the count of tensor-core (HMMA) instructions
   in each kernel's SASS where cuobjdump exists (each bf16 mma.sync kernel
   must have some: K2 ``paged_prefill_mma.cu``, K1, K3 and K4
   ``decode_mma.cu`` with paged and with contiguous rows, K5
   ``flash_forward_mma.cu``, K6 and K7 ``flash_backward_mma.cu``), and the
   card's name and power limit (nvidia-smi).
1. kernels against their plain PyTorch versions on the card: K1
   (paged_decode_attention), K2 (paged_prefill_attention) and K3
   (paged_verify_attention, window t = 5) at the serve width (B 8, H =
   Hkv = 16, hd 64, page 64, 32 blocks, lengths up to 2048; K2 with tb
   512, hb 8) and at a GQA shape (H 32, Hkv 8, hd 128), each in bf16 and
   with an int8 KV pool; K2 also at phase 4's chunked-prefill shape (tb
   64 over 512 resident rows, hb 8, 8 padded entries), and each of that
   run's 15 continuation shapes timed alone, summed to the 240 launches'
   total. bf16 runs K1-K4 on the tensor cores (``paged_prefill_mma.cu``;
   ``decode_mma.cu``, one body for K1, K3 and K4); K1, K3 and K4 merge
   their splits across a thread-block cluster and write their output
   themselves. K1's case also times K3 at t = 1 over lengths - 1 (K1's
   mask) on the same inputs. Max error against a stated tolerance;
   CUDA-event times of the kernel, the plain version and one library call
   (scaled_dot_product_attention over the gathered K/V, a yardstick the
   port never calls), beside the least time the card could take (bytes
   over 3.35 TB/s or operations over 989 TFLOP/s). Then the flash
   attention kernels K5 (forward), K6 (dq) and K7 (dk, dv), causal, bf16,
   at train-8b (B 8, T 2048, H 32, Hkv 8, hd 128: the shapes phase 6
   gives them) and train-hd64 (B 4, T 1024, H = Hkv = 16, hd 64), K5's
   f32 lse held to the f32 tolerance (2e-5); the yardstick is
   scaled_dot_product_attention with is_causal (K5) and its autograd
   backward, which yields dq, dk and dv together (K6, K7); bf16 runs K5
   (``flash_forward_mma.cu``), K6 and K7 (``flash_backward_mma.cu``) on
   the tensor cores. And K4
   (flash_decode_attention) over a contiguous cache of S 2048 with the
   cursor at row 1024 and each slot's bitmap a 576-row window ending
   there (a 512-token prompt plus 64 decode rows: what a slot holds in
   the serve traffic), at the serve width and the GQA shape, bf16 and
   int8, plus a no-bitmap case with ragged [B] lengths; its bound counts
   the set rows only, and the bound of reading every row under the
   cursor is printed beside it; one call of each must launch one CUDA
   kernel (torch.profiler) and allocate only its output. Each case also
   prints its achieved rate (its operations over its time) and its share
   of the bound.
2. the engine on the card against the engine on the CPU, a small f32
   config: plain, speculative (bigram, gamma 3) and chunked-prefill (2
   pages a step) engines; greedy streams, prefill_tokens_skipped and the
   accept counts must be identical, and the card must have run K2 and K3
   and no plain version. Then the contiguous path the same way: the
   shared-cursor engine (through an FCFS stop and an epoch roll),
   generate and generate_speculative; streams identical, the card's K4
   and K3 launches equal to the CPU's plain-version calls (and to layers
   x ticks), no plain version on the card.
3. the main path at full width: the serve config (d_model 1024, 8 layers,
   16 heads, vocab 32000) in bf16 with 8 slots, page 64, chunk 64 and
   prefill bucket 512, 32 requests of 512-token prompts sharing a
   384-token system prompt. Counters are zeroed just before and read just
   after: K1 and K2 must have launched and no plain version been called.
   A second greedy run must reproduce the streams; 16 of the requests run
   again under torch.profiler (the card's busy share and its time by
   kernel); then a shorter pass with int8 weights and an int8 KV pool.
   Prints decode tokens/s, TTFT p50, the synchronised and the
   enqueue-only host ms a decode tick and the peak memory.
4. the speculative path at full width: the same config with
   speculative=True, gamma 4, the bigram proposer, prefill bucket 128, on
   32 requests of a random 16-token phrase repeated 8 times, max_new 64
   (the JAX bench's speculative leg); the same traffic with speculation
   off; an int8-KV sampled run at temperature 0.005, twice (the replay
   must match); and 8 random 1024-token prompts with
   prefill_chunk_tokens=256. K3 must have launched, the accept rate be
   above 0, and no plain version been called.

5. training on the card against training on the CPU: f32, TF32 off,
   vocab 256, d_model 256, 2 layers, 4 heads, 2 kv heads, T 128, remat,
   flash attention, 3 AdamW steps. The losses must agree to 1e-5
   relative, the card launch K5 2·L·steps times and K6 and K7 L·steps
   times and call no plain version, and a second card run give the same
   losses bit for bit.
6. the training path at full width: the llama3_8b widths (vocab 128256,
   d_model 4096, 32 heads, 8 kv heads, d_ff 14336) with depth cut to 4
   layers, bf16, remat, flash attention, AdamW 3e-4, B 8, T 2048, one
   fixed batch, weights drawn on the card (``card_init``): one warm-up step, then 5 timed steps (counters zeroed just
   before and read just after). Prints each loss, step ms, tokens/s, MFU
   (against 989 TFLOP/s) and peak memory. Every loss must be finite, the
   last below the first, K5 launch 2·L (8) and K6 and K7 L (4) times per
   step, and no plain version run.
7. the contiguous path at full width: the serve config in bf16,
   kv_layout="contiguous", 8 slots, prefill bucket 512, chunk 64, the
   serve loop's traffic: 32 requests of 512 tokens, max_new 64 (K4 must
   launch layers x ticks times and no plain version run);
   then 80 requests whose max_new is drawn from {64, 256}, so that slots
   drain apart, the cursor climbs towards S and both an FCFS stop and an
   epoch roll happen; a pass with int8 weights and an int8 KV cache;
   make_server_step at B 1, prompt 512, max_new 64; and
   generate_speculative at B 1 on phase 4's repeated-phrase prompt, gamma
   4 (K3 through the paged view of the cache), with its tokens per verify
   and how far its greedy stream agrees with generate's (bf16: near-ties
   may part them; phase 2 holds the identity at f32).
8. the serving lifecycle and the KV tier. (a) phase 2's f32 config, a
   17-page pool and four waves of five requests (A on a shared system
   prompt, B unique, C on A's system prompt, D = B again): a card engine
   drained in the middle of wave C, persisted by
   ``lifecycle.drain_to_checkpoint`` into a temporary directory and
   resumed by ``resume_or_fresh`` into a fresh card engine must give the
   streams of the CPU engine's undrained, untiered run (plain, int8 KV,
   speculative, and tiered with ``dram_pages=24``), the resumed engine
   launching K2 and K1 (K3 speculative) and no plain version. (b) phase 3's
   engine and shared-prefix traffic in bf16 with max_new 128 (32
   requests; then 16 with int8 KV): drained after one step and restored
   into a 160-page pool, the streams must equal an uninterrupted run;
   prints the drain and restore ms, ``snap.nbytes()`` and the pages
   moved. (c) three waves of 8 requests of 512 tokens at the serve config
   (A on a 384-token system prompt, B unique, C on A's system prompt)
   with ``kv_tiering=True, dram_pages=64`` in 73 pages (B evicts all of
   A's cached pages), tiering off in 73 pages, and the default pool that
   evicts nothing: the tiered streams must equal the large pool's, wave
   C's skipped prefill tokens equal the large pool's and exceed the
   untiered run's; prints the demote and promote ms, promotions and K2
   launches of each run, and the untiered run's first divergence from
   the large pool (its dense prefill may part at a bf16 near-tie). The
   allocator's and the tier's invariants are asserted after every drain,
   restore and wave.

9. observability at full width: phase 3's engine and traffic (and then
   phase 4's speculative engine and traffic) run untraced with no flight
   recorder, then with an ``obs.Tracer`` and the default recorder (256):
   the streams and the kernel launches (K1 and K2; K3) must be equal and
   no plain version run, no span dropped, the spans (queue, admit,
   prefill, decode_chunk, reap; verify and rewind) written by
   ``write_perfetto`` must pass ``validate_perfetto``, and one
   ``pool_metrics()`` snapshot exported by ``export_serving_pool`` must
   expose ``tpu_serve_phase_duration_seconds`` for every phase that ran.
   Prints each phase's span count, total host ms and mean ms a span (a
   dispatch span ends when its kernels are enqueued), then decode tokens/s
   and wall for untraced (flight 0), the defaults and traced, two runs
   of each in turn (no gate: the host's spread is wider than the
   instrumentation).
10. the entry point. (a) ``main(["--serve", "--ckpt-dir", tmp])`` in
   this process (so its launches are counted), SIGTERM raised at the
   second wave line: exit 0, a snapshot written, K1 launched (1 + 4 ×
   waves) × 64 ticks × 8 layers times and no plain version; a second
   ``main()`` boots through ``resume_or_fresh`` from that directory and
   serves one wave; ``--int8`` once more with ``TPU_HBM_LIMIT_BYTES`` at
   half the card, where ``torch.cuda.get_per_process_memory_fraction``
   must read the fraction ``apply_hbm_limit`` computed. Every wave line
   must parse with decode_tok_s > 0. (b) ``train_loop`` at phase 6's
   widths and batch at 2 layers (its 4 cut to 2), checkpointed at step 2 by ``TrainCheckpointer`` and restored into
   fresh objects for steps 3-4: the losses must equal an uninterrupted
   4-step run bit for bit, K5-K7 launch 2·L·2, L·2 and L·2 times; prints
   the save and restore ms and the checkpoint's bytes. Then ``main()``'s
   training branch at 32 layers must refuse before allocating.
11. the fleet at bench_fleet's TPU configuration on one card: 3 replicas
   of a 4-layer model (d_model 1024, 16 heads, vocab 32000), 8 slots,
   chunk 8, bucket 128, page 64, int8 KV, the prefix cache; the first 48
   of its 96 requests (cut for the time limit) over 3 hot 128-token
   system prompts, Poisson 2.0 a router step, max_new 48. Affinity (one forced shed mid-trace) and round-robin
   through ``Router.submit``/``step``: K1 and K2 launch, no plain
   version, affinity's prefix-hit rate above round-robin's, ≥ 1 request
   migrated; prints fleet tokens/s and TTFT p50 by policy and class.
12. (a) the same fleet with a ``FaultProxy`` making r1's ``step`` raise
   ``ReplicaCrashed`` from its 10th call: nothing lost, no error, one
   failover, replayed tokens ≤ delivered ones, streams equal to the
   same fleet's no-fault run; then ``checkpoint_journal`` after three
   steps and a fresh router over the same directory finishes every open
   entry. (b) bench_disagg's trace (38 short requests, two 1024-token
   ones) through one role="prefill" replica (256-token prefill chunks)
   and two role="decode" ones, against three mixed replicas: every
   request handed off, nothing lost, equal streams; prints the handoff
   ms.
   Phases 11 and 12 run in bf16 and again in f32. Every run must end
   with no request error, nothing lost and every stream at its full
   budget; a run with no fault injected must also leave every replica
   live. Greedy streams must be equal in f32. In bf16 a row's GEMM sums
   depend on the rows beside it in its dispatch, and one bf16 unit can
   move a K/V row's int8 code by a step (``logit_spread`` prints how far
   each moves a row's logits), so two schedules of the same requests can
   part at a near-tie. There at most a capped share of the streams may
   part (``PART_CAP``), and at each parting token the dense forward over
   the prompt and the common prefix must put both chosen tokens within
   ``NEAR_TIE`` times that spread of its top logit; eight streams with a
   far token swapped in must each fail that test.

13. mixture-of-experts serving. (a) a small f32 MoE config (4 experts,
   top 2) in the paged, prefix-cached engine on the CPU and on the card:
   equal greedy streams and skipped prefill tokens, the card launching K1
   and K2 and no plain version. (b) Mixtral-8x7B's published widths
   (hidden 4096, 32 heads, 8 kv heads, intermediate 14336, 8 experts, top
   2, vocab 32000, rope_theta 1e6; depth cut to 4 layers, max_seq to
   2048), bf16, dropless experts, weights drawn on the card from a seed,
   phase 3's engine, traffic (8 slots, page 64, chunk 64, bucket 512,
   the prefix cache; 32 requests of a 384-token system prompt plus 128
   unique tokens, max_new 64), checks and prints, profiled pass and int8
   pass.
14. mixture-of-experts training at the same widths, 4 layers, B 8, T
   2048, the capacity path with its balance aux, flash attention, remat,
   AdamW 3e-4, one fixed batch: a warm-up step, then 2 timed steps (K5 2L,
   K6 and K7 L launches a step, no plain version); the losses and the aux
   must be finite and the last loss below the first. Prints step ms,
   tokens/s, the operations the step executes (``moe_step_flops``) and
   their rate's share of 989 TFLOP/s, and the peak memory.
15. BERT-base: ``classify`` at the tiny config on the card against the CPU
   (f32 and bf16), then ``python -m k8s_gpu_scheduler_tpu_torch.models.
   bert`` in a process of its own until it prints three ``bert-base qps=``
   lines, each with qps > 0; it is then sent SIGTERM and must end by that
   signal with no traceback.
16. ResNet-50: ``forward`` at the tiny f32 config on the card against the
   CPU on 32x32 and 33x33 images, then ``python -m
   k8s_gpu_scheduler_tpu_torch.models.resnet`` the same way: three
   ``resnet50 img/s=`` lines with img/s > 0 and a finite loss.

17. tensor-parallel paged serving (``ContinuousBatcher(mesh=)``), the
   serve config cut to 2 layers, in bf16 on phase 3's traffic. (a) An
   NCCL world of one through a tp = 1 mesh (which serves without an
   island): streams equal the single-card engine's, K1 and K2 as often,
   no plain version. (b) A gloo world of two ranks sharing the card (NCCL refuses
   two ranks on one device) at tp = 2, ``all_gather`` combine, Megatron
   slices: every rank launches K1 and K2 as often as one card did; each
   rank's pool and sliced weights are exactly half one card's; the bf16
   streams part from one card's only at near-ties, at most a quarter of
   them; at f32 (16 requests, and 16 speculative ones for K3) the streams
   are identical and every rank's K1/K2/K3 launches equal one card's.
   (c) ``psum``: the engine's f32 streams (16 requests) equal one card's
   but where two tokens tie within twice 1e-4 of the largest logit, in at
   most 2 of 16 streams; the f32 logits of the island's block walk within
   1e-4 of the largest of one card's; bf16 streams parting only at
   near-ties. ``weight_sharding=False`` counted once on each rank, its
   streams held as (b)'s. (d) A drain at tp = 2 restored into a
   single-card engine (f32): the uninterrupted run's streams. (e) int8
   weights and an int8 KV pool at tp = 2. (f) GQA at llama3_8b's widths
   (32/8 heads, hd 128, d_ff 14336; depth cut to 2), 8 requests: K1 at
   group 4 on 16/4 local heads, as many launches on each rank as on one
   card; f32 streams equal one card's; bf16 streams, sliced and with
   replicated weights, part only at near-ties, at most a quarter of them.
   The leader and the followers each read their own launch counters.
   (g) K1 and K3 at a rank's heads (serve and GQA at tp 2, llama3_8b at
   tp 8), the split plan made for the rank's kv heads and for the
   model's, each held to its plain version and timed beside its bound.

18. sharded training (``make_train_step(cfg, mesh, opt)``) at phase 6's
   cell (llama3_8b widths, 4 layers, bf16, flash, remat, AdamW 3e-4, B 8,
   T 2048). (a) An NCCL
   world of one: two steps with ``mesh=None`` and, from the same
   weights, through a mesh of one rank: the losses bit for bit, K5 2·L
   and K6/K7 L launches a step in both, no plain version. (b) A gloo
   world of two ranks sharing the card, at tp 2 and then at fsdp 2 (each
   rank's blocks of (a)'s weights, drawn on the card by ``card_init(...,
   mesh=)``): every rank launches
   K5-K7 as one card did, holds exactly 961,581,056 parameters and
   7,692,648,448 bytes of parameters, gradients and AdamW moments, and
   its bf16 losses are one card's to 2e-3 relative at step 1 and to
   2e-2 (1 + loss) after; each rank's step ms and peak memory are
   printed. At f32 on the same widths cut to 1 layer and vocab 32000 (two
   steps): the losses to 1e-5 relative, the first step's gradients to
   1e-5 of each leaf's largest, and every weight after the steps to 1e-5
   except where one card's first-step gradient is below 1e-6 (AdamW's eps
   zone, at most 2 lr a step there). (c) sp 2: ring and Ulysses attention
   at f32 on phase 5's small config at T 256, the losses one card's dense
   step's to 1e-5. (d) The sharded checkpoint: ``train_loop`` stopped at
   step 2 (each rank's file, rank 0's commit) and resumed into fresh
   objects gives an unstopped run's four losses bit for bit. (e) K5, K6
   and K7 at a rank's shapes (tp 2: 16/4 heads, B 8; fsdp 2: 32/8 heads,
   B 4) against their plain versions, timed beside the bound and SDPA.

19. pipeline stages, MoE over ep and training checkpoints restored across
   meshes. (a) An NCCL
   world of one: phase 5's small f32 config (dense) through a pp 1 GPipe
   step (``make_pp_train_step``, 2 microbatches) within 1e-6 relative of
   ``mesh=None``, and a small MoE config on a size-1 mesh bit for bit
   ``mesh=None``'s; there too the one-card references of (b) and (d). (b)
   A gloo world of two ranks sharing the card as pipeline stages (pp 2):
   llama3_8b's widths at 2 layers (1 a stage), dense attention (the
   pipeline's, as in JAX), remat, bf16, B 8, T 2048, 4 microbatches,
   two steps of GPipe and of 1F1B: every stage holds exactly
   1,268,789,248 parameters and 10,150,313,984 bytes of state, and its
   losses are one card's dense step's within phase 18b's bf16 gates; at
   f32 on 2 layers and vocab 32000 (two steps) the losses to 1e-5, the
   first step's gradients to 1e-5 of each leaf's largest and the weights
   by 18b's rule. (c) The stash: microbatch 1, M 4 and M 8, each stage's
   peak above its state: GPipe's must grow with M, 1F1B's move by at
   most 5 %. (d) An ep 2 world: Mixtral's widths at 2 layers (phase 14's
   4 cut to 2: two ranks at 4 would need about 76 GB), flash, remat,
   bf16, B 8, T 2048, two steps: each rank launches K5 twice a layer a
   step and K6 and K7 once, runs no plain version, holds exactly
   1,755,369,472 parameters and 14,043,217,920 bytes, and its losses are
   one card's within 18b's gates; the capacity's dropped (token, choice)
   pairs of each layer are printed beside one card's. (e) Two steps at
   tp 2 (phase 18b's widths, dense, B 2) saved at step 2, then restored
   onto fsdp 2, onto pp 2 and (rank 0) onto one card: every weight, AdamW
   moment and step count bit for bit the saved files' blocks (assembled
   by concatenation along tp), the next step's loss within 2e-3 of the
   tp 2 run's; prints the save and restore seconds.

20. gang serving: ``generate``/``make_server_step`` on a mesh (a rank
   holds its training blocks, its rows of the batch and a cache [L,
   B/(dp·fsdp), S, Hkv/tp, hd]; K4 runs on its heads, planned for one
   card's batch and heads) and ``main --serve`` on a gang. (a) An NCCL
   world of one: the serve
   config (B 8, phase 3's first 8 prompts of 512 tokens, max_new 64)
   through a size-1 mesh equals ``mesh=None`` bit for bit in bf16 and f32
   (f32 cut to 2 layers here and in (b) and (c)), with equal K4 launches
   (layers x 63). (b) A gloo world of two ranks
   sharing the card at tp 2 and at dp 2 on the same cell: every rank
   launches K4 (max_new - 1) x layers times under one card's split counts
   and runs no plain version, its K and V caches take exactly half of one
   card's bytes (268,435,456 against 536,870,912 in bf16); f32 streams
   equal one card's, bf16 streams part only at near-ties, at most a
   quarter of them (phase 17's rule). (c) GQA at llama3_8b's widths cut
   to 2 layers (32/8 heads, hd 128) at tp 2, 8 prompts of 256 tokens,
   8 new tokens: streams as (b); then K4 at a rank's shape (B 8, 16/4
   heads, hd 128, S 2048, one int length at row 1024) under the rank's
   and the model's split plan, each held to its plain version, timed
   beside its bound and one SDPA call. (d) ``main --serve --max-new 16``
   as the two workers of a gloo gang on the card: each prints JAX's
   multi-process wave line twice; ``--int8``, ``--temperature``, ``--top-k`` and
   ``--eos-id`` on a gang exit with JAX's message before anything is
   allocated. (e) Weight-only int8 on the gang's mesh, in (a)'s and (b)'s
   worlds: one card's int8 ``generate`` of (a)'s weights (bf16, and f32
   at 2 layers; 16 new tokens) against each rank's at tp 2 and at fsdp
   2, where the rank quantizes its own blocks
   (``quantize_llama_params(model, mesh=)``, the scale's max taken over
   the ranks that split K): every ``q`` and
   scale equals the cut of one card's quantization (``torch.equal`` on
   the card) and the rank's bytes are ``rank_leaf_shapes(int8=True)``'s;
   K4 launches, split counts, cache bytes and stream rules as (b); each
   int8 ``generate``'s wall is printed beside the bf16 leg's.
   The rank worlds of phases 17-20 are started by ``parallel.spawn``,
   once for all of them: their NCCL worlds of one are the jobs of one
   world, in phase order, and then their gloo worlds of two are the jobs
   of one world of two (``run_in_worlds``); each job's seconds are
   printed.
21. graftcheck for the port (``k8s_gpu_scheduler_tpu_torch/analysis/``).
   (a) ``python -m k8s_gpu_scheduler_tpu_torch.analysis`` in a process
   of its own, started before phases 17-20's rank worlds and run beside
   them (when they run): over the port's tree (every pass, the dynamic ones on the
   card at the tiny config) it exits 0, over
   ``tests/data/graftcheck_torch/`` it exits 1 with every seeded rule;
   each pass's seconds are printed. (b) For every kernel instantiation
   the presets reach (46), the ``.cu`` query of the bytes its launcher
   requests equals ``analysis/smem.py``'s mirror; with ptxas's static
   shared memory, registers and spills, each fits a block (232,448 B,
   65,536 registers); one line each with its blocks per SM. (c) Every
   shared-page scenario at the serve config's full width (page 64,
   phase 3's 384-token system prompt, gamma 4), bf16 and int8 KV: the
   shared pages stay byte-identical, K1, K2 and K3 launch and no plain
   version runs; the seeded writer is caught on the card's tensors. (d)
   Three steady dispatches after warm-up of paged, speculative and
   contiguous decode, ``generate`` (K4) and a 2-layer train step at the
   serve widths, T 512 (K5-K7): storage kept, ``memory_allocated`` not
   growing, no rebuild and no first-use configuration; each dispatch's
   host syncs and their sites (``torch.cuda.set_sync_debug_mode``) are
   printed, not gated.
22. the rest of graftcheck (op recorder, op audit, traffic and
   sharding audits). (a) Every single-card op-audit entry (JAX's
   registry, the tiny widths in bf16) recorded with the kernels launched:
   no finding, its leaves launch kernels and no plain version, and the
   record equals the same entry's CPU record (plain versions, same
   process) op for op in name, shape and dtype; each dispatch's uploads
   are printed with their bytes and sites. (b) The single-card traffic
   rows at the audit geometry, then the decode, verify and prefix-
   prefill rows at the serve config's full width (page 64, 3 slots, S
   1216, 61 pages, tail 128, hit 256, gamma 4), bf16 and int8 KV: every
   contract met, K1, K2 and K3 launched inside the records; each row's
   peak pool-scale bytes printed beside ``max_memory_allocated``'s
   growth across the dispatch. (c) The sharding audit, the ``_tp2``
   traffic rows, the pipeline's op audit and the two tp steady states on
   the gloo world of two ranks sharing the card that the CLI's tree run
   spawns: every entry on both ranks, no error (warnings printed), no
   plain version. (d) The CLI's run of 21a (made here when phase 21 did
   not run): the seeded fixtures give exactly ``GRAFT_FIXTURE_RULES``, the
   new rules included, and the tree exits 0.
23. the scheduler's control plane (``api/``, ``cluster/``, ``sched/``,
   ``plugins/``, ``cmd/``; host code, timed on the host's clock, printed
   beside the card, its power limit and the host's CPU model). (a)
   ``python -m k8s_gpu_scheduler_tpu_torch.cmd.scheduler --demo 8 --once
   --metrics-port 0`` exits 0 with one ``scheduled`` line a pod. (b)
   bench.py's ``bench_mixed`` shape against the in-memory API server:
   1,024 v5e nodes in slice groups of 4, an in-memory registry at
   utilization (i % 10) / 10, two hot-zone fillers, 560 singletons of
   1-8 chips and 30 four-member gangs arriving Poisson at 150 pods/s
   from a seeded generator, two priority-100 preemptors, one node
   mid-reshape throughout: all 684 pods bound, zero-sum chip
   accounting, the cache agreeing with the API server, the fillers
   evicted, nothing on the reshaping node, every gang on one slice
   group; p50/p99 of the e2e and cycle latencies and pods/s printed. (c)
   ``build_scheduler`` places a 4-chip pod on one of two 2x2 partitions
   of a v5e host, so PostBind injects TPU_HBM_LIMIT_BYTES and
   TPU_DUTY_CYCLE_PERCENTAGE, and a StatefulSet gang of four: each
   member's TPU_WORKER_ID/TPU_WORKER_HOSTNAMES parse to its rank of 4
   (``parallel/distributed.py``); the pod's ConfigMap is the environment
   of one wave of ``main --serve`` (its line, K1 launched, the memory
   cap equal to ``enforcement.hbm_fraction``'s to the byte, the throttle
   slept) and then of one wave of 32 shared-prefix requests on the
   production engine options (K1 and K2 launched, same fraction, the
   throttle slept).
24. the SLO-scored, in-cluster scheduler over the REST adapter
   (``cluster/kubeapi.py``) against ``tests/fakekube.py`` as a separate
   process: (a) 23b's storm with every list, watch and bind an HTTP
   round trip, held to 23b's invariants (the cache against the API state
   read over REST), its rates printed beside 23b's from the same run
   (23b runs first when phase 23 does not); (b) two ``build_scheduler(...,
   leader_elect=True)`` replicas with a 3 s lease, the port's gRPC
   ``RecommenderServer`` on copies of its seed matrices and a Prometheus
   stub answering JAX's series, scheduling test_e2e's gang and SLO pod:
   the leader binds the gang, is stopped, the standby takes the lease
   within its duration and binds the SLO pod on the recommender's
   predictions (exactly one binder a pod, no degraded score); (c) the SLO
   pod's ConfigMap, read back through ``KubeAPIServer.get``, is the
   environment of one wave of ``main --serve`` (its line, K1 launched,
   no plain call, the memory cap equal to ``enforcement.hbm_fraction``'s
   to the byte, the throttle slept).
25. the node agent (``agent/``): (a) the port's prober
   (``agent/csrc/tpuprobe.cpp``, built with g++) with no fake file and no
   device glob reads the card through NVML: one chip a card, each total
   within 1 MiB of nvidia-smi's, ``hbm_used`` following 8 GiB allocated
   and freed, and a duty cycle of at least 0.5 while K5 loops at
   train-8b (launched through its wrapper and counted, no plain call),
   lower 2 s after; (b) 1,023 ``Publisher``s on fake files at 23b's
   utilizations and one reading the card under K5 write into one
   kvstored (``native/kvstore/kvstore.cpp``, built with g++):
   ``list_inventories`` returns all 1,024, the card's inventory is what
   its prober printed, every node has its heartbeat, the port's
   ``TPUPlugin`` scores each node at 100·(1 − utilization) and the card
   below every less busy node, a publish after the load is a change and
   raises the card's score, and the re-exporter's text parses back to the
   probe; (c) the metrics logger and ``registryctl --get`` of the card's
   node, run by module name.

``--profile`` adds profiled serving runs (speculative and the contiguous
engine) and one profiled training step: the card's busy
share and its time by kernel; a profiled BERT-base call and ResNet-50
step (phases 15-16's shapes); and the CUDA kernels one paged decode
dispatch launches per layer per tick, one verify dispatch per layer per
verify and one contiguous decode dispatch per layer per tick (``--parent
DIR``: the same count for the package in DIR, a copy of another tree, in a
process of its own). ``--train-layers N`` runs phase 6 at depth N instead
of 4, to measure how step time and peak memory grow with depth.
``--kernels-only`` runs phases 0 and 1 alone and prints their cases, not
the contract's last lines (``--package-root DIR``: the package in DIR, to
time another tree's kernels). ``--phases 17,20`` runs phases 0 and 1 and
the named ones (10-12, 13-16 and 18 with its 18e run as groups; any
number of a group runs it) and prints the kernel cases and the last
line, not the kernels line, whose launches come from phases 3, 4, 6 and
7.

The line before the last is a JSON object listing every kernel with its
launches on the main path, error and times; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
CSRC = "k8s_gpu_scheduler_tpu_torch/ops/csrc/"
# kernel -> (source, the TPU kernel it replaces)
KERNELS = {
    "paged_decode_attention": (
        "decode_mma.cu",
        "k8s_gpu_scheduler_tpu/ops/decode_attention.py:497"),
    "paged_prefill_attention": (
        "paged_prefill_mma.cu",
        "k8s_gpu_scheduler_tpu/ops/decode_attention.py:999"),
    "paged_verify_attention": (
        "decode_mma.cu",
        "k8s_gpu_scheduler_tpu/ops/decode_attention.py:688"),
    "flash_decode_attention": (
        "decode_mma.cu",
        "k8s_gpu_scheduler_tpu/ops/decode_attention.py:360"),
    "flash_forward": (
        "flash_forward_mma.cu",
        "k8s_gpu_scheduler_tpu/ops/flash_attention.py:117"),
    "flash_backward_dq": (
        "flash_backward_mma.cu",
        "k8s_gpu_scheduler_tpu/ops/flash_attention.py:159"),
    "flash_backward_dkv": (
        "flash_backward_mma.cu",
        "k8s_gpu_scheduler_tpu/ops/flash_attention.py:209"),
}
PLAIN = ("paged_decode_reference", "dense_prefill_reference",
         "paged_verify_reference", "flash_decode_reference")
FLASH = ("flash_forward", "flash_backward_dq", "flash_backward_dkv")
FLASH_PLAIN = ("flash_forward_reference", "flash_backward_reference")
# The bf16 kernels on mma.sync, each named by the words its SASS name
# holds: phase 0 finds HMMA instructions in each. The shared body of K1,
# K3 (paged rows) and K4 (contiguous rows) is checked in both sources.
TENSOR_CORE_KERNELS = (("paged_prefill_mma_kernel",),
                       ("decode_mma_kernel", "PagedRows"),
                       ("decode_mma_kernel", "ContiguousRows"),
                       ("flash_fwd_mma_kernel",), ("flash_bwd_dq_mma_kernel",),
                       ("flash_bwd_dkv_mma_kernel",))


def log(*parts) -> None:
    print(*parts, flush=True)


# -- timing ---------------------------------------------------------------------

class _L2Flush:
    """Writes 256 MiB before each timed launch so every launch finds the
    50 MB L2 cold, as a layer's pool slice is on the main path."""

    def __init__(self, device):
        self.buf = torch.empty(64 << 20, dtype=torch.float32, device=device)

    def __call__(self):
        self.buf.zero_()


def time_ms(fn, flush, iters: int = 20, warmup: int = 3) -> float:
    """Median device time of one call of ``fn`` in ms (CUDA events), the
    L2 flushed before each call. The card first spins until the host has
    enqueued every call, so the events bracket the device's work alone and
    not the host's Python and launch overhead."""
    for _ in range(warmup):
        fn()
    hold = 1 << 25                       # cycles: ~17 ms at 1.98 GHz
    for _ in range(4):
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
        torch.cuda.synchronize()
        torch.cuda._sleep(hold)
        for a, b in ev:
            flush()
            a.record()
            fn()
            b.record()
        if not ev[0][0].query():         # still spinning: all enqueued
            torch.cuda.synchronize()
            return float(np.median([a.elapsed_time(b) for a, b in ev]))
        hold *= 4
    raise SystemExit("could not hold the card busy past the host's enqueue")


def max_err(got: torch.Tensor, ref: torch.Tensor, tol: float):
    """(max |got - ref|, whether |got - ref| <= tol + tol*|ref| holds)."""
    g, r = got.float(), ref.float()
    d = (g - r).abs()
    ok = bool(torch.all(d <= tol + tol * r.abs())) and bool(
        torch.isfinite(g).all())
    return float(d.max()), ok


# -- phase 1: kernels against plain ----------------------------------------------

def _pool(gen, n_pages, ps, n_kv, hd, dtype, int8, dev):
    from k8s_gpu_scheduler_tpu_torch.models.serving import _kv_quant

    k = torch.randn((n_pages, ps, n_kv, hd), generator=gen).to(dtype)
    v = torch.randn((n_pages, ps, n_kv, hd), generator=gen).to(dtype)
    if not int8:
        return k.to(dev), v.to(dev), {}
    kq, ks = _kv_quant(k)
    vq, vs = _kv_quant(v)
    return kq.to(dev), vq.to(dev), dict(k_scale=ks.to(dev),
                                        v_scale=vs.to(dev))


def _deq(pages, scale, dtype):
    return pages if scale is None else (pages.float() * scale).to(dtype)


def _gather(scale, table):
    from k8s_gpu_scheduler_tpu_torch.ops.decode_attention import (
        gather_paged_kv)

    return None if scale is None else gather_paged_kv(scale, table)


def _heads(kv, n_heads):
    """[B, S, Hkv, hd] -> [B, H, S, hd], kv heads repeated per group."""
    return kv.repeat_interleave(n_heads // kv.shape[2], dim=2).transpose(1, 2)


def decode_case(name, B, H, n_kv, hd, ps, n_blocks, int8, dev, flush,
                seed=0, plan_kv_heads=None):
    """K1 against its plain version; ``plan_kv_heads`` as the wrapper
    takes it (a tp rank's pool of ``n_kv`` heads planned as the model's)."""
    from k8s_gpu_scheduler_tpu_torch.ops import decode_attention as da

    dtype = torch.bfloat16
    gen = torch.Generator().manual_seed(seed)
    n_pages = 1 + B * n_blocks
    q = torch.randn((B, H, hd), generator=gen).to(dtype).to(dev)
    kp, vp, sc = _pool(gen, n_pages, ps, n_kv, hd, dtype, int8, dev)
    table = (torch.randperm(n_pages - 1, generator=gen)[:B * n_blocks] + 1) \
        .reshape(B, n_blocks).to(torch.int32).to(dev)
    S = n_blocks * ps
    lens = torch.randint(1, S + 1, (B,), generator=gen)
    lens[0], lens[-1] = S, 1
    lens = lens.to(torch.int32).to(dev)
    out = da.paged_decode_attention(q, kp, vp, table, lens,
                                    plan_kv_heads=plan_kv_heads, **sc)
    ref = da.paged_decode_reference(q, kp, vp, table, lens, **sc)
    torch.cuda.synchronize()
    err, ok = max_err(out, ref, TOL[dtype])
    ms = time_ms(lambda: da.paged_decode_attention(
        q, kp, vp, table, lens, plan_kv_heads=plan_kv_heads, **sc), flush)
    plain_ms = time_ms(lambda: da.paged_decode_reference(
        q, kp, vp, table, lens, **sc), flush)
    # Library yardstick: SDPA over the gathered (dequantized) K/V.
    K = _heads(_deq(da.gather_paged_kv(kp, table),
                    _gather(sc.get("k_scale"), table), dtype), H)
    V = _heads(_deq(da.gather_paged_kv(vp, table),
                    _gather(sc.get("v_scale"), table), dtype), H)
    mask = (torch.arange(S, device=dev)[None, :] < lens[:, None].long()
            )[:, None, None, :]
    q4 = q[:, :, None, :]
    lib = torch.nn.functional.scaled_dot_product_attention
    lib_ms = time_ms(lambda: lib(q4, K, V, attn_mask=mask), flush)
    lib_err, _ = max_err(lib(q4, K, V, attn_mask=mask)[:, :, 0], ref,
                         TOL[dtype])
    # Yardstick: K3 at t = 1 over lengths - 1 masks col < length, K1's
    # mask (every length here is at least 1), on the same inputs.
    yard = (q[:, None], kp, vp, table, lens - 1)
    k3_err, k3_ok = max_err(da.paged_verify_attention(*yard, **sc)[:, 0],
                            ref, TOL[dtype])
    k3_ms = time_ms(lambda: da.paged_verify_attention(*yard, **sc), flush)
    live = int(lens.sum())
    eb = 1 if int8 else 2
    nbytes = (B * H * hd * 2 * 2 + B * n_blocks * 4 + B * 4
              + live * n_kv * hd * eb * 2 + (live * n_kv * 4 * 2 if int8
                                             else 0))
    flops = 4 * live * H * hd
    return dict(case=name, kernel="paged_decode_attention", int8=int8,
                max_abs_err=err, tol=TOL[dtype], ok=ok and k3_ok, ms=ms,
                plain_ms=plain_ms, library_ms=lib_ms, library_err=lib_err,
                k3_t1_ms=k3_ms, k3_t1_err=k3_err,
                **_bound(nbytes, flops, dtype))


def prefill_case(name, M, tb, hb, H, n_kv, hd, ps, int8, dev, flush,
                 seed=1, hits=None):
    """K2 against its plain version. ``hits``: the entries' cached rows;
    by default ragged page-aligned hits (the main path's 6 pages, full,
    half, none)."""
    from k8s_gpu_scheduler_tpu_torch.ops import decode_attention as da

    dtype = torch.bfloat16
    gen = torch.Generator().manual_seed(seed)
    n_pages = 1 + M * hb
    q = torch.randn((M, tb, H, hd), generator=gen).to(dtype).to(dev)
    tk = torch.randn((M, tb, n_kv, hd), generator=gen).to(dtype).to(dev)
    tv = torch.randn((M, tb, n_kv, hd), generator=gen).to(dtype).to(dev)
    kp, vp, sc = _pool(gen, n_pages, ps, n_kv, hd, dtype, int8, dev)
    table = (torch.randperm(n_pages - 1, generator=gen)[:M * hb] + 1) \
        .reshape(M, hb).to(torch.int32).to(dev)
    choices = [6 * ps, hb * ps, (hb // 2) * ps, 0]
    hits = torch.tensor(hits or [choices[i % 4] for i in range(M)],
                        dtype=torch.int32, device=dev)
    args = (q, kp, vp, table, hits, tk, tv)
    out = da.paged_prefill_attention(*args, **sc)
    ref = da.dense_prefill_reference(*args, **sc)
    torch.cuda.synchronize()
    err, ok = max_err(out, ref, TOL[dtype])
    ms = time_ms(lambda: da.paged_prefill_attention(*args, **sc), flush)
    plain_ms = time_ms(lambda: da.dense_prefill_reference(*args, **sc),
                       flush)
    hp = hb * ps
    pk = _deq(da.gather_paged_kv(kp, table),
              _gather(sc.get("k_scale"), table), dtype)
    pv = _deq(da.gather_paged_kv(vp, table),
              _gather(sc.get("v_scale"), table), dtype)
    K = _heads(torch.cat([pk, tk], 1), H)
    V = _heads(torch.cat([pv, tv], 1), H)
    kcol = torch.arange(hp + tb, device=dev)[None, None, :]
    qrow = torch.arange(tb, device=dev)[None, :, None]
    mask = torch.where(kcol < hp, kcol < hits[:, None, None].long(),
                       (kcol - hp) <= qrow)[:, None]
    qt = q.transpose(1, 2)
    lib = torch.nn.functional.scaled_dot_product_attention
    lib_ms = time_ms(lambda: lib(qt, K, V, attn_mask=mask), flush)
    lib_err, _ = max_err(lib(qt, K, V, attn_mask=mask).transpose(1, 2),
                         ref, TOL[dtype])
    hit_rows = int(hits.sum())
    eb = 1 if int8 else 2
    nbytes = (M * tb * H * hd * 2 * 2 + M * tb * n_kv * hd * 2 * 2
              + hit_rows * n_kv * hd * eb * 2
              + (hit_rows * n_kv * 4 * 2 if int8 else 0) + M * hb * 4 + M * 4)
    flops = 4 * H * hd * (tb * hit_rows + M * tb * (tb + 1) // 2)
    return dict(case=name, kernel="paged_prefill_attention", int8=int8,
                max_abs_err=err, tol=TOL[dtype], ok=ok, ms=ms,
                plain_ms=plain_ms, library_ms=lib_ms, library_err=lib_err,
                **_bound(nbytes, flops, dtype))


def verify_case(name, B, t, H, n_kv, hd, ps, n_blocks, int8, dev, flush,
                seed=2, plan_kv_heads=None):
    """K3 against its plain version; ``plan_kv_heads`` as in
    ``decode_case``."""
    from k8s_gpu_scheduler_tpu_torch.ops import decode_attention as da

    dtype = torch.bfloat16
    gen = torch.Generator().manual_seed(seed)
    n_pages = 1 + B * n_blocks
    q = torch.randn((B, t, H, hd), generator=gen).to(dtype).to(dev)
    kp, vp, sc = _pool(gen, n_pages, ps, n_kv, hd, dtype, int8, dev)
    table = (torch.randperm(n_pages - 1, generator=gen)[:B * n_blocks] + 1) \
        .reshape(B, n_blocks).to(torch.int32).to(dev)
    S = n_blocks * ps
    lens = torch.randint(0, S - t + 1, (B,), generator=gen)
    lens[0], lens[-1] = S - t, 0
    lens = lens.to(torch.int32).to(dev)
    args = (q, kp, vp, table, lens)
    out = da.paged_verify_attention(*args, plan_kv_heads=plan_kv_heads, **sc)
    ref = da.paged_verify_reference(*args, **sc)
    torch.cuda.synchronize()
    err, ok = max_err(out, ref, TOL[dtype])
    ms = time_ms(lambda: da.paged_verify_attention(
        *args, plan_kv_heads=plan_kv_heads, **sc), flush)
    plain_ms = time_ms(lambda: da.paged_verify_reference(*args, **sc), flush)
    # Library yardstick: SDPA over the gathered K/V, a [B, 1, t, S] mask.
    K = _heads(_deq(da.gather_paged_kv(kp, table),
                    _gather(sc.get("k_scale"), table), dtype), H)
    V = _heads(_deq(da.gather_paged_kv(vp, table),
                    _gather(sc.get("v_scale"), table), dtype), H)
    bound = lens[:, None].long() + torch.arange(t, device=dev)[None] + 1
    mask = (torch.arange(S, device=dev)[None, None] < bound[..., None]
            )[:, None]
    qt = q.transpose(1, 2)
    lib = torch.nn.functional.scaled_dot_product_attention
    lib_ms = time_ms(lambda: lib(qt, K, V, attn_mask=mask), flush)
    lib_err, _ = max_err(lib(qt, K, V, attn_mask=mask).transpose(1, 2), ref,
                         TOL[dtype])
    rows = int(torch.clamp(lens.long() + t, max=S).sum())   # K/V rows read
    eb = 1 if int8 else 2
    nbytes = (B * t * H * hd * 2 * 2 + rows * n_kv * hd * eb * 2
              + (rows * n_kv * 4 * 2 if int8 else 0) + B * n_blocks * 4
              + B * 4)
    cols = int((lens.long()[:, None] + torch.arange(
        1, t + 1, device=dev)[None]).sum())                 # visible (q, k)
    flops = 4 * H * hd * cols
    return dict(case=name, kernel="paged_verify_attention", int8=int8,
                max_abs_err=err, tol=TOL[dtype], ok=ok, ms=ms,
                plain_ms=plain_ms, library_ms=lib_ms, library_err=lib_err,
                **_bound(nbytes, flops, dtype))


def flash_decode_case(name, B, H, n_kv, hd, S, int8, bitmap, dev, flush,
                      cursor=1024, window=576, seed=4, plan=None):
    """K4 over a contiguous cache. ``bitmap``: the engine's call, a scalar
    cursor and each slot's last ``window`` rows under it set; False: the
    ``cached_attention`` call, ragged [B] lengths and no bitmap; None:
    ``generate``'s call, one int length (``cursor``) and no bitmap.
    ``plan``: the wrapper's ``plan_batch``/``plan_kv_heads``."""
    from k8s_gpu_scheduler_tpu_torch.ops import decode_attention as da

    dtype = torch.bfloat16
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn((B, H, hd), generator=gen).to(dtype).to(dev)
    k, v, sc = _pool(gen, B, S, n_kv, hd, dtype, int8, dev)
    cols = torch.arange(S, device=dev)[None, :]
    if bitmap:
        lengths = cursor
        mask = ((cols >= cursor - window) & (cols < cursor)).expand(B, S) \
            .contiguous()
        kw = dict(bitmap=mask, **sc)
        under = B * cursor
    elif bitmap is None:
        lengths = cursor
        mask = (cols < cursor).expand(B, S)
        kw = dict(sc)
        under = B * cursor
    else:
        lens = torch.randint(1, S + 1, (B,), generator=gen)
        lens[0], lens[-1] = S, 1
        lengths = lens.to(torch.int32).to(dev)
        mask = cols < lengths[:, None].long()
        kw = dict(sc)
        under = int(lens.sum())
    kern_kw = {**kw, **(plan or {})}
    out = da.flash_decode_attention(q, k, v, lengths, **kern_kw)
    splits = da.flash_decode_attention.last_splits
    ref = da.flash_decode_reference(q, k, v, lengths, **kw)
    torch.cuda.synchronize()
    err, ok = max_err(out, ref, TOL[dtype])
    # The wrapper's cost beside the kernel: one call must launch one CUDA
    # kernel and allocate only its output.
    allocs = torch.cuda.memory_stats(dev)["allocation.all.allocated"]
    da.flash_decode_attention(q, k, v, lengths, **kern_kw)
    allocs = torch.cuda.memory_stats(dev)["allocation.all.allocated"] - allocs
    kernels = device_kernels(
        lambda: da.flash_decode_attention(q, k, v, lengths, **kern_kw))
    ms = time_ms(lambda: da.flash_decode_attention(q, k, v, lengths,
                                                   **kern_kw), flush)
    plain_ms = time_ms(lambda: da.flash_decode_reference(
        q, k, v, lengths, **kw), flush)
    # Library yardstick: SDPA over the K/V dequantized and repeated to H
    # heads beforehand, a boolean [B, 1, 1, S] mask.
    K = _heads(_deq(k, sc.get("k_scale"), dtype), H)
    V = _heads(_deq(v, sc.get("v_scale"), dtype), H)
    m4 = mask[:, None, None, :]
    q4 = q[:, :, None, :]
    lib = torch.nn.functional.scaled_dot_product_attention
    lib_ms = time_ms(lambda: lib(q4, K, V, attn_mask=m4), flush)
    lib_err, _ = max_err(lib(q4, K, V, attn_mask=m4)[:, :, 0], ref,
                         TOL[dtype])
    live = int(mask.sum())                    # attendable rows, all slots
    eb = 1 if int8 else 2

    def kv_bytes(rows):
        return rows * n_kv * hd * eb * 2 + (rows * n_kv * 4 * 2 if int8
                                            else 0)

    # q and the output, the lengths (none for generate's int length), the
    # bitmap's bytes under the cursor.
    fixed = B * H * hd * 2 * 2 + (0 if bitmap is None else B * 4) + (
        under if bitmap else 0)
    return dict(case=name, kernel="flash_decode_attention", int8=int8,
                splits=splits, max_abs_err=err, tol=TOL[dtype], ok=ok, ms=ms,
                kernels_per_call=kernels, allocations_per_call=allocs,
                plain_ms=plain_ms, library_ms=lib_ms, library_err=lib_err,
                bound_under_cursor_ms=(fixed + kv_bytes(under))
                / HBM_BYTES_PER_S * 1e3,
                **_bound(fixed + kv_bytes(live), 4 * live * H * hd, dtype))


def chunked_prefill_sweep(dev, flush, n_layers=8, prompt=1024, budget=256,
                          ps=64, n_slots=8, H=16, hd=64) -> dict:
    """K2 at each continuation shape that phase 4's chunked run gives it
    (``ContinuousBatcher._advance_prefill``: a 256-token budget grants one
    64-token page to each of the four oldest pending slots a step, so a
    prompt's chunk j > 0 is a K2 launch of tb 64 over hit j·64 rows, hb the
    power-of-two bucket of j pages, the 4 entries padded to the 8 slots by
    repeating the last), timed alone; the 240 launches' total is their sum
    times the two groups of four prompts times the layers."""
    from k8s_gpu_scheduler_tpu_torch.ops import decode_attention as da

    gen = torch.Generator().manual_seed(5)
    dtype = torch.bfloat16
    tb, n_chunks = ps, prompt // ps
    n_blocks = 2048 // ps
    q = torch.randn((n_slots, tb, H, hd), generator=gen).to(dtype).to(dev)
    tk, tv = (torch.randn((n_slots, tb, H, hd), generator=gen).to(dtype)
              .to(dev) for _ in range(2))
    kp, vp, _ = _pool(gen, 1 + n_slots * n_blocks, ps, H, hd, dtype, False,
                      dev)
    per = {}
    for j in range(1, n_chunks):
        hb = min(1 << (j - 1).bit_length(), n_blocks)
        table = torch.arange(1, 1 + n_slots * hb, dtype=torch.int32,
                             device=dev).reshape(n_slots, hb)
        hits = torch.full((n_slots,), j * ps, dtype=torch.int32, device=dev)
        per[j * ps] = time_ms(lambda: da.paged_prefill_attention(
            q, kp, vp, table, hits, tk, tv), flush)
    groups = n_slots // (budget // ps)
    return dict(launch_ms=per, launches=(n_chunks - 1) * groups * n_layers,
                total_ms=sum(per.values()) * groups * n_layers)


def flash_cases(name, B, T, H, n_kv, hd, dev, flush, seed=3) -> list:
    """K5, K6 and K7 (causal, bf16) against their plain versions, each
    timed beside its plain version, the SDPA yardstick and its bound."""
    from k8s_gpu_scheduler_tpu_torch.ops.flash_attention import (
        flash_backward_reference, flash_forward_reference, launch_backward_dkv,
        launch_backward_dq, launch_forward)

    dtype = torch.bfloat16
    gen = torch.Generator().manual_seed(seed)
    q, do = (torch.randn((B, T, H, hd), generator=gen).to(dtype).to(dev)
             for _ in range(2))
    k, v = (torch.randn((B, T, n_kv, hd), generator=gen).to(dtype).to(dev)
            for _ in range(2))
    out, lse = launch_forward(q, k, v, True, True)
    dq, delta = launch_backward_dq(q, k, v, out, lse, do, True)
    dk, dv = launch_backward_dkv(q, k, v, lse, delta, do, True)
    ref_out, ref_lse = flash_forward_reference(q, k, v, True)
    refs = flash_backward_reference(q, k, v, out, lse, do, True)
    torch.cuda.synchronize()
    tol = TOL[dtype]
    # lse is f32 on both sides: it is held to the f32 tolerance.
    errs = [max_err(a, b, t) for a, b, t in
            [(out, ref_out, tol), (lse, ref_lse, TOL[torch.float32]),
             (dq, refs[0], tol), (dk, refs[1], tol), (dv, refs[2], tol)]]
    # Library yardstick: SDPA over K/V repeated to H heads beforehand
    # (not timed), and its autograd backward (dq, dk, dv of the repeated
    # heads, without the GQA sum).
    qt = q.transpose(1, 2).contiguous().requires_grad_()
    kt, vt = (_heads(x, H).contiguous().requires_grad_() for x in (k, v))
    dot = do.transpose(1, 2).contiguous()
    lib = torch.nn.functional.scaled_dot_product_attention
    lib_fwd_ms = time_ms(lambda: lib(qt, kt, vt, is_causal=True), flush)
    lib_out = lib(qt, kt, vt, is_causal=True)
    lib_bwd_ms = time_ms(lambda: torch.autograd.grad(
        lib_out, (qt, kt, vt), dot, retain_graph=True), flush)
    lq, lk, lv = torch.autograd.grad(lib_out, (qt, kt, vt), dot)
    g = H // n_kv

    def kv_sum(x):                # [B, H, T, hd] -> [B, T, Hkv, hd]
        return x.float().reshape(B, n_kv, g, T, hd).sum(2).transpose(1, 2)

    lib_errs = [max_err(lib_out.detach().transpose(1, 2), ref_out, tol)[0],
                max_err(lq.transpose(1, 2), refs[0], tol)[0],
                max(max_err(kv_sum(lk), refs[1], tol)[0],
                    max_err(kv_sum(lv), refs[2], tol)[0])]
    pairs = B * H * T * (T + 1) // 2          # visible (q, k) pairs
    e = 2                                     # bf16 bytes
    qb, kvb, lseb = B * T * H * hd * e, B * T * n_kv * hd * e, B * H * T * 4
    cases = [
        dict(kernel="flash_forward", max_abs_err=max(errs[0][0], errs[1][0]),
             lse_err=errs[1][0], ok=errs[0][1] and errs[1][1],
             ms=time_ms(lambda: launch_forward(q, k, v, True, True), flush),
             plain_ms=time_ms(lambda: flash_forward_reference(q, k, v, True),
                              flush),
             library_ms=lib_fwd_ms,
             **_bound(qb + 2 * kvb + qb + lseb, 2 * 2 * pairs * hd, dtype)),
        dict(kernel="flash_backward_dq", max_abs_err=errs[2][0],
             ok=errs[2][1],
             ms=time_ms(lambda: launch_backward_dq(q, k, v, out, lse, do,
                                                   True), flush),
             plain_ms=time_ms(lambda: flash_backward_reference(
                 q, k, v, out, lse, do, True), flush),
             library_ms=lib_bwd_ms,
             **_bound(3 * qb + 2 * kvb + lseb + qb + lseb,
                      3 * 2 * pairs * hd, dtype)),
        dict(kernel="flash_backward_dkv",
             max_abs_err=max(errs[3][0], errs[4][0]),
             ok=errs[3][1] and errs[4][1],
             ms=time_ms(lambda: launch_backward_dkv(q, k, v, lse, delta, do,
                                                    True), flush),
             library_ms=lib_bwd_ms,
             **_bound(2 * qb + 2 * kvb + 2 * lseb + 2 * kvb,
                      4 * 2 * pairs * hd, dtype)),
    ]
    # The plain backward computes dq, dk and dv in one call: it is the
    # plain version of K6 and of K7 alike.
    cases[2]["plain_ms"] = cases[1]["plain_ms"]
    for c, lib_err in zip(cases, lib_errs):
        c.update(case=name, int8=False, tol=tol, library_err=lib_err)
    return cases


def _device_kernels(prof) -> int:
    """CUDA kernels in a torch.profiler trace, memsets and copies apart."""
    from torch.autograd import DeviceType

    return sum(e.count for e in prof.key_averages()
               if e.device_type != DeviceType.CPU
               and not getattr(e, "is_user_annotation", False)
               and not e.key.startswith(("Memcpy", "Memset")))


def device_kernels(fn, calls: int = 10, attempts: int = 6) -> float:
    """The CUDA kernels one call of ``fn`` launches (after a warm-up): the
    most that up to ``attempts`` traces of ``calls`` calls each record,
    over ``calls``; a trace with at least one kernel a call ends the
    search. A trace may drop some of a short kernel's device records
    (seen on the card), never add any, so the most is the count."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    most = 0
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        most = max(most, _device_kernels(prof))
        if most >= calls:
            break
    return most / calls


def _bound(nbytes: int, flops: int, dtype) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return dict(bytes=nbytes, flops=flops, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def phase_kernels(dev, this_tree=True) -> list:
    """Phase 1. ``this_tree``: also hold K4's wrapper to one kernel and
    one allocation a call (False when timing another tree's kernels)."""
    flush = _L2Flush(dev)
    cases = []
    for int8 in (False, True):
        tag = "int8kv" if int8 else "bf16"
        cases.append(decode_case(f"serve-{tag}", 8, 16, 16, 64, 64, 32,
                                 int8, dev, flush))
        cases.append(decode_case(f"gqa128-{tag}", 8, 32, 8, 128, 64, 32,
                                 int8, dev, flush))
        cases.append(prefill_case(f"serve-{tag}", 8, 512, 8, 16, 16, 64, 64,
                                  int8, dev, flush))
        cases.append(prefill_case(f"gqa128-{tag}", 8, 512, 8, 32, 8, 128, 64,
                                  int8, dev, flush))
        # Phase 4's chunked run, its middle continuation chunk: tb 64 over
        # 512 resident rows (hb 8) in every padded row.
        cases.append(prefill_case(f"chunked-{tag}", 8, 64, 8, 16, 16, 64, 64,
                                  int8, dev, flush, hits=[512] * 8))
        cases.append(verify_case(f"serve-{tag}", 8, 5, 16, 16, 64, 64, 32,
                                 int8, dev, flush))
        cases.append(verify_case(f"gqa128-{tag}", 8, 5, 32, 8, 128, 64, 32,
                                 int8, dev, flush))
        cases.append(flash_decode_case(f"serve-{tag}", 8, 16, 16, 64, 2048,
                                       int8, True, dev, flush))
        cases.append(flash_decode_case(f"gqa128-{tag}", 8, 32, 8, 128, 2048,
                                       int8, True, dev, flush))
    cases.append(flash_decode_case("serve-bf16-lengths", 8, 16, 16, 64, 2048,
                                   False, False, dev, flush))
    cases += flash_cases("train-8b", 8, 2048, 32, 8, 128, dev, flush)
    cases += flash_cases("train-hd64", 4, 1024, 16, 16, 64, dev, flush)
    for c in cases:
        log(f"  {c['kernel']:24s} {c['case']:14s} max_abs_err "
            f"{c['max_abs_err']:.3e} (tol {c['tol']}"
            + (f"; lse {c['lse_err']:.1e}, tol {TOL[torch.float32]}"
               if "lse_err" in c else "") + f") ms {c['ms']:.4f} "
            f"plain {c['plain_ms']:.4f} sdpa {c['library_ms']:.4f} (err "
            f"{c['library_err']:.1e}) bound "
            f"{c['bound_ms']:.4f} ({c['bound_by']}) "
            + (f"[K3 at t = 1 {c['k3_t1_ms']:.4f} ms, err "
               f"{c['k3_t1_err']:.1e}] " if "k3_t1_ms" in c else "")
            + (f"[one call: {c['kernels_per_call']:g} kernel(s), "
               f"{c['allocations_per_call']} allocation(s)] "
               if "kernels_per_call" in c else "")
            + (f"[every row under the cursor "
               f"{c['bound_under_cursor_ms']:.4f}] "
               if "bound_under_cursor_ms" in c else "")
            + f"{c['flops'] / c['ms'] / 1e9:.1f} TFLOP/s, "
            f"{c['bound_ms'] / c['ms']:.1%} of bound "
            + f"{'ok' if c['ok'] else 'MISMATCH'}")
    bad = [c["kernel"] + ":" + c["case"] for c in cases if not c["ok"]]
    if bad:
        raise SystemExit(f"kernel disagrees with its plain version: {bad}")
    heavy = [c["case"] for c in cases if "kernels_per_call" in c and (
        c["kernels_per_call"], c["allocations_per_call"]) != (1, 1)]
    if heavy and this_tree:
        raise SystemExit(f"K4's wrapper launched more than one kernel or "
                         f"allocated more than its output: {heavy}")
    sweep = chunked_prefill_sweep(dev, flush)
    log(f"  paged_prefill_attention, phase 4's chunked run: "
        f"{sweep['launches']} launches, {sweep['total_ms']:.4f} ms in all "
        f"(kernel alone); ms a launch by hit rows: "
        f"{json.dumps(sweep['launch_ms'])}")
    return cases


# -- phases 2 and 3: the engine ---------------------------------------------------

def per_request(max_new, n) -> list:
    return list(max_new) if np.ndim(max_new) else [max_new] * n


def drive(eng, prompts, max_new):
    """Submit ``prompts`` (``max_new`` one budget or one per request) and
    step the engine dry; returns the streams in submission order."""
    ids = [eng.submit(p, max_new=int(m))
           for p, m in zip(prompts, per_request(max_new, len(prompts)))]
    done = {}
    while eng.pending:
        done.update(eng.step())
    return [done[i] for i in ids]


def shared_prefix_traffic(rng, vocab, n, sys_len, uniq_len):
    system = list(rng.integers(0, vocab, sys_len))
    return [system + list(rng.integers(0, vocab, uniq_len))
            for _ in range(n)]


def phase_engine_vs_cpu(dev) -> dict:
    """Plain, speculative and chunked-prefill engines, each on the CPU and
    on the card, f32: identical streams and gauges; the card runs the
    kernels and never a plain version."""
    from k8s_gpu_scheduler_tpu_torch.models.llama import (
        LlamaConfig, init_params)
    from k8s_gpu_scheduler_tpu_torch.models.serving import ContinuousBatcher
    from k8s_gpu_scheduler_tpu_torch.ops import decode_attention as da

    cfg = LlamaConfig(vocab=256, d_model=256, n_layers=2, n_heads=4,
                      n_kv_heads=2, d_ff=512, max_seq=256,
                      dtype=torch.float32, decode_attn="fused", remat=False)
    engines = {"plain": {}, "spec": dict(speculative=True, gamma=3),
               "chunked": dict(prefill_chunk_tokens=32)}
    out = {}
    for name, kw in engines.items():
        got = {}
        for where in ("cpu", dev):
            model = init_params(cfg, torch.Generator().manual_seed(0), where)
            eng = ContinuousBatcher(model, cfg, n_slots=4, max_len=128,
                                    chunk=4, prefill_bucket=16,
                                    kv_layout="paged", page_size=16,
                                    prefix_cache=True, device=where, **kw)
            rng = np.random.default_rng(0)
            da.reset_counters()
            streams = []
            for _ in range(2):          # the second wave hits the cache
                streams += drive(eng, shared_prefix_traffic(
                    rng, cfg.vocab, 4, 32, 9), 12)
            conv = shared_prefix_traffic(rng, cfg.vocab, 1, 32, 9)[0]
            streams += drive(eng, [conv], 8)
            streams += drive(eng, [conv + streams[-1] + [7, 8, 9]], 8)
            phrase = list(rng.integers(0, cfg.vocab, 6))
            streams += drive(eng, [phrase * 5, phrase * 3 + [1, 2]], 20)
            eng._alloc.assert_consistent()
            m = eng.pool_metrics()
            got[str(where)] = (streams, m["prefill_tokens_skipped"],
                               m.get("spec_accept_rate"),
                               m["prefill_chunks_total"], da.counters())
        cpu, gpu = got["cpu"], got[str(dev)]
        log(f"  {name}: cpu skipped {cpu[1]} accept {cpu[2]} chunks "
            f"{cpu[3]} counters {cpu[4]}")
        log(f"  {name}: gpu skipped {gpu[1]} accept {gpu[2]} chunks "
            f"{gpu[3]} counters {gpu[4]}")
        if gpu[:4] != cpu[:4]:
            raise SystemExit(f"{name} engine on the card diverges from the "
                             f"CPU engine:\n  gpu {gpu[:4]}\n  cpu {cpu[:4]}")
        c = gpu[4]
        need = ["paged_prefill_attention"] + (
            ["paged_verify_attention"] if name == "spec"
            else ["paged_decode_attention"])
        if not all(c[k] for k in need) or cpu[1] <= 0:
            raise SystemExit(f"{name} engine on the card missed {need} or "
                             f"the cache: {c}, skipped {gpu[1]}")
        if any(c[k] for k in PLAIN):
            raise SystemExit(f"{name} engine on the card called a plain "
                             f"version: {c}")
        if name == "spec" and not gpu[2]:
            raise SystemExit("speculative engine accepted nothing")
        out[name] = dict(streams=len(gpu[0]), tokens=sum(map(len, gpu[0])),
                         skipped=gpu[1], accept_rate=gpu[2], chunks=gpu[3])
    return out


def phase_contiguous_vs_cpu(dev) -> dict:
    """The contiguous path, on the CPU and on the card, f32: the
    shared-cursor engine (exact and int8 KV; through an FCFS stop and an
    epoch roll), ``generate`` and ``generate_speculative``. Streams must be
    identical; every plain-version call of the CPU run must be one kernel
    launch on the card (K4: layers x ticks; K3: layers x verifies), and
    the card must call no plain version."""
    from k8s_gpu_scheduler_tpu_torch.models.llama import (
        LlamaConfig, init_params)
    from k8s_gpu_scheduler_tpu_torch.models.serving import (
        ContinuousBatcher, generate, generate_speculative)
    from k8s_gpu_scheduler_tpu_torch.ops import decode_attention as da

    cfg = LlamaConfig(vocab=256, d_model=256, n_layers=2, n_heads=4,
                      n_kv_heads=2, d_ff=512, max_seq=256,
                      dtype=torch.float32, decode_attn="fused", remat=False)
    requests = [(5, 9), (7, 33), (12, 5), (9, 9), (40, 6), (3, 1), (6, 13),
                (33, 5), (8, 8)]
    rng = np.random.default_rng(0)
    prompts = [list(rng.integers(0, cfg.vocab, n)) for n, _ in requests]
    budgets = [m for _, m in requests]
    batch = torch.from_numpy(rng.integers(0, cfg.vocab, (3, 9)))
    phrase = torch.from_numpy(np.tile(rng.integers(0, cfg.vocab, 6), 5)[None])
    launched = {"flash_decode_reference": "flash_decode_attention",
                "paged_verify_reference": "paged_verify_attention"}

    def engine(model, where, **kw):
        eng = ContinuousBatcher(model, cfg, n_slots=3, max_len=64, chunk=4,
                                prefill_bucket=16, kv_layout="contiguous",
                                device=where, **kw)
        streams = drive(eng, prompts, budgets)
        if not (eng.fcfs_stops and eng.epoch_rolls):
            raise SystemExit(f"the small contiguous traffic missed an FCFS "
                             f"stop or an epoch roll: {eng.fcfs_stops}, "
                             f"{eng.epoch_rolls}")
        return streams

    runs = {
        "engine": lambda m, w: engine(m, w),
        "engine-int8kv": lambda m, w: engine(m, w, kv_dtype="int8"),
        "generate": lambda m, w: generate(
            m, batch, cfg, max_new=12, max_len=64).tolist(),
        "generate_speculative": lambda m, w: generate_speculative(
            m, phrase, cfg, max_new=24, gamma=3, max_len=64).tolist(),
    }
    out = {}
    for name, fn in runs.items():
        got = []
        for where in ("cpu", dev):
            model = init_params(cfg, torch.Generator().manual_seed(0), where)
            da.reset_counters()
            streams = fn(model, where)
            got.append((streams, {k: v for k, v in da.counters().items()
                                  if v}))
        (cpu, cpu_c), (gpu, gpu_c) = got
        log(f"  {name}: cpu calls {cpu_c}, gpu launches {gpu_c}")
        if gpu != cpu:
            raise SystemExit(f"{name} on the card diverges from the CPU:\n"
                             f"  gpu {gpu}\n  cpu {cpu}")
        want = {launched[k]: v for k, v in cpu_c.items()}
        if gpu_c != want or not want:
            raise SystemExit(f"{name} on the card launched {gpu_c}, want "
                             f"{want} and no plain version")
        out[name] = dict(tokens=sum(map(len, gpu)), launches=gpu_c)
    want = cfg.n_layers * (12 - 1)
    if out["generate"]["launches"] != {"flash_decode_attention": want}:
        raise SystemExit(f"generate launched {out['generate']['launches']}, "
                         f"want K4 x {want} (layers x decoded tokens)")
    model = init_params(cfg, torch.Generator().manual_seed(0), dev)
    kw = dict(max_new=24, max_len=64)
    if generate_speculative(model, phrase, cfg, gamma=3, **kw).tolist() \
            != generate(model, phrase, cfg, **kw).tolist():
        raise SystemExit("generate_speculative diverges from generate (f32)")
    return out


class _DecodeTimer:
    """Times the engine's decode-chunk and verify dispatches on the host
    clock, synchronised at both ends (``seconds``), and the part of that
    until the dispatch returns, its kernels enqueued (``enqueue_seconds``),
    by wrapping the module functions the engine calls for the duration of
    a ``with`` block."""

    NAMES = ("_decode_chunk_paged_fn", "_verify_chunk_paged_fn",
             "_decode_chunk_fn")

    def __enter__(self):
        from k8s_gpu_scheduler_tpu_torch.models import serving

        self.seconds, self.enqueue_seconds, self._mod = 0.0, 0.0, serving
        self._orig = {n: getattr(serving, n) for n in self.NAMES}

        def wrap(orig):
            def timed(*args, **kw):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = orig(*args, **kw)
                self.enqueue_seconds += time.perf_counter() - t
                torch.cuda.synchronize()
                self.seconds += time.perf_counter() - t
                return out
            return timed

        for n, fn in self._orig.items():
            setattr(serving, n, wrap(fn))
        return self

    def __exit__(self, *exc):
        for n, fn in self._orig.items():
            setattr(self._mod, n, fn)


def serve_run(model, cfg, prompts, max_new, **kw):
    """One measured serving run on a fresh engine: (streams, stats).
    Decode tokens are every emitted token but each request's first (the
    prefill's); ``decode_tokens_per_s`` divides them by the time spent in
    decode-chunk or verify dispatches. ``kw`` overrides the engine's
    settings (8 slots, chunk = the largest max_new, prefill bucket 512,
    the paged layout, page 64 with the prefix cache on; the page settings
    only where ``kw`` keeps the paged layout)."""
    from k8s_gpu_scheduler_tpu_torch.models.serving import ContinuousBatcher
    from k8s_gpu_scheduler_tpu_torch.ops import decode_attention as da

    paged = kw.get("kv_layout", "paged") == "paged"
    eng = ContinuousBatcher(model, cfg, device=model.device, **{
        **dict(n_slots=8, max_len=cfg.max_seq, chunk=int(np.max(max_new)),
               prefill_bucket=512),
        **(dict(kv_layout="paged", page_size=64, prefix_cache=True)
           if paged else {}), **kw})
    torch.cuda.synchronize()
    da.reset_counters()
    t0 = time.perf_counter()
    with _DecodeTimer() as dec:
        streams = drive(eng, prompts, max_new)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = da.counters()
    metrics = eng.pop_request_metrics()
    ttft = sorted(m["ttft_s"] for m in metrics.values())
    n_tok = sum(map(len, streams))
    st = dict(
        requests=len(prompts), tokens=n_tok, wall_s=wall,
        tokens_per_s=n_tok / wall, decode_s=dec.seconds,
        decode_enqueue_s=dec.enqueue_seconds,
        decode_tokens_per_s=(n_tok - len(prompts)) / dec.seconds,
        ttft_p50_ms=1e3 * ttft[len(ttft) // 2], launches=counts)
    if paged:
        pool = eng.pool_metrics()
        eng._alloc.assert_consistent()
        st.update({k: pool[k] for k in (
            "prefill_tokens_skipped", "prefill_chunks_total",
            "spec_accept_rate", "spec_tokens_per_dispatch",
            "spec_rewound_tokens_total") if k in pool})
        st["rungs"] = {f"{tb}x{hb}": n for (tb, hb), n in
                       sorted(eng.prefill_rungs.items())}
    else:
        st.update(epoch_rolls=eng.epoch_rolls, fcfs_stops=eng.fcfs_stops)
    return streams, st


def serve_full_width(card, label, cfg, make_model) -> dict:
    """Phase 3's checks on ``make_model()`` (the model is built and freed
    here): a warm-up, then 32 shared-prefix requests (K1 and K2 launched,
    prompt tokens skipped, no plain version, well-formed streams, the
    synchronised ms a decode tick and the peak memory), a second greedy
    run that must reproduce them, 16 of them profiled (the card's busy
    share), and 16 with int8 weights and an int8 KV pool."""
    from k8s_gpu_scheduler_tpu_torch.ops.quant import quantize_llama_params

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = make_model()
    torch.cuda.synchronize()
    log(f"  [{card}] {label}: {sum(p.numel() for p in model.parameters())} "
        f"parameters, set up in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    max_new = 64
    # Warm-up on other prompts (allocator growth, cuBLAS handles).
    serve_run(model, cfg, shared_prefix_traffic(rng, cfg.vocab, 8, 384, 128),
              max_new)
    prompts = shared_prefix_traffic(rng, cfg.vocab, 32, 384, 128)
    torch.cuda.reset_peak_memory_stats()
    streams, st = serve_run(model, cfg, prompts, max_new)
    st.update(tick_stats(st, cfg),
              peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    log(f"  [{card}] {label} bf16: {json.dumps(st)}")
    c = st["launches"]
    if not (c["paged_decode_attention"] > 0
            and c["paged_prefill_attention"] > 0
            and st["prefill_tokens_skipped"] > 0):
        raise SystemExit(f"{label} missed a kernel or the cache: {st}")
    if any(c[k] for k in PLAIN):
        raise SystemExit(f"{label} called a plain version: {c}")
    if malformed(streams, max_new, cfg.vocab):
        raise SystemExit(f"malformed streams on the {label}")
    again, _ = serve_run(model, cfg, prompts, max_new)
    if again != streams:
        raise SystemExit(f"{label}: a second greedy run did not reproduce "
                         f"the streams")
    log(f"  [{card}] second greedy run reproduced {len(streams)} streams")
    profiled(card, f"{label} bf16, 16 requests",
             lambda: serve_run(model, cfg, prompts[:16], max_new))
    qmodel = quantize_llama_params(model)
    del model
    torch.cuda.empty_cache()
    qs, qst = serve_run(qmodel, cfg, prompts[:16], max_new, kv_dtype="int8")
    qst.update(tick_stats(qst, cfg))
    log(f"  [{card}] {label} int8 weights + int8 KV: {json.dumps(qst)}")
    qc = qst["launches"]
    if not (qc["paged_decode_attention"] > 0
            and qc["paged_prefill_attention"] > 0) \
            or any(qc[k] for k in PLAIN):
        raise SystemExit(f"{label} int8 pass missed a kernel: {qst}")
    if malformed(qs, max_new, cfg.vocab):
        raise SystemExit(f"malformed streams in the {label}'s int8 pass")
    del qmodel
    torch.cuda.empty_cache()
    return dict(bf16=st, int8=qst)


def tick_stats(st, cfg) -> dict:
    """A serve_run's decode ticks (K1 launches / layers) and the
    synchronised and the enqueue-only host ms of one."""
    ticks = st["launches"]["paged_decode_attention"] / cfg.n_layers
    return dict(ticks=ticks, tick_ms=1e3 * st["decode_s"] / ticks,
                tick_enqueue_ms=1e3 * st["decode_enqueue_s"] / ticks)


def phase_full_width(dev, card) -> dict:
    from k8s_gpu_scheduler_tpu_torch.models.llama import (
        LlamaConfig, init_params)

    cfg = dataclasses.replace(LlamaConfig.serve(), decode_attn="fused")
    return serve_full_width(card, "main path", cfg, lambda: init_params(
        cfg, torch.Generator().manual_seed(0), dev))


def malformed(streams, max_new, vocab) -> bool:
    return any(len(s) != m or min(s) < 0 or max(s) >= vocab
               for s, m in zip(streams, per_request(max_new, len(streams))))


SPEC_ENGINE = dict(speculative=True, gamma=4, proposer="bigram",
                   prefill_bucket=128)


def repeated_phrases(rng, vocab, n, phrase_len=16, reps=8):
    """The speculative leg's traffic: each request a random phrase
    repeated, the regime where prompt lookup hits (code, boilerplate,
    templated text)."""
    return [list(rng.integers(0, vocab, phrase_len)) * reps
            for _ in range(n)]


def phase_speculative(dev, card) -> dict:
    """The speculative path at full width (phase 4)."""
    from k8s_gpu_scheduler_tpu_torch.models.llama import (
        LlamaConfig, init_params)

    cfg = dataclasses.replace(LlamaConfig.serve(), decode_attn="fused")
    model = init_params(cfg, torch.Generator().manual_seed(0), dev)
    rng = np.random.default_rng(2)
    max_new = 64
    serve_run(model, cfg, repeated_phrases(rng, cfg.vocab, 8), 16,
              **SPEC_ENGINE)                     # warm-up, other prompts
    prompts = repeated_phrases(rng, cfg.vocab, 32)
    streams, st = serve_run(model, cfg, prompts, max_new, **SPEC_ENGINE)
    log(f"  [{card}] speculative bf16: {json.dumps(st)}")
    c = st["launches"]
    if not c["paged_verify_attention"]:
        raise SystemExit(f"the speculative path never launched K3: {c}")
    if any(c[k] for k in PLAIN):
        raise SystemExit(f"the speculative path called a plain version: "
                         f"{c}")
    if not st["spec_accept_rate"] > 0:
        raise SystemExit(f"the speculative path accepted nothing: {st}")
    if malformed(streams, max_new, cfg.vocab):
        raise SystemExit("malformed streams on the speculative path")
    _, off = serve_run(model, cfg, prompts, max_new, prefill_bucket=128,
                       chunk=8)
    log(f"  [{card}] speculation off (chunk 8): {json.dumps(off)}")
    sampled = []
    for _ in range(2):
        s_streams, s_st = serve_run(model, cfg, prompts, max_new,
                                    kv_dtype="int8", temperature=0.005,
                                    **SPEC_ENGINE)
        sampled.append(s_streams)
        log(f"  [{card}] int8 KV, temperature 0.005: {json.dumps(s_st)}")
        sc = s_st["launches"]
        if not sc["paged_verify_attention"] or any(sc[k] for k in PLAIN) \
                or malformed(s_streams, max_new, cfg.vocab):
            raise SystemExit(f"sampled speculative run failed: {s_st}")
    if sampled[0] != sampled[1]:
        raise SystemExit("the sampled speculative run did not replay")
    log(f"  [{card}] sampled replay identical over {len(prompts)} streams")
    long_prompts = [list(rng.integers(0, cfg.vocab, 1024)) for _ in range(8)]
    ch_streams, ch = serve_run(model, cfg, long_prompts, 16,
                               prefill_chunk_tokens=256, **SPEC_ENGINE)
    log(f"  [{card}] chunked prefill (256 tokens a step): {json.dumps(ch)}")
    cc = ch["launches"]
    if not (cc["paged_prefill_attention"] and cc["paged_verify_attention"]
            and ch["prefill_chunks_total"] > 0) or any(cc[k] for k in PLAIN) \
            or malformed(ch_streams, 16, cfg.vocab):
        raise SystemExit(f"chunked-prefill run failed: {ch}")
    return dict(spec=st, off=off, chunked=ch)


CONTIGUOUS_ENGINE = dict(kv_layout="contiguous", chunk=64)


def phase_contiguous_full_width(dev, card, profile_too) -> dict:
    """The contiguous path at full width (phase 7): the serve loop's
    traffic through the shared-cursor engine (K4), a mixed-length run that
    reaches an FCFS stop and an epoch roll, an int8 pass, then the
    single-sequence server steps (K4 at B = 1; K3 from
    ``generate_speculative``)."""
    from k8s_gpu_scheduler_tpu_torch.models.llama import (
        LlamaConfig, init_params)
    from k8s_gpu_scheduler_tpu_torch.models.serving import (
        make_server_step, make_speculative_server_step)
    from k8s_gpu_scheduler_tpu_torch.ops import decode_attention as da
    from k8s_gpu_scheduler_tpu_torch.ops.quant import quantize_llama_params

    cfg = dataclasses.replace(LlamaConfig.serve(), decode_attn="fused")
    model = init_params(cfg, torch.Generator().manual_seed(0), dev)
    rng = np.random.default_rng(3)
    max_new = 64

    def random_prompts(n, length=512):
        return [list(rng.integers(0, cfg.vocab, length)) for _ in range(n)]

    def check(label, streams, st, budgets, ticks):
        c = st["launches"]
        log(f"  [{card}] {label}: {json.dumps(st)}")
        only = {k: v for k, v in c.items() if v}
        if only != {"flash_decode_attention": cfg.n_layers * ticks}:
            raise SystemExit(f"{label}: launched {only}, want K4 x "
                             f"{cfg.n_layers} layers x {ticks} ticks and "
                             f"nothing else")
        if malformed(streams, budgets, cfg.vocab):
            raise SystemExit(f"{label}: malformed streams")

    serve_run(model, cfg, random_prompts(8), max_new, **CONTIGUOUS_ENGINE)
    prompts = random_prompts(32)
    # Eight requests admit at the epoch start, decode one 64-tick chunk
    # and drain together: 4 waves of 64 ticks.
    streams, st = serve_run(model, cfg, prompts, max_new,
                            **CONTIGUOUS_ENGINE)
    check("bf16, 32 x (512 + 64)", streams, st, max_new, 4 * 64)
    if profile_too:
        log("profile: where a contiguous serving run's device time goes")
        profiled(card, "contiguous decode", lambda: serve_run(
            model, cfg, prompts[:16], max_new, **CONTIGUOUS_ENGINE))
    # Budgets drawn from {64, 256}: slots drain apart, the cursor climbs
    # past S - 256 with requests still queued (an FCFS stop), the slots
    # drain and the epoch rolls. 64 requests finish inside one epoch; 80
    # do not.
    budgets = [int(b) for b in rng.choice([64, 256], 80)]
    mixed, mst = serve_run(model, cfg, random_prompts(80), budgets,
                           **CONTIGUOUS_ENGINE)
    ticks = mst["launches"]["flash_decode_attention"] // cfg.n_layers
    check("bf16, 80 x (512 + {64, 256})", mixed, mst, budgets, ticks)
    if ticks % 64 or not (mst["fcfs_stops"] and mst["epoch_rolls"]):
        raise SystemExit(f"the mixed run missed an FCFS stop or an epoch "
                         f"roll, or a chunk was cut: {mst}")
    log(f"  [{card}] mixed run: {mst['fcfs_stops']} FCFS stops, "
        f"{mst['epoch_rolls']} epoch rolls, {ticks} ticks")
    qmodel = quantize_llama_params(model)
    qs, qst = serve_run(qmodel, cfg, prompts[:16], max_new, kv_dtype="int8",
                        **CONTIGUOUS_ENGINE)
    check("int8 weights + int8 KV, 16 x (512 + 64)", qs, qst, max_new,
          2 * 64)
    del qmodel

    def timed(fn, *args):
        torch.cuda.synchronize()
        da.reset_counters()
        t = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        return out.tolist(), time.perf_counter() - t, {
            k: v for k, v in da.counters().items() if v}

    one = torch.as_tensor(np.asarray(random_prompts(1)), device=dev)
    step = make_server_step(cfg, None, max_new)
    step(model, one)                                         # warm-up
    toks, secs, c = timed(step, model, one)
    log(f"  [{card}] make_server_step B 1, 512 + 64: {secs * 1e3:.1f} ms, "
        f"{max_new / secs:.1f} tokens/s, launches {c}")
    if c != {"flash_decode_attention": cfg.n_layers * (max_new - 1)} \
            or malformed(toks, max_new, cfg.vocab):
        raise SystemExit(f"make_server_step: launches {c}")
    phrase = torch.as_tensor(np.asarray(repeated_phrases(
        np.random.default_rng(2), cfg.vocab, 1)), device=dev)
    spec_step = make_speculative_server_step(cfg, max_new, gamma=4)
    spec_step(model, phrase)                                 # warm-up
    spec, spec_s, sc = timed(spec_step, model, phrase)
    plain, plain_s, _ = timed(step, model, phrase)
    verifies = sc.get("paged_verify_attention", 0) // cfg.n_layers
    agree = next((i for i, (a, b) in enumerate(zip(spec[0], plain[0]))
                  if a != b), max_new)
    gs = dict(k3_launches=sc.get("paged_verify_attention", 0),
              verifies=verifies,
              tokens_per_verify=(max_new - 1) / max(verifies, 1),
              spec_ms=spec_s * 1e3, generate_ms=plain_s * 1e3,
              greedy_identical=spec == plain, agreeing_prefix=agree)
    log(f"  [{card}] generate_speculative B 1, 128 + 64, gamma 4: "
        f"{json.dumps(gs)}")
    if set(sc) != {"paged_verify_attention"} or not verifies \
            or sc["paged_verify_attention"] % cfg.n_layers \
            or malformed(spec, max_new, cfg.vocab):
        raise SystemExit(f"generate_speculative: launches {sc}")
    return dict(bf16=st, mixed=mst, int8=qst, generate_speculative=gs)


# -- phase 8: the serving lifecycle and the KV tier ------------------------------

def check_pools(eng) -> None:
    """The page allocator's partition and, on a tiered engine, the host
    tier's invariants; a breach raises and fails the run."""
    eng._alloc.assert_consistent()
    if eng._alloc.tier is not None:
        eng._alloc.tier.assert_consistent()


def lifecycle_waves(rng, vocab, n, sys_len, uniq_len):
    """Phase 8's waves: A shares a system prompt, B is unique prompts, C
    shares A's system prompt again, D repeats B (its pages by then
    demoted or forgotten)."""
    a = shared_prefix_traffic(rng, vocab, n, sys_len, uniq_len)
    b = [list(rng.integers(0, vocab, sys_len + uniq_len)) for _ in range(n)]
    c = [a[0][:sys_len] + list(rng.integers(0, vocab, uniq_len))
         for _ in range(n)]
    return a, b, c, b


def phase_lifecycle_vs_cpu(dev) -> dict:
    """(a) Phase 2's small f32 config: a card engine is drained in the
    middle of wave C, persisted through ``lifecycle.drain_to_checkpoint``,
    resumed with ``resume_or_fresh`` into a fresh card engine and run to
    the end; its streams must equal the CPU engine's undrained run with
    tiering off (plain, int8 KV, speculative, tiered). The resumed card
    engine must launch K2 and K1 (K3 speculative) and no plain version."""
    import tempfile

    from k8s_gpu_scheduler_tpu_torch.models import lifecycle
    from k8s_gpu_scheduler_tpu_torch.models.llama import (
        LlamaConfig, init_params)
    from k8s_gpu_scheduler_tpu_torch.models.serving import ContinuousBatcher
    from k8s_gpu_scheduler_tpu_torch.ops import decode_attention as da

    cfg = LlamaConfig(vocab=256, d_model=256, n_layers=2, n_heads=4,
                      n_kv_heads=2, d_ff=512, max_seq=256,
                      dtype=torch.float32, decode_attn="fused", remat=False)
    # 17 pages: four requests in flight fill the pool, so wave B evicts
    # wave A's cached pages and wave C evicts B's.
    base = dict(n_slots=4, max_len=128, chunk=4, prefill_bucket=16,
                kv_layout="paged", page_size=16, prefix_cache=True,
                n_pages=17)
    kinds = {"plain": {}, "int8kv": dict(kv_dtype="int8"),
             "spec": dict(speculative=True, gamma=3),
             "tiered": dict(kv_tiering=True, dram_pages=24)}
    # Five requests a wave on four slots: the fifth of wave C, queued at
    # the drain, mounts the pages its wave's first finisher donated (K2).
    waves = lifecycle_waves(np.random.default_rng(0), cfg.vocab, 5, 32, 9)
    out = {}
    for name, kw in kinds.items():
        ref_kw = {k: v for k, v in kw.items()
                  if k not in ("kv_tiering", "dram_pages")}
        model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        ref_eng = ContinuousBatcher(model, cfg, device="cpu", **base,
                                    **ref_kw)
        ref = [s for w in waves for s in drive(ref_eng, w, 12)]
        model = init_params(cfg, torch.Generator().manual_seed(0), dev)

        def make():
            return ContinuousBatcher(model, cfg, device=dev, **base, **kw)

        eng = make()
        got = drive(eng, waves[0], 12) + drive(eng, waves[1], 12)
        ids = [eng.submit(p, max_new=12) for p in waves[2]]
        done = dict(eng.step())
        with tempfile.TemporaryDirectory() as d:
            snap = lifecycle.drain_to_checkpoint(eng, d)
            check_pools(eng)
            eng, resumed = lifecycle.resume_or_fresh(make, d)
        check_pools(eng)
        da.reset_counters()
        while eng.pending:
            done.update(eng.step())
        got += [done[i] for i in ids] + drive(eng, waves[3], 12)
        check_pools(eng)
        c = da.counters()
        m = eng.pool_metrics()
        log(f"  {name}: resumed {resumed} requests, {len(snap.page_ids)} "
            f"pages, {len(snap.tier_keys)} tier pages; after: {c}, "
            f"promotions {m.get('page_promotions_total')}")
        if got != ref:
            raise SystemExit(f"{name}: card drain/persist/resume diverges "
                             f"from the CPU's undrained run:\n  gpu {got}\n"
                             f"  cpu {ref}")
        need = ["paged_prefill_attention", "paged_verify_attention"
                if kw.get("speculative") else "paged_decode_attention"]
        if not (resumed and all(c[k] for k in need)) \
                or any(c[k] for k in PLAIN):
            raise SystemExit(f"{name}: the resumed engine missed {need} or "
                             f"called a plain version: {c}")
        if kw.get("kv_tiering") and not (snap.tier_keys
                                         and m["page_promotions_total"]):
            raise SystemExit(f"tiered: the snapshot shipped no tier or the "
                             f"resumed engine promoted nothing: {m}")
        out[name] = dict(tokens=sum(map(len, got)), resumed=resumed,
                         pages=len(snap.page_ids),
                         tier_pages=len(snap.tier_keys))
    return out


def _synced_ms(fn):
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t)


def phase_drain_restore_full_width(dev, card) -> dict:
    """(b) Phase 3's engine and shared-prefix traffic in bf16, max_new 128
    (two steps a request at chunk 64, so a drain after one step catches
    every slot mid-stream): drained after one step and restored into an
    engine of another ``n_pages``, the streams must equal an uninterrupted
    run in this process; then the same with int8 KV."""
    from k8s_gpu_scheduler_tpu_torch.models.llama import (
        LlamaConfig, init_params)
    from k8s_gpu_scheduler_tpu_torch.models.serving import ContinuousBatcher
    from k8s_gpu_scheduler_tpu_torch.ops import decode_attention as da

    cfg = dataclasses.replace(LlamaConfig.serve(), decode_attn="fused")
    model = init_params(cfg, torch.Generator().manual_seed(0), dev)
    rng = np.random.default_rng(8)
    base = dict(n_slots=8, max_len=cfg.max_seq, chunk=64, prefill_bucket=512,
                kv_layout="paged", page_size=64, prefix_cache=True)
    max_new = 128
    out = {}
    for name, n, kw in (("bf16", 32, {}), ("int8kv", 16,
                                           dict(kv_dtype="int8"))):
        prompts = shared_prefix_traffic(rng, cfg.vocab, n, 384, 128)
        ref = drive(ContinuousBatcher(model, cfg, device=dev, **base, **kw),
                    prompts, max_new)
        eng = ContinuousBatcher(model, cfg, device=dev, **base, **kw)
        ids = [eng.submit(p, max_new=max_new) for p in prompts]
        done = dict(eng.step())
        snap, drain_ms = _synced_ms(eng.drain)
        check_pools(eng)
        # The default pool is 1 + 8 * 32 = 257 pages; restore into 160.
        fresh = ContinuousBatcher(model, cfg, device=dev, n_pages=160,
                                  **base, **kw)
        resumed, restore_ms = _synced_ms(lambda: fresh.restore(snap))
        check_pools(fresh)
        da.reset_counters()
        while fresh.pending:
            done.update(fresh.step())
        check_pools(fresh)
        c = da.counters()
        got = [done[i] for i in ids]
        st = dict(requests=n, in_flight=len(snap.slot_req),
                  queued=len(snap.queue), resumed=resumed,
                  pages_moved=len(snap.page_ids),
                  snapshot_bytes=snap.nbytes(), drain_ms=drain_ms,
                  restore_ms=restore_ms,
                  drain_duration_seconds=eng.pool_metrics()[
                      "drain_duration_seconds"],
                  restore_duration_seconds=fresh.pool_metrics()[
                      "restore_duration_seconds"], launches=c)
        log(f"  [{card}] {name}: {json.dumps(st)}")
        if got != ref:
            first = next(i for i, (a, b) in enumerate(zip(got, ref))
                         if a != b)
            raise SystemExit(f"{name}: drain/restore changed stream {first}"
                             f":\n  got {got[first]}\n  ref {ref[first]}")
        if not (snap.slot_req and c["paged_decode_attention"]
                and c["paged_prefill_attention"]) \
                or any(c[k] for k in PLAIN):
            raise SystemExit(f"{name}: the restore caught no slot in flight "
                             f"or missed K1/K2: {st}")
        out[name] = st
    return out


def _timed_method(eng, name, acc) -> None:
    """Wrap ``eng.<name>`` so each call adds its synchronised ms to
    ``acc[name]`` and one to ``acc[name + "_calls"]``."""
    orig = getattr(eng, name)

    def timed(*args, **kw):
        res, ms = _synced_ms(lambda: orig(*args, **kw))
        acc[name] = acc.get(name, 0.0) + ms
        acc[name + "_calls"] = acc.get(name + "_calls", 0) + 1
        return res

    setattr(eng, name, timed)


def phase_tiering_full_width(dev, card) -> dict:
    """(c) Tiering at the serve config, bf16, three waves of 8 requests of
    512 tokens (A on a 384-token system prompt, B unique, C on A's system
    prompt again), max_new 64, chunk 64, page 64: with ``kv_tiering=True,
    dram_pages=64`` and 73 pages (B evicts all of A's cached pages), with
    tiering off at 73 pages, and with the default 257-page pool that evicts
    nothing. The tiered run's streams must equal the large pool's (C reads
    A's promoted bytes through the same K2 and K1), and wave C's skipped
    prefill tokens equal the large pool's and exceed the untiered run's;
    the untiered run recomputes the prefix densely, so its first
    divergence from the large pool, if any, is printed."""
    from k8s_gpu_scheduler_tpu_torch.models.llama import (
        LlamaConfig, init_params)
    from k8s_gpu_scheduler_tpu_torch.models.serving import ContinuousBatcher
    from k8s_gpu_scheduler_tpu_torch.ops import decode_attention as da

    cfg = dataclasses.replace(LlamaConfig.serve(), decode_attn="fused")
    model = init_params(cfg, torch.Generator().manual_seed(0), dev)
    a, b, c, _ = lifecycle_waves(np.random.default_rng(9), cfg.vocab, 8,
                                 384, 128)
    base = dict(n_slots=8, max_len=cfg.max_seq, chunk=64, prefill_bucket=512,
                kv_layout="paged", page_size=64, prefix_cache=True)
    runs = {"tiered": dict(n_pages=73, kv_tiering=True, dram_pages=64),
            "untiered": dict(n_pages=73), "large": {}}
    out, streams = {}, {}
    for name, kw in runs.items():
        eng = ContinuousBatcher(model, cfg, device=dev, **base, **kw)
        acc: dict = {}
        if kw.get("kv_tiering"):
            _timed_method(eng, "_drain_demotions", acc)
            _timed_method(eng, "_scatter_pages", acc)
        da.reset_counters()
        got, skipped = [], []
        for wave in (a, b, c):
            before = eng.pool_metrics()["prefill_tokens_skipped"]
            got += drive(eng, wave, 64)
            check_pools(eng)
            skipped.append(eng.pool_metrics()["prefill_tokens_skipped"]
                           - before)
        counts = da.counters()
        m = eng.pool_metrics()
        streams[name] = got
        st = dict(skipped_by_wave=skipped,
                  k2_launches=counts["paged_prefill_attention"],
                  k1_launches=counts["paged_decode_attention"],
                  evictions=m.get("prefix_evictions"),
                  demotions=m.get("page_demotions_total"),
                  promotions=m.get("page_promotions_total"),
                  demote_ms=acc.get("_drain_demotions"),
                  demote_calls=acc.get("_drain_demotions_calls"),
                  promote_ms=acc.get("_scatter_pages"),
                  promote_calls=acc.get("_scatter_pages_calls"))
        log(f"  [{card}] {name}: {json.dumps(st)}")
        if any(counts[k] for k in PLAIN) or malformed(got, 64, cfg.vocab):
            raise SystemExit(f"{name}: a plain version ran or a stream is "
                             f"malformed: {counts}")
        out[name] = st
    if streams["tiered"] != streams["large"]:
        raise SystemExit("the tiered run's streams differ from the large "
                         "pool's")
    div = next((i for i, (x, y) in enumerate(zip(streams["untiered"],
                                                  streams["large"]))
                if x != y), None)
    where = "none" if div is None else (
        f"stream {div}, token "
        f"{next(j for j, (p, q) in enumerate(zip(streams['untiered'][div], streams['large'][div])) if p != q)}")
    log(f"  [{card}] untiered vs large pool, first divergence: {where}")
    out["untiered_first_divergence"] = where
    t, u, g = (out[k]["skipped_by_wave"][2]
               for k in ("tiered", "untiered", "large"))
    if not (t == g > u and out["tiered"]["promotions"]):
        raise SystemExit(f"wave C skipped {t} (tiered), {g} (large), {u} "
                         f"(untiered), promotions "
                         f"{out['tiered']['promotions']}")
    return out


# -- phase 9: observability ------------------------------------------------------

def obs_run(model, cfg, prompts, max_new, traced, **kw):
    """Phase 3's engine (``kw`` overrides) over ``prompts``: traced with an
    ``obs.Tracer`` and the default flight recorder, or untraced with none;
    nothing synchronises inside the run. Returns (streams, counters,
    engine, tracer, one pool_metrics() snapshot, wall s)."""
    from k8s_gpu_scheduler_tpu_torch.models.serving import ContinuousBatcher
    from k8s_gpu_scheduler_tpu_torch.obs import Tracer
    from k8s_gpu_scheduler_tpu_torch.ops import decode_attention as da

    tr = Tracer() if traced else None
    eng = ContinuousBatcher(model, cfg, device=model.device, **{
        **dict(n_slots=8, max_len=cfg.max_seq, chunk=max_new,
               prefill_bucket=512, kv_layout="paged", page_size=64,
               prefix_cache=True), **kw,
        **(dict(tracer=tr) if traced else dict(flight_capacity=0))})
    torch.cuda.synchronize()
    da.reset_counters()
    t0 = time.perf_counter()
    streams = drive(eng, prompts, max_new)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return streams, da.counters(), eng, tr, eng.pool_metrics(), wall


def check_traced(card, label, model, cfg, prompts, max_new, spans,
                 kernels, **kw) -> dict:
    """An untraced run and a traced run of the same traffic: equal streams
    and launches of ``kernels``, no plain version, no span dropped, the
    ``spans`` named, a Perfetto file that validates, and an exposition
    with every phase that ran. Prints the phases' host-time rollup."""
    from k8s_gpu_scheduler_tpu_torch.metrics import (
        PHASE_HISTOGRAM, Registry, export_serving_pool)
    from k8s_gpu_scheduler_tpu_torch.obs import (
        validate_perfetto, write_perfetto)

    off = obs_run(model, cfg, prompts, max_new, False, **kw)
    streams, counts, eng, tr, pool, wall = obs_run(
        model, cfg, prompts, max_new, True, **kw)
    launched = {k: counts[k] for k in kernels}
    if streams != off[0]:
        raise SystemExit(f"{label}: the traced streams differ from the "
                         f"untraced ones")
    if launched != {k: off[1][k] for k in kernels} \
            or not all(launched.values()) \
            or any(c[k] for c in (counts, off[1]) for k in PLAIN):
        raise SystemExit(f"{label}: traced launches {counts}, untraced "
                         f"{off[1]}")
    names = {s.name for s in tr.spans()}
    if tr.dropped or not spans <= names:
        raise SystemExit(f"{label}: {tr.dropped} spans dropped, spans "
                         f"{sorted(names)} lack {sorted(spans - names)}")
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        write_perfetto(tr.spans(), path)
        with open(path, encoding="utf-8") as fh:
            doc = json.load(fh)
    problems = validate_perfetto(doc)
    if problems:
        raise SystemExit(f"{label}: the Perfetto document fails: "
                         f"{problems[:5]}")
    reg = Registry()
    export_serving_pool(reg, pool)
    text = reg.expose()
    ran = sorted({p for p, _ in pool.get("phase_durations", ())})
    missing = [p for p in ran
               if f'{PHASE_HISTOGRAM}_count{{phase="{p}"}}' not in text]
    if not ran or missing:
        raise SystemExit(f"{label}: the exposition lacks phases {missing} "
                         f"(ran {ran})")
    rollup: dict = {}
    for phase, sec in pool["phase_durations"]:
        n, ms = rollup.get(phase, (0, 0.0))
        rollup[phase] = (n + 1, ms + 1e3 * sec)
    for phase, (n, ms) in sorted(rollup.items(), key=lambda x: -x[1][1]):
        log(f"  [{card}] {label} {phase}: {n} spans, {ms:.3f} host ms, "
            f"{ms / n:.4f} ms a span")
    kinds: dict = {}
    for r in eng._flight.records():
        kinds[r["kind"]] = kinds.get(r["kind"], 0) + 1
    st = dict(spans=len(tr), perfetto_events=len(doc["traceEvents"]),
              flight_records=kinds, launches=launched, wall_s=wall,
              untraced_wall_s=off[5],
              phases={p: dict(spans=n, host_ms=ms)
                      for p, (n, ms) in rollup.items()})
    log(f"  [{card}] {label}: {json.dumps(st)}")
    return st


OBS_ROUNDS = 1                  # phase 9: runs of each setting, in turn


def phase_observability(dev, card) -> dict:
    """Phase 9: phase 3's and phase 4's traffic traced against untraced
    (``check_traced``), then the instrumentation's cost on decode tokens/s
    and wall, ``OBS_ROUNDS`` runs of each setting in turn."""
    from k8s_gpu_scheduler_tpu_torch.models.llama import (
        LlamaConfig, init_params)
    from k8s_gpu_scheduler_tpu_torch.obs import Tracer

    cfg = dataclasses.replace(LlamaConfig.serve(), decode_attn="fused")
    model = init_params(cfg, torch.Generator().manual_seed(0), dev)
    rng = np.random.default_rng(0)               # phase 3's prompts
    shared_prefix_traffic(rng, cfg.vocab, 8, 384, 128)
    prompts = shared_prefix_traffic(rng, cfg.vocab, 32, 384, 128)
    rng = np.random.default_rng(2)               # phase 4's prompts
    repeated_phrases(rng, cfg.vocab, 8)
    phrases = repeated_phrases(rng, cfg.vocab, 32)
    out = dict(paged=check_traced(
        card, "paged", model, cfg, prompts, 64,
        {"queue", "admit", "prefill", "decode_chunk", "reap"},
        ("paged_decode_attention", "paged_prefill_attention")))
    out["speculative"] = check_traced(
        card, "speculative", model, cfg, phrases, 64,
        {"queue", "admit", "prefill", "verify", "rewind", "reap"},
        ("paged_verify_attention",), **SPEC_ENGINE)
    settings = {"untraced, flight 0": lambda: dict(flight_capacity=0),
                "defaults (flight 256)": dict,
                "traced": lambda: dict(tracer=Tracer())}
    runs: dict = {name: [] for name in settings}
    for _ in range(OBS_ROUNDS):
        for name, kw in settings.items():
            _, st = serve_run(model, cfg, prompts, 64, **kw())
            runs[name].append((st["decode_tokens_per_s"], st["wall_s"]))
    for name, rs in runs.items():
        log(f"  [{card}] overhead, {name}: decode tokens/s "
            f"{[round(r[0], 1) for r in rs]}, wall s "
            f"{[round(r[1], 4) for r in rs]}")
    out["overhead"] = runs
    return out


def profiled(card, label, fn) -> None:
    """Run ``fn`` (returning (streams, stats)) under torch.profiler and
    print the card's busy share of the wall time and its device time by
    kernel. The profiler slows the host, so the busy share is a lower
    bound on an unprofiled run's. Only the card's activity is traced: the
    CPU ops' records give no row here, and parsing them took most of a
    phase's time (about 50 s of phase 3 and 65 s of phase 13)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, st = fn()
    rows = {}
    for e in prof.key_averages():
        # Kernel rows only: a CPU op's device time is the sum of the
        # kernels it launched, which have rows of their own, and a user
        # annotation (the optimizer's step) spans kernels counted already.
        if e.device_type == DeviceType.CPU or getattr(
                e, "is_user_annotation", False):
            continue
        if e.self_device_time_total > 0:
            rows[e.key] = (e.self_device_time_total / 1e3, e.count)
    if not rows:
        raise SystemExit(f"{label}: the profiler recorded no kernel")
    busy = sum(ms for ms, _ in rows.values())
    wall = st["wall_s"] * 1e3
    log(f"  [{card}] {label} profiled: wall {wall:.3f} ms, device busy "
        f"{busy:.3f} ms ({100 * busy / wall:.1f} %) in "
        f"{sum(n for _, n in rows.values())} kernels, {json.dumps(st)}")
    for key, (ms, n) in sorted(rows.items(), key=lambda kv: -kv[1][0])[:20]:
        log(f"    {ms:10.3f} ms {n:7d}x {100 * ms / busy:5.1f} %  {key[:100]}")


def phase_profile(dev, card) -> None:
    """``--profile``: 16 full-width bf16 requests of the speculative
    path's traffic, profiled (phase 3 profiles the main path's)."""
    from k8s_gpu_scheduler_tpu_torch.models.llama import (
        LlamaConfig, init_params)

    cfg = dataclasses.replace(LlamaConfig.serve(), decode_attn="fused")
    model = init_params(cfg, torch.Generator().manual_seed(0), dev)
    rng = np.random.default_rng(1)
    serve_run(model, cfg, repeated_phrases(rng, cfg.vocab, 8), 16,
              **SPEC_ENGINE)
    phrases = repeated_phrases(rng, cfg.vocab, 16)
    profiled(card, "speculative",
             lambda: serve_run(model, cfg, phrases, 64, **SPEC_ENGINE))


class _Capture:
    """Keeps the arguments of the first call of the serving module's
    function ``name`` while a ``with`` block runs."""

    def __init__(self, name):
        self.name, self.call = name, None

    def __enter__(self):
        from k8s_gpu_scheduler_tpu_torch.models import serving

        self._mod, self._orig = serving, getattr(serving, self.name)

        def keep(*args, **kw):
            if self.call is None:
                self.call = (args, kw)
            return self._orig(*args, **kw)

        setattr(serving, self.name, keep)
        return self

    def __exit__(self, *exc):
        setattr(self._mod, self.name, self._orig)


def dispatch_launches(dev) -> dict:
    """The CUDA kernels that one paged decode dispatch launches per layer
    per tick, one verify dispatch per layer per verify and one contiguous
    decode dispatch per layer per tick (memsets and copies apart), at the
    serve config: the first dispatch of a short run (8 requests, chunk
    16), replayed alone under torch.profiler (its K/V writes land where
    they did). A layer-tick is one K1 or K4 launch, a layer-verify one K3
    launch."""
    from torch.profiler import ProfilerActivity, profile

    from k8s_gpu_scheduler_tpu_torch.models import serving
    from k8s_gpu_scheduler_tpu_torch.models.llama import (
        LlamaConfig, init_params)
    from k8s_gpu_scheduler_tpu_torch.ops import decode_attention as da

    cfg = dataclasses.replace(LlamaConfig.serve(), decode_attn="fused")
    model = init_params(cfg, torch.Generator().manual_seed(0), dev)
    rng = np.random.default_rng(4)
    out = {}
    for label, name, attn, kw, prompts in (
            ("decode tick", "_decode_chunk_paged_fn", "paged_decode_attention",
             {}, shared_prefix_traffic(rng, cfg.vocab, 8, 384, 128)),
            ("verify", "_verify_chunk_paged_fn", "paged_verify_attention",
             SPEC_ENGINE, repeated_phrases(rng, cfg.vocab, 8)),
            ("contiguous decode tick", "_decode_chunk_fn",
             "flash_decode_attention", dict(kv_layout="contiguous"),
             [list(rng.integers(0, cfg.vocab, 512)) for _ in range(8)])):
        with _Capture(name) as cap:
            serve_run(model, cfg, prompts, 16, **kw)
        fn = getattr(serving, name)
        args, kwargs = cap.call
        fn(*args, **kwargs)                              # warm-up
        torch.cuda.synchronize()
        da.reset_counters()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn(*args, **kwargs)
            torch.cuda.synchronize()
        steps = da.counters()[attn]
        kernels = _device_kernels(prof)
        out[label] = dict(layer_steps=steps, kernels=kernels,
                          kernels_per_layer_step=kernels / max(steps, 1))
    return out


def phase_dispatch_launches(dev, parent) -> None:
    """``--profile``: kernels per layer per decode tick and per verify, for
    this tree and, with ``--parent DIR``, for the package in DIR."""
    log(f"  this tree: {json.dumps(dispatch_launches(dev))}")
    if parent is None:
        return
    import os

    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--launch-counts",
         "--package-root", os.path.abspath(parent)], capture_output=True,
        text=True, timeout=900)
    if proc.returncode != 0:
        raise SystemExit(f"the parent tree's count failed:\n"
                         f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    log(f"  parent tree ({parent}): {proc.stdout.strip().splitlines()[-1]}")


# -- phases 5 and 6: training ------------------------------------------------------

TRAIN_STEPS = 5                 # timed full-width steps, after one warm-up


def train_setup(dev, cfg, B, T, seed=0, on_card=False):
    """A model from ``seed``, its AdamW(3e-4) train step, and one fixed
    batch {tokens, targets = tokens rolled by one} on ``dev``. The
    weights come from ``init_params`` (the same on the CPU and the card),
    or with ``on_card`` from ``card_init`` (drawn on the card: 0.1 s
    where ``init_params`` takes 16.5 s at phase 6's 1.9 B parameters)."""
    from k8s_gpu_scheduler_tpu_torch.models.llama import (
        init_params, make_optimizer, make_train_step)

    model = (card_init(cfg, dev, seed) if on_card else
             init_params(cfg, torch.Generator().manual_seed(seed), dev))
    step = make_train_step(cfg, None, make_optimizer(model, 3e-4))
    tokens = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab, (B, T)))
    batch = {"tokens": tokens.to(dev),
             "targets": torch.roll(tokens, -1, dims=1).to(dev)}
    return model, step, batch


def phase_train_vs_cpu(dev) -> dict:
    """Three f32 AdamW steps with flash attention and remat, on the CPU
    (plain versions) and twice on the card (kernels)."""
    from k8s_gpu_scheduler_tpu_torch.models.llama import LlamaConfig
    from k8s_gpu_scheduler_tpu_torch.ops.flash_attention import (
        counters, reset_counters)

    cfg = LlamaConfig(vocab=256, d_model=256, n_layers=2, n_heads=4,
                      n_kv_heads=2, d_ff=512, max_seq=128,
                      dtype=torch.float32, attn_impl="flash", remat=True)
    steps = 3

    def losses(where):
        model, step, batch = train_setup(where, cfg, 2, 128)
        return [float(step(model, batch)) for _ in range(steps)]

    cpu = losses("cpu")
    reset_counters()
    card = losses(dev)
    c = counters()
    again = losses(dev)
    log(f"  cpu losses {cpu}")
    log(f"  gpu losses {card}, replay {again}, counters {c}")
    rel = max(abs(a - b) / abs(b) for a, b in zip(card, cpu))
    want = (2 * cfg.n_layers * steps, cfg.n_layers * steps,
            cfg.n_layers * steps)
    if rel > 1e-5:
        raise SystemExit(f"training on the card diverges from the CPU: "
                         f"{card} vs {cpu} (rel {rel:.2e})")
    if tuple(c[k] for k in FLASH) != want or any(c[k] for k in FLASH_PLAIN):
        raise SystemExit(f"card training launched {c}, want {want} and no "
                         f"plain version")
    if again != card:
        raise SystemExit(f"a second card run did not replay: {again}")
    return dict(cpu=cpu, gpu=card, max_rel_diff=rel, launches=c)


def phase_train_full_width(dev, card, profile_too, n_layers) -> dict:
    """The training main path at the llama3_8b widths, depth cut to
    ``n_layers``."""
    from k8s_gpu_scheduler_tpu_torch.models.llama import LlamaConfig
    from k8s_gpu_scheduler_tpu_torch.ops.flash_attention import (
        counters, reset_counters)

    B, T = 8, 2048
    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), n_layers=n_layers,
                              attn_impl="flash")
    log(f"  cut: n_layers 32 -> {cfg.n_layers} (weights, gradients and "
        f"AdamW moments of 32 layers do not fit one 80 GB card; the default "
        f"4 keeps the peak far below the card's memory, PERF.md gives the "
        f"deepest that fits); widths, B {B} and T {T} as main()")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model, step, batch = train_setup(dev, cfg, B, T, on_card=True)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  [{card}] {n_params} parameters, set up in "
        f"{time.perf_counter() - t0:.1f} s")
    losses = [float(step(model, batch))]                 # warm-up
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    step_s, pending = [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        pending.append(step(model, batch))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
    c = counters()
    losses += [float(x) for x in pending]
    mean_s = sum(step_s) / len(step_s)
    tok_s = B * T / mean_s
    st = dict(B=B, T=T, n_layers=cfg.n_layers, n_params=n_params,
              losses=losses, step_ms=[1e3 * x for x in step_s],
              mean_step_ms=1e3 * mean_s, tokens_per_s=tok_s,
              mfu=tok_s * cfg.flops_per_token(T) / PEAK_FLOPS[torch.bfloat16],
              flops_per_token=cfg.flops_per_token(T),
              max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
              launches=c)
    log(f"  [{card}] {json.dumps(st)}")
    want = (2 * cfg.n_layers * TRAIN_STEPS, cfg.n_layers * TRAIN_STEPS,
            cfg.n_layers * TRAIN_STEPS)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise SystemExit(f"full-width training: losses {losses}")
    if tuple(c[k] for k in FLASH) != want or any(c[k] for k in FLASH_PLAIN):
        raise SystemExit(f"full-width training launched {c}, want {want} "
                         f"and no plain version")
    if profile_too:
        log("profile: where a full-width training step's device time goes")
        profiled(card, "train step", lambda: timed_step(step, model, batch))
    return st


def timed_step(step, model, batch):
    torch.cuda.synchronize()
    t = time.perf_counter()
    loss = step(model, batch)
    torch.cuda.synchronize()
    return loss, dict(wall_s=time.perf_counter() - t, loss=float(loss))


# -- main ---------------------------------------------------------------------------

# -- phases 10-12: the entry point and the fleet tier ----------------------
SERVE_TICKS = 64                 # main --serve: max_new 64 = chunk 64


class _WaveTap:
    """Stands in for ``sys.stdout`` around ``main()``: echoes and keeps
    every line, and after the ``stop_after``-th wave line raises SIGTERM
    in this (the main) thread, so the guard is set before the loop's next
    wave-boundary check: exactly ``stop_after`` waves run."""

    def __init__(self, out, stop_after):
        self.out, self.stop_after = out, stop_after
        self.lines, self._buf = [], ""

    def write(self, s):
        self.out.write(s)
        self._buf += s
        while "\n" in self._buf:
            line, self._buf = self._buf.split("\n", 1)
            self.lines.append(line)
            waves = sum(ln.startswith("llama serve qps=")
                        for ln in self.lines)
            if line.startswith("llama serve qps=") \
                    and waves == self.stop_after:
                import signal

                signal.raise_signal(signal.SIGTERM)
        return len(s)

    def flush(self):
        self.out.flush()


def run_main(dev, argv, waves):
    """``main(argv)`` in this process until SIGTERM after ``waves`` waves:
    (exit code, output lines, counters of the run, restores made)."""
    from k8s_gpu_scheduler_tpu_torch.models import llama
    from k8s_gpu_scheduler_tpu_torch.models.serving import ContinuousBatcher
    from k8s_gpu_scheduler_tpu_torch.ops import decode_attention as da

    restores, real = [], ContinuousBatcher.restore

    def restore(self, snap):
        restores.append(snap.n_requests_in_flight)
        return real(self, snap)

    tap, stdout = _WaveTap(sys.stdout, waves), sys.stdout
    ContinuousBatcher.restore = restore
    sys.stdout = tap
    code = None
    try:
        torch.cuda.synchronize()
        da.reset_counters()
        llama.main(argv, device=dev)
    except SystemExit as e:
        code = e.code
    finally:
        sys.stdout = stdout
        ContinuousBatcher.restore = real
    torch.cuda.synchronize()
    return code, tap.lines, da.counters(), restores


def phase_main_serve(dev, card) -> dict:
    """Phase 10a: ``main --serve`` through the real entry point."""
    import shutil
    import signal

    from k8s_gpu_scheduler_tpu_torch.models import lifecycle
    from k8s_gpu_scheduler_tpu_torch.utils import enforcement

    layers = 8
    tmp = tempfile.mkdtemp(prefix="main_serve_")
    snap_dir = os.path.join(tmp, "serve_snapshot")
    prev = signal.getsignal(signal.SIGTERM)
    runs = {}
    total = torch.cuda.get_device_properties(dev).total_memory
    try:
        for label, extra, waves, env in (
                ("bf16", [], 2, {}),
                ("resumed", [], 1, {}),
                ("int8", ["--int8"], 1,
                 {"TPU_HBM_LIMIT_BYTES": str(total // 2)})):
            os.environ.update(env)
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            try:
                code, lines, c, restores = run_main(
                    dev, ["--serve", "--ckpt-dir", tmp] + extra, waves)
                fraction = (torch.cuda.get_per_process_memory_fraction(0)
                            if env else None)
            finally:
                for k in env:
                    os.environ.pop(k)
                torch.cuda.set_per_process_memory_fraction(1.0, dev)
            wall = time.perf_counter() - t0
            parsed = [dict(kv.split("=") for kv in ln.split()[2:])
                      for ln in lines if ln.startswith("llama serve qps=")]
            # warmup: one dispatch; a wave: 4 x 8 slots, one dispatch each
            want = (1 + 4 * len(parsed)) * SERVE_TICKS * layers
            st = dict(exit=code, waves=len(parsed), lines=lines,
                      wall_s=wall, restores=restores,
                      steps=lifecycle._steps(snap_dir),
                      k1=c["paged_decode_attention"], k1_predicted=want,
                      decode_tok_s=[float(p["decode_tok_s"])
                                    for p in parsed])
            if env:
                st["fraction"] = fraction
                st["fraction_computed"] = enforcement.hbm_fraction(
                    env, total)
            log(f"  [{card}] main --serve {label}: {json.dumps(st)}")
            runs[label] = st
            if code != 0:
                raise SystemExit(f"main --serve {label} exited {code!r}")
            if len(parsed) != waves or not all(
                    x > 0 for x in st["decode_tok_s"]):
                raise SystemExit(f"main --serve {label}: wave lines {lines}")
            if st["k1"] != want or any(c[k] for k in PLAIN):
                raise SystemExit(f"main --serve {label} launched {c}, K1 "
                                 f"predicted {want}")
            if lifecycle.load_snapshot(snap_dir) is None:
                raise SystemExit(f"main --serve {label} wrote no snapshot")
            if label != "bf16" and restores != [0]:
                raise SystemExit(f"main --serve {label} did not boot "
                                 f"through resume_or_fresh: {restores}")
            if env and st["fraction"] != st["fraction_computed"]:
                raise SystemExit(f"memory fraction {st['fraction']} != "
                                 f"{st['fraction_computed']}")
    finally:
        signal.signal(signal.SIGTERM, prev)
        shutil.rmtree(tmp, ignore_errors=True)
    return runs


RESUME_BT = (8, 2048)            # phase 10b: phase 6's batch
RESUME_LAYERS = 2                # phase 10b: phase 6's 4 layers cut to 2
                                 # for the script's time limit


def phase_train_resume(dev, card) -> dict:
    """Phase 10b: ``train_loop`` at phase 6's widths and batch and
    ``RESUME_LAYERS`` layers, checkpointed at step 2
    by ``TrainCheckpointer`` and resumed into fresh objects for steps
    3-4; the losses must equal an uninterrupted 4-step run bit for bit.
    Then ``main()``'s training branch at 32 layers must refuse before
    allocating."""
    import shutil

    from k8s_gpu_scheduler_tpu_torch.models import llama
    from k8s_gpu_scheduler_tpu_torch.models.llama import (
        Llama, LlamaConfig, make_optimizer, train_loop)
    from k8s_gpu_scheduler_tpu_torch.ops.flash_attention import (
        counters, reset_counters)
    from k8s_gpu_scheduler_tpu_torch.utils.checkpoint import (
        TrainCheckpointer)

    (B, T), layers = RESUME_BT, RESUME_LAYERS
    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), n_layers=layers,
                              attn_impl="flash")
    torch.cuda.empty_cache()
    model, _, batch = train_setup(dev, cfg, B, T, on_card=True)
    state0 = {k: v.detach().cpu().clone()
              for k, v in model.state_dict().items()}
    ref = train_loop(model, make_optimizer(model, 3e-4), batch, max_steps=4)
    ref = torch.stack(ref).cpu()
    del model

    def fresh():
        m = Llama(cfg, dev)
        return m, make_optimizer(m, 3e-4)

    tmp = tempfile.mkdtemp(prefix="train_resume_")
    try:
        torch.cuda.empty_cache()
        model, opt = fresh()
        model.load_state_dict(state0)
        ck = TrainCheckpointer(tmp)
        save_ms = []
        real_save = ck.save

        def timed_save(step, state, force=False):
            out, ms = _synced_ms(lambda: real_save(step, state, force))
            save_ms.append(ms)
            return out

        ck.save = timed_save
        first = train_loop(model, opt, batch, ck, every=2, max_steps=2)
        first = torch.stack(first).cpu()
        del model, opt
        torch.cuda.empty_cache()
        ck = TrainCheckpointer(tmp)
        nbytes = sum(os.path.getsize(os.path.join(r, f))
                     for r, _, fs in os.walk(tmp) for f in fs)
        (step_no, (model, opt)), restore_ms = _synced_ms(
            lambda: ck.restore_or(fresh))
        reset_counters()
        rest = train_loop(model, opt, batch, ck, step_no=step_no, every=2,
                          max_steps=4)
        torch.cuda.synchronize()
        c = counters()
        rest = torch.stack(rest).cpu()
        del model, opt
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    got = torch.cat([first, rest])
    st = dict(B=B, T=T, n_layers=layers, ref_losses=ref.tolist(),
              resumed_losses=got.tolist(), bitwise=torch.equal(got, ref),
              restored_step=step_no, save_ms=save_ms, restore_ms=restore_ms,
              checkpoint_bytes=nbytes, launches=c)
    log(f"  [{card}] {json.dumps(st)}")
    want = (2 * layers * 2, layers * 2, layers * 2)
    if step_no != 2 or not st["bitwise"]:
        raise SystemExit(f"training resumed at {step_no}, losses {got} vs "
                         f"{ref}")
    if tuple(c[k] for k in FLASH) != want or any(c[k] for k in FLASH_PLAIN):
        raise SystemExit(f"resumed training launched {c}, want {want}")
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)
    try:
        llama.main([], device=dev)
        raise SystemExit("main()'s 32-layer training branch did not refuse")
    except SystemExit as e:
        msg = str(e.code)
    need = llama.train_state_bytes(LlamaConfig.llama3_8b())
    if str(need) not in msg or torch.cuda.memory_allocated(dev) != before:
        raise SystemExit(f"main()'s training branch: {msg!r}, allocated "
                         f"{torch.cuda.memory_allocated(dev) - before} B")
    log(f"  main() training branch refused before allocating: {msg}")
    st["refusal"] = msg
    st["launches"] = dict(c)
    return st


FLEET_CFG = dict(vocab=32000, d_model=1024, n_layers=4, n_heads=16,
                 n_kv_heads=16, d_ff=4096, max_seq=2048, remat=False,
                 decode_attn="fused")
FLEET_ENGINE = dict(n_slots=8, max_len=2048, chunk=8, prefill_bucket=128,
                    kv_layout="paged", page_size=64, kv_dtype="int8",
                    prefix_cache=True)
FLEET_REQUESTS = 96             # bench_fleet's TPU trace
FLEET_RUN = 48                  # phases 11 and 12a drive its first 48 (96
                                # before the script's time limit forced it)


def fleet_trace(vocab, n_req, rate=2.0, n_classes=3, page=64, seed=0,
                max_new=48):
    """bench_fleet's trace: ``n_req`` prompts over ``n_classes`` hot
    two-page system prompts plus 3-9 unique tokens each, class order and
    Poisson arrivals (in router steps) from one numpy seed; returns the
    schedule (arrival, prompt, max_new) and each request's class."""
    rng = np.random.default_rng(seed)
    hot = [list(rng.integers(0, vocab, 2 * page)) for _ in range(n_classes)]
    classes = [int(c) for c in rng.integers(0, n_classes, n_req)]
    prompts = [hot[c] + list(rng.integers(0, vocab, 3 + i % 7))
               for i, c in enumerate(classes)]
    arrive = np.floor(np.cumsum(
        rng.exponential(1.0 / rate, n_req))).astype(int)
    return [(int(a), p, max_new) for a, p in zip(arrive, prompts)], classes


def fleet_model(dev, dtype):
    from k8s_gpu_scheduler_tpu_torch.models.llama import (
        LlamaConfig, init_params)

    cfg = LlamaConfig(**FLEET_CFG, dtype=dtype)
    return cfg, init_params(cfg, torch.Generator().manual_seed(0), dev)


def dense_logits(model, x, int8=False) -> torch.Tensor:
    """The dense forward's logits [B, T, vocab] f32 for tokens ``x``; with
    ``int8`` every K/V row is first rounded through the engine's
    per-token-per-head int8 (``_kv_quant``), as the paged pools hold it."""
    from k8s_gpu_scheduler_tpu_torch.models.llama import (
        attn_sublayer, mlp_sublayer)
    from k8s_gpu_scheduler_tpu_torch.models.serving import _kv_quant
    from k8s_gpu_scheduler_tpu_torch.ops.attention import dense_attention
    from k8s_gpu_scheduler_tpu_torch.ops.layers import rms_norm, rope_freqs
    from k8s_gpu_scheduler_tpu_torch.ops.quant import qdot

    cfg = model.cfg

    def rounded(t):
        if not int8:
            return t
        q, scale = _kv_quant(t)
        return (q.float() * scale).to(t.dtype)

    def attend(q, k, v):
        return dense_attention(q, rounded(k), rounded(v), causal=True)

    angles = rope_freqs(cfg.head_dim, x.shape[1], cfg.rope_theta,
                        device=x.device)
    h = model.embed[x].to(cfg.dtype)
    with torch.no_grad():
        for blk in model.blocks:
            h, _ = mlp_sublayer(cfg, attn_sublayer(cfg, h, blk, angles,
                                                   attend), blk, dropless=True)
        return qdot(rms_norm(h, model.final_norm), model.lm_head).float()


def logit_spread(model, cfg, dev) -> dict:
    """Max |logit| movement of one 135-token row under what differs between
    two schedules of one request: the batch it is computed in (alone
    against inside a batch of 8; cuBLAS picks its GEMM by the batch's
    size) and its K/V's int8 rounding (with against without; one bf16 unit
    of difference can move a row's int8 code by a step)."""
    x = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (8, 135))).to(dev)
    alone = dense_logits(model, x[:1], int8=True)
    return dict(
        batch=(alone - dense_logits(model, x, int8=True)[:1]).abs().max(
            ).item(),
        int8=(alone - dense_logits(model, x[:1])).abs().max().item())


# A bf16 parting token's largest logit gap below the dense forward's top,
# in units of ``logit_spread``: two near-tied tokens sit within about
# twice that spread of each other, while a wrong page, scale or replay
# picks a token far below the top.
NEAR_TIE = 4.0
# The share of bf16 streams that may part from their reference: PERF.md
# §6 reads 9 and 11 of 96 (fleet), 2 of 96 (crash), 0 of 48 (disagg),
# and 11 of 24 after the journal restart, whose streams are all
# re-prefilled mid-stream.
PART_CAP = {"fleet": 0.25, "chaos": 0.25, "journal": 0.5, "disagg": 0.25}


def check_full(label, streams, budgets) -> None:
    """Every stream came back with its whole budget (no eos is set)."""
    short = [i for i, (s, m) in enumerate(zip(streams, budgets))
             if s is None or len(s) != m]
    if len(streams) != len(budgets) or short:
        raise SystemExit(f"{label}: {len(short)} of {len(budgets)} streams "
                         f"missing or short, first {short[:5]}")


def check_delivered(label, router, streams, budgets, faults=False) -> None:
    """``Router.step`` isolates a replica's raise into a health transition
    and fails requests into ``router.errors``: fail unless no request
    errored or was lost and every stream is whole, and, with no fault
    injected, unless every replica stayed live."""
    stt = router.stats()
    if router.errors or stt["requests_lost"] or (
            not faults and router.health.transition_count):
        raise SystemExit(
            f"{label}: errors {router.errors}, lost {stt['requests_lost']}, "
            f"health {stt['health_states']} after "
            f"{router.health.transition_count} transitions")
    check_full(label, streams, budgets)


def parting_gaps(model, prompts, streams, ref, int8=True) -> list:
    """For each stream that parts from its reference: the dense forward's
    logits (``int8``: its K/V rounded as an int8 pool holds them) after the
    prompt and the common prefix, and the larger of the two parting
    tokens' gaps below their top."""
    gaps = []
    for p, s, r in zip(prompts, streams, ref):
        if s == r:
            continue
        pos = next(j for j, (a, b) in enumerate(zip(s, r)) if a != b)
        x = torch.tensor([[int(t) for t in list(p) + r[:pos]]],
                         device=model.device)
        lg = dense_logits(model, x, int8=int8)[0, -1]
        gaps.append((lg.max() - torch.minimum(lg[s[pos]], lg[r[pos]])
                     ).item())
    return gaps


def check_streams(label, dtype, streams, ref, prompts, model, spread,
                  cap) -> dict:
    """Greedy identity against ``ref`` (both whole): exact in f32. In bf16
    at most ``cap`` of the streams may part, each at a near-tie: both
    parting tokens within ``NEAR_TIE`` times the larger ``logit_spread``
    of the dense forward's top logit. The gate proves it can see a fault:
    the first 8 reference streams, each with its middle token swapped for
    a far one (as a wrong page or scale derails a stream), must all fail
    it. Returns the streams differing, the first divergence and the
    largest parting and smallest fault gaps in units of the spread."""
    n_bad, where = first_divergence(streams, ref)
    out = dict(streams_differing=n_bad, first_divergence=where)
    if dtype == torch.float32:
        if n_bad:
            raise SystemExit(f"{label} (f32): {n_bad} streams differ, "
                             f"first at {where}")
        return out
    unit = max(spread.values())
    gaps = parting_gaps(model, prompts, streams, ref)
    faults = []
    for r in ref[:8]:
        j = len(r) // 2
        faults.append(r[:j] + [(r[j] + model.cfg.vocab // 2)
                               % model.cfg.vocab] + r[j + 1:])
    caught = parting_gaps(model, prompts[:8], faults, ref[:8])
    out.update(worst_gap_over_spread=max(gaps, default=0.0) / unit,
               fault_gap_over_spread=min(caught) / unit)
    if n_bad > cap * len(ref) or max(gaps, default=0.0) > NEAR_TIE * unit:
        raise SystemExit(
            f"{label} (bf16): {n_bad} of {len(ref)} streams part (cap "
            f"{cap}), gaps {gaps} against a spread of {spread}")
    if min(caught) <= NEAR_TIE * unit:
        raise SystemExit(f"{label} (bf16): the near-tie gate misses a "
                         f"fault: gaps {caught} against {spread}")
    return out


def first_divergence(streams, ref):
    """(requests whose stream differs, first (request, token) that does),
    for whole streams of equal budgets."""
    bad = [i for i, (s, r) in enumerate(zip(streams, ref)) if s != r]
    if not bad:
        return 0, None
    s, r = streams[bad[0]], ref[bad[0]]
    return len(bad), (bad[0], next(j for j, (a, b) in enumerate(zip(s, r))
                                   if a != b))


def fleet_drive(router, sched, clock=None, shed_at=None):
    """The bench legs' loop over ``sched`` (arrival step, prompt, max_new):
    submit on schedule, step the router until everything is done,
    advancing ``clock`` 20 ms a step; with ``shed_at``, force one shed off
    the busiest replica once that many requests were submitted. Returns
    (streams, migrated, wall s, router steps)."""
    from k8s_gpu_scheduler_tpu_torch.fleet import FleetError

    frids, done, migrated, nxt, t = [], {}, 0, 0, 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while nxt < len(sched) or router.pending:
        while nxt < len(sched) and sched[nxt][0] <= t:
            frids.append(router.submit(sched[nxt][1], max_new=sched[nxt][2]))
            nxt += 1
        done.update(router.step())
        if clock is not None:
            clock.advance(0.02)
        if shed_at is not None and nxt >= shed_at and migrated == 0:
            stats = {r: rep.engine.replica_stats()
                     for r, rep in router._replicas.items()}
            src = max(stats, key=lambda r: (stats[r]["active_slots"], r))
            dst = min(stats, key=lambda r: (stats[r]["active_slots"], r))
            if src != dst and stats[src]["active_slots"] > 1:
                try:
                    migrated = router.shed(src, dst)
                except FleetError:
                    pass            # the target is tight this step
        t += 1
    torch.cuda.synchronize()
    return [done.get(f) for f in frids], migrated, \
        time.perf_counter() - t0, t


def phase_fleet(dev, card, dtype, n_req=FLEET_RUN) -> dict:
    """Phase 11: bench_fleet's TPU configuration on one card: 3 replicas,
    affinity (with one forced shed) and round-robin on one Poisson
    trace, every stream whole and against a single engine's
    (``check_streams``)."""
    from k8s_gpu_scheduler_tpu_torch.fleet import Router
    from k8s_gpu_scheduler_tpu_torch.models.serving import ContinuousBatcher
    from k8s_gpu_scheduler_tpu_torch.ops import decode_attention as da

    cfg, model = fleet_model(dev, dtype)
    sched, classes = fleet_trace(cfg.vocab, FLEET_REQUESTS)
    sched, classes = sched[:n_req], classes[:n_req]
    prompts, budgets = [p for _, p, _ in sched], [m for _, _, m in sched]
    ref = drive(ContinuousBatcher(model, cfg, device=dev, **FLEET_ENGINE),
                prompts, budgets)
    check_full("one engine", ref, budgets)
    out = {"logit_spread": logit_spread(model, cfg, dev)}
    log(f"  [{card}] {dtype}: a row's logits move by up to "
        f"{out['logit_spread']['batch']} between a batch of 1 and of 8, and "
        f"{out['logit_spread']['int8']} with its K/V rounded through int8")
    for policy in ("affinity", "round_robin"):
        router = Router([(f"r{i}", ContinuousBatcher(
            model, cfg, device=dev, **FLEET_ENGINE)) for i in range(3)],
            policy=policy)
        da.reset_counters()
        streams, migrated, wall, steps = fleet_drive(
            router, sched,
            shed_at=n_req // 2 if policy == "affinity" else None)
        c = da.counters()
        met = router.pop_request_metrics()
        ttft = sorted(m["ttft_s"] * 1e3 for m in met.values())
        by_class = {}
        for frid, m in met.items():
            by_class.setdefault(classes[frid], []).append(m["ttft_s"] * 1e3)
        stt = router.stats()
        check_delivered(f"fleet {policy}", router, streams, budgets)
        st = dict(dtype=str(dtype), requests=n_req, router_steps=steps,
                  wall_s=wall,
                  tokens_per_s=sum(map(len, streams)) / wall,
                  ttft_p50_ms=ttft[len(ttft) // 2],
                  ttft_p50_ms_by_class={
                      k: sorted(v)[len(v) // 2]
                      for k, v in sorted(by_class.items())},
                  prefix_hit_rate=stt["aggregate_prefix_hit_rate"],
                  migrated=migrated, degraded_routes=stt["degraded_routes"],
                  launches=c)
        st.update(check_streams(f"fleet {policy}", dtype, streams, ref,
                                prompts, model, out["logit_spread"],
                                PART_CAP["fleet"]))
        log(f"  [{card}] fleet {policy}: {json.dumps(st)}")
        out[policy] = st
        if not (c["paged_decode_attention"] and c["paged_prefill_attention"]) \
                or any(c[k] for k in PLAIN):
            raise SystemExit(f"fleet {policy} launched {c}")
    if not out["affinity"]["prefix_hit_rate"] \
            > out["round_robin"]["prefix_hit_rate"]:
        raise SystemExit("affinity's prefix-hit rate is not above "
                         "round-robin's")
    if out["affinity"]["migrated"] < 1:
        raise SystemExit("the forced shed migrated nothing")
    return out


def phase_fleet_chaos(dev, card, dtype, n_req=FLEET_RUN) -> dict:
    """Phase 12a: bench_fleet_chaos's shape. A ``FaultProxy`` around r1
    makes its ``step`` raise ``ReplicaCrashed`` from its 10th call on, so
    the router declares it dead, replays its journaled requests on the
    survivors and rebuilds it through the engine factory. Against the
    same fleet's no-fault run: nothing lost, every stream whole and equal
    (``check_streams``), replayed ≤ delivered tokens. Then ``checkpoint_journal``
    mid-run, and a fresh router over ``load_journal`` finishes the open
    entries."""
    import shutil

    from k8s_gpu_scheduler_tpu_torch import obs
    from k8s_gpu_scheduler_tpu_torch.fleet import HealthPolicy, Router
    from k8s_gpu_scheduler_tpu_torch.metrics.exporter import (
        FLEET_LOST_TOTAL, Registry)
    from k8s_gpu_scheduler_tpu_torch.models.serving import ContinuousBatcher
    from k8s_gpu_scheduler_tpu_torch.ops import decode_attention as da
    from k8s_gpu_scheduler_tpu_torch.testing.faults import (
        FaultInjector, FaultProxy, FaultRule, ReplicaCrashed)
    from k8s_gpu_scheduler_tpu_torch.utils.retry import RetryPolicy

    cfg, model = fleet_model(dev, dtype)
    sched = fleet_trace(cfg.vocab, FLEET_REQUESTS)[0][:n_req]
    prompts, budgets = [p for _, p, _ in sched], [m for _, _, m in sched]
    spread = logit_spread(model, cfg, dev)

    def factory(rid):
        return ContinuousBatcher(model, cfg, device=dev, **FLEET_ENGINE)

    def fleet(faulty, journal_dir=None):
        clock = obs.VirtualClock()
        inj = FaultInjector(seed=13, rules=[
            FaultRule("r1.step", "crash", after=9, every=1)])
        engines = [(f"r{i}", factory(f"r{i}")) for i in range(3)]
        if faulty:
            engines[1] = ("r1", FaultProxy(engines[1][1], inj, "r1",
                                           drop_exc=ReplicaCrashed))
        reg = Registry()
        router = Router(
            engines, metrics=reg, engine_factory=factory, clock=clock,
            journal_dir=journal_dir,
            health=HealthPolicy(quarantine=RetryPolicy(
                attempts=8, base_s=0.05, multiplier=2.0, max_s=0.2,
                jitter=0.5)), health_seed=13)
        return router, reg, inj, clock

    clean, _, _, clk = fleet(False)
    want, _, clean_wall, _ = fleet_drive(clean, sched, clock=clk)
    check_delivered("no-fault fleet", clean, want, budgets)
    router, reg, inj, clk = fleet(True)
    da.reset_counters()
    got, _, wall, steps = fleet_drive(router, sched, clock=clk)
    c = da.counters()
    stt = router.stats()
    lost = sum(reg.counter(FLEET_LOST_TOTAL).value(replica=f"r{i}")
               for i in range(3)) + reg.counter(FLEET_LOST_TOTAL).value()
    st = dict(dtype=str(dtype), requests=n_req, router_steps=steps,
              wall_s=wall,
              no_fault_wall_s=clean_wall, injected=len(inj.log),
              failovers=stt["failovers"], lost=lost,
              replayed_tokens=stt["replayed_tokens"],
              delivered_tokens=stt["journal_delivered_tokens"],
              health_states=stt["health_states"], errors=len(router.errors),
              launches=c)
    log(f"  [{card}] fleet chaos: {json.dumps(st)}")
    if lost or stt["failovers"] < 1 \
            or stt["replayed_tokens"] > stt["journal_delivered_tokens"]:
        raise SystemExit(f"fleet chaos: {st}, errors {router.errors}")
    check_delivered("fleet chaos", router, got, budgets, faults=True)
    st.update(check_streams("fleet chaos", dtype, got, want, prompts, model,
                            spread, PART_CAP["chaos"]))
    log(f"  [{card}] crash against no fault: {st['streams_differing']} "
        f"streams differ, worst gap {st.get('worst_gap_over_spread')}")
    if not c["paged_decode_attention"] or any(c[k] for k in PLAIN):
        raise SystemExit(f"fleet chaos launched {c}")
    # The journal across a router restart.
    jdir = tempfile.mkdtemp(prefix="journal_")
    try:
        r1, _, _, clk = fleet(False, jdir)
        for _, p, max_new in sched[:24]:
            r1.submit(p, max_new=max_new)
        for _ in range(3):
            r1.step()
            clk.advance(0.02)
        r1.checkpoint_journal()
        open_before = {f: r1.journal.stream(f)
                       for f in r1.journal.open_frids()}
        if r1.errors or r1.health.transition_count:
            raise SystemExit(f"journal restart: the first router failed "
                             f"{r1.errors}")
        del r1
        r2, _, _, clk = fleet(False, jdir)
        done = {}
        while r2.pending:
            done.update(r2.step())
            clk.advance(0.02)
    finally:
        shutil.rmtree(jdir, ignore_errors=True)
    frids = sorted(open_before)
    if set(done) != set(open_before) or not open_before:
        raise SystemExit(f"journal restart: {len(open_before)} open entries, "
                         f"{len(done)} finished")
    check_delivered("journal restart", r2, [done[f] for f in frids],
                    [budgets[f] for f in frids])
    st["journal_restart"] = dict(
        open_entries=len(open_before), finished=len(done), lost=0,
        **check_streams("journal restart", dtype, [done[f] for f in frids],
                        [want[f] for f in frids],
                        [prompts[f] for f in frids], model, spread,
                        PART_CAP["journal"]))
    log(f"  [{card}] journal restart: {json.dumps(st['journal_restart'])}")
    return st


def disagg_trace(vocab, seed=0):
    """bench_disagg's trace: 38 shorts of 64 tokens (64 new) at 2.0 a
    step, two 1024-token longs (16 new) at steps 8 and 20, each with a
    burst of four shorts."""
    rng = np.random.default_rng(seed)
    arr = np.floor(np.cumsum(rng.exponential(1.0 / 2.0, 38))).astype(int)
    sched = [(int(s), list(rng.integers(0, vocab, 64)), 64) for s in arr]
    for ls in (8, 20):
        sched.append((ls, list(rng.integers(0, vocab, 1024)), 16))
        for burst in (ls, ls + 1):
            for _ in range(2):
                sched.append((burst, list(rng.integers(0, vocab, 64)), 64))
    sched.sort(key=lambda e: e[0])
    return sched


def phase_disagg(dev, card, dtype) -> dict:
    """Phase 12b: bench_disagg's shape — one role="prefill" replica
    (chunked prefill, 256 tokens a step) and two role="decode" replicas,
    against a mixed fleet of three, on one trace: every stream whole and
    equal (``check_streams``), every request handed off."""
    from k8s_gpu_scheduler_tpu_torch import obs
    from k8s_gpu_scheduler_tpu_torch.fleet import Router
    from k8s_gpu_scheduler_tpu_torch.metrics.exporter import Registry
    from k8s_gpu_scheduler_tpu_torch.models.serving import ContinuousBatcher
    from k8s_gpu_scheduler_tpu_torch.ops import decode_attention as da

    cfg, model = fleet_model(dev, dtype)
    sched = disagg_trace(cfg.vocab)
    prompts, budgets = [p for _, p, _ in sched], [m for _, _, m in sched]
    kw = dict(FLEET_ENGINE, prefix_cache=False)

    def engine(**extra):
        return ContinuousBatcher(model, cfg, device=dev, **kw, **extra)

    out = {}
    for label in ("mixed", "disagg"):
        if label == "mixed":
            reps = [(f"m{i}", engine(prefill_chunk_tokens=256))
                    for i in range(3)]
            pools = None
        else:
            reps = [("p0", engine(role="prefill", prefill_chunk_tokens=256)),
                    ("d0", engine(role="decode")),
                    ("d1", engine(role="decode"))]
            pools = {"prefill": ["p0"], "decode": ["d0", "d1"]}
        tr = obs.Tracer()
        router = Router(reps, pools=pools, policy="round_robin",
                        metrics=Registry(), tracer=tr)
        da.reset_counters()
        streams, _, wall, t = fleet_drive(router, sched)
        c = da.counters()
        stt = router.stats()
        check_delivered(f"{label} fleet", router, streams, budgets)
        hand = [1e3 * (s.t1 - s.t0) for s in tr.spans()
                if s.name == "handoff"]
        out[label] = dict(streams=streams,
                          stats=dict(
                              requests=len(sched), router_steps=t,
                              wall_s=wall, handoffs=stt["handoffs"],
                              lost=stt["requests_lost"],
                              handoff_ms_p50=(sorted(hand)[len(hand) // 2]
                                              if hand else None),
                              handoff_ms_max=max(hand) if hand else None,
                              launches=c))
        log(f"  [{card}] {label}: {json.dumps(out[label]['stats'])}")
        if not (c["paged_decode_attention"] and c["paged_prefill_attention"]) \
                or any(c[k] for k in PLAIN):
            raise SystemExit(f"{label} fleet launched {c}")
    st = out["disagg"]["stats"]
    if st["handoffs"] != len(sched):
        raise SystemExit(f"disaggregated fleet: {st}")
    st.update(dtype=str(dtype), **check_streams(
        "disaggregated fleet", dtype, out["disagg"]["streams"],
        out["mixed"]["streams"], prompts, model,
        logit_spread(model, cfg, dev), PART_CAP["disagg"]))
    log(f"  [{card}] disagg against mixed: {st['streams_differing']} "
        f"streams differ, worst gap {st.get('worst_gap_over_spread')}")
    return dict(mixed=out["mixed"]["stats"], disagg=st)


def sass_counts(lib, opcode: str) -> dict:
    """{kernel: count of ``opcode`` instructions in its SASS} for the
    kernels of ``lib`` that have any, from ``cuobjdump -sass``; empty where
    the toolkit has no cuobjdump."""
    import shutil
    from pathlib import Path

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return {}
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True).stdout
    if shutil.which("c++filt"):                    # readable kernel names
        sass = subprocess.run(["c++filt"], input=sass, capture_output=True,
                              text=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
        elif name and f" {opcode}" in line:
            counts[name] = counts.get(name, 0) + 1
    return counts


def phases_10_to_12(dev, card) -> None:
    log("phase 10: the entry point. (a) main --serve, bf16, int8, resumed")
    phase_main_serve(dev, card)
    log(f"  (b) training resumed from a TrainCheckpointer (llama3_8b "
        f"widths, {RESUME_LAYERS} layers, B 8, T 2048)")
    phase_train_resume(dev, card)
    for dtype in (torch.bfloat16, torch.float32):
        log(f"phase 11: the fleet at bench_fleet's configuration (3 "
            f"replicas, 4 layers, int8 KV), {dtype}")
        phase_fleet(dev, card, dtype)
        log(f"phase 12: (a) a replica crashed by a FaultProxy, then the "
            f"journal across a router restart, {dtype}")
        phase_fleet_chaos(dev, card, dtype)
        log(f"  (b) disaggregated pools against a mixed fleet, {dtype}")
        phase_disagg(dev, card, dtype)


# -- phases 13-16: mixture-of-experts, BERT-base and ResNet-50 -------------
# Mixtral-8x7B's published widths (mistralai/Mixtral-8x7B-v0.1 config.json:
# hidden 4096, 32 heads, 8 kv heads, intermediate 14336, 8 local experts, 2
# a token, vocab 32000, rope_theta 1e6), written as the port's LlamaConfig.
# Cuts: depth 32 -> 8 for serving (the serve config's depth) and 4 for
# training; max_seq 2048 (the serve config's; the traffic needs 576).
MOE_CFG = dict(vocab=32000, d_model=4096, n_heads=32, n_kv_heads=8,
               d_ff=14336, max_seq=2048, rope_theta=1e6, n_experts=8,
               moe_top_k=2, decode_attn="fused")
MOE_SERVE_LAYERS = 8
MOE_TRAIN_LAYERS = 4
MOE_TRAIN_STEPS = 2             # timed, after one warm-up step
MOE_TRAIN_BT = (8, 2048)
SMALL_MOE = dict(vocab=256, d_model=256, n_layers=2, n_heads=4, n_kv_heads=2,
                 d_ff=512, max_seq=256, dtype=torch.float32,
                 decode_attn="fused", remat=False, n_experts=4, moe_top_k=2)


def card_init(cfg, dev, seed=0, mesh=None):
    """A ``Llama`` of ``cfg`` on ``dev``: normal(0, 0.02) matrices (an MoE
    router in f32) and unit norms, drawn on the card from ``seed``
    (``init_params`` draws on the CPU, about 90 s at 11.9 B parameters).
    ``mesh``: this rank's blocks (``llama.rank_layout``) of the same
    draws, each leaf drawn whole on the card and cut."""
    from k8s_gpu_scheduler_tpu_torch.models.llama import (
        Llama, rank_layout, rank_model)
    from k8s_gpu_scheduler_tpu_torch.parallel.mesh import MeshAxes

    gen = torch.Generator(device=dev).manual_seed(seed)
    if mesh is None:
        model = Llama(cfg, dev)
        with torch.no_grad():
            for name, p in model.named_parameters():
                if not name.endswith("norm"):
                    p.normal_(0.0, 0.02, generator=gen)
        return model
    ax = MeshAxes.of(mesh)
    mine = {whole: (name, region) for name, (whole, region)
            in rank_layout(cfg, ax.sizes, ax.index).items()}
    model = rank_model(cfg, ax.sizes)
    for whole, p in Llama(cfg, "meta").named_parameters():
        w = (torch.ones(p.shape, dtype=p.dtype, device=dev)
             if whole.endswith("norm") else
             torch.empty(p.shape, dtype=p.dtype, device=dev).normal_(
                 0.0, 0.02, generator=gen))
        if whole in mine:
            name, region = mine[whole]
            mod, _, leaf = name.rpartition(".")
            setattr(model.get_submodule(mod) if mod else model, leaf,
                    torch.nn.Parameter(w[region].clone(),
                                       requires_grad=False))
        del w
    return model


def phase_moe_vs_cpu(dev) -> dict:
    """Phase 13a: the paged, prefix-cached engine at a small f32 MoE
    config on the CPU and on the card: identical greedy streams and
    skipped prefill tokens; the card launches K1 and K2 and no plain
    version."""
    from k8s_gpu_scheduler_tpu_torch.models.llama import (
        LlamaConfig, init_params)
    from k8s_gpu_scheduler_tpu_torch.models.serving import ContinuousBatcher
    from k8s_gpu_scheduler_tpu_torch.ops import decode_attention as da

    cfg = LlamaConfig(**SMALL_MOE)
    got = {}
    for where in ("cpu", dev):
        model = init_params(cfg, torch.Generator().manual_seed(0), where)
        eng = ContinuousBatcher(model, cfg, n_slots=4, max_len=128, chunk=4,
                                prefill_bucket=16, kv_layout="paged",
                                page_size=16, prefix_cache=True, device=where)
        prompts = shared_prefix_traffic(np.random.default_rng(0), cfg.vocab,
                                        8, 32, 9)
        da.reset_counters()
        # the second wave hits the first's cached system prompt
        streams = drive(eng, prompts[:4], 12) + drive(eng, prompts[4:], 12)
        got[str(where)] = (streams,
                           eng.pool_metrics()["prefill_tokens_skipped"],
                           da.counters())
    cpu, gpu = got["cpu"], got[str(dev)]
    if gpu[:2] != cpu[:2]:
        raise SystemExit(f"MoE engine on the card diverges from the CPU:\n"
                         f"  gpu {gpu[:2]}\n  cpu {cpu[:2]}")
    c = gpu[2]
    if not (c["paged_decode_attention"] and c["paged_prefill_attention"]
            and gpu[1] > 0) or any(c[k] for k in PLAIN):
        raise SystemExit(f"MoE engine on the card launched {c}, skipped "
                         f"{gpu[1]}")
    return dict(streams=len(gpu[0]), tokens=sum(map(len, gpu[0])),
                skipped=gpu[1], launches={k: v for k, v in c.items() if v})


def phase_moe_serve(dev, card) -> dict:
    """Phase 13b: phase 3's engine, traffic and checks at Mixtral-8x7B's
    widths, dropless MoE, bf16 then int8 weights + int8 KV."""
    from k8s_gpu_scheduler_tpu_torch.models.llama import LlamaConfig

    cfg = LlamaConfig(**MOE_CFG, n_layers=MOE_SERVE_LAYERS, remat=False)
    log(f"  cut: n_layers 32 -> {cfg.n_layers}, max_seq 32768 -> "
        f"{cfg.max_seq}; every width, 8 experts and top-2 as published")
    return serve_full_width(card, "MoE path", cfg,
                            lambda: card_init(cfg, dev))


def moe_step_flops(cfg, B, T) -> float:
    """Operations one MoE training step executes: the capacity path's
    projections, attention (causal half), router, one-hot dispatch and
    combine products and the experts' queues (E x C rows a batch row,
    C = ``expert_capacity``), run four times (forward, remat forward and
    the backward's two products), plus the head three times."""
    from k8s_gpu_scheduler_tpu_torch.ops.moe import expert_capacity

    D, H, Hkv, hd, F_, E = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                            cfg.head_dim, cfg.d_ff, cfg.n_experts)
    C = expert_capacity(T, E, cfg.moe_top_k, cfg.moe_capacity_factor)
    tok = B * T
    layer = (2 * tok * (2 * D * H * hd + 2 * D * Hkv * hd)
             + 2 * B * H * T * T * hd                 # QK^T, PV: half each
             + 2 * tok * D * E                        # router
             + 2 * 2 * tok * E * C * D                # dispatch, combine
             + 3 * 2 * B * E * C * D * F_)            # gate, up, down
    return 4.0 * cfg.n_layers * layer + 3 * 2.0 * tok * D * cfg.vocab


def phase_moe_train(dev, card) -> dict:
    """Phase 14: MoE training at Mixtral's widths (capacity path, balance
    aux), flash attention, remat, AdamW 3e-4, one fixed batch."""
    from k8s_gpu_scheduler_tpu_torch.models.llama import (
        LlamaConfig, forward_with_aux, make_optimizer, make_train_step)
    from k8s_gpu_scheduler_tpu_torch.ops.flash_attention import (
        counters, reset_counters)

    B, T = MOE_TRAIN_BT
    cfg = LlamaConfig(**MOE_CFG, n_layers=MOE_TRAIN_LAYERS,
                      attn_impl="flash", remat=True)
    log(f"  cut: n_layers 32 -> {cfg.n_layers} (the weights, gradients and "
        f"AdamW moments of 32 layers take 373.6 GB); every width, B {B}, "
        f"T {T}")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = card_init(cfg, dev)
    step = make_train_step(cfg, None, make_optimizer(model, 3e-4))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (B, T)))
    batch = {"tokens": tokens.to(dev),
             "targets": torch.roll(tokens, -1, dims=1).to(dev)}
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  [{card}] {n_params} parameters, set up in "
        f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    losses = [float(step(model, batch))]                 # warm-up
    reset_counters()
    step_s, pending = [], []
    for _ in range(MOE_TRAIN_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        pending.append(step(model, batch))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
    c = counters()
    losses += [float(x) for x in pending]
    with torch.no_grad():
        aux = float(forward_with_aux(model, batch["tokens"])[1])
    mean_s = sum(step_s) / len(step_s)
    flops = moe_step_flops(cfg, B, T)
    st = dict(B=B, T=T, n_layers=cfg.n_layers, n_params=n_params,
              losses=losses, aux=aux, step_ms=[1e3 * x for x in step_s],
              mean_step_ms=1e3 * mean_s, tokens_per_s=B * T / mean_s,
              executed_tflop=flops / 1e12,
              executed_share_of_989=flops / mean_s
              / PEAK_FLOPS[torch.bfloat16],
              max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
              launches=c)
    log(f"  [{card}] {json.dumps(st)}")
    want = (2 * cfg.n_layers * MOE_TRAIN_STEPS, cfg.n_layers * MOE_TRAIN_STEPS,
            cfg.n_layers * MOE_TRAIN_STEPS)
    if not (all(np.isfinite(losses)) and np.isfinite(aux)) \
            or not losses[-1] < losses[0]:
        raise SystemExit(f"MoE training: losses {losses}, aux {aux}")
    if tuple(c[k] for k in FLASH) != want or any(c[k] for k in FLASH_PLAIN):
        raise SystemExit(f"MoE training launched {c}, want {want} and no "
                         f"plain version")
    del model, step, pending
    torch.cuda.empty_cache()
    return st


def _pod_lines(module, prefix, n=3, timeout=600.0):
    """Run ``python -m module`` from the package's root until it prints
    ``n`` lines starting with ``prefix``, then SIGTERM it: (lines, exit
    code, its standard error). The process is killed on any way out."""
    import queue
    import signal
    import threading

    import k8s_gpu_scheduler_tpu_torch as pkg

    root = os.path.dirname(os.path.dirname(os.path.abspath(pkg.__file__)))
    err = tempfile.TemporaryFile(mode="w+")
    proc = subprocess.Popen([sys.executable, "-m", module], cwd=root,
                            stdout=subprocess.PIPE, stderr=err, text=True,
                            env={**os.environ, "PYTHONPATH": root})
    out: "queue.Queue" = queue.Queue()
    threading.Thread(target=lambda: [out.put(ln) for ln in proc.stdout]
                     + [out.put(None)], daemon=True).start()
    lines, deadline = [], time.monotonic() + timeout
    try:
        while len(lines) < n:
            try:
                line = out.get(timeout=max(0.0, deadline - time.monotonic()))
            except queue.Empty:
                break
            if line is None:
                break
            log(f"    {line.rstrip()}")
            if line.startswith(prefix):
                lines.append(line.strip())
        proc.send_signal(signal.SIGTERM)
        code = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        err.seek(0)
        stderr = err.read()
        err.close()
    return lines, code, stderr


def check_pod(label, lines, code, stderr, value_key) -> list:
    """Three parsed lines with ``value_key`` > 0, ended by the SIGTERM,
    no traceback: the values, else the phase fails."""
    import signal

    parsed = [dict(kv.split("=", 1) for kv in ln.split()[1:])
              for ln in lines]
    values = [float(p[value_key]) for p in parsed]
    if len(lines) != 3 or not all(v > 0 for v in values) \
            or code != -signal.SIGTERM or "Traceback" in stderr:
        raise SystemExit(f"{label}: lines {lines}, exit {code}, stderr "
                         f"{stderr[-3000:]}")
    return parsed


def profile_pods(dev, card) -> None:
    """``--profile``: one BERT-base ``classify`` at the pod's B 32, T 128
    and one ResNet-50 training step at its B 64, 224x224, each after a
    warm-up, under torch.profiler."""
    from k8s_gpu_scheduler_tpu_torch.models import bert, resnet

    model = bert.init_params(bert.BertConfig.base(),
                             torch.Generator().manual_seed(0), dev)
    tokens = torch.randint(0, model.cfg.vocab, (32, 128), device=dev)

    def classify():
        _, ms = _synced_ms(lambda: bert.classify(model, tokens))
        return None, dict(wall_s=ms / 1e3)

    classify()                                           # warm-up
    profiled(card, "bert-base classify (B 32, T 128)", classify)
    del model
    cfg = resnet.ResNetConfig.resnet50()
    net = resnet.init_params(cfg, torch.Generator().manual_seed(0), dev)
    step = resnet.make_train_step(cfg, resnet.make_optimizer(net))
    batch = {"images": torch.randn(64, 224, 224, 3, device=dev),
             "labels": torch.randint(0, cfg.n_classes, (64,), device=dev)}
    timed_step(step, net, batch)                         # warm-up
    profiled(card, "resnet50 train step (B 64, 224x224)",
             lambda: timed_step(step, net, batch))
    del net, step
    torch.cuda.empty_cache()


def phase_bert(dev, card) -> dict:
    """Phase 15: ``classify`` on the card against the CPU at the tiny
    config (f32 to 1e-5, bf16 to 2^-6 of the largest logit), then the pod
    entry point ``python -m k8s_gpu_scheduler_tpu_torch.models.bert``."""
    from k8s_gpu_scheduler_tpu_torch.models.bert import (
        BertConfig, classify, init_params)

    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, 128, (4, 48)))
    errs = {}
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2 ** -6)):
        cfg = dataclasses.replace(BertConfig.tiny(), dtype=dtype)
        cpu, gpu = (classify(init_params(cfg, torch.Generator().manual_seed(
            0), where), tokens.to(where)).cpu() for where in ("cpu", dev))
        err = float((gpu - cpu).abs().max() / cpu.abs().max())
        errs[str(dtype)] = err
        if not err <= tol:
            raise SystemExit(f"BERT classify on the card, {dtype}: relative "
                             f"error {err} > {tol}")
    log(f"  classify card vs CPU, error over the largest logit: "
        f"{json.dumps(errs)}")
    lines, code, stderr = _pod_lines(
        "k8s_gpu_scheduler_tpu_torch.models.bert", "bert-base qps=")
    parsed = check_pod("bert main()", lines, code, stderr, "qps")
    st = dict(qps=[float(p["qps"]) for p in parsed], exit=code,
              errors=errs)
    log(f"  [{card}] bert-base main(): {json.dumps(st)}")
    return st


def phase_resnet(dev, card) -> dict:
    """Phase 16: ``forward`` on the card against the CPU at the tiny f32
    config on 32x32 and 33x33 images (TF32 off; 1e-4), then the pod entry
    point ``python -m k8s_gpu_scheduler_tpu_torch.models.resnet``."""
    from k8s_gpu_scheduler_tpu_torch.models.resnet import (
        ResNetConfig, forward, init_params)

    cfg = dataclasses.replace(ResNetConfig.tiny(), dtype=torch.float32)
    errs = {}
    for size in (32, 33):
        images = torch.from_numpy(np.random.default_rng(size).standard_normal(
            (4, size, size, 3)).astype(np.float32))
        cpu, gpu = (forward(init_params(cfg, torch.Generator().manual_seed(
            0), where), images.to(where)).detach().cpu()
            for where in ("cpu", dev))
        errs[f"{size}x{size}"] = err = float((gpu - cpu).abs().max())
        if not err <= 1e-4:
            raise SystemExit(f"ResNet forward on the card, {size}x{size}: "
                             f"error {err} > 1e-4")
    log(f"  forward card vs CPU, max abs error: {json.dumps(errs)}")
    lines, code, stderr = _pod_lines(
        "k8s_gpu_scheduler_tpu_torch.models.resnet", "resnet50 img/s=")
    parsed = check_pod("resnet main()", lines, code, stderr, "img/s")
    losses = [float(p["loss"]) for p in parsed]
    if not all(np.isfinite(losses)):
        raise SystemExit(f"resnet main(): losses {losses}")
    st = dict(img_s=[float(p["img/s"]) for p in parsed], losses=losses,
              exit=code, errors=errs)
    log(f"  [{card}] resnet50 main(): {json.dumps(st)}")
    return st


def phases_13_to_16(dev, card, profile_too=False) -> dict:
    log("phase 13: MoE serving. (a) a small f32 MoE engine, card against "
        "CPU (f32, TF32 off)")
    log(f"  identical greedy streams: {json.dumps(phase_moe_vs_cpu(dev))}")
    log(f"  (b) Mixtral-8x7B widths, {MOE_SERVE_LAYERS} layers, dropless, "
        f"bf16 then int8")
    serve = phase_moe_serve(dev, card)
    log(f"phase 14: MoE training at Mixtral-8x7B widths, "
        f"{MOE_TRAIN_LAYERS} layers, bf16")
    train = phase_moe_train(dev, card)
    log("phase 15: BERT-base, classify card vs CPU and the pod's main()")
    bert = phase_bert(dev, card)
    log("phase 16: ResNet-50, forward card vs CPU and the pod's main()")
    resnet = phase_resnet(dev, card)
    if profile_too:
        log("profile: where a BERT-base call's and a ResNet-50 step's "
            "device time goes")
        profile_pods(dev, card)
    return dict(serve=serve, train=train, bert=bert, resnet=resnet)


# -- phases 17-20: one NCCL world of one and one gloo world of two ------------
# Each of phases 17-20 is a generator that yields a World for its NCCL world
# of one and then one for its gloo world of two, and is sent each world's
# rank results. run_in_worlds runs the requests of every chosen phase for
# one world size as the jobs of one spawned world, in phase order: a rank
# process starts once for the four phases instead of once for each.

@dataclasses.dataclass(frozen=True)
class World:
    """A phase's request: ``fn(rank, size, *args)`` on each rank of a world
    of ``size`` on ``backend``, within ``timeout`` seconds; after it, rank
    0 removes the paths of ``cleanup`` (a later job needs the disk)."""
    fn: object
    size: int
    backend: str
    args: tuple
    timeout: float
    cleanup: tuple = ()


def world_jobs(rank, world, jobs):
    """A rank of a shared world: each ``(fn, args, cleanup)`` of ``jobs``
    in turn, with the card's cached blocks freed and ``cleanup`` removed
    between them. Returns each job's (result, seconds)."""
    import gc
    import shutil

    import torch.distributed as dist

    out = []
    for fn, args, cleanup in jobs:
        t0 = time.perf_counter()
        out.append((fn(rank, world, *args), time.perf_counter() - t0))
        gc.collect()
        torch.cuda.empty_cache()
        dist.barrier()
        if rank == 0:
            for path in cleanup:
                shutil.rmtree(path, ignore_errors=True)
    return out


def run_in_worlds(card, phases: dict) -> dict:
    """Drive the generators of ``phases`` (label -> generator) together:
    the pending requests of one world size (smallest first) run as the jobs
    of one spawned world, and each phase is sent its job's rank results.
    Returns each phase's return value."""
    from k8s_gpu_scheduler_tpu_torch.parallel import spawn

    pending, done = {}, {}

    def advance(label, value=None):
        log(f"  -- phase {label}")
        try:
            pending[label] = phases[label].send(value)
        except StopIteration as stop:
            done[label] = stop.value

    for label in phases:
        advance(label)
    while pending:
        size = min(w.size for w in pending.values())
        batch = {k: w for k, w in pending.items() if w.size == size}
        (backend,) = {w.backend for w in batch.values()}
        timeout = sum(w.timeout for w in batch.values())
        t0 = time.perf_counter()
        ranks = spawn(world_jobs, size, backend, args=(
            [(w.fn, w.args, w.cleanup) for w in batch.values()],),
            timeout=timeout,
            group_timeout=max(w.timeout for w in batch.values()))
        log(f"  [{card}] {backend} world of {size} on one card for phases "
            f"{', '.join(batch)}: {time.perf_counter() - t0:.1f} s; each "
            f"phase's jobs (rank 0): " + ", ".join(
                f"{k} {ranks[0][i][1]:.1f} s" for i, k in enumerate(batch)))
        for i, label in enumerate(batch):
            del pending[label]
            advance(label, [r[i][0] for r in ranks])
    return done


# Phase 17: tensor-parallel paged serving ---------------------------------
TP_GQA = dict(vocab=128256, d_model=4096, n_layers=2, n_heads=32,
              n_kv_heads=8, d_ff=14336, max_seq=2048, decode_attn="fused")
TP_SUBSET = 16                  # requests of the f32 and side runs: 2 waves
TP_SUB_NEW = 32                 # their budget
TP_PART_CAP = 0.25              # bf16 streams that may part, as phase 11
                                # (all_gather, replicated; not psum)
TP_PSUM_TOL = 1e-4              # f32 psum logits, of the largest |logit|
TP_PSUM_F32_CAP = 0.125         # f32 psum streams that may part (2 of 16),
                                # each at a tie within twice that tolerance
TP_GQA_N = 8                    # 17f: requests (the tail of phase 3's
                                # prompts) and new tokens
TP_TIMEOUT = 900                # seconds a rank world may take
TP_LAYERS = 2                   # the serve config's 8 layers cut to 2
                                # (4 before the script's time limit forced
                                # it): a tp 2 tick is the gloo combines
# 17g: (case, model heads, model kv heads, hd, tp) whose per-rank K1/K3
# shapes are timed under both split plans.
TP_PLAN_SHAPES = (("serve tp2", 16, 16, 64, 2), ("gqa tp2", 32, 8, 128, 2),
                  ("llama3_8b tp8", 32, 8, 128, 8))


def tp_rank_device():
    """A rank's card: card 0 (the ranks of a gloo world share it), TF32
    off and the kernels' library loaded (the parent built it)."""
    from k8s_gpu_scheduler_tpu_torch.ops import _build

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.load_library()
    return torch.device("cuda", 0)


def tp_engine_kw(cfg, max_new, **kw):
    """Phase 3's engine settings (serve_run's)."""
    return {**dict(n_slots=8, max_len=cfg.max_seq, chunk=int(max_new),
                   prefill_bucket=512, kv_layout="paged", page_size=64,
                   prefix_cache=True), **kw}


def tp_run(model, cfg, prompts, max_new, mesh, **kw):
    """One run on a fresh engine of this rank (mesh=None: a single-card
    engine): the leader drives ``prompts``, a follower replays. Counters
    are zeroed just before and read just after. Returns (streams or None
    on a follower, stats)."""
    from k8s_gpu_scheduler_tpu_torch.models.serving import ContinuousBatcher
    from k8s_gpu_scheduler_tpu_torch.ops import decode_attention as da

    eng = ContinuousBatcher(model, cfg, device=model.device, mesh=mesh,
                            **tp_engine_kw(cfg, max_new, **kw))
    torch.cuda.synchronize()
    da.reset_counters()
    t0 = time.perf_counter()
    with _DecodeTimer() as dec:
        if eng.is_leader:
            streams = drive(eng, prompts, max_new)
            eng.close()
        else:
            eng.follow()
            streams = None
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    pool = eng.pool_metrics()
    st = dict(launches=da.counters(), wall_s=wall, decode_s=dec.seconds,
              decode_enqueue_s=dec.enqueue_seconds,
              **{k: pool[k] for k in (
                  "tp", "tp_combine", "kv_pool_device_bytes",
                  "weight_device_bytes", "weight_sliced_device_bytes")})
    if st["launches"]["paged_decode_attention"]:
        st.update(tick_stats(st, cfg))
    if streams is not None:
        n_tok = sum(map(len, streams))
        st.update(tokens=n_tok, tokens_per_s=n_tok / wall,
                  decode_tokens_per_s=(n_tok - len(prompts)) / dec.seconds)
    return streams, st


def tp_traffic(vocab):
    """Phase 3's warm-up and main prompts, and the first TP_SUBSET of
    phase 4's main prompts (after its eight warm-up ones)."""
    rng = np.random.default_rng(0)
    warm = shared_prefix_traffic(rng, vocab, 8, 384, 128)
    main = shared_prefix_traffic(rng, vocab, 32, 384, 128)
    rng = np.random.default_rng(2)
    repeated_phrases(rng, vocab, 8)
    return warm, main, repeated_phrases(rng, vocab, TP_SUBSET)


def tp_config():
    """Phase 17's config: the serve config at ``TP_LAYERS`` layers."""
    from k8s_gpu_scheduler_tpu_torch.models.llama import LlamaConfig

    return dataclasses.replace(LlamaConfig.serve(), decode_attn="fused",
                               n_layers=TP_LAYERS)


def tp_models(dev):
    """Phase 17's config in bf16 and f32, their weights from seed 0."""
    from k8s_gpu_scheduler_tpu_torch.models.llama import init_params

    cfg = tp_config()
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    return ((cfg, init_params(cfg, torch.Generator().manual_seed(0), dev)),
            (cfg32, init_params(cfg32, torch.Generator().manual_seed(0),
                                dev)))


def island_logits(model, cfg, x, isl):
    """The dense causal forward's logits [B, T, vocab] f32 through the
    serving islands' block walk (``isl`` None: one card's), as the hb == 0
    prefill runs it."""
    from k8s_gpu_scheduler_tpu_torch.models.serving import (
        _attn_residual, _mlp_residual, _qkv_local, cached_attention)
    from k8s_gpu_scheduler_tpu_torch.ops.layers import rms_norm, rope_freqs
    from k8s_gpu_scheduler_tpu_torch.ops.quant import qdot

    B, T = x.shape
    angles = rope_freqs(cfg.head_dim, T, cfg.rope_theta, device=x.device)
    h = model.embed[x].to(cfg.dtype)
    with torch.no_grad():
        for blk in model.blocks:
            a = rms_norm(h, blk.attn_norm)
            q, k, v = _qkv_local(cfg, a, blk, angles, (B, T), isl)
            h = _attn_residual(h, cached_attention(q, k, v, 0), blk.wo,
                               (B, T), isl)
            h = _mlp_residual(cfg, h, blk, isl)
        return qdot(rms_norm(h, model.final_norm), model.lm_head).float()


def tp_world_one(rank, world):
    """17a, an NCCL world of one: phase 3's main path through a tp = 1
    mesh and through the single-card engine, and the single-card
    references of phase 17b-f."""
    from k8s_gpu_scheduler_tpu_torch.parallel import MeshSpec, make_mesh

    dev = tp_rank_device()
    mesh = make_mesh(MeshSpec({"tp": 1}), dev.type)
    (cfg, model), (cfg32, model32) = tp_models(dev)
    warm, main, spec = tp_traffic(cfg.vocab)
    out = {}
    tp_run(model, cfg, warm, 64, mesh)                 # warm-up
    out["mesh"] = tp_run(model, cfg, main, 64, mesh)
    out["plain"] = tp_run(model, cfg, main, 64, None)
    out["f32"] = tp_run(model32, cfg32, main[:TP_SUBSET], TP_SUB_NEW, None)
    out["f32_spec"] = tp_run(model32, cfg32, spec, TP_SUB_NEW, None,
                             **SPEC_ENGINE)
    del model, model32
    torch.cuda.empty_cache()
    for key, gcfg in gqa_configs():
        out[key] = tp_run(card_init(gcfg, dev), gcfg, gqa_prompts(main),
                          TP_GQA_N, None, prefix_cache=False)
        torch.cuda.empty_cache()
    return out


def gqa_configs():
    """17f's GQA config in bf16 and f32, keyed as the runs are."""
    from k8s_gpu_scheduler_tpu_torch.models.llama import LlamaConfig

    cfg = LlamaConfig(**TP_GQA)
    return (("gqa", cfg),
            ("gqa_f32", dataclasses.replace(cfg, dtype=torch.float32)))


def gqa_prompts(main):
    return [p[256:] for p in main[:TP_GQA_N]]


def tp_world_two(rank, world):
    """17b-f, a gloo world of two ranks on one card: the rank results of
    each run (streams from the leader only)."""
    from k8s_gpu_scheduler_tpu_torch.models import serving
    from k8s_gpu_scheduler_tpu_torch.models.llama import sliced_for_serving
    from k8s_gpu_scheduler_tpu_torch.models.serving import ContinuousBatcher
    from k8s_gpu_scheduler_tpu_torch.ops.quant import quantize_llama_params
    from k8s_gpu_scheduler_tpu_torch.parallel import MeshSpec, make_mesh
    from k8s_gpu_scheduler_tpu_torch.parallel.island import Island
    from k8s_gpu_scheduler_tpu_torch.parallel.sharding import mesh_coords

    dev = tp_rank_device()
    mesh = make_mesh(MeshSpec({"tp": world}), dev.type)
    (cfg, model), (cfg32, model32) = tp_models(dev)
    warm, main, spec = tp_traffic(cfg.vocab)
    sub = main[:TP_SUBSET]
    out = {}
    tp_run(model, cfg, warm[:1], 8, mesh)              # warm-up
    out["bf16"] = tp_run(model, cfg, main, 64, mesh)
    out["f32"] = tp_run(model32, cfg32, sub, TP_SUB_NEW, mesh)
    out["f32_spec"] = tp_run(model32, cfg32, spec, TP_SUB_NEW, mesh,
                             **SPEC_ENGINE)
    # 17c: psum — f32 logits against one card's, then bf16 streams.
    x = torch.as_tensor(np.asarray([p[:128] for p in sub[:4]]), device=dev)
    isl = Island(mesh, dev, True, "psum")
    got = island_logits(sliced_for_serving(model32, *mesh_coords(mesh)),
                        cfg32, x, isl)
    if rank == 0:
        want = island_logits(model32, cfg32, x, None)
        out["psum_logits"] = dict(
            max_abs_diff=(got - want).abs().max().item(),
            max_abs_logit=want.abs().max().item())
    out["psum_f32"] = tp_run(model32, cfg32, sub, TP_SUB_NEW, mesh,
                             tp_combine="psum")
    out["psum"] = tp_run(model, cfg, sub, TP_SUB_NEW, mesh,
                         tp_combine="psum")
    serving.reset_decode_fallback_counts()
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out["replicated"] = tp_run(model, cfg, sub, TP_SUB_NEW, mesh,
                                   weight_sharding=False)
    out["replicated_counts"] = serving.decode_fallback_counts()
    out["replicated_warned"] = sum("weight_sharding=False" in str(w.message)
                                   for w in caught)
    # 17d: drain on tp = 2, restore into one card's engine (f32).
    # chunk 8: requests of 32 tokens are mid-decode after two steps.
    eng = ContinuousBatcher(model32, cfg32, device=dev, mesh=mesh,
                            **tp_engine_kw(cfg32, 8))
    if eng.is_leader:
        ids = [eng.submit(p, max_new=TP_SUB_NEW) for p in sub]
        done = {}
        for _ in range(2):
            done.update(eng.step())
        t0 = time.perf_counter()
        snap = eng.drain()
        drain_ms = 1e3 * (time.perf_counter() - t0)
        eng.close()
        one = ContinuousBatcher(model32, cfg32, device=dev,
                                **tp_engine_kw(cfg32, 8))
        t0 = time.perf_counter()
        one.restore(snap)
        restore_ms = 1e3 * (time.perf_counter() - t0)
        while one.pending:
            done.update(one.step())
        out["drain"] = dict(streams=[done[i] for i in ids],
                            pages=len(snap.page_ids), drain_ms=drain_ms,
                            restore_ms=restore_ms,
                            in_flight=snap.n_requests_in_flight)
    else:
        eng.follow()
    del eng, model32
    torch.cuda.empty_cache()
    # 17e: int8 weights and an int8 KV pool.
    qmodel = quantize_llama_params(model)
    out["int8"] = tp_run(qmodel, cfg, sub, TP_SUB_NEW, mesh,
                         kv_dtype="int8")
    del qmodel, model
    torch.cuda.empty_cache()
    # 17f: GQA at llama3_8b widths, depth 4: sliced weights in bf16 and
    # f32, and full q/k/v/gate/up products (replicated weights) in bf16.
    for key, gcfg in gqa_configs():
        gmodel = card_init(gcfg, dev)
        out[key] = tp_run(gmodel, gcfg, gqa_prompts(main), TP_GQA_N, mesh,
                          prefix_cache=False)
        if key == "gqa":
            out["gqa_replicated"] = tp_run(
                gmodel, gcfg, gqa_prompts(main), TP_GQA_N, mesh,
                prefix_cache=False, weight_sharding=False)
        del gmodel
        torch.cuda.empty_cache()
    return out


def tp_same_launches(label, ranks, ref, names) -> None:
    """Every rank launched each kernel in ``names`` as often as the
    single-card run did, and no plain version ran."""
    for r, st in enumerate(ranks):
        c = st["launches"]
        if any(c[k] for k in PLAIN):
            raise SystemExit(f"{label}: rank {r} ran a plain version: {c}")
        for k in names:
            if c[k] != ref["launches"][k] or not c[k]:
                raise SystemExit(
                    f"{label}: rank {r} launched {k} {c[k]} times, one "
                    f"card {ref['launches'][k]}")


def tp_partings(streams, ref) -> list:
    """For each stream that parts from its reference, the index of the
    first token that differs."""
    return [next(j for j, (a, b) in enumerate(zip(s, r)) if a != b)
            for s, r in zip(streams, ref) if s != r]


def check_psum_f32(streams, ref, prompts, model, tie) -> dict:
    """17c: the psum engine's f32 streams against one card's. They may
    part only where the reference's two tokens are tied within ``tie``
    (twice the psum logits' tolerance: each side may move by one), in at
    most ``TP_PSUM_F32_CAP`` of the streams. As in ``check_streams``, the
    gate must catch the first 8 reference streams with a far token swapped
    in."""
    n_bad, where = first_divergence(streams, ref)
    gaps = parting_gaps(model, prompts, streams, ref, int8=False)
    faults = [r[:len(r) // 2] + [(r[len(r) // 2] + model.cfg.vocab // 2)
                                 % model.cfg.vocab] + r[len(r) // 2 + 1:]
              for r in ref[:8]]
    caught = parting_gaps(model, prompts[:8], faults, ref[:8], int8=False)
    out = dict(streams_differing=n_bad, first_divergence=where,
               worst_gap=max(gaps, default=0.0), tie=tie,
               smallest_fault_gap=min(caught))
    if n_bad > TP_PSUM_F32_CAP * len(ref) or out["worst_gap"] > tie:
        raise SystemExit(f"17c psum (f32): {n_bad} of {len(ref)} streams "
                         f"part (cap {TP_PSUM_F32_CAP}), gaps {gaps} "
                         f"against a tie of {tie}")
    if min(caught) <= tie:
        raise SystemExit(f"17c psum (f32): the tie gate misses a fault: "
                         f"gaps {caught} against {tie}")
    return out


def phase_gqa_streams(card, ranks, one, main, dev) -> dict:
    """17f's checks: every rank launches K1 as one card does; the f32
    streams of the sliced island equal one card's; the bf16 ones, sliced
    and with replicated weights (full q/k/v/gate/up products), part from
    one card's only at near-ties, under ``TP_PART_CAP``."""
    lead, out = ranks[0], {}
    for key, gcfg in gqa_configs():
        tp_same_launches(f"17f {key}", [r[key][1] for r in ranks],
                         one[key][1], ("paged_decode_attention",))
        if malformed(lead[key][0], TP_GQA_N, gcfg.vocab):
            raise SystemExit(f"17f {key}: malformed GQA streams")
        log(f"  [{card}] 17f {key} (llama3_8b widths, {gcfg.n_layers} "
            f"layers) at tp=2: "
            f"{json.dumps(lead[key][1])}")
    out["17f gqa f32"] = check_streams(
        "17f gqa", torch.float32, lead["gqa_f32"][0], one["gqa_f32"][0],
        None, None, None, 0.0)
    gcfg = dict(gqa_configs())["gqa"]
    model = card_init(gcfg, dev)
    spread = logit_spread(model, gcfg, dev)
    for key in ("gqa", "gqa_replicated"):
        streams, ref = lead[key][0], one["gqa"][0]
        log(f"  [{card}] 17f {key} bf16: first differing token of each "
            f"parting stream: {tp_partings(streams, ref)}")
        out[f"17f {key}"] = check_streams(
            f"17f {key}", torch.bfloat16, streams, ref, gqa_prompts(main),
            model, spread, TP_PART_CAP)
        log(f"  [{card}] 17f {key} bf16 against one card: "
            f"{json.dumps(out[f'17f {key}'])}")
    del model
    torch.cuda.empty_cache()
    return out


def phase_plan_per_rank(dev, card) -> list:
    """17g: K1 (B 8, 32 blocks of 64 rows) and K3 (t 5) at a tp rank's
    heads, their split plan made for the rank's kv heads and for the
    model's (which the engine passes, so each head splits as on one
    card), each held to its plain version, beside the bound."""
    from k8s_gpu_scheduler_tpu_torch.ops import decode_attention as da

    flush = _L2Flush(dev)
    rows = []
    for name, H, n_kv, hd, tp in TP_PLAN_SHAPES:
        h, kv = H // tp, n_kv // tp
        groups = {"K1": 8, "K3": 8 * -(-5 * (h // kv) // da.VERIFY_Q_ROWS[
            torch.bfloat16])}
        for kern in ("K1", "K3"):
            got = {}
            for plan in (kv, n_kv):
                got[plan] = (decode_case(name, 8, h, kv, hd, 64, 32, False,
                                         dev, flush, plan_kv_heads=plan)
                             if kern == "K1" else
                             verify_case(name, 8, 5, h, kv, hd, 64, 32,
                                         False, dev, flush,
                                         plan_kv_heads=plan))
                if not got[plan]["ok"]:
                    raise SystemExit(f"17g {kern} {name} (plan for {plan} "
                                     f"heads) disagrees with its plain "
                                     f"version")
            row = dict(kernel=kern, case=name, heads=h, kv_heads=kv,
                       local_splits=da.paged_plan(32, 64, groups[kern], kv),
                       model_splits=da.paged_plan(32, 64, groups[kern],
                                                  n_kv),
                       local_ms=got[kv]["ms"], model_ms=got[n_kv]["ms"],
                       bound_ms=got[kv]["bound_ms"],
                       bound_by=got[kv]["bound_by"])
            log(f"  [{card}] 17g {kern} {name} ({h}/{kv} heads a rank): "
                f"{json.dumps(row)}")
            rows.append(row)
    return rows


def phase_tensor_parallel(dev, card) -> dict:
    """Phase 17 (see the module docstring)."""
    from k8s_gpu_scheduler_tpu_torch.models.llama import init_params

    K12 = ("paged_decode_attention", "paged_prefill_attention")
    log(f"  cuts: the serve config at {TP_LAYERS} layers (17a-e), GQA at "
        f"llama3_8b's widths at {TP_GQA['n_layers']} (17f); no width cut")
    torch.cuda.empty_cache()
    (one,) = yield World(tp_world_one, 1, "nccl", (), TP_TIMEOUT)
    (s_mesh, st_mesh), (s_one, st_one) = one["mesh"], one["plain"]
    log(f"  [{card}] 17a tp=1 mesh: {json.dumps(st_mesh)}")
    log(f"  [{card}] 17a one card:  {json.dumps(st_one)}")
    if s_mesh != s_one:
        raise SystemExit("17a: the tp=1 mesh's streams differ from the "
                         "single-card engine's")
    tp_same_launches("17a", [st_mesh], st_one, K12)
    ranks = yield World(tp_world_two, 2, "gloo", (), TP_TIMEOUT)
    lead = ranks[0]
    cfg = tp_config()
    _, main, _ = tp_traffic(cfg.vocab)
    sub = main[:TP_SUBSET]
    out = {}
    # 17b: the main path at tp=2 (all_gather): launches and bytes per rank.
    st2 = [r["bf16"][1] for r in ranks]
    for r, st in enumerate(st2):
        log(f"  [{card}] 17b tp=2 all_gather bf16, rank {r}: "
            f"{json.dumps(st)}")
    tp_same_launches("17b bf16", st2, st_one, K12)
    for r, st in enumerate(st2):
        if st["kv_pool_device_bytes"] * 2 != st_one["kv_pool_device_bytes"] \
                or st["weight_sliced_device_bytes"] * 2 != \
                st_one["weight_sliced_device_bytes"]:
            raise SystemExit(f"17b: rank {r}'s bytes are not half one "
                             f"card's: {st} against {st_one}")
    log(f"  [{card}] 17b per-rank bytes: pool "
        f"{st2[0]['kv_pool_device_bytes']:.0f} (one card "
        f"{st_one['kv_pool_device_bytes']:.0f}), weights "
        f"{st2[0]['weight_device_bytes']:.0f} (one card "
        f"{st_one['weight_device_bytes']:.0f}), sliced "
        f"{st2[0]['weight_sliced_device_bytes']:.0f}")
    # 17b: f32, plain and speculative: identical streams, K3 per rank.
    for key, names in (("f32", K12), ("f32_spec",
                                      ("paged_verify_attention",))):
        if lead[key][0] != one[key][0]:
            raise SystemExit(
                f"17b {key}: tp=2 streams differ from one card's: "
                f"{first_divergence(lead[key][0], one[key][0])}")
        tp_same_launches(f"17b {key}", [r[key][1] for r in ranks],
                         one[key][1], names)
        log(f"  [{card}] 17b {key}: {len(one[key][0])} streams identical; "
            f"launches per rank "
            f"{[r[key][1]['launches'] for r in ranks]}")
    # 17c: psum logits (f32) and the replicated weights' count.
    pl = lead["psum_logits"]
    log(f"  [{card}] 17c psum f32 logits: {json.dumps(pl)} (tolerance "
        f"{TP_PSUM_TOL} of the largest)")
    if not pl["max_abs_diff"] <= TP_PSUM_TOL * pl["max_abs_logit"]:
        raise SystemExit(f"17c: psum logits off by {pl}")
    # 17c: the engine's psum path at f32 against one card's f32 streams.
    tp_same_launches("17c psum f32", [r["psum_f32"][1] for r in ranks],
                     one["f32"][1], K12)
    model32 = init_params(dataclasses.replace(cfg, dtype=torch.float32),
                          torch.Generator().manual_seed(0), dev)
    out["17c psum f32"] = check_psum_f32(
        lead["psum_f32"][0], one["f32"][0], sub, model32,
        2 * TP_PSUM_TOL * pl["max_abs_logit"])
    del model32
    log(f"  [{card}] 17c psum f32 streams against one card's: "
        f"{json.dumps(out['17c psum f32'])}; run "
        f"{json.dumps(lead['psum_f32'][1])}")
    for r, res in enumerate(ranks):
        if res["replicated_counts"] != {"weights_replicated": 1} \
                or res["replicated_warned"] != 1:
            raise SystemExit(f"17c: rank {r} counted "
                             f"{res['replicated_counts']}, warned "
                             f"{res['replicated_warned']} times")
    # 17d: drain on tp=2, restore on one card (f32).
    dr = lead["drain"]
    if dr["streams"] != one["f32"][0]:
        raise SystemExit("17d: the restored streams differ from the "
                         "uninterrupted run's")
    log(f"  [{card}] 17d drain at tp=2 -> restore on one card: "
        f"{dr['in_flight']} requests, {dr['pages']} pages, drain "
        f"{dr['drain_ms']:.1f} ms, restore {dr['restore_ms']:.1f} ms; "
        f"streams identical")
    # 17e: int8 weights and KV.
    for r, res in enumerate(ranks):
        c = res["int8"][1]["launches"]
        if not all(c[k] for k in K12) or any(c[k] for k in PLAIN):
            raise SystemExit(f"17e: rank {r} {c}")
    if malformed(lead["int8"][0], TP_SUB_NEW, cfg.vocab):
        raise SystemExit("17e: malformed int8 streams")
    log(f"  [{card}] 17e int8 weights + int8 KV at tp=2: "
        f"{json.dumps(lead['int8'][1])}")
    # 17f: GQA, K1 at group 4 on 16/4 local heads: f32 streams equal one
    # card's; bf16 ones, sliced and replicated, part only at near-ties.
    out.update(phase_gqa_streams(card, ranks, one, main, dev))
    # bf16 streams against one card's: each parting at a near-tie. The
    # all_gather and replicated islands do one card's arithmetic (K1/K3
    # split as for the model's heads), so their share is capped; psum
    # rounds each rank's partial product to bf16 before the f32 sum, so
    # every row moves by up to a unit a layer and nearly every stream
    # parts somewhere (15 of 16 on an H100): its contract is
    # the f32 logits' tolerance above, and here only the near-ties.
    model = init_params(cfg, torch.Generator().manual_seed(0), dev)
    spread = logit_spread(model, cfg, dev)
    ref_sub = [s[:TP_SUB_NEW] for s in s_one[:TP_SUBSET]]
    for key, streams, ref, prompts, cap in (
            ("17b all_gather", lead["bf16"][0], s_one, main, TP_PART_CAP),
            ("17c psum", lead["psum"][0], ref_sub, sub, 1.0),
            ("17c replicated", lead["replicated"][0], ref_sub, sub,
             TP_PART_CAP)):
        log(f"  [{card}] {key} bf16: first differing token of each "
            f"parting stream: {tp_partings(streams, ref)}")
        out[key] = check_streams(key, torch.bfloat16, streams, ref,
                                 prompts, model, spread, cap)
        log(f"  [{card}] {key} bf16 against one card: "
            f"{json.dumps(out[key])}")
    for key in ("psum", "replicated"):
        log(f"  [{card}] 17c {key} bf16 run: {json.dumps(lead[key][1])}")
    for key in ("psum", "replicated"):
        tp_same_launches(f"17c {key}", [r[key][1] for r in ranks],
                         lead[key][1], K12)
    del model
    torch.cuda.empty_cache()
    plans = phase_plan_per_rank(dev, card)
    return dict(one=st_one, tp2=st2, plans=plans, **out)


# -- phase 18: sharded training -------------------------------------------------

SHARD_STEPS = 2                 # 18a, 18b bf16 steps (phase 6's batch)
SHARD_F32 = dict(vocab=32000, n_layers=1)     # 18b f32: llama3_8b widths
SHARD_F32_STEPS = 2
# 18b: a rank's parameters and its bytes of parameters, gradients and
# AdamW moments at tp 2 and at fsdp 2 (4 layers, bf16): half of every
# sharded leaf, the norms whole (PERF.md's prediction).
SHARD_RANK_PARAMS = 961_581_056
SHARD_RANK_STATE_BYTES = 7_692_648_448
# 18b bf16 losses against one card's, stated before the first run: step
# 1 (the same weights, sums in another order) to 2e-3 relative; steps
# 2-3 to 2e-2 + 2e-2 of the loss (after an update in which a weight with
# a gradient near zero may move the other way).
SHARD_BF16_REL1, SHARD_BF16_ABS = 2e-3, 2e-2
# 18b f32 against one card: the losses to 1e-5 relative; the first
# step's gradients to 1e-5 of each leaf's largest; the weights after the
# two AdamW steps to 1e-5, except where the first step's gradient is
# below SHARD_ADAM_ZONE on one card: there m / (sqrt(v) + 1e-8) turns
# the gradients' rounding into a move of up to 2 lr a step (the CPU
# tests' tolerance note), and such a weight may part by up to that.
SHARD_F32_TOL, SHARD_ADAM_ZONE = 1e-5, 1e-6
SHARD_SMALL = dict(vocab=256, d_model=256, n_layers=2, n_heads=4,
                   n_kv_heads=2, d_ff=512, max_seq=256, remat=True,
                   dtype=torch.float32)
SHARD_SMALL_BT = (2, 256)       # 18c, 18d
SHARD_TIMEOUT = 900


def shard_cfgs():
    """(18a/18b bf16: phase 6's config; 18b f32: llama3_8b widths, depth
    1, vocab 32000; 18c/18d: phase 5's small config at T 256)."""
    from k8s_gpu_scheduler_tpu_torch.models.llama import LlamaConfig

    full = dataclasses.replace(LlamaConfig.llama3_8b(), n_layers=4,
                               attn_impl="flash")
    f32 = dataclasses.replace(full, dtype=torch.float32, **SHARD_F32)
    small = LlamaConfig(**SHARD_SMALL, attn_impl="dense")
    return full, f32, small


def shard_batch(cfg, B, T, dev):
    """train_setup's batch: tokens from numpy seed 0, targets rolled."""
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (B, T)))
    return {"tokens": tokens.to(dev),
            "targets": torch.roll(tokens, -1, dims=1).to(dev)}


def shard_run(model, cfg, mesh, batch, steps, opt=None, after_first=None,
              make_step=None):
    """``steps`` synchronised steps of ``make_train_step(cfg, mesh, ...)``
    (or of ``make_step(cfg, mesh, opt)``), counters zeroed just before
    and read just after: losses, step ms, K5-K7 launches, peak memory,
    and the rank's parameter elements and bytes of parameters, gradients
    and AdamW moments. ``after_first()`` runs after the first step (its
    gradients are still in ``.grad``)."""
    from k8s_gpu_scheduler_tpu_torch.models.llama import (
        make_optimizer, make_train_step)
    from k8s_gpu_scheduler_tpu_torch.ops.flash_attention import (
        counters, reset_counters)

    opt = opt or make_optimizer(model, 3e-4)
    step = (make_step or make_train_step)(cfg, mesh, opt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    losses, ms = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(float(step(model, batch)))
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        if after_first is not None and len(losses) == 1:
            after_first()
    c = counters()
    params = list(model.parameters())
    state = sum(t.numel() * t.element_size() for t in
                params + [p.grad for p in params]
                + [st[k] for st in opt.state.values()
                   for k in ("exp_avg", "exp_avg_sq")])
    return dict(losses=losses, step_ms=ms, launches=c,
                max_memory_allocated_gb=torch.cuda.max_memory_allocated()
                / 1e9, params=sum(p.numel() for p in params),
                state_bytes=state)


def shard_world_one(rank, world, ref_path):
    """18a, an NCCL world of one: phase 6's config for SHARD_STEPS steps
    with ``mesh=None`` and, from the same weights, through a mesh of one
    rank; then the one-card references of 18b's f32 check (its weights
    after the steps saved to ``ref_path``) and of 18c."""
    from k8s_gpu_scheduler_tpu_torch.models.llama import init_params
    from k8s_gpu_scheduler_tpu_torch.parallel import MeshSpec, make_mesh

    dev = tp_rank_device()
    full, f32, small = shard_cfgs()
    batch = shard_batch(full, 8, 2048, dev)
    model = card_init(full, dev)
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}
    out = {"one": shard_run(model, full, None, batch, SHARD_STEPS)}
    with torch.no_grad():
        model.load_state_dict(start)
    del start
    mesh = make_mesh(MeshSpec.for_devices(1), dev.type)
    out["mesh"] = shard_run(model, full, mesh, batch, SHARD_STEPS)
    del model
    torch.cuda.empty_cache()
    model = card_init(f32, dev)
    grads = {}

    def keep_grads():
        grads.update({n: p.grad.detach().cpu()
                      for n, p in model.named_parameters()})

    out["f32"] = shard_run(model, f32, None, shard_batch(f32, 8, 2048, dev),
                           SHARD_F32_STEPS, after_first=keep_grads)
    torch.save({"weights": {k: v.detach().cpu()
                            for k, v in model.state_dict().items()},
                "grads": grads}, ref_path)
    del grads
    del model
    torch.cuda.empty_cache()
    model = init_params(small, torch.Generator().manual_seed(0), dev)
    out["small"] = shard_run(model, small, None,
                             shard_batch(small, *SHARD_SMALL_BT, dev), 2)
    return out


def shard_world_two(rank, world, ref_path, ckpt_dir):
    """18b-d, a gloo world of two ranks on one card: each rank's runs."""
    from k8s_gpu_scheduler_tpu_torch.models.llama import (
        init_params, leaf_specs, make_optimizer, train_loop)
    from k8s_gpu_scheduler_tpu_torch.parallel import MeshSpec, make_mesh
    from k8s_gpu_scheduler_tpu_torch.parallel.sharding import (
        mesh_coords, rank_slice)
    from k8s_gpu_scheduler_tpu_torch.utils.checkpoint import (
        TrainCheckpointer)

    dev = tp_rank_device()
    full, f32, small = shard_cfgs()
    out = {}

    def mesh_of(**axes):
        return make_mesh(MeshSpec.for_devices(world, **axes), dev.type)

    def model_on(cfg, mesh):
        """This rank's blocks of 18a's weights: drawn on the card at
        phase 6's widths, by ``init_params`` for the small config."""
        if cfg.d_model == small.d_model:
            return init_params(cfg, torch.Generator().manual_seed(0), dev,
                               mesh=mesh)
        return card_init(cfg, dev, mesh=mesh)

    for key, axes in (("tp2", {"tp": 2}), ("fsdp2", {"fsdp": 2})):
        mesh = mesh_of(**axes)
        t0 = time.perf_counter()
        model = model_on(full, mesh)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        out[key] = shard_run(model, full, mesh,
                             shard_batch(full, 8, 2048, dev), SHARD_STEPS)
        out[key]["init_s"] = init_s
        del model
        torch.cuda.empty_cache()
    ref = torch.load(ref_path, mmap=True, weights_only=True)
    specs = leaf_specs(f32)
    for key, axes in (("f32_tp2", {"tp": 2}), ("f32_fsdp2", {"fsdp": 2})):
        mesh = mesh_of(**axes)
        sizes, index = mesh_coords(mesh)
        model = model_on(f32, mesh)

        def mine(tree, name):
            return rank_slice(tree[name], specs[name], sizes, index)

        grad_err = {}

        def check_grads():
            for name, p in model.named_parameters():
                want = mine(ref["grads"], name)
                grad_err[name] = ((p.grad.detach().cpu() - want).abs().max()
                                  / want.abs().max()).item()

        st = shard_run(model, f32, mesh, shard_batch(f32, 8, 2048, dev),
                       SHARD_F32_STEPS, after_first=check_grads)
        worst, beyond, outside = 0.0, 0, 0
        for name, p in model.named_parameters():
            diff = (p.detach().cpu() - mine(ref["weights"], name)).abs()
            far = diff > SHARD_F32_TOL
            worst = max(worst, diff.max().item())
            beyond += int(far.sum())
            outside += int((far & (mine(ref["grads"], name).abs()
                                   >= SHARD_ADAM_ZONE)).sum())
        st.update(max_grad_err=max(grad_err.values()),
                  worst_grad_leaf=max(grad_err, key=grad_err.get),
                  max_abs_weight_diff=worst, weights_beyond_tol=beyond,
                  beyond_outside_adam_zone=outside,
                  elements=sum(p.numel() for p in model.parameters()))
        out[key] = st
        del model
        torch.cuda.empty_cache()
    del ref
    for impl in ("ring", "ulysses"):
        cfg = dataclasses.replace(small, attn_impl=impl)
        mesh = mesh_of(sp=2)
        out[impl] = shard_run(model_on(cfg, mesh), cfg, mesh,
                              shard_batch(cfg, *SHARD_SMALL_BT, dev), 2)
    # 18d: stopped at step 2, saved by every rank, resumed (flash, tp 2).
    cfg = dataclasses.replace(small, attn_impl="flash")
    mesh = mesh_of(tp=2)
    batch = shard_batch(cfg, *SHARD_SMALL_BT, dev)

    def fresh():
        model = model_on(cfg, mesh)
        return model, make_optimizer(model, 3e-4)

    ref_losses = train_loop(*fresh(), batch, mesh=mesh, max_steps=4,
                            worker=rank)
    t0 = time.perf_counter()
    first = train_loop(*fresh(), batch, TrainCheckpointer(ckpt_dir,
                                                          mesh=mesh),
                       every=2, max_steps=2, mesh=mesh, worker=rank)
    ck = TrainCheckpointer(ckpt_dir, mesh=mesh)
    step_no, (model, opt) = ck.restore_or(fresh)
    rest = train_loop(model, opt, batch, ck, step_no=step_no, every=2,
                      max_steps=4, mesh=mesh, worker=rank)
    out["resume"] = dict(ref=[x.item() for x in ref_losses],
                         resumed=[x.item() for x in first + rest],
                         step_no=step_no, seconds=time.perf_counter() - t0)
    return out


def check_bf16_losses(label, got, want) -> float:
    """18b's bf16 tolerance (SHARD_BF16_REL1, SHARD_BF16_ABS); returns
    the largest difference."""
    diffs = [abs(a - b) for a, b in zip(got, want)]
    ok = diffs[0] <= SHARD_BF16_REL1 * abs(want[0]) and all(
        d <= SHARD_BF16_ABS * (1 + abs(b))
        for d, b in zip(diffs[1:], want[1:]))
    if not ok or len(got) != len(want):
        raise SystemExit(f"{label}: bf16 losses {got} against one card's "
                         f"{want}")
    return max(diffs)


def phase_sharded_training(dev, card) -> dict:
    """Phase 18 (see the module docstring)."""
    from k8s_gpu_scheduler_tpu_torch.models.llama import (
        rank_leaf_shapes, train_state_bytes)

    full, f32, small = shard_cfgs()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        ref_path = os.path.join(tmp, "f32_ref.pt")
        (one,) = yield World(shard_world_one, 1, "nccl", (ref_path,),
                             SHARD_TIMEOUT)
        for key in ("one", "mesh"):
            log(f"  [{card}] 18a {key}: {json.dumps(one[key])}")
        want = (2 * full.n_layers * SHARD_STEPS, full.n_layers * SHARD_STEPS,
                full.n_layers * SHARD_STEPS)
        if one["mesh"]["losses"] != one["one"]["losses"]:
            raise SystemExit("18a: the size-1 mesh's losses are not "
                             "mesh=None's bit for bit")
        for key in ("one", "mesh"):
            c = one[key]["launches"]
            if tuple(c[k] for k in FLASH) != want or any(
                    c[k] for k in FLASH_PLAIN):
                raise SystemExit(f"18a {key}: launched {c}, want {want}")
        ranks = yield World(shard_world_two, 2, "gloo",
                            (ref_path, os.path.join(tmp, "ckpt")),
                            SHARD_TIMEOUT, cleanup=(tmp,))
    out = {"18a": one}
    ref = one["one"]
    for key, axes in (("tp2", {"tp": 2}), ("fsdp2", {"fsdp": 2})):
        sizes = {"dp": 1, "fsdp": 1, "sp": 1, "ep": 1, "tp": 1, **axes}
        predicted = train_state_bytes(full, sizes)
        n_pred = sum(int(np.prod(s)) for s, _ in
                     rank_leaf_shapes(full, sizes).values())
        for r, res in enumerate(ranks):
            st = res[key]
            log(f"  [{card}] 18b {key} bf16, rank {r}: {json.dumps(st)}")
            if (st["params"], st["state_bytes"]) != (
                    SHARD_RANK_PARAMS, SHARD_RANK_STATE_BYTES) or (
                    n_pred, predicted) != (SHARD_RANK_PARAMS,
                                           SHARD_RANK_STATE_BYTES):
                raise SystemExit(
                    f"18b {key}: rank {r} holds {st['params']} parameters "
                    f"and {st['state_bytes']} bytes of state; predicted "
                    f"{SHARD_RANK_PARAMS} and {SHARD_RANK_STATE_BYTES} "
                    f"(train_state_bytes: {n_pred}, {predicted})")
            if st["launches"] != ref["launches"]:
                raise SystemExit(f"18b {key}: rank {r} launched "
                                 f"{st['launches']}, one card "
                                 f"{ref['launches']}")
            st["max_loss_diff"] = check_bf16_losses(
                f"18b {key} rank {r}", st["losses"], ref["losses"])
        out[key] = [res[key] for res in ranks]
    for key in ("f32_tp2", "f32_fsdp2"):
        for r, res in enumerate(ranks):
            st = res[key]
            rel = max(abs(a - b) / abs(b) for a, b in
                      zip(st["losses"], one["f32"]["losses"]))
            st["max_rel_loss_diff"] = rel
            log(f"  [{card}] 18b {key}, rank {r}: {json.dumps(st)}")
            move = 2 * 3e-4 * SHARD_F32_STEPS      # 2 lr a step at most
            if rel > SHARD_F32_TOL or st["max_grad_err"] > SHARD_F32_TOL \
                    or st["beyond_outside_adam_zone"] \
                    or st["max_abs_weight_diff"] > move:
                raise SystemExit(
                    f"18b {key}: rank {r} parts from one card at f32: "
                    f"losses {st['losses']} (one card "
                    f"{one['f32']['losses']}), first-step gradients "
                    f"{st['max_grad_err']:.2e} of the leaf's largest, "
                    f"{st['beyond_outside_adam_zone']} weights beyond "
                    f"{SHARD_F32_TOL} where the gradient is not below "
                    f"{SHARD_ADAM_ZONE}, largest weight difference "
                    f"{st['max_abs_weight_diff']:.2e}")
        out[key] = [res[key] for res in ranks]
    for impl in ("ring", "ulysses"):
        for r, res in enumerate(ranks):
            st = res[impl]
            rel = max(abs(a - b) / abs(b) for a, b in
                      zip(st["losses"], one["small"]["losses"]))
            log(f"  [{card}] 18c {impl} sp 2, rank {r}: losses "
                f"{st['losses']} (one card's dense {one['small']['losses']},"
                f" rel {rel:.2e}), step ms {st['step_ms']}")
            if rel > 1e-5:
                raise SystemExit(f"18c {impl}: f32 losses part from one "
                                 f"card's dense step by {rel:.2e}")
        out[impl] = [res[impl] for res in ranks]
    for r, res in enumerate(ranks):
        rs = res["resume"]
        log(f"  [{card}] 18d rank {r}: {json.dumps(rs)}")
        if rs["resumed"] != rs["ref"] or rs["step_no"] != 2:
            raise SystemExit(f"18d: rank {r} resumed {rs['resumed']}, the "
                             f"unstopped run {rs['ref']}")
    return out


def phase_rank_flash_kernels(dev, card) -> list:
    """18e: K5, K6 and K7 at a rank's shapes (tp 2: 16/4 heads, B 8;
    fsdp 2: 32/8 heads, B 4), held to their plain versions and timed
    beside the bound and SDPA, as phase 1's train-8b row."""
    flush = _L2Flush(dev)
    cases = (flash_cases("train-8b tp2", 8, 2048, 16, 4, 128, dev, flush)
             + flash_cases("train-8b fsdp2", 4, 2048, 32, 8, 128, dev,
                           flush))
    for c in cases:
        log(f"  [{card}] 18e {c['kernel']:20s} {c['case']:15s} "
            f"max_abs_err {c['max_abs_err']:.3e} (tol {c['tol']}) ms "
            f"{c['ms']:.4f} plain {c['plain_ms']:.4f} sdpa "
            f"{c['library_ms']:.4f} bound {c['bound_ms']:.4f} "
            f"({c['bound_by']}) {c['bound_ms'] / c['ms']:.1%} of bound "
            f"{'ok' if c['ok'] else 'MISMATCH'}")
    bad = [c["kernel"] + ":" + c["case"] for c in cases if not c["ok"]]
    if bad:
        raise SystemExit(f"18e: kernel disagrees with its plain version: "
                         f"{bad}")
    return cases


# -- phase 19: pipeline stages, MoE over ep, restore across meshes ----------

PP_LAYERS, PP_BT, PP_M, PP_STEPS = 2, (8, 2048), 4, 2     # 19b bf16
PP_F32 = dict(vocab=32000, n_layers=2)                    # 19b f32
PP_F32_STEPS = 2
PP_STASH_M = (4, 8)             # 19c: microbatch 1, so B = M
PP_STASH_GATE = 0.05            # 1F1B's peak above its state, M 4 -> 8
# 19b: a stage at pp 2 holds 1 layer whole and the embedding, the head
# and the final norm (llama.rank_leaf_shapes and train_state_bytes at
# {"pp": 2}).
PP_RANK_PARAMS, PP_RANK_STATE_BYTES = 1_268_789_248, 10_150_313_984
EP_LAYERS, EP_BT, EP_STEPS = 2, (8, 2048), 2              # 19d
# 19d: an ep 2 rank at Mixtral's widths, 2 layers: half the experts and
# half the router's columns (the router's state is f32: 16 bytes a
# parameter, 8 for the bf16 rest).
EP_RANK_PARAMS, EP_RANK_STATE_BYTES = 1_755_369_472, 14_043_217_920
RESTORE_BT = (2, 2048)          # 19e: the steps around the checkpoint
SCHEDULES = ("gpipe", "1f1b")


def pp_cfgs():
    """(19b/19c/19e: llama3_8b widths at 2 layers, dense attention as the
    pipeline runs it, remat, bf16; 19b f32: 2 layers, vocab 32000; 19a:
    phase 5's small config, dense)."""
    from k8s_gpu_scheduler_tpu_torch.models.llama import LlamaConfig

    full = dataclasses.replace(LlamaConfig.llama3_8b(), n_layers=PP_LAYERS)
    f32 = dataclasses.replace(full, dtype=torch.float32, **PP_F32)
    small = LlamaConfig(**SHARD_SMALL, attn_impl="dense")
    return full, f32, small


def ep_cfg():
    """19d: Mixtral's widths (phase 14's) at 2 layers, flash, remat."""
    from k8s_gpu_scheduler_tpu_torch.models.llama import LlamaConfig

    return LlamaConfig(**MOE_CFG, n_layers=EP_LAYERS, attn_impl="flash",
                       remat=True)


def pp_step(M, schedule):
    """A ``shard_run`` step maker for the pipeline."""
    from k8s_gpu_scheduler_tpu_torch.models.pipeline import (
        make_pp_train_step)

    return lambda cfg, mesh, opt: make_pp_train_step(cfg, mesh, opt, M,
                                                     schedule)


def moe_drops(model, batch, mesh):
    """The (token, choice) pairs each layer's capacity dropped in a
    forward of ``batch`` (this rank's tokens on a mesh)."""
    from k8s_gpu_scheduler_tpu_torch.models.llama import loss_fn
    from k8s_gpu_scheduler_tpu_torch.ops.moe import recording_drops

    with torch.no_grad(), recording_drops() as drops:
        loss_fn(model, batch, mesh)
    return [int(d) for d in drops]


def world19_one(rank, world, ref_path):
    """19a on an NCCL world of one, and the one-card references of 19b
    (bf16 losses; f32 weights and first-step gradients, saved to
    ``ref_path``) and of 19d (losses, drops)."""
    from k8s_gpu_scheduler_tpu_torch.models.llama import (
        LlamaConfig, init_params)
    from k8s_gpu_scheduler_tpu_torch.parallel import MeshSpec, make_mesh

    dev = tp_rank_device()
    full, f32, small = pp_cfgs()
    out = {}
    batch = shard_batch(small, *SHARD_SMALL_BT, dev)
    pp1 = make_mesh(MeshSpec({"pp": 1}), dev.type)
    for key, mesh, make_step in (("one", None, None),
                                 ("pp1", pp1, pp_step(2, "gpipe"))):
        model = init_params(small, torch.Generator().manual_seed(0), dev)
        out[f"19a_{key}"] = shard_run(model, small, mesh, batch, 2,
                                      make_step=make_step)
    moe = LlamaConfig(**{**SMALL_MOE, "remat": True})
    one = make_mesh(MeshSpec.for_devices(1), dev.type)
    for key, mesh in (("moe_one", None), ("moe_mesh", one)):
        model = init_params(moe, torch.Generator().manual_seed(0), dev)
        out[f"19a_{key}"] = shard_run(model, moe, mesh,
                                      shard_batch(moe, *SHARD_SMALL_BT, dev),
                                      2)
    del model
    model = card_init(full, dev)
    out["19b_one"] = shard_run(model, full, None,
                               shard_batch(full, *PP_BT, dev), PP_STEPS)
    del model
    torch.cuda.empty_cache()
    model = card_init(f32, dev)
    grads = {}

    def keep_grads():
        grads.update({n: p.grad.detach().cpu()
                      for n, p in model.named_parameters()})

    out["19b_f32_one"] = shard_run(model, f32, None,
                                   shard_batch(f32, *PP_BT, dev),
                                   PP_F32_STEPS, after_first=keep_grads)
    torch.save({"weights": {k: v.detach().cpu()
                            for k, v in model.state_dict().items()},
                "grads": grads}, ref_path)
    del grads, model
    torch.cuda.empty_cache()
    cfg = ep_cfg()
    model = card_init(cfg, dev)
    batch = shard_batch(cfg, *EP_BT, dev)
    out["19d_drops"] = moe_drops(model, batch, None)
    out["19d_one"] = shard_run(model, cfg, None, batch, EP_STEPS)
    del model
    torch.cuda.empty_cache()
    return out


def saved_tp2_leaf(docs, specs, whole, get, dev):
    """Leaf ``whole`` (or its moment, ``get``) of a step saved at tp 2,
    assembled on ``dev`` by concatenating the two ranks' blocks along
    the dim its spec gives tp: an assembly independent of the
    checkpointer's."""
    spec = specs[whole]
    parts = [get(d).to(dev) for d in docs]
    return parts[0] if "tp" not in spec else torch.cat(
        parts, dim=spec.index("tp"))


def restored_mismatches(model, opt, cfg, sizes, index, docs, dev) -> list:
    """The (parameter, part) pairs of a restored rank that are not, bit
    for bit, its block of the saved tp 2 step (the weight, both AdamW
    moments and the step count 2)."""
    from k8s_gpu_scheduler_tpu_torch.models.llama import (
        leaf_specs, rank_layout)

    specs = leaf_specs(cfg)
    layout = rank_layout(cfg, sizes, index)
    order = {name: i for i, name in enumerate(docs[0]["model"])}
    bad = []
    for name, p in model.named_parameters():
        whole, region = layout[name]
        st = opt.state[p]
        for part, mine in (("weight", p), ("exp_avg", st["exp_avg"]),
                           ("exp_avg_sq", st["exp_avg_sq"])):
            get = ((lambda d: d["model"][whole]) if part == "weight" else
                   (lambda d, k=part: d["opt"]["state"][order[whole]][k]))
            want = saved_tp2_leaf(docs, specs, whole, get, dev)[region]
            if not torch.equal(mine.detach(), want):
                bad.append((name, part))
        if float(st["step"]) != 2:
            bad.append((name, "step"))
    return bad


def restore_on_card(rank, world, cfg, ckpt_dir, dev) -> dict:
    """19e: two steps at tp 2 saved at step 2 (and the tp 2 run's third
    step), then the step restored onto fsdp 2, onto pp 2 (a 1F1B step
    over 2 microbatches) and, on rank 0 alone, onto one card; each
    restored state checked bit for bit against the saved files
    (``restored_mismatches``) and its next step's loss taken."""
    import torch.distributed as dist

    from k8s_gpu_scheduler_tpu_torch.models.llama import (
        make_optimizer, make_train_step)
    from k8s_gpu_scheduler_tpu_torch.models.pipeline import (
        make_pp_train_step)
    from k8s_gpu_scheduler_tpu_torch.parallel import MeshSpec, make_mesh
    from k8s_gpu_scheduler_tpu_torch.parallel.mesh import MeshAxes
    from k8s_gpu_scheduler_tpu_torch.utils.checkpoint import (
        TrainCheckpointer)

    batch = shard_batch(cfg, *RESTORE_BT, dev)
    tp2 = make_mesh(MeshSpec.for_devices(world, tp=2), dev.type)
    model = card_init(cfg, dev, mesh=tp2)
    opt = make_optimizer(model, 3e-4)
    step = make_train_step(cfg, tp2, opt)
    for _ in range(2):
        step(model, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    TrainCheckpointer(ckpt_dir, mesh=tp2).save(2, (model, opt))
    out = {"save_s": time.perf_counter() - t0,
           "tp2_next_loss": float(step(model, batch))}
    del model, opt, step
    torch.cuda.empty_cache()
    files = sorted(f for f in os.listdir(os.path.join(ckpt_dir, "2"))
                   if f.startswith("rank-"))
    docs = [torch.load(os.path.join(ckpt_dir, "2", f), mmap=True,
                       weights_only=True) for f in files]
    pp2 = make_mesh(MeshSpec({"pp": 2}), dev.type)
    targets = [("fsdp2", make_mesh(MeshSpec.for_devices(world, fsdp=2),
                                   dev.type),
                lambda m, o: make_train_step(cfg, m, o)),
               ("pp2", pp2,
                lambda m, o: make_pp_train_step(cfg, m, o, 2, "1f1b"))]
    if rank == 0:
        targets.append(("one", None,
                        lambda m, o: make_train_step(cfg, None, o)))
    for key, mesh, make in targets:
        model = card_init(cfg, dev, seed=1, mesh=mesh)     # other weights
        opt = make_optimizer(model, 3e-4)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        at, (model, opt) = TrainCheckpointer(ckpt_dir, mesh=mesh).restore_or(
            lambda: (model, opt))
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        sizes, index = ((MeshAxes(mesh).sizes, MeshAxes(mesh).index)
                        if mesh is not None else ({}, {}))
        bad = restored_mismatches(model, opt, cfg, sizes, index, docs, dev)
        out[key] = dict(step_no=at, restore_s=restore_s, mismatches=bad,
                        loss=float(make(mesh, opt)(model, batch)),
                        state_bytes=sum(
                            t.numel() * t.element_size()
                            for t in list(model.parameters())
                            + [st[k] for st in opt.state.values()
                               for k in ("exp_avg", "exp_avg_sq")]))
        del model, opt
        torch.cuda.empty_cache()
    dist.barrier()
    return out


def world19_two(rank, world, ref_path, ckpt_dir):
    """19b-e on a gloo world of two ranks sharing the card."""
    import torch.distributed as dist

    from k8s_gpu_scheduler_tpu_torch.models.llama import (
        make_optimizer, rank_layout)
    from k8s_gpu_scheduler_tpu_torch.models.pipeline import (
        make_pp_train_step)
    from k8s_gpu_scheduler_tpu_torch.parallel import MeshSpec, make_mesh
    from k8s_gpu_scheduler_tpu_torch.parallel.mesh import MeshAxes

    dev = tp_rank_device()
    full, f32, _ = pp_cfgs()
    pp2 = make_mesh(MeshSpec({"pp": 2}), dev.type)
    ax = MeshAxes(pp2)
    out = {"stage": ax.index["pp"]}
    for sched in SCHEDULES:
        model = card_init(full, dev, mesh=pp2)
        out[f"19b_{sched}"] = shard_run(
            model, full, pp2, shard_batch(full, *PP_BT, dev), PP_STEPS,
            make_step=pp_step(PP_M, sched))
        del model
        torch.cuda.empty_cache()
    ref = torch.load(ref_path, mmap=True, weights_only=True)
    whole = {n: w for n, (w, _) in rank_layout(f32, ax.sizes,
                                               ax.index).items()}
    for sched in SCHEDULES:
        model = card_init(f32, dev, mesh=pp2)
        grad_err = {}

        def check_grads():
            for name, p in model.named_parameters():
                want = ref["grads"][whole[name]]
                grad_err[name] = ((p.grad.detach().cpu() - want).abs().max()
                                  / want.abs().max()).item()

        st = shard_run(model, f32, pp2, shard_batch(f32, *PP_BT, dev),
                       PP_F32_STEPS, after_first=check_grads,
                       make_step=pp_step(PP_M, sched))
        worst, beyond, outside = 0.0, 0, 0
        for name, p in model.named_parameters():
            diff = (p.detach().cpu() - ref["weights"][whole[name]]).abs()
            far = diff > SHARD_F32_TOL
            worst = max(worst, diff.max().item())
            beyond += int(far.sum())
            outside += int((far & (ref["grads"][whole[name]].abs()
                                   >= SHARD_ADAM_ZONE)).sum())
        st.update(max_grad_err=max(grad_err.values()),
                  worst_grad_leaf=max(grad_err, key=grad_err.get),
                  max_abs_weight_diff=worst, weights_beyond_tol=beyond,
                  beyond_outside_adam_zone=outside)
        out[f"19b_f32_{sched}"] = st
        del model
        torch.cuda.empty_cache()
    del ref
    dist.barrier()
    if rank == 0:
        os.remove(ref_path)          # room for 19e's checkpoint
    for M in PP_STASH_M:
        for sched in SCHEDULES:
            model = card_init(full, dev, mesh=pp2)
            opt = make_optimizer(model, 3e-4)
            step = make_pp_train_step(full, pp2, opt, M, sched)
            batch = shard_batch(full, M, PP_BT[1], dev)
            step(model, batch)     # the state: gradients and moments
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            step(model, batch)
            torch.cuda.synchronize()
            out[f"19c_{sched}_{M}"] = dict(
                state_gb=before / 1e9,
                peak_above_state_gb=(torch.cuda.max_memory_allocated()
                                     - before) / 1e9)
            del model, opt, step
            torch.cuda.empty_cache()
    cfg = ep_cfg()
    ep2 = make_mesh(MeshSpec.for_devices(world, ep=2), dev.type)
    model = card_init(cfg, dev, mesh=ep2)
    batch = shard_batch(cfg, *EP_BT, dev)
    out["19d_drops"] = moe_drops(model, batch, ep2)
    out["19d"] = shard_run(model, cfg, ep2, batch, EP_STEPS)
    del model
    torch.cuda.empty_cache()
    out["19e"] = restore_on_card(rank, world, full, ckpt_dir, dev)
    return out


def phase_pipeline_ep_restore(dev, card) -> dict:
    """Phase 19 (see the module docstring)."""
    from k8s_gpu_scheduler_tpu_torch.models.llama import (
        rank_leaf_shapes, train_state_bytes)

    full, f32, small = pp_cfgs()
    log(f"  cuts: 19b/19c/19e llama3_8b widths at {PP_LAYERS} layers "
        f"({PP_LAYERS // 2} a stage), 19b f32 at {PP_F32['n_layers']} "
        f"layers and vocab "
        f"{PP_F32['vocab']}, 19d Mixtral widths at {EP_LAYERS} layers "
        f"(two ranks at 4 would need about 76 GB of the card); no width "
        f"cut")
    for key, cfg, sizes in (("19b", full, {"pp": 2}),
                            ("19d", ep_cfg(), {"ep": 2})):
        n = sum(int(np.prod(s))
                for s, _ in rank_leaf_shapes(cfg, sizes).values())
        log(f"  {key} predicted a rank: {n} parameters, "
            f"{train_state_bytes(cfg, sizes)} bytes of state (one card "
            f"{train_state_bytes(cfg)})")
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        ref_path = os.path.join(tmp, "f32_ref.pt")
        (one,) = yield World(world19_one, 1, "nccl", (ref_path,),
                             SHARD_TIMEOUT)
        ranks = yield World(world19_two, 2, "gloo",
                            (ref_path, os.path.join(tmp, "ckpt")),
                            SHARD_TIMEOUT, cleanup=(tmp,))
    check_19a(card, one)
    check_19b(card, one, ranks)
    check_19c(card, ranks)
    check_19d(card, one, ranks)
    check_19e(card, ranks)
    return {"one": one, "ranks": ranks}


def check_19a(card, one) -> None:
    a, b = one["19a_one"]["losses"], one["19a_pp1"]["losses"]
    rel = max(abs(x - y) / abs(x) for x, y in zip(a, b))
    log(f"  [{card}] 19a pp 1 GPipe (M 2) losses {b} against mesh=None "
        f"{a}: rel {rel:.2e}; MoE on a size-1 mesh "
        f"{one['19a_moe_mesh']['losses']}, mesh=None "
        f"{one['19a_moe_one']['losses']}")
    if rel > 1e-6:
        raise SystemExit(f"19a: the pp 1 GPipe step parts from mesh=None "
                         f"by {rel:.2e}")
    if one["19a_moe_mesh"]["losses"] != one["19a_moe_one"]["losses"]:
        raise SystemExit("19a: MoE on a size-1 mesh is not mesh=None's "
                         "bit for bit")


def check_19b(card, one, ranks) -> None:
    for key in ("19b_one", "19b_f32_one"):
        log(f"  [{card}] {key} (one card, dense): "
            f"{json.dumps(one[key])}")
    for r, res in enumerate(ranks):
        for sched in SCHEDULES:
            st = res[f"19b_{sched}"]
            st["max_loss_diff"] = check_bf16_losses(
                f"19b {sched} rank {r}", st["losses"],
                one["19b_one"]["losses"])
            log(f"  [{card}] 19b {sched} bf16, stage {res['stage']}: "
                f"{json.dumps(st)} (step ms through gloo on one card: not "
                f"scaling)")
            if (st["params"], st["state_bytes"]) != (PP_RANK_PARAMS,
                                                     PP_RANK_STATE_BYTES):
                raise SystemExit(
                    f"19b {sched}: rank {r} holds {st['params']} "
                    f"parameters, {st['state_bytes']} bytes of state; "
                    f"predicted {PP_RANK_PARAMS}, {PP_RANK_STATE_BYTES}")
            st = res[f"19b_f32_{sched}"]
            rel = max(abs(a - b) / abs(b) for a, b in
                      zip(st["losses"], one["19b_f32_one"]["losses"]))
            st["max_rel_loss_diff"] = rel
            log(f"  [{card}] 19b {sched} f32, stage {res['stage']}: "
                f"{json.dumps(st)}")
            move = 2 * 3e-4 * PP_F32_STEPS
            if rel > SHARD_F32_TOL or st["max_grad_err"] > SHARD_F32_TOL \
                    or st["beyond_outside_adam_zone"] \
                    or st["max_abs_weight_diff"] > move:
                raise SystemExit(
                    f"19b {sched} f32: rank {r} parts from one card: "
                    f"losses {st['losses']} (one card "
                    f"{one['19b_f32_one']['losses']}), gradients "
                    f"{st['max_grad_err']:.2e} of the leaf's largest, "
                    f"{st['beyond_outside_adam_zone']} weights beyond "
                    f"{SHARD_F32_TOL} outside AdamW's eps zone")


def check_19c(card, ranks) -> None:
    for res in ranks:
        s = res["stage"]
        peaks = {(sched, M): res[f"19c_{sched}_{M}"]["peak_above_state_gb"]
                 for sched in SCHEDULES for M in PP_STASH_M}
        log(f"  [{card}] 19c stage {s}, microbatch 1, peak above the state "
            f"(GB): " + ", ".join(f"{k[0]} M {k[1]} {v:.3f}"
                                  for k, v in peaks.items()))
        g4, g8 = peaks["gpipe", 4], peaks["gpipe", 8]
        f4, f8 = peaks["1f1b", 4], peaks["1f1b", 8]
        if not g8 > g4:
            raise SystemExit(f"19c: GPipe's peak on stage {s} did not grow "
                             f"with M ({g4:.3f} -> {g8:.3f} GB)")
        if abs(f8 - f4) > PP_STASH_GATE * f4:
            raise SystemExit(f"19c: 1F1B's peak on stage {s} moved by more "
                             f"than {PP_STASH_GATE:.0%} from M 4 to M 8 "
                             f"({f4:.3f} -> {f8:.3f} GB)")


def check_19d(card, one, ranks) -> None:
    ref = one["19d_one"]
    log(f"  [{card}] 19d one card: {json.dumps(ref)}")
    want = (2 * EP_LAYERS * EP_STEPS, EP_LAYERS * EP_STEPS,
            EP_LAYERS * EP_STEPS)
    for r, res in enumerate(ranks):
        st = res["19d"]
        st["max_loss_diff"] = check_bf16_losses(
            f"19d rank {r}", st["losses"], ref["losses"])
        log(f"  [{card}] 19d ep 2 rank {r}: {json.dumps(st)}; dropped "
            f"(token, choice) pairs by layer, step 1: {res['19d_drops']} "
            f"(one card {one['19d_drops']}) (step ms through gloo on one "
            f"card: not scaling)")
        c = st["launches"]
        if tuple(c[k] for k in FLASH) != want or any(c[k] for k in
                                                     FLASH_PLAIN):
            raise SystemExit(f"19d: rank {r} launched {c}, want {want} and "
                             f"no plain version")
        if (st["params"], st["state_bytes"]) != (EP_RANK_PARAMS,
                                                 EP_RANK_STATE_BYTES):
            raise SystemExit(
                f"19d: rank {r} holds {st['params']} parameters, "
                f"{st['state_bytes']} bytes of state; predicted "
                f"{EP_RANK_PARAMS}, {EP_RANK_STATE_BYTES}")


def check_19e(card, ranks) -> None:
    for r, res in enumerate(ranks):
        e = res["19e"]
        log(f"  [{card}] 19e rank {r}: save {e['save_s']:.2f} s; "
            + "; ".join(f"{k}: restore {e[k]['restore_s']:.2f} s, step "
                        f"{e[k]['step_no']}, next loss {e[k]['loss']:.6f} "
                        f"(tp 2 {e['tp2_next_loss']:.6f}), "
                        f"{len(e[k]['mismatches'])} mismatches, "
                        f"{e[k]['state_bytes']} bytes"
                        for k in ("fsdp2", "pp2", "one") if k in e))
        for k in ("fsdp2", "pp2", "one"):
            if k not in e:
                continue
            if e[k]["mismatches"] or e[k]["step_no"] != 2:
                raise SystemExit(f"19e {k}: rank {r} restored step "
                                 f"{e[k]['step_no']}, parts from the saved "
                                 f"state at {e[k]['mismatches'][:8]}")
            check_bf16_losses(f"19e {k} rank {r}", [e[k]["loss"]],
                              [e["tp2_next_loss"]])
    if "one" not in ranks[0]["19e"]:
        raise SystemExit("19e: rank 0 did not restore onto one card")


# -- phase 20: gang serving ------------------------------------------------------

GANG_NEW = 64                   # 20a/20b: the serve loop's max_new
GANG_B = 8                      # 20b/20c: phase 3's first 8 prompts (512)
GANG_GQA_NEW = 8                # 20c: new tokens (each decode step gathers
                                # a rank's o/down blocks through gloo)
GANG_GQA_LAYERS = 2             # 20c: llama3_8b's 32 layers cut to 2 (4
                                # before the script's time limit forced it)
GANG_F32_LAYERS = 2             # 20a-c f32: cut to 2 layers (an identity
                                # check; a tp 2 token is ~30 ms a layer)
GANG_TIMEOUT = 600              # seconds a rank world may take
# 20b: one card's K and V caches at the serve config (L 8, B 8, S 2048,
# 16 kv heads, hd 64, bf16) and a rank's at tp 2 or dp 2 (PERF.md §4).
GANG_CACHE_BYTES = 536_870_912
GANG_RANK_CACHE_BYTES = 268_435_456
GANG_MAIN_WAVES = 2             # 20d: wave lines read from each worker
GANG_MAIN_ARGV = ["--serve", "--max-new", "16"]   # 20d: JAX's defaults but
                                # max_new (64): each token at tp 2 gathers
                                # the o/down blocks through gloo
# 20e: the int8 leg's meshes in the world of two (fsdp 2 is where a
# scale's max crosses ranks: fsdp splits K of q/k/v/gate/up and the head).
GANG_INT8 = (("tp2", {"tp": 2}), ("fsdp2", {"fsdp": 2}))
GANG_INT8_NEW = 16              # 20e: new tokens, cut from 64 (at 64 the leg
                                # took ~50 s: each fsdp 2 token gathers every
                                # weight and the embedding through gloo)
GANG_REFUSED = (["--int8"], ["--temperature", "0.7"], ["--top-k", "5"],
                ["--eos-id", "3"])
GANG_REFUSAL = ("--int8/--temperature/--top-k/--eos-id need the continuous "
                "batcher, which is single-process only; this gang has 2 "
                "processes")


def gang_configs():
    """20a-c's configs, keyed as the runs are: the serve config and
    llama3_8b's widths at 2 layers (GQA, 32/8 heads, hd 128) in bf16, and
    each at 2 layers in f32."""
    from k8s_gpu_scheduler_tpu_torch.models.llama import LlamaConfig

    serve = dataclasses.replace(LlamaConfig.serve(), decode_attn="fused")
    gqa = dataclasses.replace(LlamaConfig(**TP_GQA),
                              n_layers=GANG_GQA_LAYERS)

    def f32(cfg):
        return dataclasses.replace(cfg, dtype=torch.float32,
                                   n_layers=GANG_F32_LAYERS)

    return {"bf16": serve, "f32": f32(serve), "gqa": gqa,
            "gqa_f32": f32(gqa)}


def gang_prompts(key, vocab):
    """20b's prompts (phase 3's first 8, 512 tokens) or 20c's (17f's, 256
    tokens), as an int64 array [8, T]."""
    _, main, _ = tp_traffic(vocab)
    rows = gqa_prompts(main) if key.startswith("gqa") else main[:GANG_B]
    return np.array([list(p) for p in rows], np.int64)


def gang_generate(model, cfg, prompts, max_new, mesh):
    """``make_server_step(cfg, mesh, max_new)`` on this rank (``mesh``
    None: one card) for ``prompts``. Counters are zeroed just before and
    read just after. Returns the streams, the launches, the bytes of the
    K and V caches the call allocated, the split counts K4's wrapper
    planned and the wall time."""
    from k8s_gpu_scheduler_tpu_torch.models import serving
    from k8s_gpu_scheduler_tpu_torch.ops import decode_attention as da

    caches, splits = [], set()
    init, k4 = serving.init_cache, serving.flash_decode_attention

    def init_cache(*a, **kw):
        c = init(*a, **kw)
        caches.append(sum(c[x].numel() * c[x].element_size()
                          for x in ("k", "v")))
        return c

    def launch(*a, **kw):
        out = k4(*a, **kw)
        splits.add(k4.last_splits)
        return out

    step = serving.make_server_step(cfg, mesh, max_new, max_len=cfg.max_seq)
    x = torch.from_numpy(prompts).to(model.device)
    serving.init_cache, serving.flash_decode_attention = init_cache, launch
    try:
        torch.cuda.synchronize()
        da.reset_counters()
        t0 = time.perf_counter()
        out = step(model, x)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        serving.init_cache, serving.flash_decode_attention = init, k4
    return dict(streams=out.cpu().tolist(), launches=da.counters(),
                cache_bytes=caches, splits=sorted(splits), wall_s=wall,
                dtype=str(out.dtype))


def gang_world_one(rank, world):
    """20a, an NCCL world of one: the serve config's ``generate`` through
    a size-1 mesh and with ``mesh=None`` (bf16 and f32), and the one-card
    references of 20b and 20c."""
    from k8s_gpu_scheduler_tpu_torch.ops.quant import quantize_llama_params
    from k8s_gpu_scheduler_tpu_torch.parallel import MeshSpec, make_mesh

    dev = tp_rank_device()
    mesh = make_mesh(MeshSpec.for_devices(1), dev.type)
    out = {}
    for key, cfg in gang_configs().items():
        model = card_init(cfg, dev)
        prompts = gang_prompts(key, cfg.vocab)
        new = GANG_GQA_NEW if key.startswith("gqa") else GANG_NEW
        out[key] = gang_generate(model, cfg, prompts, new, None)
        if not key.startswith("gqa"):
            out[key + " mesh"] = gang_generate(model, cfg, prompts, new,
                                               mesh)
            out[key + " int8"] = gang_generate(
                quantize_llama_params(model), cfg, prompts, GANG_INT8_NEW,
                None)
        del model
        torch.cuda.empty_cache()
    return out


def int8_rank_check(model, cfg, dev, mesh) -> dict:
    """20e: a rank's int8 model (``quantize_llama_params(..., mesh=)`` of
    its ``card_init(..., mesh=)`` blocks) against the cut of one card's
    quantization of the same draws, every ``q``, scale and plain leaf
    compared with ``torch.equal`` on the card (a scale's cut keeps K's
    row whole), and its bytes against ``rank_leaf_shapes(int8=True)``."""
    from k8s_gpu_scheduler_tpu_torch.models.llama import (
        rank_layout, rank_leaf_shapes)
    from k8s_gpu_scheduler_tpu_torch.ops.quant import quantize_llama_params
    from k8s_gpu_scheduler_tpu_torch.parallel.mesh import MeshAxes

    ax = MeshAxes.of(mesh)
    layout = rank_layout(cfg, ax.sizes, ax.index)
    whole = quantize_llama_params(card_init(cfg, dev))
    ref = {**dict(whole.named_parameters()), **dict(whole.named_buffers())}
    held = {**dict(model.named_parameters()), **dict(model.named_buffers())}
    differ = []
    for name, t in held.items():
        base, _, part = name.rpartition(".")
        if part in ("q", "s") and base in layout:
            whole_name, region = layout[base]
            whole_name += "." + part
            if part == "s":
                region = region[:-2] + (slice(None),) + region[-1:]
        else:
            whole_name, region = layout[name]
        if not torch.equal(t, ref[whole_name][region]):
            differ.append(name)
    want = sum(int(np.prod(shape)) * torch.empty(0, dtype=dt).element_size()
               for shape, dt in rank_leaf_shapes(cfg, ax.sizes,
                                                 int8=True).values())
    got = sum(t.numel() * t.element_size() for t in held.values())
    del whole, ref
    torch.cuda.empty_cache()
    return dict(leaves=len(held), differ=differ, bytes=got, want_bytes=want)


def gang_world_two(rank, world):
    """20b-c, a gloo world of two ranks sharing the card: the serve config
    at tp 2 and at dp 2, and the GQA config at tp 2, each rank's blocks
    (``card_init(..., mesh=)``) of 20a's weights; 20e, the serve config's
    int8 at tp 2 and fsdp 2, each rank quantizing its own blocks of them
    (``quantize_llama_params(..., mesh=)``)."""
    from k8s_gpu_scheduler_tpu_torch.ops.quant import quantize_llama_params
    from k8s_gpu_scheduler_tpu_torch.parallel import MeshSpec, make_mesh

    dev = tp_rank_device()
    cfgs = gang_configs()
    out = {}
    for name, axes, keys in (("tp2", {"tp": 2}, ("bf16", "f32", "gqa",
                                                 "gqa_f32")),
                             ("dp2", {}, ("bf16", "f32"))):
        mesh = make_mesh(MeshSpec.for_devices(world, **axes), dev.type)
        for key in keys:
            cfg = cfgs[key]
            model = card_init(cfg, dev, mesh=mesh)
            new = GANG_GQA_NEW if key.startswith("gqa") else GANG_NEW
            out[f"{name} {key}"] = gang_generate(
                model, cfg, gang_prompts(key, cfg.vocab), new, mesh)
            del model
            torch.cuda.empty_cache()
    for name, axes in GANG_INT8:
        mesh = make_mesh(MeshSpec.for_devices(world, **axes), dev.type)
        for key in ("bf16", "f32"):
            cfg = cfgs[key]
            model = quantize_llama_params(card_init(cfg, dev, mesh=mesh),
                                          mesh=mesh)
            st = gang_generate(model, cfg, gang_prompts(key, cfg.vocab),
                               GANG_INT8_NEW, mesh)
            st["int8"] = int8_rank_check(model, cfg, dev, mesh)
            out[f"{name} {key} int8"] = st
            del model
            torch.cuda.empty_cache()
    return out


def check_gang_launches(label, st, cfg, max_new) -> None:
    """A run launched K4 once a layer a token after the prefill and ran
    no plain version."""
    c = st["launches"]
    want = cfg.n_layers * (max_new - 1)
    if c["flash_decode_attention"] != want or any(c[k] for k in PLAIN):
        raise SystemExit(f"{label}: K4 launched "
                         f"{c['flash_decode_attention']} times (want "
                         f"{want}), counters {c}")


def phase_gang_streams(card, one, ranks, dev) -> dict:
    """20b/20c's checks: every rank's launches and its cache bytes (half
    of one card's at tp 2 and at dp 2, and 268,435,456 at the serve
    config in bf16); f32 streams identical to one card's, bf16 parting
    only at near-ties, under ``TP_PART_CAP``."""
    cfgs = gang_configs()
    out = {}
    for run in ("tp2 bf16", "tp2 f32", "dp2 bf16", "dp2 f32", "tp2 gqa",
                "tp2 gqa_f32"):
        key = run.split()[1]
        cfg = cfgs[key]
        new = GANG_GQA_NEW if key.startswith("gqa") else GANG_NEW
        ref = one[key]
        for r, res in enumerate(ranks):
            st = res[run]
            check_gang_launches(f"20 {run} rank {r}", st, cfg, new)
            if st["cache_bytes"] != [ref["cache_bytes"][0] // 2] or \
                    st["streams"] != ranks[0][run]["streams"]:
                raise SystemExit(f"20 {run} rank {r}: cache bytes "
                                 f"{st['cache_bytes']} (one card "
                                 f"{ref['cache_bytes']}), or its streams "
                                 f"differ from rank 0's")
            if st["splits"] != ref["splits"]:
                raise SystemExit(f"20 {run} rank {r}: K4 planned "
                                 f"{st['splits']} splits, one card "
                                 f"{ref['splits']}")
        log(f"  [{card}] 20 {run}: rank 0 "
            f"{json.dumps({k: v for k, v in ranks[0][run].items() if k != 'streams'})}; "
            f"one card wall {ref['wall_s']:.3f} s, cache {ref['cache_bytes']}")
    if one["bf16"]["cache_bytes"] != [GANG_CACHE_BYTES] or \
            ranks[0]["tp2 bf16"]["cache_bytes"] != [GANG_RANK_CACHE_BYTES]:
        raise SystemExit(f"20b: cache bytes {one['bf16']['cache_bytes']} "
                         f"and {ranks[0]['tp2 bf16']['cache_bytes']}, "
                         f"predicted {GANG_CACHE_BYTES} and "
                         f"{GANG_RANK_CACHE_BYTES}")
    for key, runs in (("f32", ("tp2 f32", "dp2 f32")),
                      ("gqa_f32", ("tp2 gqa_f32",))):
        for run in runs:
            out[f"20 {run}"] = check_streams(
                f"20 {run}", torch.float32, ranks[0][run]["streams"],
                one[key]["streams"], None, None, None, 0.0)
    for key, runs in (("bf16", ("tp2 bf16", "dp2 bf16")),
                      ("gqa", ("tp2 gqa",))):
        cfg = cfgs[key]
        model = card_init(cfg, dev)
        spread = logit_spread(model, cfg, dev)
        prompts = gang_prompts(key, cfg.vocab)
        for run in runs:
            streams, ref = ranks[0][run]["streams"], one[key]["streams"]
            log(f"  [{card}] 20 {run}: first differing token of each "
                f"parting stream: {tp_partings(streams, ref)}")
            out[f"20 {run}"] = check_streams(
                f"20 {run}", torch.bfloat16, streams, ref, prompts, model,
                spread, TP_PART_CAP)
            log(f"  [{card}] 20 {run} against one card: "
                f"{json.dumps(out[f'20 {run}'])}")
        del model
        torch.cuda.empty_cache()
    return out


def phase_gang_int8(card, one, ranks, dev) -> dict:
    """20e's checks: one card's int8 launches; on every rank at tp 2 and
    fsdp 2, ``q`` and ``s`` exactly the cut of one card's quantization
    and the bytes ``rank_leaf_shapes(int8=True)`` counts, K4 launched
    (max_new - 1) x layers times under one card's split counts with no
    plain call, half one card's cache; f32 streams identical to one
    card's int8 streams, bf16 parting only at near-ties, under
    ``TP_PART_CAP``. Logs each int8 ``generate``'s wall beside the bf16
    leg's."""
    from k8s_gpu_scheduler_tpu_torch.ops.quant import quantize_llama_params

    cfgs = gang_configs()
    out = {}
    for key in ("bf16", "f32"):
        check_gang_launches(f"20e one card {key} int8", one[key + " int8"],
                            cfgs[key], GANG_INT8_NEW)
    for name, _ in GANG_INT8:
        for key in ("bf16", "f32"):
            run, ref = f"{name} {key} int8", one[f"{key} int8"]
            for r, res in enumerate(ranks):
                st, q = res[run], res[run]["int8"]
                check_gang_launches(f"20e {run} rank {r}", st, cfgs[key],
                                    GANG_INT8_NEW)
                if q["differ"] or q["bytes"] != q["want_bytes"]:
                    raise SystemExit(
                        f"20e {run} rank {r}: leaves differing from the cut "
                        f"of one card's quantization {q['differ'][:8]}, "
                        f"bytes {q['bytes']} (want {q['want_bytes']})")
                if st["splits"] != ref["splits"] or st["cache_bytes"] != [
                        ref["cache_bytes"][0] // 2] or \
                        st["streams"] != ranks[0][run]["streams"]:
                    raise SystemExit(
                        f"20e {run} rank {r}: splits {st['splits']} (one "
                        f"card {ref['splits']}), cache {st['cache_bytes']} "
                        f"(one card {ref['cache_bytes']}), or its streams "
                        f"differ from rank 0's")
            log(f"  [{card}] 20e {run}: rank 0 "
                f"{json.dumps({k: v for k, v in ranks[0][run].items() if k != 'streams'})}; "
                f"rank 1 int8 {json.dumps(ranks[1][run]['int8'])}")
    for name, _ in GANG_INT8:
        run = f"{name} f32 int8"
        out[f"20e {run}"] = check_streams(
            f"20e {run}", torch.float32, ranks[0][run]["streams"],
            one["f32 int8"]["streams"], None, None, None, 0.0)
    cfg = cfgs["bf16"]
    model = quantize_llama_params(card_init(cfg, dev))
    spread = logit_spread(model, cfg, dev)
    prompts = gang_prompts("bf16", cfg.vocab)
    for name, _ in GANG_INT8:
        run = f"{name} bf16 int8"
        streams, ref = ranks[0][run]["streams"], one["bf16 int8"]["streams"]
        log(f"  [{card}] 20e {run}: first differing token of each parting "
            f"stream: {tp_partings(streams, ref)}")
        out[f"20e {run}"] = check_streams(
            f"20e {run}", torch.bfloat16, streams, ref, prompts, model,
            spread, TP_PART_CAP)
        log(f"  [{card}] 20e {run} against one card's int8: "
            f"{json.dumps(out[f'20e {run}'])}")
    del model
    torch.cuda.empty_cache()
    for key in ("bf16", "f32"):
        walls = {"one card": (one[key + " int8"]["wall_s"],
                              one[key]["wall_s"])}
        walls.update({name: (ranks[0][f"{name} {key} int8"]["wall_s"],
                             ranks[0][f"tp2 {key}"]["wall_s"])
                      for name, _ in GANG_INT8})
        log(f"  [{card}] 20e {key} generate wall, int8 ({GANG_INT8_NEW} new "
            f"tokens) / the {key} leg's ({GANG_NEW}; 20a one card, 20b tp 2 "
            f"for both meshes), s and ms a new token: " + ", ".join(
                f"{k} {a:.3f} / {b:.3f} ({1e3 * a / GANG_INT8_NEW:.1f} / "
                f"{1e3 * b / GANG_NEW:.1f})" for k, (a, b) in walls.items()))
        out[f"20e {key} walls"] = walls
    return out


def phase_gang_k4(dev, card) -> list:
    """20c: K4 at a tp 2 rank's shape of the GQA config (B 8, 16/4 heads,
    hd 128, S 2048, generate's int length at row 1024, no bitmap), its
    split plan made for the rank's kv heads and for the model's (which
    the gang path passes), each held to its plain version, beside the
    bound and one SDPA call."""
    flush = _L2Flush(dev)
    rows = []
    for plan in ({}, {"plan_batch": GANG_B, "plan_kv_heads": 8}):
        c = flash_decode_case("gqa128 tp2 rank", GANG_B, 16, 4, 128, 2048,
                              False, None, dev, flush, plan=plan)
        if not c["ok"]:
            raise SystemExit(f"20c: K4 at a rank's shape (plan {plan}) "
                             f"disagrees with its plain version: {c}")
        c["plan"] = "model" if plan else "rank"
        log(f"  [{card}] 20c K4 at a rank's shape, the {c['plan']}'s "
            f"plan: {json.dumps(c)}")
        rows.append(c)
    return rows


def _gang_lines(argv, n, timeout=600.0):
    """``main(argv, backend="gloo")`` as the two workers of a gang (the
    gang env, both on card 0), until each prints ``n`` wave lines; then
    SIGTERM to both: ([lines, exit code, standard error] per worker).
    Every process is killed on any way out."""
    import queue
    import signal
    import threading

    import k8s_gpu_scheduler_tpu_torch as pkg

    root = os.path.dirname(os.path.dirname(os.path.abspath(pkg.__file__)))
    code = ("import sys; from k8s_gpu_scheduler_tpu_torch.models.llama "
            "import main; main(sys.argv[1:], backend='gloo')")
    procs, errs, outs = [], [], []
    for w in range(2):
        env = {**os.environ, "PYTHONPATH": root, "TPU_WORKER_ID": str(w),
               "TPU_WORKER_HOSTNAMES": "localhost,localhost"}
        env.pop("HOSTNAME", None)
        errs.append(tempfile.TemporaryFile(mode="w+"))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code, *argv], cwd=root, env=env,
            stdout=subprocess.PIPE, stderr=errs[-1], text=True))
        q: "queue.Queue" = queue.Queue()
        threading.Thread(target=lambda p=procs[-1], q=q: [
            q.put(ln) for ln in p.stdout] + [q.put(None)],
            daemon=True).start()
        outs.append(q)
    lines = [[], []]
    deadline = time.monotonic() + timeout
    try:
        for w in range(2):
            while sum(ln.startswith("llama serve qps=")
                      for ln in lines[w]) < n:
                try:
                    line = outs[w].get(timeout=max(
                        0.0, deadline - time.monotonic()))
                except queue.Empty:
                    break
                if line is None:
                    break
                log(f"    worker {w}: {line.rstrip()}")
                lines[w].append(line.strip())
        for p in procs:
            p.send_signal(signal.SIGTERM)
        codes = [p.wait(timeout=60) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    res = []
    for w in range(2):
        errs[w].seek(0)
        res.append((lines[w], codes[w], errs[w].read()))
        errs[w].close()
    return res


def phase_gang_main(dev, card) -> dict:
    """20d: ``main --serve`` (``GANG_MAIN_ARGV``) as a gang of two workers
    on the card, each printing JAX's multi-process wave line; the four
    flags its handler cannot honour refused before anything is
    allocated."""
    import re

    from k8s_gpu_scheduler_tpu_torch.models import llama

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)
    prev = os.environ.get("TPU_WORKER_HOSTNAMES")
    os.environ["TPU_WORKER_HOSTNAMES"] = "localhost,localhost"
    try:
        for flags in GANG_REFUSED:
            try:
                llama.main(["--serve", *flags], device=dev)
            except SystemExit as e:
                if e.code != GANG_REFUSAL:
                    raise SystemExit(f"20d {flags}: refused with "
                                     f"{e.code!r}") from None
            else:
                raise SystemExit(f"20d {flags}: not refused")
    finally:
        if prev is None:
            os.environ.pop("TPU_WORKER_HOSTNAMES")
        else:
            os.environ["TPU_WORKER_HOSTNAMES"] = prev
    if torch.cuda.memory_allocated(dev) != before:
        raise SystemExit("20d: a refused flag allocated on the card")
    log(f"  [{card}] 20d {len(GANG_REFUSED)} refused flags exit before "
        f"allocating: {GANG_REFUSAL!r}")
    t0 = time.perf_counter()
    res = _gang_lines(GANG_MAIN_ARGV, GANG_MAIN_WAVES)
    line = re.compile(r"^llama serve qps=([\d.]+) decode_tok_s=([\d.]+) "
                      r"prefill_tok=512 slo=[\d.]+$")
    out = {}
    for w, (lines, code, err) in enumerate(res):
        waves = [line.match(ln) for ln in lines
                 if ln.startswith("llama serve qps=")]
        # The SIGTERM reaches the two workers one after the other, so the
        # second may first see its peer's connection close: the exit code
        # is printed, not gated.
        if len(waves) != GANG_MAIN_WAVES or not all(
                m and float(m.group(1)) > 0 for m in waves):
            raise SystemExit(f"20d worker {w}: lines {lines}, exit {code}, "
                             f"stderr {err[-3000:]}")
        out[w] = [float(m.group(2)) for m in waves]
        log(f"  [{card}] 20d worker {w} exit {code} after SIGTERM")
    log(f"  [{card}] 20d main --serve, two workers of a gloo gang on the "
        f"card: decode tokens/s by worker {json.dumps(out)} in "
        f"{time.perf_counter() - t0:.1f} s")
    return out


def phase_gang_serving(dev, card) -> dict:
    """Phase 20 (see the module docstring)."""
    log(f"  cuts: 20c llama3_8b widths at {GANG_GQA_LAYERS} layers and "
        f"{GANG_GQA_NEW} new tokens; f32 runs (20e's int8 too) at "
        f"{GANG_F32_LAYERS} layers; 20e at {GANG_INT8_NEW} new tokens; no "
        f"width cut")
    torch.cuda.empty_cache()
    (one,) = yield World(gang_world_one, 1, "nccl", (), GANG_TIMEOUT)
    cfgs = gang_configs()
    for key in ("bf16", "f32"):
        a, b = one[key + " mesh"], one[key]
        check_gang_launches(f"20a {key}", a, cfgs[key], GANG_NEW)
        if a["streams"] != b["streams"] or a["launches"] != b["launches"]:
            raise SystemExit(f"20a {key}: the size-1 mesh's generate "
                             f"differs from mesh=None's")
        log(f"  [{card}] 20a {key}: size-1 mesh == mesh=None, "
            f"{len(b['streams'])} streams, launches "
            f"{b['launches']['flash_decode_attention']}, wall "
            f"{a['wall_s']:.3f} / {b['wall_s']:.3f} s")
    ranks = yield World(gang_world_two, 2, "gloo", (), GANG_TIMEOUT)
    out = phase_gang_streams(card, one, ranks, dev)
    out.update(phase_gang_int8(card, one, ranks, dev))
    out["20c k4"] = phase_gang_k4(dev, card)
    out["20d"] = phase_gang_main(dev, card)
    return out

# -- phase 21: graftcheck for the port on the card ----------------------------

# 21a: the rules the seeded fixtures of tests/data/graftcheck_torch/ carry.
GRAFT_FIXTURE_RULES = {
    "host-sync-in-dispatch", "host-time-in-dispatch", "numpy-in-dispatch",
    "trace-in-dispatch", "host-sync", "read-of-inplace-buffer",
    "smem-budget", "kernel-shape-unsupported", "shared-page-write",
    "storage-not-kept",
    # 22d: bad_ops.py, bad_traffic.py and bad_gspmd.py.
    "per-call-upload", "f32-upcast", "host-transfer", "dead-output",
    "dense-materialization", "traffic-contract", "peak-residency",
    "cache-spec-mismatch", "oversized-replicated", "island-weight-spec"}
GRAFT_FIXTURES = "tests/data/graftcheck_torch"
GRAFT_SYS = 384                 # 21c/21d: phase 3's system prompt
GRAFT_TRAIN_BT = (2, 512)       # 21d: the 2-layer train step's B, T
# 21d: the steady states at full width, each with the kernels its steady
# dispatches must launch (paged and speculative decode's K1 and K3, the
# contiguous engine's and generate's K4, the train step's K5-K7).
GRAFT_STEADY = {
    "batcher_steady_decode_paged": ("paged_decode_attention",),
    "batcher_steady_decode_paged_spec": ("paged_verify_attention",),
    "batcher_steady_decode": ("flash_decode_attention",),
    "generate_steady_state": ("flash_decode_attention",),
    "train_steady_state": FLASH}


def graft_cli_spawn(runs) -> subprocess.Popen:
    """Start the port's graftcheck CLI (its ``main``) on each argument list
    in ``runs``, one after another in one process of its own from the
    tree's root; ``graft_cli_wait`` reads it. The process is killed when
    the script exits before reading it."""
    import atexit

    root = os.path.dirname(os.path.abspath(__file__))
    code = (
        "import contextlib, io, json, time\n"
        "t0 = time.perf_counter()\n"
        "from k8s_gpu_scheduler_tpu_torch.analysis.__main__ import main\n"
        f"for args in {[list(r) for r in runs]!r}:\n"
        "    out, err = io.StringIO(), io.StringIO()\n"
        "    with contextlib.redirect_stdout(out), "
        "contextlib.redirect_stderr(err):\n"
        "        rc = main(['--json', *args])\n"
        "    print(json.dumps([rc, out.getvalue(), err.getvalue(), "
        "time.perf_counter() - t0]), flush=True)\n")
    # Files, not pipes: nothing reads the process until 21a, and a full
    # pipe would stop it.
    files = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=root,
                            stdout=files[0], stderr=files[1], text=True)
    proc.files = files
    atexit.register(proc.kill)
    return proc


def graft_cli_wait(proc, n_runs, timeout=600):
    """[(exit code, its JSON line, stderr)] of ``graft_cli_spawn``'s
    ``n_runs`` runs, and the process's own seconds for all of them."""
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise SystemExit(f"21a: the CLI's process took over {timeout} s")
    for f in proc.files:
        f.seek(0)
    stdout, stderr = (f.read() for f in proc.files)
    done = [json.loads(line) for line in stdout.splitlines()
            if line.startswith("[")]
    if len(done) != n_runs:
        raise SystemExit(f"21a: the CLI's process failed ({proc.returncode})"
                         f":\n{stderr[-4000:]}")
    return ([(rc, json.loads(out.splitlines()[0]) if out else {}, err)
             for rc, out, err, _ in done], done[-1][3])


def graft_size(dev, kv_dtype):
    """21c/21d's scenario size: the serve config at full width, weights
    drawn on the card once per config."""
    from k8s_gpu_scheduler_tpu_torch.analysis.entrypoints import ScenarioSize
    from k8s_gpu_scheduler_tpu_torch.models.llama import LlamaConfig

    cfg = dataclasses.replace(LlamaConfig.serve(), decode_attn="fused")
    models = {}

    def make_model(c, device):
        if c not in models:
            models.clear()           # one full-width model on the card
            models[c] = card_init(c, device)
        return models[c]

    return ScenarioSize(cfg=cfg, make_model=make_model, page_size=64,
                        sys_len=GRAFT_SYS, kv_dtype=kv_dtype, max_len=2048,
                        chunk=8, gamma=4, train_bt=GRAFT_TRAIN_BT)


_GRAFT_CLI: dict = {}
GRAFT_CLI_RUNS = ([], [GRAFT_FIXTURES])     # the tree, the seeded fixtures


def graft_cli_start() -> None:
    """Start the CLI over the tree and over the seeded fixtures once (21a
    and 22d read the same runs). ``main`` starts it before the rank
    worlds of phases 17-20, whose gloo transfers leave the card and most
    of the host's cores idle, so the CLI runs beside them."""
    if "proc" not in _GRAFT_CLI:
        _GRAFT_CLI["proc"] = graft_cli_spawn(GRAFT_CLI_RUNS)


def graft_cli_runs():
    """The CLI's runs (``graft_cli_start``), with the seconds its process
    took for them."""
    graft_cli_start()
    if "runs" not in _GRAFT_CLI:
        _GRAFT_CLI["runs"], _GRAFT_CLI["seconds"] = graft_cli_wait(
            _GRAFT_CLI["proc"], len(GRAFT_CLI_RUNS))
    return _GRAFT_CLI["runs"], _GRAFT_CLI["seconds"]


def phase_graft_cli(label="21a") -> None:
    """21a (22d): the CLI over the tree (every pass, the dynamic ones on
    the card) exits 0; over the seeded fixtures it exits 1 with every
    rule, the op, traffic and sharding audits' included."""
    ((code, doc, err), (bad, bad_doc, bad_err)), secs = graft_cli_runs()
    log(f"  {label} tree: exit {code}, pass seconds "
        f"{json.dumps(doc.get('pass_seconds'))}, notes "
        f"{json.dumps(doc.get('notes'))}")
    if code != 0:
        raise SystemExit(f"{label}: graftcheck over the tree exited {code}:"
                         f"\n{err[-4000:]}")
    rules = set(bad_doc.get("rules", ()))
    log(f"  {label} fixtures: exit {bad}, {bad_doc.get('n_findings')} "
        f"findings, rules {sorted(rules)}, pass seconds "
        f"{json.dumps(bad_doc.get('pass_seconds'))}; both in {secs:.1f} s")
    if bad != 1 or rules != GRAFT_FIXTURE_RULES:
        raise SystemExit(f"{label}: the fixtures gave exit {bad}, rules "
                         f"{sorted(rules)}; want exit 1 and "
                         f"{sorted(GRAFT_FIXTURE_RULES)}:\n"
                         f"{bad_err[-4000:]}")


def phase_graft_smem(card) -> list:
    """21b: every instantiation the presets reach — the .cu query equals
    the mirror, and with ptxas's static bytes and registers it fits a
    block; one line per instantiation."""
    from k8s_gpu_scheduler_tpu_torch.analysis import smem
    from k8s_gpu_scheduler_tpu_torch.ops import _build

    lib = _build.load_library()
    report = _build.ptxas_report()
    rows = []
    for e, how in smem.reached_entries().items():
        got = smem.lib_query(lib, e)
        res = smem.entry_resources(e, report)
        if got != e.dynamic_bytes:
            raise SystemExit(f"21b: {e.label}: the .cu query says {got} "
                             f"bytes, the mirror {e.dynamic_bytes}")
        if res.notes or res.registers is None:
            raise SystemExit(f"21b: {e.label}: no ptxas record")
        bad = smem.check_resources(e.label, res)
        if bad:
            raise SystemExit("21b: " + "; ".join(f.render() for f in bad))
        blocks = res.blocks_per_sm()
        rows.append(dict(
            kernel=e.kernel, instantiation=e.label, source=CSRC + e.source,
            dynamic_bytes=e.dynamic_bytes, static_bytes=res.static_bytes,
            registers=res.registers, spill_bytes=res.spill_bytes,
            threads=e.threads, blocks_per_sm=blocks,
            reached_by=sorted(set(how))))
    if smem.audit_smem(report):
        raise SystemExit("21b: audit_smem(report) found budget breaches")
    for r in sorted(rows, key=lambda r: (r["kernel"], r["instantiation"])):
        b = r["blocks_per_sm"]
        log(f"  21b {r['kernel']} {r['instantiation']}: dyn "
            f"{r['dynamic_bytes']} + static {r['static_bytes']} B, "
            f"{r['registers']} regs x {r['threads']}, spill "
            f"{r['spill_bytes']} B; blocks/SM smem {b['smem']} regs "
            f"{b['registers']} threads {b['threads']}; "
            f"{len(r['reached_by'])} paths ({card})")
    log(f"  21b: {len(rows)} instantiations, mirror == query, all within "
        f"232,448 B and 65,536 registers a block")
    return rows


def phase_graft_alias(dev, card) -> dict:
    """21c: every alias scenario at the serve config's full width, bf16
    and int8 KV, on phase 3's system prompt: shared pages byte-identical,
    K1/K2/K3 launched and no plain version; the seeded writer is caught on
    the card's tensors."""
    import importlib.util

    from k8s_gpu_scheduler_tpu_torch.analysis import entrypoints as eps
    from k8s_gpu_scheduler_tpu_torch.analysis.alias import (
        audit_shared_pages)
    from k8s_gpu_scheduler_tpu_torch.ops import decode_attention as da

    out = {}
    for kv in (None, "int8"):
        size = graft_size(dev, kv)
        for name, build in eps.alias_scenarios():
            da.reset_counters()
            t0 = time.perf_counter()
            found = audit_shared_pages(build, name, dev, size)
            torch.cuda.synchronize()
            c = da.counters()
            label = f"{name} ({kv or 'bf16'} KV)"
            out[label] = {k: c[k] for k in KERNELS if k in c}
            log(f"  21c {label}: {len(found)} findings, launches "
                f"{json.dumps(out[label])} in "
                f"{time.perf_counter() - t0:.1f} s")
            if found or any(c[p] for p in PLAIN):
                raise SystemExit(f"21c {label}: {[f.render() for f in found]}"
                                 f" plain calls {c}")
        total = {k: sum(v.get(k, 0) for lab, v in out.items()
                        if lab.endswith(f"({kv or 'bf16'} KV)"))
                 for k in ("paged_decode_attention",
                           "paged_prefill_attention",
                           "paged_verify_attention")}
        if not all(total.values()):
            raise SystemExit(f"21c ({kv or 'bf16'} KV): a kernel never "
                             f"launched: {total}")
    spec = importlib.util.spec_from_file_location(
        "bad_alias", os.path.join(os.path.dirname(os.path.abspath(
            __file__)), GRAFT_FIXTURES, "bad_alias.py"))
    bad = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bad)
    (name, build), = bad.GRAFTCHECK_TORCH_ALIAS_AUDIT
    caught = audit_shared_pages(build, name, dev, graft_size(dev, "int8"))
    log(f"  21c seeded writer on the card: "
        f"{sorted({f.rule for f in caught})} ({card})")
    if "shared-page-write" not in {f.rule for f in caught}:
        raise SystemExit(f"21c: the seeded writer was not caught: "
                         f"{[f.render() for f in caught]}")
    return out


def phase_graft_steady(dev, card) -> dict:
    """21d: three steady dispatches after warm-up per full-width steady
    state: storage kept, memory_allocated not growing, no rebuild and no
    first-use configuration, the state's kernels launched by its steady
    dispatches and no plain version called (gated); the host syncs of
    each dispatch and where they happen (printed)."""
    from collections import Counter

    from k8s_gpu_scheduler_tpu_torch.analysis import entrypoints as eps
    from k8s_gpu_scheduler_tpu_torch.analysis.steady import run_steady
    from k8s_gpu_scheduler_tpu_torch.ops import decode_attention as da
    from k8s_gpu_scheduler_tpu_torch.ops.flash_attention import (
        counters as flash_counters, reset_counters as reset_flash)

    scenarios = dict(eps.steady_scenarios())
    size = graft_size(dev, None)
    out = {}
    for name, kernels in GRAFT_STEADY.items():
        t0 = time.perf_counter()
        da.reset_counters()
        reset_flash()
        found, st = run_steady(scenarios[name], name, dev, size,
                               count_syncs=True)
        torch.cuda.synchronize()
        calls = {**da.counters(), **flash_counters()}
        plain = {k: calls[k] for k in PLAIN + FLASH_PLAIN if calls[k]}
        sites = Counter(st["sync_sites"])
        out[name] = dict(syncs=st["syncs"], allocated=st["allocated"],
                         tracked=len(st["tracked"]),
                         launches=st["launches"],
                         sites=dict(sites.most_common()))
        log(f"  21d {name}: {len(found)} findings; tracked "
            f"{len(st['tracked'])} tensors {st['tracked'][:6]}; allocated "
            f"{st['allocated']} B; steady launches "
            f"{json.dumps(st['launches'])}; host syncs a dispatch "
            f"{st['syncs']} at {json.dumps(dict(sites.most_common()))} in "
            f"{time.perf_counter() - t0:.1f} s ({card})")
        if found or not st["tracked"]:
            raise SystemExit(f"21d {name}: {[f.render() for f in found]}")
        if plain or not all(st["launches"].get(k) for k in kernels):
            raise SystemExit(f"21d {name}: steady launches "
                             f"{st['launches']}, want {list(kernels)} "
                             f"above 0; plain calls {plain}")
    return out


def phase_graftcheck(dev, card) -> dict:
    t0 = time.perf_counter()
    phase_graft_cli()
    t1 = time.perf_counter()
    rows = phase_graft_smem(card)
    t2 = time.perf_counter()
    alias = phase_graft_alias(dev, card)
    t3 = time.perf_counter()
    steady = phase_graft_steady(dev, card)
    t4 = time.perf_counter()
    log(f"  phase 21: 21a {t1 - t0:.1f} s, 21b {t2 - t1:.1f} s, 21c "
        f"{t3 - t2:.1f} s, 21d {t4 - t3:.1f} s")
    return dict(smem=rows, alias=alias, steady=steady)


# -- phase 22: the rest of graftcheck on the card -----------------------------

# 22b: the rows held at the serve config's full width, each with the
# kernel its record must launch.
GRAFT_FULL_ROWS = {"traffic_decode_chunk": "paged_decode_attention",
                   "traffic_verify_window": "paged_verify_attention",
                   "traffic_prefill_tb16_hb4_kernel":
                   "paged_prefill_attention"}


def graft_traffic_size(dev, kv_dtype):
    """22b's full width: the serve config (d 1024, 16/16 heads, hd 64,
    8 layers) at page 64, weights drawn on the card once; the scale dims
    (61 pages, S 1216, hit 256, tail 128, W 5, 3 slots) are distinct from
    every other dim in play."""
    from k8s_gpu_scheduler_tpu_torch.analysis.entrypoints import TrafficSize
    from k8s_gpu_scheduler_tpu_torch.models.llama import LlamaConfig

    cfg = dataclasses.replace(LlamaConfig.serve(), decode_attn="fused")
    models = {}

    def make_model(c, device):
        if c not in models:
            models[c] = card_init(c, device)
        return models[c]

    return TrafficSize(cfg=cfg, make_model=make_model, slots=3,
                       max_len=1216, n_pages=61, page_size=64, tb=128, hb=4,
                       gamma=4, kv_dtype=kv_dtype)


def phase_graft_ops(dev, card, errors) -> dict:
    """22a: every single-card op-audit entry on the card against the same
    entry on the CPU, op for op; uploads per dispatch printed."""
    from k8s_gpu_scheduler_tpu_torch.analysis import entrypoints as eps
    from k8s_gpu_scheduler_tpu_torch.analysis.opaudit import audit_entry
    from k8s_gpu_scheduler_tpu_torch.analysis.oprecord import (
        first_difference)

    cpu = torch.device("cpu")
    out = {}
    for name, entry in eps.op_entrypoints():
        if entry.world > 1:
            continue                     # on the world of two: 22c
        t0 = time.perf_counter()
        found, recs = audit_entry(entry, name, dev)
        t1 = time.perf_counter()
        _, cpu_recs = audit_entry(entry, name, cpu)
        diffs = [first_difference(a, b) for a, b in zip(recs, cpu_recs)]
        launched = recs[0].launched() if recs else {}
        ups = [(t.via, t.nbytes, t.site) for t in recs[0].uploads()] \
            if recs else []
        out[name] = dict(ops=[len(r.ops) for r in recs], launched=launched,
                         uploads=ups, card_s=t1 - t0)
        log(f"  22a {name}: {[len(r.ops) for r in recs]} ops, launched "
            f"{json.dumps(launched)}, {len(ups)} uploads "
            f"{sum(u[1] for u in ups)} B {json.dumps(ups)}; card "
            f"{t1 - t0:.2f} s ({card})")
        if found or not recs or any(diffs):
            errors.append(f"22a {name}: {[f.render() for f in found]} "
                          f"card vs CPU: {diffs}")
        if any(k.endswith("_reference") for k in launched) or (
                cpu_recs and cpu_recs[0].leaves() and not launched):
            errors.append(f"22a {name}: the card's leaves launched "
                          f"{launched}, want kernels and no plain version")
    return out


def phase_graft_traffic(dev, card, errors) -> dict:
    """22b: the single-card traffic rows at the audit geometry, then the
    decode, verify and prefix-prefill rows at full width in bf16 and int8
    KV: contracts met, K1-K3 launched inside the records."""
    from k8s_gpu_scheduler_tpu_torch.analysis import entrypoints as eps
    from k8s_gpu_scheduler_tpu_torch.analysis.traffic import (
        run_traffic_entry)

    out = {}
    runs = [("audit", name, entry) for name, entry in
            eps.traffic_entrypoints() if entry.world == 1]
    for kv in (None, "int8"):
        size = graft_traffic_size(dev, kv)
        runs += [(f"full {kv or 'bf16'}", name, entry) for name, entry in
                 eps.traffic_entrypoints(size) if name in GRAFT_FULL_ROWS]
    for where, name, entry in runs:
        t0 = time.perf_counter()
        found, st = run_traffic_entry(entry, name, dev)
        label = f"{name} ({where})"
        out[label] = st
        if "refused" in st:
            log(f"  22b {label}: refused by the port ({st['refused'][:60]})")
            continue
        log(f"  22b {label}: {len(found)} findings, {st.get('ops')} ops, "
            f"pool working set {st.get('pool_set')} B, peak pool-scale "
            f"allocated {st.get('peak_pool')} B, all allocated "
            f"{st.get('peak_all')} B, max_memory_allocated growth "
            f"{st.get('growth')} B, launched {json.dumps(st.get('launched'))}"
            f" in {time.perf_counter() - t0:.2f} s ({card})")
        launched = st.get("launched") or {}
        want = GRAFT_FULL_ROWS.get(name)
        if found or (want and not launched.get(want)) or any(
                k.endswith("_reference") for k in launched):
            errors.append(f"22b {label}: {[f.render() for f in found]} "
                          f"launched {launched}")
    return out


def phase_graft_world(card, errors) -> dict:
    """22c: the sharding audit, the _tp2 traffic rows, the pipeline's op
    audit and the tp steady states, as the CLI's tree run (21a's) ran them
    on its world of two gloo ranks sharing the card: each entry's stats
    by rank and its findings (warnings printed, errors gated)."""
    from k8s_gpu_scheduler_tpu_torch.analysis.world import world_jobs

    ((code, doc, _), _), _ = graft_cli_runs()
    stats = doc.get("stats", {})
    for kind, name, _ in world_jobs():
        key = f"{kind}:{name}"
        found = [f for f in doc.get("findings", ())
                 if f["path"] == f"<{kind}:{name}>"]
        brief = {r: {k: v for k, v in st.items()
                     if k in ("pool_set", "peak_pool", "growth", "launched",
                              "island", "ops", "tracked", "launches",
                              "allocated", "refused")}
                 for r, st in stats.get(key, {}).items()}
        log(f"  22c {kind} {name}: {len(found)} findings; "
            f"{json.dumps(brief, default=str)[:600]}")
        for f in found:
            log(f"    {f['severity']}: {f['rule']}: {f['message'][:400]}")
        if set(brief) != {"0", "1"} or any(
                f["severity"] == "error" for f in found):
            errors.append(f"22c {kind} {name}: ranks {sorted(brief)}, "
                          f"findings {found}")
        launched = [st.get("launched") or st.get("launches") or {}
                    for st in brief.values()]
        if any(k.endswith("_reference") for d in launched for k in d):
            errors.append(f"22c {kind} {name}: a plain version ran: "
                          f"{launched}")
    log(f"  22c: {len(world_jobs())} entries on two ranks in "
        f"{doc.get('pass_seconds', {}).get('world', 0):.1f} s ({card})")
    return {k: len(v) for k, v in stats.items()}


def phase_graft_rest(dev, card) -> dict:
    errors: list = []
    t0 = time.perf_counter()
    ops = phase_graft_ops(dev, card, errors)
    t1 = time.perf_counter()
    tr = phase_graft_traffic(dev, card, errors)
    t2 = time.perf_counter()
    phase_graft_cli("22d")              # the CLI's run, 21a's when it ran
    t3 = time.perf_counter()
    wd = phase_graft_world(card, errors)
    log(f"  phase 22: 22a {t1 - t0:.1f} s, 22b {t2 - t1:.1f} s, 22d + 22c "
        f"{t3 - t2:.1f} s")
    if errors:
        raise SystemExit("phase 22:\n" + "\n".join(errors))
    return dict(ops=ops, traffic=tr, world=wd)


# -- phase 23: the scheduler's control plane ------------------------------
# The control plane (api/, cluster/, sched/, plugins/, cmd/) is host code:
# 23a runs its entry point, 23b schedules bench.py's bench_mixed shape
# (bench.py:149) against the in-memory API server, and 23c hands a pod it
# placed on a shared partition to the serving entry point on the card.
SCHED_NODES = 1024              # 23b: bench_mixed's cluster and traffic
SCHED_SINGLES = 560
SCHED_GANGS = 30
SCHED_RATE = 150.0              # pods/s, Poisson, from a seeded generator
SCHED_SLICE = 4                 # hosts per slice group
SCHED_HOT = 2                   # hot-zone nodes, filled by the fillers
SCHED_RESHAPING = "v5e-37"      # mid-reshape the whole run
SCHED_TIMEOUT = 120.0           # seconds 23b may take to bind everything
SCHED_CHIP_MIX = (1, 2, 4, 8)
HANDOFF_SYS = 384               # 23c: the production engine's shared prefix


def host_cpu() -> str:
    """The host's CPU model and logical CPU count, for the host-clock
    numbers of phase 23: ``lscpu``'s model name, else the first model
    field of ``/proc/cpuinfo``, else the vendor and family numbers."""
    import platform

    fields = {}
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True,
                             timeout=10).stdout
        fields.update(ln.split(":", 1) for ln in out.splitlines()
                      if ":" in ln)
    except (OSError, subprocess.SubprocessError):
        pass
    try:
        with open("/proc/cpuinfo") as f:
            for ln in f:
                if ":" in ln:
                    k, v = ln.split(":", 1)
                    fields.setdefault(k.strip(), v)
    except OSError:
        pass
    fields = {k.strip(): v.strip() for k, v in fields.items()
              if v.strip() and v.strip().lower() not in ("unknown", "-")}
    name = next((fields[k] for k in ("Model name", "model name", "cpu model",
                                     "Hardware") if k in fields), None)
    if name is None:        # a host that hides the model name: its numbers
        name = " ".join(f"{k} {fields[k]}" for k in (
            "vendor_id", "cpu family", "model") if k in fields) \
            or platform.processor() or platform.machine()
    mhz = f", {fields['cpu MHz']} MHz" if "cpu MHz" in fields else ""
    return f"{name}{mhz}, {os.cpu_count()} logical CPUs"


def allocator_cap_matches(got: float, want: float, total: int) -> bool:
    """Whether the allocator's fraction ``got`` is the one ``want`` sets:
    the caching allocator keeps its cap as whole bytes,
    ``int(want * total)``, and reports that over ``total``, so the two
    fractions agree to the byte, not to the last bit."""
    return want is not None and round(got * total) == int(want * total)


def repo_root() -> str:
    """The checkout that holds the port's package (and ``tests/``)."""
    import k8s_gpu_scheduler_tpu_torch as pkg

    return os.path.dirname(os.path.dirname(os.path.abspath(pkg.__file__)))


def phase_sched_cli(card, cpu) -> dict:
    """23a: ``python -m k8s_gpu_scheduler_tpu_torch.cmd.scheduler --demo 8
    --once --metrics-port 0`` exits 0 with one ``scheduled`` line a pod
    (the CPU test holds the lines to the JAX module's)."""
    import re

    root = repo_root()
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "k8s_gpu_scheduler_tpu_torch.cmd.scheduler",
         "--demo", "8", "--once", "--metrics-port", "0"], cwd=root,
        env={**os.environ, "PYTHONPATH": root}, capture_output=True,
        text=True, timeout=120)
    wall = time.perf_counter() - t0
    lines = [m.group(0) for m in (re.search(r"scheduled \S+ -> \S+$", ln)
                                  for ln in proc.stderr.splitlines()) if m]
    want = [f"scheduled demo-{i} -> v5e-0" for i in range(8)]
    log(f"  23a exit {proc.returncode} in {wall:.2f} s ({card}; host "
        f"{cpu}): {json.dumps(lines)}")
    if proc.returncode != 0 or lines != want:
        raise SystemExit(f"23a: exit {proc.returncode}, lines {lines}\n"
                         f"{proc.stderr[-3000:]}")
    return dict(exit=proc.returncode, lines=lines, wall_s=wall)


class SchedRegistry:
    """In-memory registry: the node inventories the scheduler reads."""

    def __init__(self):
        self.data = {}

    def ping(self):
        return True

    def get(self, key):
        return self.data.get(key)

    def set(self, key, value):
        self.data[key] = value

    def get_keys(self, pattern="*"):
        return [k for k in self.data if k.startswith(pattern.rstrip("*"))]


def sched_node(o, name, index, chips=8, labels=None, annotations=None):
    return o.Node(
        metadata=o.ObjectMeta(name=name, labels={
            o.LABEL_TPU_ACCELERATOR: "tpu-v5-lite-podslice",
            o.LABEL_TPU_TOPOLOGY: "2x4", **(labels or {})},
            annotations=dict(annotations or {})),
        status=o.NodeStatus(capacity={o.TPU_RESOURCE: chips},
                            allocatable={o.TPU_RESOURCE: chips},
                            addresses=[f"10.0.{index // 250}.{index % 250}"]))


def sched_submit(o, server, name, chips, selector=None, priority=None,
                 group=None, owner=None, dns=None):
    """A pod and the ConfigMap its PostBind writes into (bench_mixed's
    ``submit``)."""
    server.create(o.ConfigMap(metadata=o.ObjectMeta(name=f"cm-{name}")))
    server.create(o.Pod(
        metadata=o.ObjectMeta(
            name=name, labels={o.LABEL_POD_GROUP: group} if group else {},
            annotations={"tpu.sched/priority": str(priority)}
            if priority else {},
            owner_references=[owner] if owner else []),
        spec=o.PodSpec(
            node_selector=selector or {},
            hostname=name if dns else "", subdomain=dns or "",
            containers=[o.Container(
                env_from=[o.ConfigMapRef(f"cm-{name}")],
                resources=o.ResourceRequirements(
                    requests={o.TPU_RESOURCE: chips}))])))


def phase_sched_mixed(card, cpu, n_nodes=SCHED_NODES,
                      n_single=SCHED_SINGLES, n_gangs=SCHED_GANGS,
                      rate=SCHED_RATE) -> dict:
    """23b: bench_mixed's run against the in-memory API server (its
    cluster built here, the storm by ``sched_storm``)."""
    from k8s_gpu_scheduler_tpu_torch.api import objects as o
    from k8s_gpu_scheduler_tpu_torch.cluster import APIServer

    server = APIServer()
    for i in range(n_nodes):
        labels = {o.LABEL_SLICE_GROUP: f"sg-{i // SCHED_SLICE}",
                  o.LABEL_WORKER_INDEX: str(i % SCHED_SLICE)}
        if i < SCHED_HOT:
            labels["zone"] = "hot"
        ann = ({o.ANN_RESHAPE_STATE: "applying"}
               if f"v5e-{i}" == SCHED_RESHAPING else {})
        server.create(sched_node(o, f"v5e-{i}", i, labels=labels,
                                 annotations=ann))
    return sched_storm("23b", card, cpu, server, n_nodes, n_single, n_gangs,
                       rate)


def sched_storm(label, card, cpu, server, n_nodes, n_single, n_gangs,
                rate) -> dict:
    """bench_mixed's storm against ``server`` (the in-memory API server
    for 23b, the REST adapter for 24a), whose nodes are already there:
    fillers saturate the hot zone, a Poisson storm of singletons and
    four-member gangs, then two higher-priority preemptors evict the
    fillers. Gates: every pod bound, zero-sum chip accounting, the cache
    agreeing with the API server's state (read through ``server``), the
    fillers gone, nothing on the reshaping node, every gang on one slice
    group."""
    from k8s_gpu_scheduler_tpu_torch.api import objects as o
    from k8s_gpu_scheduler_tpu_torch.config import SchedulerConfig
    from k8s_gpu_scheduler_tpu_torch.plugins import (
        GangPlugin, PreemptionPlugin, TPUPlugin)
    from k8s_gpu_scheduler_tpu_torch.registry.inventory import (
        NodeInventory, node_key)
    from k8s_gpu_scheduler_tpu_torch.sched import Profile, Scheduler

    reg = SchedRegistry()
    for i in range(n_nodes):
        reg.data[node_key(f"v5e-{i}")] = NodeInventory(
            node_name=f"v5e-{i}", utilization=(i % 10) / 10.0).to_json()
    # bench_mixed's operating point: 10 % node sampling at this fleet size.
    sched = Scheduler(server, profile=Profile(), config=SchedulerConfig(
        backoff_initial_s=0.05, backoff_max_s=0.5,
        percentage_of_nodes_to_score=10))
    tpu = TPUPlugin(sched.handle, registry=reg)
    gang = GangPlugin(sched.handle)
    sched.profile = Profile(
        pre_filter=[tpu, gang], filter=[tpu, gang], score=[tpu, gang],
        reserve=[tpu, gang], permit=[gang], post_bind=[tpu, gang],
        post_filter=[PreemptionPlugin(sched.handle,
                                      filter_plugins=[tpu, gang], tpu=tpu)])
    hist = sched.metrics.histogram("tpu_sched_e2e_duration_seconds")
    total = SCHED_HOT + n_single + 4 * n_gangs + SCHED_HOT
    sched.start()
    try:
        for i in range(SCHED_HOT):
            sched_submit(o, server, f"filler-{i}", 8, selector={"zone": "hot"},
                         owner="StatefulSet/fillers")
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and hist.count < SCHED_HOT:
            time.sleep(0.02)
        if hist.count != SCHED_HOT:
            raise SystemExit(f"{label}: fillers not placed ({hist.count})")
        rng = np.random.default_rng(0)
        events = [("single", i) for i in range(n_single)]
        for j, pos in enumerate(sorted(
                rng.choice(len(events), n_gangs, replace=False),
                reverse=True)):
            events.insert(pos, ("gang", j))
        t0 = time.perf_counter()
        arrival = 0.0
        for kind, idx in events:
            arrival += rng.exponential(1.0 / rate)
            lag = arrival - (time.perf_counter() - t0)
            if lag > 0:
                time.sleep(lag)
            if kind == "single":
                sched_submit(o, server, f"job-{idx}",
                             SCHED_CHIP_MIX[idx % 4])
            else:
                server.create(o.PodGroup(
                    metadata=o.ObjectMeta(name=f"gang-{idx}"), min_member=4,
                    schedule_timeout_s=60.0))
                for m in range(4):
                    sched_submit(o, server, f"gang-{idx}-{m}", 8,
                                 group=f"gang-{idx}")
        for i in range(SCHED_HOT):
            sched_submit(o, server, f"preemptor-{i}", 8,
                         selector={"zone": "hot"}, priority=100)
        deadline = time.monotonic() + SCHED_TIMEOUT
        while time.monotonic() < deadline and hist.count < total:
            time.sleep(0.05)
        wall = time.perf_counter() - t0
        bound = hist.count
    finally:
        sched.stop()
    pods = server.list("Pod")
    by_node, groups = {}, {}
    node_group = {n.metadata.name: n.metadata.labels[o.LABEL_SLICE_GROUP]
                  for n in server.list("Node")}
    for p in pods:
        if p.spec.node_name:
            by_node[p.spec.node_name] = (
                by_node.get(p.spec.node_name, 0) + p.spec.tpu_chips())
            if p.pod_group():
                groups.setdefault(p.pod_group(), set()).add(
                    node_group[p.spec.node_name])
    drift = [(name, by_node.get(name, 0), info.requested_tpu)
             for name, info in sched.cache.snapshot().items()
             if by_node.get(name, 0) != info.requested_tpu
             or info.requested_tpu != sum(p.spec.tpu_chips()
                                          for p in info.pods)]
    cyc = sched.metrics.histogram("tpu_sched_scheduling_cycle_seconds")
    st = dict(
        nodes=n_nodes, expected_binds=total, binds=bound,
        unbound=[p.metadata.name for p in pods if not p.spec.node_name],
        overcommitted=[n for n, c in by_node.items() if c > 8],
        fillers_left=[p.metadata.name for p in pods
                      if p.metadata.name.startswith("filler-")],
        reshaping_chips=by_node.get(SCHED_RESHAPING, 0),
        cache_drift=drift[:10],
        gangs_spanning=sorted(g for g, s in groups.items() if len(s) != 1),
        gangs=len(groups), wall_s=wall, pods_per_s=bound / wall,
        e2e_p50_ms=1e3 * (hist.quantile(0.5) or 0),
        e2e_p99_ms=1e3 * (hist.quantile(0.99) or 0),
        cycle_p50_ms=1e3 * (cyc.quantile(0.5) or 0),
        cycle_p99_ms=1e3 * (cyc.quantile(0.99) or 0))
    for cls in ("single", "gang", "preempting"):
        h = sched.metrics.histogram(
            f"tpu_sched_e2e_duration_seconds_class_{cls}")
        st[f"{cls}_binds"] = h.count
        st[f"{cls}_p50_ms"] = 1e3 * (h.quantile(0.5) or 0)
        st[f"{cls}_p99_ms"] = 1e3 * (h.quantile(0.99) or 0)
    log(f"  {label} ({card}; host {cpu}): {json.dumps(st)}")
    if (bound != total or st["unbound"] or st["overcommitted"]
            or st["fillers_left"] or st["reshaping_chips"] or drift
            or st["gangs_spanning"] or st["gangs"] != n_gangs):
        raise SystemExit(f"{label}: {json.dumps(st)}")
    return st


@contextlib.contextmanager
def injected_environment(env, dev):
    """A placed pod's injected ConfigMap as this process's environment,
    with ``DutyCycleThrottle.pace`` recording each sleep: yields the list
    of (percent, active s, slept s). Restores the environment, the pacer,
    the SIGTERM handler and the allocator's fraction."""
    import signal

    from k8s_gpu_scheduler_tpu_torch.utils import enforcement

    slept = []
    real_pace = enforcement.DutyCycleThrottle.pace

    def pace(self, active_s):
        s = real_pace(self, active_s)
        slept.append((self.pct, active_s, s))
        return s

    saved = {k: os.environ.get(k) for k in env}
    prev = signal.getsignal(signal.SIGTERM)
    enforcement.DutyCycleThrottle.pace = pace
    os.environ.update(env)
    try:
        yield slept
    finally:
        enforcement.DutyCycleThrottle.pace = real_pace
        signal.signal(signal.SIGTERM, prev)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        torch.cuda.set_per_process_memory_fraction(1.0, dev)
        torch.cuda.empty_cache()


def serve_one_wave(dev, card, env, label, slept) -> dict:
    """One wave of ``main --serve`` under ``injected_environment(env)``:
    gates the wave line, K1 launched with no plain call, the allocator's
    cap equal, to the byte, to ``enforcement.hbm_fraction`` of the injected
    limit, and the throttle slept."""
    from k8s_gpu_scheduler_tpu_torch.utils import enforcement

    total = torch.cuda.get_device_properties(dev).total_memory
    want = enforcement.hbm_fraction(env, total)
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    code, lines, c, _ = run_main(dev, ["--serve"], 1)
    got = torch.cuda.get_per_process_memory_fraction(0)
    waves = [ln for ln in lines if ln.startswith("llama serve qps=")]
    st = dict(exit=code, wave_lines=waves, launches=c, fraction=got,
              fraction_computed=want, total_memory=total,
              cap_bytes=got * total, computed_bytes=want * total,
              throttle=slept[:], wall_s=time.perf_counter() - t1)
    log(f"  {label} main --serve ({card}): {json.dumps(st)}")
    if code != 0 or len(waves) != 1 \
            or not allocator_cap_matches(got, want, total) \
            or not any(s > 0 for _, _, s in slept) \
            or c["paged_decode_attention"] <= 0 \
            or any(c[k] for k in PLAIN):
        raise SystemExit(f"{label} main --serve: {json.dumps(st)}")
    return st


def handoff_cluster():
    """23c's cluster, through the entry point a user calls
    (``cmd.scheduler.build_scheduler``): a v5e host carved into two 2x2
    partitions (``tpu.sched/slice.config``), a 4-chip serving pod that
    lands on one of them, and a four-host slice group for a StatefulSet
    gang of four. Returns every pod's node and ConfigMap data."""
    from k8s_gpu_scheduler_tpu_torch.api import objects as o
    from k8s_gpu_scheduler_tpu_torch.cluster import APIServer
    from k8s_gpu_scheduler_tpu_torch.cmd.scheduler import build_scheduler
    from k8s_gpu_scheduler_tpu_torch.config import SchedulerConfig

    server = APIServer()
    server.create(sched_node(o, "v5e-shared", 0, labels={"pool": "shared"},
                             annotations={o.ANN_SLICE_CONFIG: "2x2"}))
    for i in range(4):
        server.create(sched_node(o, f"v5e-gang-{i}", 1 + i, labels={
            o.LABEL_SLICE_GROUP: "sg-gang", o.LABEL_WORKER_INDEX: str(i)}))
    sched = build_scheduler(server, SchedulerConfig(
        backoff_initial_s=0.05, backoff_max_s=0.5, permit_timeout_s=30.0),
        allow_simulated_reshape=True)
    sched.start()
    try:
        sched_submit(o, server, "llama-serve-0", 4,
                     selector={"pool": "shared"})
        server.create(o.PodGroup(metadata=o.ObjectMeta(name="llama-gang"),
                                 min_member=4))
        for m in range(4):
            sched_submit(o, server, f"llama-gang-{m}", 8, group="llama-gang",
                         owner="StatefulSet/llama-gang", dns="llama-gang")
        deadline = time.monotonic() + 30
        while not all(p.spec.node_name for p in server.list("Pod")):
            if time.monotonic() > deadline:
                raise SystemExit("23c: the handoff cluster did not bind")
            time.sleep(0.02)
    finally:
        sched.stop()
        sched._reshaper.stop()
    return ({p.metadata.name: p.spec.node_name for p in server.list("Pod")},
            {c.metadata.name: dict(c.data) for c in server.list("ConfigMap")})


def phase_sched_handoff(dev, card, cpu) -> dict:
    """23c: the serving pod's injected ConfigMap as the environment of
    ``main --serve`` on the card (one wave): the serve line, K1 launched,
    the allocator's cap equal, to the byte, to ``enforcement.hbm_fraction``
    of the injected limit, and the throttle built from the injected duty share
    slept. ``main --serve`` builds JAX's engine (no prefix cache, whole
    prompts), whose prefills never take K2's path; so the same pod
    environment then serves one wave of shared-prefix requests on the
    production engine options (phase 3's: prefix cache, page 64), which
    launch K1 and K2. Every gang member's injected TPU_WORKER_ID and
    TPU_WORKER_HOSTNAMES parse through ``parallel/distributed.py`` to its
    rank and the gang's size."""
    import dataclasses

    from k8s_gpu_scheduler_tpu_torch.models.llama import (
        LlamaConfig, init_params)
    from k8s_gpu_scheduler_tpu_torch.models.serving import ContinuousBatcher
    from k8s_gpu_scheduler_tpu_torch.ops import decode_attention as da
    from k8s_gpu_scheduler_tpu_torch.parallel import distributed
    from k8s_gpu_scheduler_tpu_torch.utils import enforcement

    t0 = time.perf_counter()
    nodes, cms = handoff_cluster()
    t_sched = time.perf_counter() - t0
    env = cms["cm-llama-serve-0"]
    log(f"  23c scheduled in {t_sched:.2f} s ({card}; host {cpu}): "
        f"llama-serve-0 -> {nodes['llama-serve-0']}, injected "
        f"{json.dumps(env)}")
    if not {"TPU_HBM_LIMIT_BYTES", "TPU_DUTY_CYCLE_PERCENTAGE",
            "TPU_VISIBLE_CHIPS", "TPU_WORKER_ID"} <= set(env):
        raise SystemExit(f"23c: no sharing limits injected: {env}")
    ranks = []
    for m in range(4):
        data = cms[f"cm-llama-gang-{m}"]
        addrs = distributed.worker_addresses(data)
        me = distributed.self_worker_id(addrs, {"HOSTNAME": f"llama-gang-{m}"})
        ranks.append(me)
        log(f"    gang member {m} on {nodes[f'llama-gang-{m}']}: rank {me} "
            f"of {len(addrs)} (TPU_WORKER_ID {data.get('TPU_WORKER_ID')}, "
            f"TPU_WORKER_COUNT {data.get('TPU_WORKER_COUNT')})")
        if me != int(data["TPU_WORKER_ID"]) or len(addrs) != 4 or \
                int(data["TPU_WORKER_COUNT"]) != 4:
            raise SystemExit(f"23c: gang member {m}: {data}")
    if sorted(ranks) != [0, 1, 2, 3]:
        raise SystemExit(f"23c: gang ranks {ranks}")

    out = {}
    with injected_environment(env, dev) as slept:
        out["main"] = serve_one_wave(dev, card, env, "23c", slept)
        # The production engine's options under the same injected limits.
        want = out["main"]["fraction_computed"]
        total = out["main"]["total_memory"]
        torch.cuda.set_per_process_memory_fraction(1.0, dev)
        torch.cuda.empty_cache()
        slept.clear()
        throttle = enforcement.apply_env_limits(device=dev)
        cfg = dataclasses.replace(LlamaConfig.serve(), decode_attn="fused")
        model = init_params(cfg, torch.Generator().manual_seed(0), dev)
        rng = np.random.default_rng(23)
        prompts = shared_prefix_traffic(rng, cfg.vocab, 32, HANDOFF_SYS, 128)
        eng = ContinuousBatcher(model, cfg, n_slots=8, max_len=cfg.max_seq,
                                chunk=64, prefill_bucket=512,
                                kv_layout="paged", page_size=64,
                                prefix_cache=True, device=dev)
        drive(eng, prompts[:1], 64)                 # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        da.reset_counters()
        t2 = time.perf_counter()
        with throttle:
            streams = drive(eng, prompts, 64)
            torch.cuda.synchronize()
        c = da.counters()
        got = torch.cuda.get_per_process_memory_fraction(0)
        out["engine"] = st = dict(
            requests=len(prompts), launches=c, fraction=got,
            fraction_computed=want, throttle=slept[:],
            wall_s=time.perf_counter() - t2,
            peak_allocated=torch.cuda.max_memory_allocated(dev),
            malformed=malformed(streams, 64, cfg.vocab))
        log(f"  23c production engine ({card}): {json.dumps(st)}")
        if not allocator_cap_matches(got, want, total) \
                or c["paged_decode_attention"] <= 0 \
                or c["paged_prefill_attention"] <= 0 \
                or any(c[k] for k in PLAIN) or st["malformed"] \
                or not any(s > 0 for _, _, s in slept):
            raise SystemExit(f"23c production engine: {json.dumps(st)}")
        del eng, model
    out["gang_ranks"] = ranks
    out["injected"] = env
    return out


def phase_scheduler(dev, card) -> dict:
    cpu = host_cpu()
    t0 = time.perf_counter()
    cli = phase_sched_cli(card, cpu)
    t1 = time.perf_counter()
    mixed = phase_sched_mixed(card, cpu)
    t2 = time.perf_counter()
    handoff = phase_sched_handoff(dev, card, cpu)
    log(f"  phase 23: 23a {t1 - t0:.1f} s, 23b {t2 - t1:.1f} s, 23c "
        f"{time.perf_counter() - t2:.1f} s ({card}; host {cpu})")
    return dict(cli=cli, mixed=mixed, handoff=handoff)


# -- phase 24: the SLO-scored, in-cluster scheduler ------------------------
# The same control plane over the REST adapter (cluster/kubeapi.py) against
# tests/fakekube.py in a process of its own, as bench.py runs it: 24a is
# 23b's storm over HTTP, 24b two leader-elected replicas of build_scheduler
# with the recommender's gRPC server and a Prometheus stub as live
# sidecars, 24c the SLO pod's injected ConfigMap served on the card.
REST_LEASE_S = 3.0              # 24b: the replicas' lease (whole seconds:
#                                 the Lease carries it as an integer)
REST_TIMEOUT = 30.0             # 24b: seconds a wave or a takeover may take
REST_DUTY = {"v5e-0": 35.0, "v5e-1": 62.5}   # 24b: the stub's duty cycles


def start_fakekube(*args):
    """``tests/fakekube.py ARGS`` in a process of its own: (process, base
    URL). Run by its path, not as ``-m tests.fakekube``: a ``tests``
    package installed in site-packages shadows the repository's
    directory, which has no ``__init__.py``."""
    proc = subprocess.Popen(
        [sys.executable, os.path.join(repo_root(), "tests", "fakekube.py"),
         *args], cwd=repo_root(), stdout=subprocess.PIPE, text=True)
    line = proc.stdout.readline().strip()
    if not line.startswith("PORT "):
        stop_process(proc)
        raise SystemExit(f"24: fakekube did not start ({line!r})")
    return proc, f"http://127.0.0.1:{line.split()[1]}"


def stop_process(proc) -> None:
    proc.terminate()
    try:
        proc.wait(timeout=10)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()


def phase_rest_mixed(card, cpu, n_nodes=SCHED_NODES, n_single=SCHED_SINGLES,
                     n_gangs=SCHED_GANGS, rate=SCHED_RATE) -> dict:
    """24a: 23b's storm (``sched_storm``) over the REST adapter: the
    nodes come from fakekube (``--slice-size 4 --hot-nodes 2``), the
    reshaping node is marked through ``mutate``, and every list, watch,
    bind and PostBind patch is an HTTP round trip."""
    from k8s_gpu_scheduler_tpu_torch.api import objects as o
    from k8s_gpu_scheduler_tpu_torch.cluster.kubeapi import KubeAPIServer

    proc, url = start_fakekube("--nodes", str(n_nodes), "--slice-size",
                               str(SCHED_SLICE), "--hot-nodes", str(SCHED_HOT))
    try:
        server = KubeAPIServer(base_url=url)

        def mark(n):
            n.metadata.annotations[o.ANN_RESHAPE_STATE] = "applying"
        server.mutate("Node", SCHED_RESHAPING, "default", mark)
        return sched_storm("24a", card, cpu, server, n_nodes, n_single,
                           n_gangs, rate)
    finally:
        stop_process(proc)


class PromStub:
    """A Prometheus instant-query endpoint: ``/api/v1/query`` answers each
    of JAX's TPU series (``metrics.client.TPU_SERIES``) for the nodes in
    ``duty``, one sample a node, filtered by a ``node="..."`` matcher."""

    def __init__(self, duty):
        import threading
        import urllib.parse
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        from k8s_gpu_scheduler_tpu_torch.metrics.client import TPU_SERIES

        self.queries = []
        stub = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802
                url = urllib.parse.urlsplit(self.path)
                query = urllib.parse.parse_qs(url.query).get("query", [""])[0]
                stub.queries.append(query)
                series = query.split("{")[0]
                want = query.split('node="')[1].split('"')[0] \
                    if 'node="' in query else None
                result = [{"metric": {"__name__": series, "node": n,
                                      "device_id": "0"},
                           "value": [time.time(), str(v)]}
                          for n, v in sorted(duty.items())
                          if series in TPU_SERIES and want in (None, n)]
                body = json.dumps({"status": "success", "data": {
                    "resultType": "vector", "result": result}}).encode()
                code = 200 if url.path == "/api/v1/query" else 404
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):
                pass

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def closed_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def rest_replica(url, cfg, name):
    """One replica of ``cmd.scheduler.build_scheduler(...,
    leader_elect=True)`` with a REST adapter of its own. Two replicas in
    one process would share the elector's identity (host and pid), so
    each gets its name, and the lease is cut to ``REST_LEASE_S``; the
    elector reads these at run time. The recommender client's answers
    are counted."""
    from k8s_gpu_scheduler_tpu_torch.cluster.kubeapi import KubeAPIServer
    from k8s_gpu_scheduler_tpu_torch.cmd.scheduler import build_scheduler

    sched = build_scheduler(KubeAPIServer(base_url=url), cfg,
                            leader_elect=True)
    el = sched.elector
    el.identity = name
    el.lease_duration_s = REST_LEASE_S
    el.renew_period_s = REST_LEASE_S / 3.0
    el.retry_period_s = REST_LEASE_S / 5.0
    el.renew_deadline_s = 0.8 * REST_LEASE_S
    tpu = sched.profile.score[0]
    calls = []
    if tpu.recommender is not None:
        real = tpu.recommender.impute_configurations

        def counted(index):
            calls.append(index)
            return real(index)
        tpu.recommender.impute_configurations = counted
    return sched, tpu, calls


def rest_wait(what, fn, timeout=REST_TIMEOUT):
    deadline = time.monotonic() + timeout
    while not fn():
        if time.monotonic() > deadline:
            raise SystemExit(f"24b: {what} not within {timeout} s")
        time.sleep(0.01)


def phase_rest_replicas(card, cpu) -> dict:
    """24b: two leader-elected replicas on one fakekube schedule
    test_e2e's workload (a 2-member gang of 4-chip pods, then the
    ``llama3-8b-serve-0`` pod with SLO 5) on two v5e hosts carved 2x2,
    with the recommender's gRPC server and a Prometheus stub as live
    sidecars (no registry). The leader binds the gang and is stopped; the
    standby takes the lease and binds the SLO pod. The result holds the
    SLO pod's ConfigMap read back through ``KubeAPIServer.get``."""
    import shutil

    import grpc

    from k8s_gpu_scheduler_tpu_torch.api import objects as o
    from k8s_gpu_scheduler_tpu_torch.cluster.kubeapi import KubeAPIServer
    from k8s_gpu_scheduler_tpu_torch.config import SchedulerConfig
    from k8s_gpu_scheduler_tpu_torch.recommender import server as rserver

    log(f"  24b gRPC {grpc.__version__}: the recommender over the real wire")
    data = os.path.join(os.path.dirname(rserver.__file__), "data")
    tmp = tempfile.mkdtemp(prefix="recommender_")
    for name in ("configurations_train.tsv", "interference_train.tsv"):
        shutil.copy(os.path.join(data, name), tmp)
    rec = rserver.RecommenderServer(
        os.path.join(tmp, "configurations_train.tsv"),
        os.path.join(tmp, "interference_train.tsv"), port=0).start()
    prom = PromStub(REST_DUTY)
    proc, url = start_fakekube("--nodes", "2", "--slice-size", "2")
    replicas = []
    try:
        api = KubeAPIServer(base_url=url)
        for n in ("v5e-0", "v5e-1"):
            api.mutate("Node", n, "default", lambda node: node.metadata
                       .annotations.update({o.ANN_SLICE_CONFIG: "2x2"}))
        cfg = SchedulerConfig(backoff_initial_s=0.05, backoff_max_s=0.5,
                              permit_timeout_s=REST_TIMEOUT)
        cfg.registry.port = closed_port()           # no registry: degraded
        cfg.recommender.host, cfg.recommender.port = "127.0.0.1", rec.port
        cfg.metrics.url = prom.url
        replicas = [rest_replica(url, cfg, f"replica-{k}") for k in "ab"]
        (a, tpu_a, calls_a), (b, tpu_b, calls_b) = replicas
        if tpu_a.recommender is None or tpu_b.recommender is None \
                or tpu_a.prom is None:
            raise SystemExit("24b: a sidecar client was not built")
        a.start()
        if not a.elector.wait_until_leader(REST_TIMEOUT):
            raise SystemExit("24b: replica-a never led")
        b.start()
        api.create(o.PodGroup(metadata=o.ObjectMeta(name="gang"),
                              min_member=2, schedule_timeout_s=REST_TIMEOUT))
        for i in range(2):
            api.create(o.ConfigMap(metadata=o.ObjectMeta(name=f"cm-gang-{i}")))
            api.create(o.Pod(
                metadata=o.ObjectMeta(name=f"gang-{i}",
                                      labels={o.LABEL_POD_GROUP: "gang"}),
                spec=o.PodSpec(containers=[o.Container(
                    env_from=[o.ConfigMapRef(f"cm-gang-{i}")],
                    resources=o.ResourceRequirements(
                        requests={o.TPU_RESOURCE: 4}))])))
        rest_wait("the gang bound", lambda: all(
            api.get("Pod", f"gang-{i}").spec.node_name for i in range(2)))
        # Midway: stop the leader (a clean stop releases the lease).
        t0 = time.perf_counter()
        a.stop()
        a._reshaper.stop()
        rest_wait("the standby's takeover", b.elector.is_leader,
                  REST_LEASE_S)
        gap = time.perf_counter() - t0
        api.create(o.ConfigMap(metadata=o.ObjectMeta(name="cm-solo")))
        api.create(o.Pod(
            metadata=o.ObjectMeta(name="llama3-8b-serve-0"),
            spec=o.PodSpec(containers=[o.Container(
                env=[o.EnvVar("SLO", "5"),
                     o.EnvVar("WORKLOAD_NAME", "llama3_8b_serve")],
                env_from=[o.ConfigMapRef("cm-solo")],
                resources=o.ResourceRequirements(
                    requests={o.TPU_RESOURCE: 2}))])))
        rest_wait("the SLO pod bound", lambda: api.get(
            "Pod", "llama3-8b-serve-0").spec.node_name)
        rest_wait("the SLO pod's PostBind", lambda: "TPU_VISIBLE_CHIPS" in
                  api.get("ConfigMap", "cm-solo").data)
        b.stop()
        b._reshaper.stop()

        def count(s, metric, **labels):
            return s.metrics.counter(metric).value(**labels)
        binds = [count(s, "tpu_sched_attempts_total", result="scheduled")
                 for s, _, _ in replicas]
        pods = {p.metadata.name: p.spec.node_name for p in api.list("Pod")}
        cms = {c.metadata.name: dict(c.data) for c in api.list("ConfigMap")}
        lease = api.get("Lease", "tpu-scheduler")
        st = dict(
            pods=pods, binds=binds, failover_s=gap,
            lease=[lease.holder_identity, lease.lease_duration_s,
                   lease.lease_transitions],
            recommender_calls=[len(calls_a), len(calls_b)],
            slo_pod_scored="llama3-8b-serve-0" in calls_b,
            degraded=[count(s, "tpu_sched_score_degraded_total",
                            client="recommender") for s, _, _ in replicas],
            prom_queries=len(prom.queries), injected=cms)
        log(f"  24b ({card}; host {cpu}): {json.dumps(st)}")
        gang_env = [cms[f"cm-gang-{i}"] for i in range(2)]
        if binds != [2, 1] or not all(pods.values()) \
                or gap > REST_LEASE_S or not st["slo_pod_scored"] \
                or any(st["degraded"]) or not st["prom_queries"] \
                or not all("TPU_VISIBLE_CHIPS" in e for e in cms.values()) \
                or sorted(e.get("TPU_WORKER_ID") for e in gang_env) != \
                ["0", "1"] \
                or {e.get("TPU_WORKER_COUNT") for e in gang_env} != {"2"} \
                or len({e.get("TPU_WORKER_HOSTNAMES") for e in gang_env}) != 1:
            raise SystemExit(f"24b: {json.dumps(st)}")
        st["configmap"] = dict(api.get("ConfigMap", "cm-solo").data)
        return st
    finally:
        for s, _, _ in replicas:
            s.stop()
            s._reshaper.stop()
        stop_process(proc)
        rec.stop()
        prom.stop()
        shutil.rmtree(tmp, ignore_errors=True)


def phase_rest_handoff(dev, card, env) -> dict:
    """24c: the SLO pod's ConfigMap (read back through the REST adapter)
    as the environment of one wave of ``main --serve``."""
    if not {"TPU_HBM_LIMIT_BYTES", "TPU_DUTY_CYCLE_PERCENTAGE",
            "TPU_VISIBLE_CHIPS", "TPU_WORKER_ID"} <= set(env):
        raise SystemExit(f"24c: no sharing limits injected: {env}")
    with injected_environment(env, dev) as slept:
        return serve_one_wave(dev, card, env, "24c", slept)


def phase_rest_scheduler(dev, card, mixed=None) -> dict:
    """Phase 24; ``mixed``: 23b's result from this run (23b runs here when
    phase 23 did not)."""
    cpu = host_cpu()
    t0 = time.perf_counter()
    if mixed is None:
        mixed = phase_sched_mixed(card, cpu)
    t1 = time.perf_counter()
    rest = phase_rest_mixed(card, cpu)
    keys = ("pods_per_s", "e2e_p50_ms", "e2e_p99_ms", "cycle_p50_ms",
            "cycle_p99_ms")
    log(f"  24a over REST against 23b in memory ({card}; host {cpu}): "
        + json.dumps({k: [rest[k], mixed[k]] for k in keys}))
    t2 = time.perf_counter()
    replicas = phase_rest_replicas(card, cpu)
    t3 = time.perf_counter()
    handoff = phase_rest_handoff(dev, card, replicas["configmap"])
    log(f"  phase 24: 23b {t1 - t0:.1f} s, 24a {t2 - t1:.1f} s, 24b "
        f"{t3 - t2:.1f} s, 24c {time.perf_counter() - t3:.1f} s ({card}; "
        f"host {cpu})")
    return dict(mixed=rest, replicas=replicas, handoff=handoff)


# -- phase 25: the node agent -----------------------------------------------------

AGENT_NODES = 1024              # 25b: 23b's cluster size, this card's node one
AGENT_CARD_NODE = "h100-0"      # 25b: the node whose agent reads this card
AGENT_LOAD_S = 3.0              # 25a: seconds K5 loops at train-8b
AGENT_PROBE_AT_S = 1.0          # 25a, 25b: a probe this far into the load
AGENT_SETTLE_S = 2.0            # 25a, 25b: wait after the load (NVML's
#                                 sample window is 1/6 s to 1 s)
AGENT_BUSY = 0.5                # 25a: least duty cycle a probe under K5 reads
AGENT_TOUCH = 8 << 30           # 25a: bytes allocated, touched and freed
AGENT_MOVE = 15 << 29           # 25a: least move of hbm_used (7.5 GiB)
AGENT_MGET = 512                # 25b: list_inventories' keys an MGET
AGENT_THREADS = 8               # 25b: fake-file agents publishing at once
PROBER_ENV = ("TPUPROBE_BIN", "TPUPROBE_FAKE", "TPUPROBE_DEV_GLOB",
              "TPUPROBE_NVML_LIB")


@contextlib.contextmanager
def k5_busy(dev):
    """K5 (``flash_forward``, causal, bf16, at train-8b: B 8, T 2048,
    32/8 heads, hd 128) launched in a loop on a thread of its own while the
    block runs, synchronised every 16 launches, so the card is busy from
    the block's start and idle a few ms after its end."""
    import threading

    from k8s_gpu_scheduler_tpu_torch.ops.flash_attention import flash_forward

    gen = torch.Generator(dev).manual_seed(25)
    q = torch.randn((8, 2048, 32, 128), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    k, v = (torch.randn((8, 2048, 8, 128), generator=gen, device=dev,
                        dtype=torch.bfloat16) for _ in range(2))
    stop, errors = threading.Event(), []

    def loop():
        try:
            while not stop.is_set():
                for _ in range(16):
                    flash_forward(q, k, v, True, True)
                torch.cuda.synchronize(dev)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    th = threading.Thread(target=loop, name="k5-load", daemon=True)
    th.start()
    try:
        yield
    finally:
        stop.set()
        th.join(timeout=60)
        torch.cuda.synchronize(dev)
    if errors or th.is_alive():
        raise SystemExit(f"25: the K5 load failed: {errors or 'it hung'}")


def run_prober(exe, label, card) -> tuple:
    """One ``--once`` probe: (chips, exec ms). Fails on a non-zero exit."""
    t0 = time.perf_counter()
    proc = subprocess.run([str(exe), "--once"], capture_output=True,
                          text=True, timeout=30)
    ms = 1e3 * (time.perf_counter() - t0)
    log(f"  25a {label}: {proc.stdout.strip()} exit {proc.returncode} in "
        f"{ms:.3f} ms ({card})")
    if proc.returncode != 0:
        raise SystemExit(f"25a: the prober exited {proc.returncode}: "
                         f"{proc.stderr.strip()}")
    return json.loads(proc.stdout)["chips"], ms


def phase_agent_prober(dev, card) -> dict:
    """25a: the port's prober, with no fake file and no device glob, reads
    the node's cards through NVML. Gates: one chip a card (ids 0..n-1);
    each total within 1 MiB of nvidia-smi's and at least the card's total
    as CUDA reports it; the chips' ``hbm_used`` rising and falling by 7.5
    GiB around 8 GiB allocated, touched and freed; a probe 1 s into 3 s of
    counted K5 launches (no plain call) reading a duty cycle of at least
    0.5, and one 2 s after the load below it."""
    import gc

    from k8s_gpu_scheduler_tpu_torch.agent import _build
    from k8s_gpu_scheduler_tpu_torch.ops.flash_attention import (
        counters, reset_counters)

    t0 = time.perf_counter()
    exe = _build.build()
    log(f"  25a built {exe.name} in {time.perf_counter() - t0:.2f} s")
    n = torch.cuda.device_count()
    idle, ms = run_prober(exe, "idle", card)
    probe_ms = [ms]
    mib = [int(x) for x in subprocess.run(
        ["nvidia-smi", "--query-gpu=memory.total",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()]
    cuda_total = torch.cuda.mem_get_info(dev)[1]
    if [c["device_id"] for c in idle] != list(range(n)) or len(mib) != n:
        raise SystemExit(f"25a: {len(idle)} chips, {len(mib)} in nvidia-smi, "
                         f"{n} CUDA devices")
    for c, m in zip(idle, mib):
        if (abs(c["hbm_total"] - m * 1048576) > 1048576
                or c["hbm_total"] < cuda_total):
            raise SystemExit(f"25a: hbm_total {c['hbm_total']} against "
                             f"nvidia-smi {m} MiB, CUDA {cuda_total} B")

    def used(chips):
        return sum(c["hbm_used"] for c in chips)

    gc.collect()
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()       # so the 8 GiB are a fresh allocation
    base, ms = run_prober(exe, "before 8 GiB", card)
    probe_ms.append(ms)
    x = torch.empty(AGENT_TOUCH, dtype=torch.uint8, device=dev)
    x.fill_(1)
    torch.cuda.synchronize(dev)
    held, ms = run_prober(exe, "8 GiB held", card)
    probe_ms.append(ms)
    del x
    torch.cuda.empty_cache()
    torch.cuda.synchronize(dev)
    freed, ms = run_prober(exe, "8 GiB freed", card)
    probe_ms.append(ms)
    rise, fall = used(held) - used(base), used(held) - used(freed)

    reset_counters()
    with k5_busy(dev):
        t0 = time.perf_counter()
        time.sleep(AGENT_PROBE_AT_S)
        busy, ms = run_prober(exe, f"{AGENT_PROBE_AT_S:g} s into K5", card)
        probe_ms.append(ms)
        time.sleep(max(0.0, AGENT_LOAD_S - (time.perf_counter() - t0)))
    load_s = time.perf_counter() - t0
    c = counters()
    time.sleep(AGENT_SETTLE_S)
    after, ms = run_prober(exe, f"{AGENT_SETTLE_S:g} s after K5", card)
    probe_ms.append(ms)
    duty = max(ch["duty_cycle"] for ch in busy)
    duty_after = max(ch["duty_cycle"] for ch in after)
    st = dict(chips=n, hbm_total=[ch["hbm_total"] for ch in idle],
              nvidia_smi_mib=mib, cuda_total=cuda_total, used_rise=rise,
              used_fall=fall, duty_busy=duty, duty_after=duty_after,
              load_s=load_s, k5_launches=c["flash_forward"],
              plain_calls=c["flash_forward_reference"], probe_ms=probe_ms)
    log(f"  25a ({card}): {json.dumps(st)}")
    if (rise < AGENT_MOVE or fall < AGENT_MOVE or duty < AGENT_BUSY
            or not duty_after < duty or c["flash_forward"] == 0
            or c["flash_forward_reference"]):
        raise SystemExit(f"25a: {json.dumps(st)}")
    return st


def wait_listening(port, timeout=30.0) -> None:
    import socket

    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            socket.create_connection(("127.0.0.1", port), timeout=0.3).close()
            return
        except OSError:
            time.sleep(0.05)
    raise SystemExit(f"25b: nothing listens on :{port}")


def phase_agent_cluster(dev, card, cpu, probed) -> dict:
    """25b and 25c. 1,023 of the port's ``Publisher``s, each execing the
    port's prober on a fake file at utilization (i % 10) / 10 (23b's
    registry), 8 at a time, and one whose ``Scraper`` reads this card
    through NVML, published while K5 loops, all into one kvstored. Gates: one
    ``list_inventories`` returns all 1,024 (in MGETs of 512 keys); the
    card node's inventory is the chips its prober printed; every node has
    its heartbeat key; the port's ``TPUPlugin(registry=Client)`` scores
    every node at exactly 100·(1 − utilization), the card node below
    every node less busy than it; a publish after the load is a change
    and raises the card's score; the re-exporter's text parses back to
    the probed values. Then 25c (``phase_agent_tools``) against the same
    kvstored."""
    from concurrent.futures import ThreadPoolExecutor

    from k8s_gpu_scheduler_tpu_torch.agent import Publisher, Scraper, _build
    from k8s_gpu_scheduler_tpu_torch.agent.deviceplugin import (
        parse_prom_text)
    from k8s_gpu_scheduler_tpu_torch.api import objects as o
    from k8s_gpu_scheduler_tpu_torch.cluster import APIServer
    from k8s_gpu_scheduler_tpu_torch.config import SchedulerConfig
    from k8s_gpu_scheduler_tpu_torch.metrics.client import (
        HBM_TOTAL, HBM_USED, MXU_DUTY_CYCLE)
    from k8s_gpu_scheduler_tpu_torch.metrics.exporter import Registry
    from k8s_gpu_scheduler_tpu_torch.ops.flash_attention import (
        counters, reset_counters)
    from k8s_gpu_scheduler_tpu_torch.plugins import TPUPlugin
    from k8s_gpu_scheduler_tpu_torch.registry.client import Client
    from k8s_gpu_scheduler_tpu_torch.registry.inventory import (
        HEARTBEAT_SUFFIX, list_inventories, node_key, read_inventory)
    from k8s_gpu_scheduler_tpu_torch.sched import (
        CycleState, Profile, Scheduler)

    t_phase = time.perf_counter()
    card_node = AGENT_CARD_NODE
    names = [f"v5e-{i}" for i in range(AGENT_NODES - 1)] + [card_node]
    port = closed_port()
    kv = subprocess.Popen([str(_build.build_kvstored()), "--port", str(port),
                           "--requirepass", "pw"],
                          stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        wait_listening(port)
        reg = Client("127.0.0.1", port, password="pw")
        with tempfile.TemporaryDirectory() as tmp:
            fakes = []
            for level in range(10):
                path = os.path.join(tmp, f"duty-{level}.json")
                with open(path, "w") as f:
                    json.dump({"chips": [
                        {"device_id": i, "duty_cycle": level / 10.0,
                         "hbm_used": level << 30, "hbm_total": 16 << 30}
                        for i in range(8)]}, f)
                fakes.append(path)
            def publish(i):          # one fake-file agent: its publish ms
                pub = Publisher(reg, scraper=Scraper(fake_file=fakes[i % 10]),
                                node_name=names[i],
                                accelerator="tpu-v5-lite-podslice",
                                topology="2x4")
                t0 = time.perf_counter()
                if not pub.publish_once(force=True):
                    raise SystemExit(f"25b: {names[i]} did not publish")
                return 1e3 * (time.perf_counter() - t0)
            with ThreadPoolExecutor(AGENT_THREADS) as pool:
                publish_ms = list(pool.map(publish, range(AGENT_NODES - 1)))
        scraper, printed = Scraper(), []
        probe = scraper.scrape

        def scrape():              # keeps what each probe printed, parsed
            chips = probe()
            printed.append([dataclasses.asdict(c) for c in chips])
            return chips
        scraper.scrape = scrape
        metrics = Registry()
        card_pub = Publisher(reg, scraper=scraper, node_name=card_node,
                             accelerator=torch.cuda.get_device_name(dev),
                             metrics_registry=metrics)
        reset_counters()
        with k5_busy(dev):
            time.sleep(AGENT_PROBE_AT_S)
            t0 = time.perf_counter()
            if not card_pub.publish_once(force=True):
                raise SystemExit("25b: the card's node did not publish")
            publish_ms.append(1e3 * (time.perf_counter() - t0))
        load = counters()

        mgets, real_mget = [], reg.mget
        reg.mget = lambda *keys: mgets.append(len(keys)) or real_mget(*keys)
        t0 = time.perf_counter()
        invs = list_inventories(reg)
        list_ms = 1e3 * (time.perf_counter() - t0)
        del reg.mget
        keys = set(reg.get_keys("node/*"))
        no_heartbeat = [n for n in names
                        if node_key(n) + HEARTBEAT_SUFFIX not in keys]
        busy_inv = invs.get(card_node)
        if (sorted(invs) != sorted(names) or no_heartbeat
                or mgets != [AGENT_MGET] * (AGENT_NODES // AGENT_MGET)
                or busy_inv is None
                or [dataclasses.asdict(c) for c in busy_inv.chips]
                != printed[-1]
                or load["flash_forward"] == 0
                or load["flash_forward_reference"]):
            raise SystemExit(f"25b: {len(invs)} inventories, MGETs {mgets}, "
                             f"no heartbeat {no_heartbeat[:5]}, card "
                             f"{busy_inv} against {printed}, K5 {load}")

        sched = Scheduler(APIServer(), profile=Profile(),
                          config=SchedulerConfig())
        for i, name in enumerate(names):
            sched.cache.add_node(sched_node(o, name, i))
        plugin = TPUPlugin(sched.handle, registry=reg)
        pod = o.Pod(metadata=o.ObjectMeta(name="agent-probe"),
                    spec=o.PodSpec(containers=[o.Container(
                        resources=o.ResourceRequirements(
                            requests={o.TPU_RESOURCE: 1}))]))

        def scores(nodes):
            state = CycleState()
            plugin.pre_filter(state, pod)
            return {n: plugin.score(state, pod, n)[0] for n in nodes}

        def expected(inv):
            return 100.0 * (1.0 - max(0.0, min(1.0, inv.utilization)))
        t0 = time.perf_counter()
        busy = scores(names)
        score_ms = 1e3 * (time.perf_counter() - t0)
        off = [n for n in names if busy[n] != expected(invs[n])]
        u_card = busy_inv.utilization
        not_above = [n for n in names if invs[n].utilization < u_card
                     and not busy[n] > busy[card_node]]
        below = sum(invs[n].utilization < u_card for n in names)
        time.sleep(AGENT_SETTLE_S)
        changed = card_pub.publish_once()
        idle_inv = read_inventory(reg, card_node)
        idle_score = scores([card_node])[card_node]
        samples = {(name, lab.get("node"), lab.get("device_id")): v
                   for name, lab, v in parse_prom_text(metrics.expose())}
        exported = [tuple(samples.get((series, card_node,
                                       str(c["device_id"])))
                          for series in (MXU_DUTY_CYCLE, HBM_USED, HBM_TOTAL))
                    for c in printed[-1]]
        probed_vals = [(round(100.0 * c["duty_cycle"], 3),
                        float(c["hbm_used_bytes"]),
                        float(c["hbm_total_bytes"])) for c in printed[-1]]
        st = dict(
            nodes=len(invs), mget_keys=mgets, publish_p50_ms=float(
                np.percentile(publish_ms, 50)),
            publish_p99_ms=float(np.percentile(publish_ms, 99)),
            card_publish_ms=publish_ms[-1], list_ms=list_ms,
            score_1024_ms=score_ms, k5_launches=load["flash_forward"],
            card_busy_utilization=u_card, card_busy_score=busy[card_node],
            nodes_less_busy=below, scored_off=off[:5],
            not_above_card=not_above[:5], changed_after_load=changed,
            card_idle_utilization=idle_inv.utilization,
            card_idle_score=idle_score, reexported=exported)
        log(f"  25b ({card}; host {cpu}): {json.dumps(st)}")
        if (off or not_above or not changed
                or not idle_score > busy[card_node]
                or idle_score != expected(idle_inv)
                or exported != probed_vals):
            raise SystemExit(f"25b: {json.dumps(st)}")
        t_tools = time.perf_counter()
        st["tools"] = phase_agent_tools(card, port, probed,
                                        reg.get(node_key(card_node)))
        st["b_s"] = t_tools - t_phase
        st["c_s"] = time.perf_counter() - t_tools
        return st
    finally:
        stop_process(kv)


def phase_agent_tools(card, port, probed, card_value) -> dict:
    """25c: the metrics logger (3 samples, 0.2 s apart) and ``registryctl
    --get`` of the card's node, each run by module name from the
    repository's root as an operator would, in parallel."""
    from k8s_gpu_scheduler_tpu_torch.agent.metrics_logger import COLUMNS

    root = repo_root()
    out = os.path.join(root, "build", "agent", f"metrics-{os.getpid()}.tsv")
    env = {**os.environ, "PYTHONPATH": root}
    argvs = [["k8s_gpu_scheduler_tpu_torch.agent.metrics_logger",
              "--samples", "3", "--interval", "0.2", "-o", out],
             ["k8s_gpu_scheduler_tpu_torch.registry.ctl", "--host",
              "127.0.0.1", "--port", str(port), "--password", "pw", "--get",
              f"node/{AGENT_CARD_NODE}"]]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-m", *a], cwd=root, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for a in argvs]
    (lo, le), (co, ce) = (p.communicate(timeout=120) for p in procs)
    wall = time.perf_counter() - t0
    rows = []
    if os.path.exists(out):
        with open(out) as f:
            rows = [ln.split("\t") for ln in f.read().splitlines()]
        os.remove(out)
    totals = dict(enumerate(probed["hbm_total"]))   # 25a's, by device id
    bad_rows = [r for r in rows[1:] if len(r) != len(COLUMNS)
                or int(r[4]) != totals.get(int(r[1]))]
    st = dict(logger_exit=procs[0].returncode, logger_line=lo.strip(),
              tsv_rows=len(rows), ctl_exit=procs[1].returncode,
              ctl_is_inventory=co.strip() == card_value, wall_s=wall)
    log(f"  25c ({card}): {json.dumps(st)}")
    if (procs[0].returncode or procs[1].returncode
            or rows[:1] != [list(COLUMNS)]
            or len(rows) != 1 + 3 * probed["chips"] or bad_rows
            or co.strip() != card_value):
        raise SystemExit(f"25c: {json.dumps(st)} {bad_rows[:3]}\n"
                         f"{le[-2000:]}\n{ce[-2000:]}")
    return st


def phase_agent(dev, card) -> dict:
    """Phase 25: 25a, then 25b and 25c."""
    for var in PROBER_ENV:             # the prober reads the card itself
        os.environ.pop(var, None)
    t0 = time.perf_counter()
    probed = phase_agent_prober(dev, card)
    t1 = time.perf_counter()
    cluster = phase_agent_cluster(dev, card, host_cpu(), probed)
    log(f"  phase 25: 25a {t1 - t0:.1f} s, 25b {cluster['b_s']:.1f} s, 25c "
        f"{cluster['c_s']:.1f} s ({card})")
    return dict(prober=probed, cluster=cluster)


def main() -> int:
    t_start = time.perf_counter()
    args = sys.argv[1:]

    def phase(text):
        log(f"[{time.perf_counter() - t_start:.0f} s] {text}")

    def value(flag, default=None):
        return args[args.index(flag) + 1] if flag in args else default

    profile_too = "--profile" in args
    train_layers = int(value("--train-layers", 4))
    chosen = value("--phases")
    chosen = None if chosen is None else {int(p) for p in chosen.split(",")}

    def run(*numbers):
        """Whether a phase (or a group, by its numbers) runs: every one
        without ``--phases``."""
        return chosen is None or bool(chosen.intersection(numbers))

    if "--package-root" in args:        # another tree's package (--parent)
        sys.path.insert(0, value("--package-root"))
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    from k8s_gpu_scheduler_tpu_torch.ops import _build

    dev = torch.device("cuda", 0)
    if "--launch-counts" in args:
        print(json.dumps(dispatch_launches(dev)), flush=True)
        return 0
    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 matmuls
    torch.backends.cudnn.allow_tf32 = False
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    card = smi.splitlines()[0]
    t0 = time.perf_counter()
    _build.build()
    _build.load_library()
    phase(f"phase 0: built {_build.library_path().name} in "
        f"{time.perf_counter() - t0:.1f} s on {card}")
    for r in _build.ptxas_report():
        log(f"  ptxas {r['registers']} regs, {r['smem_bytes']} B smem, "
            f"spill {r['spill_stores']}/{r['spill_loads']} B: {r['kernel']}")
    hmma = sass_counts(_build.library_path(), "HMMA")
    for name, n in hmma.items():
        log(f"  sass {n} HMMA: {name}")
    this_tree = "--package-root" not in args
    if hmma and this_tree:           # cuobjdump exists: every mma kernel
        for words in TENSOR_CORE_KERNELS:     # must use the tensor cores
            if not any(all(w in name for w in words) for name in hmma):
                raise SystemExit(f"no HMMA instruction in {words}")
    phase("phase 1: kernels against their plain versions "
        "(atol = rtol = 2e-2 in bf16, 2e-5 for K5's f32 lse)")
    cases = phase_kernels(dev, this_tree)
    if "--kernels-only" in args:
        log(json.dumps({"card": card, "kernel_cases": cases}))
        return 0
    if run(2):
        phase("phase 2: engines on the card against the engines on the "
              "CPU (f32, TF32 off)")
        e2 = phase_engine_vs_cpu(dev)
        log(f"  identical greedy streams: {json.dumps(e2)}")
        log(f"  contiguous path, identical greedy streams: "
            f"{json.dumps(phase_contiguous_vs_cpu(dev))}")
    if run(3):
        phase("phase 3: full-width serve config, bf16")
        full = phase_full_width(dev, card)
    if run(4):
        phase("phase 4: full-width speculative path, bf16")
        spec = phase_speculative(dev, card)
    if profile_too:
        log("profile: where a serving run's device time goes")
        phase_profile(dev, card)
        log("profile: CUDA kernels a paged dispatch launches per layer per "
            "decode tick and per verify")
        phase_dispatch_launches(dev, value("--parent"))
    if run(5):
        phase("phase 5: training on the card against training on the CPU "
              "(f32, TF32 off)")
        log(f"  {json.dumps(phase_train_vs_cpu(dev))}")
    if run(6):
        phase(f"phase 6: full-width training path (llama3_8b widths, "
              f"{train_layers} layers), bf16")
        train = phase_train_full_width(dev, card, profile_too, train_layers)
    if run(7):
        phase("phase 7: full-width contiguous path, bf16")
        contig = phase_contiguous_full_width(dev, card, profile_too)
    if run(8):
        phase("phase 8: the serving lifecycle and the KV tier")
        log("  (a) drain, persist and resume on the card against the CPU's "
            "undrained run (f32, TF32 off)")
        log(f"  {json.dumps(phase_lifecycle_vs_cpu(dev))}")
        log("  (b) full-width drain and restore into another pool, bf16")
        phase_drain_restore_full_width(dev, card)
        log("  (c) full-width tiering: waves A, B, C, bf16")
        phase_tiering_full_width(dev, card)
    if run(9):
        phase("phase 9: observability at full width: traced against "
              "untraced, bf16")
        phase_observability(dev, card)
    if run(10, 11, 12):
        phase("phases 10-12: the entry point, the fleet, crash and "
              "disaggregation")
        phases_10_to_12(dev, card)
    if run(13, 14, 15, 16):
        phase("phases 13-16: MoE, BERT-base, ResNet-50")
        phases_13_to_16(dev, card, profile_too)
    worlds = {}
    if run(17):
        log("phase 17: tensor-parallel paged serving, tp=1 on an NCCL world "
            "of one, tp=2 on a gloo world of two ranks sharing the card")
        worlds["17"] = phase_tensor_parallel(dev, card)
    if run(18):
        log("phase 18: sharded training at llama3_8b's widths (4 layers): "
            "18a a size-1 mesh on an NCCL world of one, 18b-d tp 2, fsdp 2, "
            "sp 2 and the sharded checkpoint on a gloo world of two ranks "
            "sharing the card")
        worlds["18"] = phase_sharded_training(dev, card)
    if run(19):
        log("phase 19: pipeline stages (GPipe, 1F1B) and MoE over ep at "
            "llama3_8b's and Mixtral's widths, and training checkpoints "
            "restored across meshes: 19a an NCCL world of one, 19b-e a gloo "
            "world of two ranks sharing the card")
        worlds["19"] = phase_pipeline_ep_restore(dev, card)
    if run(20):
        log("phase 20: gang serving (generate on a mesh, main --serve on a "
            "gang): 20a an NCCL world of one, 20b-c a gloo world of two "
            "ranks sharing the card, 20d two gang workers on the card, 20e "
            "int8 weights in 20a's and 20b's worlds")
        worlds["20"] = phase_gang_serving(dev, card)
    if run(21, 22):
        graft_cli_start()               # beside the rank worlds
    if worlds:
        phase(f"phases {', '.join(worlds)}: their NCCL worlds of one as one "
              f"world, then their gloo worlds of two as one")
        run_in_worlds(card, worlds)
    if run(18):
        phase("phase 18e: K5-K7 at a rank's shapes")
        phase_rank_flash_kernels(dev, card)
    if run(21):
        phase("phase 21: graftcheck for the port on the card: 21a the CLI "
              "(tree and seeded fixtures), 21b shared memory and registers "
              "of every instantiation, 21c shared pages at full width, 21d "
              "steady state at full width")
        phase_graftcheck(dev, card)
    if run(22):
        phase("phase 22: the rest of graftcheck on the card: 22a the op "
              "audit (card records against the CPU's), 22b traffic "
              "contracts (audit geometry and full width), 22c sharding "
              "audit and tp steady states on two ranks, 22d the CLI on the "
              "seeded fixtures")
        phase_graft_rest(dev, card)
    sched = {}
    if run(23):
        phase("phase 23: the scheduler's control plane: 23a the entry "
              "point, 23b bench_mixed's 1,024 nodes in memory, 23c a placed "
              "pod's injected environment served on the card")
        sched = phase_scheduler(dev, card)
    if run(24):
        phase("phase 24: the SLO-scored, in-cluster scheduler over REST: 24a "
              "bench_mixed's 1,024 nodes against fakekube, 24b two "
              "leader-elected replicas with the recommender and Prometheus "
              "sidecars, 24c the SLO pod's environment served on the card")
        phase_rest_scheduler(dev, card, sched.get("mixed"))
    if run(25):
        phase("phase 25: the node agent: 25a the port's prober reads the "
              "card through NVML under K5, 25b 1,024 agents publish into "
              "kvstored and the scheduler scores the card's node on its "
              "own duty cycle, 25c the metrics logger and registryctl")
        phase_agent(dev, card)
    if chosen is not None:
        log(json.dumps({"card": card, "kernel_cases": cases}))
        log(f"chip_smoke: phases {sorted(chosen)} in "
            f"{time.perf_counter() - t_start:.1f} s")
        log(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    # Each kernel's launches come from the run of the path that runs it:
    # K1 and K2 from phase 3's main path, K3 from phase 4's, K4 from phase
    # 7's serve-loop run, K5-K7 from phase 6's timed steps.
    launches = dict(full["bf16"]["launches"])
    launches["paged_verify_attention"] = \
        spec["spec"]["launches"]["paged_verify_attention"]
    launches["flash_decode_attention"] = \
        contig["bf16"]["launches"]["flash_decode_attention"]
    launches.update({k: train["launches"][k] for k in FLASH})
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        case = "train-8b" if name in FLASH else "serve-bf16"
        c = next(c for c in cases
                 if c["kernel"] == name and c["case"] == case)
        kernels.append(dict(
            name=name, route="cuda", source=CSRC + source, replaces=replaces,
            launches=launches[name], max_abs_err=c["max_abs_err"],
            ms=c["ms"], plain_ms=c["plain_ms"], bound_ms=c["bound_ms"],
            bound_by=c["bound_by"], library_ms=c["library_ms"]))
    log(json.dumps({"card": card, "kernel_cases": cases}))
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
