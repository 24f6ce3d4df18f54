#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one CUDA card.

    python3 chip_smoke.py          # from the root of a checkout

Phases, in order; any failure raises and the script exits non-zero:
  0. the device, and `nvidia-smi --query-gpu=name,power.limit`;
  1. build the seven hand-written kernels from src/repro_torch/csrc with
     nvcc (one process per source, started together) into
     build/repro_torch/; K1's ptxas report per instance, its launch plan at
     the predict shape and at d=96, and its SASS instructions per output
     (cuobjdump -sass); K5's SASS instructions per word; count K4's
     tensor-core instructions in its SASS (both HMMA kinds must be there)
     and print its launch plans; K7's ptxas report (registers, spills),
     shared memory and blocks per SM per instance, none may spill, and its
     SASS must hold K7_HMMA;
  2. each kernel against its plain PyTorch version on the card, on inputs
     from seeded torch.Generators, at the main paths' shapes and at ragged
     ones, each error printed beside its tolerance; K1 with both store
     instances (TMA bulk, 4-byte), two calls giving the same bits, and its
     cosine against cosf on every fp32 value; K2 with both staging
     instances (bulk copies, 4-byte cp.async), its resid_sq output, and two
     calls on the same inputs giving the same bits; K3 with its launch plan
     and ptxas report per instance, at the path's shape with one tensor as
     both neighbours (the path's call; the same bits as two distinct
     tensors) and at ragged, wide, misaligned and many-agent shapes, each
     xi_sq bitwise the CPU emulation of the kernel's order and two calls
     bitwise equal; K4 (flash attention) over lengths, masks, head groups,
     both layouts, head dims and dtypes; K5 (threefry) bitwise its plain
     version, uniform and random_bits, one key and 8 keys, at n = 20, 512,
     81 920 and ragged sizes, one launch per draw, and jax's pinned words;
  3. small fits on the card against the same fits on the CPU (the plain
     versions): the megakernel path, the spmd backend and the fused
     fallback on a logistic problem; comms and bits equal, theta close;
  4. the megakernel path at full width: the paper's Sec. 5.1 synthetic
     setup with N=20 agents on a ring, 5000 samples per agent (3500 train,
     1500 test), D=4096 random features, backend="fused",
     primal="gradient", 50 iterations of COKE and of DKLA, then to_model()
     and predict / evaluate on the held-out rows. K2 must run on every
     iteration, K1 on predict, K3 never; the train MSE comes from K2's
     residuals, with one more Phi read per chunk (counted);
  5. the fused fallback at full width: the same features (no second copy)
     with +-1 labels on the logistic loss, backend="fused", primal="auto"
     (the gradient primal on this loss), 50 iterations of COKE and of
     DKLA, then predict. K3 must run exactly once per iteration, K2 never;
  6. the spmd backend at full width on phase 4's problem: COKE, DKLA and
     CTA, 50 iterations each; comms and bits equal phase 4's, theta close;
     then COKE and DKLA on phase 5's logistic problem, whose comms and bits
     equal phase 5's and theta is close (spmd forms g_aug by K3's plain
     formula); no kernel of the fit path runs;
  7. times from CUDA events (median of several runs after warm-up), each
     with the card's name and power limit: K2's ptxas report per instance
     and its launch plan; a megakernel
     iteration (chunks of ten) split into K2, the chunk's one train-MSE
     read of Phi per ten iterations and the rest; a fused-logistic
     iteration split into the local gradients, K3, the metric and the
     rest; an spmd iteration; each of these also as the host's time to
     enqueue it, from the same window; each kernel beside its bound and
     its plain version; K1 beside its earlier design's time and a write-
     floor probe (out.fill_ over the same output); K3 at the path's shape
     (CUDA-graph replay, the kernel alone by the profiler, a floor probe of
     one graph node) and at D=65536 with a cold L2, aliased and distinct,
     each beside its byte bound and the earlier design's times, and one
     wrapper call's host time; predict;
  8. torch.profiler windows over ten megakernel COKE iterations and ten
     fused-logistic COKE iterations, recording device activity only:
     device busy and idle share, device time by kernel; then ten K3 calls
     alone, which must launch one K3 kernel each and nothing else;
  9. the LM serving engine, small: the reduced qwen3-1.7b config with
     weights from one seed, on the card against the CPU (K4's plain
     version): equal greedy tokens, prefill logits close;
 10. the LM serving engine at full width: qwen3-1.7b (28 layers, d_model
     2048, 16 heads / 8 KV, head_dim 128, vocab 151936) in fp32 with
     weights drawn on the card, serving 2 prompts of 4096 tokens with
     max_new_tokens=16, greedy, cache_len=4112. K4 must launch exactly 28
     times (once per layer of the one prefill) and no other kernel; then
     layer 0's attention against the plain version, the prefill split into
     K4 and the rest, decode per token, and a profiler window over one
     prefill;
 11. K4 alone at the repo's prefill_32k length (S=32768, B=1, one layer),
     fp32 and bf16: qwen3-1.7b's heads (H=16, KV=8, causal), also without
     the causal mask beside it, and Mixtral's sliding window (H=32, KV=8,
     window 4096): the kernel's time, its bound (fp32: the least of the
     CUDA-core and 3xTF32 operation times), and
     F.scaled_dot_product_attention at the same shape as the yardstick;
 12. the simulator backend (`simulator_phase`): (a) the paper's own call,
     fit(FitConfig(algorithm=alg)) at its defaults (N=20 on an Erdos-Renyi
     p=0.3 graph, 350 train rows per agent, L=100, Cholesky, 1000
     iterations) for coke and dkla, then cta and ridge_oracle, on the card,
     on the CPU and in float64 on the card: comms and bits equal card vs
     CPU, the card's theta as close to the float64 run as the CPU's (within
     2x), COKE sends
     fewer broadcasts than DKLA near its train MSE, dist_to_oracle shrinks,
     and the COKE model's deploy launches K1; (b) primal="cg" and "auto"
     (resolving to CG) for COKE on the simulator, spmd and fused at phase
     4's big-D point, 20 iterations each: comms and bits equal across the
     six, theta within 2e-4; (c) Cholesky against CG at D=2048: comms
     equal, theta within 1e-4; then times beside their bounds: a Cholesky
     iteration at the paper's shape and at D=2048, the factorization at
     D=2048, and a CG iteration at D=4096 on the simulator and on spmd.
 13. the comm chain and time-varying topologies (`comm_topology_phase`),
     every fit loop under torch.cuda.set_sync_debug_mode("error"): the
     threefry draws (core.prng) on the card bitwise the CPU's and jax's
     pinned values; phase 4's cell with Chain([Censor(1.0, 0.95),
     Quantize(bits=8), Drop(p=0.05)]) for COKE and DKLA (K2 twice per
     iteration, K3 never, bits = sends x (D*8 + 32) exactly, the delivered
     share within a binomial bound of 0.95, COKE's train MSE within 2.5x
     phase 4's, predict through K1); the identity chain (Quantize(inf),
     Drop(0)) bitwise phase 4's COKE; phase 5's logistic cell with the
     chain (K3 once per iteration, K2 never); a cycle of two circulants on
     spmd at full width (no kernel; comms and bits equal the simulator's,
     theta close) and on the simulator at the paper's shape for 1000
     iterations with the per-graph Cholesky stack (card vs CPU vs float64);
     the fused backend's rejection of a schedule; small card-vs-CPU fits
     with the chain on every backend; then the chain megakernel, chain
     fallback and spmd schedule iterations beside the plain ones, with
     launches per iteration by the profiler.
 14. sweep (`sweep_phase`), every grid loop under
     set_sync_debug_mode("error"): G=8 keys in one draw bitwise 8 single
     draws; small sweeps (pairs, (v, mu, bits) with an inf lane, a
     Censor+Quantize+Drop chain; coke, dkla, cta) card vs CPU, comms and
     bits equal, theta within 1e-5 plus the rounding flips' steps; a fused
     evaluate of the grid launches K1 once; paper_comm_cost's censor grid
     (7 cells) and bits curve (8 cells) at its shape, 1200 iterations, each
     lane's comms and bits equal its own fit's (theta through a float64
     sweep); the bits-curve cells at the crossover width, under one shared
     factor stack (peak memory held), then a fused evaluate on the 30 000
     held-out rows (K1 once); ms and launches per grid iteration at G=1 and
     G=7 beside one fit's, and the factorization once.
 15. streaming (`stream_phase`): the three online solvers on the simulator
     and spmd, small, card vs CPU with the chain (flips counted);
     paper_online.run_curve's defaults (N=10, b=8, D=64, 1200 rounds);
     a full-width stream (N=20 ring, D=4096, b=64, 100 rounds, 2.10 GB of
     features) for online_coke and qc_odkla with Censor+Quantize(4) on
     both backends (comms and bits equal across them); ms and launches per
     round; partial_fit of the deployed model, whose fused predict
     launches K1 once. K2, K3 and K4 never move in phases 14-15.
 16. gossip and churn (`gossip_phase`), the fit loops under
     set_sync_debug_mode("error"): (a) phase 4's cell at participation 0.5,
     COKE and DKLA on the megakernel path (K2 twice per iteration, the mask
     after it; K5 once per iteration; K1 in predict), each against spmd
     (comms and bits equal, theta within phase 6's tolerance), and COKE at
     participation 1.0 bitwise phase 4's; (b) phase 5's logistic cell (K3
     once per iteration, K2 never), against spmd; (c) gossip_size=5 with a
     2x straggler on spmd: exactly 5 sends per iteration; (d) join/leave
     churn with the CG primal on the simulator and spmd (comms and bits
     equal, theta within phase 12's CG tolerance); (e) online_coke and
     qc_odkla at paper_online's shape (N=10 ring) at participation 0.4,
     with and without churn, simulator against spmd; (f) the paper grid
     as a gossip sweep plus a twin lane (bitwise equal), each lane against
     its own fit; (g) the reference's N=200, p=0.25 cell, printed beside
     the reference's figures; (h) ms and launches per iteration of each
     gossip path beside its sync one, one draw with K5 and with its plain
     version, and K5's launch floor: a replay of one launch that does no
     work.
 17. personalization (`personalize_phase`), the loops under
     set_sync_debug_mode("error"), on the heterogeneous dataset at full
     width (N=20 ring, 3 tasks, T=3500, D=4096, censor_v=0, rho=0.01,
     Personalization(k=5, every=5, warmup=30), CG, 100 iterations): (a)
     sync on the simulator and spmd: iterations 1-30 bitwise the static
     CG run, comms and bits equal across the backends, the learned graphs
     symmetric, zero-diagonal, of degree <= k, of equal support; (b)
     to_models(): each of the 20 models' fused evaluate launches K1 once,
     its MSE the plain product's; a save/load round trip; to_model()
     raises; (c) gossip at participation 0.5 (K5 once per draw), comms and
     bits equal across backends, and at 1.0 bitwise (a); (d) online_coke
     and qc_odkla at paper_online's shape on a ring, sync and gossip,
     simulator against spmd; (e) personalized sweeps at
     BENCH_personalize.json's shape cut to PZ_SWEEP_ITERS iterations (4
     cells with a twin, warmup 0 and 30), each lane against its own fit,
     and the all-warmup grid bitwise the static sweep; (f) the reference's acceptance experiment there
     (personalized beats consensus at equal bits, graph_recovery > 0.6);
     (g) ms and launches per iteration: warmup, live without and with a
     refresh, gossip, spmd, streams; one learned_adjacency at N=20 and 512.
 18. many-model serving (`serve_phase`), backend="fused": phase 4's COKE
     fit's featurizer (d=5, D=4096), its 20 per-agent models and 1004
     variants published into a ModelRegistry; (a) a resident cell, 65 536
     ids in one ThetaStore of 65 537 slots (1.07 GB) through one put_many,
     under benchmarks/many_model_bench.py's load (8 clients x 250 requests
     of 4 rows at uniform ids): QPS, rows/s, p50, p99, bucket calls, K1 and
     K6 once per bucket call, peak memory, one 1024-row bucket call's
     device and host time; one request alone and inside a full 1024-row
     bucket bitwise equal; K1's rows at T=2 bitwise the same rows at
     T=1024; hot swap under fire (2 clients, 4 publishes); one put's copy
     of the whole stack; (b) a paged cell, the 1024 registry ids through
     256 slots under the same load, with faults and evictions; every answer
     of both cells bitwise score_rows at its own row count and within
     SERVE_PREDICT_RTOL of predict; (c) K6 against its plain version at
     B in 1, 2, 31, 1024 and D in 16, 4093, 4096 (both instances, which
     give the same bits), and its time at (1024, 4096) beside its bound,
     the plain version and the einsum pair.
 19. big-D feature sharding (`shard_phase`) on a (data=2, model=4) mesh
     whose every cell is the card: (a) phase 4's Phi blocked once into
     eight (10, 3500, 1024) blocks; COKE on the simulator and spmd (CG, 30
     iterations) against the unsharded runs (comms and bits equal, theta
     within 1e-4), phase 4's fused COKE (the ring runtime, K3 once per
     block: 8 x 50) against the megakernel fit, phase 5's logistic cell,
     a Censor + Drop chain (K5 once per iteration) and one Quantize round
     (one draw of the unsharded (N, D), bitwise the unsharded round), all
     fit loops under set_sync_debug_mode("error"); ms per iteration beside
     the unsharded paths, peak memory; (b) big_d_bench's D = 65536 point
     (N=8, 128 rows) on (1, 4) and (2, 4) meshes against mesh=None; (c)
     the COKE model sharded: predict on 30 000 rows (K1 once per feature
     block), and phase 18(a)'s resident cell from a ThetaStore on the mesh
     (four (65 537, 1024) blocks) through KernelServer(mesh=): QPS, p99,
     K1 = K6 = 8 per bucket call, every answer bitwise the sharded
     score_rows and within SERVE_PREDICT_RTOL of the unsharded answer, a
     request alone bitwise inside a full bucket, one put. After each part
     the kernels it ran are held against their plain versions on one
     block of each operand at the part's block shapes: K3 on the carry's
     (10, 1024) blocks, K5 at the draws' shapes, K1 on the predict rows
     and a bucket's row block per feature block (scaled for D = 4096),
     K6 on those rows against a (65 537, 1024) stack block. The kernels
     line then carries phase 19's counts and errors for K1, K3, K5 and K6.
 20. training (`train_phase`), the port's `launch/train.py` path: (a) K7,
     the attention backward, against its plain version at the training
     shape (B=8, S=64, 16/8 heads of 128), the prefill shape (2 x 4096), a
     window, an odd length and the reduced model's heads, each error
     beside K7_RTOL, and at the training and prefill shapes its time with
     a cold L2 and its plan beside its bound (the larger of its bytes at
     the memory rate and its flops at 3xTF32), the plain version and
     autograd through F.scaled_dot_product_attention; (b) full-width
     qwen3-1.7b (28 layers,
     fp32), allreduce, AdamW lr 3e-3, clip 1.0, B=8, S=64 from
     TokenStream, 5 steps: the loss per step (finite), ms per step device
     and host, K4 and K7 once per layer per step, their ms per step (the
     profiler over a sixth step), peak memory; (c) dkla, coke, coke_et
     (local_steps=2) and cta at full width with 2 agents and the depth cut
     to 2 layers, TRAIN_CONSENSUS_STEPS = 3 steps each (`consensus_runs`):
     loss, comms, send_frac, ms per step, peak memory; coke's, cta's and
     coke_et's metrics and final parameters kept for phase 29 (shared host
     memory); (d) the reduced model, 4 agents on a ring, tests/
     test_system.py's coke run (20 steps, v=20, mu=0.5) on the card and on
     the CPU from the same weights, unfused and with K3 on the LM tree:
     comms and send_frac equal every step, losses within TRAIN_SMALL_RTOL;
     besides, from the CPU's state at each step, the card's loss for that
     step and the next within TRAIN_SMALL_RTOL (as (f));
     (e) K7 at zamba2's shared block (Dh = Dv = 80) at (8, 64, 32/32) and
     (2, 4096, 32/32), held and timed as in (a); (f) the reduced mamba2
     and zamba2 (and zamba2 at head_dim 80), allreduce and coke at 4
     agents, TRAIN_SMALL_STEPS steps on the card and on the CPU from the
     same weights: comms and send_frac equal every step; from the CPU's
     state at each step, the card's loss for that step and for the next
     (after its own update) within TRAIN_SMALL_RTOL of the CPU's; K4 = K7
     = agents x shared-block applications x card steps (0 for mamba2);
     (g) full-width mamba2-2.7b and zamba2-2.7b,
     allreduce at (b)'s settings, one model at a time: ms per step device
     and host, K4 and K7 per step (0 / 9), the SSD scan's forward and
     backward times the layers beside the step, peak memory, finite
     losses. The kernels line gains K7 (flash_attention_bwd) with (b), (f)
     and (g)'s launches; K4's entry adds (f) and (g)'s.
 21. a mesh under gossip and personalization (`mesh_gossip_phase`) on
     phase 19's (data=2, model=4) mesh of the card, every fit loop under
     set_sync_debug_mode("error"): (a) phase 4's problem blocked once;
     gossip at participation 0.5 and at gossip_size 5, COKE and DKLA, on
     the simulator and spmd (CG, 15 iterations) and the fused backend (the
     ring runtime, K3 once per block of the carry: 8 x 50), and phase 16's
     churn on spmd, each against its unsharded run: K5 once per draw,
     comms and bits equal until the runs part (`hold_until_parted`),
     theta within 1e-4; (b) phase 17's personalized cell cut to 41
     iterations (refreshes 31, 36, 41), sync and gossip at 0.5 on the
     simulator and spmd: the warmup prefix bitwise the sharded static run,
     the learned graph's support at every refresh against the unsharded
     run's (a refresh that parts is printed with the float64 gap of the
     parted rows' k-th and (k+1)-th peers, which must lie within what
     fp32 rounding moves d2 by), comms and bits equal until then; then
     to_models() of the sharded simulator fit, and each of the 20 models
     sharded and evaluated with backend="fused" (K1 once per feature
     block: 20 x 4), its MSE against the unsharded evaluate's; (c) ms per
     iteration, device and host, with launches, sharded beside unsharded
     (gossip CG on both backends, fused gossip, live personalized gossip
     with one refresh in five), and peak memory; (d) K3 on the carry's
     (10, 1024) blocks, K5 at the participation draw's (20,) and K1 on a
     per-agent evaluate's rows per feature block, against their plain
     versions. The kernels line then carries phase 21's counts and errors
     for K1, K3 and K5.
 22. the LM families beside qwen3 (`lm_family_phase`): (a) the reduced
     granite-3-8b, llama3-405b, mixtral-8x7b (window 64), minicpm3-4b and
     deepseek-v2-lite-16b served on the card against the CPU from the same
     weights (96-token prompts, 8 new): equal greedy tokens, prefill
     logits within LM_RTOL, K4 once per layer; (b) at full width, one
     model drawn, served and freed at a time, weights drawn on the card in
     fp32: deepseek-v2-lite-16b (27 layers, MLA + MoE, 2 x 4096 prompts),
     minicpm3-4b (62 layers, MLA, 2 x 4096), mixtral-8x7b (8 of its 32
     layers, MoE, window 4096, 1 x 8192 into a rolling cache of 4096) and
     granite-3-8b (40 layers, 2 x 1024), 16 new tokens each, greedy: K4
     exactly once per layer of the prefill and no other kernel; (c) per
     model, layer 0's attention through K4 against its plain version at
     the model's shape (8 heads), layer 0's MoE on 512 tokens on the card
     against the CPU (expert indices and the drop set equal, y within
     MOE_RTOL), and layer 0's decode step at position S after a prefill
     of S (the absorbed MLA decode; Mixtral's rolling cache, S past its
     window) against the plain fp32 attention of the last of S + 1 tokens,
     within LM_RTOL; (d) the
     prefill split into K4 and the rest, decode per token, peak memory,
     and K4 at each model's shape beside its plan, bound and SDPA. The
     kernels line's K4 entry then carries (b)'s launches and the largest
     error of phases 10 and 22.
 23. the SSM model and the grouped hybrid (`ssm_phase`): (a) the reduced
     mamba2-2.7b and zamba2-2.7b served on the card against the CPU from
     the same weights (2 x 197-token prompts, not a multiple of the
     32-token chunk; 8 new): equal greedy tokens, prefill logits within
     LM_RTOL, K4 once per shared-block application; (b) at full width,
     one model drawn, served and freed at a time, weights drawn on the
     card in fp32: mamba2-2.7b (64 SSM layers) and zamba2-2.7b (54 SSM
     layers, the shared attention block after every 6: 9 applications, Dh
     = Dv = 80), 2 x 4096 prompts, 16 new tokens each, greedy: K4 never
     for mamba2, 9 times for zamba2, and no other kernel; (c) layer 0's
     mixer on 512 tokens on the card and on the CPU against float64 (y
     and the state within SSM_F64_RATIO of the CPU's error), zamba2's
     first shared-block application through K4 against its plain version
     and against the float64 attention (within K4_TOL of the latter),
     and
     layer 0's recurrent decode step after a chunked prefill of S tokens
     against the chunked prefill of S + 1, within LM_RTOL; (d) the prefill split into the SSD scan, K4 and the
     rest, decode per token beside one read of the weights, peak memory,
     and K4 at (2, 4096, 32/32, 80) beside its plan, bound and SDPA, and
     at Dv = 64, 80, 128. The kernels line's K4 entry then adds (b)'s
     launches and the largest error over (c).
 24. K4's fp32 accuracy (`k4_accuracy_phase`): (a) (1, S, 8/8, 128)
     causal, S = 512 ... 8192, v of one sign down each channel (max|v| 5)
     against float64, K4 within K4_TOL at every S, printed beside the
     plain version's error and the mean signed error; (b) full-depth
     qwen3-1.7b (2 x 4096, 28 layers) and granite-3-8b (2 x 1024, 40
     layers), one drawn and freed at a time: the prefill's logits through
     K4 against the same prefill with every layer's attention through the
     plain version, within LM_RTOL of max|logit|, and, reported without a
     hold, the prefill of S + 1 against the prefill of S and one decode
     step.
 25. MoE and MLA training (`moe_mla_train_phase`), through K4 and K7 at
     Dh != Dv: (a) K7 against its plain version at deepseek-v2-lite's Dh
     192 / Dv 128 and minicpm3-4b's 96 / 64 heads (B=8, S=64 and 2 x 4096)
     and the reduced models' 48 / 32, within K7_RTOL, each timed with a
     cold L2 beside its plan, its 3xTF32 bound (3 x (6 Dh + 4 Dv) flops a
     pair), the plain version and SDPA's backward; (b) the reduced
     granite-3-8b, mixtral-8x7b, minicpm3-4b and deepseek-v2-lite-16b,
     allreduce and coke (v=20, mu=0.5) at 4 agents, B=8 at S=96 (past
     Mixtral's reduced window), TRAIN_MOE_MLA_STEPS steps on the card and
     on the CPU from the same weights: from the CPU's state at each step,
     every MoE layer's expert indices and drop set equal the CPU's
     (smallest top-k margin printed), comms and send_frac equal, and the
     card's loss for that step and the next within TRAIN_MOE_MLA_RTOL; K4 =
     K7 = agents x layers x card steps; (c) full-width deepseek-v2-lite-16b
     (2 of 27 layers), minicpm3-4b (16 of 62) and mixtral-8x7b (1 of 32),
     allreduce at 20(b)'s settings, one model drawn, stepped 5 times and
     freed at a time: each cut with its reckoning, ms per step device and
     host, K4 and K7 per step (the layers kept), peak memory, finite
     losses. The kernels line's K7 entry adds (b) and (c)'s launches and
     (a)'s largest error; K4's adds (b) and (c)'s launches.
 26. the VLM prefix and enc-dec serving (`multimodal_phase`): (a) K4
     against its plain version within K4_TOL at internvl2-1b's (2, 4096,
     14/2, 64) causal, seamless-m4t-medium's encoder (2, 2048, 16/16, 64)
     without the mask, its decoder's self attention (the same, causal)
     and its cross attention (Sq 256 over Sk 2048, no mask), each with a
     cold L2 beside its plan, bound, plain version and SDPA; (b) the
     reduced internvl2-1b and seamless-m4t-medium on the card against the
     CPU from the same weights and stub embeddings: forward logits, the
     VLM's prefill caches and the enc-dec cross k/v of every layer within
     LM_RTOL, greedy tokens equal (VLM prompts of 5 and 96 tokens beside
     its 8-row prefix); (c) internvl2-1b at full width, 2 x (256 patch
     rows + 3840 tokens), cache 4112: one prefill_with_state launches K4
     exactly 24 times and nothing else, layer 0's attention through K4
     against the plain version within LM_RTOL, one generate of 16 tokens
     with the prefix launches K4 24 times in all; (d) seamless-m4t-medium
     at full width: one prefill of 2 x (2048 frames + 2048 tokens)
     launches K4 exactly 36 times (12 encoder, 12 self, 12 cross),
     encoder layer 0 and decoder layer 0's cross attention through K4
     against the plain version within LM_RTOL, one generate over 2048
     frames with 8-token prompts and 16 new tokens launches K4 12 times
     (the encoder; the replay and the decode none); (c)-(d) the prefill
     split into K4 and the rest, decode per token, peak memory. The
     kernels line's K4 entry adds (b)-(d)'s launches and the largest
     error of (a), (c) and (d).
 27. the VLM and the enc-dec model trained (`mm_train_phase`): (a) K7
     against its plain version within K7_RTOL, and K4's output and the
     log-sum-exp K7 reads within K4_TOL (+inf rows equal), at
     internvl2-1b's (2, 4096, 14/2, 64) causal, seamless-m4t-medium's
     encoder (2, 2048, 16/16, 64) without the mask and decoder self
     attention (causal), its cross attention without the mask at Sq 256
     over Sk 2048 and at Sq 2048 over Sk 256, and ragged (1, 200 / 1000,
     14/2, 64) both ways, untimed; the rest with a cold L2 beside K7's
     bound, plain version and SDPA's backward; (b) the reduced
     internvl2-1b at 14/2 heads (8 patch rows + 88 tokens) and
     seamless-m4t-medium (80 frames + 48 tokens), allreduce and coke
     (v=20, mu=0.5) at 4 agents, TRAIN_MOE_MLA_STEPS steps of B=8 card
     against CPU from the same weights and stub embeddings, held step by
     step within TRAIN_MOE_MLA_RTOL, comms and send_frac equal; K4 = K7 =
     agents x attentions x (3 steps - 1); (c) both at full width on
     configs/shapes.py's train_4k split at B=2 (256 patch rows + 3840
     tokens; 2048 frames + 2048 tokens), AdamW lr 3e-3 clip 1.0, 5 steps:
     ms per step device and host, K4 and K7 per step (24; 12 + 2 x 12 =
     36), peak memory, finite losses, the model flops of
     launch/analysis.py and their share of the card's fp32 peak. The
     kernels line's K7 and K4 entries add (b) and (c)'s launches and
     (a)'s largest errors.
 28. phase 19's mesh across ranks (`ranks_phase`): the (data=2, model=4)
     mesh's cells owned by the ranks of a gloo group, every rank on this
     card (`make_host_mesh(..., group=)`; NCCL takes one rank per card),
     spawned by torch.multiprocessing after phase 1's build (the ranks
     only load the kernels): W = 2 (split (2, 1)) and W = 4 ((2, 2)).
     Phase 19(a)'s cells at full width and phase 19's depth (COKE with
     CG, 30 iterations, on the simulator and spmd at W = 2 and on spmd at
     W = 4; the fused fallback through K3, the logistic cell and the
     Censor + Drop chain through K5, 50), at W = 4 phase 19(b)'s D = 65536
     point (10 iterations, both backends), and the sharded COKE model's
     predict through K1, first on the one-process mesh, then on the
     ranks: every cell sends (comms > 0), every rank's history, theta
     and predictions bitwise its peers',
     comms and bits equal to the one-process run until the runs part
     (`hold_until_parted`), theta within phase 19's tolerance; K3 summed
     over the ranks equal to the one-process count, K5 on every rank
     equal to it (each rank draws every unsharded draw), K1 summed w_b
     times it; K3, K1 and K5 held against their plain versions on each
     rank's blocks. Per rank and cell: wall time, the gathers and the
     bytes they moved, peak memory, host wall beside the device's time
     between events on either side of the cell; per rank the share of Phi
     it holds. The gloo transfers sync the host: these loops run
     without set_sync_debug_mode("error"). The kernels line's
     K1, K3 and K5 entries add the ranks' launches.
     Then, in the same spawns, serving across the ranks (`rank_serve`:
     `ThetaStore` and `KernelServer` SPMD, rank 0's collector driving
     every rank's collectives by broadcast commands): phase 19(c)'s
     resident cell (65 536 ids, phase 18's clients at
     RANK_SERVE_REQUESTS requests each) and a full 1024-row
     bucket at W = 2 and 4, and at W = 4 phase 18's hot swap under fire
     and its paged cell (1024 registry ids, written by the parent before
     the spawn, through 256 slots): every answer bitwise the one-process
     mesh's score_rows at its own row count, the request alone bitwise
     itself inside the full bucket, every follower's store the front's,
     K1 and K6 summed over the ranks 8 a bucket call, both held against
     their plain versions on each rank's blocks; QPS, p50 / p99 beside
     phases 18(a) and 19(c), broadcasts and gathers per bucket call,
     per-rank wall, device time and peak memory. The kernels line's K6
     entry adds these launches too.
 29. the deep-net trainer with its agents on their own ranks
     (`train_ranks_phase`): allreduce at microbatches = 2 in this process
     (phase 20(c)'s model and batches), then TRAIN_RANK_WORLD = 2 gloo
     ranks of this card (`train.steps.make_train_step(..., mesh=)` on a
     (2, 1) mesh of the group, one agent a rank; the large gathers by
     CUDA IPC between the ranks, `sharding.gather_ranks(on_card=True)`):
     (a) coke, cta and coke_et as phase 20(c) runs them, every rank's
     metrics bitwise its peer's, comms and send_frac equal to 20(c)'s
     every step, losses within TRAIN_RANK_RTOL relative, each rank's agent
     within TRAIN_RANK_RTOL of each leaf's largest magnitude after the last
     step, the gathers a step as the layer's rules count them, peak memory
     per rank below 20(c)'s one process; layer 0's K4 (and its log-sum-
     exp) and K7 on each rank's own agent against their plain versions;
     (b) allreduce over the ranks, each 1/W of the batch, losses bitwise
     the microbatched run's and every parameter leaf's `fingerprint` (its
     words' exact integer sums) equal to it. Per rank: ms a step (wall
     and device between events), gathers and bytes a step, peak memory,
     K4 and K7 launches (N/W x layers x steps). The kernels line's K4 and
     K7 entries add the ranks' launches and errors.
Before each of phases 4-6, 10, each part of 12, each path of 13-17, each
cell of 18, each part of 19, each run of 20, each cell of 21, each
generate of 22 and 23, each prefill of 24, each run of 25 and 27, each
counted prefill and generate of 26, each cell of 28 and each run of 29
(in every rank) every launch counter is set to 0, and read just after.
The line before the last is one JSON object describing the kernels; the
last is {"ok": true, "device": {...}}. Without a card, or outside a
checkout of the repo, it prints no result and exits 2.

    python3 chip_smoke.py --phase19   # build, phases 4 and 5's fits, 19
    python3 chip_smoke.py --phase20   # build, phase 20
    python3 chip_smoke.py --phase21   # build, phase 4's problem, 21
    python3 chip_smoke.py --phase22   # build, phase 22
    python3 chip_smoke.py --phase23   # build, phase 23
    python3 chip_smoke.py --phase24   # build, phase 24
    python3 chip_smoke.py --phase25   # build, phase 25
    python3 chip_smoke.py --phase26   # build, phase 26
    python3 chip_smoke.py --phase27   # build, phase 27
    python3 chip_smoke.py --phase28   # build, phase 28
    python3 chip_smoke.py --phase29   # build, phase 20(c)'s yardstick, 29

runs phase 19 alone (after the fits it holds its sharded runs against)
and prints its launch counts and errors, phase 20 alone and its K7
entry, phase 21 alone and its launch counts and errors, phase 22, 23 or
26 alone and K4's launches and largest error there, phase 24 alone and
K4's largest error against float64, phase 25 alone and K7's launches
and largest error and K4's launches, or phase 27 alone and K7's and K4's
launches and largest errors, or phase 28 alone and its launch counts and
errors, or phase 29 alone (after the runs of phase 20(c) it holds its
ranks to) and its launch counts and errors; none prints the result
lines.
"""
from __future__ import annotations

import dataclasses
import gc
import hashlib
import importlib
import json
import math
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import weakref
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
ITERS = 50
N_AGENTS = 20
SAMPLES = 5000            # per agent: 3500 train + 1500 test rows
FEATURES = 4096
# NVIDIA data-sheet peaks: (name fragment, memory bytes/s, fp32 flop/s
# outside the tensor cores, dense bf16 tensor-core flop/s, dense TF32
# tensor-core flop/s); the first fragment found in the card's name
CARD_PEAKS = (("H100 PCIe", 2.0e12, 51.2e12, 756e12, 378e12),
              ("H100 NVL", 3.9e12, 60.0e12, 835e12, 417.5e12),
              ("H100", 3.35e12, 67.0e12, 989e12, 494.7e12),
              ("H200", 4.8e12, 67.0e12, 989e12, 494.7e12))
# K2: theta', xi_sq and resid_sq are fp32 sums of T*D products taken in
# another order than cuBLAS's (per-thread column strips, a fixed block
# tree, segment order): relative error ~sqrt(T)*2^-24 ~ 4e-6 at T=3500
K2_RTOL = 1e-5
# K2 at the main shape in its earlier design (two launches over per-agent
# row chunks, PERF.md's kernel table): the time this design is held against
K2_EARLIER_MS = 0.6582
# K1 at the predict shape in its earlier design (a 32 x 64 tile per block,
# stored at the block's end; PERF.md's kernel table): the time this design
# is held against
K1_EARLIER_MS = 0.4569
# clock cycles of the sleep kernel that holds the device while the host
# enqueues a cold-L2 timing loop (`flushed_ms`): ~20 ms at 2 GHz, more than
# 50 calls of a wrapper with a few hundred microseconds of host time each
HOLD_CYCLES = 40_000_000
# K3 in its earlier design (one block per 512-feature tile, the tile
# partials summed by torch.sum, a second kernel), timed by
# scripts/k3_compare.py before this design replaced it (PERF.md): per call
# at the path's shape (N=20, D=4096, one tensor as both neighbours) as a
# CUDA-graph replay, its kernel alone and the torch.sum by the profiler,
# and at D=K3_STREAM_D with a cold L2 (`flushed_ms`), aliased and
# distinct; "clean" after the flush buffer was also read back, timed in
# the same call as this design
K3_EARLIER_MS = {"path": 0.003882, "kernel alone": 0.001653,
                 "torch.sum": 0.001954, "stream aliased": 0.022048,
                 "stream distinct": 0.024376,
                 "stream aliased clean": 0.018800,
                 "stream distinct clean": 0.020632}
# and one call of its wrapper, host time (`host_call_ms`)
K3_EARLIER_HOST_MS = 0.0455
# K3's streaming shape: the repo's big-D point (benchmarks/big_d_bench.py)
K3_STREAM_D = 65536
# K3: g_aug is formed in the plain expression's order with round-to-nearest
# intrinsics, so it may differ from the plain version only where a compiler
# contracted a product into an FMA: 4 ulps of the largest term. xi_sq is an
# fp32 sum over D in another order than the plain torch.sum.
K3_ULPS = 4 * 2.0**-23
K3_XI_RTOL = 1e-5
# spmd vs the megakernel at full width: the same iteration with the T-sums
# of the gradient in another order (cuBLAS batched products vs K2's column
# strips), each ~sqrt(T)*2^-24 relative, carried through 50 iterations
SPMD_RTOL = 1e-5
# CTA stepsize on the spmd path (see phase 6)
CTA_LR = 0.3
# the reason no single PyTorch call is a yardstick
NO_LIBRARY = {
    "coke_megastep": "no single PyTorch call computes a whole gradient-"
                     "primal ADMM iteration (two matvecs over Phi, the ring "
                     "combine and the censor norm)",
    "rff_cos_bias": "no single PyTorch call fuses x @ omega with the cosine; "
                    "torch.addmm + torch.cos is two calls and writes the "
                    "projection to device memory",
    "coke_fused_update": "no single PyTorch call computes the augmented "
                         "gradient and the per-agent censor norm together",
    "threefry": "no PyTorch call draws jax's threefry2x32 words (torch.rand "
                "is Philox, another function)",
}
# the LM serving path (phase 10): qwen3-1.7b serving 2 prompts of 4096
# tokens, 16 new tokens each, greedy, in a cache of 4112 slots
LM_ARCH = "qwen3-1.7b"
LM_BATCH = 2
LM_PROMPT = 4096
LM_NEW_TOKENS = 16
LM_CACHE = LM_PROMPT + LM_NEW_TOKENS
# K4 alone (phase 11): the prefill_32k length of src/repro/configs/
# shapes.py, and Mixtral-8x7B's attention (src/repro/configs/
# mixtral_8x7b.py: 32 heads, 8 KV heads, head_dim 128, window 4096)
PREFILL_32K = 32768
MIXTRAL_HEADS = (32, 8, 128, 4096)
# K4 against its plain version: fp32 scores and an online softmax against a
# full softmax (the reference's own tolerance, tests/test_kernels.py); bf16
# outputs within an ulp of bf16 (2^-7 relative) after rounding
K4_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
# K7 (the attention backward, 3xTF32 on the tensor cores) against its
# plain version: sums over keys (dQ) or queries (dK, dV) in another order,
# P recomputed from K4's log-sum-exp: each gradient within this share of
# its largest magnitude
K7_RTOL = 1e-4
# the tensor-core instruction K7's 3xTF32 products compile to (SASS)
K7_HMMA = "HMMA.1688.F32.TF32"
# the tensor-core instructions each K4 instance must compile to (SASS):
# bf16 m16n8k16 and the TF32 m16n8k8 of the fp32 instance's 3xTF32
K4_HMMA = ("HMMA.16816.F32.BF16", "HMMA.1688.F32.TF32")
# the LM on the card against the CPU: fp32 through the layers with cuBLAS
# and K4 against ATen's CPU matmuls and the plain softmax, ~1e-6 relative
# per op: logits within 1e-5 of their largest magnitude
LM_RTOL = 1e-5
# phase 22(a), the reduced configs of the LM families beside qwen3's
LM_FAMILY_REDUCED = ("granite-3-8b", "llama3-405b", "mixtral-8x7b",
                     "minicpm3-4b", "deepseek-v2-lite-16b")
# phase 22, the other LM families at full width, one model at a time:
# (arch, layers served (None: all), batch, prompt tokens, cache slots)
LM_FAMILY = (
    ("deepseek-v2-lite-16b", None, 2, 4096, 4096 + LM_NEW_TOKENS),
    ("minicpm3-4b", None, 2, 4096, 4096 + LM_NEW_TOKENS),
    # 8 of 32 layers: 32 would hold 187 GB of fp32 weights; the cache of
    # the window's 4096 slots rolls over the 8192-token prompt
    ("mixtral-8x7b", 8, 1, 8192, 4096),
    ("granite-3-8b", None, 2, 1024, 1024 + LM_NEW_TOKENS),
)
# phase 22(c): layer 0's MoE on this many of the prompt's tokens, card
# against CPU
LM_FAMILY_MOE_TOKENS = 512
# phase 22(c): the MoE layer on the card against the CPU, fp32 matmuls in
# other orders: y within this share of its largest magnitude
MOE_RTOL = 1e-5
# phase 23, the SSM model and the grouped hybrid at full width, one at a
# time: (arch, batch, prompt tokens); each serves LM_NEW_TOKENS greedy
# tokens into a cache of prompt + LM_NEW_TOKENS slots
SSM_FAMILY = (("mamba2-2.7b", 2, 4096), ("zamba2-2.7b", 2, 4096))
# phase 23(a): the reduced configs' prompt, past three of their 32-token
# chunks and not a multiple of the chunk
SSM_REDUCED_PROMPT = 2 * 96 + 5
# phase 23(c): layer 0's mixer on this many of the prompt's tokens (two
# chunks of 256), card against CPU
SSM_HOLD_TOKENS = 512
# phase 23(c): layer 0's mixer at full width on the card and on the CPU,
# each against the same mixer in float64 (on the CPU): fp32's own error
# there is ~1.3e-5 of max|y| (the rms norm after the scan scales each
# row's error up to the row's own scale), so card and CPU part by as much;
# the hold is that the card's output and state are as close to float64 as
# the CPU's, within this factor
SSM_F64_RATIO = 2.0
# phase 23(d): K4 at zamba2's head dim Dh = 80 with these value widths:
# Dv = 64 runs the nj = 1 instance, 80 and 128 the nj = 2 instance, so
# 80 against 128 shows what its 48 idle output columns cost
SSM_K4_DV = (64, 80, 128)
# phase 24(a), K4's fp32 error along the row: (1, S, 8/8, 128) causal at
# these lengths, v a unit-normal mean per channel plus K4_CURVE_NOISE
# times unit noise, scaled to max|v| = K4_CURVE_VMAX: values of one sign
# down each channel, as on zamba2's first shared block (max|v| 5.19,
# max|out| 3.85), so that every output is a sum of like-signed terms. Held
# against the float64 attention computed K4_CURVE_F64_HEADS heads at a time
K4_CURVE_LENGTHS = (512, 1024, 2048, 4096, 8192)
K4_CURVE_HEADS = 8
K4_CURVE_VMAX = 5.0
K4_CURVE_NOISE = 0.25
K4_CURVE_F64_HEADS = 2
# phase 24(b): full-depth prefills through K4 against the same prefill
# with every layer's attention through the plain version: (arch, B, S)
K4_DEPTH_HOLDS = (("qwen3-1.7b", 2, 4096), ("granite-3-8b", 2, 1024))
# phase 12, the simulator backend: the paper's own call at its defaults
# (PAPER_SETUPS["synthetic"]: N=20 on an Erdos-Renyi p=0.3 graph, 500
# samples per agent, L=100, Cholesky, 1000 iterations), then the CG primal
# at phase 4's big-D point and Cholesky against CG at the crossover D
SIM_BIG_D_ITERS = 20
SIM_CROSSOVER_D = 2048
# fp32 runs of the paper's 1000-iteration fit carry theta ~1e-4 to 3e-4
# from the float64 trajectory (the reference itself 2.68e-4 on its draw,
# PERF.md), in another direction on the card than on the CPU: the card's
# theta is held within SIM_F64_FACTOR times the CPU's distance from the
# float64 run (plus SIM_F64_SLACK), and their train MSE within
# SIM_MSE_RTOL
SIM_F64_FACTOR = 2.0
SIM_F64_SLACK = 1e-5
SIM_MSE_RTOL = 1e-4
# COKE's final train MSE against DKLA's after 1000 iterations: 1.028x in
# the reference (neither has converged at lam=5e-5)
SIM_COKE_MSE_RATIO = 1.05
# the CG primal across backends, Cholesky against CG (tests/test_big_d.py)
SIM_CG_BACKEND_TOL = 2e-4
SIM_CHOL_CG_TOL = 1e-4
# phase 13, the comm chain and time-varying topologies. jax's threefry
# values (jax 0.9.0, jax_threefry_partitionable=True), made once on the CPU
# with jax.random (tests/test_torch_prng.py checks them against jax):
# (seed, fold_in data, shape, key, {flat index: jax.random.bits word})
JAX_PRNG_PINS = (
    (0, (3,), (4,), (2467461003, 3840466878),
     {0: 1146711402, 1: 3152292334, 2: 4096209733, 3: 899974525}),
    (42, (7, 2), (20,), (675592481, 2815174185),
     {0: 453413573, 1: 2720761627, 7: 499882967, 19: 2676824676}),
    (1, (2**32 - 1, 0), (20, 4096), (3689924417, 2349107139),
     {0: 3796337616, 1: 22373131, 4095: 1305795636, 4096: 230078614,
      81919: 584840883}),
    (7, (12345,), (65537,), (3187294848, 248916179),
     {0: 2380884285, 1: 2852435296, 65535: 440275409, 65536: 4091176205}),
)
# jax.random.uniform(fold_in(PRNGKey(0), 3), (4,)), float32 bit patterns
JAX_UNIFORM_PIN = (1049146072, 1060889640, 1064576818, 1045860880)
# Chain([Censor(1.0, 0.95), Quantize(bits=8), Drop(p=0.05)]).chain_key() in
# the reference, and its uncensored (DKLA) form's
JAX_CHAIN_KEYS = {"coke": (3779160158, 630299372),
                  "dkla": (190433053, 3829259469)}
CHAIN_BITS = 8
CHAIN_DROP = 0.05
# the delivered share of the Drop stage's 2 x N x ITERS link draws: within
# DELIVERY_SIGMAS binomial standard deviations of 1 - p
DELIVERY_SIGMAS = 5.0
# COKE with quantized innovations over lossy links against the censor-only
# run: the reference's own factor (tests/test_comm.py)
CHAIN_MSE_FACTOR = 2.5
# the offset cycle of the topology runs (a ring, then the ring plus the
# second neighbours), and the paper-shape run's length
TOPO_CYCLE = ((1,), (1, 2))
TOPO_PAPER_ITERS = 1000
# small card-vs-CPU fits (phase 3's tolerance); with a stochastic
# quantizer, plus one level's step for each coordinate whose rounding
# flipped between the two runs (`quantizer_flips`)
SMALL_THETA_TOL = 1e-5
# the reference's message for a schedule on the fused fallback
FUSED_SCHEDULE_ERROR = (
    "the fused coke_update kernel bakes the graph degree in as a static "
    "parameter; offset_schedule (time-varying topology) requires "
    "use_fused_kernel=False")
# phase 14, sweep: benchmarks/paper_comm_cost.py's grids at its shape
# (PAPER_SETUPS["synthetic"], samples_override=600: N=20 on an Erdos-Renyi
# p=0.3 graph, 420 train rows per agent, L=100, Cholesky, 1200
# iterations): run_setup's GRID, and run_bits_curve's BITS_CENSORS x
# BITS_WIDTHS; the latter 8 cells also at the crossover width
# (SIM_CROSSOVER_D on phase 4's ring, SIM_BIG_D_ITERS iterations)
SWEEP_ITERS = 1200
SWEEP_SAMPLES = 600
PAPER_GRID = ((0.5, 0.98), (0.5, 0.99), (0.1, 0.995), (0.05, 0.997),
              (0.02, 0.998), (0.01, 0.999), (0.05, 0.999))
BITS_CENSORS = ((0.5, 0.98), (0.1, 0.995), (0.05, 0.997), (0.01, 0.999))
BITS_WIDTHS = (float("inf"), 4.0)
# phase 15, streams: benchmarks/paper_online.py::run_curve's defaults, then
# a stream at the fit cells' width (N_AGENTS on a ring, FEATURES) with
# STREAM_WIDE_BATCH rows per agent per round
# two runs of one policy that part on a knife-edge send decision or a
# rounding flip are held by their accuracy: the mean train (or
# instantaneous) MSE over their last tenth of rounds within 1%, the
# no-loss gap of SweepResult.select
PARTED_MSE_RTOL = 0.01
STREAM_SOLVERS = ("online_dkla", "online_coke", "qc_odkla")
ONLINE = dict(rounds=1200, num_agents=10, batch=8, features=64, v=0.2,
              mu=0.995, bits=4.0, lr=0.3)
STREAM_WIDE_ROUNDS = 100
STREAM_WIDE_BATCH = 64
# phase 16, gossip and churn: the reference's churn scenario of
# tests/test_gossip.py scaled to phase 4's N=20 ring (a leave, a late
# joiner, a rejoin), and to paper_online's N=10 for the streams; the
# participation rates; the straggler of the fixed-size cell
GOSSIP_P = 0.5
GOSSIP_CHURN = dict(leave=((10, 3),), join=((20, 15), (30, 3)),
                    start_absent=(15,))
GOSSIP_CHURN_10 = dict(leave=((10, 1),), join=((20, 7), (30, 1)),
                       start_absent=(7,))
GOSSIP_STREAM_P = 0.4
GOSSIP_SIZE = 5
GOSSIP_STRAGGLER = (7, 2.0)
# rounds of participation draws over which the straggler's share is held
GOSSIP_DRAWS = 2000
# a float64 gossip lane against its float64 fit after 1200 iterations:
# batched against single triangular solves, ~1e-16 a step, far inside an
# fp32 rounding of max|theta|
GOSSIP_F64_RTOL = 1e-6
# the reference's N=200 acceptance cell (tests/test_gossip.py) and its own
# final train MSEs on the CPU (jax 0.9.0): gossip at p=0.25 over 400
# iterations, sync over 100; printed beside the port's, not held to 2x
N200 = dict(num_agents=200, samples_per_agent=5, num_features=32,
            lam=1e-3, rho=0.1, seed=0)
N200_REFERENCE_MSE = (0.025010, 0.011904)
# K5 against its plain version: single keys at the path's sizes (the
# participation draw N, a Quantize draw N x D) and ragged ones
# phase 17, personalization: the heterogeneous dataset at the fit cells'
# width (N_AGENTS on a ring, SAMPLES, FEATURES) with PZ_TASKS latent tasks,
# BENCH_personalize.json's knobs (benchmarks/personalize_bench.py: lam
# 1e-3, rho 0.01, censor_v 0 so both arms send every iteration, k=5,
# every=5, warmup=30, CG) for PZ_ITERS iterations; its own shape for the
# sweeps and the acceptance experiment, and the reference's recorded
# figures there (per-agent test MSE personalized, consensus; recovery)
PZ_TASKS = 3
PZ_FULL = dict(k=5, every=5, warmup=30)
PZ_ITERS = 100
PZ_GOSSIP_P = 0.5
PZ_STREAM = dict(k=3, every=5, warmup=10)
PZ_BENCH = dict(dataset="heterogeneous", num_agents=20,
                samples_per_agent=100, num_tasks=3, num_features=64,
                lam=1e-3, rho=0.01, censor_v=0.0, censor_mu=0.97, seed=0)
PZ_BENCH_ITERS = 300
PZ_REFERENCE = (0.00412, 0.00983, 0.896)
# a censor grid of G=4 cells, the last a twin of the first
PZ_GRID = ((0.0, 0.97), (0.01, 0.99), (0.05, 0.98), (0.0, 0.97))
PZ_SWEEP_WARMUPS = (0, 30)
# (e)'s sweeps at BENCH_personalize.json's shape, cut from its 300
# iterations to make room for phases 20(e)-(g) and 24 (warmup 30, a
# refresh every 5: 24 refreshes still)
PZ_SWEEP_ITERS = 150
PZ_SCALE_N = 512
# a per-agent model's test MSE through K1 against the plain product
PZ_DEPLOY_RTOL = 1e-5
K5_SIZES = (N_AGENTS, 512, N_AGENTS * FEATURES, 4097, 1027 * 1031)
K5_LANES = 8
# phase 18, many-model serving: benchmarks/many_model_bench.py's load
# (8 closed-loop clients, 4-row requests at uniform ids, max_delay_ms=1)
# at the fit cells' featurizer (d=5, D=4096), backend="fused"
SERVE_RESIDENT = 65536      # resident ids in one store of +1 slots, 1.07 GB
SERVE_REGISTRY = 1024       # the 20 per-agent models + 1004 variants
SERVE_CLIENTS = 8
SERVE_REQUESTS = 250        # per client
SERVE_BATCH = 4
SERVE_DELAY_MS = 1.0
SERVE_TRACE_REQUESTS = 50  # per client, the profiled run of each cell
SERVE_SWAP_CLIENTS = 2
SERVE_SWAP_PUBLISHES = 4
SERVE_ROWDOT_B = (1, 2, 31, 1024)
SERVE_ROWDOT_D = (16, 4093, 4096)
# K6 against its plain version, of sum_k |phi theta| per row: K6 rounds a
# chain of D/32 + 5 = 133 adds at D=4096 (7.9e-6 in units of 2^-24), the
# plain sum a shallower tree
ROWDOT_RTOL = 1e-5
# a served answer (K6's order) against predict's matvec (cuBLAS's order)
# over the same 4096 products, of sum_k |phi theta| per row
SERVE_PREDICT_RTOL = 2e-5
# phase 19, big-D feature sharding: a (data=2, model=4) mesh whose every
# cell is the card
SHARD_MESH = (2, 4)
SHARD_CG_ITERS = 30
SHARD_CG_TOL = 1e-4          # CG against CG in another order (phase 12)
# benchmarks/big_d_bench.py's largest point: N=8 agents, 128 train rows
# (183 samples at the 70/30 split), D=65536: Phi 0.27 GB
SHARD_BIG_D = dict(num_agents=8, samples_per_agent=183, num_features=65536)
SHARD_BIG_D_ITERS = 10
SHARD_BIG_D_MESHES = ((1, 4), (2, 4))
# timing windows per CG cell: the sharded CG iterations are host-bound
# at 0.2-0.5 s each, so three runs of one iteration
SHARD_RUNS = 3
# a sharded predict (psum of 4 block partials) against the unsharded one
# (cuBLAS's order), of sum_k |phi theta| per row
SHARD_PREDICT_RTOL = 1e-5
# phase 28, SHARD_MESH across ranks of a gloo group on the one card:
# (W, (w_b, w_m)) per spawn; the big-D point runs at W = RANK_BIG_D_WORLD
RANK_WORLDS = ((2, (2, 1)), (4, (2, 2)))
RANK_BIG_D_WORLD = 4
# the backends of the (2, 4) CG cell per W: at W = 4 a CG iteration takes
# 0.7-1.3 s on an H100 host (four processes on the card, ~270 gathers an
# iteration) against ~0.1 s on one process, so there the simulator's CG
# crosses the model cut in the big-D cell only
RANK_CG_BACKENDS = {2: ("simulator", "spmd"), 4: ("spmd",)}
RANK_TIMEOUT_S = 120         # every collective's limit: a lost rank fails
# phase 28's serving cells in each spawn (after the fit cells): (a) phase
# 19(c)'s resident cell and a full 1024-row bucket at every W, (c) phase
# 18's hot swap under fire and (b) phase 18(b)'s paged cell at W = 4,
# under phase 18's load
RANK_SERVE_CELLS = {2: ("resident",), 4: ("resident", "swap", "paged")}
# requests per client in those cells: cut from phase 18's 250 to keep the
# whole script inside its limit on a slow host (1110.9 s at 250 on an
# H100 80GB HBM3 host)
RANK_SERVE_REQUESTS = 100
# phases 18(a) and 19(c)'s QPS, p50 and p99 in this run, which phase 28
# prints beside its ranks' serving
SERVE_FIGURES: dict = {}
# phase 20, training: the reference's launch/train.py defaults (B=8, S=64,
# AdamW at lr 3e-3, grad_clip 1.0) at full width, 5 steps
TRAIN_BATCH = 8
TRAIN_SEQ = 64
TRAIN_STEPS = 5
TRAIN_LR = 3e-3
# the consensus strategies at full width: 2 agents, the depth cut to 2
# layers (a consensus step holds ~10 copies of the 2.89 GB per-agent tree:
# params, m, v, theta_hat, gamma, the neighbour cache, g_aug, the update)
TRAIN_AGENTS = 2
TRAIN_CONSENSUS_LAYERS = 2
TRAIN_STRATEGIES = ("dkla", "coke", "coke_et", "cta")
# (c)'s steps, which phase 29 repeats across ranks: cut from 5 to 3 so
# that phase 29 fits the script's time (PERF.md)
TRAIN_CONSENSUS_STEPS = 3
# K7's shapes: name -> (B, H, KV, S, D, window), all causal
K7_SHAPES = {"training": (8, 16, 8, 64, 128, 0),
             "prefill": (2, 16, 8, 4096, 128, 0),
             "window": (2, 16, 8, 1000, 128, 256),
             "odd length": (3, 16, 8, 77, 128, 0),
             "reduced": (8, 4, 2, 64, 64, 0)}
# (d): tests/test_system.py's coke run, card against CPU; fp32 through two
# layers with cuBLAS and K4/K7 against ATen and the plain softmax, carried
# through 20 AdamW steps, and held step by step from the CPU's state as well
# (`card_cpu_hold`)
TRAIN_SMALL_STEPS = 20
TRAIN_SMALL_RTOL = 1e-4
# (e): K7 at zamba2's shared block, Dh = Dv = 80 (the width-128 instances),
# at the training and prefill shapes: name -> (B, H, KV, S, D, window)
K7_ZAMBA2_SHAPES = {"zamba2 training": (8, 32, 32, 64, 80, 0),
                    "zamba2 prefill": (2, 32, 32, 4096, 80, 0)}
# (f): the reduced SSM model and hybrid trained card against CPU as (d)
# does, allreduce and coke at 4 agents, each (arch, config overrides):
# zamba2 also at head_dim 80, so that K7's Dh = 80 runs inside a step
TRAIN_SSM_REDUCED = (("mamba2-2.7b", {}), ("zamba2-2.7b", {}),
                     ("zamba2-2.7b", {"head_dim": 80}))
# (g): full width, allreduce at (b)'s settings, one model at a time
TRAIN_SSM_FULL = ("mamba2-2.7b", "zamba2-2.7b")
# phase 25, MoE and MLA training: (a) K7 at MLA's Dh != Dv, name -> (B, H,
# KV, S, Dh, window, Dv), all causal
K7_MLA_SHAPES = {
    "deepseek-v2-lite training": (8, 16, 16, 64, 192, 0, 128),
    "deepseek-v2-lite prefill": (2, 16, 16, 4096, 192, 0, 128),
    "minicpm3 training": (8, 40, 40, 64, 96, 0, 64),
    "minicpm3 prefill": (2, 40, 40, 4096, 96, 0, 64),
    "reduced MLA": (2, 4, 4, 96, 48, 0, 32)}
# (b) the reduced families trained card against CPU as phase 20(f) does, B=8
# at S=96: past Mixtral's reduced window of 64, so that K7's window path
# runs inside a step, and each agent's 2 x 96 tokens fill three MoE groups
# of 64. The hold is step by step, so 8 steps hold what 20 would.
TRAIN_MOE_MLA_REDUCED = ("granite-3-8b", "mixtral-8x7b", "minicpm3-4b",
                         "deepseek-v2-lite-16b")
TRAIN_MOE_MLA_SEQ = 96
TRAIN_MOE_MLA_STEPS = 8
# (b)'s step-by-step hold: the card's loss from the CPU's state read
# 6.6e-8 to 1.548e-6 of the CPU's in sound runs (NVIDIA H100 80GB HBM3)
TRAIN_MOE_MLA_RTOL = 1e-5
# (c) full width, allreduce at phase 20(b)'s settings, one model at a time,
# the depth cut to what one card holds: (arch, layers kept). An AdamW step
# peaks at ~9x the fp32 weights (qwen3-1.7b: 62.30 GB over 6.9 GB)
TRAIN_MOE_MLA_FULL = (("deepseek-v2-lite-16b", 2), ("minicpm3-4b", 16),
                      ("mixtral-8x7b", 1))
TRAIN_PEAK_PER_WEIGHT = 9.0
# phase 21, a mesh under gossip and personalization, on SHARD_MESH: the CG
# gossip cells' depth (a sharded CG iteration takes ~90 ms, host-bound),
# the personalized cells' (phase 17's warmup 30 and every 5: refreshes at
# 31, 36 and 41), and theta against the unsharded run of the same cell
MESH_GOSSIP_ITERS = 15
MESH_PZ_ITERS = 41
MESH_THETA_TOL = 1e-4
# phase 26, the VLM prefix and enc-dec serving: (a) K4 at the slice's
# shapes, (what, B, Sq, Sk, H, KV, Dh = Dv, causal): internvl2-1b's prefill
# of 256 patch rows + 3840 tokens (14 query heads over 2 KV heads);
# seamless-m4t-medium's encoder over 2048 frames (no mask), its decoder's
# self attention over 2048 tokens, and the cross attention of a 256-token
# output over 2048 frames (no mask, Sq != Sk)
MM_K4_SHAPES = (("internvl2-1b prefill", 2, 4096, 4096, 14, 2, 64, True),
                ("seamless encoder", 2, 2048, 2048, 16, 16, 64, False),
                ("seamless decoder self", 2, 2048, 2048, 16, 16, 64, True),
                ("seamless cross", 2, 256, 2048, 16, 16, 64, False))
# (b) the reduced models card against CPU: the VLM's prompts, shorter and
# longer than its 8-row prefix; the enc-dec model's frames and prompt
MM_REDUCED_VLM_PROMPTS = (5, 96)
MM_REDUCED_FRAMES = 64
MM_REDUCED_PROMPT = 24
# (c) internvl2-1b at full width: (batch, patch rows, text tokens), the
# split of 4096 by src/repro/configs/shapes.py::_token_specs
MM_VLM = (2, 256, 3840)
# (d) seamless-m4t-medium at full width: (batch, frames, decoder tokens),
# _token_specs' even split of 4096; the generate's prompt tokens
MM_ENCDEC = (2, 2048, 2048)
MM_ENCDEC_PROMPT = 8
# phase 27, the VLM and the enc-dec model trained: (a) K7, and K4 with the
# log-sum-exp it reads, at the slice's shapes, (what, B, Sq, Sk, H, KV,
# Dh = Dv, causal, timed): internvl2-1b's 256 + 3840 rows (groups of 7);
# seamless-m4t-medium's encoder (no mask) and decoder self attention over
# 2048, its cross attention both ways (the training split of 4096 gives a
# square one, so these hold the Sq != Sk limits), and ragged lengths on no
# tile boundary
MM_K7_SHAPES = (
    ("internvl2-1b", 2, 4096, 4096, 14, 2, 64, True, True),
    ("seamless encoder", 2, 2048, 2048, 16, 16, 64, False, True),
    ("seamless decoder self", 2, 2048, 2048, 16, 16, 64, True, True),
    ("cross, Sq < Sk", 2, 256, 2048, 16, 16, 64, False, True),
    ("cross, Sq > Sk", 2, 2048, 256, 16, 16, 64, False, True),
    ("ragged, Sq < Sk", 1, 200, 1000, 14, 2, 64, False, False),
    ("ragged, Sq > Sk", 1, 1000, 200, 14, 2, 64, False, False))
# (b) the reduced pair card against CPU as phase 25(b) does: the VLM with
# 14 query heads over 2 KV heads (K7 sums groups of 7) on its 8 patch rows
# + 88 tokens; the enc-dec model on 80 frames + 48 tokens (the cross
# attention at Sq < Sk, neither on a tile boundary)
MM_TRAIN_VLM_HEADS = (14, 2)
MM_TRAIN_VLM_TOKENS = 88
MM_TRAIN_ENC = (80, 48)
# (c) full width at configs/shapes.py's train_4k split of 4096 (256 patch
# rows + 3840 tokens; 2048 frames + 2048 tokens), its global batch of 256
# cut to 2 for one card, AdamW at phase 20's settings, 5 steps
MM_TRAIN_BATCH = 2
# phase 29, the trainer's agents on their own ranks: phase 20(c)'s runs of
# these strategies (its full-width 2-layer model, seeds, batches and
# ConsensusConfig, TRAIN_AGENTS agents) on TRAIN_RANK_WORLD gloo ranks of
# this card, one agent a rank, held to 20(c)'s one-process runs
# (TRAIN_YARDSTICK): comms and send_frac equal, losses within
# TRAIN_RANK_RTOL relative, each parameter leaf's largest magnitude within
# TRAIN_RANK_RTOL of 20(c)'s and every TRAIN_RANK_STRIDE-th element within
# TRAIN_RANK_RTOL of it. 20(c) keeps that sample (1/61 of 2 x 2.89 GB a
# strategy) in shared host memory: the whole parameters would take ~42 s
# to copy there (~1.9 s a GB into shared memory, ~0.55 s a GB off the
# card, on an H100 host: PERF.md). Then allreduce over the ranks,
# bitwise a one-process run with microbatches = TRAIN_RANK_WORLD (every
# parameter leaf's `fingerprint`: the card has no room beside the ranks for
# that run's parameters)
TRAIN_RANK_STRATEGIES = ("coke", "cta", "coke_et")
TRAIN_RANK_WORLD = 2
TRAIN_RANK_RTOL = 1e-5
TRAIN_RANK_STRIDE = 61
TRAIN_YARDSTICK: dict = {}
KERNEL_SOURCES = {   # name -> (port source, TPU kernel it replaces)
    "coke_megastep": ("src/repro_torch/csrc/coke_megastep.cu",
                      "src/repro/kernels/coke_update/coke_update.py:243"),
    "rff_cos_bias": ("src/repro_torch/csrc/rff.cu",
                     "src/repro/kernels/rff/rff.py:51"),
    "coke_fused_update": ("src/repro_torch/csrc/coke_fused_update.cu",
                          "src/repro/kernels/coke_update/coke_update.py:81"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/"
                        "flash_attention.py:97"),
    # no Pallas kernel: the reference draws inside XLA
    "threefry": ("src/repro_torch/csrc/threefry.cu",
                 "src/repro/core/step.py:79 (jax.random.uniform inside "
                 "XLA; no Pallas kernel)"),
    # no Pallas kernel: the reference gathers and row-dots inside XLA
    "gather_rowdot": ("src/repro_torch/csrc/gather_rowdot.cu",
                      "src/repro/serve/kernel_server.py:164-169 (einsum "
                      "over stack[slots] inside XLA; no Pallas kernel)"),
    # no Pallas kernel: the reference differentiates blockwise_attention
    # inside XLA
    "flash_attention_bwd": ("src/repro_torch/csrc/flash_attention_bwd.cu",
                            "src/repro/train/steps.py:38 (jax.value_and_"
                            "grad through blockwise_attention inside XLA; "
                            "no Pallas kernel)"),
}

# every kernel wrapper's launch count: name -> (module, attribute)
LAUNCH_COUNTERS = {
    "coke_megastep": ("repro_torch.kernels.coke_update.coke_update",
                      "LAUNCHES"),
    "rff_cos_bias": ("repro_torch.kernels.rff.rff", "LAUNCHES"),
    "coke_fused_update": ("repro_torch.kernels.coke_update.coke_update",
                          "FUSED_UPDATE_LAUNCHES"),
    "flash_attention": ("repro_torch.kernels.flash_attention."
                        "flash_attention", "LAUNCHES"),
    "threefry": ("repro_torch.kernels.threefry.threefry", "LAUNCHES"),
    "gather_rowdot": ("repro_torch.kernels.rowdot.rowdot", "LAUNCHES"),
    "flash_attention_bwd": ("repro_torch.kernels.flash_attention."
                            "flash_attention_bwd", "LAUNCHES"),
}


def reset_counts():
    """Set every kernel wrapper's launch count to 0."""
    for module, attr in LAUNCH_COUNTERS.values():
        setattr(importlib.import_module(module), attr, 0)


def counts():
    """Every kernel wrapper's launch count, by kernel name."""
    return {name: getattr(importlib.import_module(module), attr)
            for name, (module, attr) in LAUNCH_COUNTERS.items()}


def full_width_config():
    """Phase 4's full-width cell, which phase 18 serves from: N = 20 ring,
    SAMPLES rows per agent, D = FEATURES, the megakernel path."""
    from repro_torch.api import PAPER_SETUPS, FitConfig
    krr = dataclasses.replace(PAPER_SETUPS["synthetic"],
                              samples_per_agent=SAMPLES,
                              num_features=FEATURES)
    return FitConfig(krr=krr, backend="fused", graph="ring",
                     primal="gradient", num_iters=ITERS)


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def card_peaks(name):
    for frag, bw, flops, bf16, tf32 in CARD_PEAKS:
        if frag in name:
            return bw, flops, bf16, tf32
    raise RuntimeError(f"no data-sheet peaks for {name!r}: add them to "
                       "CARD_PEAKS before quoting a bound")


def time_ms(fn, reps=10, runs=7, warmup=3):
    """Median over `runs` of the mean time of `reps` calls, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / reps)
    return statistics.median(out)


def graph_ms(fn, reps=100, runs=7):
    """Device time of one call of `fn`: `reps` calls captured in one CUDA
    graph, replayed, median over `runs` (CUDA events). For a call whose
    host side (Python, allocation, launch) outlasts its device work, which
    `time_ms` would measure instead."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):      # warm-up off the capture
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return time_ms(graph.replay, reps=1, runs=runs, warmup=1) / reps


def flushed_ms(fn, flush, reps=50, warmup=3, clean=False):
    """Median device time of one call of `fn` with a cold L2: `flush`, a
    buffer larger than the L2, is written before each call, and CUDA events
    are recorded around the call alone. The write leaves the L2 full of
    dirty lines, which the call's reads then evict to memory; `clean` also
    reads the buffer back after writing it, so that the lines the call
    evicts are clean. A sleep kernel holds the device while the host
    enqueues every call, so that no pair of events brackets the host's own
    time between a flush and the call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(HOLD_CYCLES)
    marks = []
    for _ in range(reps):
        flush.zero_()
        if clean:
            flush.sum()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        marks.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in marks)


def host_call_ms(fn, calls=1000):
    """The host's time to make one call of `fn` (perf_counter over `calls`
    calls, no synchronisation between them)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    out = (time.perf_counter() - t0) * 1e3 / calls
    torch.cuda.synchronize()
    return out


def device_ms(e):
    """The device time (ms) of a torch.profiler key_averages() row."""
    us = getattr(e, "self_device_time_total", None)
    return (e.self_cuda_time_total if us is None else us) / 1e3


def profiled_kernels(fn, calls=20):
    """[(device ms per call, launches per call, kernel name)] of every
    kernel that `calls` calls of `fn` launch, by torch.profiler (device
    activity only); empty where the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sorted(((device_ms(e) / calls, e.count / calls, e.key)
                   for e in prof.key_averages()
                   if getattr(e, "device_type", None)
                   == torch.autograd.DeviceType.CUDA and device_ms(e) > 0),
                  reverse=True)


def paired_ms(fn, calls, runs=7, warmup=2):
    """(device ms, host ms) per call of the `calls` that `fn` makes, both
    from one window (medians over `runs`): CUDA events recorded on either
    side of `fn`, and perf_counter around the host's enqueue of the same
    work. The device cannot finish before the host has enqueued the last
    launch, so device >= host; where the two are close, the device waits
    on the host."""
    for _ in range(warmup):
        fn()
    dev, host = [], []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        host.append((time.perf_counter() - t0) * 1e3 / calls)
        end.synchronize()
        dev.append(start.elapsed_time(end) / calls)
    return statistics.median(dev), statistics.median(host)


def hmma_count(library):
    """{opcode: count} of the tensor-core instructions (HMMA.*) in a built
    library's SASS, by `cuobjdump -sass`."""
    import collections
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(library)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    return dict(collections.Counter(
        tok.rstrip(";") for line in sass.splitlines()
        for tok in line.split() if tok.startswith("HMMA")))


def k7_phase1(build):
    """Phase 1's hold of K7: every instance's ptxas report (registers,
    spills) beside its dynamic shared memory and blocks per SM (occupancy
    API); no instance may spill, and the SASS must hold K7_HMMA."""
    import re
    from repro_torch.kernels.flash_attention import flash_attention_bwd as k7
    report = build.build(("flash_attention_bwd",))["flash_attention_bwd"]
    ptxas = ptxas_report(report["log"])
    spilled = []
    for fn, props in ptxas.items():
        log(1, f"  K7 ptxas {fn}: {props or 'no report'}")
        if re.search(r"[1-9]\d* bytes spill (stores|loads)", props):
            spilled.append(fn)
    pairs = [((w, w), ins) for w, ins in k7.INSTANCES.items()]
    for (wh, wv), instances in pairs + list(k7.PAIR_INSTANCES.items()):
        for rw, cw, ns in instances:
            for kvp in (True, False):
                _, _, smem, blocks = k7.pass_limits(wh, wv, kvp, rw, cw,
                                                    ns)
                log(1, f"  K7 {'dK/dV' if kvp else 'dQ'}<width "
                       f"{wh if wh == wv else f'{wh}/{wv}'}, {rw}x{cw} "
                       f"warps, ns={ns}>: {smem} B of shared memory, "
                       f"{blocks} block(s) per SM")
    if spilled or not any("bwd_kernel" in line for line in
                          report["log"].splitlines()):
        raise AssertionError(f"K7 spills in {spilled}, or its ptxas report "
                             "is missing")
    hmma = hmma_count(build.library_path("flash_attention_bwd"))
    log(1, f"flash_attention_bwd SASS tensor-core instructions (cuobjdump "
           f"-sass): {hmma}")
    if not hmma.get(K7_HMMA, 0):
        raise AssertionError(f"the flash_attention_bwd library lacks "
                             f"{K7_HMMA} (found {hmma}): K7 does not run on "
                             "the tensor cores")


def k1_sass_counts(sass):
    """Instructions a thread issues per output on the cosine's fast path,
    in the SASS of K1's bulk instance for d = 5 (`cuobjdump -sass` text,
    where the loop over k is unrolled), as a line of text.

    Each fast-path cosine adds the 1.5 * 2^23 shifter once (`FADD ...,
    12582912`), so those count a step's outputs. The unit loop is the
    innermost loop holding them; its largest forward branch skips cosf's
    fallback."""
    import re
    body = next(p for p in sass.split("Function : ")[1:]
                if "rff_strip_kernelILb1ELi5E" in p.split("\n", 1)[0])
    ins = [(int(m.group(1), 16), m.group(2)) for m in (
        re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        for line in body.splitlines()) if m]
    shift = [a for a, t in ins if re.search(r"FADD\b.*, 12582912$", t)]
    jumps = [(a, int(m.group(1), 16)) for a, t in ins
             for m in [re.search(r"\bBRA\S*\s+.*?0x([0-9a-f]+)", t)] if m]
    lo, hi = min(((t, a) for a, t in jumps
                  if t <= shift[0] and shift[-1] <= a),
                 key=lambda r: r[1] - r[0])
    skip = max(((a, t) for a, t in jumps if lo <= a < t <= hi),
               key=lambda r: r[1] - r[0])
    fast = [t for a, t in ins if lo <= a <= hi and not skip[0] < a < skip[1]]
    ffma = sum(1 for t in fast if re.search(r"\bFFMA\b", t))
    return (f"{len(fast) / len(shift):.2f} instructions per output on the "
            f"fast path at d=5 ({len(fast)} per step of {len(shift)} "
            f"outputs, {ffma / len(shift):.2f} of them FFMA)")


def k5_sass_counts(sass):
    """(instructions per output word, text) in the SASS of K5's uniform
    instance: the grid-stride loop is the widest backward branch; every
    instruction in it but the stores counts, divided by the words a trip
    stores."""
    import re
    body = next(p for p in sass.split("Function : ")[1:]
                if "threefry_kernelILb1E" in p.split("\n", 1)[0])
    ins = [(int(m.group(1), 16), m.group(2)) for m in (
        re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        for line in body.splitlines()) if m]
    back = [(int(m.group(1), 16), a) for a, t in ins
            for m in [re.search(r"\bBRA\S*\s+.*?0x([0-9a-f]+)", t)]
            if m and int(m.group(1), 16) <= a]
    lo, hi = max(back, key=lambda r: r[1] - r[0])
    loop = [t.split()[1] if t.startswith("@") else t.split()[0]
            for a, t in ins if lo <= a <= hi]
    words = sum(1 for op in loop if op.startswith("STG"))
    ops = [op for op in loop if not op.startswith(("STG", "NOP"))]
    per = len(ops) / words
    kinds = {}
    for op in ops:
        kinds[op.split(".")[0]] = kinds.get(op.split(".")[0], 0) + 1
    return per, (f"{per:.1f} instructions per word in the grid-stride loop "
                 f"({len(ops)} per trip of {words} word(s): {kinds})")


def k4_plan(build, dh, dv, dtype):
    """K4's launch plan for (Dh, Dv, dtype) on this card, from the C entry
    `flash_attention_plan`: (query rows per block, keys per staged tile,
    cp.async stages, shared-memory bytes, blocks per SM)."""
    import ctypes
    lib = build.load("flash_attention", {"flash_attention_plan": (
        ctypes.c_int, [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)])})
    out = (ctypes.c_int * 5)()
    build.check(lib, lib.flash_attention_plan(
        dh, dv, 0 if dtype == torch.float32 else 1, out),
        "flash_attention_plan")
    return tuple(out)


def k4_bound(nbytes, flops, dtype, peaks):
    """(ms, by, how) of K4's bound: the larger of the bytes over the memory
    rate and the operations over the rate of the cheapest way the card has
    to do them. bf16: the bf16 tensor cores. fp32: the least of the CUDA
    cores and 3xTF32 (three TF32 MMAs per product, fp32-level accuracy)."""
    bw, fp32, bf16, tf32 = peaks
    t_b = nbytes / bw * 1e3
    if dtype == torch.float32:
        t_f, how = min((flops / fp32 * 1e3, f"fp32 CUDA cores at "
                        f"{fp32 / 1e12:g} TFLOP/s"),
                       (3 * flops / tf32 * 1e3, f"3xTF32, 3 x the flops at "
                        f"{tf32 / 1e12:g} TFLOP/s"))
    else:
        t_f, how = flops / bf16 * 1e3, f"bf16 at {bf16 / 1e12:g} TFLOP/s"
    if t_b >= t_f:
        return t_b, "bytes", f"{bw / 1e12:g} TB/s"
    return t_f, "operations", how


def sdpa_ms(q, k, v, *, causal, mask=None):
    """(ms, how) of one torch.nn.functional.scaled_dot_product_attention
    call on q (B, H, S, Dh), k/v (B, KV, S, *): the library yardstick of K4,
    timed here and called nowhere in the port. Takes the first backend of
    flash, efficient and cuDNN that runs the call (math too where its S^2
    scores fit), with grouped heads through enable_gqa or, where a backend
    refuses that, with K and V repeated H/KV times before the timed call."""
    import warnings
    from torch.nn.attention import SDPBackend, sdpa_kernel
    H, KV = q.shape[1], k.shape[1]
    scores = 4.0 * q.shape[0] * H * q.shape[2] * k.shape[2]
    backends = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                SDPBackend.CUDNN_ATTENTION]
    if 3 * scores < 20e9:
        backends.append(SDPBackend.MATH)
    refused = []
    for backend in backends:
        for gqa in ((True, False) if H != KV else (False,)):
            kk, vv = k, v
            if H != KV and not gqa:
                kk = k.repeat_interleave(H // KV, dim=1)
                vv = v.repeat_interleave(H // KV, dim=1)

            def call():
                with sdpa_kernel([backend]):
                    return torch.nn.functional.scaled_dot_product_attention(
                        q, kk, vv, attn_mask=mask,
                        is_causal=causal and mask is None, enable_gqa=gqa)

            try:
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    call()
                    torch.cuda.synchronize()
            except RuntimeError as e:          # includes OutOfMemoryError
                refused.append(f"{backend.name}{' enable_gqa' if gqa else ''}"
                               f": {str(e).splitlines()[0][:60]}")
                continue
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                ms = time_ms(call, reps=1, runs=3, warmup=1)
            heads = ("H = KV" if H == KV else "enable_gqa" if gqa
                     else f"K/V repeated {H // KV}x before the call")
            mask_how = ("boolean mask" if mask is not None
                        else "is_causal" if causal else "no mask")
            return ms, (f"backend {backend.name}, {heads}, {mask_how}"
                        + (f"; refused: {refused}" if refused else ""))
    raise RuntimeError(f"no SDPA backend ran the call: {refused}")


def ptxas_report(nvcc_log):
    """{kernel: "N registers, spill line"} from nvcc's -Xptxas -v output,
    K2's stream-kernel instances named by their template arguments
    (V float4 column groups per thread, R rows per stage, bulk or cp.async
    staging), K1's by its store path (TMA bulk stores or 4-byte stores),
    K3's by its load width, neighbour reads and loads in flight (U) and
    K7's by its pass, head-dim widths (Dh's / Dv's where they differ),
    warps (rw x cw) and n8 tiles (ns),
    K4's by its MMA policy, m16 tiles per warp (MT), 64-column output
    groups (NJ) and whether it writes the log-sum-exp. Empty when the
    library came from the build cache."""
    import re
    out, fn = {}, None
    for line in nvcc_log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = m.group(1)
            t = re.search(r"megastep_stream_kernelILi(\d+)ELi(\d+)ELb([01])E",
                          fn)
            k1 = re.search(r"rff_strip_kernelILb([01])ELi(\d+)E", fn)
            k3 = re.search(r"coke_fused_update_kernelI(6float4|f)Lb([01])ELi"
                           r"(\d+)E", fn)
            k7 = re.search(r"bwd_kernelILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)ELi"
                           r"(\d+)ELb([01])E", fn)
            k4 = re.search(r"flash_attention_kernelI\w*?(Bf16|Tf32x3)E"
                           r"Li(\d+)ELi(\d+)ELb([01])E", fn)
            if t:
                fn = (f"stream<V={t.group(1)}, R={t.group(2)}, "
                      f"{'bulk' if t.group(3) == '1' else 'cp.async'}>")
            elif k1:
                d = "any d" if k1.group(2) == "0" else f"d={k1.group(2)}"
                fn = f"rff<{'bulk' if k1.group(1) == '1' else '4-byte'}, {d}>"
            elif k3:
                width = "4-byte" if k3.group(1) == "f" else "16-byte"
                reads = "one" if k3.group(2) == "1" else "two"
                fn = (f"coke_fused_update<{width}, {reads} neighbour "
                      f"read(s), U={k3.group(3)}>")
            elif k7:
                wh, wv = k7.group(1), k7.group(2)
                fn = (f"{'dK/dV' if k7.group(6) == '1' else 'dQ'}<width "
                      f"{wh if wh == wv else f'{wh}/{wv}'}, {k7.group(3)}x"
                      f"{k7.group(4)} warps, ns={k7.group(5)}>")
            elif k4:
                fn = (f"K4<{k4.group(1)}, MT={k4.group(2)}, NJ={k4.group(3)}"
                      f"{', LSE' if k4.group(4) == '1' else ''}>")
            elif "combine_kernel" in fn:
                fn = "combine"
            out[fn] = ""
        elif fn is not None and ("spill" in line or "registers" in line):
            out[fn] = (out[fn] + "; " if out[fn] else "") + line.strip()
    return out


def k1_tolerance(x, omega, num_features=None):
    """1e-6 absolute on phi, or 16 ulps of the largest |x @ omega| times
    sqrt(2/L) where that is larger: the kernel's fmaf chain and cuBLAS
    round the d-term projection differently, and cos passes that on. L is
    num_features for a feature block of a wider map."""
    L = omega.shape[1] if num_features is None else num_features
    proj = float((x.abs() @ omega.abs()).max())
    return max(1e-6, math.sqrt(2.0 / L) * 16 * 2**-23 * proj)


def k3_tolerance(theta, hat, gamma, grad, left, right, rho, deg):
    """K3_ULPS of the largest term of g_aug."""
    terms = (grad, 2.0 * rho * deg * theta, gamma,
             rho * (deg * hat + left + right))
    return K3_ULPS * max(float(t.abs().max()) for t in terms)


def check_history(tag, h, iters):
    for k, v in h.items():
        if v.shape != (iters,) or not torch.isfinite(
                v.to(torch.float64)).all():
            raise AssertionError(f"{tag}: history {k} is not {iters} finite "
                                 "values")


def simulator_phase(dev, problem, krr, card, bw, fp32, reset_counts, counts):
    """Phase 12: the simulator backend and the exact primals. `problem` is
    phase 4's big-D problem (its Phi is not copied); `krr` its KRRConfig.
    Every launch counter is set to 0 before each part and must stay there
    over its fits (the simulator and the CG primal run no kernel); the
    deploy step after (a) must launch K1."""
    from repro_torch.api import FitConfig, build_problem, fit, get_solver
    from repro_torch.api.backends import (_resolve_consensus_primal,
                                          consensus_runner)
    from repro_torch.api.config import SolveContext
    from repro_torch.api.fit import _simulator_runner
    from repro_torch.core import admm

    def no_launches(what):
        c = counts()
        if any(c.values()):
            raise AssertionError(f"{what} launched kernels: {c}")

    def theta_err(a, b):
        return float((a.double().cpu() - b.double().cpu()).abs().max())

    def pair(d_h):
        return f"{d_h[0]:.4f} ms on the device / {d_h[1]:.4f} ms host enqueue"

    # ---- (a) the paper's own call: fit(FitConfig(algorithm=alg)) --------
    reset_counts()
    paper = build_problem(FitConfig(), device=dev)
    pp = paper.problem
    n, t, d = pp.feats.shape
    p_cpu = pp.to("cpu")
    p64 = dataclasses.replace(pp, feats=pp.feats.double(),
                              labels=pp.labels.double(),
                              adjacency=pp.adjacency.double())
    fits, coke_fit = {}, None
    for alg in ("coke", "dkla", "cta", "ridge_oracle"):
        c = FitConfig(algorithm=alg, record_oracle_distance=True)
        if alg == "ridge_oracle":
            c = c.replace(num_iters=1)
        t0 = time.perf_counter()
        gpu = fit(c, problem=pp, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        cpu = fit(c, problem=p_cpu, device="cpu")
        f64 = fit(c, problem=p64, device=dev)
        iters = c.resolved_iters
        h = {k: v.cpu() for k, v in gpu.history.items()}
        check_history(f"simulator {alg}", h, iters)
        if set(h) != set(cpu.history):
            raise AssertionError(f"simulator {alg}: history keys differ "
                                 "between card and CPU")
        for k in ("comms", "bits"):
            if not torch.equal(h[k], cpu.history[k]):
                raise AssertionError(f"simulator {alg}: {k} differs between "
                                     "card and CPU")
        e_card = theta_err(gpu.theta, f64.theta)
        e_cpu = theta_err(cpu.theta, f64.theta)
        e_cc = theta_err(gpu.theta, cpu.theta)
        e_mse = float(((h["train_mse"] - cpu.train_mse).abs()
                       / cpu.train_mse.abs()).max())
        same64 = torch.equal(f64.comms.cpu(), cpu.comms)
        log(12, f"paper {alg} (N={n} Erdos-Renyi p=0.3, T={t}, L={d}, "
                f"{iters} iteration(s)) on the card in {wall:.2f} s wall "
                f"(first call): comms {int(h['comms'][-1])}/{n * iters}, "
                f"bits {float(h['bits'][-1]):.0f}, both equal the CPU's "
                f"(and the float64 run's: {same64}); train_mse "
                f"{float(h['train_mse'][0]):.6f} -> "
                f"{float(h['train_mse'][-1]):.6f} (card vs CPU rtol "
                f"{e_mse:.2e}, tol {SIM_MSE_RTOL:g}); theta max|err| card vs "
                f"CPU {e_cc:.3e}, card vs float64 {e_card:.3e}, CPU vs "
                f"float64 {e_cpu:.3e} ("
                + ("not held: one fp32 solve at condition ~1e5"
                   if alg == "ridge_oracle" else
                   f"the card held within {SIM_F64_FACTOR:g}x the CPU's + "
                   f"{SIM_F64_SLACK:g}") + ")")
        # the oracle is one fp32 solve at lam=5e-5 (condition ~1e5): its
        # theta carries ~2e-2 of rounding in the weakest directions, which
        # its train MSE does not see; it is held by the MSE and the comms
        close = e_card <= SIM_F64_FACTOR * e_cpu + SIM_F64_SLACK
        if not ((close or alg == "ridge_oracle") and e_mse <= SIM_MSE_RTOL):
            raise AssertionError(f"simulator {alg}: the card's fit is further "
                                 "from the float64 run than the CPU's allows")
        if alg != "ridge_oracle":
            dist = h["dist_to_oracle"]
            log(12, f"paper {alg}: dist_to_oracle {float(dist[0]):.4f} -> "
                    f"{float(dist[-1]):.4f}")
            if not dist[-1] < dist[0]:
                raise AssertionError(f"simulator {alg}: dist_to_oracle did "
                                     "not shrink")
        fits[alg] = h
        if alg == "coke":
            coke_fit = gpu
    no_launches("the simulator's paper fits")
    coke, dkla = fits["coke"], fits["dkla"]
    ratio = float(coke["train_mse"][-1]) / float(dkla["train_mse"][-1])
    log(12, f"paper: COKE sent {int(coke['comms'][-1])} broadcasts against "
            f"DKLA's {int(dkla['comms'][-1])}, final train_mse "
            f"{float(coke['train_mse'][-1]):.6f} against "
            f"{float(dkla['train_mse'][-1]):.6f} ({ratio:.4f}x; held at "
            f"<= {SIM_COKE_MSE_RATIO}x, the reference gives 1.028x)")
    if not (int(coke["comms"][-1]) < int(dkla["comms"][-1]) == n * 1000
            and ratio <= SIM_COKE_MSE_RATIO):
        raise AssertionError("COKE did not save broadcasts at DKLA's "
                             "accuracy on the paper's setup")
    model = coke_fit.to_model(paper.rff_params)
    before = counts()["rff_cos_bias"]
    ev = model.evaluate(paper.x_test, paper.y_test, backend="fused")
    ev_ref = model.evaluate(paper.x_test, paper.y_test, backend="ref")
    torch.cuda.synchronize()
    if not counts()["rff_cos_bias"] > before:
        raise AssertionError("the simulator fit's deploy did not launch K1")
    log(12, f"paper coke deployed: test_mse {ev['test_mse']:.6f} (fused, "
            f"K1) / {ev_ref['test_mse']:.6f} (ref)")
    if not math.isclose(ev["test_mse"], ev_ref["test_mse"], rel_tol=1e-4):
        raise AssertionError("the simulator fit's fused and ref test MSE "
                             "differ")

    # ---- (b) the CG primal at phase 4's big-D point -----------------------
    reset_counts()
    N, T, D = problem.feats.shape
    big_cfg = FitConfig(krr=krr, graph="ring", algorithm="coke",
                        num_iters=SIM_BIG_D_ITERS)
    ctx = SolveContext.from_config(big_cfg.replace(primal="auto"))
    resolved = (get_solver("coke")._primal_mode(problem, ctx),
                _resolve_consensus_primal(big_cfg.replace(primal="auto"),
                                          problem, "coke"))
    if resolved != ("cg", "cg"):
        raise AssertionError(f"primal='auto' at D={D} resolved to {resolved}")
    big = {}
    for primal in ("cg", "auto"):
        for backend in ("simulator", "spmd", "fused"):
            t0 = time.perf_counter()
            r = fit(big_cfg.replace(primal=primal, backend=backend),
                    problem=problem, device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            h = {k: v.cpu() for k, v in r.history.items()}
            check_history(f"big-D {primal} {backend}", h, SIM_BIG_D_ITERS)
            big[(primal, backend)] = (r, h)
            log(12, f"big-D COKE primal={primal} on {backend} (N={N} ring, "
                    f"T={T}, D={D}, {SIM_BIG_D_ITERS} iterations) in "
                    f"{wall:.2f} s wall: comms {int(h['comms'][-1])}/"
                    f"{N * SIM_BIG_D_ITERS}, train_mse "
                    f"{float(h['train_mse'][0]):.5f} -> "
                    f"{float(h['train_mse'][-1]):.5f}")
    no_launches("the big-D CG fits")
    ref_r, ref_h = big[("cg", "simulator")]
    for (primal, backend), (r, h) in big.items():
        for k in ("comms", "bits"):
            if not torch.equal(h[k], ref_h[k]):
                raise AssertionError(f"big-D {primal} {backend}: {k} differs "
                                     "from the simulator's CG fit")
        e = theta_err(r.theta, ref_r.theta)
        log(12, f"big-D {primal} {backend} against simulator cg: comms/bits "
                f"equal, theta max|err| {e:.3e} (tol {SIM_CG_BACKEND_TOL:g})")
        if not e <= SIM_CG_BACKEND_TOL:
            raise AssertionError(f"big-D {primal} {backend}: theta differs")

    # ---- (c) Cholesky against CG at the crossover D -----------------------
    reset_counts()
    cross_cfg = FitConfig(krr=dataclasses.replace(
        krr, num_features=SIM_CROSSOVER_D), graph="ring", algorithm="coke",
        num_iters=SIM_BIG_D_ITERS)
    cross = build_problem(cross_cfg, device=dev).problem
    if admm.resolve_primal("auto", SIM_CROSSOVER_D, "quadratic") != \
            "cholesky":
        raise AssertionError("primal='auto' at the crossover is not Cholesky")
    chol = fit(cross_cfg.replace(primal="cholesky"), problem=cross,
               device=dev)
    cg = fit(cross_cfg.replace(primal="cg"), problem=cross, device=dev)
    torch.cuda.synchronize()
    no_launches("the crossover fits")
    e = theta_err(chol.theta, cg.theta)
    same = torch.equal(chol.comms, cg.comms)
    log(12, f"crossover D={SIM_CROSSOVER_D} (Phi "
            f"{cross.feats.numel() * 4 / 1e9:.3f} GB, factors "
            f"{N * SIM_CROSSOVER_D ** 2 * 4 / 1e9:.3f} GB): Cholesky against "
            f"CG, comms equal {same} ({int(chol.comms[-1])}), theta max|err| "
            f"{e:.3e} (tol {SIM_CHOL_CG_TOL:g})")
    if not (same and e <= SIM_CHOL_CG_TOL):
        raise AssertionError("Cholesky and CG differ at the crossover")

    # ---- times ------------------------------------------------------------
    def sim_chunks(cfg, prob):
        state0, chunk_fn, _ = _simulator_runner(
            get_solver(cfg.algorithm), prob, SolveContext.from_config(cfg),
            None)
        st = {"s": chunk_fn(state0, 2)[0]}

        def run(k):
            def f():
                st["s"] = chunk_fn(st["s"], k)[0]
            return f
        return run

    def ring_chunks(cfg, prob):
        carry0, chunk_fn, _ = consensus_runner(
            cfg, get_solver(cfg.algorithm), prob,
            SolveContext.from_config(cfg), None)
        st = {"c": chunk_fn(carry0, 1)[0]}

        def run(k):
            def f():
                st["c"] = chunk_fn(st["c"], k)[0]
            return f
        return run

    def bound(nbytes, flops):
        t_b, t_f = nbytes / bw * 1e3, flops / fp32 * 1e3
        return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")

    def with_bound(what, d_h, nbytes, flops):
        b_ms, by = bound(nbytes, flops)
        log(12, f"[{card}] {what}: {pair(d_h)}; bound {b_ms:.4f} ms ({by}: "
                f"{nbytes / 1e9:.4f} GB, {flops / 1e9:.3f} GFLOP; "
                f"{b_ms / d_h[0]:.1%} of it)")

    # a Cholesky iteration reads Phi once for the train MSE and the factor
    # stack twice (two triangular solves); Phi'y is hoisted out of the loop
    traced = []      # (what, fn, iterations per call, (device, host) ms)
    for what, prob, cfg in (
            ("paper shape", pp, FitConfig(algorithm="coke")),
            (f"D={SIM_CROSSOVER_D}", cross,
             cross_cfg.replace(primal="cholesky"))):
        nn, tt, dd = prob.feats.shape
        fn = sim_chunks(cfg, prob)(10)
        d_h = paired_ms(fn, 10)
        if prob is pp:
            traced.append((f"ten simulator Cholesky iterations at N={nn} "
                           f"T={tt} D={dd}", fn, 10, d_h))
        with_bound(f"one simulator COKE Cholesky iteration at N={nn} T={tt} "
                   f"D={dd} (chunks of ten)", d_h,
                   4.0 * (nn * tt * dd + 2 * nn * dd * dd),
                   2.0 * nn * tt * dd + 4.0 * nn * dd * dd)
    nn, tt, dd = cross.feats.shape
    d_h = paired_ms(lambda: admm._ridge_factors(cross), 1, runs=3, warmup=1)
    with_bound(f"the one-off factorization at N={nn} T={tt} D={dd} (the "
               "Gram per agent in fp32, then torch.linalg.cholesky)", d_h,
               4.0 * (nn * tt * dd + nn * dd * dd),
               2.0 * nn * tt * dd * dd + nn * dd ** 3 / 3.0)
    # a CG iteration reads Phi twice per operator pass: 64 passes, one for
    # r0 = b - A x0, then once for the train MSE; Phi'y and the Jacobi
    # diagonal are made once per fit
    reads = 2 * (big_cfg.cg_maxiter + 1) + 1
    for backend, runner in (("simulator", sim_chunks),
                            ("spmd", ring_chunks)):
        cfg = big_cfg.replace(primal="cg", backend=backend)
        fn = runner(cfg, problem)(3)
        d_h = paired_ms(fn, 3, runs=3, warmup=1)
        if backend == "simulator":
            traced.append((f"three simulator CG iterations at N={N} T={T} "
                           f"D={D}", fn, 3, d_h))
        with_bound(f"one CG COKE iteration on {backend} at N={N} T={T} "
                   f"D={D} ({reads} reads of the {N * T * D * 4 / 1e9:.3f} "
                   "GB Phi)", d_h, 4.0 * reads * N * T * D,
                   4.0 * (2 * big_cfg.cg_maxiter + 3) * N * T * D)
    # device activity under torch.profiler (CUDA only): the kernels' time
    # per iteration against the unprofiled device time of the same work
    for what, fn, iters, d_h in traced:
        rows = profiled_kernels(fn, calls=1)
        if not rows:
            log(12, f"the profiler recorded no device time over {what}: "
                    "its busy share is not measured")
            continue
        busy = sum(r[0] for r in rows) / iters
        log(12, f"[{card}] {what} under the profiler: kernels {busy:.4f} ms "
                f"and {sum(r[1] for r in rows) / iters:.0f} launches per "
                f"iteration; device busy {busy / d_h[0]:.1%} of the "
                f"unprofiled {d_h[0]:.4f} ms, idle {1 - busy / d_h[0]:.1%}")
        for ms, count, key in rows[:6]:
            log(12, f"  {ms / iters:.4f} ms  {count / iters:>7.1f} calls  "
                    f"{key[:90]}")
    no_launches("the simulator's timed iterations")


class QuantizerRecord:
    """Records every Quantize stage call while active: x = innovation /
    scale * levels (the quantizer's input, formed by the same ops as the
    stage, so with the same bits), the draw u and one level's step, as
    device tensors (read after the fit, so the loop stays sync-free).

    Two devices' fits of one chain draw the same u (core.prng is bitwise
    the same on both), but their x differ in the last bits wherever their
    iterates do, and the innovation's cancellation magnifies that: where
    an integer lies between x_a - u and x_b - u, the two round to
    neighbouring levels. `quantizer_flips` counts those rounding flips."""

    def __init__(self):
        from repro_torch.core import comm as comm_mod
        self._cls = comm_mod.Quantize
        self.calls = []

    def __enter__(self):
        from repro_torch.core import prng
        real = self._real = self._cls.transform
        calls = self.calls

        def transform(stage, msg, state, k, key=None):
            if math.isfinite(stage.bits) and stage.stochastic:
                levels = float(np.float32(2.0) ** (np.float32(stage.bits)
                                                   - np.float32(1.0))
                               - np.float32(1.0))
                innov = msg.payload - msg.prev
                lv = torch.full((), levels, dtype=innov.dtype,
                                device=innov.device)
                scale = torch.amax(torch.abs(innov), dim=-1, keepdim=True)
                safe = torch.where(scale > 0, scale, 1.0)
                x = innov / safe * lv
                draw_key = key if key is not None else prng.fold_in(
                    prng.PRNGKey(stage.seed), k)
                calls.append((x, prng.uniform(draw_key, x.shape, x.device),
                              (safe / lv).expand_as(x)))
            return real(stage, msg, state, k, key=key)

        self._cls.transform = transform
        return self

    def __exit__(self, *exc):
        self._cls.transform = self._real


def quantizer_flips(a: QuantizerRecord, b: QuantizerRecord):
    """(flips, draws, sum over flips of |level difference| x step) between
    two runs of one chain. Each run's level is the stage's stochastic
    rounding floor(x) + [u < x - floor(x)], i.e. ceil(x - u): with the
    same draws (checked here), two runs' levels differ only where an
    integer lies between x_a - u and x_b - u, by at most ceil(|x_a - x_b|)
    levels. Raises if the draws differ."""
    if len(a.calls) != len(b.calls):
        raise AssertionError("the two runs quantized a different number of "
                             "rounds")
    flips = draws = 0
    steps = 0.0
    for (xa, ua, sa), (xb, ub, _) in zip(a.calls, b.calls):
        xa, ua, sa, xb, ub = (t.cpu().double() for t in (xa, ua, sa, xb,
                                                          ub))
        if not torch.equal(ua, ub):
            raise AssertionError("the two runs drew different numbers")
        dq = (torch.ceil(xa - ua) - torch.ceil(xb - ub)).abs()
        flips += int((dq > 0).sum())
        draws += dq.numel()
        steps += float((dq * sa).sum())
    return flips, draws, steps


def first_flip(a: QuantizerRecord, b: QuantizerRecord):
    """The 1-based round of the first rounding flip between two runs of
    one chain (their draws equal; see `quantizer_flips`), or None."""
    for j, ((xa, ua, _), (xb, ub, _)) in enumerate(zip(a.calls, b.calls)):
        if not torch.equal(ua.cpu(), ub.cpu()):
            raise AssertionError("the two runs drew different numbers")
        xa, ua, xb = (t.cpu().double() for t in (xa, ua, xb))
        if bool((torch.ceil(xa - ua) != torch.ceil(xb - ua)).any()):
            return j + 1
    return None


class CensorRecord:
    """Records every censor decision while active: the norms
    ||theta_hat - theta|| (formed by the same ops as the decision, so with
    the same bits) and the threshold h(k), as device tensors read after
    the run. `lane(g)` gives a sweep lane's record."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        from repro_torch.core import comm as comm_mod
        self._mod = comm_mod
        real = self._real = comm_mod.censor_decision
        calls = self.calls

        def decide(theta, prev, threshold):
            xi = prev - theta
            calls.append((torch.sqrt(torch.sum(xi * xi, dim=-1)),
                          threshold))
            return real(theta, prev, threshold)

        comm_mod.censor_decision = decide
        return self

    def __exit__(self, *exc):
        self._mod.censor_decision = self._real

    def lane(self, g: int) -> "CensorRecord":
        out = CensorRecord()
        out.calls = [(n[g], h[g]) for n, h in self.calls]
        return out


def first_censor_flip(a: CensorRecord, b: CensorRecord):
    """(1-based round, relative margin) of the first send decision on
    which two runs of one policy part, or (None, None). The margin is the
    largest |norm - h(k)| / h(k) of the parted agents in either run: a
    decision parts only where the two runs' norms straddle the
    threshold."""
    for j, ((na, ha), (nb, hb)) in enumerate(zip(a.calls, b.calls)):
        na, nb = na.cpu().double(), nb.cpu().double()
        ha = torch.as_tensor(ha).cpu().double()
        hb = torch.as_tensor(hb).cpu().double()
        parted = (na >= ha) != (nb >= hb)
        if bool(parted.any()):
            margin = max(float(((n - h).abs() / h)[parted].max())
                         for n, h in ((na, ha), (nb, hb)))
            return j + 1, margin
    return None, None


def hold_until_parted(tag, ha, hb, cens_a, cens_b, quant_a=None,
                      quant_b=None) -> tuple[bool, str]:
    """comms and bits of two runs of one policy (a sweep lane and its fit,
    or two backends), equal until the two runs part: at the first send
    decision taken on either side of h(k) (the runs' fp32 roundings
    differ in the last bits, and over many rounds a margin falls within
    them), or after the first rounding flip of a stochastic quantizer
    (that round's sends precede its quantizer and still agree). With
    neither, equal throughout. Returns (whether they parted, what
    happened, for the log). Runs that parted are two valid trajectories
    of one problem, held by `parted_mse`."""
    k_dec, margin = first_censor_flip(cens_a, cens_b)
    k_q = None if quant_a is None else first_flip(quant_a, quant_b)
    ends = [k for k in (None if k_dec is None else k_dec - 1, k_q)
            if k is not None]
    end = min(ends) if ends else None
    for key in ("comms", "bits"):
        if not torch.equal(ha[key][:end].cpu(), hb[key][:end].cpu()):
            raise AssertionError(f"{tag}: {key} part before the runs do "
                                 f"(round {end})")
    notes = []
    if k_dec is not None:
        notes.append(f"a send decision parts in round {k_dec} at "
                     f"|norm - h| / h = {margin:.1e}")
    if k_q is not None:
        notes.append(f"the first rounding flip in round {k_q}")
    if not notes:
        return False, "comms and bits equal throughout"
    same = torch.equal(ha["comms"].cpu(), hb["comms"].cpu())
    return True, (f"comms and bits equal through round {end} ("
                  + "; ".join(notes) + ")"
                  + ("; comms equal to the end" if same else ""))


def parted_mse(tag, ha, hb, key="train_mse"):
    """Two runs that parted (`hold_until_parted`) must reach the same
    accuracy: the mean of `key` over their last tenth of rounds within
    PARTED_MSE_RTOL, the repo's own rule for cells of equal accuracy
    (`SweepResult.select`'s max_mse_gap). Returns the relative gap."""
    tail = max(1, ha[key].shape[0] // 10)
    a = float(ha[key][-tail:].double().mean())
    b = float(hb[key][-tail:].double().mean())
    gap = abs(a - b) / abs(b)
    if not gap <= PARTED_MSE_RTOL:
        raise AssertionError(f"{tag}: the parted runs' {key} differ by "
                             f"{gap:.2e}")
    return gap


def comm_topology_phase(dev, card, reset_counts, counts, *, problem, cfg,
                        coke4, built, log_problem, log_cfg, small,
                        small_problem, small_logistic):
    """Phase 13: the comm chain (Censor, Quantize, Drop on jax's threefry)
    through K2, K3 and K1, and time-varying topologies on spmd and the
    simulator. `problem`/`cfg` are phase 4's cell and `coke4` its COKE fit;
    `log_problem`/`log_cfg` phase 5's; `small*` phase 3's. Every fit loop
    runs under torch.cuda.set_sync_debug_mode("error"): a host sync inside
    it raises."""
    from repro_torch.api import (Censor, Chain, Drop, FitConfig, Quantize,
                                 build_problem, fit, get_solver)
    from repro_torch.api.backends import consensus_runner
    from repro_torch.api.config import SolveContext
    from repro_torch.core import comm as comm_mod
    from repro_torch.core import prng
    from repro_torch.core.graph import TopologySchedule

    N, T, D = problem.feats.shape

    def pair(d_h):
        return f"{d_h[0]:.4f} ms on the device / {d_h[1]:.4f} ms host enqueue"

    def theta_err(a, b):
        return float((a.double().cpu() - b.double().cpu()).abs().max())

    # ---- PRNG: the card's bits against the CPU's and jax's ---------------
    for seed, folds, shape, key_want, bits_want in JAX_PRNG_PINS:
        key = prng.PRNGKey(seed)
        for f in folds:
            key = prng.fold_in(key, f)
        if key != key_want:
            raise AssertionError(f"key {seed} {folds}: {key} != jax's "
                                 f"{key_want}")
        gb = prng.random_bits(key, shape, dev)
        flat = gb.reshape(-1).cpu()
        got = {i: int(flat[i]) for i in bits_want}
        if got != bits_want or not torch.equal(
                gb.cpu(), prng.random_bits(key, shape, "cpu")):
            raise AssertionError(f"random_bits {seed} {folds} {shape} on "
                                 f"the card: {got} against jax's {bits_want}")
        gu = prng.uniform(key, shape, dev).cpu()
        if not torch.equal(gu.view(torch.int32),
                           prng.uniform(key, shape, "cpu").view(torch.int32)):
            raise AssertionError(f"uniform {seed} {folds} {shape}: card and "
                                 "CPU bits differ")
    u = prng.uniform(prng.fold_in(prng.PRNGKey(0), 3), (4,), dev).cpu()
    if tuple(int(v) for v in u.view(torch.int32)) != JAX_UNIFORM_PIN:
        raise AssertionError(f"uniform on the card {u.tolist()} is not jax's")
    for seed in range(4):
        key = prng.fold_in(prng.PRNGKey(seed), 2**31 + seed)
        for shape in ((20,), (20, 4096), (100003,)):
            if not torch.equal(
                    prng.uniform(key, shape, dev).cpu().view(torch.int32),
                    prng.uniform(key, shape, "cpu").view(torch.int32)):
                raise AssertionError(f"uniform {seed} {shape}: card and CPU "
                                     "bits differ")
    chain = Chain([Censor(1.0, 0.95), Quantize(bits=CHAIN_BITS),
                   Drop(p=CHAIN_DROP)])
    keys = {"coke": chain.chain_key(),
            "dkla": comm_mod.uncensored(chain).chain_key()}
    if keys != JAX_CHAIN_KEYS:
        raise AssertionError(f"chain keys {keys} are not jax's "
                             f"{JAX_CHAIN_KEYS}")
    log(13, f"threefry on the card: keys, random_bits and uniform bitwise "
            f"jax's pinned values ({len(JAX_PRNG_PINS)} keys, shapes up to "
            f"(20, 4096) and (65537,)) and the CPU's (4 more keys x (20,), "
            f"(20, 4096), (100003,)); chain keys {keys} equal jax's")

    # the Drop stage's link draws, recorded on the device, read after
    delivered = []
    real_drop = comm_mod.Drop.transform

    def recording_drop(self, msg, state, k, key=None):
        out, st = real_drop(self, msg, state, k, key=key)
        delivered.append(out.delivered)
        return out, st

    # every fit loop below runs with host syncs raising
    strict = StrictFits().__enter__()
    comm_mod.Drop.transform = recording_drop
    try:
        # ---- the megakernel with the chain, full width -------------------
        reset_counts()
        per_msg = D * CHAIN_BITS + 32
        chain_cfg = cfg.replace(comm=chain)
        chained = {}
        for alg in ("coke", "dkla"):
            before = counts()
            t0 = time.perf_counter()
            res = fit(chain_cfg.replace(algorithm=alg), problem=problem,
                      device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            after = counts()
            rose = {k: after[k] - before[k] for k in after}
            if (rose["coke_megastep"] != 2 * ITERS
                    or rose["coke_fused_update"]):
                raise AssertionError(f"chain {alg}: launches {rose} in "
                                     f"{ITERS} iterations")
            h = {k: v.cpu() for k, v in res.history.items()}
            check_history(f"chain {alg}", h, ITERS)
            if not torch.equal(h["bits"], h["comms"].to(torch.float32)
                               * float(per_msg)):
                raise AssertionError(f"chain {alg}: bits != sends x "
                                     f"{per_msg}")
            comms = int(h["comms"][-1])
            if alg == "dkla" and comms != N * ITERS:
                raise AssertionError(f"chain dkla sent {comms}")
            chained[alg] = (res, h)
            log(13, f"chain {alg} on the megakernel (N={N} T={T} D={D}, "
                    f"{ITERS} iterations) in {wall:.2f} s wall: K2 "
                    f"{rose['coke_megastep']} launches (2 per iteration), "
                    f"K3 0; comms {comms}/{N * ITERS}, bits "
                    f"{float(h['bits'][-1]):.0f} = sends x {per_msg} "
                    f"exactly; train_mse {float(h['train_mse'][0]):.5f} -> "
                    f"{float(h['train_mse'][-1]):.5f}")
        links = torch.stack(delivered).cpu()
        share = float(links.float().mean())
        sigma = math.sqrt(CHAIN_DROP * (1 - CHAIN_DROP) / links.numel())
        log(13, f"Drop stage: {int(links.sum())}/{links.numel()} links "
                f"delivered ({share:.4f}; held within {DELIVERY_SIGMAS:g} "
                f"binomial sd = {DELIVERY_SIGMAS * sigma:.4f} of "
                f"{1 - CHAIN_DROP})")
        if abs(share - (1 - CHAIN_DROP)) > DELIVERY_SIGMAS * sigma:
            raise AssertionError(f"delivered share {share} off "
                                 f"{1 - CHAIN_DROP}")
        mse, mse4 = (float(chained["coke"][1]["train_mse"][-1]),
                     float(coke4.train_mse[-1]))
        log(13, f"chain COKE final train_mse {mse:.5f} against phase 4's "
                f"censor-only {mse4:.5f} ({mse / mse4:.4f}x, held at "
                f"<= {CHAIN_MSE_FACTOR}x)")
        if not mse <= CHAIN_MSE_FACTOR * mse4:
            raise AssertionError("the chain's COKE lost the censor-only "
                                 "accuracy")
        before = counts()["rff_cos_bias"]
        preds = chained["coke"][0].to_model(built.rff_params).predict(
            built.x_test, backend="fused")
        torch.cuda.synchronize()
        if not (counts()["rff_cos_bias"] > before
                and torch.isfinite(preds).all()):
            raise AssertionError("the chain fit's predict did not run K1")
        log(13, f"launch counts over the chain megakernel path: {counts()}")

        # ---- the identity chain: bitwise phase 4's COKE ------------------
        reset_counts()
        ident = fit(cfg.replace(comm=Chain([
            Censor(1.0, 0.95), Quantize(bits=float("inf")), Drop(p=0.0)])),
            problem=problem, device=dev)
        if not torch.equal(ident.theta, coke4.theta) or any(
                not torch.equal(ident.history[k], coke4.history[k])
                for k in coke4.history):
            raise AssertionError("the identity chain differs from phase 4's "
                                 "COKE")
        if counts()["coke_megastep"] != 2 * ITERS:
            raise AssertionError("the identity chain did not run K2")
        log(13, "identity chain (Censor(1.0, 0.95), Quantize(inf), "
                "Drop(0)): theta and every history bitwise phase 4's COKE "
                f"(comms {int(ident.comms[-1])}); {counts()}")

        # ---- the fused fallback with the chain, full width ---------------
        reset_counts()
        for alg in ("coke", "dkla"):
            before = counts()
            res = fit(log_cfg.replace(algorithm=alg, comm=chain),
                      problem=log_problem, device=dev)
            torch.cuda.synchronize()
            after = counts()
            rose = {k: after[k] - before[k] for k in after}
            if (rose["coke_fused_update"], rose["coke_megastep"]) != \
                    (ITERS, 0):
                raise AssertionError(f"chain logistic {alg}: launches "
                                     f"{rose}")
            h = {k: v.cpu() for k, v in res.history.items()}
            check_history(f"chain logistic {alg}", h, ITERS)
            if not torch.equal(h["bits"], h["comms"].to(torch.float32)
                               * float(per_msg)):
                raise AssertionError(f"chain logistic {alg}: bits")
            log(13, f"chain logistic {alg} on the fused fallback: K3 "
                    f"{rose['coke_fused_update']} launches (1 per "
                    f"iteration), K2 0; comms {int(h['comms'][-1])}/"
                    f"{N * ITERS}, bits {float(h['bits'][-1]):.0f}")
        log(13, f"launch counts over the chain fallback path: {counts()}")

        # ---- a topology cycle on spmd at full width -----------------------
        reset_counts()
        topo = TopologySchedule.circulant_cycle(N, TOPO_CYCLE, device=dev)
        spmd = fit(cfg.replace(backend="spmd", topology=topo),
                   problem=problem, device=dev)
        torch.cuda.synchronize()
        if any(counts().values()):
            raise AssertionError(f"the spmd schedule launched {counts()}")
        sim = fit(cfg.replace(backend="simulator", topology=topo,
                              inner_steps=1), problem=problem, device=dev)
        hs = {k: v.cpu() for k, v in spmd.history.items()}
        check_history("spmd schedule", hs, ITERS)
        for k in ("comms", "bits"):
            if not torch.equal(hs[k], sim.history[k].cpu()):
                raise AssertionError(f"spmd schedule: {k} differs from the "
                                     "simulator's")
        e = float((spmd.theta - sim.theta).abs().max())
        tol = SPMD_RTOL * float(sim.theta.abs().max())
        log(13, f"schedule {TOPO_CYCLE} on spmd (N={N} T={T} D={D}, {ITERS} "
                f"iterations): no kernel launched; comms "
                f"{int(hs['comms'][-1])}/{N * ITERS} and bits equal the "
                f"simulator's (primal='gradient', one step), theta max|err| "
                f"{e:.3e} (tol {tol:.3e}, rtol {SPMD_RTOL:g} of max|theta|)")
        if not e <= tol:
            raise AssertionError("spmd schedule: theta differs from the "
                                 "simulator's")

        # ---- a topology cycle at the paper's shape, Cholesky stack -------
        reset_counts()
        paper = build_problem(FitConfig(), device=dev).problem
        pcfg = FitConfig(topology=TopologySchedule.circulant_cycle(
            N, TOPO_CYCLE, device=dev), num_iters=TOPO_PAPER_ITERS,
            record_oracle_distance=True)
        ctx = SolveContext.from_config(pcfg)
        stack = get_solver("coke").prepare_traced(paper, ctx, None)["chol"]
        if tuple(stack.shape) != (len(TOPO_CYCLE), N, paper.feature_dim,
                                  paper.feature_dim):
            raise AssertionError(f"the factor stack is {tuple(stack.shape)}")
        t0 = time.perf_counter()
        gpu = fit(pcfg, problem=paper, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        cpu = fit(pcfg, problem=paper.to("cpu"), device="cpu")
        f64 = fit(pcfg, problem=dataclasses.replace(
            paper, feats=paper.feats.double(), labels=paper.labels.double(),
            adjacency=paper.adjacency.double()), device=dev)
        if any(counts().values()):
            raise AssertionError(f"the simulator schedule launched "
                                 f"{counts()}")
        h = {k: v.cpu() for k, v in gpu.history.items()}
        check_history("paper schedule", h, TOPO_PAPER_ITERS)
        for k in ("comms", "bits"):
            if not torch.equal(h[k], cpu.history[k]):
                raise AssertionError(f"paper schedule: {k} differs between "
                                     "card and CPU")
        e_card, e_cpu = (theta_err(gpu.theta, f64.theta),
                         theta_err(cpu.theta, f64.theta))
        log(13, f"schedule {TOPO_CYCLE} on the simulator at the paper's "
                f"shape (N={N}, T={paper.feats.shape[1]}, "
                f"L={paper.feature_dim}, {TOPO_PAPER_ITERS} iterations, "
                f"Cholesky stack {tuple(stack.shape)}) in {wall:.2f} s wall: "
                f"comms {int(h['comms'][-1])}/{N * TOPO_PAPER_ITERS} and "
                f"bits equal the CPU's; train_mse "
                f"{float(h['train_mse'][0]):.6f} -> "
                f"{float(h['train_mse'][-1]):.6f}, dist_to_oracle "
                f"{float(h['dist_to_oracle'][0]):.4f} -> "
                f"{float(h['dist_to_oracle'][-1]):.4f}; theta max|err| card vs "
                f"float64 {e_card:.3e}, CPU vs float64 {e_cpu:.3e} (the card "
                f"held within {SIM_F64_FACTOR:g}x the CPU's + "
                f"{SIM_F64_SLACK:g})")
        if not (e_card <= SIM_F64_FACTOR * e_cpu + SIM_F64_SLACK
                and h["dist_to_oracle"][-1] < h["dist_to_oracle"][0]):
            raise AssertionError("paper schedule: the card's fit is off")

        # ---- the fused backend rejects a schedule -------------------------
        try:
            fit(cfg.replace(topology=topo), problem=problem, device=dev)
        except ValueError as err:
            if str(err) != FUSED_SCHEDULE_ERROR:
                raise AssertionError(f"fused schedule: {err}") from err
            log(13, f"fused + schedule raises the reference's ValueError: "
                    f"{err}")
        else:
            raise AssertionError("the fused backend ran a schedule")

        # ---- small fits with the chain, card against CPU ------------------
        small_chain = Chain([Censor(0.3, 0.97), Quantize(bits=5, seed=7),
                             Drop(p=0.15, seed=11)])
        base = small.replace(censor_v=None, censor_mu=None,
                             comm=small_chain, inner_steps=1)
        cases = [(b, alg, small_problem) for b in ("simulator", "spmd",
                                                     "fused")
                 for alg in ("coke", "dkla")]
        cases += [("fused", alg, small_logistic) for alg in ("coke", "dkla")]
        for backend, alg, prob in cases:
            c = base.replace(algorithm=alg, backend=backend)
            with QuantizerRecord() as rec_cpu:
                cpu = fit(c, problem=prob, device="cpu")
            with QuantizerRecord() as rec_gpu:
                gpu = fit(c, problem=prob, device=dev)
            for k in ("comms", "bits"):
                if not torch.equal(gpu.history[k].cpu(), cpu.history[k]):
                    raise AssertionError(f"small chain {backend} {alg} "
                                         f"{prob.loss}: {k} differs")
            flips, draws, steps = quantizer_flips(rec_gpu, rec_cpu)
            tol = SMALL_THETA_TOL + steps
            e = float((gpu.theta.cpu() - cpu.theta).abs().max())
            log(13, f"small chain {backend} {alg} ({prob.loss}) card vs "
                    f"CPU: comms {int(cpu.comms[-1])} and bits equal; "
                    f"{flips} rounding flips in {draws} stochastic "
                    f"roundings (steps {steps:.3e}); theta max|err| "
                    f"{e:.3e} (tol {SMALL_THETA_TOL:g} + the flips' steps "
                    f"= {tol:.3e})")
            if not e <= tol:
                raise AssertionError(f"small chain {backend} {alg}: theta")
    finally:
        strict.__exit__()
        comm_mod.Drop.transform = real_drop

    # ---- times: chain iterations beside the plain ones --------------------
    def ring_loop(c, prob):
        carry0, chunk_fn, _ = consensus_runner(
            c, get_solver(c.algorithm), prob, SolveContext.from_config(c),
            None)
        st = {"c": chunk_fn(carry0, 2)[0]}

        def ten():
            st["c"] = chunk_fn(st["c"], 10)[0]
        return ten

    pairs = (
        ("megakernel COKE", ring_loop(cfg.replace(comm=chain), problem),
         ring_loop(cfg, problem)),
        ("fused-logistic COKE", ring_loop(log_cfg.replace(comm=chain),
                                          log_problem),
         ring_loop(log_cfg, log_problem)),
        ("spmd COKE", ring_loop(cfg.replace(backend="spmd", topology=topo),
                                problem),
         ring_loop(cfg.replace(backend="spmd"), problem)))
    for what, changed, plain in pairs:
        # in turns: changed, plain, changed, plain (medians of each)
        runs = [paired_ms(fn, 10) for fn in (changed, plain, changed, plain)]
        ch = tuple(statistics.median(x) for x in zip(runs[0], runs[2]))
        pl = tuple(statistics.median(x) for x in zip(runs[1], runs[3]))
        launches = []
        for fn in (changed, plain):
            rows = profiled_kernels(fn, calls=1)
            launches.append(sum(r[1] for r in rows) / 10 if rows else None)
        tag = "schedule" if what.startswith("spmd") else "chain"
        fmt = (lambda n: "not measured (no device rows)" if n is None
               else f"{n:.0f}")
        log(13, f"[{card}] one {what} iteration at N={N} T={T} D={D} "
                f"(chunks of ten) with the {tag}: {pair(ch)}, "
                f"{fmt(launches[0])} launches; without: {pair(pl)}, "
                f"{fmt(launches[1])} launches; the {tag} adds "
                f"{ch[0] - pl[0]:.4f} ms on the device and "
                f"{ch[1] - pl[1]:.4f} ms of host enqueue per iteration")
    key = prng.fold_in(prng.PRNGKey(0), 1)
    for shape in ((N,), (N, D)):
        d_h = paired_ms(lambda: prng.uniform(key, shape, dev), 1)
        rows = profiled_kernels(lambda: prng.uniform(key, shape, dev),
                                calls=10)
        n = sum(r[1] for r in rows) if rows else None
        log(13, f"[{card}] one prng.uniform{shape}: {pair(d_h)}, {fmt(n)} "
                "launches (K5)")


class LaneQuantizerRecord(QuantizerRecord):
    """QuantizerRecord for a sweep's lanes: records every
    `Quantize.transform_lanes` call, (G, N, D), with its lanes at bits=inf
    zeroed (they keep their payload; their x is not finite). `lane(g)`
    gives lane g's record, comparable with a fit's QuantizerRecord."""

    def __enter__(self):
        from repro_torch.core import prng
        real = self._real = self._cls.transform_lanes
        calls = self.calls

        def transform_lanes(stage, payload, prev, levels, finite, key):
            if stage.stochastic:
                innov = payload - prev
                scale = torch.amax(torch.abs(innov), dim=-1, keepdim=True)
                safe = torch.where(scale > 0, scale, 1.0)
                ok = torch.isfinite(levels)
                x = torch.where(ok, innov / safe * levels, 0.0)
                u = prng.uniform(key, x.shape[1:], x.device)
                calls.append((x, torch.where(ok, u, 0.0),
                              torch.where(ok, safe / levels, 0.0)
                              .expand_as(x)))
            return real(stage, payload, prev, levels, finite, key)

        self._cls.transform_lanes = transform_lanes
        return self

    def __exit__(self, *exc):
        self._cls.transform_lanes = self._real

    def lane(self, g: int) -> QuantizerRecord:
        out = QuantizerRecord()
        out.calls = [(x[g], u[g], s[g]) for x, u, s in self.calls]
        return out


class StrictLoops:
    """While active, every simulator chunk (of fit, fit_stream and sweep)
    and every spmd stream chunk runs under
    torch.cuda.set_sync_debug_mode("error"): a host sync inside an
    iteration raises. Set-up (factors, tables, the problem) may sync."""

    def __enter__(self):
        import importlib
        self._mods = (importlib.import_module("repro_torch.api.fit"),
                      importlib.import_module("repro_torch.api.backends"))
        self._real = (self._mods[0]._simulator_chunk,
                      self._mods[1]._stream_chunk)

        def strict(real):
            def run(*a, **k):
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    return real(*a, **k)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            return run

        self._mods[0]._simulator_chunk = strict(self._real[0])
        self._mods[1]._stream_chunk = strict(self._real[1])
        return self

    def __exit__(self, *exc):
        self._mods[0]._simulator_chunk = self._real[0]
        self._mods[1]._stream_chunk = self._real[1]


def loop_of(runner, steps=10):
    """`steps` more iterations of a (carry0, chunk_fn, theta_fn) runner per
    call, from a carry two iterations in."""
    carry0, chunk_fn, _ = runner
    st = {"c": chunk_fn(carry0, 2)[0]}

    def run():
        st["c"] = chunk_fn(st["c"], steps)[0]
    return run


def per_iteration(card, phase, what, fn, steps=10, runs=3):
    """Time `fn` (`steps` iterations per call): device and host ms per
    iteration from one window (the median of `runs`: three by default,
    as phase 19's SHARD_RUNS), and kernels and launches per iteration by
    the profiler. Returns (device ms, host ms, launches or None)."""
    d_h = paired_ms(fn, steps, runs=runs, warmup=min(2, runs))
    rows = profiled_kernels(fn, calls=1)
    launches = sum(r[1] for r in rows) / steps if rows else None
    busy = sum(r[0] for r in rows) / steps if rows else None
    log(phase, f"[{card}] {what}: {d_h[0]:.4f} ms on the device / "
               f"{d_h[1]:.4f} ms host enqueue per iteration; "
               + ("launches and kernel time not measured (the profiler "
                  "recorded no device rows)" if rows == [] else
                  f"{launches:.1f} launches and {busy:.4f} ms of kernels "
                  f"per iteration ({busy / d_h[0]:.1%} busy)"))
    return d_h[0], d_h[1], launches


def fit_kernels_idle(counts, what):
    """K2, K3 and K4 never run on the sweep and stream paths (K1 runs in a
    fused evaluate or predict, K5 in a draw)."""
    moved = {k: v for k, v in counts().items()
             if v and k not in ("rff_cos_bias", "threefry")}
    if moved:
        raise AssertionError(f"{what} launched {moved}")


def k1_once(counts, what, fn):
    """Run `fn` and require exactly one K1 launch in it."""
    before = counts()["rff_cos_bias"]
    out = fn()
    torch.cuda.synchronize()
    moved = counts()["rff_cos_bias"] - before
    if moved != 1:
        raise AssertionError(f"{what}: K1 launched {moved} times, not once")
    return out


def sweep_phase(dev, card, reset_counts, counts, *, krr):
    """Phase 14: `sweep`, a policy grid as one lane-batched simulator loop
    (no kernel in the loop; K1 once per fused evaluate of the grid).
    `krr` is phase 4's KRRConfig: the crossover cell is cut from it."""
    from repro_torch.api import (PAPER_SETUPS, Censor, Chain, Drop,
                                 FitConfig, KRRConfig, Quantize,
                                 build_problem, fit, get_solver, sweep)
    from repro_torch.api.config import SolveContext
    from repro_torch.api.fit import _simulator_runner
    from repro_torch.core import admm, prng
    from repro_torch.core import comm as comm_mod

    def theta_err(a, b):
        return float((a.double().cpu() - b.double().cpu()).abs().max())

    def lanes_runner(cfg, prob, cells):
        ctx = dataclasses.replace(SolveContext.from_config(cfg),
                                  comm=comm_mod.stack_policies(cells))
        return _simulator_runner(get_solver(cfg.algorithm), prob, ctx, None)

    def fit_runner(cfg, prob, cell):
        ctx = dataclasses.replace(SolveContext.from_config(cfg),
                                  comm=comm_mod.as_chain(cell))
        return _simulator_runner(get_solver(cfg.algorithm), prob, ctx, None)

    def cells_of(grid):
        return [Chain([Censor(*c[:2])] + ([Quantize(c[2])] if len(c) == 3
                                           else [])) for c in grid]

    # ---- (a) G keys at once: bitwise G single draws, on the card and CPU
    keys = [prng.fold_in(prng.PRNGKey(s), 7 * s + 1) for s in range(8)]
    batched = torch.tensor(keys, dtype=torch.int64, device=dev)
    for shape in ((N_AGENTS,), (N_AGENTS, 100), (N_AGENTS, FEATURES)):
        u = prng.uniform(batched, shape, dev).cpu()
        for g, key in enumerate(keys):
            if not torch.equal(u[g].view(torch.int32), prng.uniform(
                    key, shape, "cpu").view(torch.int32)):
                raise AssertionError(f"lane draw {g} {shape} differs from "
                                     "the single draw")
    log(14, f"G=8 keys in one draw on the card, shapes (20,), (20, 100), "
            f"(20, 4096): each lane bitwise the single draw on the CPU")

    # ---- (b) small sweeps, card against CPU; K1 once per evaluate -------
    reset_counts()
    small = FitConfig(krr=KRRConfig(num_agents=4, samples_per_agent=40,
                                    num_features=32, lam=1e-2, rho=0.1),
                      graph="ring", num_iters=40, censor_v=None,
                      censor_mu=None)
    sb = build_problem(small, device="cpu")
    pairs = [(0.3, 0.97), (0.05, 0.9), (1.0, 0.99)]
    bits = [(v, mu, b) for b in BITS_WIDTHS
            for v, mu in ((0.3, 0.97), (0.05, 0.9))]
    drop = [Chain([Censor(v, 0.97), Quantize(5.0, seed=7), Drop(p)])
            for v, p in ((0.3, 0.0), (0.3, 0.2), (0.05, 0.5))]
    with StrictLoops():
        for alg, name, grid in (("coke", "pairs", pairs),
                                ("coke", "(v, mu, bits)", bits),
                                ("dkla", "(v, mu, bits)", bits),
                                ("coke", "chain", drop),
                                ("cta", "pairs", pairs)):
            c = small.replace(algorithm=alg, cta_lr=0.05)
            with LaneQuantizerRecord() as rec_cpu:
                cpu = sweep(c, grid, problem=sb.problem, device="cpu")
            with LaneQuantizerRecord() as rec_gpu:
                gpu = sweep(c, grid, problem=sb.problem, device=dev)
            for k in ("comms", "bits"):
                if not torch.equal(gpu.history[k].cpu(), cpu.history[k]):
                    raise AssertionError(f"small {alg} sweep {name}: {k} "
                                         "differs card vs CPU")
            flips, draws, steps = quantizer_flips(rec_gpu, rec_cpu)
            e = theta_err(gpu.thetas, cpu.thetas)
            tol = SMALL_THETA_TOL + steps
            log(14, f"small {alg} sweep over {len(grid)} {name} cells (N=4 "
                    f"ring, D=32, 40 iterations) card vs CPU: comms "
                    f"{gpu.history['comms'][:, -1].tolist()} and bits equal; "
                    f"{flips} rounding flips in {draws} stochastic roundings; "
                    f"theta max|err| {e:.3e} (tol {SMALL_THETA_TOL:g} + the "
                    f"flips' steps = {tol:.3e})")
            if not e <= tol:
                raise AssertionError(f"small {alg} sweep {name}: theta")
    fit_kernels_idle(counts, "the small sweeps")
    rff = sb.rff_params.to(dev)
    ev = k1_once(counts, "small sweep evaluate(backend='fused')",
                 lambda: gpu.evaluate(sb.x_test, sb.y_test, backend="fused",
                                      rff_params=rff))
    ev_ref = gpu.evaluate(sb.x_test, sb.y_test, rff_params=rff)
    err = float((ev["test_mse"] - ev_ref["test_mse"]).abs().max()
                / ev_ref["test_mse"].abs().min())
    idx, model = gpu.select(sb.x_test, sb.y_test, rff_params=rff)
    k1_once(counts, "predict on a sweep cell's model",
            lambda: model.predict(sb.x_test[0], backend="fused"))
    log(14, f"small sweep evaluate(backend='fused'): K1 1 launch for "
            f"{len(gpu)} cells; test_mse rtol {err:.2e} against the plain "
            f"featurizer; select -> cell {idx}, whose model predicts "
            "through K1 (1 launch)")
    if not err <= 1e-4:
        raise AssertionError("fused and ref evaluate of a sweep differ")

    # ---- (c) the paper's censor grid: paper_comm_cost.run_setup ---------
    reset_counts()
    base = FitConfig(algorithm="coke", krr=PAPER_SETUPS["synthetic"],
                     num_iters=SWEEP_ITERS)
    paper = build_problem(base, samples_override=SWEEP_SAMPLES, device=dev)
    pp = paper.problem
    n, t, d = pp.feats.shape
    p64 = dataclasses.replace(pp, feats=pp.feats.double(),
                              labels=pp.labels.double(),
                              adjacency=pp.adjacency.double())
    with StrictLoops():
        # the lanes and the fits timed with their send decisions recorded
        with CensorRecord() as cens_lanes:
            t0 = time.perf_counter()
            sw = sweep(base, PAPER_GRID, problem=pp, device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        sw64 = sweep(base, PAPER_GRID, problem=p64, device=dev)
        fits, cens_fits = [], []
        t0 = time.perf_counter()
        for g in range(len(sw)):
            with CensorRecord() as rec:
                fits.append(fit(sw.cell_config(g), problem=pp, device=dev))
            cens_fits.append(rec)
        torch.cuda.synchronize()
        wall_fits = time.perf_counter() - t0
    for g, f in enumerate(fits):
        lane = {k: v[g] for k, v in sw.history.items()}
        parted, held = hold_until_parted(f"paper sweep cell {g}", lane,
                                         f.history, cens_lanes.lane(g),
                                         cens_fits[g])
        e_lane = theta_err(sw.thetas[g], sw64.thetas[g])
        e_fit = theta_err(f.theta, sw64.thetas[g])
        e_mse = float(((sw.history["train_mse"][g] - f.train_mse).abs()
                       / f.train_mse.abs()).max())
        log(14, f"paper sweep cell {g} {PAPER_GRID[g]}: comms "
                f"{int(lane['comms'][-1])}/{n * SWEEP_ITERS} (fit "
                f"{int(f.comms[-1])}): {held}; train_mse "
                f"{float(f.train_mse[-1]):.6f} (lane vs fit rtol "
                f"{e_mse:.2e}); theta max|err| from the float64 sweep: lane "
                f"{e_lane:.3e}, fit {e_fit:.3e}")
        if parted:   # two valid trajectories: held by their accuracy
            gap = parted_mse(f"paper sweep cell {g}", lane, f.history)
            log(14, f"paper sweep cell {g}: lane and fit parted; their "
                    f"train_mse over the last tenth differ by {gap:.2e} "
                    f"(held at {PARTED_MSE_RTOL:g})")
        elif not (e_lane <= SIM_F64_FACTOR * e_fit + SIM_F64_SLACK
                  and e_mse <= SIM_MSE_RTOL):
            raise AssertionError(f"paper sweep cell {g}: the lane is further "
                                 "from the float64 run than its fit")
    fit_kernels_idle(counts, "the paper sweep")
    log(14, f"[{card}] paper sweep: {len(sw)} cells (N={n} Erdos-Renyi "
            f"p=0.3, T={t}, L={d}, Cholesky, {SWEEP_ITERS} iterations) in "
            f"{wall:.2f} s wall as one lane-batched loop; the {len(sw)} fits "
            f"in turn {wall_fits:.2f} s (each with its sends recorded)")
    paper_cells = cells_of(PAPER_GRID)
    g1 = per_iteration(card, 14, f"paper sweep G=1 (N={n}, T={t}, L={d})",
                       loop_of(lanes_runner(base, pp, paper_cells[:1])))
    g7 = per_iteration(card, 14, f"paper sweep G={len(paper_cells)}",
                       loop_of(lanes_runner(base, pp, paper_cells)))
    one = per_iteration(card, 14, "one paper fit (no lanes)",
                        loop_of(fit_runner(base, pp, paper_cells[0])))
    log(14, f"[{card}] paper grid: one G={len(paper_cells)} iteration "
            f"{g7[0]:.4f} ms against {len(paper_cells)} fit iterations in "
            f"turn {len(paper_cells) * one[0]:.4f} ms "
            f"({len(paper_cells) * one[0] / g7[0]:.2f}x); G=1 {g1[0]:.4f} "
            "ms")

    # ---- (d) the bits curve: paper_comm_cost.run_bits_curve -------------
    reset_counts()
    curve = [Chain([Censor(v, mu), Quantize(bits=b)]) for b in BITS_WIDTHS
             for v, mu in BITS_CENSORS]
    base_b = base.replace(censor_v=None, censor_mu=None)
    with StrictLoops():
        with LaneQuantizerRecord() as q_lanes, CensorRecord() as c_lanes:
            t0 = time.perf_counter()
            swb = sweep(base_b, curve, problem=pp, device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        for g in range(len(swb)):
            with QuantizerRecord() as q_fit, CensorRecord() as c_fit:
                f = fit(swb.cell_config(g), problem=pp, device=dev)
            lane = {k: v[g] for k, v in swb.history.items()}
            quantizes = math.isfinite(curve[g].stages[1].bits)
            parted, held = hold_until_parted(
                f"bits-curve cell {g}", lane, f.history, c_lanes.lane(g),
                c_fit, q_lanes.lane(g) if quantizes else None,
                q_fit if quantizes else None)
            if parted:
                gap = parted_mse(f"bits-curve cell {g}", lane, f.history)
                held += f"; train_mse over the last tenth {gap:.2e} apart"
            if quantizes:
                flips, draws, _ = quantizer_flips(q_lanes.lane(g), q_fit)
                held += f"; {flips} rounding flips in {draws} roundings"
            log(14, f"bits-curve cell {g} {curve[g].describe()}: comms "
                    f"{int(lane['comms'][-1])} (fit {int(f.comms[-1])}), "
                    f"bits {float(lane['bits'][-1]):.0f}: {held}; train_mse "
                    f"lane {float(lane['train_mse'][-1]):.6f} / fit "
                    f"{float(f.train_mse[-1]):.6f}")
    fit_kernels_idle(counts, "the bits-curve sweep")
    log(14, f"[{card}] bits-curve sweep: {len(swb)} cells in {wall:.2f} s "
            f"wall ({SWEEP_ITERS} iterations, sends and roundings recorded)")
    per_iteration(card, 14, f"bits-curve sweep G={len(curve)}",
                  loop_of(lanes_runner(base_b, pp, curve)))
    per_iteration(card, 14, "one bits-curve fit, Quantize(4) (no lanes)",
                  loop_of(fit_runner(base_b, pp, curve[-1])))

    # ---- (e) the crossover width: one shared factor stack ---------------
    reset_counts()
    cross_cfg = FitConfig(krr=dataclasses.replace(
        krr, num_features=SIM_CROSSOVER_D), graph="ring", algorithm="coke",
        num_iters=SIM_BIG_D_ITERS, censor_v=None, censor_mu=None)
    cb = build_problem(cross_cfg, device=dev)
    cp = cb.problem
    N, T, D = cp.feats.shape
    grid = [(v, mu, b) for b in BITS_WIDTHS for v, mu in BITS_CENSORS]
    stack = N * D * D * 4
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    with StrictLoops():
        with LaneQuantizerRecord() as q_lanes, CensorRecord() as c_lanes:
            swc = sweep(cross_cfg, grid, problem=cp, device=dev)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - held
        for g in range(len(swc)):
            with QuantizerRecord() as q_fit, CensorRecord() as c_fit:
                f = fit(swc.cell_config(g), problem=cp, device=dev)
            lane = {k: v[g] for k, v in swc.history.items()}
            quantizes = math.isfinite(grid[g][2])
            parted, held = hold_until_parted(
                f"crossover cell {g}", lane, f.history, c_lanes.lane(g),
                c_fit, q_lanes.lane(g) if quantizes else None,
                q_fit if quantizes else None)
            if parted:
                gap = parted_mse(f"crossover cell {g}", lane, f.history)
                held += f"; train_mse over the last tenth {gap:.2e} apart"
            log(14, f"crossover cell {g} {grid[g]} against its fit: {held}")
    log(14, f"crossover sweep (N={N} ring, T={T}, D={D}, Cholesky, "
            f"{len(grid)} (v, mu, bits) cells, {SIM_BIG_D_ITERS} iterations):"
            f" comms {swc.history['comms'][:, -1].tolist()}; peak memory "
            f"over the problem "
            f"{peak / 1e9:.3f} GB, one factor stack {stack / 1e9:.3f} GB "
            f"(G stacks would be {len(grid) * stack / 1e9:.3f} GB)")
    if not peak < 2 * stack:
        raise AssertionError("the crossover sweep held more than one "
                             "factor stack")
    fit_kernels_idle(counts, "the crossover sweep")
    lanes = per_iteration(card, 14, f"crossover sweep G={len(grid)} (N={N},"
                          f" T={T}, D={D})", loop_of(lanes_runner(
                              cross_cfg, cp, cells_of(grid))))
    single = per_iteration(card, 14, f"one crossover fit (N={N}, T={T}, "
                           f"D={D})", loop_of(fit_runner(
                               cross_cfg, cp, cells_of(grid)[0])))
    fac = time_ms(lambda: admm._ridge_factors(cp), reps=1, runs=3,
                  warmup=1)
    log(14, f"[{card}] crossover: one G={len(grid)} iteration "
            f"{lanes[0]:.4f} ms against {len(grid)} fit iterations in turn "
            f"{len(grid) * single[0]:.4f} ms; the factorization, once per "
            f"sweep: {fac:.4f} ms")
    rows = cb.x_test.shape[0] * cb.x_test.shape[1]
    ev = k1_once(counts, "crossover sweep evaluate(backend='fused')",
                 lambda: swc.evaluate(cb.x_test, cb.y_test, backend="fused",
                                      rff_params=cb.rff_params))
    d_ev = time_ms(lambda: swc.evaluate(cb.x_test, cb.y_test,
                                        backend="fused",
                                        rff_params=cb.rff_params),
                   reps=1, runs=5, warmup=1)
    ev_ref = swc.evaluate(cb.x_test, cb.y_test, rff_params=cb.rff_params)
    err = float((ev["test_mse"] - ev_ref["test_mse"]).abs().max()
                / ev_ref["test_mse"].abs().min())
    log(14, f"[{card}] crossover evaluate(backend='fused') on {rows} "
            f"held-out rows for {len(swc)} cells: K1 1 launch, "
            f"{d_ev:.4f} ms; test_mse rtol {err:.2e} against the plain "
            "featurizer")
    if not err <= 1e-4:
        raise AssertionError("fused and ref evaluate of the crossover "
                             "sweep differ")


def stream_phase(dev, card, reset_counts, counts):
    """Phase 15: `fit_stream` and `KernelModel.partial_fit`, the streaming
    family on the simulator and spmd (no kernel in the rounds; K1 in the
    refined model's fused predict)."""
    from repro_torch.api import (PAPER_SETUPS, Censor, Chain, Drop,
                                 FitConfig, KRRConfig, Quantize,
                                 build_stream, fit_stream, get_solver)
    from repro_torch.api.backends import stream_consensus_runner
    from repro_torch.api.config import SolveContext
    from repro_torch.api.fit import _simulator_runner

    def theta_err(a, b):
        return float((a.double().cpu() - b.double().cpu()).abs().max())

    def stream_runner(cfg, stream):
        solver = get_solver(cfg.algorithm)
        ctx = SolveContext.from_config(cfg)
        if cfg.backend == "simulator":
            return _simulator_runner(solver, stream, ctx, None)
        return stream_consensus_runner(cfg, solver, stream, ctx)

    # ---- (a) small streams, card against CPU ----------------------------
    reset_counts()
    small = FitConfig(krr=KRRConfig(num_agents=6, num_features=16,
                                    lam=1e-2, rho=0.1),
                      graph="ring", num_iters=40, online_batch=8,
                      censor_v=None, censor_mu=None,
                      comm=Chain([Censor(0.3, 0.99), Quantize(5.0, seed=7),
                                  Drop(0.1, seed=11)]))
    ss = build_stream(small, device="cpu").stream
    with StrictLoops():
        for backend in ("simulator", "spmd"):
            for alg in STREAM_SOLVERS:
                c = small.replace(algorithm=alg, backend=backend,
                                  qc_eta=2.0 if alg == "qc_odkla" else None)
                with QuantizerRecord() as rec_cpu:
                    cpu = fit_stream(c, stream=ss, device="cpu")
                with QuantizerRecord() as rec_gpu:
                    gpu = fit_stream(c, stream=ss, device=dev)
                for k in ("comms", "bits"):
                    if not torch.equal(gpu.history[k].cpu(),
                                       cpu.history[k]):
                        raise AssertionError(f"small stream {backend} {alg}:"
                                             f" {k} differs card vs CPU")
                flips, draws, steps = quantizer_flips(rec_gpu, rec_cpu)
                e = theta_err(gpu.theta, cpu.theta)
                tol = SMALL_THETA_TOL + steps
                log(15, f"small stream {alg} on {backend} (N=6 ring, D=16, "
                        f"b=8, 40 rounds, Censor+Quantize(5)+Drop) card vs "
                        f"CPU: comms {int(cpu.comms[-1])} and bits equal; "
                        f"{flips} rounding flips in {draws} roundings; theta "
                        f"max|err| {e:.3e} (tol {tol:.3e})")
                if not e <= tol:
                    raise AssertionError(f"small stream {backend} {alg}: "
                                         "theta")
    fit_kernels_idle(counts, "the small streams")

    # ---- (b) paper_online.run_curve's defaults on the simulator ---------
    reset_counts()
    o = ONLINE
    base = FitConfig(krr=KRRConfig(num_agents=o["num_agents"],
                                   num_features=o["features"], lam=1e-3,
                                   rho=5e-2, seed=0),
                     censor_v=None, censor_mu=None, num_iters=o["rounds"],
                     online_batch=o["batch"], online_lr=o["lr"])
    bs = build_stream(base, device=dev).stream
    R, N = o["rounds"], o["num_agents"]
    runs = {}
    for alg in STREAM_SOLVERS:
        pol = [Censor(o["v"], o["mu"])] + ([Quantize(bits=o["bits"])]
                                           if alg == "qc_odkla" else [])
        c = base.replace(algorithm=alg, comm=Chain(pol))
        with StrictLoops():
            t0 = time.perf_counter()
            r = fit_stream(c, stream=bs, device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        h = {k: v.cpu() for k, v in r.history.items()}
        check_history(f"online {alg}", h, R)
        if alg != "qc_odkla":   # no quantizer: card and CPU run alike
            cpu = fit_stream(c, stream=bs.to("cpu"), device="cpu")
            for k in ("comms", "bits"):
                if not torch.equal(h[k], cpu.history[k]):
                    raise AssertionError(f"online {alg}: {k} differs card "
                                         "vs CPU")
        inst = h["instant_mse"].double()
        regret = torch.cumsum(inst, 0) / torch.arange(1, R + 1)
        runs[alg] = h
        log(15, f"online {alg} (paper_online.run_curve: N={N} Erdos-Renyi "
                f"p=0.3, b={o['batch']}, D={o['features']}, {R} rounds) in "
                f"{wall:.2f} s wall: comms {int(h['comms'][-1])}/{N * R}, "
                f"bits {float(h['bits'][-1]):.0f}; average regret "
                f"{float(regret[9]):.5f} (round 10) -> "
                f"{float(regret[-1]):.5f}"
                + ("; comms and bits equal the CPU's"
                   if alg != "qc_odkla" else ""))
        per_iteration(card, 15, f"one {alg} round (N={N}, b={o['batch']}, "
                      f"D={o['features']}, simulator)",
                      loop_of(stream_runner(c, bs)))
    if not (int(runs["online_dkla"]["comms"][-1]) == N * R
            and int(runs["online_coke"]["comms"][-1]) < N * R
            and float(runs["qc_odkla"]["bits"][-1])
            < float(runs["online_dkla"]["bits"][-1])):
        raise AssertionError("the online family's comms and bits are not "
                             "ordered as censoring and quantization order "
                             "them")
    fit_kernels_idle(counts, "the online curve")

    # ---- (c) a full-width stream on the simulator and spmd --------------
    reset_counts()
    wide = FitConfig(krr=dataclasses.replace(
        PAPER_SETUPS["synthetic"], num_agents=N_AGENTS,
        num_features=FEATURES), graph="ring", censor_v=None,
        censor_mu=None, comm=Chain([Censor(0.2, 0.995), Quantize(4.0)]),
        num_iters=STREAM_WIDE_ROUNDS, online_batch=STREAM_WIDE_BATCH)
    wb = build_stream(wide, device=dev)
    ws = wb.stream
    R, N, b, D = ws.feats.shape
    results = {}
    for alg in ("online_coke", "qc_odkla"):
        for backend in ("simulator", "spmd"):
            c = wide.replace(algorithm=alg, backend=backend)
            with StrictLoops(), QuantizerRecord() as rec, \
                    CensorRecord() as cens:
                t0 = time.perf_counter()
                r = fit_stream(c, stream=ws, device=dev)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            h = {k: v.cpu() for k, v in r.history.items()}
            check_history(f"wide {alg} {backend}", h, R)
            results[(alg, backend)] = (r, rec, cens)
            log(15, f"wide {alg} on {backend} (N={N} ring, b={b}, D={D}, "
                    f"{R} rounds, {ws.feats.numel() * 4 / 1e9:.2f} GB of "
                    f"features) in {wall:.2f} s wall: comms "
                    f"{int(h['comms'][-1])}/{N * R}, bits "
                    f"{float(h['bits'][-1]):.0f}; instant_mse "
                    f"{float(h['instant_mse'][0]):.5f} -> "
                    f"{float(h['instant_mse'][-1]):.5f}")
            per_iteration(card, 15, f"one wide {alg} round on {backend} "
                          f"(N={N}, b={b}, D={D})",
                          loop_of(stream_runner(c, ws)))
        (sim, rs, cs_), (spmd, rp, cp_) = (results[(alg, "simulator")],
                                           results[(alg, "spmd")])
        parted, held = hold_until_parted(f"wide {alg}", sim.history,
                                         spmd.history, cs_, cp_, rs, rp)
        flips, draws, steps = quantizer_flips(rs, rp)
        e = theta_err(sim.theta, spmd.theta)
        if parted:
            gap = parted_mse(f"wide {alg}", sim.history, spmd.history,
                             key="instant_mse")
            held += f"; instant_mse over the last tenth {gap:.2e} apart"
        log(15, f"wide {alg}, the simulator against spmd: {held}; {flips} "
                f"rounding flips in {draws} roundings; theta max|err| "
                f"{e:.3e}" + ("" if parted else
                              f" (tol {SMALL_THETA_TOL:g} + {steps:.3e})"))
        if not parted and not e <= SMALL_THETA_TOL + steps:
            raise AssertionError(f"wide {alg}: simulator and spmd theta")
    fit_kernels_idle(counts, "the wide streams")

    # ---- partial_fit: refine a deployed model, predict through K1 -------
    model = results[("online_coke", "simulator")][0].to_model(wb.rff_params)
    refined, res = model.partial_fit(ws, wide.replace(
        algorithm="qc_odkla", num_iters=10))
    check_history("partial_fit", {k: v.cpu() for k, v in
                                  res.history.items()}, 10)
    x = torch.as_tensor(wb.dataset.x[-1].reshape(-1, 5), device=dev)
    y = torch.as_tensor(wb.dataset.y[-1].reshape(-1), device=dev)
    preds = k1_once(counts, "the refined model's fused predict",
                    lambda: refined.predict(x, backend="fused"))
    ref_preds = refined.predict(x)
    e = float((preds - ref_preds).abs().max())
    mse = float(torch.mean((preds - y) ** 2))
    log(15, f"partial_fit: 10 qc_odkla rounds warm-started from the wide "
            f"online_coke model (meta warm_started="
            f"{refined.meta['warm_started']}); fused predict on {x.shape[0]}"
            f" rows through K1 (1 launch): max|fused - ref| {e:.3e}, mse "
            f"{mse:.5f}")
    if not (refined.meta["warm_started"] and e <= 1e-4):
        raise AssertionError("partial_fit's refined model")
    fit_kernels_idle(counts, "partial_fit")


class StrictFits:
    """While active, every fit and fit_stream loop (`api.fit._chunked_scan`,
    on every backend) runs under torch.cuda.set_sync_debug_mode("error"):
    a host sync inside an iteration raises. Set-up may sync."""

    def __enter__(self):
        import importlib
        self._mod = importlib.import_module("repro_torch.api.fit")
        real = self._real = self._mod._chunked_scan

        def run(*a, **k):
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                return real(*a, **k)
            finally:
                torch.cuda.set_sync_debug_mode("default")

        self._mod._chunked_scan = run
        return self

    def __exit__(self, *exc):
        self._mod._chunked_scan = self._real


def gossip_phase(dev, card, reset_counts, counts, *, problem, cfg, built,
                 coke4, log_problem, log_cfg, peaks, k5_ops):
    """Phase 16: gossip execution and churn on the simulator, spmd and
    fused backends, through K2 (the megakernel path, masked after the
    kernel), K3 (the fused fallback), K1 (predict) and K5 (one launch per
    participation draw). `problem`/`cfg`/`built` are phase 4's cell and
    `coke4` its COKE fit; `log_problem`/`log_cfg` phase 5's. Returns the
    K5 entry of the kernels line."""
    from repro_torch.api import (PAPER_SETUPS, Censor, Chain, ChurnSchedule,
                                 FitConfig, KRRConfig, Quantize,
                                 build_problem, build_stream, fit,
                                 fit_stream, get_solver, sweep)
    from repro_torch.api.backends import (consensus_runner,
                                          stream_consensus_runner)
    from repro_torch.api.config import SolveContext
    from repro_torch.api.fit import _simulator_runner
    from repro_torch.core import comm as comm_mod
    from repro_torch.core import prng
    from repro_torch.core.step import participation_mask
    from repro_torch.kernels.threefry.ref import uniform_ref

    N, T, D = problem.feats.shape
    bw, fp32 = peaks[0], peaks[1]
    # INT32 throughput: 64 INT32 lanes per SM per clock against the fp32
    # peak's 128 FP32 lanes x 2 FLOP of an FMA
    int32_rate = fp32 / 4

    def rose_since(before):
        after = counts()
        return {k: after[k] - before[k] for k in after}

    def theta_err(a, b):
        return float((a.double().cpu() - b.double().cpu()).abs().max())

    def runner(c, prob, comm=None):
        """(carry0, chunk_fn, theta_fn) of config `c` on its backend, with
        its gossip plan on the card; `comm` a LaneChain for sweep lanes."""
        solver = get_solver(c.algorithm)
        ctx = SolveContext.from_config(c, prob.num_agents, dev)
        if comm is not None:
            ctx = dataclasses.replace(ctx, comm=comm)
        if c.backend == "simulator":
            return _simulator_runner(solver, prob, ctx, None)
        if getattr(solver, "streaming", False):
            return stream_consensus_runner(c, solver, prob, ctx)
        return consensus_runner(c, solver, prob, ctx, None)

    def equal_comms(tag, ha, hb):
        for k in ("comms", "bits"):
            if not torch.equal(ha[k].cpu(), hb[k].cpu()):
                raise AssertionError(f"{tag}: {k} differ")

    timings = {}

    # ---- (a) the megakernel path under gossip, K2 every iteration -------
    gcfg = cfg.replace(exec="gossip", participation=GOSSIP_P)
    k5_launches = 0     # over (a)'s two fits: the slice's main path
    with StrictFits():
        for alg in ("coke", "dkla"):
            reset_counts()
            c = gcfg.replace(algorithm=alg)
            res = fit(c, problem=problem, device=dev)
            torch.cuda.synchronize()
            rose = counts()
            if (rose["coke_megastep"] != 2 * ITERS
                    or rose["coke_fused_update"] or rose["threefry"] != ITERS):
                raise AssertionError(f"gossip megakernel {alg}: launches "
                                     f"{rose} in {ITERS} iterations")
            k5_launches += rose["threefry"]
            h = {k: v.cpu() for k, v in res.history.items()}
            check_history(f"gossip megakernel {alg}", h, ITERS)
            comms = int(h["comms"][-1])
            if alg == "dkla" and not 0 < comms < N * ITERS:
                raise AssertionError(f"gossip dkla sent {comms} of "
                                     f"{N * ITERS}: participation missing")
            before = counts()
            model = res.to_model(built.rff_params)
            preds = model.predict(built.x_test, backend="fused")
            torch.cuda.synchronize()
            if rose_since(before)["rff_cos_bias"] != 1 or not torch.isfinite(
                    preds).all():
                raise AssertionError(f"gossip {alg}: predict is not one K1 "
                                     "launch of finite values")
            spmd = fit(c.replace(backend="spmd"), problem=problem,
                       device=dev)
            equal_comms(f"gossip spmd {alg} against the megakernel", h,
                        spmd.history)
            e = theta_err(spmd.theta, res.theta)
            tol = SPMD_RTOL * float(res.theta.abs().max())
            log(16, f"gossip megakernel {alg} (N={N} ring, T={T}, D={D}, "
                    f"participation {GOSSIP_P}, {ITERS} iterations): "
                    f"launches {rose}; comms {comms}/{N * ITERS}, bits "
                    f"{float(h['bits'][-1]):.0f}, train_mse "
                    f"{float(h['train_mse'][0]):.5f} -> "
                    f"{float(h['train_mse'][-1]):.5f}; predict: K1 once; "
                    f"spmd: comms and bits equal, theta max|err| {e:.3e} "
                    f"(tol {tol:.3e}, phase 6's rtol {SPMD_RTOL:g})")
            if not e <= tol:
                raise AssertionError(f"gossip spmd {alg}: theta")
        reset_counts()
        full = fit(cfg.replace(algorithm="coke", exec="gossip",
                               participation=1.0), problem=problem,
                   device=dev)
        torch.cuda.synchronize()
        same = torch.equal(full.theta, coke4.theta) and all(
            torch.equal(full.history[k], coke4.history[k])
            for k in coke4.history)
        log(16, f"gossip megakernel COKE at participation 1.0: theta and "
                f"every history bitwise phase 4's: {same}; launches "
                f"{counts()}")
        if not same:
            raise AssertionError("participation 1.0 differs from phase 4's "
                                 "COKE")

        # ---- (b) the fused fallback (logistic), K3 once per iteration ---
        for alg in ("coke", "dkla"):
            reset_counts()
            c = log_cfg.replace(algorithm=alg, exec="gossip",
                                participation=GOSSIP_P)
            res = fit(c, problem=log_problem, device=dev)
            torch.cuda.synchronize()
            rose = counts()
            if (rose["coke_fused_update"] != ITERS or rose["coke_megastep"]
                    or rose["threefry"] != ITERS):
                raise AssertionError(f"gossip fallback {alg}: launches "
                                     f"{rose} in {ITERS} iterations")
            h = {k: v.cpu() for k, v in res.history.items()}
            check_history(f"gossip fallback {alg}", h, ITERS)
            spmd = fit(c.replace(backend="spmd"), problem=log_problem,
                       device=dev)
            equal_comms(f"gossip spmd logistic {alg}", h, spmd.history)
            e = theta_err(spmd.theta, res.theta)
            tol = SPMD_RTOL * float(res.theta.abs().max())
            log(16, f"gossip fused fallback {alg} (logistic, participation "
                    f"{GOSSIP_P}): launches {rose}; comms "
                    f"{int(h['comms'][-1])}/{N * ITERS}; spmd: comms and "
                    f"bits equal, theta max|err| {e:.3e} (tol {tol:.3e})")
            if not e <= tol:
                raise AssertionError(f"gossip spmd logistic {alg}: theta")

        # ---- (c) fixed size with a straggler on spmd --------------------
        reset_counts()
        straggler = ChurnSchedule(slowdown=(GOSSIP_STRAGGLER,))
        c = cfg.replace(algorithm="dkla", backend="spmd", exec="gossip",
                        gossip_size=GOSSIP_SIZE, churn=straggler)
        res = fit(c, problem=problem, device=dev)
        comms = res.history["comms"].cpu()
        steps = torch.diff(comms, prepend=torch.zeros(1, dtype=comms.dtype))
        sends = (res.state[1]["comm"].bits.cpu()
                 / float(D * comm_mod.FP_BITS))
        slow = int(GOSSIP_STRAGGLER[0])
        others = float(torch.cat([sends[:slow], sends[slow + 1:]]).mean())
        log(16, f"fixed size {GOSSIP_SIZE} with agent {slow} "
                f"{GOSSIP_STRAGGLER[1]}x slower (dkla, spmd, {ITERS} "
                f"iterations): sends per iteration {sorted(set(steps.tolist()))}"
                f"; agent {slow} sent {int(sends[slow])} times, the others "
                f"{others:.2f} on average; launches {counts()}")
        if not bool((steps == GOSSIP_SIZE).all()):
            raise AssertionError("fixed-size gossip did not send exactly "
                                 f"{GOSSIP_SIZE} per iteration")
        # the slowdown's effect over many rounds of the same draws (K5)
        plan = straggler.plan(N, size=GOSSIP_SIZE, device=dev)
        key = comm_mod.uncensored(c.resolved_comm).chain_key()
        share = torch.stack([participation_mask(key, k, N, plan)
                             for k in range(1, GOSSIP_DRAWS + 1)]
                            ).float().mean(0).cpu()
        rest = float(torch.cat([share[:slow], share[slow + 1:]]).mean())
        log(16, f"over {GOSSIP_DRAWS} rounds of the same draws agent {slow} "
                f"participates in {float(share[slow]):.3f} of them, the "
                f"others in {rest:.3f} on average")
        if not float(share[slow]) < 0.75 * rest:
            raise AssertionError("the straggler participates as often as "
                                 "the others")

        # ---- (d) churn on the simulator (CG) and spmd (CG) --------------
        churn = ChurnSchedule(**GOSSIP_CHURN)
        churn_cfg = cfg.replace(algorithm="coke", exec="gossip",
                                participation=GOSSIP_P, churn=churn,
                                primal="cg")
        churned = {}
        for backend in ("simulator", "spmd"):
            reset_counts()
            t0 = time.perf_counter()
            res = fit(churn_cfg.replace(backend=backend), problem=problem,
                      device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            rose = counts()
            if (rose["coke_megastep"] or rose["coke_fused_update"]
                    or rose["threefry"] != ITERS):
                raise AssertionError(f"churn {backend}: launches {rose}")
            h = {k: v.cpu() for k, v in res.history.items()}
            check_history(f"churn {backend}", h, ITERS)
            churned[backend] = res
            log(16, f"churn {GOSSIP_CHURN} on {backend} (CG, participation "
                    f"{GOSSIP_P}, {ITERS} iterations) in {wall:.2f} s wall: "
                    f"comms {int(h['comms'][-1])}/{N * ITERS}, train_mse "
                    f"{float(h['train_mse'][0]):.5f} -> "
                    f"{float(h['train_mse'][-1]):.5f}; launches {rose}")
        sim, spmd = churned["simulator"], churned["spmd"]
        equal_comms("churn simulator against spmd", sim.history,
                    spmd.history)
        e = theta_err(sim.theta, spmd.theta)
        log(16, f"churn: simulator and spmd comms and bits equal; theta "
                f"max|err| {e:.3e} (tol {SIM_CG_BACKEND_TOL:g}, phase 12's "
                "CG across backends)")
        if not e <= SIM_CG_BACKEND_TOL:
            raise AssertionError("churn: theta differs across backends")

    # ---- (e) streams: paper_online's shape, with and without churn ------
    o = ONLINE
    sbase = FitConfig(krr=KRRConfig(num_agents=o["num_agents"],
                                    num_features=o["features"], lam=1e-3,
                                    rho=5e-2, seed=0),
                      graph="ring", censor_v=None, censor_mu=None,
                      num_iters=o["rounds"], online_batch=o["batch"],
                      online_lr=o["lr"], exec="gossip",
                      participation=GOSSIP_STREAM_P)
    ss = build_stream(sbase, device=dev).stream
    R, SN = o["rounds"], o["num_agents"]
    stream_cfgs = {}
    for alg in ("online_coke", "qc_odkla"):
        pol = [Censor(o["v"], o["mu"])] + ([Quantize(bits=o["bits"])]
                                           if alg == "qc_odkla" else [])
        for churned_run in (False, True):
            c = sbase.replace(algorithm=alg, comm=Chain(pol),
                              churn=ChurnSchedule(**GOSSIP_CHURN_10)
                              if churned_run else None)
            stream_cfgs[(alg, churned_run)] = c
            runs = {}
            for backend in ("simulator", "spmd"):
                reset_counts()
                with StrictFits(), CensorRecord() as cens, \
                        QuantizerRecord() as quant:
                    t0 = time.perf_counter()
                    r = fit_stream(c.replace(backend=backend), stream=ss,
                                   device=dev)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                # one draw per round for participation, one more for the
                # quantizer; the recorder draws again (its own launches)
                draws = 2 if alg == "qc_odkla" else 1
                k5_path = counts()["threefry"] - len(quant.calls)
                if k5_path != draws * R:
                    raise AssertionError(f"stream {alg} {backend}: K5 made "
                                         f"{k5_path} launches in {R} rounds")
                fit_kernels_idle(counts, f"gossip stream {alg}")
                runs[backend] = (r, cens, quant, wall)
            (a, ca, qa, wa), (b, cb, qb, wb) = runs["simulator"], runs["spmd"]
            quantized = alg == "qc_odkla"
            parted, held = hold_until_parted(
                f"gossip stream {alg}", a.history, b.history, ca, cb,
                qa if quantized else None, qb if quantized else None)
            if parted:
                gap = parted_mse(f"gossip stream {alg}", a.history,
                                 b.history, key="instant_mse")
                held += f"; instant_mse over the last tenth {gap:.2e} apart"
            log(16, f"gossip stream {alg} (N={SN} ring, b={o['batch']}, "
                    f"D={o['features']}, {R} rounds, participation "
                    f"{GOSSIP_STREAM_P}, churn "
                    f"{GOSSIP_CHURN_10 if churned_run else None}) in "
                    f"{wa:.2f} / {wb:.2f} s wall (simulator / spmd): comms "
                    f"{int(a.comms[-1])}/{SN * R}, simulator against spmd: "
                    f"{held}")

    # ---- (f) a gossip sweep over the paper grid -------------------------
    reset_counts()
    pbase = FitConfig(algorithm="coke", krr=PAPER_SETUPS["synthetic"],
                      num_iters=SWEEP_ITERS, exec="gossip",
                      participation=GOSSIP_P)
    pp = build_problem(pbase, samples_override=SWEEP_SAMPLES,
                       device=dev).problem
    grid = PAPER_GRID + (PAPER_GRID[0],)     # two identical lanes
    G = len(PAPER_GRID)
    with StrictLoops(), CensorRecord() as cens_lanes:
        t0 = time.perf_counter()
        sw = sweep(pbase, grid, problem=pp, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if counts()["threefry"] != SWEEP_ITERS:
        raise AssertionError(f"the gossip sweep made {counts()['threefry']} "
                             f"K5 launches in {SWEEP_ITERS} grid iterations")
    fit_kernels_idle(counts, "the gossip sweep")
    twin = all(torch.equal(sw.history[k][0], sw.history[k][G])
               for k in sw.history) and torch.equal(sw.thetas[0],
                                                     sw.thetas[G])
    if not twin:
        raise AssertionError("two identical gossip lanes differ")
    # each fp32 lane against its own fit: equal until a send decision
    # parts them (gossip's fp32 trajectories meet a knife-edge decision
    # within a few hundred rounds); then each lane and its fit in float64,
    # where they must stay equal to the end
    parted_at = []
    for g in range(G):
        with StrictFits(), CensorRecord() as cens_fit:
            f = fit(sw.cell_config(g), problem=pp, device=dev)
        lane = {k: v[g] for k, v in sw.history.items()}
        parted, held = hold_until_parted(f"gossip sweep cell {g}", lane,
                                         f.history, cens_lanes.lane(g),
                                         cens_fit)
        if parted:
            parted_at.append(g)
            tail = max(1, SWEEP_ITERS // 10)
            a = float(lane["train_mse"][-tail:].double().mean())
            b = float(f.history["train_mse"][-tail:].double().mean())
            held += (f"; train_mse over the last tenth {a:.6f} (lane) / "
                     f"{b:.6f} (fit)")
        log(16, f"gossip sweep cell {g} {PAPER_GRID[g]} in fp32: comms "
                f"{int(lane['comms'][-1])} (fit {int(f.comms[-1])}): {held}")
    p64 = dataclasses.replace(pp, feats=pp.feats.double(),
                              labels=pp.labels.double(),
                              adjacency=pp.adjacency.double())
    with CensorRecord() as cens64:
        sw64 = sweep(pbase, PAPER_GRID, problem=p64, device=dev)
    for g in range(G):
        with CensorRecord() as cens_fit:
            f = fit(sw64.cell_config(g), problem=p64, device=dev)
        lane = {k: v[g] for k, v in sw64.history.items()}
        parted, held = hold_until_parted(f"float64 gossip sweep cell {g}",
                                         lane, f.history, cens64.lane(g),
                                         cens_fit)
        e = theta_err(sw64.thetas[g], f.theta)
        tol = GOSSIP_F64_RTOL * float(f.theta.abs().max())
        log(16, f"gossip sweep cell {g} in float64 against its float64 fit: "
                f"{held}; theta max|err| {e:.3e} (tol {tol:.3e}); train_mse "
                f"{float(lane['train_mse'][-1]):.6f}")
        if parted or not e <= tol:
            raise AssertionError(f"float64 gossip sweep cell {g} parts from "
                                 "its own fit")
    log(16, f"[{card}] gossip sweep: {G} paper cells + a twin of cell 0 "
            f"(N={pp.num_agents} Erdos-Renyi, T={pp.feats.shape[1]}, "
            f"L={pp.feature_dim}, Cholesky, participation {GOSSIP_P}, "
            f"{SWEEP_ITERS} iterations) in {wall:.2f} s wall, one K5 launch "
            f"per grid iteration; the twin lanes bitwise equal; in fp32 "
            f"lanes {parted_at} part from their own fits, in float64 none")

    # ---- (g) the reference's N=200 cell ---------------------------------
    ncfg = FitConfig(krr=KRRConfig(**N200), graph="ring", algorithm="coke",
                     censor_v=0.3, censor_mu=0.97, primal="cg",
                     num_iters=100)
    npb = build_problem(ncfg, device=dev).problem
    t0 = time.perf_counter()
    nsync = fit(ncfg, problem=npb, device=dev)
    ngsp = fit(ncfg.replace(exec="gossip", participation=0.25,
                            num_iters=400), problem=npb, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    g_mse = float(ngsp.train_mse[-1])
    s_mse = float(nsync.train_mse[-1])
    log(16, f"N=200 ring, p=0.25 (400 iterations) against sync (100), CG, "
            f"on the simulator in {wall:.2f} s wall: final train MSE gossip "
            f"{g_mse:.6f} / sync {s_mse:.6f} ({g_mse / s_mse:.3f}x); comms "
            f"{int(ngsp.comms[-1])} / {int(nsync.comms[-1])}. The reference "
            f"on the CPU (its own RFF draw): {N200_REFERENCE_MSE[0]:.6f} / "
            f"{N200_REFERENCE_MSE[1]:.6f} "
            f"({N200_REFERENCE_MSE[0] / N200_REFERENCE_MSE[1]:.3f}x); its "
            "test's 2x bound is not held here")
    if not (math.isfinite(g_mse) and math.isfinite(s_mse)):
        raise AssertionError("the N=200 cell's train MSE is not finite")

    # ---- (h) times: each gossip path beside its sync counterpart --------
    cg_steps = 4
    pairs = [
        ("megakernel COKE", loop_of(runner(gcfg.replace(algorithm="coke"),
                                           problem)),
         loop_of(runner(cfg.replace(algorithm="coke"), problem)), 10),
        ("churn simulator CG", loop_of(runner(
            churn_cfg.replace(backend="simulator"), problem), cg_steps),
         loop_of(runner(cfg.replace(algorithm="coke", primal="cg",
                                    backend="simulator"), problem),
                 cg_steps), cg_steps),
        ("churn spmd CG", loop_of(runner(
            churn_cfg.replace(backend="spmd"), problem), cg_steps),
         loop_of(runner(cfg.replace(algorithm="coke", primal="cg",
                                    backend="spmd"), problem), cg_steps),
         cg_steps),
    ]
    for alg in ("online_coke", "qc_odkla"):
        c = stream_cfgs[(alg, False)]
        pairs.append((f"{alg} round", loop_of(runner(c, ss)),
                      loop_of(runner(c.replace(exec="sync",
                                               participation=1.0), ss)), 10))
    for what, gossip_fn, sync_fn, steps in pairs:
        gd = per_iteration(card, 16, f"gossip {what}", gossip_fn, steps)
        sd = per_iteration(card, 16, f"sync {what}", sync_fn, steps)
        timings[what] = (gd, sd)
        log(16, f"[{card}] {what}: gossip {gd[0]:.4f} ms / {gd[2]} launches "
                f"per iteration, sync {sd[0]:.4f} ms / {sd[2]} launches "
                f"(device ms, profiler launches)")

    # K5 at the participation draw's shape, and its plain version alone
    key = prng.fold_in(prng.PRNGKey(7), 11)
    k5_eager = time_ms(lambda: prng.uniform(key, (N,), dev), reps=100)
    k5_graph = graph_ms(lambda: prng.uniform(key, (N,), dev))
    # the launch floor: a replay of one launch that does no work (zero_()
    # on one element), beside K5's replay
    k5_floor = graph_ms(torch.zeros(1, device=dev).zero_)
    k5_host = host_call_ms(lambda: prng.uniform(key, (N,), dev))
    plain = time_ms(lambda: uniform_ref(key, (N,), dev), reps=20)
    plain_wide = time_ms(lambda: uniform_ref(key, (N, D), dev), reps=20)
    k5_wide = graph_ms(lambda: prng.uniform(key, (N, D), dev))
    ops_word = k5_ops if k5_ops is not None else 80.0
    b_ops = ops_word * N / int32_rate * 1e3
    b_bytes = 4.0 * N / bw * 1e3
    bound_ms, bound_by = max((b_ops, "operations"), (b_bytes, "bytes"))
    log(16, f"[{card}] one uniform of N={N} words: K5 {k5_graph:.6f} ms as a "
            f"CUDA-graph replay (the launch floor, one zero_() on one "
            f"element replayed the same way: {k5_floor:.6f} ms; K5 "
            f"{k5_graph - k5_floor:+.6f} ms above it), "
            f"{k5_eager:.4f} ms eager ({k5_host:.4f} ms "
            f"of host per call); plain version (~173 launches) "
            f"{plain:.4f} ms; bound {bound_ms:.6f} ms ({bound_by}: "
            f"{ops_word:.1f} instructions per word at "
            f"{int32_rate / 1e12:.2f} TOPS INT32, {4 * N} bytes at "
            f"{bw / 1e12:.2f} TB/s). At N x D = {N * D} words (a Quantize "
            f"draw): K5 {k5_wide:.6f} ms, plain {plain_wide:.4f} ms")
    for what, (gd, sd) in timings.items():
        draws = 2 if what == "qc_odkla round" else 1
        log(16, f"[{card}] {what} with K5's plain version in its place "
                f"(estimated from the direct calls above, not run): "
                f"{gd[0] - draws * k5_eager + draws * plain:.4f} ms per "
                f"iteration against {gd[0]:.4f} with K5 and {sd[0]:.4f} "
                "sync")
    src, replaces = KERNEL_SOURCES["threefry"]
    return {"name": "threefry", "route": "cuda", "source": src,
            "replaces": replaces, "launches": k5_launches,
            "max_abs_err": 0.0, "ms": k5_graph, "plain_ms": plain,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def pz_history(tag, h, iters, n_agents):
    """check_history for a personalized run: per_agent_mse is (iters, N)."""
    check_history(tag, {k: v for k, v in h.items() if k != "per_agent_mse"},
                  iters)
    pam = h["per_agent_mse"]
    if pam.shape != (iters, n_agents) or not torch.isfinite(pam).all():
        raise AssertionError(f"{tag}: per_agent_mse is not ({iters}, "
                             f"{n_agents}) finite values")


def check_graph(tag, A, k):
    """A learned graph: symmetric, zero diagonal, row degrees <= k,
    weights in [0, 1]."""
    A = A.cpu()
    deg = int((A > 0).sum(1).max())
    if not (torch.equal(A, A.T) and not A.diagonal().any() and deg <= k
            and float(A.min()) >= 0.0 and float(A.max()) <= 1.0 + 1e-6):
        raise AssertionError(f"{tag}: the learned graph is not symmetric, "
                             f"zero-diagonal, of degree <= {k} (max "
                             f"{deg}) with weights in [0, 1]")
    return deg


def personalize_phase(dev, card, reset_counts, counts):
    """Phase 17: personalization (a learned mutual top-k collaboration
    graph) for fit, fit_stream and sweep on the simulator and spmd, sync
    and gossip; the per-agent deploy through K1 (one launch per model's
    fused evaluate); K5 once per participation draw. No kernel runs in a
    personalized fit's loop: the fused backend, whose kernels take a fixed
    ring, rejects personalization."""
    from repro_torch.api import (Censor, Chain, FitConfig, KernelModel,
                                 KRRConfig, Personalization, build_problem,
                                 build_stream, fit, fit_stream, get_solver,
                                 graph_recovery, sweep)
    from repro_torch.api.backends import (consensus_runner,
                                          stream_consensus_runner)
    from repro_torch.api.config import SolveContext
    from repro_torch.api.fit import _simulator_runner
    from repro_torch.core import personalize as P

    def theta_err(a, b):
        return float((a.double().cpu() - b.double().cpu()).abs().max())

    def equal_comms(tag, ha, hb):
        for k in ("comms", "bits"):
            if not torch.equal(ha[k].cpu(), hb[k].cpu()):
                raise AssertionError(f"{tag}: {k} differ")

    def no_kernels(what, k5=0):
        c = counts()
        if c["threefry"] != k5 or any(v for k, v in c.items()
                                      if k != "threefry"):
            raise AssertionError(f"{what}: launches {c}, K5 expected {k5}")

    def runner(c, prob, ctx_over=None):
        """(carry0, chunk_fn, theta_fn) of config `c` on its backend, with
        the SolveContext fields `ctx_over` replaced (a phase's context)."""
        solver = get_solver(c.algorithm)
        ctx = SolveContext.from_config(c, prob.num_agents, dev)
        if ctx_over:
            ctx = dataclasses.replace(ctx, **ctx_over)
        if c.backend == "simulator":
            return _simulator_runner(solver, prob, ctx, None)
        if getattr(solver, "streaming", False):
            return stream_consensus_runner(c, solver, prob, ctx)
        return consensus_runner(c, solver, prob, ctx, None)

    def per_agent_test_mse(b, theta):
        pred = torch.einsum("nsd,nd->ns", b.feats_test, theta)
        return float(torch.mean((b.labels_test - pred) ** 2))

    # ---- the full-width clustered problem, built once ------------------
    krr = KRRConfig(dataset="heterogeneous", num_agents=N_AGENTS,
                    samples_per_agent=SAMPLES, num_tasks=PZ_TASKS,
                    num_features=FEATURES, lam=1e-3, rho=0.01,
                    censor_v=0.0, censor_mu=0.97, seed=0)
    cfg = FitConfig(krr=krr, graph="ring", num_iters=PZ_ITERS, primal="cg")
    t0 = time.perf_counter()
    built = build_problem(cfg, device=dev)
    torch.cuda.synchronize()
    prob = built.problem
    N, T, D = prob.feats.shape
    pz = Personalization(**PZ_FULL)
    W, K = pz.warmup, pz.k
    pcfg = cfg.replace(personalization=pz)
    log(17, f"heterogeneous problem: N={N} ring, {PZ_TASKS} tasks, T={T} "
            f"train / {built.x_test.shape[1]} test rows per agent, d=5, "
            f"D={D}, Phi {prob.feats.numel() * 4 / 1e9:.3f} GB, built in "
            f"{time.perf_counter() - t0:.1f} s")

    # ---- (a) sync on the simulator and spmd ------------------------------
    runs = {}
    for backend in ("simulator", "spmd"):
        reset_counts()
        with StrictFits():
            static = fit(cfg.replace(backend=backend,
                                     num_iters=PZ_ITERS if backend ==
                                     "simulator" else W),
                         problem=prob, device=dev)
            t0 = time.perf_counter()
            pers = fit(pcfg.replace(backend=backend), problem=prob,
                       device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        no_kernels(f"personalized sync {backend}")
        h = {k: v.cpu() for k, v in pers.history.items()}
        pz_history(f"personalized sync {backend}", h, PZ_ITERS, N)
        for k, v in static.history.items():
            if not torch.equal(v[:W].cpu(), h[k][:W]):
                raise AssertionError(f"personalized {backend}: iterations "
                                     f"1-{W} of {k} are not bitwise the "
                                     "static CG run")
        deg = check_graph(f"personalized sync {backend}",
                          pers.learned_adjacency, K)
        runs[backend] = (pers, static, deg, wall)
    (sim, cons, deg, wall_s), (spmd, _, _, wall_p) = (runs["simulator"],
                                                      runs["spmd"])
    equal_comms("personalized sync, simulator against spmd", sim.history,
                spmd.history)
    A_s, A_p = sim.learned_adjacency.cpu(), spmd.learned_adjacency.cpu()
    support = torch.equal(A_s > 0, A_p > 0)
    a_err = float((A_s - A_p).abs().max())
    e = theta_err(sim.theta, spmd.theta)
    scale = float(sim.theta.abs().max())
    mse_cons = per_agent_test_mse(built, torch.mean(cons.theta, 0).expand(
        cons.theta.shape))
    mse_pers = per_agent_test_mse(built, sim.theta)
    mse_spmd = per_agent_test_mse(built, spmd.theta)
    rec = float(graph_recovery(sim.learned_adjacency, built.clusters))
    # why the two backends' graphs part: the reference's fp32 distances
    # |t_i|^2 + |t_j|^2 - 2 t_i.t_j on the learned edges, against float64
    t64 = sim.theta.double()
    d2_exact = torch.sum((t64[:, None] - t64[None]) ** 2, dim=-1)
    t32 = sim.theta.float()
    sq = torch.sum(t32 * t32, dim=-1)
    d2_fp32 = torch.clamp_min(sq[:, None] + sq[None] - 2.0 * (t32 @ t32.T),
                              0.0).double()
    edges = sim.learned_adjacency > 0
    d2_err = ((d2_fp32 - d2_exact).abs() / d2_exact)[edges]
    log(17, f"[{card}] (a) sync personalized COKE ({PZ_FULL}, CG, "
            f"{PZ_ITERS} iterations) in {wall_s:.2f} / {wall_p:.2f} s wall "
            f"(simulator / spmd), no kernel launched: iterations 1-{W} "
            f"bitwise the static CG run on each backend; comms and bits "
            f"equal across them; learned graphs symmetric, zero diagonal, "
            f"degree <= {deg}. Across the backends: support "
            f"{'equal' if support else 'different'}, weights {a_err:.3e} "
            f"apart, theta max|err| {e:.3e} = {e / scale:.3e} relative "
            f"({'within' if e <= SPMD_RTOL * scale else 'not within'} "
            f"phase 6's rtol {SPMD_RTOL:g}; on the final thetas the "
            f"learned edges' d2, median "
            f"{float(d2_exact[edges].median()):.3e} against a median "
            f"|theta|^2 of {float(sq.median()):.3f}, carry a relative fp32 "
            f"error of median {float(d2_err.median()):.2e}, max "
            f"{float(d2_err.max()):.2e} in the reference's formula "
            f"|t_i|^2 + |t_j|^2 - 2 t_i.t_j); mean per-agent test MSE "
            f"personalized "
            f"{mse_pers:.5f} (spmd {mse_spmd:.5f}) against consensus "
            f"{mse_cons:.5f} at equal bits ({float(sim.bits[-1]):.0f}); "
            f"graph_recovery {rec:.3f} (printed only at full width)")
    if not torch.equal(cons.history["bits"].cpu(), sim.history["bits"].cpu()):
        raise AssertionError("personalized and consensus bits differ at "
                             "censor_v=0")

    # ---- (b) deploy per agent: one K1 launch per model -------------------
    models = sim.to_models(built.rff_params)
    if len(models) != N:
        raise AssertionError(f"to_models gave {len(models)} models")
    reset_counts()
    evals = [m.evaluate(built.x_test[i], built.y_test[i], backend="fused")
             for i, m in enumerate(models)]
    torch.cuda.synchronize()
    deploy_counts = counts()
    if deploy_counts["rff_cos_bias"] != N or any(
            v for k, v in deploy_counts.items() if k != "rff_cos_bias"):
        raise AssertionError(f"the {N} per-agent evaluates launched "
                             f"{deploy_counts}, not K1 once each")
    worst = 0.0
    for i, ev in enumerate(evals):
        pred = built.feats_test[i] @ sim.theta[i]
        want = float(torch.mean((built.y_test[i] - pred) ** 2))
        worst = max(worst, abs(ev["test_mse"] - want) / want)
    if not worst <= PZ_DEPLOY_RTOL:
        raise AssertionError(f"per-agent MSE through K1 is {worst:.2e} "
                             "from the plain product's")
    try:
        sim.to_model(built.rff_params)
    except ValueError as exc:
        if "personalized" not in str(exc):
            raise
    else:
        raise AssertionError("to_model() accepted a personalized fit")
    j = N // 2
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / f"agent{j}")
        models[j].save(path)
        back = KernelModel.load(path, device=dev)
    xj = built.x_test[j]
    if not (torch.equal(back.predict(xj), models[j].predict(xj))
            and back.meta["agent"] == j
            and back.meta["personalization"]["k"] == K):
        raise AssertionError("a per-agent model does not round-trip")
    xs = [built.x_test[i] for i in range(N)]
    k1_ms = time_ms(lambda: [m.featurize(x, "fused")
                             for m, x in zip(models, xs)], reps=5)
    log(17, f"[{card}] (b) to_models: {N} KernelModels; each evaluate on "
            f"its own {xs[0].shape[0]} test rows with backend='fused' "
            f"launched K1 once ({deploy_counts['rff_cos_bias']} in all, "
            f"nothing else); test MSE within {worst:.2e} relative of the "
            f"plain product on feats_test (tol {PZ_DEPLOY_RTOL:g}); agent "
            f"{j}'s model round-trips save/load on the card with equal "
            f"predictions and meta; to_model() raises 'personalized'. The "
            f"{N} K1 launches: {k1_ms:.4f} ms ({k1_ms / N:.4f} ms each)")

    # ---- (c) gossip personalization ---------------------------------------
    gcfg = pcfg.replace(exec="gossip", participation=PZ_GOSSIP_P)
    gruns = {}
    for backend in ("simulator", "spmd"):
        reset_counts()
        with StrictFits():
            g = fit(gcfg.replace(backend=backend), problem=prob, device=dev)
            torch.cuda.synchronize()
        no_kernels(f"personalized gossip {backend}", k5=PZ_ITERS)
        pz_history(f"personalized gossip {backend}",
                   {k: v.cpu() for k, v in g.history.items()}, PZ_ITERS, N)
        check_graph(f"personalized gossip {backend}", g.learned_adjacency, K)
        reset_counts()
        with StrictFits():
            full = fit(gcfg.replace(backend=backend, participation=1.0),
                       problem=prob, device=dev)
        no_kernels(f"personalized gossip p=1 {backend}", k5=PZ_ITERS)
        sync = runs[backend][0]
        if not (all(torch.equal(full.history[k], sync.history[k])
                    for k in sync.history)
                and torch.equal(full.theta, sync.theta)
                and torch.equal(full.learned_adjacency,
                                sync.learned_adjacency)):
            raise AssertionError(f"personalized gossip at participation 1.0 "
                                 f"is not bitwise sync on {backend}")
        gruns[backend] = g
    equal_comms("personalized gossip, simulator against spmd",
                gruns["simulator"].history, gruns["spmd"].history)
    gs, gp = gruns["simulator"], gruns["spmd"]
    support = torch.equal(gs.learned_adjacency.cpu() > 0,
                          gp.learned_adjacency.cpu() > 0)
    log(17, f"[{card}] (c) gossip personalized COKE at participation "
            f"{PZ_GOSSIP_P}: K5 {PZ_ITERS} launches per fit (one per draw), "
            f"nothing else; comms {int(gs.comms[-1])}/{N * PZ_ITERS} and "
            f"bits equal across simulator and spmd; graph support "
            f"{'equal' if support else 'different'}, theta max|err| "
            f"{theta_err(gs.theta, gp.theta):.3e}; at participation 1.0 "
            f"bitwise (a)'s sync run on both backends")

    # ---- (d) personalized streams ------------------------------------------
    o = ONLINE
    SN, R = o["num_agents"], o["rounds"]
    sbase = FitConfig(krr=KRRConfig(num_agents=SN, num_features=o["features"],
                                    lam=1e-3, rho=5e-2, seed=0),
                      graph="ring", censor_v=None, censor_mu=None,
                      comm=Chain([Censor(o["v"], o["mu"])]), num_iters=R,
                      online_batch=o["batch"], online_lr=o["lr"],
                      personalization=Personalization(**PZ_STREAM))
    ss = build_stream(sbase, device=dev).stream
    stream_cfgs = {}
    for alg in ("online_coke", "qc_odkla"):
        for exec_ in ("sync", "gossip"):
            c = sbase.replace(algorithm=alg, exec=exec_,
                              participation=(PZ_GOSSIP_P if exec_ == "gossip"
                                             else 1.0),
                              qc_eta=2.0 if alg == "qc_odkla" else None)
            stream_cfgs[(alg, exec_)] = c
            sr = {}
            for backend in ("simulator", "spmd"):
                reset_counts()
                with StrictFits(), CensorRecord() as cens:
                    t0 = time.perf_counter()
                    r = fit_stream(c.replace(backend=backend), stream=ss,
                                   device=dev)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                no_kernels(f"personalized stream {alg} {exec_} {backend}",
                           k5=R if exec_ == "gossip" else 0)
                check_history(f"personalized stream {alg}",
                              {k: v.cpu() for k, v in r.history.items()}, R)
                check_graph(f"personalized stream {alg} {backend}",
                            r.learned_adjacency, PZ_STREAM["k"])
                sr[backend] = (r, cens, wall)
            (a, ca, wa), (b, cb, wb) = sr["simulator"], sr["spmd"]
            parted, held = hold_until_parted(
                f"personalized stream {alg} {exec_}", a.history, b.history,
                ca, cb)
            if parted:
                gap = parted_mse(f"personalized stream {alg} {exec_}",
                                 a.history, b.history, key="instant_mse")
                held += f"; instant_mse over the last tenth {gap:.2e} apart"
            log(17, f"(d) personalized {alg} {exec_} ({PZ_STREAM}, N={SN} "
                    f"ring, b={o['batch']}, D={o['features']}, {R} rounds) in "
                    f"{wa:.2f} / {wb:.2f} s wall (simulator / spmd): comms "
                    f"{int(a.comms[-1])}/{SN * R}, K5 "
                    f"{R if exec_ == 'gossip' else 0} launches per run; "
                    f"simulator against spmd: {held}")

    # ---- (e) personalized sweeps at BENCH_personalize.json's shape -------
    bcfg = FitConfig(krr=KRRConfig(**PZ_BENCH), graph="ring",
                     num_iters=PZ_BENCH_ITERS, primal="cg")
    bb = build_problem(bcfg, device=dev)
    ecfg = bcfg.replace(num_iters=PZ_SWEEP_ITERS)
    bp = bb.problem
    G = len(PZ_GRID)
    for warmup in PZ_SWEEP_WARMUPS:
        scfg = ecfg.replace(personalization=Personalization(
            **dict(PZ_FULL, warmup=warmup)))
        reset_counts()
        with StrictLoops(), CensorRecord() as cens_lanes:
            t0 = time.perf_counter()
            sw = sweep(scfg, PZ_GRID, problem=bp, device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        no_kernels(f"personalized sweep warmup={warmup}")
        twin = all(torch.equal(sw.history[k][0], sw.history[k][G - 1])
                   for k in sw.history) and torch.equal(sw.thetas[0],
                                                         sw.thetas[G - 1])
        if not twin:
            raise AssertionError("two identical personalized lanes differ")
        notes = []
        for g in range(G - 1):
            with StrictFits(), CensorRecord() as cens_fit:
                f = fit(sw.cell_config(g), problem=bp, device=dev)
            lane = {k: v[g] for k, v in sw.history.items()}
            parted, held = hold_until_parted(
                f"personalized sweep w={warmup} cell {g}", lane, f.history,
                cens_lanes.lane(g), cens_fit)
            if parted:
                held += (f"; train_mse over the last tenth "
                         f"{parted_mse('personalized sweep', lane, f.history):.2e}"
                         " apart")
            notes.append(f"cell {g} {PZ_GRID[g]}: {held}")
        log(17, f"[{card}] (e) personalized sweep, warmup={warmup} ({G} "
                f"cells, the last a twin of the first; N={bp.num_agents} "
                f"ring, T={bp.feats.shape[1]}, D={bp.feature_dim}, CG, "
                f"{PZ_SWEEP_ITERS} iterations) in {wall:.2f} s wall, no "
                f"kernel; the twin lanes bitwise equal; each lane against "
                f"its own fit: " + "; ".join(notes))
    with StrictLoops():
        stat = sweep(ecfg, PZ_GRID, problem=bp, device=dev)
        warm = sweep(ecfg.replace(personalization=Personalization(
            **dict(PZ_FULL, warmup=10 * PZ_SWEEP_ITERS))), PZ_GRID,
            problem=bp, device=dev)
    if not (all(torch.equal(stat.history[k], warm.history[k])
                for k in stat.history)
            and torch.equal(stat.thetas, warm.thetas)):
        raise AssertionError("the all-warmup personalized sweep is not the "
                             "static sweep")
    log(17, "(e) the all-warmup grid (warmup >= the iteration count): every "
            "history and theta bitwise the static sweep's")

    # ---- (f) the reference's acceptance experiment ------------------------
    with StrictFits():
        bcons = fit(bcfg, problem=bp, device=dev)
        bpers = fit(bcfg.replace(personalization=pz), problem=bp, device=dev)
    if not torch.equal(bcons.history["bits"], bpers.history["bits"]):
        raise AssertionError("acceptance: the two arms' bits differ")
    b_cons = per_agent_test_mse(bb, torch.mean(bcons.theta, 0).expand(
        bcons.theta.shape))
    b_pers = per_agent_test_mse(bb, bpers.theta)
    b_rec = float(graph_recovery(bpers.learned_adjacency, bb.clusters))
    log(17, f"[{card}] (f) acceptance at BENCH_personalize.json's shape "
            f"(N={bp.num_agents}, 100 samples, D={bp.feature_dim}, "
            f"{PZ_BENCH_ITERS} iterations, {PZ_FULL}): mean per-agent test "
            f"MSE personalized {b_pers:.5f} against consensus {b_cons:.5f} "
            f"at equal bits ({float(bpers.bits[-1]):.0f}), graph_recovery "
            f"{b_rec:.3f}; the reference (its own RFF draw, "
            f"BENCH_personalize.json): {PZ_REFERENCE[0]} against "
            f"{PZ_REFERENCE[1]}, recovery {PZ_REFERENCE[2]}")
    if not (b_pers < b_cons and b_rec > 0.6):
        raise AssertionError("acceptance: personalized does not beat "
                             "consensus with graph_recovery > 0.6")

    # ---- (g) times --------------------------------------------------------
    sim_cfg = pcfg.replace(backend="simulator")
    steps = 3
    never = Personalization(**dict(PZ_FULL, warmup=10**9))
    always = Personalization(**dict(PZ_FULL, every=1, warmup=0))
    timed = [
        ("warmup-phase iteration (the static CG program)", sim_cfg,
         dict(pz_warmup=True)),
        ("live iteration without a refresh", sim_cfg,
         dict(personalization=never)),
        ("live iteration with a refresh", sim_cfg,
         dict(personalization=always)),
        ("gossip live iteration with a refresh, participation "
         f"{PZ_GOSSIP_P}", gcfg.replace(backend="simulator"),
         dict(personalization=always)),
        ("spmd live iteration with a refresh", pcfg.replace(backend="spmd"),
         dict(personalization=always)),
    ]
    for what, c, over in timed:
        per_iteration(card, 17, f"personalized COKE {what} (N={N}, T={T}, "
                      f"D={D}, CG)", loop_of(runner(c, prob, over), steps),
                      steps)
    for alg, exec_ in (("online_coke", "sync"), ("qc_odkla", "gossip")):
        c = stream_cfgs[(alg, exec_)]
        per_iteration(card, 17, f"personalized {alg} {exec_} round "
                      f"(N={SN}, b={o['batch']}, D={o['features']}, a "
                      f"refresh every {PZ_STREAM['every']} rounds)",
                      loop_of(runner(c, ss, dict(
                          personalization=Personalization(
                              **dict(PZ_STREAM, warmup=0))))))
    for n in (N, PZ_SCALE_N):
        th = torch.randn((n, FEATURES), generator=torch.Generator(
            device=dev).manual_seed(n), device=dev)
        ms = time_ms(lambda: P.learned_adjacency(pz, th), reps=5)
        rows = profiled_kernels(lambda: P.learned_adjacency(pz, th), calls=1)
        log(17, f"[{card}] one learned_adjacency at N={n}, D={FEATURES} "
                f"(k={K}, rbf auto-scaled, row blocks of {min(128, n)}): "
                f"{ms:.4f} ms, "
                + (f"{sum(r[1] for r in rows)} launches"
                   if rows else "launches not measured"))
    return deploy_counts["rff_cos_bias"]


def drive(server, ids, *, clients, requests, batch, seed):
    """benchmarks/many_model_bench.py::_drive with every answer kept:
    `clients` threads each fire `requests` tagged requests of `batch`
    uniform rows at uniform ids, back to back (closed loop). Returns
    (wall s, latencies ms, [(model id, x, answer)])."""
    import threading

    input_dim = server.model.input_dim
    latencies, answers, failures = [], [], []
    lock = threading.Lock()

    def client(cid):
        rng = np.random.default_rng(seed + cid)
        mine, got = [], []
        try:
            for _ in range(requests):
                mid = ids[int(rng.integers(0, len(ids)))]
                x = rng.uniform(size=(batch, input_dim)).astype(np.float32)
                t0 = time.perf_counter()
                out = server.submit(x, mid).result(timeout=120)
                mine.append((time.perf_counter() - t0) * 1e3)
                got.append((mid, x, out))
        except Exception as e:  # noqa: BLE001 - raised below
            failures.append(e)
        with lock:
            latencies.extend(mine)
            answers.extend(got)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    if failures or any(t.is_alive() for t in threads):
        raise AssertionError(f"a serving client failed: {failures[:1]}")
    return wall, latencies, answers


def latency_figures(wall, lat):
    """(QPS, p50 ms, p99 ms) of a closed-loop run's request latencies."""
    lat = np.sort(np.asarray(lat))
    n = len(lat)
    return n / wall, float(lat[n // 2]), float(lat[min(n - 1,
                                                       int(n * 0.99))])


def serve_phase(dev, card, reset_counts, counts, *, built, coke, bw, fp32):
    """Phase 18: many-model serving at full width. One featurizer (phase
    4's: d=5, D=4096) and its COKE fit's 20 per-agent models plus 1004
    variants in a `ModelRegistry`; a resident cell (65 536 ids in one
    `ThetaStore` of 65 537 slots, 1.07 GB) and a paged cell (the 1024
    registry ids through 256 slots) under benchmarks/many_model_bench.py's
    load, each bucket call one K1 and one K6 launch; every answer bitwise
    `score_rows` at its own row count; hot swap under fire; K6 alone
    against its plain version and its bound; one put's copy. Returns K6's
    entry of the kernels line."""
    from repro_torch.kernels.rff import rff as k1
    from repro_torch.kernels.rowdot import rowdot as k6
    from repro_torch.kernels.rowdot.ref import gather_rowdot_ref
    from repro_torch.serve import (KernelServeConfig, KernelServer,
                                   ModelRegistry, ThetaStore)

    t_phase = time.perf_counter()
    base = coke.to_model(built.rff_params, include_per_agent=False)
    D = base.num_features
    scfg = KernelServeConfig(backend="fused", max_delay_ms=SERVE_DELAY_MS)
    load = dict(clients=SERVE_CLIENTS, requests=SERVE_REQUESTS,
                batch=SERVE_BATCH)

    # ---- the registry: 20 per-agent models and their variants -----------
    tmp = tempfile.TemporaryDirectory(prefix="serve-registry-")
    reg = ModelRegistry(tmp.name, device=dev)
    t0 = time.perf_counter()
    agent_ids = [m for m, _ in coke.publish_models(
        reg, prefix="agent", rff_params=built.rff_params)]
    rng = np.random.default_rng(42)
    n_var = SERVE_REGISTRY - len(agent_ids)
    variants = (base.theta.cpu().numpy()[None, :] + rng.normal(
        scale=0.1, size=(n_var, D))).astype(np.float32)
    var_ids = [f"v-{i:04d}" for i in range(n_var)]
    for mid, th in zip(var_ids, variants):
        reg.publish(mid, base.replace(theta=torch.from_numpy(th)))
    reg_ids = agent_ids + var_ids
    reg_thetas = torch.cat([coke.theta, torch.from_numpy(variants).to(dev)])
    log(18, f"[{card}] published {len(reg_ids)} models ({len(agent_ids)} "
            f"per-agent + {n_var} variants, D={D}) into a ModelRegistry in "
            f"{time.perf_counter() - t0:.2f} s")

    def bucket_calls(server, before):
        s = server.stats()
        return s["batches"] - before["batches"], s["rows"] - before["rows"]

    def timed(obj, name, spent):
        """Wrap obj.name to add its host seconds and calls to `spent`."""
        inner = getattr(obj, name)

        def wrapper(*a, **k):
            t0 = time.perf_counter()
            try:
                return inner(*a, **k)
            finally:
                spent[0] += time.perf_counter() - t0
                spent[1] += 1

        setattr(obj, name, wrapper)

    def device_busy(server, ids, seed):
        """A shorter run of the same load under the profiler (device
        activity only): (window ms, kernel ms, launches by kernel)."""
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            drive(server, ids, seed=seed, clients=SERVE_CLIENTS,
                  requests=SERVE_TRACE_REQUESTS, batch=SERVE_BATCH)
            torch.cuda.synchronize()
            window = (time.perf_counter() - t0) * 1e3
        rows = [(device_ms(e), e.count, e.key) for e in prof.key_averages()
                if getattr(e, "device_type", None)
                == torch.autograd.DeviceType.CUDA and device_ms(e) > 0]
        return window, sum(r[0] for r in rows), rows

    def busy_report(label, window, busy, rows):
        if not rows:
            log(18, f"{label}: the profiler recorded no device time: the "
                    "device busy share is not measured")
            return
        top = ", ".join(f"{key[:40]} {ms:.3f} ms x {count}"
                        for ms, count, key in sorted(rows, reverse=True)[:4])
        log(18, f"[{card}] {label}, {SERVE_CLIENTS} x "
                f"{SERVE_TRACE_REQUESTS} requests under the profiler: "
                f"window {window:.2f} ms, kernels {busy:.3f} ms: device "
                f"busy {busy / window:.2%}, idle {1 - busy / window:.2%} "
                f"({top})")

    def report(label, key, server, wall, lat, before, store_before=None):
        """Log a cell's run; its (QPS, p50, p99) go to SERVE_FIGURES[key]
        for phase 28's lines."""
        calls, rows = bucket_calls(server, before)
        n = len(lat)
        qps, p50, p99 = SERVE_FIGURES[key] = latency_figures(wall, lat)
        c = counts()
        msg = (f"[{card}] {label}: {n} requests of {SERVE_BATCH} rows from "
               f"{SERVE_CLIENTS} clients in {wall:.3f} s: "
               f"{qps:.1f} QPS, {n * SERVE_BATCH / wall:.1f} rows/s, "
               f"p50 {p50:.4f} ms, p99 {p99:.4f} ms; {calls} bucket "
               f"calls, {rows / calls:.2f} rows per call; launches {c}")
        if store_before is not None:
            s = server.stats()["store"]
            faults = s["faults"] - store_before["faults"]
            evictions = s["evictions"] - store_before["evictions"]
            msg += f"; {faults} faults, {evictions} evictions"
            if not (faults > 0 and evictions > 0):
                raise AssertionError(f"{label}: the paged cell did not page "
                                     f"({faults} faults, {evictions} "
                                     "evictions)")
        log(18, msg)
        if not c["rff_cos_bias"] == c["gather_rowdot"] == calls or any(
                v for k, v in c.items()
                if k not in ("rff_cos_bias", "gather_rowdot")):
            raise AssertionError(f"{label}: launches {c} over {calls} "
                                 "bucket calls, not one K1 and one K6 each")
        return c["gather_rowdot"]

    worst = [0.0]

    def check_answers(label, answers, theta_of):
        """Every answer bitwise score_rows at its own row count, and
        within SERVE_PREDICT_RTOL of predict's matvec (of sum |phi theta|
        per row)."""
        for mid, x, out in answers:
            theta = theta_of(mid)
            xt = torch.from_numpy(x).to(dev)
            own = base.score_rows(xt, theta.expand(x.shape[0], D),
                                  backend="fused").cpu().numpy()
            if not np.array_equal(out, own):
                raise AssertionError(f"{label}: the answer for {mid} is not "
                                     "bitwise its score_rows")
            model = base.replace(theta=theta)
            pred = model.predict(xt, backend="fused")
            scale = model.featurize(xt, "fused").abs() @ theta.abs()
            rel = float(((torch.from_numpy(out).to(dev) - pred).abs()
                         / scale).max())
            worst[0] = max(worst[0], rel)
            if not rel <= SERVE_PREDICT_RTOL:
                raise AssertionError(f"{label}: the answer for {mid} is "
                                     f"{rel:.3e} of sum|phi theta| from "
                                     "predict")
        log(18, f"{label}: all {len(answers)} answers bitwise score_rows "
                f"at their own row count; worst distance from predict "
                f"{worst[0]:.3e} of sum|phi theta| (tol "
                f"{SERVE_PREDICT_RTOL:g})")

    # ---- (a) the resident cell --------------------------------------------
    res_ids = reg_ids + [f"r-{i:05d}"
                         for i in range(SERVE_RESIDENT - len(reg_ids))]
    gen = torch.Generator(device=dev).manual_seed(18)
    res_thetas = torch.cat([reg_thetas, base.theta + 0.1 * torch.randn(
        (SERVE_RESIDENT - len(reg_ids), D), generator=gen, device=dev)])
    slot_of = {m: i for i, m in enumerate(res_ids)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    store = ThetaStore(SERVE_RESIDENT + 1, D, device=dev)
    t0 = time.perf_counter()
    store.put_many(res_ids, res_thetas)
    torch.cuda.synchronize()
    log(18, f"[{card}] put_many of {SERVE_RESIDENT} ids into a ThetaStore "
            f"of {store.capacity} slots ({store.stack.numel() * 4 / 1e9:.3f}"
            f" GB): {(time.perf_counter() - t0) * 1e3:.2f} ms")
    server = KernelServer(model=base, store=store, config=scfg, device=dev)
    server.predict(np.zeros((SERVE_BATCH, 5), np.float32), res_ids[0])
    flushes = [0.0, 0]
    timed(server, "_flush", flushes)
    before = server.stats()
    reset_counts()
    wall, lat, answers = drive(server, res_ids, seed=0, **load)
    k6_launches = report(f"resident cell ({SERVE_RESIDENT} ids in one "
                         "stack)", "phase 18(a), unsharded", server, wall,
                         lat, before)
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(18, f"[{card}] resident cell: {flushes[1]} collector flushes, "
            f"{flushes[0] * 1e3 / flushes[1]:.4f} ms of host each (resolve, "
            f"pad, upload, K1, K6, copy back, scatter), "
            f"{flushes[0] / wall:.1%} of the run's wall time")
    busy_report("resident cell", *device_busy(server, res_ids, seed=50))
    check_answers("resident cell", answers,
                  lambda m: res_thetas[slot_of[m]])

    # one 1024-row bucket call, device and host
    xs = np.random.default_rng(1).uniform(size=(1024, 5)).astype(np.float32)
    slots = np.random.default_rng(2).integers(
        0, SERVE_RESIDENT, 1024).astype(np.int32)
    snap = store.stack
    bucket = paired_ms(lambda: server._score_padded_multi(snap, xs, slots),
                       1)
    log(18, f"[{card}] one 1024-row bucket call of the resident cell (K1 + "
            f"K6 + the answers' copy to the host): {bucket[0]:.4f} ms on "
            f"the device / {bucket[1]:.4f} ms on the host (paired_ms); peak "
            f"memory over the cell {peak:.3f} GB")

    # one request alone (bucket 32) and inside a full 1024-row bucket
    x1 = np.random.default_rng(3).uniform(size=(SERVE_BATCH, 5)).astype(
        np.float32)
    alone = server.predict(x1, "v-0003")
    server.stop()
    full = KernelServer(model=base, store=store, config=scfg, device=dev,
                        autostart=False)
    rng = np.random.default_rng(4)
    fill = [full.submit(rng.uniform(size=(SERVE_BATCH, 5)).astype(
        np.float32), res_ids[int(rng.integers(0, SERVE_RESIDENT))])
        for _ in range(1024 // SERVE_BATCH - 1)]
    probe = full.submit(x1, "v-0003")
    full.start()
    for f in fill:
        f.result(timeout=120)
    cobatched = probe.result(timeout=120)
    full.stop()
    s = full.stats()
    if (s["batches"], s["rows"], s["padded_rows"]) != (1, 1024, 0):
        raise AssertionError(f"the full bucket ran as {s}")
    if not np.array_equal(alone, cobatched):
        raise AssertionError("a request scored alone and inside a full "
                             "1024-row bucket differs")
    log(18, "one request scored alone (bucket 32) and inside a full "
            "1024-row bucket: bitwise equal")

    # K1's rows do not depend on T
    xk = torch.from_numpy(xs).to(dev)
    phi = k1.rff_cos_bias(xk, base.omega, base.bias)
    for lo in (0, 7, 500, 1022):
        if not torch.equal(k1.rff_cos_bias(xk[lo:lo + 2].contiguous(),
                                           base.omega, base.bias),
                           phi[lo:lo + 2]):
            raise AssertionError(f"K1's rows {lo}, {lo + 1} at T=2 differ "
                                 "from the same rows at T=1024")
    log(18, "K1's rows at T=2 bitwise the same rows at T=1024")

    # hot swap under fire, full width
    server = KernelServer(model=base, store=store, config=scfg, device=dev)
    hot = "v-0007"
    versions = [res_thetas[slot_of[hot]]] + [
        res_thetas[slot_of[hot]] + 0.5 * (k + 1)
        for k in range(SERVE_SWAP_PUBLISHES)]
    xh = torch.from_numpy(x1).to(dev)
    refs = [base.score_rows(xh, v.expand(SERVE_BATCH, D),
                            backend="fused").cpu().numpy() for v in versions]
    import threading
    stop_fire = threading.Event()
    fired, failures = [], []

    def fire():
        try:
            while not stop_fire.is_set():
                fired.append(server.submit(x1, hot).result(timeout=120))
        except Exception as e:  # noqa: BLE001 - raised below
            failures.append(e)

    threads = [threading.Thread(target=fire)
               for _ in range(SERVE_SWAP_CLIENTS)]
    for t in threads:
        t.start()
    for v in versions[1:]:
        time.sleep(0.02)
        server.publish(hot, v)
    time.sleep(0.02)
    stop_fire.set()
    for t in threads:
        t.join(timeout=120)
    server.stop()
    if failures or any(t.is_alive() for t in threads):
        raise AssertionError(f"hot swap: a client failed {failures[:1]}")
    seen = [next((i for i, r in enumerate(refs) if np.array_equal(o, r)),
                 None) for o in fired]
    if None in seen:
        raise AssertionError("hot swap: an answer matched no published "
                             "version (a torn read)")
    log(18, f"hot swap under fire: {len(fired)} answers from "
            f"{SERVE_SWAP_CLIENTS} clients across {SERVE_SWAP_PUBLISHES} "
            f"publishes, each bitwise one version's score_rows; versions "
            f"seen {sorted(set(seen))}")

    # one put's copy on write at full size
    theta_put = versions[-1].clone()
    put_ms = time_ms(lambda: store.put(hot, theta_put, dirty=True), reps=5,
                     runs=5, warmup=2)
    put_host = host_call_ms(lambda: store.put(hot, theta_put, dirty=True),
                            calls=20)
    put_bound = 2 * store.stack.numel() * 4 / bw * 1e3
    log(18, f"[{card}] one ThetaStore.put at {store.capacity} x {D} "
            f"({store.stack.numel() * 4 / 1e9:.3f} GB, a copy of the whole "
            f"stack): {put_ms:.4f} ms on the device, {put_host:.4f} ms host "
            f"enqueue, against {put_bound:.4f} ms to read and write the "
            f"stack once ({put_bound / put_ms:.1%})")
    del server, full, snap, phi

    # ---- (b) the paged cell -----------------------------------------------
    paged = KernelServer(registry=reg, store_capacity=SERVE_REGISTRY // 4,
                         config=scfg, device=dev)
    paged.predict(np.zeros((SERVE_BATCH, 5), np.float32), reg_ids[1])
    flushes, faults = [0.0, 0], [0.0, 0]
    timed(paged, "_flush", flushes)
    timed(paged.store, "fault", faults)
    before = paged.stats()
    store_before = dict(before["store"])
    reset_counts()
    wall, lat, answers = drive(paged, reg_ids, seed=100, **load)
    k6_launches += report(f"paged cell ({SERVE_REGISTRY} registry ids "
                          f"through {SERVE_REGISTRY // 4} slots)",
                          "phase 18(b), paged", paged, wall, lat, before,
                          store_before)
    log(18, f"[{card}] paged cell: {flushes[1]} collector flushes, "
            f"{flushes[0] * 1e3 / flushes[1]:.4f} ms of host each, "
            f"{flushes[0] / wall:.1%} of the run's wall time; {faults[1]} "
            f"faults (registry load, featurizer check), "
            f"{faults[0] * 1e3 / faults[1]:.4f} ms each, "
            f"{faults[0] / wall:.1%} of the wall time")
    busy_report("paged cell", *device_busy(paged, reg_ids, seed=150))
    paged.stop()
    reg_slot = {m: i for i, m in enumerate(reg_ids)}
    check_answers("paged cell", answers, lambda m: reg_thetas[reg_slot[m]])
    tmp.cleanup()

    # ---- (c) K6 alone ---------------------------------------------------
    gen = torch.Generator(device=dev).manual_seed(6)
    err = 0.0
    for B in SERVE_ROWDOT_B:
        for d in SERVE_ROWDOT_D:
            p = math.sqrt(2.0 / d) * torch.cos(
                6.3 * torch.rand((B, d), generator=gen, device=dev))
            st = torch.randn((300, d), generator=gen, device=dev)
            sl = torch.randint(0, 300, (B,), generator=gen,
                               device=dev).to(torch.int32)
            got = k6.gather_rowdot(p, st, sl.cpu().numpy())
            want = gather_rowdot_ref(p, st, sl)
            scale = (p * st[sl.long()]).abs().sum(-1)
            e = float(((got - want).abs() / scale).max())
            off = torch.empty(B * d + 1, device=dev)[1:].view(B, d)
            off.copy_(p)
            same = torch.equal(k6.gather_rowdot(off, st, sl.cpu().numpy()),
                               got)
            log(18, f"K6 gather_rowdot B={B} D={d} [{k6.staging(p, st)}]: "
                    f"max|err| / sum|phi theta| {e:.3e} (tol "
                    f"{ROWDOT_RTOL:g}); the 4-byte instance on an unaligned "
                    f"copy gives the same bits: {same}")
            if not (e <= ROWDOT_RTOL and same):
                raise AssertionError(f"K6 disagrees with its plain version "
                                     f"at B={B} D={d}")
            if (B, d) == (1024, D):
                err = float((got - want).abs().max())
    stack = store.stack
    phi = k1.rff_cos_bias(xk, base.omega, base.bias)
    d_slots = torch.from_numpy(slots).to(dev)
    long_slots = d_slots.long()
    out = torch.empty(1024, device=dev)
    k6_warm = graph_ms(lambda: k6.launch(phi, stack, d_slots, out))
    flush = torch.empty(64 * 2**20, device=dev)      # 256 MB > the L2
    k6_cold = flushed_ms(lambda: k6.launch(phi, stack, d_slots, out), flush)
    k6_ms = flushed_ms(lambda: k6.launch(phi, stack, d_slots, out), flush,
                       clean=True)
    del flush
    k6_call_ms = time_ms(lambda: k6.gather_rowdot(phi, stack, slots))
    plain_ms = time_ms(lambda: gather_rowdot_ref(phi, stack, d_slots))
    lib_ms = time_ms(lambda: torch.einsum("bd,bd->b", phi,
                                          stack[long_slots]))
    nbytes = 4.0 * (2 * 1024 * D + 2 * 1024)
    flops = 2.0 * 1024 * D
    t_b, t_f = nbytes / bw * 1e3, flops / fp32 * 1e3
    b_ms, b_by = (t_b, "bytes") if t_b >= t_f else (t_f, "operations")
    log(18, f"[{card}] K6 at (B, D)=(1024, {D}) from the {store.capacity}-"
            f"slot stack: {k6_ms:.6f} ms (the launch alone, cold L2: 256 MB "
            f"written and read back before each call); {k6_cold:.6f} ms "
            f"after a written flush (the call evicts dirty lines); "
            f"{k6_warm:.6f} ms as a CUDA-graph replay (phi and the gathered "
            f"rows stay in the L2); {k6_call_ms:.6f} ms per wrapper call "
            f"(with the slots' upload); bound {b_ms:.6f} ms ({b_by}: "
            f"{nbytes / 1e6:.3f} MB; {b_ms / k6_ms:.1%} of it cold), plain "
            f"{plain_ms:.6f} ms (index_select, mul, sum), "
            f"torch.einsum('bd,bd->b', phi, stack[slots]) {lib_ms:.6f} ms "
            "(two calls: no single PyTorch call gathers and row-dots)")
    log(18, f"[{card}] phase 18 took {time.perf_counter() - t_phase:.1f} s")
    src, replaces = KERNEL_SOURCES["gather_rowdot"]
    return {"name": "gather_rowdot", "route": "cuda", "source": src,
            "replaces": replaces, "launches": k6_launches,
            "max_abs_err": err, "ms": k6_ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}


def k1_block_errors(mesh, xb, omega, bias, num_features):
    """K1 on rows xb against rff_ref, on every feature block of a sharded
    omega and bias that this process holds, scaled for the whole width:
    (max |err|, tolerance, the blocks' shape)."""
    from repro_torch.distributed import sharding
    from repro_torch.kernels.rff import rff as k1
    from repro_torch.kernels.rff.ref import rff_ref

    worst = tol = 0.0
    for m in sorted({m for _, m in mesh.local_cells()}):
        ob = sharding.local_block(omega, 0, m)
        bb = sharding.local_block(bias, 0, m)
        got = k1.rff_cos_bias(xb, ob, bb, num_features=num_features)
        want = rff_ref(xb, ob, bb, num_features)
        worst = max(worst, float((got - want).abs().max()))
        tol = max(tol, k1_tolerance(xb, ob, num_features))
    torch.cuda.synchronize()
    return worst, tol, tuple(ob.shape)


def k3_block_errors(mesh, theta, rho, seed):
    """The ring runtime's K3 call on every block of a feature-sharded
    carry that this process holds (the path's wrapper on `theta` and its
    ring neighbours, one
    neighbour tensor as both halves as the fallback passes it) against
    coke_update_ref on the same blocks: (max |g_aug err|, its tolerance,
    max relative err of xi^2 against the plain partials summed in block
    order (None where other ranks hold some of a row's model blocks), the
    blocks' shape)."""
    from repro_torch.distributed import sharding
    from repro_torch.kernels.coke_update import ops as k3_ops
    from repro_torch.kernels.coke_update.ref import coke_update_ref
    from repro_torch.launch.mesh import num_agents

    N = theta.shape[0]
    gen = torch.Generator(device=theta.device).manual_seed(seed)
    half = 0.5 * (theta.roll(1, 0) + theta.roll(-1, 0))
    ops = [theta, 0.5 * theta] + [1e-2 * torch.randn(
        theta.shape, generator=gen, device=theta.device)
        for _ in range(2)] + [half]
    blocked = [sharding.shard_features(t, mesh, N) for t in ops]
    kw = dict(rho=rho, deg=2.0)
    got_g, got_xi = k3_ops.coke_update_blocks(*blocked, blocked[4], **kw)
    worst_g = worst_xi = tol_g = 0.0
    cut = N % num_agents(mesh) == 0
    cells = mesh.local_cells()
    got_xi = sharding.unshard(got_xi)
    for b in sorted({b for b, _ in cells}) if cut else [0]:
        xi = None
        for m in sorted({m for _, m in cells}):
            blk = [sharding.local_block(t, b, m) for t in blocked]
            want, want_xi = coke_update_ref(*blk, blk[4], **kw)
            worst_g = max(worst_g, float(
                (sharding.local_block(got_g, b, m) - want).abs().max()))
            tol_g = max(tol_g, k3_tolerance(*blk, blk[4], **kw))
            xi = want_xi if xi is None else xi + want_xi
        if mesh.split[1] > 1:    # xi^2 sums model blocks other ranks hold
            worst_xi = None
            continue
        rows = sharding.block_index(got_g, 0, b, 0)
        worst_xi = max(worst_xi, float((got_xi[rows] - xi).abs().max()
                                       / xi.abs().max()))
    torch.cuda.synchronize()
    return worst_g, tol_g, worst_xi, tuple(sharding.local_block(
        blocked[0], *cells[0]).shape)


def shard_phase(dev, card, reset_counts, counts, *, problem, cfg, built,
                coke4, log_problem, log_cfg, log_coke):
    """Phase 19: big-D feature sharding on a SHARD_MESH mesh whose every
    cell is the card. (a) phase 4's problem blocked once: COKE on the
    simulator and spmd (CG) and phase 4's fused COKE (the K3 fallback,
    once per block), phase 5's logistic cell, a Censor + Drop chain (K5
    once per draw) and one Quantize round of the unsharded draw, each
    against its unsharded run; (b) benchmarks/big_d_bench.py's D = 65536
    point on (1, 4) and (2, 4) meshes against mesh=None; (c) phase 4's
    COKE model sharded: predict (K1 once per feature block) and phase
    18(a)'s resident cell from a sharded store through a sharded server
    (K1 and K6 once per (row, feature) block per bucket call). Every fit
    loop runs under set_sync_debug_mode("error"). Returns the phase's
    launch counts by kernel."""
    from repro_torch.api import (Censor, Chain, Drop, FitConfig, KRRConfig,
                                 Quantize, build_problem, fit, get_solver)
    from repro_torch.api.backends import consensus_runner
    from repro_torch.api.config import SolveContext
    from repro_torch.core import prng
    from repro_torch.distributed import sharding
    from repro_torch.kernels.rff import rff as k1
    from repro_torch.kernels.rowdot import rowdot as k6
    from repro_torch.kernels.rowdot.ref import gather_rowdot_ref
    from repro_torch.kernels.threefry import threefry as k5
    from repro_torch.kernels.threefry.ref import uniform_ref
    from repro_torch.launch.mesh import make_host_mesh, num_agents
    from repro_torch.serve import KernelServeConfig, KernelServer, ThetaStore
    fit_module = importlib.import_module("repro_torch.api.fit")

    t_phase = time.perf_counter()
    mesh = make_host_mesh(*SHARD_MESH, device=dev)
    N, T, D = problem.feats.shape
    blocks = mesh.size
    seen = {k: 0 for k in LAUNCH_COUNTERS}

    def tally(c):
        for k, v in c.items():
            seen[k] += v
        return c

    def strict(fn):
        """fn with the fit loop (`_chunked_scan`) under
        set_sync_debug_mode("error"); set-up may sync."""
        real = fit_module._chunked_scan

        def wrapped(*a, **k):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return real(*a, **k)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        fit_module._chunked_scan = wrapped
        try:
            out = fn()
        finally:
            fit_module._chunked_scan = real
        torch.cuda.synchronize()
        return out

    def same_comms(tag, a, b):
        for k in ("comms", "bits"):
            if not torch.equal(a.history[k].cpu(), b.history[k].cpu()):
                raise AssertionError(f"{tag}: {k} differ from the unsharded "
                                     "run")

    def err(a, b):
        return float((a.double().cpu() - b.double().cpu()).abs().max())

    def runner_of(c, prob, m):
        ctx = SolveContext.from_config(c)
        solver = get_solver(c.algorithm)
        if c.backend == "simulator":
            return fit_module._simulator_runner(solver, prob, ctx, None,
                                                mesh=m)
        return consensus_runner(c, solver, prob, ctx, None, mesh=m)

    def only(tag, cnt, want):
        """The launch counts of one part: exactly `want`, 0 elsewhere."""
        got = {k: v for k, v in cnt.items() if v}
        if got != {k: v for k, v in want.items() if v}:
            raise AssertionError(f"{tag}: launches {got}, expected {want}")

    # each kernel of the phase against its plain version on the same
    # inputs, at the block shapes the path above gave it (these launches
    # come after the part's counts were read, and are not counted)
    errs = {}

    def hold(name, tag, e, tol, launches):
        log(19, f"[{card}] {name} at {tag}: max|err| {e:.3e} (tol "
                f"{tol:.3e}) against its plain version; {launches} "
                "launches in the part above")
        if not e <= tol:
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"at {tag}: {e} > {tol}")
        errs[name] = max(errs.get(name, 0.0), e)

    def hold_k1(tag, xb, omega, bias, launches):
        worst, tol, shape = k1_block_errors(mesh, xb, omega, bias, D)
        hold("rff_cos_bias", f"{tag}, x {tuple(xb.shape)} on "
             f"{mesh.shape['model']} feature blocks of {shape}", worst, tol,
             launches)

    # ---- (a) the fit cells at full width ----------------------------------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    sp = sharding.shard_problem(problem, mesh)
    torch.cuda.synchronize()
    blk = sharding.local_block(sp.feats)
    log(19, f"[{card}] shard_problem on a {SHARD_MESH} mesh ({blocks} cells, "
            f"all {dev}): Phi {tuple(problem.feats.shape)} into "
            f"{len(sp.feats.blocks)} contiguous blocks of {tuple(blk.shape)} "
            f"in {(time.perf_counter() - t0) * 1e3:.2f} ms; the blocks hold "
            f"{(torch.cuda.memory_allocated() - held) / 1e9:.3f} GB (the one "
            "blocked copy: every fit below runs on it; on one card a mesh "
            "is a layout, not a saving)")

    cg_cfg = cfg.replace(algorithm="coke", primal="cg",
                         num_iters=SHARD_CG_ITERS)
    for backend in ("simulator", "spmd"):
        c = cg_cfg.replace(backend=backend)
        plain = fit(c, problem=problem, device=dev)
        reset_counts()
        t0 = time.perf_counter()
        sh = strict(lambda: fit(c, problem=sp, device=dev, mesh=mesh))
        wall = time.perf_counter() - t0
        only(f"{backend} CG on the mesh", tally(counts()), {})
        same_comms(f"{backend} CG", sh, plain)
        e = err(sh.theta, plain.theta)
        log(19, f"[{card}] COKE {backend} CG on the mesh, "
                f"{SHARD_CG_ITERS} iterations in {wall:.2f} s wall: comms "
                f"{int(sh.history['comms'][-1])}/{N * SHARD_CG_ITERS} and "
                f"bits equal the unsharded run's, theta max|err| {e:.3e} "
                f"(tol {SHARD_CG_TOL:g}); no kernel launched (the CG path "
                "has none)")
        if not e <= SHARD_CG_TOL:
            raise AssertionError(f"{backend} CG on the mesh: theta differs")
        for label, prob, m in (("sharded", sp, mesh),
                               ("unsharded", problem, None)):
            per_iteration(card, 19, f"COKE {backend} CG {label}",
                          loop_of(runner_of(c, prob, m), steps=1), steps=1,
                          runs=SHARD_RUNS)

    # phase 4's fused COKE: on a mesh the megakernel's gate sends it to the
    # ring runtime, K3 once per block of the carry
    fc = cfg.replace(algorithm="coke")
    reset_counts()
    t0 = time.perf_counter()
    sh = strict(lambda: fit(fc, problem=sp, device=dev, mesh=mesh))
    wall = time.perf_counter() - t0
    only("fused COKE on the mesh", tally(counts()),
         {"coke_fused_update": blocks * ITERS})
    same_comms("fused COKE", sh, coke4)
    e = err(sh.theta, coke4.theta)
    tol = SPMD_RTOL * float(coke4.theta.abs().max())
    log(19, f"[{card}] phase 4's fused COKE on the mesh, {ITERS} iterations "
            f"in {wall:.2f} s wall: K3 {blocks} x {ITERS} launches (one per "
            f"block of the carry per iteration), K2 none; comms "
            f"{int(sh.history['comms'][-1])}/{N * ITERS} and bits equal the "
            f"megakernel fit's, theta max|err| {e:.3e} (tol {tol:.3e}, "
            f"phase 6's)")
    if not e <= tol:
        raise AssertionError("fused COKE on the mesh: theta differs")
    # K3 per carry block: the path's wrapper on the fit's theta
    worst_g, tol_g, worst_xi, shape = k3_block_errors(mesh, coke4.theta,
                                                      problem.rho, 19)
    hold("coke_fused_update", f"the carry's {blocks} blocks of {shape} "
         "(g_aug)", worst_g, tol_g, blocks * ITERS)
    log(19, f"[{card}]   and its xi^2, the psum of the blocks' partials "
            f"against the plain partials summed in block order: max "
            f"relative err {worst_xi:.3e} (tol {K3_XI_RTOL:g})")
    if not worst_xi <= K3_XI_RTOL:
        raise AssertionError("K3's xi^2 on blocks disagrees with its plain "
                             "version")
    for label, prob, m in (("sharded (K3 per block)", sp, mesh),
                           ("unsharded (K2)", problem, None)):
        per_iteration(card, 19, f"fused COKE {label}",
                      loop_of(runner_of(fc, prob, m), steps=5), steps=5)

    # phase 5's logistic cell on the same blocks of Phi
    _, lspec, _ = sharding.problem_specs(log_problem, mesh)
    slp = dataclasses.replace(sp, labels=sharding.shard(
        log_problem.labels, mesh, lspec), loss="logistic")
    lc = log_cfg.replace(algorithm="coke")
    reset_counts()
    sh = strict(lambda: fit(lc, problem=slp, device=dev, mesh=mesh))
    only("logistic COKE on the mesh", tally(counts()),
         {"coke_fused_update": blocks * ITERS})
    same_comms("logistic COKE", sh, log_coke)
    e = err(sh.theta, log_coke.theta)
    tol = SPMD_RTOL * float(log_coke.theta.abs().max())
    log(19, f"[{card}] phase 5's logistic COKE on the mesh: K3 {blocks} x "
            f"{ITERS}, comms {int(sh.history['comms'][-1])} and bits equal "
            f"phase 5's, theta max|err| {e:.3e} (tol {tol:.3e})")
    if not e <= tol:
        raise AssertionError("logistic COKE on the mesh: theta differs")

    # a chain with a drawing stage: Drop's (N,) draw once per iteration
    v, mu = cfg.resolved_censor
    chain = Chain([Censor(v, mu), Drop(CHAIN_DROP)])
    cc = fc.replace(comm=chain, censor_v=None, censor_mu=None)
    plain = fit(cc, problem=problem, device=dev)
    reset_counts()
    sh = strict(lambda: fit(cc, problem=sp, device=dev, mesh=mesh))
    only("chain COKE on the mesh", tally(counts()),
         {"coke_fused_update": blocks * ITERS, "threefry": ITERS})
    same_comms("chain COKE", sh, plain)
    e = err(sh.theta, plain.theta)
    tol = SPMD_RTOL * float(plain.theta.abs().max())
    log(19, f"[{card}] fused COKE with Chain([Censor({v}, {mu}), "
            f"Drop({CHAIN_DROP})]) on the mesh: K5 {ITERS} (one draw per "
            f"iteration, over the unsharded (N,)), K3 {blocks} x {ITERS}; "
            f"comms and bits equal the unsharded (megakernel) chain fit's, "
            f"theta max|err| {e:.3e} (tol {tol:.3e})")
    if not e <= tol:
        raise AssertionError("chain COKE on the mesh: theta differs")

    # one Quantize round on blocks: one draw of the unsharded (N, D) shape
    q = Chain([Censor(v, mu), Quantize(bits=CHAIN_BITS), Drop(CHAIN_DROP)])
    prev = 0.5 * coke4.theta
    want_hat, want_send, want_st = q.apply(coke4.theta, prev, 7,
                                           q.init_state(N, dev))
    bt = sharding.shard_features(coke4.theta, mesh, N)
    bp = sharding.shard_features(prev, mesh, N)
    reset_counts()
    got_hat, got_send, got_st = q.apply(bt, bp, 7, q.init_state(N, dev))
    torch.cuda.synchronize()
    only("one Quantize round on the mesh", tally(counts()), {"threefry": 2})
    if not (torch.equal(sharding.unshard(got_hat), want_hat)
            and torch.equal(sharding.unshard(got_send), want_send)
            and torch.equal(sharding.unshard(got_st.bits), want_st.bits)):
        raise AssertionError("a Quantize round on blocks differs from the "
                             "unsharded round")
    log(19, f"[{card}] one Censor + Quantize({CHAIN_BITS}) + Drop round on "
            f"blocks: K5 twice (one ({N}, {D}) draw split into the blocks, "
            "one (N,) draw); payload, decisions and bits bitwise the "
            "unsharded round's")
    key = prng.fold_in(prng.PRNGKey(19), 7)
    same = all(torch.equal(
        k5.threefry_draw(key, shape, dev, uniform=True).view(torch.int32),
        uniform_ref(key, shape, dev).view(torch.int32))
        for shape in ((N,), (N, D)))
    hold("threefry", f"the draws' shapes ({N},) and ({N}, {D}), bitwise",
         0.0 if same else math.inf, 0.0, seen["threefry"])
    del sh, plain, bt, bp, slp
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(19, f"[{card}] (a) peak memory {peak:.3f} GB (phase 4's Phi "
            f"{problem.feats.numel() * 4 / 1e9:.3f} GB, held by the caller, "
            "plus its blocked copy and the fits' state)")
    del sp
    torch.cuda.empty_cache()

    # ---- (b) the big-D point ----------------------------------------------
    bcfg = FitConfig(krr=KRRConfig(lam=1e-3, rho=1e-2, seed=0,
                                   **SHARD_BIG_D),
                     graph="ring", algorithm="coke", censor_v=0.5,
                     censor_mu=0.97, primal="cg",
                     num_iters=SHARD_BIG_D_ITERS)
    bprob = build_problem(bcfg, device=dev).problem
    bn, bt_, bd = bprob.feats.shape
    log(19, f"[{card}] big-D point: Phi {tuple(bprob.feats.shape)} "
            f"({bprob.feats.numel() * 4 / 1e9:.3f} GB), CG, "
            f"{SHARD_BIG_D_ITERS} iterations")
    for backend in ("simulator", "spmd"):
        c = bcfg.replace(backend=backend)
        plain = fit(c, problem=bprob, device=dev)
        base_t = per_iteration(card, 19, f"big-D {backend} CG unsharded",
                               loop_of(runner_of(c, bprob, None), steps=1),
                               steps=1, runs=SHARD_RUNS)
        for shape in SHARD_BIG_D_MESHES:
            m = make_host_mesh(*shape, device=dev)
            bsp = sharding.shard_problem(bprob, m)
            reset_counts()
            sh = strict(lambda: fit(c, problem=bsp, device=dev, mesh=m))
            only(f"big-D {backend} {shape}", tally(counts()), {})
            same_comms(f"big-D {backend} {shape}", sh, plain)
            e = err(sh.theta, plain.theta)
            t = per_iteration(card, 19, f"big-D {backend} CG on {shape}",
                              loop_of(runner_of(c, bsp, m), steps=1),
                              steps=1, runs=SHARD_RUNS)
            log(19, f"[{card}] big-D {backend} CG on a {shape} mesh: comms "
                    f"{int(sh.history['comms'][-1])}/{bn * SHARD_BIG_D_ITERS}"
                    f" and bits equal mesh=None's, theta max|err| {e:.3e} "
                    f"(tol {SHARD_CG_TOL:g}); {t[0]:.4f} ms per iteration "
                    f"on the device against {base_t[0]:.4f} ms unsharded")
            if not e <= SHARD_CG_TOL:
                raise AssertionError(f"big-D {backend} {shape}: theta "
                                     "differs")
            del bsp, sh
    del bprob
    torch.cuda.empty_cache()

    # ---- (c) deploy and serve ---------------------------------------------
    model = coke4.to_model(built.rff_params)
    sm = model.shard(mesh)
    x = built.x_test
    reset_counts()
    got = sm.predict(x, backend="fused")
    torch.cuda.synchronize()
    only("sharded predict", tally(counts()),
         {"rff_cos_bias": mesh.shape["model"]})
    want = model.predict(x, backend="fused")
    flat = x.reshape(-1, x.shape[-1])
    scale = (model.featurize(flat, "fused").abs()
             @ model.theta.abs()).reshape(want.shape)
    rel = float(((got - want).abs() / scale).max())
    log(19, f"[{card}] the sharded COKE model's predict on "
            f"{flat.shape[0]} rows: K1 {mesh.shape['model']} launches (one "
            f"per feature block), within {rel:.3e} of sum|phi theta| of the "
            f"unsharded predict (tol {SHARD_PREDICT_RTOL:g})")
    if not (got.shape == want.shape and rel <= SHARD_PREDICT_RTOL):
        raise AssertionError("the sharded predict differs")
    hold_k1("the sharded predict", flat, sm.omega, sm.bias,
            mesh.shape["model"])

    base = coke4.to_model(built.rff_params, include_per_agent=False)
    scfg = KernelServeConfig(backend="fused", max_delay_ms=SERVE_DELAY_MS)
    res_ids = [f"r-{i:05d}" for i in range(SERVE_RESIDENT)]
    gen = torch.Generator(device=dev).manual_seed(19)
    res_thetas = torch.cat([coke4.theta, base.theta + 0.1 * torch.randn(
        (SERVE_RESIDENT - N, D), generator=gen, device=dev)])
    slot_of = {m: i for i, m in enumerate(res_ids)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    store = ThetaStore(SERVE_RESIDENT + 1, D, device=dev, mesh=mesh)
    t0 = time.perf_counter()
    store.put_many(res_ids, res_thetas)
    torch.cuda.synchronize()
    sblk = sharding.local_block(store.stack)
    log(19, f"[{card}] put_many of {SERVE_RESIDENT} ids into a ThetaStore "
            f"on the mesh: {len(store.stack.blocks)} blocks of "
            f"{tuple(sblk.shape)} in {(time.perf_counter() - t0) * 1e3:.2f}"
            " ms")
    server = KernelServer(model=base, store=store, config=scfg, mesh=mesh,
                          device=dev)
    server.predict(np.zeros((SERVE_BATCH, 5), np.float32), res_ids[0])
    cells = num_agents(mesh) * mesh.shape["model"]
    before = server.stats()
    reset_counts()
    wall, lat, answers = drive(server, res_ids, seed=0,
                               clients=SERVE_CLIENTS,
                               requests=SERVE_REQUESTS, batch=SERVE_BATCH)
    c = tally(counts())
    s = server.stats()
    calls = s["batches"] - before["batches"]
    only("the sharded resident cell", c,
         {"rff_cos_bias": cells * calls, "gather_rowdot": cells * calls})
    qps, p50, p99 = SERVE_FIGURES["phase 19(c), one-process mesh"] = \
        latency_figures(wall, lat)
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(19, f"[{card}] sharded resident cell: {len(lat)} requests of "
            f"{SERVE_BATCH} rows from {SERVE_CLIENTS} clients in "
            f"{wall:.3f} s: {qps:.1f} QPS, p50 {p50:.4f} ms, "
            f"p99 {p99:.4f} ms; {calls} bucket "
            f"calls, K1 = K6 = {cells} x {calls} (one per (row, feature) "
            f"block); peak memory {peak:.3f} GB")
    worst = 0.0
    for mid, xq, out in answers:
        theta = res_thetas[slot_of[mid]]
        xt = torch.from_numpy(xq).to(dev)
        own = server.model.score_rows(xt, theta.expand(xq.shape[0], D),
                                      backend="fused").cpu().numpy()
        if not np.array_equal(out, own):
            raise AssertionError(f"sharded cell: the answer for {mid} is "
                                 "not bitwise the sharded score_rows")
        plain_out = base.score_rows(xt, theta.expand(xq.shape[0], D),
                                    backend="fused")
        sc = base.featurize(xt, "fused").abs() @ theta.abs()
        worst = max(worst, float(((torch.from_numpy(out).to(dev)
                                   - plain_out).abs() / sc).max()))
    log(19, f"sharded resident cell: all {len(answers)} answers bitwise the "
            f"sharded score_rows at their own row count; worst distance "
            f"from the unsharded answer {worst:.3e} of sum|phi theta| (tol "
            f"{SERVE_PREDICT_RTOL:g})")
    if not worst <= SERVE_PREDICT_RTOL:
        raise AssertionError("a sharded answer is far from the unsharded")
    # a full bucket's row block: 1024 rows over the batch axes
    rb = 1024 // num_agents(mesh)
    xb = torch.rand((rb, 5), generator=gen, device=dev)
    hold_k1("a bucket's row block", xb, server.model.omega,
            server.model.bias, cells * calls)
    slots = np.random.default_rng(5).integers(
        0, SERVE_RESIDENT, rb).astype(np.int32)
    worst6 = 0.0
    for m in range(mesh.shape["model"]):
        ob = sharding.local_block(server.model.omega, 0, m)
        bb = sharding.local_block(server.model.bias, 0, m)
        pb = k1.rff_cos_bias(xb, ob, bb, num_features=D)
        st = sharding.local_block(store.stack, 0, m)
        got6 = k6.gather_rowdot(pb, st, slots)
        sl = torch.from_numpy(slots).to(dev)
        want6 = gather_rowdot_ref(pb, st, sl)
        sc = (pb * st[sl.long()]).abs().sum(-1)
        worst6 = max(worst6, float(((got6 - want6).abs() / sc).max()))
    torch.cuda.synchronize()
    hold("gather_rowdot", f"{mesh.shape['model']} blocks of "
         f"{tuple(pb.shape)} rows against stack blocks of "
         f"{tuple(st.shape)} (of sum|phi theta| per row)", worst6,
         ROWDOT_RTOL, cells * calls)

    # one request alone, and inside a full 1024-row bucket
    x1 = np.random.default_rng(3).uniform(size=(SERVE_BATCH, 5)).astype(
        np.float32)
    alone = server.predict(x1, res_ids[7])
    server.stop()
    full = KernelServer(model=base, store=store, config=scfg, mesh=mesh,
                        device=dev, autostart=False)
    rng = np.random.default_rng(4)
    fill = [full.submit(rng.uniform(size=(SERVE_BATCH, 5)).astype(
        np.float32), res_ids[int(rng.integers(0, SERVE_RESIDENT))])
        for _ in range(1024 // SERVE_BATCH - 1)]
    probe = full.submit(x1, res_ids[7])
    full.start()
    for f in fill:
        f.result(timeout=120)
    cobatched = probe.result(timeout=120)
    full.stop()
    fs = full.stats()
    if (fs["batches"], fs["rows"], fs["padded_rows"]) != (1, 1024, 0):
        raise AssertionError(f"the full sharded bucket ran as {fs}")
    if not np.array_equal(alone, cobatched):
        raise AssertionError("a request alone and inside a full sharded "
                             "bucket differs")
    log(19, "one request alone and inside a full 1024-row bucket on the "
            "mesh: bitwise equal")

    # one put: a copy on write of every block
    theta_put = res_thetas[7].clone()
    put_ms = time_ms(lambda: store.put(res_ids[7], theta_put), reps=5,
                     runs=5, warmup=2)
    log(19, f"[{card}] one ThetaStore.put on the mesh "
            f"({len(store.stack.blocks)} blocks, {store.capacity} x {D}): "
            f"{put_ms:.4f} ms on the "
            "device (each block copied, then written)")
    del server, full, store, res_thetas, sm
    torch.cuda.empty_cache()
    log(19, f"[{card}] launches over phase 19: "
            f"{ {k: v for k, v in seen.items() if v} }; phase 19 took "
            f"{time.perf_counter() - t_phase:.1f} s")
    return seen, errs


def mesh_gossip_phase(dev, card, reset_counts, counts, *, problem, cfg):
    """Phase 21: a mesh under gossip and under personalization, on
    SHARD_MESH of the one card. (a) phase 4's problem blocked once: gossip
    at participation GOSSIP_P and at gossip_size GOSSIP_SIZE, COKE and
    DKLA, on the simulator (CG), spmd (CG) and the fused backend (the K3
    fallback, once per block of the carry), and phase 16's churn on spmd,
    each against its unsharded run (comms and bits equal until the runs
    part, theta within MESH_THETA_TOL); (b) phase 17's personalized cell
    (cut to MESH_PZ_ITERS iterations, three refreshes), sync and gossip on
    the simulator and spmd: the learned graph's support at every refresh
    against the unsharded run's (a refresh that parts is reported with its
    float64 margin, which must lie within the fp32 rounding of the
    reference's d2 formula), comms and bits equal until then, the warmup
    prefix bitwise the sharded static run; then to_models() and each
    model's sharded fused evaluate (K1 once per feature block); (c) ms per
    iteration sharded beside unsharded, and peak memory; (d) K3, K5 and K1
    against their plain versions at the phase's block shapes. Every fit
    loop runs under set_sync_debug_mode("error"). Returns the phase's
    launch counts and errors by kernel."""
    from repro_torch.api import (ChurnSchedule, FitConfig, KRRConfig,
                                 Personalization, build_problem, fit,
                                 get_solver)
    from repro_torch.api.backends import consensus_runner
    from repro_torch.core import personalize as P
    from repro_torch.core import prng
    from repro_torch.distributed import sharding
    from repro_torch.kernels.threefry import threefry as k5
    from repro_torch.kernels.threefry.ref import uniform_ref
    from repro_torch.launch.mesh import make_host_mesh
    fit_module = importlib.import_module("repro_torch.api.fit")

    t_phase = time.perf_counter()
    mesh = make_host_mesh(*SHARD_MESH, device=dev)
    M = mesh.shape["model"]
    blocks = mesh.size
    seen = {k: 0 for k in LAUNCH_COUNTERS}
    errs = {}

    def only(tag, want):
        """The part's launch counts, added to the phase's: exactly
        `want`, 0 elsewhere."""
        torch.cuda.synchronize()
        got = {k: v for k, v in counts().items() if v}
        for k, v in got.items():
            seen[k] += v
        if got != {k: v for k, v in want.items() if v}:
            raise AssertionError(f"{tag}: launches {got}, expected {want}")
        return got

    def hold(name, tag, e, tol, launches):
        log(21, f"[{card}] {name} at {tag}: max|err| {e:.3e} (tol "
                f"{tol:.3e}) against its plain version; {launches} "
                "launches in the phase")
        if not e <= tol:
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"at {tag}: {e} > {tol}")
        errs[name] = max(errs.get(name, 0.0), e)

    def err(a, b):
        return float((a.double().cpu() - b.double().cpu()).abs().max())

    def runner_of(c, prob, m):
        ctx = fit_module._solve_context(c, dev, torch.float32,
                                        prob.num_agents)
        solver = get_solver(c.algorithm)
        if c.backend == "simulator":
            return fit_module._simulator_runner(solver, prob, ctx, None,
                                                mesh=m)
        return consensus_runner(c, solver, prob, ctx, None, mesh=m)

    def figures(what, c, pairs, steps, runs):
        """ms per iteration of `c` on each (label, problem, mesh)."""
        out = {}
        for label, prob, m in pairs:
            out[label] = per_iteration(
                card, 21, f"{what} {label}",
                loop_of(runner_of(c, prob, m), steps=steps), steps=steps,
                runs=runs)
        return out

    # ---- (a) gossip on phase 4's problem, blocked once --------------------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    N, T, D = problem.feats.shape
    sp = sharding.shard_problem(problem, mesh)
    execs = {"p": dict(participation=GOSSIP_P),
             "size": dict(gossip_size=GOSSIP_SIZE)}
    cells = [(alg, backend, tag, kn) for alg in ("coke", "dkla")
             for backend in ("simulator", "spmd", "fused")
             for tag, kn in execs.items()]
    cells += [(alg, "spmd", "churn", dict(
        participation=GOSSIP_P, churn=ChurnSchedule(**GOSSIP_CHURN)))
        for alg in ("coke", "dkla")]
    fused_theta = None
    for alg, backend, ex, kn in cells:
        if backend == "fused":      # phase 4's cell: the gradient primal
            c = cfg.replace(algorithm=alg, exec="gossip", **kn)
        else:
            c = cfg.replace(algorithm=alg, backend=backend, primal="cg",
                            num_iters=MESH_GOSSIP_ITERS, exec="gossip", **kn)
        iters = c.resolved_iters
        tag = f"gossip {ex} {alg} {backend}"
        with CensorRecord() as cu:
            plain = fit(c, problem=problem, device=dev)
        reset_counts()
        with StrictFits(), CensorRecord() as cs:
            t0 = time.perf_counter()
            sh = fit(c, problem=sp, device=dev, mesh=mesh)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        got = only(tag, {"threefry": iters,
                         "coke_fused_update": (blocks * iters
                                               if backend == "fused" else 0)})
        parted, note = hold_until_parted(tag, sh.history, plain.history, cs,
                                         cu)
        e = err(sh.theta, plain.theta)
        if parted:
            gap = parted_mse(tag, sh.history, plain.history)
            held = f"parted: final train MSE {gap:.2e} apart"
        else:
            held = f"theta max|err| {e:.3e} (tol {MESH_THETA_TOL:g})"
            if not e <= MESH_THETA_TOL:
                raise AssertionError(f"{tag}: theta differs")
        log(21, f"[{card}] {tag} on the mesh ({iters} iterations, "
                f"{wall:.2f} s wall): launches {got}; comms "
                f"{int(sh.history['comms'][-1])}/{N * iters}, {note}; "
                f"{held}")
        if backend == "fused" and alg == "coke" and ex == "p":
            fused_theta = sh.theta
    del plain, sh
    gc = cfg.replace(algorithm="coke", exec="gossip",
                     participation=GOSSIP_P)
    for backend in ("simulator", "spmd"):
        c = gc.replace(backend=backend, primal="cg")
        figures(f"gossip COKE {backend} CG p={GOSSIP_P}", c,
                (("sharded", sp, mesh), ("unsharded", problem, None)),
                steps=1, runs=SHARD_RUNS)
    figures(f"gossip COKE fused p={GOSSIP_P}", gc,
            (("sharded (K3 per block)", sp, mesh),
             ("unsharded (K2)", problem, None)), steps=5, runs=7)
    log(21, f"[{card}] (a) peak memory "
            f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB (phase 4's "
            f"Phi {problem.feats.numel() * 4 / 1e9:.3f} GB and its blocked "
            "copy, plus the fits' state)")
    worst_g, tol_g, worst_xi, shape = k3_block_errors(mesh, fused_theta,
                                                      problem.rho, 21)
    hold("coke_fused_update", f"the carry's {blocks} blocks of {shape} "
         "(g_aug)", worst_g, tol_g, seen["coke_fused_update"])
    if not worst_xi <= K3_XI_RTOL:
        raise AssertionError("K3's xi^2 on blocks disagrees with its plain "
                             "version")
    key = prng.fold_in(prng.PRNGKey(21), 3)
    same = torch.equal(
        k5.threefry_draw(key, (N,), dev, uniform=True).view(torch.int32),
        uniform_ref(key, (N,), dev).view(torch.int32))
    hold("threefry", f"the participation draw's shape ({N},), bitwise",
         0.0 if same else math.inf, 0.0, seen["threefry"])
    del sp, fused_theta
    torch.cuda.empty_cache()

    # ---- (b) personalization: phase 17's cell, cut in depth ---------------
    torch.cuda.reset_peak_memory_stats()
    krr = KRRConfig(dataset="heterogeneous", num_agents=N_AGENTS,
                    samples_per_agent=SAMPLES, num_tasks=PZ_TASKS,
                    num_features=FEATURES, lam=1e-3, rho=0.01,
                    censor_v=0.0, censor_mu=0.97, seed=0)
    pz = Personalization(**PZ_FULL)
    W, K = pz.warmup, pz.k
    refreshes = [k for k in range(1, MESH_PZ_ITERS + 1)
                 if P.should_update(pz, k)]
    pcfg = FitConfig(krr=krr, graph="ring", num_iters=MESH_PZ_ITERS,
                     primal="cg", personalization=pz)
    hb = build_problem(pcfg, device=dev)
    hprob = hb.problem
    hsp = sharding.shard_problem(hprob, mesh)
    real_update = P.maybe_update

    def recorded(fn):
        """fn() with every refresh's (graph, thetas) recorded."""
        rec = {}

        def spy(pz_, thetas, k, adjacency):
            out = real_update(pz_, thetas, k, adjacency)
            if P.should_update(pz_, k):
                rec[k] = (out.clone(), thetas.clone())
            return out
        P.maybe_update = spy
        try:
            return fn(), rec
        finally:
            P.maybe_update = real_update

    def knife_edge(A_u, A_s, t_u, t_s):
        """(rows, margin, noise) of a refresh whose support parts: the
        float64 gap between the k-th and (k+1)-th nearest peers (exact
        differences of the unsharded run's thetas) of the agents whose
        neighbourhoods differ, against what moves d2 between the runs:
        the fp32 rounding of |t_i|^2 + |t_j|^2 - 2 t_i.t_j (16 ulps of
        its terms) and the runs' own theta difference."""
        t = sharding.unshard(t_u).double().cpu()
        dt = (sharding.unshard(t_s).double().cpu() - t).abs().amax(1)
        d2 = torch.sum((t[:, None] - t[None]) ** 2, dim=-1)
        d2.fill_diagonal_(math.inf)
        srt = torch.sort(d2, dim=1).values
        gap = srt[:, K] - srt[:, K - 1]
        sq = torch.sum(t * t, dim=-1)
        noise = (16 * 2.0**-23 * (sq + sq.max())
                 + 4 * float(sq.max().sqrt()) * (dt + dt.max()))
        rows = torch.nonzero(((A_u.cpu() > 0) != (A_s.cpu() > 0)).any(1))
        rows = rows.flatten()
        return rows.tolist(), float(gap[rows].min()), float(
            noise[rows].max())

    runs = {}
    for backend in ("simulator", "spmd"):
        for ex in ("sync", "gossip"):
            c = pcfg.replace(backend=backend)
            if ex == "gossip":
                c = c.replace(exec="gossip", participation=PZ_GOSSIP_P)
            tag = f"personalized {ex} {backend}"
            plain, rec_u = recorded(lambda: fit(c, problem=hprob,
                                                device=dev))
            with StrictFits():
                static = fit(c.replace(personalization=None, num_iters=W),
                             problem=hsp, device=dev, mesh=mesh)
            reset_counts()
            with StrictFits():
                t0 = time.perf_counter()
                sh, rec_s = recorded(lambda: fit(c, problem=hsp, device=dev,
                                                 mesh=mesh))
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            got = only(tag, {"threefry": MESH_PZ_ITERS if ex == "gossip"
                             else 0})
            if sorted(rec_s) != refreshes or sorted(rec_u) != refreshes:
                raise AssertionError(f"{tag}: refreshes at {sorted(rec_s)}")
            for k, v in static.history.items():
                if not torch.equal(sh.history[k][:W].cpu(), v.cpu()):
                    raise AssertionError(f"{tag}: iterations 1-{W} of {k} "
                                         "are not bitwise the sharded static "
                                         "run")
            check_graph(tag, sh.learned_adjacency, K)
            parted = next((k for k in refreshes if not torch.equal(
                rec_u[k][0] > 0, rec_s[k][0] > 0)), None)
            end = None if parted is None else parted - 1
            for key in ("comms", "bits"):
                if not torch.equal(sh.history[key][:end].cpu(),
                                   plain.history[key][:end].cpu()):
                    raise AssertionError(f"{tag}: {key} differ before the "
                                         "graphs part")
            if parted is None:
                note = (f"the support equal at every refresh {refreshes}; "
                        "comms and bits equal throughout")
            else:
                rows, margin, noise = knife_edge(
                    rec_u[parted][0], rec_s[parted][0], rec_u[parted][1],
                    rec_s[parted][1])
                note = (f"the support equal through refresh "
                        f"{[k for k in refreshes if k < parted]}, parts at "
                        f"refresh {parted} in rows {rows}: float64 gap "
                        f"between their {K}th and {K + 1}th nearest peers "
                        f"{margin:.3e}, within the fp32 rounding "
                        f"{noise:.3e} of the reference's d2 formula; comms "
                        f"and bits equal through iteration {end}")
                if not margin <= noise:
                    raise AssertionError(f"{tag}: the graphs part at refresh "
                                         f"{parted} by {margin:.3e}, more "
                                         f"than fp32 rounding ({noise:.3e})")
            runs[(backend, ex)] = sh
            log(21, f"[{card}] {tag} on the mesh ({PZ_FULL}, CG, "
                    f"{MESH_PZ_ITERS} iterations, {wall:.2f} s wall): "
                    f"launches {got}; iterations 1-{W} bitwise the sharded "
                    f"static run; {note}; theta "
                    f"{err(sh.theta, plain.theta):.3e} from the unsharded "
                    f"run's (max|theta| {float(plain.theta.abs().max()):.3f})")

    # to_models: each per-agent model's sharded fused evaluate
    models = runs[("simulator", "sync")].to_models(hb.rff_params)
    want = [m.evaluate(hb.x_test[i], hb.y_test[i], backend="fused")
            for i, m in enumerate(models)]
    bounds = []
    for i, m in enumerate(models):       # the MSE's reach from the predict
        phi = m.featurize(hb.x_test[i].reshape(-1, 5), "fused")
        dev_p = SHARD_PREDICT_RTOL * (phi.abs() @ m.theta.abs())
        resid = (hb.y_test[i].reshape(-1) - phi @ m.theta).abs()
        bounds.append(float(torch.mean(2 * resid * dev_p + dev_p ** 2)))
    sharded = [m.shard(mesh) for m in models]
    reset_counts()
    got_ev = [m.evaluate(hb.x_test[i], hb.y_test[i], backend="fused")
              for i, m in enumerate(sharded)]
    only("the per-agent sharded evaluates", {"rff_cos_bias": N * M})
    worst = max(abs(g["test_mse"] - w["test_mse"]) / b
                for g, w, b in zip(got_ev, want, bounds))
    log(21, f"[{card}] to_models of the sharded simulator fit: {N} models, "
            f"each sharded and evaluated on its {hb.x_test.shape[1]} test "
            f"rows with backend='fused': K1 {N} x {M} (once per feature "
            f"block); test MSE within {worst:.3f} of its bound from the "
            f"unsharded evaluate's (SHARD_PREDICT_RTOL of sum|phi theta| per "
            "prediction)")
    if not worst <= 1.0:
        raise AssertionError("a per-agent sharded evaluate is off the "
                             "unsharded MSE")
    e1, t1, shape = k1_block_errors(mesh, hb.x_test[0], sharded[0].omega,
                                    sharded[0].bias, D)
    hold("rff_cos_bias", f"a per-agent evaluate, x {tuple(hb.x_test[0].shape)}"
         f" on {M} feature blocks of {shape}", e1, t1, N * M)

    # live personalized iterations (warmup 0: one refresh in five)
    live = pcfg.replace(personalization=Personalization(
        **dict(PZ_FULL, warmup=0)), exec="gossip", participation=PZ_GOSSIP_P)
    for backend in ("simulator", "spmd"):
        figures(f"personalized gossip {backend} (a refresh in "
                f"{PZ_FULL['every']})", live.replace(backend=backend),
                (("sharded", hsp, mesh), ("unsharded", hprob, None)),
                steps=PZ_FULL["every"], runs=SHARD_RUNS)
    log(21, f"[{card}] (b) peak memory "
            f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    del hb, hprob, hsp, runs, models, sharded
    torch.cuda.empty_cache()
    log(21, f"[{card}] launches over phase 21: "
            f"{ {k: v for k, v in seen.items() if v} }; phase 21 took "
            f"{time.perf_counter() - t_phase:.1f} s")
    return seen, errs


def _censor_calls(rec):
    """A CensorRecord's calls as plain host tensors (the norms of a
    blocked run gathered whole: one collective per call, in the same order
    on every rank)."""
    from repro_torch.distributed import sharding
    return [(sharding.unshard(n).cpu(), h.cpu() if torch.is_tensor(h)
             else h) for n, h in rec.calls]


def rank_cells(dev, mesh, reset_counts, counts, *, big_d,
               cg_backends=("simulator", "spmd")):
    """Phase 28's cells on `mesh` (the one-process mesh of the card, or a
    rank's share of it): phase 19(a)'s COKE fits at full width (CG on
    each of `cg_backends`, the fused fallback through K3 once per block,
    the logistic cell, the Censor + Drop chain through K5), with `big_d`
    phase 19(b)'s D = 65536 point on the same mesh, and the sharded COKE
    model's predict through K1 once per feature block. Each
    problem is built whole on the card from its seed, placed (each rank
    keeps a copy of its own blocks) and dropped. Per cell: the history
    and theta gathered whole on the host, the censor record, the launch
    counts (every counter set to 0 just before, read just after), the
    wall seconds beside the device's ms between events recorded on
    either side of the cell (as `paired_ms`: where the two are close the
    device waits on the host; no profiler, whose start-up costs each
    rank ~13 s on an H100 host), the collectives' calls
    and bytes and the peak memory. Also the K3 and K1 holds on this
    process's blocks, the placement's memory figures, and K5 against its
    plain version."""
    from repro_torch.api import (Censor, Chain, Drop, FitConfig, KRRConfig,
                                 build_problem, fit, make_problem)
    from repro_torch.core import prng
    from repro_torch.core.graph import ring
    from repro_torch.distributed import sharding
    from repro_torch.kernels.threefry import threefry as k5
    from repro_torch.kernels.threefry.ref import uniform_ref

    out = {"cells": {}, "holds": {}, "memory": {}}

    def cell(name, fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        traffic = dict(sharding.TRAFFIC)
        reset_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        with CensorRecord() as rec:
            res = fn()
        end.record()
        end.synchronize()
        wall = time.perf_counter() - t0
        out["cells"][name] = {
            "history": {k: v.cpu() for k, v in res.history.items()},
            "theta": res.theta.cpu(), "censor": _censor_calls(rec),
            "launches": counts(), "wall": wall,
            "device_ms": start.elapsed_time(end),
            "gathers": sharding.TRAFFIC["calls"] - traffic["calls"],
            "bytes": sharding.TRAFFIC["bytes"] - traffic["bytes"],
            "peak": torch.cuda.max_memory_allocated()}
        return res

    def placed(prob):
        """prob's blocks on this mesh, the whole problem dropped; the
        bytes of Phi this process keeps."""
        sp = sharding.shard_problem(prob, mesh)
        return sp, sp.feats.data.nbytes

    cfg = full_width_config()
    built = build_problem(cfg, device=dev)
    problem = built.problem
    labels = torch.where(problem.labels > problem.labels.median(), 1.0, -1.0)
    log_labels = labels.clone()
    whole_phi = problem.feats.nbytes
    torch.cuda.synchronize()
    held_whole = torch.cuda.memory_allocated()
    sp, own = placed(problem)
    del problem, labels
    built = dataclasses.replace(built, problem=None, feats_test=None)
    torch.cuda.synchronize()
    out["memory"]["phi"] = (whole_phi, own, held_whole,
                            torch.cuda.memory_allocated())
    cg_cfg = cfg.replace(algorithm="coke", primal="cg",
                         num_iters=SHARD_CG_ITERS)
    for backend in cg_backends:
        c = cg_cfg.replace(backend=backend)
        cell(f"COKE {backend} CG",
             lambda: fit(c, problem=sp, device=dev, mesh=mesh))
    fc = cfg.replace(algorithm="coke")
    fused = cell("fused COKE (K3)",
                 lambda: fit(fc, problem=sp, device=dev, mesh=mesh))
    _, lspec, _ = sharding.problem_specs(sp, mesh)
    slp = dataclasses.replace(sp, labels=sharding.shard(log_labels, mesh,
                                                        lspec),
                              loss="logistic")
    lc = FitConfig(krr=cfg.krr, backend="fused", graph="ring",
                   num_iters=ITERS, algorithm="coke")
    cell("logistic COKE (K3)",
         lambda: fit(lc, problem=slp, device=dev, mesh=mesh))
    v, mu = cfg.resolved_censor
    cc = fc.replace(comm=Chain([Censor(v, mu), Drop(CHAIN_DROP)]),
                    censor_v=None, censor_mu=None)
    cell("chain COKE (K3, K5)",
         lambda: fit(cc, problem=sp, device=dev, mesh=mesh))
    del slp

    # the kernels on this process's blocks against their plain versions
    # (after the counts were read: not counted)
    worst_g, tol_g, _, shape = k3_block_errors(mesh, fused.theta,
                                               sp.rho, 28)
    out["holds"]["coke_fused_update"] = (worst_g, tol_g, shape)
    key = prng.fold_in(prng.PRNGKey(28), 7)
    N = fused.theta.shape[0]
    same = all(torch.equal(
        k5.threefry_draw(key, shape, dev, uniform=True).view(torch.int32),
        uniform_ref(key, shape, dev).view(torch.int32))
        for shape in ((N,), (N, FEATURES)))
    out["holds"]["threefry"] = (0.0 if same else math.inf, 0.0, (N,))
    del sp

    # the sharded COKE model's predict: K1 once per feature block held
    model = fused.to_model(built.rff_params)
    sm = model.shard(mesh)
    x = built.x_test
    flat = x.reshape(-1, x.shape[-1])
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    got = sm.predict(x, backend="fused")
    torch.cuda.synchronize()
    out["predict"] = {"preds": got.cpu(), "launches": counts(),
                      "wall": time.perf_counter() - t0,
                      "want": model.predict(x, backend="fused").cpu(),
                      "scale": (model.featurize(flat, "fused").abs()
                                @ model.theta.abs()).reshape(
                                    got.shape).cpu()}
    e1, t1, shape = k1_block_errors(mesh, flat, sm.omega, sm.bias, FEATURES)
    out["holds"]["rff_cos_bias"] = (e1, t1, shape)
    # the serving cells' template and the per-agent thetas
    out["template"] = (fused.to_model(built.rff_params,
                                      include_per_agent=False), fused.theta)
    del model, sm, built, fused

    if big_d:
        bcfg = FitConfig(krr=KRRConfig(lam=1e-3, rho=1e-2, seed=0,
                                       **SHARD_BIG_D),
                         graph="ring", algorithm="coke", censor_v=0.5,
                         censor_mu=0.97, primal="cg",
                         num_iters=SHARD_BIG_D_ITERS)
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        bprob = build_problem(bcfg, device=dev).problem
        whole = bprob.feats.nbytes
        bsp, own = placed(bprob)
        del bprob
        torch.cuda.synchronize()
        out["memory"]["big_d"] = (whole, own,
                                  torch.cuda.max_memory_allocated() - before,
                                  torch.cuda.memory_allocated() - before)
        for backend in ("simulator", "spmd"):
            c = bcfg.replace(backend=backend)
            cell(f"big-D {backend} CG",
                 lambda: fit(c, problem=bsp, device=dev, mesh=mesh))
        del bsp
    torch.cuda.empty_cache()
    return out


def registry_ids(n_agents):
    """Phase 28(b)'s registry ids: phase 18's per-agent models and
    SERVE_REGISTRY - n_agents variants."""
    return [f"agent-{i:02d}" for i in range(n_agents)] + [
        f"v-{i:04d}" for i in range(SERVE_REGISTRY - n_agents)]


def write_registry(root, template, agents):
    """Phase 28(b)'s registry at `root`: the per-agent thetas and
    variants of the template's theta (0.1 N(0, 1) from seed 42), each one
    published model; returns {id: theta} on the template's device."""
    from repro_torch.serve import ModelRegistry

    n = agents.shape[0]
    variants = (template.theta.cpu().numpy()[None, :]
                + np.random.default_rng(42).normal(
                    scale=0.1, size=(SERVE_REGISTRY - n,
                                     template.num_features))
                ).astype(np.float32)
    thetas = torch.cat([agents, torch.from_numpy(variants).to(
        agents.device)])
    reg = ModelRegistry(str(root), device=agents.device)
    ids = registry_ids(n)
    for mid, th in zip(ids, thetas):
        reg.publish(mid, template.replace(theta=th))
    return dict(zip(ids, thetas))


def resident_thetas(template, agents):
    """Phase 28(a)'s SERVE_RESIDENT thetas on the card: the per-agent
    thetas, then the template's theta plus 0.1 N(0, 1) from seed 28 (the
    same bits in every process on the card)."""
    gen = torch.Generator(device=agents.device).manual_seed(28)
    n = SERVE_RESIDENT - agents.shape[0]
    return torch.cat([agents, template.theta + 0.1 * torch.randn(
        (n, template.num_features), generator=gen, device=agents.device)])


def rank_serve(dev, mesh, cells, reg_root, template, agents, reset_counts,
               counts):
    """Phase 28's serving cells on a rank's share of the SHARD_MESH mesh,
    SPMD: every rank builds the same stores and servers (the COKE model
    of `rank_cells` as the template, whole), and rank 0, the front, alone
    runs the clients; the other ranks follow its commands in `stop()`.
    (a) 65 536 ids `put_many` into a store of 65 537 slots, phase 18's
    load (SERVE_CLIENTS closed-loop clients x RANK_SERVE_REQUESTS
    requests of 4 rows at uniform ids, max_delay_ms=1), then one request
    alone and inside a full 1024-row bucket; with "swap" in `cells` (c)
    phase 18's hot swap under fire on that store, and with "paged" (b)
    the registry at `reg_root` through SERVE_REGISTRY // 4 slots. Per
    cell and rank: the answers (front), the launch counts (every counter
    set to 0 just before the first command, read after the stop), the
    server's and the store's stats and resident ids, the broadcasts and
    gathers and their bytes, wall seconds beside the device's ms between
    events on either side, peak memory. Then K1 and K6 on this rank's
    blocks of a bucket's row block against their plain versions (not
    counted)."""
    from repro_torch.distributed import sharding
    from repro_torch.kernels.rff import rff as k1
    from repro_torch.kernels.rowdot import rowdot as k6
    from repro_torch.kernels.rowdot.ref import gather_rowdot_ref
    from repro_torch.launch.mesh import num_agents
    from repro_torch.serve import (KernelServeConfig, KernelServer,
                                   ModelRegistry, ThetaStore)

    front = mesh.rank == 0
    D = template.num_features
    kw = dict(config=KernelServeConfig(backend="fused",
                                       max_delay_ms=SERVE_DELAY_MS),
              mesh=mesh, device=dev, autostart=False)
    load = dict(clients=SERVE_CLIENTS, requests=RANK_SERVE_REQUESTS,
                batch=SERVE_BATCH)
    out = {"cells": {}, "holds": {},
           "template": {k: v.cpu() for k, v in template._array_tree()
                        .items()}, "agents": agents.cpu()}

    def cell(name, server, store, fn):
        """fn(server) on the front (which starts the server) between the
        counters' reset and the server's stop on every rank."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        traffic = dict(sharding.TRAFFIC)
        reset_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        got = fn(server) if front else None      # fn starts the front
        server.stop()
        end.record()
        end.synchronize()
        s = server.stats()
        out["cells"][name] = {
            "got": got, "launches": counts(),
            "wall": time.perf_counter() - t0,
            "device_ms": start.elapsed_time(end),
            "server": {k: s[k] for k in ("batches", "rows", "padded_rows")},
            "store": store.stats(), "resident": hashlib.sha256(
                "\n".join(store.resident()).encode()).hexdigest(),
            "traffic": {k: sharding.TRAFFIC[k] - traffic[k]
                        for k in traffic},
            "peak": torch.cuda.max_memory_allocated()}

    # ---- (a) the resident cell, then a full bucket ------------------------
    res_ids = [f"r-{i:05d}" for i in range(SERVE_RESIDENT)]
    thetas = resident_thetas(template, agents)
    store = ThetaStore(SERVE_RESIDENT + 1, D, device=dev, mesh=mesh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    store.put_many(res_ids, thetas)
    torch.cuda.synchronize()
    out["put_many_ms"] = (time.perf_counter() - t0) * 1e3
    out["stack_bytes"] = sum(t.nbytes for t in store.stack.blocks.values())
    del thetas
    x1 = np.random.default_rng(3).uniform(size=(SERVE_BATCH, 5)).astype(
        np.float32)

    def resident(server):
        server.start()
        server.predict(np.zeros((SERVE_BATCH, 5), np.float32), res_ids[0])
        wall, lat, answers = drive(server, res_ids, seed=0, **load)
        alone = server.predict(x1, res_ids[7])
        return {"wall": wall, "lat": lat, "answers": answers,
                "alone": alone}

    cell("resident", KernelServer(template, store=store, **kw), store,
         resident)

    def full_bucket(server):
        rng = np.random.default_rng(4)
        fill = []
        for _ in range(1024 // SERVE_BATCH - 1):
            mid = res_ids[int(rng.integers(0, SERVE_RESIDENT))]
            x = rng.uniform(size=(SERVE_BATCH, 5)).astype(np.float32)
            fill.append((mid, x, server.submit(x, mid)))
        probe = server.submit(x1, res_ids[7])
        server.start()          # every request queued first: one bucket
        return {"answers": [(m, x, f.result(timeout=120))
                            for m, x, f in fill]
                + [(res_ids[7], x1, probe.result(timeout=120))]}

    cell("full bucket", KernelServer(template, store=store, **kw), store,
         full_bucket)

    # ---- (c) hot swap under fire ------------------------------------------
    if "swap" in cells:
        hot = res_ids[7]
        versions = [agents[7] + 0.5 * (k + 1)
                    for k in range(SERVE_SWAP_PUBLISHES)]

        def swap(server):
            import threading
            server.start()
            stop_fire = threading.Event()
            fired, failures = [], []

            def fire():
                try:
                    while not stop_fire.is_set():
                        fired.append(server.submit(x1, hot).result(
                            timeout=120))
                except Exception as e:  # noqa: BLE001 - raised below
                    failures.append(e)

            threads = [threading.Thread(target=fire)
                       for _ in range(SERVE_SWAP_CLIENTS)]
            for t in threads:
                t.start()
            for v in versions:
                time.sleep(0.02)
                server.publish(hot, v)
            time.sleep(0.02)
            stop_fire.set()
            for t in threads:
                t.join(timeout=120)
            if failures or any(t.is_alive() for t in threads):
                raise AssertionError(f"hot swap: a client failed "
                                     f"{failures[:1]}")
            return {"fired": fired, "last": server.predict(x1, hot)}

        cell("hot swap", KernelServer(template, store=store, **kw), store,
             swap)

    # the kernels on this rank's blocks of a bucket's row block (1024 rows
    # over the batch axes) against their plain versions, not counted
    sm = template.shard(mesh)
    gen = torch.Generator(device=dev).manual_seed(280)
    xb = torch.rand((1024 // num_agents(mesh), 5), generator=gen,
                    device=dev)
    out["holds"]["rff_cos_bias"] = k1_block_errors(mesh, xb, sm.omega,
                                                   sm.bias, D)
    slots = np.random.default_rng(5).integers(
        0, SERVE_RESIDENT, xb.shape[0]).astype(np.int32)
    sl = torch.from_numpy(slots).to(dev)
    worst = tol = 0.0
    for m in sorted({m for _, m in mesh.local_cells()}):
        pb = k1.rff_cos_bias(xb, sharding.local_block(sm.omega, 0, m),
                             sharding.local_block(sm.bias, 0, m),
                             num_features=D)
        st = sharding.local_block(store.stack, 0, m)
        got6 = k6.gather_rowdot(pb, st, slots)
        want6 = gather_rowdot_ref(pb, st, sl)
        scale = (pb * st[sl.long()]).abs().sum(-1)
        if not bool(((got6 - want6).abs() <= ROWDOT_RTOL * scale).all()):
            raise AssertionError(f"rank {mesh.rank}: K6 on block {m} "
                                 "disagrees with its plain version")
        worst = max(worst, float((got6 - want6).abs().max()))
        tol = max(tol, ROWDOT_RTOL * float(scale.max()))
    torch.cuda.synchronize()
    out["holds"]["gather_rowdot"] = (worst, tol, tuple(st.shape))
    del sm, store
    torch.cuda.empty_cache()

    # ---- (b) the paged cell -----------------------------------------------
    if "paged" in cells:
        reg_ids = registry_ids(agents.shape[0])
        reg = ModelRegistry(str(reg_root), device=dev)
        paged = KernelServer(template, registry=reg,
                             store_capacity=SERVE_REGISTRY // 4, **kw)

        def paged_run(server):
            server.start()
            server.predict(np.zeros((SERVE_BATCH, 5), np.float32),
                           reg_ids[1])
            wall, lat, answers = drive(server, reg_ids, seed=100, **load)
            return {"wall": wall, "lat": lat, "answers": answers}

        cell("paged", paged, paged.store, paged_run)
        del paged
    torch.cuda.empty_cache()
    return out


def rank_main(rank, world, split, tmp, device="cuda:0", registry=None):
    """A rank of phase 28 (started by `torch.multiprocessing` with the
    spawn method; the parent built the kernels, so this only loads them):
    join the gloo group of `world` ranks on the card over a FileStore in
    `tmp` (RANK_TIMEOUT_S to every collective), run `rank_cells` and then
    `rank_serve` on its share of the SHARD_MESH mesh (the paged cell's
    registry at `registry`) and save what it got there."""
    import datetime

    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import make_host_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(Path(tmp) / "store"), world),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
    try:
        t0 = time.perf_counter()
        mesh = make_host_mesh(*SHARD_MESH, device=dev,
                              group=dist.group.WORLD, split=split)
        res = rank_cells(dev, mesh, reset_counts, counts,
                         big_d=world == RANK_BIG_D_WORLD,
                         cg_backends=RANK_CG_BACKENDS[world])
        res.update(cells_held=mesh.local_cells(), wall=time.perf_counter()
                   - t0, traffic=dict(sharding.TRAFFIC))
        template, agents = res.pop("template")
        res["serve"] = rank_serve(dev, mesh, RANK_SERVE_CELLS[world],
                                  registry, template, agents, reset_counts,
                                  counts)
        torch.save(res, Path(tmp) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def serve_ranks_check(card, dev, world, split, ranks, reg_thetas):
    """Phase 28's serving cells of one spawn, held in the parent: every
    answer bitwise the one-process SHARD_MESH mesh's `score_rows` at the
    request's own row count (the template, thetas and registry rebuilt
    from what rank 0 sent and from the seeds); the probe alone bitwise
    itself inside the full 1024-row bucket; every follower's store (stats
    and resident ids) and bucket calls the front's; K1 and K6 summed over
    the ranks 8 a bucket call (each (row, feature) block once, as on one
    process), no other kernel. Prints per cell QPS and p50 / p99 beside
    phases 18(a) and 19(c) of this run, the broadcasts and gathers per
    bucket call and their bytes, and per rank the wall and device time
    and peak memory. Returns the launches over the ranks by kernel."""
    from repro_torch.api.model import KernelModel
    from repro_torch.core.rff import RFFParams
    from repro_torch.launch.mesh import make_host_mesh

    sv = [r["serve"] for r in ranks]
    arr = sv[0]["template"]
    template = KernelModel(RFFParams(omega=arr["omega"].to(dev),
                                     bias=arr["bias"].to(dev),
                                     mapping="cos_bias"),
                           arr["theta"].to(dev))
    agents = sv[0]["agents"].to(dev)
    D = template.num_features
    sm = template.shard(make_host_mesh(*SHARD_MESH, device=dev))
    res_thetas = resident_thetas(template, agents)
    hot = agents[7]
    versions = [hot] + [hot + 0.5 * (k + 1)
                        for k in range(SERVE_SWAP_PUBLISHES)]
    x1 = np.random.default_rng(3).uniform(size=(SERVE_BATCH, 5)).astype(
        np.float32)

    def theta_of(mid):
        if reg_thetas is not None and mid in reg_thetas:
            return reg_thetas[mid]
        return res_thetas[int(mid[2:])]

    def own(x, theta):
        xt = torch.from_numpy(x).to(dev)
        return sm.score_rows(xt, theta.expand(x.shape[0], D),
                             backend="fused").cpu().numpy()

    seen = {k: 0 for k in LAUNCH_COUNTERS}
    for name in sv[0]["cells"]:
        cells = [s["cells"][name] for s in sv]
        c0 = cells[0]
        t_hold = time.perf_counter()
        got = c0["got"]
        answers = list(got.get("answers", []))
        for mid, x, out in answers:
            if not np.array_equal(out, own(x, theta_of(mid))):
                raise AssertionError(f"W={world} {name}: the answer for "
                                     f"{mid} is not bitwise the one-process "
                                     "mesh's score_rows")
        n_held = len(answers)
        if name == "hot swap":
            refs = [own(x1, v) for v in versions]
            seen_v = [sum(np.array_equal(o, r) for r in refs)
                      for o in got["fired"]]
            if any(k != 1 for k in seen_v) or not np.array_equal(
                    got["last"], refs[-1]):
                raise AssertionError(f"W={world} hot swap: an answer "
                                     "matched no version, or more than one")
            n_held += len(got["fired"]) + 1
        if name == "resident":
            if not np.array_equal(got["alone"], own(x1, res_thetas[7])):
                raise AssertionError(f"W={world}: the request alone is not "
                                     "bitwise the one-process mesh's")
            n_held += 1
        if name == "full bucket":
            probe = answers[-1][2]
            if not np.array_equal(probe, sv[0]["cells"]["resident"]["got"]
                                  ["alone"]):
                raise AssertionError(f"W={world}: a request alone and "
                                     "inside a full 1024-row bucket differ")
            if any(tuple(c["server"].values()) != (1, 1024, 0)
                   for c in cells):
                raise AssertionError(f"W={world}: the full bucket ran as "
                                     f"{[c['server'] for c in cells]}")
        calls = c0["server"]["batches"]
        for r, c in enumerate(cells[1:], 1):
            if c["server"] != c0["server"] or c["store"] != c0["store"] \
                    or c["resident"] != c0["resident"]:
                raise AssertionError(
                    f"W={world} {name}: rank {r} ended with store "
                    f"{c['store']} and bucket calls {c['server']}, the "
                    f"front {c0['store']} and {c0['server']}")
        total = {k: sum(c["launches"][k] for c in cells)
                 for k in LAUNCH_COUNTERS}
        blocks = SHARD_MESH[0] * SHARD_MESH[1]
        if total["rff_cos_bias"] != blocks * calls or \
                total["gather_rowdot"] != blocks * calls or any(
                    v for k, v in total.items()
                    if k not in ("rff_cos_bias", "gather_rowdot")):
            raise AssertionError(f"W={world} {name}: launches {total} over "
                                 f"the ranks for {calls} bucket calls")
        if name == "paged" and not (c0["store"]["faults"] > 0
                                    and c0["store"]["evictions"] > 0):
            raise AssertionError(f"W={world}: the paged cell did not page "
                                 f"({c0['store']})")
        for k, v in total.items():
            seen[k] += v
        tr = c0["traffic"]
        line = (f"[{card}] W={world} {name}: {calls} bucket calls; every "
                f"one of {n_held} answers bitwise the one-process mesh's "
                f"score_rows at its own row count (held in "
                f"{time.perf_counter() - t_hold:.1f} s); every follower's "
                f"store and bucket calls the front's ({c0['store']}); K1 = "
                f"K6 = {total['gather_rowdot']} over the ranks ({blocks} x "
                f"{calls}); per bucket call {tr['broadcasts'] / calls:.2f} "
                f"broadcasts ({tr['broadcast_bytes'] / calls / 1e3:.1f} kB) "
                f"and {tr['calls'] / calls:.2f} gathers "
                f"({tr['bytes'] / calls / 1e3:.2f} kB into the front)")
        if "lat" in got:
            qps, p50, p99 = latency_figures(got["wall"], got["lat"])
            line += (f"; {len(got['lat'])} requests of {SERVE_BATCH} rows "
                     f"from {SERVE_CLIENTS} clients: {qps:.1f} QPS, p50 "
                     f"{p50:.4f} ms, p99 {p99:.4f} ms (")
            line += "; ".join(
                f"{k} {q:.1f} QPS, p50 {a:.4f} ms, p99 {b:.4f} ms"
                for k, (q, a, b) in SERVE_FIGURES.items()) \
                if SERVE_FIGURES else "phases 18 and 19 not run in this call"
            line += ")"
        log(28, line)
        for r, c in enumerate(cells):
            log(28, f"[{card}]   rank {r}: {c['wall'] * 1e3:.1f} ms wall, "
                    f"{c['device_ms']:.1f} ms between the device's events; "
                    f"{c['traffic']['broadcasts']} broadcasts, "
                    f"{c['traffic']['calls']} gathers; peak "
                    f"{c['peak'] / 1e9:.3f} GB (its stack blocks "
                    f"{sv[r]['stack_bytes'] / 1e9:.3f} GB; put_many "
                    f"{sv[r]['put_many_ms']:.1f} ms)")
    return seen


def ranks_phase(dev, card, reset_counts, counts):
    """Phase 28: phase 19's (data=2, model=4) mesh across ranks of a gloo
    group, every rank on this one card (NCCL refuses two ranks on one
    card): the cells of `rank_cells` on the one-process mesh here, then
    in W = 2 ranks (split (2, 1): each rank one batch block, all four
    model blocks) and W = 4 ranks ((2, 2): a 1 x 2 rectangle each), each
    split one spawn of `rank_main`. Every rank must get every cell's
    history and theta bitwise its peers'; against the one-process run,
    comms and bits equal until the runs part (`hold_until_parted`: a
    rank's batched products may round otherwise on the card) and theta
    within phase 19's tolerance; the launches over the ranks: K3 summed
    equal to the one-process count (each block once), K5 on every rank
    the one-process count (every rank draws each unsharded draw and keeps
    its blocks), K1 summed w_b times the one-process count (predict's
    rows are not cut: each batch row of ranks featurizes them for its
    feature blocks). The gloo transfers sync the host, so the loops run
    without phase 19's set_sync_debug_mode("error"). Prints per rank and
    cell the host wall and the device time between events, the
    collectives' calls and bytes and the peak memory, and per rank the
    share of Phi it holds.
    Returns the ranks' launch counts (summed over both splits) and the
    largest errors of the kernels against their plain versions."""
    import threading

    import torch.multiprocessing as mp
    from repro_torch.launch.mesh import make_host_mesh

    t_phase = time.perf_counter()
    base = rank_cells(dev, make_host_mesh(*SHARD_MESH, device=dev),
                      reset_counts, counts, big_d=True)
    template, agents = base.pop("template")
    for name, c in base["cells"].items():
        log(28, f"[{card}] one process, {name}: {c['wall']:.2f} s wall, "
                f"comms {int(c['history']['comms'][-1])}, launches "
                f"{ {k: v for k, v in c['launches'].items() if v} }")
        if not c["history"]["comms"][-1] > 0:
            raise AssertionError(f"one process, {name}: no agent sent, so "
                                 "the comms hold below would be empty")
    seen = {k: 0 for k in LAUNCH_COUNTERS}
    errs: dict[str, float] = {}
    blocks = SHARD_MESH[0] * SHARD_MESH[1]
    (ROOT / "build").mkdir(exist_ok=True)
    # the paged cell's registry, written while the first spawn runs
    reg_dir = tempfile.mkdtemp(prefix="phase28-registry-", dir=ROOT / "build")
    written: dict = {}

    def write():
        t0 = time.perf_counter()
        try:
            written["thetas"] = write_registry(reg_dir, template, agents)
        except Exception as e:  # noqa: BLE001 - raised before its spawn
            written["error"] = e
        written["s"] = time.perf_counter() - t0

    writer = threading.Thread(target=write)
    writer.start()
    for world, split in RANK_WORLDS:
        tmp = tempfile.mkdtemp(prefix="phase28-", dir=ROOT / "build")
        try:
            reg_thetas = None
            if "paged" in RANK_SERVE_CELLS[world]:
                writer.join()
                if "error" in written:
                    raise written["error"]
                reg_thetas = written["thetas"]
                log(28, f"[{card}] wrote the paged cell's registry of "
                        f"{len(reg_thetas)} models in {written['s']:.2f} s "
                        f"(beside the spawns before W = {world})")
            t0 = time.perf_counter()
            mp.start_processes(rank_main, args=(world, split, tmp,
                                                str(dev), reg_dir),
                               nprocs=world, join=True,
                               start_method="spawn")
            spawn_s = time.perf_counter() - t0
            ranks = [torch.load(Path(tmp) / f"rank{r}.pt",
                                weights_only=False) for r in range(world)]
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        log(28, f"[{card}] W = {world} ranks on {dev} over gloo, split "
                f"{split} of the {SHARD_MESH} mesh: spawned, ran and "
                f"joined in {spawn_s:.1f} s")
        for name, want in base["cells"].items():
            if name not in ranks[0]["cells"]:
                continue
            got = [r["cells"][name] for r in ranks]
            for r, g in enumerate(got[1:], 1):
                for k, v in g["history"].items():
                    if not torch.equal(v, got[0]["history"][k]):
                        raise AssertionError(f"{name}: rank {r}'s {k} is "
                                             "not rank 0's")
                if not torch.equal(g["theta"], got[0]["theta"]):
                    raise AssertionError(f"{name}: rank {r}'s theta is not "
                                         "rank 0's")
            rec_a, rec_b = CensorRecord(), CensorRecord()
            rec_a.calls, rec_b.calls = got[0]["censor"], want["censor"]
            parted, note = hold_until_parted(
                f"W={world} {name}", got[0]["history"], want["history"],
                rec_a, rec_b)
            if not got[0]["history"]["comms"][-1] > 0:
                raise AssertionError(f"W={world} {name}: no agent sent")
            e = float((got[0]["theta"].double()
                       - want["theta"].double()).abs().max())
            cg = "CG" in name
            tol = SHARD_CG_TOL if cg else \
                SPMD_RTOL * float(want["theta"].abs().max())
            if parted:
                parted_mse(f"W={world} {name}", got[0]["history"],
                           want["history"])
            elif not e <= tol:
                raise AssertionError(f"W={world} {name}: theta {e} > {tol}")
            total = {k: sum(g["launches"][k] for g in got)
                     for k in LAUNCH_COUNTERS}
            one = want["launches"]
            if total["coke_fused_update"] != one["coke_fused_update"] or \
                    any(g["launches"]["threefry"] != one["threefry"]
                        for g in got) or {
                        k for k, v in total.items() if v} - {
                        "coke_fused_update", "threefry"}:
                raise AssertionError(f"W={world} {name}: launches {total} "
                                     f"over the ranks, one process {one}")
            for k, v in total.items():
                seen[k] += v
            log(28, f"[{card}] W={world} {name}: every rank's history and "
                    f"theta bitwise rank 0's; against one process {note}, "
                    f"theta max|err| {e:.3e} (tol {tol:.3e}); launches over "
                    f"the ranks { {k: v for k, v in total.items() if v} } "
                    f"(one process { {k: v for k, v in one.items() if v} })")
            for r, g in enumerate(got):
                iters = want["history"]["comms"].numel()
                log(28, f"[{card}]   rank {r}: {g['wall'] * 1e3:.1f} ms "
                        f"wall, {g['device_ms']:.1f} ms on the device "
                        f"({g['wall'] * 1e3 / iters:.2f} / "
                        f"{g['device_ms'] / iters:.2f} an iteration; one "
                        f"process {want['wall'] * 1e3 / iters:.2f} / "
                        f"{want['device_ms'] / iters:.2f}); {g['gathers']} "
                        f"gathers moving {g['bytes'] / 1e6:.3f} MB into the "
                        f"rank; peak {g['peak'] / 1e9:.3f} GB")
        # predict: every rank's bitwise the others', near the unsharded
        pg = [r["predict"] for r in ranks]
        if not all(torch.equal(p["preds"], pg[0]["preds"]) for p in pg):
            raise AssertionError(f"W={world}: the ranks' predicts differ")
        rel = float(((pg[0]["preds"] - base["predict"]["want"]).abs()
                     / base["predict"]["scale"]).max())
        k1 = sum(p["launches"]["rff_cos_bias"] for p in pg)
        k1_one = base["predict"]["launches"]["rff_cos_bias"]
        if not rel <= SHARD_PREDICT_RTOL or k1 != split[0] * k1_one:
            raise AssertionError(f"W={world} predict: {rel} of sum|phi "
                                 f"theta|, K1 {k1} over the ranks")
        seen["rff_cos_bias"] += k1
        log(28, f"[{card}] W={world} the sharded COKE model's predict on "
                f"{pg[0]['preds'].numel()} rows: every rank's answer "
                f"bitwise the others', within {rel:.3e} of sum|phi theta| "
                f"of the unsharded predict (tol {SHARD_PREDICT_RTOL:g}); K1 "
                f"{k1} launches over the ranks ({split[0]} x the one "
                f"process's {k1_one}: each batch row of ranks featurizes "
                f"the rows for its feature blocks); "
                + ", ".join(f"rank {r} {p['wall'] * 1e3:.1f} ms"
                            for r, p in enumerate(pg)))
        for r, res in enumerate(ranks):
            phi = res["memory"]["phi"]
            line = (f"[{card}]   rank {r} holds cells {res['cells_held']}: "
                    f"{phi[1] / 1e9:.3f} GB of Phi's {phi[0] / 1e9:.3f} GB "
                    f"({phi[1] / phi[0]:.3f}); allocated {phi[2] / 1e9:.3f} "
                    f"GB with the whole problem, {phi[3] / 1e9:.3f} GB once "
                    "it was placed and dropped")
            if "big_d" in res["memory"]:
                bd = res["memory"]["big_d"]
                line += (f"; big-D Phi {bd[1] / 1e9:.3f} of "
                         f"{bd[0] / 1e9:.3f} GB ({bd[1] / bd[0]:.3f}), "
                         f"peak {bd[2] / 1e9:.3f} GB while placing, "
                         f"{bd[3] / 1e9:.3f} GB held after")
            log(28, line + f"; {res['traffic']['calls']} gathers, "
                    f"{res['traffic']['bytes'] / 1e6:.1f} MB in all, "
                    f"{res['wall']:.1f} s")
            for kname, (e, tol, shape) in res["holds"].items():
                if not e <= tol:
                    raise AssertionError(f"rank {r}: {kname} disagrees with "
                                         f"its plain version: {e} > {tol}")
                errs[kname] = max(errs.get(kname, 0.0), e)
        for k, v in serve_ranks_check(card, dev, world, split, ranks,
                                      reg_thetas).items():
            seen[k] += v
        for res in ranks:
            for kname, (e, tol, shape) in res["serve"]["holds"].items():
                if not e <= tol:
                    raise AssertionError(f"serving: {kname} disagrees with "
                                         f"its plain version: {e} > {tol}")
                errs[kname] = max(errs.get(kname, 0.0), e)
        log(28, f"[{card}] W={world}: K3 on each rank's carry blocks "
                f"{ranks[0]['holds']['coke_fused_update'][2]}, K1 on its "
                f"feature blocks {ranks[0]['holds']['rff_cos_bias'][2]} and "
                "K5 at the draws' shapes held against their plain versions "
                f"on every rank, and K1 and K6 on each rank's blocks of a "
                f"bucket's row block "
                f"{ranks[0]['serve']['holds']['gather_rowdot'][2]}: "
                f"max|err| {errs}")
    writer.join()
    shutil.rmtree(reg_dir, ignore_errors=True)
    log(28, f"[{card}] launches over phase 28's ranks: "
            f"{ {k: v for k, v in seen.items() if v} } (blocks {blocks}); "
            f"phase 28 took {time.perf_counter() - t_phase:.1f} s")
    return seen, errs


def k7_operands(gen, dev, B, H, KV, S, D, Dv=None, Sk=None):
    """(B, S, H, D) q, (B, Sk, KV, D) k, (B, Sk, KV, Dv) v and (B, S, H,
    Dv) dO (Dv defaults to D, Sk to S), the model's layout."""
    Dv = D if Dv is None else Dv
    Sk = S if Sk is None else Sk
    return tuple(torch.randn(shape, generator=gen, device=dev)
                 for shape in ((B, S, H, D), (B, Sk, KV, D),
                               (B, Sk, KV, Dv), (B, S, H, Dv)))


def admissible_pairs(S, window, Sk=None, causal=True):
    """(query, key) pairs the mask admits over S queries and Sk keys (Sk
    defaults to S), query i and key j at positions i and j: j <= i where
    causal, j > i - window where window (0: none)."""
    Sk = S if Sk is None else Sk
    i = np.arange(S, dtype=np.int64)
    hi = np.minimum(i, Sk - 1) if causal else np.full(S, Sk - 1)
    lo = np.maximum(0, i - window + 1) if window else np.zeros(S, np.int64)
    return int(np.maximum(0, hi - lo + 1).sum())


def k7_library_ms(q, k, v, do, window, causal=True):
    """(ms, how) of the backward alone of one F.scaled_dot_product_attention
    call (memory-efficient backend, fp32) on q (B, H, Sq, Dh), v (B, KV,
    Sk, Dv) and k/v repeated to H heads before the call, with the causal
    mask or without it: torch.autograd.grad of its output at do, the graph
    kept. The yardstick of K7, called nowhere in the port. (None, why)
    where the backend refuses the shape."""
    import warnings
    from torch.nn.attention import SDPBackend, sdpa_kernel
    rep = q.shape[1] // k.shape[1]
    qq = q.detach().requires_grad_()
    kk = k.repeat_interleave(rep, dim=1).detach().requires_grad_()
    vv = v.repeat_interleave(rep, dim=1).detach().requires_grad_()
    mask = None
    if window:
        i = torch.arange(q.shape[2], device=q.device)[:, None]
        j = torch.arange(k.shape[2], device=q.device)[None, :]
        mask = j > i - window
        if causal:
            mask = mask & (j <= i)
    masked = ("boolean mask" if window else "is_causal" if causal
              else "no mask")
    how = (f"backward of EFFICIENT_ATTENTION, fp32, K/V repeated {rep}x "
           f"before the call, {masked}")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
                out = torch.nn.functional.scaled_dot_product_attention(
                    qq, kk, vv, attn_mask=mask,
                    is_causal=causal and mask is None)
            ms = time_ms(lambda: torch.autograd.grad(
                out, (qq, kk, vv), do, retain_graph=True),
                reps=1, runs=5, warmup=1)
        except RuntimeError as exc:
            return None, f"{how}: refused ({str(exc).splitlines()[0]})"
    return ms, how


def k7_hold(phase, dev, card, gen, flush, peaks, tag, B, H, KV, S, D, window,
            timed, Dv=None, *, Sk=None, causal=True, hold_k4=False):
    """K7 at one shape (S queries and Sk keys, default S; q, k of head dim
    D; v, dO of Dv, default D; causal or without the mask) against its
    plain version, within K7_RTOL of each gradient's max; with `hold_k4`,
    K4's output and log-sum-exp that it reads too, within K4_TOL (the +inf
    rows equal); where `timed`, its cold-L2 time beside its bound, the
    plain version and SDPA's backward. Returns the kernels line's entry
    for this shape (None where not timed); with `hold_k4`, (that, K7's
    largest error, K4's largest error)."""
    from repro_torch.kernels.flash_attention import flash_attention as k4
    from repro_torch.kernels.flash_attention import flash_attention_bwd as k7
    from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                         attention_lse_ref,
                                                         attention_ref)
    t = lambda x: x.transpose(1, 2)
    Dv = D if Dv is None else Dv
    Sk = S if Sk is None else Sk
    q, k, v, do = k7_operands(gen, dev, B, H, KV, S, D, Dv, Sk)
    lse = torch.empty((B, H, S), device=dev)
    out = k4.launch(q, k, v, heads_dim=2, causal=causal, window=window,
                    lse=lse)
    mask = f"{'causal' if causal else 'no mask'}, window={window}"
    lens = f"S={S}" if Sk == S else f"Sq={S}, Sk={Sk}"
    dims = f"D={D}" if Dv == D else f"Dh={D}, Dv={Dv}"
    k4_err = None
    if hold_k4:
        tol = K4_TOL[torch.float32]
        want_o = attention_ref(t(q), t(k), t(v), causal=causal,
                               window=window)
        o_err = float((t(out) - want_o).abs().max())
        del want_o
        want_l = attention_lse_ref(t(q), t(k), causal=causal, window=window)
        inf = torch.isinf(want_l)
        same_inf = bool(torch.equal(torch.isinf(lse), inf))
        l_err = float((lse[~inf] - want_l[~inf]).abs().max()) \
            if bool((~inf).any()) else 0.0
        k4_err = max(o_err, l_err)
        log(phase, f"K4 {tag} ({lens}, H={H}, KV={KV}, {dims}, {mask}): "
                   f"output max|err| {o_err:.3e}, log-sum-exp max|err| "
                   f"{l_err:.3e} (tol {tol:g}), +inf rows "
                   f"{int(inf.sum())}, equal: {same_inf}")
        if not (k4_err <= tol and same_inf):
            raise AssertionError(f"K4 or its log-sum-exp disagrees with its "
                                 f"plain version at the {tag} shape")

    def bwd():
        return k7.gqa_flash_bwd(q, k, v, out, do, lse, causal=causal,
                                window=window)

    got = bwd()
    want = attention_bwd_ref(t(q), t(k), t(v), t(out), t(do),
                             causal=causal, window=window)
    errs, rel = [], []
    for g, w in zip(got, want):
        e = float((g - t(w)).abs().max())
        errs.append(e)
        rel.append(e / float(w.abs().max()))
    del got, want
    log(phase, f"K7 {tag} (B={B}, {lens}, H={H}, KV={KV}, {dims}, {mask}): "
               f"max|err| dq {errs[0]:.3e}, dk {errs[1]:.3e}, dv "
               f"{errs[2]:.3e}; relative to each max {max(rel):.3e} (tol "
               f"{K7_RTOL:g})")
    if not max(rel) <= K7_RTOL:
        raise AssertionError(f"K7 disagrees with its plain version at the "
                             f"{tag} shape")
    if not timed:
        return (None, max(errs), k4_err) if hold_k4 else None
    bw, tf32 = peaks[0], peaks[3]
    big = max(S, Sk) > 1000
    ms = flushed_ms(bwd, flush, reps=5 if big else 50,
                    warmup=1 if big else 3)
    pairs = admissible_pairs(S, window, Sk, causal)
    # the backward's five products (S and dP recomputed once, dV, dK, dQ):
    # 6 Dh + 4 Dv flops a pair (10 D at Dh = Dv), at the least
    # fp32-accurate route, 3xTF32 (three TF32 MMAs a product) on the
    # tensor cores; its bytes: q, dQ (Dh) and o, dO (Dv) of (B, Sq, H), k,
    # dK (Dh) and v, dV (Dv) of (B, Sk, KV), L, each once
    flops = (6.0 * D + 4.0 * Dv) * pairs * B * H
    nbytes = 4.0 * (B * 2 * (D + Dv) * (S * H + Sk * KV) + B * H * S)
    t_f, t_b = 3 * flops / tf32 * 1e3, nbytes / bw * 1e3
    b_ms, b_by = (t_f, "operations") if t_f >= t_b else (t_b, "bytes")
    plan = k7.device_plan(q, k, v)
    plain_ms = time_ms(lambda: attention_bwd_ref(
        t(q), t(k), t(v), t(out), t(do), causal=causal, window=window),
        reps=1, runs=3, warmup=1)
    lib_ms, lib_how = k7_library_ms(t(q), t(k), t(v), t(do), window, causal)
    lib = "none" if lib_ms is None else f"{lib_ms:.4f} ms"
    log(phase, f"[{card}] K7 at the {tag} shape: {ms:.4f} ms with a cold "
               f"L2, bound {b_ms:.4f} ms ({b_by}: 3 x {flops / 1e12:.4f} "
               f"TFLOP at {tf32 / 1e12:g} TFLOP/s, 3xTF32, "
               f"{nbytes / 1e9:.4f} GB at {bw / 1e12:g} TB/s; "
               f"{b_ms / ms:.1%} of it); plain {plain_ms:.4f} ms; "
               f"library {lib} ({lib_how}); plan: widths "
               f"{plan.width}/{plan.width_v}, "
               f"dK/dV {plan.kv.rows}-key tiles, {plan.kv.warps} warps "
               f"({plan.kv.rw}x{plan.kv.cw}), {plan.kv.step_rows} query "
               f"rows a step, {plan.kv.smem} B, grid {plan.kv.grid}; dQ "
               f"{plan.q.rows}-query tiles, {plan.q.warps} warps "
               f"({plan.q.rw}x{plan.q.cw}), {plan.q.step_rows} key rows a "
               f"step, {plan.q.smem} B, grid {plan.q.grid}")
    entry = {"name": "flash_attention_bwd", "route": "cuda",
             "source": KERNEL_SOURCES["flash_attention_bwd"][0],
             "replaces": KERNEL_SOURCES["flash_attention_bwd"][1],
             "launches": None, "max_abs_err": max(errs), "ms": ms,
             "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
             "library_ms": lib_ms}
    return (entry, max(errs), k4_err) if hold_k4 else entry


def state_on(tree, where):
    """A copy of a train state (dicts, tuples, named tuples of tensors) on
    `where`."""
    if isinstance(tree, dict):
        return {k: state_on(x, where) for k, x in tree.items()}
    if isinstance(tree, tuple):
        items = [state_on(x, where) for x in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") \
            else tuple(items)
    if isinstance(tree, torch.Tensor):
        return tree.to(where, copy=True)
    return tree


def card_cpu_hold(dev, cfg, weights, stream, ccfg, agents, steps,
                  routes=None, extra=None):
    """Train `cfg` from `weights` on the CPU and on the card, `steps`
    batches of `stream` (split over `agents` under the consensus config
    `ccfg`; None trains allreduce), AdamW lr 3e-3, and compare them the way
    fp32 allows: two fp32 runs of many AdamW steps part chaotically (with
    no kernel at all, the plain attention on the card, the reduced qwen3
    and zamba2 part from the CPU by ~1e-4; scripts/train_probe.py), so at
    each step the card takes a copy of the CPU's state and runs that step
    and the next, beside its own free run. With `routes`, a list that a
    wrapped `models.moe.route` appends to, each step's routings of the
    card's step from the CPU's state and of the CPU's step are kept too.
    Returns a dict: per-step metrics `cpu`, `free`, the `forced` pairs;
    `same` (comms and send_frac of the free run equal the CPU's every
    step), `same_forced` (the same from the CPU's state), the worst
    relative loss differences `worst_free`, `worst_step` (that step's from
    the CPU's state), `worst_next` (the next step's, after the card's own
    update), and `routed`, [(card routings, CPU routings)] per step.
    `extra` maps a batch key to a tensor of the global batch that every
    step's batch carries beside the tokens (the VLM's prefix_embeds, the
    enc-dec model's encoder_embeds): the family's stub embeddings, made
    once and copied to both devices."""
    from repro_torch.optim.optimizers import OptConfig
    from repro_torch.train.steps import agent_batch, make_train_step
    keys = ("loss", "comms", "send_frac") if ccfg else ("loss",)
    fns, states, batches = {}, {}, {}
    for where in ("cpu", dev):
        init_fn, fns[where], _ = make_train_step(
            cfg, OptConfig(lr=3e-3), ccfg, num_agents=agents)
        states[where] = init_fn({k: x.to(where) for k, x in weights.items()})
        batches[where] = []
        for i in range(steps):
            toks, labels = stream.batch(i)
            b = {"tokens": torch.as_tensor(toks, device=where),
                 "labels": torch.as_tensor(labels, device=where),
                 **{k: x.to(where) for k, x in (extra or {}).items()}}
            batches[where].append(agent_batch(b, agents) if ccfg else b)
    routes = [] if routes is None else routes
    metrics = lambda m: {k: float(m[k]) for k in keys}
    cpu, free, forced, routed = [], [], [], []
    for i in range(steps):
        routes.clear()
        state = state_on(states["cpu"], dev)
        state, m = fns[dev](state, batches[dev][i])
        card_routes = list(routes)
        pair = [metrics(m)]
        if i + 1 < steps:
            pair.append(metrics(fns[dev](state, batches[dev][i + 1])[1]))
        forced.append(pair)
        del state
        states[dev], m = fns[dev](states[dev], batches[dev][i])
        free.append(metrics(m))
        routes.clear()
        states["cpu"], m = fns["cpu"](states["cpu"], batches["cpu"][i])
        cpu.append(metrics(m))
        routed.append((card_routes, list(routes)))
    torch.cuda.synchronize()
    rel = lambda a, c: abs(a["loss"] - c["loss"]) / abs(c["loss"])
    return {
        "cpu": cpu, "free": free, "forced": forced, "routed": routed,
        "same": all(a[k] == c[k] for a, c in zip(free, cpu)
                    for k in keys[1:]),
        "same_forced": all(x[k] == c[k] for i, pair in enumerate(forced)
                           for x, c in zip(pair, cpu[i:i + 2])
                           for k in keys[1:]),
        "worst_free": max(rel(a, c) for a, c in zip(free, cpu)),
        "worst_step": max(rel(pair[0], cpu[i])
                          for i, pair in enumerate(forced)),
        "worst_next": max((rel(pair[1], cpu[i + 1])
                           for i, pair in enumerate(forced[:-1])),
                          default=0.0)}


def hold_line(h, consensus, tol=TRAIN_SMALL_RTOL, free_tol=None):
    """The log text of a `card_cpu_hold` result; True where it holds: each
    step from the CPU's state within `tol`, and with `free_tol` the free
    run's losses within it too."""
    free = h["free"]
    sent = (f"; free run: comms {[int(r['comms']) for r in free]}, "
            f"send_frac {[r['send_frac'] for r in free]}, equal to the "
            f"CPU's every step: {h['same']}; from the CPU's state: equal "
            f"every step: {h['same_forced']}" if consensus else "")
    held = (f"tol {free_tol:g}" if free_tol is not None else
            "not held: fp32 order alone parts two runs by as much")
    text = (f"free-run losses {free[0]['loss']:.5f} -> "
            f"{free[-1]['loss']:.5f}, max relative difference to the CPU's "
            f"{h['worst_free']:.3e} ({held}); from the CPU's state each "
            f"step: that step's loss {h['worst_step']:.3e}, the next step's "
            f"after the card's update {h['worst_next']:.3e} (tol {tol:g})"
            f"{sent}")
    ok = (h["same"] and h["same_forced"]
          and h["worst_step"] <= tol and h["worst_next"] <= tol
          and (free_tol is None or h["worst_free"] <= free_tol))
    return text, ok


def timed_steps(tag, step_fns, state, batches, want, reset_counts, counts):
    """Train steps timed one by one (CUDA events and the host clock), the
    launch counts over them held to `want` and the losses to finite ones;
    returns (state, [(metrics, dev ms, host ms)])."""
    rows = []
    reset_counts()
    for fn, batch in zip(step_fns, batches):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        state, m = fn(state, batch)
        end.record()
        host = (time.perf_counter() - t0) * 1e3
        end.synchronize()
        rows.append(({k: float(v) for k, v in m.items()},
                     start.elapsed_time(end), host))
    got = {k: v for k, v in counts().items() if v}
    if got != {k: v for k, v in want.items() if v}:
        raise AssertionError(f"{tag} launched {got}, expected {want}")
    losses = [r[0]["loss"] for r in rows]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{tag}: losses {losses}")
    return state, rows


def fingerprint(x: torch.Tensor, chunk: int = 1 << 26) -> tuple[int, int]:
    """x's 32-bit words summed as int64, plain and weighted by their
    position mod 65521 plus one: integer sums, exact in any order (mod
    2^64), so equal bits give equal pairs; chunked, so a leaf of the
    embedding's size takes ~1.5 GB beside it."""
    w = x.detach().reshape(-1).view(torch.int32)
    plain = weighted = 0
    for start in range(0, w.numel(), chunk):
        c = w[start:start + chunk].to(torch.int64)
        pos = torch.arange(start, start + c.numel(), device=c.device) \
            % 65521 + 1
        plain += int(c.sum())
        weighted += int((c * pos).sum())
    return plain % 2**64, weighted % 2**64


def train_stream(cfg):
    """Phase 20's token stream (its batch and length) for `cfg`."""
    from repro_torch.data.tokens import TokenStream, TokenStreamConfig
    return TokenStream(TokenStreamConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
        global_batch=TRAIN_BATCH))


def train_batch(stream, i, dev, agents=None):
    from repro_torch.train.steps import agent_batch
    toks, labels = stream.batch(i)
    b = {"tokens": torch.as_tensor(toks, device=dev),
         "labels": torch.as_tensor(labels, device=dev)}
    return agent_batch(b, agents) if agents else b


def consensus_runs(dev, card, reset_counts, counts, strategies):
    """Phase 20(c): each of `strategies` at full width with the depth cut
    to TRAIN_CONSENSUS_LAYERS, TRAIN_AGENTS agents in this process,
    TRAIN_CONSENSUS_STEPS steps timed one by one (coke_et a local step,
    then a consensus step); K4 and K7 N x layers a step. For
    TRAIN_RANK_STRATEGIES it keeps phase 29's yardstick in TRAIN_YARDSTICK:
    each step's metrics and times, the peak memory and the final
    parameters in shared host memory."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.consensus import ConsensusConfig
    from repro_torch.optim.optimizers import OptConfig
    from repro_torch.train.steps import make_train_step

    cfg = get_config(LM_ARCH).with_overrides(
        num_layers=TRAIN_CONSENSUS_LAYERS)
    opt_cfg = OptConfig(kind="adamw", lr=TRAIN_LR, grad_clip=1.0)
    stream = train_stream(cfg)
    N, Lc, n = TRAIN_AGENTS, TRAIN_CONSENSUS_LAYERS, TRAIN_CONSENSUS_STEPS
    for strategy in strategies:
        local_steps = 2 if strategy == "coke_et" else 1
        ccfg = ConsensusConfig(strategy=strategy, rho=1e-3, censor_v=1.0,
                               censor_mu=0.99, local_steps=local_steps)
        torch.cuda.reset_peak_memory_stats()
        init_fn, step_fn, local_fn = make_train_step(cfg, opt_cfg, ccfg,
                                                     num_agents=N)
        state = init_fn(torch.Generator(device=dev).manual_seed(0))
        fns = [local_fn if (i + 1) % local_steps else step_fn
               for i in range(n)]
        state, rows = timed_steps(
            strategy, fns, state,
            [train_batch(stream, i, dev, N) for i in range(n)],
            {"flash_attention": N * Lc * n,
             "flash_attention_bwd": N * Lc * n}, reset_counts, counts)
        peak = torch.cuda.max_memory_allocated() / 1e9
        if strategy in TRAIN_RANK_STRATEGIES:
            flat = {k: x.reshape(N, -1) for k, x in state["params"].items()}
            TRAIN_YARDSTICK[strategy] = {
                "rows": rows, "peak": peak,
                "bytes": sum(f[0].nbytes for f in flat.values()),
                "max": {k: f.abs().amax(1).cpu() for k, f in flat.items()},
                "sample": {k: f[:, ::TRAIN_RANK_STRIDE].cpu().share_memory_()
                           for k, f in flat.items()}}
            del flat
        for i, (m, d_ms, h_ms) in enumerate(rows):
            extra = "".join(f", {k} {m[k]:g}" for k in
                            ("comms", "send_frac", "consensus_gap")
                            if k in m)
            log(20, f"[{card}] {strategy} step {i} "
                    f"({'local' if fns[i] is local_fn else 'consensus'}): "
                    f"loss {m['loss']:.6f}{extra}; device {d_ms:.2f} ms, "
                    f"host {h_ms:.2f} ms")
        log(20, f"[{card}] {strategy} at full width, {N} agents, {Lc} "
                f"layers: K4 and K7 {N * Lc} launches each per step; peak "
                f"memory {peak:.2f} GB")
        del state
        torch.cuda.empty_cache()


def train_phase(dev, card, reset_counts, counts, *, peaks):
    """Phase 20: the port's training path (`train.steps`, the code of
    `launch/train.py`) through K4 and K7. (a) K7 alone against its plain
    version; (b) full-width allreduce training; (c) the consensus
    strategies at full width, depth cut; (d) the reduced coke run on the
    card against the CPU; (e) K7 at zamba2's head dim; (f) the reduced
    SSM model and hybrid trained on the card against the CPU; (g) both at
    full width. Returns (the kernels line's entry for K7, K4's launches
    over (f) and (g))."""
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenStream, TokenStreamConfig
    from repro_torch.distributed.consensus import ConsensusConfig
    from repro_torch.models import model as M
    from repro_torch.optim.optimizers import OptConfig
    from repro_torch.train.steps import agent_batch, make_train_step
    from torch.profiler import ProfilerActivity, profile

    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(20)
    flush = torch.empty(64 * 2**20, device=dev)      # 256 MB > the L2

    def hold_k7(tag, *shape, timed):
        return k7_hold(20, dev, card, gen, flush, peaks, tag, *shape,
                       timed=timed)

    # ---- (a) K7 alone against its plain version --------------------------
    entry = None
    for tag, shape in K7_SHAPES.items():
        got = hold_k7(tag, *shape, timed=tag in ("training", "prefill"))
        if tag == "training":
            entry = got
    torch.cuda.empty_cache()

    # ---- (b) full-width allreduce training ----------------------------------
    cfg = get_config(LM_ARCH)
    opt_cfg = OptConfig(kind="adamw", lr=TRAIN_LR, grad_clip=1.0)
    stream = TokenStream(TokenStreamConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
        global_batch=TRAIN_BATCH))

    def upload(i, agents=None, device=dev):
        toks, labels = stream.batch(i)
        b = {"tokens": torch.as_tensor(toks, device=device),
             "labels": torch.as_tensor(labels, device=device)}
        return agent_batch(b, agents) if agents else b

    def run(tag, step_fns, state, batches, want):
        return timed_steps(tag, step_fns, state, batches, want,
                           reset_counts, counts)

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    init_fn, step_fn, _ = make_train_step(cfg, opt_cfg)
    state = init_fn(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in state["params"].values())
    log(20, f"{LM_ARCH} allreduce: {n_params / 1e9:.3f} B fp32 parameters "
            f"drawn, AdamW slots allocated in {time.perf_counter() - t0:.1f}"
            " s")
    L = cfg.num_layers
    n = TRAIN_STEPS
    state, rows = run("allreduce", [step_fn] * n, state,
                      [upload(i) for i in range(n)],
                      {"flash_attention": L * n, "flash_attention_bwd": L * n})
    for i, (m, d_ms, h_ms) in enumerate(rows):
        log(20, f"[{card}] allreduce step {i}: loss {m['loss']:.6f}, "
                f"device {d_ms:.2f} ms, host {h_ms:.2f} ms")
    steady = rows[1:]
    d_med = statistics.median(r[1] for r in steady)
    h_med = statistics.median(r[2] for r in steady)
    # K4 and K7 per step, by the profiler over a sixth step
    batch = upload(n)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        state, _ = step_fn(state, batch)
        torch.cuda.synchronize()
    k4_ms = k7_ms = busy = 0.0
    top = []
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        ms = device_ms(e)
        busy += ms
        top.append((ms, e.count, e.key))
        if "flash_attention_kernel" in e.key:
            k4_ms += ms
        elif any(x in e.key for x in ("::bwd_kernel<", "::delta_kernel(")):
            k7_ms += ms
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(20, f"[{card}] allreduce at full width ({L} layers, B={TRAIN_BATCH}, "
            f"S={TRAIN_SEQ}): steps 1-{n - 1} median device {d_med:.2f} ms,"
            f" host {h_med:.2f} ms per step; K4 and K7 {L} launches each "
            f"per step; over a profiled step K4 {k4_ms:.3f} ms, K7 "
            f"{k7_ms:.3f} ms of {busy:.2f} ms of kernels"
            + ("" if busy else " (the profiler recorded no device time: "
               "not measured)")
            + f"; peak memory {peak:.2f} GB")
    for ms, count, key in sorted(top, reverse=True)[:8]:
        log(20, f"  {ms:.3f} ms  {count:>5} calls  {key[:100]}")
    entry["launches"] = L * n
    del state, batch
    torch.cuda.empty_cache()

    # ---- (c) the consensus strategies at full width, depth cut ------------
    consensus_runs(dev, card, reset_counts, counts, TRAIN_STRATEGIES)

    # ---- (d) the reduced coke run, card against CPU -----------------------
    # K3 runs here at the reduced size: on the full-width LM tree its
    # flatten would hold six more (N, 722 M) copies than phase (c) has room
    # for
    small = get_config(LM_ARCH).reduced()
    weights = M.param_dict(M.init_params(small,
                                         torch.Generator().manual_seed(0)))
    small_stream = TokenStream(TokenStreamConfig(
        vocab_size=small.vocab_size, seq_len=48, global_batch=8,
        structure=0.9))
    for fused in (False, True):
        ccfg = ConsensusConfig(strategy="coke", rho=1e-3, censor_v=20.0,
                               censor_mu=0.5, use_fused_kernel=fused)
        steps = TRAIN_SMALL_STEPS
        reset_counts()
        h = card_cpu_hold(dev, small, weights, small_stream, ccfg, 4, steps)
        n = 4 * small.num_layers * (3 * steps - 1)
        want = {"flash_attention": n, "flash_attention_bwd": n,
                "coke_fused_update": 3 * steps - 1 if fused else 0}
        seen = {k: v for k, v in counts().items() if v}
        if seen != {k: v for k, v in want.items() if v}:
            raise AssertionError(f"the reduced coke run launched {seen}, "
                                 f"expected {want}")
        text, ok = hold_line(h, True, free_tol=TRAIN_SMALL_RTOL)
        log(20, f"reduced {LM_ARCH}, 4 agents, coke v=20 mu=0.5, {steps} "
                f"steps{' with K3' if fused else ''}: {text}; K4 and K7 {n} "
                f"launches each{f', K3 {3 * steps - 1}' if fused else ''}")
        if not ok:
            raise AssertionError("the reduced coke run differs between card "
                                 "and CPU")

    # ---- (e) K7 at zamba2's head dim, alone --------------------------------
    for tag, shape in K7_ZAMBA2_SHAPES.items():
        hold_k7(tag, *shape, timed=True)
    del flush
    torch.cuda.empty_cache()

    def hybrid_applications(c):
        """Shared-block applications a forward makes (K4 and K7 once each
        per agent): one per group of a hybrid, none in a pure SSM model."""
        return (c.num_layers // c.shared_attn_every
                if c.arch_type == "hybrid" else 0)

    # ---- (f) the reduced SSM model and hybrid, card against CPU -----------
    # held as (d), but for the free-running losses, which are printed: free
    # runs to equal comms and send_frac, the losses step by step from the
    # CPU's state (`card_cpu_hold`)
    k4_launches = k7_launches = 0
    for arch, over in TRAIN_SSM_REDUCED:
        small = get_config(arch).reduced().with_overrides(**over)
        apps = hybrid_applications(small)
        weights = M.param_dict(M.init_params(
            small, torch.Generator().manual_seed(0)))
        small_stream = TokenStream(TokenStreamConfig(
            vocab_size=small.vocab_size, seq_len=48, global_batch=8,
            structure=0.9))
        for strategy, agents in (("allreduce", 1), ("coke", 4)):
            ccfg = (ConsensusConfig(strategy="coke", rho=1e-3, censor_v=20.0,
                                    censor_mu=0.5)
                    if strategy == "coke" else None)
            steps = TRAIN_SMALL_STEPS
            reset_counts()
            h = card_cpu_hold(dev, small, weights, small_stream, ccfg,
                              agents, steps)
            n = agents * apps * (3 * steps - 1)
            seen = {k: v for k, v in counts().items() if v}
            if seen != {k: n for k in ("flash_attention",
                                       "flash_attention_bwd") if n}:
                raise AssertionError(f"reduced {arch} {strategy} launched "
                                     f"{seen}, expected K4 = K7 = {n}")
            heads = (f", shared block Dh = Dv = {small.resolved_head_dim}"
                     if apps else "")
            text, ok = hold_line(h, ccfg is not None)
            log(20, f"(f) reduced {arch}{heads}, {strategy}, {agents} "
                    f"agent(s), {steps} steps: {text}; K4 and K7 {n} "
                    "launches each")
            if not ok:
                raise AssertionError(f"reduced {arch} {strategy} training "
                                     "differs between card and CPU")
            k4_launches += n
            k7_launches += n
        del weights

    # ---- (g) full-width mamba2 and zamba2, allreduce, one at a time --------
    from repro_torch.models.ssm import ssd_chunked
    for arch in TRAIN_SSM_FULL:
        cfg_f = get_config(arch)
        apps = hybrid_applications(cfg_f)
        n = TRAIN_STEPS
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        init_fn, step_fn, _ = make_train_step(cfg_f, opt_cfg)
        state = init_fn(torch.Generator(device=dev).manual_seed(0))
        n_params = sum(x.numel() for x in state["params"].values())
        f_stream = TokenStream(TokenStreamConfig(
            vocab_size=cfg_f.vocab_size, seq_len=TRAIN_SEQ,
            global_batch=TRAIN_BATCH))
        batches = []
        for i in range(n):
            toks, labels = f_stream.batch(i)
            batches.append({"tokens": torch.as_tensor(toks, device=dev),
                            "labels": torch.as_tensor(labels, device=dev)})
        state, rows = run(f"{arch} allreduce", [step_fn] * n, state, batches,
                          {"flash_attention": apps * n,
                           "flash_attention_bwd": apps * n})
        peak = torch.cuda.max_memory_allocated() / 1e9
        del state, batches
        torch.cuda.empty_cache()
        for i, (m, d_ms, h_ms) in enumerate(rows):
            log(20, f"[{card}] (g) {arch} allreduce step {i}: loss "
                    f"{m['loss']:.6f}, device {d_ms:.2f} ms, host "
                    f"{h_ms:.2f} ms")
        d_med = statistics.median(r[1] for r in rows[1:])
        h_med = statistics.median(r[2] for r in rows[1:])
        # the SSD scan's forward and backward at the step's shape, on
        # operands of its shapes, times the layers: its share of the step
        H_s, P_s, N_s = cfg_f.ssm_heads, cfg_f.ssm_head_dim, cfg_f.ssm_state
        sg = torch.Generator(device=dev).manual_seed(20)
        shape = (TRAIN_BATCH, TRAIN_SEQ)
        xs = torch.randn((*shape, H_s, P_s), generator=sg, device=dev)
        dt = torch.nn.functional.softplus(torch.randn(
            (*shape, H_s), generator=sg, device=dev))
        a_neg = -torch.rand((H_s,), generator=sg, device=dev) - 0.5
        bm, cm = (torch.randn((*shape, N_s), generator=sg, device=dev)
                  for _ in range(2))
        leaves = [x.requires_grad_() for x in (xs, dt, bm, cm)]
        dy = torch.randn_like(xs)

        def scan_fwd_bwd():
            y, _ = ssd_chunked(xs, dt, a_neg, bm, cm, cfg_f.ssm_chunk)
            return torch.autograd.grad(y, leaves, dy)

        ssd_t = paired_ms(scan_fwd_bwd, 1, runs=5, warmup=2)
        ssd_share = cfg_f.num_layers * ssd_t[0]
        del xs, dt, bm, cm, leaves, dy
        log(20, f"[{card}] (g) {arch} allreduce at full width "
                f"({cfg_f.num_layers} SSM layers"
                f"{f', {apps} shared-block applications' if apps else ''}; "
                f"{n_params / 1e9:.3f} B fp32 parameters; B={TRAIN_BATCH}, "
                f"S={TRAIN_SEQ}): steps 1-{n - 1} median device "
                f"{d_med:.2f} ms, host {h_med:.2f} ms per step; K4 and K7 "
                f"{apps} launches each per step; the SSD scan's forward and "
                f"backward {ssd_t[0]:.4f} ms on the device / {ssd_t[1]:.4f} "
                f"ms host a layer, x {cfg_f.num_layers} = {ssd_share:.2f} ms"
                f" ({ssd_share / d_med:.1%} of the step); peak memory "
                f"{peak:.2f} GB; losses "
                f"{[round(r[0]['loss'], 6) for r in rows]}")
        k4_launches += apps * n
        k7_launches += apps * n
    entry["launches"] += k7_launches
    log(20, f"[{card}] K4 and K7 launches over (f) and (g): {k4_launches}, "
            f"{k7_launches}; phase 20 took "
            f"{time.perf_counter() - t_phase:.1f} s")
    return entry, k4_launches


def moe_mla_train_phase(dev, card, reset_counts, counts, *, peaks):
    """Phase 25: the MoE and MLA families trained on the card through K4 and
    K7 at Dh != Dv. (a) K7 against its plain version at MLA's head dims
    (K7_MLA_SHAPES), timed with a cold L2 beside its bound, the plain
    version and SDPA's backward; (b) the reduced granite-3-8b,
    mixtral-8x7b, minicpm3-4b and deepseek-v2-lite-16b, allreduce and coke
    (v=20, mu=0.5) at 4 agents, card against CPU from the same weights:
    at each step the card takes the CPU's state, and every MoE layer's
    expert indices and drop set, comms and send_frac, and the losses of
    that step and the next lie with the CPU's; (c) full-width
    deepseek-v2-lite, minicpm3 and mixtral, allreduce, the depth cut to
    TRAIN_MOE_MLA_FULL, one model drawn, stepped and freed at a time.
    Returns (K7's launches and largest error, K4's launches)."""
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenStream, TokenStreamConfig
    from repro_torch.distributed.consensus import ConsensusConfig
    from repro_torch.models import model as M
    from repro_torch.models import moe as moe_mod
    from repro_torch.optim.optimizers import OptConfig
    from repro_torch.train.steps import make_train_step

    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(25)
    flush = torch.empty(64 * 2**20, device=dev)      # 256 MB > the L2
    k7_err = 0.0

    # ---- (a) K7 at MLA's head dims, alone ----------------------------------
    for tag, (B, H, KV, S, D, window, Dv) in K7_MLA_SHAPES.items():
        entry = k7_hold(25, dev, card, gen, flush, peaks, tag, B, H, KV, S,
                        D, window, timed=True, Dv=Dv)
        k7_err = max(k7_err, entry["max_abs_err"])
    del flush
    torch.cuda.empty_cache()

    # ---- (b) the reduced families, card against CPU -----------------------
    # The router's choice is discontinuous: the card's and the CPU's
    # routing are held equal at every step from the CPU's state first, then
    # the losses; a flip is printed with its margin and the seed.
    routes = []
    route = moe_mod.route

    def recorded(router, cfg, xg, capacity):
        r = route(router, cfg, xg, capacity)
        top = torch.sort(r.probs.detach(), dim=-1, descending=True)[0]
        margin = float((top[..., cfg.top_k - 1] - top[..., cfg.top_k]).min())
        routes.append((r.expert_idx.cpu(), r.keep.cpu(), margin))
        return r

    k4_launches = k7_launches = 0
    moe_mod.route = recorded
    try:
        for arch in TRAIN_MOE_MLA_REDUCED:
            small = get_config(arch).reduced()
            weights = M.param_dict(M.init_params(
                small, torch.Generator().manual_seed(0)))
            small_stream = TokenStream(TokenStreamConfig(
                vocab_size=small.vocab_size, seq_len=TRAIN_MOE_MLA_SEQ,
                global_batch=8, structure=0.9))
            heads = (f"MLA Dh {small.qk_nope_dim + small.qk_rope_dim} / Dv "
                     f"{small.v_head_dim}" if small.attn_kind == "mla" else
                     f"GQA {small.num_heads}/{small.num_kv_heads} of "
                     f"{small.resolved_head_dim}")
            moe = (f", MoE {small.num_experts} experts top-{small.top_k}"
                   if small.is_moe else "")
            window = (f", window {small.sliding_window}"
                      if small.sliding_window else "")
            for strategy, agents in (("allreduce", 1), ("coke", 4)):
                ccfg = (ConsensusConfig(strategy="coke", rho=1e-3,
                                        censor_v=20.0, censor_mu=0.5)
                        if strategy == "coke" else None)
                steps = TRAIN_MOE_MLA_STEPS
                reset_counts()
                h = card_cpu_hold(dev, small, weights, small_stream, ccfg,
                                  agents, steps, routes=routes)
                same_routes, margin, flips = True, math.inf, []
                for i, (card_routes, cpu_routes) in enumerate(h["routed"]):
                    if len(card_routes) != len(cpu_routes):
                        raise AssertionError(f"reduced {arch} {strategy} step"
                                             f" {i}: {len(card_routes)} MoE "
                                             f"routings on the card, "
                                             f"{len(cpu_routes)} on the CPU")
                    for layer, (a, c) in enumerate(zip(card_routes,
                                                       cpu_routes)):
                        margin = min(margin, c[2])
                        if not (torch.equal(a[0], c[0])
                                and torch.equal(a[1], c[1])):
                            same_routes = False
                            flips.append((i, layer, c[2]))
                # K4 and K7 once per layer of each agent's forward
                n = agents * small.num_layers * (3 * steps - 1)
                seen = {k: v for k, v in counts().items() if v}
                if seen != {"flash_attention": n, "flash_attention_bwd": n}:
                    raise AssertionError(f"reduced {arch} {strategy} launched "
                                         f"{seen}, expected K4 = K7 = {n}")
                routing = ""
                if small.is_moe:
                    routing = (f"; routing from the CPU's state, every MoE "
                               f"layer's expert indices and drop set equal "
                               f"the CPU's at every step: {same_routes}, "
                               f"smallest top-{small.top_k} margin "
                               f"{margin:.3e}")
                    for i, layer, mg in flips:
                        routing += (f"; flip at step {i}, routing {layer}, "
                                    f"margin {mg:.3e} (weights seed 0, "
                                    f"stream seed {small_stream.cfg.seed})")
                text, ok = hold_line(h, ccfg is not None,
                                     tol=TRAIN_MOE_MLA_RTOL)
                log(25, f"(b) reduced {arch} ({heads}{moe}{window}), "
                        f"{strategy}, {agents} agent(s), {steps} steps of B=8"
                        f" S={TRAIN_MOE_MLA_SEQ}: {text}{routing}; K4 and K7 "
                        f"{n} launches each")
                if not (same_routes and ok):
                    raise AssertionError(f"reduced {arch} {strategy} training "
                                         "differs between card and CPU")
                k4_launches += n
                k7_launches += n
            del weights
    finally:
        moe_mod.route = route

    # ---- (c) full width, allreduce, the depth cut, one model at a time ----
    opt_cfg = OptConfig(kind="adamw", lr=TRAIN_LR, grad_clip=1.0)
    total = torch.cuda.get_device_properties(dev).total_memory / 1e9
    for arch, layers in TRAIN_MOE_MLA_FULL:
        full = get_config(arch)
        cfg_f = full.with_overrides(num_layers=layers)
        n = TRAIN_STEPS
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        init_fn, step_fn, _ = make_train_step(cfg_f, opt_cfg)
        state = init_fn(torch.Generator(device=dev).manual_seed(0))
        n_params = sum(x.numel() for x in state["params"].values())
        weights_gb = 4.0 * n_params / 1e9
        f_stream = TokenStream(TokenStreamConfig(
            vocab_size=cfg_f.vocab_size, seq_len=TRAIN_SEQ,
            global_batch=TRAIN_BATCH))
        batches = []
        for i in range(n):
            toks, labels = f_stream.batch(i)
            batches.append({"tokens": torch.as_tensor(toks, device=dev),
                            "labels": torch.as_tensor(labels, device=dev)})
        state, rows = timed_steps(
            f"(c) {arch}", [step_fn] * n, state, batches,
            {"flash_attention": layers * n, "flash_attention_bwd": layers * n},
            reset_counts, counts)
        peak = torch.cuda.max_memory_allocated() / 1e9
        del state, batches
        losses = [r[0]["loss"] for r in rows]
        d_med = statistics.median(r[1] for r in rows[1:])
        h_med = statistics.median(r[2] for r in rows[1:])
        attn = (f"MLA Dh {cfg_f.qk_nope_dim + cfg_f.qk_rope_dim} / Dv "
                f"{cfg_f.v_head_dim}" if cfg_f.attn_kind == "mla" else
                f"GQA {cfg_f.num_heads}/{cfg_f.num_kv_heads} of "
                f"{cfg_f.resolved_head_dim}")
        log(25, f"[{card}] (c) {arch} allreduce at full width, {layers} of "
                f"{full.num_layers} layers ({attn}"
                f"{', MoE' if cfg_f.is_moe else ''}): {n_params / 1e9:.3f} B "
                f"fp32 parameters, {weights_gb:.2f} GB, reckoned peak "
                f"{TRAIN_PEAK_PER_WEIGHT:g} x = "
                f"{TRAIN_PEAK_PER_WEIGHT * weights_gb:.1f} GB of the card's "
                f"{total:.1f} GB; B={TRAIN_BATCH}, S={TRAIN_SEQ}: steps "
                f"1-{n - 1} median device {d_med:.2f} ms, host {h_med:.2f} "
                f"ms per step; K4 and K7 {layers} launches each per step; "
                f"peak memory {peak:.2f} GB; losses "
                f"{[round(x, 6) for x in losses]}")
        k4_launches += layers * n
        k7_launches += layers * n
        torch.cuda.empty_cache()
    log(25, f"[{card}] K4 and K7 launches over (b) and (c): {k4_launches}, "
            f"{k7_launches}; K7's largest error over (a) {k7_err:.3e}; phase "
            f"25 took {time.perf_counter() - t_phase:.1f} s")
    return k7_launches, k7_err, k4_launches


def lm_family_phase(dev, card, reset_counts, counts, *, peaks):
    """Phase 22: the LM families beside qwen3 (`LM_FAMILY`): (a) each
    reduced config served on the card against the CPU from the same
    weights; (b) each at full width, weights drawn on the card, serving
    LM_NEW_TOKENS greedy tokens, K4 once per layer of the prefill and no
    other kernel; (c) at full width, layer 0's attention through K4 against
    its plain version, layer 0's MoE on the card against the CPU (the MoE
    models), and layer 0's decode step after a prefill of S tokens against
    the plain attention of the last of S + 1 (the absorbed MLA decode;
    Mixtral's rolling window). End to end over all the layers the two
    paths part by more than LM_RTOL: scripts/lm_hold_probe.py; (d)
    the prefill split into K4 and the rest, decode per token, peak memory,
    and K4 at each model's shape beside its bound and SDPA. One model is
    drawn, served and freed before the next. Returns (K4 launches over
    (b)'s four generates, K4's largest error over (c))."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention.ops import gqa_flash
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.models import attention as A
    from repro_torch.models import blocks as blk
    from repro_torch.models import model as M
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.common import rms_norm
    from repro_torch.serve import Engine, ServeConfig

    t_phase = time.perf_counter()
    bw = peaks[0]
    t = lambda x: x.transpose(1, 2)
    idle = {name: 0 for name in KERNEL_SOURCES}

    def pair(d_h):
        return f"{d_h[0]:.4f} ms on the device / {d_h[1]:.4f} ms host enqueue"

    # ---- (a) the reduced configs, card against CPU --------------------------
    for arch in LM_FAMILY_REDUCED:
        cfg = get_config(arch).reduced()
        gpu = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
        cpu = M.LM(cfg, device="cpu")
        cpu.load_state_dict({n: w.cpu() for n, w in gpu.state_dict().items()})
        prompts = np.random.default_rng(22).integers(0, cfg.vocab_size,
                                                     (2, 96))
        scfg = ServeConfig(max_new_tokens=8,
                           cache_len=cfg.sliding_window or 104)
        reset_counts()
        toks_gpu = Engine(cfg, gpu, scfg).generate(prompts)
        torch.cuda.synchronize()
        seen = counts()
        toks_cpu = Engine(cfg, cpu, scfg).generate(prompts)
        log(22, f"(a) reduced {arch} ({M.layer_kind(cfg)} layers, "
                f"{cfg.attn_kind}, window {cfg.sliding_window}), 2 x 96 "
                f"prompt tokens, 8 new, cache {scfg.cache_len}: card tokens "
                f"{toks_gpu.tolist()}; equal to the CPU's: "
                f"{bool((toks_gpu == toks_cpu).all())}; launches {seen}")
        if seen != dict(idle, flash_attention=cfg.num_layers) or not (
                toks_gpu == toks_cpu).all():
            raise AssertionError(f"reduced {arch}: the card's tokens or "
                                 "launches differ")
        batch = torch.as_tensor(prompts)
        lg_gpu, _ = M.prefill_with_state(gpu, cfg, {"tokens": batch.to(dev)},
                                         104)
        lg_cpu, _ = M.prefill_with_state(cpu, cfg, {"tokens": batch}, 104)
        err = float((lg_gpu.cpu() - lg_cpu).abs().max())
        tol = LM_RTOL * float(lg_cpu.abs().max())
        log(22, f"(a) reduced {arch} prefill, card against CPU: logits "
                f"max|err| {err:.3e} (tol {tol:.3e}, rtol {LM_RTOL:g} of "
                "max|logit|)")
        if not err <= tol:
            raise AssertionError(f"reduced {arch}: the card's prefill logits "
                                 "differ beyond the LM tolerance")
        del gpu, cpu

    # ---- (b)-(d) each family at full width, one model at a time -------------
    launches, worst = 0, 0.0
    for arch, layers, B, S, cache in LM_FAMILY:
        cfg = get_config(arch)
        if layers is not None:
            cfg = cfg.with_overrides(num_layers=layers)
        cut = (f"{layers} of {get_config(arch).num_layers} layers"
               if layers else f"all {cfg.num_layers} layers")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        lm = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize()
        n_params = sum(w.numel() for w in lm.parameters())
        log(22, f"(b) {arch}, {cut}: {n_params / 1e9:.3f} B parameters "
                f"drawn on the card in fp32 ({n_params * 4 / 1e9:.2f} GB) in "
                f"{time.perf_counter() - t0:.1f} s")
        rng = np.random.default_rng(22)
        prompts = rng.integers(0, cfg.vocab_size, (B, S))
        engine = Engine(cfg, lm, ServeConfig(max_new_tokens=LM_NEW_TOKENS,
                                             cache_len=cache))
        reset_counts()
        t0 = time.perf_counter()
        served = engine.generate(prompts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        seen = counts()
        peak = torch.cuda.max_memory_allocated(dev)
        log(22, f"(b) {arch} generate: {B} x {S} prompt tokens, "
                f"{LM_NEW_TOKENS} new each, cache {cache}, in {wall:.2f} s "
                f"wall (first call); launch counts {seen}; peak memory "
                f"{peak / 1e9:.2f} GB; ids (first 8 of each row) "
                f"{served[:, :8].tolist()}")
        if seen != dict(idle, flash_attention=cfg.num_layers):
            raise AssertionError(f"{arch}: the serving path launched {seen}, "
                                 "not K4 once per layer of the prefill")
        if served.shape != (B, LM_NEW_TOKENS) or not (
                (served >= 0) & (served < cfg.vocab_size)).all():
            raise AssertionError(f"{arch}: generate gave {served.shape} "
                                 "tokens outside the vocabulary")
        launches += seen["flash_attention"]
        tokens = torch.as_tensor(prompts, device=dev)
        window = cfg.sliding_window
        with torch.inference_mode():
            # ---- (c) layer 0's attention: K4 against its plain version ---
            pos = torch.arange(S, dtype=torch.int32, device=dev)
            lp = lm.blocks[0]
            x0 = torch.nn.functional.embedding(tokens, lm.embed)
            h0 = rms_norm(x0, lp.ln1, cfg.norm_eps)
            if cfg.attn_kind == "mla":
                (q0, k0, v0), _ = A._mla_expand(lp.attn, cfg, h0, pos)
            else:
                q0, k0, v0 = A._gqa_project_qkv(lp.attn, cfg, h0, pos)
            H, KV = q0.shape[2], k0.shape[2]
            Dh, Dv = q0.shape[3], v0.shape[3]
            got = gqa_flash(q0, k0, v0, causal=True, window=window)
            heads = torch.arange(0, H, max(1, H // 8), device=dev)[:8]
            kv_heads = heads // (H // KV)
            want = attention_ref(t(q0[:, :, heads]), t(k0[:, :, kv_heads]),
                                 t(v0[:, :, kv_heads]), causal=True,
                                 window=window)
            err = float((got[:, :, heads] - t(want)).abs().max())
            worst = max(worst, err)
            log(22, f"(c) {arch} layer 0 attention (B={B}, S={S}, H={H}, "
                    f"KV={KV}, Dh={Dh}, Dv={Dv}, window {window}; v strides "
                    f"{tuple(v0.stride())}), K4 against its plain version on "
                    f"heads {heads.tolist()}: max|err| {err:.3e} (tol "
                    f"{K4_TOL[torch.float32]:g})")
            if not err <= K4_TOL[torch.float32]:
                raise AssertionError(f"{arch}: K4 disagrees with its plain "
                                     "version on layer 0")
            del want, got

            # ---- (c) layer 0's MoE, card against CPU ---------------------
            if cfg.is_moe:
                n = LM_FAMILY_MOE_TOKENS
                p0 = pos[:n]
                x1 = x0[:1, :n] + blk.attn_forward(lp.attn, cfg,
                                                   h0[:1, :n], p0)
                h1 = rms_norm(x1, lp.ln2, cfg.norm_eps)
                moe_cpu = moe_mod.MoE(cfg, device="cpu")
                moe_cpu.load_state_dict({k: w.cpu() for k, w in
                                         lp.moe.state_dict().items()})
                h1_cpu = h1.cpu()
                C = moe_mod._capacity(cfg, n)
                r_gpu = moe_mod.route(lp.moe.router, cfg, h1, C)
                r_cpu = moe_mod.route(moe_cpu.router, cfg, h1_cpu, C)
                y_gpu, aux_gpu = moe_mod.moe_forward(lp.moe, cfg, h1)
                y_cpu, aux_cpu = moe_mod.moe_forward(moe_cpu, cfg, h1_cpu)
                top = torch.sort(r_cpu.probs, dim=-1, descending=True)[0]
                margin = float((top[..., cfg.top_k - 1]
                                - top[..., cfg.top_k]).min())
                same = bool(torch.equal(r_gpu.expert_idx.cpu(),
                                        r_cpu.expert_idx))
                kept = bool(torch.equal(r_gpu.keep.cpu(), r_cpu.keep))
                e_y = float((y_gpu.cpu() - y_cpu).abs().max())
                tol_y = MOE_RTOL * float(y_cpu.abs().max())
                log(22, f"(c) {arch} layer 0 MoE on {n} tokens (E="
                        f"{cfg.num_experts}, top-{cfg.top_k}, "
                        f"{cfg.num_shared_experts} shared, C={C}), card "
                        f"against CPU: expert_idx equal {same}, keep mask "
                        f"equal {kept} ({int((~r_cpu.keep).sum())} of "
                        f"{r_cpu.keep.numel()} token-slots dropped), "
                        f"smallest top-{cfg.top_k} probability margin "
                        f"{margin:.3e}; y max|err| {e_y:.3e} (tol "
                        f"{tol_y:.3e}, rtol {MOE_RTOL:g}); aux "
                        f"{float(aux_gpu):.6f} / {float(aux_cpu):.6f}")
                if not (same and kept and e_y <= tol_y):
                    raise AssertionError(f"{arch}: layer 0's MoE differs "
                                         "between card and CPU")
                del moe_cpu, h1_cpu, y_cpu, y_gpu, x1, h1

            # ---- (c) one decode step against the prefill, layer 0 ---------
            # the served sequence's S + 1 tokens into layer 0's attention:
            # the cache of a prefill of the first S (the serving path's
            # attn_forward with cache_len: latents for MLA, rolling for a
            # window), one attn_decode of token S, against the plain
            # version's fp32 attention of the last row over the keys it
            # may see, through the same output projection
            seq = torch.cat([tokens, torch.as_tensor(
                served[:, :1], dtype=torch.long, device=dev)], dim=1)
            pos1 = torch.arange(S + 1, dtype=torch.int32, device=dev)
            h = rms_norm(torch.nn.functional.embedding(seq, lm.embed),
                         lp.ln1, cfg.norm_eps)
            _, c0 = blk.attn_forward(lp.attn, cfg, h[:, :S], pos1[:S],
                                     cache_len=cache)
            y_dec, _ = blk.attn_decode(lp.attn, cfg, h[:, S:], c0, S)
            if cfg.attn_kind == "mla":
                (q1, k1, v1), _ = A._mla_expand(lp.attn, cfg, h, pos1)
            else:
                q1, k1, v1 = A._gqa_project_qkv(lp.attn, cfg, h, pos1)
            lo = max(0, S + 1 - window) if window else 0
            last = attention_ref(t(q1[:, -1:]), t(k1[:, lo:]),
                                 t(v1[:, lo:]), causal=False)
            y_ref = A._out_project(lp.attn, t(last))
            e_dec = float((y_dec - y_ref).abs().max())
            tol_dec = LM_RTOL * float(y_ref.abs().max())
            log(22, f"(c) {arch} layer 0, one decode step at position {S} "
                    f"(cache {cache}, "
                    f"{'latent, absorbed' if cfg.attn_kind == 'mla' else 'KV'}"
                    f"{f', rolling: keys {lo}..{S}' if lo else ''}) against "
                    f"the plain attention of the prefill's last row: "
                    f"max|err| {e_dec:.3e} (tol {tol_dec:.3e}, rtol "
                    f"{LM_RTOL:g} of max|y|)")
            if not e_dec <= tol_dec:
                raise AssertionError(f"{arch}: the decode step differs from "
                                     "the prefill's attention")
            del c0, h, q1, k1, v1, last, y_ref, y_dec

            # ---- (d) times ------------------------------------------------
            batch = {"tokens": tokens}
            prefill_t = paired_ms(lambda: M.prefill_with_state(
                lm, cfg, batch, cache), 1, runs=3, warmup=0)
            k4_t = paired_ms(lambda: gqa_flash(q0, k0, v0, causal=True,
                                               window=window),
                             1, runs=5, warmup=1)
            k4_share = cfg.num_layers * k4_t[0]
            log(22, f"[{card}] (d) {arch} prefill of {B} x {S} tokens: "
                    f"{pair(prefill_t)}. K4: {cfg.num_layers} launches x "
                    f"{pair(k4_t)} = {k4_share:.4f} ms on the device "
                    f"({k4_share / prefill_t[0]:.1%} of the prefill); the "
                    f"rest {prefill_t[0] - k4_share:.4f} ms")
            _, lm_state = M.prefill_with_state(lm, cfg, batch, cache)
            token = torch.as_tensor(served[:, :1], dtype=torch.long,
                                    device=dev)

            def decode_steps():
                for i in range(LM_NEW_TOKENS - 1):
                    M.decode_step(lm, cfg, token, lm_state, S + i)

            decode_t = paired_ms(decode_steps, LM_NEW_TOKENS - 1, runs=2,
                                 warmup=1)
            log(22, f"[{card}] (d) {arch} decode per token (batch {B}, cache "
                    f"{cache}): {pair(decode_t)}; reading the fp32 weights "
                    f"once takes {n_params * 4 / bw * 1e3:.4f} ms at "
                    f"{bw / 1e12} TB/s; peak memory of the generate "
                    f"{peak / 1e9:.2f} GB")

            # K4 at the model's shape: its plan, bound and the library call
            if window:
                n_pairs = (window * (window + 1) // 2
                           + (S - window) * window)
            else:
                n_pairs = S * (S + 1) // 2
            flops = 2.0 * B * H * (Dh + Dv) * n_pairs
            nbytes = 4.0 * B * S * (H * Dh + KV * Dh + KV * Dv + H * Dv)
            b_ms, b_by, b_how = k4_bound(nbytes, flops, torch.float32, peaks)
            bq, bk, stages, smem, blocks = k4_plan(build, Dh, Dv,
                                                   torch.float32)
            try:
                lib_ms, lib_how = sdpa_ms(t(q0), t(k0), t(v0), causal=True,
                                          mask=None if not window else (
                                              (pos[None, :] <= pos[:, None])
                                              & (pos[None, :]
                                                 > pos[:, None] - window)))
                lib = f"{lib_ms:.4f} ms ({lib_how})"
            except RuntimeError as e:
                lib = f"not measured: {e}"
            log(22, f"[{card}] (d) {arch} K4 at (B={B}, S={S}, H={H}, "
                    f"KV={KV}, Dh={Dh}, Dv={Dv}, causal, window {window}, "
                    f"fp32): {k4_t[0]:.4f} ms, bound {b_ms:.4f} ms ({b_by}, "
                    f"{b_how}: {flops / 1e12:.4f} TFLOP over {n_pairs} "
                    f"admissible pairs per head, {nbytes / 1e9:.4f} GB; "
                    f"{b_ms / k4_t[0]:.1%} of it); plan {bq}-row query "
                    f"tiles, {bk}-key tiles in {stages} stages, {smem} B of "
                    f"shared memory, {blocks} block(s) per SM; "
                    f"F.scaled_dot_product_attention {lib}")
            del q0, k0, v0, x0, h0, lm_state
        del lm, engine
        torch.cuda.empty_cache()
    log(22, f"[{card}] K4 over (b)'s four generates: {launches} launches; "
            f"largest error over (c) {worst:.3e}; phase 22 took "
            f"{time.perf_counter() - t_phase:.1f} s")
    return launches, worst


def ssm_phase(dev, card, reset_counts, counts, *, peaks):
    """Phase 23: the SSM model and the grouped hybrid (`SSM_FAMILY`): (a)
    each reduced config served on the card against the CPU from the same
    weights, at a prompt that is not a multiple of the chunk; (b) each at
    full width, weights drawn on the card, serving LM_NEW_TOKENS greedy
    tokens, K4 once per application of the hybrid's shared block (9 for
    zamba2), never for mamba2, and no other kernel; (c) layer 0's mixer on
    SSM_HOLD_TOKENS tokens on the card and on the CPU against float64,
    zamba2's first
    shared-block application through K4 against its plain version, and
    layer 0's recurrent decode step after a prefill of S tokens against
    the chunked prefill of S + 1 (the state-space duality at full width);
    (d) the prefill split into the SSD scan, K4 and the rest, decode per
    token, peak memory, and K4 at zamba2's shape beside its bound and SDPA,
    with Dv = 64, 80 and 128 at Dh = 80. One model is drawn, served and
    freed before the next. Returns (K4 launches over (b)'s generates, K4's
    largest error over (c))."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention.ops import gqa_flash
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.models import attention as A
    from repro_torch.models import blocks as blk
    from repro_torch.models import model as M
    from repro_torch.models import ssm
    from repro_torch.models.common import rms_norm
    from repro_torch.serve import Engine, ServeConfig

    t_phase = time.perf_counter()
    bw = peaks[0]
    t = lambda x: x.transpose(1, 2)
    idle = {name: 0 for name in KERNEL_SOURCES}

    def pair(d_h):
        return f"{d_h[0]:.4f} ms on the device / {d_h[1]:.4f} ms host enqueue"

    def applications(cfg):
        """Launches of K4 a prefill makes: one per shared-block application
        of a hybrid, none in a pure SSM model."""
        if cfg.arch_type == "hybrid":
            return cfg.num_layers // cfg.shared_attn_every
        return 0

    def rel(got, want):
        """max|got - want| / max|want|, on the CPU in float64."""
        got, want = got.double().cpu(), want.double().cpu()
        return float((got - want).abs().max() / want.abs().max())

    # ---- (a) the reduced configs, card against CPU --------------------------
    for arch, _, _ in SSM_FAMILY:
        cfg = get_config(arch).reduced()
        gpu = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
        cpu = M.LM(cfg, device="cpu")
        cpu.load_state_dict({n: w.cpu() for n, w in gpu.state_dict().items()})
        S = SSM_REDUCED_PROMPT
        prompts = np.random.default_rng(23).integers(0, cfg.vocab_size,
                                                     (2, S))
        scfg = ServeConfig(max_new_tokens=8, cache_len=S + 8)
        reset_counts()
        toks_gpu = Engine(cfg, gpu, scfg).generate(prompts)
        torch.cuda.synchronize()
        seen = counts()
        toks_cpu = Engine(cfg, cpu, scfg).generate(prompts)
        apps = applications(cfg)
        log(23, f"(a) reduced {arch} ({cfg.num_layers} SSM layers, chunk "
                f"{cfg.ssm_chunk}, {apps} shared-block application(s)), 2 x "
                f"{S} prompt tokens, 8 new: card tokens {toks_gpu.tolist()}; "
                f"equal to the CPU's: {bool((toks_gpu == toks_cpu).all())}; "
                f"launches {seen}")
        if seen != dict(idle, flash_attention=apps) or not (
                toks_gpu == toks_cpu).all():
            raise AssertionError(f"reduced {arch}: the card's tokens or "
                                 "launches differ")
        batch = torch.as_tensor(prompts)
        lg_gpu, _ = M.prefill_with_state(gpu, cfg, {"tokens": batch.to(dev)},
                                         S + 8)
        lg_cpu, _ = M.prefill_with_state(cpu, cfg, {"tokens": batch}, S + 8)
        err = float((lg_gpu.cpu() - lg_cpu).abs().max())
        tol = LM_RTOL * float(lg_cpu.abs().max())
        log(23, f"(a) reduced {arch} prefill, card against CPU: logits "
                f"max|err| {err:.3e} (tol {tol:.3e}, rtol {LM_RTOL:g} of "
                "max|logit|)")
        if not err <= tol:
            raise AssertionError(f"reduced {arch}: the card's prefill logits "
                                 "differ beyond the LM tolerance")
        del gpu, cpu

    # ---- (b)-(d) each model at full width, one at a time ---------------------
    launches, worst = 0, 0.0
    for arch, B, S in SSM_FAMILY:
        cfg = get_config(arch)
        cache = S + LM_NEW_TOKENS
        apps = applications(cfg)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        lm = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize()
        n_params = sum(w.numel() for w in lm.parameters())
        log(23, f"(b) {arch}, all {cfg.num_layers} SSM layers"
                f"{f', shared block every {cfg.shared_attn_every}' if apps else ''}"
                f": {n_params / 1e9:.3f} B parameters drawn on the card in "
                f"fp32 ({n_params * 4 / 1e9:.2f} GB) in "
                f"{time.perf_counter() - t0:.1f} s")
        prompts = np.random.default_rng(23).integers(0, cfg.vocab_size,
                                                     (B, S))
        engine = Engine(cfg, lm, ServeConfig(max_new_tokens=LM_NEW_TOKENS,
                                             cache_len=cache))
        reset_counts()
        t0 = time.perf_counter()
        served = engine.generate(prompts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        seen = counts()
        peak = torch.cuda.max_memory_allocated(dev)
        log(23, f"(b) {arch} generate: {B} x {S} prompt tokens, "
                f"{LM_NEW_TOKENS} new each, cache {cache}, in {wall:.2f} s "
                f"wall (first call); launch counts {seen}; peak memory "
                f"{peak / 1e9:.2f} GB; ids (first 8 of each row) "
                f"{served[:, :8].tolist()}")
        if seen != dict(idle, flash_attention=apps):
            raise AssertionError(f"{arch}: the serving path launched {seen}, "
                                 f"not K4 {apps} times (once per shared-"
                                 "block application) and nothing else")
        if served.shape != (B, LM_NEW_TOKENS) or not (
                (served >= 0) & (served < cfg.vocab_size)).all():
            raise AssertionError(f"{arch}: generate gave {served.shape} "
                                 "tokens outside the vocabulary")
        launches += seen["flash_attention"]
        tokens = torch.as_tensor(prompts, device=dev)
        first = lm.blocks[0][0] if apps else lm.blocks[0]
        with torch.inference_mode():
            pos = torch.arange(S, dtype=torch.int32, device=dev)
            x0 = torch.nn.functional.embedding(tokens, lm.embed)

            # ---- (c) layer 0's mixer: card and CPU against float64 --------
            n = SSM_HOLD_TOKENS
            h = rms_norm(x0[:, :n], first.ln1, cfg.norm_eps)
            y_gpu, c_gpu = ssm.ssm_forward(first.ssm, cfg, h,
                                           return_cache=True)
            weights = {k: w.cpu() for k, w in first.ssm.state_dict().items()}
            outs = {}
            for dtype in (torch.float32, torch.float64):
                mixer = ssm.SSM(cfg.with_overrides(dtype=dtype),
                                device="cpu")
                mixer.load_state_dict(weights)
                outs[dtype] = ssm.ssm_forward(mixer, cfg,
                                              h.cpu().to(dtype),
                                              return_cache=True)
            (y_cpu, c_cpu), (y64, c64) = outs.values()
            e = {what: (rel(g, w64), rel(c, w64), rel(g, c))
                 for what, g, c, w64 in (
                     ("y", y_gpu, y_cpu, y64),
                     ("state", c_gpu.state, c_cpu.state, c64.state))}
            e_t = max(float((g.cpu() - c).abs().max())
                      for g, c in zip(c_gpu[:2], c_cpu[:2]))
            log(23, f"(c) {arch} layer 0 mixer on {B} x {n} tokens (chunk "
                    f"{cfg.ssm_chunk}, H={cfg.ssm_heads}, P="
                    f"{cfg.ssm_head_dim}, N={cfg.ssm_state}), max|err| over "
                    "max|float64|: "
                    + "; ".join(f"{what} card {a:.3e}, CPU {b:.3e} (card "
                                f"within {SSM_F64_RATIO:g}x the CPU's: "
                                f"{a <= SSM_F64_RATIO * b}), card against "
                                f"CPU {c:.3e}"
                                for what, (a, b, c) in e.items())
                    + f"; conv tails card against CPU max|err| {e_t:.3e}")
            if not all(a <= SSM_F64_RATIO * b for a, b, _ in e.values()):
                raise AssertionError(f"{arch}: layer 0's mixer on the card "
                                     "is further from float64 than "
                                     f"{SSM_F64_RATIO:g}x the CPU's")
            del weights, outs, y_cpu, c_cpu, y64, c64, y_gpu, c_gpu, h

            # ---- (c) one recurrent decode step against the chunked prefill
            # of the served sequence's S + 1 tokens, layer 0
            seq = torch.cat([tokens, torch.as_tensor(
                served[:, :1], dtype=torch.long, device=dev)], dim=1)
            h = rms_norm(torch.nn.functional.embedding(seq, lm.embed),
                         first.ln1, cfg.norm_eps)
            _, c0 = ssm.ssm_forward(first.ssm, cfg, h[:, :S],
                                    return_cache=True)
            y_dec, _ = ssm.ssm_decode(first.ssm, cfg, h[:, S:], c0)
            y_full = ssm.ssm_forward(first.ssm, cfg, h)[:, S:]
            e_dec = float((y_dec - y_full).abs().max())
            tol_dec = LM_RTOL * float(y_full.abs().max())
            log(23, f"(c) {arch} layer 0, one recurrent decode step at "
                    f"position {S} after a chunked prefill of {S} against "
                    f"the chunked prefill of {S + 1} ({(S + 1) % cfg.ssm_chunk}"
                    f" token(s) in its last chunk): max|err| {e_dec:.3e} (tol "
                    f"{tol_dec:.3e}, rtol {LM_RTOL:g} of max|y|)")
            if not e_dec <= tol_dec:
                raise AssertionError(f"{arch}: the decode step differs from "
                                     "the chunked prefill")
            del seq, h, c0, y_dec, y_full

            # ---- (c) the first shared-block application: K4 against its
            # plain version on the same operands
            q0 = None
            if apps:
                x = x0
                for lp in lm.blocks[0]:
                    x, _ = blk.block_forward(lp, cfg, x, pos, "ssm")
                hs = rms_norm(x, lm.shared_attn.ln1, cfg.norm_eps)
                q0, k0, v0 = A._gqa_project_qkv(lm.shared_attn.attn, cfg, hs,
                                                pos)
                H, KV = q0.shape[2], k0.shape[2]
                Dh, Dv = q0.shape[3], v0.shape[3]
                got = gqa_flash(q0, k0, v0, causal=True)
                heads = torch.arange(0, H, max(1, H // 8), device=dev)[:8]
                kv_heads = heads // (H // KV)
                ops = (t(q0[:, :, heads]), t(k0[:, :, kv_heads]),
                       t(v0[:, :, kv_heads]))
                want = attention_ref(*ops, causal=True)
                # the exact attention: the same masked softmax in float64
                q64, k64, v64 = (o.double() for o in ops)
                s64 = (q64 @ k64.transpose(-1, -2)) / Dh ** 0.5
                s64.masked_fill_(torch.ones((S, S), dtype=torch.bool,
                                            device=dev).triu(1), -math.inf)
                s_max = float(s64[s64 > -math.inf].abs().max())
                exact = torch.softmax(s64, dim=-1) @ v64
                del s64, q64, k64
                mine = t(got[:, :, heads])
                err = float((mine - want).abs().max())
                err64 = float((mine.double() - exact).abs().max())
                plain64 = float((want.double() - exact).abs().max())
                v_max = float(v64.abs().max())
                tol = K4_TOL[torch.float32]
                worst = max(worst, err)
                log(23, f"(c) {arch} first shared-block application (after "
                        f"{cfg.shared_attn_every} SSM layers; B={B}, S={S}, "
                        f"H={H}, KV={KV}, Dh={Dh}, Dv={Dv}; max|v| "
                        f"{v_max:.3f}, max|out| "
                        f"{float(exact.abs().max()):.3f}, max|score| "
                        f"{s_max:.3f}) on heads {heads.tolist()}: K4 against "
                        f"its plain version max|err| {err:.3e}; against the "
                        f"float64 attention K4 {err64:.3e} (tol {tol:g}), "
                        f"the plain version {plain64:.3e} (K4 "
                        f"{err64 / plain64:.2f}x it)")
                if not err64 <= tol:
                    raise AssertionError(f"{arch}: K4 is further than "
                                         f"{tol:.3e} from the float64 "
                                         "attention on the shared block")
                del x, hs, got, want, exact, v64, mine, ops

            # ---- (d) times -----------------------------------------------
            batch = {"tokens": tokens}
            prefill_t = paired_ms(lambda: M.prefill_with_state(
                lm, cfg, batch, cache), 1, runs=3, warmup=0)
            # the SSD scan alone on layer 0's operands
            h = rms_norm(x0, first.ln1, cfg.norm_eps)
            _, xs, bc, dt = ssm._project(first.ssm, cfg, h)
            xs, _ = ssm._causal_conv(xs, first.ssm.conv_x, first.ssm.conv_bx)
            bc, _ = ssm._causal_conv(bc, first.ssm.conv_bc,
                                     first.ssm.conv_bbc)
            N = cfg.ssm_state
            xs = xs.reshape(B, S, cfg.ssm_heads, cfg.ssm_head_dim)
            dt = torch.nn.functional.softplus(dt.float()
                                              + first.ssm.dt_bias)
            a_neg = -torch.exp(first.ssm.A_log)
            ssd_t = paired_ms(lambda: ssm.ssd_chunked(
                xs, dt, a_neg, bc[..., :N], bc[..., N:], cfg.ssm_chunk),
                1, runs=5, warmup=1)
            ssd_share = cfg.num_layers * ssd_t[0]
            # the scan's bound: x, dt, B and C read once, y and the final
            # state written once; the products C.B, the causal half of the
            # scores times x, the chunk-end contributions and the
            # inter-chunk output, and ~4 elementwise operations a score
            H_s, P_s, Q = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_chunk
            nc, tri = -(-S // Q), Q * (Q + 1) // 2
            ssd_flops = 2.0 * B * nc * (Q * Q * N + H_s * tri * P_s
                                        + 2 * H_s * P_s * N * Q
                                        + 2 * H_s * tri)
            ssd_bytes = 4.0 * B * (2 * S * H_s * P_s + S * H_s + 2 * S * N
                                   + H_s * P_s * N)
            ssd_b = k4_bound(ssd_bytes, ssd_flops, torch.float32, peaks)
            del h, xs, bc, dt
            k4_share, k4_t = 0.0, None
            if apps:
                k4_t = paired_ms(lambda: gqa_flash(q0, k0, v0, causal=True),
                                 1, runs=5, warmup=1)
                k4_share = apps * k4_t[0]
            rest = prefill_t[0] - ssd_share - k4_share
            log(23, f"[{card}] (d) {arch} prefill of {B} x {S} tokens: "
                    f"{pair(prefill_t)}. SSD scan: {cfg.num_layers} layers x "
                    f"{pair(ssd_t)} = {ssd_share:.4f} ms on the device "
                    f"({ssd_share / prefill_t[0]:.1%} of the prefill; "
                    f"{S // cfg.ssm_chunk} chunks of {cfg.ssm_chunk}; a "
                    f"layer's scan bound {ssd_b[0]:.4f} ms ({ssd_b[1]}, "
                    f"{ssd_b[2]}: {ssd_flops / 1e9:.2f} GFLOP, "
                    f"{ssd_bytes / 1e6:.1f} MB), {ssd_b[0] / ssd_t[0]:.1%} "
                    "of it reached); K4: "
                    + (f"{apps} launches x {pair(k4_t)} = {k4_share:.4f} ms "
                       f"({k4_share / prefill_t[0]:.1%})" if apps else
                       "none")
                    + f"; the rest (GEMMs, conv, norms) {rest:.4f} ms")
            _, lm_state = M.prefill_with_state(lm, cfg, batch, cache)
            token = torch.as_tensor(served[:, :1], dtype=torch.long,
                                    device=dev)

            def decode_steps():
                for i in range(LM_NEW_TOKENS - 1):
                    M.decode_step(lm, cfg, token, lm_state, S + i)

            decode_t = paired_ms(decode_steps, LM_NEW_TOKENS - 1, runs=2,
                                 warmup=1)
            log(23, f"[{card}] (d) {arch} decode per token (batch {B}): "
                    f"{pair(decode_t)}; reading the fp32 weights once takes "
                    f"{n_params * 4 / bw * 1e3:.4f} ms at {bw / 1e12} TB/s; "
                    f"peak memory of the generate {peak / 1e9:.2f} GB")
            del lm_state

            # K4 at zamba2's shape: its plan, bound and the library call;
            # then Dv = 64, 80, 128 at Dh = 80 on operands of that shape
            if apps:
                n_pairs = S * (S + 1) // 2
                flops = 2.0 * B * H * (Dh + Dv) * n_pairs
                nbytes = 4.0 * B * S * (H * Dh + KV * Dh + KV * Dv + H * Dv)
                b_ms, b_by, b_how = k4_bound(nbytes, flops, torch.float32,
                                             peaks)
                bq, bk, stages, smem, blocks = k4_plan(build, Dh, Dv,
                                                       torch.float32)
                try:
                    lib_ms, lib_how = sdpa_ms(t(q0), t(k0), t(v0),
                                              causal=True)
                    lib = f"{lib_ms:.4f} ms ({lib_how})"
                except RuntimeError as e:
                    lib = f"not measured: {e}"
                plain_ms = time_ms(lambda: attention_ref(
                    t(q0), t(k0), t(v0), causal=True), reps=1, runs=3,
                    warmup=1)
                log(23, f"[{card}] (d) {arch} K4 at (B={B}, S={S}, H={H}, "
                        f"KV={KV}, Dh={Dh}, Dv={Dv}, causal, fp32): "
                        f"{k4_t[0]:.4f} ms, bound {b_ms:.4f} ms ({b_by}, "
                        f"{b_how}: {flops / 1e12:.4f} TFLOP over {n_pairs} "
                        f"admissible pairs per head, {nbytes / 1e9:.4f} GB; "
                        f"{b_ms / k4_t[0]:.1%} of it); plan {bq}-row query "
                        f"tiles, {bk}-key tiles in {stages} stages, {smem} B "
                        f"of shared memory, {blocks} block(s) per SM; its "
                        f"plain version {plain_ms:.4f} ms; "
                        f"F.scaled_dot_product_attention {lib}")
                gen = torch.Generator(device=dev).manual_seed(23)
                widths = []
                for dv in SSM_K4_DV:
                    v = torch.randn((B, S, KV, dv), generator=gen,
                                    device=dev)
                    ms = time_ms(lambda: gqa_flash(q0, k0, v, causal=True),
                                 reps=3, runs=5, warmup=1)
                    widths.append(f"Dv={dv} (nj={(dv + 63) // 64}) "
                                  f"{ms:.4f} ms")
                    del v
                log(23, f"[{card}] (d) {arch} K4 at Dh={Dh} by value width, "
                        f"same q and k: {'; '.join(widths)}")
                del q0, k0, v0
            del x0
        del lm, engine
        torch.cuda.empty_cache()
    log(23, f"[{card}] K4 over (b)'s generates: {launches} launches; "
            f"largest error over (c) {worst:.3e}; phase 23 took "
            f"{time.perf_counter() - t_phase:.1f} s")
    return launches, worst


def exact_attention(q, k, v, heads_at_once=K4_CURVE_F64_HEADS):
    """The causal attention of q (B, H, S, Dh), k/v (B, H, S, *) in
    float64, `heads_at_once` heads at a time so that the (S, S) float64
    scores fit: the yardstick of K4's fp32 error."""
    S, scale = q.shape[2], q.shape[3] ** -0.5
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device).triu(1)
    out = []
    for h in range(0, q.shape[1], heads_at_once):
        hs = slice(h, h + heads_at_once)
        s = (q[:, hs].double() @ k[:, hs].double().transpose(-1, -2)) * scale
        s.masked_fill_(mask, -math.inf)
        out.append(torch.softmax(s, dim=-1) @ v[:, hs].double())
        del s
    return torch.cat(out, dim=1)


def coherent_normal(gen, shape):
    """(B, S, H, D) values of one sign down each (head, channel): a
    unit-normal mean per channel plus K4_CURVE_NOISE times unit noise,
    scaled to max|.| = K4_CURVE_VMAX."""
    x = torch.randn((1, 1, *shape[2:]), generator=gen, device=gen.device) \
        + K4_CURVE_NOISE * torch.randn(shape, generator=gen,
                                       device=gen.device)
    return x * (K4_CURVE_VMAX / x.abs().max())


def k4_row_curve(dev, lengths=K4_CURVE_LENGTHS, seed=24):
    """K4's fp32 error against float64 along the row (phase 24(a)): for
    each S in `lengths`, (1, S, K4_CURVE_HEADS heads, 128) causal, q and k
    unit normal, v a mean per channel plus K4_CURVE_NOISE times noise,
    scaled to max|v| = K4_CURVE_VMAX (`coherent_normal`). Returns one dict
    per S: K4's and the plain version's max|err| and their mean signed
    error (err * sign(exact), over the output: negative where the error
    pulls toward 0), max|v|, max|exact| and mean|exact|."""
    from repro_torch.kernels.flash_attention.ops import gqa_flash
    from repro_torch.kernels.flash_attention.ref import attention_ref
    t = lambda x: x.transpose(1, 2)
    H, D, rows = K4_CURVE_HEADS, 128, []
    for S in lengths:
        gen = torch.Generator(device=dev).manual_seed(seed)
        q, k = (torch.randn((1, S, H, D), generator=gen, device=dev)
                for _ in range(2))
        v = coherent_normal(gen, (1, S, H, D))
        with torch.inference_mode():
            got = t(gqa_flash(q, k, v, causal=True)).double()
            plain = attention_ref(t(q), t(k), t(v), causal=True).double()
            exact = exact_attention(t(q), t(k), t(v))
            sign = exact.sign()
            row = {"S": S, "v_max": float(v.abs().max()),
                   "max_abs": float(exact.abs().max()),
                   "mean_abs": float(exact.abs().mean())}
            for name, x in (("k4", got), ("plain", plain)):
                d = x - exact
                row[f"{name}_err"] = float(d.abs().max())
                row[f"{name}_bias"] = float((d * sign).mean())
        rows.append(row)
        del q, k, v, got, plain, exact, sign, d
        torch.cuda.empty_cache()
    return rows


def k4_curve_line(row):
    """One line of text for a `k4_row_curve` row."""
    return (f"S={row['S']}: K4 max|err| {row['k4_err']:.3e}, plain "
            f"{row['plain_err']:.3e} (K4 {row['k4_err'] / row['plain_err']:.2f}"
            f"x the plain version's); mean signed error K4 "
            f"{row['k4_bias']:+.3e}, plain {row['plain_bias']:+.3e}; "
            f"max|v| {row['v_max']:.3f}, max|out| {row['max_abs']:.3f}, "
            f"mean|out| {row['mean_abs']:.3f}")


def k4_accuracy_phase(dev, card, reset_counts, counts):
    """Phase 24: K4's fp32 accuracy. (a) the error along the row against
    float64 (`k4_row_curve`), held within K4_TOL at every length; (b) for
    each of K4_DEPTH_HOLDS, one model drawn and freed at a time, the
    full-depth prefill's logits through K4 against the same prefill with
    every layer's attention through the plain version on the card (the
    swap is made here, for this hold only: the GEMMs are the same in both,
    so the difference is K4's), within LM_RTOL of max|logit|; beside it,
    without a hold, the prefill of S + 1 tokens against the prefill of S
    and one decode step. Returns (K4's largest error against float64 over
    (a), K4 launches over (b)'s prefills through it)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models import attention as A
    from repro_torch.models import model as M

    t_phase = time.perf_counter()
    tol = K4_TOL[torch.float32]
    # ---- (a) the error along the row ---------------------------------------
    rows = k4_row_curve(dev)
    for row in rows:
        log(24, f"(a) K4 (1, S, {K4_CURVE_HEADS}/{K4_CURVE_HEADS}, 128) "
                f"causal fp32 against float64, " + k4_curve_line(row)
                + f" (tol {tol:g})")
    worst = max(row["k4_err"] for row in rows)
    if not worst <= tol:
        raise AssertionError(f"K4 is {worst:.3e} from the float64 attention "
                             f"on long rows, past K4_TOL {tol:g}")

    # ---- (b) full depth: K4 against the plain attention in every layer -----
    def plain_gqa(q, k, v, *, causal=True, window=0, block_q=128,
                  block_k=128):
        return ops._plain(q, k, v, causal, window)

    launches = 0
    idle = {name: 0 for name in KERNEL_SOURCES}
    for arch, B, S in K4_DEPTH_HOLDS:
        cfg = get_config(arch)
        torch.cuda.empty_cache()
        lm = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
        tokens = torch.as_tensor(np.random.default_rng(24).integers(
            0, cfg.vocab_size, (B, S + 1)), device=dev)
        head = {"tokens": tokens[:, :S]}
        with torch.inference_mode():
            reset_counts()
            lg_k4, state = M.prefill_with_state(lm, cfg, head, S + 1)
            torch.cuda.synchronize()
            seen = counts()
            A.gqa_flash = plain_gqa
            try:
                reset_counts()
                lg_plain, _ = M.prefill_with_state(lm, cfg, head, S + 1)
                torch.cuda.synchronize()
                seen_plain = counts()
            finally:
                A.gqa_flash = ops.gqa_flash
            if seen != dict(idle, flash_attention=cfg.num_layers) or \
                    seen_plain != idle:
                raise AssertionError(f"{arch}: the prefill through K4 "
                                     f"launched {seen}, the plain one "
                                     f"{seen_plain}")
            launches += seen["flash_attention"]
            err = float((lg_k4 - lg_plain).abs().max())
            scale = float(lg_plain.abs().max())
            log(24, f"(b) {arch}, all {cfg.num_layers} layers, {B} x {S} "
                    f"prompt tokens: last-position logits through K4 against "
                    f"the same prefill with every layer's attention through "
                    f"the plain version: max|err| {err:.3e} (tol "
                    f"{LM_RTOL * scale:.3e}, rtol {LM_RTOL:g} of max|logit| "
                    f"{scale:.3f}); K4 {seen['flash_attention']} launches")
            if not err <= LM_RTOL * scale:
                raise AssertionError(f"{arch}: the full-depth prefill through "
                                     "K4 parts from the plain attention's "
                                     "beyond LM_RTOL")
            lg_dec, _ = M.decode_step(lm, cfg, tokens[:, S:], state, S)
            lg_next, _ = M.prefill_with_state(lm, cfg, {"tokens": tokens},
                                              S + 1)
            e_dec = float((lg_dec - lg_next).abs().max())
            log(24, f"(b) {arch}: the prefill of {S + 1} tokens against the "
                    f"prefill of {S} and one decode step, last-position "
                    f"logits max|err| {e_dec:.3e} ({e_dec / scale:.3e} of "
                    f"max|logit|; reported, not held: the GEMMs differ in "
                    "shape)")
            del lg_k4, lg_plain, lg_dec, lg_next, state
        del lm
        torch.cuda.empty_cache()
    log(24, f"[{card}] phase 24 took {time.perf_counter() - t_phase:.1f} s")
    return worst, launches


def multimodal_phase(dev, card, reset_counts, counts, *, peaks):
    """Phase 26: the VLM prefix and enc-dec serving. (a) K4 at
    MM_K4_SHAPES against its plain version within K4_TOL, each timed with
    a cold L2 beside its plan, bound, plain version and SDPA; (b) the
    reduced internvl2-1b and seamless-m4t-medium on the card against the
    CPU from the same weights and stub embeddings: forward logits, the
    VLM's prefill caches, the enc-dec cross k/v of every layer, within
    LM_RTOL, and equal greedy tokens (VLM prompts shorter and longer than
    the prefix); (c) internvl2-1b at full width: one prefill_with_state
    of 256 patch rows + 3840 tokens launches K4 once per layer and
    nothing else, layer 0's attention through K4 against the plain
    version, a generate of LM_NEW_TOKENS with the prefix (K4 in its
    prefill only); (d) seamless-m4t-medium at full width: one prefill of
    2048 frames + 2048 tokens launches K4 once per encoder layer, decoder
    self attention and cross attention, encoder layer 0 and decoder layer
    0's cross attention through K4 against the plain version, a generate
    over 2048 frames (K4 in the encoder only: the prompt's replay and the
    decode run none); (c)-(d) the prefill split into K4 and the rest,
    decode per token and peak memory. One model drawn and freed at a
    time. Returns (K4 launches over (b)-(d)'s counted runs, K4's largest
    error against its plain version over (a), (c) and (d))."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ops import gqa_flash
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.models import attention as A
    from repro_torch.models import blocks as blk
    from repro_torch.models import model as M
    from repro_torch.models.common import rms_norm
    from repro_torch.serve import Engine, ServeConfig
    from repro_torch.serve.engine import _fill_cross_memory

    t_phase = time.perf_counter()
    bw = peaks[0]
    t = lambda x: x.transpose(1, 2)
    idle = {name: 0 for name in KERNEL_SOURCES}
    tol = K4_TOL[torch.float32]
    launches, worst = 0, 0.0

    def pair(d_h):
        return f"{d_h[0]:.4f} ms on the device / {d_h[1]:.4f} ms host enqueue"

    def held(tag, got, want):
        """Hold got within LM_RTOL of max|want|."""
        err = float((got.cpu() - want.cpu()).abs().max())
        scale = float(want.abs().max())
        log(26, f"{tag}: max|err| {err:.3e} (tol {LM_RTOL * scale:.3e}, "
                f"rtol {LM_RTOL:g} of max {scale:.3f})")
        if not err <= LM_RTOL * scale:
            raise AssertionError(f"{tag}: beyond LM_RTOL")

    def k4_held(tag, q, k, v, causal):
        """K4 on (B, S, heads, D) operands against its plain version,
        within K4_TOL; returns the error."""
        got = gqa_flash(q, k, v, causal=causal)
        want = attention_ref(t(q), t(k), t(v), causal=causal)
        err = float((t(got) - want).abs().max())
        log(26, f"{tag}: K4 against its plain version, max|err| {err:.3e} "
                f"(tol {tol:g})")
        if not err <= tol:
            raise AssertionError(f"{tag}: K4 disagrees with its plain "
                                 "version")
        return err

    def plain_gqa(q, k, v, *, causal=True, window=0, block_q=128,
                  block_k=128):
        return ops._plain(q, k, v, causal, window)

    def through_plain(fn):
        """fn() with every attention of the model through K4's plain
        version (swapped here for this call only); no kernel launches."""
        A.gqa_flash = plain_gqa
        try:
            reset_counts()
            out = fn()
            torch.cuda.synchronize()
            seen = counts()
        finally:
            A.gqa_flash = ops.gqa_flash
        if seen != idle:
            raise AssertionError(f"the plain attention launched {seen}")
        return out

    def counted(tag, fn, want):
        """fn() between a reset and a read of the launch counters, which
        must show K4 `want` times and nothing else."""
        nonlocal launches
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        seen = counts()
        if seen != dict(idle, flash_attention=want):
            raise AssertionError(f"{tag}: launched {seen}, not K4 {want} "
                                 "times and nothing else")
        launches += want
        return out

    # ---- (a) K4 at the slice's shapes ---------------------------------------
    flush = torch.empty(64 * 2**20, device=dev)      # 256 MB > the L2
    gen = torch.Generator(device=dev).manual_seed(26)
    for what, B, Sq, Sk, H, KV, D, causal in MM_K4_SHAPES:
        q = torch.randn((B, Sq, H, D), generator=gen, device=dev)
        k = torch.randn((B, Sk, KV, D), generator=gen, device=dev)
        v = torch.randn((B, Sk, KV, D), generator=gen, device=dev)
        shape = (f"(B={B}, Sq={Sq}, Sk={Sk}, H={H}, KV={KV}, Dh=Dv={D}, "
                 f"{'causal' if causal else 'no mask'}, fp32)")
        worst = max(worst, k4_held(f"(a) {what} {shape}", q, k, v, causal))
        ms = flushed_ms(lambda: gqa_flash(q, k, v, causal=causal), flush,
                        reps=20, warmup=2)
        plain_ms = time_ms(lambda: attention_ref(t(q), t(k), t(v),
                                                 causal=causal),
                           reps=1, runs=3, warmup=1)
        n_pairs = Sq * (Sq + 1) // 2 if causal else Sq * Sk
        flops = 2.0 * B * H * 2 * D * n_pairs
        nbytes = 4.0 * B * D * 2 * (Sq * H + Sk * KV)
        b_ms, b_by, b_how = k4_bound(nbytes, flops, torch.float32, peaks)
        bq, bk, stages, smem, blocks = k4_plan(build, D, D, torch.float32)
        try:
            lib_ms, lib_how = sdpa_ms(t(q), t(k), t(v), causal=causal)
            lib = f"{lib_ms:.4f} ms ({lib_how}; K4 {ms / lib_ms:.2f}x it)"
        except RuntimeError as e:
            lib = f"not measured: {e}"
        log(26, f"[{card}] (a) {what} K4 {shape}: {ms:.4f} ms with a cold "
                f"L2, bound {b_ms:.4f} ms ({b_by}, {b_how}: "
                f"{flops / 1e12:.4f} TFLOP over {n_pairs} admissible pairs "
                f"per head, {nbytes / 1e9:.4f} GB; {b_ms / ms:.1%} of it); "
                f"plan {bq}-row query tiles, {bk}-key tiles in {stages} "
                f"stages, {smem} B of shared memory, {blocks} block(s) per "
                f"SM; plain {plain_ms:.4f} ms; "
                f"F.scaled_dot_product_attention {lib}")
        del q, k, v
    del flush
    torch.cuda.empty_cache()

    # ---- (b) the reduced models, card against CPU ---------------------------
    for arch in ("internvl2-1b", "seamless-m4t-medium"):
        cfg = get_config(arch).reduced()
        gpu = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
        cpu = M.LM(cfg, device="cpu")
        cpu.load_state_dict({n: w.cpu() for n, w in gpu.state_dict().items()})
        rng = np.random.default_rng(26)
        if cfg.is_encdec:
            key, rows, want = ("encoder_embeds", MM_REDUCED_FRAMES,
                               cfg.encoder_layers)
            prompt_lens = (MM_REDUCED_PROMPT,)
        else:
            key, rows, want = "prefix_embeds", cfg.prefix_len, cfg.num_layers
            prompt_lens = MM_REDUCED_VLM_PROMPTS
        emb = rng.normal(size=(2, rows, cfg.d_model)).astype(np.float32)
        batch = {"tokens": torch.as_tensor(
            rng.integers(0, cfg.vocab_size, (2, 96))),
            key: torch.from_numpy(emb)}
        on_card = {n: x.to(dev) for n, x in batch.items()}
        tag = f"(b) reduced {arch}"
        with torch.inference_mode():
            held(f"{tag} forward logits, card against CPU",
                 M.forward(gpu, cfg, on_card)[0],
                 M.forward(cpu, cfg, batch)[0])
            if cfg.is_encdec:
                s_gpu = _fill_cross_memory(cfg, gpu, M.init_serve_state(
                    cfg, 2, 16, enc_len=rows, device=dev), on_card[key])
                s_cpu = _fill_cross_memory(cfg, cpu, M.init_serve_state(
                    cfg, 2, 16, enc_len=rows, device="cpu"), batch[key])
                for name in ("cross_k", "cross_v"):
                    for i, (a, b) in enumerate(zip(s_gpu[name],
                                                   s_cpu[name])):
                        held(f"{tag} {name} of decoder layer {i}", a, b)
            else:
                C = rows + 96
                _, s_gpu = M.prefill_with_state(gpu, cfg, on_card, C)
                _, s_cpu = M.prefill_with_state(cpu, cfg, batch, C)
                for i, (a, b) in enumerate(zip(s_gpu["layers"],
                                               s_cpu["layers"])):
                    held(f"{tag} prefill cache k of layer {i}", a.k, b.k)
                    held(f"{tag} prefill cache v of layer {i}", a.v, b.v)
                    if not torch.equal(a.slot_positions.cpu(),
                                       b.slot_positions):
                        raise AssertionError(f"{tag}: the cache's slots "
                                             "differ")
            del s_gpu, s_cpu
        for S in prompt_lens:
            prompts = rng.integers(0, cfg.vocab_size, (2, S))
            scfg = ServeConfig(max_new_tokens=8, cache_len=rows + S + 8)
            toks_gpu = counted(f"{tag} generate", lambda: Engine(
                cfg, gpu, scfg, extra_batch={key: emb}).generate(prompts),
                want)
            toks_cpu = Engine(cfg, cpu, scfg,
                              extra_batch={key: emb}).generate(prompts)
            same = bool((toks_gpu == toks_cpu).all())
            log(26, f"{tag}, 2 x {S} prompt tokens after {rows} "
                    f"{key.split('_')[0]} rows, 8 new, cache "
                    f"{scfg.cache_len}: card tokens {toks_gpu.tolist()}; "
                    f"equal to the CPU's: {same}; K4 {want} launches")
            if not same:
                raise AssertionError(f"{tag}: the card's greedy tokens "
                                     "differ from the CPU's")
        del gpu, cpu

    # ---- (c) internvl2-1b at full width -------------------------------------
    cfg = get_config("internvl2-1b")
    B, P, S = MM_VLM
    cache = P + S + LM_NEW_TOKENS
    torch.cuda.empty_cache()
    lm = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    n_params = sum(w.numel() for w in lm.parameters())
    prefix = torch.randn((B, P, cfg.d_model), generator=gen, device=dev)
    prompts = np.random.default_rng(26).integers(0, cfg.vocab_size, (B, S))
    tokens = torch.as_tensor(prompts, device=dev)
    batch = {"tokens": tokens, "prefix_embeds": prefix}
    tag = f"(c) internvl2-1b, {B} x ({P} patch rows + {S} tokens)"
    log(26, f"{tag}: {n_params / 1e9:.3f} B parameters drawn on the card "
            f"in fp32 ({n_params * 4 / 1e9:.2f} GB)")
    with torch.inference_mode():
        logits, state = counted(f"{tag} prefill_with_state", lambda:
                                M.prefill_with_state(lm, cfg, batch, cache),
                                cfg.num_layers)
        rows = int((state["layers"][0].slot_positions >= 0).sum())
        if logits.shape != (B, 1, cfg.padded_vocab) or not bool(
                torch.isfinite(logits).all()) or rows != P + S:
            raise AssertionError(f"{tag}: the prefill gave {logits.shape} "
                                 f"logits and {rows} cached rows")
        log(26, f"{tag} prefill_with_state: K4 {cfg.num_layers} launches, no "
                f"other kernel; {rows} cached rows a layer; finite logits")
        del state, logits
        x0, pos, _ = M._embed_inputs(lm, cfg, batch)
        lp = lm.blocks[0]
        h0 = rms_norm(x0, lp.ln1, cfg.norm_eps)
        held(f"{tag} layer 0's attention through K4 against the plain "
             "version", A.gqa_forward(lp.attn, cfg, h0, pos),
             through_plain(lambda: A.gqa_forward(lp.attn, cfg, h0, pos)))
        q0, k0, v0 = A._gqa_project_qkv(lp.attn, cfg, h0, pos)
        worst = max(worst, k4_held(f"{tag} layer 0", q0, k0, v0, True))
    engine = Engine(cfg, lm, ServeConfig(max_new_tokens=LM_NEW_TOKENS,
                                         cache_len=cache),
                    extra_batch={"prefix_embeds": prefix})
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    served = counted(f"{tag} generate", lambda: engine.generate(prompts),
                     cfg.num_layers)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    log(26, f"{tag} generate of {LM_NEW_TOKENS} tokens, cache {cache}: "
            f"{wall:.2f} s wall; K4 {cfg.num_layers} launches (the "
            f"prefill's), none in decode; ids (first 8 of each row) "
            f"{served[:, :8].tolist()}")
    if served.shape != (B, LM_NEW_TOKENS) or not (
            (served >= 0) & (served < cfg.vocab_size)).all():
        raise AssertionError(f"{tag}: generate gave {served.shape} tokens "
                             "outside the vocabulary")
    with torch.inference_mode():
        prefill_t = paired_ms(lambda: M.prefill_with_state(
            lm, cfg, batch, cache), 1, runs=3, warmup=0)
        k4_t = paired_ms(lambda: gqa_flash(q0, k0, v0, causal=True), 1,
                         runs=5, warmup=1)
        k4_share = cfg.num_layers * k4_t[0]
        log(26, f"[{card}] {tag} prefill: {pair(prefill_t)}. K4: "
                f"{cfg.num_layers} launches x {pair(k4_t)} = "
                f"{k4_share:.4f} ms on the device "
                f"({k4_share / prefill_t[0]:.1%} of the prefill); the rest "
                f"{prefill_t[0] - k4_share:.4f} ms")
        _, st = M.prefill_with_state(lm, cfg, batch, cache)
        token = torch.as_tensor(served[:, :1], dtype=torch.long, device=dev)

        def decode_steps():
            for i in range(LM_NEW_TOKENS - 1):   # the engine's positions
                M.decode_step(lm, cfg, token, st, S + i)

        decode_t = paired_ms(decode_steps, LM_NEW_TOKENS - 1, runs=2,
                             warmup=1)
    log(26, f"[{card}] {tag} decode per token (batch {B}, cache {cache}): "
            f"{pair(decode_t)}; reading the fp32 weights once takes "
            f"{n_params * 4 / bw * 1e3:.4f} ms at {bw / 1e12} TB/s; peak "
            f"memory of the generate {peak / 1e9:.2f} GB")
    del lm, engine, st, x0, h0, q0, k0, v0, prefix, tokens, batch
    torch.cuda.empty_cache()

    # ---- (d) seamless-m4t-medium at full width ------------------------------
    cfg = get_config("seamless-m4t-medium")
    B, F_enc, S = MM_ENCDEC
    L, E, Sp = cfg.num_layers, cfg.encoder_layers, MM_ENCDEC_PROMPT
    lm = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    n_params = sum(w.numel() for w in lm.parameters())
    frames = torch.randn((B, F_enc, cfg.d_model), generator=gen, device=dev)
    prompts = np.random.default_rng(26).integers(0, cfg.vocab_size, (B, S))
    tokens = torch.as_tensor(prompts, device=dev)
    batch = {"tokens": tokens, "encoder_embeds": frames}
    tag = f"(d) seamless-m4t-medium, {B} x ({F_enc} frames + {S} tokens)"
    log(26, f"{tag}: {n_params / 1e9:.3f} B parameters drawn on the card "
            f"in fp32 ({n_params * 4 / 1e9:.2f} GB)")
    with torch.inference_mode():
        logits = counted(f"{tag} prefill", lambda: M.prefill(lm, cfg, batch),
                         E + 2 * L)
        if logits.shape != (B, 1, cfg.padded_vocab) or not bool(
                torch.isfinite(logits).all()):
            raise AssertionError(f"{tag}: the prefill gave {logits.shape} "
                                 "logits or values that are not finite")
        log(26, f"{tag} prefill: K4 {E + 2 * L} launches ({E} encoder, {L} "
                f"decoder self, {L} cross), no other kernel; finite logits")
        # encoder layer 0
        pos = torch.arange(F_enc, dtype=torch.int32, device=dev)
        enc0 = lm.encoder[0]
        held(f"{tag} encoder layer 0 through K4 against the plain version",
             blk.block_forward(enc0, cfg, frames, pos, "dense",
                               causal=False)[0],
             through_plain(lambda: blk.block_forward(
                 enc0, cfg, frames, pos, "dense", causal=False)[0]))
        h = rms_norm(frames, enc0.ln1, cfg.norm_eps)
        qe, ke, ve = A._gqa_project_qkv(enc0.attn, cfg, h, pos)
        worst = max(worst, k4_held(f"{tag} encoder layer 0", qe, ke, ve,
                                   False))
        # decoder layer 0: its self attention, then the cross attention
        memory, _ = M.encode(lm, cfg, frames)
        dec0 = lm.decoder[0]
        mk, mv = blk.cross_memory_kv(dec0.cross_attn, memory)
        posd = torch.arange(S, dtype=torch.int32, device=dev)
        x = torch.nn.functional.embedding(tokens, lm.embed)
        h = rms_norm(x, dec0.ln1, cfg.norm_eps)
        qs, ks, vs = A._gqa_project_qkv(dec0.self_attn, cfg, h, posd)
        x = x + A.gqa_forward(dec0.self_attn, cfg, h, posd, window=0)
        hx = rms_norm(x, dec0.ln_x, cfg.norm_eps)
        held(f"{tag} decoder layer 0's cross attention through K4 against "
             "the plain version",
             blk.cross_attend(dec0.cross_attn, cfg, hx, mk, mv),
             through_plain(lambda: blk.cross_attend(dec0.cross_attn, cfg,
                                                    hx, mk, mv)))
        qc = blk._project(hx, dec0.cross_attn.wq)
        worst = max(worst, k4_held(f"{tag} decoder layer 0's cross "
                                   "attention", qc, mk, mv, False))
        del memory, x, h, hx, logits
    engine = Engine(cfg, lm, ServeConfig(max_new_tokens=LM_NEW_TOKENS,
                                         cache_len=Sp + LM_NEW_TOKENS),
                    extra_batch={"encoder_embeds": frames})
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    served = counted(f"{tag} generate", lambda: engine.generate(
        prompts[:, :Sp]), E)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    log(26, f"(d) seamless-m4t-medium generate over {F_enc} frames, "
            f"{Sp}-token prompts, {LM_NEW_TOKENS} new: {wall:.2f} s wall; K4 "
            f"{E} launches (the encoder's), none in the prompt's replay or "
            f"the decode; ids (first 8 of each row) "
            f"{served[:, :8].tolist()}")
    if served.shape != (B, LM_NEW_TOKENS) or not (
            (served >= 0) & (served < cfg.vocab_size)).all():
        raise AssertionError(f"{tag}: generate gave {served.shape} tokens "
                             "outside the vocabulary")
    with torch.inference_mode():
        prefill_t = paired_ms(lambda: M.prefill(lm, cfg, batch), 1, runs=3,
                              warmup=0)
        k4_enc = paired_ms(lambda: gqa_flash(qe, ke, ve, causal=False), 1,
                           runs=5, warmup=1)
        k4_self = paired_ms(lambda: gqa_flash(qs, ks, vs, causal=True), 1,
                            runs=5, warmup=1)
        k4_cross = paired_ms(lambda: gqa_flash(qc, mk, mv, causal=False), 1,
                             runs=5, warmup=1)
        k4_share = E * k4_enc[0] + L * (k4_self[0] + k4_cross[0])
        log(26, f"[{card}] {tag} prefill: {pair(prefill_t)}. K4: {E} "
                f"encoder x {pair(k4_enc)}, {L} self x {pair(k4_self)}, {L} "
                f"cross x {pair(k4_cross)} = {k4_share:.4f} ms on the device "
                f"({k4_share / prefill_t[0]:.1%} of the prefill); the rest "
                f"{prefill_t[0] - k4_share:.4f} ms")
        state0 = M.init_serve_state(cfg, B, Sp + LM_NEW_TOKENS,
                                    enc_len=F_enc, device=dev)
        fill_t = paired_ms(lambda: _fill_cross_memory(cfg, lm, state0,
                                                      frames),
                           1, runs=3, warmup=1)
        _, st, pos0 = engine._prefill_state(tokens[:, :Sp])
        token = torch.as_tensor(served[:, :1], dtype=torch.long, device=dev)

        def decode_steps():
            for i in range(LM_NEW_TOKENS - 1):
                M.decode_step(lm, cfg, token, st, pos0 + i)

        decode_t = paired_ms(decode_steps, LM_NEW_TOKENS - 1, runs=2,
                             warmup=1)
    log(26, f"[{card}] (d) seamless-m4t-medium generate's encoding (the "
            f"encoder and {L} layers' cross k/v over {F_enc} frames): "
            f"{pair(fill_t)}; decode per token (batch {B}, {F_enc} frames "
            f"of cross memory): {pair(decode_t)}; reading the fp32 weights "
            f"once takes {n_params * 4 / bw * 1e3:.4f} ms at "
            f"{bw / 1e12} TB/s; peak memory of the generate "
            f"{peak / 1e9:.2f} GB")
    del lm, engine, st, state0, frames, batch, tokens
    del qe, ke, ve, qs, ks, vs, qc, mk, mv
    torch.cuda.empty_cache()
    log(26, f"[{card}] K4 over (b)-(d)'s counted runs: {launches} launches; "
            f"largest error against its plain version over (a), (c) and "
            f"(d) {worst:.3e}; phase 26 took "
            f"{time.perf_counter() - t_phase:.1f} s")
    return launches, worst


def mm_train_phase(dev, card, reset_counts, counts, *, peaks):
    """Phase 27: internvl2-1b and seamless-m4t-medium trained on the card
    through K4 and K7. (a) K7 against its plain version at MM_K7_SHAPES
    (without the mask, at Sq != Sk both ways, over groups of 7), with K4's
    output and log-sum-exp held there too, the timed shapes with a cold L2
    beside K7's bound, its plain version and SDPA's backward; (b) the
    reduced VLM (14/2 heads) and enc-dec model, allreduce and coke (v=20,
    mu=0.5) at 4 agents, card against CPU from the same weights and stub
    embeddings, held step by step (`card_cpu_hold`), K4 = K7 = agents x
    attentions x (3 steps - 1); (c) both at full width on
    `configs.shapes._token_specs`' train_4k split at B=2, allreduce, AdamW
    lr 3e-3 clip 1.0, 5 steps: step times, peak memory, launches and the
    model flops of `launch.analysis` against the card's fp32 peak. Returns
    (K7's launches and largest error, K4's launches and largest error)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import SHAPES, _token_specs
    from repro_torch.data.tokens import TokenStream, TokenStreamConfig
    from repro_torch.distributed.consensus import ConsensusConfig
    from repro_torch.launch import analysis
    from repro_torch.models import model as M
    from repro_torch.optim.optimizers import OptConfig
    from repro_torch.train.steps import make_train_step

    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(27)
    flush = torch.empty(64 * 2**20, device=dev)      # 256 MB > the L2
    k7_err = k4_err = 0.0
    k4_launches = k7_launches = 0

    def attentions(cfg):
        """Attention calls in one forward: one per layer, or one per
        encoder layer and two (self, cross) per decoder layer."""
        return cfg.encoder_layers + (2 if cfg.is_encdec else 1) * \
            cfg.num_layers

    def batch_data(specs, stream, i, where, embeds):
        """A batch of `specs`' shapes: the stream's tokens and labels of
        step i, the stub embeddings given."""
        toks, labels = stream.batch(i)
        out = {"tokens": torch.as_tensor(toks, device=where),
               "labels": torch.as_tensor(labels, device=where),
               **{k: x.to(where) for k, x in embeds.items()}}
        for k, spec in specs.items():
            if out[k].shape != spec.shape or out[k].dtype != spec.dtype:
                raise AssertionError(f"{k}: {out[k].dtype} "
                                     f"{tuple(out[k].shape)}, the spec "
                                     f"{spec.dtype} {tuple(spec.shape)}")
        return out

    def stub_embeds(specs, g):
        """Seeded normals of each *_embeds spec's shape, on g's device."""
        return {k: torch.randn(spec.shape, generator=g, device=g.device,
                               dtype=spec.dtype)
                for k, spec in specs.items() if k.endswith("_embeds")}

    # ---- (a) K7 and K4's log-sum-exp at the slice's shapes ------------------
    for tag, B, Sq, Sk, H, KV, D, causal, timed in MM_K7_SHAPES:
        _, e7, e4 = k7_hold(27, dev, card, gen, flush, peaks, tag, B, H, KV,
                            Sq, D, 0, timed, Sk=Sk, causal=causal,
                            hold_k4=True)
        k7_err, k4_err = max(k7_err, e7), max(k4_err, e4)
    del flush
    torch.cuda.empty_cache()

    # ---- (b) the reduced pair, card against CPU -----------------------------
    H, KV = MM_TRAIN_VLM_HEADS
    vlm = get_config("internvl2-1b").reduced().with_overrides(
        num_heads=H, num_kv_heads=KV)
    P = vlm.prefix_len
    enc = get_config("seamless-m4t-medium").reduced()
    frames, dec_tokens = MM_TRAIN_ENC
    cpu_gen = torch.Generator().manual_seed(27)
    vlm_specs = _token_specs(vlm, TRAIN_BATCH, P + MM_TRAIN_VLM_TOKENS, True)
    enc_specs = {"encoder_embeds": torch.empty(
        (TRAIN_BATCH, frames, enc.d_model), device="meta")}
    for cfg, specs, text, what in (
            (vlm, vlm_specs, MM_TRAIN_VLM_TOKENS,
             f"internvl2-1b (GQA {H}/{KV} of {vlm.resolved_head_dim}, {P} "
             f"patch rows + {MM_TRAIN_VLM_TOKENS} tokens)"),
            (enc, enc_specs, dec_tokens,
             f"seamless-m4t-medium ({enc.num_heads}/{enc.num_kv_heads} of "
             f"{enc.resolved_head_dim}, {frames} frames + {dec_tokens} "
             f"tokens)")):
        weights = M.param_dict(M.init_params(
            cfg, torch.Generator().manual_seed(0)))
        stream = TokenStream(TokenStreamConfig(
            vocab_size=cfg.vocab_size, seq_len=text,
            global_batch=TRAIN_BATCH, structure=0.9))
        extra = stub_embeds(specs, cpu_gen)
        for strategy, agents in (("allreduce", 1), ("coke", 4)):
            ccfg = (ConsensusConfig(strategy="coke", rho=1e-3,
                                    censor_v=20.0, censor_mu=0.5)
                    if strategy == "coke" else None)
            steps = TRAIN_MOE_MLA_STEPS
            reset_counts()
            h = card_cpu_hold(dev, cfg, weights, stream, ccfg, agents, steps,
                              extra=extra)
            n = agents * attentions(cfg) * (3 * steps - 1)
            seen = {k: v for k, v in counts().items() if v}
            if seen != {"flash_attention": n, "flash_attention_bwd": n}:
                raise AssertionError(f"reduced {cfg.name} {strategy} "
                                     f"launched {seen}, expected K4 = K7 = "
                                     f"{n}")
            text_, ok = hold_line(h, ccfg is not None, tol=TRAIN_MOE_MLA_RTOL)
            log(27, f"(b) reduced {what}, {strategy}, {agents} agent(s), "
                    f"{steps} steps of B={TRAIN_BATCH}: {text_}; K4 and K7 "
                    f"{n} launches each ({agents} x {attentions(cfg)} "
                    f"attentions x {3 * steps - 1} forwards)")
            if not ok:
                raise AssertionError(f"reduced {cfg.name} {strategy} "
                                     "training differs between card and CPU")
            k4_launches += n
            k7_launches += n
        del weights, extra

    # ---- (c) full width, allreduce, one model at a time ---------------------
    opt_cfg = OptConfig(kind="adamw", lr=TRAIN_LR, grad_clip=1.0)
    total = torch.cuda.get_device_properties(dev).total_memory / 1e9
    shape = SHAPES["train_4k"]
    B, S = MM_TRAIN_BATCH, shape.seq_len
    for arch in ("internvl2-1b", "seamless-m4t-medium"):
        cfg = get_config(arch)
        specs = _token_specs(cfg, B, S, with_labels=True)
        n, A = TRAIN_STEPS, attentions(cfg)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        init_fn, step_fn, _ = make_train_step(cfg, opt_cfg)
        state = init_fn(torch.Generator(device=dev).manual_seed(0))
        n_params = sum(x.numel() for x in state["params"].values())
        mflops = analysis.model_flops(
            cfg, "train", B, S,
            analysis.active_params(cfg, M.param_shapes(cfg)))
        stream = TokenStream(TokenStreamConfig(
            vocab_size=cfg.vocab_size, seq_len=specs["tokens"].shape[1],
            global_batch=B))
        embeds = stub_embeds(specs, gen)
        batches = [batch_data(specs, stream, i, dev, embeds)
                   for i in range(n)]
        split = ", ".join(f"{k} {tuple(x.shape)}" for k, x in specs.items())
        state, rows = timed_steps(
            f"(c) {arch}", [step_fn] * n, state, batches,
            {"flash_attention": A * n, "flash_attention_bwd": A * n},
            reset_counts, counts)
        peak = torch.cuda.max_memory_allocated() / 1e9
        del state, batches, embeds
        losses = [r[0]["loss"] for r in rows]
        d_med = statistics.median(r[1] for r in rows[1:])
        h_med = statistics.median(r[2] for r in rows[1:])
        share = mflops / (d_med * 1e-3) / peaks[1]
        depth = (f"{cfg.encoder_layers} encoder + {cfg.num_layers} decoder"
                 if cfg.is_encdec else f"{cfg.num_layers}")
        log(27, f"[{card}] (c) {arch} allreduce at full width, {depth} "
                f"layers (GQA {cfg.num_heads}/{cfg.num_kv_heads} of "
                f"{cfg.resolved_head_dim}): {n_params / 1e9:.3f} B fp32 "
                f"parameters, {4.0 * n_params / 1e9:.2f} GB of the card's "
                f"{total:.1f} GB; {shape.name}'s split of {S} at B={B} (the "
                f"global batch {shape.global_batch} cut for one card): "
                f"{split}; steps 1-{n - 1} median device {d_med:.2f} ms, "
                f"host {h_med:.2f} ms per step; K4 and K7 {A} launches each "
                f"per step; peak memory {peak:.2f} GB; model flops "
                f"{mflops / 1e12:.3f} TFLOP a step (launch/analysis.py), "
                f"{share:.1%} of the card's fp32 peak of "
                f"{peaks[1] / 1e12:g} TFLOP/s; losses "
                f"{[round(x, 6) for x in losses]}")
        k4_launches += A * n
        k7_launches += A * n
        torch.cuda.empty_cache()
    log(27, f"[{card}] K4 and K7 launches over (b) and (c): {k4_launches}, "
            f"{k7_launches}; largest error over (a): K7 {k7_err:.3e}, K4 "
            f"{k4_err:.3e}; phase 27 took "
            f"{time.perf_counter() - t_phase:.1f} s")
    return k7_launches, k7_err, k4_launches, k4_err


def own_attention_hold(dev, cfg, params, i, tokens):
    """Layer 0's attention of agent i (its rows of a blocked parameter
    tree, its (B/N, S) tokens): K4 with the log-sum-exp against its plain
    versions (within K4_TOL), K7 on a seeded dO against its plain version
    (within K7_RTOL of each gradient's max). Returns (K4's largest error,
    K7's largest error, K7's largest relative error, the shape)."""
    from types import SimpleNamespace

    from repro_torch.distributed.sharding import agent_row
    from repro_torch.kernels.flash_attention import flash_attention as k4
    from repro_torch.kernels.flash_attention import flash_attention_bwd as k7
    from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                         attention_lse_ref,
                                                         attention_ref)
    from repro_torch.models.attention import _gqa_project_qkv
    from repro_torch.models.common import rms_norm
    row = lambda name: agent_row(params[name], i)
    t = lambda x: x.transpose(1, 2)
    with torch.no_grad():
        h = rms_norm(torch.nn.functional.embedding(tokens, row("embed")),
                     row("blocks.0.ln1"), cfg.norm_eps)
        attn = SimpleNamespace(**{k: row(f"blocks.0.attn.{k}") for k in (
            "wq", "wk", "wv", "q_norm", "k_norm")})
        pos = torch.arange(tokens.shape[1], dtype=torch.int32, device=dev)
        q, k, v = _gqa_project_qkv(attn, cfg, h, pos)
        B, S, H = q.shape[:3]
        lse = torch.empty((B, H, S), device=dev)
        out = k4.launch(q, k, v, heads_dim=2, causal=True, window=0, lse=lse)
        o_err = float((t(out) - attention_ref(t(q), t(k), t(v),
                                              causal=True)).abs().max())
        l_err = float((lse - attention_lse_ref(t(q), t(k), causal=True))
                      .abs().max())
        do = torch.randn(out.shape, device=dev, generator=torch.Generator(
            device=dev).manual_seed(29))
        got = k7.gqa_flash_bwd(q, k, v, out, do, lse, causal=True)
        want = attention_bwd_ref(t(q), t(k), t(v), t(out), t(do),
                                 causal=True)
        errs = [float((g - t(w)).abs().max()) for g, w in zip(got, want)]
        rel = max(e / float(w.abs().max()) for e, w in zip(errs, want))
    return max(o_err, l_err), max(errs), rel, tuple(q.shape) + (
        k.shape[2],)


def train_rank_cells(dev, yard):
    """What each rank of phase 29 runs, SPMD over the default group: (a)
    each strategy of TRAIN_RANK_STRATEGIES on a (TRAIN_AGENTS, 1) mesh,
    phase 20(c)'s steps timed one by one, K4 and K7 held to N/W x layers a
    step, its own agents' final parameters held against 20(c)'s (`yard`),
    the gathers and peak memory; layer 0's K4 and K7 on its own agent
    against their plain versions; (b) allreduce on a (W, 1) mesh, its
    final parameters' fingerprints. Returns what the parent holds."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding
    from repro_torch.distributed.consensus import ConsensusConfig
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim.optimizers import OptConfig
    from repro_torch.train.steps import make_train_step

    W, N, n = dist.get_world_size(), TRAIN_AGENTS, TRAIN_CONSENSUS_STEPS
    cfg = get_config(LM_ARCH).with_overrides(
        num_layers=TRAIN_CONSENSUS_LAYERS)
    L = cfg.num_layers
    opt_cfg = OptConfig(kind="adamw", lr=TRAIN_LR, grad_clip=1.0)
    stream = train_stream(cfg)
    mesh = make_host_mesh(N, 1, device=dev, group=dist.group.WORLD)
    own = list(sharding.agent_range(mesh, N))
    out = {"own": own, "cells": {}}
    want = {"flash_attention": len(own) * L * n,
            "flash_attention_bwd": len(own) * L * n}
    for strategy in TRAIN_RANK_STRATEGIES:
        local_steps = 2 if strategy == "coke_et" else 1
        ccfg = ConsensusConfig(strategy=strategy, rho=1e-3, censor_v=1.0,
                               censor_mu=0.99, local_steps=local_steps)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        init_fn, step_fn, local_fn = make_train_step(
            cfg, opt_cfg, ccfg, num_agents=N, mesh=mesh)
        state = init_fn(torch.Generator(device=dev).manual_seed(0))
        fns = [local_fn if (i + 1) % local_steps else step_fn
               for i in range(n)]
        batches = [train_batch(stream, i, dev, N) for i in range(n)]
        before = dict(sharding.TRAFFIC)
        state, rows = timed_steps(f"rank {dist.get_rank()} {strategy}", fns,
                                  state, batches, want, reset_counts, counts)
        launches = counts()
        traffic = {k: sharding.TRAFFIC[k] - before[k]
                   for k in ("calls", "bytes")}
        peak = torch.cuda.max_memory_allocated()
        params = state.pop("params")
        del state
        worst = 0.0
        for name, p in params.items():
            for i in own:
                row = sharding.agent_row(p, i).reshape(-1)
                top = float(yard[strategy]["max"][name][i])
                ref = yard[strategy]["sample"][name][i].to(dev)
                e = max(float((row[::TRAIN_RANK_STRIDE] - ref).abs().max()),
                        abs(float(row.abs().max()) - top))
                worst = max(worst, e / max(top, 1e-30))
                del ref
        if strategy == TRAIN_RANK_STRATEGIES[0]:
            out["holds"] = own_attention_hold(dev, cfg, params, own[0],
                                              batches[0]["tokens"][own[0]])
        del params, batches
        torch.cuda.empty_cache()
        out["cells"][strategy] = {
            "rows": rows, "launches": launches, "traffic": traffic,
            "peak": peak, "param_rel": worst,
            "local": [f is local_fn for f in fns]}
    # (b) allreduce over the W ranks, each 1/W of the batch
    amesh = make_host_mesh(W, 1, device=dev, group=dist.group.WORLD)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    init_fn, step_fn, _ = make_train_step(cfg, opt_cfg, mesh=amesh)
    state = init_fn(torch.Generator(device=dev).manual_seed(0))
    before = dict(sharding.TRAFFIC)
    state, rows = timed_steps(
        f"rank {dist.get_rank()} allreduce", [step_fn] * n, state,
        [train_batch(stream, i, dev) for i in range(n)],
        {"flash_attention": L * n, "flash_attention_bwd": L * n},
        reset_counts, counts)
    launches = counts()
    out["allreduce"] = {
        "rows": rows, "launches": launches,
        "fingerprints": {k: fingerprint(x)
                         for k, x in state["params"].items()},
        "peak": torch.cuda.max_memory_allocated(),
        "traffic": {k: sharding.TRAFFIC[k] - before[k]
                    for k in ("calls", "bytes")}}
    del state
    torch.cuda.empty_cache()
    return out


def train_rank_main(rank, world, tmp, device, yard):
    """A rank of phase 29 (spawned; the parent built the kernels): join
    the gloo group of `world` ranks on the card over a FileStore in `tmp`
    (RANK_TIMEOUT_S to every collective), run `train_rank_cells` and save
    what it got there."""
    import datetime

    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    torch.cuda.set_device(dev)
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(Path(tmp) / "store"), world),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
    try:
        t0 = time.perf_counter()
        res = train_rank_cells(dev, yard)
        res["wall"] = time.perf_counter() - t0
        torch.save(res, Path(tmp) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def train_gathers(strategy, local, leaves, admm):
    """The gathers a rank's steps make, by the layer's rules: a consensus
    step fetches the ring once (one gather a leaf: `roll_agents_many`),
    takes consensus_gap's mean over the agents (one a leaf) and max (one),
    and the loss (one); an ADMM step also comms, send_frac and bits (one
    each); a local step the loss only."""
    per = 2 * leaves + 2 + (3 if admm else 0)
    return sum(1 if lo else per for lo in local)


def train_ranks_phase(dev, card, reset_counts, counts):
    """Phase 29: the deep-net trainer with its agents on their own ranks
    of a gloo group, every rank on this card. First, in this process,
    allreduce with microbatches = TRAIN_RANK_WORLD at phase 20(c)'s model
    and batches (its yardstick); then one spawn of TRAIN_RANK_WORLD ranks
    of `train_rank_main`. Each rank: phase 20(c)'s TRAIN_RANK_STRATEGIES on
    a (TRAIN_AGENTS, 1) mesh, one agent a rank, every step's metrics
    bitwise its peers', comms and send_frac equal to 20(c)'s one-process
    run every step, losses within TRAIN_RANK_RTOL relative, its agents'
    parameters within TRAIN_RANK_RTOL of each leaf's largest magnitude
    after the last step; K4 and K7 N/W x layers a step; the gathers a step
    as `train_gathers` counts them; peak memory below 20(c)'s; layer 0's
    K4 and K7 on its own agent against their plain versions; then
    allreduce over the ranks, each 1/W of the batch, its losses bitwise
    the microbatched run's and every parameter leaf's `fingerprint` equal
    to it. Prints per rank and run ms
    a step (wall and device between events), gathers and bytes a step and
    peak memory. Returns the launches summed over the ranks and the
    kernels' largest errors."""
    import torch.multiprocessing as mp
    from repro_torch.configs import get_config
    from repro_torch.optim.optimizers import OptConfig
    from repro_torch.train.steps import make_train_step

    t_phase = time.perf_counter()
    W, N, n = TRAIN_RANK_WORLD, TRAIN_AGENTS, TRAIN_CONSENSUS_STEPS
    missing = [s for s in TRAIN_RANK_STRATEGIES if s not in TRAIN_YARDSTICK]
    if missing:
        raise AssertionError(f"phase 20(c) kept no yardstick for {missing}")
    cfg = get_config(LM_ARCH).with_overrides(
        num_layers=TRAIN_CONSENSUS_LAYERS)
    L = cfg.num_layers
    leaves = len(TRAIN_YARDSTICK[TRAIN_RANK_STRATEGIES[0]]["max"])
    tree_bytes = TRAIN_YARDSTICK[TRAIN_RANK_STRATEGIES[0]]["bytes"]
    stream = train_stream(cfg)
    # (b)'s yardstick: allreduce with microbatches = W, in this process
    torch.cuda.reset_peak_memory_stats()
    init_fn, step_fn, _ = make_train_step(
        cfg, OptConfig(kind="adamw", lr=TRAIN_LR, grad_clip=1.0),
        microbatches=W)
    state = init_fn(torch.Generator(device=dev).manual_seed(0))
    state, ar_rows = timed_steps(
        f"allreduce, microbatches = {W}", [step_fn] * n, state,
        [train_batch(stream, i, dev) for i in range(n)],
        {"flash_attention": W * L * n, "flash_attention_bwd": W * L * n},
        reset_counts, counts)
    ar_peak = torch.cuda.max_memory_allocated() / 1e9
    ar_prints = {k: fingerprint(x) for k, x in state["params"].items()}
    del state
    gc.collect()
    torch.cuda.empty_cache()
    log(29, f"[{card}] one process, allreduce at microbatches = {W} "
            f"({LM_ARCH} at full width, {L} layers, B={TRAIN_BATCH}, "
            f"S={TRAIN_SEQ}): losses {[r[0]['loss'] for r in ar_rows]}; "
            f"device {statistics.median(r[1] for r in ar_rows[1:]):.2f} ms, "
            f"host {statistics.median(r[2] for r in ar_rows[1:]):.2f} ms a "
            f"step; peak {ar_peak:.2f} GB; "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB still "
            "allocated here before the spawn")
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="phase29-", dir=ROOT / "build")
    try:
        t0 = time.perf_counter()
        mp.start_processes(train_rank_main, args=(
            W, tmp, str(dev), TRAIN_YARDSTICK), nprocs=W, join=True,
            start_method="spawn")
        spawn_s = time.perf_counter() - t0
        ranks = [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False)
                 for r in range(W)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(29, f"[{card}] W = {W} ranks on {dev} over gloo, one agent a rank "
            f"(mesh ({N}, 1)): spawned, ran and joined in {spawn_s:.1f} s")
    seen = {k: 0 for k in LAUNCH_COUNTERS}
    metric = lambda rows: [r[0] for r in rows]
    for strategy in TRAIN_RANK_STRATEGIES:
        yard = TRAIN_YARDSTICK[strategy]
        cells = [r["cells"][strategy] for r in ranks]
        for r, c in enumerate(cells[1:], 1):
            if metric(c["rows"]) != metric(cells[0]["rows"]):
                raise AssertionError(f"{strategy}: rank {r}'s metrics are "
                                     "not rank 0's")
        got, ref = metric(cells[0]["rows"]), metric(yard["rows"])
        same = all(g.get(k) == w.get(k) for g, w in zip(got, ref)
                   for k in ("comms", "send_frac"))
        bits = all(g == w for g, w in zip(got, ref))
        rel = max(abs(g["loss"] - w["loss"]) / abs(w["loss"])
                  for g, w in zip(got, ref))
        gap = max((abs(g["consensus_gap"] - w["consensus_gap"])
                   / abs(w["consensus_gap"]) for g, w in zip(got, ref)
                   if "consensus_gap" in w), default=0.0)
        worst = max(c["param_rel"] for c in cells)
        gathers = train_gathers(strategy, cells[0]["local"], leaves,
                                strategy != "cta")
        log(29, f"[{card}] {strategy}: every rank's metrics bitwise its "
                f"peer's; against phase 20(c)'s one process: comms and "
                f"send_frac equal every step: {same}; every metric bitwise: "
                f"{bits}; loss max relative difference {rel:.3e}, "
                f"consensus_gap {gap:.3e}; each rank's agent: each leaf's "
                f"largest magnitude and one element in {TRAIN_RANK_STRIDE} "
                f"within {worst:.3e} of that magnitude (tol "
                f"{TRAIN_RANK_RTOL:g}); losses {[g['loss'] for g in got]}, "
                f"comms {[int(g['comms']) for g in got if 'comms' in g]}")
        if not (same and rel <= TRAIN_RANK_RTOL
                and worst <= TRAIN_RANK_RTOL):
            raise AssertionError(f"{strategy} across ranks differs from "
                                 "phase 20(c)'s one-process run")
        d_one = statistics.median(r[1] for r in yard["rows"][1:])
        h_one = statistics.median(r[2] for r in yard["rows"][1:])
        for r, c in enumerate(cells):
            tr = c["traffic"]
            if tr["calls"] != gathers:
                raise AssertionError(f"{strategy}: rank {r} made "
                                     f"{tr['calls']} gathers, the layer's "
                                     f"rules {gathers}")
            if not c["peak"] / 1e9 < yard["peak"]:
                raise AssertionError(f"{strategy}: rank {r}'s peak "
                                     f"{c['peak'] / 1e9:.2f} GB is not below "
                                     f"one process's {yard['peak']:.2f} GB")
            for k, v in c["launches"].items():
                seen[k] += v
            log(29, f"[{card}]   rank {r} (agents {ranks[r]['own']}): "
                    f"wall {statistics.median(x[2] for x in c['rows'][1:]):.2f}"
                    f" ms, device {statistics.median(x[1] for x in c['rows'][1:]):.2f}"
                    f" ms a step (steps 1-{n - 1}, median; one process "
                    f"{h_one:.2f} / {d_one:.2f}); {tr['calls'] / n:.1f} "
                    f"gathers a step ({gathers} over the run by the layer's "
                    f"rules), {tr['bytes'] / n / 1e9:.3f} GB a step into the "
                    f"rank (its agent's tree {tree_bytes / 1e9:.3f} GB); "
                    f"K4 {c['launches']['flash_attention']}, K7 "
                    f"{c['launches']['flash_attention_bwd']} ({len(ranks[r]['own'])}"
                    f" x {L} x {n}); peak {c['peak'] / 1e9:.2f} GB (one "
                    f"process {yard['peak']:.2f} GB)")
    ar = [r["allreduce"] for r in ranks]
    ar_losses = [r[0]["loss"] for r in ar_rows]
    for r, a in enumerate(ar):
        if [x[0] for x in a["rows"]] != [x[0] for x in ar_rows] \
                or a["fingerprints"] != ar_prints:
            raise AssertionError(f"allreduce: rank {r}'s losses or "
                                 "parameters are not bitwise the one-process "
                                 f"microbatches = {W} run's")
        for k, v in a["launches"].items():
            seen[k] += v
        log(29, f"[{card}] allreduce rank {r}: losses and every parameter "
                f"leaf's fingerprint equal to the one-process microbatches "
                f"= {W} run's "
                f"({ar_losses}); wall "
                f"{statistics.median(x[2] for x in a['rows'][1:]):.2f} ms, "
                f"device {statistics.median(x[1] for x in a['rows'][1:]):.2f}"
                f" ms a step; {a['traffic']['calls'] / n:.1f} gathers, "
                f"{a['traffic']['bytes'] / n / 1e9:.3f} GB a step; K4 "
                f"{a['launches']['flash_attention']}, K7 "
                f"{a['launches']['flash_attention_bwd']}; peak "
                f"{a['peak'] / 1e9:.2f} GB (one process {ar_peak:.2f} GB)")
    errs = {"flash_attention": 0.0, "flash_attention_bwd": 0.0}
    for r, res in enumerate(ranks):
        k4_err, k7_err, k7_rel, shape = res["holds"]
        log(29, f"[{card}] rank {r}: layer 0's attention of agent "
                f"{res['own'][0]} (q {shape[:4]}, KV {shape[4]}): K4 output "
                f"and log-sum-exp max|err| {k4_err:.3e} (tol "
                f"{K4_TOL[torch.float32]:g}), K7 max|err| {k7_err:.3e}, "
                f"{k7_rel:.3e} of each gradient's max (tol {K7_RTOL:g}); "
                f"wall {res['wall']:.1f} s")
        if not (k4_err <= K4_TOL[torch.float32] and k7_rel <= K7_RTOL):
            raise AssertionError(f"rank {r}: K4 or K7 disagrees with its "
                                 "plain version on its own agent")
        errs["flash_attention"] = max(errs["flash_attention"], k4_err)
        errs["flash_attention_bwd"] = max(errs["flash_attention_bwd"],
                                          k7_err)
    got = {k: v for k, v in seen.items() if v}
    want = {k: W * N // W * L * n * len(TRAIN_RANK_STRATEGIES) + W * L * n
            for k in ("flash_attention", "flash_attention_bwd")}
    if got != want:
        raise AssertionError(f"phase 29's ranks launched {got}, expected "
                             f"{want}")
    log(29, f"[{card}] launches over phase 29's ranks: {got}; phase 29 "
            f"took {time.perf_counter() - t_phase:.1f} s")
    return seen, errs


def phase29_alone() -> int:
    """Phase 29 alone: build the kernels, run phase 20(c)'s yardstick
    strategies (`train_phase`'s (c), TRAIN_RANK_STRATEGIES only), then
    `train_ranks_phase`; prints its launch counts and errors."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    build.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(29, f"[{card}] built the kernels in {time.perf_counter() - t0:.1f} s")
    consensus_runs(dev, card, reset_counts, counts, TRAIN_RANK_STRATEGIES)
    seen, errs = train_ranks_phase(dev, card, reset_counts, counts)
    print(card)
    print(json.dumps({"launches": seen, "max_abs_err": errs}))
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs the port on a CUDA card", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script; run "
              "it from a checkout of the repo", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    t_script = time.perf_counter()

    from repro_torch.api import (FitConfig, KRRConfig, build_problem, fit,
                                 get_solver, make_problem)
    from repro_torch.api.backends import _local_grads, consensus_runner
    from repro_torch.api.config import SolveContext
    from repro_torch.api.solvers import _stacked_metrics
    from repro_torch.core import prng
    from repro_torch.core.graph import ring
    from repro_torch.kernels import build
    from repro_torch.kernels.coke_update import coke_update as k2
    from repro_torch.kernels.coke_update.ref import (coke_megastep_ref,
                                                     coke_update_ref,
                                                     xi_sq_in_kernel_order)
    from repro_torch.kernels.flash_attention import flash_attention as k4
    from repro_torch.kernels.flash_attention.ops import gqa_flash
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.rff import rff as k1
    from repro_torch.kernels.rff.ref import rff_ref
    from repro_torch.kernels.threefry import threefry as k5
    from repro_torch.kernels.threefry.ref import (random_bits_ref,
                                                  uniform_ref)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    # K1's predict shape: every agent's held-out rows (30 000 at full size)
    predict_rows = N_AGENTS * (SAMPLES - int(SAMPLES * 0.7))

    # ---- 0. device -------------------------------------------------------
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    card = smi
    peaks = card_peaks(name)
    bw, fp32, bf16_peak, tf32_peak = peaks
    log(0, f"device {name} (count {torch.cuda.device_count()}), torch "
           f"{torch.__version__}, CUDA {torch.version.cuda}")
    log(0, f"nvidia-smi: {smi}; peaks used for bounds: {bw / 1e12} TB/s, "
           f"{fp32 / 1e12} TFLOP/s fp32, {bf16_peak / 1e12} TFLOP/s bf16, "
           f"{tf32_peak / 1e12} TFLOP/s TF32")

    # ---- 1. build --------------------------------------------------------
    t0 = time.perf_counter()
    report = build.build()
    log(1, f"built {sorted(report)} in {time.perf_counter() - t0:.1f} s "
           f"into {build.BUILD_DIR.relative_to(ROOT)}")
    for src, r in sorted(report.items()):
        if src in ("coke_megastep", "rff", "coke_fused_update",
                   "flash_attention_bwd"):
            # per instance: K1 and K7 below, K3 in phase 2, K2 in phase 7
            continue
        for line in r["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(1, f"  {src}: {line.strip()}")
    for fn, props in ptxas_report(report["rff"]["log"]).items():
        log(1, f"  rff {fn}: {props}")
    for shape in ((predict_rows, 5, FEATURES),
                  (predict_rows, 96, FEATURES)):
        out = torch.empty(shape[0], shape[2], device=dev)
        plan = k1.rff_device_plan(*shape, out)
        log(1, f"K1 plan (M, d, L)={shape}: {plan.instance} instance, "
               f"{plan.strips} strip(s) of {plan.strip} columns, "
               f"{plan.tiles} row tiles of {plan.rows} rows, "
               f"{plan.buffers} output tiles in shared memory, "
               f"{plan.smem_bytes} B of shared memory, {plan.blocks} "
               f"blocks; omega and bias slices "
               f"{4 * (shape[1] + 1) * plan.strip} B")
        del out
    try:
        tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
        k1_sass = k1_sass_counts(subprocess.run(
            [tool, "-sass", str(build.library_path("rff"))],
            capture_output=True, text=True, check=True, timeout=300).stdout)
    except Exception as exc:    # a diagnostic: a layout it misreads
        k1_sass = f"not read ({exc!r})"
    log(1, f"K1 SASS (cuobjdump -sass, bulk instance): {k1_sass}")
    try:
        tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
        k5_ops, k5_sass = k5_sass_counts(subprocess.run(
            [tool, "-sass", str(build.library_path("threefry"))],
            capture_output=True, text=True, check=True, timeout=300).stdout)
    except Exception as exc:    # a diagnostic: a layout it misreads
        k5_ops, k5_sass = None, f"not read ({exc!r})"
    log(1, f"K5 SASS (cuobjdump -sass, uniform instance): {k5_sass}")
    hmma = hmma_count(build.library_path("flash_attention"))
    log(1, f"flash_attention SASS tensor-core instructions (cuobjdump "
           f"-sass): {hmma}")
    if not all(hmma.get(kind, 0) > 0 for kind in K4_HMMA):
        raise AssertionError(f"the flash_attention library lacks one of "
                             f"{K4_HMMA} (found {hmma}): K4 does not run on "
                             "the tensor cores")
    for dh, dv, dtype in ((128, 128, torch.float32),
                          (128, 128, torch.bfloat16),
                          (256, 256, torch.float32)):
        bq, bk, stages, smem, blocks = k4_plan(build, dh, dv, dtype)
        log(1, f"K4 plan Dh={dh} Dv={dv} {str(dtype).split('.')[-1]}: "
               f"{bq}-row query tiles, {bk}-key tiles in {stages} cp.async "
               f"stages, {smem} B of shared memory, {blocks} block(s) per "
               "SM")
    k7_phase1(build)

    # ---- 2. kernels against their plain versions -------------------------
    gen = torch.Generator(device=dev).manual_seed(11)
    errs = {k: 0.0 for k in KERNEL_SOURCES}

    def rff_case(M, d, L, main=False):
        x = torch.rand((M, d), generator=gen, device=dev)
        omega = torch.randn((d, L), generator=gen, device=dev)
        bias = torch.rand((L,), generator=gen, device=dev) * (2 * math.pi)
        got = k1.rff_cos_bias(x, omega, bias)
        want = rff_ref(x, omega, bias)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        tol = k1_tolerance(x, omega)
        instance = k1.rff_staging(L, got)
        log(2, f"K1 rff_cos_bias M={M} d={d} L={L} ({instance}): max|err| "
               f"{err:.3e} (tol {tol:.3e})")
        if not err <= tol:
            raise AssertionError(f"K1 disagrees with its plain version at "
                                 f"M={M} d={d} L={L}: {err} > {tol}")
        if main:
            errs["rff_cos_bias"] = err
        return x, omega, bias, instance

    k1_inputs = rff_case(predict_rows, 5, FEATURES, main=True)
    instances = {k1_inputs[3]}
    for M, d, L in ((1001, 13, 100), (1001, 13, 513), (1001, 77, 100),
                    (1001, 77, 513), (1001, 96, 100), (1001, 96, 513),
                    (1001, 5, 513), (1, 5, FEATURES), (1001, 96, FEATURES),
                    (257, 5, FEATURES + 4), (1000, 96, 253)):
        instances.add(rff_case(M, d, L)[3])
    if instances != {"bulk", "4-byte"}:
        raise AssertionError(f"phase 2 ran K1's instances {instances}, "
                             "not both")
    again = k1.rff_cos_bias(*k1_inputs[:3])
    if not torch.equal(again, k1.rff_cos_bias(*k1_inputs[:3])):
        raise AssertionError("two K1 calls on the same inputs differ")
    del again
    bad, first_bad = k1.rff_cos_mismatches(dev)
    log(2, f"K1's cosine against cosf on all 2^32 fp32 values: {bad} "
           "differ; two calls at the predict shape give the same bits")
    if bad:
        raise AssertionError(f"K1's cosine differs from cosf on {bad} "
                             f"values, first 0x{first_bad:08x}")

    def mega_case(n, t, d, offsets, main=False, misalign=False):
        theta = torch.randn((n, d), generator=gen, device=dev)
        hat = torch.randn((n, d), generator=gen, device=dev)
        gamma = 0.1 * torch.randn((n, d), generator=gen, device=dev)
        # bounded features shaped like sqrt(2/D) cos(.), labels in [0, 1)
        # misaligned: a view 4 bytes off 16-byte alignment
        u = torch.rand(n * t * d + int(misalign), generator=gen,
                       device=dev)
        phi = u[int(misalign):].view(n, t, d)
        phi.copy_(math.sqrt(2.0 / d) * torch.cos(2 * math.pi * phi))
        y = torch.rand((n, t), generator=gen, device=dev)
        kw = dict(rho=1e-2, lam=5e-5, lr=0.1, offsets=offsets)
        want = coke_megastep_ref(theta, hat, gamma, phi, y,
                                 return_resid_sq=True, **kw)
        rsq = torch.empty((n,), device=dev)
        got = k2.coke_megastep(theta.clone(), hat, gamma, phi, y,
                               resid_sq=rsq, **kw) + (rsq,)
        torch.cuda.synchronize()
        errs_here = [float((o - w).abs().max()) for o, w in zip(got, want)]
        tols = [K2_RTOL * float(w.abs().max()) for w in want]
        plan = k2.megastep_plan(phi)
        log(2, f"K2 coke_megastep N={n} T={t} D={d} offsets={offsets} "
               f"[{k2.megastep_staging(phi)}, {plan.rows_per_stage} rows x "
               f"{plan.stages} stages, grid {plan.segments.grid}, "
               f"{plan.segments.num_segments} segments]: max|err| theta' "
               f"{errs_here[0]:.3e} (tol {tols[0]:.3e})")
        log(2, f"  and its sums at that shape: max|err| xi_sq "
               f"{errs_here[1]:.3e} (tol {tols[1]:.3e}), resid_sq "
               f"{errs_here[2]:.3e} (tol {tols[2]:.3e})")
        if not all(e <= tol for e, tol in zip(errs_here, tols)):
            raise AssertionError(f"K2 disagrees with its plain version at "
                                 f"N={n} T={t} D={d} offsets={offsets}")
        if main:
            # the kernels line's max_abs_err is theta''s error
            errs["coke_megastep"] = errs_here[0]
        return theta, hat, gamma, phi, y, kw

    k2_inputs = mega_case(N_AGENTS, int(SAMPLES * 0.7), FEATURES, (1,),
                          main=True)
    k2_staged = {k2.megastep_staging(k2_inputs[3])}
    for n, t, d, offsets, mis in (
            (20, 3500, 4096, (1,), True),     # the main shape, cp.async
            (4, 40, 32, (1,), False), (2, 33, 513, (1,), False),
            (8, 64, 100, (1, 2), False), (3, 17, 128, (1,), False),
            (5, 128, 256, (2,), False),
            (7, 1000, 256, (1,), False),      # ranges cross agents
            (200, 5, 64, (1, 3), False),      # N above the SM count
            (6, 1, 128, (1,), False),         # T = 1
            (3, 8, 16384, (1,), False),       # the widest instance
            (2, 5, 19370, (1,), False),       # earlier widest D, unaligned
            (4, 50, 1001, (1,), False)):
        phi = mega_case(n, t, d, offsets, misalign=mis)[3]
        k2_staged.add(k2.megastep_staging(phi))
    if k2_staged != {"bulk", "cp.async"}:
        raise AssertionError(f"K2's cases took only {k2_staged}")
    # no floating-point atomics: a second call gives the same bits
    theta2, hat2, gamma2, phi2, y2, kw2 = k2_inputs
    runs = []
    for _ in range(2):
        rsq = torch.empty((N_AGENTS,), device=dev)
        runs.append(k2.coke_megastep(theta2.clone(), hat2, gamma2, phi2, y2,
                                     resid_sq=rsq, **kw2) + (rsq,))
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(*runs)):
        raise AssertionError("two K2 calls on the same inputs differ")
    log(2, "K2: two calls at the main shape give bitwise-equal theta', xi_sq "
           "and resid_sq")

    for fn, props in ptxas_report(report["coke_fused_update"]["log"]).items():
        log(2, f"  K3 ptxas {fn}: {props or 'no report'}")

    def update_case(n, d, deg, main=False, aliased=False, misalign=False):
        # theta, theta_hat, gamma, grad, left, right at the scale of a fit;
        # aliased: one tensor as both neighbour operands, as the fused
        # fallback passes them; misaligned: views 4 bytes off 16
        ops = []
        for _ in range(6):
            u = torch.randn(n * d + int(misalign), generator=gen, device=dev)
            ops.append(0.1 * u[int(misalign):].view(n, d))
        if aliased:
            ops[5] = ops[4]
        kw = dict(rho=1e-2, deg=deg)
        want, want_xi = coke_update_ref(*ops, **kw)
        plan, vec, shared = k2.fused_update_launch(ops)
        if shared != aliased:
            raise AssertionError(f"K3 took the {'one' if shared else 'two'}-"
                                 f"read instance for aliased={aliased}")
        before = k2.FUSED_UPDATE_LAUNCHES
        got, got_xi = k2.coke_fused_update(*ops, **kw)
        again = k2.coke_fused_update(*ops, **kw)
        torch.cuda.synchronize()
        if k2.FUSED_UPDATE_LAUNCHES != before + 2:
            raise AssertionError("K3 did not launch exactly once per call")
        e_g = float((got - want).abs().max())
        e_xi = float((got_xi - want_xi).abs().max())
        tol_g = k3_tolerance(*ops, **kw)
        tol_xi = K3_XI_RTOL * float(want_xi.abs().max())
        order = xi_sq_in_kernel_order(ops[0].cpu(), ops[1].cpu(), plan,
                                      vec=vec)
        in_order = torch.equal(got_xi.cpu(), order)
        twice = torch.equal(got, again[0]) and torch.equal(got_xi, again[1])
        log(2, f"K3 coke_fused_update N={n} D={d} deg={deg:g} "
               f"[{'16-byte' if vec else '4-byte'}, "
               f"{'one neighbour read' if shared else 'two neighbour reads'};"
               f" plan C={plan.clusters} threads={plan.threads} "
               f"U={plan.unroll} slice={plan.slice} grid={plan.grid}]: g_aug "
               f"max|err| {e_g:.3e} (tol {tol_g:.3e}, 4 ulps of the largest "
               f"term), xi_sq max|err| {e_xi:.3e} (tol {tol_xi:.3e}, rtol "
               f"{K3_XI_RTOL:g}); xi_sq bitwise its order's CPU emulation: "
               f"{in_order}; two calls bitwise equal: {twice}")
        if not (e_g <= tol_g and e_xi <= tol_xi):
            raise AssertionError(f"K3 disagrees with its plain version at "
                                 f"N={n} D={d} deg={deg}")
        if not (in_order and twice):
            raise AssertionError(f"K3's xi_sq at N={n} D={d} is not its "
                                 "order's bits, or two calls differ")
        if main:
            errs["coke_fused_update"] = e_g
        return ops, kw

    # the path's call: N=20, D=4096, one tensor as both neighbours
    k3_inputs = update_case(N_AGENTS, FEATURES, 2.0, main=True, aliased=True)
    distinct = [t.clone() for t in k3_inputs[0]]
    if not all(torch.equal(a, b) for a, b in zip(
            k2.coke_fused_update(*k3_inputs[0], **k3_inputs[1]),
            k2.coke_fused_update(*distinct, **k3_inputs[1]))):
        raise AssertionError("K3 with one neighbour read differs from the "
                             "same values in two tensors")
    log(2, "K3 at the path's shape: one neighbour read gives the bits of "
           "the same values in two distinct tensors")
    del distinct
    for n, d, deg, aliased, mis in (
            (N_AGENTS, FEATURES, 2.0, False, False),
            (N_AGENTS, FEATURES, 2.0, True, True),
            (N_AGENTS, 65536, 2.0, True, False),       # the streaming shape
            (N_AGENTS, 65536, 2.0, False, False),
            (N_AGENTS, 4099, 2.0, True, False),        # ragged, 8 blocks
            (1, 8192, 4.0, False, False),              # N = 1
            (200, 1024, 2.0, True, False),             # N above the SMs
            (1, 1, 2.0, False, False), (3, 513, 2.0, False, False),
            (7, 1000, 2.0, True, False), (1, 1, 4.0, True, False),
            (3, 513, 4.0, False, True), (7, 1000, 4.0, False, False)):
        update_case(n, d, deg, aliased=aliased, misalign=mis)

    def attention_cases():
        """K4 against its plain version over lengths (Sq = Sk, and not),
        masks, head groups, both layouts, head dims and dtypes."""
        worst = {}
        for sq, sk in ((100, 100), (257, 257), (1024, 1024), (300, 700),
                       (700, 300)):
            for dh, dv in ((64, 64), (128, 128), (192, 128)):
                for dtype in (torch.float32, torch.bfloat16):
                    errs_here = []
                    for kv in (8, 4, 2):          # H / KV = 1, 2, 4
                        q = torch.randn((2, 8, sq, dh), generator=gen,
                                        device=dev).to(dtype)
                        k = torch.randn((2, kv, sk, dh), generator=gen,
                                        device=dev).to(dtype)
                        v = torch.randn((2, kv, sk, dv), generator=gen,
                                        device=dev).to(dtype)
                        for causal in (True, False):
                            for window in (0, 32):
                                want = attention_ref(q, k, v, causal=causal,
                                                     window=window)
                                a = k4.flash_attention(q, k, v, causal=causal,
                                                       window=window)
                                b = gqa_flash(q.transpose(1, 2),
                                              k.transpose(1, 2),
                                              v.transpose(1, 2),
                                              causal=causal, window=window)
                                torch.cuda.synchronize()
                                for got in (a, b.transpose(1, 2)):
                                    errs_here.append(float(
                                        (got.float() - want.float()).abs()
                                        .max()))
                    err, tol = max(errs_here), K4_TOL[dtype]
                    key = str(dtype).split(".")[-1]
                    worst[key] = max(worst.get(key, 0.0), err)
                    log(2, f"K4 flash_attention Sq={sq} Sk={sk} Dh={dh} "
                           f"Dv={dv} {key}: H/KV 1, 2, 4 x causal x window "
                           f"0, 32 x both layouts ({len(errs_here)} calls): "
                           f"max|err| {err:.3e} (tol {tol:g})")
                    if not err <= tol:
                        raise AssertionError(
                            f"K4 disagrees with its plain version at Sq={sq} "
                            f"Sk={sk} Dh={dh} Dv={dv} {key}: {err} > {tol}")
        return worst

    k4_worst = attention_cases()
    log(2, f"K4 worst error over the sweep: {k4_worst}")

    def threefry_case(key, n):
        """K5 against its plain version on the card, uniform floats and
        random_bits words, one launch each; bitwise."""
        before = k5.LAUNCHES
        u = k5.threefry_draw(key, (n,), dev, uniform=True)
        bits = k5.threefry_draw(key, (n,), dev, uniform=False)
        torch.cuda.synchronize()
        if k5.LAUNCHES - before != 2:
            raise AssertionError(f"K5 made {k5.LAUNCHES - before} launches "
                                 "for two draws")
        shape = (n,)
        same = (torch.equal(u.view(torch.int32),
                            uniform_ref(key, shape, dev).view(torch.int32))
                and torch.equal(bits, random_bits_ref(key, shape, dev)))
        if not same:
            raise AssertionError(f"K5 differs from its plain version at "
                                 f"n={n}, key {key}")

    for n in K5_SIZES:
        threefry_case(prng.fold_in(prng.PRNGKey(n), 2**32 - 1), n)
        lanes = torch.tensor([prng.fold_in(prng.PRNGKey(n), g)
                              for g in range(K5_LANES)], dtype=torch.int64,
                             device=dev)
        threefry_case(lanes, n)
    for seed, folds, shape, key_want, bits_want in JAX_PRNG_PINS:
        key = prng.PRNGKey(seed)
        for f in folds:
            key = prng.fold_in(key, f)
        flat = k5.threefry_draw(key, shape, dev, uniform=False).reshape(-1)
        if key != key_want or {i: int(flat[i]) for i in bits_want} \
                != bits_want:
            raise AssertionError(f"K5 misses jax's pinned words under seed "
                                 f"{seed}")
    errs["threefry"] = 0.0
    log(2, f"K5 threefry at n={list(K5_SIZES)}, one key and {K5_LANES} "
           f"keys: uniform and random_bits bitwise the plain version (one "
           f"launch per draw); jax's pinned words (JAX_PRNG_PINS) equal")

    # ---- 3. small fits, card against CPU ----------------------------------
    small = FitConfig(krr=KRRConfig(num_agents=4, samples_per_agent=40,
                                    num_features=32, lam=1e-2, rho=0.1),
                      graph="ring", censor_v=0.3, censor_mu=0.97,
                      num_iters=40, primal="gradient", inner_lr=0.05,
                      cta_lr=0.05, backend="fused")
    small_built = build_problem(small, device="cpu")
    small_logistic = dataclasses.replace(
        small_built.problem, loss="logistic", labels=torch.where(
            small_built.problem.labels > small_built.problem.labels.median(),
            1.0, -1.0))
    small_cases = [("fused", alg, small_built.problem, small)
                   for alg in ("coke", "dkla")]
    small_cases += [("spmd", alg, small_built.problem, small)
                    for alg in ("coke", "dkla", "cta")]
    # a threshold under which COKE sends some broadcasts on this loss
    small_cases += [("fused", alg, small_logistic,
                     small.replace(censor_v=0.03, censor_mu=0.8))
                    for alg in ("coke", "dkla")]
    for backend, alg, prob, base in small_cases:
        cfg = base.replace(algorithm=alg, backend=backend)
        if alg == "cta":
            cfg = cfg.replace(censor_v=None, censor_mu=None)
        cpu = fit(cfg, problem=prob, device="cpu")
        gpu = fit(cfg, problem=prob, device=dev)
        for k in ("comms", "bits"):
            if not torch.equal(gpu.history[k].cpu(), cpu.history[k]):
                raise AssertionError(f"small {backend} {alg} {prob.loss} fit:"
                                     f" {k} differs between card and CPU")
        e = float((gpu.theta.cpu() - cpu.theta).abs().max())
        e_mse = float((gpu.train_mse.cpu() - cpu.train_mse).abs().max())
        log(3, f"small {backend} {alg} fit ({prob.loss}) N=4 T=28 D=32, card "
               f"vs CPU: comms/bits equal ({int(cpu.comms[-1])} "
               f"transmissions), theta max|err| {e:.3e}, train_mse max|err| "
               f"{e_mse:.3e} (tol 1e-5)")
        if not (e <= 1e-5 and e_mse <= 1e-5):
            raise AssertionError(f"small {backend} {alg} fit differs on the "
                                 "card")

    # ---- 4. the megakernel path at full width -----------------------------
    cfg = full_width_config()
    krr = cfg.krr
    t0 = time.perf_counter()
    built = build_problem(cfg, device=dev)
    torch.cuda.synchronize()
    problem = built.problem
    N, T, D = problem.feats.shape
    log(4, f"build_problem: feats {tuple(problem.feats.shape)} "
           f"({problem.feats.numel() * 4 / 1e9:.3f} GB), x_test "
           f"{tuple(built.x_test.shape)}, {time.perf_counter() - t0:.1f} s")

    # the megakernel path reads Phi in K2 once per iteration, and once more
    # per chunk for the last iteration's train MSE (backends.residual_sq)
    from repro_torch.api import backends as backends_mod
    metric_reads = [0]
    real_residual_sq = backends_mod.residual_sq

    def counted_residual_sq(*a, **k):
        metric_reads[0] += 1
        return real_residual_sq(*a, **k)

    backends_mod.residual_sq = counted_residual_sq
    reset_counts()
    results = {}
    for alg in ("coke", "dkla"):
        before2 = k2.LAUNCHES
        reads_before = metric_reads[0]
        t0 = time.perf_counter()
        res = fit(cfg.replace(algorithm=alg), problem=problem, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rose = k2.LAUNCHES - before2
        if rose != k2.LAUNCHES_PER_CALL * ITERS:
            raise AssertionError(f"{alg}: K2 launched {rose} times in "
                                 f"{ITERS} iterations")
        reads = metric_reads[0] - reads_before
        if reads != 1:       # one chunk: chunk_size is None
            raise AssertionError(f"{alg}: the train MSE read Phi {reads} "
                                 "times outside K2 in one chunk")
        log(4, f"{alg}: Phi reads {ITERS} in K2 (one per iteration) + "
               f"{reads} for the train MSE (one per chunk)")
        h = {k: v.cpu() for k, v in res.history.items()}
        check_history(alg, h, ITERS)
        if not h["train_mse"][-1] < h["train_mse"][0]:
            raise AssertionError(f"{alg}: train_mse did not fall")
        comms = int(h["comms"][-1])
        if alg == "dkla" and comms != N * ITERS:
            raise AssertionError(f"dkla sent {comms} != {N * ITERS}")
        if alg == "coke" and comms > N * ITERS:
            raise AssertionError(f"coke sent {comms} > {N * ITERS}")

        model = res.to_model(built.rff_params)
        before1 = k1.LAUNCHES
        preds = model.predict(built.x_test, backend="fused")
        torch.cuda.synchronize()
        if not k1.LAUNCHES > before1:
            raise AssertionError(f"{alg}: predict did not launch K1")
        ev = model.evaluate(built.x_test, built.y_test, backend="fused")
        ev_ref = model.evaluate(built.x_test, built.y_test, backend="ref")
        if preds.shape != built.y_test.shape or not torch.isfinite(
                preds).all():
            raise AssertionError(f"{alg}: predictions are not finite "
                                 f"{tuple(built.y_test.shape)}")
        if not math.isclose(ev["test_mse"], ev_ref["test_mse"], rel_tol=1e-4):
            raise AssertionError(f"{alg}: fused and ref test MSE differ: "
                                 f"{ev['test_mse']} vs {ev_ref['test_mse']}")
        log(4, f"{alg}: {ITERS} iterations in {wall:.2f} s wall (first "
               f"call); train_mse {float(h['train_mse'][0]):.5f} -> "
               f"{float(h['train_mse'][-1]):.5f}, comms {comms}/"
               f"{N * ITERS}, bits {float(h['bits'][-1]):.0f}, "
               f"consensus_gap {float(h['consensus_gap'][-1]):.3e}; test_mse "
               f"{ev['test_mse']:.5f} (fused) / {ev_ref['test_mse']:.5f} "
               f"(ref), consensus_mse {ev['consensus_mse']:.5f}")
        results[alg] = res
    backends_mod.residual_sq = real_residual_sq
    mega_counts = counts()
    log(4, f"launch counts over the megakernel path: {mega_counts}")
    if mega_counts["coke_fused_update"] != 0:
        raise AssertionError("K3 ran on the megakernel path")

    # ---- 5. the fused fallback on a logistic problem at full width --------
    labels_pm = torch.where(problem.labels > problem.labels.median(), 1.0,
                            -1.0)
    log_problem = make_problem(problem.feats, labels_pm, ring(N),
                               problem.lam, problem.rho, loss="logistic")
    if log_problem.feats.data_ptr() != problem.feats.data_ptr():
        raise AssertionError("the logistic problem copied Phi")
    log_cfg = FitConfig(krr=krr, backend="fused", graph="ring",
                        num_iters=ITERS)          # primal="auto"
    reset_counts()
    log_results = {}
    for alg in ("coke", "dkla"):
        before = (k2.FUSED_UPDATE_LAUNCHES, k2.LAUNCHES)
        t0 = time.perf_counter()
        res = fit(log_cfg.replace(algorithm=alg), problem=log_problem,
                  device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rose = (k2.FUSED_UPDATE_LAUNCHES - before[0], k2.LAUNCHES - before[1])
        if rose != (ITERS, 0):
            raise AssertionError(f"logistic {alg}: K3 launched {rose[0]} and "
                                 f"K2 {rose[1]} times in {ITERS} iterations")
        h = {k: v.cpu() for k, v in res.history.items()}
        check_history(f"logistic {alg}", h, ITERS)
        comms = int(h["comms"][-1])
        if alg == "dkla" and comms != N * ITERS:
            raise AssertionError(f"logistic dkla sent {comms} != {N * ITERS}")
        if alg == "coke" and comms > N * ITERS:
            raise AssertionError(f"logistic coke sent {comms} > {N * ITERS}")
        margins = torch.einsum("ntd,nd->nt", log_problem.feats, res.theta)
        acc = float((torch.sign(margins) == labels_pm).float().mean())
        before1 = k1.LAUNCHES
        preds = res.to_model(built.rff_params).predict(built.x_test,
                                                       backend="fused")
        torch.cuda.synchronize()
        if not k1.LAUNCHES > before1:
            raise AssertionError(f"logistic {alg}: predict did not launch K1")
        if preds.shape != built.y_test.shape or not torch.isfinite(
                preds).all():
            raise AssertionError(f"logistic {alg}: predictions are not "
                                 "finite")
        log(5, f"logistic {alg}: {ITERS} iterations in {wall:.2f} s wall "
               f"(first call); comms {comms}/{N * ITERS}, bits "
               f"{float(h['bits'][-1]):.0f}, train sign-accuracy {acc:.4f}, "
               f"consensus_gap {float(h['consensus_gap'][-1]):.3e}")
        log_results[alg] = res
    log_counts = counts()
    log(5, f"launch counts over the fused-fallback path: {log_counts}")

    # ---- 6. the spmd backend at full width --------------------------------
    reset_counts()
    spmd_cfg = cfg.replace(backend="spmd")
    for alg in ("coke", "dkla", "cta"):
        c = spmd_cfg.replace(algorithm=alg)
        if alg == "cta":
            # the ring runtime's CTA takes the gradient before the combine
            # (as the reference's spmd backend does); at the default
            # cta_lr=0.9 it diverges on this setup, at 0.3 it converges
            c = c.replace(censor_v=None, censor_mu=None, cta_lr=CTA_LR)
        t0 = time.perf_counter()
        res = fit(c, problem=problem, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        h = {k: v.cpu() for k, v in res.history.items()}
        check_history(f"spmd {alg}", h, ITERS)
        msg = (f"spmd {alg}: {ITERS} iterations in {wall:.2f} s wall (first "
               f"call); train_mse {float(h['train_mse'][0]):.5f} -> "
               f"{float(h['train_mse'][-1]):.5f}, comms "
               f"{int(h['comms'][-1])}/{N * ITERS}")
        if alg == "cta":
            if int(h["comms"][-1]) != N * ITERS:
                raise AssertionError("spmd cta did not send every iteration")
            if not h["train_mse"][-1] < h["train_mse"][0]:
                raise AssertionError("spmd cta: train_mse did not fall")
            log(6, msg)
            continue
        mega = results[alg]
        for k in ("comms", "bits"):
            if not torch.equal(h[k], mega.history[k].cpu()):
                raise AssertionError(f"spmd {alg}: {k} differs from the "
                                     "megakernel fit")
        e = float((res.theta - mega.theta).abs().max())
        tol = SPMD_RTOL * float(mega.theta.abs().max())
        log(6, f"{msg}; comms/bits equal the megakernel fit's, theta "
               f"max|err| {e:.3e} (tol {tol:.3e}, rtol {SPMD_RTOL:g} of "
               f"max|theta|)")
        if not e <= tol:
            raise AssertionError(f"spmd {alg}: theta differs from the "
                                 "megakernel fit")
    # phase 5's logistic fits on spmd, where g_aug is the plain formula:
    # holds K3 in place on the fused fallback at the main path's shapes
    for alg in ("coke", "dkla"):
        res = fit(log_cfg.replace(algorithm=alg, backend="spmd"),
                  problem=log_problem, device=dev)
        fused = log_results[alg]
        for k in ("comms", "bits"):
            if not torch.equal(res.history[k], fused.history[k]):
                raise AssertionError(f"spmd logistic {alg}: {k} differs from "
                                     "the fused fallback's")
        e = float((res.theta - fused.theta).abs().max())
        tol = SPMD_RTOL * float(fused.theta.abs().max())
        log(6, f"spmd logistic {alg}: comms {int(res.comms[-1])}/"
               f"{N * ITERS} and bits equal the fused fallback's (K3), theta "
               f"max|err| {e:.3e} (tol {tol:.3e}, rtol {SPMD_RTOL:g} of "
               f"max|theta|)")
        if not e <= tol:
            raise AssertionError(f"spmd logistic {alg}: theta differs from "
                                 "the fused fallback's")
    spmd_counts = counts()
    log(6, f"launch counts over the spmd path: {spmd_counts}")
    if spmd_counts["coke_fused_update"] or spmd_counts["coke_megastep"]:
        raise AssertionError("a fit kernel ran on the spmd path")

    # ---- 7. times ---------------------------------------------------------
    def runner(c, prob):
        carry0, chunk_fn, _ = consensus_runner(
            c, get_solver(c.algorithm), prob, SolveContext.from_config(c),
            None)
        state = {"carry": chunk_fn(carry0, 2)[0]}

        def ten_iterations():
            state["carry"] = chunk_fn(state["carry"], 10)[0]

        return state, ten_iterations

    def ten(fn):
        def calls():
            for _ in range(10):
                fn()
        return calls

    def pair(d_h):
        return f"{d_h[0]:.4f} ms on the device / {d_h[1]:.4f} ms host enqueue"

    # every iteration and every part below: device and host time from one
    # window of ten calls (paired_ms)
    plan = k2.megastep_plan(problem.feats)
    main_instance = (f"stream<V={plan.columns}, R={plan.max_rows}, "
                     f"{k2.megastep_staging(problem.feats)}>")
    for fn, props in ptxas_report(report["coke_megastep"]["log"]).items():
        log(7, f"[{card}] K2 ptxas {fn}: {props or 'no report'}"
               + (" (the main path's instance)" if fn == main_instance
                  else ""))
    log(7, f"[{card}] K2 plan at N={N} T={T} D={D}: grid "
           f"{plan.segments.grid} persistent blocks ({plan.blocks} fit on "
           f"the card at once), {plan.segments.num_segments} (block, agent) "
           f"segments, {k2.megastep_staging(problem.feats)} staging, "
           f"{plan.stages} stages of {plan.rows_per_stage} rows "
           f"({plan.stage_bytes} B each, {plan.smem_bytes} B of shared "
           f"memory), {plan.bytes_in_flight} B in flight per SM while the "
           f"consumers hold one stage; {plan.columns} float4 column groups "
           "per consumer thread")
    coke_cfg = cfg.replace(algorithm="coke")
    mega_state, mega_ten = runner(coke_cfg, problem)
    mega_iter = paired_ms(mega_ten, 10)
    iter_ms = mega_iter[0]
    st = mega_state["carry"]
    # the chunk's one train-MSE read of Phi, as _megastep_chunk makes it
    # after its last iteration: timed alone, and counted once per ten
    metric_read = paired_ms(ten(lambda: torch.sum(backends_mod.residual_sq(
        problem.feats, st.theta, problem.labels)) / (N * T)), 10)
    theta, hat, gamma = st.theta.clone(), st.theta_hat, st.gamma
    kw = dict(rho=problem.rho, lam=problem.lam, lr=coke_cfg.inner_lr,
              offsets=(1,))
    rsq_out = torch.empty((N,), device=dev)
    k2_path = paired_ms(ten(lambda: k2.coke_megastep(
        theta, hat, gamma, problem.feats, problem.labels, resid_sq=rsq_out,
        **kw)), 10)
    metric_share = metric_read[0] / 10
    log(7, f"[{card}] one megakernel COKE iteration at N={N} T={T} D={D} "
           f"(chunks of ten): {pair(mega_iter)}. Parts, each alone: K2 with "
           f"the train-MSE residuals folded in {pair(k2_path)}; the chunk's "
           f"one train-MSE read of Phi (einsum after its last iteration) "
           f"{pair(metric_read)}, {metric_share:.4f} ms per iteration over "
           f"ten; the rest (censor, dual, bookkeeping) "
           f"{iter_ms - k2_path[0] - metric_share:.4f} ms on the device. "
           f"Phi is read 11 times per ten iterations (20 when the metric "
           f"read it every iteration)")

    log_state, log_ten = runner(log_cfg.replace(algorithm="coke"),
                                log_problem)
    log_iter = paired_ms(log_ten, 10)
    log_iter_ms = log_iter[0]
    params, cst = log_state["carry"]
    th = params["theta"]
    grads_t = paired_ms(ten(lambda: _local_grads(log_problem, th)), 10)
    half = 0.5 * (cst["nbr_left"]["theta"] + cst["nbr_right"]["theta"])
    grads = _local_grads(log_problem, th)
    k3_path = paired_ms(ten(lambda: k2.coke_fused_update(
        th, cst["theta_hat"]["theta"], cst["gamma"]["theta"], grads, half,
        half, rho=log_problem.rho, deg=2.0)), 10)
    log_metrics = paired_ms(ten(lambda: _stacked_metrics(
        log_problem, th, cst["comms"], torch.sum(cst["comm"].bits))), 10)
    log(7, f"[{card}] one fused-logistic COKE iteration at N={N} T={T} "
           f"D={D}: {pair(log_iter)}. Parts, each alone: local gradients "
           f"(forward and backward, two Phi reads) {pair(grads_t)}; K3 "
           f"wrapper {pair(k3_path)}; train_mse metric {pair(log_metrics)}; "
           f"the rest (optimizer step, censor, dual, bookkeeping) "
           f"{log_iter_ms - grads_t[0] - k3_path[0] - log_metrics[0]:.4f} ms "
           f"on the device")

    _, spmd_ten = runner(spmd_cfg.replace(algorithm="coke"), problem)
    spmd_iter = paired_ms(spmd_ten, 10)
    log(7, f"[{card}] one spmd COKE iteration (quadratic) {pair(spmd_iter)}, "
           f"beside the megakernel's {pair(mega_iter)}")
    iteration_ms = {"megakernel": mega_iter, "fused-logistic": log_iter,
                    "spmd": spmd_iter}
    # the host's speed in this run: the ring runtime's iterations are
    # a few hundred such launches, so their time follows this figure
    tiny = torch.zeros(1, device=dev)
    probe = paired_ms(ten(lambda: [tiny.add_(1.0) for _ in range(100)]),
                      1000)
    log(7, f"[{card}] host dispatch probe: one add_ on a 1-element tensor "
           f"{pair(probe)}")

    theta2, hat2, gamma2, phi2, y2, kw2 = k2_inputs
    rsq2 = torch.empty((N_AGENTS,), device=dev)
    k2_ms = time_ms(lambda: k2.coke_megastep(theta2, hat2, gamma2, phi2, y2,
                                             resid_sq=rsq2, **kw2))
    k2_plain_ms = time_ms(lambda: coke_megastep_ref(
        theta2, hat2, gamma2, phi2, y2, return_resid_sq=True, **kw2))
    n2, t2, d2 = phi2.shape
    # Phi and y read; theta, theta_hat, gamma read, theta' written; xi_sq
    # and resid_sq written. Flops: the two matvecs, the combine, the
    # squared residuals
    k2_bytes = 4.0 * (n2 * t2 * d2 + n2 * t2 + 4 * n2 * d2 + 2 * n2)
    k2_flops = 4.0 * n2 * t2 * d2 + 12.0 * n2 * d2 + 2.0 * n2 * t2
    x1, omega1, bias1, _ = k1_inputs
    m1, d1 = x1.shape
    l1 = omega1.shape[1]
    # the card's own write stream over the same output: not K1's
    # library_ms (no call computes K1's function), a floor for its stores
    fill = torch.empty((m1, l1), device=dev)
    k1_ms = time_ms(lambda: k1.rff_cos_bias(x1, omega1, bias1))
    fill_ms = time_ms(lambda: fill.fill_(1.0))
    k1_plain_ms = time_ms(lambda: rff_ref(x1, omega1, bias1))
    del fill
    k1_bytes = 4.0 * (m1 * d1 + d1 * l1 + l1 + m1 * l1)
    k1_flops = 2.0 * m1 * l1 * d1 + 2.0 * m1 * l1
    ops3, kw3 = k3_inputs
    n3, d3 = ops3[0].shape

    def k3_call():
        return k2.coke_fused_update(*ops3, **kw3)

    # K3's device work (~microseconds) is shorter than its wrapper's host
    # side: its time and its plain version's come from CUDA-graph replays;
    # the floor probe, a graph of 100 zero_() on one element, is what one
    # graph node costs
    k3_ms = graph_ms(k3_call)
    k3_plain_ms = graph_ms(lambda: coke_update_ref(*ops3, **kw3))
    k3_floor_ms = graph_ms(torch.zeros(1, device=dev).zero_)
    k3_host_ms = host_call_ms(k3_call)
    k3_alone = [r for r in profiled_kernels(k3_call)
                if "coke_fused_update_kernel" in r[2]]
    # what the path's call reads: theta, theta_hat, gamma, grad and one
    # neighbour tensor where left is right (six (N, D) arrays with g_aug
    # written), seven with distinct neighbours; xi_sq (N,) written. Flops:
    # 8 for g_aug and 3 for the squared difference per element
    k3_plan, _, k3_shared = k2.fused_update_launch(ops3)
    k3_arrays = 6 if k3_shared else 7
    k3_bytes = 4.0 * (k3_arrays * n3 * d3 + n3)
    k3_flops = 11.0 * n3 * d3
    # the streaming shape with a cold L2, aliased and distinct
    flush = torch.empty(64 * 2**20, device=dev)          # 256 MB
    wide = [0.1 * torch.randn((n3, K3_STREAM_D), generator=gen, device=dev)
            for _ in range(6)]
    k3_stream = {}
    for label, right in (("aliased", wide[4]), ("distinct", wide[5])):
        wide_ops = wide[:5] + [right]
        for clean in (False, True):
            k3_stream[label + " clean" * clean] = flushed_ms(
                lambda o=wide_ops: k2.coke_fused_update(*o, **kw3), flush,
                clean=clean)
    wide_plan = k2.fused_update_launch(wide)[0]
    del flush, wide
    model = results["coke"].to_model(built.rff_params)
    predict_ms = time_ms(lambda: model.predict(built.x_test,
                                               backend="fused"))
    predict_ref_ms = time_ms(lambda: model.predict(built.x_test,
                                                   backend="ref"))

    def bound(nbytes, flops):
        t_b, t_f = nbytes / bw * 1e3, flops / fp32 * 1e3
        return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")

    launches = {"coke_megastep": mega_counts["coke_megastep"],
                "rff_cos_bias": mega_counts["rff_cos_bias"],
                "coke_fused_update": log_counts["coke_fused_update"]}
    kernels = []
    for kname, ms, plain, nbytes, flops in (
            ("coke_megastep", k2_ms, k2_plain_ms, k2_bytes, k2_flops),
            ("rff_cos_bias", k1_ms, k1_plain_ms, k1_bytes, k1_flops),
            ("coke_fused_update", k3_ms, k3_plain_ms, k3_bytes, k3_flops)):
        b_ms, b_by = bound(nbytes, flops)
        src, replaces = KERNEL_SOURCES[kname]
        kernels.append({"name": kname, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[kname],
                        "max_abs_err": errs[kname], "ms": ms,
                        "plain_ms": plain, "bound_ms": b_ms,
                        "bound_by": b_by, "library_ms": None})
        log(7, f"[{card}] {kname}: {ms:.4f} ms, bound {b_ms:.4f} ms "
               f"({b_by}: {nbytes / 1e9:.4f} GB, {flops / 1e9:.3f} GFLOP; "
               f"{b_ms / ms:.1%} of it), plain {plain:.4f} ms; library_ms "
               f"null: {NO_LIBRARY[kname]}")
    k2_bound = bound(k2_bytes, k2_flops)[0]
    log(7, f"[{card}] K2 redesigned: {k2_ms:.4f} ms against its "
           f"{k2_bound:.4f} ms byte bound ({k2_bound / k2_ms:.1%}) and the "
           f"earlier design's {K2_EARLIER_MS} ms "
           f"({K2_EARLIER_MS / k2_ms:.2f}x faster)")
    k1_bound = bound(k1_bytes, k1_flops)[0]
    log(7, f"[{card}] K1 redesigned: {k1_ms:.4f} ms against its "
           f"{k1_bound:.4f} ms byte bound ({k1_bound / k1_ms:.1%}) and the "
           f"earlier design's {K1_EARLIER_MS} ms "
           f"({K1_EARLIER_MS / k1_ms:.2f}x faster); write-floor probe "
           f"out.fill_(1.0) on the same ({m1}, {l1}) fp32 output "
           f"{fill_ms:.4f} ms ({k1_bytes / fill_ms / 1e9:.2f} TB/s; K1 "
           f"{k1_bytes / k1_ms / 1e9:.2f} TB/s)")
    log(7, f"[{card}] K2 shape N={n2} T={t2} D={d2}; K1 shape M={m1} d={d1} "
           f"L={l1}; K3 shape N={n3} D={d3}")
    k3_bound = bound(k3_bytes, k3_flops)[0]
    k3_kernel = (f"{k3_alone[0][0]:.6f} ms" if k3_alone
                 else "not measured (no device time recorded)")
    log(7, f"[{card}] K3 plan at N={n3} D={d3}: {k3_plan}; at N={n3} "
           f"D={K3_STREAM_D}: {wide_plan}")
    log(7, f"[{card}] K3 at the path's shape N={n3} D={d3}, "
           f"{'one tensor as both neighbours: six' if k3_shared else 'seven'}"
           f" (N, D) arrays, {k3_bytes / 1e6:.4f} MB: {k3_ms:.6f} ms per "
           f"call as a CUDA-graph replay (the earlier design "
           f"{K3_EARLIER_MS['path']} ms, two graph nodes); the kernel alone "
           f"by the profiler {k3_kernel} (earlier "
           f"{K3_EARLIER_MS['kernel alone']} ms + torch.sum "
           f"{K3_EARLIER_MS['torch.sum']} ms); floor probe (a graph of 100 "
           f"zero_() on one element) {k3_floor_ms:.6f} ms per node, K3 "
           f"{k3_ms / k3_floor_ms:.2f}x it; byte bound {k3_bound:.6f} ms, "
           f"not reachable at this size (~2 MB in L2, about one DRAM round "
           f"trip's worth of bytes in flight)")
    for label, arrays in (("aliased", 6), ("distinct", 7),
                          ("aliased clean", 6), ("distinct clean", 7)):
        nbytes = 4.0 * (arrays * n3 * K3_STREAM_D + n3)
        b_ms = nbytes / bw * 1e3
        ms = k3_stream[label]
        earlier = K3_EARLIER_MS[f"stream {label}"]
        how = ("written, then read back: the lines the call evicts are "
               "clean" if "clean" in label else "written before each call: "
               "the call's reads evict its dirty lines to memory")
        log(7, f"[{card}] K3 at N={n3} D={K3_STREAM_D} {label.split()[0]} "
               f"({arrays} (N, D) arrays, {nbytes / 1e6:.4f} MB), cold L2 "
               f"(256 MB {how}; per-call CUDA events, median): {ms:.6f} ms "
               f"against its {b_ms:.6f} ms byte bound ({b_ms / ms:.1%}); "
               f"the earlier design {earlier} ms ({earlier / ms:.2f}x)")
    log(7, f"[{card}] one K3 wrapper call's host time (perf_counter over "
           f"1000 calls): {k3_host_ms:.6f} ms (the earlier wrapper "
           f"{K3_EARLIER_HOST_MS} ms)")
    log(7, f"[{card}] predict on {tuple(built.x_test.shape)} held-out rows: "
           f"fused {predict_ms:.4f} ms, ref {predict_ref_ms:.4f} ms")

    # ---- 8. device traces of ten iterations -------------------------------
    from torch.profiler import (ProfilerActivity, profile,
                                supported_activities)

    def trace(ten_iterations, activities):
        """(event window ms, rows of (device ms, count, kernel name)) of
        ten iterations under the profiler."""
        torch.cuda.synchronize()
        with profile(activities=activities) as prof:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            ten_iterations()
            end.record()
            end.synchronize()
        # device-side events only: the host ops that launched them
        # (aten::bmm, ...) carry the same device time again
        rows = sorted(((device_ms(e), e.count, e.key)
                       for e in prof.key_averages()
                       if getattr(e, "device_type", None)
                       == torch.autograd.DeviceType.CUDA
                       and device_ms(e) > 0), reverse=True)
        return start.elapsed_time(end), rows

    for label, path, ten_iterations in (
            ("megakernel COKE", "megakernel", mega_ten),
            ("fused-logistic COKE", "fused-logistic", log_ten)):
        # device activity alone first: recording host ops stretches the
        # window the busy share is read against
        options = [[ProfilerActivity.CPU, ProfilerActivity.CUDA]]
        if ProfilerActivity.CUDA in supported_activities():
            options.insert(0, [ProfilerActivity.CUDA])
        for activities in options:
            window, rows = trace(ten_iterations, activities)
            if rows:
                break
        if not rows:
            log(8, f"{label}: the profiler recorded no device time: the "
                   "device busy share is not measured")
            continue
        busy = sum(r[0] for r in rows)
        traced = "+".join(a.name for a in activities)
        unprofiled = 10 * iteration_ms[path][0]
        log(8, f"[{card}] ten {label} iterations under the profiler "
               f"({traced}): window {window:.4f} ms (unprofiled, phase 7: "
               f"{unprofiled:.4f} ms), kernels {busy:.4f} ms: device busy "
               f"{busy / window:.1%} of the traced window, idle "
               f"{1 - busy / window:.1%}; kernel time over the unprofiled "
               f"window {busy / unprofiled:.1%}")
        for ms, count, key in rows[:12]:
            log(8, f"  {ms / 10:.4f} ms/iter  {count / 10:>5.1f} calls/iter  "
                   f"{key[:100]}")
        for ms, count, key in rows:
            if "coke_fused_update_kernel" in key:
                log(8, f"[{card}] K3 kernel device time {ms / count:.4f} ms "
                       f"per launch ({count} launches)")

    # one K3 call is one kernel launch: no reduction kernel after it. The
    # profiler can lose a kernel record of a short window (seen once on the
    # H100: 9 of 10 recorded), so a trace that recorded fewer K3 launches
    # than calls, and nothing else, is taken again; the wrapper's own count
    # must show one launch per call each time
    for attempt in range(1, 4):
        before = k2.FUSED_UPDATE_LAUNCHES
        rows3 = profiled_kernels(k3_call, calls=10)
        # profiled_kernels makes one call before its window
        if k2.FUSED_UPDATE_LAUNCHES - before != 11:
            raise AssertionError(
                f"eleven K3 wrapper calls counted "
                f"{k2.FUSED_UPDATE_LAUNCHES - before} launches, not 11")
        for ms, count, key in rows3:
            log(8, f"[{card}] ten K3 wrapper calls at N={n3} D={d3} under "
                   f"the profiler (trace {attempt}), per call: {ms:.6f} ms  "
                   f"{count:g} launches  {key[:100]}")
        if not rows3:
            log(8, "ten K3 wrapper calls: the profiler recorded no device "
                   "time: the kernels of one call are not measured")
            break
        if not (len(rows3) == 1
                and "coke_fused_update_kernel" in rows3[0][2]
                and rows3[0][1] <= 1):
            raise AssertionError(f"one K3 call launched {rows3}, not exactly "
                                 "one K3 kernel")
        if rows3[0][1] == 1:
            break
    else:
        raise AssertionError(f"three traces of ten K3 calls each recorded "
                             f"fewer than ten K3 launches: {rows3}")

    # ---- 9. the LM serving engine, small: card against CPU ----------------
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models.attention import _gqa_project_qkv
    from repro_torch.models.common import rms_norm
    from repro_torch.serve import Engine, ServeConfig

    small_cfg = get_config(LM_ARCH).reduced()
    small_gpu = M.init_params(small_cfg,
                              torch.Generator(device=dev).manual_seed(0))
    small_cpu = M.LM(small_cfg, device="cpu")
    small_cpu.load_state_dict({n: t.cpu() for n, t in
                               small_gpu.state_dict().items()})
    rng = np.random.default_rng(0)
    small_prompts = rng.integers(0, small_cfg.vocab_size, (2, 64))
    scfg = ServeConfig(max_new_tokens=8, cache_len=72)
    before = k4.LAUNCHES
    toks_gpu = Engine(small_cfg, small_gpu, scfg).generate(small_prompts)
    torch.cuda.synchronize()
    if k4.LAUNCHES - before != small_cfg.num_layers:
        raise AssertionError("the small engine did not launch K4 once per "
                             "layer")
    toks_cpu = Engine(small_cfg, small_cpu, scfg).generate(small_prompts)
    batch = {"tokens": torch.as_tensor(small_prompts)}
    lg_gpu, _ = M.prefill_with_state(small_gpu, small_cfg,
                                     {"tokens": batch["tokens"].to(dev)}, 72)
    lg_cpu, _ = M.prefill_with_state(small_cpu, small_cfg, batch, 72)
    e = float((lg_gpu.cpu() - lg_cpu).abs().max())
    tol = LM_RTOL * float(lg_cpu.abs().max())
    top2 = torch.topk(lg_cpu[..., :small_cfg.vocab_size], 2, dim=-1).values
    log(9, f"reduced {LM_ARCH} (2 layers, d_model 256) engine, 2 x 64 "
           f"prompt tokens, 8 new: card tokens {toks_gpu.tolist()}; equal "
           f"to the CPU's: {bool((toks_gpu == toks_cpu).all())}; prefill "
           f"logits max|err| {e:.3e} (tol {tol:.3e}, rtol {LM_RTOL:g} of "
           f"max|logit|); first-token top-1/top-2 margin "
           f"{float((top2[..., 0] - top2[..., 1]).min()):.3e}")
    if not ((toks_gpu == toks_cpu).all() and e <= tol):
        raise AssertionError("the small engine differs between card and CPU")
    del small_gpu, small_cpu

    # ---- 10. the LM serving engine at full width ---------------------------
    lm_cfg = get_config(LM_ARCH)
    t0 = time.perf_counter()
    lm = M.init_params(lm_cfg, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in lm.parameters())
    log(10, f"{LM_ARCH}: {n_params / 1e9:.3f} B parameters drawn on the card "
            f"in fp32 ({n_params * 4 / 1e9:.2f} GB) in "
            f"{time.perf_counter() - t0:.1f} s")
    prompts = rng.integers(0, lm_cfg.vocab_size, (LM_BATCH, LM_PROMPT))
    engine = Engine(lm_cfg, lm, ServeConfig(max_new_tokens=LM_NEW_TOKENS,
                                            cache_len=LM_CACHE))
    reset_counts()
    t0 = time.perf_counter()
    served = engine.generate(prompts)
    torch.cuda.synchronize()
    serve_wall = time.perf_counter() - t0
    lm_counts = counts()
    log(10, f"generate: {LM_BATCH} x {LM_PROMPT} prompt tokens, "
            f"{LM_NEW_TOKENS} new each, in {serve_wall:.2f} s wall (first "
            f"call); launch counts over the serving path: {lm_counts}")
    if lm_counts != {"coke_megastep": 0, "rff_cos_bias": 0,
                     "coke_fused_update": 0,
                     "flash_attention": lm_cfg.num_layers, "threefry": 0,
                     "gather_rowdot": 0, "flash_attention_bwd": 0}:
        raise AssertionError(f"the serving path launched {lm_counts}, not "
                             f"K4 once per layer of the prefill")
    if served.shape != (LM_BATCH, LM_NEW_TOKENS) or not (
            (served >= 0) & (served < lm_cfg.vocab_size)).all():
        raise AssertionError(f"generate gave {served.shape} tokens outside "
                             "the vocabulary")
    log(10, f"generated ids (first 8 of each row): "
            f"{served[:, :8].tolist()}")

    lm_batch = {"tokens": torch.as_tensor(prompts, device=dev)}
    with torch.inference_mode():
        logits, lm_state = M.prefill_with_state(lm, lm_cfg, lm_batch,
                                                LM_CACHE)
        torch.cuda.synchronize()
        if logits.shape != (LM_BATCH, 1, lm_cfg.padded_vocab) or not bool(
                torch.isfinite(logits).all()):
            raise AssertionError("prefill logits are not finite "
                                 f"{(LM_BATCH, 1, lm_cfg.padded_vocab)}")
        # layer 0's attention: K4 against its plain version on one query
        # head of each KV group, over the last 512 query rows, which see
        # the whole causal key range
        pos = torch.arange(LM_PROMPT, dtype=torch.int32, device=dev)
        h0 = rms_norm(torch.nn.functional.embedding(lm_batch["tokens"],
                                                    lm.embed),
                      lm.blocks[0].ln1, lm_cfg.norm_eps)
        q0, k0, v0 = _gqa_project_qkv(lm.blocks[0].attn, lm_cfg, h0, pos)
        got = gqa_flash(q0, k0, v0, causal=True)
        group = lm_cfg.num_heads // lm_cfg.num_kv_heads
        heads = torch.arange(0, lm_cfg.num_heads, group, device=dev)
        want = attention_ref(q0[:, :, heads].transpose(1, 2),
                             k0.transpose(1, 2), v0.transpose(1, 2),
                             causal=True).transpose(1, 2)
        rows = slice(LM_PROMPT - 512, LM_PROMPT)
        err_k4 = float((got[:, rows][:, :, heads] - want[:, rows]).abs()
                       .max())
        errs["flash_attention"] = err_k4
        log(10, f"layer 0 attention, K4 against its plain version on heads "
                f"{heads.tolist()} (one per KV group), last 512 query rows: "
                f"max|err| {err_k4:.3e} (tol {K4_TOL[torch.float32]:g})")
        if not err_k4 <= K4_TOL[torch.float32]:
            raise AssertionError("K4 disagrees with its plain version on "
                                 "layer 0 of the full-width prefill")
        del want

        # times: prefill split into K4 and the rest, decode per token
        prefill_t = paired_ms(lambda: M.prefill_with_state(
            lm, lm_cfg, lm_batch, LM_CACHE), 1, runs=3, warmup=1)
        k4_call = paired_ms(ten(lambda: gqa_flash(q0, k0, v0, causal=True)),
                            10, runs=3, warmup=1)
        k4_share = lm_cfg.num_layers * k4_call[0]
        log(10, f"[{card}] prefill of {LM_BATCH} x {LM_PROMPT} tokens: "
                f"{pair(prefill_t)}. K4: {lm_cfg.num_layers} launches x "
                f"{pair(k4_call)} = {k4_share:.4f} ms on the device "
                f"({k4_share / prefill_t[0]:.1%} of the prefill); the rest "
                f"(projections, norms, rope, MLPs, cache packing, head) "
                f"{prefill_t[0] - k4_share:.4f} ms")
        token = torch.as_tensor(served[:, :1], dtype=torch.long, device=dev)

        def decode_steps():
            for i in range(LM_NEW_TOKENS - 1):
                M.decode_step(lm, lm_cfg, token, lm_state, LM_PROMPT + i)

        decode_t = paired_ms(decode_steps, LM_NEW_TOKENS - 1, runs=3,
                             warmup=1)
        weight_ms = n_params * 4 / bw * 1e3
        log(10, f"[{card}] decode per token (batch {LM_BATCH}, cache "
                f"{LM_CACHE}): {pair(decode_t)}; reading the fp32 weights "
                f"once takes {weight_ms:.4f} ms at {bw / 1e12} TB/s")
        for what, fn in (("one prefill", lambda: M.prefill_with_state(
                lm, lm_cfg, lm_batch, LM_CACHE)),
                         (f"{LM_NEW_TOKENS - 1} decode steps", decode_steps)):
            window, rows_p = trace(fn, [ProfilerActivity.CUDA]) \
                if ProfilerActivity.CUDA in supported_activities() \
                else (0, [])
            if not rows_p:
                log(10, f"the profiler recorded no device time over {what}: "
                        "its busy share is not measured")
                continue
            busy = sum(r[0] for r in rows_p)
            log(10, f"[{card}] {what} under the profiler (CUDA): window "
                    f"{window:.4f} ms, kernels {busy:.4f} ms, device busy "
                    f"{busy / window:.1%}, idle {1 - busy / window:.1%}")
            for ms, count, key in rows_p[:8]:
                log(10, f"  {ms:.4f} ms  {count:>5} calls  {key[:100]}")

        # K4 at the main path's shape: its bound, plain version, library
        n_pairs = LM_PROMPT * (LM_PROMPT + 1) // 2
        dh = lm_cfg.resolved_head_dim
        k4_flops = 2.0 * LM_BATCH * lm_cfg.num_heads * 2 * dh * n_pairs
        k4_bytes = 4.0 * LM_BATCH * LM_PROMPT * dh * (
            2 * lm_cfg.num_heads + 2 * lm_cfg.num_kv_heads)
        k4_ms = time_ms(lambda: gqa_flash(q0, k0, v0, causal=True), reps=3,
                        runs=5, warmup=1)
        k4_plain_ms = time_ms(lambda: attention_ref(
            q0.transpose(1, 2), k0.transpose(1, 2), v0.transpose(1, 2),
            causal=True), reps=1, runs=3, warmup=1)
        k4_lib_ms, k4_lib_how = sdpa_ms(q0.transpose(1, 2), k0.transpose(1, 2),
                                        v0.transpose(1, 2), causal=True)
        del q0, k0, v0, h0, got, lm_state, logits
    del lm, engine
    torch.cuda.empty_cache()
    b_ms, b_by, b_how = k4_bound(k4_bytes, k4_flops, torch.float32, peaks)
    src, replaces = KERNEL_SOURCES["flash_attention"]
    kernels.append({"name": "flash_attention", "route": "cuda",
                    "source": src, "replaces": replaces,
                    "launches": lm_counts["flash_attention"],
                    "max_abs_err": errs["flash_attention"], "ms": k4_ms,
                    "plain_ms": k4_plain_ms, "bound_ms": b_ms,
                    "bound_by": b_by, "library_ms": k4_lib_ms})
    log(10, f"[{card}] flash_attention at the prefill's shape (B={LM_BATCH}, "
            f"S={LM_PROMPT}, H={lm_cfg.num_heads}, KV={lm_cfg.num_kv_heads}, "
            f"Dh=Dv={dh}, causal, fp32): {k4_ms:.4f} ms, bound {b_ms:.4f} ms "
            f"({b_by}, {b_how}: {k4_bytes / 1e9:.4f} GB, "
            f"{k4_flops / 1e12:.4f} TFLOP "
            f"over {n_pairs} admissible pairs per head; {b_ms / k4_ms:.1%} "
            f"of it), plain {k4_plain_ms:.4f} ms, "
            f"F.scaled_dot_product_attention {k4_lib_ms:.4f} ms "
            f"({k4_lib_how})")

    # ---- 11. K4 alone at the prefill_32k length ----------------------------
    side = {}
    qwen3 = (lm_cfg.num_heads, lm_cfg.num_kv_heads, dh, 0)
    for label, (H, KV, D, window), dtype, causal in (
            ("qwen3", qwen3, torch.float32, True),
            ("qwen3", qwen3, torch.float32, False),
            ("qwen3", qwen3, torch.bfloat16, True),
            ("mixtral", MIXTRAL_HEADS, torch.float32, True),
            ("mixtral", MIXTRAL_HEADS, torch.bfloat16, True)):
        S = PREFILL_32K
        q = torch.randn((1, S, H, D), generator=gen, device=dev).to(dtype)
        k = torch.randn((1, S, KV, D), generator=gen, device=dev).to(dtype)
        v = torch.randn((1, S, KV, D), generator=gen, device=dev).to(dtype)
        ms = time_ms(lambda: gqa_flash(q, k, v, causal=causal,
                                       window=window), reps=1, runs=3,
                     warmup=1)
        if causal and window:
            n_pairs = (window * (window + 1) // 2 + (S - window) * window)
        elif causal:
            n_pairs = S * (S + 1) // 2
        else:
            n_pairs = S * S
        flops = 2.0 * H * 2 * D * n_pairs
        nbytes = dtype.itemsize * S * D * (2 * H + 2 * KV)
        b_ms, b_by, b_how = k4_bound(nbytes, flops, dtype, peaks)
        mask = None
        if window:
            i = torch.arange(S, device=dev)
            mask = (i[None, :] <= i[:, None]) & (i[None, :] >
                                                 i[:, None] - window)
        lib_ms, lib_how = sdpa_ms(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), causal=causal,
                                  mask=mask)
        key = str(dtype).split(".")[-1]
        side[(label, key, causal)] = ms
        log(11, f"[{card}] K4 {label} S={S} H={H} KV={KV} Dh=Dv={D} "
                f"{'causal' if causal else 'non-causal'} window={window} "
                f"{key}: {ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}, "
                f"{b_how}: {flops / 1e12:.4f} TFLOP over {n_pairs} pairs "
                f"per head, {nbytes / 1e9:.4f} GB; "
                f"{b_ms / ms:.1%} of it); F.scaled_dot_product_attention "
                f"{lib_ms:.4f} ms ({lib_how})")
        del q, k, v, mask
        torch.cuda.empty_cache()
    ratio = side[("qwen3", "float32", True)] / side[("qwen3", "float32",
                                                     False)]
    log(11, f"[{card}] K4 qwen3 S={PREFILL_32K} fp32: causal "
            f"{side[('qwen3', 'float32', True)]:.4f} ms beside non-causal "
            f"{side[('qwen3', 'float32', False)]:.4f} ms: {ratio:.3f}x "
            "(key tiles above the diagonal are skipped)")
    if not ratio <= 0.6:
        raise AssertionError(f"the causal K4 call takes {ratio:.3f}x the "
                             "non-causal one: the skipped tiles did not show")

    # ---- 12. the simulator backend and the exact primals ------------------
    simulator_phase(dev, problem, krr, card, bw, fp32, reset_counts, counts)

    # ---- 13. the comm chain and time-varying topologies -------------------
    comm_topology_phase(dev, card, reset_counts, counts, problem=problem,
                        cfg=cfg, coke4=results["coke"], built=built,
                        log_problem=log_problem, log_cfg=log_cfg,
                        small=small, small_problem=small_built.problem,
                        small_logistic=small_logistic)

    # ---- 14. sweep: policy grids as one lane-batched loop ----------------
    sweep_phase(dev, card, reset_counts, counts, krr=krr)

    # ---- 15. streaming: fit_stream and partial_fit -----------------------
    stream_phase(dev, card, reset_counts, counts)

    # ---- 16. gossip and churn ---------------------------------------------
    kernels.append(gossip_phase(
        dev, card, reset_counts, counts, problem=problem, cfg=cfg,
        built=built, coke4=results["coke"], log_problem=log_problem,
        log_cfg=log_cfg, peaks=peaks, k5_ops=k5_ops))
    log(16, f"[{card}] threefry (K5): {kernels[-1]}")

    # ---- 17. personalization ------------------------------------------------
    pz_k1 = personalize_phase(dev, card, reset_counts, counts)
    log(17, f"[{card}] K1 launches in phase 17's per-agent deploy: {pz_k1} "
            "(one per model); K2, K3 and K4 never moved in phase 17")

    # ---- 18. many-model serving ---------------------------------------------
    kernels.append(serve_phase(dev, card, reset_counts, counts, built=built,
                               coke=results["coke"], bw=bw, fp32=fp32))
    log(18, f"[{card}] gather_rowdot (K6): {kernels[-1]}")

    # ---- 19. big-D feature sharding -----------------------------------------
    shard_counts, shard_errs = shard_phase(
        dev, card, reset_counts, counts, problem=problem, cfg=cfg,
        built=built, coke4=results["coke"], log_problem=log_problem,
        log_cfg=log_cfg, log_coke=log_results["coke"])
    for entry in kernels:       # the kernels phase 19 runs: its numbers
        n19 = shard_counts[entry["name"]]
        if n19:
            log(19, f"{entry['name']}: launches {entry['launches']} and "
                    f"max|err| {entry['max_abs_err']:.3e} on its earlier "
                    f"path, {n19} and {shard_errs[entry['name']]:.3e} over "
                    "phase 19")
            entry["launches"] = n19
            entry["max_abs_err"] = shard_errs[entry["name"]]
    for name in ("rff_cos_bias", "coke_fused_update", "gather_rowdot",
                 "threefry"):
        if not shard_counts[name]:
            raise AssertionError(f"phase 19 never launched {name}")

    # ---- 20. training through K4 and K7 ---------------------------------
    # phase 20(g)'s full-width mamba2-2.7b peaks at ~75 of the card's ~79
    # GiB: the fit cells' arrays go first (phase 4's and phase 2's Phi and
    # what holds them); phase 21 rebuilds phase 4's problem from its seed,
    # as --phase21 does
    phi_freed = weakref.ref(problem.feats)
    del (problem, built, log_problem, results, log_results, mega_state,
         mega_ten, log_state, log_ten, spmd_ten, ten_iterations, k2_inputs,
         theta2, hat2, gamma2, phi2, y2, kw2)
    gc.collect()
    torch.cuda.empty_cache()
    log(20, f"before phase 20: {torch.cuda.memory_allocated() / 2**30:.2f} "
            f"GiB allocated; phase 4's Phi freed: {phi_freed() is None}")
    k7_entry, train_k4 = train_phase(dev, card, reset_counts, counts,
                                     peaks=peaks)
    kernels.append(k7_entry)
    log(20, f"[{card}] flash_attention_bwd (K7): {kernels[-1]}")

    # ---- 21. a mesh under gossip and personalization ----------------------
    problem = build_problem(cfg, device=dev).problem
    mesh_counts, mesh_errs = mesh_gossip_phase(
        dev, card, reset_counts, counts, problem=problem, cfg=cfg)
    for entry in kernels:       # the kernels phase 21 runs: its numbers
        n21 = mesh_counts[entry["name"]]
        if n21:
            log(21, f"{entry['name']}: launches {entry['launches']} and "
                    f"max|err| {entry['max_abs_err']:.3e} on its earlier "
                    f"path, {n21} and {mesh_errs[entry['name']]:.3e} over "
                    "phase 21")
            entry["launches"] = n21
            entry["max_abs_err"] = mesh_errs[entry["name"]]
    for name in ("rff_cos_bias", "coke_fused_update", "threefry"):
        if not mesh_counts[name]:
            raise AssertionError(f"phase 21 never launched {name}")

    # ---- 22. the LM families beside qwen3, served at full width -------------
    lm_launches, lm_err = lm_family_phase(dev, card, reset_counts, counts,
                                          peaks=peaks)
    for entry in kernels:       # K4's numbers: phase 22's four generates
        if entry["name"] == "flash_attention":
            log(22, f"flash_attention: launches {entry['launches']} and "
                    f"max|err| {entry['max_abs_err']:.3e} on phase 10's "
                    f"path, {lm_launches} and {lm_err:.3e} over phase 22")
            entry["launches"] = lm_launches
            entry["max_abs_err"] = max(entry["max_abs_err"], lm_err)

    # ---- 23. the SSM model and the grouped hybrid, served at full width -----
    ssm_launches, ssm_err = ssm_phase(dev, card, reset_counts, counts,
                                      peaks=peaks)
    for entry in kernels:       # K4's numbers: phases 22 and 23's generates
        if entry["name"] == "flash_attention":
            log(23, f"flash_attention: launches {entry['launches']} and "
                    f"max|err| {entry['max_abs_err']:.3e} over phases 10 and "
                    f"22, {ssm_launches} and {ssm_err:.3e} over phase 23")
            entry["launches"] += ssm_launches
            entry["max_abs_err"] = max(entry["max_abs_err"], ssm_err)
            log(23, f"flash_attention: {train_k4} launches over phase "
                    "20(f)-(g)'s training steps added")
            entry["launches"] += train_k4

    # ---- 24. K4's fp32 accuracy at long rows and at full depth --------------
    k4_accuracy_phase(dev, card, reset_counts, counts)

    # ---- 25. MoE and MLA training through K4 and K7 at Dh != Dv -------------
    k7_25, k7_err_25, k4_25 = moe_mla_train_phase(dev, card, reset_counts,
                                                  counts, peaks=peaks)
    for entry in kernels:       # K4 and K7 add phase 25's launches
        if entry["name"] == "flash_attention_bwd":
            log(25, f"flash_attention_bwd: launches {entry['launches']} and "
                    f"max|err| {entry['max_abs_err']:.3e} over phase 20, "
                    f"{k7_25} and {k7_err_25:.3e} over phase 25")
            entry["launches"] += k7_25
            entry["max_abs_err"] = max(entry["max_abs_err"], k7_err_25)
        elif entry["name"] == "flash_attention":
            log(25, f"flash_attention: {k4_25} launches over phase 25's "
                    "training steps added")
            entry["launches"] += k4_25

    # ---- 26. the VLM prefix and enc-dec serving -----------------------------
    mm_launches, mm_err = multimodal_phase(dev, card, reset_counts, counts,
                                           peaks=peaks)
    for entry in kernels:       # K4 adds phase 26's launches and error
        if entry["name"] == "flash_attention":
            log(26, f"flash_attention: {mm_launches} launches and max|err| "
                    f"{mm_err:.3e} over phase 26 added")
            entry["launches"] += mm_launches
            entry["max_abs_err"] = max(entry["max_abs_err"], mm_err)

    # ---- 27. the VLM and the enc-dec model trained through K4 and K7 -------
    k7_27, k7_err_27, k4_27, k4_err_27 = mm_train_phase(
        dev, card, reset_counts, counts, peaks=peaks)
    for entry in kernels:       # K4 and K7 add phase 27's launches, errors
        if entry["name"] == "flash_attention_bwd":
            log(27, f"flash_attention_bwd: {k7_27} launches and max|err| "
                    f"{k7_err_27:.3e} over phase 27 added")
            entry["launches"] += k7_27
            entry["max_abs_err"] = max(entry["max_abs_err"], k7_err_27)
        elif entry["name"] == "flash_attention":
            log(27, f"flash_attention: {k4_27} launches and max|err| "
                    f"{k4_err_27:.3e} over phase 27 added")
            entry["launches"] += k4_27
            entry["max_abs_err"] = max(entry["max_abs_err"], k4_err_27)

    # ---- 28. phase 19's mesh across ranks of a gloo group -------------------
    rank_counts, rank_errs = ranks_phase(dev, card, reset_counts, counts)
    for entry in kernels:       # K1, K3, K5 and K6 add the ranks' launches
        n28 = rank_counts[entry["name"]]
        if n28:
            log(28, f"{entry['name']}: {n28} launches over the ranks and "
                    f"max|err| {rank_errs[entry['name']]:.3e} on their "
                    "blocks added")
            entry["launches"] += n28
            entry["max_abs_err"] = max(entry["max_abs_err"],
                                       rank_errs[entry["name"]])
    for name in ("rff_cos_bias", "coke_fused_update", "threefry",
                 "gather_rowdot"):
        if not rank_counts[name]:
            raise AssertionError(f"phase 28's ranks never launched {name}")

    # ---- 29. the trainer's agents on their own ranks ----------------------
    # its two ranks take ~30 GB of the card each: phase 21's problem goes
    del problem
    gc.collect()
    torch.cuda.empty_cache()
    log(29, f"before phase 29: {torch.cuda.memory_allocated() / 2**30:.2f} "
            "GiB allocated here")
    train_counts, train_errs = train_ranks_phase(dev, card, reset_counts,
                                                 counts)
    for entry in kernels:       # K4 and K7 add the ranks' launches
        n29 = train_counts[entry["name"]]
        if n29:
            log(29, f"{entry['name']}: {n29} launches over the ranks and "
                    f"max|err| {train_errs[entry['name']]:.3e} on their own "
                    "agents added")
            entry["launches"] += n29
            entry["max_abs_err"] = max(entry["max_abs_err"],
                                       train_errs[entry["name"]])
    log(29, f"the whole script took {time.perf_counter() - t_script:.1f} s")

    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def phase19_alone() -> int:
    """Phase 19 alone: build the kernels, fit phase 4's full-width COKE
    cell on the megakernel path and phase 5's logistic COKE cell on the
    fused fallback (what phase 19 holds its sharded runs against), then
    run `shard_phase` and print its launch counts and errors."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.api import FitConfig, build_problem, fit, make_problem
    from repro_torch.core.graph import ring
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    build.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    cfg = full_width_config()
    built = build_problem(cfg, device=dev)
    problem = built.problem
    coke = fit(cfg.replace(algorithm="coke"), problem=problem, device=dev)
    labels = torch.where(problem.labels > problem.labels.median(), 1.0, -1.0)
    log_problem = make_problem(problem.feats, labels,
                               ring(problem.num_agents), problem.lam,
                               problem.rho, loss="logistic")
    log_cfg = FitConfig(krr=cfg.krr, backend="fused", graph="ring",
                        num_iters=ITERS)
    log_coke = fit(log_cfg.replace(algorithm="coke"), problem=log_problem,
                   device=dev)
    torch.cuda.synchronize()
    log(19, f"[{card}] built the kernels and fitted phases 4 and 5's COKE "
            f"cells in {time.perf_counter() - t0:.1f} s")
    seen, errs = shard_phase(dev, card, reset_counts, counts,
                             problem=problem, cfg=cfg, built=built,
                             coke4=coke, log_problem=log_problem,
                             log_cfg=log_cfg, log_coke=log_coke)
    print(card)
    print(json.dumps({"launches": seen, "max_abs_err": errs}))
    return 0


def phase21_alone() -> int:
    """Phase 21 alone: build the kernels and phase 4's problem, then run
    `mesh_gossip_phase` and print its launch counts and errors."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.api import build_problem
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    build.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    cfg = full_width_config()
    problem = build_problem(cfg, device=dev).problem
    torch.cuda.synchronize()
    log(21, f"[{card}] built the kernels and phase 4's problem in "
            f"{time.perf_counter() - t0:.1f} s")
    seen, errs = mesh_gossip_phase(dev, card, reset_counts, counts,
                                   problem=problem, cfg=cfg)
    print(card)
    print(json.dumps({"launches": seen, "max_abs_err": errs}))
    return 0


def phase20_alone() -> int:
    """Phase 20 alone: build the kernels and run `train_phase`; prints its
    K7 entry, not the result lines."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    build.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    entry, k4_launches = train_phase(
        dev, card, reset_counts, counts,
        peaks=card_peaks(torch.cuda.get_device_name(0)))
    print(card)
    print(json.dumps(dict(entry, k4_launches=k4_launches)))
    return 0


def phase22_alone() -> int:
    """Phase 22 alone: build the kernels and run `lm_family_phase`; prints
    its K4 launches and largest error, not the result lines."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    build.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    launches, err = lm_family_phase(
        dev, card, reset_counts, counts,
        peaks=card_peaks(torch.cuda.get_device_name(0)))
    print(card)
    print(json.dumps({"flash_attention": {"launches": launches,
                                          "max_abs_err": err}}))
    return 0


def phase23_alone() -> int:
    """Phase 23 alone: build the kernels and run `ssm_phase`; prints its K4
    launches and largest error, not the result lines."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    build.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    launches, err = ssm_phase(
        dev, card, reset_counts, counts,
        peaks=card_peaks(torch.cuda.get_device_name(0)))
    print(card)
    print(json.dumps({"flash_attention": {"launches": launches,
                                          "max_abs_err": err}}))
    return 0


def phase24_alone() -> int:
    """Phase 24 alone: build the kernels and run `k4_accuracy_phase`;
    prints K4's largest error against float64 on long rows and its
    launches in the full-depth prefills, not the result lines."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    build.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    err, launches = k4_accuracy_phase(dev, card, reset_counts, counts)
    print(card)
    print(json.dumps({"flash_attention": {"launches": launches,
                                          "max_err_float64": err}}))
    return 0


def phase25_alone() -> int:
    """Phase 25 alone: build the kernels and run `moe_mla_train_phase`;
    prints K7's launches and largest error and K4's launches, not the
    result lines."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    build.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    k7_launches, k7_err, k4_launches = moe_mla_train_phase(
        dev, card, reset_counts, counts,
        peaks=card_peaks(torch.cuda.get_device_name(0)))
    print(card)
    print(json.dumps({"flash_attention_bwd": {"launches": k7_launches,
                                              "max_abs_err": k7_err},
                      "flash_attention": {"launches": k4_launches}}))
    return 0


def phase26_alone() -> int:
    """Phase 26 alone: build the kernels and run `multimodal_phase`; prints
    its K4 launches and largest error, not the result lines."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    build.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    launches, err = multimodal_phase(
        dev, card, reset_counts, counts,
        peaks=card_peaks(torch.cuda.get_device_name(0)))
    print(card)
    print(json.dumps({"flash_attention": {"launches": launches,
                                          "max_abs_err": err}}))
    return 0


def phase27_alone() -> int:
    """Phase 27 alone: build the kernels and run `mm_train_phase`; prints
    K7's and K4's launches and largest errors, not the result lines."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    build.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    k7_launches, k7_err, k4_launches, k4_err = mm_train_phase(
        dev, card, reset_counts, counts,
        peaks=card_peaks(torch.cuda.get_device_name(0)))
    print(card)
    print(json.dumps({"flash_attention_bwd": {"launches": k7_launches,
                                              "max_abs_err": k7_err},
                      "flash_attention": {"launches": k4_launches,
                                          "max_abs_err": k4_err}}))
    return 0


def phase28_alone() -> int:
    """Phase 28 alone: build the kernels (the ranks only load them), then
    run `ranks_phase` and print its launch counts and errors."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    build.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(28, f"[{card}] built the kernels in {time.perf_counter() - t0:.1f} s")
    seen, errs = ranks_phase(dev, card, reset_counts, counts)
    print(card)
    print(json.dumps({"launches": seen, "max_abs_err": errs}))
    return 0


if __name__ == "__main__":
    alone = {"--phase19": phase19_alone, "--phase20": phase20_alone,
             "--phase21": phase21_alone, "--phase22": phase22_alone,
             "--phase23": phase23_alone, "--phase24": phase24_alone,
             "--phase25": phase25_alone, "--phase26": phase26_alone,
             "--phase27": phase27_alone, "--phase28": phase28_alone,
             "--phase29": phase29_alone}
    sys.exit(alone[sys.argv[1]]() if sys.argv[1:] and sys.argv[1] in alone
             else main())
