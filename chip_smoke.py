#!/usr/bin/env python3
"""Smoke run of hpx_tpu_torch, the PyTorch/CUDA port, on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA GPU and nvcc.
It needs one card and takes a few minutes, the kernel build included.
Float32 matrix products and convolutions run in full float32 (TF32 off).

1. Build: compiles the port's CUDA sources (hpx_tpu_torch/csrc/*.cu, one
   nvcc per source, all started together) and prints each build's time,
   nvcc's register and spill report, and the card's name and power
   limit (nvidia-smi); the SASS of the bf16 flash forward
   (flash_fwd_wgmma) and of the bf16 flash backward (flash_bwd_wgmma)
   must each hold HGMMA (wgmma) and UTMALDG (TMA loads) instructions,
   and those of the f32 flash forward and chunk fold (flash_fwd_tf32x3)
   and of the f32 flash backward (flash_bwd_tf32x3) HMMA (mma.sync on
   the tensor cores), their registers and spills printed beside
   (cuobjdump -sass). For kernel 1
   (multistep_fused_kernel<K>, one
   instance a K of ops.stencil.CELLS_PER_THREAD) it prints the SHFL,
   LDS, STS and BAR counts of its SASS, which must hold SHFL; the CUDA
   runtime's registers, static shared memory and local bytes of each
   instance: the shared memory must equal ops.stencil.smem_bytes and
   nothing may spill.
   Then the native scheduler (hpx_tpu_torch/native/scheduler.cpp),
   built with g++ into hpx_tpu_torch/_build/: the pool an executor owns
   under the default configuration must be a NativePool, and
   examples_cuda/fibonacci.py's fib(15) at threshold 10 must give 610
   through it, one task a spawn.
2. Kernel checks: each kernel against its plain PyTorch version on small
   and ragged shapes. The stencil kernels bitwise (tolerance 0): kernel
   2 at n in {1, 2, 3, 127, 1000, 2^20 + 3}; kernel 1 at n in {1, 5,
   511 and 513 (around 2S, S = ops.stencil.PASS_STEPS = 256), 4095,
   4097, 100003, 2^19} and around the tile the plan gives 2^19 (T - 1,
   T, T + 1), steps in {1, 31, 32, 33, 70, S - 1, S, S + 1, 2S + 3,
   1024}, by the wrapper's own plan, by each K's plan and by each K's
   plan with blocks of 2 and 8 warps (runs exchanged between warps), and
   from a tensor that is not 16-byte aligned (the scalar loads); one
   pass given a halo one cell short (a planted fault) must differ. The
   paged-attention kernels within rtol = atol = 1e-5 for float32 output
   and rtol = atol = 1e-2 (about one bfloat16 ulp at the outputs'
   magnitude) for bfloat16 output, over every pool type and 18 shapes
   (three of them split over P = 8, 8 and 5 CTAs with wholly dead runs;
   head dims 80, 40, 36, 256 and 384 for the kernels' other paths:
   element loads, padded rows, 16 lanes a key, a ring of 2 stages;
   blocks of 256 and 128 rows walked in parts, and an online chunk of
   fewer blocks, the plans the first split design refused),
   the online kernel against its plain version in the kernel's split
   and chunk (splits=P, chunk_rows); each output bitwise the same on a
   second call, with
   every dead table entry pointed at another block and from pools that
   are not 16-byte aligned; the wrapper's shared-memory sizes equal the
   source's; an exact-kernel shape above the shared-memory cap
   (W*g*S/8) must raise; both kernels at S 49600 and 56960 with 528
   (slot, head) pairs (P = 1, raised for the exact kernel where its run
   does not fit); both kernels at hd 512 of f32 with a halved chunk.
   Kernel 9 (the FP32 rate probe, fma_chain) bitwise against
   plain_fma_chain at n in {128, 4096, 2^17 + 384}, steps in {1, 7,
   1024}, c in {0.9999999, 0.3}.
3. The main path, through the entry points a user calls, each path with
   the launch counts set to 0 just before it and read just after:
     fused     stencil_fused -> multistep -> multistep_fused (kernel 1:
               one C call a dispatch, launching its passes of up to 256
               steps), n = 2^27 with nt = 256 in 64-step dispatches, and
               n = 2^19 with nt = 1024 in one dispatch;
     unfused   heat_step_best (kernel 2) for 16 chained steps at
               n = 2^28 and at n = 2^20 + 3;
     dataflow  stencil_dataflow over a CudaExecutor, np = 16 partitions of
               2^20, nt = 32, eager and then watched futures.
     config #1 SAXPY + dot as examples_cuda/saxpy_cuda.py runs it at n =
               2^22: z = a*x + y by two hpx.transform calls and dot(z,
               x) by hpx.transform_reduce under par.on(cuda_executor())
               on CUDA tensors, with torch's sync debug mode "error"
               around them (no synchronization, so no copy to the
               host), every result on cuda:0 until the final float(); z
               within 2.5e-7 and dot within 1e-5 relative of float64
               numpy; dot again through torch.add (a known fold) and
               through a lambda (the general fold, log2(n) rounds),
               each timed and within 1e-5. Then under par.task with
               the card held busy (torch.cuda._sleep): the launch
               returns at once, the future is not ready until the
               device work is done, and z and dot equal the blocking
               run's bit for bit.
     bench     hpx_tpu_torch/tools/bench.py's five metrics once (one
               chain at each end of each slope): the triad and copy
               streams at 2^24, kernel 2 at 2^24 (and its device time
               by events), the FFT at 2^22, kernel 9 at 2^17 x 1024 and
               kernel 1 at 2^19 x 1024, the headline last.
     algorithms
               senders and the one-device algorithms on cuda:0 (no
               kernel of the 9: torch's sort, scans, searchsorted, topk
               and FFT, as the reference uses XLA's):
               config #3, the STREAM triad a = b + 3*c by
               hpx.transform(par.on(cuda_executor()), pv_b, f, pv_c)
               over partitioned_vectors of 2^24 f32 in 4 partitions on
               the card, enqueued under sync debug mode "error", the
               result a PartitionedVector with the source's layout
               within 2.5e-7 relative of float64 numpy, its GB/s by
               the slope of 64 and 640 dependent dispatches; sort of
               f32 with NaN of both signs, -0.0 and +0.0 planted, of
               int32 and with key=abs, partial_sort_copy(k = 1024) by
               IEEE total order, unique and partition at 2^24, bit for
               bit against numpy; inclusive and exclusive + scans at
               2^24 (int32 exact, also by a general op; f32 within
               i*eps*sum|a[0..i]| of float64); the five set operations
               on sorted int32 multisets of 2^22 against numpy's
               counts; unique, partition and each set operation
               synchronizing exactly once (sync debug mode "warn");
               fft_sharded / ifft_sharded of 2^22 complex64 on a
               one-rank mesh (forward within 1e-4 of float64 numpy by
               the norm, round trip within 1e-5); and sync_wait(
               schedule(cuda_scheduler()) | then_on_device(f) |
               bulk(2^22, g)) equal to its CPU run, then_on_device's
               value delivered by the watcher after its CUDA event
               (not ready while the card is held busy); and
               for_each(seq, pv, f) over a vector of 1000 f32 on the
               card: a host policy works on a copy, the result bit for
               bit f over numpy, the vector unchanged on the card.
     serving   ContinuousServer(paged=True) on cuda:0 at the full width
               of the repo's serving model (benchmarks/serving_bench.py
               at --scale 16: vocab 1024, d_model 1024, 8 heads of 128,
               4 layers, d_ff 4096; random weights from seed 0), on
               (a) serving_bench's paged mix: 12 requests sharing a
                   64-token prefix plus 8-token tails, max_new 16-32,
                   4 slots, smax 160;
               (b) a long-context mix: 16 prompts of 256-768 tokens,
                   max_new 64, 8 slots, smax 1024, block_size 16;
               each in float32 through paged_kernel fused (kernel
               paged_attention_exact), fused_online (kernel
               paged_attention_online) and gather, and the dense server;
               then (b) in float32 with blocks of 256 rows (a shape
               the first split design refused): auto, resolved to
               fused when the server is built, fused_online and
               gather, each kernel's plan walking a block in 2 parts;
               then (b) in bfloat16 with paged_kernel auto (-> fused)
               beside a bfloat16 gather run.
     resilient the fault ladder on (a) and (b) in float32: the dense,
               fused, fused_online and speculative fused servers, each
               fault-free and under a seeded injector (FAULT_SEED,
               FAULT_RATE, at most FAULT_MAX faults over the decode,
               prefill, verify and alloc sites; (b)'s paged servers
               also with alloc disarmed): tokens equal to the
               fault-free run's, nothing shed, a restore at every
               decode, verify and later prefill fault, as many CUDA
               graphs captured, no block leaked; two verify faults turn
               speculation off; a 15-block pool defers admissions and
               completes equal. Then "traced serving": (a) under
               svc.tracing, the Chrome trace exported and validated;
               the tracer's cost on (b) (tokens/s, A B B A) and a rate-0
               injector's (host ms a decode step); profile_trace's
               trace naming kernel 3. The numbers print as one
               "resilience: {...}" line before the kernels line.
     training  make_train_step at the full width of the repo's training
               model (bench.py:516-528: vocab 32768, d_model 512, 8 heads
               of 64, 4 layers, d_ff 2048, MHA, no rope; random weights
               from seed 0, one fixed batch of 8 x 1024 tokens from
               seed 1): 10 bfloat16 SGD steps (lr 0.01), each launching
               each flash kernel once a layer, that lower the loss; 3
               Adam steps (torch.optim.Adam, lr 1e-3) that lower it.
     ring      the same model, batch and weights through the sharded
               step, make_train_step(cfg, make_mesh_3d(4)) = (dp 1, sp
               2, tp 2): 4 ranks started by hpx_tpu_torch's launcher
               (gloo on one card, nccl with a card a rank). 10 bf16 SGD
               steps that lower the loss, each launching
               flash_attention_chunk (kernel 8) and flash_attention_bwd
               (kernels 6-7 in one) 8 times a rank (2 ring steps x 4
               layers), the flash forward and the f32 backward kernels
               never; 3 more with the time in collectives and
               in host staging copies measured; one striped_ring step
               whose loss agrees with the contiguous one within 5e-3
               relative; then in f32 (batch 2 x 1024), contiguous and
               striped, its loss within 1e-5 relative and every
               gradient within 1e-5 by the norm of the single-device
               step's on this card (kernels 5-7), a left-out fold of a
               past chunk (contiguous) and offsets all 0 (striped)
               reading above that limit. On one card the step's host
               time is four processes time-slicing it: not a training
               rate.
     MoE serving
               the repo's MoE model (benchmarks/serving_bench.py:633-637
               at --scale 16: vocab 1024, d_model 1024, 8 heads of 128,
               2 layers, d_ff 2048, 4 experts, top-2, moe_capacity 4.0;
               random weights from seed 4) on ContinuousServer(slots=4,
               smax=128): 8 requests of 24 seeded prompt tokens and 48
               new ones, in f32 dense and paged through gather, fused
               (kernel 3) and fused_online (kernel 4), and in bf16
               fused and gather, each server run twice (graphs captured,
               then replayed; tokens/s of both). The f32 tokens of all
               four equal each other and generate()'s (the 8 prompts in
               one batch, two alone); every run drop-free (0 claims
               dropped, the server's _moe_routed / _moe_dropped /
               _moe_occ printed); kernels 3-4 against their plain
               versions on each server's pools at its decode shape; a
               captured decode step's time (events around replays)
               beside the MoE FFN's and the dense MLP's (one expert's
               width) a layer at its 4 rows, in a graph; once more with
               hpx.serving.moe.capacity_factor = 100 (cf 1.0), which
               must drop claims.
     MoE training
               the training model with 4 experts, top-2, capacity 4.0
               (__graft_entry__.py:262-263), bf16, batch 8 x 1024
               through make_train_step(cfg), captured: the [T, E, C]
               tensors' bytes reckoned first (T 8192, C 16384; the phase
               fails, saying what it needs, if they do not fit: no
               smaller batch); 3 SGD steps whose loss falls, each
               launching the flash forward and backward once a layer;
               step ms, peak memory; the MoE FFN's forward at T 8192
               beside the dense MLP's, each in a graph.
     expert parallelism
               the same MoE model in f32, batch 2 x 1024, on 4 ranks
               (gloo on one card, nccl with a card a rank) over Mesh((2,
               1, 2)) and Mesh((2, 2, 1)) of ("dp", "sp", "tp"): experts
               over dp, each expert's d_ff over tp; the loss within 1e-5
               relative and every gradient, unsharded, within 1e-5 by
               the norm of the single-device step's (aux weight 0: the
               Switch aux is a per-rank statistic; drop-free on both
               sides); flash forward and f32 backward a layer on (2, 1,
               2), the chunk fold (kernel 8) and the f32 backward sp
               times a layer on (2, 2, 1); a planted fault (every
               gradient summed over dp and sp, the experts' too) must
               read above the limit; collectives' share of 3 more steps.
     Ulysses and the sharded stencil
               4 ranks: ulysses_attention over sp 4 at the ring path's
               shape ([8, 1024, 8, 64], causal), forward and backward in
               f32 and bf16, flash (kernels 5-7) on each head group,
               against one-rank flash_attention on the card (f32 1e-5
               forward, 1e-4 backward; bf16 2e-2 and 5e-3 by the norm);
               kernels 5-7 against their plain versions at the head
               group's shape; the exchanges' ms beside the flash
               forward's; sharded_multistep at 2^24 cells, 16 steps,
               halo_steps 1 and 4, coef 0.3, bitwise equal to its run on
               make_mesh((1,)).
     pipelined training
               make_pipelined_train_step on 4 ranks (gloo on one card,
               nccl with a card a rank) over ("dp", "pp") (1, 4) and
               (2, 2) interleaved 2, and ("dp", "pp", "tp") (1, 2, 2), M
               4 microbatches: the training model at full width in bf16,
               8 x 1024, PP_STEPS steps whose loss falls, each rank's
               launches a step equal to the schedule's (kernel 5 2 M L/pp:
               the forward and the backward walk's remat; kernels 6-7 M
               L/pp), the step's host ms and its share in
               torch.distributed's verbs; then f32 at 4 x 1024: the loss
               within PP_LOSS_REL relative and the updated weights,
               unstacked and deinterleaved, within PP_WEIGHT_REL by the
               norm of the single-device step's on the same weights and
               batch, and two planted faults (the backward hop sent to
               the next member, the embedding's gradient unsummed over
               pp) reading above PP_FAULT_READ; kernels 5-7 against their
               plain versions at a stage's microbatch shape.
     Jacobi    config #5 at 8192^2 f32, 100 sweeps: jacobi_serial,
               jacobi_dataflow over 8 row blocks on a BlockExecutor of the
               card's targets and jacobi_sharded on a 2 x 2 mesh of 4
               ranks (100 and 25 sweeps a dispatch), bitwise equal (the
               ranks' blocks by SHA-256), the residual within n eps,
               Mcells/s of each; ghosts that never arrive must differ.
     FFT       fft_sharded / ifft_sharded of 2^22 complex64 over 4 ranks
               and fft2_sharded_2d of 2048^2 on a 2 x 2 mesh, within
               1e-4 of float64 numpy and of the one-rank transform; ms a
               transform and the exchanges' share.
     distributed sort and the multi-rank vector
               in the FFT's world: sort_sharded of 2^24 f32 by "sample"
               and "odd_even", bitwise np.sort(kind="stable"), ms a sort,
               the verbs' share and counts; NaN / -0.0 / +-inf sorts and
               by-key NaN payloads; config #3's triad over a 4-rank
               vector (no verb, GB/s a rank); reduce, inclusive_scan
               (bitwise, integers), minmax with a NaN, count and
               partition on a vector that fills its layout; five planted
               faults that must fail their checks.
     sharded serving
               ContinuousServer(mesh=Mesh((2, 2), ("dp", "tp"))) on 4
               ranks (gloo on one card, nccl with a card a rank) at the
               serving model's full width, every rank building the same
               server and submitting the same requests: mix (a) f32
               dense, fused (kernel 3), fused_online (kernel 4) and int8
               pools, (b) f32 fused and n-gram speculative (k SPEC_K),
               (a) and (b) bf16 fused, and the MoE model dense and fused
               with its experts over tp. Every rank's f32 tokens equal
               the one-rank server's on this card (bf16: how many are
               equal is printed), the MoE claims routed and dropped
               equal, no CUDA graph captured (gloo); kernels 3-4 launched
               n_layers times a decode step and a verify window on every
               rank (2 or 4 slots and 4 kv heads of 128 a rank), the
               profiler's records of kernel 3 (device records only, after
               TRACE_LEAD_IN spin launches and a TRACE_MARGIN_S margin)
               equal to its count on each rank; both kernels against
               their plain versions on the int8 and bf16 runs' pools at
               the rank's shape; tokens/s, and over a fenced run of (a)
               the share in torch.distributed's verbs and host ms a
               decode step (4 gloo ranks sharing one card: not a
               scaling number); the tp close after wo left out and dp
               rank 1's table rows shifted by a slot must each change
               tokens.
   Each stencil kernel's output must equal its plain version on the same
   inputs bit for bit; the dataflow result must equal stencil_serial;
   the fused result must conserve the sum, and a small run must agree
   with a float64 numpy reference. The float32 serving tokens of both
   kernels must equal the gather run's and the dense server's, the
   prefix mix must hit the radix tree, and two requests must equal
   transformer.generate run alone; the bfloat16 run prints its
   agreement with the bfloat16 gather run, and both kernels are held to
   their plain versions on the pools it left.
   The flash kernels (5-7) are also checked against their plain versions
   on (sq, sk) in {(1, 1), (37, 53), (48, 16), (16, 48), (1024, 1024)},
   and, to cross the bf16 forward's 128-row tiles, (129, 129), (200,
   200), (1, 200), (300, 129), (1000, 1000), causal or not, MHA and GQA
   (8 q heads over 2), head dims 64 and 128, f32 and bf16 (the forward
   flash_fwd_tf32x3 in f32, flash_fwd_wgmma in bf16), the backward
   at offsets d in {sk - sq, 0, -16}, each given the o and L of the
   forward at its own offset (so p <= 1, as the ring gives them):
   flash_attention_bwd (one kernel: flash_bwd_tf32x3 in f32,
   flash_bwd_wgmma in bf16) against plain_flash_bwd; the f32 forward
   built with the big·big product alone (1xTF32) must read above 1e-5,
   and the f32 backward built so and with the dq partials of key tile 0
   left out must each read above 1e-4, on every S 1024 case; the
   forward's shared-memory sizes in attention_cuda.py must equal the
   source's; the bf16 backward also at B 8 (grids
   of 132 CTAs or more), MHA and MQA (8 q heads over 1), on (sq, sk) in
   {(300, 300), (1000, 1000), (257, 1029), (1, 1029)} at every offset;
   rtol = atol = 1e-5 for the f32 forward (o and L), 1e-4 for the
   f32 backward, 2e-2 in bf16, and in bf16 also ||got - want|| /
   ||want|| <= 5e-3 (a skipped 64-row tile, a skipped 128-key tile of
   the bf16 forward, the dq partial of one 128-key tile of the bf16
   backward left out, all simulated on the S 1024 inputs, and the bf16
   forward built to release each K/V stage before its P V completed,
   at H 64 and at H 128 with 128-row CTAs, must read above that); the
   bf16 forward's plain version folds keys in the kernel's tiles of
   128; the bf16 forward's 128-row CTAs (two consumer warpgroups, H
   128, B 8 x 8 heads so that the plan takes them) on (sq, sk) in
   {(300, 300), (600, 664), (664, 600), (1000, 1000), (257, 1029)},
   causal or not, MHA and GQA; and flash_attention's gradients
   through the kernels against the same autograd Function over the
   plain versions.
   The chunk kernel (8) is checked against its plain version on (sq, sk)
   in {(64, 64), (37, 53), (129, 200), (200, 129), (512, 512)}, causal
   at d in {sk, 0, -1, -sq}
   and not causal, MHA and GQA, head dims 64 and 128, f32 and bf16, from
   a carry an earlier fold left: acc in bf16 at 2e-2 and by the norm
   (where a skipped key tile of the kernel's must read above the
   limit), in f32 as acc / l (the o the ring makes of the unnormalized
   carry) at 1e-5, its raw elementwise reading printed; m and l at
   1e-5; in f32 also at (1024, 1024), H 64 and 128, MHA and GQA,
   causal at d = 0 and not, where flash_fwd_tf32x3's chunk fold built
   with the big·big product alone (1xTF32) and with key tile 0 left out
   must each read above 1e-5; at the 128-row CTAs (bf16, H 128, B 8 x 8
   heads, (300, 300) and (600, 664), d in {sk, 64, 0, -64, -sq}); and
   at the ring path's own shape (q [32, 512, 64] bf16, causal) at d in
   {0, 512, -512}.
   Before the ring path, 2 ranks try over gloo, on CUDA tensors as they
   are, every torch.distributed verb that collectives.device.GLOO_CUDA
   hands over unstaged: each must run and agree.
   Then the training width in f32 (batch 2 x 1024), a main path of its
   own (the f32 routes run only there and in the ring's f32 gates:
   flash_fwd_tf32x3, kernel 5's, once a layer a gradient and a step;
   flash_bwd_tf32x3, kernels 6 and 7's, once a layer; in each of the
   ring's f32 gates kernel 8's chunk fold and flash_bwd_tf32x3 8 times
   a rank), its launches counted with the others' and the f32 forward's
   and chunk fold's apart from their bf16 ones:
   the loss through the kernels within 1e-5 relative of the loss through
   their plain versions, every weight's gradient within 1e-5 by its norm
   (a dq zeroed on purpose must read above that), and the weights after
   one SGD step each way within rtol = atol = 1e-5.
   The server's decode step (greedy and sampled), its prefill chunk a
   ladder width and its probe, and the single-device SGD step run as
   replays of CUDA graphs (core/programs.GraphProgram), captured at the
   first call of a signature: every serving and training path above
   runs them so, each server capturing at most a graph a ladder width
   + 3 (count_captures). Phase "program captures": after mix (a) on f32
   dense, fused and fused_online servers (whose second run of the same
   requests captures a graph only at a signature it had not seen, none
   for the dense server), each captured program and the f32 SGD step
   (batch 2 x 1024) are replayed on the same inputs and state as their
   .eager program: tokens equal, every float result (logits, loss, the
   caches, pools and weights written) within 1e-6 of the eager one's
   by max |diff| / max |eager|; the bf16 SGD step's readings printed.
   Profiles: mixes (b) and (a) in bf16 and the bf16 training step, each
   eager and captured in the order eager, captured, captured, eager (ms
   a step on the host clock), then each once under torch.profiler
   (device busy share; host-issued launches a step: kernel and graph
   launches and copies); and hpx_tpu_torch/tools/algo_profile.py's
   profiles give config #3's and the FFT's (kernels by device time,
   launches a call).
4. Timing: each kernel at its main-path shape, CUDA events around runs
   of back-to-back calls (as many as fill about 2 ms), median of 7 runs
   after warm-up (kernel 9 at 2^17 x 1024, bound by its operations: 24 a
   step and element at 67 TFLOP/s; kernel 1 at 2^27 x 64 and 2^19 x
   1024, with the wrapper's host ms a call (the wall clock of calls made
   while the card is held busy) and the instruction bound, its 4 FP32
   instructions a cell update at 33.5 x 10^12 a second (132 SMs x 128
   lanes x 1.98 GHz), beside the operations bound); its plain version,
   median of 3; and its bound, the
   larger of bytes moved (input read once, output written once) over
   3.35 TB/s and operations over the peak of their type (H100 SXM data
   sheet: 67 TFLOP/s FP32, 989 TFLOP/s bf16). The paged kernels are
   timed at the full-width decode shape (B 8, W 1, 8 heads of 128,
   block 16) at S 1024 with bfloat16 and int8 pools and at S 8192 with
   bfloat16 pools, beside F.scaled_dot_product_attention on K/V gathered
   beforehand (the gather not counted), as a yardstick the port never
   calls: CUDA events around a CUDA graph of the calls (the wrappers'
   host work outlasts the kernels), each call on the next of several
   copies of the pools so that it finds L2 cold, with the warm time,
   CUDA-event time of back-to-back calls and host enqueue time beside
   it, and the time with every slot at position 0 and by P; the bound
   counts the live rows (positions up to pos0 + W - 1) and the live
   blocks' table entries and scales (the all-block bound is printed
   beside it).
   The flash kernels are timed in bfloat16, causal, at the training
   shape (B 8, S 1024, 8 heads of 64) and at bench.py:448's (B 2,
   S 4096, 8 heads of 128), their operations counted over the visible
   (query, key) pairs, beside SDPA (is_causal); each kernel's time is
   its device time, CUDA events around a CUDA graph of 20 calls (the
   wrapper's host work, a plan and TMA tensor maps a call, can outlast
   the kernel), and SDPA's library time is taken the same way, with the
   back-to-back event times, SDPA's profiler time and the wrapper's host
   time a call (the wall clock of calls made while the card is held
   busy) beside them; the timed inputs are held against the plain
   version first. The backward (kernels 6-7, one launch) is timed
   alone and as the whole route of _FlashAttention.backward (delta,
   the dq fill, the kernel, the casts), beside SDPA's flash backward
   (aten._scaled_dot_product_flash_attention_backward on the saved
   outputs of its forward) by the same graph; its bound counts the
   function's least work (10 operations a visible pair and head
   element; q, k, v, do, L, delta read and dq, dk, dv written once in
   f32), the split kernels' (14 operations) printed beside; and at the
   ring's shape (q [32, 512, 64], d = 0 and 512).
   Kernel 8 is timed the same
   way at the ring's shape (q [32, 512, 64] bf16, causal) at d = 0 and
   d = 512. The f32 routes of kernels 5-8 (flash_fwd_tf32x3, the
   forward and its chunk fold, and flash_bwd_tf32x3, all 3xTF32 on the
   tensor cores; the backward alone and as the whole f32 route of
   _FlashAttention.backward) are timed by the same graph at the
   training shape and at the ring's (d = 0), their bound at 67 TFLOP/s
   FP32 and at 495 TFLOP/s TF32 for their TF32 operations (12 a pair
   and head element in the forward and fold, 30 in the backward),
   SDPA's f32 forward and autograd backward beside them, with the
   library kernels the profiler names; the kernels line carries them as
   each flash row's "f32". No single
   PyTorch call folds a chunk into a carry, so it has no library
   yardstick. Every other library yardstick (but kernel 5's) is device
   time under
   torch.profiler: a library call's host work (autograd, dispatch) can
   outlast its kernels, and events would then time the host; where three
   traces record no device time it is CUDA-event time, and each row's
   library_by says which ("profiler" or "events"). The
   training step is timed on the host clock (median of the
   bf16 steps after 2 warm-ups).
5. Prints the bench lines ("bench: {...}"), the resilience and MoE
   numbers ("resilience: {...}", "moe: {...}": the MoE, expert-parallel,
   Ulysses and stencil phases' readings, times and stats), the
   pipelined, Jacobi and FFT phases' ("multirank: {...}"), the sharded
   serving phase's ("sharded: {...}"), {"kernels": [...]} (the flash rows
   with their launches on the pipelined path beside, the paged rows with
   theirs on the sharded server) and, last, {"ok": true, "device": ...}.

Exits non-zero, and prints no result line, if CUDA is absent, if the
package cannot be imported, or if any phase fails.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import itertools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
import traceback

HBM_BYTES_PER_S = 3.35e12     # H100 SXM, device memory
FP32_OPS_PER_S = 67e12        # H100 SXM, FP32 outside the tensor cores
BF16_OPS_PER_S = 989e12       # H100 SXM, bf16 tensor cores, dense
TF32_OPS_PER_S = 495e12       # H100 SXM, TF32 tensor cores, dense
FLOPS_PER_CELL_STEP = 5       # 2u, one add, one sub, one fma (2 operations)
# FP32 instructions of a cell update of kernel 1 (FMUL, FSUB, FADD, FFMA)
# and the card's FP32 issue rate: 132 SMs x 128 lanes x 1.98 GHz
FP32_INSTR_PER_CELL_STEP = 4
FP32_INSTR_PER_S = 33.5e12

# paged-attention wrapper -> the TPU kernel its CUDA kernel replaces
PAGED_KERNELS = {
    "fused_paged_attention": "hpx_tpu/ops/attention_pallas.py:908",
    "fused_paged_online_attention": "hpx_tpu/ops/attention_pallas.py:972",
}
# (rtol, atol) of a paged kernel against its plain version, by output type
PAGED_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-2, 1e-2)}
# profiled runs a trace is taken in, where one comes short of the
# wrappers' counts (see trace_short)
TRACE_ATTEMPTS = 3
# seconds of host-only time at each end of a trace whose kernel records
# are held to the wrappers' counts: the profiler keeps only device
# records it places inside its window, and it has placed kernels
# milliseconds before their own launches (H100, torch 2.11 + CUDA 12.8),
# which dropped the first kernels of a trace whose work began at its
# start; late in a whole run it also held no record of the first 2.5 ms
# of work that began 0.25 s into its window (the eager training trace's
# first 15 launches, in every attempt; NVIDIA H100 80GB HBM3, 700.00 W),
# so the margin is 1 s
TRACE_MARGIN_S = 1.0
# uncounted launches of the spin kernel (torch.cuda._sleep) that open the
# work of every such trace, after its margin, under a "trace lead-in"
# range: late in a whole run the profiler held no device record of the
# first 15-17 launches of a trace's work, margin or not (252-254 ms after
# a 0.25 s margin, 1002-1004 ms after a 1 s one, in every attempt;
# NVIDIA H100 80GB HBM3, 700.00 W), so the lead-in takes their place;
# the lead-in's records and launches are left out of every figure, and
# each counted trace prints how many of its launches lost their record
TRACE_LEAD_IN = 2000
# bench.py:516-528, the repo's training model
TRAIN_MODEL = dict(vocab=32768, d_model=512, n_heads=8, head_dim=64,
                   n_layers=4, d_ff=2048, lr=0.01)
# flash wrapper -> the TPU kernel(s) its CUDA kernel replaces: the bf16
# backward is one kernel for kernels 6 and 7, a row of the kernels line
# each
FLASH_KERNELS = {
    "flash_attention_fwd": ("hpx_tpu/ops/attention_pallas.py:112",),
    "flash_attention_bwd": ("hpx_tpu/ops/attention_pallas.py:397",
                            "hpx_tpu/ops/attention_pallas.py:446"),
}
# the kernels line's names of flash_attention_bwd's two rows
BWD_ROWS = ("flash_attention_bwd (dq)", "flash_attention_bwd (dk, dv)")
# the backward's f32 route: its wrapper (kernel flash_bwd_tf32x3)
FLASH_F32_BWD = ("flash_attention_bwd_f32",)
# a flash row of the kernels line -> the wrapper of its f32 route
F32_ROUTE = {"flash_attention_fwd": "flash_attention_fwd",
             "flash_attention_bwd (dq)": "flash_attention_bwd_f32",
             "flash_attention_bwd (dk, dv)": "flash_attention_bwd_f32",
             "flash_attention_chunk": "flash_attention_chunk"}
# the ring's chunk kernel -> the TPU kernel its CUDA kernel replaces
CHUNK_KERNEL = {"flash_attention_chunk": "hpx_tpu/ops/attention_pallas.py:618"}
# the FP32 rate probe -> bench_vpu_rate's Pallas kernel it replaces
FMA_KERNEL = {"fma_chain": "bench.py:339"}
# config #1 (examples_cuda/saxpy_cuda.py) at the size it runs by default
SAXPY_LOG2N = 22
# (rtol, atol) of a flash kernel against its plain version: f32 forward,
# f32 backward (sums of up to Sk terms of exp(s - L)), bf16
FLASH_TOL = {"fwd": (1e-5, 1e-5), "bwd": (1e-4, 1e-4), "bf16": (2e-2, 2e-2)}
# the bf16 flash outputs are held a second time by their norm:
# ||got - want|| / ||want|| <= FLASH_NORM_REL, the norm taken as at least
# NORM_FLOOR * sqrt(n) (an output that is itself rounding noise, as dq
# where each row sees one key and dp - delta cancels, stays with the
# elementwise limit). One skipped 64-row tile must read above it.
FLASH_NORM_REL = 5e-3
NORM_FLOOR = 1e-4
# per-leaf ||g_kernels - g_plain|| / ||g_plain|| of the f32 training
# gradients; a zeroed dq must read above it
GRAD_NORM_REL = 1e-5
# a CUDA-graph replay against its eager program, f32: max |replay -
# eager| / max |eager| of each logit, loss and weight tensor
CAPTURE_REL = 1e-6
# f32 tokens of two decoders may differ only at a near-tie: where they
# do, the top-2 gap of the target's logits at the first differing pick
# must be below this (the window and the sequential forwards round
# apart by ~1e-6 of the logits)
TIE_GAP = 1e-4
# speculative serving: draft tokens a slot and step (verify width: the
# ladder's rung for 1 + SPEC_K, 8)
SPEC_K = 4
# the resilient-serving phase's seeded injector: sites, seed, rate and cap
FAULT_SITES = ("decode", "prefill", "verify", "alloc")
FAULT_SEED = 15
FAULT_RATE = 0.05
FAULT_MAX = 8
# benchmarks/serving_bench.py:633-637 at its default --scale 16: the
# repo's MoE model, and its load (8 requests, 24-token prompts from a
# seed, 48 new tokens each) on ContinuousServer(slots=4, smax=128)
MOE_MODEL = dict(vocab=1024, d_model=1024, n_heads=8, head_dim=128,
                 n_layers=2, d_ff=2048, n_experts=4, moe_top_k=2,
                 moe_capacity=4.0)
MOE_REQS, MOE_PROMPT, MOE_NEW, MOE_SEED = 8, 24, 48, 4
MOE_SERVER = dict(slots=4, smax=128)
# the MoE knobs of __graft_entry__.py:262-263 on the training model
TRAIN_MOE = dict(n_experts=4, moe_top_k=2, moe_capacity=4.0)
# the expert-parallel f32 gate: batch rows, and the meshes (dp, sp, tp)
EP_BATCH = 2
EP_MESHES = ((2, 1, 2), (2, 2, 1))
# Ulysses at the ring path's shape [B, S, N, H] over sp = 4; the sharded
# stencil's cells and steps over 4 ranks
ULYSSES_SHAPE = (8, 1024, 8, 64)
STENCIL_CELLS, STENCIL_STEPS = 1 << 24, 16
# the pipelined step on 4 ranks: (mesh shape, axis names, microbatches M,
# interleave V); bf16 steps a mesh; the f32 gate's batch rows (the
# interleaved gate on dp 2 needs M = pp = 2 rows a dp shard)
PP_MESHES = (((1, 4), ("dp", "pp"), 4, 1), ((2, 2), ("dp", "pp"), 4, 2),
             ((1, 2, 2), ("dp", "pp", "tp"), 4, 1))
PP_STEPS = 4
PP_F32_BATCH = 4
PP_LOSS_REL = 1e-6          # the f32 loss against the single-device step's
PP_WEIGHT_REL = 1e-5        # the updated weights, by the norm
PP_FAULT_READ = 0.1         # a planted fault's update reading must pass it
# config #5: the 2-D Jacobi grid, sweeps and row blocks; the sharded
# variant's sweeps a dispatch
JACOBI = dict(nx=8192, ny=8192, nb=8, iterations=100)
JACOBI_SPD = (100, 25)
# the multi-rank FFT: the 1-D length and the 2-D side
FFT_N, FFT2_SIDE = 1 << 22, 2048
FFT_TOL = 1e-4
# the distributed sorts and config #3's triad over 4 ranks (2^22 f32 a
# rank); the vector of the segmented checks and of the scan's and
# reduce's planted faults, which fills 8 partitions; the planted faults'
# sorts; the small sorts of NaN, -0.0, +-inf
DSORT_N, DVEC_N, DFAULT_N, DSMALL_N = 1 << 24, 1 << 22, 1 << 18, 1024



def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Milliseconds a call of fn() by CUDA events, after warm-up: the
    median over ``reps`` runs of back-to-back calls, each run as many
    calls as fill about 2 ms (at least one), so that the host's work
    between launches overlaps the device's instead of being timed."""
    import torch

    def run(n: int) -> float:
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) / n
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    calls = max(1, min(50, math.ceil(2.0 / run(1))))
    return statistics.median(run(calls) for _ in range(reps))


def _graph_ms(calls, reps: int = 7) -> float:
    """Milliseconds a call by CUDA events around replays of one CUDA graph
    that holds ``calls`` (functions of no argument, each launching work)
    in order: the median over ``reps`` replays, over the number of calls.
    The host's work for each call (argument checks, allocation, the
    launch) stays out of the timing; the graph's launch of each node is
    in it. For kernels whose wrappers' host work outlasts them."""
    import torch
    for c in calls:                 # warm-up, outside the capture
        c()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for c in calls:
            c()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / len(calls))
    del graph
    return statistics.median(times)


def _host_ms(fn, reps: int = 7, calls: int = 20) -> float:
    """Host milliseconds a call of fn(): the wall clock around ``calls``
    calls made while the card is held busy (``torch.cuda._sleep``), so
    that no call waits on the device; median over ``reps``. The wrapper's
    checks, allocation, plan and launch, not the kernel."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(100_000_000)    # tens of ms of device work
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) * 1e3 / calls)
        torch.cuda.synchronize()
    return statistics.median(times)


def _device_ms(fn, reps: int) -> tuple:
    """(device milliseconds a call of fn(), "profiler"): the kernels'
    summed device time under torch.profiler over ``reps`` calls, after a
    warm-up. For library calls whose host work (autograd) outlasts their
    kernels, so that CUDA events would time the host. Where three traces
    record no device time: (CUDA-event milliseconds, "events"), host
    work included, and the method travels with the number."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):          # a trace that recorded no device time
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        dev_us = sum(e.self_device_time_total for e in prof.key_averages()
                     if e.device_type != torch.autograd.DeviceType.CPU)
        if dev_us > 0:
            return dev_us * 1e-3 / reps, "profiler"
    print("   the profiler recorded no device time in 3 traces: CUDA events "
          "instead (host work included)", flush=True)
    return _cuda_ms(fn, reps), "events"


def _ptxas_report(log: str):
    """(kernel, "R registers, S bytes spilled") for each entry function
    in nvcc's -Xptxas -v log; the kernel as its name and template
    arguments, cut out of the mangled symbol."""
    kernel, spill = None, "0"
    for line in log.splitlines():
        m = re.search(r"entry function '(\w+)'", line)
        if m:
            sym = m.group(1)
            n = re.search(r"_cu_[0-9a-f]{8}(\d+)([A-Za-z_]\w*)", sym)
            kernel = sym
            if n:
                name = n.group(2)[:int(n.group(1))]
                rest = n.group(2)[int(n.group(1)):]
                lits = re.match(r"I((?:L[a-z]\d+E)+)E", rest)
                targs = (",".join(re.findall(r"L[a-z](\d+)E", lits.group(1)))
                         if lits else rest[1:rest.find("E")]
                         if rest.startswith("I") else "")
                kernel = f"{name}<{targs}>" if targs else name
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and kernel:
            yield kernel, f"{m.group(1)} registers, {spill} bytes spilled"
            kernel, spill = None, "0"


def _norm_rel(got, want) -> float:
    """||got - want|| / ||want||, the norm of want taken as at least
    NORM_FLOOR * sqrt(n); 0 for empty tensors."""
    if not want.numel():
        return 0.0
    g, w = got.double(), want.double()
    den = max(w.norm().item(), NORM_FLOOR * math.sqrt(w.numel()))
    return (g - w).norm().item() / den


def _bound(nbytes: float, ops: float,
           ops_per_s: float = FP32_OPS_PER_S) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _comm_split(step, dev, n: int) -> dict:
    """Host seconds of ``n`` calls of ``step`` (one training step on a
    rank), and of that the time inside torch.distributed's verbs
    (transfers, gloo's host reductions, waiting for peers) and inside
    collectives.device's host staging copies; and the verbs' calls, by
    verb, a call of ``step`` (``verbs``). Each timed call is fenced
    by synchronize() on both sides, so it does not count the card's
    queued compute; the fences cost the step some overlap."""
    import torch
    import torch.distributed as dist
    from hpx_tpu_torch.collectives import device as cd
    acc = {"comm": 0.0, "copies": 0.0}

    class TimedWait:
        """A point-to-point request whose wait() is timed (a request may
        be waited on once only)."""

        def __init__(self, req):
            self.req = req

        def wait(self):
            t0 = time.perf_counter()
            self.req.wait()
            torch.cuda.synchronize(dev)
            acc["comm"] += time.perf_counter() - t0

    def timed(fn, what, verb=None):
        def run(*a, **kw):
            if verb is not None:
                calls[verb] += 1
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            r = fn(*a, **kw)
            torch.cuda.synchronize(dev)
            acc[what] += time.perf_counter() - t0
            # batch_isend_irecv: the transfers end in the waits
            return [TimedWait(q) for q in r] if isinstance(r, list) else r
        return run
    verbs = ("all_reduce", "all_gather", "broadcast", "all_to_all_single",
             "reduce_scatter", "batch_isend_irecv")
    saved = {v: getattr(dist, v) for v in verbs}
    calls = dict.fromkeys(verbs, 0)
    saved_cd = (cd._host, cd._home)
    for v in verbs:
        setattr(dist, v, timed(saved[v], "comm", v))
    cd._host, cd._home = (timed(f, "copies") for f in saved_cd)
    try:
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize(dev)
        total = time.perf_counter() - t0
    finally:
        for v in verbs:
            setattr(dist, v, saved[v])
        cd._host, cd._home = saved_cd
    return {"step_ms": total / n * 1e3, "comm_ms": acc["comm"] / n * 1e3,
            "copies_ms": acc["copies"] / n * 1e3,
            "verbs": {v: c // n if c % n == 0 else c / n
                      for v, c in calls.items()}}


def _ring_rank(f32_batch: int) -> dict:
    """One rank of the ring path (spawned by hpx_tpu_torch's launcher):
    the training model at full width on make_mesh_3d(4) = (dp 1, sp 2,
    tp 2), weights from seed 0 and the batch from seed 1 made on the
    rank's card as the single-device path makes them.
      1. 10 bf16 SGD steps, each step's kernel launches counted;
      2. 3 more, each collective and each host staging copy timed
         (``_comm_split``), then 3 with every verb staged through host
         memory under gloo;
      3. one bf16 step with striped_ring, for its first loss;
      4. f32, the batch's first ``f32_batch`` rows: the loss and the
         gradients summed over (dp, sp), gathered over tp, of the
         contiguous ring as it is and with a planted fault (rank sp 1
         leaves out its fold of the past chunk), and of the striped ring
         as it is and with every chunk's offset 0, the f32 backward
         kernel's launches counted in each.
    Rank 0 returns the full f32 gradients; every rank its readings and
    the f32 chunk fold's and backward's launches in each f32 gate."""
    import dataclasses
    import torch
    from hpx_tpu_torch.models import transformer as tf
    from hpx_tpu_torch.ops import attention as ao
    from hpx_tpu_torch.ops import attention_cuda as ac
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = tf.make_mesh_3d(4)
    dev = mesh.device
    kern = (ac.flash_attention_chunk, ac.flash_attention_bwd,
            ac.flash_attention_fwd, ac.flash_attention_bwd_f32)
    out = {"rank": mesh.rank, "coords": mesh.coords, "device": str(dev),
           "backend": mesh.backend}

    def sharded(cfg):
        return tf.shard_params(tf.init_params(cfg, seed=0, device=dev), cfg,
                               mesh)
    cfg = tf.TransformerConfig(**TRAIN_MODEL, dtype=torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(1)
    toks, tgts = tf.sample_batch(cfg, 8, 1024, generator=gen, device=dev)
    params = sharded(cfg)
    t, g = tf.shard_batch(toks, tgts, mesh)
    step = tf.make_train_step(cfg, mesh)
    losses, secs, per_step = [], [], []
    torch.cuda.reset_peak_memory_stats(dev)
    for k in kern:
        k.launches = 0
    for _ in range(10):
        before = [k.launches for k in kern]
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        params, loss = step(params, t, g)
        torch.cuda.synchronize(dev)
        secs.append(time.perf_counter() - t0)
        losses.append(float(loss))
        per_step.append([k.launches - b for k, b in zip(kern, before)])
    out.update(losses=losses, secs=secs, per_step=per_step,
               launches={k.__name__: k.launches for k in kern},
               peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30)
    from hpx_tpu_torch.collectives import device as cd
    direct = cd.GLOO_CUDA
    out["split"] = {"as_shipped": _comm_split(lambda: step(params, t, g),
                                              dev, 3)}
    cd.GLOO_CUDA = frozenset()      # every verb staged, for comparison
    try:
        out["split"]["all_staged"] = _comm_split(
            lambda: step(params, t, g), dev, 3)
    finally:
        cd.GLOO_CUDA = direct
    del params, step
    cfg_s = dataclasses.replace(cfg, striped_ring=True)
    ts, gs = tf.shard_batch(toks, tgts, mesh, striped=True)
    _, loss = tf.make_train_step(cfg_s, mesh)(sharded(cfg_s), ts, gs)
    out["striped_loss"] = float(loss)

    cfg32 = tf.TransformerConfig(**TRAIN_MODEL)
    cfg32s = dataclasses.replace(cfg32, striped_ring=True)
    p32 = sharded(cfg32)
    names = [n for n, _ in p32.named_parameters()]
    fold, offset = ac.flash_attention_chunk, ao.ring_offset

    def skip_past(q, k, v, acc, m, l, d, causal=False):
        # planted fault 1: the fold of a past chunk (d > 0) left out
        return (acc, m, l) if d > 0 else fold(q, k, v, acc, m, l, d, causal)
    # the wrapper counts its launches on the module name it stands under
    skip_past.launches = 0

    def all_visible(idx, src, sq, striped):
        # planted fault 2, striped: every chunk at offset 0, so a query
        # sees the key in its own slot of every later shard, a future one
        return 0
    for key, c, fold_fn, offset_fn in (
            ("f32", cfg32, fold, offset),
            ("f32_fault", cfg32, skip_past, offset),
            ("f32_striped", cfg32s, fold, offset),
            ("f32_striped_fault", cfg32s, fold, all_visible)):
        t2, g2 = tf.shard_batch(toks[:f32_batch], tgts[:f32_batch], mesh,
                                striped=c.striped_ring)
        ac.flash_attention_chunk, ao.ring_offset = fold_fn, offset_fn
        before = ac.flash_attention_bwd_f32.launches
        before_fold = fold.launches
        try:
            w, grads, loss = tf._loss_and_grads(p32, t2, g2, c, mesh)
        finally:
            ac.flash_attention_chunk, ao.ring_offset = fold, offset
        out[key + "_launches"] = ac.flash_attention_bwd_f32.launches - before
        out[key + "_chunk_launches"] = fold.launches - before_fold
        full = tf.unshard_params(
            tf._from_named(dict(zip(names, grads)), c.n_layers), c, mesh)
        out[key + "_loss"] = float(loss)
        if mesh.rank == 0:
            out[key + "_grads"] = {n: x.detach().cpu() for n, x in
                                   full.named_parameters()}
        del w, grads, full
    return out


def _gloo_cuda_rank(verbs) -> dict:
    """One of 2 ranks (spawned by hpx_tpu_torch's launcher; on one card
    they share it): each of ``verbs``, torch.distributed verbs that
    collectives/device.py calls, over a gloo group, on float32 and
    bfloat16 CUDA tensors as they are. Returns verb -> None where it ran
    and gave the right result, else the error."""
    import torch
    import torch.distributed as dist
    g = dist.new_group([0, 1], backend="gloo")
    r = dist.get_rank()
    dev = torch.device("cuda", torch.cuda.current_device())
    dts = (torch.float32, torch.bfloat16)

    def mine(dt, rank=r):
        return (torch.arange(8, device=dev) + 10 * rank).to(dt)

    def all_reduce():
        for dt in dts:
            t = mine(dt)
            dist.all_reduce(t, group=g)
            assert torch.equal(t, mine(dt, 0) + mine(dt, 1))

    def all_gather():
        for dt in dts:
            outs = [torch.empty(8, device=dev, dtype=dt) for _ in range(2)]
            dist.all_gather(outs, mine(dt), group=g)
            assert torch.equal(torch.cat(outs),
                               torch.cat([mine(dt, 0), mine(dt, 1)]))

    def broadcast():
        for dt in dts:
            t = mine(dt)
            dist.broadcast(t, src=0, group=g)
            assert torch.equal(t, mine(dt, 0))

    def all_to_all():
        for dt in dts:
            out = torch.empty(8, device=dev, dtype=dt)
            dist.all_to_all_single(out, mine(dt), group=g)
            assert torch.equal(out, torch.cat([mine(dt, j)[4 * r:4 * r + 4]
                                               for j in (0, 1)]))

    def reduce_scatter():
        for dt in dts:
            out = torch.empty(4, device=dev, dtype=dt)
            dist.reduce_scatter(out, list(mine(dt).chunk(2)), group=g)
            assert torch.equal(out,
                               (mine(dt, 0) + mine(dt, 1))[4 * r:4 * r + 4])

    res = {}
    for fn in (all_reduce, all_gather, broadcast, all_to_all,
               reduce_scatter):
        if fn.__name__ not in verbs:
            continue
        try:
            fn()
            torch.cuda.synchronize(dev)
            res[fn.__name__] = None
        except Exception as e:  # noqa: BLE001 - the verb's answer
            res[fn.__name__] = f"{type(e).__name__}: {str(e)[:160]}"
        # printed as it comes: a verb that kills its rank leaves the
        # answers before it
        print(f"   rank {r}: {fn.__name__} on CUDA tensors over gloo: "
              f"{res[fn.__name__] or 'ran and agreed'}", flush=True)
        dist.barrier(group=g)
    return res


# -- mixture-of-experts, expert parallelism, Ulysses and the sharded stencil ---

def _uncounted(kernels):
    """A context in which the kernels' launches (a comparison with their
    plain versions) are not counted: their counters are put back as they
    were on leaving it."""
    @contextlib.contextmanager
    def ctx():
        saved = [k.launches for k in kernels]
        try:
            yield
        finally:
            for k, n in zip(kernels, saved):
                k.launches = n
    return ctx()


def _moe_requests(vocab: int):
    """serving_bench.py's MoE load: 8 requests of 24 seeded prompt tokens
    (ids 1..999) and 48 new tokens each."""
    import numpy as np
    rng = np.random.default_rng(MOE_SEED)
    return [(rng.integers(1, min(1000, vocab), MOE_PROMPT).tolist(),
             MOE_NEW) for _ in range(MOE_REQS)]


def _moe_serve(serving, params, cfg, reqs, **kw):
    """One MoE server run (graphs captured as it goes), then the same
    requests again on the same server (graphs replayed; a paged server's
    radix tree may hold their prompts by then): (tokens, server, first
    run's s, second run's s, the MoE stats of the first run)."""
    import torch
    srv = serving.ContinuousServer(params, cfg, **kw)
    secs, outs, stats = [], [], None
    for _ in range(2):
        for p, m in reqs:
            srv.submit(p, max_new=m)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = srv.run()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        outs.append([out[r] for r in sorted(out)])
        if stats is None:
            stats = (srv._moe_routed, srv._moe_dropped, list(srv._moe_occ))
    if outs[0] != outs[1]:
        raise AssertionError("a MoE server's second run of the same "
                             "requests emitted other tokens")
    return outs[0], srv, secs[0], secs[1], stats


def _ep_rank(shape: tuple, batch: int, fault: bool) -> dict:
    """One rank of the expert-parallel path (spawned by hpx_tpu_torch's
    launcher): the training model with 4 experts (TRAIN_MOE) in f32,
    weights from seed 0 and the batch's first ``batch`` rows from seed 1,
    on Mesh(shape, ("dp", "sp", "tp")): experts over dp, each expert's
    d_ff over tp. The loss and the gradients (unsharded) of one step,
    each flash kernel's launches, and the step's host time split into
    collectives and staging copies over 3 more SGD steps. ``fault``:
    also the gradients with every weight's gradient summed over dp and
    sp (the experts' too, which must be summed over sp only)."""
    import torch
    from hpx_tpu_torch.models import transformer as tf
    from hpx_tpu_torch.ops import attention_cuda as ac
    from hpx_tpu_torch.parallel.mesh import Mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = Mesh(shape, ("dp", "sp", "tp"))
    dev = mesh.device
    cfg = tf.TransformerConfig(**TRAIN_MODEL, **TRAIN_MOE,
                               moe_aux_weight=0.0)
    gen = torch.Generator(device=dev).manual_seed(1)
    toks, tgts = tf.sample_batch(cfg, 8, 1024, generator=gen, device=dev)
    t, g = tf.shard_batch(toks[:batch], tgts[:batch], mesh)
    params = tf.shard_params(tf.init_params(cfg, seed=0, device=dev), cfg,
                             mesh)
    names = [n for n, _ in params.named_parameters()]
    kern = (ac.flash_attention_fwd, ac.flash_attention_bwd_f32,
            ac.flash_attention_chunk, ac.flash_attention_bwd)
    out = {"rank": mesh.rank, "coords": mesh.coords, "device": str(dev),
           "backend": mesh.backend,
           "shards": {n: tuple(w.shape) for n, w in params.named_parameters()
                      if ".moe." in n and n.startswith("layers.0.")}}
    runs = [("f32", tf._grad_axes)]
    if fault:
        runs.append(("f32_fault", lambda spec: tf._DATA_AXES))
    for key, axes in runs:
        for k in kern:
            k.launches = 0
        real, tf._grad_axes = tf._grad_axes, axes
        try:
            _, grads, loss = tf._loss_and_grads(params, t, g, cfg, mesh)
        finally:
            tf._grad_axes = real
        out[key + "_launches"] = {k.__name__: k.launches for k in kern}
        full = tf.unshard_params(
            tf._from_named(dict(zip(names, grads)), cfg.n_layers), cfg, mesh)
        out[key + "_loss"] = float(loss)
        if mesh.rank == 0:
            out[key + "_grads"] = {n: x.detach().cpu() for n, x in
                                   full.named_parameters()}
        del grads, full
    step = tf.make_train_step(cfg, mesh)
    step(params, t, g)
    out["split"] = _comm_split(lambda: step(params, t, g), dev, 3)
    return out


def _ulysses_rank(shape: tuple, steps: int, cells: int) -> dict:
    """One rank of the Ulysses and stencil path: ``ulysses_attention``
    over an "sp" axis of 4 at the ring path's shape ([B, S, N, H] =
    ``shape``, causal), forward and backward, in f32 and bf16, this
    rank's chunk of the output and of dq, dk, dv (flash, kernels 5-7, on
    the head group), each kernel's launches, and the median ms of the
    two exchanges beside that of the flash forward; then
    ``sharded_multistep`` on this rank's block of ``cells`` cells,
    halo_steps 1 and 4, coef 0.3, ``steps`` steps, and its ms."""
    import torch
    from hpx_tpu_torch.collectives.device import all_to_all
    from hpx_tpu_torch.ops import attention as ao
    from hpx_tpu_torch.ops import attention_cuda as ac
    from hpx_tpu_torch.parallel import halo
    from hpx_tpu_torch.parallel.mesh import Mesh, shard_1d
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = Mesh((4,), ("sp",))
    dev, r = mesh.device, mesh.axis_index("sp")
    kern = (ac.flash_attention_fwd, ac.flash_attention_bwd,
            ac.flash_attention_bwd_f32)
    out = {"rank": mesh.rank, "device": str(dev), "backend": mesh.backend}
    for dt in (torch.float32, torch.bfloat16):
        q, k, v, w = _ulysses_inputs(shape, dt)
        ts = [x.chunk(4, 1)[r].contiguous().to(dev).requires_grad_(True)
              for x in (q, k, v)]
        wc = w.chunk(4, 1)[r].to(dev)
        for kk in kern:
            kk.launches = 0
        o = ao.ulysses_attention_sharded(*ts, mesh, "sp", causal=True)
        grads = torch.autograd.grad(torch.sum(o.float() * wc), ts)
        torch.cuda.synchronize(dev)
        tag = str(dt).split(".")[-1]
        out[tag] = {"o": o.detach().cpu(),
                    "grads": [x.cpu() for x in grads],
                    "launches": {kk.__name__: kk.launches for kk in kern}}

        def timed(fn, n=5):
            secs = []
            for _ in range(n):
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize(dev)
                secs.append((time.perf_counter() - t0) * 1e3)
            return statistics.median(secs)
        with torch.no_grad():
            qc, kc, vc = (x.detach() for x in ts)
            heads = [all_to_all(x, mesh, "sp", split_axis=2, concat_axis=1)
                     for x in (qc, kc, vc)]
            launches = [kk.launches for kk in kern]
            out[tag]["a2a_ms"] = timed(lambda: [
                all_to_all(x, mesh, "sp", split_axis=2, concat_axis=1)
                for x in (qc, kc, vc)] + [all_to_all(
                    heads[0], mesh, "sp", split_axis=1, concat_axis=2)])
            out[tag]["flash_ms"] = timed(
                lambda: ac.flash_attention(*heads, True))
            for kk, n in zip(kern, launches):     # timing runs: uncounted
                kk.launches = n
        out[tag]["head_group"] = tuple(heads[0].shape)
    xmesh = Mesh((4,), ("x",))
    local = shard_1d(_stencil_input(cells), xmesh, "x")
    for w_ in (1, 4):
        run = halo.sharded_multistep(xmesh, "x", steps, w_)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        res = run(local, 0.3)
        torch.cuda.synchronize(dev)
        out[f"stencil_h{w_}"] = res.cpu()
        out[f"stencil_h{w_}_ms"] = (time.perf_counter() - t0) * 1e3
    return out


def _ulysses_inputs(shape: tuple, dt):
    """q, k, v and the cotangent weights w, [B, S, N, H] on the CPU from
    seed 21, in ``dt`` (w in f32)."""
    import torch
    cpu = torch.Generator().manual_seed(21)
    q, k, v, w = (torch.randn(shape, generator=cpu) for _ in range(4))
    return q.to(dt), k.to(dt), v.to(dt), w


def _stencil_input(cells: int):
    import torch
    return torch.rand(cells, generator=torch.Generator().manual_seed(5))


def _pp_rank(path: str, f32_batch: int) -> dict:
    """One rank of the pipelined path (spawned by hpx_tpu_torch's
    launcher), on each mesh of PP_MESHES in turn:
      1. the training model in bf16, weights from seed 0, the batch of
         8 x 1024 from seed 1 (as the single-device path makes them):
         PP_STEPS pipelined SGD steps, each step's kernel launches
         counted and its host time taken; then 2 with every collective
         and staging copy timed (``_comm_split``);
      2. f32 from the weights in ``path`` (the single-device step's
         start), the batch's first ``f32_batch`` rows: one pipelined SGD
         step, its loss, launches and, per weight (unstacked and
         deinterleaved), ||w - w1|| / ||w1|| and the update's reading
         ||(w0 - w) - (w0 - w1)|| / ||w0 - w1|| against the
         single-device step's w1 in ``path``;
      3. the planted faults (the backward walk's hop sent to the next
         member; the embedding's gradient left unsummed over pp) on
         the first mesh: their updates' readings."""
    import torch
    from hpx_tpu_torch.models import transformer as tf
    from hpx_tpu_torch.ops import attention_cuda as ac
    from hpx_tpu_torch.parallel import pipeline_spmd as ps
    from hpx_tpu_torch.parallel.mesh import Mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    ref = torch.load(path, map_location=dev)
    w0, w1 = ref["w0"], ref["w1"]
    kern = (ac.flash_attention_fwd, ac.flash_attention_bwd,
            ac.flash_attention_bwd_f32, ac.flash_attention_chunk)
    cfg = tf.TransformerConfig(**TRAIN_MODEL, dtype=torch.bfloat16)
    cfg32 = tf.TransformerConfig(**TRAIN_MODEL)
    real_hop, real_axes = ps._hop, tf._pp_grad_axes

    def forward_hop(x, mesh, axis, shift, periodic):
        # planted fault: the backward walk's hop to the next member
        return real_hop(x, mesh, axis, abs(shift), periodic)
    faults = {"hop": lambda: setattr(ps, "_hop", forward_hop),
              "emb": lambda: setattr(tf, "_pp_grad_axes",
                                     lambda name: ("dp",))}
    out = []
    for i, (shape, names, m, v) in enumerate(PP_MESHES):
        mesh = Mesh(shape, names)
        r = {"shape": shape, "rank": mesh.rank, "coords": mesh.coords,
             "device": str(mesh.device), "backend": mesh.backend}
        gen = torch.Generator(device=dev).manual_seed(1)
        toks, tgts = tf.sample_batch(cfg, 8, 1024, generator=gen, device=dev)
        params = tf.prepare_pipeline_params(
            tf.init_params(cfg, seed=0, device=dev), mesh, v)
        t, g = tf.shard_batch(toks, tgts, mesh)
        step = tf.make_pipelined_train_step(cfg, mesh, m, interleave=v)
        torch.cuda.reset_peak_memory_stats(dev)
        losses, secs, per_step = [], [], []
        for _ in range(PP_STEPS):
            for k in kern:
                k.launches = 0
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            params, loss = step(params, t, g)
            torch.cuda.synchronize(dev)
            secs.append(time.perf_counter() - t0)
            losses.append(float(loss))
            per_step.append({k.__name__: k.launches for k in kern})
        r.update(losses=losses, secs=secs, per_step=per_step,
                 peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30)
        r["split"] = _comm_split(lambda: step(params, t, g), dev, 2)
        del params, step
        m32 = min(m, f32_batch // mesh.shape["dp"])
        t2, g2 = tf.shard_batch(toks[:f32_batch], tgts[:f32_batch], mesh)
        # the faults on the first mesh: on a ring of 2 (the interleaved
        # mesh) the next member is the previous one, and the hop fault
        # could not show
        runs = [None] + (["hop", "emb"] if i == 0 else [])
        for fault in runs:
            p32 = tf.prepare_pipeline_params(
                tf._from_named(dict(w0), cfg32.n_layers), mesh, v)
            step32 = tf.make_pipelined_train_step(cfg32, mesh, m32,
                                                  interleave=v)
            for k in kern:
                k.launches = 0
            if fault:
                faults[fault]()
            try:
                p32, loss = step32(p32, t2, g2)
            finally:
                ps._hop, tf._pp_grad_axes = real_hop, real_axes
            key = f"f32_{fault}" if fault else "f32"
            r[key + "_launches"] = {k.__name__: k.launches for k in kern}
            r[key + "_loss"] = float(loss)
            whole = tf.unstack_pipeline_params(
                tf.deinterleave_pipeline_params(
                    tf.unshard_pipeline_params(p32, mesh),
                    mesh.shape["pp"], v))
            reads = {}
            for n, x in whole.named_parameters():
                upd = (w0[n] - w1[n]).double()
                reads[n] = (((x - w1[n]).double().norm()
                             / w1[n].double().norm()).item(),
                            (((w0[n] - x).double() - upd).norm()
                             / upd.norm().clamp_min(1e-30)).item())
            r[key + "_reads"] = reads
            r["m32"] = m32
            del p32, step32, whole
        out.append(r)
        torch.cuda.empty_cache()
    return out


def _digest(t) -> str:
    """The SHA-256 of a tensor's bytes (a bitwise comparison across
    processes without moving the tensor)."""
    import hashlib
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()


def _jacobi_rank(spds) -> dict:
    """One of 4 ranks of config #5's sharded variant: ``jacobi_sharded``
    on Mesh((2, 2), ("x", "y")) at JACOBI, once for each sweeps-a-dispatch
    of ``spds``: its block's digest, the last residual and the host
    seconds; then, as a planted fault, the run with ghosts that never
    arrive (zeros at every rank boundary), its digest."""
    import torch
    from hpx_tpu_torch.models import jacobi2d as jm
    from hpx_tpu_torch.parallel import halo2d
    from hpx_tpu_torch.parallel.mesh import Mesh
    mesh = Mesh((2, 2), ("x", "y"))
    dev = mesh.device
    p = jm.JacobiParams(**JACOBI)
    out = {"rank": mesh.rank, "coords": mesh.coords, "device": str(dev),
           "backend": mesh.backend}
    for spd in spds:
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        u, res = jm.jacobi_sharded(p, mesh, steps_per_dispatch=spd)
        torch.cuda.synchronize(dev)
        out[f"secs_{spd}"] = time.perf_counter() - t0
        out[f"digest_{spd}"] = _digest(u)
        out[f"res_{spd}"] = float(res)
        del u
    real = halo2d.edge_shift
    halo2d.edge_shift = lambda x, mesh_, axis, shift: torch.zeros_like(x)
    try:
        u, _ = jm.jacobi_sharded(p, mesh)
    finally:
        halo2d.edge_shift = real
    out["digest_unexchanged"] = _digest(u)
    return out


def _fft_signal(shape, seed):
    import numpy as np
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _fft_rank(n: int, side: int) -> dict:
    """One of 4 ranks of the multi-rank FFT: ``fft_sharded`` and
    ``ifft_sharded`` of this rank's chunk of FFT_N complex64 (seed 41)
    over Mesh((4,), ("x",)), ``fft2_sharded_2d`` of its block of a
    side x side complex64 array (seed 42) over Mesh((2, 2), ("x", "y")):
    the results, the median ms of 5 calls of each, and the time inside
    torch.distributed's verbs and staging copies (``_comm_split``)."""
    import torch
    from hpx_tpu_torch.algo import fft as dfft
    from hpx_tpu_torch.parallel.mesh import Mesh
    line, grid = Mesh((4,), ("x",)), Mesh((2, 2), ("x", "y"))
    dev = line.device
    r = line.axis_index("x")
    gi, gj = grid.coords
    v = torch.from_numpy(_fft_signal(n, 41)).chunk(4)[r].to(dev)
    a = torch.from_numpy(_fft_signal((side, side), 42)).chunk(2, 0)[gi] \
        .chunk(2, 1)[gj].contiguous().to(dev)
    out = {"rank": line.rank, "coords": grid.coords, "device": str(dev),
           "backend": line.backend}
    calls = {"fft": lambda: dfft.fft_sharded(v, line),
             "ifft": lambda: dfft.ifft_sharded(v, line),
             "fft2_2d": lambda: dfft.fft2_sharded_2d(a, grid)}
    for name, fn in calls.items():
        out[name] = fn().cpu()
        ms = []
        for _ in range(5):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize(dev)
            ms.append((time.perf_counter() - t0) * 1e3)
        out[name + "_ms"] = statistics.median(ms)
        out[name + "_split"] = _comm_split(fn, dev, 3)
    out["round"] = dfft.ifft_sharded(dfft.fft_sharded(v, line), line).cpu()
    del v, a
    torch.cuda.empty_cache()
    # the next phase's work, in this world (a 4-rank world's fixed cost
    # is most of such a phase's time); its failure is that phase's
    try:
        out["dsort"] = _dsort_part(line)
    except Exception:  # noqa: BLE001 - reported by the next phase
        out["dsort_error"] = traceback.format_exc()
    return out


def _dsort_part(line) -> dict:
    """One of 4 ranks of "distributed sort and the multi-rank vector", in
    the multi-rank FFT's world on Mesh((4,), ("x",)): each check compares
    this rank's chunk with the same chunk of numpy's answer (a flag a
    check), so the parent sees every rank's verdict.

    - sort_sharded of DSORT_N standard normals (seed 44) by "sample" and
      by "odd_even": bitwise np.sort(kind="stable"); ms a sort and the
      verbs' share of it (_comm_split: 3 fenced sorts, ranks aligned by
      a barrier) and the verb counts of one sort;
    - DSMALL_N values with NaNs of five bit patterns, -0.0, +0.0, +-inf,
      by both methods, bitwise; sort_sharded_by_key of reversed int32
      keys and NaN payloads of three bit patterns, bitwise;
    - config #3's triad a = b + 3*c by hpx.transform(par.on(
      cuda_executor()), pv_b, f, pv_c) over a vector of DSORT_N f32 in 4
      partitions over the 4 ranks: no verb on the path, within Z_RTOL
      of float64, GB/s of this rank's block by the slope of 64 and 640
      dependent dispatches (all 4 ranks at once on one card);
    - on a vector of DVEC_N f32 in 8 partitions (it fills its layout):
      reduce and inclusive_scan of integers 0-3 (every sum below 2^24:
      exact in any order, held bitwise), minmax_element with a NaN at 2
      (NaN), count of int32 (exact), partition with -0.0 planted
      (bitwise, stable);
    - five planted faults, each of which its check must catch: on the
      filled vector, the scan's cross-rank prefix left out, the scan's
      prefix leaving out rank 0's total, and reduce dropping the last
      rank's partial; at DFAULT_N, odd-even with p - 1 rounds on a
      reversed input, and p - 1 splitters taken as regular samples of
      rank 0's own sorted chunk alone (before the rank stripe), on a
      skewed input whose rank 0 chunk lies below the rest (the other
      ranks' records then overflow the last bucket's static capacity).
      And a reading without a verdict: p - 1 splitters from rank 0's p
      samples after the stripe, on the same input."""
    import numpy as np
    import torch
    import hpx_tpu_torch as hpx
    from hpx_tpu_torch.algo import segmented as sg
    from hpx_tpu_torch.algo import sorting as so
    from hpx_tpu_torch.collectives import device as cd
    dev, p, r = line.device, 4, line.axis_index("x")
    out = {}
    t_all = time.perf_counter()

    def mine(a):                 # this rank's chunk of a whole vector
        m = a.shape[0] // p
        return a[r * m:(r + 1) * m]

    def bits_equal(got, want):
        got = got.cpu().numpy() if isinstance(got, torch.Tensor) else got
        return got.dtype == want.dtype and got.tobytes() == want.tobytes()

    def nan_bits(pattern, k):
        return np.resize(np.array(pattern, np.uint32), k).view(np.float32)

    v = np.random.default_rng(44).standard_normal(DSORT_N).astype(
        np.float32)
    want = mine(np.sort(v, kind="stable"))
    chunk = torch.from_numpy(mine(v)).to(dev)
    for method in ("sample", "odd_even"):
        def one(method=method):
            return so.sort_sharded(chunk, line, method=method)
        out[f"{method}_equal"] = bits_equal(one(), want)
        cd.barrier(line)
        out[f"{method}_split"] = _comm_split(one, dev, 3)
        out[f"{method}_ms"] = out[f"{method}_split"]["step_ms"]
        out[f"{method}_verbs"] = out[f"{method}_split"]["verbs"]
    del chunk
    # NaNs, zeros and infinities; by key with NaN payloads
    rng = np.random.default_rng(45)
    sp = rng.standard_normal(DSMALL_N).astype(np.float32)
    sp[rng.permutation(DSMALL_N)[:100]] = nan_bits(
        [0x7FC00000, 0xFFC00000, 0x7FC00123, 0xFFFFFFFF, 0x7F800001], 100)
    sp[rng.permutation(DSMALL_N)[:80]] = np.resize(
        np.array([0.0, -0.0, np.inf, -np.inf], np.float32), 80)
    for method in ("sample", "odd_even"):
        out[f"special_{method}"] = bits_equal(
            so.sort_sharded(torch.from_numpy(mine(sp)).to(dev), line,
                            method=method),
            mine(np.sort(sp, kind="stable")))
    keys = np.arange(DSMALL_N, dtype=np.int32)[::-1].copy()
    vals = nan_bits([0x7FC00001, 0xFFC0BEEF, 0x7F800003], DSMALL_N)
    out["by_key"] = bits_equal(
        so.sort_sharded_by_key(torch.from_numpy(mine(keys)).to(dev),
                               torch.from_numpy(mine(vals)).to(dev), line),
        mine(vals[np.argsort(keys, kind="stable")]))
    # config #3's triad over the ranks
    layout = hpx.container_layout(4, mesh=line)
    b32 = np.random.default_rng(46).random(DSORT_N, np.float32)
    c32 = np.random.default_rng(47).random(DSORT_N, np.float32)
    pv_b = hpx.partitioned_vector.from_array(b32, layout)
    pv_c = hpx.partitioned_vector.from_array(c32, layout)
    policy = hpx.par.on(hpx.cuda_executor())

    def triad(x, y):
        return torch.add(x, y, alpha=3.0)
    res = {}

    def triad_once():
        res["a"] = hpx.transform(policy, pv_b, triad, pv_c)
    out["triad_verbs"] = sum(_comm_split(triad_once, dev, 1)["verbs"]
                             .values())
    a = res.pop("a")
    w64 = mine(b32).astype(np.float64) + 3.0 * mine(c32).astype(np.float64)
    out["triad_rel"] = float(np.max(np.abs(a.data.cpu().numpy() - w64)
                                    / np.abs(w64)))
    out["triad_layout"] = (type(a).__name__, a.layout is layout,
                           a.data.shape[0], a.local_range())

    def chain(k):
        x = pv_b
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(k):
            x = hpx.transform(policy, x, triad, pv_c)
        torch.cuda.synchronize(dev)
        return time.perf_counter() - t0
    cd.barrier(line)
    per = statistics.median((chain(640) - chain(64)) / 576
                            for _ in range(3))
    out["triad_ms"] = per * 1e3
    out["triad_gbs"] = 3 * 4 * (DSORT_N // p) / per / 1e9
    del pv_b, pv_c, a
    # the segmented checks on a vector that fills its layout; small
    # integers in f32 (sums below 2^24): every sum and prefix is exact in
    # any order, so the checks are bitwise
    lay8 = hpx.container_layout(8, mesh=line)
    x = np.random.default_rng(48).integers(0, 4, DVEC_N).astype(np.float32)
    px = hpx.partitioned_vector.from_array(x, lay8)
    total = float(x.astype(np.int64).sum())
    cum = mine(np.cumsum(x.astype(np.int64)).astype(np.float32))

    def reduce_ok():
        return float(hpx.reduce(hpx.par, px, 0.0)) == total

    def scan_ok():
        return bits_equal(hpx.inclusive_scan(hpx.par, px).data, cum)
    out["reduce"], out["scan"] = reduce_ok(), scan_ok()
    xn = x.copy()
    xn[2] = np.nan
    mm = hpx.minmax_element(hpx.par,
                            hpx.partitioned_vector.from_array(xn, lay8))
    out["minmax_nan"] = bool(torch.isnan(mm).all())
    ints = np.random.default_rng(49).integers(0, 10, DVEC_N).astype(np.int32)
    out["count"] = int(hpx.count(hpx.par, hpx.partitioned_vector.from_array(
        ints, lay8), 3)) == int((ints == 3).sum())
    z = np.linspace(-1, 1, DVEC_N).astype(np.float32)
    z[::5] = -0.0
    part, point = hpx.partition(hpx.par, hpx.partitioned_vector.from_array(
        z, lay8), lambda t: t > 0.25)
    keep = z > 0.25
    out["partition"] = point == int(keep.sum()) and bits_equal(
        part, np.concatenate([z[keep], z[~keep]]))
    del part
    # the planted faults, each of which its check must catch: the scan's
    # and reduce's on the filled vector, by the checks above
    saved_prefix, saved_partials = sg._rank_prefix, sg._partials

    def drop_last(t, span):      # the last rank's partial as zeros
        got = saved_partials(t, span).clone()
        got[-1] = 0
        return got
    for key, name, rule, check in (
            ("fault_scan_passes", "_rank_prefix", lambda *a: None, scan_ok),
            ("fault_scan_one_total_passes", "_rank_prefix",
             lambda op, tot, present, rank: saved_prefix(
                 op, tot, present[1:], rank), scan_ok),
            ("fault_reduce_partial_passes", "_partials", drop_last,
             reduce_ok)):
        setattr(sg, name, rule)
        try:
            out[key] = check()
        finally:
            sg._rank_prefix, sg._partials = saved_prefix, saved_partials
    del px
    rev = np.arange(DFAULT_N, dtype=np.float32)[::-1].copy()
    saved = so._odd_even
    so._odd_even = functools.partial(saved, rounds=p - 1)
    try:
        bad = so.sort_sharded(torch.from_numpy(mine(rev)).to(dev), line,
                              method="odd_even")
    finally:
        so._odd_even = saved
    out["fault_rounds_passes"] = bits_equal(bad, mine(np.sort(rev)))
    skew = np.random.default_rng(51).random(DFAULT_N, np.float32)
    skew[DFAULT_N // p:] += 10.0          # rank 0's chunk below the rest
    want_skew = mine(np.sort(skew, kind="stable"))
    chunk0 = skew[:DFAULT_N // p]
    pick = np.argsort(chunk0, kind="stable")[
        (DFAULT_N // p // p) * np.arange(1, p)]
    own = (so._okey(torch.from_numpy(chunk0[pick]).to(dev)),
           torch.from_numpy(pick.astype(np.int64)).to(dev))
    saved = so._splitters
    for label, rule in (
            ("fault_splitters_passes", lambda sok, sgid, p_: own),
            ("rank0_splitters_passes",
             lambda sok, sgid, p_: (lambda o: (sok[o], sgid[o]))(
                 so._lexsort(sok[:p_], sgid[:p_])[1:p_]))):
        so._splitters = rule
        try:
            bad = so.sort_sharded(torch.from_numpy(mine(skew)).to(dev), line,
                                  method="sample")
        finally:
            so._splitters = saved
        out[label] = bits_equal(bad, want_skew)
    out["seconds"] = time.perf_counter() - t_all
    return out


def _paged_plan_of(kind, q, k_pool, v_pool, table, *_):
    """(P, stages, cb, shared-memory bytes, sub): the wrapper's own plan of
    a launch of kernel ``kind`` ("exact" or "online") on these inputs."""
    from hpx_tpu_torch.ops import attention_cuda as ac
    b, w, nq, hd = q.shape
    nkv = k_pool.shape[2]
    return ac.paged_plan(kind == "exact", b, nkv, w * (nq // nkv),
                         table.shape[1], k_pool.shape[1], hd,
                         k_pool.element_size())


def _plain_online(*args):
    """The online kernel's plain version in the kernel's order: the same P
    runs, merged in rank order, and the same chunk of cb blocks or of a
    part of a block (cb * bs / sub rows)."""
    from hpx_tpu_torch.ops import attention_cuda as ac
    p, _, cb, _, sub = _paged_plan_of("online", *args)
    return ac.plain_paged_attention_online(
        *args, splits=p, chunk_rows=cb * (args[1].shape[1] // sub))


def _paged_pairs():
    """{wrapper name: (the kernel's wrapper, its plain version)} of
    kernels 3-4."""
    from hpx_tpu_torch.ops import attention_cuda as ac
    return {"fused_paged_attention": (ac.fused_paged_attention,
                                      ac.plain_paged_attention_exact),
            "fused_paged_online_attention": (ac.fused_paged_online_attention,
                                             _plain_online)}


def _sharded_serve_rank() -> dict:
    """One rank of the sharded-serving path (spawned by hpx_tpu_torch's
    launcher): ContinuousServer(mesh=Mesh((2, 2), ("dp", "tp"))) at the
    serving model's full width (SERVE_MODEL, weights from seed 0 made on
    the rank's card as the one-rank path makes them) on mixes (a) and (b):
    f32 dense, paged fused (kernel 3) and fused_online (kernel 4) on (a),
    fused on (b), int8 pools (fused) on (a), n-gram speculation (fused, k
    SPEC_K) on (b),
    bf16 fused on both, and MOE_MODEL (weights from seed 4, its 8
    requests) dense and paged fused in f32, its experts over tp. Each run
    returns its tokens (by request id), wall seconds, the steps and
    verify windows its paged programs ran and each kernel's launches
    (held to n_layers a step and a window); (a) f32 fused once more under
    torch.profiler, its kernel records held to the wrapper's count; once
    with every verb and staging copy fenced and timed (``_comm_split``);
    two planted faults: the tp close after wo left out, and dp rank 1's
    table rows shifted by one slot. Kernels 3-4 against their plain
    versions at the rank's shape on the bf16 and int8 runs' pools."""
    t_start = time.perf_counter()
    import torch
    from torch.profiler import ProfilerActivity, profile
    from hpx_tpu_torch.models import serving
    from hpx_tpu_torch.models import transformer as tf
    from hpx_tpu_torch.parallel.mesh import Mesh
    from hpx_tpu_torch.tools.serving_ab import SERVE_MODEL, mixes
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = Mesh((2, 2), ("dp", "tp"))
    dev = mesh.device
    pairs = _paged_pairs()
    kern = {k: w for k, (w, _) in pairs.items()}
    wrapper = {"fused": "fused_paged_attention",
               "fused_online": "fused_paged_online_attention"}
    mx = mixes()
    mx["moe"] = (_moe_requests(MOE_MODEL["vocab"]), MOE_SERVER)
    models = {}

    def model(which, dtype):
        if (which, dtype) not in models:
            spec, seed = ((MOE_MODEL, MOE_SEED) if which == "moe"
                          else (SERVE_MODEL, 0))
            cfg = tf.TransformerConfig(**spec, dtype=dtype)
            models[which, dtype] = (tf.init_params(cfg, seed=seed,
                                                   device=dev), cfg)
        return models[which, dtype]

    def counting(srv, calls):
        """The server's paged step and verify programs, each call
        counted."""
        for name in ("_paged_step_prog", "_paged_verify_prog"):
            orig = getattr(srv, name)

            def get(*a, orig=orig, name=name):
                prog = orig(*a)

                def call(*x, **y):
                    calls[name] += 1
                    return prog(*x, **y)
                return call
            setattr(srv, name, get)

    def submit(srv, reqs):
        for p, m in reqs:
            srv.submit(p, max_new=m)

    out = {"rank": mesh.rank, "coords": mesh.coords, "device": str(dev),
           "backend": mesh.backend, "runs": {}, "checks": []}

    def run(label, mix, dtype, which="serve", **kw):
        params, cfg = model(which, dtype)
        reqs, base = mx[mix]
        srv = serving.ContinuousServer(params, cfg, mesh=mesh, **base, **kw)
        calls = {"_paged_step_prog": 0, "_paged_verify_prog": 0}
        counting(srv, calls)
        before = {k: w.launches for k, w in kern.items()}
        submit(srv, reqs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = srv.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: w.launches - before[k] for k, w in kern.items()}
        windows = calls["_paged_step_prog"] + calls["_paged_verify_prog"]
        if mesh.rank == 0:
            print(f"   rank 0: {label} in {wall!r} s (at "
                  f"{time.perf_counter() - t_start!r} s)", flush=True)
        want = {k: (cfg.n_layers * windows
                    if wrapper.get(srv.paged_kernel) == k else 0)
                for k in kern}
        if launches != want:
            raise AssertionError(f"rank {mesh.rank} {label} ({mix}): "
                                 f"launches {launches}, the schedule's "
                                 f"{want}")
        out["runs"][label] = dict(
            tokens=[res[r] for r in sorted(res)], wall=wall,
            steps=calls["_paged_step_prog"],
            windows=calls["_paged_verify_prog"], launches=launches,
            graphs=len(srv._graphs), moe=(srv._moe_routed,
                                          srv._moe_dropped),
            spec=srv.spec_stats() if srv._spec else None,
            kernel=srv.paged_kernel, rows=srv._rows,
            heads=srv.cfg.kv_heads // srv._tp)
        return srv

    def check(srv, what):
        """Kernels 3-4 against their plain versions on the server's pools
        at its decode shape on this rank (its slots, W 1, its kv heads),
        through random tables over its blocks; uncounted."""
        cpu = torch.Generator().manual_seed(9)
        rows, maxb = srv._rows, srv._maxb
        with _uncounted([w for w, _ in pairs.values()]):
            for layer, (kp, vp) in enumerate(srv._pools):
                sc = () if srv._scales is None else srv._scales[layer]
                nb, bs = kp.shape[0], kp.shape[1]
                table = torch.randint(0, nb, (rows, maxb),
                                      generator=cpu).int()
                pos = torch.randint(0, maxb * bs, (rows,),
                                    generator=cpu).int()
                pos[0], pos[-1] = 0, maxb * bs - 1
                q = torch.randn(rows, 1, srv.cfg.n_heads // srv._tp,
                                srv.cfg.head_dim, generator=cpu).to(
                                    srv.cfg.dtype)
                args = [q.to(dev), kp, vp, table.to(dev), pos.to(dev), *sc]
                for k, (fn, plain) in pairs.items():
                    got, want = fn(*args), plain(*args)
                    torch.cuda.synchronize()
                    rtol, atol = PAGED_TOL[str(want.dtype).split(".")[-1]]
                    g, w = got.float(), want.float()
                    err = (g - w).abs().max().item()
                    margin = ((g - w).abs() / (atol + rtol * w.abs())
                              ).max().item()
                    out["checks"].append(dict(
                        kernel=k, what=f"{what} layer {layer}", err=err,
                        margin=margin, shape=tuple(kp.shape),
                        ok=bool(got.shape == want.shape and torch.allclose(
                            g, w, rtol=rtol, atol=atol))))

    f32, bf16 = torch.float32, torch.bfloat16
    fused = dict(paged=True, paged_kernel="fused")
    online = dict(paged=True, paged_kernel="fused_online")
    run("(a) f32 dense", "a", f32)
    run("(a) f32 fused", "a", f32, **fused)
    run("(a) f32 fused_online", "a", f32, **online)
    run("(b) f32 fused", "b", f32, **fused)
    srv = run("(a) f32 fused int8 pools", "a", f32, kv_dtype="int8", **fused)
    check(srv, "(a) int8 pools")
    run("(b) f32 fused spec", "b", f32, spec=True, spec_k=SPEC_K, **fused)
    for mix in ("a", "b"):
        srv = run(f"({mix}) bf16 fused", mix, bf16, **fused)
    check(srv, "(b) bf16 pools")
    del srv
    run("MoE f32 dense", "moe", f32, which="moe")
    run("MoE f32 fused", "moe", f32, which="moe", **fused)
    models.pop(("moe", f32))

    if mesh.rank == 0:
        print(f"   rank 0: runs done at {time.perf_counter() - t_start!r} s",
              flush=True)
    # (a) f32 fused under the profiler: kernel records against the count
    params, cfg = model("serve", f32)
    reqs, base = mx["a"]
    w = kern["fused_paged_attention"]
    for attempt in range(TRACE_ATTEMPTS):
        srv = serving.ContinuousServer(params, cfg, mesh=mesh, **base,
                                       **fused)
        submit(srv, reqs)
        # device records only: the eager programs' host ops, recorded on
        # 4 processes sharing the host, would cost the trace tens of s
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            time.sleep(TRACE_MARGIN_S)
            for _ in range(TRACE_LEAD_IN):
                torch.cuda._sleep(100)
            torch.cuda.synchronize()
            before = w.launches
            srv.run()
            torch.cuda.synchronize()
            counted_ = w.launches - before
            time.sleep(TRACE_MARGIN_S)
        traced = sum(e.count for e in prof.key_averages()
                     if e.device_type != torch.autograd.DeviceType.CPU
                     and w.kernels.search(e.key))
        out["profiled"] = dict(traced=traced, counted=counted_,
                               attempt=attempt)
        if traced >= counted_:
            break

    # every verb and staging copy fenced and timed, over one run of (a)
    srv = serving.ContinuousServer(params, cfg, mesh=mesh, **base, **fused)
    calls = {"_paged_step_prog": 0, "_paged_verify_prog": 0}
    counting(srv, calls)
    ntok = sum(m for _, m in reqs)

    def once():
        submit(srv, reqs)
        srv.run()
    out["split"] = dict(_comm_split(once, dev, 1), tokens=ntok,
                        steps=calls["_paged_step_prog"])
    if mesh.rank == 0:
        print(f"   rank 0: profile and split done at "
              f"{time.perf_counter() - t_start!r} s", flush=True)

    # planted faults, each on (a) f32 fused
    real = tf.reduce_from
    closes = {"n": 0}

    def no_wo_close(x, mesh_, axis="tp"):
        closes["n"] += 1            # a dense layer closes wo, then w2
        return x if closes["n"] % 2 else real(x, mesh_, axis)
    tf.reduce_from = no_wo_close
    try:
        run("fault: wo close left out", "a", f32, **fused)
    finally:
        tf.reduce_from = real
    table = serving.device_table

    def shifted(*a, **k):
        t = table(*a, **k)
        return torch.roll(t, 1, 0) if mesh.axis_index("dp") == 1 else t
    serving.device_table = shifted
    try:
        run("fault: dp rank 1's table rows shifted", "a", f32, **fused)
    finally:
        serving.device_table = table
    out["seconds"] = time.perf_counter() - t_start
    return out


class Smoke:
    def __init__(self) -> None:
        self.failures = []
        self.seconds = {}          # each phase's wall seconds
        names = ("heat_step_blocked", "multistep_fused", *PAGED_KERNELS,
                 *FLASH_KERNELS, *FLASH_F32_BWD, *CHUNK_KERNEL,
                 *FMA_KERNEL)
        self.max_abs_err = {k: 0.0 for k in names}
        # largest |got - want| / (atol + rtol |want|) of a kernel: <= 1
        self.margin = {k: 0.0 for k in names}
        # largest norm-relative reading of a bf16 flash output
        self.norm_rel = {k: 0.0 for k in (*FLASH_KERNELS, *CHUNK_KERNEL)}
        self.launches = {k: 0 for k in names}
        # the f32 route's launches of the wrappers that take both types
        # (the f32 training gate's and the ring's f32 gates'), also in
        # self.launches
        self.f32_launches = {"flash_attention_fwd": 0,
                             "flash_attention_chunk": 0}

    def phase(self, name, fn) -> bool:
        print(f"== {name}", flush=True)
        t0 = time.perf_counter()
        try:
            fn()
            return True
        except Exception:  # noqa: BLE001 — report every failed phase
            traceback.print_exc()
            print(f"FAIL {name}", flush=True)
            self.failures.append(name)
            return False
        finally:
            self.seconds[name] = time.perf_counter() - t0
            print(f"   ({name}: {self.seconds[name]:.1f} s)", flush=True)

    def expect_equal(self, kernel: str, got, want, what: str,
                     quiet: bool = False) -> None:
        import torch
        torch.cuda.synchronize()
        err = (got - want).abs().max().item() if got.numel() else 0.0
        self.max_abs_err[kernel] = max(self.max_abs_err[kernel], err)
        if got.shape != want.shape or not torch.equal(got, want):
            raise AssertionError(f"{what}: kernel differs from its plain "
                                 f"version, max abs err {err}")
        if not quiet:
            print(f"   {what}: equal (tolerance 0)", flush=True)

    def expect_close(self, kernel: str, got, want, what: str,
                     quiet: bool = False, tol=None, norm: bool = False,
                     track: str = None) -> float:
        """Elementwise within (rtol, atol); with ``norm``, also within
        FLASH_NORM_REL by the norm (see _norm_rel). The largest error
        over its tolerance is kept under ``kernel`` and, given one, under
        ``track`` too (a kernel's route apart)."""
        import torch
        torch.cuda.synchronize()
        if norm and got.shape == want.shape:
            r = _norm_rel(got, want)
            self.norm_rel[kernel] = max(self.norm_rel[kernel], r)
            if r > FLASH_NORM_REL:
                raise AssertionError(f"{what}: kernel differs from its "
                                     f"plain version by the norm: {r} > "
                                     f"{FLASH_NORM_REL}")
        rtol, atol = tol or PAGED_TOL[str(want.dtype).split(".")[-1]]
        g, w = got.float(), want.float()
        err = (g - w).abs().max().item() if got.numel() else 0.0
        self.max_abs_err[kernel] = max(self.max_abs_err[kernel], err)
        if got.shape == want.shape and got.numel():
            r = ((g - w).abs() / (atol + rtol * w.abs())).max().item()
            for k in (kernel, track) if track else (kernel,):
                self.margin[k] = max(self.margin.get(k, 0.0), r)
        if (got.shape != want.shape or got.dtype != want.dtype
                or not torch.allclose(g, w, rtol=rtol, atol=atol)):
            raise AssertionError(f"{what}: kernel differs from its plain "
                                 f"version, max abs err {err} (rtol "
                                 f"{rtol}, atol {atol})")
        if not quiet:
            print(f"   {what}: max abs err {err} (rtol {rtol}, atol "
                  f"{atol})", flush=True)
        return err


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import numpy as np
        import hpx_tpu_torch as hpx
        from hpx_tpu_torch import CudaExecutor, HighResolutionTimer
        from hpx_tpu_torch.models import quant
        from hpx_tpu_torch.models import serving
        from hpx_tpu_torch.models import stencil1d as s1
        from hpx_tpu_torch.models import transformer as tf
        from hpx_tpu_torch.ops import _build
        from hpx_tpu_torch.ops import attention_cuda as ac
        from hpx_tpu_torch.ops import paged_attention as pa
        from hpx_tpu_torch.ops import fma_rate as fr
        from hpx_tpu_torch.ops import stencil as st
        from hpx_tpu_torch.core import programs
        from hpx_tpu_torch.core.config import runtime_config
        from hpx_tpu_torch.svc import faultinject, profiling, tracing
        # the serving model at full width, mixes (a) and (b) and the
        # stepped run, shared with the A B B A tool
        from hpx_tpu_torch.tools.serving_ab import (SERVE_MODEL,
                                                    mixes as serve_mixes,
                                                    serve as stepped)
        from hpx_tpu_torch.svc.trace_export import (load_chrome_trace,
                                                    validate_chrome_trace)
        from hpx_tpu_torch.utils import prng
        from hpx_tpu_torch.utils.compilemon import count_captures
    except ImportError as e:
        print(f"chip_smoke: cannot import hpx_tpu_torch: {e}",
              file=sys.stderr)
        return 2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = _nvidia_smi()
    name = torch.cuda.get_device_name(0)
    print(f"device: {name}; nvidia-smi: {smi}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    sm = Smoke()
    kernels = (st.heat_step_blocked, st.multistep_fused,
               ac.fused_paged_attention, ac.fused_paged_online_attention,
               ac.flash_attention_fwd, ac.flash_attention_bwd,
               ac.flash_attention_bwd_f32, ac.flash_attention_chunk,
               fr.fma_chain)

    plan_of, plain_online = _paged_plan_of, _plain_online

    def splits_of(*args):
        """P, the CTAs the online kernel gives each (slot, kv-head) on
        these inputs."""
        return plan_of("online", *args)[0]
    paged = _paged_pairs()
    kind_of = {"fused_paged_attention": "exact",
               "fused_paged_online_attention": "online"}

    # -- 1. build ---------------------------------------------------------------
    def build():
        from concurrent.futures import ThreadPoolExecutor
        sources = sorted(f[:-3] for f in os.listdir(_build.CSRC)
                         if f.endswith(".cu"))
        t = HighResolutionTimer()
        with ThreadPoolExecutor(len(sources)) as pool:
            list(pool.map(_build.load, sources))
        print(f"   built {sources} in {t.elapsed():.2f} s", flush=True)
        for src in sources:
            info = _build.BUILD_INFO[src]
            print(f"   {src}: {info['seconds']:.2f} s, built={info['built']}")
            for kernel, report in _ptxas_report(info["log"]):
                print(f"     {kernel}: {report}")
        # the bf16 flash forward and backward run on wgmma fed by TMA:
        # the SASS of each holds HGMMA and UTMALDG instructions
        cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
        sass = subprocess.run([cuobjdump, "-sass",
                               _build.BUILD_INFO["flash_attention"]["path"]],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout
        reports = list(_ptxas_report(_build.BUILD_INFO["flash_attention"]
                                     ["log"]))
        for kern, want in (("flash_fwd_wgmma", ("HGMMA", "UTMALDG")),
                            ("flash_bwd_wgmma", ("HGMMA", "UTMALDG")),
                            ("flash_fwd_tf32x3", ("HMMA",)),
                            ("flash_bwd_tf32x3", ("HMMA",))):
            body = "".join(f for f in sass.split("Function : ")[1:]
                           if kern in f.split("\n", 1)[0])
            counts = {op: body.count(op) for op in want}
            print(f"   {kern} SASS: {counts}", flush=True)
            if not all(counts.values()):
                raise AssertionError(f"{kern} has none of the tensor-core "
                                     f"or TMA instructions {want}: {counts}")
            if kern.endswith("tf32x3"):     # each instance's registers
                for k_, r in reports:
                    if k_.startswith(kern):
                        print(f"     {k_}: {r}", flush=True)
        # kernel 1 keeps its cells in registers: warp shuffles each step,
        # shared memory only for the runs exchanged between warps
        sass = subprocess.run([cuobjdump, "-sass",
                               _build.BUILD_INFO["stencil"]["path"]],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout
        for k in st.CELLS_PER_THREAD:
            body = "".join(f for f in sass.split("Function : ")[1:]
                           if f"multistep_fused_kernelILi{k}E"
                           in f.split("\n", 1)[0])
            ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]\s+)?"
                             r"([A-Z][A-Z0-9]*)", body)
            counts = {op: ops.count(op) for op in ("SHFL", "LDS", "STS",
                                                    "BAR")}
            attrs = st.multistep_fused_attrs(k)
            print(f"   multistep_fused_kernel<{k}> SASS: {counts}; "
                  f"runtime: {attrs}", flush=True)
            if not counts["SHFL"] or attrs["local"] \
                    or attrs["smem"] != st.smem_bytes(k):
                raise AssertionError(
                    f"multistep_fused_kernel<{k}>: no SHFL, spilled, or "
                    f"shared memory {attrs['smem']} != the plan's "
                    f"{st.smem_bytes(k)}")
    if not sm.phase("build", build):
        return 1

    def native_scheduler():
        """The native C++ scheduler (hpx_tpu_torch/native/scheduler.cpp),
        built with g++ at first use into the package's _build/; the pool
        an executor owns under the default configuration
        (hpx.scheduler.native = 1) must be a NativePool, and
        examples_cuda/fibonacci.py's fib(15) at threshold 10 must give 610
        through it, one task a spawn."""
        import importlib.util
        from hpx_tpu_torch.native import loader
        if loader.native_lib() is None:
            raise AssertionError(f"the native scheduler did not build: "
                                 f"{loader.BUILD_INFO.get('error')}")
        info = loader.BUILD_INFO
        if os.path.dirname(info["path"]) != str(loader.BUILD_DIR):
            raise AssertionError(f"loaded {info['path']}, not a build of "
                                 f"{loader.SOURCE} in {loader.BUILD_DIR}")
        print(f"   {loader.SOURCE.name} -> {info['path']} "
              f"(built={info['built']}, {info['seconds']!r} s)", flush=True)
        spec = importlib.util.spec_from_file_location(
            "fibonacci", os.path.join(os.path.dirname(os.path.abspath(
                __file__)), "examples_cuda", "fibonacci.py"))
        fib = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(fib)

        def spawns(n):
            return 0 if n < 10 else 1 + spawns(n - 1) + spawns(n - 2)
        ex = hpx.ThreadPoolExecutor()
        try:
            if type(ex.pool).__name__ != "NativePool":
                raise AssertionError(f"the default own pool is "
                                     f"{type(ex.pool).__name__}")
            t = HighResolutionTimer()
            got = fib.fib_futurized(15, 10, ex)
            secs = t.elapsed()
            for _ in range(500):        # executed lands after a task body
                if ex.pool.stats()["executed"] >= spawns(15):
                    break
                time.sleep(0.01)
            st = ex.pool.stats()
        finally:
            ex.shutdown()
        print(f"   fib(15), threshold 10, on {type(ex.pool).__name__} of "
              f"{st['threads']} threads: {got} in {secs * 1e3!r} ms; "
              f"executed {st['executed']} (spawns {spawns(15)}), stolen "
              f"{st['stolen']}", flush=True)
        if got != 610 or st["executed"] != spawns(15):
            raise AssertionError(f"fib(15) = {got}, executed "
                                 f"{st['executed']}")
    sm.phase("native scheduler", native_scheduler)

    # -- 2. kernel checks on small and ragged shapes ---------------------------
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rand(n):
        return torch.rand(n, generator=gen, device="cuda") * 100

    def kernel_checks():
        for n in (1, 2, 3, 127, 1000, (1 << 20) + 3):
            u = rand(n)
            sm.expect_equal("heat_step_blocked", st.heat_step_blocked(u, 0.3),
                            st.plain_heat_step_blocked(u, 0.3),
                            f"kernel 2 n={n}")
        # kernel 1 around 2S, around the tile the plan gives 2^19, over
        # one and several passes; by the wrapper's plan, each K's plan,
        # and each K's with blocks of 2 and 8 warps
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        s_ = st.PASS_STEPS
        tile = st.multistep_plan(1 << 19, s_, sms).tile
        plans = [(None, None)] + [(k, w) for k in st.CELLS_PER_THREAD
                                  for w in (None, 2, 8)]
        for n in (1, 5, 2 * s_ - 1, 2 * s_ + 1, 4095, 4097, 100003,
                  tile - 1, tile, tile + 1, 1 << 19):
            for steps in (1, 31, 32, 33, 70, s_ - 1, s_, s_ + 1, 2 * s_ + 3,
                          1024):
                u = rand(n)
                want = st.plain_multistep(u, 0.3, steps)
                for k, w in plans:
                    plan = None if k is None else st.multistep_plan(
                        n, steps, sms, k, w)
                    sm.expect_equal(
                        "multistep_fused",
                        st.multistep_fused(u, 0.3, steps, plan), want,
                        f"kernel 1 n={n} steps={steps} plan="
                        f"{plan or st.multistep_plan(n, steps, sms)}",
                        quiet=True)
                v = rand(n + 1)[1:]          # 4 bytes off: scalar loads
                sm.expect_equal("multistep_fused",
                                st.multistep_fused(v, 0.3, steps),
                                st.plain_multistep(v, 0.3, steps),
                                f"kernel 1 unaligned n={n} steps={steps}",
                                quiet=True)
            print(f"   kernel 1 n={n}: {10 * (len(plans) + 1)} cases equal "
                  f"(tolerance 0)", flush=True)
        # a planted fault: one pass with a halo one cell short
        u = rand(100003)
        plan = st.multistep_plan(100003, s_, sms)
        got = st.multistep_fused(u, 0.3, s_, plan._replace(halo=plan.halo - 1))
        torch.cuda.synchronize()
        if torch.equal(got, st.plain_multistep(u, 0.3, s_)):
            raise AssertionError("kernel 1 with a halo one cell short equals "
                                 "its plain version: the check is blind")
        print(f"   planted fault, halo {plan.halo - 1} for {s_} steps: "
              f"differs ({int(torch.isnan(got).sum())} NaN cells)",
              flush=True)
    sm.phase("kernel checks", kernel_checks)

    def fma_kernel_checks():
        """Kernel 9 against plain_fma_chain, bitwise, at bench.py's size
        and off it, for the coefficient bench.py uses and an inexact
        one (c * u is then rounded inside the FMA)."""
        n_cases = 0
        for n in (128, 4096, (1 << 17) + 128 * 3):
            u = torch.rand(n, generator=gen, device="cuda")
            for steps in (1, 7, 1024):
                for c in (0.9999999, 0.3):
                    sm.expect_equal("fma_chain", fr.fma_chain(u, c, steps),
                                    fr.plain_fma_chain(u, c, steps),
                                    f"kernel 9 n={n} steps={steps} c={c}")
                    n_cases += 1
        print(f"   {n_cases} kernel 9 cases bitwise equal", flush=True)
    sm.phase("fma_rate kernel checks", fma_kernel_checks)

    def paged_state(b, maxb, bs, nkv, g, hd, w, pool_dt, q_dt, seed):
        """Random pools, a shuffled table (logical != physical, block 0
        never mapped), ragged positions with one slot at 0 and one
        whose window ends on the last row; (q, k_pool, v_pool, table,
        pos0, k_scale, v_scale) on the card."""
        cpu = torch.Generator().manual_seed(seed)
        nb = b * maxb + 2
        kp = torch.randn(nb, bs, nkv, hd, generator=cpu)
        vp = torch.randn(nb, bs, nkv, hd, generator=cpu)
        table = (torch.randperm(nb - 1, generator=cpu)[:b * maxb] + 1
                 ).reshape(b, maxb).int()
        pos = torch.randint(0, maxb * bs - w + 1, (b,), generator=cpu).int()
        pos[0], pos[-1] = 0, maxb * bs - w
        q = torch.randn(b, w, nkv * g, hd, generator=cpu).to(q_dt)
        ks = vs = None
        if pool_dt in (torch.int8, torch.float8_e4m3fn):
            (kp, ks), (vp, vs) = (pa.quantize_blocks(kp, pool_dt),
                                  pa.quantize_blocks(vp, pool_dt))
        else:
            kp, vp = kp.to(pool_dt), vp.to(pool_dt)
        return [None if t is None else t.cuda()
                for t in (q, kp, vp, table, pos, ks, vs)]

    pool_types = ((torch.float32, torch.float32),
                  (torch.bfloat16, torch.bfloat16),
                  (torch.int8, torch.float32), (torch.int8, torch.bfloat16),
                  (torch.float8_e4m3fn, torch.float32),
                  (torch.float8_e4m3fn, torch.bfloat16))

    def moved_dead(args):
        """args with every dead table entry (a block whose first
        position is past pos0 + W - 1) pointed at another pool block."""
        q, kp, _, table, pos = args[:5]
        bs, maxb, nb = kp.shape[1], table.shape[1], kp.shape[0]
        nlive = ((pos.long() + q.shape[1] - 1) // bs + 1).clamp(max=maxb)
        dead = (torch.arange(maxb, device=table.device)[None, :]
                >= nlive[:, None])
        moved = table.clone()
        moved[dead] = (moved[dead] + 1) % nb
        return [*args[:3], moved, *args[4:]], int(dead.sum())

    def misaligned(t):
        """A copy of t whose data starts one element past a 16-byte
        boundary."""
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        v = buf[1:].view(t.shape)
        v.copy_(t)
        return v

    def long_state(b, maxb, nkv, hd, seed):
        """f32 q and pools on the card for S = maxb * 16 (W 1, g 1), the
        slots at random positions in the second half, the last at S - 1;
        (q, k_pool, v_pool, table, pos0, None, None)."""
        cuda = torch.Generator(device="cuda").manual_seed(seed)
        nb, s = b * maxb + 2, maxb * 16
        kp, vp = (torch.randn(nb, 16, nkv, hd, generator=cuda,
                              device="cuda") for _ in range(2))
        table = (torch.randperm(nb - 1, generator=cuda, device="cuda")
                 [:b * maxb] + 1).reshape(b, maxb).int()
        pos = torch.randint(s // 2, s, (b,), generator=cuda,
                            device="cuda").int()
        pos[-1] = s - 1
        q = torch.randn(b, 1, nkv, hd, generator=cuda, device="cuda")
        return [q, kp, vp, table, pos, None, None]

    def paged_kernel_checks():
        # (slots, max_blocks, block_size, kv heads, group g, head_dim, W);
        # shapes 8-10 split each walk over P = 8, 8 and 5 CTAs, with slot 0
        # at position 0 (its runs after the first wholly dead); 11-15 take
        # the kernels' other paths: hd 80 (10 pieces of bf16, not a
        # multiple of the dot's 8 lanes), hd 40 and 36 (element loads and
        # rows padded to 16 bytes for int8/fp8, and for bf16 at 36), W*g 20
        # x hd 256 and hd 384 (a ring of 2 stages for f32 pools; 16 lanes a
        # key at 384); 16-18 take the plans that the first split design
        # refused: blocks of 256 rows (f32: both kernels walk each block in
        # 2 parts) and of 128 rows at hd 224 (f32: parts; bf16 exact:
        # parts), and blocks of one row at hd 336, W*g 20 (f32 online: a
        # chunk of fewer blocks); 19-20 the speculative verify windows of
        # the serving mixes (b) and (a) (W 8 at S 1024 and 160)
        shapes = ((3, 4, 8, 2, 1, 64, 1), (3, 3, 16, 2, 2, 128, 2),
                  (2, 3, 32, 1, 4, 64, 5), (5, 7, 16, 2, 1, 128, 1),
                  (4, 2, 8, 3, 4, 128, 2), (1, 5, 32, 2, 2, 64, 5),
                  (2, 1, 16, 1, 1, 64, 1), (2, 64, 16, 2, 1, 128, 1),
                  (3, 256, 16, 1, 2, 64, 3), (8, 64, 16, 8, 1, 128, 1),
                  (2, 6, 16, 2, 2, 80, 2), (2, 5, 8, 2, 1, 40, 3),
                  (3, 4, 16, 1, 2, 36, 1), (1, 4, 16, 1, 4, 256, 5),
                  (2, 3, 16, 1, 1, 384, 1), (2, 4, 256, 1, 1, 128, 1),
                  (2, 3, 128, 2, 1, 224, 1), (1, 256, 1, 1, 4, 336, 5),
                  (8, 64, 16, 8, 1, 128, 8), (4, 10, 16, 8, 1, 128, 8))
        n = dead_total = 0
        plans = set()
        for pool_dt, q_dt in pool_types:
            worst = {k: 0.0 for k in paged}
            for i, shape in enumerate(shapes):
                args = paged_state(*shape, pool_dt, q_dt, seed=i)
                moved, dead = moved_dead(args)
                dead_total += dead
                unaligned = [*args[:1], misaligned(args[1]),
                             misaligned(args[2]), *args[3:]]
                for k, (fn, plain) in paged.items():
                    got = fn(*args)
                    plan = plan_of(kind_of[k], *args)
                    plans.add((kind_of[k], shape[5], str(pool_dt),
                               (*plan[:3], plan[4])))
                    what = (f"{k} {shape} (P, stages, cb, sub) = "
                            f"{(*plan[:3], plan[4])} {pool_dt} q {q_dt}")
                    err = sm.expect_close(k, got, plain(*args), what,
                                          quiet=True)
                    worst[k] = max(worst[k], err)
                    # the same bits again, with the dead blocks moved, and
                    # from pools that are not 16-byte aligned
                    if not torch.equal(fn(*args), got):
                        raise AssertionError(f"{what}: two calls differ")
                    if not torch.equal(fn(*moved), got):
                        raise AssertionError(f"{what}: the output depends "
                                             "on dead table entries")
                    if not torch.equal(fn(*unaligned), got):
                        raise AssertionError(f"{what}: unaligned pools "
                                             "give other bits")
                    n += 1
            print(f"   pools {pool_dt}, q {q_dt}: {len(shapes)} shapes "
                  f"within {PAGED_TOL[str(q_dt).split('.')[-1]]}, max abs "
                  f"err {worst}; each call's bits equal on a second call, "
                  "with the dead table entries pointed elsewhere and from "
                  "unaligned pools", flush=True)
        ps = [ac.paged_splits(sh[0], sh[3], sh[1], sh[2]) for sh in shapes]
        print(f"   P over the shapes: {ps}; {dead_total} dead table "
              "entries moved; plans (kernel, hd, pool, (P, stages, cb, "
              f"sub)) other than 3 stages of whole chunks: "
              f"{sorted(p for p in plans if p[3][1] != 3 or p[3][3] != 1)}",
              flush=True)
        if not any(p[3][1] == 2 for p in plans):
            raise AssertionError("no shape took a ring of 2 stages")
        for kind in ("exact", "online"):
            if not any(p[0] == kind and p[3][3] > 1 for p in plans):
                raise AssertionError(f"no shape walked its blocks in parts "
                                     f"({kind})")
        if not any(p[0] == "online" and p[3][3] == 1 and p[1] == 336
                   and p[3][2] < ac.chunk_blocks(1) for p in plans):
            raise AssertionError("no online plan took a chunk of fewer "
                                 "blocks")

        # the layout's two copies: the wrapper's sizes equal the source's,
        # blocks walked whole (sub 1) and in parts (sub 2, 4, 3)
        lib = ac._lib()
        n_layout = 0
        for (exact, elem, wg, maxb, bs, hd, p, stages, cb,
             sub) in itertools.product(
                (True, False), (1, 2, 4), (1, 20), (1, 64, 3560),
                (1, 16, 64, 48), (36, 128, 384), (1, 8), (2, 3), (1, 4),
                (1, 2, 4, 3)):
            if bs % sub:
                continue
            want = ac._layout_bytes(exact, wg, maxb, bs, hd, p, elem, stages,
                                    cb, sub)
            got = lib.hpx_paged_smem_bytes(int(exact), elem, wg, maxb, bs, hd,
                                           cb, sub, p, stages)
            if got != want:
                raise AssertionError(
                    f"shared memory of {(exact, elem, wg, maxb, bs, hd, p)}"
                    f" stages {stages} cb {cb} sub {sub}: {want} in "
                    f"attention_cuda.py, {got} in paged_attention.cu")
            n_layout += 1
        print("   shared-memory layout: attention_cuda.py's sizes equal "
              f"paged_layout's on {n_layout} shapes", flush=True)

        # above the shared-memory cap (W*g*S/P scores, P raised to 8) the
        # exact kernel raises: W*g*S = 20*24576
        args = paged_state(1, 1536, 16, 1, 4, 64, 5, torch.float32,
                           torch.float32, seed=99)
        try:
            ac.fused_paged_attention(*args)
        except ValueError as e:
            print(f"   W*g*S = 20*24576 raises: {e}", flush=True)
        else:
            raise AssertionError("fused_paged_attention took a shape "
                                 "above its shared-memory cap")
        sm.expect_close("fused_paged_online_attention",
                        ac.fused_paged_online_attention(*args),
                        plain_online(*args),
                        f"fused_paged_online_attention at W*g*S = 20*24576,"
                        f" P={splits_of(*args)}")
        # 528 CTAs already (paged_splits gives P = 1) at long S, f32, hd
        # 16: the exact kernel at one CTA a (slot, head) where its run
        # fits (S 49600), P raised where it does not (S 56960, the one-CTA
        # design's cap); the online kernel at P = 1 on both
        for maxb, raised in ((3100, False), (3560, True)):
            args = long_state(66, maxb, 8, 16, seed=maxb)
            plan = plan_of("exact", *args)
            if ac.paged_splits(66, 8, maxb, 16) != 1 or (plan[0] > 1) != raised:
                raise AssertionError(f"S {maxb * 16}: plan {plan}")
            for k, (fn, plain) in paged.items():
                sm.expect_close(k, fn(*args), plain(*args),
                                f"{k} B 66 x 8 heads of 16, S {maxb * 16}, "
                                f"plan {plan_of(kind_of[k], *args)[:3]}")
            print(f"   S {maxb * 16} at 528 CTAs: exact plan "
                  f"(P, stages, cb) = {plan[:3]}", flush=True)
            del args
        # f32 pools, hd 512: 2 stages of 64 rows do not fit, so both
        # kernels halve their chunk (the online kernel's fold follows it)
        args = paged_state(2, 4, 16, 1, 1, 512, 1, torch.float32,
                           torch.float32, seed=98)
        for k, (fn, plain) in paged.items():
            plan = plan_of(kind_of[k], *args)
            if plan[2] >= ac.chunk_blocks(16):
                raise AssertionError(f"hd 512 f32: plan {plan}")
            got = fn(*args)
            sm.expect_close(k, got, plain(*args),
                            f"{k} hd 512 f32, plan {plan}")
            if not torch.equal(fn(*args), got):
                raise AssertionError("hd 512: two calls differ")
        print(f"   {n} paged-kernel comparisons passed", flush=True)
    sm.phase("paged kernel checks", paged_kernel_checks)

    def tile_of(q):
        """Keys a tile of the forward kernels on q's dtype: the bf16
        (wgmma) kernel's FLASH_TILE_N, the f32 kernel's FLASH_BLOCK; their
        plain versions fold in the same tiles."""
        return ac.FLASH_TILE_N if q.dtype == torch.bfloat16 else \
            ac.FLASH_BLOCK

    def plain_fwd(q, k, v, causal=False):
        return ac.plain_flash_fwd(q, k, v, causal, tile_of(q))

    def plain_chunk(q, k, v, acc, m, l, d, causal=False):
        return ac.plain_flash_chunk(q, k, v, acc, m, l, d, causal, tile_of(q))

    @contextlib.contextmanager
    def plain_flash():
        """flash_attention's autograd Function over the plain versions,
        on the card: the flash wrappers swapped for their plain versions
        (the forward's in its kernel's tiles) while the block runs (for
        comparisons; nothing is launched)."""
        plain = {"flash_attention_fwd": plain_fwd,
                 "flash_attention_bwd": ac.plain_flash_bwd,
                 "flash_attention_bwd_f32": ac.plain_flash_bwd}
        names = (*FLASH_KERNELS, *FLASH_F32_BWD)
        saved = [getattr(ac, k) for k in names]
        for k in names:
            setattr(ac, k, plain[k])
        try:
            yield
        finally:
            for k, fn in zip(names, saved):
                setattr(ac, k, fn)

    def flash_state(b, sq, sk, nq, nkv, h, dt, seed):
        """q, k, v, do in the kernel layout, random normal, on the card."""
        cpu = torch.Generator().manual_seed(seed)

        def r(rows, s_):
            return torch.randn(rows, s_, h, generator=cpu).to(dt).cuda()
        return r(b * nq, sq), r(b * nkv, sk), r(b * nkv, sk), r(b * nq, sq)

    def tile_fault_readings(q, k, v, do, causal, tile=64):
        """What the norm check reads where a kernel skips one tile of
        ``tile`` rows: for each tile t, ||x_t - x|| / ||x|| with x_t the
        output without t (o: the forward skips key tile t; dq: key tile
        t's dq partial is left out, as the bf16 backward would by
        dropping one CTA's dq reduce at tile 128; dk, dv: q tile t is
        skipped, as the bf16 backward would skip one 64-row tile), in f32
        on these inputs (MHA, sq == sk). Returns the smallest over t."""
        q, k, v, do = (x.float() for x in (q, k, v, do))
        scale = 1.0 / math.sqrt(q.shape[-1])
        s = torch.einsum("rqh,rkh->rqk", q, k) * scale
        if causal:
            s = s.masked_fill(torch.ones(s.shape[1:], dtype=torch.bool,
                                         device=s.device).triu(1),
                              float("-inf"))
        p = torch.softmax(s, -1)
        o = p @ v
        ds = p * (do @ v.transpose(1, 2)
                  - (do * o).sum(-1, keepdim=True)) * scale
        dq, dk, dv = ds @ k, ds.transpose(1, 2) @ q, p.transpose(1, 2) @ do
        out = {"o": [], "dq": [], "dk": [], "dv": []}
        for t0 in range(0, s.shape[-1], tile):
            t = slice(t0, t0 + tile)
            pt = p.clone()
            pt[..., t] = 0
            lt = pt.sum(-1, keepdim=True)
            out["o"].append(_norm_rel(
                torch.where(lt > 0, pt @ v / lt.clamp_min(1e-30), 0.0), o))
            out["dq"].append(_norm_rel(dq - ds[..., t] @ k[:, t], dq))
            out["dk"].append(_norm_rel(
                dk - ds[:, t].transpose(1, 2) @ q[:, t], dk))
            out["dv"].append(_norm_rel(
                dv - p[:, t].transpose(1, 2) @ do[:, t], dv))
        return {name: min(r) for name, r in out.items()}

    def early_release_readings():
        """The norm readings of the bf16 forward built with each K/V stage
        released before its P V completed (P V then reads the tile the
        producer refilled the stage with), B 8, S 1024, 8 heads, causal,
        against the plain version, at H 64 (64-row CTAs) and H 128
        (128-row CTAs: two consumer warpgroups, 256 arrivals a stage):
        the check must see both."""
        out = {}
        for h in (64, 128):
            q, k, v, _ = flash_state(8, 1024, 1024, 8, 8, h, torch.bfloat16,
                                     seed=77)
            bn, sq, _ = q.shape
            o = torch.empty_like(q)
            lse = torch.empty((bn, sq), device="cuda")
            block_m, smem = ac.flash_fwd_plan(h, bn, sq)
            if block_m != 64 * (h // 64):
                raise AssertionError(f"H {h}: the plan took block_m "
                                     f"{block_m}")
            code = ac._flash_lib().hpx_flash_fwd_bf16_early_release(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr(), bn, bn, sq, sq, h, 1, ac._flash_scale(h),
                block_m, smem, torch.cuda.current_stream().cuda_stream)
            torch.cuda.synchronize()
            if code != 0:
                raise AssertionError(f"the early-release build did not "
                                     f"launch: {code}")
            out[f"hd {h}, block_m {block_m}"] = _norm_rel(
                o, plain_fwd(q, k, v, True)[0])
        return out

    def f32_fwd_fault_reading(q, k, v, causal, want):
        """The f32 forward (flash_fwd_tf32x3) built with the big·big
        product alone (1xTF32) on the inputs of a check: the largest
        |got - want| / (atol + rtol |want|) over o and L against the
        plain version's ``want``: above 1 fails the check."""
        bn, sq, h = q.shape
        o, lse = torch.empty_like(q), torch.empty(q.shape[:2],
                                                  device=q.device)
        rtol, atol = FLASH_TOL["fwd"]
        code = ac._flash_lib().hpx_flash_fwd_f32_one_term(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), bn, k.shape[0], sq, k.shape[1], h, int(causal),
            ac._flash_scale(h), *ac.flash_fwd_f32_plan(h, bn, sq),
            torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        if code != 0:
            raise AssertionError(f"the f32 forward's 1xTF32 build did not "
                                 f"launch: {code}")
        return max(((g - w).abs() / (atol + rtol * w.abs())).max().item()
                   for g, w in zip((o, lse), want))

    def f32_fault_readings(args, want):
        """The f32 backward built with a planted fault, on the arguments
        of a check: "1xTF32" (the big·big product alone) and "dq of key
        tile 0 left out"; each reading the largest |got - want| / (atol
        + rtol |want|) over dq, dk and dv, against the plain version's
        ``want``: above 1 fails the check."""
        q, k, v, do, delta, lse, d, causal = args
        bn, sq, h = q.shape
        bnkv, sk = k.shape[0], k.shape[1]
        rtol, atol = FLASH_TOL["bwd"]
        lib = ac._flash_lib()
        out = {}
        for name, entry in (("1xTF32", lib.hpx_flash_bwd_f32_one_term),
                            ("dq of key tile 0 left out",
                             lib.hpx_flash_bwd_f32_drop_tile)):
            dq = torch.zeros_like(q)
            dk, dv = torch.empty_like(k), torch.empty_like(v)
            code = entry(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         do.data_ptr(), delta.data_ptr(), lse.data_ptr(),
                         dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), bn,
                         bnkv, sq, sk, h, d, int(causal), ac._flash_scale(h),
                         ac.flash_bwd_f32_plan(h, bnkv, sk)[2],
                         torch.cuda.current_stream().cuda_stream)
            torch.cuda.synchronize()
            if code != 0:
                raise AssertionError(f"the f32 backward's {name} build did "
                                     f"not launch: {code}")
            out[name] = max(((g - w).abs() / (atol + rtol * w.abs()))
                            .max().item() for g, w in zip((dq, dk, dv), want))
        return out

    def forward_at(q, k, v, d, causal):
        """(o in q's dtype, L) of the forward at causal offset d: the plain
        fold of every key from an empty carry, finished as the ring
        finishes (0 on a row that sees no key)."""
        acc = torch.zeros(q.shape, device=q.device)
        m = torch.full(q.shape[:2], -1e30, device=q.device)
        acc, m, l = plain_chunk(q, k, v, acc, m, torch.zeros_like(m), d,
                                causal)
        live, l1 = l > 0, l.clamp_min(1e-30)
        o = torch.where(live[..., None], acc / l1[..., None], 0.0)
        return o.to(q.dtype), torch.where(live, m + torch.log(l1), 0.0)

    def bwd_edges(seeds):
        """The bf16 backward where its design has edges: B 8 (grids of 132
        CTAs or more at MHA), MQA 8/1 (a CTA walks the 8 q heads of its
        K/V row), Sk not a multiple of its 128-key tiles, Sq = 1 at d < 0
        (no key seen: dq 0); H 64 and 128, causal or not, every offset
        with its own forward's L."""
        n, worst = 0, 0.0
        for h in ac.FLASH_HEAD_DIMS:
            for sq, sk in ((300, 300), (1000, 1000), (257, 1029), (1, 1029)):
                for causal in (False, True):
                    for nq, nkv in ((8, 8), (8, 1)):
                        q, k, v, do = flash_state(8, sq, sk, nq, nkv, h,
                                                  torch.bfloat16, next(seeds))
                        for d in ((sk - sq, 0, -16) if causal
                                  else (sk - sq,)):
                            od, ld = forward_at(q, k, v, d, causal)
                            args = (q, k, v, do, ac.bwd_prep(do, od), ld, d,
                                    causal, nq, nkv)
                            got = ac.flash_attention_bwd(*args)
                            want = ac.plain_flash_bwd(*args)
                            for name, g, wt in zip(("dq", "dk", "dv"), got,
                                                   want):
                                worst = max(worst, sm.expect_close(
                                    "flash_attention_bwd", g, wt,
                                    f"{name} bf16 hd {h} B 8 sq {sq} sk {sk} "
                                    f"causal {causal} heads {nq}/{nkv} d {d}",
                                    quiet=True, tol=FLASH_TOL["bf16"],
                                    norm=True))
                            n += 1
        print(f"   {n} bf16 backward cases at B 8 (MHA: 64 K/V rows; MQA "
              f"8/1), sq 1-1000, sk 300-1029, every offset: max abs err "
              f"{worst!r} (tolerance {FLASH_TOL['bf16']}, by the norm <= "
              f"{FLASH_NORM_REL})", flush=True)

    def flash_kernel_checks():
        n = 0
        seeds = itertools.count(1)
        faults, faults128, f32_faults, fwd_faults = [], [], [], []
        for dt in (torch.float32, torch.bfloat16):
            f32 = dt == torch.float32
            tf = FLASH_TOL["fwd" if f32 else "bf16"]
            tb = FLASH_TOL["bwd" if f32 else "bf16"]
            for h in (64, 128):
                worst = {}
                for sq, sk in ((1, 1), (37, 53), (48, 16), (16, 48),
                               (129, 129), (200, 200), (1, 200), (300, 129),
                               (1000, 1000), (1024, 1024)):
                    for causal in (False, True):
                        for nq, nkv in ((8, 8), (8, 2)):
                            q, k, v, do = flash_state(2, sq, sk, nq, nkv, h,
                                                      dt, next(seeds))
                            what = (f"{dt} hd {h} sq {sq} sk {sk} causal "
                                    f"{causal} heads {nq}/{nkv}")
                            o, lse = ac.flash_attention_fwd(q, k, v, causal)
                            po, plse = plain_fwd(q, k, v, causal)
                            track = "flash_attention_fwd f32" if f32 \
                                else None
                            errs = [sm.expect_close(
                                "flash_attention_fwd", o, po, f"o {what}",
                                quiet=True, tol=tf, norm=not f32,
                                track=track),
                                sm.expect_close(
                                "flash_attention_fwd", lse, plse,
                                f"L {what}", quiet=True,
                                tol=FLASH_TOL["fwd"], track=track)]
                            worst["flash_attention_fwd"] = max(
                                worst.get("flash_attention_fwd", 0.0), *errs)
                            if f32 and sq == sk == 1024:
                                fwd_faults.append(f32_fwd_fault_reading(
                                    q, k, v, causal, (po, plse)))
                            # the backward (kernels 6-7) at offsets d, each
                            # given the o and L of the forward at its own
                            # offset, so that L covers every key a row
                            # sees and p <= 1, as the ring gives them
                            offsets = ((sk - sq, 0, -16) if causal
                                       else (sk - sq,))
                            for d in offsets:
                                od, ld = ((po, plse) if d == sk - sq else
                                          forward_at(q, k, v, d, causal))
                                args = (q, k, v, do, ac.bwd_prep(do, od), ld,
                                        d, causal)
                                w = f"{what} d {d}"
                                # one kernel, dk/dv per K/V row: f32
                                # flash_bwd_tf32x3, bf16 flash_bwd_wgmma
                                got = ac.flash_attention_bwd(*args, nq, nkv)
                                want = ac.plain_flash_bwd(*args, nq, nkv)
                                kern = (FLASH_F32_BWD[0] if f32
                                        else "flash_attention_bwd")
                                for name, g, wt in zip(("dq", "dk", "dv"),
                                                       got, want):
                                    err = sm.expect_close(
                                        kern, g, wt, f"{name} {w}",
                                        quiet=True, tol=tb, norm=not f32)
                                    worst[kern] = max(worst.get(kern, 0.0),
                                                      err)
                                if f32 and sq == sk == 1024 and d == 0:
                                    f32_faults.append(f32_fault_readings(
                                        args, want))
                            if sq == sk == 1024 and nq == nkv and not f32:
                                faults.append(tile_fault_readings(
                                    q, k, v, do, causal))
                                faults128.append(tile_fault_readings(
                                    q, k, v, do, causal, ac.FLASH_TILE_N))
                            n += 1
                print(f"   flash {dt} hd {h}: within fwd {tf}, bwd {tb}; "
                      f"max abs err {worst}", flush=True)
        print(f"   {n} flash-kernel cases passed (forward, and backward "
              "at every offset d); largest error over its tolerance: "
              f"{ {k: sm.margin[k] for k in (*FLASH_KERNELS, *FLASH_F32_BWD)} }",
              flush=True)
        print(f"   bf16 norm-relative readings, largest of every case: "
              f"{sm.norm_rel} (limit {FLASH_NORM_REL})", flush=True)
        f32_fault = {k: min(f[k] for f in f32_faults) for k in f32_faults[0]}
        print(f"   planted faults of the f32 backward (flash_bwd_tf32x3, S "
              f"1024, H 64 and 128, MHA and GQA, causal or not; the largest "
              f"|got - want| / (atol + rtol |want|) over dq, dk, dv, the "
              f"smallest over {len(f32_faults)} cases; above 1 fails "
              f"{FLASH_TOL['bwd']}): {f32_fault}", flush=True)
        if min(f32_fault.values()) <= 1:
            raise AssertionError(f"the 1e-4 check would miss a fault of the "
                                 f"f32 backward: {f32_fault}")
        print(f"   f32 forward (flash_fwd_tf32x3): largest error over its "
              f"tolerance {FLASH_TOL['fwd']} on every f32 case, o and L "
              f"{sm.margin['flash_attention_fwd f32']!r}", flush=True)
        print(f"   planted fault of the f32 forward (flash_fwd_tf32x3 with "
              f"big·big alone, 1xTF32; S 1024, H 64 and 128, MHA and GQA, "
              f"causal or not; the largest |got - want| / (atol + rtol "
              f"|want|) over o and L, the smallest over {len(fwd_faults)} "
              f"cases; above 1 fails {FLASH_TOL['fwd']}): {min(fwd_faults)!r}",
              flush=True)
        if min(fwd_faults) <= 1:
            raise AssertionError(f"the 1e-5 check would miss the f32 "
                                 f"forward's 1xTF32 build: {fwd_faults}")
        fault = {k: min(f[k] for f in faults) for k in faults[0]}
        fault128 = {k: min(f[k] for f in faults128) for k in ("o", "dq")}
        print(f"   planted fault, one 64-row tile skipped (S 1024, MHA, "
              f"bf16 inputs; smallest reading over tiles, hd and causal; "
              f"dk, dv: a q tile of the bf16 backward): {fault}; the bf16 "
              f"backward's dq partial of one 128-key tile left out: "
              f"{fault128['dq']!r}", flush=True)
        if min(fault.values()) <= FLASH_NORM_REL or \
                fault128["dq"] <= FLASH_NORM_REL:
            raise AssertionError(f"the norm check would miss a skipped "
                                 f"tile: {fault}, {fault128}")
        bwd_edges(seeds)
        # the 128-row CTA of the bf16 forward (two consumer warpgroups):
        # H 128 on grids of 132 CTAs or more (B 8 x 8 heads), ragged,
        # causal at offsets d = +-64 that put a key tile past one
        # warpgroup's diagonal and not the other's, GQA
        wide, worst = 0, 0.0
        for sq, sk in ((300, 300), (600, 664), (664, 600), (1000, 1000),
                       (257, 1029)):
            for causal in (False, True):
                for nq, nkv in ((8, 8), (8, 2)):
                    q, k, v, _ = flash_state(8, sq, sk, nq, nkv, 128,
                                             torch.bfloat16, next(seeds))
                    block_m = ac.flash_fwd_plan(128, q.shape[0], sq)[0]
                    if block_m != 128:
                        raise AssertionError(f"sq {sq}: the plan took "
                                             f"block_m {block_m}, not 128")
                    what = (f"bf16 hd 128 B 8 sq {sq} sk {sk} causal "
                            f"{causal} heads {nq}/{nkv}, block_m 128")
                    o, lse = ac.flash_attention_fwd(q, k, v, causal)
                    po, plse = plain_fwd(q, k, v, causal)
                    worst = max(worst, sm.expect_close(
                        "flash_attention_fwd", o, po, f"o {what}",
                        quiet=True, tol=FLASH_TOL["bf16"], norm=True))
                    sm.expect_close("flash_attention_fwd", lse, plse,
                                    f"L {what}", quiet=True,
                                    tol=FLASH_TOL["fwd"])
                    wide += 1
        print(f"   {wide} bf16 forward cases at block_m 128 (H 128, B 8, "
              f"sq 257-1000, d = +-64, GQA) passed: o max abs err {worst} "
              f"(tolerance {FLASH_TOL['bf16']}, by the norm <= "
              f"{FLASH_NORM_REL}), L within {FLASH_TOL['fwd']}", flush=True)
        # the bf16 forward's own faults: a skipped 128-key tile, and a
        # stage released before its P V completed (at both block_m)
        early = early_release_readings()
        print(f"   planted faults of the bf16 forward (S 1024, MHA): one "
              f"128-key tile skipped, smallest reading over tiles, hd and "
              f"causal {fault128['o']!r}; each stage released before its "
              f"P V completed {early} (limit {FLASH_NORM_REL})",
              flush=True)
        if fault128["o"] <= FLASH_NORM_REL or \
                min(early.values()) <= FLASH_NORM_REL:
            raise AssertionError("the norm check would miss a fault of the "
                                 f"bf16 forward: {fault128['o']}, {early}")
        # the bf16 forward's layout: the plan's sizes equal fwd_layout's
        lib = ac._flash_lib()
        plans = ((64, 64), (128, 64), (128, 128))
        for h, bm in plans:
            want = ac.flash_fwd_smem_bytes(h, bm)
            got = lib.hpx_flash_fwd_smem_bytes(h, bm)
            if got != want:
                raise AssertionError(f"bf16 forward, H {h}, block_m {bm}: "
                                     f"{want} bytes in attention_cuda.py, "
                                     f"{got} in flash_attention.cu")
        print(f"   bf16 forward's shared memory: attention_cuda.py's sizes "
              f"equal fwd_layout's on the {len(plans)} built plans",
              flush=True)
        for h in ac.FLASH_HEAD_DIMS:
            want = ac.flash_bwd_plan(h, 64, 1024)[2]
            got = lib.hpx_flash_bwd_smem_bytes(h)
            if got != want or want != ac.flash_bwd_smem_bytes(h):
                raise AssertionError(f"bf16 backward, H {h}: the plan's "
                                     f"{want} bytes, bwd_layout's {got}")
        print("   bf16 backward's shared memory: flash_bwd_plan's sizes "
              "equal bwd_layout's at H 64 and 128", flush=True)
        for h in ac.FLASH_HEAD_DIMS:
            want = ac.flash_fwd_f32_plan(h, 64, 1024)[1]
            got = lib.hpx_flash_fwd_f32_smem_bytes(h)
            if got != want or want != ac.flash_fwd_f32_smem_bytes(h):
                raise AssertionError(f"f32 forward, H {h}: the plan's "
                                     f"{want} bytes, f3_layout's {got}")
        print("   f32 forward's shared memory: flash_fwd_f32_plan's sizes "
              "equal f3_layout's at H 64 and 128", flush=True)
        # the autograd Function's gradients through the kernels against
        # the same Function over the plain versions, [B, S, N, H]
        for dt, (sq, sk, nq, nkv, h, causal) in (
                (torch.float32, (300, 300, 8, 2, 64, True)),
                (torch.float32, (128, 200, 8, 8, 128, False)),
                (torch.bfloat16, (300, 300, 8, 2, 64, True)),
                (torch.bfloat16, (1024, 1024, 8, 8, 64, True))):
            cpu = torch.Generator().manual_seed(sq + h)

            def r(s_, heads):
                return torch.randn(2, s_, heads, h, generator=cpu).to(
                    dt).cuda()
            q, k, v, w = r(sq, nq), r(sk, nkv), r(sk, nkv), r(sq, nq)

            def grads():
                xs = [x.clone().requires_grad_() for x in (q, k, v)]
                out = ac.flash_attention(*xs, causal)
                g = torch.autograd.grad((out.float() * w.float()).sum(), xs)
                return (out.detach(), *g)
            got = grads()
            with plain_flash():
                want = grads()
            tol = FLASH_TOL["bf16"] if dt == torch.bfloat16 else None
            bwd = ("flash_attention_bwd" if tol else FLASH_F32_BWD[0],) * 3
            for name, g, wt, kern in zip(
                    ("o", "dq", "dk", "dv"), got, want,
                    ("flash_attention_fwd", *bwd)):
                t = tol or FLASH_TOL["fwd" if name == "o" else "bwd"]
                sm.expect_close(kern, g, wt,
                                f"flash_attention {name} {dt} sq {sq} sk "
                                f"{sk} heads {nq}/{nkv} hd {h} causal "
                                f"{causal}: kernels vs plain Function",
                                tol=t, norm=tol is not None)
        print(f"   bf16 norm-relative readings with the Function's: "
              f"{sm.norm_rel} (limit {FLASH_NORM_REL})", flush=True)
    sm.phase("flash kernel checks", flash_kernel_checks)

    def chunk_state(sq, sk, nq, nkv, h, dt, seed, b=2):
        """q, k, v in the kernel layout and a carry (acc, m, l) left by
        folding an earlier, fully visible chunk into (0, -1e30, 0)."""
        q, k0, v0, _ = flash_state(b, sq, sk, nq, nkv, h, dt, seed)
        _, k, v, _ = flash_state(b, sq, sk, nq, nkv, h, dt, seed + 1000)
        acc = torch.zeros(q.shape, device="cuda")
        m = torch.full(q.shape[:2], -1e30, device="cuda")
        carry = plain_chunk(q, k0, v0, acc, m, torch.zeros_like(m), sk, True)
        return q, k, v, carry

    def chunk_fault_reading(q, k, v, carry, d, causal, want_acc):
        """||acc_t - acc|| / ||acc|| for acc_t the fold without key tile
        t of the kernel's tiles (the keys before it at d, the keys after
        it at d - their start), smallest over t."""
        sk, reads, tile = k.shape[1], [], tile_of(q)
        for t0 in range(0, sk, tile):
            a = tuple(x.clone() for x in carry)
            if t0:
                a = plain_chunk(q, k[:, :t0], v[:, :t0], *a, d, causal)
            if t0 + tile < sk:
                a = plain_chunk(q, k[:, t0 + tile:], v[:, t0 + tile:], *a,
                                d - t0 - tile, causal)
            reads.append(_norm_rel(a[0], want_acc))
        return min(reads)

    def f32_chunk_fault_readings(q, k, v, carry, causal, want):
        """The f32 chunk fold (flash_fwd_tf32x3, kChunk) built with a
        planted fault, at d = 0 from ``carry``: "1xTF32" (the big·big
        product alone) and "key tile 0 left out"; each reading the
        largest |got - want| / (atol + rtol |want|) over acc / l (l the
        plain version's), m and l against the plain version's ``want``:
        above 1 fails the check."""
        bn, sq, h = q.shape
        rtol, atol = FLASH_TOL["fwd"]
        lib = ac._flash_lib()
        den = want[2].clamp_min(1e-30)[..., None]
        out = {}
        for name, entry in (("1xTF32", lib.hpx_flash_chunk_f32_one_term),
                            ("key tile 0 left out",
                             lib.hpx_flash_chunk_f32_drop_tile)):
            acc, m, l = (x.clone() for x in carry)
            code = entry(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         acc.data_ptr(), m.data_ptr(), l.data_ptr(), bn,
                         k.shape[0], sq, k.shape[1], h, 0, int(causal),
                         ac._flash_scale(h), *ac.flash_fwd_f32_plan(h, bn, sq),
                         torch.cuda.current_stream().cuda_stream)
            torch.cuda.synchronize()
            if code != 0:
                raise AssertionError(f"the f32 chunk fold's {name} build did "
                                     f"not launch: {code}")
            out[name] = max(((g - w).abs() / (atol + rtol * w.abs())).max()
                            .item() for g, w in ((acc / den, want[0] / den),
                                                 (m, want[1]), (l, want[2])))
        return out

    def chunk_kernel_checks():
        """Kernel 8 against plain_flash_chunk from a carry an earlier
        fold left. acc in bf16 at 2e-2 and by the norm; in f32 as acc / l,
        l the plain version's, at the f32 forward's 1e-5: the carry is
        unnormalized (sums of about l times the values' size), and acc /
        l is the o the ring's finish makes of it, held as the forward's
        o is; its raw elementwise reading against 1e-5 is printed. m and
        l at the f32 forward's 1e-5."""
        n, faults, raw = 0, [], []
        seeds = itertools.count(5001)

        def check(q, k, v, carry, d, causal, what):
            f32 = q.dtype == torch.float32
            want = plain_chunk(q, k, v, *carry, d, causal)
            got = ac.flash_attention_chunk(q, k, v,
                                           *(x.clone() for x in carry), d,
                                           causal)
            torch.cuda.synchronize()
            track = "flash_attention_chunk f32" if f32 else None
            if f32:
                g, w = got[0], want[0]
                raw.append(((g - w).abs() / (1e-5 + 1e-5 * w.abs())).max()
                           .item())
                den = want[2].clamp_min(1e-30)[..., None]
                err = sm.expect_close(
                    "flash_attention_chunk", g / den, w / den,
                    f"acc / l {what}", quiet=True, tol=FLASH_TOL["fwd"],
                    track=track)
            else:
                err = sm.expect_close(
                    "flash_attention_chunk", got[0], want[0],
                    f"acc {what}", quiet=True, tol=FLASH_TOL["bf16"],
                    norm=True)
            for name, g, w in zip("ml", got[1:], want[1:]):
                sm.expect_close("flash_attention_chunk", g, w,
                                f"{name} {what}", quiet=True,
                                tol=FLASH_TOL["fwd"], track=track)
            return err, want

        for dt in (torch.float32, torch.bfloat16):
            f32 = dt == torch.float32
            for h in (64, 128):
                worst = 0.0
                for sq, sk in ((64, 64), (37, 53), (129, 200), (200, 129),
                               (512, 512)):
                    for nq, nkv in ((8, 8), (8, 2)):
                        for causal, ds in ((True, (sk, 0, -1, -sq)),
                                           (False, (0,))):
                            for d in ds:
                                q, k, v, carry = chunk_state(
                                    sq, sk, nq, nkv, h, dt, next(seeds))
                                what = (f"{dt} hd {h} sq {sq} sk {sk} heads "
                                        f"{nq}/{nkv} causal {causal} d {d}")
                                err, want = check(q, k, v, carry, d, causal,
                                                  what)
                                worst = max(worst, err)
                                if sq == 512 and not f32 and nq == nkv \
                                        and d in (sk, 0):
                                    faults.append(chunk_fault_reading(
                                        q, k, v, carry, d, causal, want[0]))
                                n += 1
                print(f"   flash_chunk {dt} hd {h}: "
                      f"{'acc / l' if f32 else 'acc'} max abs err {worst} "
                      f"(tolerance {FLASH_TOL['fwd' if f32 else 'bf16']}), "
                      f"m and l within {FLASH_TOL['fwd']}", flush=True)
        # f32 at S 1024 (d = 0): flash_fwd_tf32x3's chunk fold built with
        # big·big alone (1xTF32) and with key tile 0 left out must each
        # read above the f32 limit on every case
        f32_faults = []
        for h in (64, 128):
            for nq, nkv in ((8, 8), (8, 2)):
                for causal in (True, False):
                    q, k, v, carry = chunk_state(1024, 1024, nq, nkv, h,
                                                 torch.float32, next(seeds))
                    _, want = check(q, k, v, carry, 0, causal,
                                    f"f32 hd {h} sq 1024 sk 1024 heads "
                                    f"{nq}/{nkv} causal {causal} d 0")
                    f32_faults.append(f32_chunk_fault_readings(
                        q, k, v, carry, causal, want))
                    n += 1
        f32_fault = {k: min(f[k] for f in f32_faults) for k in f32_faults[0]}
        print(f"   f32 chunk fold (flash_fwd_tf32x3): largest error over its "
              f"tolerance {FLASH_TOL['fwd']} on every f32 case, acc / l, m "
              f"and l {sm.margin['flash_attention_chunk f32']!r}", flush=True)
        print(f"   {len(f32_faults)} f32 chunk cases at S 1024 passed; planted "
              f"faults of the f32 chunk fold (flash_fwd_tf32x3; the largest "
              f"|got - want| / (atol + rtol |want|) over acc / l, m and l, "
              f"the smallest over the cases; above 1 fails "
              f"{FLASH_TOL['fwd']}): {f32_fault}", flush=True)
        if min(f32_fault.values()) <= 1:
            raise AssertionError(f"the 1e-5 check would miss a fault of the "
                                 f"f32 chunk fold: {f32_fault}")
        over = sum(r > 1 for r in raw)
        print(f"   f32 acc unnormalized, elementwise against rtol = atol = "
              f"1e-5: largest |got - want| / (1e-5 + 1e-5 |want|) "
              f"{max(raw)!r}, above 1 in {over} of {len(raw)} f32 cases "
              "(held as acc / l above)", flush=True)
        # the 128-row CTA of the chunk fold (two consumer warpgroups): H
        # 128 on B 8 x 8 heads, causal at offsets that put a key tile past
        # one warpgroup's diagonal and not the other's (d = +-64), GQA
        wide = 0
        for sq, sk in ((300, 300), (600, 664)):
            for nq, nkv in ((8, 8), (8, 2)):
                for causal, ds in ((True, (sk, 64, 0, -64, -sq)),
                                   (False, (0,))):
                    for d in ds:
                        q, k, v, carry = chunk_state(
                            sq, sk, nq, nkv, 128, torch.bfloat16,
                            next(seeds), b=8)
                        block_m = ac.flash_fwd_plan(128, q.shape[0], sq)[0]
                        if block_m != 128:
                            raise AssertionError(f"sq {sq}: the plan took "
                                                 f"block_m {block_m}")
                        check(q, k, v, carry, d, causal,
                              f"bf16 hd 128 B 8 sq {sq} sk {sk} heads "
                              f"{nq}/{nkv} causal {causal} d {d}, block_m "
                              "128")
                        n += 1
                        wide += 1
        print(f"   {wide} bf16 chunk cases at block_m 128 passed",
              flush=True)
        print(f"   {n} chunk-kernel cases passed so far; largest error over its "
              f"tolerance {sm.margin['flash_attention_chunk']}; bf16 "
              f"norm-relative reading of acc, largest "
              f"{sm.norm_rel['flash_attention_chunk']} (limit "
              f"{FLASH_NORM_REL})", flush=True)
        # the ring path's own shape: each rank's q [32, 512, 64] bf16
        # (B 8 x 4 local heads) against one kv chunk, at the offsets of
        # its own chunk, a past one and a future one
        tol = FLASH_TOL["bf16"]
        for d in (0, 512, -512):
            q, k, v, carry = chunk_state(512, 512, 16, 16, 64,
                                         torch.bfloat16, next(seeds))
            want = plain_chunk(q, k, v, *carry, d, True)
            got = ac.flash_attention_chunk(q, k, v,
                                           *(x.clone() for x in carry), d,
                                           True)
            what = f"ring shape q {list(q.shape)} bf16 causal d {d}"
            err = sm.expect_close("flash_attention_chunk", got[0], want[0],
                                  f"acc {what}", quiet=True, tol=tol,
                                  norm=True)
            for name, g, w in zip("ml", got[1:], want[1:]):
                sm.expect_close("flash_attention_chunk", g, w,
                                f"{name} {what}", quiet=True,
                                tol=FLASH_TOL["fwd"])
            print(f"   {what}: acc max abs err {err!r} (tolerance {tol}), "
                  f"by the norm {_norm_rel(got[0], want[0])!r} (limit "
                  f"{FLASH_NORM_REL}); m and l within {FLASH_TOL['fwd']}",
                  flush=True)
            n += 1
        fault = min(faults)
        print(f"   planted fault, one {ac.FLASH_TILE_N}-row key tile skipped "
              f"(512 x 512, MHA, bf16, d = 512 and 0; smallest over tiles "
              f"and hd): {fault}", flush=True)
        if fault <= FLASH_NORM_REL:
            raise AssertionError(f"the norm check would miss a skipped "
                                 f"tile: {fault}")
    sm.phase("flash chunk kernel checks", chunk_kernel_checks)

    # -- 3. the main path ---------------------------------------------------------
    def run_path(fn):
        for k in kernels:
            k.launches = 0
        fn()
        for k in kernels:
            sm.launches[k.__name__] += k.launches

    def fused():
        for nx, nt, spd in ((1 << 27, 256, 64), (1 << 19, 1024, 1024)):
            p = s1.StencilParams(nx=nx, np_=1, nt=nt, k=0.3)
            u0 = s1.init_domain(p)
            torch.cuda.synchronize()
            t = HighResolutionTimer()
            got = s1.stencil_fused(p, u0, steps_per_dispatch=spd)
            torch.cuda.synchronize()
            s1.print_time_results("fused (first run)", t.elapsed(), p)
            if got.shape != u0.shape or not torch.isfinite(got).all():
                raise AssertionError("fused result not finite or misshapen")
            s0, s_end = u0.double().sum().item(), got.double().sum().item()
            if abs(s_end - s0) > 1e-5 * abs(s0):
                raise AssertionError(f"sum not conserved: {s0} -> {s_end}")
            sm.expect_equal("multistep_fused", got,
                            st.plain_multistep(u0, p.coef, nt),
                            f"stencil_fused n=2^{nx.bit_length() - 1} "
                            f"nt={nt} steps_per_dispatch={spd}")
        # a float64 numpy reference on a small input
        p = s1.StencilParams(nx=4096, np_=1, nt=50, k=0.25)
        got = s1.stencil_fused(p).cpu().numpy().astype(np.float64)
        ref = np.arange(p.total, dtype=np.float64)
        for _ in range(p.nt):
            ref = ref + p.coef * (np.roll(ref, 1) - 2 * ref + np.roll(ref, -1))
        np.testing.assert_allclose(got, ref, rtol=1e-4)
        print("   stencil_fused n=4096 nt=50 agrees with float64 numpy "
              "(rtol 1e-4)")

    def unfused():
        for n in (1 << 28, (1 << 20) + 3):
            p = s1.StencilParams(nx=n, np_=1, nt=16, k=0.3)
            u0 = s1.init_domain(p)
            torch.cuda.synchronize()
            t = HighResolutionTimer()
            got = u0
            for _ in range(p.nt):
                got = st.heat_step_best(got, p.coef)
            torch.cuda.synchronize()
            s1.print_time_results("unfused (first run)", t.elapsed(), p)
            want = u0
            for _ in range(p.nt):
                want = st.plain_heat_step_blocked(want, p.coef)
            sm.expect_equal("heat_step_blocked", got, want,
                            f"heat_step_best x{p.nt} n={n}")
            del got, want

    def dataflow():
        p = s1.StencilParams(nx=1 << 20, np_=16, nt=32, k=0.3)
        want = s1.stencil_serial(p)
        for eager in (True, False):
            ex = CudaExecutor(eager=eager)
            torch.cuda.synchronize()
            t = HighResolutionTimer()
            got = s1.gather_dataflow_result(s1.stencil_dataflow(p, ex))
            torch.cuda.synchronize()
            mode = "eager" if eager else "watched"
            s1.print_time_results(f"dataflow {mode}", t.elapsed(), p)
            if not torch.equal(got, want):
                raise AssertionError(f"dataflow ({mode}) differs from "
                                     "stencil_serial")
            print(f"   dataflow ({mode}) equals stencil_serial")

    def saxpy_path():
        """Config #1 as examples_cuda/saxpy_cuda.py runs it: z = a*x + y
        by two transforms, then dot(z, x) by transform_reduce, all under
        par.on(cuda_executor()) on CUDA tensors. No synchronization and
        so no copy to the host while the algorithms run (torch's sync
        debug mode set to "error" around them), every result a tensor
        on cuda:0 until the final float(); z within Z_RTOL and dot
        within DOT_RTOL of float64 numpy, and so is dot through a known
        and through the general fold. Then the same under par.task:
        with the card held busy by torch.cuda._sleep, the launching
        thread returns at once and the future is not ready until the
        device work is done; its z and dot equal the blocking run's
        bit for bit (the same kernels on the same inputs)."""
        from examples_cuda import saxpy_cuda as sx
        n, a = 1 << SAXPY_LOG2N, 2.5
        ex = hpx.cuda_executor()
        policy = hpx.par.on(ex)
        x, y = sx.inputs(n, ex.target.device)
        torch.cuda.synchronize()
        mode = torch.cuda.get_sync_debug_mode()
        t = HighResolutionTimer()
        torch.cuda.set_sync_debug_mode("error")
        try:
            z, dot = sx.saxpy_dot(policy, x, y, a)
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        enqueue = t.elapsed()
        for name_, v in (("z", z), ("dot", dot)):
            if not isinstance(v, torch.Tensor) or v.device != x.device:
                raise AssertionError(f"config #1: {name_} is not a tensor "
                                     f"on {x.device}: {type(v)}")
        if z.shape != x.shape or not bool(torch.isfinite(z).all()):
            raise AssertionError("config #1: z not finite or misshapen")
        z64, dot64 = sx.reference(x, y, a)
        z_rel = float(np.max(np.abs(z.cpu().numpy() - z64) / np.abs(z64)))
        dot_rel = abs(float(dot) - dot64) / abs(dot64)
        print(f"   n=2^{SAXPY_LOG2N} on {x.device}: dot {float(dot)!r}, "
              f"float64 {dot64!r}, relative {dot_rel!r} (<= "
              f"{sx.DOT_RTOL}); z max relative {z_rel!r} (<= "
              f"{sx.Z_RTOL}); enqueued in {enqueue * 1e3!r} ms with no "
              "synchronization", flush=True)
        if z_rel > sx.Z_RTOL or dot_rel > sx.DOT_RTOL:
            raise AssertionError(f"config #1 off float64: z {z_rel}, "
                                 f"dot {dot_rel}")
        # the same dot through a reduce operator with no known fold: the
        # general device fold (algo/reductions._tree_fold, log2(n) rounds
        # of the vmapped op), timed beside the known fold's
        times = {}
        for name_, op in (("known fold", torch.add),
                          ("general fold", lambda p, q: p + q)):
            torch.cuda.synchronize()
            t = HighResolutionTimer()
            torch.cuda.set_sync_debug_mode("error")
            try:
                d = hpx.transform_reduce(policy, z, 0.0, op, torch.mul,
                                         rng2=x)
            finally:
                torch.cuda.set_sync_debug_mode(mode)
            torch.cuda.synchronize()
            times[name_] = t.elapsed()
            rel = abs(float(d) - dot64) / abs(dot64)
            print(f"   transform_reduce, {name_}: {times[name_] * 1e3!r} ms "
                  f"to the result, dot relative {rel!r} (<= "
                  f"{sx.DOT_RTOL})", flush=True)
            if not rel <= sx.DOT_RTOL:
                raise AssertionError(f"config #1 {name_} off float64: {rel}")
        task = policy.task
        torch.cuda._sleep(1)    # the spin kernel loaded before any clock
        torch.cuda.synchronize()
        t = HighResolutionTimer()
        torch.cuda._sleep(1_000_000_000)    # ~0.5 s of device work ahead
        ahead = t.elapsed()
        # the launch's own time: the spin kernel's launch before it once
        # took 130 ms of host time (the device work then ended as late)
        t_launch = HighResolutionTimer()
        f1 = hpx.transform(task, x, lambda xi: a * xi)
        launched = t_launch.elapsed()
        early = f1.is_ready()
        z1 = f1.get(timeout=60)
        waited = t.elapsed()
        z2 = hpx.transform(task, z1, torch.add, rng2=y).get(timeout=60)
        fd = hpx.transform_reduce(task, z2, 0.0, torch.add, torch.mul,
                                  rng2=x)
        if not isinstance(fd, hpx.Future):
            raise AssertionError(f"par.task returned {type(fd)}")
        dot_t = fd.get(timeout=60)
        print(f"   par.task: launch returned after {launched * 1e3!r} ms "
              f"(the device work ahead launched in {ahead * 1e3!r} ms), "
              f"future ready then: {early}; ready after {waited * 1e3!r} "
              f"ms; dot {float(dot_t)!r}", flush=True)
        if early or launched > 0.05 or waited < 0.1:
            raise AssertionError("par.task: the future was ready before "
                                 "the device work, or the launch waited")
        if not (torch.equal(z2, z) and torch.equal(dot_t, dot)):
            raise AssertionError("par.task results differ from the "
                                 "blocking run's")

    bench_lines = []

    def bench_path():
        """hpx_tpu_torch/tools/bench.py's five metrics once (one sample
        of one chain at each end of each slope): kernel 9 (the probe),
        kernel 2 and kernel 1 run on this path; the headline last."""
        from hpx_tpu_torch.tools import bench
        lines = bench.run(samples=1, repeats=1, smi=smi)
        got = [line["metric"] for line in lines]
        want = ["stream_triad_gbs", "copy_stream_elems",
                "1d_stencil_unfused_cell_updates", "fft_1d_gflops",
                "1d_stencil_cell_updates"]
        if got != want or not all(
                math.isfinite(line["value"]) and line["value"] > 0
                for line in lines):
            raise AssertionError(f"bench lines {got}: {lines}")
        bench_lines.extend(lines)

    config3 = {}

    def algorithms_path():
        """Senders and the one-device algorithms on cuda:0, no fallback:
        config #3 (the STREAM triad over partitioned_vectors of 2^24 f32,
        4 partitions on the card) enqueued under sync debug mode "error";
        sort, scans and set operations at 2^24 / 2^22 against numpy, each
        data-dependent result with exactly one synchronization; the FFT at
        2^22; and a sender pipeline against its CPU run."""
        import threading
        import warnings
        from examples_cuda import saxpy_cuda as sx
        from hpx_tpu_torch import algo as al
        from hpx_tpu_torch.algo import fft as dfft
        from hpx_tpu_torch.exec import p2300 as ex
        from hpx_tpu_torch.parallel.mesh import Mesh
        from hpx_tpu_torch.tools import bench
        dev = torch.device("cuda", 0)
        policy = hpx.par.on(hpx.cuda_executor())
        rng = np.random.default_rng(7)
        mode = torch.cuda.get_sync_debug_mode()

        def syncs(fn):
            """(fn(), the synchronizing CUDA operations it made), read
            under sync debug mode "warn"."""
            torch.cuda.synchronize()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    out = fn()
                finally:
                    torch.cuda.set_sync_debug_mode(mode)
            return out, sum("synchronizing" in str(w.message)
                            for w in caught)

        def bits(t):
            a = t.cpu().numpy() if isinstance(t, torch.Tensor) else t
            return a.view(f"u{a.dtype.itemsize}") if a.dtype.kind == "f" \
                else a

        def same(got, want, what):
            if got.shape != want.shape or not np.array_equal(bits(got),
                                                             bits(want)):
                raise AssertionError(f"{what}: differs from numpy")

        # -- config #3: a = b + s*c over partitioned_vectors ---------------
        n, s_ = 1 << 24, 3.0
        layout = hpx.container_layout(4)
        b32 = rng.random(n, np.float32)
        c32 = rng.random(n, np.float32)
        pv_b = hpx.partitioned_vector.from_array(torch.from_numpy(b32).to(dev),
                                                 layout)
        pv_c = hpx.partitioned_vector.from_array(torch.from_numpy(c32).to(dev),
                                                 layout)

        def triad(x, y):     # one kernel, as bench.py's via_transform
            return torch.add(x, y, alpha=s_)
        torch.cuda.synchronize()
        t = HighResolutionTimer()
        torch.cuda.set_sync_debug_mode("error")
        try:
            a = hpx.transform(policy, pv_b, triad, pv_c)
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        enqueue = t.elapsed()
        if not isinstance(a, hpx.PartitionedVector) or a.layout is not \
                layout or a.size != n or a.data.device != dev:
            raise AssertionError(f"config #3: {a!r} is not a vector of "
                                 f"{n} on {dev} with the source's layout")
        segs = [(g.begin, g.end, g.devices) for g in a.segments()]
        if segs != [(k * n // 4, (k + 1) * n // 4, (dev,)) for k in range(4)]:
            raise AssertionError(f"config #3 segments {segs}")
        want = b32.astype(np.float64) + s_ * c32.astype(np.float64)
        rel = float(np.max(np.abs(a.to_numpy() - want) / np.abs(want)))
        if not rel <= sx.Z_RTOL:
            raise AssertionError(f"config #3 off float64: {rel}")

        def chain(k):
            x = pv_b
            t0 = time.perf_counter()
            for _ in range(k):
                x = hpx.transform(policy, x, triad, pv_c)
            float(x.data[0])
            return time.perf_counter() - t0
        per, spread = bench.robust(
            lambda: bench.slope_time(chain, 64, 640, 3), 3)
        gbs = 3 * n * 4 / per / 1e9
        config3.update(metric="config3_triad_gbs", value=gbs, unit="GB/s",
                       vs_baseline=gbs / bench.HBM_PEAK_GBS, spread=spread,
                       dispatch_ms=per * 1e3, n=n, partitions=4,
                       max_rel_err=rel, device=smi)
        triad_line = next((x for x in bench_lines
                           if x["metric"] == "stream_triad_gbs"), {})
        print(f"   config #3: 4 partitions of 2^22 f32 on {dev}, a = b + "
              f"{s_}*c by hpx.transform(par.on(cuda_executor()), pv_b, f, "
              f"pv_c), f = torch.add(x, y, alpha={s_}): a PartitionedVector with the source's layout, "
              f"enqueued in {enqueue * 1e3!r} ms with no synchronization; "
              f"max relative error {rel!r} (<= {sx.Z_RTOL}); {gbs!r} GB/s "
              f"by the slope of 64 and 640 dependent dispatches (spread "
              f"{spread!r}), beside stream_triad_gbs "
              f"{triad_line.get('value')!r} (via_transform_gbs "
              f"{triad_line.get('via_transform_gbs')!r}); on {smi}",
              flush=True)
        del pv_b, pv_c, a

        # a host policy given a vector on the card works on a host copy
        # and leaves the vector as it was, as the reference copies a
        # device array to the host
        src = rng.random(1000, np.float32)
        pv_s = hpx.partitioned_vector.from_array(torch.from_numpy(src).to(dev),
                                                 layout)
        got = hpx.for_each(hpx.seq, pv_s, lambda x: x * 2.0 + 1.0)
        same(torch.from_numpy(got.to_numpy()), src * np.float32(2.0) +
             np.float32(1.0), "for_each(seq, vector on the card)")
        same(pv_s.data.cpu()[:1000], src, "the vector after for_each(seq)")
        if pv_s.data.device != dev:
            raise AssertionError(f"for_each(seq) moved its source to "
                                 f"{pv_s.data.device}")
        print(f"   for_each(seq, pv, f) over 1000 f32 of a vector on {dev}: "
              f"the result bit for bit f over numpy's copy, the vector "
              f"unchanged on the card", flush=True)
        del pv_s, got

        # -- sorting at 2^24 ---------------------------------------------
        f = rng.standard_normal(n).astype(np.float32)
        idx = rng.permutation(n)
        neg_nan = np.array([0xFFC00001], np.uint32).view(np.float32)[0]
        f[idx[:n // 64]] = np.nan
        f[idx[n // 64:n // 32]] = neg_nan
        f[idx[n // 32:n // 16]] = -0.0
        f[idx[n // 16:n // 8]] = 0.0
        ints = rng.integers(-2 ** 31, 2 ** 31, n).astype(np.int32)
        ft, it = torch.from_numpy(f).to(dev), torch.from_numpy(ints).to(dev)
        times = {}

        def timed(name, fn):
            times[name] = _cuda_ms(fn, 3)
            return fn()
        same(timed("sort f32", lambda: al.sort(policy, ft)),
             np.sort(f, kind="stable"), "sort f32 with NaN, -0.0, +0.0")
        same(timed("sort int32", lambda: al.sort(policy, it)),
             np.sort(ints), "sort int32")
        same(timed("sort(key=abs) f32", lambda: al.sort(policy, ft,
                                                        key=torch.abs)),
             f[np.argsort(np.abs(f), kind="stable")], "sort(key=abs)")
        # the k smallest by IEEE total order (the reference's
        # -lax.top_k(-x, k)): -NaN first, -0.0 before +0.0, +NaN last; on
        # |normal| values with 3 -NaN, 200 -0.0, 300 +0.0 and 300 NaN
        k = 1024
        h = np.abs(rng.standard_normal(n)).astype(np.float32)
        pick = rng.permutation(n)[:803]
        h[pick[:3]], h[pick[3:203]] = neg_nan, -0.0
        h[pick[203:503]], h[pick[503:]] = 0.0, np.nan
        hb = h.view(np.int32)
        key = np.sort(np.where(hb < 0, hb ^ 0x7FFFFFFF, hb))[:k]
        ht = torch.from_numpy(h).to(dev)
        psc = timed("partial_sort_copy k=1024 f32",
                    lambda: al.partial_sort_copy(policy, ht, k))
        same(psc, np.where(key < 0, key ^ 0x7FFFFFFF, key).view(np.float32),
             "partial_sort_copy(k = 1024)")
        srt = np.sort(rng.integers(0, 1 << 20, n).astype(np.int32))
        st_ = torch.from_numpy(srt).to(dev)
        uniq, n_sync = syncs(lambda: al.unique(policy, st_))
        same(uniq, srt[np.concatenate([[True], srt[1:] != srt[:-1]])],
             "unique")
        times["unique int32"] = _cuda_ms(lambda: al.unique(policy, st_), 3)
        counts = {"unique": n_sync}
        (part, point), counts["partition"] = syncs(
            lambda: al.partition(policy, ft, lambda x: x > 0))
        pos = f > 0
        same(part, np.concatenate([f[pos], f[~pos]]), "partition")
        if point != int(pos.sum()):
            raise AssertionError(f"partition point {point}")
        times["partition f32"] = _cuda_ms(
            lambda: al.partition(policy, ft, lambda x: x > 0), 3)

        # -- scans at 2^24 ------------------------------------------------
        g = rng.standard_normal(n).astype(np.float32)
        gt = torch.from_numpy(g).to(dev)
        c64 = np.cumsum(g.astype(np.float64))
        bound = (np.arange(n) * (np.finfo(np.float32).eps)
                 * np.cumsum(np.abs(g.astype(np.float64))))
        worst = {}
        for name, fn, want_ in (
                ("inclusive_scan + f32",
                 lambda: al.inclusive_scan(policy, gt), c64),
                ("exclusive_scan + f32",
                 lambda: al.exclusive_scan(policy, gt, 0.0),
                 np.concatenate([[0.0], c64[:-1]]))):
            out = timed(name, fn).cpu().numpy()
            b_ = bound if name.startswith("inclusive") else \
                np.concatenate([[0.0], bound[:-1]])
            if out.dtype != np.float32 or not np.all(
                    np.abs(out - want_) <= b_):
                raise AssertionError(f"{name}: off float64 beyond "
                                     "i*eps*sum|a|")
            worst[name] = float(np.max(np.abs(out - want_)
                                       / np.maximum(b_, 1e-30)))
        small = rng.integers(-1000, 1000, n).astype(np.int32)
        smt = torch.from_numpy(small).to(dev)
        ci = np.cumsum(small, dtype=np.int32)
        for name, fn, want_ in (
                ("inclusive_scan + int32",
                 lambda: al.inclusive_scan(policy, smt), ci),
                ("exclusive_scan + int32",
                 lambda: al.exclusive_scan(policy, smt, 0),
                 np.concatenate([[0], ci[:-1]]).astype(np.int32)),
                ("inclusive_scan general op (log2 n rounds) int32",
                 lambda: al.inclusive_scan(policy, smt, 0,
                                           lambda x, y: x + y), ci)):
            same(timed(name, fn), want_, name)

        # -- set operations on sorted int32 multisets of 2^22 -------------
        m = 1 << 22
        sa = np.sort(rng.integers(0, 1 << 20, m).astype(np.int32))
        sb = np.sort(rng.integers(1 << 19, 3 << 19, m).astype(np.int32))
        ta, tb = torch.from_numpy(sa).to(dev), torch.from_numpy(sb).to(dev)
        va, na = np.unique(sa, return_counts=True)
        vb, nb = np.unique(sb, return_counts=True)
        vals = np.union1d(va, vb)
        ma = np.zeros(len(vals), np.int64)
        mb = np.zeros(len(vals), np.int64)
        ma[np.searchsorted(vals, va)] = na
        mb[np.searchsorted(vals, vb)] = nb
        setops = {"set_union": np.maximum(ma, mb),
                  "set_intersection": np.minimum(ma, mb),
                  "set_difference": np.maximum(ma - mb, 0),
                  "set_symmetric_difference": np.abs(ma - mb)}
        for name, mult in setops.items():
            fn = functools.partial(getattr(al, name), policy, ta, tb)
            got, counts[name] = syncs(fn)
            same(got, np.repeat(vals, mult).astype(np.int32), name)
            times[f"{name} int32"] = _cuda_ms(fn, 3)
        inter = torch.from_numpy(np.repeat(vals, setops["set_intersection"])
                                 .astype(np.int32)).to(dev)
        got, counts["includes"] = syncs(
            lambda: al.includes(policy, ta, inter))
        if got is not True or al.includes(policy, ta, tb) is not False:
            raise AssertionError("includes: a multiset does not include "
                                 "its intersection, or includes the other")
        times["includes int32"] = _cuda_ms(
            lambda: al.includes(policy, ta, tb), 3)
        if any(v != 1 for v in counts.values()):
            raise AssertionError(f"synchronizations a call, want 1 each: "
                                 f"{counts}")
        print(f"   sort (f32 with NaN of both signs, -0.0, +0.0 planted; "
              f"int32; key=abs), partial_sort_copy(k = 1024), unique and "
              f"partition at 2^24, the five set operations on sorted int32 "
              f"multisets of 2^22: bitwise equal to numpy; scans at 2^24: "
              f"int32 exact, f32 within i*eps*sum|a| (worst share of the "
              f"bound {worst}); synchronizations a call {counts}; ms a call "
              f"(CUDA events) {times}; on {smi}", flush=True)
        del ft, it, ht, st_, gt, smt, ta, tb, inter

        # -- the FFT at 2^22 ----------------------------------------------
        mesh = Mesh((1,), ("x",))
        v = (rng.standard_normal(m) + 1j * rng.standard_normal(m)).astype(
            np.complex64)
        vt = torch.from_numpy(v).to(dev)
        y = dfft.fft_sharded(vt, mesh)
        if y.shape != (m,) or y.dtype != torch.complex64 or \
                not bool(torch.isfinite(torch.view_as_real(y)).all()):
            raise AssertionError("fft: misshapen or not finite")
        ref = np.fft.fft(v.astype(np.complex128))
        fwd = float(np.linalg.norm(y.cpu().numpy() - ref)
                    / np.linalg.norm(ref))
        back = dfft.ifft_sharded(y, mesh).cpu().numpy()
        trip = float(np.linalg.norm(back - v) / np.linalg.norm(v))
        fft_ms = _cuda_ms(lambda: dfft.fft_sharded(vt, mesh), 5)
        print(f"   fft_sharded of 2^22 complex64 on a one-rank mesh "
              f"({dfft._split_n(m, 1)}): forward {fwd!r} by the norm of "
              f"float64 np.fft.fft (<= 1e-4), round trip {trip!r} (<= "
              f"1e-5); {fft_ms!r} ms a transform (CUDA events); on {smi}",
              flush=True)
        if not (fwd <= 1e-4 and trip <= 1e-5):
            raise AssertionError(f"fft: forward {fwd}, round trip {trip}")
        del vt, y

        # -- a sender pipeline --------------------------------------------
        u = torch.from_numpy(rng.random(m, np.float32))
        x = u.to(dev)

        def pipeline(sch, then_dev, x_):
            seen = np.zeros(m, np.uint8)

            def g(i, y_):
                seen[i] = 1
            out = ex.sync_wait(ex.schedule(sch)
                               | then_dev(lambda: x_ * 2.0 + 1.0)
                               | ex.bulk(m, g), timeout=600)
            if not seen.all():
                raise AssertionError("bulk missed an index")
            return out
        t = HighResolutionTimer()
        y_gpu = pipeline(ex.cuda_scheduler(), ex.then_on_device, x)
        secs = t.elapsed()
        cpu_ex = hpx.CudaExecutor(device="cpu")
        y_cpu = pipeline(ex.cuda_scheduler(cpu_ex),
                         lambda f_: ex.then_on_device(f_, cpu_ex), u)
        if y_gpu.device != dev or not torch.equal(y_gpu.cpu(), y_cpu):
            raise AssertionError("the sender pipeline on the card differs "
                                 "from its CPU run")
        names = []
        torch.cuda.synchronize()
        t = HighResolutionTimer()
        torch.cuda._sleep(1_000_000_000)    # ~0.5 s of device work ahead
        fut = ex.as_future(
            ex.schedule(ex.cuda_scheduler())
            | ex.then_on_device(lambda: x * 2.0 + 1.0)
            | ex.then(lambda y_: names.append(
                threading.current_thread().name) or y_))
        launched, early = t.elapsed(), fut.is_ready()
        y2 = fut.get(timeout=60)
        waited = t.elapsed()
        print(f"   sync_wait(schedule(cuda_scheduler()) | then_on_device(f) "
              f"| bulk(2^22, g)): equal to its run on the CPU, {secs!r} s "
              f"(bulk's 2^22 host calls included); with the card held "
              f"busy the sender's future was ready at launch: {early} "
              f"({launched * 1e3!r} ms), ready after {waited * 1e3!r} ms, "
              f"delivered on {names}", flush=True)
        if early or launched > 0.05 or waited < 0.1 or not names or \
                not names[0].startswith("hpx-torch-watcher") or \
                not torch.equal(y2, y_gpu):
            raise AssertionError("then_on_device's value did not wait for "
                                 "its CUDA event on the watcher")

    def graph_nodes(what, progs, want=None):
        """Each CUDA graph captured for ``progs`` (GraphProgram), read
        back: the kernel nodes of each counted wrapper in it (the nodes
        whose function the wrapper's pattern names, from the graph
        itself), held equal to the launches the wrapper made while the
        graph was captured and, where ``want`` names the program, to
        want[name] ({wrapper: nodes}). Returns {program: [each graph's
        {wrapper: nodes}]}."""
        seen = {}
        for prog in progs:
            for g in prog.graphs.values():
                nodes = {}
                for w in programs._COUNTED:
                    n = sum(c for k, c in g.kernels.items()
                            if w.kernels.search(k))
                    if n:
                        nodes[w.__name__] = n
                expect = (want or {}).get(prog.name, nodes)
                if nodes != g.wrapper_launches or nodes != expect:
                    raise AssertionError(
                        f"{what}: a graph of {prog.name} holds the kernel "
                        f"nodes {nodes}; its wrappers launched "
                        f"{g.wrapper_launches} while it was captured; want "
                        f"{expect}; all its kernel nodes {dict(g.kernels)}")
                seen.setdefault(prog.name, []).append(nodes)
        return seen

    def server_nodes(srv):
        """The counted kernels' nodes a server's graphs must hold: a
        paged step or verify on the fused kernels one launch a layer; the
        dense and gather steps and verifies, the chunks, the probe and
        the draft model's programs none."""
        step = {"fused": "fused_paged_attention",
                "fused_online": "fused_paged_online_attention"}.get(
                    srv._paged_kernel if srv.paged else None)
        paged_ = {step: srv.cfg.n_layers} if step else {}
        return {"cb_step": {}, "cb_chunk": {}, "cb_probe": {},
                "cb_verify": {}, "cb_draft": {}, "cb_dchunk": {},
                "pg_step": paged_, "pg_verify": paged_}

    def sgd_nodes(cfg):
        """The SGD step's graph: the flash forward and the backward of
        the weights' type (kernels 6-7 in one), once a layer."""
        bwd = ("flash_attention_bwd_f32" if cfg.dtype == torch.float32
               else "flash_attention_bwd")
        return {"sgd_step": {"flash_attention_fwd": cfg.n_layers,
                             bwd: cfg.n_layers}}

    # the serving model at full width; mixes (a) and (b) from seeds
    mixes = serve_mixes()
    mix_a = mixes["a"][0]
    models = {}

    def model(dtype):
        if dtype not in models:
            cfg = tf.TransformerConfig(**SERVE_MODEL, dtype=dtype)
            models[dtype] = (tf.init_params(cfg, seed=0), cfg)
        return models[dtype]

    def serve(mix, label, dtype, **kw):
        reqs, base = mixes[mix]
        params, cfg = model(dtype)
        srv = serving.ContinuousServer(params, cfg, **base, **kw)
        for p, m in reqs:
            srv.submit(p, max_new=m)
        torch.cuda.synchronize()
        t = HighResolutionTimer()
        with count_captures() as caps:
            out = srv.run()
        torch.cuda.synchronize()
        secs = t.elapsed()
        # a chunk program per ladder width, the probe, and the step with
        # and without sampling; speculative: a verify program per width
        # in place of the step and, with a draft model, its step and a
        # draft chunk per width
        ladder = len(srv.prefill_buckets)
        limit = ((2 + (srv._draft_params is not None)) * ladder + 2
                 if srv._spec else ladder + 3)
        if caps.captures > limit or \
                caps.captures != sum(len(g.graphs)
                                     for g in srv._graphs.values()):
            raise AssertionError(f"({mix}) {label}: {caps.captures} "
                                 f"captures for {ladder} ladder widths")
        nodes = graph_nodes(f"({mix}) {label}", srv._graphs.values(),
                            server_nodes(srv))
        ntok = sum(len(v) for v in out.values())
        if sorted(out) != list(range(len(reqs))) or any(
                len(out[i]) != m or not all(0 <= x < cfg.vocab
                                            for x in out[i])
                for i, (_, m) in enumerate(reqs)):
            raise AssertionError(f"({mix}) {label}: missing, short or "
                                 "out-of-vocabulary tokens")
        extra = ""
        if srv.paged:
            st_ = srv.cache_stats()
            extra = (f", kernel {srv.paged_kernel}, radix hit rate "
                     f"{st_['hit_rate']!r}, prefill tokens saved "
                     f"{st_['prefill_tokens_saved']}")
        print(f"   ({mix}) {label}: {ntok} tokens in {secs!r} s = "
              f"{ntok / secs!r} tokens/s{extra}; {caps.captures} CUDA "
              f"graphs captured; counted kernels' nodes read from each "
              f"graph (equal to the wrappers' launches in its capture): "
              f"{nodes}", flush=True)
        rates[mix, label] = ntok / secs
        return out, srv

    # the non-spec servers' tokens, and every server run's tokens/s, by
    # (mix, run), for the speculative phase
    plain_runs, rates = {}, {}

    def serving_f32():
        f32 = torch.float32
        # warm-up: cuBLAS and allocator set-up, kept out of the timings
        serve("a", "warm-up (dense)", f32)
        for mix in ("a", "b"):
            dense, _ = serve(mix, "f32 dense", f32)
            plain_runs[mix, "f32 dense"] = dense
            gather, _ = serve(mix, "f32 paged gather", f32, paged=True,
                              block_size=16, paged_kernel="gather")
            fused, srv = serve(mix, "f32 paged fused", f32, paged=True,
                               block_size=16, paged_kernel="fused")
            online, _ = serve(mix, "f32 paged fused_online", f32,
                              paged=True, block_size=16,
                              paged_kernel="fused_online")
            if not fused == online == gather == dense:
                bad = [label for label, o in (("fused", fused),
                                              ("fused_online", online),
                                              ("gather", gather))
                       if o != dense]
                raise AssertionError(f"({mix}) f32 tokens of {bad} differ "
                                     "from the dense server's")
            print(f"   ({mix}) f32 tokens: fused == fused_online == gather "
                  "== dense", flush=True)
            if mix == "a":
                st_ = srv.cache_stats()
                if st_["tokens_matched"] <= 0:
                    raise AssertionError("(a) the prefix mix never hit the "
                                         "radix tree")
                # the differential contract: a request's tokens are what
                # transformer.generate emits for its prompt alone
                params, cfg = model(f32)
                for rid in (0, 11):
                    p, m = mix_a[rid]
                    solo = tf.generate(params, cfg, [p], max_new=m)
                    if solo[0].tolist() != fused[rid]:
                        raise AssertionError(f"(a) request {rid} differs "
                                             "from generate() alone")
                print("   (a) requests 0 and 11 equal generate() run alone",
                      flush=True)

    def serving_long_blocks():
        """(b) in f32 with blocks of 256 rows, a shape the kernels' first
        split design refused (a stage held whole blocks): auto resolves
        to the exact kernel at construction, whose plan walks each block
        in 2 parts, as does the online kernel's; both kernels' tokens
        equal the gather server's."""
        f32, bs = torch.float32, 256
        cfg = model(f32)[1]
        plans = {k: ac.paged_plan(k == "fused", 8, cfg.kv_heads, 1,
                                  1024 // bs, bs, cfg.head_dim, 4)
                 for k in ("fused", "fused_online")}
        if any(p is None or p[4] < 2 for p in plans.values()):
            raise AssertionError(f"blocks of {bs}: plans {plans}")
        before = {k.__name__: k.launches for k in kernels}
        auto, srv = serve("b", f"f32 paged auto, blocks of {bs}", f32,
                          paged=True, block_size=bs)
        if srv.paged_kernel != "fused":
            raise AssertionError(f"auto resolved to {srv.paged_kernel}")
        online, _ = serve("b", f"f32 paged fused_online, blocks of {bs}",
                          f32, paged=True, block_size=bs,
                          paged_kernel="fused_online")
        gather, _ = serve("b", f"f32 paged gather, blocks of {bs}", f32,
                          paged=True, block_size=bs, paged_kernel="gather")
        ran = {k.__name__: k.launches - before[k.__name__] for k in kernels
               if k.__name__ in PAGED_KERNELS}
        if not auto == online == gather or min(ran.values()) <= 0:
            raise AssertionError(f"blocks of {bs}: f32 tokens of auto "
                                 f"(fused) == fused_online == gather: "
                                 f"{auto == gather}, {online == gather}; "
                                 f"launches {ran}")
        print(f"   (b) blocks of {bs}, f32: plans (P, stages, cb, smem, "
              f"sub) {plans}; tokens of auto (fused) == fused_online == "
              f"gather; kernel launches {ran}", flush=True)

    bf16_pools = []

    def serving_bf16():
        bf16 = torch.bfloat16
        fused, srv = serve("b", "bf16 paged auto", bf16, paged=True,
                           block_size=16)
        if srv._paged_kernel != "fused":
            raise AssertionError(f"auto resolved to {srv._paged_kernel}")
        gather, _ = serve("b", "bf16 paged gather", bf16, paged=True,
                          block_size=16, paged_kernel="gather")
        plain_runs["b", "bf16 paged gather"] = gather
        same = sum(a == b for r in gather for a, b in zip(fused[r], gather[r]))
        total = sum(len(v) for v in gather.values())
        whole = sum(fused[r] == gather[r] for r in gather)
        print(f"   (b) bf16 auto vs bf16 gather: {same}/{total} tokens and "
              f"{whole}/{len(gather)} requests equal", flush=True)
        bf16_pools.extend(srv._pools)

    def tie_gap(params, cfg, seq):
        """The top-2 gap of the f32 logits after the tokens ``seq``: how
        near a tie the pick at the next position is."""
        caches = [tuple(torch.zeros((1, len(seq), cfg.kv_heads,
                                     cfg.head_dim), dtype=cfg.dtype,
                                    device="cuda") for _ in range(2))
                  for _ in range(cfg.n_layers)]
        with torch.no_grad():
            _, last = tf._prefill_window(params, cfg, caches, torch.tensor(
                [seq], device="cuda"))
        top = last[0].topk(2).values
        return float(top[0] - top[1])

    def same_tokens(what, got, want, prompts, params, cfg):
        """got == want ({request: tokens}); where a request differs, the
        first differing pick must be a near-tie (its top-2 logit gap below
        TIE_GAP), printed either way. Returns the differing requests."""
        ties = []
        for r, w in want.items():
            g = list(got[r])
            if g == list(w):
                continue
            i = next((j for j, (a, b) in enumerate(zip(g, w)) if a != b),
                     min(len(g), len(w)))
            ties.append((r, i, tie_gap(params, cfg, list(prompts[r])
                                       + list(w[:i]))))
        if ties:
            print(f"   {what}: {len(ties)} of {len(want)} requests differ; "
                  f"(request, first differing pick, top-2 logit gap there) "
                  f"{ties}", flush=True)
        if any(gap > TIE_GAP for *_, gap in ties) or len(got) != len(want):
            raise AssertionError(f"{what}: tokens differ beyond a near-tie "
                                 f"(gap above {TIE_GAP}): {ties}")
        return ties

    spec_launches = {k: 0 for k in PAGED_KERNELS}

    def serving_spec():
        """Speculative serving at full width in f32 on mixes (a) and (b),
        prompt-lookup drafts at k = SPEC_K (verify width 8): the dense
        server and the paged server on gather, fused and fused_online,
        each server's tokens against the non-spec f32 dense server's;
        then a self-draft (draft = target: every draft accepted but at
        near-ties) and a small random draft model of the same width and
        one layer (most drafts rejected), both on the fused kernel. Each
        verify graph holds one node of its kernel a layer (serve's
        graph_nodes); the launches of kernels 3-4 in these runs are the
        verify windows' (``spec_launches``). Then (b) in bf16, fused,
        against the non-spec bf16 gather server: agreement printed."""
        f32 = torch.float32
        params, cfg = model(f32)
        dcfg = tf.TransformerConfig(**dict(SERVE_MODEL, n_layers=1),
                                    dtype=f32)
        dparams = tf.init_params(dcfg, seed=1)
        paged_kw = dict(paged=True, block_size=16)
        for mix in ("a", "b"):
            want = plain_runs[mix, "f32 dense"]
            prompts = {i: p for i, (p, _) in enumerate(mixes[mix][0])}
            runs = [("dense", {}),
                    *((f"paged {k}", dict(paged_kw, paged_kernel=k))
                      for k in ("gather", "fused", "fused_online")),
                    ("self-draft, paged fused",
                     dict(paged_kw, paged_kernel="fused",
                          draft_params=params, draft_cfg=cfg)),
                    ("random 1-layer draft, paged fused",
                     dict(paged_kw, paged_kernel="fused",
                          draft_params=dparams, draft_cfg=dcfg))]
            for label, kw in runs:
                before = {k: getattr(ac, k).launches for k in PAGED_KERNELS}
                label = f"f32 spec k={SPEC_K}, {label}"
                out, srv = serve(mix, label, f32, spec=True, spec_k=SPEC_K,
                                 **kw)
                for k in PAGED_KERNELS:
                    spec_launches[k] += getattr(ac, k).launches - before[k]
                ties = same_tokens(f"({mix}) {label}", out, want, prompts,
                                   params, cfg)
                st_ = srv.spec_stats()
                print(f"   ({mix}) {label}: tokens == the non-spec f32 dense "
                      f"server's ({len(ties)} near-ties); "
                      f"{rates[mix, label]!r} tokens/s against "
                      f"{rates[mix, 'f32 dense']!r} non-spec dense; spec "
                      f"stats {st_}; slots' k {srv._slot_k}", flush=True)
                if "self-draft" in label and st_["acceptance_rate"] < 0.9:
                    raise AssertionError(f"({mix}) self-draft accepted "
                                         f"{st_['acceptance_rate']}")
                if "random" in label and st_["acceptance_rate"] > 0.5:
                    raise AssertionError(f"({mix}) a random draft accepted "
                                         f"{st_['acceptance_rate']}")
        if not all(spec_launches.values()):
            raise AssertionError(f"kernels 3-4 never ran a verify window: "
                                 f"{spec_launches}")
        bf16 = torch.bfloat16
        out, srv = serve("b", f"bf16 spec k={SPEC_K}, paged auto", bf16,
                         spec=True, spec_k=SPEC_K, **paged_kw)
        gather = plain_runs["b", "bf16 paged gather"]
        same = sum(a == b for r in gather for a, b in zip(out[r], gather[r]))
        total = sum(len(v) for v in gather.values())
        print(f"   (b) bf16 spec (kernel {srv.paged_kernel}) vs bf16 non-spec "
              f"gather: {same}/{total} tokens and "
              f"{sum(out[r] == gather[r] for r in gather)}/{len(gather)} "
              f"requests equal; spec stats {srv.spec_stats()}; kernels 3-4 "
              f"launches in the f32 verify windows {spec_launches}; on "
              f"{smi}", flush=True)

    # -- fault ladder and tracing on the main path ----------------------------
    class Recording(faultinject.FaultInjector):
        """A FaultInjector that keeps the (site, nth) of each fault."""

        def __init__(self, **kw) -> None:
            super().__init__(**kw)
            self.fired = []

        def _decide(self, site):
            fire, nth = super()._decide(site)
            if fire:
                self.fired.append((site, nth))
            return fire, nth

    def graph_count(srv) -> int:
        return sum(len(g.graphs) for g in srv._graphs.values())

    # per (mix, run): what a faulted run gave, for the resilience line
    resilience = {}

    def paged_launches():
        return {k: getattr(ac, k).launches for k in PAGED_KERNELS}

    def faulted_run(mix, label, kw, sites, base, bsrv, ran0, want,
                    prompts, params, cfg):
        """One faulted run of serving_resilient, held to the fault-free
        run ``base`` of the server ``bsrv``, which launched kernels 3-4
        ``ran0`` times."""
        f32 = torch.float32
        tag = "" if sites == FAULT_SITES else f", sites {','.join(sites)}"
        before = paged_launches()
        fi = faultinject.install(Recording(
            seed=FAULT_SEED, rate=FAULT_RATE, max_faults=FAULT_MAX,
            sites=sites))
        try:
            out, srv = serve(mix, f"f32 {label}, faulted{tag}", f32, **kw)
        finally:
            faultinject.uninstall()
        ran = {k: n - before[k] for k, n in paged_launches().items()}
        ratio = {k: ran[k] / ran0[k] for k in ran if ran0[k]}
        what = f"({mix}) f32 {label}, faulted{tag}"
        st = srv.fault_stats()
        if srv.paged and out != base:
            raise AssertionError(f"{what}: tokens differ from the "
                                 "fault-free run's")
        ties = same_tokens(f"{what} against its fault-free run",
                           out, base, prompts, params, cfg)
        ties += same_tokens(f"{what} against the non-spec dense "
                            "server", out, want, prompts, params,
                            cfg)
        caps, caps0 = graph_count(srv), graph_count(bsrv)
        if caps != caps0 + srv._spec_degraded:
            raise AssertionError(f"{what}: {caps} CUDA graphs "
                                 f"captured, the fault-free run "
                                 f"{caps0}")
        if st["shed"] or srv.failed or srv._ckpt:
            raise AssertionError(f"{what}: shed {st['shed']}, failed "
                                 f"{srv.failed}, checkpoints left "
                                 f"{sorted(srv._ckpt)}")
        if st["injected"] != fi.total_injected or not fi.fired:
            raise AssertionError(f"{what}: {fi.total_injected} "
                                 f"faults injected, {st['injected']}"
                                 " counted")
        need = {s for s, n in fi.fired
                if s in ("decode", "verify")
                or (s == "prefill" and n > 1)}
        missing = [s for s in need
                   if st["restored_by_site"].get(s, 0) < 1]
        if missing:
            raise AssertionError(f"{what}: faults at {missing} "
                                 f"restored nothing: {st}")
        blocks = {}
        if srv.paged:
            a, b = srv.cache_stats(), bsrv.cache_stats()
            blocks = {k: (a[k], b[k]) for k in ("free",
                                                 "blocks_held")}
            if a["free"] + a["blocks_held"] != \
                    b["free"] + b["blocks_held"]:
                raise AssertionError(f"{what}: blocks free and "
                                     f"held by the radix tree "
                                     f"{blocks} (faulted, "
                                     "fault-free)")
        h = srv._restore_hist
        row = {"fault_stats": st, "fired": fi.fired,
               "restores": h.count,
               "restore_ms_median": h.quantile(0.5) * 1e3,
               "restore_ms_p99": h.quantile(0.99) * 1e3,
               "tokens_per_s": rates[mix, f"f32 {label}, faulted{tag}"],
               "tokens_per_s_fault_free":
                   rates[mix, f"f32 {label}, fault-free"],
               "captures": caps, "captures_fault_free": caps0,
               "launches": ran, "launches_fault_free": ran0,
               "launches_ratio": ratio, "blocks_free_held": blocks,
               "near_ties": len(ties)}
        resilience[mix, label + tag] = row
        print(f"   {what}: tokens == the fault-free run's; faults "
              f"(site, nth) {fi.fired}; fault_stats {st}; restore "
              f"ms median {row['restore_ms_median']!r}, p99 "
              f"{row['restore_ms_p99']!r} ({h.count} restores); "
              f"kernels 3-4 launches {ran} (fault-free {ran0}, "
              f"ratio {ratio}); {row['tokens_per_s']!r}"
              f" tokens/s against {row['tokens_per_s_fault_free']!r}"
              f" fault-free; CUDA graphs {caps} (fault-free "
              f"{caps0}); blocks (free, held) faulted/fault-free "
              f"{blocks}; on {smi}", flush=True)

    def serving_resilient():
        """The fault ladder at full width in f32 on mixes (a) and (b): the
        dense server, paged fused and fused_online, and speculative paged
        fused (prompt lookup, k = SPEC_K), each served fault-free and then
        under a seeded injector over FAULT_SITES (FAULT_RATE, at most
        FAULT_MAX faults); (b)'s paged servers again with alloc
        disarmed, since its alloc faults reach the cap before a decode
        check fires (``faulted_run``); and a warmed server of (b), dense
        and paged fused, fault-free and faulted (alloc disarmed) in the
        order A B B A, for what faults cost in tokens/s. A faulted run's
        tokens equal the fault-free run's (paged: exactly; dense restores
        re-prefill, so near-ties as ``same_tokens``) and the non-spec
        dense server's (near-ties); it
        sheds nothing, counts every injected fault, restores at each
        decode and verify fault and at each prefill fault but a first
        (no slot is live before the first admission), captures as many
        CUDA graphs as the fault-free run (the steps after a restore feed
        the graphs already captured), leaves no checkpoint pinned, and,
        paged, leaves as many blocks free or held by the radix tree as
        the fault-free run. Then two verify faults in a row turn
        speculation off (degraded 1, tokens unchanged), and a pool of 15
        blocks with prefix reuse off (two requests' worth) makes
        admissions defer, then complete equal. Prints fault_stats(), the
        restores' ms (median and p99 from the server's histogram),
        kernels 3-4's launches (faulted, fault-free and their ratio) and
        tokens/s faulted against fault-free."""
        f32 = torch.float32
        params, cfg = model(f32)
        paged_kw = dict(paged=True, block_size=16)
        spec_kw = dict(paged_kw, paged_kernel="fused", spec=True,
                       spec_k=SPEC_K)
        modes = [("dense", {}),
                 ("paged fused", dict(paged_kw, paged_kernel="fused")),
                 ("paged fused_online",
                  dict(paged_kw, paged_kernel="fused_online")),
                 (f"spec k={SPEC_K}, paged fused", spec_kw)]
        print(f"   injector: seed {FAULT_SEED}, rate {FAULT_RATE}, at most "
              f"{FAULT_MAX} faults, sites {FAULT_SITES}", flush=True)
        for mix in ("a", "b"):
            want = plain_runs[mix, "f32 dense"]
            prompts = {i: p for i, (p, _) in enumerate(mixes[mix][0])}
            for label, kw in modes:
                before = paged_launches()
                base, bsrv = serve(mix, f"f32 {label}, fault-free", f32, **kw)
                ran0 = {k: n - before[k]
                        for k, n in paged_launches().items()}
                # (b)'s admissions make hundreds of alloc checks, whose
                # faults take the cap before the first decode fault: its
                # paged servers also run with alloc disarmed
                for sites in ((FAULT_SITES, FAULT_SITES[:3])
                              if mix == "b" and kw.get("paged")
                              else (FAULT_SITES,)):
                    faulted_run(mix, label, kw, sites, base, bsrv, ran0,
                                want, prompts, params, cfg)
        # what faults cost a warmed server: (b) with alloc disarmed (so
        # that the faults restore), on one server each, fault-free and
        # faulted runs in the order A B B A (captures and radix warm)
        cost = {}
        for label, kw in (("dense", {}),
                          ("paged fused", dict(paged_kw,
                                               paged_kernel="fused"))):
            srv = serving.ContinuousServer(params, cfg, **mixes["b"][1],
                                           **kw)
            stepped(srv, mixes["b"][0], torch)
            tps = {"fault-free": [], "faulted": []}
            restores = []
            for k in ("fault-free", "faulted", "faulted", "fault-free"):
                before = srv._flt_restored
                if k == "faulted":
                    faultinject.install(faultinject.FaultInjector(
                        seed=FAULT_SEED, rate=FAULT_RATE,
                        max_faults=FAULT_MAX, sites=FAULT_SITES[:3]))
                try:
                    wall, ntok, _ = stepped(srv, mixes["b"][0], torch)
                finally:
                    faultinject.uninstall()
                tps[k].append(ntok / wall)
                if k == "faulted":
                    restores.append(srv._flt_restored - before)
            if srv.failed or not all(restores):
                raise AssertionError(f"(b) warmed {label}: failed "
                                     f"{srv.failed}, restores {restores}")
            cost[label] = {"tokens_per_s": tps, "slot_restores": restores}
            print(f"   (b) f32 {label}, warmed, alloc disarmed: tokens/s "
                  f"fault-free {tps['fault-free']}, faulted "
                  f"{tps['faulted']} (order A B B A; slot restores a "
                  f"faulted run {restores}); on {smi}", flush=True)
        resilience["b", "warmed fault cost"] = cost
        # the degradation ladder
        want = plain_runs["a", "f32 dense"]
        prompts = {i: p for i, (p, _) in enumerate(mixes["a"][0])}
        faultinject.install(faultinject.FaultInjector(
            schedule={"verify": {1, 2}}))
        try:
            out, srv = serve("a", f"f32 spec k={SPEC_K}, paged fused, "
                             "verify faults 1 and 2", f32, **spec_kw)
        finally:
            faultinject.uninstall()
        st = srv.fault_stats()
        same_tokens("(a) spec after two verify faults", out, want, prompts,
                    params, cfg)
        if st["degraded"] != 1 or srv._spec or st["shed"]:
            raise AssertionError(f"two verify faults: {st}, spec "
                                 f"{srv._spec}")
        print(f"   (a) two verify faults in a row: speculation off, tokens "
              f"== the non-spec dense server's; fault_stats {st}",
              flush=True)
        resilience["a", "degraded"] = {"fault_stats": st}
        # admission OOM on a pool of two requests' blocks
        rc = runtime_config()
        old = rc.get("hpx.serving.admit_retries")
        rc.set("hpx.serving.admit_retries", "64")
        try:
            out, srv = serve("a", "f32 paged fused, 15 blocks, no prefix "
                             "reuse", f32, paged=True, block_size=16,
                             paged_kernel="fused", prefix_reuse=False,
                             num_blocks=15)
        finally:
            rc.set("hpx.serving.admit_retries", old)
        st = srv.fault_stats()
        same_tokens("(a) a pool of 15 blocks", out, want, prompts, params,
                    cfg)
        if st["retried"] < 1 or st["shed"] or srv.failed:
            raise AssertionError(f"a pool of 15 blocks: {st}, failed "
                                 f"{srv.failed}")
        print(f"   (a) a pool of 15 blocks (prefix reuse off): admissions "
              f"deferred {st['retried']} times, then every request "
              f"completed == the non-spec dense server's; fault_stats "
              f"{st}", flush=True)
        resilience["a", "admission OOM"] = {"fault_stats": st}

    def traced_serving():
        """svc.tracing on the main path: mix (a) in f32 on paged fused
        under tracing.trace(), its tokens those of the non-spec dense
        server, the Chrome trace exported and validated
        (validate_chrome_trace == []), the event counts by name printed
        (serving.admit, prefill, decode and retire spans and cache.match
        instants must be there). The tracer's cost on mix (b): tokens/s
        of a traced and an untraced server (each warmed by one run) in
        the order untraced, traced, traced, untraced; the host ms of a
        decode step with a rate-0 injector installed and with none, in
        the same order. Then svc.profiling.profile_trace around a few
        steps: its trace must name kernel 3's CUDA kernel."""
        import tempfile
        from collections import Counter
        f32 = torch.float32
        params, cfg = model(f32)
        kw = dict(paged=True, block_size=16, paged_kernel="fused")
        want = plain_runs["a", "f32 dense"]
        prompts = {i: p for i, (p, _) in enumerate(mixes["a"][0])}
        with tempfile.TemporaryDirectory() as d:
            with tracing.trace() as tr:
                out, srv = serve("a", "f32 paged fused, traced", f32, **kw)
            path = os.path.join(d, "serving_trace.json")
            tr.export(path)
            doc = load_chrome_trace(path)
        same_tokens("(a) traced", out, want, prompts, params, cfg)
        problems = validate_chrome_trace(doc)
        if problems:
            raise AssertionError(f"the exported trace: {problems[:5]}")
        counts = Counter(e["name"] for e in doc["traceEvents"]
                         if e["ph"] in ("B", "i", "s", "C"))
        need = ("serving.admit", "serving.prefill", "serving.decode",
                "serving.retire", "cache.match")
        if any(counts[n] < 1 for n in need):
            raise AssertionError(f"the trace lacks some of {need}: "
                                 f"{dict(counts)}")
        print(f"   (a) traced: {len(doc['traceEvents'])} events exported, "
              f"valid; dropped {tr.dropped}; by name (B, i, s, C) "
              f"{dict(counts.most_common())}", flush=True)
        reqs, base = mixes["b"]
        runs = {"untraced": serving.ContinuousServer(params, cfg, **base,
                                                     **kw),
                "traced": serving.ContinuousServer(params, cfg, **base, **kw)}
        for srv in runs.values():
            stepped(srv, reqs, torch)
        tps = {k: [] for k in runs}
        events = []
        for k in ("untraced", "traced", "traced", "untraced"):
            ctx = tracing.trace() if k == "traced" else \
                contextlib.nullcontext()
            with ctx as tr:
                wall, ntok, _ = stepped(runs[k], reqs, torch)
            if tr is not None:
                events.append(len(tr.snapshot()) + tr.dropped)
            tps[k].append(ntok / wall)
        host = {k: [] for k in ("none", "rate 0")}
        srv = runs["untraced"]
        for k in ("none", "rate 0", "rate 0", "none"):
            if k == "rate 0":
                faultinject.install(faultinject.FaultInjector(rate=0.0))
            try:
                _, _, decode = stepped(srv, reqs, torch)
            finally:
                faultinject.uninstall()
            host[k].append(statistics.median(decode) * 1e3)
        resilience["b", "tracer cost"] = {"tokens_per_s": tps,
                                          "events": events,
                                          "decode_step_host_ms": host}
        print(f"   (b) f32 paged fused, tokens/s untraced {tps['untraced']}"
              f", traced {tps['traced']} (order A B B A; {events} events a "
              f"traced run); host ms of a decode step (median) with no "
              f"injector {host['none']}, with a rate-0 injector "
              f"{host['rate 0']} (order A B B A); on {smi}", flush=True)
        with tempfile.TemporaryDirectory() as d:
            srv = runs["untraced"]
            for p, m in reqs[:4]:
                srv.submit(p, max_new=m)
            with profiling.profile_trace(d):
                for _ in range(8):
                    srv.step()
            srv.run()
            with open(os.path.join(d, "trace.json")) as f:
                names = {e.get("name", "") for e in json.load(f).get(
                    "traceEvents", [])}
        hits = sorted(n for n in names if "paged_attention_exact" in n)
        if not hits:
            raise AssertionError("profile_trace's trace names no "
                                 "paged_attention_exact kernel")
        print(f"   profile_trace: {len(names)} event names; kernel 3 as "
              f"{hits[:2]}", flush=True)

    def decoders():
        """The other decoders at the serving width in f32, 4 prompts of 64
        tokens, 32 new: speculative_generate (the 1-layer random draft,
        and the target as its own draft), beam_search(beam_width=1) and
        top_k=1 sampling, each against greedy generate (near-ties
        allowed, as ``same_tokens``); beams of 4 sorted and finite;
        speculative_sample twice under one key, the same tokens; top_k 8
        draws in the vocabulary; packed int4 weights within half a scale
        step of the dense ones (the reference test's bound), their logits
        finite beside the dense ones."""
        f32 = torch.float32
        params, cfg = model(f32)
        dcfg = tf.TransformerConfig(**dict(SERVE_MODEL, n_layers=1),
                                    dtype=f32)
        dparams = tf.init_params(dcfg, seed=1)
        prompt = np.random.default_rng(2).integers(1, cfg.vocab,
                                                   (4, 64)).tolist()
        prompts = dict(enumerate(prompt))
        n = 32

        def rows(t):
            return dict(enumerate(t.tolist()))

        def timed(fn):
            torch.cuda.synchronize()
            t = HighResolutionTimer()
            out = fn()
            torch.cuda.synchronize()
            return out, t.elapsed()
        greedy, g_s = timed(lambda: tf.generate(params, cfg, prompt,
                                                max_new=n))
        want = rows(greedy)
        runs = {
            "speculative_generate, 1-layer draft": lambda: (
                tf.speculative_generate(params, cfg, dparams, dcfg, prompt,
                                        max_new=n, k=SPEC_K,
                                        return_stats=True)),
            "speculative_generate, self-draft": lambda: (
                tf.speculative_generate(params, cfg, params, cfg, prompt,
                                        max_new=n, k=SPEC_K,
                                        return_stats=True)),
            "beam_search(beam_width=1)": lambda: (tf.beam_search(
                params, cfg, prompt, max_new=n, beam_width=1), None),
            "generate(top_k=1)": lambda: (tf.generate(
                params, cfg, prompt, max_new=n, temperature=0.7, top_k=1,
                key=prng.PRNGKey(3)), None)}
        for what, fn in runs.items():
            (out, rounds), secs = timed(fn)
            ties = same_tokens(what, rows(out), want, prompts, params, cfg)
            print(f"   {what}: tokens == greedy generate's ({len(ties)} "
                  f"near-ties); {secs!r} s against greedy's {g_s!r} s"
                  + (f"; {rounds} rounds for {n - 1} tokens after the first"
                     if rounds is not None else ""), flush=True)
        beams, scores = tf.beam_search(params, cfg, prompt, max_new=n,
                                       beam_width=4, return_all=True)
        if not bool(torch.isfinite(scores).all()) or \
                bool((scores[:, :-1] < scores[:, 1:]).any()):
            raise AssertionError(f"beams of 4: scores {scores.tolist()}")
        s1 = tf.speculative_sample(params, cfg, dparams, dcfg, prompt[:1],
                                   max_new=n, k=SPEC_K, key=prng.PRNGKey(5))
        s2 = tf.speculative_sample(params, cfg, dparams, dcfg, prompt[:1],
                                   max_new=n, k=SPEC_K, key=prng.PRNGKey(5))
        tk8 = tf.generate(params, cfg, prompt, max_new=n, temperature=0.8,
                          top_k=8, key=prng.PRNGKey(4))
        if not torch.equal(s1, s2) or int(s1.min()) < 0 or \
                int(s1.max()) >= cfg.vocab or int(tk8.min()) < 0 or \
                int(tk8.max()) >= cfg.vocab:
            raise AssertionError("speculative_sample is not deterministic "
                                 "under one key, or a draw is out of range")
        print(f"   beams of 4: scores sorted, finite (best {scores[:, 0]}); "
              f"speculative_sample deterministic under one key; top_k=8 "
              f"draws in range", flush=True)
        q4 = quant.quantize_params(params, bits=4)
        worst = 0.0
        for lp, lq in zip(params["layers"], q4["layers"]):
            for name, w in lp.named_parameters():
                t4 = lq[name]
                if not hasattr(t4, "axis"):
                    continue
                err = (quant.dequant(t4, f32) - w).abs() - t4.s / 2
                worst = max(worst, float(err.max()))
        if worst > 1e-6:
            raise AssertionError(f"int4 round trip above s/2 by {worst}")
        toks = torch.tensor(prompt, device="cuda")

        def logits(p):
            caches = [tuple(torch.zeros((4, 64, cfg.kv_heads, cfg.head_dim),
                                        device="cuda") for _ in range(2))
                      for _ in range(cfg.n_layers)]
            with torch.no_grad():
                return tf._decode_window(p, caches, toks, 0, cfg)[1]
        dense_l, q4_l = logits(params), logits(q4)
        rel = float((q4_l - dense_l).norm() / dense_l.norm())
        out4 = tf.generate(q4, cfg, prompt, max_new=8)
        if not bool(torch.isfinite(q4_l).all()) or int(out4.max()) >= \
                cfg.vocab:
            raise AssertionError("int4 logits not finite")
        print(f"   int4: every weight within s/2 of the dense one (worst "
              f"excess {worst!r}); logits ||int4 - dense|| / ||dense|| = "
              f"{rel!r}; weights {quant.quantized_bytes(params['layers'])}"
              f" -> {quant.quantized_bytes(q4['layers'])} bytes; on {smi}",
              flush=True)

    def serving_demo():
        """examples_cuda/serving_demo.py on the card: it prints OK."""
        proc = subprocess.run(
            [sys.executable, os.path.join(os.path.dirname(os.path.abspath(
                __file__)), "examples_cuda", "serving_demo.py")],
            capture_output=True, text=True, timeout=600)
        print("\n".join(f"   {x}" for x in proc.stdout.splitlines()),
              flush=True)
        if proc.returncode != 0 or \
                proc.stdout.strip().splitlines()[-1:] != ["OK"]:
            raise AssertionError(f"serving_demo.py: rc {proc.returncode}, "
                                 f"{proc.stderr[-2000:]}")

    train = {}

    def training():
        """make_train_step at full width: 10 bf16 SGD steps on the fixed
        batch and 3 Adam steps."""
        cfg = tf.TransformerConfig(**TRAIN_MODEL, dtype=torch.bfloat16)
        params = tf.init_params(cfg, seed=0)
        gen = torch.Generator(device="cuda").manual_seed(1)
        toks, tgts = tf.sample_batch(cfg, 8, 1024, generator=gen)
        step = tf.make_train_step(cfg)
        names = (*FLASH_KERNELS, *FLASH_F32_BWD)
        flash = [getattr(ac, k) for k in names]
        # a layer a step: the forward and the bf16 backward (one kernel);
        # the f32 backward kernel never
        want = [cfg.n_layers] * len(FLASH_KERNELS) + [0] * len(FLASH_F32_BWD)
        losses, secs = [], []
        torch.cuda.reset_peak_memory_stats()
        for i in range(10):
            before = [f.launches for f in flash]
            torch.cuda.synchronize()
            t = HighResolutionTimer()
            params, loss = step(params, toks, tgts)
            torch.cuda.synchronize()
            secs.append(t.elapsed())
            losses.append(float(loss))
            per = [f.launches - b for f, b in zip(flash, before)]
            if per != want:
                raise AssertionError(f"step {i}: launches {per} of "
                                     f"{list(names)}, want {want}")
        if not all(math.isfinite(x) for x in losses) or \
                not losses[-1] < losses[0]:
            raise AssertionError(f"bf16 losses did not fall: {losses}")
        sgd_graph = graph_nodes("bf16 SGD step", [step.program],
                                sgd_nodes(cfg))
        step_s = statistics.median(secs[2:])
        train.update(cfg=cfg, params=params, toks=toks, tgts=tgts, step=step,
                     step_ms=step_s * 1e3, tokens_per_s=toks.numel() / step_s)
        print(f"   bf16 SGD, 10 steps on the fixed batch: losses {losses}",
              flush=True)
        print(f"   each step launched the flash forward and the bf16 "
              f"backward (kernels 6-7 in one) {cfg.n_layers} times (once a "
              f"layer), the f32 backward kernel never (steps 2-10 as "
              f"replays of one graph, its counted kernels' nodes "
              f"{sgd_graph}); step times {secs} s; "
              f"median after 2 "
              f"warm-ups {step_s * 1e3!r} ms = {toks.numel() / step_s!r} "
              f"tokens/s; peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30!r} GiB; on {smi}",
              flush=True)
        # Adam through a torch.optim factory
        p_adam = tf.init_params(cfg, seed=0)
        factory = functools.partial(torch.optim.Adam, lr=1e-3)
        state = tf.make_opt_state(p_adam, cfg, factory)
        astep = tf.make_train_step(cfg, optimizer=factory)
        alosses = []
        for _ in range(3):
            p_adam, state, loss = astep(p_adam, state, toks, tgts)
            alosses.append(float(loss))
        if not all(math.isfinite(x) for x in alosses) or \
                not alosses[-1] < alosses[0]:
            raise AssertionError(f"Adam losses did not fall: {alosses}")
        print(f"   bf16 Adam (lr 1e-3), 3 steps: losses {alosses}", flush=True)
        del p_adam, state

    for name_, fn in (("main path: fused", fused),
                      ("main path: unfused", unfused),
                      ("main path: dataflow", dataflow),
                      ("main path: config #1 (SAXPY + dot)", saxpy_path),
                      ("main path: bench script", bench_path),
                      ("main path: senders and one-device algorithms",
                       algorithms_path),
                      ("main path: serving f32", serving_f32),
                      ("main path: serving f32, blocks of 256 rows",
                       serving_long_blocks),
                      ("main path: serving bf16", serving_bf16),
                      ("main path: serving speculative", serving_spec),
                      ("main path: resilient serving", serving_resilient),
                      ("traced serving", traced_serving),
                      ("main path: decoders", decoders),
                      ("examples_cuda/serving_demo.py", serving_demo),
                      ("main path: training", training)):
        sm.phase(name_, lambda fn=fn: run_path(fn))

    # -- mixture-of-experts through the server and the training step --------
    moe = {}
    moe_knob = "hpx.serving.moe.capacity_factor"

    def moe_paged_check(srv, what):
        """Kernels 3-4 against their plain versions on a MoE server's
        pools at its own decode shape (slots, W 1, its heads and
        blocks), through random tables over its blocks; uncounted."""
        cpu = torch.Generator().manual_seed(9)
        slots, maxb = srv.slots, srv._maxb
        with _uncounted(kernels):
            for layer, (kp, vp) in enumerate(srv._pools):
                nb, bs = kp.shape[0], kp.shape[1]
                table = torch.randint(0, nb, (slots, maxb),
                                      generator=cpu).int()
                pos = torch.randint(0, maxb * bs, (slots,),
                                    generator=cpu).int()
                pos[0], pos[-1] = 0, maxb * bs - 1
                q = torch.randn(slots, 1, srv.cfg.n_heads, srv.cfg.head_dim,
                                generator=cpu).to(kp.dtype)
                args = [q.cuda(), kp, vp, table.cuda(), pos.cuda()]
                for k, (fn, plain) in paged.items():
                    sm.expect_close(
                        k, fn(*args), plain(*args),
                        f"{k} on the MoE {what} server's layer-{layer} "
                        f"pools (B {slots}, W 1, {srv.cfg.n_heads} heads of "
                        f"{srv.cfg.head_dim}, blocks of {bs}, {maxb} a "
                        "slot)")

    def moe_ffn_ms(cfg, params, t, cf):
        """(MoE FFN ms, dense MLP ms) a layer on t tokens in cfg.dtype:
        moe_ffn at capacity factor ``cf`` on layer 0's experts, and the
        dense MLP of one expert's width (d_ff), each in a CUDA graph."""
        from hpx_tpu_torch.models import moe as pm
        g = torch.Generator(device="cuda").manual_seed(3)
        h = torch.randn(t, cfg.d_model, generator=g,
                        device="cuda").to(cfg.dtype)
        lp = params["layers"][0]["moe"]
        mcfg = dataclasses.replace(tf._moe_cfg(cfg), capacity_factor=cf)
        w1, b1, w2 = lp["w1"][0], lp["b1"][0], lp["w2"][0]
        with torch.no_grad():
            moe_ms = _graph_ms([lambda: pm.moe_ffn(h, lp, mcfg,
                                                   return_stats=True)], 5)
            dense_ms = _graph_ms([lambda: tf._gelu(h @ w1 + b1) @ w2], 5)
        return moe_ms, dense_ms

    def moe_serving():
        """The repo's MoE model (MOE_MODEL), random weights from seed 4,
        on ContinuousServer(slots=4, smax=128): dense and paged through
        gather, fused and fused_online in f32, fused and gather in bf16,
        8 seeded requests of 24 + 48 tokens; f32 tokens all equal and
        equal generate()'s (batched and alone), drop-free (no claim
        dropped); kernels 3-4 against their plain versions at this
        shape; the MoE FFN's share of a captured step; the knob at 100
        (cf 1.0) drops."""
        from hpx_tpu_torch.core.config import runtime_config
        reqs = _moe_requests(MOE_MODEL["vocab"])
        ntok = sum(m for _, m in reqs)
        print(f"   card: {smi}", flush=True)
        paged_kw = {k: dict(paged=True, paged_kernel=k)
                    for k in ("gather", "fused", "fused_online")}
        for dt in (torch.float32, torch.bfloat16):
            tag = str(dt).split(".")[-1]
            cfg = tf.TransformerConfig(**MOE_MODEL, dtype=dt)
            params = tf.init_params(cfg, seed=MOE_SEED)
            modes = ({"dense": {}, **paged_kw} if dt == torch.float32
                     else {k: paged_kw[k] for k in ("fused", "gather")})
            runs = {}
            for label, kw in modes.items():
                before = {k.__name__: k.launches for k in kernels}
                toks, srv, s1, s2, st = _moe_serve(serving, params, cfg,
                                                   reqs, **MOE_SERVER, **kw)
                ran = {k.__name__: k.launches - before[k.__name__]
                       for k in kernels if k.launches != before[k.__name__]}
                runs[label] = (toks, srv)
                moe[f"{tag} {label}"] = dict(
                    first_tokens_per_s=ntok / s1, tokens_per_s=ntok / s2,
                    routed=st[0], dropped=st[1], occupancy=st[2])
                print(f"   {tag} {label}{', kernel ' + srv.paged_kernel if srv.paged else ''}"
                      f": {ntok} tokens in {s1!r} s = {ntok / s1!r} "
                      f"tokens/s (first run, graphs captured), again in "
                      f"{s2!r} s = {ntok / s2!r} tokens/s (replays); MoE "
                      f"claims routed {st[0]!r}, dropped {st[1]!r}, "
                      f"occupancy {st[2]}; launches {ran}", flush=True)
                if st[1] != 0.0 or st[0] <= 0:
                    raise AssertionError(f"{tag} {label}: the drop-free "
                                         f"server dropped {st[1]} claims")
            if dt == torch.float32:
                want = runs["dense"][0]
                bad = [k for k, (t_, _) in runs.items() if t_ != want]
                if bad:
                    raise AssertionError(f"f32 MoE tokens of {bad} differ "
                                         "from the dense server's")
                batch = tf.generate(params, cfg, [p for p, _ in reqs],
                                    max_new=MOE_NEW)
                solo = [tf.generate(params, cfg, [reqs[i][0]],
                                    max_new=MOE_NEW)[0].tolist()
                        for i in (0, MOE_REQS - 1)]
                if batch.tolist() != want or solo != [want[0], want[-1]]:
                    raise AssertionError("f32 MoE server tokens differ from "
                                         "generate()'s")
                print("   f32 tokens: fused == fused_online == gather == "
                      "dense == generate() (the 8 prompts in one batch, and "
                      "requests 0 and 7 alone)", flush=True)
                srv = runs["fused"][1]
                moe_paged_check(srv, "f32")
                # a captured decode step against its MoE FFNs alone
                maxb = srv._maxb
                args = (srv.params, srv._pools, srv._scales,
                        torch.randint(0, cfg.vocab, (srv.slots,),
                                      device="cuda"),
                        torch.full((srv.slots,), MOE_PROMPT + MOE_NEW // 2,
                                   dtype=torch.int32, device="cuda"),
                        (torch.arange(srv.slots * maxb, dtype=torch.int32,
                                      device="cuda").reshape(srv.slots, maxb)
                         % srv._alloc.num_blocks),
                        srv._temp_dev, srv._keys_dev, False)
                prog = srv._paged_step_prog()
                with _uncounted(kernels):
                    step_ms = _cuda_ms(lambda: prog(*args), 7)
                    moe_ms, dense_ms = moe_ffn_ms(cfg, params, srv.slots,
                                                  float(cfg.n_experts))
                share = cfg.n_layers * moe_ms / step_ms
                moe.update(step_ms=step_ms, decode_moe_ms=moe_ms,
                           decode_dense_ms=dense_ms, decode_share=share)
                print(f"   f32 fused decode step (a replay of its CUDA "
                      f"graph, events): {step_ms!r} ms; the MoE FFN alone "
                      f"(B {srv.slots} rows, drop-free, in a graph) "
                      f"{moe_ms!r} ms a layer beside the dense MLP of one "
                      f"expert's width {dense_ms!r} ms: {cfg.n_layers} MoE "
                      f"layers are {share!r} of the step; {smi}", flush=True)
                rc = runtime_config()
                old = rc.get(moe_knob)
                rc.set(moe_knob, "100")
                try:
                    toks100, srv100, _, s100, st100 = _moe_serve(
                        serving, params, cfg, reqs, **MOE_SERVER,
                        **paged_kw["fused"])
                finally:
                    rc.set(moe_knob, old)
                agree = sum(a == b for r, w in zip(toks100, want)
                            for a, b in zip(r, w)) / ntok
                moe["knob100"] = dict(routed=st100[0], dropped=st100[1],
                                      agreement=agree,
                                      tokens_per_s=ntok / s100)
                print(f"   f32 fused with {moe_knob} = 100 (cf 1.0, C = "
                      f"ceil(4 * 2 / 4) = 2 a step): claims routed "
                      f"{st100[0]!r}, dropped {st100[1]!r}; tokens equal to "
                      f"the drop-free run's: {agree!r}; {ntok / s100!r} "
                      f"tokens/s (replays)", flush=True)
                if st100[1] <= 0 or srv100._moe_capacity_pct != 100:
                    raise AssertionError(f"the knob at 100 dropped nothing: "
                                         f"{st100}")
            else:
                fused, gather = runs["fused"][0], runs["gather"][0]
                agree = sum(a == b for r, w in zip(fused, gather)
                            for a, b in zip(r, w)) / ntok
                moe["bf16 agreement"] = agree
                print(f"   bf16 fused tokens equal to the bf16 gather "
                      f"server's: {agree!r} (rounding; f32 is held equal)",
                      flush=True)
                moe_paged_check(runs["fused"][1], "bf16")
            del runs, params
            torch.cuda.empty_cache()

    def moe_training():
        """make_train_step at the training model's full width with 4
        experts (TRAIN_MOE), bf16, batch 8 x 1024, captured: the bytes
        reckoned first, 3 SGD steps whose loss falls, each launching the
        flash forward and backward once a layer; step ms, peak memory;
        the MoE layer's forward beside the dense MLP's at T = 8192."""
        cfg = tf.TransformerConfig(**TRAIN_MODEL, **TRAIN_MOE,
                                   dtype=torch.bfloat16)
        b, s = 8, 1024
        t_, e = b * s, cfg.n_experts
        cap = max(1, math.ceil(t_ * cfg.moe_top_k * cfg.moe_capacity / e))
        tec = t_ * e * cap
        # kept for the backward a layer: each round's f32 claim one-hots
        # (the combine's product) and the bf16 dispatch and combine (the
        # two einsums)
        keep = cfg.n_layers * tec * (4 * cfg.moe_top_k + 2 + 2)
        torch.cuda.empty_cache()
        free, total = torch.cuda.mem_get_info()
        print(f"   reckoned: T {t_}, C = ceil(T k cf / E) = {cap}: each f32 "
              f"[T, E, C] tensor is {tec * 4 / 2**30!r} GiB; kept for the "
              f"backward about {keep / 2**30!r} GiB over {cfg.n_layers} "
              f"layers, plus a few such tensors in flight; free on the "
              f"card {free / 2**30!r} of {total / 2**30!r} GiB; {smi}",
              flush=True)
        if keep + 4 * tec * 4 > free:
            raise AssertionError(
                f"the MoE step at batch {b} x {s} needs about "
                f"{(keep + 4 * tec * 4) / 2**30:.1f} GiB and the card has "
                f"{free / 2**30:.1f} GiB free: it does not fit (not run at "
                "a smaller batch)")
        params = tf.init_params(cfg, seed=0)
        gen = torch.Generator(device="cuda").manual_seed(1)
        toks, tgts = tf.sample_batch(cfg, b, s, generator=gen)
        step = tf.make_train_step(cfg)
        flash = (ac.flash_attention_fwd, ac.flash_attention_bwd)
        torch.cuda.reset_peak_memory_stats()
        losses, secs, per = [], [], []
        for _ in range(3):
            before = [f.launches for f in flash]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, loss = step(params, toks, tgts)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            losses.append(float(loss))
            per.append([f.launches - x for f, x in zip(flash, before)])
        peak = torch.cuda.max_memory_allocated() / 2**30
        if any(p != [cfg.n_layers] * 2 for p in per):
            raise AssertionError(f"flash launches a step {per} of "
                                 f"(fwd, bwd), want {cfg.n_layers} each")
        if not all(math.isfinite(x) for x in losses) or \
                not losses[-1] < losses[0]:
            raise AssertionError(f"MoE bf16 losses did not fall: {losses}")
        moe.update(train_step_ms=statistics.median(secs[1:]) * 1e3,
                   train_first_ms=secs[0] * 1e3, train_peak_gib=peak,
                   train_losses=losses)
        print(f"   bf16 MoE SGD, 3 steps on the fixed batch (8 x 1024): "
              f"losses {losses}; each step launched flash_attention_fwd and "
              f"flash_attention_bwd {per[0]} times (once a layer); step "
              f"times {[x * 1e3 for x in secs]} ms (the first eager and "
              f"captured, then replays); peak memory {peak!r} GiB; {smi}",
              flush=True)
        del step, toks, tgts
        torch.cuda.empty_cache()
        with _uncounted(kernels):
            moe_ms, dense_ms = moe_ffn_ms(cfg, params, t_,
                                          float(cfg.moe_capacity))
        moe.update(train_moe_ms=moe_ms, train_dense_ms=dense_ms)
        print(f"   the MoE FFN's forward at T {t_} (cf {cfg.moe_capacity}, "
              f"bf16, in a graph) {moe_ms!r} ms a layer beside the dense "
              f"MLP of one expert's width {dense_ms!r} ms; {smi}", flush=True)
        del params
        torch.cuda.empty_cache()

    sm.phase("main path: MoE serving", lambda: run_path(moe_serving))
    sm.phase("main path: MoE training", lambda: run_path(moe_training))

    def training_gate():
        """The training width in f32, batch 2 x 1024, from the same
        weights on the same tokens: the loss and every weight's gradient
        through the kernels against the same through their plain
        versions (the gradient by its norm, GRAD_NORM_REL), with a
        planted fault (dq zeroed) that must read above the limit; then
        one SGD step each way, the weights after it within rtol = atol
        = 1e-5."""
        cfg = tf.TransformerConfig(**TRAIN_MODEL)
        params = tf.init_params(cfg, seed=0)
        toks, tgts = train["toks"][:2], train["tgts"][:2]
        names = [k for k, _ in params.named_parameters()]

        def grads():
            _, g, loss = tf._loss_and_grads(params, toks, tgts, cfg,
                                            tf.make_mesh_3d(1))
            return g, float(loss)
        before = ac.flash_attention_bwd_f32.launches
        fwd_before = ac.flash_attention_fwd.launches
        g_kernel, l_kernel = grads()
        f32_bwd = ac.flash_attention_bwd_f32.launches - before
        f32_fwd = ac.flash_attention_fwd.launches - fwd_before
        print(f"   f32 gradients: flash_fwd_tf32x3 launched {f32_fwd} times, "
              f"flash_bwd_tf32x3 {f32_bwd} ({cfg.n_layers} layers)",
              flush=True)
        if f32_bwd != cfg.n_layers or f32_fwd != cfg.n_layers:
            raise AssertionError(f"the f32 forward and backward kernels "
                                 f"launched {f32_fwd} and {f32_bwd} times, "
                                 f"not once a layer")
        with plain_flash():
            g_plain, l_plain = grads()
            # the planted fault: a backward whose dq is zeros
            ac.flash_attention_bwd = (
                lambda q, *a: (torch.zeros(q.shape, device=q.device),
                               *ac.plain_flash_bwd(q, *a)[1:]))
            g_fault, _ = grads()
        rel = abs(l_kernel - l_plain) / abs(l_plain)
        reads = {n: _norm_rel(a, b) for n, a, b in zip(names, g_kernel,
                                                         g_plain)}
        faults = {n: _norm_rel(a, b) for n, a, b in zip(names, g_fault,
                                                          g_plain)}
        worst = max(reads, key=reads.get)
        caught = max(faults, key=faults.get)
        print(f"   f32, batch 2 x 1024: loss {l_kernel!r} (kernels) vs "
              f"{l_plain!r} (plain versions), relative {rel!r} (<= 1e-5); "
              f"gradients' largest norm-relative reading {reads[worst]!r} "
              f"({worst}; limit {GRAD_NORM_REL}); dq zeroed reads "
              f"{faults[caught]!r} ({caught}), smallest over leaves "
              f"{min(faults.values())!r}", flush=True)
        if rel > 1e-5:
            raise AssertionError(f"f32 loss {l_kernel} (kernels) vs "
                                 f"{l_plain} (plain), relative {rel}")
        if reads[worst] > GRAD_NORM_REL:
            raise AssertionError(f"f32 gradient of {worst} differs between "
                                 f"kernels and plain versions: "
                                 f"{reads[worst]}")
        if faults[caught] <= GRAD_NORM_REL:
            raise AssertionError("the gradient check would miss a zeroed "
                                 f"dq: {faults[caught]}")
        del g_kernel, g_plain, g_fault
        p_plain = copy.deepcopy(params)
        step = tf.make_train_step(cfg)
        step(params, toks, tgts)
        with plain_flash():
            step.eager(p_plain, toks, tgts)
        # the f32 route's forward launches: the gradients' and the step's
        f32_fwd = ac.flash_attention_fwd.launches - fwd_before
        if f32_fwd != 2 * cfg.n_layers:
            raise AssertionError(f"the f32 forward kernel launched {f32_fwd} "
                                 f"times, not once a layer a pass")
        sm.f32_launches["flash_attention_fwd"] += f32_fwd
        err = 0.0
        for (name, a), (_, b) in zip(params.named_parameters(),
                                     p_plain.named_parameters()):
            err = max(err, (a - b).abs().max().item())
            if not torch.allclose(a, b, rtol=1e-5, atol=1e-5):
                raise AssertionError(f"f32 step: weight {name} differs "
                                     "between kernels and plain versions")
        print(f"   f32 SGD step: weights max abs err {err!r} (rtol = atol "
              "= 1e-5)", flush=True)
    if train:   # the f32 training path: the f32 backward kernel's only
        sm.phase("main path: training f32, kernels against plain",
                 lambda: run_path(training_gate))

    def rel_reading(got, want) -> float:
        """max |got - want| / max |want| (0 for equal tensors)."""
        g, w = got.double(), want.double()
        if torch.equal(got, want):
            return 0.0
        return (g - w).abs().max().item() / max(w.abs().max().item(),
                                                1e-30)

    def clones(x):
        return [t.clone() for t in programs.tensors(x)]

    def restore(x, saved):
        for t, v in zip(programs.tensors(x), saved):
            t.copy_(v)

    def run_both(prog, args, state, stale=False):
        """(replay's results, eager's results): the program replayed on
        ``args``, then, from the same ``state`` (saved before and
        restored after the replay), ``.eager`` on them; each the outputs'
        tensors and then the state's. ``stale`` leaves the replay's
        input copies out (a planted fault: it runs on the inputs of the
        call before)."""
        if prog.signature(args) not in prog.graphs:
            prog(*args)                  # warm-up run and capture
        saved = clones(state)
        copy_in = programs._Graph._copy_in
        if stale:
            programs._Graph._copy_in = lambda self, args: None
        try:
            got = prog(*args)            # a replay
        finally:
            programs._Graph._copy_in = copy_in
        torch.cuda.synchronize()
        got = clones(got) + clones(state)
        restore(state, saved)
        want = prog.eager(*args)
        torch.cuda.synchronize()
        return got, clones(want) + clones(state)

    def readings(got, want):
        """(largest reading, [(i, reading) over CAPTURE_REL], [i of
        integer results that differ])."""
        worst, over, ints = 0.0, [], []
        for i, (a, b) in enumerate(zip(got, want)):
            if not a.is_floating_point():
                if not torch.equal(a, b):
                    ints.append(i)
                continue
            r = rel_reading(a, b)
            worst = max(worst, r)
            if r > CAPTURE_REL:
                over.append((i, r))
        return worst, over, ints

    def replay_vs_eager(what, prog, args, state, hold=True, stale=None):
        """One captured program replayed against its ``.eager`` program
        on the same inputs from the same state: tokens equal, every float
        result (outputs and the state it wrote) within CAPTURE_REL of the
        eager one's by max |diff| / max |eager|. With ``hold`` False the
        readings are printed, not held. ``stale``, other inputs of the
        same signature: the replay run on them with its input copies
        left out must differ (the check is not blind)."""
        before = {k.__name__: k.launches for k in kernels}
        worst, over, ints = readings(*run_both(prog, args, state))
        ran = {k.__name__: k.launches - before[k.__name__] for k in kernels
               if k.launches != before[k.__name__]}
        print(f"   {what}: replay vs eager, largest reading {worst!r} "
              f"(limit {CAPTURE_REL}{'' if hold else ', printed only'}); "
              f"launches {ran}"
              + (f"; over the limit: {over}" if over else "")
              + (f"; integer results differ: {ints}" if ints else ""),
              flush=True)
        if hold and (over or ints):
            raise AssertionError(f"{what}: replay differs from eager: "
                                 f"{over}, integers {ints}")
        if stale is not None:
            bad, bad_over, bad_ints = readings(*run_both(prog, stale, state,
                                                         stale=True))
            print(f"   {what}, planted fault (input copies left out): "
                  f"largest reading {bad!r}, integer results differ "
                  f"{bad_ints}", flush=True)
            if not bad_over and not bad_ints:
                raise AssertionError(f"{what}: a replay on stale inputs "
                                     "passes the check: it is blind")

    def program_captures():
        """Each captured program, replayed against ``.eager`` on the same
        inputs: the dense, fused and fused_online f32 servers' steps
        (greedy and sampled), chunk per ladder width and probe, after
        mix (a); the f32 SGD step (batch 2 x 1024, kernels 5-7 in f32 in
        the graph); bf16 (the SGD step, the bf16 server's step), printed
        only. A server's second run of the same requests captures
        nothing."""
        f32 = torch.float32
        params, cfg = model(f32)
        gen = torch.Generator(device="cuda").manual_seed(5)
        dev = torch.device("cuda")
        for label, kw in (("dense", {}),
                          ("paged fused", dict(paged=True, block_size=16,
                                               paged_kernel="fused")),
                          ("paged fused_online",
                           dict(paged=True, block_size=16,
                                paged_kernel="fused_online"))):
            _, srv = serve("a", f"f32 {label} (for the replays)", f32, **kw)
            seen = sum(len(g.graphs) for g in srv._graphs.values())
            for p, m in mix_a:
                srv.submit(p, max_new=m)
            with count_captures() as caps:
                again = srv.run()
            new = sum(len(g.graphs) for g in srv._graphs.values()) - seen
            # dense: the same chunk widths again; paged: the radix tree
            # may shorten a prompt's chunks onto another width
            if caps.captures != new or (not srv.paged and new):
                raise AssertionError(f"{label}: the second run of the same "
                                     f"requests captured {caps.captures} "
                                     f"graphs at {new} new signatures")
            print(f"   f32 {label}: a second run of (a) captured "
                  f"{caps.captures} graphs, at {new} signatures not seen "
                  f"before ({len(again)} requests)", flush=True)
            slots, smax = srv.slots, srv.smax
            tok = torch.randint(0, cfg.vocab, (slots,), generator=gen,
                                device=dev)
            pos = torch.randint(0, smax, (slots,), generator=gen,
                                device=dev).int()
            keys = torch.randint(0, 2**31, (slots, 2), generator=gen,
                                 device=dev)
            for sample in (False, True):
                temp = torch.full((slots,), 0.8 if sample else 0.0,
                                  device=dev)
                if srv.paged:
                    maxb = srv._maxb
                    tables = (torch.arange(slots * maxb, device=dev,
                                           dtype=torch.int32)
                              .reshape(slots, maxb) + 1)
                    replay_vs_eager(
                        f"f32 {label} step, sample={sample}",
                        srv._paged_step_prog(),
                        (srv.params, srv._pools, srv._scales, tok, pos,
                         tables, temp, keys, sample),
                        (srv._pools, srv._scales))
                else:
                    replay_vs_eager(
                        f"f32 {label} step, sample={sample}",
                        srv._step_prog(),
                        (srv.params, srv._caches, tok, pos, temp, keys,
                         sample), srv._caches,
                        stale=(srv.params, srv._caches, tok.flip(0),
                               (pos + 1) % smax, temp, keys, sample))
            # the chunk and probe graphs bind the server's one scratch
            scratch = srv._scratch
            for width in srv.prefill_buckets:
                for t in programs.tensors(scratch):
                    t.copy_(torch.randn(t.shape, generator=gen, device=dev))
                toks = torch.randint(0, cfg.vocab, (1, width), generator=gen,
                                     device=dev)
                pos0 = torch.tensor(smax - width - 3, device=dev)
                replay_vs_eager(f"f32 {label} chunk, width {width}",
                                srv._chunk_prog(width),
                                (srv.params, scratch, toks, pos0), scratch)
            replay_vs_eager(f"f32 {label} probe", srv._probe_prog(),
                            (srv.params, scratch, toks[:, :1],
                             torch.tensor(smax - 1, device=dev)), scratch)
            n = sum(len(g.graphs) for g in srv._graphs.values())
            if n > len(srv.prefill_buckets) + 3:
                raise AssertionError(f"{label}: {n} graphs")
            graph_nodes(f"f32 {label}", srv._graphs.values(),
                        server_nodes(srv))
            del srv
        # a capture that cannot be made raises: a program that reads a
        # value back to the host mid-way (a synchronization, refused
        # while a stream is captured) must not give way to its eager run
        x = torch.ones(4, device=dev)
        bad = programs.GraphProgram(lambda t: t * float(t.sum()), dev)
        before = torch.cuda.current_stream(dev)
        try:
            bad(x)
        except RuntimeError as e:
            print(f"   a capture that synchronizes raised "
                  f"{type(e).__name__}: {str(e).splitlines()[0][:120]}",
                  flush=True)
        else:
            raise AssertionError("a capture that synchronizes did not "
                                 "raise")
        if bad.graphs or float((x * 2).sum()) != 8.0:
            raise AssertionError("after the failed capture: graphs "
                                 f"{len(bad.graphs)}, or the card fails")
        if torch.cuda.current_stream(dev) != before:
            raise AssertionError("the failed capture left its capture "
                                 "stream current")
        # the SGD step: f32 (held) and bf16 (printed)
        for dt, hold in ((f32, True), (torch.bfloat16, False)):
            tcfg = tf.TransformerConfig(**TRAIN_MODEL, dtype=dt)
            tparams = tf.init_params(tcfg, seed=0)
            toks, tgts = train["toks"][:2], train["tgts"][:2]
            step = tf.make_train_step(tcfg)
            weights = list(tparams.parameters())
            replay_vs_eager(f"{str(dt)[6:]} SGD step, batch 2 x 1024",
                            step.program, (tparams, toks, tgts), weights,
                            hold=hold,
                            stale=((tparams, toks.flip(1), tgts.flip(1))
                                   if hold else None))
            graph_nodes(f"{str(dt)[6:]} SGD step", [step.program],
                        sgd_nodes(tcfg))
            del step, tparams, weights
        torch.cuda.empty_cache()
    if train:
        sm.phase("program captures", program_captures)

    def gloo_cuda():
        """Every verb that collectives.device.GLOO_CUDA hands to gloo on
        CUDA tensors as they are, tried by 2 ranks: each must run and
        agree. The others are staged through pinned host memory."""
        from hpx_tpu_torch.collectives import device as cd
        from hpx_tpu_torch.parallel.mesh import launch
        res = launch(_gloo_cuda_rank, 2, sorted(cd.GLOO_CUDA), timeout=120)
        for verb in sorted(cd.GLOO_CUDA):
            errs = [r[verb] for r in res if r.get(verb, "not run")]
            print(f"   {verb}: gloo on CUDA tensors "
                  f"{'fails: ' + errs[0] if errs else 'runs and agrees'}",
                  flush=True)
            if errs:
                raise AssertionError(f"{verb} is in GLOO_CUDA but gloo "
                                     f"fails it on CUDA tensors: {errs}")
        print("   staged through pinned host memory: every other verb "
              "(ppermute: gloo's send/recv of a CUDA tensor aborts its "
              "process)", flush=True)
    sm.phase("gloo and CUDA tensors", gloo_cuda)

    ring = {}

    def ring_path():
        """The sharded step (make_mesh_3d(4), 4 ranks through the port's
        launcher) at full width: launches, falling bf16 losses, the
        striped first loss; then its f32 gradients against the
        single-device step's on this card, with a planted fault."""
        from hpx_tpu_torch.parallel.mesh import launch
        f32_batch = 2
        torch.cuda.empty_cache()
        print(f"   card: {smi}", flush=True)
        t = HighResolutionTimer()
        res = launch(_ring_rank, 4, f32_batch, timeout=900)
        wall = t.elapsed()
        r0 = res[0]
        print(f"   4 ranks in {wall!r} s (spawn, CUDA contexts and every "
              f"phase); ranks' devices {[r['device'] for r in res]}, "
              f"coords {[r['coords'] for r in res]}, backend "
              f"{r0['backend']}", flush=True)
        # sp ring steps x layers; no forward, no f32 backward kernel
        want = [2 * 4, 2 * 4, 0, 0]
        for r in res:
            if any(p != want for p in r["per_step"]):
                raise AssertionError(
                    f"rank {r['rank']}: launches a step {r['per_step']} of "
                    "(flash_attention_chunk, bwd, fwd, bwd_f32), "
                    f"want {want}")
            # the f32 gates: flash_bwd_tf32x3 and flash_fwd_tf32x3's chunk
            # fold once a ring step and layer
            f32_bwd = [r[k + "_launches"] for k in ("f32", "f32_striped")]
            f32_fold = [r[k + "_chunk_launches"]
                        for k in ("f32", "f32_striped")]
            if f32_bwd != [2 * 4] * 2 or f32_fold != [2 * 4] * 2:
                raise AssertionError(f"rank {r['rank']}: the f32 backward "
                                     f"and chunk kernels launched {f32_bwd} "
                                     f"and {f32_fold} times in the f32 gates, "
                                     f"want {[2 * 4] * 2} each")
            sm.launches["flash_attention_bwd_f32"] += sum(f32_bwd)
            sm.launches["flash_attention_chunk"] += sum(f32_fold)
            sm.f32_launches["flash_attention_chunk"] += sum(f32_fold)
            if r["losses"] != r0["losses"]:
                raise AssertionError(f"rank {r['rank']}'s losses differ "
                                     "from rank 0's")
            for k in ("flash_attention_chunk", "flash_attention_bwd"):
                sm.launches[k] += r["launches"][k]
        losses = r0["losses"]
        if not all(math.isfinite(x) for x in losses) or \
                not losses[-1] < losses[0]:
            raise AssertionError(f"ring bf16 losses did not fall: {losses}")
        step_s = statistics.median(max(r["secs"][i] for r in res)
                                   for i in range(2, 10))
        ring["step_ms"] = step_s * 1e3
        # a training rate only where every rank had a card of its own
        ring["what"] = (f"one card a rank over {r0['backend']}"
                        if len({r["device"] for r in res}) == len(res)
                        else f"four processes time-slicing one card over "
                             f"{r0['backend']}: not a training rate")
        rel_s = abs(r0["striped_loss"] - losses[0]) / abs(losses[0])
        print(f"   bf16 SGD, 10 steps on the fixed batch (8 x 1024): losses "
              f"{losses}", flush=True)
        print(f"   every rank launched flash_attention_chunk and "
              f"flash_attention_bwd 8 times a step, flash_attention_fwd and "
              f"the f32 backward kernel never: "
              f"{[r['launches'] for r in res]}; in each f32 gate "
              f"flash_fwd_tf32x3's chunk fold and flash_bwd_tf32x3 8 times "
              f"each; peak memory a rank "
              f"{[r['peak_gib'] for r in res]} GiB", flush=True)
        print(f"   step time (host clock, slowest rank, median after 2 "
              f"warm-ups): {step_s * 1e3!r} ms; {ring['what']}; step "
              f"times of rank 0 {r0['secs']}", flush=True)
        print(f"   striped_ring first loss {r0['striped_loss']!r} vs "
              f"contiguous {losses[0]!r}: relative {rel_s!r} (<= 5e-3)",
              flush=True)
        if rel_s > 5e-3:
            raise AssertionError(f"striped first loss differs by {rel_s}")
        for r in res:
            for how, sp in r["split"].items():
                print(f"   rank {r['rank']}, 3 more bf16 steps ({how}) with "
                      f"every collective and staging copy fenced and timed:"
                      f" step {sp['step_ms']!r} ms, in torch.distributed's "
                      f"verbs {sp['comm_ms']!r} ms "
                      f"({sp['comm_ms'] / sp['step_ms']!r}), in the verbs' "
                      f"buffer copies (host staging; a device clone where "
                      f"a verb writes its input) {sp['copies_ms']!r} ms "
                      f"({sp['copies_ms'] / sp['step_ms']!r})", flush=True)
        ring["split"] = [r["split"] for r in res]
        # the same f32 gradients on one device, through kernels 5-7
        cfg = tf.TransformerConfig(**TRAIN_MODEL)
        params = tf.init_params(cfg, seed=0)
        toks, tgts = train["toks"][:f32_batch], train["tgts"][:f32_batch]
        _, g_one, l_one = tf._loss_and_grads(params, toks, tgts, cfg,
                                             tf.make_mesh_3d(1))
        names = [k for k, _ in params.named_parameters()]
        g_one = dict(zip(names, (g.cpu() for g in g_one)))
        l_one = float(l_one)
        for ring_kind, key, fault in (
                ("contiguous", "f32", "rank sp 1 leaves out its past "
                 "chunk's fold"),
                ("striped", "f32_striped", "every chunk at offset 0")):
            rel = abs(r0[key + "_loss"] - l_one) / abs(l_one)
            reads = {n: _norm_rel(r0[key + "_grads"][n], g_one[n])
                     for n in names}
            faults = {n: _norm_rel(r0[key + "_fault_grads"][n], g_one[n])
                      for n in names}
            worst = max(reads, key=reads.get)
            caught = max(faults, key=faults.get)
            ring[key] = dict(rel=rel, grad_read=reads[worst],
                             fault=faults[caught])
            print(f"   f32 gate, {ring_kind} ring, batch {f32_batch} x 1024: "
                  f"loss {r0[key + '_loss']!r} (4 ranks, kernels 8/6/7) vs "
                  f"{l_one!r} (one device, kernels 5/6/7), relative {rel!r} "
                  f"(<= 1e-5); gradients' largest norm-relative reading "
                  f"{reads[worst]!r} ({worst}; limit {GRAD_NORM_REL}); "
                  f"planted fault ({fault}) reads {faults[caught]!r} "
                  f"({caught}), loss {r0[key + '_fault_loss']!r}",
                  flush=True)
            if rel > 1e-5:
                raise AssertionError(f"f32 {ring_kind} ring loss relative "
                                     f"{rel}")
            if reads[worst] > GRAD_NORM_REL:
                raise AssertionError(f"f32 {ring_kind} ring gradient of "
                                     f"{worst}: {reads[worst]}")
            if faults[caught] <= GRAD_NORM_REL:
                raise AssertionError(f"the gradient check would miss the "
                                     f"{ring_kind} fault: {faults[caught]}")
    if train:
        sm.phase("main path: ring training (4 ranks)", ring_path)

    def ep_path():
        """The f32 MoE step with its experts over dp (EP_MESHES, 4 ranks
        through the port's launcher), the loss and every gradient,
        unsharded, within 1e-5 by the norm of the single-device step at
        the same batch (moe_capacity 4.0 >= E / k: both drop-free; the
        aux weight 0, since the Switch aux is a per-rank statistic);
        on (2, 1, 2) a planted fault, experts' gradients summed over dp
        too, reads above that limit."""
        from hpx_tpu_torch.parallel.mesh import launch
        torch.cuda.empty_cache()
        print(f"   card: {smi}", flush=True)
        cfg = tf.TransformerConfig(**TRAIN_MODEL, **TRAIN_MOE,
                                   moe_aux_weight=0.0)
        params = tf.init_params(cfg, seed=0)
        gen = torch.Generator(device="cuda").manual_seed(1)
        toks, tgts = tf.sample_batch(cfg, 8, 1024, generator=gen)
        with _uncounted(kernels):
            _, g_one, l_one = tf._loss_and_grads(
                params, toks[:EP_BATCH], tgts[:EP_BATCH], cfg,
                tf.make_mesh_3d(1))
        names = [k for k, _ in params.named_parameters()]
        g_one = dict(zip(names, (g.cpu() for g in g_one)))
        l_one = float(l_one)
        del params
        for shape in EP_MESHES:
            t = HighResolutionTimer()
            res = launch(_ep_rank, 4, shape, EP_BATCH,
                         shape == EP_MESHES[0], timeout=900)
            r0 = res[0]
            dp, sp, tp = shape
            print(f"   mesh (dp, sp, tp) = {shape}: 4 ranks in "
                  f"{t.elapsed()!r} s, backend {r0['backend']}, devices "
                  f"{[r['device'] for r in res]}; layer 0's expert shards "
                  f"{r0['shards']}", flush=True)
            for r in res:
                n = r["f32_launches"]
                want = ({"flash_attention_fwd": cfg.n_layers,
                         "flash_attention_bwd_f32": cfg.n_layers,
                         "flash_attention_chunk": 0} if sp == 1 else
                        {"flash_attention_fwd": 0,
                         "flash_attention_bwd_f32": sp * cfg.n_layers,
                         "flash_attention_chunk": sp * cfg.n_layers})
                if any(n[k] != v for k, v in want.items()):
                    raise AssertionError(f"rank {r['rank']} on {shape}: "
                                         f"launches {n}, want {want}")
                for k in want:
                    sm.launches[k] += n[k]
                    if k in sm.f32_launches:
                        sm.f32_launches[k] += n[k]
                if r["f32_loss"] != r0["f32_loss"]:
                    raise AssertionError("ranks' losses differ")
            rel = abs(r0["f32_loss"] - l_one) / abs(l_one)
            reads = {n: _norm_rel(r0["f32_grads"][n], g_one[n])
                     for n in names}
            worst = max(reads, key=reads.get)
            moe[f"ep {shape}"] = dict(rel=rel, grad_read=reads[worst],
                                      split=[r["split"] for r in res])
            print(f"   f32 EP step on {shape}, batch {EP_BATCH} x 1024: "
                  f"loss {r0['f32_loss']!r} vs {l_one!r} on one device, "
                  f"relative {rel!r} (<= 1e-5); gradients' largest "
                  f"norm-relative reading {reads[worst]!r} ({worst}; limit "
                  f"{GRAD_NORM_REL}); launches a rank "
                  f"{r0['f32_launches']}", flush=True)
            for r in res:
                sp_ = r["split"]
                print(f"   rank {r['rank']}, 3 f32 SGD steps with every "
                      f"collective and staging copy fenced and timed: step "
                      f"{sp_['step_ms']!r} ms, in torch.distributed's verbs "
                      f"{sp_['comm_ms']!r} ms, in staging copies "
                      f"{sp_['copies_ms']!r} ms (ranks time-slice one "
                      f"card: not a training rate)", flush=True)
            if rel > 1e-5 or reads[worst] > GRAD_NORM_REL:
                raise AssertionError(f"EP step on {shape}: loss relative "
                                     f"{rel}, gradient of {worst} "
                                     f"{reads[worst]}")
            if "f32_fault_grads" in r0:
                faults = {n: _norm_rel(r0["f32_fault_grads"][n], g_one[n])
                          for n in names}
                caught = max(faults, key=faults.get)
                print(f"   planted fault (every gradient summed over dp and "
                      f"sp, the experts' too) reads {faults[caught]!r} "
                      f"({caught})", flush=True)
                if faults[caught] <= GRAD_NORM_REL:
                    raise AssertionError("the EP gradient check would miss "
                                         "experts' gradients summed over dp")

    def ulysses_path():
        """ulysses_attention over sp = 4 at ULYSSES_SHAPE (4 ranks),
        forward and backward in f32 and bf16, against one-rank
        flash_attention on the card at the flash contracts; kernels 5-7
        against their plain versions at the head-group shape; the
        sharded stencil at 2^24 cells bitwise equal to its one-rank run."""
        from hpx_tpu_torch.parallel import halo
        from hpx_tpu_torch.parallel.mesh import launch, make_mesh
        torch.cuda.empty_cache()
        t = HighResolutionTimer()
        res = launch(_ulysses_rank, 4, ULYSSES_SHAPE, STENCIL_STEPS,
                     STENCIL_CELLS, timeout=900)
        print(f"   4 ranks in {t.elapsed()!r} s, backend "
              f"{res[0]['backend']}, devices {[r['device'] for r in res]}; "
              f"{smi}", flush=True)
        for dt in (torch.float32, torch.bfloat16):
            tag = str(dt).split(".")[-1]
            f32 = dt == torch.float32
            bwd = "flash_attention_bwd_f32" if f32 else "flash_attention_bwd"
            for r in res:
                n = r[tag]["launches"]
                if n["flash_attention_fwd"] != 1 or n[bwd] != 1:
                    raise AssertionError(f"rank {r['rank']} {tag}: "
                                         f"launches {n}, want fwd and {bwd} "
                                         "once")
                sm.launches["flash_attention_fwd"] += 1
                sm.launches[bwd] += 1
                if f32:
                    sm.f32_launches["flash_attention_fwd"] += 1
            q, k, v, w = (x.cuda() for x in _ulysses_inputs(ULYSSES_SHAPE,
                                                            dt))
            ts = [x.requires_grad_(True) for x in (q, k, v)]
            with _uncounted(kernels):
                o = ac.flash_attention(*ts, True)
                grads = torch.autograd.grad(torch.sum(o.float() * w), ts)
            got = [torch.cat([r[tag]["o"] for r in res], 1)] + [
                torch.cat([r[tag]["grads"][i] for r in res], 1)
                for i in range(3)]
            reads = {}
            for name, g, want_ in zip(("o", "dq", "dk", "dv"), got,
                                      [o.detach(), *grads]):
                g, want_ = g.float().cuda(), want_.float()
                tol = (FLASH_TOL["fwd" if name == "o" else "bwd"] if f32
                       else FLASH_TOL["bf16"])
                err = (g - want_).abs().max().item()
                ok = torch.allclose(g, want_, rtol=tol[0], atol=tol[1])
                nr = _norm_rel(g, want_)
                reads[name] = (err, nr)
                if not ok or (not f32 and nr > FLASH_NORM_REL):
                    raise AssertionError(f"ulysses {tag} {name}: max abs "
                                         f"err {err}, norm {nr} (tol {tol})")
            moe[f"ulysses {tag}"] = dict(
                reads=reads, a2a_ms=[r[tag]["a2a_ms"] for r in res],
                flash_ms=[r[tag]["flash_ms"] for r in res])
            print(f"   ulysses {tag} (causal, {ULYSSES_SHAPE} over sp 4, head "
                  f"group {res[0][tag]['head_group']}) against one-rank "
                  f"flash_attention: (max abs err, norm-relative) {reads}; "
                  f"the four exchanges of a forward "
                  f"{[r[tag]['a2a_ms'] for r in res]} ms beside the head "
                  f"group's flash forward {[r[tag]['flash_ms'] for r in res]}"
                  f" ms a rank (host clock, fenced; gloo stages through the "
                  f"host: not a scaling number)", flush=True)
        # kernels 5-7 against their plain versions at the head-group shape
        b, s_, n_, h = ULYSSES_SHAPE
        with _uncounted(kernels):
            for dt in (torch.float32, torch.bfloat16):
                f32 = dt == torch.float32
                q, k, v, do = flash_state(b, s_, s_, n_ // 4, n_ // 4, h, dt,
                                          seed=31)
                what = f"{dt} head group [{b * n_ // 4}, {s_}, {h}] causal"
                track = "flash_attention_fwd f32" if f32 else None
                o, lse = ac.flash_attention_fwd(q, k, v, True)
                po, plse = plain_fwd(q, k, v, True)
                sm.expect_close("flash_attention_fwd", o, po, f"o {what}",
                                tol=FLASH_TOL["fwd" if f32 else "bf16"],
                                norm=not f32, track=track)
                sm.expect_close("flash_attention_fwd", lse, plse,
                                f"L {what}", tol=FLASH_TOL["fwd"],
                                track=track)
                args = (q, k, v, do, ac.bwd_prep(do, o), lse, 0, True,
                        n_ // 4, n_ // 4)
                got = ac.flash_attention_bwd(*args)
                want = ac.plain_flash_bwd(*args)
                bk = "flash_attention_bwd_f32" if f32 \
                    else "flash_attention_bwd"
                for name, g, w_ in zip(("dq", "dk", "dv"), got, want):
                    sm.expect_close(bk, g, w_, f"{name} {what}",
                                    tol=FLASH_TOL["bwd" if f32 else "bf16"],
                                    norm=not f32,
                                    track=f"{bk} f32" if f32 else None)
        # the sharded stencil against its run on one rank
        u = _stencil_input(STENCIL_CELLS).cuda()
        one = make_mesh((1,), ("x",))
        outs = {}
        for w_ in (1, 4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = halo.sharded_multistep(one, "x", STENCIL_STEPS, w_)(u, 0.3)
            torch.cuda.synchronize()
            one_ms = (time.perf_counter() - t0) * 1e3
            got = torch.cat([r[f"stencil_h{w_}"] for r in res])
            outs[w_] = got
            if not torch.equal(got, want.cpu()):
                raise AssertionError(f"sharded stencil, halo {w_}: not "
                                     "bitwise the one-rank run")
            ms = [r[f"stencil_h{w_}_ms"] for r in res]
            moe[f"stencil h{w_}"] = dict(ms=ms, one_rank_ms=one_ms)
            print(f"   sharded_multistep, {STENCIL_CELLS} cells over 4 "
                  f"ranks, {STENCIL_STEPS} steps, halo_steps {w_}, coef "
                  f"0.3: bitwise equal to make_mesh((1,))'s run; {ms} ms a "
                  f"rank (host clock; ghosts staged through pinned host "
                  f"memory under gloo), one rank {one_ms!r} ms", flush=True)
        if not torch.equal(outs[1], outs[4]):
            raise AssertionError("halo_steps 4 differs from halo_steps 1")

    if train:
        sm.phase("main path: expert parallelism (4 ranks)",
                 lambda: run_path(ep_path))
        sm.phase("Ulysses and the sharded stencil (4 ranks)",
                 lambda: run_path(ulysses_path))

    multi = {}

    def pipeline_path():
        """make_pipelined_train_step on 4 ranks (gloo on one card, nccl
        with a card a rank) over PP_MESHES: bf16 steps whose loss falls,
        each rank's flash launches a step held to the schedule's count;
        the f32 gate against the single-device step on the same weights
        and batch (its loss within PP_LOSS_REL relative, the updated
        weights within PP_WEIGHT_REL by the norm), planted faults
        reading above PP_FAULT_READ; kernels 5-7 against their plain
        versions at a stage's microbatch shape."""
        import tempfile
        from hpx_tpu_torch.parallel.mesh import launch
        torch.cuda.empty_cache()
        print(f"   card: {smi}", flush=True)
        cfg32 = tf.TransformerConfig(**TRAIN_MODEL)
        p0 = tf.init_params(cfg32, seed=0)
        gen = torch.Generator(device="cuda").manual_seed(1)
        toks, tgts = tf.sample_batch(cfg32, 8, 1024, generator=gen)
        w0 = {n: x.detach().clone() for n, x in p0.named_parameters()}
        one = tf.make_train_step(cfg32)
        with _uncounted(kernels):       # the single-device step, uncaptured
            p1, l_one = getattr(one, "eager", one)(
                p0, toks[:PP_F32_BATCH], tgts[:PP_F32_BATCH])
        l_one = float(l_one)
        w1 = {n: x.detach().clone() for n, x in p1.named_parameters()}
        del p0, p1, one
        tmp = tempfile.mkdtemp(prefix="pp_gate_")
        path = os.path.join(tmp, "w.pt")
        torch.save({"w0": {n: x.cpu() for n, x in w0.items()},
                    "w1": {n: x.cpu() for n, x in w1.items()}}, path)
        del w0, w1
        torch.cuda.empty_cache()
        try:
            t = HighResolutionTimer()
            res = launch(_pp_rank, 4, path, PP_F32_BATCH, timeout=900)
        finally:
            import shutil
            shutil.rmtree(tmp, ignore_errors=True)
        print(f"   4 ranks, 3 meshes in {t.elapsed()!r} s, backend "
              f"{res[0][0]['backend']}, devices "
              f"{[r[0]['device'] for r in res]}", flush=True)
        n_layers = cfg32.n_layers
        for i, (shape, names, m, v) in enumerate(PP_MESHES):
            rs = [r[i] for r in res]
            pp = dict(zip(names, shape))["pp"]
            m32 = rs[0]["m32"]
            # each live step of a stage runs L/(pp V) blocks, a stage has
            # M V live steps: the forward and the backward walk's remat
            # launch kernel 5 M L/pp times each, kernels 6-7 M L/pp times
            want = {"flash_attention_fwd": 2 * m * n_layers // pp,
                    "flash_attention_bwd": m * n_layers // pp,
                    "flash_attention_bwd_f32": 0,
                    "flash_attention_chunk": 0}
            want32 = {"flash_attention_fwd": 2 * m32 * n_layers // pp,
                      "flash_attention_bwd": 0,
                      "flash_attention_bwd_f32": m32 * n_layers // pp,
                      "flash_attention_chunk": 0}
            for r in rs:
                for j, n in enumerate(r["per_step"]):
                    if n != want:
                        raise AssertionError(
                            f"{shape} rank {r['rank']} step {j}: launches "
                            f"{n}, want {want} (fwd 2 M L/pp, bwd M L/pp)")
                if r["f32_launches"] != want32:
                    raise AssertionError(
                        f"{shape} rank {r['rank']} f32: launches "
                        f"{r['f32_launches']}, want {want32}")
                for k in want:
                    sm.launches[k] += PP_STEPS * want[k] + want32[k]
                    pp_launches[k] += PP_STEPS * want[k] + want32[k]
                sm.f32_launches["flash_attention_fwd"] += \
                    want32["flash_attention_fwd"]
                if r["losses"] != rs[0]["losses"] or \
                        r["f32_loss"] != rs[0]["f32_loss"]:
                    raise AssertionError(f"{shape}: ranks' losses differ")
            r0 = rs[0]
            if not r0["losses"][-1] < r0["losses"][0]:
                raise AssertionError(f"{shape}: the loss did not fall: "
                                     f"{r0['losses']}")
            step_ms = [max(r["secs"][j] for r in rs) * 1e3
                       for j in range(PP_STEPS)]
            splits = [r["split"] for r in rs]
            share = [sp_["comm_ms"] / sp_["step_ms"] for sp_ in splits]
            rel = abs(r0["f32_loss"] - l_one) / abs(l_one)
            wr = {n: x[0] for n, x in r0["f32_reads"].items()}
            ur = {n: x[1] for n, x in r0["f32_reads"].items()}
            worst_w = max(wr, key=wr.get)
            worst_u = max(ur, key=ur.get)
            tag = f"pp {'x'.join(map(str, shape))} M{m} V{v}"
            multi[tag] = dict(
                step_ms=step_ms, losses=r0["losses"],
                peak_gib=max(r["peak_gib"] for r in rs), split=splits,
                comm_share=share, f32_loss_rel=rel,
                f32_weight_read=wr[worst_w], f32_update_read=ur[worst_u],
                launches_a_step=want, f32_launches=want32)
            print(f"   {dict(zip(names, shape))}, M {m}, interleave {v}: "
                  f"bf16 steps {step_ms} ms (slowest rank, host clock; 4 "
                  f"ranks time-slice one card: not a training rate), loss "
                  f"{r0['losses']}, peak {multi[tag]['peak_gib']!r} GiB; "
                  f"launches a rank and step {want} = fwd 2 M L/pp, bwd "
                  f"M L/pp (L {n_layers}, pp {pp}); 2 more steps fenced: "
                  f"{[sp_['step_ms'] for sp_ in splits]} ms, in "
                  f"torch.distributed's verbs "
                  f"{[sp_['comm_ms'] for sp_ in splits]} ms (share "
                  f"{share}), staging copies "
                  f"{[sp_['copies_ms'] for sp_ in splits]} ms", flush=True)
            print(f"   f32 gate, batch {PP_F32_BATCH} x 1024, M {m32}: loss "
                  f"{r0['f32_loss']!r} vs one device {l_one!r}, relative "
                  f"{rel!r} (<= {PP_LOSS_REL}); updated weights' largest "
                  f"norm-relative reading {wr[worst_w]!r} ({worst_w}; <= "
                  f"{PP_WEIGHT_REL}); the update's {ur[worst_u]!r} "
                  f"({worst_u}); launches a rank {want32}", flush=True)
            if rel > PP_LOSS_REL or wr[worst_w] > PP_WEIGHT_REL:
                raise AssertionError(f"{shape} f32 gate: loss {rel}, "
                                     f"{worst_w} {wr[worst_w]}")
            for fault in ("hop", "emb"):
                key = f"f32_{fault}_reads"
                if key not in r0:
                    continue
                fr_ = {n: x[1] for n, x in r0[key].items()}
                caught = max(fr_, key=fr_.get)
                multi[tag][f"fault_{fault}"] = fr_[caught]
                print(f"   planted fault ({'the backward hop to the next '
                      'member' if fault == 'hop' else 'emb unsummed over '
                      'pp'}) reads {fr_[caught]!r} ({caught}; must pass "
                      f"{PP_FAULT_READ})", flush=True)
                if fr_[caught] <= PP_FAULT_READ:
                    raise AssertionError(f"{shape}: the gate would miss "
                                         f"the {fault} fault")
        # kernels 5-7 against their plain versions at a stage's
        # microbatch shape: bf16 mb 2 of (1, 4), f32 mb 1 of the gate
        with _uncounted(kernels):
            for dt, b in ((torch.bfloat16, 2), (torch.float32, 1)):
                f32 = dt == torch.float32
                nh, hd = TRAIN_MODEL["n_heads"], TRAIN_MODEL["head_dim"]
                q, k, v_, do = flash_state(b, 1024, 1024, nh, nh, hd, dt,
                                           seed=33)
                what = f"{dt} stage microbatch [{b * nh}, 1024, {hd}] causal"
                track = "flash_attention_fwd f32" if f32 else None
                o, lse = ac.flash_attention_fwd(q, k, v_, True)
                po, plse = plain_fwd(q, k, v_, True)
                sm.expect_close("flash_attention_fwd", o, po, f"o {what}",
                                tol=FLASH_TOL["fwd" if f32 else "bf16"],
                                norm=not f32, track=track)
                sm.expect_close("flash_attention_fwd", lse, plse,
                                f"L {what}", tol=FLASH_TOL["fwd"],
                                track=track)
                args = (q, k, v_, do, ac.bwd_prep(do, o), lse, 0, True,
                        nh, nh)
                got = ac.flash_attention_bwd(*args)
                want_ = ac.plain_flash_bwd(*args)
                bk = "flash_attention_bwd_f32" if f32 \
                    else "flash_attention_bwd"
                for nm, g_, w_ in zip(("dq", "dk", "dv"), got, want_):
                    sm.expect_close(bk, g_, w_, f"{nm} {what}",
                                    tol=FLASH_TOL["bwd" if f32 else "bf16"],
                                    norm=not f32,
                                    track=f"{bk} f32" if f32 else None)

    pp_launches = {k: 0 for k in ("flash_attention_fwd",
                                  "flash_attention_bwd",
                                  "flash_attention_bwd_f32",
                                  "flash_attention_chunk")}
    if train:
        sm.phase("main path: pipelined training (4 ranks)", pipeline_path)

    def jacobi_path():
        """Config #5 at JACOBI: jacobi_serial, jacobi_dataflow over the
        row blocks on a BlockExecutor of the card's targets, and
        jacobi_sharded on a 2 x 2 mesh of 4 ranks (JACOBI_SPD sweeps a
        dispatch): bitwise equal grids, the residual within n eps, Mcells/s
        of each; a planted fault (ghosts that never arrive) must differ."""
        from hpx_tpu_torch.exec.block import BlockExecutor
        from hpx_tpu_torch.models import jacobi2d as jm
        from hpx_tpu_torch.parallel.mesh import launch
        torch.cuda.empty_cache()
        p = jm.JacobiParams(**JACOBI)
        n, it = p.nx, p.iterations
        mcells = p.nx * p.ny * it / 1e6
        torch.cuda.synchronize()
        t = HighResolutionTimer()
        serial = jm.jacobi_serial(p)
        torch.cuda.synchronize()
        t_serial = t.elapsed()
        ex = BlockExecutor()
        t.restart()
        df = jm.gather_blocks(jm.jacobi_dataflow(p, ex))
        torch.cuda.synchronize()
        t_df = t.elapsed()
        if not torch.equal(df, serial):
            bad = (df != serial).nonzero()
            raise AssertionError(
                f"jacobi_dataflow differs from jacobi_serial at {len(bad)} "
                f"cells, first {bad[:4].tolist()}, max "
                f"{(df - serial).abs().max().item()}")
        del df
        u99 = jm.jacobi_serial(dataclasses.replace(p, iterations=it - 1))
        u100 = jm.jacobi_serial(dataclasses.replace(p, iterations=1), u99)
        if not torch.equal(u100, serial):
            raise AssertionError("99 + 1 sweeps differ from 100")
        res = float(jm.residual(u99, u100))
        del u99, u100
        torch.cuda.empty_cache()
        t.restart()
        rs = launch(_jacobi_rank, 4, JACOBI_SPD, timeout=900)
        print(f"   4 ranks in {t.elapsed()!r} s, backend {rs[0]['backend']}, "
              f"devices {[r['device'] for r in rs]}; {smi}", flush=True)
        h, w = n // 2, p.ny // 2
        out = dict(serial_mcells_s=mcells / t_serial,
                   dataflow_mcells_s=mcells / t_df, residual=res)
        for r in rs:
            i, j = r["coords"]
            want = _digest(serial[i * h:(i + 1) * h, j * w:(j + 1) * w])
            for spd in JACOBI_SPD:
                if r[f"digest_{spd}"] != want:
                    raise AssertionError(f"jacobi_sharded block {(i, j)}, "
                                         f"{spd} sweeps a dispatch: not "
                                         "bitwise the serial grid")
                got = r[f"res_{spd}"]
                if abs(got - res) > p.nx * p.ny * 1.1920929e-07 * abs(res):
                    raise AssertionError(f"residual {got} vs {res}")
            r["fault_differs"] = r["digest_unexchanged"] != want
        # the heat spreads from the top edge: the top blocks meet at the
        # vertical cut, where ghosts that never arrive must show
        if not any(r["fault_differs"] for r in rs):
            raise AssertionError("the planted fault (ghosts that never "
                                 "arrive) reads equal")
        for spd in JACOBI_SPD:
            secs = max(r[f"secs_{spd}"] for r in rs)
            out[f"sharded_spd{spd}_mcells_s"] = mcells / secs
            out[f"sharded_spd{spd}_residual_rel"] = max(
                abs(r[f"res_{spd}"] - res) / abs(res) for r in rs)
        multi["jacobi"] = out
        print(f"   config #5, {n}x{p.ny} f32, {it} sweeps: serial "
              f"{out['serial_mcells_s']!r} Mcells/s, dataflow ({p.nb} row "
              f"blocks on {ex.num_workers} target(s)) "
              f"{out['dataflow_mcells_s']!r} Mcells/s, sharded 2 x 2 "
              f"{[out[f'sharded_spd{s_}_mcells_s'] for s_ in JACOBI_SPD]} "
              f"Mcells/s at {JACOBI_SPD} sweeps a dispatch (slowest rank; "
              f"4 processes share one card and the host: not a scaling "
              f"number); all three grids bitwise equal; residual {res!r}, "
              f"the sharded one's relative difference "
              f"{[out[f'sharded_spd{s_}_residual_rel'] for s_ in JACOBI_SPD]}"
              f" (<= n eps); ghosts that never arrive: blocks "
              f"{[r['coords'] for r in rs if r['fault_differs']]} differ",
              flush=True)

    sm.phase("Jacobi (config #5)", jacobi_path)

    fft_world = {}

    def fft_path():
        """fft_sharded / ifft_sharded of FFT_N complex64 over 4 ranks and
        fft2_sharded_2d of FFT2_SIDE^2 on a 2 x 2 mesh: within FFT_TOL of
        float64 numpy and of the one-rank transform on the card, by the
        norm; ms a transform and the exchanges' share."""
        from hpx_tpu_torch.algo import fft as dfft
        from hpx_tpu_torch.parallel.mesh import Mesh, launch
        torch.cuda.empty_cache()
        t = HighResolutionTimer()
        rs = launch(_fft_rank, 4, FFT_N, FFT2_SIDE, timeout=900)
        fft_world["ranks"] = rs
        print(f"   4 ranks in {t.elapsed()!r} s, backend {rs[0]['backend']}, "
              f"devices {[r['device'] for r in rs]}; {smi}", flush=True)
        v = _fft_signal(FFT_N, 41)
        a = _fft_signal((FFT2_SIDE, FFT2_SIDE), 42)
        one, one2 = Mesh((1,), ("x",)), Mesh((1, 1), ("x", "y"))
        vc, ac_ = torch.from_numpy(v).cuda(), torch.from_numpy(a).cuda()
        want = {"fft": (np.fft.fft(v.astype(np.complex128)),
                        dfft.fft_sharded(vc, one).cpu().numpy()),
                "ifft": (np.fft.ifft(v.astype(np.complex128)),
                         dfft.ifft_sharded(vc, one).cpu().numpy()),
                "fft2_2d": (np.fft.fft2(a.astype(np.complex128)),
                            dfft.fft2_sharded_2d(ac_, one2).cpu().numpy())}

        def rel(x, y):
            return float(np.linalg.norm(x - y) / np.linalg.norm(y))
        out = {}
        for name, (ref64, ref1) in want.items():
            if name == "fft2_2d":
                got = torch.cat([torch.cat([rs[2 * i + j][name]
                                            for j in range(2)], 1)
                                 for i in range(2)]).numpy()
            else:
                got = torch.cat([r[name] for r in rs]).numpy()
            r64, r1 = rel(got, ref64), rel(got, ref1)
            ms = max(r[name + "_ms"] for r in rs)
            share = [r[name + "_split"]["comm_ms"]
                     / r[name + "_split"]["step_ms"] for r in rs]
            out[name] = dict(rel_numpy=r64, rel_one_rank=r1, ms=ms,
                             a2a_share=share)
            print(f"   {name} ({'2^22' if name != 'fft2_2d' else '2048^2'} "
                  f"complex64, 4 ranks): within {r64!r} of float64 numpy and "
                  f"{r1!r} of the one-rank transform (<= {FFT_TOL}); "
                  f"{ms!r} ms a transform (slowest rank, median of 5, host "
                  f"clock); the exchanges' share of fenced calls {share}",
                  flush=True)
            if r64 > FFT_TOL or r1 > FFT_TOL:
                raise AssertionError(f"multi-rank {name}: {r64}, {r1}")
        back = torch.cat([r["round"] for r in rs]).numpy()
        out["round_trip"] = rel(back, v)
        if out["round_trip"] > 1e-5:
            raise AssertionError(f"round trip {out['round_trip']}")
        multi["fft"] = out

    sm.phase("multi-rank FFT (4 ranks)", fft_path)

    def dsort_path():
        """The distributed sorts and the multi-rank partitioned_vector over
        4 ranks on one card (gloo), run by _dsort_part in the multi-rank
        FFT's world: every rank's checks must pass, and each planted fault
        must fail its check on some rank."""
        rs = fft_world.get("ranks")
        if rs is None:
            raise AssertionError("the multi-rank FFT's world did not come "
                                 "back")
        errs = [r["dsort_error"] for r in rs if "dsort_error" in r]
        if errs:
            raise AssertionError(f"a rank failed:\n{errs[0]}")
        ds = [r["dsort"] for r in rs]
        checks = ("sample_equal", "odd_even_equal", "special_sample",
                  "special_odd_even", "by_key", "reduce", "scan",
                  "minmax_nan", "count", "partition")
        failed = sorted({k for d in ds for k in checks if not d[k]})
        out = {}
        for method in ("sample", "odd_even"):
            share = [d[f"{method}_split"]["comm_ms"]
                     / d[f"{method}_split"]["step_ms"] for d in ds]
            ms = max(d[f"{method}_ms"] for d in ds)
            verbs = [{k: v for k, v in d[f"{method}_verbs"].items() if v}
                     for d in ds]
            out[method] = dict(ms=ms, verbs_share=share, verbs=verbs,
                               ms_by_rank=[d[f"{method}_ms"] for d in ds])
            print(f"   sort_sharded({method}) of 2^24 f32, 2^22 a rank: "
                  f"bitwise np.sort(kind='stable') on every rank: "
                  f"{all(d[f'{method}_equal'] for d in ds)}; {ms!r} ms a "
                  f"sort (slowest rank, mean of 3 fenced, host clock); "
                  f"torch.distributed's verbs {share} of a fenced sort; "
                  f"verbs of one sort by rank {verbs}", flush=True)
        a2a = {d["sample_verbs"]["all_to_all_single"] for d in ds}
        rounds = max(d["odd_even_verbs"]["batch_isend_irecv"] for d in ds)
        if a2a != {3} or rounds < 4:
            failed.append(f"verb counts: sample all_to_all {a2a}, odd-even "
                          f"rounds {rounds}")
        gbs = [d["triad_gbs"] for d in ds]
        rel = max(d["triad_rel"] for d in ds)
        verbs = sum(d["triad_verbs"] for d in ds)
        lays = [d["triad_layout"] for d in ds]
        print(f"   config #3 over 4 ranks (2^24 f32 in 4 partitions, "
              f"hpx.transform(par.on(cuda_executor()), pv_b, f, pv_c)): "
              f"{verbs} verbs on the path; max relative error {rel!r}; "
              f"GB/s a rank {gbs} (the 4 ranks at once on one card, slope "
              f"of 64 and 640 dispatches); blocks {lays}", flush=True)
        if verbs or rel > 2.5e-7 or any(
                t[:3] != ("PartitionedVector", True, DSORT_N // 4)
                for t in lays):
            failed.append("config #3 over ranks")
        print(f"   on 2^22 f32 in 8 partitions (fills its layout): reduce "
              f"and inclusive_scan of integers 0-3 (bitwise), "
              f"minmax_element with a NaN, count, "
              f"partition with -0.0: {[{k: d[k] for k in checks[5:]} for d in ds]}; "
              f"NaN/-0.0/inf sorts and by-key NaN payloads: "
              f"{[{k: d[k] for k in checks[2:5]} for d in ds]}", flush=True)
        faults = {}
        for key, what in (("fault_scan_passes",
                           "the scan's cross-rank prefix left out"),
                          ("fault_scan_one_total_passes",
                           "the scan's prefix leaving out rank 0's total"),
                          ("fault_reduce_partial_passes",
                           "reduce dropping the last rank's partial"),
                          ("fault_rounds_passes",
                           "odd-even with p - 1 rounds, reversed input"),
                          ("fault_splitters_passes",
                           "p - 1 splitters from rank 0's own chunk "
                           "alone, skewed input")):
            caught = not all(d[key] for d in ds)
            faults[key.replace("_passes", "_caught")] = caught
            print(f"   planted fault ({what}): check failed on ranks "
                  f"{[i for i, d in enumerate(ds) if not d[key]]} "
                  f"(caught: {caught})", flush=True)
            if not caught:
                failed.append(f"fault not caught: {what}")
        print(f"   reading: p - 1 splitters from rank 0's p samples after "
              f"the stripe, on the skewed input, sort correctly on every "
              f"rank: "
              f"{all(d['rank0_splitters_passes'] for d in ds)} (the rank "
              f"stripe gives every rank a regular sample of every chunk)",
              flush=True)
        secs = max(d["seconds"] for d in ds)
        fft_world["dsort_s"] = secs
        print(f"   the phase's ranks: {secs!r} s in the FFT's world; {smi}",
              flush=True)
        out.update(triad_gbs=gbs, triad_rel=rel, faults=faults, seconds=secs,
                   rank0_splitters_sort=all(d["rank0_splitters_passes"]
                                            for d in ds))
        multi["dsort"] = out
        if failed:
            raise AssertionError(f"distributed sort phase: {failed}")

    sm.phase("distributed sort and the multi-rank vector (4 ranks)",
             dsort_path)
    # that phase's ranks ran in the FFT phase's world, so the FFT phase's
    # seconds held them: move the slowest rank's seconds over
    moved = fft_world.get("dsort_s", 0.0)
    sm.seconds["multi-rank FFT (4 ranks)"] -= moved
    sm.seconds["distributed sort and the multi-rank vector (4 ranks)"] += \
        moved
    print(f"   (phase seconds: the slowest rank's {moved:.1f} s of the "
          f"distributed sort phase, run in the FFT's world, moved from the "
          f"FFT phase's seconds to its own)", flush=True)

    sharded = {}
    sharded_launches = {k: 0 for k in PAGED_KERNELS}

    def sharded_path():
        """ContinuousServer(mesh=) on 4 ranks (gloo on one card, nccl with
        a card a rank), Mesh((2, 2), ("dp", "tp")), at the serving
        model's full width (_sharded_serve_rank): every rank's f32 tokens
        equal the one-rank server's on this card (dense, fused,
        fused_online, int8 pools, n-gram speculation, MoE); kernels 3-4
        launched n_layers times a decode step and a verify window on
        every rank, the profiler's records of kernel 3 equal to its
        count, and both kernels within their contract of their plain
        versions at the rank's shape; both planted faults differ."""
        from hpx_tpu_torch.parallel.mesh import launch
        torch.cuda.empty_cache()
        print(f"   card: {smi}", flush=True)
        f32 = torch.float32
        fused = dict(paged=True, paged_kernel="fused")
        online = dict(paged=True, paged_kernel="fused_online")
        one = {}

        def one_rank(label, mix, params, cfg, reqs, base, **kw):
            srv = serving.ContinuousServer(params, cfg, **base, **kw)
            for p, m in reqs:
                srv.submit(p, max_new=m)
            res = srv.run()
            one[label] = ([res[r] for r in sorted(res)],
                          (srv._moe_routed, srv._moe_dropped))
        with _uncounted(kernels):
            for mix in ("a", "b"):
                reqs, base = mixes[mix]
                for dt, tag in ((f32, "f32"), (torch.bfloat16, "bf16")):
                    params, cfg = model(dt)
                    one_rank(f"({mix}) {tag} fused", mix, params, cfg, reqs,
                             base, **fused)
            params, cfg = model(f32)
            reqs, base = mixes["a"]
            one_rank("(a) f32 dense", "a", params, cfg, reqs, base)
            one_rank("(a) f32 fused_online", "a", params, cfg, reqs, base,
                     **online)
            one_rank("(a) f32 fused int8 pools", "a", params, cfg, reqs,
                     base, kv_dtype="int8", **fused)
            reqs, base = mixes["b"]
            one_rank("(b) f32 fused spec", "b", params, cfg, reqs, base,
                     spec=True, spec_k=SPEC_K, **fused)
            mcfg = tf.TransformerConfig(**MOE_MODEL)
            mparams = tf.init_params(mcfg, seed=MOE_SEED)
            mreqs = _moe_requests(mcfg.vocab)
            one_rank("MoE f32 dense", "moe", mparams, mcfg, mreqs,
                     MOE_SERVER)
            del mparams
        one["MoE f32 fused"] = one["MoE f32 dense"]
        for k in ("fault: wo close left out",
                  "fault: dp rank 1's table rows shifted"):
            one[k] = one["(a) f32 fused"]
        torch.cuda.empty_cache()
        t = HighResolutionTimer()
        rs = launch(_sharded_serve_rank, 4, timeout=900)
        print(f"   4 ranks in {t.elapsed()!r} s ({[r['seconds'] for r in rs]} "
              f"s inside the ranks), backend {rs[0]['backend']}, devices "
              f"{[r['device'] for r in rs]}, coords "
              f"{[r['coords'] for r in rs]}", flush=True)
        runs = rs[0]["runs"]
        for label, r0 in runs.items():
            want, moe_want = one[label]
            total = sum(len(x) for x in want)
            fault = label.startswith("fault")
            # a fault may part the ranks' tokens: it reads on the rank
            # that agrees least with the one-rank server
            same = min(sum(a == b for x, y in zip(r["runs"][label]["tokens"],
                                                  want)
                           for a, b in zip(x, y)) for r in rs)
            for r in rs[1:]:
                if r["runs"][label]["launches"] != r0["launches"] or (
                        not fault
                        and r["runs"][label]["tokens"] != r0["tokens"]):
                    raise AssertionError(f"{label}: rank {r['rank']}'s "
                                         "tokens or launches differ from "
                                         "rank 0's")
            for k, n in r0["launches"].items():
                if not fault:
                    sm.launches[k] += 4 * n
                    sharded_launches[k] += 4 * n
            print(f"   {label}: {same} of {total} tokens equal the one-rank "
                  f"server's; {r0['steps']} decode steps and {r0['windows']} "
                  f"verify windows on kernel {r0['kernel']}, launches a rank "
                  f"{r0['launches']} ({r0['rows']} slots and "
                  f"{r0['heads']} kv heads a rank); "
                  f"{sum(len(x) for x in r0['tokens']) / r0['wall']!r} "
                  f"tokens/s; CUDA graphs {r0['graphs']}"
                  + (f"; MoE (routed, dropped) {r0['moe']}, one rank "
                     f"{moe_want}" if label.startswith("MoE") else "")
                  + (f"; spec {r0['spec']}" if r0["spec"] else ""),
                  flush=True)
            sharded[label] = dict(equal=same, tokens=total,
                                  tokens_per_s=sum(len(x) for x in
                                                   r0["tokens"]) / r0["wall"],
                                  launches=r0["launches"], steps=r0["steps"],
                                  windows=r0["windows"])
            if fault:
                if same == total:
                    raise AssertionError(f"planted {label} reads as a pass")
            elif "bf16" not in label and same != total:
                raise AssertionError(f"{label}: {total - same} f32 tokens "
                                     "differ from the one-rank server's")
            if label.startswith("MoE") and r0["moe"] != moe_want:
                raise AssertionError(f"{label}: MoE claims {r0['moe']}, one "
                                     f"rank {moe_want}")
            if r0["graphs"]:
                raise AssertionError(f"{label}: a gloo mesh captured "
                                     f"{r0['graphs']} graphs")
        for r in rs:
            p_ = r["profiled"]
            print(f"   rank {r['rank']}: torch.profiler holds "
                  f"{p_['traced']} runs of kernel 3 in (a) f32 fused, its "
                  f"wrapper counted {p_['counted']} (attempt "
                  f"{p_['attempt'] + 1}, after {TRACE_LEAD_IN} lead-in "
                  f"launches and a {TRACE_MARGIN_S} s margin)", flush=True)
            if p_["traced"] != p_["counted"] or not p_["counted"]:
                raise AssertionError(f"rank {r['rank']}: the trace holds "
                                     f"{p_['traced']} runs of kernel 3, "
                                     f"the wrapper counted {p_['counted']}")
            for c in r["checks"]:
                k = c["kernel"]
                sm.max_abs_err[k] = max(sm.max_abs_err[k], c["err"])
                sm.margin[k] = max(sm.margin[k], c["margin"])
                if not c["ok"]:
                    raise AssertionError(f"rank {r['rank']}: {k} on the "
                                         f"{c['what']} pools {c['shape']}: "
                                         f"max abs err {c['err']}")
        worst = {}
        for c in (c for r in rs for c in r["checks"]):
            worst[c["kernel"], c["shape"]] = max(
                worst.get((c["kernel"], c["shape"]), 0.0), c["err"])
        print(f"   kernels 3-4 against their plain versions at the rank's "
              f"shape, every rank and layer, largest max abs err by pool "
              f"shape: {worst}", flush=True)
        split = [r["split"] for r in rs]
        for r, sp_ in zip(rs, split):
            print(f"   rank {r['rank']}, (a) f32 fused with every verb and "
                  f"staging copy fenced and timed: "
                  f"{sp_['tokens'] / sp_['step_ms'] * 1e3!r} tokens/s, "
                  f"{sp_['step_ms'] / sp_['steps']!r} host ms a decode "
                  f"step (the run over its {sp_['steps']} decode steps, "
                  f"prefill included), {sp_['comm_ms'] / sp_['step_ms']!r} "
                  f"of the run in "
                  f"torch.distributed's verbs, "
                  f"{sp_['copies_ms'] / sp_['step_ms']!r} in staging copies "
                  f"(4 gloo ranks sharing one card: not a scaling number)",
                  flush=True)
        sharded["split"] = split
        sharded["card"] = smi

    sm.phase("main path: sharded serving (4 ranks)", sharded_path)

    def bf16_pool_gate():
        """Both kernels against their plain versions on the pools the
        bf16 run left, through random tables over its blocks."""
        cpu = torch.Generator().manual_seed(7)
        for layer, (kp, vp) in enumerate(bf16_pools):
            nb, bs = kp.shape[0], kp.shape[1]
            maxb = 1024 // bs
            table = torch.randint(0, nb, (8, maxb), generator=cpu).int()
            pos = torch.randint(0, maxb * bs, (8,), generator=cpu).int()
            pos[0], pos[-1] = 0, maxb * bs - 1
            q = torch.randn(8, 1, 8, 128, generator=cpu).to(torch.bfloat16)
            args = [q.cuda(), kp, vp, table.cuda(), pos.cuda()]
            for k, (fn, plain) in paged.items():
                sm.expect_close(k, fn(*args), plain(*args),
                                f"{k} on the bf16 run's layer-{layer} pools")
    if bf16_pools:
        sm.phase("bf16 pools: kernels against plain", bf16_pool_gate)
    print(f"   launches on the main path: {sm.launches}", flush=True)
    for k, v in sm.launches.items():
        if v <= 0:
            sm.failures.append(f"{k} not launched on the main path")
            print(f"FAIL {k} was not launched on the main path")
    torch.cuda.empty_cache()

    @contextlib.contextmanager
    def eager_programs():
        """Servers built inside run their programs eagerly, as before the
        CUDA-graph captures, for the profiles' before and after."""
        saved = programs.graphs_enabled
        programs.graphs_enabled = lambda device: False
        try:
            yield
        finally:
            programs.graphs_enabled = saved

    def device_events(prof):
        """(device microseconds, host-issued launches by API call) of a
        trace: device events only (kernels, copies; a CPU op's own device
        time already holds its kernels'), and the calls that put work on
        the device: kernel launches (cudaLaunchKernelExC for the
        clustered paged-attention launches), graph launches and copies."""
        ev = prof.key_averages()
        dev = [e for e in ev if e.key not in ("decode step", "trace lead-in")
               and "spin_kernel" not in e.key and
               e.device_type != torch.autograd.DeviceType.CPU]
        calls = {e.key: e.count for e in ev
                 if e.key.startswith(("cudaLaunchKernel", "cudaGraphLaunch",
                                      "cudaMemcpyAsync"))}
        for e in lead_in_launches(prof):
            calls[e.name] -= 1
        return sum(e.self_device_time_total for e in dev), calls, dev

    def trace_lead_in():
        """The head of a trace whose kernel records are held to the
        wrappers' counts, inside its window: TRACE_MARGIN_S of host-only
        time, then TRACE_LEAD_IN launches of the spin kernel under a
        "trace lead-in" range, and a synchronization, so that the counted
        work is not the first the window holds."""
        from torch.profiler import record_function
        time.sleep(TRACE_MARGIN_S)
        with record_function("trace lead-in"):
            for _ in range(TRACE_LEAD_IN):
                torch.cuda._sleep(100)
            torch.cuda.synchronize()

    def lead_in_launches(prof):
        """The host launches inside a trace's "trace lead-in" range."""
        evs = prof.events()
        spans = [(e.time_range.start, e.time_range.end) for e in evs
                 if e.name == "trace lead-in"
                 and e.device_type == torch.autograd.DeviceType.CPU]
        return [e for e in evs if e.name.startswith(
                    ("cudaLaunchKernel", "cudaGraphLaunch"))
                and any(a <= e.time_range.start <= b for a, b in spans)]

    def lead_in_lost(prof) -> str:
        """How many of a trace's lead-in launches have no device record."""
        recorded = {e.id for e in prof.events()
                    if e.device_type != torch.autograd.DeviceType.CPU}
        lead = lead_in_launches(prof)
        lost = sum(e.id not in recorded for e in lead)
        return f"{lost} of the {len(lead)} lead-in launches"

    def launch_skew_us(prof):
        """The least (start of a device record - start of the host call
        that launched it) in a trace, in microseconds: below 0 where the
        profiler placed a kernel before its own launch."""
        evs = prof.events()
        launch = {e.id: e.time_range.start for e in evs if e.name.startswith(
            ("cudaLaunchKernel", "cudaGraphLaunch"))}
        return min((e.time_range.start - launch[e.id] for e in evs
                    if e.device_type != torch.autograd.DeviceType.CPU
                    and e.id in launch), default=None)

    def unrecorded_launches(prof):
        """The host launches after a trace's lead-in whose device record
        the profiler does not hold: (API call, ms after the trace's first
        event) of each, to place a record the trace lost."""
        evs = prof.events()
        recorded = {e.id for e in evs
                    if e.device_type != torch.autograd.DeviceType.CPU}
        lead = {e.id for e in lead_in_launches(prof)}
        t0 = min((e.time_range.start for e in evs), default=0)
        return [(e.name, (e.time_range.start - t0) * 1e-3) for e in evs
                if e.name.startswith(("cudaLaunchKernel", "cudaGraphLaunch"))
                and e.id not in recorded and e.id not in lead]

    def traced_launches(what, prof, dev, before):
        """The counted kernels' launches the profiler saw run on the card
        (its kernel records, which graph replays' kernels are among),
        against the wrappers' counts since ``before`` ({name: count}),
        which a replay raises by its graph's nodes: equal, or the run
        fails. Returns {wrapper: launches traced}."""
        traced = {}
        for w in programs._COUNTED:
            n = sum(e.count for e in dev if w.kernels.search(e.key))
            counted_ = w.launches - before[w.__name__]
            if n != counted_:
                raise AssertionError(
                    f"{what}: the trace holds {n} runs of {w.__name__}'s "
                    f"kernel, its count rose by {counted_} (least launch "
                    f"skew {launch_skew_us(prof)} us; launches without a "
                    f"device record {unrecorded_launches(prof)}; "
                    f"{lead_in_lost(prof)} without one)")
            if n:
                traced[w.__name__] = n
        return traced

    def trace_short(what, prof, dev, before, attempt) -> bool:
        """True where the trace holds fewer runs of some counted kernel
        than its wrapper's count rose by, and of none more, with an
        attempt left; such a trace is taken again, up to TRACE_ATTEMPTS
        times, and traced_launches holds the last one exactly. The
        profiler drops device records that it places before its window
        (TRACE_MARGIN_S keeps the counted work away from both ends) and
        has dropped the first records of a window's work (the lead-in's
        now)."""
        short = {}
        for w in programs._COUNTED:
            n = sum(e.count for e in dev if w.kernels.search(e.key))
            counted_ = w.launches - before[w.__name__]
            if n > counted_:
                return False
            if n < counted_:
                short[w.__name__] = (n, counted_)
        if not short or attempt + 1 >= TRACE_ATTEMPTS:
            return False
        print(f"   {what}: the trace is short of the wrappers' counts "
              f"(traced, counted) {short}, least launch skew "
              f"{launch_skew_us(prof)} us, launches without a device "
              f"record {unrecorded_launches(prof)} ({lead_in_lost(prof)} "
              "without one); traced again",
              flush=True)
        return True

    def serve_steps(srv, reqs, profiled=False):
        """(steps, wall seconds, host seconds of each decode step, trace)
        of one run of ``reqs``, stepped by hand, under torch.profiler when
        ``profiled``. A decode step is one that finds no request queued
        and no prefill pending (it only decodes); under the profiler it
        is marked by a "decode step" range."""
        from torch.profiler import ProfilerActivity, profile, record_function
        for p, m in reqs:
            srv.submit(p, max_new=m)
        ctx = (profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
               if profiled else contextlib.nullcontext())
        steps, decode = 0, []
        with ctx as prof:
            torch.cuda.synchronize()
            if profiled:
                trace_lead_in()
            t = HighResolutionTimer()
            more = True
            while more:
                only = not srv._queue and not srv._pending
                t0 = time.perf_counter()
                with (record_function("decode step") if profiled and only
                      else contextlib.nullcontext()):
                    more = srv.step()
                if only:
                    decode.append(time.perf_counter() - t0)
                steps += 1
            torch.cuda.synchronize()
            wall = t.elapsed()
            if profiled:
                time.sleep(TRACE_MARGIN_S)
        return steps, wall, decode, prof

    def decode_calls(prof) -> dict:
        """(host-issued launches inside the trace's "decode step" ranges,
        by API call; the number of ranges). The ranges are the host's
        (the profiler also records each as a device annotation)."""
        import bisect
        evs = prof.events()
        spans = sorted((e.time_range.start, e.time_range.end) for e in evs
                       if e.name == "decode step" and e.device_type
                       == torch.autograd.DeviceType.CPU)
        starts = [a for a, _ in spans]
        out = {}
        for e in evs:
            if not e.name.startswith(("cudaLaunchKernel", "cudaGraphLaunch",
                                      "cudaMemcpyAsync")):
                continue
            i = bisect.bisect_right(starts, e.time_range.start) - 1
            if i >= 0 and e.time_range.start <= spans[i][1]:
                out[e.name] = out.get(e.name, 0) + 1
        return out, len(spans)

    def serving_profile():
        """Where a decode step's time goes, before and after the captures:
        mixes (b) and (a) in bf16 (auto -> fused) on a server whose
        programs run eagerly and on one whose step, chunk and probe
        programs replay CUDA graphs; each server warmed by two runs of
        the mix (its captures, cuBLAS), then timed unprofiled in the
        order eager, captured, captured, eager (ms a step: the wall clock
        of a run over its steps), then run once under torch.profiler.
        Busy share: the device events' summed time over the wall time,
        of the profiled run and of the unprofiled ones (device ms a step
        over ms a step)."""
        params, cfg = model(torch.bfloat16)
        for mix in ("b", "a"):
            reqs, base = mixes[mix]
            kw = dict(base, paged=True, block_size=16)
            with eager_programs():
                eager = serving.ContinuousServer(params, cfg, **kw)
            runs = {"eager": eager,
                    "captured": serving.ContinuousServer(params, cfg, **kw)}
            if runs["eager"]._graphs or runs["eager"]._graph_pool:
                raise AssertionError("the eager server captures")
            for srv in runs.values():
                # twice: the second run's prompts meet the radix tree, so
                # its chunk widths are the later runs' too
                for _ in range(2):
                    serve_steps(srv, reqs)
            ms = {k: [] for k in runs}
            dec = {k: [] for k in runs}
            caught = 0
            for k in ("eager", "captured", "captured", "eager"):
                with count_captures() as caps:
                    steps, wall, decode, _ = serve_steps(runs[k], reqs)
                caught += caps.captures
                ms[k].append(wall / steps * 1e3)
                dec[k].append(statistics.median(decode) * 1e3)
            print(f"   ({mix}) captures during the timed runs: {caught}",
                  flush=True)
            for k, srv in runs.items():
                for attempt in range(TRACE_ATTEMPTS):
                    before = {w.__name__: w.launches
                              for w in programs._COUNTED}
                    steps, wall, _, prof = serve_steps(srv, reqs,
                                                       profiled=True)
                    dev_us, calls, dev = device_events(prof)
                    if dev_us <= 0 or not trace_short(
                            f"({mix}) bf16 {k}", prof, dev, before, attempt):
                        break
                total = sum(calls.values())
                dcalls, nd = decode_calls(prof)
                step_ms = statistics.mean(ms[k])
                print(f"   ({mix}) bf16 {k}: {step_ms!r} ms a step (runs "
                      f"{ms[k]}, {steps} steps a run); host ms a decode "
                      f"step (median, runs) {dec[k]}; profiled "
                      f"{wall / steps * 1e3!r} ms a step; {total / steps!r} "
                      f"host-issued launches a step {calls}; "
                      f"{sum(dcalls.values()) / max(nd, 1)!r} a decode step "
                      f"({nd} decode steps) {dcalls}; on {smi}", flush=True)
                if dev_us <= 0:
                    print(f"   ({mix}) {k}: device busy share not measured "
                          "(the profiler recorded no device time)",
                          flush=True)
                    continue
                traced = traced_launches(f"({mix}) bf16 {k}", prof, dev,
                                     before)
                if not traced.get("fused_paged_attention"):
                    raise AssertionError(f"({mix}) bf16 {k}: the trace holds "
                                         "no run of paged_attention_exact")
                print(f"   ({mix}) bf16 {k}: the counted kernels' runs in the "
                      f"trace equal the wrappers' counts: {traced}; least "
                      f"launch skew {launch_skew_us(prof)!r} us; "
                      f"{lead_in_lost(prof)} without a device record",
                      flush=True)
                dev_ms = dev_us * 1e-3 / steps
                exact_us = sum(e.self_device_time_total for e in dev
                               if "paged_attention_exact" in e.key)
                print(f"   ({mix}) bf16 {k}: device {dev_ms!r} ms a step; "
                      f"busy share {dev_ms / step_ms!r} unprofiled, "
                      f"{dev_us * 1e-6 / wall!r} profiled; "
                      f"paged_attention_exact {exact_us / dev_us!r} of the "
                      "device time", flush=True)
                for e in sorted(dev, key=lambda e: -e.self_device_time_total
                                )[:6]:
                    print(f"     {e.key[:70]}: "
                          f"{e.self_device_time_total * 1e-3!r} ms device, "
                          f"{e.count} calls", flush=True)
            del runs, eager
    sm.phase("serving profile", serving_profile)

    def spec_profile():
        """A speculative step's time, calls and busy share beside the
        plain step's: mix (b) in f32 on the fused kernel, a non-spec and
        a spec server (prompt-lookup drafts, k = SPEC_K), each warmed by
        one run, timed unprofiled in the order plain, spec, spec, plain
        (tokens/s, ms a step), then run once under torch.profiler
        (host-issued launches a step, device ms a step, busy share; the
        counted kernels' runs in the trace equal the wrappers' counts)."""
        params, cfg = model(torch.float32)
        reqs, base = mixes["b"]
        kw = dict(base, paged=True, block_size=16, paged_kernel="fused")
        runs = {"plain": serving.ContinuousServer(params, cfg, **kw),
                "spec": serving.ContinuousServer(params, cfg, spec=True,
                                                 spec_k=SPEC_K, **kw)}
        ntok = sum(m for _, m in reqs)
        for srv in runs.values():
            serve_steps(srv, reqs)
        # the host's share of a spec step spent mining drafts
        drafts_s = []
        mine = runs["spec"]._prompt_drafts

        def timed_drafts(*a):
            t0 = time.perf_counter()
            out = mine(*a)
            drafts_s.append(time.perf_counter() - t0)
            return out
        runs["spec"]._prompt_drafts = timed_drafts
        tps, ms = {k: [] for k in runs}, {k: [] for k in runs}
        for k in ("plain", "spec", "spec", "plain"):
            steps, wall, _, _ = serve_steps(runs[k], reqs)
            tps[k].append(ntok / wall)
            ms[k].append(wall / steps * 1e3)
        for k, srv in runs.items():
            for attempt in range(TRACE_ATTEMPTS):
                before = {w.__name__: w.launches for w in programs._COUNTED}
                steps, wall, _, prof = serve_steps(srv, reqs, profiled=True)
                dev_us, calls, dev = device_events(prof)
                if dev_us <= 0 or not trace_short(
                        f"(b) f32 fused {k}", prof, dev, before, attempt):
                    break
            step_ms = statistics.mean(ms[k])
            print(f"   (b) f32 fused {k}: {tps[k]} tokens/s (runs), "
                  f"{step_ms!r} ms a step ({steps} steps a run, "
                  f"{ntok / steps!r} tokens a step); profiled: "
                  f"{sum(calls.values()) / steps!r} host-issued launches a "
                  f"step {calls}; on {smi}", flush=True)
            if dev_us <= 0:
                print(f"   (b) {k}: device busy share not measured (the "
                      "profiler recorded no device time)", flush=True)
                continue
            traced = traced_launches(f"(b) f32 fused {k}", prof, dev, before)
            dev_ms = dev_us * 1e-3 / steps
            print(f"   (b) f32 fused {k}: device {dev_ms!r} ms a step, busy "
                  f"share {dev_ms / step_ms!r} unprofiled, "
                  f"{dev_us * 1e-6 / wall!r} profiled; counted kernels in "
                  f"the trace {traced}; least launch skew "
                  f"{launch_skew_us(prof)!r} us; {lead_in_lost(prof)} "
                  "without a device record", flush=True)
        print(f"   (b) spec stats over these runs: "
              f"{runs['spec'].spec_stats()}; host ms a spec step mining "
              f"prompt-lookup drafts (n-gram, radix peek): median "
              f"{statistics.median(drafts_s) * 1e3!r}, mean "
              f"{statistics.mean(drafts_s) * 1e3!r} over {len(drafts_s)} "
              "steps", flush=True)
    sm.phase("speculative serving profile", spec_profile)

    def training_profile():
        """Where a training step's time goes, before and after the
        capture: the main path's bf16 SGD step eagerly (``step.eager``)
        and as graph replays, 3 steps each in the order eager, captured,
        captured, eager on the host clock (a synchronization after each
        step), then 3 more of each under torch.profiler. Device busy
        share = the device events' summed time over the wall time."""
        if not train:
            raise AssertionError("the training path did not run")
        step = train["step"]
        runs = {"eager": step.eager, "captured": step}
        params, toks, tgts = train["params"], train["toks"], train["tgts"]
        secs = {k: [] for k in runs}
        for k in ("eager", "captured", "captured", "eager"):
            for _ in range(3):
                torch.cuda.synchronize()
                t = HighResolutionTimer()
                params, _ = runs[k](params, toks, tgts)
                torch.cuda.synchronize()
                secs[k].append(t.elapsed())
        from torch.profiler import ProfilerActivity, profile
        for k, fn in runs.items():
            for attempt in range(TRACE_ATTEMPTS):
                before = {w.__name__: w.launches for w in programs._COUNTED}
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    torch.cuda.synchronize()
                    trace_lead_in()
                    t = HighResolutionTimer()
                    for _ in range(3):
                        params, _ = fn(params, toks, tgts)
                    torch.cuda.synchronize()
                    wall = t.elapsed()
                    time.sleep(TRACE_MARGIN_S)
                dev_us, calls, dev = device_events(prof)
                if dev_us <= 0 or not trace_short(
                        f"bf16 training {k}", prof, dev, before, attempt):
                    break
            step_ms = statistics.median(secs[k]) * 1e3
            print(f"   bf16 training {k}: {step_ms!r} ms a step (median of "
                  f"{[x * 1e3 for x in secs[k]]}); profiled "
                  f"{wall / 3 * 1e3!r} ms a step; "
                  f"{sum(calls.values()) / 3!r} host-issued launches a "
                  f"step {calls}; on {smi}", flush=True)
            if dev_us <= 0:
                print("   device busy share: not measured (the profiler "
                      "recorded no device time)", flush=True)
                continue
            traced = traced_launches(f"bf16 training {k}", prof, dev, before)
            want = {n: 3 * train["cfg"].n_layers for n in FLASH_KERNELS}
            if traced != want:
                raise AssertionError(f"bf16 training {k}: traced kernel runs "
                                     f"{traced}, want {want}")
            print(f"   bf16 training {k}: the counted kernels' runs in the "
                  f"trace of 3 steps equal the wrappers' counts: {traced}; "
                  f"least launch skew {launch_skew_us(prof)!r} us; "
                  f"{lead_in_lost(prof)} without a device record",
                  flush=True)
            per_step = dev_us * 1e-3 / 3
            print(f"   bf16 training {k}: device {per_step!r} ms a step; "
                  f"busy share {per_step / step_ms!r} unprofiled, "
                  f"{dev_us * 1e-6 / wall!r} profiled", flush=True)
            groups = {"flash kernels": 0.0, "matmuls": 0.0, "other": 0.0}
            for e in dev:
                key = ("flash kernels" if "flash_" in e.key else "matmuls"
                       if any(w in e.key for w in ("nvjet", "gemm",
                                                   "cutlass"))
                       else "other")
                groups[key] += e.self_device_time_total * 1e-3 / 3
            print(f"   device ms a step by group: {groups}", flush=True)
            for e in sorted(dev, key=lambda e: -e.self_device_time_total
                            )[:8]:
                print(f"     {e.key[:70]}: "
                      f"{e.self_device_time_total * 1e-3!r} ms device, "
                      f"{e.count} calls", flush=True)
        train["params"] = params
    sm.phase("training profile", training_profile)

    # -- 4. timing ----------------------------------------------------------------
    def algorithms_profile():
        """Where config #3's and the FFT's time goes:
        hpx_tpu_torch/tools/algo_profile.py's three profiles."""
        from hpx_tpu_torch.tools import algo_profile
        for line in algo_profile.run(smi):
            if not line["device_ms"] > 0:
                print(f"   {line['profile']}: the profiler recorded no "
                      "device time (busy share not measured)", flush=True)
    sm.phase("algorithms profile", algorithms_profile)

    timing = {}

    def time_kernels():
        coef = 0.3
        n = 1 << 28
        u = rand(n)
        ms = _cuda_ms(lambda: st.heat_step_blocked(u, coef), 7)
        plain = _cuda_ms(lambda: st.plain_heat_step_blocked(u, coef), 3)
        bound, by = _bound(8 * n, FLOPS_PER_CELL_STEP * n)
        timing["heat_step_blocked"] = dict(ms=ms, plain=plain, bound=bound,
                                           by=by, library=None,
                                           shape="n=2^28")
        del u
        torch.cuda.empty_cache()
        for n, steps in ((1 << 27, 64), (1 << 19, 1024)):
            u = rand(n)

            def call():
                st.multistep_fused(u, coef, steps)
            ms = _cuda_ms(call, 7)
            plain = _cuda_ms(lambda: st.plain_multistep(u, coef, steps), 3)
            bound, by = _bound(8 * n, FLOPS_PER_CELL_STEP * n * steps)
            plan = st.multistep_plan(n, steps, torch.cuda.get_device_properties(
                0).multi_processor_count)
            shape = (f"n=2^{n.bit_length() - 1} steps={steps}, plan "
                     f"k={plan.k} threads={plan.threads} blocks="
                     f"{plan.blocks} passes={plan.passes}")
            key = ("multistep_fused" if "multistep_fused" not in timing
                   else f"multistep_fused n=2^{n.bit_length() - 1}")
            timing[key] = dict(
                ms=ms, plain=plain, bound=bound, by=by, library=None,
                shape=shape, host=_host_ms(call),
                bound_instr=FP32_INSTR_PER_CELL_STEP * n * steps
                / FP32_INSTR_PER_S * 1e3)
            del u
            torch.cuda.empty_cache()
        time_fma()
        time_paged()
        time_flash()
        time_chunk()
        time_flash_f32()
        for k, t in timing.items():
            print(f"   timing {k} [{t['shape']}]: kernel_ms={t['ms']!r} "
                  f"plain_ms={t['plain']!r} bound_ms={t['bound']!r} "
                  f"({t['by']}) library_ms={t['library']!r} "
                  f"({t.get('library_by')}) "
                  + "".join(f"{x}_ms={t[x]!r} " for x in (
                      "events", "host", "bound_instr", "route",
                      "route_events", "bound_split", "bound_tf32x3",
                      "library_events",
                      "library_profiler", "library_autograd") if x in t)
                  + f"launches={sm.launches[k.split()[0]]} (f32 route "
                  f"{sm.f32_launches.get(k.split()[0], '-')}) on {smi}")

    def time_fma():
        """Kernel 9 at bench.py's shape (2^17 elements, 1024 iterations,
        c 0.9999999): bound by operations (8 FMA of 2 and 8 more a
        step), bytes the array read and written once."""
        n, steps = fr.N, fr.STEPS
        u = torch.rand(n, generator=gen, device="cuda")
        ms = _cuda_ms(lambda: fr.fma_chain(u, 0.9999999, steps), 7)
        plain = _cuda_ms(lambda: fr.plain_fma_chain(u, 0.9999999, steps), 3)
        bound, by = _bound(8 * n, fr.OPERATIONS_PER_STEP * n * steps)
        timing["fma_chain"] = dict(
            ms=ms, plain=plain, bound=bound, by=by, library=None,
            shape=f"n=2^17 steps={steps}")
        print(f"   kernel 9: {ms!r} ms = "
              f"{n * steps * fr.INSTRUCTIONS_PER_STEP / ms / 1e9!r} x 1e12 "
              f"FP32 instructions/s, {bound / ms * 100!r} % of its bound "
              f"({by}); on {smi}", flush=True)

    def time_paged():
        """Kernels 3 and 4 at the full-width decode shape (B 8, W 1, 8
        heads of 128, block 16, bf16 queries): S 1024 with bf16 and int8
        pools, S 8192 with bf16 pools; beside SDPA on K/V gathered
        beforehand, timed the same way. Each is timed in a CUDA graph
        (the wrapper's host work outlasts the kernel, so events around
        back-to-back calls would time the host; those are printed
        beside). Cold L2: the graph's calls take the copies of the pools
        (or of the gathered K/V) in turn, so many copies that the others'
        live K/V passing through between two calls on one copy is over
        100 MB (at least 4), as the server's call of a layer finds its
        pools after the other layers' pools and weights; warm: every call
        on one copy. The bound counts the live blocks these inputs need;
        the bound over every block of the table is printed beside it."""
        import torch.nn.functional as F
        b, nh, hd, bs = 8, 8, 128, 16
        for seq, pool_dt, w in ((1024, torch.bfloat16, 1),
                                (1024, torch.int8, 1),
                                (8192, torch.bfloat16, 1),
                                (1024, torch.bfloat16, 8),
                                (1024, torch.int8, 8)):
            maxb = seq // bs
            args = paged_state(b, maxb, bs, nh, 1, hd, w, pool_dt,
                               torch.bfloat16, seed=3)
            q, kp, vp, table, pos, ks, vs = args
            splits = splits_of(*args)
            nlive = int(((pos.long() + w - 1) // bs + 1).clamp(max=maxb)
                        .sum())

            def nbytes(keys, blocks):
                # the K and V rows of `keys` positions once, the scales and
                # table entries of `blocks` blocks, q, out and the positions
                return (2 * keys * nh * hd * kp.element_size()
                        + (2 * blocks * nh * 4 if ks is not None else 0)
                        + blocks * 4 + 2 * q.numel() * q.element_size()
                        + pos.numel() * 4)
            # the live rows: positions up to pos0 + W - 1 of each slot;
            # window row i attends pos0 + i + 1 of them
            live_keys = int((pos.long() + w).clamp(max=seq).sum())
            pairs = int(sum((pos.long() + i + 1).clamp(max=seq).sum()
                            for i in range(w)))
            bound, by = _bound(nbytes(live_keys, nlive),
                               4 * nh * pairs * hd, BF16_OPS_PER_S)
            bound_all, by_all = _bound(nbytes(b * seq, b * maxb),
                                       4 * b * nh * w * seq * hd,
                                       BF16_OPS_PER_S)
            n_copies = max(4, math.ceil(100e6 / nbytes(nlive * bs, nlive))
                           + 1)
            copies = [args] + [[q, kp.clone(), vp.clone(), table, pos,
                                None if ks is None else ks.clone(),
                                None if vs is None else vs.clone()]
                               for _ in range(n_copies - 1)]
            # the yardstick: one library call on K/V gathered beforehand,
            # window row i masked to positions <= pos0 + i
            live = (torch.arange(seq, device="cuda")[None, None, :]
                    <= (pos.long()[:, None] + torch.arange(
                        w, device="cuda"))[:, :, None])[:, None]
            qs = q.transpose(1, 2)
            kc = pa.gather_block_kv(kp, table, ks, q.dtype).transpose(1, 2)
            vc = pa.gather_block_kv(vp, table, vs, q.dtype).transpose(1, 2)
            n_lib = max(4, math.ceil(100e6 / (2 * kc.numel() * 2)) + 1)
            gathered = [(kc, vc)] + [(kc.clone(), vc.clone())
                                     for _ in range(n_lib - 1)]

            def sdpa(kc, vc):
                return lambda: F.scaled_dot_product_attention(
                    qs, kc, vc, attn_mask=live)
            n_calls = 4 * max(n_copies, n_lib)
            library = _graph_ms([sdpa(*gathered[i % n_lib])
                                 for i in range(n_calls)])
            library_warm = _graph_ms([sdpa(kc, vc)] * n_calls)
            dt = str(pool_dt).split(".")[-1]
            print(f"   paged timing W={w} S={seq} {dt} pools: P={splits}, "
                  f"{nlive} "
                  f"of {b * maxb} blocks live, {live_keys} of {b * seq} "
                  f"rows; cold over {n_copies} copies "
                  f"of the pools ({n_lib} of the gathered K/V for SDPA); "
                  f"bound over live blocks {bound!r} ms ({by}), over every "
                  f"block {bound_all!r} ms ({by_all}); SDPA cold "
                  f"{library!r} ms, warm {library_warm!r} ms (CUDA graph) "
                  f"on {smi}", flush=True)
            for k, (fn, plain) in paged.items():
                t0 = time.perf_counter()
                for _ in range(50):
                    fn(*args)
                host = (time.perf_counter() - t0) / 50 * 1e3
                torch.cuda.synchronize()
                it = itertools.cycle(copies)
                t = {"ms": _graph_ms([functools.partial(fn, *copies[
                         i % n_copies]) for i in range(n_calls)]),
                     "warm": _graph_ms([functools.partial(fn, *args)]
                                       * n_calls),
                     "events": _cuda_ms(lambda: fn(*next(it)), 7),
                     "host": host,
                     "plain": _cuda_ms(lambda: plain(*args), 3),
                     "bound": bound, "by": by, "bound_all": bound_all,
                     "library": library, "library_by": "CUDA graph",
                     "library_warm": library_warm, "splits": splits,
                     "shape": f"B={b} W={w} nq=nkv={nh} hd={hd} bs={bs} "
                              f"S={seq} {dt} pools, bf16 q, P={splits}, "
                              "cold L2, CUDA graph"}
                print(f"   {k} W={w} S={seq} {dt}: cold {t['ms']!r} ms, warm "
                      f"{t['warm']!r} ms (CUDA graph); CUDA events around "
                      f"back-to-back cold calls {t['events']!r} ms; host "
                      f"enqueue {host!r} ms a call; "
                      f"{bound / t['ms'] * 100!r} % of the live-block "
                      f"bound, P={splits}", flush=True)
                key = (k if (seq, pool_dt, w) == (1024, torch.bfloat16, 1)
                       else f"{k} {dt}" if (seq, w) == (1024, 1)
                       else f"{k} S={seq}" if w == 1 else f"{k} W={w} {dt}")
                timing[key] = t
            if (seq, pool_dt, w) == (1024, torch.bfloat16, 1):
                paged_breakdown(args)
            del args, copies, gathered, kc, vc
            torch.cuda.empty_cache()

    def paged_breakdown(args):
        """What a decode call's time is made of: the same call with every
        slot at position 0 (one live block a slot: launch, prologue,
        cluster exchanges and merge, almost no walk), and the call with P
        forced to 1, 2, 4 and 8 (warm L2, CUDA graph)."""
        q, kp, vp, table, pos, ks, vs = args
        one = [q, kp, vp, table, torch.zeros_like(pos), ks, vs]
        splits = ac.paged_splits
        try:
            for k, (fn, _) in paged.items():
                fixed = _graph_ms([functools.partial(fn, *one)] * 32)
                by_p = {}
                for p in (1, 2, 4, 8):
                    ac.paged_splits = lambda *a, p=p: p
                    by_p[p] = _graph_ms([functools.partial(fn, *args)] * 32)
                ac.paged_splits = splits
                print(f"   {k} at the decode shape (CUDA graph): every slot "
                      f"at position 0 {fixed!r} ms; by P (warm) {by_p}",
                      flush=True)
        finally:
            ac.paged_splits = splits

    def time_flash():
        """Kernels 5-7 in bf16, causal, at the training shape and at
        bench.py:448's, beside SDPA's forward and its flash backward by
        the same method (a CUDA graph); then the backward at the ring's
        shape."""
        import types
        import torch.nn.functional as F
        aten = torch.ops.aten
        bf = FLASH_TOL["bf16"]
        for b, seq, n, h in ((8, 1024, 8, 64), (2, 4096, 8, 128)):
            q, k, v, do = flash_state(b, seq, seq, n, n, h, torch.bfloat16,
                                      seed=11)
            o, lse = ac.flash_attention_fwd(q, k, v, True)
            # the timed inputs held against the plain version, as the
            # checks hold theirs (at S 4096 x 128: 128-row CTAs)
            po, plse = plain_fwd(q, k, v, True)
            what = (f"timed inputs B {b} S {seq} {n} x {h} bf16 causal, "
                    f"block_m {ac.flash_fwd_plan(h, b * n, seq)[0]}")
            err = sm.expect_close("flash_attention_fwd", o, po, f"o {what}",
                                  quiet=True, tol=bf, norm=True)
            sm.expect_close("flash_attention_fwd", lse, plse, f"L {what}",
                            quiet=True, tol=FLASH_TOL["fwd"])
            o_norm = _norm_rel(o, po)
            del po, plse
            delta = ac.bwd_prep(do, o)
            args = (q, k, v, do, delta, lse, 0, True)
            errs = [sm.expect_close("flash_attention_bwd", g, wt,
                                    f"{name} {what}", quiet=True, tol=bf,
                                    norm=True)
                    for name, g, wt in zip(
                        ("dq", "dk", "dv"), ac.flash_attention_bwd(*args),
                        ac.plain_flash_bwd(*args))]
            print(f"   {what}: o max abs err {err!r}, by the norm "
                  f"{o_norm!r}; L within "
                  f"{FLASH_TOL['fwd']}; dq, dk, dv max abs err {errs}",
                  flush=True)
            # operations over the visible (query, key) pairs, 2 per
            # multiply-add: 2 products forward; the backward's five (S, dP,
            # dV, dK, dQ) once each. Bytes: each input read once, each
            # output written once (the backward's dq, dk, dv in f32)
            pairs = b * n * seq * (seq + 1) // 2
            el, rows = q.numel(), b * n * seq
            bounds = {
                "flash_attention_fwd": _bound(3 * el * 2 + el * 2 + rows * 4,
                                              4 * pairs * h, BF16_OPS_PER_S),
                "flash_attention_bwd": _bound(
                    4 * el * 2 + 2 * rows * 4 + 3 * el * 4, 10 * pairs * h,
                    BF16_OPS_PER_S)}
            # the split kernels' bounds (S and dP in each: 14 operations a
            # pair), for the parent's kernels 6 + 7
            split = sum(_bound(5 * el * 2 + 2 * rows * 4 + x * el * 4,
                               y * pairs * h, BF16_OPS_PER_S)[0]
                        for x, y in ((1, 6), (2, 8)))
            q4, k4, v4, do4 = (x.view(b, n, seq, h) for x in (q, k, v, do))

            def sdpa_fwd():
                F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)
            # SDPA's flash backward on the saved outputs of its forward:
            # one graph-capturable call, delta included
            fo = aten._scaled_dot_product_flash_attention(q4, k4, v4, 0.0,
                                                          True)

            def sdpa_bwd():
                aten._scaled_dot_product_flash_attention_backward(
                    do4, q4, k4, v4, fo[0], fo[1], fo[2], fo[3], fo[4],
                    fo[5], 0.0, True, fo[6], fo[7])
            xs = [x.clone().requires_grad_() for x in (q4, k4, v4)]

            def sdpa_fwd_bwd():
                out = F.scaled_dot_product_attention(*xs, is_causal=True)
                torch.autograd.grad(out, xs, do4)
            lib_fwd, by_fwd = _device_ms(sdpa_fwd, 7)
            lib_graph = _graph_ms([sdpa_fwd] * 20)
            lib_bwd_graph = _graph_ms([sdpa_bwd] * 20)
            lib_both, by_both = _device_ms(sdpa_fwd_bwd, 7)
            lib_bwd = lib_both - lib_fwd
            by_bwd = by_fwd if by_fwd == by_both else "profiler - events"
            events = (_cuda_ms(sdpa_fwd, 7), _cuda_ms(sdpa_fwd_bwd, 7),
                      _cuda_ms(sdpa_bwd, 7))
            # what F.scaled_dot_product_attention's autograd runs: its
            # backend, and its backward by the graph (forward + backward
            # less forward)
            try:
                from torch.nn.attention import SDPBackend
                backend = SDPBackend(torch._fused_sdp_choice(
                    q4, k4, v4, is_causal=True)).name
            except Exception as e:  # noqa: BLE001 - a reading, not a check
                backend = f"not read ({type(e).__name__})"
            try:
                auto_bwd = _graph_ms([sdpa_fwd_bwd] * 20) - lib_graph
            except Exception as e:  # noqa: BLE001 - a reading, not a check
                auto_bwd = f"not measured ({type(e).__name__}: {e})"[:200]
            # the whole bf16 route of _FlashAttention.backward: the layout
            # copies, delta, the dq fill, the kernel, the casts
            pub = [ac._public_layout(x, b) for x in (q, k, v, do)]
            ctx = types.SimpleNamespace(saved_tensors=(*pub[:3], o, lse),
                                        causal=True)

            def route():
                ac._FlashAttention.backward(ctx, pub[3])
            runs = {"flash_attention_fwd": (
                        lambda: ac.flash_attention_fwd(q, k, v, True),
                        lambda: plain_fwd(q, k, v, True)),
                    "flash_attention_bwd": (
                        lambda: ac.flash_attention_bwd(*args),
                        lambda: ac.plain_flash_bwd(*args))}
            shape = f"B={b} S={seq} N={n} H={h} bf16 causal"
            for kname, (fn, plain) in runs.items():
                bound, by = bounds[kname]
                # the kernel's device time: a CUDA graph of 20 calls (the
                # wrapper's host work, a plan and tensor maps a call,
                # stays out), SDPA's by the same method; beside them
                # events around back-to-back calls and the wrapper's host
                # time a call
                t = {"ms": _graph_ms([fn] * 20), "events": _cuda_ms(fn, 7),
                     "host": _host_ms(fn), "plain": _cuda_ms(plain, 3),
                     "bound": bound, "by": by, "library_by": "graph",
                     "shape": shape}
                if kname == "flash_attention_fwd":
                    t.update(library=lib_graph, library_events=events[0],
                             library_profiler=lib_fwd)
                else:
                    t.update(library=lib_bwd_graph, library_events=events[2],
                             library_profiler=lib_bwd,
                             route=_graph_ms([route] * 20),
                             library_autograd=auto_bwd,
                             route_events=_cuda_ms(route, 7),
                             bound_split=split)
                timing[kname if seq == 1024 else f"{kname} S={seq}"] = t
                torch.cuda.empty_cache()
            bt = timing["flash_attention_bwd" if seq == 1024 else
                        f"flash_attention_bwd S={seq}"]
            print(f"   SDPA at {shape}: forward {lib_graph!r} ms (graph; "
                  f"{by_fwd} {lib_fwd!r}, events {events[0]!r}); flash "
                  f"backward {lib_bwd_graph!r} ms (graph, one aten call with "
                  f"delta; events {events[2]!r}; {by_bwd} forward + backward "
                  f"less forward {lib_bwd!r}; events of forward + backward "
                  f"{events[1]!r}); F.scaled_dot_product_attention's backend "
                  f"{backend}, its autograd backward in a graph (forward + "
                  f"backward less forward) {auto_bwd!r} ms. Kernels 6-7 "
                  f"(one launch) {bt['ms']!r} ms "
                  f"(graph), the whole route of _FlashAttention.backward "
                  f"{bt['route']!r} ms (graph), {bt['route'] / lib_bwd_graph!r}"
                  f" of SDPA's; the bound {bt['bound']!r} ms ({bt['by']}; the "
                  f"split kernels' {split!r} ms); on {smi}", flush=True)
            del q, k, v, do, o, lse, delta, args, xs, q4, k4, v4, do4, fo
            del pub, ctx
            torch.cuda.empty_cache()
        # the ring's backward step: each rank's q [32, 512, 64] against one
        # chunk of 512 keys, causal, d = 0 (its own chunk) and 512 (a past
        # chunk, all visible), each with its own forward's L
        q, k, v, do = flash_state(8, 512, 512, 4, 4, 64, torch.bfloat16,
                                  seed=13)
        bn, sq, h = q.shape
        el = q.numel()
        for d in (0, 512):
            o, lse = ac.flash_attention_fwd(q, k, v, d == 0)
            args = (q, k, v, do, ac.bwd_prep(do, o), lse, d, True)
            for name, g, wt in zip(("dq", "dk", "dv"),
                                   ac.flash_attention_bwd(*args),
                                   ac.plain_flash_bwd(*args)):
                sm.expect_close("flash_attention_bwd", g, wt,
                                f"{name} ring shape d {d}", quiet=True,
                                tol=bf, norm=True)
            pairs = bn * sum(min(512, i + d + 1) for i in range(sq))
            bound, by = _bound(4 * el * 2 + 2 * bn * sq * 4 + 3 * el * 4,
                               10 * pairs * h, BF16_OPS_PER_S)
            q4, k4, v4, do4 = (x.view(8, 4, sq, h) for x in (q, k, v, do))
            fo = aten._scaled_dot_product_flash_attention(q4, k4, v4, 0.0,
                                                          d == 0)

            def sdpa_bwd():
                aten._scaled_dot_product_flash_attention_backward(
                    do4, q4, k4, v4, fo[0], fo[1], fo[2], fo[3], fo[4],
                    fo[5], 0.0, d == 0, fo[6], fo[7])

            def call():
                ac.flash_attention_bwd(*args)
            timing[f"flash_attention_bwd ring d={d}"] = {
                "ms": _graph_ms([call] * 20), "events": _cuda_ms(call, 7),
                "host": _host_ms(call),
                "plain": _cuda_ms(lambda: ac.plain_flash_bwd(*args), 3),
                "bound": bound, "by": by, "library": _graph_ms([sdpa_bwd] * 20),
                "library_by": "graph",
                "shape": f"q [{bn}, {sq}, {h}] bf16, causal, d={d}"}

    def time_chunk():
        """Kernel 8 at the ring path's shape (each rank's q [32, 512, 64]
        bf16 against one chunk of its kv, causal), d = 0 (its own chunk)
        and d = 512 (a past chunk, all visible), from a real carry."""
        q, k, v, carry = chunk_state(512, 512, 16, 16, 64, torch.bfloat16,
                                     seed=13)
        bn, sq, h = q.shape
        # bytes: q, k, v read once; acc, m, l read and written once
        nbytes = 3 * q.numel() * 2 + 2 * sum(x.numel() * 4 for x in carry)
        for d in (0, 512):
            pairs = bn * sum(min(512, i + d + 1) for i in range(sq))
            bound, by = _bound(nbytes, 4 * pairs * h, BF16_OPS_PER_S)
            work = tuple(x.clone() for x in carry)

            def call():
                ac.flash_attention_chunk(q, k, v, *work, d, True)
            # device time in a CUDA graph of 20 calls, events beside it
            t = {"ms": _graph_ms([call] * 20), "events": _cuda_ms(call, 7),
                 "host": _host_ms(call),
                 "plain": _cuda_ms(lambda: plain_chunk(
                     q, k, v, *carry, d, True), 3),
                 "bound": bound, "by": by, "library": None,
                 "library_by": None,
                 "shape": f"q [{bn}, {sq}, {h}] bf16, causal, d={d}"}
            timing["flash_attention_chunk" if d == 0
                   else f"flash_attention_chunk d={d}"] = t
    def time_flash_f32():
        """The f32 routes of kernels 5-8 at the training shape (B 8, S
        1024, 8 heads of 64) and at the ring's (q [32, 512, 64], d = 0),
        causal, their inputs first held against the plain versions:
        flash_fwd_tf32x3 (the forward, and its chunk fold from a zero
        carry) and the backward's one kernel, flash_bwd_tf32x3, all
        3xTF32 on the tensor cores; the backward alone and as the whole
        f32 route of _FlashAttention.backward (layout copies, delta, the
        dq fill, the kernel, the casts). Device time by the CUDA graph
        of 20 calls the bf16 rows use, events and the plain version
        beside; the bound at 67 TFLOP/s FP32 and at 495 TFLOP/s TF32
        (the forward's and the fold's 4 operations a pair and head
        element 12 as 3xTF32, the backward's 10 30); SDPA in f32 by the
        same graph (its forward; its backward as forward + backward less
        forward, with the kernels the profiler names; none for the
        chunk)."""
        import types
        import torch.nn.functional as F
        from torch.profiler import ProfilerActivity, profile
        for tag, (b, seq, n, h) in (("", (8, 1024, 8, 64)),
                                    (" ring", (8, 512, 4, 64))):
            q, k, v, do = flash_state(b, seq, seq, n, n, h, torch.float32,
                                      seed=17)
            o, lse = ac.flash_attention_fwd(q, k, v, True)
            po, plse = plain_fwd(q, k, v, True)
            sm.expect_close("flash_attention_fwd", o, po, f"f32 o{tag}",
                            quiet=True, tol=FLASH_TOL["fwd"])
            sm.expect_close("flash_attention_fwd", lse, plse, f"f32 L{tag}",
                            quiet=True, tol=FLASH_TOL["fwd"])
            args = (q, k, v, do, ac.bwd_prep(do, o), lse, 0, True)
            for name, g, w in zip(("dq", "dk", "dv"),
                                  ac.flash_attention_bwd_f32(*args),
                                  ac.plain_flash_bwd(*args)):
                sm.expect_close(FLASH_F32_BWD[0], g, w, f"f32 {name}{tag}",
                                quiet=True, tol=FLASH_TOL["bwd"])
            carry = (torch.zeros_like(q),
                     torch.full(q.shape[:2], -1e30, device="cuda"),
                     torch.zeros(q.shape[:2], device="cuda"))
            work = tuple(x.clone() for x in carry)
            for g, w in zip(ac.flash_attention_chunk(q, k, v, *work, 0, True),
                            plain_chunk(q, k, v, *carry, 0, True)):
                sm.expect_close("flash_attention_chunk", g, w,
                                f"f32 chunk{tag}", quiet=True,
                                tol=FLASH_TOL["fwd"])
            pairs = b * n * seq * (seq + 1) // 2
            el, rows = q.numel(), b * n * seq
            # each input read once, each output written once, all f32;
            # operations over the visible pairs, 2 a multiply-add: the
            # forward's 2 products, the backward's 5 (3 TF32 products
            # each as 3xTF32)
            bwd_bytes = 7 * el * 4 + 2 * rows * 4
            bounds = {
                "flash_attention_fwd": _bound(4 * el * 4 + rows * 4,
                                              4 * pairs * h),
                FLASH_F32_BWD[0]: _bound(bwd_bytes, 10 * pairs * h),
                "flash_attention_chunk": _bound(
                    3 * el * 4 + 2 * (el * 4 + 2 * rows * 4),
                    4 * pairs * h)}
            tf32x3 = _bound(bwd_bytes, 30 * pairs * h, TF32_OPS_PER_S)
            # the forward and the chunk fold as 3xTF32: 12 TF32 operations
            # a visible pair and head element (two products, three terms)
            tf32x3_fwd = {
                "flash_attention_fwd": _bound(4 * el * 4 + rows * 4,
                                              12 * pairs * h, TF32_OPS_PER_S),
                "flash_attention_chunk": _bound(
                    3 * el * 4 + 2 * (el * 4 + 2 * rows * 4), 12 * pairs * h,
                    TF32_OPS_PER_S)}
            q4, k4, v4, do4 = (x.view(b, n, seq, h) for x in (q, k, v, do))

            def sdpa_fwd():
                F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)
            xs = [x.clone().requires_grad_() for x in (q4, k4, v4)]

            def sdpa_fwd_bwd():
                out = F.scaled_dot_product_attention(*xs, is_causal=True)
                torch.autograd.grad(out, xs, do4)
            lib_fwd = _graph_ms([sdpa_fwd] * 20)
            try:
                lib_bwd = _graph_ms([sdpa_fwd_bwd] * 20) - lib_fwd
                lib_bwd_by = "graph"
            except Exception as e:  # noqa: BLE001 - a reading, not a check
                print(f"   SDPA f32 backward in a graph: {type(e).__name__}"
                      f": {e}; CUDA events instead", flush=True)
                lib_bwd = _cuda_ms(sdpa_fwd_bwd, 7) - _cuda_ms(sdpa_fwd, 7)
                lib_bwd_by = "events"
            # which library kernels the yardstick runs (a reading)
            sdpa_fwd_bwd()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                sdpa_fwd_bwd()
                torch.cuda.synchronize()
            lib_kernels = sorted({e.key[:120] for e in prof.key_averages()
                                  if "fmha" in e.key or "attention" in
                                  e.key.lower()})
            # and every kernel of its forward alone (a reading)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                sdpa_fwd()
                torch.cuda.synchronize()
            fwd_kernels = sorted({e.key[:120] for e in prof.key_averages()
                                  if e.self_device_time_total > 0})
            work = tuple(x.clone() for x in carry)
            # the whole f32 route of _FlashAttention.backward
            pub = [ac._public_layout(x, b) for x in (q, k, v, do)]
            ctx = types.SimpleNamespace(saved_tensors=(*pub[:3], o, lse),
                                        causal=True)

            def route():
                ac._FlashAttention.backward(ctx, pub[3])
            runs = {
                "flash_attention_fwd": (
                    lambda: ac.flash_attention_fwd(q, k, v, True),
                    lambda: plain_fwd(q, k, v, True), lib_fwd),
                FLASH_F32_BWD[0]: (
                    lambda: ac.flash_attention_bwd_f32(*args),
                    lambda: ac.plain_flash_bwd(*args), lib_bwd),
                "flash_attention_chunk": (
                    lambda: ac.flash_attention_chunk(q, k, v, *work, 0,
                                                     True),
                    lambda: plain_chunk(q, k, v, *carry, 0, True), None)}
            shape = (f"B={b} S={seq} N={n} H={h} f32 causal" if not tag
                     else f"q [{b * n}, {seq}, {h}] f32, causal, d=0")
            for kname, (fn, plain, lib) in runs.items():
                bound, by = bounds[kname]
                timing[f"{kname} f32{tag}"] = {
                    "ms": _graph_ms([fn] * 20), "events": _cuda_ms(fn, 7),
                    "plain": _cuda_ms(plain, 3), "bound": bound, "by": by,
                    "library": lib,
                    "library_by": (lib_bwd_by if kname == FLASH_F32_BWD[0]
                                   else "graph") if lib else None,
                    "shape": shape}
                if kname in tf32x3_fwd:
                    timing[f"{kname} f32{tag}"]["bound_tf32x3"] = \
                        tf32x3_fwd[kname][0]
            bt = timing[f"{FLASH_F32_BWD[0]} f32{tag}"]
            ft = timing[f"flash_attention_fwd f32{tag}"]
            ct = timing[f"flash_attention_chunk f32{tag}"]
            bt.update(route=_graph_ms([route] * 20),
                      bound_tf32x3=tf32x3[0])
            print(f"   f32 at {shape}: forward flash_fwd_tf32x3 "
                  f"{ft['ms']!r} ms (SDPA {lib_fwd!r}, its kernels "
                  f"{fwd_kernels}: {ft['ms'] / lib_fwd!r} of it; bound FP32 "
                  f"{ft['bound']!r} ms, {ft['bound'] / ft['ms']!r} of it, "
                  f"3xTF32 {ft['bound_tf32x3']!r} ms, "
                  f"{ft['bound_tf32x3'] / ft['ms']!r}); backward "
                  f"flash_bwd_tf32x3 "
                  f"{bt['ms']!r} ms, the whole f32 route of "
                  f"_FlashAttention.backward {bt['route']!r} ms (SDPA "
                  f"{lib_bwd!r}, {lib_bwd_by}: {bt['ms'] / lib_bwd!r} of "
                  f"it; its kernels {lib_kernels}); bound FP32 "
                  f"{bt['bound']!r} ms ({bt['by']}, "
                  f"{bt['bound'] / bt['ms']!r} of it), 3xTF32 "
                  f"{tf32x3[0]!r} ms ({tf32x3[1]}, "
                  f"{tf32x3[0] / bt['ms']!r}); chunk fold "
                  f"{ct['ms']!r} ms (3xTF32 bound {ct['bound_tf32x3']!r} "
                  f"ms, {ct['bound_tf32x3'] / ct['ms']!r} of it; CUDA "
                  f"graph); on {smi}", flush=True)
            del q, k, v, do, o, lse, args, carry, work, xs, pub, ctx
            torch.cuda.empty_cache()
        # the yardstick's f32 products: PyTorch's memory-efficient kernel
        # declares its float GEMMs on sm80+ as OpMultiplyAddFastF32
        # (3xTF32); read from the installed headers where they ship
        hdr = os.path.join(os.path.dirname(torch.__file__), "include", "ATen",
                           "native", "transformers", "cuda",
                           "mem_eff_attention", "gemm_kernel_utils.h")
        fast = False
        if os.path.isfile(hdr):
            with open(hdr) as f:
                fast = "OpMultiplyAddFastF32" in f.read()
        print(f"   SDPA f32 yardstick: the installed {hdr} names "
              f"OpMultiplyAddFastF32 (3xTF32): {fast}", flush=True)

    sm.phase("timing", time_kernels)

    if sm.failures:
        print(f"chip_smoke: FAILED phases: {sm.failures}", flush=True)
        return 1

    # the kernels line: one row a TPU kernel; the bf16 backward's one
    # kernel stands in the rows of kernels 6 and 7
    replaces = {"heat_step_blocked": "hpx_tpu/ops/stencil.py:110",
                "multistep_fused": "hpx_tpu/ops/stencil.py:44",
                **PAGED_KERNELS,
                "flash_attention_fwd": FLASH_KERNELS["flash_attention_fwd"][0],
                **dict(zip(BWD_ROWS, FLASH_KERNELS["flash_attention_bwd"])),
                **CHUNK_KERNEL, **FMA_KERNEL}
    wrapper = {r: "flash_attention_bwd" for r in BWD_ROWS}
    sources = {"heat_step_blocked": "stencil", "multistep_fused": "stencil",
               "fma_chain": "fma_rate",
               **{k: "paged_attention" for k in PAGED_KERNELS},
               **{k: "flash_attention" for k in ("flash_attention_fwd",
                                                 *BWD_ROWS, *CHUNK_KERNEL)}}
    # the kernel of a flash row's f32 route
    f32_kernel = {"flash_attention_fwd": "flash_fwd_tf32x3 (3xTF32 on the "
                                         "tensor cores)",
                  **{r: "flash_bwd_tf32x3 (dq, dk, dv in one launch, "
                        "3xTF32 on the tensor cores)" for r in BWD_ROWS},
                  "flash_attention_chunk": "flash_fwd_tf32x3<H, kChunk=1> "
                                           "(3xTF32 on the tensor cores)"}

    def f32_routes(row):
        """The f32 route of a flash row: its wrapper's kernel, launches
        on the f32 main paths (the f32 training gate, the ring's f32
        gates), error and times at the training and the ring's shape
        (time_flash_f32)."""
        out = {}
        k = F32_ROUTE[row]
        for tag in ("", " ring"):
            t = timing[f"{k} f32{tag}"]
            out[tag.strip() or "training"] = {
                "wrapper": k, "kernel": f32_kernel[row],
                "launches": sm.f32_launches.get(k, sm.launches[k]),
                "max_abs_err": sm.max_abs_err[k], "ms": t["ms"],
                **({"margin": sm.margin[f"{k} f32"]}
                   if f"{k} f32" in sm.margin else {}),
                **{f"{x}_ms": t[x] for x in ("events", "plain", "bound",
                                             "bound_tf32x3", "library",
                                             "route") if x in t},
                "bound_by": t["by"], "library_by": t["library_by"],
                "shape": t["shape"]}
        return out
    rows = []
    for row, at in replaces.items():
        k = wrapper.get(row, row)
        t = timing[k]
        rows.append({"name": row, "route": "cuda",
                     "source": f"hpx_tpu_torch/csrc/{sources[row]}.cu",
                     "replaces": at, "launches": sm.launches[k],
                     "max_abs_err": sm.max_abs_err[k], "ms": t["ms"],
                     "plain_ms": t["plain"], "bound_ms": t["bound"],
                     "bound_by": t["by"], "library_ms": t["library"],
                     "library_by": t.get("library_by"),
                     **({"kernel": "flash_bwd_wgmma (dq, dk, dv in one "
                                   "launch)"} if k != row else {}),
                     **{f"{x}_ms": t[x] for x in (
                         "warm", "events", "host", "bound_instr",
                         "bound_all", "route",
                         "route_events", "bound_split", "library_autograd",
                         "library_warm",
                         "library_events", "library_profiler") if x in t},
                     **({"splits": t["splits"]} if "splits" in t else {}),
                     **({"verify_window": {
                         dt: {"ms": timing[f"{k} W=8 {dt}"]["ms"],
                              "bound_ms": timing[f"{k} W=8 {dt}"]["bound"],
                              "bound_by": timing[f"{k} W=8 {dt}"]["by"],
                              "library_ms":
                                  timing[f"{k} W=8 {dt}"]["library"],
                              "shape": timing[f"{k} W=8 {dt}"]["shape"]}
                         for dt in ("bfloat16", "int8")},
                         "verify_launches": spec_launches[k],
                         "sharded_launches": sharded_launches[k]}
                        if k in PAGED_KERNELS else {}),
                     **({"f32": f32_routes(row)} if row in F32_ROUTE
                        else {}),
                     **({"pipeline_launches": pp_launches[k]}
                        if k in pp_launches and pp_launches[k] else {}),
                     "shape": t["shape"]})
    print(f"training step (bf16, B 8 x S 1024, full width): "
          f"{train['step_ms']!r} ms = {train['tokens_per_s']!r} tokens/s; "
          f"sharded step (4 ranks on make_mesh_3d(4), same model and "
          f"batch, host clock; {ring['what']}): {ring['step_ms']!r} "
          f"ms; card: {smi}")
    for line in bench_lines:
        print(f"bench: {json.dumps(line)}")
    print(f"config #3: {json.dumps(config3)}")
    print("resilience: " + json.dumps(
        {f"({m}) {k}": v for (m, k), v in resilience.items()}))
    print("moe: " + json.dumps({**moe, "card": smi}))
    print("multirank: " + json.dumps({**multi, "card": smi}))
    print("sharded: " + json.dumps(sharded))
    print("phase seconds: " + json.dumps(sm.seconds))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
