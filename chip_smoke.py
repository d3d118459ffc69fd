#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py [--phases 8,9,18,19]

Needs one CUDA card, ``nvcc`` and the repository checkout (the kernels are
built from ``classifying_vae_lstm_tpu_torch/csrc`` into
``build/torch_kernels/``). Imports nothing of JAX. Phases, each fatal on
failure:

1. the card's name and power limit; build every kernel source (one nvcc per
   source, started together), timed, with the compiler's register report;
   ``cuobjdump -sass`` of the built ``csrc/lstm_seq_tc.cu``: every
   instance of its product kernels holds tensor-core (HMMA) instructions;
   of ``csrc/two_cell_tc.cu``: its bf16 product kernels (walk, dx, dW) do
   and its f32 kernels hold none (FFMA only); of ``csrc/vae_dense_tc.cu``:
   its product kernels (the row chain's and the weight gradients') do; of
   ``csrc/lstm_bwd_f32.cu``: none (FFMA only); of ``csrc/two_cell.cu`` (the
   two-cell forward): its bf16 kernels do, its f32 kernels none; of
   ``csrc/generate_cl_vrnn.cu``: ``generate_kernel``'s bf16 instance does,
   its f32 instance none, and ``generate_int8_kernel`` holds int8
   tensor-core (IMMA) instructions and no ``__dp4a`` (IDP), as does the
   int8 instance of ``csrc/generate_cl_vae.cu``'s
   ``generate_vae_coop_kernel``, whose bf16 instance holds HMMA and whose
   f32 instance none; its ``generate_cluster_kernel``'s four instances
   (f32 and bf16) none, TF32 included; ``csrc/lstm_seq.cu`` (the f32
   forward): none;
2. kernel vs plain version, f32, on the trained ``artifacts/jsball_vrnn4``
   weights at the largest serving bucket (64 songs, 32 seed + 256 steps):
   probabilities with u=1 within 1e-5, and sampled frames equal up to each
   song's first near-tie (|u - p| < 1e-4 in the plain run), a second call
   bitwise equal; kernel and plain times with CUDA events, the profiler's
   device time, the grid and weight residency, the serving-bucket grid;
3. kernel vs plain version, bf16 weights, at hidden 512 (seeded glorot-scale
   weights): probabilities with u=1, max within 2e-2, mean within 2e-3, a
   second call bitwise equal; CUDA-event and device time beside the bound
   at the bf16 rate, and the serving-bucket grid in bf16;
4. the serving path: the port's ``cli.serve`` server with
   ``--dynamic_batching --warmup full`` answers /generate requests (a burst
   among them) over HTTP; the launch counts are set to 0 just before and read
   just after, and the plain version must not run on a CUDA tensor;
5. the two-cell training kernels vs their plain versions at the full
   training shape (B=200, T=16, H=256, L=8, K=13, use_x_prev; the
   ``jsball_vrnn4`` weights with seeded rows for 13 keys): forward hd and
   zargs within 1e-5, every backward output within 1e-4 * max|plain| + 1e-6,
   a second forward and backward call bitwise equal; kernel and plain times
   with CUDA events beside each kernel's bound, the forward's device time
   split between the operands' layouts and the walk, the backward's
   between the walk (of which the z hand-off), dx and the weight gradients,
   and the HMMA count of each f32 backward kernel (0);
6. the training path: the port's ``cli.cl_vrnn_train`` trains 3 epochs on
   the committed corpus at the jsball_vrnn4 width through
   ``--lstm_backend pallas``; the two-cell counts are set to 0 just before and
   read just after and must equal the run's own steps (one forward launch per
   train and eval batch, two backward launches per train batch), losses must
   be finite and fall, and the plain versions must not run on CUDA tensors;
   then a training step's time split (forward, backward, optimizer; a
   profiler's per-kernel device time where it records one);
7. the checkpoint that run wrote loads into the port's ``GenerationEngine``
   and generates songs through the generation kernel;
8. the whole-sequence LSTM kernels (inference forward, training forward,
   backward) vs their plain versions: all three at the training shape
   (B=200, T=16, H=256, the ``jsball_vrnn4`` encoder and decoder weights with
   seeded rows for 13 keys), the inference forward at the evaluation shape
   (64 importance samples x 200 windows = 12,800 rows, the trained weights);
   forward outputs within 1e-5, backward outputs within 1e-4 * max|plain| +
   1e-6, a second call of each bitwise equal, each forward counted once a
   call and its layout printed (``lstm_seq.fwd_plan``); kernel and plain
   times with
   CUDA events beside each kernel's bound, and the backward's device time
   split between the walk, dx and the weight gradients (the f32 full
   backward is ``csrc/lstm_bwd_f32.cu``: 0 HMMA);
9. the ``--two_cell off`` training path: ``cli.cl_vrnn_train --lstm_backend
   pallas --two_cell off`` for 2 epochs from phase 6's seed; the LSTM kernel
   counts are set to 0 just before and read just after and must equal the
   run's own steps (per train batch 2 training-forward and 4 backward
   launches, per eval batch 2 inference-forward launches; two-cell counts
   0), losses finite and falling, the first epoch's train loss equal to
   phase 6's within 1e-3 relative, and no plain version on CUDA tensors;
   a step's wall time beside its device-busy time and idle share;
10. the evaluation path: ``cli.evaluate`` of ``artifacts/jsball_vrnn4`` on
   ``Piano-midi_Cs`` (4,468 test windows, 64 samples, batches of 200)
   through ``--lstm_backend pallas`` (46 inference-forward launches, counts
   set to 0 just before), then ``xla`` (plain PyTorch on the card, same
   seed): the two NLLs within 1e-4; a profile of one evaluation batch; then
   phase 9's checkpoint evaluated on ``Piano-midi_all``;
11. the cl_vae generation kernel (the cluster kernel, one block a cluster)
   vs its plain version, f32, on the trained ``artifacts/jsball_vae``
   weights (D=H=88, L=4, K=10, use_x_prev) at the largest serving bucket (64
   single-frame seeds, 256 steps), with and without ``use_z_prior``:
   probabilities with u=1 within 1e-5, frames equal up to each song's first
   near-tie; kernel and plain times with CUDA events beside the bound, the
   profiler's device time, the plan the wrapper launches (blocks a cluster,
   threads, waves),
   the wrapper's operands timed apart, the kernel's own clock of each part
   of a step, a second call bitwise equal, the serving-bucket grid; then
   bf16 weights at hidden 256 (seeded glorot-scale weights; one block holds
   them, the f32 ones take two): probabilities with u=1, max within 2e-2,
   mean within 2e-3, the same lines; every launch of the phase counted by
   the cluster kernel's count;
12. cl_vae serving: the port's ``cli.serve`` on ``jsball_vae`` with
   ``--dynamic_batching --warmup full`` answers /generate over HTTP (solo,
   key-filtered and MIDI-seeded requests, a burst of 8); the cl_vae launch
   count, set to 0 just before and read just after, must equal the engine's
   device calls, and the plain version must not run on a CUDA tensor;
13. both sample CLIs: ``cli.cl_vae_sample`` (``jsbcs_vae`` on
   ``Piano-midi_Cs``, true keys, 8 songs x 64 frames) and
   ``cli.cl_vrnn_sample`` (``jsball_vrnn4``, ``--infer_w``, 4 songs) write
   their MIDI files with exactly one launch of their kernel each;
14. the dense-stack cl_vae training kernels (forward; backward: one launch,
   the row pass and the weight gradients either side of a grid barrier) vs
   their plain versions at the training shape (B=100, the ``jsball_vae``
   weights with seeded rows for 13 keys, use_x_prev) and at the seq-concat
   width (D=976, Cw=256, H=1024, L=16, K=13, B=1024, seeded glorot
   weights), each shape's plan printed (layout: weights resident in shared
   memory or streamed; rows and threads a block; forward blocks, the
   backward's cooperative grid, weight-gradient tiles; shared memory a
   block): forward outputs within 1e-5 x max(1, max|plain|), every backward
   output within 1e-4 * max|plain| + 1e-6, a second call of each bitwise
   equal; kernel and plain (cuBLAS products) times with CUDA events beside
   each kernel's bound, and each kernel's own clock of its parts;
15. the cl_vae training path: ``cli.cl_vae_train --train_backend pallas``
   for 3 epochs on the committed corpus (13 keys) at the jsball_vae width;
   the dense-stack counts are set to 0 just before and read just after and
   must equal the run's own steps (per train batch one forward and one
   backward launch, per eval batch one forward), losses finite and
   falling, no plain version on CUDA tensors; a step's time split; then one
   ``xla`` epoch from the same seed, its first-epoch loss within 1e-3
   relative of the kernel run's;
16. ``cli.evaluate --family cl_vae`` of ``artifacts/jsbcs_vae`` on
   ``Piano-midi_Cs`` (its whole test split, 64 samples, batches of 200) and
   of phase 15's checkpoint on the training corpus; ``cli.cl_vae_sample`` on
   that checkpoint with true keys, one generation launch;
17. the cl_vae generation kernels of every config past one block's shared
   memory, and without hidden layers, vs their plain version at 64
   single-frame seeds x 256 steps, on seeded glorot weights with 13 keys:
   the cluster kernel in f32 at H=256 and H=512 (D=88, L=4, use_x_prev,
   with and without use_z_prior; 2 and 4 blocks a cluster) and without
   hidden layers, and the wide kernel without hidden layers at D=1,024,
   L=32, no x_prev,
   probabilities with u=1 within 1e-5 and frames equal up to each song's
   first near-tie; the cluster kernel in bf16 at H=512 and the cooperative
   kernel in bf16 at the seq-concat width (D=H=1024, L=16, no x_prev) and
   at D=1,024, H=5,120 with and without x_prev, probabilities within max
   2e-2 / mean 2e-3; each kernel's count equals its launches in the phase,
   and jsball_vae's width takes the cluster kernel on one block; kernel and
   plain times beside each bound, the layout each takes, the cluster
   kernel's plan, device time, operands, clock and repeat bits at each of
   its shapes, and the cooperative kernel's own clock of each part of a
   step at H=5,120;
18. the bf16 mode of both dense-stack kernels vs their bf16 plain versions
   at phase 19's training shape (D=1024, Cw=256, H=1024, L=16, K=13, B=100)
   and at phase 14's seq-concat shape: forward within 1e-2 x max(1,
   max|plain|) and 1e-3 relative Frobenius, backward within 1e-2 relative
   Frobenius (same rounding points, f32 sums in another order); each
   parameter gradient of the loss on the kernel route within 3x the plain
   bf16 route's error against the f32 truth + 2% of its norm, the weight
   gradients bf16-representable and the bias gradients not rounded; a
   second backward call bitwise equal; times beside the bound at the bf16
   rate; both bf16 kernels are ``csrc/vae_dense_tc.cu``: the forward's
   device time split between its two product launches and its row kernel,
   its device launches a call as the profiler records them (the wrapper
   counts the call's three launches as one) and a second call bitwise
   equal; the backward's split between the row-chain products, the row
   kernels and the weight gradients;
19. the bf16 paths: ``cli.cl_vae_train --seq_length 16 --intermediate_dim
   1024 --intermediate_class_dim 256 --latent_dim 16 --bf16_compute
   --train_backend pallas`` for 2 epochs on the committed corpus (D=1,024;
   bf16 counts set to 0 just before and read just after, equal to the run's
   steps), then 1 epoch of ``xla`` from the same seed (first-epoch loss
   within 1e-2 relative), a step's time split (wall, device busy, idle
   share, the dense-stack kernels' device ms by part),
   ``cli.evaluate --family cl_vae`` of the checkpoint; then a bf16
   H=512 model at D=88 trained
   through the kernels, sampled by ``cli.cl_vae_sample`` and served by
   ``cli.serve`` through the cluster kernel (two blocks a cluster; launches
   equal to the engine's device calls), a model without hidden layers
   sampled through the cluster kernel, and a seq-concat model without hidden
   layers (``--seq_length 16``, L=32: D=1,024, whose z heads 8 blocks do
   not hold) sampled through the wide kernel;
20. the bf16 stream mode of the three whole-sequence LSTM kernels (the
   tensor-core route of ``csrc/lstm_seq_tc.cu``) vs their
   bf16 plain versions at H=1,024 (the seeded Keras init, 13 keys):
   training forward and backward at B=1,024, T=16 for the encoder (IN=101)
   and the decoder (IN=103), the inference forward at the evaluation shape
   (12,800 rows): forward h and c within 1e-2 x max(1, max|plain|) and 1e-3
   relative Frobenius, backward outputs within 1e-2 relative Frobenius, dRk
   bf16 and dW, db not rounded; times beside bounds at the bf16 rate, and
   the backward's device time split between the walk, dRk and dW / db;
21. the bf16 cl_vrnn of the JAX package's scale work (D=88, H=1,024, L=2,
   T=16, use_x_prev, B=1,024; 13 keys) trained by ``cli.cl_vrnn_train``
   for 2 epochs with the args.json the JAX package's ``--lstm_backend
   auto`` writes at this width (pallas, ``bf16_compute``, fusion (T, T, T),
   ``two_cell`` off), read back through ``cl_vrnn_config_from_args``; the
   LSTM counts set to 0 just before and read just after equal the run's
   steps in bf16 (2 training forwards and 4 backward launches per train
   batch, 2 inference forwards per eval batch) and 0 in f32 and two-cell;
   losses finite and falling, no plain version on CUDA tensors; 1 epoch of
   ``xla`` from the same seed (first-epoch loss within 1e-2 relative); a
   step's time split;
22. ``cli.evaluate`` of that checkpoint on the training corpus through the
   bf16 inference kernel (2 launches per batch) and through ``xla`` (NLLs
   within 1e-2 relative), a profile of one evaluation batch,
   ``cli.cl_vrnn_sample`` of it (one bf16 generation launch), and
   ``artifacts/jsball_vrnn4`` with its args flagged bf16 evaluated on
   ``Piano-midi_Cs`` through the bf16 kernel, its NLL beside phase 10's;
23. the bf16 stream mode of both two-cell kernels vs their bf16 plain
   versions at phase 24's shape (B=1,024, T=16, D=88, H=512, L=2, K=13,
   use_x_prev; the model's seeded Keras init): the f32 forward outputs
   within 1e-2 x max(1, max|plain|) and 1e-3 relative Frobenius, the bf16
   streams within one bf16
   step at their largest entry, every backward output within 1e-2 of its
   largest entry, types checked (streams and weight gradients bf16, bias
   sums not rounded), a second forward and backward call bitwise equal;
   times beside bounds at the bf16 rate, the forward's and the backward's
   device split as phase 5's and the HMMA count of each bf16 product kernel;
24. the bf16 two-cell cl_vrnn the JAX package trains at H=512
   (``artifacts/two_cell_exp.json`` row ``H512_B1024_bf16``: D=88, L=2,
   T=16, use_x_prev, B=1,024; 13 keys) trained by ``cli.cl_vrnn_train``
   with the args.json JAX ``--lstm_backend auto`` writes at this width
   (pallas, ``bf16_compute``, fusion (T, T, T), ``two_cell`` on): 1 epoch
   with ``--save_last``, then ``--resume`` to 2 epochs, which goes on at
   epoch 1 with the saved AdamWN count; each run's bf16 two-cell counts,
   set to 0 just before and read just after, equal its steps (one forward
   per train and eval batch, two backward launches per train batch), every
   other count 0; no plain version on CUDA tensors; 1 epoch of ``xla`` from
   the same seed (first-epoch loss within 1e-2 relative); a step's split;
25. that checkpoint downstream: ``cli.evaluate`` through the bf16 LSTM
   inference kernel and through ``xla`` (NLLs within 1e-3 relative),
   ``cli.cl_vrnn_sample`` (one bf16 generation launch) and one /generate
   request through ``cli.serve`` (one bf16 launch);
26. the kernels of the other fusion rungs (proj, drk, full) of the
   whole-sequence LSTM (the unfused inference and training forwards on xz =
   x @ W + b, the dz-only walk, the drk walk with its dRk pass) vs their
   plain versions: bf16 at phase 27's shape (B=1,024, T=16, H=2,048; the
   model's seeded Keras init, 13 keys) for the encoder (IN=101) and the
   decoder (IN=103), forward within 1e-2 x max(1, max|plain|) and 1e-3
   relative Frobenius, the walks within 1e-2 relative Frobenius; beside
   them the fused-projection training and inference forwards phase 27 runs,
   at its training batch and at one 1,600-row evaluation batch, within the
   same forward bounds; every
   gradient of each rung there with JAX's types (dRk and dx bf16-valued, dW
   f32 at the proj rungs and bf16-valued at the unfused ones, db never
   rounded); the walk at H=2,560 (B=256); f32 at phase 8's
   shape within phase 8's bounds, with the f32 walks' device split (the
   walk, the drk rung's dRk); times beside bounds at the stream type's
   rate;
27. the bf16 cl_vrnn the JAX package trains at H=2,048
   (``artifacts/fused_kernel_exp.json`` phase h2048, variant proj: D=88,
   L=2, T=16, use_x_prev, B=1,024; 13 keys) through ``cli.cl_vrnn_train
   --lstm_backend pallas --two_cell off`` with ``bf16_compute``: the CLI
   pins fusion (T, F, F), the args.json JAX ``auto`` writes there; 1
   epoch whose counts, set to 0 just before and read just after, are per
   train batch 2 bf16 training forwards and 2 bf16 dz-only walks, per eval
   batch 2 bf16 inference forwards, every other 0 (never the full rung's
   backward); 1 epoch of ``xla`` (first-epoch loss within 1e-2 relative); a
   step's split; ``cli.evaluate`` of its last epoch at 8 samples through
   ``keep`` (2 bf16 inference forwards a batch) and ``xla`` (NLLs within
   1e-2 relative); ``cli.cl_vrnn_sample`` (one bf16 generation launch);
   the bf16 generation kernel on that checkpoint's weights against its
   plain version (probabilities within max 2e-2, mean 2e-3, as phase 3),
   then timed at 64 songs x (32 + 256) steps beside its bound (its slices,
   70 MB in all, stream from L2 and HBM);
28. the other rungs end to end at the jsball_vrnn4 width (B=200, T=16,
   H=256, ``--two_cell off``): 1 epoch each of fusion (T, T, F), (F, T, F)
   and (F, F, F) in f32 and (F, F, F) and (T, T, F) in bf16, set through
   ``args.fusion``; each run's counts equal its steps, every other 0, the
   f32 runs' first-epoch loss within 1e-3 relative of phase 9's, each
   run's step wall time beside its device-busy time and idle share (the f32
   runs' walk and dRk device ms a step); then
   ``cli.evaluate`` of the (F, F, F) f32 checkpoint through the unfused
   inference forward (2 a batch) and ``xla`` (NLLs within 1e-4);
29. the int8 generation kernels vs their plain versions on seeded glorot
   weights: cl_vrnn at D=88, L=2, use_x_prev, 13 keys, H=64, H=1,536 and
   H=1,752 (the JAX package's int8 band), 64 songs x (32 + 256) steps, the
   kernel's profiler device time (one launch a call) apart from the
   wrapper's CUDA-event time and its pack; cl_vae at the
   seq-concat width (D=1,024, L=16), H=5,120 without x_prev (with and
   without use_z_prior) and H=4,160 with x_prev, whose weight slices stay
   in shared memory, and H=5,120 and H=7,808 with x_prev, which stream the
   frame head's tiles and then the x rows as well, 64 x 256: the layout
   each takes, the quantized
   operands equal on the card and the host, probabilities with u=1 within
   1e-5, free-running frames equal in >= 99.9% of entries, the kernel's
   profiler device time (one launch a call), the pack timed apart and the
   kernel's own clock of each part of a step
   (``cuda_generate_vae.phase_ms``); the int8 kernel, its plain version and
   the bf16 kernel on the same weights timed, beside the int8 bound; at
   H=1,536 the bf16 kernel's CUDA-event and device time beside its bound at
   the bf16 rate (its slices stream from L2);
30. the int8 paths: ``cli.cl_vrnn_train`` writes the bf16 H=1,536 cl_vrnn
   (1 epoch, ``--lstm_backend pallas``, ``bf16_compute`` as JAX ``auto``
   sets it; args.json pallas, bf16, fusion (T, T, T), ``two_cell`` off; the
   bf16 LSTM counts equal its steps), then ``cli.cl_vrnn_sample`` and
   ``cli.serve --lstm_backend keep`` (4 requests) sample it through the int8
   kernel, bf16 launches 0, /stats mode int8, and ``serve`` with its default
   ``auto`` in bf16, int8 launches 0; ``cli.cl_vae_train`` writes the bf16
   seq-concat cl_vae at H=5,120 (1 epoch), ``cli.cl_vae_sample`` and
   ``cli.serve`` with ``--gen_backend pallas`` sample it in int8 (88-pitch
   rolls of 16 frames a row), with ``auto`` in bf16 through the cooperative
   kernel (its count 1 a call);
31. the bf16 tensor-core route swept over H = 88, 512, 1,024, 1,536, 2,048,
   2,560 x B = 200, 1,024, 1,600 (T=16, IN=101): training and inference
   forwards within phase 20's forward bounds, the walk within 1e-2 relative
   Frobenius, each timed beside its bound (Rk crosses the 50 MB L2 between
   H=2,048 and 2,560);
32. key consistency and the 13-key checkpoints: ``cli.key_consistency`` of
   ``artifacts/pm_configs/c5m.npz`` (cl_vrnn, H=88, 13 keys) on the
   training corpus, 8 songs x (32 + 64) steps a key: one generation launch
   (``generate_kernel<float>``) a key with test songs, counted from 0 just
   before, the report printed, its margin > 0; the first key's batch
   through the kernel (bitwise the CLI's frames) and the plain version on
   the CLI's own noise, frames equal up to each song's first near-tie;
   ``jsball_vrnn4`` (K=10) on the 13-key corpus raising; ``cli.evaluate``
   of ``c3.npz`` (cl_vae) and of ``c5m.npz`` through ``--lstm_backend
   pallas`` (the f32 inference forward at H=88: 2 launches a batch) on the
   training corpus, 64 samples, seeds 0-7: the mean NLL of the 8 runs
   within 0.01 nats/frame of the mean of the JAX package's CPU runs of
   those seeds (c3 9.838325, c5m 6.347775; seed 0 alone, 9.8525 and 6.3478,
   is printed beside the card's: one seed's estimate of c3 moves by up to
   0.045 between seeds); that forward at the
   evaluation shape (12,800 rows) against its plain version, timed beside
   its bound;
33. the train CLIs' flags: ``cli.cl_vrnn_train`` at phase 6's width
   through the two-cell kernels, 2 epochs with ``--data_init
   --check_numerics --do_log --trace_dir --streaming``: the two-cell counts
   equal the run's steps plus the check's first batch (one forward, two
   backward launches); the check's line printed, and a NaN in one leaf
   raising, naming it; the card's data-based init within rtol 1e-5 / atol
   1e-6 of the CPU plain init on the same noise; 40 streamed steps (pinned
   memory, a side stream, ``device_prefetch``) with losses bitwise those
   of the same batches and noise copied synchronously; a JSONL line and an
   event an epoch, the events' scalars the JSONL's in f32; one Chrome
   trace, naming the two-cell forward and backward kernels; the wall time
   of warm streamed and resident epochs in turns (a record);
34. sampling at every width: the f32 / bf16 cl_vrnn generation kernel
   past 20 hidden units a block (H = 2,688 and 4,096 at D=88, L=2, 13
   keys: blocks of two unit groups, ``gen_grid``) and the bf16 cl_vae
   wide kernel past the cooperative kernel's latent width (D=1,024,
   H=5,120, L=106), seeded weights, 8 songs x 32 steps (cl_vrnn after a
   32-frame seed), each driven through its sampling entry point
   (``generate_cl_vrnn_batch`` / ``generate_cl_vae_batch``, the counts set
   to 0 just before: one launch a call) and held against its plain version
   on the same noise with u = 1: f32 within 1e-5, bf16 with no output
   ``bf16_outside`` and max 2e-2 / mean 2e-3; each timed beside its bound;
35. data-parallel training through NCCL at world size 1:
   ``cli.cl_vrnn_train --lstm_backend pallas --dp 1`` and
   ``cli.cl_vae_train --train_backend pallas --dp 1`` (the CLI spawns the
   rank) against the same runs without ``--dp``: epoch losses within rtol
   1e-5 and final parameters within rtol 1e-4 / atol 1e-6, and the rank's
   two-cell and dense-stack launch counts (set to 0 in the rank just
   before its run) those of the run without ``--dp``. NCCL refuses two
   ranks on one card, so more ranks are held on the CPU (gloo,
   ``tests/test_torch_parallel.py``);
36. one process over a two-shard mesh of the one card (``make_mesh(2,
   devices=[card, card])``): ``generate_cl_vrnn_batch_dp`` (jsball_vrnn4,
   64 songs x (32 + 64)) and ``generate_cl_vae_batch_dp`` (jsball_vae, 64
   x 64, keys inferred) bitwise equal to the single-device kernel calls on
   each shard's songs and noise (two launches a call), and their frames
   beside the whole batch's single-device call; ``iw_nll_dataset_dp`` of
   jsball_vrnn4 on ``Piano-midi_Cs`` through ``--lstm_backend pallas``
   (``cli.evaluate --dp 2``: two inference launches a shard and batch)
   within 1e-4 of the single-device NLL; then ``cli.serve --dp 2`` on that
   mesh answering requests through ``generate_cl_vrnn_batch_dp`` (both
   CLIs' ``dp_mesh`` given the two-shard mesh: ``--dp`` past the card
   count raises);
37. tensor parallelism on a ``(1, 2)`` mesh that repeats the card, each run
   once with the parameters replicated and once column-sharded over the
   two model devices (``weights.params_on_model_axis``): (a) 4 steps of the
   f32 two-cell cl_vrnn at phase 6's width, (b) 3 steps of phase 21's bf16
   H=1,024 cl_vrnn (``--two_cell off``), (c) 6 steps of the f32 cl_vae
   through the dense-stack kernels, (d) ``iw_nll_dataset`` of c5m through
   the H=88 inference kernel (two batches of 200 test windows), (e)
   ``generate_cl_vrnn_batch`` of jsball_vrnn4 (64 x (32 + 64)), (f) run (a)
   through ``Trainer(mesh=make_mesh(1, 2, [card, card]))`` in a one-rank
   NCCL group; losses within rtol 1e-5 (phase 35's), final parameters
   within 1e-5 as each leaf's relative norm of the difference and, element
   by element, within JAX ``tests/test_parallel.py``'s TP bound (rtol
   1e-3, atol 1e-5) ((b): phase 21's relative 1e-2, on the losses and each
   leaf's norm), NLLs per window within rtol 1e-5, generation bitwise equal; every
   launch count (set to 0 just before each run) equal to the replicated
   run's and > 0 for the run's kernels, the shard-product count
   (``parallel.columns.SHARD_PRODUCTS``: the heads' column-parallel
   products) > 0 on the TP runs that have plain products; ms per step TP
   against replicated (the median after each run's first step);
38. the route ``--two_cell auto`` picks for fresh bf16 training at the
   scaled widths: ``cli.cl_vrnn_train --lstm_backend pallas`` with
   ``bf16_compute`` and no ``--two_cell`` flag, 1 epoch each at H=1,024 and
   H=2,048 (B=1,024, phases 21's and 27's flags otherwise): args.json
   records ``two_cell: true``; the bf16 two-cell counts (set to 0 just
   before, read just after) are one forward launch a train and eval batch
   and two backward launches a train batch, and the whole-sequence LSTM
   kernels launch 0 times; the first epoch's train loss within 1e-2
   relative of the ``xla`` epoch phases 21 and 27 ran from the same seed;
39. ``tools/torch_converged_parity.py`` (BASELINE configs 3 and 5 trained,
   evaluated and sampled through the kernels) at ``--epochs 7`` on the
   pallas route, seed 0, each config: a checkpoint, four finite NLLs
   (evaluation seeds 0-3, 64 samples), the MIDI files (and config 5's WAV
   files) read back with notes, no plain version on a CUDA tensor, and the
   launch counts of its stages (set to 0 just before each) > 0 for the
   two-cell forward and backward, the f32 inference forward and the
   cl_vrnn generation kernel (config 5), the dense-stack forward and
   backward and the cl_vae generation kernel (config 3);
40. the step-decomposition probes of ``tools/`` (``ops/exp_lstm.py``,
   ``csrc/exp_lstm.cu``): their tools' paths with the counts set to 0
   just before and read just after (``tools/torch_exp_h512_ablation.py``'s
   microkernels at B=1,024, H=512, bb=256, ``tools/torch_exp_lstm_interleave.py``
   at H=512, B=1,024, and ``tools/torch_repro_full_bwd_fault.py``'s ten
   cases, each in its own process, all at once: the six mini walks at
   B=40 (a partial 16-row tile), the bf16 and f32 walk-drk and full
   backwards called directly and through autograd at B=500, H=512, each
   finite and within 1e-2 (bf16) or 1e-4 (f32) of its plain version); then
   each kernel against its plain version at the tests' shape (64, 128, 32)
   and the tool's (1,024, 512, 256), the chains within 1e-2 of each output
   block's largest entry (from the state the kernel carried,
   ``exp_lstm.chain_plain_blockwise``), the gates and the off-chain product
   within 1e-4, the interleave bitwise equal to the port's bf16 training
   forward and within 1e-3 relative Frobenius of its plain version, the
   mini walk's f32 sums within 1e-4 and its dx within 1e-2; CUDA-event and
   device times of each at the tool's shape beside its bound, its plain
   version's time and, for the off-chain product, one ``torch.mm`` of the
   same operations; phase 1's SASS check finds HMMA in the chain, pair,
   off-chain and interleave kernels.

The run prints each phase's wall time, and fails if a thread it started is
still running at the end.

The last lines are the kernel table (one JSON object), the card's name and
power limit, and ``{"ok": true, "device": {...}}``. ``--phases`` runs only
the phases named, with phase 1 and the phases whose results they read (for
example to time two checkouts' training paths in turns in one call); such a
run prints neither the table nor the result line.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import dataclasses
import functools
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

SEED = 0
MODEL = "artifacts/jsball_vrnn4.npz"
VAE_MODEL = "artifacts/jsball_vae.npz"
CORPUS = "data/input/Piano-midi_all.pickle"
EVAL_CORPUS = "data/input/Piano-midi_Cs.pickle"  # keys 0 and 1: jsball_vrnn4 has 10
EVAL_WINDOWS, EVAL_SAMPLES, EVAL_B = 4468, 64, 200  # its test split at T=16
PEAK_F32_FLOPS = 67e12  # H100 SXM, f32 outside the tensor cores
PEAK_BF16_FLOPS = 989e12  # H100 SXM, dense bf16 on the tensor cores
PEAK_HBM_BYTES = 3.35e12  # H100 SXM HBM3
TRAIN_B, TRAIN_T, TRAIN_K = 200, 16, 13  # the training path's batch, window, key classes
LSTM_SEQ_PLAIN = ("lstm_seq_fwd_plain", "lstm_seq_train_fwd_plain", "lstm_seq_bwd_plain",
                  "lstm_seq_xz_fwd_plain", "lstm_seq_xz_train_fwd_plain", "lstm_seq_walk_plain",
                  "lstm_seq_walk_drk_plain")


def require(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke FAILED: {msg}")


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, warm: int = 1) -> float:
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def seed_windows(n: int):
    import numpy as np

    from classifying_vae_lstm_tpu_torch.data import PianoData

    P = PianoData(CORPUS, batch_size=1, seq_length=32, squeeze_x=False)
    idx = np.random.default_rng(SEED).choice(len(P.x_test), size=n, replace=False)
    return P.x_test[idx]


def frames_agree_to_near_tie(label, fk, fp, u, probs):
    """Kernel frames ``fk`` equal the plain frames ``fp`` ([B, nsteps, D])
    in every song up to its first near-tie, a step where some |u - p| < 1e-4
    in the plain run (``probs``): there the two summation orders may rightly
    draw another frame, and the songs part."""
    import torch

    B, nsteps = fk.shape[:2]
    require(set(torch.unique(fk).tolist()) <= {0.0, 1.0}, "kernel frames not binary")
    near = ((u - probs).abs() < 1e-4).any(dim=2)  # [B, nsteps]
    diff = (fk != fp).any(dim=2)
    first = lambda m: torch.where(m.any(1), m.float().argmax(1), torch.full_like(m[:, 0], nsteps,
                                                                                 dtype=torch.long))
    t_tie, t_diff = first(near), first(diff)
    bad = (t_diff < t_tie).nonzero().flatten().tolist()
    whole = int((t_diff == nsteps).sum().item())
    print(f"{label}: {whole}/{B} songs agree wholly; {int((t_tie < nsteps).sum())} songs "
          f"have a near-tie (median first near-tie at step {int(t_tie.median())}); "
          f"songs diverging before their first near-tie: {bad}")
    require(not bad, f"songs {bad} diverge before a near-tie")


def roofline_ms(fmas: float, nbytes: float, peak: float = PEAK_F32_FLOPS) -> tuple[float, str]:
    """Least time for a call: the larger of its operations (2 per FMA) over
    the card's rate for their type (f32 by default; ``PEAK_BF16_FLOPS`` for
    products of bf16 operands) and its bytes over HBM bandwidth."""
    t_ops, t_bytes = 2 * fmas / peak, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def bound_ms(cfg, B, Tseed, nsteps, weight_bytes, peak=PEAK_F32_FLOPS) -> tuple[float, str]:
    """Least time for one call: the larger of its FMAs over the card's rate
    for their type (f32 by default; ``PEAK_BF16_FLOPS`` for the bf16 mode)
    and its bytes (each input read once, the output written once) over HBM
    bandwidth. The w folds are computed outside the kernel."""
    D, H, L = cfg.original_dim, cfg.intermediate_dim, cfg.latent_dim
    total, n_xp = Tseed + nsteps, (D if cfg.use_x_prev else 0)
    per_song_step = 2 * ((D + H) * 4 * H + H * 2 * L + (H + L + n_xp) * 4 * H + H * D)
    flops = B * total * per_song_step
    stream_bytes = 4 * (B * Tseed * D + B * total * (L + D) + 2 * B * 4 * H
                        + 2 * L + D + B * nsteps * D)
    t_ops = flops / peak
    t_bytes = (stream_bytes + weight_bytes) / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def phase_build():
    from classifying_vae_lstm_tpu_torch.ops import _build

    t0 = time.perf_counter()
    logs = _build.build_all(extra_flags=["-Xptxas", "-v"])
    build_s = time.perf_counter() - t0
    for name, log in logs.items():
        print(f"--- nvcc csrc/{name}.cu ---\n{log.strip()}")
    print(f"kernel build: {build_s:.2f} s for {sorted(logs) or 'no sources (already built)'}")
    require(set(_build.sources()) == {"exp_lstm", "generate_cl_vae", "generate_cl_vrnn",
                                      "lstm_bwd_f32",
                                      "lstm_seq", "lstm_seq_tc", "two_cell", "two_cell_tc",
                                      "vae_dense", "vae_dense_tc"},
            f"sources {_build.sources()}")


# the product kernels of csrc/lstm_seq_tc.cu (the gate-gradient kernel is
# elementwise and has no product)
TC_KERNELS = ("lstm_tc_proj_kernel", "lstm_tc_step_kernel", "lstm_tc_bwd_step_kernel",
              "lstm_tc_drk_kernel")


# the two-cell backward's kernels (csrc/two_cell_tc.cu): the bf16 products
# on the tensor cores, the f32 mode's kernels on FFMA only
TWO_CELL_TC = ("two_cell_walk_tc_kernel", "two_cell_dx_tc_kernel", "two_cell_dw_tc_kernel")
TWO_CELL_F32 = ("two_cell_walk_f32_kernel", "two_cell_dx_f32_kernel", "two_cell_handoff_kernel",
                "two_cell_dw_narrow_kernel", "wgrad_kernel")
# the two-cell forward's kernels (csrc/two_cell.cu): the walk steps, bf16 on
# the tensor cores, f32 on FFMA only (and the layouts, no products); the f32 /
# bf16 generation kernel's two instances (mangled template arguments)
TWO_CELL_FWD_TC = ("two_cell_step_tc_kernel",)
TWO_CELL_FWD_F32 = ("two_cell_step_f32_kernel", "two_cell_layout_kernel")
GEN_BF16, GEN_F32 = ("generate_kernelI13__nv_bfloat16",), ("generate_kernelIf",)
# the cooperative cl_vae kernel's instances (csrc/generate_cl_vae.cu): int8
# codes, bf16 and f32 operands
VAE_COOP_I8, VAE_COOP_BF16, VAE_COOP_F32 = ("generate_vae_coop_kernelIa",), (
    "generate_vae_coop_kernelI13__nv_bfloat16",), ("generate_vae_coop_kernelIf",)
# the cluster cl_vae kernel's instances (f32 and bf16, each with and without
# the register path), FFMA only in both modes
VAE_CLUSTER = ("generate_cluster_kernelIf", "generate_cluster_kernelI13__nv_bfloat16")
# the bf16 dense-stack backward's product kernels (csrc/vae_dense_tc.cu), on
# the tensor cores; the f32 LSTM full backward's (csrc/lstm_bwd_f32.cu), FFMA
VAE_TC = ("vae_tc_product_kernel", "vae_tc_dw_kernel")
# the product kernels of the tools' probes (csrc/exp_lstm.cu), on the tensor cores
EXP_TC = ("chain_kernel", "pair_kernel", "offchain_kernel", "interleave_kernel")
LSTM_BWD_F32 = ("lstm_bwd_walk_kernel", "lstm_bwd_dx_kernel", "wgrad_kernel")


@functools.lru_cache(maxsize=None)
def lib_sass(source) -> dict:
    """``cuobjdump -sass`` counts per kernel of the built ``csrc/<source>.cu``
    (``tools/torch_kernel_resources.sass_counts``), read once a library."""
    from classifying_vae_lstm_tpu_torch.ops import _build
    from tools.torch_kernel_resources import sass_counts

    return sass_counts(str(_build._lib_path(source)))


def hmma_counts(source, names) -> dict:
    """HMMA / HGMMA count per kernel of the built ``csrc/<source>.cu`` whose
    mangled name holds one of ``names``."""
    counts = lib_sass(source)
    return {k: [c["hmma"] for n, c in counts.items() if k in n] for k in names}


def phase_tensor_cores():
    """``cuobjdump -sass`` of the built ``csrc/lstm_seq_tc.cu`` library: every
    instance of each product kernel holds tensor-core (HMMA or HGMMA)
    instructions; likewise the bf16 product kernels of
    ``csrc/two_cell_tc.cu``, of the two-cell forward (``csrc/two_cell.cu``)
    and the bf16 instance of the generation kernel, whose f32 kernels hold
    none; the int8 generation kernels of ``csrc/generate_cl_vrnn.cu`` and
    ``csrc/generate_cl_vae.cu`` hold int8 tensor-core (IMMA) instructions
    and no ``__dp4a`` (IDP), the cooperative cl_vae kernel's bf16 instance
    HMMA and its f32 instance none, the f32 LSTM forward none, and the
    product kernels of ``csrc/exp_lstm.cu`` HMMA."""
    sources = ("lstm_seq_tc", "two_cell_tc", "two_cell", "generate_cl_vrnn", "generate_cl_vae",
               "vae_dense_tc", "lstm_bwd_f32", "lstm_seq", "exp_lstm")
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:  # one cuobjdump each
        list(pool.map(lib_sass, sources))
    counts = {n: c["hmma"] for n, c in lib_sass("lstm_seq_tc").items()}
    found = {k: [n for n in counts if k in n] for k in TC_KERNELS}
    print("tensor-core instructions (HMMA/HGMMA) in csrc/lstm_seq_tc.cu: " + "; ".join(
        f"{k} {[counts[n] for n in names]}" for k, names in found.items()))
    require(all(names and all(counts[n] > 0 for n in names) for names in found.values()),
            f"a product kernel of csrc/lstm_seq_tc.cu runs without tensor-core instructions: "
            f"{counts}")
    tc16, f32 = hmma_counts("two_cell_tc", TWO_CELL_TC), hmma_counts("two_cell_tc", TWO_CELL_F32)
    print(f"tensor-core instructions in csrc/two_cell_tc.cu: bf16 products {tc16}; f32 mode "
          f"{f32}")
    require(all(v and all(c > 0 for c in v) for v in tc16.values()),
            f"a bf16 product kernel of csrc/two_cell_tc.cu runs without tensor cores: {tc16}")
    require(all(v and not any(v) for v in f32.values()),
            f"an f32 kernel of csrc/two_cell_tc.cu holds tensor-core instructions: {f32}")
    fwd16, fwd32 = (hmma_counts("two_cell", k) for k in (TWO_CELL_FWD_TC, TWO_CELL_FWD_F32))
    gen16, gen32 = (hmma_counts("generate_cl_vrnn", k) for k in (GEN_BF16, GEN_F32))
    print(f"tensor-core instructions in csrc/two_cell.cu: bf16 {fwd16}; f32 {fwd32}; in "
          f"csrc/generate_cl_vrnn.cu's generate_kernel: bf16 {gen16}; f32 {gen32}")
    require(all(v and all(c > 0 for c in v) for v in (*fwd16.values(), *gen16.values())),
            f"a bf16 kernel of the two-cell forward or of generation runs without tensor cores: "
            f"{fwd16} {gen16}")
    require(all(v and not any(v) for v in (*fwd32.values(), *gen32.values())),
            f"an f32 kernel of the two-cell forward or of generation holds tensor-core "
            f"instructions: {fwd32} {gen32}")
    i8 = {n: c for n, c in lib_sass("generate_cl_vrnn").items() if "generate_int8_kernel" in n}
    print("generate_int8_kernel (csrc/generate_cl_vrnn.cu): " + "; ".join(
        f"{c['imma']} IMMA (int8 tensor-core), {c['idp']} IDP (__dp4a) of {c['sass']} "
        "instructions" for c in i8.values()))
    require(len(i8) == 1 and all(c["imma"] > 0 and c["idp"] == 0 for c in i8.values()),
            f"generate_int8_kernel does not run its products on the int8 tensor cores: {i8}")
    v8 = {n: c for n, c in lib_sass("generate_cl_vae").items() if VAE_COOP_I8[0] in n}
    print("generate_vae_coop_kernel<signed char> (csrc/generate_cl_vae.cu): " + "; ".join(
        f"{c['imma']} IMMA, {c['idp']} IDP of {c['sass']} instructions" for c in v8.values()))
    require(len(v8) == 1 and all(c["imma"] > 0 and c["idp"] == 0 for c in v8.values()),
            f"the int8 cl_vae kernel does not run its products on the int8 tensor cores: {v8}")
    coop16, coop32 = (hmma_counts("generate_cl_vae", k) for k in (VAE_COOP_BF16, VAE_COOP_F32))
    fwd32 = hmma_counts("lstm_seq", ("lstm_fwd_kernel",))
    print(f"tensor-core instructions in generate_vae_coop_kernel: bf16 {coop16}, f32 {coop32}; "
          f"in csrc/lstm_seq.cu's f32 forward {fwd32}")
    require(all(v and all(c > 0 for c in v) for v in coop16.values()),
            f"the bf16 cooperative cl_vae kernel runs without tensor cores: {coop16}")
    require(all(v and not any(v) for v in (*coop32.values(), *fwd32.values())),
            f"an f32 kernel holds tensor-core instructions: {coop32} {fwd32}")
    cl = hmma_counts("generate_cl_vae", VAE_CLUSTER)
    print(f"tensor-core instructions (HMMA, TF32 included) in generate_cluster_kernel: f32 "
          f"{cl[VAE_CLUSTER[0]]}, bf16 {cl[VAE_CLUSTER[1]]} (FFMA in both modes)")
    require(len(cl[VAE_CLUSTER[0]]) == 2 and len(cl[VAE_CLUSTER[1]]) == 2
            and not any(cl[VAE_CLUSTER[0]] + cl[VAE_CLUSTER[1]]),
            f"the cluster cl_vae kernel's instances hold tensor-core instructions: {cl}")
    vae16, lstm32 = hmma_counts("vae_dense_tc", VAE_TC), hmma_counts("lstm_bwd_f32", LSTM_BWD_F32)
    print(f"tensor-core instructions in csrc/vae_dense_tc.cu's products {vae16}; in "
          f"csrc/lstm_bwd_f32.cu {lstm32}")
    require(all(v and all(c > 0 for c in v) for v in vae16.values()),
            f"a product kernel of csrc/vae_dense_tc.cu runs without tensor cores: {vae16}")
    require(all(v and not any(v) for v in lstm32.values()),
            f"a kernel of csrc/lstm_bwd_f32.cu holds tensor-core instructions: {lstm32}")
    exp16 = hmma_counts("exp_lstm", EXP_TC)
    print(f"tensor-core instructions in csrc/exp_lstm.cu's products {exp16}")
    require(all(v and all(c > 0 for c in v) for v in exp16.values()),
            f"a product kernel of csrc/exp_lstm.cu runs without tensor cores: {exp16}")


GEN_BUCKETS = ((1, 4, 16, 64), (32, 64, 128, 256))  # serving buckets: songs x steps


def generation_grid(label, params, cfg, seeds, eps, u, ws, mode):
    """The generation kernel's CUDA-event ms per serving bucket (songs x
    steps), each after a warm-up launch."""
    from classifying_vae_lstm_tpu_torch.ops import cuda_generate as cg

    grid, Tseed = {}, seeds.shape[1]
    for b in GEN_BUCKETS[0]:
        for t in GEN_BUCKETS[1]:
            args = [x[:b, : Tseed + t].contiguous() for x in (seeds, eps, u)]
            wb = ws[:b].contiguous()
            grid[f"{b}x{t}"] = round(time_ms(lambda: cg.generate_cl_vrnn_batch_cuda(
                params, cfg, args[0], t, args[1], args[2], wb, mode=mode), reps=5), 3)
    print(f"{label} kernel ms per serving bucket (songs x steps): {json.dumps(grid)}")


def generation_line(label, params, cfg, seeds, nsteps, eps, u, ws, mode, reps=3):
    """The f32 / bf16 generation kernel at one shape: CUDA-event ms a call
    around the wrapper, the profiler's device ms of ``generate_kernel`` a
    call (one launch), its own clock of each part of a step
    (``cuda_generate.phase_ms``), the grid and weight residency, a second
    call bitwise equal, beside the bound (the mode's rate). Returns (ms,
    device ms or None, bound ms, bound_by)."""
    import torch

    from classifying_vae_lstm_tpu_torch.ops import cuda_generate as cg

    B, Tseed, D = seeds.shape
    H, L = cfg.intermediate_dim, cfg.latent_dim
    fn = lambda: cg.generate_cl_vrnn_batch_cuda(params, cfg, seeds, nsteps, eps, u, ws,
                                                return_probs=True, mode=mode)
    first = fn()
    same_bits(lambda: (fn(),), (), (first,), ("probabilities",), f"{label} generation")
    k_ms = time_ms(fn, reps, warm=1)
    dv = device_ms_per_call(fn, 2, "generate_kernel")
    w = cg._pack(params, cfg, ws, D, mode)
    wbytes = sum(w[k].numel() * w[k].element_size()
                 for k in ("wke_x", "rke", "wz_t", "wkd_x", "wkd_z", "rkd", "wx_t")
                 if w[k] is not None)
    peak = PEAK_BF16_FLOPS if mode == "bf16" else PEAK_F32_FLOPS
    b_ms, b_by = bound_ms(cfg, B, Tseed, nsteps, wbytes, peak)
    n_sm = torch.cuda.get_device_properties(seeds.device).multi_processor_count
    nu, nv, blocks = cg.gen_grid(H, n_sm)
    res = cg.resident_bytes(D, H, L, nu, B, cfg.use_x_prev, mode, nv)
    split = cg.phase_ms(params, cfg, seeds, nsteps, eps, u, ws, mode)
    print(f"{label} generation: a call's parts (block 0's clock, ms; a wait is the slowest "
          "block's lag and the grid barrier) "
          + "; ".join(f"{n} {v:.3f}" for n, v in split.items()))
    print(f"{label} generation, {B} x ({Tseed} + {nsteps}), H={H}: kernel {k_ms:.3f} ms a call "
          f"(CUDA events), device {dv[0] if dv else 'not measured'} ms in generate_kernel "
          f"(profiler); bound {b_ms:.4f} ms ({b_by}, {mode} rate); {blocks} blocks of {nv} "
          f"group(s) of {nu} units, "
          f"weights {'resident, ' + str(res) + ' B a block' if res else 'streamed from L2'}, "
          f"{cg.gen_smem(nu, min(B, cg.launch_songs(nu, nv, L)), L, res, nv)} B of shared "
          "memory a block")
    return k_ms, (dv[0] if dv else None), b_ms, b_by


def phase_f32(dev):
    import numpy as np
    import torch

    from classifying_vae_lstm_tpu_torch.cli import common
    from classifying_vae_lstm_tpu_torch.ops import cuda_generate as cg
    from classifying_vae_lstm_tpu_torch.sampling import infer_w_cl_vrnn
    from classifying_vae_lstm_tpu_torch.weights import params_from_numpy

    raw, cfg, _ = common.load_model(MODEL, "cl_vrnn")
    params = params_from_numpy(raw, dev)
    B, Tseed, nsteps = 64, 32, 256
    total = Tseed + nsteps
    seeds = torch.from_numpy(seed_windows(B)).to(dev)
    ws = infer_w_cl_vrnn(params, cfg, seeds)
    rng = np.random.default_rng(SEED)
    eps = torch.from_numpy(rng.standard_normal((B, total, cfg.latent_dim),
                                               dtype=np.float32)).to(dev)
    u_np = rng.random((B, total, cfg.original_dim), dtype=np.float32)
    # the seed phase's draws are discarded except the last one's, which feeds
    # the first free step; pinning them makes every near-tie visible in the
    # returned (post-seed) probabilities
    u_np[:, :Tseed] = 1.0
    u = torch.from_numpy(u_np).to(dev)
    u1 = torch.ones_like(u)

    kern = lambda uu, rp: cg.generate_cl_vrnn_batch_cuda(params, cfg, seeds, nsteps, eps, uu, ws,
                                                         return_probs=rp)
    plain = lambda uu, rp: cg.generate_cl_vrnn_batch_plain(params, cfg, seeds, nsteps, eps, uu,
                                                           ws, return_probs=rp)
    pk, pp = kern(u1, True), plain(u1, True)
    torch.cuda.synchronize()
    err = (pk - pp).abs().max().item()
    require(torch.isfinite(pk).all().item() and pk.shape == (B, nsteps, cfg.original_dim),
            "kernel probabilities not finite or misshapen")
    print(f"f32 probs, u=1: max |kernel - plain| = {err:.3e} (limit 1e-5)")
    require(err <= 1e-5, f"f32 probabilities differ by {err}")

    fk, fp, probs = kern(u, False), plain(u, False), plain(u, True)
    torch.cuda.synchronize()
    frames_agree_to_near_tie("f32 frames", fk, fp, u[:, Tseed:], probs)

    k_ms = time_ms(lambda: kern(u, False), reps=10, warm=2)
    p_ms = time_ms(lambda: plain(u, False), reps=3, warm=1)
    _, _, b_ms, b_by = generation_line("f32", params, cfg, seeds, nsteps, eps, u, ws, "f32")
    print(f"f32 kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}) "
          f"at B={B} Tseed={Tseed} nsteps={nsteps} H={cfg.intermediate_dim}")
    generation_grid("f32", params, cfg, seeds, eps, u, ws, "f32")
    return {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by}


def phase_bf16(dev):
    import numpy as np
    import torch

    from classifying_vae_lstm_tpu_torch.models import cl_vrnn
    from classifying_vae_lstm_tpu_torch.ops import cuda_generate as cg
    from classifying_vae_lstm_tpu_torch.weights import params_from_numpy

    D, H, L, K = 88, 512, 8, 10
    cfg = cl_vrnn.Config(original_dim=D, intermediate_dim=H, latent_dim=L, seq_length=16,
                         n_classes=K, use_x_prev=True, bf16_compute=True)
    rng = np.random.default_rng(SEED + 1)

    def glorot(i, o):
        lim = np.sqrt(6.0 / (i + o))
        return rng.uniform(-lim, lim, (i, o)).astype(np.float32)

    raw = {
        "encoder_h": {"kernel": glorot(D + K, 4 * H), "recurrent_kernel": glorot(H, 4 * H),
                      "bias": np.zeros(4 * H, np.float32)},
        "decoder_h": {"kernel": glorot(D + L + K, 4 * H), "recurrent_kernel": glorot(H, 4 * H),
                      "bias": np.zeros(4 * H, np.float32)},
        "Z_mean": {"kernel": glorot(H, L), "bias": np.zeros(L, np.float32)},
        "Z_log_var": {"kernel": glorot(H, L), "bias": np.zeros(L, np.float32)},
        "X_decoded_mean": {"kernel": glorot(H, D), "bias": np.zeros(D, np.float32)},
    }
    params = params_from_numpy(raw, dev)
    B, Tseed, nsteps = 64, 32, 256
    seeds = torch.from_numpy(seed_windows(B)).to(dev)
    ws = torch.eye(K, device=dev)[torch.arange(B, device=dev) % K]
    eps = torch.from_numpy(rng.standard_normal((B, Tseed + nsteps, L), dtype=np.float32)).to(dev)
    u1 = torch.ones((B, Tseed + nsteps, D), device=dev)
    run = lambda f: f(params, cfg, seeds, nsteps, eps, u1, ws, return_probs=True, mode="bf16")
    pk, pp = run(cg.generate_cl_vrnn_batch_cuda), run(cg.generate_cl_vrnn_batch_plain)
    torch.cuda.synchronize()
    d = (pk - pp).abs()
    mx, mean = d.max().item(), d.mean().item()
    k_ms = time_ms(lambda: run(cg.generate_cl_vrnn_batch_cuda), reps=5)
    print(f"bf16 H={H} probs, u=1: max {mx:.3e} (limit 2e-2), mean {mean:.3e} (limit 2e-3); "
          f"kernel {k_ms:.3f} ms")
    require(torch.isfinite(pk).all().item(), "bf16 kernel probabilities not finite")
    require(mx <= 2e-2 and mean <= 2e-3, f"bf16 probabilities differ: max {mx}, mean {mean}")
    generation_line("bf16", params, cfg, seeds, nsteps, eps, u1, ws, "bf16")
    generation_grid("bf16 H=512", params, cfg, seeds, eps, u1, ws, "bf16")


def exercise_server(httpd, extra=()):
    """Serve ``httpd`` in a thread and drive /generate as a client would:
    /healthz, a rolls, a MIDI and a key-filtered request, the ``extra``
    (label, body) rolls requests, then a burst of 8 concurrent requests.
    Returns /stats and each request's ms on the client's clock (HTTP and
    JSON included); shuts the server down."""
    import base64

    import numpy as np

    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    client_ms = {}

    def post(body, label):
        req = urllib.request.Request(f"{url}/generate", data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=120) as r:
            require(r.status == 200, f"{label} -> HTTP {r.status}")
            out = json.load(r)
        client_ms[label] = (time.perf_counter() - t0) * 1e3
        return out

    def check_rolls(out, n, t):
        rolls = np.asarray(out["rolls"])
        require(rolls.shape == (n, t, 88), f"rolls shape {rolls.shape} != {(n, t, 88)}")
        require(set(np.unique(rolls).tolist()) <= {0, 1}, "rolls not binary")

    try:
        with urllib.request.urlopen(f"{url}/healthz", timeout=30) as r:
            require(json.load(r)["ok"], "/healthz")
        check_rolls(post({"n": 4, "t": 64}, "4x64"), 4, 64)
        out = post({"n": 16, "t": 128, "format": "midi_base64"}, "16x128 midi")
        require(len(out["midi_base64"]) == 16
                and all(base64.b64decode(m)[:4] == b"MThd" for m in out["midi_base64"]),
                "midi_base64 response")
        check_rolls(post({"n": 1, "t": 32, "key": "C"}, "1x32 key C"), 1, 32)
        for label, body in extra:
            check_rolls(post(body, label), body["n"], body["t"])
        results, errors = [None] * 8, []
        barrier = threading.Barrier(8)

        def client(i):
            try:
                barrier.wait(timeout=30)
                results[i] = post({"n": 2, "t": 64}, f"burst {i}")
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(repr(e))

        clients = [threading.Thread(target=client, args=(i,)) for i in range(8)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=120)
        require(not errors and not any(c.is_alive() for c in clients), f"burst: {errors}")
        for r in results:
            check_rolls(r, 2, 64)
        with urllib.request.urlopen(f"{url}/stats", timeout=30) as r:
            stats = json.load(r)
    finally:
        httpd.shutdown()
        httpd.server_close()
    solo = [f"{k} {v:.3f} ms" for k, v in client_ms.items() if not k.startswith("burst")]
    burst = sorted(v for k, v in client_ms.items() if k.startswith("burst"))
    print(f"client latency: {'; '.join(solo)}; burst of 8 x {{n: 2, t: 64}}: min "
          f"{burst[0]:.3f} ms, median {burst[4]:.3f} ms, max {burst[-1]:.3f} ms")
    return stats


def phase_serve():
    from classifying_vae_lstm_tpu_torch.cli import serve
    from classifying_vae_lstm_tpu_torch.ops import cuda_generate as cg

    plain_on_cuda = []
    args = serve.build_parser().parse_args(
        ["-i", MODEL, "--train_file", CORPUS, "--dynamic_batching", "--warmup", "full",
         "--port", "0"])
    with sampler_plain_guard(cg, "generate_cl_vrnn_batch_plain", plain_on_cuda):
        cg.LAUNCHES = 0  # counts from here on are the main path's
        t0 = time.perf_counter()
        httpd, engine = serve.make_server(args)
        print(f"engine built and warmed in {time.perf_counter() - t0:.2f} s "
              f"({cg.LAUNCHES} warm-up launches)")
        warm_launches = cg.LAUNCHES
        stats = exercise_server(httpd)
        launches = cg.LAUNCHES
    lat = engine.latency_stats()
    print(f"/stats: requests {stats['requests']}, batches {stats['batches']}, batched_songs "
          f"{stats['batched_songs']}, gen_path {stats['gen_path']}, device {stats['device']}")
    print(f"main path launches: {launches} ({warm_launches} warm-up, "
          f"{launches - warm_launches} for {stats['requests']} requests); "
          f"latency p50 {lat['p50_ms']:.3f} ms, p95 {lat['p95_ms']:.3f} ms "
          f"(window {args.batch_window_ms} ms)")
    require(launches > warm_launches, "requests did not launch the kernel")
    require(stats["batches"] > 0, "the burst was not coalesced (batches == 0)")
    require(not plain_on_cuda, f"plain version ran on CUDA tensors: {plain_on_cuda}")
    return launches


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def train_shape_weights(rng):
    """The trained ``jsball_vrnn4`` weights (as NumPy) with fresh glorot rows
    for the 13 key classes of the training corpus, and its config."""
    import numpy as np

    from classifying_vae_lstm_tpu_torch.cli import common

    raw, cfg0, _ = common.load_model(MODEL, "cl_vrnn")
    K, K0, H = TRAIN_K, cfg0.n_classes, cfg0.intermediate_dim
    lim = np.sqrt(6.0 / (K + 4 * H))
    w_rows = lambda: rng.uniform(-lim, lim, (K, 4 * H)).astype(np.float32)
    for cell in ("encoder_h", "decoder_h"):
        raw[cell]["kernel"] = np.concatenate([raw[cell]["kernel"][:-K0], w_rows()])
    return raw, cfg0


def phase_two_cell(dev):
    """Both two-cell kernels against their plain versions at the training
    shape; returns the kernel-table fields of each."""
    import numpy as np
    import torch

    from classifying_vae_lstm_tpu_torch.models import cl_vrnn
    from classifying_vae_lstm_tpu_torch.ops import two_cell as tc
    from classifying_vae_lstm_tpu_torch.weights import params_from_numpy

    B, T, K = TRAIN_B, TRAIN_T, TRAIN_K
    rng = np.random.default_rng(SEED + 2)
    raw, cfg0 = train_shape_weights(rng)
    D, H, L = cfg0.original_dim, cfg0.intermediate_dim, cfg0.latent_dim
    cfg = cl_vrnn.Config(original_dim=D, intermediate_dim=H, latent_dim=L, seq_length=T,
                         n_classes=K, use_x_prev=True, lstm_backend="pallas", two_cell=True)
    params = params_from_numpy(raw, dev)
    f = lambda a: torch.from_numpy(a).to(dev)
    x = f((rng.random((B, T, D)) < 0.1).astype(np.float32))
    xp = f((rng.random((B, T, D)) < 0.1).astype(np.float32))
    W = torch.softmax(f(rng.standard_normal((B, K)).astype(np.float32)), -1)
    eps = f(rng.standard_normal((B, T, L)).astype(np.float32))
    ins = tc.pack_inputs(params, cfg, x, xp, W, eps)

    outs = tc.two_cell_fwd(*ins)
    ref = tc.two_cell_fwd_plain(*ins)
    torch.cuda.synchronize()
    names = ("hd", "zargs", "ze", "zd", "hpe", "cpe", "ce", "he", "hpd", "cpd", "cd")
    errs = {n: (k - p).abs().max().item() for n, k, p in zip(names, outs, ref)}
    require(all(torch.isfinite(o).all().item() for o in outs), "forward kernel output not finite")
    fwd_err = max(errs["hd"], errs["zargs"])
    print(f"two-cell forward, B={B} T={T} H={H} L={L} K={K}: max |kernel - plain| hd "
          f"{errs['hd']:.3e}, zargs {errs['zargs']:.3e} (limit 1e-5); residual streams "
          + ", ".join(f"{n} {errs[n]:.3e}" for n in names[2:]))
    require(fwd_err <= 1e-5, f"two-cell forward differs: {errs}")
    same_bits(tc.two_cell_fwd, ins, outs, names, "two-cell forward")

    (xe, xd, eps_t, we, be, rke, wdx, bd, rkd, kz, wz, bz, *_) = ins
    hd, zargs, ze, zd, hpe, cpe, ce, he, hpd, cpd, cd = ref
    dhd = f((1e-2 * rng.standard_normal(tuple(hd.shape))).astype(np.float32))
    dza = f((1e-2 * rng.standard_normal(tuple(zargs.shape))).astype(np.float32))
    res = (ze, zd, cpe, ce, cpd, cd, hpe, he, hpd, eps_t, zargs, xe, xd, dhd, dza,
           we, rke, wdx, rkd, kz, wz)
    got = tc.two_cell_bwd(*res)
    want = tc.two_cell_bwd_plain(*res)
    torch.cuda.synchronize()
    gnames = ("dxe", "dxd", "dh0e", "dc0e", "dh0d", "dc0d", "drke", "drkd", "dwe", "dwdx", "dkz",
              "dwz", "dbe", "dbd", "dbz")
    bad, rel = [], {}
    for n, g, w in zip(gnames, got, want):
        err, scale = (g - w).abs().max().item(), w.abs().max().item()
        rel[n] = err / max(scale, 1e-30)
        if not (err <= 1e-4 * scale + 1e-6 and math.isfinite(err)):
            bad.append((n, err, scale))
    bwd_err = max((g - w).abs().max().item() for g, w in zip(got, want))
    print("two-cell backward: max |kernel - plain| / max|plain| per output: "
          + ", ".join(f"{n} {rel[n]:.2e}" for n in gnames)
          + f" (limit 1e-4 + 1e-6 abs); largest abs error {bwd_err:.3e}")
    require(not bad, f"two-cell backward differs: {bad}")
    same_bits(tc.two_cell_bwd, res, got, gnames, "two-cell backward")

    fk_ms = time_ms(lambda: tc.two_cell_fwd(*ins), reps=20, warm=2)
    fp_ms = time_ms(lambda: tc.two_cell_fwd_plain(*ins), reps=5, warm=1)
    bk_ms = time_ms(lambda: tc.two_cell_bwd(*res), reps=20, warm=2)
    bp_ms = time_ms(lambda: tc.two_cell_bwd_plain(*res), reps=5, warm=1)
    INe, INd, R = xe.shape[-1], xd.shape[-1], T * B
    weights = (we, be, rke, wdx, bd, rkd, kz, wz, bz)
    fwd_fmas = R * ((INe + H) * 4 * H + H * 2 * L + (INd + L + H) * 4 * H)
    fb_ms, fb_by = roofline_ms(fwd_fmas, _nbytes(ins) + _nbytes(outs))
    # serial chain (dz @ W^T for both cells, z head) + weight gradients and
    # column sums over the B*T rows
    bwd_fmas = R * (4 * H * (H + INd + L) + 2 * L * H + 4 * H * (H + INe)
                    + 4 * H * (2 * H + INe + INd + L + 2) + 2 * L * (H + 1))
    bb_ms, bb_by = roofline_ms(bwd_fmas, _nbytes(res) + _nbytes(got))
    print(f"two-cell forward kernel {fk_ms:.3f} ms, plain {fp_ms:.3f} ms, bound {fb_ms:.4f} ms "
          f"({fb_by}); backward kernel {bk_ms:.3f} ms, plain {bp_ms:.3f} ms, "
          f"bound {bb_ms:.4f} ms ({bb_by})")
    print("two-cell forward, device time: "
          + device_split(lambda: tc.two_cell_fwd(*ins), 10, TWO_CELL_FWD_PARTS))
    print("two-cell backward, device time: "
          + device_split(lambda: tc.two_cell_bwd(*res), 10, TWO_CELL_BWD_PARTS)
          + f"; HMMA per f32 kernel (FFMA only, no TF32): {hmma_counts('two_cell_tc', TWO_CELL_F32)}")
    return ({"max_abs_err": fwd_err, "ms": fk_ms, "plain_ms": fp_ms, "bound_ms": fb_ms,
             "bound_by": fb_by},
            {"max_abs_err": bwd_err, "ms": bk_ms, "plain_ms": bp_ms, "bound_ms": bb_ms,
             "bound_by": bb_by})


TRAIN_FLAGS = ["--train_file", CORPUS, "--intermediate_dim", "256", "--latent_dim", "8",
               "--seq_length", "16", "--batch_size", "200", "--use_x_prev", "--class_weight",
               "0.3", "--patience", "0", "--lstm_backend", "pallas"]


@contextlib.contextmanager
def plain_guard(module, names, record):
    """Record every call of the named plain versions on a CUDA tensor."""
    real = {n: getattr(module, n) for n in names}

    def guard(name):
        def guarded(*a):
            if a[0].is_cuda:
                record.append(name)
            return real[name](*a)
        return guarded

    for n in names:
        setattr(module, n, guard(n))
    try:
        yield
    finally:
        for n, fn in real.items():
            setattr(module, n, fn)


@contextlib.contextmanager
def sampler_plain_guard(module, name, record):
    """Record every call of a sampler's plain version (``fn(params, cfg,
    x_seeds, ...)``) on a CUDA tensor."""
    real = getattr(module, name)

    def guarded(params, cfg, x_seeds, *a, **k):
        if x_seeds.is_cuda:
            record.append((name, tuple(x_seeds.shape)))
        return real(params, cfg, x_seeds, *a, **k)

    setattr(module, name, guarded)
    try:
        yield
    finally:
        setattr(module, name, real)


@contextlib.contextmanager
def recorded_modes(module):
    """Record every mode a generation wrapper of ``module`` resolves (one
    per call on CUDA tensors)."""
    modes, real = [], module._resolve_mode

    def resolve_mode(cfg, mode):
        modes.append(real(cfg, mode))
        return modes[-1]

    module._resolve_mode = resolve_mode
    try:
        yield modes
    finally:
        module._resolve_mode = real


def run_train(run, flags, model_dir, reset, read, cli=None, base_flags=TRAIN_FLAGS,
              overrides=None):
    """One run of a train CLI (``cli.cl_vrnn_train`` at the jsball_vrnn4
    width unless ``cli`` and ``base_flags`` say otherwise). ``overrides``
    are set on the parsed namespace (fields the CLI has no flag for, as the
    JAX package's ``--lstm_backend auto`` sets ``bf16_compute``). ``reset``
    sets the launch counts to 0 just before the run, ``read`` returns them
    just after. Returns (args, counts, seen, per-epoch seconds, wall)."""
    import torch

    from classifying_vae_lstm_tpu_torch.cli import cl_vrnn_train
    from classifying_vae_lstm_tpu_torch.train import loop

    cli = cli or cl_vrnn_train
    seen, epoch_s = {}, []
    real_fit, real_epoch = cli.fit, loop.Trainer.train_epoch

    def fit(trainer, params, train_data, val_data, **kw):
        seen.update(trainer=trainer, train=train_data, val=val_data, fit_kw=kw)
        out = real_fit(trainer, params, train_data, val_data, **kw)
        seen.update(final_params=out[0], best_params=out[1], history=out[2])
        return out

    def train_epoch(self, *a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = real_epoch(self, *a, **k)
        torch.cuda.synchronize()
        epoch_s.append(time.perf_counter() - t0)
        return m

    args = cli.build_parser().parse_args([run, *base_flags, *flags, "--model_dir", model_dir])
    for k, v in (overrides or {}).items():
        setattr(args, k, v)
    cli.fit, loop.Trainer.train_epoch = fit, train_epoch
    reset()  # counts from here on are this training path's
    t0 = time.perf_counter()
    try:
        cli.train(args)
    finally:
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read()
        cli.fit, loop.Trainer.train_epoch = real_fit, real_epoch
    seen["ckpt"] = os.path.join(model_dir, f"{run}.npz")
    return args, counts, seen, epoch_s, wall


def _report_train(label, args, seen, epoch_s, wall):
    hist, B, E = seen["history"], args.batch_size, args.num_epochs
    n_train, n_val = (len(seen[k]["x"]) // B for k in ("train", "val"))
    print(f"{label}: {E} epochs x ({n_train} train + {n_val} eval steps) in {wall:.2f} s; "
          f"loss per epoch {[round(v, 4) for v in hist['loss']]}, val_loss "
          f"{[round(v, 4) for v in hist['val_loss']]}")
    print(f"{label}: ms per training step (host clock, epoch synchronised): "
          f"{[round(s * 1e3 / n_train, 3) for s in epoch_s]} per epoch")
    require(all(math.isfinite(v) for vals in hist.values() for v in vals), "non-finite loss")
    require(E < 2 or hist["loss"][-1] < hist["loss"][0],
            f"train loss did not fall: {hist['loss']}")
    return E, n_train, n_val


def phase_train(model_dir):
    """The training path through ``cli.cl_vrnn_train``; returns the launch
    counts, the checkpoint written and what the time split needs."""
    from classifying_vae_lstm_tpu_torch.ops import two_cell as tc

    def reset():
        tc.FWD_LAUNCHES = tc.BWD_LAUNCHES = 0

    plain_on_cuda = []
    with plain_guard(tc, ("two_cell_fwd_plain", "two_cell_bwd_plain"), plain_on_cuda):
        args, (fwd, bwd), seen, epoch_s, wall = run_train(
            "smoke", ["--num_epochs", "3"], model_dir, reset,
            lambda: (tc.FWD_LAUNCHES, tc.BWD_LAUNCHES))
    E, n_train, n_val = _report_train("training path", args, seen, epoch_s, wall)
    print(f"training path launches: forward {fwd} (expected {E * (n_train + n_val)}), "
          f"backward {bwd} (expected {2 * E * n_train}: the reverse walk and the "
          f"weight-gradient pass per step)")
    require(fwd == E * (n_train + n_val), f"forward launches {fwd}")
    require(bwd == 2 * E * n_train, f"backward launches {bwd}")
    require(not plain_on_cuda, f"plain two-cell versions ran on CUDA tensors: {plain_on_cuda}")
    seen.update(step_ms=epoch_s[-1] * 1e3 / n_train)
    return fwd, bwd, seen


# the whole-sequence LSTM counts of ops/lstm_seq.py (<name>_LAUNCHES): the
# default rung's inference forward, training forward and backward, the other
# rungs' unfused forwards, dz-only walk and drk walk, bf16 and f32; then the
# f32 two-cell counts
LSTM_SEQ_COUNTS = tuple(f"{m}{k}" for m in ("BF16_", "") for k in (
    "FWD", "TRAIN_FWD", "BWD", "XZ_FWD", "XZ_TRAIN_FWD", "WALK", "DRK"))
LSTM_COUNTS = LSTM_SEQ_COUNTS + ("TWO_CELL_FWD", "TWO_CELL_BWD")


def _lstm_counts() -> dict:
    from classifying_vae_lstm_tpu_torch.ops import lstm_seq as ls
    from classifying_vae_lstm_tpu_torch.ops import two_cell as tc

    counts = {n: getattr(ls, f"{n}_LAUNCHES") for n in LSTM_SEQ_COUNTS}
    counts.update(TWO_CELL_FWD=tc.FWD_LAUNCHES, TWO_CELL_BWD=tc.BWD_LAUNCHES)
    return counts


def lstm_expected(**counts) -> dict:
    """The counts of :func:`_lstm_counts` a run must leave: the named ones,
    every other 0."""
    require(set(counts) <= set(LSTM_COUNTS), f"unknown counts {sorted(counts)}")
    return {n: counts.get(n, 0) for n in LSTM_COUNTS}


def nonzero(counts: dict) -> dict:
    """The counts that are not 0 (every other is)."""
    return {n: v for n, v in counts.items() if v}


def _reset_lstm_counts():
    from classifying_vae_lstm_tpu_torch.ops import lstm_seq as ls
    from classifying_vae_lstm_tpu_torch.ops import two_cell as tc

    for n in LSTM_SEQ_COUNTS:
        setattr(ls, f"{n}_LAUNCHES", 0)
    tc.FWD_LAUNCHES = tc.BWD_LAUNCHES = 0


def _evaluate_counted(argv):
    """``cli.evaluate`` of ``argv`` with the LSTM counts set to 0 just
    before; returns (printed result, counts (:func:`_lstm_counts`), mean NLL
    over the windows, the estimator's recorded call and its seconds, wall
    seconds)."""
    import torch

    from classifying_vae_lstm_tpu_torch.cli import evaluate

    calls, real_nll = [], evaluate.iw_nll_dataset

    def spy(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_nll(*a, **k)
        torch.cuda.synchronize()
        calls.append({"args": a, "nlls": out, "s": time.perf_counter() - t0})
        return out

    evaluate.iw_nll_dataset = spy
    try:
        _reset_lstm_counts()
        t0 = time.perf_counter()
        out = evaluate.evaluate(evaluate.build_parser().parse_args(argv))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _lstm_counts()
    finally:
        evaluate.iw_nll_dataset = real_nll
    return out, counts, calls[-1]["nlls"].double().mean().item(), calls[-1], wall


def phase_train_two_loop(model_dir, first_loss):
    """The ``--two_cell off`` training path: both LSTMs through the
    whole-sequence kernels. Returns the training-forward and backward
    launch counts and what the run left (its checkpoint among them)."""
    from classifying_vae_lstm_tpu_torch.ops import lstm_seq as ls
    from classifying_vae_lstm_tpu_torch.ops import two_cell as tc
    from classifying_vae_lstm_tpu_torch.train.checkpoint import load_model_args

    plain_on_cuda = []
    with plain_guard(ls, LSTM_SEQ_PLAIN, plain_on_cuda), \
            plain_guard(tc, ("two_cell_fwd_plain", "two_cell_bwd_plain"), plain_on_cuda):
        args, counts, seen, epoch_s, wall = run_train(
            "smoke_off", ["--num_epochs", "2", "--two_cell", "off"], model_dir,
            _reset_lstm_counts, _lstm_counts)
    E, n_train, n_val = _report_train("--two_cell off path", args, seen, epoch_s, wall)
    train_fwd, bwd = counts["TRAIN_FWD"], counts["BWD"]
    expected = lstm_expected(FWD=2 * E * n_val, TRAIN_FWD=2 * E * n_train, BWD=4 * E * n_train)
    print(f"--two_cell off launches {nonzero(counts)} (expected {nonzero(expected)}, every other "
          f"count 0; per train batch 2 training forwards and 2 x 2 backward launches, per eval "
          f"batch 2 inference forwards)")
    require(counts == expected, f"--two_cell off launches {counts} != {expected}")
    require(not plain_on_cuda, f"plain versions ran on CUDA tensors: {plain_on_cuda}")
    loss0 = seen["history"]["loss"][0]
    rel = abs(loss0 - first_loss) / abs(first_loss)
    print(f"first epoch train loss: two-loop {loss0!r}, two-cell (phase 6) {first_loss!r}, "
          f"relative difference {rel:.3e} (limit 1e-3)")
    require(rel <= 1e-3, f"first-epoch losses differ by {rel}")
    margs = load_model_args(seen["ckpt"])
    require((margs["lstm_backend"], margs["two_cell"], margs["fusion"])
            == ("pallas", False, [True, True, True]), f"args.json {margs}")
    return train_fwd, bwd, seen


def phase_train_breakdown(seen, label="two-cell kernels", key="two_cell", split=None):
    """Where a training step's time goes: CUDA events around the forward
    (loss), the backward and the optimizer step; then a profiler's device
    time per kernel, where it records one (``label``: the kernels whose
    name holds ``key``; ``split``: device ms of named kernel groups, as
    :func:`device_split`). Informational."""
    import torch

    from classifying_vae_lstm_tpu_torch.train.loop import copy_params

    trainer = seen["trainer"]
    params = copy_params(seen["best_params"], requires_grad=True)
    opt = trainer.init_optimizer(params)
    B = trainer.batch_size
    batch = {k: v[:B] for k, v in seen["train"].items()}
    gen = torch.Generator(device=batch["x"].device).manual_seed(SEED)

    def step(ev=None):
        opt.zero_grad(set_to_none=True)
        if ev:
            ev[0].record()
        loss, _ = trainer.loss_fn(params, batch, gen, 1.0, 0.3, 1.0)
        if ev:
            ev[1].record()
        loss.backward()
        if ev:
            ev[2].record()
        opt.step()
        if ev:
            ev[3].record()

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    n, parts = 10, [0.0, 0.0, 0.0]
    t0 = time.perf_counter()
    for _ in range(n):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        step(ev)
        torch.cuda.synchronize()
        for i in range(3):
            parts[i] += ev[i].elapsed_time(ev[i + 1]) / n
    wall = (time.perf_counter() - t0) * 1e3 / n
    print(f"training step at B={B}: {wall:.3f} ms (host clock, synchronised); CUDA events: "
          f"forward + loss {parts[0]:.3f} ms, backward {parts[1]:.3f} ms, optimizer "
          f"{parts[2]:.3f} ms")
    device_profile(step, 5, wall, "step", label, key)
    if split:
        print(f"{label}, device ms a step: " + device_split(step, 5, split))


def _device_rows(fn, n):
    """``torch.profiler``'s device-side events over n calls of ``fn`` (host
    ranges and their device-side annotations report the same device time
    again, so they are left out) and their device time in µs."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    dev_us = lambda e: getattr(e, "self_device_time_total", 0.0) or 0.0
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and dev_us(e) > 0
            and not getattr(e, "is_user_annotation", False)]
    return sorted(rows, key=dev_us, reverse=True), dev_us


def device_profile(fn, n, wall_ms, unit, label, key):
    """Device time per call of ``fn`` from ``torch.profiler`` over n calls:
    busy share against ``wall_ms`` and the time of the kernels whose name
    holds ``key``. Informational: prints "not measured" where the profiler
    records no device time."""
    try:
        rows, dev_us = _device_rows(fn, n)
        if not rows:
            print("profiler: no device time recorded (device busy share not measured)")
            return
        busy = sum(dev_us(e) for e in rows) / (n * 1e3)
        ours = sum(dev_us(e) for e in rows if key in e.key) / (n * 1e3)
        print(f"profiler, per {unit}: device busy {busy:.3f} ms of {wall_ms:.3f} ms "
              f"({100 * (1 - busy / wall_ms):.1f}% idle), {label} {ours:.3f} ms, "
              f"{sum(e.count for e in rows) // n} device events; top: "
              + "; ".join(f"{e.key[:48]} {dev_us(e) / (n * 1e3):.3f} ms x{e.count // n}"
                          for e in rows[:8]))
    except Exception as e:  # noqa: BLE001 — the caller's numbers stand without it
        print(f"profiler: not measured ({e!r})")


def device_ms_per_call(fn, n, key, launches=None):
    """(device ms per call of the kernels whose name holds ``key``, device
    ms per call of all kernels) from ``torch.profiler`` over n calls of
    ``fn`` after one warm-up call; None where it records no device time, or
    where ``launches`` (the launches of those kernels a call) is given and
    the profiler kept another number than n x launches of them."""
    import torch

    try:
        fn()
        torch.cuda.synchronize()
        rows, dev_us = _device_rows(fn, n)
        if not rows:
            return None
        kept = sum(e.count for e in rows if key in e.key)
        if launches is not None and kept != n * launches:
            print(f"profiler: not measured (it kept {kept} of the {n * launches} launches of "
                  f"{key})")
            return None
        per = lambda es: sum(dev_us(e) for e in es) / (n * 1e3)
        return per(e for e in rows if key in e.key), per(rows)
    except Exception as e:  # noqa: BLE001 — the CUDA-event times stand without it
        print(f"profiler: not measured ({e!r})")
        return None


# the bf16 full backward's parts, by kernel name: the walk (gate gradients
# and step products), the dRk product, the dW / db pass
BWD_PARTS = {"walk": ("lstm_tc_bwd_gates", "lstm_tc_bwd_step"), "dRk": ("lstm_tc_drk",),
             "dW/db": ("wgrad_kernel",)}


def device_split(fn, n, parts, count=None):
    """Device ms per call of ``fn`` by part (kernels whose name holds one of
    the part's keys) from ``torch.profiler`` over n calls after a warm-up,
    as a printable string, with the device launches a call of the kernels
    whose name holds ``count`` where it is given; "not measured" where it
    records none."""
    import torch

    try:
        fn()
        torch.cuda.synchronize()
        rows, dev_us = _device_rows(fn, n)
    except Exception as e:  # noqa: BLE001 — the CUDA-event times stand without it
        return f"not measured ({e!r})"
    if not rows:
        return "not measured"
    per = lambda keys: sum(dev_us(e) for e in rows if any(k in e.key for k in keys)) / (n * 1e3)
    text = ", ".join(f"{p} {per(keys):.3f} ms" for p, keys in parts.items()) + \
        f" (all kernels {sum(dev_us(e) for e in rows) / (n * 1e3):.3f} ms)"
    if count:
        text += (f"; {sum(e.count for e in rows if count in e.key) / n:g} device launches a "
                 f"call of its {count}* kernels")
    return text


# the f32 walks of the dz-only and drk rungs (csrc/lstm_bwd_f32.cu): the
# walk's per-step products with the gates, and the drk rung's row-split dRk
F32_WALK_PARTS = {"walk": ("lstm_bwd_walk",), "dRk": ("lstm_bwd_wgrad",)}
# the f32 full backward's parts (csrc/lstm_bwd_f32.cu), by kernel name: the
# walk's per-step products with the gates, dx, dRk / dW and db
LSTM_BWD_PARTS = {"walk": ("lstm_bwd_walk",), "dx": ("lstm_bwd_dx",),
                  "weight gradients": ("wgrad_",)}
# the bf16 dense-stack backward's parts (csrc/vae_dense_tc.cu): the wide
# row-chain products, the head and the two narrow row kernels, the weight
# gradients (wide on the tensor cores, narrow and the bias sums)
VAE_TC_PARTS = {"row-chain products": ("vae_tc_product",),
                "row kernels": ("vae_tc_head", "vae_tc_latent", "vae_tc_key"),
                "weight gradients": ("vae_tc_dw", "wgrad_"),
                "of which narrow and bias sums": ("wgrad_",)}
# the bf16 dense-stack forward's parts (csrc/vae_dense_tc.cu): the two
# product launches (the x-side products, the frame head), the narrow chain
VAE_TC_FWD_PARTS = {"products": ("vae_tc_product",), "row kernel": ("vae_tc_fwd_rows",)}
# a bf16 cl_vae training step's dense-stack kernels by part (phase 19)
VAE_STEP_PARTS = {"forward row kernel": ("vae_tc_fwd_rows",),
                  "products, both directions": ("vae_tc_product",),
                  "backward row kernels": ("vae_tc_head", "vae_tc_latent", "vae_tc_key"),
                  "weight gradients": ("vae_tc_dw", "wgrad_")}

# the two-cell backward's parts, by kernel name: the serial walk (the
# per-step products with the decoder's gates, and the z hand-off with the
# encoder's gates), the hoisted dx products, the weight gradients
TWO_CELL_BWD_PARTS = {"walk": ("two_cell_walk", "two_cell_handoff"),
                      "of which z hand-off": ("two_cell_handoff",), "dx": ("two_cell_dx",),
                      "weight gradients": ("two_cell_dw", "wgrad_"),
                      "of which dKz, dWz, bias sums": ("two_cell_dw_narrow",)}


# the two-cell forward's parts (csrc/two_cell.cu): the operands' layouts,
# the T + 1 walk steps
TWO_CELL_FWD_PARTS = {"layouts": ("two_cell_layout",), "walk": ("two_cell_step",)}


def same_bits(fn, args, first, names, label):
    """A second call of ``fn`` gives every output bit for bit as ``first``:
    each sum is taken in a fixed order, with no atomics."""
    import torch

    again = fn(*args)
    torch.cuda.synchronize()
    differ = [n for n, a, b in zip(names, first, again) if not torch.equal(a, b)]
    print(f"{label}: a second call is bitwise equal in every output: {not differ}")
    require(not differ, f"{label}: repeated calls differ in {differ}")


def phase_checkpoint_serves(ckpt):
    """The trained checkpoint serves through the generation kernel."""
    import numpy as np

    from classifying_vae_lstm_tpu_torch.cli import serve
    from classifying_vae_lstm_tpu_torch.ops import cuda_generate as cg

    args = serve.build_parser().parse_args(["-i", ckpt, "--train_file", CORPUS,
                                            "--warmup", "off"])
    engine = serve.build_engine(args)[0]
    before = cg.LAUNCHES
    rolls = engine.generate(n=4, nsteps=64)
    require(rolls.shape == (4, 64, 88) and set(np.unique(rolls).tolist()) <= {0, 1},
            f"songs from the trained checkpoint: shape {rolls.shape}")
    require(cg.LAUNCHES > before, "the trained checkpoint did not generate through the kernel")
    print(f"trained checkpoint {ckpt}: 4 songs x 64 frames through the generation kernel, "
          f"{int(rolls.sum())} notes on")


FWD_LIMIT = 1e-5


def fwd_outside(errs, ref):
    """The forward outputs whose kernel-vs-plain error exceeds the limit: h
    (|h| < 1) within 1e-5; c and z, which grow without bound over the steps,
    within 1e-5 x max(1, max|plain|), the same f32 rounding at their scale."""
    bad = {}
    for name, err in errs.items():
        key = name.split()[-1]
        scale = 1.0 if key in ("h", "h_prev") else max(1.0, ref[key].abs().max().item())
        if not (err <= FWD_LIMIT * scale and math.isfinite(err)):
            bad[name] = (err, scale)
    return bad


def _lstm_inputs(rng, dev, raw_cell, B, T, D, H):
    """A cell's weights and a time-major input batch: binary frames in the
    first D columns (the corpus's density), the rest (key weights, z)
    Gaussian; zero initial state, as the model runs it."""
    import numpy as np
    import torch

    from classifying_vae_lstm_tpu_torch.weights import params_from_numpy

    p = params_from_numpy(raw_cell, dev)
    IN = p["kernel"].shape[0]
    x = np.concatenate([(rng.random((T, B, D)) < 0.1).astype(np.float32),
                        (0.5 * rng.standard_normal((T, B, IN - D))).astype(np.float32)], -1)
    zeros = torch.zeros((B, H), device=dev)
    return (torch.from_numpy(x).to(dev), p["kernel"], p["bias"], p["recurrent_kernel"], zeros,
            zeros)


def fwd_layout(ls, B, IN, H) -> str:
    """The f32 forward's plan at (B, IN, H) on this card, printable."""
    import torch

    p = ls.card_plan(B, IN, H, torch.device("cuda", 0))
    return (f"{p['groups']} groups of {p['NB']} blocks (one cooperative launch) owning "
            f"{p['nu']} units each, {p['rpg']} rows a group in tiles of "
            f"{ls.fwd_tile_rows(p['nu'], p['rt'])} ({p['rt']} a thread), the [W ; Rk] slice "
            f"{'resident' if p['resident'] else 'streamed'}")


def phase_lstm_seq(dev):
    """The three whole-sequence LSTM kernels against their plain versions:
    all three at the training shape (both cells; the backward on the
    transposed views of Rk and W that ``LstmSeqCore`` passes, twice, bitwise
    equal), the inference forward at the evaluation shape (both cells).
    Returns the kernel-table fields of each, from the encoder cell."""
    import numpy as np
    import torch

    from classifying_vae_lstm_tpu_torch.cli import common
    from classifying_vae_lstm_tpu_torch.ops import lstm_seq as ls

    rng = np.random.default_rng(SEED + 3)
    raw13, cfg = train_shape_weights(rng)
    raw10, _, _ = common.load_model(MODEL, "cl_vrnn")
    D, H = cfg.original_dim, cfg.intermediate_dim
    H4 = 4 * H
    fwd_fmas = lambda T, B, IN: T * B * (IN + H) * H4
    table = {}
    for cell in ("encoder_h", "decoder_h"):
        B, T = TRAIN_B, TRAIN_T
        ins = _lstm_inputs(rng, dev, raw13[cell], B, T, D, H)
        x, w, b, rk, _, _ = ins
        IN = x.shape[-1]
        before = (ls.FWD_LAUNCHES, ls.TRAIN_FWD_LAUNCHES)
        got = ls.lstm_seq_train_fwd(*ins)
        inf = ls.lstm_seq_fwd(*ins)
        ref = ls.lstm_seq_train_fwd_plain(*ins)
        torch.cuda.synchronize()
        require((ls.FWD_LAUNCHES, ls.TRAIN_FWD_LAUNCHES) == (before[0] + 1, before[1] + 1),
                "the f32 forwards were not counted once a call")
        print(f"lstm_seq {cell} f32 forward layout: {fwd_layout(ls, B, IN, H)}")
        same_bits(ls.lstm_seq_train_fwd, ins, got, ("h", "c", "z", "h_prev", "c_prev"),
                  f"lstm_seq {cell} f32 training forward")
        same_bits(ls.lstm_seq_fwd, ins, inf, ("h", "c"), f"lstm_seq {cell} f32 inference forward")
        names = ("h", "c", "z", "h_prev", "c_prev")
        errs = {n: (k - p).abs().max().item() for n, k, p in zip(names, got, ref)}
        errs.update({f"inference {n}": (k - p).abs().max().item()
                     for n, k, p in zip(names, inf, ref)})
        require(all(torch.isfinite(o).all().item() for o in got + inf),
                "LSTM forward kernel output not finite")
        bad = fwd_outside(errs, dict(zip(names, ref)))
        print(f"lstm_seq {cell} at B={B} T={T} IN={IN} H={H}: max |kernel - plain| "
              + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
              + f" (limit {FWD_LIMIT}, for c and z {FWD_LIMIT} x max(1, max|plain|): max|plain| "
              f"c {ref[1].abs().max().item():.3f}, z {ref[2].abs().max().item():.3f})")
        require(not bad, f"LSTM forward differs: {bad}")
        h, c, z, hp, cp = ref
        dh = torch.from_numpy((1e-2 * rng.standard_normal(tuple(h.shape))).astype(np.float32))
        dc = torch.zeros_like(dh)
        dc[-1] = torch.from_numpy((1e-2 * rng.standard_normal((B, H))).astype(np.float32))
        res = (z, cp, c, hp, x, dh.to(dev), dc.to(dev), rk.T, w.T)
        bgot = ls.lstm_seq_bwd(*res)
        bwant = ls.lstm_seq_bwd_plain(*res)
        torch.cuda.synchronize()
        same_bits(ls.lstm_seq_bwd, res, bgot, ("dx", "dh0", "dc0", "drk", "dw", "db"),
                  f"lstm_seq {cell} f32 backward")
        bad, rel = [], {}
        for n, g, wv in zip(("dx", "dh0", "dc0", "drk", "dw", "db"), bgot, bwant):
            err, scale = (g - wv).abs().max().item(), wv.abs().max().item()
            rel[n] = err / max(scale, 1e-30)
            if not (err <= 1e-4 * scale + 1e-6 and math.isfinite(err)):
                bad.append((n, err, scale))
        bwd_err = max((g - wv).abs().max().item() for g, wv in zip(bgot, bwant))
        print(f"lstm_seq {cell} backward: max |kernel - plain| / max|plain| "
              + ", ".join(f"{n} {v:.2e}" for n, v in rel.items())
              + f" (limit 1e-4 + 1e-6 abs); largest abs error {bwd_err:.3e}")
        require(not bad, f"LSTM backward differs: {bad}")

        # the two forwards in turns (inference, training, training, inference)
        ik = time_ms(lambda: ls.lstm_seq_fwd(*ins), reps=20, warm=2)
        tk = time_ms(lambda: ls.lstm_seq_train_fwd(*ins), reps=20, warm=2)
        tk2 = time_ms(lambda: ls.lstm_seq_train_fwd(*ins), reps=20, warm=2)
        ik2 = time_ms(lambda: ls.lstm_seq_fwd(*ins), reps=20, warm=2)
        tp = time_ms(lambda: ls.lstm_seq_train_fwd_plain(*ins), reps=5)
        bk = time_ms(lambda: ls.lstm_seq_bwd(*res), reps=20, warm=2)
        bp = time_ms(lambda: ls.lstm_seq_bwd_plain(*res), reps=5)
        tb_ms, tb_by = roofline_ms(fwd_fmas(T, B, IN), _nbytes(ins) + _nbytes(got))
        # the serial chain dz @ [Rk | W]ᵀ, then dRk, dW and db over T*B rows
        bb_ms, bb_by = roofline_ms(T * B * H4 * (2 * (H + IN) + 1), _nbytes(res) + _nbytes(bgot))
        print(f"lstm_seq {cell} at the training shape: training forward {tk:.3f} / {tk2:.3f} ms "
              f"(plain {tp:.3f}, bound {tb_ms:.4f} {tb_by}); inference forward {ik:.3f} / "
              f"{ik2:.3f} ms; backward "
              f"({T + 5} device launches) {bk:.3f} ms (plain {bp:.3f}, bound {bb_ms:.4f} "
              f"{bb_by}); device: {device_split(lambda: ls.lstm_seq_bwd(*res), 10, LSTM_BWD_PARTS)}; "
              f"HMMA per kernel {hmma_counts('lstm_bwd_f32', LSTM_BWD_F32)} (FFMA only)")
        if cell == "encoder_h":
            table["train_fwd"] = {"max_abs_err": max(errs.values()), "ms": tk, "plain_ms": tp,
                                  "bound_ms": tb_ms, "bound_by": tb_by}
            table["bwd"] = {"max_abs_err": bwd_err, "ms": bk, "plain_ms": bp, "bound_ms": bb_ms,
                            "bound_by": bb_by}

    for cell in ("encoder_h", "decoder_h"):
        B, T = EVAL_SAMPLES * EVAL_B, TRAIN_T
        ins = _lstm_inputs(rng, dev, raw10[cell], B, T, D, H)
        IN = ins[0].shape[-1]
        before = ls.FWD_LAUNCHES
        got = ls.lstm_seq_fwd(*ins)
        ref = ls.lstm_seq_fwd_plain(*ins)
        torch.cuda.synchronize()
        require(ls.FWD_LAUNCHES == before + 1, "the f32 inference forward was not counted")
        print(f"lstm_seq {cell} f32 forward layout at the evaluation shape: "
              f"{fwd_layout(ls, B, IN, H)}")
        same_bits(ls.lstm_seq_fwd, ins, got, ("h", "c"),
                  f"lstm_seq {cell} f32 inference forward at the evaluation shape")
        errs = {n: (k - p).abs().max().item() for n, k, p in zip(("h", "c"), got, ref)}
        err = max(errs.values())
        require(all(torch.isfinite(o).all().item() for o in got), "LSTM forward not finite")
        bad = fwd_outside(errs, {"h": ref[0], "c": ref[1]})
        require(not bad, f"LSTM inference forward differs at the evaluation shape: {bad}")
        k_ms = time_ms(lambda: ls.lstm_seq_fwd(*ins), reps=5, warm=1)
        p_ms = time_ms(lambda: ls.lstm_seq_fwd_plain(*ins), reps=3, warm=1)
        b_ms, b_by = roofline_ms(fwd_fmas(T, B, IN), _nbytes(ins) + _nbytes(got))
        print(f"lstm_seq {cell} inference forward at the evaluation shape (B={B} T={T} IN={IN} "
              f"H={H}): max |kernel - plain| h {errs['h']:.3e}, c {errs['c']:.3e} (max|plain| c "
              f"{ref[1].abs().max().item():.3f}); kernel {k_ms:.3f} ms, "
              f"plain {p_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by})")
        if cell == "encoder_h":
            table["fwd"] = {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                            "bound_by": b_by}
    return table


def phase_evaluate(ckpt):
    """The evaluation path through ``cli.evaluate``: the trained model on
    ``Piano-midi_Cs`` through the inference kernel, then plain PyTorch on
    the card with the same seed, then the ``--two_cell off`` checkpoint on
    the training corpus. Returns the first run's inference-forward
    launches and its NLL."""
    from classifying_vae_lstm_tpu_torch.data import PianoData
    from classifying_vae_lstm_tpu_torch.ops import lstm_seq as ls

    argv = lambda model, corpus, backend: [
        "-i", model, "--train_file", corpus, "--lstm_backend", backend, "--n_samples",
        str(EVAL_SAMPLES), "--batch_size", str(EVAL_B)]
    plain_on_cuda = []
    with plain_guard(ls, LSTM_SEQ_PLAIN, plain_on_cuda):
        out_k, counts_k, nll_k, est_k, wall_k = _evaluate_counted(
            argv(MODEL, EVAL_CORPUS, "pallas"))
        out_x, counts_x, nll_x, est_x, wall_x = _evaluate_counted(argv(MODEL, EVAL_CORPUS, "xla"))
        out_c, counts_c, nll_c, _, wall_c = _evaluate_counted(argv(ckpt, CORPUS, "keep"))
    f32_fwd = lambda n: lstm_expected(FWD=2 * -(-n // EVAL_B))
    print(f"evaluate jsball_vrnn4 on {EVAL_CORPUS} ({out_k['n_test_examples']} windows, "
          f"{EVAL_SAMPLES} samples, batches of {EVAL_B}): --lstm_backend pallas NLL "
          f"{nll_k!r} nats/frame (printed {out_k['test_nll_nats_per_frame']}), wall "
          f"{wall_k:.3f} s, estimator {est_k['s']:.3f} s; --lstm_backend xla NLL {nll_x!r} "
          f"(printed {out_x['test_nll_nats_per_frame']}), wall {wall_x:.3f} s, estimator "
          f"{est_x['s']:.3f} s; |difference| {abs(nll_k - nll_x):.3e} (limit 1e-4)")
    print(f"evaluation launches: pallas {nonzero(counts_k)}, xla {nonzero(counts_x)} (expected "
          f"{nonzero(f32_fwd(EVAL_WINDOWS))} and none, every other count 0); the 12,800-row "
          f"forward's layout: {fwd_layout(ls, EVAL_SAMPLES * EVAL_B, 106, 256)}")
    require(out_k["n_test_examples"] == out_x["n_test_examples"] == EVAL_WINDOWS,
            f"test windows {out_k['n_test_examples']}, {out_x['n_test_examples']}")
    require(counts_k == f32_fwd(EVAL_WINDOWS), f"evaluation launches {counts_k}")
    require(not any(counts_x.values()), f"xla evaluation launched kernels: {counts_x}")
    require(math.isfinite(nll_k) and abs(nll_k - nll_x) <= 1e-4,
            f"pallas and xla NLLs differ: {nll_k} vs {nll_x}")

    P = PianoData(CORPUS, batch_size=1, seq_length=TRAIN_T, return_y_next=True,
                  return_y_hist=True, squeeze_x=False, squeeze_y=False)
    n = len(P.x_test)
    print(f"evaluate the --two_cell off checkpoint on {CORPUS}: {out_c} (NLL {nll_c!r}), "
          f"wall {wall_c:.3f} s, launches {nonzero(counts_c)}")
    require(out_c["n_test_examples"] == n, f"test windows {out_c['n_test_examples']} != {n}")
    require(counts_c == f32_fwd(n), f"launches {counts_c}")
    require(math.isfinite(nll_c), "non-finite NLL")
    require(not plain_on_cuda, f"plain LSTM versions ran on CUDA tensors: {plain_on_cuda}")

    profile_eval_batch(est_k)
    return counts_k["FWD"], nll_k


def profile_eval_batch(est):
    """Where one evaluation batch's time goes: host clock around the
    estimator on the first batch of a recorded ``iw_nll_dataset(params,
    cfg, data, generator, n_samples, ...)`` call, and the profiler's device
    time."""
    import torch

    from classifying_vae_lstm_tpu_torch.evaluation.nll import iw_nll_cl_vrnn

    params, cfg, data, _, n_samples = est["args"][:5]
    batch = {k: v[:EVAL_B] for k, v in data.items()}
    gen = torch.Generator(device=batch["x"].device).manual_seed(SEED)

    def one_batch():
        with torch.no_grad():
            iw_nll_cl_vrnn(params, cfg, batch["x"], batch["y"], gen, n_samples,
                           batch.get("x_prev"))

    one_batch()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        one_batch()
    torch.cuda.synchronize()
    batch_ms = (time.perf_counter() - t0) * 1e3 / 3
    print(f"one evaluation batch ({n_samples} x {EVAL_B} rows, H={cfg.intermediate_dim}, "
          f"bf16 {cfg.bf16_compute}): {batch_ms:.3f} ms (host clock, synchronised)")
    device_profile(one_batch, 3, batch_ms, "evaluation batch", "LSTM kernels", "lstm_seq")


def vae_bound_ms(cfg, B, nsteps, weight_bytes, peak=PEAK_F32_FLOPS) -> tuple[float, str]:
    """Least time for one cl_vae generation call: its FMAs per song-step
    (encoder x rows, z heads, decoder z and x_prev rows, frame head; without
    hidden layers the z heads' and the frame head's x_prev and z rows)
    against its bytes (seeds, eps, u, the per-song folds, the weights and the
    output, each once); ``peak`` is the rate of the products' type."""
    D, H, L = cfg.original_dim, cfg.intermediate_dim, cfg.latent_dim
    n_xp = D if cfg.use_x_prev else 0
    if cfg.has_hidden:
        fmas = B * nsteps * (D * H + H * 2 * L + L * H + n_xp * H + H * D)
        folds = 2 * B * H
    else:
        fmas = B * nsteps * (D * 2 * L + L * D + n_xp * D)
        folds = B * (2 * L + D)
    stream_bytes = 4 * (B * D + B * nsteps * (L + D) + folds + B * nsteps * D)
    return roofline_ms(fmas, stream_bytes + weight_bytes, peak)


def cluster_line(label, params, cfg, seeds, nsteps, eps, u, ws, mode, peak, reps=20):
    """The cluster kernel at one shape: its plan, CUDA-event ms a call
    around the wrapper, the profiler's device ms of the kernel a call, the
    wrapper's packing of the weights apart (once a signature; the per-song
    folds are formed in the kernel's prologue), its own clock of each part
    of a step, a second call bitwise equal, the bound (the mode's rate).
    Returns (ms, device ms or None, bound ms, bound_by, plan)."""
    from classifying_vae_lstm_tpu_torch.ops import cuda_generate_vae as cgv

    B = seeds.shape[0]
    plan = cgv.launch_plan(cfg, B, mode, seeds.device)
    fn = lambda: cgv.generate_cl_vae_batch_cuda(params, cfg, seeds, nsteps, eps, u, ws,
                                                return_probs=True)
    first = fn()
    same_bits(lambda: (fn(),), (), (first,), ("probabilities",), f"{label} generation")
    k_ms = time_ms(fn, reps, warm=1)
    dv = device_ms_per_call(fn, 3, "generate_cluster_kernel", launches=1)
    cgv._PACKED.clear()
    pack_ms = time_ms(lambda: (cgv._PACKED.clear(),
                               cgv.cluster_operands(params, cfg, mode, plan, seeds.device)),
                      reps=5, warm=1)
    parts = cgv.cluster_phase_ms(params, cfg, seeds, nsteps, eps, u, ws, mode=mode)
    parts.pop("plan")
    print(f"{label}: a step's parts, us (block 0's clock, thread 0) "
          + "; ".join(f"{n} {v * 1e3 / nsteps:.3f}" for n, v in parts.items()))
    w = cgv._pack(params, cfg, ws, mode)
    wbytes = sum(v.numel() * v.element_size() for n, v in w.items()
                 if v is not None and n not in ("encb", "decb", "zb", "xb"))
    b_ms, b_by = vae_bound_ms(cfg, B, nsteps, wbytes, peak)
    print(f"{label}: generate_cluster_kernel {k_ms:.4f} ms a call (CUDA events), device "
          f"{f'{dv[0]:.4f}' if dv else 'not measured'} ms (profiler); bound {b_ms:.4f} ms "
          f"({b_by}, {mode} rate); plan C={plan['C']} blocks, one song a cluster, "
          f"T={plan['T']} g={plan['g']} register path {plan['regs']}, {plan['clusters']} "
          f"clusters in {plan['waves']} wave(s), "
          f"{plan['bytes']} B of shared memory a block; the wrapper's packing of the weights "
          f"apart {pack_ms:.4f} ms (once a signature)")
    return k_ms, (dv[0] if dv else None), b_ms, b_by, plan


def phase_vae(dev):
    """The cl_vae generation kernel (the cluster kernel) against its plain
    version: f32 on the trained jsball_vae weights at the largest serving
    bucket, then bf16 at a seeded width of one block's bf16 weights. Returns
    the kernel-table fields of the f32 run."""
    import numpy as np
    import torch

    from classifying_vae_lstm_tpu_torch.cli import common
    from classifying_vae_lstm_tpu_torch.models import cl_vae
    from classifying_vae_lstm_tpu_torch.ops import cuda_generate_vae as cgv
    from classifying_vae_lstm_tpu_torch.sampling import infer_w_cl_vae
    from classifying_vae_lstm_tpu_torch.weights import params_from_numpy

    raw, cfg, _ = common.load_model(VAE_MODEL, "cl_vae")
    params = params_from_numpy(raw, dev)
    B, nsteps = 64, 256
    D, L = cfg.original_dim, cfg.latent_dim
    require(cgv.kernel_for(cfg) == "generate_cl_vae_cluster" and cgv.cluster_plan(cfg, B)["C"] == 1,
            f"jsball_vae routes to {cgv.kernel_for(cfg)}")
    seeds = torch.from_numpy(np.ascontiguousarray(seed_windows(B)[:, 0])).to(dev)
    ws = infer_w_cl_vae(params, seeds)
    rng = np.random.default_rng(SEED + 4)
    eps = torch.from_numpy(rng.standard_normal((B, nsteps, L), dtype=np.float32)).to(dev)
    u = torch.from_numpy(rng.random((B, nsteps, D), dtype=np.float32)).to(dev)
    u1 = torch.ones_like(u)
    errs, times = {}, {}
    cgv.LAUNCHES = cgv.CLUSTER_LAUNCHES = cgv.COOP_LAUNCHES = cgv.WIDE_LAUNCHES = 0
    for zp in (False, True):
        kern = lambda uu, rp: cgv.generate_cl_vae_batch_cuda(
            params, cfg, seeds, nsteps, eps, uu, ws, use_z_prior=zp, return_probs=rp)
        plain = lambda uu, rp: cgv.generate_cl_vae_batch_plain(
            params, cfg, seeds, nsteps, eps, uu, ws, use_z_prior=zp, return_probs=rp)
        pk, pp = kern(u1, True), plain(u1, True)
        torch.cuda.synchronize()
        require(torch.isfinite(pk).all().item() and pk.shape == (B, nsteps, D),
                "cl_vae kernel probabilities not finite or misshapen")
        errs[zp] = (pk - pp).abs().max().item()
        print(f"cl_vae f32 probs, u=1, use_z_prior={zp}: max |kernel - plain| = "
              f"{errs[zp]:.3e} (limit 1e-5)")
        require(errs[zp] <= 1e-5, f"cl_vae f32 probabilities differ by {errs[zp]}")
        fk, fp, probs = kern(u, False), plain(u, False), plain(u, True)
        torch.cuda.synchronize()
        frames_agree_to_near_tie(f"cl_vae f32 frames, use_z_prior={zp}", fk, fp, u, probs)
        # kernel, plain, plain, kernel
        times[zp] = (time_ms(lambda: kern(u, False), reps=20, warm=2),
                     time_ms(lambda: plain(u, False), reps=3, warm=1),
                     time_ms(lambda: plain(u, False), reps=3),
                     time_ms(lambda: kern(u, False), reps=20))
    for zp, (k1, p1, p2, k2) in times.items():
        print(f"cl_vae f32 kernel {k1:.4f} / {k2:.4f} ms, plain {p1:.3f} / {p2:.3f} ms "
              f"(use_z_prior={zp}) at B={B} nsteps={nsteps} H={cfg.intermediate_dim}")
    k_ms, dv, b_ms, b_by, _ = cluster_line("cl_vae f32 jsball_vae 64 x 256", params, cfg, seeds,
                                           nsteps, eps, u, ws, "f32", PEAK_F32_FLOPS)
    grid = {}  # the serving buckets (songs x steps), each after a warm-up launch
    for b in (1, 4, 16, 64):
        for t in (32, 64, 128, 256):
            args = [x[:b, :t].contiguous() for x in (eps, u)]
            sb, wb = seeds[:b].contiguous(), ws[:b].contiguous()
            grid[f"{b}x{t}"] = round(time_ms(lambda: cgv.generate_cl_vae_batch_cuda(
                params, cfg, sb, t, args[0], args[1], wb), reps=5), 4)
    print(f"cl_vae f32 kernel ms per serving bucket (songs x steps): {json.dumps(grid)}")

    # bf16 weights at H=256: one block holds them (f32 ones take two)
    H, K = 256, cfg.n_classes
    bcfg = cl_vae.Config(original_dim=D, intermediate_dim=H, latent_dim=L,
                         intermediate_class_dim=88, n_classes=K, use_x_prev=True,
                         bf16_compute=True)
    require(cgv.cluster_plan(bcfg, B, "bf16")["C"] == 1
            and cgv.cluster_plan(bcfg, B, "f32")["C"] == 2, "bf16 width choice")
    brng = np.random.default_rng(SEED + 5)

    def glorot(i, o):
        lim = np.sqrt(6.0 / (i + o))
        return brng.uniform(-lim, lim, (i, o)).astype(np.float32)

    dense = lambda i, o: {"kernel": glorot(i, o), "bias": np.zeros(o, np.float32)}
    bparams = params_from_numpy({"h": dense(D + K, H), "z_mean": dense(H, L),
                                 "z_log_var": dense(H, L), "decoder_h": dense(K + D + L, H),
                                 "x_decoded_mean": dense(H, D)}, dev)
    bws = torch.eye(K, device=dev)[torch.arange(B, device=dev) % K]
    run = lambda f: f(bparams, bcfg, seeds, nsteps, eps, u1, bws, return_probs=True)
    pk, pp = run(cgv.generate_cl_vae_batch_cuda), run(cgv.generate_cl_vae_batch_plain)
    torch.cuda.synchronize()
    d = (pk - pp).abs()
    mx, mean = d.max().item(), d.mean().item()
    print(f"cl_vae bf16 H={H} probs, u=1: max {mx:.3e} (limit 2e-2), mean {mean:.3e} (limit "
          f"2e-3)")
    require(torch.isfinite(pk).all().item(), "cl_vae bf16 kernel probabilities not finite")
    require(mx <= 2e-2 and mean <= 2e-3, f"cl_vae bf16 probabilities differ: max {mx}, "
                                        f"mean {mean}")
    cluster_line(f"cl_vae bf16 H={H} 64 x 256", bparams, bcfg, seeds, nsteps, eps, u, bws, "bf16",
                 PEAK_BF16_FLOPS, reps=10)
    print(f"phase 11: {cgv.CLUSTER_LAUNCHES} launches of the cluster kernel, {cgv.LAUNCHES} f32 / "
          f"bf16 launches in all")
    require(cgv.CLUSTER_LAUNCHES == cgv.LAUNCHES > 0 and cgv.COOP_LAUNCHES == cgv.WIDE_LAUNCHES == 0,
            f"phase 11's launches left the cluster kernel: cluster {cgv.CLUSTER_LAUNCHES}, all "
            f"{cgv.LAUNCHES}, cooperative {cgv.COOP_LAUNCHES}, wide {cgv.WIDE_LAUNCHES}")
    return {"max_abs_err": max(errs.values()), "ms": k_ms, "plain_ms": times[False][1],
            "bound_ms": b_ms, "bound_by": b_by}


def phase_vae_serve():
    """cl_vae serving through ``cli.serve``: one launch of the cluster
    kernel per engine device call. Returns the launches."""
    import base64

    import numpy as np

    from classifying_vae_lstm_tpu_torch.data import MidiWriter

    with tempfile.TemporaryDirectory() as d:
        roll = np.zeros((12, 88), np.float32)
        roll[:, [39, 43, 46]] = 1.0
        MidiWriter().dump_sequence_to_midi(roll, os.path.join(d, "seed.mid"))
        with open(os.path.join(d, "seed.mid"), "rb") as f:
            seed_b64 = base64.b64encode(f.read()).decode()
    launches, cluster, calls, warm, stats, engine, coop = counted_serve(
        ["-i", VAE_MODEL, "--train_file", CORPUS, "--dynamic_batching", "--warmup", "full",
         "--port", "0"], [("2x64 seed_midi", {"n": 2, "t": 64, "seed_midi_base64": seed_b64})])
    lat = engine.latency_stats()
    print(f"cl_vae /stats: family {stats['family']}, gen_backend {stats['gen_backend']}, "
          f"requests {stats['requests']}, batches {stats['batches']}, batched_songs "
          f"{stats['batched_songs']}, gen_path {stats['gen_path']}")
    print(f"cl_vae main path: {launches} launches for {calls} engine device calls "
          f"({warm[0]} warm-up); latency p50 {lat['p50_ms']:.3f} ms, p95 {lat['p95_ms']:.3f} ms")
    require(stats["family"] == "cl_vae", f"/stats family {stats['family']}")
    require(launches == calls and launches > warm[0],
            f"cl_vae launches {launches} != engine device calls {calls}")
    require(cluster == launches and coop == 0,
            f"jsball_vae took the cluster kernel {cluster} of {launches} times, the "
            f"cooperative one {coop} times")
    require(stats["batches"] > 0, "the cl_vae burst was not coalesced (batches == 0)")
    return launches


def phase_sample_clis(out_dir):
    """Both sample CLIs on the card, each with exactly one launch of its
    kernel. Returns the cl_vae launches."""
    import numpy as np

    from classifying_vae_lstm_tpu_torch.cli import cl_vae_sample, cl_vrnn_sample
    from classifying_vae_lstm_tpu_torch.data import read_midi_roll
    from classifying_vae_lstm_tpu_torch.ops import cuda_generate as cg
    from classifying_vae_lstm_tpu_torch.ops import cuda_generate_vae as cgv

    runs = (
        ("cl_vae_sample", cl_vae_sample, cgv, "generate_cl_vae_batch_plain",
         ["smoke_vae", "-i", "artifacts/jsbcs_vae.npz", "-n", "8", "-t", "64"], (8, 64), True),
        ("cl_vrnn_sample", cl_vrnn_sample, cg, "generate_cl_vrnn_batch_plain",
         ["smoke_vrnn", "-i", MODEL, "--infer_w", "-n", "4"], (4, 32), False),
    )
    vae_launches = 0
    for name, cli, kmod, plain_name, argv, (n, t), doubled in runs:
        args = cli.build_parser().parse_args(
            [*argv, "--train_file", EVAL_CORPUS, "--sample_dir", out_dir])
        plain_on_cuda = []
        with sampler_plain_guard(kmod, plain_name, plain_on_cuda):
            kmod.LAUNCHES = 0  # counts from here on are this CLI's
            cgv.CLUSTER_LAUNCHES = 0
            t0 = time.perf_counter()
            samples = cli.sample(args)
            wall = time.perf_counter() - t0
            launches = kmod.LAUNCHES
        require(samples.shape == (n, t, 88) and set(np.unique(samples).tolist()) <= {0, 1},
                f"{name} samples {samples.shape}")
        for j in range(n):
            roll = read_midi_roll(os.path.join(out_dir, f"{args.run_name}_{j}.mid"))
            want = np.repeat(samples[j], 2, axis=0) if doubled else samples[j]
            require(np.array_equal(roll, want[: len(roll)]) and not want[len(roll):].any(),
                    f"{name}: song {j}'s MIDI does not parse back into its frames")
        files = sorted(f for f in os.listdir(out_dir) if f.startswith(args.run_name))
        print(f"{name}: {n} songs x {t} frames in {wall:.3f} s (host clock, checkpoint and "
              f"corpus included), {launches} launch, {int(samples.sum())} notes on; files "
              f"{len(files)} ({files[0]} .. {files[-1]})")
        require(launches == 1, f"{name} launched its kernel {launches} times")
        require(kmod is not cgv or cgv.CLUSTER_LAUNCHES == 1,
                f"{name} did not take the cluster kernel")
        require(not plain_on_cuda, f"{name}: plain version ran on CUDA tensors")
        if cli is cl_vae_sample:
            vae_launches = launches
    return vae_launches


VAE_TRAIN_B, VAE_WIDE = 100, dict(D=976, Cw=256, H=1024, L=16, K=TRAIN_K, B=1024)
VAE_DENSE_PLAIN = ("vae_dense_fwd_plain", "vae_dense_bwd_plain")


def vae_train_shape_params(rng, dev):
    """The trained ``jsball_vae`` weights (D=H=Cw=88, L=4) with fresh glorot
    rows and heads for the 13 key classes of the training corpus, and the
    matching config on the ``pallas`` route."""
    import numpy as np

    from classifying_vae_lstm_tpu_torch.cli import common
    from classifying_vae_lstm_tpu_torch.weights import params_from_numpy

    raw, cfg0, _ = common.load_model(VAE_MODEL, "cl_vae")
    K, K0, D = TRAIN_K, cfg0.n_classes, cfg0.original_dim
    glorot = lambda i, o: rng.uniform(-np.sqrt(6.0 / (i + o)), np.sqrt(6.0 / (i + o)),
                                      (i, o)).astype(np.float32)
    Cw, H = cfg0.intermediate_class_dim, cfg0.intermediate_dim
    for head in ("w_mean", "w_log_var"):
        raw[head] = {"kernel": glorot(Cw, K - 1), "bias": np.zeros(K - 1, np.float32)}
    raw["h"]["kernel"] = np.concatenate([raw["h"]["kernel"][:D], glorot(K, H)])
    raw["decoder_h"]["kernel"] = np.concatenate([glorot(K, H), raw["decoder_h"]["kernel"][K0:]])
    cfg = dataclasses.replace(cfg0, n_classes=K, train_backend="pallas")
    return params_from_numpy(raw, dev), cfg


def vae_wide_params(rng, dev):
    """Seeded glorot weights at the seq-concat width the JAX kernel was
    written for (D=976, Cw=256, H=1024, L=16, K=13), and its config."""
    import numpy as np

    from classifying_vae_lstm_tpu_torch.models import cl_vae
    from classifying_vae_lstm_tpu_torch.weights import params_from_numpy

    w = VAE_WIDE
    cfg = cl_vae.Config(original_dim=w["D"], intermediate_dim=w["H"], latent_dim=w["L"],
                        intermediate_class_dim=w["Cw"], n_classes=w["K"], use_x_prev=True,
                        train_backend="pallas")

    def dense(i, o):
        lim = np.sqrt(6.0 / (i + o))
        return {"kernel": rng.uniform(-lim, lim, (i, o)).astype(np.float32),
                "bias": np.zeros(o, np.float32)}

    D, Cw, H, L, K = w["D"], w["Cw"], w["H"], w["L"], w["K"]
    raw = {"h_w": dense(D, Cw), "w_mean": dense(Cw, K - 1), "w_log_var": dense(Cw, K - 1),
           "h": dense(D + K, H), "z_mean": dense(H, L), "z_log_var": dense(H, L),
           "decoder_h": dense(K + D + L, H), "x_decoded_mean": dense(H, D)}
    return params_from_numpy(raw, dev), cfg


def vae_dense_fmas(cfg) -> int:
    """FMAs of one row of the dense-stack forward: every weight once."""
    D, Cw, H, L, K = (cfg.original_dim, cfg.intermediate_class_dim, cfg.intermediate_dim,
                      cfg.latent_dim, cfg.n_classes)
    n_xp = D if cfg.use_x_prev else 0
    return D * Cw + Cw * 2 * (K - 1) + (D + K) * H + H * 2 * L + (K + n_xp + L) * H + H * D


def dense_times(vd, label, cfg, B, ins, outs, res, got, reps, peak=PEAK_F32_FLOPS):
    """Both dense-stack kernels and their plain versions timed in turns
    (kernel, plain, plain, kernel) with CUDA events, beside each direction's
    bound, then the profiler's device time per call. Returns each
    direction's kernel-table fields but the error."""
    D, K, L = cfg.original_dim, cfg.n_classes, cfg.latent_dim
    fk = (time_ms(lambda: vd.vae_dense_fwd(*ins), reps=reps, warm=2),
          time_ms(lambda: vd.vae_dense_fwd_plain(*ins), reps=reps, warm=2),
          time_ms(lambda: vd.vae_dense_fwd_plain(*ins), reps=reps),
          time_ms(lambda: vd.vae_dense_fwd(*ins), reps=reps))
    bk = (time_ms(lambda: vd.vae_dense_bwd(*res), reps=reps, warm=2),
          time_ms(lambda: vd.vae_dense_bwd_plain(*res), reps=reps, warm=2),
          time_ms(lambda: vd.vae_dense_bwd_plain(*res), reps=reps),
          time_ms(lambda: vd.vae_dense_bwd(*res), reps=reps))
    F = vae_dense_fmas(cfg)
    n_bias = (cfg.intermediate_class_dim + 2 * (K - 1) + 2 * cfg.intermediate_dim + 2 * L + D)
    live = lambda ts: [t for t in ts if t is not None]
    # the bf16 backward is csrc/vae_dense_tc.cu's 8 launches (9 past 128 rows);
    # the f32 one, csrc/vae_dense.cu's one cooperative launch
    n_bwd = (9 if B > 128 else 8) if peak == PEAK_BF16_FLOPS else 1
    fb_ms, fb_by = roofline_ms(B * F, _nbytes(live(ins)) + _nbytes(outs), peak)
    # the row pass (every weight once, transposed) + every dW and bias sum
    bb_ms, bb_by = roofline_ms(B * (2 * F + n_bias), _nbytes(live(res)) + _nbytes(live(got)),
                               peak)
    print(f"vae_dense {label} shape: forward kernel {fk[0]:.4f} / {fk[3]:.4f} ms, plain "
          f"(cuBLAS products) {fk[1]:.4f} / {fk[2]:.4f} ms, kernel/plain "
          f"{fk[0] / fk[1]:.2f}, bound {fb_ms:.5f} ms ({fb_by}); backward kernel ({n_bwd} launches) "
          f"{bk[0]:.4f} / {bk[3]:.4f} ms, plain {bk[1]:.4f} / {bk[2]:.4f} ms, kernel/plain "
          f"{bk[0] / bk[1]:.2f}, bound {bb_ms:.5f} ms ({bb_by}); shared memory "
          f"{vd.smem_bytes(cfg)} B per block")
    # device time alone (the CUDA-event times above include the wrappers'
    # host work, which sets them at the training shape)
    dt = {n: device_ms_per_call(fn, 20, "vae_")
          for n, fn in (("forward", lambda: vd.vae_dense_fwd(*ins)),
                        ("plain forward", lambda: vd.vae_dense_fwd_plain(*ins)),
                        ("backward", lambda: vd.vae_dense_bwd(*res)),
                        ("plain backward", lambda: vd.vae_dense_bwd_plain(*res)))}
    print(f"vae_dense {label} shape, profiler device ms per call: "
          + "; ".join(f"{n} " + ("not measured" if v is None else
                                 f"{v[1]:.4f} (dense-stack kernels {v[0]:.4f})")
                      for n, v in dt.items()))
    return {"fwd": {"ms": fk[0], "plain_ms": fk[1], "bound_ms": fb_ms, "bound_by": fb_by},
            "bwd": {"ms": bk[0], "plain_ms": bk[1], "bound_ms": bb_ms, "bound_by": bb_by}}


def phase_vae_dense(dev):
    """Both dense-stack kernels against their plain versions at the training
    shape and at the seq-concat width. Returns the kernel-table fields of
    each at the training shape."""
    import numpy as np
    import torch

    from classifying_vae_lstm_tpu_torch.ops import vae_dense as vd

    rng = np.random.default_rng(SEED + 6)
    shapes = {"training": (*vae_train_shape_params(rng, dev), VAE_TRAIN_B),
              "wide": (*vae_wide_params(rng, dev), VAE_WIDE["B"])}
    table = {}
    for label, (params, cfg, B) in shapes.items():
        D, K, L = cfg.original_dim, cfg.n_classes, cfg.latent_dim
        f = lambda a: torch.from_numpy(a).to(dev)
        x = f((rng.random((B, D)) < 0.1).astype(np.float32))
        xp = f((rng.random((B, D)) < 0.1).astype(np.float32))
        eps_w = f(rng.standard_normal((B, K - 1)).astype(np.float32))
        eps_z = f(rng.standard_normal((B, L)).astype(np.float32))
        ins = vd.pack_inputs(params, cfg, x, xp, eps_w, eps_z)
        p = vd.plan(B, D, cfg.intermediate_class_dim, cfg.intermediate_dim, L, K, cfg.use_x_prev)
        print(f"vae_dense f32 plan, {label} shape: layout "
              f"{'resident' if p.resident else 'streamed'} (weights "
              f"{'in every block' if p.resident else f'through {p.stages} slots of {p.slot} floats'})"
              f", rows a block {p.rows}, threads a block {p.threads}, row tiles {p.tiles}, "
              f"weight-gradient tiles {p.wg_tiles} of {p.wg_tile} x {p.wg_tile}, shared memory "
              f"a block forward {p.fwd_smem} B / backward {p.bwd_smem} B, backward scratch "
              f"{p.scratch} floats")
        outs = vd.vae_dense_fwd(*ins)
        ref = vd.vae_dense_fwd_plain(*ins)
        torch.cuda.synchronize()
        names = ("xhat", "wargs", "zargs", "w", "a1", "a2", "a3")
        errs = {n: (k - p).abs().max().item() for n, k, p in zip(names, outs, ref)}
        scale = {n: max(1.0, p.abs().max().item()) for n, p in zip(names, ref)}
        require(all(torch.isfinite(o).all().item() for o in outs),
                "dense-stack forward kernel output not finite")
        bad = {n: (e, scale[n]) for n, e in errs.items()
               if not (e <= FWD_LIMIT * scale[n] and math.isfinite(e))}
        print(f"vae_dense forward, {label} shape (B={B} D={D} Cw={cfg.intermediate_class_dim} "
              f"H={cfg.intermediate_dim} L={L} K={K}): max |kernel - plain| "
              + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
              + f" (limit {FWD_LIMIT} x max(1, max|plain|))")
        require(not bad, f"dense-stack forward differs: {bad}")

        (x_, xp_, ew, ez, whw, _, wwz, _, whx, whw2, _, wzz, _, wdw, wdxp, wdz, _, wxh, _) = ins
        xhat, wargs, zargs, w, a1, a2, a3 = ref
        cot = [f((1e-2 * rng.standard_normal(tuple(o.shape))).astype(np.float32))
               for o in (xhat, wargs, zargs, w)]
        res = (x_, xp_, ew, ez, a1, a2, a3, xhat, wargs, zargs, w, *cot,
               whw, wwz, whx, whw2, wzz, wdw, wdxp, wdz, wxh)
        got = vd.vae_dense_bwd(*res)
        want = vd.vae_dense_bwd_plain(*res)
        torch.cuda.synchronize()
        gnames = ("dx", "dxp", "dwhw", "dbhw", "dwwz", "dbwz", "dwhx", "dwhw2", "dbh", "dwzz",
                  "dbzz", "dwdw", "dwdxp", "dwdz", "dbd", "dwxh", "dbxh")
        bad, rel = [], {}
        for n, g, wv in zip(gnames, got, want):
            err, sc = (g - wv).abs().max().item(), wv.abs().max().item()
            rel[n] = err / max(sc, 1e-30)
            if not (err <= 1e-4 * sc + 1e-6 and math.isfinite(err)):
                bad.append((n, err, sc))
        bwd_err = max((g - wv).abs().max().item() for g, wv in zip(got, want))
        print(f"vae_dense backward, {label} shape: max |kernel - plain| / max|plain| "
              + ", ".join(f"{n} {v:.2e}" for n, v in rel.items())
              + f" (limit 1e-4 + 1e-6 abs); largest abs error {bwd_err:.3e}")
        require(not bad, f"dense-stack backward differs: {bad}")
        same_bits(vd.vae_dense_fwd, ins, outs, names, f"vae_dense forward, {label} shape")
        same_bits(lambda *a: [g for g in vd.vae_dense_bwd(*a) if g is not None], res,
                  [g for g in got if g is not None], [n for n, g in zip(gnames, got)
                                                      if g is not None],
                  f"vae_dense backward, {label} shape")
        for direction, args in (("fwd", ins), ("bwd", res)):
            parts, blocks = vd.phase_ms(direction, *args)
            print(f"vae_dense {direction} {label} shape, {blocks} blocks"
                  + (" (the cooperative grid)" if direction == "bwd" else "")
                  + ", the kernel's own clock (block 0, ms): "
                  + ", ".join(f"{n} {v:.4f}" for n, v in parts.items()))

        t = dense_times(vd, label, cfg, B, ins, outs, res, got,
                        reps=50 if label == "training" else 10)
        if label == "training":
            table["fwd"] = {"max_abs_err": max(errs.values()), **t["fwd"]}
            table["bwd"] = {"max_abs_err": bwd_err, **t["bwd"]}
    return table


VAE_TRAIN_FLAGS = ["--train_file", CORPUS, "--intermediate_dim", "88",
                   "--intermediate_class_dim", "88", "--latent_dim", "4", "--batch_size",
                   str(VAE_TRAIN_B), "--use_x_prev", "--patience", "0"]


def phase_vae_train(model_dir):
    """The cl_vae training path through ``cli.cl_vae_train --train_backend
    pallas`` (3 epochs), then 1 epoch of ``xla`` from the same seed. Returns
    the forward and backward launch counts and what the run left."""
    from classifying_vae_lstm_tpu_torch.cli import cl_vae_train
    from classifying_vae_lstm_tpu_torch.ops import vae_dense as vd
    from classifying_vae_lstm_tpu_torch.train.checkpoint import load_model_args

    reset, read = _reset_dense_counts, lambda: _dense_counts()[:2]
    plain_on_cuda = []
    with plain_guard(vd, VAE_DENSE_PLAIN, plain_on_cuda):
        args, (fwd, bwd), seen, epoch_s, wall = run_train(
            "smoke_vae", ["--num_epochs", "3", "--train_backend", "pallas"], model_dir, reset,
            read, cli=cl_vae_train, base_flags=VAE_TRAIN_FLAGS)
        require(_dense_counts()[2:] == (0, 0), f"f32 training ran the bf16 mode: {_dense_counts()}")
        E, n_train, n_val = _report_train("cl_vae training path", args, seen, epoch_s, wall)
        print(f"cl_vae training path launches: forward {fwd} (expected {E * (n_train + n_val)}), "
              f"backward {bwd} (expected {E * n_train}: one launch a step, the row pass and "
              f"the weight gradients either side of its grid barrier)")
        require(fwd == E * (n_train + n_val), f"dense-stack forward launches {fwd}")
        require(bwd == E * n_train, f"dense-stack backward launches {bwd}")
        margs = load_model_args(seen["ckpt"])
        require((margs["train_backend"], margs["n_classes"]) == ("pallas", TRAIN_K),
                f"args.json {margs}")
        seen.update(step_ms=epoch_s[-1] * 1e3 / n_train)

        args_x, counts_x, seen_x, epoch_x, wall_x = run_train(
            "smoke_vae_xla", ["--num_epochs", "1", "--train_backend", "xla"], model_dir, reset,
            read, cli=cl_vae_train, base_flags=VAE_TRAIN_FLAGS)
    _report_train("cl_vae --train_backend xla", args_x, seen_x, epoch_x, wall_x)
    require(counts_x == (0, 0), f"the xla route launched dense-stack kernels: {counts_x}")
    require(not plain_on_cuda, f"plain dense-stack versions ran on CUDA tensors: {plain_on_cuda}")
    loss_k, loss_x = seen["history"]["loss"][0], seen_x["history"]["loss"][0]
    rel = abs(loss_k - loss_x) / abs(loss_x)
    print(f"cl_vae first epoch train loss: pallas {loss_k!r}, xla {loss_x!r}, relative "
          f"difference {rel:.3e} (limit 1e-3); ms per step, first epoch: pallas "
          f"{epoch_s[0] * 1e3 / n_train:.3f}, xla {epoch_x[0] * 1e3 / n_train:.3f}; epoch s: "
          f"pallas {[round(v, 3) for v in epoch_s]}, xla {[round(v, 3) for v in epoch_x]}")
    require(rel <= 1e-3, f"first-epoch losses differ by {rel}")
    return fwd, bwd, seen


def phase_vae_evaluate(ckpt, out_dir):
    """``cli.evaluate --family cl_vae``: jsbcs_vae over the whole test split
    of ``Piano-midi_Cs``, then phase 15's checkpoint on the training corpus;
    then ``cli.cl_vae_sample`` on that checkpoint with true keys, one
    generation launch."""
    import numpy as np
    import torch

    from classifying_vae_lstm_tpu_torch.cli import cl_vae_sample, evaluate
    from classifying_vae_lstm_tpu_torch.data import PianoData
    from classifying_vae_lstm_tpu_torch.ops import cuda_generate_vae as cgv
    from classifying_vae_lstm_tpu_torch.ops import vae_dense as vd

    for model, corpus in (("artifacts/jsbcs_vae.npz", EVAL_CORPUS), (ckpt, CORPUS)):
        args = evaluate.build_parser().parse_args(
            ["-i", model, "--family", "cl_vae", "--train_file", corpus, "--n_samples",
             str(EVAL_SAMPLES), "--batch_size", str(EVAL_B)])
        vd.FWD_LAUNCHES = vd.BWD_LAUNCHES = 0
        t0 = time.perf_counter()
        out = evaluate.evaluate(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = len(PianoData(corpus, batch_size=1, seq_length=1, return_y_next=True).x_test)
        print(f"evaluate {model} on {corpus}: NLL {out['test_nll_nats_per_frame']} nats/frame "
              f"over {out['n_test_examples']} frames ({EVAL_SAMPLES} samples, batches of "
              f"{EVAL_B}), wall {wall:.3f} s (host clock, checkpoint and corpus loads included); "
              f"dense-stack launches {(vd.FWD_LAUNCHES, vd.BWD_LAUNCHES)} (the estimator runs "
              "plain dense layers, as the JAX one does)")
        require(out["family"] == "cl_vae" and out["n_test_examples"] == n,
                f"evaluation covered {out['n_test_examples']} of {n} frames")
        require(math.isfinite(out["test_nll_nats_per_frame"]), "non-finite NLL")

    args = cl_vae_sample.build_parser().parse_args(
        ["smoke_trained_vae", "-i", ckpt, "-n", "4", "-t", "32", "--train_file", CORPUS,
         "--sample_dir", out_dir])
    plain_on_cuda = []
    with sampler_plain_guard(cgv, "generate_cl_vae_batch_plain", plain_on_cuda):
        cgv.LAUNCHES = cgv.CLUSTER_LAUNCHES = 0
        samples = cl_vae_sample.sample(args)
        launches = cgv.LAUNCHES
    files = sorted(f for f in os.listdir(out_dir) if f.startswith("smoke_trained_vae"))
    print(f"cl_vae_sample on the trained checkpoint: 4 songs x 32 frames, {launches} launch, "
          f"{int(samples.sum())} notes on, {len(files)} MIDI files")
    require(samples.shape == (4, 32, 88) and set(np.unique(samples).tolist()) <= {0, 1},
            f"samples {samples.shape}")
    require(launches == 1 and len(files) == 4 and not plain_on_cuda and cgv.CLUSTER_LAUNCHES == 1,
            f"cl_vae_sample: {launches} launches ({cgv.CLUSTER_LAUNCHES} cluster), files {files}, "
            f"plain {plain_on_cuda}")


# ---- phases 17-19: the wide cl_vae generation kernel, the bf16 mode of the
# dense-stack kernels, and the paths through both

CLUSTER, COOP, WIDE = "generate_cl_vae_cluster", "generate_cl_vae_coop", "generate_cl_vae_wide"
WIDE_GEN = (  # label, (D, H, L, use_x_prev), weight mode, the kernel kernel_for picks
    ("f32 H=256", (88, 256, 4, True), "f32", CLUSTER),  # 2 blocks a cluster
    ("f32 H=512", (88, 512, 4, True), "f32", CLUSTER),  # 4
    ("bf16 H=512", (88, 512, 4, True), "bf16", CLUSTER),  # 2
    ("bf16 seq-concat", (1024, 1024, 16, False), "bf16", COOP),
    ("bf16 H=5120", (1024, 5120, 16, False), "bf16", COOP),
    ("bf16 H=5120 x_prev", (1024, 5120, 16, True), "bf16", COOP),
    ("f32 no hidden", (88, 0, 4, True), "f32", CLUSTER),
    # the width of phase 19's seq-concat checkpoint without hidden layers:
    # its z heads (2L x D) past 8 blocks
    ("f32 no hidden D=1024 L=32", (1024, 0, 32, False), "f32", WIDE),
)


def glorot_vae_raw(rng, D, H, L, K, use_x_prev, Cw=88):
    """Seeded glorot-scale cl_vae weights with zero biases (NumPy), with or
    without hidden layers (``H = 0``)."""
    import numpy as np

    def dense(i, o):
        lim = np.sqrt(6.0 / (i + o))
        return {"kernel": rng.uniform(-lim, lim, (i, o)).astype(np.float32),
                "bias": np.zeros(o, np.float32)}

    n_xp = D if use_x_prev else 0
    raw = {"h_w": dense(D, Cw), "w_mean": dense(Cw, K - 1), "w_log_var": dense(Cw, K - 1)}
    if H:
        raw.update(h=dense(D + K, H), z_mean=dense(H, L), z_log_var=dense(H, L),
                   decoder_h=dense(K + n_xp + L, H), x_decoded_mean=dense(H, D))
    else:
        raw.update(z_mean=dense(D + K, L), z_log_var=dense(D + K, L),
                   x_decoded_mean=dense(K + n_xp + L, D))
    return raw


def phase_vae_wide(dev):
    """The kernels of every config past one block's shared memory, and
    without hidden layers, against their plain version at 64 single-frame
    seeds x 256 steps: the cluster kernel (f32 at H=256 and H=512 with and
    without use_z_prior, clusters of 2 and 4 blocks; bf16 at H=512; without
    hidden layers), the cooperative kernel (bf16 at the seq-concat width
    D=H=1,024 and at D=1,024, H=5,120 with and without x_prev) and the wide
    kernel (without hidden layers at D=1,024, L=32, no x_prev, whose z
    heads 8 blocks do not hold), each where ``kernel_for`` sends it; the cluster kernel's
    plan, device time, operands and clock at each of its shapes
    (:func:`cluster_line`), the cooperative kernel's own clock of each part
    of a step at H=5,120. Returns the kernel-table fields of the bf16
    H=5,120 run (the width phase 30's checkpoint samples at), and of the
    runs at the widths of phase 19's checkpoints: bf16 H=512, without hidden
    layers at D=88 and at D=1,024."""
    import numpy as np
    import torch

    from classifying_vae_lstm_tpu_torch.cli import common
    from classifying_vae_lstm_tpu_torch.models import cl_vae
    from classifying_vae_lstm_tpu_torch.ops import cuda_generate_vae as cgv
    from classifying_vae_lstm_tpu_torch.weights import params_from_numpy

    B, nsteps, K = 64, 256, TRAIN_K
    rng = np.random.default_rng(SEED + 7)
    seeds88 = torch.from_numpy(np.ascontiguousarray(seed_windows(B)[:, 0])).to(dev)
    ws = torch.eye(K, device=dev)[torch.arange(B, device=dev) % K]
    calls = {CLUSTER: 0, COOP: 0, WIDE: 0}
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count

    # this phase's launches
    cgv.LAUNCHES = cgv.CLUSTER_LAUNCHES = cgv.WIDE_LAUNCHES = cgv.COOP_LAUNCHES = 0
    rows = {}
    for label, (D, H, L, use_xp), mode, kernel in WIDE_GEN:
        cfg = cl_vae.Config(original_dim=D, intermediate_dim=H, latent_dim=L,
                            intermediate_class_dim=88, n_classes=K, use_x_prev=use_xp,
                            bf16_compute=mode == "bf16")
        require(cgv.kernel_for(cfg) == kernel and cgv.pick_mode(cfg) == mode,
                f"{label}: routed to {cgv.kernel_for(cfg)} in mode {cgv.pick_mode(cfg)}")

        def kern(*a, kernel=kernel, **k):
            calls[kernel] += 1
            return cgv.generate_cl_vae_batch_cuda(*a, **k)

        layout = ""
        if kernel == CLUSTER:
            plan = cgv.launch_plan(cfg, B, mode, dev)
            layout = (f"; clusters of {plan['C']} blocks, one song a cluster, {plan['T']} "
                      f"threads, {plan['waves']} wave(s)")
        if kernel == COOP:
            plan = cgv.coop_plan(cfg, B, n_sm, mode)
            layout = (f"; {plan['G']} blocks of {plan['nu']} units, the frame head in "
                      f"{plan['hs']} song groups of {plan['P']} pitch tiles a block, slices "
                      f"resident (x rows, head) {plan['res']}")
        params = params_from_numpy(glorot_vae_raw(rng, D, H, L, K, use_xp), dev)
        seeds = (seeds88 if D == 88 else
                 torch.from_numpy((rng.random((B, D)) < 0.1).astype(np.float32)).to(dev))
        eps = torch.from_numpy(rng.standard_normal((B, nsteps, L), dtype=np.float32)).to(dev)
        u = torch.from_numpy(rng.random((B, nsteps, D), dtype=np.float32)).to(dev)
        u1 = torch.ones_like(u)
        errs = []
        for zp in ((False, True) if mode == "f32" else (False,)):
            k = lambda uu, rp: kern(params, cfg, seeds, nsteps, eps, uu, ws, use_z_prior=zp,
                                    return_probs=rp)
            p = lambda uu, rp: cgv.generate_cl_vae_batch_plain(
                params, cfg, seeds, nsteps, eps, uu, ws, use_z_prior=zp, return_probs=rp)
            pk, pp = k(u1, True), p(u1, True)
            torch.cuda.synchronize()
            require(torch.isfinite(pk).all().item() and pk.shape == (B, nsteps, D),
                    f"{label}: probabilities not finite or misshapen")
            d = (pk - pp).abs()
            mx, mean = d.max().item(), d.mean().item()
            errs.append(mx)
            if mode == "f32":
                print(f"{kernel} {label} probs, u=1, use_z_prior={zp}: max |kernel - plain| = "
                      f"{mx:.3e} (limit 1e-5)")
                require(mx <= 1e-5, f"{label} f32 probabilities differ by {mx}")
                fk, fp, probs = k(u, False), p(u, False), p(u, True)
                torch.cuda.synchronize()
                frames_agree_to_near_tie(f"{kernel} {label} frames, use_z_prior={zp}", fk, fp, u,
                                         probs)
            else:
                print(f"{kernel} {label} probs, u=1: max {mx:.3e} (limit 2e-2), mean {mean:.3e} "
                      "(limit 2e-3)")
                require(mx <= 2e-2 and mean <= 2e-3, f"{label} bf16 probabilities differ: "
                                                     f"max {mx}, mean {mean}")
        k = lambda: kern(params, cfg, seeds, nsteps, eps, u, ws)
        p = lambda: cgv.generate_cl_vae_batch_plain(params, cfg, seeds, nsteps, eps, u, ws)
        t = (time_ms(k, reps=3, warm=1), time_ms(p, reps=2, warm=1), time_ms(p, reps=2),
             time_ms(k, reps=3))
        w = cgv._pack(params, cfg, ws, mode)
        wbytes = sum(v.numel() * v.element_size() for n, v in w.items()
                     if v is not None and n not in ("encb", "decb", "zb", "xb"))
        b_ms, b_by = vae_bound_ms(cfg, B, nsteps, wbytes,
                                  PEAK_BF16_FLOPS if mode == "bf16" else PEAK_F32_FLOPS)
        print(f"{kernel} {label} (D={D} H={H} L={L} use_x_prev={use_xp}): kernel {t[0]:.3f} / "
              f"{t[3]:.3f} ms, plain {t[1]:.3f} / {t[2]:.3f} ms, bound {b_ms:.4f} ms ({b_by}) "
              f"at B={B} nsteps={nsteps}; {wbytes / 1e6:.3f} MB of weights{layout}")
        rows[label] = {"max_abs_err": max(errs), "ms": t[0], "plain_ms": t[1], "bound_ms": b_ms,
                       "bound_by": b_by}
        if kernel == CLUSTER:  # plan, device time, operands, clock, bits; its launches counted
            n0 = (cgv.CLUSTER_LAUNCHES, cgv.LAUNCHES)
            cluster_line(f"{CLUSTER} {label}", params, cfg, seeds, nsteps, eps, u, ws, mode,
                         PEAK_BF16_FLOPS if mode == "bf16" else PEAK_F32_FLOPS, reps=5)
            grown = cgv.CLUSTER_LAUNCHES - n0[0]
            require(cgv.LAUNCHES - n0[1] == grown > 0, f"{label}: launches off the cluster count")
            calls[CLUSTER] += grown
        if label == "bf16 H=5120":
            rows["parts"] = (params, cfg, seeds, eps, u)
    cluster, coop, wide = calls[CLUSTER], calls[COOP], calls[WIDE]
    require(cgv.CLUSTER_LAUNCHES == cluster and cgv.COOP_LAUNCHES == coop
            and cgv.WIDE_LAUNCHES == wide and cgv.LAUNCHES == cluster + coop + wide,
            f"launches: cluster {cgv.CLUSTER_LAUNCHES} (calls {cluster}), cooperative "
            f"{cgv.COOP_LAUNCHES} (calls {coop}), wide {cgv.WIDE_LAUNCHES} (calls {wide}), all "
            f"{cgv.LAUNCHES}")
    params, cfg, seeds, eps, u = rows.pop("parts")
    split = cgv.phase_ms(params, cfg, seeds, nsteps, eps, u, ws, mode="bf16")
    print("generate_cl_vae_coop bf16 H=5120: a call's parts (block 0's clock, ms; a wait is the "
          "slowest block's lag and the grid barrier) "
          + "; ".join(f"{n} {v:.3f}" for n, v in split.items()))
    # the jsball_vae width takes the cluster kernel on one block
    raw, jcfg, _ = common.load_model(VAE_MODEL, "cl_vae")
    jp = params_from_numpy(raw, dev)
    jws = torch.eye(jcfg.n_classes, device=dev)[:4]
    jeps = torch.zeros((4, 8, jcfg.latent_dim), device=dev)
    cgv.LAUNCHES = cgv.CLUSTER_LAUNCHES = cgv.WIDE_LAUNCHES = cgv.COOP_LAUNCHES = 0
    cgv.generate_cl_vae_batch_cuda(jp, jcfg, seeds88[:4].contiguous(), 8, jeps,
                                   torch.ones((4, 8, 88), device=dev), jws)
    torch.cuda.synchronize()
    require(cgv.kernel_for(jcfg) == CLUSTER and cgv.LAUNCHES == cgv.CLUSTER_LAUNCHES == 1
            and cgv.WIDE_LAUNCHES == cgv.COOP_LAUNCHES == 0
            and cgv.cluster_plan(jcfg, 4)["C"] == 1,
            "jsball_vae did not take the cluster kernel on one block")
    print(f"phase 17: {cluster} cluster, {coop} cooperative and {wide} wide launches, each "
          "counted by its own count; jsball_vae's width launches the cluster kernel, one block a "
          "cluster")
    return (rows["bf16 H=5120"], rows["bf16 H=512"], rows["f32 no hidden"],
            rows["f32 no hidden D=1024 L=32"])


SEQ_DENSE = dict(D=1024, Cw=256, H=1024, L=16, K=TRAIN_K, B=VAE_TRAIN_B, use_x_prev=False)


def phase_vae_dense_bf16(dev):
    """The bf16 mode of both dense-stack kernels against their bf16 plain
    versions at phase 19's training shape and at phase 14's seq-concat
    shape; then each parameter gradient of the loss on the kernel route in
    bf16 against the f32 truth, within the JAX test's bound. Returns the
    kernel-table fields of each direction at the training shape."""
    import numpy as np
    import torch

    from classifying_vae_lstm_tpu_torch.models import cl_vae
    from classifying_vae_lstm_tpu_torch.ops import vae_dense as vd
    from classifying_vae_lstm_tpu_torch.weights import params_from_numpy

    rng = np.random.default_rng(SEED + 8)
    shapes = {"seq-concat training": SEQ_DENSE, "seq-concat wide": {**VAE_WIDE, "use_x_prev": True}}
    rel = lambda a, b: ((a.float() - b.float()).norm() / (b.float().norm() + 1e-30)).item()
    table = {}
    for label, sh in shapes.items():
        D, Cw, H, L, K, B, use_xp = (sh[k] for k in ("D", "Cw", "H", "L", "K", "B", "use_x_prev"))
        cfg = cl_vae.Config(original_dim=D, intermediate_dim=H, latent_dim=L,
                            intermediate_class_dim=Cw, n_classes=K, use_x_prev=use_xp,
                            train_backend="pallas", bf16_compute=True)
        params = params_from_numpy(glorot_vae_raw(rng, D, H, L, K, use_xp, Cw), dev)
        f = lambda a: torch.from_numpy(a).to(dev)
        x = f((rng.random((B, D)) < 0.1).astype(np.float32))
        xp = f((rng.random((B, D)) < 0.1).astype(np.float32))
        y = f((rng.random((B, D)) < 0.1).astype(np.float32))
        eps_w = f(rng.standard_normal((B, K - 1)).astype(np.float32))
        eps_z = f(rng.standard_normal((B, L)).astype(np.float32))
        ins = vd.pack_inputs(params, cfg, x, xp, eps_w, eps_z)
        outs = vd.vae_dense_fwd(*ins)
        ref = vd.vae_dense_fwd_plain(*ins)
        torch.cuda.synchronize()
        names = ("xhat", "wargs", "zargs", "w", "a1", "a2", "a3")
        errs = {n: (k - p).abs().max().item() for n, k, p in zip(names, outs, ref)}
        rels = {n: rel(k, p) for n, k, p in zip(names, outs, ref)}
        scale = {n: max(1.0, p.abs().max().item()) for n, p in zip(names, ref)}
        print(f"vae_dense bf16 forward, {label} shape (B={B} D={D} Cw={Cw} H={H} L={L} K={K} "
              f"use_x_prev={use_xp}): max |kernel - plain| "
              + ", ".join(f"{n} {e:.3e} (rel. Frobenius {rels[n]:.2e})" for n, e in errs.items())
              + " (limits 1e-2 x max(1, max|plain|), 1e-3)")
        require(all(torch.isfinite(o).all().item() for o in outs), "bf16 forward not finite")
        require(all(errs[n] <= 1e-2 * scale[n] and rels[n] <= 1e-3 for n in names),
                f"bf16 dense-stack forward differs: {errs} {rels}")
        same_bits(vd.vae_dense_fwd, ins, outs, names, f"vae_dense bf16 forward, {label} shape")
        split = device_split(lambda: vd.vae_dense_fwd(*ins), 10, VAE_TC_FWD_PARTS, "vae_tc_")
        print(f"vae_dense bf16 forward, {label} shape, device: {split}")
        (x_, xp_, ew, ez, whw, _, wwz, _, whx, whw2, _, wzz, _, wdw, wdxp, wdz, _, wxh, _) = ins
        xhat, wargs, zargs, w, a1, a2, a3 = ref
        cot = [f((1e-2 * rng.standard_normal(tuple(o.shape))).astype(np.float32))
               for o in (xhat, wargs, zargs, w)]
        res = (x_, xp_, ew, ez, a1, a2, a3, xhat, wargs, zargs, w, *cot,
               whw, wwz, whx, whw2, wzz, wdw, wdxp, wdz, wxh)
        got = vd.vae_dense_bwd(*res)
        want = vd.vae_dense_bwd_plain(*res)
        torch.cuda.synchronize()
        gnames = ("dx", "dxp", "dwhw", "dbhw", "dwwz", "dbwz", "dwhx", "dwhw2", "dbh", "dwzz",
                  "dbzz", "dwdw", "dwdxp", "dwdz", "dbd", "dwxh", "dbxh")
        brel = {n: rel(g, wv) for n, g, wv in zip(gnames, got, want) if wv is not None}
        types = {n: g.dtype for n, g in zip(gnames, got) if g is not None}
        print(f"vae_dense bf16 backward, {label} shape: relative Frobenius |kernel - plain| "
              + ", ".join(f"{n} {v:.2e}" for n, v in brel.items()) + " (limit 1e-2)")
        require(all(v <= 1e-2 and math.isfinite(v) for v in brel.values()),
                f"bf16 dense-stack backward differs: {brel}")
        require(all(t == (torch.float32 if n.startswith("db") else torch.bfloat16)
                    for n, t in types.items()), f"gradient types {types}")
        bwd_err = max((g.float() - wv.float()).abs().max().item()
                      for g, wv in zip(got, want) if wv is not None)
        live = [(n, g) for n, g in zip(gnames, got) if g is not None]
        same_bits(lambda *a: [g for g in vd.vae_dense_bwd(*a) if g is not None], res,
                  [g for _, g in live], [n for n, _ in live],
                  f"vae_dense bf16 backward, {label} shape")
        print(f"vae_dense bf16 backward, {label} shape, device: "
              f"{device_split(lambda: vd.vae_dense_bwd(*res), 10, VAE_TC_PARTS)}")

        # each parameter gradient of the loss against the f32 truth: kernel
        # route bf16 vs plain route bf16 (the JAX test's bound)
        batch = {"x": x, "y": y, "w": torch.eye(K, device=dev)[torch.arange(B, device=dev) % K],
                 "eps_w": eps_w, "eps_z": eps_z}
        if use_xp:
            batch["x_prev"] = xp

        def grads(c):
            p = {k: {n: v.detach().clone().requires_grad_(True) for n, v in d.items()}
                 for k, d in params.items()}
            loss, _ = cl_vae.loss_and_metrics(p, c, batch, None, 1.0, 1.0, 1.0)
            loss.backward()
            return {f"{k}/{n}": v.grad for k, d in p.items() for n, v in d.items()}

        g_k = grads(cfg)
        g_x = grads(dataclasses.replace(cfg, train_backend="xla"))
        g_f = grads(dataclasses.replace(cfg, train_backend="xla", bf16_compute=False))
        bad = []
        for n, g in g_k.items():
            ek, ex = (g - g_f[n]).norm().item(), (g_x[n] - g_f[n]).norm().item()
            rounded = torch.equal(g, g.bfloat16().float())
            if not (ek <= 3 * ex + 0.02 * (g_f[n].norm().item() + 1e-3)
                    and rounded == n.endswith("kernel")):
                bad.append((n, ek, ex, rounded))
        print(f"vae_dense bf16, {label} shape, loss gradients vs the f32 truth: kernel route "
              f"{max((g - g_f[n]).norm().item() / (g_f[n].norm().item() + 1e-30) for n, g in g_k.items()):.3e}, "
              f"plain bf16 route {max((g - g_f[n]).norm().item() / (g_f[n].norm().item() + 1e-30) for n, g in g_x.items()):.3e} "
              "largest relative error per leaf; every kernel gradient bf16-representable, no "
              "bias gradient rounded")
        require(not bad, f"bf16 gradients outside the JAX bound or wrongly rounded: {bad}")

        t = dense_times(vd, f"bf16 {label}", cfg, B, ins, outs, res, got,
                        reps=20 if B <= VAE_TRAIN_B else 10, peak=PEAK_BF16_FLOPS)
        if label == "seq-concat training":
            table["fwd"] = {"max_abs_err": max(errs.values()), **t["fwd"]}
            table["bwd"] = {"max_abs_err": bwd_err, **t["bwd"]}
    return table


SEQ_TRAIN_FLAGS = ["--train_file", CORPUS, "--seq_length", "16", "--intermediate_dim", "1024",
                   "--intermediate_class_dim", "256", "--latent_dim", "16", "--batch_size",
                   str(VAE_TRAIN_B), "--bf16_compute", "--patience", "0"]


def _dense_counts():
    from classifying_vae_lstm_tpu_torch.ops import vae_dense as vd

    return (vd.FWD_LAUNCHES, vd.BWD_LAUNCHES, vd.BF16_FWD_LAUNCHES, vd.BF16_BWD_LAUNCHES)


def _reset_dense_counts():
    from classifying_vae_lstm_tpu_torch.ops import vae_dense as vd

    vd.FWD_LAUNCHES = vd.BWD_LAUNCHES = vd.BF16_FWD_LAUNCHES = vd.BF16_BWD_LAUNCHES = 0


def phase_vae_bf16_train(model_dir):
    """Seq-concat cl_vae training in bf16 through the dense-stack kernels'
    bf16 mode (2 epochs of ``cli.cl_vae_train --bf16_compute --train_backend
    pallas``), then 1 epoch of ``xla`` from the same seed. Returns the bf16
    launch counts and what the run left."""
    from classifying_vae_lstm_tpu_torch.cli import cl_vae_train
    from classifying_vae_lstm_tpu_torch.ops import vae_dense as vd
    from classifying_vae_lstm_tpu_torch.train.checkpoint import load_model_args

    plain_on_cuda = []
    with plain_guard(vd, VAE_DENSE_PLAIN, plain_on_cuda):
        args, counts, seen, epoch_s, wall = run_train(
            "seq_bf16", ["--num_epochs", "2", "--train_backend", "pallas"], model_dir,
            _reset_dense_counts, _dense_counts, cli=cl_vae_train, base_flags=SEQ_TRAIN_FLAGS)
        E, n_train, n_val = _report_train("bf16 seq-concat training path", args, seen, epoch_s,
                                          wall)
        fwd, bwd = E * (n_train + n_val), 2 * E * n_train
        print(f"bf16 seq-concat training: D={args.original_dim}, launches (forward, backward, "
              f"bf16 forward, bf16 backward) {counts} (expected {(fwd, bwd, fwd, bwd)})")
        require(counts == (fwd, bwd, fwd, bwd), f"bf16 dense-stack launches {counts}")
        margs = load_model_args(seen["ckpt"])
        require((margs["train_backend"], margs["bf16_compute"], margs["original_dim"])
                == ("pallas", True, args.original_dim), f"args.json {margs}")
        seen.update(step_ms=epoch_s[-1] * 1e3 / n_train)
        args_x, counts_x, seen_x, epoch_x, wall_x = run_train(
            "seq_bf16_xla", ["--num_epochs", "1", "--train_backend", "xla"], model_dir,
            _reset_dense_counts, _dense_counts, cli=cl_vae_train, base_flags=SEQ_TRAIN_FLAGS)
    _report_train("bf16 seq-concat --train_backend xla", args_x, seen_x, epoch_x, wall_x)
    require(counts_x == (0, 0, 0, 0), f"the xla route launched dense-stack kernels: {counts_x}")
    require(not plain_on_cuda, f"plain dense-stack versions ran on CUDA tensors: {plain_on_cuda}")
    loss_k, loss_x = seen["history"]["loss"][0], seen_x["history"]["loss"][0]
    rel = abs(loss_k - loss_x) / abs(loss_x)
    print(f"bf16 seq-concat first epoch train loss: pallas {loss_k!r}, xla {loss_x!r}, relative "
          f"difference {rel:.3e} (limit 1e-2: the routes round at different places); ms per "
          f"step, first epoch: pallas {epoch_s[0] * 1e3 / n_train:.3f}, xla "
          f"{epoch_x[0] * 1e3 / n_train:.3f}; epoch s: pallas {[round(v, 3) for v in epoch_s]}, "
          f"xla {[round(v, 3) for v in epoch_x]}")
    require(rel <= 1e-2, f"first-epoch losses differ by {rel}")
    return counts[2], counts[3], seen


def counted_serve(argv, extra=()):
    """``cli.serve`` built from ``argv`` and driven by :func:`exercise_server`;
    the cl_vae launch counts are set to 0 just before. Returns (launches,
    cluster launches, engine device calls, warm-up (launches, calls), /stats,
    the engine, cooperative launches)."""
    from classifying_vae_lstm_tpu_torch.cli import serve
    from classifying_vae_lstm_tpu_torch.ops import cuda_generate_vae as cgv
    from classifying_vae_lstm_tpu_torch.serving import GenerationEngine

    runs, runs_lock = [0], threading.Lock()
    real_run = GenerationEngine._run

    def counted_run(self, *a, **k):
        with runs_lock:
            runs[0] += 1
        return real_run(self, *a, **k)

    args = serve.build_parser().parse_args(argv)
    plain_on_cuda = []
    GenerationEngine._run = counted_run
    try:
        with sampler_plain_guard(cgv, "generate_cl_vae_batch_plain", plain_on_cuda):
            cgv.LAUNCHES = cgv.CLUSTER_LAUNCHES = cgv.COOP_LAUNCHES = 0  # this path's counts
            t0 = time.perf_counter()
            httpd, engine = serve.make_server(args)
            warm = (cgv.LAUNCHES, runs[0])
            print(f"cl_vae engine built and warmed in {time.perf_counter() - t0:.2f} s "
                  f"({warm[0]} warm-up launches for {warm[1]} device calls)")
            stats = exercise_server(httpd, extra)
            launches, cluster, calls = cgv.LAUNCHES, cgv.CLUSTER_LAUNCHES, runs[0]
            coop = cgv.COOP_LAUNCHES
    finally:
        GenerationEngine._run = real_run
    require(not plain_on_cuda, f"plain version ran on CUDA tensors: {plain_on_cuda}")
    return launches, cluster, calls, warm, stats, engine, coop


def sample_one_launch(ckpt, run_name, out_dir, n=4, t=32, count="CLUSTER_LAUNCHES",
                      seq_length=1):
    """``cli.cl_vae_sample`` of ``ckpt`` with true keys: one launch, of the
    kernel whose count ``count`` names (the cluster, the cooperative or the
    wide kernel); t steps of ``seq_length`` frames a song; MIDI files
    written. Returns the launches."""
    import numpy as np

    from classifying_vae_lstm_tpu_torch.cli import cl_vae_sample
    from classifying_vae_lstm_tpu_torch.ops import cuda_generate_vae as cgv

    args = cl_vae_sample.build_parser().parse_args(
        [run_name, "-i", ckpt, "-n", str(n), "-t", str(t), "--train_file", CORPUS,
         "--sample_dir", out_dir])
    plain_on_cuda = []
    with sampler_plain_guard(cgv, "generate_cl_vae_batch_plain", plain_on_cuda):
        cgv.LAUNCHES = cgv.CLUSTER_LAUNCHES = cgv.COOP_LAUNCHES = cgv.WIDE_LAUNCHES = 0
        samples = cl_vae_sample.sample(args)
        launches, ours = cgv.LAUNCHES, getattr(cgv, count)
    files = sorted(f for f in os.listdir(out_dir) if f.startswith(run_name))
    print(f"cl_vae_sample {ckpt}: {n} songs x {t} frames, {launches} launch ({ours} counted by "
          f"{count}), {int(samples.sum())} notes on, {len(files)} MIDI files")
    require(samples.shape == (n, t * seq_length, 88)
            and set(np.unique(samples).tolist()) <= {0, 1},
            f"samples {samples.shape}")
    require(launches == ours == 1 and len(files) == n and not plain_on_cuda,
            f"cl_vae_sample: {launches} launches ({ours} {count}), files {files}, plain "
            f"{plain_on_cuda}")
    return ours


REPAIR_FLAGS = ["--train_file", CORPUS, "--latent_dim", "4", "--batch_size", str(VAE_TRAIN_B),
                "--use_x_prev", "--patience", "0", "--num_epochs", "2"]
# a seq-concat model without hidden layers whose z heads (2L x D f32, every
# block holds them all) 8 blocks do not hold: the wide kernel's (D=1,024 at
# --seq_length 16, L=32; seq-concat takes no x_prev in either package)
NO_HIDDEN_SEQ_FLAGS = ["--train_file", CORPUS, "--latent_dim", "32", "--batch_size",
                       str(VAE_TRAIN_B), "--patience", "0", "--num_epochs", "2"]


def phase_vae_repair(model_dir, out_dir):
    """Checkpoints past one block's shared memory, and without hidden layers,
    trained by the port on the card, sample and serve: a bf16 H=512 model
    (``--bf16_compute --train_backend pallas``) through
    ``cli.cl_vae_sample`` and ``cli.serve`` on the cluster kernel (two blocks
    a cluster), then a model without hidden layers (``xla``) through
    ``cli.cl_vae_sample`` on the cluster kernel, and a seq-concat one
    without hidden layers (``--seq_length 16``, L=32: D=1,024, z heads past
    what 8 blocks hold) on the wide kernel. Two epochs each: the first epoch saves no
    checkpoint. Returns the launches of the cluster kernel at bf16 H=512 and
    without hidden layers, and of the wide kernel."""
    from classifying_vae_lstm_tpu_torch.cli import cl_vae_train, common
    from classifying_vae_lstm_tpu_torch.ops import cuda_generate_vae as cgv

    args, counts, seen, epoch_s, wall = run_train(
        "wide_bf16", ["--intermediate_dim", "512", "--bf16_compute", "--train_backend", "pallas"],
        model_dir, _reset_dense_counts, _dense_counts, cli=cl_vae_train, base_flags=REPAIR_FLAGS)
    E, n_train, n_val = _report_train("bf16 H=512 training", args, seen, epoch_s, wall)
    require(counts[2:] == (E * (n_train + n_val), 2 * E * n_train), f"launches {counts}")
    _, cfg, _ = common.load_model(seen["ckpt"], "cl_vae")
    require(cgv.kernel_for(cfg) == CLUSTER and cgv.pick_mode(cfg) == "bf16"
            and cgv.cluster_plan(cfg, 8)["C"] == 2,
            f"the H=512 checkpoint routes to {cgv.kernel_for(cfg)}, {cgv.pick_mode(cfg)}")
    cluster = sample_one_launch(seen["ckpt"], "smoke_wide_bf16", out_dir)
    launches, w, calls, warm, stats, engine, c = counted_serve(
        ["-i", seen["ckpt"], "--train_file", CORPUS, "--dynamic_batching", "--warmup", "off",
         "--port", "0"])
    lat = engine.latency_stats()
    print(f"cl_vae serving of the bf16 H=512 checkpoint: {launches} launches ({w} of the "
          f"cluster kernel, {c} of the cooperative one) for {calls} engine device calls; requests "
          f"{stats['requests']}, batches {stats['batches']}; latency p50 {lat['p50_ms']:.3f} ms, "
          f"p95 {lat['p95_ms']:.3f} ms")
    require(launches == w == calls > 0 and c == 0,
            f"cluster launches {w}, cooperative {c}, all {launches}, calls {calls}")
    require(stats["batches"] > 0, "the burst was not coalesced (batches == 0)")
    cluster += w
    no_hidden = {}
    for name, seq, kernel, flags in (("no_hidden", 1, CLUSTER, REPAIR_FLAGS),
                                     ("no_hidden_seq", 16, WIDE, NO_HIDDEN_SEQ_FLAGS)):
        args, counts, seen, epoch_s, wall = run_train(
            name, ["--intermediate_dim", "0", "--seq_length", str(seq)], model_dir,
            _reset_dense_counts, _dense_counts, cli=cl_vae_train, base_flags=flags)
        _report_train(f"no-hidden training (xla), D={args.original_dim}", args, seen, epoch_s,
                      wall)
        require(counts == (0, 0, 0, 0), f"no-hidden training launched dense-stack kernels: "
                                        f"{counts}")
        _, cfg, _ = common.load_model(seen["ckpt"], "cl_vae")
        require(cgv.kernel_for(cfg) == kernel, f"the no-hidden checkpoint at D="
                                               f"{cfg.original_dim} routes to {cgv.kernel_for(cfg)}")
        no_hidden[kernel] = sample_one_launch(
            seen["ckpt"], f"smoke_{name}", out_dir, seq_length=seq,
            count="CLUSTER_LAUNCHES" if kernel == CLUSTER else "WIDE_LAUNCHES")
    return cluster, no_hidden[CLUSTER], no_hidden[WIDE]


def phase_vae_bf16_evaluate(ckpt):
    """``cli.evaluate --family cl_vae`` of the bf16 seq-concat checkpoint on
    the training corpus: a finite NLL over every test window."""
    import torch

    from classifying_vae_lstm_tpu_torch.cli import evaluate

    args = evaluate.build_parser().parse_args(
        ["-i", ckpt, "--family", "cl_vae", "--train_file", CORPUS, "--n_samples",
         str(EVAL_SAMPLES), "--batch_size", str(EVAL_B)])
    t0 = time.perf_counter()
    out = evaluate.evaluate(args)
    torch.cuda.synchronize()
    print(f"evaluate the bf16 seq-concat checkpoint on {CORPUS}: NLL "
          f"{out['test_nll_nats_per_frame']} nats/frame over {out['n_test_examples']} windows, "
          f"wall {time.perf_counter() - t0:.3f} s")
    require(math.isfinite(out["test_nll_nats_per_frame"]) and out["n_test_examples"] > 0,
            f"evaluation {out}")



# the bf16 cl_vrnn of the JAX package's scale work (tools/bench_train_scale.py:
# D=88, H=1024, L=2, T=16, use_x_prev, B=1024), with the 13 keys of the
# committed corpus in place of its K=10
BF16_H, BF16_L, BF16_B = 1024, 2, 1024
BF16_FLAGS = ["--train_file", CORPUS, "--intermediate_dim", str(BF16_H), "--latent_dim",
              str(BF16_L), "--seq_length", str(TRAIN_T), "--batch_size", str(BF16_B),
              "--use_x_prev", "--patience", "0", "--two_cell", "off"]
# what the JAX package's --lstm_backend auto writes into args.json at H=1024
# on a TPU (cli/common.py resolve_lstm_backend; cli/cl_vrnn_train.py)
AUTO_H1024 = {"lstm_backend": "pallas", "bf16_compute": True, "fusion": [True, True, True],
              "two_cell": False}


def bf16_outside(got, ref):
    """Kernel-vs-plain errors of a bf16 forward's outputs (h, c, z, h_prev,
    c_prev, as many as given): (max abs error, relative Frobenius) per
    output, and those beyond 1e-2 x max(1, max|plain|) or 1e-3 relative.
    Both sides round at the same places and sum in f32 in another order, so
    a rounding may land on the other bf16 neighbour."""
    errs, bad = {}, {}
    for name, k, p in zip(("h", "c", "z", "h_prev", "c_prev"), got, ref):
        k, p = k.float(), p.float()
        err = (k - p).abs().max().item()
        rel = ((k - p).norm() / p.norm().clamp_min(1e-30)).item()
        errs[name] = (err, rel)
        if not (err <= 1e-2 * max(1.0, p.abs().max().item()) and rel <= 1e-3
                and math.isfinite(err)):
            bad[name] = (err, rel)
    return errs, bad


def _fmt_errs(errs):
    return ", ".join(f"{n} {e:.3e} ({r:.2e})" for n, (e, r) in errs.items())


def phase_lstm_seq_bf16(dev):
    """The bf16 stream mode of the three whole-sequence LSTM kernels against
    their bf16 plain versions at phase 21's width, on the model's seeded
    Keras init: training forward and backward at B=1024, T=16, H=1024 for
    the encoder (IN=101) and the decoder (IN=103), and the inference forward
    at the evaluation shape (12,800 rows). Returns the kernel-table fields of
    each, from the encoder cell, with bounds at the bf16 rate."""
    import numpy as np
    import torch

    from classifying_vae_lstm_tpu_torch.nn.core import init_lstm
    from classifying_vae_lstm_tpu_torch.ops import lstm_seq as ls

    rng = np.random.default_rng(SEED + 9)
    gen = torch.Generator().manual_seed(SEED + 9)
    D, H, T = 88, BF16_H, TRAIN_T
    H4 = 4 * H
    cells = {"encoder_h": D + TRAIN_K, "decoder_h": D + BF16_L + TRAIN_K}
    raw = {c: {k: v.numpy() for k, v in init_lstm(gen, IN, H).items()}
           for c, IN in cells.items()}
    fwd_fmas = lambda B, IN: T * B * (IN + H) * H4
    bf = lambda ins: (ins[0].bfloat16(), ins[1], ins[2], ins[3].bfloat16(), *ins[4:])
    f32, b16 = torch.float32, torch.bfloat16
    table = {}
    for cell in cells:
        B = BF16_B
        ins = bf(_lstm_inputs(rng, dev, raw[cell], B, T, D, H))
        x, w, _, rk, _, _ = ins
        IN = x.shape[-1]
        got = ls.lstm_seq_train_fwd(*ins)
        inf = ls.lstm_seq_fwd(*ins)
        ref = ls.lstm_seq_train_fwd_plain(*ins)
        torch.cuda.synchronize()
        types = [o.dtype for o in got]
        require(types == [o.dtype for o in ref] == [f32, f32, b16, b16, f32],
                f"bf16 training forward output types {types}")
        errs, bad = bf16_outside(got, ref)
        ierrs, ibad = bf16_outside(inf, ref)
        print(f"lstm_seq bf16 {cell} at B={B} T={T} IN={IN} H={H}: max |kernel - plain| "
              f"(relative Frobenius) {_fmt_errs(errs)}; inference forward {_fmt_errs(ierrs)} "
              "(limits 1e-2 x max(1, max|plain|) and 1e-3 relative)")
        require(not bad and not ibad, f"bf16 LSTM forward differs: {bad} {ibad}")
        h, c, z, hp, cp = ref
        dh = torch.from_numpy((1e-2 * rng.standard_normal(tuple(h.shape))).astype(np.float32))
        dc = torch.zeros_like(dh)
        dc[-1] = torch.from_numpy((1e-2 * rng.standard_normal((B, H))).astype(np.float32))
        res = (z, cp, c, hp, x, dh.to(dev), dc.to(dev), rk.T.contiguous(), w.T.contiguous())
        bgot = ls.lstm_seq_bwd(*res)
        bwant = ls.lstm_seq_bwd_plain(*res)
        torch.cuda.synchronize()
        rel = {n: ((g.float() - wv.float()).norm() / wv.float().norm().clamp_min(1e-30)).item()
               for n, g, wv in zip(("dx", "dh0", "dc0", "drk", "dw", "db"), bgot, bwant)}
        types = [g.dtype for g in bgot]
        representable = lambda g: torch.equal(g.float(), g.bfloat16().float())
        print(f"lstm_seq bf16 {cell} backward: relative Frobenius "
              + ", ".join(f"{n} {v:.2e}" for n, v in rel.items())
              + f" (limit 1e-2); types {[str(t)[6:] for t in types]}; dRk bf16-representable "
              f"{representable(bgot[3])}, dW {representable(bgot[4])}, db "
              f"{representable(bgot[5])}")
        require(all(v <= 1e-2 and math.isfinite(v) for v in rel.values()),
                f"bf16 LSTM backward differs: {rel}")
        require(types == [b16, f32, f32, b16, f32, f32], f"bf16 backward output types {types}")
        require(not representable(bgot[4]) and not representable(bgot[5]),
                "dW or db came back rounded to bf16")
        bwd_err = max((g.float() - wv.float()).abs().max().item() for g, wv in zip(bgot, bwant))

        tk = time_ms(lambda: ls.lstm_seq_train_fwd(*ins), reps=10, warm=2)
        ik = time_ms(lambda: ls.lstm_seq_fwd(*ins), reps=10, warm=2)
        tp = time_ms(lambda: ls.lstm_seq_train_fwd_plain(*ins), reps=3)
        bk = time_ms(lambda: ls.lstm_seq_bwd(*res), reps=10, warm=2)
        bp = time_ms(lambda: ls.lstm_seq_bwd_plain(*res), reps=3)
        split = device_split(lambda: ls.lstm_seq_bwd(*res), 3, BWD_PARTS)
        tb_ms, tb_by = roofline_ms(fwd_fmas(B, IN), _nbytes(ins) + _nbytes(got), PEAK_BF16_FLOPS)
        bb_ms, bb_by = roofline_ms(T * B * H4 * (2 * (H + IN) + 1),
                                   _nbytes(res) + _nbytes(bgot), PEAK_BF16_FLOPS)
        print(f"lstm_seq bf16 {cell} at the training shape: training forward {tk:.3f} ms "
              f"(plain {tp:.3f}, bound {tb_ms:.4f} {tb_by}, bf16 rate); inference forward "
              f"{ik:.3f} ms; backward {bk:.3f} ms (plain {bp:.3f}, bound {bb_ms:.4f} {bb_by}); "
              f"its device time per call: {split}")
        if cell == "encoder_h":
            table["train_fwd"] = {"max_abs_err": max(e for e, _ in errs.values()), "ms": tk,
                                  "plain_ms": tp, "bound_ms": tb_ms, "bound_by": tb_by}
            table["bwd"] = {"max_abs_err": bwd_err, "ms": bk, "plain_ms": bp, "bound_ms": bb_ms,
                            "bound_by": bb_by}
        del got, inf, ref, res, bgot, bwant

    for cell in cells:
        B = EVAL_SAMPLES * EVAL_B
        ins = bf(_lstm_inputs(rng, dev, raw[cell], B, T, D, H))
        IN = ins[0].shape[-1]
        got = ls.lstm_seq_fwd(*ins)
        ref = ls.lstm_seq_fwd_plain(*ins)
        torch.cuda.synchronize()
        errs, bad = bf16_outside(got, ref)
        require(not bad, f"bf16 LSTM inference forward differs at the evaluation shape: {bad}")
        k_ms = time_ms(lambda: ls.lstm_seq_fwd(*ins), reps=3, warm=1)
        p_ms = time_ms(lambda: ls.lstm_seq_fwd_plain(*ins), reps=2, warm=1)
        b_ms, b_by = roofline_ms(fwd_fmas(B, IN), _nbytes(ins) + _nbytes(got), PEAK_BF16_FLOPS)
        print(f"lstm_seq bf16 {cell} inference forward at the evaluation shape (B={B} T={T} "
              f"IN={IN} H={H}): max |kernel - plain| (relative Frobenius) {_fmt_errs(errs)}; "
              f"kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}, bf16 "
              "rate)")
        if cell == "encoder_h":
            table["fwd"] = {"max_abs_err": max(e for e, _ in errs.values()), "ms": k_ms,
                            "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by}
        del got, ref, ins
    torch.cuda.empty_cache()
    return table


def phase_train_bf16(model_dir):
    """The bf16 cl_vrnn at H=1024 trained through the bf16 streams of the
    whole-sequence LSTM kernels: ``cli.cl_vrnn_train`` (its Trainer and fit)
    with the args the JAX package's ``--lstm_backend auto`` writes at this
    width, 2 epochs, and args.json read back through
    ``cl_vrnn_config_from_args``; then 1 epoch of the ``xla`` route from the
    same seed. Returns the bf16 training-forward and backward launches and
    what the run left."""
    from classifying_vae_lstm_tpu_torch.cli import common
    from classifying_vae_lstm_tpu_torch.ops import lstm_seq as ls
    from classifying_vae_lstm_tpu_torch.ops import two_cell as tc
    from classifying_vae_lstm_tpu_torch.train.checkpoint import load_model_args

    plain_on_cuda = []
    with plain_guard(ls, LSTM_SEQ_PLAIN, plain_on_cuda), \
            plain_guard(tc, ("two_cell_fwd_plain", "two_cell_bwd_plain"), plain_on_cuda):
        args, counts, seen, epoch_s, wall = run_train(
            "h1024_bf16", ["--num_epochs", "2", "--lstm_backend", "pallas"], model_dir,
            _reset_lstm_counts, _lstm_counts, base_flags=BF16_FLAGS,
            overrides={"bf16_compute": True})
        E, n_train, n_val = _report_train("bf16 H=1024 training path", args, seen, epoch_s,
                                          wall)
        expected = lstm_expected(BF16_FWD=2 * E * n_val, BF16_TRAIN_FWD=2 * E * n_train,
                                 BF16_BWD=4 * E * n_train)
        print(f"bf16 H=1024 training: K={args.n_classes} (the corpus's keys; the scale bench "
              f"has 10); launches {nonzero(counts)} (expected {nonzero(expected)}, every other "
              "count 0)")
        require(counts == expected, f"bf16 LSTM launches {counts} != {expected}")
        margs = load_model_args(seen["ckpt"])
        cfg = common.cl_vrnn_config_from_args(margs)
        require({k: margs[k] for k in AUTO_H1024} == AUTO_H1024, f"args.json {margs}")
        require((cfg.intermediate_dim, cfg.bf16_compute, cfg.lstm_backend, cfg.fusion,
                 cfg.two_cell, cfg.n_classes)
                == (BF16_H, True, "pallas", (True, True, True), False, TRAIN_K),
                f"config read back {cfg}")
        seen.update(step_ms=epoch_s[-1] * 1e3 / n_train)
        args_x, counts_x, seen_x, epoch_x, wall_x = run_train(
            "h1024_bf16_xla", ["--num_epochs", "1", "--lstm_backend", "xla"], model_dir,
            _reset_lstm_counts, _lstm_counts, base_flags=BF16_FLAGS,
            overrides={"bf16_compute": True})
    _report_train("bf16 H=1024 --lstm_backend xla", args_x, seen_x, epoch_x, wall_x)
    require(not any(counts_x.values()), f"the xla route launched LSTM kernels: {counts_x}")
    require(not plain_on_cuda, f"plain versions ran on CUDA tensors: {plain_on_cuda}")
    loss_k, loss_x = seen["history"]["loss"][0], seen_x["history"]["loss"][0]
    rel = abs(loss_k - loss_x) / abs(loss_x)
    print(f"bf16 H=1024 first epoch train loss: pallas {loss_k!r}, xla {loss_x!r}, relative "
          f"difference {rel:.3e} (limit 1e-2: the routes round at different places); ms per "
          f"step, first epoch: pallas {epoch_s[0] * 1e3 / n_train:.3f}, xla "
          f"{epoch_x[0] * 1e3 / n_train:.3f}; epoch s: pallas {[round(v, 3) for v in epoch_s]}, "
          f"xla {[round(v, 3) for v in epoch_x]}")
    require(rel <= 1e-2, f"first-epoch losses differ by {rel}")
    seen.update(xla_loss=loss_x)
    return counts["BF16_TRAIN_FWD"], counts["BF16_BWD"], seen


def phase_evaluate_bf16(ckpt, out_dir, nll_f32):
    """Phase 21's checkpoint evaluated through the bf16 inference kernel
    (``--lstm_backend keep``) and through plain PyTorch (``xla``), a profile
    of one evaluation batch, ``cli.cl_vrnn_sample`` of it through the bf16
    mode of the generation kernel; then ``jsball_vrnn4`` with its args
    flagged as ``--lstm_backend auto`` flags them, evaluated through the
    bf16 kernel on ``Piano-midi_Cs``. Returns the bf16 inference-forward
    launches of the first evaluation."""
    import shutil

    from classifying_vae_lstm_tpu_torch.ops import lstm_seq as ls
    from classifying_vae_lstm_tpu_torch.train.checkpoint import load_model_args

    common_argv = ["--n_samples", str(EVAL_SAMPLES), "--batch_size", str(EVAL_B)]
    expected = lstm_expected(BF16_FWD=2 * -(-EVAL_WINDOWS // EVAL_B))
    plain_on_cuda = []
    with plain_guard(ls, LSTM_SEQ_PLAIN, plain_on_cuda):
        out_k, counts_k, nll_k, est_k, wall_k = _evaluate_counted(
            ["-i", ckpt, "--train_file", CORPUS, "--lstm_backend", "keep", *common_argv])
        out_x, counts_x, nll_x, _, wall_x = _evaluate_counted(
            ["-i", ckpt, "--train_file", CORPUS, "--lstm_backend", "xla", *common_argv])
        rel = abs(nll_k - nll_x) / abs(nll_x)
        print(f"evaluate the bf16 H=1024 checkpoint on {CORPUS} ({out_k['n_test_examples']} "
              f"windows, {EVAL_SAMPLES} samples, batches of {EVAL_B}): keep (bf16 kernels) NLL "
              f"{nll_k!r} in {wall_k:.3f} s, launches {nonzero(counts_k)} (expected "
              f"{nonzero(expected)}); xla NLL {nll_x!r} in {wall_x:.3f} s, launches "
              f"{nonzero(counts_x)}; relative difference "
              f"{rel:.3e} (limit 1e-2: the routes round at different places)")
        require(out_k["n_test_examples"] == out_x["n_test_examples"] == EVAL_WINDOWS,
                f"test windows {out_k['n_test_examples']}, {out_x['n_test_examples']}")
        require(counts_k == expected, f"bf16 evaluation launches {counts_k}")
        require(not any(counts_x.values()), f"xla evaluation launched kernels: {counts_x}")
        require(math.isfinite(nll_k) and rel <= 1e-2, f"NLLs differ: {nll_k} vs {nll_x}")
        profile_eval_batch(est_k)

        # jsball_vrnn4 flagged as the JAX package's auto flags a scaled checkpoint
        flagged = os.path.join(out_dir, "jsball_vrnn4_auto.npz")
        shutil.copyfile(MODEL, flagged)
        with open(flagged.replace(".npz", ".json"), "w") as f:
            json.dump({**load_model_args(MODEL), **AUTO_H1024}, f)
        out_j, counts_j, nll_j, _, wall_j = _evaluate_counted(
            ["-i", flagged, "--train_file", EVAL_CORPUS, *common_argv])
        print(f"evaluate jsball_vrnn4 flagged bf16 on {EVAL_CORPUS}: NLL {nll_j!r} (printed "
              f"{out_j['test_nll_nats_per_frame']}) in {wall_j:.3f} s, launches "
              f"{nonzero(counts_j)}; the "
              f"f32 checkpoint's (phase 10) {nll_f32!r}, difference {nll_j - nll_f32:.3e}")
        require(counts_j == expected and out_j["n_test_examples"] == EVAL_WINDOWS
                and math.isfinite(nll_j), f"flagged evaluation {out_j}, launches {counts_j}")

    sample_cl_vrnn_bf16(ckpt, "smoke_bf16", out_dir, "bf16 H=1024")
    return counts_k["BF16_FWD"]


# the bf16 two-cell cl_vrnn of the JAX package's scale work at H=512
# (artifacts/two_cell_exp.json row H512_B1024_bf16, tools/bench_train_scale.py:
# D=88, L=2, T=16, use_x_prev, B=1024), with the 13 keys of the committed
# corpus in place of its K=10
H512_H, H512_B = 512, 1024
H512_FLAGS = ["--train_file", CORPUS, "--intermediate_dim", str(H512_H), "--latent_dim",
              str(BF16_L), "--seq_length", str(TRAIN_T), "--batch_size", str(H512_B),
              "--use_x_prev", "--patience", "0", "--two_cell", "on"]
# what the JAX package's --lstm_backend auto writes into args.json at H=512
# on a TPU (its two-cell gate is 256 <= H < 1024)
AUTO_H512 = {"lstm_backend": "pallas", "bf16_compute": True, "fusion": [True, True, True],
             "two_cell": True}
TWO_CELL_PLAIN = ("two_cell_fwd_plain", "two_cell_bwd_plain")


def bf16_step_at_max(t) -> float:
    """One bf16 step (ulp) at the largest magnitude of ``t``."""
    m = t.float().abs().max().item()
    return 2.0 ** (math.floor(math.log2(m)) - 7) if m > 0 else 0.0


def phase_two_cell_bf16(dev):
    """The bf16 stream mode of both two-cell kernels against their bf16
    plain versions at phase 24's shape (B=1,024, T=16, D=88, H=512, L=2,
    K=13, use_x_prev) on the model's seeded Keras init. Forward: the f32
    outputs (hd, zargs, the c streams) within 1e-2 x max(1, max|plain|) and
    1e-3 relative Frobenius (an h or z operand that lands on the other bf16
    neighbour moves its row's later steps), the bf16 streams (ze, zd, hpe,
    he, hpd) within one bf16 step at their largest entry; backward: every output within 1e-2 of its largest entry;
    output types checked, the streams and the six weight gradients bf16,
    the bias sums not rounded. Returns the kernel-table fields of each, with
    bounds at the bf16 rate."""
    import numpy as np
    import torch

    from classifying_vae_lstm_tpu_torch.models import cl_vrnn
    from classifying_vae_lstm_tpu_torch.ops import two_cell as tc

    B, T, D, H, L, K = H512_B, TRAIN_T, 88, H512_H, BF16_L, TRAIN_K
    cfg = cl_vrnn.Config(original_dim=D, intermediate_dim=H, latent_dim=L, seq_length=T,
                         n_classes=K, use_x_prev=True, lstm_backend="pallas",
                         bf16_compute=True, two_cell=True)
    params = cl_vrnn.init(torch.Generator(device=dev).manual_seed(SEED + 11), cfg)
    rng = np.random.default_rng(SEED + 11)
    f = lambda a: torch.from_numpy(a).to(dev)
    x = f((rng.random((B, T, D)) < 0.1).astype(np.float32))
    xp = f((rng.random((B, T, D)) < 0.1).astype(np.float32))
    W = torch.softmax(f(rng.standard_normal((B, K)).astype(np.float32)), -1)
    eps = f(rng.standard_normal((B, T, L)).astype(np.float32))
    ins = tc.pack_inputs(params, cfg, x, xp, W, eps, torch.bfloat16)
    b16, f32 = torch.bfloat16, torch.float32
    representable = lambda t: torch.equal(t.float(), t.float().bfloat16().float())

    outs = tc.two_cell_fwd(*ins)
    ref = tc.two_cell_fwd_plain(*ins)
    torch.cuda.synchronize()
    names = ("hd", "zargs", "ze", "zd", "hpe", "cpe", "ce", "he", "hpd", "cpd", "cd")
    streams = {"ze", "zd", "hpe", "he", "hpd"}
    errs, bad = {}, []
    for n, k, p in zip(names, outs, ref):
        want = b16 if n in streams else f32
        err = (k.float() - p.float()).abs().max().item()
        fro = ((k.float() - p.float()).norm() / p.float().norm().clamp_min(1e-30)).item()
        if n in streams:
            ok = err <= bf16_step_at_max(p) and representable(k)
        else:
            ok = err <= 1e-2 * max(1.0, p.abs().max().item()) and fro <= 1e-3
        errs[n] = (err, fro)
        if not (k.dtype == p.dtype == want and ok and math.isfinite(err)):
            bad.append((n, str(k.dtype), err, fro))
    print(f"two-cell bf16 forward, B={B} T={T} H={H} L={L} K={K}: max |kernel - plain| "
          f"(relative Frobenius) {_fmt_errs(errs)}; limits: f32 outputs 1e-2 x max(1, "
          "max|plain|) and 1e-3 relative (phase 20's bf16 bounds), bf16 streams one bf16 step at "
          "their largest entry")
    require(not bad, f"two-cell bf16 forward differs: {bad}")
    fwd_err = max(e for e, _ in errs.values())
    same_bits(tc.two_cell_fwd, ins, outs, names, "two-cell bf16 forward")

    (xe, xd, eps_t, we, be, rke, wdx, bd, rkd, kz, wz, bz, *_) = ins
    hd, zargs, ze, zd, hpe, cpe, ce, he, hpd, cpd, cd = ref
    dhd = f((1e-2 * rng.standard_normal(tuple(hd.shape))).astype(np.float32))
    dza = f((1e-2 * rng.standard_normal(tuple(zargs.shape))).astype(np.float32))
    res = (ze, zd, cpe, ce, cpd, cd, hpe, he, hpd, eps_t, zargs, xe, xd, dhd, dza,
           we, rke, wdx, rkd, kz, wz)
    got = tc.two_cell_bwd(*res)
    want = tc.two_cell_bwd_plain(*res)
    torch.cuda.synchronize()
    gnames = ("dxe", "dxd", "dh0e", "dc0e", "dh0d", "dc0d", "drke", "drkd", "dwe", "dwdx", "dkz",
              "dwz", "dbe", "dbd", "dbz")
    rounded = {"dxe", "dxd", "drke", "drkd", "dwe", "dwdx", "dkz", "dwz"}
    rel, bad = {}, []
    for n, g, w in zip(gnames, got, want):
        err, scale = (g.float() - w.float()).abs().max().item(), w.float().abs().max().item()
        rel[n] = err / max(scale, 1e-30)
        types_ok = g.dtype == w.dtype == (b16 if n in rounded else f32)
        if not (types_ok and err <= 1e-2 * scale and math.isfinite(err)
                and (n not in rounded or representable(g))):
            bad.append((n, str(g.dtype), err, scale))
    unrounded = [n for n in ("dbe", "dbd", "dbz") if not representable(got[gnames.index(n)])]
    print("two-cell bf16 backward: max |kernel - plain| / max|plain| per output: "
          + ", ".join(f"{n} {rel[n]:.2e}" for n in gnames)
          + f" (limit 1e-2); bf16 outputs {sorted(rounded)}; bias sums not rounded: {unrounded}")
    require(not bad, f"two-cell bf16 backward differs: {bad}")
    require(unrounded == ["dbe", "dbd", "dbz"], f"bias sums rounded to bf16: {unrounded}")
    same_bits(tc.two_cell_bwd, res, got, gnames, "two-cell bf16 backward")
    bwd_err = max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want))

    fk_ms = time_ms(lambda: tc.two_cell_fwd(*ins), reps=10, warm=2)
    fp_ms = time_ms(lambda: tc.two_cell_fwd_plain(*ins), reps=3)
    bk_ms = time_ms(lambda: tc.two_cell_bwd(*res), reps=10, warm=2)
    bp_ms = time_ms(lambda: tc.two_cell_bwd_plain(*res), reps=3)
    INe, INd, R = xe.shape[-1], xd.shape[-1], T * B
    fwd_fmas = R * ((INe + H) * 4 * H + H * 2 * L + (INd + L + H) * 4 * H)
    fb_ms, fb_by = roofline_ms(fwd_fmas, _nbytes(ins) + _nbytes(outs), PEAK_BF16_FLOPS)
    bwd_fmas = R * (4 * H * (H + INd + L) + 2 * L * H + 4 * H * (H + INe)
                    + 4 * H * (2 * H + INe + INd + L + 2) + 2 * L * (H + 1))
    bb_ms, bb_by = roofline_ms(bwd_fmas, _nbytes(res) + _nbytes(got), PEAK_BF16_FLOPS)
    print(f"two-cell bf16 forward kernel {fk_ms:.3f} ms, plain {fp_ms:.3f} ms, bound "
          f"{fb_ms:.4f} ms ({fb_by}, bf16 rate); backward kernel {bk_ms:.3f} ms, "
          f"plain {bp_ms:.3f} ms, bound {bb_ms:.4f} ms ({bb_by}, bf16 rate)")
    print("two-cell bf16 forward, device time: "
          + device_split(lambda: tc.two_cell_fwd(*ins), 10, TWO_CELL_FWD_PARTS))
    print("two-cell bf16 backward, device time: "
          + device_split(lambda: tc.two_cell_bwd(*res), 10, TWO_CELL_BWD_PARTS)
          + f"; HMMA per bf16 product kernel: {hmma_counts('two_cell_tc', TWO_CELL_TC)}")
    del outs, ref, got, want, res, ins
    torch.cuda.empty_cache()
    return ({"max_abs_err": fwd_err, "ms": fk_ms, "plain_ms": fp_ms, "bound_ms": fb_ms,
             "bound_by": fb_by},
            {"max_abs_err": bwd_err, "ms": bk_ms, "plain_ms": bp_ms, "bound_ms": bb_ms,
             "bound_by": bb_by})


def _h512_counts():
    """:func:`_lstm_counts` and the bf16 two-cell forward and backward."""
    from classifying_vae_lstm_tpu_torch.ops import two_cell as tc

    return {**_lstm_counts(), "BF16_TWO_CELL_FWD": tc.BF16_FWD_LAUNCHES,
            "BF16_TWO_CELL_BWD": tc.BF16_BWD_LAUNCHES}


def _reset_h512_counts():
    from classifying_vae_lstm_tpu_torch.ops import two_cell as tc

    _reset_lstm_counts()
    tc.BF16_FWD_LAUNCHES = tc.BF16_BWD_LAUNCHES = 0


def phase_train_two_cell_bf16(model_dir):
    """The bf16 two-cell cl_vrnn at H=512 trained through the bf16 streams of
    the two-cell kernels by ``cli.cl_vrnn_train`` with the args the JAX
    package's ``--lstm_backend auto`` writes at this width: 1 epoch with
    ``--save_last``, then ``--resume`` for 1 more epoch (the run goes on at
    epoch 1 with the saved AdamWN count), then 1 epoch of the ``xla`` route
    from the same seed. Returns the bf16 forward and backward launches of the
    two kernel runs and what the resumed run left."""
    from classifying_vae_lstm_tpu_torch.cli import common
    from classifying_vae_lstm_tpu_torch.ops import lstm_seq as ls
    from classifying_vae_lstm_tpu_torch.ops import two_cell as tc
    from classifying_vae_lstm_tpu_torch.train.checkpoint import load_model_args, load_opt_state

    plain_on_cuda, runs = [], {}
    opt_file = os.path.join(model_dir, "h512_bf16.last.opt.npz")
    with plain_guard(tc, TWO_CELL_PLAIN, plain_on_cuda), \
            plain_guard(ls, LSTM_SEQ_PLAIN, plain_on_cuda):
        for label, flags in (("first", ["--num_epochs", "1", "--save_last"]),
                             ("resumed", ["--num_epochs", "2", "--resume"])):
            args, counts, seen, epoch_s, wall = run_train(
                "h512_bf16", [*flags, "--lstm_backend", "pallas"], model_dir,
                _reset_h512_counts, _h512_counts, base_flags=H512_FLAGS,
                overrides={"bf16_compute": True})
            leaves, epoch = load_opt_state(opt_file)
            runs[label] = (args, counts, seen, epoch_s, wall, int(leaves[0]), epoch)
        args_x, counts_x, seen_x, epoch_x, wall_x = run_train(
            "h512_bf16_xla", ["--num_epochs", "1", "--lstm_backend", "xla"], model_dir,
            _reset_h512_counts, _h512_counts, base_flags=H512_FLAGS,
            overrides={"bf16_compute": True})
    n_train, n_val = (len(runs["first"][2][k]["x"]) // H512_B for k in ("train", "val"))
    expected = {**lstm_expected(), "BF16_TWO_CELL_FWD": n_train + n_val,
                "BF16_TWO_CELL_BWD": 2 * n_train}
    for label, (args, counts, seen, epoch_s, wall, count, epoch) in runs.items():
        hist = seen["history"]
        print(f"bf16 two-cell H=512 {label} run: epochs {len(hist['loss'])} of {args.num_epochs} "
              f"({n_train} train + {n_val} eval steps each) in {wall:.2f} s; loss "
              f"{hist['loss']}, val_loss {hist['val_loss']}; ms per step (host clock, epoch "
              f"synchronised) {[round(s * 1e3 / n_train, 3) for s in epoch_s]}; epoch s "
              f"{[round(s, 3) for s in epoch_s]}; launches {nonzero(counts)} (expected "
              f"{nonzero(expected)}, every other count 0); .last.opt.npz count {count}, "
              f"epoch {epoch}")
        require(all(math.isfinite(v) for vals in hist.values() for v in vals), "non-finite loss")
        require(counts == expected, f"{label} run launches {counts} != {expected}")
    kw = runs["resumed"][2]["fit_kw"]
    first_count, resumed = runs["first"][5], runs["resumed"]
    require((runs["first"][6], first_count) == (1, n_train),
            f"first run saved epoch {runs['first'][6]}, count {first_count}")
    require(kw.get("initial_epoch") == 1 and int(kw["opt_state"][0]) == first_count,
            f"resumed run began at epoch {kw.get('initial_epoch')}")
    require((resumed[6], resumed[5]) == (2, 2 * n_train) and len(resumed[2]["history"]["loss"])
            == 1, f"resumed run saved epoch {resumed[6]}, count {resumed[5]}")
    loss0, loss1 = runs["first"][2]["history"]["loss"][0], resumed[2]["history"]["loss"][0]
    require(loss1 < loss0, f"train loss did not fall across the resume: {loss0} -> {loss1}")
    print(f"resume: the second run began at epoch {kw['initial_epoch']} with the saved AdamWN "
          f"count {int(kw['opt_state'][0])} and left epoch {resumed[6]}, count {resumed[5]}; "
          f"train loss {loss0!r} -> {loss1!r}")
    margs = load_model_args(resumed[2]["ckpt"])
    cfg = common.cl_vrnn_config_from_args(margs)
    require({k: margs[k] for k in AUTO_H512} == AUTO_H512, f"args.json {margs}")
    require((cfg.intermediate_dim, cfg.bf16_compute, cfg.lstm_backend, cfg.fusion, cfg.two_cell,
             cfg.n_classes) == (H512_H, True, "pallas", (True, True, True), True, TRAIN_K),
            f"config read back {cfg}")

    _report_train("bf16 H=512 --lstm_backend xla", args_x, seen_x, epoch_x, wall_x)
    require(not any(counts_x.values()), f"the xla route launched kernels: {counts_x}")
    require(not plain_on_cuda, f"plain versions ran on CUDA tensors: {plain_on_cuda}")
    loss_x = seen_x["history"]["loss"][0]
    rel = abs(loss0 - loss_x) / abs(loss_x)
    epoch_k = runs["first"][3]
    print(f"bf16 two-cell H=512 first epoch train loss: pallas {loss0!r}, xla {loss_x!r}, "
          f"relative difference {rel:.3e} (limit 1e-2: the routes round at different places); "
          f"ms per step, first epoch: pallas {epoch_k[0] * 1e3 / n_train:.3f}, xla "
          f"{epoch_x[0] * 1e3 / n_train:.3f}")
    require(rel <= 1e-2, f"first-epoch losses differ by {rel}")
    seen = resumed[2]
    seen.update(step_ms=resumed[3][-1] * 1e3 / n_train)
    fwd = sum(r[1]["BF16_TWO_CELL_FWD"] for r in runs.values())
    bwd = sum(r[1]["BF16_TWO_CELL_BWD"] for r in runs.values())
    return fwd, bwd, seen


def serve_one_request(ckpt, label):
    """``cli.serve`` of ``ckpt`` (no warm-up) answers one /generate request
    over HTTP with one launch of the generation kernel in its bf16 mode."""
    from classifying_vae_lstm_tpu_torch.ops import cuda_generate as cg

    bf16, int8, modes, _ = serve_requests(["-i", ckpt, "--train_file", CORPUS], cg,
                                          [{"n": 2, "t": 32}])
    require((bf16, int8) == (1, 0) and modes == ["bf16"],
            f"serve the {label} checkpoint: launches {bf16}, {int8}, modes {modes}")


def phase_evaluate_two_cell_bf16(ckpt, out_dir):
    """Phase 24's checkpoint downstream: ``cli.evaluate`` through the bf16
    inference kernel (``--lstm_backend keep``, 2 launches per batch, no
    two-cell launch) and through ``xla`` (NLLs within 1e-3 relative),
    ``cli.cl_vrnn_sample`` of it (one bf16 generation launch) and one
    /generate request through ``cli.serve``."""
    from classifying_vae_lstm_tpu_torch.ops import lstm_seq as ls
    from classifying_vae_lstm_tpu_torch.ops import two_cell as tc

    common_argv = ["--n_samples", str(EVAL_SAMPLES), "--batch_size", str(EVAL_B)]
    expected = lstm_expected(BF16_FWD=2 * -(-EVAL_WINDOWS // EVAL_B))
    plain_on_cuda = []
    with plain_guard(ls, LSTM_SEQ_PLAIN, plain_on_cuda):
        tc.BF16_FWD_LAUNCHES = tc.BF16_BWD_LAUNCHES = 0
        out_k, counts_k, nll_k, _, wall_k = _evaluate_counted(
            ["-i", ckpt, "--train_file", CORPUS, "--lstm_backend", "keep", *common_argv])
        out_x, counts_x, nll_x, _, wall_x = _evaluate_counted(
            ["-i", ckpt, "--train_file", CORPUS, "--lstm_backend", "xla", *common_argv])
        two_cell = (tc.BF16_FWD_LAUNCHES, tc.BF16_BWD_LAUNCHES)
    rel = abs(nll_k - nll_x) / abs(nll_x)
    print(f"evaluate the bf16 two-cell H=512 checkpoint on {CORPUS} "
          f"({out_k['n_test_examples']} windows, {EVAL_SAMPLES} samples, batches of {EVAL_B}): "
          f"keep (bf16 LSTM kernels) NLL {nll_k!r} in {wall_k:.3f} s, launches "
          f"{nonzero(counts_k)} (expected {nonzero(expected)}); xla NLL {nll_x!r} in "
          f"{wall_x:.3f} s, launches {nonzero(counts_x)}; "
          f"relative difference {rel:.3e} (limit 1e-3); bf16 two-cell launches {two_cell}")
    require(out_k["n_test_examples"] == out_x["n_test_examples"] == EVAL_WINDOWS,
            f"test windows {out_k['n_test_examples']}, {out_x['n_test_examples']}")
    require(counts_k == expected and not any(counts_x.values()) and two_cell == (0, 0),
            f"evaluation launches {counts_k}, {counts_x}, {two_cell}")
    require(math.isfinite(nll_k) and rel <= 1e-3, f"NLLs differ: {nll_k} vs {nll_x}")
    require(not plain_on_cuda, f"plain versions ran on CUDA tensors: {plain_on_cuda}")
    sample_cl_vrnn_bf16(ckpt, "smoke_h512", out_dir, "bf16 two-cell H=512")
    serve_one_request(ckpt, "bf16 two-cell H=512")


def sample_cl_vrnn_bf16(ckpt, run_name, out_dir, label):
    """``cli.cl_vrnn_sample`` of a bf16 checkpoint: 4 songs, one launch of
    the generation kernel, in its bf16 mode, and no plain version on a CUDA
    tensor."""
    from classifying_vae_lstm_tpu_torch.cli import cl_vrnn_sample
    from classifying_vae_lstm_tpu_torch.ops import cuda_generate as cg

    bf16, int8, modes, _ = sample_counted(
        cl_vrnn_sample, cg, [run_name, "-i", ckpt, "--infer_w", "-n", "4", "--train_file",
                             CORPUS, "--sample_dir", out_dir], 4)
    require((bf16, int8) == (1, 0) and modes == ["bf16"],
            f"cl_vrnn_sample of the {label} checkpoint: launches {bf16}, {int8}, modes {modes}")


# the bf16 cl_vrnn the JAX package trains at H=2,048
# (artifacts/fused_kernel_exp.json phase h2048, variant proj, "B1024 H2048
# bf16"; tools/bench_train_scale.py: D=88, L=2, T=16, use_x_prev, B=1024),
# with the 13 keys of the committed corpus in place of its K=10; past the drk
# ceiling (H >= 1,579) JAX --lstm_backend auto pins the proj-only rung
H2048_H, H2048_B = 2048, 1024
WIDE_WALK_H, WIDE_WALK_B = 2560, 256  # the widest H auto pins to that rung
# --two_cell off is what JAX auto writes at this width; the port's gate
# alone would take the two-cell route (ops/two_cell.BF16_TWO_CELL_MAX_H)
H2048_FLAGS = ["--train_file", CORPUS, "--intermediate_dim", str(H2048_H), "--latent_dim",
               str(BF16_L), "--seq_length", str(TRAIN_T), "--batch_size", str(H2048_B),
               "--use_x_prev", "--patience", "0", "--two_cell", "off"]
AUTO_H2048 = {"lstm_backend": "pallas", "bf16_compute": True, "fusion": [True, False, False],
              "two_cell": False}
H2048_EVAL_SAMPLES = 8  # a run length: 46 inference forwards of 1,600 rows at H=2,048
RUNG_KERNELS = ("xz_fwd", "xz_train_fwd", "walk", "walk_drk")


def rung_kernels(label, ins, reps):
    """The four kernels of the non-default rungs against their plain
    versions on one cell's inputs ``ins`` (x, w, b, rk, h0, c0; bf16 x and
    rk: the bf16 mode): the unfused forwards on xz = x @ W + b (rounded as
    ``lstm_sequence_pallas`` hoists it), the walks on the plain forward's
    residuals. f32: forward within :func:`fwd_outside`, backward within 1e-4
    x max|plain| + 1e-6; bf16: :func:`bf16_outside`, backward within 1e-2
    relative Frobenius. Returns the kernel-table fields per kernel (bounds at
    the stream type's rate)."""
    import numpy as np
    import torch

    from classifying_vae_lstm_tpu_torch.ops import lstm_seq as ls
    from classifying_vae_lstm_tpu_torch.ops.lstm import bf16_operand

    x, w, b, rk, h0, c0 = ins
    T, B, IN = x.shape
    H = rk.shape[0]
    bf16 = x.dtype == torch.bfloat16
    peak = PEAK_BF16_FLOPS if bf16 else PEAK_F32_FLOPS
    xz = x.float() @ (bf16_operand(w) if bf16 else w) + b
    xins = (xz.to(x.dtype).contiguous(), rk, h0, c0)
    got = ls.lstm_seq_xz_train_fwd(*xins)
    inf = ls.lstm_seq_xz_fwd(*xins)
    ref = ls.lstm_seq_xz_train_fwd_plain(*xins)
    torch.cuda.synchronize()
    require([o.dtype for o in got] == [o.dtype for o in ref]
            == [torch.float32, torch.float32, x.dtype], f"{label}: forward types")
    if bf16:
        errs, bad = bf16_outside(got, ref)
        ierrs, ibad = bf16_outside(inf, ref)
        bad.update({f"inference {n}": e for n, e in ibad.items()})
        fwd_err = max(e for e, _ in [*errs.values(), *ierrs.values()])
        shown = f"{_fmt_errs(errs)}; inference {_fmt_errs(ierrs)} (limits 1e-2 x max(1, " \
                "max|plain|) and 1e-3 relative)"
    else:
        names = ("h", "c", "z")
        errs = {n: (k - p).abs().max().item() for n, k, p in zip(names, got, ref)}
        errs.update({f"inference {n}": (k - p).abs().max().item()
                     for n, k, p in zip(names, inf, ref)})
        bad = fwd_outside(errs, dict(zip(names, ref)))
        fwd_err = max(errs.values())
        shown = ", ".join(f"{n} {e:.3e}" for n, e in errs.items()) + f" (limit {FWD_LIMIT})"
    print(f"{label}: unfused forwards, max |kernel - plain| {shown}")
    require(not bad, f"{label}: unfused forward differs: {bad}")

    h, c, z = ref
    rng = np.random.default_rng(SEED + 13)
    dh = torch.from_numpy((1e-2 * rng.standard_normal(tuple(h.shape))).astype(np.float32))
    dc = torch.zeros_like(dh)
    dc[-1] = torch.from_numpy((1e-2 * rng.standard_normal((B, H))).astype(np.float32))
    cp, hp = torch.cat([c0[None], c[:-1]]), torch.cat([h0[None], h[:-1]]).to(z.dtype)
    res = (z, cp, c, hp, dh.to(x.device), dc.to(x.device), rk.T.contiguous())
    walk_res = res[:3] + res[4:]
    outs = {"walk": ls.lstm_seq_walk(*walk_res), "walk_drk": ls.lstm_seq_walk_drk(*res)}
    torch.cuda.synchronize()
    want = ls.lstm_seq_walk_drk_plain(*res)
    bwd_err = {}
    for kind, out in outs.items():
        rel, bad = {}, []
        for n, g, wv in zip(("dz", "dh0", "dc0", "drk"), out, want):
            g, wv = g.float(), wv.float()
            err, scale = (g - wv).abs().max().item(), wv.abs().max().item()
            rel[n] = ((g - wv).norm() / wv.norm().clamp_min(1e-30)).item()
            ok = rel[n] <= 1e-2 if bf16 else err <= 1e-4 * scale + 1e-6
            if not (ok and math.isfinite(err)):
                bad.append((n, err, rel[n]))
        bwd_err[kind] = max((g.float() - wv.float()).abs().max().item()
                            for g, wv in zip(out, want))
        print(f"{label}: {kind} relative Frobenius "
              + ", ".join(f"{n} {v:.2e}" for n, v in rel.items())
              + f" (limit {'1e-2 relative' if bf16 else '1e-4 x max|plain| + 1e-6'}); types "
              f"{[str(o.dtype)[6:] for o in out]}")
        require(not bad, f"{label}: {kind} differs: {bad}")
        require(out[0].dtype == z.dtype and all(o.dtype == torch.float32 for o in out[1:]),
                f"{label}: {kind} output types")

    fwd_fmas, walk_fmas = T * B * H * 4 * H, T * B * 4 * H * H
    times = {
        "xz_train_fwd": (lambda: ls.lstm_seq_xz_train_fwd(*xins),
                         lambda: ls.lstm_seq_xz_train_fwd_plain(*xins), fwd_fmas,
                         _nbytes(xins) + _nbytes(got), fwd_err),
        "xz_fwd": (lambda: ls.lstm_seq_xz_fwd(*xins), lambda: ls.lstm_seq_xz_fwd_plain(*xins),
                   fwd_fmas, _nbytes(xins) + _nbytes(inf), fwd_err),
        "walk": (lambda: ls.lstm_seq_walk(*walk_res), lambda: ls.lstm_seq_walk_plain(*walk_res),
                 walk_fmas, _nbytes(walk_res) + _nbytes(outs["walk"]), bwd_err["walk"]),
        "walk_drk": (lambda: ls.lstm_seq_walk_drk(*res), lambda: ls.lstm_seq_walk_drk_plain(*res),
                     2 * walk_fmas, _nbytes(res) + _nbytes(outs["walk_drk"]),
                     bwd_err["walk_drk"]),
    }
    table = {}
    for kind, (kernel, plain, fmas, nbytes, err) in times.items():
        k_ms = time_ms(kernel, reps=reps, warm=1)
        p_ms = time_ms(plain, reps=reps, warm=1)
        b_ms, b_by = roofline_ms(fmas, nbytes, peak)
        table[kind] = {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                       "bound_by": b_by}
    if not bf16:  # the f32 walks: the full backward's walk, and the drk rung's split dRk
        for kind in ("walk", "walk_drk"):
            print(f"{label}: {kind} device split: "
                  + device_split(times[kind][0], 5, F32_WALK_PARTS))
    print(f"{label}: " + "; ".join(
        f"{k} {v['ms']:.3f} ms (plain {v['plain_ms']:.3f}, bound {v['bound_ms']:.4f} "
        f"{v['bound_by']}{', bf16 rate' if bf16 else ''})" for k, v in table.items()))
    return table


def rung_gradient_types(label, ins):
    """Every gradient of ``lstm_sequence(backend="pallas", fusion=f,
    compute_dtype=bf16)`` on the card for each non-default rung f, at one
    cell's width: finite, with JAX's types: dRk and dx bf16-valued, dW f32
    and unrounded at the proj rungs and bf16-valued at the unfused ones, db
    never rounded."""
    import torch

    from classifying_vae_lstm_tpu_torch.ops.lstm import lstm_sequence

    x, w, b, rk, h0, c0 = ins
    representable = lambda g: torch.equal(g, g.bfloat16().float())
    for fusion in ((True, True, False), (True, False, False), (False, True, False),
                   (False, False, False)):
        t = {"x": x.transpose(0, 1).float(), "kernel": w, "bias": b,
             "recurrent_kernel": rk.float()}
        t = {k: v.detach().clone().requires_grad_(True) for k, v in t.items()}
        params = {k: t[k] for k in ("kernel", "recurrent_kernel", "bias")}
        h, (hT, cT) = lstm_sequence(params, t["x"], h0, c0, backend="pallas",
                                    compute_dtype=torch.bfloat16, fusion=fusion)
        (1e-2 * h.float().sum() + cT.sum()).backward()
        g = {k: v.grad for k, v in t.items()}
        rounded = {k: representable(v) for k, v in g.items()}
        print(f"{label} fusion {fusion}: gradients bf16-valued {rounded}")
        require(all(torch.isfinite(v).all().item() for v in g.values()),
                f"{label} {fusion}: non-finite gradient")
        require(rounded == {"x": True, "kernel": not fusion[0], "bias": False,
                            "recurrent_kernel": True}, f"{label} {fusion}: gradient types")
        del h, hT, cT, g, t


def proj_forwards(label, ins, eval_ins):
    """The fused-projection forwards that phase 27 runs, at its shapes: the
    bf16 training forward and inference forward on one cell's training batch
    ``ins``, and the inference forward on one evaluation batch ``eval_ins``
    (8 samples x 200 windows), each against its plain version within
    :func:`bf16_outside`; their times beside the plain versions'."""
    import torch

    from classifying_vae_lstm_tpu_torch.ops import lstm_seq as ls

    got, inf = ls.lstm_seq_train_fwd(*ins), ls.lstm_seq_fwd(*ins)
    ref = ls.lstm_seq_train_fwd_plain(*ins)
    ev, ev_ref = ls.lstm_seq_fwd(*eval_ins), ls.lstm_seq_fwd_plain(*eval_ins)
    torch.cuda.synchronize()
    types = [o.dtype for o in got]
    require(types == [o.dtype for o in ref]
            == [torch.float32, torch.float32, torch.bfloat16, torch.bfloat16, torch.float32],
            f"{label}: training forward output types {types}")
    errs, bad = bf16_outside(got, ref)
    ierrs, ibad = bf16_outside(inf, ref)
    eerrs, ebad = bf16_outside(ev, ev_ref)
    B_eval = eval_ins[0].shape[1]
    print(f"{label}: fused-projection training forward, max |kernel - plain| (relative "
          f"Frobenius) {_fmt_errs(errs)}; inference forward {_fmt_errs(ierrs)}; inference "
          f"forward at B={B_eval} {_fmt_errs(eerrs)} (limits 1e-2 x max(1, max|plain|) and "
          "1e-3 relative)")
    require(not bad and not ibad and not ebad,
            f"{label}: fused-projection forward differs: {bad} {ibad} {ebad}")
    del got, inf, ref, ev, ev_ref
    ms = {name: time_ms(fn, reps=3, warm=1) for name, fn in (
        ("training forward", lambda: ls.lstm_seq_train_fwd(*ins)),
        ("plain", lambda: ls.lstm_seq_train_fwd_plain(*ins)),
        ("inference forward", lambda: ls.lstm_seq_fwd(*ins)),
        (f"inference forward at B={B_eval}", lambda: ls.lstm_seq_fwd(*eval_ins)),
        (f"plain at B={B_eval}", lambda: ls.lstm_seq_fwd_plain(*eval_ins)))}
    print(f"{label}: " + "; ".join(f"{n} {v:.3f} ms" for n, v in ms.items()))


def phase_lstm_rungs(dev):
    """The non-default rungs' kernels against their plain versions: bf16 at
    the H=2,048 training shape (B=1,024, T=16; the model's seeded Keras init,
    drawn on the card, 13 keys) for the encoder (IN=101) and the decoder
    (IN=103), beside the fused-projection forwards phase 27 runs there
    (:func:`proj_forwards`), the gradient types of each rung there, the walk
    at H=2,560 (B=256), and f32 at phase 8's training shape. Returns the
    kernel-table fields, f32 and bf16, from the encoder cell."""
    import numpy as np
    import torch

    from classifying_vae_lstm_tpu_torch.nn.core import init_lstm
    from classifying_vae_lstm_tpu_torch.ops import lstm_seq as ls

    rng = np.random.default_rng(SEED + 12)
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    D, H, T = 88, H2048_H, TRAIN_T
    bf = lambda ins: (ins[0].bfloat16(), ins[1], ins[2], ins[3].bfloat16(), *ins[4:])
    keras = lambda IN, H: {k: v.cpu().numpy() for k, v in init_lstm(gen, IN, H).items()}
    table = {}
    for cell, IN in (("encoder_h", D + TRAIN_K), ("decoder_h", D + BF16_L + TRAIN_K)):
        raw = keras(IN, H)
        ins = bf(_lstm_inputs(rng, dev, raw, H2048_B, T, D, H))
        eval_ins = bf(_lstm_inputs(rng, dev, raw, H2048_EVAL_SAMPLES * EVAL_B, T, D, H))
        proj_forwards(f"bf16 {cell} at B={H2048_B} T={T} IN={IN} H={H}", ins, eval_ins)
        del eval_ins
        got = rung_kernels(f"bf16 {cell} at B={H2048_B} T={T} IN={IN} H={H}", ins, reps=3)
        if cell == "encoder_h":
            table["bf16"] = got
            rung_gradient_types(f"bf16 {cell} at H={H}", ins)
        del ins
        torch.cuda.empty_cache()

    Hw = WIDE_WALK_H
    x, w, b, rk, h0, c0 = bf(_lstm_inputs(rng, dev, keras(D + TRAIN_K, Hw), WIDE_WALK_B, T, D,
                                          Hw))
    xz = (x.float() @ w.bfloat16().float() + b).bfloat16()
    h, c, z = ls.lstm_seq_xz_train_fwd_plain(xz, rk, h0, c0)
    dh = torch.from_numpy((1e-2 * rng.standard_normal(tuple(h.shape))).astype(np.float32))
    cp = torch.cat([c0[None], c[:-1]])
    res = (z, cp, c, dh.to(dev), torch.zeros_like(c), rk.T.contiguous())
    got, want = ls.lstm_seq_walk(*res), ls.lstm_seq_walk_plain(*res)
    torch.cuda.synchronize()
    rel = {n: ((g.float() - wv.float()).norm() / wv.float().norm().clamp_min(1e-30)).item()
           for n, g, wv in zip(("dz", "dh0", "dc0"), got, want)}
    k_ms = time_ms(lambda: ls.lstm_seq_walk(*res), reps=3, warm=1)
    b_ms, b_by = roofline_ms(T * WIDE_WALK_B * 4 * Hw * Hw, _nbytes(res) + _nbytes(got),
                             PEAK_BF16_FLOPS)
    print(f"bf16 walk at H={Hw} (B={WIDE_WALK_B}, the tensor-core walk): relative "
          "Frobenius " + ", ".join(f"{n} {v:.2e}" for n, v in rel.items())
          + f" (limit 1e-2); {k_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}, bf16 rate)")
    require(all(v <= 1e-2 and math.isfinite(v) for v in rel.values()),
            f"the walk at H={Hw} differs: {rel}")
    del x, w, b, rk, xz, h, c, z, res, got, want
    torch.cuda.empty_cache()

    raw13, cfg = train_shape_weights(rng)
    ins = _lstm_inputs(rng, dev, raw13["encoder_h"], TRAIN_B, T, cfg.original_dim,
                       cfg.intermediate_dim)
    table["f32"] = rung_kernels(f"f32 encoder_h at B={TRAIN_B} T={T} H={cfg.intermediate_dim}",
                                ins, reps=10)
    return table


def phase_train_h2048(model_dir):
    """The bf16 cl_vrnn at H=2,048 trained by ``cli.cl_vrnn_train`` with
    ``--lstm_backend pallas`` and ``bf16_compute`` (set on the namespace,
    as JAX ``--lstm_backend auto`` sets it) and ``--two_cell off``: the CLI
    pins fusion (T, F, F), and with the flag the args.json is the one JAX
    auto writes at this width, read back through
    ``cl_vrnn_config_from_args``; 1 epoch, whose counts (set to
    0 just before, read just after) are per train batch 2 bf16 training
    forwards and 2 bf16 dz-only walks, per eval batch 2 bf16 inference
    forwards, every other 0; then 1 epoch of ``xla`` from the same seed.
    Returns the bf16 walk launches and what the run left."""
    from classifying_vae_lstm_tpu_torch.cli import common
    from classifying_vae_lstm_tpu_torch.ops import lstm_seq as ls
    from classifying_vae_lstm_tpu_torch.ops import two_cell as tc
    from classifying_vae_lstm_tpu_torch.train.checkpoint import load_model_args

    plain_on_cuda = []
    with plain_guard(ls, LSTM_SEQ_PLAIN, plain_on_cuda), \
            plain_guard(tc, TWO_CELL_PLAIN, plain_on_cuda):
        args, counts, seen, epoch_s, wall = run_train(
            "h2048_bf16", ["--num_epochs", "1", "--lstm_backend", "pallas", "--save_last"],
            model_dir, _reset_lstm_counts, _lstm_counts, base_flags=H2048_FLAGS,
            overrides={"bf16_compute": True})
        E, n_train, n_val = _report_train("bf16 H=2048 training path", args, seen, epoch_s,
                                          wall)
        expected = lstm_expected(BF16_FWD=2 * E * n_val, BF16_TRAIN_FWD=2 * E * n_train,
                                 BF16_WALK=2 * E * n_train)
        print(f"bf16 H=2048 training: K={args.n_classes}; launches {nonzero(counts)} (expected "
              f"{nonzero(expected)}, every other count 0: the dz-only walk ran, never the full "
              "rung's backward)")
        require(counts == expected, f"bf16 H=2048 launches {counts} != {expected}")
        margs = load_model_args(seen["ckpt"])
        cfg = common.cl_vrnn_config_from_args(margs)
        require({k: margs[k] for k in AUTO_H2048} == AUTO_H2048, f"args.json {margs}")
        require((cfg.intermediate_dim, cfg.bf16_compute, cfg.lstm_backend, cfg.fusion,
                 cfg.two_cell, cfg.n_classes)
                == (H2048_H, True, "pallas", (True, False, False), False, TRAIN_K),
                f"config read back {cfg}")
        seen.update(step_ms=epoch_s[-1] * 1e3 / n_train)
        args_x, counts_x, seen_x, epoch_x, wall_x = run_train(
            "h2048_bf16_xla", ["--num_epochs", "1", "--lstm_backend", "xla"], model_dir,
            _reset_lstm_counts, _lstm_counts, base_flags=H2048_FLAGS,
            overrides={"bf16_compute": True})
    _report_train("bf16 H=2048 --lstm_backend xla", args_x, seen_x, epoch_x, wall_x)
    require(not any(counts_x.values()), f"the xla route launched LSTM kernels: {counts_x}")
    require(not plain_on_cuda, f"plain versions ran on CUDA tensors: {plain_on_cuda}")
    loss_k, loss_x = seen["history"]["loss"][0], seen_x["history"]["loss"][0]
    rel = abs(loss_k - loss_x) / abs(loss_x)
    print(f"bf16 H=2048 first epoch train loss: pallas {loss_k!r}, xla {loss_x!r}, relative "
          f"difference {rel:.3e} (limit 1e-2: the routes round at different places); ms per "
          f"step: pallas {epoch_s[0] * 1e3 / n_train:.3f}, xla {epoch_x[0] * 1e3 / n_train:.3f}")
    require(rel <= 1e-2, f"first-epoch losses differ by {rel}")
    seen.update(xla_loss=loss_x)
    return counts["BF16_WALK"], counts["BF16_TRAIN_FWD"], seen


def phase_evaluate_h2048(ckpt, out_dir):
    """Phase 27's checkpoint (its last epoch, :func:`last_checkpoint`)
    downstream: ``cli.evaluate``
    with ``--lstm_backend keep`` (2 bf16 inference forwards a batch: every
    proj rung's primal is the default rung's) and ``xla`` at 8 importance
    samples (NLLs within 1e-2 relative), then ``cli.cl_vrnn_sample`` (one
    bf16 generation launch) and the generation kernel against its plain
    version (:func:`generation_against_plain`). Returns the
    inference-forward launches."""
    from classifying_vae_lstm_tpu_torch.ops import lstm_seq as ls

    argv = lambda backend: ["-i", ckpt, "--train_file", CORPUS, "--lstm_backend", backend,
                            "--n_samples", str(H2048_EVAL_SAMPLES), "--batch_size", str(EVAL_B)]
    expected = lstm_expected(BF16_FWD=2 * -(-EVAL_WINDOWS // EVAL_B))
    plain_on_cuda = []
    with plain_guard(ls, LSTM_SEQ_PLAIN, plain_on_cuda):
        out_k, counts_k, nll_k, _, wall_k = _evaluate_counted(argv("keep"))
        out_x, counts_x, nll_x, _, wall_x = _evaluate_counted(argv("xla"))
    rel = abs(nll_k - nll_x) / abs(nll_x)
    print(f"evaluate the bf16 H=2048 checkpoint on {CORPUS} ({out_k['n_test_examples']} windows, "
          f"{H2048_EVAL_SAMPLES} samples, batches of {EVAL_B}): keep NLL {nll_k!r} in "
          f"{wall_k:.3f} s, launches {nonzero(counts_k)} (expected {nonzero(expected)}); xla "
          f"NLL {nll_x!r} in {wall_x:.3f} s; relative difference {rel:.3e} (limit 1e-2)")
    require(out_k["n_test_examples"] == out_x["n_test_examples"] == EVAL_WINDOWS,
            f"test windows {out_k['n_test_examples']}, {out_x['n_test_examples']}")
    require(counts_k == expected and not any(counts_x.values()),
            f"evaluation launches {counts_k}, {counts_x}")
    require(math.isfinite(nll_k) and rel <= 1e-2, f"NLLs differ: {nll_k} vs {nll_x}")
    require(not plain_on_cuda, f"plain versions ran on CUDA tensors: {plain_on_cuda}")
    sample_cl_vrnn_bf16(ckpt, "smoke_h2048", out_dir, "bf16 H=2048")
    generation_against_plain(ckpt, "bf16 H=2048", full_shape=True)
    return counts_k["BF16_FWD"]


def generation_against_plain(ckpt, label, B=4, nsteps=32, full_shape=False):
    """The generation kernel on a bf16 checkpoint's own weights against its
    plain version on the same inputs, as phase 3 holds it at H=512: B songs
    of 32-frame seeds and ``nsteps`` free steps (the sample CLI's), u = 1 so
    that every draw is 0 and no near-tie can flip a frame; probabilities
    within max 2e-2 and mean 2e-3. Its launches come after phase 27's counts
    were read. ``full_shape`` also times 64 songs x (32 + 256) steps
    (``generation_line``)."""
    import numpy as np
    import torch

    from classifying_vae_lstm_tpu_torch.cli import common
    from classifying_vae_lstm_tpu_torch.ops import cuda_generate as cg
    from classifying_vae_lstm_tpu_torch.weights import params_from_numpy

    dev = torch.device("cuda", 0)
    raw, cfg, _ = common.load_model(ckpt, "cl_vrnn")
    require(cg.pick_mode(cfg) == "bf16", f"{label}: generation mode {cg.pick_mode(cfg)}")
    params = params_from_numpy(raw, dev)
    seeds = torch.from_numpy(seed_windows(B)).to(dev)
    Tseed, K = seeds.shape[1], cfg.n_classes
    rng = np.random.default_rng(SEED + 14)
    eps = torch.from_numpy(rng.standard_normal((B, Tseed + nsteps, cfg.latent_dim),
                                               dtype=np.float32)).to(dev)
    u1 = torch.ones((B, Tseed + nsteps, cfg.original_dim), device=dev)
    ws = torch.eye(K, device=dev)[torch.arange(B, device=dev) % K]
    run = lambda f: f(params, cfg, seeds, nsteps, eps, u1, ws, return_probs=True, mode="bf16")
    pk, pp = run(cg.generate_cl_vrnn_batch_cuda), run(cg.generate_cl_vrnn_batch_plain)
    torch.cuda.synchronize()
    d = (pk - pp).abs()
    mx, mean = d.max().item(), d.mean().item()
    k_ms = time_ms(lambda: run(cg.generate_cl_vrnn_batch_cuda), reps=3)
    p_ms = time_ms(lambda: run(cg.generate_cl_vrnn_batch_plain), reps=2)
    print(f"generation of the {label} checkpoint against its plain version (B={B}, Tseed="
          f"{Tseed}, nsteps={nsteps}, u=1): probabilities max {mx:.3e} (limit 2e-2), mean "
          f"{mean:.3e} (limit 2e-3); kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms")
    require(pk.shape == (B, nsteps, cfg.original_dim) and torch.isfinite(pk).all().item(),
            f"{label}: generation probabilities not finite or misshapen")
    require(mx <= 2e-2 and mean <= 2e-3, f"{label}: generation differs: max {mx}, mean {mean}")
    if full_shape:  # the largest serving bucket, beside the bound at the bf16 rate
        B, nsteps = 64, 256
        seeds = torch.from_numpy(seed_windows(B)).to(dev)
        eps = torch.from_numpy(rng.standard_normal((B, Tseed + nsteps, cfg.latent_dim),
                                                   dtype=np.float32)).to(dev)
        ws = torch.eye(K, device=dev)[torch.arange(B, device=dev) % K]
        generation_line(f"bf16 ({label})", params, cfg, seeds, nsteps, eps,
                        torch.ones((B, Tseed + nsteps, cfg.original_dim), device=dev), ws, "bf16")


# each run: (label, fusion, bf16, the counts one train batch and one eval batch leave)
OTHER_RUNGS = (
    ("(T, T, F) f32", [True, True, False], False,
     lambda n, v: lstm_expected(TRAIN_FWD=2 * n, DRK=4 * n, FWD=2 * v)),
    ("(F, T, F) f32", [False, True, False], False,
     lambda n, v: lstm_expected(XZ_TRAIN_FWD=2 * n, DRK=4 * n, XZ_FWD=2 * v)),
    ("(F, F, F) f32", [False, False, False], False,
     lambda n, v: lstm_expected(XZ_TRAIN_FWD=2 * n, WALK=2 * n, XZ_FWD=2 * v)),
    ("(F, F, F) bf16", [False, False, False], True,
     lambda n, v: lstm_expected(BF16_XZ_TRAIN_FWD=2 * n, BF16_WALK=2 * n, BF16_XZ_FWD=2 * v)),
    ("(T, T, F) bf16", [True, True, False], True,
     lambda n, v: lstm_expected(BF16_TRAIN_FWD=2 * n, BF16_DRK=4 * n, BF16_FWD=2 * v)),
)


def last_checkpoint(ckpt):
    """The ``--save_last`` parameters of a run (``<run>.last.npz``) as a
    checkpoint of their own, beside a copy of the run's args: a run's first
    epoch writes no best checkpoint (the Keras-style gate opens at epoch 1)."""
    import shutil

    last = ckpt.replace(".npz", ".last.npz")
    for ext in (".json", ".yaml"):
        shutil.copyfile(ckpt.replace(".npz", ext), last.replace(".npz", ext))
    return last


def phase_other_rungs(model_dir, first_loss):
    """The other rungs end to end at the jsball_vrnn4 width (B=200, T=16,
    H=256, ``--two_cell off``): 1 epoch of ``cli.cl_vrnn_train`` each with
    fusion (T, T, F), (F, T, F) and (F, F, F) in f32 and (F, F, F) and (T, T,
    F) in bf16 (every new bf16 instance on a training path),
    set through ``args.fusion`` as a checkpoint's args.json carries it; each
    run's counts equal its steps and every other count is 0, the f32 runs'
    first-epoch loss equals phase 9's within 1e-3 relative; then
    ``cli.evaluate`` of the f32 (F, F, F) checkpoint through the unfused
    inference forward (2 a batch) and through ``xla`` (NLLs within 1e-4).
    Returns the f32 and bf16 launches per kernel over the runs."""
    from classifying_vae_lstm_tpu_torch.ops import lstm_seq as ls
    from classifying_vae_lstm_tpu_torch.train.checkpoint import load_model_args

    totals = {n: 0 for n in LSTM_COUNTS}
    plain_on_cuda = []
    with plain_guard(ls, LSTM_SEQ_PLAIN, plain_on_cuda):
        for i, (label, fusion, bf16, per) in enumerate(OTHER_RUNGS):
            overrides = {"fusion": fusion, **({"bf16_compute": True} if bf16 else {})}
            args, counts, seen, epoch_s, wall = run_train(
                f"rung{i}", ["--num_epochs", "1", "--two_cell", "off", "--save_last"], model_dir,
                _reset_lstm_counts, _lstm_counts, overrides=overrides)
            E, n_train, n_val = _report_train(f"fusion {label}", args, seen, epoch_s, wall)
            expected = per(E * n_train, E * n_val)
            loss0 = seen["history"]["loss"][0]
            rel = abs(loss0 - first_loss) / abs(first_loss)
            print(f"fusion {label}: launches {nonzero(counts)} (expected {nonzero(expected)}, "
                  f"every other count 0); first-epoch loss {loss0!r}, phase 9's {first_loss!r}, "
                  f"relative difference {rel:.3e}")
            require(counts == expected, f"fusion {label} launches {counts} != {expected}")
            margs = load_model_args(seen["ckpt"])
            require(margs["fusion"] == fusion and margs.get("bf16_compute", False) == bf16,
                    f"args.json {margs}")
            require(bf16 or rel <= 1e-3, f"fusion {label}: first-epoch loss differs by {rel}")
            phase_train_breakdown(seen, f"fusion {label} LSTM kernels", "lstm_",
                                  None if bf16 else F32_WALK_PARTS)
            totals = {n: totals[n] + counts[n] for n in LSTM_COUNTS}
            if fusion == [False, False, False] and not bf16:
                ckpt = last_checkpoint(seen["ckpt"])
        argv = lambda backend: ["-i", ckpt, "--train_file", CORPUS, "--lstm_backend", backend,
                                "--n_samples", str(EVAL_SAMPLES), "--batch_size", str(EVAL_B)]
        out_k, counts_k, nll_k, _, wall_k = _evaluate_counted(argv("keep"))
        out_x, counts_x, nll_x, _, wall_x = _evaluate_counted(argv("xla"))
    expected = lstm_expected(XZ_FWD=2 * -(-out_k["n_test_examples"] // EVAL_B))
    print(f"evaluate the (F, F, F) f32 checkpoint on {CORPUS}: keep NLL {nll_k!r} in "
          f"{wall_k:.3f} s, launches {nonzero(counts_k)} (expected {nonzero(expected)}); xla NLL "
          f"{nll_x!r} in {wall_x:.3f} s; |difference| {abs(nll_k - nll_x):.3e} (limit 1e-4)")
    require(counts_k == expected and not any(counts_x.values()),
            f"evaluation launches {counts_k}, {counts_x}")
    require(math.isfinite(nll_k) and abs(nll_k - nll_x) <= 1e-4, f"NLLs {nll_k} vs {nll_x}")
    require(not plain_on_cuda, f"plain versions ran on CUDA tensors: {plain_on_cuda}")
    totals["XZ_FWD"] += counts_k["XZ_FWD"]
    return totals


# the int8 band: a bf16 cl_vrnn of the JAX scale config (D=88, L=2, T=16,
# use_x_prev, B=1,024; 13 keys) at H=1,536, where JAX --lstm_backend auto on a
# TPU writes pallas, bf16_compute, fusion (T, T, T), two_cell off and the JAX
# sampler picks int8 weights (tests/test_pallas_generate.py:111); and the bf16
# seq-concat cl_vae (D=1,024) at H=5,120 (tests/test_pallas_generate_vae.py:149
# pins int8 there at D=976). --two_cell off writes JAX's two_cell, as phase
# 21 does at H=1,024: the port's own gate, measured on the H100, would take
# the two-cell route here (BF16_TWO_CELL_MAX_H = 2,048 in ops/two_cell.py).
INT8_H, INT8_VAE_H = 1536, 5120
INT8_VAE_XP_H = 4160  # the narrowest int8 width at D=1,024, with the x_prev slices
INT8_VAE_TOP_H = 7808  # the widest int8 width at D=1,024
INT8_TOP_H = 1752  # the widest H the JAX package samples in int8 at D=88, L=2
INT8_FLAGS = ["--train_file", CORPUS, "--intermediate_dim", str(INT8_H), "--latent_dim",
              str(BF16_L), "--seq_length", str(TRAIN_T), "--batch_size", str(BF16_B),
              "--use_x_prev", "--patience", "0", "--two_cell", "off"]
AUTO_H1536 = {"lstm_backend": "pallas", "bf16_compute": True, "fusion": [True, True, True],
              "two_cell": False}
PEAK_INT8_OPS = 1979e12  # H100 SXM, dense int8 on the tensor cores


def int8_bound_ms(int8_macs, other_flops, nbytes, other_peak=PEAK_BF16_FLOPS):
    """Least time for an int8 generation call: its int8 products (2
    operations a MAC) at the int8 tensor rate plus its other products at
    ``other_peak``, against its bytes (each input once, the output once) at
    HBM rate."""
    t_ops = 2 * int8_macs / PEAK_INT8_OPS + other_flops / other_peak
    t_bytes = nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def dp4a_ms(int8_macs):
    """The int8 MACs at the integer pipes' __dp4a rate (4 MACs per
    instruction, an assumed 64 instructions per SM per clock on 132 SMs at
    the card's maximum SM clock, as nvidia-smi reads it): a yardstick for
    kernels that run on __dp4a, not a published peak."""
    mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                                "--format=csv,noheader,nounits"], capture_output=True, text=True,
                               check=True).stdout.split()[0])
    return int8_macs / (4 * 64 * 132 * mhz * 1e6) * 1e3


def _tensor_bytes(w: dict, skip=()) -> int:
    return sum(v.numel() * v.element_size() for k, v in w.items()
               if v is not None and k not in skip)


def _int8_case(label, kern, plain, bf16, pack, nbytes, int8_macs, other_flops, probs_u1, u,
               with_frames=True, device_key=None, kernel_pack=None):
    """One int8 kernel against its plain version: the quantized operands
    equal on the card and on the host, probabilities with u = 1 within 1e-5,
    free-running frames equal in >= 99.9% of entries; then the int8 kernel,
    the plain version and the bf16 kernel on the same weights timed with CUDA
    events, beside the int8 bound. With ``device_key``, the profiler's device
    time of the kernels whose name holds it, apart from the wrapper's CUDA-event
    time, and their launches a call (one); with ``kernel_pack``, the
    wrapper's pack of the weights timed alone. Returns the kernel-table
    fields."""
    import torch

    w_dev, w_cpu = pack("cuda"), pack("cpu")
    quantized = [k for k, v in w_dev.items()
                 if v is not None and (v.dtype == torch.int8 or k.startswith("s"))]
    same = all(torch.equal(w_dev[k].cpu(), w_cpu[k]) for k in quantized)
    require(len(quantized) >= 4 and same,
            f"{label}: the int8 operands quantized on the card differ from the host's")
    pk, pp = kern(probs_u1, True), plain(probs_u1, True)
    torch.cuda.synchronize()
    require(torch.isfinite(pk).all().item() and pk.shape == pp.shape,
            f"{label}: probabilities not finite or misshapen")
    err = (pk - pp).abs().max().item()
    eq = 1.0
    if with_frames:
        fk, fp = kern(u, False), plain(u, False)
        torch.cuda.synchronize()
        require(set(torch.unique(fk).tolist()) <= {0.0, 1.0}, f"{label}: frames not binary")
        eq = (fk == fp).float().mean().item()
    print(f"int8 {label}: {len(quantized)} quantized operands (codes, scales) equal on card "
          f"and host; probs u=1 max |kernel - plain| = "
          f"{err:.3e} (limit 1e-5); frames equal in {eq:.6f} of entries (limit 0.999)")
    require(err <= 1e-5 and eq >= 0.999, f"int8 {label}: probs {err}, frames {eq}")
    t = (time_ms(lambda: kern(u, False), reps=3, warm=1), time_ms(lambda: plain(u, False), reps=1),
         time_ms(lambda: bf16(u), reps=2, warm=1), time_ms(lambda: kern(u, False), reps=3))
    b_ms, b_by = int8_bound_ms(int8_macs, other_flops, nbytes)
    print(f"int8 {label}: kernel {t[0]:.3f} / {t[3]:.3f} ms, plain {t[1]:.3f} ms, the bf16 "
          f"kernel on the same weights {t[2]:.3f} ms; roofline_ms {b_ms:.4f} ({b_by}: "
          f"{2 * int8_macs:.3e} int8 operations at 1,979 TOPS, {nbytes / 1e6:.3f} MB at 3.35 "
          f"TB/s), {t[0] / b_ms:.0f}x; the int8 MACs at the __dp4a rate {dp4a_ms(int8_macs):.3f} "
          "ms")
    row = {"max_abs_err": err, "ms": t[0], "plain_ms": t[1], "bound_ms": b_ms, "bound_by": b_by,
           "bf16_ms": t[2]}
    if device_key:
        kern(u, False)
        torch.cuda.synchronize()
        rows, dev_us = _device_rows(lambda: kern(u, False), 2)
        ours = [e for e in rows if device_key in e.key]
        launches = sum(e.count for e in ours) / 2
        row["device_ms"] = sum(dev_us(e) for e in ours) / 2e3 if rows else None
        print(f"int8 {label}: profiler, per call: {device_key} {row['device_ms']} device ms in "
              f"{launches} launches (CUDA events around the wrapper {t[0]:.3f} / {t[3]:.3f} ms); "
              "all device work " + (f"{sum(dev_us(e) for e in rows) / 2e3:.3f} ms" if rows
                                    else "not measured"))
        require(not rows or launches == 1, f"{label}: {launches} launches of {device_key} a call")
    if kernel_pack:
        row["pack_ms"] = time_ms(kernel_pack, reps=3, warm=1)
        print(f"int8 {label}: the wrapper's pack (_quant_cols and the per-block packing) "
              f"{row['pack_ms']:.3f} ms (CUDA events)")
    return row


def phase_int8_kernels(dev):
    """Phase 29: each int8 kernel against its plain version on the card, on
    seeded glorot weights: cl_vrnn at D=88, L=2, use_x_prev, 13 keys, H=64,
    H=1,536 and H=1,752 (the top of the JAX package's int8 band), 64 songs x
    (32 + 256) steps (phase 2's shape), with the kernel's profiler device
    time and launches a call and the wrapper's pack timed apart; cl_vae at
    the seq-concat width (D=1,024, L=16), 64 x 256 steps (phase 17's wide
    shape), the same apart and the kernel's clock of each part of a step:
    H=5,120 without x_prev, with and without use_z_prior, and H=4,160 with
    x_prev (weight slices resident in shared memory), H=5,120 (the head's
    tiles streamed) and H=7,808 (the x rows too) with x_prev. Returns the kernel-table fields of the H=1,536 cl_vrnn and the
    H=5,120 cl_vae runs (the largest error of every cl_vae case)."""
    import numpy as np
    import torch

    from classifying_vae_lstm_tpu_torch.models import cl_vae, cl_vrnn
    from classifying_vae_lstm_tpu_torch.ops import cuda_generate as cg
    from classifying_vae_lstm_tpu_torch.ops import cuda_generate_vae as cgv
    from classifying_vae_lstm_tpu_torch.weights import params_from_numpy

    rng = np.random.default_rng(SEED + 29)
    K, B = TRAIN_K, 64

    def glorot(i, o):
        lim = np.sqrt(6.0 / (i + o))
        return rng.uniform(-lim, lim, (i, o)).astype(np.float32)

    rows = {}
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    D, L, Tseed, nsteps = 88, BF16_L, 32, 256
    total = Tseed + nsteps
    seeds = torch.from_numpy(seed_windows(B)).to(dev)
    ws = torch.eye(K, device=dev)[torch.arange(B, device=dev) % K]
    eps = torch.from_numpy(rng.standard_normal((B, total, L), dtype=np.float32)).to(dev)
    u = torch.from_numpy(rng.random((B, total, D), dtype=np.float32)).to(dev)
    u[:, :Tseed] = 1.0  # the seed phase's draws only feed the first free step
    for H in (64, INT8_H, INT8_TOP_H):
        cfg = cl_vrnn.Config(original_dim=D, intermediate_dim=H, latent_dim=L,
                             seq_length=TRAIN_T, n_classes=K, use_x_prev=True,
                             bf16_compute=True, lstm_backend="pallas")
        raw = {
            "encoder_h": {"kernel": glorot(D + K, 4 * H), "recurrent_kernel": glorot(H, 4 * H),
                          "bias": np.zeros(4 * H, np.float32)},
            "decoder_h": {"kernel": glorot(D + L + K, 4 * H),
                          "recurrent_kernel": glorot(H, 4 * H),
                          "bias": np.zeros(4 * H, np.float32)},
            "Z_mean": {"kernel": glorot(H, L), "bias": np.zeros(L, np.float32)},
            "Z_log_var": {"kernel": glorot(H, L), "bias": np.zeros(L, np.float32)},
            "X_decoded_mean": {"kernel": glorot(H, D), "bias": np.full(D, -2.0, np.float32)},
        }
        params = params_from_numpy(raw, dev)
        run = lambda f, uu, rp, mode="int8": f(params, cfg, seeds, nsteps, eps, uu, ws,
                                               return_probs=rp, mode=mode)
        host = params_from_numpy(raw, "cpu")
        pack = lambda where: cg._pack(params if where == "cuda" else host, cfg,
                                      ws if where == "cuda" else ws.cpu(), D, "int8")
        w = pack("cuda")
        macs = B * total * ((D + H) * 4 * H + (H + D) * 4 * H + H * D)
        other = 2 * B * total * (H * 2 * L + L * 4 * H)
        nbytes = (_tensor_bytes(w) + 4 * (B * Tseed * D + B * total * (L + D) + B * nsteps * D))
        require(cg.pick_mode(cfg) == ("bf16" if H == 64 else "int8"),
                f"H={H}: pick_mode {cg.pick_mode(cfg)}")
        nu, grid = cg.int8_grid(H, n_sm)
        print(f"int8 cl_vrnn H={H}: {grid} blocks of {nu} hidden units on {n_sm} SMs, "
              f"{cg._int8_smem(nu, B, L)} B of shared memory a block")
        rows[f"cl_vrnn H={H}"] = _int8_case(
            f"cl_vrnn H={H} (64 x (32 + 256))",
            lambda uu, rp: run(cg.generate_cl_vrnn_batch_cuda, uu, rp),
            lambda uu, rp: run(cg.generate_cl_vrnn_batch_plain, uu, rp),
            lambda uu: run(cg.generate_cl_vrnn_batch_cuda, uu, False, "bf16"),
            pack, nbytes, macs, other, torch.ones_like(u), u, device_key="generate_int8_kernel",
            kernel_pack=lambda: cg.pack_int8(pack("cuda"), cfg, nu))
        if H == INT8_H:  # the bf16 kernel on the same weights, beside its bound
            generation_line("bf16 (the int8 band's weights)", params, cfg, seeds, nsteps, eps,
                            torch.ones_like(u), ws, "bf16")
        split = cg.phase_ms(params, cfg, seeds, nsteps, eps, u, ws, "int8")
        print(f"int8 cl_vrnn H={H}: a call's parts (block 0's clock, ms; a wait is the "
              "slowest block's lag and the grid barrier) "
              + "; ".join(f"{n} {v:.3f}" for n, v in split.items()))
    D, L, nsteps = 1024, 16, 256
    # each width with the residency (x-row slices, head tiles) it must take
    layouts = {(INT8_VAE_H, False): (True, True), (INT8_VAE_XP_H, True): (True, True),
               (INT8_VAE_H, True): (True, False), (INT8_VAE_TOP_H, True): (False, False)}
    for (H, use_xp), res in layouts.items():
        cfg = cl_vae.Config(original_dim=D, intermediate_dim=H, latent_dim=L,
                            intermediate_class_dim=256, n_classes=K, use_x_prev=use_xp,
                            bf16_compute=True, gen_backend="pallas")
        require(cgv.pick_mode(cfg) == "int8" and cgv.kernel_for(cfg) == "generate_cl_vae_int8",
                f"cl_vae H={H}: {cgv.pick_mode(cfg)}, {cgv.kernel_for(cfg)}")
        raw = glorot_vae_raw(rng, D, H, L, K, use_xp, Cw=256)
        raw["x_decoded_mean"]["bias"][:] = -2.0
        params = params_from_numpy(raw, dev)
        host = params_from_numpy(raw, "cpu")
        seeds = torch.from_numpy((rng.random((B, D)) < 0.1).astype(np.float32)).to(dev)
        eps = torch.from_numpy(rng.standard_normal((B, nsteps, L), dtype=np.float32)).to(dev)
        u = torch.from_numpy(rng.random((B, nsteps, D), dtype=np.float32)).to(dev)
        pack = lambda where: cgv._pack_int8(params if where == "cuda" else host, cfg,
                                            ws if where == "cuda" else ws.cpu())
        w = pack("cuda")
        plan = cgv.coop_plan(cfg, B, n_sm)
        print(f"int8 cl_vae D={D} H={H} use_x_prev={use_xp}: {plan['G']} blocks of "
              f"{plan['nu']} hidden units on {n_sm} SMs, the frame head in {plan['hs']} song "
              f"groups of {plan['P']} pitch tiles a block, slices resident (x rows, head) "
              f"{plan['res']}")
        require(plan["res"] == res, f"cl_vae H={H} use_x_prev={use_xp}: layout {plan['res']}, "
                f"not {res}")
        macs = B * nsteps * (D * H * (2 if use_xp else 1) + H * D)
        other = 2 * B * nsteps * (H * 2 * L + L * H)
        nbytes = (_tensor_bytes(w, ("encb", "decb"))
                  + 4 * (2 * B * H + B * D + B * nsteps * (L + D) + B * nsteps * D))
        for zp in ((False, True) if not use_xp else (False,)):
            run = lambda f, uu, rp, mode="int8": f(params, cfg, seeds, nsteps, eps, uu, ws,
                                                   use_z_prior=zp, return_probs=rp, mode=mode)
            key = f"cl_vae H={H} xp={use_xp} zp={zp}"
            rows[key] = _int8_case(
                f"cl_vae D={D} H={H} use_x_prev={use_xp} use_z_prior={zp} (64 x 256)",
                lambda uu, rp: run(cgv.generate_cl_vae_batch_cuda, uu, rp),
                lambda uu, rp: run(cgv.generate_cl_vae_batch_plain, uu, rp),
                lambda uu: run(cgv.generate_cl_vae_batch_cuda, uu, False, "bf16"),
                pack, nbytes, macs, 0 if zp else other, torch.ones_like(u), u,
                device_key="generate_vae_coop_kernel<signed char>",
                kernel_pack=lambda: cgv.pack_coop(pack("cuda"), cfg, plan["nu"], plan["G"],
                                                  plan["P"], plan["hs"]))
            split = cgv.phase_ms(params, cfg, seeds, nsteps, eps, u, ws, use_z_prior=zp)
            print(f"int8 {key}: a call's parts (block 0's clock, ms; a wait is the slowest "
                  "block's lag and the grid barrier) "
                  + "; ".join(f"{n} {v:.3f}" for n, v in split.items()))
    main_row = rows[f"cl_vae H={INT8_VAE_H} xp=False zp=False"]
    errs = max(v["max_abs_err"] for k, v in rows.items() if k.startswith("cl_vae"))
    top, mid = rows[f"cl_vrnn H={INT8_TOP_H}"], rows[f"cl_vrnn H={INT8_H}"]
    print(f"int8 cl_vrnn kernel at H={INT8_H} / {INT8_TOP_H}: {mid['ms']:.3f} / {top['ms']:.3f} "
          f"ms (device {mid.get('device_ms')} / {top.get('device_ms')}), bound "
          f"{mid['bound_ms']:.4f} / {top['bound_ms']:.4f} ms")
    return mid, {**main_row, "max_abs_err": errs}


def serve_requests(argv, kmod, bodies, frames_per_row=1):
    """``cli.serve`` of ``argv`` (no warm-up) answers each /generate body
    over HTTP; the family's launch counts are set to 0 just after the engine
    is built and read after the last request. Returns (f32/bf16 launches,
    int8 launches, the modes the wrapper resolved, /stats)."""
    import numpy as np

    from classifying_vae_lstm_tpu_torch.cli import serve

    plain_name = ("generate_cl_vae_batch_plain" if kmod.__name__.endswith("_vae")
                  else "generate_cl_vrnn_batch_plain")
    args = serve.build_parser().parse_args([*argv, "--warmup", "off", "--port", "0"])
    plain_on_cuda = []
    with recorded_modes(kmod) as modes, sampler_plain_guard(kmod, plain_name, plain_on_cuda):
        httpd, _ = serve.make_server(args)
        kmod.LAUNCHES = kmod.INT8_LAUNCHES = 0  # counts from here on are these requests'
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        ms = []
        try:
            for body in bodies:
                req = urllib.request.Request(f"{url}/generate", data=json.dumps(body).encode(),
                                             headers={"Content-Type": "application/json"})
                t0 = time.perf_counter()
                with urllib.request.urlopen(req, timeout=120) as r:
                    require(r.status == 200, f"/generate {body} -> HTTP {r.status}")
                    rolls = np.asarray(json.load(r)["rolls"])
                ms.append((time.perf_counter() - t0) * 1e3)
                shape = (body["n"], body["t"] * frames_per_row, 88)
                require(rolls.shape == shape and set(np.unique(rolls).tolist()) <= {0, 1},
                        f"/generate {body}: rolls {rolls.shape}, want {shape}")
            with urllib.request.urlopen(f"{url}/stats", timeout=30) as r:
                stats = json.load(r)
        finally:
            httpd.shutdown()
            httpd.server_close()
        counts = (kmod.LAUNCHES, kmod.INT8_LAUNCHES)
    require(not plain_on_cuda, f"plain version ran on CUDA tensors: {plain_on_cuda}")
    print(f"serve {' '.join(argv[2:])}: {len(bodies)} requests {[b['n'] for b in bodies]} songs "
          f"in {[round(v, 3) for v in ms]} ms (client clock); /stats mode {stats['mode']}, "
          f"launches (f32/bf16, int8) {counts}, modes {sorted(set(modes))}")
    return counts[0], counts[1], modes, stats


def sample_counted(cli, kmod, argv, n):
    """A sample CLI of ``argv`` with the family's launch counts set to 0
    just before and read just after. Returns (f32/bf16 launches, int8
    launches, modes, the rolls written)."""
    import numpy as np

    plain_name = ("generate_cl_vae_batch_plain" if kmod.__name__.endswith("_vae")
                  else "generate_cl_vrnn_batch_plain")
    plain_on_cuda = []
    with recorded_modes(kmod) as modes, sampler_plain_guard(kmod, plain_name, plain_on_cuda):
        kmod.LAUNCHES = kmod.INT8_LAUNCHES = 0  # counts from here on are this CLI's
        t0 = time.perf_counter()
        samples = cli.sample(cli.build_parser().parse_args(argv))
        wall = time.perf_counter() - t0
        counts = (kmod.LAUNCHES, kmod.INT8_LAUNCHES)
    out_dir = argv[argv.index("--sample_dir") + 1]
    files = [f"{argv[0]}_{j}.mid" for j in range(n)
             if os.path.exists(os.path.join(out_dir, f"{argv[0]}_{j}.mid"))]
    print(f"{cli.__name__.rsplit('.', 1)[1]} {argv[0]}: rolls {samples.shape} in {wall:.3f} s "
          f"(host clock), launches (f32/bf16, int8) {counts}, modes {modes}, {len(files)} MIDI "
          f"files, {int(samples.sum())} notes on")
    require(samples.shape[0] == n and samples.shape[2] == 88
            and set(np.unique(samples).tolist()) <= {0, 1} and len(files) == n,
            f"samples {samples.shape}, files {files}")
    require(not plain_on_cuda, f"plain version ran on CUDA tensors: {plain_on_cuda}")
    return counts[0], counts[1], modes, samples


def phase_int8_paths(model_dir, sample_dir):
    """Phase 30: the entry points reach the int8 kernels where the JAX
    package does. cl_vrnn: ``cli.cl_vrnn_train`` writes the H=1,536 bf16
    checkpoint (1 epoch, ``--lstm_backend pallas --two_cell off``,
    ``bf16_compute`` set as JAX ``auto`` sets it; args.json as JAX ``auto``
    writes it; the bf16 LSTM counts equal its steps), then ``cli.cl_vrnn_sample`` and ``serve
    --lstm_backend keep`` sample it through the int8 kernel (bf16 launches
    0) and ``serve`` with its default ``auto`` through the bf16 one (int8
    launches 0). cl_vae: ``cli.cl_vae_train`` writes the bf16 seq-concat
    checkpoint at H=5,120 (1 epoch), then ``cli.cl_vae_sample --gen_backend
    pallas`` and ``serve --gen_backend pallas`` sample it in int8, ``auto``
    in bf16 through the cooperative kernel (its count 1 a call). Returns
    the int8 launches of each family on these paths and the cooperative
    kernel's bf16 launches."""
    from classifying_vae_lstm_tpu_torch.cli import cl_vae_sample, cl_vae_train, cl_vrnn_sample
    from classifying_vae_lstm_tpu_torch.cli import common
    from classifying_vae_lstm_tpu_torch.ops import cuda_generate as cg
    from classifying_vae_lstm_tpu_torch.ops import cuda_generate_vae as cgv
    from classifying_vae_lstm_tpu_torch.ops import lstm_seq as ls
    from classifying_vae_lstm_tpu_torch.ops import two_cell as tc
    from classifying_vae_lstm_tpu_torch.train.checkpoint import load_model_args

    t_phase = time.perf_counter()
    plain_on_cuda = []
    with plain_guard(ls, LSTM_SEQ_PLAIN, plain_on_cuda), \
            plain_guard(tc, TWO_CELL_PLAIN, plain_on_cuda):
        args, counts, seen, epoch_s, wall = run_train(
            "h1536_bf16", ["--num_epochs", "1", "--lstm_backend", "pallas", "--save_last"],
            model_dir, _reset_lstm_counts, _lstm_counts, base_flags=INT8_FLAGS,
            overrides={"bf16_compute": True})
    E, n_train, n_val = _report_train("bf16 H=1536 training path", args, seen, epoch_s, wall)
    expected = lstm_expected(BF16_FWD=2 * E * n_val, BF16_TRAIN_FWD=2 * E * n_train,
                             BF16_BWD=4 * E * n_train)
    print(f"bf16 H=1536 training: launches {nonzero(counts)} (expected {nonzero(expected)}, every "
          "other count 0)")
    require(counts == expected, f"bf16 H=1536 launches {counts} != {expected}")
    require(not plain_on_cuda, f"plain versions ran on CUDA tensors: {plain_on_cuda}")
    margs = load_model_args(seen["ckpt"])
    cfg = common.cl_vrnn_config_from_args(margs)
    require({k: margs[k] for k in AUTO_H1536} == AUTO_H1536, f"args.json {margs}")
    require(cg.pick_mode(cfg) == "int8", f"H=1536 checkpoint samples in {cg.pick_mode(cfg)}")
    ckpt = last_checkpoint(seen["ckpt"])
    bf16, int8, modes, _ = sample_counted(
        cl_vrnn_sample, cg, ["smoke_h1536", "-i", ckpt, "--infer_w", "-n", "4", "--train_file",
                             CORPUS, "--sample_dir", sample_dir], 4)
    require((bf16, int8) == (0, 1) and modes == ["int8"], f"cl_vrnn_sample {bf16}, {int8}, {modes}")
    vrnn_launches = int8
    bodies = [{"n": 4, "t": 64}, {"n": 16, "t": 128}, {"n": 1, "t": 32}, {"n": 64, "t": 256}]
    bf16, int8, modes, stats = serve_requests(
        ["-i", ckpt, "--train_file", CORPUS, "--lstm_backend", "keep"], cg, bodies)
    require((bf16, int8) == (0, len(bodies)) and set(modes) == {"int8"}
            and stats["mode"] == "int8" and stats["int8_launches"] == len(bodies),
            f"serve --lstm_backend keep: {bf16}, {int8}, {modes}, {stats}")
    vrnn_launches += int8
    bf16, int8, modes, stats = serve_requests(["-i", ckpt, "--train_file", CORPUS], cg,
                                              [{"n": 2, "t": 32}])
    require((bf16, int8) == (1, 0) and modes == ["bf16"] and stats["mode"] == "bf16"
            and stats["lstm_backend"] == "xla", f"serve (auto): {bf16}, {int8}, {modes}, {stats}")

    flags = list(SEQ_TRAIN_FLAGS)
    flags[flags.index("--intermediate_dim") + 1] = str(INT8_VAE_H)
    args, _, seen, epoch_s, wall = run_train(
        "seq_h5120", ["--num_epochs", "1", "--save_last"], model_dir, lambda: None, lambda: None,
        cli=cl_vae_train, base_flags=flags)
    _report_train("bf16 seq-concat H=5120 training path (xla)", args, seen, epoch_s, wall)
    margs = load_model_args(seen["ckpt"])
    require((margs["original_dim"], margs["intermediate_dim"], margs["bf16_compute"],
             margs["seq_length"]) == (1024, INT8_VAE_H, True, 16), f"args.json {margs}")
    ckpt = last_checkpoint(seen["ckpt"])
    argv = ["smoke_seq", "-i", ckpt, "-n", "4", "-t", "8", "--train_file", CORPUS,
            "--sample_dir", sample_dir]
    bf16, int8, modes, rolls = sample_counted(cl_vae_sample, cgv, [*argv, "--gen_backend",
                                                                   "pallas"], 4)
    require((bf16, int8) == (0, 1) and modes == ["int8"] and rolls.shape == (4, 8 * 16, 88),
            f"cl_vae_sample --gen_backend pallas: {bf16}, {int8}, {modes}, {rolls.shape}")
    vae_launches = int8
    cgv.COOP_LAUNCHES = 0  # the default auto: bf16 on the cooperative kernel
    bf16, int8, modes, rolls = sample_counted(cl_vae_sample, cgv, argv, 4)
    require((bf16, int8, cgv.COOP_LAUNCHES) == (1, 0, 1) and modes == ["bf16"],
            f"cl_vae_sample --gen_backend auto: {bf16}, {int8}, {modes}, cooperative "
            f"{cgv.COOP_LAUNCHES}")
    coop_launches = cgv.COOP_LAUNCHES
    bodies = [{"n": 4, "t": 8}, {"n": 16, "t": 32}]
    bf16, int8, modes, stats = serve_requests(
        ["-i", ckpt, "--train_file", CORPUS, "--gen_backend", "pallas"], cgv, bodies, 16)
    require((bf16, int8) == (0, len(bodies)) and set(modes) == {"int8"}
            and stats["mode"] == "int8", f"serve --gen_backend pallas: {bf16}, {int8}, {modes}")
    vae_launches += int8
    cgv.COOP_LAUNCHES = 0
    bf16, int8, modes, stats = serve_requests(["-i", ckpt, "--train_file", CORPUS], cgv,
                                              [{"n": 2, "t": 8}], 16)
    require((bf16, int8, cgv.COOP_LAUNCHES) == (1, 0, 1) and modes == ["bf16"]
            and stats["gen_backend"] == "xla",
            f"serve (auto): {bf16}, {int8}, {modes}, cooperative {cgv.COOP_LAUNCHES}")
    coop_launches += cgv.COOP_LAUNCHES
    print(f"int8 paths: {vrnn_launches} cl_vrnn and {vae_launches} cl_vae int8 launches, every "
          f"bf16 count 0 on them; {coop_launches} launches of the cooperative bf16 kernel on the "
          f"default auto; phase 30 took {time.perf_counter() - t_phase:.1f} s")
    return vrnn_launches, vae_launches, coop_launches


SWEEP_H = (88, 512, 1024, 1536, 2048, 2560)
SWEEP_B = (200, 1024, 1600)


def phase_lstm_bf16_sweep(dev):
    """The bf16 tensor-core route across widths and batches: H in
    ``SWEEP_H`` x B in ``SWEEP_B`` (T=16, IN=101, seeded Glorot-scale
    weights drawn on the card): the training forward and the inference
    forward against the plain training forward within :func:`bf16_outside`,
    the dz-only walk against its plain version within 1e-2 relative
    Frobenius; each timed (CUDA events, 2 calls after a warm-up) beside its
    bound at the bf16 rate. Rk is 33.5 MB at H=2,048 and 52.4 MB at 2,560,
    past the 50 MB L2: the ms per GFLOP across H shows whether the step
    products fall off that cliff."""
    import torch

    from classifying_vae_lstm_tpu_torch.ops import lstm_seq as ls

    gen = torch.Generator(device=dev).manual_seed(SEED + 31)
    T, IN = TRAIN_T, 101
    t0 = time.perf_counter()
    for H in SWEEP_H:
        r = lambda *shape, scale: scale * torch.randn(*shape, generator=gen, device=dev)
        w, b = r(IN, 4 * H, scale=(2.0 / (IN + 4 * H)) ** 0.5), r(4 * H, scale=0.1)
        rk = r(H, 4 * H, scale=H ** -0.5).bfloat16()
        for B in SWEEP_B:
            x = (torch.rand(T, B, IN, generator=gen, device=dev) < 0.1).bfloat16()
            h0 = c0 = torch.zeros((B, H), device=dev)
            ins = (x, w, b, rk, h0, c0)
            got, inf = ls.lstm_seq_train_fwd(*ins), ls.lstm_seq_fwd(*ins)
            ref = ls.lstm_seq_train_fwd_plain(*ins)
            torch.cuda.synchronize()
            errs, bad = bf16_outside(got, ref)
            ierrs, ibad = bf16_outside(inf, ref)
            h, c, z, hp, cp = ref
            dh = r(T, B, H, scale=1e-2)
            res = (z, cp, c, dh, torch.zeros_like(dh), rk.T.contiguous())
            walk, want = ls.lstm_seq_walk(*res), ls.lstm_seq_walk_plain(*res)
            torch.cuda.synchronize()
            rel = max(((g.float() - wv.float()).norm() / wv.float().norm().clamp_min(1e-30)).item()
                      for g, wv in zip(walk, want))
            require(not bad and not ibad and rel <= 1e-2 and math.isfinite(rel),
                    f"bf16 sweep H={H} B={B}: forward {bad} {ibad}, walk {rel}")
            fmas = T * B * H * 4 * (IN + H)
            ms = {"training forward": time_ms(lambda: ls.lstm_seq_train_fwd(*ins), reps=2),
                  "inference forward": time_ms(lambda: ls.lstm_seq_fwd(*ins), reps=2),
                  "walk": time_ms(lambda: ls.lstm_seq_walk(*res), reps=2)}
            bounds = {"training forward": roofline_ms(fmas, _nbytes(ins) + _nbytes(got),
                                                      PEAK_BF16_FLOPS)[0],
                      "inference forward": roofline_ms(fmas, _nbytes(ins) + _nbytes(inf),
                                                       PEAK_BF16_FLOPS)[0],
                      "walk": roofline_ms(T * B * 4 * H * H, _nbytes(res) + _nbytes(walk),
                                          PEAK_BF16_FLOPS)[0]}
            print(f"bf16 sweep H={H} B={B}: " + "; ".join(
                f"{k} {v:.3f} ms ({v / bounds[k]:.1f}x its bound {bounds[k]:.4f}, "
                f"{v / (2 * (fmas if k != 'walk' else T * B * 4 * H * H) / 1e9):.4f} ms/GFLOP)"
                for k, v in ms.items())
                + f"; max |kernel - plain| h {errs['h'][0]:.2e}, z {errs['z'][0]:.2e}, "
                f"inference h {ierrs['h'][0]:.2e}; walk {rel:.2e} relative")
            del ins, got, inf, ref, res, walk, want, x, h, c, z, hp, cp, dh
        del w, b, rk
        torch.cuda.empty_cache()
    print(f"phase 31 (bf16 sweep): {time.perf_counter() - t0:.1f} s")


# the phases whose results a phase reads: a selection runs them too
KC_MODEL = "artifacts/pm_configs/c5m.npz"  # cl_vrnn, H=88, 13 keys, trained on CORPUS
C3_MODEL = "artifacts/pm_configs/c3.npz"  # cl_vae, 13 keys, trained on CORPUS
# the JAX package's cli.evaluate of each on CORPUS (64 samples), nats/frame, run on the CPU
# (the script cannot import JAX): seed 0, and the mean of seeds 0-7, to which the limit holds
# the mean of the card's seeds 0-7. One seed's estimate moves by up to 0.045 (c3) and 0.003
# (c5m) between seeds in the JAX package, so one seed cannot be held within the limit.
JAX_NLL_SEED0 = {"c3": 9.8525, "c5m": 6.3478}
JAX_NLL = {"c3": 9.838325, "c5m": 6.347775}
NLL_LIMIT, NLL_SEEDS = 0.01, 8


class _Tee:
    """Write to the real stdout and keep a copy."""

    def __init__(self, out):
        self.out, self.text = out, []

    def write(self, s):
        self.text.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def phase_key_consistency(dev):
    """Key consistency and the 13-key checkpoints: ``cli.key_consistency``
    of c5m on the card (one generation launch a key with test songs, the
    margin > 0), one key's batch through the kernel and the plain version on
    the CLI's own noise, a key past ``n_classes`` raising, and
    ``cli.evaluate`` of c3 and of c5m through the H=88 inference kernel
    against the JAX package's NLLs; the H=88 forward timed at the
    evaluation shape. Returns the generation and the inference-forward
    launches."""
    import numpy as np
    import torch

    from classifying_vae_lstm_tpu_torch.cli import common
    from classifying_vae_lstm_tpu_torch.cli import key_consistency as kc
    from classifying_vae_lstm_tpu_torch.data import PianoData
    from classifying_vae_lstm_tpu_torch.ops import cuda_generate as cg
    from classifying_vae_lstm_tpu_torch.ops import lstm_seq as ls
    from classifying_vae_lstm_tpu_torch.sampling import generate as gen

    calls, real = [], kc.generate_cl_vrnn_batch

    def spy(params, cfg, seeds, nsteps, generator, ws):
        state = generator.get_state().clone()
        out = real(params, cfg, seeds, nsteps, generator, ws)
        calls.append((params, cfg, seeds, nsteps, state, ws, out))
        return out

    args = kc.build_parser().parse_args(["-i", KC_MODEL, "--train_file", CORPUS])
    plain_on_cuda = []
    kc.generate_cl_vrnn_batch = spy
    try:
        with sampler_plain_guard(cg, "generate_cl_vrnn_batch_plain", plain_on_cuda):
            cg.LAUNCHES = 0
            t0 = time.perf_counter()
            rep = kc.run(args)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = cg.LAUNCHES
    finally:
        kc.generate_cl_vrnn_batch = real
    P = PianoData(CORPUS, batch_size=1, seq_length=args.seed_len, squeeze_x=False)
    n_keys = len(np.unique(P.test_song_keys))
    print(f"key consistency of c5m on {CORPUS} (-n {args.n} -t {args.t}, seeds of "
          f"{args.seed_len} frames): {json.dumps(rep)}; {launches} generation launches "
          f"(expected {n_keys}, one a key with test songs), wall {wall:.3f} s")
    require(launches == n_keys == len(calls), f"key consistency launches {launches}")
    require(not plain_on_cuda, f"the plain sampler ran on CUDA tensors: {plain_on_cuda}")
    require(rep["n_songs"] == n_keys * args.n and rep["margin"] > 0,
            f"key consistency report {rep}")

    # the first key's batch: kernel and plain version on the CLI's own noise
    params, cfg, seeds, nsteps, state, ws, out = calls[0]
    g = torch.Generator(device=dev)
    g.set_state(state)
    B, Tseed, D = seeds.shape
    eps, u = gen.draw_generation_noise(g, B, Tseed + nsteps, cfg.latent_dim, D, device=dev)
    fk = cg.generate_cl_vrnn_batch_cuda(params, cfg, seeds, nsteps, eps, u, ws)
    fp = cg.generate_cl_vrnn_batch_plain(params, cfg, seeds, nsteps, eps, u, ws)
    probs = cg.generate_cl_vrnn_batch_plain(params, cfg, seeds, nsteps, eps, u, ws,
                                            return_probs=True)
    torch.cuda.synchronize()
    require(torch.equal(fk, out), "the kernel's frames differ from the CLI's on its own noise")
    frames_agree_to_near_tie("key consistency, first key", fk, fp, u[:, Tseed:], probs)

    try:
        kc.run(kc.build_parser().parse_args(["-i", MODEL, "--train_file", CORPUS, "-n", "1",
                                             "-t", "1"]))
    except ValueError as e:
        print(f"jsball_vrnn4 (K=10) on {CORPUS} raises: {e}")
        require("n_classes=10" in str(e), f"unexpected message: {e}")
    else:
        require(False, "a key past n_classes did not raise")

    argv = lambda model, seed, *extra: ["-i", model, "--train_file", CORPUS, "--n_samples",
                                        str(EVAL_SAMPLES), "--batch_size", str(EVAL_B),
                                        "--seed", str(seed), *extra]
    _reset_dense_counts()
    out3, counts3, nll3, _, wall3 = _evaluate_counted(argv(C3_MODEL, SEED))
    dense3 = _dense_counts()
    out5, counts5, nll5, _, wall5 = _evaluate_counted(argv(KC_MODEL, SEED, "--lstm_backend",
                                                           "pallas"))
    n_test = out5["n_test_examples"]
    print(f"launches: c3 (cl_vae, plain dense layers as in JAX) dense-stack "
          f"{dense3} (f32 fwd, bwd, bf16 fwd, bwd), LSTM {nonzero(counts3)}; c5m "
          f"{nonzero(counts5)} (expected FWD {2 * -(-n_test // EVAL_B)}, every other 0)")
    require(counts5 == lstm_expected(FWD=2 * -(-n_test // EVAL_B)), f"c5m launches {counts5}")
    for name, model, extra, first, nll, wall in (
            ("c3", C3_MODEL, (), out3, nll3, wall3),
            ("c5m", KC_MODEL, ("--lstm_backend", "pallas"), out5, nll5, wall5)):
        nlls = [nll] + [_evaluate_counted(argv(model, s, *extra))[2]
                        for s in range(SEED + 1, SEED + NLL_SEEDS)]
        mean, ref = float(np.mean(nlls)), JAX_NLL[name]
        print(f"evaluate {name} on {CORPUS} ({first['n_test_examples']} test examples, "
              f"{EVAL_SAMPLES} samples; one run {wall:.3f} s): seed {SEED} NLL {nlls[0]!r} "
              f"nats/frame (printed {first['test_nll_nats_per_frame']}; the JAX package's seed "
              f"{SEED} on the CPU {JAX_NLL_SEED0[name]}, |difference| "
              f"{abs(nlls[0] - JAX_NLL_SEED0[name]):.4f}); seeds {SEED}-{SEED + NLL_SEEDS - 1} "
              f"{[round(v, 5) for v in nlls]}, mean {mean:.5f}, spread "
              f"{max(nlls) - min(nlls):.4f}; the JAX package's mean of those seeds {ref}: "
              f"|difference| {abs(mean - ref):.4f} (limit {NLL_LIMIT})")
        require(all(map(math.isfinite, nlls)) and abs(mean - ref) <= NLL_LIMIT,
                f"{name} NLL mean {mean} vs {ref}")

    # the H=88 inference forward at the evaluation shape (both cells' shape: the encoder's)
    raw, cfg5, _ = common.load_model(KC_MODEL, "cl_vrnn")
    rng = np.random.default_rng(SEED + 32)
    ins = _lstm_inputs(rng, dev, raw["encoder_h"], EVAL_SAMPLES * EVAL_B, TRAIN_T,
                       cfg5.original_dim, cfg5.intermediate_dim)
    got, ref = ls.lstm_seq_fwd(*ins), ls.lstm_seq_fwd_plain(*ins)
    torch.cuda.synchronize()
    errs = {n: (k - p).abs().max().item() for n, k, p in zip(("h", "c"), got, ref)}
    require(not fwd_outside(errs, {"h": ref[0], "c": ref[1]}), f"H=88 forward differs: {errs}")
    T, Bv, IN = ins[0].shape
    H = cfg5.intermediate_dim
    k_ms = time_ms(lambda: ls.lstm_seq_fwd(*ins), reps=10, warm=2)
    p_ms = time_ms(lambda: ls.lstm_seq_fwd_plain(*ins), reps=3, warm=1)
    b_ms, b_by = roofline_ms(T * Bv * (IN + H) * 4 * H, _nbytes(ins) + _nbytes(got))
    print(f"lstm_seq inference forward at c5m's evaluation shape (B={Bv} T={T} IN={IN} H={H}; "
          f"{fwd_layout(ls, Bv, IN, H)}): max |kernel - plain| h {errs['h']:.3e}, c "
          f"{errs['c']:.3e}; kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, bound {b_ms:.4f} ms "
          f"({b_by})")
    return launches, counts5["FWD"]


STREAM_STEPS = 40  # batches of the streamed-vs-synchronous comparison


def phase_train_flags(model_dir):
    """``cli.cl_vrnn_train`` at the jsball_vrnn4 width through the two-cell
    kernels with ``--data_init --check_numerics --do_log --trace_dir
    --streaming``, 2 epochs: the numerics line and a NaN leaf named, the
    card's data-based init against the CPU plain init on its noise, a
    streamed epoch's step losses bitwise those of the same batches copied
    synchronously, the JSONL and events of every epoch, the trace naming
    the two-cell kernels. Returns the two-cell forward and backward
    launches."""
    import numpy as np
    import torch

    from classifying_vae_lstm_tpu_torch.data.loader import batch_iterator
    from classifying_vae_lstm_tpu_torch.ops import two_cell as tc
    from classifying_vae_lstm_tpu_torch.optim import data_init
    from classifying_vae_lstm_tpu_torch.train import debug, loop
    from classifying_vae_lstm_tpu_torch.utils.tb_events import read_scalar_events

    log_dir, trace_dir = os.path.join(model_dir, "logs"), os.path.join(model_dir, "trace")
    inits, real_core = [], data_init.data_based_init_cl_vrnn_noise
    stream_s, real_stream = [], loop.Trainer.train_epoch_streaming

    def core(*a):
        inits.append((a, real_core(*a)))
        return inits[-1][1]

    def streamed(self, *a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = real_stream(self, *a, **k)
        torch.cuda.synchronize()
        stream_s.append(time.perf_counter() - t0)
        return m

    def reset():
        tc.FWD_LAUNCHES = tc.BWD_LAUNCHES = 0

    flags = ["--num_epochs", "2", "--data_init", "--check_numerics", "--do_log", "--log_dir",
             log_dir, "--trace_dir", trace_dir, "--streaming"]
    tee, plain_on_cuda = _Tee(sys.stdout), []
    data_init.data_based_init_cl_vrnn_noise = core
    loop.Trainer.train_epoch_streaming = streamed
    try:
        with contextlib.redirect_stdout(tee), \
                plain_guard(tc, ("two_cell_fwd_plain", "two_cell_bwd_plain"), plain_on_cuda):
            args, (fwd, bwd), seen, _, wall = run_train(
                "flags", flags, model_dir, reset, lambda: (tc.FWD_LAUNCHES, tc.BWD_LAUNCHES))
    finally:
        data_init.data_based_init_cl_vrnn_noise = real_core
        loop.Trainer.train_epoch_streaming = real_stream
    E, n_train, n_val = _report_train("training flags", args, seen, stream_s, wall)
    print(f"training flags: two-cell launches forward {fwd} (expected {E * (n_train + n_val) + 1}"
          f", the check's first batch among them), backward {bwd} (expected "
          f"{2 * E * n_train + 2})")
    require(fwd == E * (n_train + n_val) + 1 and bwd == 2 * E * n_train + 2,
            f"two-cell launches {fwd}, {bwd}")
    require(not plain_on_cuda, f"plain two-cell versions ran on CUDA tensors: {plain_on_cuda}")
    require(len(stream_s) == E, f"{len(stream_s)} streamed epochs of {E}")

    # 1. --check_numerics: its line, and a NaN leaf named
    require("check_numerics: first batch loss/grads finite" in "".join(tee.text),
            "the check_numerics line was not printed")
    trainer, train = seen["trainer"], seen["train"]
    bad = loop.copy_params(seen["best_params"])
    bad["decoder_h"]["recurrent_kernel"][3, 7] = float("nan")
    first = {k: v[: args.batch_size] for k, v in train.items()}
    try:
        debug.check_first_batch(trainer.loss_fn, bad, first, torch.Generator(device=first[
            "x"].device).manual_seed(0), 1.0, args.class_weight, 1.0)
    except FloatingPointError as e:
        print(f"check_first_batch with one NaN: {e}")
        require("decoder_h/recurrent_kernel (1/" in str(e), f"leaf not named: {e}")
    else:
        require(False, "a NaN parameter did not raise")

    # 2. --data_init: the card's init against the CPU plain init on the same noise
    require(len(inits) == 1, f"{len(inits)} data-based inits")
    (p0, cfg, batch, eps_w, eps_z), got = inits[0]
    cpu = lambda t: {k: cpu(v) for k, v in t.items()} if isinstance(t, dict) else t.cpu()
    want = real_core(cpu(p0), cfg, cpu(batch), eps_w.cpu(), eps_z.cpu())
    rel = 0.0
    for name, layer in want.items():
        for leaf, v in layer.items():
            g = got[name][leaf].cpu()
            torch.testing.assert_close(g, v, rtol=1e-5, atol=1e-6, msg=f"{name}/{leaf}")
            rel = max(rel, ((g - v).abs() / v.abs().clamp_min(1e-6)).max().item())
    print(f"data-based init on the card ({batch['x'].shape[0]} rows, noise from a generator "
          f"seeded {args.seed + 1}) vs the CPU plain init on that noise: every leaf within rtol "
          f"1e-5 / atol 1e-6 (max relative {rel:.2e})")

    # 3. --streaming: the prefetch stream's batches vs synchronous copies, bitwise
    dev = first["x"].device
    host = {k: v.cpu().numpy()[: STREAM_STEPS * args.batch_size] for k, v in train.items()}
    cw = float(np.float32(args.class_weight))

    def step_losses(prefetch):
        p = loop.copy_params(seen["best_params"], requires_grad=True)
        opt, g = trainer.init_optimizer(p), torch.Generator(device=dev).manual_seed(SEED)
        losses, real_step = [], trainer.train_step

        def step(*a):
            m = real_step(*a)
            losses.append(m["loss"])
            return m

        trainer.train_step = step
        try:
            if prefetch:
                trainer.train_epoch_streaming(p, opt, host, g, 1.0, cw, 1.0,
                                              np.random.default_rng(SEED))
            else:
                for b in batch_iterator(host, args.batch_size, np.random.default_rng(SEED)):
                    step(p, opt, {k: torch.from_numpy(v).to(dev) for k, v in b.items()}, g,
                         1.0, cw, 1.0)
        finally:
            del trainer.train_step
        return torch.stack(losses).cpu()

    ls_p, ls_s = step_losses(True), step_losses(False)
    print(f"streamed vs synchronous copies, {len(ls_p)} steps: losses bitwise equal "
          f"{torch.equal(ls_p, ls_s)} (first {ls_p[0].item()!r}, last {ls_p[-1].item()!r})")
    require(len(ls_p) == STREAM_STEPS and torch.equal(ls_p, ls_s),
            "streamed step losses differ from synchronous copies")
    # warm epochs in turns, streamed / resident / resident / streamed (the CLI's first
    # epoch carries the run's warm-up, its second the profiler)
    p = loop.copy_params(seen["best_params"], requires_grad=True)
    opt, g = trainer.init_optimizer(p), torch.Generator(device=dev).manual_seed(SEED)
    host_all = {k: v.cpu().numpy() for k, v in train.items()}
    turns = {"streamed": [], "resident": []}
    for kind in ("streamed", "resident", "resident", "streamed"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if kind == "streamed":
            trainer.train_epoch_streaming(p, opt, host_all, g, 1.0, cw, 1.0,
                                          np.random.default_rng(SEED))
        else:
            trainer.train_epoch(p, opt, train, g, 1.0, cw, 1.0)
        torch.cuda.synchronize()
        turns[kind].append(round(time.perf_counter() - t0, 3))
    print(f"epoch wall time (host clock, synchronised; a record, no claim), {n_train} steps "
          f"each: the CLI's streamed epochs {[round(s, 3) for s in stream_s]} s (the first "
          f"with the warm-up, the second under the profiler); warm epochs in turns "
          f"streamed {turns['streamed']} s, resident {turns['resident']} s")

    # 4. --do_log: a JSONL line and an event an epoch, the same scalars
    with open(os.path.join(log_dir, "flags.jsonl")) as f:
        lines = [json.loads(x) for x in f]
    (events,) = [os.path.join(log_dir, "flags", n) for n in os.listdir(os.path.join(log_dir,
                                                                                    "flags"))]
    back = read_scalar_events(events)
    require([d["epoch"] for d in lines] == list(range(E)), f"JSONL epochs {lines}")
    require(back == [(d["epoch"], {k: float(np.float32(v)) for k, v in d.items() if k != "epoch"})
                     for d in lines], "the event file's scalars differ from the JSONL")
    print(f"--do_log: {len(lines)} JSONL lines, {len(back)} events read back equal "
          f"({len(back[0][1])} scalars each)")

    # 5. --trace_dir: one trace, naming the two-cell kernels' launches
    traces = [n for n in os.listdir(trace_dir) if n.endswith(".pt.trace.json")]
    require(len(traces) == 1, f"traces {traces}")
    with open(os.path.join(trace_dir, traces[0])) as f:
        events = json.load(f)["traceEvents"]
    kernels = collections.Counter(e["name"] for e in events if e.get("cat") == "kernel")
    two_cell = {n: c for n, c in kernels.items() if "two_cell" in n}
    launch_api = sum(1 for e in events if e.get("cat") == "cuda_runtime"
                     and "Launch" in e.get("name", ""))
    print(f"--trace_dir: {traces[0]}, {len(events)} events, {sum(kernels.values())} kernel "
          f"events ({launch_api} launch calls); two-cell kernels {two_cell}")
    require(any("two_cell_step" in n for n in two_cell)
            and any("two_cell_walk" in n for n in two_cell),
            f"the trace names no two-cell forward and backward kernels: {sorted(kernels)[:20]}")
    return fwd, bwd


WIDE_VRNN = ((2688, "f32"), (2688, "bf16"), (4096, "f32"), (4096, "bf16"))  # past 20 units a block
WIDE_VAE = (1024, 5120, 106)  # D, H, L: past the cooperative kernel's latent width


def _vrnn_raw_on(dev, seed, D, H, L, K):
    """Seeded glorot-scale cl_vrnn weights drawn on the card (torch), zero
    biases but the frame head's (-1: sparse frames)."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)

    def glorot(i, o):
        lim = math.sqrt(6.0 / (i + o))
        return (torch.rand((i, o), generator=g, device=dev) * 2 - 1) * lim

    z = lambda n, v=0.0: torch.full((n,), v, device=dev)
    return {
        "encoder_h": {"kernel": glorot(D + K, 4 * H), "recurrent_kernel": glorot(H, 4 * H),
                      "bias": z(4 * H)},
        "decoder_h": {"kernel": glorot(D + L + K, 4 * H), "recurrent_kernel": glorot(H, 4 * H),
                      "bias": z(4 * H)},
        "Z_mean": {"kernel": glorot(H, L), "bias": z(L)},
        "Z_log_var": {"kernel": glorot(H, L), "bias": z(L)},
        "X_decoded_mean": {"kernel": glorot(H, D), "bias": z(D, -1.0)},
    }


def _probs_against_plain(label, mode, pk, pp):
    """Kernel probabilities (u = 1) against the plain version's: f32 within
    1e-5; bf16 with no output ``bf16_outside`` and max 2e-2 / mean 2e-3.
    Returns the max abs error."""
    import torch

    require(torch.isfinite(pk).all().item() and pk.shape == pp.shape,
            f"{label}: probabilities not finite or misshapen")
    d = (pk - pp).abs()
    mx, mean = d.max().item(), d.mean().item()
    if mode == "f32":
        print(f"{label} probs, u=1: max |kernel - plain| = {mx:.3e} (limit 1e-5)")
        require(mx <= 1e-5, f"{label}: f32 probabilities differ by {mx}")
    else:
        errs, bad = bf16_outside((pk,), (pp,))
        print(f"{label} probs, u=1: max {mx:.3e} (limit 2e-2), mean {mean:.3e} (limit 2e-3); "
              f"{_fmt_errs(errs)}")
        require(not bad and mx <= 2e-2 and mean <= 2e-3, f"{label}: bf16 probabilities differ: "
                                                          f"{bad}, max {mx}, mean {mean}")
    return mx


def phase_wide_sampling(dev):
    """Phase 34: the widths where the port raised before the generation
    kernels took every config the JAX package samples. Returns the kernel
    table's rows of the cl_vrnn unit-group layout (times at bf16 H=4,096)
    and of the bf16 wide cl_vae kernel."""
    import numpy as np
    import torch

    from classifying_vae_lstm_tpu_torch.models import cl_vae, cl_vrnn
    from classifying_vae_lstm_tpu_torch.ops import cuda_generate as cg
    from classifying_vae_lstm_tpu_torch.ops import cuda_generate_vae as cgv
    from classifying_vae_lstm_tpu_torch.sampling import (draw_generation_noise,
                                                          generate_cl_vae_batch,
                                                          generate_cl_vrnn_batch)
    from classifying_vae_lstm_tpu_torch.weights import params_from_numpy

    B, nsteps, K = 8, 32, TRAIN_K
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    seeds = torch.from_numpy(seed_windows(B)).to(dev)
    Tseed = seeds.shape[1]
    ws = torch.eye(K, device=dev)[torch.arange(B, device=dev) % K]
    errs, launches, rows = [], 0, {}
    for i, (H, mode) in enumerate(WIDE_VRNN):
        cfg = cl_vrnn.Config(original_dim=88, intermediate_dim=H, latent_dim=2, seq_length=16,
                             n_classes=K, use_x_prev=True, bf16_compute=mode == "bf16")
        nu, nv, G = cg.gen_grid(H, n_sm)
        require(cg.pick_mode(cfg) == mode and cg.fits(cfg) and nv > 1,
                f"cl_vrnn H={H} {mode}: mode {cg.pick_mode(cfg)}, fits {cg.fits(cfg)}, nv {nv}")
        params = _vrnn_raw_on(dev, SEED + 40 + i, 88, H, 2, K)
        cg.LAUNCHES = cg.INT8_LAUNCHES = 0  # the entry point's launches
        frames = generate_cl_vrnn_batch(params, cfg, seeds, nsteps,
                                        torch.Generator(device=dev).manual_seed(SEED), ws)
        torch.cuda.synchronize()
        launches += cg.LAUNCHES
        require(cg.LAUNCHES == 1 and cg.INT8_LAUNCHES == 0,
                f"cl_vrnn H={H} {mode}: {cg.LAUNCHES} launches")
        require(frames.shape == (B, nsteps, 88) and set(torch.unique(frames).tolist()) <= {0, 1},
                f"cl_vrnn H={H} {mode}: frames")
        eps, _ = draw_generation_noise(torch.Generator(device=dev).manual_seed(SEED + 1), B,
                                       Tseed + nsteps, 2, 88)
        u1 = torch.ones((B, Tseed + nsteps, 88), device=dev)
        run = lambda f: f(params, cfg, seeds, nsteps, eps, u1, ws, return_probs=True, mode=mode)
        label = f"generate_kernel {mode} H={H} ({G} blocks of {nv} groups of {nu} units)"
        errs.append(_probs_against_plain(label, mode, run(cg.generate_cl_vrnn_batch_cuda),
                                         run(cg.generate_cl_vrnn_batch_plain)))
        k_ms = time_ms(lambda: run(cg.generate_cl_vrnn_batch_cuda), reps=3)
        p_ms = time_ms(lambda: run(cg.generate_cl_vrnn_batch_plain), reps=1)
        w = cg._pack(params, cfg, ws, 88, mode)
        wbytes = sum(w[k].numel() * w[k].element_size()
                     for k in ("wke_x", "rke", "wz_t", "wkd_x", "wkd_z", "rkd", "wx_t"))
        b_ms, b_by = bound_ms(cfg, B, Tseed, nsteps, wbytes,
                              PEAK_BF16_FLOPS if mode == "bf16" else PEAK_F32_FLOPS)
        print(f"{label}, {B} x ({Tseed} + {nsteps}): kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, "
              f"bound {b_ms:.4f} ms ({b_by}, {mode} rate); "
              f"{cg.launch_songs(nu, nv, 2)} songs a launch")
        rows[(H, mode)] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by}
    groups_row = {"launches": launches, "max_abs_err": max(errs), **rows[WIDE_VRNN[-1]]}

    D, H, L = WIDE_VAE
    cfg = cl_vae.Config(original_dim=D, intermediate_dim=H, latent_dim=L,
                        intermediate_class_dim=88, n_classes=K, bf16_compute=True)
    require(cgv.pick_mode(cfg) == "bf16" and cgv.kernel_for(cfg) == "generate_cl_vae_wide",
            f"cl_vae D={D} H={H} L={L}: {cgv.pick_mode(cfg)}, {cgv.kernel_for(cfg)}")
    rng = np.random.default_rng(SEED + 45)
    params = params_from_numpy(glorot_vae_raw(rng, D, H, L, K, False), dev)
    vseeds = torch.from_numpy((rng.random((B, D)) < 0.1).astype(np.float32)).to(dev)
    cgv.LAUNCHES = cgv.WIDE_LAUNCHES = cgv.COOP_LAUNCHES = cgv.CLUSTER_LAUNCHES = 0
    frames = generate_cl_vae_batch(params, cfg, vseeds, nsteps,
                                   torch.Generator(device=dev).manual_seed(SEED), w_vals=ws)
    torch.cuda.synchronize()
    require(cgv.LAUNCHES == cgv.WIDE_LAUNCHES == 1 and frames.shape == (B, nsteps, D),
            f"cl_vae wide bf16: {cgv.LAUNCHES} launches, {cgv.WIDE_LAUNCHES} wide")
    vae_launches = cgv.WIDE_LAUNCHES
    eps = torch.from_numpy(rng.standard_normal((B, nsteps, L), dtype=np.float32)).to(dev)
    u1 = torch.ones((B, nsteps, D), device=dev)
    run = lambda f: f(params, cfg, vseeds, nsteps, eps, u1, ws, return_probs=True)
    label = f"generate_wide_kernel bf16 D={D} H={H} L={L}"
    err = _probs_against_plain(label, "bf16", run(cgv.generate_cl_vae_batch_cuda),
                               run(cgv.generate_cl_vae_batch_plain))
    k_ms = time_ms(lambda: run(cgv.generate_cl_vae_batch_cuda), reps=3)
    p_ms = time_ms(lambda: run(cgv.generate_cl_vae_batch_plain), reps=1)
    w = cgv._pack(params, cfg, ws, "bf16")
    wbytes = sum(v.numel() * v.element_size() for n, v in w.items()
                 if v is not None and n not in ("encb", "decb", "zb", "xb"))
    b_ms, b_by = vae_bound_ms(cfg, B, nsteps, wbytes, PEAK_BF16_FLOPS)
    print(f"{label}, {B} x {nsteps}: kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, bound "
          f"{b_ms:.4f} ms ({b_by}, bf16 rate); {wbytes / 1e6:.3f} MB of bf16 weights read "
          "from L2 every step")
    return groups_row, {"launches": vae_launches, "max_abs_err": err, "ms": k_ms,
                        "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by}


def _dp_counted_rank(rank, args):
    """A ``--dp`` rank of a train CLI (spawned by the CLI in place of its
    ``_train_rank``): the kernels' launch counts set to 0 just before the
    rank's run and read just after, beside its losses and final parameters."""
    from classifying_vae_lstm_tpu_torch.cli import cl_vae_train, cl_vrnn_train, common
    from classifying_vae_lstm_tpu_torch.ops import two_cell as tc

    cli = cl_vae_train if hasattr(args, "intermediate_class_dim") else cl_vrnn_train
    seen, real_fit = {}, cli.fit

    def fit(*a, **k):
        out = real_fit(*a, **k)
        seen.update(final=common.tree_to_cpu(out[0]), history=out[2])
        return out

    cli.fit = fit
    tc.FWD_LAUNCHES = tc.BWD_LAUNCHES = 0
    _reset_dense_counts()
    try:
        best, best_loss = cli._train_rank(rank, args)
    finally:
        cli.fit = real_fit
    return {"best_loss": best_loss, "counts": (tc.FWD_LAUNCHES, tc.BWD_LAUNCHES,
                                               *_dense_counts()[:2]), **seen}


def phase_dp_train(model_dir):
    """Phase 35: both train CLIs through ``--dp 1`` (NCCL, world size 1)
    against the same runs without it. Returns the two-cell forward and
    backward and the dense-stack forward and backward launches of the DP
    runs."""
    import numpy as np
    import torch

    from classifying_vae_lstm_tpu_torch.cli import cl_vae_train, cl_vrnn_train, common
    from classifying_vae_lstm_tpu_torch.ops import two_cell as tc

    totals = []
    for cli, flags, base in ((cl_vrnn_train, ["--num_epochs", "2"], TRAIN_FLAGS),
                             (cl_vae_train, ["--num_epochs", "2", "--train_backend", "pallas"],
                              VAE_TRAIN_FLAGS)):
        name = cli.__name__.rsplit(".", 1)[1]
        counts = lambda: (tc.FWD_LAUNCHES, tc.BWD_LAUNCHES, *_dense_counts()[:2])

        def reset():
            tc.FWD_LAUNCHES = tc.BWD_LAUNCHES = 0
            _reset_dense_counts()

        args, one_counts, seen, _, wall = run_train(f"{name}_one", flags, model_dir, reset,
                                                    counts, cli=cli, base_flags=base)
        dargs = cli.build_parser().parse_args([f"{name}_dp", *base, *flags, "--dp", "1",
                                               "--model_dir", model_dir])
        real_rank = cli._train_rank
        cli._train_rank = _dp_counted_rank  # the CLI spawns it; its module is this script
        t0 = time.perf_counter()
        try:
            out = cli.train(dargs)
        finally:
            cli._train_rank = real_rank
        dp_wall = time.perf_counter() - t0
        hist, dp_hist = seen["history"], out["history"]
        print(f"{name} --dp 1 (NCCL, world size 1; {dp_wall:.2f} s with the rank's start, "
              f"without --dp {wall:.2f} s): losses {[round(v, 6) for v in dp_hist['loss']]} "
              f"against {[round(v, 6) for v in hist['loss']]}; launches (two-cell fwd, bwd, "
              f"dense fwd, bwd) {out['counts']} against {one_counts}")
        for k, v in hist.items():
            require(np.allclose(dp_hist[k], v, rtol=1e-5, atol=0), f"{name}: {k} {dp_hist[k]} "
                                                                  f"vs {v}")
        final = common.tree_to_cpu(seen["final_params"])
        worst, bitwise = 0.0, True
        for layer in final:
            for leaf in final[layer]:
                a, b = out["final"][layer][leaf], final[layer][leaf]
                bitwise &= torch.equal(a, b)
                worst = max(worst, ((a - b).abs() - 1e-4 * b.abs()).max().item())
        print(f"{name} --dp 1 final parameters: bitwise {'equal' if bitwise else 'unequal'}, "
              f"max(|dp - one| - 1e-4 |one|) {worst:.3e} (limit 1e-6)")
        require(worst <= 1e-6, f"{name}: final parameters differ ({worst})")
        require(out["counts"] == one_counts and sum(one_counts) > 0,
                f"{name}: --dp 1 launches {out['counts']}, without --dp {one_counts}")
        totals.append(out["counts"])
    (fwd, bwd, _, _), (_, _, dfwd, dbwd) = totals
    return fwd, bwd, dfwd, dbwd


def phase_dp_sharded(dev):
    """Phase 36: the one-process DP paths over a two-shard mesh of the one
    card. Returns the cl_vrnn generation, cl_vae generation and LSTM
    inference-forward launches of the DP calls (serving's included)."""
    import numpy as np
    import torch

    from classifying_vae_lstm_tpu_torch.cli import common, evaluate, serve
    from classifying_vae_lstm_tpu_torch.evaluation import nll
    from classifying_vae_lstm_tpu_torch.ops import cuda_generate as cg
    from classifying_vae_lstm_tpu_torch.ops import cuda_generate_vae as cgv
    from classifying_vae_lstm_tpu_torch.ops import lstm_seq as ls
    from classifying_vae_lstm_tpu_torch.parallel import make_mesh, replicate
    from classifying_vae_lstm_tpu_torch.sampling import (draw_generation_noise,
                                                          generate_cl_vae_batch,
                                                          generate_cl_vae_batch_dp,
                                                          generate_cl_vrnn_batch,
                                                          generate_cl_vrnn_batch_dp,
                                                          infer_w_cl_vae, infer_w_cl_vrnn)
    from classifying_vae_lstm_tpu_torch.weights import params_from_numpy

    mesh = make_mesh(2, devices=[dev, dev])
    gen = lambda: torch.Generator(device=dev).manual_seed(SEED + 50)

    def against_shards(label, kmod, dp_call, one_call, shard_call, draw):
        kmod.LAUNCHES = 0
        out = dp_call()
        torch.cuda.synchronize()
        launches = kmod.LAUNCHES
        require(launches == 2, f"{label}: {launches} launches for two shards")
        eps, u = draw()
        b = out.shape[0] // 2
        for r in range(2):
            rows = slice(r * b, (r + 1) * b)
            require(torch.equal(out[rows], shard_call(rows, eps, u)),
                    f"{label}: shard {r} differs from the single-device call on its songs")
        whole = one_call()
        agree = (out == whole).float().mean().item()
        print(f"{label} on a two-shard mesh of the card: 2 launches, each shard bitwise the "
              f"single-device call on its songs; {agree:.6f} of the frames equal the whole "
              f"batch's single-device call (another song count a launch: another sum order)")
        require(agree >= 0.99, f"{label}: frames agree {agree}")
        return launches

    raw, cfg, _ = common.load_model(MODEL, "cl_vrnn")
    params = params_from_numpy(raw, dev)
    seeds = torch.from_numpy(seed_windows(64)).to(dev)
    ws = infer_w_cl_vrnn(params, cfg, seeds)
    T, n = seeds.shape[1], 64
    draw = lambda: draw_generation_noise(gen(), 64, T + n, cfg.latent_dim, 88)
    dp_gen = against_shards(
        "generate_cl_vrnn_batch_dp (jsball_vrnn4, 64 x (32 + 64))", cg,
        lambda: generate_cl_vrnn_batch_dp(params, cfg, seeds, n, gen(), ws, mesh),
        lambda: generate_cl_vrnn_batch(params, cfg, seeds, n, gen(), ws),
        lambda rows, eps, u: cg.generate_cl_vrnn_batch_cuda(
            params, cfg, seeds[rows].contiguous(), n, eps[rows].contiguous(),
            u[rows].contiguous(), ws[rows].contiguous()), draw)

    vraw, vcfg, _ = common.load_model(VAE_MODEL, "cl_vae")
    vparams = params_from_numpy(vraw, dev)
    vseeds = torch.from_numpy(np.ascontiguousarray(seed_windows(64)[:, 0])).to(dev)
    vws = infer_w_cl_vae(vparams, vseeds)
    vdraw = lambda: draw_generation_noise(gen(), 64, 64, vcfg.latent_dim, 88)
    dp_vae = against_shards(
        "generate_cl_vae_batch_dp (jsball_vae, 64 x 64, keys inferred)", cgv,
        lambda: generate_cl_vae_batch_dp(replicate(vparams, mesh), vcfg, vseeds, 64, gen(),
                                         None, mesh),
        lambda: generate_cl_vae_batch(vparams, vcfg, vseeds, 64, gen()),
        lambda rows, eps, u: cgv.generate_cl_vae_batch_cuda(
            vparams, vcfg, vseeds[rows].contiguous(), 64, eps[rows].contiguous(),
            u[rows].contiguous(), vws[rows].contiguous()), vdraw)

    # the CLIs with --dp 2, their mesh the two shards of the one card (a
    # --dp past the card count raises)
    real_mesh, dp_calls = common.dp_mesh, []
    common.dp_mesh = lambda args: (dp_calls.append(args.dp), mesh)[1]
    argv = ["-i", MODEL, "--train_file", EVAL_CORPUS, "--lstm_backend", "pallas", "--n_samples",
            str(EVAL_SAMPLES), "--batch_size", str(EVAL_B)]
    calls, real_one, real_dp = [], nll.iw_nll_dataset, nll.iw_nll_dataset_dp

    def spy(fn):
        def spied(*a, **k):
            calls.append(fn(*a, **k))
            return calls[-1]
        return spied

    evaluate.iw_nll_dataset, evaluate.iw_nll_dataset_dp = spy(real_one), spy(real_dp)
    try:
        one = evaluate.evaluate(evaluate.build_parser().parse_args(argv))
        _reset_lstm_counts()
        t0 = time.perf_counter()
        two = evaluate.evaluate(evaluate.build_parser().parse_args([*argv, "--dp", "2"]))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        dp_eval = _lstm_counts()["FWD"]
        plain_on_cuda = []
        args = serve.build_parser().parse_args(["-i", MODEL, "--train_file", CORPUS, "--dp",
                                                "2", "--warmup", "off", "--port", "0"])
        with sampler_plain_guard(cg, "generate_cl_vrnn_batch_plain", plain_on_cuda):
            cg.LAUNCHES = 0
            httpd, engine = serve.make_server(args)
            require(engine.mesh is mesh, "serve --dp 2 did not take the two-shard mesh")
            stats = exercise_server(httpd)
            served = cg.LAUNCHES
    finally:
        common.dp_mesh = real_mesh
        evaluate.iw_nll_dataset, evaluate.iw_nll_dataset_dp = real_one, real_dp
    nb = -(-EVAL_WINDOWS // EVAL_B)
    diff = (calls[1].double() - calls[0].double()).abs()
    print(f"evaluate --dp 2 (jsball_vrnn4 on {EVAL_CORPUS}, pallas, two shards of the card): "
          f"{two['test_nll_nats_per_frame']} against one device's "
          f"{one['test_nll_nats_per_frame']}; {dp_eval} inference-forward launches (expected "
          f"{4 * nb}), {wall:.3f} s; per-window |difference| max {diff.max().item():.3e}, mean "
          f"NLLs {abs(calls[1].double().mean() - calls[0].double().mean()).item():.3e} apart "
          "(limit 1e-4)")
    require(dp_calls == [2, 2], f"dp_mesh calls {dp_calls}")
    require(dp_eval == 4 * nb, f"evaluation launches {dp_eval}")
    require(abs(calls[1].double().mean() - calls[0].double().mean()).item() <= 1e-4,
            f"DP evaluation differs: {one}, {two}")
    print(f"serve --dp 2 (two shards of the card): {stats['requests']} requests, {served} "
          "launches")
    require(served > 0 and not plain_on_cuda, f"serve --dp 2: {served} launches, "
                                               f"plain on CUDA {plain_on_cuda}")
    return dp_gen + served, dp_vae, dp_eval


def _tp_counts() -> dict:
    """Every launch count a phase-37 run can move: the LSTM and two-cell
    counts, the dense-stack counts and the cl_vrnn generation count."""
    from classifying_vae_lstm_tpu_torch.ops import cuda_generate as cg

    counts = _lstm_counts()
    counts.update(zip(("DENSE_FWD", "DENSE_BWD", "DENSE_BF16_FWD", "DENSE_BF16_BWD"),
                      _dense_counts()))
    counts["GENERATE"] = cg.LAUNCHES
    return counts


def _reset_tp_counts():
    from classifying_vae_lstm_tpu_torch.ops import cuda_generate as cg
    from classifying_vae_lstm_tpu_torch.parallel import columns

    _reset_lstm_counts()
    _reset_dense_counts()
    cg.LAUNCHES = 0
    columns.SHARD_PRODUCTS = 0


def _params_apart(tp, one, rel):
    """(bitwise equal, max(|tp - one| - rel |one|), the largest relative
    norm ||tp - one|| / ||one|| of a leaf) over two parameter trees, read on
    the host (column shards gathered)."""
    from classifying_vae_lstm_tpu_torch.cli.common import tree_to_cpu

    tp, one = tree_to_cpu(tp), tree_to_cpu(one)
    worst, norm, bitwise = 0.0, 0.0, True
    for layer in one:
        for leaf in one[layer]:
            a, b = tp[layer][leaf], one[layer][leaf]
            bitwise &= bool((a == b).all())
            worst = max(worst, ((a - b).abs() - rel * b.abs()).max().item())
            norm = max(norm, ((a - b).norm() / b.norm().clamp_min(1e-30)).item())
    return bitwise, worst, norm


def _tp_train(dev, mod, cfg, raw, data, B, placing, mesh=None):
    """One training epoch of ``data`` (its rows / B steps) through a
    ``Trainer``, from ``raw`` placed by ``placing`` (``"replicated"`` on the
    card, ``"tp"`` column-sharded over ``[dev, dev]``, ``"mesh"``: the
    Trainer's own placement on ``mesh``, a DP rank); every count set to 0
    just before the epoch and read just after. Returns the loss, the final
    parameters, the counts, the shard products and ms per step."""
    import torch

    from classifying_vae_lstm_tpu_torch.optim import init_optimizer
    from classifying_vae_lstm_tpu_torch.parallel import columns
    from classifying_vae_lstm_tpu_torch.train import Trainer
    from classifying_vae_lstm_tpu_torch.train.loop import copy_params
    from classifying_vae_lstm_tpu_torch.weights import params_from_numpy, params_on_model_axis

    def loss_fn(p, b, g, kl_w, class_w, w_kl_w):
        return mod.loss_and_metrics(p, cfg, b, g, kl_w, class_w, w_kl_w)

    noise_fn = (lambda g: mod.draw_apply_noise(g, cfg, B)) if mesh is not None else None
    trainer = Trainer(loss_fn, init_optimizer("adam-wn")[0], B, mesh=mesh, noise_fn=noise_fn)
    params = (params_on_model_axis(raw, [dev, dev]) if placing == "tp"
              else trainer.place(params_from_numpy(raw, dev)))
    params = copy_params(params, requires_grad=True)
    opt = trainer.init_optimizer(params)
    g = torch.Generator(device=dev).manual_seed(SEED + 37)
    name = "train_step" if mesh is None else "_dp_step"  # the epoch's step of this path
    real_step, ends = getattr(trainer, name), []

    def timed_step(*a, **k):
        out = real_step(*a, **k)
        torch.cuda.synchronize()
        ends.append(time.perf_counter())
        return out

    setattr(trainer, name, timed_step)
    torch.cuda.synchronize()
    _reset_tp_counts()
    t0 = time.perf_counter()
    m = trainer.train_epoch(params, opt, data, g, 1.0, 1.0, 1.0)
    loss = float(m["loss"])
    torch.cuda.synchronize()
    step_ms = [(b - a) * 1e3 for a, b in zip([t0] + ends, ends)]
    # ms per step: the median after the first step, which carries the warm-up
    return {"loss": loss, "params": params, "counts": _tp_counts(),
            "shard": columns.SHARD_PRODUCTS, "ms": statistics.median(step_ms[1:]),
            "first_ms": step_ms[0]}


def _tp_pair(label, runs, need, ms_rows, heads=True, bf16=False):
    """Hold a TP run against the replicated one: losses (rtol 1e-5; bf16:
    phase 21's 1e-2); final parameters, each leaf's relative norm of the
    difference within 1e-5 (bf16: phase 21's 1e-2) and, in f32, every
    element within JAX ``tests/test_parallel.py``'s bound for its TP epoch
    against one device (rtol 1e-3, atol 1e-5); every launch count (equal,
    the ``need``ed ones > 0) and the shard products (0 on the replicated
    run; on the TP run > 0 where plain products, the heads', sit outside the
    kernels, else 0). Phase 35's elementwise metric is printed beside: the
    column-split products sum in another order, and AdamWN turns an
    ulp-level gradient difference of a near-zero gradient into a visible
    step, so a few elements move past its 1e-6 (``PERF.md`` §6 has the figures)."""
    one, tp = runs["replicated"], runs["tp"]
    loss_rtol, norm_limit = (1e-2, 1e-2) if bf16 else (1e-5, 1e-5)
    rel = abs(tp["loss"] - one["loss"]) / abs(one["loss"])
    bitwise, worst, norm = _params_apart(tp["params"], one["params"], 1e-4)
    _, jax_tp, _ = _params_apart(tp["params"], one["params"], 1e-3)
    print(f"{label}: loss TP {tp['loss']!r}, replicated {one['loss']!r} (relative "
          f"{rel:.3e}, limit {loss_rtol}); final parameters bitwise "
          f"{'equal' if bitwise else 'unequal'}, largest relative norm of a leaf's "
          f"difference {norm:.3e} (limit {norm_limit}), max(|tp - one| - 1e-3 |one|) "
          f"{jax_tp:.3e}{' (limit 1e-5)' if not bf16 else ''}, max(|tp - one| - 1e-4 |one|) "
          f"{worst:.3e}; launches {nonzero(tp['counts'])} against {nonzero(one['counts'])}; "
          f"shard products {tp['shard']} (replicated {one['shard']}); ms per step (median "
          f"after the first) TP {tp['ms']:.3f}, replicated {one['ms']:.3f} (first step "
          f"{tp['first_ms']:.3f} / {one['first_ms']:.3f})")
    require(rel <= loss_rtol, f"{label}: losses {tp['loss']} vs {one['loss']}")
    require(norm <= norm_limit and (bf16 or jax_tp <= 1e-5),
            f"{label}: final parameters differ ({norm}, {jax_tp})")
    require(tp["counts"] == one["counts"] and all(tp["counts"][n] > 0 for n in need),
            f"{label}: launches {tp['counts']} vs {one['counts']}")
    require((tp["shard"] > 0) == heads and one["shard"] == 0,
            f"{label}: shard products {tp['shard']}, replicated {one['shard']}")
    ms_rows[label.split(" ", 1)[0]] = (round(tp["ms"], 3), round(one["ms"], 3))
    return tp["counts"]


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def phase_tensor_parallel(dev):
    """Phase 37: tensor parallelism on a (1, 2) mesh that repeats the card;
    each run once replicated and once column-sharded. Returns the TP runs'
    launches: two-cell forward and backward, bf16 LSTM training forward and
    backward, f32 LSTM inference forward, dense-stack forward and backward,
    cl_vrnn generation."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from classifying_vae_lstm_tpu_torch.cli import common
    from classifying_vae_lstm_tpu_torch.data import PianoData
    from classifying_vae_lstm_tpu_torch.evaluation.nll import iw_nll_dataset
    from classifying_vae_lstm_tpu_torch.models import cl_vae, cl_vrnn
    from classifying_vae_lstm_tpu_torch.ops import cuda_generate as cg
    from classifying_vae_lstm_tpu_torch.ops import lstm_seq as ls
    from classifying_vae_lstm_tpu_torch.ops import two_cell as tc
    from classifying_vae_lstm_tpu_torch.ops import vae_dense as vd
    from classifying_vae_lstm_tpu_torch.parallel import columns, make_mesh
    from classifying_vae_lstm_tpu_torch.sampling import generate_cl_vrnn_batch, infer_w_cl_vrnn
    from classifying_vae_lstm_tpu_torch.weights import params_from_numpy, params_on_model_axis

    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 37)
    to = lambda a: torch.from_numpy(a).to(dev)
    init = lambda mod, cfg, seed: common.tree_to_cpu(
        mod.init(torch.Generator(device=dev).manual_seed(seed), cfg))

    def windows(n, T, D, K):
        f = (rng.random((n, T + 2, D)) < 0.1).astype(np.float32)
        w = np.eye(K, dtype=np.float32)[rng.integers(0, K, n)]
        return {"x_prev": to(f[:, :T]), "x": to(f[:, 1:T + 1]), "y": to(f[:, 2:]), "w": to(w)}

    ms_rows, plain_on_cuda, out = {}, [], {}
    with plain_guard(tc, ("two_cell_fwd_plain", "two_cell_bwd_plain"), plain_on_cuda), \
            plain_guard(ls, LSTM_SEQ_PLAIN, plain_on_cuda), \
            plain_guard(vd, VAE_DENSE_PLAIN, plain_on_cuda):
        # (a) f32 two-cell cl_vrnn at TRAIN_FLAGS width, 3 steps
        cfg_a = cl_vrnn.Config(original_dim=88, intermediate_dim=256, latent_dim=8,
                               seq_length=TRAIN_T, n_classes=TRAIN_K, use_x_prev=True,
                               lstm_backend="pallas")
        raw_a, data_a = init(cl_vrnn, cfg_a, SEED + 1), windows(4 * TRAIN_B, TRAIN_T, 88, TRAIN_K)
        runs_a = {p: _tp_train(dev, cl_vrnn, cfg_a, raw_a, data_a, TRAIN_B, p)
                  for p in ("replicated", "tp")}
        out["a"] = _tp_pair("(a) f32 two-cell cl_vrnn, H=256 B=200, 4 steps", runs_a,
                            ("TWO_CELL_FWD", "TWO_CELL_BWD"), ms_rows)
        # (b) bf16 cl_vrnn at BF16_FLAGS (H=1,024, B=1,024, --two_cell off), 3 steps
        cfg_b = cl_vrnn.Config(original_dim=88, intermediate_dim=BF16_H, latent_dim=BF16_L,
                               seq_length=TRAIN_T, n_classes=TRAIN_K, use_x_prev=True,
                               lstm_backend="pallas", bf16_compute=True,
                               fusion=(True, True, True), two_cell=False)
        raw_b, data_b = init(cl_vrnn, cfg_b, SEED + 2), windows(3 * BF16_B, TRAIN_T, 88, TRAIN_K)
        runs_b = {p: _tp_train(dev, cl_vrnn, cfg_b, raw_b, data_b, BF16_B, p)
                  for p in ("replicated", "tp")}
        out["b"] = _tp_pair("(b) bf16 cl_vrnn, H=1,024 B=1,024 --two_cell off, 3 steps",
                            runs_b, ("BF16_TRAIN_FWD", "BF16_BWD"), ms_rows, bf16=True)
        # (c) f32 cl_vae at VAE_TRAIN_FLAGS, --train_backend pallas, 6 steps
        cfg_c = cl_vae.Config(original_dim=88, intermediate_dim=88, latent_dim=4,
                              intermediate_class_dim=88, n_classes=TRAIN_K, use_x_prev=True,
                              train_backend="pallas")
        f = (rng.random((6 * VAE_TRAIN_B + 1, 88)) < 0.1).astype(np.float32)
        data_c = {"x_prev": to(f[:-1]), "x": to(f[1:]), "y": to(f[1:]),
                  "w": to(np.eye(TRAIN_K, dtype=np.float32)[rng.integers(0, TRAIN_K,
                                                                          len(f) - 1)])}
        raw_c = init(cl_vae, cfg_c, SEED + 3)
        runs_c = {p: _tp_train(dev, cl_vae, cfg_c, raw_c, data_c, VAE_TRAIN_B, p)
                  for p in ("replicated", "tp")}
        # (the kernels take the whole graph: no plain product is left to split)
        out["c"] = _tp_pair("(c) f32 cl_vae, D=H=88 B=100, dense-stack kernels, 6 steps",
                            runs_c, ("DENSE_FWD", "DENSE_BWD"), ms_rows, heads=False)
        require(out["c"]["DENSE_FWD"] == 6 and out["c"]["DENSE_BWD"] == 6,
                f"(c) dense-stack launches {out['c']}")

        # (d) IW-NLL of c5m through the H=88 inference kernel, two batches of 200
        raw_d, cfg_d, margs = common.load_model(KC_MODEL, "cl_vrnn")
        cfg_d = common.resolve_lstm_backend(cfg_d, "pallas")
        P = PianoData(CORPUS, batch_size=1, seq_length=margs["seq_length"],
                      return_y_next=True, return_y_hist=True, squeeze_x=False,
                      squeeze_y=False)
        test = common.build_cl_vrnn_datasets(P, margs["n_classes"], cfg_d.use_x_prev,
                                             dev)["test"]
        data_d = {k: v[:2 * EVAL_B] for k, v in test.items() if k in ("x", "y", "x_prev")}
        nll = {}
        for placing, params in (("replicated", params_from_numpy(raw_d, dev)),
                                ("tp", params_on_model_axis(raw_d, [dev, dev]))):
            _reset_tp_counts()
            nll[placing] = (iw_nll_dataset(params, cfg_d, data_d,
                                           torch.Generator(device=dev).manual_seed(SEED),
                                           EVAL_SAMPLES, EVAL_B, "cl_vrnn"),
                            _tp_counts(), columns.SHARD_PRODUCTS)
        (one, c_one, s_one), (tp, c_tp, s_tp) = nll["replicated"], nll["tp"]
        rel = ((tp - one).abs() / one.abs()).max().item()
        print(f"(d) iw_nll_dataset of c5m (H=88, {2 * EVAL_B} test windows of {CORPUS}, "
              f"{EVAL_SAMPLES} samples, pallas): mean NLL TP {tp.mean().item()!r}, replicated "
              f"{one.mean().item()!r}; per window max relative difference {rel:.3e} (limit "
              f"1e-5); launches {nonzero(c_tp)} against {nonzero(c_one)}; shard products "
              f"{s_tp} (replicated {s_one})")
        require(torch.isfinite(tp).all() and rel <= 1e-5, f"(d) NLLs differ by {rel}")
        require(c_tp == c_one and c_tp["FWD"] == 4 and s_tp > 0 and s_one == 0,
                f"(d) launches {c_tp} vs {c_one}, shard products {s_tp}")
        out["d"] = c_tp

        # (e) cl_vrnn generation at jsball_vrnn4 width: 64 songs x (32 + 64)
        raw_e, cfg_e, _ = common.load_model(MODEL, "cl_vrnn")
        seeds = torch.from_numpy(seed_windows(64)).to(dev)
        frames = {}
        for placing, params in (("replicated", params_from_numpy(raw_e, dev)),
                                ("tp", params_on_model_axis(raw_e, [dev, dev]))):
            ws = infer_w_cl_vrnn(params, cfg_e, seeds)
            _reset_tp_counts()
            got = generate_cl_vrnn_batch(params, cfg_e, seeds, 64,
                                         torch.Generator(device=dev).manual_seed(SEED + 7), ws)
            torch.cuda.synchronize()
            frames[placing] = (got, _tp_counts())
        (one, c_one), (tp, c_tp) = frames["replicated"], frames["tp"]
        print(f"(e) generate_cl_vrnn_batch (jsball_vrnn4, 64 x (32 + 64)): TP frames "
              f"{'bitwise equal to' if torch.equal(tp, one) else 'unlike'} the replicated "
              f"call's; launches {nonzero(c_tp)} against {nonzero(c_one)}")
        require(torch.equal(tp, one), "(e) TP generation differs")
        require(c_tp == c_one and c_tp["GENERATE"] == 1, f"(e) launches {c_tp} vs {c_one}")
        out["e"] = c_tp

        # (f) run (a) through Trainer(mesh=make_mesh(1, 2, [dev, dev])), a
        # one-rank NCCL group: the DP step over column-sharded parameters
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method=f"tcp://localhost:{_free_port()}", rank=0,
                                world_size=1)
        try:
            mesh = make_mesh(1, 2, devices=[dev, dev])
            runs_f = {"replicated": runs_a["replicated"],
                      "tp": _tp_train(dev, cl_vrnn, cfg_a, raw_a, data_a, TRAIN_B, "mesh",
                                      mesh)}
        finally:
            dist.destroy_process_group()
        out["f"] = _tp_pair("(f) run (a) through Trainer(mesh=make_mesh(1, 2, [card, card])), "
                            "NCCL world size 1", runs_f, ("TWO_CELL_FWD", "TWO_CELL_BWD"),
                            ms_rows)
    require(not plain_on_cuda, f"plain versions ran on CUDA tensors: {plain_on_cuda}")
    print(f"tensor parallelism (phase 37): ms per step (TP, replicated) {ms_rows}; "
          f"{time.perf_counter() - t0:.1f} s")
    a, b, c, d, e, f = (out[k] for k in "abcdef")
    return (a["TWO_CELL_FWD"] + f["TWO_CELL_FWD"], a["TWO_CELL_BWD"] + f["TWO_CELL_BWD"],
            b["BF16_TRAIN_FWD"], b["BF16_BWD"], d["FWD"], c["DENSE_FWD"], c["DENSE_BWD"],
            e["GENERATE"])


EXP_SHAPES = ((64, 128, 32), (1024, 512, 256))  # (B, H, bb): the tests' and the h512 tool's
EXP_ILV = (512, 1024)  # (H, B) of the interleave's first row
EXP_TOL = {"chain_mm": 1e-2, "chain_mm_x2": 1e-2, "chain_mm_x2_fullwidth": 1e-2,
           "chain_mm_encdec": 1e-2, "gates_fwd": 1e-4, "gates_bwd": 1e-4, "offchain_mm": 1e-4}
EXP_STEP_TOL = 1e-4  # a chain's single step: f32 sums of the same bf16 operands
# f32 operations an element and step of the gates kernels, a tanh counted as one
EXP_GATE_OPS = {"gates_fwd": 22, "gates_bwd": 45}
EXP_REPLACES = {"chain_mm": "exp_h512_ablation.py:315", "chain_mm_x2": "exp_h512_ablation.py:315",
                "chain_mm_x2_fullwidth": "exp_h512_ablation.py:338",
                "chain_mm_encdec": "exp_h512_ablation.py:338",
                "gates_fwd": "exp_h512_ablation.py:375", "gates_bwd": "exp_h512_ablation.py:375",
                "offchain_mm": "exp_h512_ablation.py:401",
                "interleave": "exp_lstm_interleave.py:118",
                "mini_walk": "repro_full_bwd_fault.py:140"}


def exp_bound_ms(name, B, H, bb, T=16, IN=128) -> tuple[float, str]:
    """Least time of a probe at (B, H, bb): its tensor-core operations at
    the bf16 rate (the gates' f32 operations at the f32 rate) against its
    bytes, each input read once (the chains read h0's first bb rows, the
    off-chain product block 0's rows of dz), each output written once."""
    H4 = 4 * H
    if name in ("chain_mm", "chain_mm_x2"):
        return roofline_ms(B * H * H4 * T, 4 * bb * H + 2 * H * H4 + 4 * B * H, PEAK_BF16_FLOPS)
    if name.startswith("chain_mm"):
        return roofline_ms(2 * B * H * H4 * T, 8 * bb * H + 4 * H * H4 + 8 * B * H,
                           PEAK_BF16_FLOPS)
    if name in EXP_GATE_OPS:
        return roofline_ms(EXP_GATE_OPS[name] * B * H * T / 2, 4 * B * H4 + 4 * B * H)
    return roofline_ms(B * (H + IN) * H4 * T, 2 * (B * H + bb * H4 + B * IN) + 4 * (H + IN) * H4,
                       PEAK_BF16_FLOPS)


def _first(pair):
    return None if pair is None else pair[0]


# the kernel each probe launches, as the profiler names it
EXP_KERNEL = {"chain_mm": "chain_kernel", "chain_mm_x2": "chain_kernel",
              "chain_mm_x2_fullwidth": "pair_kernel", "chain_mm_encdec": "pair_kernel",
              "gates_fwd": "gates_fwd_kernel", "gates_bwd": "gates_bwd_kernel",
              "offchain_mm": "offchain_kernel"}


def queued_ms(fn, reps: int = 20) -> float:
    """Device ms a call of ``fn`` with the host's work between calls hidden:
    a spinning kernel holds the stream while the host queues ``reps`` calls,
    so the CUDA events bracket only their kernels, run back to back (the
    wrapper's own fills included). Back-to-back calls of a ~30 us kernel are
    otherwise paced by the wrapper's host work (``time_ms``), and the
    profiler keeps no device time late in a run of every phase."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    for margin in (4, 16, 64):  # the spin in cycles: margin x the host's time at <= 2 GHz
        ev[0].record()
        torch.cuda._sleep(int(margin * host_ms * 2e6) + 10_000)
        ev[1].record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        queued = (time.perf_counter() - t0) * 1e3
        ev[2].record()
        torch.cuda.synchronize()
        spin = ev[0].elapsed_time(ev[1])
        if queued < spin:
            return ev[1].elapsed_time(ev[2]) / reps
    require(False, f"the host took {queued:.3f} ms to queue the calls, past the {spin:.3f} ms "
                   "spin that hides it")


def phase_exp_probes(dev):
    """The step-decomposition probes of ``tools/`` (phase 40): the three
    tools' paths, counted, then each kernel against its plain version and
    timed. Returns the kernel table's rows of the nine kernels."""
    import numpy as np
    import torch

    from classifying_vae_lstm_tpu_torch.ops import exp_lstm as ex
    from tools import torch_exp_h512_ablation as abl
    from tools import torch_exp_lstm_interleave as ilv
    from tools import torch_repro_full_bwd_fault as ladder

    t0 = time.perf_counter()
    B, H, bb = EXP_SHAPES[1]
    ex.reset_counts()
    micro = abl.run_micro(B, H, bb, dev, reps=2, profile=False)
    ilv_row = ilv.run(*EXP_ILV, dev, reps=2)
    torch.cuda.synchronize()
    counts = ex.counts()
    print(f"probe tools' paths (h512 microkernels at B={B} H={H} bb={bb}, interleave at "
          f"(H, B)={EXP_ILV}): launches {counts}; micro rows {micro}; interleave {ilv_row}")
    t1 = time.perf_counter()
    rows = ladder.run_ladder("cuda", ladder.CASES, timeout=300)
    counts["mini_walk"] = sum(r.get("launches", {}).get("exp_lstm.MINI_WALK_LAUNCHES", 0)
                              for r in rows)
    failed = [r["case"] for r in rows if not (r["ok"] and r["finite"]) or r["crashed"]]
    print(f"fault ladder: {len(rows) - len(failed)}/{len(rows)} cases finite and within "
          f"tolerance, {time.perf_counter() - t1:.1f} s (the tools' paths before it "
          f"{t1 - t0:.1f} s)")
    require(not failed, f"fault ladder cases failed: {failed}")
    require(all(v > 0 for v in counts.values()), f"a probe kernel was not launched: {counts}")
    require(all(r["launches"] for r in rows if r["case"][:4] in ("real", "jit_")),
            "a ladder case at B=500 launched no LSTM kernel")
    require(ilv_row["bitwise_equal_to_baseline"], "the interleave differs from the baseline")

    out = {}
    for shape in EXP_SHAPES:
        Bs, Hs, bbs = shape
        a = abl.micro_inputs(Bs, Hs, dev)
        calls, plains = abl.micro_calls(ex, a, bbs), abl.micro_calls(ex, a, bbs, plain=True)
        for name in abl.MICRO:
            got = calls[name]()
            want = abl.reference(ex, name, got, a, bbs)
            got, want = (got if isinstance(got, tuple) else (got,),
                         want if isinstance(want, tuple) else (want,))
            err = max((g - w).abs().max().item() for g, w in zip(got, want))
            top = min(w.abs().max().item() for w in want)
            require(all(torch.isfinite(g).all() for g in got) and 1e-3 < top < 1e6,
                    f"{name} at {shape}: outputs not finite or of size {top}")
            # the outputs that carry a state from block to block, block by block
            parts = ([slice(None)] if name == "offchain_mm"
                     else [slice(b * bbs, (b + 1) * bbs) for b in range(Bs // bbs)])
            rels = []
            for g, w in zip(got, want):
                for s in parts:
                    e = (g[s] - w[s]).abs().max().item()
                    rels.append(e / w[s].abs().max().item())
                    require(e <= EXP_TOL[name] * w[s].abs().max().item(),
                            f"{name} at {shape}: {e} past {EXP_TOL[name]} of its largest entry")
            print(f"{name} at B={Bs} H={Hs} bb={bbs}: relative error of each output block "
                  f"{['%.2e' % r for r in rels]} (limit {EXP_TOL[name]})")
            if shape != EXP_SHAPES[1]:
                continue
            row = {"max_abs_err": err, "ms": queued_ms(calls[name]),
                   "event_ms": time_ms(calls[name], 20), "plain_ms": time_ms(plains[name], 3),
                   "device_ms": _first(device_ms_per_call(calls[name], 3, EXP_KERNEL[name],
                                                          launches=1))}
            row["bound_ms"], row["bound_by"] = exp_bound_ms(name, Bs, Hs, bbs)
            row["library_ms"] = None
            if name == "offchain_mm":  # one product of the same operations (bf16 out)
                lhs = torch.cat([a["hp"], a["xp"]], 1).repeat(16, 1).T
                rhs = a["dz"][:bbs].repeat(16 * Bs // bbs, 1)
                require(torch.allclose(torch.mm(lhs, rhs).float(), torch.cat(got), rtol=2e-2,
                                       atol=2e-2 * got[0].abs().max().item()),
                        "the library product computes another function")
                row["library_ms"] = queued_ms(lambda: torch.mm(lhs, rhs))
            out[name] = row
            print(f"{name} at B={Bs} H={Hs} bb={bbs}: {row}")

    # the chains one step a block (T=1), each step from the kernel's own
    # state: a bias a step would show here, where 16 steps of roundings
    # cannot hide it (two correct f32 sum orders part by ~3e-7 a step)
    a = abl.micro_inputs(B, H, dev)
    for name in EXP_KERNEL:
        if not name.startswith("chain"):
            continue
        ins = ((a["h0"], a["rkA"]) if name in ("chain_mm", "chain_mm_x2")
               else (a["h0"], a["g0"], a["rkA"], a["rkB"]))
        got = getattr(ex, name)(*ins, bb, 1)
        want = ex.chain_plain_blockwise(name, got, *ins, bb=bb, T=1)
        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        worst = max((g[s] - w[s]).abs().max().item() / w[s].abs().max().item()
                    for g, w in zip(got, want)
                    for s in (slice(b * bb, (b + 1) * bb) for b in range(B // bb)))
        print(f"{name} one step a block at B={B} H={H} bb={bb}: largest relative error "
              f"{worst:.2e} (limit {EXP_STEP_TOL})")
        require(worst <= EXP_STEP_TOL, f"{name}: one step {worst} past {EXP_STEP_TOL}")

    # the interleave at (H, B) = (512, 1024) beside its plain version
    args = ilv.inputs(*EXP_ILV, dev)
    got = ex.lstm_interleave_train_fwd(*args)
    plain = ex.lstm_interleave_train_fwd_plain(*args)
    rel = max(ilv.rel_frob(g, p) for g, p in zip(got, plain))
    require(rel <= 1e-3, f"the interleave is {rel} from its plain version")
    Hi, Bi = EXP_ILV
    T, H4 = 16, 4 * Hi
    out["interleave"] = {
        "max_abs_err": max((g.float() - p.float()).abs().max().item() for g, p in zip(got, plain)),
        "ms": queued_ms(lambda: ex.lstm_interleave_train_fwd(*args)),
        "event_ms": time_ms(lambda: ex.lstm_interleave_train_fwd(*args), 20),
        "plain_ms": time_ms(lambda: ex.lstm_interleave_train_fwd_plain(*args), 3),
        "device_ms": _first(device_ms_per_call(lambda: ex.lstm_interleave_train_fwd(*args), 3,
                                               "interleave_kernel", launches=1)),
        "baseline_ms": ilv_row.get("baseline_ms"), "rel_frob": rel}
    out["interleave"]["bound_ms"], out["interleave"]["bound_by"] = roofline_ms(
        Bi * T * Hi * H4, 2 * T * Bi * H4 * 2 + 2 * Hi * H4 + 8 * Bi * Hi + 8 * T * Bi * Hi,
        PEAK_BF16_FLOPS)
    out["interleave"]["library_ms"] = None
    print(f"interleave at (H, B)={EXP_ILV}: {out['interleave']}")

    # the mini walk, every case, at the tool's MINI shape; min_all timed
    Tm, Bm, Hm, INm = (ladder.MINI[k] for k in ("T", "B", "H", "IN"))
    rng = np.random.default_rng(0)
    b16 = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32)).to(dev).bfloat16()
    z, h, x = b16(Tm, Bm, 4 * Hm), b16(Tm, Bm, Hm), b16(Tm, Bm, INm)
    worst = 0.0
    for case in ex.MINI_CASES:
        got, want = ex.mini_walk(case, z, h, x), ex.mini_walk_plain(case, z, h, x)
        for i, (g, w) in enumerate(zip(got, want)):
            if w is None:
                continue
            for gs, ws in (zip(g, w) if i == 0 else [(g, w)]):
                e = (gs.float() - ws.float()).abs().max().item()
                require(e <= (1e-2 if i == 0 else 1e-4) * ws.float().abs().max().item(),
                        f"mini walk {case}: output {i} off by {e}")
                worst = max(worst, e / ws.float().abs().max().item())
    call = lambda: ex.mini_walk("min_all", z, h, x)  # noqa: E731
    H4m = 4 * Hm
    rd = Tm * Bm
    out["mini_walk"] = {
        "max_abs_err": max((g.float() - w.float()).abs().max().item()
                           for g, w in zip(call(), ex.mini_walk_plain("min_all", z, h, x))),
        "max_rel_err": worst, "ms": queued_ms(call), "event_ms": time_ms(call, 20),
        "plain_ms": time_ms(lambda: ex.mini_walk_plain("min_all", z, h, x), 3),
        # the walk and its three sums (drk, dw, db)
        "device_ms": _first(device_ms_per_call(call, 3, "mini_", launches=4)),
        "library_ms": None}
    out["mini_walk"]["bound_ms"], out["mini_walk"]["bound_by"] = roofline_ms(
        rd * (Hm + INm) * H4m + rd * (2 * H4m + Hm + INm + H4m) / 2,
        2 * rd * (H4m + Hm + 2 * INm) + 4 * (Hm + INm + 1) * H4m)
    print(f"mini walk (min_all at T={Tm} B={Bm} H={Hm} IN={INm}): {out['mini_walk']}")
    print(f"phase 40: {time.perf_counter() - t0:.1f} s")
    return [{"name": f"exp_{name}", "route": "cuda",
             "source": "classifying_vae_lstm_tpu_torch/csrc/exp_lstm.cu",
             "replaces": f"tools/{EXP_REPLACES[name]}", "launches": counts[name],
             **{k: v for k, v in out[name].items()
                if k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}}
            for name in ex.KERNELS]


NEEDS = {7: (6,), 9: (6,), 10: (9,), 13: (12,), 16: (15,), 22: (10, 21), 25: (24,), 28: (9,),
         38: (21, 27)}
N_PHASES = 40


def phase_two_cell_auto(model_dir, xla_loss):
    """The ``--two_cell auto`` route of fresh bf16 training at H=1,024 and
    H=2,048: 1 epoch each of ``cli.cl_vrnn_train --lstm_backend pallas``
    with ``bf16_compute`` (set on the namespace, as the JAX package's
    ``--lstm_backend auto`` sets it) and no ``--two_cell`` flag, phases 21's
    and 27's flags otherwise. ``xla_loss`` maps H to the first-epoch train
    loss of the ``xla`` epoch those phases ran from the same seed. Returns
    the bf16 two-cell forward and backward launches."""
    from classifying_vae_lstm_tpu_torch.ops import lstm_seq as ls
    from classifying_vae_lstm_tpu_torch.ops import two_cell as tc
    from classifying_vae_lstm_tpu_torch.train.checkpoint import load_model_args

    plain_on_cuda, fwd, bwd = [], 0, 0
    for H, flags in ((BF16_H, BF16_FLAGS), (H2048_H, H2048_FLAGS)):
        i = flags.index("--two_cell")
        base = flags[:i] + flags[i + 2:]  # the flag left at its default, auto
        with plain_guard(tc, TWO_CELL_PLAIN, plain_on_cuda), \
                plain_guard(ls, LSTM_SEQ_PLAIN, plain_on_cuda):
            args, counts, seen, epoch_s, wall = run_train(
                f"auto_h{H}", ["--num_epochs", "1", "--lstm_backend", "pallas"], model_dir,
                _reset_h512_counts, _h512_counts, base_flags=base,
                overrides={"bf16_compute": True})
        label = f"bf16 H={H} --two_cell auto"
        E, n_train, n_val = _report_train(label, args, seen, epoch_s, wall)
        expected = {**lstm_expected(), "BF16_TWO_CELL_FWD": E * (n_train + n_val),
                    "BF16_TWO_CELL_BWD": 2 * E * n_train}
        margs = load_model_args(seen["ckpt"])
        loss_k, loss_x = seen["history"]["loss"][0], xla_loss[H]
        rel = abs(loss_k - loss_x) / abs(loss_x)
        print(f"{label}: args.json two_cell {margs.get('two_cell')!r}, fusion "
              f"{margs.get('fusion')}; launches {nonzero(counts)} (expected {nonzero(expected)}, "
              f"every other count 0: no whole-sequence LSTM kernel); first epoch train loss "
              f"{loss_k!r} against xla {loss_x!r} (phase {21 if H == BF16_H else 27}), relative "
              f"difference {rel:.3e} (limit 1e-2); ms per step "
              f"{epoch_s[0] * 1e3 / n_train:.3f}")
        require(margs.get("two_cell") is True and margs.get("bf16_compute") is True,
                f"{label}: args.json {margs}")
        require(counts == expected, f"{label}: launches {counts} != {expected}")
        require(rel <= 1e-2, f"{label}: first-epoch losses differ by {rel}")
        fwd += counts["BF16_TWO_CELL_FWD"]
        bwd += counts["BF16_TWO_CELL_BWD"]
    require(not plain_on_cuda, f"plain versions ran on CUDA tensors: {plain_on_cuda}")
    return fwd, bwd


CONVERGED_EPOCHS = 7  # the least run that writes a best-epoch checkpoint


def phase_converged_tool(work_dir):
    """``tools/torch_converged_parity.py`` for configs 3 and 5 at
    ``--epochs 7``, pallas route, seed 0, through its ``run`` (which checks
    its kernels' launches, the NLLs, the songs and the plain versions);
    returns each config's entry."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools"))
    import torch_converged_parity as tcp

    entries = {}
    for config in ("5", "3"):
        out = os.path.join(work_dir, f"c{config}")
        e = tcp.run(config, 0, "pallas", CONVERGED_EPOCHS, "cuda", work_dir=out)
        ckpt = os.path.join(out, tcp.RECIPES[config][1] + ".npz")
        files = sorted(os.listdir(os.path.join(out, "samples")))
        print(f"converged-parity tool, config {config} ({CONVERGED_EPOCHS} epochs): checkpoint "
              f"of epoch {e['checkpoint_epoch']} ({os.path.getsize(ckpt)} bytes), NLLs "
              f"{e['eval_nlls']} (mean {e['nll']:.4f}), s per epoch {e['s_per_epoch_median']:.3f}, "
              f"wall {e['wall_s']:.1f} s; launches {e['launches']}; songs "
              f"{[(k, [s['notes'] for s in v['songs']]) for k, v in e['samples'].items()]}; "
              f"files {files}")
        wavs = [f for f in files if f.endswith(".wav")]
        require(e["checkpoint_epoch"] == CONVERGED_EPOCHS, f"config {config}: no checkpoint")
        require(len(wavs) == (6 if config == "5" else 0), f"config {config}: WAV files {wavs}")
        entries[config] = e
    return entries


def selected_phases(spec):
    """The phases to run: every one for ``None``, else the comma-separated
    numbers in ``spec``, phase 1 (the build) and what they read from."""
    if spec is None:
        return set(range(1, N_PHASES + 1))
    run = {1} | {int(n) for n in spec.split(",") if n.strip()}
    require(run <= set(range(1, N_PHASES + 1)), f"phases are 1 .. {N_PHASES}, got {spec}")
    while True:
        more = {d for n in run for d in NEEDS.get(n, ())} - run
        if not more:
            return run
        run |= more


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=None,
                    help="comma-separated phase numbers to run (with phase 1 and the phases "
                         "they read from); only a run of every phase, the default, prints the "
                         "kernel table and the result line")
    run = selected_phases(ap.parse_args(argv).phases)
    want = run.__contains__
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs a CUDA card",
              file=sys.stderr)
        return 1
    import classifying_vae_lstm_tpu_torch  # noqa: F401 — fails without the checkout

    t_start = time.perf_counter()
    t_last = [t_start]

    def took(*phases):  # the wall time since the last phase ended
        now = time.perf_counter()
        print(f"chip_smoke: phase {', '.join(map(str, phases))} took {now - t_last[0]:.1f} s")
        t_last[0] = now

    line = gpu_line()
    print(f"card: {line}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    dev = torch.device("cuda", 0)
    phase_build()
    phase_tensor_cores()
    took(1)
    if want(2):
        f32 = phase_f32(dev)
        took(2)
    if want(3):
        phase_bf16(dev)
        took(3)
    if want(4):
        launches = phase_serve()
        took(4)
    if want(5):
        fwd, bwd = phase_two_cell(dev)
        took(5)
    if want(8):
        lstm = phase_lstm_seq(dev)
        took(8)
    if want(6):
        with tempfile.TemporaryDirectory() as model_dir:
            fwd_launches, bwd_launches, seen = phase_train(model_dir)
            phase_train_breakdown(seen)
            took(6)
            if want(7):
                phase_checkpoint_serves(seen["ckpt"])
                took(7)
            if want(9):
                train_fwd_launches, lstm_bwd_launches, seen_off = phase_train_two_loop(
                    model_dir, seen["history"]["loss"][0])
                phase_train_breakdown(seen_off, "LSTM kernels", "lstm_")
                took(9)
            if want(10):
                eval_launches, nll_f32 = phase_evaluate(seen_off["ckpt"])
                took(10)
    if want(11):
        vae = phase_vae(dev)
        took(11)
    if want(12):
        vae_launches = phase_vae_serve()
        took(12)
    if want(13):
        with tempfile.TemporaryDirectory() as sample_dir:
            vae_launches += phase_sample_clis(sample_dir)
            took(13)
    if want(14):
        dense = phase_vae_dense(dev)
        took(14)
    if want(15):
        with tempfile.TemporaryDirectory() as model_dir:
            dense_fwd, dense_bwd, seen_vae = phase_vae_train(model_dir)
            phase_train_breakdown(seen_vae, "dense-stack kernels", "vae_dense")
            took(15)
            if want(16):
                with tempfile.TemporaryDirectory() as sample_dir:
                    phase_vae_evaluate(seen_vae["ckpt"], sample_dir)
                    took(16)
    if want(17):
        coop_row, h512_row, no_hidden_row, wide_row = phase_vae_wide(dev)
        took(17)
    if want(18):
        dense16 = phase_vae_dense_bf16(dev)
        took(18)
    if want(19):
        with (tempfile.TemporaryDirectory() as model_dir,
              tempfile.TemporaryDirectory() as sample_dir):
            bf16_fwd, bf16_bwd, seen_seq = phase_vae_bf16_train(model_dir)
            phase_train_breakdown(seen_seq, "dense-stack kernels", "vae_", VAE_STEP_PARTS)
            phase_vae_bf16_evaluate(seen_seq["ckpt"])
            h512_launches, no_hidden_launches, wide_launches = phase_vae_repair(model_dir,
                                                                                sample_dir)
            took(19)
    if want(20):
        lstm16 = phase_lstm_seq_bf16(dev)
        took(20)
    if want(21):
        with (tempfile.TemporaryDirectory() as model_dir,
              tempfile.TemporaryDirectory() as sample_dir):
            bf16_train_fwd, bf16_bwd_launches, seen_h = phase_train_bf16(model_dir)
            phase_train_breakdown(seen_h, "LSTM kernels", "lstm_seq")
            took(21)
            if want(22):
                bf16_eval = phase_evaluate_bf16(seen_h["ckpt"], sample_dir, nll_f32)
                took(22)
    if want(23):
        tc16 = phase_two_cell_bf16(dev)
        took(23)
    if want(24):
        with (tempfile.TemporaryDirectory() as model_dir,
              tempfile.TemporaryDirectory() as sample_dir):
            tc16_fwd, tc16_bwd, seen_tc = phase_train_two_cell_bf16(model_dir)
            phase_train_breakdown(seen_tc, "two-cell kernels", "two_cell")
            took(24)
            if want(25):
                phase_evaluate_two_cell_bf16(seen_tc["ckpt"], sample_dir)
                took(25)
    if want(26):
        rungs = phase_lstm_rungs(dev)
        took(26)
    if want(27):
        with (tempfile.TemporaryDirectory() as model_dir,
              tempfile.TemporaryDirectory() as sample_dir):
            walk16_launches, _, seen_w = phase_train_h2048(model_dir)
            phase_train_breakdown(seen_w, "LSTM kernels", "lstm_seq")
            phase_evaluate_h2048(last_checkpoint(seen_w["ckpt"]), sample_dir)
            took(27)
    if want(28):
        with tempfile.TemporaryDirectory() as model_dir:
            other = phase_other_rungs(model_dir, seen_off["history"]["loss"][0])
            took(28)
    t29 = time.perf_counter()
    if want(29):
        int8_vrnn, int8_vae = phase_int8_kernels(dev)
        took(29)
    if want(30):
        with (tempfile.TemporaryDirectory() as model_dir,
              tempfile.TemporaryDirectory() as sample_dir):
            int8_vrnn_launches, int8_vae_launches, coop_auto = phase_int8_paths(model_dir,
                                                                                sample_dir)
            took(30)
    if want(29) and want(30):
        print(f"phases 29-30 (int8 kernels and paths): {time.perf_counter() - t29:.1f} s")
    if want(31):
        phase_lstm_bf16_sweep(dev)
        took(31)
    if want(32):
        kc_launches, kc_eval_launches = phase_key_consistency(dev)
        took(32)
    if want(33):
        with tempfile.TemporaryDirectory() as model_dir:
            flags_fwd, flags_bwd = phase_train_flags(model_dir)
            took(33)
    if want(34):
        groups_row, vae_wide16_row = phase_wide_sampling(dev)
        took(34)
    if want(35):
        with tempfile.TemporaryDirectory() as model_dir:
            dp_fwd, dp_bwd, dp_dense_fwd, dp_dense_bwd = phase_dp_train(model_dir)
            took(35)
    if want(36):
        dp_gen, dp_vae, dp_eval = phase_dp_sharded(dev)
        took(36)
    if want(37):
        (tp_fwd, tp_bwd, tp16_fwd, tp16_bwd, tp_eval, tp_dense_fwd, tp_dense_bwd,
         tp_gen) = phase_tensor_parallel(dev)
        took(37)
    if want(38):
        with tempfile.TemporaryDirectory() as model_dir:
            auto_fwd, auto_bwd = phase_two_cell_auto(
                model_dir, {BF16_H: seen_h["xla_loss"], H2048_H: seen_w["xla_loss"]})
            took(38)
    if want(39):
        with tempfile.TemporaryDirectory() as work_dir:
            conv = phase_converged_tool(work_dir)
            took(39)
    if want(40):
        exp_rows = phase_exp_probes(dev)
        took(40)
    if len(run) < N_PHASES:
        print(f"chip_smoke: phases {', '.join(map(str, sorted(run)))} passed in "
              f"{time.perf_counter() - t_start:.1f} s")
        return 0
    # the converged-parity tool's launches on its paths (phase 39)
    tool = lambda config, stage, count: conv[config]["launches"][stage].get(count, 0)  # noqa: E731
    source = "classifying_vae_lstm_tpu_torch/csrc/two_cell.cu"
    two_cell_bwd_source = "classifying_vae_lstm_tpu_torch/csrc/two_cell_tc.cu"
    lstm_source = "classifying_vae_lstm_tpu_torch/csrc/lstm_seq.cu"
    tc_source = "classifying_vae_lstm_tpu_torch/csrc/lstm_seq_tc.cu"
    pallas_lstm = "classifying_vae_lstm_tpu/ops/pallas_lstm.py"
    dense_source = "classifying_vae_lstm_tpu_torch/csrc/vae_dense.cu"
    lstm_bwd_source = "classifying_vae_lstm_tpu_torch/csrc/lstm_bwd_f32.cu"
    dense_tc_source = "classifying_vae_lstm_tpu_torch/csrc/vae_dense_tc.cu"
    kernels = [{
        "name": "generate_cl_vrnn", "route": "cuda",
        "source": "classifying_vae_lstm_tpu_torch/csrc/generate_cl_vrnn.cu",
        "replaces": "classifying_vae_lstm_tpu/ops/pallas_generate.py:153",
        "launches": launches + kc_launches + dp_gen + tp_gen
        + tool("5", "sample", "cuda_generate.LAUNCHES"), **f32, "library_ms": None,
    }, {
        # the same kernel past 20 units a block (phase 34: blocks of two unit
        # groups; bf16 at H=4,096)
        "name": "generate_cl_vrnn_unit_groups", "route": "cuda",
        "source": "classifying_vae_lstm_tpu_torch/csrc/generate_cl_vrnn.cu",
        "replaces": "classifying_vae_lstm_tpu/ops/pallas_generate.py:153", **groups_row,
        "library_ms": None,
    }, {
        "name": "two_cell_fwd", "route": "cuda", "source": source,
        "replaces": "classifying_vae_lstm_tpu/ops/pallas_two_cell.py:129",
        "launches": fwd_launches + flags_fwd + dp_fwd + tp_fwd
        + tool("5", "train", "two_cell.FWD_LAUNCHES"), **fwd, "library_ms": None,
    }, {
        "name": "two_cell_bwd", "route": "cuda", "source": two_cell_bwd_source,
        "replaces": "classifying_vae_lstm_tpu/ops/pallas_two_cell.py:295",
        "launches": bwd_launches + flags_bwd + dp_bwd + tp_bwd
        + tool("5", "train", "two_cell.BWD_LAUNCHES"), **bwd, "library_ms": None,
    }, {
        "name": "lstm_seq_fwd", "route": "cuda", "source": lstm_source,
        "replaces": f"{pallas_lstm}:632",
        "launches": eval_launches + kc_eval_launches + dp_eval + tp_eval
        + tool("5", "evaluate", "lstm_seq.FWD_LAUNCHES"),
        **lstm["fwd"], "library_ms": None,
    }, {
        "name": "lstm_seq_train_fwd", "route": "cuda", "source": lstm_source,
        "replaces": f"{pallas_lstm}:730", "launches": train_fwd_launches, **lstm["train_fwd"],
        "library_ms": None,
    }, {
        "name": "lstm_seq_bwd", "route": "cuda", "source": lstm_bwd_source,
        "replaces": f"{pallas_lstm}:986", "launches": lstm_bwd_launches, **lstm["bwd"],
        "library_ms": None,
    }, {
        "name": "generate_cl_vae", "route": "cuda",
        "source": "classifying_vae_lstm_tpu_torch/csrc/generate_cl_vae.cu",
        "replaces": "classifying_vae_lstm_tpu/ops/pallas_generate_vae.py:141",
        "launches": vae_launches + dp_vae + tool("3", "sample", "cuda_generate_vae.LAUNCHES"),
        **vae, "library_ms": None,
    }, {
        "name": "vae_dense_fwd", "route": "cuda", "source": dense_source,
        "replaces": "classifying_vae_lstm_tpu/ops/pallas_vae.py:133",
        "launches": dense_fwd + dp_dense_fwd + tp_dense_fwd
        + tool("3", "train", "vae_dense.FWD_LAUNCHES"), **dense["fwd"], "library_ms": None,
    }, {
        "name": "vae_dense_bwd", "route": "cuda", "source": dense_source,
        "replaces": "classifying_vae_lstm_tpu/ops/pallas_vae.py:230",
        "launches": dense_bwd + dp_dense_bwd + tp_dense_bwd
        + tool("3", "train", "vae_dense.BWD_LAUNCHES"), **dense["bwd"], "library_ms": None,
    }, {
        # the same cluster kernel past one block (phase 19's bf16 H=512 model,
        # two blocks a cluster; times from phase 17 at its width)
        "name": "generate_cl_vae_cluster_wide", "route": "cuda",
        "source": "classifying_vae_lstm_tpu_torch/csrc/generate_cl_vae.cu",
        "replaces": "classifying_vae_lstm_tpu/ops/pallas_generate_vae.py:141",
        "launches": h512_launches, **h512_row, "library_ms": None,
    }, {
        # and without hidden layers (phase 19's model at D=88)
        "name": "generate_cl_vae_cluster_no_hidden", "route": "cuda",
        "source": "classifying_vae_lstm_tpu_torch/csrc/generate_cl_vae.cu",
        "replaces": "classifying_vae_lstm_tpu/ops/pallas_generate_vae.py:141",
        "launches": no_hidden_launches, **no_hidden_row, "library_ms": None,
    }, {
        # phase 19's seq-concat model without hidden layers (D=1,024, L=32),
        # times from phase 17 at its width
        "name": "generate_cl_vae_wide", "route": "cuda",
        "source": "classifying_vae_lstm_tpu_torch/csrc/generate_cl_vae.cu",
        "replaces": "classifying_vae_lstm_tpu/ops/pallas_generate_vae.py:141",
        "launches": wide_launches, **wide_row, "library_ms": None,
    }, {
        # its bf16 mode, past the cooperative kernel's latent width (phase 34)
        "name": "generate_cl_vae_wide_bf16", "route": "cuda",
        "source": "classifying_vae_lstm_tpu_torch/csrc/generate_cl_vae.cu",
        "replaces": "classifying_vae_lstm_tpu/ops/pallas_generate_vae.py:141", **vae_wide16_row,
        "library_ms": None,
    }, {
        "name": "generate_cl_vae_coop", "route": "cuda",
        "source": "classifying_vae_lstm_tpu_torch/csrc/generate_cl_vae.cu",
        "replaces": "classifying_vae_lstm_tpu/ops/pallas_generate_vae.py:141",
        "launches": coop_auto, **coop_row, "library_ms": None,
    }, {
        "name": "vae_tc_fwd", "route": "cuda", "source": dense_tc_source,
        "replaces": "classifying_vae_lstm_tpu/ops/pallas_vae.py:133", "launches": bf16_fwd,
        **dense16["fwd"], "library_ms": None,
    }, {
        "name": "vae_dense_bwd_bf16", "route": "cuda", "source": dense_tc_source,
        "replaces": "classifying_vae_lstm_tpu/ops/pallas_vae.py:230", "launches": bf16_bwd,
        **dense16["bwd"], "library_ms": None,
    }, {
        "name": "lstm_seq_fwd_bf16", "route": "cuda", "source": tc_source,
        "replaces": f"{pallas_lstm}:632", "launches": bf16_eval, **lstm16["fwd"],
        "library_ms": None,
    }, {
        "name": "lstm_seq_train_fwd_bf16", "route": "cuda", "source": tc_source,
        "replaces": f"{pallas_lstm}:730", "launches": bf16_train_fwd + tp16_fwd,
        **lstm16["train_fwd"],
        "library_ms": None,
    }, {
        "name": "lstm_seq_bwd_bf16", "route": "cuda", "source": tc_source,
        "replaces": f"{pallas_lstm}:986", "launches": bf16_bwd_launches + tp16_bwd,
        **lstm16["bwd"],
        "library_ms": None,
    }, {
        "name": "two_cell_fwd_bf16", "route": "cuda", "source": source,
        "replaces": "classifying_vae_lstm_tpu/ops/pallas_two_cell.py:129",
        "launches": tc16_fwd + auto_fwd, **tc16[0], "library_ms": None,
    }, {
        "name": "two_cell_bwd_bf16", "route": "cuda", "source": two_cell_bwd_source,
        "replaces": "classifying_vae_lstm_tpu/ops/pallas_two_cell.py:295",
        "launches": tc16_bwd + auto_bwd, **tc16[1], "library_ms": None,
    }]
    # the other rungs: launches on their paths (phase 28; the bf16 walk on the
    # H=2,048 main path, phase 27), times from phase 26
    replaced = {"xz_fwd": 216, "xz_train_fwd": 529, "walk": 810, "walk_drk": 920}
    counted = {"xz_fwd": "XZ_FWD", "xz_train_fwd": "XZ_TRAIN_FWD", "walk": "WALK",
               "walk_drk": "DRK"}
    for mode, sfx in (("f32", ""), ("bf16", "_bf16")):
        for kind in RUNG_KERNELS:
            launches = other[f"{'BF16_' if sfx else ''}{counted[kind]}"]
            if (mode, kind) == ("bf16", "walk"):
                launches = walk16_launches
            require(launches > 0, f"lstm_seq_{kind}{sfx} was not launched on its path")
            source = (tc_source if sfx
                      else lstm_bwd_source if kind in ("walk", "walk_drk") else lstm_source)
            kernels.append({"name": f"lstm_seq_{kind}{sfx}", "route": "cuda", "source": source,
                            "replaces": f"{pallas_lstm}:{replaced[kind]}",
                            "launches": launches, **rungs[mode][kind], "library_ms": None})
    for name, launches, row, src, replaced in (
            ("generate_cl_vrnn_int8", int8_vrnn_launches, int8_vrnn, "generate_cl_vrnn.cu",
             "pallas_generate.py:211"),
            ("generate_vae_int8", int8_vae_launches, int8_vae, "generate_cl_vae.cu",
             "pallas_generate_vae.py:192")):
        require(launches > 0, f"{name} was not launched on its path")
        kernels.append({"name": name, "route": "cuda",
                        "source": f"classifying_vae_lstm_tpu_torch/csrc/{src}",
                        "replaces": f"classifying_vae_lstm_tpu/ops/{replaced}",
                        "launches": launches,
                        **{k: v for k, v in row.items()
                           if k not in ("bf16_ms", "device_ms", "pack_ms")},
                        "library_ms": None})
    kernels += exp_rows  # the tools' probes (phase 40)
    # every thread this run started has ended (the servers' threads are
    # daemons and shut down), so the interpreter exits with main's code
    alive = [t.name for t in threading.enumerate()
             if t is not threading.main_thread() and not t.daemon]
    require(not alive, f"threads still running: {alive}")
    print(f"chip_smoke: all {N_PHASES} phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(line)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
