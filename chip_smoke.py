#!/usr/bin/env python
"""Smoke run of the PyTorch port (agcn_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

The quickest proof that the port builds, serves and trains on the card.
Phases, each of which fails the run (exit code 1, no result line) when it
fails:

1. environment: a CUDA GPU is required; prints its name and power limit.
2. build: compiles every CUDA source of the port with nvcc (sm_90a), all
   started together, and prints the build time and ptxas' report (for
   each gcn_fwd_fp32_kernel instantiation its registers, spills and
   dynamic shared memory, for each gcn_da1_fp32_kernel, each general
   kernel and each logits kernel its registers and spills); a spill in
   gcn_fwd_mma_kernel, gcn_fwd_fp32_kernel, gcn_da1_mma_kernel,
   gcn_da1_fp32_kernel, gcn_dw_fp32_kernel, gcn_u_kernel, the general
   gcn_fwd_gen_kernel, gcn_u_gen_kernel, gcn_da1_gen_kernel or any kernel
   of logits.cu fails it.
3. gcn_fwd against its plain version, on the card, at every AGCN layer
   shape of the served batch (16 streams x 2 persons = 32 samples), fp32
   and bf16, both aggregate-rounding modes, and as dx (gcn_fwd on g,
   a1^T, W^T) at the training batch (64 x 2 persons = 128 samples);
   prints max error, kernel / plain / library time and the roofline
   bound. At each served shape, on bf16 integer inputs where the two
   modes differ, each mode must match its own plain version and fail the
   other's; on small-integer inputs bf16 (the tensor cores) and fp32
   (gcn_fwd_fp32_kernel, the CUDA cores) equal their plain version bit
   for bit in both modes at every served shape and with round_agg=1 at
   every dx shape, and two calls are bitwise equal; the fp32 rows are
   printed layer by layer (served and dx). All of it at V = 25 (NTU),
   then again at V = 15 (the OpenPose skeleton). The code is
   agcn_tpu_torch/tools/fwd_check.py, which runs it alone in about a
   minute: `python -m agcn_tpu_torch.tools.fwd_check`.
4. gcn_bwd (dW, da1) at the training batch, fp32 and bf16: first the
   library's da1 tiling (frames of a tile, dynamic shared memory, blocks
   an SM holds: fewer than two fail it); then against its
   plain version at every layer shape, two calls bitwise equal, and on
   bf16 integer inputs equal to the plain version while dropping either
   rounding point changes the result; fp32 dW equal to its plain version
   bit for bit on integer inputs whose sums are exact in any order (the
   batch cut to keep them below 2^24), and fp32 da1 at the full batch (x,
   W and g in [-1, 1]). Prints kernel / plain / library (the einsum
   backward) time and the bound, dW and da1 apart (da1 is
   gcn_da1_mma_kernel on the tensor cores in bf16 and the CUDA-core
   gcn_da1_fp32_kernel in fp32, each over frame groups summed by
   gcn_da1_reduce_kernel; dW in both types is gcn_u_kernel, then
   gcn_dw_mma_kernel in bf16 or the CUDA-core GEMM gcn_dw_fp32_kernel in
   fp32), and the fp32 da1 rows layer by layer; at V = 25, then at V = 15
   (the tiling asked at V = 25, 18 and 15). The code
   is agcn_tpu_torch/tools/bwd_check.py, which runs it alone in about a
   minute: `python -m agcn_tpu_torch.tools.bwd_check`.
5. the attention-logits kernel against its plain version (the packed
   128 x 128 formulation) at the ten layer shapes of the served (32) and
   training (128) batches, fp32 (logits_fp32_kernel, the CUDA cores) and
   bf16 (logits_mma_kernel, the tensor cores), theta/phi as views of the
   fused embedding: 1e-5 of the output scale, two calls bitwise equal,
   and on integer inputs the sums equal to the plain version's bit for
   bit, each divided once; kernel / plain / library (the 'transposed'
   form's torch.matmul in fp32) time back to back, the kernel's device
   time alone (the calls queued ahead of the card) and the host's time a
   call, the bound and its share, and the launch plan; at V = 25, then at
   V = 15 (the kernel's general tile). The code is
   agcn_tpu_torch/tools/logits_check.py, which runs it
   alone in about a minute: `python -m agcn_tpu_torch.tools.logits_check`.
6. host data path: builds the C++ host kernels
   (agcn_tpu_torch/native/skelio.cpp) with g++ and prints the build time;
   runs pre_normalization on the batch of a served tick (16 streams,
   T=300, the two bodies selected) in C++ and in numpy (`native_ok=False`),
   holds the two within 1e-4 of the output scale and prints each one's
   median ms of 5 calls on the card's host; writes a seeded raw tree of
   `.skeleton` files and runs `python -m agcn_tpu_torch.data.gen ntu` and
   `streams` in subprocesses: the files' shapes and labels, one C++ parse
   a file, the C++ parse equal to the Python one on every file, and the
   joint and bone files through the Feeder and one full-width pallas AGCN
   forward on the card (finite logits).
7. AGCN serving main path: the NTU-60 AGCN of configs/ntu60_xview/
   test_joint.yaml with `formulation: pallas`, full width, T=300, seeded
   random weights, serving 16 live streams through BatchedStreamServer
   (predict, then predict_async + flush) in fp32 and bf16, and one tick
   with `use_pallas=True` (gcn_kernel's `fused_gcn`, the fp32 aggregate)
   in each of fp32 and bf16; the kernels' launch counts must equal layers
   x forwards for each dtype; the card's logits, those of the bf16
   `use_pallas` tick too, are held against the same model and weights run
   with device="cpu" (the plain versions); every batched tick must run
   pre_normalization in C++ (one call a tick), and the mean host prep is
   printed beside phase 6's numpy figure.
8. AGCN: device time of one served forward by kernel group
   (torch.profiler); the serving CLI `python -m agcn_tpu_torch.infer
   --serve 16 --pipeline` on recordings written to a temporary directory.
9. AGCN training main path, configs/ntu60_xview/train_joint.yaml with
   `formulation: pallas`, full width, T=300: one step at batch 4 on the
   card against the same step with the kernels' plain versions on the
   card and against device="cpu" (fp32, TF32 off, the card replaying
   the CPU's ReLU masks: every gradient 1e-3 of its scale, loss 1e-4
   relative; bf16 loss 5e-2); 10 bf16 steps
   at batch 64 on one repeated batch, whose loss must fall, with exactly
   20 gcn_fwd and 10 gcn_bwd launches per step; ms per step, seq/s and
   peak memory of pallas, pallas_hybrid and agg_packed, and the device
   time of one pallas step by kernel group, in which bf16 da1 must run
   gcn_da1_mma_kernel (the tensor cores) and not the fp32
   gcn_da1_fp32_kernel; the same for pallas and agg_packed in fp32 (TF32
   off; 1 warm-up, 3 timed steps), one fp32 pallas step profiled, in
   which dW must run gcn_u_kernel and gcn_dw_fp32_kernel, da1
   gcn_da1_fp32_kernel and gcn_da1_reduce_kernel (neither the removed
   gcn_da1_kernel nor gcn_da1_mma_kernel), and the forward and dx
   gcn_fwd_fp32_kernel alone; then the entry point
   `python -m agcn_tpu_torch.main` in subprocesses on synthetic data in a
   temporary directory: train and evaluate one epoch at batch 64, save,
   resume for a second epoch, and `--phase test` on the last checkpoint,
   which must reproduce the run's last top-1.
10. AAGCN serving main path: configs/ntu60_xview/test_joint_aagcn.yaml
   (10 blocks, STC attention, adaptive) with `formulation` and
   `eval_formulation: pallas` (AAGCN serves on 'agg' otherwise), seeded
   weights with a live attention branch and BN statistics from a
   train-mode forward, 16 streams in fp32 and bf16: 10 gcn_fwd launches
   per forward, card against CPU and C++ pre_normalization as in 7.
   Then the attention-logits kernel's entry point on the theta/phi each
   layer of a served forward produced (fp32 and bf16), against
   ops.gcn.attention_logits 'transposed' in fp32 at 1e-5 of the scale: 10
   launches per forward.
11. AAGCN: device time of one served forward by kernel group; the
   serving CLI on the AAGCN config.
12. AAGCN training main path, train_joint_aagcn.yaml, as 9: the card
   step against the CPU with the attention branch live, 10 bf16 steps at
   batch 64 (20 gcn_fwd + 10 gcn_bwd launches each), the three
   formulations' speed, and the entry point: train and evaluate one
   epoch, then `--phase test`.
13. The AAGCN-transformer recipe (full width: model_layers 103, the
   64-channel backbone, 'dual' with cross_fusion, 3 layers of 8 heads,
   FF 512, T=300), whose path runs none of the port's kernels, as in the
   JAX package: every kernel's launch count must stay 0 over its serving
   and training. Serving test_joint_aagcn_transformer.yaml to 16 streams
   in bf16 and fp32 (TF32 off), BN statistics from a train-mode forward,
   card against CPU as in 7 (fp32 1e-3, bf16 5e-2 of the logit scale),
   one C++ pre_normalize a tick, tick ms and preds/s sync and pipelined,
   and the device time of one served forward by kernel group; training
   train_joint_aagcn_transformer.yaml (AdamW, onecycle, bf16): one fp32
   step at batch 4 with dropout 0 against the CPU (loss 1e-4 relative,
   every gradient 1e-3 of its scale, the ReLU masks replayed), one
   AdamW-LLRD step (factor 0.8) on the card and on the CPU from the same
   gradients, 10 bf16 steps at batch 64 at the recipe's dropout on one
   repeated batch (the loss must fall), ms per step, seq/s and peak
   memory in bf16 and fp32 and one bf16 step's device time by kernel
   group; then `python -m agcn_tpu_torch.main` trains and evaluates one
   epoch, `--phase test` reproduces its top-1, and `python -m
   agcn_tpu_torch.infer --serve 16` serves that checkpoint.
14. The SGN recipe (configs/ntu60_xview/train_sgn.yaml at full width: V =
   25, seg 20, 60 classes, sgcn_dims (128, 256, 256), c4 512), whose path
   runs none of the port's kernels, as in the JAX package: every kernel's
   launch count must stay 0. Seeded synthetic SGN pickles (train, val and
   test splits of (N, T <= 300, 150) with one-person and all-zero frames)
   in a temporary directory: the C++ `flatten_persons` must be built and
   equal the numpy loop on every sequence, and the collate runs it (host
   ms of one training collate of 64 rows and one test collate of 4 x 5
   crops); card against CPU with every unit's w1 random and the BN
   statistics of a train-mode forward: eval logits in fp32 within 1e-3 of
   the logit scale, one fp32 step at dropout 0 (loss 1e-4 relative, every
   gradient 1e-3 of its scale, the CPU's ReLU masks and max selections
   replayed); 10 Adam steps at the recipe's dropout2d on one repeated
   batch of 64 (the loss must fall), ms per step, seq/s, peak memory and
   one step's device time by kernel group, the ms of one 4 x 5-crop eval
   batch; `python -m agcn_tpu_torch.main` trains one epoch of a copy of
   train_sgn.yaml on the pickles and evaluates with multi_test 5, and
   `--phase test` with a test_sgn.yaml-shaped config on its checkpoint
   reproduces its top-1; one full-width forward of the Kinetics shape
   (V = 18, 400 classes) is finite.
15. The trainer's run knobs. (a) One fp32 SAM step (rho 0.05) of
   train_joint.yaml's AGCN at full width, `formulation: pallas`, batch 4,
   T=300, with the kernels against the same step with their plain
   versions (the plain run's ReLU masks replayed, as in 9): every
   gradient the update takes within 1e-3 of its scale, 40 gcn_fwd and 20
   gcn_bwd launches, and the BN running statistics those of pass one
   alone; SAM against SGD at batch 64 in bf16 (ms a step, peak memory,
   one SAM step's device time), and the host ms of a checkpoint (sync and
   async) and of an event scalar. (b) `python -m agcn_tpu_torch.main` on
   train_joint.yaml with `formulation: pallas`, `optimizer: SAM`,
   `profiler` and `async_checkpoint`, 8 steps an epoch (batch 8 of
   synthetic T=300 sequences), then the same work dir with `auto_resume`
   for a second epoch (the profiler off): 40 gcn_fwd and 20 gcn_bwd
   launches a step (metrics.jsonl), a Chrome trace of steps 2-7 in
   work_dir/trace naming gcn_fwd's and gcn_bwd's kernels, TensorBoard
   event files that parse (CRCs checked by the reader here: the card's
   machine has no TensorBoard) and carry the log's scalars, and the
   resumed run continuing at epoch 1 from the checkpoint's step 8. (c)
   train_sgn_fsim_sam.yaml and train_sgn_scan8.yaml as shipped through
   the entry point on synthetic SGN pickles (512 + 64 training
   sequences: 9 steps at batch 64), two epochs each: a finite fsim, and
   the scan8 epoch equal to one with steps_per_call 1 within 1e-5; ms a
   step of each, with the card's name and power limit.
16. BN folding, the apply_gcn forms and the AAGCN versions, whose paths
   but (a)'s run none of the port's kernels, as in the JAX package. (a)
   test_joint.yaml's AGCN and test_joint_aagcn.yaml's AAGCN with
   `formulation: pallas` (AAGCN also `eval_formulation`), BN statistics
   from a train-mode forward, folded by utils/bn_fold.py: one served
   forward of each in fp32 (TF32 off) and bf16 at 16 streams x 2 persons,
   T=300, with 10 gcn_fwd launches a forward, and the logits kernel's
   entry point on each folded AAGCN forward's theta/phi (10 a forward);
   folded logits against unfolded (fp32 2e-4 of the logit scale, bf16
   5e-2), the card's folded logits against the CPU's (fp32 1e-3, bf16
   5e-2); device time by kernel group and kernels launched, folded
   beside unfolded. (b) apply_gcn's pf, custom, pf_packed, agg_packed2,
   agg_dp, fused_dyn and hybrid against 'agg' at AGCN l5's and l2's
   served shapes (fp32, 1e-5 of the output scale; custom's gradients
   against autograd of 'agg', 1e-4 of each tensor's scale), each form's
   ms. (c) train_joint_aagcn_v31.yaml at full width, T=60 (the recipe's
   random_subsample), seeded weights: eval logits at batch 64 against the
   CPU (fp32 1e-3, bf16 5e-2), one SGD-nesterov step at batch 4 with
   dropout 0 against the CPU (loss 1e-4 relative, every gradient 1e-3 of
   its scale, the CPU's ReLU masks replayed), 10 bf16 steps at batch 64
   whose loss must fall, ms a step, seq/s and peak memory in bf16 and
   fp32 and one bf16 step's device time by kernel group; at a cut depth
   (one encoder layer of three) `python -m agcn_tpu_torch.main` trains one
   epoch of one step, `--phase test` with test_joint_aagcn_v31.yaml (in
   this process) reproduces its top-1, and `python -m
   agcn_tpu_torch.infer --serve 16 --max-frame 60` serves the
   checkpoint; no kernel launched. (d) v17, v24, v30 (both GCN units),
   v32 and v34, one forward each at batch 2 against the CPU (fp32 1e-3).
17. SGN's v11-v13 options, the MMD loss and sgn_original (full width: V
   = 25, seg 20, 60 classes, c4 512), whose paths run none of the port's
   kernels, as in the JAX package: every kernel's launch count must stay
   0. On phase 14's synthetic pickles: (a) train_sgn_v11.yaml,
   train_sgn_v12.yaml (the InfoGCN head), train_sgn_v13_gt4.yaml and
   sgn_original, every unit's w1 random and the BN statistics of a
   train-mode forward: eval logits of a 4 x 5-crop batch, card against
   CPU in fp32, within 1e-3 of the logit scale; (b) one fp32 v12 step at
   batch 4 with dropout 0 (label smoothing, the MMD loss, Adam), card
   against CPU, the card replaying the CPU's ReLU masks, max selections
   and the head's eps: loss and the six MMD metrics 1e-4 relative (the
   cosines 1e-4 of 1), every gradient 1e-3 of its scale; (c) 10 Adam
   steps of v12 at its batch of 128 and of v13_gt4 at 64 on one repeated
   batch (the loss must fall), ms per step, seq/s, peak memory, one
   step's device time by kernel group and its busy share; (d) `python -m
   agcn_tpu_torch.main` trains one epoch of a copy of train_sgn_v12.yaml
   and evaluates with multi_test 5 (metrics.jsonl's train and eval lines
   carry mmd, l2_z_mean, cos_z, dist_z, cos_z_prior and dist_z_prior),
   and `--phase test` on its checkpoint reproduces its top-1.
18. SGN's transformer (train_sgn_transformer.yaml: torch-style encoders;
   train_sgn_v15.yaml: the lucid encoder; full width: V = 25, seg 20, 60
   classes) and SGN serving, whose paths run none of the port's kernels,
   as in the JAX package: every kernel's launch count must stay 0. On
   phase 14's synthetic pickles: (a) both recipes' models with the BN
   statistics of a train-mode forward: eval logits of a 4 x 5-crop batch,
   card against CPU in fp32, within 1e-3 of the logit scale; (b) one fp32
   v15 step at batch 4 with dropout 0 (label smoothing 0.1, Adam), card
   against CPU, the card replaying the CPU's ReLU masks and max
   selections: loss 1e-4 relative, every gradient 1e-3 of its scale; (c)
   10 Adam steps of each recipe at batch 64 on one repeated batch (the
   loss must fall), ms per step, seq/s, peak memory, one step's device
   time by kernel group and its busy share; (d) `python -m
   agcn_tpu_torch.main` trains one epoch (one step) of a copy of
   train_sgn_transformer.yaml at a cut depth (one temporal encoder layer
   of two) and evaluates with multi_test 5, `--phase
   test` with test_sgn_transformer.yaml reproduces its top-1, and `python
   -m agcn_tpu_torch.infer --serve 16` serves the checkpoint; (e) the SGN
   tick, 16 streams x 5 crops (80 rows), for train_sgn.yaml's `sgn` and
   for test_sgn_transformer.yaml's model: tick ms sync and pipelined,
   preds/s, host prep and h2d ms, one C++ pre_normalize a stream and
   tick, and the card's answers those of the CPU on the same recordings.
19. SGN raw generation and SGN's temporal-branch options, whose paths run
   none of the port's kernels, as in the JAX package: every kernel's
   launch count must stay 0. (a) A seeded synthetic NTU raw tree (48
   .skeleton files of one to four bodies with their own IDs, empty
   frames, short, wide, returning and tied bodies, and the five
   statistics tables; one listed sample missing), then `python -m
   agcn_tpu_torch.data.gen sgn-raw --evaluations CS CV` in a subprocess:
   its 12 pickles ((n, 300, 150) float32, 0-based labels, every kept
   sample once an evaluation), one C++ pre_normalize call, no sklearn,
   jax or agcn_tpu imported, ms a sample; then phase 14's entry-point
   check on its NTU_CV pickles at batch 8 (one epoch, 5-crop eval,
   `--phase test`). (b) train_sgn.yaml's SGN at full width with t_mode 2,
   3 (2 heads, one layer), 4 and 5, aspp_rates [1, 3, 5], gcn_fpn 8 with
   a branch on every level and t_maxpool_kwargs kernel [1, 2]: eval
   logits of a 4 x 5-crop batch card against CPU in fp32 within 2e-4
   (of the logit scale where it exceeds 1), one Adam step's median ms at
   batch 64, its device time by kernel group and busy share.
20. Data-parallel training (the card has one GPU, so one rank). (a)
   train_joint.yaml's AGCN at full width, `formulation: pallas`, bf16,
   batch 64, on synthetic data (2 batches, T = 64): one epoch through the
   entry point's `main` in this process, then with `world_size: 1` and
   `ddp: true` under `torchrun --standalone --nproc-per-node 1 -m
   agcn_tpu_torch.main` (an NCCL process group, DDP, SyncBN), and
   `--phase test` on its checkpoint under torchrun: its log names NCCL,
   its per-step losses are the plain run's within 5e-2 relative, 20
   gcn_fwd and 10 gcn_bwd launches a step, and `--phase test` reproduces
   its top-1; then in this process, on a one-rank NCCL group, the
   trainer's DDP step (T = 300) timed beside the plain step, its launches
   counted, and a torch.profiler window over two DDP steps, in which
   NCCL's kernels must run (count and device ms printed). (b) On that
   group, model_edge_gcn with its gradients, edge_partitioned_aggregate
   (an NCCL all-reduce) and SyncBN forward and backward, card against CPU
   in fp32 within 1e-5 of each output's scale.
21. The 15-joint OpenPose recipes through the GCN kernels at V = 15:
   configs/openpose_b25_j15_xview/train_joint.yaml (AGCN) and
   train_joint_aagcn.yaml (AAGCN: adaptive, attention, 10 blocks), full
   width, T = 300, `formulation: pallas` (AAGCN also `eval_formulation`),
   seeded weights and 15-joint synthetic data. (a) 16 streams served in
   fp32 and bf16 (10 gcn_fwd launches a forward, card against CPU as in
   7, one C++ pre_normalize a tick), the device time of one bf16 served
   forward by kernel group, and for AAGCN the logits kernel's entry point
   on each layer's theta/phi (10 launches a forward); (b) one step at
   batch 4 card against CPU as in 9 (a), 10 bf16 steps at batch 64 (20
   gcn_fwd and 10 gcn_bwd launches a step, the loss falling) and 5 more
   timed; (c) the entry point `main` in this process trains and evaluates
   one epoch of 2 steps (bf16, as shipped; its launches 20 + 10 a step),
   `--phase test` reproduces its top-1, and `python -m
   agcn_tpu_torch.infer --serve 16` serves the checkpoint.
22. The single-stream live demo. (a) `python -m agcn_tpu_torch.infer`
   without --serve, in its own process on the card, for test_joint.yaml's
   AGCN and test_joint_aagcn.yaml's AAGCN at full width with
   `formulation: pallas` (AAGCN also `eval_formulation`), seeded weights
   as phases 7 and 10 make them, on a directory of two seeded 300-frame
   recordings (V = 25, M = 2) with --interval 50 --timing --out-folder
   --max-frame 300 (the CLI computes in fp32, as the root infer.py does):
   a `== file` line a recording, 12 timed `frame` lines, results.txt's
   classes those of the CPU on the same inputs and its probabilities
   within 1e-3 of the logit scale; (b) 10 gcn_fwd (round_agg=1) launches
   a prediction in that process and no other kernel; the use_pallas AGCN
   (10 round_agg=0 launches a prediction) and train_sgn.yaml's SGN (no
   kernel) through the CLI's single-stream mode in this process; (c)
   ActionRecognition(expose_attention=True) on the card (fp32 and bf16;
   SGN fp32) against the CPU: the same graphs in length, order and
   shape, within 1e-3 / 5e-2 of their scale; (d) whether matplotlib is
   installed, and --save-attention's PNGs or its argument error naming
   matplotlib; (e) the median predict ms on the card after the first,
   with and without exposure.
23. The rest of SGN's GCN stack and head, whose paths run no port kernel,
   as in the JAX package. (a) argmax over the frames on the card takes
   the first frame of a tie (temporal_maxpool 2 embeds it; a ReLU leaves
   ties at 0), against numpy on a (64, 20, 1, 512) tensor of integers;
   (b) each case of STACK_CASES (gt modes 0, 5, 6; attn modes 1-3, 10;
   gcn_fpn 10 with every sgcn2 option; gcn_fpn_output_merge 2; the FFN
   variants 0xx-3xx, residuals, prenorm, g_weighted, the unit's and G's
   kernels; spatial pools 0, 3-5, temporal pools 0, 2-5) on
   train_sgn.yaml's SGN at full width, seg 20, fp32 with TF32 off: with
   every w1 random and the BN statistics of a train-mode forward, the
   card's eval logits of 4 samples x 5 crops within 2e-4 of the CPU
   port's; then Adam steps at batch 64: the median ms, the device ms by
   kernel group, the busy share and the parameter count; no port kernel
   launches; (c) gcn_fpn 10 with merge 2 through the entry point's
   `main` in this process: one epoch on phase 14's synthetic pickles,
   then `--phase test` on its checkpoint reproduces its top-1.
24. SGN's input side, whose paths run no port kernel, as in the JAX
   package. (a) each case of INPUT_CASES (semantic_jdiff,
   xem_projection, semantic_frame_location 1, semantic_joint_smp, the
   body-part segment embeddings alone and with jdiff) on train_sgn.yaml's
   SGN at full width, seg 20, fp32 with TF32 off, as phase 23 (b): card
   against CPU logits within 2e-4, Adam steps at batch 64 (median ms,
   device ms by kernel group, busy share, kernel count), no port kernel
   launches; (b) the host ms of a 64-row training collate and a 4 x
   5-crop test collate under `midvel_sampler: 1` (the k-means segment
   split, numpy only), beside the equal split's, and every sequence's
   bounds well formed; (c) the segment embeddings with `midvel_sampler:
   1` through the entry point's `main` in this process: one epoch on
   phase 14's synthetic pickles, then `--phase test` on its checkpoint
   reproduces its top-1.
25. the GCN kernels at any joint count (the general kernels,
   `gcn_fwd_gen_kernel`, `gcn_u_gen_kernel`, `gcn_da1_gen_kernel`, every
   V outside the tuned 15, 18 and 25): (a) each against its plain
   version at V = 1, 7, 16, 31, 32, 33 and 67 on small shapes (forward in
   both round_agg modes and all three type combinations, dx, dW, da1;
   integer inputs bit for bit, two calls bitwise equal), then at V = 31
   and 67 the served and training layer shapes as phases 3 and 4 (kernel,
   plain and einsum ms beside the bound), and the logits kernel at V =
   31 as phase 5; (b) AGCN at full width on the 31-node STGAT expanded
   graph (`[I, N, N^T]`), `formulation: pallas`: a served forward (batch
   32, T = 300) in fp32 and bf16 and in bf16 with `use_pallas`, card
   against CPU at phase 7's bars, 10 launches a forward, then 3 bf16 SGD
   steps at batch 64 (the first untimed) with 20 gcn_fwd and 10 gcn_bwd
   launches a step, ms a step and peak memory; (c) AAGCN on the same
   graph (`eval_formulation: pallas`) served in fp32 and bf16 card
   against CPU, its embeddings through the logits kernel (10 launches a
   forward).

`python3 chip_smoke.py --phase 14` runs phases 1 and 14 alone (about a
minute), `--phase 15` phases 1, 2 (the build) and 15, `--phase 16`
phases 1, 2 and 16, `--phase 17` phases 1 and 17, `--phase 18` phases 1
and 18, `--phase 19` phases 1 and 19, `--phase 20` phases 1, 2 and 20,
`--phase 21` phases 1, 2 and 21, `--phase 22` phases 1, 2 and 22,
`--phase 23` phases 1 and 23, `--phase 24` phases 1 and 24, `--phase
25` phases 1, 2 and 25; none
prints a result line (details of
15 in build/chip_smoke_knobs.json, of 16 in
build/chip_smoke_versions.json, of 17 in
build/chip_smoke_sgn_options.json, of 18 in
build/chip_smoke_sgn_transformer.json, of 19 in
build/chip_smoke_sgn_temporal.json, of 20 in
build/chip_smoke_parallel.json, of 21 in build/chip_smoke_openpose.json,
of 22 in build/chip_smoke_single_stream.json, of 23 in
build/chip_smoke_sgn_stack.json, of 24 in
build/chip_smoke_sgn_input.json, of 25 in
build/chip_smoke_any_joints.json).

The last lines of standard output are the `kernels` JSON line (each
kernel's V = 15 sums and launches under "v15", phase 25's sums at V = 31
and 67 and its launches under "vgen"), the card's `nvidia-smi`
name and power limit, and {"ok": true, "device": {...}}. Details go to
build/chip_smoke.json.
"""

import contextlib
import dataclasses
import importlib.util
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
try:
    # phases 3, 4 and 5 and the card-check helpers shared with them
    from agcn_tpu_torch.tools.bwd_check import (
        JOINTS_GENERAL, JOINTS_SMALL, LAYERS, PERSONS, SEED, TRAIN_BATCH,
        bwd_entry, bwd_spills, check, check_general_small, cuda_time_ms,
        da1_fp32_layers, log, nvidia_smi_line, phase_bwd_kernels,
        report_da1_fp32_build)
    from agcn_tpu_torch.tools.fwd_check import (
        SERVE_BATCH, fp32_layers, fwd_entry, phase_dx, phase_fwd_kernels,
        report_fp32_build, report_gen_build, spilling)
    from agcn_tpu_torch.tools.logits_check import (
        logits_close, logits_entry, logits_spills, logits_sums, phase_logits,
        report_build)
except ImportError as e:
    print(f"chip_smoke: the port is not importable here ({e}); run from a "
          "checkout of the repository", file=sys.stderr)
    sys.exit(1)
CONFIG = os.path.join(REPO, "configs", "ntu60_xview", "test_joint.yaml")
TRAIN_CONFIG = os.path.join(REPO, "configs", "ntu60_xview",
                            "train_joint.yaml")
AAGCN_CONFIG = os.path.join(REPO, "configs", "ntu60_xview",
                            "test_joint_aagcn.yaml")
AAGCN_TRAIN_CONFIG = os.path.join(REPO, "configs", "ntu60_xview",
                                  "train_joint_aagcn.yaml")
TRANSFORMER_CONFIG = os.path.join(REPO, "configs", "ntu60_xview",
                                  "test_joint_aagcn_transformer.yaml")
TRANSFORMER_TRAIN_CONFIG = os.path.join(REPO, "configs", "ntu60_xview",
                                        "train_joint_aagcn_transformer.yaml")
SGN_CONFIG = os.path.join(REPO, "configs", "ntu60_xview", "train_sgn.yaml")
SGN_TEST_CONFIG = os.path.join(REPO, "configs", "ntu60_xview",
                               "test_sgn.yaml")
SGN_FSIM_SAM_CONFIG = os.path.join(REPO, "configs", "ntu60_xview",
                                   "train_sgn_fsim_sam.yaml")
SGN_SCAN8_CONFIG = os.path.join(REPO, "configs", "ntu60_xview",
                                "train_sgn_scan8.yaml")
SGN_KINETICS_CONFIG = os.path.join(REPO, "configs", "kinetics",
                                   "train_sgn.yaml")
TRAIN_STEPS = 10
STREAMS = 16
SEQ = 300
TICK_FRAMES = 10


def make_streams(np, v=25):
    """Seeded synthetic skeleton streams of V joints: (S, frames, M, 1, V,
    C)."""
    rng = np.random.default_rng(SEED)
    frames = SEQ + 12 * TICK_FRAMES
    base = rng.standard_normal((STREAMS, 1, PERSONS, 1, v, 3)) * 0.3
    base[:, :, 1] += np.array([1.0, 0.0, 0.5])  # second body beside
    phase = rng.uniform(0, 2 * np.pi, (STREAMS, 1, PERSONS, 1, v, 3))
    tt = np.arange(frames)[None, :, None, None, None, None]
    motion = 0.1 * np.sin(tt * 0.15 + phase)
    noise = rng.standard_normal((STREAMS, frames, PERSONS, 1, v, 3)) * 0.01
    return (base + motion + noise).astype(np.float32)


def randomize_eval_state(torch, model, seed):
    """Seeded BN statistics/affines and PA, so every layer's output
    (the GCN's too — its BN starts at scale 1e-6) reaches the logits."""
    from agcn_tpu_torch.ops.norm import BatchNorm

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                n = m.weight.numel()
                m.weight.copy_(torch.rand(n, generator=g) + 0.5)
                m.bias.copy_(torch.randn(n, generator=g) * 0.1)
                m.running_mean.copy_(torch.randn(n, generator=g) * 0.1)
                m.running_var.copy_(torch.rand(n, generator=g) + 0.5)
        for name, p in model.named_parameters():
            if name.endswith(".PA"):
                p.copy_(torch.randn(p.shape, generator=g) * 0.01)


def serve_ticks(server, seq, start, ticks, pipelined):
    """Feed TICK_FRAMES frames per stream and tick; returns the answers
    of every tick, the wall time of the ticks and the mean host prep."""
    answers = []
    prep_ms = 0.0
    t0 = time.perf_counter()
    for i in range(ticks):
        lo = start + i * TICK_FRAMES
        for sid in range(STREAMS):
            for f in seq[sid, lo:lo + TICK_FRAMES]:
                server.append_frame(sid, f)
        r = server.predict_async() if pipelined else server.predict()
        prep_ms += server.last_prep_ms
        if r is not None:
            answers.append(r)
    if pipelined:
        answers.append(server.flush())
    return answers, time.perf_counter() - t0, prep_ms / ticks


def check_answers(np, answers, num_class):
    for res in answers:
        check(res is not None and sorted(res) == list(range(STREAMS)),
              "a tick did not answer every stream")
        for label, probs in res.values():
            check(probs.shape == (num_class,) and np.isfinite(probs).all()
                  and abs(probs.sum() - 1.0) < 1e-4
                  and 0 <= label < num_class, "malformed answer")


def serve_streams(torch, np, models, summary, label, num_class, v=25):
    """Serve the 16 streams of V joints with each model (fp32, bf16)
    through BatchedStreamServer: a warm-up tick, 4 sync and 4 pipelined
    ticks, then the last tick's input through the model directly, whose
    probabilities the served ones must equal. Every batched tick must run
    pre_normalization in C++ (one `native.pre_normalize` call a tick).
    Returns the forwards run, the card's logits per dtype, and that
    input."""
    from agcn_tpu_torch import native
    from agcn_tpu_torch.infer.preprocess import InferencePreprocessor
    from agcn_tpu_torch.infer.serving import BatchedStreamServer

    seq = make_streams(np, v)
    forwards = 0
    x_check = None
    card_logits = {}
    for dname, model in models.items():
        server = BatchedStreamServer(model, max_streams=STREAMS,
                                     num_joint=v, max_seq_length=SEQ)
        shadows = []
        for sid in range(STREAMS):
            check(server.add_stream() == sid, "stream ids")
            shadows.append(InferencePreprocessor(num_joint=v,
                                                 max_seq_length=SEQ))
        for i in range(SEQ):
            for sid in range(STREAMS):
                server.append_frame(sid, seq[sid, i])
                shadows[sid].append(seq[sid, i])
        calls = native.pre_normalize.calls
        # warm-up tick (cuDNN, kernel attributes), not timed
        warm, _, _ = serve_ticks(server, seq, SEQ, 1, False)
        sync, sync_s, sync_prep = serve_ticks(server, seq,
                                              SEQ + TICK_FRAMES, 4, False)
        pipe, pipe_s, pipe_prep = serve_ticks(
            server, seq, SEQ + 5 * TICK_FRAMES, 4, True)
        forwards += 1 + 4 + 4
        cpp_calls = native.pre_normalize.calls - calls
        check(cpp_calls == 1 + 4 + 4,
              f"{label} {dname}: {cpp_calls} C++ pre_normalize calls in 9 "
              "batched ticks")
        check_answers(np, warm + sync + pipe, num_class)
        check(len(pipe) == 4, "pipelined ticks lost")
        # the same input as the last tick, through the model directly
        for sid in range(STREAMS):
            for f in seq[sid, SEQ:SEQ + 9 * TICK_FRAMES]:
                shadows[sid].append(f)
        x_check = np.concatenate([s.dense_input() for s in shadows])
        with torch.inference_mode():
            logits = model(torch.from_numpy(x_check).cuda()).float().cpu()
        forwards += 1
        card_logits[dname] = logits.numpy()
        probs = torch.softmax(logits, -1).numpy()
        last = pipe[-1]
        served = np.stack([last[sid][1] for sid in range(STREAMS)])
        perr = float(np.abs(served - probs).max())
        check(perr < 1e-4, f"{label} {dname}: served probabilities differ "
                           f"from the model's on the same input by "
                           f"{perr:.2e}")
        tick_ms = {"sync": sync_s / 4 * 1e3, "pipelined": pipe_s / 4 * 1e3}
        prep_ms = {"sync": sync_prep, "pipelined": pipe_prep}
        # phase 6's figure (absent when a phase runs alone)
        numpy_ms = summary.get("host_data", {}).get(
            "pre_normalization_ms", {}).get("numpy", float("nan"))
        summary[f"{label}_serve_{dname}"] = dict(
            tick_ms=tick_ms, prep_ms=prep_ms, cpp_pre_normalize=cpp_calls,
            numpy_pre_normalization_ms=numpy_ms,
            preds_per_s={k: STREAMS / (v / 1e3) for k, v in tick_ms.items()})
        log(f"  {label} {dname}: {STREAMS} streams, tick "
            f"{tick_ms['sync']:.2f} ms sync / {tick_ms['pipelined']:.2f} ms "
            f"pipelined -> {STREAMS / tick_ms['sync'] * 1e3:.1f} / "
            f"{STREAMS / tick_ms['pipelined'] * 1e3:.1f} preds/s "
            f"(mean host prep {sync_prep:.2f} / {pipe_prep:.2f} ms with "
            f"pre_normalization in C++, {cpp_calls} calls; numpy "
            f"pre_normalization alone {numpy_ms:.2f} ms a tick, phase 6)")
    return forwards, card_logits, x_check


def check_against_cpu(torch, np, model_name, args, state, x_check,
                      card_logits, summary, label):
    """The same weights and input through the plain versions on the CPU:
    fp32 (TF32 off) within 1e-3 of the logit scale (another summation
    order through ten layers), bf16 within 5e-2 (~3 significant digits
    per activation through ten layers). `card_logits` maps a name that
    starts with its dtype to the card's logits on `x_check`."""
    from agcn_tpu_torch.models.registry import build_model

    torch.set_num_threads(os.cpu_count() or 1)
    cpu = build_model(model_name, args, device="cpu", num_frame=SEQ)
    cpu.load_state_dict({k: v.cpu() for k, v in state.items()}, strict=True)
    cpu.eval()
    t0 = time.perf_counter()
    with torch.inference_mode():
        ref = cpu(torch.from_numpy(x_check)).numpy()
    cpu_s = time.perf_counter() - t0
    scale = float(np.abs(ref).max())
    errs = {d: float(np.abs(card_logits[d] - ref).max())
            for d in card_logits}
    top1 = {d: float((card_logits[d].argmax(-1) == ref.argmax(-1)).mean())
            for d in card_logits}
    log(f"  {label} card vs cpu logits: max err {errs} (logit scale "
        f"{scale:.3f}), top-1 agreement {top1}, cpu forward {cpu_s:.1f} s")
    for name, err in errs.items():
        bar = 1e-3 if name.startswith("float32") else 5e-2
        check(err <= bar * max(scale, 1.0),
              f"{label} {name} card logits off the CPU reference by "
              f"{err:.3e}")
    summary[f"{label}_card_vs_cpu"] = dict(logit_err=errs, logit_scale=scale,
                                           top1_agreement=top1)


# the raw tree of phase 6 (c): (camera, subject, action, frames); xview
# trains on camera 2, xsub on subject 1
GEN_SAMPLES = ((1, 1, 1, 300), (2, 1, 2, 280), (1, 3, 3, 250),
               (2, 3, 4, 300), (1, 1, 5, 200), (2, 3, 6, 300),
               (1, 3, 7, 150), (2, 1, 8, 300))


def write_skeleton(np, path, frames, rng):
    """A seeded NTU `.skeleton` text file of two moving bodies."""
    t = np.arange(frames)[None, :, None, None]
    bodies = (rng.standard_normal((2, 1, 25, 3)) * 0.3
              + np.array([[0.0, 0.0, 3.0], [1.0, 0.0, 3.5]])[:, None, None]
              + 0.1 * np.sin(0.15 * t + rng.uniform(0, 6, (2, 1, 25, 3)))
              + rng.standard_normal((2, frames, 25, 3)) * 0.01)
    lines = [str(frames)]
    for f in range(frames):
        lines.append("2")
        for b in range(2):
            lines += ["72057594037931101 0 1 1 1 1 0 0.1 0.2 2", "25"]
            lines += [f"{x:.6f} {y:.6f} {z:.6f} 100 100 500 500 0.1 0.2 "
                      "0.3 0.9 2" for x, y, z in bodies[b, f]]
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


def median_ms(fn, iters=5):
    """The median host time of `iters` calls of fn, in ms."""
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[iters // 2]


def phase_host_data(torch, np, smi, summary):
    """The port's C++ host kernels (agcn_tpu_torch/native/skelio.cpp):
    (a) the g++ build; (b) pre_normalization of a served tick's batch, C++
    against numpy; (c) the generation CLI on a seeded raw tree, its joint
    and bone files through the Feeder and one full-width AGCN forward on
    the card."""
    import pickle

    from agcn_tpu_torch import native
    from agcn_tpu_torch.data.feeder import SkeletonDataset
    from agcn_tpu_torch.data.gen.ntu import read_skeleton
    from agcn_tpu_torch.data.gen.preprocess import pre_normalization
    from agcn_tpu_torch.infer.serving import BatchedStreamServer
    from agcn_tpu_torch.models.registry import build_model
    from agcn_tpu_torch.utils.config import load_config

    # (a) build
    t0 = time.perf_counter()
    path = native.build()
    build_s = time.perf_counter() - t0
    check(path is not None and native.available(),
          "the native library did not build (no g++ on the PATH)")
    log(f"  (a) g++ {' '.join(native.GXX_FLAGS)} -> {path.name} in "
        f"{build_s:.2f} s")

    # (b) the batch of a served tick: 16 streams, T = 300, the two bodies
    # selected, before pre_normalization (a server with a stand-in model:
    # only its host prep runs)
    seq = make_streams(np)
    server = BatchedStreamServer(torch.nn.Linear(1, 1), max_streams=STREAMS,
                                 max_seq_length=SEQ, normalize=False)
    for sid in range(STREAMS):
        server.add_stream()
        for f in seq[sid, :SEQ]:
            server.append_frame(sid, f)
    rows = server._prepare_dense_batched(list(range(STREAMS)))
    check(rows.shape == (STREAMS, 3, SEQ, 25, 2), f"tick rows {rows.shape}")
    calls = native.pre_normalize.calls
    got = pre_normalization(rows)
    check(native.pre_normalize.calls == calls + 1,
          "pre_normalization did not run the C++ kernel")
    ref = pre_normalization(rows, native_ok=False)
    scale = float(np.abs(ref).max())
    err = float(np.abs(got - ref).max())
    check(err <= 1e-4 * scale, f"C++ pre_normalization off numpy by {err:.3e}"
                               f" (scale {scale:.3f})")
    cpp_ms = median_ms(lambda: pre_normalization(rows))
    numpy_ms = median_ms(lambda: pre_normalization(rows, native_ok=False))
    log(f"  (b) pre_normalization of one tick's batch {tuple(rows.shape)}: "
        f"C++ {cpp_ms:.2f} ms, numpy {numpy_ms:.2f} ms (median of 5, the "
        f"card's host; {smi}); max err {err:.2e} of scale {scale:.3f} "
        f"(bar 1e-4 x scale)")

    # (c) generation: raw .skeleton -> joint (ntu) -> bone (streams)
    with tempfile.TemporaryDirectory() as tmp:
        raw = os.path.join(tmp, "raw")
        os.makedirs(raw)
        rng = np.random.default_rng(SEED + 21)
        names = []
        for c, p, a, frames in GEN_SAMPLES:
            names.append(f"S001C{c:03d}P{p:03d}R001A{a:03d}.skeleton")
            write_skeleton(np, os.path.join(raw, names[-1]), frames, rng)
        out = os.path.join(tmp, "out")
        t0 = time.perf_counter()
        counts = run_entry_point(["ntu", "--data-path", raw, "--out-path",
                                  out, "--benchmark", "xview", "--part",
                                  "train", "eval"],
                                 module="agcn_tpu_torch.data.gen")
        xview = os.path.join(out, "xview")
        for part in ("train", "eval"):
            run_entry_point(["streams", "--joint-path",
                             os.path.join(xview, f"{part}_data_joint.npy")],
                            module="agcn_tpu_torch.data.gen")
        gen_s = time.perf_counter() - t0
        check(counts["parse_skeleton"] == len(names),
              f"the ntu CLI parsed {counts['parse_skeleton']} files in "
              f"C++, not {len(names)}")
        check(counts["pre_normalize"] == 2,
              f"the ntu CLI ran pre_normalize {counts['pre_normalize']} "
              "times, not once a split")
        for name in names:
            parsed, frames = native.parse_skeleton(
                os.path.join(raw, name), 4, 10_000, 25)
            py, py_frames = read_skeleton(os.path.join(raw, name))
            check(frames == py_frames and np.array_equal(
                parsed[:, :frames], py.astype(np.float32)),
                f"{name}: the C++ parse differs from read_skeleton")
        model = build_model("agcn", dict(load_config(CONFIG).model_args,
                                         formulation="pallas"),
                            device="cuda",
                            generator=torch.Generator().manual_seed(SEED))
        randomize_eval_state(torch, model, SEED + 1)
        model.eval()
        gen = {}
        for part, cams in (("train", (2,)), ("eval", (1,))):
            want = sorted(n for n in names if int(n[5:8]) in cams)
            with open(os.path.join(xview, f"{part}_label.pkl"), "rb") as f:
                got_names, labels = pickle.load(f)
            check(got_names == want
                  and labels == [int(n[17:20]) - 1 for n in want],
                  f"{part} labels {got_names} {labels}")
            for stream in ("joint", "bone"):
                ds = SkeletonDataset(
                    os.path.join(xview, f"{part}_data_{stream}.npy"),
                    os.path.join(xview, f"{part}_label.pkl"))
                x = np.stack([ds[i][0] for i in range(len(ds))])
                check(x.shape == (len(want), 3, SEQ, 25, 2)
                      and np.isfinite(x).all() and np.abs(x).max() > 0,
                      f"{part} {stream}: {x.shape}")
                with torch.inference_mode():
                    logits = model(torch.from_numpy(x).cuda()).float().cpu()
                check(logits.shape == (len(want), 60)
                      and bool(torch.isfinite(logits).all()),
                      f"{part} {stream} logits {tuple(logits.shape)}")
                gen[f"{part}_{stream}"] = list(x.shape)
        del model
    log(f"  (c) python -m agcn_tpu_torch.data.gen ntu (xview train + eval) "
        f"and streams on {len(names)} raw files in {gen_s:.1f} s: "
        f"parse_skeleton {counts['parse_skeleton']} C++ calls, "
        f"pre_normalize {counts['pre_normalize']}; C++ parse == "
        f"read_skeleton on every file; {gen}; joint and bone through the "
        f"Feeder and one pallas AGCN forward each: finite logits")
    summary["host_data"] = dict(
        build_s=build_s, library=path.name, tick_rows=list(rows.shape),
        pre_normalization_ms={"cpp": cpp_ms, "numpy": numpy_ms},
        max_err=err, scale=scale, gen_s=gen_s, gen_calls=counts,
        gen_shapes=gen, nvidia_smi=smi)


def phase_main_path(torch, np, summary):
    from agcn_tpu_torch import native
    from agcn_tpu_torch.infer.serving import BatchedStreamServer
    from agcn_tpu_torch.models.registry import build_model
    from agcn_tpu_torch.ops.kernels import gcn_fused, gcn_kernel
    from agcn_tpu_torch.utils.config import load_config

    cfg = load_config(CONFIG)
    args = dict(cfg.model_args, formulation="pallas")
    num_class = args["num_class"]
    models = {}
    for dname in ("float32", "bfloat16"):
        m = build_model(cfg.model, args, device="cuda",
                        dtype=getattr(torch, dname),
                        generator=torch.Generator().manual_seed(SEED))
        randomize_eval_state(torch, m, SEED + 1)
        models[dname] = m.eval()
    state = models["float32"].state_dict()
    ups = {}
    for dname in ("float32", "bfloat16"):
        m = build_model(cfg.model, dict(args, use_pallas=True), device="cuda",
                        dtype=getattr(torch, dname))
        m.load_state_dict(state, strict=True)
        ups[dname] = m.eval()

    gcn_fused.adaptive_gcn_pallas.launches = 0
    gcn_kernel.fused_gcn.launches = 0
    served, card_logits, x_check = serve_streams(torch, np, models, summary,
                                                 "agcn", num_class)
    forwards = {"pallas": served, "use_pallas": {}}
    fused_gcn_launches = {}

    # one served tick with use_pallas=True (the gcn_kernel entry) in each
    # dtype, on the input of serve_streams' last tick (x_check); a hook
    # keeps the tick's logits
    seq = make_streams(np)
    for dname, up in ups.items():
        server = BatchedStreamServer(up, max_streams=STREAMS,
                                     max_seq_length=SEQ)
        for sid in range(STREAMS):
            server.add_stream()
        for i in range(SEQ + 9 * TICK_FRAMES):
            for sid in range(STREAMS):
                server.append_frame(sid, seq[sid, i])
        kept = []
        hook = up.register_forward_hook(
            lambda mod, inp, out: kept.append(out.float().cpu().numpy()))
        before = gcn_kernel.fused_gcn.launches
        calls = native.pre_normalize.calls
        up_ans = server.predict()
        fused_gcn_launches[dname] = gcn_kernel.fused_gcn.launches - before
        check(native.pre_normalize.calls == calls + 1,
              f"use_pallas {dname} tick: pre_normalization not in C++")
        hook.remove()
        forwards["use_pallas"][dname] = len(kept)
        check_answers(np, [up_ans], num_class)
        check(len(kept) == 1, f"use_pallas {dname} tick ran {len(kept)} "
                              f"forwards")
        card_logits[f"{dname} use_pallas"] = kept[0][:STREAMS]
    # fp32: the use_pallas form against the pallas form on the card, in
    # probability (in fp32 the two forms are the same function)
    up_probs = torch.softmax(torch.from_numpy(
        card_logits["float32 use_pallas"]), -1).numpy()
    ref_probs = torch.softmax(torch.from_numpy(card_logits["float32"]),
                              -1).numpy()
    uerr = float(np.abs(up_probs - ref_probs).max())
    check(uerr < 1e-4, f"use_pallas tick differs from the pallas "
                       f"formulation by {uerr:.2e} in probability")

    launches = {"adaptive_gcn_pallas": gcn_fused.adaptive_gcn_pallas.launches,
                "fused_gcn": fused_gcn_launches}
    log(f"  launches {launches} for forwards {forwards}")
    check(launches["adaptive_gcn_pallas"] == LAYERS * forwards["pallas"]
          and all(fused_gcn_launches.get(d) == LAYERS * n
                  for d, n in forwards["use_pallas"].items()),
          f"launch counts {launches} != {LAYERS} layers x {forwards}")
    # the CPU reference of every entry: on the CPU in fp32 the pallas and
    # use_pallas forms run the same plain function (gcn_fwd_plain, whose
    # aggregate rounding is a no-op in fp32)
    check_against_cpu(torch, np, cfg.model, args, state, x_check,
                      card_logits, summary, "agcn")
    summary.update(launches=launches, forwards=forwards)
    return launches, state, args, models, x_check


def dense_streams(np, frames, v=25):
    """The model input of the first `frames` frames of every stream (V
    joints), as the server prepares it."""
    from agcn_tpu_torch.infer.preprocess import InferencePreprocessor

    seq = make_streams(np, v)
    out = []
    for sid in range(STREAMS):
        pp = InferencePreprocessor(num_joint=v, max_seq_length=SEQ)
        for f in seq[sid, :frames]:
            pp.append(f)
        out.append(pp.dense_input())
    return np.concatenate(out)


def prepare_aagcn_eval(torch, np, model, x, seed):
    """Seeded weights that exercise every branch of an AAGCN at eval: BN
    affines, PA about the graph, a live attention branch (alpha, conv_ta
    and fc2c start at zero), and every BN's running statistics set to its
    batch statistics in a train-mode forward, so that eval normalizes as
    training would (with random statistics the attention's x * (1 + se)
    grows the logits 1e5-fold over ten blocks). `x`: the model input
    (numpy) of that forward."""
    from agcn_tpu_torch.ops.norm import BatchNorm

    g = torch.Generator().manual_seed(seed)

    def draw(p, fn):
        p.copy_(fn(p.shape).to(p.device))

    norms = [m for m in model.modules() if isinstance(m, BatchNorm)]
    with torch.no_grad():
        for m in norms:
            draw(m.weight, lambda s: torch.rand(s, generator=g) + 0.5)
            draw(m.bias, lambda s: torch.randn(s, generator=g) * 0.1)
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
        for name, p in model.named_parameters():
            if name.endswith(".PA"):
                p.add_((torch.randn(p.shape, generator=g) * 0.05).to(p.device))
            elif name.endswith(".alpha"):
                draw(p, lambda s: torch.rand(s, generator=g) * 0.5 + 0.5)
            elif ".conv_ta." in name or ".fc2c." in name:
                draw(p, lambda s: torch.randn(s, generator=g) * 0.1)
        model.train()(torch.from_numpy(x).to(next(model.parameters()).device))
        for m in norms:  # undo the momentum-0.1 update from (0, 1)
            m.running_mean.div_(0.1)
            m.running_var.sub_(0.9).div_(0.1).clamp_(min=1e-3)
    model.eval()


def capture_embeddings(torch, model, x):
    """The fused theta|phi embedding that each layer of one forward hands
    to ops.gcn.attention_logits, with (K, Ce)."""
    from agcn_tpu_torch.ops import gcn as gcn_ops

    seen = []
    plain = gcn_ops.attention_logits

    def keep(emb, k, ce, form="transposed"):
        seen.append((emb.detach().clone(), k, ce))
        return plain(emb, k, ce, form)

    gcn_ops.attention_logits = keep
    try:
        with torch.inference_mode():
            model(x)
    finally:
        gcn_ops.attention_logits = plain
    return seen


def phase_aagcn_serving(torch, np, summary):
    """AAGCN serving: test_joint_aagcn.yaml with formulation and
    eval_formulation pallas, 16 streams in fp32 and bf16, 10 gcn_fwd
    launches per forward, card against CPU; then the logits kernel's own
    entry point on the theta/phi each layer of a served forward produces,
    against attention_logits(emb, 'transposed') in fp32."""
    from agcn_tpu_torch.models.registry import build_model
    from agcn_tpu_torch.ops.kernels import gcn_fused, gcn_kernel
    from agcn_tpu_torch.utils.config import load_config

    cfg = load_config(AAGCN_CONFIG)
    args = dict(cfg.model_args, formulation="pallas",
                eval_formulation="pallas")
    num_class = args["num_class"]
    ref = build_model(cfg.model, args, device="cuda",
                      generator=torch.Generator().manual_seed(SEED))
    # BN statistics from the streams' first 300 frames; the served ticks
    # then run on later frames
    prepare_aagcn_eval(torch, np, ref, dense_streams(np, SEQ), SEED + 1)
    state = {k: v.detach().clone() for k, v in ref.state_dict().items()}
    del ref
    models = {}
    for dname in ("float32", "bfloat16"):
        m = build_model(cfg.model, args, device="cuda",
                        dtype=getattr(torch, dname))
        m.load_state_dict(state, strict=True)
        models[dname] = m.eval()

    gcn_fused.adaptive_gcn_pallas.launches = 0
    gcn_kernel.fused_gcn.launches = 0
    forwards, card_logits, x_check = serve_streams(torch, np, models,
                                                   summary, "aagcn",
                                                   num_class)
    launches = {"adaptive_gcn_pallas": gcn_fused.adaptive_gcn_pallas.launches,
                "fused_gcn": gcn_kernel.fused_gcn.launches}
    log(f"  aagcn launches {launches} for {forwards} forwards")
    check(launches == {"adaptive_gcn_pallas": LAYERS * forwards,
                       "fused_gcn": 0},
          f"aagcn launch counts {launches} != {LAYERS} layers x {forwards}")
    check_against_cpu(torch, np, cfg.model, args, state, x_check,
                      card_logits, summary, "aagcn")
    logits_launches, worst = logits_on_served_embeddings(torch, models,
                                                         x_check)
    summary.update(aagcn_launches=launches, aagcn_forwards=forwards,
                   logits_served=dict(launches=logits_launches,
                                      max_err_over_scale=worst))
    return launches, logits_launches, state, args, models, x_check


def logits_on_served_embeddings(torch, models, x_check):
    """The logits kernel's entry point on the theta/phi that each layer of
    one served forward of each model produces, against
    attention_logits(emb, 'transposed') in fp32 at 1e-5 of the scale:
    LAYERS launches a forward. Returns (launches, worst err / scale)."""
    from agcn_tpu_torch.ops import gcn as gcn_ops
    from agcn_tpu_torch.ops.kernels import logits_kernel

    x = torch.from_numpy(x_check).cuda()
    embs = {d: capture_embeddings(torch, m, x) for d, m in models.items()}
    logits_kernel.attention_logits_pallas.launches = 0
    worst = 0.0
    for dname, seen in embs.items():
        check(len(seen) == LAYERS, f"{dname}: {len(seen)} logits calls")
        for emb, k, ce in seen:
            b, t, v, _ = emb.shape
            e = emb.view(b, t, v, 2, k, ce)
            with torch.inference_mode():
                got = logits_kernel.attention_logits_pallas(
                    e[..., 0, :, :], e[..., 1, :, :], ce * t)
                want = gcn_ops.attention_logits(emb.float(), k, ce,
                                                "transposed")
            ok, err, scale = logits_close(got, want)
            check(ok, f"served {dname} V={v} T={t} Ce={ce}: logits kernel "
                      f"off the transposed form by {err:.3e} (scale "
                      f"{scale:.3e})")
            worst = max(worst, err / scale)
    logits_launches = logits_kernel.attention_logits_pallas.launches
    log(f"  logits kernel on the served embeddings of {len(embs)} forwards: "
        f"{logits_launches} launches, max err {worst:.2e} of the scale")
    check(logits_launches == LAYERS * len(embs),
          f"logits launches {logits_launches} != {LAYERS} x {len(embs)}")
    return logits_launches, worst


# kernel-name substrings -> group of the device-time breakdown, first
# match wins
KERNEL_GROUPS = (
    ("gcn_fwd_", "gcn_fwd (the port's CUDA kernel)"),
    ("logits_", "attention logits (the port's CUDA kernel)"),
    ("gcn_dw_", "gcn_bwd (the port's CUDA kernel)"),
    ("gcn_u_kernel", "gcn_bwd (the port's CUDA kernel)"),
    # gcn_da1_fp32_kernel (fp32), gcn_da1_mma_kernel (bf16) and
    # gcn_da1_reduce_kernel (both): before "reduce" below
    ("gcn_da1_", "gcn_bwd (the port's CUDA kernel)"),
    ("conv", "cuDNN convolution"), ("cudnn", "cuDNN convolution"),
    # cuDNN's FFT convolution algorithms (fp32 with TF32 off)
    ("fft", "cuDNN convolution"),
    ("pointwise_mult_and_sum_complex", "cuDNN convolution"),
    ("gemm", "GEMM (cuBLAS)"), ("sm90_xmma", "GEMM (cuBLAS)"),
    ("cutlass", "GEMM (cuBLAS)"), ("softmax", "softmax"),
    ("reduce", "reductions"), ("elementwise", "elementwise"),
    ("copy", "copies / layout"), ("Memcpy", "memcpy"))


def kernel_group(name):
    low = name.lower()
    for key, group in KERNEL_GROUPS:
        if key.lower() in low:
            return group
    return "other"


def profile_forward(torch, model, x, iters=5):
    """Wall ms of a forward (profiler off), and its device time by kernel
    group with the kernels launched in each (`torch.profiler`)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        model(x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            model(x)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / iters
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                model(x)
            torch.cuda.synchronize()
    groups, kernels = {}, {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            g = kernel_group(ev.name)
            groups[g] = groups.get(g, 0.0) + ev.device_time_total / 1e3 / iters
            kernels[g] = kernels.get(g, 0) + 1
    kernels = {g: n / iters for g, n in kernels.items()}
    device_ms = sum(groups.values())
    check(device_ms > 0, "the profiler saw no device time")
    return dict(wall_ms=wall_ms, device_ms=device_ms, groups=groups,
                kernels=kernels)


def phase_profile(torch, models, x_np, summary, label, iters=5):
    """Device time of one served forward by kernel group, under
    torch.profiler, on the main path's models and its last served input;
    the wall time per forward is taken with the profiler off."""
    x = torch.from_numpy(x_np).cuda()
    for dname, model in models.items():
        prof = profile_forward(torch, model, x, iters)
        wall_ms, device_ms = prof["wall_ms"], prof["device_ms"]
        log(f"  {label} {dname}: wall {wall_ms:.3f} ms per forward (profiler "
            f"off), "
            f"device {device_ms:.3f} ms under the profiler (busy "
            f"{100 * device_ms / wall_ms:.1f}%)")
        for g, ms in sorted(prof["groups"].items(), key=lambda kv: -kv[1]):
            log(f"    {ms:9.3f} ms {100 * ms / device_ms:5.1f}%  {g}")
        summary[f"{label}_profile_{dname}"] = dict(
            wall_ms=wall_ms, device_ms=device_ms, groups=prof["groups"])


def phase_cli(torch, np, state, model_name, args, trainer_checkpoint=False,
              launches_per_tick=LAYERS):
    """The serving CLI on 16 recordings, its weights a bare state dict or,
    with `trainer_checkpoint`, a file of the port trainer's
    `save_checkpoint` (the model, optimizer state, step and epoch)."""
    import yaml

    from agcn_tpu_torch.infer import cli
    from agcn_tpu_torch.models.registry import build_model
    from agcn_tpu_torch.ops.kernels import gcn_fused
    from agcn_tpu_torch.train.checkpoint import save_checkpoint

    seq = make_streams(np)[:, :4 * TICK_FRAMES]  # 4 ticks per stream
    with tempfile.TemporaryDirectory() as tmp:
        rec = os.path.join(tmp, "recordings")
        os.makedirs(rec)
        for sid in range(STREAMS):
            # (C, T, V, M) recordings
            arr = np.transpose(seq[sid, :, :, 0], (3, 0, 2, 1))
            np.save(os.path.join(rec, f"cam{sid:02d}.npy"), arr)
        weights = os.path.join(tmp, f"{model_name}.pt")
        if trainer_checkpoint:
            model = build_model(model_name, args, device="cpu")
            model.load_state_dict({k: v.cpu() for k, v in state.items()},
                                  strict=True)
            save_checkpoint(weights, model, {}, step=1, epoch=1,
                            steps_per_epoch=1)
            del model
        else:
            torch.save({k: v.cpu() for k, v in state.items()}, weights)
        cfg_path = os.path.join(tmp, "serve.yaml")
        with open(cfg_path, "w") as f:
            yaml.safe_dump({"model": model_name, "model_args": args}, f)
        gcn_fused.adaptive_gcn_pallas.launches = 0
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            cli.main(["--config", cfg_path, "--weights", weights,
                      "--input", rec, "--serve", str(STREAMS), "--pipeline",
                      "--timing", "--interval", str(TICK_FRAMES)])
        launches = gcn_fused.adaptive_gcn_pallas.launches
    lines = out.getvalue().splitlines()
    answers = [ln for ln in lines if ln.startswith("[cam")]
    ticks = [ln for ln in lines if ln.startswith("tick:")]
    source = "trainer checkpoint" if trainer_checkpoint else "state dict"
    log(f"  {model_name} cli ({source}): {len(answers)} answers, "
        f"{len(ticks)} ticks, "
        f"{launches} launches; last: {ticks[-1] if ticks else None}")
    check(len(answers) == STREAMS * 4
          and launches == launches_per_tick * 4,
          f"cli served {len(answers)} answers with {launches} launches")
    return launches


def train_model(torch, cfg, form, dname, device="cuda"):
    """The recipe's model at full width with `formulation: form`, seeded
    weights, parameters fp32 and compute in `dname`."""
    from agcn_tpu_torch.models.registry import build_model

    return build_model(cfg.model, dict(cfg.model_args, formulation=form),
                       device=device,
                       dtype=None if dname == "float32" else torch.bfloat16,
                       generator=torch.Generator().manual_seed(SEED))


def train_batch(np, n, seed, num_class=60, v=25):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 3, SEQ, v, PERSONS)).astype(np.float32)
    return x, rng.integers(0, num_class, n)


def joints(cfg):
    """The recipe's joint count (the NTU skeleton's 25 unless it names
    another)."""
    return cfg.model_args.get("num_point", 25)


def make_step(torch, cfg, model, steps_per_epoch=1, keep=None, sam_rho=0.0,
              recipe_loss=False):
    """The trainer's step: the recipe's loss and optimizer (AGCN's: clip ->
    decay -> nesterov), with `keep` given the model's raw gradients (under
    SAM, `sam_rho` > 0, those of pass two, which the update takes); the
    optimizer is the step's `.optimizer`. With `recipe_loss`, the loss is
    the trainer's: the recipe's label smoothing and its aux losses (the
    MMD loss)."""
    from agcn_tpu_torch.train import losses, optim
    from agcn_tpu_torch.train.steps import make_train_step
    from agcn_tpu_torch.train.trainer import build_aux_loss

    opt = optim.from_config(cfg, model.named_parameters(), steps_per_epoch)
    loss_fn = losses.build_loss(
        cfg.loss, cfg.model_args["num_class"],
        **({"smoothing": cfg.label_smoothing} if recipe_loss else {}))
    step = make_train_step(
        model, loss_fn, opt, grad_transform=keep, sam_rho=sam_rho,
        aux_loss_fn=build_aux_loss(cfg, model) if recipe_loss else None)
    step.optimizer = opt
    return step


def liven_attention(torch, model, seed):
    """AAGCN's attention branch away from its zero init: alpha in
    [0.5, 1), conv_ta and fc2c normal(0, 0.1) (a no-op on AGCN)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".alpha"):
                p.copy_((torch.rand(p.shape, generator=g) * 0.5 + 0.5)
                        .to(p.device))
            elif ".conv_ta." in name or ".fc2c." in name:
                p.copy_((torch.randn(p.shape, generator=g) * 0.1)
                        .to(p.device))


def phase_train_vs_cpu(torch, np, cfg, summary, label):
    """(a) One step at batch 4: the card with the kernels against the card
    with their plain versions (the kernels' own error) and against
    device="cpu" (the whole step).

    A ReLU input within rounding of zero may take either side in two fp32
    computations, and one such flip moves the gradients of its layer and
    of every layer below it by ~1% (agcn_tpu_torch/tools/grad_parity.py).
    So the CPU's step records its ReLU inputs and masks and the card's
    fp32 steps replay the masks: all three compute the same linear piece
    of the network. The card's ReLU inputs must lie within 1e-3 of their
    layer's mean |input| of the CPU's, so that the masks hide no fault."""
    from agcn_tpu_torch.tools.grad_parity import (
        ReluProbe, condition_bn, grad_errors, plain_versions_on_the_card,
        relu_probe)

    x, y = train_batch(np, 4, SEED + 4, v=joints(cfg))
    ref = train_model(torch, cfg, "pallas", "float32")
    condition_bn(ref, SEED + 6)
    liven_attention(torch, ref, SEED + 12)
    state = {k: v.detach().cpu().clone() for k, v in ref.state_dict().items()}
    del ref
    out, probes = {}, {}
    torch.set_num_threads(os.cpu_count() or 1)
    runs = {"cpu fp32": ("cpu", "float32", False),
            "card fp32": ("cuda", "float32", False),
            "card fp32 plain": ("cuda", "float32", True),
            "card bf16": ("cuda", "bfloat16", False)}
    for run, (dev, dname, plain) in runs.items():
        model = train_model(torch, cfg, "pallas", dname, device=dev)
        model.load_state_dict(state, strict=True)
        grads = {}

        def keep(m):
            # a copy: the optimizer then clips the gradients in place
            grads.update((n, p.grad.double().cpu().clone())
                         for n, p in m.named_parameters())

        probes[run] = (
            ReluProbe(keep_inputs=True) if run == "cpu fp32"
            else ReluProbe(ref=probes["cpu fp32"]) if dname == "float32"
            else ReluProbe())
        t0 = time.perf_counter()
        with contextlib.ExitStack() as scopes:
            scopes.enter_context(relu_probe(probes[run]))
            if plain:
                scopes.enter_context(plain_versions_on_the_card())
            loss = make_step(torch, cfg, model, keep=keep)(
                torch.from_numpy(x).to(dev),
                torch.from_numpy(y).to(dev))["loss"].item()
        out[run] = (loss, grads, time.perf_counter() - t0)
        del model
    ref_loss, ref_grads, cpu_s = out["cpu fp32"]
    rel = {k: abs(v[0] - ref_loss) / abs(ref_loss) for k, v in out.items()}
    # fp32 (TF32 off), sums in another order: 1e-3 of each tensor's scale
    kern = grad_errors(out["card fp32"][1], out["card fp32 plain"][1], 1e-3)
    cpu = grad_errors(out["card fp32"][1], ref_grads, 1e-3)
    flips = {k: (probes[k].disagree, probes[k].input_diff)
             for k in ("card fp32", "card fp32 plain")}
    log(f"  {label} (a) batch 4: loss cpu fp32 {ref_loss:.6f}; relative to it "
        + ", ".join(f"{k} {out[k][0]:.6f} ({rel[k]:.2e})"
                    for k in runs if k != "cpu fp32")
        + f"; cpu step {cpu_s:.1f} s; ReLU signs off the cpu's masks: "
        + ", ".join(f"{k} {n} (inputs at most {m:.2e} of their layer's "
                    f"mean |input| from the cpu's)"
                    for k, (n, m) in flips.items()))
    for k, rows in (("kernels vs plain on the card", kern),
                    ("card vs cpu", cpu)):
        log(f"      {k}: worst gradients (err / bar, name, err, scale): "
            + "; ".join(f"{r:.2f} {n} {e:.3e} {sc:.3e}"
                        for r, n, e, sc in rows[:3]))
    check(all(m <= 1e-3 for _, m in flips.values()),
          f"{label}: the card's ReLU inputs lie far from the CPU's: {flips}")
    # bf16: ~3 digits per activation through ten layers, against the
    # fp32 reference
    check(rel["card fp32"] <= 1e-4 and rel["card fp32 plain"] <= 1e-4,
          f"{label}: fp32 card loss off the CPU's: {rel}")
    check(kern[0][0] <= 1.0, f"{label}: fp32 gradients with the kernels off "
                             f"those with their plain versions: {kern[0]}")
    check(cpu[0][0] <= 1.0,
          f"{label}: fp32 card gradients off the CPU's: {cpu[0]}")
    check(rel["card bf16"] <= 5e-2,
          f"{label}: bf16 card loss off the CPU's: {rel}")
    summary[f"{label}_train_vs_cpu"] = dict(
        loss={k: v[0] for k, v in out.items()}, loss_rel=rel,
        relu_sign_flips=flips,
        kernels_vs_plain=[list(r) for r in kern[:5]],
        card_vs_cpu=[list(r) for r in cpu[:5]])


def phase_train_main_path(torch, np, cfg, summary, label, time_steps=0):
    """(c) Ten bf16 steps of the recipe's `pallas` model at batch 64 on
    one repeated batch: the loss must fall, and each step must launch
    gcn_fwd 20 times (10 forwards, 10 dx) and gcn_bwd 10 times. Then
    `time_steps` more, timed (ms a step, seq/s, peak memory)."""
    from agcn_tpu_torch.ops.kernels import gcn_fused, gcn_kernel

    model = train_model(torch, cfg, "pallas", "bfloat16")
    step = make_step(torch, cfg, model)
    x, y = train_batch(np, TRAIN_BATCH, SEED + 7, v=joints(cfg))
    x, y = torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()
    gcn_fused.adaptive_gcn_pallas.launches = 0
    gcn_kernel.fused_gcn.launches = 0
    gcn_fused.gcn_backward.launches = 0
    losses = [step(x, y)["loss"] for _ in range(TRAIN_STEPS)]
    losses = [v.item() for v in losses]
    launches = {"gcn_fwd_round_agg": gcn_fused.adaptive_gcn_pallas.launches,
                "gcn_fwd_fp32_agg": gcn_kernel.fused_gcn.launches,
                "gcn_bwd": gcn_fused.gcn_backward.launches}
    log(f"  {label} (c) {TRAIN_STEPS} steps on one batch: loss "
        f"{' '.join(f'{v:.3f}' for v in losses)}; launches {launches}")
    check(all(math.isfinite(v) for v in losses), "non-finite loss")
    check(losses[-1] < losses[0],
          f"{label}: the loss did not fall on a repeated batch: {losses}")
    check(launches == {"gcn_fwd_round_agg": 2 * LAYERS * TRAIN_STEPS,
                       "gcn_fwd_fp32_agg": 0,
                       "gcn_bwd": LAYERS * TRAIN_STEPS},
          f"{label}: launch counts {launches} for {TRAIN_STEPS} steps")
    summary[f"{label}_train_losses"] = losses
    summary[f"{label}_train_launches"] = launches
    if time_steps:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(time_steps):
            step(x, y)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / time_steps
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        summary[f"{label}_train_speed"] = dict(
            ms_per_step=ms, seq_per_s=TRAIN_BATCH / ms * 1e3, peak_gib=peak,
            timed_steps=time_steps)
        log(f"  {label} (c) {time_steps} more steps: {ms:.2f} ms/step, "
            f"{TRAIN_BATCH / ms * 1e3:.1f} seq/s, peak {peak:.2f} GiB")
    return launches


def phase_train_speed(torch, np, cfg, summary, label, iters=5,
                      fp32=False):
    """(d) ms per step, seq/s and peak memory per formulation at batch
    64, bf16; the device time of one pallas step by kernel group. With
    `fp32`, then pallas and agg_packed in fp32 (TF32 off), 1 warm-up and
    3 timed steps each, and one fp32 pallas step profiled."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x, y = train_batch(np, TRAIN_BATCH, SEED + 8)
    x, y = torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()
    runs = [(form, "bfloat16", 2, iters)
            for form in ("pallas", "pallas_hybrid", "agg_packed")]
    if fp32:
        runs += [(form, "float32", 1, 3) for form in ("pallas", "agg_packed")]
    speed = {}
    for form, dname, warm, n in runs:
        key = form if dname == "bfloat16" else f"{form}_fp32"
        model = train_model(torch, cfg, form, dname)
        step = make_step(torch, cfg, model)
        for _ in range(warm):
            step(x, y)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(n):
            step(x, y)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / n
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        speed[key] = dict(ms_per_step=ms, seq_per_s=TRAIN_BATCH / ms * 1e3,
                          peak_gib=peak, timed_steps=n)
        log(f"  {label} (d) {key:15s} {ms:8.2f} ms/step "
            f"{TRAIN_BATCH / ms * 1e3:7.1f}"
            f" seq/s, peak {peak:.2f} GiB")
        if form == "pallas":
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                step(x, y)
                torch.cuda.synchronize()
            groups, ours = {}, {}
            for ev in prof.events():
                if ev.device_type == DeviceType.CUDA:
                    g = kernel_group(ev.name)
                    ms_ev = ev.device_time_total / 1e3
                    groups[g] = groups.get(g, 0.0) + ms_ev
                    mine = re.search(r"gcn_\w+_kernel", ev.name)
                    if mine:  # the port's kernels one by one
                        ours[mine[0]] = ours.get(mine[0], 0.0) + ms_ev
            device_ms = sum(groups.values())
            check(device_ms > 0, "the profiler saw no device time")
            da1 = sorted(k for k in ours if "da1" in k)
            if dname == "bfloat16":
                # bf16 da1 runs on the tensor cores, never the fp32 kernel
                check("gcn_da1_mma_kernel" in ours
                      and "gcn_da1_fp32_kernel" not in ours,
                      f"{label}: da1 kernels of a bf16 pallas step: {da1}")
            else:
                # fp32 da1: the CUDA-core kernel over frame groups, then
                # the ordered reduce
                check(da1 == ["gcn_da1_fp32_kernel", "gcn_da1_reduce_kernel"],
                      f"{label}: da1 kernels of an fp32 pallas step: {da1}")
                # fp32 dW: u formed once, then the CUDA-core GEMM
                check({"gcn_u_kernel", "gcn_dw_fp32_kernel"} <= set(ours)
                      and "gcn_dw_mma_kernel" not in ours
                      and "gcn_dw_partial_kernel" not in ours,
                      f"{label}: dW kernels of an fp32 pallas step: "
                      f"{sorted(k for k in ours if 'dw' in k or 'u_' in k)}")
                # fp32 forward and dx: the CUDA-core gcn_fwd_fp32_kernel
                fwd = sorted(k for k in ours if k.startswith("gcn_fwd"))
                check(fwd == ["gcn_fwd_fp32_kernel"],
                      f"{label}: gcn_fwd kernels of an fp32 pallas step: "
                      f"{fwd}")
            log(f"      one {key} step: device {device_ms:.3f} ms; the "
                f"port's kernels: "
                + ", ".join(f"{k} {v:.3f} ms" for k, v in sorted(
                    ours.items(), key=lambda kv: -kv[1])))
            for g, gms in sorted(groups.items(), key=lambda kv: -kv[1]):
                log(f"    {gms:9.3f} ms {100 * gms / device_ms:5.1f}%  {g}")
            speed[key].update(device_ms=device_ms, groups=groups,
                              kernels=ours)
        del model, step
    summary[f"{label}_train_speed"] = speed


def run_entry_point(args, timeout=600, module="agcn_tpu_torch.main",
                    stdout=False, kernels=False):
    """`python -m <module> <args>` in a subprocess, run through runpy as
    `-m` runs it, which then prints the calls of the port's C host kernels
    (agcn_tpu_torch/native) as its last line, with `kernels` also the
    launch counts of the port's CUDA kernels in that process; the rest of
    its output goes to this run's log, and a failure fails the phase.
    Returns those counts (with `stdout`, and the lines printed before
    them)."""
    launches = ("from agcn_tpu_torch.ops.kernels import gcn_fused, "
                "gcn_kernel, logits_kernel\n"
                "counts.update(gcn_fwd_round_agg="
                "gcn_fused.adaptive_gcn_pallas.launches, gcn_fwd_fp32_agg="
                "gcn_kernel.fused_gcn.launches, gcn_bwd="
                "gcn_fused.gcn_backward.launches, logits="
                "logits_kernel.attention_logits_pallas.launches)\n"
                if kernels else "")
    code = ("import json, runpy, sys\n"
            f"sys.argv = [{module!r}] + {list(args)!r}\n"
            f"runpy.run_module({module!r}, run_name='__main__', "
            "alter_sys=True)\n"
            "from agcn_tpu_torch import native\n"
            "counts = {'parse_skeleton': native.parse_skeleton.calls,"
            " 'pre_normalize': native.pre_normalize.calls,"
            " 'flatten_persons': native.flatten_persons.calls}\n"
            + launches + "print(json.dumps(counts))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=timeout)
    lines = proc.stdout.splitlines()
    tail = (lines[:-1] + proc.stderr.splitlines())[-8:]
    for ln in tail:
        log(f"      {ln}")
    check(proc.returncode == 0,
          f"{module} {' '.join(args)} exited {proc.returncode}")
    counts = json.loads(lines[-1])
    return (counts, lines[:-1]) if stdout else counts


def serve_checkpoint(np, tmp, cfg_path, weights, max_frame=SEQ,
                     normalize_calls=1, v=25):
    """`python -m agcn_tpu_torch.infer --serve 16 --pipeline --max-frame
    <max_frame>` on 16 recordings (V joints) of 4 ticks with the trainer's
    checkpoint `weights`: every stream answered at every tick,
    `normalize_calls` C++ pre_normalize calls a tick (one for the batched
    dense prep, one a stream for SGN's per-stream rows)."""
    rec = os.path.join(tmp, "recordings")
    os.makedirs(rec)
    seq = make_streams(np, v)[:, :4 * TICK_FRAMES]
    for sid in range(STREAMS):
        np.save(os.path.join(rec, f"cam{sid:02d}.npy"),
                np.transpose(seq[sid, :, :, 0], (3, 0, 2, 1)))
    counts, lines = run_entry_point(
        ["--config", cfg_path, "--weights", weights, "--input", rec,
         "--serve", str(STREAMS), "--pipeline", "--timing", "--interval",
         str(TICK_FRAMES), "--max-frame", str(max_frame)],
        module="agcn_tpu_torch.infer", stdout=True)
    answers = [ln for ln in lines if ln.startswith("[cam")]
    ticks = [ln for ln in lines if ln.startswith("tick:")]
    log(f"      python -m agcn_tpu_torch.infer --serve {STREAMS} on the "
        f"checkpoint: {len(answers)} answers, {len(ticks)} ticks, "
        f"{counts['pre_normalize']} C++ pre_normalize calls")
    check(len(answers) == STREAMS * 4 and len(ticks) == 4
          and counts["pre_normalize"] == 4 * normalize_calls,
          f"the serving CLI gave {len(answers)} answers in {len(ticks)} "
          f"ticks ({counts})")
    return dict(answers=len(answers), ticks=ticks, calls=counts)


def read_metrics(path):
    with open(path) as f:
        return [json.loads(ln) for ln in f if ln.strip()]


def phase_train_cli(np, summary, config, label, resume=True,
                    formulation="pallas", launches_per_step=(2 * LAYERS,
                                                             LAYERS),
                    serve=False, max_frame=SEQ, test_config=None, steps=2,
                    in_process=False, **model_args):
    """(b) The entry point on a config derived from the recipe `config`:
    synthetic data, batch 64, T=300, bf16, `formulation` (none for a model
    without one) and `model_args`. Train and evaluate one epoch of `steps`
    steps and save; with `resume`, resume from that checkpoint for a
    second epoch; `--phase test` on the last checkpoint (the entry point's
    `main` in this process: another interpreter would add its start) must
    reproduce the run's last top-1. Each step must launch gcn_fwd and
    gcn_bwd `launches_per_step` times. With `serve`, `python -m
    agcn_tpu_torch.infer --serve 16 --max-frame <max_frame>` serves that
    checkpoint to 16 recordings, 4 ticks each. With `test_config`,
    `--phase test` runs that recipe (its test feeder pointed at the
    data), else the training config. With `in_process`, the training
    epochs run through the entry point's `main` in this process too (no
    interpreter start). The data has the recipe's joint count."""
    import pickle

    import yaml

    from agcn_tpu_torch.main import main as entry_point

    with open(config) as f:
        recipe = yaml.safe_load(f)
    v = recipe["model_args"].get("num_point", 25)
    epochs = 2 if resume else 1

    def train(args):
        if not in_process:
            return run_entry_point(args)
        with contextlib.redirect_stdout(io.StringIO()):
            entry_point(args)

    with tempfile.TemporaryDirectory() as tmp:
        paths = {}
        for split, n in (("train", steps * TRAIN_BATCH),
                         ("val", TRAIN_BATCH)):
            x, y = train_batch(np, n, SEED + 9 + n, v=v)
            paths[split] = (os.path.join(tmp, f"{split}_data.npy"),
                            os.path.join(tmp, f"{split}_label.pkl"))
            np.save(paths[split][0], x)
            with open(paths[split][1], "wb") as f:
                pickle.dump(([f"{split}{i}" for i in range(n)],
                             y.tolist()), f)
        work = os.path.join(tmp, "work")
        recipe.update(
            work_dir=work, batch_size=TRAIN_BATCH,
            test_batch_size=TRAIN_BATCH, num_epoch=1, num_worker=2,
            log_interval=1,
            save_interval=1, eval_interval=1, show_topk=[1, 5],
            model_args=dict(recipe["model_args"], **model_args,
                            **({"formulation": formulation} if formulation
                               else {})),
            train_feeder_args=dict(recipe["train_feeder_args"],
                                   data_path=paths["train"][0],
                                   label_path=paths["train"][1]),
            test_feeder_args=dict(recipe["test_feeder_args"],
                                  data_path=paths["val"][0],
                                  label_path=paths["val"][1]))
        cfg_path = os.path.join(tmp, "train.yaml")
        with open(cfg_path, "w") as f:
            yaml.safe_dump(recipe, f)
        ckpt = os.path.join(work, "checkpoints")
        log(f"  {label} (b) train + eval + save, epoch 1")
        train(["--config", cfg_path])
        if resume:
            log("      resume from epoch_1 for epoch 2")
            train(["--config", cfg_path, "--weights",
                   os.path.join(ckpt, "epoch_1.pt"), "--start-epoch", "1",
                   "--num-epoch", "2"])
        test_path = cfg_path
        if test_config:
            with open(test_config) as f:
                test_recipe = yaml.safe_load(f)
            test_recipe.update(
                work_dir=os.path.join(tmp, "test"),
                test_batch_size=TRAIN_BATCH, num_worker=2,
                model_args=dict(test_recipe["model_args"], **model_args),
                test_feeder_args=dict(test_recipe["test_feeder_args"],
                                      data_path=paths["val"][0],
                                      label_path=paths["val"][1]))
            test_path = os.path.join(tmp, "test.yaml")
            with open(test_path, "w") as f:
                yaml.safe_dump(test_recipe, f)
        log(f"      --phase test on epoch_{epochs} "
            f"({os.path.basename(test_config or config)})")
        with contextlib.redirect_stdout(io.StringIO()):
            entry_point(["--config", test_path, "--phase", "test",
                         "--weights", os.path.join(ckpt, f"epoch_{epochs}.pt"),
                         "--work-dir", os.path.join(tmp, "test")])
        metrics = read_metrics(os.path.join(work, "metrics.jsonl"))
        test = read_metrics(os.path.join(tmp, "test", "metrics.jsonl"))
        with open(os.path.join(tmp, "test", "right.txt")) as f:
            right = len(f.readlines())
        if serve:
            served = serve_checkpoint(np, tmp, cfg_path, os.path.join(
                ckpt, f"epoch_{epochs}.pt"), max_frame=max_frame, v=v)
            summary[f"{label}_cli_served"] = served
    trains = [m for m in metrics if m["kind"] == "train"]
    evals = [m for m in metrics if m["kind"] == "eval"]
    check([m["epoch"] for m in trains] == list(range(epochs))
          and [m["epoch"] for m in evals] == list(range(epochs)),
          f"{label} epochs trained / evaluated: {metrics}")
    for m in trains:
        check(math.isfinite(m["loss"]), f"non-finite loss: {m}")
        check(m["steps"] == steps * (m["epoch"] + 1),
              f"optimizer steps after epoch {m['epoch']}: {m['steps']}")
        fwd, bwd = launches_per_step
        check(m["launches"] == {"gcn_fwd_round_agg": steps * fwd,
                                "gcn_fwd_fp32_agg": 0,
                                "gcn_bwd": steps * bwd},
              f"epoch {m['epoch']} launches {m['launches']} for {steps} "
              "steps")
    check(test[-1]["top1"] == evals[-1]["top1"]
          and right == round(test[-1]["top1"] * TRAIN_BATCH),
          f"--phase test top-1 {test[-1]['top1']} != the run's "
          f"{evals[-1]['top1']}")
    log(f"      epochs {[round(m['loss'], 4) for m in trains]} loss, "
        f"{[round(m['seq_per_sec'], 1) for m in trains]} seq/s; eval top-1 "
        f"{evals[-1]['top1']:.4f}, --phase test top-1 "
        f"{test[-1]['top1']:.4f}")
    summary[f"{label}_train_cli"] = dict(train=trains, eval=evals, test=test)


# -- phase 13: the AAGCN transformer recipe (no TPU kernel on its path) --


def reset_launches():
    """Every kernel wrapper's launch count to 0."""
    from agcn_tpu_torch.ops.kernels import (gcn_fused, gcn_kernel,
                                            logits_kernel)

    gcn_fused.adaptive_gcn_pallas.launches = 0
    gcn_kernel.fused_gcn.launches = 0
    gcn_fused.gcn_backward.launches = 0
    logits_kernel.attention_logits_pallas.launches = 0


def all_launches():
    from agcn_tpu_torch.ops.kernels import logits_kernel
    from agcn_tpu_torch.train.trainer import kernel_launches

    return dict(kernel_launches(),
                logits=logits_kernel.attention_logits_pallas.launches)


def transformer_model(torch, cfg, dname, device="cuda", dropout=None):
    """The recipe's AAGCN transformer at full width for T = 300, seeded
    weights, parameters fp32, the backbone in `dname`."""
    from agcn_tpu_torch.models.registry import build_model

    args = dict(cfg.model_args)
    if dropout is not None:
        args["dropout"] = dropout
    return build_model(cfg.model, args, device=device,
                       dtype=None if dname == "float32" else torch.bfloat16,
                       generator=torch.Generator().manual_seed(SEED),
                       num_frame=SEQ)


def phase_transformer_serving(torch, np, summary):
    """test_joint_aagcn_transformer.yaml serving 16 streams in fp32 and
    bf16, BN statistics from a train-mode forward; card against CPU;
    one C++ pre_normalize a tick; no launch of any port kernel."""
    from agcn_tpu_torch.utils.config import load_config

    cfg = load_config(TRANSFORMER_CONFIG)
    args = dict(cfg.model_args)
    ref = transformer_model(torch, cfg, "float32")
    prepare_aagcn_eval(torch, np, ref, dense_streams(np, SEQ), SEED + 1)
    state = {k: v.detach().clone() for k, v in ref.state_dict().items()}
    del ref
    models = {}
    for dname in ("float32", "bfloat16"):
        m = transformer_model(torch, cfg, dname)
        m.load_state_dict(state, strict=True)
        models[dname] = m.eval()
    reset_launches()
    forwards, card_logits, x_check = serve_streams(
        torch, np, models, summary, "transformer", args["num_class"])
    launches = all_launches()
    log(f"  transformer launches {launches} for {forwards} forwards (this "
        "path runs no port kernel, as in the JAX package)")
    check(not any(launches.values()),
          f"the transformer's serving path launched {launches}")
    check_against_cpu(torch, np, cfg.model, args, state, x_check,
                      card_logits, summary, "transformer")
    summary.update(transformer_launches=launches,
                   transformer_forwards=forwards)
    return models, x_check


def phase_transformer_train_vs_cpu(torch, np, cfg, summary):
    """(a) One fp32 step at batch 4 with dropout 0, card against CPU (the
    card replaying the CPU's ReLU masks, as phases 9 and 12, and the
    elements its token max-pooling selected: a near tie picked the other
    way routes a token's gradient to another element and moved the
    lowest layers' gradients 2.7x past the bar; `AmaxProbe`): loss 1e-4
    relative, every gradient 1e-3 of its scale; bf16 loss 5e-2. Then one
    AdamW-LLRD step (llrd_factor 0.8) from the same weights and the card's
    gradients on the card and on the CPU: the parameters within 1e-6 of
    their scale plus 1e-3 of the step, and each LLRD group's largest
    update within 1% of its LR (Adam's first step moves every parameter
    with a gradient by lr x (1 + weight decay x p)), read where |p| < 0.05
    so that the fp32 parameter's rounding stays below 0.1% of it."""
    from agcn_tpu_torch.tools.grad_parity import (AmaxProbe, ReluProbe,
                                                  amax_probe, condition_bn,
                                                  grad_errors, relu_probe)
    from agcn_tpu_torch.train import optim

    x, y = train_batch(np, 4, SEED + 4)
    ref = transformer_model(torch, cfg, "float32", device="cpu",
                            dropout=0.0)
    condition_bn(ref, SEED + 6)
    state = {k: v.detach().clone() for k, v in ref.state_dict().items()}
    del ref
    torch.set_num_threads(os.cpu_count() or 1)
    runs = {"cpu fp32": ("cpu", "float32"), "card fp32": ("cuda", "float32"),
            "card bf16": ("cuda", "bfloat16")}
    out, probes, maxes = {}, {}, {}
    for run, (dev, dname) in runs.items():
        model = transformer_model(torch, cfg, dname, device=dev, dropout=0.0)
        model.load_state_dict(state, strict=True)
        grads = {}

        def keep(m):
            grads.update((n, p.grad.double().cpu().clone())
                         for n, p in m.named_parameters())

        replay = run == "card fp32"
        probes[run] = (ReluProbe(keep_inputs=True) if run == "cpu fp32"
                       else ReluProbe(ref=probes["cpu fp32"]) if replay
                       else ReluProbe())
        maxes[run] = AmaxProbe(ref=maxes["cpu fp32"] if replay else None)
        with relu_probe(probes[run]), amax_probe(maxes[run]):
            loss = make_step(torch, cfg, model, keep=keep)(
                torch.from_numpy(x).to(dev),
                torch.from_numpy(y).to(dev))["loss"].item()
        out[run] = (loss, grads)
        del model
    ref_loss, ref_grads = out["cpu fp32"]
    rel = {k: abs(v[0] - ref_loss) / abs(ref_loss) for k, v in out.items()}
    rows = grad_errors(out["card fp32"][1], ref_grads, 1e-3)
    flip, ties = probes["card fp32"], maxes["card fp32"]
    log(f"  transformer (a) batch 4, dropout 0: loss cpu fp32 {ref_loss:.6f}"
        f", card fp32 {out['card fp32'][0]:.6f} ({rel['card fp32']:.2e}), "
        f"card bf16 {out['card bf16'][0]:.6f} ({rel['card bf16']:.2e}); "
        f"ReLU signs off the cpu's masks {flip.disagree} (inputs at most "
        f"{flip.input_diff:.2e} of their layer's mean |input| from the "
        f"cpu's); max-pool selections off the cpu's {ties.disagree} of "
        f"{ties.maxima}; worst gradients (err / bar, name, err, scale): "
        + "; ".join(f"{r:.2f} {n} {e:.3e} {sc:.3e}" for r, n, e, sc in
                    rows[:3]))
    check(flip.input_diff <= 1e-3,
          f"transformer: the card's ReLU inputs lie far from the CPU's: "
          f"{flip.input_diff}")
    check(ties.disagree <= 1e-4 * ties.maxima,
          f"transformer: {ties.disagree} of {ties.maxima} max-pool "
          "selections differ from the CPU's")
    check(rel["card fp32"] <= 1e-4,
          f"transformer: fp32 card loss off the CPU's: {rel}")
    check(rows[0][0] <= 1.0,
          f"transformer: fp32 card gradients off the CPU's: {rows[0]}")
    check(rel["card bf16"] <= 5e-2,
          f"transformer: bf16 card loss off the CPU's: {rel}")

    # one AdamW-LLRD step on the same gradients, card against CPU, built
    # as the trainer builds it
    llrd_cfg = dataclasses.replace(cfg, optimizer="AdamW-LLRD",
                                   llrd_factor=0.8)
    after, opts = {}, {}
    for dev in ("cuda", "cpu"):
        model = transformer_model(torch, cfg, "float32", device=dev,
                                  dropout=0.0)
        model.load_state_dict(state, strict=True)
        for n, p in model.named_parameters():
            p.grad = out["card fp32"][1][n].float().to(dev)
        opts[dev] = optim.from_config(llrd_cfg, model.named_parameters(),
                                      1)
        opts[dev].step()
        after[dev] = {n: p.detach().double().cpu()
                      for n, p in model.named_parameters()}
        del model
    opt = opts["cuda"]
    lr0 = opt.schedule(0)
    scale_of = {id(p): s for s, g in zip(opt.scales, opt.opt.param_groups)
                for p in g["params"]}
    names = list(after["cuda"])  # named_parameters' order, as opt.params
    scales = [scale_of[id(p)] for p in opt.params]
    worst, groups = 0.0, {}
    for n, s in zip(names, scales):
        p0 = state[n].double()
        # the update where the fp32 parameter's rounding is < 0.1% of it
        small = p0.abs() < 0.05
        if small.any():
            step_max = (after["cuda"][n] - p0)[small].abs().max().item()
            groups[s] = max(groups.get(s, 0.0), step_max)
        bar = 1e-6 * p0.abs().max().item() + 1e-3 * lr0 * s
        worst = max(worst, (after["cuda"][n] - after["cpu"][n]).abs()
                    .max().item() / bar)
    ratios = {s: groups[s] / (lr0 * s) for s in groups}
    log(f"      AdamW-LLRD (factor 0.8) step at lr {lr0:.3e}: card vs cpu "
        f"parameters at most {worst:.3f} of the bar; per LLRD group "
        "largest update / (lr x multiplier): "
        + ", ".join(f"{s:.3f}: {r:.4f}" for s, r in sorted(ratios.items())))
    check(worst <= 1.0, f"transformer AdamW-LLRD: card parameters off the "
                        f"CPU's by {worst:.3f} of the bar")
    check(len(ratios) == cfg.model_args["num_layers"]
          and all(abs(r - 1.0) <= 1e-2 for r in ratios.values()),
          f"transformer AdamW-LLRD group updates {ratios}")
    summary["transformer_train_vs_cpu"] = dict(
        loss={k: v[0] for k, v in out.items()}, loss_rel=rel,
        relu_sign_flips=(flip.disagree, flip.input_diff),
        max_pool_ties=(ties.disagree, ties.maxima),
        card_vs_cpu=[list(r) for r in rows[:5]],
        adamw_llrd=dict(worst_over_bar=worst, group_ratio=ratios, lr=lr0))


def phase_transformer_main_path(torch, np, cfg, summary):
    """(c) Ten bf16 steps of the recipe (AdamW, onecycle, dropout 0.1) at
    batch 64 on one repeated batch: the loss must fall, and no port
    kernel is launched."""
    model = transformer_model(torch, cfg, "bfloat16")
    step = make_step(torch, cfg, model)
    x, y = train_batch(np, TRAIN_BATCH, SEED + 7)
    x, y = torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()
    reset_launches()
    losses = [step(x, y)["loss"] for _ in range(TRAIN_STEPS)]
    losses = [v.item() for v in losses]
    launches = all_launches()
    log(f"  transformer (c) {TRAIN_STEPS} steps on one batch: loss "
        f"{' '.join(f'{v:.3f}' for v in losses)}; launches {launches}")
    check(all(math.isfinite(v) for v in losses), "non-finite loss")
    check(losses[-1] < losses[0],
          f"transformer: the loss did not fall on a repeated batch: {losses}")
    check(not any(launches.values()),
          f"transformer: the training path launched {launches}")
    summary["transformer_train_losses"] = losses
    summary["transformer_train_launches"] = launches


def step_speed(torch, cfg, build, x, y, label):
    """ms per step, seq/s and peak memory at the batch of (x, y): bf16 (5
    timed steps after 2) and fp32 with TF32 off (3 after 1) of the model
    `build(dname)` makes, stepped as the trainer steps it; one bf16 step's
    device time by kernel group."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    speed, batch = {}, x.shape[0]
    for dname, warm, n in (("bfloat16", 2, 5), ("float32", 1, 3)):
        model = build(dname)
        step = make_step(torch, cfg, model)
        for _ in range(warm):
            step(x, y)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(n):
            step(x, y)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / n
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        speed[dname] = dict(ms_per_step=ms, seq_per_s=batch / ms * 1e3,
                            peak_gib=peak, timed_steps=n)
        log(f"  {label} {dname:9s} {ms:8.2f} ms/step "
            f"{batch / ms * 1e3:7.1f} seq/s, peak {peak:.2f} GiB")
        if dname == "bfloat16":
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                step(x, y)
                torch.cuda.synchronize()
            groups = {}
            for ev in prof.events():
                if ev.device_type == DeviceType.CUDA:
                    g = kernel_group(ev.name)
                    groups[g] = groups.get(g, 0.0) + \
                        ev.device_time_total / 1e3
            device_ms = sum(groups.values())
            check(device_ms > 0, "the profiler saw no device time")
            log(f"      one bf16 step: device {device_ms:.3f} ms "
                f"({100 * device_ms / ms:.1f}% of the step's wall time)")
            for g, gms in sorted(groups.items(), key=lambda kv: -kv[1]):
                log(f"    {gms:9.3f} ms {100 * gms / device_ms:5.1f}%  {g}")
            speed[dname].update(device_ms=device_ms, groups=groups)
        del model, step
    return speed


def phase_transformer_speed(torch, np, cfg, summary):
    """(d) ms per step, seq/s and peak memory at batch 64: bf16 (the
    recipe; 5 timed steps after 2) and fp32 with TF32 off (3 after 1);
    one bf16 step's device time by kernel group."""
    x, y = train_batch(np, TRAIN_BATCH, SEED + 8)
    x, y = torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()
    summary["transformer_train_speed"] = step_speed(
        torch, cfg, lambda d: transformer_model(torch, cfg, d), x, y,
        "transformer (d)")


# -- phase 14: the SGN recipe (no TPU kernel on its path) -----------------

SGN_SPLITS = (("train", 128), ("val", 64), ("test", 40))
SGN_CROPS = 5


def sgn_sequences(np, n, seed, v=25):
    """Seeded (n, 300, 2*V*3) two-person sequences of 40-300 frames with
    one-person frames (either slot) and all-zero frames among them, the
    classes set apart by an offset of the first coordinate."""
    rng = np.random.default_rng(seed)
    half = v * 3
    data = np.zeros((n, SEQ, 2 * half), np.float32)
    labels = rng.integers(0, 60, n)
    for i in range(n):
        t = int(rng.integers(40, SEQ + 1))
        seq = rng.standard_normal((t, 2 * half)).astype(np.float32) * 0.3
        seq[rng.random(t) < 0.3, half:] = 0.0   # person 1 absent
        seq[rng.random(t) < 0.1, :half] = 0.0   # person 0 absent
        seq[rng.random(t) < 0.05] = 0.0         # empty frames
        seq[:, 0::3] += 0.02 * labels[i]
        data[i, :t] = seq
    return data, labels


def write_sgn_pickles(np, tmp):
    """The NTU_CV_{train,val,test} data and label pickles of the SGN
    loader; the train split's loader merges val into it."""
    import pickle

    paths = {}
    for k, (split, n) in enumerate(SGN_SPLITS):
        data, labels = sgn_sequences(np, n, SEED + 30 + k)
        paths[split] = (os.path.join(tmp, f"NTU_CV_{split}.pkl"),
                        os.path.join(tmp, f"NTU_CV_{split}_label.pkl"))
        for path, obj in zip(paths[split], (data, labels)):
            with open(path, "wb") as f:
                pickle.dump(obj, f)
    return paths


def sgn_model(torch, cfg, device="cuda", dropout2d=None):
    """The recipe's SGN at full width for its seg, seeded weights."""
    from agcn_tpu_torch.models.registry import build_model

    args = dict(cfg.model_args)
    if dropout2d is not None:
        args["dropout2d"] = dropout2d
    return build_model(cfg.model, args, device=device,
                       generator=torch.Generator().manual_seed(SEED),
                       num_frame=cfg.train_dataloader_args["seg"])


def liven_sgn(torch, model, x, seed):
    """Every unit's w1 random (its init is zero: the G path would add
    exactly nothing; the original SGN's `w`) and every BN's running
    statistics set to its batch statistics in a train-mode forward on `x`
    (numpy), so that eval normalizes as training would: a BN called n
    times in the forward (a shared temporal branch's) took n momentum-0.1
    updates from (0, 1), which leave 0.9^n of the start."""
    from agcn_tpu_torch.ops.norm import BatchNorm

    g = torch.Generator().manual_seed(seed)
    norms = [m for m in model.modules() if isinstance(m, BatchNorm)]
    calls = {id(m): 0 for m in norms}

    def count(m, _):
        calls[id(m)] += 1

    hooks = [m.register_forward_pre_hook(count) for m in norms]
    with torch.no_grad():
        for name, p in model.named_parameters():
            if (name.endswith(".w1.block.conv.conv.weight")
                    or re.fullmatch(r"gcn\d\.w\.cnn\.weight", name)):
                p.copy_((torch.randn(p.shape, generator=g)
                         / math.sqrt(p.shape[1])).to(p.device))
        for m in norms:
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
        model.train()(torch.from_numpy(x).to(next(model.parameters()).device))
        for m in norms:  # undo the updates from (0, 1)
            kept = 0.9 ** calls[id(m)]
            m.running_mean.div_(1.0 - kept)
            m.running_var.sub_(kept).div_(1.0 - kept).clamp_(min=1e-3)
    for h in hooks:
        h.remove()
    model.eval()


def phase_sgn_data(np, tmp, summary):
    """(a) The synthetic pickles; the C++ flatten_persons built, equal to
    the numpy loop on every sequence, and run by the collate; host ms of
    one training collate (64 rows) and one test collate (4 x 5 crops).
    Returns the pickles' paths and one collated batch of each kind."""
    from agcn_tpu_torch import native
    from agcn_tpu_torch.data.feeder import SGNDataset
    from agcn_tpu_torch.data.sgn_collate import SegmentSampler

    t0 = time.perf_counter()
    check(native.available(), "the C++ host kernels did not build (g++)")
    build_s = time.perf_counter() - t0
    paths = write_sgn_pickles(np, tmp)
    train = SGNDataset(*paths["train"], dataset="NTU60-CV-SGN")
    test = SGNDataset(*paths["test"], dataset="NTU60-CV-SGN")
    sampler = SegmentSampler(dataset="NTU60-CV-SGN", seg=20,
                             multi_test=SGN_CROPS)
    frames = 0
    for ds in (train, test):
        for i in range(len(ds)):
            seq = ds[i][0]
            got = native.flatten_persons(seq)
            want = sampler.flatten_persons(seq[seq.any(axis=-1)])
            check(all(np.array_equal(a, b) for a, b in zip(got, want)),
                  f"C++ flatten_persons differs from numpy on sequence {i}")
            frames += len(got[0])
    batch = [train[i] for i in range(TRAIN_BATCH)]
    crops = [test[i] for i in range(4)]
    rng = np.random.default_rng(SEED)
    calls = native.flatten_persons.calls
    train_ms = median_ms(lambda: sampler.collate(batch, rng, train=True))
    test_ms = median_ms(lambda: sampler.collate(crops, rng, multi_crop=True))
    check(native.flatten_persons.calls - calls == 5 * (TRAIN_BATCH + 4),
          "the collate did not run the C++ flatten_persons")
    x, _, y, _ = sampler.collate(batch, rng, train=True)
    x_eval, _, y_eval, _ = sampler.collate(crops, rng, multi_crop=True)
    check(x.shape == (TRAIN_BATCH, 20, 75)
          and x_eval.shape == (4 * SGN_CROPS, 20, 75),
          f"collated shapes {x.shape}, {x_eval.shape}")
    log(f"  sgn (a) C++ host kernels ready in {build_s:.2f} s; "
        f"flatten_persons C++ = numpy on {len(train) + len(test)} "
        f"sequences ({frames} frames out); host collate: train "
        f"{TRAIN_BATCH} rows {train_ms:.2f} ms, test 4 x {SGN_CROPS} crops "
        f"{test_ms:.2f} ms (median of 5)")
    summary["sgn_data"] = dict(train_collate_ms=train_ms,
                               test_collate_ms=test_ms, sequences=len(train)
                               + len(test), frames=frames)
    return paths, (x, y), (x_eval, y_eval)


def phase_sgn_vs_cpu(torch, np, cfg, x_eval, summary):
    """(b) Card against CPU, w1 random and live BN statistics: the eval
    logits of the 4 x 5-crop batch in fp32 (TF32 off) within 1e-3 of the
    logit scale, and one fp32 training step at batch 4 with dropout 0:
    loss 1e-4 relative, every gradient 1e-3 of its scale, the card
    replaying the CPU's ReLU masks and max-pool selections (a max routes a
    gradient to one element; a near tie picked the other way moves it)."""
    from agcn_tpu_torch.tools.grad_parity import (AmaxProbe, ReluProbe,
                                                  amax_probe, grad_errors,
                                                  relu_probe)

    ref = sgn_model(torch, cfg, device="cpu", dropout2d=0.0)
    liven_sgn(torch, ref, x_eval, SEED + 40)
    state = {k: v.detach().clone() for k, v in ref.state_dict().items()}
    torch.set_num_threads(os.cpu_count() or 1)
    with torch.inference_mode():
        want = ref(torch.from_numpy(x_eval)).numpy()
    del ref
    card = sgn_model(torch, cfg, dropout2d=0.0)
    card.load_state_dict(state, strict=True)
    with torch.inference_mode():
        got = card.eval()(torch.from_numpy(x_eval).cuda()).cpu().numpy()
    scale = float(np.abs(want).max())
    logit_err = float(np.abs(got - want).max())
    check(logit_err <= 1e-3 * max(scale, 1.0),
          f"sgn: card logits off the CPU's by {logit_err:.3e}")

    x, y = np.ascontiguousarray(x_eval[::SGN_CROPS]), np.arange(4) * 7 % 60
    out, probes, maxes = {}, {}, {}
    for run, dev in (("cpu fp32", "cpu"), ("card fp32", "cuda")):
        model = sgn_model(torch, cfg, device=dev, dropout2d=0.0)
        model.load_state_dict(state, strict=True)
        grads = {}

        def keep(m):
            grads.update((n, p.grad.double().cpu().clone())
                         for n, p in m.named_parameters())

        replay = run == "card fp32"
        probes[run] = (ReluProbe(ref=probes["cpu fp32"]) if replay
                       else ReluProbe(keep_inputs=True))
        maxes[run] = AmaxProbe(ref=maxes["cpu fp32"] if replay else None)
        with relu_probe(probes[run]), amax_probe(maxes[run]):
            loss = make_step(torch, cfg, model, keep=keep)(
                torch.from_numpy(x).to(dev),
                torch.from_numpy(y).to(dev))["loss"].item()
        out[run] = (loss, grads)
        del model
    ref_loss, ref_grads = out["cpu fp32"]
    rel = abs(out["card fp32"][0] - ref_loss) / abs(ref_loss)
    rows = grad_errors(out["card fp32"][1], ref_grads, 1e-3)
    flip, ties = probes["card fp32"], maxes["card fp32"]
    log(f"  sgn (b) eval logits (4 x {SGN_CROPS} crops) card vs cpu: max err "
        f"{logit_err:.3e} (logit scale {scale:.3f}); one fp32 step at batch "
        f"4, dropout 0: loss cpu {ref_loss:.6f}, card {out['card fp32'][0]:.6f}"
        f" ({rel:.2e}); ReLU signs off the cpu's masks {flip.disagree} "
        f"(inputs at most {flip.input_diff:.2e} of their layer's mean |input|"
        f" from the cpu's); max selections off the cpu's {ties.disagree} of "
        f"{ties.maxima}; worst gradients (err / bar, name, err, scale): "
        + "; ".join(f"{r:.2f} {n} {e:.3e} {sc:.3e}" for r, n, e, sc in
                    rows[:3]))
    check(flip.input_diff <= 1e-3,
          f"sgn: the card's ReLU inputs lie far from the CPU's: "
          f"{flip.input_diff}")
    check(ties.disagree <= 1e-4 * ties.maxima,
          f"sgn: {ties.disagree} of {ties.maxima} max selections differ")
    check(rel <= 1e-4, f"sgn: fp32 card loss off the CPU's: {rel}")
    check(rows[0][0] <= 1.0, f"sgn: fp32 card gradients off the CPU's: "
                             f"{rows[0]}")
    summary["sgn_card_vs_cpu"] = dict(
        logit_err=logit_err, logit_scale=scale, loss_rel=rel,
        relu_sign_flips=(flip.disagree, flip.input_diff),
        max_ties=(ties.disagree, ties.maxima),
        grads=[list(r) for r in rows[:5]])


def phase_sgn_main_path(torch, cfg, train_batch_np, x_eval, summary):
    """(c) Ten Adam steps of the recipe (dropout2d 0.2) at batch 64 on one
    repeated batch: the loss must fall and no port kernel launches; then
    ms per step, seq/s and peak memory (5 timed steps after 2), one step's
    device time by kernel group (torch.profiler) and its busy share, and
    the ms of one 4 x 5-crop eval batch (20 calls after 3)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from agcn_tpu_torch.train import losses
    from agcn_tpu_torch.train.steps import make_eval_step

    x, y = (torch.from_numpy(a).cuda() for a in train_batch_np)
    model = sgn_model(torch, cfg)
    step = make_step(torch, cfg, model)
    reset_launches()
    losses_ = [step(x, y)["loss"] for _ in range(TRAIN_STEPS)]
    losses_ = [v.item() for v in losses_]
    launches = all_launches()
    log(f"  sgn (c) {TRAIN_STEPS} Adam steps (dropout2d "
        f"{cfg.model_args['dropout2d']}) on one batch of {TRAIN_BATCH}: loss "
        f"{' '.join(f'{v:.3f}' for v in losses_)}; launches {launches}")
    check(all(math.isfinite(v) for v in losses_), "sgn: non-finite loss")
    check(losses_[-1] < losses_[0],
          f"sgn: the loss did not fall on a repeated batch: {losses_}")
    check(not any(launches.values()),
          f"sgn: the training path launched {launches}")
    for _ in range(2):
        step(x, y)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(5):
        step(x, y)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / 5
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(x, y)
        torch.cuda.synchronize()
    groups, kernels = {}, 0
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            g = kernel_group(ev.name)
            groups[g] = groups.get(g, 0.0) + ev.device_time_total / 1e3
            kernels += 1
    device_ms = sum(groups.values())
    check(device_ms > 0, "the profiler saw no device time")
    # where the host's time goes (self time under the profiler, which
    # inflates each op's: read the shares)
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    host_ms = sum(e.self_cpu_time_total for e in host) / 1e3
    host_top = [(e.key, e.self_cpu_time_total / 1e3, e.count)
                for e in host[:8]]
    eval_step = make_eval_step(model, losses.build_loss(
        cfg.loss, cfg.model_args["num_class"]), multi_crop=SGN_CROPS)
    xe = torch.from_numpy(x_eval).cuda()
    for _ in range(3):
        eval_step(xe)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        logits, _ = eval_step(xe)
    torch.cuda.synchronize()
    eval_ms = (time.perf_counter() - t0) * 1e3 / 20
    check(tuple(logits.shape) == (4, cfg.model_args["num_class"]),
          f"sgn eval logits {tuple(logits.shape)}")
    log(f"      {ms:.3f} ms/step, {TRAIN_BATCH / ms * 1e3:.1f} seq/s, peak "
        f"{peak:.3f} GiB; one step: device {device_ms:.3f} ms in {kernels} "
        f"kernels ({100 * device_ms / ms:.1f}% of the step's wall time)")
    for g, gms in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"    {gms:9.3f} ms {100 * gms / device_ms:5.1f}%  {g}")
    log(f"      host self time under the profiler {host_ms:.2f} ms; top ops "
        "(ms, calls): " + ", ".join(f"{k} {t:.2f} ({n})"
                                   for k, t, n in host_top))
    log(f"      one eval batch (4 x {SGN_CROPS} crops, crops averaged): "
        f"{eval_ms:.3f} ms")
    summary["sgn_train"] = dict(losses=losses_, launches=launches,
                                ms_per_step=ms,
                                seq_per_s=TRAIN_BATCH / ms * 1e3,
                                peak_gib=peak, device_ms=device_ms,
                                kernels=kernels, groups=groups,
                                host_ms=host_ms, host_top=host_top,
                                eval_ms=eval_ms)
    del model, step


def phase_sgn_cli(torch, np, paths, tmp, summary, sizes=None, batch=None,
                  key="sgn_cli", kinetics=True):
    """(d) `python -m agcn_tpu_torch.main` on a copy of train_sgn.yaml
    pointed at the pickles: one epoch (train + val merged, batch 64 or
    `batch`), eval with multi_test 5 (4 samples x 5 crops a batch) and a
    checkpoint; `--phase test` with a test_sgn.yaml-shaped config on it
    must give the same top-1 and score rows (one a sample, within 1e-5 of
    their scale). The collate runs the C++ flatten_persons; no port kernel
    launches. `sizes` are the (train + val, test) sample counts (phase
    14's pickles by default). Then, with `kinetics`, one full-width
    forward of the Kinetics recipe's shape (V = 18, 400 classes) on the
    card: finite logits. The entry points' metrics go to summary[key]."""
    import pickle

    import yaml

    from agcn_tpu_torch.utils.config import load_config

    with open(SGN_CONFIG) as f:
        recipe = yaml.safe_load(f)
    if batch is not None:
        recipe["batch_size"] = batch
    work = os.path.join(tmp, "work")
    recipe.update(
        work_dir=work, num_epoch=1, num_worker=2, log_interval=1,
        save_interval=1, eval_interval=1, show_topk=[1, 5],
        train_feeder_args=dict(recipe["train_feeder_args"],
                               data_path=paths["train"][0],
                               label_path=paths["train"][1]),
        test_feeder_args=dict(recipe["test_feeder_args"],
                              data_path=paths["test"][0],
                              label_path=paths["test"][1]))
    with open(SGN_TEST_CONFIG) as f:
        test_recipe = yaml.safe_load(f)
    test_recipe.update(
        work_dir=os.path.join(tmp, "test"),
        test_feeder_args=dict(test_recipe["test_feeder_args"],
                              data_path=paths["test"][0],
                              label_path=paths["test"][1]))
    cfgs = {}
    for name, r in (("train", recipe), ("test", test_recipe)):
        cfgs[name] = os.path.join(tmp, f"sgn_{name}.yaml")
        with open(cfgs[name], "w") as f:
            yaml.safe_dump(r, f)
    log("  sgn (d) python -m agcn_tpu_torch.main: train + eval (multi_test "
        f"{SGN_CROPS}) + save, one epoch")
    calls = run_entry_point(["--config", cfgs["train"]])
    ckpt = os.path.join(work, "checkpoints", "epoch_1.pt")
    log("      --phase test (test_sgn.yaml) on epoch_1")
    test_calls = run_entry_point(["--config", cfgs["test"], "--weights",
                                  ckpt])
    metrics = read_metrics(os.path.join(work, "metrics.jsonl"))
    test = read_metrics(os.path.join(tmp, "test", "metrics.jsonl"))
    with open(os.path.join(tmp, "test", "right.txt")) as f:
        right = len(f.readlines())
    scores = []
    for run in (work, os.path.join(tmp, "test")):
        with open(os.path.join(run, "score", "epoch1_val.pkl"), "rb") as f:
            scores.append(np.stack(list(pickle.load(f).values())))
    score_err = float(np.abs(scores[0] - scores[1]).max())
    trains = [m for m in metrics if m["kind"] == "train"]
    evals = [m for m in metrics if m["kind"] == "eval"]
    n_train, n_test = sizes or (
        dict(SGN_SPLITS)["train"] + dict(SGN_SPLITS)["val"],
        dict(SGN_SPLITS)["test"])
    check(len(trains) == 1 and len(evals) == 1
          and trains[0]["steps"] == n_train // recipe["batch_size"]
          and math.isfinite(trains[0]["loss"]),
          f"sgn entry point: {metrics}")
    check(not any(trains[0]["launches"].values()),
          f"sgn entry point launched {trains[0]['launches']}")
    # one C++ call a sequence per epoch: train + val (whole batches),
    # then 5-crop eval
    steps = n_train // recipe["batch_size"]
    check(calls["flatten_persons"] == steps * recipe["batch_size"] + n_test
          and test_calls["flatten_persons"] == n_test,
          f"C++ flatten_persons calls {calls}, {test_calls}")
    check(test[-1]["top1"] == evals[-1]["top1"]
          and right == round(test[-1]["top1"] * n_test),
          f"--phase test top-1 {test[-1]['top1']} != the run's "
          f"{evals[-1]['top1']}")
    # one score row a test sample (its crops averaged), the same in both
    # runs (one card, the same weights and crops)
    check(scores[0].shape == scores[1].shape == (
        n_test, recipe["model_args"]["num_class"])
          and score_err <= 1e-5 * float(np.abs(scores[0]).max()),
          f"sgn scores: shapes {scores[0].shape}, {scores[1].shape}, "
          f"max difference {score_err:.3e}")
    log(f"      loss {trains[0]['loss']:.4f}, {trains[0]['seq_per_sec']:.1f} "
        f"seq/s (host-fed epoch of {trains[0]['steps']} steps); eval top-1 "
        f"{evals[-1]['top1']:.4f} in {evals[-1]['seconds']:.2f} s, --phase "
        f"test top-1 {test[-1]['top1']:.4f}, its {n_test} score rows within "
        f"{score_err:.2e} of the run's; C++ flatten_persons calls "
        f"{calls['flatten_persons']} + {test_calls['flatten_persons']}")
    summary[key] = dict(train=trains, eval=evals, test=test, calls=calls,
                        test_calls=test_calls)
    if not kinetics:
        return
    kcfg = load_config(SGN_KINETICS_CONFIG)
    kin = sgn_model(torch, kcfg).eval()
    xk = torch.from_numpy(np.random.default_rng(SEED).standard_normal(
        (4, 20, 18 * 3)).astype(np.float32)).cuda()
    with torch.inference_mode():
        logits = kin(xk)
    check(tuple(logits.shape) == (4, 400)
          and bool(torch.isfinite(logits).all()),
          f"kinetics SGN logits {tuple(logits.shape)}")
    log(f"      kinetics shape (V = 18, 400 classes): finite logits "
        f"{tuple(logits.shape)}")


def phase_sgn(torch, np, summary):
    """Phase 14: (a)-(d) above, in one temporary directory."""
    from agcn_tpu_torch.utils.config import load_config

    t14 = time.perf_counter()
    cfg = load_config(SGN_CONFIG)
    with tempfile.TemporaryDirectory() as tmp:
        paths, train_batch_np, (x_eval, _) = phase_sgn_data(np, tmp,
                                                            summary)
        phase_sgn_vs_cpu(torch, np, cfg, x_eval, summary)
        phase_sgn_main_path(torch, cfg, train_batch_np, x_eval, summary)
        phase_sgn_cli(torch, np, paths, tmp, summary)
    summary["sgn_phase_s"] = time.perf_counter() - t14
    log(f"  phase 14 in {summary['sgn_phase_s']:.1f} s")


# -- phase 15: the trainer's run knobs -------------------------------------

SAM_RHO = 0.05
KNOB_BATCH = 8          # (b): 8 SAM steps an epoch of 64 sequences
SGN_KNOB_SPLITS = (("train", 512), ("val", 64), ("test", 40))


def phase_sam_step(torch, np, cfg, summary):
    """(a) One fp32 SAM step (rho 0.05) of the full-width `pallas` AGCN at
    batch 4, T=300, on the card with the kernels against the same step
    with their plain versions, the kernel run replaying the plain run's
    ReLU masks (phase 9's replay: its ReLU inputs within 1e-3 of their
    layer's mean |input| of the plain run's). Every gradient the update
    takes (pass two's) within 1e-3 of its tensor's scale; 40 gcn_fwd and
    20 gcn_bwd launches (two passes of 20 and 10); the BN running
    statistics those of one train-mode forward of pass one alone (within
    1e-6 of their scale, `num_batches_tracked` 1)."""
    from agcn_tpu_torch.ops.norm import BatchNorm
    from agcn_tpu_torch.tools.grad_parity import (
        ReluProbe, condition_bn, grad_errors, plain_versions_on_the_card,
        relu_probe)

    x, y = train_batch(np, 4, SEED + 40)
    x, y = torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()
    ref = train_model(torch, cfg, "pallas", "float32")
    condition_bn(ref, SEED + 41)
    state = {k: v.detach().clone() for k, v in ref.state_dict().items()}
    del ref
    out, probes = {}, {}
    for run in ("plain", "kernels"):
        model = train_model(torch, cfg, "pallas", "float32")
        model.load_state_dict(state, strict=True)
        grads = {}

        def keep(m):
            grads.update((n, p.grad.double().cpu().clone())
                         for n, p in m.named_parameters())

        probes[run] = (ReluProbe(keep_inputs=True) if run == "plain"
                       else ReluProbe(ref=probes["plain"]))
        step = make_step(torch, cfg, model, keep=keep, sam_rho=SAM_RHO)
        reset_launches()
        with contextlib.ExitStack() as scopes:
            scopes.enter_context(relu_probe(probes[run]))
            if run == "plain":
                scopes.enter_context(plain_versions_on_the_card())
            loss = step(x, y)["loss"].item()
        torch.cuda.synchronize()
        out[run] = (loss, grads, all_launches(), model)
    kern = grad_errors(out["kernels"][1], out["plain"][1], 1e-3)
    launches = out["kernels"][2]
    # pass one alone: a train-mode forward at the step's starting state
    first = train_model(torch, cfg, "pallas", "float32")
    first.load_state_dict(state, strict=True)
    with torch.no_grad(), relu_probe(ReluProbe(ref=probes["plain"])):
        first.train()(x)
    want = dict(first.named_buffers())
    stat_err, counted = 0.0, set()
    for name, mod in out["kernels"][3].named_modules():
        if isinstance(mod, BatchNorm):
            counted.add(int(mod.num_batches_tracked))
            for buf in ("running_mean", "running_var"):
                w = want[f"{name}.{buf}"]
                stat_err = max(stat_err, float(
                    (getattr(mod, buf) - w).abs().max()
                    / w.abs().max().clamp(min=1e-30)))
    rel = abs(out["kernels"][0] - out["plain"][0]) / abs(out["plain"][0])
    probe = probes["kernels"]
    log(f"  sam (a) batch 4: loss {out['kernels'][0]:.6f} (plain versions "
        f"{out['plain'][0]:.6f}, {rel:.2e}); ReLU signs off the plain run's "
        f"masks {probe.disagree} (inputs at most {probe.input_diff:.2e} of "
        f"their layer's mean |input|); launches {launches}; BN statistics "
        f"{stat_err:.2e} of their scale from pass one alone, counted "
        f"{sorted(counted)} time(s)")
    log("      kernels vs plain: worst gradients (err / bar, name, err, "
        "scale): " + "; ".join(f"{r:.2f} {n} {e:.3e} {sc:.3e}"
                               for r, n, e, sc in kern[:3]))
    check(probe.input_diff <= 1e-3,
          f"sam: the kernel run's ReLU inputs lie far from the plain "
          f"run's: {probe.input_diff}")
    check(kern[0][0] <= 1.0 and rel <= 1e-4,
          f"sam: the kernel step's gradients off the plain versions': "
          f"{kern[0]}, loss {rel}")
    check(launches["gcn_fwd_round_agg"] == 4 * LAYERS
          and launches["gcn_bwd"] == 2 * LAYERS
          and launches["gcn_fwd_fp32_agg"] == 0,
          f"sam: launches of one step {launches}")
    check(counted == {1} and stat_err <= 1e-6,
          f"sam: BN statistics moved by pass two ({stat_err}, counted "
          f"{counted})")
    summary["sam_step"] = dict(loss={k: v[0] for k, v in out.items()},
                               kernels_vs_plain=[list(r) for r in kern[:5]],
                               launches=launches, bn_stat_err=stat_err,
                               relu=[probe.disagree, probe.input_diff])


def phase_sam_speed(torch, np, cfg, tmp, summary, warm=2, iters=3):
    """(a') ms a step, seq/s and peak memory of the recipe's bf16 `pallas`
    AGCN at batch 64, T=300, plain SGD against SAM (2 warm-up, 3 timed
    steps each, one repeated batch), and the device time of one SAM step
    by kernel group with the host ms of that profiled step. Then the
    host costs of the other knobs on that model: a checkpoint saved
    synchronously, and asynchronously twice (each: the call's return,
    after the snapshot's device-to-host copies, then the wait for the
    background write), and one TensorBoard scalar (the mean of 300)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from agcn_tpu_torch.train import checkpoint as ckpt
    from agcn_tpu_torch.utils.tb_writer import SummaryWriter

    x, y = train_batch(np, TRAIN_BATCH, SEED + 42)
    x, y = torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()
    speed = {}
    for name, rho in (("sgd", 0.0), ("sam", SAM_RHO)):
        model = train_model(torch, cfg, "pallas", "bfloat16")
        step = make_step(torch, cfg, model, sam_rho=rho)
        for _ in range(warm):
            step(x, y)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(iters):
            step(x, y)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / iters
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        speed[name] = dict(ms_per_step=ms, seq_per_s=TRAIN_BATCH / ms * 1e3,
                           peak_gib=peak)
        if name == "sam":
            t0 = time.perf_counter()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                step(x, y)
                torch.cuda.synchronize()
            speed[name]["profiled_ms"] = (time.perf_counter() - t0) * 1e3
            groups = {}
            for ev in prof.events():
                if ev.device_type == DeviceType.CUDA:
                    g = kernel_group(ev.name)
                    groups[g] = groups.get(g, 0.0) + ev.device_time_total / 1e3
            speed[name].update(device_ms=sum(groups.values()), groups=groups)
            opt_state = step.optimizer.state_dict()
            saves = {}
            # two async saves: the second as every later save of a run
            for mode in ("sync", "async", "async_again"):
                t0 = time.perf_counter()
                ckpt.save_checkpoint(os.path.join(tmp, f"save_{mode}"), model,
                                     opt_state, 1, 0, 1,
                                     async_save=mode != "sync")
                saves[mode] = (time.perf_counter() - t0) * 1e3
                t0 = time.perf_counter()
                ckpt.wait_for_checkpoints()
                saves[f"{mode}_write"] = (time.perf_counter() - t0) * 1e3
            writer = SummaryWriter(os.path.join(tmp, "event_cost"))
            t0 = time.perf_counter()
            for i in range(300):
                writer.add_scalar("train/loss", 1.0 / (i + 1), i)
            writer.close()
            speed["host_ms"] = dict(
                saves, event_scalar=(time.perf_counter() - t0) * 1e3 / 300)
        del model, step
    sam, sgd = speed["sam"], speed["sgd"]
    ratio = sam["ms_per_step"] / sgd["ms_per_step"]
    log(f"  sam (a') bf16 batch {TRAIN_BATCH}: SGD {sgd['ms_per_step']:.2f} "
        f"ms/step ({sgd['seq_per_s']:.1f} seq/s, peak {sgd['peak_gib']:.2f} "
        f"GiB), SAM {sam['ms_per_step']:.2f} ms/step ({sam['seq_per_s']:.1f} "
        f"seq/s, peak {sam['peak_gib']:.2f} GiB), {ratio:.3f}x; "
        f"one SAM step's device time {sam['device_ms']:.3f} ms: " + ", ".join(
            f"{g} {v:.3f}" for g, v in sorted(sam["groups"].items(),
                                              key=lambda kv: -kv[1])[:5]))
    host = speed["host_ms"]
    log(f"      host ms: the profiled SAM step {sam['profiled_ms']:.2f}; a "
        f"checkpoint saved {host['sync']:.2f} synchronously, "
        f"{host['async']:.2f} until an async save returns (then "
        f"{host['async_write']:.2f} of background write), the next "
        f"{host['async_again']:.2f} (then {host['async_again_write']:.2f}); "
        f"one event scalar {host['event_scalar']:.4f}")
    check(sam["device_ms"] > 0, "sam: the profiler saw no device time")
    summary["sam_speed"] = speed


def masked_crc32c(data):
    """TFRecord's masked CRC-32C (Castagnoli), bit by bit."""
    crc = 0xFFFFFFFF
    for byte in data:
        crc ^= byte
        for _ in range(8):
            crc = (crc >> 1) ^ (0x82F63B78 & -(crc & 1))
    crc ^= 0xFFFFFFFF
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def proto_fields(buf):
    """(field, wire type, value) of one protobuf message."""
    pos = 0

    def varint():
        nonlocal pos
        out = shift = 0
        while True:
            b = buf[pos]
            pos += 1
            out |= (b & 0x7F) << shift
            shift += 7
            if b < 0x80:
                return out

    while pos < len(buf):
        key = varint()
        field, wire = key >> 3, key & 7
        if wire == 0:
            value = varint()
        elif wire in (1, 5):
            size = 8 if wire == 1 else 4
            value, pos = buf[pos:pos + size], pos + size
        elif wire == 2:
            size = varint()
            value, pos = buf[pos:pos + size], pos + size
        else:
            raise ValueError(f"protobuf wire type {wire}")
        yield field, wire, value


def read_events(directory):
    """(tag, step, value) of every scalar in the TensorBoard event files of
    `directory` (TFRecords of Event protobufs), each record's length and
    payload checked against their masked CRC-32C. The card's machine has
    no TensorBoard, so the reader is this one."""
    import struct

    out = []
    for name in sorted(os.listdir(directory)):
        with open(os.path.join(directory, name), "rb") as f:
            data = f.read()
        pos = 0
        while pos < len(data):
            header = data[pos:pos + 8]
            (size,) = struct.unpack("<Q", header)
            (crc_h,) = struct.unpack("<I", data[pos + 8:pos + 12])
            payload = data[pos + 12:pos + 12 + size]
            (crc_p,) = struct.unpack("<I", data[pos + 12 + size:
                                               pos + 16 + size])
            check(masked_crc32c(header) == crc_h
                  and masked_crc32c(payload) == crc_p,
                  f"event file {name}: a record's CRC does not match")
            pos += 16 + size
            step = 0
            values = []
            for field, _, value in proto_fields(payload):
                if field == 2:
                    step = value
                elif field == 5:  # Summary
                    for f_v, _, v in proto_fields(value):
                        if f_v == 1:  # Summary.Value
                            items = dict((f, x) for f, _, x in
                                         proto_fields(v))
                            values.append((
                                items[1].decode(),
                                struct.unpack("<f", items[2])[0]))
            out.extend((tag, step, v) for tag, v in values)
    return out


def trace_kernels(path):
    """The names of the port's gcn kernels in a Chrome trace."""
    with open(path) as f:
        trace = json.load(f)
    return {m[0] for e in trace.get("traceEvents", [])
            for m in [re.search(r"gcn_\w+_kernel", str(e.get("name", "")))]
            if m}


def phase_knobs_cli(np, tmp, summary):
    """(b) `python -m agcn_tpu_torch.main` on train_joint.yaml with
    `formulation: pallas`, `optimizer: SAM` (rho 0.05), `profiler`,
    `async_checkpoint`, 64 synthetic sequences of T=300 at batch 8 (8 steps
    an epoch), one epoch; then the same work dir with `auto_resume` for a
    second epoch. Each epoch 40 gcn_fwd and 20 gcn_bwd launches a step
    (metrics.jsonl); the first run's Chrome trace of steps 2-7 names
    gcn_fwd's and gcn_bwd's kernels; the event files parse (CRCs checked)
    and carry the log's scalars; the resumed run (the profiler off)
    continues at epoch 1 from the checkpoint's step 8."""
    import pickle

    import yaml

    with open(TRAIN_CONFIG) as f:
        recipe = yaml.safe_load(f)
    paths = {}
    for split, n in (("train", 8 * KNOB_BATCH), ("val", 16)):
        x, y = train_batch(np, n, SEED + 50 + n)
        paths[split] = (os.path.join(tmp, f"knob_{split}.npy"),
                        os.path.join(tmp, f"knob_{split}.pkl"))
        np.save(paths[split][0], x)
        with open(paths[split][1], "wb") as f:
            pickle.dump(([f"{split}{i}" for i in range(n)], y.tolist()), f)
    work = os.path.join(tmp, "knobs")
    recipe.update(
        work_dir=work, batch_size=KNOB_BATCH, test_batch_size=16,
        num_epoch=1, num_worker=2, log_interval=1, save_interval=1,
        eval_interval=1, show_topk=[1, 5], optimizer="SAM", sam_rho=SAM_RHO,
        profiler=True, async_checkpoint=True,
        model_args=dict(recipe["model_args"], formulation="pallas"),
        train_feeder_args=dict(recipe["train_feeder_args"],
                               data_path=paths["train"][0],
                               label_path=paths["train"][1]),
        test_feeder_args=dict(recipe["test_feeder_args"],
                              data_path=paths["val"][0],
                              label_path=paths["val"][1]))
    cfg_path = os.path.join(tmp, "knobs.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(recipe, f)
    log("  knobs (b) python -m agcn_tpu_torch.main: SAM, profiler, async "
        "checkpoints, one epoch of 8 steps at batch 8")
    t0 = time.perf_counter()
    run_entry_point(["--config", cfg_path])
    first_s = time.perf_counter() - t0
    log("      the same work dir with auto_resume, --num-epoch 2 (the "
        "profiler off: one trace is enough)")
    t0 = time.perf_counter()
    run_entry_point(["--config", cfg_path, "--auto-resume", "true",
                     "--num-epoch", "2", "--profiler", "false"])
    second_s = time.perf_counter() - t0
    metrics = read_metrics(os.path.join(work, "metrics.jsonl"))
    trains = [m for m in metrics if m["kind"] == "train"]
    evals = [m for m in metrics if m["kind"] == "eval"]
    with open(os.path.join(work, "log.txt")) as f:
        log_text = f.read()
    check([m["epoch"] for m in trains] == [0, 1]
          and [m["steps"] for m in trains] == [8, 16]
          and [m["epoch"] for m in evals] == [0, 1],
          f"knobs: epochs and steps {metrics}")
    for m in trains:
        check(math.isfinite(m["loss"]), f"knobs: non-finite loss {m}")
        check(m["launches"] == {"gcn_fwd_round_agg": 8 * 4 * LAYERS,
                                "gcn_fwd_fp32_agg": 0,
                                "gcn_bwd": 8 * 2 * LAYERS},
              f"knobs: epoch {m['epoch']} launches {m['launches']} for 8 "
              "SAM steps")
    resumed = (f"auto-resumed from {work}/checkpoints/epoch_1.pt "
               "(continuing at epoch 1)")
    check(resumed in log_text
          and "optimizer state resumed at step 8" in log_text,
          "knobs: the second run did not auto-resume from epoch_1.pt")
    saved = sorted(os.listdir(os.path.join(work, "checkpoints")))
    check(saved == ["epoch_1.pt", "epoch_2.pt"], f"knobs: checkpoints {saved}")
    # the traces: one a run, of steps 2-7 of its first epoch
    trace_dir = os.path.join(work, "trace")
    traces = sorted(os.listdir(trace_dir))
    check(traces == ["epoch0_steps2-7.pt.trace.json"],
          f"knobs: traces {traces}")
    trace_mb = os.path.getsize(os.path.join(trace_dir, traces[0])) / 2 ** 20
    names = [trace_kernels(os.path.join(trace_dir, t)) for t in traces]
    need = {"gcn_fwd_mma_kernel", "gcn_u_kernel", "gcn_dw_mma_kernel",
            "gcn_da1_mma_kernel"}
    check(all(need <= n for n in names),
          f"knobs: the traces' gcn kernels {names}")
    check(log_text.count(f"profiler trace written to {trace_dir}") == 1,
          "knobs: the profiler's log lines")
    # the event files: the log's scalars, keyed by the optimizer's count
    train_ev = read_events(os.path.join(work, "event", "train"))
    val_ev = read_events(os.path.join(work, "event", "val"))
    step_losses = [float(v) for v in re.findall(
        r"epoch \d+ step \d+/\d+ loss ([-\d.]+)", log_text)]
    ev_losses = [(s, v) for t, s, v in train_ev if t == "train/loss"]
    check([s for s, _ in ev_losses] == list(range(1, 17))
          and all(abs(v - w) <= 5e-5 for (_, v), w in
                  zip(ev_losses, step_losses))
          and len(step_losses) == 16,
          f"knobs: train/loss events {ev_losses} against the log "
          f"{step_losses}")
    check([(s, v) for t, s, v in train_ev if t == "train/epoch"]
          == [(8, 0.0), (16, 1.0)]
          and [abs(v - trains[i]["loss"]) <= 1e-6 * abs(trains[i]["loss"])
               for i, v in enumerate(v for s, v in ev_losses
                                     if s in (8, 16))] == [True, True],
          f"knobs: train/epoch events and the epochs' losses: {train_ev}")
    check([(s, round(v, 6)) for t, s, v in val_ev if t == "val/top1"]
          == [(8 * (e["epoch"] + 1), round(e["top1"], 6)) for e in evals],
          f"knobs: val/top1 events {val_ev} against {evals}")
    log(f"      epochs {[round(m['loss'], 4) for m in trains]} loss, "
        f"{[round(m['seconds'] / 8 * 1e3, 2) for m in trains]} ms a SAM "
        f"step (host clock; epoch 0 profiled, epoch 1 not); launches a step "
        f"{ {k: v // 8 for k, v in trains[0]['launches'].items()} }; the "
        f"trace ({trace_mb:.1f} MiB) names {sorted(names[0])}; "
        f"{len(train_ev)} + {len(val_ev)} scalar events read back; the runs "
        f"{first_s:.1f} s and {second_s:.1f} s")
    summary["knobs_cli"] = dict(train=trains, eval=evals, traces=traces,
                                trace_kernels=sorted(names[0]),
                                trace_mib=trace_mb, run_s=[first_s, second_s],
                                events=len(train_ev) + len(val_ev))
    return trains


def phase_sgn_knobs(np, tmp, smi, summary):
    """(c) The two SGN recipes through the entry point as shipped (model
    and optimizer), on synthetic SGN pickles of phase 14's kind with more
    training sequences (512 + 64 merged: 9 steps at batch 64), two epochs
    each: train_sgn_fsim_sam.yaml (SAM, fsim_mode 1; `python -m
    agcn_tpu_torch.main`) with a finite fsim in training and eval;
    train_sgn_scan8.yaml (each epoch one group of 8 steps, then one single
    step) equal to the same run with steps_per_call 1 within 1e-5 of each
    tensor's scale (the last step's loss, every parameter), the two run
    in this process by `agcn_tpu_torch.main.main`, one after the other,
    with cuDNN's deterministic algorithms. Two epochs each, evaluated and saved after the second; ms a step from
    each epoch's host clock (the first holds the warm-up)."""
    import pickle

    import torch
    import yaml

    from agcn_tpu_torch.main import main as entry_point

    paths = {}
    for k, (split, n) in enumerate(SGN_KNOB_SPLITS):
        data, labels = sgn_sequences(np, n, SEED + 60 + k)
        paths[split] = (os.path.join(tmp, f"NTU_CV_{split}.pkl"),
                        os.path.join(tmp, f"NTU_CV_{split}_label.pkl"))
        for path, obj in zip(paths[split], (data, labels)):
            with open(path, "wb") as f:
                pickle.dump(obj, f)
    runs = {}
    for name, config, over in (
            ("fsim_sam", SGN_FSIM_SAM_CONFIG, {}),
            ("scan8", SGN_SCAN8_CONFIG, {}),
            ("scan1", SGN_SCAN8_CONFIG, {"steps_per_call": 1})):
        with open(config) as f:
            recipe = yaml.safe_load(f)
        work = os.path.join(tmp, name)
        # the recipes' own log cadence (log_interval 100: no step of the
        # epoch waits for its metrics, in either run)
        recipe.update(
            work_dir=work, num_epoch=2, num_worker=2,
            save_interval=2, eval_interval=2, show_topk=[1, 5],
            train_feeder_args=dict(recipe["train_feeder_args"],
                                   data_path=paths["train"][0],
                                   label_path=paths["train"][1]),
            test_feeder_args=dict(recipe["test_feeder_args"],
                                  data_path=paths["test"][0],
                                  label_path=paths["test"][1]), **over)
        cfg_path = os.path.join(tmp, f"{name}.yaml")
        with open(cfg_path, "w") as f:
            yaml.safe_dump(recipe, f)
        if name == "fsim_sam":
            log(f"  sgn knobs (c) python -m agcn_tpu_torch.main: {name}")
            run_entry_point(["--config", cfg_path])
        else:
            # the same entry point in this process (two more interpreters
            # would take ~14 s each to reach the card), with cuDNN's
            # deterministic algorithms: a weight gradient summed by
            # atomics differs from run to run in its last bits, and Adam
            # turns such bits of a near-zero gradient into +-lr steps
            log(f"  sgn knobs (c) agcn_tpu_torch.main.main in this "
                f"process, cuDNN deterministic: {name}")
            deterministic = torch.backends.cudnn.deterministic
            torch.backends.cudnn.deterministic = True
            try:
                with contextlib.redirect_stdout(io.StringIO()):
                    entry_point(["--config", cfg_path])
            finally:
                torch.backends.cudnn.deterministic = deterministic
        metrics = read_metrics(os.path.join(work, "metrics.jsonl"))
        runs[name] = ([m for m in metrics if m["kind"] == "train"],
                      [m for m in metrics if m["kind"] == "eval"][0], work)
    steps = (SGN_KNOB_SPLITS[0][1] + SGN_KNOB_SPLITS[1][1]) // TRAIN_BATCH
    for name, (trains, ev, _) in runs.items():
        check([m["steps"] for m in trains] == [steps, 2 * steps]
              and all(math.isfinite(m["loss"])
                      and not any(m["launches"].values()) for m in trains),
              f"sgn knobs {name}: {trains}")
    fsim = (runs["fsim_sam"][0][-1].get("fsim"),
            runs["fsim_sam"][1].get("fsim"))
    check(all(v is not None and math.isfinite(v) and v > 0 for v in fsim),
          f"sgn knobs: fsim in training and eval {fsim}")
    states = [torch.load(os.path.join(runs[n][2], "checkpoints",
                                      "epoch_2.pt"), weights_only=False)
              for n in ("scan8", "scan1")]
    param_err = max(float((a - states[1]["model"][k]).abs().max()
                          / states[1]["model"][k].abs().max().clamp(
                              min=1e-30))
                    for k, a in states[0]["model"].items()
                    if a.is_floating_point())
    loss8, loss1 = runs["scan8"][0][-1]["loss"], runs["scan1"][0][-1]["loss"]
    loss_err = abs(loss8 - loss1) / abs(loss1)
    # epoch 0 holds the process's and the shapes' warm-up; epoch 1 not
    ms = {n: [m["seconds"] / steps * 1e3 for m in runs[n][0]] for n in runs}
    log(f"      fsim_sam: loss {runs['fsim_sam'][0][-1]['loss']:.4f}, fsim "
        f"{fsim[0]:.4f} (eval {fsim[1]:.4f}), eval top-1 "
        f"{runs['fsim_sam'][1]['top1']:.4f}; scan8 against steps_per_call "
        f"1: loss {loss8:.6f} / {loss1:.6f} ({loss_err:.2e}), parameters "
        f"within {param_err:.2e} of their scale")
    log(f"      ms a step (epochs 0 / 1 of {steps} steps at batch "
        f"{TRAIN_BATCH}, host clock with the collate): " + ", ".join(
            f"{n} {v[0]:.2f} / {v[1]:.2f}" for n, v in ms.items())
        + f" [{smi}]")
    check(loss_err <= 1e-5 and param_err <= 1e-5,
          f"sgn knobs: scan8 off the steps_per_call 1 run: loss {loss_err}, "
          f"parameters {param_err}")
    summary["sgn_knobs"] = dict(
        runs={n: dict(train=r[0], eval=r[1]) for n, r in runs.items()},
        ms_per_step=ms, scan8_loss_err=loss_err, scan8_param_err=param_err,
        nvidia_smi=smi)


def phase_knobs(torch, np, smi, summary):
    """Phase 15: (a)-(c) above."""
    from agcn_tpu_torch.utils.config import load_config

    t15 = time.perf_counter()
    cfg = load_config(TRAIN_CONFIG)
    phase_sam_step(torch, np, cfg, summary)
    with tempfile.TemporaryDirectory() as tmp:
        phase_sam_speed(torch, np, cfg, tmp, summary)
        trains = phase_knobs_cli(np, tmp, summary)
        phase_sgn_knobs(np, tmp, smi, summary)
    summary["knobs_phase_s"] = time.perf_counter() - t15
    log(f"  phase 15 in {summary['knobs_phase_s']:.1f} s")
    # every kernel's count on the SAM path: the three GCN kernels' from
    # the entry point's epochs (their log counts those), the logits
    # kernel's from (a)'s step, which read all four
    launches = {k: 0 for k in trains[0]["launches"]}
    for m in trains:
        for k, n in m["launches"].items():
            launches[k] += n
    launches["logits"] = summary["sam_step"]["launches"]["logits"]
    check(launches["logits"] == 0 and launches["gcn_fwd_fp32_agg"] == 0,
          f"sam: a kernel off the SAM path launched: {launches}")
    return launches


# -- phase 16: BN folding, the apply_gcn forms and the AAGCN versions -----

V31_CONFIG = os.path.join(REPO, "configs", "ntu60_xview",
                          "train_joint_aagcn_v31.yaml")
V31_TEST_CONFIG = os.path.join(REPO, "configs", "ntu60_xview",
                               "test_joint_aagcn_v31.yaml")
V31_SEQ = 60  # the recipe's feeders: random_subsample 60
# (C, Co) of AGCN l5's and l2's GCN, served (batch 32, T = 300): 'hybrid'
# is agg_packed at the first ((V*C)*(V*Co) = 1600 x 3200) and fused_dyn at
# the second (1600 x 1600)
FORM_SHAPES = ((64, 128), (64, 64))
GCN_FORMS = ("pf", "custom", "pf_packed", "agg_packed2", "agg_dp",
             "fused_dyn", "hybrid")
# (d): each version at batch 2, one served forward on the card against
# the CPU, at the JAX suite's modes and the constructor's widths and
# depths, with the v31 recipe's patchify (101, kernel 3, unpadded) and
# frames (T = 60, so T' = 20). v17 takes two encoder layers (its masks go
# on the last only); v34's T-sized tables are cut to T': trans_len 20,
# t_length 21 (CLS + T')
VERSION_CASES = (
    ("aagcn_v17", 60, dict(pos_enc="cossin", classifier_type="CLS",
                           trans_num_layers=2, attn_masking="backward")),
    ("aagcn_v24", 60, dict(add_A="triple", pos_enc="cossin")),
    ("aagcn_v30", 60, dict(gcn_trans_unit="v2", pos_enc="cossin")),
    ("aagcn_v30", 60, dict(gcn_trans_unit="v3", pos_enc="cossin")),
    ("aagcn_v32", 60, dict(trans_seq="sa-t-res-attn-a", add_A=True,
                           pos_enc="cossin")),
    ("aagcn_v34", 60, dict(trans_seq="sa-t-res-v3", add_A=True,
                           add_Aa="one", trans_len=20, t_length=21,
                           pos_enc="cossin")),
)


def phase_fold(torch, np, summary):
    """(a) BN folding on the served `pallas` forwards of AGCN and AAGCN
    (test_joint*.yaml, 16 streams x 2 persons, T = 300, BN statistics from
    a train-mode forward): folded logits against unfolded (fp32 2e-4 of
    the logit scale, bf16 5e-2), the card's folded logits against the
    CPU's (fp32 1e-3, bf16 5e-2), 10 gcn_fwd launches a folded forward and
    10 of the logits kernel on each folded AAGCN forward's theta/phi; the
    device time by kernel group of each forward, folded beside unfolded.
    Returns the launch counts of the folded serving path."""
    from agcn_tpu_torch.models.registry import build_model
    from agcn_tpu_torch.ops import gcn as gcn_ops
    from agcn_tpu_torch.ops.kernels import logits_kernel
    from agcn_tpu_torch.utils import bn_fold
    from agcn_tpu_torch.utils.config import load_config

    x_np = dense_streams(np, SEQ)
    x = torch.from_numpy(x_np).cuda()
    launches_by_path, out = {}, {}
    for family, config, fold in (
            ("agcn", CONFIG, bn_fold.fold_agcn_bn_eval),
            ("aagcn", AAGCN_CONFIG, bn_fold.fold_aagcn_bn_eval)):
        cfg = load_config(config)
        args = dict(cfg.model_args, formulation="pallas")
        if family == "aagcn":
            args["eval_formulation"] = "pallas"
        ref = build_model(cfg.model, args, device="cuda",
                          generator=torch.Generator().manual_seed(SEED))
        prepare_aagcn_eval(torch, np, ref, x_np, SEED + 1)
        state = {k: v.detach().clone() for k, v in ref.state_dict().items()}
        del ref
        folded = fold(state)
        models = {}
        for dname in ("float32", "bfloat16"):
            for kind, weights, fold_bn in (("unfolded", state, False),
                                           ("folded", folded, True)):
                m = build_model(cfg.model, dict(args, fold_bn=fold_bn),
                                device="cuda", dtype=getattr(torch, dname))
                m.load_state_dict(weights, strict=True)
                models[(kind, dname)] = m.eval()
        # the folded serving path: its forwards alone between the reset and
        # the read
        reset_launches()
        logits = {}
        with torch.inference_mode():
            for dname in ("float32", "bfloat16"):
                logits[("folded", dname)] = models[("folded", dname)](
                    x).float().cpu()
        launches = all_launches()
        embs = []
        if family == "aagcn":
            for dname in ("float32", "bfloat16"):
                embs += capture_embeddings(torch, models[("folded", dname)],
                                           x)
            worst = 0.0
            reset_launches()
            for emb, k, ce in embs:
                b, t, v, _ = emb.shape
                e = emb.view(b, t, v, 2, k, ce)
                with torch.inference_mode():
                    got = logits_kernel.attention_logits_pallas(
                        e[..., 0, :, :], e[..., 1, :, :], ce * t)
                    want = gcn_ops.attention_logits(emb.float(), k, ce,
                                                    "transposed")
                ok, err, scale = logits_close(got, want)
                check(ok, f"folded aagcn T={t} Ce={ce}: the logits kernel "
                          f"off the transposed form by {err:.3e}")
                worst = max(worst, err / scale)
            launches["logits"] = \
                logits_kernel.attention_logits_pallas.launches
            out[f"{family}_logits_kernel_worst"] = worst
        launches_by_path[f"{family}_folded_serve"] = launches
        check(launches["gcn_fwd_round_agg"] == 2 * LAYERS
              and launches["gcn_fwd_fp32_agg"] == 0
              and launches["gcn_bwd"] == 0
              and launches["logits"] == (2 * LAYERS if family == "aagcn"
                                         else 0),
              f"{family} folded forwards launched {launches}")
        with torch.inference_mode():
            for dname in ("float32", "bfloat16"):
                logits[("unfolded", dname)] = models[("unfolded", dname)](
                    x).float().cpu()
        errs = {}
        for dname, bar in (("float32", 2e-4), ("bfloat16", 5e-2)):
            want = logits[("unfolded", dname)]
            scale = want.abs().max().item()
            err = (logits[("folded", dname)] - want).abs().max().item()
            errs[f"folded vs unfolded {dname}"] = err / scale
            check(err <= bar * scale, f"{family} {dname}: folded logits off "
                                      f"the unfolded by {err:.3e} (scale "
                                      f"{scale:.3f})")
        torch.set_num_threads(os.cpu_count() or 1)
        cpu = build_model(cfg.model, dict(args, fold_bn=True), device="cpu")
        cpu.load_state_dict({k: v.cpu() for k, v in folded.items()},
                            strict=True)
        with torch.inference_mode():
            ref = cpu.eval()(torch.from_numpy(x_np))
        scale = ref.abs().max().item()
        for dname, bar in (("float32", 1e-3), ("bfloat16", 5e-2)):
            err = (logits[("folded", dname)] - ref).abs().max().item()
            errs[f"card vs cpu folded {dname}"] = err / scale
            check(err <= bar * scale, f"{family} {dname}: the card's folded "
                                      f"logits off the CPU's by {err:.3e}")
        del cpu
        log(f"  {family} (a) folded logits, error over the logit scale "
            f"{scale:.3f}: " + ", ".join(f"{k} {v:.2e}" for k, v in
                                         errs.items())
            + f"; launches of the folded forwards {launches}")
        for dname in ("float32", "bfloat16"):
            prof = {kind: profile_forward(torch, models[(kind, dname)], x)
                    for kind in ("unfolded", "folded")}
            u, f_ = prof["unfolded"], prof["folded"]
            log(f"  {family} {dname} served forward, unfolded / folded: wall "
                f"{u['wall_ms']:.3f} / {f_['wall_ms']:.3f} ms, device "
                f"{u['device_ms']:.3f} / {f_['device_ms']:.3f} ms, kernels "
                f"{sum(u['kernels'].values()):.0f} / "
                f"{sum(f_['kernels'].values()):.0f}")
            for g in sorted(u["groups"], key=lambda g: -u["groups"][g]):
                log(f"    {u['groups'][g]:9.3f} / "
                    f"{f_['groups'].get(g, 0.0):9.3f} ms, "
                    f"{u['kernels'][g]:4.0f} / {f_['kernels'].get(g, 0):4.0f}"
                    f" kernels  {g}")
            out[f"{family}_{dname}"] = dict(prof, errors=errs)
        del models
    summary["fold"] = dict(out, launches=launches_by_path)
    return launches_by_path


def phase_forms(torch, np, summary):
    """(b) The seven einsum forms of apply_gcn on the card against 'agg' at
    two served AGCN layer shapes (batch 32, T = 300), fp32 with TF32 off:
    1e-5 of the output scale; 'custom''s gradients (its hand-ordered
    backward) against autograd of 'agg', 1e-4 of each tensor's scale;
    each form's forward ms (CUDA events over 5 calls)."""
    from agcn_tpu_torch.ops import gcn as gcn_ops

    rows = []
    for c, co in FORM_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(SEED + c + co)
        x = torch.randn(2 * STREAMS, SEQ, 25, c, device="cuda", generator=g)
        a1 = torch.softmax(torch.randn(2 * STREAMS, 3, 25, 25, device="cuda",
                                       generator=g), dim=-2)
        w = torch.randn(3, c, co, device="cuda", generator=g) / math.sqrt(
            3 * c)
        with torch.no_grad():
            want = gcn_ops.apply_gcn(x, a1, w, "agg")
            scale = want.abs().max().item()
            for form in ("agg",) + GCN_FORMS:
                y = gcn_ops.apply_gcn(x, a1, w, form)
                err = (y - want).abs().max().item()
                check(err <= 1e-5 * scale,
                      f"apply_gcn {form} at C={c} Co={co} off 'agg' by "
                      f"{err:.3e} (scale {scale:.3f})")
                ms = cuda_time_ms(
                    lambda: gcn_ops.apply_gcn(x, a1, w, form), 5)
                rows.append(dict(form=form, c=c, co=co, err=err / scale,
                                 ms=ms))
        gy = torch.randn(want.shape, device="cuda", generator=g)
        grads = {}
        for form in ("agg", "custom"):
            leaves = [t.clone().requires_grad_(True) for t in (x, a1, w)]
            (gcn_ops.apply_gcn(*leaves, form) * gy).sum().backward()
            grads[form] = [t.grad for t in leaves]
        for name, got, ref in zip(("dx", "da1", "dW"), grads["custom"],
                                  grads["agg"]):
            err, sc = (got - ref).abs().max().item(), ref.abs().max().item()
            check(err <= 1e-4 * sc, f"custom {name} at C={c} Co={co} off "
                                    f"autograd of agg by {err:.3e} ({sc:.3e})")
            rows.append(dict(form=f"custom {name}", c=c, co=co,
                             err=err / sc))
        del x, a1, w, want, gy, grads
    for r in rows:
        log(f"  (b) C={r['c']:3d} Co={r['co']:3d} {r['form']:12s} err "
            f"{r['err']:.2e} of the scale"
            + (f", {r['ms']:.3f} ms" if "ms" in r else ""))
    summary["gcn_forms"] = rows


def v31_model(torch, cfg, dname, device="cuda", dropout=None):
    """The v31 recipe's model at full width for T = 60, seeded weights,
    parameters fp32, the backbone in `dname`."""
    from agcn_tpu_torch.models.registry import build_model

    args = dict(cfg.model_args)
    if dropout is not None:
        args["dropout"] = dropout
    return build_model(cfg.model, args, device=device,
                       dtype=None if dname == "float32" else torch.bfloat16,
                       generator=torch.Generator().manual_seed(SEED),
                       num_frame=V31_SEQ)


def v31_batch(np, n, seed, num_class=60):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 3, V31_SEQ, 25, PERSONS)).astype(np.float32)
    return x, rng.integers(0, num_class, n)


def phase_v31_vs_cpu(torch, np, cfg, summary):
    """(c) Eval logits at batch 64 (BN statistics from a train-mode
    forward), card against CPU: fp32 1e-3 of the logit scale, bf16 5e-2.
    One SGD-nesterov step at batch 4, dropout 0, BN conditioned: the card
    replays the CPU's ReLU masks; loss 1e-4 relative, every gradient 1e-3
    of its scale."""
    from agcn_tpu_torch.tools.grad_parity import (ReluProbe, condition_bn,
                                                  grad_errors, relu_probe)

    torch.set_num_threads(os.cpu_count() or 1)
    x_bn, _ = v31_batch(np, TRAIN_BATCH, SEED + 21)
    x_eval, _ = v31_batch(np, TRAIN_BATCH, SEED + 22)
    ref = v31_model(torch, cfg, "float32")
    prepare_aagcn_eval(torch, np, ref, x_bn, SEED + 1)
    state = {k: v.detach().clone() for k, v in ref.state_dict().items()}
    del ref
    logits = {}
    for dev, dname in (("cuda", "float32"), ("cuda", "bfloat16"),
                       ("cpu", "float32")):
        m = v31_model(torch, cfg, dname, device=dev)
        m.load_state_dict({k: v.to(dev) for k, v in state.items()},
                          strict=True)
        with torch.inference_mode():
            logits[(dev, dname)] = m.eval()(
                torch.from_numpy(x_eval).to(dev)).float().cpu()
        del m
    ref_logits = logits[("cpu", "float32")]
    scale = ref_logits.abs().max().item()
    errs = {}
    for dname, bar in (("float32", 1e-3), ("bfloat16", 5e-2)):
        err = (logits[("cuda", dname)] - ref_logits).abs().max().item()
        errs[dname] = err / scale
        check(err <= bar * scale, f"v31 {dname}: card logits off the CPU's "
                                  f"by {err:.3e} (scale {scale:.3f})")

    x, y = v31_batch(np, 4, SEED + 4)
    ref = v31_model(torch, cfg, "float32", device="cpu", dropout=0.0)
    condition_bn(ref, SEED + 6)
    state = {k: v.detach().clone() for k, v in ref.state_dict().items()}
    del ref
    out, probes = {}, {}
    for run, dev in (("cpu", "cpu"), ("card", "cuda")):
        model = v31_model(torch, cfg, "float32", device=dev, dropout=0.0)
        model.load_state_dict({k: v.to(dev) for k, v in state.items()},
                              strict=True)
        grads = {}

        def keep(m):
            grads.update((n, p.grad.double().cpu().clone())
                         for n, p in m.named_parameters())

        probes[run] = (ReluProbe(keep_inputs=True) if run == "cpu"
                       else ReluProbe(ref=probes["cpu"]))
        step = make_step(torch, cfg, model, keep=keep)
        with relu_probe(probes[run]):
            loss = step(torch.from_numpy(x).to(dev),
                        torch.from_numpy(y).to(dev))["loss"].item()
        out[run] = (loss, grads)
        del model, step
    rel = abs(out["card"][0] - out["cpu"][0]) / abs(out["cpu"][0])
    rows = grad_errors(out["card"][1], out["cpu"][1], 1e-3)
    flip = probes["card"]
    log(f"  v31 (c) eval logits at batch {TRAIN_BATCH}, card vs cpu over the "
        f"scale {scale:.3f}: {errs}; one SGD step at batch 4: "
        f"loss cpu {out['cpu'][0]:.6f}, card {out['card'][0]:.6f} "
        f"({rel:.2e}); ReLU inputs at most {flip.input_diff:.2e} of their "
        f"layer's mean |input| from the cpu's; worst gradients (err / bar, "
        "name, err, scale): "
        + "; ".join(f"{r:.2f} {n} {e:.3e} {sc:.3e}" for r, n, e, sc in
                    rows[:3]))
    check(flip.input_diff <= 1e-3, f"v31: the card's ReLU inputs lie far "
                                   f"from the CPU's: {flip.input_diff}")
    check(rel <= 1e-4, f"v31: card loss off the CPU's by {rel:.2e}")
    check(rows[0][0] <= 1.0, f"v31: card gradients off the CPU's: {rows[0]}")
    summary["v31_vs_cpu"] = dict(
        logits_over_scale=errs, logit_scale=scale, loss=(out["cpu"][0],
                                                         out["card"][0]),
        loss_rel=rel, card_vs_cpu=[list(r) for r in rows[:5]])


def phase_v31_main_path(torch, np, cfg, summary):
    """(c) Ten bf16 steps of the recipe's model and optimizer (SGD
    nesterov, dropout 0.1; the recipe itself sets no compute_dtype and
    trains in fp32) at batch 64 on one repeated batch: the loss must
    fall; no port kernel is launched. Then ms a step, seq/s and peak
    memory in bf16 (5 timed steps after 2) and fp32, the recipe's type,
    with TF32 off (3 after 1), and one bf16 step's device time by kernel
    group."""
    model = v31_model(torch, cfg, "bfloat16")
    step = make_step(torch, cfg, model)
    x, y = v31_batch(np, TRAIN_BATCH, SEED + 7)
    x, y = torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()
    reset_launches()
    losses = [step(x, y)["loss"] for _ in range(TRAIN_STEPS)]
    losses = [v.item() for v in losses]
    launches = all_launches()
    log(f"  v31 (c) {TRAIN_STEPS} bf16 steps on one batch: loss "
        f"{' '.join(f'{v:.3f}' for v in losses)}; launches {launches}")
    check(all(math.isfinite(v) for v in losses), "v31: non-finite loss")
    check(losses[-1] < losses[0],
          f"v31: the loss did not fall on a repeated batch: {losses}")
    check(not any(launches.values()),
          f"v31: the training path launched {launches}")
    del model, step
    speed = step_speed(torch, cfg, lambda d: v31_model(torch, cfg, d), x, y,
                       "v31 (c)")
    summary.update(v31_train_losses=losses, v31_train_launches=launches,
                   v31_train_speed=speed)
    return launches


def phase_versions_vs_cpu(torch, np, summary):
    """(d) v17, v24, v30 (both GCN units), v32 and v34 at their
    constructor's widths (`VERSION_CASES`): one forward each at batch 2
    with BN statistics from a train-mode forward, card against CPU, fp32
    within 1e-3 of the logit scale; no port kernel launched."""
    from agcn_tpu_torch.models.registry import build_model

    torch.set_num_threads(os.cpu_count() or 1)
    rows = []
    reset_launches()
    for name, t, kw in VERSION_CASES:
        args = dict(num_class=60, model_layers=101, kernel_size=3,
                    pad=False, **kw)
        rng = np.random.default_rng(SEED + t)
        x_bn, x = (rng.standard_normal((2, 3, t, 25, PERSONS)).astype(
            np.float32) for _ in range(2))
        ref = build_model(name, args, device="cuda", num_frame=t,
                          generator=torch.Generator().manual_seed(SEED))
        prepare_aagcn_eval(torch, np, ref, x_bn, SEED + 1)
        with torch.inference_mode():
            card = ref(torch.from_numpy(x).cuda()).float().cpu()
        state = {k: v.cpu() for k, v in ref.state_dict().items()}
        del ref
        cpu = build_model(name, args, device="cpu", num_frame=t)
        cpu.load_state_dict(state, strict=True)
        with torch.inference_mode():
            want = cpu.eval()(torch.from_numpy(x))
        scale = want.abs().max().item()
        err = (card - want).abs().max().item()
        rows.append(dict(model=name, t=t, err=err / scale, scale=scale,
                         **{k: v for k, v in kw.items()
                            if k in ("trans_seq", "gcn_trans_unit", "add_A",
                                     "attn_masking")}))
        log(f"  (d) {name} {kw}: card vs cpu {err:.2e} of the logit scale "
            f"{scale:.3f}")
        check(err <= 1e-3 * scale, f"{name} {kw}: card logits off the CPU's "
                                   f"by {err:.3e}")
    launches = all_launches()
    check(not any(launches.values()), f"the versions launched {launches}")
    summary["versions_vs_cpu"] = dict(rows=rows, launches=launches)


def phase_versions(torch, np, smi, summary):
    """Phase 16: (a) BN folding, (b) the apply_gcn forms, (c) the v31
    recipe, (d) the other versions. Returns the launch counts of the
    folded serving paths and of v31's training path."""
    from agcn_tpu_torch.utils.config import load_config

    t16 = time.perf_counter()
    parts = {}

    def lap(name):
        parts[name] = time.perf_counter() - t16 - sum(parts.values())

    folded = phase_fold(torch, np, summary)
    lap("a")
    phase_forms(torch, np, summary)
    lap("b")
    cfg = load_config(V31_CONFIG)
    phase_v31_vs_cpu(torch, np, cfg, summary)
    lap("c: card against cpu")
    v31_train = phase_v31_main_path(torch, np, cfg, summary)
    lap("c: steps and speed")
    # the entry points at a cut depth (one encoder layer of the recipe's
    # three) and one step
    phase_train_cli(np, summary, V31_CONFIG, "aagcn_v31", resume=False,
                    formulation=None, launches_per_step=(0, 0), serve=True,
                    max_frame=V31_SEQ, test_config=V31_TEST_CONFIG, steps=1,
                    num_layers=1)
    lap("c: entry points")
    # v31's training path: the ten steps' counts, and the entry point's
    # epoch's (whose log counts the three GCN kernels)
    v31_train = dict(v31_train)
    for m in summary["aagcn_v31_train_cli"]["train"]:
        for key, n in m["launches"].items():
            v31_train[key] += n
    phase_versions_vs_cpu(torch, np, summary)
    lap("d")
    summary["versions_phase_s"] = time.perf_counter() - t16
    summary["versions_phase_parts_s"] = parts
    summary["versions_smi"] = smi
    log(f"  phase 16 in {summary['versions_phase_s']:.1f} s ("
        + ", ".join(f"{k} {v:.1f}" for k, v in parts.items()) + ")")
    return dict(folded, aagcn_v31_train=v31_train)


# -- phase 17: SGN's v11-v13 options, the MMD loss, sgn_original ---------

SGN_OPTION_CONFIGS = {
    name: os.path.join(REPO, "configs", "ntu60_xview",
                       f"train_sgn_{name}.yaml")
    for name in ("v11", "v12", "v13_gt4")}
MMD_METRICS = ("mmd", "l2_z_mean", "cos_z", "dist_z", "cos_z_prior",
               "dist_z_prior")


def first(out):
    """The logits of a model's output ((logits, G) for sgn_original)."""
    return out[0] if isinstance(out, tuple) else out


def option_configs():
    """The recipes of phase 17 (sgn_original in train_sgn.yaml's data
    settings: no recipe ships it), by name."""
    from agcn_tpu_torch.utils.config import load_config

    cfgs = {name: load_config(path)
            for name, path in SGN_OPTION_CONFIGS.items()}
    cfgs["sgn_original"] = load_config(SGN_CONFIG, {
        "model": "model.sgn.SGN",
        "model_args": {"num_class": 60, "num_point": 25, "in_channels": 3,
                       "seg": 20, "dropout": 0.0}})
    return cfgs


def phase_sgn_options_vs_cpu(torch, np, cfgs, x_eval, summary):
    """(a) Card against CPU, fp32 (TF32 off): each model with every unit's
    w1 random and the BN statistics of a train-mode forward, eval logits
    of the 4 x 5-crop batch within 1e-3 of the logit scale. Returns the
    CPU models' state dicts."""
    states, rows = {}, {}
    torch.set_num_threads(os.cpu_count() or 1)
    for name, cfg in cfgs.items():
        drop = None if name == "sgn_original" else 0.0
        ref = sgn_model(torch, cfg, device="cpu", dropout2d=drop)
        liven_sgn(torch, ref, x_eval, SEED + 50)
        states[name] = {k: v.detach().clone()
                        for k, v in ref.state_dict().items()}
        with torch.inference_mode():
            want = first(ref(torch.from_numpy(x_eval))).numpy()
        del ref
        card = sgn_model(torch, cfg, dropout2d=drop)
        card.load_state_dict(states[name], strict=True)
        with torch.inference_mode():
            got = first(card.eval()(torch.from_numpy(x_eval).cuda()))
        got = got.cpu().numpy()
        scale = float(np.abs(want).max())
        err = float(np.abs(got - want).max())
        rows[name] = dict(logit_err=err, logit_scale=scale,
                          params=sum(p.numel() for p in card.parameters()))
        check(np.isfinite(got).all() and err <= 1e-3 * max(scale, 1.0),
              f"{name}: card logits off the CPU's by {err:.3e}")
        del card
    log("  sgn options (a) eval logits (4 x 5 crops) card vs cpu: "
        + "; ".join(f"{n} {r['logit_err']:.3e} of {r['logit_scale']:.3f} "
                    f"({r['params']:,} parameters)" for n, r in rows.items()))
    summary["sgn_options_vs_cpu"] = rows
    return states


def phase_sgn_mmd_step_vs_cpu(torch, np, cfg, state, x_eval, summary):
    """(b) One fp32 step of v12 (label smoothing, the MMD loss, Adam) at
    batch 4 with dropout 0, card against CPU: the card replays the CPU's
    ReLU masks, max selections and the InfoGCN head's eps. Loss and the
    six MMD metrics 1e-4 relative (the cosines 1e-4 of their bound, 1),
    every gradient 1e-3 of its scale."""
    from agcn_tpu_torch.tools.grad_parity import (AmaxProbe, NoiseProbe,
                                                  ReluProbe, amax_probe,
                                                  grad_errors, noise_probe,
                                                  relu_probe)

    x = np.ascontiguousarray(x_eval[::SGN_CROPS])
    y = np.array([0, 7, 7, 21])  # a repeated class and absent ones
    out, probes = {}, {}
    for run, dev in (("cpu", "cpu"), ("card", "cuda")):
        model = sgn_model(torch, cfg, device=dev, dropout2d=0.0)
        model.load_state_dict(state, strict=True)
        grads = {}

        def keep(m):
            grads.update((n, p.grad.double().cpu().clone())
                         for n, p in m.named_parameters())

        ref = probes.get("cpu")
        probes[run] = (ReluProbe(ref=ref and ref[0], keep_inputs=not ref),
                       AmaxProbe(ref=ref and ref[1]),
                       NoiseProbe(ref=ref and ref[2]))
        relu, amax, noise = probes[run]
        with relu_probe(relu), amax_probe(amax), noise_probe(noise):
            metrics = make_step(torch, cfg, model, keep=keep,
                                recipe_loss=True)(
                torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev))
        out[run] = ({k: v.item() for k, v in metrics.items()}, grads)
        del model
    (m_cpu, g_cpu), (m_card, g_card) = out["cpu"], out["card"]
    # relative to the value; the cosines (cos_z_prior is 0 in exact
    # arithmetic for the orthogonal prior) relative to their bound, 1
    rel = {k: abs(m_card[k] - m_cpu[k]) / max(
        abs(m_cpu[k]), 1.0 if k.startswith("cos") else 1e-30)
           for k in ("loss",) + MMD_METRICS}
    rows = grad_errors(g_card, g_cpu, 1e-3)
    relu, amax, noise = probes["card"]
    log(f"  sgn options (b) one fp32 v12 step at batch 4 with the MMD loss: "
        f"loss cpu {m_cpu['loss']:.6f}, card {m_card['loss']:.6f}; "
        + ", ".join(f"{k} {m_card[k]:.5g} ({rel[k]:.1e})"
                    for k in MMD_METRICS)
        + f"; eps replayed {len(noise.draws)}; ReLU signs off the cpu's "
        f"{relu.disagree} (inputs within {relu.input_diff:.2e}); max "
        f"selections off {amax.disagree} of {amax.maxima}; worst gradients: "
        + "; ".join(f"{r:.2f} {n} {e:.3e} {sc:.3e}" for r, n, e, sc in
                    rows[:3]))
    check(len(noise.draws) == 1, f"eps draws {len(noise.draws)}")
    check(relu.input_diff <= 1e-3,
          f"v12: the card's ReLU inputs lie far from the CPU's: "
          f"{relu.input_diff}")
    check(amax.disagree <= 1e-4 * amax.maxima,
          f"v12: {amax.disagree} of {amax.maxima} max selections differ")
    check(max(rel.values()) <= 1e-4, f"v12: card metrics off the CPU's: "
                                     f"{rel}")
    check(rows[0][0] <= 1.0, f"v12: card gradients off the CPU's: "
                             f"{rows[0]}")
    summary["sgn_mmd_step"] = dict(
        cpu=m_cpu, card=m_card, rel=rel,
        relu_sign_flips=(relu.disagree, relu.input_diff),
        max_ties=(amax.disagree, amax.maxima),
        grads=[list(r) for r in rows[:5]])


def step_profile(torch, step, x, y):
    """One step under torch.profiler: (device ms by kernel group, kernels
    launched)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(x, y)
        torch.cuda.synchronize()
    groups, kernels = {}, 0
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            g = kernel_group(ev.name)
            groups[g] = groups.get(g, 0.0) + ev.device_time_total / 1e3
            kernels += 1
    check(sum(groups.values()) > 0, "the profiler saw no device time")
    return groups, kernels


def phase_sgn_options_train(torch, np, cfgs, train_ds, summary):
    """(c) Ten Adam steps of v12 (batch 128, the MMD loss) and v13_gt4
    (batch 64) at the recipes' dropout2d on one repeated collated batch:
    the loss must fall and no port kernel launches; then ms per step,
    seq/s and peak memory (5 timed steps after 2), one step's device time
    by kernel group (torch.profiler) and its busy share."""
    from agcn_tpu_torch.data.sgn_collate import SegmentSampler

    sampler = SegmentSampler(dataset="NTU60-CV-SGN", seg=20)
    rng = np.random.default_rng(SEED + 51)
    rows = {}
    for name in ("v12", "v13_gt4"):
        cfg = cfgs[name]
        n = cfg.batch_size
        x, _, y, _ = sampler.collate([train_ds[i] for i in range(n)], rng,
                                     train=True)
        x, y = torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()
        model = sgn_model(torch, cfg)
        step = make_step(torch, cfg, model, recipe_loss=True)
        reset_launches()
        losses_ = [step(x, y)["loss"] for _ in range(TRAIN_STEPS)]
        losses_ = [v.item() for v in losses_]
        launches = all_launches()
        check(all(math.isfinite(v) for v in losses_)
              and losses_[-1] < losses_[0],
              f"{name}: the loss did not fall on a repeated batch: "
              f"{losses_}")
        check(not any(launches.values()),
              f"{name}: the training path launched {launches}")
        for _ in range(2):
            step(x, y)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(5):
            step(x, y)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / 5
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        groups, kernels = step_profile(torch, step, x, y)
        device_ms = sum(groups.values())
        rows[name] = dict(batch=n, losses=losses_, launches=launches,
                          ms_per_step=ms, seq_per_s=n / ms * 1e3,
                          peak_gib=peak, device_ms=device_ms,
                          busy=device_ms / ms, kernels=kernels,
                          groups=groups)
        log(f"  sgn options (c) {name}: {TRAIN_STEPS} Adam steps at batch "
            f"{n}: loss {' '.join(f'{v:.3f}' for v in losses_)}; launches "
            f"{launches}; {ms:.3f} ms/step, {n / ms * 1e3:.1f} seq/s, peak "
            f"{peak:.3f} GiB; one step: device {device_ms:.3f} ms in "
            f"{kernels} kernels ({100 * device_ms / ms:.1f}% busy)")
        for g, gms in sorted(groups.items(), key=lambda kv: -kv[1]):
            log(f"    {gms:9.3f} ms {100 * gms / device_ms:5.1f}%  {g}")
        del model, step
    summary["sgn_options_train"] = rows


def phase_sgn_options_cli(np, paths, tmp, summary):
    """(d) `python -m agcn_tpu_torch.main` on a copy of train_sgn_v12.yaml
    pointed at the pickles: one epoch (batch 128), eval with multi_test 5
    and a checkpoint; metrics.jsonl's train and eval lines carry the six
    MMD metrics, finite; `--phase test` on the checkpoint reproduces the
    run's top-1; no port kernel launches."""
    import yaml

    with open(SGN_OPTION_CONFIGS["v12"]) as f:
        recipe = yaml.safe_load(f)
    work = os.path.join(tmp, "v12")
    recipe.update(
        work_dir=work, num_epoch=1, num_worker=2, log_interval=1,
        save_interval=1, eval_interval=1, show_topk=[1, 5],
        train_feeder_args=dict(recipe["train_feeder_args"],
                               data_path=paths["train"][0],
                               label_path=paths["train"][1]),
        test_feeder_args=dict(recipe["test_feeder_args"],
                              data_path=paths["test"][0],
                              label_path=paths["test"][1]))
    cfg_path = os.path.join(tmp, "sgn_v12.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(recipe, f)
    log("  sgn options (d) python -m agcn_tpu_torch.main on "
        "train_sgn_v12.yaml: train + eval (multi_test 5) + save, one epoch; "
        "then --phase test")
    run_entry_point(["--config", cfg_path])
    run_entry_point(["--config", cfg_path, "--phase", "test", "--weights",
                     os.path.join(work, "checkpoints", "epoch_1.pt"),
                     "--work-dir", os.path.join(tmp, "v12_test")])
    metrics = read_metrics(os.path.join(work, "metrics.jsonl"))
    test = read_metrics(os.path.join(tmp, "v12_test", "metrics.jsonl"))
    trains = [m for m in metrics if m["kind"] == "train"]
    evals = [m for m in metrics if m["kind"] == "eval"]
    check(len(trains) == 1 and len(evals) == 1
          and all(math.isfinite(m.get(k, math.nan))
                  for m in (trains[0], evals[0]) for k in MMD_METRICS),
          f"v12 entry point: the MMD metrics missing: {metrics}")
    check(not any(trains[0]["launches"].values()),
          f"v12 entry point launched {trains[0]['launches']}")
    check(test[-1]["top1"] == evals[-1]["top1"],
          f"--phase test top-1 {test[-1]['top1']} != the run's "
          f"{evals[-1]['top1']}")
    log(f"      train loss {trains[0]['loss']:.4f}, "
        + ", ".join(f"{k} {trains[0][k]:.4g}" for k in MMD_METRICS)
        + f"; eval top-1 {evals[-1]['top1']:.4f} (mmd {evals[-1]['mmd']:.4g}"
        f"), --phase test top-1 {test[-1]['top1']:.4f}")
    summary["sgn_options_cli"] = dict(train=trains, eval=evals, test=test)


def phase_sgn_options(torch, np, summary):
    """Phase 17: (a)-(d) above, on phase 14's synthetic pickles in one
    temporary directory."""
    from agcn_tpu_torch.data.feeder import SGNDataset
    from agcn_tpu_torch.data.sgn_collate import SegmentSampler

    t17 = time.perf_counter()
    cfgs = option_configs()
    reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        paths = write_sgn_pickles(np, tmp)
        train = SGNDataset(*paths["train"], dataset="NTU60-CV-SGN")
        test = SGNDataset(*paths["test"], dataset="NTU60-CV-SGN")
        sampler = SegmentSampler(dataset="NTU60-CV-SGN", seg=20,
                                 multi_test=SGN_CROPS)
        x_eval, _, _, _ = sampler.collate([test[i] for i in range(4)],
                                          np.random.default_rng(SEED),
                                          multi_crop=True)
        states = phase_sgn_options_vs_cpu(torch, np, cfgs, x_eval, summary)
        phase_sgn_mmd_step_vs_cpu(torch, np, cfgs["v12"], states["v12"],
                                  x_eval, summary)
        phase_sgn_options_train(torch, np, cfgs, train, summary)
        phase_sgn_options_cli(np, paths, tmp, summary)
    launches = all_launches()
    check(not any(launches.values()), f"phase 17 launched {launches}")
    summary["sgn_options_launches"] = launches
    summary["sgn_options_phase_s"] = time.perf_counter() - t17
    log(f"  phase 17 in {summary['sgn_options_phase_s']:.1f} s")
    return launches


# -- phase 18: SGN's transformer and SGN serving (no TPU kernel) ---------

SGN_TRANSFORMER_CONFIGS = {
    name: os.path.join(REPO, "configs", "ntu60_xview", f"train_{name}.yaml")
    for name in ("sgn_transformer", "sgn_v15")}
SGN_TRANSFORMER_TEST_CONFIG = os.path.join(REPO, "configs", "ntu60_xview",
                                           "test_sgn_transformer.yaml")


def sgn_transformer_model(torch, cfg, device="cuda", dropout=None):
    """The recipe's SGN transformer at full width for its seg, seeded
    weights; `dropout` replaces every dropout rate of the recipe (fc's and
    the encoders')."""
    from agcn_tpu_torch.models.registry import build_model

    args = dict(cfg.model_args)
    if dropout is not None:
        args["dropout"] = dropout
        for k in ("spatial_mha_kwargs", "temporal_mha_kwargs"):
            if k in args:
                args[k] = dict(args[k], dropout=dropout)
    seg = (cfg.train_dataloader_args or cfg.test_dataloader_args)["seg"]
    return build_model(cfg.model, args, device=device,
                       generator=torch.Generator().manual_seed(SEED),
                       num_frame=seg)


def phase_sgn_transformer_vs_cpu(torch, np, cfgs, x_eval, summary):
    """(a) Card against CPU, fp32 (TF32 off): each recipe's model with the
    BN statistics of a train-mode forward, eval logits of the 4 x 5-crop
    batch within 1e-3 of the logit scale. Returns the CPU models' state
    dicts."""
    states, rows = {}, {}
    torch.set_num_threads(os.cpu_count() or 1)
    for name, cfg in cfgs.items():
        ref = sgn_transformer_model(torch, cfg, device="cpu")
        liven_sgn(torch, ref, x_eval, SEED + 60)
        states[name] = {k: v.detach().clone()
                        for k, v in ref.state_dict().items()}
        with torch.inference_mode():
            want = first(ref(torch.from_numpy(x_eval))).numpy()
        del ref
        card = sgn_transformer_model(torch, cfg)
        card.load_state_dict(states[name], strict=True)
        with torch.inference_mode():
            got = first(card.eval()(torch.from_numpy(x_eval).cuda()))
        got = got.cpu().numpy()
        scale = float(np.abs(want).max())
        err = float(np.abs(got - want).max())
        rows[name] = dict(logit_err=err, logit_scale=scale,
                          params=sum(p.numel() for p in card.parameters()))
        check(np.isfinite(got).all() and err <= 1e-3 * max(scale, 1.0),
              f"{name}: card logits off the CPU's by {err:.3e}")
        del card
    log("  sgn transformer (a) eval logits (4 x 5 crops) card vs cpu: "
        + "; ".join(f"{n} {r['logit_err']:.3e} of {r['logit_scale']:.3f} "
                    f"({r['params']:,} parameters)" for n, r in rows.items()))
    summary["sgn_transformer_vs_cpu"] = rows
    return states


def phase_sgn_transformer_step_vs_cpu(torch, np, cfg, state, x_eval,
                                      summary):
    """(b) One fp32 step of train_sgn_v15.yaml (label smoothing 0.1,
    Adam) at batch 4 with dropout 0, card against CPU, the card replaying
    the CPU's ReLU masks and max selections: loss 1e-4 relative, every
    gradient 1e-3 of its scale."""
    from agcn_tpu_torch.tools.grad_parity import (AmaxProbe, ReluProbe,
                                                  amax_probe, grad_errors,
                                                  relu_probe)

    x = np.ascontiguousarray(x_eval[::SGN_CROPS])
    y = np.array([0, 7, 7, 21])
    out, probes = {}, {}
    for run, dev in (("cpu", "cpu"), ("card", "cuda")):
        model = sgn_transformer_model(torch, cfg, device=dev, dropout=0.0)
        model.load_state_dict(state, strict=True)
        grads = {}

        def keep(m):
            grads.update((n, p.grad.double().cpu().clone())
                         for n, p in m.named_parameters())

        ref = probes.get("cpu")
        probes[run] = (ReluProbe(ref=ref and ref[0], keep_inputs=not ref),
                       AmaxProbe(ref=ref and ref[1]))
        relu, amax = probes[run]
        with relu_probe(relu), amax_probe(amax):
            loss = make_step(torch, cfg, model, keep=keep, recipe_loss=True)(
                torch.from_numpy(x).to(dev),
                torch.from_numpy(y).to(dev))["loss"].item()
        out[run] = (loss, grads)
        del model
    (l_cpu, g_cpu), (l_card, g_card) = out["cpu"], out["card"]
    rel = abs(l_card - l_cpu) / abs(l_cpu)
    rows = grad_errors(g_card, g_cpu, 1e-3)
    relu, amax = probes["card"]
    log(f"  sgn transformer (b) one fp32 v15 step at batch 4, dropout 0, "
        f"label smoothing {cfg.label_smoothing}: loss cpu {l_cpu:.6f}, card "
        f"{l_card:.6f} ({rel:.2e}); ReLU signs off the cpu's {relu.disagree}"
        f" (inputs within {relu.input_diff:.2e}); max selections off "
        f"{amax.disagree} of {amax.maxima}; worst gradients: "
        + "; ".join(f"{r:.2f} {n} {e:.3e} {sc:.3e}" for r, n, e, sc in
                    rows[:3]))
    check(relu.input_diff <= 1e-3,
          f"v15: the card's ReLU inputs lie far from the CPU's: "
          f"{relu.input_diff}")
    check(amax.disagree <= 1e-4 * amax.maxima,
          f"v15: {amax.disagree} of {amax.maxima} max selections differ")
    check(rel <= 1e-4, f"v15: fp32 card loss off the CPU's: {rel}")
    check(rows[0][0] <= 1.0, f"v15: card gradients off the CPU's: {rows[0]}")
    summary["sgn_transformer_step"] = dict(
        cpu=l_cpu, card=l_card, loss_rel=rel,
        relu_sign_flips=(relu.disagree, relu.input_diff),
        max_ties=(amax.disagree, amax.maxima),
        grads=[list(r) for r in rows[:5]])


def phase_sgn_transformer_train(torch, np, cfgs, train_ds, summary):
    """(c) Ten Adam steps of each recipe at its batch of 64 and its
    dropout on one repeated collated batch: the loss must fall and no port
    kernel launches; then ms per step, seq/s and peak memory (5 timed steps
    after 2), one step's device time by kernel group (torch.profiler) and
    its busy share."""
    from agcn_tpu_torch.data.sgn_collate import SegmentSampler

    sampler = SegmentSampler(dataset="NTU60-CV-SGN", seg=20)
    rng = np.random.default_rng(SEED + 61)
    rows = {}
    for name, cfg in cfgs.items():
        n = cfg.batch_size
        x, _, y, _ = sampler.collate([train_ds[i] for i in range(n)], rng,
                                     train=True)
        x, y = torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()
        model = sgn_transformer_model(torch, cfg)
        step = make_step(torch, cfg, model, recipe_loss=True)
        before = all_launches()
        losses_ = [step(x, y)["loss"] for _ in range(TRAIN_STEPS)]
        losses_ = [v.item() for v in losses_]
        launches = {k: n - before[k] for k, n in all_launches().items()}
        check(all(math.isfinite(v) for v in losses_)
              and losses_[-1] < losses_[0],
              f"{name}: the loss did not fall on a repeated batch: "
              f"{losses_}")
        check(not any(launches.values()),
              f"{name}: the training path launched {launches}")
        for _ in range(2):
            step(x, y)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(5):
            step(x, y)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / 5
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        groups, kernels = step_profile(torch, step, x, y)
        device_ms = sum(groups.values())
        rows[name] = dict(batch=n, losses=losses_, launches=launches,
                          ms_per_step=ms, seq_per_s=n / ms * 1e3,
                          peak_gib=peak, device_ms=device_ms,
                          busy=device_ms / ms, kernels=kernels,
                          groups=groups)
        log(f"  sgn transformer (c) {name}: {TRAIN_STEPS} Adam steps at "
            f"batch {n}: loss {' '.join(f'{v:.3f}' for v in losses_)}; "
            f"launches {launches}; {ms:.3f} ms/step, {n / ms * 1e3:.1f} "
            f"seq/s, peak {peak:.3f} GiB; one step: device {device_ms:.3f} "
            f"ms in {kernels} kernels ({100 * device_ms / ms:.1f}% busy)")
        for g, gms in sorted(groups.items(), key=lambda kv: -kv[1]):
            log(f"    {gms:9.3f} ms {100 * gms / device_ms:5.1f}%  {g}")
        del model, step
    summary["sgn_transformer_train"] = rows


def phase_sgn_transformer_cli(np, paths, tmp, summary):
    """(d) `python -m agcn_tpu_torch.main` on a copy of
    train_sgn_transformer.yaml pointed at the pickles, its depth cut to one
    temporal encoder layer: one epoch of one step (batch 64), eval with
    multi_test 5 and a checkpoint; `--phase test` with a
    copy of test_sgn_transformer.yaml (the entry point's `main` in this
    process: a third interpreter would add its start) reproduces its
    top-1 (right.txt too) and its score rows (one a sample, its crops
    averaged; within 1e-5 of their scale); `python -m
    agcn_tpu_torch.infer --serve 16`
    serves the checkpoint (one C++ pre_normalize a stream and tick: SGN's
    rows are made stream by stream); no port kernel launches."""
    import pickle

    import yaml

    from agcn_tpu_torch.main import main as entry_point

    with open(SGN_TRANSFORMER_CONFIGS["sgn_transformer"]) as f:
        recipe = yaml.safe_load(f)
    work = os.path.join(tmp, "sgn_transformer")
    # cut depth: one temporal encoder layer of the recipe's two, and one
    # step (the 64 val sequences as the training set)
    recipe.update(
        work_dir=work, num_epoch=1, num_worker=2, log_interval=1,
        save_interval=1, eval_interval=1, show_topk=[1, 5],
        model_args=dict(recipe["model_args"], temporal_mha_kwargs=dict(
            recipe["model_args"]["temporal_mha_kwargs"], num_layers=1)),
        train_feeder_args=dict(recipe["train_feeder_args"],
                               data_path=paths["val"][0],
                               label_path=paths["val"][1]),
        test_feeder_args=dict(recipe["test_feeder_args"],
                              data_path=paths["test"][0],
                              label_path=paths["test"][1]))
    with open(SGN_TRANSFORMER_TEST_CONFIG) as f:
        test_recipe = yaml.safe_load(f)
    test_recipe.update(
        work_dir=os.path.join(tmp, "sgn_transformer_test"),
        model_args=dict(test_recipe["model_args"], temporal_mha_kwargs=dict(
            test_recipe["model_args"]["temporal_mha_kwargs"], num_layers=1)),
        test_feeder_args=dict(test_recipe["test_feeder_args"],
                              data_path=paths["test"][0],
                              label_path=paths["test"][1]))
    cfgs = {}
    for name, r in (("train", recipe), ("test", test_recipe)):
        cfgs[name] = os.path.join(tmp, f"sgn_transformer_{name}.yaml")
        with open(cfgs[name], "w") as f:
            yaml.safe_dump(r, f)
    log("  sgn transformer (d) python -m agcn_tpu_torch.main on "
        "train_sgn_transformer.yaml: train + eval (multi_test 5) + save, "
        "one epoch; --phase test with test_sgn_transformer.yaml; the "
        f"serving CLI at {STREAMS} streams")
    run_entry_point(["--config", cfgs["train"]])
    ckpt = os.path.join(work, "checkpoints", "epoch_1.pt")
    with contextlib.redirect_stdout(io.StringIO()):
        entry_point(["--config", cfgs["test"], "--weights", ckpt])
    metrics = read_metrics(os.path.join(work, "metrics.jsonl"))
    test = read_metrics(os.path.join(tmp, "sgn_transformer_test",
                                     "metrics.jsonl"))
    with open(os.path.join(tmp, "sgn_transformer_test", "right.txt")) as f:
        right = len(f.readlines())
    scores = []
    for run in (work, os.path.join(tmp, "sgn_transformer_test")):
        with open(os.path.join(run, "score", "epoch1_val.pkl"), "rb") as f:
            scores.append(np.stack(list(pickle.load(f).values())))
    score_err = float(np.abs(scores[0] - scores[1]).max())
    trains = [m for m in metrics if m["kind"] == "train"]
    evals = [m for m in metrics if m["kind"] == "eval"]
    n_test = dict(SGN_SPLITS)["test"]
    check(len(trains) == 1 and len(evals) == 1
          and math.isfinite(trains[0]["loss"]),
          f"sgn_transformer entry point: {metrics}")
    check(not any(trains[0]["launches"].values()),
          f"sgn_transformer entry point launched {trains[0]['launches']}")
    check(test[-1]["top1"] == evals[-1]["top1"]
          and right == round(test[-1]["top1"] * n_test),
          f"--phase test top-1 {test[-1]['top1']} != the run's "
          f"{evals[-1]['top1']}")
    check(scores[0].shape == scores[1].shape == (
        n_test, recipe["model_args"]["num_class"])
          and score_err <= 1e-5 * float(np.abs(scores[0]).max()),
          f"sgn_transformer scores: shapes {scores[0].shape}, "
          f"{scores[1].shape}, max difference {score_err:.3e}")
    served = serve_checkpoint(np, tmp, cfgs["test"], ckpt,
                              normalize_calls=STREAMS)
    log(f"      train loss {trains[0]['loss']:.4f}, "
        f"{trains[0]['seq_per_sec']:.1f} seq/s (host-fed epoch of "
        f"{trains[0]['steps']} steps); eval top-1 {evals[-1]['top1']:.4f} in "
        f"{evals[-1]['seconds']:.2f} s, --phase test top-1 "
        f"{test[-1]['top1']:.4f}, its {n_test} score rows within "
        f"{score_err:.2e} of the run's")
    summary["sgn_transformer_cli"] = dict(train=trains, eval=evals,
                                          test=test, served=served,
                                          score_err=score_err)


def serve_sgn(server, seq, ticks, start, pipelined=False):
    """Ticks of a kind="sgn" server over the streams of `seq` (fed
    TICK_FRAMES frames a stream before each tick, from frame `start`; the
    ring already holds the frames before it): (answers of every tick, ms
    of each tick, host prep ms and h2d enqueue ms of each tick)."""
    answers, tick_ms, prep, h2d = [], [], [], []
    for i in range(ticks):
        lo = start + i * TICK_FRAMES
        for sid in range(STREAMS):
            for f in seq[sid, lo:lo + TICK_FRAMES]:
                server.append_frame(sid, f)
        t0 = time.perf_counter()
        r = server.predict_async() if pipelined else server.predict()
        tick_ms.append((time.perf_counter() - t0) * 1e3)
        prep.append(server.last_prep_ms)
        h2d.append(server.last_h2d_ms)
        if r is not None:
            answers.append(r)
    if pipelined:
        answers.append(server.flush())
    return answers, tick_ms, prep, h2d


def phase_sgn_serving(torch, np, states, summary):
    """(e) The SGN tick: 16 streams x 5 crops (80 rows a forward) of
    train_sgn.yaml's `sgn` (w1 random, live BN statistics) and of
    test_sgn_transformer.yaml's SGN transformer ((a)'s weights), each
    stream's crops from its default_rng(stream id): a warm-up tick, 4
    sync and 4 pipelined ticks on the card (tick ms, preds/s, host prep
    and h2d ms; one C++ pre_normalize a stream and tick); then a tenth
    tick on the card and on the CPU with the same weights, the CPU
    server's streams handed the card server's rings and crop generators
    as they stand: every stream's probabilities within 1e-4 of the
    CPU's, the labels equal where the CPU's top two lie more than 1e-4
    apart."""
    import copy

    from agcn_tpu_torch import native
    from agcn_tpu_torch.infer.serving import BatchedStreamServer
    from agcn_tpu_torch.utils.config import load_config

    seq = make_streams(np)
    sgn_cfg = load_config(SGN_CONFIG)
    ref = sgn_model(torch, sgn_cfg, device="cpu")
    x_warm = np.random.default_rng(SEED + 62).standard_normal(
        (64, 20, 75)).astype(np.float32)
    liven_sgn(torch, ref, x_warm, SEED + 63)
    tf_cfg = load_config(SGN_TRANSFORMER_TEST_CONFIG)
    served = {"sgn": (sgn_cfg, sgn_model, ref.state_dict()),
              "sgn_transformer": (tf_cfg, sgn_transformer_model,
                                  states["sgn_transformer"])}
    torch.set_num_threads(os.cpu_count() or 1)
    rows = {}
    for name, (cfg, build, state) in served.items():
        servers = {}
        for dev in ("cuda", "cpu"):
            model = build(torch, cfg, device=dev)
            model.load_state_dict(state, strict=True)
            servers[dev] = BatchedStreamServer(
                model.eval(), max_streams=STREAMS, kind="sgn",
                max_seq_length=SEQ, multi_test=SGN_CROPS,
                sgn_dataloader_args=cfg.test_dataloader_args)
            for sid in range(STREAMS):
                check(servers[dev].add_stream() == sid, "stream ids")
        card, cpu = servers["cuda"], servers["cpu"]
        for sid in range(STREAMS):
            for f in seq[sid, :SEQ]:
                card.append_frame(sid, f)
        calls = native.pre_normalize.calls
        warm, _, _, _ = serve_sgn(card, seq, 1, SEQ)
        sync, sync_ms, sync_prep, sync_h2d = serve_sgn(
            card, seq, 4, SEQ + TICK_FRAMES)
        pipe, pipe_ms, pipe_prep, pipe_h2d = serve_sgn(
            card, seq, 4, SEQ + 5 * TICK_FRAMES, pipelined=True)
        cpp_calls = native.pre_normalize.calls - calls
        check(cpp_calls == 9 * STREAMS,
              f"sgn serving {name}: {cpp_calls} C++ pre_normalize calls in "
              f"9 ticks of {STREAMS} streams")
        got = warm + sync + pipe
        check(len(got) == 9, f"sgn serving {name}: {len(got)} answered ticks")
        check_answers(np, got, cfg.model_args["num_class"])
        # the CPU server takes up each stream where the card's stands
        for sid in range(STREAMS):
            cpu._streams[sid] = copy.deepcopy(card._streams[sid])
            cpu._rngs[sid] = copy.deepcopy(card._rngs[sid])
        (g,), _, _, _ = serve_sgn(card, seq, 1, SEQ + 9 * TICK_FRAMES)
        (w,), _, _, _ = serve_sgn(cpu, seq, 1, SEQ + 9 * TICK_FRAMES)
        perr, flips = 0.0, 0
        for sid in range(STREAMS):
            pg, pw = g[sid][1], w[sid][1]
            perr = max(perr, float(np.abs(pg - pw).max()))
            top2 = np.sort(pw)[-2:]
            flips += int(g[sid][0] != w[sid][0] and top2[1] - top2[0] > 1e-4)
        check(perr <= 1e-4 and flips == 0,
              f"sgn serving {name}: card answers off the CPU's: "
              f"probabilities {perr:.2e}, {flips} labels")
        tick = {"sync": float(np.mean(sync_ms)),
                "pipelined": float(np.mean(pipe_ms))}
        rows[name] = dict(
            tick_ms=tick, preds_per_s={k: STREAMS / (v / 1e3)
                                       for k, v in tick.items()},
            prep_ms={"sync": float(np.mean(sync_prep)),
                     "pipelined": float(np.mean(pipe_prep))},
            h2d_ms={"sync": float(np.mean(sync_h2d)),
                    "pipelined": float(np.mean(pipe_h2d))},
            cpp_pre_normalize=cpp_calls, prob_err_vs_cpu=perr,
            rows_a_forward=STREAMS * SGN_CROPS)
        r = rows[name]
        log(f"  sgn serving (e) {name}: {STREAMS} streams x {SGN_CROPS} "
            f"crops, tick {tick['sync']:.2f} ms sync / "
            f"{tick['pipelined']:.2f} ms pipelined -> "
            f"{r['preds_per_s']['sync']:.1f} / "
            f"{r['preds_per_s']['pipelined']:.1f} preds/s; host prep "
            f"{r['prep_ms']['sync']:.2f} / {r['prep_ms']['pipelined']:.2f} "
            f"ms, h2d {r['h2d_ms']['sync']:.3f} / "
            f"{r['h2d_ms']['pipelined']:.3f} ms; {cpp_calls} C++ "
            f"pre_normalize calls; probabilities within {perr:.2e} of the "
            "cpu's")
        del servers, card
    summary["sgn_serving"] = rows


def phase_sgn_transformer(torch, np, summary):
    """Phase 18: (a)-(e) above, on phase 14's synthetic pickles in one
    temporary directory; the launch counts of all of it must stay 0."""
    from agcn_tpu_torch.data.feeder import SGNDataset
    from agcn_tpu_torch.data.sgn_collate import SegmentSampler
    from agcn_tpu_torch.utils.config import load_config

    t18 = time.perf_counter()
    cfgs = {name: load_config(path)
            for name, path in SGN_TRANSFORMER_CONFIGS.items()}
    reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        paths = write_sgn_pickles(np, tmp)
        train = SGNDataset(*paths["train"], dataset="NTU60-CV-SGN")
        test = SGNDataset(*paths["test"], dataset="NTU60-CV-SGN")
        sampler = SegmentSampler(dataset="NTU60-CV-SGN", seg=20,
                                 multi_test=SGN_CROPS)
        x_eval, _, _, _ = sampler.collate([test[i] for i in range(4)],
                                          np.random.default_rng(SEED),
                                          multi_crop=True)
        part_s, t0 = {}, time.perf_counter()
        states = phase_sgn_transformer_vs_cpu(torch, np, cfgs, x_eval,
                                              summary)
        part_s["a"], t0 = time.perf_counter() - t0, time.perf_counter()
        phase_sgn_transformer_step_vs_cpu(torch, np, cfgs["sgn_v15"],
                                          states["sgn_v15"], x_eval,
                                          summary)
        part_s["b"], t0 = time.perf_counter() - t0, time.perf_counter()
        phase_sgn_transformer_train(torch, np, cfgs, train, summary)
        part_s["c"], t0 = time.perf_counter() - t0, time.perf_counter()
        phase_sgn_transformer_cli(np, paths, tmp, summary)
        part_s["d"], t0 = time.perf_counter() - t0, time.perf_counter()
        phase_sgn_serving(torch, np, states, summary)
        part_s["e"] = time.perf_counter() - t0
    launches = all_launches()
    check(not any(launches.values()), f"phase 18 launched {launches}")
    summary["sgn_transformer_launches"] = launches
    summary["sgn_transformer_phase_s"] = time.perf_counter() - t18
    summary["sgn_transformer_part_s"] = part_s
    log(f"  phase 18 in {summary['sgn_transformer_phase_s']:.1f} s ("
        + ", ".join(f"({k}) {v:.1f}" for k, v in part_s.items()) + ")")
    return launches


# -- phase 19: SGN raw generation and SGN's temporal-branch options -------

SGN_RAW_SAMPLES = 48   # (a): .skeleton files written, one listed missing
SGN_RAW_BATCH = 8      # (a): the entry point's batch on NTU_CV
# (b): each option group at train_sgn.yaml's widths
TEMPORAL_CASES = (
    ("t_mode2", dict(t_mode=2)),
    ("t_mode3", dict(t_mode=3, t_mha_kwargs={"nhead": 2, "num_layers": 1})),
    ("t_mode4", dict(t_mode=4)),
    ("t_mode5", dict(t_mode=5)),
    ("aspp", dict(aspp_rates=[1, 3, 5])),
    ("gcn_fpn8", dict(gcn_fpn=8, multi_t=[[3], [3], [3]])),
    ("t_maxpool", dict(t_maxpool_kwargs={"kernel_size": [1, 2]})),
)


def phase_sgn_raw(torch, np, tmp, summary):
    """(a) A seeded synthetic NTU raw tree (agcn_tpu_torch/tools/
    sgn_raw_tree.py: SGN_RAW_SAMPLES .skeleton files of one to four bodies,
    empty frames, short, wide, returning and tied bodies, and the five
    statistics tables), then `python -m agcn_tpu_torch.data.gen sgn-raw
    --evaluations CS CV` in a subprocess: its 12 pickles, (n, 300, 150)
    finite float32 arrays and 0-based labels, each evaluation's splits
    holding every kept sample once; one C++ pre_normalize call; no
    sklearn, jax or agcn_tpu module imported. Seconds per sample. Then
    phase 14's entry-point check on its NTU_CV pickles (batch
    SGN_RAW_BATCH): one epoch, 5-crop eval, `--phase test`."""
    import pickle

    from agcn_tpu_torch.tools.sgn_raw_tree import write_sgn_raw_tree

    t0 = time.perf_counter()
    stat_dir, raw_dir, names = write_sgn_raw_tree(
        os.path.join(tmp, "raw_tree"), SGN_RAW_SAMPLES, SEED)
    write_s = time.perf_counter() - t0
    out = os.path.join(tmp, "sgn_raw")
    argv = ["agcn_tpu_torch.data.gen", "sgn-raw", "--stat-dir", stat_dir,
            "--skeleton-root", raw_dir, "--out-dir", out, "--evaluations",
            "CS", "CV"]
    code = ("import json, runpy, sys, time\n"
            f"sys.argv = {argv!r}\n"
            "t0 = time.perf_counter()\n"
            "runpy.run_module('agcn_tpu_torch.data.gen', run_name='__main__',"
            " alter_sys=True)\n"
            "seconds = time.perf_counter() - t0\n"
            "from agcn_tpu_torch import native\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('sklearn', 'jax', 'flax', 'agcn_tpu'))\n"
            "print(json.dumps({'seconds': seconds, 'forbidden': bad, "
            "'pre_normalize': native.pre_normalize.calls}))\n")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=600)
    wall_s = time.perf_counter() - t0
    for ln in (proc.stdout.splitlines()[:-1] + proc.stderr.splitlines())[-8:]:
        log(f"      {ln}")
    check(proc.returncode == 0, f"sgn-raw exited {proc.returncode}")
    info = json.loads(proc.stdout.splitlines()[-1])
    check(not info["forbidden"], f"sgn-raw imported {info['forbidden']}")
    check(info["pre_normalize"] == 1,
          f"sgn-raw: {info['pre_normalize']} C++ pre_normalize calls")
    files = sorted(os.listdir(out))
    check(len(files) == 12, f"sgn-raw wrote {files}")
    sizes = {}
    for ev in ("CS", "CV"):
        for split in ("train", "val", "test"):
            base = os.path.join(out, f"NTU_{ev}_{split}")
            with open(base + ".pkl", "rb") as f:
                data = pickle.load(f)
            with open(base + "_label.pkl", "rb") as f:
                labels = np.asarray(pickle.load(f))
            check(data.dtype == np.float32 and data.ndim == 3
                  and data.shape[1:] == (300, 150)
                  and bool(np.isfinite(data).all())
                  and len(labels) == len(data) > 0
                  and labels.min() >= 0 and labels.max() < 60,
                  f"NTU_{ev}_{split}: {data.shape} {data.dtype}, labels "
                  f"{labels.min()}..{labels.max()}")
            sizes[f"{ev}_{split}"] = len(data)
        total = sum(sizes[f"{ev}_{sp}"] for sp in ("train", "val", "test"))
        check(total == len(names),
              f"{ev}: {total} samples in the splits of {len(names)}")
    per_sample = info["seconds"] / len(names)
    log(f"  sgn-raw (a) {len(names)} samples (tree written in {write_s:.2f} "
        f"s): generation {info['seconds']:.3f} s in the subprocess "
        f"({1e3 * per_sample:.2f} ms a sample; {wall_s:.2f} s with its "
        f"start), splits {sizes}; no sklearn / jax / agcn_tpu imported; C++ "
        f"pre_normalize calls {info['pre_normalize']}")
    summary["sgn_raw"] = dict(samples=len(names), seconds=info["seconds"],
                              ms_per_sample=1e3 * per_sample,
                              wall_s=wall_s, write_s=write_s, sizes=sizes)
    paths = {split: (os.path.join(out, f"NTU_CV_{split}.pkl"),
                     os.path.join(out, f"NTU_CV_{split}_label.pkl"))
             for split in ("train", "test")}
    log(f"  sgn-raw (a) the entry points on its NTU_CV pickles, batch "
        f"{SGN_RAW_BATCH}")
    phase_sgn_cli(torch, np, paths, tmp, summary,
                  sizes=(sizes["CV_train"] + sizes["CV_val"],
                         sizes["CV_test"]),
                  batch=SGN_RAW_BATCH, key="sgn_raw_cli", kinetics=False)


def phase_sgn_temporal_options(torch, np, x_eval, train_ds, summary):
    """(b) Each of TEMPORAL_CASES on train_sgn.yaml's SGN (full width,
    seg 20, fp32, TF32 off): with every unit's w1 random and the BN
    statistics of a train-mode forward (`liven_sgn`), the card's eval
    logits of the 4 x 5-crop batch within 2e-4 (of the logit scale where
    it exceeds 1) of the CPU port's at the same weights; then Adam steps
    at the recipe's batch of 64 and dropout: one step's median ms (5
    timed after 2), one step's device time by kernel group
    (torch.profiler) and its busy share; no port kernel launches."""
    from agcn_tpu_torch.data.sgn_collate import SegmentSampler
    from agcn_tpu_torch.utils.config import load_config

    torch.set_num_threads(os.cpu_count() or 1)
    sampler = SegmentSampler(dataset="NTU60-CV-SGN", seg=20)
    x, _, y, _ = sampler.collate([train_ds[i] for i in range(64)],
                                 np.random.default_rng(SEED + 71),
                                 train=True)
    x, y = torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()
    base = load_config(SGN_CONFIG)
    rows = {}
    for name, opts in TEMPORAL_CASES:
        cfg = load_config(SGN_CONFIG, {
            "model_args": dict(base.model_args, **opts)})
        ref = sgn_model(torch, cfg, device="cpu", dropout2d=0.0)
        liven_sgn(torch, ref, x_eval, SEED + 70)
        state = {k: v.detach().clone() for k, v in ref.state_dict().items()}
        with torch.inference_mode():
            want = ref(torch.from_numpy(x_eval)).numpy()
        del ref
        card = sgn_model(torch, cfg, dropout2d=0.0)
        card.load_state_dict(state, strict=True)
        with torch.inference_mode():
            got = card.eval()(torch.from_numpy(x_eval).cuda()).cpu().numpy()
        del card
        scale = float(np.abs(want).max())
        err = float(np.abs(got - want).max())
        check(np.isfinite(got).all() and err <= 2e-4 * max(scale, 1.0),
              f"{name}: card logits off the CPU's by {err:.3e} (scale "
              f"{scale:.3f})")
        model = sgn_model(torch, cfg)
        step = make_step(torch, cfg, model, recipe_loss=True)
        before = all_launches()
        times = []
        for i in range(7):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = step(x, y)["loss"]
            torch.cuda.synchronize()
            if i >= 2:
                times.append((time.perf_counter() - t0) * 1e3)
        ms = sorted(times)[len(times) // 2]
        check(math.isfinite(loss.item()), f"{name}: loss {loss.item()}")
        groups, kernels = step_profile(torch, step, x, y)
        launches = {k: n - before[k] for k, n in all_launches().items()}
        check(not any(launches.values()),
              f"{name}: the training path launched {launches}")
        device_ms = sum(groups.values())
        rows[name] = dict(options=opts, logit_err=err, logit_scale=scale,
                          params=sum(p.numel() for p in model.parameters()),
                          ms_per_step=ms, seq_per_s=64 / ms * 1e3,
                          device_ms=device_ms, busy=device_ms / ms,
                          kernels=kernels, groups=groups, launches=launches)
        log(f"  sgn temporal (b) {name} {opts}: logits card vs cpu "
            f"{err:.3e} of {scale:.3f}; {rows[name]['params']:,} parameters; "
            f"Adam step at batch 64: median {ms:.3f} ms, device "
            f"{device_ms:.3f} ms in {kernels} kernels "
            f"({100 * device_ms / ms:.1f}% busy); launches {launches}")
        del model, step
    summary["sgn_temporal"] = rows


def phase_sgn_temporal(torch, np, summary):
    """Phase 19: (a) and (b) above, in one temporary directory; the launch
    counts of all of it must stay 0."""
    from agcn_tpu_torch.data.feeder import SGNDataset
    from agcn_tpu_torch.data.sgn_collate import SegmentSampler

    t19 = time.perf_counter()
    reset_launches()
    part_s = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        phase_sgn_raw(torch, np, tmp, summary)
        part_s["a"], t0 = time.perf_counter() - t0, time.perf_counter()
        paths = write_sgn_pickles(np, tmp)
        train = SGNDataset(*paths["train"], dataset="NTU60-CV-SGN")
        test = SGNDataset(*paths["test"], dataset="NTU60-CV-SGN")
        sampler = SegmentSampler(dataset="NTU60-CV-SGN", seg=20,
                                 multi_test=SGN_CROPS)
        x_eval, _, _, _ = sampler.collate([test[i] for i in range(4)],
                                          np.random.default_rng(SEED),
                                          multi_crop=True)
        phase_sgn_temporal_options(torch, np, x_eval, train, summary)
        part_s["b"] = time.perf_counter() - t0
    launches = all_launches()
    check(not any(launches.values()), f"phase 19 launched {launches}")
    summary["sgn_temporal_launches"] = launches
    summary["sgn_temporal_phase_s"] = time.perf_counter() - t19
    summary["sgn_temporal_part_s"] = part_s
    log(f"  phase 19 in {summary['sgn_temporal_phase_s']:.1f} s ("
        + ", ".join(f"({k}) {v:.1f}" for k, v in part_s.items()) + ")")
    return launches


# -- phase 20: data-parallel training and the edge partition --------------

PARALLEL_SEQ = 64     # (a): the entry points' T, cut from 300
PARALLEL_STEPS = 2    # (a): steps of the entry points' epoch (batch 64)
DDP_TIMED = 5         # (a): timed steps of the DDP and the plain step
EDGE_BATCH = 16       # (b): samples (x 2 persons) of the card-CPU checks


def run_torchrun(args, timeout=600):
    """`torchrun --standalone --nproc-per-node 1 -m agcn_tpu_torch.main
    <args>` (torchrun is `python -m torch.distributed.run`) in a
    subprocess: a one-rank launch, so the entry point makes an NCCL
    process group on the card; its last lines go to this run's log, and
    a failure fails the phase."""
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "1", "-m", "agcn_tpu_torch.main", *args],
        cwd=REPO, capture_output=True, text=True, timeout=timeout)
    for ln in (proc.stdout.splitlines() + proc.stderr.splitlines())[-6:]:
        log(f"      {ln}")
    check(proc.returncode == 0,
          f"torchrun agcn_tpu_torch.main {' '.join(args)} exited "
          f"{proc.returncode}")


def phase_parallel_cli(np, tmp, summary):
    """(a) train_joint.yaml's AGCN at full width (`formulation: pallas`,
    bf16, batch 64) on synthetic data (PARALLEL_STEPS batches of T =
    PARALLEL_SEQ): one epoch through the entry point's `main` in this
    process (no launcher), then with `world_size: 1`, `ddp: true` under
    torchrun (an NCCL group, DDP,
    SyncBN), and `--phase test` on the DDP checkpoint under torchrun. The
    DDP run's log names NCCL, its per-step losses (event files) are the
    plain run's within 5e-2 relative (PERF.md's bf16 bar), it launches
    gcn_fwd and gcn_bwd at every step, and `--phase test` reproduces its
    top-1."""
    import pickle

    import yaml

    with open(TRAIN_CONFIG) as f:
        recipe = yaml.safe_load(f)
    feeders = {}
    for split, n in (("train", PARALLEL_STEPS * TRAIN_BATCH),
                     ("val", TRAIN_BATCH)):
        rng = np.random.default_rng(SEED + 20 + n)
        x = rng.standard_normal((n, 3, PARALLEL_SEQ, 25, PERSONS))
        paths = (os.path.join(tmp, f"{split}_data.npy"),
                 os.path.join(tmp, f"{split}_label.pkl"))
        np.save(paths[0], x.astype(np.float32))
        with open(paths[1], "wb") as f:
            pickle.dump(([f"{split}{i}" for i in range(n)],
                         rng.integers(0, 60, n).tolist()), f)
        feeders[split] = dict(data_path=paths[0], label_path=paths[1])
    cfgs, works = {}, {}
    for name, extra in (("plain", {}),
                        ("ddp", {"world_size": 1, "ddp": True})):
        works[name] = os.path.join(tmp, f"work_{name}")
        r = dict(recipe, work_dir=works[name], batch_size=TRAIN_BATCH,
                 test_batch_size=TRAIN_BATCH, num_epoch=1, num_worker=2,
                 log_interval=1, save_interval=1, eval_interval=1,
                 show_topk=[1, 5], **extra,
                 model_args=dict(recipe["model_args"], formulation="pallas"),
                 train_feeder_args=dict(recipe["train_feeder_args"],
                                        **feeders["train"]),
                 test_feeder_args=dict(recipe["test_feeder_args"],
                                       **feeders["val"]))
        cfgs[name] = os.path.join(tmp, f"{name}.yaml")
        with open(cfgs[name], "w") as f:
            yaml.safe_dump(r, f)
    from agcn_tpu_torch.main import main as entry_point

    t0 = time.perf_counter()
    log("  (a) agcn_tpu_torch.main, one epoch, in this process (the "
        "reference)")
    with contextlib.redirect_stdout(io.StringIO()):
        entry_point(["--config", cfgs["plain"]])
    log("      torchrun --standalone --nproc-per-node 1 -m "
        "agcn_tpu_torch.main (world_size 1, ddp true)")
    run_torchrun(["--config", cfgs["ddp"]])
    test_dir = os.path.join(tmp, "test")
    log("      torchrun ... --phase test on its checkpoint")
    run_torchrun(["--config", cfgs["ddp"], "--phase", "test", "--weights",
                  os.path.join(works["ddp"], "checkpoints", "epoch_1.pt"),
                  "--work-dir", test_dir])
    cli_s = time.perf_counter() - t0
    with open(os.path.join(works["ddp"], "log.txt")) as f:
        group_line = [ln for ln in f if "process group:" in ln]
    check(len(group_line) == 1 and "nccl" in group_line[0],
          f"the DDP run's process group: {group_line}")
    losses = {name: [v for tag, _, v in read_events(
        os.path.join(work, "event", "train")) if tag == "train/loss"]
        for name, work in works.items()}
    check(len(losses["ddp"]) == len(losses["plain"]) == PARALLEL_STEPS,
          f"logged steps: {losses}")
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["ddp"],
                                                  losses["plain"]))
    check(rel <= 5e-2, f"DDP losses {losses['ddp']} against the plain "
                       f"run's {losses['plain']}: {rel:.3e} relative")
    metrics = {name: read_metrics(os.path.join(work, "metrics.jsonl"))
               for name, work in works.items()}
    test = read_metrics(os.path.join(test_dir, "metrics.jsonl"))
    train = [m for m in metrics["ddp"] if m["kind"] == "train"][0]
    evals = [m for m in metrics["ddp"] if m["kind"] == "eval"]
    check(train["launches"] == {"gcn_fwd_round_agg":
                                PARALLEL_STEPS * 2 * LAYERS,
                                "gcn_fwd_fp32_agg": 0,
                                "gcn_bwd": PARALLEL_STEPS * LAYERS},
          f"the DDP epoch's launches: {train['launches']}")
    check(test[-1]["top1"] == evals[-1]["top1"],
          f"--phase test top-1 {test[-1]['top1']} != the DDP run's "
          f"{evals[-1]['top1']}")
    log(f"      {group_line[0].strip().split('] ', 1)[-1]}; losses plain "
        f"{[round(v, 5) for v in losses['plain']]}, DDP "
        f"{[round(v, 5) for v in losses['ddp']]} ({rel:.2e} relative); "
        f"launches {train['launches']}; eval top-1 {evals[-1]['top1']:.4f}"
        f", --phase test {test[-1]['top1']:.4f}; {cli_s:.1f} s")
    summary["parallel_cli"] = dict(
        group=group_line[0].strip(), losses=losses, loss_rel=rel,
        metrics=metrics, test=test, seconds=cli_s)
    return train["launches"]


def nccl_kernels(prof):
    """(kernels, device ms, names) of NCCL's kernels in a profile: its
    ring and tree kernels (`ncclDevKernel_*`) and, on one rank, its
    one-rank reduce (onerank.cu); not the `nccl:*` annotations that
    torch.profiler lays over them on the device's timeline."""
    from torch.autograd import DeviceType

    n, ms, names = 0, 0.0, set()
    for ev in prof.events():
        name = ev.name.lower()
        if ev.device_type == DeviceType.CUDA and not name.startswith(
                "nccl:") and ("nccl" in name or "onerank" in name):
            n += 1
            ms += ev.device_time_total / 1e3
            names.add(ev.name[:90])
    return n, ms, sorted(names)


def phase_parallel_steps(torch, np, tmp, summary):
    """(a) In this process, a one-rank NCCL group (the launcher's
    variables set here) and the trainer of train_joint.yaml's AGCN
    (`formulation: pallas`, bf16, batch 64, T = 300): DDP over the data
    axis, SyncBN, NCCL's AVG all-reduce a gradient bucket. Its step's ms
    beside the plain step's (no group, no DDP), DDP_TIMED each after 2,
    20 gcn_fwd and 10 gcn_bwd launches a DDP step, and a torch.profiler
    window over two DDP steps with NCCL's kernels counted. (b) On that
    group, model_edge_gcn (the one-rank edge axis: the dense sum) with
    its gradients, edge_partitioned_aggregate (one NCCL all-reduce) and
    SyncBN's forward and backward, card against the CPU (SyncBN against
    the plain BatchNorm there), fp32 with TF32 off, within 1e-5 of each
    output's scale."""
    import socket

    from torch.profiler import ProfilerActivity, profile

    from agcn_tpu_torch.parallel import destroy, init_distributed
    from agcn_tpu_torch.train.trainer import Trainer
    from agcn_tpu_torch.utils.config import load_config

    cfg = load_config(TRAIN_CONFIG, dict(
        work_dir=os.path.join(tmp, "steps"), world_size=1, ddp=True,
        train_feeder_args={}, test_feeder_args={}, print_log=False,
        model_args=dict(load_config(TRAIN_CONFIG).model_args,
                        formulation="pallas")))
    x_np, y_np = train_batch(np, TRAIN_BATCH, SEED + 21)
    x = torch.from_numpy(x_np).cuda()
    y = torch.from_numpy(y_np).cuda()

    def timed(step):
        for _ in range(2):
            step(x, y)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(DDP_TIMED):
            step(x, y)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / DDP_TIMED

    plain_ms = timed(make_step(torch, cfg, train_model(
        torch, cfg, "pallas", "bfloat16")))
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = dict(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK="0",
               WORLD_SIZE="1", LOCAL_RANK="0")
    before = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        check(init_distributed(cfg) is not None, "no process group made")
        trainer = Trainer(cfg)
        check(torch.distributed.get_backend() == "nccl",
              f"backend {torch.distributed.get_backend()}")
        reset_launches()
        ddp_ms = timed(trainer._train_step)
        launches = all_launches()
        steps = 2 + DDP_TIMED
        check(launches == {"gcn_fwd_round_agg": steps * 2 * LAYERS,
                           "gcn_fwd_fp32_agg": 0, "gcn_bwd": steps * LAYERS,
                           "logits": 0},
              f"{steps} DDP steps launched {launches}")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(2):
                trainer._train_step(x, y)
            torch.cuda.synchronize()
        n_nccl, nccl_ms, nccl_names = nccl_kernels(prof)
        check(n_nccl > 0, "no NCCL kernel in the profile of two DDP steps")
        log(f"  (a) in-process DDP step (one-rank NCCL group, SyncBN, AVG "
            f"buckets) {ddp_ms:.2f} ms against the plain step's "
            f"{plain_ms:.2f} ms (bf16, batch 64, T={SEQ}, {DDP_TIMED} steps "
            f"after 2 each); {launches['gcn_fwd_round_agg']} gcn_fwd / "
            f"{launches['gcn_bwd']} gcn_bwd launches in {steps} steps; "
            f"two DDP steps: {n_nccl} NCCL kernels, {nccl_ms:.4f} device ms "
            f"({nccl_names})")
        mesh = trainer.mesh
        del trainer
        edge = phase_parallel_edge(torch, np, mesh)
    finally:
        destroy()
        for k, v in before.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    summary["parallel_steps"] = dict(
        plain_ms=plain_ms, ddp_ms=ddp_ms, launches=launches,
        nccl_kernels=n_nccl, nccl_device_ms=nccl_ms, nccl_names=nccl_names,
        edge=edge)
    return launches


def phase_parallel_edge(torch, np, mesh):
    """(b) above, on the trainer's one-rank mesh (bound to the process, so
    the SyncBN finds its data axis)."""
    from agcn_tpu_torch.graph import build_adjacency
    from agcn_tpu_torch.ops.norm import BatchNorm
    from agcn_tpu_torch.parallel.edge_partition import (
        edge_partitioned_aggregate, model_edge_gcn)

    rng = np.random.default_rng(SEED + 22)
    b = EDGE_BATCH * PERSONS
    host = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for k, s in (("x", (b, SEQ, 25, 64)), ("a1", (b, 3, 25, 25)),
                         ("w", (3, 64, 64)), ("g", (b, SEQ, 25, 64)),
                         ("bn_x", (b, SEQ, 25, 64)))}
    adj = build_adjacency("ntu_rgb_d")
    errs = {}

    def rel(name, card, cpu):
        cpu = cpu.detach()
        err = float((card.detach().cpu() - cpu).abs().max())
        scale = float(cpu.abs().max())
        errs[name] = err / scale
        check(err <= 1e-5 * scale, f"{name}: card against CPU {err:.3e} "
                                   f"(scale {scale:.3e})")

    out = {}
    for dev in ("cuda", "cpu"):
        t = {k: v.to(dev, copy=True).requires_grad_(
            k in ("x", "a1", "w", "bn_x")) for k, v in host.items()}
        y = model_edge_gcn(t["x"], t["a1"], t["w"], mesh)
        (y * t["g"]).sum().backward()
        bn = BatchNorm(64, axis_name="data" if dev == "cuda" else None)
        bn = bn.to(dev).train()
        z = bn(t["bn_x"])
        (z * t["g"]).sum().backward()
        agg = (edge_partitioned_aggregate(t["x"].detach(), adj, mesh)
               if dev == "cuda" else
               torch.einsum("btvc,kvw->kbtwc", t["x"].detach(),
                            torch.from_numpy(adj)))
        out[dev] = dict(y=y, dx=t["x"].grad, da1=t["a1"].grad,
                        dw=t["w"].grad, bn_y=z, bn_dx=t["bn_x"].grad,
                        bn_dscale=bn.weight.grad, bn_dbias=bn.bias.grad,
                        bn_mean=bn.running_mean, bn_var=bn.running_var,
                        agg=agg)
    for name, cpu in out["cpu"].items():
        rel(name, out["cuda"][name], cpu)
    log(f"  (b) on the one-rank NCCL group, card against CPU (fp32): "
        f"model_edge_gcn y/dx/da1/dW, edge_partitioned_aggregate, SyncBN "
        f"y/dx/dscale/dbias/running stats at batch {b}, T={SEQ}, C 64: "
        f"largest {max(errs.values()):.2e} of the scale "
        f"({max(errs, key=errs.get)})")
    return errs


def phase_parallel(torch, np, smi, summary):
    """Phase 20: (a) and (b) above in one temporary directory. Returns the
    launch counts of the DDP training paths (the entry point's epoch and
    the in-process steps)."""
    t20 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        cli = phase_parallel_cli(np, tmp, summary)
        steps = phase_parallel_steps(torch, np, tmp, summary)
    summary["parallel_phase_s"] = time.perf_counter() - t20
    summary["parallel_smi"] = smi
    log(f"  phase 20 in {summary['parallel_phase_s']:.1f} s ({smi})")
    return {k: cli.get(k, 0) + steps[k] for k in steps}


# -- phase 21: the 15-joint OpenPose recipes on the V = 15 kernels --

OPENPOSE_DIR = os.path.join(REPO, "configs", "openpose_b25_j15_xview")
OPENPOSE_CONFIGS = {
    "agcn": os.path.join(OPENPOSE_DIR, "train_joint.yaml"),
    "aagcn": os.path.join(OPENPOSE_DIR, "train_joint_aagcn.yaml")}


def openpose_serving(torch, np, cfg, label, summary):
    """(a) The recipe's model at full width with `formulation: pallas`
    (AAGCN also `eval_formulation`), seeded weights (AGCN's BN and PA as
    phase 7's, AAGCN's as phase 10's: a live attention branch, BN
    statistics from a train-mode forward), serving 16 streams of the
    recipe's joints in fp32 and bf16: LAYERS gcn_fwd launches a forward,
    card against CPU at phase 7's bars, and the device time of one bf16
    served forward by kernel group; AAGCN's served embeddings through the
    logits kernel's entry point (LAYERS launches a forward). Returns
    (gcn_fwd launches, logits launches)."""
    from agcn_tpu_torch.models.registry import build_model
    from agcn_tpu_torch.ops.kernels import gcn_fused, gcn_kernel

    v = joints(cfg)
    args = dict(cfg.model_args, formulation="pallas")
    if cfg.model == "aagcn":
        args["eval_formulation"] = "pallas"
    ref = build_model(cfg.model, args, device="cuda",
                      generator=torch.Generator().manual_seed(SEED))
    if cfg.model == "aagcn":
        prepare_aagcn_eval(torch, np, ref, dense_streams(np, SEQ, v),
                           SEED + 1)
    else:
        randomize_eval_state(torch, ref, SEED + 1)
    state = {k: t.detach().clone() for k, t in ref.state_dict().items()}
    del ref
    models = {}
    for dname in ("float32", "bfloat16"):
        m = build_model(cfg.model, args, device="cuda",
                        dtype=getattr(torch, dname))
        m.load_state_dict(state, strict=True)
        models[dname] = m.eval()
    reset_launches()
    forwards, card_logits, x_check = serve_streams(
        torch, np, models, summary, label, args["num_class"], v)
    launches = {"adaptive_gcn_pallas": gcn_fused.adaptive_gcn_pallas.launches,
                "fused_gcn": gcn_kernel.fused_gcn.launches}
    log(f"  {label} launches {launches} for {forwards} forwards")
    check(launches == {"adaptive_gcn_pallas": LAYERS * forwards,
                       "fused_gcn": 0},
          f"{label} launch counts {launches} != {LAYERS} layers x "
          f"{forwards}")
    check_against_cpu(torch, np, cfg.model, args, state, x_check,
                      card_logits, summary, label)
    phase_profile(torch, {"bfloat16": models["bfloat16"]}, x_check, summary,
                  label)
    logits = 0
    if cfg.model == "aagcn":
        logits, worst = logits_on_served_embeddings(torch, models, x_check)
        summary[f"{label}_logits_served"] = dict(launches=logits,
                                                 max_err_over_scale=worst)
    summary[f"{label}_serve_launches"] = dict(launches, forwards=forwards,
                                              logits=logits)
    return launches["adaptive_gcn_pallas"], logits


def phase_openpose(torch, np, smi, summary):
    """Phase 21: the 15-joint OpenPose recipes, configs/
    openpose_b25_j15_xview/train_joint.yaml (AGCN) and
    train_joint_aagcn.yaml (AAGCN: adaptive, attention, 10 blocks), at
    full width and T = 300 with `formulation: pallas`, through the GCN
    kernels at V = 15: (a) serving (`openpose_serving`); (b) one step at
    batch 4 card against CPU (phase 9 (a)'s bars, the CPU's ReLU masks
    replayed), 10 bf16 steps at batch 64 with 20 gcn_fwd and 10 gcn_bwd
    launches a step, 5 more timed; (c) the entry point `main` (in this
    process) trains and evaluates one epoch of 2 steps on synthetic 15-joint
    data, bf16 as shipped (20 gcn_fwd and 10 gcn_bwd launches a step),
    `--phase test` reproduces its top-1, and `python -m
    agcn_tpu_torch.infer --serve 16` serves the checkpoint. Returns the
    launch counts by path."""
    from agcn_tpu_torch.utils.config import load_config

    t21 = time.perf_counter()
    out = {}
    for family, path in OPENPOSE_CONFIGS.items():
        label = f"openpose_{family}"
        cfg = load_config(path)
        check(joints(cfg) == 15 and cfg.model == family,
              f"{path}: {cfg.model} with {joints(cfg)} joints")
        log(f"  {label}: {os.path.relpath(path, REPO)}")
        serve, logits = openpose_serving(torch, np, cfg, label, summary)
        phase_train_vs_cpu(torch, np, cfg, summary, label)
        train = phase_train_main_path(torch, np, cfg, summary, label,
                                      time_steps=5)
        phase_train_cli(np, summary, path, label, resume=False, serve=True,
                        in_process=True,
                        **({"eval_formulation": "pallas"}
                           if family == "aagcn" else {}))
        cli = {k: sum(m["launches"][k]
                      for m in summary[f"{label}_train_cli"]["train"])
               for k in train}
        out[label] = dict(serve=serve, logits=logits, train=train, cli=cli)
    summary["openpose_launches"] = out
    summary["openpose_phase_s"] = time.perf_counter() - t21
    summary["openpose_smi"] = smi
    log(f"  phase 21 in {summary['openpose_phase_s']:.1f} s ({smi})")
    return out


# -- phase 22: the single-stream live demo ---------------------------------

SINGLE_INTERVAL = 50   # (a): frames between predictions, 6 a recording
SINGLE_TIMED = 20      # (e): timed predictions after the first


def single_stream_recordings(np, tmp):
    """Two seeded 300-frame recordings (V = 25, M = 2), streams 0 and 1 of
    `make_streams`, as (C, T, V, M) .npy files in a directory, cam0 the
    older. Returns the directory and the frames, (2, T, M, 1, V, C)."""
    rec = os.path.join(tmp, "recordings")
    os.makedirs(rec)
    seq = make_streams(np)[:2, :SEQ]
    for i in range(2):
        path = os.path.join(rec, f"cam{i}.npy")
        np.save(path, np.transpose(seq[i, :, :, 0], (3, 0, 2, 1)))
        os.utime(path, (100 + i, 100 + i))
    return rec, seq


def single_stream_state(torch, np, family):
    """The recipe (test_joint.yaml's AGCN or test_joint_aagcn.yaml's
    AAGCN) at full width with `formulation: pallas` (AAGCN also
    `eval_formulation`), seeded weights as phases 7 and 10 make them.
    Returns (model name, model args, the state dict on the CPU)."""
    from agcn_tpu_torch.models.registry import build_model
    from agcn_tpu_torch.utils.config import load_config

    cfg = load_config(CONFIG if family == "agcn" else AAGCN_CONFIG)
    args = dict(cfg.model_args, formulation="pallas")
    if family == "aagcn":
        args["eval_formulation"] = "pallas"
    ref = build_model(cfg.model, args, device="cuda",
                      generator=torch.Generator().manual_seed(SEED))
    if family == "aagcn":
        prepare_aagcn_eval(torch, np, ref, dense_streams(np, SEQ), SEED + 1)
    else:
        randomize_eval_state(torch, ref, SEED + 1)
    state = {k: v.detach().cpu().clone() for k, v in ref.state_dict().items()}
    return cfg.model, args, state


def single_stream_cpu_answers(torch, np, model_name, args, state, seq):
    """The CPU's answers at the CLI's predictions: one recognizer buffer
    through both recordings (the CLI's runs on from one file into the
    next), the model input at every SINGLE_INTERVAL-th frame of a file,
    all of them through the plain versions in one CPU forward. Returns
    (labels, probabilities, logit scale, the CPU model)."""
    from agcn_tpu_torch.infer.preprocess import InferencePreprocessor
    from agcn_tpu_torch.models.registry import build_model

    torch.set_num_threads(os.cpu_count() or 1)
    cpu = build_model(model_name, args, device="cpu", num_frame=SEQ)
    cpu.load_state_dict(state, strict=True)
    cpu.eval()
    pp = InferencePreprocessor(max_seq_length=SEQ)
    xs = []
    for rec in seq:
        for i, frame in enumerate(rec):
            pp.append(frame)
            if (i + 1) % SINGLE_INTERVAL == 0:
                xs.append(pp.dense_input())
    with torch.inference_mode():
        logits = cpu(torch.from_numpy(np.concatenate(xs))).numpy()
    probs = torch.softmax(torch.from_numpy(logits), -1).numpy()
    return probs.argmax(-1), probs, float(np.abs(logits).max()), cpu


def single_stream_cli(torch, np, tmp, rec, seq, family, summary):
    """(a) `python -m agcn_tpu_torch.infer` without --serve, in its own
    process on the card (the CLI computes in fp32, as the root infer.py
    does: neither reads the recipe's compute_dtype), on the directory of
    two recordings with --interval 50 --timing --out-folder: a `== file`
    line a recording, 6 `frame` lines each with its ms, results.txt's
    classes those of the CPU and its probabilities within the serving
    phases' fp32 bar (1e-3 of the logit scale), and (b) 10 gcn_fwd
    (round_agg=1) launches a prediction and no other kernel. Returns the
    state (model name, args, state dict, CPU model) and the launches."""
    import yaml

    model_name, args, state = single_stream_state(torch, np, family)
    weights = os.path.join(tmp, f"{family}.pt")
    torch.save(state, weights)
    cfg_path = os.path.join(tmp, f"{family}.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump({"model": model_name, "model_args": args}, f)
    out_dir = os.path.join(tmp, f"{family}_out")
    t0 = time.perf_counter()
    counts, lines = run_entry_point(
        ["--config", cfg_path, "--weights", weights, "--input", rec,
         "--interval", str(SINGLE_INTERVAL), "--timing", "--out-folder",
         out_dir, "--max-frame", str(SEQ)],
        module="agcn_tpu_torch.infer", stdout=True, kernels=True)
    cli_s = time.perf_counter() - t0
    predicts = 2 * SEQ // SINGLE_INTERVAL
    frames = [ln for ln in lines if ln.startswith("frame ")]
    heads = [ln for ln in lines if ln.startswith("== ")]
    check(heads == [f"== {os.path.join(rec, f'cam{i}.npy')}"
                    for i in range(2)]
          and len(frames) == predicts
          and all(re.fullmatch(r"frame \d+: class \d+ p=[0-9.]+ "
                               r"\([0-9.]+ ms\)", ln) for ln in frames),
          f"{family} single-stream CLI printed {heads} and {frames}")
    with open(os.path.join(out_dir, "results.txt")) as f:
        rows = [ln.strip().split(",") for ln in f if ln.strip()]
    card_labels = np.array([int(r[1]) for r in rows])
    card_p = np.array([float(r[2]) for r in rows])
    check([int(r[0]) for r in rows] == [SINGLE_INTERVAL * (i + 1) for i in
                                        range(SEQ // SINGLE_INTERVAL)] * 2,
          f"{family} results.txt frames {[r[0] for r in rows]}")
    t0 = time.perf_counter()
    labels, probs, scale, cpu = single_stream_cpu_answers(
        torch, np, model_name, args, state, seq)
    cpu_s = time.perf_counter() - t0
    bar = 1e-3 * max(scale, 1.0)
    perr = float(np.abs(card_p - probs[np.arange(predicts),
                                       card_labels]).max())
    top2 = np.sort(probs, -1)[:, -2:]
    flips = [i for i in range(predicts) if card_labels[i] != labels[i]
             and top2[i, 1] - top2[i, 0] > bar]
    log(f"  {family} (a) CLI: {len(frames)} predictions in {cli_s:.1f} s "
        f"(the process, the model's build and the load included); card "
        f"against CPU: probability err {perr:.2e} (bar {bar:.2e}, logit "
        f"scale {scale:.3f}), classes {card_labels.tolist()} vs "
        f"{labels.tolist()}; CPU forward of the {predicts} inputs "
        f"{cpu_s:.1f} s")
    check(perr <= bar and not flips,
          f"{family} single-stream CLI answers off the CPU's: probability "
          f"err {perr:.3e}, classes differ at {flips}")
    launches = {k: counts[k] for k in ("gcn_fwd_round_agg",
                                       "gcn_fwd_fp32_agg", "gcn_bwd",
                                       "logits")}
    log(f"  {family} (b) launches in the CLI's process: {launches} for "
        f"{predicts} predictions")
    check(launches == {"gcn_fwd_round_agg": LAYERS * predicts,
                       "gcn_fwd_fp32_agg": 0, "gcn_bwd": 0, "logits": 0},
          f"{family} single-stream launches {launches} != {LAYERS} x "
          f"{predicts} gcn_fwd (round_agg=1) and nothing else")
    ms = [float(re.search(r"\(([0-9.]+) ms\)", ln)[1]) for ln in frames]
    summary[f"single_stream_{family}_cli"] = dict(
        predictions=len(frames), seconds=cli_s, prob_err=perr, bar=bar,
        logit_scale=scale, card_labels=card_labels.tolist(),
        cpu_labels=labels.tolist(), printed_ms=ms, launches=launches,
        cpu_forward_s=cpu_s)
    return (model_name, args, state, cpu), launches


def run_cli_in_process(argv):
    """The CLI's `main` in this process; its printed lines."""
    from agcn_tpu_torch.infer import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(argv)
    return out.getvalue().splitlines()


def single_stream_extra_runs(torch, np, tmp, rec, agcn, summary):
    """(b) The AGCN with `use_pallas: true` (gcn_kernel's fused_gcn, the
    fp32 aggregate: 10 gcn_fwd round_agg=0 launches a prediction), and
    train_sgn.yaml's SGN (no port kernel, as in the JAX package), each
    through the CLI's single-stream mode in this process on cam0 (6
    predictions); (d) --save-attention: with matplotlib, the PNG of each
    prediction's first block graph; without, the CLI's argument error
    naming it. Returns the launches of each run."""
    import yaml

    from agcn_tpu_torch.infer import cli
    from agcn_tpu_torch.utils.config import load_config

    model_name, args, state, _ = agcn
    cam0 = os.path.join(rec, "cam0.npy")
    predicts = SEQ // SINGLE_INTERVAL
    weights = os.path.join(tmp, "agcn.pt")
    up_path = os.path.join(tmp, "agcn_use_pallas.yaml")
    with open(up_path, "w") as f:
        yaml.safe_dump({"model": model_name,
                        "model_args": dict(args, use_pallas=True)}, f)
    out = {}
    reset_launches()
    lines = run_cli_in_process(["--config", up_path, "--weights", weights,
                                "--input", cam0, "--interval",
                                str(SINGLE_INTERVAL)])
    out["agcn_use_pallas"] = all_launches()
    check(sum(ln.startswith("frame ") for ln in lines) == predicts
          and out["agcn_use_pallas"] == {
              "gcn_fwd_round_agg": 0, "gcn_fwd_fp32_agg": LAYERS * predicts,
              "gcn_bwd": 0, "logits": 0},
          f"use_pallas single stream: {len(lines)} lines, launches "
          f"{out['agcn_use_pallas']}")

    sgn_cfg = load_config(SGN_CONFIG)
    sgn = sgn_model(torch, sgn_cfg)
    liven_sgn(torch, sgn, sgn_sequences(np, 64, SEED + 40)[0][:, :20],
              SEED + 41)
    sgn_weights = os.path.join(tmp, "sgn.pt")
    torch.save({k: v.cpu() for k, v in sgn.state_dict().items()},
               sgn_weights)
    del sgn
    reset_launches()
    lines = run_cli_in_process(["--config", SGN_CONFIG, "--weights",
                                sgn_weights, "--input", cam0, "--interval",
                                str(SINGLE_INTERVAL)])
    out["sgn"] = all_launches()
    check(sum(ln.startswith("frame ") for ln in lines) == predicts
          and not any(out["sgn"].values()),
          f"SGN single stream: {len(lines)} lines, launches {out['sgn']}")
    log(f"  (b) in-process single-stream runs on cam0 ({predicts} "
        f"predictions each): {out}")

    have_mpl = importlib.util.find_spec("matplotlib") is not None
    attn = os.path.join(tmp, "attention")
    argv = ["--config", os.path.join(tmp, "agcn.yaml"), "--weights",
            weights, "--input", cam0, "--interval", str(SEQ // 2),
            "--save-attention", attn]
    if have_mpl:
        run_cli_in_process(argv)
        pngs = sorted(os.listdir(attn))
        check(pngs == [f"cam0_f{SEQ // 2}_g0.png", f"cam0_f{SEQ}_g0.png"],
              f"--save-attention wrote {pngs}")
        said = f"wrote {pngs}"
    else:
        err = io.StringIO()
        refused = False
        with contextlib.redirect_stderr(err):
            try:
                cli.main(argv)
            except SystemExit:
                refused = True
        said = (err.getvalue().strip().splitlines() or [""])[-1]
        check(refused and "matplotlib" in said and not os.path.exists(attn),
              f"--save-attention without matplotlib: refused {refused}, "
              f"said {said!r}")
    log(f"  (d) matplotlib {'is' if have_mpl else 'is not'} installed: "
        f"--save-attention {said}")
    summary["single_stream_save_attention"] = dict(matplotlib=have_mpl,
                                                   said=said)
    summary["single_stream_extra_launches"] = out
    return out


def single_stream_attention(torch, np, family, state_of, seq, summary):
    """(c) The recognizer's `last_attention` on the card, fp32 and bf16,
    against the CPU's on the same frames (cam0's 300): the same length,
    order and shapes, each graph within 1e-3 (fp32) / 5e-2 (bf16) of the
    CPU's scale, the card's probabilities the CPU's within the same bars
    of 1; and (e) the median predict latency on the card after the first,
    with and without exposure (host copies included), and for the dense
    models the device time of the predict's forward alone
    (`profile_forward`)."""
    from agcn_tpu_torch.infer.realtime import ActionRecognition
    from agcn_tpu_torch.models.registry import build_model

    model_name, args, state, cpu, kw = state_of
    num_frame = kw.get("sgn_dataloader_args", {}).get("seg", SEQ)

    def fed(model, expose):
        rec = ActionRecognition(model, expose_attention=expose, **kw)
        for f in seq[0]:
            rec.append_frame(f)
        return rec

    ref = fed(cpu, True)
    _, want_p = ref.predict()
    want = ref.last_attention
    scale = max(float(np.abs(g).max()) for g in want)
    rows = {}
    for dname in ("float32", "bfloat16"):
        if family == "sgn" and dname == "bfloat16":
            continue  # SGN computes in fp32 (the trainer's rule)
        model = build_model(model_name, args, device="cuda",
                            dtype=getattr(torch, dname), num_frame=num_frame)
        model.load_state_dict(state, strict=True)
        bar = 1e-3 if dname == "float32" else 5e-2
        times = {}
        for expose in (True, False):
            rec = fed(model.eval(), expose)
            _, got_p = rec.predict()
            if expose:
                got = rec.last_attention
                check(len(got) == len(want) and all(
                    g.shape == w.shape for g, w in zip(got, want)),
                    f"{family} {dname}: {len(got)} graphs "
                    f"{[g.shape for g in got]} against the CPU's "
                    f"{[w.shape for w in want]}")
                err = max(float(np.abs(g - w).max())
                          for g, w in zip(got, want))
                perr = float(np.abs(got_p - want_p).max())
                check(err <= bar * max(scale, 1.0) and perr <= bar,
                      f"{family} {dname}: graphs {err:.3e} off the CPU's "
                      f"(scale {scale:.3f}), probabilities {perr:.3e}")
            ms = []
            for _ in range(SINGLE_TIMED):
                rec.predict()
                ms.append(rec.last_latency_ms)
            times["exposed" if expose else "plain"] = float(np.median(ms))
        rows[dname] = dict(graphs=len(got), graph_err=err,
                           graph_scale=scale, prob_err=perr,
                           predict_ms_median=times)
        log(f"  {family} {dname} (c) {len(got)} graphs {got[0].shape}, "
            f"max err {err:.2e} of scale {scale:.3f}, probabilities "
            f"{perr:.2e}; (e) predict {times['plain']:.3f} ms, "
            f"{times['exposed']:.3f} ms with exposure (median of "
            f"{SINGLE_TIMED} after the first)")
        if family != "sgn":
            # the predict's forward alone: its device time and busy share
            prof = profile_forward(torch, model, torch.from_numpy(
                rec.preproc.dense_input()).cuda())
            rows[dname]["forward_profile"] = prof
            busy = 100 * prof["device_ms"] / prof["wall_ms"]
            log(f"      its forward: wall {prof['wall_ms']:.3f} ms, device "
                f"{prof['device_ms']:.3f} ms ({busy:.1f}% busy) in "
                f"{sum(prof['kernels'].values()):.0f} kernels")
        del model
    summary[f"single_stream_{family}_recognizer"] = rows


def phase_single_stream(torch, np, smi, summary):
    """Phase 22: the single-stream live demo (`python -m
    agcn_tpu_torch.infer` without --serve, ActionRecognition with
    `expose_attention`): (a) the CLI in its own process for
    test_joint.yaml's AGCN and test_joint_aagcn.yaml's AAGCN against the
    CPU (`single_stream_cli`), (b) its launches, and those of the
    use_pallas AGCN and train_sgn.yaml's SGN, (d) --save-attention
    (`single_stream_extra_runs`), (c) the recognizer's graphs card
    against CPU and (e) its latency (`single_stream_attention`). Returns
    the launch counts by path."""
    from agcn_tpu_torch.utils.config import load_config

    t22 = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        rec, seq = single_stream_recordings(np, tmp)
        states = {}
        for family in ("agcn", "aagcn"):
            states[family], out[f"{family}_single_stream"] = \
                single_stream_cli(torch, np, tmp, rec, seq, family, summary)
        extra = single_stream_extra_runs(torch, np, tmp, rec,
                                         states["agcn"], summary)
        out["agcn_single_stream_use_pallas"] = extra["agcn_use_pallas"]
        out["sgn_single_stream"] = extra["sgn"]
    for family in ("agcn", "aagcn"):
        single_stream_attention(torch, np, family,
                                (*states[family], {}), seq, summary)
    sgn_cfg = load_config(SGN_CONFIG)
    sgn = sgn_model(torch, sgn_cfg, device="cpu")
    liven_sgn(torch, sgn, sgn_sequences(np, 64, SEED + 40)[0][:, :20],
              SEED + 41)
    sgn_args = sgn_cfg.test_dataloader_args
    single_stream_attention(
        torch, np, "sgn",
        (sgn_cfg.model, sgn_cfg.model_args,
         {k: v.clone() for k, v in sgn.state_dict().items()}, sgn,
         dict(kind="sgn", multi_test=sgn_args["multi_test"],
              sgn_dataloader_args=sgn_args)), seq, summary)
    summary["single_stream_launches"] = out
    summary["single_stream_phase_s"] = time.perf_counter() - t22
    summary["single_stream_smi"] = smi
    log(f"  phase 22 in {summary['single_stream_phase_s']:.1f} s ({smi})")
    return out


# -- phase 23: the rest of SGN's GCN stack and head (no TPU kernel) --------

# (b): each case at train_sgn.yaml's widths; together every option value
# of the GCN stack and head (gt modes 0, 5, 6; attn modes 1-3, 10;
# gcn_fpn 10 and every sgcn2_* option; gcn_fpn_output_merge 2; the FFN
# variants 0xx-3xx, residual, prenorm, g_weighted, v_kernel, the unit's
# and G's kernels; spatial pools 0, 3-5, temporal pools 0, 2-5)
STACK_CASES = (
    ("fpn10_merge2", dict(gcn_fpn=10, gcn_fpn_output_merge=2,
                          temporal_maxpool=2, multi_t=[[], [], [3, 5]])),
    ("fpn10_sgcn2", dict(gcn_fpn=10, sgcn2_dims=[256, 128, 256],
                         sgcn2_attn_mode=10, sgcn2_kernel=3, sgcn2_padding=1,
                         sgcn2_v_kernel=3, sgcn2_residual=[1, 1, 1],
                         sgcn2_prenorm=True, sgcn2_ffn=304.0,
                         sgcn2_dropout=0.2, sgcn_attn_mode=10,
                         sgcn_ffn=4.0)),
    ("gt0_unit", dict(sgcn_gt_mode=0, sgcn_g_proj_dim=[256, 128, 256],
                      sgcn_g_weighted=True, sgcn_g_kernel=3, sgcn_kernel=3,
                      sgcn_padding=1, sgcn_v_kernel=3,
                      sgcn_residual=[1, 1, 1], sgcn_prenorm=True,
                      sgcn_ffn=104.0, sgcn_attn_mode=2, spatial_maxpool=4,
                      temporal_maxpool=3)),
    ("gt5", dict(sgcn_gt_mode=5, sgcn_attn_mode=1, spatial_maxpool=5,
                 temporal_maxpool=4)),
    ("gt6", dict(sgcn_gt_mode=6, multi_t=[[], [], [3], [3]],
                 sgcn_attn_mode=3, spatial_maxpool=3, temporal_maxpool=5)),
    ("pools0", dict(spatial_maxpool=0, temporal_maxpool=0,
                    gcn_fpn_output_merge=2, sgcn_ffn=204.0)),
)
STACK_CLI_CASE = "fpn10_merge2"   # (c): through the entry point


def argmax_ties_on_card(torch, np):
    """(a) temporal_maxpool 2 embeds the argmax over the frames, and a
    ReLU leaves channels tied at 0: on the card, as on the CPU and in
    JAX, the first frame of a tie wins. A (64, 20, 1, 512) tensor of
    integers in [0, 2] (ties everywhere) on the card against numpy's
    argmax, which takes the first."""
    y = np.random.default_rng(SEED + 80).integers(
        0, 3, (64, 20, 1, 512)).astype(np.float32)
    want = np.argmax(y, axis=1)
    got = torch.argmax(torch.from_numpy(y).cuda(), dim=1).cpu().numpy()
    check(np.array_equal(got, want),
          f"argmax on the card left the first frame of a tie in "
          f"{int((got != want).sum())} of {want.size} channels")
    log(f"  sgn stack (a) argmax over {want.size} channels with ties on "
        "the card: the first frame, as numpy and JAX take it")


def phase_sgn_cases(torch, np, cases, x_eval, train_ds, seed, label):
    """Each of `cases` ((name, options) over train_sgn.yaml's
    `model_args`) on the recipe's SGN (full width, seg 20, fp32, TF32
    off): with every unit's w1 random and the BN statistics of a
    train-mode forward (`liven_sgn`), the card's eval logits of the 4 x
    5-crop batch within 2e-4 (of the logit scale where it exceeds 1) of
    the CPU port's at the same weights; then Adam steps at the recipe's
    batch of 64 and dropout: one step's median ms (5 timed after 2), one
    step's device time by kernel group (torch.profiler) and its busy
    share, the parameter count; no port kernel launches. Returns the
    rows by case."""
    from agcn_tpu_torch.data.sgn_collate import SegmentSampler
    from agcn_tpu_torch.utils.config import load_config

    torch.set_num_threads(os.cpu_count() or 1)
    sampler = SegmentSampler(dataset="NTU60-CV-SGN", seg=20)
    x, _, y, _ = sampler.collate([train_ds[i] for i in range(64)],
                                 np.random.default_rng(seed), train=True)
    x, y = torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()
    base = load_config(SGN_CONFIG)
    rows = {}
    for name, opts in cases:
        cfg = load_config(SGN_CONFIG, {
            "model_args": dict(base.model_args, **opts)})
        ref = sgn_model(torch, cfg, device="cpu", dropout2d=0.0)
        liven_sgn(torch, ref, x_eval, seed + 1)
        state = {k: v.detach().clone() for k, v in ref.state_dict().items()}
        with torch.inference_mode():
            want = ref(torch.from_numpy(x_eval)).numpy()
        del ref
        card = sgn_model(torch, cfg, dropout2d=0.0)
        card.load_state_dict(state, strict=True)
        with torch.inference_mode():
            got = card.eval()(torch.from_numpy(x_eval).cuda()).cpu().numpy()
        del card
        scale = float(np.abs(want).max())
        err = float(np.abs(got - want).max())
        check(np.isfinite(got).all() and err <= 2e-4 * max(scale, 1.0),
              f"{name}: card logits off the CPU's by {err:.3e} (scale "
              f"{scale:.3f})")
        model = sgn_model(torch, cfg)
        step = make_step(torch, cfg, model, recipe_loss=True)
        before = all_launches()
        times = []
        for i in range(7):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = step(x, y)["loss"]
            torch.cuda.synchronize()
            if i >= 2:
                times.append((time.perf_counter() - t0) * 1e3)
        ms = sorted(times)[len(times) // 2]
        check(math.isfinite(loss.item()), f"{name}: loss {loss.item()}")
        groups, kernels = step_profile(torch, step, x, y)
        launches = {k: n - before[k] for k, n in all_launches().items()}
        check(not any(launches.values()),
              f"{name}: the training path launched {launches}")
        device_ms = sum(groups.values())
        rows[name] = dict(options=opts, logit_err=err, logit_scale=scale,
                          params=sum(p.numel() for p in model.parameters()),
                          ms_per_step=ms, seq_per_s=64 / ms * 1e3,
                          device_ms=device_ms, busy=device_ms / ms,
                          kernels=kernels, groups=groups, launches=launches)
        log(f"  {label} {name}: logits card vs cpu {err:.3e} of "
            f"{scale:.3f}; {rows[name]['params']:,} parameters; Adam step "
            f"at batch 64: median {ms:.3f} ms, device {device_ms:.3f} ms in "
            f"{kernels} kernels ({100 * device_ms / ms:.1f}% busy); "
            f"launches {launches}")
        for g, gms in sorted(groups.items(), key=lambda kv: -kv[1])[:4]:
            log(f"    {gms:9.3f} ms {100 * gms / device_ms:5.1f}%  {g}")
        del model, step
    return rows


def phase_sgn_case_cli(np, paths, tmp, name, opts, label, loader_args=()):
    """The entry point's `main`, in this process, on a copy of
    train_sgn.yaml with `opts` over its `model_args` (and `loader_args`
    over both loaders' arguments) pointed at phase 14's pickles: one
    epoch (batch 64), eval with multi_test 5 and a checkpoint; `--phase
    test` on the checkpoint must reproduce the run's top-1; finite loss,
    no port kernel launches. Returns the metrics of both runs."""
    import yaml

    from agcn_tpu_torch.main import main as entry_point

    with open(SGN_CONFIG) as f:
        recipe = yaml.safe_load(f)
    work = os.path.join(tmp, name)
    recipe.update(
        work_dir=work, num_epoch=1, num_worker=2, log_interval=1,
        save_interval=1, eval_interval=1, show_topk=[1, 5],
        model_args=dict(recipe["model_args"], **opts),
        train_feeder_args=dict(recipe["train_feeder_args"],
                               data_path=paths["train"][0],
                               label_path=paths["train"][1]),
        test_feeder_args=dict(recipe["test_feeder_args"],
                              data_path=paths["test"][0],
                              label_path=paths["test"][1]),
        train_dataloader_args=dict(recipe["train_dataloader_args"],
                                   **dict(loader_args)),
        test_dataloader_args=dict(recipe["test_dataloader_args"],
                                  **dict(loader_args)))
    cfg_path = os.path.join(tmp, f"{name}.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(recipe, f)
    log(f"  {label} the entry point's main on train_sgn.yaml with {name}"
        + "".join(f" and {k} {v}" for k, v in dict(loader_args).items())
        + ": train + eval (multi_test 5) + save, one epoch; then --phase "
        "test")
    with contextlib.redirect_stdout(io.StringIO()):
        entry_point(["--config", cfg_path])
        entry_point(["--config", cfg_path, "--phase", "test", "--weights",
                     os.path.join(work, "checkpoints", "epoch_1.pt"),
                     "--work-dir", f"{work}_test"])
    metrics = read_metrics(os.path.join(work, "metrics.jsonl"))
    test = read_metrics(os.path.join(f"{work}_test", "metrics.jsonl"))
    trains = [m for m in metrics if m["kind"] == "train"]
    evals = [m for m in metrics if m["kind"] == "eval"]
    check(len(trains) == 1 and len(evals) == 1
          and math.isfinite(trains[0]["loss"]),
          f"{name} entry point: {metrics}")
    check(not any(trains[0]["launches"].values()),
          f"{name} entry point launched {trains[0]['launches']}")
    check(test[-1]["top1"] == evals[-1]["top1"],
          f"--phase test top-1 {test[-1]['top1']} != the run's "
          f"{evals[-1]['top1']}")
    log(f"      loss {trains[0]['loss']:.4f} over {trains[0]['steps']} "
        f"steps, {trains[0]['seq_per_sec']:.1f} seq/s; eval top-1 "
        f"{evals[-1]['top1']:.4f}, --phase test top-1 "
        f"{test[-1]['top1']:.4f}")
    return dict(train=trains, eval=evals, test=test)


def phase_sgn_stack(torch, np, smi, summary):
    """Phase 23: (a)-(c) above on phase 14's synthetic pickles, in one
    temporary directory; the launch counts of all of it must stay 0."""
    from agcn_tpu_torch.data.feeder import SGNDataset
    from agcn_tpu_torch.data.sgn_collate import SegmentSampler

    t23 = time.perf_counter()
    reset_launches()
    part_s = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        argmax_ties_on_card(torch, np)
        paths = write_sgn_pickles(np, tmp)
        train = SGNDataset(*paths["train"], dataset="NTU60-CV-SGN")
        test = SGNDataset(*paths["test"], dataset="NTU60-CV-SGN")
        sampler = SegmentSampler(dataset="NTU60-CV-SGN", seg=20,
                                 multi_test=SGN_CROPS)
        x_eval, _, _, _ = sampler.collate([test[i] for i in range(4)],
                                          np.random.default_rng(SEED),
                                          multi_crop=True)
        summary["sgn_stack"] = phase_sgn_cases(
            torch, np, STACK_CASES, x_eval, train, SEED + 81,
            "sgn stack (b)")
        part_s["ab"], t0 = time.perf_counter() - t0, time.perf_counter()
        summary["sgn_stack_cli"] = phase_sgn_case_cli(
            np, paths, tmp, STACK_CLI_CASE, dict(STACK_CASES)[STACK_CLI_CASE],
            "sgn stack (c)")
        part_s["c"] = time.perf_counter() - t0
    launches = all_launches()
    check(not any(launches.values()), f"phase 23 launched {launches}")
    summary["sgn_stack_launches"] = launches
    summary["sgn_stack_phase_s"] = time.perf_counter() - t23
    summary["sgn_stack_part_s"] = part_s
    summary["sgn_stack_smi"] = smi
    log(f"  phase 23 in {summary['sgn_stack_phase_s']:.1f} s ("
        + ", ".join(f"({k}) {v:.1f}" for k, v in part_s.items())
        + f"; {smi})")
    return launches


INPUT_SEGMENTS = dict(input_position=1001, input_velocity=1001)
INPUT_CASES = (
    ("jdiff", dict(semantic_jdiff=1)),
    ("xem_projection", dict(xem_projection=1)),
    ("frame_first", dict(semantic_frame_location=1)),
    ("joint_smp", dict(semantic_joint_smp=1)),
    ("segments", INPUT_SEGMENTS),
    ("segments_jdiff", dict(INPUT_SEGMENTS, semantic_jdiff=1)),
)
INPUT_CLI_CASE = "segments"        # (c): with midvel_sampler 1
INPUT_COLLATE_TIMED = 3            # (b): timed collates of each kind


def phase_sgn_input_collate(np, train_ds, test_ds, summary):
    """(b) `midvel_sampler: 1` (the k-means segment split, numpy only, no
    scikit-learn on this machine) on phase 14's pickles: the host ms of a
    64-row training collate and a 4 x 5-crop test collate (median of
    INPUT_COLLATE_TIMED), beside the equal split's; every sequence's
    bounds start at 0, rise strictly and end at its frame count, 21 of
    them for 20 segments; the batches' shapes."""
    from agcn_tpu_torch import native
    from agcn_tpu_torch.data import transforms
    from agcn_tpu_torch.data.sgn_collate import SegmentSampler

    batch = [train_ds[i] for i in range(64)]
    crops = [test_ds[i] for i in range(4)]
    times = {}
    for policy, kw in (("midvel", {"midvel_sampler": 1}), ("equal", {})):
        sampler = SegmentSampler(dataset="NTU60-CV-SGN", seg=20,
                                 multi_test=SGN_CROPS, **kw)
        rng = np.random.default_rng(SEED + 93)
        times[policy], shapes = {}, []
        for kind, items, train in (("train_ms", batch, True),
                                   ("test_ms", crops, False)):
            ms = []
            for _ in range(INPUT_COLLATE_TIMED):
                t0 = time.perf_counter()
                x = sampler.collate(items, rng, train=train,
                                    multi_crop=not train)[0]
                ms.append((time.perf_counter() - t0) * 1e3)
            times[policy][kind] = sorted(ms)[len(ms) // 2]
            shapes.append(x.shape)
        check(shapes == [(64, 20, 75), (4 * SGN_CROPS, 20, 75)],
              f"{policy}: collated shapes {shapes}")
    for seq, _, _ in batch + crops:
        frames = sampler.pad(native.flatten_persons(seq)[0])
        bounds = transforms.split_idx_using_kmeans(frames, 20)
        check(len(bounds) == 21 and bounds[0] == 0
              and bounds[-1] == len(frames)
              and bool(np.all(np.diff(bounds) > 0)),
              f"k-means bounds {bounds} for {len(frames)} frames")
    log(f"  sgn input (b) host collate, midvel_sampler 1 (k-means): train "
        f"64 rows {times['midvel']['train_ms']:.2f} ms, test 4 x "
        f"{SGN_CROPS} crops {times['midvel']['test_ms']:.2f} ms; the equal "
        f"split: {times['equal']['train_ms']:.2f} ms, "
        f"{times['equal']['test_ms']:.2f} ms (median of "
        f"{INPUT_COLLATE_TIMED}); the bounds of {len(batch) + len(crops)} "
        "sequences well formed")
    summary["sgn_input_collate"] = times


def phase_sgn_input(torch, np, smi, summary):
    """Phase 24: (a)-(c) above on phase 14's synthetic pickles, in one
    temporary directory; the launch counts of all of it must stay 0."""
    from agcn_tpu_torch.data.feeder import SGNDataset
    from agcn_tpu_torch.data.sgn_collate import SegmentSampler

    t24 = time.perf_counter()
    reset_launches()
    part_s = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        paths = write_sgn_pickles(np, tmp)
        train = SGNDataset(*paths["train"], dataset="NTU60-CV-SGN")
        test = SGNDataset(*paths["test"], dataset="NTU60-CV-SGN")
        sampler = SegmentSampler(dataset="NTU60-CV-SGN", seg=20,
                                 multi_test=SGN_CROPS)
        x_eval, _, _, _ = sampler.collate([test[i] for i in range(4)],
                                          np.random.default_rng(SEED),
                                          multi_crop=True)
        summary["sgn_input"] = phase_sgn_cases(
            torch, np, INPUT_CASES, x_eval, train, SEED + 91,
            "sgn input (a)")
        part_s["a"], t0 = time.perf_counter() - t0, time.perf_counter()
        phase_sgn_input_collate(np, train, test, summary)
        part_s["b"], t0 = time.perf_counter() - t0, time.perf_counter()
        summary["sgn_input_cli"] = phase_sgn_case_cli(
            np, paths, tmp, INPUT_CLI_CASE, dict(INPUT_CASES)[INPUT_CLI_CASE],
            "sgn input (c)", {"midvel_sampler": 1})
        part_s["c"] = time.perf_counter() - t0
    launches = all_launches()
    check(not any(launches.values()), f"phase 24 launched {launches}")
    summary["sgn_input_launches"] = launches
    summary["sgn_input_phase_s"] = time.perf_counter() - t24
    summary["sgn_input_part_s"] = part_s
    summary["sgn_input_smi"] = smi
    log(f"  phase 24 in {summary['sgn_input_phase_s']:.1f} s ("
        + ", ".join(f"({k}) {v:.1f}" for k, v in part_s.items())
        + f"; {smi})")
    return launches


# -- phase 25: the GCN kernels at any joint count --------------------------

STGAT_JOINTS = 31      # (b), (c): NTU's 25 joints and STGAT's 6 part nodes
STGAT_STEPS = 3        # (b): SGD steps at batch 64, the first untimed
GEN_ITERS = (3, 1)     # (a): timed calls of a kernel, of a plain / einsum


def stgat_adj(np):
    """The (3, 31, 31) adjacency of the STGAT expanded graph of NTU-25:
    [I, N, N^T], N the in-degree normalized graph without its self
    links."""
    from agcn_tpu_torch.graph.build import (expanded_graph,
                                            normalize_in_degree)
    from agcn_tpu_torch.graph.skeletons import get_skeleton

    a = expanded_graph(get_skeleton("ntu_rgb_d"), 1)
    eye = np.eye(a.shape[0])
    n = normalize_in_degree(a - eye)
    return np.stack([eye, n, n.T]).astype(np.float32)


def stgat_model(torch, np, family, dname, device="cuda", generator=None,
                **kw):
    """AGCN or AAGCN at full width (10 blocks, 60 classes, M = 2) on the
    STGAT graph with `formulation: pallas` (AAGCN also `eval_formulation`),
    computing in `dname`."""
    from agcn_tpu_torch.models import AAGCN, AGCN

    extra = {"eval_formulation": "pallas"} if family == "aagcn" else {}
    cls = AAGCN if family == "aagcn" else AGCN
    return cls(num_class=60, num_point=STGAT_JOINTS, adj=stgat_adj(np),
               formulation="pallas", device=device,
               dtype=None if dname == "float32" else torch.bfloat16,
               generator=generator, **extra, **kw)


def stgat_vs_cpu(torch, np, family, state, x, card_logits, label, summary,
                 **kw):
    """The same weights and input on device="cpu" (the kernels' plain
    versions): fp32 card logits within 1e-3 of the logit scale, bf16
    within 5e-2 (check_against_cpu's bars)."""
    torch.set_num_threads(os.cpu_count() or 1)
    cpu = stgat_model(torch, np, family, "float32", device="cpu", **kw)
    cpu.load_state_dict({k: v.cpu() for k, v in state.items()}, strict=True)
    t0 = time.perf_counter()
    with torch.inference_mode():
        ref = cpu.eval()(torch.from_numpy(x))
    ref = (ref[0] if isinstance(ref, tuple) else ref).numpy()
    cpu_s = time.perf_counter() - t0
    scale = float(np.abs(ref).max())
    errs = {d: float(np.abs(card_logits[d] - ref).max()) for d in card_logits}
    log(f"  {label} card vs cpu logits: max err {errs} (logit scale "
        f"{scale:.3f}), cpu forward {cpu_s:.1f} s")
    for name, err in errs.items():
        bar = 1e-3 if name.startswith("float32") else 5e-2
        check(err <= bar * max(scale, 1.0),
              f"{label} {name} card logits off the CPU reference by "
              f"{err:.3e}")
    summary[f"{label}_card_vs_cpu"] = dict(logit_err=errs, logit_scale=scale)


def stgat_served(torch, np, family, summary):
    """One served forward (16 sequences x 2 persons = 32 samples, T = 300,
    V = 31) of `family` in fp32 and bf16 with seeded weights (AGCN's BN
    and PA as phase 7's, AAGCN's as phase 10's), timed first (CUDA
    events, 3 calls after 2), then with the launch counts reset: LAYERS
    gcn_fwd launches a forward, card against CPU. AGCN: also a
    bf16 forward with `use_pallas` (gcn_kernel's fused_gcn, the fp32
    aggregate), LAYERS fused_gcn launches. AAGCN: the served embeddings
    through the logits kernel's entry point (`logits_on_served_embeddings`,
    LAYERS launches a forward). Returns the launch counts."""
    from agcn_tpu_torch.ops.kernels import gcn_fused, gcn_kernel

    label = f"{family}_stgat"
    x, _ = train_batch(np, STREAMS, SEED + 31, v=STGAT_JOINTS)
    ref = stgat_model(torch, np, family, "float32",
                      generator=torch.Generator().manual_seed(SEED))
    if family == "aagcn":
        prepare_aagcn_eval(torch, np, ref, x, SEED + 1)
    else:
        randomize_eval_state(torch, ref, SEED + 1)
    state = {k: t.detach().clone() for k, t in ref.state_dict().items()}
    del ref
    models = {}
    for dname in ("float32", "bfloat16"):
        models[dname] = stgat_model(torch, np, family, dname)
        models[dname].load_state_dict(state, strict=True)
        models[dname].eval()
    xc = torch.from_numpy(x).cuda()
    with torch.inference_mode():
        ms = {d: cuda_time_ms(lambda: m(xc), 3) for d, m in models.items()}
    reset_launches()
    card = {}
    with torch.inference_mode():
        for dname, m in models.items():
            out = m(xc)
            card[dname] = (out[0] if isinstance(out, tuple) else out
                           ).float().cpu().numpy()
            check(card[dname].shape == (STREAMS, 60)
                  and np.isfinite(card[dname]).all(),
                  f"{label} {dname}: logits {card[dname].shape}, finite "
                  f"{np.isfinite(card[dname]).all()}")
    launches = {"gcn_fwd_round_agg": gcn_fused.adaptive_gcn_pallas.launches,
                "gcn_fwd_fp32_agg": gcn_kernel.fused_gcn.launches}
    check(launches == {"gcn_fwd_round_agg": 2 * LAYERS,
                       "gcn_fwd_fp32_agg": 0},
          f"{label}: launches {launches} for two served forwards")
    log(f"  {label} (V={STGAT_JOINTS}) served forward of 32 samples, T=300: "
        f"{ms['float32']:.2f} ms fp32, {ms['bfloat16']:.2f} ms bf16; "
        f"launches {launches} in the two checked forwards")
    if family == "agcn":
        models["bfloat16 use_pallas"] = stgat_model(torch, np, family,
                                                     "bfloat16",
                                                     use_pallas=True)
        models["bfloat16 use_pallas"].load_state_dict(state, strict=True)
        reset_launches()
        with torch.inference_mode():
            card["bfloat16 use_pallas"] = models["bfloat16 use_pallas"].eval(
                )(xc).float().cpu().numpy()
        launches["gcn_fwd_fp32_agg"] = gcn_kernel.fused_gcn.launches
        check(launches["gcn_fwd_fp32_agg"] == LAYERS
              and gcn_fused.adaptive_gcn_pallas.launches == 0,
              f"{label} use_pallas: {launches['gcn_fwd_fp32_agg']} fused_gcn "
              f"and {gcn_fused.adaptive_gcn_pallas.launches} gcn_fwd "
              "launches in a forward")
    stgat_vs_cpu(torch, np, family, state, x, card, label, summary)
    launches["logits"] = 0
    if family == "aagcn":
        launches["logits"], worst = logits_on_served_embeddings(torch,
                                                                models, x)
        summary[f"{label}_logits_served"] = dict(launches=launches["logits"],
                                                 max_err_over_scale=worst)
        # the embeddings' two capture forwards launched gcn_fwd too
        launches["gcn_fwd_round_agg"] = gcn_fused.adaptive_gcn_pallas.launches
        check(launches["gcn_fwd_round_agg"] == 4 * LAYERS,
              f"{label}: {launches['gcn_fwd_round_agg']} gcn_fwd launches in "
              "four forwards")
    summary[f"{label}_serve"] = dict(ms=ms, launches=launches)
    return launches


def stgat_train(torch, np, summary):
    """(b) STGAT_STEPS SGD steps (train_joint.yaml's loss and optimizer:
    clip, decay, nesterov) of the bf16 pallas AGCN on the STGAT graph at
    batch 64 on one batch, the first untimed: finite losses, 2 LAYERS
    gcn_fwd (forward and dx) and LAYERS gcn_bwd launches a step; ms a
    step (host clock, synchronized) and peak memory of the timed ones.
    Returns the launch counts."""
    from agcn_tpu_torch.ops.kernels import gcn_fused, gcn_kernel
    from agcn_tpu_torch.utils.config import load_config

    model = stgat_model(torch, np, "agcn", "bfloat16",
                        generator=torch.Generator().manual_seed(SEED))
    step = make_step(torch, load_config(TRAIN_CONFIG), model)
    x, y = train_batch(np, TRAIN_BATCH, SEED + 7, v=STGAT_JOINTS)
    x, y = torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()
    reset_launches()
    losses = [step(x, y)["loss"].item()]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses += [step(x, y)["loss"] for _ in range(STGAT_STEPS - 1)]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / (STGAT_STEPS - 1)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [float(v) for v in losses]
    launches = {"gcn_fwd_round_agg": gcn_fused.adaptive_gcn_pallas.launches,
                "gcn_fwd_fp32_agg": gcn_kernel.fused_gcn.launches,
                "gcn_bwd": gcn_fused.gcn_backward.launches}
    log(f"  agcn_stgat (b) {STGAT_STEPS} bf16 SGD steps at batch "
        f"{TRAIN_BATCH}: loss {' '.join(f'{v:.4f}' for v in losses)}; "
        f"{ms:.2f} ms/step, {TRAIN_BATCH / ms * 1e3:.1f} seq/s, peak "
        f"{peak:.2f} GiB (the last {STGAT_STEPS - 1}); launches {launches}")
    check(all(math.isfinite(v) for v in losses),
          f"agcn_stgat: non-finite loss {losses}")
    check(launches == {"gcn_fwd_round_agg": 2 * LAYERS * STGAT_STEPS,
                       "gcn_fwd_fp32_agg": 0,
                       "gcn_bwd": LAYERS * STGAT_STEPS},
          f"agcn_stgat: launch counts {launches} for {STGAT_STEPS} steps")
    summary["agcn_stgat_train"] = dict(
        losses=losses, ms_per_step=ms, seq_per_s=TRAIN_BATCH / ms * 1e3,
        peak_gib=peak, timed_steps=STGAT_STEPS - 1, launches=launches)
    return launches


def phase_any_joints(torch, np, smi, summary):
    """Phase 25: the GCN kernels at joint counts outside the tuned 15, 18
    and 25 (the general kernels). (a) each general kernel against its
    plain version at V = 1, 7, 16, 32, 33, 31 and 67 on small shapes
    (`check_general_small`), then at V = 31 and 67 the layer shapes of a
    served forward (batch 32) and of a training step (batch 128), as
    phases 3 and 4 (CUDA events: kernel, plain and einsum times beside the
    bound; integer inputs bit for bit), and the logits kernel's general
    tile at V = 31 (phase 5's checks); (b) AGCN at full width on the
    31-node STGAT graph, `formulation: pallas`: a served forward in fp32
    and bf16 (and bf16 with `use_pallas`) card against CPU, then
    STGAT_STEPS bf16 SGD steps at batch 64; (c) AAGCN on the same graph,
    served in fp32 and bf16 card against CPU, its embeddings through the
    logits kernel. Returns the kernels' rows and the launch counts."""
    from agcn_tpu_torch.ops.kernels import gcn_fused, gcn_kernel, logits_kernel

    t25 = time.perf_counter()
    out = dict(rows={}, dx_rows={}, bwd_rows={})
    with torch.inference_mode():
        for v in JOINTS_SMALL + JOINTS_GENERAL:
            check_general_small(torch, np, gcn_fused, gcn_kernel, v)
        for v in JOINTS_GENERAL:
            log(f"  V={v}: gcn_fwd at the served layer shapes (batch 32), "
                f"dx and gcn_bwd at the training ones (batch 128)")
            out["rows"][v] = phase_fwd_kernels(torch, np, gcn_fused,
                                               gcn_kernel, v, *GEN_ITERS)
            out["dx_rows"][v] = phase_dx(torch, np, gcn_fused, v, *GEN_ITERS)
            out["bwd_rows"][v] = phase_bwd_kernels(torch, np, gcn_fused, v,
                                                   *GEN_ITERS)
        log(f"  the logits kernel at V = {STGAT_JOINTS} (its general tile)")
        out["logits_rows"] = phase_logits(torch, np, logits_kernel,
                                          v=STGAT_JOINTS)
    ta = time.perf_counter() - t25
    for v in JOINTS_GENERAL:
        for d in ("bfloat16", "float32"):
            f = fwd_entry(out["rows"][v], True, d, 0, "", "",
                          out["dx_rows"][v])
            b = bwd_entry(out["bwd_rows"][v], 0, d, v)
            log(f"  V={v} {d}: served forward {f['ms']:.3f} ms (plain "
                f"{f['plain_ms']:.3f}, einsum {f['library_ms']:.3f}, bound "
                f"{f['bound_ms']:.3f}); dx a step {f['dx']['ms']:.3f} ms "
                f"(einsum {f['dx']['library_ms']:.3f}, bound "
                f"{f['dx']['bound_ms']:.3f}); dW {b['dw']['ms']:.3f} ms "
                f"(einsums {b['dw']['library_ms']:.3f}, bound "
                f"{b['dw']['bound_ms']:.3f}), da1 {b['da1']['ms']:.3f} ms "
                f"(einsums {b['da1']['library_ms']:.3f}, bound "
                f"{b['da1']['bound_ms']:.3f})")
    t0 = time.perf_counter()
    out["launches"] = {"agcn_stgat_serve": stgat_served(torch, np, "agcn",
                                                        summary),
                       "agcn_stgat_train": stgat_train(torch, np, summary)}
    tb = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["launches"]["aagcn_stgat_serve"] = stgat_served(torch, np, "aagcn",
                                                        summary)
    tc = time.perf_counter() - t0
    summary["any_joints_phase_s"] = time.perf_counter() - t25
    summary["any_joints_launches"] = out["launches"]
    summary["any_joints_rows"] = {k: out[k] for k in (
        "rows", "dx_rows", "bwd_rows", "logits_rows")}
    summary["any_joints_smi"] = smi
    log(f"  phase 25 in {summary['any_joints_phase_s']:.1f} s ((a) {ta:.1f}, "
        f"(b) {tb:.1f}, (c) {tc:.1f}; {smi})")
    return out


def vgen_entries(out, kernels):
    """Each `kernels` row's "vgen" entry: phase 25's sums at V = 31 and 67
    in both types (the logits kernel at V = 31), and its launches on
    phase 25's paths."""
    same = ("name", "route", "source", "replaces", "launches")
    n = {k: 0 for k in ("gcn_fwd_round_agg", "gcn_fwd_fp32_agg", "gcn_bwd",
                        "logits")}
    for counts in out["launches"].values():
        for k, c in counts.items():
            n[k] += c
    for i, (round_agg, key) in enumerate(((True, "gcn_fwd_round_agg"),
                                          (False, "gcn_fwd_fp32_agg"))):
        kernels[i]["vgen"] = {f"v{v}": {d: {
            k: x for k, x in fwd_entry(
                out["rows"][v], round_agg, d, 0, "", "",
                out["dx_rows"][v] if round_agg else None).items()
            if k not in same} for d in ("bfloat16", "float32")}
            for v in JOINTS_GENERAL}
        kernels[i]["vgen"]["launches"] = n[key]
    kernels[2]["vgen"] = {f"v{v}": {d: {
        k: x for k, x in bwd_entry(out["bwd_rows"][v], 0, d, v).items()
        if k not in same} for d in ("bfloat16", "float32")}
        for v in JOINTS_GENERAL}
    kernels[2]["vgen"]["launches"] = n["gcn_bwd"]
    kernels[3]["vgen"] = {f"v{STGAT_JOINTS}": {
        d: dict(logits_sums(out["logits_rows"], SERVE_BATCH, d),
                per=f"one served forward (10 layers, 32 samples, T=300, "
                    f"V={STGAT_JOINTS})") for d in ("bfloat16", "float32")},
        "launches": n["logits"]}
    for entry, key in zip(kernels, n):
        entry["launches"] += n[key]
        entry["launches_by_path"].update(
            {path: c[key] for path, c in out["launches"].items()
             if c.get(key)})


def main(argv=None):
    import torch

    argv = sys.argv[1:] if argv is None else argv
    only = argv[1] if len(argv) == 2 and argv[0] == "--phase" else None
    if argv and only not in ("14", "15", "16", "17", "18", "19", "20",
                             "21", "22", "23", "24", "25"):
        print("usage: python3 chip_smoke.py "
              "[--phase 14|15|16|17|18|19|20|21|22|23|24|25]",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU available", file=sys.stderr)
        return 1
    import numpy as np

    from agcn_tpu_torch.ops.kernels import (build, gcn_fused, gcn_kernel,
                                            logits_kernel)
    from agcn_tpu_torch.utils.config import load_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    summary = {}
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    t_start = time.perf_counter()
    log(f"[1/25] {kind}: {smi}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    if only == "14":
        log("[14/25] the SGN recipe alone (phase 14)")
        phase_sgn(torch, np, summary)
        return 0
    if only == "17":
        log("[17/25] SGN's v11-v13 options, the MMD loss and sgn_original "
            "alone (phase 17)")
        phase_sgn_options(torch, np, summary)
        out_dir = os.path.join(REPO, "build")
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "chip_smoke_sgn_options.json"),
                  "w") as f:
            json.dump(summary, f, indent=1)
        return 0
    if only == "18":
        log("[18/25] SGN's transformer (train_sgn_transformer.yaml, "
            "train_sgn_v15.yaml) and SGN serving alone (phase 18)")
        phase_sgn_transformer(torch, np, summary)
        out_dir = os.path.join(REPO, "build")
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "chip_smoke_sgn_transformer.json"),
                  "w") as f:
            json.dump(summary, f, indent=1)
        return 0
    if only == "19":
        log("[19/25] SGN raw generation (sgn-raw) and SGN's temporal-branch "
            "options alone (phase 19)")
        phase_sgn_temporal(torch, np, summary)
        out_dir = os.path.join(REPO, "build")
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "chip_smoke_sgn_temporal.json"),
                  "w") as f:
            json.dump(summary, f, indent=1)
        return 0
    if only == "23":
        log("[23/25] the rest of SGN's GCN stack and head alone (phase 23)")
        phase_sgn_stack(torch, np, smi, summary)
        out_dir = os.path.join(REPO, "build")
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "chip_smoke_sgn_stack.json"),
                  "w") as f:
            json.dump(summary, f, indent=1)
        return 0
    if only == "24":
        log("[24/25] SGN's input side and the k-means segment split alone "
            "(phase 24)")
        phase_sgn_input(torch, np, smi, summary)
        out_dir = os.path.join(REPO, "build")
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "chip_smoke_sgn_input.json"),
                  "w") as f:
            json.dump(summary, f, indent=1)
        return 0
    if only == "15":
        t0 = time.perf_counter()
        built = build.build_all()
        log(f"[2/25] built {sorted(built)} in {time.perf_counter() - t0:.1f} "
            "s")
        log("[15/25] the trainer's run knobs alone (phase 15)")
        phase_knobs(torch, np, smi, summary)
        out_dir = os.path.join(REPO, "build")
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "chip_smoke_knobs.json"), "w") as f:
            json.dump(summary, f, indent=1)
        return 0
    if only == "20":
        t0 = time.perf_counter()
        built = build.build_all()
        log(f"[2/25] built {sorted(built)} in {time.perf_counter() - t0:.1f} "
            "s")
        log("[20/25] data-parallel training and the edge partition alone "
            "(phase 20)")
        summary["phase20_launches"] = phase_parallel(torch, np, smi, summary)
        out_dir = os.path.join(REPO, "build")
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "chip_smoke_parallel.json"),
                  "w") as f:
            json.dump(summary, f, indent=1)
        return 0
    if only == "21":
        t0 = time.perf_counter()
        built = build.build_all()
        log(f"[2/25] built {sorted(built)} in {time.perf_counter() - t0:.1f} "
            "s")
        log("[21/25] the 15-joint OpenPose recipes (AGCN, AAGCN) on the "
            "V = 15 kernels alone (phase 21)")
        phase_openpose(torch, np, smi, summary)
        out_dir = os.path.join(REPO, "build")
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "chip_smoke_openpose.json"),
                  "w") as f:
            json.dump(summary, f, indent=1)
        return 0
    if only == "22":
        t0 = time.perf_counter()
        built = build.build_all()
        log(f"[2/25] built {sorted(built)} in {time.perf_counter() - t0:.1f} "
            "s")
        log("[22/25] the single-stream live demo (python -m "
            "agcn_tpu_torch.infer without --serve, expose_attention) alone "
            "(phase 22)")
        phase_single_stream(torch, np, smi, summary)
        out_dir = os.path.join(REPO, "build")
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "chip_smoke_single_stream.json"),
                  "w") as f:
            json.dump(summary, f, indent=1)
        return 0
    if only == "25":
        t0 = time.perf_counter()
        built = build.build_all()
        log(f"[2/25] built {sorted(built)} in {time.perf_counter() - t0:.1f} "
            "s")
        for name in ("gcn_fwd", "gcn_bwd"):
            summary[f"{name}_gen_build"] = report_gen_build(built[name].log)
        check(not spilling(built["gcn_fwd"].log)
              and not bwd_spills(built["gcn_bwd"].log), "a GCN kernel spills")
        log("[25/25] the GCN kernels at any joint count alone (phase 25)")
        phase_any_joints(torch, np, smi, summary)
        out_dir = os.path.join(REPO, "build")
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "chip_smoke_any_joints.json"),
                  "w") as f:
            json.dump(summary, f, indent=1)
        return 0
    if only == "16":
        t0 = time.perf_counter()
        built = build.build_all()
        log(f"[2/25] built {sorted(built)} in {time.perf_counter() - t0:.1f} "
            "s")
        log("[16/25] BN folding, the apply_gcn forms, the AAGCN versions "
            "alone (phase 16)")
        summary["phase16_launches"] = phase_versions(torch, np, smi, summary)
        out_dir = os.path.join(REPO, "build")
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "chip_smoke_versions.json"),
                  "w") as f:
            json.dump(summary, f, indent=1)
        return 0

    t0 = time.perf_counter()
    built = build.build_all()
    build_s = time.perf_counter() - t0
    log(f"[2/25] built {sorted(built)} in {build_s:.1f} s")
    for res in built.values():
        for ln in res.log.splitlines():
            if "registers" in ln or "spill" in ln or "smem" in ln:
                log(f"  {ln.strip()}")
    summary["fp32_fwd_build"] = report_fp32_build(built["gcn_fwd"].log)
    for name in ("gcn_fwd", "gcn_bwd"):
        summary[f"{name}_gen_build"] = report_gen_build(built[name].log)
    summary["fp32_da1_build"] = report_da1_fp32_build(built["gcn_bwd"].log)
    summary["logits_build"] = report_build(built["logits"].log)
    spills = spilling(built["gcn_fwd"].log)
    check(not spills, f"gcn_fwd kernels spill: {spills}")
    spills = bwd_spills(built["gcn_bwd"].log)
    check(not spills, f"gcn_bwd kernels spill: {spills}")
    spills = logits_spills(built["logits"].log)
    check(not spills, f"logits kernels spill: {spills}")
    summary["build_s"] = build_s

    log("[3/25] gcn_fwd kernel vs plain version at the served shapes "
        "(batch 32) and as dx at the training shapes (batch 128). "
        "Tolerances: fp32 (TF32 off) max err <= 1e-4 x output scale "
        "(another summation order over up to 19,200 products); bf16 per "
        "element <= 2^-7 |ref| + 2^-10 x scale (loose: one bf16 rounding "
        "of each output may land one ulp apart), yet tight enough that "
        "each round_agg mode fails the other mode's plain version on "
        "integer inputs; bf16 and fp32 bit for bit on small-integer "
        "inputs, two calls bitwise equal")
    with torch.inference_mode():
        rows = phase_fwd_kernels(torch, np, gcn_fused, gcn_kernel)
        dx_rows = phase_dx(torch, np, gcn_fused)
    log("  fp32 per layer (gcn_fwd_fp32_kernel, ms)")
    summary.update(kernel_rows=rows, dx_rows=dx_rows,
                   fp32_fwd_layers=fp32_layers(rows, dx_rows))
    log("  the same at V = 15 (the OpenPose skeleton)")
    with torch.inference_mode():
        rows15 = phase_fwd_kernels(torch, np, gcn_fused, gcn_kernel, 15)
        dx_rows15 = phase_dx(torch, np, gcn_fused, 15)
    log("  fp32 per layer at V = 15 (gcn_fwd_fp32_kernel, ms)")
    summary.update(kernel_rows_v15=rows15, dx_rows_v15=dx_rows15,
                   fp32_fwd_layers_v15=fp32_layers(rows15, dx_rows15))

    log("[4/25] gcn_bwd vs its plain version at the training shapes "
        "(batch 128), same tolerances")
    with torch.inference_mode():
        bwd_rows = phase_bwd_kernels(torch, np, gcn_fused)
    log("  fp32 da1 per layer (gcn_da1_fp32_kernel, ms)")
    summary.update(bwd_rows=bwd_rows,
                   fp32_da1_layers=da1_fp32_layers(bwd_rows))
    log("  the same at V = 15 (the OpenPose skeleton)")
    with torch.inference_mode():
        bwd_rows15 = phase_bwd_kernels(torch, np, gcn_fused, 15)
    log("  fp32 da1 per layer at V = 15 (gcn_da1_fp32_kernel, ms)")
    summary.update(bwd_rows_v15=bwd_rows15,
                   fp32_da1_layers_v15=da1_fp32_layers(bwd_rows15))

    log("[5/25] attention-logits kernel vs plain version at the served "
        "(32) and training (128) batch shapes. Tolerance: max err <= 1e-5 "
        "x output scale (fp32 sums of up to 9,600 products in another "
        "order); two calls bitwise equal; on integer inputs the sums bit "
        "for bit, each divided once. Times back to back, and the kernel's "
        "device time alone with the calls queued ahead of the card")
    with torch.inference_mode():
        logits_rows = phase_logits(torch, np, logits_kernel)
        log("  the same at V = 15 (the OpenPose skeleton; the kernel's "
            "general tile)")
        logits_rows15 = phase_logits(torch, np, logits_kernel, v=15)
    summary.update(logits_rows=logits_rows, logits_rows_v15=logits_rows15)

    log("[6/25] host data path: the C++ host kernels "
        "(agcn_tpu_torch/native/skelio.cpp) built by g++; pre_normalization "
        "of a served tick's batch, C++ against numpy (tolerance 1e-4 x "
        "output scale, the serving bar); python -m "
        "agcn_tpu_torch.data.gen ntu and streams on a seeded raw tree, the "
        "files through the Feeder and a pallas AGCN forward")
    phase_host_data(torch, np, smi, summary)

    log("[7/25] AGCN serving main path: 16 streams through "
        "BatchedStreamServer")
    launches, state, args, models, x_check = phase_main_path(torch, np,
                                                             summary)
    log("[8/25] AGCN: device time of one served forward by kernel group; "
        "the serving CLI (python -m agcn_tpu_torch.infer --serve 16 "
        "--pipeline)")
    phase_profile(torch, models, x_check, summary, "agcn")
    del models
    summary["agcn_cli_launches"] = phase_cli(torch, np, state, "agcn", args,
                                             trainer_checkpoint=True)

    log("[9/25] AGCN training main path: train_joint.yaml, formulation "
        "pallas, T=300")
    train_cfg = load_config(TRAIN_CONFIG)
    phase_train_vs_cpu(torch, np, train_cfg, summary, "agcn")
    train_launches = phase_train_main_path(torch, np, train_cfg, summary,
                                           "agcn")
    phase_train_speed(torch, np, train_cfg, summary, "agcn", fp32=True)
    phase_train_cli(np, summary, TRAIN_CONFIG, "agcn")

    log("[10/25] AAGCN serving main path: test_joint_aagcn.yaml, formulation "
        "and eval_formulation pallas, 16 streams; the logits kernel's entry "
        "point on the served forward's theta/phi")
    (aagcn_launches, logits_launches, aagcn_state, aagcn_args, aagcn_models,
     aagcn_x) = phase_aagcn_serving(torch, np, summary)
    log("[11/25] AAGCN: device time of one served forward by kernel group; "
        "the serving CLI")
    phase_profile(torch, aagcn_models, aagcn_x, summary, "aagcn")
    del aagcn_models
    summary["aagcn_cli_launches"] = phase_cli(torch, np, aagcn_state, "aagcn",
                                              aagcn_args)

    log("[12/25] AAGCN training main path: train_joint_aagcn.yaml, "
        "formulation pallas, T=300")
    aagcn_cfg = load_config(AAGCN_TRAIN_CONFIG)
    phase_train_vs_cpu(torch, np, aagcn_cfg, summary, "aagcn")
    aagcn_train_launches = phase_train_main_path(torch, np, aagcn_cfg,
                                                 summary, "aagcn")
    phase_train_speed(torch, np, aagcn_cfg, summary, "aagcn")
    phase_train_cli(np, summary, AAGCN_TRAIN_CONFIG, "aagcn", resume=False,
                    eval_formulation="pallas")

    log("[13/25] AAGCN-transformer recipe (no port kernel on its path, as "
        "in the JAX package): test_joint_aagcn_transformer.yaml serving 16 "
        "streams; train_joint_aagcn_transformer.yaml (AdamW, onecycle), "
        "T=300")
    t13 = time.perf_counter()
    tf_models, tf_x = phase_transformer_serving(torch, np, summary)
    phase_profile(torch, tf_models, tf_x, summary, "transformer")
    del tf_models
    tf_cfg = load_config(TRANSFORMER_TRAIN_CONFIG)
    phase_transformer_train_vs_cpu(torch, np, tf_cfg, summary)
    phase_transformer_main_path(torch, np, tf_cfg, summary)
    phase_transformer_speed(torch, np, tf_cfg, summary)
    phase_train_cli(np, summary, TRANSFORMER_TRAIN_CONFIG, "transformer",
                    resume=False, formulation=None, launches_per_step=(0, 0),
                    serve=True)
    summary["transformer_phase_s"] = time.perf_counter() - t13
    log(f"  phase 13 in {summary['transformer_phase_s']:.1f} s")

    log("[14/25] SGN recipe (no port kernel on its path, as in the JAX "
        "package): train_sgn.yaml at full width on synthetic SGN pickles "
        "(the C++ flatten_persons), card against CPU, 10 Adam steps, speed, "
        "the entry points with 5-crop eval")
    phase_sgn(torch, np, summary)

    log("[15/25] the trainer's run knobs: one fp32 SAM step of the pallas "
        "AGCN, kernels against plain versions; the entry point on "
        "train_joint.yaml with SAM, the profiler, async checkpoints, then "
        "auto-resume; train_sgn_fsim_sam.yaml and train_sgn_scan8.yaml "
        "through the entry point")
    sam_launches = phase_knobs(torch, np, smi, summary)

    log("[16/25] BN folding on the served pallas AGCN and AAGCN forwards "
        "(gcn_fwd and the logits kernel counted); the apply_gcn forms "
        "against 'agg'; the AAGCN v31 recipe (train_joint_aagcn_v31.yaml, "
        "T=60: card against CPU, 10 SGD steps, speed, the entry points); "
        "v17, v24, v30, v32 and v34 against the CPU")
    v16 = phase_versions(torch, np, smi, summary)

    log("[17/25] SGN's v11-v13 options, the MMD loss and sgn_original (no "
        "port kernel on their path, as in the JAX package): v11, v12, "
        "v13_gt4 and sgn_original card against CPU; one v12 step with the "
        "MMD loss card against CPU; 10 Adam steps of v12 (batch 128) and "
        "v13_gt4 (64), speed; train_sgn_v12.yaml through the entry points")
    v17 = phase_sgn_options(torch, np, summary)

    log("[18/25] SGN's transformer (no port kernel on its path, as in the "
        "JAX package): train_sgn_transformer.yaml and train_sgn_v15.yaml "
        "card against CPU, one v15 step card against CPU, 10 Adam steps "
        "each, speed, the entry points (train, --phase test, --serve 16); "
        "the SGN tick (sgn and sgn_transformer, 16 streams x 5 crops) "
        "card against CPU")
    v18 = phase_sgn_transformer(torch, np, summary)

    log("[19/25] SGN raw generation and SGN's temporal-branch options (no "
        "port kernel on their path, as in the JAX package): python -m "
        "agcn_tpu_torch.data.gen sgn-raw on a synthetic raw tree, its "
        "NTU_CV pickles through the entry points; t_mode 2-5, t_mha_kwargs, "
        "aspp_rates, gcn_fpn 8 and t_maxpool_kwargs at train_sgn.yaml's "
        "widths card against CPU, one Adam step each")
    v19 = phase_sgn_temporal(torch, np, summary)

    log("[20/25] data-parallel training: train_joint.yaml's pallas AGCN "
        "through torchrun (one rank: an NCCL group, DDP, SyncBN) against the "
        "plain entry point, --phase test on the DDP checkpoint; the DDP "
        "step's ms and NCCL kernels; model_edge_gcn, the edge aggregate and "
        "SyncBN on the NCCL group, card against CPU")
    v20 = phase_parallel(torch, np, smi, summary)
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with open(os.path.join(REPO, "build", "chip_smoke_parallel.json"),
              "w") as f:
        json.dump({k: summary[k] for k in (
            "parallel_cli", "parallel_steps", "parallel_phase_s",
            "parallel_smi")}, f, indent=1)

    log("[21/25] the 15-joint OpenPose recipes on the V = 15 kernels: "
        "openpose_b25_j15_xview/train_joint.yaml (AGCN) and "
        "train_joint_aagcn.yaml (AAGCN), formulation pallas: 16 streams "
        "card against CPU, one step card against CPU, 10 bf16 steps, the "
        "entry points (train, --phase test, --serve 16)")
    v21 = phase_openpose(torch, np, smi, summary)

    log("[22/25] the single-stream live demo: python -m agcn_tpu_torch.infer "
        "without --serve (test_joint.yaml's AGCN and test_joint_aagcn.yaml's "
        "AAGCN, formulation pallas, card against CPU; the use_pallas AGCN "
        "and train_sgn.yaml's SGN; --save-attention), the recognizer's "
        "exposed graphs card against CPU and its predict latency")
    v22 = phase_single_stream(torch, np, smi, summary)

    log("[23/25] the rest of SGN's GCN stack and head (no port kernel on "
        "their path, as in the JAX package): argmax ties on the card; gt "
        "modes 0, 5, 6, attn modes 1-3 and 10, gcn_fpn 10 with the sgcn2 "
        "options, gcn_fpn_output_merge 2, the unit and block options and "
        "the pooling modes at train_sgn.yaml's widths, card against CPU, "
        "Adam steps; gcn_fpn 10 with merge 2 through the entry point")
    v23 = phase_sgn_stack(torch, np, smi, summary)

    log("[24/25] SGN's input side (no port kernel on its path, as in the "
        "JAX package): semantic_jdiff, xem_projection, "
        "semantic_frame_location 1, semantic_joint_smp and the segment "
        "embeddings at train_sgn.yaml's widths, card against CPU, Adam "
        "steps; the k-means segment split's collates; the segment "
        "embeddings with midvel_sampler 1 through the entry point")
    v24 = phase_sgn_input(torch, np, smi, summary)

    log("[25/25] the GCN kernels at any joint count (the general kernels): "
        "each against its plain version at V = 1, 7, 16, 31, 32, 33 and 67 "
        "(small shapes), at V = 31 and 67 the served and training layer "
        "shapes, the logits kernel at V = 31; AGCN and AAGCN on the 31-node "
        "STGAT expanded graph, formulation pallas: a served forward in fp32 "
        "and bf16 card against CPU, 3 bf16 SGD steps of AGCN at batch 64")
    v25 = phase_any_joints(torch, np, smi, summary)

    fwd_launches = {
        "agcn_serve": launches["adaptive_gcn_pallas"],
        "agcn_train": train_launches["gcn_fwd_round_agg"],
        "aagcn_serve": aagcn_launches["adaptive_gcn_pallas"],
        "aagcn_train": aagcn_train_launches["gcn_fwd_round_agg"],
        "agcn_sam_train": sam_launches["gcn_fwd_round_agg"],
        "agcn_folded_serve":
            v16["agcn_folded_serve"]["gcn_fwd_round_agg"],
        "aagcn_folded_serve":
            v16["aagcn_folded_serve"]["gcn_fwd_round_agg"],
        "agcn_ddp_train": v20["gcn_fwd_round_agg"],
        "agcn_single_stream":
            v22["agcn_single_stream"]["gcn_fwd_round_agg"],
        "aagcn_single_stream":
            v22["aagcn_single_stream"]["gcn_fwd_round_agg"]}
    bwd_launches = {"agcn_train": train_launches["gcn_bwd"],
                    "aagcn_train": aagcn_train_launches["gcn_bwd"],
                    "agcn_sam_train": sam_launches["gcn_bwd"],
                    "agcn_ddp_train": v20["gcn_bwd"]}
    # the V = 15 paths of phase 21: served forwards, the ten steps, the
    # entry point's epoch
    for label, n in v21.items():
        fwd_launches[f"{label}_serve"] = n["serve"]
        fwd_launches[f"{label}_train"] = (n["train"]["gcn_fwd_round_agg"]
                                          + n["cli"]["gcn_fwd_round_agg"])
        bwd_launches[f"{label}_train"] = (n["train"]["gcn_bwd"]
                                          + n["cli"]["gcn_bwd"])
    kernels = [
        fwd_entry(rows, True, "bfloat16", sum(fwd_launches.values()),
                  "gcn_fwd (aggregate rounded to x's type)",
                  "agcn_tpu/ops/pallas/gcn_fused.py:52", dx_rows),
        fwd_entry(rows, False, "bfloat16",
                  sum(launches["fused_gcn"].values())
                  + v22["agcn_single_stream_use_pallas"]["gcn_fwd_fp32_agg"],
                  "gcn_fwd (fp32 aggregate)",
                  "agcn_tpu/ops/pallas/gcn_kernel.py:27"),
        bwd_entry(bwd_rows, sum(bwd_launches.values())),
        logits_entry(logits_rows, logits_launches
                     + v16["aagcn_folded_serve"]["logits"]
                     + v21["openpose_aagcn"]["logits"]),
    ]
    kernels[0]["launches_by_path"] = fwd_launches
    kernels[1]["launches_by_path"] = {
        f"agcn_serve_use_pallas_{d}": n
        for d, n in launches["fused_gcn"].items()}
    kernels[1]["launches_by_path"]["agcn_single_stream_use_pallas"] = (
        v22["agcn_single_stream_use_pallas"]["gcn_fwd_fp32_agg"])
    kernels[2]["launches_by_path"] = bwd_launches
    kernels[3]["launches_by_path"] = {
        "aagcn_serve": logits_launches,
        "aagcn_folded_serve": v16["aagcn_folded_serve"]["logits"],
        "openpose_aagcn_serve": v21["openpose_aagcn"]["logits"]}
    # each kernel's count on the transformer's paths, as phase 13 read it:
    # the served ticks; the ten steps and the entry point's epoch (whose
    # log counts the three GCN kernels)
    tf_train = dict(summary["transformer_train_launches"])
    for m in summary["transformer_train_cli"]["train"]:
        for key, n in m["launches"].items():
            tf_train[key] += n
    # and on the SGN path, as phase 14 read it: the ten steps (the entry
    # point's epoch is checked at 0 for the three GCN kernels)
    sgn_train = dict(summary["sgn_train"]["launches"])
    for key, n in summary["sgn_cli"]["train"][0]["launches"].items():
        sgn_train[key] += n
    for entry, key in zip(kernels, ("gcn_fwd_round_agg", "gcn_fwd_fp32_agg",
                                    "gcn_bwd", "logits")):
        entry["launches_by_path"].update(
            transformer_serve=summary["transformer_launches"][key],
            transformer_train=tf_train[key], sgn_train=sgn_train[key],
            agcn_sam_train=sam_launches[key],
            aagcn_v31_train=v16["aagcn_v31_train"][key])
        for path in ("agcn_folded_serve", "aagcn_folded_serve"):
            entry["launches_by_path"].setdefault(path, v16[path][key])
        entry["launches_by_path"]["sgn_options"] = v17[key]
        entry["launches_by_path"]["sgn_transformer"] = v18[key]
        entry["launches_by_path"]["sgn_temporal"] = v19[key]
        entry["launches_by_path"]["sgn_stack"] = v23[key]
        entry["launches_by_path"]["sgn_input"] = v24[key]
        entry["launches_by_path"].setdefault("agcn_ddp_train", v20[key])
        # phase 22: each single-stream run's count of every kernel
        for path, n in v22.items():
            entry["launches_by_path"].setdefault(path, n[key])
    # the fp32 routes' numbers beside the bf16 ones (gcn_fwd: served
    # forward and, for gcn_fused, dx per step; gcn_bwd: per step)
    same = ("name", "route", "source", "replaces", "launches")
    for i, (round_agg, dx) in enumerate(((True, dx_rows), (False, None))):
        kernels[i]["float32"] = {
            k: v for k, v in fwd_entry(rows, round_agg, "float32", 0, "", "",
                                       dx).items() if k not in same}
    kernels[2]["float32"] = {
        k: v for k, v in bwd_entry(bwd_rows, 0, "float32").items()
        if k not in same}
    # and at V = 15 (the OpenPose skeleton), both types: the same sums
    # over phases 3-5's V = 15 rows, the launches of phase 21's paths
    v15_launches = (
        sum(n for p, n in fwd_launches.items() if p.startswith("openpose")),
        0,
        sum(n for p, n in bwd_launches.items() if p.startswith("openpose")),
        v21["openpose_aagcn"]["logits"])
    for i, (round_agg, dx) in enumerate(((True, dx_rows15), (False, None))):
        kernels[i]["v15"] = {d: {
            k: v for k, v in fwd_entry(rows15, round_agg, d, 0, "", "",
                                       dx).items() if k not in same}
            for d in ("bfloat16", "float32")}
    kernels[2]["v15"] = {d: {
        k: v for k, v in bwd_entry(bwd_rows15, 0, d, 15).items()
        if k not in same} for d in ("bfloat16", "float32")}
    kernels[3]["v15"] = {d: dict(logits_sums(logits_rows15, SERVE_BATCH, d),
                                 per="one served forward (10 layers, 32 "
                                     "samples, T=300, V=15)")
                         for d in ("bfloat16", "float32")}
    for entry, n in zip(kernels, v15_launches):
        entry["v15"]["launches"] = n
    # and at any other V (the general kernels): phase 25's sums and paths
    vgen_entries(v25, kernels)
    summary.update(kernels=kernels, device=kind, nvidia_smi=smi,
                   seconds=time.perf_counter() - t_start)
    log(f"  all phases in {summary['seconds']:.1f} s")
    out_dir = os.path.join(REPO, "build")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
