#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (``paddle_tpu_torch``) on one card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card, ``nvcc`` (``$CUDA_HOME``, ``PATH`` or
``/usr/local/cuda``) and the repository's sources; it imports neither JAX
nor ``paddle_tpu``. Phases, each fatal on failure:

  1. device — the card's name and power limit (``nvidia-smi``); TF32
     switched off for matmuls and cuDNN, so fp32 stays fp32;
  2. build  — ``ops/csrc/paged_attention.cu``,
     ``ops/csrc/flash_attention.cu``, ``ops/csrc/matmul_stats.cu``,
     ``ops/csrc/dropout.cu`` and ``ops/csrc/lstm_cell.cu`` compiled for
     sm_90a, one ``nvcc`` each, started together; ptxas must report no
     spills in any of the 24 paged instantiations (4 pool types x 3
     widths x 2 row classes), the 18 flash ones (3 kernels x 2 dtypes x
     3 widths), the 6 matmul_stats ones (2 dtypes x 3 tiles), the 8
     dropout ones (2 dtypes x upscale x mask) or the 2 lstm_cell ones
     (forward, backward);
  3. kernel — the CUDA paged-attention kernel (each chain split across
     blocks, the splits merged in the same launch) held against its
     plain PyTorch version (``_attend_plain``) at rtol 1e-4 / atol 1e-5
     on live rows (``PAGED_CASES``): decode (C=1, S=32), a prefill chunk
     (C=16, S=1), a speculative width (C=5), ragged chains, layers 0 and
     3 of a 4-layer pool, nblk at NBmax and capped at half of it, f32,
     bf16, int8 and fp8-e4m3 pools, dk 64, 128 and 256, bs 16 and 32,
     chains of up to 128 blocks, and 1-byte tiles of 24 bytes (8-byte
     copies). Then timed at three shapes — (a) the serving decode shape
     (S=32, H=8, C=1, dk 64, bs 16, 256 positions, fp32, a 4-layer pool
     rotating through the L2), (b) the same pool with ragged chains of
     1..16 blocks, (c) a prefill chunk (S=1, C=16, a chain of 14 blocks)
     — each as device time alone and with the host's gaps, against the
     plain version, scaled_dot_product_attention over the gathered dense
     K/V (a boolean mask from qpos at b and c; a yardstick the port never
     calls) and the bound (the bytes of the live chains, the fp32-SIMT
     operations beside it); two launches bitwise equal at (a) and (c);
  4. slice  — the flagship ``transformer_lm`` at its own widths (vocab
     4096, max_len 256, 4 layers, 8 heads, d_model 512, d_inner 2048,
     fp32, weights from ``init_stream(seed=0)``) served by
     ``Engine(slots=32, prefill_chunk=16, block_size=16)``: 64 greedy
     requests, half sharing one 64-token prefix. The kernel's launch
     count is reset just before and read just after; tokens must equal
     the gather path's and, for 4 requests, ``sequential_generate``'s;
     16 of the requests again over an fp8-e4m3 pool
     (``kv_quant='fp8'``), the block kernel's tokens equal to the gather
     path's; then a traced pass of 32 requests (device busy share, top
     kernels, the paged kernel's share of device time);
  5. flash  — the three CUDA flash-attention kernels (forward: O and
     LSE; dQ, which also writes delta; dK/dV, with a nonzero dLSE
     cotangent) held against the plain PyTorch version (``_dense_lse``
     and its autograd) on causal and non-causal T in {128, 256, 200,
     1024}, D in {64, 128}, B*H in {1, 16}; T in {200, 256} at D 8 and
     256 (the contract's ends); and the training shape (B=32, H=8,
     T=256, D=64, causal): fp32 at rtol 1e-4 / atol 1e-5, bf16 (D up to
     256) at rtol 2^-7 / atol 1e-2 per element (bf16 keeps 8 bits:
     outputs round at 2^-9 relative in both versions, and the kernel's
     delta reads the rounded O); gradients are compared with atol scaled
     by their largest value. Two forwards (O and LSE) and two backwards
     on the same inputs must be bitwise equal; the delta the dQ kernel
     wrote must agree with ``_delta``. Then each kernel timed at the
     training shape (B=32, H=8, T=256, D=64, causal, fp32), as device
     time alone and with the host's gaps (calls enqueued one after
     another), against the plain version, scaled_dot_product_attention
     forward and backward (a yardstick the port never calls; its
     backward's kernels are named from a traced pass) and the card's
     bound: the larger of TF32 tensor-core arithmetic (3xTF32's extra
     MMAs not counted) and bytes, the fp32-SIMT figure beside it; the
     kernel route's whole backward through autograd beside the library's
     and the plain version's, as device time alone (a sleep kernel hides
     the host's enqueue) and with the host's gaps;
  6. train  — ``transformer_lm(packed=True)`` at its own widths with
     ``Adam(1e-3)``, started on the card (``Executor(CUDAPlace(0))``),
     10 steps over a fixed set of batch-32 batches
     (``make_lm_batch(RandomState(seed), 32, 256, 4096)``): finite
     losses that fall from step 1 to step 10, each flash launch count
     exactly n_layer per step (reset just before, read just after);
     tokens/s and step ms for it and the unpacked form (composed
     matmul/softmax, no kernel). From one startup scope copied twice, 3
     steps packed and 3 steps unpacked agree in losses (rtol 1e-4) and
     weights: with SGD to 2e-4 of max(1, max|w|) per tensor, with Adam
     to 5e-4 in the norm of the whole difference, a limit that the same
     run with dK zeroed must exceed (see ``parity_phase``). Then a
     traced pass of 3 steps;
  7. mm     — the CUDA matmul_stats kernel (y = x w with the shifted
     column sums s1, s2 of y - c in its epilogue) held against its plain
     version (``_dense_matmul_stats``) at the 15 distinct 1x1-conv shapes
     of the ResNet-50 training step below plus ragged M, K, N: fp32 y at
     rtol 1e-4 / atol 1e-5, bf16 y at rtol 2^-7 / atol 1e-5, s1 and s2
     at rtol 1e-4 plus 1e-5 of sum|y - c| and sum (y - c)^2 per column
     (the two versions sum up to 100,352 rows in other orders); fp32 dX
     and dW through the autograd Function (all three cotangents nonzero)
     against autograd through the plain version, atol 1e-5 of the largest
     value; two launches bitwise equal (y, s1, s2) at the largest shape
     and at M=1,568 K=2,048 N=512. Then each shape timed as device time
     alone (and, for the kernel and ``torch.matmul``, with the host's
     gaps too) against the plain version, ``torch.matmul`` of the same
     product (the product WITHOUT the statistics, a yardstick the port
     never calls), the composed route (cuDNN 1x1 conv + the BN
     statistics pass) and the bound (the larger of TF32 tensor-core
     arithmetic and bytes, the fp32-SIMT figure beside it), per shape and
     summed over the 36 launches of one step; each shape's tile must put
     a block on every SM or be bound by bytes;
  8. resnet — ``models.resnet.build_train_net`` (ResNet-50, ImageNet
     224x224x3, batch 32, 1000 classes, fp32, ``Momentum(0.01, 0.9)``)
     started on the card, with ``fuse_conv_bn`` on: 10 steps over two
     fixed numpy batches, finite losses that fall, matmul_stats launches
     exactly 36 per step (reset just before, read just after); images/s
     and step ms for it and for the same net with the flag off (cuDNN
     conv + BN statistics, no kernel). From one startup scope copied
     twice, 3 steps fused and 3 flag-off agree in the step-1 loss (rtol
     1e-4), and in the weights and BN running statistics within a limit
     that controls place (see ``resnet_parity_phase``). Then traced
     passes of 3 fused and 3 flag-off steps;
  9. megastep — K steps as one CUDA graph, captured once and replayed,
     against the eager steps (``core/graphs.py``): the packed LM with
     Adam and ResNet-50 with ``fuse_conv_bn`` on and off, each 10
     ``run()`` steps against 2 ``run_steps(K=5)`` dispatches over the
     same 10 batches from one startup scope copied twice (the graph
     captured before, by a warm call on a third copy): losses and every
     state tensor bitwise equal, or the first differing op named and the
     weights held to the limit the earlier controls place (ResNet's
     eager steps are compared twice first; where cuDNN's default
     algorithms part run to run, the comparison runs under
     ``cudnn.deterministic``); flash launches exactly n_layer and
     matmul_stats exactly 36 per logical step, counted through replays.
     Then ``Engine(slots=32, prefill_chunk=16, block_size=16)`` at
     megastep 1 and 8 on the 64-request mixed set and a decode-heavy set
     (32 requests, prompts of 8-32 tokens, 192 new tokens each): tokens
     equal between K=1 and K=8 and, for 4 requests,
     ``sequential_generate``'s; paged launches exactly n_layer x (decode
     steps the device ran + prefill chunks); captures, replays and
     megastep dispatches printed. Each path is timed eager against graph
     in A/B/A/B order (2 pairs: the host varies from run to run), with
     the medians, and traced once each way for the device busy share;
     every timing line carries the ``nvidia-smi`` line;
 10. spec    — speculative and sampled serving. Kernel #1 at the scoring
     shape (S=32, H=8, C=gamma+1=5, dk 64, ragged per-row qpos = pos +
     j, fp32 and fp8 pools) against its plain version at phase 3's
     tolerances, then timed at (d) (every slot scoring positions
     251..255 of 256) as device time alone and with the host's gaps
     against the plain version, scaled_dot_product_attention with the
     per-row causal mask and the bound. Then the flagship served by
     ``Engine(slots=32, prefill_chunk=16, block_size=16)`` with
     ``speculative=True``, gamma 4, drafter ``ngram`` and ``truncated``
     (2 layers), on both request sets: tokens equal to the plain
     engine's at megastep 1 and, for 4 requests, to
     ``sequential_generate``'s (phase 9's); drafted scoring dispatches
     required; paged launches exactly n_layer x (scoring dispatches +
     plain steps run + prefill chunks) + spec_layers x draft steps;
     accepted tokens per scoring dispatch printed. The scoring dispatch
     computes a position at M = S x C GEMM rows and the kernel's C = 5
     layout, the plain step at M = S and C = 1, so the two round
     differently: where a speculative run's tokens part from the plain
     run's, the first differing token is diagnosed (``_divergence``). A
     near-tie within the row's fp32 rounding (the most the plain and
     the dense fp32 dispatches of that row disagree on a logit) is
     logged with its figures and counted: the scoring dispatch's logits
     within twice that rounding of the plain step's, and the two
     tokens' logits under the plain step no further apart than it
     (sampled: the uniform no further from a CDF step than the two
     dispatches' CDFs disagree); anything else fails. Sampled: 16
     requests (temperature 0.8, top_k 50, top_p 0.95, seeds 100-115)
     among 4 greedy ones, 64 new tokens each, through the plain engine,
     the megastep-8 engine (its sampled CUDA graph, replays required)
     and the ngram speculative engine: identical tokens, a second pass
     identical, the greedy requests equal to their all-greedy tokens;
     the counter RNG's bits (Philox words and uniforms) equal on the
     CPU and the card for 1,000 (seed, counter) pairs. Last, the
     decode-heavy set timed over plain K=1, plain K=8, spec-ngram and
     spec-truncated in A/B/A/B order (3 rounds, medians: ms per decode
     dispatch, tokens/s) and traced once each for the device busy
     share;
 11. io      — persistence and the dense layout, at the flagship's
     widths. (a) The packed LM with ``Adam(1e-3)``, batch 32 x 256, on
     the flash kernels: 3 steps, ``io.save_checkpoint``,
     ``io.load_checkpoint`` into a fresh scope on the card, 3 more steps,
     bitwise equal (losses and every persistable) to 6 uninterrupted
     steps from the same startup scope; a ``save_persistables``/
     ``load_persistables`` round trip bitwise; the newest checkpoint's
     blob corrupted, ``load_checkpoint`` falls back to the older step;
     flash launches exactly n_layer per step. (b) ``save_lm_artifact(...,
     specialize=False)`` of the LM's forward program from that trained
     scope (targets: the logits; the training program would carry
     Adam's moments into the artifact, as the JAX package's does);
     the cold start ``Engine(<dir>)`` -> first token timed; on both
     request sets the artifact engine's tokens and scores equal an
     engine's over ``TransformerLMInfer.from_program`` on the live scope,
     paged launches exactly n_layer x (decode steps run + prefill
     chunks); a flipped byte in the params blob raises
     ``ArtifactError``. (c) ``Engine(paged=False, slots=32,
     prefill_chunk=16)`` at megastep 1 and 8 on both sets: K=1 and K=8
     token-identical, 4 requests of the mixed set equal
     ``sequential_generate``'s, tokens equal the paged engine's or part
     at a near-tie diagnosed under phase 10's 1x rule (logged and
     counted; anything else fails), zero paged launches; then dense
     against paged at K=1 and K=8 timed A/B/A/B on the decode-heavy set
     (3 rounds, medians) and each layout traced once at K=8 for the
     device busy share. (d) The fused ops' sweep cases on the card
     against the CPU; ``save_lm_artifact`` with its defaults
     (``specialize=True``) and with ``bf16=True`` from the trained scope
     on the card, the op counts before and after and each pass's work
     logged; ``verify_bitwise`` of the specialize pipeline on the card
     (2 steps of batch 32 x 256, logits bitwise); engines booted from
     the specialized, bf16 and plain artifacts and a source engine on
     the live scope serve both sets: paged launches exact, the
     specialized engine's tokens and scores bitwise the source
     engine's; the bf16 artifact's teacher-forced logits (4 rows x 64
     steps) within the gap of a control, the bf16 serving model
     (``dtype=bfloat16``) over the same scope; each artifact's cold
     start, and the three artifact engines' decode dispatch timed A/B/C
     on the decode-heavy set. (e) 3 Adam steps of the packed LM under
     ``amp.amp_guard()``: the flash kernels launched in bf16 (counted by
     dtype), losses and weights within 2x the control's gap from the
     fp32 run (the control: the same AMP run on the plain attention
     version), and ``ParallelExecutor(use_bf16_compute=True)`` at one
     rank bitwise the AMP run;
 12. options — the flagship's training options at full width, batch 32
     x 256, Adam(1e-3), label smoothing 0.1. (a) Configuration A,
     ``transformer_lm(packed=True, recompute=True,
     label_smooth_eps=0.1)``: 3 steps with recompute and 3 without from
     one startup scope, losses and every persistable bitwise equal;
     flash launches exactly 2 x n_layer forward and n_layer of each
     backward a step with recompute (the recompute runs the forward
     kernel again), n_layer each without; peak device memory
     (``max_memory_allocated`` after ``reset_peak_memory_stats``) lower
     with recompute; step ms A/B/A/B (2 pairs, medians); 5 ``run()``
     calls against one ``run_steps(K=5)`` dispatch bitwise; one
     ``append_backward(checkpoint=True)`` step bitwise equal to the plain
     step. (b) The dropout kernel against its plain version, Out and Mask
     bitwise, with and without the upscale factor and the mask, at the
     LM's two dropout shapes [32, 256, 512] and [32, 8, 256, 256], odd
     sizes, bf16, p 0.1 and 0.5; two launches bitwise equal; timed at
     [32, 8, 256, 256] f32 without the mask, device time alone and with
     the host's gaps, against the plain version, the bytes bound and
     ``F.dropout`` (a yardstick the port never calls: its masks differ).
     (c) Configuration B, ``transformer_lm(packed=True,
     dropout_rate=0.1, label_smooth_eps=0.1)``: 10 steps over two fixed
     batches, losses finite and falling; dropout launches exactly 2 x
     (1 + 3 x n_layer) a step (the backward draws each mask again), 3 x
     n_layer more with recompute, no flash launch (attention dropout
     takes the composed path, as in the JAX package); recompute against
     no recompute bitwise (contract c); 5 ``run()`` calls against one
     ``run_steps(K=5)`` dispatch bitwise (contract a); step ms eager and
     under the graph A/B/A/B; a traced pass for the device busy share
     and the kernel's share. (d) The optimizer family on a reduced LM (2
     layers, d_model 128, T 64, batch 8): adagrad, adamax,
     decayed_adagrad, adadelta, rmsprop, ftrl, proximal_gd,
     proximal_adagrad, ModelAverage's average_accumulates, and the three
     gradient clips with L2 decay, 2 steps on the card against the port's
     CPU path from one startup scope, losses and persistables within
     2e-4 of max(1, max|w|) (ftrl, whose rule carries the paths'
     gradient rounding into some weights many times over: each path
     within 2e-4 of the float64 rule along its own gradients, and the
     card from the CPU within the float64 rule's own gap plus 2e-4 a
     path); ModelAverage's apply / restore round trip bitwise;
 13. mt      — the encoder-decoder MT transformer, beam search and the
     decode graphs, the mnist models and VGG-16. (a)
     ``transformer(packed=True)`` at its own widths (vocab 4096/4096,
     max_len 64, 2 layers, 8 heads, d_model 256, d_inner 1024, fp32) with
     ``Adam(1e-3)``, batch 64 x 64 full-length sentences of a copy task:
     10 eager steps, losses falling, each flash kernel launched exactly 2
     x steps (the decoder's causal self-attention; the encoder and the
     cross-attention stay composed); 3 steps against the
     ``packed=False`` twin (zero biases on full-length masks) held by
     phase 6's Adam limit and its two controls (plain attention; dK
     zeroed, which must exceed it); 5 ``run()`` calls against one
     ``run_steps(K=5)`` dispatch bitwise; step ms, tokens/s and the
     busy share eager and under the graph. (b) The three flash kernels
     at the MT decoder's shape [64, 8, 64, 32] (D = 32 in the kernels'
     DC = 64 instantiation), causal, fp32 and bf16, against their plain
     versions at phase 5's tolerances, then timed there as phase 5 times
     them (kernel, plain, SDPA, bound). (c) From (a)'s trained scope,
     ``TransformerInfer.translate`` (beam 4) and ``translate_greedy`` on
     16 sentences (half padded), max_out_len 64, fp32 then bf16, end_id a
     token the greedy run emits: each decode one CUDA graph, bitwise
     equal to the eager loop (``decoding.beam_search`` /
     ``greedy_search`` called directly) over two replays; every returned
     score equal to its sentence's teacher-forced sum of log-probs within
     1e-4 of max(1, |score|); greedy tokens equal to the argmax of their
     teacher-forced logits or parting at a near-tie (the gap within what
     the batch and single-row dispatches of the row disagree by); ms per
     translate and tokens/s eager and graph. (d) The flagship LM (phase
     4's weights) ``generate`` beam 4 and greedy, 8 rows x 128 tokens:
     graph bitwise equal to the eager loop; greedy rows equal to
     ``sequential_generate``'s tokens or parting at a diagnosed
     near-tie; timings. (e) ``mlp``, ``cnn`` and VGG-16 (3 x 32 x 32, 10
     classes) with Adam, batch 64, 5 eager steps each, losses falling, ms
     per step; VGG with its dropouts, 5 ``run()`` calls against one
     ``run_steps(K=5)`` dispatch bitwise (under
     ``cudnn.deterministic``); ``cnn_infer`` on a uint8 batch against the
     port's CPU path at 1e-5.
 14. deepfm  — DeepFM, SelectedRows and the op library (no kernel of the
     port runs here). (a) ``models.deepfm.build_train_net(num_fields=8,
     vocab_size=20000, embed_dim=16)``, dnn (32, 32), Adam 1e-2, batch
     1024 on tests/test_deepfm.py's click rule: the card's first 3
     steps within 2e-4 of max(1, max|w|) of the port's CPU path from one
     startup scope; 20 eager steps, losses finite and falling, no kernel
     launched; 5 ``run()`` calls against one ``run_steps(K=5)`` dispatch
     bitwise (the shared tables' gradients sum repeated ids); step ms
     eager and under the graph A/B/A/B, examples/s, the busy share of a
     traced pass of each. (b) The sparse branches on a 20000 x 16
     table: 3 SelectedRows gradients of 8192 ids each (repeats among
     them) through ``merge_selected_rows``, then ``sgd`` or lazy
     ``adam``, on the card and on the CPU from one state: the touched
     rows within rtol 1e-6 / atol 1e-7, every untouched row of the table and
     both moments bitwise as it was, ``run_steps`` refusing the
     program. (c) ``tools/op_sweep.py``: each of the 112 op types the
     slice added, forward and (where the CPU sweep checks one) backward,
     on the card against the CPU at the CPU sweep's tolerances.
 15. lstm    — LoD sequences, the RNN ops and the rest of control flow,
     with the fused LSTM step (``ops/csrc/lstm_cell.cu``: h @ W on
     3xTF32 tensor cores with the cell in the epilogue, forward and
     backward). (a) The step kernels against their plain versions
     (``_lstm_step_plain``, ``_lstm_step_bwd_plain``) at B 64 D 512,
     B 5 D 48 and B 3 D 6 (rows not 16-byte aligned), with and without
     peepholes, two activation sets, dead rows at the step and at the
     next, the scan's first backward step and
     later ones in both directions, and the dh-only call: H, C, Out, the
     saved gates, dh, dc, the gate and peephole gradients at rtol 1e-5 /
     atol 1e-6 of the largest value; two launches bitwise; a reverse
     peephole ``lstm`` (B 64, D 512, lengths 1..16) through the lowering,
     kernel route against the plain steps at rtol 1e-4 / atol 1e-5; then
     timed at B 64 D 512 with the benchmark's lengths over the 128 steps
     of a layer's scan (forward and backward, device time alone and with
     the host's gaps) against the plain steps, the bound from those
     lengths (W's bytes included) and the library's route for a step
     (``torch.mm`` then ATen's ``_thnn_fused_lstm_cell``, and its
     backward, where PyTorch exposes it: no peepholes and no mask, a
     yardstick the port never calls); one layer's scan forward and
     backward against cuDNN's LSTM on the packed batch (TF32 off; it
     includes the input projection the port's fc does). (b)
     benchmarks/stacked_dynamic_lstm.py at its own
     widths (vocab 5000, hidden 512, 3 layers, batch 64, lengths
     ``RandomState(0).randint(40, 81)``: 3,823 tokens in a bucket of
     4,096, @MAXLEN 128) with Adam 1e-3: the card's first step against
     the port's CPU path from one startup scope, the loss and the norm
     of the weights' difference within 4 x the gap of the control (the
     plain steps on the card); where the max pool's choice parts from
     the CPU's at a near-tie (two rows within rounding), the forward
     kernel's pool input and the step through the plain forward and the
     backward kernel are held so instead, and a parting that is no
     near-tie fails; 20 eager steps on the fixed batch, losses
     falling, lstm_cell launches exactly 3 x 128 x 2 a step and no other
     kernel of the port; 5 ``run()`` calls against one ``run_steps(K=5)``
     dispatch bitwise; ms per batch eager and under the graph A/B/A/B (3
     pairs after a warm window on each scope, medians), tokens/s and the
     busy share; an eager step's peak device memory; the device kernels
     of one step through the kernels and through the plain steps, from
     traced passes (the kernel route: 768 step kernels and fewer GEMMs
     than @MAXLEN); the book GRU
     encoder-decoder (dict 100, emb 32, hidden 64, batch 16, its cost
     sum-pooled: segment sums) with 5 ``run()`` calls against one
     ``run_steps(K=5)`` dispatch bitwise. (c) ``tools/op_sweep.py``'s LoD part: each of the 32
     op types the slice added (the sequence, RNN and control-flow ops)
     on the card against the CPU;
 16. crf/detection — (a) the reference book's label_semantic_roles
     tagger (``models/label_semantic_roles.py``) at its own widths:
     word_dim 32, the shared 44068 x 32 table (not trained), predicate
     3162 x 32, mark 2 x 5, hidden 512, 8 ``dynamic_lstm`` layers of 128
     units with peepholes, reversed on odd layers, with the book's
     activation attributes, 59 labels, ``linear_chain_crf`` (crfw at lr
     x 1e-3), ``crf_decoding`` and ``chunk_eval``; Adam 2e-3, batch 64,
     lengths ``RandomState(0).randint(5, 30)`` (@MAXLEN 32). The forward
     of one batch on the card against the CPU from one scope: the CRF
     NLL within rtol 1e-5, the Viterbi paths equal (a parting must be a
     near-tie: its margin under the CPU's emissions no more than 2 x the
     row's rounding) and every tag in [0, 59); the first step within 4 x
     the plain LSTM steps' gap to the CPU; 20 eager steps, losses
     falling, lstm_cell launches exactly 8 x 32 x 2 a step; K=5
     bitwise; eager and graph ms A/B/A/B, tokens/s, busy share; an eager
     step's kernels by device time (the step kernels', the GEMMs' and
     the CRF part's share and launches, the last traced alone on the
     step's emissions) and its peak memory. (b) The ssd zoo model at its
     widths (3 x 64 x 64, 5 classes, 352 priors), batch 32 with 1..4
     ground-truth boxes an image, Adam 1e-3: 10 eager steps, losses
     falling; K=5 bitwise (cudnn.deterministic); eager and graph ms
     A/B/A/B. (c) ``build_ssd_infer_net`` on the trained weights, card
     rows against the CPU's (labels equal, scores and boxes at rtol 1e-5
     / atol 1e-6, or a diagnosed near-tie), DetectionMAP card against
     CPU, ms per batch eager and as one CUDA graph, one multiclass_nms's
     launches (traced). (d) CTC at batch 32, T 64, 32 classes, labels
     5..20: warpctc's loss and gradient card against CPU at rtol 1e-5,
     ``F.ctc_loss`` as a control on the feasible sequences at rtol 1e-4,
     ``ctc_greedy_decoder`` card equal to CPU; then ``tools/op_sweep``'s
     detection part: each of the 14 CRF, CTC and detection op types on
     the card against the CPU;
 17. data — the data plane on the card. (a) The reference book's
     image_classification net, ``resnet_cifar10(images, 32)`` at batch
     128 with Adam 1e-3, fp32, ``fuse_conv_bn`` and
     ``cudnn.deterministic`` on: 2,560 ``dataset.cifar.train10``
     samples written to two files by the port's ``recordio`` writer (the
     native library built with g++ and zlib at first use: a machine
     without ``zlib.h`` fails here, naming it), read back by
     ``layers.open_files(thread_num=2)`` (every sample once), then
     ``reader.shuffle``, ``batch(128)`` and ``DataFeeder.feed``: 20
     feeds. 20 ``run()`` calls against ``DeviceLoader(...)
     .megabatches(5)`` into ``run_steps(feeds=stack, k=5)`` (4
     dispatches, the loader's worker staging each stack through pinned
     memory on a side stream while the previous one runs) and against
     ``run_steps`` given the same 5 host dicts as a list, each from the
     same startup values: losses and every state tensor bitwise equal;
     matmul_stats launched exactly 2 a step (the two 1x1 stride-2
     projection shortcuts); images/s fed by the loader and by the list,
     2 pairs in turns (medians), each route's busy share and the streams
     of its host-to-device copies from a traced window. (b) matmul_stats
     at the shortcuts' shapes (M=32,768 K=16 N=32; M=8,192 K=32 N=64),
     fp32 with gradients, against its plain version at phase 7's
     tolerances, timed as phase 7 times a shape (device time alone and
     with the host's gaps, the plain version, ``torch.matmul``, the
     bound). (c) The book's understand_sentiment ``stacked_lstm_net`` at
     the reference function's widths (emb 128, hid 512: 128-unit LSTMs,
     3 stacked) over ``dataset.imdb``, batch 64: 3 ``run()`` steps fed
     by ``DeviceLoader``'s per-batch iterator (the LoD feed passed
     through on the host, the label staged) bitwise equal to the
     DataFeeder's dicts fed directly, lstm_cell launches exactly 3 x
     @MAXLEN x 2 a step; ``run_steps(K=5)`` given a list of the loader's
     dicts bitwise equal to the DataFeeder's list and to 5 ``run()``
     calls;
 18. front — the rest of the front end on the card. (a) In a process of
     its own (``chip_smoke.py --front-profile DIR``), 3 steps of the
     packed LM (phase 6's program, batch 32, Adam) under
     ``fluid.profiler.profiler("All", "total", <dir>)`` with the flag
     ``profile_memory`` on: the host table has 3 ``exe.run(compiled)``
     calls and n_layer x 3 ``op:sp_attention`` rows, the device trace
     (``<dir>/device_trace.json``) names ``flash_fwd_kernel``,
     ``flash_bwd_dq_kernel`` and ``flash_bwd_dkv_kernel`` as many times
     as their launch counters, and so does the profiler's own trace
     check (``last_device_trace_check``), the recorded peak lies between
     0 and the card's memory; profiled and unprofiled step ms. (a') The
     same 3 steps in the script's own process, after its earlier
     profiler sessions, through the user-facing profiler (whose window
     runs a discarded warm-up cycle, then idles the card at both edges):
     the counters are n_layer x 3 and the trace holds as many flash
     kernels; a trace otherwise incomplete must have made the profiler
     warn, each launch without a record logged with its place in the
     window. (b) 10 LM steps
     with ``check_nan_inf`` on bitwise equal to 10 with it off (losses
     and every state tensor), one guard read a run, both step ms; a NaN
     in ``mask`` trips the same op and variable on the card and on the
     CPU (2 rows of the batch), and ``run_steps(K=5)`` with the NaN in
     step 3 names ``logical step 3 of 5``. (c) An nce net at the
     word2vec book's widths (4 context words over the imikolov
     dictionary, embedding 32, hidden 256, batch 64): ``run_steps(K=5)``
     as one CUDA graph bitwise equal to 5 ``run()`` calls; the LM's
     startup program's Philox words bitwise equal on the card and the
     CPU, its values within 2 ulp, and both startups' seconds. (d)
     ResNet-50 inference at batch 32 (phase 8's net cloned
     ``for_test``, pruned to the logits) from weights after 3 fused
     training steps: after ``InferenceTranspiler`` no ``batch_norm`` op
     is left and the logits stay within 1e-4 of the largest unfused
     logit; both forwards' ms. (e) The recognize_digits convnet (20 and
     50 filters) trained 2 passes through ``v2.trainer.SGD`` after
     ``paddle.init(use_gpu=True)``, its executor on the card, the cost
     falling; ``paddle.infer`` equal to an executor run.
 19. parallel — the parallel tier (``parallel/``, ``ParallelExecutor``,
     ``distributed/launch.py``). (a) ``tools/op_sweep.py``'s parallel
     part: the 9 op types without a mesh on the card against the CPU;
     ``transformer_lm_parallel`` at the
     flagship's widths (batch 32 x 256, SGD 0.1) through
     ``ParallelExecutor`` on a one-rank mesh: 3 steps bitwise equal to
     ``Executor.run`` (losses and every state tensor), ``run_steps(K=5)``
     one CUDA graph bitwise equal to 5 ``run()`` calls, each flash kernel
     launched exactly n_layer a step (and n_layer x 5 through the
     replay); the same for ``num_experts=4`` (the MoE fallback) and
     ``pp=2`` in the strategy (the loop over layers); step ms of both
     executors. (b) Two rank processes on the one card
     (``chip_smoke.py --parallel-rank b 2 R STORE``) over a gloo group,
     the port's collectives staged through pinned host memory: ring and
     Ulysses attention over sp=2 at [32, 8, 256, 64] fp32, causal and
     not, forward and backward, on each rank's sequence block of Q, K
     and V (DTensors over the sp mesh; the output leaves as the rank's
     block), against ``flash_attention_lse`` over the whole sequence in
     one process at phase 5's limits, each rank's flash launches exact
     (causally rank 0 runs its diagonal only, rank 1 its diagonal and
     one full block), each rank's staged bytes a call at most the count
     from the code (``_par_staged_count``: 64 MiB for the ring, 128 MiB
     for Ulysses) and printed beside the 160 and 224 MiB the calls
     staged on whole tensors (``PAR_STAGED_BEFORE``); ``gpipe``
     over pp=2 on the LM's 4-layer stack (3 SGD steps) against the
     one-rank loop (2e-4, weights 50 x), each rank holding half the
     stage weights' bytes, and the same steps as one ``run_steps`` call:
     3 ``run`` calls over the two ranks, no graph captured, bitwise equal
     to them; ``moe_ffn`` over ep=2 with 4 experts, top-1 and top-2, on
     8,192 tokens, each rank passing its ep block of the experts (half
     their bytes): routing (overflow, aux) identical to one rank, the
     output at rtol 1e-4 / atol 1e-5. (c) Four rank processes: which of
     DTensor's collectives gloo carries for CUDA tensors here (probed; a
     probe that fails otherwise than by gloo's refusal, or times out,
     fails the phase), then each dryrun_multichip(4) combo (dp x tp, dp x
     sp, dp x pp, dp x ep) whose collectives it carries (dp x sp, dp x pp
     and dp x ep must run), at (a)'s widths, 3 SGD steps
     against the one-rank run at the dryrun's limits (losses 2e-4, 2e-3
     with sp or ep; weights 50 x), each rank's flash launches exact
     (``_par_flash_want``), and under pp or ep each rank holding half its
     stage and expert blocks' bytes. It logs the seconds, each rank's
     staged bytes, held state bytes beside the whole scope's, step ms,
     and the flash launches.
  20. pserver — the wire and its runtime, one process a role
     (``chip_smoke.py --ps-child ROLE ARGS``), spawned, each on the card.
     (a) The flagship LM at full width through ``DistributeTranspiler``
     (sync): one trainer and two pservers (their optimize blocks through
     ``Executor(CUDAPlace(0))``), 5 Adam steps from the start of a local
     ``Executor.run`` in the trainer, the weights within 2e-4 of
     max(1, max|w|) of the local run's after every step; the flash
     launches n_layer x 5 per kernel in the trainer (locally and through
     the pservers) and none in the pservers; the monitor and the tracer
     armed in the three processes: the trainer's recorder holds the 5
     step events, and the three span logs merge (``trace.merge``) into
     one timeline where every trainer ``rpc.send``/``rpc.get`` span has
     its pserver span under the same trace id. (b) DeepFM at phase 14's
     widths with both FM tables ``is_distributed`` over the same two
     pservers (``prefetch``, ``send_sparse``): SGD on new batches and
     lazy Adam on one batch repeated, then two trainers at fan-in 2
     (SGD, each half of the batch), every step held (the tables read
     back from the shards) within DFM_TOL of a local ``is_sparse`` run on
     the card (for two trainers, one at double batch and twice the
     rate). (c) The chaos composition of tests/test_chaos.py on the
     full-width LM without a local optimizer: a KV store and a master
     task queue (one process), a pserver cell whose SGD runs on the card
     (lease, checkpoints), and the trainer under ``resilient_loop``; a
     fault-free run, then one under CHAOS_SPEC's seeded plan (RPC drops,
     duplicates, mid-frame closes and delays, a bitflipped trainer
     checkpoint, a NaN batch), during which this process SIGKILLs the
     pserver, reaps it and starts a replacement that registers through
     the KV store and recovers from the dead cell's checkpoint. It
     checks exact task accounting, a recovered round > 0, 1 rollback
     and steps = tasks - 1, the final loss within 10% + 0.05 of the
     fault-free run's, and fault, retry, reconnect, rollback and
     checkpoint events in the flight recorder. A child that fails or
     outlives its time fails the phase.
  21. fleet — the serving fleet and its monitoring plane, the flagship
     LM at its own widths booted from its ``save_lm_artifact`` (v1, and
     v2: the same program after one more Adam step). (a) Telemetry:
     ``Engine(slots=32)`` on phase 9's mixed set with the monitor and
     the tracer on against the same engine with both off: tokens and
     paged launches equal, one ``serving_request`` row per request, one
     ``engine.step`` span per iteration, ms per decode step on and off
     (medians of interleaved pairs). (b) Three in-process cells (slots
     8, megastep 8; every cell's device work under ``capture_lock``)
     behind a ``Router`` and a ``Supervisor``, 96 requests of 16-128
     prompt and 32-64 new tokens: exactly once, token-identical to one
     engine's run of them (4 of them against ``sequential_generate``; a
     parting passes only as a diagnosed near-tie), the cells' paged
     launches summing to the kernel's count; again under FLEET_CHAOS (a
     cell killed after 3 dispatches, one stalled past the router's
     deadline, frame faults) and two more crashes, with device memory
     after the respawns within one cell's footprint of the fleet's
     start; again with one replica as a process of its own
     (``--ps-child replica``), SIGKILLed mid-traffic; the ``Collector``
     scrapes every registered replica, ``watch_fleet`` renders, and the
     merged timeline of the two processes holds the request lanes. (c)
     ``Autoscaler`` 1 -> 3 under a burst, drained to 1, rolled v1 -> v2
     with a kill mid-roll (each result v1's or v2's); a healthy v2 canary
     promoted by ``RolloutController`` on its verdicts, then one whose
     candidate stalls aborted while v1 serves, its forensic bundle
     verified by ``python -m paddle_tpu_torch.monitor bundle``. (d)
     DeepFM F8 D16 V20k scoring (``build_scoring_net``) over two
     row-sharded pservers: ``ScoringEngine`` batches of 1,024 on the
     card bitwise equal to the direct Executor at the same shape,
     within 1e-6 of the CPU's, then routed with ``OnlineTrainer``
     pushing, a pserver killed and recovered mid-serve, staleness
     within 5 s. (e) ``ParallelExecutor`` at one rank writes ``pexe``
     rows and ``pexe.step`` spans; ``debug_nans`` raises on a planted
     NaN on the card.

The last three lines of standard output are the kernels' JSON line, the
``nvidia-smi`` name/power-limit line, and ``{"ok": true, "device": ...}``.
In the kernels' line ``launches`` sums the eager main path's run, the
megastep graph's (counted through replays), phase 10's speculative
and plain runs, phase 11's and phase 12's; ``graph_launches`` gives the
graph's alone, ``spec_launches`` phase 10's, ``io_launches`` phase 11's
(the flash entries' ``io_bf16_launches`` its bf16 launches under AMP),
``options_launches`` phase 12's and ``mt_launches`` phase 13's eager MT
training run. The flash entries carry ``mt_shape``: their times and
bound at the MT decoder's shape [64, 8, 64, 32]. The ``dropout`` entry
(``"tpu_kernel": false``: the JAX package's dropout is no Pallas kernel)
counts phase 12's configuration-B runs and phase 13's eager VGG steps
(``zoo_launches``); its times and bound are at the
attention-weight shape [32, 8, 256, 256] f32 and its ``max_abs_err``
is the largest difference over its comparisons (0: they must be
bitwise).
The flash entries add phase 18's profiled and guarded LM steps and its
K=5 dispatch (``front_launches``), phase 19's runs, every rank's
(``par_launches``), and phase 20's trainers' (``ps_launches``). The ``matmul_stats`` entry adds phase
17 (a)'s launches through the loader's graphs (``data_launches``) and
phase 18 (d)'s 3 fused training steps (``front_launches``), and carries
``cifar_shortcut_shapes``,
its times, bound and error at the two ResNet-CIFAR shortcut shapes.
The ``lstm_cell`` entry (``"tpu_kernel": false``: the JAX package's
LSTM step is a ``lax.scan`` body XLA fuses) counts phase 15's 20 eager
steps (``graph_launches``: its K=5 dispatch), phase 16's 20 eager
SRL steps (``srl_launches``; ``srl_graph_launches``: its K=5
dispatch) and phase 17 (c)'s 3 loader-fed steps (``data_launches``;
``data_graph_launches``: its K=5 dispatch); its times and bound are
the forward step's at B 64 D 512 with the benchmark's lengths, a call's
mean over the 128 steps of one layer's scan, and it adds the backward
step's (``bwd_ms``, ``bwd_plain_ms``, ``bwd_bound_ms``, ``bwd_bound_by``,
``bwd_library_ms``, ``bwd_ms_with_host_gaps``) and one layer's scan
forward and backward against cuDNN's (``layer_ms``, ``cudnn_layer_ms``);
``library_ms`` is the library's route for a step, ``torch.mm`` then
ATen's ``_thnn_fused_lstm_cell`` (two calls: no single PyTorch call
computes the step; null where PyTorch lacks the cell).
Paged attention's ``launches`` add phase 21's (``fleet_launches``: (a)'s
four engine runs and (b)'s fault-free fleet run). Paged attention's
entry carries ``scoring_shape``: its times and bound
at (d), and its launches at the scoring shape among phase 10's: counted
inside each scoring dispatch (the kernel's counter read before and after
it, n_layer required) and each launch's query rows (C = 5 required).
Every entry's ``ms`` and ``library_ms`` are device time alone, and each
adds both read with the host's gaps
(``ms_with_host_gaps``, ``library_ms_with_host_gaps``); paged
attention's are at shape (a), and its ``launches`` count one per call.
matmul_stats's times and bound are sums over the 36 launches of one
ResNet-50 step, and its max_abs_err covers y, s1 and s2 (the sums'
absolute errors dominate: they are sums of up to 100,352 rows).
Without a CUDA card, or outside the repository, it exits non-zero and
prints no result.
"""

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
FP32_FLOPS = 67e12                 # H100 SXM fp32, outside tensor cores
TF32_FLOPS = 495e12                # H100 SXM TF32 tensor cores, dense
RTOL, ATOL = 1e-4, 1e-5

# the flagship transformer_lm defaults (models/transformer.py)
VOCAB, MAX_LEN, N_LAYER, N_HEAD, D_MODEL, D_INNER = 4096, 256, 4, 8, 512, 2048


class SmokeFailure(Exception):
    pass


def check(cond, msg, *args):
    if not cond:
        raise SmokeFailure(msg % args)


def log(msg, *args):
    print(msg % args if args else msg, flush=True)


# -- phase 1 -------------------------------------------------------------
def device_phase(torch):
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(proc.returncode == 0 and proc.stdout.strip(),
          "nvidia-smi failed: %s", proc.stderr.strip())
    smi = proc.stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("device: %s (torch %s, CUDA %s, %d card(s)); nvidia-smi: %s",
        torch.cuda.get_device_name(0), torch.__version__,
        torch.version.cuda, torch.cuda.device_count(), smi)
    return smi


# -- phase 2 -------------------------------------------------------------
def _kernel_name(line):
    """``kernel<args>`` from a ptxas line's mangled template name (the
    bare name for a kernel that is no template)."""
    m = re.search(r"([a-z_]+_kernel)I(\w*?)EE", line)
    if not m:
        m = re.search(r"([a-z_]+_kernel)E", line)
        return m.group(1) if m else line.strip()
    args = m.group(2)
    for mangled, plain in (("13__nv_bfloat16", "bf16"),
                           ("13__nv_fp8_e4m3", "fp8"), ("ELi", ", "),
                           ("Li", ", "),
                           ("Lb0", ", false"), ("Lb1", ", true")):
        args = args.replace(mangled, plain)
    head = {"f": "float", "a": "int8"}.get(args[:1])
    if head and not args.startswith("fp8"):
        args = head + args[1:]
    return "%s<%s>" % (m.group(1), args)


def _ptxas_report(text):
    """{kernel<args>: (registers, spill store bytes, spill load bytes)}
    from nvcc's -Xptxas -v output."""
    out, cur = {}, None
    for line in text.splitlines():
        if "Compiling entry" in line:
            cur = _kernel_name(line)
            out[cur] = [0, 0, 0]
        elif cur is None:
            continue
        elif "spill stores" in line:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                out[cur][1:] = [int(m.group(1)), int(m.group(2))]
        elif "Used" in line and "registers" in line:
            m = re.search(r"Used (\d+) registers", line)
            if m:
                out[cur][0] = int(m.group(1))
    return {k: tuple(v) for k, v in out.items()}


def build_phase():
    from paddle_tpu_torch.ops import _build
    names = ("paged_attention", "flash_attention", "matmul_stats",
             "dropout", "lstm_cell")
    t0 = time.perf_counter()
    _build.load_all(names)
    log("build: %s in %.2f s (one nvcc each, in parallel)",
        ", ".join(n + ".cu" for n in names), time.perf_counter() - t0)
    held = {}
    for name in names:
        report = _ptxas_report(_build.build_log.get(name, ""))
        for kernel, (regs, st, ld) in sorted(report.items()):
            log("  ptxas %s: %-36s %3d registers, spill stores %d bytes, "
                "spill loads %d bytes", name, kernel, regs, st, ld)
            if kernel.startswith(("flash_", "matmul_stats_kernel",
                                  "paged_", "dropout_kernel", "lstm_cell_")):
                held[kernel] = st, ld
    counts = {p: sum(k.startswith(p) for k in held)
              for p in ("flash_", "matmul_stats_kernel", "paged_",
                        "dropout_kernel", "lstm_cell_")}
    for prefix, want, what in (
            ("flash_", 18, "3 kernels x 2 dtypes x 3 widths"),
            ("matmul_stats_kernel", 6, "2 dtypes x 3 tiles"),
            ("paged_", 24, "4 pool types x 3 widths x 2 row classes"),
            ("dropout_kernel", 8, "2 dtypes x upscale x mask"),
            ("lstm_cell_", 2, "forward and backward")):
        check(counts[prefix] == want, "ptxas reported %d %s kernels, "
              "expected %d (%s)", counts[prefix], prefix, want, what)
    spilled = [k for k, (st, ld) in held.items() if st or ld]
    check(not spilled, "ptxas spills in the paged, flash, matmul_stats, "
          "dropout or lstm_cell kernels: %s", spilled)


# -- phase 3 -------------------------------------------------------------
QUANTS = {"fp32": None, "bf16": None, "int8": "int8", "fp8": "fp8"}


def _pool_case(torch, rng, s, c, chains, quant, layers=4, h=8, bs=16,
               dk=64, nbmax=16, nb=None):
    """A random pool problem: K/V drawn on the card from a seed taken
    from ``rng``; slot i's chain of ``chains[i]`` blocks, its last query
    at the chain's last block."""
    from paddle_tpu_torch.ops import paged_attention as P
    dev = torch.device("cuda")
    nb = nb or s * nbmax + 4
    shape = (nb, layers, h, bs, dk)
    g = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))
    pk = torch.randn(shape, generator=g, device=dev)
    pv = torch.randn(shape, generator=g, device=dev)
    btab = rng.permutation(nb)[:s * nbmax].reshape(s, nbmax)
    qpos = np.stack([rng.integers(0, ch * bs, size=c) for ch in chains])
    qpos[:, -1] = (np.asarray(chains) - 1) * bs + rng.integers(0, bs, s)
    q = rng.normal(size=(s, h, c, dk)).astype(np.float32) * dk ** -0.5
    case = {"q": torch.from_numpy(q).to(dev),
            "btab": torch.from_numpy(btab.astype(np.int32)).to(dev),
            "qpos": torch.from_numpy(qpos.astype(np.int32)).to(dev),
            "k_scale": None, "v_scale": None}
    spec = P.kv_quant_spec(QUANTS[quant])
    if spec is not None:
        pk, case["k_scale"] = P.quantize_kv(pk, spec[0])
        pv, case["v_scale"] = P.quantize_kv(pv, spec[0])
    elif quant == "bf16":
        pk, pv = pk.to(torch.bfloat16), pv.to(torch.bfloat16)
    case["pool_k"], case["pool_v"] = pk.contiguous(), pv.contiguous()
    return case


# (S, C, dk, bs, NBmax, pool types): the serving shapes (decode S=32,
# a prefill chunk C=16, a speculative width C=5) at dk 64 and bs 16 in
# all four pool types; dk 128 and 256; bs 32; chains up to 128 blocks
# (many splits, many of them past a short chain); 1-byte codes whose
# K/V tiles are not a multiple of 16 bytes (bs 3, dk 8: 8-byte copies)
PAGED_CASES = [(s, c, 64, 16, 16, tuple(QUANTS))
               for s, c in ((32, 1), (1, 16), (8, 5))] + \
    [(s, c, dk, 16, 16, tuple(QUANTS)) for dk in (128, 256)
     for s, c in ((8, 1), (1, 16), (4, 5))] + \
    [(s, c, 64, 32, 8, tuple(QUANTS)) for s, c in ((8, 1), (1, 16))] + \
    [(s, c, 64, 16, 128, ("fp32", "fp8")) for s, c in ((4, 1), (2, 16))] + \
    [(s, c, 8, 3, 6, ("int8", "fp8")) for s, c in ((4, 1), (3, 5))]


def kernel_phase(torch):
    """Every listed case against the plain version, at layers 0 and 3,
    with nblk at NBmax and at half of it (which caps the walk below the
    longest chain: only slots whose own chain fits are live rows);
    returns the largest absolute error seen."""
    from paddle_tpu_torch.ops import paged_attention as P
    rng = np.random.default_rng(0)
    worst, n = 0.0, 0
    for s, c, dk, bs, nbmax, quants in PAGED_CASES:
        for quant in quants:
            chains = rng.integers(1, nbmax + 1, size=s)
            chains[0] = nbmax
            case = _pool_case(torch, rng, s, c, chains, quant, bs=bs, dk=dk,
                              nbmax=nbmax)
            args = tuple(case[k] for k in ("q", "pool_k", "pool_v", "btab",
                                           "qpos"))
            splits = P._splits(s, args[0].shape[1], c, nbmax, bs)
            for layer in (0, 3):
                for nblk in [v for v in (nbmax, nbmax // 2)
                             if v and (chains <= v).any()]:
                    nb_t = torch.tensor([nblk], dtype=torch.int32,
                                        device="cuda")
                    got = P.paged_attention(
                        *args, nblk=nb_t, k_scale=case["k_scale"],
                        v_scale=case["v_scale"], layer=layer)
                    ref = P._attend_plain(
                        *args, nblk, case["k_scale"], case["v_scale"],
                        layer=layer)
                    torch.cuda.synchronize()
                    live = torch.as_tensor(chains <= nblk, device="cuda")
                    err = (got[live] - ref[live]).abs()
                    bad = err > ATOL + RTOL * ref[live].abs()
                    worst = max(worst, float(err.max()))
                    n += 1
                    check(bool(torch.isfinite(got[live]).all())
                          and not bool(bad.any()),
                          "kernel disagrees with _attend_plain: S=%d C=%d "
                          "dk=%d bs=%d NBmax=%d %s layer=%d nblk=%d "
                          "max_abs_err=%g", s, c, dk, bs, nbmax, quant,
                          layer, nblk, float(err.max()))
                    log("kernel: S=%-2d C=%-2d dk=%-3d bs=%-2d NBmax=%-3d "
                        "%-4s splits=%-3d layer=%d nblk=%-3d "
                        "max_abs_err=%.3g  ok", s, c, dk, bs, nbmax, quant,
                        splits, layer, nblk, float(err.max()))
    log("kernel: %d comparisons ok; largest abs error %.3g", n, worst)
    return worst


def _paged_shapes(torch):
    """The three timed shapes on one 4-layer pool of 512 blocks (S=32,
    H=8, bs 16, dk 64, fp32; 33.5 MB a layer, 134 MB rotating through
    the 50 MB L2 as the decode loop meets them): (a) decode, every slot
    at 256 positions; (b) decode with ragged chains of 1..16 blocks;
    (c) a prefill chunk, S=1, C=16, a chain of 14 blocks."""
    rng = np.random.default_rng(1)
    s, bs, nbmax = 32, 16, 16
    case = _pool_case(torch, rng, s, 1, [nbmax] * s, "fp32", nb=s * nbmax)
    case["qpos"].fill_(nbmax * bs - 1)
    ragged = rng.integers(1, nbmax + 1, size=s)
    qpos_b = (ragged - 1) * bs + rng.integers(0, bs, size=s)
    q16 = rng.normal(size=(1, 8, 16, 64)).astype(np.float32) * 0.125
    shapes = {
        "a": (case["q"], case["btab"], case["qpos"], nbmax),
        "b": (case["q"], case["btab"], torch.from_numpy(
            qpos_b[:, None].astype(np.int32)).cuda(), int(ragged.max())),
        "c": (torch.from_numpy(q16).cuda(), case["btab"][:1],
              torch.arange(13 * bs, 14 * bs, dtype=torch.int32,
                           device="cuda")[None], 14),
    }
    return case["pool_k"], case["pool_v"], shapes


def _paged_work(q, qpos, h, dk, bs, itemsize=4):
    """(bytes, flops) one call needs: each live K/V element read once
    (the blocks up to each slot's last query), q read and out written
    once, the tables read; 4 flops per (query, key, dk) pair that
    attends (2 for QK^T, 2 for PV)."""
    s, c = qpos.shape
    qp = qpos.long().cpu()
    blocks = int((qp.max(dim=1).values // bs + 1).sum())
    pairs = int((qp + 1).sum())
    nbytes = (2 * blocks * h * bs * dk * itemsize + 2 * q.numel() * 4
              + 4 * (qpos.numel() + blocks))
    return nbytes, 4 * pairs * h * dk


def timing_phase(torch):
    """Kernel, plain version and library call at the three shapes, each
    as device time alone (a sleep kernel hides the host's enqueue) and
    with the host's gaps (calls back to back, each between its own
    events); the library call is scaled_dot_product_attention over the
    gathered dense K/V (a yardstick the port never calls), with a
    boolean mask from qpos where the chains are ragged or C > 1. Then
    two launches on the same inputs must be bitwise equal at (a) and
    (c). Returns the kernels-line entry (shape a)."""
    from paddle_tpu_torch.ops import paged_attention as P
    pk, pv, shapes = _paged_shapes(torch)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    h, bs, dk = pk.shape[2], pk.shape[3], pk.shape[4]
    out = {}
    for name, (q, bt, qp, nblk) in shapes.items():
        nb_t = torch.tensor([nblk], dtype=torch.int32, device="cuda")
        c = qp.shape[1]
        npos = nblk * bs
        dense, mask = [], None
        if name != "a":
            kpos = torch.arange(npos, device="cuda")
            mask = (kpos[None, None, None, :] <= qp[:, None, :, None])
        for layer in range(4):
            kv = []
            for pool in (pk, pv):
                g = pool[:, layer][bt[:, :nblk].long()]
                kv.append(g.permute(0, 2, 1, 3, 4).reshape(
                    bt.shape[0], h, npos, dk).contiguous())
            dense.append(kv)

        def kernel(i):
            P.paged_attention(q, pk, pv, bt, qp, nblk=nb_t, layer=i % 4)

        def library(i):
            k, v = dense[i % 4]
            sdpa(q, k, v, attn_mask=mask, scale=1.0)

        def plain(i):
            P._attend_plain(q, pk, pv, bt, qp, nblk, None, None,
                            layer=i % 4)
        r = {"ms": _events_ms(torch, kernel, 100, hide_host=True),
             "ms_with_host_gaps": _events_ms(torch, kernel, 100),
             "library_ms": _events_ms(torch, library, 100,
                                      hide_host=True),
             "library_ms_with_host_gaps": _events_ms(torch, library, 100),
             "plain_ms": _events_ms(torch, plain, 5)}
        got = P.paged_attention(q, pk, pv, bt, qp, nblk=nb_t, layer=0)
        lib = sdpa(q, dense[0][0], dense[0][1], attn_mask=mask, scale=1.0)
        check(torch.allclose(got, lib, rtol=RTOL, atol=ATOL),
              "kernel disagrees with scaled_dot_product_attention at (%s)",
              name)
        if name in ("a", "c"):
            again = P.paged_attention(q, pk, pv, bt, qp, nblk=nb_t,
                                      layer=0)
            torch.cuda.synchronize()
            check(torch.equal(got, again), "two launches at (%s) are not "
                  "bitwise equal", name)
        nbytes, flops = _paged_work(q, qp, h, dk, bs)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / FP32_FLOPS * 1e3
        r.update(bound_ms=max(bytes_ms, ops_ms),
                 bound_by="bytes" if bytes_ms >= ops_ms else "operations")
        splits = P._splits(q.shape[0], h, c, bt.shape[1], bs)
        log("timing (%s) S=%d H=%d C=%d dk=%d bs=%d, %s fp32, splits %d: "
            "device time alone kernel_ms=%.5f library_ms=%.5f (kernel / "
            "library %.3f); with the host's gaps kernel_ms=%.5f "
            "library_ms=%.5f; plain_ms=%.5f (with gaps); bound_ms=%.5f "
            "(%s: %d bytes %.5f ms, %d flops at fp32 SIMT %.5f ms)%s",
            name, q.shape[0], h, c, dk, bs,
            {"a": "256 positions per slot",
             "b": "ragged chains of 1..16 blocks",
             "c": "a chain of 14 blocks"}[name], splits, r["ms"],
            r["library_ms"], r["ms"] / r["library_ms"],
            r["ms_with_host_gaps"], r["library_ms_with_host_gaps"],
            r["plain_ms"], r["bound_ms"], r["bound_by"], nbytes, bytes_ms,
            flops, ops_ms, "; two launches bitwise equal"
            if name in ("a", "c") else "")
        out[name] = r
    return out["a"]


# -- phase 4 -------------------------------------------------------------
def _requests(rng):
    prefix = [1] + rng.integers(3, VOCAB, 63).tolist()
    reqs = []
    for i in range(64):
        if i % 2 == 0:
            prompt = prefix + rng.integers(
                3, VOCAB, int(rng.integers(1, 33))).tolist()
        else:
            prompt = [1] + rng.integers(
                3, VOCAB, int(rng.integers(7, 96))).tolist()
        reqs.append((prompt, int(rng.integers(32, 129))))
    return reqs


def slice_phase(torch):
    from paddle_tpu_torch.models.transformer_infer import (
        TransformerLMInfer, init_stream)
    from paddle_tpu_torch.ops import paged_attention as P
    from paddle_tpu_torch.serving import Engine, sequential_generate
    stream = init_stream(VOCAB, MAX_LEN, N_LAYER, N_HEAD, D_MODEL, D_INNER,
                         seed=0)
    # end_id past the vocabulary: random weights never stop early
    model = TransformerLMInfer.from_stream(
        stream, N_LAYER, N_HEAD, D_MODEL, MAX_LEN, end_id=VOCAB)
    check(model.device.type == "cuda", "model is not on the card")
    reqs = _requests(np.random.default_rng(0))
    prompts, max_new = [p for p, _ in reqs], [m for _, m in reqs]
    runs = {}
    for kernel in (True, False):
        with Engine(model, slots=32, prefill_chunk=16, block_size=16,
                    block_kernel=kernel) as eng:
            check(eng._block_kernel is kernel, "attention path mismatch")
            eng.warmup()
            P.paged_attention.launches = 0
            t0 = time.perf_counter()
            out = eng.generate_many(prompts, max_new)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = P.paged_attention.launches
            stats = dict(eng.stats)
            pool_mb = sum(t.numel() * t.element_size()
                          for n, t in eng._state.items()
                          if n.startswith("pool")) / 1e6
        runs[kernel] = (out, wall, launches, stats)
        ntok = sum(len(t) for t, _ in out)
        log("slice (%s): %d requests, %d tokens in %.3f s = %.1f tokens/s; "
            "mean decode step %.3f ms over %d steps; prefill chunks %d; "
            "prefix_hits %d; preemptions %d; pool %.1f MB; kernel "
            "launches %d", "block kernel" if kernel else "gather",
            len(out), ntok, wall, ntok / wall,
            1e3 * stats["decode_seconds"] / stats["decode_steps"],
            stats["decode_steps"], stats["prefill_chunks"],
            stats["prefix_hits"], stats["preemptions"], pool_mb, launches)
    out, _, launches, stats = runs[True]
    dispatches = stats["decode_steps"] + stats["prefill_chunks"]
    check(launches >= N_LAYER * dispatches,
          "kernel launches %d < n_layer x dispatches %d", launches,
          N_LAYER * dispatches)
    check(runs[False][2] == 0, "the gather path launched the kernel")
    for i, ((toks, score), (req_p, req_m)) in enumerate(zip(out, reqs)):
        check(len(toks) == req_m and all(0 <= t < VOCAB for t in toks)
              and np.isfinite(score), "request %d: bad output", i)
    gather = runs[False][0]
    diverged = [i for i, (a, b) in enumerate(zip(out, gather))
                if a[0] != b[0]]
    check(not diverged, "block-kernel tokens differ from the gather "
          "path's for requests %s", diverged)
    check(stats["prefix_hits"] > 0, "no prefix-cache hit")
    seq = sequential_generate(model, reqs[:4])
    for i, ((a, sa), (b, sb)) in enumerate(zip(out[:4], seq)):
        check(a == b, "request %d differs from sequential_generate", i)
        check(abs(sa - sb) <= 1e-3 * max(1.0, abs(sb)),
              "request %d score %r vs sequential %r", i, sa, sb)
    log("slice: tokens equal the gather path (64 requests) and "
        "sequential_generate (4 requests); %d launches for %d dispatches "
        "x %d layers", launches, dispatches, N_LAYER)
    fp8_slice_phase(torch, model, reqs[:16])
    profile_phase(torch, model, reqs)
    return launches


def fp8_slice_phase(torch, model, reqs):
    """The same engine over an fp8-e4m3 pool (``kv_quant='fp8'``): codes
    and per-vector scales written on the card, read by the kernel and,
    on the gather path, by the dense gather; both paths must give the
    same tokens."""
    from paddle_tpu_torch.ops import paged_attention as P
    from paddle_tpu_torch.serving import Engine
    prompts, max_new = [p for p, _ in reqs], [m for _, m in reqs]
    outs = {}
    for kernel in (True, False):
        with Engine(model, slots=32, prefill_chunk=16, block_size=16,
                    block_kernel=kernel, kv_quant="fp8") as eng:
            check(eng._state["pool_k"].dtype == torch.float8_e4m3fn,
                  "the fp8 engine's pool is %s", eng._state["pool_k"].dtype)
            eng.warmup()
            P.paged_attention.launches = 0
            outs[kernel] = eng.generate_many(prompts, max_new)
            torch.cuda.synchronize()
            launches = P.paged_attention.launches
            dispatches = (eng.stats["decode_steps"]
                          + eng.stats["prefill_chunks"])
        if kernel:
            check(launches >= N_LAYER * dispatches, "fp8: kernel launches "
                  "%d < n_layer x dispatches %d", launches,
                  N_LAYER * dispatches)
            kernel_launches = launches
    for i, ((toks, score), req_m) in enumerate(zip(outs[True], max_new)):
        check(len(toks) == req_m and all(0 <= t < VOCAB for t in toks)
              and np.isfinite(score), "fp8 request %d: bad output", i)
    diverged = [i for i, (a, b) in enumerate(zip(outs[True], outs[False]))
                if a[0] != b[0]]
    check(not diverged, "fp8 pool: block-kernel tokens differ from the "
          "gather path's for requests %s", diverged)
    log("slice (fp8 pool): %d requests, tokens equal on the block kernel "
        "and the gather path; %d launches", len(reqs), kernel_launches)


def profile_phase(torch, model, reqs):
    """A separate traced pass (the timed runs above are untraced): the
    block-kernel engine serves the first 32 requests under
    torch.profiler with device activity only; prints the device busy
    share of the wall time, the kernels that take the most of it, and
    the paged kernel's share."""
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.serving import Engine
    sub = reqs[:32]
    with Engine(model, slots=32, prefill_chunk=16, block_size=16) as eng:
        eng.warmup()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            eng.generate_many([p for p, _ in sub], [m for _, m in sub])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        steps = eng.stats["decode_steps"] + eng.stats["prefill_chunks"]
    _report_profile(prof, wall, "profile (traced, 32 requests, %d "
                    "dispatches)" % steps, focus="paged_attention_kernel")


# -- phase 5 -------------------------------------------------------------
BF16_ATOL, BF16_RTOL = 1e-2, 2.0 ** -7
# (causal, T, D, B, H); then the contract's narrowest and widest D; the
# last of each list is the training path's own shape (bf16: under AMP)
TRAIN_FLASH_CASE = (True, MAX_LEN, D_MODEL // N_HEAD, 32, N_HEAD)
FLASH_CASES = [(causal, t, d, 1, h) for causal in (False, True)
               for t in (128, 256, 200, 1024) for d in (64, 128)
               for h in (1, 16)] + \
    [(causal, t, d, 1, 16) for causal in (False, True) for t in (200, 256)
     for d in (8, 256)] + [TRAIN_FLASH_CASE]
FLASH_BF16_CASES = [(causal, t, d, 1, 16) for causal in (False, True)
                    for t in (128, 200) for d in (64, 128)] + \
    [(True, 200, 256, 1, 16), TRAIN_FLASH_CASE]


def _flash_case(torch, F, causal, t, d, b, h, dtype, seed):
    """One forward + backward through the kernels and through the plain
    version on the same inputs; returns the error of each output."""
    g = torch.Generator().manual_seed(seed)

    def draw(*shape):
        return torch.randn(*shape, generator=g).to("cuda")
    q, k, v = [draw(b, h, t, d).to(dtype).requires_grad_(True)
               for _ in range(3)]
    dout, dlse = draw(b, h, t, d), draw(b, h, t)
    errs = {}
    results = []
    for fn in (F.flash_attention_lse, F._dense_lse):
        out, lse = fn(q, k, v, causal=causal, scale=d ** -0.5)
        loss = (out.float() * dout).sum() + (lse * dlse).sum()
        grads = torch.autograd.grad(loss, [q, k, v])
        results.append([x.detach().float() for x in (out, lse) + grads])
    torch.cuda.synchronize()
    atol, rtol = (ATOL, RTOL) if dtype == torch.float32 else (BF16_ATOL,
                                                             BF16_RTOL)
    for name, got, ref in zip(("o", "lse", "dq", "dk", "dv"), *results):
        scale = 1.0
        if name not in ("o", "lse"):
            scale = float(ref.abs().max().clamp_min(1e-30))
        err = (got - ref).abs()
        bad = err > atol * scale + rtol * ref.abs()
        check(bool(torch.isfinite(got).all()) and not bool(bad.any()),
              "flash %s disagrees with the plain version: %s causal=%s "
              "T=%d D=%d B=%d H=%d max_abs_err=%g", name, dtype, causal, t,
              d, b, h, float(err.max()))
        errs[name] = (float(err.max()), float(err.max()) / scale)
    return errs


def flash_kernel_phase(torch):
    """Every case against the plain version; returns the largest fp32
    absolute error per kernel."""
    from paddle_tpu_torch.ops import flash_attention as F
    worst = {"flash_fwd": 0.0, "flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
    cases = [(c, torch.float32) for c in FLASH_CASES] + \
        [(c, torch.bfloat16) for c in FLASH_BF16_CASES]
    for i, ((causal, t, d, b, h), dtype) in enumerate(cases):
        e = _flash_case(torch, F, causal, t, d, b, h, dtype, seed=i)
        log("flash: %-8s causal=%-5s T=%-4d D=%-3d B=%-2d H=%-2d "
            "max_abs_err o %.2e lse %.2e | scaled dq %.2e dk %.2e dv %.2e  "
            "ok", str(dtype).replace("torch.", ""), causal, t, d, b, h,
            e["o"][0], e["lse"][0], e["dq"][1], e["dk"][1], e["dv"][1])
        if dtype == torch.float32:
            worst["flash_fwd"] = max(worst["flash_fwd"], e["o"][0],
                                     e["lse"][0])
            worst["flash_bwd_dq"] = max(worst["flash_bwd_dq"], e["dq"][0])
            worst["flash_bwd_dkv"] = max(worst["flash_bwd_dkv"],
                                         e["dk"][0], e["dv"][0])
    log("flash: %d cases ok (%d fp32, %d bf16); largest fp32 abs errors %s",
        len(cases), len(FLASH_CASES), len(cases) - len(FLASH_CASES),
        ", ".join("%s %.3g" % kv for kv in worst.items()))
    flash_backward_checks(torch, F)
    return worst


def flash_backward_checks(torch, F):
    """At the training shape (fp32) and the widest bf16 case, with a
    nonzero dLSE: two forwards on the same inputs give bitwise-equal O and
    LSE, two backwards bitwise-equal dQ, dK, dV and delta (no atomics),
    and the delta the dQ kernel wrote
    agrees with its plain version ``_delta`` (atol 1e-5 of max|delta|,
    rtol 1e-4: the two sum the D products in other orders)."""
    for (causal, t, d, b, h), dtype in (
            (TRAIN_FLASH_CASE, torch.float32),
            ((True, 200, 256, 1, 16), torch.bfloat16)):
        g = torch.Generator().manual_seed(7)
        q, k, v, dout = [torch.randn(b, h, t, d, generator=g).to(
            "cuda", dtype) for _ in range(4)]
        dlse = torch.randn(b, h, t, generator=g).to("cuda")
        scale = d ** -0.5
        out, lse = F._fwd_cuda(q, k, v, causal, scale)
        out2, lse2 = F._fwd_cuda(q, k, v, causal, scale)
        torch.cuda.synchronize()
        check(torch.equal(out, out2) and torch.equal(lse, lse2),
              "flash forward not bitwise repeatable (%s T=%d D=%d): o, lse "
              "equal %s", dtype, t, d,
              [torch.equal(out, out2), torch.equal(lse, lse2)])
        runs = []
        for _ in range(2):
            dq, delta = F._bwd_dq_cuda(q, k, v, out, dout, lse, dlse,
                                        causal, scale)
            dk, dv = F._bwd_dkv_cuda(q, k, v, dout, lse, delta, causal,
                                     scale)
            runs.append((dq, dk, dv, delta))
        torch.cuda.synchronize()
        same = [torch.equal(a, b) for a, b in zip(*runs)]
        check(all(same), "flash backward not bitwise repeatable (%s T=%d "
              "D=%d): dq, dk, dv, delta equal %s", dtype, t, d, same)
        ref = F._delta(out, dout, dlse)
        err = (runs[0][3] - ref).abs()
        top = float(ref.abs().max())
        check(not bool((err > ATOL * top + RTOL * ref.abs()).any()),
              "kernel-written delta disagrees with _delta (%s T=%d D=%d): "
              "max_abs_err %g of max|delta| %g", dtype, t, d,
              float(err.max()), top)
        log("flash backward: %s causal=%s T=%d D=%d B=%d H=%d: two "
            "forwards bitwise equal (o, lse), two backwards bitwise equal "
            "(dq, dk, dv, delta); kernel delta vs "
            "_delta max_abs_err %.3g (max|delta| %.3g)  ok",
            str(dtype).replace("torch.", ""), causal, t, d, b, h,
            float(err.max()), top)


HIDE_HOST_CYCLES = 4_000_000       # ~2 ms of the card's clock


def _events_ms(torch, fn, reps, prep=None, hide_host=False,
               sleep_cycles=HIDE_HOST_CYCLES):
    """Mean device ms of ``fn(i)`` over ``reps`` calls, CUDA-event timed
    around each call; ``prep(i)``, when given, runs before each call
    outside the timed span (to build an autograd graph). With
    ``hide_host``, a sleep kernel of ``sleep_cycles`` queued before the
    start event keeps the card busy while the host enqueues the call, so
    the span is device time alone, without the host's gaps between the
    call's launches."""
    for i in range(3):
        if prep:
            prep(i)
        fn(i)
    torch.cuda.synchronize()
    pairs = []
    for i in range(reps):
        if prep:
            prep(i)
        if hide_host:
            torch.cuda._sleep(sleep_cycles)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn(i)
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / reps


def flash_timing_phase(torch, b=32, h=8, t=MAX_LEN, d=64):
    """The LM's training shape by default: B=32, H=8, T=256, D=64,
    causal, fp32. Four input sets (4 x 67 MB there) rotate through the
    50 MB L2, as the layers of a training step meet them."""
    from paddle_tpu_torch.ops import flash_attention as F
    scale = d ** -0.5
    shape = "B=%d H=%d T=%d D=%d causal fp32" % (b, h, t, d)
    sets = []
    for i in range(4):
        g = torch.Generator().manual_seed(100 + i)
        q, k, v, dout = [torch.randn(b, h, t, d, generator=g).to("cuda")
                         for _ in range(4)]
        out, lse = F._fwd_cuda(q, k, v, True, scale)
        _, delta = F._bwd_dq_cuda(q, k, v, out, dout, lse, None, True,
                                  scale)
        sets.append((q, k, v, dout, out, lse, delta))
    cur = {}

    def fwd(i):
        q, k, v = sets[i % 4][:3]
        F._fwd_cuda(q, k, v, True, scale)

    def dq(i):
        q, k, v, dout, out, lse, _ = sets[i % 4]
        F._bwd_dq_cuda(q, k, v, out, dout, lse, None, True, scale)

    def dkv(i):
        q, k, v, dout, _, lse, delta = sets[i % 4]
        F._bwd_dkv_cuda(q, k, v, dout, lse, delta, True, scale)

    def graph(fn):
        def prep(i):
            q, k, v, dout = [x.detach().requires_grad_(True)
                             for x in sets[i % 4][:4]]
            cur["out"] = fn(q, k, v)
            cur["in"], cur["dout"] = (q, k, v), dout
        return prep

    def backward(i):
        torch.autograd.grad(cur["out"], cur["in"], cur["dout"])

    sdpa = torch.nn.functional.scaled_dot_product_attention

    def plain(q, k, v):
        return F._dense_lse(q, k, v, True, scale)[0]

    def lib(q, k, v):
        return sdpa(q, k, v, is_causal=True, scale=scale)

    def kernels(q, k, v):
        return F.flash_attention(q, k, v, causal=True, scale=scale)

    # each launch read two ways: as device time alone (a sleep kernel
    # hides the host's enqueue, which can outlast a 0.1 ms kernel) and
    # with the host's gaps (calls enqueued one after another, as a step
    # enqueues them: a host slower than the card shows as idle card)
    times, gaps = {}, {}
    for name, fn in (("flash_fwd", fwd), ("flash_bwd_dq", dq),
                     ("flash_bwd_dkv", dkv)):
        times[name] = _events_ms(torch, fn, 50, hide_host=True)
        gaps[name] = _events_ms(torch, fn, 50)
    with torch.no_grad():
        plain_fwd = _events_ms(torch, lambda i: plain(*sets[i % 4][:3]), 10,
                               hide_host=True)
        lib_fwd = _events_ms(torch, lambda i: lib(*sets[i % 4][:3]), 50,
                             hide_host=True)
        lib_fwd_gaps = _events_ms(torch, lambda i: lib(*sets[i % 4][:3]), 50)
    # the whole backward through autograd, each route timed the same way:
    # with the host's gaps (as enqueued) and as device time alone; the
    # library twice, before and after the kernel route
    whole = {}
    for hide in (False, True):
        for route, fn, reps in (("plain", plain, 10), ("library", lib, 50),
                                ("kernels", kernels, 50),
                                ("library again", lib, 50)):
            whole[route, hide] = _events_ms(torch, backward, reps,
                                            prep=graph(fn), hide_host=hide)
    plain_bwd, lib_bwd = whole["plain", True], whole["library", True]
    q, k, v, _, out = sets[0][:5]
    check(torch.allclose(out, lib(q, k, v), rtol=RTOL, atol=ATOL),
          "flash forward disagrees with scaled_dot_product_attention")
    # the work this run's data needs: causal keeps T(T+1)/2 of the T^2
    # (query, key) pairs; each product is 2 flops per pair and head dim
    pairs = b * h * t * (t + 1) // 2
    elem = b * h * t * d * 4                # one [B, H, T, D] f32 tensor
    row = b * h * t * 4                     # one [B, H, T] f32 tensor
    # (flops, bytes: inputs read once, outputs written once, peak). Every
    # kernel's products run on the TF32 tensor cores (3xTF32: the
    # emulation's 3 MMAs are not counted as work). fwd reads q, k, v and
    # writes o and lse; dq reads q, k, v, o, do and lse and writes dq and
    # delta; dkv reads q, k, v, do, lse and delta and writes dk and dv.
    work = {
        "flash_fwd": (2 * 2 * pairs * d, 4 * elem + row, TF32_FLOPS),
        "flash_bwd_dq": (3 * 2 * pairs * d, 6 * elem + 2 * row, TF32_FLOPS),
        "flash_bwd_dkv": (4 * 2 * pairs * d, 6 * elem + 2 * row,
                          TF32_FLOPS),
    }
    out = {}
    for name, (flops, nbytes, peak) in work.items():
        ops_ms = flops / peak * 1e3
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        fwd_side = name == "flash_fwd"
        out[name] = {
            "ms": times[name],
            "plain_ms": plain_fwd if fwd_side else plain_bwd,
            "library_ms": lib_fwd if fwd_side else lib_bwd,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "ms_with_host_gaps": gaps[name],
            "library_ms_with_host_gaps": (lib_fwd_gaps if fwd_side else
                                          whole["library", False])}
        log("timing %s (%s), device time "
            "alone: kernel_ms=%.5f bound_ms=%.5f (%s; operations %.5f ms "
            "at %g TFLOP/s, bytes %.5f ms: %d flops, %d bytes; fp32-SIMT "
            "operations bound %.5f ms) plain_ms=%.5f library_ms=%.5f; with "
            "the host's gaps: kernel_ms=%.5f library_ms=%.5f%s", name,
            shape, times[name], out[name]["bound_ms"], out[name]["bound_by"],
            ops_ms, peak / 1e12, bytes_ms, flops, nbytes,
            flops / FP32_FLOPS * 1e3, out[name]["plain_ms"],
            out[name]["library_ms"], gaps[name],
            out[name]["library_ms_with_host_gaps"], "" if fwd_side else
            " (plain and library: one backward computing dq, dk, dv)")
    for hide, how in ((True, "device time alone"),
                      (False, "with the host's gaps")):
        kern = whole["kernels", hide]
        libs = whole["library", hide], whole["library again", hide]
        log("timing: whole backward through autograd (%s), %s: kernel "
            "route %.5f ms (dq %.5f + dkv %.5f "
            "timed alone), library (scaled_dot_product_attention) %.5f / "
            "%.5f ms (before and after), plain %.5f ms; kernel route / "
            "library %.3f", shape, how, kern, times["flash_bwd_dq"],
            times["flash_bwd_dkv"], libs[0], libs[1], whole["plain", hide],
            kern / min(libs))
    _library_backward_kernels(torch, backward, graph(lib))
    return out


def _library_backward_kernels(torch, backward, prep):
    """Name the kernels of scaled_dot_product_attention's backward (which
    backend the library yardstick is) from a short traced pass."""
    from torch.profiler import ProfilerActivity, profile
    prep(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        backward(0)
        torch.cuda.synchronize()
    rows = _device_rows(torch, prof)
    if not rows:
        log("library backward kernels: the profiler reported no device "
            "time (not measured)")
        return
    for dev_us, count, key in sorted(rows, reverse=True)[:6]:
        log("library backward kernel: %8.4f ms x%d  %s", dev_us / 1e3,
            count, key[:110])


# -- phase 6 -------------------------------------------------------------
TRAIN_BATCH, TRAIN_STEPS, PARITY_STEPS = 32, 10, 3


def _lm_program(fluid, T, packed, optimizer="adam"):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        # the constants are transformer_lm's own defaults
        avg_cost, _ = T.transformer_lm(
            vocab_size=VOCAB, max_len=MAX_LEN, n_layer=N_LAYER,
            n_head=N_HEAD, d_model=D_MODEL, d_inner=D_INNER, packed=packed)
        if optimizer == "adam":
            fluid.optimizer.Adam(learning_rate=1e-3).minimize(avg_cost)
        else:
            fluid.optimizer.SGD(learning_rate=0.1).minimize(avg_cost)
    return main, startup, avg_cost


def _train(torch, fluid, exe, prog, init, batches, steps):
    """``steps`` steps from a fresh copy of ``init``: (losses, wall
    seconds of steps 2..n, scope)."""
    main, _, avg_cost = prog
    scope = fluid.Scope()
    fluid.load_numpy_state(scope, init, exe.device)
    losses = []
    t0 = None
    for i in range(steps):
        if i == 1:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        loss, = exe.run(main, feed=batches[i % len(batches)],
                        fetch_list=[avg_cost], scope=scope)
        losses.append(float(loss))
    torch.cuda.synchronize()
    return losses, time.perf_counter() - t0, scope


def train_phase(torch):
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import transformer as T
    from paddle_tpu_torch.ops import flash_attention as F
    exe = fluid.Executor(fluid.CUDAPlace(0))
    check(exe.device.type == "cuda", "the executor is not on the card")
    check(fluid.Executor().device.type == "cuda",
          "Executor() does not default to the card")
    packed = _lm_program(fluid, T, True)
    unpacked = _lm_program(fluid, T, False)
    ops = [op.type for op in packed[0].global_block().ops]
    check(ops.count("sp_attention") == N_LAYER and "softmax" not in ops,
          "the packed program does not route attention to sp_attention")
    scope0 = fluid.Scope()
    exe.run(packed[1], scope=scope0)
    init = {n: scope0.get_numpy(n) for n in scope0.local_var_names()
            if scope0.find_var(n) is not None}
    batches = [T.make_lm_batch(np.random.RandomState(seed), TRAIN_BATCH,
                               MAX_LEN, VOCAB) for seed in (0, 1)]
    tokens = TRAIN_BATCH * MAX_LEN
    runs = {}
    for name, prog in (("packed", packed), ("unpacked", unpacked)):
        for key in F.flash_attention.launches:
            F.flash_attention.launches[key] = 0
        losses, wall, _ = _train(torch, fluid, exe, prog, init, batches,
                                 TRAIN_STEPS)
        launches = dict(F.flash_attention.launches)
        runs[name] = (losses, wall, launches)
        log("train (%s): %d steps, losses %s; %.1f tokens/s, mean step "
            "%.3f ms (steps 2..%d); flash launches %s", name, TRAIN_STEPS,
            " ".join("%.4f" % x for x in losses),
            tokens * (TRAIN_STEPS - 1) / wall,
            1e3 * wall / (TRAIN_STEPS - 1), TRAIN_STEPS, launches)
        check(all(np.isfinite(losses)), "%s losses not finite", name)
        check(losses[-1] < losses[0], "%s loss did not fall: %r", name,
              losses)
    launches = runs["packed"][2]
    for key, n in launches.items():
        check(n == N_LAYER * TRAIN_STEPS, "flash %s launches %d != "
              "n_layer x steps = %d", key, n, N_LAYER * TRAIN_STEPS)
    check(not any(runs["unpacked"][2].values()),
          "the unpacked program launched a flash kernel")

    parity_phase(torch, fluid, T, exe, packed, unpacked, init, batches)
    train_profile(torch, fluid, exe, packed, init, batches)
    return {"flash_fwd": launches["fwd"],
            "flash_bwd_dq": launches["bwd_dq"],
            "flash_bwd_dkv": launches["bwd_dkv"]}


ADAM_NORM_TOL = 5e-4


@contextlib.contextmanager
def _patched(module, name, wrap):
    """``module.name`` replaced by ``wrap(original)`` for the block."""
    real = getattr(module, name)
    setattr(module, name, wrap(real))
    try:
        yield
    finally:
        setattr(module, name, real)


def _plain_route(real):
    return lambda q, scale: (False, real(q, scale)[1])


def _zero_dk(real):
    def faulted(*args):
        dk, dv = real(*args)
        return dk.zero_(), dv
    return faulted


def _apart(wp, wu):
    """(largest |diff| / max(1, max|w|) per tensor, its tensor, norm of
    the whole difference over the weights' norm)."""
    graft = {n: float(np.abs(wp[n] - wu[n]).max()) /
             max(1.0, float(np.abs(wu[n]).max())) for n in wp}
    worst = max(graft, key=graft.get)
    norm = float(np.sqrt(sum(float(np.sum((wp[n] - wu[n]) ** 2))
                             for n in wp)) /
                 np.sqrt(sum(float(np.sum(wu[n] ** 2)) for n in wp)))
    return graft[worst], worst, norm


def parity_phase(torch, fluid, T, exe, packed, unpacked, init, batches):
    """From one startup scope copied twice, PARITY_STEPS steps packed
    (the flash kernels) and unpacked (composed matmul/softmax, no
    kernel). The two forms differ only in rounding, but a ReLU input
    within rounding of 0 switches a unit on in one form and off in the
    other, which moves that unit's gradient column by one token's share.
    SGD carries such a difference into the weights at its size, so the
    SGD run is held to the reference's multi-step bound: 2e-4 of
    max(1, max|w|) per tensor (__graft_entry__.py:154). Adam divides
    every update by its gradient's own magnitude, so a weight whose
    gradient is within rounding of zero can step +lr in one form and -lr
    in the other: the Adam run is held in losses (rtol 1e-4) and in the
    norm of the whole weight difference over the weights' norm
    (ADAM_NORM_TOL), the per-tensor figure printed. Two controls at the
    same width place that limit: the packed form with its attention
    routed to the plain version (the two forms' own rounding noise, no
    kernel), and the packed form with the dK/dV kernel's dK zeroed (a
    wrong backward), which must land above the limit."""
    sgd = (_lm_program(fluid, T, True, "sgd"),
           _lm_program(fluid, T, False, "sgd"))
    scope = fluid.Scope()
    exe.run(sgd[0][1], scope=scope)
    sgd_init = {n: scope.get_numpy(n) for n in scope.local_var_names()
                if scope.find_var(n) is not None}

    def run(prog, start):
        losses, _, sc = _train(torch, fluid, exe, prog, start, batches,
                               PARITY_STEPS)
        return losses, {n: sc.get_numpy(n) for n in start}

    (lp, wp), (lu, wu) = run(sgd[0], sgd_init), run(sgd[1], sgd_init)
    for i, (a, b) in enumerate(zip(lp, lu)):
        check(abs(a - b) <= 1e-4 * abs(b), "sgd step %d loss packed %r vs "
              "unpacked %r", i + 1, a, b)
    graft, worst, norm = _apart(wp, wu)
    check(graft <= 2e-4, "sgd weights diverge after %d steps: %s %g",
          PARITY_STEPS, worst, graft)
    log("train parity (sgd, %d steps): losses packed %s vs unpacked %s; "
        "weights: largest |diff| / max(1, max|w|) %.3g (%s), relative "
        "norm of the whole difference %.3g", PARITY_STEPS,
        ["%.6f" % x for x in lp], ["%.6f" % x for x in lu], graft, worst,
        norm)
    _adam_parity(torch, fluid, exe, packed, unpacked, init, batches,
                 "train")


def _adam_parity(torch, fluid, exe, packed, unpacked, init, batches,
                 what):
    """PARITY_STEPS Adam steps of ``packed`` (the flash kernels) against
    ``unpacked`` (composed) from one startup scope: losses at rtol 1e-4
    and the relative norm of the whole weight difference within
    ADAM_NORM_TOL; then the two controls that place that limit (see
    ``parity_phase``): plain attention, and dK zeroed, which must land
    above it."""
    from paddle_tpu_torch.ops import flash_attention as F

    def run(prog):
        losses, _, sc = _train(torch, fluid, exe, prog, init, batches,
                               PARITY_STEPS)
        return losses, {n: sc.get_numpy(n) for n in init}

    (lp, wp), (lu, wu) = run(packed), run(unpacked)
    for i, (a, b) in enumerate(zip(lp, lu)):
        check(abs(a - b) <= 1e-4 * abs(b), "%s: adam step %d loss packed "
              "%r vs unpacked %r", what, i + 1, a, b)
    graft, worst, norm = _apart(wp, wu)
    check(norm <= ADAM_NORM_TOL, "%s: adam weights diverge after %d "
          "steps: relative norm %g", what, PARITY_STEPS, norm)
    log("%s parity (adam, %d steps): losses packed %s vs unpacked %s; "
        "weights: largest |diff| / max(1, max|w|) %.3g (%s), relative "
        "norm of the whole difference %.3g", what, PARITY_STEPS,
        ["%.6f" % x for x in lp], ["%.6f" % x for x in lu], graft, worst,
        norm)
    controls = {}
    for name, attr, wrap in (("plain attention", "_route", _plain_route),
                             ("dK zeroed", "_bwd_dkv_cuda", _zero_dk)):
        with _patched(F, attr, wrap):
            lc, wc = run(packed)
        graft, worst, norm = _apart(wc, wu)
        controls[name] = norm
        log("%s parity control (adam, packed with %s vs unpacked): "
            "losses %s; largest |diff| / max(1, max|w|) %.3g (%s), relative "
            "norm %.3g (limit %g)", what, name, ["%.6f" % x for x in lc],
            graft, worst, norm, ADAM_NORM_TOL)
    check(controls["dK zeroed"] > ADAM_NORM_TOL, "%s: the Adam parity limit "
          "%g does not catch a zeroed dK (relative norm %g)", what,
          ADAM_NORM_TOL, controls["dK zeroed"])


def train_profile(torch, fluid, exe, prog, init, batches,
                  title="train profile (traced, 3 steps)"):
    """A separate traced pass of 3 training steps of ``prog`` (after one
    warm step): device busy share of the wall time and the kernels that
    take the most of it."""
    from torch.profiler import ProfilerActivity, profile
    main, _, avg_cost = prog
    scope = fluid.Scope()
    fluid.load_numpy_state(scope, init, exe.device)
    exe.run(main, feed=batches[0], fetch_list=[avg_cost], scope=scope)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(3):
            exe.run(main, feed=batches[i % 2], fetch_list=[avg_cost],
                    scope=scope)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _report_profile(prof, wall, title)


# -- phase 7 -------------------------------------------------------------
# ResNet-50 as benchmarks/resnet.py trains it: ImageNet 224x224, batch 32
RESNET_BATCH, RESNET_IMAGE, RESNET_CLASSES = 32, 224, 1000
RESNET_FUSED_PER_STEP = 36     # 1x1 convs feeding a train BN, of 53 convs
MM_STAT_TOL = 1e-5             # of sum|y - c| and sum (y - c)^2 per column
MM_RAGGED = [(1000, 72, 200), (1000, 67, 131), (97, 2048, 64), (5, 3, 1)]


def _resnet_program(fluid, R):
    """The ResNet-50 training Program and the (M, K, N) of each 1x1 conv
    that feeds a train-mode batch norm, in program order (the fused
    route's matmul_stats launches of one step)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        _, _, avg_cost, _ = R.build_train_net(
            model="resnet_imagenet", depth=50,
            image_shape=(3, RESNET_IMAGE, RESNET_IMAGE),
            num_classes=RESNET_CLASSES)
    block = main.global_block()
    bn_in = {op.input("X")[0] for op in block.ops
             if op.type == "batch_norm" and not op.attr("is_test", False)}
    shapes = []
    for op in block.ops:
        if op.type != "conv2d":
            continue
        co, ci, kh, kw = block.vars[op.input("Filter")[0]].shape
        out = op.output("Output")[0]
        if (kh, kw) == (1, 1) and out in bn_in:
            _, _, ho, wo = block.vars[out].shape
            shapes.append((RESNET_BATCH * ho * wo, ci, co))
    return (main, startup, avg_cost), shapes


def _mm_inputs(torch, m, k, n, dtype, seed):
    """x [M, K], w [K, N] as the transpose of an [N, K] filter (the conv
    route's layout), c [N] f32; drawn on the card from a seeded
    generator."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(m, k, generator=g, device="cuda")
    w_nk = torch.randn(n, k, generator=g, device="cuda") * k ** -0.5
    c = 0.1 * torch.randn(n, generator=g, device="cuda")
    return x.to(dtype), w_nk.to(dtype), c


def _mm_case(torch, MS, m, k, n, dtype, seed, grads):
    """Kernel against plain version on one shape; returns the largest
    absolute error of y, s1, s2 (and dx, dw)."""
    x, w_nk, c = _mm_inputs(torch, m, k, n, dtype, seed)
    got = MS.matmul_colstats(x, w_nk.t(), c)
    ref = MS._dense_matmul_stats(x, w_nk.t(), c)
    torch.cuda.synchronize()
    yc = ref[0].float() - c[None, :]
    rtol = RTOL if dtype == torch.float32 else BF16_RTOL
    err = {}
    y_err = (got[0].float() - ref[0].float()).abs()
    err["y"] = float(y_err.max())
    check(bool(torch.isfinite(got[0]).all()) and not bool(
        (y_err > ATOL + rtol * ref[0].float().abs()).any()),
        "matmul_stats y disagrees with the plain version: %s M=%d K=%d "
        "N=%d max_abs_err=%g", dtype, m, k, n, err["y"])
    for name, g, r, scale in (("s1", got[1], ref[1], yc.abs().sum(0)),
                              ("s2", got[2], ref[2], (yc * yc).sum(0))):
        e = (g - r).abs()
        err[name] = float(e.max())
        err[name + "_rel"] = float((e / scale.clamp_min(1e-30)).max())
        check(bool(torch.isfinite(g).all()) and not bool(
            (e > MM_STAT_TOL * scale + RTOL * r.abs()).any()),
            "matmul_stats %s disagrees with the plain version: %s M=%d K=%d "
            "N=%d max_abs_err=%g (%.3g of the sum of magnitudes)", name,
            dtype, m, k, n, err[name], err[name + "_rel"])
    if not grads:
        return err
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    gy = torch.randn(m, n, generator=gen, device="cuda")
    g1 = torch.randn(n, generator=gen, device="cuda")
    g2 = torch.randn(n, generator=gen, device="cuda") / m
    results = []
    for fn in (MS.matmul_colstats, MS._dense_matmul_stats):
        xl = x.detach().requires_grad_(True)
        wl = w_nk.detach().requires_grad_(True)
        y, s1, s2 = fn(xl, wl.t(), c)
        loss = (y * gy).sum() + (s1 * g1).sum() + (s2 * g2).sum()
        results.append(torch.autograd.grad(loss, [xl, wl]))
    torch.cuda.synchronize()
    for name, g, r in zip(("dx", "dw"), *results):
        scale = float(r.abs().max().clamp_min(1e-30))
        e = (g - r).abs()
        err[name] = float(e.max())
        check(bool(torch.isfinite(g).all()) and not bool(
            (e > ATOL * scale + RTOL * r.abs()).any()),
            "matmul_stats %s disagrees with the plain autograd: M=%d K=%d "
            "N=%d max_abs_err=%g (largest %g)", name, m, k, n, err[name],
            scale)
    return err


def mm_kernel_phase(torch, shapes):
    """The 15 ResNet-50 shapes and the ragged ones, fp32 with gradients
    and bf16; returns the largest fp32 absolute error over y, s1, s2."""
    from paddle_tpu_torch.ops import matmul_stats as MS
    distinct = sorted(set(shapes), reverse=True)
    worst = 0.0
    cases = [(s, torch.float32) for s in distinct + MM_RAGGED] + \
        [(s, torch.bfloat16) for s in distinct[::3] + MM_RAGGED[:2]]
    for i, ((m, k, n), dtype) in enumerate(cases):
        fp32 = dtype == torch.float32
        e = _mm_case(torch, MS, m, k, n, dtype, seed=i, grads=fp32)
        if fp32:
            worst = max(worst, e["y"], e["s1"], e["s2"])
        log("mm: %-8s M=%-6d K=%-4d N=%-4d max_abs_err y %.2e s1 %.2e s2 "
            "%.2e (of the sums of magnitudes: %.1e, %.1e)%s  ok",
            str(dtype).replace("torch.", ""), m, k, n, e["y"], e["s1"],
            e["s2"], e["s1_rel"], e["s2_rel"],
            " dx %.2e dw %.2e" % (e["dx"], e["dw"]) if fp32 else "")
    log("mm: %d cases ok (%d fp32 with gradients, %d bf16); largest fp32 "
        "abs error over y, s1, s2 %.3g", len(cases),
        len(distinct) + len(MM_RAGGED),
        len(cases) - len(distinct) - len(MM_RAGGED), worst)
    mm_repeat_checks(torch, MS, shapes)
    return worst


def _mm_work(m, k, n, itemsize=4):
    """(operations, bytes) of one launch: the product's 2MKN plus the
    statistics' 4MN (subtract, add, multiply, add); x, w and y in their
    dtype, c, s1, s2 in f32, each read or written once."""
    return (2 * m * k * n + 4 * m * n,
            itemsize * (m * k + k * n + m * n) + 4 * 3 * n)


def mm_repeat_checks(torch, MS, shapes):
    """Two launches on the same inputs give bitwise-equal y, s1 and s2
    (fixed summation orders, no atomics): at the step's largest shape and
    at the narrowest grid's (M=1,568 K=2,048 N=512: 52 blocks of
    128 x 128)."""
    largest = max(set(shapes), key=lambda s: _mm_work(*s)[0])
    for m, k, n in (largest, (1568, 2048, 512)):
        x, w_nk, c = _mm_inputs(torch, m, k, n, torch.float32, seed=3)
        a = MS._fwd_cuda(x, w_nk.t(), c)
        b = MS._fwd_cuda(x, w_nk.t(), c)
        torch.cuda.synchronize()
        same = [torch.equal(u, v) for u, v in zip(a, b)]
        check(all(same), "matmul_stats not bitwise repeatable (M=%d K=%d "
              "N=%d): y, s1, s2 equal %s", m, k, n, same)
        log("mm: M=%d K=%d N=%d fp32: two launches bitwise equal (y, s1, "
            "s2)  ok", m, k, n)


def mm_timing_phase(torch, shapes):
    """Each distinct shape, fp32: the kernel, the plain version, the
    product alone in torch.matmul and the composed route, CUDA-event
    timed per call; then the sum over one step's launches. Each shape's
    tile must give every SM a block, or the shape must be bound by bytes
    at that tile."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import matmul_stats as MS
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    counts = {}
    for s in shapes:
        counts[s] = counts.get(s, 0) + 1
    step = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
            "composed_ms": 0.0, "bound_ms": 0.0, "ops_ms": 0.0,
            "bytes_ms": 0.0, "simt_ms": 0.0, "ms_with_host_gaps": 0.0,
            "library_ms_with_host_gaps": 0.0}
    largest = max(counts, key=lambda s: _mm_work(*s)[0])
    per_shape = {}
    for m, k, n in sorted(counts, reverse=True):
        x, w_nk, c = _mm_inputs(torch, m, k, n, torch.float32, seed=m + n)
        w = w_nk.t()
        hw = m // RESNET_BATCH
        side = int(round(hw ** 0.5))
        x4 = x.reshape(RESNET_BATCH, side, side, k).permute(
            0, 3, 1, 2).contiguous()
        w4 = w_nk.reshape(n, k, 1, 1)

        def composed(i):
            y = F.conv2d(x4, w4)
            yc = y - c.reshape(1, -1, 1, 1)
            return yc.sum(dim=(0, 2, 3)), (yc * yc).sum(dim=(0, 2, 3))

        def kernel(i):
            MS._fwd_cuda(x, w, c)

        def library(i):
            torch.matmul(x, w)

        # device time alone (a sleep kernel hides the host's enqueue), and
        # the kernel and torch.matmul also with the host's gaps
        t = {"ms": _events_ms(torch, kernel, 20, hide_host=True),
             "plain_ms": _events_ms(
                 torch, lambda i: MS._dense_matmul_stats(x, w, c), 10,
                 hide_host=True),
             "library_ms": _events_ms(torch, library, 20, hide_host=True),
             "composed_ms": _events_ms(torch, composed, 10, hide_host=True),
             "ms_with_host_gaps": _events_ms(torch, kernel, 20),
             "library_ms_with_host_gaps": _events_ms(torch, library, 20)}
        # the products run on the TF32 tensor cores (3xTF32: the
        # emulation's 3 MMAs are not counted as work)
        flops, nbytes = _mm_work(m, k, n)
        ops_ms = flops / TF32_FLOPS * 1e3
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        t["bound_ms"] = max(ops_ms, bytes_ms)
        t["bound_by"] = "operations" if ops_ms >= bytes_ms else "bytes"
        bm, bn, blocks = MS._tile(m, n)
        check(blocks >= sms or t["bound_by"] == "bytes", "matmul_stats "
              "M=%d N=%d: %d blocks of %dx%d for %d SMs, and not bound by "
              "bytes", m, n, blocks, bm, bn, sms)
        per_shape[(m, k, n)] = t
        for key in ("ms", "plain_ms", "library_ms", "composed_ms",
                    "bound_ms", "ms_with_host_gaps",
                    "library_ms_with_host_gaps"):
            step[key] += counts[(m, k, n)] * t[key]
        step["ops_ms"] += counts[(m, k, n)] * ops_ms
        step["bytes_ms"] += counts[(m, k, n)] * bytes_ms
        step["simt_ms"] += counts[(m, k, n)] * flops / FP32_FLOPS * 1e3
        log("timing mm M=%-6d K=%-4d N=%-4d x%d per step, device time "
            "alone: kernel_ms=%.5f bound_ms=%.5f (%s: %d flops, %d bytes; "
            "fp32-SIMT operations bound %.5f) plain_ms=%.5f library_ms=%.5f "
            "(product only) composed_ms=%.5f; with the host's gaps: "
            "kernel_ms=%.5f library_ms=%.5f; tile %dx%d, %d blocks for %d "
            "SMs", m, k, n, counts[(m, k, n)], t["ms"], t["bound_ms"],
            t["bound_by"], flops, nbytes, flops / FP32_FLOPS * 1e3,
            t["plain_ms"], t["library_ms"], t["composed_ms"],
            t["ms_with_host_gaps"], t["library_ms_with_host_gaps"], bm, bn,
            blocks, sms)
    log("timing mm, summed over the %d launches of one step, device time "
        "alone: kernel_ms=%.4f bound_ms=%.4f (TF32 operations %.4f, bytes "
        "%.4f; fp32-SIMT operations %.4f) plain_ms=%.4f "
        "library_ms=%.4f (torch.matmul, product only) composed_ms=%.4f "
        "(cuDNN 1x1 conv + BN statistics pass); kernel / library %.3f; "
        "with the host's gaps: kernel_ms=%.4f library_ms=%.4f, kernel / "
        "library %.3f; largest shape M=%d K=%d N=%d:"
        " kernel_ms=%.5f bound_ms=%.5f plain_ms=%.5f library_ms=%.5f",
        len(shapes), step["ms"], step["bound_ms"], step["ops_ms"],
        step["bytes_ms"], step["simt_ms"], step["plain_ms"], step["library_ms"],
        step["composed_ms"], step["ms"] / step["library_ms"],
        step["ms_with_host_gaps"], step["library_ms_with_host_gaps"],
        step["ms_with_host_gaps"] / step["library_ms_with_host_gaps"],
        *largest, per_shape[largest]["ms"],
        per_shape[largest]["bound_ms"], per_shape[largest]["plain_ms"],
        per_shape[largest]["library_ms"])
    return {"ms": step["ms"], "plain_ms": step["plain_ms"],
            "library_ms": step["library_ms"], "bound_ms": step["bound_ms"],
            "bound_by": "operations" if step["ops_ms"] >= step["bytes_ms"]
            else "bytes", "ms_with_host_gaps": step["ms_with_host_gaps"],
            "library_ms_with_host_gaps": step["library_ms_with_host_gaps"]}


# -- phase 8 -------------------------------------------------------------
def _resnet_batches():
    return [{"data": np.random.RandomState(seed).rand(
                RESNET_BATCH, 3, RESNET_IMAGE, RESNET_IMAGE).astype(
                    np.float32),
             "label": np.random.RandomState(seed + 100).randint(
                 0, RESNET_CLASSES, (RESNET_BATCH, 1)).astype(np.int64)}
            for seed in (0, 1)]


@contextlib.contextmanager
def _fuse(flags, on):
    flags.set_flag("fuse_conv_bn", on)
    try:
        yield
    finally:
        flags.set_flag("fuse_conv_bn", None)


def resnet_phase(torch, prog, shapes):
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.ops import matmul_stats as MS
    check(len(shapes) == RESNET_FUSED_PER_STEP and len(set(shapes)) == 15,
          "ResNet-50 has %d fusable 1x1 convs (%d shapes), expected %d (15)",
          len(shapes), len(set(shapes)), RESNET_FUSED_PER_STEP)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    check(exe.device.type == "cuda", "the executor is not on the card")
    scope0 = fluid.Scope()
    exe.run(prog[1], scope=scope0)
    init = {n: scope0.get_numpy(n) for n in scope0.local_var_names()
            if scope0.find_var(n) is not None}
    batches = _resnet_batches()
    runs = {}
    for name, on in (("fused", True), ("flag off", False)):
        with _fuse(flags, on):
            MS.matmul_colstats.launches = 0
            losses, wall, _ = _train(torch, fluid, exe, prog, init, batches,
                                     TRAIN_STEPS)
            launches = MS.matmul_colstats.launches
        runs[name] = (losses, wall, launches)
        log("resnet50 (%s): %d steps, losses %s; %.1f images/s, mean step "
            "%.3f ms (steps 2..%d); matmul_stats launches %d", name,
            TRAIN_STEPS, " ".join("%.4f" % x for x in losses),
            RESNET_BATCH * (TRAIN_STEPS - 1) / wall,
            1e3 * wall / (TRAIN_STEPS - 1), TRAIN_STEPS, launches)
        check(all(np.isfinite(losses)), "%s losses not finite", name)
        check(losses[-1] < losses[0], "%s loss did not fall: %r", name,
              losses)
    check(runs["fused"][2] == RESNET_FUSED_PER_STEP * TRAIN_STEPS,
          "matmul_stats launches %d != %d per step x %d steps",
          runs["fused"][2], RESNET_FUSED_PER_STEP, TRAIN_STEPS)
    check(runs["flag off"][2] == 0, "the flag-off run launched the kernel")
    resnet_parity_phase(torch, fluid, flags, exe, prog, init, batches)
    for name, on in (("fused", True), ("flag off", False)):
        with _fuse(flags, on):
            train_profile(torch, fluid, exe, prog, init, batches,
                          "resnet50 profile (traced, 3 %s steps)" % name)
    return runs["fused"][2]


# the fused route against the flag-off route after PARITY_STEPS Momentum
# steps (see resnet_parity_phase): the largest |diff| / max(1, max|w|)
# over the weights and BN running statistics, per tensor; and a sanity
# bound on the losses of steps 2.. (step 1, before any update, is held
# at rtol 1e-4)
RESNET_PARITY_TOL = 0.2
RESNET_LATER_LOSS_RTOL = 2e-2


def _drop_ds2(real):
    def faulted(x, w, c, y, dy, ds1, ds2):
        return real(x, w, c, y, dy, ds1, ds2.new_zeros(ds2.shape))
    return faulted


def resnet_parity_phase(torch, fluid, flags, exe, prog, init, batches):
    """From one startup scope copied twice, PARITY_STEPS Momentum steps
    fused (the kernel) and flag-off (cuDNN conv, BN's own statistics
    pass). The step-1 losses (same weights: forward rounding only) agree
    at rtol 1e-4. After an update the two routes part by more than
    rounding: at this width ResNet-50's first gradients amplify rounding
    differences in the forward to ~10% in some tensors (the JAX package's
    own fused and composed routes part alike on the CPU), and cuDNN's
    backward is not repeatable run to run. So the weights and BN running
    statistics (the block's parameters) are held to RESNET_PARITY_TOL, a
    limit that controls at full width place in the same run: the
    flag-off route run again, and the fused route with the kernel
    replaced by its plain version (the routes' own noise, no kernel),
    must stay within it; the fused route with the 2 (Y - c) ds2 term
    dropped from the backward (a wrong gradient through the variance)
    must exceed it. The later losses cannot tell that fault from noise
    (its losses land as near flag-off's as the sound run's), so they are
    held only to the sanity bound RESNET_LATER_LOSS_RTOL."""
    from paddle_tpu_torch.ops import matmul_stats as MS
    names = [p.name for p in prog[0].global_block().all_parameters()]

    def run(on):
        with _fuse(flags, on):
            losses, _, sc = _train(torch, fluid, exe, prog, init, batches,
                                   PARITY_STEPS)
        return losses, {n: sc.get_numpy(n) for n in names}

    lf, wf = run(True)
    lo, wo = run(False)
    sound = _apart(wf, wo)
    la, wa = run(False)
    again = _apart(wa, wo)
    log("resnet50 parity noise (flag off run again vs flag off): losses %s;"
        " largest |diff| / max(1, max|w|) %.3g (%s), relative norm %.3g",
        ["%.6f" % x for x in la], *again)
    log("resnet50 parity (%d steps): losses fused %s vs flag off %s; "
        "weights and BN running stats: largest |diff| / max(1, max|w|) "
        "%.3g (%s), relative norm %.3g (limit %g)", PARITY_STEPS,
        ["%.6f" % x for x in lf], ["%.6f" % x for x in lo], sound[0],
        sound[1], sound[2], RESNET_PARITY_TOL)
    controls = {}
    for name, attr, wrap in (
            ("plain version", "_fwd_cuda",
             lambda real: MS._dense_matmul_stats),
            ("ds2 term dropped", "_mmstats_bwd", _drop_ds2)):
        with _patched(MS, attr, wrap):
            lc, wc = run(True)
        controls[name] = _apart(wc, wo) + (wc, lc)
        log("resnet50 parity control (fused with %s vs flag off): losses "
            "%s; largest |diff| / max(1, max|w|) %.3g (%s), relative norm "
            "%.3g (limit %g)", name, ["%.6f" % x for x in lc],
            controls[name][0], controls[name][1], controls[name][2],
            RESNET_PARITY_TOL)
    log("resnet50 parity: kernel vs its plain version on the fused route: "
        "largest |diff| / max(1, max|w|) %.3g (%s), relative norm %.3g",
        *_apart(wf, controls["plain version"][3]))
    for i, (a, b) in enumerate(zip(lf, lo)):
        rtol = 1e-4 if i == 0 else RESNET_LATER_LOSS_RTOL
        check(abs(a - b) <= rtol * abs(b), "resnet50 step %d loss fused %r "
              "vs flag off %r (rtol %g)", i + 1, a, b, rtol)
        check(abs(controls["plain version"][4][i] - b) <= rtol * abs(b),
              "resnet50 step %d loss of the plain-version control %r vs "
              "flag off %r (rtol %g)", i + 1,
              controls["plain version"][4][i], b, rtol)
    check(again[0] <= RESNET_PARITY_TOL, "the flag-off route's own run-to-"
          "run noise %g exceeds the limit %g", again[0], RESNET_PARITY_TOL)
    check(sound[0] <= RESNET_PARITY_TOL, "resnet50 weights diverge after "
          "%d steps: %s %g", PARITY_STEPS, sound[1], sound[0])
    check(controls["plain version"][0] <= RESNET_PARITY_TOL,
          "the routes' own noise %g exceeds the limit %g",
          controls["plain version"][0], RESNET_PARITY_TOL)
    check(controls["ds2 term dropped"][0] > RESNET_PARITY_TOL,
          "the parity limit %g does not catch a dropped ds2 term (%g)",
          RESNET_PARITY_TOL, controls["ds2 term dropped"][0])


# -- phase 9 -------------------------------------------------------------
# megastep: K steps as one CUDA graph (Executor.run_steps,
# Engine(megastep=K)) against the eager steps, on the full-width paths
MEGA_TRAIN_K, MEGA_TRAIN_STEPS, MEGA_SERVE_K, MEGA_PAIRS = 5, 10, 8, 2


def _reset_launches():
    from paddle_tpu_torch.ops import dropout as D
    from paddle_tpu_torch.ops import flash_attention as F
    from paddle_tpu_torch.ops import lstm_cell as LC
    from paddle_tpu_torch.ops import matmul_stats as MS
    from paddle_tpu_torch.ops import paged_attention as P
    for key in F.flash_attention.launches:
        F.flash_attention.launches[key] = 0
    MS.matmul_colstats.launches = 0
    P.paged_attention.launches = 0
    D.dropout.launches = 0
    LC.lstm_scan.launches = 0


def _launches():
    from paddle_tpu_torch.core.graphs import launch_counts
    return launch_counts()


def _scope_from(fluid, init, device):
    scope = fluid.Scope()
    fluid.load_numpy_state(scope, init, device)
    return scope


def _eager_steps(torch, exe, main, avg_cost, scope, batches):
    losses = [exe.run(main, feed=b, fetch_list=[avg_cost], scope=scope)[0]
              for b in batches]
    torch.cuda.synchronize()
    return losses


def _graph_steps(torch, exe, main, avg_cost, scope, batches):
    losses = []
    for i in range(0, len(batches), MEGA_TRAIN_K):
        out = exe.run_steps(main, feeds=batches[i:i + MEGA_TRAIN_K],
                            fetch_list=[avg_cost], scope=scope)
        losses += [o[0] for o in out]
    torch.cuda.synchronize()
    return losses


def _first_mismatch(torch, fluid, exe, prog, init, batch):
    """The first op, in program order, whose output differs between one
    eager step and one captured step (K=1) from the same state: every
    lowered op's outputs are copied as it runs (under capture, into the
    graph's memory, so a replay fills them). The autograd backward runs
    inside one call, so a difference born there shows first at an
    optimizer op."""
    from paddle_tpu_torch.core import executor as E
    main, _, avg_cost = prog
    records = []
    real = E._lower_op

    def recording(ctx, op):
        real(ctx, op)
        for names in op.outputs.values():
            for n in names:
                v = ctx.env.get(n)
                if isinstance(v, torch.Tensor):
                    records.append((op.type, n, v.detach().clone()))

    E._lower_op = recording
    try:
        exe.run(main, feed=batch, fetch_list=[avg_cost],
                scope=_scope_from(fluid, init, exe.device))
        eager = list(records)
        del records[:]
        exe.run_steps(main, feeds=[batch], fetch_list=[avg_cost],
                      scope=_scope_from(fluid, init, exe.device),
                      use_program_cache=False)
        graph = records[-len(eager):]
    finally:
        E._lower_op = real
    torch.cuda.synchronize()
    for (op_type, name, a), (_, _, b) in zip(eager, graph):
        if not torch.equal(a, b):
            diff = (a.double() - b.double()).abs().max().item() \
                if a.is_floating_point() else float("nan")
            return "%s (output %s, largest |diff| %.3g)" % (op_type, name,
                                                            diff)
    return "none of the %d op outputs (the difference is in the state " \
        "update)" % len(eager)


def _mega_compare(torch, fluid, exe, prog, init, batches, what, limit,
                  apart):
    """MEGA_TRAIN_STEPS run() steps against MEGA_TRAIN_STEPS / K
    run_steps(K) dispatches over the same batches, each from its own copy
    of ``init``; the graph was captured before (a warm call on a third
    copy), so the counted run only replays. Losses and weights must be
    bitwise equal; where they are not, the first differing op is named
    and the weights are held to ``limit`` by ``apart`` (the limit the
    existing controls place). Returns (the graph run's launch counts,
    bitwise)."""
    main, _, avg_cost = prog
    names = sorted(init)
    sa = _scope_from(fluid, init, exe.device)
    le = _eager_steps(torch, exe, main, avg_cost, sa, batches)
    sb = _scope_from(fluid, init, exe.device)
    _reset_launches()
    replays = exe.stats["graph_replays"]
    lg = _graph_steps(torch, exe, main, avg_cost, sb, batches)
    counts = _launches()
    check(exe.stats["graph_replays"] - replays
          == MEGA_TRAIN_STEPS // MEGA_TRAIN_K, "%s: %d replays for %d "
          "dispatches", what, exe.stats["graph_replays"] - replays,
          MEGA_TRAIN_STEPS // MEGA_TRAIN_K)
    we = {n: sa.get_numpy(n) for n in names}
    wg = {n: sb.get_numpy(n) for n in names}
    check(all(np.isfinite(lg)), "%s: graph losses not finite", what)
    same_loss = all(np.array_equal(a, b) for a, b in zip(le, lg))
    differ = [n for n in names if not np.array_equal(we[n], wg[n])]
    log("%s: %d run() steps vs %d run_steps(K=%d) dispatches: losses %s; "
        "graph losses %s; %s", what, MEGA_TRAIN_STEPS,
        MEGA_TRAIN_STEPS // MEGA_TRAIN_K, MEGA_TRAIN_K,
        " ".join("%.6f" % float(x) for x in le),
        "bitwise equal" if same_loss else
        " ".join("%.6f" % float(x) for x in lg),
        "every one of %d state tensors bitwise equal" % len(names)
        if not differ else "%d of %d state tensors differ (first %s)"
        % (len(differ), len(names), differ[0]))
    if same_loss and not differ:
        return counts, True
    op = _first_mismatch(torch, fluid, exe, prog, init, batches[0])
    value, worst = apart(wg, we)
    log("%s: NOT bitwise; first differing op: %s; weights apart %.3g "
        "(%s), limit %g", what, op, value, worst, limit)
    check(value <= limit, "%s: graph weights %g apart from eager (limit "
          "%g; first differing op %s)", what, value, op, limit)
    for i, (a, b) in enumerate(zip(le, lg)):
        check(abs(float(a) - float(b)) <= 1e-4 * abs(float(b)),
              "%s step %d loss eager %r vs graph %r", what, i + 1, a, b)
    return counts, False


def _capture_warm(torch, fluid, exe, prog, init, batches, what):
    """A warm call on a scratch copy of ``init``: captures the K-step
    graph, so that the counted and timed runs only replay."""
    main, _, avg_cost = prog
    captures = exe.stats["graph_captures"]
    t0 = time.perf_counter()
    exe.run_steps(main, feeds=batches[:MEGA_TRAIN_K], fetch_list=[avg_cost],
                  scope=_scope_from(fluid, init, exe.device))
    torch.cuda.synchronize()
    check(exe.stats["graph_captures"] == captures + 1,
          "%s: the warm call captured no graph", what)
    log("%s: K=%d graph captured (warm-up step, capture, first replay) in "
        "%.3f s", what, MEGA_TRAIN_K, time.perf_counter() - t0)


def _median(xs):
    return float(np.median(xs))


def _timed_train(torch, exe, prog, scope, batches, graph):
    main, _, avg_cost = prog
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (_graph_steps if graph else _eager_steps)(torch, exe, main, avg_cost,
                                              scope, batches)
    return time.perf_counter() - t0


@contextlib.contextmanager
def _gc_pauses():
    """Seconds the host spent in Python's garbage collector inside the
    block, in ``out[0]``."""
    import gc
    out, began = [0.0], [0.0]

    def watch(phase, _info):
        if phase == "start":
            began[0] = time.perf_counter()
        else:
            out[0] += time.perf_counter() - began[0]

    gc.callbacks.append(watch)
    try:
        yield out
    finally:
        gc.callbacks.remove(watch)


def _interleaved_train(torch, fluid, exe, prog, init, batches, what,
                       unit, per_step, smi, warm=False):
    """Eager and graph steps in A/B/A/B order, MEGA_PAIRS pairs (the host
    varies from run to run), each over the MEGA_TRAIN_STEPS batches on a
    scope of its own; then one traced pass of each. With ``warm``, one
    untimed window on each scope first (the graph bound to its scope).
    Logs each timed window's graph captures and garbage-collector pauses.
    Returns the medians and busy shares."""
    scopes = {g: _scope_from(fluid, init, exe.device) for g in (0, 1)}
    if warm:
        for g in (0, 1):
            _timed_train(torch, exe, prog, scopes[g], batches, g)
    walls = {0: [], 1: []}
    captures, pauses = {0: [], 1: []}, {0: [], 1: []}
    for _ in range(MEGA_PAIRS):
        for g in (0, 1):
            before = exe.stats["graph_captures"]
            with _gc_pauses() as gc_s:
                walls[g].append(_timed_train(torch, exe, prog, scopes[g],
                                             batches, g))
            captures[g].append(exe.stats["graph_captures"] - before)
            pauses[g].append(gc_s[0])
    busy = {}
    for g in (0, 1):
        _timed_train(torch, exe, prog, scopes[g], batches[:MEGA_TRAIN_K], g)
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            wall = _timed_train(torch, exe, prog, scopes[g],
                                batches[:MEGA_TRAIN_K], g)
            torch.cuda.synchronize()
        busy[g] = _report_profile(
            prof, wall, "%s profile (traced, %d %s steps)" % (
                what, MEGA_TRAIN_K, "graph" if g else "eager"))[0]
    n = len(batches)
    out = {}
    for g, name in ((0, "eager"), (1, "graph")):
        ms = [1e3 * w / n for w in walls[g]]
        rate = [per_step * n / w for w in walls[g]]
        out[name] = (_median(ms), _median(rate), busy[g])
        log("%s timing (%s, %d pairs interleaved eager/graph%s): step ms "
            "%s (median %.3f); %s %s (median %.1f); device busy %s; graph "
            "captures in each window %s, garbage-collector pauses s %s; %s",
            what, name, MEGA_PAIRS, ", a warm window on each scope first"
            if warm else "", " ".join("%.3f" % x for x in ms), out[name][0],
            unit, " ".join("%.1f" % x for x in rate), out[name][1],
            "not measured" if busy[g] is None else "%.1f%%" % (100 * busy[g]),
            captures[g], " ".join("%.4f" % x for x in pauses[g]), smi)
    log("%s timing: graph / eager step ms (medians) %.3f; %s", what,
        out["graph"][0] / out["eager"][0], smi)
    return out


def mega_train_lm_phase(torch, smi):
    """The packed LM with Adam(1e-3) at full width: 10 run() steps vs 2
    run_steps(K=5) dispatches over the same 10 batches; flash launches
    exactly n_layer per logical step, each kernel, through replays."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import transformer as T
    exe = fluid.Executor(fluid.CUDAPlace(0))
    prog = _lm_program(fluid, T, True)
    scope0 = fluid.Scope()
    exe.run(prog[1], scope=scope0)
    init = {n: scope0.get_numpy(n) for n in scope0.local_var_names()
            if scope0.find_var(n) is not None}
    batches = [T.make_lm_batch(np.random.RandomState(seed), TRAIN_BATCH,
                               MAX_LEN, VOCAB)
               for seed in range(MEGA_TRAIN_STEPS)]
    what = "mega-train lm"
    _capture_warm(torch, fluid, exe, prog, init, batches, what)
    counts, bitwise = _mega_compare(
        torch, fluid, exe, prog, init, batches, what, ADAM_NORM_TOL,
        lambda a, b: (_apart(a, b)[2], "relative norm of the difference"))
    for key in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        check(counts[key] == N_LAYER * MEGA_TRAIN_STEPS, "%s: %s launches "
              "%d through replays != n_layer x steps = %d", what, key,
              counts[key], N_LAYER * MEGA_TRAIN_STEPS)
    log("%s: launches through %d replays %s (n_layer %d x %d logical "
        "steps each); captures %d, replays %d", what,
        MEGA_TRAIN_STEPS // MEGA_TRAIN_K,
        {k: v for k, v in counts.items() if v}, N_LAYER, MEGA_TRAIN_STEPS,
        exe.stats["graph_captures"], exe.stats["graph_replays"])
    timing = _interleaved_train(torch, fluid, exe, prog, init, batches,
                                what, "tokens/s", TRAIN_BATCH * MAX_LEN,
                                smi)
    return counts, bitwise, timing


def mega_train_resnet_phase(torch, prog, smi):
    """ResNet-50 (batch 32, 224x224) with fuse_conv_bn on and off: 10
    run() steps vs 2 run_steps(K=5) dispatches over the same 10 batches.
    Eager ResNet steps are not repeatable run to run by default (cuDNN's
    backward), so a control runs the eager steps twice; where they part,
    the comparison is repeated with cudnn.deterministic (graph captured
    anew), which must be bitwise. matmul_stats launches exactly 36 per
    logical step through replays (fused), none with the flag off."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import flags
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope0 = fluid.Scope()
    exe.run(prog[1], scope=scope0)
    init = {n: scope0.get_numpy(n) for n in scope0.local_var_names()
            if scope0.find_var(n) is not None}
    batches = [{"data": np.random.RandomState(seed).rand(
                    RESNET_BATCH, 3, RESNET_IMAGE, RESNET_IMAGE).astype(
                        np.float32),
                "label": np.random.RandomState(seed + 100).randint(
                    0, RESNET_CLASSES, (RESNET_BATCH, 1)).astype(np.int64)}
               for seed in range(MEGA_TRAIN_STEPS)]
    params = [p.name for p in prog[0].global_block().all_parameters()]

    def apart(a, b):
        graft, worst, _ = _apart({n: a[n] for n in params},
                                 {n: b[n] for n in params})
        return graft, worst

    out = {}
    for name, on in (("fused", True), ("flag off", False)):
        what = "mega-train resnet50 (%s)" % name
        with _fuse(flags, on):
            _capture_warm(torch, fluid, exe, prog, init, batches, what)
            main, _, avg_cost = prog
            s1 = _scope_from(fluid, init, exe.device)
            s2 = _scope_from(fluid, init, exe.device)
            l1 = _eager_steps(torch, exe, main, avg_cost, s1, batches)
            l2 = _eager_steps(torch, exe, main, avg_cost, s2, batches)
            repeatable = all(np.array_equal(a, b) for a, b in zip(l1, l2)) \
                and all(np.array_equal(s1.get_numpy(n), s2.get_numpy(n))
                        for n in init)
            log("%s: eager steps run twice %s", what,
                "bitwise equal" if repeatable else
                "part (cuDNN's default algorithms are not repeatable); the "
                "graph is compared under cudnn.deterministic")
            det = torch.backends.cudnn.deterministic
            torch.backends.cudnn.deterministic = not repeatable or det
            try:
                if not repeatable:
                    _capture_warm(torch, fluid, exe, prog, init, batches,
                                  what + " deterministic")
                counts, bitwise = _mega_compare(
                    torch, fluid, exe, prog, init, batches, what,
                    RESNET_PARITY_TOL, apart)
            finally:
                torch.backends.cudnn.deterministic = det
            want = RESNET_FUSED_PER_STEP * MEGA_TRAIN_STEPS if on else 0
            check(counts["matmul_stats"] == want, "%s: matmul_stats launches "
                  "%d through replays, expected %d", what,
                  counts["matmul_stats"], want)
            log("%s: matmul_stats launches through %d replays %d (%d per "
                "logical step); captures %d, replays %d", what,
                MEGA_TRAIN_STEPS // MEGA_TRAIN_K, counts["matmul_stats"],
                counts["matmul_stats"] // MEGA_TRAIN_STEPS,
                exe.stats["graph_captures"], exe.stats["graph_replays"])
            timing = _interleaved_train(torch, fluid, exe, prog, init,
                                        batches, what, "images/s",
                                        RESNET_BATCH, smi)
        out[name] = (counts, bitwise, repeatable, timing)
    return out


def _decode_heavy_requests(rng):
    """32 requests, one per slot: prompts of 8-32 tokens, 192 new tokens
    each (long generation at a full batch)."""
    return [([1] + rng.integers(3, VOCAB, int(rng.integers(7, 32))).tolist(),
             192) for _ in range(32)]


def _serve_once(torch, eng, reqs):
    before = dict(eng.stats)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = eng.generate_many([p for p, _ in reqs], [m for _, m in reqs])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    delta = {k: eng.stats[k] - before[k] for k in eng.stats}
    return out, wall, delta


def mega_serve_phase(torch, smi):
    """The flagship served by Engine(slots=32, prefill_chunk=16,
    block_size=16) at megastep=1 and megastep=8 on the 64-request mixed
    set and a decode-heavy set (32 requests, max_new 192): tokens equal
    between K=1 and K=8, and for 4 requests equal to
    sequential_generate's; paged launches exactly n_layer x (decode steps
    the device ran + prefill chunks). Then timed A/B/A/B and traced."""
    from paddle_tpu_torch.models.transformer_infer import (
        TransformerLMInfer, init_stream)
    from paddle_tpu_torch.serving import Engine, sequential_generate
    stream = init_stream(VOCAB, MAX_LEN, N_LAYER, N_HEAD, D_MODEL, D_INNER,
                         seed=0)
    model = TransformerLMInfer.from_stream(
        stream, N_LAYER, N_HEAD, D_MODEL, MAX_LEN, end_id=VOCAB)
    sets = {"mixed": _requests(np.random.default_rng(0)),
            "decode-heavy": _decode_heavy_requests(np.random.default_rng(1))}
    engines = {}
    seqs = {}
    for k in (1, MEGA_SERVE_K):
        eng = Engine(model, slots=32, prefill_chunk=16, block_size=16,
                     megastep=k)
        t0 = time.perf_counter()
        eng.warmup()
        log("mega-serve: Engine(megastep=%d) warmup %.3f s (graph "
            "captures %d)", k, time.perf_counter() - t0,
            eng.stats["graph_captures"])
        engines[k] = eng
    graph_paged = 0
    try:
        timing = {}
        for set_name, reqs in sets.items():
            outs = {}
            for k, eng in engines.items():
                _reset_launches()
                out, wall, d = _serve_once(torch, eng, reqs)
                launches = _launches()["paged_attention"]
                outs[k] = out
                ntok = sum(len(t) for t, _ in out)
                log("mega-serve %s (megastep=%d): %d requests, %d tokens in "
                    "%.3f s = %.1f tokens/s; decode steps consumed %d, run %d "
                    "(%.3f ms each); megastep dispatches %d; prefill chunks "
                    "%d; graph replays %d (captures %d); paged launches %d; "
                    "%s", set_name, k, len(out), ntok, wall, ntok / wall,
                    d["decode_steps"], d["decode_steps_run"],
                    1e3 * d["decode_seconds"] / d["decode_steps_run"],
                    d["megastep_dispatches"], d["prefill_chunks"],
                    d["graph_replays"], eng.stats["graph_captures"],
                    launches, smi)
                want = N_LAYER * (d["decode_steps_run"] + d["prefill_chunks"])
                check(launches == want, "mega-serve %s megastep=%d: paged "
                      "launches %d != n_layer x (decode steps run + prefill "
                      "chunks) = %d", set_name, k, launches, want)
                for i, ((toks, score), (_, m)) in enumerate(zip(out, reqs)):
                    check(len(toks) == m and np.isfinite(score),
                          "mega-serve %s megastep=%d request %d: bad "
                          "output", set_name, k, i)
                if k > 1:
                    check(d["megastep_dispatches"] > 0 and
                          d["graph_replays"] == d["megastep_dispatches"],
                          "mega-serve %s: %d megastep dispatches, %d "
                          "replays", set_name, d["megastep_dispatches"],
                          d["graph_replays"])
                    graph_paged += launches
            diverged = [i for i, (a, b) in enumerate(zip(outs[1],
                                                         outs[MEGA_SERVE_K]))
                        if a[0] != b[0]]
            check(not diverged, "mega-serve %s: megastep=%d tokens differ "
                  "from megastep=1 for requests %s", set_name, MEGA_SERVE_K,
                  diverged)
            seq = seqs[set_name] = sequential_generate(model, reqs[:4])
            for i, ((a, _), (b, _)) in enumerate(zip(outs[MEGA_SERVE_K][:4],
                                                     seq)):
                check(a == b, "mega-serve %s request %d differs from "
                      "sequential_generate", set_name, i)
            log("mega-serve %s: megastep=%d tokens equal megastep=1's (%d "
                "requests) and sequential_generate's (4 requests)",
                set_name, MEGA_SERVE_K, len(reqs))
            timing[set_name] = _interleaved_serve(
                torch, {"megastep=%d" % k: e for k, e in engines.items()},
                reqs, "mega-serve " + set_name, smi)
    finally:
        for eng in engines.values():
            eng.close()
    return graph_paged, timing, seqs


def _interleaved_serve(torch, engines, reqs, title, smi, traced=None):
    """Each engine of ``{label: engine}`` serves ``reqs`` in turn,
    MEGA_PAIRS rounds (A/B/A/B: the host varies from run to run), then
    once traced (only the labels in ``traced``, when given: a trace's
    post-processing costs ~10 s of host time at these sizes). A decode
    dispatch is a plain step the device ran or a scoring dispatch.
    Returns {label: (median ms per decode dispatch, median tokens/s,
    busy share or None)}."""
    walls = {k: [] for k in engines}
    rates = {k: [] for k in engines}
    steps = {k: [] for k in engines}
    for _ in range(MEGA_PAIRS):
        for k, eng in engines.items():
            out, wall, d = _serve_once(torch, eng, reqs)
            walls[k].append(wall)
            rates[k].append(sum(len(t) for t, _ in out) / wall)
            steps[k].append(1e3 * d["decode_seconds"] / (
                d["decode_steps_run"] + d["spec_dispatches"]))
    busy = dict.fromkeys(engines)
    from torch.profiler import ProfilerActivity, profile
    for k, eng in engines.items():
        if traced is not None and k not in traced:
            continue
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _, wall, _ = _serve_once(torch, eng, reqs)
        busy[k] = _report_profile(
            prof, wall, "%s profile (traced, %s)" % (title, k),
            focus="paged_attention_kernel")[0]
    out = {}
    for k in engines:
        out[k] = (_median(steps[k]), _median(rates[k]), busy[k])
        log("%s timing (%s, %d rounds interleaved): decode dispatch ms %s "
            "(median %.3f); tokens/s %s (median %.1f); wall s %s; device "
            "busy %s; %s", title, k, MEGA_PAIRS,
            " ".join("%.3f" % x for x in steps[k]), out[k][0],
            " ".join("%.1f" % x for x in rates[k]), out[k][1],
            " ".join("%.3f" % x for x in walls[k]),
            "not measured" if busy[k] is None else "%.1f%%" % (100 * busy[k]),
            smi)
    return out


# -- phase 10 ------------------------------------------------------------
# speculative and sampled serving: the scoring dispatch (the paged kernel
# at C = gamma + 1 rows), the truncated drafter, the counter-keyed
# sampler and the sampled megastep graph
SPEC_GAMMA, SPEC_LAYERS = 4, 2
# a parting is a near-tie only if the scoring dispatch's logits of that
# row stay within this many times the row's fp32 rounding of the plain
# step's (``_divergence``)
SPEC_DELTA_X = 2
SAMPLED = dict(temperature=0.8, top_k=50, top_p=0.95)
SAMPLED_SEEDS = range(100, 116)


def spec_kernel_phase(torch):
    """Kernel #1 at the scoring shape (S=32, H=8, C=gamma+1=5, dk 64, bs
    16, ragged per-row qpos = pos + j) against the plain version on
    fp32 and fp8 pools (layers 0 and 3, phase 3's tolerances); then
    timed at (d), every slot scoring positions 251..255 of a 256-position
    chain on the phase-3 timing pool, as device time alone and with the
    host's gaps, against the plain version, scaled_dot_product_attention
    over the gathered K/V with the per-row causal mask, and the bound.
    Returns (largest abs error, timing entry)."""
    from paddle_tpu_torch.ops import paged_attention as P
    rng = np.random.default_rng(10)
    s, c, bs, nbmax = 32, SPEC_GAMMA + 1, 16, 16
    worst = 0.0
    for quant in ("fp32", "fp8"):
        chains = rng.integers(1, nbmax + 1, size=s)
        chains[0] = nbmax
        case = _pool_case(torch, rng, s, c, chains, quant)
        last = (chains - 1) * bs + rng.integers(0, bs, size=s)
        pos = np.maximum(last - (c - 1), 0)
        case["qpos"] = torch.from_numpy(
            (pos[:, None] + np.arange(c)[None]).astype(np.int32)).cuda()
        args = tuple(case[k] for k in ("q", "pool_k", "pool_v", "btab",
                                       "qpos"))
        nb_t = torch.tensor([nbmax], dtype=torch.int32, device="cuda")
        for layer in (0, 3):
            got = P.paged_attention(*args, nblk=nb_t,
                                    k_scale=case["k_scale"],
                                    v_scale=case["v_scale"], layer=layer)
            ref = P._attend_plain(*args, nbmax, case["k_scale"],
                                  case["v_scale"], layer=layer)
            torch.cuda.synchronize()
            err = (got - ref).abs()
            bad = err > ATOL + RTOL * ref.abs()
            worst = max(worst, float(err.max()))
            check(bool(torch.isfinite(got).all()) and not bool(bad.any()),
                  "scoring shape: kernel disagrees with _attend_plain (%s, "
                  "layer %d): max_abs_err=%g", quant, layer,
                  float(err.max()))
            log("spec kernel: S=%d C=%d dk=64 bs=16 %s ragged qpos=pos+j "
                "splits=%d layer=%d max_abs_err=%.3g  ok", s, c, quant,
                P._splits(s, 8, c, nbmax, bs), layer, float(err.max()))
    pk, pv, shapes = _paged_shapes(torch)
    bt = shapes["a"][1]
    h, dk = pk.shape[2], pk.shape[4]
    q = torch.from_numpy(rng.normal(size=(s, h, c, dk)).astype(
        np.float32) * dk ** -0.5).cuda()
    qp = (torch.arange(c, dtype=torch.int32, device="cuda")[None]
          + (nbmax * bs - c)).expand(s, c).contiguous()
    nb_t = torch.tensor([nbmax], dtype=torch.int32, device="cuda")
    npos = nbmax * bs
    kpos = torch.arange(npos, device="cuda")
    mask = kpos[None, None, None, :] <= qp[:, None, :, None]
    dense = []
    for layer in range(4):
        dense.append([pool[:, layer][bt.long()].permute(0, 2, 1, 3, 4)
                      .reshape(s, h, npos, dk).contiguous()
                      for pool in (pk, pv)])
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def kernel(i):
        P.paged_attention(q, pk, pv, bt, qp, nblk=nb_t, layer=i % 4)

    def library(i):
        k, v = dense[i % 4]
        sdpa(q, k, v, attn_mask=mask, scale=1.0)

    def plain(i):
        P._attend_plain(q, pk, pv, bt, qp, nbmax, None, None, layer=i % 4)
    r = {"ms": _events_ms(torch, kernel, 100, hide_host=True),
         "ms_with_host_gaps": _events_ms(torch, kernel, 100),
         "library_ms": _events_ms(torch, library, 100, hide_host=True),
         "library_ms_with_host_gaps": _events_ms(torch, library, 100),
         "plain_ms": _events_ms(torch, plain, 5)}
    got = P.paged_attention(q, pk, pv, bt, qp, nblk=nb_t, layer=0)
    lib = sdpa(q, dense[0][0], dense[0][1], attn_mask=mask, scale=1.0)
    check(torch.allclose(got, lib, rtol=RTOL, atol=ATOL),
          "kernel disagrees with scaled_dot_product_attention at (d)")
    nbytes, flops = _paged_work(q, qp, h, dk, bs)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / FP32_FLOPS * 1e3
    r.update(bound_ms=max(bytes_ms, ops_ms),
             bound_by="bytes" if bytes_ms >= ops_ms else "operations")
    log("timing (d) scoring S=%d H=%d C=%d dk=%d bs=%d, positions 251..255 "
        "of 256 per slot, fp32, splits %d: device time alone kernel_ms=%.5f "
        "library_ms=%.5f (kernel / library %.3f); with the host's gaps "
        "kernel_ms=%.5f library_ms=%.5f; plain_ms=%.5f (with gaps); "
        "bound_ms=%.5f (%s: %d bytes %.5f ms, %d flops at fp32 SIMT %.5f "
        "ms)", s, h, c, dk, bs, P._splits(s, h, c, nbmax, bs), r["ms"],
        r["library_ms"], r["ms"] / r["library_ms"], r["ms_with_host_gaps"],
        r["library_ms_with_host_gaps"], r["plain_ms"], r["bound_ms"],
        r["bound_by"], nbytes, bytes_ms, flops, ops_ms)
    return worst, r


def _row_logits(torch, model, prompt, toks, i):
    """The logits for generated token ``i`` of a request whose earlier
    tokens are ``toks[:i]``, under three fp32 dispatches: the plain
    paged step (S=32 slots, row 0 live, prefilled in chunks of 16, as the
    plain engine computes that row), the scoring dispatch (C = gamma+1,
    the position at j=0, the following tokens as drafts, on a copy of the
    same pool) and the dense single-row step. Returns three [V] f32
    tensors."""
    dev, bs, s = model.device, 16, 32
    nbmax = MAX_LEN // bs
    need = len(prompt) - 1
    st = model._init_paged_state(nbmax, bs)
    btab = torch.zeros((s, nbmax), dtype=torch.int32, device=dev)
    btab[0] = torch.arange(nbmax, dtype=torch.int32, device=dev)
    for cur in range(0, need, 16):
        n = min(16, need - cur)
        chunk = torch.zeros(16, dtype=torch.long, device=dev)
        chunk[:n] = torch.tensor(prompt[cur:cur + n], device=dev)
        model._prefill_chunk_paged(st, chunk, cur, n, btab[0],
                                   block_kernel=True)
    active = torch.zeros(s, dtype=torch.bool, device=dev)
    active[0] = True
    tok = torch.zeros(s, dtype=torch.long, device=dev)
    pos = torch.zeros(s, dtype=torch.long, device=dev)
    seq = [prompt[-1]] + list(toks[:i])
    c = SPEC_GAMMA + 1
    for j in range(i + 1):
        tok[0], pos[0] = seq[j], need + j
        if j == i:
            drafts = list(toks[i:i + c - 1])
            toks_c = torch.zeros((s, c), dtype=torch.long, device=dev)
            toks_c[0, :1 + len(drafts)] = torch.tensor(
                [seq[i]] + drafts, device=dev)
            nv = torch.zeros(s, dtype=torch.long, device=dev)
            nv[0] = len(drafts)
            spool = {n: t.clone() for n, t in st.items()}
            score, _ = model._spec_logits_paged(
                toks_c, spool, pos, btab, nv, write_mask=active,
                block_kernel=True)
        plain, _ = model._step_logits_paged(tok, st, pos, btab,
                                            write_mask=active,
                                            block_kernel=True)
    dstate = model._init_state(1)
    for t, tk in enumerate(list(prompt[:-1]) + seq):
        dense, dstate = model._step_logits(
            torch.full((1,), tk, dtype=torch.long, device=dev), dstate, t)
    return plain[0].float(), score[0, 0].float(), dense[0].float()


def _divergence(torch, model, req, a, b, sp=None):
    """Diagnose the first token where the speculative run ``a`` and the
    plain run ``b`` part. The row's fp32 rounding is taken as the largest
    difference between two correct fp32 dispatches of it, the plain
    paged step and the dense step (``_row_logits``), neither of them the
    scoring dispatch under test. A near-tie needs both: the scoring
    dispatch's logits of the row within ``SPEC_DELTA_X`` times that
    rounding of the plain step's, and (greedy) the two tokens' logits
    under the plain step no further apart than that rounding, or
    (sampled, ``sp``) the uniform no further from a step of the plain
    step's CDF than the two correct dispatches' CDFs differ. Returns
    (near-tie, figures)."""
    from paddle_tpu_torch.serving import sampling as SM
    i = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
    if i is None:
        return False, "lengths %d vs %d" % (len(a), len(b))
    with torch.no_grad():
        plain, score, dense = _row_logits(torch, model, req[0], b, i)
    eps = float((plain - dense).abs().max())
    delta = float((plain - score).abs().max())
    top = torch.topk(plain, 2)
    gap = abs(float(plain[a[i]] - plain[b[i]]))
    ulp = float(torch.finfo(torch.float32).eps * top.values[0].abs())
    msg = ("token %d: %d vs %d (plain); plain step top-2 %s, logit gap of "
           "the two %.3g (fp32 ulp of the top logit %.3g); scoring "
           "dispatch picks %d (gap %.3g), differs from the plain step by "
           "up to %.3g; the dense step picks %d, differs by up to %.3g"
           % (i, a[i], b[i], top.indices.tolist(), gap, ulp,
              int(score.argmax()), abs(float(score[a[i]] - score[b[i]])),
              delta, int(dense.argmax()), eps))
    close = delta <= SPEC_DELTA_X * eps
    if not close:
        msg += ("; the scoring dispatch is further from the plain step "
                "than %d x the row's rounding" % SPEC_DELTA_X)
    if sp is None:
        return close and gap <= eps, msg
    dev = model.device

    def cdf(lg, order=None):
        final = SM.filter_logits(
            lg[None], torch.tensor([sp["temperature"]], device=dev),
            torch.tensor([sp["top_k"]], device=dev),
            torch.tensor([sp["top_p"]], device=dev))
        p = torch.softmax(final, -1)[0]
        if order is None:
            order = torch.sort(p, descending=True, stable=True).indices
        return torch.cumsum(p[order], 0), order
    c_plain, order = cdf(plain)
    c_dense, _ = cdf(dense, order)
    u = float(SM.uniform(SM.step_keys(
        torch.tensor([sp["seed"]], device=dev),
        torch.tensor([i], device=dev)))[0])
    dist = float((c_plain - u * c_plain[-1]).abs().min())
    eps_cdf = float((c_plain - c_dense).abs().max())
    msg += ("; sampled: u %.7f lands %.3g from the plain step's nearest "
            "CDF step; the two dispatches' CDFs differ by up to %.3g"
            % (u, dist, eps_cdf))
    return close and dist <= eps_cdf, msg


def _same_or_near_tie(torch, model, req, a, b, what, near_ties, sp=None):
    """Tokens ``a`` (speculative) must equal ``b`` (plain), unless they
    part at a near-tie (``_divergence``); a near-tie is logged and kept
    in ``near_ties``, anything else fails."""
    if a == b:
        return True
    tie, msg = _divergence(torch, model, req, a, b, sp)
    log("%s: tokens part: %s: %s", what,
        "a near-tie within the row's fp32 rounding" if tie
        else "NOT a near-tie", msg)
    check(tie, "%s differs from the plain engine, and not at a near-tie: "
          "%s", what, msg)
    near_ties.append("%s: %s" % (what, msg))
    return False


@contextlib.contextmanager
def _scoring_launches(eng):
    """Watch ``eng``'s scoring dispatches for one run: yields (the paged
    launches inside each call of ``_spec_step_impl``, read from the
    kernel's counter before and after it; {query rows C: launches}
    inside those calls, read from each launch's q)."""
    from paddle_tpu_torch.ops import paged_attention as P
    per, rows, inside = [], {}, [False]
    impl, attend = eng._spec_step_impl, P._attend_cuda

    def attend_seen(q, *args, **kw):
        if inside[0]:
            rows[q.shape[2]] = rows.get(q.shape[2], 0) + 1
        return attend(q, *args, **kw)

    def scoring(*args, **kw):
        n0 = P.paged_attention.launches
        inside[0] = True
        try:
            return impl(*args, **kw)
        finally:
            inside[0] = False
            per.append(P.paged_attention.launches - n0)
    eng._spec_step_impl, P._attend_cuda = scoring, attend_seen
    try:
        yield per, rows
    finally:
        del eng._spec_step_impl
        P._attend_cuda = attend


def _spec_engines(model):
    from paddle_tpu_torch.serving import Engine
    out = {}
    for label, kw in (("plain K=1", {}),
                      ("plain K=%d" % MEGA_SERVE_K,
                       {"megastep": MEGA_SERVE_K}),
                      ("spec-ngram", {"speculative": True,
                                      "spec_gamma": SPEC_GAMMA,
                                      "spec_drafter": "ngram"}),
                      ("spec-truncated", {"speculative": True,
                                          "spec_gamma": SPEC_GAMMA,
                                          "spec_drafter": "truncated",
                                          "spec_layers": SPEC_LAYERS})):
        eng = Engine(model, slots=32, prefill_chunk=16, block_size=16, **kw)
        t0 = time.perf_counter()
        eng.warmup(sampled=True)
        log("spec-serve: %s warmup (greedy and sampled) %.3f s, graph "
            "captures %d", label, time.perf_counter() - t0,
            eng.stats["graph_captures"])
        out[label] = eng
    return out


def spec_serve_phase(torch, smi, seqs):
    """Speculative and sampled serving of the flagship LM. Greedy: both
    request sets through the ngram and the truncated drafter, tokens
    equal to the plain engine's at megastep 1 (or parted at a diagnosed
    near-tie, ``_same_or_near_tie``), whose tokens equal (4 requests)
    sequential_generate's (``seqs``, from phase 9); paged launches exactly
    n_layer x (scoring dispatches + plain steps run + prefill chunks) +
    spec_layers x truncated draft steps. Sampled: 16 requests (seeds
    100-115) among 4 greedy ones through the plain engine, the megastep
    graph (its sampled variant) and the speculative engine, twice;
    the RNG's bits on the card against the CPU's. Then the decode-heavy
    set timed A/B/A/B over the four engines. Returns (paged launches,
    those of them inside scoring dispatches, at C = gamma + 1, counted
    around each dispatch by ``_scoring_launches``; timing)."""
    from paddle_tpu_torch.models.transformer_infer import (
        TransformerLMInfer, init_stream)
    stream = init_stream(VOCAB, MAX_LEN, N_LAYER, N_HEAD, D_MODEL, D_INNER,
                         seed=0)
    model = TransformerLMInfer.from_stream(
        stream, N_LAYER, N_HEAD, D_MODEL, MAX_LEN, end_id=VOCAB)
    sets = {"mixed": _requests(np.random.default_rng(0)),
            "decode-heavy": _decode_heavy_requests(np.random.default_rng(1))}
    engines = _spec_engines(model)
    total = scoring = 0
    near_ties = []
    try:
        for set_name, reqs in sets.items():
            _reset_launches()
            base, _, d = _serve_once(torch, engines["plain K=1"], reqs)
            want = N_LAYER * (d["decode_steps_run"] + d["prefill_chunks"])
            launches = _launches()["paged_attention"]
            check(launches == want, "spec-serve %s plain: paged launches "
                  "%d != %d", set_name, launches, want)
            total += launches
            for i, ((a, _), (b, _)) in enumerate(zip(base, seqs[set_name])):
                check(a == b, "spec-serve %s: plain request %d differs from "
                      "sequential_generate", set_name, i)
            for label in ("spec-ngram", "spec-truncated"):
                eng = engines[label]
                _reset_launches()
                with _scoring_launches(eng) as (per, rows):
                    out, wall, d = _serve_once(torch, eng, reqs)
                launches = _launches()["paged_attention"]
                want = (N_LAYER * (d["spec_dispatches"] + d["decode_steps_run"]
                                   + d["prefill_chunks"])
                        + eng._spec_layers * d["spec_draft_steps"])
                ntok = sum(len(t) for t, _ in out)
                log("spec-serve %s (%s, gamma %d%s): %d requests, %d tokens "
                    "in %.3f s = %.1f tokens/s; scoring dispatches %d, "
                    "drafted %d, accepted %d (%.1f%% of drafted), emitted "
                    "%d (accepted tokens per scoring dispatch %.3f, emitted "
                    "%.3f, summed over its slots); plain steps run %d; "
                    "draft steps %d; prefill chunks %d; paged launches %d; "
                    "%s", set_name, label, SPEC_GAMMA,
                    ", %d layers" % eng._spec_layers
                    if eng._spec_layers else "", len(out), ntok, wall,
                    ntok / wall, d["spec_dispatches"], d["spec_drafted"],
                    d["spec_accepted"],
                    100 * d["spec_accepted"] / max(1, d["spec_drafted"]),
                    d["spec_emitted"],
                    d["spec_accepted"] / max(1, d["spec_dispatches"]),
                    d["spec_emitted"] / max(1, d["spec_dispatches"]),
                    d["decode_steps_run"], d["spec_draft_steps"],
                    d["prefill_chunks"], launches, smi)
                check(d["spec_dispatches"] > 0 and d["spec_drafted"] > 0,
                      "spec-serve %s %s: no drafted scoring dispatch",
                      set_name, label)
                check(launches == want, "spec-serve %s %s: paged launches "
                      "%d != n_layer x (scoring dispatches + plain steps + "
                      "prefill chunks) + spec_layers x draft steps = %d",
                      set_name, label, launches, want)
                total += launches
                check(len(per) == d["spec_dispatches"]
                      and all(n == N_LAYER for n in per),
                      "spec-serve %s %s: %d scoring dispatches seen (stats "
                      "%d), paged launches inside them %s, not n_layer "
                      "each", set_name, label, len(per),
                      d["spec_dispatches"], sorted(set(per)))
                check(rows == {SPEC_GAMMA + 1: sum(per)},
                      "spec-serve %s %s: paged launches inside scoring "
                      "dispatches by query rows %s, not all at C = %d",
                      set_name, label, rows, SPEC_GAMMA + 1)
                log("spec-serve %s %s: %d paged launches inside its %d "
                    "scoring dispatches (counted around each), all at C = "
                    "%d", set_name, label, sum(per), len(per),
                    SPEC_GAMMA + 1)
                scoring += sum(per)
                for i, ((a, sa), (b, sb)) in enumerate(zip(out, base)):
                    what = "spec-serve %s %s request %d" % (set_name,
                                                            label, i)
                    if _same_or_near_tie(torch, model, reqs[i], a, b, what,
                                         near_ties):
                        check(abs(sa - sb) <= 1e-3 * max(1.0, abs(sb)),
                              "%s: score %r vs %r", what, sa, sb)
            log("spec-serve %s: both drafters' tokens equal the plain "
                "engine's (%d requests; near-ties so far %d) and the plain "
                "engine's equal sequential_generate's (4 requests)",
                set_name, len(reqs), len(near_ties))
        sampled_phase(torch, model, engines, sets["decode-heavy"], base,
                      near_ties)
        timing = _interleaved_serve(torch, engines, sets["decode-heavy"],
                                    "spec-serve decode-heavy", smi)
        log("spec-serve: %d near-tie(s) where a speculative run parted "
            "from the plain one%s", len(near_ties),
            "".join("\n  " + t for t in near_ties))
    finally:
        for eng in engines.values():
            eng.close()
    return total, scoring, timing


def sampled_phase(torch, model, engines, heavy, heavy_greedy, near_ties):
    """16 sampled requests (temperature 0.8, top_k 50, top_p 0.95, seeds
    100-115) with 4 greedy ones among them, 64 new tokens each, through
    the plain engine, the megastep-8 engine (its sampled CUDA graph) and
    the speculative engine: identical tokens (the speculative engine's
    may part at a diagnosed near-tie, appended to ``near_ties``), a
    second pass identical, the greedy requests equal to their all-greedy
    tokens, the sampled
    ones not all greedy (``heavy_greedy``: the set's greedy tokens).
    Then the counter RNG's bits on the card against the CPU's."""
    from paddle_tpu_torch.serving import sampling as SM
    reqs = [(p, 64) for p, _ in heavy[:20]]
    greedy = (3, 8, 13, 18)
    seeds = iter(SAMPLED_SEEDS)
    samp = [None if i in greedy else dict(SAMPLED, seed=next(seeds))
            for i in range(len(reqs))]

    def run(eng):
        hs = [eng.submit(p, m, sampling=sp)
              for (p, m), sp in zip(reqs, samp)]
        return [h.result(timeout=600)[0] for h in hs]
    mega = engines["plain K=%d" % MEGA_SERVE_K]
    outs = {}
    for label in ("plain K=1", "plain K=%d" % MEGA_SERVE_K, "spec-ngram"):
        eng = engines[label]
        before = dict(eng.stats)
        graph = eng._graphs[True]
        replays = graph.replays if graph is not None else 0
        outs[label] = [run(eng), run(eng)]
        d = {k: eng.stats[k] - before[k] for k in eng.stats}
        if graph is not None:
            replays = graph.replays - replays
        log("sampled %s: 2 passes of %d requests (%d sampled); sampled "
            "graph replays %d (all graph replays %d); scoring dispatches %d "
            "(accepted %d)", label, len(reqs), len(SAMPLED_SEEDS), replays,
            d["graph_replays"], d["spec_dispatches"], d["spec_accepted"])
        if eng is mega:
            check(graph is not None and replays > 0,
                  "sampled: the megastep engine replayed no sampled graph")
    ref = outs["plain K=1"][0]
    for label, (a, b) in outs.items():
        for i, (x, y, r) in enumerate(zip(a, b, ref)):
            check(x == y, "sampled %s request %d: the second pass differs",
                  label, i)
            if label.startswith("spec"):
                _same_or_near_tie(torch, model, reqs[i], x, r,
                                  "sampled %s request %d" % (label, i),
                                  near_ties, samp[i])
            else:
                check(x == r, "sampled %s request %d differs from the plain "
                      "engine's at megastep 1", label, i)
    alone = engines["plain K=1"].generate_many(
        [reqs[i][0] for i in greedy], [reqs[i][1] for i in greedy])
    for i, (toks, _) in zip(greedy, alone):
        check(ref[i] == toks, "sampled: greedy request %d differs from its "
              "all-greedy tokens", i)
    drew = sum(ref[i] != heavy_greedy[i][0][:64] for i in range(len(reqs))
               if i not in greedy)
    check(drew > 0, "sampled: every sampled request gave its greedy tokens")
    rng = np.random.default_rng(7)
    seeds = torch.from_numpy(rng.integers(0, 2 ** 32, 1000))
    counts = torch.from_numpy(rng.integers(0, 2 ** 40, 1000))

    def bits(keys):
        seed, count = keys[:, 0], keys[:, 1]
        zero = torch.zeros_like(count)
        words = SM.philox4x32((count & 0xFFFFFFFF, count >> 32, zero, zero),
                              (seed, zero))
        return torch.stack(words, 1).cpu(), SM.uniform(keys).cpu()
    keys = SM.step_keys(seeds, counts)
    (w_cpu, u_cpu), (w_dev, u_dev) = bits(keys), bits(keys.cuda())
    check(torch.equal(w_cpu, w_dev) and torch.equal(u_cpu, u_dev),
          "the counter RNG's bits differ between the CPU and the card")
    log("sampled: tokens equal across plain K=1, K=%d (sampled graph) and "
        "spec-ngram (near-ties in phase 10: %d), and across two passes; "
        "greedy requests equal their all-greedy tokens; %d of %d sampled "
        "requests part from greedy; counter RNG bits (4 Philox words and "
        "the uniform) equal on the CPU and the card for 1000 (seed, "
        "counter) pairs", MEGA_SERVE_K, len(near_ties), drew,
        len(SAMPLED_SEEDS))


# -- phase 11 ------------------------------------------------------------
# io: a checkpoint resumes training, an artifact directory boots a
# replica, and the dense paged=False layout serves
IO_STEPS = 3


def _io_lm(fluid, T, adam=True):
    """The packed flagship LM, with Adam(1e-3) or as the forward alone
    (the same variable names either way)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        avg_cost, logits = T.transformer_lm(
            vocab_size=VOCAB, max_len=MAX_LEN, n_layer=N_LAYER,
            n_head=N_HEAD, d_model=D_MODEL, d_inner=D_INNER, packed=True)
        if adam:
            fluid.optimizer.Adam(learning_rate=1e-3).minimize(avg_cost)
    return main, startup, avg_cost, logits


def io_resume_phase(torch, smi, tmp):
    """(a) The packed LM with Adam(1e-3), batch 32 x 256, on the flash
    kernels: IO_STEPS steps, ``save_checkpoint``, ``load_checkpoint`` into
    a fresh scope on the card, IO_STEPS more, against 2 x IO_STEPS
    uninterrupted steps from the same startup scope: losses and every
    persistable bitwise equal. A ``save_persistables``/
    ``load_persistables`` round trip is bitwise; with the newest
    checkpoint's blob corrupted, ``load_checkpoint`` returns the older
    step. Flash launches exactly n_layer per step. Returns (flash
    launches, the resumed scope)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import io as IO
    from paddle_tpu_torch.models import transformer as T
    exe = fluid.Executor(fluid.CUDAPlace(0))
    main, startup, avg_cost, _ = _io_lm(fluid, T)
    scope0 = fluid.Scope()
    exe.run(startup, scope=scope0)
    init = {n: scope0.get_numpy(n) for n in scope0.local_var_names()
            if scope0.find_var(n) is not None}
    names = [v.name for v in main.list_vars() if v.persistable]
    batches = [T.make_lm_batch(np.random.RandomState(40 + i), TRAIN_BATCH,
                               MAX_LEN, VOCAB) for i in range(2 * IO_STEPS)]
    totals = {"fwd": 0, "bwd_dq": 0, "bwd_dkv": 0}

    def steps(scope, bs):
        """Train on ``bs``, the flash counts reset just before and read
        just after."""
        _reset_launches()
        losses = [float(exe.run(main, feed=b, fetch_list=[avg_cost],
                                scope=scope)[0]) for b in bs]
        torch.cuda.synchronize()
        got = _launches()
        for k in totals:
            n = got["flash_" + k]
            check(n == N_LAYER * len(bs), "io-resume: flash %s launches %d "
                  "!= n_layer x steps = %d", k, n, N_LAYER * len(bs))
            totals[k] += n
        return losses

    whole = _scope_from(fluid, init, exe.device)
    want = steps(whole, batches)
    part = _scope_from(fluid, init, exe.device)
    got = steps(part, batches[:IO_STEPS])
    ck = os.path.join(tmp, "ckpt")
    t0 = time.perf_counter()
    IO.save_checkpoint(ck, IO_STEPS, main, scope=part)
    t_save = time.perf_counter() - t0
    resumed = fluid.Scope()
    t0 = time.perf_counter()
    step = IO.load_checkpoint(ck, main, scope=resumed, executor=exe)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    check(step == IO_STEPS, "io-resume: load_checkpoint gave step %r", step)
    check(all(resumed.find_var(n).device.type == "cuda" for n in names),
          "io-resume: the checkpoint did not load onto the card")
    got += steps(resumed, batches[IO_STEPS:])
    check(got == want, "io-resume: resumed losses %s differ from the "
          "uninterrupted run's %s", got, want)
    differ = [n for n in names
              if not torch.equal(resumed.find_var(n), whole.find_var(n))]
    check(not differ, "io-resume: %d persistables differ from the "
          "uninterrupted run's (first %s)", len(differ), differ[:3])
    nbytes = os.path.getsize(os.path.join(ck, "ckpt-%d.npz" % IO_STEPS))
    log("io-resume: %d + %d Adam steps through save_checkpoint / "
        "load_checkpoint (%d persistables, %.1f MB: save %.3f s, load onto "
        "the card %.3f s) bitwise equal to %d uninterrupted steps in losses "
        "%s and every persistable; flash launches %s; %s", IO_STEPS,
        IO_STEPS, len(names), nbytes / 1e6, t_save, t_load, 2 * IO_STEPS,
        " ".join("%.6f" % x for x in got), totals, smi)
    pd = os.path.join(tmp, "persistables")
    IO.save_persistables(exe, pd, main, scope=resumed)
    back = fluid.Scope()
    IO.load_persistables(exe, pd, main, scope=back)
    differ = [n for n in names
              if not torch.equal(back.find_var(n), resumed.find_var(n))]
    check(not differ, "io-resume: save/load_persistables changed %s",
          differ[:3])
    IO.save_checkpoint(ck, 2 * IO_STEPS, main, scope=resumed)
    blob = os.path.join(ck, "ckpt-%d.npz" % (2 * IO_STEPS))
    with open(blob, "r+b") as f:
        f.seek(os.path.getsize(blob) // 2)
        f.write(b"\xde\xad\xbe\xef")
    fallback = IO.load_checkpoint(ck, main, scope=fluid.Scope(),
                                  executor=exe)
    check(fallback == IO_STEPS, "io-resume: with the newest checkpoint "
          "corrupted load_checkpoint gave %r, not %d", fallback, IO_STEPS)
    log("io-resume: save/load_persistables round trip bitwise (%d vars); "
        "newest checkpoint corrupted -> load_checkpoint fell back to step "
        "%d", len(names), fallback)
    return totals, resumed


def _cold_start(torch, Engine, d, probe):
    """``Engine(<d>)`` booted and asked ``probe``: (engine, seconds from
    the constructor to the first token, the probe's output)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = Engine(d, slots=32, prefill_chunk=16, block_size=16)
    first = eng.submit(*probe)
    while first.t_first_token is None and not first.done():
        time.sleep(0.0005)
    cold_s = (first.t_first_token or time.perf_counter()) - t0
    return eng, cold_s, first.result(timeout=600)


def _serve_counted(torch, eng, reqs):
    """One run of ``reqs`` with the paged count reset just before and
    read just after: (outputs, stats delta, paged launches, wall)."""
    _reset_launches()
    out, wall, d = _serve_once(torch, eng, reqs)
    return out, d, _launches()["paged_attention"], wall


def io_serve_phase(torch, smi, tmp, scope):
    """(b) ``save_lm_artifact(specialize=False)`` of the LM's forward
    program (targets: the logits) from the trained scope, then
    ``Engine(model=<dir>)`` on both request sets: tokens identical to an engine over ``from_program`` on the live
    scope; paged launches exactly n_layer x (decode steps run + prefill
    chunks); a flipped byte in the params blob raises ``ArtifactError``;
    the cold start (directory -> first token) timed. (c) The dense layout
    ``Engine(paged=False)`` at megastep 1 and 8 on both sets: K=1 and K=8
    token-identical, 4 requests of the mixed set equal to
    ``sequential_generate``'s, equal to the paged engine's (a parting
    passes only as a diagnosed 1x near-tie, counted), zero paged
    launches; then dense against paged at K=1 and K=8 timed A/B/A/B on
    the decode-heavy set, and each layout traced once at K=8 (at K=1 both
    are host-bound: 6-8% busy on an H100). Returns (paged
    launches, near-ties, timing, cold-start seconds)."""
    import shutil
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import transformer as T
    from paddle_tpu_torch.models.transformer_infer import TransformerLMInfer
    from paddle_tpu_torch.serving import (
        ArtifactError, Engine, model_from_artifact, save_lm_artifact,
        sequential_generate)
    t_start = time.perf_counter()
    main, _, _, logits = _io_lm(fluid, T, adam=False)
    art = os.path.join(tmp, "artifact")
    save_lm_artifact(art, main, scope, [logits], N_LAYER, N_HEAD, D_MODEL,
                     MAX_LEN, end_id=VOCAB, specialize=False)
    sets = {"mixed": _requests(np.random.default_rng(0)),
            "decode-heavy": _decode_heavy_requests(np.random.default_rng(1))}
    # a first request that shares no block with the sets' prompts, so
    # the prefix caches of the two engines compared below start alike
    probe = ([1] + np.random.default_rng(5).integers(3, VOCAB, 40).tolist(),
             8)
    cold, cold_s, probe_out = _cold_start(torch, Engine, art, probe)
    check(cold.model.device.type == "cuda", "io-serve: the artifact "
          "engine's model is not on the card")
    log("io-serve: cold start Engine(<artifact dir>) -> first token of a "
        "%d-token prompt %.3f s (artifact %.1f MB, no warmup); %s",
        len(probe[0]), cold_s,
        sum(os.path.getsize(os.path.join(art, f))
            for f in os.listdir(art)) / 1e6, smi)
    live_model = TransformerLMInfer.from_program(
        main, scope, N_LAYER, N_HEAD, D_MODEL, MAX_LEN, end_id=VOCAB)
    live = Engine(live_model, slots=32, prefill_chunk=16, block_size=16)
    check(live.submit(*probe).result(timeout=600) == probe_out,
          "io-serve: the probe request differs between the artifact "
          "engine and the live scope's")
    dense = {k: Engine(live_model, slots=32, prefill_chunk=16, paged=False,
                       megastep=k) for k in (1, MEGA_SERVE_K)}
    paged8 = Engine(live_model, slots=32, prefill_chunk=16, block_size=16,
                    megastep=MEGA_SERVE_K)
    engines = [cold, live, paged8] + list(dense.values())
    total = 0
    near_ties = []
    try:
        for eng in engines:
            eng.warmup(sampled=False)
        for set_name, reqs in sets.items():
            outs = {}
            for label, eng in (("artifact", cold), ("live", live)):
                out, d, launches, wall = _serve_counted(torch, eng, reqs)
                want = N_LAYER * (d["decode_steps_run"] + d["prefill_chunks"])
                check(launches == want, "io-serve %s %s: paged launches %d "
                      "!= n_layer x (decode steps run + prefill chunks) = "
                      "%d", set_name, label, launches, want)
                total += launches
                outs[label] = out
                log("io-serve %s (%s engine): %d requests, %d tokens in "
                    "%.3f s; paged launches %d", set_name, label, len(out),
                    sum(len(t) for t, _ in out), wall, launches)
            check(outs["artifact"] == outs["live"], "io-serve %s: the "
                  "artifact engine's tokens or scores differ from the live "
                  "scope's", set_name)
            for k, eng in dense.items():
                out, d, launches, wall = _serve_counted(torch, eng, reqs)
                check(launches == 0, "io-dense %s K=%d: %d paged launches",
                      set_name, k, launches)
                check(k == 1 or d["megastep_dispatches"] > 0,
                      "io-dense %s: no megastep dispatch", set_name)
                outs["dense K=%d" % k] = out
                log("io-dense %s (K=%d): %d requests, %d tokens in %.3f s; "
                    "decode steps run %d, megastep dispatches %d, graph "
                    "replays %d; paged launches 0", set_name, k, len(out),
                    sum(len(t) for t, _ in out), wall,
                    d["decode_steps_run"], d["megastep_dispatches"],
                    d["graph_replays"])
            check(outs["dense K=1"] == outs["dense K=%d" % MEGA_SERVE_K],
                  "io-dense %s: K=%d differs from K=1", set_name,
                  MEGA_SERVE_K)
            # the reference decode runs one row a step: 4 requests of
            # the mixed set (long prompts, shared prefixes) hold it
            seq = (sequential_generate(live_model, reqs[:4])
                   if set_name == "mixed" else ())
            for i, ((a, _), (b, _)) in enumerate(zip(outs["dense K=1"],
                                                     seq)):
                check(a == b, "io-dense %s request %d differs from "
                      "sequential_generate", set_name, i)
            parted = 0
            for i, ((a, _), (b, _)) in enumerate(zip(outs["dense K=1"],
                                                     outs["artifact"])):
                what = "io-dense %s request %d (dense vs paged)" % (
                    set_name, i)
                parted += not _same_or_near_tie(torch, live_model, reqs[i],
                                                a, b, what, near_ties)
            log("io-dense %s: K=1 and K=%d token-identical (%d requests); "
                "%d requests equal sequential_generate's; %d parted from "
                "the paged engine at a diagnosed near-tie (%.1f s into "
                "io-serve)", set_name, MEGA_SERVE_K, len(reqs), len(seq),
                parted, time.perf_counter() - t_start)
        flipped = os.path.join(tmp, "flipped")
        shutil.copytree(art, flipped)
        pf = os.path.join(flipped, "__params__.npz")
        with open(pf, "r+b") as f:
            f.seek(os.path.getsize(pf) // 2)
            b = f.read(1)
            f.seek(-1, 1)
            f.write(bytes([b[0] ^ 0x01]))
        try:
            model_from_artifact(flipped)
        except ArtifactError as e:
            log("io-serve: a flipped byte in the params blob -> "
                "ArtifactError: %s", e)
        else:
            check(False, "io-serve: a flipped params byte booted a model")
        t_timing = time.perf_counter()
        timing = _interleaved_serve(
            torch, {"dense K=1": dense[1], "paged K=1": live,
                    "dense K=%d" % MEGA_SERVE_K: dense[MEGA_SERVE_K],
                    "paged K=%d" % MEGA_SERVE_K: paged8},
            sets["decode-heavy"], "io-dense decode-heavy", smi,
            traced=("dense K=%d" % MEGA_SERVE_K,
                    "paged K=%d" % MEGA_SERVE_K))
        log("io-dense: timing and traces took %.1f s; %d near-tie(s) where "
            "the dense engine parted from the paged one%s",
            time.perf_counter() - t_timing, len(near_ties),
            "".join("\n  " + t for t in near_ties))
    finally:
        for eng in engines:
            eng.close()
    return total, near_ties, timing, cold_s


IO_TF_REQS, IO_TF_STEPS = 4, 64    # teacher-forced rows of the bf16 check


def _forced_logits(torch, model, toks):
    """[len(toks), V] fp32 logits of one row fed ``toks`` step by step."""
    state = model._init_state(1)
    rows = []
    with torch.no_grad():
        for t, tok in enumerate(toks):
            lg, state = model._step_logits(
                torch.tensor([tok], device=model.device), state, t)
            rows.append(lg.float()[0])
    return torch.stack(rows)


def _dir_mb(d):
    return sum(os.path.getsize(os.path.join(d, f))
               for f in os.listdir(d)) / 1e6


def io_specialize_phase(torch, smi, tmp, scope, plain_art):
    """(d) The specialized artifacts. The fused ops' sweep cases
    (``tools/op_sweep.py`` part "fused") on the card against the CPU.
    ``save_lm_artifact`` with its
    defaults (``specialize=True``) and with ``bf16=True`` writes the LM's
    forward program from the trained scope on the card (constant folding
    runs there); the op counts before and after and what each pass
    removed or fused are logged. ``verify_bitwise`` holds the specialize
    pipeline on the card: the specialized program's logits bitwise the
    source program's over 2 steps of batch 32 x 256. Engines booted from
    the specialized, the bf16 and (b)'s plain artifact, and a source
    engine over ``from_program`` on the live scope, serve both request
    sets: paged launches exactly n_layer x (decode steps run + prefill
    chunks) each; the specialized engine's tokens and scores bitwise the
    source engine's. The bf16 artifact's model (bf16-rounded weights,
    fp32 compute) is held against the fp32 one on IO_TF_REQS rows of
    IO_TF_STEPS teacher-forced steps: its largest logit gap over
    max(1, max|logit|) within the CONTROL's, the bf16 serving model
    (``dtype=bfloat16``: weights, activations and KV in bf16) over the
    same scope. The cold start of each artifact is timed, and the plain,
    specialized and bf16 artifacts' engines timed A/B/C on the
    decode-heavy set. Returns (paged launches, timing, cold starts)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import io as IO
    from paddle_tpu_torch.models import transformer as T
    from paddle_tpu_torch.models.transformer_infer import TransformerLMInfer
    from paddle_tpu_torch.serving import Engine, save_lm_artifact
    from paddle_tpu_torch.tools import op_sweep
    from paddle_tpu_torch.transform import (specialize_for_inference,
                                            verify_bitwise)
    held, worst = op_sweep.run("cuda", part="fused")
    check(held == {"fused_matmul_bias_act", "fused_scale_cast"}, "io-spec: "
          "the op sweep held %s", sorted(held))
    log("io-spec: the fused ops (mul and conv2d anchors with bias and "
        "activation, a cast/scale pair) on the card against the CPU, "
        "forward and gradients: largest forward difference %.3g", worst)
    main, startup, _, logits = _io_lm(fluid, T, adam=False)
    arts = {"plain artifact": plain_art}
    for label, kw in (("specialized", {}), ("bf16 artifact", {"bf16": True})):
        d = os.path.join(tmp, label.replace(" ", "-"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_lm_artifact(d, main, scope, [logits], N_LAYER, N_HEAD, D_MODEL,
                         MAX_LEN, end_id=VOCAB, **kw)
        save_s = time.perf_counter() - t0
        man = IO.load_inference_manifest(d)
        tr = man["transform"]
        check(tr["ops_after"] < tr["ops_before"], "io-spec %s: the "
              "specialized program did not shrink: %s", label, tr)
        check(bool(kw) == bool(man["param_dtypes"]), "io-spec %s: bf16 "
              "params %s", label, sorted(man["param_dtypes"])[:3])
        log("io-spec: save_lm_artifact(%s) of the forward program from the "
            "trained scope on the card in %.3f s, %.1f MB: ops %d -> %d "
            "(pruned, then per pass removed or rewritten %s; fused "
            "patterns %s); bf16 cast sites %s, %d params stored bfloat16",
            ", ".join("%s=%s" % kv for kv in kw.items()) or "defaults",
            save_s, _dir_mb(d), tr["ops_before"], tr["ops_after"],
            tr["passes"], tr["patterns"], tr.get("bf16_sites"),
            len(man["param_dtypes"]))
        arts[label] = d
    exe = fluid.Executor(fluid.CUDAPlace(0))
    feeds = [v.name for v in main.list_vars() if v.is_data]
    spec = specialize_for_inference(main, feeds, [logits.name],
                                    device=exe.device)
    ok, detail = verify_bitwise(
        main, startup, lambda rng: T.make_lm_batch(rng, TRAIN_BATCH,
                                                   MAX_LEN, VOCAB),
        [logits.name], spec.program, steps=2, place=fluid.CUDAPlace(0))
    check(ok, "io-spec: verify_bitwise of the specialize pipeline on the "
          "card: %s", detail)
    log("io-spec: verify_bitwise on the card: the specialized program "
        "(%d ops) gives the source program's logits bitwise over 2 steps of "
        "batch %d x %d", len(spec.program.global_block().ops), TRAIN_BATCH,
        MAX_LEN)

    sets = {"mixed": _requests(np.random.default_rng(0)),
            "decode-heavy": _decode_heavy_requests(np.random.default_rng(1))}
    probe = ([1] + np.random.default_rng(5).integers(3, VOCAB, 40).tolist(),
             8)
    live_model = TransformerLMInfer.from_program(
        main, scope, N_LAYER, N_HEAD, D_MODEL, MAX_LEN, end_id=VOCAB)
    engines, cold = {}, {}
    try:
        for label, d in arts.items():
            engines[label], cold[label], out = _cold_start(torch, Engine, d,
                                                           probe)
            check(engines[label].model.device.type == "cuda", "io-spec: the "
                  "%s engine's model is not on the card", label)
            log("io-spec: cold start Engine(<%s dir>) -> first token of a "
                "%d-token prompt %.3f s (%.1f MB, no warmup)", label,
                len(probe[0]), cold[label], _dir_mb(arts[label]))
        engines["source"] = Engine(live_model, slots=32, prefill_chunk=16,
                                   block_size=16)
        for eng in engines.values():
            eng.warmup(sampled=False)
        total = 0
        for set_name, reqs in sets.items():
            outs = {}
            for label, eng in engines.items():
                out, d, launches, wall = _serve_counted(torch, eng, reqs)
                want = N_LAYER * (d["decode_steps_run"] + d["prefill_chunks"])
                check(launches == want, "io-spec %s %s: paged launches %d != "
                      "n_layer x (decode steps run + prefill chunks) = %d",
                      set_name, label, launches, want)
                total += launches
                outs[label] = out
                log("io-spec %s (%s engine): %d requests, %d tokens in %.3f "
                    "s; paged launches %d", set_name, label, len(out),
                    sum(len(t) for t, _ in out), wall, launches)
            for label in ("specialized", "plain artifact"):
                check(outs[label] == outs["source"], "io-spec %s: the %s "
                      "engine's tokens or scores differ from the source "
                      "engine's", set_name, label)
            same = sum(a == b for (a, _), (b, _) in
                       zip(outs["bf16 artifact"], outs["source"]))
            check(all(len(a) == len(b) for (a, _), (b, _) in
                      zip(outs["bf16 artifact"], outs["source"])),
                  "io-spec %s: the bf16 engine's outputs have other lengths",
                  set_name)
            log("io-spec %s: the specialized engine's tokens and scores "
                "bitwise the source engine's (%d requests); the bf16 "
                "artifact engine's greedy tokens equal on %d of %d requests",
                set_name, len(reqs), same, len(reqs))
        control = TransformerLMInfer.from_program(
            main, scope, N_LAYER, N_HEAD, D_MODEL, MAX_LEN, end_id=VOCAB,
            dtype=torch.bfloat16)
        rng = np.random.default_rng(9)
        gaps = []
        for r in range(IO_TF_REQS):
            toks = [1] + rng.integers(3, VOCAB, IO_TF_STEPS - 1).tolist()
            ref = _forced_logits(torch, live_model, toks)
            scale = max(1.0, float(ref.abs().max()))
            art = _forced_logits(torch, engines["bf16 artifact"].model, toks)
            ctl = _forced_logits(torch, control, toks)
            gaps.append((float((art - ref).abs().max()) / scale,
                         float((ctl - ref).abs().max()) / scale))
        worst = max(a for a, _ in gaps)
        limit = max(c for _, c in gaps)
        check(worst <= limit, "io-spec: the bf16 artifact's logits part from "
              "the fp32 model's by %.4g of max(1, max|logit|), beyond the "
              "control's %.4g (the bf16 serving model)", worst, limit)
        log("io-spec: bf16 artifact vs fp32 over %d rows x %d teacher-forced "
            "steps: largest logit gap %s of max(1, max|logit|); the control "
            "(the bf16 serving model over the same scope) %s; limit %.4g",
            IO_TF_REQS, IO_TF_STEPS, " ".join("%.4g" % a for a, _ in gaps),
            " ".join("%.4g" % c for _, c in gaps), limit)
        timing = _interleaved_serve(
            torch, {k: engines[k] for k in ("plain artifact", "specialized",
                                            "bf16 artifact")},
            sets["decode-heavy"], "io-spec decode-heavy", smi, traced=())
    finally:
        for eng in engines.values():
            eng.close()
    return total, timing, cold


AMP_STEPS = 6
AMP_SEEDS = (70, 170, 270, 370)    # batch i of a seed: RandomState(seed + i)
# limits on the AMP run's gap from fp32 over the control's (the same AMP
# run on the plain attention version), placed from 10 seeds x 6 steps on
# an H100 80GB HBM3 at 700 W (PERF.md): the mean loss gap over 4 seeds'
# steps, whose readings over every 4 of the 10 seeds spread 0.72-1.79x,
# and each seed's weights gap, 0.98-1.02x
AMP_LOSS_X, AMP_WEIGHTS_X = 2.5, 1.25


def io_amp_phase(torch, smi):
    """(e) AMP training: for each of AMP_SEEDS, AMP_STEPS Adam steps of the
    packed LM, batch 32 x 256, from one startup scope: fp32, under
    ``amp.amp_guard()`` (the products on bf16 operands, the flash kernels
    launched in bf16: their launches counted by dtype), and the same AMP
    run with the plain attention version (the CONTROL: the same precision,
    the attention computed in fp32 from bf16 q, k, v and rounded to bf16,
    as the kernels do); for the first seed also ``ParallelExecutor`` at
    one rank with ``DistributedStrategy(use_bf16_compute=True)``, bitwise
    the AMP run. One seed's loss gap is AMP rounding noise that any
    one-ulp change redraws, so the losses are held over all seeds and
    steps: their mean gap from fp32 at most AMP_LOSS_X times the
    control's; each seed's weights (relative norm of the difference) at
    most AMP_WEIGHTS_X times the control's. Returns {flash kernel:
    launches}, and the bf16 launches."""
    import collections
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import amp, parallel
    from paddle_tpu_torch.models import transformer as T
    from paddle_tpu_torch.ops import flash_attention as F
    exe = fluid.Executor(fluid.CUDAPlace(0))
    main, startup, avg_cost, _ = _io_lm(fluid, T)
    init = _init_of(fluid, exe, startup)
    names = sorted(init)
    by_dtype = collections.Counter()

    def tally(name):
        def wrap(real):
            def counted(q, *args):
                by_dtype["flash_" + name[1:-5], str(q.dtype)[6:]] += 1
                return real(q, *args)
            return counted
        return wrap

    def run(batches, use_amp, plain=False, pexe=False):
        scope = _scope_from(fluid, init, exe.device)
        by_dtype.clear()
        with contextlib.ExitStack() as stack:
            for fn in ("_fwd_cuda", "_bwd_dq_cuda", "_bwd_dkv_cuda"):
                stack.enter_context(_patched(F, fn, tally(fn)))
            if plain:
                stack.enter_context(_patched(F, "_route", _plain_route))
            if use_amp and not pexe:
                stack.enter_context(amp.amp_guard(True))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _reset_launches()
            if pexe:
                p = fluid.ParallelExecutor(
                    loss_name=avg_cost.name, main_program=main, scope=scope,
                    mesh=parallel.make_mesh({"dp": 1}),
                    strategy=parallel.DistributedStrategy(
                        use_bf16_compute=True))
                losses = [float(p.run([avg_cost], feed=b)[0])
                          for b in batches]
            else:
                losses = [float(exe.run(main, feed=b, fetch_list=[avg_cost],
                                        scope=scope)[0]) for b in batches]
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0) / len(batches)
        counts = {k: v for k, v in _launches().items()
                  if k.startswith("flash_")}
        check(np.isfinite(losses).all(), "io-amp: losses %s", losses)
        check(not amp.amp_enabled(), "io-amp: AMP left on")
        return losses, {n: scope.find_var(n) for n in names}, counts, \
            dict(by_dtype), ms

    def wgap(weights, w32):
        diff = sum(float(torch.sum((weights[n].float() - w32[n].float())
                                   ** 2)) for n in names)
        norm = sum(float(torch.sum(w32[n].float() ** 2)) for n in names)
        return (diff / norm) ** 0.5

    want = N_LAYER * AMP_STEPS
    counts, bf16 = collections.Counter(), collections.Counter()
    amp_gaps, ctl_gaps = [], []
    for seed in AMP_SEEDS:
        batches = [T.make_lm_batch(np.random.RandomState(seed + i),
                                   TRAIN_BATCH, MAX_LEN, VOCAB)
                   for i in range(AMP_STEPS)]
        l32, w32, c32, d32, ms32 = run(batches, False)
        l16, w16, c16, d16, ms16 = run(batches, True)
        lp, wp, cp, _, msp = run(batches, True, plain=True)
        for key in FLASH_KERNELS:
            check(c32[key] == want and d32.get((key, "float32")) == want,
                  "io-amp fp32: %s launches %d (%s), want %d float32", key,
                  c32[key], d32, want)
            check(c16[key] == want and d16.get((key, "bfloat16")) == want,
                  "io-amp: %s launches %d (%s), want %d bfloat16", key,
                  c16[key], d16, want)
            check(cp[key] == 0, "io-amp control: %d %s launches", cp[key],
                  key)
        counts.update({k: c32[k] + c16[k] for k in FLASH_KERNELS})
        bf16.update({k: c16[k] for k in FLASH_KERNELS})
        amp_gaps += [abs(a - b) for a, b in zip(l16, l32)]
        ctl_gaps += [abs(a - b) for a, b in zip(lp, l32)]
        wg16, wgp = wgap(w16, w32), wgap(wp, w32)
        check(0 < wgp and wg16 <= AMP_WEIGHTS_X * wgp, "io-amp seed %d: AMP "
              "on the flash kernels moves the weights %.4g from fp32 "
              "(relative norm), the control %.4g: beyond %.2f x", seed, wg16,
              wgp, AMP_WEIGHTS_X)
        log("io-amp seed %d: losses fp32 %s | AMP %s | control (AMP, plain "
            "attention) %s; weights from fp32 %.4g, control %.4g (%.3f x); "
            "ms a step (eager, the first with its warm-up) %.3f / %.3f / "
            "%.3f; flash launches by dtype %s", seed,
            " ".join("%.6f" % x for x in l32), " ".join("%.6f" % x
                                                       for x in l16),
            " ".join("%.6f" % x for x in lp), wg16, wgp, wg16 / wgp, ms32,
            ms16, msp, d16)
        if seed == AMP_SEEDS[0]:
            lx, wx, cx, dx, msx = run(batches, True, pexe=True)
            for key in FLASH_KERNELS:
                check(cx[key] == want and dx.get((key, "bfloat16")) == want,
                      "io-amp pexe: %s launches %d (%s), want %d bfloat16",
                      key, cx[key], dx, want)
            check(lx == l16 and all(torch.equal(wx[n], w16[n])
                                    for n in names),
                  "io-amp: ParallelExecutor(use_bf16_compute=True) losses "
                  "%s differ from the AMP run's %s", lx, l16)
            counts.update({k: cx[k] for k in FLASH_KERNELS})
            bf16.update({k: cx[k] for k in FLASH_KERNELS})
    g16 = sum(amp_gaps) / len(amp_gaps)
    gp = sum(ctl_gaps) / len(ctl_gaps)
    check(0 < gp and g16 <= AMP_LOSS_X * gp, "io-amp: AMP on the flash "
          "kernels parts from fp32 by a mean loss gap of %.4g over %d seeds "
          "x %d steps, the control by %.4g: beyond %.2f x", g16,
          len(AMP_SEEDS), AMP_STEPS, gp, AMP_LOSS_X)
    log("io-amp: over %d seeds x %d steps AMP on the flash kernels parts "
        "from fp32 by a mean loss gap of %.4g, the control by %.4g (%.3f x, "
        "limit %.2f); ParallelExecutor(use_bf16_compute=True) bitwise the "
        "AMP run; %s", len(AMP_SEEDS), AMP_STEPS, g16, gp, g16 / gp,
        AMP_LOSS_X, smi)
    return dict(counts), dict(bf16)


def io_phase(torch, smi):
    """Phase 11: checkpoint resume, artifact cold start, the dense layout,
    the specialized and bf16 artifacts, AMP training. Returns ({kernel:
    launches}, timing, the specialized artifacts' timing and cold
    starts, the bf16 flash launches)."""
    import tempfile
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_io_") as tmp:
        flash, scope = io_resume_phase(torch, smi, tmp)
        t1 = time.perf_counter()
        paged, _, timing, _ = io_serve_phase(torch, smi, tmp, scope)
        t2 = time.perf_counter()
        spec_paged, spec_timing, cold = io_specialize_phase(
            torch, smi, tmp, scope, os.path.join(tmp, "artifact"))
        del scope
        t3 = time.perf_counter()
        amp_flash, amp_bf16 = io_amp_phase(torch, smi)
    log("io: phase 11 took %.1f s (resume %.1f s, serve %.1f s, "
        "specialized artifacts %.1f s, AMP %.1f s)",
        time.perf_counter() - t0, t1 - t0, t2 - t1, t3 - t2,
        time.perf_counter() - t3)
    launches = {"flash_" + k: n for k, n in flash.items()}
    for k in launches:
        launches[k] += amp_flash[k]
    launches["paged_attention"] = paged + spec_paged
    return launches, timing, (spec_timing, cold), amp_bf16


# -- phase 12 ------------------------------------------------------------
OPTIONS_STEPS, OPTIONS_PAIRS, OPTIONS_EPS = 3, 3, 0.1
DROPOUT_RATE, DROPOUT_TRAIN_STEPS = 0.1, 10
# dropout launches per step of the dropout LM: the embedding's, then per
# layer the attention weights' and two residual ones, in the forward and
# again in the backward (which draws the mask again); with recompute
# regions the 3 a layer run a third time, in the recompute
DROPOUT_FWD = 1 + 3 * N_LAYER
DROPOUT_PER_STEP = {False: 2 * DROPOUT_FWD,
                    True: 2 * DROPOUT_FWD + 3 * N_LAYER}
# the reduced LM of the optimizer family: 2 layers, d_model 128, T 64
OPT_LM = dict(vocab_size=VOCAB, max_len=64, n_layer=2, n_head=N_HEAD,
              d_model=128, d_inner=512)
OPT_BATCH, OPT_STEPS, OPT_TOL = 8, 2, 2e-4


def _options_lm(fluid, T, recompute=False, dropout=0.0, checkpoint=False,
                cfg=None, make_opt=None):
    """The packed flagship LM with label smoothing and the given options,
    trained with Adam(1e-3) (``minimize``; with ``checkpoint``,
    ``append_backward(checkpoint=True)`` and ``apply_gradients``, which
    emit the same optimizer ops)."""
    cfg = cfg or dict(vocab_size=VOCAB, max_len=MAX_LEN, n_layer=N_LAYER,
                      n_head=N_HEAD, d_model=D_MODEL, d_inner=D_INNER)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        avg_cost, _ = T.transformer_lm(
            packed=True, recompute=recompute, dropout_rate=dropout,
            label_smooth_eps=OPTIONS_EPS, **cfg)
        opt = (make_opt or (lambda f: f.optimizer.Adam(1e-3)))(fluid)
        if checkpoint:
            pg = fluid.append_backward(avg_cost, checkpoint=True)
            opt.apply_gradients(sorted(pg, key=lambda x: x[0].name))
        else:
            opt.minimize(avg_cost)
    return main, startup, avg_cost


def _init_of(fluid, exe, startup):
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    return {n: scope.get_numpy(n) for n in scope.local_var_names()
            if scope.find_var(n) is not None}


def _counted_steps(torch, exe, prog, scope, batches):
    """Eager steps with the launch counts reset just before and read just
    after: (losses as floats, counts)."""
    main, _, avg_cost = prog
    _reset_launches()
    losses = [float(exe.run(main, feed=b, fetch_list=[avg_cost],
                            scope=scope)[0]) for b in batches]
    torch.cuda.synchronize()
    return losses, _launches()


def _same_state(torch, a, b, names):
    return [n for n in names if not torch.equal(a.find_var(n),
                                                b.find_var(n))]


def _graph_vs_eager(torch, fluid, prog, init, batches, what):
    """K run() calls against one run_steps(K) dispatch from copies of
    ``init``, each on a fresh executor (run seeds from counter 0; the
    graph captured by a warm call first, its counter set back): losses
    and every state tensor bitwise equal. Returns the dispatch's launch
    counts through its replay."""
    main, _, avg_cost = prog
    k = len(batches)
    eager = fluid.Executor(fluid.CUDAPlace(0))
    graph = fluid.Executor(fluid.CUDAPlace(0))
    t0 = time.perf_counter()
    graph.run_steps(main, feeds=batches, fetch_list=[avg_cost],
                    scope=_scope_from(fluid, init, graph.device))
    torch.cuda.synchronize()
    check(graph.stats["graph_captures"] == 1, "%s: no graph captured", what)
    log("%s: K=%d graph captured (warm-up step, capture, first replay) in "
        "%.3f s", what, k, time.perf_counter() - t0)
    graph._rng_counter = 0
    sa = _scope_from(fluid, init, eager.device)
    le = [float(eager.run(main, feed=b, fetch_list=[avg_cost],
                          scope=sa)[0]) for b in batches]
    sb = _scope_from(fluid, init, graph.device)
    _reset_launches()
    out = graph.run_steps(main, feeds=batches, fetch_list=[avg_cost],
                          scope=sb)
    torch.cuda.synchronize()
    counts = _launches()
    lg = [float(o[0]) for o in out]
    check(graph.stats["graph_replays"] == 2, "%s: %d replays for 2 "
          "dispatches", what, graph.stats["graph_replays"])
    differ = _same_state(torch, sa, sb, sorted(init))
    check(lg == le and not differ, "%s: run_steps(K=%d) is not bitwise "
          "equal to %d run() calls: losses %s vs %s, %d state tensors "
          "differ (first %s)", what, k, k, lg, le, len(differ), differ[:1])
    log("%s: %d run() calls vs one run_steps(K=%d) dispatch: losses %s "
        "bitwise equal, every one of %d state tensors bitwise equal; "
        "launches through the replay %s", what, k, k,
        " ".join("%.6f" % x for x in le), len(init),
        {n: c for n, c in counts.items() if c})
    return counts, eager, graph, sa, sb


def options_flash_phase(torch, smi):
    """(a) Configuration A: transformer_lm(packed=True, recompute=True,
    label_smooth_eps=0.1) with Adam(1e-3) at full width, against the same
    model without recompute, from one startup scope."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import transformer as T
    exe = fluid.Executor(fluid.CUDAPlace(0))
    progs = {rc: _options_lm(fluid, T, recompute=rc) for rc in (True, False)}
    ops = progs[True][0].global_block().ops
    check(sum(op.type == "recompute_block" for op in ops) == N_LAYER,
          "the recompute program has no region per layer")
    init = _init_of(fluid, exe, progs[True][1])
    names = sorted(init)
    batches = [T.make_lm_batch(np.random.RandomState(60 + i), TRAIN_BATCH,
                               MAX_LEN, VOCAB) for i in range(5)]
    runs, totals = {}, {}
    for rc in (True, False):
        scope = _scope_from(fluid, init, exe.device)
        _gc_collect(torch)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        losses, counts = _counted_steps(torch, exe, progs[rc], scope,
                                        batches[:OPTIONS_STEPS])
        peak = torch.cuda.max_memory_allocated()
        runs[rc] = (losses, scope, peak, base)
        for key, per in (("flash_fwd", 2 if rc else 1),
                         ("flash_bwd_dq", 1), ("flash_bwd_dkv", 1)):
            want = per * N_LAYER * OPTIONS_STEPS
            check(counts[key] == want, "options-flash (recompute=%s): %s "
                  "launches %d != %d", rc, key, counts[key], want)
            totals[key] = totals.get(key, 0) + counts[key]
        check(all(np.isfinite(losses)), "options-flash: losses not finite")
        log("options-flash (recompute=%s): %d Adam steps, losses %s; flash "
            "launches %s; peak device memory %.1f MB (%.1f MB held before "
            "the steps); %s", rc, OPTIONS_STEPS,
            " ".join("%.6f" % x for x in losses),
            {k: v for k, v in counts.items() if v}, peak / 1e6, base / 1e6,
            smi)
    differ = _same_state(torch, runs[True][1], runs[False][1], names)
    check(runs[True][0] == runs[False][0] and not differ,
          "options-flash: recompute is not bitwise equal to the plain run: "
          "losses %s vs %s, %d persistables differ (first %s)",
          runs[True][0], runs[False][0], len(differ), differ[:1])
    # the steps' own peak: above what the card held before they began
    # (the other run's scope among it)
    above = {rc: runs[rc][2] - runs[rc][3] for rc in runs}
    check(above[True] < above[False], "options-flash: recompute's peak "
          "%d B above the held memory is not below the plain run's %d B",
          above[True], above[False])
    log("options-flash: recompute bitwise equal to the plain run (losses "
        "and all %d persistables); peak device memory above what was held "
        "before the steps %.1f MB with recompute vs %.1f MB without: %.1f "
        "MB less", len(names), above[True] / 1e6, above[False] / 1e6,
        (above[False] - above[True]) / 1e6)
    # step ms, recompute / plain in A/B/A/B order
    scopes = {rc: _scope_from(fluid, init, exe.device) for rc in (True,
                                                                  False)}
    ms = {True: [], False: []}
    for _ in range(OPTIONS_PAIRS):
        for rc in (True, False):
            main, _, avg_cost = progs[rc]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for b in batches[:OPTIONS_STEPS]:
                exe.run(main, feed=b, fetch_list=[avg_cost],
                        scope=scopes[rc])
            torch.cuda.synchronize()
            ms[rc].append(1e3 * (time.perf_counter() - t0) / OPTIONS_STEPS)
    step_ms = {rc: _median(ms[rc]) for rc in ms}
    log("options-flash timing (%d pairs interleaved, %d steps each): step "
        "ms with recompute %s (median %.3f), without %s (median %.3f); "
        "recompute / plain %.3f; %s", OPTIONS_PAIRS, OPTIONS_STEPS,
        " ".join("%.3f" % x for x in ms[True]), step_ms[True],
        " ".join("%.3f" % x for x in ms[False]), step_ms[False],
        step_ms[True] / step_ms[False], smi)
    counts, _, gexe, _, gscope = _graph_vs_eager(
        torch, fluid, progs[True], init, batches, "options-flash graph")
    for key, per in (("flash_fwd", 2), ("flash_bwd_dq", 1),
                     ("flash_bwd_dkv", 1)):
        check(counts[key] == per * N_LAYER * len(batches), "options-flash "
              "graph: %s launches %d through the replay != %d", key,
              counts[key], per * N_LAYER * len(batches))
        totals[key] += counts[key]
    # the same A/B/A/B under the graphs: device time, the host's share
    # removed (the plain program's graph captured by a first call)
    scopes = {True: gscope, False: _scope_from(fluid, init, gexe.device)}
    main, _, avg_cost = progs[False]
    gexe.run_steps(main, feeds=batches, fetch_list=[avg_cost],
                   scope=scopes[False])
    gms = {True: [], False: []}
    for _ in range(OPTIONS_PAIRS):
        for rc in (True, False):
            main, _, avg_cost = progs[rc]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            gexe.run_steps(main, feeds=batches, fetch_list=[avg_cost],
                           scope=scopes[rc])
            torch.cuda.synchronize()
            gms[rc].append(1e3 * (time.perf_counter() - t0) / len(batches))
    graph_ms = {rc: _median(gms[rc]) for rc in gms}
    log("options-flash timing under run_steps(K=%d) graphs (%d pairs "
        "interleaved): step ms with recompute %s (median %.3f), without %s "
        "(median %.3f); recompute / plain %.3f; %s", len(batches),
        OPTIONS_PAIRS, " ".join("%.3f" % x for x in gms[True]),
        graph_ms[True], " ".join("%.3f" % x for x in gms[False]),
        graph_ms[False], graph_ms[True] / graph_ms[False], smi)
    # one checkpoint=True step against the plain step
    ckpt = _options_lm(fluid, T, checkpoint=True)
    sa = _scope_from(fluid, init, exe.device)
    sb = _scope_from(fluid, init, exe.device)
    la, _ = _counted_steps(torch, exe, progs[False], sa, batches[:1])
    lb, _ = _counted_steps(torch, exe, ckpt, sb, batches[:1])
    differ = _same_state(torch, sa, sb, names)
    check(la == lb and not differ, "options-flash: the checkpoint=True "
          "step is not bitwise equal to the plain step: %s vs %s, %d "
          "persistables differ", lb, la, len(differ))
    log("options-flash: one append_backward(checkpoint=True) step bitwise "
        "equal to the plain step (loss %.6f, %d persistables)", la[0],
        len(names))
    return totals, {"peak_mb": {"recompute": above[True] / 1e6,
                                "plain": above[False] / 1e6},
                    "step_ms": {"recompute": step_ms[True],
                                "plain": step_ms[False]},
                    "graph_step_ms": {"recompute": graph_ms[True],
                                      "plain": graph_ms[False]}}


def _gc_collect(torch):
    import gc
    gc.collect()
    torch.cuda.synchronize()


DROPOUT_CASES = [((TRAIN_BATCH, MAX_LEN, D_MODEL), "float32", 0.1),
                 ((TRAIN_BATCH, N_HEAD, MAX_LEN, MAX_LEN), "float32", 0.1),
                 ((TRAIN_BATCH, N_HEAD, MAX_LEN, MAX_LEN), "float32", 0.5),
                 ((1_000_003,), "float32", 0.1), ((4099,), "float32", 0.5),
                 ((TRAIN_BATCH, MAX_LEN, D_MODEL), "bfloat16", 0.1),
                 ((TRAIN_BATCH, N_HEAD, MAX_LEN, MAX_LEN), "bfloat16", 0.5)]


def dropout_kernel_phase(torch):
    """(b) The dropout kernel against its plain version, bit for bit on
    Out and Mask, with and without the upscale factor and the mask, then
    timed at the attention-weight shape [32, 8, 256, 256] f32 (the LM's
    default downgrade_in_infer: no factor, no mask), device time alone
    and with the host's gaps, against the plain version, the bytes bound
    and torch.nn.functional.dropout (a yardstick the port never calls:
    its masks differ)."""
    from paddle_tpu_torch.ops import dropout as D
    compared, err = 0, 0.0
    for n, (shape, dtype, p) in enumerate(DROPOUT_CASES):
        g = torch.Generator().manual_seed(300 + n)
        x = torch.randn(shape, generator=g).to("cuda",
                                               getattr(torch, dtype))
        seed = torch.tensor(1000003 * 7 + n, device="cuda")
        for scale in (False, True):
            for want_mask in (False, True):
                out, mask = D._dropout_cuda(x, seed, n, p, scale, want_mask)
                pout, pmask = D._dropout_plain(x, seed, n, p, scale,
                                               want_mask)
                torch.cuda.synchronize()
                err = max(err, float((out.float() - pout.float()).abs()
                                     .max()))
                check(torch.equal(out, pout), "dropout kernel Out differs "
                      "from the plain version at %s %s p=%g scale=%s "
                      "mask=%s (%d elements differ)", shape, dtype, p,
                      scale, want_mask, int((out != pout).sum()))
                if want_mask:
                    check(torch.equal(mask, pmask), "dropout kernel Mask "
                          "differs from the plain version at %s %s p=%g",
                          shape, dtype, p)
                compared += 1
        keep = float(pmask.float().mean())
        log("dropout kernel: %s %s p=%g: Out and Mask bitwise equal to the "
            "plain version (4 variants); keep share %.5f", shape, dtype, p,
            keep)
    # two launches on the same inputs
    x = torch.randn(TRAIN_BATCH, N_HEAD, MAX_LEN, MAX_LEN, device="cuda")
    seed = torch.tensor(5, device="cuda")
    a = D._dropout_cuda(x, seed, 3, DROPOUT_RATE, False, True)
    b = D._dropout_cuda(x, seed, 3, DROPOUT_RATE, False, True)
    check(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]),
          "two dropout launches on the same inputs differ")
    # timing at the attention-weight shape: four inputs rotate through the
    # L2 (4 x 67 MB), as the layers of a step meet them
    xs = [torch.randn(TRAIN_BATCH, N_HEAD, MAX_LEN, MAX_LEN, device="cuda")
          for _ in range(4)]
    fd = torch.nn.functional.dropout

    def kern(i):
        D._dropout_cuda(xs[i % 4], seed, 3, DROPOUT_RATE, False, False)

    def lib(i):
        fd(xs[i % 4], DROPOUT_RATE, training=True)

    ms = _events_ms(torch, kern, 50, hide_host=True)
    gaps = _events_ms(torch, kern, 50)
    lib_ms = _events_ms(torch, lib, 50, hide_host=True)
    lib_gaps = _events_ms(torch, lib, 50)
    plain_ms = _events_ms(torch, lambda i: D._dropout_plain(
        xs[i % 4], seed, 3, DROPOUT_RATE, False, False), 5, hide_host=True)
    nbytes = 2 * xs[0].numel() * 4          # x read once, Out written once
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    log("timing dropout ([32, 8, 256, 256] f32, p=%g, no mask), device time "
        "alone: kernel_ms=%.5f bound_ms=%.5f (bytes: %d) plain_ms=%.5f "
        "library_ms=%.5f (F.dropout); with the host's gaps: kernel_ms=%.5f "
        "library_ms=%.5f; kernel / bound %.2f; %d comparisons bitwise",
        DROPOUT_RATE, ms, bound, nbytes, plain_ms, lib_ms, gaps, lib_gaps,
        ms / bound, compared)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "bytes", "library_ms": lib_ms,
            "ms_with_host_gaps": gaps, "library_ms_with_host_gaps": lib_gaps,
            "max_abs_err": err}


def options_dropout_phase(torch, smi):
    """(c) Configuration B: transformer_lm(packed=True, dropout_rate=0.1,
    label_smooth_eps=0.1) with Adam(1e-3) at full width: 10 eager steps,
    losses finite and falling; recompute against no recompute bitwise;
    5 run() calls against one run_steps(K=5) dispatch bitwise; dropout
    launches counted exactly; step ms eager and under the graph; one
    traced pass."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import transformer as T
    exe = fluid.Executor(fluid.CUDAPlace(0))
    progs = {rc: _options_lm(fluid, T, recompute=rc, dropout=DROPOUT_RATE)
             for rc in (False, True)}
    init = _init_of(fluid, exe, progs[False][1])
    names = sorted(init)
    fixed = [T.make_lm_batch(np.random.RandomState(seed), TRAIN_BATCH,
                             MAX_LEN, VOCAB) for seed in (0, 1)]
    total = 0
    scope = _scope_from(fluid, init, exe.device)
    losses, counts = _counted_steps(
        torch, exe, progs[False], scope,
        [fixed[i % 2] for i in range(DROPOUT_TRAIN_STEPS)])
    want = DROPOUT_PER_STEP[False] * DROPOUT_TRAIN_STEPS
    check(counts["dropout"] == want, "options-dropout: %d dropout launches "
          "!= %d", counts["dropout"], want)
    check(not any(counts[k] for k in ("flash_fwd", "flash_bwd_dq",
                                      "flash_bwd_dkv")),
          "options-dropout: the dropout LM launched a flash kernel")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          "options-dropout: losses not finite and falling: %s", losses)
    total += counts["dropout"]
    log("options-dropout: %d Adam steps over 2 fixed batches, losses %s; "
        "dropout launches %d (%d a step); %s", DROPOUT_TRAIN_STEPS,
        " ".join("%.4f" % x for x in losses), counts["dropout"],
        DROPOUT_PER_STEP[False], smi)
    batches = [T.make_lm_batch(np.random.RandomState(70 + i), TRAIN_BATCH,
                               MAX_LEN, VOCAB) for i in range(MEGA_TRAIN_K)]
    # contract (c): recompute against no recompute, fresh executors
    runs = {}
    for rc in (False, True):
        ex = fluid.Executor(fluid.CUDAPlace(0))
        scope = _scope_from(fluid, init, ex.device)
        losses, counts = _counted_steps(torch, ex, progs[rc], scope,
                                        batches[:OPTIONS_STEPS])
        want = DROPOUT_PER_STEP[rc] * OPTIONS_STEPS
        check(counts["dropout"] == want, "options-dropout (recompute=%s): "
              "%d dropout launches != %d", rc, counts["dropout"], want)
        total += counts["dropout"]
        runs[rc] = (losses, scope)
    differ = _same_state(torch, runs[True][1], runs[False][1], names)
    check(runs[True][0] == runs[False][0] and not differ,
          "options-dropout: recompute is not bitwise equal to no recompute:"
          " losses %s vs %s, %d persistables differ (first %s)",
          runs[True][0], runs[False][0], len(differ), differ[:1])
    log("options-dropout: %d steps with recompute bitwise equal to %d "
        "without (losses %s, all %d persistables); dropout launches %d and "
        "%d a step", OPTIONS_STEPS, OPTIONS_STEPS,
        " ".join("%.6f" % x for x in runs[True][0]), len(names),
        DROPOUT_PER_STEP[True], DROPOUT_PER_STEP[False])
    # contract (a): one run_steps(K=5) dispatch against 5 run() calls
    counts, eager, graph, sa, sb = _graph_vs_eager(
        torch, fluid, progs[False], init, batches, "options-dropout graph")
    want = DROPOUT_PER_STEP[False] * len(batches)
    check(counts["dropout"] == want, "options-dropout graph: %d dropout "
          "launches through the replay != %d", counts["dropout"], want)
    total += counts["dropout"]
    # step ms eager and under the graph, A/B/A/B
    main, _, avg_cost = progs[False]
    ms = {"eager": [], "graph": []}
    for _ in range(OPTIONS_PAIRS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in batches:
            eager.run(main, feed=b, fetch_list=[avg_cost], scope=sa)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        graph.run_steps(main, feeds=batches, fetch_list=[avg_cost],
                        scope=sb)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        ms["eager"].append(1e3 * (t1 - t0) / len(batches))
        ms["graph"].append(1e3 * (t2 - t1) / len(batches))
    step_ms = {k: _median(v) for k, v in ms.items()}
    log("options-dropout timing (%d pairs interleaved, %d steps each): step "
        "ms eager %s (median %.3f), graph %s (median %.3f); graph / eager "
        "%.3f; %s", OPTIONS_PAIRS, len(batches),
        " ".join("%.3f" % x for x in ms["eager"]), step_ms["eager"],
        " ".join("%.3f" % x for x in ms["graph"]), step_ms["graph"],
        step_ms["graph"] / step_ms["eager"], smi)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches[:OPTIONS_STEPS]:
            eager.run(main, feed=b, fetch_list=[avg_cost], scope=sa)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy, _ = _report_profile(prof, wall, "options-dropout profile (traced, "
                              "%d eager steps)" % OPTIONS_STEPS,
                              focus="dropout_kernel")
    return total, {"step_ms": step_ms, "busy": busy}


def _proximal_lm(fluid, T, op_type):
    """The reduced LM trained by one proximal rule per parameter (the JAX
    package has no class for these: its ops are appended as
    tests/test_ops_sweep2.py drives them)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        avg_cost, _ = T.transformer_lm(packed=True, **OPT_LM)
        pg = fluid.append_backward(avg_cost)
        blk = main.global_block()
        lr = fluid.layers.create_global_var([1], 0.05, "float32",
                                            persistable=True, name="prox_lr")
        for p, g in sorted(pg, key=lambda x: x[0].name):
            inputs = {"Param": [p.name], "Grad": [g.name],
                      "LearningRate": [lr.name]}
            outputs = {"ParamOut": [p.name]}
            if op_type == "proximal_adagrad":
                m = fluid.layers.create_global_var(
                    list(p.shape), 0.1, "float32", persistable=True,
                    name=p.name + "_prox_moment")
                inputs["Moment"] = [m.name]
                outputs["MomentOut"] = [m.name]
            blk.append_op(type=op_type, inputs=inputs, outputs=outputs,
                          attrs={"l1": 1e-3, "l2": 1e-3})
    return main, startup, avg_cost


def _ftrl64(p, sq, lin, g, lr, l1, l2, power):
    """One ftrl update in float64 (``ops/optimizer_ops.py``'s rule)."""
    sq_new = sq + g * g
    lin_new = lin + g - (sq_new ** -power - sq ** -power) / lr * p
    y = sq_new ** -power / lr + 2 * l2
    p_new = np.where(np.abs(lin_new) > l1,
                     (l1 * np.sign(lin_new) - lin_new) / y, 0.0)
    return p_new, sq_new, lin_new


def _ftrl_witness(fluid, cuda, cpu, prog, init, batches):
    """ftrl's control. Each path (the card, the CPU) runs the steps from
    ``init`` with every gradient fetched, and the float64 rule is applied
    along that path's own gradients from the same start. Returns {path:
    (losses, scope, {param: (the path's fp32 weight, its float64
    witness)})}."""
    main, _, avg_cost = prog
    ops = [op for op in main.global_block().ops if op.type == "ftrl"]
    grads = [op.input("Grad")[0] for op in ops]
    out = {}
    for path, exe in (("card", cuda), ("cpu", cpu)):
        scope = _scope_from(fluid, init, exe.device)
        state = {op.input("Param")[0]: [
            init[op.input(k)[0]].astype(np.float64)
            for k in ("Param", "SquaredAccumulator", "LinearAccumulator")]
            for op in ops}
        losses = []
        for b in batches:
            got = exe.run(main, feed=b, fetch_list=[avg_cost] + grads,
                          scope=scope)
            losses.append(float(got[0]))
            for op, g in zip(ops, got[1:]):
                p = op.input("Param")[0]
                lr = float(init[op.input("LearningRate")[0]].reshape(-1)[0])
                state[p] = list(_ftrl64(
                    *state[p], np.asarray(g, np.float64), lr,
                    op.attr("l1", 0.0), op.attr("l2", 0.0),
                    op.attr("lr_power", -0.5)))
        out[path] = (losses, scope, {p: (scope.get_numpy(p), s[0])
                                     for p, s in state.items()})
    return out


def _ftrl_limits(witness):
    """({path: the largest gap of its fp32 weights from its float64
    witness}, the float64 rule's own gap between the two paths' gradients,
    the limit for the card against the CPU: that gap plus OPT_TOL for
    each path), every gap over max(1, max|w|) of a tensor."""
    def gap(a, b):
        return float(np.abs(a - b).max()) / max(1.0, float(np.abs(b).max()))
    own = {path: max(gap(w32, w64) for w32, w64 in w[2].values())
           for path, w in witness.items()}
    card, cpu = witness["card"][2], witness["cpu"][2]
    rule = max(gap(card[p][1], cpu[p][1]) for p in cpu)
    return own, rule, rule + 2 * OPT_TOL


def options_optimizer_phase(torch):
    """(d) The optimizer family on the reduced LM (2 layers, d_model 128,
    T 64, batch 8, vocab 4096): each of the nine update rules and the
    three gradient clips with L2 decay, 2 steps on the card against the
    port's CPU path from the same startup values, losses and every
    persistable within 2e-4 of max(1, max|w|) (ftrl against its float64
    witness: ``_ftrl_witness``); ModelAverage's apply / restore round trip
    bitwise."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import transformer as T
    cuda = fluid.Executor(fluid.CUDAPlace(0))
    cpu = fluid.Executor(fluid.CPUPlace())
    batches = [T.make_lm_batch(np.random.RandomState(80 + i), OPT_BATCH,
                               OPT_LM["max_len"], VOCAB)
               for i in range(OPT_STEPS)]
    l2 = lambda f: f.regularizer.L2Decay(1e-4)  # noqa: E731
    cases = [
        # the rules that divide by |g| (adagrad, decayed_adagrad, adamax)
        # carry the card's and the CPU's gradient rounding (~1e-8 on
        # weights whose gradient sums to near zero) into the weights
        # times lr / epsilon; at lr / epsilon <= 1e4 that stays ~1e-4, so
        # a 2e-4 gap is the rule's, not the summation order's (decayed
        # adagrad at lr 0.05, epsilon 1e-6 parted by 5.4e-4 on an H100
        # 80GB HBM3 at 700 W)
        ("adagrad", lambda f: f.optimizer.Adagrad(0.01)),
        # epsilon 1e-6, as the other rules' defaults: at Adamax's 1e-8 the
        # first step moves every weight by lr x sign(g) once |g| > 1e-8,
        # so a gradient that sums to within rounding of zero (its sign
        # set by the summation order) moves its weight 2 lr apart between
        # the card and the CPU (0.0104 of max(1, max|w|) on an H100 80GB
        # HBM3 at 700 W)
        ("adamax", lambda f: f.optimizer.Adamax(0.01, epsilon=1e-6)),
        ("decayed_adagrad", lambda f: f.optimizer.DecayedAdagrad(0.01)),
        ("adadelta", lambda f: f.optimizer.Adadelta(1.0)),
        ("rmsprop", lambda f: f.optimizer.RMSProp(0.01, momentum=0.5)),
        # ftrl divides its linear accumulator by sqrt(n) / lr + 2 l2: an
        # element with a tiny gradient carries the card's and the CPU's
        # rounding of that gradient into its weight many times over, so
        # each path is held to the float64 rule along its own gradients,
        # and the gap between them to the float64 rule's own gap
        # (_ftrl_witness)
        ("ftrl", lambda f: f.optimizer.Ftrl(0.05, l1=1e-3, l2=1e-3)),
        ("proximal_gd", None), ("proximal_adagrad", None),
        ("average_accumulates", lambda f: f.optimizer.SGD(0.1)),
        ("clip_by_value+l2", lambda f: f.optimizer.SGD(
            0.1, regularization=l2(f))),
        ("clip_by_norm+l2", lambda f: f.optimizer.SGD(
            0.1, regularization=l2(f))),
        ("clip_by_global_norm+l2", lambda f: f.optimizer.SGD(
            0.1, regularization=l2(f))),
    ]
    clips = {"clip_by_value+l2": lambda f: f.clip.GradientClipByValue(0.01),
             "clip_by_norm+l2": lambda f: f.clip.GradientClipByNorm(0.05),
             "clip_by_global_norm+l2":
                 lambda f: f.clip.GradientClipByGlobalNorm(0.1)}
    worst = 0.0
    for name, make in cases:
        average = None
        if make is None:
            prog = _proximal_lm(fluid, T, name)
        else:
            main, startup = fluid.Program(), fluid.Program()
            with fluid.program_guard(main, startup), \
                    fluid.unique_name.guard():
                avg_cost, _ = T.transformer_lm(packed=True, **OPT_LM)
                if name in clips:
                    fluid.clip.set_gradient_clip(clips[name](fluid))
                make(fluid).minimize(avg_cost)
                if name == "average_accumulates":
                    average = fluid.optimizer.ModelAverage(
                        0.5, min_average_window=2, max_average_window=3)
            prog = (main, startup, avg_cost)
        op_type = name.split("+")[0]
        types = {op.type for op in prog[0].global_block().ops}
        want = {"clip_by_value": "clip", "clip_by_norm": "clip_by_norm",
                "clip_by_global_norm": "elementwise_max"}.get(op_type,
                                                              op_type)
        check(want in types, "optimizer %s: no %s op in the program", name,
              want)
        init = _init_of(fluid, cpu, prog[1])
        witness = None
        if name == "ftrl":
            witness = _ftrl_witness(fluid, cuda, cpu, prog, init, batches)
            (lg, sg, _), (lc, sc, _) = witness["card"], witness["cpu"]
        else:
            sg = _scope_from(fluid, init, cuda.device)
            sc = _scope_from(fluid, init, cpu.device)
            lg, _ = _counted_steps(torch, cuda, prog, sg, batches)
            lc = [float(cpu.run(prog[0], feed=b, fetch_list=[prog[2]],
                                scope=sc)[0]) for b in batches]
        apart = max(abs(a - b) / max(1.0, abs(b)) for a, b in zip(lg, lc))
        for n in init:
            a, b = sg.get_numpy(n), sc.get_numpy(n)
            if a.dtype.kind == "f":
                apart = max(apart, float(np.abs(a - b).max())
                            / max(1.0, float(np.abs(b).max())))
            else:
                check(np.array_equal(a, b), "optimizer %s: %s differs", name,
                      n)
        msg, limit = "", OPT_TOL
        if witness is not None:
            own, rule, limit = _ftrl_limits(witness)
            msg = ("; each path within %.3g (card) and %.3g (CPU) of float64 "
                   "ftrl along its own gradients (limit %g), the float64 "
                   "rule's own gap %.3g" % (own["card"], own["cpu"], OPT_TOL,
                                            rule))
            for path, gap in own.items():
                check(gap <= OPT_TOL, "optimizer ftrl: the %s path is %g "
                      "from float64 ftrl along its own gradients (limit %g)",
                      path, gap, OPT_TOL)
        check(apart <= limit, "optimizer %s: the card is %g apart from "
              "the CPU path (limit %g)", name, apart, limit)
        worst = max(worst, apart)
        if average is not None:
            params = [p.name for p, _ in average.params_grads]
            before = {n: sg.find_var(n).clone() for n in params}
            held = {n: sg.find_var(n) for n in params}
            average.apply(cuda, scope=sg)
            gavg = {n: sg.get_numpy(n) for n in params}
            average.restore(cuda)
            average.apply(cpu, scope=sc)
            for n in params:
                b = sc.get_numpy(n)
                check(float(np.abs(gavg[n] - b).max())
                      <= OPT_TOL * max(1.0, float(np.abs(b).max())),
                      "ModelAverage.apply: %s on the card differs from the "
                      "CPU path", n)
            average.restore(cpu)
            check(all(sg.find_var(n) is held[n]
                      and torch.equal(held[n], before[n]) for n in params),
                  "ModelAverage.restore did not give back the parameters "
                  "bitwise")
            msg += "; ModelAverage apply/restore round trip bitwise (%d " \
                "params)" % len(params)
        log("optimizer %s: %d steps on the card, losses %s, within %.3g of "
            "the CPU path (limit %g)%s", name, OPT_STEPS,
            " ".join("%.6f" % x for x in lg), apart, OPT_TOL, msg)
    return worst


def options_phase(torch, smi):
    """Phase 12: the flagship's training options. Returns (flash launches
    of configuration A's counted runs, dropout launches of
    configuration B's, the dropout kernel's times)."""
    flash, _ = options_flash_phase(torch, smi)
    times = dropout_kernel_phase(torch)
    drops, _ = options_dropout_phase(torch, smi)
    options_optimizer_phase(torch)
    return flash, drops, times


# -- phase 13 ------------------------------------------------------------
# the machine-translation transformer at transformer()'s own defaults
# (models/transformer.py), beam search and the decode graphs, the flagship
# LM's generate, the mnist models and VGG-16
MT = dict(src_vocab_size=4096, trg_vocab_size=4096, max_len=64, n_layer=2,
          n_head=8, d_model=256, d_inner=1024)
MT_BATCH, MT_STEPS, MT_K = 64, 10, 5
MT_SHAPE = (MT_BATCH, MT["n_head"], MT["max_len"],
            MT["d_model"] // MT["n_head"])          # [64, 8, 64, 32]
MT_SRC, MT_BEAM = 16, 4
SCORE_TOL = 1e-4          # a returned score vs its teacher-forced sum
GEN_BATCH, GEN_BEAM, GEN_LEN = 8, 4, 128
ZOO_BATCH, ZOO_STEPS = 64, 5
DECODE_PAIRS = 2


def _mt_program(fluid, T, packed):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        avg_cost, _ = T.transformer(packed=packed, **MT)
        fluid.optimizer.Adam(learning_rate=1e-3).minimize(avg_cost)
    return main, startup, avg_cost


def _mt_batch(seed, batch=MT_BATCH):
    """A copy task at full length: the target is the source behind BOS
    (1), the labels the source; every mask is ones (packed sentences)."""
    rng = np.random.RandomState(seed)
    t, v = MT["max_len"], MT["src_vocab_size"]
    src = rng.randint(3, v, (batch, t)).astype(np.int64)
    pos = np.tile(np.arange(t, dtype=np.int64), (batch, 1))
    ones = np.ones((batch, t), np.float32)
    trg = np.concatenate([np.ones((batch, 1), np.int64), src[:, :-1]], 1)
    return {"src_word": src, "src_pos": pos, "src_mask": ones,
            "trg_word": trg, "trg_pos": pos, "trg_mask": ones,
            "lbl_word": src}


def mt_train_phase(torch, smi):
    """(a) transformer(packed=True) at its own widths with Adam(1e-3),
    batch 64 x 64: 10 eager steps (losses fall; each flash kernel
    launched exactly n_layer times a step, the decoder's self-attention);
    3 steps against the packed=False twin from one startup scope, held
    by phase 6's Adam limit with its two controls; 5 run() calls against
    one run_steps(K=5) dispatch, bitwise; step ms eager and under the
    graph. Returns (the eager run's launch counts, its trained scope, the
    program)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import transformer as T
    exe = fluid.Executor(fluid.CUDAPlace(0))
    packed, unpacked = _mt_program(fluid, T, True), \
        _mt_program(fluid, T, False)
    ops = [op.type for op in packed[0].global_block().ops]
    check(ops.count("sp_attention") == MT["n_layer"],
          "the packed MT program has %d sp_attention ops, not n_layer = %d",
          ops.count("sp_attention"), MT["n_layer"])
    init = _init_of(fluid, exe, packed[1])
    batches = [_mt_batch(seed) for seed in range(MT_STEPS)]
    _reset_launches()
    losses, wall, scope = _train(torch, fluid, exe, packed, init, batches,
                                 MT_STEPS)
    counts = _launches()
    tokens = MT_BATCH * MT["max_len"]
    log("mt train (packed, Adam, batch %d x %d): %d steps, losses %s; "
        "%.1f tokens/s, mean step %.3f ms (steps 2..%d); launches %s; %s",
        MT_BATCH, MT["max_len"], MT_STEPS,
        " ".join("%.4f" % x for x in losses),
        tokens * (MT_STEPS - 1) / wall, 1e3 * wall / (MT_STEPS - 1),
        MT_STEPS, {k: n for k, n in counts.items() if n}, smi)
    check(all(np.isfinite(losses)), "mt losses not finite: %r", losses)
    check(losses[-1] < losses[0], "mt loss did not fall: %r", losses)
    want = MT["n_layer"] * MT_STEPS
    for key, n in counts.items():
        check(n == (want if key.startswith("flash_") else 0),
              "mt: %s launches %d (want %d: n_layer decoder "
              "self-attentions a step)", key, n,
              want if key.startswith("flash_") else 0)
    # the unpacked twin: zero biases on full-length masks, composed
    _adam_parity(torch, fluid, exe, packed, unpacked, init,
                 batches[:PARITY_STEPS], "mt")
    graph = _graph_vs_eager(torch, fluid, packed, init, batches[:MT_K],
                            "mt run_steps")[0]
    for key in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        check(graph[key] == MT["n_layer"] * MT_K, "mt graph: %s launches "
              "%d through the replay, want %d", key, graph[key],
              MT["n_layer"] * MT_K)
    _interleaved_train(torch, fluid, exe, packed, init, batches, "mt",
                       "tokens/s", tokens, smi)
    return counts, scope, packed


def mt_flash_phase(torch):
    """(b) The three flash kernels at the MT decoder's shape [64, 8, 64,
    32], causal, fp32 and bf16, against their plain versions at phase
    5's tolerances; then timed there as phase 5 times them. Returns (the
    largest fp32 errors, the times)."""
    from paddle_tpu_torch.ops import flash_attention as F
    b, h, t, d = MT_SHAPE
    worst = {}
    for i, dtype in enumerate((torch.float32, torch.bfloat16)):
        e = _flash_case(torch, F, True, t, d, b, h, dtype, seed=1300 + i)
        log("mt flash: %-8s causal=True T=%d D=%d B=%d H=%d max_abs_err o "
            "%.2e lse %.2e | scaled dq %.2e dk %.2e dv %.2e  ok",
            str(dtype).replace("torch.", ""), t, d, b, h, e["o"][0],
            e["lse"][0], e["dq"][1], e["dk"][1], e["dv"][1])
        if dtype == torch.float32:
            worst = {"flash_fwd": max(e["o"][0], e["lse"][0]),
                     "flash_bwd_dq": e["dq"][0],
                     "flash_bwd_dkv": max(e["dk"][0], e["dv"][0])}
    return worst, flash_timing_phase(torch, b, h, t, d)


def _mt_sources(torch):
    """MT_SRC held-out sentences on the card; every other one padded from
    position 48 on (the cross bias masks the padding)."""
    src = _mt_batch(900, MT_SRC)
    tok = torch.from_numpy(src["src_word"]).cuda()
    mask = torch.ones(tok.shape, dtype=torch.float32, device="cuda")
    mask[::2, 48:] = 0.0
    tok[::2, 48:] = 0
    return tok, mask


def _teacher_forced(torch, model, src, mask, sents):
    """Each sentence of ``sents`` [B, W, T] fed back through the decoder
    behind BOS: (the sum of each one's token log-probs up to and with its
    first end_id [B, W], the teacher-forced logits [B*W, T, V] f32)."""
    b, w, t = sents.shape
    rows = b * w
    flat = sents.reshape(rows, t).long()
    with torch.no_grad():
        state = model._init_decode_state(model.encode(src, mask), mask,
                                         rows)
        tok = torch.full((rows,), model.bos_id, dtype=torch.long,
                         device=src.device)
        total = torch.zeros(rows, dtype=torch.float32, device=src.device)
        alive = torch.ones(rows, dtype=torch.bool, device=src.device)
        logits_all = []
        for i in range(t):
            logits, state = model._step_logits(tok, state, i)
            logp = torch.log_softmax(logits.float(), -1)
            total += torch.where(alive, logp.gather(1, flat[:, i:i + 1])[:, 0],
                                 0.0)
            logits_all.append(logits.float())
            alive = alive & (flat[:, i] != model.end_id)
            tok = flat[:, i]
    return total.reshape(b, w), torch.stack(logits_all, 1)


def _greedy_partings(torch, model, src, mask, toks, logits, what):
    """Greedy tokens [B, T] against the argmax of their teacher-forced
    logits [B, T, V], up to each row's first end_id. A parting is a
    near-tie when the two tokens' logits lie no further apart than the
    row's fp32 rounding, taken (as phase 10's rule takes it) as the
    largest difference between two correct dispatches of that row: the
    batch's and the row teacher-forced alone. Returns the near-ties."""
    near = []
    top = logits.argmax(-1)
    for r in range(toks.shape[0]):
        row = toks[r].tolist()
        end = row.index(model.end_id) + 1 if model.end_id in row \
            else len(row)
        differ = [i for i in range(end) if row[i] != int(top[r, i])]
        if not differ:
            continue
        i = differ[0]
        _, alone = _teacher_forced(torch, model, src[r:r + 1],
                                   mask[r:r + 1], toks[r:r + 1, None, :i + 1])
        eps = float((alone[0, i] - logits[r, i]).abs().max())
        gap = abs(float(logits[r, i, row[i]] - logits[r, i, top[r, i]]))
        msg = ("%s row %d token %d: greedy %d, teacher-forced argmax %d, "
               "logit gap %.3g, the row's rounding (batch vs alone) %.3g"
               % (what, r, i, row[i], int(top[r, i]), gap, eps))
        log("%s: tokens part: %s: %s", what, "a near-tie" if gap <= eps
            else "NOT a near-tie", msg)
        check(gap <= eps, "%s", msg)
        near.append(msg)
    return near


def _pick_end_id(toks):
    """A token the greedy run emits in its first row, at the first
    position from 8 on whose token did not come earlier: as end_id it
    ends that sentence inside the decode."""
    row = toks[0].tolist()
    for i in range(8, len(row)):
        if row[i] not in row[:i]:
            return row[i]
    return row[len(row) // 2]


def _ab_timing(torch, fns, pairs=DECODE_PAIRS):
    """{name: [wall ms, ...]} over ``pairs`` rounds of every fn in turn
    (A/B/A/B: the host varies from run to run)."""
    walls = {name: [] for name in fns}
    for _ in range(pairs):
        for name, fn in fns.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls[name].append(1e3 * (time.perf_counter() - t0))
    return walls


def _traced(torch, fn, title):
    """One traced call of ``fn``: the device busy share of its wall time
    and the kernels that take the most of it."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _report_profile(prof, wall, title)


def _graph_entry(model):
    """The decode graph a call just used (the newest)."""
    return list(model._decode_graphs.values())[-1][0]


def mt_translate_phase(torch, smi, prog, scope):
    """(c) translate (beam 4) and translate_greedy from the scope (a)
    trained, 16 sentences, max_out_len 64, fp32 then bf16: the decode
    graph bitwise equal to the eager loop (decoding.beam_search /
    greedy_search called directly); every returned beam's score equal to
    its teacher-forced sum of log-probs within SCORE_TOL; greedy tokens
    equal to the argmax of their teacher-forced logits or parting at a
    near-tie; ms per translate and tokens/s eager and graph."""
    from paddle_tpu_torch.models import decoding
    from paddle_tpu_torch.models.transformer_infer import TransformerInfer
    src, mask = _mt_sources(torch)
    dims = dict(n_layer=MT["n_layer"], n_head=MT["n_head"],
                d_model=MT["d_model"], max_len=MT["max_len"])
    max_out = MT["max_len"]
    near = []
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        probe = TransformerInfer.from_program(prog[0], scope, dtype=dtype,
                                              device="cuda", **dims)
        end_id = _pick_end_id(probe.translate_greedy(src, mask, max_out)[0])
        model = TransformerInfer.from_program(
            prog[0], scope, dtype=dtype, device="cuda", end_id=end_id,
            **dims)

        def eager_beam():
            with torch.no_grad():
                state = model._init_decode_state(
                    model.encode(src, mask), mask, MT_SRC * MT_BEAM)
                return decoding.beam_search(
                    model._step_logits, state, model.bos_id, end_id,
                    max_out, MT_SRC, MT_BEAM)

        def eager_greedy():
            with torch.no_grad():
                state = model._init_decode_state(
                    model.encode(src, mask), mask, MT_SRC)
                return decoding.greedy_search(
                    model._step_logits, state, model.bos_id, end_id,
                    max_out, MT_SRC)

        runs = {
            "beam": (lambda: model.translate(src, mask, beam_size=MT_BEAM,
                                             max_out_len=max_out),
                     eager_beam),
            "greedy": (lambda: model.translate_greedy(src, mask, max_out),
                       eager_greedy)}
        for how, (graph_fn, eager_fn) in runs.items():
            what = "mt translate %s %s" % (how, name)
            t0 = time.perf_counter()
            g1 = graph_fn()
            torch.cuda.synchronize()
            capture_s = time.perf_counter() - t0
            g2 = graph_fn()
            e = eager_fn()
            torch.cuda.synchronize()
            entry = _graph_entry(model)
            check(entry.replays == 2, "%s: %d replays for 2 calls", what,
                  entry.replays)
            same = [torch.equal(a, b) for a, b in zip(g1, e)] + \
                [torch.equal(a, b) for a, b in zip(g2, e)]
            check(all(same), "%s: the decode graph is not bitwise equal to "
                  "the eager loop (tokens, scores; two replays): %s", what,
                  same)
            sents, scores = g1
            if how == "greedy":
                sents, scores = sents[:, None, :], scores[:, None]
            check(bool(torch.isfinite(scores).all()) and
                  bool((scores[:, 1:] <= scores[:, :-1]).all()),
                  "%s: scores not finite or not sorted best first", what)
            forced, logits = _teacher_forced(torch, model, src, mask, sents)
            diff = (forced - scores).abs()
            bad = diff > SCORE_TOL * scores.abs().clamp_min(1.0)
            check(not bool(bad.any()), "%s: a returned score is not its "
                  "sentence's teacher-forced sum of log-probs: largest "
                  "difference %g", what, float(diff.max()))
            if how == "greedy":
                near += _greedy_partings(torch, model, src, mask,
                                         sents[:, 0], logits.reshape(
                                             MT_SRC, max_out, -1), what)
            ended = int((sents == end_id).any(-1).sum())
            walls = _ab_timing(torch, {"eager": eager_fn,
                                       "graph": graph_fn})
            if dtype == torch.float32:
                _traced(torch, graph_fn, "%s profile (traced, one graph "
                        "replay)" % what)
            toks = MT_SRC * max_out
            log("%s: graph captured in %.3f s (warm-up, capture, first "
                "replay); graph == eager loop bitwise (two replays); %d of "
                "%d sentences end at end_id %d; scores vs teacher-forced "
                "sums: largest difference %.3g (limit %g of max(1, "
                "|score|))", what, capture_s, ended, sents.shape[0] *
                sents.shape[1], end_id, float(diff.max()), SCORE_TOL)
            for mode in ("eager", "graph"):
                ms = walls[mode]
                log("%s timing (%s, %d rounds eager/graph in turn): ms per "
                    "translate %s (median %.3f); %.1f tokens/s (median; %d "
                    "sentences x %d output tokens); %s", what, mode,
                    DECODE_PAIRS, " ".join("%.3f" % x for x in ms),
                    _median(ms), toks / _median(ms) * 1e3, MT_SRC, max_out,
                    smi)
    log("mt translate: near-ties among greedy partings: %d", len(near))
    return near


def lm_generate_phase(torch, smi):
    """(d) TransformerLMInfer.generate on the flagship LM (phase 4's
    weights, init_stream(seed=0), all 4 layers): beam 4 and greedy, 8
    rows, 128 tokens: the decode graph bitwise equal to the eager loop;
    greedy rows all equal (every row starts from BOS) and equal to
    sequential_generate's tokens, or parting at a near-tie (the two
    tokens' logits no further apart than the batch and single-row
    dispatches of the row disagree)."""
    from paddle_tpu_torch.models import decoding
    from paddle_tpu_torch.models.transformer_infer import (
        TransformerLMInfer, init_stream)
    from paddle_tpu_torch.serving import sequential_generate
    model = TransformerLMInfer.from_stream(
        init_stream(VOCAB, MAX_LEN, N_LAYER, N_HEAD, D_MODEL, D_INNER,
                    seed=0), N_LAYER, N_HEAD, D_MODEL, MAX_LEN,
        device="cuda")
    near = []

    def eager(beam):
        with torch.no_grad():
            if beam > 1:
                return decoding.beam_search(
                    model._step_logits, model._init_state(GEN_BATCH * beam),
                    model.bos_id, model.end_id, GEN_LEN, GEN_BATCH, beam)
            return decoding.greedy_search(
                model._step_logits, model._init_state(GEN_BATCH),
                model.bos_id, model.end_id, GEN_LEN, GEN_BATCH)

    for beam in (GEN_BEAM, 1):
        what = "lm generate %s" % ("beam %d" % beam if beam > 1
                                   else "greedy")
        t0 = time.perf_counter()
        g1 = model.generate(GEN_BATCH, GEN_LEN, beam_size=beam)
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
        g2 = model.generate(GEN_BATCH, GEN_LEN, beam_size=beam)
        e = eager(beam)
        torch.cuda.synchronize()
        same = [torch.equal(a, b) for a, b in zip(g1, e)] + \
            [torch.equal(a, b) for a, b in zip(g2, e)]
        check(all(same), "%s: the decode graph is not bitwise equal to the "
              "eager loop: %s", what, same)
        check(_graph_entry(model).replays == 2, "%s: replays %d for 2 "
              "calls", what, _graph_entry(model).replays)
        if beam == 1:
            toks = g1[0]
            check(bool((toks == toks[:1]).all()), "%s: rows from the same "
                  "BOS differ", what)
            seq, _ = sequential_generate(model, [([model.bos_id],
                                                  GEN_LEN)])[0]
            row = toks[0].tolist()[:len(seq)]
            if row != seq:
                near.append(_lm_parting(torch, model, row, seq, what))
        walls = _ab_timing(torch, {
            "eager": lambda: eager(beam),
            "graph": lambda: model.generate(GEN_BATCH, GEN_LEN,
                                            beam_size=beam)})
        _traced(torch, lambda: model.generate(GEN_BATCH, GEN_LEN,
                                              beam_size=beam),
                "%s profile (traced, one graph replay)" % what)
        log("%s (%d rows x %d tokens, beam %d, flagship widths, 4 layers): "
            "graph captured in %.3f s; graph == eager loop bitwise (two "
            "replays)%s", what, GEN_BATCH, GEN_LEN, beam, capture_s,
            "; greedy equals sequential_generate's %d tokens" % len(seq)
            if beam == 1 and not near else "")
        for mode in ("eager", "graph"):
            ms = walls[mode]
            log("%s timing (%s, %d rounds eager/graph in turn): ms per "
                "generate %s (median %.3f); %.1f tokens/s (median; %d rows "
                "x %d tokens); %s", what, mode, DECODE_PAIRS,
                " ".join("%.3f" % x for x in ms), _median(ms),
                GEN_BATCH * GEN_LEN / _median(ms) * 1e3, GEN_BATCH,
                GEN_LEN, smi)
    return near


def _lm_parting(torch, model, row, seq, what):
    """Diagnose the first token where generate's greedy row and
    sequential_generate's part: the logits of that position under the
    batch dispatch (GEN_BATCH rows) and the single-row one; a near-tie
    when the two tokens' logits lie no further apart than the two
    dispatches disagree."""
    i = next(j for j, (a, b) in enumerate(zip(row, seq)) if a != b)
    prefix = [model.bos_id] + row[:i]
    out = []
    for rows in (GEN_BATCH, 1):
        state = model._init_state(rows)
        with torch.no_grad():
            for t, tk in enumerate(prefix):
                logits, state = model._step_logits(
                    torch.full((rows,), tk, dtype=torch.long,
                               device=model.device), state, t)
        out.append(logits[0].float())
    eps = float((out[0] - out[1]).abs().max())
    gap = abs(float(out[1][row[i]] - out[1][seq[i]]))
    msg = ("%s token %d: generate %d, sequential_generate %d; logit gap "
           "%.3g under the single-row step, the two dispatches differ by "
           "up to %.3g" % (what, i, row[i], seq[i], gap, eps))
    log("%s: tokens part: %s: %s", what, "a near-tie" if gap <= eps
        else "NOT a near-tie", msg)
    check(gap <= eps, "%s", msg)
    return msg


def _zoo_programs(fluid):
    from paddle_tpu_torch.models import mlp as M
    from paddle_tpu_torch.models import vgg as V
    progs = {}
    for name, shape in (("mlp", [784]), ("cnn", [1, 28, 28]),
                        ("vgg", [3, 32, 32])):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            if name == "vgg":
                _, _, avg_cost, _ = V.build_train_net(image_shape=shape)
            else:
                img = fluid.layers.data("img", shape)
                label = fluid.layers.data("label", [1], dtype="int64")
                net = M.mlp if name == "mlp" else M.cnn
                _, avg_cost, _ = net(img, label)
                fluid.optimizer.Adam(learning_rate=1e-3).minimize(avg_cost)
        progs[name] = (main, startup, avg_cost, shape)
    return progs


def _zoo_batch(shape, name):
    """One batch of ZOO_BATCH images whose class shows in their mean
    brightness (label / 10 added to noise in [0, 0.5)), so 5 steps can
    learn it."""
    rng = np.random.RandomState(13)
    label = rng.randint(0, 10, (ZOO_BATCH, 1)).astype(np.int64)
    img = 0.5 * rng.rand(ZOO_BATCH, *shape) + label.reshape(
        (ZOO_BATCH,) + (1,) * len(shape)) / 10.0
    return {name: img.astype(np.float32), "label": label}


def zoo_phase(torch, smi):
    """(e) mlp, cnn and VGG-16 (3 x 32 x 32, 10 classes) with Adam, batch
    64: 5 eager steps each on one fixed batch (``_zoo_batch``), losses
    finite and falling; VGG's dropout launches exactly 2 x 10 a step,
    ms per step; VGG with its dropouts: 5 run() calls against one
    run_steps(K=5) dispatch, bitwise (under cudnn.deterministic: cuDNN's
    default backward algorithms part run to run); cnn_infer's forward on
    a uint8 batch, against the port's CPU path on the same weights.
    Returns the dropout launches of VGG's eager steps."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import mlp as M
    exe = fluid.Executor(fluid.CUDAPlace(0))
    drops = 0
    for name, (main, startup, avg_cost, shape) in _zoo_programs(
            fluid).items():
        feed = _zoo_batch(shape, "data" if name == "vgg" else "img")
        init = _init_of(fluid, exe, startup)
        prog = (main, startup, avg_cost)
        _reset_launches()
        losses, wall, _ = _train(torch, fluid, exe, prog, init, [feed],
                                 ZOO_STEPS)
        counts = _launches()
        log("zoo %s (Adam, batch %d): %d steps on one batch, losses %s; "
            "mean step %.3f ms (steps 2..%d); launches %s; %s", name,
            ZOO_BATCH, ZOO_STEPS, " ".join("%.4f" % x for x in losses),
            1e3 * wall / (ZOO_STEPS - 1), ZOO_STEPS,
            {k: n for k, n in counts.items() if n}, smi)
        check(all(np.isfinite(losses)) and losses[-1] < losses[0],
              "zoo %s: losses not finite or not falling: %r", name, losses)
        if name == "vgg":
            n_drop = sum(op.type == "dropout"
                         for op in main.global_block().ops)
            drops = counts["dropout"]
            check(drops == 2 * n_drop * ZOO_STEPS, "vgg: %d dropout "
                  "launches, want 2 (the backward draws each mask again) x "
                  "%d dropout ops x %d steps", drops, n_drop, ZOO_STEPS)
            det = torch.backends.cudnn.deterministic
            torch.backends.cudnn.deterministic = True
            try:
                _graph_vs_eager(torch, fluid, prog, init, [feed] * ZOO_STEPS,
                                "vgg run_steps")
            finally:
                torch.backends.cudnn.deterministic = det
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        build, feeds = M.zoo_spec_cnn_infer()
        pred, = build()
    init = _init_of(fluid, exe, startup)
    rng = np.random.RandomState(14)
    feed = {"img": rng.randint(0, 256, (ZOO_BATCH, 1, 28, 28)).astype(
        np.uint8)}
    got, = exe.run(main, feed=feed, fetch_list=[pred],
                   scope=_scope_from(fluid, init, exe.device))
    cpu = fluid.Executor(fluid.CPUPlace())
    ref, = cpu.run(main, feed=feed, fetch_list=[pred],
                   scope=_scope_from(fluid, init, "cpu"))
    err = float(np.abs(got - ref).max())
    check(got.shape == (ZOO_BATCH, 10) and bool(np.isfinite(got).all())
          and np.allclose(got.sum(1), 1.0, atol=1e-5) and err <= 1e-5,
          "cnn_infer on a uint8 batch: shape %s, card vs CPU max_abs_err %g",
          got.shape, err)
    log("zoo cnn_infer: uint8 batch [%d, 1, 28, 28] through cast/scale/"
        "conv/pool/transposes/reshapes/fc softmax on the card, card vs CPU "
        "max_abs_err %.3g  ok", ZOO_BATCH, err)
    return drops


def mt_phase(torch, smi):
    """Phase 13. Returns (flash launches of (a)'s eager run, the flash
    kernels' largest fp32 errors and times at the MT shape, VGG's
    dropout launches)."""
    t0 = time.perf_counter()
    counts, scope, prog = mt_train_phase(torch, smi)
    t1 = time.perf_counter()
    err, times = mt_flash_phase(torch)
    t2 = time.perf_counter()
    near = mt_translate_phase(torch, smi, prog, scope)
    t3 = time.perf_counter()
    near += lm_generate_phase(torch, smi)
    t4 = time.perf_counter()
    drops = zoo_phase(torch, smi)
    t5 = time.perf_counter()
    log("mt: phase 13 took %.1f s (train %.1f s, flash %.1f s, translate "
        "%.1f s, generate %.1f s, zoo %.1f s); near-ties %d", t5 - t0,
        t1 - t0, t2 - t1, t3 - t2, t4 - t3, t5 - t4, len(near))
    return counts, err, times, drops


# -- phase 14 ------------------------------------------------------------
# DeepFM at the repo's widest configuration (bench.py's F8 D16 V20k):
# build_train_net(num_fields=8, vocab_size=20000, embed_dim=16), dnn
# (32, 32), Adam 1e-2, batch 1024, on tests/test_deepfm.py's click rule
DFM = dict(num_fields=8, vocab_size=20000, embed_dim=16, learning_rate=1e-2)
DFM_BATCH, DFM_STEPS, DFM_K, DFM_TOL = 1024, 20, 5, 2e-4
SPARSE_ROWS, SPARSE_NNZ = 8192, 3


def _dfm_batch(seed, batch=DFM_BATCH):
    """Ids uniform in the vocabulary; a click iff field 0's id is even
    and field 1's id lies in the lower half."""
    rng = np.random.RandomState(seed)
    v = DFM["vocab_size"]
    ids = rng.randint(0, v, (batch, DFM["num_fields"])).astype(np.int64)
    click = (ids[:, 0] % 2 == 0) & (ids[:, 1] < v // 2)
    feed = {"field_%d" % i: ids[:, i:i + 1]
            for i in range(DFM["num_fields"])}
    feed["click"] = click.astype(np.float32).reshape(-1, 1)
    return feed


def deepfm_train_phase(torch, smi):
    """(a) DeepFM training: 20 eager steps with losses falling; the
    card's first 3 steps within DFM_TOL of max(1, max|w|) of the port's
    CPU path from one startup scope (losses at rtol DFM_TOL); 5 run()
    calls against one run_steps(K=5) dispatch, bitwise (the shared
    tables' gradients sum repeated ids: every batch repeats them); step
    ms eager and under the graph, examples/s and the busy share of a
    traced pass of each. No kernel of the port runs here: every launch
    count must stay 0."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import deepfm as D
    exe = fluid.Executor(fluid.CUDAPlace(0))
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        _, _, _, loss = D.build_train_net(**DFM)
    prog = (main, startup, loss)
    init = _init_of(fluid, exe, startup)
    batches = [_dfm_batch(300 + i) for i in range(DFM_STEPS)]
    # the card against the port's CPU path, 3 steps from one scope
    cpu = fluid.Executor(fluid.CPUPlace())
    sc, sp = _scope_from(fluid, init, exe.device), \
        _scope_from(fluid, init, "cpu")
    for i, b in enumerate(batches[:3]):
        lc, = exe.run(main, feed=b, fetch_list=[loss], scope=sc)
        lp, = cpu.run(main, feed=b, fetch_list=[loss], scope=sp)
        check(abs(float(lc) - float(lp)) <= DFM_TOL * abs(float(lp)),
              "deepfm step %d: loss on the card %r, on the CPU %r", i + 1,
              float(lc), float(lp))
    graft, worst, norm = _apart({n: sc.get_numpy(n) for n in init},
                                {n: sp.get_numpy(n) for n in init})
    check(graft <= DFM_TOL, "deepfm: after 3 steps %s is %g of max(1, "
          "max|w|) from the CPU path (limit %g)", worst, graft, DFM_TOL)
    log("deepfm card vs CPU (Adam, 3 steps, batch %d): largest |diff| / "
        "max(1, max|w|) %.3g (%s), relative norm %.3g; limit %g", DFM_BATCH,
        graft, worst, norm, DFM_TOL)
    _reset_launches()
    losses, wall, _ = _train(torch, fluid, exe, prog, init, batches,
                             DFM_STEPS)
    counts = _launches()
    log("deepfm train (F%d D%d V%d, dnn (32, 32), Adam 1e-2, batch %d): "
        "%d steps, losses %s; %.1f examples/s, mean step %.3f ms (steps "
        "2..%d); %s", DFM["num_fields"], DFM["embed_dim"],
        DFM["vocab_size"], DFM_BATCH, DFM_STEPS,
        " ".join("%.4f" % x for x in losses),
        DFM_BATCH * (DFM_STEPS - 1) / wall, 1e3 * wall / (DFM_STEPS - 1),
        DFM_STEPS, smi)
    check(all(np.isfinite(losses)), "deepfm losses not finite: %r", losses)
    check(np.mean(losses[-5:]) < losses[0] - 0.02, "deepfm loss did not "
          "fall: %r", losses)
    check(not any(counts.values()), "deepfm launched the port's kernels: "
          "%s", counts)
    _graph_vs_eager(torch, fluid, prog, init, batches[:DFM_K],
                    "deepfm run_steps")
    out = _interleaved_train(torch, fluid, exe, prog, init,
                             batches[:2 * DFM_K], "deepfm", "examples/s",
                             DFM_BATCH, smi)
    return out


def _sparse_program(fluid, kind):
    """merge_selected_rows on a SelectedRows gradient, then sgd or lazy
    adam on a VOCAB x D table."""
    prog = fluid.Program()
    blk = prog.global_block()
    state = ["p", "lr"] + (["m1", "m2", "b1p", "b2p"] if kind == "adam"
                           else [])
    for n in state:
        blk.create_var(name=n, persistable=True)
    blk.create_var(name="g", persistable=True, type="selected_rows")
    blk.create_var(name="gm")
    blk.append_op("merge_selected_rows", {"X": ["g"]}, {"Out": ["gm"]}, {})
    if kind == "sgd":
        blk.append_op("sgd", {"Param": ["p"], "Grad": ["gm"],
                              "LearningRate": ["lr"]},
                      {"ParamOut": ["p"]}, {})
    else:
        blk.append_op(
            "adam", {"Param": ["p"], "Grad": ["gm"], "LearningRate": ["lr"],
                     "Moment1": ["m1"], "Moment2": ["m2"],
                     "Beta1Pow": ["b1p"], "Beta2Pow": ["b2p"]},
            {"ParamOut": ["p"], "Moment1Out": ["m1"], "Moment2Out": ["m2"],
             "Beta1PowOut": ["b1p"], "Beta2PowOut": ["b2p"]},
            {"update_beta_pow": True})
    return prog


def deepfm_sparse_phase(torch, smi):
    """(b) The sparse branches on a 20000 x 16 table: SPARSE_NNZ steps,
    each a SelectedRows gradient of SPARSE_ROWS ids (repeats among them)
    merged by merge_selected_rows, then sgd or lazy adam, on the card
    and on the CPU from the same state: touched rows within rtol 1e-6 /
    atol 1e-7 of the CPU's, every untouched row of the table and both
    moments bitwise as it was; run_steps refuses the program."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core.selected_rows import SelectedRows
    v, d = DFM["vocab_size"], DFM["embed_dim"]
    rng = np.random.RandomState(41)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    cpu = fluid.Executor(fluid.CPUPlace())
    for kind in ("sgd", "adam"):
        prog = _sparse_program(fluid, kind)
        state = {"p": rng.randn(v, d).astype(np.float32),
                 "lr": np.array([0.05], np.float32)}
        if kind == "adam":
            state.update(m1=0.1 * rng.randn(v, d).astype(np.float32),
                         m2=0.01 * np.abs(rng.randn(v, d)).astype(
                             np.float32),
                         b1p=np.array([0.9], np.float32),
                         b2p=np.array([0.999], np.float32))
        sc, sp = _scope_from(fluid, state, exe.device), \
            _scope_from(fluid, state, "cpu")
        touched = np.zeros(v, bool)
        ms = []
        for _ in range(SPARSE_NNZ):
            rows = rng.randint(0, v, SPARSE_ROWS)
            touched[rows] = True
            value = rng.randn(SPARSE_ROWS, d).astype(np.float32)
            sc.set("g", SelectedRows(rows, value, v))
            sp.set("g", SelectedRows(rows, value, v))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            exe.run(prog, feed={}, fetch_list=[], scope=sc)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
            cpu.run(prog, feed={}, fetch_list=[], scope=sp)
        worst = 0.0
        for n in ("p", "m1", "m2") if kind == "adam" else ("p",):
            got, want = sc.get_numpy(n), sp.get_numpy(n)
            err = float(np.max(np.abs(got[touched] - want[touched])))
            close = np.allclose(got[touched], want[touched], rtol=1e-6,
                                atol=1e-7)
            check(close, "sparse %s: %s on the touched rows differs from "
                  "the CPU beyond rtol 1e-6 / atol 1e-7 (largest "
                  "|difference| %g)", kind, n, err)
            check(np.array_equal(got[~touched], state[n][~touched]),
                  "sparse %s: an untouched row of %s changed", kind, n)
            check(not np.array_equal(got[touched], state[n][touched]),
                  "sparse %s: %s did not move", kind, n)
            worst = max(worst, err)
        try:
            exe.run_steps(prog, feeds=[{}, {}], scope=sc)
        except NotImplementedError as e:
            check("host (IO) ops" in str(e), "sparse %s: run_steps raised "
                  "%s", kind, e)
        else:
            raise SmokeFailure("sparse %s: run_steps took a program with a "
                               "host op" % kind)
        log("deepfm sparse %s (table %d x %d, %d steps of %d ids, %d rows "
            "touched): card vs CPU on touched rows within rtol 1e-6 / atol "
            "1e-7, largest |difference| %.3g; %d untouched rows bitwise "
            "(table and moments); run_steps refused; "
            "ms a step (merge + update, host reads included) %s; %s", kind,
            v, d, SPARSE_NNZ, SPARSE_ROWS, int(touched.sum()), worst,
            int((~touched).sum()), " ".join("%.3f" % x for x in ms), smi)


def op_sweep_phase(torch):
    """(c) The op library on the card against the CPU
    (``paddle_tpu_torch/tools/op_sweep.py``): every op type the slice
    added, forward, and backward where the CPU sweep checks a
    gradient."""
    from paddle_tpu_torch.tools import op_sweep
    held, worst = op_sweep.run("cuda")
    check(len(held) == 112, "op sweep held %d op types, want 112",
          len(held))
    log("op sweep: %d op types held on the card against the CPU "
        "(forward rtol %g / atol %g, gradients rtol %g / atol %g); "
        "largest forward |difference| %.3g", len(held), op_sweep.FWD_RTOL,
        op_sweep.FWD_ATOL, op_sweep.GRAD_RTOL, op_sweep.GRAD_ATOL, worst)
    return len(held)


def deepfm_phase(torch, smi):
    """Phase 14."""
    t0 = time.perf_counter()
    deepfm_train_phase(torch, smi)
    t1 = time.perf_counter()
    deepfm_sparse_phase(torch, smi)
    t2 = time.perf_counter()
    n = op_sweep_phase(torch)
    t3 = time.perf_counter()
    log("deepfm: phase 14 took %.1f s (train %.1f s, sparse %.1f s, op "
        "sweep %.1f s); %d op types held", t3 - t0, t1 - t0, t2 - t1,
        t3 - t2, n)


# -- phase 15 ------------------------------------------------------------
# benchmarks/stacked_dynamic_lstm.py at its own widths (the reference's
# benchmark/fluid/stacked_dynamic_lstm.py: vocab 5000, hidden 512, 3
# layers, batch 64, lengths RandomState(0).randint(40, 81))
LSTM = dict(vocab=5000, hidden=512, stacked=3, batch=64)
LSTM_STEPS, LSTM_K = 20, 5
# (3, 6): unaligned rows; (64, 128): the SRL book's 128 units
LSTM_CELL_CASES = [(64, 512), (5, 48), (3, 6), (64, 128)]
# (gate, cell, candidate) attribute codes as the lowering passes them:
# sigmoid/tanh/tanh, sigmoid/relu/id, the SRL book's sigmoid/sigmoid/relu,
# and its reading with cell and candidate swapped
LSTM_ACTS = [(1, 2, 2), (1, 3, 0), (1, 1, 3), (1, 3, 1)]
LSTM_RTOL, LSTM_ATOL = 1e-5, 1e-6       # a few f32 ulp at O(1) values
LSTM_OP_RTOL, LSTM_OP_ATOL = 1e-4, 1e-5  # 16 steps through the lowering
LSTM_CONTROL = 4.0                      # limit: 4 x the plain cell's gap
GRU_BOOK = dict(dict_size=100, emb=32, hidden=64, batch=16, lengths=(10, 33))


def _lstm_program(fluid):
    """The benchmark's Program in the port's layers (tests/test_torch_rnn
    .py builds the same and holds its JSON to the benchmark's):
    embedding, 3 x (fc to 4 hidden, dynamic_lstm without peepholes), max
    sequence pool, fc softmax, cross-entropy, Adam 1e-3."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        L = fluid.layers
        words = L.data("words", [1], dtype="int64", lod_level=1)
        label = L.data("label", [1], dtype="int64")
        x = L.embedding(words, size=[LSTM["vocab"], LSTM["hidden"]])
        for _ in range(LSTM["stacked"]):
            proj = L.fc(x, 4 * LSTM["hidden"])
            x, _ = L.dynamic_lstm(proj, size=4 * LSTM["hidden"],
                                  use_peepholes=False)
        pred = L.fc(L.sequence_pool(x, "max"), 2, act="softmax")
        loss = L.mean(L.cross_entropy(pred, label))
        fluid.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    return main, startup, loss


def _lstm_lengths(rng):
    return rng.randint(40, 81, size=LSTM["batch"]).tolist()


def _lstm_batch(fluid):
    """The benchmark's batch: lengths, ids and labels from one
    RandomState(0) stream."""
    rng = np.random.RandomState(0)
    lens = _lstm_lengths(rng)
    ids = rng.randint(0, LSTM["vocab"], (sum(lens), 1)).astype(np.int64)
    ys = rng.randint(0, 2, (LSTM["batch"], 1)).astype(np.int64)
    return {"words": fluid.create_lod_tensor(ids, [lens]), "label": ys}, lens


def _step_inputs(torch, b, d, seed, peep):
    """On the card: a forward step's inputs (xt, h_prev, c_prev, w at an
    initializer's scale randn / sqrt(D), peep), lengths 0..8, and a
    backward step's (dg_next, dout, dcell, the carried dh and dc)."""
    g = torch.Generator().manual_seed(seed)

    def r(*shape):
        return torch.randn(*shape, generator=g)

    fwd = [r(b, 4 * d), r(b, d), r(b, d), r(d, 4 * d) * d ** -0.5,
           r(3 * d) if peep else None]
    lens = torch.randint(0, 9, (b,), generator=g, dtype=torch.int32)
    bwd = [r(b, 4 * d)] + [r(b, d) for _ in range(4)]
    cuda = [None if x is None else x.cuda() for x in fwd + bwd]
    return cuda[:5], lens.cuda(), cuda[5:]


_STEP_NAMES = ("H", "C", "Out", "gates", "dh", "dc", "dg", "dpeep")


def _step_pair(torch, fwd, bwd, ins, lens, grads, t, t_next, acts, saved):
    """A forward step and a backward step through ``fwd``/``bwd`` (the
    kernels or the plain versions): [H, C, Out, gates, dh, dc, dg] and
    dpeep with peepholes. The backward reads ``saved`` (the plain
    forward's gates and C), so it sees the same inputs in both; t_next
    None is the scan's first backward step."""
    xt, h, c, w, peep = ins
    dgn, dout, dcell, dh0, dc0 = grads
    out = list(fwd(xt, h, c, w, peep, lens, t, acts))
    dh, dc = dh0.clone(), dc0.clone()
    dpeep = None if peep is None else torch.full(
        (c.shape[0], 3 * c.shape[1]), 0.5, device=c.device)
    dg = torch.full_like(xt, 7.0)
    bwd(None if t_next is None else dgn, w, lens, t_next, saved[0], c,
        saved[1], peep, t, acts, dout, dcell, dh, dc, dpeep, dg)
    return out + [dh, dc, dg] + ([] if peep is None else [dpeep])


def _close_err(torch, got, want, rtol, atol):
    """(within rtol / atol of the largest |want|, largest |diff|)."""
    diff = float((got - want).abs().max())
    scale = max(1.0, float(want.abs().max()))
    return bool(torch.allclose(got, want, rtol=rtol, atol=atol * scale)), \
        diff


def lstm_kernel_phase(torch):
    """(a) The fused step kernels against their plain versions on the
    card at B 64 D 512, B 5 D 48, B 3 D 6 (rows that are no
    multiple of 16 bytes: the element-wise staging) and B 64 D 128 (the
    SRL book's width), with and without peepholes, the four activation
    sets of LSTM_ACTS, dead rows at the step and at the
    next: the forward
    step (H, C, Out and the saved gates) and the backward step (dh, dc,
    the gate gradients and the per-row peephole gradients), as the
    scan's first backward step (no dg_next) and as a later one, and the
    dh-only call a scan with H0 ends on, at rtol 1e-5 / atol 1e-6 of the
    largest value; two launches of each bitwise; then a reverse LSTM
    with peepholes through the ``lstm`` lowering (D 512 with the default
    activations, D 128 with the SRL book's), kernel route against
    the plain steps on the card (Hidden, Cell and the gradients of
    Input, Weight and Bias at rtol 1e-4 / atol 1e-5). Then timed at the
    main path's shape and lengths."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops import lstm_cell as LC
    from paddle_tpu_torch.tools import op_sweep
    kernel = (LC._lstm_step_cuda, LC._lstm_step_bwd_cuda)
    plain = (LC._lstm_step_plain, LC._lstm_step_bwd_plain)
    compared, err = 0, 0.0
    for n, (b, d) in enumerate(LSTM_CELL_CASES):
        for peep in (False, True):
            for acts in LSTM_ACTS:
                for t, t_next in ((0, None), (5, 6), (5, 4)):
                    ins, lens, grads = _step_inputs(torch, b, d, 500 + n,
                                                    peep)
                    saved = LC._lstm_step_plain(*ins, lens, t, acts)
                    saved = (saved[3], saved[1])
                    got = _step_pair(torch, *kernel, ins, lens, grads, t,
                                     t_next, acts, saved)
                    want = _step_pair(torch, *plain, ins, lens, grads, t,
                                      t_next, acts, saved)
                    dh_k, dh_p = grads[3].clone(), grads[3].clone()
                    for fn, dh in ((LC._lstm_step_bwd_cuda, dh_k),
                                   (LC._lstm_step_bwd_plain, dh_p)):
                        fn(grads[0], ins[3], lens, t, None, None, None,
                           None, None, acts, None, None, dh, grads[4].clone(),
                           None, None)
                    torch.cuda.synchronize()
                    for name, a, w in zip(_STEP_NAMES + ("dh only",),
                                          got + [dh_k], want + [dh_p]):
                        ok, e = _close_err(torch, a, w, LSTM_RTOL, LSTM_ATOL)
                        err = max(err, e)
                        check(ok, "lstm step kernel %s differs from the "
                              "plain version at B %d D %d peep %s acts %s "
                              "t %d t_next %s: largest |diff| %g", name, b,
                              d, peep, acts, t, t_next, e)
                    compared += 1
        log("lstm step kernels: B %d D %d: forward and backward within rtol "
            "%g / atol %g of the plain versions (peepholes on/off, acts %s, "
            "the first backward step and later ones in both directions, "
            "dead rows among the live)", b, d, LSTM_RTOL, LSTM_ATOL,
            LSTM_ACTS)
    ins, lens, grads = _step_inputs(torch, 64, 512, 599, True)
    saved = LC._lstm_step_plain(*ins, lens, 3, (1, 2, 2))
    runs = [_step_pair(torch, *kernel, ins, lens, grads, 3, 4, (1, 2, 2),
                       (saved[3], saved[1])) for _ in range(2)]
    check(all(torch.equal(x, y) for x, y in zip(*runs)),
          "two lstm step launches on the same inputs differ")
    # a reverse LSTM with peepholes through the lowering (16 steps), with
    # the default activations and with the SRL book's at its width
    b = 64
    exe = fluid.Executor(fluid.CUDAPlace(0))
    for d, attrs in ((512, {}), (128, {"gate_activation": "sigmoid",
                                       "cell_activation": "sigmoid",
                                       "candidate_activation": "relu"})):
        rng = np.random.RandomState(77)
        lens = rng.randint(1, 17, size=b).tolist()
        lens[0] = 16
        inputs = {"Input": op_sweep.Seq(0.5 * rng.randn(sum(lens), 4 * d)
                                        .astype(np.float32), lens),
                  "Weight": (0.05 * rng.randn(d, 4 * d)).astype(np.float32),
                  "Bias": (0.1 * rng.randn(1, 7 * d)).astype(np.float32)}
        prog, feed, fetch = op_sweep.one_op_program(
            fluid, "lstm", inputs, dict(attrs, use_peepholes=True,
                                        is_reverse=True),
            ["Hidden", "Cell"], ["Input", "Weight", "Bias"])
        LC.lstm_scan.launches = 0
        got = exe.run(prog, feed=feed, fetch_list=fetch, scope=fluid.Scope())
        torch.cuda.synchronize()
        check(LC.lstm_scan.launches == 2 * 16, "the reverse lstm launched "
              "the step kernels %d times, want 2 x 16",
              LC.lstm_scan.launches)
        with _plain_steps(LC):
            want = exe.run(prog, feed=feed, fetch_list=fetch,
                           scope=fluid.Scope())
        for name, g, w in zip(fetch, got, want):
            ok, e = _close_err(torch, torch.from_numpy(g),
                               torch.from_numpy(w), LSTM_OP_RTOL,
                               LSTM_OP_ATOL)
            check(ok, "reverse peephole lstm (B %d, D %d, %s, 16 steps): %s "
                  "differs between the kernel and the plain route by %g", b,
                  d, attrs or "default activations", name, e)
        log("lstm step kernels: reverse peephole lstm through the lowering "
            "(B %d, D %d, %s, lengths 1..16, 32 launches): Hidden, Cell and "
            "the gradients of Input, Weight and Bias within rtol %g / atol "
            "%g of the plain steps", b, d, attrs or "default activations",
            LSTM_OP_RTOL, LSTM_OP_ATOL)
    log("lstm step kernels: %d step comparisons; two launches bitwise; "
        "largest |diff| %.3g", compared, err)
    return dict(_lstm_timing(torch, LC), max_abs_err=err)


@contextlib.contextmanager
def _plain_steps(LC):
    """The scan on the card through the plain steps (the control route)."""
    with _patched(LC, "_steps_for", lambda real: lambda device: (
            LC._lstm_step_plain, LC._lstm_step_bwd_plain)):
        yield


def _step_bounds(lengths, b, d):
    """(forward, backward) bounds of one step, each averaged over the
    sweep's steps t = 0..@MAXLEN-1 as (bytes, operations, ms, bound_by).
    What a step must move, in f32 words: W [D, 4D] once when a row is
    live (forward: at t; backward: at t + 1), and per row, forward, 13 D
    for a live row (reads x_t 4D, h_prev and c_prev; writes H, C, Out and
    the gates 4D) and 5 D for a dead one (reads h_prev, c_prev; writes H, C, Out);
    backward, 17 D for a row live at t + 1 (reads dg_next 4D, dOut, dc,
    the gates 4D, c_prev, c; writes dg 4D and dc), 14 D for one live at
    t only (the carried dh in place of dg_next) and 6 D for a dead one
    (reads dc; writes dg 4D and dc); plus the lengths. Operations: the
    product's 2 x 4D x D a row (live at t forward, at t + 1 backward) at
    the TF32 tensor cores' rate, the cell's 22 (forward) or 44
    (backward: the activations again, then the gradients) an element of
    a row live at t at the fp32 rate."""
    maxlen = 1 << (max(lengths) - 1).bit_length()
    live = [sum(n > t for n in lengths) for t in range(maxlen + 1)]
    f32, w_bytes = 4, 4 * 4 * d * d

    def bound(per_step):
        rows = [per_step(live[t], live[t + 1]) for t in range(maxlen)]
        nbytes = float(np.mean([r[0] for r in rows]))
        ops_s = float(np.mean([r[1] / TF32_FLOPS + r[2] / FP32_FLOPS
                               for r in rows]))
        ops = float(np.mean([r[1] + r[2] for r in rows]))
        by = "bytes" if nbytes / HBM_BYTES_PER_S >= ops_s else "operations"
        return nbytes, ops, max(nbytes / HBM_BYTES_PER_S, ops_s) * 1e3, by

    fwd = bound(lambda k, _: ((w_bytes if k else 0) + f32 * d * (
        13 * k + 5 * (b - k)) + 4 * b, 8 * k * d * d, 22 * k * d))
    bwd = bound(lambda k, k2: ((w_bytes if k2 else 0) + f32 * d * (
        17 * k2 + 14 * (k - k2) + 6 * (b - k)) + 4 * b, 8 * k2 * d * d,
        44 * k * d))
    return fwd, bwd


def _lstm_timing(torch, LC):
    """The step kernels at the main path's shape and live share: B 64, D
    512, no peepholes, the benchmark's lengths (40..80, @MAXLEN 128),
    the timed calls sweeping the steps of one layer's scan as the main
    path does (forward t = 0..127; backward t = 127..0, each reading the
    gate gradients of step t + 1, none at the last step). Device time
    alone and with the host's gaps, the plain steps over the same sweep,
    the bound from the sweep's lengths (``_step_bounds``), and the
    library's route for a step: ``torch.mm`` (h @ W) then ATen's fused
    cell ``_thnn_fused_lstm_cell`` (no peepholes, no mask; its backward
    ``_thnn_fused_lstm_cell_backward_impl`` then ``torch.mm`` for dh),
    two calls each way, where PyTorch exposes the cell. The kernels and
    the library's route also back to back, as the graph-held scan runs
    them (``tools/kernel_trials.graph_sweep_ms``). Then one layer's
    scan forward and backward (autograd through ``lstm_scan``: 256
    launches and the weight-gradient product) against cuDNN's LSTM
    (``torch.nn.LSTM(512, 512)`` on the packed batch, TF32 off: its time
    includes the input projection the port's fc does, and it runs only
    to the longest length, 80 steps, on a shrinking batch)."""
    from paddle_tpu_torch.tools.kernel_trials import graph_sweep_ms
    b, d = LSTM["batch"], LSTM["hidden"]
    acts = (1, 2, 2)
    (xt, h, c, w, _), _, (dgn, dout, _, dh0, dc0) = _step_inputs(
        torch, b, d, 600, False)
    lengths = _lstm_lengths(np.random.RandomState(0))
    maxlen = 1 << (max(lengths) - 1).bit_length()
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    sweep = 2 * maxlen                  # each timed loop: whole sweeps
    outs = tuple(torch.empty_like(c) for _ in range(3)) + (
        torch.empty_like(xt),)
    gates = LC._lstm_step_plain(xt, h, c, w, None, lens, 0, acts)[3]
    dh, dc, dg = dh0.clone(), dc0.clone(), torch.empty_like(xt)

    def fwd_of(step):
        return lambda i: step(xt, h, c, w, None, lens, i % maxlen, acts,
                              out=outs)

    def bwd_of(step):
        def call(i):
            t = maxlen - 1 - i % maxlen
            step(dgn if t < maxlen - 1 else None, w, lens, t + 1, gates, c,
                 outs[1], None, t, acts, dout, None, dh, dc, None, dg)
        return call

    fwd, bwd = fwd_of(LC._lstm_step_cuda), bwd_of(LC._lstm_step_bwd_cuda)
    ms = _events_ms(torch, fwd, sweep, hide_host=True)
    gaps = _events_ms(torch, fwd, sweep)
    bwd_ms = _events_ms(torch, bwd, sweep, hide_host=True)
    bwd_gaps = _events_ms(torch, bwd, sweep)
    in_graph = {"fwd": graph_sweep_ms(fwd, maxlen),
                "bwd": graph_sweep_ms(bwd, maxlen)}
    with torch.no_grad():
        plain_ms = _events_ms(torch, fwd_of(LC._lstm_step_plain), maxlen,
                              hide_host=True)
        plain_bwd_ms = _events_ms(torch, bwd_of(LC._lstm_step_bwd_plain),
                                  maxlen, hide_host=True)
    lib_ms = lib_gaps = lib_bwd_ms = None
    fused = getattr(torch, "_thnn_fused_lstm_cell", None) or getattr(
        torch.ops.aten, "_thnn_fused_lstm_cell", None)
    fused_bwd = getattr(torch.ops.aten, "_thnn_fused_lstm_cell_backward_impl",
                        None)
    if fused is not None:
        with torch.no_grad():
            def lib(_):
                return fused(xt, torch.mm(h, w), c)
            lib_ms = _events_ms(torch, lib, sweep, hide_host=True)
            lib_gaps = _events_ms(torch, lib, sweep)
            in_graph["library fwd"] = graph_sweep_ms(lib, maxlen)
            hy, cy, work = lib(0)
            if fused_bwd is not None:
                def lib_bwd(_):
                    return torch.mm(fused_bwd(dout, dc0, c, cy, work,
                                              False)[0], w.t())
                lib_bwd_ms = _events_ms(torch, lib_bwd, sweep,
                                        hide_host=True)
                in_graph["library bwd"] = graph_sweep_ms(lib_bwd, maxlen)
    (nbytes, flops, bound, bound_by), (bwd_bytes, bwd_flops, bwd_bound,
                                       bwd_by) = _step_bounds(lengths, b, d)
    layer = _lstm_layer_timing(torch, LC, lengths, maxlen)
    log("timing lstm step kernels (B %d, D %d, f32, no peepholes, the "
        "benchmark's lengths, steps 0..%d swept), device time alone: "
        "forward kernel_ms=%.5f bound_ms=%.5f by %s (bytes: %.0f, "
        "operations: %.0f) plain_ms=%.5f library_ms=%s (torch.mm then "
        "_thnn_fused_lstm_cell); backward kernel_ms=%.5f bound_ms=%.5f by "
        "%s (bytes: %.0f, operations: %.0f) plain_ms=%.5f library_ms=%s "
        "(_thnn_fused_lstm_cell_backward_impl then torch.mm); with the "
        "host's gaps: forward kernel_ms=%.5f library_ms=%s, backward "
        "kernel_ms=%.5f; kernel / bound %.1f forward, %.1f backward", b, d,
        maxlen - 1, ms, bound, bound_by, nbytes, flops, plain_ms,
        "none" if lib_ms is None else "%.5f" % lib_ms, bwd_ms, bwd_bound,
        bwd_by, bwd_bytes, bwd_flops, plain_bwd_ms,
        "none" if lib_bwd_ms is None else "%.5f" % lib_bwd_ms, gaps,
        "none" if lib_gaps is None else "%.5f" % lib_gaps, bwd_gaps,
        ms / bound, bwd_ms / bwd_bound)
    log("timing lstm step kernels back to back (the sweep captured in one "
        "CUDA graph, as run_steps replays the scan), ms a call: %s",
        ", ".join("%s %.5f" % kv for kv in in_graph.items()))
    return dict({"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                 "bound_by": bound_by, "library_ms": lib_ms,
                 "ms_with_host_gaps": gaps,
                 "library_ms_with_host_gaps": lib_gaps, "bwd_ms": bwd_ms,
                 "bwd_plain_ms": plain_bwd_ms, "bwd_bound_ms": bwd_bound,
                 "bwd_bound_by": bwd_by, "bwd_library_ms": lib_bwd_ms,
                 "bwd_ms_with_host_gaps": bwd_gaps,
                 "ms_in_graph_sweep": in_graph}, **layer)


LSTM_LAYER_SLEEP = 60_000_000      # ~30 ms: hides a layer's enqueue


def _lstm_layer_timing(torch, LC, lengths, maxlen):
    """One layer forward and backward, device time alone (a long sleep
    hides the host's enqueue of its ~260 launches): the port's scan
    through autograd against cuDNN's LSTM on the packed batch."""
    b, d = LSTM["batch"], LSTM["hidden"]
    g = torch.Generator(device="cuda").manual_seed(601)
    xp = (0.5 * torch.randn(maxlen, b, 4 * d, generator=g, device="cuda")
          ).requires_grad_(True)
    w = (torch.randn(d, 4 * d, generator=g, device="cuda") * d ** -0.5
         ).requires_grad_(True)
    zeros = torch.zeros(b, d, device="cuda")
    cot = torch.randn(maxlen, b, d, generator=g, device="cuda")
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")

    def port(_):
        hs, _ = LC.lstm_scan(xp, w, zeros, zeros, None, lens, (1, 2, 2))
        torch.autograd.grad(torch.sum(hs * cot), [xp, w])

    port_ms = _events_ms(torch, port, 4, hide_host=True,
                         sleep_cycles=LSTM_LAYER_SLEEP)
    from torch.nn.utils.rnn import PackedSequence, pack_padded_sequence
    lstm = torch.nn.LSTM(d, d).cuda()
    x = torch.randn(maxlen, b, d, generator=g, device="cuda")
    packed = pack_padded_sequence(x, torch.tensor(lengths),
                                  enforce_sorted=False)
    data = packed.data.detach().requires_grad_(True)
    packed = PackedSequence(data, packed.batch_sizes, packed.sorted_indices,
                            packed.unsorted_indices)
    pcot = torch.randn(data.shape[0], d, generator=g, device="cuda")

    def cudnn(_):
        out, _ = lstm(packed)
        torch.autograd.grad(torch.sum(out.data * pcot),
                            [data] + list(lstm.parameters()))

    cudnn_ms = _events_ms(torch, cudnn, 4, hide_host=True,
                          sleep_cycles=LSTM_LAYER_SLEEP)
    log("timing one lstm layer forward and backward (B %d, D %d, the "
        "benchmark's lengths), device time alone: the port's scan %.4f ms "
        "(%d steps: %d step launches and the weight-gradient product), "
        "cuDNN's LSTM %.4f ms (packed, %d steps on a shrinking batch, "
        "with the input projection the port's fc does); port / cuDNN %.2f",
        b, d, port_ms, maxlen, 2 * maxlen, cudnn_ms, max(lengths),
        port_ms / cudnn_ms)
    return {"layer_ms": port_ms, "cudnn_layer_ms": cudnn_ms}


def _kernel_rows(torch, fn):
    """[(device us, launches, name)] of the device kernels one call of
    ``fn`` runs, from the chrome trace of a ``profiler.trace`` pass after
    an untraced warm-up call (copies and fills left out), or None when
    the trace holds no kernel. ``profiler.trace`` pads the window (the
    profiler drops the records of kernels that ran before its window
    opened, and the window can open after the profile's start returns)
    and takes the trace again while kernel records are missing, at most
    ``profiler._TRACE_TRIES`` passes."""
    import tempfile
    from paddle_tpu_torch import profiler
    fn()
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as tmp:
        profiler.trace(fn, tmp)
        rows = _trace_rows(os.path.join(tmp, "device_trace.json"))
    got = profiler.last_device_trace_check()
    if got["passes"] > 1 or not got["complete"]:
        log("traced pass: %d passes, the last %s (%d launches without a "
            "kernel record)", got["passes"], "complete" if got["complete"]
            else "INCOMPLETE", got["unmatched_launches"])
    return rows or None


def _traced_kernels(torch, fn, title):
    """Device kernels one call of ``fn`` launches, from a traced pass
    (``_kernel_rows``): {"all", "lstm_cell" (the step kernels), "gemm"
    (names holding "gemm")}, or None when the profiler saw no device
    time."""
    rows = _kernel_rows(torch, fn)
    if rows is None:
        log("%s: the profiler reported no device time (not measured)", title)
        return None
    return {"all": sum(n for _, n, _ in rows),
            "lstm_cell": sum(n for _, n, k in rows if "lstm_cell_" in k),
            "gemm": sum(n for _, n, k in rows if "gemm" in k.lower())}


def _pool_partings(h_k, h_c, lens):
    """[(near-tie, sequence, unit, the card's argmax, the CPU's, margin,
    rounding)] of the max pool's choices over each sequence's rows of
    ``h_k`` (the card's pool input) and ``h_c`` (the CPU's) that part. The
    margin is the CPU's value at its argmax less its value at the card's;
    the rounding is the most the two correct fp32 computations part on
    that sequence and unit, max_t |h_k - h_c|, plus the fp32 rounding of
    the value. A near-tie's margin is at most NEAR_TIE_X times that."""
    out, start = [], 0
    eps32 = float(np.finfo(np.float32).eps)
    for n, length in enumerate(lens):
        hk, hc = h_k[start:start + length], h_c[start:start + length]
        ak, ac = hk.argmax(0), hc.argmax(0)
        for u in np.nonzero(ak != ac)[0]:
            margin = float(hc[ac[u], u] - hc[ak[u], u])
            eps = float(np.abs(hk[:, u] - hc[:, u]).max()) + \
                eps32 * float(np.abs(hc[:, u]).max())
            out.append((margin <= NEAR_TIE_X * eps, n, int(u), int(ak[u]),
                        int(ac[u]), margin, eps))
        start += length
    return out


def _first_step_gaps(fluid, LC, exe, prog, init, batch, what, pool=None):
    """The first step from ``init`` on the CPU, and on the card through
    the step kernels and through the plain steps (the control): the
    kernel route's loss and the norm of its weights' difference to the
    CPU's, each within LSTM_CONTROL x the control's. Returns (the
    kernel's loss gap, the control's).

    With ``pool`` = (the max pool's input, the sequence lengths), a
    pooled choice where the kernel route and the CPU part at a near-tie
    (``_pool_partings``: two rows equal, or within rounding, on the CPU)
    sends that sequence's gradient through another row, which no limit
    on the weights can hold. Then the weights are held on the two
    kernels apart: the kernel forward's pool input within LSTM_CONTROL x
    the control's, and the step through the plain forward and the
    kernel backward in the weights; a parting that is no near-tie
    fails."""
    main, _, loss = prog
    names = sorted(init)
    fetch = [loss] + ([pool[0]] if pool else [])

    def first_step(executor, route=None):
        scope = _scope_from(fluid, init, executor.device)
        with (_patched(LC, "_steps_for", lambda real: lambda device: route)
              if route else contextlib.nullcontext()):
            out = executor.run(main, feed=batch, fetch_list=fetch,
                               scope=scope)
        return float(out[0]), {n: scope.get_numpy(n) for n in names}, \
            out[1:]

    plain = (LC._lstm_step_plain, LC._lstm_step_bwd_plain)
    t0 = time.perf_counter()
    cpu_loss, cpu_w, cpu_h = first_step(fluid.Executor(fluid.CPUPlace()))
    cpu_s = time.perf_counter() - t0
    k_loss, k_w, k_h = first_step(exe)
    p_loss, p_w, p_h = first_step(exe, plain)
    k_gap = abs(k_loss - cpu_loss) / abs(cpu_loss)
    p_gap = abs(p_loss - cpu_loss) / abs(cpu_loss)
    k_norm = _apart(k_w, cpu_w)[2]
    p_norm = _apart(p_w, cpu_w)[2]
    kp_norm = _apart(k_w, p_w)[2]
    log("%s first step: loss card kernel %.7f, card plain steps %.7f, CPU "
        "%.7f; loss gap to the CPU %.3g (control: the plain steps %.3g); "
        "weights' difference norm / weights' norm to the CPU %.3g (control "
        "%.3g), kernel to plain steps %.3g; limit %g x the control; the "
        "CPU step took %.1f s", what, k_loss, p_loss, cpu_loss, k_gap, p_gap,
        k_norm, p_norm, kp_norm, LSTM_CONTROL, cpu_s)
    check(k_gap <= max(LSTM_CONTROL * p_gap, 1e-6), "%s first step: the "
          "kernel's loss is %g from the CPU's, the plain steps' %g", what,
          k_gap, p_gap)
    partings = _pool_partings(k_h[0], cpu_h[0], pool[1]) if pool else []
    if not partings:
        check(k_norm <= max(LSTM_CONTROL * p_norm, 1e-6), "%s first step: "
              "the kernel's weights are %g from the CPU's, the plain "
              "steps' %g", what, k_norm, p_norm)
        return k_gap, p_gap
    log("%s first step: the max pool parts from the CPU's at %d choice(s) "
        "(near-tie, sequence, unit, card row, CPU row, margin, rounding): "
        "%s", what, len(partings), partings[:4])
    check(all(p[0] for p in partings), "%s first step: the max pool parts "
          "from the CPU's where no near-tie explains it: %s", what,
          [p for p in partings if not p[0]][:4])
    h_gap = [float(np.abs(h - c).max()) / float(np.abs(c).max())
             for h, c in ((k_h[0], cpu_h[0]), (p_h[0], cpu_h[0]))]
    check(h_gap[0] <= max(LSTM_CONTROL * h_gap[1], 1e-6), "%s first step: "
          "the kernel forward's pool input is %g from the CPU's, the plain "
          "steps' %g", what, h_gap[0], h_gap[1])
    _, b_w, _ = first_step(exe, (LC._lstm_step_plain,
                                 LC._lstm_step_bwd_cuda))
    b_norm = _apart(b_w, cpu_w)[2]
    log("%s first step, the kernels apart: the forward's pool input %.3g "
        "from the CPU's (control %.3g); the plain forward with the kernel "
        "backward %.3g from the CPU's weights (control %.3g)", what,
        h_gap[0], h_gap[1], b_norm, p_norm)
    check(b_norm <= max(LSTM_CONTROL * p_norm, 1e-6), "%s first step: "
          "through the plain forward the kernel backward's weights are %g "
          "from the CPU's, the plain steps' %g", what, b_norm, p_norm)
    return k_gap, p_gap


def lstm_train_phase(torch, smi):
    """(b) The stacked LSTM at full width: the card's first step against
    the port's CPU path from one startup scope, at LSTM_CONTROL times the
    gap of the control (the plain steps on the card) in the loss and in
    the norm of the weights' difference (where the max pool parts from
    the CPU's at a near-tie, the two kernels held apart:
    ``_first_step_gaps``); LSTM_STEPS eager steps on the
    fixed batch with losses falling and lstm_cell launches exactly 3
    layers x @MAXLEN steps x 2 (forward, backward) a step (reset just
    before, read just after); 5 run() calls against one run_steps(K=5)
    dispatch bitwise; eager and graph ms per batch A/B/A/B, tokens/s and
    the busy share; the peak device memory of an eager step; the device
    kernels of one step through the kernels and through the plain steps,
    from traced passes: the kernel route's step kernels exactly 768 and
    fewer GEMM kernels than @MAXLEN (no per-step product outside the
    kernel: the weight gradient is one product a layer)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops import lstm_cell as LC
    exe = fluid.Executor(fluid.CUDAPlace(0))
    main, startup, loss = _lstm_program(fluid)
    prog = (main, startup, loss)
    init = _init_of(fluid, exe, startup)
    batch, lens = _lstm_batch(fluid)
    tokens = sum(lens)
    maxlen = 1 << (max(lens) - 1).bit_length()
    per_step = 2 * LSTM["stacked"] * maxlen
    k_gap, p_gap = _first_step_gaps(
        fluid, LC, exe, prog, init, batch,
        "lstm (vocab %d, hidden %d, %d layers, batch %d, %d tokens in a "
        "bucket of %d, @MAXLEN %d)" % (
            LSTM["vocab"], LSTM["hidden"], LSTM["stacked"], LSTM["batch"],
            tokens, 1 << (tokens - 1).bit_length(), maxlen),
        pool=([op for op in main.global_block().ops
               if op.type == "sequence_pool"][0].input("X")[0], lens))
    _reset_launches()
    losses, wall, _ = _train(torch, fluid, exe, prog, init, [batch],
                             LSTM_STEPS)
    counts = _launches()
    log("lstm train (Adam 1e-3, the benchmark's fixed batch): %d steps, "
        "losses %s; %.1f tokens/s, mean step %.3f ms (steps 2..%d); "
        "lstm_cell launches %d (%d a step); %s", LSTM_STEPS,
        " ".join("%.4f" % x for x in losses),
        tokens * (LSTM_STEPS - 1) / wall, 1e3 * wall / (LSTM_STEPS - 1),
        LSTM_STEPS, counts["lstm_cell"], counts["lstm_cell"] // LSTM_STEPS,
        smi)
    check(all(np.isfinite(losses)), "lstm losses not finite: %r", losses)
    check(np.mean(losses[-5:]) < losses[0] - 0.01, "lstm loss did not "
          "fall: %r", losses)
    check(counts["lstm_cell"] == per_step * LSTM_STEPS, "lstm_cell launched "
          "%d times in %d steps, want %d (3 layers x %d steps x 2)",
          counts["lstm_cell"], LSTM_STEPS, per_step * LSTM_STEPS, maxlen)
    others = {k: v for k, v in counts.items() if k != "lstm_cell" and v}
    check(not others, "the lstm step launched other kernels: %s", others)
    graph_counts = _graph_vs_eager(torch, fluid, prog, init,
                                   [batch] * LSTM_K, "lstm run_steps")[0]
    check(graph_counts["lstm_cell"] == per_step * LSTM_K,
          "lstm run_steps(K=%d): %d lstm_cell launches through the replay, "
          "want %d", LSTM_K, graph_counts["lstm_cell"], per_step * LSTM_K)
    _capture_warm(torch, fluid, exe, prog, init, [batch] * MEGA_TRAIN_K,
                  "lstm")
    timing = _interleaved_train(torch, fluid, exe, prog, init,
                                [batch] * MEGA_TRAIN_STEPS, "lstm",
                                "tokens/s", tokens, smi, warm=True)
    scope = _scope_from(fluid, init, exe.device)

    def step():
        exe.run(main, feed=batch, fetch_list=[loss], scope=scope)

    step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    kernel_route = _traced_kernels(torch, step, "lstm traced step")
    with _plain_steps(LC):
        step()
        plain_route = _traced_kernels(torch, step, "lstm plain traced step")
    if kernel_route is not None:
        check(kernel_route["lstm_cell"] == per_step, "the traced lstm step "
              "ran %d step kernels, want %d", kernel_route["lstm_cell"],
              per_step)
        check(kernel_route["gemm"] < maxlen, "the traced lstm step ran %d "
              "GEMM kernels: a per-step product outside the step kernel",
              kernel_route["gemm"])
    log("lstm device kernels in one step (traced): %s through the kernel "
        "route, %s through the plain steps; peak device memory of an eager "
        "step %.1f MB; %s", kernel_route, plain_route, peak / 2 ** 20, smi)
    return counts["lstm_cell"], graph_counts["lstm_cell"], {
        "first_step_gap": k_gap, "control_gap": p_gap,
        "kernels_a_step": kernel_route, "plain_kernels_a_step": plain_route,
        "peak_bytes": peak, "timing": timing}


def _gru_book_program(fluid):
    """tests/book/test_rnn_encoder_decoder.py's GRU encoder-decoder at
    GRU_BOOK's small widths; its cost is sum-pooled per sequence
    (``sequence_pool`` "sum": segment sums)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        L = fluid.layers
        v, emb, hid = GRU_BOOK["dict_size"], GRU_BOOK["emb"], \
            GRU_BOOK["hidden"]
        src = L.data("src_word_id", [1], dtype="int64", lod_level=1)
        trg = L.data("target_language_word", [1], dtype="int64",
                     lod_level=1)
        label = L.data("target_language_next_word", [1], dtype="int64",
                       lod_level=1)
        enc = L.dynamic_gru(L.fc(L.embedding(src, size=[v, emb]), hid * 3),
                            size=hid)
        dec = L.dynamic_gru(L.fc(L.embedding(trg, size=[v, emb]), hid * 3),
                            size=hid, h_0=L.sequence_last_step(enc))
        pred = L.fc(dec, v, act="softmax")
        loss = L.mean(L.sequence_pool(L.cross_entropy(pred, label), "sum"))
        fluid.optimizer.Adam(learning_rate=0.005).minimize(loss)
    return main, startup, loss


def gru_book_phase(torch):
    """The book GRU encoder-decoder (sum-pooled cost): LSTM_K run()
    calls against one run_steps(K=LSTM_K) dispatch bitwise, over LSTM_K
    batches of one step signature (the same lengths, fresh words)."""
    import paddle_tpu_torch as fluid
    exe = fluid.Executor(fluid.CUDAPlace(0))
    prog = _gru_book_program(fluid)
    init = _init_of(fluid, exe, prog[1])
    rng = np.random.RandomState(5)
    b, v = GRU_BOOK["batch"], GRU_BOOK["dict_size"]
    slen = rng.randint(*GRU_BOOK["lengths"], size=b).tolist()
    tlen = rng.randint(*GRU_BOOK["lengths"], size=b).tolist()

    def words(lens):
        return fluid.create_lod_tensor(
            rng.randint(0, v, (sum(lens), 1)).astype(np.int64), [lens])

    batches = [{"src_word_id": words(slen),
                "target_language_word": words(tlen),
                "target_language_next_word": words(tlen)}
               for _ in range(LSTM_K)]
    _graph_vs_eager(torch, fluid, prog, init, batches,
                    "book gru encoder-decoder (dict %d, emb %d, hidden %d, "
                    "batch %d, %d + %d tokens)" % (
                        v, GRU_BOOK["emb"], GRU_BOOK["hidden"], b,
                        sum(slen), sum(tlen)))


def lstm_phase(torch, smi):
    """Phase 15."""
    t0 = time.perf_counter()
    cell = lstm_kernel_phase(torch)
    t1 = time.perf_counter()
    launches, graph_launches, train = lstm_train_phase(torch, smi)
    gru_book_phase(torch)
    t2 = time.perf_counter()
    from paddle_tpu_torch.tools import op_sweep
    held, worst = op_sweep.run("cuda", part="lod")
    check(len(held) == 32, "lod op sweep held %d op types, want 32",
          len(held))
    t3 = time.perf_counter()
    log("lod op sweep: %d op types held on the card against the CPU "
        "(forward rtol %g / atol %g, gradients rtol %g / atol %g); largest "
        "forward |difference| %.3g", len(held), op_sweep.FWD_RTOL,
        op_sweep.FWD_ATOL, op_sweep.GRAD_RTOL, op_sweep.GRAD_ATOL, worst)
    log("lstm: phase 15 took %.1f s (kernel %.1f s, train and book gru "
        "%.1f s, op sweep "
        "%.1f s)", t3 - t0, t1 - t0, t2 - t1, t3 - t2)
    return launches, graph_launches, cell, train


# -- phase 16 ------------------------------------------------------------
# the CRF/CTC and detection ops: the reference's label_semantic_roles
# tagger at the book's widths, the ssd zoo model, CTC
SRL_BATCH, SRL_STEPS = 64, 20
SRL_NLL_RTOL = 1e-5
NEAR_TIE_X = 2.0          # a parting's margin: at most 2 x the rounding
SSD_BATCH, SSD_STEPS = 32, 10
DET_RTOL, DET_ATOL = 1e-5, 1e-6
CTC = dict(batch=32, t=64, classes=32, label_lens=(5, 20))
CTC_RTOL = 1e-5


def _srl_program(fluid):
    from paddle_tpu_torch.models import label_semantic_roles as SRL
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        net = SRL.build_train_net(fluid)
    return main, startup, net


def _path_score(em, trans, path):
    """A tag path's CRF score in float64 under emissions ``em`` [n, D]."""
    em, trans = em.astype(np.float64), trans.astype(np.float64)
    return trans[0, path[0]] + trans[1, path[-1]] + \
        em[np.arange(len(path)), path].sum() + \
        trans[2:][path[:-1], path[1:]].sum()


def _viterbi_partings(em_k, em_c, trans, path_k, path_c, lens):
    """[(near-tie, margin, rounding, first row, length)] of the
    sentences whose card and CPU Viterbi paths part. The margin is the
    CPU path's score less the card path's, both under the CPU's
    emissions; the row's rounding is the most that two correct fp32
    computations of its emissions (the card's, the CPU's) can move a
    path's score, sum_t max_d |em_k - em_c|, plus the fp32 rounding of
    the score's own sum. A near-tie's margin is at most NEAR_TIE_X times
    that."""
    out, start = [], 0
    eps32 = float(np.finfo(np.float32).eps)
    for n in lens:
        pk, pc = path_k[start:start + n], path_c[start:start + n]
        if not np.array_equal(pk, pc):
            ek, ec = em_k[start:start + n], em_c[start:start + n]
            margin = _path_score(ec, trans, pc) - _path_score(ec, trans, pk)
            terms = float(np.abs(ec).max(1).sum()) + \
                float(np.abs(trans).max()) * (n + 1)
            eps = float(np.abs(ek - ec).max(1).sum()) + eps32 * terms
            out.append((abs(margin) <= NEAR_TIE_X * eps, margin, eps, start,
                        n))
        start += n
    return out


def _crf_part(fluid, em, target, path, lens, trans):
    """The SRL step's CRF part alone, on its own inputs: one-op programs
    of linear_chain_crf (with the gradients of its Emission and
    Transition), crf_decoding and chunk_eval (the path against the
    target), and their feeds."""
    from paddle_tpu_torch.tools import op_sweep
    S = op_sweep.Seq
    parts = [("linear_chain_crf", {"Emission": S(em, lens),
                                   "Label": S(target, lens),
                                   "Transition": trans}, {},
              ["LogLikelihood"], ["Emission", "Transition"]),
             ("crf_decoding", {"Emission": S(em, lens),
                               "Transition": trans}, {}, ["ViterbiPath"],
              []),
             ("chunk_eval", {"Inference": S(path, lens),
                             "Label": S(target, lens)},
              {"num_chunk_types": 29, "chunk_scheme": "IOB"},
              ["Precision", "NumCorrectChunks"], [])]
    return [op_sweep.one_op_program(fluid, *p) for p in parts]


def _share(rows, pick):
    """(device ms, launches, share of the rows' device time) of the rows
    whose names ``pick`` accepts."""
    mine = [r for r in rows if pick(r[2])]
    total = sum(r[0] for r in rows)
    return (sum(r[0] for r in mine) / 1e3, sum(r[1] for r in mine),
            sum(r[0] for r in mine) / total)


def srl_phase(torch, smi):
    """(a) The reference book's label_semantic_roles tagger at its own
    widths (``models/label_semantic_roles.py``: word_dim 32, the shared
    44068 x 32 table not trained, predicate 3162 x 32, mark 2 x 5,
    hidden 512, 8 dynamic_lstm layers of 128 units with peepholes,
    reversed on odd layers, 59 labels, the CRF with crfw at lr x 1e-3,
    Viterbi, chunk_eval over 29 IOB types; Adam 2e-3), batch 64 with
    lengths RandomState(0).randint(5, 30): the forward of one fixed
    batch on the card and on the CPU from one scope (the CRF NLL within
    rtol 1e-5, the Viterbi paths equal or parted at a diagnosed
    near-tie, every tag in [0, 59)); the card's first step against the
    CPU's within 4 x the gap of the control (the plain LSTM steps on the
    card), on loss and weights; 20 eager steps, losses falling, lstm_cell
    launches exactly 8 layers x @MAXLEN x 2 a step and no other kernel
    of the port; 5 ``run()`` calls against one ``run_steps(K=5)``
    dispatch bitwise; eager and graph ms A/B/A/B, tokens/s and the busy
    share; an eager step's kernels by device time (the step kernels', the
    GEMMs' and, traced alone on the same inputs, the CRF part's share
    and launches); an eager step's peak memory."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import label_semantic_roles as SRL
    from paddle_tpu_torch.ops import lstm_cell as LC
    exe = fluid.Executor(fluid.CUDAPlace(0))
    cpu = fluid.Executor(fluid.CPUPlace())
    main, startup, net = _srl_program(fluid)
    loss = net["loss"]
    prog = (main, startup, loss)
    init = _init_of(fluid, exe, startup)
    batch, lens = SRL.make_batch(fluid, batch=SRL_BATCH, seed=0)
    labels = SRL.LABEL_DICT_LEN
    tokens = sum(lens)
    maxlen = 1 << (max(lens) - 1).bit_length()
    per_step = 2 * SRL.BOOK["depth"] * maxlen
    w = SRL.BOOK
    log("srl (the book's db_lstm at its widths: vocabularies %d / %d, "
        "word_dim %d, hidden %d, %d peephole lstm layers of %d units, %d "
        "labels; Adam 2e-3): batch %d, %d tokens in a bucket of %d, "
        "@MAXLEN %d, %.1f%% of the (row, step) cells live",
        w["word_dict_len"], w["pred_dict_len"], w["word_dim"],
        w["hidden_dim"], w["depth"], w["hidden_dim"] // 4, labels,
        SRL_BATCH, tokens, 1 << (tokens - 1).bit_length(), maxlen,
        100.0 * tokens / (SRL_BATCH * maxlen))

    # the forward of one fixed batch, card against CPU, from one scope
    fetch = [net["nll"], net["emission"], net["path"]] + list(net["chunks"])
    infer = main.prune([v.name for v in fetch])

    def forward(executor):
        return executor.run(infer, feed=batch, fetch_list=fetch,
                            scope=_scope_from(fluid, init, executor.device))

    got, want = forward(exe), forward(cpu)
    nll_err = float(np.max(np.abs(got[0] - want[0]) / np.abs(want[0])))
    check(np.allclose(got[0], want[0], rtol=SRL_NLL_RTOL, atol=0),
          "srl: the card's CRF NLL is %g (relative) from the CPU's, limit "
          "%g", nll_err, SRL_NLL_RTOL)
    path_k, path_c = got[2].ravel(), want[2].ravel()
    check(path_k.shape == (tokens,) and bool(((path_k >= 0)
                                               & (path_k < labels)).all()),
          "srl: Viterbi path of shape %s, tags %d..%d, want %d tags in "
          "[0, %d)", path_k.shape, path_k.min(), path_k.max(), tokens,
          labels)
    partings = _viterbi_partings(got[1], want[1], init["crfw"], path_k,
                                 path_c, lens)
    for tie, margin, eps, start, n in partings:
        log("srl: the Viterbi paths part in the sentence at row %d (%d "
            "tokens): margin %.3g, the row's rounding %.3g: %s", start, n,
            margin, eps, "a near-tie" if tie else "NOT a near-tie")
        check(tie, "srl: the card's Viterbi path parts from the CPU's at "
              "row %d, margin %g over %g x the row's rounding %g", start,
              margin, NEAR_TIE_X, eps)
    chunks_k = [float(np.ravel(x)[0]) for x in got[3:]]
    chunks_c = [float(np.ravel(x)[0]) for x in want[3:]]
    check(partings or chunks_k == chunks_c, "srl: chunk metrics on the "
          "card %s, on the CPU %s", chunks_k, chunks_c)
    log("srl forward, card vs CPU: CRF NLL within %.3g (relative; limit "
        "%g), mean NLL %.4f; Viterbi paths %s; chunk_eval (precision, "
        "recall, F1, infer / label / correct chunks) card %s, CPU %s; %s",
        nll_err, SRL_NLL_RTOL, float(np.mean(got[0])),
        "equal" if not partings else "part in %d sentences, each at a "
        "near-tie" % len(partings), chunks_k, chunks_c, smi)

    k_gap, p_gap = _first_step_gaps(fluid, LC, exe, prog, init, batch,
                                    "srl")
    _reset_launches()
    losses, wall, _ = _train(torch, fluid, exe, prog, init, [batch],
                             SRL_STEPS)
    counts = _launches()
    log("srl train (the fixed batch): %d steps, losses %s; %.1f tokens/s, "
        "mean step %.3f ms (steps 2..%d); lstm_cell launches %d (%d a "
        "step); %s", SRL_STEPS, " ".join("%.4f" % x for x in losses),
        tokens * (SRL_STEPS - 1) / wall, 1e3 * wall / (SRL_STEPS - 1),
        SRL_STEPS, counts["lstm_cell"], counts["lstm_cell"] // SRL_STEPS,
        smi)
    check(all(np.isfinite(losses)) and np.mean(losses[-5:]) < losses[0]
          and losses[-1] < losses[0], "srl loss did not fall: %r", losses)
    check(counts["lstm_cell"] == per_step * SRL_STEPS, "srl: lstm_cell "
          "launched %d times in %d steps, want %d (8 layers x %d steps x 2)",
          counts["lstm_cell"], SRL_STEPS, per_step * SRL_STEPS, maxlen)
    others = {k: v for k, v in counts.items() if k != "lstm_cell" and v}
    check(not others, "the srl step launched other kernels: %s", others)
    graph_counts = _graph_vs_eager(torch, fluid, prog, init,
                                   [batch] * MEGA_TRAIN_K,
                                   "srl run_steps")[0]
    check(graph_counts["lstm_cell"] == per_step * MEGA_TRAIN_K,
          "srl run_steps(K=%d): %d lstm_cell launches through the replay, "
          "want %d", MEGA_TRAIN_K, graph_counts["lstm_cell"],
          per_step * MEGA_TRAIN_K)
    _capture_warm(torch, fluid, exe, prog, init, [batch] * MEGA_TRAIN_K,
                  "srl")
    timing = _interleaved_train(torch, fluid, exe, prog, init,
                                [batch] * MEGA_TRAIN_STEPS, "srl",
                                "tokens/s", tokens, smi, warm=True)

    scope = _scope_from(fluid, init, exe.device)

    def step():
        exe.run(main, feed=batch, fetch_list=[loss], scope=scope)

    step()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    shares = {}
    rows = _kernel_rows(torch, step)
    em = got[1][:tokens]
    target = batch["target"].data.astype(np.int32)
    crf = _crf_part(fluid, em, target, path_k.reshape(-1, 1), lens,
                    init["crfw"])

    def crf_step():
        for p, f, out in crf:
            exe.run(p, feed=f, fetch_list=out, scope=fluid.Scope())

    crf_rows = _kernel_rows(torch, crf_step)
    if rows is not None and crf_rows is not None:
        step_ms = sum(r[0] for r in rows) / 1e3
        crf_ms = sum(r[0] for r in crf_rows) / 1e3
        shares = {
            "step_device_ms": step_ms,
            "step_launches": sum(r[1] for r in rows),
            "lstm_cell": _share(rows, lambda k: "lstm_cell_" in k),
            "gemm": _share(rows, lambda k: "gemm" in k.lower()),
            "crf_part": (crf_ms, sum(r[1] for r in crf_rows),
                         crf_ms / step_ms)}
        log("srl eager step kernels (traced): %d launches, %.3f ms of "
            "device time; the lstm step kernels %.3f ms in %d launches = "
            "%.1f%%; GEMMs %.3f ms in %d = %.1f%%; the CRF part (its "
            "forward and gradient, Viterbi and chunk_eval, traced alone on "
            "the step's emissions) %.3f ms in %d launches = %.1f%% of the "
            "step's device time", shares["step_launches"], step_ms,
            *shares["lstm_cell"][:2], 100 * shares["lstm_cell"][2],
            *shares["gemm"][:2], 100 * shares["gemm"][2], crf_ms,
            shares["crf_part"][1], 100 * shares["crf_part"][2])
        for dev_us, count, key in sorted(rows, reverse=True)[:8]:
            log("  %6.1f%% of device time  %8.3f ms  x%-6d %s",
                100 * dev_us / 1e3 / step_ms, dev_us / 1e3, count, key[:70])
    log("srl: an eager step's peak device memory %.1f MB, %.1f MB above "
        "what was held before it (the weights, their moments and the "
        "captured graphs' pools); %s", peak / 2 ** 20, (peak - held) / 2 ** 20,
        smi)
    return counts["lstm_cell"], graph_counts["lstm_cell"], {
        "tokens": tokens, "first_step_gap": k_gap, "control_gap": p_gap,
        "nll_err": nll_err, "viterbi_partings": len(partings),
        "kernels": shares, "peak_bytes": peak, "step_bytes": peak - held,
        "timing": timing}


def _ssd_programs(fluid):
    from paddle_tpu_torch.models import ssd as S
    progs = []
    for build in (S.build_ssd_train_net, S.build_ssd_infer_net):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            out = build()
        progs.append((main, startup, out[-1]))
    return progs


def ssd_train_phase(torch, smi, prog):
    """(b) The ssd zoo model at its own widths (3 x 64 x 64, 5 classes,
    352 priors over two maps, Adam 1e-3), batch 32 with 1..4 ground-truth
    boxes an image (``models/ssd.make_batch``): SSD_STEPS eager steps on
    the fixed batch, losses falling; 5 ``run()`` calls against one
    ``run_steps(K=5)`` dispatch bitwise (under cudnn.deterministic);
    eager and graph ms A/B/A/B and the busy share. Returns the trained
    scope's state and the batch."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import ssd as S
    exe = fluid.Executor(fluid.CUDAPlace(0))
    init = _init_of(fluid, exe, prog[1])
    batch, lens = S.make_batch(fluid, batch=SSD_BATCH, seed=0)
    losses, wall, scope = _train(torch, fluid, exe, prog, init, [batch],
                                 SSD_STEPS)
    log("ssd train (Adam 1e-3, batch %d, %d ground-truth boxes in a bucket "
        "of %d): %d steps, losses %s; mean step %.3f ms (steps 2..%d); %s",
        SSD_BATCH, sum(lens), 1 << (sum(lens) - 1).bit_length(), SSD_STEPS,
        " ".join("%.4f" % x for x in losses), 1e3 * wall / (SSD_STEPS - 1),
        SSD_STEPS, smi)
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          "ssd loss did not fall: %r", losses)
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        _graph_vs_eager(torch, fluid, prog, init, [batch] * MEGA_TRAIN_K,
                        "ssd run_steps")
    finally:
        torch.backends.cudnn.deterministic = det
    _capture_warm(torch, fluid, exe, prog, init, [batch] * MEGA_TRAIN_K,
                  "ssd")
    timing = _interleaved_train(torch, fluid, exe, prog, init,
                                [batch] * MEGA_TRAIN_STEPS, "ssd",
                                "images/s", SSD_BATCH, smi, warm=True)
    return {n: scope.get_numpy(n) for n in init}, batch, timing


def _det_rows_part(a, b):
    """Images whose detection rows part: labels not equal, or scores or
    boxes beyond rtol DET_RTOL / atol DET_ATOL."""
    return [i for i in range(a.shape[0])
            if not (np.array_equal(a[i, :, 0], b[i, :, 0])
                    and np.allclose(a[i, :, 1:], b[i, :, 1:], rtol=DET_RTOL,
                                    atol=DET_ATOL))]


def _det_program(fluid, m, c):
    """detection_output alone over fed locations [N, m, 4], scores
    [N, m, c], priors and variances [m, 4], with the infer net's
    attributes."""
    main = fluid.Program()
    with fluid.program_guard(main, fluid.Program()), \
            fluid.unique_name.guard():
        L = fluid.layers
        loc = L.data("loc", [m, 4])
        conf = L.data("conf", [m, c])
        prior = L.data("prior", [m, 4], append_batch_size=False)
        var = L.data("var", [m, 4], append_batch_size=False)
        dets = L.detection_output(loc, conf, prior, var, nms_threshold=0.45,
                                  score_threshold=0.01, keep_top_k=50)
    return main, dets


def ssd_infer_phase(torch, smi, prog, state, images, gt):
    """(c) ``build_ssd_infer_net`` (detection_output: softmax, box_coder
    decode, multiclass_nms; nms_top_k 400 over 352 priors, keep_top_k
    50) on the trained weights: the card's rows against the CPU's from
    the same weights, labels equal and scores and boxes within rtol 1e-5
    / atol 1e-6, unless the image's parting is diagnosed as a near-tie
    (the network's outputs on the card within rounding of the CPU's, and
    detection_output alone on the CPU fed the card's outputs giving the
    card's rows: a decision at a boundary, not the detection ops);
    DetectionMAP (class_num 5, 11-point) over the images, card against
    CPU; ms per batch eager and as one CUDA graph (``run_steps``, K=1)
    A/B/A/B; the launches of one multiclass_nms (traced)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.tools import op_sweep
    main, _, dets = prog
    ops = main.global_block().ops
    coder = next(op for op in ops if op.type == "box_coder")
    nms = next(op for op in ops if op.type == "multiclass_nms")
    soft = next(op for op in ops if op.type == "softmax")
    inner = [soft.input("X")[0], coder.input("TargetBox")[0],
             coder.input("PriorBox")[0], coder.input("PriorBoxVar")[0],
             nms.input("BBoxes")[0], nms.input("Scores")[0]]
    fetch = [dets.name] + inner
    feed = {"image": images}
    exe = fluid.Executor(fluid.CUDAPlace(0))
    cpu = fluid.Executor(fluid.CPUPlace())
    scope = _scope_from(fluid, state, exe.device)
    got = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
    want = cpu.run(main, feed=feed, fetch_list=fetch,
                   scope=_scope_from(fluid, state, "cpu"))
    k_rows, c_rows = got[0], want[0]
    n, m, c = got[1].shape
    kept = int((k_rows[..., 1] > 0).sum())
    check(k_rows.shape == (images.shape[0], 50, 6) and kept > 0
          and bool(np.isfinite(k_rows).all()), "ssd detections: shape %s, "
          "%d kept rows", k_rows.shape, kept)
    parted = _det_rows_part(k_rows, c_rows)
    if parted:
        det_main, det_out = _det_program(fluid, m, c)
        alone, = cpu.run(det_main, feed={"conf": got[1], "loc": got[2],
                                         "prior": got[3], "var": got[4]},
                         fetch_list=[det_out], scope=fluid.Scope())
        net_err = max(_close_err(torch, torch.from_numpy(g),
                                 torch.from_numpy(w), 1e-4, 1e-5)[1]
                      for g, w in zip(got[1:3], want[1:3]))
        near = all(np.allclose(g, w, rtol=1e-4, atol=1e-5 * max(
            1.0, float(np.abs(w).max())))
                   for g, w in zip(got[1:3], want[1:3]))
        same_alone = not _det_rows_part(k_rows, alone)
        log("ssd detections: %d of %d images part between the card and the "
            "CPU; the network's outputs differ by up to %.3g; "
            "detection_output alone on the CPU, fed the card's outputs, %s "
            "the card's rows: %s", len(parted), n, net_err,
            "gives" if same_alone else "does NOT give",
            "near-ties" if near and same_alone else "NOT near-ties")
        check(near and same_alone, "ssd detections part from the CPU's in "
              "images %s, and not at a near-tie", parted[:8])
    # DetectionMAP over the images, card and CPU
    map_main = fluid.Program()
    with fluid.program_guard(map_main, fluid.Program()), \
            fluid.unique_name.guard():
        d = fluid.layers.data("det", [6])
        gl = fluid.layers.data("gt_label", [1])
        gb = fluid.layers.data("gt_box", [4])
        ev = fluid.evaluator.DetectionMAP(d, gl, gb, class_num=5)
    gt_box, gt_label, lens = gt
    maps = []
    for executor, rows in ((exe, k_rows), (cpu, c_rows)):
        ev.reset()
        start = 0
        for i, g in enumerate(lens):
            mv, = executor.run(map_main, feed={
                "det": rows[i], "gt_label": gt_label[start:start + g]
                .astype(np.float32), "gt_box": gt_box[start:start + g]},
                fetch_list=ev.metrics, scope=fluid.Scope())
            ev.update(mv)
            start += g
        maps.append(float(ev.eval()[0]))
    check(parted or abs(maps[0] - maps[1]) <= 1e-5 * max(1.0, maps[1]),
          "ssd DetectionMAP: card %r, CPU %r", maps[0], maps[1])
    # ms per batch: eager and one captured dispatch (K=1)
    graph_out = exe.run_steps(main, feeds=[feed], fetch_list=[dets],
                              scope=scope)
    torch.cuda.synchronize()
    check(np.array_equal(np.asarray(graph_out[0][0]), k_rows),
          "ssd detections: the CUDA graph's rows differ from eager's")
    walls = _ab_timing(torch, {
        "eager": lambda: exe.run(main, feed=feed, fetch_list=[dets],
                                 scope=scope),
        "graph": lambda: exe.run_steps(main, feeds=[feed],
                                       fetch_list=[dets], scope=scope)})
    one = op_sweep.one_op_program(
        fluid, "multiclass_nms", {"BBoxes": got[5], "Scores": got[6]},
        {a: nms.attr(a) for a in ("score_threshold", "nms_top_k",
                                  "keep_top_k", "nms_threshold",
                                  "normalized", "nms_eta",
                                  "background_label")}, ["Out"])
    nms_rows = _kernel_rows(torch, lambda: exe.run(
        one[0], feed=one[1], fetch_list=one[2], scope=fluid.Scope()))
    nms_launches = None if nms_rows is None else sum(r[1] for r in nms_rows)
    nms_ms = None if nms_rows is None else sum(r[0] for r in nms_rows) / 1e3
    log("ssd inference (batch %d, %d priors, %d classes): %d kept rows, "
        "card rows %s the CPU's; DetectionMAP (11-point, class_num 5) card "
        "%.6f, CPU %.6f; ms per batch eager %s (median %.3f), one CUDA "
        "graph %s (median %.3f); one multiclass_nms: %s launches, %s ms of "
        "device time (%d rounds: min(priors, nms_top_k)); %s", n, m, c,
        kept, "equal to" if not parted else "at near-ties with", *maps,
        " ".join("%.3f" % x for x in walls["eager"]),
        _median(walls["eager"]), " ".join("%.3f" % x for x in
                                          walls["graph"]),
        _median(walls["graph"]), nms_launches,
        "not measured" if nms_ms is None else "%.3f" % nms_ms,
        min(m, nms.attr("nms_top_k")), smi)
    return {"eager_ms": _median(walls["eager"]),
            "graph_ms": _median(walls["graph"]),
            "nms_launches": nms_launches, "nms_device_ms": nms_ms,
            "map": maps[0], "parted_images": len(parted)}


def ctc_phase(torch):
    """(d) CTC at batch 32, T 64, 32 classes, label lengths 5..20 (input
    lengths 40..64; the last sequence cannot align: 5 equal labels in 6
    steps): warpctc's loss on the card against the port on the CPU at
    rtol 1e-5, its gradient within 1e-5 of its largest value (the
    CPU's own fp32 rounding logged beside it, against F.ctc_loss in
    float64); ``torch.nn.functional.ctc_loss`` as an
    independent control on the feasible sequences at rtol 1e-4 (it gives
    inf where the port, as the JAX package, gives a huge finite loss);
    ``ctc_greedy_decoder`` on the card equal to the CPU's."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.tools import op_sweep
    b, t, c = CTC["batch"], CTC["t"], CTC["classes"]
    rng = np.random.RandomState(16)
    lab_lens = rng.randint(CTC["label_lens"][0], CTC["label_lens"][1] + 1,
                           size=b)
    in_lens = rng.randint(40, t + 1, size=b)
    in_lens[-1], lab_lens[-1] = 6, 5
    logits = rng.randn(int(in_lens.sum()), c).astype(np.float32)
    labels = rng.randint(1, c, (int(lab_lens.sum()), 1)).astype(np.int32)
    labels[-5:] = 3
    S = op_sweep.Seq
    prog, feed, fetch = op_sweep.one_op_program(
        fluid, "warpctc", {"Logits": S(logits, in_lens.tolist()),
                           "Label": S(labels, lab_lens.tolist())},
        {"blank": 0}, ["Loss"], ["Logits"])
    res = [fluid.Executor(place).run(prog, feed=feed, fetch_list=fetch,
                                     scope=fluid.Scope())
           for place in (fluid.CUDAPlace(0), fluid.CPUPlace())]
    (loss_k, grad_k), (loss_c, grad_c) = res
    loss_err = float(np.max(np.abs(loss_k - loss_c) / np.abs(loss_c)))
    grad_err = float(np.abs(grad_k - grad_c).max()) / float(
        np.abs(grad_c).max())
    check(np.allclose(loss_k, loss_c, rtol=CTC_RTOL, atol=0),
          "ctc: the card's loss is %g (relative) from the CPU's", loss_err)
    check(grad_err <= CTC_RTOL, "ctc: the card's gradient is %g (of its "
          "largest value) from the CPU's, limit %g", grad_err, CTC_RTOL)
    dev = torch.device("cuda")
    padded = torch.zeros((t, b, c), device=dev)
    starts = np.concatenate([[0], np.cumsum(in_lens)[:-1]])
    for i, (s, n) in enumerate(zip(starts, in_lens)):
        padded[:n, i] = torch.from_numpy(logits[s:s + n]).to(dev)
    ref = torch.nn.functional.ctc_loss(
        torch.log_softmax(padded, -1),
        torch.from_numpy(labels.ravel().astype(np.int64)).to(dev),
        torch.from_numpy(in_lens.astype(np.int64)),
        torch.from_numpy(lab_lens.astype(np.int64)), blank=0,
        reduction="none").cpu().numpy()
    ctl_err = float(np.max(np.abs(loss_k.ravel()[:-1] - ref[:-1])
                           / np.abs(ref[:-1])))
    # the CPU gradient's own fp32 rounding: F.ctc_loss in float64 on the
    # feasible sequences (their rows of the flat logits), for the log
    x64 = torch.from_numpy(logits[:starts[-1]].astype(np.float64))
    x64.requires_grad_(True)
    pad64 = torch.zeros((t, b - 1, c), dtype=torch.float64)
    for i, (s, n) in enumerate(zip(starts[:-1], in_lens[:-1])):
        pad64[:n, i] = x64[s:s + n]
    torch.nn.functional.ctc_loss(
        torch.log_softmax(pad64, -1),
        torch.from_numpy(labels.ravel()[:-lab_lens[-1]].astype(np.int64)),
        torch.from_numpy(in_lens[:-1].astype(np.int64)),
        torch.from_numpy(lab_lens[:-1].astype(np.int64)), blank=0,
        reduction="sum").backward()
    f64_err = float((x64.grad - torch.from_numpy(
        grad_c[:starts[-1]])).abs().max()) / float(x64.grad.abs().max())
    check(ctl_err <= 1e-4 and np.isinf(ref[-1])
          and 1e29 < loss_k.ravel()[-1] < np.inf, "ctc: against "
          "F.ctc_loss %g (limit 1e-4); the impossible sequence %r (port) "
          "and %r (F.ctc_loss)", ctl_err, loss_k.ravel()[-1], ref[-1])
    main = fluid.Program()
    with fluid.program_guard(main, fluid.Program()), \
            fluid.unique_name.guard():
        x = fluid.layers.data("logits", [c], lod_level=1)
        decoded = fluid.layers.ctc_greedy_decoder(x, blank=0)
    lod = fluid.create_lod_tensor(logits, [in_lens.tolist()])
    outs = [fluid.Executor(place).run(main, feed={"logits": lod},
                                      fetch_list=[decoded],
                                      scope=fluid.Scope())[0]
            for place in (fluid.CUDAPlace(0), fluid.CPUPlace())]
    check(np.array_equal(*outs), "ctc_greedy_decoder: card and CPU differ")
    log("ctc (batch %d, T up to %d, %d classes, labels %d..%d): warpctc "
        "loss card vs CPU within %.3g (relative; limit %g), gradient "
        "within %.3g of its largest value (limit %g; the CPU's own fp32 "
        "gradient is %.3g of its largest from F.ctc_loss's in float64 on "
        "the feasible sequences); the control F.ctc_loss within %.3g on "
        "the %d feasible sequences; the impossible one %.4g (port) and %r "
        "(F.ctc_loss); ctc_greedy_decoder's %d decoded ids equal on card "
        "and CPU", b, t, c, CTC["label_lens"][0], CTC["label_lens"][1],
        loss_err, CTC_RTOL, grad_err, CTC_RTOL, f64_err, ctl_err, b - 1,
        loss_k.ravel()[-1], float(ref[-1]), outs[0].shape[0])
    return max(loss_err, grad_err)


def crf_detection_phase(torch, smi):
    """Phase 16."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.tools import op_sweep
    t0 = time.perf_counter()
    srl_launches, srl_graph, srl = srl_phase(torch, smi)
    t1 = time.perf_counter()
    train_prog, infer_prog = _ssd_programs(fluid)
    state, batch, ssd_timing = ssd_train_phase(torch, smi, train_prog)
    lens = batch["gt_box"].recursive_sequence_lengths()[-1]
    infer = ssd_infer_phase(torch, smi, infer_prog, state, batch["image"],
                            (batch["gt_box"].data, batch["gt_label"].data,
                             lens))
    t2 = time.perf_counter()
    ctc_err = ctc_phase(torch)
    held, worst = op_sweep.run("cuda", part="detection")
    check(len(held) == 14, "detection op sweep held %d op types, want 14",
          len(held))
    t3 = time.perf_counter()
    log("detection op sweep: %d op types held on the card against the CPU "
        "(forward rtol %g / atol %g, gradients rtol %g / atol %g); largest "
        "forward |difference| %.3g", len(held), op_sweep.FWD_RTOL,
        op_sweep.FWD_ATOL, op_sweep.GRAD_RTOL, op_sweep.GRAD_ATOL, worst)
    log("crf/detection: phase 16 took %.1f s (srl %.1f s, ssd %.1f s, ctc "
        "and the op sweep %.1f s)", t3 - t0, t1 - t0, t2 - t1, t3 - t2)
    return srl_launches, srl_graph, {"srl": srl, "ssd_train": ssd_timing,
                                     "ssd_infer": infer, "ctc_err": ctc_err}


# -- phase 17 ------------------------------------------------------------
# (a) the reference book's image_classification ResNet: resnet_cifar10 at
# depth 32, batch 128, Adam 1e-3, fp32, fed from cifar10 through recordio
# files, open_files, shuffle, batch and DataFeeder
DATA = dict(depth=32, batch=128, k=5, dispatches=4, recordio_files=2)
DATA_SHORTCUTS = [(32768, 16, 32), (8192, 32, 64)]   # the 1x1 projections
# (c) the book's understand_sentiment stacked_lstm_net at the reference
# function's default widths, over imdb
SENTI = dict(emb=128, hid=512, stacked=3, batch=64, batches=8,
             run_steps=3, k=5)
DATA_PAIRS = 2


def _cifar_program(fluid):
    """The book's image_classification net: resnet_cifar10(images, 32),
    cross-entropy, Adam 1e-3."""
    from paddle_tpu_torch.models import resnet as R
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        images = fluid.layers.data("pixel", [3, 32, 32])
        label = fluid.layers.data("label", [1], dtype="int64")
        predict = R.resnet_cifar10(images, DATA["depth"])
        avg_cost = fluid.layers.mean(fluid.layers.cross_entropy(predict,
                                                                label))
        fluid.layers.accuracy(predict, label)
        fluid.optimizer.Adam(learning_rate=0.001).minimize(avg_cost)
    block = main.global_block()
    bn_in = {op.input("X")[0] for op in block.ops
             if op.type == "batch_norm" and not op.attr("is_test", False)}
    shapes = []
    for op in block.ops:
        co, ci, kh, kw = block.vars[op.input("Filter")[0]].shape \
            if op.type == "conv2d" else (0, 0, 0, 0)
        out = op.output("Output")[0] if op.type == "conv2d" else None
        if (kh, kw) == (1, 1) and out in bn_in:
            _, _, ho, wo = block.vars[out].shape
            shapes.append((DATA["batch"] * ho * wo, ci, co))
    return (main, startup, avg_cost), [images, label], shapes


def _cifar_feeds(fluid, tmp, feed_vars, main):
    """The host feed dicts of DATA["dispatches"] x k steps: cifar10
    samples written to recordio files by the port's writer, read back by
    layers.open_files(thread_num=2) (every sample once: held), then
    shuffle, batch and DataFeeder."""
    import random
    n = DATA["batch"] * DATA["k"] * DATA["dispatches"]
    samples = list(fluid.dataset.cifar.train10(n)())
    t0 = time.perf_counter()
    per = -(-n // DATA["recordio_files"])
    paths = []
    for f in range(DATA["recordio_files"]):
        path = os.path.join(tmp, "cifar-%02d.recordio" % f)
        part = samples[f * per:(f + 1) * per]
        count = fluid.recordio.convert_reader_to_recordio_file(
            path, lambda part=part: iter(part))
        check(count == len(part), "recordio wrote %d of %d samples",
              count, len(part))
        paths.append(path)
    t1 = time.perf_counter()
    back = list(fluid.layers.open_files(paths, thread_num=2)())
    t2 = time.perf_counter()

    def key(s):
        return int(s[1]), np.asarray(s[0]).tobytes()
    check(len(back) == n and sorted(map(key, back)) ==
          sorted(map(key, samples)), "open_files read back %d samples, "
          "not the %d written", len(back), n)
    random.seed(0)
    reader = fluid.batch(fluid.reader.shuffle(lambda: iter(back), n),
                         DATA["batch"])
    feeder = fluid.DataFeeder(feed_vars, fluid.CPUPlace(), program=main)
    feeds = [feeder.feed(b) for b in reader()]
    t3 = time.perf_counter()
    from paddle_tpu_torch import native
    log("data (a): %d cifar10 samples through the port's recordio (%s, "
        "built with g++ and zlib into %s): written to %d files (%d bytes) "
        "in %.3f s, read back by open_files(thread_num=2) in %.3f s, every "
        "sample once; shuffle, batch(%d), DataFeeder: %d feeds (pixel %s "
        "%s, label %s %s) in %.3f s", n, os.path.basename(
            native.load("recordio")._name), native.BUILD_DIR, len(paths),
        sum(os.path.getsize(p) for p in paths), t1 - t0, t2 - t1,
        DATA["batch"], len(feeds), feeds[0]["pixel"].shape,
        feeds[0]["pixel"].dtype, feeds[0]["label"].shape,
        feeds[0]["label"].dtype, t3 - t2)
    return feeds


def _loader_dispatches(torch, fluid, exe, main, avg_cost, scope, feeds,
                       mark=None):
    """The feeds through DeviceLoader.megabatches(k) into
    run_steps(feeds=stack, k=k); returns the losses (device tensors) and
    the loader's feed-plan cache. ``mark`` is called once the first
    dispatch has been issued."""
    from paddle_tpu_torch.reader import DeviceLoader
    out = []
    loader = DeviceLoader(iter(feeds), capacity=2, device=exe.device)
    for i, stack in enumerate(loader.megabatches(DATA["k"])):
        k = int(stack["pixel"].shape[0])
        check(stack["pixel"].device == exe.device and
              stack["label"].dtype == torch.int32, "the loader staged "
              "%s %s, not %s int32", stack["pixel"].device,
              stack["label"].dtype, exe.device)
        out += [o[0] for o in exe.run_steps(
            main, feeds=stack, k=k, fetch_list=[avg_cost], scope=scope,
            return_numpy=False)]
        if i == 0 and mark is not None:
            mark()
    torch.cuda.synchronize()
    return out, loader._plans


def _list_dispatches(torch, exe, main, avg_cost, scope, feeds, mark=None):
    out = []
    for i in range(0, len(feeds), DATA["k"]):
        out += [o[0] for o in exe.run_steps(
            main, feeds=feeds[i:i + DATA["k"]], fetch_list=[avg_cost],
            scope=scope, return_numpy=False)]
        if i == 0 and mark is not None:
            mark()
    torch.cuda.synchronize()
    return out


def _plan_counts(cache, since=(0, 0, 0)):
    """(hits, misses, buffer_reuses) of a FeedPlanCache, less ``since``."""
    return tuple(a - b for a, b in zip(
        (cache.hits, cache.misses, cache.buffer_reuses), since))


def _plan_cost(feeds, device, rounds=20):
    """Host microseconds a feed dict to normalize these feeds: derived
    every call (no cache), through a fresh FeedPlanCache (the first pass
    over the feeds: a miss for each new signature) and through the same
    cache again (every signature seen). Medians over ``rounds``."""
    from paddle_tpu_torch.core.executor import FeedPlanCache, \
        _normalize_feeds
    us = {"derived": [], "cache_first_pass": [], "cache_seen": []}
    for _ in range(rounds):
        cache = FeedPlanCache(device_fn=lambda: device)
        for what, kw in (("derived", {}),
                         ("cache_first_pass", {"plan_cache": cache}),
                         ("cache_seen", {"plan_cache": cache})):
            t0 = time.perf_counter()
            for f in feeds:
                _normalize_feeds(f, **kw)
            us[what].append(1e6 * (time.perf_counter() - t0) / len(feeds))
    out = {k: _median(v) for k, v in us.items()}
    out["signatures"] = len({FeedPlanCache._key(f) for f in feeds})
    return out


def _busy_in(spans, lo, hi):
    """Seconds of [lo, hi) (trace microseconds) covered by the union of
    ``spans`` (sorted (start, end) pairs)."""
    busy, reach = 0.0, lo
    for a, b in spans:
        a, b = max(a, reach), min(b, hi)
        if b > a:
            busy += b - a
            reach = b
    return busy / 1e6


def _trace_summary(prof, tmp):
    """One pass over the trace's chrome export: the host-to-device bytes
    by stream, the streams that ran kernels, the ten kernels with the
    most device time, and the device busy share (the union of kernel,
    copy and memset spans, so overlapping streams count once) of the
    ``chip_smoke.run`` range and of its ``chip_smoke.steady`` part. None
    when the trace holds no device work."""
    path = os.path.join(tmp, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)
    events = events.get("traceEvents", events) \
        if isinstance(events, dict) else events
    copies, kernels, ranges, spans, by_name = {}, set(), {}, [], {}
    for ev in events:
        cat, name = str(ev.get("cat", "")), str(ev.get("name", ""))
        args = ev.get("args") or {}
        stream = args.get("stream", ev.get("tid"))
        if cat == "user_annotation" and name.startswith("chip_smoke."):
            ranges[name] = (float(ev["ts"]),
                            float(ev["ts"]) + float(ev.get("dur", 0)))
        if cat not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        ts, dur = float(ev["ts"]), float(ev.get("dur", 0))
        spans.append((ts, ts + dur))
        if cat == "gpu_memcpy" and "HtoD" in name:
            copies[stream] = copies.get(stream, 0) + int(
                args.get("bytes", 0))
        elif cat == "kernel":
            kernels.add(stream)
            t, c = by_name.get(name, (0.0, 0))
            by_name[name] = (t + dur, c + 1)
    if not spans:
        return None
    spans.sort()
    busy = {}
    for part in ("run", "steady"):
        lo, hi = ranges.get("chip_smoke." + part, (None, None))
        busy[part] = None if lo is None or hi <= lo else \
            _busy_in(spans, lo, hi) / ((hi - lo) / 1e6)
    top = sorted(((t / 1e3, c, n) for n, (t, c) in by_name.items()),
                 reverse=True)[:10]
    return {"copies": copies, "kernel_streams": kernels, "busy": busy,
            "top": top}


def data_resnet_phase(torch, smi, tmp):
    """Phase 17 (a)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import flags
    prog, feed_vars, shapes = _cifar_program(fluid)
    main, startup, avg_cost = prog
    check(shapes == DATA_SHORTCUTS, "resnet_cifar10's fusable 1x1 convs "
          "are %s, expected the two projection shortcuts %s", shapes,
          DATA_SHORTCUTS)
    feeds = _cifar_feeds(fluid, tmp, feed_vars, main)
    steps = len(feeds)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    s0 = fluid.Scope()
    exe.run(startup, scope=s0)
    init = {n: s0.get_numpy(n) for n in s0.local_var_names()
            if s0.find_var(n) is not None}
    names = sorted(init)
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with _fuse(flags, True):
            sa = _scope_from(fluid, init, exe.device)
            before = _plan_counts(exe._feed_plans)
            t0 = time.perf_counter()
            eager = [exe.run(main, feed=f, fetch_list=[avg_cost], scope=sa,
                             return_numpy=False)[0] for f in feeds]
            torch.cuda.synchronize()
            eager_s = time.perf_counter() - t0
            plans = {"run": _plan_counts(exe._feed_plans, before)}
            # the first dispatch captures the K=5 graph while the
            # loader's worker stages the next stacks (it waits on the
            # capture lock), the others replay it
            sb = _scope_from(fluid, init, exe.device)
            _reset_launches()
            replays = exe.stats["graph_replays"]
            captures = exe.stats["graph_captures"]
            t0 = time.perf_counter()
            loaded, loader_plans = _loader_dispatches(
                torch, fluid, exe, main, avg_cost, sb, feeds)
            loader_s = time.perf_counter() - t0
            plans["loader"] = _plan_counts(loader_plans)
            counts = _launches()
            check(exe.stats["graph_replays"] - replays == DATA["dispatches"]
                  and exe.stats["graph_captures"] - captures == 1,
                  "data (a): %d replays and %d captures for %d loader "
                  "dispatches", exe.stats["graph_replays"] - replays,
                  exe.stats["graph_captures"] - captures,
                  DATA["dispatches"])
            log("data (a): %d loader-fed dispatches (the first captured "
                "the K=%d graph with the loader's worker running) in %.3f "
                "s", DATA["dispatches"], DATA["k"], loader_s)
            sc = _scope_from(fluid, init, exe.device)
            before = _plan_counts(exe._feed_plans)
            listed = _list_dispatches(torch, exe, main, avg_cost, sc, feeds)
            plans["list"] = _plan_counts(exe._feed_plans, before)
            cost = _plan_cost(feeds, exe.device)
            _log_plans("data (a)", plans, cost, len(feeds), smi)
            le = [float(x) for x in eager]
            check(all(np.isfinite(le)), "data (a): eager losses not finite")
            for what, got, scope in (("the loader's stacks", loaded, sb),
                                     ("the host lists", listed, sc)):
                same = [torch.equal(a, b) for a, b in zip(eager, got)]
                differ = _same_state(torch, sa, scope, names)
                log("data (a): %d run() steps vs %d run_steps(K=%d) "
                    "dispatches fed %s: losses %s; %s", steps,
                    DATA["dispatches"], DATA["k"], what,
                    "bitwise equal" if all(same) else
                    "differ at steps %s" % [i + 1 for i, s in
                                            enumerate(same) if not s],
                    "every one of %d state tensors bitwise equal"
                    % len(names) if not differ else "%d state tensors "
                    "differ (first %s)" % (len(differ), differ[0]))
                check(all(same) and not differ, "data (a): run_steps fed "
                      "%s is not bitwise equal to %d run() calls", what,
                      steps)
            log("data (a): losses %s", " ".join("%.5f" % x for x in le))
            check(le[-1] < le[0], "data (a): the loss did not fall: %r", le)
            # the capture's warm-up runs one step eagerly, on copies of
            # the state, before the graph is recorded: its launches ran
            mm = counts["matmul_stats"]
            check(mm == len(DATA_SHORTCUTS) * (steps + 1), "data (a): "
                  "matmul_stats launched %d times in %d steps and the "
                  "capture's warm-up step, want %d a step (the two "
                  "projection shortcuts)", mm, steps, len(DATA_SHORTCUTS))
            log("data (a): matmul_stats launches %d in %d steps through "
                "the loader's graphs and the capture's warm-up step = %d "
                "a step: one for each 1x1 stride-2 projection shortcut "
                "feeding a train batch norm (16->32 at M=%d, 32->64 at "
                "M=%d; the other 31 convs are 3x3, and the shortcut's "
                "backward is two torch.matmul calls)", mm, steps,
                mm // (steps + 1), DATA_SHORTCUTS[0][0],
                DATA_SHORTCUTS[1][0])
            t0 = time.perf_counter()
            timing = _data_timing(torch, fluid, exe, main, avg_cost, init,
                                  feeds, smi, tmp)
            log("data (a): timing and tracing took %.1f s",
                time.perf_counter() - t0)
            timing["eager_images_per_s"] = DATA["batch"] * steps / eager_s
            log("data (a): 20 eager run() steps %.3f s = %.1f images/s "
                "(graphs not yet captured; includes the first step's "
                "warm-up); %s", eager_s, timing["eager_images_per_s"], smi)
    finally:
        torch.backends.cudnn.deterministic = det
    timing["feed_plans"] = dict(plans, host_us=cost)
    return mm, timing


def _log_plans(what, plans, cost, n, smi):
    """The feed-plan caches' (hits, misses, buffer reuses) by route, and
    the host time a feed dict to normalize with and without a cache."""
    log("%s: feed-plan cache (hits, misses, buffer reuses) by route: %s; "
        "the DataFeeder's arrays are writeable, so none is committed",
        what, ", ".join("%s %s" % kv for kv in plans.items()))
    log("%s: normalizing a feed dict on the host (%d feeds, %d "
        "signatures; medians of 20 rounds): derived every call %.2f us, "
        "through a fresh cache %.2f us, through a cache that has seen "
        "them %.2f us; %s", what, n, cost["signatures"], cost["derived"],
        cost["cache_first_pass"], cost["cache_seen"], smi)


def _data_timing(torch, fluid, exe, main, avg_cost, init, feeds, smi, tmp):
    """images/s fed by the loader and by the host lists, DATA_PAIRS
    pairs in turns (medians); then one traced run of each: the device
    busy share of the whole run and of its steady part (from the second
    dispatch's issue), and which streams the host-to-device copies ran
    on."""
    from torch.profiler import ProfilerActivity, profile, record_function
    n = DATA["batch"] * len(feeds)
    routes = {
        "loader": lambda s, mark=None: _loader_dispatches(
            torch, fluid, exe, main, avg_cost, s, feeds, mark)[0],
        "list": lambda s, mark=None: _list_dispatches(
            torch, exe, main, avg_cost, s, feeds, mark)}
    scopes = {r: _scope_from(fluid, init, exe.device) for r in routes}
    walls = {r: [] for r in routes}
    for _ in range(DATA_PAIRS):
        for r, fn in routes.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(scopes[r])
            walls[r].append(time.perf_counter() - t0)
    out = {}
    for r, fn in routes.items():
        # the whole run traced; its steady part starts where the second
        # dispatch is issued (the loader's worker running and ahead)
        steady = []

        def mark():
            steady.append(record_function("chip_smoke.steady"))
            steady[0].__enter__()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function("chip_smoke.run"):
                t0 = time.perf_counter()
                fn(scopes[r], mark)
                wall = time.perf_counter() - t0
                steady[0].__exit__(None, None, None)
        t1 = time.perf_counter()
        trace = _trace_summary(prof, tmp)
        log("data (a): reading the trace took %.1f s",
            time.perf_counter() - t1)
        busy = trace and trace["busy"]["steady"]
        if trace is None:
            log("data (a) profile, fed by the %s: the trace held no "
                "device work (busy share and the copies' streams not "
                "measured)", r)
        else:
            log("data (a) profile (traced, %d steps fed by the %s, %.3f ms "
                "a step): device busy %s of the whole run, %s from the "
                "second dispatch's issue to the end (the steady state); "
                "%s", len(feeds), r, 1e3 * wall / len(feeds),
                *("not measured" if b is None else "%.1f%%" % (100 * b)
                  for b in (trace["busy"]["run"], busy)), smi)
            for ms, count, name in trace["top"]:
                log("  %9.3f ms  x%-6d %s", ms, count, name[:70])
        rates = [n / w for w in walls[r]]
        out[r] = {"images_per_s": _median(rates), "busy": busy,
                  "busy_whole_run": trace and trace["busy"]["run"],
                  "step_ms": _median([1e3 * w / len(feeds)
                                      for w in walls[r]]),
                  "traced_step_ms": 1e3 * wall / len(feeds)}
        log("data (a) timing, fed by the %s (%d pairs in turns): images/s "
            "%s (median %.1f), step ms %.3f; device busy %s; %s", r,
            DATA_PAIRS, " ".join("%.1f" % x for x in rates),
            out[r]["images_per_s"], out[r]["step_ms"], "not measured"
            if busy is None else "%.1f%%" % (100 * busy), smi)
        if trace is None:
            continue
        copies, kernels = trace["copies"], trace["kernel_streams"]
        big = {s: b for s, b in copies.items() if b >= 1 << 20}
        log("data (a), fed by the %s: host-to-device bytes by stream %s; "
            "kernels ran on %d streams (a graph's replay spreads over "
            "several); the copies of 1 MiB or more ran on %s", r, copies,
            len(kernels), "streams that ran no kernel" if big and not
            set(big) & kernels else "a kernel stream" if big else
            "no stream (none that large)")
        out[r]["copy_streams"] = {str(s): b for s, b in copies.items()}
        out[r]["copies_off_compute_stream"] = bool(big) and not (
            set(big) & kernels)
    return out


def data_mm_phase(torch):
    """Phase 17 (b): matmul_stats at the two shortcut shapes, fp32, held
    against its plain version at phase 7's tolerances and timed as phase
    7 times a shape."""
    from paddle_tpu_torch.ops import matmul_stats as MS
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    worst, rows = 0.0, []
    for i, (m, k, n) in enumerate(DATA_SHORTCUTS):
        e = _mm_case(torch, MS, m, k, n, torch.float32, seed=170 + i,
                     grads=True)
        worst = max(worst, e["y"], e["s1"], e["s2"])
        x, w_nk, c = _mm_inputs(torch, m, k, n, torch.float32, seed=m + n)
        w = w_nk.t()
        t = {"ms": _events_ms(torch, lambda i: MS._fwd_cuda(x, w, c), 20,
                              hide_host=True),
             "plain_ms": _events_ms(
                 torch, lambda i: MS._dense_matmul_stats(x, w, c), 10,
                 hide_host=True),
             "library_ms": _events_ms(torch, lambda i: torch.matmul(x, w),
                                      20, hide_host=True),
             "ms_with_host_gaps": _events_ms(
                 torch, lambda i: MS._fwd_cuda(x, w, c), 20)}
        flops, nbytes = _mm_work(m, k, n)
        ops_ms = flops / TF32_FLOPS * 1e3
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        t["bound_ms"] = max(ops_ms, bytes_ms)
        t["bound_by"] = "operations" if ops_ms >= bytes_ms else "bytes"
        bm, bn, blocks = MS._tile(m, n)
        check(blocks >= sms or t["bound_by"] == "bytes", "matmul_stats "
              "M=%d N=%d: %d blocks of %dx%d for %d SMs, and not bound by "
              "bytes", m, n, blocks, bm, bn, sms)
        t.update(m=m, k=k, n=n, max_abs_err=max(e["y"], e["s1"], e["s2"]))
        rows.append(t)
        log("data (b): matmul_stats M=%d K=%d N=%d fp32: max_abs_err y "
            "%.2e s1 %.2e s2 %.2e dx %.2e dw %.2e  ok; device time alone "
            "kernel_ms=%.5f bound_ms=%.5f (%s: %d flops, %d bytes) "
            "plain_ms=%.5f library_ms=%.5f (torch.matmul, product only); "
            "with the host's gaps kernel_ms=%.5f; tile %dx%d, %d blocks "
            "for %d SMs", m, k, n, e["y"], e["s1"], e["s2"], e["dx"],
            e["dw"], t["ms"], t["bound_ms"], t["bound_by"], flops, nbytes,
            t["plain_ms"], t["library_ms"], t["ms_with_host_gaps"], bm, bn,
            blocks, sms)
    return worst, rows


def _sentiment_program(fluid):
    """The book's understand_sentiment stacked_lstm_net at the reference
    function's defaults (emb 128, hid 512: dynamic_lstm of 128 units, 3
    stacked, the later pairs reversed), max pools, softmax over 2
    classes, Adam 2e-3."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        L = fluid.layers
        data = L.data("words", [1], dtype="int64", lod_level=1)
        label = L.data("label", [1], dtype="int64")
        emb = L.embedding(data, size=[fluid.dataset.imdb.VOCAB_SIZE,
                                      SENTI["emb"]])
        fc1 = L.fc(emb, SENTI["hid"])
        lstm1, _ = L.dynamic_lstm(fc1, size=SENTI["hid"])
        inputs = [fc1, lstm1]
        for _ in range(2, SENTI["stacked"] + 1):
            fc = L.fc(L.concat(inputs, axis=1), SENTI["hid"])
            lstm, _ = L.dynamic_lstm(fc, size=SENTI["hid"], is_reverse=True)
            inputs = [fc, lstm]
        pred = L.fc(L.concat([L.sequence_pool(inputs[0], "max"),
                              L.sequence_pool(inputs[1], "max")], axis=1),
                    2, act="softmax")
        loss = L.mean(L.cross_entropy(pred, label))
        fluid.optimizer.Adam(learning_rate=0.002).minimize(loss)
    return main, startup, loss, [data, label]


def data_lod_phase(torch, smi):
    """Phase 17 (c)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops import lstm_cell as LC
    from paddle_tpu_torch.reader import DeviceLoader
    main, startup, loss, feed_vars = _sentiment_program(fluid)
    reader = fluid.batch(fluid.dataset.imdb.train(
        n=SENTI["batch"] * SENTI["batches"]), SENTI["batch"])
    feeder = fluid.DataFeeder(feed_vars, fluid.CPUPlace(), program=main)
    feeds = [feeder.feed(b) for b in reader()]
    lens = [f["words"].recursive_sequence_lengths()[0] for f in feeds]

    def bucket(i):
        """(bucketed token total, @MAXLEN) of batch i: run_steps'
        signature of a LoD feed"""
        return (1 << (sum(lens[i]) - 1).bit_length(),
                1 << (max(lens[i]) - 1).bit_length())
    # the K=5 dispatch takes the first K batches of the first batch's
    # signature (run_steps captures one signature; a batch of another
    # bucket is run() on its own, as its error message says)
    group = [i for i in range(len(feeds)) if bucket(i) == bucket(0)]
    check(len(group) >= SENTI["k"] and all(
        bucket(i)[1] == bucket(0)[1] for i in range(len(feeds))),
        "data (c): %d of %d batches share the first one's bucket %s "
        "(buckets %s)", len(group), len(feeds), bucket(0),
        [bucket(i) for i in range(len(feeds))])
    maxlen = bucket(0)[1]
    exe = fluid.Executor(fluid.CUDAPlace(0))
    s0 = fluid.Scope()
    exe.run(startup, scope=s0)
    init = {n: s0.get_numpy(n) for n in s0.local_var_names()
            if s0.find_var(n) is not None}
    names = sorted(init)
    steps = SENTI["run_steps"]

    # run(): fed by the loader's per-batch iterator against direct feeds
    sd = _scope_from(fluid, init, exe.device)
    before = _plan_counts(exe._feed_plans)
    direct = [exe.run(main, feed=f, fetch_list=[loss], scope=sd,
                      return_numpy=False)[0] for f in feeds[:steps]]
    plans = {"run": _plan_counts(exe._feed_plans, before)}
    sl = _scope_from(fluid, init, exe.device)
    LC.lstm_scan.launches = 0
    loaded = []
    before = _plan_counts(exe._feed_plans)
    loader = DeviceLoader(iter(feeds[:steps]), device=exe.device)
    for batch in loader:
        check(isinstance(batch["words"], fluid.LoDTensor) and
              batch["label"].device == exe.device, "data (c): the loader "
              "did not pass the LoD feed through (%s) or stage the label "
              "(%s)", type(batch["words"]).__name__, batch["label"].device)
        loaded.append(exe.run(main, feed=batch, fetch_list=[loss],
                              scope=sl, return_numpy=False)[0])
    torch.cuda.synchronize()
    eager_launches = LC.lstm_scan.launches
    plans["loader"] = _plan_counts(loader._plans)
    plans["loader-fed run"] = _plan_counts(exe._feed_plans, before)
    _log_plans("data (c)", plans, _plan_cost(feeds, exe.device),
               len(feeds), smi)
    per_step = SENTI["stacked"] * maxlen * 2
    same = all(torch.equal(a, b) for a, b in zip(direct, loaded))
    differ = _same_state(torch, sd, sl, names)
    log("data (c): stacked_lstm_net (emb %d, hid %d, %d stacked; imdb, "
        "batch %d, @MAXLEN %d, tokens a batch %s): %d run() steps fed by "
        "DeviceLoader (LoD passed through) vs fed the DataFeeder's dicts: "
        "losses %s (%s); %s; lstm_cell launches %d (%d a step: %d layers x "
        "%d steps x forward and backward)", SENTI["emb"], SENTI["hid"],
        SENTI["stacked"], SENTI["batch"], maxlen,
        [sum(x) for x in lens], steps, " ".join(
            "%.5f" % float(x) for x in direct),
        "bitwise equal" if same else "DIFFER", "every state tensor "
        "bitwise equal" if not differ else "%d state tensors differ"
        % len(differ), eager_launches, per_step, SENTI["stacked"], maxlen)
    check(same and not differ, "data (c): run() fed by the loader is not "
          "bitwise equal to run() fed the DataFeeder's dicts")
    check(eager_launches == per_step * steps, "data (c): lstm_cell "
          "launched %d times in %d steps, want %d", eager_launches, steps,
          per_step * steps)

    # run_steps(k=5): a list of the loader's dicts against the direct list
    k = SENTI["k"]
    kfeeds = [feeds[i] for i in group[:k]]
    log("data (c): batches' (bucketed tokens, @MAXLEN) %s; the K=%d "
        "dispatch takes batches %s", [bucket(i) for i in range(len(feeds))],
        k, group[:k])
    via = list(DeviceLoader(iter(kfeeds), device=exe.device))
    sg = _scope_from(fluid, init, exe.device)
    LC.lstm_scan.launches = 0
    graph = exe.run_steps(main, feeds=via, fetch_list=[loss], scope=sg,
                          return_numpy=False)
    torch.cuda.synchronize()
    graph_launches = LC.lstm_scan.launches
    sh = _scope_from(fluid, init, exe.device)
    host = exe.run_steps(main, feeds=kfeeds, fetch_list=[loss],
                         scope=sh, return_numpy=False)
    se = _scope_from(fluid, init, exe.device)
    eager = [exe.run(main, feed=f, fetch_list=[loss], scope=se,
                     return_numpy=False)[0] for f in kfeeds]
    torch.cuda.synchronize()
    for what, got, scope in (("the DataFeeder's dicts as a list", host, sh),
                             ("%d run() calls" % k, eager, se)):
        same = all(torch.equal(a[0] if isinstance(a, list) else a,
                               b[0]) for a, b in zip(got, graph))
        differ = _same_state(torch, scope, sg, names)
        log("data (c): run_steps(K=%d) fed a list of the loader's dicts vs "
            "%s: losses %s; %s", k, what, "bitwise equal" if same else
            "DIFFER", "every state tensor bitwise equal" if not differ
            else "%d state tensors differ (first %s)" % (len(differ),
                                                          differ[0]))
        check(same and not differ, "data (c): run_steps fed the loader's "
              "dicts is not bitwise equal to %s", what)
    check(graph_launches == per_step * (k + 1), "data (c): the K=%d "
          "dispatch launched lstm_cell %d times, want %d a step and the "
          "capture's warm-up step", k, graph_launches, per_step)
    log("data (c): the K=%d dispatch's lstm_cell launches %d: %d a step "
        "through the replay and the capture's warm-up step", k,
        graph_launches, per_step)
    return eager_launches, graph_launches


def data_plane_phase(torch, smi):
    """Phase 17."""
    import tempfile
    t0 = time.perf_counter()
    work = os.path.join(ROOT, "build", "paddle_tpu_torch")
    os.makedirs(work, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=work) as tmp:
        mm_launches, timing = data_resnet_phase(torch, smi, tmp)
    t1 = time.perf_counter()
    mm_err, mm_rows = data_mm_phase(torch)
    t2 = time.perf_counter()
    lstm_eager, lstm_graph = data_lod_phase(torch, smi)
    t3 = time.perf_counter()
    log("data: phase 17 took %.1f s ((a) %.1f s, (b) %.1f s, (c) %.1f s)",
        t3 - t0, t1 - t0, t2 - t1, t3 - t2)
    return {"mm_launches": mm_launches, "mm_err": mm_err,
            "mm_shapes": mm_rows, "timing": timing,
            "lstm_launches": lstm_eager, "lstm_graph_launches": lstm_graph}


# -- phase 18 ------------------------------------------------------------
FRONT_STEPS = 3          # profiled LM steps
GUARD_STEPS = 10         # LM steps with the NaN guards on and off
GUARD_K, GUARD_BAD = 5, 3
NCE = dict(context=4, emb=32, hidden=256, batch=64, k=5)
TRANSPILE_RTOL = 1e-4
V2_PASSES = 2
FLASH_KERNELS = {"flash_fwd": "flash_fwd_kernel",
                 "flash_bwd_dq": "flash_bwd_dq_kernel",
                 "flash_bwd_dkv": "flash_bwd_dkv_kernel"}


def _flash_reset(F):
    for key in F.flash_attention.launches:
        F.flash_attention.launches[key] = 0


def _flash_read(F):
    return {"flash_" + k: v for k, v in F.flash_attention.launches.items()}


def _timed_steps(torch, exe, main, avg_cost, scope, batches):
    """(losses, mean step ms) of one run() a batch, synced."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [exe.run(main, feed=b, fetch_list=[avg_cost], scope=scope)[0]
              for b in batches]
    torch.cuda.synchronize()
    return losses, 1e3 * (time.perf_counter() - t0) / len(batches)


def _trace_rows(path):
    """[(device us, launches, name)] of the kernel events in the chrome
    trace at ``path``, one row a kernel name."""
    with open(path) as f:
        events = json.load(f)
    events = events.get("traceEvents", events) \
        if isinstance(events, dict) else events
    rows = {}
    for ev in events:
        if str(ev.get("cat", "")) == "kernel":
            row = rows.setdefault(str(ev.get("name", "")), [0.0, 0])
            row[0] += ev.get("dur", 0.0)
            row[1] += 1
    return [(us, n, name) for name, (us, n) in rows.items()]


def _trace_kernels(path, names):
    """{name: kernel events in the chrome trace at ``path`` whose name
    holds it}."""
    rows = _trace_rows(path)
    return {n: sum(c for _, c, k in rows if n in k) for n in names}


FRONT_CHILD = "--front-profile"     # phase 18 (a)'s own process


def _front_profile_child(tmp):
    """Phase 18 (a)'s measurements, run as ``chip_smoke.py --front-profile
    DIR``: FRONT_STEPS LM steps unprofiled, then FRONT_STEPS under
    fluid.profiler with profile_memory on (the device trace under DIR);
    prints one JSON line of what they counted and took."""
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.models import transformer as T
    from paddle_tpu_torch.ops import flash_attention as F
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    exe = fluid.Executor(fluid.CUDAPlace(0))
    main, startup, avg_cost = _lm_program(fluid, T, True)
    scope = _scope_from(fluid, _init_of(fluid, exe, startup), exe.device)
    batches = [T.make_lm_batch(np.random.RandomState(seed), TRAIN_BATCH,
                               MAX_LEN, VOCAB)
               for seed in range(FRONT_STEPS)]
    exe.run(main, feed=batches[0], fetch_list=[avg_cost], scope=scope)
    _, plain_ms = _timed_steps(torch, exe, main, avg_cost, scope, batches)
    path = os.path.join(tmp, "profile")
    torch.cuda.reset_peak_memory_stats()
    flags.set_flag("profile_memory", True)
    table = io.StringIO()
    _flash_reset(F)
    with contextlib.redirect_stdout(table), \
            fluid.profiler.profiler("All", "total", path):
        _, prof_ms = _timed_steps(torch, exe, main, avg_cost, scope,
                                  batches)
    trace = os.path.join(path, "device_trace.json")
    print(json.dumps({
        "launches": _flash_read(F), "plain_ms": plain_ms,
        "prof_ms": prof_ms, "table": table.getvalue().splitlines()[:12],
        "events": {k: v for k, v in fluid.profiler._events.items()
                   if k in ("exe.run(compiled)", "op:sp_attention")},
        "trace": _trace_kernels(trace, list(FLASH_KERNELS.values()))
        if os.path.exists(trace) else None,
        "check": fluid.profiler.last_device_trace_check(),
        "total": torch.cuda.get_device_properties(0).total_memory}))
    return 0


def front_profiler_phase(torch, smi, tmp):
    """Phase 18 (a), in a process of its own (``_front_profile_child``):
    the host table, the device trace against the launch counters, the
    peak, the profiled and unprofiled step ms. A process that has run the
    script's earlier phases (some twenty traces) saw its device trace
    miss one flash_fwd_kernel of 12 (PERF.md section 7); a fresh process
    has never missed one. Returns the flash launches."""
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           FRONT_CHILD, tmp], capture_output=True,
                          text=True, timeout=600, cwd=ROOT)
    check(proc.returncode == 0 and proc.stdout.strip(), "front (a): the "
          "profiled process failed (%d): %s", proc.returncode,
          proc.stderr[-3000:])
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    for line in out["table"]:
        log("front (a): | %s", line)
    launches = out["launches"]
    run_ev = out["events"].get("exe.run(compiled)")
    check(run_ev is not None and run_ev[0] == FRONT_STEPS,
          "front (a): the host table has %s exe.run(compiled) calls, want "
          "%d", run_ev and run_ev[0], FRONT_STEPS)
    attn = out["events"].get("op:sp_attention")
    check(attn is not None and attn[0] == N_LAYER * FRONT_STEPS,
          "front (a): op:sp_attention rows %s, want n_layer x steps = %d",
          attn and attn[0], N_LAYER * FRONT_STEPS)
    for key, n in launches.items():
        check(n == N_LAYER * FRONT_STEPS, "front (a): %s launches %d != "
              "n_layer x steps = %d", key, n, N_LAYER * FRONT_STEPS)
    in_trace = out["trace"]
    check(in_trace is not None, "front (a): no device trace")
    for key, kname in FLASH_KERNELS.items():
        check(in_trace[kname] == launches[key], "front (a): the device "
              "trace holds %d %s launches, the counter %d", in_trace[kname],
              kname, launches[key])
    mine = out["check"]["kernels"]
    check(all(mine[k] == {"launched": launches[k], "traced": in_trace[kn]}
              for k, kn in FLASH_KERNELS.items()), "front (a): the "
          "profiler's own trace check %s disagrees with the counters %s "
          "and the trace %s", mine, launches, in_trace)
    total, peak = out["total"], run_ev[3]
    check(0 < peak < total, "front (a): peak %d bytes not in (0, %d)",
          peak, total)
    log("front (a): %d LM steps profiled in a process of their own; "
        "exe.run(compiled) %d, op:sp_attention %d; device trace %s = "
        "counters %s; peak %.1f MB of %.1f GB; step %.3f ms profiled, %.3f "
        "ms unprofiled (%s); the profiler's trace check: %s",
        FRONT_STEPS, run_ev[0], attn[0], in_trace, launches, peak / 1e6,
        total / 1e9, out["prof_ms"], out["plain_ms"], smi, out["check"])
    return launches


def _unmatched_launches(path):
    """[(ms after the window opened, ms before it closed, thread, the
    runtime call, the innermost host range around it)] of the kernel
    launches in the chrome trace at ``path`` that have no kernel record
    (outside graph captures: the launches ``profiler._check_trace``
    counts as unmatched)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    window = next((e for e in events if e.get("cat") == "Trace"), None)
    recorded = {(e.get("args") or {}).get("correlation") for e in events
                if e.get("cat") == "kernel"}
    ranges = [e for e in events if e.get("cat") in ("cpu_op",
                                                    "user_annotation")
              and "dur" in e]
    out = []
    for e in events:
        if e.get("cat") not in ("cuda_runtime", "cuda_driver") \
                or "LaunchKernel" not in str(e.get("name")):
            continue
        if (e.get("args") or {}).get("correlation") in recorded:
            continue
        ts, tid = e["ts"], e.get("tid")
        around = [r for r in ranges if r.get("tid") == tid
                  and r["ts"] <= ts <= r["ts"] + r["dur"]]
        inner = min(around, key=lambda r: r["dur"])["name"] if around \
            else None
        if window is None:
            out.append((None, None, tid, e["name"], inner))
        else:
            out.append(((ts - window["ts"]) / 1e3,
                        (window["ts"] + window["dur"] - ts) / 1e3, tid,
                        e["name"], inner))
    return out


def front_profiler_inprocess(torch, fluid, F, exe, prog, init, batches,
                             tmp, smi):
    """Phase 18 (a'): the same FRONT_STEPS profiled LM steps in the
    script's own process, after its earlier phases' profiler sessions,
    where an unpadded trace once lost a flash_fwd_kernel and a padded one
    the block's first ~30 kernel records, 56 ms into its window (PERF.md
    section 7). Traced through the user-facing ``profiler.trace``: a
    warm-up cycle whose records it discards, the card idle at both edges
    of the recorded window, and the steps run and traced again while the
    profiler's check finds kernel records missing (at most
    ``profiler._TRACE_TRIES`` passes). The last trace's flash kernels
    must equal the launch counters over its pass (n_layer x 3), and the
    profiler must have warned exactly when that trace is incomplete.
    Returns the flash launches of all passes."""
    import warnings
    main, _, avg_cost = prog
    scope = _scope_from(fluid, init, exe.device)
    path = os.path.join(tmp, "profile_inprocess")
    _flash_reset(F)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        fluid.profiler.trace(lambda: _timed_steps(
            torch, exe, main, avg_cost, scope, batches[:FRONT_STEPS]), path)
    launches = _flash_read(F)
    trace = os.path.join(path, "device_trace.json")
    in_trace = _trace_kernels(trace, list(FLASH_KERNELS.values()))
    got = fluid.profiler.last_device_trace_check()
    warned = [str(w.message) for w in caught
              if issubclass(w.category, RuntimeWarning)
              and "incomplete" in str(w.message)]
    short = {k: got["kernels"][k]["launched"] - in_trace[kn]
             for k, kn in FLASH_KERNELS.items() if k in got["kernels"]
             and in_trace[kn] < got["kernels"][k]["launched"]}
    check(not short, "front (a'): after %d traced passes the trace lost "
          "flash records %s; the launches without a kernel record (ms "
          "after the window opened, ms before it closed, thread, call, "
          "innermost host range): %s", got["passes"], short,
          _unmatched_launches(trace)[:40])
    want = N_LAYER * FRONT_STEPS
    for key, kname in FLASH_KERNELS.items():
        check(launches[key] == got["passes"] * want and got["kernels"].get(
            key) == {"launched": want, "traced": in_trace[kname]},
              "front (a'): %s: counter %d over %d passes, the profiler's "
              "check of the last %s, its trace %d", key, launches[key],
              got["passes"], got["kernels"].get(key), in_trace[kname])
    check(bool(warned) == (not got["complete"]), "front (a'): the trace "
          "check says complete=%s and the profiler warned %d times",
          got["complete"], len(warned))
    log("front (a'): %d LM steps profiled in the script's process: device "
        "trace %s, counters %s; %s after %d traced pass(es); unmatched "
        "runtime launches %d (the earliest and the latest at %s ms from "
        "the trace's start); %s", FRONT_STEPS, in_trace, launches,
        "complete" if got["complete"] else "INCOMPLETE, and the profiler "
        "warned", got["passes"], got["unmatched_launches"],
        got["unmatched_at_ms"], smi)
    return launches


def _nan_batch(batch, rows=None):
    out = {k: (v[:rows] if rows else v).copy() for k, v in batch.items()}
    out["mask"][0, 1] = np.nan
    return out


def _nan_message(exe, main, avg_cost, scope, feed=None, steps=None):
    try:
        if steps is None:
            exe.run(main, feed=feed, fetch_list=[avg_cost], scope=scope)
        else:
            exe.run_steps(main, feeds=steps, fetch_list=[avg_cost],
                          scope=scope)
    except FloatingPointError as e:
        return str(e)
    return None


def front_guard_phase(torch, fluid, F, exe, prog, init, batches, smi):
    """Phase 18 (b): GUARD_STEPS LM steps guarded and unguarded, bitwise;
    a NaN feed named as the CPU port names it; run_steps naming its
    logical step. Returns the flash launches of the guarded run."""
    from paddle_tpu_torch import flags
    main, _, avg_cost = prog
    runs = {}
    launches = None
    for on in (False, True):
        scope = _scope_from(fluid, init, exe.device)
        flags.set_flag("check_nan_inf", on)
        try:
            exe.run(main, feed=batches[0], fetch_list=[avg_cost],
                    scope=scope)
            scope = _scope_from(fluid, init, exe.device)
            reads = exe.stats["guard_reads"]
            _flash_reset(F)
            losses, ms = _timed_steps(
                torch, exe, main, avg_cost, scope,
                [batches[i % len(batches)] for i in range(GUARD_STEPS)])
            if on:
                launches = _flash_read(F)
                reads = exe.stats["guard_reads"] - reads
        finally:
            flags.set_flag("check_nan_inf", None)
        runs[on] = (losses, ms, scope)
    same = all(np.array_equal(a, b) for a, b in zip(runs[0][0], runs[1][0]))
    names = [n for n in init]
    differ = _same_state(torch, runs[0][2], runs[1][2], names)
    check(same and not differ, "front (b): the guarded steps are not "
          "bitwise the unguarded ones (%s)", differ[:3])
    check(reads == GUARD_STEPS, "front (b): %d guard reads in %d guarded "
          "steps", reads, GUARD_STEPS)
    for key, n in launches.items():
        check(n == N_LAYER * GUARD_STEPS, "front (b): %s launches %d != %d",
              key, n, N_LAYER * GUARD_STEPS)
    log("front (b): %d LM steps guarded vs unguarded: losses and %d state "
        "tensors bitwise equal; step %.3f ms guarded, %.3f ms unguarded "
        "(%s); one guard read a run", GUARD_STEPS, len(names), runs[1][1],
        runs[0][1], smi)
    # one NaN in a feed: the card names what the CPU port names
    flags.set_flag("check_nan_inf", True)
    try:
        bad = _nan_batch(batches[0], rows=2)
        card = _nan_message(exe, main, avg_cost,
                            _scope_from(fluid, init, exe.device), feed=bad)
        cpu_exe = fluid.Executor(fluid.CPUPlace())
        cpu = _nan_message(cpu_exe, main, avg_cost,
                           _scope_from(fluid, init, "cpu"), feed=bad)
        check(card is not None and card == cpu, "front (b): a NaN feed "
              "tripped %r on the card, %r on the CPU", card, cpu)
        log("front (b): a NaN in mask[0, 1]: the card and the CPU both "
            "raise %r", card)
        steps = [batches[i % len(batches)] for i in range(GUARD_K)]
        steps[GUARD_BAD] = _nan_batch(steps[GUARD_BAD])
        _flash_reset(F)
        msg = _nan_message(exe, main, avg_cost,
                           _scope_from(fluid, init, exe.device),
                           steps=steps)
        graph = _flash_read(F)
    finally:
        flags.set_flag("check_nan_inf", None)
    want = "logical step %d of %d" % (GUARD_BAD, GUARD_K)
    check(msg is not None and want in msg and msg.startswith(card),
          "front (b): run_steps(K=%d) with the NaN in step %d raised %r",
          GUARD_K, GUARD_BAD, msg)
    log("front (b): run_steps(K=%d), the NaN in step %d: %r", GUARD_K,
        GUARD_BAD, msg)
    return {k: launches[k] + graph[k] for k in launches}


def _nce_program(fluid):
    from paddle_tpu_torch.dataset import imikolov
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = 11
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        words = [fluid.layers.data("w%d" % i, [1], dtype="int64")
                 for i in range(NCE["context"])]
        target = fluid.layers.data("target", [1], dtype="int64")
        embeds = [fluid.layers.embedding(
            w, size=[imikolov.VOCAB_SIZE, NCE["emb"]],
            param_attr=fluid.ParamAttr(name="shared_w")) for w in words]
        hidden = fluid.layers.fc(fluid.layers.concat(embeds, axis=1),
                                 NCE["hidden"], act="sigmoid")
        cost = fluid.layers.nce(hidden, target,
                                num_total_classes=imikolov.VOCAB_SIZE)
        avg_cost = fluid.layers.mean(cost)
        fluid.optimizer.SGD(learning_rate=0.5).minimize(avg_cost)
    return main, startup, avg_cost


def _ulps(a, b):
    """The largest distance in float32 units in the last place."""
    def ordered(x):
        i = np.ascontiguousarray(x, np.float32).view(np.int32).astype(
            np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int(np.max(np.abs(ordered(a) - ordered(b)), initial=0))


def front_draws_phase(torch, fluid, exe, prog, smi):
    """Phase 18 (c): an nce net at word2vec widths under run_steps(K) vs K
    run() calls; the LM's startup draws on the card and on the CPU."""
    from paddle_tpu_torch.core import philox, registry
    from paddle_tpu_torch.dataset import imikolov
    main, startup, avg_cost = _nce_program(fluid)
    init = _init_of(fluid, exe, startup)
    rng = np.random.RandomState(5)
    feeds = [{**{"w%d" % i: rng.randint(0, imikolov.VOCAB_SIZE, (
        NCE["batch"], 1)).astype(np.int64) for i in range(NCE["context"])},
        "target": rng.randint(0, imikolov.VOCAB_SIZE, (
            NCE["batch"], 1)).astype(np.int64)} for _ in range(NCE["k"])]
    # two fresh executors: both runs draw from run counters 0..K-1
    se = _scope_from(fluid, init, exe.device)
    eexe = fluid.Executor(fluid.CUDAPlace(0))
    eager = [eexe.run(main, feed=f, fetch_list=[avg_cost], scope=se)[0]
             for f in feeds]
    sg = _scope_from(fluid, init, exe.device)
    gexe = fluid.Executor(fluid.CUDAPlace(0))
    graph = [o[0] for o in gexe.run_steps(main, feeds=feeds,
                                          fetch_list=[avg_cost], scope=sg)]
    torch.cuda.synchronize()
    differ = _same_state(torch, se, sg, list(init))
    same = all(np.array_equal(a, b) for a, b in zip(eager, graph))
    check(gexe.stats["graph_captures"] == 1, "front (c): the nce "
          "dispatch was not captured into a graph")
    check(same and not differ, "front (c): nce run_steps(K=%d) is not "
          "bitwise %d run() calls (%s)", NCE["k"], NCE["k"], differ[:3])
    check(len(set(float(x) for x in eager)) == NCE["k"],
          "front (c): the nce losses repeat: %s", eager)
    log("front (c): nce (vocab %d, emb %d, hidden %d, batch %d) "
        "run_steps(K=%d) as one graph: losses %s and %d state tensors "
        "bitwise the %d run() calls'", imikolov.VOCAB_SIZE, NCE["emb"],
        NCE["hidden"], NCE["batch"], NCE["k"],
        " ".join("%.5f" % float(x) for x in graph), len(init), NCE["k"])
    # the LM's startup: Philox words and values, card against CPU
    _, lm_start, _ = prog
    seed = torch.tensor(lm_start.random_seed * 1000003, dtype=torch.int64)
    keys = registry.random_op_keys(lm_start.global_block())
    words = 0
    for op in lm_start.global_block().ops:
        if id(op) not in keys:
            continue
        n = int(np.prod(op.attr("shape")))
        n += n % 2
        a = philox.words(n, seed.cuda(), keys[id(op)], "cuda").cpu()
        b = philox.words(n, seed, keys[id(op)], "cpu")
        check(torch.equal(a, b), "front (c): the Philox words of %s differ "
              "on the card", op.type)
        words += n
    t0 = time.perf_counter()
    card = _init_of(fluid, fluid.Executor(fluid.CUDAPlace(0)), lm_start)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = _init_of(fluid, fluid.Executor(fluid.CPUPlace()), lm_start)
    cpu_s = time.perf_counter() - t0
    worst = max(_ulps(card[n], cpu[n]) for n in cpu)
    equal = sum(np.array_equal(card[n], cpu[n]) for n in cpu)
    check(sorted(card) == sorted(cpu) and worst <= 2, "front (c): the LM's "
          "startup values part by %d ulp between the card and the CPU",
          worst)
    log("front (c): the LM's startup: %d Philox words bitwise equal on the "
        "card and the CPU; %d of %d values bitwise equal, the rest within "
        "%d ulp; startup %.3f s on the card, %.3f s on the CPU (%s)", words,
        equal, len(cpu), worst, card_s, cpu_s, smi)


def front_transpile_phase(torch, fluid, R, exe, smi):
    """Phase 18 (d): ResNet-50 inference (batch 32) before and after
    InferenceTranspiler, from weights trained 3 steps with fuse_conv_bn
    on; returns those steps' matmul_stats launches."""
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.ops import matmul_stats as MS
    (main, startup, avg_cost), _ = _resnet_program(fluid, R)
    init = _init_of(fluid, exe, startup)
    batches = _resnet_batches()
    scope = _scope_from(fluid, init, exe.device)
    with _fuse(flags, True):
        MS.matmul_colstats.launches = 0
        losses = _eager_steps(torch, exe, main, avg_cost, scope,
                              [batches[i % 2] for i in range(3)])
        launches = MS.matmul_colstats.launches
    check(launches == 3 * RESNET_FUSED_PER_STEP, "front (d): %d "
          "matmul_stats launches in 3 fused steps", launches)
    trained = {n: scope.get_numpy(n) for n in scope.local_var_names()}
    block = main.global_block()
    xent = [op for op in block.ops if op.type == "cross_entropy"][0]
    prob = xent.input("X")[0]
    soft = [op for op in block.ops if op.type == "softmax"
            and op.output("Out")[0] == prob][0]
    logits = soft.input("X")[0]
    infer = main.clone(for_test=True).prune([logits])
    n_bn = sum(op.type == "batch_norm" for op in infer.global_block().ops)
    feed = {"data": batches[0]["data"]}
    outs, times = {}, {}
    for name in ("unfused", "fused"):
        sc = _scope_from(fluid, trained, exe.device)
        if name == "fused":
            fluid.InferenceTranspiler().transpile(infer, exe.place,
                                                  scope=sc)
        out, = exe.run(infer, feed=feed, fetch_list=[logits], scope=sc)
        _, times[name] = _timed_steps(torch, exe, infer, logits, sc,
                                      [feed] * 5)
        outs[name] = np.asarray(out)
    left = sum(op.type == "batch_norm" for op in infer.global_block().ops)
    check(n_bn > 0 and left == 0, "front (d): %d of %d batch_norm ops left "
          "after the transpiler", left, n_bn)
    rel = float(np.max(np.abs(outs["fused"] - outs["unfused"]))
                / np.max(np.abs(outs["unfused"])))
    check(np.isfinite(outs["fused"]).all() and rel <= TRANSPILE_RTOL,
          "front (d): the fused logits part by %.3g of the largest, over "
          "%g", rel, TRANSPILE_RTOL)
    log("front (d): ResNet-50 inference, batch %d, weights after 3 fused "
        "steps (losses %s, matmul_stats %d launches): %d batch_norm ops "
        "folded; logits within %.3g of the largest; %.3f ms fused, %.3f "
        "ms unfused (%s)", RESNET_BATCH, " ".join(
            "%.4f" % float(x) for x in losses), launches, n_bn, rel,
        times["fused"], times["unfused"], smi)
    return launches


def front_v2_phase(torch, fluid, smi):
    """Phase 18 (e): the recognize_digits convnet through paddle.v2 on the
    card."""
    import paddle_tpu_torch.v2 as paddle
    old = (fluid.switch_main_program(fluid.Program()),
           fluid.switch_startup_program(fluid.Program()))
    try:
        with fluid.unique_name.guard():
            paddle.init(use_gpu=True, trainer_count=1)
            images = paddle.layer.data(
                name="pixel", type=paddle.data_type.dense_vector(784))
            label = paddle.layer.data(
                name="label", type=paddle.data_type.integer_value(10))
            conv1 = paddle.networks.simple_img_conv_pool(
                input=images, filter_size=5, num_filters=20, num_channel=1,
                pool_size=2, pool_stride=2, act=paddle.activation.Relu())
            conv2 = paddle.networks.simple_img_conv_pool(
                input=conv1, filter_size=5, num_filters=50, num_channel=20,
                pool_size=2, pool_stride=2, act=paddle.activation.Relu())
            predict = paddle.layer.fc(input=conv2, size=10,
                                      act=paddle.activation.Softmax())
            cost = paddle.layer.classification_cost(input=predict,
                                                    label=label)
            parameters = paddle.parameters.create(cost)
            trainer = paddle.trainer.SGD(
                cost=cost, parameters=parameters,
                update_equation=paddle.optimizer.Momentum(
                    learning_rate=0.1 / 128.0, momentum=0.9,
                    regularization=paddle.optimizer.L2Regularization(
                        rate=5e-4)))
            check(trainer.__exe__.device.type == "cuda", "front (e): the "
                  "v2 trainer is not on the card")
            costs = []
            t0 = time.perf_counter()
            trainer.train(
                reader=paddle.batch(paddle.reader.shuffle(
                    paddle.dataset.mnist.train(n=1024), buf_size=1024),
                    batch_size=64), num_passes=V2_PASSES,
                event_handler=lambda e: costs.append(e.cost)
                if isinstance(e, paddle.event.EndPass) else None)
            wall = time.perf_counter() - t0
            check(costs[-1] < costs[0], "front (e): the v2 cost did not "
                  "fall: %s", costs)
            test = [(s[0],) for s in paddle.dataset.mnist.test(n=64)()]
            probs = paddle.infer(output_layer=predict,
                                 parameters=parameters, input=test)
            prog = predict.block.program.prune([predict])
            feeder = fluid.DataFeeder([images], fluid.CUDAPlace(0),
                                      program=prog)
            exe = fluid.Executor(fluid.CUDAPlace(0))
            want, = exe.run(prog, feed=feeder.feed(test),
                            fetch_list=[predict], scope=parameters._scope)
    finally:
        fluid.switch_main_program(old[0])
        fluid.switch_startup_program(old[1])
        paddle.init()
    check(probs.shape == (64, 10) and np.allclose(
        probs, want, rtol=1e-5, atol=1e-7), "front (e): paddle.infer "
        "parts from the executor's run by %.3g",
        float(np.max(np.abs(probs - want))))
    log("front (e): v2 recognize_digits convnet on the card: %d passes of "
        "16 batches of 64, pass costs %s, %.1f s; paddle.infer equals an "
        "executor run (%s)", V2_PASSES, " ".join("%.4f" % c for c in costs),
        wall, smi)


def frontend_phase(torch, smi):
    """Phase 18."""
    import tempfile
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import resnet as R
    from paddle_tpu_torch.models import transformer as T
    from paddle_tpu_torch.ops import flash_attention as F
    t0 = time.perf_counter()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    prog = _lm_program(fluid, T, True)
    init = _init_of(fluid, exe, prog[1])
    batches = [T.make_lm_batch(np.random.RandomState(seed), TRAIN_BATCH,
                               MAX_LEN, VOCAB) for seed in (0, 1, 2)]
    work = os.path.join(ROOT, "build", "paddle_tpu_torch")
    os.makedirs(work, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=work) as tmp:
        prof = front_profiler_phase(torch, smi, tmp)
        here = front_profiler_inprocess(torch, fluid, F, exe, prog, init,
                                        batches, tmp, smi)
    t1 = time.perf_counter()
    guard = front_guard_phase(torch, fluid, F, exe, prog, init, batches,
                              smi)
    t2 = time.perf_counter()
    front_draws_phase(torch, fluid, exe, prog, smi)
    t3 = time.perf_counter()
    mm = front_transpile_phase(torch, fluid, R, exe, smi)
    t4 = time.perf_counter()
    front_v2_phase(torch, fluid, smi)
    t5 = time.perf_counter()
    log("front: phase 18 took %.1f s ((a) %.1f, (b) %.1f, (c) %.1f, (d) "
        "%.1f, (e) %.1f)", t5 - t0, t1 - t0, t2 - t1, t3 - t2, t4 - t3,
        t5 - t4)
    return {"flash": {k: prof[k] + here[k] + guard[k] for k in prof},
            "mm_launches": mm}


# -- phase 19 ------------------------------------------------------------
PAR_CHILD = "--parallel-rank"       # phase 19 (b) and (c): one rank
PAR_STEPS, PAR_K = 3, 5
PAR_ATTN = (32, 8, MAX_LEN, 64)     # [B, H, T, D] of (b)'s attention
# (b)'s MoE: the LM's batch of tokens, d_model, 4 experts, d_inner
PAR_MOE = (TRAIN_BATCH * MAX_LEN, D_MODEL, 4, D_INNER)
# dryrun_multichip(4)'s combos: (name, axes, seed, loss limit, experts)
PAR_COMBOS = (("dp_tp", (("dp", 2), ("tp", 2)), 0, 2e-4, 0),
              ("dp_sp", (("dp", 2), ("sp", 2)), 1, 2e-3, 0),
              ("dp_pp", (("dp", 2), ("pp", 2)), 3, 2e-4, 0),
              ("dp_ep", (("dp", 2), ("ep", 2)), 4, 2e-3, 4))
# the collectives DTensor's own ops make over the dp x tp sub-mesh in
# each combo, as counted on the CPU at the dryrun's sizes (the shard_map
# regions and their gradients move layouts with the port's collectives,
# which stage through host memory)
PAR_NEEDS = {"dp_tp": ("all_reduce", "all_gather", "reduce_scatter"),
             "dp_sp": ("all_reduce",), "dp_pp": ("all_reduce",),
             "dp_ep": ("all_reduce",)}
# the combos (c) must run: all of them but dp x tp, whose DTensor
# all-gather gloo kills on this card (ROADMAP.md, queue 3)
PAR_REQUIRED = ("dp_sp", "dp_pp", "dp_ep")
# what counts as gloo refusing a probe's collective, on every rank that
# failed: an exception naming gloo or the device's missing backend (a
# peer of a rank that died gets one too: gloo's closed connection, or its
# PAR_PROBE_TIMEOUT_S timeout), or a segmentation fault after the probe
# issued the collective on CUDA tensors (PAR_ISSUED on its standard
# error; the same call on CPU tensors carried just before); any other
# exit, a kill at the probes' own time limit included, fails the phase
PAR_REFUSAL = (r"(?i)^(\[rank\d+\]:\s*)?[\w.]*(Error|Exception)\b"
               r".*(gloo|no backend type)")
PAR_ISSUED = "chip_smoke: probe issued on CUDA tensors: "
PAR_PROBE_TIMEOUT_S = 60      # gloo's, on each probe rank
# a probe's message: the LM's [32, 256, 512] fp32 activation, 16 MB
PAR_PROBE_FLOATS = TRAIN_BATCH * MAX_LEN * D_MODEL
# (b)'s staged bytes a rank a call (forward and backward) when each rank
# entered the whole Q, K and V and left with the output gathered whole,
# as the calls ran before ranks held their sequence blocks, by variant
PAR_STAGED_BEFORE = {"ring": 160 << 20, "ulysses": 224 << 20}


def _par_staged_count(variant, block, whole=False):
    """The bytes a rank stages in one (b) call on its sequence block of
    ``block`` bytes a tensor, from the code (``collective.py``: a gloo
    collective of CUDA tensors copies its send buffers to host memory and
    its receive buffers back, each counted once): the ring rotates K and
    V sp - 1 times forward and sends each step's dK and dV home as often
    backward (``ring._Ring``); Ulysses makes 8 all-to-alls of a block (Q,
    K, V and the output, and their gradients), each staging all its
    chunks out and back (``_raw_all_to_all``). On its block nothing is
    gathered: the output is the rank's block. On ``whole`` tensors each
    rank slices its block of Q, K and V on entry (no collective), and 4
    all-gathers stage a block out and the sp blocks of the whole back:
    the output's forward (``_ExitPlain``), dQ's, dK's and dV's backward
    (``_EnterPlain``)."""
    sp = 2
    gathers = 4 * (1 + sp) * block if whole else 0
    if variant == "ring":
        return 2 * (sp - 1) * 2 * block * 2 + gathers
    return 8 * block * 2 + gathers


def _held_bytes(scope, names):
    """(bytes this rank holds, bytes of the whole values) over the
    scope's values of ``names``: a held block's and a DTensor's local
    block against its global shape."""
    held = whole = 0
    for n in names:
        v = scope.find_var(n)
        if v is None or not hasattr(v, "element_size"):
            continue
        size = v.element_size()
        local = v.to_local() if hasattr(v, "placements") else v
        shape = getattr(v, "global_shape", tuple(v.shape))
        held += local.numel() * size
        whole += int(np.prod(shape, dtype=np.int64)) * size
    return held, whole


def _par_program(fluid, T, strategy, experts):
    """transformer_lm_parallel at the flagship's widths with SGD(0.1),
    the dryrun's optimizer."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        avg_cost, _ = T.transformer_lm_parallel(
            vocab_size=VOCAB, max_len=MAX_LEN, n_layer=N_LAYER,
            n_head=N_HEAD, d_model=D_MODEL, d_inner=D_INNER,
            strategy=strategy, num_experts=experts)
        fluid.optimizer.SGD(learning_rate=0.1).minimize(avg_cost)
    return main, startup, avg_cost


def _par_batches(seed, n):
    from paddle_tpu_torch.models import transformer as T
    return [T.make_lm_batch(np.random.RandomState(seed + 100 * i),
                            TRAIN_BATCH, MAX_LEN, VOCAB) for i in range(n)]


def _par_gap(fluid, a, b, names, rank):
    """On rank 0 the largest |a - b| / max(1, max|b|) over ``names``
    (None elsewhere); ``a``'s sharded values are gathered first, a
    collective every rank makes."""
    from paddle_tpu_torch.core.executor import as_numpy
    out = 0.0
    for n in names:
        x = as_numpy(a.find_var(n))
        if rank == 0:
            y = as_numpy(b.find_var(n))
            out = max(out, float(np.abs(x - y).max())
                      / max(1.0, float(np.abs(y).max())))
    return out if rank == 0 else None


def par_one_rank_phase(torch, smi):
    """Phase 19 (a): ParallelExecutor on a one-rank mesh at full width,
    the dense LM, the MoE fallback and the pp=2 scan fallback. Returns
    the flash launches (eager and through the K=5 replay)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import parallel
    from paddle_tpu_torch.models import transformer as T
    from paddle_tpu_torch.tools import op_sweep
    held, worst = op_sweep.run("cuda", part="parallel")
    check(len(held) == 9, "par (a): the op sweep held %d parallel op types, "
          "expected 9", len(held))
    log("par (a): the 9 op types of the parallel tier without a mesh (the "
        "collectives, moe_ffn, pipeline_stack) on the card against the "
        "CPU, largest forward difference %.3g", worst)
    mesh = parallel.make_mesh({"dp": 1})
    exe = fluid.Executor(fluid.CUDAPlace(0))
    total = {k: 0 for k in FLASH_KERNELS}
    for label, strategy, experts in (
            ("dense", parallel.DistributedStrategy(), 0),
            ("moe", parallel.DistributedStrategy(), 4),
            ("pp=2", parallel.DistributedStrategy(pp=2), 0)):
        prog = _par_program(fluid, T, strategy, experts)
        main, _, avg_cost = prog
        init = _init_of(fluid, exe, prog[1])
        batches = _par_batches(0, PAR_STEPS)
        sa = _scope_from(fluid, init, exe.device)
        le, _ = _counted_steps(torch, exe, prog, sa, batches)
        sb = _scope_from(fluid, init, exe.device)
        pexe = fluid.ParallelExecutor(loss_name=avg_cost.name,
                                      main_program=main, mesh=mesh,
                                      scope=sb, strategy=strategy)
        _reset_launches()
        lp = [float(pexe.run([avg_cost], feed=b)[0]) for b in batches]
        torch.cuda.synchronize()
        counts = _launches()
        differ = _same_state(torch, sa, sb, sorted(init))
        check(lp == le and not differ, "par (a) %s: ParallelExecutor is "
              "not bitwise equal to Executor: losses %s vs %s, %d state "
              "tensors differ (first %s)", label, lp, le, len(differ),
              differ[:1])
        for name in FLASH_KERNELS:
            check(counts[name] == N_LAYER * PAR_STEPS, "par (a) %s: %s "
                  "launched %d times in %d steps, expected %d", label,
                  name, counts[name], PAR_STEPS, N_LAYER * PAR_STEPS)
        five = _par_batches(10, PAR_K)
        sc = _scope_from(fluid, init, exe.device)
        graph = fluid.ParallelExecutor(loss_name=avg_cost.name,
                                       main_program=main, mesh=mesh,
                                       scope=sc, strategy=strategy)
        graph.run_steps([avg_cost], feeds=five)   # capture
        check(graph.stats["graph_captures"] == 1, "par (a) %s: no graph "
              "captured", label)
        fluid.load_numpy_state(sc, init, exe.device)
        graph._exe._rng_counter = 0
        eager = fluid.Executor(fluid.CUDAPlace(0))
        sd = _scope_from(fluid, init, eager.device)
        le5 = [float(eager.run(main, feed=b, fetch_list=[avg_cost],
                               scope=sd)[0]) for b in five]
        _reset_launches()
        lg5 = [float(o[0]) for o in graph.run_steps([avg_cost],
                                                     feeds=five)]
        torch.cuda.synchronize()
        counts5 = _launches()
        differ = _same_state(torch, sc, sd, sorted(init))
        check(graph.stats["graph_replays"] == 2 and lg5 == le5
              and not differ, "par (a) %s: run_steps(K=%d) (%d replays) "
              "is not bitwise equal to %d run() calls: losses %s vs %s, "
              "%d state tensors differ (first %s)", label, PAR_K,
              graph.stats["graph_replays"], PAR_K, lg5, le5, len(differ),
              differ[:1])
        for name in FLASH_KERNELS:
            check(counts5[name] == N_LAYER * PAR_K, "par (a) %s: %s "
                  "launched %d times through the K=%d replay, expected %d",
                  label, name, counts5[name], PAR_K, N_LAYER * PAR_K)
            total[name] += counts[name] + counts5[name]
        _, exe_ms = _timed_steps(torch, exe, main, avg_cost, sa, batches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in batches:
            pexe.run([avg_cost], feed=b)
        torch.cuda.synchronize()
        pexe_ms = 1e3 * (time.perf_counter() - t0) / len(batches)
        log("par (a) %s: ParallelExecutor on a one-rank mesh, %d SGD steps "
            "bitwise equal to Executor.run (losses %s), run_steps(K=%d) "
            "one CUDA graph bitwise equal to %d run() calls; flash "
            "launches %s a step, %s through the replay; step ms "
            "ParallelExecutor %.2f, Executor %.2f (batch %d x %d; %s)",
            label, PAR_STEPS, " ".join("%.6f" % x for x in lp), PAR_K,
            PAR_K, N_LAYER, {k: counts5[k] for k in FLASH_KERNELS},
            pexe_ms, exe_ms, TRAIN_BATCH, MAX_LEN, smi)
    return total


def _par_attn(torch, parallel, F, C, rank, variant, causal, whole=False):
    """Phase 19 (b): ring or Ulysses over sp=2, forward and backward, on
    this rank's sequence block of Q, K and V (DTensors over the sp mesh:
    the block enters as it is and the output leaves as the rank's block),
    or with ``whole`` on the whole Q, K and V as plain tensors (each rank
    slices its block on entry and gathers the output whole); held against
    flash_attention_lse over the whole sequence in this process (after
    the launch counters are read), and its staged bytes against the
    count from the code."""
    from torch.distributed.tensor import DTensor, Shard
    mesh = parallel.make_mesh({"sp": 2})
    b, h, t, d = PAR_ATTN
    g = torch.Generator().manual_seed(7)
    q, k, v, w = [torch.randn(b, h, t, d, generator=g).to("cuda")
                  for _ in range(4)]
    spec = (None, None, "sp", None)
    block = (lambda mesh, spec, x: x) if whole else parallel.blocks.block_of
    leaves = [block(mesh, spec, x).requires_grad_(True) for x in (q, k, v)]
    fn = parallel.ring_attention if variant == "ring" else \
        parallel.ulysses_attention
    staged = C.staged_bytes
    torch.cuda.synchronize()
    _flash_reset(F)
    t0 = time.perf_counter()
    if whole:
        out = fn(*leaves, mesh, causal=causal)
    else:
        ins = [DTensor.from_local(x, mesh.dtensor_mesh, [Shard(2)],
                                  run_check=False, shape=q.shape,
                                  stride=q.stride()) for x in leaves]
        out = fn(*ins, mesh, causal=causal).to_local()
    (out * block(mesh, spec, w)).sum().backward()
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    staged = C.staged_bytes - staged
    counts = _flash_read(F)
    if variant == "ulysses":
        want = 1
    else:
        want = 1 + rank if causal else 2
    what = "par (b) %s %s%s rank %d" % (variant, "causal" if causal
                                        else "full",
                                        " whole" if whole else "", rank)
    for name in FLASH_KERNELS:
        check(counts[name] == want, "%s: %s launched %d times, expected "
              "%d", what, name, counts[name], want)
    count = _par_staged_count(variant, q.numel() * 4 // 2, whole)
    check(staged <= count, "%s: staged %d bytes, more than the %d the "
          "code moves", what, staged, count)
    check(tuple(out.shape) == (b, h, t // (1 if whole else 2), d), "%s: "
          "the output is %s", what, tuple(out.shape))
    qr, kr, vr = [x.detach().clone().requires_grad_(True)
                  for x in (q, k, v)]
    ro, _ = F.flash_attention_lse(qr, kr, vr, causal=causal)
    (ro * w).sum().backward()
    ro = block(mesh, spec, ro.detach())
    err = float((out - ro).abs().max())
    check(torch.allclose(out, ro, rtol=RTOL, atol=ATOL), "%s: the output "
          "is %.3g from flash_attention_lse over the whole sequence",
          what, err)
    for name, got, ref in (("dq", leaves[0].grad, qr.grad),
                           ("dk", leaves[1].grad, kr.grad),
                           ("dv", leaves[2].grad, vr.grad)):
        ref = block(mesh, spec, ref)
        scale = float(ref.abs().max())
        gerr = float((got - ref).abs().max())
        check(gerr <= ATOL * scale + RTOL * scale, "%s: %s is %.3g from "
              "the whole sequence's (largest %.3g)", what, name, gerr,
              scale)
        err = max(err, gerr / max(scale, 1e-30))
    return {"what": what, "launches": counts, "ms": ms, "err": err,
            "staged": staged, "count": count, "whole": whole,
            "before": PAR_STAGED_BEFORE[variant]}


def _par_flash_want(axes, rank):
    """Each flash kernel's launches on ``rank`` in PAR_STEPS steps of the
    LM over ``axes``, from the code: the ring's causal shards (1 + its sp
    coordinate a layer: later shards are skipped), a gpipe stage's layers
    for each of its 2 * pp microbatches, or one a layer."""
    names = [a for a, _ in axes]
    sizes = dict(axes)
    coords = np.unravel_index(rank, [sizes[a] for a in names])
    at = dict(zip(names, coords))
    if sizes.get("pp", 1) > 1:
        per = N_LAYER // sizes["pp"] * 2 * sizes["pp"]
    elif sizes.get("sp", 1) > 1:
        per = N_LAYER * (1 + int(at["sp"]))
    else:
        per = N_LAYER
    return per * PAR_STEPS


def _par_lm(torch, fluid, parallel, T, axes, seed, tol, experts, rank,
            what, steps=False):
    """One of the LM runs of (b) and (c): transformer_lm_parallel at full
    width over ``axes`` through ParallelExecutor, PAR_STEPS SGD steps,
    against the same program's one-rank run on rank 0 (the fallbacks: the
    flash attention over the whole sequence, the loop over layers, the
    MoE's dense routing). With ``steps``, the same steps again as one
    ``run_steps`` call from the same state: over several ranks it runs
    them as PAR_STEPS ``run`` calls, no graph captured, bitwise equal."""
    from paddle_tpu_torch.ops import flash_attention as F
    from paddle_tpu_torch.parallel import collective as C
    strategy = parallel.DistributedStrategy(
        dp=axes.get("dp", 1), tp=axes.get("tp", 1), sp=axes.get("sp", 1),
        pp=axes.get("pp", 1), ep=axes.get("ep", 1))
    prog = _par_program(fluid, T, strategy, experts)
    main, _, avg_cost = prog
    exe = fluid.Executor(fluid.CUDAPlace(0))
    init = _init_of(fluid, exe, prog[1])
    batches = _par_batches(seed, PAR_STEPS)
    sa = _scope_from(fluid, init, exe.device)
    le = [float(exe.run(main, feed=b, fetch_list=[avg_cost],
                        scope=sa)[0]) for b in batches] \
        if rank == 0 else None
    mesh = parallel.make_mesh(axes)
    sb = _scope_from(fluid, init, exe.device)
    pexe = fluid.ParallelExecutor(loss_name=avg_cost.name,
                                  main_program=main, mesh=mesh, scope=sb,
                                  strategy=strategy)
    staged = C.staged_bytes
    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lp = [float(pexe.run([avg_cost], feed=b)[0]) for b in batches]
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / PAR_STEPS
    counts = _flash_read(F)
    staged = C.staged_bytes - staged
    want = _par_flash_want(list(axes.items()), rank)
    for name in FLASH_KERNELS:
        check(counts[name] == want, "%s rank %d: %s launched %d times in "
              "%d steps, expected %d", what, rank, name, counts[name],
              PAR_STEPS, want)
    # what this rank holds of the state: every persistable, and the held
    # blocks (stage and expert weights, their accumulators) alone
    pers = sorted(init)
    held, whole = _held_bytes(sb, pers)
    blocks = [n for n in pers if hasattr(sb.find_var(n), "global_shape")]
    hb, hw = _held_bytes(sb, blocks)
    if "pp" in axes or "ep" in axes:
        check(blocks and 2 * hb == hw, "%s rank %d: holds %d of the %d "
              "bytes of its %d stage and expert blocks, not half", what,
              rank, hb, hw, len(blocks))
    if steps:
        sc = _scope_from(fluid, init, exe.device)
        again = fluid.ParallelExecutor(loss_name=avg_cost.name,
                                       main_program=main, mesh=mesh,
                                       scope=sc, strategy=strategy)
        _reset_launches()
        ls = [float(o[0]) for o in again.run_steps([avg_cost],
                                                   feeds=batches)]
        torch.cuda.synchronize()
        counts = {k: v + _flash_read(F)[k] for k, v in counts.items()}
        differ = _same_state(torch, sb, sc, sorted(init))
        st = again.stats
        check(ls == lp and not differ and st["graph_captures"] == 0
              and st["megastep_dispatches"] == 0, "%s: run_steps(K=%d) "
              "is not %d bitwise run() calls: losses %s vs %s, %d state "
              "tensors differ, %d captures, %d megasteps", what, PAR_STEPS,
              PAR_STEPS, ls, lp, len(differ), st["graph_captures"],
              st["megastep_dispatches"])
    gap = _par_gap(fluid, sb, sa, sorted(init), rank)
    if rank == 0:
        for i, (a, b) in enumerate(zip(lp, le)):
            check(np.isfinite(a) and abs(a - b) <= tol * max(1.0, abs(b)),
                  "%s: step %d loss %r, one rank %r (limit %g)", what, i,
                  a, b, tol)
        check(gap <= 50 * tol, "%s: final weights %.3g from the one-rank "
              "run (limit %g)", what, gap, 50 * tol)
    return {"what": what, "losses": lp, "one_rank": le, "gap": gap,
            "ms": ms, "staged": staged, "launches": counts,
            "run_steps": steps, "held": held, "whole": whole,
            "held_blocks": hb, "whole_blocks": hw, "blocks": len(blocks)}


def _par_moe(torch, parallel, C, top_k, rank, whole=False):
    """Phase 19 (b): moe_ffn over ep=2 on this rank's ep block of the
    expert stacks (or with ``whole`` on the whole stacks, sliced on
    entry) against the same call without a mesh, on this rank: the
    routing (overflow, aux) identical, the output at rtol 1e-4 / atol
    1e-5."""
    from paddle_tpu_torch.parallel import moe
    tokens, d, e, hidden = PAR_MOE
    g = torch.Generator().manual_seed(11)
    x = torch.randn(tokens, d, generator=g).to("cuda")
    gate = (torch.randn(d, e, generator=g) * 0.05).to("cuda")
    up = (torch.randn(e, d, hidden, generator=g) * d ** -0.5).to("cuda")
    down = (torch.randn(e, hidden, d, generator=g)
            * hidden ** -0.5).to("cuda")
    mesh = parallel.make_mesh({"ep": 2})
    # this rank's ep block of the expert stacks, held as such
    up_b, down_b = [w if whole else parallel.blocks.block_of(
        mesh, ("ep",), w) for w in (up, down)]
    held = (up_b.numel() + down_b.numel()) * 4
    all_bytes = (up.numel() + down.numel()) * 4
    staged = C.staged_bytes
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, aux, st = moe.moe_ffn(x, gate, up_b, down_b, mesh=mesh,
                               top_k=top_k, return_stats=True)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    ref, raux, rst = moe.moe_ffn(x, gate, up, down, top_k=top_k,
                                 return_stats=True)
    what = "par (b) moe top-%d%s rank %d" % (top_k, " whole" if whole
                                             else "", rank)
    check(float(st["overflow"]) == float(rst["overflow"])
          and float(aux) == float(raux), "%s: routing differs: overflow "
          "%r vs %r, aux %r vs %r", what, float(st["overflow"]),
          float(rst["overflow"]), float(aux), float(raux))
    err = float((out - ref).abs().max())
    check(torch.allclose(out, ref, rtol=RTOL, atol=ATOL), "%s: output "
          "%.3g from the one-rank call", what, err)
    check(held == (all_bytes if whole else all_bytes // 2), "%s: holds %d "
          "of the experts' %d bytes", what, held, all_bytes)
    return {"what": what, "overflow": float(st["overflow"]), "err": err,
            "ms": ms, "staged": C.staged_bytes - staged, "held": held,
            "whole": all_bytes}


def _par_probe(torch, dist, name):
    """One of the functional collectives DTensor's own ops call, on CUDA
    tensors of PAR_PROBE_FLOATS over this gloo group: whether gloo
    carries it here is this process's exit (a refusal raises, or, as
    gloo's functional all-gather of CUDA tensors does on the H100's
    PyTorch 2.11, kills the process; ``_par_refusal``). The same call on
    a small CPU tensor goes first: it shows the group works and leaves no
    lazy import for after the CUDA call is issued, so a crash past
    PAR_ISSUED is the CUDA call's."""
    import torch.distributed._functional_collectives as funcol
    group = dist.group.WORLD

    def call(x):
        if name == "all_reduce":
            out = funcol.all_reduce(x, "sum", group)
        elif name == "all_gather":
            out = funcol.all_gather_tensor(x, 0, group)
        else:
            out = funcol.reduce_scatter_tensor(x, "sum", 0, group)
        return float(out.sum())

    cpu = call(torch.ones(2 * dist.get_world_size()))
    x = torch.ones(PAR_PROBE_FLOATS, device="cuda")
    torch.cuda.synchronize()
    print(PAR_ISSUED + name, file=sys.stderr, flush=True)
    total = call(x)
    torch.cuda.synchronize()
    return {"carried": name, "sum": total, "cpu_sum": cpu}


def _par_refusal(rc, err):
    """A probe rank's exit (``rc``, its standard error) as gloo's
    documented refusal of the collective, or None when it is some other
    fault: a segmentation fault once the CUDA call was issued (whichever
    thread faulthandler finds where: the fault is in gloo's worker
    thread, and the main thread may be anywhere past the call), or an
    exception naming gloo or the missing device backend."""
    if rc == -11 and "Fatal Python error: Segmentation fault" in err \
            and PAR_ISSUED in err:
        return "exit -11: segmentation fault once the CUDA call was issued"
    if rc == 1:
        for ln in err.strip().splitlines():
            if re.search(PAR_REFUSAL, ln.strip()):
                return "exit 1: " + ln.strip()[:200]
    return None


def _par_child(argv):
    """Phase 19 (b) or (c) as one rank: ``chip_smoke.py --parallel-rank
    PART WORLD RANK STORE``; prints one JSON line of what it measured."""
    import faulthandler
    import torch
    import torch.distributed as dist
    faulthandler.enable()       # a crash in a collective names its line
    part, world, rank, store = argv[0], int(argv[1]), int(argv[2]), argv[3]
    # argv[4], for (c): the collectives gloo carries here, comma-separated
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import parallel
    from paddle_tpu_torch.distributed import launch
    from paddle_tpu_torch.models import transformer as T
    from paddle_tpu_torch.ops import flash_attention as F
    from paddle_tpu_torch.parallel import collective as C
    probe = part.startswith("probe:")
    launch.init_parallel_env("file://" + store, world, rank, device="cuda",
                             backend="gloo",
                             timeout=PAR_PROBE_TIMEOUT_S if probe else 300)
    res = {"rank": rank}
    try:
        if part == "b":
            # gloo connects a pair at its first message: one small ring
            # call first, so the timed calls below do not pay for it
            x = torch.zeros(2, 1, 4, 8, device="cuda")
            parallel.ring_attention(x, x, x, parallel.make_mesh({"sp": 2}))
            res["attn"] = [_par_attn(torch, parallel, F, C, rank, v, c)
                           for v in ("ring", "ulysses")
                           for c in (False, True)]
            # the whole-tensor entry the port keeps (each rank slices on
            # entry and gathers the output), causal
            res["attn"] += [_par_attn(torch, parallel, F, C, rank, v, True,
                                      whole=True)
                            for v in ("ring", "ulysses")]
            res["lm"] = [_par_lm(torch, fluid, parallel, T, {"pp": 2}, 3,
                                 2e-4, 0, rank, "par (b) gpipe pp=2",
                                 steps=True)]
            res["moe"] = [_par_moe(torch, parallel, C, k, rank)
                          for k in (1, 2)]
            res["moe"].append(_par_moe(torch, parallel, C, 1, rank,
                                       whole=True))
        elif probe:
            res["probe"] = _par_probe(torch, dist, part[len("probe:"):])
        else:
            carried = set(argv[4].split(","))
            res["lm"] = [
                _par_lm(torch, fluid, parallel, T, dict(axes), seed, tol,
                        experts, rank, "par (c) %s" % name)
                for name, axes, seed, tol, experts in PAR_COMBOS
                if set(PAR_NEEDS[name]) <= carried]
        res["staged"] = C.staged_bytes
    except SmokeFailure as e:
        print("chip_smoke: rank %d FAILED: %s" % (rank, e), file=sys.stderr)
        return 1
    finally:
        launch.shutdown()
    print(json.dumps(res))
    return 0


def _par_run(parts, world, tmp, extra=(), timeout=600):
    """Run each phase 19 part of ``parts`` as ``world`` rank processes
    on the one card (gloo through host memory), all at once, within
    ``timeout`` seconds: {part: each rank's (exit code, standard output,
    standard error)}."""
    env = dict(os.environ, OMP_NUM_THREADS="2")
    runs = []
    for part in parts:
        store = os.path.join(tmp, "store_" + part.replace(":", "_"))
        for r in range(world):
            out = open(os.path.join(tmp, "%s_%d.out" % (part, r)), "w+")
            err = open(os.path.join(tmp, "%s_%d.err" % (part, r)), "w+")
            runs.append((part, out, err, subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), PAR_CHILD,
                 part, str(world), str(r), store] + list(extra),
                stdout=out, stderr=err, cwd=ROOT, env=env)))
    deadline = time.monotonic() + timeout
    try:
        for _, _, _, p in runs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for _, _, _, p in runs:
            if p.poll() is None:
                p.kill()
                p.wait()
    texts = {part: [] for part in parts}
    for part, out, err, p in runs:
        out.seek(0)
        err.seek(0)
        texts[part].append((p.returncode, out.read(), err.read()))
        out.close()
        err.close()
    return texts


def _par_spawn(part, world, tmp, extra=()):
    """``_par_run`` whose every rank must exit 0. Returns each rank's
    JSON."""
    texts = _par_run([part], world, tmp, extra)[part]
    bad = [(r, rc, "\n".join([ln for ln in e.strip().splitlines()
                               if "]:W" not in ln and "Extension modules"
                               not in ln][-30:]))
           for r, (rc, _, e) in enumerate(texts) if rc != 0]
    check(not bad, "par (%s): %d ranks on the card: %s", part, world,
          "; ".join("rank %d exited %s: %s" % b for b in bad))
    return [json.loads(o.strip().splitlines()[-1]) for _, o, _ in texts]


def _par_log(res):
    for r in res:
        for item in r.get("attn", []):
            log("%s: %.1f ms forward and backward on %s, max rel err "
                "%.3g, staged %d bytes (%.1f MiB; the code's count %.1f "
                "MiB; before ranks held blocks, whole tensors in and "
                "out: %.0f MiB), flash launches %s", item["what"],
                item["ms"],
                "the whole tensors" if item["whole"]
                else "its sequence block", item["err"], item["staged"],
                item["staged"] / 2 ** 20, item["count"] / 2 ** 20,
                item["before"] / 2 ** 20, item["launches"])
        for item in r.get("moe", []):
            log("%s: %.1f ms, max rel err %.3g, staged %d bytes; holds "
                "%d of the experts' %d bytes (%.1f of %.1f MB)",
                item["what"], item["ms"], item["err"], item["staged"],
                item["held"], item["whole"], item["held"] / 1e6,
                item["whole"] / 1e6)
        for item in r.get("lm", []):
            log("%s rank %d: losses %s%s, step ms %.1f, staged %d bytes a "
                "run of %d steps; holds %d of its state's %d bytes (%.1f "
                "of %.1f MB), %d stage and expert blocks %d of %d bytes "
                "(%.1f of %.1f MB); flash launches %s%s", item["what"],
                r["rank"], " ".join("%.6f" % x for x in item["losses"]),
                " (one rank %s, final weights %.3g from it)"
                % (" ".join("%.6f" % x for x in item["one_rank"]),
                   item["gap"]) if item["one_rank"] else "", item["ms"],
                item["staged"], PAR_STEPS, item["held"], item["whole"],
                item["held"] / 1e6, item["whole"] / 1e6, item["blocks"],
                item["held_blocks"], item["whole_blocks"],
                item["held_blocks"] / 1e6, item["whole_blocks"] / 1e6,
                item["launches"],
                "; run_steps(K=%d): %d run() calls, no graph, bitwise "
                "equal" % (PAR_STEPS, PAR_STEPS) if item["run_steps"]
                else "")


def parallel_phase(torch, smi):
    """Phase 19."""
    import tempfile
    t0 = time.perf_counter()
    flash = par_one_rank_phase(torch, smi)
    t1 = time.perf_counter()
    work = os.path.join(ROOT, "build", "paddle_tpu_torch")
    os.makedirs(work, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=work) as tmp:
        two = _par_spawn("b", 2, tmp)
        t2 = time.perf_counter()
        # which of DTensor's collectives gloo carries for CUDA tensors
        # here, one 2-rank process pair a collective (a crash is an
        # answer, not a failure of the phase)
        names = ("all_reduce", "all_gather", "reduce_scatter")
        probes = _par_run(["probe:" + n for n in names], 2, tmp,
                          timeout=180)
        refused = {}
        for name in names:
            whys = []
            for r, (rc, _, err) in enumerate(probes["probe:" + name]):
                if rc == 0:
                    continue
                why = _par_refusal(rc, err)
                lines = [ln for ln in err.strip().splitlines()
                         if ln.strip() and "]:W" not in ln]
                check(why is not None, "par (c): the %s probe's rank %d "
                      "exited %s, which is no refusal of gloo's: %s", name,
                      r, rc, " | ".join(lines[-12:]))
                whys.append("rank %d %s" % (r, why))
            if whys:
                refused[name] = "; ".join(whys)
        carried = [n for n in names if n not in refused]
        t3 = time.perf_counter()
        four = _par_spawn("c", 4, tmp, extra=[",".join(carried)])
    t4 = time.perf_counter()
    _par_log(two)
    ran = [item["what"] for item in four[0]["lm"]]
    log("par (c): gloo on this card carries %s for %d MB CUDA tensors%s; "
        "combos run: %s; not run: %s", carried or "none",
        PAR_PROBE_FLOATS * 4 >> 20, "; not %s" % refused if refused
        else "", ran or "none",
        [n for n, *_ in PAR_COMBOS if "par (c) %s" % n not in ran]
        or "none")
    _par_log(four)
    missing = [n for n in PAR_REQUIRED if "par (c) %s" % n not in ran]
    check(not missing, "par (c): combos %s did not run (gloo refused %s)",
          missing, refused or "nothing")
    for res in (two, four):
        for r in res:
            for item in r.get("attn", []) + r.get("lm", []):
                for name in FLASH_KERNELS:
                    flash[name] += item["launches"][name]
    log("par: phase 19 took %.1f s ((a) %.1f, (b) %.1f, probes %.1f, (c) "
        "%.1f); staged bytes by rank (b) %s (c) %s; flash launches %s "
        "(%s)", t4 - t0, t1 - t0, t2 - t1, t3 - t2, t4 - t3,
        [r["staged"] for r in two], [r["staged"] for r in four], flash,
        smi)
    return flash


# -- phase 20 ------------------------------------------------------------
PS_CHILD = "--ps-child"          # phase 20: one pserver, trainer or master
PS_STEPS = 5                     # (a): Adam steps through the pservers
PS_TOL = 2e-4                    # of max(1, max|w|) per tensor, each step
DFM_PS_STEPS = 3                 # (b): steps of each DeepFM run
DFM_PS_SGD_LR = 0.1
CHAOS_TASKS = 11                 # (c): master tasks = batches of a run
CHAOS_LR = 0.1                   # the chaos pserver's SGD
CHAOS_KILL_ROUND = 3             # SIGKILL once its checkpoint is this far
CHAOS_CKPT_S = 0.25              # the pserver cell's checkpoint interval
CHAOS_SPEC = {
    "rpc": {"drop": 0.06, "duplicate": 0.05, "close_mid_frame": 0.03,
            "delay": 0.08, "delay_s": 0.003, "max": 10},
    "ckpt": {"nth": 2, "mode": "bitflip"},
    "nan": {"step": 9, "name": "mask"},
}
CHAOS_SEED = 1301
CHAOS_TTL = 2.0                  # the pservers' membership lease
PS_CHILD_TIMEOUT = 600           # seconds, each spawn group


def _ps_wait_file(path, timeout=300.0, proc=None):
    """The text of a file another process writes once (a port file),
    polled within ``timeout``; a watched process that exits first fails
    the phase."""
    deadline = time.monotonic() + timeout
    while True:
        try:
            with open(path) as f:
                text = f.read().strip()
            if text:
                return text
        except OSError:
            pass
        check(proc is None or proc.poll() is None,
              "ps: the process writing %s exited %s first", path,
              proc.returncode if proc is not None else None)
        check(time.monotonic() < deadline, "ps: no %s after %.0f s", path,
              timeout)
        time.sleep(0.02)


def _ps_write(path, obj):
    """Write JSON where a poller reads it whole (a rename)."""
    with open(path + ".tmp", "w") as f:
        json.dump(obj, f)
    os.replace(path + ".tmp", path)


def _ps_gap(a, b):
    """|a - b| over max(1, max|b|), the multi-step bound's scale."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(1.0, float(np.abs(b).max()))) \
        if b.size else 0.0


def _ps_lm_program(fluid, T, optimizer="adam"):
    return _lm_program(fluid, T, True, optimizer=optimizer)


def _ps_dfm_program(fluid, D, opt, dist, lr_scale=1):
    """DeepFM at phase 14's widths, both FM tables ``is_distributed``
    when ``dist``: Adam (DFM's rate) or SGD (at ``lr_scale`` times its
    rate)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        fields = [fluid.layers.data("field_%d" % i, [1], dtype="int64")
                  for i in range(DFM["num_fields"])]
        label = fluid.layers.data("click", [1])
        _, logit = D.deepfm(fields, DFM["vocab_size"], DFM["embed_dim"],
                            is_sparse=True, is_distributed=dist)
        loss = fluid.layers.mean(
            fluid.layers.sigmoid_cross_entropy_with_logits(logit, label))
        if opt == "sgd":
            fluid.optimizer.SGD(
                learning_rate=DFM_PS_SGD_LR * lr_scale).minimize(loss)
        else:
            fluid.optimizer.Adam(
                learning_rate=DFM["learning_rate"]).minimize(loss)
    return main, startup, loss


def _ps_job_program(fluid, job):
    from paddle_tpu_torch.models import deepfm as D
    from paddle_tpu_torch.models import transformer as T
    if job["kind"] == "lm":
        return _ps_lm_program(fluid, T)
    return _ps_dfm_program(fluid, D, job["opt"], True)


def _ps_transpile(fluid, prog, eps, trainers, tid=0):
    t = fluid.DistributeTranspiler(mode="pserver")
    t.transpile(trainer_id=tid, program=prog[0], pservers=",".join(eps),
                trainers=trainers, startup_program=prog[1])
    return t


def _ps_arm(tmp, proc):
    """The monitor and the tracer of this process, each writing its own
    log under ``tmp``."""
    from paddle_tpu_torch import monitor, trace
    monitor.enable(log_path=os.path.join(tmp, "mon_%s.jsonl" % proc))
    trace.enable(log_path=os.path.join(tmp, "trace_%s.jsonl" % proc),
                 proc=proc, clock_interval=0)


def _ps_disarm():
    from paddle_tpu_torch import monitor, trace
    trace.disable()
    monitor.disable()


def _ps_load(fluid, scope, init, device, shard=None):
    """``init`` ({name: array}) into ``scope`` for the names it holds; a
    table held as a row shard gets rows i::n (``shard`` = (i, n)),
    zero-padded to the shard's rows."""
    vals = {}
    for name in list(scope.local_var_names()):
        if name not in init or scope.find_var(name) is None:
            continue
        arr = init[name]
        have = tuple(scope.find_var(name).shape)
        if have != arr.shape:
            i, n = shard
            part = arr[i::n]
            arr = np.concatenate([part, np.zeros(
                (have[0] - part.shape[0],) + arr.shape[1:], arr.dtype)])
        vals[name] = arr
    fluid.load_numpy_state(scope, vals, device)


def _ps_pserver_child(args):
    """Phase 20 (a)/(b): one pserver process serving its jobs in turn on
    the same endpoint: each job's pserver program through
    ``Executor(CUDAPlace(0)).run`` (its optimize blocks on the card),
    until a trainer sends EXIT."""
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.monitor import runtime as mrt
    from paddle_tpu_torch.distributed import rpc
    from paddle_tpu_torch.ops import flash_attention as F
    i, eps, tmp = args["index"], args["eps"], args["tmp"]
    ep = eps[i]
    out = []
    for job in args["jobs"]:
        print("pserver %d: job %s" % (i, job["name"]), file=sys.stderr,
              flush=True)
        prog = _ps_job_program(fluid, job)
        t = _ps_transpile(fluid, prog, eps, job["trainers"])
        pprog = t.get_pserver_program(ep, port_file=job["port_files"][i])
        exe = fluid.Executor(fluid.CUDAPlace(0))
        check(exe.device.type == "cuda", "ps: the pserver is not on the "
              "card")
        scope = fluid.Scope()
        exe.run(t.get_startup_program(ep, pprog), scope=scope)
        init = dict(np.load(job["init"]))
        _ps_load(fluid, scope, init, exe.device, (i, len(eps)))
        if job.get("armed"):
            _ps_arm(tmp, "pserver%d" % i)
        _flash_reset(F)
        rounds0 = rpc._PS_ROUNDS.value()
        steps0 = sum(mrt.STEPS.snapshot().values())
        exe.run(pprog, scope=scope)          # serves until EXIT
        torch.cuda.synchronize()
        if job.get("armed"):
            _ps_disarm()
        out.append({"job": job["name"],
                    "rounds": rpc._PS_ROUNDS.value() - rounds0,
                    "monitor_steps": sum(mrt.STEPS.snapshot().values())
                    - steps0, "flash": _flash_read(F)})
    return {"index": i, "jobs": out}


def _ps_exit(eps):
    from paddle_tpu_torch.distributed import ops as dist_ops
    from paddle_tpu_torch.distributed import rpc
    for ep in eps:
        cli = rpc.RPCClient(ep, timeout=60.0)
        cli.shutdown_server()
        cli.close()
    dist_ops.reset_clients()


def _ps_params(main, scope):
    return {p.name: scope.get_numpy(p.name)
            for p in main.global_block().all_parameters()
            if scope.find_var(p.name) is not None}


def _ps_lm_trainer(torch, fluid, args, job):
    """Phase 20 (a) in the trainer: the local run first (5 Adam steps of
    ``Executor.run`` on the card from the same start), then the same 5
    steps through the transpiled program against the two pservers, the
    weights held against the local run's after every step."""
    from paddle_tpu_torch.models import transformer as T
    from paddle_tpu_torch.ops import flash_attention as F
    from paddle_tpu_torch import monitor
    init = dict(np.load(job["init"]))
    batches = [T.make_lm_batch(np.random.RandomState(s), TRAIN_BATCH,
                               MAX_LEN, VOCAB) for s in range(PS_STEPS)]
    exe = fluid.Executor(fluid.CUDAPlace(0))
    local = _ps_lm_program(fluid, T)
    scope = fluid.Scope()
    exe.run(local[1], scope=scope)
    fluid.load_numpy_state(scope, init, exe.device)
    _flash_reset(F)
    want, local_ms, local_losses = [], [], []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, = exe.run(local[0], feed=b, fetch_list=[local[2]],
                        scope=scope)
        torch.cuda.synchronize()
        local_ms.append(1e3 * (time.perf_counter() - t0))
        local_losses.append(float(loss))
        want.append(_ps_params(local[0], scope))
    local_flash = _flash_read(F)
    prog = _ps_lm_program(fluid, T)
    _ps_transpile(fluid, prog, args["eps"], 1)
    ops = [op.type for op in prog[0].global_block().ops]
    check("adam" not in ops and ops.count("send") == 1
          and ops.count("recv") == 1, "ps (a): the trainer program is not "
          "transpiled: %s", ops[-4:])
    scope = fluid.Scope()
    exe.run(prog[1], scope=scope)
    fluid.load_numpy_state(scope, {n: v for n, v in init.items()
                                   if scope.find_var(n) is not None},
                           exe.device)
    for pf in job["port_files"]:
        _ps_wait_file(pf)
    _ps_arm(args["tmp"], "trainer")
    _flash_reset(F)
    ms, losses, gaps = [], [], []
    try:
        for i, b in enumerate(batches):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, = exe.run(prog[0], feed=b, fetch_list=[prog[2]],
                            scope=scope)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
            losses.append(float(loss))
            got = _ps_params(prog[0], scope)
            check(sorted(got) == sorted(want[i]), "ps (a): the trainer "
                  "holds other parameters than the local run")
            gap = max(_ps_gap(got[n], want[i][n]) for n in got)
            gaps.append(gap)
            check(gap <= PS_TOL, "ps (a): step %d weights %.3g from the "
                  "local run (limit %g)", i + 1, gap, PS_TOL)
    finally:
        _ps_disarm()
    flash = _flash_read(F)
    rows = monitor.read_jsonl(os.path.join(args["tmp"],
                                           "mon_trainer.jsonl"))
    # the values a step moves: the gradients the send op takes (each of
    # its parameter's size), the weights recv brings back (frame
    # headers aside)
    ops = {op.type: op for op in prog[0].global_block().ops}
    sent_bytes = sum(got[n[:-len("@GRAD")]].nbytes
                     for n in ops["send"].input("X"))
    recv_bytes = sum(got[n].nbytes for n in ops["recv"].output("Out"))
    _ps_exit(args["eps"])
    return {"job": job["name"], "ms": ms, "local_ms": local_ms,
            "losses": losses, "local_losses": local_losses, "gaps": gaps,
            "flash": flash, "local_flash": local_flash,
            "recorder_steps": sum(1 for r in rows if r["ev"] == "step"),
            "sent_value_bytes": sent_bytes, "recv_value_bytes": recv_bytes,
            "device": str(exe.device)}


def _ps_tables(eps, names, vocab):
    """The global tables from their mod-sharded pserver row stores."""
    from paddle_tpu_torch.distributed import rpc
    shards = {n: [] for n in names}
    for ep in eps:
        with rpc.RPCClient(ep) as cli:
            for n in names:
                shards[n].append(np.asarray(cli.get_var(n)))
    out = {}
    for n, parts in shards.items():
        table = np.zeros((vocab,) + parts[0].shape[1:], parts[0].dtype)
        for i, part in enumerate(parts):
            rows = np.arange(part.shape[0]) * len(parts) + i
            keep = rows < vocab
            table[rows[keep]] = part[keep]
        out[n] = table
    return out


def _ps_dfm_feeds(job, tid=None):
    """SGD: a new batch a step; Adam: one batch again and again (then
    the rows a step touches are the rows every step touches, and lazy
    Adam on the shards is dense Adam). A trainer of a two-trainer run
    gets its half of each batch (``tid``)."""
    feeds = [_dfm_batch(s) for s in range(DFM_PS_STEPS)] \
        if job["opt"] == "sgd" else [_dfm_batch(0)] * DFM_PS_STEPS
    if tid is not None and job["trainers"] > 1:
        n = DFM_BATCH // job["trainers"]
        feeds = [{k: v[tid * n:(tid + 1) * n] for k, v in f.items()}
                 for f in feeds]
    return feeds


def _ps_dfm_trainer(torch, fluid, args, job, tid):
    """Phase 20 (b) in a trainer: one DeepFM run through the transpiled
    program (prefetch, send_sparse) against the two pservers. Trainer 0
    holds the weights after every step (the tables read back from the
    shards) against a local ``is_sparse`` run from the same start on the
    whole batches: for a two-trainer run (fan-in 2, SGD) one trainer at
    double batch, whose mean gradient is half the two trainers' summed
    ones, at twice the rate."""
    from paddle_tpu_torch.models import deepfm as D
    init = dict(np.load(job["init"]))
    exe = fluid.Executor(fluid.CUDAPlace(0))
    tables = ("fm_first_w", "fm_second_w")
    want = []
    if tid == 0:
        local = _ps_dfm_program(fluid, D, job["opt"], False,
                                lr_scale=job["trainers"])
        scope = fluid.Scope()
        exe.run(local[1], scope=scope)
        fluid.load_numpy_state(scope, init, exe.device)
        for f in _ps_dfm_feeds(job):
            exe.run(local[0], feed=f, fetch_list=[local[2]], scope=scope)
            want.append(_ps_params(local[0], scope))
    prog = _ps_dfm_program(fluid, D, job["opt"], True)
    t = _ps_transpile(fluid, prog, args["eps"], job["trainers"], tid)
    check(sorted(t._dist_tables) == sorted(tables),
          "ps (b): the sharded tables are %s", sorted(t._dist_tables))
    ops = [op.type for op in prog[0].global_block().ops]
    check(ops.count("prefetch") == 2 * DFM["num_fields"]
          and "send_sparse" in ops and "lookup_table" not in ops,
          "ps (b): the trainer program does not prefetch its tables")
    scope = fluid.Scope()
    exe.run(prog[1], scope=scope)
    check(all(scope.find_var(n) is None for n in tables),
          "ps (b): the trainer holds a [V, D] table")
    fluid.load_numpy_state(scope, {n: v for n, v in init.items()
                                   if scope.find_var(n) is not None},
                           exe.device)
    for pf in job["port_files"]:
        _ps_wait_file(pf)
    gaps, ms = [], []
    for i, f in enumerate(_ps_dfm_feeds(job, tid)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        exe.run(prog[0], feed=f, fetch_list=[prog[2]], scope=scope)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        if want:
            got = dict(_ps_params(prog[0], scope),
                       **_ps_tables(args["eps"], tables,
                                    DFM["vocab_size"]))
            gap = max(_ps_gap(got[n], want[i][n]) for n in want[i])
            gaps.append(gap)
            check(gap <= DFM_TOL, "ps (b) %s: step %d weights %.3g from "
                  "the local run (limit %g)", job["name"], i + 1, gap,
                  DFM_TOL)
    _ps_write(os.path.join(args["tmp"], "done_%s_%d" % (job["name"], tid)),
              {"tid": tid})
    if tid == 0:
        for k in range(1, job["trainers"]):
            _ps_wait_file(os.path.join(args["tmp"], "done_%s_%d"
                                       % (job["name"], k)))
        _ps_exit(args["eps"])
    return {"job": job["name"], "tid": tid, "gaps": gaps, "ms": ms,
            "trainers": job["trainers"], "opt": job["opt"]}


def _ps_trainer_child(args):
    import torch
    import paddle_tpu_torch as fluid
    out = []
    for job in args["jobs"]:
        print("trainer %d: job %s" % (args["tid"], job["name"]),
              file=sys.stderr, flush=True)
        if job["kind"] == "lm":
            out.append(_ps_lm_trainer(torch, fluid, args, job))
        else:
            out.append(_ps_dfm_trainer(torch, fluid, args, job,
                                       args["tid"]))
    return {"tid": args["tid"], "jobs": out}


# (c): the chaos composition of tests/test_chaos.py, one process a role
def _chaos_master_child(args):
    """KV store and master task queue, one of each for the fault-free
    run and one for the chaos run; serves until the stop file."""
    from paddle_tpu_torch.distributed.master import MasterServer, TaskQueue
    from paddle_tpu_torch.distributed.membership import KVServer
    tmp = args["tmp"]
    servers, ports = [], {}
    for run in ("base", "chaos"):
        kv = KVServer(sweep_interval=0.05).start()
        m = MasterServer(TaskQueue(
            payloads=list(range(args["tasks"])), timeout_s=300,
            snapshot_path=os.path.join(tmp, "q_%s.json" % run))).start()
        servers += [kv, m]
        ports["kv_" + run] = kv.endpoint
        ports["m_" + run] = "127.0.0.1:%d" % m.port
    _ps_write(args["port_file"], ports)
    deadline = time.monotonic() + PS_CHILD_TIMEOUT
    while not os.path.exists(args["stop_file"]) \
            and time.monotonic() < deadline:
        time.sleep(0.05)
    for s in servers:
        s.stop()
    return {"ports": ports}


def _chaos_pserver_child(args):
    """The pserver cell: a VariableServer whose SGD runs on the card,
    its membership lease and a checkpoint every CHAOS_CKPT_S; a replacement
    first recovers from the dead cell's checkpoint. Serves until EXIT
    (or dies by SIGKILL)."""
    import threading
    import torch
    from paddle_tpu_torch.distributed.membership import (KVClient,
                                                         register_pserver)
    from paddle_tpu_torch.distributed.rpc import VariableServer
    dev = torch.device("cuda")

    def sgd_on_card(store, grads):
        for k, g in grads.items():
            p = k.replace("@GRAD", "")
            if p in store:
                w = torch.from_numpy(np.ascontiguousarray(store[p])).to(dev)
                w -= CHAOS_LR * torch.from_numpy(
                    np.ascontiguousarray(np.asarray(g))).to(dev)
                store[p] = w.cpu().numpy()

    server = VariableServer(fan_in=1, optimize_fn=sgd_on_card, sync=True)
    recovered = server.recover(args["ckpt"]) if args["recover"] else None
    server.start()
    ep = "127.0.0.1:%d" % server.port
    kv = KVClient(args["kv"])
    _, lease = register_pserver(kv, 1, ep, ttl=CHAOS_TTL)
    stop = threading.Event()

    def ckpt_loop():
        while not stop.wait(CHAOS_CKPT_S):
            try:
                server.checkpoint(args["ckpt"])
            except Exception:
                pass

    th = threading.Thread(target=ckpt_loop, daemon=True)
    th.start()
    _ps_write(args["port_file"], {"endpoint": ep, "pid": os.getpid(),
                                  "recovered": recovered})
    server._shutdown.wait(PS_CHILD_TIMEOUT)
    stop.set()
    th.join(timeout=30)
    lease.revoke()
    kv.close()
    return {"endpoint": ep, "recovered": recovered, "round": server._round}


def _chaos_run(torch, fluid, exe, prog, params, init, batches, kv_ep,
               master_ep, ckpt_dir):
    """One trainer run of the composition: tasks from the master, each a
    step (the LM's loss and gradients on the card, one tagged round to
    the pserver found through the KV store, the new weights back) under
    ``resilient_loop`` (background checkpoints, NaN rollback). Returns
    the loop's summary."""
    import itertools
    from paddle_tpu_torch.distributed.master import MasterClient
    from paddle_tpu_torch.distributed.membership import KVClient, PS_PREFIX
    from paddle_tpu_torch.distributed.rpc import RPCClient
    from paddle_tpu_torch.resilience import Policy, resilient_loop
    main, _, avg_cost = prog
    grads = [p + "@GRAD" for p in params]
    pol = Policy(max_attempts=1000, base_delay=0.05, max_delay=2.0,
                 deadline=120.0, seed=5)
    resolver_kv = KVClient(kv_ep)

    def resolve():
        return resolver_kv.get(PS_PREFIX + "0")

    scope = fluid.Scope()
    fluid.load_numpy_state(scope, init, exe.device)
    cli = RPCClient(resolve(), retry=pol, resolver=resolve)
    for p in params:
        cli.put_var(p, scope.get_numpy(p))
    mcli = MasterClient(master_ep, retry=pol)
    inc = "%016x" % time.time_ns() + "c0ffee00"
    seq = itertools.count()

    def step_fn(step, feeds):
        outs = exe.run(main, feed=feeds, fetch_list=[avg_cost] + grads,
                       scope=scope)
        loss = float(np.asarray(outs[0]).reshape(-1)[0])
        if not np.isfinite(loss):
            return loss          # poisoned: push nothing, roll back
        tag = "t0:i%s:s%d" % (inc, next(seq))
        for name, g in zip(grads, outs[1:]):
            cli.send_var(name, g, tag=tag)
        cli.barrier(tag=tag)
        fluid.load_numpy_state(scope, {p: cli.get_var(p) for p in params},
                               exe.device)
        return loss

    def on_rollback(step):
        for p in params:
            cli.put_var(p, scope.get_numpy(p))

    def tasks():
        while True:
            tid, payload = mcli.get_task()
            if tid is None:
                if payload == "done":
                    return
                time.sleep(0.02)
                continue
            yield batches[payload]
            mcli.task_done(tid)

    try:
        return resilient_loop(step_fn, tasks(), ckpt_dir, program=main,
                              scope=scope, checkpoint_every=4,
                              max_rollbacks=4, background=True,
                              on_rollback=on_rollback)
    finally:
        cli.close()
        mcli.close()
        resolver_kv.close()


def _chaos_trainer_child(args):
    """The trainer of (c): the full-width LM without a local optimizer
    (its gradients go to the pserver), the fault-free run, then the
    chaos run under the armed fault plan, the monitor's flight recorder
    on."""
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import monitor
    from paddle_tpu_torch.distributed.membership import KVClient, PS_PREFIX
    from paddle_tpu_torch.models import transformer as T
    from paddle_tpu_torch.ops import flash_attention as F
    from paddle_tpu_torch.resilience import faults
    tmp = args["tmp"]
    exe = fluid.Executor(fluid.CUDAPlace(0))
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        avg_cost, _ = T.transformer_lm(
            vocab_size=VOCAB, max_len=MAX_LEN, n_layer=N_LAYER,
            n_head=N_HEAD, d_model=D_MODEL, d_inner=D_INNER, packed=True)
        pg = fluid.backward.append_backward(avg_cost)
    params = [p.name for p, _ in pg]
    init = {n: v for n, v in np.load(args["init"]).items()
            if main.global_block().has_var(n)}
    batches = [T.make_lm_batch(np.random.RandomState(100 + s), TRAIN_BATCH,
                               MAX_LEN, VOCAB) for s in range(args["tasks"])]
    prog = (main, startup, avg_cost)
    _flash_reset(F)
    base = _chaos_run(torch, fluid, exe, prog, params, init, batches,
                      args["kv_base"], args["m_base"],
                      os.path.join(tmp, "ck_base"))
    monitor.enable(log_path=os.path.join(tmp, "mon_chaos.jsonl"))
    # the RPC faults hit the chaos pserver's frames alone
    kv = KVClient(args["kv_chaos"])
    port = int(kv.get(PS_PREFIX + "0").rsplit(":", 1)[1])
    kv.close()
    spec = dict(CHAOS_SPEC, rpc=dict(CHAOS_SPEC["rpc"], ports=[port]))
    plan = faults.arm(spec, seed=CHAOS_SEED)
    try:
        chaos = _chaos_run(torch, fluid, exe, prog, params, init, batches,
                           args["kv_chaos"], args["m_chaos"],
                           os.path.join(tmp, "ck_chaos"))
    finally:
        faults.disarm()
        monitor.disable()
    evs = sorted({r["ev"] for r in monitor.read_jsonl(
        os.path.join(tmp, "mon_chaos.jsonl"))})
    keep = ("steps", "rollbacks", "skipped_steps", "losses", "final_loss",
            "checkpoints", "resumed_from")
    return {"base": {k: base[k] for k in keep},
            "chaos": {k: chaos[k] for k in keep},
            "trips": sorted({k for k, _ in plan.trips}),
            "events": evs, "flash": _flash_read(F)}


def _ps_child(argv):
    """Phase 20: ``chip_smoke.py --ps-child ROLE ARGS.json``, one role of
    the parameter-server runs; prints one JSON line of what it saw."""
    import faulthandler
    import torch
    faulthandler.enable()
    # a role that hangs names every thread's line before it is killed
    faulthandler.dump_traceback_later(PS_CHILD_TIMEOUT // 2, exit=False)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    role = argv[0]
    with open(argv[1]) as f:
        args = json.load(f)
    fn = {"pserver": _ps_pserver_child, "trainer": _ps_trainer_child,
          "chaos_master": _chaos_master_child,
          "chaos_pserver": _chaos_pserver_child,
          "chaos_trainer": _chaos_trainer_child,
          "replica": _fleet_replica_child}[role]
    try:
        res = fn(args)
    except SmokeFailure as e:
        print("chip_smoke: %s FAILED: %s" % (role, e), file=sys.stderr)
        return 1
    print(json.dumps(res))
    return 0


def _ps_spawn(tmp, role, args, tag):
    """Start one phase 20 role: (process, its args, out and err files)."""
    path = os.path.join(tmp, "args_%s.json" % tag)
    with open(path, "w") as f:
        json.dump(args, f)
    out = open(os.path.join(tmp, "%s.out" % tag), "w+")
    err = open(os.path.join(tmp, "%s.err" % tag), "w+")
    env = dict(os.environ, OMP_NUM_THREADS="2")
    p = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                          PS_CHILD, role, path], stdout=out, stderr=err,
                         cwd=ROOT, env=env)
    return {"p": p, "tag": tag, "out": out, "err": err}


def _ps_reap(kids, timeout, allow_killed=()):
    """Wait for every child within ``timeout`` seconds, or until one
    fails; any still running then is killed. Each must exit 0 (those in
    ``allow_killed``, SIGKILLed by the supervisor, excepted). Returns
    {tag: its JSON line}."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        rcs = [k["p"].poll() for k in kids]
        if all(rc is not None for rc in rcs) or any(
                rc not in (None, 0) and k["tag"] not in allow_killed
                for rc, k in zip(rcs, kids)):
            break           # all done, or one failed: stop the others
        time.sleep(0.05)
    for k in kids:
        if k["p"].poll() is None:
            k["p"].kill()
            k["p"].wait()
    res, bad = {}, []
    for k in kids:
        k["out"].seek(0)
        k["err"].seek(0)
        out, err = k["out"].read(), k["err"].read()
        k["out"].close()
        k["err"].close()
        if k["tag"] in allow_killed:
            continue
        if k["p"].returncode != 0:
            lines = [ln for ln in err.strip().splitlines() if ln.strip()]
            bad.append("%s exited %s: %s" % (k["tag"], k["p"].returncode,
                                             " | ".join(lines[-20:])))
            continue
        res[k["tag"]] = json.loads(out.strip().splitlines()[-1])
    check(not bad, "ps: %s", "; ".join(bad))
    return res


def _ps_init(torch, fluid, prog, path):
    """A program's parameters as its startup makes them on the card,
    saved as .npz (the optimizer state each run's own startup makes)."""
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    exe.run(prog[1], scope=scope)
    np.savez(path, **_ps_params(prog[0], scope))


def _ps_trace_check(tmp):
    """(a)'s three span logs merged into one timeline; every trainer
    send and recv (``rpc.send``, ``rpc.get``) has its pserver span under
    the same trace id, parented by it or by its retry attempt."""
    from paddle_tpu_torch.trace import merge
    logs = [os.path.join(tmp, "trace_%s.jsonl" % p)
            for p in ("trainer", "pserver0", "pserver1")]
    timeline, info = merge.merge_files(logs)
    spans = merge.load_logs(logs)["spans"]
    by_id = {s["span"]: s for s in spans}
    lanes = {e["args"]["name"].split(" ")[0]
             for e in timeline["traceEvents"]
             if e.get("name") == "process_name"}
    check(lanes == {"trainer", "pserver0", "pserver1"}, "ps (a): merged "
          "timeline lanes %s", sorted(lanes))
    client = [s for s in spans if s["proc"] == "trainer"
              and s["name"] in ("rpc.send", "rpc.get")]
    served = [s for s in spans if s["proc"].startswith("pserver")
              and s["name"] in ("pserver.SEND", "pserver.GET")]
    matched = 0
    for c in client:
        ok = False
        for s in served:
            par = by_id.get(s["parent"])
            if s["trace"] == c["trace"] and (
                    s["parent"] == c["span"]
                    or (par is not None and par["parent"] == c["span"])):
                ok = True
                break
        matched += ok
    check(client and matched == len(client), "ps (a): %d of %d trainer "
          "send/recv spans have their pserver span in the merged timeline",
          matched, len(client))
    return {"spans": len(spans), "client": len(client),
            "events": len(timeline["traceEvents"])}


def ps_train_phase(torch, smi, tmp):
    """Phase 20 (a) and (b): two pserver processes and two trainer
    processes on the card, spawned together; the pservers serve (a)'s LM
    job and (b)'s three DeepFM jobs in turn on the same endpoints."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import deepfm as D
    from paddle_tpu_torch.models import transformer as T
    lm_init = os.path.join(tmp, "lm_init.npz")
    dfm_init = os.path.join(tmp, "dfm_init.npz")
    _ps_init(torch, fluid, _ps_lm_program(fluid, T), lm_init)
    _ps_init(torch, fluid, _ps_dfm_program(fluid, D, "adam", False),
             dfm_init)
    from paddle_tpu_torch.distributed.rpc import VariableServer
    eps = []
    for _ in range(2):
        probe = VariableServer()
        eps.append("127.0.0.1:%d" % probe.port)
        probe.stop()

    def job(name, kind, **kw):
        return dict(name=name, kind=kind, trainers=kw.pop("trainers", 1),
                    init=lm_init if kind == "lm" else dfm_init,
                    port_files=[os.path.join(tmp, "port_%s_%d" % (name, i))
                                for i in range(2)], **kw)

    jobs = [job("lm", "lm", armed=True),
            job("dfm_sgd", "dfm", opt="sgd"),
            job("dfm_adam", "dfm", opt="adam"),
            job("dfm_sgd_2t", "dfm", opt="sgd", trainers=2)]
    kids = [_ps_spawn(tmp, "pserver", {"index": i, "eps": eps,
                                       "jobs": jobs, "tmp": tmp},
                      "pserver%d" % i) for i in range(2)]
    kids.append(_ps_spawn(tmp, "trainer", {"tid": 0, "eps": eps,
                                           "jobs": jobs, "tmp": tmp},
                          "trainer0"))
    kids.append(_ps_spawn(tmp, "trainer", {"tid": 1, "eps": eps,
                                           "jobs": jobs[-1:], "tmp": tmp},
                          "trainer1"))
    res = _ps_reap(kids, PS_CHILD_TIMEOUT)
    lm = res["trainer0"]["jobs"][0]
    want = N_LAYER * PS_STEPS
    for name in FLASH_KERNELS:
        check(lm["flash"][name] == want and lm["local_flash"][name] == want,
              "ps (a): %s launches %d through the pservers, %d locally != "
              "3 kernels' n_layer x %d steps = %d", name, lm["flash"][name],
              lm["local_flash"][name], PS_STEPS, want)
    for i in range(2):
        ps = res["pserver%d" % i]["jobs"]
        check(not any(any(j["flash"].values()) for j in ps),
              "ps: pserver %d launched a flash kernel", i)
        check([j["rounds"] for j in ps] == [PS_STEPS] + [DFM_PS_STEPS] * 3,
              "ps: pserver %d rounds %s", i, [j["rounds"] for j in ps])
        check(ps[0]["monitor_steps"] == 1, "ps (a): pserver %d's monitor "
              "saw %d runs", i, ps[0]["monitor_steps"])
    check(lm["recorder_steps"] == PS_STEPS, "ps (a): the trainer's "
          "recorder holds %d step events, not %d", lm["recorder_steps"],
          PS_STEPS)
    tr = _ps_trace_check(tmp)
    log("ps (a): LM at full width through DistributeTranspiler on %s: 1 "
        "trainer, 2 pservers on the card, %d Adam steps, weights %s from "
        "the local run (limit %g); losses %s (local %s); step ms %s (local "
        "%s); %.1f MB of gradients sent and %.1f MB of weights received a "
        "step; flash "
        "launches %s; merged trace: %d spans, %d trainer send/recv spans "
        "each with its pserver span (%s)", lm["device"], PS_STEPS,
        " ".join("%.2g" % g for g in lm["gaps"]), PS_TOL,
        " ".join("%.5f" % x for x in lm["losses"]),
        " ".join("%.5f" % x for x in lm["local_losses"]),
        " ".join("%.1f" % x for x in lm["ms"]),
        " ".join("%.1f" % x for x in lm["local_ms"]),
        lm["sent_value_bytes"] / 1e6, lm["recv_value_bytes"] / 1e6, lm["flash"], tr["spans"],
        tr["client"], smi)
    for j in res["trainer0"]["jobs"][1:]:
        log("ps (b) %s: DeepFM F%d V%d D%d batch %d, both FM tables "
            "sharded over 2 pservers, %d trainer(s), %s: weights after "
            "each step %s from the local is_sparse run%s (limit %g); "
            "trainer 0 step ms %s (%s)", j["job"], DFM["num_fields"],
            DFM["vocab_size"], DFM["embed_dim"], DFM_BATCH, j["trainers"],
            "lazy Adam" if j["opt"] == "adam" else "SGD",
            " ".join("%.2g" % g for g in j["gaps"]),
            " at double batch" if j["trainers"] > 1 else "", DFM_TOL,
            " ".join("%.1f" % x for x in j["ms"]), smi)
    return {name: lm["flash"][name] + lm["local_flash"][name]
            for name in FLASH_KERNELS}


def ps_chaos_phase(torch, smi, tmp):
    """Phase 20 (c): the chaos composition, one process a role; this
    process supervises: it SIGKILLs the chaos pserver once its
    checkpoint has reached CHAOS_KILL_ROUND, reaps it, waits for its
    lease to lapse and starts the replacement."""
    import signal
    from paddle_tpu_torch.distributed.master import MasterClient
    from paddle_tpu_torch.distributed.membership import KVClient, PS_PREFIX
    from paddle_tpu_torch.distributed.rpc import RPCClient
    lm_init = os.path.join(tmp, "lm_init.npz")
    ports_file = os.path.join(tmp, "chaos_ports.json")
    stop_file = os.path.join(tmp, "chaos_stop")
    kids = [_ps_spawn(tmp, "chaos_master", {
        "tmp": tmp, "tasks": CHAOS_TASKS, "port_file": ports_file,
        "stop_file": stop_file}, "chaos_master")]
    t0 = time.perf_counter()
    killed = {}
    try:
        ports = json.loads(_ps_wait_file(ports_file, proc=kids[0]["p"]))
        ckpt = {run: os.path.join(tmp, "ps_%s.ckpt" % run)
                for run in ("base", "chaos")}
        cells = {}
        for run in ("base", "chaos"):
            pf = os.path.join(tmp, "cell_%s.json" % run)
            kid = _ps_spawn(tmp, "chaos_pserver", {
                "kv": ports["kv_" + run], "ckpt": ckpt[run],
                "recover": False, "port_file": pf}, "cell_" + run)
            kids.append(kid)
            cells[run] = (kid, pf)
        for run, (kid, pf) in cells.items():
            _ps_wait_file(pf, proc=kid["p"])
        trainer = _ps_spawn(tmp, "chaos_trainer", dict(
            ports, tmp=tmp, tasks=CHAOS_TASKS, init=lm_init),
            "chaos_trainer")
        kids.append(trainer)
        # supervise: the kill, then the replacement
        victim = cells["chaos"][0]
        deadline = time.monotonic() + PS_CHILD_TIMEOUT
        while trainer["p"].poll() is None and time.monotonic() < deadline:
            try:
                with open(ckpt["chaos"] + ".meta") as f:
                    rnd = json.load(f)["round"]
            except (OSError, ValueError, KeyError):
                rnd = -1
            if rnd >= CHAOS_KILL_ROUND:
                break
            time.sleep(0.05)
        check(trainer["p"].poll() is None, "ps (c): the trainer exited "
              "before the chaos pserver reached round %d", CHAOS_KILL_ROUND)
        os.kill(victim["p"].pid, signal.SIGKILL)
        victim["p"].wait()          # reaped: its card memory is freed
        killed["round"] = rnd
        kv = KVClient(ports["kv_chaos"])
        while kv.get(PS_PREFIX + "0") is not None:
            check(time.monotonic() < deadline, "ps (c): the killed "
                  "pserver's lease never lapsed")
            time.sleep(0.05)
        kv.close()
        pf = os.path.join(tmp, "cell_replacement.json")
        kids.append(_ps_spawn(tmp, "chaos_pserver", {
            "kv": ports["kv_chaos"], "ckpt": ckpt["chaos"],
            "recover": True, "port_file": pf}, "cell_replacement"))
        replacement = json.loads(_ps_wait_file(pf, proc=kids[-1]["p"]))
        trainer["p"].wait(timeout=max(1.0, deadline - time.monotonic()))
        counts = {}
        for run in ("base", "chaos"):
            with MasterClient(ports["m_" + run]) as mc:
                counts[run] = mc.counts()
        for ep in (json.loads(_ps_wait_file(cells["base"][1]))["endpoint"],
                   replacement["endpoint"]):
            cli = RPCClient(ep, timeout=60.0)
            cli.shutdown_server()
            cli.close()
    finally:
        _ps_write(stop_file, {})
        res = _ps_reap(kids, PS_CHILD_TIMEOUT, allow_killed=("cell_chaos",))
    wall = time.perf_counter() - t0
    tr = res["chaos_trainer"]
    base, chaos = tr["base"], tr["chaos"]
    n = CHAOS_TASKS
    for run in ("base", "chaos"):
        check(counts[run] == {"todo": 0, "pending": 0, "done": n,
                              "failed": 0}, "ps (c): %s task accounting %s",
              run, counts[run])
    check(replacement["recovered"] is not None
          and replacement["recovered"] > 0, "ps (c): the replacement "
          "recovered round %s", replacement["recovered"])
    check({"nan", "ckpt_corrupt"} <= set(tr["trips"])
          and set(tr["trips"]) & {"drop", "duplicate", "close_mid_frame",
                                  "delay"}, "ps (c): faults fired %s",
          tr["trips"])
    check(chaos["rollbacks"] == 1 and chaos["steps"] == n - 1
          and base["steps"] == n and base["rollbacks"] == 0,
          "ps (c): rollbacks %d, steps %d of %d tasks (fault-free: %d)",
          chaos["rollbacks"], chaos["steps"], n, base["steps"])
    check(all(np.isfinite(chaos["losses"])), "ps (c): a loss is not finite")
    fb, ff = base["final_loss"], chaos["final_loss"]
    check(abs(ff - fb) <= 0.10 * abs(fb) + 0.05, "ps (c): final loss %.5f, "
          "fault-free %.5f", ff, fb)
    check(fb < base["losses"][0] and ff < chaos["losses"][0],
          "ps (c): a run did not learn")
    need = {"fault", "retry", "reconnect", "rollback", "checkpoint"}
    check(need <= set(tr["events"]), "ps (c): the flight recorder holds "
          "%s", tr["events"])
    log("ps (c): chaos composition on the full-width LM (%d tasks): "
        "faults %s; pserver SIGKILLed at checkpoint round %d, replacement "
        "recovered round %d through the KV store; rollbacks %d, skipped "
        "%s; final loss %.5f vs fault-free %.5f; recorder events %s; %.1f "
        "s (%s)", n, tr["trips"], killed["round"], replacement["recovered"],
        chaos["rollbacks"], chaos["skipped_steps"], ff, fb, tr["events"],
        wall, smi)
    return tr["flash"]


def pserver_phase(torch, smi):
    """Phase 20."""
    import tempfile
    t0 = time.perf_counter()
    work = os.path.join(ROOT, "build", "paddle_tpu_torch")
    os.makedirs(work, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=work) as tmp:
        flash = ps_train_phase(torch, smi, tmp)
        t1 = time.perf_counter()
        chaos = ps_chaos_phase(torch, smi, tmp)
    t2 = time.perf_counter()
    for name in FLASH_KERNELS:
        flash[name] += chaos[name]
    log("ps: phase 20 took %.1f s ((a) and (b) %.1f, (c) %.1f); flash "
        "launches %s (%s)", t2 - t0, t1 - t0, t2 - t1, flash, smi)
    return flash


# -- phase 21 ----------------------------------------------------------------
FLEET_CELLS = 3                   # (b): in-process cells
FLEET_SLOTS = 8                   # every cell's slots: one GEMM shape
FLEET_MEGASTEP = 8
FLEET_REQUESTS = 96
FLEET_CHAOS = {
    "rpc": {"drop": 0.03, "duplicate": 0.03, "close_mid_frame": 0.02,
            "delay": 0.05, "delay_s": 0.003, "max": 8},
    "kill": [{"target": "replica:0", "after": 3}],
    "stall": [{"target": "replica:1", "after": 2, "seconds": 2.5}],
}
FLEET_SEED = 1301
TEL_PAIRS = 2                     # (a): interleaved off/on pairs
SCORE_BATCH = 1024                # (d): the scoring engine's batch
SCORE_DNN = (400, 400, 400)
CANARY_DELTA = {
    "window_s": 300.0, "min_pairs": 6, "min_requests": 6,
    "objectives": [
        {"metric": "delta_ttft", "percentile": 0.95,
         "max_inflation": 4.0, "min_floor_s": 0.5},
        {"metric": "delta_error_rate", "max_delta": 0.5}],
}


def _fleet_requests(rng, n=FLEET_REQUESTS):
    """``n`` requests: prompts of 16-128 tokens, 32-64 new tokens."""
    return [([1] + rng.integers(3, VOCAB, int(rng.integers(15, 128)))
             .tolist(), int(rng.integers(32, 65))) for _ in range(n)]


def _fleet_artifacts(torch, fluid, T, tmp):
    """The full-width LM saved twice by ``save_lm_artifact``: v1 from a
    seeded startup, v2 after one more Adam step of the same program.
    Returns {"v1": dir, "v2": dir}."""
    from paddle_tpu_torch.serving import save_lm_artifact
    main, startup, avg_cost, logits = _io_lm(fluid, T, adam=True)
    startup.random_seed = 21
    fwd = _io_lm(fluid, T, adam=False)[0]
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    out = {}
    for name in ("v1", "v2"):
        if name == "v2":
            batch = T.make_lm_batch(np.random.RandomState(21),
                                    TRAIN_BATCH, MAX_LEN, VOCAB)
            loss, = exe.run(main, feed=batch, fetch_list=[avg_cost],
                            scope=scope)
            check(np.isfinite(float(np.asarray(loss))), "fleet: the v2 "
                  "Adam step's loss is not finite")
        out[name] = os.path.join(tmp, name)
        save_lm_artifact(out[name], fwd, scope, [logits], N_LAYER, N_HEAD,
                         D_MODEL, MAX_LEN, end_id=VOCAB, specialize=False)
    return out


def _same_tokens(torch, model, reqs, got, want, what, near_ties):
    """Each of ``got`` equal to ``want`` (request for request), or
    parting at a near-tie ``_divergence`` diagnoses."""
    check(len(got) == len(want), "%s: %d results for %d requests", what,
          len(got), len(want))
    for i, ((a, _), (b, _)) in enumerate(zip(got, want)):
        _same_or_near_tie(torch, model, reqs[i], a, b,
                          "%s request %d" % (what, i), near_ties)


def _fleet_reference(torch, art, reqs, **kw):
    """One engine's tokens over ``reqs`` (the fleet cells' settings)."""
    from paddle_tpu_torch.serving import Engine
    with Engine(art, slots=FLEET_SLOTS, megastep=FLEET_MEGASTEP,
                **kw) as eng:
        eng.warmup()
        out = eng.generate_many([p for p, _ in reqs], [m for _, m in reqs])
    torch.cuda.synchronize()
    return out


def telemetry_phase(torch, smi, arts, tmp):
    """(a) ``Engine(slots=32)`` from the v1 artifact on phase 9's mixed
    set with the monitor and the tracer on, against the same engine
    with both off: tokens identical, paged launches equal, one
    ``serving_request`` row per request, one ``engine.step`` span per
    iteration; ms per decode step with telemetry on and off as medians
    of interleaved pairs."""
    from paddle_tpu_torch import monitor
    from paddle_tpu_torch.ops import paged_attention as P
    from paddle_tpu_torch.serving import Engine
    from paddle_tpu_torch.trace import runtime as trt
    reqs = _requests(np.random.default_rng(0))
    runs = {False: [], True: []}
    for i in range(TEL_PAIRS):
        for on in (False, True):
            mlog = os.path.join(tmp, "tel-%d.jsonl" % i)
            spans = os.path.join(tmp, "tel-spans-%d.jsonl" % i)
            if on:
                trt.enable(log_path=spans, sample_rate=1.0, proc="tel")
                ctx = monitor.session(log_path=mlog)
            else:
                ctx = contextlib.nullcontext()
            try:
                with ctx, Engine(arts["v1"], slots=32) as eng:
                    eng.warmup()
                    P.paged_attention.launches = 0
                    out = eng.generate_many([p for p, _ in reqs],
                                            [m for _, m in reqs])
                    torch.cuda.synchronize()
                    launches = P.paged_attention.launches
                    stats = dict(eng.stats)
            finally:
                if on:
                    trt.disable()
            runs[on].append((out, launches, stats, mlog, spans))
    base = runs[False][0]
    for on in (False, True):
        for out, launches, stats, mlog, spans in runs[on]:
            check([t for t, _ in out] == [t for t, _ in base[0]],
                  "telemetry %s: tokens differ from the run with it off",
                  "on" if on else "off")
            check(launches == base[1], "telemetry %s: %d paged launches, "
                  "%d with it off", "on" if on else "off", launches,
                  base[1])
            if not on:
                continue
            rows = monitor.read_jsonl(mlog)
            reqrows = [r for r in rows if r["ev"] == "serving_request"]
            steprows = [r for r in rows if r["ev"] == "serving_step"]
            check(len(reqrows) == len(reqs), "telemetry: %d "
                  "serving_request rows for %d requests", len(reqrows),
                  len(reqs))
            check(len(steprows) == stats["steps"], "telemetry: %d "
                  "serving_step rows for %d iterations", len(steprows),
                  stats["steps"])
            sp = [r for r in monitor.read_jsonl(spans)
                  if r["ev"] == "span"]
            nstep = sum(s["name"] == "engine.step" for s in sp)
            check(nstep == stats["steps"], "telemetry: %d engine.step "
                  "spans for %d iterations", nstep, stats["steps"])
            check(sum(s["name"] == "serving.request" for s in sp)
                  == len(reqs), "telemetry: serving.request spans")

    def ms(run):
        st = run[2]
        return 1e3 * st["decode_seconds"] / st["decode_steps"]
    off = _median([ms(r) for r in runs[False]])
    on = _median([ms(r) for r in runs[True]])
    log("fleet (a): Engine(slots=32) from the artifact, %d requests: "
        "tokens and %d paged launches equal with telemetry on and off; "
        "%d serving_request rows, %d engine.step spans = iterations; ms "
        "per decode step off %.4f, on %.4f (medians of %d interleaved "
        "pairs) (%s)", len(reqs), base[1], len(reqs), base[2]["steps"],
        off, on, TEL_PAIRS, smi)
    return {"tel_off_ms": off, "tel_on_ms": on, "launches":
            sum(r[1] for v in runs.values() for r in v)}


def _fleet_replica_child(args):
    """Phase 21 (b)'s replica process (``--ps-child replica``): its engine
    booted from the artifact on the card and warmed while the in-process
    runs go on, then, once the go file appears, one ``fleet.Replica``
    over it registered in the KV store, serving until it is killed (or
    its stop file appears)."""
    from paddle_tpu_torch.distributed.membership import KVClient
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.serving import Engine, fleet
    from paddle_tpu_torch.trace import runtime as trt
    _build.load_all(["paged_attention"])
    trt.enable(log_path=args["spans"], sample_rate=1.0, proc="replica-proc")
    eng = Engine(args["art"], slots=FLEET_SLOTS, megastep=FLEET_MEGASTEP,
                 name="replica-proc").warmup()
    while not os.path.exists(args["go"]):
        time.sleep(0.05)
    kv = KVClient(args["kv"])
    cell = fleet.Replica(kv, None, desired=args["desired"], ttl=1.0,
                         engine_factory=lambda name: eng, version="v1")
    _ps_write(args["ready"], {"endpoint": cell.endpoint})
    while not os.path.exists(args["stop"]):
        time.sleep(0.05)
    cell.shutdown()
    trt.disable()
    return {"endpoint": cell.endpoint}


def _cleared_cublas(torch):
    """Bytes allocated after dropping cuBLAS's workspaces (PyTorch keeps
    one a handle and stream for the process)."""
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()
    return torch.cuda.memory_allocated()


def _serve_all(router, reqs, timeout=600):
    hs = [router.submit(p, m, session="s%d" % (i % 8))
          for i, (p, m) in enumerate(reqs)]
    return [h.result(timeout=timeout) for h in hs]


def fleet_phase(torch, smi, arts, tmp, ref, near_ties):
    """(b) Three in-process cells (slots 8, megastep 8) behind a Router
    and a Supervisor, 96 requests: exactly once and token-identical to
    one engine's run; again under the fault plan (a cell killed after 3
    dispatches, one stalled, frame faults); again with one replica as a
    process of its own, SIGKILLed mid-traffic. The Collector scrapes
    every replica, ``watch_fleet`` renders its line, the merged
    timeline holds the request lanes, the cells' paged launches sum to
    the total, and device memory after three respawns stays within one
    cell's footprint."""
    import gc
    import io as _io
    import signal
    from paddle_tpu_torch.distributed.membership import (
        KVClient, KVServer, live_endpoints)
    from paddle_tpu_torch.monitor.collector import Collector
    from paddle_tpu_torch.monitor.watch import watch_fleet
    from paddle_tpu_torch.ops import paged_attention as P
    from paddle_tpu_torch.resilience import faults
    from paddle_tpu_torch.serving import Engine, fleet
    from paddle_tpu_torch.trace import merge as tmerge
    from paddle_tpu_torch.trace import runtime as trt
    reqs, want, model = ref
    spans = os.path.join(tmp, "fleet-spans.jsonl")
    trt.enable(log_path=spans, sample_rate=1.0, proc="fleet")
    kvs = KVServer(sweep_interval=0.05).start()
    kv = KVClient(kvs.endpoint)
    cells, sup, router, child = [], None, None, None
    timings = {}
    try:
        # (b)'s replica process boots from the artifact while the
        # in-process runs go on; it registers once told to
        args = {"kv": kvs.endpoint, "art": arts["v1"],
                "desired": FLEET_CELLS + 1,
                "spans": os.path.join(tmp, "replica-proc-spans.jsonl"),
                "go": os.path.join(tmp, "replica-proc.go"),
                "ready": os.path.join(tmp, "replica-proc.ready"),
                "stop": os.path.join(tmp, "replica-proc.stop")}
        child = _ps_spawn(tmp, "replica", args, "replica-proc")
        gc.collect()
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()

        spawn_errors = []

        def engine(name):
            # warmed (its megastep graph captured) before the cell
            # registers, so no request reaches it first
            return Engine(arts["v1"], slots=FLEET_SLOTS,
                          megastep=FLEET_MEGASTEP, name=name).warmup()

        def spawn():
            try:
                c = fleet.Replica(kv, None, desired=FLEET_CELLS + 1,
                                  ttl=0.6, engine_factory=engine,
                                  version="v1")
            except Exception as e:
                spawn_errors.append(repr(e))
                raise
            cells.append(c)
            return c
        spawn()
        torch.cuda.synchronize()
        cell_bytes = torch.cuda.memory_allocated() - mem0
        for _ in range(FLEET_CELLS - 1):
            spawn()
        router = fleet.Router(kvs.endpoint, window=FLEET_SLOTS,
                              max_queue=4 * FLEET_REQUESTS,
                              stall_timeout=1.0, refresh_interval=0.05,
                              client_timeout=0.8, name="fleet-router")
        router.wait_for_replicas(FLEET_CELLS, timeout=60)
        mem_cells = _cleared_cublas(torch)
        n0 = P.paged_attention.launches
        c0 = sum(c.engine.stats["paged_launches"] for c in cells)
        t0 = time.perf_counter()
        got = _serve_all(router, reqs)
        torch.cuda.synchronize()
        timings["fault_free_s"] = time.perf_counter() - t0
        total = P.paged_attention.launches - n0
        timings["launches"] = total
        per_cell = [c.engine.stats["paged_launches"] for c in cells]
        check(sum(per_cell) - c0 == total, "fleet: the cells' paged "
              "launches %s sum to %d, the kernel counted %d", per_cell,
              sum(per_cell) - c0, total)
        check(total > 0, "fleet: no paged launch")
        _same_tokens(torch, model, reqs, got, want, "fleet", near_ties)
        st = dict(router.stats)
        check(st["completed"] == st["requests"] == len(reqs)
              and st["failed"] == 0, "fleet: router stats %s", st)
        ntok = sum(len(t) for t, _ in got)
        log("fleet (b): %d cells, %d requests exactly once, tokens equal "
            "one engine's; %d tokens in %.3f s = %.1f tokens/s; paged "
            "launches %d = the cells' %s (%s)", FLEET_CELLS, len(reqs),
            ntok, timings["fault_free_s"],
            ntok / timings["fault_free_s"], total, per_cell, smi)

        # the fault plan, the Supervisor respawning what dies
        sup = fleet.Supervisor(kv, spawn, desired=FLEET_CELLS,
                               interval=0.1).start()
        spec = dict(FLEET_CHAOS)
        spec["rpc"] = dict(spec["rpc"], ports=[c.server.port
                                               for c in cells])
        plan = faults.arm(spec, seed=FLEET_SEED)
        t0 = time.perf_counter()
        try:
            got = _serve_all(router, reqs)
        finally:
            faults.disarm()
        timings["chaos_s"] = time.perf_counter() - t0
        _same_tokens(torch, model, reqs, got, want, "fleet chaos",
                     near_ties)
        kinds = {k for k, _ in plan.trips}
        check({"kill", "stall"} <= kinds, "fleet chaos: trips %s",
              plan.trips)
        st = dict(router.stats)
        check(st["failed"] == 0 and st["completed"] == st["requests"]
              == 2 * len(reqs), "fleet chaos: router stats %s", st)
        router.wait_for_replicas(FLEET_CELLS, timeout=60)
        # more deaths until the Supervisor has replaced three cells: a
        # crash is replaced when it leaves fewer live registrations than
        # the fleet's (the evicted stalled cell, still beating, may hold
        # one of them)
        crashes, gc_s = 0, 0.0
        while sup.respawns < 3:
            check(crashes < 6, "fleet: %d respawns after %d crashes",
                  sup.respawns, crashes)
            t_gc = time.perf_counter()
            gc.collect()
            gc_s = max(gc_s, time.perf_counter() - t_gc)
            torch.cuda.synchronize()
            m_before = torch.cuda.memory_allocated()
            deadline = time.monotonic() + 60
            while True:
                reg = set(live_endpoints(kv, "replica").values())
                victim = next((c for c in cells if c.endpoint in reg
                               and not c.engine._stop), None)
                if victim is not None:
                    break
                check(time.monotonic() < deadline, "fleet: no registered "
                      "live cell to crash: registry %s, cells %s",
                      sorted(reg), [(c.endpoint, c.engine._stop,
                                     repr(c.engine._error)) for c in cells])
                time.sleep(0.05)
            victim.crash()
            crashes += 1
            # the victim's lease lapses, then the registry holds the
            # fleet's count again (the Supervisor's replacement, when one
            # was needed)
            deadline = time.monotonic() + 60
            while True:
                live = [v for v in live_endpoints(kv, "replica").values()
                        if not v.startswith(fleet.EVICTED_PREFIX)]
                if victim.endpoint not in live and \
                        len(live) >= FLEET_CELLS:
                    break
                check(time.monotonic() < deadline, "fleet: the registry "
                      "holds %s after a crash (spawn errors %s)", live,
                      spawn_errors[-3:])
                time.sleep(0.05)
            router.wait_for_replicas(FLEET_CELLS, timeout=60)
            gc.collect()
            torch.cuda.synchronize()
            log("fleet (b): a crash (respawns %d): allocated %+.1f MB; the "
                "longest full garbage collection so far %.3f s", sup.respawns,
                (torch.cuda.memory_allocated() - m_before) / 1e6, gc_s)
        check(sup.respawns >= 3, "fleet: %d respawns", sup.respawns)
        gc.collect()
        torch.cuda.synchronize()
        # a stalled cell the router evicted lives on (it is wedged, not
        # dead): each live cell past the fleet's own counts once
        alive = sum(not c.engine._stop for c in cells)
        # PyTorch keeps a cuBLAS workspace for every handle and stream
        # the process has used (a thread that runs a product takes a
        # handle): the process's, not a cell's, so both readings are
        # taken with them dropped
        with_ws = torch.cuda.memory_allocated()
        mem1 = _cleared_cublas(torch)
        log("fleet (b): cells (closed, model freed, state tensors, graphs): "
            "%s; allocated %.1f MB over the fleet's start, %.1f MB of it "
            "cuBLAS's workspaces", [
                (c.engine._stop, c.engine.model is None,
                 len(c.engine._state),
                 sum(g is not None for g in c.engine._graphs.values()))
                for c in cells], (mem1 - mem_cells) / 1e6,
            (with_ws - mem1) / 1e6)
        check(mem1 - mem_cells <= (alive - FLEET_CELLS + 1) * cell_bytes,
              "fleet: %d bytes allocated after %d respawns with %d live "
              "cells, %d with the fleet's %d up, one cell %d", mem1,
              sup.respawns, alive, mem_cells, FLEET_CELLS, cell_bytes)
        log("fleet (b) chaos: trips %s; %d resubmissions, evictions %s; "
            "%.3f s; %d respawns; allocated %.1f MB over the fleet's start "
            "with %d live cells (one cell %.1f MB)", sorted(kinds),
            st["resubmissions"], st["evictions"], timings["chaos_s"],
            sup.respawns, (mem1 - mem_cells) / 1e6, alive,
            cell_bytes / 1e6)
        sup.stop()
        sup = None

        # one replica as a process of its own (booted meanwhile),
        # SIGKILLed mid-traffic
        _ps_write(args["go"], {})
        ep = json.loads(_ps_wait_file(args["ready"], 300,
                                      child["p"]))["endpoint"]
        try:
            router.wait_for_replicas(FLEET_CELLS + 1, timeout=60)
        except TimeoutError as e:
            check(False, "fleet: %s with the replica process %s: the "
                  "registry %s, the router's replicas %s, the cells "
                  "(endpoint, slot, stopped) %s", e, ep,
                  live_endpoints(kv, "replica"), router.replicas(),
                  [(c.endpoint, c.slot, c.engine._stop) for c in cells])
        with Collector(kv_endpoint=kvs.endpoint, roles=("replica",)) as col:
            col.scrape_once()
            snap = col.fleet_snapshot()
            buf = _io.StringIO()
            frame = watch_fleet(collector=col, once=True, out=buf)
        eps = {e["endpoint"]: e for e in snap["__meta__"]["endpoints"]}
        live_eps = sorted(live_endpoints(kv, "replica").values())
        check(ep in live_eps, "fleet: the replica process %s is not "
              "registered: %s", ep, live_eps)
        for e in live_eps:
            check(e in eps and eps[e]["ok"], "collector: replica %s not "
                  "scraped: %s", e, eps.get(e))
        line = next((ln for ln in frame.splitlines() if "fleet" in ln), "")
        check(line, "watch_fleet rendered no fleet line")
        log("fleet (b): collector scraped %d replicas (%d processes); "
            "watch_fleet: %s", len(live_eps),
            snap["__meta__"]["processes"], line.strip())
        hs = [router.submit(p, m, session="p%d" % i)
              for i, (p, m) in enumerate(reqs)]
        done = 0
        deadline = time.monotonic() + 300
        while done < len(reqs) // 4:
            check(time.monotonic() < deadline, "fleet: no progress before "
                  "the kill")
            done = sum(h.done() for h in hs)
            time.sleep(0.01)
        child["p"].send_signal(signal.SIGKILL)
        child["p"].wait()
        got = [h.result(timeout=600) for h in hs]
        _same_tokens(torch, model, reqs, got, want, "fleet process kill",
                     near_ties)
        st = dict(router.stats)
        check(st["failed"] == 0 and st["completed"] == st["requests"],
              "fleet process kill: router stats %s", st)
        log("fleet (b): replica process SIGKILLed after %d of %d "
            "completions; all %d exactly once, token-identical; "
            "resubmissions %d", done, len(reqs), len(reqs),
            st["resubmissions"])
    finally:
        faults.disarm()
        if child is not None and child["p"].poll() is None:
            child["p"].kill()
            child["p"].wait()
        if child is not None:
            child["out"].close()
            child["err"].close()
        if router is not None:
            router.close()
        if sup is not None:
            sup.stop()
        for c in cells:
            try:
                c.shutdown()
            except Exception:
                pass
        trt.disable()
        kv.shutdown_server()
        kv.close()
    merged, info = tmerge.merge_files(
        [spans, os.path.join(tmp, "replica-proc-spans.jsonl")])
    names = {e.get("name") for e in merged["traceEvents"]}
    check({"router.dispatch", "replica.SUBM", "serving.request",
           "engine.step"} <= names, "merged timeline: spans %s",
          sorted(n for n in names if n))
    lanes = [e["args"]["name"] for e in merged["traceEvents"]
             if e.get("name") == "process_name"]
    log("fleet (b): merged timeline of %d spans over lanes %s holds the "
        "request lanes", info["spans"], lanes)
    return timings


def elastic_phase(torch, smi, arts, tmp, refs, near_ties):
    """(c) Autoscale 1 -> 3 under a burst from the v1 artifact, drain
    to 1; roll v1 -> v2 with a kill mid-roll (exactly once, each result
    token-identical to its version's); canary v2 under ``rollout``:
    healthy promoted on its verdicts, one with an injected stall aborted
    while v1 keeps serving, its forensic bundle written and verified by
    ``python -m paddle_tpu_torch.monitor bundle``."""
    from paddle_tpu_torch import monitor
    from paddle_tpu_torch.distributed.membership import KVClient, KVServer
    from paddle_tpu_torch.resilience import faults
    from paddle_tpu_torch.serving.autoscale import Autoscaler
    from paddle_tpu_torch.serving.fleet import Router
    reqs, v1ref, v2ref, model1, model2 = refs
    kvs = KVServer(sweep_interval=0.05).start()
    kv = KVClient(kvs.endpoint)
    auto = router = None
    out = {}
    mlog = os.path.join(tmp, "elastic.jsonl")
    try:
        with monitor.session(log_path=mlog):
            kw = dict(slots=FLEET_SLOTS, megastep=FLEET_MEGASTEP,
                      ttl=0.6, interval=0.05, cooldown=0.0,
                      drain_timeout=120.0, health_timeout=120.0)
            auto = Autoscaler(kvs.endpoint, arts["v1"], desired=1,
                              min_replicas=1, max_replicas=5, **kw).start()
            auto.wait_steady(timeout=120)
            router = Router(kvs.endpoint, window=FLEET_SLOTS,
                            max_queue=8 * FLEET_REQUESTS,
                            stall_timeout=2.0, refresh_interval=0.05,
                            client_timeout=1.5, name="elastic")
            router.wait_for_replicas(1, timeout=60)
            hs = [router.submit(p, m) for p, m in reqs]
            t0 = time.perf_counter()
            auto.set_desired(3, "burst")
            st = auto.wait_steady(timeout=120)
            out["scale_up_s"] = time.perf_counter() - t0
            check(st["live"] == 3, "elastic: %s after scaling up", st)
            got = [h.result(timeout=600) for h in hs]
            _same_tokens(torch, model1, reqs, got, v1ref, "elastic burst",
                         near_ties)
            t0 = time.perf_counter()
            auto.set_desired(1, "drain")
            st = auto.wait_steady(timeout=120)
            out["drain_s"] = time.perf_counter() - t0
            check(st["live"] == 1, "elastic: %s after draining", st)
            # the roll, its first drained cell killed mid-roll
            plan = faults.arm({"kill": [{"target": "roll", "after": 0}]},
                              seed=FLEET_SEED)
            hs = [router.submit(p, m) for p, m in reqs]
            t0 = time.perf_counter()
            auto.roll(arts["v2"])
            last = auto.wait_roll(timeout=300)
            out["roll_s"] = time.perf_counter() - t0
            faults.disarm()
            check(not last["aborted"], "elastic: the roll aborted: %s",
                  last)
            check(("kill", "roll") in plan.trips, "elastic: no kill "
                  "mid-roll: %s", plan.trips)
            got = [h.result(timeout=600) for h in hs]
            which = [_version_tokens(torch, refs, i, toks, "elastic roll",
                                     near_ties)
                     for i, (toks, _) in enumerate(got)]
            v1n, v2n = which.count("v1"), which.count("v2")
            st = auto.wait_steady(timeout=120)
            check(st["version_mix"].get("v2") == st["live"]
                  and not st["version_mix"].get("v1"),
                  "elastic: version mix %s after the roll", st)
            got = _serve_all(router, reqs[:16])
            _same_tokens(torch, model2, reqs[:16], got, v2ref[:16],
                         "elastic after the roll", near_ties)
            rst = dict(router.stats)
            check(rst["failed"] == 0 and rst["completed"]
                  == rst["requests"], "elastic: router stats %s", rst)
            log("fleet (c): scaled 1 -> 3 in %.3f s under a burst of %d, "
                "drained to 1 in %.3f s, rolled v1 -> v2 in %.3f s with a "
                "kill mid-roll (%d results v1's, %d v2's, exactly once); "
                "version mix %s (%s)", out["scale_up_s"], len(reqs),
                out["drain_s"], out["roll_s"], v1n, v2n,
                st["version_mix"], smi)
            auto.close()
            router.close()
            auto = router = None
            out.update(_canary_runs(torch, kvs, kv, arts, refs, tmp,
                                    near_ties))
    finally:
        faults.disarm()
        if router is not None:
            router.close()
        if auto is not None:
            auto.close()
        kv.shutdown_server()
        kv.close()
    rows = monitor.read_jsonl(mlog)
    evs = {r["ev"] for r in rows}
    check({"scale_event", "drain", "roll", "verdict", "rollout"} <= evs,
          "elastic: recorder rows %s", sorted(evs))
    return out


def _version_tokens(torch, refs, i, toks, what, near_ties):
    """Request ``i``'s tokens must be v1's or v2's (a canary serves some
    requests from the candidate): returns which, or fails unless they
    part from v1's at a near-tie."""
    reqs, v1ref, v2ref, model1, _ = refs
    if toks == v1ref[i][0]:
        return "v1"
    if toks == v2ref[i][0]:
        return "v2"
    _same_or_near_tie(torch, model1, reqs[i], toks, v1ref[i][0],
                      "%s request %d" % (what, i), near_ties)
    return "v1"


def _canary_runs(torch, kvs, kv, arts, refs, tmp, near_ties):
    """(c)'s canary: a healthy v2 promoted on its verdicts, then (the
    fleet back on v1) a v2 whose candidate stalls, aborted while v1
    serves, with its forensic bundle checked by the monitor CLI."""
    reqs, v1ref, _, model1, _ = refs
    import threading
    from paddle_tpu_torch.resilience import faults
    from paddle_tpu_torch.serving.autoscale import Autoscaler
    from paddle_tpu_torch.serving.fleet import Router
    from paddle_tpu_torch.serving.rollout import RolloutController
    out = {}
    for kind in ("healthy", "stalled"):
        kw = dict(slots=FLEET_SLOTS, megastep=FLEET_MEGASTEP, ttl=0.6)
        auto = Autoscaler(kvs.endpoint, arts["v1"], desired=2,
                          min_replicas=1, max_replicas=5, interval=0.05,
                          cooldown=0.0, drain_timeout=120.0,
                          health_timeout=120.0, **kw).start()
        router = ctl = None
        try:
            auto.wait_steady(timeout=120)
            router = Router(kvs.endpoint, window=FLEET_SLOTS,
                            max_queue=8 * FLEET_REQUESTS,
                            stall_timeout=2.0, refresh_interval=0.05,
                            client_timeout=1.5, name="canary-" + kind)
            router.wait_for_replicas(2, timeout=60)
            if kind == "stalled":
                # the candidate wedges past the router's stall deadline:
                # evicted, and with no respawn allowed the canary aborts
                plan = faults.arm({"stall": [{"target": "candidate",
                                              "after": 0,
                                              "seconds": 30.0}]},
                                  seed=FLEET_SEED)
            ctl = RolloutController(
                kvs.endpoint, router, auto, arts["v2"],
                {"delta": CANARY_DELTA}, candidates=1,
                shadow_fraction=1.0, canary_weight=0.3,
                verdict_timeout=120.0 if kind == "healthy" else 10.0,
                max_respawns=1 if kind == "healthy" else 0, capture=True,
                capture_dir=os.path.join(tmp, "bundles-" + kind), **kw)
            done = {}
            th = threading.Thread(target=lambda: done.update(st=ctl.run()),
                                  daemon=True)
            t0 = time.perf_counter()
            th.start()
            i = 0
            deadline = time.monotonic() + 300
            while th.is_alive():
                check(time.monotonic() < deadline, "canary %s: no end: %s",
                      kind, ctl.status())
                batch = [reqs[(i + j) % len(reqs)] for j in range(8)]
                got = _serve_all(router, batch)
                for j, (toks, _) in enumerate(got):
                    _version_tokens(torch, refs, (i + j) % len(reqs), toks,
                                    "canary " + kind, near_ties)
                i += 8
            th.join(timeout=120)
            faults.disarm()
            st = done.get("st") or ctl.status()
            out["canary_%s_s" % kind] = time.perf_counter() - t0
            if kind == "healthy":
                check(st["phase"] == "promoted", "canary healthy: %s", st)
                fst = auto.wait_steady(timeout=120)
                check(not fst["version_mix"].get("v1"), "canary healthy: "
                      "version mix %s", fst["version_mix"])
                log("fleet (c) canary: healthy v2 promoted in %.3f s; "
                    "verdicts %s", out["canary_healthy_s"],
                    {p: v.get("verdict")
                     for p, v in st["verdicts"].items()})
                continue
            check(("stall", "candidate") in plan.trips, "canary stalled: "
                  "the stall never fired: %s", plan.trips)
            check(st["phase"] in ("rolled-back", "aborted"),
                  "canary stalled: %s", st)
            fst = auto.wait_steady(timeout=120)
            check(fst["version_mix"].get("v1") == 2
                  and not fst["version_mix"].get("v2"),
                  "canary stalled: version mix %s", fst["version_mix"])
            got = _serve_all(router, reqs[:8])
            _same_tokens(torch, model1, reqs[:8], got, v1ref[:8],
                         "canary stalled, v1 after", near_ties)
            bdir = os.path.join(tmp, "bundles-stalled")
            bundles = sorted(d for d in os.listdir(bdir)
                             if d.startswith("bundle-")) \
                if os.path.isdir(bdir) else []
            check(bundles, "canary stalled: no forensic bundle")
            proc = subprocess.run(
                [sys.executable, "-m", "paddle_tpu_torch.monitor",
                 "bundle", os.path.join(bdir, bundles[-1])],
                capture_output=True, text=True, timeout=300, cwd=ROOT)
            check(proc.returncode == 0 and "manifest verified"
                  in proc.stdout, "monitor bundle exited %d: %s %s",
                  proc.returncode, proc.stdout[-2000:],
                  proc.stderr[-2000:])
            log("fleet (c) canary: stalled v2 %s in %.3f s, v1 serving; "
                "bundle %s verified by the monitor CLI", st["phase"],
                out["canary_stalled_s"], bundles[-1])
        finally:
            faults.disarm()
            if ctl is not None:
                ctl.close()
            if router is not None:
                router.close()
            auto.close()
    return out


def _score_tables(seed, vocab, dim):
    rng = np.random.RandomState(seed)
    return {"fm_first_w": (rng.rand(vocab, 1) * 0.1).astype(np.float32),
            "fm_second_w": (rng.rand(vocab, dim) * 0.1).astype(np.float32)}


def _score_shard(shard, nshard, tables, vocab, lr=0.5):
    from paddle_tpu_torch.distributed.rpc import VariableServer
    from paddle_tpu_torch.core.selected_rows import SelectedRows
    meta = {t: {"shard": shard, "num_shards": nshard, "height": vocab}
            for t in tables}

    def opt_fn(store, merged):
        for g, val in merged.items():
            t = g[:-5] if g.endswith("@GRAD") else g
            if t in store and isinstance(val, SelectedRows):
                store[t][np.asarray(val.rows) // nshard] -= \
                    lr * np.asarray(val.value)
    srv = VariableServer(fan_in=1, sparse_tables=meta, optimize_fn=opt_fn)
    for t in tables:
        srv.store[t] = np.asarray(tables[t])[shard::nshard].copy()
    srv.start()
    return srv, "127.0.0.1:%d" % srv.port


def sparse_phase(torch, smi, tmp):
    """(d) DeepFM F8 D16 V20k scoring (``build_scoring_net``) with both
    FM tables on two row-sharded pservers, ``ScoringEngine`` with a
    ``HotIDCache`` on the card behind the router: batches of 1,024
    bitwise equal to the direct Executor at the same shape on the card,
    the card's scores within 1e-6 of the CPU's, ``OnlineTrainer``
    pushing while it serves with the measured staleness within its
    bound, and a pserver killed mid-serve and recovered from its
    checkpoint."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import monitor
    from paddle_tpu_torch.distributed import membership as M
    from paddle_tpu_torch.models import deepfm as dfm
    from paddle_tpu_torch.serving import fleet
    from paddle_tpu_torch.serving.sparse import (
        HotIDCache, OnlineTrainer, ScoringEngine, SparseClient,
        measure_staleness)
    F, D, V = DFM["num_fields"], DFM["embed_dim"], DFM["vocab_size"]
    nshard, bound = 2, 5.0
    tables = _score_tables(21, V, D)
    kvs = M.KVServer(sweep_interval=0.05).start()
    kv = M.KVClient(kvs.endpoint)
    servers, eps, leases = [], [], []
    engines, router, cell, trainer = [], None, None, None
    out = {}
    mlog = os.path.join(tmp, "sparse.jsonl")
    try:
        for sh in range(nshard):
            srv, ep = _score_shard(sh, nshard, tables, V)
            servers.append(srv)
            eps.append(ep)
            leases.append(M.register_endpoint(kv, "ps", nshard, ep,
                                              ttl=1.0)[1])
        main, startup = fluid.Program(), fluid.Program()
        startup.random_seed = 21
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            prob, _ = dfm.build_scoring_net(F, D, dnn_dims=SCORE_DNN)
        scope = fluid.Scope()
        fluid.Executor(fluid.CUDAPlace(0)).run(startup, scope=scope)
        cpu_scope = fluid.Scope()
        from paddle_tpu_torch.core.scope import load_numpy_state
        from paddle_tpu_torch.core.executor import as_numpy
        load_numpy_state(cpu_scope, {
            v.name: as_numpy(scope.find_var(v.name))
            for v in main.global_block().vars.values()
            if v.persistable and scope.find_var(v.name) is not None},
            "cpu")

        def engine(name, place, sc, staleness=60.0):
            cache = HotIDCache(capacity=65536, staleness_s=staleness)
            c1 = SparseClient("fm_first_w", eps, kv=kv, cache=cache)
            c2 = SparseClient("fm_second_w", eps, kv=kv, cache=cache)
            feat = dfm.make_featurizer(c1, c2, F, D)
            eng = ScoringEngine(main, sc, prob.name, feat,
                                clients=[c1, c2], batch=SCORE_BATCH,
                                name=name, place=place)
            engines.append(eng)
            return eng, feat
        rng = np.random.RandomState(21)

        def feats(n):
            return [{"f%d" % f: [int(rng.randint(0, V))]
                     for f in range(F)} for _ in range(n)]
        batch = feats(SCORE_BATCH)
        batch[1]["f0"] = [2, 5, 9]          # multi-hot, sum-pooled
        del batch[2]["f1"]                  # an absent field pools to 0
        card, feat = engine("card", fluid.CUDAPlace(0), scope)
        cpu, _ = engine("cpu", fluid.CPUPlace(), cpu_scope)
        t0 = time.perf_counter()
        got = card.score_many(batch, timeout=300)
        out["score_cold_ms"] = 1e3 * (time.perf_counter() - t0)
        # the same batch again: every row a cache hit, the dispatch warm
        t0 = time.perf_counter()
        again = card.score_many(batch, timeout=300)
        out["score_ms"] = 1e3 * (time.perf_counter() - t0)
        check(again == got, "sparse: the warm batch scored differently")
        # the direct Executor over the same featurized feed and shape
        direct, = fluid.Executor(fluid.CUDAPlace(0)).run(
            main, feed=feat(batch, SCORE_BATCH), fetch_list=[prob.name],
            scope=scope)
        direct = np.asarray(direct).reshape(-1)[:SCORE_BATCH]
        check(np.array_equal(np.asarray(got, np.float32), direct),
              "sparse: the scoring engine's batch of %d differs from the "
              "direct Executor's at the same shape (largest %g)",
              SCORE_BATCH, float(np.abs(np.asarray(got) - direct).max()))
        on_cpu = cpu.score_many(batch, timeout=300)
        err = float(np.abs(np.asarray(got) - np.asarray(on_cpu)).max())
        check(err <= 1e-6, "sparse: card scores differ from the CPU's by "
              "%g > 1e-6", err)
        log("sparse (d): DeepFM F%d D%d V%d scoring, batch %d: card "
            "bitwise equal to the direct Executor; card vs CPU largest "
            "|difference| %.3g (limit 1e-6); %.3f ms for the batch "
            "through the engine cold (rows from the pservers, the first "
            "dispatch), %.3f ms warm (%s)", F, D, V, SCORE_BATCH, err,
            out["score_cold_ms"], out["score_ms"], smi)
        card.close()
        cpu.close()

        # routed, with online updates and a pserver killed mid-serve
        with monitor.session(log_path=mlog):
            eng, _ = engine("routed", fluid.CUDAPlace(0), scope,
                            staleness=0.2)
            cell = fleet.Replica(kv, None, desired=1, ttl=1.0,
                                 role="scoring",
                                 engine_factory=lambda name: eng)
            router = fleet.Router(kvs.endpoint, role="scoring",
                                  window=SCORE_BATCH,
                                  max_queue=4 * SCORE_BATCH,
                                  refresh_interval=0.05,
                                  stall_timeout=30.0, name="scoring")
            router.wait_for_replicas(1, timeout=60)
            hot = rng.randint(0, V, 64)
            trainer = OnlineTrainer(
                "fm_second_w", eps, height=V, interval=0.03, kv=kv,
                update_fn=lambda: (hot, rng.rand(len(hot), D)
                                   .astype(np.float32) * 0.01))
            trainer.start()
            hs = []
            ckpt = os.path.join(tmp, "shard0.ckpt")
            for i in range(2 * SCORE_BATCH):
                hs.append(router.submit(features=feats(1)[0]))
                if i == SCORE_BATCH // 2:
                    servers[0].checkpoint(ckpt)
                    leases[0].revoke()
                    servers[0].stop()
                if i == SCORE_BATCH // 2 + SCORE_BATCH // 4:
                    repl, new_ep = _score_shard(0, nshard, tables, V)
                    check(repl.recover(ckpt) is not None,
                          "sparse: the replacement shard recovered nothing")
                    servers[0] = repl
                    leases[0] = M.register_endpoint(kv, "ps", nshard,
                                                    new_ep, ttl=1.0)[1]
            res = [h.result(timeout=600) for h in hs]
            rst = dict(router.stats)
            check(len(res) == len(hs) and rst["failed"] == 0
                  and rst["completed"] == rst["requests"] == len(hs),
                  "sparse: router stats %s", rst)
            check(all(np.isfinite(s) for _, s in res),
                  "sparse: a routed score is not finite")
            trainer.stop()
            stale = measure_staleness(trainer, eng._clients[1],
                                      probe_id=int(hot[0]), timeout=30.0)
            check(stale < bound, "sparse: staleness %.3f s past %.1f s",
                  stale, bound)
            inval = eng._clients[0].cache.stats["invalidations"]
            check(inval >= 1, "sparse: the respawned shard's incarnation "
                  "invalidated nothing")
        out["staleness_s"] = stale
        log("sparse (d): %d routed requests exactly once across a pserver "
            "kill and recovery, online updates landing; staleness %.3f s "
            "(bound %.1f s); %d cache invalidations", len(hs), stale, bound,
            inval)
    finally:
        if trainer is not None:
            trainer.close()
        if router is not None:
            router.close()
        if cell is not None:
            cell.shutdown()
        for eng in engines:
            eng.close()
            for c in eng._clients:
                c.close()
        for srv in servers:
            srv.stop()
        kv.shutdown_server()
        kv.close()
    return out


def pexe_nan_phase(torch, smi, tmp):
    """(e) ``ParallelExecutor`` at one rank on the card writes ``pexe``
    recorder rows and ``pexe.step`` spans; the ``debug_nans`` flag
    raises on a planted NaN on the card, naming the op."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import flags, monitor, parallel
    from paddle_tpu_torch.models import transformer as T
    from paddle_tpu_torch.trace import runtime as trt
    main, startup, avg_cost, _ = _io_lm(fluid, T, adam=True)
    scope = fluid.Scope()
    fluid.Executor(fluid.CUDAPlace(0)).run(startup, scope=scope)
    mesh = parallel.make_mesh({"dp": 1}, "cuda")
    pexe = fluid.ParallelExecutor(loss_name=avg_cost.name,
                                  main_program=main, mesh=mesh,
                                  scope=scope)
    log_path = os.path.join(tmp, "pexe.jsonl")
    spans = os.path.join(tmp, "pexe-spans.jsonl")
    trt.enable(log_path=spans, sample_rate=1.0, proc="pexe")
    try:
        with monitor.session(log_path=log_path):
            for i in range(3):
                loss, = pexe.run([avg_cost], feed=T.make_lm_batch(
                    np.random.RandomState(i), TRAIN_BATCH, MAX_LEN, VOCAB))
                check(np.isfinite(float(np.asarray(loss))),
                      "pexe: loss not finite")
    finally:
        trt.disable()
    rows = [r for r in monitor.read_jsonl(log_path)
            if r.get("executor") == "pexe"]
    kinds = sorted({r["ev"] for r in rows})
    nspan = sum(r["ev"] == "span" and r["name"] == "pexe.step"
                for r in monitor.read_jsonl(spans))
    check("compile" in kinds and "step" in kinds, "pexe: rows %s", kinds)
    check(nspan == 3, "pexe: %d pexe.step spans for 3 steps", nspan)
    # a planted NaN: log of a negative activation
    nmain, nstart = fluid.Program(), fluid.Program()
    with fluid.program_guard(nmain, nstart):
        x = fluid.layers.data("x", [64])
        h = fluid.layers.fc(x, 64)
        loss = fluid.layers.mean(fluid.layers.log(h))
        fluid.optimizer.SGD(0.1).minimize(loss)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    sc = fluid.Scope()
    exe.run(nstart, scope=sc)
    feed = {"x": np.random.RandomState(0).randn(32, 64).astype(np.float32)}
    flags.set_flag("debug_nans", True)
    try:
        try:
            exe.run(nmain, feed=feed, fetch_list=[loss], scope=sc)
        except FloatingPointError as e:
            msg = str(e)
        else:
            raise SmokeFailure("debug_nans: a NaN-making run did not raise")
    finally:
        flags.set_flag("debug_nans", None)
    check("'log'" in msg, "debug_nans: the error names no log op: %s", msg)
    log("fleet (e): ParallelExecutor at one rank wrote %d pexe rows (%s) "
        "and %d pexe.step spans; debug_nans raised on the card: %s",
        len(rows), kinds, nspan, msg)


def fleet_serving_phase(torch, smi):
    """Phase 21."""
    import tempfile
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import transformer as T
    from paddle_tpu_torch.serving import model_from_artifact, \
        sequential_generate
    t0 = time.perf_counter()
    work = os.path.join(ROOT, "build", "paddle_tpu_torch")
    os.makedirs(work, exist_ok=True)
    near_ties = []
    times = {}
    with tempfile.TemporaryDirectory(dir=work) as tmp:
        arts = _fleet_artifacts(torch, fluid, T, tmp)
        tel = telemetry_phase(torch, smi, arts, tmp)
        t1 = time.perf_counter()
        reqs = _fleet_requests(np.random.default_rng(21))
        v1ref = _fleet_reference(torch, arts["v1"], reqs)
        model1 = model_from_artifact(arts["v1"])
        seq = sequential_generate(model1, reqs[:4])
        for i, ((a, _), (b, _)) in enumerate(zip(v1ref[:4], seq)):
            _same_or_near_tie(torch, model1, reqs[i], a, b,
                              "fleet reference request %d vs "
                              "sequential_generate" % i, near_ties)
        times.update(fleet_phase(torch, smi, arts, tmp,
                                 (reqs, v1ref, model1), near_ties))
        t2 = time.perf_counter()
        ereqs = reqs[:48]
        v2ref = _fleet_reference(torch, arts["v2"], ereqs)
        model2 = model_from_artifact(arts["v2"])
        times.update(elastic_phase(torch, smi, arts, tmp,
                                   (ereqs, v1ref[:48], v2ref, model1,
                                    model2), near_ties))
        t3 = time.perf_counter()
        times.update(sparse_phase(torch, smi, tmp))
        t4 = time.perf_counter()
        pexe_nan_phase(torch, smi, tmp)
    t5 = time.perf_counter()
    launches = tel.pop("launches") + times.pop("launches")
    log("fleet: phase 21 took %.1f s ((a) %.1f, (b) %.1f, (c) %.1f, (d) "
        "%.1f, (e) %.1f); near-ties %d; %s (%s)", t5 - t0, t1 - t0,
        t2 - t1, t3 - t2, t4 - t3, t5 - t4, len(near_ties),
        json.dumps({k: round(v, 4) for k, v in dict(tel, **times).items()}),
        smi)
    return launches


def _device_rows(torch, prof):
    """[(device us, launches, name)] of a closed profile's device events
    (kernels, copies, fills), one row a name, summed from its kineto
    results: ``key_averages()`` gives the same rows (a serving trace's
    47, 60,299 launches and its busy time to the digit on an H100) but
    first parses every event into a tree, 5-12 s a serving trace against
    0.3-0.7 s so."""
    rows = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            row = rows.setdefault(ev.name(), [0.0, 0])
            row[0] += ev.duration_ns() / 1e3
            row[1] += 1
    return [(us, n, name) for name, (us, n) in rows.items() if us > 0]


def _report_profile(prof, wall, title, focus=None):
    """Device busy share of ``wall`` and the top kernels; with ``focus``,
    also the share of the kernels whose names hold it. Returns (busy
    share or None when the profiler saw no device time, launches of the
    focus kernels in the trace)."""
    import torch
    rows = _device_rows(torch, prof)
    if not rows:
        log("%s: the profiler reported no device time (not measured)",
            title)
        return None, 0
    busy_s = sum(r[0] for r in rows) / 1e6
    log("%s: wall %.3f s, device busy %.3f s = %.1f%% (idle %.1f%%)",
        title, wall, busy_s, 100 * busy_s / wall, 100 - 100 * busy_s / wall)
    for dev_us, count, key in sorted(rows, reverse=True)[:10]:
        log("  %6.1f%% of device time  %8.3f ms  x%-6d %s",
            100 * dev_us / 1e6 / busy_s, dev_us / 1e3, count, key[:70])
    mine = [r for r in rows if focus and focus in r[2]]
    if focus:
        log("%s: %s %.3f ms in %d launches = %.1f%% of device time",
            title, focus, sum(r[0] for r in mine) / 1e3,
            sum(r[1] for r in mine),
            100 * sum(r[0] for r in mine) / 1e6 / busy_s)
    return busy_s / wall, sum(r[1] for r in mine)


def main():
    try:
        import torch
    except ImportError as e:
        print("chip_smoke: torch is not importable: %s" % e,
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import paddle_tpu_torch  # noqa: F401
    except ImportError as e:
        print("chip_smoke: the port is not importable from %s: %s"
              % (ROOT, e), file=sys.stderr)
        return 2
    if sys.argv[1:2] == [FRONT_CHILD]:
        return _front_profile_child(sys.argv[2])
    if sys.argv[1:2] == [PAR_CHILD]:
        return _par_child(sys.argv[2:])
    if sys.argv[1:2] == [PS_CHILD]:
        return _ps_child(sys.argv[2:])
    try:
        smi = device_phase(torch)
        build_phase()
        max_err = kernel_phase(torch)
        times = timing_phase(torch)
        launches = slice_phase(torch)
        flash_err = flash_kernel_phase(torch)
        flash_times = flash_timing_phase(torch)
        flash_launches = train_phase(torch)
        import paddle_tpu_torch as fluid
        from paddle_tpu_torch.models import resnet as R
        resnet, shapes = _resnet_program(fluid, R)
        mm_err = mm_kernel_phase(torch, shapes)
        mm_times = mm_timing_phase(torch, shapes)
        mm_launches = resnet_phase(torch, resnet, shapes)
        lm_counts, _, _ = mega_train_lm_phase(torch, smi)
        mega_resnet = mega_train_resnet_phase(torch, resnet, smi)
        serve_launches, _, seqs = mega_serve_phase(torch, smi)
        spec_err, spec_times = spec_kernel_phase(torch)
        spec_launches, scoring_launches, _ = spec_serve_phase(torch, smi,
                                                              seqs)
        io_launches, _, _, io_bf16 = io_phase(torch, smi)
        options_flash, options_dropout, dropout_times = options_phase(
            torch, smi)
        mt_launches, mt_err, mt_times, zoo_drops = mt_phase(torch, smi)
        deepfm_phase(torch, smi)
        lstm_launches, lstm_graph, lstm_cell, _ = lstm_phase(torch, smi)
        srl_launches, srl_graph, _ = crf_detection_phase(torch, smi)
        data = data_plane_phase(torch, smi)
        front = frontend_phase(torch, smi)
        par = parallel_phase(torch, smi)
        ps = pserver_phase(torch, smi)
        fleet_launches = fleet_serving_phase(torch, smi)
    except SmokeFailure as e:
        print("chip_smoke: FAILED: %s" % e, file=sys.stderr)
        return 1
    flash_src = "paddle_tpu_torch/ops/csrc/flash_attention.cu"
    # launches: the eager main path's and the graph path's (counted
    # through replays), each reset just before its run and read after
    mm_graph = mega_resnet["fused"][0]["matmul_stats"]
    kernels = [dict({
        "name": "paged_attention", "route": "cuda",
        "source": "paddle_tpu_torch/ops/csrc/paged_attention.cu",
        "replaces": "paddle_tpu/ops/paged_attention.py:185",
        "launches": (launches + serve_launches + spec_launches
                     + io_launches["paged_attention"] + fleet_launches),
        "graph_launches": serve_launches, "spec_launches": spec_launches,
        "fleet_launches": fleet_launches,
        "io_launches": io_launches["paged_attention"],
        "max_abs_err": max(max_err, spec_err),
        "scoring_shape": dict(spec_times, launches=scoring_launches)},
        **times)]
    for name, line in (("flash_fwd", 68), ("flash_bwd_dq", 163),
                       ("flash_bwd_dkv", 202)):
        kernels.append(dict({
            "name": name, "route": "cuda", "source": flash_src,
            "replaces": "paddle_tpu/ops/flash_attention.py:%d" % line,
            "launches": (flash_launches[name] + lm_counts[name]
                         + io_launches[name] + options_flash[name]
                         + mt_launches[name] + front["flash"][name]
                         + par[name] + ps[name]),
            "graph_launches": lm_counts[name],
            "front_launches": front["flash"][name],
            "par_launches": par[name],
            "ps_launches": ps[name],
            "io_launches": io_launches[name],
            "io_bf16_launches": io_bf16[name],
            "options_launches": options_flash[name],
            "mt_launches": mt_launches[name],
            "max_abs_err": max(flash_err[name], mt_err[name]),
            "mt_shape": mt_times[name]}, **flash_times[name]))
    kernels.append(dict({
        "name": "matmul_stats", "route": "cuda",
        "source": "paddle_tpu_torch/ops/csrc/matmul_stats.cu",
        "replaces": "paddle_tpu/ops/matmul_stats.py:72",
        "launches": (mm_launches + mm_graph + data["mm_launches"]
                     + front["mm_launches"]),
        "graph_launches": mm_graph, "data_launches": data["mm_launches"],
        "front_launches": front["mm_launches"],
        "max_abs_err": max(mm_err, data["mm_err"]),
        "cifar_shortcut_shapes": data["mm_shapes"]}, **mm_times))
    kernels.append(dict({
        "name": "dropout", "route": "cuda", "tpu_kernel": False,
        "source": "paddle_tpu_torch/ops/csrc/dropout.cu",
        "replaces": "paddle_tpu/ops/nn.py:51 (jax.random.bernoulli, fused "
                    "by XLA: no Pallas kernel)",
        "launches": options_dropout + zoo_drops,
        "options_launches": options_dropout, "zoo_launches": zoo_drops},
        **dropout_times))
    kernels.append(dict({
        "name": "lstm_cell", "route": "cuda", "tpu_kernel": False,
        "source": "paddle_tpu_torch/ops/csrc/lstm_cell.cu",
        "replaces": "paddle_tpu/ops/rnn_ops.py:111-131 (lax.scan body, "
                    "fused by XLA: no Pallas kernel)",
        "launches": lstm_launches + srl_launches + data["lstm_launches"],
        "graph_launches": lstm_graph, "srl_launches": srl_launches,
        "srl_graph_launches": srl_graph,
        "data_launches": data["lstm_launches"],
        "data_graph_launches": data["lstm_graph_launches"]}, **lstm_cell))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
