#!/usr/bin/env python3
"""Chip smoke test of mxnet_tpu_torch on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py

Drives the port's paths end to end with random weights and data from a
seed: at GPT-2 medium's published widths (OpenAI GPT-2 "355M": n_embd
1024, n_head 16, n_layer 24, n_positions 1024, vocab 50257, MLP 4096),
Gluon training of a causal transformer LM (the repo's TransformerEncoder
equations: LayerNorm, ReLU FFN, an untied Dense head with bias) and
decode serving (DecodeModel: RMSNorm, no biases, an untied head); at
ResNet-50's widths (batch 128, bf16), the fused 1x1 convolution of a
stage-2 bottleneck boundary; and runtime compilation of CUDA C++ through
NVRTC (rtc.CudaModule). Phases, one JSON line each:

  device   card name, power limit (nvidia-smi), torch/CUDA versions
  build    nvcc builds every kernel of mxnet_tpu_torch/csrc, timed; fails
           if ptxas reports a spill in any instance
  kernels  each kernel against its plain PyTorch version at the main
           paths' shapes (max error vs a stated tolerance), and timed
           (device time) beside its plain version and one library call;
           head dims 384 and 512 through the wide kernels, 96 and 640
           and cross-attention (S_q 128, S_k 512) through the dense
           route; the attention kernels in bfloat16 and float16 beside
           SDPA in the same type (each element against its row's
           magnitude; a control with one tile of keys dropped must fail
           that check); the f32 flash forward and dQ against
           float64 (exact_flash_*: within 4x the plain f32 version's own
           error, which one TF32 pass, emulated, must break); decode (split
           over the pool, one launch a call) at GQA groups 7 and 16, with
           every slot at 512 of 1024 (the serving profile's step) and at
           Llama-3-8B's widths over a 32768-position pool, a second call
           bit-identical, and f32 decode against float64 as the flash
           kernels (exact_decode_f32_*); the quantized matmul's decode and prefill kernels with float32,
           bfloat16 and float16 x; conv1x1 at ResNet-50's five 1x1 shapes
           (bf16), f32, f16 and a mixed (f16 x, bf16 w) pair; the rtc
           kernels over 2^26 floats with NVRTC's compile time. Each
           case also reads its kernel launches a call from the counter
           that every launch site in csrc raises (_build.launches)
  train    TransformerEncoder + Dense head trained through the port's
           Gluon (initialize, autograd.record, loss.backward,
           Trainer("adam").step) on 8 x 1024 tokens: every parameter's
           gradient held against the plain attention path on a
           2-sequence slice, then 2 warm-up and 5 timed steps (loss per
           step, step time, tokens/s, peak memory, launches per step)
  train_profile
           one training step under torch.profiler: device time by kernel
  engine_f32 / engine_int8
           DecodeEngine serving 8 staggered sessions with float and
           int8 weights through its CUDA graphs (the step, and one graph
           a prompt bucket, captured before the timed run); one
           session's per-token logits held against a full-context
           recompute through the plain path; tokens/s, the served step's
           wall time, per-token latency, each kernel's launch count, and
           the graphs: capture seconds, plan_compiles (step_compiles must
           be 1, no capture in the timed run), plan_resident_bytes, the
           launches captured and those the replays made
  profile  one decode step, eager and as the engine's step graph, side by
           side: host wall time of each, the graph run as the engine
           serves it (also at ragged lengths with two logits rows kept,
           and with the card idle between steps) and back to back, device
           time by kernel under torch.profiler
  serve_gqa
           DecodeEngine serving 8 sessions (prompts 17..4000 tokens) at
           Qwen2-7B's attention and model widths (28 q heads over 4 kv
           heads, head dim 128, d_model 3584, d_ff 18944, vocab 152064;
           4 of its 28 layers, max_len 4096) with f32 weights drawn on the
           card, through graphs as the engines, logits against a
           full-context recompute, then the profile phase's step with
           decode attention's share
  export   the decode artifact's write side at GPT-2 medium's widths, 2 of
           its 24 layers: export_decode_model (f32), quantize_decode_
           artifact (int8), DecodeEngine on the int8 file; its params and
           tokens held bit for bit against an engine given the same int8
           params in memory
  conv     ResNet-50 stage 2 at batch 128, bf16, through ops.conv_fused:
           expand 64 -> 256 with statistics, finalize_stats, bn_fold, then
           the next block's reduce 256 -> 64 with the BN + residual + ReLU
           prologue and statistics; held against the same chain through
           reference_conv1x1; time per application, peak memory, launches
  rtc      a user's runtime-compiled kernels through rtc.CudaModule:
           compile, get_kernel, launch (grid, block, dynamic shared
           memory) over 2^26 floats, checked against torch
  module_lenet / module_resnet50
           the symbolic path through Module.fit: LeNet
           (examples/train_mnist.py) and ResNet-50 v1 at bench.py's
           flagship configuration in float32, each held against the port
           on the CPU
  gluon_resnet50
           the model zoo's resnet50_v1 through hybridized Gluon at
           bench.py's flagship configuration (batch 128, 224², float32,
           SoftmaxCrossEntropyLoss, Trainer("sgd"), 20 steps after 2):
           img/s beside module_resnet50's, host and device time a step,
           peak memory; beforehand a whole batch-2 step (output,
           gradients, moving statistics, updated parameters) against the
           port on the CPU in float64 and by module_resnet50's float32
           rule (a TF32 control must fail it)
  gluon_cifar
           examples/gluon_cifar.py's program on the card with only its
           import changed (mx.gpu() for mx.tpu()): its own accuracy bar
  gluon_lm_hybrid
           the causal LM of examples/transformer_lm.py at GPT-2 medium's
           widths, hybridized (the flash kernels through the registered
           _contrib_flash_attention op in the executor's walk), 8 x 1024
           tokens, Adam, 3 steps after 1, held against the same net run
           eagerly from the same parameters; the flash kernels' launches
  gluon_fused_resnet50
           the model zoo's resnet50_v1 through gluon.trainer.fused_fit
           (steps_per_dispatch=4: 4 replays of DataParallelTrainer's
           CUDA graph a block) over a gluon.data.DataLoader of an
           ArrayDataset at bench.py's flagship configuration, 8 batches
           of images from RandomState(0), 2 epochs: img/s over the
           second beside module_resnet50's and gluon_resnet50's, host
           enqueue against device time a step, busy share, captures,
           peak memory; beforehand K = 4 against K = 1 and 2 fused steps
           against 2 steps of the hybridized Trainer loop at batch 8
  gluon_fused_lm
           the LM of gluon_lm_hybrid (encoder and head in one
           HybridSequential, Adam) through fused_fit(steps_per_dispatch=2):
           the flash forward, dQ and dK/dV kernels inside the captured
           step, their launches counted over the replays (24 a step),
           step time, device time a step, peak memory; the first 3 steps'
           losses against gluon_lm_hybrid's loop from the same parameters
  dp_resnet50
           bench.py's flagship lane through parallel.DataParallelTrainer
           on data_parallel_mesh(1): ResNet-50 v1 at batch 128, bf16 with
           fp32 masters, the step a CUDA graph replayed K = 4 times a
           step_k (3 windows of 40 steps, then 40 single steps), f32 (20
           steps); step_k held against K steps, and a bf16 and an f32
           step against the port's CPU step from the same parameters,
           each against float64 (bf16 beside four faulty steps that
           must fail its rule);
           img/s, host enqueue against device time a step, the device
           kernels of a bf16 step, capture seconds, pool bytes, peak
           memory
  module_fused
           LeNet through Module.fit(steps_per_dispatch=4) against
           steps_per_dispatch=1 from the same parameters, then the
           example's 8 epochs fused: validation accuracy, seconds an
           epoch, samples/s
  gluon_fused_lm_amp (after gluon_fused_lm)
           the same LM and fit under amp.init("bfloat16"): step time
           beside the f32 step, the device split of a replay (flash
           kernels, bf16 tensor-core and SIMT f32 GEMMs), the flash
           kernels' launches a replay in bf16 (24 each), the first 3
           losses against the f32 ones (1e-2) and falling; a control
           with the op widened to fp32 by the policy must fail the bf16
           check
  dp_resnet50_fp16 (after dp_resnet50)
           dp_resnet50's lane in float16 with the loss scaler on the
           card: step_k against K steps, img/s beside the bf16 lane's;
           an inf in one batch skipped without re-capture (state
           bit-identical, scale halved, one more skip)
  ckpt_resume
           the amp LM (4 of 24 layers) through fused_fit and LeNet
           through Module.fit, each resumed from an async checkpoint in a
           fresh net or Module: the last 4 losses and the final
           parameters bit-identical to the uninterrupted run; bench.py's
           checkpoint lane (steps/s with no, blocking and async commits,
           restore ms, bytes a commit)
  rnn_op   the fused RNN op (ops/rnn_ops.py) in its four modes, 2 layers,
           one and two directions: outputs and gradients (data,
           parameters, both states) in f32 on the card against the same
           op on the CPU in float64, within 4x the CPU f32's own error (a
           control with R transposed must fail); at the lstm_lm lane's
           shape its forward + backward beside torch.nn.LSTM's (cuDNN,
           the library yardstick, on no path) in f32 and bf16;
           gluon.rnn.LSTM against LSTMCell.unroll with the same weights
  lstm_lm  bench.py's lstm_lm lane as written (vocab 10000, hidden 512,
           2 layers, batch 32, seq 64, bf16) through DataParallelTrainer:
           step_k(K=16, unroll=2) in 3 windows of 64 steps, tokens/s
           beside single-dispatch tokens/s, device ms a step, busy share,
           kernels a step, peak memory; beforehand step_k against 16
           steps and a batch-2 f32 step against the CPU's float64 step
           (a step with the recurrent gradient zeroed must fail)
  lstm_bucketing
           examples/lstm_bucketing.py's program on the card with only its
           import changed, --ctx gpu: its own perplexity bar, seconds,
           steps/s, its 3 bucket modules over one parameter buffer (the
           example's toy widths); then BucketingModule at the widths of
           MXNet's example/rnn/bucketing defaults (2 x 200 LSTM, batch
           32, buckets 10..60, vocab 10000) over a synthetic corpus:
           tokens/s, samples/s, steps/s, ms a step by bucket, 6 modules
           over one buffer, perplexity falling
  predict  the predict tier on ResNet-50 v1 at bench.py's inference lane
           (batch 32, 224 x 224, weights from the seed, BatchNorm
           statistics from 30 training-mode passes): export_model on the
           card in f32 (cpu and cuda programs) and bf16, Predictor and
           ServingEngine (one CUDA graph at the export batch) from the
           file, every bucket's rows against the predictor's, wall ms by
           bucket and the graph's replay ms, img/s at 32 beside the
           executor plan's (bench.py's _infer_ips), a profiler read of a
           bucket-32 call; the bf16 batch against the executor's bf16
           walk and the f32 batch (norm-wise errors, top-1 agreement; the
           f32 batch itself and the bf16 rows shifted by one must fail);
           a batch-2 request on the card
           and on the CPU against float64 (a plan that slices the padding
           rows must fail); a DynamicBatcher closed loop (64 clients of 1
           row, 10 s); bench.py's int8_serving lane as written (int8
           within 1e-2 of bf16); quantize_model on ResNet-50 (naive, 2
           batches) with every quantized node held bit for bit against
           the CPU on the card's inputs, top-1 agreement and the two
           graphs' ms; the int8 route at K = 4608 against the CPU and the
           float32 route (which must be wrong); examples/export_predict.py
           and quantize_resnet.py (naive, entropy) with only their
           imports changed
  serving_net
           the frontend's --bench as bench.py's serving_net lane runs it
           (2 toy MLPs x 2 replicas, 64 urllib clients, 768 requests);
           examples/serve_two_models.py with only its import changed; the
           f32 and bf16 ResNet-50 artifacts hot behind a ServingFrontend,
           2 replicas each: 64 urllib clients of 1-image requests in a
           closed loop against each (QPS, p50/p99, shed), then a budget
           that evicts the LRU one when a third loads (the bytes each is
           charged, the card's memory); a decode artifact at GPT-2
           medium's widths (2 layers) driven by :generate through the
           frontend against DecodeEngine.generate (the tokens vary; a
           position table shifted by one must change them); and
           python -m mxnet_tpu_torch.serving --selftest on the card with
           its own 2x bar (the batcher's closed loop against one
           Predictor call a request)
  ssd300   SSD300-VGG16 (ssd300_vgg16_symbol: MXNet's example/ssd at its
           published widths, 8,732 anchors, VOC's 20 classes) trained
           through Module at batch 32 of 300 x 300 float32 images
           (synthetic, seeded; SGD lr 0.004, momentum 0.9, wd 5e-4):
           img/s over steps 3..12, the softmax and box losses first
           against last, peak memory, one profiled step (top kernels,
           the device time under MultiBoxPrior / MultiBoxTarget /
           MultiBoxDetection); beforehand a batch-2 step on the card and
           the CPU against float64 (module_resnet50's float32 rule, class
           targets equal); then MultiBoxTarget and MultiBoxDetection
           (nms_topk 400) on the trained network's batch of 32, card
           against CPU (masks, classes, kept rows equal; floats within
           1e-5), beside two wrong assignments that must fail (anchors
           shifted by a row, the bipartite pass skipped), each op's
           device and wall ms; examples/ssd_train.py with only its import
           changed (--ctx tpu: the card)
  dlrm     the row-sparse EmbeddingTrainer at the widths of
           facebookresearch/dlrm's Criteo Kaggle script (its 26 tables
           as one 33,762,577 x 16 table, 13 dense features, MLP
           512-256-1) on synthetic zipf(1.3) clicks, the table drawn once
           on the card and carried between arms by export and import:
           sparse SGD at batch 128 and 2048, bf16 and fp8 wires, dense
           SGD (the A/B), sparse Adam; each arm's steps/s and samples/s
           (median of 3 windows), touched rows, analytic wire, peak
           memory, busy share, kernels a step, top device operations,
           and a warmed step under sync-debug "error"; then sparse =
           dense bit for bit on permutation data, the card against the
           CPU at a 2^20-row table (SGD with momentum in full, Adam's
           first loss; untouched rows bit for bit) beside two faults
           that must fail (every row's moments decayed, the inverse map
           shifted), sparse.dot and kvstore row-sparse pushes on the
           card, examples/dlrm_train.py's program (its loss falls; a
           resumed step is bit-identical) and the CLI's --bench
  device_feed
           ResNet-50 v1 (gluon_fused_resnet50's configuration: batch
           128, 224², float32, K = 4) through fused_fit over a
           re-iterable source whose host cost a batch is one device step
           (time.sleep, calibrated by a run of a free source: bench.py's
           pipeline lane design), 3 epochs with MXNET_DEVICE_FEED off and
           then on, cuDNN's deterministic algorithms in both: img/s over
           epochs 1..2 of each and their ratio, the feed's overlap_frac,
           feed_wait_us and feed_stage_us, the card's idle at each
           epoch's start and between blocks; the parameters after the
           two fits bit-identical
  traced_lm
           gluon_fused_lm's LM (24 layers, 8 x 1024 tokens, Adam, K = 2,
           2 epochs of 3 steps) through fused_fit with every runtime
           plane off, then with span tracing, the JSONL step log, the
           flight recorder (flusher on), the watchdog and the profiler's
           torch.profiler kernel lane on, from the same parameters:
           losses and parameters bit-identical, steps/s of each and the
           tracing tax; the trace shard merged (step.fused_dispatch,
           feed.wait, feed.stage spans in their phases), one step-log
           record a block with its feed / compute breakdown; the
           kernel lane's flash_fwd_tc / flash_bwd_dq_tc / flash_bwd_dkv
           counts against the launch counters over 2 more step_k calls
           (replays; 2 eager steps of the hybridized loop as well); one
           traced step_k (a span, the step log, a feed staging) under
           torch.cuda.set_sync_debug_mode("error"); a stalled loop's
           watchdog dump within its stall_s; an exception's flight-
           recorder box holding the last spans; one /metrics scrape
           (device_feed, devstats, span and step series) and /healthz;
           Monitor(monitor_all=True) over 2 steps of LeNet's Module.fit on
           the card against the CPU (the same names, stats within
           MODULE_RTOL)
  planner  the sharding planner on zero_lm's LM loss Symbol (GPT-2
           medium's widths, 12 of its 24 layers) over 4 replicas of the
           card: plan_auto's table (every
           candidate's FLOPs, bytes, wire, peak, cost and status; dp,
           zero1, zero2, dp2.tp2, dp2.tp2+zero2 priced, pp4 unsupported),
           two runs in the same order, a 1 GiB budget rejecting all with
           no trainer built; dp, dp2.tp2 and dp2.tp2+zero2 trained 3
           steps each from one seed (losses against dp's, 48 launches a
           step of each flash kernel with the kernel lane equal to the
           counters, per-replica resident bytes against
           estimate_hbm_bytes, s a step, the cost source's FLOPs and their
           share of the f32 peak), the predicted order beside the
           measured; the planner CLI's --selftest and --bench
  group2ctx
           LeNet through Module.fit with the convolutions in a group on
           gpu(0) and the FC head on cpu(): each node's outputs on its
           group's device, card + host against the all-card walk
           (outputs and gradients within MODULE_RTOL), a control with
           the head on the card making no cross-device copy; ms a step
  image_codec
           nvJPEG (csrc/nvjpeg_codec.cu) decoding the committed JPEG
           fixture (tests/data/jpeg_fixture.npz) against the JAX
           package's OpenCV decode beside it (mean and largest
           difference; another entry's pixels must fail), an encode
           round trip at quality 95 (PSNR), the batched decode's rate
           on 1 and 4 host threads, and the batch-assembly kernel
           (csrc/image_assemble.cu) against its plain version at the
           main shape, 128 JPEGs of 256² -> 3 x 224² (uint8 with crop
           and mirror bit-identical, float32 with mean/std), timed
           beside its bytes bound
  image_rec_resnet50
           bench.py's e2e_data lane: a .rec of 2560 synthetic 256²
           JPEGs (quality 90, labels 0-999) encoded on the card by
           recordio.pack_img, ImageRecordIter on the card route (batch
           128, 224², random crop and mirror, 4 threads, 3 batches in
           flight, uint8): the pipeline alone (img/s), then ResNet-50
           v1 through DataParallelTrainer in bf16 with input_preproc
           normalizing on the card (img/s end to end beside
           dp_resnet50's synthetic-input img/s), cross-entropy a step,
           peak memory, the card's busy share over 5 steps from the
           profiler's kernel lane; one batch's crops and mirrors held
           against the same iterator at ctx=cpu()
  image_det_rec
           ImageDetIter on the card (nvJPEG, the detection augmenters
           as torch ops) from a .rec of 256 JPEGs of 300² with 1-4
           packed boxes, SSD300's batch 32 with rand_crop and
           rand_mirror, feeding 3 steps of the ssd300 phase's Module;
           the labels after the augmenters equal the host iterator's
           for the same seed
  faster_rcnn
           Faster R-CNN VGG16 (tools/torch_rcnn.py: example/rcnn's
           end-to-end training, one 600 x 1000 image a step, 21 classes,
           Proposal 12,000 -> 2,000 at NMS 0.7, the proposal_target Custom
           op sampling 128 rois, ROIPooling 7 x 7, fc6/fc7 of 4096)
           trained through Module.fit in float32: a float64 step at
           192 x 320 on the card and the host first (proposals and
           sampled rois equal, losses and gradients within 1e-9); 12
           steps, images/s and ms a step over steps 3-12, each loss term
           first against last, ROIPooling's and the NMS's launches and
           the Custom op's host ms a step, peak memory; 2 profiled steps
           (device ms by kernel group and under Proposal, Custom and
           ROIPooling); the NMS kernel's keep mask on the trained
           network's boxes against its plain version, and a control at
           another threshold that must fail. The kernels phase holds
           both kernels (csrc/roi_pooling.cu, csrc/proposal_nms.cu) at
           these shapes
  contrib_ops
           the other contrib ops at realistic shapes (R-FCN's PSROI and
           deformable PSROI pooling, a 3 x 3 512 -> 512 deformable
           convolution at 37 x 62, CTC at T 80 x 128, the samplers 60²
           -> 40², FlowNet-C's correlation, fft over 1,024, ...) on the
           card against the host in float64 by the float32 rule; LeNet
           with a Custom head through DataParallelTrainer.step_k, eager
           with its reason, against 8 Module steps
  feedforward
           LeNet through mx.model.FeedForward over the bundled digits:
           validation accuracy over 0.9, save/load with predict
           bit-identical, and the JAX package's FeedForward checkpoint
           (tests/data/feedforward_jax-*) loaded and predicting its own
           stored probabilities

then the nvidia-smi line, a ``kernels`` summary line, and last
``{"ok": true, "device": {...}}``. Exits non-zero (and prints no result)
without CUDA, or when any phase fails. Details go to
chiprun_out/chip_smoke.json.

    python3 chip_smoke.py --phases device,engines,profile [--package ROOT]

runs only the named phases (the serving pair, say), with the package
found under ROOT (default: this script's directory), so that two trees
can be measured by the same script on one card: run the parent's and
the change's trees in turn, parent, change, change, parent. It prints
the phases' lines and ``{"ok": ..., "phases": [...]}``.
"""
import contextlib
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "chiprun_out")

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 bandwidth, the
# FP32 rate outside the tensor cores (the f32 kernels' type), and the bf16
# tensor-core rate (the bf16 conv1x1's type)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_F64_FLOPS = 34e12        # outside the tensor cores (H100 SXM data sheet)
# the flash forward and dQ kernels form each f32 product as 3 TF32
# tensor-core products (bf16/f16 inputs: 1 product at the bf16 rate)
TF32_PIECES = 3
# f32 flash forward and dQ against float64: within F64_FACTOR times the
# plain f32 version's own float64 error
F64_FACTOR = 4
# bf16/f16 attention outputs vs their plain versions, element by element:
# |got - ref| within HALF_ULPS units of (one ulp of |ref| there + one ulp
# of the root-sum-square of the terms it sums), ulps of the output type
# (mxnet_tpu_torch.test_utils.half_units). The kernels round P and dS to
# the input type before their second product, as the TPU kernels do,
# which moves an element by a fraction of its terms; the plain versions
# round once at the end. Causal rows and keys differ in magnitude by 30x
# and more, so no tensor-wide scale is used. Each bf16/f16 flash case also
# holds a control, its plain version with DROP_KEYS keys from S/2 on left
# out of every row (a skipped K/V tile), which must fail the check.
HALF_ULPS = 2
DROP_KEYS = 64
DTYPES = {}             # "f32" / "bf16" / "f16" -> torch dtype, at run time
# the quantized matmul's kernels form each f32 x as 3 exact bf16 pieces on
# the bf16 tensor cores (bf16 x: 1 piece; f16 x: 1 product on the f16
# tensor cores, where every int8 and e4m3 weight is exact)
QMM_PIECES = {"f32": 3, "bf16": 1, "f16": 1}
# ... so with f32 x they agree with float64 within QMM_F64_ULPS * K units of
# 2^-24 of sum |x| |q| * scale: f32 sums of exact products in any order
QMM_F64_ULPS = 4

# GPT-2 medium widths
CFG = dict(vocab=50257, layers=24, d_model=1024, heads=16, kv_heads=16,
           d_ff=4096, max_len=1024)
SLOTS = 8
# the export phase's cut of GPT-2 medium's 24 layers
EXPORT_LAYERS = 2
PROMPT_LENS = (17, 60, 100, 200, 300, 500, 700, 900)
NEW_TOKENS = 32
SEED = 0

# GQA serving at Qwen2-7B's widths (Qwen's published config.json for
# Qwen2-7B: hidden_size 3584, num_attention_heads 28, num_key_value_heads
# 4, intermediate_size 18944, vocab_size 152064; head dim 128, group 7) in
# DecodeModel's own blocks (RMSNorm, tanh-GELU MLP, learned positions: not
# Qwen2's SwiGLU and rotary positions). Cut: 4 of 28 layers, max_len 4096
# (of 32768), to stay in the script's time; f32 weights drawn on the card.
QWEN = dict(vocab=152064, layers=4, d_model=3584, heads=28, kv_heads=4,
            d_ff=18944, max_len=4096)
QWEN_PROMPT_LENS = (17, 100, 300, 700, 1200, 2000, 3000, 4000)

# the training model: GPT-2 medium widths in TransformerEncoder + Dense
TRAIN = dict(vocab_size=50257, units=1024, hidden_size=4096, num_heads=16,
             num_layers=24, max_length=1024)
TRAIN_BATCH = 8
TRAIN_WARMUP = 2
TRAIN_STEPS = 5
TRAIN_LR = 1e-4
GRAD_SLICE = 2          # sequences of the first batch in the gradient check

# tolerances, stated before the run. Kernels vs their plain versions:
# float32 sums taken in another order, |values| ~ 1, so 1e-4 absolute
# plus 1e-4 relative to the reference's largest magnitude (the flash
# backward's sums run over up to S = 4096 terms and stay inside it).
KERNEL_ATOL = 1e-4
KERNEL_RTOL = 1e-4
# training gradients on 2 sequences, per parameter tensor, in two checks:
# * backward only: kernels vs the forward kernel with the backward's plain
#   twin swapped in. The forward is bit-identical, so only the dQ and
#   dK/dV kernels differ: every tensor within BWD_GRAD_RTOL both
#   norm-wise (||g - g_ref|| / ||g_ref||) and element by element (of the
#   tensor's max |g_ref|): float32 sums in another order through 24
#   layers. Earlier runs on the H100 measured 4.2e-6 to 4.7e-6 here;
#   1e-4 leaves 20x room above that and still catches a dQ or dK/dV sum
#   off by a few 1e-4.
# * whole path: kernels vs the plain attention forward and backward (the
#   blocks' flash_attention swapped for reference_attention), every
#   tensor within PATH_GRAD_RTOL norm-wise. Looser, because ReLU's
#   derivative jumps at 0: an FFN pre-activation within rounding distance
#   of 0 lands on the other side in the other forward, which moves the
#   FFN's backward at that token by its whole contribution (up to ~1.3% of
#   a tensor's max |grad| at 2 x 1024 tokens) in ffn1 and the LayerNorm
#   before it, and attenuated upstream. Earlier runs on the H100 found all
#   25,316 elements beyond 1e-3 of their tensor's max (of 406 M) in ffn1
#   weights, and norm-wise errors up to 1.29e-3 (ffn1 weight) and 1.26e-3
#   (that LayerNorm's gamma). Their losses agree within LOSS_RTOL.
# The attention key biases are exempt from both: their true gradient is
# exactly 0 (softmax ignores the per-row shift q . b), so both paths hold
# rounding noise there; they are held below ZERO_GRAD_RTOL of the largest
# gradient of the model instead.
BWD_GRAD_RTOL = 1e-4
PATH_GRAD_RTOL = 1e-2
PATH_ELEM_RTOL = 1e-3   # only counts the elements beyond it, as a report
LOSS_RTOL = 1e-3
ZERO_GRAD_RTOL = 1e-4
# conv1x1 (bf16) vs reference_conv1x1 on the same inputs: y within one
# bf16 ulp of the reference plus CONV_ATOL_REL of its largest magnitude
# (the f32 sums run in another order before the rounding, so a sum near a
# rounding boundary lands on the other side); the statistics within
# CONV_STATS_RTOL of their largest magnitude (f32 sums of ~400 k terms in
# another order); float32 cases use the kernels' tolerance above. The
# stage-2 chain's second output takes its input through the first one's
# statistics, so it is held to one ulp plus CHAIN_ATOL_REL.
CONV_ATOL_REL = 1e-4
CONV_STATS_RTOL = 1e-3
CHAIN_ATOL_REL = 1e-3
# ResNet-50 (He et al. 2016, torchvision resnet50) stage 2 at batch 128
CONV_BATCH = 128
# the rtc kernels run over 2^26 float32 elements
RTC_N = 1 << 26
# engine logits vs full-context recompute through the plain path: 24
# layers of float32 rounding in another order (and, for int8, the same
# dequantized weights multiplied in another order), relative to the
# largest logit
LOGIT_RTOL = 1e-3

# cycles a second of torch.cuda._sleep's spin: above the H100's boost clock
# (1.98 GHz), so the spin outlasts the enqueue it covers
SPIN_HZ = 2e9

# the symbolic training path (Module.fit). ResNet-50 v1 at bench.py's
# flagship lane: batch 128, 224 x 224, float32, SGD lr 0.05 momentum 0.9
# rescale_grad 1 / 128, synthetic data from seed 0, 2 warm-up and 5 timed
# steps. LeNet as examples/train_mnist.py runs it: tanh LeNet (500 hidden
# units), its synthetic digits (n 2048, seed 0, 7/8 for training), batch
# 64, 8 epochs, lr 0.3, momentum 0.9, rescale_grad 1 / 64.
R50_BATCH = 128
R50_IMG = 224
R50_WARMUP = 2
R50_STEPS = 5
R50_LR = 0.05
R50_CHECK_BATCH = 2     # the card-against-CPU check's batch
LENET_N = 2048
LENET_BATCH = 64
LENET_EPOCHS = 8
LENET_LR = 0.3
LENET_BAR = 0.9         # examples/train_mnist.py's validation bar
LENET_CHECK_STEPS = 10  # steps held against the port on the CPU
# card against the port on the CPU from the same initial parameters: both
# float32 (the convolutions without TF32, the matmuls without TF32), so
# only the summation order differs (cuDNN / cuBLAS against oneDNN / MKL).
# LeNet after 10 SGD steps: every parameter within MODULE_RTOL of its
# tensor's largest magnitude. ResNet-50 at batch 2, one forward and
# backward from the same parameters, in two checks:
# * float64 on the card and on the CPU: every tensor (output, each
#   gradient, each moving statistic) within R50_F64_RTOL of its largest
#   magnitude (float64 sums in another order through 53 layers; cuDNN's
#   float64 kernels); this holds every op of the path on the card;
# * float32 on the card and on the CPU, each against the float64 step:
#   the output's error on the card within R50_F32_FACTOR times the CPU's
#   (plus R50_F32_FLOOR); the gradients' norm-wise errors, median and
#   largest over the tensors, within R50_F32_FACTOR times the CPU's. Not
#   tensor by tensor: at batch 2 a ReLU that lands on the other side of 0
#   in another summation order moves a whole BatchNorm channel of 98
#   values (2 x 7 x 7): two CPU runs (8 threads and 1) differ by up to
#   1.1% norm-wise and 9% of a tensor's largest element, and each lies up
#   to 2.6% norm-wise from the float64 step.
#   A whole step in TF32 must fail this rule: the script runs it (the
#   control: the port's per-call guard off, TF32 allowed in cuDNN and
#   cuBLAS) through the same check, and fails unless the check rejects
#   it. On an H100 the control's median norm-wise error read 34% against
#   the float32 step's 1.2% and the CPU's 0.68%. A TF32 convolution also
#   shows in the stem check against float64 (CONV_F64_RTOL).
MODULE_RTOL = 1e-4
R50_F64_RTOL = 1e-9
R50_F32_FACTOR = 4
R50_F32_FLOOR = 1e-6
# Gluon on the card (gluon_resnet50, gluon_cifar, gluon_lm_hybrid):
# ResNet-50 v1 from the model zoo at bench.py's flagship configuration
# (batch 128, 224 x 224, float32), hybridized, SoftmaxCrossEntropyLoss,
# Trainer("sgd", lr 0.05, momentum 0.9), record / backward / step(128):
# GLUON_R50_WARMUP steps, then GLUON_R50_STEPS timed. Beforehand one whole
# step at batch R50_CHECK_BATCH (the output, every gradient, the moving
# statistics and every parameter after the update) on the card against
# the port on the CPU from the same parameters: in float64
# (net.cast("float64")) within R50_F64_RTOL, and in float32 by
# module_resnet50's rule (_f32_rule), which the whole step in TF32 must
# fail. examples/gluon_cifar.py's program with its own arguments on the
# card: its accuracy bar (> 0.9) holds. The causal LM of
# examples/transformer_lm.py at GPT-2 medium's widths (TRAIN, GLM_LAYERS
# of its 24 layers), 8 x 1024 tokens, Adam, hybridized: GLM_WARMUP + GLM_STEPS
# steps, held against the same net not hybridized from the same
# parameters (losses, and every parameter after the steps norm-wise,
# within GLM_RTOL: the same kernels run on both); the flash kernels
# launched once each a layer a step, through _contrib_flash_attention.
GLUON_R50_WARMUP = 2
GLUON_R50_STEPS = 20
GLM_LAYERS = 24
GLM_WARMUP = 1
GLM_STEPS = 3
GLM_RTOL = 1e-5
CIFAR_BAR = 0.9         # examples/gluon_cifar.py's own bar
# Gluon's fused fit on the card (gluon_fused_resnet50, gluon_fused_lm):
# resnet50_v1 at bench.py's flagship configuration through
# gluon.trainer.fused_fit(steps_per_dispatch=GFUSED_K) over a
# gluon.data.DataLoader of an ArrayDataset (GFUSED_BATCHES batches of
# images from RandomState(SEED), GFUSED_EPOCHS epochs; img/s over the
# last, read in the fit's thread, then again with GFUSED_WORKERS thread
# workers reading ahead); beforehand, at batch GFUSED_CHECK_BATCH with
# cuDNN's deterministic algorithms, K = GFUSED_K against K = 1 (every
# parameter and aux state within GFUSED_STEPK_RTOL of its largest
# magnitude, and the epoch loss) and 2 fused steps against 2 steps of
# the hybridized Trainer loop (each tensor within GFUSED_LOOP_RTOL
# norm-wise). The LM
# (TRAIN, GLM_LAYERS layers) in one HybridSequential with Adam through
# fused_fit(steps_per_dispatch=GFLM_K), 2 epochs of GFLM_STEPS steps on
# the LM batch: the first GFLM_STEPS steps' losses within GFLM_RTOL of
# gluon_lm_hybrid's hybridized loop from the same parameters (the fused
# step's Adam correction is computed in float32 on the card), the flash
# kernels' launches a replay (GLM_LAYERS each) times the replays.
GFUSED_K = 4
GFUSED_BATCHES = 8
GFUSED_WORKERS = 4      # the second reading's thread workers
GFUSED_EPOCHS = 2
GFUSED_CHECK_BATCH = 8
GFUSED_STEPK_RTOL = 1e-6
GFUSED_LOOP_RTOL = 1e-5
GFLM_K = 2
GFLM_STEPS = 3
GFLM_RTOL = 1e-4
# device_feed: gluon_fused_resnet50's configuration fed by a source that
# sleeps one device step a batch (calibrated by a run of a free source),
# FEED_EPOCHS epochs (epoch 0 captures; rates over 1..N), feed off then on
FEED_EPOCHS = 3
FEED_MIN_HOST_S = 2e-3
# traced_lm: the watchdog's stall limit during the fit (it must not fire)
# and in the stalled-loop check; eager steps of the kernel lane's check
TRACE_FIT_STALL_S = 120.0
TRACE_STALL_S = 0.5
TRACE_EAGER_STEPS = 2
# the flight recorder's check: a small MLP fused_fit whose source raises
TRACE_MLP_BATCH = 64
# gluon_fused_lm_amp: the LM under amp.init("bfloat16"); its first 3
# losses against gluon_fused_lm's f32 ones (bf16 products over 24 layers)
AMP_DTYPE = "bfloat16"
AMP_LOSS_RTOL = 1e-2
# dp_resnet50_fp16: DataParallelTrainer(dtype="float16"), windows as
# dp_resnet50's bf16 lane
FP16_WINDOWS = 3
# ckpt_resume: the amp LM at CKPT_LM_LAYERS of its 24 layers, 2 epochs
# of CKPT_LM_BATCHES batches (K = GFLM_K), against 1 epoch, a commit, a
# fresh net and the resumed epoch; LeNet through Module.fit per batch,
# CKPT_LENET_EPOCHS against half of them and a resume; bench.py's
# checkpoint lane (bench.py:1129-1175): its MLP stepped CKPT_MLP_STEPS a
# window, CKPT_WINDOWS windows, a commit every CKPT_EVERY steps
CKPT_LM_LAYERS = 4
CKPT_LM_BATCHES = 4
CKPT_LENET_EPOCHS = 2
CKPT_MLP = dict(batch=256, dim=1024, hidden=512, classes=64)
CKPT_MLP_STEPS = 32
CKPT_EVERY = 8
CKPT_WINDOWS = 3

# the stem convolution (7 x 7 / 2, batch 2 at 224) through the registered
# op against float64: its output (sums of 147 products) within
# CONV_F64_RTOL and its weight gradient (sums of 2 x 112 x 112 products)
# within CONV_F64_DW_RTOL of their largest magnitude; TF32 products
# (10-bit mantissas) land near 1e-3, as the script's control (cuDNN with
# TF32 allowed) reports beside them
CONV_F64_RTOL = 1e-5
CONV_F64_DW_RTOL = 1e-4

# data-parallel training (parallel.DataParallelTrainer on
# data_parallel_mesh(1)): bench.py's _train_ips at its configuration
# (ResNet-50 v1 + SoftmaxOutput, batch 128, 224 x 224, SGD lr 0.05
# momentum 0.9 rescale_grad 1 / 128, init_state's draw, data from
# RandomState(0) as bench.py makes it), the step a CUDA graph: bf16 with
# fp32 masters through step_k(K=4) after one warm-up dispatch, 3 windows
# of 40 steps (median), then one window of 40 single steps; f32 through
# step_k(K=4), one window of 20 steps. Beforehand on the card: step_k
# against K steps from the same state at batch 8, with cuDNN's
# deterministic algorithms (losses and parameters within DP_STEPK_RTOL of
# each tensor's largest magnitude), and one bf16 and one f32 step against
# the port's eager step on the CPU at batch 2, each against the float64
# step on the CPU from the same parameters. The tensors compared: the
# output and each parameter's momentum after the step (-lr x rescale x
# its gradient, no cancellation against the weight); f32 also each
# moving statistic. f32, from He-normal parameters, by module_resnet50's
# rule (the card's errors within R50_F32_FACTOR times the CPU's). bf16
# from the trainer's own draw (init_state's N(0, 0.01), as bench.py
# trains): from He-normal parameters a bf16 step is no longer the step
# float64 takes (per-tensor cosine to float64 ~0.1 on the card and the
# CPU alike, at batches 2, 8 and 32: tools/torch_bf16_witness.py), from
# the trainer's draw it is (~0.94). The bf16 rule (_bf16_rule), each
# bound set from the H100's and the CPU's readings at batch 2 (card /
# CPU): the 10th percentile over the parameters of the momentum's cosine
# to float64's at least DP_BF16_COS_P10 (0.885 / 0.861); the median
# |log(||m|| / ||m64||)| at most DP_BF16_LOG_RATIO (0.026 / 0.027); the
# output's cross-entropy at the labels within DP_BF16_CE_RTOL of
# float64's (7.2e-5 / 7.2e-5); the median norm-wise error within
# DP_BF16_FACTOR times the CPU's (0.345 / 0.3455). The CPU's bf16 step
# must pass it, and four faults of the card's step must each fail it:
# the momenta zeroed, negated and doubled, and the step taken with the
# labels rolled by one sample (cosine p10 -0.15, norm-wise 0.478).
DP_K = 4
DP_WINDOW = 40
DP_WINDOWS = 3
DP_F32_STEPS = 20
DP_CHECK_BATCH = 8
DP_STEPK_RTOL = 1e-6
DP_BF16_COS_P10 = 0.5
DP_BF16_LOG_RATIO = 0.1
DP_BF16_CE_RTOL = 1e-3
DP_BF16_FACTOR = 1.25
# the fused fit: examples/train_mnist.py's LeNet through
# Module.fit(steps_per_dispatch=4) against steps_per_dispatch=1 on the
# card from the same initial parameters, one unshuffled epoch
# (parameters within FUSED_RTOL of each tensor's largest magnitude), then
# the example's 8 epochs fused
FUSED_K = 4
FUSED_RTOL = 1e-5
# recurrent networks (rnn_op, lstm_lm, lstm_bucketing). The RNN op of
# ops/rnn_ops.py in its four modes at RNN_CHECK (2 layers, one and two
# directions), f32 on the card and on the CPU, each against the same op
# on the CPU in float64: the outputs (y, h, c) and the gradients of
# random cotangents for data, parameters and both states, by
# module_resnet50's float32 rule (_f32_rule: the card's errors within
# R50_F32_FACTOR times the CPU's); the control, the card's op with each
# gate's recurrent block R transposed in layer 0, must fail it. At the
# lane's shape the op's forward + backward beside torch.nn.LSTM (cuDNN,
# a library call, not on any path) on the same weights, f32 and bf16.
# gluon.rnn.LSTM (the fused op) against LSTMCell.unroll with the same
# weights on the card (tests/test_gluon.py's check, GLUON_RNN_RTOL).
RNN_CHECK = dict(seq=16, batch=8, input=32, hidden=64, layers=2)
RNN_TIME_ITERS = 5
GLUON_RNN_RTOL = 1e-4
# bench.py's lstm_lm lane (bench.py:198-261) as written: Embedding ->
# TNC RNN (lstm) -> FullyConnected -> SoftmaxOutput, vocab 10000, hidden
# 512, 2 layers, batch 32, seq 64; DataParallelTrainer(dtype="bfloat16",
# sgd lr 0.1, rescale_grad 1 / (batch x seq)) on one card, states
# entering batch-major; step_k(K = 16, unroll = 2), 3 windows of 64
# steps (median tokens/s), then LSTM_SINGLE single steps. Beforehand:
# step_k against 16 steps from the same state (LSTM_STEPK_RTOL of each
# tensor's largest magnitude), and one f32 step at batch LSTM_CHECK_BATCH
# (with momentum 0.9, so each momentum is -lr x rescale x its gradient)
# on the card and on the CPU against the float64 step on the CPU by
# _f32_rule, which the card's step with the recurrent blocks of the RNN
# parameters' gradient zeroed must fail.
LSTM_LM = dict(vocab=10000, hidden=512, layers=2, batch=32, seq=64)
LSTM_K = 16
LSTM_UNROLL = 2
LSTM_WINDOW = 64
LSTM_WINDOWS = 3
LSTM_SINGLE = 10
LSTM_LR = 0.1
LSTM_CHECK_BATCH = 2
LSTM_STEPK_RTOL = 1e-6
# examples/lstm_bucketing.py's own bar: final train perplexity < 8.0
# (its exit code); its 3 buckets (6, 10, 14)
BUCKETS = 3
# BucketingModule at real widths beside the example: the defaults of
# MXNet's example/rnn/bucketing/lstm_bucketing.py (2 stacked LSTMCell
# layers of 200, embed 200, batch 32, buckets 10..60, SGD lr 0.01 wd
# 1e-5, Xavier(factor_type="in", magnitude=2.34), Perplexity(0)) at
# PTB's vocab of 10000, eager through BaseModule.fit as that example
# runs. PTB is not in the repo: BUCKET_LM["sentences"] synthetic
# sentences from SEED, lengths uniform on 2..60, words Zipf (s = 1) on
# 1..vocab-1 (0 pads). Epoch 1 binds a module a bucket; epoch 2 is
# timed: tokens/s counts the positions a batch computes (bucket x
# batch), samples/s as the example's Speedometer. Bar: a module for every
# bucket over one parameter buffer, finite parameters, the train
# perplexity after the epochs below the one before them, and one step a
# bucket on the card against the CPU (BUCKET_STEP_RTOL).
BUCKET_LM = dict(vocab=10000, hidden=200, embed=200, layers=2, batch=32,
                 buckets=(10, 20, 30, 40, 50, 60), sentences=3200,
                 epochs=2, lr=0.01, wd=1e-5)
# one training step a bucket on the card against the same step on the
# CPU from the same parameters and batches: each parameter within this of
# its tensor's largest magnitude
BUCKET_STEP_RTOL = 1e-5
# SSD300-VGG16 (ssd300_vgg16_symbol): MXNet's example/ssd at its
# published widths, VOC's 20 classes, batch 32 of 300 x 300 float32
# images, train.py's default optimizer (SGD lr 0.004, momentum 0.9, wd
# 5e-4, rescale_grad 1: the loss heads normalise by their valid count);
# SSD_DISTINCT synthetic batches from SEED (1..8 boxes an image) cycled
# over SSD_STEPS steps, img/s over steps SSD_TIMED_FROM.. (10 steps);
# SSD_WIDTH_DIV divides the widths only for a rehearsal on the CPU
SSD_BATCH = 32
SSD_IMG = 300
SSD_CLASSES = 20
SSD_MAX_BOXES = 8
SSD_WIDTH_DIV = 1
SSD_STEPS = 13
SSD_TIMED_FROM = 3
SSD_DISTINCT = 4
SSD_OPT = dict(learning_rate=0.004, momentum=0.9, wd=5e-4, rescale_grad=1.0)
SSD_NMS_TOPK = 400
SSD_CHECK_BATCH = 2      # the whole step's card-against-CPU check
SSD_OPS_RTOL = 1e-5      # loc targets and boxes, card against CPU
SSD_TIME_ITERS = 5

RECORD = {}
DEV = "cuda"


def _sync():
    import torch
    if DEV == "cuda":
        torch.cuda.synchronize()


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        out = "nvidia-smi unavailable: %s" % e
    return out.splitlines()[0] if out else "nvidia-smi: no output"


def bench_ms(fn, argsets, iters):
    """Mean device ms per call by CUDA events, cycling through ``argsets``
    so consecutive calls read different buffers (beyond the 50 MB L2 where
    the main path finds its inputs cold). A spin kernel (``_sleep``) ahead
    of the timed calls holds the card while the host enqueues them, so a
    call whose host side takes longer than its kernel is timed by its
    kernel, not by the host's launch rate."""
    import torch
    for a in argsets[:2]:
        fn(*a)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(*argsets[0])
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0        # an upper bound of one enqueue
    st = torch.cuda.Event(enable_timing=True)
    en = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(2e9, (1.5 * host_s * iters + 2e-4) * SPIN_HZ)))
    st.record()
    for i in range(iters):
        fn(*argsets[i % len(argsets)])
    en.record()
    en.synchronize()
    return st.elapsed_time(en) / iters


def copies(nbytes, *ts):
    """Enough clones of ``ts`` to pass 120 MB in all (at least one)."""
    n = max(1, math.ceil(120e6 / max(nbytes, 1)))
    return [ts] + [tuple(t.clone() for t in ts) for _ in range(n - 1)]


def bound_ms(nbytes, flops, peak_flops=PEAK_F32_FLOPS):
    tb = nbytes / PEAK_BYTES_PER_S * 1e3
    tf = flops / peak_flops * 1e3
    return max(tb, tf), ("bytes" if tb >= tf else "operations")


_FLOPS = {}


def step_flops(tag, sym, shapes, hand):
    """A training step's FLOPs (forward + backward) of ``sym`` at the
    input ``shapes``, from the port's cost source (telemetry.costs: the
    products counted exactly from the shapes), printed once beside the
    hand count ``hand`` it replaced (RECORD["flop_counts"])."""
    from mxnet_tpu_torch.telemetry import costs
    key = (tag, tuple(sorted(shapes.items())))
    if key not in _FLOPS:
        params = [a for a in sym.list_arguments() if a not in shapes]
        gc = costs.graph_costs(sym, shapes, sharded=tuple(shapes),
                               diff=params)
        got = gc.fwd_flops + gc.bwd_flops
        _FLOPS[key] = got
        rec = {"model": tag, "shapes": {k: list(v) for k, v in
                                        shapes.items()},
               "cost_source_flops": got, "hand_flops": hand,
               "ratio": got / hand, "unruled": sorted(set(gc.unruled))}
        RECORD.setdefault("flop_counts", []).append(rec)
        print("step FLOPs %s: cost source %.6e, hand count %.6e "
              "(ratio %.4f)" % (tag, got, hand, got / hand), flush=True)
    return _FLOPS[key]


def err_of(got, ref):
    import torch
    diff = (got.float() - ref.float()).abs()
    fin = torch.isfinite(ref)
    if not bool(torch.equal(torch.isfinite(got), fin)):
        return float("inf"), float("inf")
    e = float(diff[fin].max()) if bool(fin.any()) else 0.0
    scale = float(ref.float()[fin].abs().max()) if bool(fin.any()) else 0.0
    return e, KERNEL_ATOL + KERNEL_RTOL * scale


def launches_per_call(call, stem):
    """Kernel launches one ``call()`` makes, read from the counter that
    every launch site of ``csrc/<stem>.cu`` raises (``_build.launches``);
    for rtc (``stem`` None), whose kernels are a user's, from
    ``rtc.CudaKernel.launches``."""
    import torch
    from mxnet_tpu_torch import _build, rtc

    def count():
        return rtc.CudaKernel.launches if stem is None \
            else _build.launches(stem)
    n0 = count()
    call()
    torch.cuda.synchronize()
    return count() - n0


# -- symbols of the symbolic path (importable without a card) ----------------

def resnet_v1_symbol(sym, layers=(3, 4, 6, 3),
                     channels=(64, 256, 512, 1024, 2048), classes=1000,
                     prefix="resnetv10_"):
    """ResNet v1 with bottlenecks from the model zoo of the package whose
    ``mx.sym`` is ``sym`` (the port's, or the JAX package's for the parity
    tests): ``ResNetV1(BottleneckV1, layers, channels, classes)`` applied
    to ``Variable("data")``, under SoftmaxOutput, as bench.py builds its
    flagship. Defaults: ``resnet50_v1()``."""
    import importlib
    package = sym.__name__.rpartition(".")[0]
    zoo = importlib.import_module(package + ".gluon.model_zoo.vision.resnet")
    net = zoo.ResNetV1(zoo.BottleneckV1, list(layers), list(channels),
                       classes=classes, prefix=prefix)
    return sym.SoftmaxOutput(net(sym.Variable("data")), name="softmax")


def lenet_symbol(sym):
    """examples/train_mnist.py's LeNet (tanh, 500 hidden units)."""
    data = sym.Variable("data")
    net = sym.Convolution(data, kernel=(5, 5), num_filter=20, name="c1")
    net = sym.Activation(net, act_type="tanh")
    net = sym.Pooling(net, pool_type="max", kernel=(2, 2), stride=(2, 2))
    net = sym.Convolution(net, kernel=(5, 5), num_filter=50, name="c2")
    net = sym.Activation(net, act_type="tanh")
    net = sym.Pooling(net, pool_type="max", kernel=(2, 2), stride=(2, 2))
    net = sym.FullyConnected(sym.Flatten(net), num_hidden=500, name="f1")
    net = sym.Activation(net, act_type="tanh")
    net = sym.FullyConnected(net, num_hidden=10, name="f2")
    return sym.SoftmaxOutput(net, name="softmax")


SSD300 = dict(
    sizes=((.1, .141), (.2, .272), (.37, .447), (.54, .619), (.71, .79),
           (.88, .961)),
    ratios=((1, 2, .5),) + ((1, 2, .5, 3, 1. / 3),) * 3 + ((1, 2, .5),) * 2,
    steps=tuple(s / 300. for s in (8, 16, 32, 64, 100, 300)),
    extra=((512, 2, 1), (256, 2, 1), (256, 1, 0), (256, 1, 0)))


def ssd300_vgg16_symbol(sym, num_classes=20, width_div=1, nms_topk=400):
    """SSD300 on VGG16-reduced, as MXNet's example/ssd builds it
    (symbol/vgg16_reduced.py, symbol_factory.get_config("vgg16_reduced",
    300), symbol_builder.get_symbol_train), with the package whose
    ``mx.sym`` is ``sym``; ``width_div`` divides every convolution's
    width (1: the published widths). Backbone conv1-conv5 (3x3 pad 1 +
    ReLU; 2x2 stride-2 max pools after conv1-4, pool3 "full" so 75 ->
    38; pool5 3x3 stride 1 pad 1), fc6 a 3x3 convolution of 1024 at pad
    and dilation 6, fc7 1x1 of 1024; four extra layers (1x1 of half the
    width, then 3x3 at stride 2/2/1/1, pad 1/1/0/0); sources relu4_3
    (L2Normalization over channels times a learned (1, C, 1, 1) scale,
    init 20, __wd_mult__ 0.1), relu7 and the extra layers; 3x3 heads of
    A (C + 1) class and 4 A box filters; 8,732 anchors at 300². Outputs:
    SoftmaxOutput over the MultiBoxTarget classes, the valid-normalised
    smooth-L1 MakeLoss of the masked box error, the class targets
    (MakeLoss, grad_scale 0) and MultiBoxDetection on the trained outputs
    (MakeLoss, grad_scale 0)."""
    def conv(x, name, nf, kernel=3, pad=1, stride=1, dilate=1):
        x = sym.Convolution(x, kernel=(kernel, kernel), pad=(pad, pad),
                            stride=(stride, stride),
                            dilate=(dilate, dilate),
                            num_filter=max(1, nf // width_div), name=name)
        return sym.Activation(x, act_type="relu",
                              name="relu" + name[len("conv"):]
                              if name.startswith("conv") else name + "_relu")

    data = sym.Variable("data")
    label = sym.Variable("label")
    x = data
    for stage, (n, nf) in enumerate(((2, 64), (2, 128), (3, 256),
                                     (3, 512), (3, 512)), start=1):
        for i in range(1, n + 1):
            x = conv(x, "conv%d_%d" % (stage, i), nf)
        if stage == 4:
            relu4_3 = x
        if stage < 5:
            x = sym.Pooling(x, pool_type="max", kernel=(2, 2),
                            stride=(2, 2), name="pool%d" % stage,
                            pooling_convention="full" if stage == 3
                            else "valid")
        else:
            x = sym.Pooling(x, pool_type="max", kernel=(3, 3),
                            stride=(1, 1), pad=(1, 1), name="pool5")
    x = sym.Convolution(x, kernel=(3, 3), pad=(6, 6), dilate=(6, 6),
                        num_filter=1024 // width_div, name="fc6")
    x = sym.Activation(x, act_type="relu", name="relu6")
    x = sym.Convolution(x, kernel=(1, 1), num_filter=1024 // width_div,
                        name="fc7")
    relu7 = sym.Activation(x, act_type="relu", name="relu7")
    sources, x = [relu4_3, relu7], relu7
    for k, (nf, stride, pad) in enumerate(SSD300["extra"]):
        x = conv(x, "multi_feat_%d_conv_1x1" % (k + 2), nf // 2, kernel=1,
                 pad=0)
        x = conv(x, "multi_feat_%d_conv_3x3" % (k + 2), nf, stride=stride,
                 pad=pad)
        sources.append(x)
    import importlib
    init = importlib.import_module(sym.__name__.rpartition(".")[0]).init
    scale = sym.Variable("relu4_3_scale", shape=(1, 512 // width_div, 1, 1),
                         wd_mult=0.1, init=init.Constant(20))
    sources[0] = sym.broadcast_mul(
        sym.L2Normalization(sources[0], mode="channel",
                            name="relu4_3_norm"), scale)
    cls_layers, loc_layers, anchor_layers = [], [], []
    for k, src in enumerate(sources):
        sizes, ratios = SSD300["sizes"][k], SSD300["ratios"][k]
        na = len(sizes) - 1 + len(ratios)
        name = "src%d" % k
        loc = sym.Convolution(src, kernel=(3, 3), pad=(1, 1),
                              num_filter=4 * na, name=name + "_loc_pred_conv")
        loc_layers.append(sym.Flatten(sym.transpose(loc, axes=(0, 2, 3, 1))))
        cls = sym.Convolution(src, kernel=(3, 3), pad=(1, 1),
                              num_filter=na * (num_classes + 1),
                              name=name + "_cls_pred_conv")
        cls_layers.append(sym.Flatten(sym.transpose(cls, axes=(0, 2, 3, 1))))
        step = SSD300["steps"][k]
        anchor_layers.append(sym.Flatten(sym.contrib.MultiBoxPrior(
            src, sizes=sizes, ratios=ratios, clip=False, steps=(step, step),
            name=name + "_anchors")))
    loc_preds = sym.Concat(*loc_layers, dim=1, name="multibox_loc_pred")
    cls_preds = sym.transpose(sym.Reshape(
        sym.Concat(*cls_layers, dim=1), shape=(0, -1, num_classes + 1)),
        axes=(0, 2, 1), name="multibox_cls_pred")
    anchors = sym.Reshape(sym.Concat(*anchor_layers, dim=1),
                          shape=(0, -1, 4), name="multibox_anchors")
    tgt = sym.contrib.MultiBoxTarget(
        anchors, label, cls_preds, overlap_threshold=.5, ignore_label=-1,
        negative_mining_ratio=3, minimum_negative_samples=0,
        negative_mining_thresh=.5, variances=(.1, .1, .2, .2),
        name="multibox_target")
    cls_prob = sym.SoftmaxOutput(cls_preds, tgt[2], ignore_label=-1,
                                 use_ignore=True, grad_scale=1.,
                                 multi_output=True, normalization="valid",
                                 name="cls_prob")
    loc_loss = sym.MakeLoss(sym.smooth_l1(tgt[1] * (loc_preds - tgt[0]),
                                          scalar=1.0, name="loc_loss_"),
                            grad_scale=1., normalization="valid",
                            name="loc_loss")
    cls_label = sym.MakeLoss(tgt[2], grad_scale=0, name="cls_label")
    det = sym.contrib.MultiBoxDetection(
        cls_prob, loc_preds, anchors, nms_threshold=.45,
        force_suppress=False, variances=(.1, .1, .2, .2), nms_topk=nms_topk,
        name="detection")
    det = sym.MakeLoss(det, grad_scale=0, name="det_out")
    return sym.Group([cls_prob, loc_loss, cls_label, det])


def synthetic_detection(n, img=300, max_boxes=8, num_classes=20, seed=0):
    """Seeded images in [-1, 1] and 1..max_boxes ground-truth boxes an
    image (class, x1, y1, x2, y2 in [0, 1]; the rest -1 rows), as
    example/ssd's padded labels; no dataset is read. Box sides are
    uniform on 0.03..0.7 of the image (VOC's objects run from a few
    percent of it to most of it), so some boxes overlap no anchor by
    more than 0.5 and only the bipartite pass assigns them."""
    import numpy as np
    rng = np.random.RandomState(seed)
    x = rng.uniform(-1, 1, (n, 3, img, img)).astype(np.float32)
    y = -np.ones((n, max_boxes, 5), np.float32)
    for i in range(n):
        for j in range(rng.randint(1, max_boxes + 1)):
            w, h = rng.uniform(0.03, 0.7, 2)
            x1, y1 = rng.uniform(0, 1 - w), rng.uniform(0, 1 - h)
            y[i, j] = (rng.randint(num_classes), x1, y1, x1 + w, y1 + h)
    return x, y


def synthetic_mnist(n=2048, seed=0):
    """examples/train_mnist.py's separable synthetic digits (copied: the
    card's machine runs the port alone): class-dependent stripes."""
    import numpy as np
    rng = np.random.RandomState(seed)
    y = rng.randint(0, 10, n)
    x = rng.normal(0, 0.3, (n, 1, 28, 28)).astype(np.float32)
    for i in range(n):
        x[i, 0, (y[i] * 2 + 2) % 26] += 2.0     # class-indexed bright row
        x[i, 0, :, (y[i] + 3) % 26] += 1.0
    return x, y.astype(np.float32)


# -- phases -------------------------------------------------------------------

def phase_device():
    import torch
    smi = nvidia_smi()
    print(smi, flush=True)
    RECORD["nvidia_smi"] = smi
    return {"name": torch.cuda.get_device_name(0), "nvidia_smi": smi,
            "count": torch.cuda.device_count(), "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32}


def phase_build():
    from mxnet_tpu_torch import _build
    t0 = time.perf_counter()
    _build.library("flash_attention")
    secs = time.perf_counter() - t0
    info = dict(_build.last_build)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "build_log.txt"), "w") as f:
        for stem, log in info.get("logs", {}).items():
            f.write("== %s\n%s\n" % (stem, log))
    spills, regs = [], {}
    for stem, log in info.get("logs", {}).items():
        fn = "?"
        for ln in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", ln)
            if m:
                fn = m.group(1)
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", ln)
            if m and (int(m.group(1)) or int(m.group(2))):
                spills.append("%s %s: %s" % (stem, fn, ln.strip()))
            m = re.search(r"Used (\d+) registers", ln)
            if m:
                regs[stem] = max(regs.get(stem, 0), int(m.group(1)))
    res = {"build_seconds": secs, "built": info.get("built"),
           "max_registers": regs, "spills": spills}
    if spills:
        raise AssertionError("ptxas spilled: %s" % spills[:8])
    return res


def _max_rule_ulps(got, ref):
    """The tensor-wide rule the element check replaced: max |got - ref| in
    ulps of max |ref|. Kept for the controls' record only."""
    import torch
    r = ref.float()
    m = float(r.abs().max())
    return float((got.float() - r).abs().max()) / (
        2.0 ** math.floor(math.log2(m)) * torch.finfo(got.dtype).eps)


def _held(got, ref, terms=None):
    """(error, its tolerance, ok): float32 outputs by err_of, bf16/f16 by
    half_units (``terms``: the root-sum-squares of their terms) against
    HALF_ULPS."""
    import torch
    from mxnet_tpu_torch import test_utils as U
    if got.dtype == torch.float32:
        e, tol = err_of(got, ref)
        return e, tol, e <= tol
    u = U.half_units(got, ref, terms)
    return u, "%d units of ulp(|ref|) + ulp(rss of its terms)" \
        % HALF_ULPS, u <= HALF_ULPS


def _control(ctrl, ref, terms):
    """A control's record: its error by the check (it must fail) and by
    the tensor-wide rule that the check replaced."""
    from mxnet_tpu_torch import test_utils as U
    return {"units": U.half_units(ctrl, ref, terms),
            "max_rule_ulps": _max_rule_ulps(ctrl, ref)}


def _tc_bound(io_bytes, flops, dt):
    """A flash kernel's bound at the tensor cores' peak for its inputs (3
    TF32 products for f32, the forward's and dQ's design; one bf16/f16
    product), and the FP32 pipes' bound."""
    if dt == "f32":
        design = bound_ms(io_bytes, TF32_PIECES * flops, PEAK_TF32_FLOPS)
    else:
        design = bound_ms(io_bytes, flops, PEAK_BF16_FLOPS)
    return design, bound_ms(io_bytes, flops)[0]


def _flash_case(name, b, h, hkv, s, d, causal, gen, dt="f32"):
    import torch
    import torch.nn.functional as F
    from mxnet_tpu_torch import test_utils as U
    from mxnet_tpu_torch.ops import attention as A
    dev = "cuda"
    tdt = DTYPES[dt]
    q = torch.randn(b, h, s, d, generator=gen, device=dev).to(tdt)
    k = torch.randn(b, hkv, s, d, generator=gen, device=dev).to(tdt)
    v = torch.randn(b, hkv, s, d, generator=gen, device=dev).to(tdt)
    n0, dense0 = A.flash_attention_fwd.launches, A.dense_attention.calls
    out, lse = A.flash_attention_fwd(q, k, v, causal=causal)
    launched = (A.flash_attention_fwd.launches - n0,
                A.dense_attention.calls - dense0)
    again = A.flash_attention_fwd(q, k, v, causal=causal)
    rout, rlse = A.reference_attention_with_lse(q, k, v, causal=causal)
    torch.cuda.synchronize()
    deterministic = bool(torch.equal(out, again[0]) and
                         torch.equal(lse, again[1]))
    control = terms = None
    if dt != "f32":
        terms = U.attention_term_scales(q, k, v, causal)[0]
        ctrl = U.attention_without_keys(q, k, v, s // 2, s // 2 + DROP_KEYS,
                                        causal)[0]
        control = _control(ctrl, rout, terms)
        del ctrl
    e_o, tol_o, ok_o = _held(out, rout, terms)
    e_l, tol_l = err_of(lse, rlse)
    del terms
    ok_o = ok_o and (control is None or control["units"] > HALF_ULPS)
    per_call = launches_per_call(
        lambda: A.flash_attention_fwd(q, k, v, causal=causal),
        "flash_attention")
    esz = q.element_size()
    io_bytes = esz * (2 * q.numel() + k.numel() + v.numel()) \
        + 4 * lse.numel()
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = 4 * b * h * d * pairs
    sets = copies(io_bytes, q, k, v)
    iters = 20
    ms = bench_ms(lambda q, k, v: A.flash_attention_fwd(q, k, v, causal),
                  sets, iters)
    plain = bench_ms(lambda q, k, v: A.reference_attention_with_lse(
        q, k, v, causal), sets, iters)
    gqa = {"enable_gqa": True} if hkv != h else {}
    lib = bench_ms(lambda q, k, v: F.scaled_dot_product_attention(
        q, k, v, is_causal=causal, **gqa), sets, iters)
    (bnd, by), b_f32 = _tc_bound(io_bytes, flops, dt)
    return {"kernel": "flash_attention_fwd", "case": name, "dtype": dt,
            "held_in_ulps": dt != "f32",
            "shape": [b, h, hkv, s, d], "causal": causal,
            "max_abs_err": max(float((out.float() - rout.float()).abs()
                                     .max()), e_l),
            "err_out": e_o, "err_lse": e_l,
            "tol_out": tol_o, "tol_lse": tol_l,
            "control_dropped_keys": control,
            "launches_and_dense_calls": launched,
            "kernel_launches_per_call": per_call,
            "deterministic": deterministic,
            "ok": ok_o and e_l <= tol_l and launched == (1, 0)
            and deterministic and per_call == 1,
            "kernel_ms": ms, "plain_ms": plain, "library_ms": lib,
            "library_note": "SDPA in %s" % dt,
            "bound_ms": bnd, "bound_by": by, "bound_f32_pipes_ms": b_f32,
            "bytes": io_bytes, "flops": flops}


def _flash_bwd_case(name, b, h, hkv, s, d, causal, gen, glse=False,
                    plain_batch=None, iters=10, dt="f32"):
    """dQ and dK/dV kernels against the plain twin (on the first
    ``plain_batch`` sequences when the dense (S, S) matrices would not
    fit), timed beside the twin and SDPA's backward through autograd."""
    import torch
    import torch.nn.functional as F
    from mxnet_tpu_torch import test_utils as U
    from mxnet_tpu_torch.ops import attention as A
    dev = "cuda"
    tdt = DTYPES[dt]
    q = torch.randn(b, h, s, d, generator=gen, device=dev).to(tdt)
    k = torch.randn(b, hkv, s, d, generator=gen, device=dev).to(tdt)
    v = torch.randn(b, hkv, s, d, generator=gen, device=dev).to(tdt)
    do = torch.randn(b, h, s, d, generator=gen, device=dev).to(tdt)
    gl = torch.randn(b, h, s, generator=gen, device=dev) if glse else None
    o, lse = A.flash_attention_fwd(q, k, v, causal=causal)
    dq = A.flash_attention_bwd_dq(q, k, v, o, lse, do, gl, causal)
    dkp, dvp = A.flash_attention_bwd_dkv(q, k, v, o, lse, do, gl, causal)
    again = A.flash_attention_bwd(q, k, v, o, lse, do, gl, causal)
    torch.cuda.synchronize()
    if hkv != h:
        dkp = dkp.reshape(b, hkv, h // hkv, s, d).sum(2)
        dvp = dvp.reshape(b, hkv, h // hkv, s, d).sum(2)
    dk, dv = dkp.to(tdt), dvp.to(tdt)
    deterministic = bool(torch.equal(dq, again[0]) and
                         torch.equal(dk, again[1]) and
                         torch.equal(dv, again[2]))
    pb = plain_batch or b
    sl = slice(0, pb)
    ref = A.reference_flash_attention_bwd(
        q[sl], k[sl], v[sl], o[sl], lse[sl], do[sl],
        None if gl is None else gl[sl], causal)
    torch.cuda.synchronize()
    abs_err = max(float((got[sl].float() - r.float()).abs().max())
                  for got, r in zip((dq, dk, dv), ref))
    control, terms = None, (None,) * 3
    if dt != "f32":
        gsl = None if gl is None else gl[sl]
        terms = U.attention_term_scales(q[sl], k[sl], v[sl], causal,
                                        o=o[sl], do=do[sl], glse=gsl)[1:]
        ctrl = U.attention_without_keys(q[sl], k[sl], v[sl], s // 2,
                                        s // 2 + DROP_KEYS, causal,
                                        do=do[sl], glse=gsl)[1:]
        control = [_control(c, r, t) for c, r, t in zip(ctrl, ref, terms)]
        del ctrl
    held = [_held(got[sl], r, t) for got, r, t in zip((dq, dk, dv), ref,
                                                       terms)]
    del ref, terms
    dq_per_call = launches_per_call(lambda: A.flash_attention_bwd_dq(
        q, k, v, o, lse, do, gl, causal), "flash_attention_bwd")
    dkv_per_call = launches_per_call(lambda: A.flash_attention_bwd_dkv(
        q, k, v, o, lse, do, gl, causal), "flash_attention_bwd")
    pairs = s * (s + 1) // 2 if causal else s * s
    esz = q.element_size()
    n_in = esz * (3 * q.numel() + k.numel() + v.numel()) + 4 * (
        lse.numel() + (gl.numel() if gl is not None else 0))
    dq_bytes = n_in + esz * q.numel()
    dkv_bytes = n_in + 4 * 2 * q.numel()          # f32 per-q-head partials
    dq_flops = 6 * d * pairs * b * h
    dkv_flops = 8 * d * pairs * b * h
    sets = copies(n_in, q, k, v, o, lse, do)
    if len(sets) > 3:
        sets = sets[:3]
    dq_ms = bench_ms(lambda q, k, v, o, l, g: A.flash_attention_bwd_dq(
        q, k, v, o, l, g, gl, causal), sets, iters)
    dkv_ms = bench_ms(lambda q, k, v, o, l, g: A.flash_attention_bwd_dkv(
        q, k, v, o, l, g, gl, causal), sets, iters)
    psets = [tuple(t[sl] for t in a) for a in sets[:1]]
    plain = bench_ms(lambda q, k, v, o, l, g: A.reference_flash_attention_bwd(
        q, k, v, o, l, g, None if gl is None else gl[sl], causal), psets,
        max(2, iters // 4)) * b / pb
    # library: the backward of SDPA (recorded once, replayed with
    # retain_graph), the same dq/dk/dv of the same inputs without glse
    ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))
    gqa = {"enable_gqa": True} if hkv != h else {}
    lo = F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal, **gqa)
    lib = bench_ms(lambda g: torch.autograd.grad(
        lo, (ql, kl, vl), g, retain_graph=True), [(do,)], iters)
    del lo, ql, kl, vl
    (b_dq, by_dq), b_dq_f32 = _tc_bound(dq_bytes, dq_flops, dt)
    # dK/dV does its math on the FP32 pipes, but the card could do the
    # same work at the forward's and dQ's rates: its bound is theirs
    (b_dkv, by_dkv), b_dkv_f32 = _tc_bound(dkv_bytes, dkv_flops, dt)
    ok = all(h_[2] for h_ in held) and deterministic and (
        control is None or all(c["units"] > HALF_ULPS for c in control)) \
        and dq_per_call == dkv_per_call == 1
    return {"kernel": "flash_attention_bwd", "case": name, "dtype": dt,
            "held_in_ulps": dt != "f32",
            "shape": [b, h, hkv, s, d], "causal": causal, "glse": glse,
            "plain_batch": pb, "err_dq": held[0][0], "err_dk": held[1][0],
            "err_dv": held[2][0], "tols": [t for _, t, _ in held],
            "control_dropped_keys": control,
            "max_abs_err": abs_err,
            "dq_kernel_launches_per_call": dq_per_call,
            "dkv_kernel_launches_per_call": dkv_per_call,
            "deterministic": deterministic, "ok": ok,
            "dq_ms": dq_ms, "dkv_ms": dkv_ms, "kernel_ms": dq_ms + dkv_ms,
            "plain_ms": plain, "plain_note": "the plain twin computes dq, "
            "dk and dv together" + (
                "; timed on %d of %d sequences, scaled" % (pb, b)
                if pb != b else ""),
            "library_ms": lib, "library_note": "SDPA backward in %s "
            "through autograd (dq, dk, dv together)" % dt,
            "dq_bound_ms": b_dq, "dq_bound_by": by_dq,
            "dq_bound_f32_pipes_ms": b_dq_f32,
            "dkv_bound_ms": b_dkv, "dkv_bound_by": by_dkv,
            "dkv_bound_f32_pipes_ms": b_dkv_f32,
            "bound_ms": b_dq + b_dkv,
            "bound_by": by_dq if by_dq == by_dkv else "mixed",
            "dq_bytes": dq_bytes, "dkv_bytes": dkv_bytes,
            "dq_flops": dq_flops, "dkv_flops": dkv_flops}


def _decode_case(name, b, h, hkv, s, d, lengths, gen, dt="f32"):
    import torch
    import torch.nn.functional as F
    from mxnet_tpu_torch import test_utils as U
    from mxnet_tpu_torch.ops import attention as A
    dev = "cuda"
    tdt = DTYPES[dt]
    q = torch.randn(b, h, d, generator=gen, device=dev).to(tdt)
    k = torch.randn(b, hkv, s, d, generator=gen, device=dev).to(tdt)
    v = torch.randn(b, hkv, s, d, generator=gen, device=dev).to(tdt)
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    n0, dense0 = A.decode_attention.launches, A.dense_attention.calls
    out = A.decode_attention(q, k, v, ln)
    launched = (A.decode_attention.launches - n0,
                A.dense_attention.calls - dense0)
    again = A.decode_attention(q, k, v, ln)
    ref = A.reference_decode_attention(q, k, v, ln)
    torch.cuda.synchronize()
    deterministic = bool(torch.equal(out, again))
    tiles, splits, chunk = A.decode_plan(
        b, h, hkv, s, torch.cuda.get_device_properties(0)
        .multi_processor_count)
    e, tol, ok = _held(out, ref, None if dt == "f32" else
                       U.decode_term_scales(q, k, v, ln))
    per_call = launches_per_call(lambda: A.decode_attention(q, k, v, ln),
                                 "decode_attention")
    tot = int(sum(lengths))
    esz = q.element_size()
    io_bytes = esz * (2 * q.numel() + 2 * hkv * d * tot) + 4 * b
    flops = 4 * h * d * tot
    pool_bytes = esz * (k.numel() + v.numel())
    sets = copies(pool_bytes, q, k, v)
    mask = (torch.arange(s, device=dev)[None, :] < ln[:, None])
    mask = mask[:, None, None, :]
    gqa = {"enable_gqa": True} if hkv != h else {}

    def lib_fn(q, k, v):
        return F.scaled_dot_product_attention(
            q[:, :, None], k, v, attn_mask=mask, **gqa)

    iters = 50
    ms = bench_ms(lambda q, k, v: A.decode_attention(q, k, v, ln), sets,
                  iters)
    plain = bench_ms(lambda q, k, v: A.reference_decode_attention(
        q, k, v, ln), sets, iters)
    lib = bench_ms(lib_fn, sets, iters)
    bnd, by = bound_ms(io_bytes, flops)
    return {"kernel": "decode_attention", "case": name, "dtype": dt,
            "held_in_ulps": dt != "f32",
            "shape": [b, h, hkv, s, d], "lengths": list(lengths),
            "group": h // hkv, "launches_and_dense_calls": launched,
            "splits": splits, "chunk": chunk, "head_tiles": tiles,
            "kernel_launches_per_call": per_call,
            "deterministic": deterministic,
            "max_abs_err": float((out.float() - ref.float()).abs().max()),
            "err": e, "tol": tol,
            "ok": ok and launched == (1, 0) and deterministic
            and per_call == 1,
            "kernel_ms": ms, "plain_ms": plain, "library_ms": lib,
            "bound_ms": bnd, "bound_by": by, "bytes": io_bytes,
            "flops": flops}


def _qmm_case(name, m, kdim, n, dtype, gen, xdt="f32"):
    """The quantized matmul against its plain version (float32 x: the
    kernels' tolerance; bfloat16 / float16 x: one ulp of x's type plus
    1e-4 of the largest magnitude), the same bits on a second call, timed
    beside the plain
    version and torch.matmul on the wide weight. float32 x is also held
    against float64 (_qmm_f64_ratio). Both kernels run QMM_PIECES bf16
    tensor-core products, which set the bound's operations (the FP32
    pipes' bound is kept beside)."""
    import torch
    from mxnet_tpu_torch.ops import quantization as Q
    dev = "cuda"
    x = torch.randn(m, kdim, generator=gen, device=dev).to(DTYPES[xdt])
    w = torch.randn(kdim, n, generator=gen, device=dev) / math.sqrt(kdim)
    q, sc = Q.quantize_rows(w, dtype)
    del w
    out = Q.quantized_matmul(x, q, sc)
    again = Q.quantized_matmul(x, q, sc)
    ref = Q.reference_quantized_matmul(x, q, sc)
    torch.cuda.synchronize()
    deterministic = bool(torch.equal(out, again))
    route = "qmm_tc" if Q._qmm_route(x, q, out) == 1 else "qmm_small"
    e, tol = err_of(out, ref)
    f64 = None
    if xdt != "f32":
        ulps = _half_ulp_err(out, ref, KERNEL_RTOL)
        ok, tol_s = ulps <= 1.0, "one ulp of x's type + %g of max |ref|" \
            % KERNEL_RTOL
    else:
        # and against float64 within the exact-products bound
        f64 = _qmm_f64_ratio(out, x, q, sc)
        ulps, ok, tol_s = None, e <= tol and f64 <= 1.0, tol
    per_call = launches_per_call(lambda: Q.quantized_matmul(x, q, sc),
                                 "quantized_matmul")
    io_bytes = x.element_size() * (m * kdim + m * n) \
        + q.numel() * q.element_size() + 4 * n
    flops = 2 * m * n * kdim
    sets = copies(q.numel() * q.element_size(), x, q, sc)
    wide = [(a[0], Q.dequantize_rows(a[1], a[2]).to(x.dtype))
            for a in sets[:2]]
    iters = 20
    ms = bench_ms(Q.quantized_matmul, sets, iters)
    plain = bench_ms(Q.reference_quantized_matmul, sets, iters)
    lib = bench_ms(torch.matmul, wide, iters)
    b_f32, _ = bound_ms(io_bytes, flops)
    bnd, by = bound_ms(io_bytes, QMM_PIECES[xdt] * flops, PEAK_BF16_FLOPS)
    return {"kernel": "quantized_matmul", "case": name, "dtype": dtype,
            "x_dtype": xdt, "route": route,
            "shape": [m, kdim, n], "max_abs_err": e, "tol": tol_s,
            "err_half_ulps": ulps, "f64_err_over_bound": f64,
            "deterministic": deterministic,
            "kernel_launches_per_call": per_call,
            "ok": ok and deterministic and per_call == 1,
            "kernel_ms": ms, "plain_ms": plain,
            "library_ms": lib, "library_note": "torch.matmul on the "
            "pre-dequantized weight in x's dtype (2 copies rotated)",
            "bound_ms": bnd, "bound_by": by, "bound_f32_pipes_ms": b_f32,
            "bytes": io_bytes, "flops": flops}


def _qmm_f64_ratio(out, x, q, sc):
    """The largest |out - x @ q * scale| in float64 over the bound that
    float32 sums of exact products keep in any order: 4 K units of 2^-24
    of sum |x| |q| * scale (QMM_F64_ULPS)."""
    def f64(a, b):
        return (a.double() @ b.double()) * sc.double()
    bound = QMM_F64_ULPS * x.shape[1] * 2.0 ** -24 * f64(x.abs(),
                                                          q.float().abs())
    return float(((out.double() - f64(x, q)).abs() / bound).nan_to_num(
        0.0, posinf=float("inf")).max())


def _qmm_pieces_case(name, m, kdim, n, dtype, gen):
    """Both quantized-matmul kernels form exact products: float32 x spans
    1e-20 to 1e20, so one term rules each short sum, and the result stays
    within the float64 bound of _qmm_f64_ratio, which x without its third
    bf16 piece, x as one bf16 value and x rounded to TF32 (emulated in
    torch on the same inputs) all break."""
    import torch
    from mxnet_tpu_torch.ops import quantization as Q
    dev = "cuda"
    mag = 10.0 ** (torch.rand(m, kdim, generator=gen, device=dev) * 40 - 20)
    x = (torch.randn(m, kdim, generator=gen, device=dev).sign() * mag).float()
    q, sc = Q.quantize_rows(torch.randn(kdim, n, generator=gen, device=dev),
                            dtype)
    out = Q.quantized_matmul(x, q, sc)
    route = Q._qmm_route(x, q, out)
    hi = x.bfloat16().float()
    mid = (x - hi).bfloat16().float()
    tf32 = ((x.view(torch.int32) + 0x1000) & ~0x1fff).view(torch.float32)
    controls = {}
    for cname, xw in (("two_pieces", hi + mid), ("one_piece", hi),
                      ("tf32", tf32)):
        ref = ((xw.double() @ q.double()) * sc.double()).float()
        controls[cname] = _qmm_f64_ratio(ref, x, q, sc)
    ratio = _qmm_f64_ratio(out, x, q, sc)
    return {"kernel": "quantized_matmul_exact", "case": name,
            "dtype": dtype, "shape": [m, kdim, n],
            "route": "qmm_tc" if route == 1 else "qmm_small",
            "err_over_bound": ratio, "controls_err_over_bound": controls,
            "ok": ratio <= 1.0 and all(v > 1.0 for v in controls.values())}


def _dense_case(name, d, gen, s_q=512):
    """A head dim no kernel takes (96), or one above the kernels' 512
    (640), through flash_attention with its backward and through
    decode_attention; or cross-attention (``s_q`` query rows against 512
    keys, causal from the bottom right) through flash_attention alone:
    the dense route's answer, and no kernel launch."""
    import torch
    from mxnet_tpu_torch.ops import attention as A
    dev = "cuda"
    q = torch.randn(2, 8, s_q, d, generator=gen, device=dev).requires_grad_()
    k, v = (torch.randn(2, 8, 512, d, generator=gen, device=dev)
            .requires_grad_() for _ in range(2))
    do = torch.randn(2, 8, s_q, d, generator=gen, device=dev)
    ln = torch.tensor([1, 512], dtype=torch.int32, device=dev)
    decode = not A.kernel_head_dim(d) or d > A.MAX_HEAD_DIM
    kernels = {n: f.launches for n, f in _wrappers().items()}
    calls = A.dense_attention.calls
    out = A.flash_attention(q, k, v, causal=True)
    out.backward(do)
    if decode:
        dec = A.decode_attention(q[:, :, -1].detach(), k.detach(),
                                 v.detach(), ln)
    torch.cuda.synchronize()
    after = {n: f.launches for n, f in _wrappers().items()}
    q2, k2, v2 = (t.detach().clone().requires_grad_() for t in (q, k, v))
    ref = A.reference_attention(q2, k2, v2, causal=True)
    ref.backward(do)
    pairs = [(out, ref), (q.grad, q2.grad), (k.grad, k2.grad),
             (v.grad, v2.grad)]
    if decode:
        pairs.append((dec, A.reference_decode_attention(
            q2[:, :, -1].detach(), k2.detach(), v2.detach(), ln)))
    errs = [err_of(a.detach(), b.detach()) for a, b in pairs]
    finite = all(bool(torch.isfinite(t.grad).all()) for t in (q, k, v))
    dense = A.dense_attention.calls - calls
    return {"kernel": "dense_attention", "case": name,
            "shape": [2, 8, 8, s_q, 512, d], "dense_calls": dense,
            "kernel_launches": {n: after[n] - kernels[n] for n in after},
            "max_abs_err": max(e for e, _ in errs), "finite_grads": finite,
            "ok": dense == 1 + decode and after == kernels and finite
            and all(e <= t for e, t in errs)}


def _flash_exact_case(name, b, h, s, d, gen):
    """The f32 flash forward (``exact_flash_fwd_f32``) or dQ
    (``exact_flash_dq_f32``) against float64: its largest error within
    F64_FACTOR times the plain f32 version's own, while one TF32 pass (the
    same formulas on tf32-rounded q, k, v, P and dS, in float64; the
    control) must exceed that bound."""
    import torch
    from mxnet_tpu_torch.ops import attention as A
    dev = "cuda"
    q, k, v, do = (torch.randn(b, h, s, d, generator=gen, device=dev)
                   for _ in range(4))
    out, lse = A.flash_attention_fwd(q, k, v, causal=True)
    mask = torch.ones(s, s, dtype=torch.bool, device=dev).tril()

    def f64(rnd):
        sc = rnd(q) @ rnd(k).transpose(-1, -2) / math.sqrt(d)
        sc = sc.masked_fill(~mask, float("-inf"))
        p = torch.exp(sc - torch.logsumexp(sc, -1, keepdim=True))
        o = rnd(p) @ rnd(v)
        if name.startswith("exact_flash_fwd"):
            return o
        dp = rnd(do) @ rnd(v).transpose(-1, -2)
        ds = p * (dp - (do.double() * o).sum(-1, keepdim=True)) \
            / math.sqrt(d)
        return rnd(ds) @ rnd(k)

    def exact(x):
        return x.double()

    def one_tf32(x):
        x = x.float()
        return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(
            torch.float32).double()

    if name.startswith("exact_flash_fwd"):
        got = out
        plain = A.reference_attention_with_lse(q, k, v, causal=True)[0]
    else:
        got = A.flash_attention_bwd_dq(q, k, v, out, lse, do, causal=True)
        plain = A.reference_flash_attention_bwd(q, k, v, out, lse, do,
                                                causal=True)[0]
    ref = f64(exact)
    bound = F64_FACTOR * float((plain.double() - ref).abs().max())
    ratio = float((got.double() - ref).abs().max()) / bound
    control = float((f64(one_tf32) - ref).abs().max()) / bound
    return {"kernel": "flash_attention_exact", "case": name,
            "shape": [b, h, h, s, d], "err_over_bound": ratio,
            "control_one_tf32_err_over_bound": control,
            "bound": "%d x the plain f32 version's float64 error (%g)"
                     % (F64_FACTOR, bound),
            "ok": ratio <= 1.0 and control > 1.0}


def _decode_exact_case(name, b, h, hkv, s, d, lengths, gen):
    """The f32 decode kernel (``exact_decode_f32_*``) against float64: its
    largest error within F64_FACTOR times the plain f32 version's own,
    while one TF32 pass (q, k, P and v rounded to TF32, the same formulas
    in float64; the control) must exceed that bound."""
    import torch
    from mxnet_tpu_torch.ops import attention as A
    dev = "cuda"
    q = torch.randn(b, h, d, generator=gen, device=dev)
    k = torch.randn(b, hkv, s, d, generator=gen, device=dev)
    v = torch.randn(b, hkv, s, d, generator=gen, device=dev)
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    got = A.decode_attention(q, k, v, ln)
    plain = A.reference_decode_attention(q, k, v, ln)
    kk, vv = (t.repeat_interleave(h // hkv, dim=1) for t in (k, v))
    valid = torch.arange(s, device=dev)[None, None, :] < ln[:, None, None]

    def f64(rnd):
        sc = torch.einsum("bhd,bhsd->bhs", rnd(q), rnd(kk)) / math.sqrt(d)
        p = torch.softmax(sc.masked_fill(~valid, float("-inf")), -1)
        return torch.einsum("bhs,bhsd->bhd", rnd(p), rnd(vv))

    def one_tf32(x):
        x = x.float()
        return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(
            torch.float32).double()

    ref = f64(lambda x: x.double())
    bound = F64_FACTOR * float((plain.double() - ref).abs().max())
    ratio = float((got.double() - ref).abs().max()) / bound
    control = float((f64(one_tf32) - ref).abs().max()) / bound
    return {"kernel": "decode_attention_exact", "case": name,
            "shape": [b, h, hkv, s, d], "lengths": list(lengths),
            "err_over_bound": ratio,
            "control_one_tf32_err_over_bound": control,
            "bound": "%d x the plain f32 version's float64 error (%g)"
                     % (F64_FACTOR, bound),
            "ok": ratio <= 1.0 and control > 1.0}


def _half_ulp_err(got, ref, atol_rel):
    """Largest |got - ref| in units of (one ulp of ref in got's type,
    bfloat16 or float16, + atol_rel of max |ref|): <= 1 passes."""
    import torch
    r = ref.float()
    _, e = torch.frexp(r)
    tol = torch.ldexp(torch.full_like(r, torch.finfo(got.dtype).eps),
                      e - 1) + atol_rel * float(r.abs().max())
    return float(((got.float() - r).abs() / tol).max())


def _stats_err(got, ref):
    return max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
               for a, b in zip(got, ref))


def _conv_pieces(xdt, wdt):
    """Tensor-core products conv1x1 takes for an (x, w) pair: the product
    of each side's exact pieces in the mma's type (f16 when both sides
    are f16, else bf16): one for that type, two for f16 under bf16, three
    for f32; None for f32 x f32 (the FMA kernel)."""
    if xdt == wdt == "f32":
        return None
    n = {"f32": 3, "bf16": 1, "f16": 1 if xdt == wdt else 2}
    return n[xdt] * n[wdt]


def _conv_case(name, n, ci, co, p, dtype, gen, residual=False, wdtype=None):
    """conv1x1 with the relu(bn(x)) prologue (and a residual in x's type)
    plus statistics against reference_conv1x1 on the card; timed beside
    the plain twin and a library chain (the prologue in torch ops,
    torch.matmul in the pair's common type, two reductions); y and the
    statistics checked bit-identical on a second run."""
    import torch
    from mxnet_tpu_torch.ops import conv_fused as C
    dev = "cuda"
    wdtype = wdtype or dtype
    dt, wdt = DTYPES[dtype], DTYPES[wdtype]
    x = torch.randn(n, ci, p, generator=gen, device=dev).to(dt)
    w = (torch.randn(co, ci, generator=gen, device=dev) / ci ** 0.5).to(wdt)
    scale = torch.rand(ci, generator=gen, device=dev) + 0.5
    shift = torch.randn(ci, generator=gen, device=dev) * 0.5
    res = torch.randn(n, ci, p, generator=gen, device=dev).to(dt) \
        if residual else None
    kw = dict(bn_in=(scale, shift), residual=res, relu_in=True)
    y, st = C.conv1x1(x, w, **kw)
    y2, st2 = C.conv1x1(x, w, **kw)
    ry, rst = C.reference_conv1x1(x, w, **kw)
    torch.cuda.synchronize()
    abs_err = float((y.float() - ry.float()).abs().max())
    if dtype != "f32":
        y_err = _half_ulp_err(y, ry, CONV_ATOL_REL)
        y_ok = y_err <= 1.0
    else:
        e, tol = err_of(y, ry)
        y_err, y_ok = e / tol, e <= tol
    s_err = _stats_err(st, rst)
    deterministic = bool(torch.equal(y, y2) and torch.equal(st[0], st2[0])
                         and torch.equal(st[1], st2[1]))
    del y2, st2, ry, rst
    per_call = launches_per_call(lambda: C.conv1x1(
        x, w, bn_in=(scale, shift), residual=res, relu_in=True), "conv1x1")
    esz = x.element_size()
    io_bytes = esz * (x.numel() + co * p * n) + w.numel() * w.element_size() \
        + 8 * ci + 8 * co + (res.numel() * esz if residual else 0)
    flops = 2 * n * p * ci * co
    iters = 10
    sets = [(x, w, res)]
    ms = bench_ms(lambda x, w, r: C.conv1x1(
        x, w, bn_in=(scale, shift), residual=r, relu_in=True), sets, iters)
    plain = bench_ms(lambda x, w, r: C.reference_conv1x1(
        x, w, bn_in=(scale, shift), residual=r, relu_in=True), sets,
        max(2, iters // 2))
    sc3, sh3 = scale.reshape(1, ci, 1), shift.reshape(1, ci, 1)
    common = dt if dt == wdt else torch.float32

    def library(x, w, r):
        xp = x * sc3 + sh3
        if r is not None:
            xp = xp + r
        yl = torch.matmul(w.to(common), torch.relu(xp).to(dt).to(common))
        yf = yl.float()
        return yl.to(dt), yf.sum(dim=(0, 2)), (yf * yf).sum(dim=(0, 2))

    lib = bench_ms(library, sets, iters)
    pieces = _conv_pieces(dtype, wdtype)
    if pieces is None:
        bnd, by = bound_ms(io_bytes, flops, PEAK_F32_FLOPS)
    else:
        bnd, by = bound_ms(io_bytes, pieces * flops, PEAK_BF16_FLOPS)
    return {"kernel": "conv1x1", "case": name, "dtype": dtype,
            "w_dtype": wdtype, "products": pieces,
            "shape": [n, ci, co, p], "residual": residual,
            "max_abs_err": abs_err, "err_over_tol": y_err,
            "tol": "one ulp of y's type + %g of max |ref|" % CONV_ATOL_REL
            if dtype != "f32" else "%g + %g of max |ref|" % (
                KERNEL_ATOL, KERNEL_RTOL), "stats_rel_err": s_err,
            "stats_rtol": CONV_STATS_RTOL, "deterministic": deterministic,
            "kernel_launches_per_call": per_call,
            "ok": y_ok and s_err <= CONV_STATS_RTOL and deterministic
            and per_call == 1,
            "kernel_ms": ms, "plain_ms": plain, "library_ms": lib,
            "library_note": "torch prologue + torch.matmul (cuBLAS) in the "
            "pair's common type + two reductions", "bound_ms": bnd,
            "bound_by": by, "bytes": io_bytes, "flops": flops}


RTC_SOURCE = r"""
extern "C" __global__ void scale_add(const float* x, const float* y,
                                     float* out, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = x[i] * 2.0f + y[i];
}
extern "C" __global__ void negate(const float* x, float* out, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = -x[i];
}
// one block per row, a block-wide tree sum in dynamic shared memory
extern "C" __global__ void row_sum(const float* x, float* out, int cols) {
  extern __shared__ float part[];
  const float* row = x + (size_t)blockIdx.x * cols;
  float s = 0.f;
  for (int c = threadIdx.x; c < cols; c += blockDim.x) s += row[c];
  part[threadIdx.x] = s;
  __syncthreads();
  for (int h = blockDim.x / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) part[threadIdx.x] += part[threadIdx.x + h];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = part[0];
}
"""
RTC_SIGS = {"scale_add": "const float *x, const float *y, float *out, int n",
            "negate": "const float *x, float *out, int n",
            "row_sum": "const float *x, float *out, int cols"}
RTC_ROWS = 4096          # row_sum: (4096, 2^26 / 4096)
RTC_BLOCK = 256


def _rtc_launch(kernels, name, x, y, out):
    """The launch of each rtc kernel over RTC_N floats, as a user writes
    it (the grid covers the data; row_sum one block per row)."""
    from mxnet_tpu_torch import gpu
    k = kernels[name]
    if name == "scale_add":
        k.launch([x, y, out, RTC_N], gpu(0),
                 ((RTC_N + RTC_BLOCK - 1) // RTC_BLOCK,), (RTC_BLOCK,))
    elif name == "negate":
        k.launch([x, out, RTC_N], gpu(0),
                 ((RTC_N + RTC_BLOCK - 1) // RTC_BLOCK,), (RTC_BLOCK,))
    else:
        k.launch([x, out, RTC_N // RTC_ROWS], gpu(0), (RTC_ROWS,),
                 (RTC_BLOCK,), shared_mem=RTC_BLOCK * 4)


def _rtc_cases(gen):
    """NVRTC's compile time; each rtc kernel over 2^26 floats against its
    torch expression (plain) and one torch call (library), timed beside
    its bytes bound."""
    import torch
    from mxnet_tpu_torch import rtc
    t0 = time.perf_counter()
    mod = rtc.CudaModule(RTC_SOURCE)
    compile_s = time.perf_counter() - t0
    kernels = {n: mod.get_kernel(n, sig) for n, sig in RTC_SIGS.items()}
    x = torch.randn(RTC_N, generator=gen, device="cuda")
    y = torch.randn(RTC_N, generator=gen, device="cuda")
    out = torch.empty_like(x)
    sums = torch.empty(RTC_ROWS, device="cuda")
    x2 = x.view(RTC_ROWS, -1)
    exprs = {  # (plain torch expression, one torch call, output, bytes)
        "scale_add": (lambda: x * 2.0 + y, lambda: torch.add(y, x, alpha=2),
                      out, 3 * 4 * RTC_N),
        "negate": (lambda: -x, lambda: torch.neg(x), out, 2 * 4 * RTC_N),
        "row_sum": (lambda: x2.sum(1), lambda: torch.sum(x2, 1), sums,
                    4 * RTC_N + 4 * RTC_ROWS)}
    cases = []
    for name, (plain_fn, lib_fn, dst, nbytes) in exprs.items():
        _rtc_launch(kernels, name, x, y, dst)
        ref = plain_fn()
        torch.cuda.synchronize()
        e, tol = err_of(dst, ref)
        per_call = launches_per_call(
            lambda: _rtc_launch(kernels, name, x, y, dst), None)
        ms = bench_ms(lambda: _rtc_launch(kernels, name, x, y, dst), [()], 20)
        plain = bench_ms(plain_fn, [()], 20)
        lib = bench_ms(lib_fn, [()], 20)
        bnd, by = bound_ms(nbytes, 0)
        cases.append({"kernel": "rtc", "case": name, "n": RTC_N,
                      "compile_s": compile_s, "max_abs_err": e, "tol": tol,
                      "kernel_launches_per_call": per_call,
                      "ok": e <= tol and per_call == 1,
                      "kernel_ms": ms, "plain_ms": plain,
                      "library_ms": lib, "bound_ms": bnd, "bound_by": by,
                      "bytes": nbytes})
    return cases


def phase_kernels():
    import torch
    DTYPES.update(f32=torch.float32, bf16=torch.bfloat16, f16=torch.float16)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    cases = [
        _flash_case("train_b8_s1024", TRAIN_BATCH, 16, 16, 1024, 64, True,
                    gen),
        _flash_case("prefill_s128", 1, 16, 16, 128, 64, True, gen),
        _flash_case("prefill_s1024", 1, 16, 16, 1024, 64, True, gen),
        _flash_case("gqa_s512", 1, 16, 4, 512, 64, True, gen),
        _flash_case("ragged_s1000", 1, 16, 16, 1000, 64, True, gen),
        _flash_case("noncausal_s300", 1, 16, 16, 300, 64, False, gen),
        _flash_case("hd128_s1000", 1, 8, 8, 1000, 128, True, gen),
        _flash_case("hd256_s1000", 1, 8, 8, 1000, 256, True, gen),
        _flash_case("hd384_s1000", 1, 8, 8, 1000, 384, True, gen),
        _flash_case("hd512_s1000", 1, 8, 8, 1000, 512, True, gen),
        _flash_case("train_b8_s1024_bf16", TRAIN_BATCH, 16, 16, 1024, 64,
                    True, gen, "bf16"),
        _flash_case("hd128_s1000_bf16", 1, 8, 8, 1000, 128, True, gen,
                    "bf16"),
        _flash_case("train_b8_s1024_f16", TRAIN_BATCH, 16, 16, 1024, 64,
                    True, gen, "f16"),
        # the ring's blocks (ring_attention: 16 heads of 64, 4,096 rows
        # a replica): the off-diagonal pairs non-causal, the diagonal
        # causal, in both of the ring phase's dtypes
        _flash_case("ring_block_s4096", 1, 16, 16, 4096, 64, False, gen),
        _flash_case("ring_diag_s4096", 1, 16, 16, 4096, 64, True, gen),
        _flash_case("ring_block_s4096_bf16", 1, 16, 16, 4096, 64, False,
                    gen, "bf16"),
        _flash_case("ring_diag_s4096_bf16", 1, 16, 16, 4096, 64, True, gen,
                    "bf16"),
        _flash_exact_case("exact_flash_fwd_f32", 2, 16, 1024, 64, gen),
        _flash_exact_case("exact_flash_fwd_f32_hd128", 1, 8, 1000, 128, gen),
    ]
    cases += [
        _flash_bwd_case("train_b8_s1024", TRAIN_BATCH, 16, 16, 1024, 64,
                        True, gen, plain_batch=2),
        _flash_bwd_case("longctx_b8_s4096_d128", 8, 8, 8, 4096, 128, True,
                        gen, plain_batch=1, iters=3),
        _flash_bwd_case("gqa_h8_kv2_s1024", 2, 8, 2, 1024, 64, True, gen),
        _flash_bwd_case("ragged_s1000", 2, 16, 16, 1000, 64, True, gen),
        _flash_bwd_case("noncausal_s512", 2, 16, 16, 512, 64, False, gen),
        _flash_bwd_case("glse_s1024", 2, 16, 16, 1024, 64, True, gen,
                        glse=True),
        # f32 D = 128 dQ on both sides of its tile choice: one wave of
        # blocks here (32-key tiles), many at S 4096 above (16-key tiles)
        _flash_bwd_case("hd128_s1000", 1, 8, 8, 1000, 128, True, gen),
        _flash_bwd_case("hd256_s1000", 1, 8, 8, 1000, 256, True, gen),
        _flash_bwd_case("hd384_s1000", 1, 8, 8, 1000, 384, True, gen),
        _flash_bwd_case("hd512_s1000", 1, 8, 8, 1000, 512, True, gen),
        _flash_bwd_case("train_b8_s1024_bf16", TRAIN_BATCH, 16, 16, 1024, 64,
                        True, gen, plain_batch=2, dt="bf16"),
        _flash_bwd_case("hd128_s1000_bf16", 1, 8, 8, 1000, 128, True, gen,
                        dt="bf16"),
        _flash_bwd_case("gqa_h8_kv2_s1024_f16", 2, 8, 2, 1024, 64, True, gen,
                        glse=True, dt="f16"),
        # the ring's backward blocks, each with a non-zero lse cotangent
        _flash_bwd_case("ring_block_s4096", 1, 16, 16, 4096, 64, False, gen,
                        glse=True, iters=5),
        _flash_bwd_case("ring_diag_s4096", 1, 16, 16, 4096, 64, True, gen,
                        glse=True, iters=5),
        _flash_bwd_case("ring_block_s4096_bf16", 1, 16, 16, 4096, 64, False,
                        gen, glse=True, iters=5, dt="bf16"),
        _flash_bwd_case("ring_diag_s4096_bf16", 1, 16, 16, 4096, 64, True,
                        gen, glse=True, iters=5, dt="bf16"),
        _flash_exact_case("exact_flash_dq_f32", 2, 16, 1024, 64, gen),
        _flash_exact_case("exact_flash_dq_f32_hd128", 1, 8, 1000, 128, gen),
    ]
    lengths = (0, 1, 17, 100, 511, 700, 1000, 1024)
    cases += [
        _decode_case("step_mha", SLOTS, 16, 16, 1024, 64, lengths, gen),
        # the serving profile's step: every slot at 512 of the 1024 pool
        _decode_case("step_mha_uniform512", SLOTS, 16, 16, 1024, 64,
                     (512,) * SLOTS, gen),
        _decode_case("step_gqa", SLOTS, 16, 4, 1024, 64, lengths, gen),
        _decode_case("step_hd128", SLOTS, 8, 8, 1024, 128, lengths, gen),
        _decode_case("step_hd256", SLOTS, 8, 8, 1024, 256, lengths, gen),
        _decode_case("step_hd384", SLOTS, 8, 8, 1024, 384, lengths, gen),
        _decode_case("step_hd512", SLOTS, 8, 8, 1024, 512, lengths, gen),
        _decode_case("step_hd512_gqa8", SLOTS, 8, 1, 1024, 512, lengths,
                     gen),
        # GQA groups of 7 (Qwen2-7B: 28 q heads over 4 kv heads, D 128) and
        # 16 (Falcon-40B: 128 over 8, D 64)
        _decode_case("step_gqa7_hd128", SLOTS, 28, 4, 1024, 128, lengths,
                     gen),
        _decode_case("step_gqa16_hd64", SLOTS, 128, 8, 1024, 64, lengths,
                     gen),
        _decode_case("step_mha_bf16", SLOTS, 16, 16, 1024, 64, lengths, gen,
                     "bf16"),
        _decode_case("step_hd128_bf16", SLOTS, 8, 8, 1024, 128, lengths,
                     gen, "bf16"),
        _decode_case("step_gqa_f16", SLOTS, 16, 4, 1024, 64, lengths, gen,
                     "f16"),
        # long context at Llama-3-8B's attention widths (32 q heads over 8
        # kv heads, head dim 128), bf16: 2 slots of a 32768-position pool
        _decode_case("longctx_llama3_8b_bf16", 2, 32, 8, 32768, 128,
                     (32768, 20000), gen, "bf16"),
        # f32 decode against float64 at the MHA step and the G7 shape
        _decode_exact_case("exact_decode_f32_mha", SLOTS, 16, 16, 1024, 64,
                           (1, 17, 100, 511, 700, 1000, 1024, 1024), gen),
        _decode_exact_case("exact_decode_f32_gqa7_hd128", SLOTS, 28, 4, 1024,
                           128, (1, 17, 100, 511, 700, 1000, 1024, 1024),
                           gen),
        _dense_case("hd96", 96, gen),
        _dense_case("hd640", 640, gen),
        _dense_case("cross_sq128_sk512", 64, gen, s_q=128),
    ]
    # the decode step's six per-layer matmuls (wq, wk, wv, wo at (1024,
    # 1024); w1; w2) and the head at 8 slots, then prefill at the longest
    # bucket's 1000 rows
    cases.append(_qmm_case("step_wq_int8", 8, 1024, 1024, "int8", gen))
    for dt in ("int8", "fp8"):
        cases += [
            _qmm_case("step_w1_" + dt, 8, 1024, 4096, dt, gen),
            _qmm_case("step_w2_" + dt, 8, 4096, 1024, dt, gen),
            _qmm_case("step_head_" + dt, 8, 1024, 50257, dt, gen),
        ]
    cases += [
        _qmm_case("step_w2_int8_m1", 1, 4096, 1024, "int8", gen),
        _qmm_case("step_w2_int8_m16", 16, 4096, 1024, "int8", gen),
        _qmm_case("step_w1_int8_bf16x", 8, 1024, 4096, "int8", gen, "bf16"),
        _qmm_case("step_w1_int8_f16x", 8, 1024, 4096, "int8", gen, "f16"),
        _qmm_case("prefill_w1_int8", 1000, 1024, 4096, "int8", gen),
        _qmm_case("prefill_w1_fp8", 1000, 1024, 4096, "fp8", gen),
        _qmm_case("prefill_w2_int8", 1000, 4096, 1024, "int8", gen),
        _qmm_case("prefill_w1_int8_bf16x", 1000, 1024, 4096, "int8", gen,
                  "bf16"),
        _qmm_case("prefill_w1_int8_f16x", 1000, 1024, 4096, "int8", gen,
                  "f16"),
    ]
    # exact products, with teeth: K = 8, x over 40 decades
    cases += [_qmm_pieces_case("exact_%s_%s" % (kind, dt), m, 8, n, dt, gen)
              for kind, m, n in (("step_head", 8, 50257),
                                 ("prefill", 1000, 4096))
              for dt in ("int8", "fp8")]
    # ResNet-50's 1x1 shapes (docs/megakernel_r04.md section 3), each as
    # that doc's unit: relu(bn(x)) prologue plus statistics
    for ci, co, hw in ((256, 64, 56), (64, 256, 56), (128, 512, 28),
                       (1024, 256, 14), (512, 2048, 7)):
        cases.append(_conv_case("r50_%dto%d_%d" % (ci, co, hw), CONV_BATCH,
                                ci, co, hw * hw, "bf16", gen))
    cases.append(_conv_case("r50_256to64_56_residual", CONV_BATCH, 256, 64,
                            56 * 56, "bf16", gen, residual=True))
    cases.append(_conv_case("r50_64to256_56_f32", CONV_BATCH, 64, 256,
                            56 * 56, "f32", gen))
    # float16, and a mixed pair (f16 x, bf16 w: two exact bf16 pieces)
    cases.append(_conv_case("r50_64to256_56_f16", CONV_BATCH, 64, 256,
                            56 * 56, "f16", gen))
    cases.append(_conv_case("r50_256to64_56_f16x_bf16w", CONV_BATCH, 256,
                            64, 56 * 56, "f16", gen, residual=True,
                            wdtype="bf16"))
    cases += _rtc_cases(gen)
    # the R-CNN path's kernels at faster_rcnn's shapes
    cases += [_roi_pool_case("rcnn_r128_512x37x62", gen),
              _nms_case("rcnn_pre12000_f32", gen, RCNN_NMS[0]),
              _nms_case("rcnn_pre12000_f64", gen, RCNN_NMS[0], "f64")]
    RECORD["kernel_cases"] = cases
    for c in cases:
        emit(dict(phase="kernel_case", **c))
    bad = [c["kernel"] + ":" + c["case"] for c in cases if not c["ok"]]
    if bad:
        raise AssertionError("kernel disagrees with its plain version: %s"
                             % bad)
    return {"cases": len(cases)}


def _wrappers():
    from mxnet_tpu_torch import rtc
    from mxnet_tpu_torch.image import assemble as I
    from mxnet_tpu_torch.ops import attention as A, conv_fused as C, \
        quantization as Q, rcnn as R
    return {"flash_attention_fwd": A.flash_attention_fwd,
            "flash_attention_bwd_dq": A.flash_attention_bwd_dq,
            "flash_attention_bwd_dkv": A.flash_attention_bwd_dkv,
            "decode_attention": A.decode_attention,
            "quantized_matmul": Q.quantized_matmul,
            "conv1x1": C.conv1x1, "rtc": rtc.CudaKernel,
            "image_assemble": I.assemble, "roi_pooling": R.roi_pooling,
            "proposal_nms": R.proposal_nms}


def _reset_counts():
    from mxnet_tpu_torch.ops import attention as A
    for fn in _wrappers().values():
        fn.launches = 0
        if hasattr(fn, "by_dtype"):
            fn.by_dtype.clear()
    A.dense_attention.calls = 0


def _read_counts():
    """Kernel launches by wrapper, and the dense attention route's calls
    (GPT-2 medium's head dim 64 has a kernel: they stay 0)."""
    from mxnet_tpu_torch.ops import attention as A
    counts = {name: fn.launches for name, fn in _wrappers().items()}
    counts["dense_attention"] = A.dense_attention.calls
    return counts


def _lm_batch():
    """Next token = (token + 3) % vocab (examples/transformer_lm.py),
    8 x 1024 tokens from the seed, as float ids (Gluon's convention)."""
    import numpy as np
    import torch
    v, s = TRAIN["vocab_size"], TRAIN["max_length"]
    rng = np.random.RandomState(SEED)
    start = rng.randint(0, v, (TRAIN_BATCH, 1))
    tokens = (start + np.arange(s + 1) * 3) % v
    x = torch.tensor(tokens[:, :-1], dtype=torch.float32, device=DEV)
    y = torch.tensor(tokens[:, 1:], dtype=torch.float32, device=DEV)
    return x, y


def _lm_step_loss(net, head, loss_fn, x, y):
    logits = head(net(x))
    return loss_fn(logits.reshape(-1, TRAIN["vocab_size"]),
                   y.reshape(-1)).mean()


def _grad_stats(g_a, g_b, gmax, elem_rtol):
    """Per-tensor differences of two gradient dicts (g_b the reference);
    counts the elements beyond ``elem_rtol`` of their tensor's max."""
    st = {"norm": (0.0, None), "elem": (0.0, None), "key_bias": 0.0, "outliers": {},
          "n_out": 0, "n_el": 0, "finite": True}
    for n in g_b:
        st["finite"] = st["finite"] and bool(g_a[n].isfinite().all())
        if n.endswith("_key_bias"):
            st["key_bias"] = max(st["key_bias"],
                                 float(g_a[n].abs().max()) / gmax,
                                 float(g_b[n].abs().max()) / gmax)
            continue
        diff = (g_a[n] - g_b[n]).abs()
        rel = float(diff.norm()) / max(float(g_b[n].norm()), 1e-30)
        scale = max(float(g_b[n].abs().max()), 1e-30)
        out = int((diff > elem_rtol * scale).sum())
        st["n_el"] += diff.numel()
        if out:
            st["n_out"] += out
            st["outliers"][n] = out
        if rel > st["norm"][0]:
            st["norm"] = (rel, n)
        if float(diff.max()) / scale > st["elem"][0]:
            st["elem"] = (float(diff.max()) / scale, n)
    st["outliers"] = dict(sorted(st["outliers"].items(),
                                 key=lambda kv: -kv[1])[:12])
    return st


def _grad_check(net, head, params, loss_fn, x, y):
    """Loss and every parameter's gradient on the first GRAD_SLICE
    sequences three ways: through the kernels; through the plain
    attention (``ops.attention.flash_attention``, which the blocks'
    ``_contrib_flash_attention`` op calls, swapped for
    ``reference_attention``, differentiated by torch); and through the
    forward kernel with the backward's plain twin swapped in, which keeps
    the forward (and every ReLU mask) bit-identical and so isolates the
    dQ and dK/dV kernels. Both swaps hold for this check only."""
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.ops import attention as A
    xs, ys = x[:GRAD_SLICE], y[:GRAD_SLICE]
    kernel_fwd, kernel_bwd = A.flash_attention, A.flash_attention_bwd
    runs = {}
    for mode in ("kernels", "plain", "plain_bwd"):
        if mode == "plain":
            A.flash_attention = A.reference_attention
        if mode == "plain_bwd":
            A.flash_attention_bwd = A.reference_flash_attention_bwd
        try:
            with autograd.record():
                loss = _lm_step_loss(net, head, loss_fn, xs, ys)
            loss.backward()
        finally:
            A.flash_attention = kernel_fwd
            A.flash_attention_bwd = kernel_bwd
        runs[mode] = (float(loss.detach()),
                      {n: p.grad()._data.detach().clone()
                       for n, p in params.items()})
    l_k, g_k = runs["kernels"]
    l_p, g_p = runs["plain"]
    gmax = max(float(g.abs().max()) for g in g_p.values())
    full = _grad_stats(g_k, g_p, gmax, PATH_ELEM_RTOL)
    bwd = _grad_stats(g_k, runs["plain_bwd"][1], gmax, BWD_GRAD_RTOL)
    del runs, g_k, g_p
    res = {"sequences": GRAD_SLICE, "tensors": len(params),
           "loss_kernels": l_k, "loss_plain": l_p,
           "loss_rel_err": abs(l_k - l_p) / abs(l_p),
           "loss_rtol": LOSS_RTOL,
           "bwd_only_norm_rel_err": bwd["norm"][0],
           "bwd_only_elem_rel_err_max": bwd["elem"][0],
           "bwd_only_worst_tensor": bwd["elem"][1],
           "bwd_only_elems_beyond_rtol_of_max": bwd["n_out"],
           "bwd_only_rtol": BWD_GRAD_RTOL,
           "path_norm_rel_err": full["norm"][0],
           "path_worst_tensor": full["norm"][1],
           "path_rtol": PATH_GRAD_RTOL,
           "path_elem_rel_err_max": full["elem"][0],
           "path_worst_elem_tensor": full["elem"][1],
           "path_elem_count_rtol": PATH_ELEM_RTOL,
           "path_elems_beyond_rtol_of_max": full["n_out"],
           "elems": full["n_el"],
           "path_tensors_with_such_elems": full["outliers"],
           "key_bias_max_rel": max(full["key_bias"], bwd["key_bias"]),
           "key_bias_rtol": ZERO_GRAD_RTOL,
           "all_finite": full["finite"] and bwd["finite"]}
    res["ok"] = bool(
        res["all_finite"] and res["loss_rel_err"] <= LOSS_RTOL and
        bwd["norm"][0] <= BWD_GRAD_RTOL and
        bwd["elem"][0] <= BWD_GRAD_RTOL and
        full["norm"][0] <= PATH_GRAD_RTOL and
        res["key_bias_max_rel"] <= ZERO_GRAD_RTOL)
    return res


def phase_train():
    """The Gluon training path at full width: build, gradient check,
    warm-up, timed steps (launch counts read around the timed steps)."""
    import math as _m
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, cpu, gluon, gpu
    t0 = time.perf_counter()
    mx.random.seed(SEED)
    ctx = gpu(0) if DEV == "cuda" else cpu()
    net = gluon.nn.TransformerEncoder(**TRAIN, prefix="lm_")
    head = gluon.nn.Dense(TRAIN["vocab_size"], flatten=False,
                          prefix="head_")
    net.initialize(mx.init.Xavier(), ctx=ctx)
    head.initialize(mx.init.Xavier(), ctx=ctx)
    params = {**net.collect_params(), **head.collect_params()}
    trainer = gluon.Trainer(params, "adam", {"learning_rate": TRAIN_LR})
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    x, y = _lm_batch()
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    check = _grad_check(net, head, params, loss_fn, x, y)
    if DEV == "cuda":
        check["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    build_s = time.perf_counter() - t0
    n_params = int(sum(p.data().size for p in params.values()))
    emit(dict(phase="train_grad_check", **check))

    def step():
        with autograd.record():
            loss = _lm_step_loss(net, head, loss_fn, x, y)
        loss.backward()
        trainer.step(1)             # the loss is a mean already, as in
        return loss.detach()        # examples/transformer_lm.py

    losses = []
    for _ in range(TRAIN_WARMUP):
        losses.append(step())
    _sync()
    if DEV == "cuda":               # the timed steps' peak alone
        torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    step_s = []
    for _ in range(TRAIN_STEPS):
        t1 = time.perf_counter()
        losses.append(step())
        _sync()
        step_s.append(time.perf_counter() - t1)
    counts = _read_counts()
    peak = torch.cuda.max_memory_allocated() if DEV == "cuda" else 0
    losses = [float(v) for v in losses]
    tokens = TRAIN_BATCH * TRAIN["max_length"]
    mean_s = sum(step_s) / len(step_s)
    per_step = {k: v / TRAIN_STEPS for k, v in counts.items()}
    want = TRAIN["num_layers"]
    res = {"model": dict(TRAIN, head="Dense(vocab, flatten=False)"),
           "batch": TRAIN_BATCH, "tokens_per_step": tokens,
           "n_params": n_params, "setup_and_check_s": build_s,
           "grad_check": check, "losses": losses,
           "step_s": step_s, "step_s_mean": mean_s,
           "step_s_min": min(step_s), "tokens_per_s": tokens / mean_s,
           "peak_mem_gb": peak / 1e9, "launches": counts,
           "launches_per_step": per_step,
           "all_finite": all(_m.isfinite(v) for v in losses),
           "loss_falls": losses[-1] < losses[0]}
    res["ok"] = bool(check["ok"] and res["all_finite"] and res["loss_falls"]
                     and counts["dense_attention"] == 0
                     and all(counts[k] == want * TRAIN_STEPS for k in (
                         "flash_attention_fwd", "flash_attention_bwd_dq",
                         "flash_attention_bwd_dkv")))
    RECORD["train"] = res
    RECORD["_train"] = (net, head, trainer, loss_fn, x, y, mean_s)
    if not res["ok"]:
        raise AssertionError("train failed: %s" % json.dumps(res)[:3000])
    return res


def _device_rows(prof, n_steps, required=True):
    """(kernel, device ms a step, calls a step) by kernel, largest first;
    raises when the card recorded nothing, unless not ``required``."""
    rows = []
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", None)
        if t is None:
            t = getattr(ev, "cuda_time_total", 0.0)
        if t and "CUDA" in str(getattr(ev, "device_type", "")):
            rows.append((ev.key, t / (1e3 * n_steps), ev.count / n_steps))
    if required and DEV == "cuda" and not rows:
        raise AssertionError("torch.profiler recorded no device time")
    rows.sort(key=lambda r: -r[1])
    return rows


# device kernels grouped by name (matched lower-case, first group wins)
_GROUPS = (("flash_fwd", ("flash_fwd",)), ("flash_bwd_dq", ("flash_bwd_dq",)),
           ("flash_bwd_dkv", ("flash_bwd_dkv",)),
           ("gemm", ("gemm", "cutlass", "kernel2")),
           ("layer_norm", ("layer_norm", "gammabeta")),
           ("log_softmax", ("softmax",)),
           ("embedding", ("embedding", "index", "scatter", "gather")))


def phase_train_profile():
    """One training step under torch.profiler: device time by kernel
    against the host wall per step (the timed steps' mean)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from mxnet_tpu_torch import autograd
    net, head, trainer, loss_fn, x, y, host_s = RECORD.pop("_train")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with autograd.record():
            loss = _lm_step_loss(net, head, loss_fn, x, y)
        loss.backward()
        trainer.step(1)
        _sync()
    rows = _device_rows(prof, 1)
    dev_ms = sum(r[1] for r in rows)
    groups = {}
    for k, t, c in rows:
        g = next((name for name, keys in _GROUPS
                  if any(key in k.lower() for key in keys)),
                 "other (elementwise: Adam, residuals, ReLU, ...)")
        groups[g] = groups.get(g, 0.0) + t
    res = {"step_host_ms": host_s * 1e3, "device_ms_per_step": dev_ms,
           "device_busy_share": dev_ms / (host_s * 1e3),
           "groups_ms": groups,
           "top": [{"kernel": k[:100], "ms_per_step": t, "calls": c}
                   for k, t, c in rows[:15]]}
    del net, head, trainer, loss, x, y
    import gc
    gc.collect()
    if DEV == "cuda":
        torch.cuda.empty_cache()
    return res


def _pct(xs, p):
    xs = sorted(xs)
    if not xs:
        return None
    return xs[min(len(xs) - 1, int(round(p / 100.0 * (len(xs) - 1))))]


def _recompute_logits(model, toks):
    """Logits after ``toks`` by one prefill of the whole context into a
    fresh one-slot cache."""
    import torch
    from mxnet_tpu_torch.serving.decode import prompt_buckets
    bucket = next(b for b in prompt_buckets(model.max_len)
                  if b >= len(toks))
    kc, vc = model.init_cache(1)
    padded = torch.zeros(1, bucket, dtype=torch.int64, device=DEV)
    padded[0, :len(toks)] = torch.tensor(toks, device=DEV)
    _, _, _, ref = model.prefill(kc, vc, padded, len(toks), 0)
    return ref.float().cpu().numpy()


def _served_step_s(eng):
    """(sum, count) of the engine's step-seconds histogram: the wall time
    of each served step (state in, replay, next tokens out)."""
    snap = eng._m_step.snapshot()
    return snap["sum"], snap["count"]


def _serve(tag, model, params, need, prompt_lens=None):
    """Serve the staggered sessions (``prompt_lens``, default PROMPT_LENS)
    of ``model`` through the engine's CUDA graphs; check logits, plans and
    launches; return the phase."""
    import numpy as np
    from mxnet_tpu_torch.ops import attention as A
    from mxnet_tpu_torch.serving.decode import DecodeEngine, prompt_buckets
    prompt_lens = prompt_lens or PROMPT_LENS
    max_len = model.max_len
    rng = np.random.RandomState(SEED + 1)
    prompts = [rng.randint(0, model.vocab, size=n).tolist()
               for n in prompt_lens]
    t0 = time.perf_counter()
    eng = DecodeEngine(model, params, num_slots=SLOTS, name=tag, device=DEV)
    setup_s = time.perf_counter() - t0
    try:
        # capture every prompt bucket's graph off the clock
        ladder = prompt_buckets(max_len)
        buckets = sorted({next(b for b in ladder if b >= n)
                          for n in prompt_lens} | {ladder[0]})
        t0 = time.perf_counter()
        for b in buckets:
            eng.generate([1] * min(b, max_len - 1), max_new_tokens=2)
        warm_s = time.perf_counter() - t0
        _sync()
        compiles = eng.plan_compiles
        _reset_counts()
        steps0 = eng.step_executions
        rep0 = eng.graph_launches()["replayed"]
        step_s0 = _served_step_s(eng)
        t_sub, sessions = [], []
        t_start = time.perf_counter()
        for i, p in enumerate(prompts):
            t_sub.append(time.perf_counter())
            sessions.append(eng.submit(
                p, max_new_tokens=NEW_TOKENS,
                keep_logits=i in (0, len(prompts) - 1)))
            time.sleep(0.005)
        outs = [s.result(timeout=600) for s in sessions]
        wall = time.perf_counter() - t_start
        counts = _read_counts()
        steps = eng.step_executions - steps0
        rep1 = eng.graph_launches()["replayed"]
        step_s1 = _served_step_s(eng)
        plans = eng.plans()
        graphs = {"plan_compiles": eng.plan_compiles,
                  "step_compiles": eng.step_compiles,
                  "plan_resident_bytes": eng.plan_resident_bytes,
                  "resident_bytes": eng.resident_bytes(),
                  "capture_s": {p["name"]: p["capture_s"] for p in plans},
                  "peak_bytes": {p["name"]: p["peak_bytes"] for p in plans},
                  "captured_launches": eng.graph_launches()["captured"],
                  "replayed_launches": {k: n - rep0.get(k, 0)
                                        for k, n in rep1.items()},
                  "all_graphs": all(p["graph"] for p in plans),
                  "compiles_in_run": eng.plan_compiles - compiles,
                  "arrivals_zero": all(not t.any()
                                       for t in A._ARRIVALS.values())}
    finally:
        eng.close()
    n_tok = sum(len(o) for o in outs)
    itl = [(b - a) * 1e3 for s in sessions
           for a, b in zip(s.t_emit, s.t_emit[1:])]
    ttft = [(s.t_emit[0] - t) * 1e3 for s, t in zip(sessions, t_sub)]
    # served logits vs a full-context recompute through the plain path:
    # every step of the shortest prompt (bucket 32), and the first and last
    # step of the longest (the largest bucket, decode lengths past it)
    checks = [(0, range(NEW_TOKENS)), (len(prompts) - 1, (0, NEW_TOKENS - 1))]
    worst, n_checked, finite = {}, 0, True
    # the plain versions for this recompute only: serving.decode's names
    # of the three kernel wrappers patched to their reference twins; the
    # engine is closed, so no graph is captured while they are in place
    from mxnet_tpu_torch.ops import quantization as Q
    from mxnet_tpu_torch.serving import decode as SD
    kernels = (SD.flash_attention, SD.decode_attention, SD.quantized_matmul)
    SD.flash_attention = A.reference_attention
    SD.decode_attention = A.reference_decode_attention
    SD.quantized_matmul = Q.reference_quantized_matmul
    try:
        for i, steps_i in checks:
            sess = sessions[i]
            worst[prompt_lens[i]] = 0.0
            for t in steps_i:
                got = sess.logits[t]
                finite = finite and bool(np.isfinite(got).all())
                ref = _recompute_logits(model, prompts[i] + sess.tokens[:t])
                rel = float(np.abs(got - ref).max()
                            / max(1e-30, np.abs(ref).max()))
                worst[prompt_lens[i]] = max(worst[prompt_lens[i]], rel)
                n_checked += 1
    finally:
        (SD.flash_attention, SD.decode_attention,
         SD.quantized_matmul) = kernels
    replayed = graphs["replayed_launches"]
    ok_counts = all(counts[k] > 0 and replayed.get(k, 0) > 0
                    for k in need) and counts["dense_attention"] == 0
    ok_graphs = (graphs["all_graphs"] and graphs["step_compiles"] == 1
                 and graphs["plan_compiles"] == 1 + len(buckets)
                 and graphs["compiles_in_run"] == 0
                 and graphs["arrivals_zero"])
    served = (step_s1[0] - step_s0[0]) / max(step_s1[1] - step_s0[1], 1)
    res = {"setup_s": setup_s, "bucket_capture_s": warm_s,
           "sessions": len(outs), "tokens": n_tok, "wall_s": wall,
           "tokens_per_s": n_tok / wall, "steps": steps,
           "served_step_ms": served * 1e3,
           "step_ms_mean": wall / max(steps, 1) * 1e3,
           "itl_p50_ms": _pct(itl, 50), "itl_p99_ms": _pct(itl, 99),
           "ttft_p50_ms": _pct(ttft, 50), "ttft_max_ms": max(ttft),
           "launches": counts, "graphs": graphs,
           "logits_checked": n_checked,
           "logits_max_rel_err": max(worst.values()),
           "logits_max_rel_err_by_prompt": worst,
           "logits_tol_rel": LOGIT_RTOL, "all_finite": finite,
           "lens_ok": all(len(o) == NEW_TOKENS for o in outs)}
    res["ok"] = bool(ok_counts and ok_graphs
                     and res["logits_max_rel_err"] <= LOGIT_RTOL
                     and finite and res["lens_ok"])
    if not res["ok"]:
        raise AssertionError("%s failed: %s" % (tag, json.dumps(res)))
    return res


def phase_engines():
    import numpy as np  # noqa: F401
    import torch
    from mxnet_tpu_torch.contrib.quantization import calibrate_weights
    from mxnet_tpu_torch.convert import to_torch_params
    from mxnet_tpu_torch.serving.decode import DecodeModel
    t0 = time.perf_counter()
    model = DecodeModel(**CFG)
    params = model.init_params(seed=SEED)
    init_s = time.perf_counter() - t0
    n_params = int(sum(v.size for v in params.values()))
    out = {}
    r = _serve("gpt2m-f32", model, params,
               ("flash_attention_fwd", "decode_attention"))
    r.update(init_params_s=init_s, n_params=n_params)
    out["engine_f32"] = r
    emit(dict(phase="engine_f32", **r))
    dev_params = to_torch_params(params, DEV)
    del params
    qparams, stats = calibrate_weights(dev_params, "int8")
    del dev_params
    model_q = DecodeModel(**CFG)
    r = _serve("gpt2m-int8", model_q, qparams,
               ("flash_attention_fwd", "decode_attention",
                "quantized_matmul"))
    r["int8_weight_bytes"] = int(sum(
        v.numel() for k, v in qparams.items()
        if v.dtype == torch.int8))
    r["calib_rms_rel_err_max"] = max(s["rms_rel_err"]
                                     for s in stats.values())
    out["engine_int8"] = r
    emit(dict(phase="engine_int8", **r))
    RECORD["engines"] = out
    RECORD["_models"] = {"f32": model, "int8": model_q}
    return {"done": list(out)}


def phase_profile():
    """A full-occupancy decode step of each served model (float, int8),
    eager and as the engine's graph, timed by host clock and under
    torch.profiler (device time by kernel)."""
    models = RECORD.pop("_models")
    RECORD["profile"] = {tag: _profile_step(m, tag)
                         for tag, m in models.items()}
    return RECORD["profile"]


def _profile_step(model, tag):
    """A decode step with every slot at half the model's max_len, side by
    side in one run: the eager step (host wall time, then device time by
    kernel under torch.profiler) and the engine's step plan (its CUDA
    graph), run as the engine serves it (state in, replay, next tokens
    out, synchronise: host wall time), run back to back with one
    synchronisation at the end (host wall time over many: the device's
    pace), and under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from mxnet_tpu_torch.serving.decode import DecodeEngine
    eng = DecodeEngine(model, None, num_slots=SLOTS, name=tag + "-profile",
                       device=DEV)
    try:
        kc, vc = eng._k, eng._v
        dev = DEV
        toks = torch.arange(SLOTS, dtype=torch.int32, device=dev)
        lens = torch.tensor([model.max_len // 2] * SLOTS, dtype=torch.int32,
                            device=dev)
        act = torch.ones(SLOTS, dtype=torch.bool, device=dev)
        for _ in range(3):
            model.step(kc, vc, toks, lens, act)
        _sync()
        t0 = time.perf_counter()
        n = 10
        for _ in range(n):
            model.step(kc, vc, toks, lens, act)
        _sync()
        host_ms = (time.perf_counter() - t0) / n * 1e3
        plan = eng._step_plan
        plan.host_in.copy_(torch.stack([toks, lens, act.int()]).cpu())
        with eng._stream_ctx():
            for _ in range(3):
                plan.run()
            eng._sync()
            t0 = time.perf_counter()
            for _ in range(n):
                plan.run()
                eng._sync()
            served_ms = (time.perf_counter() - t0) / n * 1e3
            m = 50
            t0 = time.perf_counter()
            for _ in range(m):
                plan.run()
            eng._sync()
            replay_ms = (time.perf_counter() - t0) / m * 1e3
            # as served by _serve: ragged lengths (its prompts, 16 tokens
            # in) and two slots' logits rows copied out; then the same
            # with the card left idle 1.5 ms between steps (the served
            # loop's host work between replays)
            ragged = [min(n + 16, model.max_len - 1) for n in PROMPT_LENS]
            plan.host_in[1] = torch.tensor(
                (ragged * SLOTS)[:SLOTS], dtype=torch.int32)
            rows = (0, SLOTS - 1)
            served_ragged_ms, served_gap_ms = [], []
            for gap in (0.0, 1.5e-3):
                for _ in range(3):
                    plan.run(rows)
                    eng._sync()
                total = 0.0
                for _ in range(n):
                    t0 = time.perf_counter()
                    plan.run(rows)
                    eng._sync()
                    total += time.perf_counter() - t0
                    if gap:
                        time.sleep(gap)
                (served_gap_ms if gap else served_ragged_ms).append(
                    total / n * 1e3)
            plan.host_in[1] = lens.cpu()
        res = {"step_host_ms": host_ms, "served_step_ms": served_ms,
               "replay_ms": replay_ms,
               "served_ragged_ms": served_ragged_ms[0],
               "served_idle_gap_ms": served_gap_ms[0], "slots": SLOTS,
               "length": model.max_len // 2,
               "launches_per_replay": plan.launches}
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                model.step(kc, vc, toks, lens, act)
            _sync()
        rows = _device_rows(prof, 3)
        dev_total = sum(r[1] for r in rows)
        dec = sum(r[1] for r in rows if "decode_" in r[0])
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with eng._stream_ctx():
                for _ in range(3):
                    plan.run()
                eng._sync()
        # the kernels of a replay, where the profiler traces graphs
        graph_rows = _device_rows(prof, 3, required=False)
        res.update(device_ms_per_step=dev_total,
                   device_ms_per_replay=sum(r[1] for r in graph_rows)
                   if graph_rows else "not traced",
                   decode_attention_ms_per_step=dec,
                   decode_attention_share=dec / dev_total
                   if dev_total else None,
                   device_busy_share=dev_total / host_ms if host_ms else None,
                   served_over_device=served_ms / dev_total
                   if dev_total else None,
                   top=[{"kernel": k[:80], "ms_per_step": t, "calls": c}
                        for k, t, c in rows[:12]])
    finally:
        eng.close()
    return res


def _device_params(model, seed):
    """DecodeModel.init_params's recipe (standard normal over sqrt(fan-in),
    positions scaled by 0.1, norms at 1) drawn on the card from a
    torch.Generator seeded ``seed``: numpy would take tens of seconds of
    host time for Qwen2-7B's widths. The CPU tests hold the model against
    the JAX package at small widths."""
    import torch
    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed)
    d, h, hkv, hd = model.d_model, model.heads, model.kv_heads, \
        model.head_dim

    def w(*shape):
        t = torch.randn(*shape, generator=gen, device=DEV)
        return t.mul_(1.0 / math.sqrt(shape[0]))

    p = {"embed": w(model.vocab, d), "pos": w(model.max_len, d).mul_(0.1),
         "lnf": torch.ones(d, device=DEV), "head": w(d, model.vocab)}
    for i in range(model.layers):
        p[f"l{i}.ln1"] = torch.ones(d, device=DEV)
        p[f"l{i}.wq"] = w(d, h * hd)
        p[f"l{i}.wk"] = w(d, hkv * hd)
        p[f"l{i}.wv"] = w(d, hkv * hd)
        p[f"l{i}.wo"] = w(h * hd, d)
        p[f"l{i}.ln2"] = torch.ones(d, device=DEV)
        p[f"l{i}.w1"] = w(d, model.d_ff)
        p[f"l{i}.w2"] = w(model.d_ff, d)
    return p


def phase_serve_gqa():
    """GQA serving through the new decode kernel at Qwen2-7B's attention
    and model widths (QWEN: 28 q heads over 4 kv heads, head dim 128, 4
    layers, max_len 4096), f32 weights: 8 staggered sessions of 17..4000
    prompt tokens, 32 new tokens each, through DecodeEngine; logits held
    against a full-context recompute; then a full-occupancy decode step
    (slots at 2048) under torch.profiler with decode attention's share."""
    import torch
    from mxnet_tpu_torch.serving.decode import DecodeModel
    t0 = time.perf_counter()
    model = DecodeModel(**QWEN)
    params = _device_params(model, SEED)
    _sync()
    init_s = time.perf_counter() - t0
    n_params = int(sum(v.numel() for v in params.values()))
    r = _serve("qwen2-7b-widths-f32", model, params,
               ("flash_attention_fwd", "decode_attention"),
               prompt_lens=QWEN_PROMPT_LENS)
    del params
    r.update(model="DecodeModel at Qwen2-7B widths (config.json: hidden "
             "3584, 28 heads, 4 kv heads, intermediate 18944, vocab "
             "152064); RMSNorm/tanh-GELU/learned positions, not Qwen2's "
             "blocks", cut="layers 28 -> 4, max_len 4096",
             init_params_s=init_s, n_params=n_params,
             profile=_profile_step(model, "qwen2-7b-widths-f32"))
    RECORD["serve_gqa"] = r
    return r


def phase_export():
    """The decode artifact's write side at GPT-2 medium's widths cut to
    EXPORT_LAYERS layers: export_decode_model (f32) ->
    quantize_decode_artifact (int8) -> DecodeEngine(path). The engine
    loaded from the artifact must hold the same int8 params, bit for bit,
    as one given calibrate_weights of the same float params in memory,
    and serve the same tokens."""
    import tempfile
    import numpy as np
    import torch
    from mxnet_tpu_torch.contrib.export import export_decode_model
    from mxnet_tpu_torch.contrib.quantization import (
        calibrate_weights, quantize_decode_artifact)
    from mxnet_tpu_torch.serving.decode import DecodeEngine, DecodeModel
    cfg = dict(CFG, layers=EXPORT_LAYERS)
    model = DecodeModel(**cfg)
    params = model.init_params(seed=SEED)
    rng = np.random.RandomState(SEED + 2)
    prompts = [rng.randint(0, cfg["vocab"], size=n).tolist()
               for n in PROMPT_LENS[:4]]
    work = os.path.join(HERE, "build")
    os.makedirs(work, exist_ok=True)
    res = {"model": "DecodeModel at GPT-2 medium widths",
           "cut": "layers 24 -> %d" % EXPORT_LAYERS}
    with tempfile.TemporaryDirectory(dir=work) as td:
        f32, q8 = os.path.join(td, "f32.mxa"), os.path.join(td, "int8.mxa")
        t0 = time.perf_counter()
        export_decode_model(f32, model.config(), params,
                            model_name="gpt2m-2l")
        res["export_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        quant = quantize_decode_artifact(f32, q8, dtype="int8")
        res["quantize_s"] = time.perf_counter() - t0
        res.update(f32_mb=os.path.getsize(f32) / 1e6,
                   int8_mb=os.path.getsize(q8) / 1e6,
                   quantized=len(quant["params"]))
        qparams, _ = calibrate_weights(params, "int8")
        t0 = time.perf_counter()
        with DecodeEngine(q8, num_slots=SLOTS, device=DEV) as a:
            res["load_s"] = time.perf_counter() - t0
            got = [a.generate(p, max_new_tokens=NEW_TOKENS) for p in prompts]
            loaded = dict(a.model.named_parameters())
            graphs = all(p["graph"] for p in a.plans())
            name = a.name
        with DecodeEngine(DecodeModel(**cfg), qparams, num_slots=SLOTS,
                          name="gpt2m-2l-mem", device=DEV) as b:
            ref = [b.generate(p, max_new_tokens=NEW_TOKENS) for p in prompts]
            same = sorted(loaded) == sorted(
                n for n, _ in b.model.named_parameters()) and all(
                torch.equal(t, b.model.get_parameter(n))
                for n, t in loaded.items())
    res.update(engine=name, sessions=len(got), tokens=sum(map(len, got)),
               params_equal=same, tokens_equal=got == ref, graphs=graphs)
    res["ok"] = bool(same and got == ref and graphs and name == "gpt2m-2l"
                     and all(len(o) == NEW_TOKENS for o in got))
    RECORD["export"] = res
    if not res["ok"]:
        raise AssertionError("export failed: %s" % json.dumps(res))
    return res


def _stage2_chain(conv, x0, w1, w2, r, gamma, beta):
    """ResNet-50 stage 2's bottleneck boundary through ops.conv_fused:
    expand with statistics, fold BN, the next block's reduce with the
    BN + residual + ReLU prologue and statistics, and its BN."""
    from mxnet_tpu_torch.ops import conv_fused as C
    count = x0.shape[0] * x0.shape[2]
    y, (s1, s2) = conv(x0, w1)
    mean, _, rstd = C.finalize_stats(s1, s2, count, 1e-5)
    fold = C.bn_fold(gamma, beta, mean, rstd)
    z, (t1, t2) = conv(y, w2, bn_in=fold, residual=r, relu_in=True)
    return y, z, C.finalize_stats(t1, t2, count, 1e-5)


def phase_conv():
    """The conv path at ResNet-50's stage-2 widths, batch 128, bf16:
    x0 (128, 64, 56*56) -> 256 channels -> 64, through conv1x1,
    finalize_stats and bn_fold, timed by CUDA events behind a spin (device
    time). Launch counts are read around the timed applications; the
    check runs the same chain through reference_conv1x1."""
    import torch
    from mxnet_tpu_torch.ops import conv_fused as C
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED + 2)
    n, c, p = CONV_BATCH, 64, 56 * 56
    bf = torch.bfloat16
    x0 = torch.randn(n, c, p, generator=gen, device=DEV).to(bf)
    w1 = (torch.randn(4 * c, c, generator=gen, device=DEV) / c ** 0.5).to(bf)
    w2 = (torch.randn(c, 4 * c, generator=gen, device=DEV)
          / (4 * c) ** 0.5).to(bf)
    r = torch.randn(n, 4 * c, p, generator=gen, device=DEV).to(bf)
    gamma = torch.rand(4 * c, generator=gen, device=DEV) + 0.5
    beta = torch.randn(4 * c, generator=gen, device=DEV) * 0.1
    args = (x0, w1, w2, r, gamma, beta)
    _stage2_chain(C.conv1x1, *args)                  # warm-up
    _sync()
    t0 = time.perf_counter()
    _stage2_chain(C.conv1x1, *args)
    _sync()
    host_s = time.perf_counter() - t0   # an upper bound of one enqueue
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    iters = 10
    st = torch.cuda.Event(enable_timing=True)
    en = torch.cuda.Event(enable_timing=True)
    # a spin holds the card while the host enqueues the timed applications
    # (as bench_ms): device time, not the host's pace
    torch.cuda._sleep(int(min(2e9, (1.5 * host_s * iters + 2e-4) * SPIN_HZ)))
    st.record()
    for _ in range(iters):
        y, z, (mean, var, rstd) = _stage2_chain(C.conv1x1, *args)
    en.record()
    en.synchronize()
    counts = _read_counts()
    peak = torch.cuda.max_memory_allocated()
    ms = st.elapsed_time(en) / iters
    ry, rz, (rmean, rvar, _) = _stage2_chain(C.reference_conv1x1, *args)
    torch.cuda.synchronize()
    y_err = _half_ulp_err(y, ry, CONV_ATOL_REL)
    z_err = _half_ulp_err(z, rz, CHAIN_ATOL_REL)
    stats_err = _stats_err((mean, var), (rmean, rvar))
    res = {"model": "ResNet-50 stage 2 bottleneck boundary (torchvision "
           "resnet50: 64 -> 256 expand, 256 -> 64 reduce)",
           "shape": [n, c, 4 * c, p], "dtype": "bf16",
           "ms_per_application": ms, "applications": iters,
           "launches": counts,
           "launches_per_application": counts["conv1x1"] / iters,
           "peak_mem_gb": peak / 1e9, "y_err_ulps": y_err,
           "z_err_ulps": z_err, "bn_stats_rel_err": stats_err,
           "all_finite": bool(torch.isfinite(z.float()).all()),
           "bytes_per_application": 2 * (x0.numel() + 2 * y.numel()
                                         + r.numel() + z.numel())}
    res["ok"] = bool(counts["conv1x1"] == 2 * iters and y_err <= 1.0
                     and z_err <= 1.0 and stats_err <= CONV_STATS_RTOL
                     and res["all_finite"])
    RECORD["conv"] = res
    if not res["ok"]:
        raise AssertionError("conv failed: %s" % json.dumps(res))
    return res


def phase_rtc():
    """A user's runtime-compiled kernels: rtc.CudaModule compiles the
    source through NVRTC, get_kernel parses each signature, launch runs
    each over 2^26 floats (row_sum with a grid of rows, a block and
    dynamic shared memory); launch counts read around the launches."""
    import torch
    from mxnet_tpu_torch import rtc
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED + 3)
    _reset_counts()
    t0 = time.perf_counter()
    mod = rtc.CudaModule(RTC_SOURCE)
    kernels = {n: mod.get_kernel(n, sig) for n, sig in RTC_SIGS.items()}
    x = torch.randn(RTC_N, generator=gen, device=DEV)
    y = torch.randn(RTC_N, generator=gen, device=DEV)
    outs = {"scale_add": torch.empty_like(x), "negate": torch.empty_like(x),
            "row_sum": torch.empty(RTC_ROWS, device=DEV)}
    for name, dst in outs.items():
        _rtc_launch(kernels, name, x, y, dst)
    _sync()
    wall = time.perf_counter() - t0
    counts = _read_counts()
    refs = {"scale_add": x * 2.0 + y, "negate": -x,
            "row_sum": x.view(RTC_ROWS, -1).sum(1)}
    errs = {n: err_of(outs[n], refs[n]) for n in outs}
    res = {"kernels": list(outs), "n": RTC_N, "compile_and_run_s": wall,
           "launches": counts,
           "max_abs_err": {n: e for n, (e, _) in errs.items()},
           "tol": {n: t for n, (_, t) in errs.items()}}
    res["ok"] = bool(counts["rtc"] == len(outs)
                     and all(e <= t for e, t in errs.values()))
    RECORD["rtc"] = res
    if not res["ok"]:
        raise AssertionError("rtc failed: %s" % json.dumps(res))
    return res


def _free_card():
    import gc
    import torch
    gc.collect()
    if DEV == "cuda":
        torch.cuda.empty_cache()


def _rel_err(got, ref):
    """max |got - ref| over the reference's largest magnitude (numpy)."""
    import numpy as np
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(1e-30, np.abs(ref).max()))


def _ctx():
    import mxnet_tpu_torch as mx
    return mx.gpu(0) if DEV == "cuda" else mx.cpu()


def _lenet_iters(mx, shuffle):
    x, y = synthetic_mnist(LENET_N, SEED)
    split = LENET_N * 7 // 8
    import numpy as np
    np.random.seed(SEED)                # NDArrayIter shuffles by np.random
    train = mx.io.NDArrayIter(x[:split], y[:split], LENET_BATCH,
                              shuffle=shuffle, label_name="softmax_label")
    val = mx.io.NDArrayIter(x[split:], y[split:], LENET_BATCH,
                            label_name="softmax_label")
    return train, val


def phase_module_lenet():
    """examples/train_mnist.py's LeNet through Module.fit on the card
    (validation accuracy, seconds an epoch, samples/s), after its first
    LENET_CHECK_STEPS SGD steps are held against the port on the CPU from
    the same initial parameters."""
    import time
    import torch
    import mxnet_tpu_torch as mx
    _free_card()
    opt = {"learning_rate": LENET_LR, "momentum": 0.9,
           "rescale_grad": 1.0 / LENET_BATCH}
    # 1. card against CPU, unshuffled, from the CPU module's parameters
    train, _ = _lenet_iters(mx, shuffle=False)
    mods = []
    for ctx in (_ctx(), mx.cpu()):
        with mx.NameManager():
            m = mx.mod.Module(lenet_symbol(mx.sym), context=ctx)
        m.bind(data_shapes=train.provide_data,
               label_shapes=train.provide_label)
        mods.append(m)
    card, host = mods
    mx.random.seed(SEED)
    host.init_params(mx.init.Uniform(0.01))
    card.set_params(*host.get_params())
    for m in mods:
        m.init_optimizer(optimizer="sgd", optimizer_params=opt)
    batches = iter(train)
    for _ in range(LENET_CHECK_STEPS):
        b = next(batches)
        for m in mods:
            m.forward_backward(b)
            m.update()
    ca, ha = card.get_params()[0], host.get_params()[0]
    check = {n: _rel_err(ca[n].asnumpy(), ha[n].asnumpy()) for n in ha}
    del mods, card, host
    # 2. the example's fit, on the card
    train, val = _lenet_iters(mx, shuffle=True)
    with mx.NameManager():
        mod = mx.mod.Module(lenet_symbol(mx.sym), context=_ctx())
    epoch_t = []
    _reset_counts()
    t0 = time.perf_counter()
    mod.fit(train, eval_data=val, num_epoch=LENET_EPOCHS, optimizer="sgd",
            optimizer_params=opt, eval_metric="acc",
            batch_end_callback=mx.callback.Speedometer(LENET_BATCH, 10),
            epoch_end_callback=lambda *a: epoch_t.append(
                time.perf_counter()))
    fit_s = time.perf_counter() - t0
    counts = _read_counts()
    acc = mod.score(val, mx.metric.Accuracy())[0][1]
    n_train = LENET_N * 7 // 8 // LENET_BATCH * LENET_BATCH
    spans = [b - a for a, b in zip([t0] + epoch_t, epoch_t)]
    res = {"val_accuracy": float(acc), "bar": LENET_BAR,
           "epochs": LENET_EPOCHS, "fit_s": fit_s,
           "epoch_s": spans, "epoch_s_after_first": sum(spans[1:]) /
           max(1, len(spans) - 1),
           "samples_per_s": n_train * LENET_EPOCHS / fit_s,
           "samples_per_s_after_first": n_train * (len(spans) - 1) /
           max(1e-9, sum(spans[1:])),
           "check_steps": LENET_CHECK_STEPS, "check_rtol": MODULE_RTOL,
           "check_max_rel_err": max(check.values()), "check": check,
           "launches": counts,
           "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32}
    res["ok"] = bool(acc > LENET_BAR and res["check_max_rel_err"]
                     <= MODULE_RTOL
                     and not any(counts[k] for k in _wrappers()))
    RECORD["module_lenet"] = res
    if not res["ok"]:
        raise AssertionError("module_lenet failed: %s" % json.dumps(res))
    return res


def _init_bound(ex, mx, seed):
    """He-normal weights, zero biases and betas, unit gammas and
    variances, zero means, drawn on the host from ``seed``."""
    gen = __import__("torch").Generator().manual_seed(seed)
    init = mx.init.Xavier(rnd_type="gaussian", factor_type="in",
                          magnitude=2, generator=gen)
    attrs = ex._symbol.attr_dict()
    for name, arr in list(ex.arg_dict.items()) + list(ex.aux_dict.items()):
        if name in ("data", "softmax_label"):
            continue
        init(mx.init.InitDesc(name, attrs.get(name, {})), arr)


def _conv_tf32_check():
    """The stem convolution through the registered op (forward and the
    weight gradient) against float64, beside the same convolution with
    cuDNN's TF32 allowed (the control, which must break the bound)."""
    import torch
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops import registry
    gen = torch.Generator().manual_seed(SEED)
    x = torch.rand(R50_CHECK_BATCH, 3, R50_IMG, R50_IMG, generator=gen)
    w = torch.randn(64, 3, 7, 7, generator=gen) * 0.1
    dy = torch.randn(R50_CHECK_BATCH, 64, R50_IMG // 2, R50_IMG // 2,
                     generator=gen)
    ref_y = F.conv2d(x.double(), w.double(), None, 2, 3)
    ref_dw = torch.ops.aten.convolution_backward(
        dy.double(), x.double(), w.double(), None, [2, 2], [3, 3], [1, 1],
        False, [0, 0], 1, [False, True, False])[1]
    xc, wc, dyc = (t.to(DEV) for t in (x, w, dy))
    op = registry.get_op("Convolution")
    attrs = op.parse_attrs(dict(kernel=(7, 7), stride=(2, 2), pad=(3, 3),
                                num_filter=64, no_bias=True))
    wl = wc.clone().requires_grad_(True)
    y = op.fcompute(attrs, registry.OpCtx(is_train=True), xc, wl)[0]
    dw = torch.autograd.grad(y, wl, dyc)[0]
    res = {"y_err": _rel_err(y.detach().cpu(), ref_y),
           "dw_err": _rel_err(dw.cpu(), ref_dw),
           "y_rtol": CONV_F64_RTOL, "dw_rtol": CONV_F64_DW_RTOL,
           "cudnn_allow_tf32_default": torch.backends.cudnn.allow_tf32}
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        cy = F.conv2d(xc, wc, None, 2, 3)
        cdw = torch.ops.aten.convolution_backward(
            dyc, xc, wc, None, [2, 2], [3, 3], [1, 1], False, [0, 0], 1,
            [False, True, False])[1]
        _sync()
    finally:
        torch.backends.cudnn.allow_tf32 = old
    res["tf32_control_y_err"] = _rel_err(cy.cpu(), ref_y)
    res["tf32_control_dw_err"] = _rel_err(cdw.cpu(), ref_dw)
    return res


@contextlib.contextmanager
def _tf32_everywhere():
    """The control's precision: the port's per-call guard (``cudnn_f32``)
    off and TF32 allowed in cuDNN and cuBLAS, so every convolution and
    product of the step multiplies 10-bit mantissas."""
    import torch
    from mxnet_tpu_torch.ops import nn as nnops
    cd, mm = torch.backends.cudnn, torch.backends.cuda.matmul
    old = (cd.allow_tf32, mm.allow_tf32, nnops.cudnn_f32)
    nnops.cudnn_f32 = contextlib.nullcontext
    cd.allow_tf32 = mm.allow_tf32 = True
    try:
        yield
    finally:
        cd.allow_tf32, mm.allow_tf32, nnops.cudnn_f32 = old


def _f32_rule(card, cpu, ref):
    """A float32 step on the card against the same step on the CPU, each
    against the float64 step (R50_F32_FACTOR): the output's error, and
    the median and largest norm-wise error over the tensors."""
    import numpy as np
    norm = {who: {k: float(np.linalg.norm(t[k] - v)
                           / max(1e-30, np.linalg.norm(v)))
                  for k, v in ref.items()}
            for who, t in (("card", card), ("cpu", cpu))}
    out = {who: _rel_err(t["output"], ref["output"])
           for who, t in (("card", card), ("cpu", cpu))}
    med = {w: float(np.median(list(norm[w].values()))) for w in norm}
    top = {w: max(norm[w].values()) for w in norm}
    return {"output_err": out, "norm_err_median": med, "norm_err_max": top,
            "factor": R50_F32_FACTOR,
            "worst": sorted(((k, norm["card"][k], norm["cpu"][k])
                             for k in ref), key=lambda r: -r[1])[:4],
            "ok": bool(out["card"] <= R50_F32_FACTOR * out["cpu"]
                       + R50_F32_FLOOR
                       and med["card"] <= R50_F32_FACTOR * med["cpu"]
                       and top["card"] <= R50_F32_FACTOR * top["cpu"])}


def phase_module_resnet50():
    """ResNet-50 v1 trained through Module.fit on the card at bench.py's
    flagship configuration; beforehand the card's forward and backward at
    batch R50_CHECK_BATCH against the port on the CPU from the same
    parameters, and the stem convolution against float64 (no TF32)."""
    import time
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    import mxnet_tpu_torch as mx
    _free_card()
    res = {"batch": R50_BATCH, "image": R50_IMG, "dtype": "float32",
           "cudnn_allow_tf32_outside_calls": torch.backends.cudnn.allow_tf32,
           "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32}
    # 1. convolutions without TF32, against float64
    res["conv_f64"] = _conv_tf32_check()
    # 2. card against the port on the CPU at batch 2: float64 on both
    # (held tight), and float32 on both against the float64 step
    with mx.NameManager():
        sym = resnet_v1_symbol(mx.sym)
    shape = (R50_CHECK_BATCH, 3, R50_IMG, R50_IMG)
    rng = np.random.RandomState(SEED)
    xb = rng.uniform(0, 1, shape).astype(np.float32)
    yb = rng.randint(0, 1000, R50_CHECK_BATCH).astype(np.float32)
    host = sym.simple_bind(ctx=mx.cpu(), data=shape)
    _init_bound(host, mx, SEED)
    exs = {"cpu32": host}
    for key, ctx, dt in (("cpu64", mx.cpu(), "float64"),
                         ("card64", _ctx(), "float64"),
                         ("card32", _ctx(), "float32"),
                         ("card32_tf32", _ctx(), "float32")):
        ex = sym.simple_bind(ctx=ctx, data=shape, type_dict={
            n: dt for n in sym.list_arguments()})
        for a in ex.aux_dict.values():
            a._data = a._data.to(torch.float64 if dt == "float64"
                                 else torch.float32)
        ex.copy_params_from(host.arg_dict, host.aux_dict)
        exs[key] = ex
    for key, ex in exs.items():
        with (_tf32_everywhere() if key == "card32_tf32"
              else contextlib.nullcontext()):
            ex.forward(is_train=True, data=mx.nd.array(xb, ctx=mx.cpu()),
                       softmax_label=mx.nd.array(yb, ctx=mx.cpu()))
            ex.backward()

    def tensors(ex):
        out = {"output": ex.outputs[0]}
        out.update({"grad:" + n: g for n, g in ex.grad_dict.items()
                    if n not in ("data", "softmax_label")})
        out.update({"aux:" + n: a for n, a in ex.aux_dict.items()})
        return {k: v.asnumpy().astype(np.float64) for k, v in out.items()}
    t = {k: tensors(ex) for k, ex in exs.items()}
    ref = t["cpu64"]
    e64 = {k: _rel_err(t["card64"][k], v) for k, v in ref.items()}
    f32 = _f32_rule(t["card32"], t["cpu32"], ref)
    control = _f32_rule(t["card32_tf32"], t["cpu32"], ref)
    res["check"] = {
        "batch": R50_CHECK_BATCH, "tensors": len(ref),
        "f64_card_vs_cpu_max": max(e64.values()),
        "f64_rtol": R50_F64_RTOL,
        "f64_worst": sorted(e64.items(), key=lambda kv: -kv[1])[:4],
        "f32": f32, "tf32_control": control,
        "f32_card_vs_cpu_max_elem": max(
            _rel_err(t["card32"][k], t["cpu32"][k]) for k in ref)}
    res["check"]["ok"] = bool(max(e64.values()) <= R50_F64_RTOL
                              and f32["ok"] and not control["ok"])
    init_args = {n: a.copy() for n, a in host.arg_dict.items()
                 if n not in ("data", "softmax_label")}
    init_aux = {n: a.copy() for n, a in host.aux_dict.items()}
    del host, exs
    _free_card()
    # 3. Module.fit at batch 128 over an NDArrayIter of synthetic images
    n_steps = R50_WARMUP + R50_STEPS
    rng = np.random.RandomState(SEED)
    x = rng.uniform(0, 1, (n_steps * R50_BATCH, 3, R50_IMG, R50_IMG)) \
        .astype(np.float32)
    y = rng.randint(0, 1000, n_steps * R50_BATCH).astype(np.float32)
    it = mx.io.NDArrayIter(x, y, R50_BATCH, label_name="softmax_label")
    del x
    mod = mx.mod.Module(sym, context=_ctx())
    marks = []

    def on_batch(param):
        _sync()
        marks.append(time.perf_counter())
        if len(marks) == R50_WARMUP and DEV == "cuda":
            torch.cuda.reset_peak_memory_stats()

    metric = mx.metric.create(["acc", "ce"])
    _reset_counts()
    t0 = time.perf_counter()
    mod.fit(it, num_epoch=1, optimizer="sgd",
            optimizer_params={"learning_rate": R50_LR, "momentum": 0.9,
                              "rescale_grad": 1.0 / R50_BATCH},
            arg_params=init_args, aux_params=init_aux, eval_metric=metric,
            batch_end_callback=on_batch)
    counts = _read_counts()
    fit_s = time.perf_counter() - t0
    timed = marks[-1] - marks[R50_WARMUP - 1]
    step_s = timed / R50_STEPS
    peak = torch.cuda.max_memory_allocated() if DEV == "cuda" else 0
    names, vals = metric.get()
    train_ce = dict(zip(names, vals))["cross-entropy"]
    # 4. host against device: steps outside fit, the host's enqueue time
    # (forward_backward + update, before any sync) against the step
    batch = next(iter(it))
    host_ms, wall_ms = [], []
    for _ in range(3):
        _sync()
        a = time.perf_counter()
        mod.forward_backward(batch)
        mod.update()
        b = time.perf_counter()
        _sync()
        c = time.perf_counter()
        host_ms.append((b - a) * 1e3)
        wall_ms.append((c - a) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        mod.forward_backward(batch)
        mod.update()
        _sync()
    rows = _device_rows(prof, 1)
    dev_ms = sum(r[1] for r in rows)
    h2d = sum(r[1] for r in rows if "htod" in r[0].lower()
              or "memcpy hto" in r[0].lower())
    # the batch copy alone, by CUDA events: host batch (pinned) into the
    # bound array, as the executor's forward does it
    src = batch.data[0]._data
    dst = mod._exec.arg_dict["data"]._data
    copy_ms = 0.0
    if DEV == "cuda":
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        _sync()
        ev[0].record()
        for _ in range(5):
            dst.copy_(src, non_blocking=True)
        ev[1].record()
        _sync()
        copy_ms = ev[0].elapsed_time(ev[1]) / 5
    # 5. the host's own cost of a step: the same step at batch 2, where
    # the card's work is small, so the wall time is the host's dispatch
    # (at batch 128 the launch queue fills and the host waits on the card)
    small = mx.mod.Module(sym, context=_ctx())
    small.bind(data_shapes=[("data", shape)],
               label_shapes=[("softmax_label", (R50_CHECK_BATCH,))])
    small.set_params(init_args, init_aux)
    small.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": R50_LR, "momentum": 0.9,
        "rescale_grad": 1.0 / R50_BATCH})
    sb = mx.io.DataBatch([mx.nd.array(xb, ctx=mx.cpu())],
                         [mx.nd.array(yb, ctx=mx.cpu())])
    small_ms = []
    for i in range(R50_WARMUP + R50_STEPS):
        _sync()
        a = time.perf_counter()
        small.forward_backward(sb)
        small.update()
        _sync()
        if i >= R50_WARMUP:
            small_ms.append((time.perf_counter() - a) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        small.forward_backward(sb)
        small.update()
        _sync()
    small_dev = sum(r[1] for r in _device_rows(prof, 1))
    del small
    flops = step_flops("resnet50", sym, {
        "data": (R50_BATCH, 3, R50_IMG, R50_IMG),
        "softmax_label": (R50_BATCH,)}, 3 * 8.18e9 * R50_BATCH)
    res.update({
        "fit_s": fit_s, "step_ms": step_s * 1e3,
        "img_per_s": R50_BATCH / step_s,
        "step_ms_each": [(b - a) * 1e3 for a, b in zip(marks, marks[1:])],
        "train_ce": float(train_ce), "loss_finite": bool(
            np.isfinite(train_ce)),
        "peak_mem_gb": peak / 1e9,
        "host_enqueue_ms": host_ms, "step_wall_ms": wall_ms,
        "device_ms_per_step": dev_ms,
        "device_busy_share": dev_ms / float(np.median(wall_ms)),
        "h2d_copy_ms": h2d, "h2d_share": h2d / max(1e-9, dev_ms),
        "batch_copy_event_ms": copy_ms,
        "batch_copy_share": copy_ms / (step_s * 1e3),
        "batch_pinned": bool(src.is_pinned()),
        "flop_per_step": flops,
        "fp32_bound_ms": flops / PEAK_F32_FLOPS * 1e3,
        "flop_share_of_fp32_peak": flops / step_s / PEAK_F32_FLOPS,
        "top": [{"kernel": k[:100], "ms_per_step": t, "calls": c}
                for k, t, c in rows[:12]],
        "kernels_a_step": sum(r[2] for r in rows),
        "host_step_ms_batch2": small_ms,
        "device_ms_batch2": small_dev,
        "launches": counts,
        "params": len(mod._param_names)})
    res["ok"] = bool(res["loss_finite"] and res["check"]["ok"]
                     and res["conv_f64"]["y_err"] <= CONV_F64_RTOL
                     and res["conv_f64"]["dw_err"] <= CONV_F64_DW_RTOL
                     and not any(counts[k] for k in _wrappers()))
    RECORD["module_resnet50"] = res
    del mod, it
    _free_card()
    if not res["ok"]:
        raise AssertionError("module_resnet50 failed: %s"
                             % json.dumps(res, default=str)[:4000])
    return res


def _gluon_r50(mx, params=None, ctx=None, dtype=None):
    """The model zoo's resnet50_v1 (1000 classes), its parameters
    ``params`` (numpy, by name) installed on ``ctx``, cast to ``dtype``,
    hybridized."""
    from mxnet_tpu_torch.convert import load_gluon_params
    net = mx.gluon.model_zoo.vision.resnet50_v1(classes=1000,
                                                prefix="resnetv10_")
    if params is not None:
        load_gluon_params(net, params, ctx=ctx)
    if dtype is not None:
        net.cast(dtype)
    net.hybridize()
    return net


def _gluon_r50_init(mx):
    """resnet50_v1's parameters (numpy, by name) drawn on the host from
    the seed (He-normal, as module_resnet50), deferred shapes finished by
    one forward."""
    import numpy as np
    import torch
    from mxnet_tpu_torch.convert import gluon_params_to_numpy
    mx.random.seed(SEED)
    gen = torch.Generator().manual_seed(SEED)
    host = mx.gluon.model_zoo.vision.resnet50_v1(classes=1000,
                                                 prefix="resnetv10_")
    host.initialize(mx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                   magnitude=2, generator=gen),
                    ctx=mx.cpu())
    host(mx.nd.array(np.zeros((1, 3, 32, 32), np.float32), ctx=mx.cpu()))
    return gluon_params_to_numpy(host)


def _gluon_trainer(mx, net):
    return (mx.gluon.Trainer(net.collect_params(), "sgd",
                             {"learning_rate": R50_LR, "momentum": 0.9}),
            mx.gluon.loss.SoftmaxCrossEntropyLoss())


def _gluon_check_step(mx, net, xb, yb, ctx, dtype):
    """A whole batch-2 step's tensors (numpy float64): the output, every
    gradient, the moving statistics after the forward, every parameter
    after the update."""
    import numpy as np
    trainer, loss_fn = _gluon_trainer(mx, net)
    x = mx.nd.array(xb, ctx=ctx, dtype=dtype)
    y = mx.nd.array(yb, ctx=ctx, dtype=dtype)
    with mx.autograd.record():
        out = net(x)
        loss = loss_fn(out, y)
    loss.backward()
    params = net.collect_params()
    t = {"output": out.asnumpy()}
    t.update({"grad:" + n: p.grad().asnumpy() for n, p in params.items()
              if p.grad_req != "null"})
    t.update({"aux:" + n: p.data().asnumpy() for n, p in params.items()
              if p.grad_req == "null"})
    trainer.step(R50_CHECK_BATCH)
    t.update({"param:" + n: p.data().asnumpy() for n, p in params.items()
              if p.grad_req != "null"})
    return {k: np.asarray(v, np.float64) for k, v in t.items()}


def phase_gluon_resnet50():
    """ResNet-50 v1 of the model zoo trained through hybridized Gluon on
    the card at bench.py's flagship configuration, after a whole batch-2
    step held against the port on the CPU (float64 and float32)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    import mxnet_tpu_torch as mx
    _free_card()
    res = {"batch": R50_BATCH, "image": R50_IMG, "dtype": "float32",
           "model": "gluon.model_zoo.vision.resnet50_v1(classes=1000)",
           "hybridized": True}
    # 1. parameters drawn on the host (He-normal, as module_resnet50)
    init = _gluon_r50_init(mx)
    # 2. a whole step at batch 2: card against the CPU
    rng = np.random.RandomState(SEED)
    shape = (R50_CHECK_BATCH, 3, R50_IMG, R50_IMG)
    xb = rng.uniform(0, 1, shape).astype(np.float32)
    yb = rng.randint(0, 1000, R50_CHECK_BATCH).astype(np.float32)
    t = {}
    for key, ctx, dt in (("cpu64", mx.cpu(), "float64"),
                         ("card64", _ctx(), "float64"),
                         ("cpu32", mx.cpu(), "float32"),
                         ("card32", _ctx(), "float32"),
                         ("card32_tf32", _ctx(), "float32")):
        net = _gluon_r50(mx, init, ctx, dt)
        with (_tf32_everywhere() if key == "card32_tf32"
              else contextlib.nullcontext()):
            t[key] = _gluon_check_step(mx, net, xb, yb, ctx, dt)
        del net
        _free_card()
    ref = t["cpu64"]
    e64 = {k: _rel_err(t["card64"][k], v) for k, v in ref.items()}
    f32 = _f32_rule(t["card32"], t["cpu32"], ref)
    control = _f32_rule(t["card32_tf32"], t["cpu32"], ref)
    res["check"] = {
        "batch": R50_CHECK_BATCH, "tensors": len(ref),
        "f64_card_vs_cpu_max": max(e64.values()), "f64_rtol": R50_F64_RTOL,
        "f64_worst": sorted(e64.items(), key=lambda kv: -kv[1])[:4],
        "f32": f32, "tf32_control": control}
    res["check"]["ok"] = bool(max(e64.values()) <= R50_F64_RTOL
                              and f32["ok"] and not control["ok"])
    del t
    # 3. training at batch 128 on data made on the card
    net = _gluon_r50(mx, init, _ctx())
    g = torch.Generator(device=DEV).manual_seed(SEED)
    x = mx.nd.NDArray(torch.rand((R50_BATCH, 3, R50_IMG, R50_IMG),
                                 generator=g, device=DEV))
    y = mx.nd.NDArray(torch.randint(0, 1000, (R50_BATCH,), generator=g,
                                    device=DEV).float())
    losses = []
    trainer, loss_fn = _gluon_trainer(mx, net)

    def step():
        with mx.autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        trainer.step(R50_BATCH)
        return loss

    for _ in range(GLUON_R50_WARMUP):
        losses.append(step().mean())
    _sync()
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    marks = [time.perf_counter()]
    for _ in range(GLUON_R50_STEPS):
        losses.append(step().mean())
        _sync()
        marks.append(time.perf_counter())
    counts = _read_counts()
    peak = torch.cuda.max_memory_allocated() if DEV == "cuda" else 0
    step_ms = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    mean_ms = (marks[-1] - marks[0]) * 1e3 / GLUON_R50_STEPS
    # 4. host against device: the host's enqueue time of a step (before
    # any sync) against its wall time, and a profiled step's device time
    host_ms, wall_ms = [], []
    for _ in range(3):
        _sync()
        a = time.perf_counter()
        step()
        b = time.perf_counter()
        _sync()
        host_ms.append((b - a) * 1e3)
        wall_ms.append((time.perf_counter() - a) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        _sync()
    rows = _device_rows(prof, 1)
    dev_ms = sum(r[1] for r in rows)
    # 5. the host's own cost of a step: the same step at batch 2, where
    # the card's work is small (at batch 128 the launch queue fills and
    # the host waits on the card)
    xs = mx.nd.NDArray(x._data[:R50_CHECK_BATCH].contiguous())
    ys = mx.nd.NDArray(y._data[:R50_CHECK_BATCH].contiguous())
    small_ms = []
    for i in range(R50_WARMUP + R50_STEPS):
        _sync()
        a = time.perf_counter()
        with mx.autograd.record():
            loss = loss_fn(net(xs), ys)
        loss.backward()
        trainer.step(R50_BATCH)
        _sync()
        if i >= R50_WARMUP:
            small_ms.append((time.perf_counter() - a) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with mx.autograd.record():
            loss = loss_fn(net(xs), ys)
        loss.backward()
        trainer.step(R50_BATCH)
        _sync()
    small_dev = sum(r[1] for r in _device_rows(prof, 1))
    losses = [float(v.asnumpy()) for v in losses]
    flops = step_flops("resnet50", resnet_v1_symbol(mx.sym), {
        "data": (R50_BATCH, 3, R50_IMG, R50_IMG),
        "softmax_label": (R50_BATCH,)}, 3 * 8.18e9 * R50_BATCH)
    module_ips = RECORD.get("module_resnet50", {}).get("img_per_s")
    res.update({
        "step_ms": mean_ms, "step_ms_each": step_ms,
        "img_per_s": R50_BATCH / mean_ms * 1e3,
        "module_fit_img_per_s_same_run": module_ips,
        "losses": losses,
        "loss_finite": all(math.isfinite(v) for v in losses),
        "peak_mem_gb": peak / 1e9,
        "host_enqueue_ms": host_ms, "step_wall_ms": wall_ms,
        "device_ms_per_step": dev_ms,
        "device_busy_share": dev_ms / float(np.median(wall_ms)),
        "flop_per_step": flops,
        "fp32_bound_ms": flops / PEAK_F32_FLOPS * 1e3,
        "top": [{"kernel": k[:100], "ms_per_step": ms, "calls": c}
                for k, ms, c in rows[:12]],
        "kernels_a_step": sum(r[2] for r in rows),
        "host_step_ms_batch2": small_ms, "device_ms_batch2": small_dev,
        "params": len(net.collect_params()),
        "launches": counts})
    res["ok"] = bool(res["loss_finite"] and res["check"]["ok"])
    RECORD["gluon_resnet50"] = res
    del net, x, y, xs, ys
    _free_card()
    if not res["ok"]:
        raise AssertionError("gluon_resnet50 failed: %s"
                             % json.dumps(res, default=str)[:4000])
    return res


def phase_gluon_cifar():
    """examples/gluon_cifar.py's program on the card through the port:
    its source with ``mxnet_tpu`` imported as ``mxnet_tpu_torch`` and
    ``mx.gpu()`` where it says ``mx.tpu()``, its own arguments (resnet18_v1,
    10 classes, batch 32, 32 x 32, Xavier(magnitude=2), hybridized, SGD
    0.05 / 0.9, 30 steps); its own bar: accuracy above 0.9."""
    import io
    path = os.path.join(HERE, "examples", "gluon_cifar.py")
    with open(path) as f:
        src = f.read()
    for a, b in (("import mxnet_tpu as mx", "import mxnet_tpu_torch as mx"),
                 ("from mxnet_tpu import", "from mxnet_tpu_torch import"),
                 ("mx.tpu()", "mx.gpu()" if DEV == "cuda" else "mx.cpu()")):
        if a not in src:
            raise AssertionError("examples/gluon_cifar.py has no %r" % a)
        src = src.replace(a, b)
    argv, sys.argv = sys.argv, [path]
    buf = io.StringIO()
    _reset_counts()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            exec(compile(src, path, "exec"), {"__name__": "__main__",
                                              "__file__": path})
        code = 0
    except SystemExit as e:
        code = e.code
    finally:
        sys.argv = argv
    seconds = time.perf_counter() - t0
    lines = buf.getvalue().strip().splitlines()
    acc = float(lines[-1].split("acc")[-1]) if lines else float("nan")
    res = {"program": "examples/gluon_cifar.py", "exit_code": code,
           "lines": lines, "final_acc": acc, "bar": CIFAR_BAR,
           "seconds": seconds, "launches": _read_counts()}
    res["ok"] = bool(code == 0 and acc > CIFAR_BAR)
    RECORD["gluon_cifar"] = res
    _free_card()
    if not res["ok"]:
        raise AssertionError("gluon_cifar failed: %s" % json.dumps(res))
    return res


def _glm_run(mx, init, hybrid, x, y):
    """The LM (GLM_LAYERS layers at GPT-2 medium's widths) from ``init``
    (numpy by name, for the encoder and the head), trained GLM_WARMUP +
    GLM_STEPS steps with Adam: (losses, launches of the steps after
    warm-up, step seconds, parameters after as host tensors, graphs
    traced)."""
    from mxnet_tpu_torch.convert import load_gluon_params
    cfg = dict(TRAIN, num_layers=GLM_LAYERS)
    net = mx.gluon.nn.TransformerEncoder(**cfg, prefix="lm_")
    head = mx.gluon.nn.Dense(cfg["vocab_size"], flatten=False,
                             prefix="head_")
    for block in (net, head):
        load_gluon_params(block, {n: init[n] for n in
                                  block.collect_params().keys()},
                          ctx=_ctx())
        if hybrid:
            block.hybridize()
    params = {**net.collect_params(), **head.collect_params()}
    trainer = mx.gluon.Trainer(params, "adam", {"learning_rate": TRAIN_LR})
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    losses, step_s = [], []
    for i in range(GLM_WARMUP + GLM_STEPS):
        if i == GLM_WARMUP:
            _sync()
            _reset_counts()
        t0 = time.perf_counter()
        with mx.autograd.record():
            logits = head(net(x))
            loss = loss_fn(logits.reshape((-3, 0)),
                           y.reshape((-1,))).mean()
        loss.backward()
        trainer.step(1)
        losses.append(float(loss.asnumpy()))
        if i >= GLM_WARMUP:
            step_s.append(time.perf_counter() - t0)
    counts = _read_counts()
    after = {n: p.data()._data.detach().to("cpu", copy=True)
             for n, p in params.items()}
    graphs = sum(1 for b in (net, head) if b._cached_graph)
    del net, head, params, trainer
    _free_card()
    return losses, counts, step_s, after, graphs


# the LM's parameters and its hybridized losses, kept by gluon_lm_hybrid
# for gluon_fused_lm's check
_GLM_REF = {}


def _glm_init(mx):
    """The LM's parameters (numpy by name, for the encoder and the head),
    drawn on the card from the seed, and its batch (x, y) as NDArrays."""
    from mxnet_tpu_torch.convert import gluon_params_to_numpy
    cfg = dict(TRAIN, num_layers=GLM_LAYERS)
    mx.random.seed(SEED)
    net = mx.gluon.nn.TransformerEncoder(**cfg, prefix="lm_")
    head = mx.gluon.nn.Dense(cfg["vocab_size"], flatten=False,
                             prefix="head_")
    net.initialize(mx.init.Xavier(), ctx=_ctx())
    head.initialize(mx.init.Xavier(), ctx=_ctx())
    x, y = _lm_batch()
    x, y = mx.nd.NDArray(x), mx.nd.NDArray(y)
    head(net(x[:1]))                    # finish the head's deferred shape
    init = gluon_params_to_numpy(net)
    init.update(gluon_params_to_numpy(head))
    del net, head
    _free_card()
    return init, x, y


def phase_gluon_lm_hybrid():
    """The causal LM of examples/transformer_lm.py at GPT-2 medium's
    widths trained hybridized (the attention through
    _contrib_flash_attention in the executor's walk), held against the
    same net run eagerly from the same parameters."""
    import numpy as np
    import torch
    import mxnet_tpu_torch as mx
    _free_card()
    cfg = dict(TRAIN, num_layers=GLM_LAYERS)
    init, x, y = _glm_init(mx)
    hyb = _glm_run(mx, init, True, x, y)
    _GLM_REF.update(init=init, losses=hyb[0])
    eag = _glm_run(mx, init, False, x, y)
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(hyb[0], eag[0]))
    norm_err = {n: float((hyb[3][n] - eag[3][n]).norm()
                         / max(float(eag[3][n].norm()), 1e-30))
                for n in eag[3]}
    elem_err = {n: float((hyb[3][n] - eag[3][n]).abs().max()
                         / max(float(eag[3][n].abs().max()), 1e-30))
                for n in eag[3]}
    want = GLM_LAYERS * GLM_STEPS
    counts = hyb[1]
    res = {"model": dict(cfg, head="Dense(vocab, flatten=False)"),
           "batch": TRAIN_BATCH, "tokens_per_step": TRAIN_BATCH
           * cfg["max_length"], "steps": GLM_STEPS, "warmup": GLM_WARMUP,
           "losses_hybrid": hyb[0], "losses_eager": eag[0],
           "loss_rel_err": loss_err,
           "param_norm_rel_err_max": max(norm_err.values()),
           "param_worst": sorted(norm_err.items(),
                                 key=lambda kv: -kv[1])[:4],
           "param_elem_rel_err_max": max(elem_err.values()),
           "rtol": GLM_RTOL, "graphs_traced": hyb[4],
           "step_s_hybrid": hyb[2], "step_s_eager": eag[2],
           "launches": counts, "launches_eager": eag[1],
           "launches_want_each": want,
           "finite": bool(all(np.isfinite(hyb[0]))
                          and all(bool(torch.isfinite(t).all())
                                  for t in hyb[3].values()))}
    flash = ("flash_attention_fwd", "flash_attention_bwd_dq",
             "flash_attention_bwd_dkv")
    res["ok"] = bool(res["finite"] and hyb[4] == 2
                     and loss_err <= GLM_RTOL
                     and res["param_norm_rel_err_max"] <= GLM_RTOL
                     and all(counts[k] == want for k in flash)
                     and all(eag[1][k] == want for k in flash)
                     and counts["dense_attention"] == 0)
    RECORD["gluon_lm_hybrid"] = res
    del hyb, eag
    _free_card()
    if not res["ok"]:
        raise AssertionError("gluon_lm_hybrid failed: %s"
                             % json.dumps(res, default=str)[:4000])
    return res


@contextlib.contextmanager
def _watch_step_k():
    """Every DataParallelTrainer.step_k call of the enclosed code, as
    fused_fit makes them: its trainer, its block's K, its losses, the
    host's time in the call (the enqueue of K replays, nothing synced) and
    CUDA events around it (the block's device time: the event before it
    fires when the work queued ahead of it is done)."""
    import torch
    from mxnet_tpu_torch.parallel import dp
    real = dp.DataParallelTrainer.step_k
    calls = []

    def watched(self, params, states, aux, inputs, *a, **kw):
        evs = [torch.cuda.Event(enable_timing=True) for _ in range(2)] \
            if DEV == "cuda" else None
        if evs:
            evs[0].record()
        t0 = time.perf_counter()
        out = real(self, params, states, aux, inputs, *a, **kw)
        host = time.perf_counter() - t0
        if evs:
            evs[1].record()
        calls.append({"trainer": self, "k": int(inputs[0].shape[0]),
                      "losses": out[3], "host_ms": host * 1e3,
                      "start": t0, "events": evs})
        return out
    dp.DataParallelTrainer.step_k = watched
    try:
        yield calls
    finally:
        dp.DataParallelTrainer.step_k = real


def _block_device_ms(call):
    return call["events"][0].elapsed_time(call["events"][1]) \
        if call["events"] else 0.0


def _host_params(net):
    """Every parameter and aux state of a Gluon net as a host tensor."""
    return {n: p.data()._data.detach().to("cpu", copy=True)
            for n, p in net.collect_params().items()}


def _norm_errs(got, ref):
    """name -> ||got - ref|| / ||ref|| (float64)."""
    return {n: float((got[n].double() - ref[n].double()).norm()
                     / max(float(ref[n].double().norm()), 1e-30))
            for n in ref}


def _gluon_fit(mx, net, data, epochs, k, callback=None, optimizer="sgd",
               optimizer_params=None, **kw):
    """gluon.trainer.fused_fit of ``net`` on SoftmaxCrossEntropyLoss
    over ``data`` (``kw``: its other options); by default SGD as bench.py
    trains (lr 0.05, momentum 0.9). The loader's batches and the fit's
    mesh follow the current context, ``_ctx()``."""
    with _ctx():
        return mx.gluon.trainer.fused_fit(
            net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), data, epochs,
            optimizer=optimizer, optimizer_params=optimizer_params or {
                "learning_rate": R50_LR, "momentum": 0.9},
            steps_per_dispatch=k, epoch_callback=callback, **kw)


def phase_gluon_fused_resnet50():
    """ResNet-50 v1 of the model zoo through gluon.trainer.fused_fit on
    the card at bench.py's flagship configuration, fed by a
    gluon.data.DataLoader: K = 4 against K = 1, and 2 fused steps against
    2 steps of the hybridized Trainer loop, then the timed fit."""
    import numpy as np
    import torch
    import mxnet_tpu_torch as mx
    _free_card()
    init = _gluon_r50_init(mx)
    res = {"model": "gluon.model_zoo.vision.resnet50_v1(classes=1000)",
           "batch": R50_BATCH, "image": R50_IMG, "dtype": "float32",
           "k": GFUSED_K, "batches": GFUSED_BATCHES,
           "epochs": GFUSED_EPOCHS}
    # 1. fusing and the loop against each other at a small batch, from
    # the same parameters, with cuDNN's deterministic algorithms
    b = GFUSED_CHECK_BATCH
    rng = np.random.RandomState(SEED)
    xs = rng.uniform(0, 1, (GFUSED_K * b, 3, R50_IMG, R50_IMG)) \
        .astype(np.float32)
    ys = rng.randint(0, 1000, GFUSED_K * b).astype(np.float32)
    runs = {}
    with _cudnn_deterministic():
        for k in (1, GFUSED_K):
            net = _gluon_r50(mx, init, _ctx())
            loader = mx.gluon.data.DataLoader(
                mx.gluon.data.ArrayDataset(xs, ys), batch_size=b)
            with _watch_step_k() as calls:
                losses = _gluon_fit(mx, net, loader, 1, k)
            runs[k] = (_host_params(net), losses, calls[0]["trainer"]
                       .captures, [c["k"] for c in calls])
            del net, calls
            _free_card()
        # 2 fused steps and 2 steps of the loop
        two = [(mx.nd.array(xs[i * b:(i + 1) * b], ctx=_ctx()),
                mx.nd.array(ys[i * b:(i + 1) * b], ctx=_ctx()))
               for i in range(2)]
        net = _gluon_r50(mx, init, _ctx())
        _gluon_fit(mx, net, two, 1, 2)
        fused = _host_params(net)
        del net
        _free_card()
        net = _gluon_r50(mx, init, _ctx())
        trainer, loss_fn = _gluon_trainer(mx, net)
        for xb, yb in two:
            with mx.autograd.record():
                loss = loss_fn(net(xb), yb)
            loss.backward()
            trainer.step(b)
        loop = _host_params(net)
        del net, trainer, two
        _free_card()
    stepk = {n: _rel_err(runs[GFUSED_K][0][n].numpy(), v.numpy())
             for n, v in runs[1][0].items()}
    vs_loop = _norm_errs(fused, loop)
    res["check"] = {
        "batch": b, "k1_vs_k": max(stepk.values()),
        "k1_vs_k_loss": abs(runs[GFUSED_K][1][0] - runs[1][1][0])
        / abs(runs[1][1][0]), "stepk_rtol": GFUSED_STEPK_RTOL,
        "blocks": {k: r[3] for k, r in runs.items()},
        "captures": {k: r[2] for k, r in runs.items()},
        "fused_vs_loop_norm_max": max(vs_loop.values()),
        "fused_vs_loop_worst": sorted(vs_loop.items(),
                                      key=lambda kv: -kv[1])[:4],
        "fused_vs_loop_rtol": GFUSED_LOOP_RTOL, "tensors": len(vs_loop)}
    res["check"]["ok"] = bool(
        res["check"]["k1_vs_k"] <= GFUSED_STEPK_RTOL
        and res["check"]["k1_vs_k_loss"] <= GFUSED_STEPK_RTOL
        and res["check"]["fused_vs_loop_norm_max"] <= GFUSED_LOOP_RTOL
        and all(c == (1 if DEV == "cuda" else 0)
                for c in res["check"]["captures"].values()))
    del runs, fused, loop
    # 2. the timed fit: GFUSED_BATCHES batches of synthetic images from
    # RandomState(SEED) through a DataLoader of an ArrayDataset, read in
    # this thread (the phase's reading, its launches counted), then read
    # ahead by GFUSED_WORKERS thread workers
    n = GFUSED_BATCHES * R50_BATCH
    x = np.empty((n, 3, R50_IMG, R50_IMG), np.float32)
    for i in range(GFUSED_BATCHES):
        x[i * R50_BATCH:(i + 1) * R50_BATCH] = rng.uniform(
            0, 1, (R50_BATCH, 3, R50_IMG, R50_IMG))
    y = rng.randint(0, 1000, n).astype(np.float32)
    dataset = mx.gluon.data.ArrayDataset(x, y)
    _reset_counts()
    fit, tr = _r50_timed_fit(mx, init, dataset, 0)
    counts = _read_counts()
    res.update(fit)
    res.update({
        "module_fit_img_per_s_same_run":
            RECORD.get("module_resnet50", {}).get("img_per_s"),
        "gluon_hybrid_img_per_s_same_run":
            RECORD.get("gluon_resnet50", {}).get("img_per_s"),
        "captures": tr.captures, "graphs": tr.graph_stats(),
        "launches": counts})
    del tr
    _free_card()
    threaded, tr = _r50_timed_fit(mx, init, dataset, GFUSED_WORKERS)
    res["thread_workers"] = dict(threaded, workers=GFUSED_WORKERS,
                                 captures=tr.captures)
    res["ok"] = bool(res["check"]["ok"] and res["losses_finite"]
                     and threaded["losses_finite"]
                     and res["captures"] == (1 if DEV == "cuda" else 0)
                     and tr.captures == res["captures"]
                     and not any(counts[k] for k in _wrappers()))
    RECORD["gluon_fused_resnet50"] = res
    del tr, dataset, x, y
    _free_card()
    if not res["ok"]:
        raise AssertionError("gluon_fused_resnet50 failed: %s"
                             % json.dumps(res, default=str)[:4000])
    return res


def _r50_timed_fit(mx, init, dataset, workers):
    """resnet50_v1 from ``init`` fused-fit for GFUSED_EPOCHS epochs over a
    DataLoader of ``dataset`` with ``workers`` thread workers: (timings of
    the last epoch, the trainer)."""
    import torch
    loader = mx.gluon.data.DataLoader(dataset, batch_size=R50_BATCH,
                                      num_workers=workers)
    net = _gluon_r50(mx, init, _ctx())
    marks = []
    _sync()
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _watch_step_k() as calls:
        losses = _gluon_fit(mx, net, loader, GFUSED_EPOCHS, GFUSED_K,
                            lambda e, _n, _l: marks.append(
                                time.perf_counter()))
    peak = torch.cuda.max_memory_allocated() if DEV == "cuda" else 0
    last = calls[-(len(calls) // GFUSED_EPOCHS):]
    epoch_s = [b - a for a, b in zip([t0] + marks, marks)]
    dev_ms = sum(_block_device_ms(c) for c in last)
    steps = sum(c["k"] for c in last)
    fit = {
        "epoch_losses": losses, "epoch_s": epoch_s,
        "img_per_s": steps * R50_BATCH / epoch_s[-1],
        "step_ms": epoch_s[-1] * 1e3 / steps,
        "device_ms_per_step": dev_ms / steps,
        "host_enqueue_ms_per_step": sum(c["host_ms"] for c in last) / steps,
        "device_busy_share": dev_ms / (epoch_s[-1] * 1e3),
        "idle_ms_last_epoch": epoch_s[-1] * 1e3 - dev_ms,
        # the loader stacking, pinning and copying the epoch's first block
        # while the card has nothing queued
        "fill_ms_last_epoch": (last[0]["start"] - marks[-2]) * 1e3,
        "blocks": [c["k"] for c in calls],
        "host_enqueue_ms_each": [c["host_ms"] for c in calls],
        "device_ms_each": [_block_device_ms(c) for c in calls],
        "peak_mem_gb": peak / 1e9,
        "losses_finite": bool(all(math.isfinite(v) for v in losses))}
    tr = calls[0]["trainer"]
    del net, calls, loader
    return fit, tr


def _glm_net(mx, init, layers):
    """The LM (encoder and head in one hybridized HybridSequential) at
    ``layers`` layers of GPT-2 medium's widths, from ``init``."""
    from mxnet_tpu_torch.convert import load_gluon_params
    cfg = dict(TRAIN, num_layers=layers)
    enc = mx.gluon.nn.TransformerEncoder(**cfg, prefix="lm_")
    head = mx.gluon.nn.Dense(cfg["vocab_size"], flatten=False,
                             prefix="head_")
    for block in (enc, head):
        load_gluon_params(block, {n: init[n] for n in
                                  block.collect_params().keys()},
                          ctx=_ctx())
    net = mx.gluon.nn.HybridSequential()
    net.add(enc, head)
    net.hybridize()
    return net


def _glm_fused_run(mx, init, x, y, layers, steps=GFLM_STEPS, epochs=2,
                   keep_params=False, **fit_kw):
    """The LM through fused_fit(steps_per_dispatch=GFLM_K) with Adam on
    ``steps`` batches an epoch: (record, the trainer, the step_k calls,
    the parameters after as host tensors when ``keep_params``).
    The record holds the step losses, step and device time, host
    enqueue, captures, the replays and each kernel's launches a replay
    (by dtype too), peak memory and the launch counters."""
    import torch
    net = _glm_net(mx, init, layers)
    data = [(x, y)] * steps
    marks = []
    _sync()
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    with _watch_step_k() as calls:
        epoch_losses = _gluon_fit(
            mx, net, data, epochs, GFLM_K,
            lambda e, _n, _l: marks.append(time.perf_counter()),
            optimizer="adam",
            optimizer_params={"learning_rate": TRAIN_LR}, **fit_kw)
    counts = _read_counts()
    peak = torch.cuda.max_memory_allocated() if DEV == "cuda" else 0
    tr = calls[0]["trainer"]
    step_losses = [float(v) / TRAIN_BATCH for c in calls
                   for v in c["losses"].cpu()]
    per_epoch = max(1, len(calls) // epochs)
    last = calls[-per_epoch:]
    epoch_s = [b_ - a_ for a_, b_ in zip([t0] + marks, marks)]
    graphs = tr.graph_stats()
    per_replay = {}
    replays = 0
    for g in graphs["graphs"].values():
        replays += g["replays"]
        for kname, v in g["launches"].items():
            per_replay[kname] = per_replay.get(kname, 0) + v
    replayed = {kname: per_replay.get(kname, 0) * replays
                for kname in _FLASH}
    cfg = dict(TRAIN, num_layers=layers)
    res = {"model": dict(cfg, head="Dense(vocab, flatten=False)",
                         wrapped="HybridSequential(encoder, head)"),
           "batch": TRAIN_BATCH, "tokens_per_step": TRAIN_BATCH
           * cfg["max_length"], "k": GFLM_K, "optimizer": "adam",
           "step_losses": step_losses, "epoch_losses": epoch_losses,
           "blocks": [c["k"] for c in calls], "epoch_s": epoch_s,
           "step_s": epoch_s[-1] / sum(c["k"] for c in last),
           "device_ms_per_step": sum(_block_device_ms(c) for c in last)
           / sum(c["k"] for c in last),
           "host_enqueue_ms_per_step": sum(c["host_ms"] for c in last)
           / sum(c["k"] for c in last),
           "host_enqueue_ms_each": [c["host_ms"] for c in calls],
           "device_ms_each": [_block_device_ms(c) for c in calls],
           "device_busy_share": sum(_block_device_ms(c) for c in last)
           / max(epoch_s[-1] * 1e3, 1e-9),
           "captures": tr.captures, "graphs": graphs,
           "replays": replays, "launches_a_replay": per_replay,
           "launches_replayed": replayed,
           "launches_replayed_want_each": layers * replays,
           "layers": layers, "peak_mem_gb": peak / 1e9, "launches": counts,
           "finite": bool(all(math.isfinite(v) for v in step_losses))}
    params = _host_params(net) if keep_params else None
    del net
    return res, tr, calls, params


_FLASH = ("flash_attention_fwd", "flash_attention_bwd_dq",
          "flash_attention_bwd_dkv")


def _flash_replays_ok(res, tr, dtype=None):
    """One capture, and each flash kernel launched ``layers`` times a
    replay over every replay (in ``dtype`` alone when given: its
    ``name[dtype]`` launches a replay are all of them), no dense call."""
    per = res["launches_a_replay"]
    layers = res["layers"]
    ok = tr.captures == (1 if DEV == "cuda" else 0) \
        and res["replays"] == len(res["step_losses"]) \
        and all(res["launches_replayed"][k] == layers * res["replays"]
                for k in _FLASH) \
        and res["launches"]["dense_attention"] == 0
    if dtype is not None:
        ok = ok and all(per.get("%s[%s]" % (k, dtype), 0) == per.get(k, 0)
                        == layers for k in _FLASH)
    return bool(ok)


def _kernel_group(name):
    """The device-time group of a kernel of the LM's step: the flash
    kernels; GEMMs on the tensor cores (cuBLAS's bf16 CUTLASS kernels and
    its Hopper ``nvjet`` kernels) or on the FP32 pipes (SIMT sgemm and
    the ``f32f32`` FFMA kernels); dtype casts and copies; the other
    elementwise kernels (Adam, residuals, ReLU, LayerNorm's pieces); the
    rest."""
    n = name.lower()
    for g in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        if g in n:
            return g
    if "nvjet" in n or ("gemm" in n and ("bf16" in n or "s1688" in n
                                         or "s16816" in n)):
        return "gemm_tensor_core"
    if "gemm" in n or "cutlass" in n:
        return "gemm_f32_simt" if ("sgemm" in n or "simt" in n
                                   or "f32f32" in n) else "gemm_other"
    if "copy" in n or "memcpy" in n:
        return "cast_copy"
    if "elementwise" in n or "reduce" in n:
        return "elementwise_reduce"
    return "other"


def _replay_split(tr, x, y):
    """One more step_k of the trainer's captured LM step under
    torch.profiler: device ms a step by group (the flash kernels, bf16
    tensor-core GEMMs, SIMT f32 GEMMs, the rest) and each group's share,
    with the largest kernels. The step trains on (the fit is over)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    inputs = tr.shard_inputs([torch.stack([x._data] * GFLM_K),
                              torch.stack([y._data] * GFLM_K)],
                             stacked=True)
    tr.step_k(tr._params, tr._states, tr._aux, inputs)
    _sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tr.step_k(tr._params, tr._states, tr._aux, inputs)
        _sync()
    rows = _device_rows(prof, GFLM_K)
    dev_ms = sum(r[1] for r in rows)
    groups = {}
    for k, t, _c in rows:
        g = _kernel_group(k)
        groups[g] = groups.get(g, 0.0) + t
    return {"device_ms_per_step": dev_ms, "groups_ms": groups,
            "groups_share": {g: t / max(dev_ms, 1e-9)
                             for g, t in groups.items()},
            "top": [{"kernel": k[:140], "ms_per_step": t, "calls": c}
                    for k, t, c in rows[:16]]}


def phase_gluon_fused_lm():
    """The causal LM of examples/transformer_lm.py at GPT-2 medium's
    widths (encoder and head in one HybridSequential) through
    gluon.trainer.fused_fit with Adam, K = 2: the flash kernels inside
    the captured step, counted over its replays; the first 3 fused steps'
    losses held against gluon_lm_hybrid's loop from the same
    parameters."""
    import mxnet_tpu_torch as mx
    _free_card()
    if "losses" in _GLM_REF:
        init = _GLM_REF["init"]
        x, y = (mx.nd.NDArray(t) for t in _lm_batch())
        ref = _GLM_REF["losses"][:GFLM_STEPS]
    else:
        init, x, y = _glm_init(mx)
        ref = _glm_run(mx, init, True, x, y)[0][:GFLM_STEPS]
        _GLM_REF["init"] = init
    res, tr, calls, _ = _glm_fused_run(mx, init, x, y, GLM_LAYERS)
    loss_err = max(abs(a - b) / abs(b)
                   for a, b in zip(res["step_losses"][:GFLM_STEPS], ref))
    res.update(hybrid_loop_losses=ref, loss_rel_err=loss_err,
               rtol=GFLM_RTOL, device_split=_replay_split(tr, x, y),
               eager_step_s_same_run=RECORD.get("gluon_lm_hybrid", {})
               .get("step_s_eager"))
    res["ok"] = bool(res["finite"] and loss_err <= GFLM_RTOL
                     and _flash_replays_ok(res, tr))
    RECORD["gluon_fused_lm"] = res
    del calls, tr
    _free_card()
    if not res["ok"]:
        raise AssertionError("gluon_fused_lm failed: %s"
                             % json.dumps(res, default=str)[:4000])
    return res


def _capture_cost(tr):
    """What a checkpoint's capture of the trainer's whole state costs:
    the copies on the card (the training thread's share: seconds to the
    copies' end, bytes) and the saver thread's move of them to the host
    (seconds)."""
    from mxnet_tpu_torch.checkpoint.state import capture_fused_state
    _sync()
    t0 = time.perf_counter()
    st = capture_fused_state(tr, tr._params, tr._states, tr._aux,
                             "gluon_fused", 0, 0, 0, TRAIN_BATCH, AMP_DTYPE)
    _sync()
    t1 = time.perf_counter()
    nbytes = sum(v.numel() * v.element_size() for v in st.arrays.values())
    st.host_arrays()
    t2 = time.perf_counter()
    del st
    _free_card()
    return {"arrays_bytes": nbytes, "device_copy_s": t1 - t0,
            "to_host_s": t2 - t1}


def phase_gluon_fused_lm_amp():
    """The LM of gluon_fused_lm (24 layers, 8 x 1024 tokens, Adam,
    K = 2, 2 epochs of 3 steps, the same parameters) under
    amp.init("bfloat16"): fused_fit's trainer in bf16 with fp32 masters,
    the policy's casts in its captured step. Step time beside
    gluon_fused_lm's f32 step, the device split of one replay (flash
    kernels, bf16 tensor-core and SIMT f32 GEMMs), each flash kernel's
    launches a replay in bf16 (24), the first 3 losses against the f32
    ones (AMP_LOSS_RTOL) and falling. Two controls, one step each: the
    policy's cast removed from _contrib_flash_attention (recorded: its
    inputs come bf16 from the projections all the same) and the op
    widened to fp32 by the policy, whose kernels must fail the bf16
    check."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import amp
    _free_card()
    if "gluon_fused_lm" not in RECORD:
        phase_gluon_fused_lm()
    f32 = RECORD["gluon_fused_lm"]
    init = _GLM_REF["init"]
    x, y = (mx.nd.NDArray(t) for t in _lm_batch())
    half = "torch." + AMP_DTYPE
    op = "_contrib_flash_attention"
    amp.init(AMP_DTYPE)
    try:
        res, tr, calls, _ = _glm_fused_run(mx, init, x, y, GLM_LAYERS)
        res["device_split"] = _replay_split(tr, x, y)
        res["flash_in_bf16"] = _flash_replays_ok(res, tr, half)
        res["checkpoint_capture"] = _capture_cost(tr)
        del calls, tr
        _free_card()
        controls = {}
        for name, lists in (("flash_cast_removed",
                             dict(ALLOW=amp.ALLOW - {op})),
                            ("flash_widened",
                             dict(ALLOW=amp.ALLOW - {op},
                                  WIDEN=amp.WIDEN | {op}))):
            saved = {k: getattr(amp, k) for k in lists}
            for k, v in lists.items():
                setattr(amp, k, v)
            try:
                cres, ctr, _c, _ = _glm_fused_run(
                    mx, init, x, y, GLM_LAYERS, steps=GFLM_K, epochs=1)
                controls[name] = {
                    "flash_launches_a_replay": {
                        k: v for k, v in cres["launches_a_replay"].items()
                        if k.startswith("flash")},
                    "flash_in_bf16": _flash_replays_ok(cres, ctr, half),
                    "step_losses": cres["step_losses"]}
            finally:
                for k, v in saved.items():
                    setattr(amp, k, v)
            del ctr, _c
            _free_card()
    finally:
        amp.disable()
    ref = f32["step_losses"][:GFLM_STEPS]
    got = res["step_losses"][:GFLM_STEPS]
    res.update(
        amp_dtype=AMP_DTYPE, f32_step_losses=ref,
        loss_rel_err=max(abs(a - b) / abs(b) for a, b in zip(got, ref)),
        loss_rtol=AMP_LOSS_RTOL,
        losses_fall=res["step_losses"][-1] < res["step_losses"][0],
        f32_step_s_same_run=f32["step_s"],
        f32_device_ms_per_step_same_run=f32["device_ms_per_step"],
        f32_device_split_same_run=f32.get("device_split"),
        controls=controls)
    res["ok"] = bool(res["finite"] and res["flash_in_bf16"]
                     and res["loss_rel_err"] <= AMP_LOSS_RTOL
                     and res["losses_fall"]
                     and not controls["flash_widened"]["flash_in_bf16"])
    RECORD["gluon_fused_lm_amp"] = res
    if not res["ok"]:
        raise AssertionError("gluon_fused_lm_amp failed: %s"
                             % json.dumps(res, default=str)[:4000])
    return res


def _dp_trainer(sym, dtype, batch, device=None):
    """bench.py's trainer on one device: the card (``DEV``) unless
    ``device`` names another."""
    from mxnet_tpu_torch.parallel import DataParallelTrainer, \
        data_parallel_mesh
    device = device or DEV
    mesh = data_parallel_mesh(1) if device == "cuda" else \
        data_parallel_mesh(1, [device])
    return DataParallelTrainer(sym, mesh, optimizer="sgd",
                               learning_rate=R50_LR, momentum=0.9,
                               rescale_grad=1.0 / batch, dtype=dtype)


@contextlib.contextmanager
def _cudnn_deterministic():
    """cuDNN's deterministic algorithms for the enclosed calls (some of its
    float32 algorithms sum with atomics, so two runs of one step differ in
    the last bits, which ResNet-50's BatchNorms at batch 8 amplify: the
    first run of the step_k check read 5.9e-2 between step_k and K steps
    in float32 without this, 0 in bf16)."""
    import torch
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = old


def _dp_stepk_check(sym, dtype):
    """step_k(K) against K step calls from the same state, at batch
    DP_CHECK_BATCH, both with cuDNN's deterministic algorithms: each loss,
    parameter and momentum within DP_STEPK_RTOL of its tensor's largest
    magnitude."""
    with _cudnn_deterministic():
        return _dp_stepk_pair(sym, dtype)


def _dp_stepk_pair(sym, dtype):
    import numpy as np
    b = DP_CHECK_BATCH
    shapes = {"data": (b, 3, R50_IMG, R50_IMG), "softmax_label": (b,)}
    rng = np.random.RandomState(SEED)
    xs = rng.uniform(0, 1, (DP_K,) + shapes["data"]).astype(np.float32)
    ys = rng.randint(0, 1000, (DP_K, b)).astype(np.float32)
    out = []
    for fused in (True, False):
        tr = _dp_trainer(sym, dtype, b)
        p, st, a = tr.init_state(shapes)
        inputs = tr.shard_inputs([xs, ys], stacked=True)
        if fused:
            p, st, a, losses, _ = tr.step_k(p, st, a, inputs)
        else:
            losses = []
            for i in range(DP_K):
                p, st, a, loss, _ = tr.step(p, st, a, (inputs[0][i],
                                                       inputs[1][i]))
                losses.append(loss)
            losses = __import__("torch").stack(losses)
        out.append([losses.cpu().numpy()] + [t.cpu().numpy() for t in p]
                   + [t[0].cpu().numpy() for t in st])
        captures = tr.captures
        del tr, p, st, a
        _free_card()
    err = max(_rel_err(u, v) for u, v in zip(*out))
    return {"dtype": dtype, "batch": b, "k": DP_K, "max_rel_err": err,
            "rtol": DP_STEPK_RTOL, "captures": captures,
            "ok": bool(err <= DP_STEPK_RTOL and captures == (
                1 if DEV == "cuda" else 0))}


def _ce(prob, y):
    """Mean cross-entropy of probabilities ``prob`` at integer labels
    ``y`` (numpy, float64)."""
    import numpy as np
    p = np.asarray(prob, np.float64)[np.arange(len(y)), y.astype(int)]
    return float(-np.log(np.maximum(p, 1e-30)).mean())


def _step_measures(got, ref, y):
    """A trainer step's momenta (``mom:`` keys) and output against the
    float64 step's: the norm-wise error, the cosine and the norm ratio of
    each parameter's momentum (median, extremes, 10th percentile), the
    cosine of all momenta as one vector, the output's cross-entropy at
    the labels ``y`` and its largest element error. Parameters whose
    float64 gradient is exactly zero (the biases the executor's dead-bias
    pass zeroes) have no direction and are left out."""
    import numpy as np
    keys = [k for k in ref if k.startswith("mom:") and np.any(ref[k])]
    ne, cos, lr_ = [], [], []
    for k in keys:
        a, b = got[k].ravel(), ref[k].ravel()
        na, nb = np.linalg.norm(a), np.linalg.norm(b)
        ne.append(float(np.linalg.norm(a - b) / max(1e-30, nb)))
        cos.append(float(a @ b / max(1e-30, na * nb)))
        lr_.append(float(abs(np.log(max(1e-30, na) / max(1e-30, nb)))))
    a = np.concatenate([got[k].ravel() for k in keys])
    b = np.concatenate([ref[k].ravel() for k in keys])
    ce, ce_ref = _ce(got["output"], y), _ce(ref["output"], y)
    return {"norm_err_median": float(np.median(ne)),
            "norm_err_max": max(ne),
            "cos_median": float(np.median(cos)), "cos_min": min(cos),
            "cos_p10": float(np.percentile(cos, 10)),
            "cos_all": float(a @ b / max(1e-30, np.linalg.norm(a)
                                         * np.linalg.norm(b))),
            "log_ratio_median": float(np.median(lr_)),
            "log_ratio_max": max(lr_),
            "ce": ce, "ce_ref": ce_ref, "ce_rel": abs(ce - ce_ref) / ce_ref,
            "output_err": _rel_err(got["output"], ref["output"]),
            "tensors": len(keys)}


def _bf16_rule(card, cpu, ref, y, faults):
    """A bf16 step on the card and on the CPU against the float64 step
    (``_step_measures``), held by the DP_BF16_* bounds; ``faults``: name
    -> a faulty version of the card's step, each of which must fail the
    same bounds."""
    cpu_m = _step_measures(cpu, ref, y)

    def held(m):
        return dict(m, ok=bool(
            m["cos_p10"] >= DP_BF16_COS_P10
            and m["log_ratio_median"] <= DP_BF16_LOG_RATIO
            and m["ce_rel"] <= DP_BF16_CE_RTOL
            and m["norm_err_median"]
            <= DP_BF16_FACTOR * cpu_m["norm_err_median"]))
    res = {"card": held(_step_measures(card, ref, y)), "cpu": held(cpu_m),
           "faults": {n: held(_step_measures(f, ref, y))
                      for n, f in faults.items()},
           "bounds": {"cos_p10_min": DP_BF16_COS_P10,
                      "log_ratio_median_max": DP_BF16_LOG_RATIO,
                      "ce_rtol": DP_BF16_CE_RTOL,
                      "norm_err_factor": DP_BF16_FACTOR}}
    res["ok"] = bool(res["card"]["ok"] and res["cpu"]["ok"] and not any(
        f["ok"] for f in res["faults"].values()))
    return res


def _dp_reference(sym, shape, args, auxs, x, y, ctx=None):
    """The float64 step of the executor on ``ctx`` (the CPU by default)
    from ``args`` / ``auxs``: the output, each parameter's momentum after
    a step from zero (-lr x rescale x its gradient, formed in float64)
    and each moving statistic."""
    import numpy as np
    import torch
    import mxnet_tpu_torch as mx
    ex = sym.simple_bind(ctx=ctx or mx.cpu(), data=shape, type_dict={
        n: "float64" for n in sym.list_arguments()})
    for a in ex.aux_dict.values():
        a._data = a._data.to(torch.float64)
    ex.copy_params_from(
        {n: mx.nd.array(v, ctx=mx.cpu()) for n, v in args.items()},
        {n: mx.nd.array(v, ctx=mx.cpu()) for n, v in auxs.items()})
    ex.forward(is_train=True, data=mx.nd.array(x, ctx=mx.cpu()),
               softmax_label=mx.nd.array(y, ctx=mx.cpu()))
    ex.backward()
    scale = -R50_LR / shape[0]
    ref = {"output": ex.outputs[0].asnumpy().astype(np.float64)}
    ref.update({"mom:" + n: scale * ex.grad_dict[n].asnumpy()
                for n in args})
    ref.update({"aux:" + n: a.asnumpy().astype(np.float64)
                for n, a in ex.aux_dict.items()})
    return ref


def _dp_card_vs_cpu(sym):
    """One f32 trainer step (from He-normal parameters) and one bf16 step
    (from the trainer's own draw) at batch R50_CHECK_BATCH on the card
    and, eagerly, on the CPU, each against the float64 step on the CPU
    from the same parameters (see the DP_* constants)."""
    import numpy as np
    import mxnet_tpu_torch as mx
    b = R50_CHECK_BATCH
    shape = (b, 3, R50_IMG, R50_IMG)
    rng = np.random.RandomState(SEED)
    x = rng.uniform(0, 1, shape).astype(np.float32)
    y = rng.randint(0, 1000, b).astype(np.float32)
    host = sym.simple_bind(ctx=mx.cpu(), data=shape)
    _init_bound(host, mx, SEED)
    he_normal = ({n: a.asnumpy() for n, a in host.arg_dict.items()
                  if n not in ("data", "softmax_label")},
                 {n: a.asnumpy() for n, a in host.aux_dict.items()})
    del host
    tr = _dp_trainer(sym, "float32", b, "cpu")
    p, _, a = tr.init_state({"data": shape, "softmax_label": (b,)})
    drawn = (tr.host_params(p), tr.host_aux(a))
    del tr, p, a

    def step(dtype, device, params, labels=y):
        tr = _dp_trainer(sym, dtype, b, device)
        p, st, a = tr.init_state({"data": shape, "softmax_label": (b,)},
                                 arg_params=params[0], aux_params=params[1])
        p, st, a, _, outs = tr.step(p, st, a, tr.shard_inputs([x, labels]))
        t = {"output": outs[0].float().cpu().numpy().astype(np.float64)}
        t.update({"mom:" + n: s_[0].cpu().numpy().astype(np.float64)
                  for n, s_ in zip(tr.param_names, st)})
        t.update({"aux:" + n: v.cpu().numpy().astype(np.float64)
                  for n, v in zip(tr.aux_names, a)})
        del tr, p, st, a
        _free_card()
        return t
    res = {"batch": b}
    ref = _dp_reference(sym, shape, *he_normal, x, y)
    res["float32"] = _f32_rule(step("float32", DEV, he_normal),
                               step("float32", "cpu", he_normal), ref)
    res["float32"]["params"] = "He-normal"
    ref = _dp_reference(sym, shape, *drawn, x, y)
    card = step("bfloat16", DEV, drawn)
    faults = {name: {k: (v * f if k.startswith("mom:") else v)
                     for k, v in card.items()}
              for name, f in (("zeroed", 0.0), ("negated", -1.0),
                              ("doubled", 2.0))}
    faults["labels_rolled"] = step("bfloat16", DEV, drawn, np.roll(y, 1))
    res["bfloat16"] = _bf16_rule(card, step("bfloat16", "cpu", drawn), ref,
                                 y, faults)
    res["bfloat16"]["params"] = "init_state (N(0, 0.01))"
    res["ok"] = bool(res["float32"]["ok"] and res["bfloat16"]["ok"])
    return res


def _dp_window(tr, state, inputs, steps, k):
    """``steps`` training steps, ``k`` a step_k dispatch (1: step), timed
    by the host clock up to a sync on the last loss. Returns (state,
    seconds)."""
    p, st, a = state
    _sync()
    t0 = time.perf_counter()
    for _ in range(steps // k):
        if k == 1:
            p, st, a, loss, _ = tr.step(p, st, a, inputs)
        else:
            p, st, a, loss, _ = tr.step_k(p, st, a, inputs)
    float(loss.reshape(-1)[-1])
    return (p, st, a), time.perf_counter() - t0


def phase_dp_resnet50():
    """bench.py's flagship training lane through the port's
    DataParallelTrainer on one card (see the DP_* constants): the checks
    first, then bf16 step_k windows, a single-step window, the step's
    host enqueue against its device time, a profiled dispatch, and the
    f32 step_k window."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    import mxnet_tpu_torch as mx
    _free_card()
    with mx.NameManager():
        sym = resnet_v1_symbol(mx.sym)
    res = {"batch": R50_BATCH, "image": R50_IMG, "k": DP_K,
           "optimizer": "sgd lr 0.05 momentum 0.9 rescale_grad 1/128"}
    t0 = time.perf_counter()
    res["step_k_check"] = [_dp_stepk_check(sym, dt)
                           for dt in ("bfloat16", "float32")]
    res["card_vs_cpu"] = _dp_card_vs_cpu(sym)
    res["check_s"] = time.perf_counter() - t0
    _free_card()
    shapes = {"data": (R50_BATCH, 3, R50_IMG, R50_IMG),
              "softmax_label": (R50_BATCH,)}
    rng = np.random.RandomState(0)          # bench.py's draws, in order
    x = rng.uniform(0, 1, shapes["data"]).astype(np.float32)
    y = rng.randint(0, 1000, R50_BATCH).astype(np.float32)
    xs = rng.uniform(0, 1, (DP_K,) + shapes["data"]).astype(np.float32)
    ys = rng.randint(0, 1000, (DP_K, R50_BATCH)).astype(np.float32)
    flops = step_flops("resnet50", sym, shapes, 3 * 8.18e9 * R50_BATCH)
    _reset_counts()
    lanes = {}
    for dtype in ("bfloat16", "float32"):
        tr = _dp_trainer(sym, dtype, R50_BATCH)
        state = tr.init_state(shapes)
        inputs_k = tr.shard_inputs([xs, ys], stacked=True)
        inputs1 = tr.shard_inputs([x, y])
        lane = {}
        t1 = time.perf_counter()
        p, st, a, losses, _ = tr.step_k(*state, inputs_k)   # capture
        first = losses.cpu().numpy()
        lane["first_dispatch_s"] = time.perf_counter() - t1
        state = (p, st, a)
        if DEV == "cuda":
            torch.cuda.reset_peak_memory_stats()
        rates = []
        windows = DP_WINDOWS if dtype == "bfloat16" else 1
        steps = DP_WINDOW if dtype == "bfloat16" else DP_F32_STEPS
        for _ in range(windows):
            state, sec = _dp_window(tr, state, inputs_k, steps, DP_K)
            rates.append(steps * R50_BATCH / sec)
        lane["img_per_s_step_k"] = float(np.median(rates))
        lane["img_per_s_windows"] = rates
        lane["step_ms"] = R50_BATCH / lane["img_per_s_step_k"] * 1e3
        if dtype == "bfloat16":
            state, sec = _dp_window(tr, state, inputs1, DP_WINDOW, 1)
            lane["img_per_s_step"] = DP_WINDOW * R50_BATCH / sec
            # the host's enqueue of a dispatch (no sync inside) against
            # the dispatch's wall time, a step each
            enq, wall = [], []
            for _ in range(3):
                _sync()
                t1 = time.perf_counter()
                p, st, a, losses, _ = tr.step_k(*state, inputs_k)
                t2 = time.perf_counter()
                _sync()
                t3 = time.perf_counter()
                state = (p, st, a)
                enq.append((t2 - t1) * 1e3 / DP_K)
                wall.append((t3 - t1) * 1e3 / DP_K)
            lane["host_enqueue_ms_per_step"] = enq
            lane["dispatch_wall_ms_per_step"] = wall
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            p, st, a, losses, _ = tr.step_k(*state, inputs_k)
            _sync()
        state = (p, st, a)
        rows = _device_rows(prof, DP_K)
        dev_ms = sum(r[1] for r in rows)
        lane["device_ms_per_step"] = dev_ms
        lane["device_busy_share"] = dev_ms / lane["step_ms"]
        lane["kernels_a_step"] = sum(r[2] for r in rows)
        lane["top"] = [{"kernel": k_[:120], "ms_per_step": t_,
                        "calls": c_} for k_, t_, c_ in rows[:15]]
        conv_rows = [r for r in rows if any(w in r[0].lower() for w in (
            "cudnn", "conv", "dgrad", "wgrad", "xmma"))]
        lane["cudnn_ms_per_step"] = sum(r[1] for r in conv_rows)
        # the convolution kernels cuDNN picked (layout: NCHW, as the JAX
        # package's), largest first
        lane["cudnn_kernels"] = [{"kernel": k_[:160], "ms_per_step": t_,
                                  "calls": c_}
                                 for k_, t_, c_ in conv_rows[:12]]
        lane["gemm_ms_per_step"] = sum(
            r[1] for r in rows if any(w in r[0].lower() for w in (
                "gemm", "cutlass", "sm90_xmma")))
        peak = torch.cuda.max_memory_allocated() if DEV == "cuda" else 0
        last = losses.cpu().numpy()
        lane.update({
            "peak_mem_gb": peak / 1e9, "graphs": tr.graph_stats(),
            "captures": tr.captures, "first_losses": first.tolist(),
            "last_losses": last.tolist(),
            "losses_finite": bool(np.isfinite(first).all()
                                  and np.isfinite(last).all()),
            "flop_per_step": flops,
            "flop_share_of_peak": flops / (lane["step_ms"] / 1e3) / (
                PEAK_BF16_FLOPS if dtype == "bfloat16" else PEAK_F32_FLOPS),
            "peak_used": "bf16 989 TFLOP/s" if dtype == "bfloat16"
            else "fp32 67 TFLOP/s"})
        lanes[dtype] = lane
        del tr, state, inputs_k, inputs1, p, st, a
        _free_card()
    counts = _read_counts()
    res.update({"bf16": lanes["bfloat16"], "f32": lanes["float32"],
                "launches": counts, "seconds_total":
                time.perf_counter() - t0})
    res["ok"] = bool(
        all(c["ok"] for c in res["step_k_check"])
        and res["card_vs_cpu"]["ok"]
        and all(l_["losses_finite"] for l_ in lanes.values())
        and all(l_["captures"] == (1 if DEV == "cuda" else 0)
                for l_ in lanes.values())
        and not any(counts[k] for k in _wrappers()))
    RECORD["dp_resnet50"] = res
    if not res["ok"]:
        raise AssertionError("dp_resnet50 failed: %s"
                             % json.dumps(res, default=str)[:4000])
    return res


def phase_dp_resnet50_fp16():
    """dp_resnet50's lane in float16: DataParallelTrainer(dtype=
    "float16") with its DynamicLossScaler on the card, step_k(K=4), batch
    128 (FP16_WINDOWS windows of DP_WINDOW steps): img/s beside
    dp_resnet50's bf16 in the same run, the scale and the steps skipped.
    Beforehand step_k against K steps (deterministic cuDNN). Then an inf
    placed in one batch: the step must be skipped with no re-capture
    (parameters, momenta and BatchNorm statistics bit-identical to
    before it, the scale halved, one more skip), and the next step must
    train again."""
    import numpy as np
    import torch
    import mxnet_tpu_torch as mx
    _free_card()
    with mx.NameManager():
        sym = resnet_v1_symbol(mx.sym)
    res = {"batch": R50_BATCH, "image": R50_IMG, "k": DP_K,
           "dtype": "float16",
           "optimizer": "sgd lr 0.05 momentum 0.9 rescale_grad 1/128"}
    t0 = time.perf_counter()
    res["step_k_check"] = _dp_stepk_check(sym, "float16")
    _free_card()
    shapes = {"data": (R50_BATCH, 3, R50_IMG, R50_IMG),
              "softmax_label": (R50_BATCH,)}
    rng = np.random.RandomState(0)          # dp_resnet50's draws
    x = rng.uniform(0, 1, shapes["data"]).astype(np.float32)
    y = rng.randint(0, 1000, R50_BATCH).astype(np.float32)
    xs = rng.uniform(0, 1, (DP_K,) + shapes["data"]).astype(np.float32)
    ys = rng.randint(0, 1000, (DP_K, R50_BATCH)).astype(np.float32)
    _reset_counts()
    tr = _dp_trainer(sym, "float16", R50_BATCH)
    state = tr.init_state(shapes)
    inputs_k = tr.shard_inputs([xs, ys], stacked=True)
    t1 = time.perf_counter()
    p, st, a, losses, _ = tr.step_k(*state, inputs_k)      # capture
    res["first_dispatch_s"] = time.perf_counter() - t1
    res["first_losses"] = losses.cpu().tolist()
    state = (p, st, a)
    rates = []
    for _ in range(FP16_WINDOWS):
        state, sec = _dp_window(tr, state, inputs_k, DP_WINDOW, DP_K)
        rates.append(DP_WINDOW * R50_BATCH / sec)
    res["img_per_s_step_k"] = float(np.median(rates))
    res["img_per_s_windows"] = rates
    res["bf16_img_per_s_same_run"] = RECORD.get("dp_resnet50", {}).get(
        "bf16", {}).get("img_per_s_step_k")
    res["scale_after_windows"] = tr.loss_scale
    res["skipped_in_windows"] = tr.skipped_steps
    # the forced overflow, through the captured step
    p, st, a = state
    flat = lambda p_, st_, a_: list(p_) + [t for s_ in st_ for t in s_] \
        + list(a_)
    before = [t.clone() for t in flat(p, st, a)]
    scale0, skipped0, captures0 = tr.loss_scale, tr.skipped_steps, \
        tr.captures
    bad = x.copy()
    bad[0, 0, 0, 0] = np.inf
    p, st, a, loss_bad, _ = tr.step(p, st, a, tr.shard_inputs([bad, y]))
    unchanged = all(torch.equal(u, v) for u, v in zip(flat(p, st, a),
                                                       before))
    res["overflow"] = {
        "scale_before": scale0, "scale_after": tr.loss_scale,
        "skipped_before": skipped0, "skipped_after": tr.skipped_steps,
        "captures_before": captures0, "captures_after": tr.captures,
        "state_bit_identical": unchanged,
        "amp_counters": mx.amp.counters()}
    p, st, a, loss_next, _ = tr.step(p, st, a, tr.shard_inputs([x, y]))
    res["overflow"]["next_step_trains"] = bool(
        math.isfinite(float(loss_next)) and tr.skipped_steps
        == skipped0 + 1 and not all(torch.equal(u, v) for u, v in zip(
            flat(p, st, a), before)))
    res.update(graphs=tr.graph_stats(), captures=tr.captures,
               launches=_read_counts(),
               seconds_total=time.perf_counter() - t0,
               losses_finite=bool(np.isfinite(res["first_losses"]).all()))
    o = res["overflow"]
    res["ok"] = bool(
        res["step_k_check"]["ok"] and res["losses_finite"]
        and o["state_bit_identical"]
        and o["scale_after"] == max(o["scale_before"] * 0.5, 1.0)
        and o["skipped_after"] == o["skipped_before"] + 1
        and o["captures_after"] == o["captures_before"]
        == (1 if DEV == "cuda" else 0)
        and o["next_step_trains"]
        and not any(res["launches"][k] for k in _wrappers()))
    RECORD["dp_resnet50_fp16"] = res
    del tr, state, inputs_k, p, st, a, before
    _free_card()
    if not res["ok"]:
        raise AssertionError("dp_resnet50_fp16 failed: %s"
                             % json.dumps(res, default=str)[:4000])
    return res


def _dir_bytes(path):
    return sum(os.path.getsize(os.path.join(r, f))
               for r, _d, fs in os.walk(path) for f in fs)


def _ckpt_lm(mx, init, x, y, tmp):
    """The amp LM at CKPT_LM_LAYERS layers through fused_fit: 2 epochs
    straight, against 1 epoch with checkpoint_dir (its async commit at
    the epoch's end) and then a fresh net resumed for the second. The
    last CKPT_LM_BATCHES losses and every final parameter must be
    bit-identical."""
    import torch
    from mxnet_tpu_torch import checkpoint
    from mxnet_tpu_torch.checkpoint import state as cstate
    d = os.path.join(tmp, "lm")
    mx.amp.init(AMP_DTYPE)
    capture_s = []
    real = cstate.capture_fused_state

    def timed(*a, **kw):
        _sync()
        t0 = time.perf_counter()
        out = real(*a, **kw)
        _sync()
        capture_s.append(time.perf_counter() - t0)
        return out
    try:
        straight, _t, _c, want = _glm_fused_run(
            mx, init, x, y, CKPT_LM_LAYERS, steps=CKPT_LM_BATCHES,
            keep_params=True)
        del _t, _c
        _free_card()
        cstate.capture_fused_state = timed
        first, _t, _c, _ = _glm_fused_run(
            mx, init, x, y, CKPT_LM_LAYERS, steps=CKPT_LM_BATCHES,
            epochs=1, checkpoint_dir=d)
        del _t, _c
        _free_card()
        t0 = time.perf_counter()
        state = checkpoint.CheckpointManager(d).restore()
        restore_s = time.perf_counter() - t0
        resumed, _t, _c, got = _glm_fused_run(
            mx, init, x, y, CKPT_LM_LAYERS, steps=CKPT_LM_BATCHES,
            checkpoint_dir=d, resume=True, keep_params=True)
        del _t, _c
    finally:
        cstate.capture_fused_state = real
        mx.amp.disable()
    tail = straight["step_losses"][-CKPT_LM_BATCHES:]
    res = {"layers": CKPT_LM_LAYERS, "amp_dtype": AMP_DTYPE,
           "steps": len(straight["step_losses"]),
           "straight_losses": straight["step_losses"],
           "first_half_losses": first["step_losses"],
           "resumed_losses": resumed["step_losses"],
           "losses_bit_identical": resumed["step_losses"] == tail,
           "params_bit_identical": sorted(got) == sorted(want) and all(
               torch.equal(got[n], want[n]) for n in want),
           "commit_bytes": _dir_bytes(os.path.join(
               d, "step-%010d" % CKPT_LM_BATCHES)),
           "capture_s": capture_s, "restore_s": restore_s,
           "restored_meta": {k: state.meta.get(k) for k in
                             ("kind", "epoch", "batch", "step",
                              "amp_dtype", "trainer")},
           "launches": resumed["launches"]}
    res["ok"] = bool(res["losses_bit_identical"]
                     and res["params_bit_identical"]
                     and len(res["resumed_losses"]) == CKPT_LM_BATCHES)
    return res


def _ckpt_lenet(mx, tmp):
    """LeNet through Module.fit per batch: CKPT_LENET_EPOCHS epochs
    straight against half of them with checkpoint_dir and a resume in a
    fresh Module; the last 4 batches' losses (cross-entropy of the
    outputs) and every final parameter bit-identical."""
    import numpy as np
    d = os.path.join(tmp, "lenet")
    opt = {"learning_rate": LENET_LR, "momentum": 0.9}

    def fit(epochs, ckpt=None, resume=False):
        np.random.seed(SEED)
        mx.random.seed(SEED)
        train, _ = _lenet_iters(mx, shuffle=False)
        losses = []

        def batch_end(param):
            m = param.locals["self"]
            prob = m.get_outputs()[0].asnumpy()
            lab = param.locals["data_batch"].label[0].asnumpy()
            losses.append(_ce(prob, lab))
        mod = mx.mod.Module(lenet_symbol(mx.sym), context=_ctx())
        mod.fit(train, num_epoch=epochs, optimizer="sgd",
                optimizer_params=opt, initializer=mx.init.Xavier(),
                batch_end_callback=batch_end, checkpoint_dir=ckpt,
                resume=resume)
        args, aux = mod.get_params()
        return losses, {n: a.asnumpy() for d_ in (args, aux)
                        for n, a in d_.items()}

    with _cudnn_deterministic():
        want_l, want_p = fit(CKPT_LENET_EPOCHS)
        fit(CKPT_LENET_EPOCHS // 2, d)
        got_l, got_p = fit(CKPT_LENET_EPOCHS, d, resume=True)
    res = {"epochs": CKPT_LENET_EPOCHS, "batches": len(want_l),
           "resumed_batches": len(got_l),
           "last4_straight": want_l[-4:], "last4_resumed": got_l[-4:],
           "losses_bit_identical": got_l[-4:] == want_l[-4:],
           "params_bit_identical": all(np.array_equal(got_p[n], want_p[n])
                                       for n in want_p)}
    res["ok"] = bool(res["losses_bit_identical"]
                     and res["params_bit_identical"])
    return res


def _ckpt_lane(mx, tmp):
    """bench.py's checkpoint lane on the card: its MLP (batch 256,
    1024 -> 512 -> 512 -> 64, SGD) through DataParallelTrainer.step,
    CKPT_WINDOWS windows of CKPT_MLP_STEPS steps with no checkpoint, with
    a blocking commit every CKPT_EVERY steps and with async commits:
    steps/s (median), restore ms, bytes and save ms a commit."""
    import numpy as np
    from mxnet_tpu_torch.checkpoint import CheckpointManager
    from mxnet_tpu_torch.checkpoint.state import TrainingState
    c = CKPT_MLP
    with mx.NameManager():
        net = mx.sym.FullyConnected(mx.sym.Variable("data"),
                                    num_hidden=c["hidden"], name="ckfc1")
        net = mx.sym.Activation(net, act_type="relu")
        net = mx.sym.FullyConnected(net, num_hidden=c["hidden"],
                                    name="ckfc2")
        net = mx.sym.Activation(net, act_type="relu")
        net = mx.sym.FullyConnected(net, num_hidden=c["classes"],
                                    name="ckfc3")
        sym = mx.sym.SoftmaxOutput(net, name="softmax")
    rng = np.random.RandomState(0)
    x = rng.uniform(-1, 1, (c["batch"], c["dim"])).astype(np.float32)
    y = rng.randint(0, c["classes"], (c["batch"],)).astype(np.float32)
    out = {}
    for mode in ("none", "sync", "async"):
        tr = _dp_trainer(sym, "float32", c["batch"])
        state = tr.init_state({"data": x.shape, "softmax_label": y.shape})
        inputs = tr.shard_inputs([x, y])
        for _ in range(2):
            p, st, a, loss, _ = tr.step(*state, inputs)
            state = (p, st, a)
        float(loss)
        mgr = None if mode == "none" else CheckpointManager(
            os.path.join(tmp, "lane_" + mode), async_save=mode == "async",
            keep_last_n=2)
        rates, gstep = [], 0
        for _ in range(CKPT_WINDOWS):
            t0 = time.perf_counter()
            for _ in range(CKPT_MLP_STEPS):
                p, st, a, loss, _ = tr.step(*state, inputs)
                state = (p, st, a)
                gstep += 1
                if mgr is not None and gstep % CKPT_EVERY == 0:
                    arrays, tmeta = tr.export_training_state(*state)
                    mgr.save(TrainingState(arrays=arrays, meta={
                        "kind": "bench", "epoch": 0, "batch": gstep,
                        "step": gstep, "trainer": tmeta}), step=gstep)
            float(loss)
            if mgr is not None:
                mgr.wait()
            rates.append(CKPT_MLP_STEPS / (time.perf_counter() - t0))
        lane = {"steps_per_s": float(np.median(rates)),
                "steps_per_s_windows": rates}
        if mgr is not None:
            t0 = time.perf_counter()
            back = mgr.restore()
            lane["restore_ms"] = (time.perf_counter() - t0) * 1e3
            cnt = mgr.counters()
            commits = max(1, cnt["ckpt_commits"])
            lane.update(commits=cnt["ckpt_commits"],
                        bytes_per_commit=cnt["ckpt_bytes"] // commits,
                        save_ms_per_commit=cnt["ckpt_save_us"] / commits
                        / 1e3, overlap_frac=cnt["ckpt_overlap_frac"],
                        restored_step=back.step)
            mgr.close()
        out[mode] = lane
        del tr, state, inputs
        _free_card()
    out["ok"] = bool(out["sync"]["restored_step"] == out["async"][
        "restored_step"] == CKPT_WINDOWS * CKPT_MLP_STEPS)
    return out


def phase_ckpt_resume():
    """Checkpoints on the card: the amp LM through fused_fit and LeNet
    through Module.fit, each resumed bit-identically (_ckpt_lm,
    _ckpt_lenet), and bench.py's checkpoint lane (_ckpt_lane)."""
    import shutil
    import tempfile
    import mxnet_tpu_torch as mx
    _free_card()
    init = _GLM_REF.get("init")
    if init is None:
        init = _glm_init(mx)[0]
    x, y = (mx.nd.NDArray(t) for t in _lm_batch())
    tmp = tempfile.mkdtemp(prefix="ckpt_resume_")
    try:
        res = {"lm": _ckpt_lm(mx, init, x, y, tmp)}
        _free_card()
        res["lenet"] = _ckpt_lenet(mx, tmp)
        res["lane"] = _ckpt_lane(mx, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    res["launches"] = res["lm"]["launches"]
    res["ok"] = bool(res["lm"]["ok"] and res["lenet"]["ok"]
                     and res["lane"]["ok"])
    RECORD["ckpt_resume"] = res
    _free_card()
    if not res["ok"]:
        raise AssertionError("ckpt_resume failed: %s"
                             % json.dumps(res, default=str)[:4000])
    return res


def phase_module_fused():
    """examples/train_mnist.py's LeNet through Module.fit with
    steps_per_dispatch=FUSED_K on the card: one unshuffled epoch against
    steps_per_dispatch=1 from the same initial parameters, then the
    example's 8 epochs fused (validation accuracy, seconds an epoch,
    samples/s)."""
    import time
    import mxnet_tpu_torch as mx
    _free_card()
    opt = {"learning_rate": LENET_LR, "momentum": 0.9,
           "rescale_grad": 1.0 / LENET_BATCH}
    train, _ = _lenet_iters(mx, shuffle=False)
    with mx.NameManager():
        host = mx.mod.Module(lenet_symbol(mx.sym), context=mx.cpu())
    host.bind(data_shapes=train.provide_data,
              label_shapes=train.provide_label)
    mx.random.seed(SEED)
    host.init_params(mx.init.Uniform(0.01))
    init_args, init_aux = host.get_params()
    finals = []
    for k in (1, FUSED_K):
        train.reset()
        with mx.NameManager():
            m = mx.mod.Module(lenet_symbol(mx.sym), context=_ctx())
        m.fit(train, num_epoch=1, optimizer="sgd", optimizer_params=opt,
              arg_params=init_args, aux_params=init_aux,
              steps_per_dispatch=k)
        finals.append({n: a.asnumpy() for n, a in m.get_params()[0].items()})
    check = {n: _rel_err(finals[1][n], finals[0][n]) for n in finals[0]}
    check_captures = m.fused_trainer.captures
    del m
    _free_card()
    train, val = _lenet_iters(mx, shuffle=True)
    with mx.NameManager():
        mod = mx.mod.Module(lenet_symbol(mx.sym), context=_ctx())
    epoch_t = []
    _reset_counts()
    t0 = time.perf_counter()
    mod.fit(train, eval_data=val, num_epoch=LENET_EPOCHS, optimizer="sgd",
            optimizer_params=opt, eval_metric="acc",
            steps_per_dispatch=FUSED_K,
            epoch_end_callback=lambda *a: epoch_t.append(
                time.perf_counter()))
    fit_s = time.perf_counter() - t0
    counts = _read_counts()
    acc = mod.score(val, mx.metric.Accuracy())[0][1]
    n_train = LENET_N * 7 // 8 // LENET_BATCH * LENET_BATCH
    spans = [b - a for a, b in zip([t0] + epoch_t, epoch_t)]
    tr = mod.fused_trainer
    res = {"val_accuracy": float(acc), "bar": LENET_BAR,
           "meets_bar": bool(acc > LENET_BAR), "k": FUSED_K,
           "epochs": LENET_EPOCHS, "fit_s": fit_s, "epoch_s": spans,
           "epoch_s_after_first": sum(spans[1:]) / max(1, len(spans) - 1),
           "samples_per_s": n_train * LENET_EPOCHS / fit_s,
           "samples_per_s_after_first": n_train * (len(spans) - 1) /
           max(1e-9, sum(spans[1:])),
           "k1_vs_fused_max_rel_err": max(check.values()),
           "k1_vs_fused": check, "rtol": FUSED_RTOL,
           "check_captures": check_captures, "captures": tr.captures,
           "graphs": tr.graph_stats(), "launches": counts}
    # the example's bar is reported, not required: the fused fit is held
    # to K = 1 above
    res["ok"] = bool(res["k1_vs_fused_max_rel_err"] <= FUSED_RTOL
                     and tr.captures == (1 if DEV == "cuda" else 0)
                     and not any(counts[k] for k in _wrappers()))
    RECORD["module_fused"] = res
    del mod
    _free_card()
    if not res["ok"]:
        raise AssertionError("module_fused failed: %s" % json.dumps(
            res, default=str)[:4000])
    return res


def lstm_lm_symbol(sym, vocab, hidden, layers):
    """bench.py's lstm_lm symbol (bench.py:218-238) built with the given
    package's ``sym``: Embedding -> TNC RNN (lstm; the initial states
    enter batch-major and are transposed to the op's layout) ->
    FullyConnected -> SoftmaxOutput."""
    data = sym.Variable("data")
    emb = sym.Embedding(data, input_dim=vocab, output_dim=hidden,
                        name="emb")
    emb_t = sym.transpose(emb, axes=(1, 0, 2))
    state_bf = sym.Variable("state")
    cell_bf = sym.Variable("state_cell")
    rnn = sym.RNN(emb_t, sym.Variable("rnn_params"),
                  sym.transpose(state_bf, axes=(1, 0, 2)),
                  sym.transpose(cell_bf, axes=(1, 0, 2)),
                  state_size=hidden, num_layers=layers, mode="lstm",
                  name="lstm")
    out = sym.transpose(rnn, axes=(1, 0, 2))
    logits = sym.FullyConnected(sym.reshape(out, shape=(-1, hidden)),
                                num_hidden=vocab, name="dec")
    return sym.SoftmaxOutput(logits, name="softmax", multi_output=False)


def _r_blocks(mode, layers, dirs, input_size, hidden):
    """(offset, gates) of each recurrent block R of the RNN op's flat
    parameter vector, by (layer, direction), in the order of the layout."""
    g = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}[mode]
    ptr, out = 0, {}
    for layer in range(layers):
        in_sz = input_size if layer == 0 else hidden * dirs
        for d in range(dirs):
            ptr += g * hidden * in_sz
            out[(layer, d)] = (ptr, g)
            ptr += g * hidden * hidden
    return out


def _rnn_arrays(rng, mode, bidirectional):
    """Inputs, parameters, states and output cotangents of the op at
    RNN_CHECK (numpy float64, from ``rng``)."""
    from mxnet_tpu_torch.ops.rnn_ops import rnn_param_size
    c = RNN_CHECK
    dirs = 2 if bidirectional else 1
    n_p = rnn_param_size(c["layers"], c["input"], c["hidden"],
                         bidirectional, mode)
    st = (c["layers"] * dirs, c["batch"], c["hidden"])
    a = {"data": rng.uniform(-1, 1, (c["seq"], c["batch"], c["input"])),
         "params": rng.uniform(-0.3, 0.3, n_p),
         "state": rng.uniform(-0.5, 0.5, st),
         "g_y": rng.standard_normal((c["seq"], c["batch"],
                                     c["hidden"] * dirs)),
         "g_h": rng.standard_normal(st)}
    if mode == "lstm":
        a["state_cell"] = rng.uniform(-0.5, 0.5, st)
        a["g_c"] = rng.standard_normal(st)
    return a


def _rnn_tensors(mode, bidirectional, device, dtype, arrays, faulty=False):
    """The RNN op's outputs and the gradients of sum(outputs x
    cotangents) for its data, parameters and states, on ``device`` in
    ``dtype``, as float64 numpy. ``faulty``: each gate's recurrent block
    of layer 0 (both directions) transposed."""
    import torch
    from mxnet_tpu_torch.ops.registry import OpCtx, get_op
    c = RNN_CHECK
    schema = get_op("RNN")
    attrs = schema.parse_attrs(dict(
        state_size=c["hidden"], num_layers=c["layers"],
        bidirectional=bidirectional, mode=mode, state_outputs=True))
    leaves = ["data", "params", "state"] + (
        ["state_cell"] if mode == "lstm" else [])
    t = {k: torch.tensor(v, dtype=dtype, device=device,
                         requires_grad=k in leaves)
         for k, v in arrays.items()}
    params = t["params"]
    if faulty:
        dirs = 2 if bidirectional else 1
        h = c["hidden"]
        blocks = _r_blocks(mode, c["layers"], dirs, c["input"], h)
        pieces, ptr = [], 0
        for d in range(dirs):
            off, g = blocks[(0, d)]
            r = params[off:off + g * h * h].view(g, h, h)
            pieces += [params[ptr:off], r.transpose(1, 2).reshape(-1)]
            ptr = off + g * h * h
        params = torch.cat(pieces + [params[ptr:]])
    ins = [t["data"], params, t["state"]] + (
        [t["state_cell"]] if mode == "lstm" else [])
    outs = schema.fcompute(attrs, OpCtx(is_train=True), *ins)
    cts = [t["g_y"], t["g_h"]] + ([t["g_c"]] if mode == "lstm" else [])
    loss = sum((o * g).sum() for o, g in zip(outs, cts))
    grads = torch.autograd.grad(loss, [t[k] for k in leaves])
    res = {"output": outs[0], "h": outs[1]}
    if mode == "lstm":
        res["c"] = outs[2]
    res.update({"grad:" + k: g for k, g in zip(leaves, grads)})
    return {k: v.detach().to("cpu", torch.float64).numpy()
            for k, v in res.items()}


def _profiled_ms(fn, iters):
    """(device ms a call: the kernels' time under torch.profiler, wall ms
    a call without the profiler, wall ms a call under it, kernels a call)
    of ``fn`` after one warm-up call. bench_ms's spin cannot hold the card
    for a call of thousands of launches: the launch queue fills and the
    host waits on the card."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    _sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    _sync()
    wall = (time.perf_counter() - t0) * 1e3 / iters
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        _sync()
        wall_profiled = (time.perf_counter() - t0) * 1e3 / iters
    rows = _device_rows(prof, iters)
    return (sum(r[1] for r in rows), wall, wall_profiled,
            sum(r[2] for r in rows))


def _rnn_lane_timing():
    """The RNN op's forward + backward at the lstm_lm lane's shape (2
    layers, seq 64, batch 32, 512 -> 512) beside torch.nn.LSTM's (cuDNN,
    TF32 off in f32) on the same weights, in f32 and bf16, eager: device
    ms a call, wall ms a call without and under the profiler, kernels a
    call; the op's output against the library's."""
    import torch
    from mxnet_tpu_torch.ops import nn as nnops
    from mxnet_tpu_torch.ops.registry import OpCtx, get_op
    c = LSTM_LM
    T, N, H, L = c["seq"], c["batch"], c["hidden"], c["layers"]
    torch.manual_seed(SEED)
    lib32 = torch.nn.LSTM(H, H, num_layers=L).to(DEV)
    flat32 = torch.cat(
        [getattr(lib32, f"weight_{k}_l{i}").detach().reshape(-1)
         for i in range(L) for k in ("ih", "hh")]
        + [getattr(lib32, f"bias_{k}_l{i}").detach()
           for i in range(L) for k in ("ih", "hh")])
    schema = get_op("RNN")
    attrs = schema.parse_attrs(dict(state_size=H, num_layers=L,
                                    mode="lstm", state_outputs=True))
    octx = OpCtx(is_train=True)
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    res = {"shape": {"seq": T, "batch": N, "input": H, "hidden": H,
                     "layers": L}, "iters": RNN_TIME_ITERS}
    flops = 2 * 3 * 4 * H * (H + H) * T * N * L   # fwd + bwd products
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        lib = torch.nn.LSTM(H, H, num_layers=L).to(DEV, dt)
        lib.load_state_dict(lib32.state_dict())
        lib.flatten_parameters()
        flat = flat32.to(dt).requires_grad_(True)
        x = torch.randn((T, N, H), generator=gen, device=DEV).to(dt) \
            .requires_grad_(True)
        h0 = (0.1 * torch.randn((L, N, H), generator=gen, device=DEV)) \
            .to(dt).requires_grad_(True)
        c0 = (0.1 * torch.randn((L, N, H), generator=gen, device=DEV)) \
            .to(dt).requires_grad_(True)
        gy = torch.randn((T, N, H), generator=gen, device=DEV).to(dt)

        def op_call():
            y = schema.fcompute(attrs, octx, x, flat, h0, c0)[0]
            torch.autograd.grad(y, [x, flat, h0, c0], gy)
            return y

        def lib_call():
            y = lib(x, (h0, c0))[0]
            torch.autograd.grad(y, [x, h0, c0] + list(lib.parameters()), gy)
            return y

        row = {}
        with nnops.cudnn_f32():
            for who, fn in (("op", op_call), ("cudnn", lib_call)):
                row[who + "_ms"], row[who + "_wall_ms"], \
                    row[who + "_wall_profiled_ms"], \
                    row[who + "_kernels"] = _profiled_ms(fn, RNN_TIME_ITERS)
            with torch.no_grad():
                y_op = schema.fcompute(attrs, octx, x, flat, h0, c0)[0]
                y_lib = lib(x, (h0, c0))[0]
        row["op_vs_cudnn_max_rel_err"] = _rel_err(
            y_op.float().cpu().numpy(), y_lib.float().cpu().numpy())
        row["op_over_cudnn"] = row["op_ms"] / row["cudnn_ms"] \
            if row["cudnn_ms"] else None
        # each input read once (x, parameters, both states, dy), each
        # output written once (y, dx, d parameters, both state gradients)
        io_bytes = 2 * (x.numel() + flat.numel() + h0.numel() + c0.numel()) \
            * x.element_size() + gy.numel() * gy.element_size() \
            + y_op.numel() * y_op.element_size()
        row["bound_ms"], row["bound_by"] = bound_ms(
            io_bytes, flops, PEAK_F32_FLOPS if dt == torch.float32
            else PEAK_BF16_FLOPS)
        res[name] = row
    del lib, lib32
    _free_card()
    return res


def _gluon_rnn_check():
    """tests/test_gluon.py's check on the card: gluon.rnn.LSTM (the fused
    op) against LSTMCell.unroll with the same weights, eager and
    hybridized."""
    import numpy as np
    import mxnet_tpu_torch as mx
    c = RNN_CHECK
    T, N, I, H = c["seq"], c["batch"], c["input"], c["hidden"]
    rng = np.random.RandomState(SEED)
    x = rng.uniform(-1, 1, (T, N, I)).astype(np.float32)
    ctx = _ctx()
    layer = mx.gluon.rnn.LSTM(H, num_layers=1, layout="TNC", input_size=I)
    layer.initialize(mx.init.Xavier(), ctx=ctx)
    fused = layer(mx.nd.array(x, ctx=ctx)).asnumpy()
    layer.hybridize()
    hybrid = layer(mx.nd.array(x, ctx=ctx)).asnumpy()
    cell = mx.gluon.rnn.LSTMCell(H, input_size=I)
    cell.initialize(ctx=ctx)
    for n in ("i2h_weight", "h2h_weight", "i2h_bias", "h2h_bias"):
        getattr(cell, n).set_data(getattr(layer, "l0_" + n).data())
    outs, _ = cell.unroll(T, [mx.nd.array(x[t], ctx=ctx) for t in range(T)])
    unrolled = np.stack([o.asnumpy() for o in outs])
    err = _rel_err(fused, unrolled)
    res = {"shape": [T, N, I, H], "fused_vs_cell_max_rel_err": err,
           "hybrid_vs_eager_max_rel_err": _rel_err(hybrid, fused),
           "rtol": GLUON_RNN_RTOL}
    res["ok"] = bool(err <= GLUON_RNN_RTOL
                     and res["hybrid_vs_eager_max_rel_err"] <= 1e-6)
    return res


def phase_rnn_op():
    """The RNN op on the card in its four modes (see RNN_CHECK), its time
    at the lstm_lm lane's shape beside cuDNN's, and gluon.rnn.LSTM against
    LSTMCell.unroll."""
    import numpy as np
    import torch
    _free_card()
    rng = np.random.RandomState(SEED)
    cases = []
    for mode in ("lstm", "gru", "rnn_tanh", "rnn_relu"):
        for bi in (False, True):
            arrays = _rnn_arrays(rng, mode, bi)
            ref = _rnn_tensors(mode, bi, "cpu", torch.float64, arrays)
            cpu = _rnn_tensors(mode, bi, "cpu", torch.float32, arrays)
            card = _rnn_tensors(mode, bi, DEV, torch.float32, arrays)
            ctrl = _rnn_tensors(mode, bi, DEV, torch.float32, arrays,
                                faulty=True)
            rule = _f32_rule(card, cpu, ref)
            ctrl_rule = _f32_rule(ctrl, cpu, ref)
            cases.append({
                "mode": mode, "bidirectional": bi,
                "output_err": rule["output_err"],
                "norm_err_median": rule["norm_err_median"],
                "norm_err_max": rule["norm_err_max"],
                "worst": rule["worst"][:2],
                "control_output_err": ctrl_rule["output_err"]["card"],
                "control_norm_err_max": ctrl_rule["norm_err_max"]["card"],
                "control_fails": not ctrl_rule["ok"],
                "ok": bool(rule["ok"] and not ctrl_rule["ok"])})
    res = {"check": RNN_CHECK, "factor": R50_F32_FACTOR, "cases": cases,
           "gluon": _gluon_rnn_check()}
    res["timing"] = _rnn_lane_timing() if DEV == "cuda" else None
    res["ok"] = bool(all(c_["ok"] for c_ in cases) and res["gluon"]["ok"])
    RECORD["rnn_op"] = res
    _free_card()
    if not res["ok"]:
        raise AssertionError("rnn_op failed: %s"
                             % json.dumps(res, default=str)[:4000])
    return res


def _lstm_shapes(b):
    c = LSTM_LM
    st = (b, c["layers"], c["hidden"])
    return {"data": (b, c["seq"]), "state": st, "state_cell": st,
            "softmax_label": (b * c["seq"],)}


def _lstm_trainer(sym, dtype, batch, device=None, momentum=0.0):
    """bench.py's lstm_lm trainer on one device (``DEV`` unless
    ``device`` names another)."""
    from mxnet_tpu_torch.parallel import DataParallelTrainer, \
        data_parallel_mesh
    device = device or DEV
    mesh = data_parallel_mesh(1) if device == "cuda" else \
        data_parallel_mesh(1, [device])
    return DataParallelTrainer(
        sym, mesh, data_names=("data", "state", "state_cell"),
        label_names=("softmax_label",), optimizer="sgd",
        learning_rate=LSTM_LR, momentum=momentum,
        rescale_grad=1.0 / (batch * LSTM_LM["seq"]), dtype=dtype)


def _lstm_stepk_check(sym):
    """step_k(K, unroll) against K step calls from the same state at the
    lane's batch in bf16: each parameter within LSTM_STEPK_RTOL of its
    tensor's largest magnitude."""
    import numpy as np
    import torch
    c, b, k = LSTM_LM, LSTM_LM["batch"], LSTM_K
    shapes = _lstm_shapes(b)
    rng = np.random.RandomState(SEED)
    xs = rng.randint(0, c["vocab"], (k, b, c["seq"])).astype(np.float32)
    h0s = np.zeros((k,) + shapes["state"], np.float32)
    ys = rng.randint(0, c["vocab"], (k, b * c["seq"])).astype(np.float32)
    out, captures = [], []
    for fused in (True, False):
        tr = _lstm_trainer(sym, "bfloat16", b)
        p, st, a = tr.init_state(shapes)
        inputs = tr.shard_inputs([xs, h0s, h0s.copy(), ys], stacked=True)
        if fused:
            p, st, a, losses, _ = tr.step_k(p, st, a, inputs,
                                            unroll=LSTM_UNROLL)
        else:
            losses = []
            for i in range(k):
                p, st, a, loss, _ = tr.step(p, st, a,
                                            [x_[i] for x_ in inputs])
                losses.append(loss)
            losses = torch.stack(losses)
        out.append([losses.cpu().numpy()] + [t.cpu().numpy() for t in p])
        captures.append(tr.captures)
        del tr, p, st, a
        _free_card()
    err = max(_rel_err(u, v) for u, v in zip(*out))
    return {"k": k, "unroll": LSTM_UNROLL, "batch": b, "max_rel_err": err,
            "rtol": LSTM_STEPK_RTOL, "captures": captures,
            "ok": bool(err <= LSTM_STEPK_RTOL and captures == [
                1 if DEV == "cuda" else 0] * 2)}


def _lstm_reference(sym, shapes, params, feed):
    """The float64 step of the executor on the CPU from ``params``: the
    output and each parameter's momentum after one step from zero (-lr x
    rescale x its gradient, formed in float64)."""
    import numpy as np
    import mxnet_tpu_torch as mx
    ex = sym.simple_bind(ctx=mx.cpu(), type_dict={
        n: "float64" for n in sym.list_arguments()}, **shapes)
    ex.copy_params_from({n: mx.nd.array(v, ctx=mx.cpu())
                         for n, v in params.items()})
    ex.forward(is_train=True, **{n: mx.nd.array(v, ctx=mx.cpu())
                                 for n, v in feed.items()})
    ex.backward()
    scale = -LSTM_LR / shapes["softmax_label"][0]
    ref = {"output": ex.outputs[0].asnumpy().astype(np.float64)}
    ref.update({"mom:" + n: scale * ex.grad_dict[n].asnumpy()
                for n in params})
    return ref


def _lstm_card_vs_cpu(sym):
    """One f32 trainer step (momentum 0.9) at batch LSTM_CHECK_BATCH from
    the trainer's draw, on the card and on the CPU, each against the
    float64 step on the CPU by _f32_rule; the card's step with the
    recurrent blocks R of the RNN parameters' momentum zeroed must fail
    it."""
    import numpy as np
    c, b = LSTM_LM, LSTM_CHECK_BATCH
    shapes = _lstm_shapes(b)
    rng = np.random.RandomState(SEED)
    feed = {"data": rng.randint(0, c["vocab"], shapes["data"]),
            "state": rng.uniform(-0.5, 0.5, shapes["state"]),
            "state_cell": rng.uniform(-0.5, 0.5, shapes["state_cell"]),
            "softmax_label": rng.randint(0, c["vocab"],
                                         shapes["softmax_label"])}
    feed = {k: v.astype(np.float32) for k, v in feed.items()}
    tr = _lstm_trainer(sym, "float32", b, "cpu", momentum=0.9)
    params = tr.host_params(tr.init_state(shapes)[0])
    del tr

    def step(device):
        tr = _lstm_trainer(sym, "float32", b, device, momentum=0.9)
        p, st, a = tr.init_state(shapes, arg_params=params)
        p, st, a, _, outs = tr.step(p, st, a, tr.shard_inputs(
            [feed[n] for n in tr.input_names]))
        t = {"output": outs[0].float().cpu().numpy().astype(np.float64)}
        t.update({"mom:" + n: s_[0].cpu().numpy().astype(np.float64)
                  for n, s_ in zip(tr.param_names, st)})
        del tr, p, st, a
        _free_card()
        return t
    ref = _lstm_reference(sym, shapes, params, feed)
    card, cpu = step(DEV), step("cpu")
    res = _f32_rule(card, cpu, ref)
    mom = card["mom:rnn_params"].copy()
    h = c["hidden"]
    for off, g in _r_blocks("lstm", c["layers"], 1, h, h).values():
        mom[off:off + g * h * h] = 0.0
    ctrl = _f32_rule(dict(card, **{"mom:rnn_params": mom}), cpu, ref)
    res.update({"batch": b, "params": "init_state (N(0, 0.01))",
                "control_r_grad_zeroed": {
                    "norm_err_max": ctrl["norm_err_max"]["card"],
                    "fails": not ctrl["ok"]}})
    res["ok"] = bool(res["ok"] and not ctrl["ok"])
    return res


def phase_lstm_lm():
    """bench.py's lstm_lm lane through the port's DataParallelTrainer on
    one card (see LSTM_LM): the checks, then step_k windows, single
    steps, a profiled dispatch."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    import mxnet_tpu_torch as mx
    _free_card()
    c, b, k = LSTM_LM, LSTM_LM["batch"], LSTM_K
    with mx.NameManager():
        sym = lstm_lm_symbol(mx.sym, c["vocab"], c["hidden"], c["layers"])
    res = {"config": c, "k": k, "unroll": LSTM_UNROLL, "dtype": "bfloat16",
           "optimizer": "sgd lr 0.1 rescale_grad 1/(batch x seq)"}
    t0 = time.perf_counter()
    res["step_k_check"] = _lstm_stepk_check(sym)
    res["card_vs_cpu"] = _lstm_card_vs_cpu(sym)
    res["check_s"] = time.perf_counter() - t0
    shapes = _lstm_shapes(b)
    rng = np.random.RandomState(0)          # bench.py's draws, in order
    x = rng.randint(0, c["vocab"], (b, c["seq"])).astype(np.float32)
    h0 = np.zeros(shapes["state"], np.float32)
    y = rng.randint(0, c["vocab"], (b * c["seq"],)).astype(np.float32)
    xs = rng.randint(0, c["vocab"], (k, b, c["seq"])).astype(np.float32)
    h0s = np.zeros((k,) + shapes["state"], np.float32)
    ys = rng.randint(0, c["vocab"], (k, b * c["seq"])).astype(np.float32)
    tokens = b * c["seq"]
    _reset_counts()
    tr = _lstm_trainer(sym, "bfloat16", b)
    p, st, a = tr.init_state(shapes)
    inputs = tr.shard_inputs([x, h0, h0.copy(), y])
    inputs_k = tr.shard_inputs([xs, h0s, h0s.copy(), ys], stacked=True)
    t1 = time.perf_counter()
    p, st, a, losses, _ = tr.step_k(p, st, a, inputs_k, unroll=LSTM_UNROLL)
    float(losses[-1])
    res["first_dispatch_s"] = time.perf_counter() - t1
    for _ in range(2):
        p, st, a, loss, _ = tr.step(p, st, a, inputs)
    float(loss)
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    rates = []
    for _ in range(LSTM_WINDOWS):
        _sync()
        t1 = time.perf_counter()
        for _ in range(LSTM_WINDOW // k):
            p, st, a, losses, _ = tr.step_k(p, st, a, inputs_k,
                                            unroll=LSTM_UNROLL)
        float(losses[-1])
        rates.append(LSTM_WINDOW * tokens / (time.perf_counter() - t1))
    _sync()
    t1 = time.perf_counter()
    for _ in range(LSTM_SINGLE):
        p, st, a, loss, _ = tr.step(p, st, a, inputs)
    float(loss)
    single = LSTM_SINGLE * tokens / (time.perf_counter() - t1)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        p, st, a, losses, _ = tr.step_k(p, st, a, inputs_k,
                                        unroll=LSTM_UNROLL)
        _sync()
    rows = _device_rows(prof, k)
    tok_s = float(np.median(rates))
    step_ms = tokens / tok_s * 1e3
    dev_ms = sum(r[1] for r in rows)
    gemm = sum(r[1] for r in rows if any(
        w in r[0].lower() for w in ("gemm", "cutlass", "nvjet", "xmma")))
    res.update({
        "tokens_per_s": tok_s, "tokens_per_s_windows": rates,
        "tokens_per_s_single_dispatch": single, "step_ms": step_ms,
        "device_ms_per_step": dev_ms,
        "device_busy_share": dev_ms / step_ms,
        "gemm_ms_per_step": gemm,
        "kernels_a_step": sum(r[2] for r in rows),
        "top": [{"kernel": k_[:120], "ms_per_step": t_, "calls": c_}
                for k_, t_, c_ in rows[:12]],
        "peak_mem_gb": (torch.cuda.max_memory_allocated() / 1e9
                        if DEV == "cuda" else 0.0),
        "captures": tr.captures, "graphs": tr.graph_stats(),
        "params_finite": bool(all(torch.isfinite(t_).all() for t_ in p)),
        "launches": _read_counts(),
        "seconds_total": time.perf_counter() - t0})
    res["ok"] = bool(res["step_k_check"]["ok"] and res["card_vs_cpu"]["ok"]
                     and res["params_finite"]
                     and tr.captures == (1 if DEV == "cuda" else 0))
    RECORD["lstm_lm"] = res
    del tr, p, st, a
    _free_card()
    if not res["ok"]:
        raise AssertionError("lstm_lm failed: %s"
                             % json.dumps(res, default=str)[:4000])
    return res


def _bucket_corpus(c):
    """BUCKET_LM's synthetic sentences from SEED: lengths uniform on
    2..max bucket, words Zipf (s = 1) on 1..vocab-1."""
    import numpy as np
    rng = np.random.RandomState(SEED)
    ranks = np.arange(1, c["vocab"])
    p = 1.0 / ranks
    p /= p.sum()
    lens = rng.randint(2, max(c["buckets"]) + 1, c["sentences"])
    words = rng.choice(ranks, size=int(lens.sum()), p=p)
    return [w.tolist() for w in np.split(words, np.cumsum(lens)[:-1])]


def _bucket_sym_gen(mx, c):
    """The sym_gen of MXNet's example/rnn/bucketing at BUCKET_LM's widths:
    Embedding -> stacked LSTMCells unrolled to the bucket's length ->
    FullyConnected -> SoftmaxOutput."""
    stack = mx.rnn.SequentialRNNCell()
    for i in range(c["layers"]):
        stack.add(mx.rnn.LSTMCell(num_hidden=c["hidden"],
                                  prefix="lstm_l%d_" % i))

    def sym_gen(seq_len):
        data = mx.sym.Variable("data")
        label = mx.sym.Variable("softmax_label")
        embed = mx.sym.Embedding(data, input_dim=c["vocab"],
                                 output_dim=c["embed"], name="embed")
        stack.reset()
        outputs, _ = stack.unroll(seq_len, inputs=embed,
                                  merge_outputs=True)
        pred = mx.sym.Reshape(outputs, shape=(-1, c["hidden"]))
        pred = mx.sym.FullyConnected(pred, num_hidden=c["vocab"],
                                     name="pred")
        lab = mx.sym.Reshape(label, shape=(-1,))
        return (mx.sym.SoftmaxOutput(pred, lab, name="softmax"),
                ("data",), ("softmax_label",))
    return sym_gen


def _bucketing_card_vs_cpu(mx, c, sentences):
    """One training step a bucket (forward_backward, update) on the card
    and on the CPU from the same parameters and batches: after each step
    every parameter within BUCKET_STEP_RTOL of its tensor's largest
    magnitude."""
    import random
    import numpy as np
    mods = []
    for ctx in (_ctx(), mx.cpu()):
        np.random.seed(SEED)
        random.seed(SEED)
        it = mx.rnn.BucketSentenceIter(sentences, c["batch"],
                                       buckets=list(c["buckets"]),
                                       invalid_label=0)
        mod = mx.mod.BucketingModule(
            _bucket_sym_gen(mx, c), context=ctx,
            default_bucket_key=it.default_bucket_key)
        mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
        mods.append((mod, it))
    (card, it_card), (cpu, it_cpu) = mods
    cpu.init_params(initializer=mx.init.Xavier(factor_type="in",
                                               magnitude=2.34))
    card.init_params(arg_params=cpu.get_params()[0], aux_params={},
                     force_init=True)
    for m in (card, cpu):
        m.init_optimizer(optimizer="sgd", optimizer_params={
            "learning_rate": c["lr"], "momentum": 0.0, "wd": c["wd"]})
    errs = {}
    for b_card, b_cpu in zip(it_card, it_cpu):
        key = b_card.bucket_key
        if key != b_cpu.bucket_key:
            raise AssertionError("bucket keys differ: %s, %s"
                                 % (key, b_cpu.bucket_key))
        if key in errs:
            continue
        for m, b in ((card, b_card), (cpu, b_cpu)):
            m.forward_backward(b)
            m.update()
        p_card, p_cpu = card.get_params()[0], cpu.get_params()[0]
        errs[key] = max(_rel_err(p_card[n].asnumpy(), p_cpu[n].asnumpy())
                        for n in p_cpu)
    worst = max(errs.values())
    return {"steps": len(errs), "max_rel_err_by_bucket": errs,
            "rtol": BUCKET_STEP_RTOL,
            "ok": bool(len(errs) == len(c["buckets"])
                       and worst <= BUCKET_STEP_RTOL)}


def _bucketing_full_width():
    """BucketingModule at BUCKET_LM's widths on the card: perplexity
    before and after BUCKET_LM["epochs"] epochs of BaseModule.fit, the
    last epoch timed (tokens/s, samples/s, steps/s, median ms a step by
    bucket), the modules bound and their parameter buffers; then one step
    a bucket against the CPU (_bucketing_card_vs_cpu). The global
    generators are seeded from SEED first."""
    import random
    import numpy as np
    import torch
    import mxnet_tpu_torch as mx
    c = BUCKET_LM
    np.random.seed(SEED)
    random.seed(SEED)
    mx.random.seed(SEED)
    t0 = time.perf_counter()
    sentences = _bucket_corpus(c)
    train = mx.rnn.BucketSentenceIter(sentences, c["batch"],
                                      buckets=list(c["buckets"]),
                                      invalid_label=0)
    sym_gen = _bucket_sym_gen(mx, c)

    mod = mx.mod.BucketingModule(sym_gen, context=_ctx(),
                                 default_bucket_key=train.default_bucket_key)
    mod.bind(data_shapes=train.provide_data,
             label_shapes=train.provide_label)
    init = mx.init.Xavier(factor_type="in", magnitude=2.34)
    mod.init_params(initializer=init)
    ppl0 = mod.score(train, mx.metric.Perplexity(0))[0][1]
    marks = []

    def mark(param):
        marks.append((param.epoch, param.locals["data_batch"].bucket_key,
                      time.perf_counter()))
    epoch_starts = {}

    def epoch_end(epoch, *_):
        _sync()
        epoch_starts[epoch + 1] = time.perf_counter()
    train.reset()
    _sync()
    epoch_starts[0] = time.perf_counter()
    mod.fit(train, num_epoch=c["epochs"], optimizer="sgd",
            optimizer_params={"learning_rate": c["lr"], "momentum": 0.0,
                              "wd": c["wd"]},
            initializer=init, eval_metric=mx.metric.Perplexity(0),
            batch_end_callback=mark, epoch_end_callback=epoch_end)
    last = c["epochs"] - 1
    ppl1 = mod.score(train, mx.metric.Perplexity(0))[0][1]
    first = sum(1 for m in marks if m[0] == 0)
    timed = [m for m in marks if m[0] == last]
    prev = [epoch_starts[last]] + [m[2] for m in timed[:-1]]
    per_bucket = {}
    for (_, key, t), t_prev in zip(timed, prev):
        per_bucket.setdefault(key, []).append((t - t_prev) * 1e3)
    seconds = epoch_starts[last + 1] - epoch_starts[last]
    steps = len(timed)
    positions = sum(key for _, key, _ in timed) * c["batch"]
    ptrs = {}
    for m in mod._buckets.values():
        for n in m._param_names:
            ptrs.setdefault(n, set()).add(
                m._exec.arg_dict[n]._data.data_ptr())
    args, _ = mod.get_params()
    res = {"config": dict(c, buckets=list(c["buckets"])),
           "source": "MXNet example/rnn/bucketing/lstm_bucketing.py "
                     "defaults, PTB vocab; synthetic Zipf corpus",
           "perplexity_before": ppl0, "perplexity_after": ppl1,
           "epoch_s": seconds, "steps": steps,
           "steps_per_s": steps / seconds,
           "samples_per_s": steps * c["batch"] / seconds,
           "tokens_per_s": positions / seconds,
           "step_ms_median_by_bucket": {
               k: float(np.median(v)) for k, v in sorted(per_bucket.items())},
           "first_epoch_s": epoch_starts[1] - epoch_starts[0],
           "first_epoch_steps": first,
           "buckets": sorted(mod._buckets),
           "params_shared": bool(ptrs) and all(len(v) == 1
                                                for v in ptrs.values()),
           "params_finite": bool(all(np.isfinite(v.asnumpy()).all()
                                     for v in args.values())),
           "peak_mem_gb": (torch.cuda.max_memory_allocated() / 1e9
                           if DEV == "cuda" else 0.0)}
    del mod, train
    _free_card()
    res["card_vs_cpu"] = _bucketing_card_vs_cpu(mx, c, sentences)
    res["ok"] = bool(res["buckets"] == list(c["buckets"])
                     and first == steps > 0 and res["params_shared"]
                     and res["params_finite"]
                     and math.isfinite(ppl1) and ppl1 < ppl0
                     and res["card_vs_cpu"]["ok"])
    res["seconds_total"] = time.perf_counter() - t0
    _free_card()
    return res


def phase_lstm_bucketing():
    """examples/lstm_bucketing.py's program on the card through the port:
    its source with ``mxnet_tpu`` imported as ``mxnet_tpu_torch``, run with
    ``--ctx gpu`` and its own other arguments; its own bar (final train
    perplexity < 8.0, exit code 0); the bucket modules it bound (BUCKETS)
    and that their parameters are one buffer (the same data_ptr). Then
    BucketingModule at real widths (BUCKET_LM)."""
    import io
    import torch
    import mxnet_tpu_torch as mx
    path = os.path.join(HERE, "examples", "lstm_bucketing.py")
    with open(path) as f:
        src = f.read()
    a, b = "import mxnet_tpu as mx", "import mxnet_tpu_torch as mx"
    if a not in src:
        raise AssertionError("examples/lstm_bucketing.py has no %r" % a)
    src = src.replace(a, b)
    made, updates = [], [0]
    base = mx.mod.BucketingModule

    class Recorded(base):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

        def update(self):
            updates[0] += 1
            super().update()
    mx.mod.BucketingModule = Recorded
    argv = sys.argv
    sys.argv = [path, "--ctx", "gpu" if DEV == "cuda" else "cpu"]
    buf = io.StringIO()
    _reset_counts()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            exec(compile(src, path, "exec"), {"__name__": "__main__",
                                              "__file__": path})
        code = 0
    except SystemExit as e:
        code = e.code
    finally:
        sys.argv = argv
        mx.mod.BucketingModule = base
    seconds = time.perf_counter() - t0
    lines = buf.getvalue().strip().splitlines()
    mod = made[0] if made else None
    buckets = sorted(mod._buckets) if mod is not None else []
    ptrs = {}
    if mod is not None:
        for key, m in mod._buckets.items():
            for n in m._param_names:
                ptrs.setdefault(n, set()).add(
                    m._exec.arg_dict[n]._data.data_ptr())
    res = {"program": "examples/lstm_bucketing.py", "exit_code": code,
           "lines": lines[-3:], "seconds": seconds,
           "train_steps": updates[0],
           "steps_per_s": updates[0] / seconds, "buckets": buckets,
           "bucket_modules": len(buckets),
           "params_shared": bool(ptrs) and all(len(v) == 1
                                                for v in ptrs.values()),
           "param_buffers": {n: len(v) for n, v in ptrs.items()},
           "launches": _read_counts()}
    res["ok"] = bool(code == 0 and len(buckets) == BUCKETS
                     and res["params_shared"])
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    res["full_width"] = _bucketing_full_width()
    res["ok"] = bool(res["ok"] and res["full_width"]["ok"])
    RECORD["lstm_bucketing"] = res
    _free_card()
    if not res["ok"]:
        raise AssertionError("lstm_bucketing failed: %s" % json.dumps(res))
    return res


# -- the predict tier and int8 Symbols ---------------------------------------

PREDICT_BATCH = 32           # bench.py's INFER_BATCH (inference_resnet50)
PREDICT_IMG = 224
PREDICT_ITERS = 20           # timed infer calls a bucket
PREDICT_YARD_LOOPS = (3, 20)  # bench.py's _infer_ips: 3 loops (of 50 there)
PREDICT_CHECK_BATCH = 2      # the card-vs-CPU request
PREDICT_BN_PASSES = 30       # training-mode passes that set the BN statistics
BUCKET_RTOL = 1e-5           # a bucket's rows against the predictor's
BATCHER = dict(clients=64, seconds=10.0, max_wait_us=2000, queue_depth=256)
INT8_MLP = dict(d_in=256, d_h=1024, d_out=256, batch=32, iters=60)
QUANT_CALIB_BATCHES = 2
QUANT_CHECK_ROWS = 4         # rows of each quantized node held against the CPU
QUANT_K4608 = (PREDICT_BATCH, 512, 7, 7)   # stage 4's 3x3 convolution input
# the served bf16 ResNet-50 batch (norm-wise error of the probabilities)
# against the executor's bf16 walk on the same images (the same casts and
# ops, run eagerly): within walk; against the f32 batch: as far as the
# walk is from it (ratio within [1/ratio, ratio]: the cast shows), top-1
# agreement at least top1. The f32 batch itself (a program that never
# casts) and the bf16 rows shifted by one row must fail. Readings on an
# H100 80GB HBM3 at 700 W: served vs walk 0.0 (as on the CPU), bf16 vs
# f32 0.184, top-1 0.875; the f32 batch vs the walk 0.183; the shifted
# rows vs the walk 0.272, top-1 0.875 (the argmax varies little over
# images, so top-1 alone cannot tell the rows apart).
BF16_CHECK = dict(walk=1e-2, ratio=2.0, top1=0.75)
INT8_MAX_ABS_ERR = 1e-2      # int8_serving: int8 against bf16 (PERF.md 2)
SERVE_REPLICAS = 2
# the network tier at full width: 64 urllib clients, each sending
# NET_REQUESTS 1-image requests of 224 x 224 (3 MB of JSON) back to back
NET_CLIENTS, NET_REQUESTS, NET_DEADLINE_MS = 64, 2, 60000
# :generate at the export phase's cut of GPT-2 medium (its widths, 2 of
# 24 layers); the control shifts the position table by one
GEN_NEW_TOKENS = 16


def _serve_device():
    """The entry points' device: None (their default, the card), or the
    host when the phases are rehearsed with DEV = "cpu"."""
    return None if DEV == "cuda" else "cpu"


def _example_context():
    """The context an example runs in: the port's default (the card), or
    the host context when rehearsed with DEV = "cpu"."""
    import mxnet_tpu_torch as mx
    return contextlib.nullcontext() if DEV == "cuda" else mx.cpu()


def _card_bytes():
    """(allocated, reserved, total) bytes of the card (zeros on the
    host)."""
    import torch
    if DEV != "cuda":
        return 0, 0, 0
    return (torch.cuda.memory_allocated(), torch.cuda.memory_reserved(),
            torch.cuda.mem_get_info()[1])


def _example_src(name, pairs):
    path = os.path.join(HERE, "examples", name)
    with open(path) as f:
        src = f.read()
    for a, b in pairs:
        if a not in src:
            raise AssertionError("examples/%s has no %r" % (name, a))
        src = src.replace(a, b)
    return path, src


def _run_example(path, src, argv):
    """exec an example's source as __main__ with ``argv``: (exit code,
    its stdout lines, seconds)."""
    import io
    old, sys.argv = sys.argv, [path] + list(argv)
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            exec(compile(src, path, "exec"), {"__name__": "__main__",
                                              "__file__": path})
        code = 0
    except SystemExit as e:
        code = e.code
    finally:
        sys.argv = old
    return code, buf.getvalue().strip().splitlines(), \
        time.perf_counter() - t0


@contextlib.contextmanager
def _digits_without_sklearn():
    """examples/export_predict.py reads sklearn's digits; where scikit-learn
    is not installed (the card's machine), ``sklearn.datasets.load_digits``
    is provided for the example's run from tools/data/digits.csv.gz, a copy
    of the file scikit-learn bundles (the UCI optical digits, 1797 x 64
    plus the label column)."""
    import gzip
    import importlib.machinery
    import importlib.util
    import types
    import numpy as np
    if importlib.util.find_spec("sklearn") is not None:
        yield False
        return

    def load_digits():
        with gzip.open(os.path.join(HERE, "tools", "data",
                                    "digits.csv.gz"), "rt") as f:
            d = np.loadtxt(f, delimiter=",")
        return types.SimpleNamespace(data=d[:, :-1],
                                     target=d[:, -1].astype(int),
                                     images=d[:, :-1].reshape(-1, 8, 8))
    pkg = types.ModuleType("sklearn")
    ds = types.ModuleType("sklearn.datasets")
    # specs, so that importlib.util.find_spec (torch.export's trace rules
    # ask it of loaded modules) finds these as it would the package
    pkg.__spec__ = importlib.machinery.ModuleSpec("sklearn", None,
                                                  is_package=True)
    ds.__spec__ = importlib.machinery.ModuleSpec("sklearn.datasets", None)
    ds.load_digits = load_digits
    pkg.datasets = ds
    sys.modules["sklearn"], sys.modules["sklearn.datasets"] = pkg, ds
    try:
        yield True
    finally:
        sys.modules.pop("sklearn", None)
        sys.modules.pop("sklearn.datasets", None)


def _r50_inference_params(mx, sym, shape):
    """ResNet-50 parameters drawn on the host from SEED (``_init_bound``),
    then PREDICT_BN_PASSES training-mode forwards on the card over one
    batch of images, so the moving statistics describe the activations
    (inference through identity BatchNorms would leave the logits in the
    thousands and the softmax one-hot). Returns (args, auxs) as numpy."""
    import numpy as np
    host = sym.simple_bind(ctx=mx.cpu(), grad_req="null", data=shape)
    _init_bound(host, mx, SEED)
    ex = sym.simple_bind(ctx=_ctx(), grad_req="null", data=shape)
    ex.copy_params_from(host.arg_dict, host.aux_dict)
    x = np.random.RandomState(SEED + 1).uniform(0, 1, shape).astype(
        np.float32)
    for _ in range(PREDICT_BN_PASSES):
        ex.forward(is_train=True, data=x)
    args = {n: a.asnumpy() for n, a in ex.arg_dict.items()
            if n not in ("data", "softmax_label")}
    auxs = {n: a.asnumpy() for n, a in ex.aux_dict.items()}
    return args, auxs


def _plan_yardstick(mx, sym, args, auxs, x, dtype):
    """bench.py's inference lane (``_infer_ips``) on the port: the
    executor's inference walk (``executor._Plan(sym, is_train=False)``)
    on the card at batch 32, params with ndim > 1 and the data in bf16
    for bf16 (the casts export_model's program makes); the median of
    PREDICT_YARD_LOOPS loops, img/s, the loops' rates and the walk's
    output on ``x``."""
    import numpy as np
    import torch
    from mxnet_tpu_torch.executor import _Plan
    dev = torch.device(DEV)
    plan = _Plan(sym, is_train=False)
    half = dtype == "bfloat16"

    def t(v):
        v = torch.from_numpy(np.ascontiguousarray(v)).to(dev)
        return v.to(torch.bfloat16) if half and v.ndim > 1 else v
    a = {n: t(v) for n, v in args.items()}
    a["data"] = t(x)
    a["softmax_label"] = torch.zeros(x.shape[0], device=dev)
    aux = {n: t(v) for n, v in auxs.items()}

    def run():
        with torch.no_grad():
            return plan.run(a, aux, dev)[0][0]
    run()
    _sync()
    loops, n = PREDICT_YARD_LOOPS
    rates = []
    for _ in range(loops):
        t0 = time.perf_counter()
        for _ in range(n):
            out = run()
        out = out.float().cpu()
        rates.append(n * x.shape[0] / (time.perf_counter() - t0))
    return float(np.median(rates)), rates, out.numpy()


def _replay_ms(eng, iters):
    """Device ms of one replay of the engine's graph (CUDA events on the
    engine's stream), the median of ``iters``."""
    import numpy as np
    import torch
    plan = eng._plan()
    st = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    en = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    with torch.cuda.stream(eng._stream):
        for i in range(iters):
            st[i].record()
            plan.graph.replay()
            en[i].record()
    eng._stream.synchronize()
    dev = [s.elapsed_time(e) for s, e in zip(st, en)]
    return float(np.median(dev))


def _conv_net_group(name):
    """The device-time group of a kernel of a served ResNet-50 replay."""
    n = name.lower()
    if "memcpy" in n or "memset" in n:
        return "memcpy_memset"
    if any(k in n for k in ("conv", "cudnn", "xmma", "implicit",
                            "winograd", "fprop", "sm90", "nchwtonhwc",
                            "nhwctonchw")):
        return "cudnn"
    if "gemm" in n or "nvjet" in n or "cutlass" in n:
        return "gemm"
    if "reduce" in n or "softmax" in n:
        return "reduce_softmax"
    if "elementwise" in n or "vectorized" in n or "unrolled" in n:
        return "elementwise"
    return "other"


def _replay_profile(eng, x, iters=5):
    """One profiler read of the bucket-32 plan served as a client sees it
    (``eng.infer`` on host rows: the pinned copy, the replay, the copy
    back): device ms a call by kernel group and the top kernels, and the
    wall ms under the profiler; the busy share is the device sum over
    the wall."""
    from torch.profiler import ProfilerActivity, profile
    eng.infer(x)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            eng.infer(x)
        wall = (time.perf_counter() - t0) * 1e3 / iters
    rows = _device_rows(prof, iters)
    groups = {}
    for k, ms, calls in rows:
        g = _conv_net_group(k)
        groups[g] = groups.get(g, 0.0) + ms
    dev = sum(r[1] for r in rows)
    return {"wall_ms": wall, "device_ms": dev,
            "busy": dev / wall if wall else None,
            "kernels_a_call": sum(r[2] for r in rows), "groups": groups,
            "top": [(k[:80], ms, calls) for k, ms, calls in rows[:8]]}


def _predict_artifact(mx, sym, args, auxs, x, dtype, td, res):
    """export_model on the card, Predictor and ServingEngine from the
    file; every bucket's rows against the predictor's; ms by bucket."""
    import numpy as np
    from mxnet_tpu_torch.contrib.export import export_model
    from mxnet_tpu_torch.predictor import Predictor
    from mxnet_tpu_torch.serving import ServingEngine
    tag = "f32" if dtype == "float32" else "bf16"
    path = os.path.join(td, "resnet50_%s.mxa" % tag)
    out = {"dtype": dtype}
    t0 = time.perf_counter()
    # the bf16 artifact is served on the card only: its cpu program is
    # not traced (the f32 artifact carries both)
    export_model(path, sym, args, auxs, {"data": x.shape}, dtype=dtype,
                 platforms=None if dtype == "float32" else (DEV,),
                 model_name="resnet50_%s" % tag)
    out["export_s"] = time.perf_counter() - t0
    import zipfile
    with zipfile.ZipFile(path) as z:
        man = json.loads(z.read("MANIFEST.json"))
        out["files"] = {i.filename: i.file_size for i in z.infolist()}
    out["platforms"] = man["platforms"]
    out["manifest_peak_bytes"] = (man.get("devstats") or {}).get(
        "peak_bytes")
    t0 = time.perf_counter()
    pred = Predictor(path, device=_serve_device())
    full = pred.forward(x)[0]
    out["predictor_load_forward_s"] = time.perf_counter() - t0
    out["finite"] = bool(np.isfinite(full).all())
    t0 = time.perf_counter()
    eng = ServingEngine(pred)
    out["engine_warmup_s"] = time.perf_counter() - t0
    out["plans"] = [{"batch": b, "graph": pl.graph is not None,
                     "capture_s": pl.capture_s, "peak_bytes": pl.peak_bytes,
                     "resident_bytes": eng.plan_bytes[b],
                     "launches": pl.launches}
                    for b, pl in sorted(eng._plans.items())]
    out["plan_resident_bytes"] = eng.plan_resident_bytes
    rows, ms = {}, {}
    for b in eng.buckets:
        got = eng.infer(x[:b])[0]
        err = float(np.abs(got - full[:b]).max()
                    / max(1e-30, np.abs(full[:b]).max()))
        rows[b] = err
        walls = []
        for _ in range(PREDICT_ITERS):
            t0 = time.perf_counter()
            eng.infer(x[:b])
            walls.append((time.perf_counter() - t0) * 1e3)
        ms[b] = float(np.median(walls))
    replay = _replay_ms(eng, PREDICT_ITERS) if DEV == "cuda" else None
    out.update(bucket_rel_err=rows, bucket_ms=ms, replay_ms=replay,
               img_s_b32=PREDICT_BATCH * 1e3 / ms[PREDICT_BATCH],
               img_s_b32_device=PREDICT_BATCH * 1e3 / replay
               if DEV == "cuda" else None,
               graphs=all(p["graph"] for p in out["plans"]),
               buckets_ok=all(e <= BUCKET_RTOL for e in rows.values()))
    if DEV == "cuda":
        out["replay_profile_b32"] = _replay_profile(eng, x)
    out["yardstick_img_s"], out["yardstick_loops"], walk = \
        _plan_yardstick(mx, sym, args, auxs, x, dtype)
    res[tag] = out
    return path, pred, eng, full, walk


def _wrong_rows_engine(pred):
    """The f32 rule's control: a ServingEngine whose plan slices the
    padding rows out of the program's outputs, not the request's."""
    from mxnet_tpu_torch.serving import ServingEngine

    class WrongRows(ServingEngine):
        def _rows(self, outs, n):
            return [o[self.max_batch - n:] for o in outs]
    return WrongRows(pred)


def _predict_f32_rule(mx, sym, args, auxs, x, path, eng, pred):
    """One batch-2 request served on the card and predicted on the CPU
    (the artifact's cpu program), each against the float64 forward (the
    executor on the card in float64): the card's error within
    R50_F32_FACTOR times the CPU's; the wrong-rows control must fail."""
    import torch
    from mxnet_tpu_torch.predictor import Predictor
    n = PREDICT_CHECK_BATCH
    shape = (n,) + x.shape[1:]
    ex = sym.simple_bind(ctx=_ctx(), grad_req="null", data=shape,
                         type_dict={k: "float64"
                                    for k in sym.list_arguments()})
    for k, v in auxs.items():
        ex.aux_dict[k]._data = torch.from_numpy(v).to(
            device=DEV, dtype=torch.float64)
    for k, v in args.items():
        ex.arg_dict[k]._data.copy_(torch.from_numpy(v))
    ref = ex.forward(is_train=False, data=x[:n].astype("float64"))[0] \
        .asnumpy()
    card = eng.infer(x[:n])[0]
    t0 = time.perf_counter()
    cpu = Predictor(path, device="cpu").forward(x[:n])[0]
    card_device = str(eng.device)
    cpu_s = time.perf_counter() - t0
    faulty = _wrong_rows_engine(pred).infer(x[:n])[0]
    err = {"card": _rel_err(card, ref), "cpu": _rel_err(cpu, ref),
           "control_wrong_rows": _rel_err(faulty, ref)}

    def rule(e):
        return e <= R50_F32_FACTOR * err["cpu"] + R50_F32_FLOOR
    return {"err": err, "factor": R50_F32_FACTOR, "cpu_forward_s": cpu_s,
            "served_on": card_device,
            "ok": bool(rule(err["card"])),
            "control_fails": not rule(err["control_wrong_rows"])}


def _bf16_vs_f32(b16, f32, walk):
    """The served bf16 batch against the executor's bf16 walk and against
    the f32 batch on the same images (BF16_CHECK); the f32 batch itself
    (a program that never casts) and the bf16 rows shifted by one row
    must fail."""
    import numpy as np
    c = BF16_CHECK

    def dist(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))
    walk_f32 = dist(walk, f32)

    def check(got):
        r = {"vs_walk": dist(got, walk), "vs_f32": dist(got, f32),
             "top1_vs_f32": float((got.argmax(1) == f32.argmax(1)).mean())}
        r["ok"] = bool(r["vs_walk"] <= c["walk"]
                       and walk_f32 / c["ratio"] <= r["vs_f32"]
                       <= walk_f32 * c["ratio"]
                       and r["top1_vs_f32"] >= c["top1"])
        return r
    out = dict(check(b16), walk_vs_f32=walk_f32, limits=c,
               controls={"no_cast": check(f32),
                         "rows_shifted": check(np.roll(b16, 1, axis=0))})
    out["controls_fail"] = not any(v["ok"] for v in out["controls"].values())
    out["ok"] = bool(out["ok"] and out["controls_fail"])
    return out


def _batcher_closed_loop(eng, x, full):
    """BATCHER["clients"] threads send 1-row requests back to back for
    BATCHER["seconds"] through a DynamicBatcher over ``eng``; every
    answer is held against the predictor's row."""
    import threading
    import numpy as np
    from mxnet_tpu_torch.serving import DynamicBatcher
    errs, fails = [0.0], []
    lock = threading.Lock()
    stop = [False]
    with DynamicBatcher(eng, max_wait_us=BATCHER["max_wait_us"],
                        queue_depth=BATCHER["queue_depth"]) as bat:
        def client(i):
            r = i % PREDICT_BATCH
            while not stop[0]:
                try:
                    out = bat.infer(x[r:r + 1], timeout_ms=30000)[0]
                except Exception as e:      # counted, reported below
                    with lock:
                        fails.append(repr(e)[:200])
                    continue
                e = float(np.abs(out[0] - full[r]).max())
                with lock:
                    errs[0] = max(errs[0], e)
        threads = [threading.Thread(target=client, args=(i,), daemon=True)
                   for i in range(BATCHER["clients"])]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        time.sleep(BATCHER["seconds"])
        stop[0] = True
        for t in threads:
            t.join(timeout=60)
        dt = time.perf_counter() - t0
        snap = bat.metrics.snapshot()
    scale = float(np.abs(full).max())
    return {"clients": BATCHER["clients"], "seconds": dt,
            "max_wait_us": BATCHER["max_wait_us"],
            "queue_depth": BATCHER["queue_depth"],
            "completed": snap["completed"], "qps": snap["completed"] / dt,
            "p50_ms": snap["p50_ms"], "p99_ms": snap["p99_ms"],
            "mean_batch": snap["avg_batch_rows"],
            "batch_hist": snap["batch_hist"], "shed": snap["shed"],
            "timeouts": snap["timeouts"], "errors": fails[:3],
            "n_errors": len(fails), "max_rel_err": errs[0] / scale,
            "ok": bool(not fails and snap["completed"] > 0
                       and errs[0] <= BUCKET_RTOL * scale)}


def _int8_serving_lane(td):
    """bench.py's int8_serving lane as written (bench.py:453-525): the
    256-1024-1024-256 MLP at batch 32 exported twice, bf16 and bf16 with
    weight-only int8, each served through ServingEngine(buckets=(32,));
    img/s the median of 3 loops of INT8_MLP["iters"] calls."""
    import zipfile
    import numpy as np
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.contrib.export import export_model
    from mxnet_tpu_torch.serving import ServingEngine
    c = INT8_MLP
    rng = np.random.RandomState(0)
    with mx.NameManager():
        net = mx.sym.FullyConnected(mx.sym.Variable("data"),
                                    num_hidden=c["d_h"], name="fc1")
        net = mx.sym.Activation(net, act_type="relu")
        net = mx.sym.FullyConnected(net, num_hidden=c["d_h"], name="fc2")
        net = mx.sym.Activation(net, act_type="relu")
        net = mx.sym.FullyConnected(net, num_hidden=c["d_out"], name="fc3")
        sym = mx.sym.SoftmaxOutput(net, name="softmax")
    shapes = {"data": (c["batch"], c["d_in"]),
              "softmax_label": (c["batch"],)}
    arg_shapes, _, _ = sym.infer_shape(**shapes)
    args = {n: rng.normal(0, 0.05, s).astype(np.float32)
            for n, s in zip(sym.list_arguments(), arg_shapes)
            if n not in ("data", "softmax_label")}
    x = rng.uniform(-1, 1, (c["batch"], c["d_in"])).astype(np.float32)

    def serve_ips(path):
        eng = ServingEngine(path, buckets=(c["batch"],),
                            device=_serve_device())
        try:
            out = np.asarray(eng.infer(x)[0])
            rates = []
            for _ in range(3):
                t0 = time.perf_counter()
                for _ in range(c["iters"]):
                    eng.infer(x)
                rates.append(c["iters"] * c["batch"]
                             / (time.perf_counter() - t0))
            return float(np.median(rates)), out
        finally:
            eng.close()
    p16 = os.path.join(td, "mlp_bf16.mxa")
    p8 = os.path.join(td, "mlp_int8.mxa")
    export_model(p16, sym, args, {}, {"data": shapes["data"]},
                 dtype="bfloat16")
    export_model(p8, sym, args, {}, {"data": shapes["data"]},
                 dtype="bfloat16", quantize="int8")
    with zipfile.ZipFile(p8) as z:
        quant = json.loads(z.read("MANIFEST.json")).get("quant") or {}
    bf16_ips, out16 = serve_ips(p16)
    int8_ips, out8 = serve_ips(p8)
    return {"batch": c["batch"], "bf16_ips": bf16_ips, "int8_ips": int8_ips,
            "int8_vs_bf16": int8_ips / bf16_ips,
            "max_abs_err": float(np.abs(out16 - out8).max()),
            "quantized_params": len(quant.get("params", [])),
            "max_abs_err_limit": INT8_MAX_ABS_ERR,
            "ok": bool(np.isfinite(out8).all()
                       and float(np.abs(out16 - out8).max())
                       <= INT8_MAX_ABS_ERR
                       and len(quant.get("params", [])) == 3)}


def _entry_name(node, idx):
    if node.op is None:
        return node.name
    return "%s_output%d" % (node.name, idx) if node.num_outputs() > 1 \
        else "%s_output" % node.name


def _ms_median(fn, iters=5):
    import numpy as np
    fn()
    _sync()
    walls = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        _sync()
        walls.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(walls))


def _quantized_conv_route(mx):
    """The int8 route at ResNet-50 stage 4's K = 4608 convolution
    (512 -> 512, 3 x 3, 7 x 7, batch 32): int8 inputs near +-127, so the
    int32 sums pass 2^24. The registered op on the card (float64 products)
    against the same op on the CPU, bit for bit; the control, the same
    convolution accumulated in float32 on the card (TF32 off), must
    differ. Device ms of the op's convolution beside the float32
    convolution's."""
    import numpy as np
    import torch
    from mxnet_tpu_torch.ops.nn import cudnn_f32
    from mxnet_tpu_torch.ops.registry import OpCtx, get_op
    rng = np.random.RandomState(SEED + 3)
    d = rng.randint(100, 128, QUANT_K4608).astype(np.int8)
    w = (rng.randint(100, 128, (512, 512, 3, 3))
         * rng.choice([-1, 1], (512, 1, 1, 1))).astype(np.int8)
    one = np.ones(1, np.float32)
    op = get_op("_contrib_quantized_conv")
    attrs = op.parse_attrs({"kernel": (3, 3), "num_filter": 512,
                            "pad": (1, 1), "no_bias": True})

    def run(device):
        ts = [torch.from_numpy(a).to(device) for a in (d, w, -one, one,
                                                       -one, one)]
        return op.fcompute(attrs, OpCtx(device=torch.device(device)),
                           *ts), ts
    (card, _, _), ts = run(DEV)
    cpu = run("cpu")[0][0]
    dc, wc = ts[0], ts[1]
    with cudnn_f32():
        f32 = torch.nn.functional.conv2d(dc.float(), wc.float(),
                                         padding=1)
    f32_int = torch.round(f32).to(torch.int32)
    q_ms = f_ms = None
    if DEV == "cuda":
        q_ms = bench_ms(lambda *a: op.fcompute(attrs, None, *a),
                        [tuple(ts)], 10)

        def f32_conv(a, b):
            with cudnn_f32():
                return torch.nn.functional.conv2d(a, b, padding=1)
        f_ms = bench_ms(f32_conv, [(dc.float(), wc.float())], 10)
    flops = 2.0 * 512 * 4608 * 49 * QUANT_K4608[0]
    return {"shape": list(QUANT_K4608), "k": 4608,
            "max_abs_int32": int(card.abs().max()),
            "card_equals_cpu": bool(torch.equal(card.cpu(), cpu)),
            "f32_route_wrong_elements": int((f32_int != card).sum()),
            "f32_route_max_abs_diff": int((f32_int - card).abs().max()),
            "int8_route_ms": q_ms, "f32_conv_ms": f_ms,
            "flops": flops,
            "ok": bool(torch.equal(card.cpu(), cpu)
                       and bool((f32_int != card).any()))}


def _quantize_resnet50(mx, sym, args, auxs, x, full_f32):
    """quantize_model on ResNet-50 (naive calibration over
    QUANT_CALIB_BATCHES batches of 32 on the card); the int8 graph on the
    card with a monitor over its quantized nodes, and each of those nodes
    run again on the CPU on the card's inputs (their first
    QUANT_CHECK_ROWS rows: each row is computed alone): the int32 / int8
    outputs and the range scalars must be bit-equal. Top-1 agreement and
    the largest probability error against float32, and the two graphs'
    ms on the card."""
    import numpy as np
    import torch
    from mxnet_tpu_torch.contrib.quantization import quantize_model
    from mxnet_tpu_torch.ops.registry import OpCtx
    rng = np.random.RandomState(SEED + 4)
    calib_x = rng.uniform(0, 1, (QUANT_CALIB_BATCHES * PREDICT_BATCH,)
                          + x.shape[1:]).astype(np.float32)
    calib = mx.io.NDArrayIter(calib_x, batch_size=PREDICT_BATCH,
                              label_name=None)
    nd_args = {k: mx.nd.array(v, ctx=_ctx()) for k, v in args.items()}
    nd_auxs = {k: mx.nd.array(v, ctx=_ctx()) for k, v in auxs.items()}
    t0 = time.perf_counter()
    qsym, qargs, qauxs = quantize_model(
        sym, nd_args, nd_auxs, ctx=_ctx(), calib_mode="naive",
        calib_data=calib, num_calib_examples=len(calib_x))
    out = {"quantize_s": time.perf_counter() - t0}
    qnodes = [n for n in qsym._topo() if n.op is not None
              and n.op.name.startswith("_contrib_quantized_")]
    out["quantized_nodes"] = {}
    for n in qnodes:
        out["quantized_nodes"][n.op.name] = \
            out["quantized_nodes"].get(n.op.name, 0) + 1
    ex = qsym.simple_bind(ctx=_ctx(), grad_req="null", data=x.shape)
    for k, v in list(qargs.items()) + list(qauxs.items()):
        # the offline ranges are 0-d, bound as (1,): assigned as the
        # example assigns them
        (ex.arg_dict if k in ex.arg_dict else ex.aux_dict)[k][:] = v
    needed = {_entry_name(s, i) for n in qnodes for (s, i) in n.inputs
              if s.op is not None}
    needed |= {_entry_name(n, i) for n in qnodes for i in range(3)}
    rows = QUANT_CHECK_ROWS
    taps = {}

    def tap(name, arr):
        if name in needed:
            t = arr._data
            taps[name] = (t[:rows] if t.ndim >= 2 else t).clone()
    ex.set_monitor_callback(tap)
    ex.forward(is_train=False, data=x)
    ex.set_monitor_callback(None)
    p8 = ex.outputs[0].asnumpy()
    mismatched, checked, big_k = [], 0, 0
    cpu = torch.device("cpu")
    for n in qnodes:
        ins = []
        for s, i in n.inputs:
            if s.op is None:
                t = ex.arg_dict[s.name]._data
                ins.append(t[:rows] if s.name == "data" else t)
            else:
                ins.append(taps[_entry_name(s, i)])
        parsed = n.op.parse_attrs(n.attrs)
        got = n.op.fcompute(parsed, OpCtx(device=cpu),
                            *[t.cpu() for t in ins])
        card = [taps[_entry_name(n, i)].cpu() for i in range(3)]
        same = all(g.dtype == c.dtype and torch.equal(g.reshape(c.shape), c)
                   for g, c in zip(got, card))
        checked += 1
        if n.op.name == "_contrib_quantized_conv":
            w = ins[1]
            big_k += int(w.shape[1] * w[0, 0].numel() > 1040)
        if not same:
            mismatched.append(n.name)
    out.update(nodes_checked=checked, rows_checked=rows,
               convs_with_k_over_1040=big_k, mismatched=mismatched[:8],
               n_mismatched=len(mismatched))
    out["top1_agreement"] = float((p8.argmax(1) == full_f32.argmax(1))
                                  .mean())
    out["max_prob_err"] = float(np.abs(p8 - full_f32).max())
    out["finite"] = bool(np.isfinite(p8).all())
    ex32 = sym.simple_bind(ctx=_ctx(), grad_req="null", data=x.shape)
    ex32.copy_params_from(nd_args, nd_auxs, allow_extra_params=True)
    out["int8_graph_ms"] = _ms_median(
        lambda: ex.forward(is_train=False, data=x))
    out["f32_graph_ms"] = _ms_median(
        lambda: ex32.forward(is_train=False, data=x))
    out["ok"] = bool(not mismatched and checked == len(qnodes)
                     and out["finite"])
    return out


def phase_predict():
    """The predict tier on ResNet-50 v1 at bench.py's inference lane
    (batch 32, 224 x 224): export_model on the card (f32 and bf16),
    Predictor and ServingEngine (one CUDA graph at the export batch) from
    the file, every bucket's rows against the predictor's, ms by bucket
    and img/s at 32 beside the executor plan's img/s (bench.py's
    _infer_ips); the bf16 batch against the executor's bf16 walk and the
    f32 batch (with a no-cast and a shifted-rows control); a batch-2
    request on the card and on the CPU against float64 (with a wrong-rows
    control); a DynamicBatcher closed loop; bench.py's int8_serving lane;
    quantize_model on ResNet-50 with the quantized nodes held bit for bit
    against the CPU, and the int8 route's control at K = 4608;
    examples/export_predict.py and quantize_resnet.py (naive and entropy)
    with only their imports changed."""
    import shutil
    import tempfile
    import numpy as np
    import mxnet_tpu_torch as mx
    _free_card()
    _reset_counts()
    t_phase = time.perf_counter()
    res = {"model": "resnet50_v1", "batch": PREDICT_BATCH,
           "image": PREDICT_IMG}
    with mx.NameManager():
        sym = resnet_v1_symbol(mx.sym)
    shape = (PREDICT_BATCH, 3, PREDICT_IMG, PREDICT_IMG)
    t0 = time.perf_counter()
    args, auxs = _r50_inference_params(mx, sym, shape)
    res["params_s"] = time.perf_counter() - t0
    x = np.random.RandomState(SEED + 2).uniform(0, 1, shape).astype(
        np.float32)
    work = os.path.join(HERE, "build")
    os.makedirs(work, exist_ok=True)
    td = tempfile.mkdtemp(dir=work)
    try:
        path32, pred32, eng32, full32, _ = _predict_artifact(
            mx, sym, args, auxs, x, "float32", td, res)
        path16, _, eng16, full16, walk16 = _predict_artifact(
            mx, sym, args, auxs, x, "bfloat16", td, res)
        res["bf16_vs_f32"] = _bf16_vs_f32(full16, full32, walk16)
        res["f32_rule"] = _predict_f32_rule(mx, sym, args, auxs, x, path32,
                                            eng32, pred32)
        res["batcher"] = _batcher_closed_loop(eng32, x, full32)
        eng16.close()
        del eng16
        _free_card()
        res["int8_serving"] = _int8_serving_lane(td)
        res["int8_conv_route"] = _quantized_conv_route(mx)
        _free_card()
        res["quantize_model"] = _quantize_resnet50(mx, sym, args, auxs, x,
                                                   full32)
        eng32.close()
        del eng32, pred32
        _free_card()
        exp_path, exp_src = _example_src(
            "export_predict.py",
            (("import mxnet_tpu as mx", "import mxnet_tpu_torch as mx"),
             ("from mxnet_tpu.", "from mxnet_tpu_torch.")))
        cwd = os.getcwd()
        os.chdir(td)
        # the example draws its initial weights and its shuffles from the
        # global generators: seeded from SEED as every phase's draws are
        # (its bar is narrow: the JAX package's own CPU runs read 0.898
        # and 0.902, the port's unseeded card runs 0.909-0.920)
        np.random.seed(SEED)
        mx.random.seed(SEED)
        try:
            with _digits_without_sklearn() as shim, _example_context():
                code, lines, secs = _run_example(exp_path, exp_src, [])
        finally:
            os.chdir(cwd)
        acc = float(lines[-1].split(":")[-1]) if lines else float("nan")
        res["export_predict"] = {"exit_code": code, "accuracy": acc,
                                 "bar": 0.9, "seconds": secs,
                                 "sklearn_from_tools_data": shim,
                                 "lines": lines[-3:],
                                 "ok": bool(code == 0 and acc > 0.9)}
        q_path, q_src = _example_src(
            "quantize_resnet.py",
            (("import mxnet_tpu as mx", "import mxnet_tpu_torch as mx"),
             ("from mxnet_tpu.contrib import",
              "from mxnet_tpu_torch.contrib import")))
        res["quantize_resnet"] = {}
        for calib in ("naive", "entropy"):
            with _example_context():
                code, lines, secs = _run_example(
                    q_path, q_src, ["--calib", calib, "--ctx",
                                    "tpu" if DEV == "cuda" else "cpu"])
            res["quantize_resnet"][calib] = {
                "exit_code": code, "lines": lines[-2:], "seconds": secs,
                "ok": code == 0}
        RECORD["predict_paths"] = {"f32": path32, "bf16": path16,
                                   "dir": td}
    except BaseException:
        shutil.rmtree(td, ignore_errors=True)
        raise
    res["launches"] = _read_counts()
    res["phase_s"] = time.perf_counter() - t_phase
    f32, bf16 = res["f32"], res["bf16"]
    res["ok"] = bool(
        f32["buckets_ok"] and bf16["buckets_ok"] and f32["finite"]
        and bf16["finite"] and res["bf16_vs_f32"]["ok"]
        and res["f32_rule"]["ok"]
        and res["f32_rule"]["control_fails"] and res["batcher"]["ok"]
        and res["int8_serving"]["ok"] and res["int8_conv_route"]["ok"]
        and res["quantize_model"]["ok"] and res["export_predict"]["ok"]
        and all(v["ok"] for v in res["quantize_resnet"].values()))
    RECORD["predict"] = res
    _free_card()
    if not res["ok"]:
        raise AssertionError("predict failed: %s"
                             % json.dumps(res, default=str)[:6000])
    return res


def phase_serving_net():
    """The network tier: the frontend's --bench as bench.py's serving_net
    lane runs it (2 hot 16-wide MLPs x 2 replicas, 64 urllib clients, 768
    requests: a toy's numbers, not a user's); examples/serve_two_models.py
    with only its import changed; then at full width a ServingFrontend
    holding the f32 and bf16 ResNet-50 artifacts of phase predict
    (exported here when it did not run), 2 replicas each: 64 urllib
    clients in a closed loop against each (QPS, p50/p99, shed: the
    serving_net metrics), then a budget that forces one LRU eviction when
    a third artifact loads (the resident bytes each model is charged
    against the card's memory); and a decode artifact at GPT-2 medium's
    widths driven by :generate through the same frontend (the decode
    kernel's path)."""
    import shutil
    import tempfile
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.serving import frontend
    from mxnet_tpu_torch.serving.router import manifest_need_bytes
    _free_card()
    _reset_counts()
    t_phase = time.perf_counter()
    res = {}
    t0 = time.perf_counter()
    res["bench"] = frontend.bench(requests=768, concurrency=64, replicas=2,
                                  device=_serve_device())
    res["bench"]["seconds"] = time.perf_counter() - t0
    res["bench"]["model"] = "two 16-wide MLPs, export batch 8 (toy)"
    path, src = _example_src(
        "serve_two_models.py",
        (("import mxnet_tpu as mx", "import mxnet_tpu_torch as mx"),
         ("from mxnet_tpu.", "from mxnet_tpu_torch.")))
    with _example_context():
        code, lines, secs = _run_example(path, src, [])
    res["serve_two_models"] = {"exit_code": code, "seconds": secs,
                               "lines": lines[:12], "ok": code == 0}
    res["selftest_cli"] = _serving_selftest_cli()
    paths = RECORD.get("predict_paths")
    own = None
    if paths is None:
        own = tempfile.mkdtemp(dir=os.path.join(HERE, "build"))
        with mx.NameManager():
            sym = resnet_v1_symbol(mx.sym)
        shape = (PREDICT_BATCH, 3, PREDICT_IMG, PREDICT_IMG)
        args, auxs = _r50_inference_params(mx, sym, shape)
        from mxnet_tpu_torch.contrib.export import export_model
        paths = {}
        for tag, dt in (("f32", "float32"), ("bf16", "bfloat16")):
            paths[tag] = os.path.join(own, "resnet50_%s.mxa" % tag)
            export_model(paths[tag], sym, args, auxs, {"data": shape},
                         dtype=dt, platforms=(DEV,),
                         model_name="resnet50_%s" % tag)
    try:
        res["full_width"] = _serving_full_width(paths, manifest_need_bytes)
        res["generate"] = _serving_generate()
    finally:
        if own is not None:
            shutil.rmtree(own, ignore_errors=True)
        if RECORD.get("predict_paths"):
            shutil.rmtree(RECORD["predict_paths"]["dir"], ignore_errors=True)
            RECORD["predict_paths"] = None
    res["launches"] = _read_counts()
    res["phase_s"] = time.perf_counter() - t_phase
    b = res["bench"]
    res["ok"] = bool(b["completed"] > 0 and b["qps"] > 0
                     and res["serve_two_models"]["ok"]
                     and res["selftest_cli"]["ok"]
                     and res["full_width"]["ok"] and res["generate"]["ok"])
    RECORD["serving_net"] = res
    _free_card()
    if not res["ok"]:
        raise AssertionError("serving_net failed: %s"
                             % json.dumps(res, default=str)[:6000])
    return res


def _serving_selftest_cli():
    """``python -m mxnet_tpu_torch.serving --selftest`` on the card with
    its own defaults (256 requests, 8 clients, --min-speedup 2.0): the
    batcher's closed loop must beat one Predictor call a request by 2x
    (its exit code), and /metrics must carry the serving series."""
    import mxnet_tpu_torch
    root = os.path.dirname(os.path.dirname(
        os.path.abspath(mxnet_tpu_torch.__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "mxnet_tpu_torch.serving",
                        "--selftest"], env=env, capture_output=True,
                       text=True, timeout=300)
    out = {"exit_code": r.returncode, "seconds": time.perf_counter() - t0}
    try:
        line = json.loads(r.stdout.strip().splitlines()[-1])
    except (IndexError, ValueError):
        out.update(ok=False, stderr=r.stderr[-2000:])
        return out
    out.update({k: line.get(k) for k in (
        "device", "requests", "concurrency", "batched_qps",
        "sequential_qps", "speedup", "avg_batch_rows", "batch_hist",
        "shed", "timeouts", "telemetry_scrape_ok")})
    out["ok"] = bool(r.returncode == 0 and line.get("ok")
                     and str(line.get("device", "")).startswith("cuda"))
    return out


def _serving_full_width(paths, need_of):
    """Two ResNet-50 artifacts hot behind a ServingFrontend, SERVE_REPLICAS
    each: one request each held against the predictor, then the HTTP
    closed loop against each (``_http_closed_loop``); a third load under
    a budget of their measured resident bytes plus the third's estimate,
    less one byte, must evict the LRU one."""
    import numpy as np
    from mxnet_tpu_torch.predictor import Predictor
    from mxnet_tpu_torch.serving.frontend import ServingFrontend, _http
    out = {"replicas": SERVE_REPLICAS}
    x = np.random.RandomState(SEED + 5).uniform(
        0, 1, (1, 3, PREDICT_IMG, PREDICT_IMG)).astype(np.float32)
    want = Predictor(paths["f32"], device=_serve_device()).forward(x)[0]
    # probe: each model's measured resident bytes, unbudgeted
    with ServingFrontend(replicas=SERVE_REPLICAS,
                         device=_serve_device()) as probe:
        charged = {}
        for tag in ("f32", "bf16"):
            code, st = _http("POST", "%s/v1/models/resnet50_%s:load"
                                  % (probe.url, tag), {"path": paths[tag]})
            if code != 200:
                raise AssertionError("load %s: %s %s" % (tag, code, st))
            charged[tag] = int(st["resident_bytes"])
        out["probe_card_allocated"] = _card_bytes()[0]
    need3 = int(need_of(paths["f32"])) * SERVE_REPLICAS
    budget = charged["f32"] + charged["bf16"] + need3 - 1
    total = _card_bytes()[2]
    out.update(charged_bytes=charged, need_third=need3, budget=budget,
               manifest_need={k: int(need_of(paths[k]))
                              for k in ("f32", "bf16")})
    with ServingFrontend(replicas=SERVE_REPLICAS, budget=budget,
                         device=_serve_device()) as fe:
        u = fe.url
        for tag in ("f32", "bf16"):
            code, st = _http("POST", "%s/v1/models/resnet50_%s:load"
                                  % (u, tag), {"path": paths[tag]})
            if code != 200:
                raise AssertionError("load %s: %s %s" % (tag, code, st))
        t0 = time.perf_counter()
        code, body = _http("POST", "%s/v1/models/resnet50_f32:predict"
                                % u, {"inputs": [x.tolist()]})
        out["predict_http_s"] = time.perf_counter() - t0
        got = np.asarray(body["outputs"][0], np.float32) if code == 200 \
            else None
        out["predict_status"] = code
        out["predict_rel_err"] = None if got is None else _rel_err(got, want)
        code16, _ = _http("POST", "%s/v1/models/resnet50_bf16:predict"
                               % u, {"inputs": [x.tolist()]})
        out["closed_loop"] = {tag: _http_closed_loop(
            u, "resnet50_%s" % tag, x) for tag in ("f32", "bf16")}
        table = _http("GET", "%s/v1/models" % u)[1]
        out["resident_before"] = table["resident_bytes"]
        (out["card_allocated"], out["card_reserved"],
         out["card_total"]) = _card_bytes()
        code3, st3 = _http("POST", "%s/v1/models/resnet50_c:load" % u,
                                {"path": paths["f32"]})
        table = _http("GET", "%s/v1/models" % u)[1]
        held = sorted(table["models"])
        out.update(third_status=code3, held_after=held,
                   resident_after=table["resident_bytes"],
                   charged_after={k: v.get("resident_bytes")
                                  for k, v in table["models"].items()})
    # bf16 was used last, so f32 is the LRU model and goes
    out["ok"] = bool(code == 200 and code16 == 200 and code3 == 200
                     and all(v["ok"] for v in out["closed_loop"].values())
                     and out["predict_rel_err"] is not None
                     and out["predict_rel_err"] <= BUCKET_RTOL
                     and held == ["resnet50_bf16", "resnet50_c"])
    return out


def _http_closed_loop(url, model, x):
    """NET_CLIENTS urllib clients send NET_REQUESTS 1-image requests each
    to ``model`` back to back (the frontend's closed loop: interactive,
    deadline NET_DEADLINE_MS, each client's JSON body encoded once):
    QPS, p50/p99 of the answered requests, and the shed (429), timed-out
    (504) and failed counts."""
    from mxnet_tpu_torch.serving.frontend import _closed_loop, _pctl
    row = [x.tolist()]
    jobs = [(model, "interactive", NET_DEADLINE_MS, NET_REQUESTS, row)
            for _ in range(NET_CLIENTS)]
    counts, lats, dt = _closed_loop(url, jobs)
    total = sum(counts.values())
    ok = counts.get(("interactive", 200), 0)
    inter = lats.get("interactive", [])
    return {"clients": NET_CLIENTS, "requests": total, "completed": ok,
            "seconds": dt, "qps": ok / dt, "p50_ms": _pctl(inter, 50),
            "p99_ms": _pctl(inter, 99),
            "shed": counts.get(("interactive", 429), 0),
            "timeouts": counts.get(("interactive", 504), 0),
            "failed": total - ok - counts.get(("interactive", 429), 0)
            - counts.get(("interactive", 504), 0),
            "request_bytes": len(json.dumps({"inputs": row})),
            "ok": bool(total == NET_CLIENTS * NET_REQUESTS and ok > 0
                       and ok + counts.get(("interactive", 429), 0)
                       == total)}


def _serving_generate():
    """A decode artifact at the export phase's cut of GPT-2 medium (CFG's
    widths, EXPORT_LAYERS layers, params from SEED) loaded into a
    ServingFrontend and driven by POST :generate: the decode kernel's
    path through the network tier, held against DecodeEngine.generate.
    The tokens must not be one token repeated, and the control (the
    position table shifted by one row, every position read one place
    off) must change them."""
    import tempfile
    import numpy as np
    from mxnet_tpu_torch.contrib.export import export_decode_model
    from mxnet_tpu_torch.serving.decode import DecodeEngine, DecodeModel
    from mxnet_tpu_torch.serving.frontend import ServingFrontend, _http
    cfg = dict(CFG, layers=EXPORT_LAYERS)
    model = DecodeModel(**cfg)
    params = model.init_params(seed=SEED)
    prompt = list(range(3, 20))
    shifted = dict(params, pos=np.roll(params["pos"], 1, axis=0))
    with DecodeEngine(DecodeModel(**cfg), shifted, num_slots=2,
                      device=_serve_device()) as eng:
        control = eng.generate(prompt, max_new_tokens=GEN_NEW_TOKENS)
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build")) as td:
        path = os.path.join(td, "dec.mxa")
        t0 = time.perf_counter()
        export_decode_model(path, model.config(), params, model_name="dec")
        export_s = time.perf_counter() - t0
        del params, shifted
        with DecodeEngine(path, num_slots=2, device=_serve_device()) as eng:
            want = eng.generate(prompt, max_new_tokens=GEN_NEW_TOKENS)
        with ServingFrontend(replicas=1, device=_serve_device()) as fe:
            code, st = _http("POST", "%s/v1/models/dec:load" % fe.url,
                             {"path": path}, timeout=300)
            t0 = time.perf_counter()
            code2, body = _http(
                "POST", "%s/v1/models/dec:generate" % fe.url,
                {"tokens": prompt, "max_new_tokens": GEN_NEW_TOKENS})
            gen_s = time.perf_counter() - t0
    tokens = body.get("tokens")
    return {"widths": cfg, "export_s": export_s, "load_status": code,
            "status": code2, "generate_http_s": gen_s, "tokens": tokens,
            "engine_tokens": want, "distinct": len(set(tokens or ())),
            "control_shifted_positions": control,
            "control_differs": control != want,
            "ok": bool(code == 200 and code2 == 200 and tokens == want
                       and len(set(want)) > 1 and control != want)}


# -- ssd300 -------------------------------------------------------------------

_SSD_TARGET = dict(overlap_threshold=.5, ignore_label=-1,
                   negative_mining_ratio=3, minimum_negative_samples=0,
                   negative_mining_thresh=.5, variances=(.1, .1, .2, .2))
_SSD_DETECT = dict(nms_threshold=.45, force_suppress=False,
                   variances=(.1, .1, .2, .2), nms_topk=SSD_NMS_TOPK)
_SSD_OPS = ("_contrib_MultiBoxPrior", "_contrib_MultiBoxTarget",
            "_contrib_MultiBoxDetection")
# a step's device kernels by kind (matched lower-case, first group wins):
# cuDNN's convolutions, the float64 forward route (im2col and DGEMM), the
# other GEMMs, host-device copies, the rest
_SSD_GROUPS = (("cudnn_conv", ("cudnn", "fprop", "dgrad", "wgrad",
                               "implicit_gemm", "fft", "convolve")),
               ("f64_route", ("im2col_kernel<double>", "f64f64",
                              "dgemm")),
               ("gemm_f32", ("gemm", "cutlass")),
               ("copies", ("memcpy", "memset")),
               ("elementwise", ("elementwise", "reduce", "pool",
                                "softmax", "index", "sort", "scatter",
                                "gather", "cat", "fill")))


def _ssd_params(shapes):
    """He-normal weights (fan in), zero biases, the L2Normalization scale
    20 (its __init__), drawn on the host from SEED (numpy, by name)."""
    import numpy as np
    rng = np.random.RandomState(SEED)
    out = {}
    for name, shape in shapes.items():
        if name in ("data", "label"):
            continue
        if name == "relu4_3_scale":
            out[name] = np.full(shape, 20.0, np.float32)
        elif name.endswith("_weight"):
            out[name] = (rng.standard_normal(shape) * np.sqrt(
                2.0 / int(np.prod(shape[1:])))).astype(np.float32)
        else:
            out[name] = np.zeros(shape, np.float32)
    return out


def _ssd_losses(outs):
    """example/ssd's MultiBoxMetric from a step's outputs: the softmax
    cross-entropy over the anchors the targets keep (class >= 0) and the
    smooth-L1 box loss over the positive anchors."""
    import numpy as np
    prob, loc, label = (o.asnumpy() for o in outs[:3])
    keep = label >= 0
    lab = np.where(keep, label, 0).astype(np.int64)
    p = np.take_along_axis(prob, lab[:, None, :], axis=1)[:, 0]
    ce = float(-np.log(np.maximum(p[keep], 1e-30)).mean())
    return {"softmax_ce": ce, "loc_loss": float(loc.sum() / max(
        1, int((label > 0).sum()))), "positives": int((label > 0).sum()),
        "negatives": int((label == 0).sum())}


def _ssd_step_check(mx, sym, params):
    """A batch-SSD_CHECK_BATCH training step (forward and backward) on the
    card and on the CPU, in float32 and float64 from the same parameters:
    float64 card against CPU, float32 by module_resnet50's rule
    (_f32_rule) over the class probabilities, the box loss and every
    gradient, and the class targets equal."""
    import numpy as np
    xb, yb = synthetic_detection(SSD_CHECK_BATCH, SSD_IMG, SSD_MAX_BOXES,
                                 SSD_CLASSES, seed=SEED + 1)
    host = {n: mx.nd.array(v, ctx=mx.cpu()) for n, v in params.items()}
    t, labels = {}, {}
    for key, ctx, dt in (("cpu64", mx.cpu(), "float64"),
                         ("cpu32", mx.cpu(), "float32"),
                         ("card64", _ctx(), "float64"),
                         ("card32", _ctx(), "float32")):
        ex = sym.simple_bind(ctx=ctx, data=xb.shape, label=yb.shape,
                             type_dict={n: dt for n in
                                        sym.list_arguments()})
        ex.copy_params_from(host, {})
        ex.forward(is_train=True, data=mx.nd.array(xb, ctx=mx.cpu()),
                   label=mx.nd.array(yb, ctx=mx.cpu()))
        ex.backward()
        out = {"output": ex.outputs[0], "loc_loss": ex.outputs[1]}
        out.update({"grad:" + n: ex.grad_dict[n] for n in params})
        t[key] = {k: v.asnumpy().astype(np.float64) for k, v in out.items()}
        labels[key] = ex.outputs[2].asnumpy()
        del ex
        _free_card()
    ref = t["cpu64"]
    e64 = {k: _rel_err(t["card64"][k], v) for k, v in ref.items()}
    f32 = _f32_rule(t["card32"], t["cpu32"], ref)
    # the card's class targets are the host's in each precision; float32
    # against float64 may differ (reported): a box inside two anchors of
    # one area ties their IoUs exactly, and rounding breaks the tie
    same = {"card32_cpu32": bool(np.array_equal(labels["card32"],
                                                labels["cpu32"])),
            "card64_cpu64": bool(np.array_equal(labels["card64"],
                                                labels["cpu64"]))}
    return {"batch": SSD_CHECK_BATCH, "tensors": len(ref),
            "f64_card_vs_cpu_max": max(e64.values()),
            "f64_worst": sorted(e64.items(), key=lambda kv: -kv[1])[:4],
            "f32": f32, "class_targets_equal": same,
            "f32_f64_class_targets_differing": int(
                (labels["cpu32"] != labels["cpu64"]).sum()),
            "positives": int((labels["cpu64"] > 0).sum()),
            "ok": bool(max(e64.values()) <= R50_F64_RTOL and f32["ok"]
                       and all(same.values()))}


def _ssd_op(name, attrs, *xs):
    from mxnet_tpu_torch.ops import registry
    schema = registry.get_op(name)
    return schema.fcompute(schema.parse_attrs(attrs), registry.OpCtx(
        device=xs[0].device), *xs)


def _ssd_ops_check(mx, sym, arg_params, x, y):
    """MultiBoxTarget and MultiBoxDetection on one full batch (the
    trained network's class and box predictions and anchors, computed on
    the card), run on the card and on the CPU: masks, classes and kept
    rows equal, loc targets and boxes within SSD_OPS_RTOL of their
    largest magnitude. Two wrong assignments must fail the same check:
    the anchors shifted by one row, and the bipartite pass skipped.
    Then each op's device and wall ms at the batch."""
    import numpy as np
    import torch
    from mxnet_tpu_torch.ops import contrib
    internals = sym.get_internals()
    heads = mx.sym.Group([internals["multibox_cls_pred_output"],
                          internals["multibox_loc_pred_output"],
                          internals["multibox_anchors_output"]])
    ex = heads.simple_bind(ctx=_ctx(), data=x.shape, grad_req="null")
    ex.copy_params_from(arg_params, {}, allow_extra_params=True)
    ex.forward(is_train=False, data=mx.nd.array(x, ctx=mx.cpu()))
    cls_pred, loc_pred, anchors = (o._data.detach() for o in ex.outputs)
    del ex
    label = torch.tensor(y, device=cls_pred.device)
    card = _ssd_op("_contrib_MultiBoxTarget", _SSD_TARGET, anchors, label,
                   cls_pred)
    cpu = _ssd_op("_contrib_MultiBoxTarget", _SSD_TARGET, anchors.cpu(),
                  label.cpu(), cls_pred.cpu())

    def compare_target(got):
        loc, mask, cls = (g.cpu() for g in got)
        return {"mask_equal": bool(torch.equal(mask, cpu[1])),
                "class_equal": bool(torch.equal(cls, cpu[2])),
                "classes_differing": int((cls != cpu[2]).sum()),
                "loc_err": _rel_err(loc.numpy(), cpu[0].numpy())}

    tgt = compare_target(card)
    tgt["ok"] = bool(tgt["mask_equal"] and tgt["class_equal"]
                     and tgt["loc_err"] <= SSD_OPS_RTOL)
    tgt.update(positives=int((cpu[2] > 0).sum()),
               negatives=int((cpu[2] == 0).sum()))
    shifted = compare_target(_ssd_op(
        "_contrib_MultiBoxTarget", _SSD_TARGET,
        torch.roll(anchors, 1, dims=1), label, cls_pred))
    real_assign = contrib._bipartite_assign

    def no_bipartite(ious, thresh_ok=1e-6):
        a, m_gt, m_iou = real_assign(ious, thresh_ok=float("inf"))
        return a, m_gt, m_iou
    contrib._bipartite_assign = no_bipartite
    try:
        skipped = compare_target(_ssd_op("_contrib_MultiBoxTarget",
                                         _SSD_TARGET, anchors, label,
                                         cls_pred))
    finally:
        contrib._bipartite_assign = real_assign
    for c in (shifted, skipped):
        c["fails"] = not (c["mask_equal"] and c["class_equal"]
                          and c["loc_err"] <= SSD_OPS_RTOL)
    tgt["control_anchors_shifted"] = shifted
    tgt["control_bipartite_skipped"] = skipped
    # detection on the SoftmaxOutput probabilities
    prob = torch.softmax(cls_pred, dim=1)
    d_card = _ssd_op("_contrib_MultiBoxDetection", _SSD_DETECT, prob,
                     loc_pred, anchors)[0].cpu()
    d_cpu = _ssd_op("_contrib_MultiBoxDetection", _SSD_DETECT, prob.cpu(),
                    loc_pred.cpu(), anchors.cpu())[0]
    kept = d_cpu[..., 0] >= 0
    det = {"kept_rows_equal": bool(torch.equal(d_card[..., 0],
                                               d_cpu[..., 0])),
           "box_err": _rel_err(d_card[..., 1:].numpy(),
                               d_cpu[..., 1:].numpy()),
           "kept_per_image": [int(k) for k in kept.sum(1)],
           "valid_per_image_max": int((d_cpu[..., 1] >= 0).sum(1).max())}
    det["ok"] = bool(det["kept_rows_equal"]
                     and det["box_err"] <= SSD_OPS_RTOL)
    times = {}
    for name, fn in (("multibox_target", lambda: _ssd_op(
            "_contrib_MultiBoxTarget", _SSD_TARGET, anchors, label,
            cls_pred)), ("multibox_detection", lambda: _ssd_op(
                "_contrib_MultiBoxDetection", _SSD_DETECT, prob, loc_pred,
                anchors))):
        dev_ms, wall, _, kernels = _profiled_ms(fn, SSD_TIME_ITERS)
        times[name] = {"device_ms": dev_ms, "wall_ms": wall,
                       "kernels": kernels}
    return {"target": tgt, "detection": det, "times_batch": times,
            "batch": int(x.shape[0]), "anchors": int(anchors.shape[1]),
            "ok": bool(tgt["ok"] and det["ok"] and shifted["fails"]
                       and skipped["fails"])}


@contextlib.contextmanager
def _annotated(prefix, ops, host_ms=None):
    """The ops' fcompute under torch.profiler ranges named
    ``<prefix><op>``, so one profiled step reads the device time under
    each; with ``host_ms``, the Custom op's host wall ms a call (the copy
    to the host, the user's forward, the copy back) appended to it."""
    from torch.profiler import record_function
    from mxnet_tpu_torch.ops import registry
    saved = {}
    for name in ops:
        schema = registry.get_op(name)
        saved[name] = schema.fcompute

        def wrapped(attrs, octx, *xs, _f=schema.fcompute, _n=name):
            t0 = time.perf_counter()
            with record_function(prefix + _n):
                out = _f(attrs, octx, *xs)
            if host_ms is not None and _n == "Custom":
                host_ms.append((time.perf_counter() - t0) * 1e3)
            return out
        schema.fcompute = wrapped
    try:
        yield
    finally:
        for name, fn in saved.items():
            registry.get_op(name).fcompute = fn


def phase_ssd300():
    """SSD300-VGG16 (ssd300_vgg16_symbol) trained through Module on the
    card at example/ssd's published widths: a batch-2 step against the
    CPU first; SSD_STEPS steps of batch 32, img/s over the last 10, the
    MultiBoxMetric losses first against last, peak memory; one step
    under torch.profiler (the top kernels, the device time under each
    detection op); MultiBoxTarget and MultiBoxDetection on the trained
    network's batch, card against CPU, beside two wrong assignments that
    must fail; examples/ssd_train.py with only its import changed."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    import mxnet_tpu_torch as mx
    _free_card()
    t_phase = time.perf_counter()
    res = {"batch": SSD_BATCH, "image": SSD_IMG, "classes": SSD_CLASSES,
           "width_div": SSD_WIDTH_DIV, "optimizer": dict(SSD_OPT, name="sgd")}
    with mx.NameManager():
        sym = ssd300_vgg16_symbol(mx.sym, num_classes=SSD_CLASSES,
                                  width_div=SSD_WIDTH_DIV,
                                  nms_topk=SSD_NMS_TOPK)
    dshape = (SSD_BATCH, 3, SSD_IMG, SSD_IMG)
    lshape = (SSD_BATCH, SSD_MAX_BOXES, 5)
    arg_shapes, out_shapes, _ = sym.infer_shape(data=dshape, label=lshape)
    shapes = dict(zip(sym.list_arguments(), arg_shapes))
    params = _ssd_params(shapes)
    res["anchors"] = int(out_shapes[0][2])
    res["params"] = int(sum(v.size for v in params.values()))
    # 1. a batch-2 step, card against CPU
    t0 = time.perf_counter()
    res["check"] = _ssd_step_check(mx, sym, params)
    res["check"]["seconds"] = time.perf_counter() - t0
    # 2. training through Module
    x, y = synthetic_detection(SSD_BATCH * SSD_DISTINCT, SSD_IMG,
                               SSD_MAX_BOXES, SSD_CLASSES, seed=SEED)
    batches = [mx.io.DataBatch(
        data=[mx.nd.array(x[i * SSD_BATCH:(i + 1) * SSD_BATCH],
                          ctx=mx.cpu())],
        label=[mx.nd.array(y[i * SSD_BATCH:(i + 1) * SSD_BATCH],
                           ctx=mx.cpu())]) for i in range(SSD_DISTINCT)]
    mod = mx.mod.Module(sym, data_names=("data",), label_names=("label",),
                        context=_ctx())
    mod.bind(data_shapes=[("data", dshape)], label_shapes=[("label", lshape)])
    mod.init_params(arg_params={k: mx.nd.array(v, ctx=mx.cpu())
                                for k, v in params.items()})
    mod.init_optimizer(optimizer="sgd", optimizer_params=dict(SSD_OPT))
    _reset_counts()
    step_s, losses = [], []
    for step in range(SSD_STEPS):
        if step == SSD_TIMED_FROM and DEV == "cuda":
            torch.cuda.reset_peak_memory_stats()
        b = batches[step % SSD_DISTINCT]
        _sync()
        t0 = time.perf_counter()
        mod.forward(b, is_train=True)
        mod.backward()
        mod.update()
        _sync()
        step_s.append(time.perf_counter() - t0)
        losses.append(_ssd_losses(mod.get_outputs()))
    peak = torch.cuda.max_memory_allocated() if DEV == "cuda" else 0
    counts = _read_counts()
    timed = step_s[SSD_TIMED_FROM:]
    first, last = losses[0], losses[-1]
    flops = step_flops("ssd300", sym, {"data": dshape, "label": lshape},
                       3 * 2 * 34.5e9 * SSD_BATCH / SSD_WIDTH_DIV ** 2)
    res.update({
        "step_ms_each": [s * 1e3 for s in step_s],
        "step_ms": float(np.mean(timed)) * 1e3,
        "img_per_s": SSD_BATCH * len(timed) / sum(timed),
        "losses": losses, "loss_first": first, "loss_last": last,
        "peak_mem_gb": peak / 1e9, "launches": counts,
        "flop_per_step": flops,
        "fp32_bound_ms": flops / PEAK_F32_FLOPS * 1e3})
    # 3. one step under the profiler
    b = batches[0]
    with _annotated("ssd:", _SSD_OPS):
        _sync()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            mod.forward(b, is_train=True)
            mod.backward()
            mod.update()
            _sync()
            prof_wall = (time.perf_counter() - t0) * 1e3
    rows = _device_rows(prof, 1)
    # the ssd: ranges' device spans (the kernels their fcompute launched,
    # and the card's idle gaps between them), apart from the kernels
    ranges = {}
    for ev in prof.key_averages():
        if ev.key.startswith("ssd:"):
            t = getattr(ev, "device_time_total", None)
            if t is None:
                t = getattr(ev, "cuda_time_total", 0.0)
            ranges[ev.key[4:]] = {"device_ms": t / 1e3,
                                  "cpu_ms": ev.cpu_time_total / 1e3,
                                  "calls": ev.count}
    kernels = [r for r in rows if not r[0].startswith("ssd:")]
    split = {}
    for k, t, _ in kernels:
        name = k.lower()
        group = next((g for g, keys in _SSD_GROUPS
                      if any(key in name for key in keys)), "other")
        split[group] = split.get(group, 0.0) + t
    dev_ms = sum(r[1] for r in kernels)
    res["profile"] = {
        "device_ms": dev_ms, "wall_ms_profiled": prof_wall,
        "busy_share": dev_ms / max(1e-9, prof_wall),
        "kernels": int(sum(r[2] for r in kernels)),
        "split_ms": split,
        "top": [{"kernel": k[:100], "ms": t, "calls": c}
                for k, t, c in kernels[:12]],
        "detection_ops": ranges}
    # 4. the detection ops on the trained network's batch, card vs CPU
    trained = mod.get_params()[0]
    del mod, batches
    _free_card()
    res["ops"] = _ssd_ops_check(mx, sym, trained, x[:SSD_BATCH],
                                y[:SSD_BATCH])
    # 5. the example, with only its import changed
    path, src = _example_src("ssd_train.py", (
        ("import mxnet_tpu as mx", "import mxnet_tpu_torch as mx"),))
    with _example_context():
        code, lines, secs = _run_example(
            path, src, ["--ctx", "tpu" if DEV == "cuda" else "cpu"])
    res["example"] = {"exit_code": code, "seconds": secs,
                      "lines": lines[-3:], "ok": code == 0}
    res["phase_s"] = time.perf_counter() - t_phase
    res["ok"] = bool(res["check"]["ok"] and res["ops"]["ok"]
                     and res["example"]["ok"]
                     and res["anchors"] == 8732
                     and all(np.isfinite([v for l in losses for v in
                                          (l["softmax_ce"], l["loc_loss"])]))
                     and last["softmax_ce"] < first["softmax_ce"]
                     and last["loc_loss"] < first["loc_loss"]
                     and not any(counts[k] for k in _wrappers()))
    RECORD["ssd300"] = res
    _free_card()
    if not res["ok"]:
        raise AssertionError("ssd300 failed: %s"
                             % json.dumps(res, default=str)[:6000])
    return res


# -- the DLRM phase: the row-sparse embedding trainer -----------------------
# facebookresearch/dlrm's bench/dlrm_s_criteo_kaggle.sh: Criteo Kaggle's 26
# categorical tables (their rows, 33,762,577 in all) as the trainer's one
# table, slot j's ids offset by the rows of tables 0..j-1;
# --arch-sparse-feature-size=16, --arch-mlp-top=512-256-1, 13 dense
# features, --learning-rate=0.1 at --mini-batch-size=128 (a mean loss:
# rescale_grad 1/batch on the trainer's summed BCE). The trainer has no
# bottom MLP and no dot interaction: it concatenates the 26 rows and the
# dense features into its MLP, as the JAX package's does.
DLRM_TABLE_ROWS = (1460, 583, 10131227, 2202608, 305, 24, 12517, 633, 3,
                   93145, 5683, 8351593, 3194, 27, 14992, 5461306, 10, 5652,
                   2173, 4, 7046547, 18, 15, 286181, 105, 142572)
DLRM_DIM = 16
DLRM_DENSE = 13
DLRM_MLP = (512, 256)
DLRM_SGD_LR = 0.1
DLRM_ADAM_LR = 1e-2           # examples/dlrm_train.py's
DLRM_BATCHES = (128, 2048)    # the script's, and a larger one
DLRM_DISTINCT = 4             # synthetic batches cycled
DLRM_WARMUP = 2
DLRM_WINDOW = 20
DLRM_WINDOWS = 3
DLRM_WIRE_WINDOW = 5          # the bf16 / fp8 arms: a few steps a window
DLRM_PROFILE_STEPS = 5
DLRM_CHECK_ROWS = 1 << 20     # the card-vs-CPU table
DLRM_CHECK_STEPS = 3
DLRM_RTOL = 1e-5
DLRM_NDARRAY = dict(rows=4096, cols=100_000, nnz_row=26, out=16,
                    vocab=100_000, grad_rows=2048)
# examples/dlrm_train.py's constants (its mesh: one card)
DLRM_EXAMPLE = dict(vocab=50_000, dim=32, slots=4, dense=8, batch=64,
                    steps=120, mlp=(64, 32), lr=1e-2)


def _dlrm_mesh(cpu=False):
    from mxnet_tpu_torch.context import cpu as cpu_ctx
    from mxnet_tpu_torch.parallel.mesh import (data_parallel_mesh,
                                               mesh_for_contexts)
    if cpu or DEV != "cuda":
        return mesh_for_contexts([cpu_ctx(0)])
    return data_parallel_mesh(1)


def _dlrm_split(total, parts):
    """``parts`` table sizes summing to ``total`` (the last takes the
    remainder)."""
    rows = [total // parts] * parts
    rows[-1] += total - sum(rows)
    return tuple(rows)


def dlrm_batch(rng, batch, rows=None, dense=None):
    """Synthetic Criteo-shaped clicks: slot j's id zipf(1.3) within table
    j's rows (examples/dlrm_train.py's draw), offset by the rows of the
    tables before it; the label the parity of slots 0 and 1's ids XOR
    dense[:, 0] > 0 (the example's learnable label)."""
    import numpy as np
    rows = np.asarray(DLRM_TABLE_ROWS if rows is None else rows, np.int64)
    dense = DLRM_DENSE if dense is None else dense
    local = np.minimum(rng.zipf(1.3, size=(batch, len(rows))) - 1, rows - 1)
    offsets = np.concatenate([[0], np.cumsum(rows)[:-1]])
    x = rng.normal(size=(batch, dense)).astype(np.float32)
    y = (((local[:, 0] + local[:, 1]) % 2) ^ (x[:, 0] > 0)).astype(np.float32)
    return (local + offsets).astype(np.int32), x, y


def _dlrm_trainer(mesh, vocab, batch, optimizer="sgd", exchange="sparse",
                  compress="none", slots=None, dim=None, dense=None,
                  mlp=None, lr=None):
    from mxnet_tpu_torch.parallel.embedding import EmbeddingTrainer
    dim = DLRM_DIM if dim is None else dim
    dense = DLRM_DENSE if dense is None else dense
    mlp = DLRM_MLP if mlp is None else mlp
    if lr is None:
        lr = DLRM_SGD_LR if optimizer == "sgd" else DLRM_ADAM_LR
    return EmbeddingTrainer(
        mesh, vocab=vocab, embed_dim=dim,
        n_slots=len(DLRM_TABLE_ROWS) if slots is None else slots,
        dense_dim=dense, mlp_hidden=mlp, optimizer=optimizer,
        learning_rate=lr, rescale_grad=1.0 / batch, exchange=exchange,
        compress=compress, batch_size=batch)


def _dlrm_profile(tr, state, inputs, n):
    """Device ms, kernels and the largest device operations of ``n``
    steps under torch.profiler; busy = kernel time over the wall."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            state, loss, _ = tr.step(state, inputs[i % len(inputs)])
        _sync()
        wall = (time.perf_counter() - t0) * 1e3 / n
    # the step's own range (record_function) is not a kernel
    rows = [r for r in _device_rows(prof, n, required=DEV == "cuda")
            if r[0] != tr.program_tag]
    dev_ms = sum(r[1] for r in rows)
    return state, {"device_ms": dev_ms, "wall_ms_profiled": wall,
                   "busy_share": dev_ms / max(1e-9, wall),
                   "kernels": sum(r[2] for r in rows),
                   "top": [{"kernel": k[:100], "ms": t, "calls": c}
                           for k, t, c in rows[:10]]}


def _dlrm_arm(tr, state, batches, window, profile=True):
    """Warm-up steps, one step under sync-debug "error" (a host sync
    raises), then DLRM_WINDOWS timed windows (each ends on a read of its
    last loss), steps/s the median; peak memory over the windows; the
    touched rows of each window's last step; a profiled run."""
    import numpy as np
    import torch
    inputs = [tr.shard_inputs(list(b)) for b in batches]
    for i in range(DLRM_WARMUP):
        state, loss, nnz = tr.step(state, inputs[i % len(inputs)])
    _sync()
    res = {"exchange": tr.exchange, "compress": tr.compress,
           "optimizer": tr.optimizer, "batch": tr._batch}
    if DEV == "cuda":
        torch.cuda.set_sync_debug_mode("error")
        try:
            state, loss, nnz = tr.step(state, inputs[0])
            res["sync_free"] = True
        except RuntimeError as e:
            res["sync_free"] = False
            res["sync_error"] = repr(e)[:300]
        finally:
            torch.cuda.set_sync_debug_mode("default")
        _sync()
        torch.cuda.reset_peak_memory_stats()
    rates, losses, touched = [], [], []
    k = 0
    for _ in range(DLRM_WINDOWS):
        t0 = time.perf_counter()
        for _ in range(window):
            state, loss, nnz = tr.step(state, inputs[k % len(inputs)])
            k += 1
        losses.append(float(loss) / tr._batch)
        rates.append(window / (time.perf_counter() - t0))
        res.setdefault("nnz", []).append(int(nnz))
    touched = [len(np.unique(b[0])) for b in batches]
    sps = float(np.median(rates))
    from mxnet_tpu_torch.parallel.embedding import EmbeddingLayout
    L = tr.layout
    res.update({
        "steps_per_s": sps, "samples_per_s": sps * tr._batch,
        "rates": rates, "loss_per_sample": losses,
        "touched_rows": touched,
        "touched_share": [t / tr.vocab for t in touched],
        "wire_bytes_analytic": L.wire_bytes_per_step(
            tr.exchange, tr._wire_itemsize, tr._mlp_bytes()),
        # the same step's wire over 8 cards (one card sends nothing)
        "wire_bytes_analytic_8": EmbeddingLayout(
            L.vocab, L.dim, 8, L.unique // 8 or 1, L.n_states)
        .wire_bytes_per_step(tr.exchange, tr._wire_itemsize,
                             tr._mlp_bytes()),
        "peak_bytes": torch.cuda.max_memory_allocated()
        if DEV == "cuda" else 0})
    if profile:
        state, res["profile"] = _dlrm_profile(tr, state, inputs,
                                              DLRM_PROFILE_STEPS)
    return state, res


def _dlrm_carry(src, state, dst, moments=False):
    """Export ``src``'s state to the host and import it into ``dst``
    (Adam's moments zero when ``moments`` and the source has none)."""
    import numpy as np
    arrays, meta = src.export_training_state(state)
    del state
    _free_card()
    if moments:
        for n in ["embed"] + dst.mlp_names:
            for j in range(2):
                arrays.setdefault(f"opt:{n}:{j}",
                                  np.zeros_like(arrays[f"param:{n}"]))
        meta = dict(meta, t=0.0)
    return dst.import_training_state(arrays, meta)


def _dlrm_untouched(before, after, touched_rows, n_states):
    """Rows a step did not touch keep their weight and moments bit for
    bit: the count of such rows that changed."""
    import numpy as np
    mask = np.ones(before["param:embed"].shape[0], bool)
    mask[touched_rows] = False
    bad = 0
    for name in ["param:embed"] + ["opt:embed:%d" % j
                                   for j in range(n_states)]:
        diff = (before[name] != after[name]).any(axis=1)
        bad += int((diff & mask).sum())
    return bad


def _dlrm_run_check(mesh, batches, optimizer, patch=None):
    """DLRM_CHECK_STEPS steps at the full-width batch and MLP over a
    DLRM_CHECK_ROWS table (SGD with momentum 0.9, or Adam): losses,
    touched rows, the final export, and the untouched rows that changed,
    step by step."""
    import numpy as np
    from mxnet_tpu_torch.ops import sparse_ops
    from mxnet_tpu_torch.parallel.embedding import EmbeddingTrainer
    b = batches[0][0].shape[0]
    tr = EmbeddingTrainer(
        mesh, vocab=DLRM_CHECK_ROWS, embed_dim=DLRM_DIM,
        n_slots=len(DLRM_TABLE_ROWS), dense_dim=DLRM_DENSE,
        mlp_hidden=DLRM_MLP, optimizer=optimizer,
        learning_rate=DLRM_SGD_LR if optimizer == "sgd" else DLRM_ADAM_LR,
        momentum=0.9 if optimizer == "sgd" else 0.0, rescale_grad=1.0 / b,
        batch_size=b)
    state = tr.init_state(seed=SEED)
    inputs = [tr.shard_inputs(list(x)) for x in batches]
    saved = {}
    if patch:
        for name, fn in patch.items():
            saved[name] = getattr(sparse_ops, name)
            setattr(sparse_ops, name, fn(saved[name]))
    try:
        losses, nnz, changed = [], [], 0
        before = tr.export_training_state(state)[0]
        for s in range(DLRM_CHECK_STEPS):
            state, loss, n = tr.step(state, inputs[s % len(inputs)])
            losses.append(float(loss))
            nnz.append(int(n))
            after = tr.export_training_state(state)[0]
            changed += _dlrm_untouched(
                before, after, np.unique(batches[s % len(batches)][0]),
                tr._n_states)
            before = after
    finally:
        for name, fn in saved.items():
            setattr(sparse_ops, name, fn)
    del state
    _free_card()
    touched = np.unique(np.concatenate([x[0].reshape(-1) for x in batches]))
    return {"losses": losses, "nnz": nnz, "untouched_changed": changed,
            "final": after, "touched": touched}


def _dlrm_against(card, cpu, gate_all=True):
    """Card vs CPU: losses (relative), touched rows (counts equal; the
    table's touched rows and the MLP, norm-wise), untouched rows (none
    changed, bit for bit). Adam moves each parameter by about +-lr
    whatever its gradient's size, so a gradient that sums to about 0
    may flip its step between two summation orders: for Adam
    (``gate_all`` False) only the first loss (before any update) is held
    to DLRM_RTOL, the rest reported."""
    import numpy as np
    rel = [abs(a - b) / max(1e-30, abs(b))
           for a, b in zip(card["losses"], cpu["losses"])]
    state = 0.0
    rows = cpu["touched"]
    for k, ref in cpu["final"].items():
        got = card["final"][k]
        if "embed" in k:
            got, ref = got[rows], ref[rows]
        state = max(state, float(np.linalg.norm(got - ref)
                                 / max(1e-30, np.linalg.norm(ref))))
    held = rel if gate_all else rel[:1]
    ok = bool(max(held) <= DLRM_RTOL
              and (state <= DLRM_RTOL or not gate_all)
              and card["nnz"] == cpu["nnz"]
              and card["untouched_changed"] == 0
              and cpu["untouched_changed"] == 0)
    return {"loss_rel": rel, "state_rel": state, "nnz_card": card["nnz"],
            "nnz_cpu": cpu["nnz"],
            "untouched_changed": card["untouched_changed"],
            "held": "all" if gate_all else "first loss", "ok": ok}


def _adam_decays_every_row(orig):
    """A faulty lazy Adam: every row's moments decay, the dense update's
    habit (the control the untouched-rows check must catch)."""
    def fn(weight, mean, var, rows, grad_rows, lr, beta1, beta2, eps,
           **kw):
        mean[:-1].mul_(beta1)
        var[:-1].mul_(beta2)
        return orig(weight, mean, var, rows, grad_rows, lr, beta1, beta2,
                    eps, **kw)
    return fn


def _inverse_shifted(orig):
    """unique_rows with its inverse map shifted by one slot."""
    def fn(ids, size, fill):
        uniq, inv, count = orig(ids, size, fill)
        return uniq, (inv + 1) % size, count
    return fn


def _dlrm_checks(mesh):
    """Sparse vs dense on permutation data (bit for bit), card vs CPU at
    a 2^20-row table with both controls, and the NDArray layer."""
    import numpy as np
    from mxnet_tpu_torch.parallel.embedding import _permutation_data
    res = {}
    b = DLRM_BATCHES[-1]
    slots = len(DLRM_TABLE_ROWS)
    # 1. every row touched once: the two exchanges leave equal states
    pdata = _permutation_data(b * slots, b, slots, DLRM_DENSE, seed=SEED)
    bit = {}
    for optimizer in ("sgd", "adam"):
        outs = []
        for exchange in ("sparse", "dense"):
            tr = _dlrm_trainer(mesh, b * slots, b, optimizer, exchange)
            state = tr.init_state(seed=SEED)
            inputs = tr.shard_inputs(list(pdata))
            for _ in range(DLRM_CHECK_STEPS):
                state, _, _ = tr.step(state, inputs)
            outs.append(tr.export_training_state(state)[0])
            del state
        bit[optimizer] = bool(all(np.array_equal(outs[0][k], outs[1][k])
                                  for k in outs[0]))
    res["sparse_dense_bitwise"] = bit
    # 2. card against CPU (SGD with momentum; Adam), and two controls
    rng = np.random.RandomState(SEED + 1)
    rows = _dlrm_split(DLRM_CHECK_ROWS, slots)
    batches = [dlrm_batch(rng, b, rows) for _ in range(DLRM_CHECK_STEPS)]
    cpu, versus = {}, {}
    t0 = time.perf_counter()
    for optimizer in ("sgd", "adam"):
        cpu[optimizer] = _dlrm_run_check(_dlrm_mesh(cpu=True), batches,
                                         optimizer)
    res["cpu_seconds"] = time.perf_counter() - t0
    for optimizer in ("sgd", "adam"):
        card = _dlrm_run_check(mesh, batches, optimizer)
        versus[optimizer] = _dlrm_against(card, cpu[optimizer],
                                          gate_all=optimizer == "sgd")
    res["card_vs_cpu"] = versus
    res["controls"] = {}
    for name, optimizer, patch in (
            ("adam_decays_every_row", "adam",
             {"rows_adam_update_": _adam_decays_every_row}),
            ("inverse_shifted", "sgd", {"unique_rows": _inverse_shifted})):
        bad = _dlrm_run_check(mesh, batches, optimizer, patch)
        verdict = _dlrm_against(bad, cpu[optimizer],
                                gate_all=optimizer == "sgd")
        res["controls"][name] = dict(verdict, failed=not verdict["ok"])
    res["ndarray"] = _dlrm_ndarray_check()
    res["ok"] = bool(all(bit.values())
                     and all(v["ok"] for v in versus.values())
                     and all(c["failed"] for c in res["controls"].values())
                     and res["ndarray"]["ok"])
    return res


def _dlrm_kv(mx, ctx, w0, grads, opt):
    """A kvstore holding ``w0`` on ``ctx``, two row-sparse pushes through
    the updater of ``opt``; the pulled weight (numpy)."""
    from mxnet_tpu_torch.ndarray import sparse
    kv = mx.kv.create("local")
    kv.init("emb", mx.nd.array(w0, ctx=ctx))
    kv.set_optimizer(opt)
    for pair in grads:
        kv.push("emb", [sparse.row_sparse_array(g, shape=w0.shape, ctx=ctx)
                        for g in pair])
    out = mx.nd.zeros(w0.shape, ctx=ctx)
    kv.pull("emb", out=out)
    return out.asnumpy()


def _dlrm_ndarray_check():
    """sparse.dot(csr, dense) on the card against the dense product; lazy
    SGD (momentum, wd) and Adam through kvstore row-sparse pushes: only
    the pushed rows move, and the card's weights equal the CPU's."""
    import numpy as np
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ndarray import sparse
    c = DLRM_NDARRAY
    rng = np.random.RandomState(SEED + 2)
    cols = rng.randint(0, c["cols"], size=(c["rows"], c["nnz_row"]))
    indptr = np.arange(c["rows"] + 1) * c["nnz_row"]
    data = rng.normal(size=cols.size).astype(np.float32)
    rhs = rng.normal(size=(c["cols"], c["out"])).astype(np.float32)
    csr = sparse.csr_matrix((data, cols.reshape(-1), indptr),
                            shape=(c["rows"], c["cols"]), ctx=_ctx())
    got = sparse.dot(csr, mx.nd.array(rhs, ctx=_ctx())).asnumpy()
    dense = csr.tostype("default").asnumpy().astype(np.float64)
    ref = dense @ rhs.astype(np.float64)
    dot_err = float(np.abs(got - ref).max() / np.abs(ref).max())
    res = {"dot_rel_err": dot_err, "dot_has_parts": csr._ell is not None}
    w0 = rng.normal(size=(c["vocab"], c["out"])).astype(np.float32)
    grads = []
    for _ in range(2):
        pair = []
        for _ in range(2):
            ids = rng.choice(c["vocab"], c["grad_rows"], replace=False)
            pair.append((rng.normal(size=(len(ids), c["out"]))
                         .astype(np.float32), ids))
        grads.append(pair)
    pushed = np.unique(np.concatenate([g[1] for p in grads for g in p]))
    untouched = np.setdiff1d(np.arange(c["vocab"]), pushed)
    for name, make in (
            ("sgd", lambda: mx.optimizer.SGD(learning_rate=0.1,
                                             momentum=0.9, wd=1e-4)),
            ("adam", lambda: mx.optimizer.Adam(learning_rate=1e-2,
                                               wd=1e-4))):
        card = _dlrm_kv(mx, _ctx(), w0, grads, make())
        host = _dlrm_kv(mx, mx.cpu(), w0, grads, make())
        res[name] = {
            "rel_err_vs_cpu": float(np.abs(card - host).max()
                                    / np.abs(host).max()),
            "untouched_equal": bool(np.array_equal(card[untouched],
                                                   w0[untouched])),
            "pushed_moved": bool((card[pushed] != w0[pushed]).any(axis=1)
                                 .all())}
    res["ok"] = bool(dot_err <= DLRM_RTOL and res["dot_has_parts"] and all(
        res[n]["rel_err_vs_cpu"] <= 1e-6 and res[n]["untouched_equal"]
        and res[n]["pushed_moved"] for n in ("sgd", "adam")))
    return res


def _dlrm_example(mesh):
    """examples/dlrm_train.py's constants, generator and steps through
    the port's trainer (the example imports jax): the loss falls over
    its 120 steps, and the step after an export and import equals the
    uninterrupted step bit for bit."""
    import numpy as np
    c = DLRM_EXAMPLE
    tr = _dlrm_trainer(mesh, c["vocab"], c["batch"], "adam",
                       slots=c["slots"], dim=c["dim"], dense=c["dense"],
                       mlp=c["mlp"], lr=c["lr"])
    state = tr.init_state(c["batch"], seed=0)
    rng = np.random.RandomState(7)

    def batch():
        ids = np.minimum(rng.zipf(1.3, size=(c["batch"], c["slots"])) - 1,
                         c["vocab"] - 1).astype(np.int32)
        dense = rng.normal(size=(c["batch"], c["dense"])).astype(np.float32)
        y = (((ids[:, 0] + ids[:, 1]) % 2) ^ (dense[:, 0] > 0)) \
            .astype(np.float32)
        return ids, dense, y

    losses = []
    t0 = time.perf_counter()
    for _ in range(c["steps"]):
        state, loss, _ = tr.step(state, tr.shard_inputs(list(batch())))
        losses.append(float(loss) / c["batch"])
    secs = time.perf_counter() - t0
    arrays, meta = tr.export_training_state(state)
    resumed = tr.import_training_state(arrays, meta)
    inputs = tr.shard_inputs(list(batch()))
    state, l_a, _ = tr.step(state, inputs)
    resumed, l_b, _ = tr.step(resumed, inputs)
    a = tr.export_training_state(state)[0]
    b = tr.export_training_state(resumed)[0]
    first, last = float(np.mean(losses[:20])), float(np.mean(losses[-20:]))
    bitwise = bool(float(l_a) == float(l_b)
                   and all(np.array_equal(a[k], b[k]) for k in a))
    return {"loss_first20": first, "loss_last20": last, "seconds": secs,
            "resume_bitwise": bitwise, "ok": bool(last < first and bitwise)}


def _dlrm_bench_cli():
    """``python -m mxnet_tpu_torch.parallel.embedding --bench`` on the
    card: its exit code and its JSON line."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [HERE] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    args = [sys.executable, "-m", "mxnet_tpu_torch.parallel.embedding",
            "--bench"] + ([] if DEV == "cuda" else ["--ctx", "cpu"])
    t0 = time.perf_counter()
    proc = subprocess.run(args, capture_output=True, text=True,
                          timeout=300, env=env, cwd=HERE)
    line = (proc.stdout.strip().splitlines() or [""])[-1]
    try:
        rec = json.loads(line)
    except ValueError:
        rec = {"stdout": line[-500:], "stderr": proc.stderr[-500:]}
    return {"exit_code": proc.returncode, "seconds":
            time.perf_counter() - t0, "result": rec,
            "ok": proc.returncode == 0}


def phase_dlrm():
    """The row-sparse EmbeddingTrainer at Criteo Kaggle's widths
    (DLRM_TABLE_ROWS as one 33,762,577 x 16 table, 26 slots, 13 dense,
    MLP 512-256-1) on synthetic zipf(1.3) clicks: the sparse exchange
    with SGD at batch 128 and 2048, bf16 and fp8 wires, the dense
    exchange (the A/B), Adam; each arm's steps/s, samples/s, touched
    rows, analytic wire, peak memory, busy share, kernels a step and
    largest device operations, with a warmed step under sync-debug
    "error". The table is drawn once on the card and carried between
    arms by export and import. Then the checks (sparse vs dense bit for
    bit, card vs CPU with two controls that must fail, the NDArray
    layer), examples/dlrm_train.py's program and the CLI's --bench."""
    import numpy as np
    import torch
    _free_card()
    t_phase = time.perf_counter()
    mesh = _dlrm_mesh()
    vocab = int(sum(DLRM_TABLE_ROWS))
    res = {"vocab": vocab, "dim": DLRM_DIM, "slots": len(DLRM_TABLE_ROWS),
           "dense": DLRM_DENSE, "mlp": list(DLRM_MLP) + [1],
           "table_bytes": vocab * DLRM_DIM * 4}
    rng = np.random.RandomState(SEED)
    data = {b: [dlrm_batch(rng, b) for _ in range(DLRM_DISTINCT)]
            for b in DLRM_BATCHES}
    _reset_counts()
    arms = {}
    small, big = DLRM_BATCHES
    tr = _dlrm_trainer(mesh, vocab, small)
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    state = tr.init_state(small, generator=gen)
    _sync()
    res["init_seconds"] = time.perf_counter() - t0
    plan = (("sparse_sgd_b%d" % small, tr, DLRM_WINDOW),
            ("sparse_sgd_b%d" % big, _dlrm_trainer(mesh, vocab, big),
             DLRM_WINDOW),
            ("sparse_sgd_bf16_b%d" % big,
             _dlrm_trainer(mesh, vocab, big, compress="bf16"),
             DLRM_WIRE_WINDOW),
            ("sparse_sgd_fp8_b%d" % big,
             _dlrm_trainer(mesh, vocab, big, compress="fp8"),
             DLRM_WIRE_WINDOW),
            ("dense_sgd_b%d" % big,
             _dlrm_trainer(mesh, vocab, big, exchange="dense"), DLRM_WINDOW),
            ("sparse_adam_b%d" % big,
             _dlrm_trainer(mesh, vocab, big, "adam"), DLRM_WINDOW))
    prev = None
    carry_s = 0.0
    for name, arm_tr, window in plan:
        if prev is not None:
            t0 = time.perf_counter()
            state = _dlrm_carry(prev, state, arm_tr,
                                moments=arm_tr.optimizer == "adam")
            _sync()
            carry_s += time.perf_counter() - t0
        state, arms[name] = _dlrm_arm(arm_tr, state, data[arm_tr._batch],
                                      window)
        prev = arm_tr
    del state
    _free_card()
    res["carry_seconds"] = carry_s
    res["arms"] = arms
    res["launches"] = _read_counts()
    sp_b = arms["sparse_sgd_b%d" % big]["steps_per_s"]
    dn_b = arms["dense_sgd_b%d" % big]["steps_per_s"]
    res["sparse_over_dense"] = sp_b / dn_b
    res["meets_2x_bar"] = bool(sp_b >= 2 * dn_b)
    t0 = time.perf_counter()
    res["checks"] = _dlrm_checks(mesh)
    res["checks"]["seconds"] = time.perf_counter() - t0
    res["example"] = _dlrm_example(mesh)
    res["bench_cli"] = _dlrm_bench_cli()
    res["phase_s"] = time.perf_counter() - t_phase
    res["ok"] = bool(
        res["checks"]["ok"] and res["example"]["ok"]
        and res["bench_cli"]["ok"]
        and all(a.get("sync_free", DEV != "cuda") for a in arms.values())
        and all(np.isfinite(a["loss_per_sample"]).all()
                for a in arms.values())
        and not any(res["launches"][k] for k in _wrappers()))
    RECORD["dlrm"] = res
    _free_card()
    if not res["ok"]:
        raise AssertionError("dlrm failed: %s"
                             % json.dumps(res, default=str)[:6000])
    return res


class _FeedSource:
    """A re-iterable (x, y) source of host numpy batches that sleeps
    ``host_s`` before each (the decode / read stand-in of bench.py's
    pipeline lane)."""

    def __init__(self, xs, ys, host_s):
        self.xs, self.ys, self.host_s = xs, ys, host_s

    def __iter__(self):
        for x, y in zip(self.xs, self.ys):
            if self.host_s:
                time.sleep(self.host_s)
            yield x, y


@contextlib.contextmanager
def _env(**values):
    """os.environ with ``values`` set (None: unset) for the block."""
    old = {k: os.environ.get(k) for k in values}
    try:
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = str(v)
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _feed_arm(mx, init, source, feed_on):
    """resnet50_v1 from ``init`` fused-fit for FEED_EPOCHS epochs over
    ``source`` with the device feed on or off: (record, host params)."""
    from mxnet_tpu_torch import pipeline
    net = _gluon_r50(mx, init, _ctx())
    marks = []
    pipeline.reset_stats()
    _sync()
    with _env(MXNET_DEVICE_FEED=int(feed_on)), _watch_step_k() as calls:
        losses = _gluon_fit(mx, net, source, FEED_EPOCHS, GFUSED_K,
                            lambda e, _n, _l: marks.append(
                                time.perf_counter()))
    _sync()
    feed = pipeline.stats()
    per_epoch = len(calls) // FEED_EPOCHS
    epochs = [calls[i * per_epoch:(i + 1) * per_epoch]
              for i in range(FEED_EPOCHS)]

    def gap(a, b):
        return max(0.0, a["events"][1].elapsed_time(b["events"][0])) \
            if a["events"] else 0.0
    steps = sum(c["k"] for ep in epochs[1:] for c in ep)
    span_s = marks[-1] - marks[0]
    rec = {"feed": bool(feed_on), "epoch_losses": losses,
           "img_per_s": steps * R50_BATCH / span_s,
           "step_s": span_s / steps,
           "idle_ms_at_epoch_start": [gap(epochs[e - 1][-1], epochs[e][0])
                                      for e in range(1, FEED_EPOCHS)],
           "idle_ms_between_blocks": [sum(gap(a, b) for a, b in
                                          zip(ep, ep[1:])) for ep in epochs],
           "device_ms_per_step": sum(_block_device_ms(c) for ep in epochs[1:]
                                     for c in ep) / steps,
           "captures": calls[0]["trainer"].captures,
           "feed_stats": feed,
           "losses_finite": bool(all(math.isfinite(v) for v in losses))}
    params = _host_params(net)
    del net, calls
    _free_card()
    return rec, params


def phase_device_feed():
    """ResNet-50 v1 through fused_fit at gluon_fused_resnet50's
    configuration over a source that costs one device step a batch on
    the host, with the device feed off and then on: both rates and their
    ratio, the feed's counters, the card's idle at each epoch's start,
    and the parameters bit-identical between the arms. Nothing is
    claimed of the ratio: fused_fit already reads each block's losses a
    block late, so staging overlapped the replays before the feed."""
    import numpy as np
    import torch
    import mxnet_tpu_torch as mx
    _free_card()
    init = _gluon_r50_init(mx)
    rng = np.random.RandomState(SEED)
    xs = [rng.uniform(0, 1, (R50_BATCH, 3, R50_IMG, R50_IMG))
          .astype(np.float32) for _ in range(GFUSED_BATCHES)]
    ys = [rng.randint(0, 1000, R50_BATCH).astype(np.float32)
          for _ in range(GFUSED_BATCHES)]
    res = {"model": "gluon.model_zoo.vision.resnet50_v1(classes=1000)",
           "batch": R50_BATCH, "image": R50_IMG, "dtype": "float32",
           "k": GFUSED_K, "batches": GFUSED_BATCHES, "epochs": FEED_EPOCHS,
           "cudnn_deterministic": True}
    _reset_counts()
    with _cudnn_deterministic():
        free, _ = _feed_arm(mx, init, _FeedSource(xs, ys, 0.0), False)
        host_s = max(free["step_s"], FEED_MIN_HOST_S)
        off, p_off = _feed_arm(mx, init, _FeedSource(xs, ys, host_s), False)
        on, p_on = _feed_arm(mx, init, _FeedSource(xs, ys, host_s), True)
    counts = _read_counts()
    diff = [n for n in p_off if not torch.equal(p_off[n], p_on[n])]
    res.update({"calibration": free, "host_cost_ms_per_batch": host_s * 1e3,
                "feed_off": off, "feed_on": on,
                "img_per_s_off": off["img_per_s"],
                "img_per_s_on": on["img_per_s"],
                "ratio_on_over_off": on["img_per_s"] / off["img_per_s"],
                "overlap_frac": on["feed_stats"]["overlap_frac"],
                "feed_wait_us": on["feed_stats"]["feed_wait_us"],
                "feed_stage_us": on["feed_stats"]["feed_stage_us"],
                "params_bit_identical": not diff, "params_differing": diff[:8],
                "tensors": len(p_off), "launches": counts})
    res["ok"] = bool(not diff and len(p_off) > 100
                     and on["losses_finite"] and off["losses_finite"]
                     and on["epoch_losses"] == off["epoch_losses"]
                     and on["feed_stats"]["feed_batches"]
                     == FEED_EPOCHS * -(-GFUSED_BATCHES // GFUSED_K)
                     and on["feed_stats"]["feeds_active"] == 0
                     and off["feed_stats"]["feed_batches"] == 0
                     and on["captures"] == off["captures"]
                     == (1 if DEV == "cuda" else 0)
                     and not any(counts[k] for k in _wrappers()))
    RECORD["device_feed"] = res
    del p_off, p_on, xs, ys
    _free_card()
    if not res["ok"]:
        raise AssertionError("device_feed failed: %s"
                             % json.dumps(res, default=str)[:4000])
    return res


_LANE_KERNELS = {"flash_attention_fwd": r"\bflash_fwd_tc\b",
                 "flash_attention_bwd_dq": r"\bflash_bwd_dq_tc\b",
                 "flash_attention_bwd_dkv": r"\bflash_bwd_dkv\b"}


def _lane_counts(path):
    """Kernel events of a torch.profiler chrome trace by flash wrapper
    (the kernel each launches), and all kernel events."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    out = {w: sum(1 for n in kernels if re.search(rx, n))
           for w, rx in _LANE_KERNELS.items()}
    out["kernel_events"] = len(kernels)
    return out


def _lane_pad():
    """Kernels that open a kernel-lane session before the counted work:
    in the whole script (after the earlier phases' profiler sessions)
    CUPTI did not record the first kernels a session ran, 2–3 flash
    forwards of 96 and 48, where ``--phases device,build,traced_lm`` lost
    none."""
    import torch
    if DEV != "cuda":
        return
    pad = torch.zeros(1024, device="cuda")
    for _ in range(256):
        pad.add_(1.0)
    torch.cuda._sleep(50_000_000)
    _sync()
    time.sleep(0.05)


def _lane_window(directory, fn):
    """Launch counts and the kernel lane's flash counts over ``fn()``."""
    from mxnet_tpu_torch import profiler
    profiler.set_config(xplane_dir=directory, profile_imperative=False,
                        profile_symbolic=False)
    _sync()
    profiler.set_state("run")
    try:
        _lane_pad()
        _reset_counts()
        fn()
        _sync()
    finally:
        profiler.set_state("stop")
    counts = _read_counts()
    seen = _lane_counts(profiler.kernel_profile()[1])
    return {"launches": {k: counts[k] for k in _FLASH}, "trace": seen,
            "equal": all(seen[k] == counts[k] for k in _FLASH)}


def _glm_eager_steps(mx, init, x, y, steps):
    """``steps`` steps of the hybridized Trainer loop of the LM (one
    warm-up step first, outside the caller's window)."""
    net = _glm_net(mx, init, GLM_LAYERS)
    trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                               {"learning_rate": TRAIN_LR})
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()

    def step():
        with mx.autograd.record():
            loss = loss_fn(net(x).reshape((-3, 0)), y.reshape((-1,))).mean()
        loss.backward()
        trainer.step(1)
    step()
    return net, trainer, lambda: [step() for _ in range(steps)]


class _MonitorRecorder:
    """A Monitor subclass (made at run time) keeping each window."""

    @staticmethod
    def make(mx, **kw):
        class Recorder(mx.Monitor):
            def __init__(self):
                super().__init__(**kw)
                self.windows = []

            def toc_print(self):
                self.windows.append(self.toc())
        return Recorder()


def _monitor_check(mx):
    """Monitor(monitor_all=True) over 2 steps of LeNet's Module.fit on the
    card and on the CPU from the same parameters: the tapped names equal,
    each mean |x| within MODULE_RTOL."""
    import numpy as np
    x, y = synthetic_mnist(2 * LENET_BATCH, SEED)
    out = {}
    host_params = None
    for name, ctx in (("cpu", mx.cpu()), ("card", _ctx())):
        it = mx.io.NDArrayIter(x, y, LENET_BATCH,
                               label_name="softmax_label")
        with mx.NameManager():
            mod = mx.mod.Module(lenet_symbol(mx.sym), context=ctx)
        if host_params is None:
            mod.bind(data_shapes=it.provide_data,
                     label_shapes=it.provide_label)
            mx.random.seed(SEED)
            mod.init_params(mx.init.Uniform(0.01))
            host_params = mod.get_params()
        mon = _MonitorRecorder.make(mx, interval=1, monitor_all=True)
        mod.fit(it, num_epoch=1, optimizer="sgd", arg_params=host_params[0],
                aux_params=host_params[1], force_init=True,
                optimizer_params={"learning_rate": LENET_LR,
                                  "rescale_grad": 1.0 / LENET_BATCH},
                monitor=mon)
        out[name] = mon.windows
        del mod
    names = {k: [r[1] for w in v for r in w] for k, v in out.items()}
    errs = []
    for wc, wh in zip(out["card"], out["cpu"]):
        for (_, _, a), (_, _, b) in zip(wc, wh):
            a = np.array([float(v) for v in a.split()])
            b = np.array([float(v) for v in b.split()])
            errs.append(float(np.abs(a - b).max()
                              / max(np.abs(b).max(), 1e-30)))
    return {"windows": len(out["card"]), "records": len(names["card"]),
            "names_equal": names["card"] == names["cpu"],
            "inputs_tapped": sum(1 for n in names["card"]
                                 if not n.endswith("_output")),
            "max_rel_err": max(errs) if errs else None, "rtol": MODULE_RTOL,
            "ok": bool(names["card"] == names["cpu"] and len(out["card"]) == 2
                       and errs and max(errs) <= MODULE_RTOL)}


def _flightrec_check(mx, directory):
    """A small MLP's fused_fit on the card whose source raises after a few
    batches, with the flight recorder installed: the exception goes to
    sys.excepthook as an uncaught one would; the box on disk names it and
    holds the fit's last spans."""
    import numpy as np
    from mxnet_tpu_torch.telemetry import flightrec
    rng = np.random.RandomState(SEED)

    def source():
        for i in range(6):
            if i == 5:
                raise RuntimeError("source failed at batch 5")
            yield (rng.normal(size=(TRACE_MLP_BATCH, 32)).astype(np.float32),
                   rng.randint(0, 4, TRACE_MLP_BATCH).astype(np.float32))

    class Once:
        def __iter__(self):
            return source()
    net = mx.gluon.nn.HybridSequential()
    net.add(mx.gluon.nn.Dense(64, activation="relu"), mx.gluon.nn.Dense(4))
    net.initialize(mx.init.Xavier(), ctx=_ctx())
    net.hybridize()
    prev = sys.excepthook
    sys.excepthook = lambda *a: None      # the chained hook: quiet
    try:
        flightrec.install(directory=directory)
        try:
            _gluon_fit(mx, net, Once(), 1, 2)
            raised = None
        except RuntimeError:
            raised = sys.exc_info()
            sys.excepthook(*raised)
    finally:
        flightrec.uninstall()
        sys.excepthook = prev
    path = os.path.join(directory, "flightrec-rank-0.json")
    with open(path) as f:
        box = json.load(f)
    names = [e["name"] for e in box["events"]]
    del net
    _free_card()
    return {"raised": raised is not None, "reason": box["reason"],
            "events": len(names), "last": names[-6:],
            "ok": bool(raised is not None
                       and box["reason"].startswith(
                           "uncaught exception: RuntimeError")
                       and "uncaught:RuntimeError" in names
                       and "step.fused_dispatch" in names
                       and "feed.wait" in names)}


def _watchdog_check(directory):
    """A loop that beats through the step log, then stalls: the watchdog
    dumps every thread's stack within its stall limit."""
    from mxnet_tpu_torch.telemetry import StepLogger, watchdog
    from mxnet_tpu_torch.telemetry.registry import get_registry
    c = get_registry().counter("mxnet_watchdog_stall_dumps_total")
    before = c.value()
    path = os.path.join(directory, "stall.txt")
    watchdog.install(stall_s=TRACE_STALL_S, path=path, sigusr1=False)
    slog = StepLogger("stalled_loop")
    for _ in range(3):
        slog.step(samples=1)
        time.sleep(0.02)
    t_last = time.monotonic()
    while c.value() == before and time.monotonic() - t_last < 10:
        time.sleep(0.01)
    took = time.monotonic() - t_last
    watchdog.uninstall()
    slog.close()
    with open(path) as f:
        text = f.read()
    return {"stall_s": TRACE_STALL_S, "beat_to_dump_s": took,
            "dumps": c.value() - before,
            "ok": bool(c.value() == before + 1 and "step stalled" in text
                       and "(stalled_loop step)" in text
                       and "Thread" in text
                       and took <= TRACE_STALL_S * 1.25 + 0.25)}


def _scrape_check():
    """One /metrics scrape and /healthz of the exporter."""
    import urllib.request
    from mxnet_tpu_torch import telemetry
    srv = telemetry.start_server(0, host="127.0.0.1")
    try:
        body = urllib.request.urlopen(srv.url + "/metrics",
                                      timeout=30).read().decode()
        health = json.loads(urllib.request.urlopen(
            srv.url + "/healthz", timeout=30).read().decode())
    finally:
        telemetry.stop_server()
    want = ["mxnet_device_feed_feed_batches", "mxnet_device_feed_overlap_frac",
            "mxnet_devstats_programs", "mxnet_devstats_peak_bytes",
            "mxnet_trace_compute_seconds_bucket",
            "mxnet_trace_feed_seconds_bucket",
            "mxnet_step_time_seconds_bucket", "mxnet_steps_total",
            "mxnet_amp_amp_cast_bytes_saved"]
    missing = [w for w in want if w not in body]
    return {"missing": missing, "subsystems": health.get("subsystems"),
            "metrics": health.get("metrics"), "bytes": len(body),
            "ok": bool(not missing and health.get("status") == "ok"
                       and {"device_feed", "devstats", "amp"}
                       <= set(health.get("subsystems", [])))}


def phase_traced_lm():
    """gluon_fused_lm's LM through fused_fit with every runtime plane off
    and then on (tracing, the step log, the flight recorder, the
    watchdog, the profiler's kernel lane) from the same parameters:
    bit-identical, the tracing tax, the trace and step log read back,
    the kernel lane against the launch counters, a traced step_k under
    sync-debug "error", the watchdog, the flight recorder, /metrics and
    Monitor."""
    import shutil
    import tempfile
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import pipeline, profiler
    from mxnet_tpu_torch.telemetry import StepLogger, tracing, watchdog
    _free_card()
    if "init" in _GLM_REF:
        init = _GLM_REF["init"]
        x, y = (mx.nd.NDArray(t) for t in _lm_batch())
    else:
        init, x, y = _glm_init(mx)
        _GLM_REF["init"] = init
    work = tempfile.mkdtemp(prefix="traced_lm_")
    log = os.path.join(work, "steps.jsonl")
    saved_cfg = dict(profiler._config)
    res = {"layers": GLM_LAYERS, "k": GFLM_K, "steps_an_epoch": GFLM_STEPS,
           "epochs": 2, "batch": TRAIN_BATCH}
    try:
        # 1. every plane off, then on, from the same parameters
        with _env(MXNET_TRACE=0, MXNET_FLIGHTREC=0, MXNET_TELEMETRY=0,
                  MXNET_TELEMETRY_LOG=None):
            plain, tr0, calls0, p0 = _glm_fused_run(
                mx, init, x, y, GLM_LAYERS, keep_params=True)
        del tr0, calls0
        _free_card()
        from mxnet_tpu_torch.telemetry import flightrec
        with _env(MXNET_TRACE=1, MXNET_FLIGHTREC=1, MXNET_TELEMETRY=1,
                  MXNET_TELEMETRY_LOG=log):
            profiler.clear_events()
            tracing.reset_phase_totals()
            flightrec.reset()
            flightrec.install(directory=os.path.join(work, "box"))
            watchdog.install(stall_s=TRACE_FIT_STALL_S,
                             path=os.path.join(work, "fit_stall.txt"),
                             sigusr1=False)
            profiler.set_config(xplane_dir=os.path.join(work, "lane_fit"),
                                filename=os.path.join(work, "ops.json"))
            profiler.set_state("run")
            try:
                traced, tr1, calls1, p1 = _glm_fused_run(
                    mx, init, x, y, GLM_LAYERS, keep_params=True)
            finally:
                profiler.set_state("stop")
                watchdog.uninstall()
                flightrec.uninstall()
            shard = tracing.dump(path=os.path.join(work, "shards",
                                                   "trace-rank-0.json"))
        fit_lane = _lane_counts(profiler.kernel_profile()[1])
        differ = [n for n in p0 if not torch.equal(p0[n], p1[n])]
        res.update({
            "plain": {k: plain[k] for k in ("step_losses", "step_s",
                                            "device_ms_per_step",
                                            "host_enqueue_ms_per_step",
                                            "device_busy_share")},
            "traced": {k: traced[k] for k in ("step_losses", "step_s",
                                              "device_ms_per_step",
                                              "host_enqueue_ms_per_step",
                                              "device_busy_share")},
            "steps_per_s_plain": 1.0 / plain["step_s"],
            "steps_per_s_traced": 1.0 / traced["step_s"],
            "tracing_tax": traced["step_s"] / plain["step_s"] - 1.0,
            "losses_bit_identical":
                plain["step_losses"] == traced["step_losses"],
            "params_bit_identical": not differ,
            "params_differing": differ[:8], "tensors": len(p0),
            "launches": traced["launches"],
            "fit_lane": {"trace": fit_lane,
                         "launches": {k: traced["launches"][k]
                                      for k in _FLASH},
                         "captured_a_kernel": {
                             k: traced["launches_a_replay"].get(k, 0)
                             for k in _FLASH}}})
        del p0, p1
        # 2. the shard merged, the step log read back
        merged_path, summary = tracing.merge(os.path.dirname(shard),
                                             out_path=os.path.join(
                                                 work, "merged.json"))
        with open(merged_path) as f:
            evs = json.load(f)["traceEvents"]
        spans = {}
        for e in evs:
            if e.get("ph") == "X" and e.get("cat", "").startswith("trace:"):
                key = "%s|%s" % (e["name"], e["cat"])
                spans[key] = spans.get(key, 0) + 1
        blocks = len(calls1)
        with open(log) as f:
            recs = [json.loads(line) for line in f if line.strip()]
        steps = [r for r in recs if r["event"] == "step"]
        res["trace"] = {"spans": spans, "events": summary["events"],
                        "dropped": summary["dropped_events"],
                        "summary": tracing.format_summary(summary)[:1500]}
        res["step_log"] = {"records": len(recs), "step_records": len(steps),
                           "blocks": blocks, "first": steps[:1]}
        trace_ok = (spans.get("step.fused_dispatch|trace:compute") == blocks
                    and spans.get("feed.wait|trace:feed", 0) >= blocks
                    and spans.get("feed.stage|trace:feed_stage", 0)
                    >= blocks)
        log_ok = (len(steps) == blocks and all(
            {"feed_us", "compute_us", "feed_compute_overlap_frac"} <= set(r)
            for r in steps) and all(r["compute_us"] > 0 for r in steps))
        # 3. the kernel lane against the counters: 2 more step_k calls
        # (replays of the captured step), and 2 eager steps
        inputs = tr1.shard_inputs([torch.stack([x._data] * GFLM_K),
                                   torch.stack([y._data] * GFLM_K)],
                                  stacked=True)
        replays = _lane_window(
            os.path.join(work, "lane_replays"),
            lambda: [tr1.step_k(tr1._params, tr1._states, tr1._aux, inputs)
                     for _ in range(2)])
        # 4. one traced step_k, the step log and a feed staging under
        # sync-debug "error": none of them waits for the card (on the
        # host, a rehearsal, there is nothing to check)
        sync_free = None
        _sync()
        with _env(MXNET_TRACE=1, MXNET_TELEMETRY_LOG=None):
            copy_stream = torch.cuda.Stream() if DEV == "cuda" else None
            host = torch.zeros(TRAIN_BATCH, 1024)
            slog = StepLogger("sync_debug")
            if DEV == "cuda":
                torch.cuda.set_sync_debug_mode("error")
            try:
                with tracing.span("step.fused_dispatch", phase="compute",
                                  k=GFLM_K):
                    tr1.step_k(tr1._params, tr1._states, tr1._aux, inputs)
                staged, ev = pipeline.stage_tensors(
                    [host], _ctx().torch_device(), copy_stream)
                pipeline.Staged(staged, staged, ev).ready()
                slog.step(samples=GFLM_K * TRAIN_BATCH, steps=GFLM_K)
                sync_free = DEV == "cuda"
            finally:
                if DEV == "cuda":
                    torch.cuda.set_sync_debug_mode(0)
            slog.close()
        _sync()
        del tr1, calls1, inputs
        _free_card()
        net, _tr, run = _glm_eager_steps(mx, init, x, y, TRACE_EAGER_STEPS)
        eager = _lane_window(os.path.join(work, "lane_eager"), run)
        del net, _tr, run
        _free_card()
        res["lane"] = {"replays_2_step_k": replays,
                       "eager_steps": dict(eager, steps=TRACE_EAGER_STEPS)}
        res["sync_debug_step_k_ok"] = sync_free
        # 5. watchdog, flight recorder, /metrics, Monitor
        res["watchdog"] = _watchdog_check(work)
        res["flightrec"] = _flightrec_check(mx, os.path.join(work, "crash"))
        res["metrics"] = _scrape_check()
        res["monitor"] = _monitor_check(mx)
    finally:
        profiler._config.clear()
        profiler._config.update(saved_cfg)
        shutil.rmtree(work, ignore_errors=True)
    res["ok"] = bool(
        res["losses_bit_identical"] and res["params_bit_identical"]
        and res["tensors"] > 100 and trace_ok and log_ok
        and res["lane"]["eager_steps"]["equal"]
        and all(res["lane"]["eager_steps"]["launches"][k] > 0
                for k in _FLASH)
        and res["sync_debug_step_k_ok"] and res["watchdog"]["ok"]
        and res["flightrec"]["ok"] and res["metrics"]["ok"]
        and res["monitor"]["ok"]
        and all(traced["launches"][k] > 0 for k in _FLASH)
        and not any(traced["launches"][k]
                    for k in _wrappers() if k not in _FLASH))
    RECORD["traced_lm"] = res
    _free_card()
    if not res["ok"]:
        raise AssertionError("traced_lm failed: %s"
                             % json.dumps(res, default=str)[:6000])
    return res


# -- parallel breadth: sequence, ZeRO, tensor / expert / pipeline ------------

# ring_attention: GPT-2 medium's attention widths (16 heads of 64) over a
# sequence of 4 x 4096 split over 4 replicas of the card, causal, the SGD
# step of examples/long_context_lm.py (q, k, v drawn x 0.3, an N(0, 1)
# target, mean squared error, lr 0.5). Tolerances, norm-wise against one
# flash call over the whole sequence: f32 1e-5 (the kernels' 3xTF32
# products, the merge's exp in float32), bf16 1e-2 (each block's output
# rounds to bf16 before the merge)
RING = dict(batch=1, heads=16, head_dim=64, sp=4, seq_per_replica=4096)
RING_SMALL_SEQ = 512            # a replica's block in the dense-body check
RING_STEPS = 3
RING_LR = 0.5
RING_TOL = {"f32": 1e-5, "bf16": 1e-2}
# the controls must miss the tolerance; the lse cotangent's share of the
# gradients (0.6% norm-wise at these inputs) lies under bf16's 1e-2, so
# only f32 gates the dropped-glse control (bf16 reports it)
RING_GLSE_GATED = ("f32",)
RING_TIME_ITERS = 3

# zero_lm: gluon_fused_lm's LM (TRAIN, 8 x 1024 tokens, Adam) as one loss
# Symbol through DataParallelTrainer over 4 replicas of the card (batch 2
# a replica), 3 steps an arm from the same parameters
ZERO_REPLICAS = 4
# the LM's depth in zero_lm and planner (4 replicas of the card, eager
# ZeRO arms): 12 of GPT-2 medium's 24 layers, so that the whole script
# stays well inside its time limit (24 layers took 175 s of the two
# phases' 1091 in the run that added the image phases)
ZERO_LM_LAYERS = 12
ZERO_STEPS = 3
ZERO_TOL = 1e-6                 # ZeRO-1 vs dp (when not bitwise), 2 vs 1
# fp8 wire: the loss after its first compressed update against float32's
# (e4m3 without a scale sends a gradient element under 2^-10 as 0 and
# keeps it in the residual, so the gap grows over the first steps: every
# step's is reported; tests/test_torch_zero.py holds the gap to the JAX
# package's on a small LM). The error feedback is gated by a control arm
# whose residual is zeroed after every step: it must leave the fp8 arm
# at the third loss, the first after a step with a residual
ZERO_FP8_LOSS_RTOL = 1e-2
ZERO_FIT_STEPS = 2              # fused_fit under MXNET_ZERO_STAGE=2

# tp_pp: GPT-2 medium's MLP (8,192 tokens x 1024, hidden 4096) over tp 4;
# 8 experts of 1024 -> 4096 over ep 4; 4 stages of 1024 x 1024 with 8
# microbatches of 1,024 rows. f32, norm-wise 1e-5 against each function's
# reference on the card; on TP_CPU_ROWS tokens, in float64, the card and
# the host each against the reference in float64 on the host (1e-10:
# float64 sums in another order)
TP = dict(tokens=8192, d=1024, hidden=4096, n=4)
MOE = dict(tokens=8192, d=1024, hidden=4096, experts=8, n=4)
PIPE = dict(stages=4, d=1024, micro=8, rows=1024)
TP_TOL = 1e-5
TP_F64_TOL = 1e-10
TP_CPU_ROWS = 1024


def _replica_mesh(axis, n, device=None):
    """A mesh listing one device ``n`` times (the card, or the host)."""
    import torch
    from mxnet_tpu_torch.parallel import build_mesh
    dev = device or DEV
    dev = torch.device("cuda", 0) if dev == "cuda" else torch.device("cpu")
    return build_mesh({axis: n}, [dev] * n)


def _nerr(got, ref):
    """||got - ref|| / ||ref||, in float64."""
    g, r = got.detach().double(), ref.detach().double().to(got.device)
    return float((g - r).norm() / max(float(r.norm()), 1e-300))


def _attn_step(fn, q, k, v, target):
    """(loss, output, (dq, dk, dv)) of long_context_lm.py's MSE loss."""
    import torch
    qs = [t.detach().requires_grad_(True) for t in (q, k, v)]
    out = fn(*qs)
    loss = ((out.float() - target) ** 2).mean()
    grads = torch.autograd.grad(loss, qs)
    return loss.detach(), out.detach(), grads


def _ring_inputs(dt, s, seed):
    import torch
    g = torch.Generator(device=DEV).manual_seed(seed)
    shape = (RING["batch"], RING["heads"], s, RING["head_dim"])
    q, k, v = ((torch.randn(shape, generator=g, device=DEV) * 0.3).to(dt)
               for _ in range(3))
    target = torch.randn(shape, generator=g, device=DEV)
    return q, k, v, target


def _counted(fn):
    """fn()'s result and the kernel launches it made (counts set to 0
    just before, read just after)."""
    _sync()
    _reset_counts()
    out = fn()
    _sync()
    return out, _read_counts()


def _add_counts(total, counts):
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def _attn_path(name, fn, whole, q, k, v, target, tol, per_step):
    """One attention path over the sequence split: RING_STEPS SGD steps
    (the main path, counted), then its output and gradients at the first
    state against one flash call over the whole sequence."""
    import torch

    def train():
        a, b, c = q, k, v
        losses = []
        for _ in range(RING_STEPS):
            loss, _, grads = _attn_step(fn, a, b, c, target)
            a, b, c = (t - RING_LR * gr for t, gr in zip((a, b, c), grads))
            losses.append(float(loss))
        return losses

    t0 = time.perf_counter()
    losses, counts = _counted(train)
    step_s = (time.perf_counter() - t0) / RING_STEPS
    _, o_p, g_p = _attn_step(fn, q, k, v, target)
    _, o_w, g_w = _attn_step(whole, q, k, v, target)
    errs = {"out": _nerr(o_p, o_w)}
    errs.update({"d" + n: _nerr(a, b) for n, a, b in zip("qkv", g_p, g_w)})
    want = {f: per_step * RING_STEPS for f in _FLASH}
    rec = {"losses": losses, "step_s": step_s,
           "launches": counts, "launches_want": want,
           "errors_vs_whole": errs, "tol": tol,
           "finite": bool(all(math.isfinite(v) for v in losses))}
    rec["ok"] = bool(rec["finite"] and max(errs.values()) <= tol
                     and (DEV != "cuda" or all(
                         counts[f] == want[f] for f in _FLASH))
                     and counts["dense_attention"] == 0)
    del o_p, g_p, o_w, g_w
    return rec, counts


def _attn_costs(fn, q, k, v, target):
    """Device ms of one forward and backward of ``fn`` (CUDA events, the
    mean of RING_TIME_ITERS after one warm-up) and its peak memory above
    the inputs."""
    import torch
    _attn_step(fn, q, k, v, target)
    _sync()
    if DEV != "cuda":
        return {"ms": None, "peak_extra_gb": None}
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    st = torch.cuda.Event(enable_timing=True)
    en = torch.cuda.Event(enable_timing=True)
    st.record()
    for _ in range(RING_TIME_ITERS):
        _attn_step(fn, q, k, v, target)
    en.record()
    en.synchronize()
    return {"ms": st.elapsed_time(en) / RING_TIME_ITERS,
            "peak_extra_gb": (torch.cuda.max_memory_allocated() - base)
            / 1e9}


def phase_ring_attention():
    """Sequence parallelism on the flash kernels over 4 replicas of the
    card: ring_attention (16 forward, dQ and dK/dV launches a step, the
    backward with a non-zero lse cotangent) and ulysses_attention (4 of
    each), each in f32 and bf16 through long_context_lm.py's step, held
    against one flash call over the whole sequence and the ring's dense
    body; two controls (off-diagonal blocks unmasked, the lse cotangent
    dropped) must fail; the profiler's kernel lane counts a ring step."""
    import tempfile
    import torch
    from mxnet_tpu_torch.ops import attention as A
    from mxnet_tpu_torch.parallel import ring_attention, sp, \
        ulysses_attention
    _free_card()
    n = RING["sp"]
    s = n * RING["seq_per_replica"]
    mesh = _replica_mesh("sp", n)
    ring = lambda a, b, c: ring_attention(a, b, c, mesh, causal=True)
    flash = lambda a, b, c: ring_attention(a, b, c, mesh, causal=True,
                                           impl="flash")
    uly = lambda a, b, c: ulysses_attention(a, b, c, mesh, causal=True)
    whole = lambda a, b, c: A.flash_attention(a, b, c, causal=True)
    res = {"model": dict(RING, seq=s, causal=True,
                         mesh="build_mesh({'sp': %d}, [%s:0] * %d)"
                         % (n, DEV, n)),
           "step": "examples/long_context_lm.py (MSE, SGD lr %g), %d steps"
           % (RING_LR, RING_STEPS)}
    launches = {}
    ok = True
    for dname in ("f32", "bf16"):
        dt = {"f32": torch.float32, "bf16": torch.bfloat16}[dname]
        tol = RING_TOL[dname]
        q, k, v, target = _ring_inputs(dt, s, SEED + 11)
        r, c = _attn_path("ring", ring, whole, q, k, v, target, tol, n * n)
        _add_counts(launches, c)
        u, c = _attn_path("ulysses", uly, whole, q, k, v, target, tol, n)
        _add_counts(launches, c)
        # the controls: each must miss the tolerance
        _, o_w, g_w = _attn_step(whole, q, k, v, target)
        real, merge, last = A.flash_attention_with_lse, sp._merge, {}

        def keep_lse(*a, **kw):
            o, last["lse"] = real(*a, **kw)
            return o, last["lse"]
        # every block merged with its own lse: the -inf mask undone
        A.flash_attention_with_lse = keep_lse
        sp._merge = lambda o, lse, o_i, lse_i: merge(o, lse, o_i,
                                                     last["lse"])
        try:
            unmasked = flash(q, k, v)
        finally:
            A.flash_attention_with_lse, sp._merge = real, merge
        ctrl_unmasked = _nerr(unmasked, o_w)

        def no_glse(*a, **kw):
            o, lse = real(*a, **kw)
            return o, lse.detach()
        A.flash_attention_with_lse = no_glse
        try:
            _, _, g_d = _attn_step(flash, q, k, v, target)
        finally:
            A.flash_attention_with_lse = real
        ctrl_glse = max(_nerr(a, b) for a, b in zip(g_d, g_w))
        del unmasked, g_d, o_w, g_w, last
        # the dense ring body at a short sequence
        sq, sk, sv, st = _ring_inputs(dt, n * RING_SMALL_SEQ, SEED + 12)
        dense = lambda a, b, c: ring_attention(a, b, c, mesh, causal=True,
                                               impl="dense")
        _, o_f, g_f = _attn_step(flash, sq, sk, sv, st)
        _, o_d, g_d = _attn_step(dense, sq, sk, sv, st)
        vs_dense = {"out": _nerr(o_f, o_d)}
        vs_dense.update({"d" + nm: _nerr(a, b)
                         for nm, a, b in zip("qkv", g_f, g_d)})
        costs = {"ring": _attn_costs(ring, q, k, v, target),
                 "ulysses": _attn_costs(uly, q, k, v, target),
                 "whole": _attn_costs(whole, q, k, v, target)}
        res[dname] = {"ring": r, "ulysses": u,
                      "control_unmasked_err": ctrl_unmasked,
                      "control_no_glse_err": ctrl_glse,
                      "vs_dense_body": vs_dense, "costs": costs}
        ok = ok and r["ok"] and u["ok"] and ctrl_unmasked > tol \
            and (ctrl_glse > tol or dname not in RING_GLSE_GATED) \
            and max(vs_dense.values()) <= tol
        del q, k, v, target, sq, sk, sv, st
        _free_card()
    if DEV == "cuda":
        q, k, v, target = _ring_inputs(torch.float32, s, SEED + 11)
        with tempfile.TemporaryDirectory() as td:
            lane = _lane_window(td, lambda: _attn_step(ring, q, k, v,
                                                       target))
        lane["want_each"] = n * n
        res["kernel_lane"] = lane
        ok = ok and lane["equal"] and all(
            lane["launches"][f] == n * n for f in _FLASH)
        del q, k, v, target
    res["launches"] = launches
    res["ok"] = bool(ok)
    RECORD["ring_attention"] = res
    _free_card()
    if not res["ok"]:
        raise AssertionError("ring_attention failed: %s"
                             % json.dumps(res, default=str)[:4000])
    return res


def _zero_lm_symbol(mx, init):
    """gluon_fused_lm's LM at ZERO_LM_LAYERS layers and
    SoftmaxCrossEntropyLoss traced into one Symbol, as fused_fit traces
    them."""
    net = _glm_net(mx, init, ZERO_LM_LAYERS)
    out = net(mx.sym.Variable("data"))
    loss = mx.gluon.loss.SoftmaxCrossEntropyLoss()(
        out, mx.sym.Variable("fused_label"))
    del net
    _free_card()
    return loss


def _zero_trainer(mx, sym, mesh, stage, compress="none"):
    from mxnet_tpu_torch.parallel import DataParallelTrainer
    return DataParallelTrainer(
        sym, mesh, data_names=("data",), label_names=("fused_label",),
        optimizer="adam", learning_rate=TRAIN_LR,
        rescale_grad=1.0 / TRAIN_BATCH, zero_stage=stage,
        grad_compress=compress)


def _zero_arm(mx, sym, init, mesh, stage, compress, x, y,
              feedback=True):
    """One arm: ZERO_STEPS steps from ``init`` (the main path), the
    launches counted over all but the first (dp's step over replicas of
    one card is a CUDA graph: its first step captures).
    ``feedback=False`` zeroes the error-feedback residual after every
    step: a control whose residual is never added back. Returns (record,
    trainer, state)."""
    import torch
    from mxnet_tpu_torch.parallel import zero
    tr = _zero_trainer(mx, sym, mesh, stage, compress)
    state = tr.init_state({"data": tuple(x.shape),
                           "fused_label": tuple(y.shape)},
                          arg_params={n: init[n] for n in tr.param_names})
    inputs = tr.shard_inputs([x, y])
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    c0 = zero.counters()

    losses, step_s = [], []

    def run(n):
        nonlocal state
        for _ in range(n):
            t0 = time.perf_counter()
            p, s, a, loss, _ = tr.step(*state, inputs)
            state = (p, s, a)
            losses.append(float(loss) / TRAIN_BATCH)
            step_s.append(time.perf_counter() - t0)
            if not feedback:
                for rs in tr._resid:
                    for r in rs:
                        r.zero_()

    run(1)
    _, counts = _counted(lambda: run(ZERO_STEPS - 1))
    c1 = zero.counters()
    rec = {"stage": stage, "compress": compress, "losses": losses,
           "step_s": step_s,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9
           if DEV == "cuda" else None,
           "launches": counts, "captures": tr.captures,
           "flash_launches_per_step": {f: counts[f] / (ZERO_STEPS - 1)
                                       for f in _FLASH},
           "finite": bool(all(math.isfinite(v) for v in losses))}
    if stage:
        L = tr.layout
        rec.update(buckets=L.n_buckets, padded_floats=sum(L.padded),
                   wire_bytes_per_step=tr.wire_bytes_per_step(),
                   counter_wire_bytes=c1["zero_wire_bytes"]
                   - c0["zero_wire_bytes"],
                   wire_source="analytic")
        rec["wire_ok"] = rec["counter_wire_bytes"] == \
            ZERO_STEPS * rec["wire_bytes_per_step"]
    return rec, tr, state


def _named_clone(tr, params):
    return {n: t.detach().clone()
            for n, t in tr.device_params(params).items()}


def _params_cmp(got, ref):
    """(bit-identical, the largest norm-wise error) over the parameters."""
    import torch
    bitwise = all(torch.equal(got[n], ref[n]) for n in ref)
    return bitwise, max(_nerr(got[n], ref[n]) for n in ref)


def phase_zero_lm():
    """ZeRO on the card: gluon_fused_lm's LM (GPT-2 medium's widths,
    ZERO_LM_LAYERS layers, 8 x 1024 tokens, Adam) as its loss Symbol
    through DataParallelTrainer over 4 replicas of the card, 3 steps an
    arm from the same parameters: dp over the same mesh, ZeRO-1, ZeRO-2
    and ZeRO-2 + fp8, and the fp8 arm again with its residual never
    added back (a control). ZeRO-1 against dp, ZeRO-2 against ZeRO-1,
    fp8's losses against float32's and against the control's; 4 x
    ZERO_LM_LAYERS launches a step of each flash kernel; the counters' wire bytes;
    s a step and peak memory an arm; a ZeRO-2 commit restored into dp
    giving ZeRO-2's next step; then fused_fit under MXNET_ZERO_STAGE=2 on
    [gpu(0)] writing back the trainer's parameters."""
    import shutil
    import tempfile
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.checkpoint import CheckpointManager, TrainingState
    from mxnet_tpu_torch.parallel import ZeroTrainer
    _free_card()
    init = _GLM_REF.get("init")
    if init is None:
        init = _glm_init(mx)[0]
    x, y = _lm_batch()
    sym = _zero_lm_symbol(mx, init)
    mesh = _replica_mesh("data", ZERO_REPLICAS)
    res = {"model": dict(TRAIN, num_layers=ZERO_LM_LAYERS),
           "batch": TRAIN_BATCH,
           "replicas": ZERO_REPLICAS, "per_replica_batch":
           TRAIN_BATCH // ZERO_REPLICAS, "steps": ZERO_STEPS,
           "optimizer": "adam", "tol": ZERO_TOL,
           "mesh": "build_mesh({'data': %d}, [%s:0] * %d)"
           % (ZERO_REPLICAS, DEV, ZERO_REPLICAS)}
    launches = {}
    want = ZERO_LM_LAYERS * ZERO_REPLICAS

    dp, tr, st = _zero_arm(mx, sym, init, mesh, 0, "none", x, y)
    _add_counts(launches, dp["launches"])
    ref = _named_clone(tr, st[0])
    del tr, st
    _free_card()
    z1, tr, st = _zero_arm(mx, sym, init, mesh, 1, "none", x, y)
    _add_counts(launches, z1["launches"])
    got1 = _named_clone(tr, st[0])
    z1["bitwise_vs_dp"], z1["err_vs_dp"] = _params_cmp(got1, ref)
    del tr, st, ref
    _free_card()
    z2, tr2, st2 = _zero_arm(mx, sym, init, mesh, 2, "none", x, y)
    _add_counts(launches, z2["launches"])
    z2["bitwise_vs_zero1"], z2["err_vs_zero1"] = _params_cmp(
        _named_clone(tr2, st2[0]), got1)
    del got1
    _free_card()
    # a ZeRO-2 commit restored into plain dp: the next step equals
    # ZeRO-2's own
    tmp = tempfile.mkdtemp(prefix="zero_lm_")
    try:
        arrays, meta = tr2.export_training_state(*st2)
        mgr = CheckpointManager(tmp, async_save=False)
        mgr.save(TrainingState(arrays=arrays, meta={
            "kind": "zero_lm", "step": ZERO_STEPS, "trainer": meta}),
            step=ZERO_STEPS)
        mgr.close()
        del arrays
        restored = CheckpointManager(tmp).restore()
        trd = _zero_trainer(mx, sym, mesh, 0)
        trd.init_state({"data": tuple(x.shape),
                        "fused_label": tuple(y.shape)},
                       arg_params={n: init[n] for n in trd.param_names})
        std = trd.import_training_state(restored.arrays,
                                        restored.meta["trainer"])
        del restored
        std = trd.step(*std, trd.shard_inputs([x, y]))[:3]
        st2 = tr2.step(*st2, tr2.shard_inputs([x, y]))[:3]
        bitwise, err = _params_cmp(_named_clone(trd, std[0]),
                                   _named_clone(tr2, st2[0]))
        res["restore_into_dp"] = {"bitwise": bitwise, "err": err,
                                  "ownership_entries":
                                  len(meta["zero"]["ownership"])}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del tr2, st2, trd, std
    _free_card()
    z8, tr, st = _zero_arm(mx, sym, init, mesh, 2, "fp8", x, y)
    _add_counts(launches, z8["launches"])
    z8["residual_abs_sum"] = float(sum(float(r.abs().sum())
                                       for rs in tr._resid for r in rs))
    z8["loss_rel_err_vs_fp32_each"] = [abs(a - b) / abs(b) for a, b in
                                       zip(z8["losses"], z2["losses"])]
    z8["loss_rel_err_after_one_update"] = z8["loss_rel_err_vs_fp32_each"][1]
    del tr, st
    _free_card()
    # the control: the same fp8 arm with the residual never added back
    # must leave it at the third loss (the first step after a residual)
    nofb, tr, st = _zero_arm(mx, sym, init, mesh, 2, "fp8", x, y,
                             feedback=False)
    _add_counts(launches, nofb["launches"])
    nofb["loss_rel_err_vs_fp32_each"] = [
        abs(a - b) / abs(b) for a, b in zip(nofb["losses"], z2["losses"])]
    nofb["loss_rel_diff_vs_fp8_each"] = [
        abs(a - b) / abs(b) for a, b in zip(nofb["losses"], z8["losses"])]
    z8["feedback_ok"] = nofb["losses"][:2] == z8["losses"][:2] \
        and nofb["losses"][2] != z8["losses"][2]
    del tr, st
    _free_card()
    res.update(dp=dp, zero1=z1, zero2=z2, zero2_fp8=z8,
               control_fp8_no_feedback=nofb)
    flash_ok = all(a["flash_launches_per_step"][f] == want
                   for a in (dp, z1, z2, z8, nofb) for f in _FLASH) \
        if DEV == "cuda" else True
    res["flash_launches_want_per_step"] = want

    # fused_fit under MXNET_ZERO_STAGE=2 on [gpu(0)]
    net = _glm_net(mx, init, ZERO_LM_LAYERS)
    with _env(MXNET_ZERO_STAGE="2"), _watch_step_k() as calls:
        fit_losses = _gluon_fit(mx, net, [(mx.nd.NDArray(x),
                                           mx.nd.NDArray(y))]
                                * ZERO_FIT_STEPS, 1, ZERO_FIT_STEPS,
                                optimizer="adam",
                                optimizer_params={"learning_rate":
                                                  TRAIN_LR})
    ftr = calls[0]["trainer"]
    own = ftr.host_params(ftr._params)
    written = _host_params(net)
    fit_ok = isinstance(ftr, ZeroTrainer) and all(
        torch.equal(written[n], torch.from_numpy(own[n]))
        for n in ftr.param_names)
    res["fused_fit_zero2"] = {"trainer": type(ftr).__name__,
                              "stage": getattr(ftr, "_zero_stage", None),
                              "epoch_losses": fit_losses,
                              "written_back_equal": fit_ok}
    del net, calls, ftr, own, written
    res["launches"] = launches
    res["ok"] = bool(
        all(a["finite"] for a in (dp, z1, z2, z8, nofb))
        and (z1["bitwise_vs_dp"] or z1["err_vs_dp"] <= ZERO_TOL)
        and z2["err_vs_zero1"] <= ZERO_TOL
        and z8["losses"][-1] < z8["losses"][0]
        and z8["loss_rel_err_after_one_update"] <= ZERO_FP8_LOSS_RTOL
        and z8["residual_abs_sum"] > 0 and z8["feedback_ok"]
        and all(a["wire_ok"] for a in (z1, z2, z8)) and flash_ok
        and res["restore_into_dp"]["err"] <= ZERO_TOL and fit_ok)
    RECORD["zero_lm"] = res
    _free_card()
    if not res["ok"]:
        raise AssertionError("zero_lm failed: %s"
                             % json.dumps(res, default=str)[:4000])
    return res


def _tp_case(fn, ref, arrs, cpu_fn, cpu_arrs):
    """``fn`` on the card against ``ref`` on the card in float32 (output
    and the gradients of its squared mean with respect to every input),
    and on ``cpu_arrs`` in float64, card and host each against ``ref`` in
    float64 on the host, within TP_F64_TOL. The host check is float64:
    ReLU's kinks make a deep stack's input gradient ill-conditioned in
    float32 (a pre-activation within rounding of 0 flips its mask), and
    which elements flip depends on each device's rounding (pipeline_mlp's
    input gradient at these shapes: 4.1e-4 off float64 on an H100, 5.6e-7
    and 8.2e-4 on two x86 hosts)."""
    import torch

    def vg(f, xs):
        ts = [t.detach().requires_grad_(True) for t in xs]
        out = f(*ts)
        grads = torch.autograd.grad((out ** 2).mean(), ts)
        return [out.detach()] + [gr.detach() for gr in grads]

    def worst(got, want):
        return max(_nerr(a.cpu(), b) for a, b in zip(got, want))

    t0 = time.perf_counter()
    got = vg(fn, arrs)
    _sync()
    wall = time.perf_counter() - t0
    vs_ref = worst(got, vg(ref, arrs))
    del got
    f64 = [t.double() for t in cpu_arrs]
    card = vg(fn, [t.to(DEV) for t in f64])
    host = vg(cpu_fn, f64)
    want = vg(ref, f64)
    card_err, host_err = worst(card, want), worst(host, want)
    return {"vs_reference": vs_ref, "card_f64_vs_ref_f64": card_err,
            "cpu_f64_vs_ref_f64": host_err, "fwd_bwd_wall_s": wall,
            "ok": bool(vs_ref <= TP_TOL and card_err <= TP_F64_TOL
                       and host_err <= TP_F64_TOL)}


def phase_tp_pp():
    """Tensor, expert and pipeline parallelism over 4 replicas of the
    card, f32: megatron_mlp at GPT-2 medium's MLP, moe_ffn with 8
    experts over ep 4, pipeline_mlp with 4 stages and 8 microbatches,
    each (output and gradients) against its reference on the card and
    against the same function over 4 host replicas. No kernel."""
    import torch
    from mxnet_tpu_torch.parallel import megatron_mlp, moe_ffn, \
        pipeline_mlp, tp, pp
    _free_card()
    g = torch.Generator().manual_seed(SEED + 21)
    rnd = lambda *s, scale=1.0: torch.randn(*s, generator=g) * scale
    res = {"dtype": "float32", "tol": TP_TOL, "cpu_rows": TP_CPU_ROWS}
    n = TP["n"]
    host = lambda xs: [t.clone() for t in xs]
    card = lambda xs: [t.to(DEV) for t in xs]

    d, h = TP["d"], TP["hidden"]
    arrs = [rnd(TP["tokens"], d), rnd(d, h, scale=d ** -0.5),
            rnd(h, scale=0.1), rnd(h, d, scale=h ** -0.5),
            rnd(d, scale=0.1)]
    tmesh, cmesh = _replica_mesh("tp", n), _replica_mesh("tp", n, "cpu")
    cpu_arrs = host([arrs[0][:TP_CPU_ROWS]] + arrs[1:])
    res["megatron_mlp"] = _tp_case(
        lambda *a: megatron_mlp(*a, tmesh),
        lambda x, w1, b1, w2, b2: torch.relu(x @ w1 + b1) @ w2 + b2,
        card(arrs), lambda *a: megatron_mlp(*a, cmesh), cpu_arrs)
    res["megatron_mlp"]["config"] = dict(TP)

    d, h, e = MOE["d"], MOE["hidden"], MOE["experts"]
    arrs = [rnd(MOE["tokens"], d), rnd(d, e, scale=d ** -0.5),
            rnd(e, d, h, scale=d ** -0.5), rnd(e, h, d, scale=h ** -0.5)]
    # top-1 routing on the host's and the card's float32 logits: the
    # tokens whose two best experts lie within 1e-3 would route by
    # rounding, so the CPU check takes the first TP_CPU_ROWS of the others
    logits = (arrs[0].double() @ arrs[1].double())
    top2 = logits.topk(2, dim=1).values
    clear = (top2[:, 0] - top2[:, 1]) > 1e-3
    rows = arrs[0][clear][:TP_CPU_ROWS]
    emesh, cemesh = _replica_mesh("ep", n), _replica_mesh("ep", n, "cpu")
    res["moe_ffn"] = _tp_case(
        lambda *a: moe_ffn(*a, emesh), tp.moe_ffn_reference,
        card(arrs), lambda *a: moe_ffn(*a, cemesh),
        host([rows] + arrs[1:]))
    res["moe_ffn"].update(config=dict(MOE),
                          routing_ties_left_out=int((~clear).sum()))
    # the card's slice must be the same rows as the host's
    res["moe_ffn"]["cpu_rows_note"] = "first %d tokens with a clear top-1" \
        % TP_CPU_ROWS

    m, rows_, d = PIPE["micro"], PIPE["rows"], PIPE["d"]
    arrs = [rnd(m, rows_, d), rnd(PIPE["stages"], d, d, scale=d ** -0.5),
            rnd(PIPE["stages"], d, scale=0.1)]
    pmesh, cpmesh = _replica_mesh("pp", n), _replica_mesh("pp", n, "cpu")
    res["pipeline_mlp"] = _tp_case(
        lambda *a: pipeline_mlp(*a, pmesh),
        pp.pipeline_reference, card(arrs),
        lambda *a: pipeline_mlp(*a, cpmesh), host(arrs))
    res["pipeline_mlp"].update(config=dict(PIPE),
                               ticks=m + PIPE["stages"] - 1)
    res["launches"] = {}
    res["ok"] = bool(all(res[k]["ok"] for k in
                         ("megatron_mlp", "moe_ffn", "pipeline_mlp")))
    RECORD["tp_pp"] = res
    _free_card()
    if not res["ok"]:
        raise AssertionError("tp_pp failed: %s"
                             % json.dumps(res, default=str)[:4000])
    return res

# -- planner: the sharding planner on the LM over 4 replicas of the card -------

PLAN_REPLICAS = 4
PLAN_STEPS = 3                  # a step of capture / warm-up, then 2 timed
PLAN_ARMS = ("dp", "dp2.tp2", "dp2.tp2+zero2")
PLAN_LOSS_RTOL = 1e-4
PLAN_BUDGET = 1 << 30           # 1 GiB: under every candidate's lower bound
PLAN_WANT = ("dp", "zero1", "zero2", "dp2.tp2", "dp2.tp2+zero2", "pp4")


def _plan_resident(tr, params, states):
    """Parameter and optimizer-state bytes one replica holds: dp's whole
    tensors; a tensor-parallel parameter's one shard; ZeRO's one shard
    of every bucket."""
    from mxnet_tpu_torch.parallel import ZeroTrainer
    nbytes = lambda t: t.numel() * t.element_size()
    if isinstance(tr, ZeroTrainer):
        return sum(nbytes(b[0]) for b in params) + sum(
            nbytes(st[0]) for b in states for st in b)
    one = lambda p: nbytes(p[0]) if isinstance(p, tuple) else nbytes(p)
    return sum(one(p) for p in params) + sum(one(s) for st in states
                                             for s in st)


def _plan_arm(mx, planner, sym, shapes, kw, devices, init, x, y, plan,
              directory):
    """PLAN_STEPS steps of one plan from ``init``: the first outside the
    counted window (a graph capture, or a warm-up step), the rest in a
    kernel-lane window. Returns the arm's record."""
    import torch
    tr = planner.make_trainer(sym, shapes, plan=plan, devices=devices,
                              apply_knobs=False, **kw)
    state = tr.init_state(shapes, arg_params={n: init[n]
                                              for n in tr.param_names})
    inputs = tr.shard_inputs([x, y])
    model = planner.ModelSpec(sym, shapes, **kw)
    resident = _plan_resident(tr, state[0], state[1])
    est = planner.estimate_hbm_bytes(model, tr._sharding_plan)
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    losses, step_s = [], []

    def one():
        nonlocal state
        t0 = time.perf_counter()
        p, st, a, loss, _ = tr.step(*state, inputs)
        state = (p, st, a)
        losses.append(float(loss) / TRAIN_BATCH)
        step_s.append(time.perf_counter() - t0)

    one()
    lane = _lane_window(directory, lambda: [one() for _ in
                                            range(PLAN_STEPS - 1)])
    counted = PLAN_STEPS - 1
    costs = tr._step_costs(shapes)
    timed = step_s[1:]
    mean_s = sum(timed) / len(timed)
    flops_all = costs["flops"] * PLAN_REPLICAS
    rec = {"plan": plan, "trainer": type(tr).__name__,
           "losses": losses, "step_s_each": step_s, "step_s": mean_s,
           "flash_launches_per_step": {f: lane["launches"][f] / counted
                                       for f in _FLASH},
           "lane": lane, "launches": lane["launches"],
           "resident_param_state_bytes": resident,
           "estimate_hbm_bytes": est,
           "resident_within_estimate": bool(resident <= est),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9
           if DEV == "cuda" else None,
           "flops_per_replica_step": costs["flops"],
           "flops_step_all_replicas": flops_all,
           "flop_share_of_f32_peak": flops_all / mean_s / PEAK_F32_FLOPS,
           "captures": tr.captures,
           "finite": bool(all(math.isfinite(v) for v in losses))}
    del tr, state, inputs
    _free_card()
    return rec


def _planner_cli(flag):
    """``python -m mxnet_tpu_torch.parallel.planner <flag> --devices 4``
    on the card: its exit code and last JSON line."""
    import mxnet_tpu_torch
    root = os.path.dirname(os.path.dirname(
        os.path.abspath(mxnet_tpu_torch.__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    args = [sys.executable, "-m", "mxnet_tpu_torch.parallel.planner", flag,
            "--devices", str(PLAN_REPLICAS)]
    if DEV != "cuda":
        args += ["--ctx", "cpu"]
    t0 = time.perf_counter()
    r = subprocess.run(args, env=env, capture_output=True, text=True,
                       timeout=600)
    out = {"exit_code": r.returncode, "seconds": time.perf_counter() - t0}
    try:
        out["result"] = json.loads(r.stdout.strip().splitlines()[-1])
    except (IndexError, ValueError):
        out["stderr"] = r.stderr[-2000:]
    return out


def phase_planner():
    """The sharding planner (parallel.planner) on the card: zero_lm's LM
    loss Symbol (GPT-2 medium's widths, ZERO_LM_LAYERS layers, 8 x 1024
    tokens, Adam, f32)
    over 4 replicas of the card. plan_auto's table printed (every
    candidate's FLOPs, bytes, wire, peak, cost and status), twice in the
    same order; a 1 GiB budget rejecting every candidate with no trainer
    built; dp, dp2.tp2 and dp2.tp2+zero2 trained 3 steps each from one
    seed: losses within PLAN_LOSS_RTOL of dp's at every step, 96 launches
    of each flash kernel a step (the kernel lane equal to the counters),
    per-replica resident bytes within estimate_hbm_bytes, s a step, the
    cost source's FLOPs and their share of the f32 peak; the predicted
    order beside the measured one (one card stands for four, so the wire
    is analytic: not gated); the CLI's --selftest (must pass) and
    --bench."""
    import tempfile
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.parallel import planner
    _free_card()
    init = _GLM_REF.get("init")
    if init is None:
        init = _glm_init(mx)[0]
    x, y = _lm_batch()
    sym = _zero_lm_symbol(mx, init)
    shapes = {"data": tuple(x.shape), "fused_label": tuple(y.shape)}
    kw = dict(data_names=("data",), label_names=("fused_label",),
              optimizer="adam", learning_rate=TRAIN_LR,
              rescale_grad=1.0 / TRAIN_BATCH)
    model = planner.ModelSpec(sym, shapes, **kw)
    dev = torch.device("cuda", 0) if DEV == "cuda" else torch.device("cpu")
    devices = [dev] * PLAN_REPLICAS
    res = {"model": dict(TRAIN, num_layers=ZERO_LM_LAYERS),
           "batch": TRAIN_BATCH,
           "replicas": PLAN_REPLICAS, "steps": PLAN_STEPS,
           "optimizer": "adam", "loss_rtol": PLAN_LOSS_RTOL,
           "wire_gbps": planner.resolve_wire_bw() / 1e9,
           "mesh": "build_mesh(plan.axes, [%s] * %d)" % (dev, PLAN_REPLICAS)}
    # 1. the table, twice
    built0 = planner._BUILT[0]
    t0 = time.perf_counter()
    r1 = planner.plan_auto(model, devices=devices)
    res["plan_auto_s"] = time.perf_counter() - t0
    r2 = planner.plan_auto(model, devices=devices)
    rows = []
    for e in r1.entries:
        name = e["plan"].name if e.get("plan") else e["name"]
        row = {"name": name, "status": e["status"]}
        for k in ("flops", "bytes", "wire_bytes", "wire_bytes_estimate",
                  "peak_bytes", "cost_s", "reason"):
            if k in e:
                row[k] = e[k]
        rows.append(row)
        print("plan %-14s %-11s %s" % (name, e["status"], json.dumps(
            {k: v for k, v in row.items() if k not in ("name", "status")},
            default=str)), flush=True)
    order = lambda r: [(e["plan"].name, e["cost_s"]) for e in r.entries
                       if "cost_s" in e]
    res["table"] = rows
    res["chosen"] = r1.chosen.name
    res["deterministic"] = bool(r1.chosen.name == r2.chosen.name
                                and order(r1) == order(r2))
    res["candidates_ok"] = bool(
        [r["name"] for r in rows] == list(PLAN_WANT)
        and rows[-1]["status"] == "unsupported"
        and all(r["status"] in ("scored", "selected") for r in rows[:-1]))
    res["built_while_planning"] = planner._BUILT[0] - built0
    # 2. a budget under every lower bound: nothing priced, nothing built
    lower = {p.name: planner.estimate_hbm_bytes(model, p)
             for p, _ in planner.enumerate_candidates(model, PLAN_REPLICAS)
             if p is not None}
    built0 = planner._BUILT[0]
    try:
        planner.plan_auto(model, devices=devices, budget=PLAN_BUDGET)
        pruned = {"raised": False}
    except mx.MXNetError as e:
        rep = e.report
        pruned = {"raised": True, "priced": rep.compiled,
                  "built": rep.built, "statuses": sorted(
                      {x["status"] for x in rep.entries})}
    pruned["trainers_built"] = planner._BUILT[0] - built0
    pruned["budget"] = PLAN_BUDGET
    pruned["lower_bounds"] = lower
    pruned["ok"] = bool(pruned["raised"] and pruned["priced"] == 0
                        and pruned["built"] == 0
                        and pruned["trainers_built"] == 0
                        and min(lower.values()) > PLAN_BUDGET)
    res["pruning"] = pruned
    # 3. the arms
    arms = {}
    with tempfile.TemporaryDirectory(prefix="planner_lane_") as d:
        for plan in PLAN_ARMS:
            arms[plan] = _plan_arm(mx, planner, sym, shapes, kw, devices,
                                   init, x, y, plan, os.path.join(d, plan))
    ref = arms["dp"]["losses"]
    want = ZERO_LM_LAYERS * PLAN_REPLICAS
    for a in arms.values():
        a["loss_rel_err_vs_dp"] = [abs(g - r) / abs(r)
                                   for g, r in zip(a["losses"], ref)]
        a["losses_ok"] = bool(a["finite"] and max(
            a["loss_rel_err_vs_dp"]) <= PLAN_LOSS_RTOL)
        a["launches_ok"] = bool(
            DEV != "cuda" or (all(v == want for v in
                                  a["flash_launches_per_step"].values())
                              and a["lane"]["equal"]))
    res["arms"] = arms
    res["flash_launches_want_per_step"] = want
    launches = {}
    for a in arms.values():
        _add_counts(launches, a["launches"])
    res["launches"] = launches
    measured = sorted(arms, key=lambda k: (arms[k]["step_s"], k))
    predicted = sorted(PLAN_ARMS, key=lambda k: (
        next(e["cost_s"] for e in r1.entries
             if e.get("plan") is not None and e["plan"].name == k), k))
    res["predicted_order"] = predicted
    res["measured_order"] = measured
    print("planner order: predicted %s, measured %s" % (predicted,
                                                        measured),
          flush=True)
    # 4. the CLI
    res["selftest"] = _planner_cli("--selftest")
    res["bench"] = _planner_cli("--bench")
    res["ok"] = bool(
        res["deterministic"] and res["candidates_ok"]
        and res["built_while_planning"] == 0 and pruned["ok"]
        and all(a["losses_ok"] and a["launches_ok"]
                and a["resident_within_estimate"] for a in arms.values())
        and res["selftest"]["exit_code"] == 0
        and res["selftest"].get("result", {}).get("ok")
        and res["bench"]["exit_code"] == 0)
    RECORD["planner"] = res
    _free_card()
    if not res["ok"]:
        raise AssertionError("planner failed: %s"
                             % json.dumps(res, default=str)[:4000])
    return res


# -- group2ctx: LeNet's FC head on the host ------------------------------------

G2C_BATCH = 64
G2C_N = 1024
G2C_EPOCHS = 2


def _g2c_lenet(mx):
    """examples/train_mnist.py's LeNet with its convolutions in group
    "convs" and its FC head (and the loss) in group "head"."""
    with mx.NameManager():
        data = mx.sym.Variable("data")
        with mx.AttrScope(ctx_group="convs"):
            net = mx.sym.Convolution(data, kernel=(5, 5), num_filter=20,
                                     name="c1")
            net = mx.sym.Activation(net, act_type="tanh")
            net = mx.sym.Pooling(net, pool_type="max", kernel=(2, 2),
                                 stride=(2, 2))
            net = mx.sym.Convolution(net, kernel=(5, 5), num_filter=50,
                                     name="c2")
            net = mx.sym.Activation(net, act_type="tanh")
            net = mx.sym.Pooling(net, pool_type="max", kernel=(2, 2),
                                 stride=(2, 2))
        with mx.AttrScope(ctx_group="head"):
            net = mx.sym.FullyConnected(mx.sym.Flatten(net), num_hidden=500,
                                        name="f1")
            net = mx.sym.Activation(net, act_type="tanh")
            net = mx.sym.FullyConnected(net, num_hidden=10, name="f2")
            return mx.sym.SoftmaxOutput(net, name="softmax")


def _g2c_module(mx, head_ctx, params, train):
    mod = mx.mod.Module(_g2c_lenet(mx), context=_ctx(),
                        group2ctxs={"convs": _ctx(), "head": head_ctx})
    mod.bind(data_shapes=train.provide_data,
             label_shapes=train.provide_label)
    mod.set_params(*params)
    return mod


def phase_group2ctx():
    """group2ctx model parallelism (executor._Placement) on the card:
    LeNet through Module.fit with the convolutions in a group on gpu(0)
    and the FC head on cpu(). Each node's outputs on its group's device
    (a monitor over one forward); card + host against the all-card walk
    from the same parameters on one batch (outputs and gradients within
    MODULE_RTOL); the control with the head on the card makes no
    cross-device copy; ms a step of both fits and the fit's accuracy."""
    import numpy as np
    import mxnet_tpu_torch as mx
    _free_card()
    x, yl = synthetic_mnist(G2C_N, SEED)
    train = mx.io.NDArrayIter(x, yl, G2C_BATCH, label_name="softmax_label")
    with mx.NameManager():
        init = mx.mod.Module(lenet_symbol(mx.sym), context=mx.cpu())
    init.bind(data_shapes=train.provide_data,
              label_shapes=train.provide_label)
    mx.random.seed(SEED)
    init.init_params(mx.init.Xavier())
    params = init.get_params()
    res = {"batch": G2C_BATCH, "groups": {"convs": str(_ctx()),
                                          "head": "cpu(0)"}}
    _reset_counts()
    # 1. placement: every node's output on its group's device
    split = _g2c_module(mx, mx.cpu(), params, train)
    ex = split._exec
    seen = {}
    ex.set_monitor_callback(lambda n, t: seen.setdefault(
        n.rsplit("_output", 1)[0], t._data.device))
    batch = next(iter(train))
    split.forward(batch, is_train=True)
    ex.set_monitor_callback(None)
    placed = {n: str(c.torch_device()) for n, c in ex.placement.items()}
    wrong = {n: (str(seen.get(n)), d) for n, d in placed.items()
             if str(seen.get(n)) != d}
    res["placement"] = placed
    res["segments"] = [(str(c), ns) for c, ns in ex.segments]
    res["placement_ok"] = bool(not wrong and seen and any(
        d == "cpu" for d in placed.values()) and any(
        d.startswith(DEV) for d in placed.values()))
    res["misplaced"] = wrong
    # 2. card + host against the all-card walk, one batch
    whole = _g2c_module(mx, _ctx(), params, train)
    got = {}
    for tag, mod in (("split", split), ("card", whole)):
        c0 = mod._exec.copies
        mod.forward_backward(batch)
        got[tag] = {"output": mod.get_outputs()[0].asnumpy(),
                    **{n: g.asnumpy() for n, g in
                       mod._exec.grad_dict.items() if n in params[0]},
                    "copies": mod._exec.copies - c0}
    err = {k: _rel_err(got["split"][k], got["card"][k])
           for k in got["card"] if k != "copies"}
    res["check"] = {"rtol": MODULE_RTOL, "max_rel_err": max(err.values()),
                    "errors": err}
    res["copies_a_step"] = {"split": got["split"]["copies"],
                            "all_card_control": got["card"]["copies"]}
    # 3. the fits, ms a step
    fits = {}
    for tag, head in (("split", mx.cpu()), ("all_card", _ctx())):
        mod = _g2c_module(mx, head, params, train)
        steps = []
        train.reset()
        _sync()
        last = [time.perf_counter()]

        def tick(_):
            _sync()
            now = time.perf_counter()
            steps.append((now - last[0]) * 1e3)
            last[0] = now
        mod.fit(train, num_epoch=G2C_EPOCHS, optimizer="sgd",
                optimizer_params={"learning_rate": LENET_LR,
                                  "momentum": 0.9,
                                  "rescale_grad": 1.0 / G2C_BATCH},
                batch_end_callback=tick)
        acc = mod.score(train, mx.metric.Accuracy())[0][1]
        fits[tag] = {"ms_a_step": float(np.median(steps[1:])),
                     "steps": len(steps), "train_accuracy": float(acc),
                     "copies": mod._exec.copies}
    res["fits"] = fits
    res["launches"] = _read_counts()
    res["ok"] = bool(res["placement_ok"]
                     and res["check"]["max_rel_err"] <= MODULE_RTOL
                     and res["copies_a_step"]["split"] > 0
                     and res["copies_a_step"]["all_card_control"] == 0
                     and fits["all_card"]["copies"] == 0)
    RECORD["group2ctx"] = res
    _free_card()
    if not res["ok"]:
        raise AssertionError("group2ctx failed: %s"
                             % json.dumps(res, default=str)[:4000])
    return res


# -- the image record pipeline: nvJPEG and the batch-assembly kernel --------
# bench.py's e2e_data lane on the port: a synthetic ImageNet-shaped .rec
# (2560 JPEGs of 256², quality 90, labels 0-999, seed 0, bench.py's
# _build_synth_rec), ImageRecordIter at batch 128 and 224² with random
# crops and mirrors, uint8 batches normalized on the card by the trainer's
# input_preproc, ResNet-50 through DataParallelTrainer in bf16. The
# detection lane: SSD300's batch and size from a .rec of packed boxes.
IMG_REC_N = 2560
IMG_SIZE = 256
IMG_QUALITY = 90
IMG_THREADS = 4              # bench.py's preprocess_threads
IMG_PREFETCH = 3             # bench.py's prefetch_buffer
IMG_WARMUP = 3
IMG_TIMED = 20
IMG_PROFILE_STEPS = 5        # the kernel lane's window of e2e steps
IMG_HELD_STEPS = 12          # e2e steps whose batches are held after
CODEC_MEAN_TOL = 1.5         # mean |nvJPEG - the JAX package's decode|
CODEC_MAX_TOL = 16           # largest: another IDCT and chroma upsampling
ASSEMBLE_F32_ATOL = 1e-5     # the float32 path (the same rounded ops)
CODEC_PSNR_MIN = 30.0        # an encode/decode round trip at quality 95
DET_N = 256
DET_STEPS = 3
DET_MAX_BOXES = 4
DET_MEAN_TOL = 1.5           # card vs host data after the augmenters


def _jpeg_fixture():
    """[(JPEG bytes, the JAX package's decoded BGR pixels)] of
    tests/data/jpeg_fixture.npz (made by tests/test_torch_image.py)."""
    from mxnet_tpu_torch import recordio
    from mxnet_tpu_torch.test_utils import jpeg_fixture
    return [(recordio.unpack(r)[1], pix) for r, pix in jpeg_fixture(
        os.path.join(HERE, "tests", "data", "jpeg_fixture.npz"))]


def _decode(buf, to_rgb=True):
    """nvJPEG on the card (a host tensor under DEV = "cpu")."""
    import torch
    from mxnet_tpu_torch.image import codec
    if DEV == "cuda":
        return codec.decode(buf, torch.device("cuda"), to_rgb=to_rgb)
    return torch.from_numpy(codec.host_imdecode(buf, 1, to_rgb).copy())


def _synth_images(n, size, seed):
    """bench.py's synthetic images, made on the card: an 8x8 base from
    RandomState(seed) resized bicubic to ``size``² (image.imresize), plus
    uniform noise in [-10, 10) from a torch generator of the same seed;
    and labels 0-999."""
    import numpy as np
    import torch
    from mxnet_tpu_torch.image import imresize
    rng = np.random.RandomState(seed)
    dev = torch.device(DEV)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    for i in range(n):
        base = torch.from_numpy(rng.randint(0, 255, (8, 8, 3), np.uint8))
        img = imresize(base.to(dev), size, size, interp=2)._data
        noise = torch.randint(-10, 10, img.shape, generator=g, device=dev,
                              dtype=torch.int16)
        img = (img.to(torch.int16) + noise).clamp_(0, 255).to(torch.uint8)
        yield img, float(rng.randint(0, 1000))


def _write_synth_rec(path, n, size, seed, label_of=None):
    """A .rec of ``n`` JPEGs encoded by the port's pack_img on the card
    (OpenCV on the host under DEV = "cpu"); returns the seconds."""
    import mxnet_tpu_torch as mx
    t0 = time.perf_counter()
    w = mx.recordio.MXRecordIO(path, "w")
    for i, (img, label) in enumerate(_synth_images(n, size, seed)):
        if label_of is not None:
            label = label_of(i)
        w.write(mx.recordio.pack_img(mx.recordio.IRHeader(0, label, i, 0),
                                     img, quality=IMG_QUALITY, ctx=_ctx()))
    w.close()
    _sync()
    return time.perf_counter() - t0


def _assemble_case(raw, plans, offs):
    """The assembly kernel against its plain version at the main shape:
    uint8 (crop, mirror) bit-identical, float32 with mean/std within
    ASSEMBLE_F32_ATOL; device time, the bytes bound, the plain time."""
    import torch
    from mxnet_tpu_torch.image import assemble as A, IMAGENET_DEFAULT_MEAN, \
        IMAGENET_DEFAULT_STD
    hw = (R50_IMG, R50_IMG)
    k = A.assemble(raw, plans, offs, hw)
    p = A.assemble_plain(raw, plans, offs, hw)
    st = dict(mean=IMAGENET_DEFAULT_MEAN, std=IMAGENET_DEFAULT_STD)
    kf = A.assemble(raw, plans, offs, hw, "float32", **st)
    pf = A.assemble_plain(raw, plans, offs, hw, "float32", **st)
    _sync()
    u8_equal = bool(torch.equal(k, p))
    f32_err = float((kf - pf).abs().max())
    case = {"kernel": "image_assemble", "case": "b128_256_to_224_u8",
            "shape": [len(plans), 3, R50_IMG, R50_IMG],
            "u8_bit_identical": u8_equal, "max_abs_err": f32_err,
            "f32_atol": ASSEMBLE_F32_ATOL, "kernel_launches_per_call": 1,
            "library_ms": None,
            "library_note": "no single PyTorch call crops, mirrors and "
                            "packs a batch of differently sized images"}
    if DEV == "cuda":
        desc = A.descriptors(plans, offs, raw.device)
        case["kernel_ms"] = bench_ms(
            lambda: A.assemble(raw, plans, offs, hw, desc=desc), [()], 50)
        case["kernel_ms_f32"] = bench_ms(
            lambda: A.assemble(raw, plans, offs, hw, "float32", desc=desc,
                               **st), [()], 50)
        case["plain_ms"] = bench_ms(
            lambda: A.assemble_plain(raw, plans, offs, hw), [()], 3)
        # each crop's pixels read once, the batch written once
        nbytes = 2 * len(plans) * 3 * R50_IMG * R50_IMG
        case["bound_ms"], case["bound_by"] = bound_ms(nbytes, 0)
        case["bound_ms_f32"] = bound_ms(nbytes // 2 * 5, 0)[0]
        case["bytes"] = nbytes
        case["launches_a_batch"] = 1
    case["ok"] = u8_equal and f32_err <= ASSEMBLE_F32_ATOL
    RECORD.setdefault("kernel_cases", []).append(case)
    return case


def phase_image_codec():
    """nvJPEG and the assembly kernel: the fixture's decode against the
    JAX package's (a control from another entry must fail), an encode
    round trip's PSNR, the batched decode's rate (1 and IMG_THREADS host
    threads), and the assembly kernel against its plain version at the
    main shape (128 images of 256² -> 3 x 224², uint8 with crop and
    mirror), timed beside its bound."""
    import numpy as np
    import torch
    from mxnet_tpu_torch.image import assemble as A, codec
    res = {"mean_tol": CODEC_MEAN_TOL, "max_tol": CODEC_MAX_TOL}
    entries = _jpeg_fixture()
    fx = []
    for i, (buf, pix) in enumerate(entries):
        d = np.abs(_decode(buf, to_rgb=False).cpu().numpy().astype(np.int64)
                   - pix)
        fx.append({"entry": i, "shape": list(pix.shape),
                   "max_abs_diff": int(d.max()),
                   "mean_abs_diff": float(d.mean())})
    res["fixture"] = fx
    ctl = np.abs(_decode(entries[0][0], to_rgb=False).cpu().numpy()
                 .astype(np.int64) - entries[1][1])
    res["control_mean_abs_diff"] = float(ctl.mean())
    img = _decode(entries[2][0], to_rgb=False)
    if DEV == "cuda":
        back = _decode(codec.encode(img, 95, bgr=True), to_rgb=False)
        res["hardware_refused_status"] = codec.hardware_status()
    else:
        back = torch.from_numpy(codec.host_imdecode(codec.host_encode(
            img.numpy(), 95), 1, False).copy())
    mse = float(((back.float() - img.float()) ** 2).mean())
    res["roundtrip_q95_psnr_db"] = 10 * math.log10(255 ** 2 / max(mse, 1e-12))
    # the main shape: 128 JPEGs of 256², bench.py's quality
    bufs = []
    for img, _ in _synth_images(R50_BATCH, IMG_SIZE, SEED):
        bufs.append(codec.encode(img, IMG_QUALITY, bgr=False)
                    if DEV == "cuda" else
                    codec.host_encode(img.numpy()[:, :, ::-1], IMG_QUALITY))
    sizes = [codec.jpeg_size(b)[:2] for b in bufs]
    offs = [int(o) for o in np.concatenate(
        [[0], np.cumsum([h * w * 3 for h, w in sizes])])[:-1]]
    total = offs[-1] + sizes[-1][0] * sizes[-1][1] * 3
    raw = torch.empty(total, dtype=torch.uint8, device=DEV)
    if DEV == "cuda":
        rates = {}
        import concurrent.futures as cf
        for threads in (1, IMG_THREADS):
            pool = cf.ThreadPoolExecutor(threads)
            chunks = [c for c in np.array_split(np.arange(len(bufs)),
                                                threads) if len(c)]

            def run(ids):
                side = torch.cuda.Stream()
                side.wait_stream(torch.cuda.default_stream())  # raw's
                with torch.cuda.stream(side):
                    codec.decode_batch([bufs[i] for i in ids], raw,
                                       [offs[i] for i in ids],
                                       [sizes[i] for i in ids])
            list(pool.map(run, chunks))            # warm: contexts
            t0 = time.perf_counter()
            for _ in range(3):
                list(pool.map(run, chunks))
            rates[threads] = 3 * len(bufs) / (time.perf_counter() - t0)
            pool.shutdown()
        res["decode_img_per_s_by_threads"] = rates
    else:
        for b, o in zip(bufs, offs):
            im = codec.host_imdecode(b, 1, True)
            raw[o:o + im.size] = torch.from_numpy(im.reshape(-1))
    plans = [A.plan_record(A._IR.pack(0, 0.0, i, 0) + b,
                           lambda p: codec.jpeg_size(p)[:2], SEED, 1, i,
                           (3, R50_IMG, R50_IMG), 0, True, True, 1)
             for i, b in enumerate(bufs)]
    res["mirrored"] = sum(p.mirror for p in plans)
    res["assemble"] = _assemble_case(raw, plans, offs)
    res["ok"] = bool(
        all(f["mean_abs_diff"] <= CODEC_MEAN_TOL
            and f["max_abs_diff"] <= CODEC_MAX_TOL for f in fx)
        and res["control_mean_abs_diff"] > CODEC_MEAN_TOL
        and res["roundtrip_q95_psnr_db"] >= CODEC_PSNR_MIN
        and 0 < res["mirrored"] < R50_BATCH
        and res["assemble"]["ok"])
    RECORD["image_codec"] = res
    if not res["ok"]:
        raise AssertionError("image_codec failed: %s"
                             % json.dumps(res, default=str)[:4000])
    return res


def _kernel_busy(path, window):
    """The card's busy ms inside the ``window`` range of a torch.profiler
    chrome trace (the kernel lane): the union of its kernels' intervals
    clipped to the range's span (one time base), the span's ms, and the
    kernels that ran in it."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    w = next(e for e in events if e.get("name") == window
             and e.get("ph") == "X" and e.get("cat") != "gpu_user_annotation")
    lo, hi = float(w["ts"]), float(w["ts"]) + float(w["dur"])
    spans = sorted((max(lo, float(e["ts"])),
                    min(hi, float(e["ts"]) + float(e.get("dur", 0))))
                   for e in events if e.get("cat") == "kernel")
    spans = [(a, b) for a, b in spans if b > a]
    busy, end = 0.0, lo
    for a, b in spans:
        if b <= end:
            continue
        busy += b - max(a, end)
        end = b
    return busy / 1e3, (hi - lo) / 1e3, len(spans)


def phase_image_rec_resnet50():
    """bench.py's e2e_data lane on the port (see the IMG_* constants): the
    .rec built on the card, the pipeline alone (img/s), ResNet-50 trained
    from it through DataParallelTrainer in bf16 (img/s end to end, beside
    dp_resnet50's synthetic-input img/s), a window under the profiler's
    kernel lane (the card's busy share), the batches of IMG_HELD_STEPS
    more steps held against the plain assembly of a fresh decode of their
    own plans (the producer's buffers never share a block with the
    training stream's work in flight), and one batch's draws held against
    the same iterator at ctx=cpu() with the plain version."""
    import tempfile
    import numpy as np
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import profiler
    from mxnet_tpu_torch.image import IMAGENET_DEFAULT_MEAN, \
        IMAGENET_DEFAULT_STD, assemble as A, codec
    _free_card()
    res = {"records": IMG_REC_N, "image": IMG_SIZE, "quality": IMG_QUALITY,
           "batch": R50_BATCH, "crop": R50_IMG, "threads": IMG_THREADS,
           "prefetch": IMG_PREFETCH}
    tmp = tempfile.mkdtemp(prefix="img_rec_")
    rec = os.path.join(tmp, "synth.rec")
    res["build_rec_s"] = _write_synth_rec(rec, IMG_REC_N, IMG_SIZE, SEED)
    res["rec_mb"] = os.path.getsize(rec) / 1e6
    kw = dict(path_imgrec=rec, data_shape=(3, R50_IMG, R50_IMG),
              batch_size=R50_BATCH, shuffle=True, rand_crop=True,
              rand_mirror=True, preprocess_threads=IMG_THREADS,
              prefetch_buffer=IMG_PREFETCH, output_dtype="uint8")
    with mx.NameManager():
        sym = resnet_v1_symbol(mx.sym)
    mean = torch.tensor(IMAGENET_DEFAULT_MEAN, dtype=torch.float32,
                        device=DEV).reshape(1, 3, 1, 1)
    stdinv = 1.0 / torch.tensor(IMAGENET_DEFAULT_STD, dtype=torch.float32,
                                device=DEV).reshape(1, 3, 1, 1)

    def preproc(name, v):
        if name == "data":
            return (v.to(torch.float32) - mean) * stdinv
        return v
    _reset_counts()
    codec.counts.update(decoded=0, batched_calls=0)
    it = mx.image.ImageRecordIter(ctx=_ctx(), **kw)
    res["route"] = type(it).__name__

    def get():
        while True:
            try:
                return it.next()
            except StopIteration:
                it.reset()
    for _ in range(IMG_WARMUP):
        get()
    t0 = time.perf_counter()
    for _ in range(IMG_TIMED):
        get()
    res["pipeline_img_per_s"] = IMG_TIMED * R50_BATCH / (
        time.perf_counter() - t0)
    stages = np.asarray(list(it.stage_seconds)[1:])  # the first: contexts
    res["stage_ms_median"] = dict(zip(("read", "decode", "assemble"),
                                      (np.median(stages, 0) * 1e3).tolist()))
    res["stage_batches"] = len(stages)
    from mxnet_tpu_torch.parallel import DataParallelTrainer, \
        data_parallel_mesh
    mesh = data_parallel_mesh(1) if DEV == "cuda" else \
        data_parallel_mesh(1, [DEV])
    tr = DataParallelTrainer(sym, mesh, optimizer="sgd",
                             learning_rate=R50_LR, momentum=0.9,
                             rescale_grad=1.0 / R50_BATCH, dtype="bfloat16",
                             input_preproc=preproc)
    state = tr.init_state({"data": (R50_BATCH, 3, R50_IMG, R50_IMG),
                           "softmax_label": (R50_BATCH,)})
    losses = []

    def steps(n, held=None):
        nonlocal state
        for _ in range(n):
            b = get()
            if held is not None:
                held.append((b.data[0]._data, it.last_plans))
                # 7s the size of a batch's decoded images, written on an
                # idle card and freed while their sum waits behind a sleep,
                # just as the taken batch frees the producer to decode the
                # next one: it must not take the block (its buffers live on
                # its own stream)
                _sync()
                sevens = torch.full((sevens_n,), 7, dtype=torch.uint8,
                                    device=DEV)
                if DEV == "cuda":
                    torch.cuda._sleep(100_000_000)     # ~50 ms
                sums.append(sevens.sum(dtype=torch.int64))
                del sevens
            y = b.label[0]._data
            p, st, a, _, outs = tr.step(*state, tr.shard_inputs(
                [b.data[0], y]))
            state = (p, st, a)
            # the step's cross-entropy from the softmax rows, on the card
            prob = outs[0].float().gather(1, y.long()[:, None])
            losses.append(-prob.clamp_min(1e-30).log().mean())
    steps(IMG_WARMUP)
    _sync()
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    steps(IMG_TIMED)
    _sync()
    res["e2e_img_per_s"] = IMG_TIMED * R50_BATCH / (time.perf_counter() - t0)
    res["peak_mem_gb"] = (torch.cuda.max_memory_allocated() / 1e9
                          if DEV == "cuda" else 0.0)
    res["captures"] = tr.captures
    res["launches"] = _read_counts()
    res["decoded"] = dict(codec.counts)
    res["cross_entropy"] = [float(v) for v in torch.stack(losses).cpu()]
    res["losses_finite"] = bool(np.isfinite(res["cross_entropy"]).all())
    synth = RECORD.get("dp_resnet50", {}).get("bf16", {})
    res["dp_resnet50_synthetic_img_per_s_step"] = synth.get("img_per_s_step")
    res["dp_resnet50_synthetic_img_per_s_step_k"] = synth.get(
        "img_per_s_step_k")
    # the card's busy share over a window, from the kernel lane
    if DEV == "cuda":
        lane = tempfile.mkdtemp(prefix="img_lane_")
        profiler.set_config(xplane_dir=lane, profile_imperative=False,
                            profile_symbolic=False)
        profiler.set_state("run")
        try:
            _lane_pad()
            with torch.profiler.record_function("image_rec_window"):
                steps(IMG_PROFILE_STEPS)
                _sync()
        finally:
            profiler.set_state("stop")
        busy, span, nk = _kernel_busy(profiler.kernel_profile()[1],
                                      "image_rec_window")
        res["profile"] = {"steps": IMG_PROFILE_STEPS, "window_ms": span,
                          "device_busy_ms": busy, "busy_share": busy / span,
                          "kernel_events": nk}
    held, sums = [], []
    sevens_n = R50_BATCH * IMG_SIZE * IMG_SIZE * 3
    steps(IMG_HELD_STEPS, held)
    _sync()
    unequal = 0
    for data, plans in held:
        offs = [int(o) for o in np.concatenate([[0], np.cumsum(
            [p.sh * p.sw * 3 for p in plans])])]
        if DEV == "cuda":
            raw = torch.empty(offs[-1], dtype=torch.uint8, device=DEV)
            codec.decode_batch([p.payload for p in plans], raw, offs[:-1],
                               [(p.sh, p.sw) for p in plans])
        else:
            raw = torch.cat([_decode(p.payload).reshape(-1) for p in plans])
        ref = A.assemble_plain(raw, plans, offs[:-1], (R50_IMG, R50_IMG))
        unequal += int(not torch.equal(data, ref))
    res["held_while_training"] = {
        "batches": len(held), "unequal_to_a_fresh_decode": unequal,
        "freed_blocks_overwritten": sum(int(v) != 7 * sevens_n
                                        for v in sums)}
    del tr, state, held
    it.close()
    _free_card()
    # one batch's draws: the card route against its ctx=cpu() twin
    twin = {"card": mx.image.ImageRecordIter(ctx=_ctx(), **kw),
            "cpu": mx.image.ImageRecordIter(ctx=mx.cpu(), **kw)}
    got = {k: v.next() for k, v in twin.items()}
    draws = {k: v.last_draws for k, v in twin.items()}
    plans, _ = twin["cpu"].plans(0)
    offs = [int(o) for o in np.concatenate([[0], np.cumsum(
        [p.sh * p.sw * 3 for p in plans])])]
    if DEV == "cuda":       # the card route's own decode of these JPEGs
        raw = torch.empty(offs[-1], dtype=torch.uint8, device=DEV)
        codec.decode_batch([p.payload for p in plans], raw, offs[:-1],
                           [(p.sh, p.sw) for p in plans])
    else:
        raw = torch.cat([_decode(p.payload).reshape(-1) for p in plans])
    ref = A.assemble_plain(raw, plans, offs[:-1], (R50_IMG, R50_IMG))
    card = got["card"].data[0]._data
    host = got["cpu"].data[0]._data
    res["twin"] = {
        "draws_equal": draws["card"] == draws["cpu"],
        "mirrored": sum(d[4] for d in draws["cpu"]),
        "card_equals_plain_of_its_decode": bool(torch.equal(card, ref)),
        "labels_equal": bool(torch.equal(got["card"].label[0]._data.cpu(),
                                          got["cpu"].label[0]._data)),
        "card_vs_host_codec_mean_abs_diff": float(
            (card.cpu().float() - host.float()).abs().mean())}
    for v in twin.values():
        v.close()
    import shutil
    shutil.rmtree(tmp, ignore_errors=True)
    t = res["twin"]
    res["ok"] = bool(
        res["route"] == "_NativeImageRecordIter"
        and res["losses_finite"]
        and res["held_while_training"]["unequal_to_a_fresh_decode"] == 0
        and res["held_while_training"]["freed_blocks_overwritten"] == 0
        and (res["launches"]["image_assemble"] > 0 or DEV != "cuda")
        and t["draws_equal"] and t["card_equals_plain_of_its_decode"]
        and t["labels_equal"] and 0 < t["mirrored"] < R50_BATCH
        and t["card_vs_host_codec_mean_abs_diff"] <= CODEC_MEAN_TOL
        and res["captures"] == (1 if DEV == "cuda" else 0))
    RECORD["image_rec_resnet50"] = res
    if not res["ok"]:
        raise AssertionError("image_rec_resnet50 failed: %s"
                             % json.dumps(res, default=str)[:4000])
    return res


def _det_label(rng):
    """[2, 5, (id, xmin, ymin, xmax, ymax) x 1-4] as ImageDetIter reads
    it, the boxes inside the image and at least 0.1 wide."""
    import numpy as np
    n = int(rng.randint(1, DET_MAX_BOXES + 1))
    lo = rng.uniform(0.0, 0.6, (n, 2))
    hi = np.minimum(lo + rng.uniform(0.1, 0.4, (n, 2)), 1.0)
    cls = rng.randint(0, SSD_CLASSES, (n, 1))
    return np.concatenate([[2.0, 5.0], np.concatenate(
        [cls, lo, hi], 1).ravel()]).astype(np.float32)


def phase_image_det_rec():
    """ImageDetIter on the card from a .rec of DET_N JPEGs of SSD300's
    300² with 1-4 packed boxes each, at SSD300's batch with rand_crop and
    rand_mirror, feeding DET_STEPS training steps of the ssd300 phase's
    Module; its labels after the augmenters held against the same
    iterator at ctx=cpu() for the same seed (exact), its data within
    DET_MEAN_TOL (nvJPEG against the host codec)."""
    import random
    import shutil
    import tempfile
    import numpy as np
    import torch
    import mxnet_tpu_torch as mx
    _free_card()
    res = {"records": DET_N, "image": SSD_IMG, "batch": SSD_BATCH,
           "steps": DET_STEPS}
    tmp = tempfile.mkdtemp(prefix="img_det_")
    rec = os.path.join(tmp, "det.rec")
    rng = np.random.RandomState(SEED + 1)
    labels = [_det_label(rng) for _ in range(DET_N)]
    res["build_rec_s"] = _write_synth_rec(rec, DET_N, SSD_IMG, SEED + 1,
                                          label_of=lambda i: labels[i])
    kw = dict(batch_size=SSD_BATCH, data_shape=(3, SSD_IMG, SSD_IMG),
              path_imgrec=rec, rand_crop=0.5, rand_mirror=True, mean=True,
              std=True)
    random.seed(SEED)
    it = mx.image.ImageDetIter(ctx=_ctx(), **kw)
    it.reshape(label_shape=(SSD_MAX_BOXES, 5))
    with mx.NameManager():
        sym = ssd300_vgg16_symbol(mx.sym, num_classes=SSD_CLASSES,
                                  width_div=SSD_WIDTH_DIV,
                                  nms_topk=SSD_NMS_TOPK)
    dshape = (SSD_BATCH, 3, SSD_IMG, SSD_IMG)
    lshape = (SSD_BATCH, SSD_MAX_BOXES, 5)
    arg_shapes, _, _ = sym.infer_shape(data=dshape, label=lshape)
    params = _ssd_params(dict(zip(sym.list_arguments(), arg_shapes)))
    mod = mx.mod.Module(sym, data_names=("data",), label_names=("label",),
                        context=_ctx())
    mod.bind(data_shapes=[("data", dshape)], label_shapes=[("label", lshape)])
    mod.init_params(arg_params={k: mx.nd.array(v, ctx=mx.cpu())
                                for k, v in params.items()})
    mod.init_optimizer(optimizer="sgd", optimizer_params=dict(SSD_OPT))
    # the iterator's batches first (its draws are ``random``'s, which
    # nothing else may take in between), then the steps from them
    _reset_counts()
    batches, iter_s, losses, step_s = [], [], [], []
    for _ in range(DET_STEPS):
        t0 = time.perf_counter()
        batches.append(it.next())
        _sync()
        iter_s.append(time.perf_counter() - t0)
    for b in batches:
        t0 = time.perf_counter()
        mod.forward(b, is_train=True)
        mod.backward()
        mod.update()
        _sync()
        step_s.append(time.perf_counter() - t0)
        losses.append(_ssd_losses(mod.get_outputs()))
    res.update({"batch_data_device": str(b.data[0]._data.device),
                "launches": _read_counts(),
                "iter_ms": [s * 1e3 for s in iter_s],
                "step_ms": [s * 1e3 for s in step_s], "losses": losses})
    card_batches = [(b.data[0]._data.cpu(), b.label[0]._data.cpu())
                    for b in batches]
    del batches
    del mod
    _free_card()
    random.seed(SEED)
    host = mx.image.ImageDetIter(ctx=mx.cpu(), **kw)
    host.reshape(label_shape=(SSD_MAX_BOXES, 5))
    lab_eq, diffs = [], []
    for d_card, l_card in card_batches:
        hb = host.next()
        lab_eq.append(bool(torch.equal(l_card, hb.label[0]._data)))
        diffs.append(float((d_card - hb.data[0]._data).abs().mean()))
    shutil.rmtree(tmp, ignore_errors=True)
    # the normalized data's mean difference, in 8-bit units (std ~57.6)
    res["labels_equal_cpu"] = lab_eq
    res["data_mean_abs_diff_units"] = [d * float(np.mean(
        [58.395, 57.12, 57.375])) for d in diffs]
    res["boxes_a_batch"] = [int((l_[:, :, 0] >= 0).sum())
                            for _, l_ in card_batches]
    res["ok"] = bool(
        all(lab_eq)
        and all(d <= DET_MEAN_TOL for d in res["data_mean_abs_diff_units"])
        and all(np.isfinite([v for l_ in losses for v in
                             (l_["softmax_ce"], l_["loc_loss"])]))
        and res["batch_data_device"].startswith(DEV))
    RECORD["image_det_rec"] = res
    if not res["ok"]:
        raise AssertionError("image_det_rec failed: %s"
                             % json.dumps(res, default=str)[:4000])
    return res


# -- the R-CNN path: Faster R-CNN VGG16, the other contrib ops, Custom and
# FeedForward --------------------------------------------------------------
# MXNet's example/rcnn end-to-end VGG16 training (py-faster-rcnn's
# faster_rcnn_end2end settings; tools/torch_rcnn.py defines the network,
# the proposal_target Custom op and the anchor assignment once for either
# package): one 600 x 1000 image a step, 21 classes, conv1_* and conv2_*
# fixed, SGD lr 0.001 momentum 0.9 wd 5e-4.
RCNN_IMG = (600, 1000)
RCNN_CLASSES = 21
RCNN_STAGES = None           # None: torch_rcnn.VGG16
RCNN_HIDDEN = 4096
RCNN_NMS = (12000, 2000)     # rpn_pre_nms_top_n, rpn_post_nms_top_n
RCNN_ROIS = 128
RCNN_SCALES = (8, 16, 32)
RCNN_STEPS = 12
RCNN_TIMED_FROM = 2          # steps 3-12 timed
RCNN_OPT = dict(learning_rate=0.001, momentum=0.9, wd=5e-4,
                rescale_grad=1.0)
RCNN_CHECK_IMG = (192, 320)  # the float64 card-against-host step
RCNN_F64_RTOL = 1e-9         # losses and gradients, card against host
RCNN_ROIS_RTOL = 1e-12       # proposals and sampled rois: exp's last bit
RCNN_PROFILE_STEPS = 2
RCNN_ROI_GRAD_RTOL = 1e-5    # ROIPooling's data gradient: atomics' order
RCNN_NMS_CONTROL = 0.5       # the keep-mask control's threshold
_RCNN_OPS = ("_contrib_Proposal", "Custom", "ROIPooling")
# a step's device kernels by kind (matched lower-case, first group wins)
_RCNN_GROUPS = (("roi_pooling", ("roi_pool",)),
                ("proposal_nms", ("nms_mask", "nms_sweep")),
                ("cudnn_conv", ("cudnn", "fprop", "dgrad", "wgrad",
                                "implicit_gemm", "convolve")),
                ("f64_conv_route", ("im2col_kernel<double>", "f64f64",
                                    "dgemm")),
                ("gemm_f32", ("gemm", "cutlass")),
                ("sort_topk", ("sort", "radix", "topk")),
                ("copies", ("memcpy", "memset")))


def _rcnn_tools():
    """tools/torch_rcnn.py (the network, proposal_target and the anchor
    assignment), imported from beside this script."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "torch_rcnn", os.path.join(HERE, "tools", "torch_rcnn.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rcnn_symbol(mx, R, dropout=0.5):
    with mx.NameManager():
        return R.faster_rcnn_symbol(
            mx, num_classes=RCNN_CLASSES, stages=RCNN_STAGES or R.VGG16,
            rpn_pre=RCNN_NMS[0], rpn_post=RCNN_NMS[1], batch_rois=RCNN_ROIS,
            hidden=RCNN_HIDDEN, dropout=dropout, scales=RCNN_SCALES)


def _rcnn_data(R, n, hw, seed):
    return R.synthetic_images(n, hw[0], hw[1], RCNN_CLASSES, seed=seed,
                              stages=RCNN_STAGES or R.VGG16,
                              scales=RCNN_SCALES)


def _rcnn_params(R, sym, hw):
    shapes = R.param_shapes(sym, hw[0], hw[1], stages=RCNN_STAGES or R.VGG16,
                            scales=RCNN_SCALES)
    return R.init_params(shapes, seed=SEED)


def _rcnn_f64_check(mx, R):
    """One training step of the network at RCNN_CHECK_IMG in float64, on
    the card and on the host, from the same parameters (dropout off: the
    two devices' generators differ): the proposals and the sampled rois
    (tapped by the executor's monitor) within RCNN_ROIS_RTOL of their
    magnitude (the box decode's exp may differ in its last bit between
    the card's and the host's libm), bit-identical reported; the losses
    and every gradient within RCNN_F64_RTOL."""
    import numpy as np
    sym = _rcnn_symbol(mx, R, dropout=0.0)
    params = _rcnn_params(R, sym, RCNN_CHECK_IMG)
    d = _rcnn_data(R, 1, RCNN_CHECK_IMG, seed=SEED + 1)
    names = R.DATA_NAMES + R.LABEL_NAMES
    taps = ("rois_output0", "proposal_target_output0")
    res = {}
    for key, ctx in (("card", _ctx()), ("cpu", mx.cpu())):
        ex = sym.simple_bind(ctx=ctx, type_dict={n: "float64" for n in
                                                 sym.list_arguments()},
                             **{n: d[n].shape for n in names})
        ex.copy_params_from({k: mx.nd.array(v.astype(np.float64),
                                            ctx=mx.cpu())
                             for k, v in params.items()})
        seen = {}
        ex.set_monitor_callback(
            lambda name, arr: seen.__setitem__(name, arr.asnumpy())
            if name in taps else None)
        ex.forward(is_train=True, **{n: mx.nd.array(
            d[n].astype(np.float64), ctx=mx.cpu()) for n in names})
        ex.backward()
        t = {"out%d" % i: o.asnumpy() for i, o in enumerate(ex.outputs)}
        t.update({"grad:" + n: ex.grad_dict[n].asnumpy() for n in params})
        t.update({k: seen[k] for k in taps})
        res[key] = t
        del ex
        _free_card()
    card, cpu = res["card"], res["cpu"]
    errs = {k: _rel_err(card[k], v) for k, v in cpu.items()
            if k not in taps}
    rois = {k: {"rel_err": _rel_err(card[k], cpu[k]),
                "bit_identical": bool(np.array_equal(card[k], cpu[k])),
                "shape": list(cpu[k].shape)} for k in taps}
    fg = int((cpu["out4"] > 0).sum())
    return {"image": list(RCNN_CHECK_IMG), "dtype": "float64",
            "tensors": len(errs), "max_rel_err": max(errs.values()),
            "worst": sorted(errs.items(), key=lambda kv: -kv[1])[:4],
            "rtol": RCNN_F64_RTOL, "proposals": rois[taps[0]],
            "sampled_rois": rois[taps[1]], "rois_rtol": RCNN_ROIS_RTOL,
            "fg_rois": fg,
            "losses": R.losses([cpu["out%d" % i] for i in range(5)],
                               d["label"][0]),
            "ok": bool(max(errs.values()) <= RCNN_F64_RTOL
                       and all(r["rel_err"] <= RCNN_ROIS_RTOL
                               for r in rois.values()))}


def _rcnn_keep_check(mx, R, sym, params, d):
    """The Proposal kernel's keep mask against its plain version on the
    step's real boxes: the RPN's class probabilities and box deltas of
    the trained network on one image, decoded, filtered and sorted as
    Proposal does. A control with the plain version at another NMS
    threshold (RCNN_NMS_CONTROL) must differ."""
    import torch
    from mxnet_tpu_torch.ops import contrib, rcnn, registry
    internals = sym.get_internals()
    rpn = mx.sym.Group([internals["rpn_cls_act_reshape_output"],
                        internals["rpn_bbox_pred_output"]])
    ex = rpn.simple_bind(ctx=_ctx(), grad_req="null",
                         data=d["data"][:1].shape)
    ex.copy_params_from(params, {}, allow_extra_params=True)
    ex.forward(is_train=False, data=mx.nd.array(d["data"][:1],
                                                ctx=mx.cpu()))
    prob, delta = (o._data for o in ex.outputs)
    del ex
    attrs = registry.get_op("_contrib_Proposal").parse_attrs(dict(
        feature_stride=R.STRIDE, scales=RCNN_SCALES, ratios=R.RATIOS,
        rpn_pre_nms_top_n=RCNN_NMS[0], rpn_post_nms_top_n=RCNN_NMS[1],
        threshold=0.7, rpn_min_size=R.STRIDE))
    info = torch.tensor(d["im_info"][:1], device=prob.device)
    a = prob.shape[1] // 2
    top, _, _ = contrib.proposal_candidates(prob[:, a:], delta, info, attrs)
    boxes = contrib.nms_boxes(top)
    keep = rcnn.proposal_nms(boxes, 0.7)
    plain = rcnn.proposal_nms_plain(boxes, 0.7)
    control = rcnn.proposal_nms_plain(boxes, RCNN_NMS_CONTROL)
    _sync()
    return {"boxes": int(boxes.shape[1]), "kept": int(keep.sum()),
            "equal": bool(torch.equal(keep, plain)),
            "control_threshold": RCNN_NMS_CONTROL,
            "control_kept": int(control.sum()),
            "control_fails": not bool(torch.equal(keep, control)),
            "ok": bool(torch.equal(keep, plain)
                       and not torch.equal(keep, control))}


def _rcnn_lane(mod, batch):
    """RCNN_PROFILE_STEPS training steps under the profiler's kernel lane
    (``profiler.set_config(xplane_dir=...)``), each in a range of its
    own: per step, each kernel group's device ms (ROIPooling's and the
    NMS's kernels among them), the card's busy ms inside the step, the
    device span under each R-CNN op's range and the Custom op's host ms;
    their means over the steps."""
    import numpy as np
    from torch.profiler import record_function
    from mxnet_tpu_torch import profiler
    host = []
    steps = []
    with tempfile.TemporaryDirectory() as td:
        profiler.set_config(xplane_dir=td, profile_imperative=False,
                            profile_symbolic=False)
        with _annotated("rcnn:", _RCNN_OPS, host):
            _sync()
            profiler.set_state("run")
            try:
                _lane_pad()
                for i in range(RCNN_PROFILE_STEPS):
                    t0 = time.perf_counter()
                    with record_function("rcnn_step%d" % i):
                        mod.forward(batch, is_train=True)
                        mod.backward()
                        mod.update()
                        _sync()
                    steps.append((time.perf_counter() - t0) * 1e3)
            finally:
                profiler.set_state("stop")
        path = profiler.kernel_profile()[1]
        if path is None:
            return {"steps": RCNN_PROFILE_STEPS, "wall_ms": steps,
                    "note": "no kernel-lane trace (no card)"}
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        per = []
        for i in range(RCNN_PROFILE_STEPS):
            name = "rcnn_step%d" % i
            w = next(e for e in events if e.get("name") == name
                     and e.get("ph") == "X"
                     and e.get("cat") != "gpu_user_annotation")
            lo, hi = float(w["ts"]), float(w["ts"]) + float(w["dur"])
            split = {}
            for e in events:
                if e.get("cat") != "kernel" or not lo <= float(e["ts"]) < hi:
                    continue
                k = e.get("name", "").lower()
                g = next((g for g, keys in _RCNN_GROUPS
                          if any(key in k for key in keys)), "other")
                split[g] = split.get(g, 0.0) + float(e.get("dur", 0)) / 1e3
            ops = {}
            for e in events:
                if (e.get("cat") == "gpu_user_annotation"
                        and e.get("name", "").startswith("rcnn:")
                        and lo <= float(e["ts"]) < hi + 1e6):
                    key = e["name"][5:]
                    ops[key] = ops.get(key, 0.0) + float(e["dur"]) / 1e3
            busy, span, nk = _kernel_busy(path, name)
            per.append({"split_ms": split, "kernel_ms": sum(split.values()),
                        "busy_ms": busy, "step_ms": span, "kernels": nk,
                        "op_device_span_ms": ops})
    groups = sorted({g for p in per for g in p["split_ms"]})
    return {"steps": RCNN_PROFILE_STEPS, "each": per,
            "wall_ms": steps,
            "split_ms": {g: float(np.mean([p["split_ms"].get(g, 0.0)
                                           for p in per])) for g in groups},
            "kernel_ms": float(np.mean([p["kernel_ms"] for p in per])),
            "busy_share": float(np.mean([p["busy_ms"] / max(1e-9,
                                                            p["step_ms"])
                                         for p in per])),
            "custom_host_ms": float(np.mean(host)) if host else None}


def phase_faster_rcnn():
    """Faster R-CNN VGG16 trained end to end through the port's
    Module.fit on the card in float32 (tools/torch_rcnn.py at example/
    rcnn's settings): first one float64 step at RCNN_CHECK_IMG on the
    card and on the host (proposals and sampled rois equal, losses and
    gradients within RCNN_F64_RTOL); then RCNN_STEPS steps of one
    600 x 1000 image: images/s and ms a step over steps 3-12, each loss
    term first against last, per step the launches of ROIPooling's and
    the NMS's kernels and the Custom op's host ms, peak memory above what
    was allocated when the phase began; two
    steps under the profiler's kernel lane (device ms of each kernel
    group, ROIPooling's and the NMS's kernels among them, busy share, the
    device span under each R-CNN op's range); the NMS kernel's keep mask
    on the trained
    network's real boxes against its plain version, beside a control at
    another threshold that must fail. The RPN's log loss must fall (the
    mean of the last three steps under the first)."""
    import numpy as np
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import rcnn
    R = _rcnn_tools()
    _free_card()
    # what earlier phases left allocated: the peak below is this phase's
    # own, above it
    base = torch.cuda.memory_allocated() if DEV == "cuda" else 0
    t_phase = time.perf_counter()
    res = {"image": list(RCNN_IMG), "classes": RCNN_CLASSES,
           "rpn_nms": list(RCNN_NMS), "rois": RCNN_ROIS,
           "optimizer": dict(RCNN_OPT, name="sgd")}
    t0 = time.perf_counter()
    res["check"] = _rcnn_f64_check(mx, R)
    res["check"]["seconds"] = time.perf_counter() - t0
    sym = _rcnn_symbol(mx, R)
    params = _rcnn_params(R, sym, RCNN_IMG)
    d = _rcnn_data(R, RCNN_STEPS, RCNN_IMG, seed=SEED)
    res["params"] = int(sum(v.size for v in params.values()))
    stages = RCNN_STAGES or R.VGG16
    res["feature_map"] = list(R.feature_shape(stages, *RCNN_IMG))
    train = mx.io.NDArrayIter(
        data={n: d[n] for n in R.DATA_NAMES},
        label={n: d[n] for n in R.LABEL_NAMES}, batch_size=1,
        shuffle=False)
    mod = mx.mod.Module(sym, data_names=R.DATA_NAMES,
                        label_names=R.LABEL_NAMES, context=_ctx(),
                        fixed_param_names=R.fixed_param_names(stages))
    host_ms, marks, losses, counts = [], [], [], []

    def on_batch(param):
        _sync()
        t_in = time.perf_counter()
        i = param.nbatch
        if i == RCNN_TIMED_FROM and DEV == "cuda":
            torch.cuda.reset_peak_memory_stats()
        outs = [o.asnumpy() for o in mod.get_outputs()]
        losses.append(R.losses(outs, d["label"][i]))
        counts.append((rcnn.roi_pooling.launches,
                       rcnn.proposal_nms.launches))
        marks.append((t_in, time.perf_counter()))

    _reset_counts()
    with _annotated("rcnn:", _RCNN_OPS, host_ms):
        _sync()
        t_fit = time.perf_counter()
        mod.fit(train, num_epoch=1, optimizer="sgd",
                optimizer_params=dict(RCNN_OPT),
                arg_params={k: mx.nd.array(v, ctx=mx.cpu())
                            for k, v in params.items()},
                eval_metric=mx.metric.CustomMetric(
                    lambda label, pred: 0.0, name="none",
                    allow_extra_outputs=True),
                batch_end_callback=on_batch)
    launches = _read_counts()
    peak = torch.cuda.max_memory_allocated() if DEV == "cuda" else 0
    # step i: from the end of callback i - 1 (fit's start for step 0) to
    # the start of callback i
    step_s = [marks[0][0] - t_fit] + [marks[i][0] - marks[i - 1][1]
                                      for i in range(1, len(marks))]
    timed = step_s[RCNN_TIMED_FROM:]
    per_step = [{"roi_pooling": b[0] - a[0], "proposal_nms": b[1] - a[1]}
                for a, b in zip([(0, 0)] + counts[:-1], counts)]
    first, last = losses[0], losses[-1]
    res.update({
        "steps": len(step_s), "step_ms_each": [s * 1e3 for s in step_s],
        "step_ms": float(np.mean(timed)) * 1e3,
        "img_per_s": len(timed) / sum(timed),
        "loss_first": first, "loss_last": last, "losses": losses,
        "launches": launches, "launches_each_step": per_step,
        "custom_host_ms_each_step": host_ms,
        "resident_at_start_gb": base / 1e9,
        "peak_mem_gb": (peak - base) / 1e9})
    # RCNN_PROFILE_STEPS steps under the port's kernel lane
    batch = mx.io.DataBatch(
        data=[mx.nd.array(d[n][:1], ctx=mx.cpu()) for n in R.DATA_NAMES],
        label=[mx.nd.array(d[n][:1], ctx=mx.cpu()) for n in R.LABEL_NAMES])
    res["profile"] = _rcnn_lane(mod, batch)
    trained = mod.get_params()[0]
    res["keep_mask"] = _rcnn_keep_check(mx, R, sym, trained, d)
    del mod
    _free_card()
    res["phase_s"] = time.perf_counter() - t_phase
    on_card = DEV != "cuda" or all(
        s["roi_pooling"] >= 1 and s["proposal_nms"] >= 1 for s in per_step)
    res["ok"] = bool(
        res["check"]["ok"] and res["keep_mask"]["ok"] and on_card
        and len(losses) == RCNN_STEPS
        and all(np.isfinite(list(l_.values())).all() for l_ in losses)
        and np.mean([l_["rpn_log_loss"] for l_ in losses[-3:]])
        < first["rpn_log_loss"])
    RECORD["faster_rcnn"] = res
    if not res["ok"]:
        raise AssertionError("faster_rcnn failed: %s"
                             % json.dumps(res, default=str)[:6000])
    return res


# the other contrib ops at realistic shapes: (case, op, attrs, inputs as
# (shape, kind) with kind "normal", "uniform:lo:hi", "rois:n:h:w",
# "probs", "labels:n:len" or an array maker, indices differentiated)
CONTRIB_CASES = (
    # R-FCN's position-sensitive head: 21 classes, 7 x 7 groups at 1/16
    ("psroi_rfcn", "_contrib_PSROIPooling",
     dict(spatial_scale=1 / 16, output_dim=21, pooled_size=7, group_size=7),
     (((1, 1029, 37, 62), "normal"), ((300, 5), "rois:600:1000")), (0,)),
    ("deformable_psroi_rfcn", "_contrib_DeformablePSROIPooling",
     dict(spatial_scale=1 / 16, output_dim=21, group_size=7, pooled_size=7,
          part_size=7, sample_per_part=4, trans_std=0.1),
     (((1, 1029, 37, 62), "normal"), ((300, 5), "rois:600:1000"),
      ((300, 2, 7, 7), "normal")), (0, 2)),
    ("deformable_conv_512", "_contrib_DeformableConvolution",
     dict(kernel=(3, 3), pad=(1, 1), num_filter=512),
     (((1, 512, 37, 62), "normal"), ((1, 18, 37, 62), "uniform:-2:2"),
      ((512, 512, 3, 3), "weight"), ((512,), "normal")), (0, 1, 2, 3)),
    ("ctc_t80_b128", "CTCLoss", {},
     (((80, 128, 11), "normal"), ((128, 4), "labels:11:4")), (0,)),
    ("bilinear_sampler_60to40", "BilinearSampler", {},
     (((64, 8, 60, 60), "normal"), ((64, 2, 40, 40), "uniform:-1.1:1.1")),
     (0, 1)),
    ("grid_generator_40", "GridGenerator",
     dict(transform_type="affine", target_shape=(40, 40)),
     (((64, 6), "affine"),), (0,)),
    ("spatial_transformer_60to40", "SpatialTransformer",
     dict(target_shape=(40, 40)),
     (((64, 8, 60, 60), "normal"), ((64, 6), "affine")), (0, 1)),
    ("bilinear_resize_60to40", "_contrib_BilinearResize2D",
     dict(height=40, width=40), (((64, 8, 60, 60), "normal"),), (0,)),
    ("adaptive_avg_60to40", "_contrib_AdaptiveAvgPooling2D",
     dict(output_size=(40, 40)), (((64, 8, 60, 60), "normal"),), (0,)),
    # FlowNet-C's correlation: displacement 20 at stride 2 over conv3's
    # 256 channels at 48 x 64 (a 384 x 512 input)
    ("correlation_flownetc", "Correlation",
     dict(kernel_size=1, max_displacement=20, stride1=1, stride2=2,
          pad_size=20),
     (((2, 256, 48, 64), "normal"), ((2, 256, 48, 64), "normal")), (0, 1)),
    ("fft_1024", "_contrib_fft", {}, (((256, 1024), "normal"),), (0,)),
    ("ifft_1024", "_contrib_ifft", {}, (((256, 2048), "normal"),), (0,)),
    ("crop_center", "Crop", dict(h_w=(64, 64), center_crop=True),
     (((8, 64, 100, 100), "normal"),), (0,)),
    ("count_sketch", "_contrib_count_sketch", dict(out_dim=512),
     (((128, 2048), "normal"), ((1, 2048), "index:512"),
      ((1, 2048), "sign")), (0,)),
    ("khatri_rao", "khatri_rao", dict(num_args=2),
     (((64, 32), "normal"), ((64, 32), "normal")), (0, 1)),
    ("quadratic", "_contrib_quadratic", dict(a=1.5, b=-2.0, c=0.5),
     (((1024, 1024), "normal"),), (0,)),
)


def _contrib_input(rng, shape, kind):
    import numpy as np
    if kind == "normal":
        return rng.standard_normal(shape)
    if kind == "weight":
        return rng.standard_normal(shape) / np.sqrt(np.prod(shape[1:]))
    if kind.startswith("uniform:"):
        lo, hi = (float(v) for v in kind.split(":")[1:])
        return rng.uniform(lo, hi, shape)
    if kind.startswith("rois:"):
        h, w = (float(v) for v in kind.split(":")[1:])
        x = np.sort(rng.uniform(0, w, (shape[0], 2)), axis=1)
        y = np.sort(rng.uniform(0, h, (shape[0], 2)), axis=1)
        return np.concatenate([np.zeros((shape[0], 1)), x[:, :1], y[:, :1],
                               x[:, 1:], y[:, 1:]], axis=1)
    if kind.startswith("labels:"):
        alphabet, length = (int(v) for v in kind.split(":")[1:])
        lab = rng.randint(1, alphabet, shape).astype(np.float64)
        lens = rng.randint(1, length + 1, shape[0])
        lab[np.arange(shape[1])[None, :] >= lens[:, None]] = 0
        return lab
    if kind == "affine":
        return np.array([1, 0, 0, 0, 1, 0]) + 0.2 * rng.uniform(-1, 1, shape)
    if kind.startswith("index:"):
        return rng.randint(0, int(kind.split(":")[1]), shape)
    if kind == "sign":
        return np.sign(rng.uniform(-1, 1, shape))
    raise ValueError(kind)


def _fft_reference(arrs, ct):
    """_contrib_fft in float64 numpy (the op computes in float32 whatever
    its input's type): the interleaved spectrum and its vector-Jacobian
    product, Re(N ifft(C)) of the cotangent pairs C."""
    import numpy as np
    x = arrs[0]
    spec = np.fft.fft(x, axis=-1)
    out = np.stack([spec.real, spec.imag], -1).reshape(x.shape[:-1] + (-1,))
    c = ct.reshape(x.shape + (2,))
    grad = np.real(np.fft.ifft(c[..., 0] + 1j * c[..., 1], axis=-1)
                   * x.shape[-1])
    return {"output": out, "grad:0": grad}


def _ifft_reference(arrs, ct):
    """_contrib_ifft in float64 numpy: Re(ifft(Z)) * d of the pairs Z, and
    its vector-Jacobian product, the interleaved fft of the cotangent."""
    import numpy as np
    x = arrs[0]
    pairs = x.reshape(x.shape[:-1] + (-1, 2))
    d = pairs.shape[-2]
    out = np.real(np.fft.ifft(pairs[..., 0] + 1j * pairs[..., 1], axis=-1)) * d
    g = np.fft.fft(ct, axis=-1)
    return {"output": out, "grad:0": np.stack([g.real, g.imag], -1)
            .reshape(x.shape)}


# ops whose port computes in float32 whatever the input's type: their
# float64 reference is numpy's
_CONTRIB_REFERENCES = {"_contrib_fft": _fft_reference,
                       "_contrib_ifft": _ifft_reference}


def _contrib_case(case, name, attrs, inputs, diff, seed):
    """The op on the card in float32 and on the host in float32 and
    float64 from the same draws, with a seeded cotangent: outputs and the
    differentiated inputs' gradients by module_resnet50's float32 rule
    (the card's error against float64 within R50_F32_FACTOR of the
    host's; the float64 reference of fft / ifft, which compute in float32
    whatever the type, is numpy's); the card's ms a call."""
    import numpy as np
    import torch
    from mxnet_tpu_torch.ops import registry
    schema = registry.get_op(name)
    parsed = schema.parse_attrs(attrs)
    rng = np.random.RandomState(seed)
    arrs = [_contrib_input(rng, s, k) for s, k in inputs]
    ct = None
    t = {}
    for key, dev, dt in (("card", DEV, torch.float32),
                         ("cpu32", "cpu", torch.float32),
                         ("cpu64", "cpu", torch.float64)):
        xs = [torch.tensor(a, dtype=dt, device=dev) for a in arrs]
        leaves = [xs[i].requires_grad_(True) for i in diff]
        octx = registry.OpCtx(is_train=True, device=torch.device(dev))
        _sync()
        t0 = time.perf_counter()
        with torch.enable_grad():
            out = schema.fcompute(parsed, octx, *xs)[0]
        _sync()
        ms = (time.perf_counter() - t0) * 1e3
        if ct is None:
            ct = np.random.RandomState(seed + 1).standard_normal(out.shape)
        grads = torch.autograd.grad(out, leaves, torch.tensor(
            ct, dtype=dt, device=dev))
        t[key] = {"output": out.detach().cpu().double().numpy()}
        t[key].update({"grad:%d" % i: g.cpu().double().numpy()
                       for i, g in zip(diff, grads)})
        if key == "card":
            t["card_ms"] = ms
    if name in _CONTRIB_REFERENCES:
        t["cpu64"] = _CONTRIB_REFERENCES[name](arrs, ct)
    rule = _f32_rule(t["card"], t["cpu32"], t["cpu64"])
    return {"case": case, "op": name, "shapes": [list(s) for s, _ in inputs],
            "card_ms_first_call": t["card_ms"], "rule": rule,
            "ok": rule["ok"]}


def _custom_head_check(mx):
    """LeNet with a Custom op ("smoke_halve": x / 2, its backward g / 2)
    before its SoftmaxOutput, trained by DataParallelTrainer.step_k over
    4 stacked batches on the card: the step runs eagerly (no capture)
    with the reason naming the op, said in one warning, and equals 4
    eager Module steps from the same parameters (DP_STEPK_RTOL)."""
    import warnings
    import numpy as np
    import torch
    if "smoke_halve" not in mx.operator.get_all_registered():
        class Halve(mx.operator.CustomOp):
            def forward(self, is_train, req, in_data, out_data, aux):
                self.assign(out_data[0], req[0], in_data[0] / 2)

            def backward(self, req, out_grad, in_data, out_data, in_grad,
                         aux):
                self.assign(in_grad[0], req[0], out_grad[0] / 2)

        @mx.operator.register("smoke_halve")
        class HalveProp(mx.operator.CustomOpProp):
            def create_operator(self, ctx, shapes, dtypes):
                return Halve()
    sym = lenet_symbol(mx.sym)
    internals = sym.get_internals()
    head = mx.sym.Custom(internals["f2_output"],
                         op_type="smoke_halve", name="halve")
    sym = mx.sym.SoftmaxOutput(head, name="softmax")
    b, k = 64, 4
    x, y = synthetic_mnist(b * k, seed=SEED + 3)
    xs, ys = x.reshape(k, b, 1, 28, 28), y.reshape(k, b)
    tr = _dp_trainer(sym, "float32", b)
    p, st, a = tr.init_state({"data": (b, 1, 28, 28),
                              "softmax_label": (b,)})
    init = {n: t.detach().cpu().numpy().copy()
            for n, t in tr.device_params(p).items()}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        p, st, a, _, _ = tr.step_k(p, st, a, tr.shard_inputs(
            [xs, ys], stacked=True))
        p, st, a, _, _ = tr.step_k(p, st, a, tr.shard_inputs(
            [xs, ys], stacked=True))
    said = [str(w.message) for w in caught if "Custom" in str(w.message)]
    stats = tr.graph_stats()
    got = {n: t.detach().cpu().numpy() for n, t in
           tr.device_params(p).items()}
    mod = mx.mod.Module(sym, context=_ctx())
    mod.bind(data_shapes=[("data", (b, 1, 28, 28))],
             label_shapes=[("softmax_label", (b,))])
    mod.init_params(arg_params={n: mx.nd.array(v, ctx=mx.cpu())
                                for n, v in init.items()})
    mod.init_optimizer(optimizer="sgd", optimizer_params=dict(
        learning_rate=R50_LR, momentum=0.9, rescale_grad=1.0 / b))
    for _ in range(2):
        for i in range(k):
            mod.forward(mx.io.DataBatch(
                data=[mx.nd.array(xs[i], ctx=mx.cpu())],
                label=[mx.nd.array(ys[i], ctx=mx.cpu())]), is_train=True)
            mod.backward()
            mod.update()
    ref = {n: v.asnumpy() for n, v in mod.get_params()[0].items()}
    err = max(_rel_err(got[n], ref[n]) for n in ref)
    del tr, mod
    _free_card()
    reason = stats.get("eager_reason") or ""
    return {"batch": b, "k": k, "calls": 2, "captures": stats["captures"],
            "eager_reason": reason, "warnings": said,
            "max_rel_err_vs_module": err, "rtol": DP_STEPK_RTOL,
            "ok": bool(stats["captures"] == 0 and "smoke_halve" in reason
                       and (DEV != "cuda" or len(said) == 1)
                       and err <= DP_STEPK_RTOL)}


def phase_contrib_ops():
    """The other ops of the slice on the card at realistic shapes (R-FCN's
    PSROIPooling and DeformablePSROIPooling with trans, a 3 x 3 512 -> 512
    DeformableConvolution at 37 x 62, CTC at T 80 x batch 128 over 11
    symbols, the samplers and the spatial transformer 60² -> 40²,
    FlowNet-C's Correlation, fft over 1,024, the small ops), each held by
    the float32 rule against the same op on the host in float64; then
    LeNet with a Custom head through DataParallelTrainer.step_k, eager on
    the card, against 8 Module steps."""
    _free_card()
    cases = [_contrib_case(c, n, a, i, d, SEED + 10 * j)
             for j, (c, n, a, i, d) in enumerate(CONTRIB_CASES)]
    res = {"cases": cases, "custom_step_k": _custom_head_check(
        __import__("mxnet_tpu_torch"))}
    bad = [c["case"] for c in cases if not c["ok"]]
    res["failed"] = bad
    res["ok"] = bool(not bad and res["custom_step_k"]["ok"])
    RECORD["contrib_ops"] = res
    _free_card()
    if not res["ok"]:
        raise AssertionError("contrib_ops failed: %s"
                             % json.dumps(res, default=str)[:6000])
    return res


FF_EPOCHS = 10
FF_BATCH = 64
FF_LR = 0.1
FF_BAR = 0.9                  # examples/train_mnist.py's validation bar
FF_JAX_FIXTURE = ("tests", "data", "feedforward_jax")


def _digits_28():
    """sklearn's bundled digits (tools/data/digits.csv.gz), each 8 x 8
    image repeated 3 x 3 and padded to LeNet's 28 x 28, scaled to
    [0, 1]; a seeded 80/20 split."""
    import gzip
    import numpy as np
    with gzip.open(os.path.join(HERE, "tools", "data", "digits.csv.gz"),
                   "rt") as f:
        d = np.loadtxt(f, delimiter=",")
    x = np.kron(d[:, :-1].reshape(-1, 8, 8), np.ones((3, 3))) / 16.0
    x = np.pad(x, ((0, 0), (2, 2), (2, 2)))[:, None].astype(np.float32)
    y = d[:, -1].astype(np.float32)
    order = np.random.RandomState(SEED).permutation(len(y))
    cut = int(0.8 * len(y))
    return (x[order[:cut]], y[order[:cut]]), (x[order[cut:]], y[order[cut:]])


def phase_feedforward():
    """LeNet through the legacy mx.model.FeedForward on the card over the
    bundled digits: validation accuracy against the example's bar, save
    and load with predict bit-identical, and the JAX package's
    FeedForward checkpoint (tests/data/feedforward_jax-*) loaded, its
    predictions against the JAX package's own (stored beside it)."""
    import warnings
    import numpy as np
    import mxnet_tpu_torch as mx
    mx.random.seed(SEED)
    np.random.seed(SEED)
    (xt, yt), (xv, yv) = _digits_28()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        model = mx.model.FeedForward(
            lenet_symbol(mx.sym), ctx=_ctx(), num_epoch=FF_EPOCHS,
            numpy_batch_size=FF_BATCH, learning_rate=FF_LR, momentum=0.9,
            initializer=mx.init.Xavier())
    deprecated = any(issubclass(w.category, DeprecationWarning)
                     for w in caught)
    t0 = time.perf_counter()
    model.fit(xt, yt, eval_data=(xv, yv))
    fit_s = time.perf_counter() - t0
    probs = model.predict(xv)
    acc = float((probs.argmax(1) == yv).mean())
    score = float(model.score(xv, yv))
    with tempfile.TemporaryDirectory() as td:
        prefix = os.path.join(td, "lenet")
        model.save(prefix)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            loaded = mx.model.FeedForward.load(prefix, FF_EPOCHS,
                                               ctx=_ctx(),
                                               numpy_batch_size=FF_BATCH)
        again = loaded.predict(xv)
    fix = os.path.join(HERE, *FF_JAX_FIXTURE)
    with np.load(fix + "-expected.npz") as z:
        fx, fprobs = z["x"], z["probs"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        jmodel = mx.model.FeedForward.load(fix, 2, ctx=_ctx())
    jprobs = jmodel.predict(fx)
    jerr = _rel_err(jprobs, fprobs)
    res = {"train": int(len(yt)), "val": int(len(yv)), "epochs": FF_EPOCHS,
           "fit_s": fit_s, "val_acc": acc, "score": score, "bar": FF_BAR,
           "deprecation_warning": deprecated,
           "reload_bit_identical": bool(np.array_equal(probs, again)),
           "reload_max_abs_diff": float(np.abs(probs - again).max()),
           "jax_checkpoint_rel_err": jerr,
           "ok": bool(acc > FF_BAR and score > FF_BAR
                      and deprecated and np.array_equal(probs, again)
                      and jerr <= 1e-5)}
    RECORD["feedforward"] = res
    if not res["ok"]:
        raise AssertionError("feedforward failed: %s"
                             % json.dumps(res, default=str)[:4000])
    return res


def _rcnn_rois(gen, n, hw, batch=1):
    """n rois [0, x1, y1, x2, y2] inside an hw image: corners uniform,
    sides at least 16 pixels (Proposal's min size)."""
    import torch
    h, w = hw
    xy = torch.rand(n, 4, generator=gen, device=DEV)
    x1 = xy[:, 0] * (w - 16)
    y1 = xy[:, 1] * (h - 16)
    x2 = x1 + 16 + xy[:, 2] * (w - 16 - x1)
    y2 = y1 + 16 + xy[:, 3] * (h - 16 - y1)
    b = torch.zeros(n, device=DEV)
    return torch.stack([b, x1, y1, x2, y2], dim=1)


def _roi_windows(rois, h, w, scale):
    """Map elements under the union of the rois' windows (each roi's
    bins cover rows [y1, y1 + max(y2 - y1 + 1, 1)) and the like columns,
    corners rounded half away, clipped to the map), and the sum of the
    windows' sizes over the rois (host tensors)."""
    import torch
    from mxnet_tpu_torch.ops.contrib import _round_half_away
    x1, y1, x2, y2 = (_round_half_away(rois[:, k].float() * scale)
                      for k in (1, 2, 3, 4))
    rows = (y1, y1 + torch.clamp_min(y2 - y1 + 1, 1))
    cols = (x1, x1 + torch.clamp_min(x2 - x1 + 1, 1))
    ys = torch.arange(h, dtype=torch.float32)
    xs = torch.arange(w, dtype=torch.float32)
    my = (ys >= rows[0][:, None]) & (ys < rows[1][:, None])     # (R, H)
    mx_ = (xs >= cols[0][:, None]) & (xs < cols[1][:, None])    # (R, W)
    union = (my[:, :, None] & mx_[:, None, :]).any(0)
    window = float((my.sum(1) * mx_.sum(1)).sum())
    return int(union.sum()), window


def _library_ms(call, iters, name, without):
    """(ms, note) of ``call(torchvision.ops)`` where torchvision is
    installed and runs here (for the library times only: the port never
    uses it), else (None, why not)."""
    try:
        import torchvision.ops
    except Exception as e:          # not installed, or built for another torch
        return None, "torchvision not importable (%s); %s" % (
            type(e).__name__, without)
    try:
        return bench_ms(lambda: call(torchvision.ops), [()], iters), name
    except Exception as e:
        return None, "%s failed: %r" % (name, e)


def _roi_pool_case(name, gen):
    """ROIPooling at Faster R-CNN's second stage (the conv5_3 map of a
    600 x 1000 image, 512 x 37 x 62 after ReLU, RCNN_ROIS rois, 7 x 7
    bins at 1/16): the forward equal to the plain version, the data
    gradient within RCNN_ROI_GRAD_RTOL of its largest magnitude; device
    times of the forward and backward kernels beside the plain forward's
    and torchvision's roi_pool (where installed), and the bounds of this
    run's data: the forward reads the union of the rois' windows of the
    map once and writes the output once, the backward reads that union
    and the output's gradient once and writes the whole data gradient
    once; each does a comparison an element of each roi's window."""
    import torch
    from mxnet_tpu_torch.ops import rcnn
    fh, fw = 37, 62
    data = torch.relu(torch.randn(1, 512, fh, fw, generator=gen,
                                  device=DEV))
    rois = _rcnn_rois(gen, RCNN_ROIS, RCNN_IMG)
    x = data.clone().requires_grad_(True)
    xp = data.clone().requires_grad_(True)
    out = rcnn.roi_pooling(x, rois, (7, 7), 1 / 16)
    ref = rcnn.roi_pooling_plain(xp, rois, (7, 7), 1 / 16)
    g = torch.randn(out.shape, generator=gen, device=DEV)
    (gx,) = torch.autograd.grad(out, x, g)
    (gp,) = torch.autograd.grad(ref, xp, g)
    out, ref = out.detach(), ref.detach()
    _sync()
    fwd_equal = bool(torch.equal(out, ref))
    grad_err = float((gx - gp).abs().max()) / max(1e-30,
                                                  float(gp.abs().max()))
    case = {"kernel": "roi_pooling", "case": name,
            "shape": [1, 512, fh, fw], "rois": RCNN_ROIS,
            "forward_equal": fwd_equal, "max_abs_err":
            float((out - ref).abs().max()), "grad_rel_err": grad_err,
            "grad_rtol": RCNN_ROI_GRAD_RTOL, "library_ms": None}
    if DEV == "cuda":
        covered, window = _roi_windows(rois.cpu(), fh, fw, 1 / 16)
        read = 4 * 512 * covered + rois.numel() * 4
        window *= 512
        nbytes = read + out.numel() * 4
        case["bytes"], case["operations"] = nbytes, window
        case["bound_ms"], case["bound_by"] = bound_ms(nbytes, window)
        bwd_bytes = read + out.numel() * 4 + data.numel() * 4
        case["bwd_bytes"] = bwd_bytes
        case["bwd_bound_ms"], case["bwd_bound_by"] = bound_ms(bwd_bytes,
                                                              window)
        case["library_ms"], case["library_note"] = _library_ms(
            lambda lib: lib.roi_pool(data, rois, (7, 7), 1 / 16), 50,
            "torchvision.ops.roi_pool", "no torch call pools rois")
        case["kernel_ms"] = bench_ms(
            lambda: rcnn.roi_pooling(data, rois, (7, 7), 1 / 16), [()], 50)
        case["plain_ms"] = bench_ms(
            lambda: rcnn.roi_pooling_plain(data, rois, (7, 7), 1 / 16),
            [()], 3)
        y = rcnn.roi_pooling(x, rois, (7, 7), 1 / 16)
        case["bwd_kernel_ms"] = bench_ms(
            lambda: torch.autograd.grad(y, x, g, retain_graph=True), [()],
            20)
        case["kernel_launches_per_call"] = launches_per_call(
            lambda: rcnn.roi_pooling(data, rois, (7, 7), 1 / 16),
            "roi_pooling")
    case["ok"] = fwd_equal and grad_err <= RCNN_ROI_GRAD_RTOL
    return case


def _nms_case(name, gen, n, dtype="f32"):
    """Proposal's NMS at its pre-NMS count: n boxes of a 600 x 1000 image
    (centres uniform, sides 16-316 pixels) sorted by a random score, the
    +1 shift applied; the kernel's keep mask identical to the plain
    version's at threshold 0.7. Device times; the bound of this run's
    data: the boxes read once, the mask written once, ~14 operations an
    IoU over the n (n - 1) / 2 pairs. torchvision's nms on the same
    boxes as the library's time where it is installed (it suppresses at
    IoU > threshold, not >=, and reads its mask back to the host)."""
    import torch
    from mxnet_tpu_torch.ops import rcnn
    dt = torch.float64 if dtype == "f64" else torch.float32
    ctr = torch.rand(n, 2, generator=gen, device=DEV, dtype=torch.float64) \
        * torch.tensor([1000.0, 600.0], device=DEV, dtype=torch.float64)
    wh = torch.rand(n, 2, generator=gen, device=DEV,
                    dtype=torch.float64) * 300 + 16
    boxes = torch.cat([ctr - wh / 2, ctr + wh / 2], dim=1).to(dt)[None]
    keep = rcnn.proposal_nms(boxes, 0.7)
    plain = rcnn.proposal_nms_plain(boxes, 0.7)
    _sync()
    equal = bool(torch.equal(keep, plain))
    case = {"kernel": "proposal_nms", "case": name, "boxes": n,
            "dtype": dtype, "kept": int(keep.sum()), "keep_equal": equal,
            "max_abs_err": 0.0 if equal else 1.0, "library_ms": None}
    if DEV == "cuda":
        nbytes = boxes.numel() * boxes.element_size() + n
        flops = 14.0 * n * (n - 1) / 2
        case["bytes"], case["operations"] = nbytes, flops
        case["bound_ms"], case["bound_by"] = bound_ms(
            nbytes, flops, PEAK_F32_FLOPS if dtype == "f32"
            else PEAK_F64_FLOPS)
        score = torch.arange(n, 0, -1, device=DEV, dtype=dt)
        case["library_ms"], case["library_note"] = _library_ms(
            lambda lib: lib.nms(boxes[0], score, 0.7), 20,
            "torchvision.ops.nms (IoU > threshold, a host read)",
            "no torch call runs greedy NMS")
        case["kernel_ms"] = bench_ms(lambda: rcnn.proposal_nms(boxes, 0.7),
                                     [()], 20)
        t0 = time.perf_counter()
        rcnn.proposal_nms_plain(boxes, 0.7)
        _sync()
        case["plain_ms"] = (time.perf_counter() - t0) * 1e3
        case["kernel_launches_per_call"] = launches_per_call(
            lambda: rcnn.proposal_nms(boxes, 0.7), "proposal_nms")
    case["ok"] = equal
    return case


PHASES = (("device", phase_device), ("build", phase_build),
          ("kernels", phase_kernels), ("train", phase_train),
          ("train_profile", phase_train_profile),
          ("engines", phase_engines), ("profile", phase_profile),
          ("serve_gqa", phase_serve_gqa), ("export", phase_export),
          ("conv", phase_conv),
          ("rtc", phase_rtc), ("module_lenet", phase_module_lenet),
          ("module_resnet50", phase_module_resnet50),
          ("gluon_resnet50", phase_gluon_resnet50),
          ("gluon_cifar", phase_gluon_cifar),
          ("gluon_lm_hybrid", phase_gluon_lm_hybrid),
          ("gluon_fused_resnet50", phase_gluon_fused_resnet50),
          ("gluon_fused_lm", phase_gluon_fused_lm),
          ("gluon_fused_lm_amp", phase_gluon_fused_lm_amp),
          ("dp_resnet50", phase_dp_resnet50),
          ("dp_resnet50_fp16", phase_dp_resnet50_fp16),
          ("module_fused", phase_module_fused),
          ("ckpt_resume", phase_ckpt_resume),
          ("rnn_op", phase_rnn_op), ("lstm_lm", phase_lstm_lm),
          ("lstm_bucketing", phase_lstm_bucketing),
          ("predict", phase_predict), ("serving_net", phase_serving_net),
          ("ssd300", phase_ssd300), ("dlrm", phase_dlrm),
          ("device_feed", phase_device_feed),
          ("traced_lm", phase_traced_lm),
          ("ring_attention", phase_ring_attention),
          ("zero_lm", phase_zero_lm), ("tp_pp", phase_tp_pp),
          ("planner", phase_planner), ("group2ctx", phase_group2ctx),
          ("image_codec", phase_image_codec),
          ("image_rec_resnet50", phase_image_rec_resnet50),
          ("image_det_rec", phase_image_det_rec),
          ("faster_rcnn", phase_faster_rcnn),
          ("contrib_ops", phase_contrib_ops),
          ("feedforward", phase_feedforward))

# (name, source, TPU kernel, case kind, case, its time / bound keys, errors,
# its kernel launches a call: counted in the case)
KERNEL_ROWS = (
    ("flash_attention_fwd", "mxnet_tpu_torch/csrc/flash_attention.cu",
     "mxnet_tpu/ops/attention.py:80", "flash_attention_fwd",
     "train_b8_s1024", "kernel_ms", "bound_ms", "bound_by",
     ("max_abs_err",), "kernel_launches_per_call"),
    ("flash_attention_bwd_dq", "mxnet_tpu_torch/csrc/flash_attention_bwd.cu",
     "mxnet_tpu/ops/attention.py:144", "flash_attention_bwd",
     "train_b8_s1024", "dq_ms", "dq_bound_ms", "dq_bound_by", ("err_dq",),
     "dq_kernel_launches_per_call"),
    ("flash_attention_bwd_dkv",
     "mxnet_tpu_torch/csrc/flash_attention_bwd.cu",
     "mxnet_tpu/ops/attention.py:197", "flash_attention_bwd",
     "train_b8_s1024", "dkv_ms", "dkv_bound_ms", "dkv_bound_by",
     ("err_dk", "err_dv"), "dkv_kernel_launches_per_call"),
    ("decode_attention", "mxnet_tpu_torch/csrc/decode_attention.cu",
     "mxnet_tpu/ops/attention.py:612", "decode_attention", "step_mha",
     "kernel_ms", "bound_ms", "bound_by", ("max_abs_err",),
     "kernel_launches_per_call"),
    ("quantized_matmul", "mxnet_tpu_torch/csrc/quantized_matmul.cu",
     "mxnet_tpu/ops/quantization.py:407", "quantized_matmul",
     "step_head_int8", "kernel_ms", "bound_ms", "bound_by",
     ("max_abs_err",), "kernel_launches_per_call"),
    ("conv1x1", "mxnet_tpu_torch/csrc/conv1x1.cu",
     "mxnet_tpu/ops/conv_fused.py:69", "conv1x1", "r50_64to256_56",
     "kernel_ms", "bound_ms", "bound_by", ("max_abs_err",),
     "kernel_launches_per_call"),
    ("rtc", "mxnet_tpu_torch/rtc.py", "mxnet_tpu/rtc.py:71", "rtc",
     "scale_add", "kernel_ms", "bound_ms", "bound_by", ("max_abs_err",),
     "kernel_launches_per_call"),
    # no TPU kernel: the JAX package's native pipeline's ProcessRecord
    ("image_assemble", "mxnet_tpu_torch/csrc/image_assemble.cu",
     "src/runtime_native.cc:357", "image_assemble", "b128_256_to_224_u8",
     "kernel_ms", "bound_ms", "bound_by", ("max_abs_err",),
     "kernel_launches_per_call"),
    # no TPU kernel: ROIPooling and Proposal's NMS are plain XLA there
    ("roi_pooling", "mxnet_tpu_torch/csrc/roi_pooling.cu",
     "mxnet_tpu/ops/contrib.py:528", "roi_pooling", "rcnn_r128_512x37x62",
     "kernel_ms", "bound_ms", "bound_by", ("max_abs_err",),
     "kernel_launches_per_call"),
    ("proposal_nms", "mxnet_tpu_torch/csrc/proposal_nms.cu",
     "mxnet_tpu/ops/contrib.py:286", "proposal_nms", "rcnn_pre12000_f32",
     "kernel_ms", "bound_ms", "bound_by", ("max_abs_err",),
     "kernel_launches_per_call"),
)


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=None,
                    help="comma-separated phases to run (default: all)")
    ap.add_argument("--package", default=HERE,
                    help="directory holding mxnet_tpu_torch")
    args = ap.parse_args(argv)
    chosen = None if args.phases is None else args.phases.split(",")
    if chosen is not None and not set(chosen) <= {n for n, _ in PHASES}:
        ap.error("phases are %s" % ", ".join(n for n, _ in PHASES))
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.package)
    sys.path.insert(0, root)
    try:
        import mxnet_tpu_torch  # noqa: F401
        from mxnet_tpu_torch import _build
        if not any(_build.CSRC.glob("*.cu")):
            raise ImportError("no kernel sources under %s" % _build.CSRC)
    except ImportError as e:
        print("chip_smoke: mxnet_tpu_torch not importable from %s: %s"
              % (root, e), file=sys.stderr)
        return 2
    failed = []
    for name, fn in PHASES:
        if chosen is not None and name not in chosen:
            continue
        t0 = time.perf_counter()
        try:
            res = fn()
            emit(dict(res, phase=name, ok=True,
                      seconds=time.perf_counter() - t0))
        except Exception as e:      # a phase failing must not hide the rest
            failed.append(name)
            emit({"phase": name, "ok": False, "error": repr(e)[:2000],
                  "seconds": time.perf_counter() - t0})
            traceback.print_exc()
            if name in ("device", "build"):
                break
    if chosen is not None:
        os.makedirs(OUT_DIR, exist_ok=True)
        with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
            json.dump(RECORD, f, indent=1, default=str)
        emit({"ok": not failed, "phases": chosen,
              "package": mxnet_tpu_torch.__file__})
        return 1 if failed else 0
    cases = RECORD.get("kernel_cases", [])
    paths = list(RECORD.get("engines", {}).values())
    paths += [RECORD[k] for k in ("train", "serve_gqa", "conv", "rtc",
                                  "module_lenet", "module_resnet50",
                                  "gluon_resnet50", "gluon_cifar",
                                  "gluon_lm_hybrid", "gluon_fused_resnet50",
                                  "gluon_fused_lm", "gluon_fused_lm_amp",
                                  "dp_resnet50", "dp_resnet50_fp16",
                                  "module_fused", "ckpt_resume",
                                  "lstm_lm", "lstm_bucketing", "predict",
                                  "serving_net", "ssd300", "dlrm",
                                  "device_feed", "traced_lm",
                                  "ring_attention", "zero_lm", "tp_pp",
                                  "planner", "group2ctx",
                                  "image_rec_resnet50", "image_det_rec",
                                  "faster_rcnn")
              if k in RECORD]
    rows = []
    for (name, src, replaces, kind, case, ms_key, bound_key, by_key,
         err_keys, per_call_key) in KERNEL_ROWS:
        c = next((c for c in cases
                  if c["kernel"] == kind and c["case"] == case), None)
        # absolute errors, but of the attention cases in bf16/f16: those
        # are held in ulps and kept in chip_smoke.json
        errs = [c[k] for c in cases if c["kernel"] == kind
                and not c.get("held_in_ulps") for k in err_keys]
        launches = sum(p["launches"].get(name, 0) for p in paths)
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches,
                     "max_abs_err": max(errs) if errs else None,
                     "case": case,
                     "ms": c and c[ms_key],
                     "plain_ms": c and c["plain_ms"],
                     "bound_ms": c and c[bound_key],
                     "bound_by": c and c[by_key],
                     "library_ms": c and c["library_ms"],
                     "kernel_launches_per_call": c and c[per_call_key]})
    RECORD["kernels"] = rows
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(RECORD, f, indent=1, default=str)
    unlaunched = [r["name"] for r in rows if not r["launches"]]
    if unlaunched and not failed:
        failed.append("no launch on a path: %s" % unlaunched)
    if failed:
        print("chip_smoke: failed phases: %s" % failed, file=sys.stderr)
        return 1
    print(RECORD["nvidia_smi"], flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
