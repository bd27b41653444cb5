#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (stabletriton_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py [--profile] [--plans]
    python3 chip_smoke.py --host-time [DIR]
    python3 chip_smoke.py --group-norm [DIR]
    python3 chip_smoke.py --sd21
    python3 chip_smoke.py --k8 [DIR] [--serve]

``--profile`` adds a torch.profiler breakdown of one step under each
binding to phases 4 and 4c (device time by kernel family, idle share, the
attention kernels by name) and of the default binding's 1024^2 decode to
phase 5e (the same, and its 12 longest kernels), phase 4e's 30-step
request and phase 4f's 30-step Heun request (the capture cost of a graph
of two UNet evaluations a step);
``--plans`` times the wgmma kernels at forced tile widths and K splits
beside the planner's choice and a plain wave-filling rule's (before phase
3). ``--host-time`` only builds the kernels and prints the host time a
launch of the linear, conv, GroupNorm, LayerNorm, attention, timestep
embedding and dropout wrappers, of bare C entries and of the fused GN conv
op, of the package in DIR (a copy of another tree, to compare two in one
run) or of this checkout, with the skinny linear's, LayerNorm's and
dropout's device time and their PyTorch calls'; it prints no result line.
``--group-norm`` likewise only builds the kernels and prints, for the
package in DIR or this checkout, GroupNorm's (K9's) device time at every
shape of the paths, whole and as the fused conv's stats and fold, beside
F.group_norm and its bound, then the replayed SDXL-base step under the
fused-op and all-kernel bindings and a 1024^2 f32 decode under the fused-op
binding by kernel family; it prints no result line. ``--sd21`` only builds
the kernels and runs phases 7v and 5v (SD2.1-768 at the sd-2.1-768.batch8
cell's shapes and served as it serves it), then prints their kernel rows
and the result line. ``--k8`` only builds the kernels and runs phase 3k:
K8 at every shape of the SDXL-base 1024^2 step at UNet batch 2 and 16
(and the refiner's 128^2 384 -> 384, SD1.5's split 8^2 2560 -> 1280)
against its plain version, its normalised operand bit for bit K9's apply
(a centre-tap identity weight), and its device time beside its bound, the
unfused pair (K9 apply + K6) and, given DIR (another tree, e.g. the
parent's), that tree's K8 timed in a subprocess on the same card; then
with ``--serve`` phase 5b (the fused-op binding served at 1024^2: every
K8 launch of the replayed steps on wgmma_gn_bf16 but conv_out's), and
the result line.

Phases, each fatal on failure (non-zero exit, no result line):

  1. device: the card's name and power limit from nvidia-smi;
  2. build: compile the CUDA kernels from stabletriton_tpu_torch/csrc/ for sm_90a;
  3. kernels: each kernel against its plain PyTorch version at the shapes the
     SDXL-base 1024^2 path gives it (max abs / max relative error, times:
     CUDA events through the wrapper, and in this and every later kernel
     phase the device time a call from torch.profiler's kernel events, for
     the kernel and the library call, since short rows read host time),
     beside its bound (operations over the peak rate or bytes over the
     memory rate, whichever is longer) and one PyTorch call computing the
     same function where there is one (SDPA for attention; the reference
     op's cuDNN conv for the bf16 convs, F.conv2d with TF32 off for the f32
     ones); each attention launch must carry its class (the JAX package's
     Pallas kernel it stands in for, K1-K5) and its kernel in its launch key
     (bf16 at most 128 keys on attn_tinykv_wgmma_bf16, above on
     attn_wgmma_bf16, f32 on the 3xTF32 GEMM wgmma_tf32x3, whose
     row also prints its bound at the f32 FMA peak and the time of its
     operand split); the convs run on the kernel the routing picks (bf16:
     wgmma, conv_in's Cin 4 padded to 8 and conv_out's Cout 4 on the
     8-column tile, with the padding's time printed; f32: the 3xTF32 wgmma
     kernel, beside the scalar kernel it replaced, or for the VAE's conv_in
     (Cin 4, SDXL's 128^2 and SD1.5's 64^2) the direct kernel, beside the
     scalar kernel it replaced and the 3xTF32 conv on Cin padded to 8),
     SD1.5's 16^2 and 8^2 levels included, and the tf32 rows beside their
     bound in 3xTF32 on the tensor cores as well; each bf16 attention row
     with Sk <= 128 (K5, and K1's cross-attention) also prints the device
     time of every bf16 kernel at the same operands;
  3b. fused-op kernels: GroupNorm (K9: the stats-and-fold kernel and the
     apply kernel behind one C entry) at every GroupNorm shape of the
     SDXL-base, SD1.5 and f32 VAE decoder paths (K9_CASES), beside
     F.group_norm, the same bits in a second run, and its stats and fold
     alone (the fused conv's prologue) by device time beside their bound;
     LayerNorm / RMSNorm (K10, beside F.layer_norm /
     F.rms_norm), GEGLU (K11) and the GN-fused 3x3 conv (K8, its scale /
     shift from the GroupNorm fold kernel) against their plain versions at
     the same path's shapes; K8 also beside the unfused pair (K9 apply, K6);
  3c. SD1.5 attention: the bf16 kernels at the SD1.5 512^2 path's shapes
     (K3 at d=40, K4 at d=80 and 160, K5 on attn_tinykv_wgmma_bf16 against
     77 keys and the mid-block's 64), then phase 3's d=64 rows again;
  3e. C4: the bf16 attention kernels (K1 self and cross, K2, K3 at d=40,
     K4 at d=80 and 160, K5 at d=40, 80 and 160 and the mid block's S=64)
     on inputs where each output is an exact f32 quotient x / l whose bf16
     rounding differs from that of x * f32(1 / l): every output must be
     bf16(x / l) bit for bit, as JAX's o / l.clip(1e-30) gives it; and
     on inputs that put zeros, quotients under 2^-99 or over 2^99,
     infinities and NaN (by position) beside in-range outputs in one warp's
     rows, which the epilogue stores again with the division;
  3f. the default binding's GroupNorm, LayerNorm and GEGLU kernel forms
     ("cuda_bf16apply") at SD1.5's largest shapes beside the plain chains
     they replace (device ms, bound, kernels a call), held to them: bf16
     within 2 ulps of the largest output with at most 2e-4 of the elements
     off, f32 within 8 ulps; rows of the kernels line, their launches those
     of phases 5 and 5c; then torch.rsqrt against 1 / sqrt;
  3d. the rest of the opt-in kernels: the timestep embedding (K12) at
     (2,)->(2,320) and (12,)->(12,256), bit for bit against its plain
     version, beside the launch floor (the device time of an empty
     kernel); linear (K13) at every GEMM shape of
     both paths (wgmma, the f32 3xTF32 GEMM, SiLU and GELU epilogues, and
     the skinny kernel at each M = 2 shape of the steps, whose launches are
     counted by shape), each beside cuBLAS's addmm of the same GEMM (f32 with TF32
     off), the wgmma rows beside the WMMA kernel (element loads, the route
     of the shapes TMA cannot take), the f32 rows beside their f32-FMA bound
     and the time of the wrapper's weight split; seeded dropout (K14)
     through ops.dispatch under a ("dropout", "cuda") binding at (2, 4096,
     640) in bf16 and f32 and at 2^20 f32 elements, bit for bit against
     its plain version, deterministic, seed-sensitive, and dropping a
     fraction within 4 sigma of the rate;
  4, 4b, 4d. step deviation: one full-width SDXL-base UNet step (128^2
     latent, CFG batch 2, bf16, random weights, fused projections and the
     cross K/V precompute) under the default binding, the fused-op binding
     (CompileConfig.overrides: group_norm, layer_norm, geglu -> "cuda",
     gn_conv2d -> "fused") and the all-kernel binding (the fused-op binding
     plus linear and time_embed -> "cuda"), each against the "reference"
     binding: MSE under 1e-3; attention launches per step K1 130, K2 10:
     K1's 70 cross-attention launches (77 keys) on attn_tinykv_wgmma_bf16,
     the 60 self and K2 on attn_wgmma_bf16;
     default-binding kernel forms 46 GroupNorms, 210 LayerNorms, 70 GEGLUs
     (none under the other two bindings);
     fused-op launches K8 35, K9 11, K10 210, K11 70; all-kernel also K12 2
     and K13 463 + 70 in the precompute, every linear dispatch on the
     kernel and none on the reference (cuBLAS) op, 512 of the 533 on the
     wgmma kernel and 21 (M = 2) on the skinny one; under every binding all
     38 convs on the wgmma kernel;
  4c. one full-width SD1.5 UNet step (64^2 latent, CFG batch 2, bf16) under
     the three bindings against the reference binding, MSE under 1e-3;
     attention launches per step K3 5, K4 10, K5 17 (all on the tiny-KV
     kernel) and no K1 or K2; default-binding kernel forms 61 GroupNorms,
     48 LayerNorms, 16 GEGLUs; K8 45,
     K9 16, K10 48, K11 16; all-kernel K12 1, K13 152 + 16 (144 wgmma, 24
     skinny); all 49 convs on wgmma;
  4h. (after 4e) SD1.5's UNet step at UNet batch 2 and 16: eager under the
     default binding (the kernel forms' per-step launches, K8-K11 none), then
     replayed under the default binding, under its plain chains and under
     the fused-op binding, in turns; the default step by kernel family and
     against the plain chains' (the step gate);
  4e. replay: under the reference, default, fused-op and all-kernel
     bindings, compile_unet_kv's precompute and step at the full-width
     SDXL-base step of phase 4 (and SD1.5's of 4c), called eagerly
     (``__wrapped__``) and by replay on the same inputs: the outputs bit for
     bit equal (under every binding but the all-kernel one, whose step runs
     no cuBLAS call, a difference is logged with its max abs and MSE and
     held under the step gate against the reference binding), a replay
     counting the eager step's launches key by key; the step timed eager
     against replay (host clock and CUDA events), its capture and
     instantiate time, the graph's nodes by type beside the eager step's
     kernels from the profiler, peak memory of an eager step, the pool a
     capture reserves and a replay's peak; with ``--profile`` the idle
     share of both. Then four SDXL 1024^2 4-step requests (return_latents)
     through SDXLPipeline.txt2img under each binding: two of one signature
     (the first captures, the second replays with another prompt and seed)
     and two with a guidance interval over the middle two steps, each equal
     to the eager loop (the program's own, from the same
     make_denoise_loop) on its inputs as above, one graph a signature, a
     replay counting its signature's eager launches; each capture's host
     seconds in pieces (the eager warm-up, torch.cuda.graph's entry, the
     captured call, the end of the capture, instantiate); with ``--profile``
     also a 30-step request under the default binding, captured and
     replayed, then freed (its graph must be gone with its pipeline);
  4f. solvers and DeepCache: the shallow pass (unet_apply_shallow on the
     cache of unet_apply(return_cache=True), cross K/V precompute) against
     the full pass on the same inputs, bit for bit, at full width, CFG batch
     2, bf16: SDXL-base at 128^2 with the split at depth 1 (no attention in
     the shallow pass) and 2 (K1, K2 live), SD1.5 at 64^2 at depth 1 (K3,
     K5), under the default, fused-op and all-kernel bindings; each pass's
     launches by kernel (attention by launch key), both graphed, each replay
     bit for bit its eager run (held as in 4e) and timed against it; then
     compile_unet_deepcache's (full, shallow) under each binding, eager
     against replay. Then SDXL 1024^2 4-step requests (batch 1,
     return_latents) under the default and all-kernel bindings in each mode:
     plain Euler, deep_cache=2, deep_cache=(2, 2), heun, dpmpp_2m, euler_a,
     and heun with deep_cache=2 and a guidance interval over the middle two
     steps; each mode twice (the first captures, the second replays with
     another prompt and seed), both bit for bit the eager loop on their
     inputs, one graph a signature, the replay counting the first call's
     launches key by key; each mode's replayed wall beside plain Euler's,
     its first call's pieces, and its deviation against the reference
     binding's eager loop of the same mode (max abs, MSE): at most
     MODE_MSE_RATIO x the binding's plain Euler MSE, all finite; and the
     ancestral noise of an image alone and in slot 1 of a batch of two,
     bit for bit (SD1.5's step cases run after 4e's SD1.5 step);
  5. serving: a ServingEngine over a full-width SDXL-base pipeline answers
     three 1024^2 requests (4 Euler steps, guidance 5), after the same three
     with other seeds, which capture each bucket's denoise loop: the counted
     requests replay and must count the first ones' launches key by key,
     in every serving phase (5-5e); the images must be
     finite, (1024, 1024, 3) and inside [-1, 1], and the attention (K1, K2,
     K3) and conv launch counters must have moved during this phase, every
     K1/K2 launch on its kernel as in phase 4 and each image's f32 decode on the
     3xTF32 conv 32 times and the direct conv once (conv_in), its attention
     once on the 3xTF32 GEMM; the kernel forms of GroupNorm, LayerNorm and
     GEGLU their per-step counts times the UNet steps run, and the decoder's
     GroupNorms once per image in f32;
  5b. a second ServingEngine, over a pipeline with the fused-op binding,
     answers two co-batched 1024^2 requests and one alone; same image
     checks, and the launch counters of K8-K11 must match the per-step
     counts times the UNet steps run (K9 also once per VAE GroupNorm per
     image), and the attention and decode convs as in phase 5;
  5d. a third, with the all-kernel binding: as 5b, and K12 must launch 2 a
     UNet step, K13 463 a step + 70 a generation (the precompute) + 4 an
     image (the f32 VAE mid-attention);
  5e. the reference binding (cuBLAS, cuDNN, SDPA) serves the same three
     requests as phase 5; the same seed alone and co-batched must differ by
     at most SOLO_VS_BATCHED_BOUND under each of the four bindings (and
     under SD1.5's default binding in 5c), and a kernel binding by at most
     SOLO_VS_BATCHED_RATIO times the reference binding's diff; then one
     1024^2 f32 decode under the default binding against the reference
     binding's (TF32 off): max abs (at most DECODE_MAX_ABS), MSE and each
     decode's time, logged;
  5c. with the SDXL weights freed, a ServingEngine over a full-width SD1.5
     pipeline (CLIP-L, one encoder; VAE scaling 0.18215) answers two
     co-batched 512^2 requests and one alone (4 Euler steps, guidance 7.5);
     the images must be finite, (512, 512, 3) and inside [-1, 1]; the
     K3/K4/K5 bf16 launches must be the per-step counts times the UNet
     steps run (K3 and K4 on attn_wgmma_bf16, K5 on the tiny-KV kernel),
     plus one f32 K3 launch per
     image for the VAE on the 3xTF32 GEMM; the decode convs and the kernel
     forms as in phase 5.
  6k. (after 3d) the twins at the shapes the image-conditioned paths give
     them and no earlier path did, against their plain versions as in phase
     3: the f32 VAE encoder's convs (conv_in Cin 3 -> 128 at 1024^2 on the
     direct kernel, 512^2 and 256^2 levels, conv_out 512 -> 8), the 9-channel
     inpainting conv_in, the SDXL refiner's GroupNorm-fused convs (Cin 384,
     1152, 2304), Transformer2D GroupNorm (768), LayerNorm, GEGLU and
     projections at its widths, its 5-slot time ids and its attention at
     h=12 and 24 (K2 S=4096, K1 S=1024 and 256, cross-attention on the
     tiny-KV kernel);
  6. (after 5e, before 5c) the image-conditioned paths at 1024^2, random
     weights, 4 Euler steps, batch 1, with the launch counters set to 0
     just before and read just after: one f32 VAE encode under the default
     and all-kernel bindings against the reference binding (TF32 off; max
     abs at most F32_REL_TOL of the largest latent), timed, with its
     launches by route and an encode -> decode round trip; then under the
     default and all-kernel bindings warmup followed by the same
     signature's first txt2img request (which must capture nothing),
     img2img_image on SDXL-base (strength 0.5), inpaint on the 9-channel
     SDXL UNet (SDXL-base's tensors with a new conv_in; a centred square
     mask; Euler, and Heun with a guidance interval and deep_cache=2) and
     TwoStageSDXL with the SDXL refiner (refiner_strength 0.25), each kind
     twice (the first call captures, the second replays): both bit for bit
     the eager loop on their inputs, the replay counting the first call's
     launches, the plain kinds' launches as their pieces count them (the
     refiner's per step from its config, written beside SDXL-base's), graph
     nodes, the first call's pieces, the replayed wall, and the MSE of the
     latents against the reference binding's same request (eager) at most
     MODE_MSE_RATIO x the binding's plain Euler txt2img MSE.
  7k. (after 6k) the twins at the shapes SD2.x's 768^2 path gives them (96^2
     latent, CFG batch 2) against their plain versions as in phase 3:
     attention at h=5 d=64 (self S=9216 on the K3 route, the first bf16 K3
     launch at d=64; cross against 77 keys on the K5 route), at h=10 / 20
     (K2, K1) and the f32 VAE's at S=9216; the UNet's convs at 96^2..12^2,
     the f32 VAE's at 96^2 and 768^2; the GN-fused conv, GroupNorm,
     LayerNorm, GEGLU and projections at 320 channels and the cross K/V
     precompute of a 1024-wide context; each row's launches are counted on
     phase 7c's path;
  7v. (after 7k) the twins at the shapes of the sd-2.1-768.batch8 cell
     (UNet batch 16 at a 96^2 latent, a group of 8 images at 768^2) against
     their plain versions as in phase 3: attention at h=5 d=64 (self S=9216
     on the K3 route, whose plain version runs a batch row at a time; cross
     against 77 keys on the K5 route) and at h=10 (K2, S=2304); the UNet's
     3x3 convs at level 0 (conv_in, 320->320, the up block's 960->320, the
     upsampler's 640->640, conv_out); the default binding's kernel forms as
     in phase 3f: GroupNorm+SiLU at 320, 640 and 960 channels, the
     Transformer2D's GroupNorm, LayerNorm over level 0's 147456 rows, GEGLU,
     and the f32 decoder's GroupNorm at 768^2; each row's launches are
     counted on phase 5v's path;
  5v. (after 5c) a ServingEngine over a full-width SD2.1-768 pipeline as the
     benchmark's configuration gives it (OpenCLIP-H's 23 layers read after
     final_layer_norm, pad id 0; SchedulerConfig(prediction_type=
     "v_prediction"); default binding) answers eight co-batched 768^2
     requests (a bucket of 8: UNet batch 16; 4 Euler steps, guidance 7.5),
     after eight with other seeds that capture the bucket's loop; the
     counters set to 0 just before and read just after the replayed group:
     every bf16 attention launch at b=16 and the per-step counts by kernel
     and class (K3 5, K2 5, K1 6 on attn_wgmma_bf16; K5 5, K1 11 on the
     tiny-KV kernel) times the UNet steps run, the kernel forms' per-step
     counts (SD1.5's topology) and the decoder's GroupNorms per image,
     each image's f32 decode as in phase 5, and every
     pipeline.loop span's prediction "v_prediction";
  7a. (after 5c) the native library (native/src/*.cpp, built with g++ into
     build/native/ beside the CUDA build): every entry bit for bit its numpy
     version on full-size inputs (a 1280x1280 bf16 / f16 / f32 weight, a
     (1280, 1280, 3, 3) conv weight, a 1024^2 image and its PNG, a long
     prompt's ids), each timed;
  7b. a full-width SDXL-base diffusers directory (f16, about 6.9 GB: the
     UNet, both encoders, the whole VAE, unet/config.json, synthetic
     tokenizer files) written by the port's safetensors writer into a
     temporary directory (the free disk checked first, the directory deleted
     at the end); load_sdxl, two prompt strings tokenized, two 4-step 1024^2
     requests (the first captures, the second replays), each image bit for
     bit the same request on a pipeline built in memory from the same f16
     arrays; the native PNG of one decodes back to to_rgb8's array; write,
     load and request seconds and the peak memory;
  7c. a full-width SD2.x SGM single file (f16, about 2.5 GB: the UNet, the
     OpenCLIP-H text tower, the VAE decoder) in a temporary directory;
     load_single_file_auto must find "sd2", set clip_skip=2 and load every
     tensor as written; two 4-step 768^2 requests under the default and the
     all-kernel binding (capture, replay), each bit for bit the eager loop on
     its inputs, the launch counters set to 0 just before and read just
     after; each binding's latent MSE against the reference binding's same
     request, printed beside SD1.5's step MSE of phase 4c;
  7d. a duck-typed full-width SDXL-base UNet module in torch layout (bf16 on
     the card) through frontends.diffusers.compile: two steps (capture,
     replay) bit for bit unet_apply on the compiled params, a DeepCache step
     pair, one CompVisUNetShim call with a 2816-wide y;
  8p. (after 7k, before any capture) runtime/profiling.py: bench_fn on K2's
     shape (self-attention S=4096 h=10 bf16) chained through q, within 10%
     of CUDA events on the same call; profiling.trace around a few of those
     launches, whose Chrome trace must name the attention kernel;
  8k. (after 8p) the turbo int8 ops at SDXL-base's 1024^2 shapes, bf16:
     linear_int8 at to_qkv, both ff ups, the cross K/V precompute and
     time_emb_proj at M = 2; conv2d_int8 at a 3x3 stride-1 conv with a
     (B, C) bias, the stride-2 downsampler and a 1x1 shortcut. The int8
     activations and int32 accumulators equal the CPU's; the output's max
     abs difference from the CPU op; each op's time beside the bare
     torch._int_mm (the weight as stored and row-major), the bf16
     kernel at that shape (K13, K6), one cuBLAS / cuDNN call and its bound
     at the int8 peak (1979 TOP/s) or the memory rate, its device time
     split into product and glue from profiling.trace;
  8a. (after 6) the SDXL-base step of phase 4 under CompileConfig(quantize=
     "int8" | "int8_ff" | "int8_conv") on the default binding and int8_conv
     on the fused-op one: the first call and a replay bit for bit the eager
     step; the replayed step timed by bench_fn chained through the sample,
     beside the bf16 step timed the same way and phase 4e's; its MSE and
     relative max error against the bf16 step, finite and not equal to it;
  8b. (after 8a) one 1024^2 4-step Euler request per turbo mode through
     SDXLPipeline (first: eager loop and capture; second: a replay), each
     bit for bit its eager loop, with its wall time, peak memory and the
     quantized UNet's weight bytes beside the bf16 one's. Turbo is a draft
     mode outside the 1e-3 fidelity gate.
  9t. (after 8b) autotune (kernels/autotune.py) from an empty table (no
     packaged file, a temporary user cache): ensure_tuned_for the SDXL-base
     1024^2 batch-1 signature under the all-kernel binding (shapes by op,
     wall time, the shapes moved off the fitted rule); the same signature
     through SDXLPipeline with ST_TPU_AUTOTUNE=1 tunes nothing, and every
     launch key of its captured loop names the table's plan; then the
     rule's two recorded misses ((154,1024)@(1024,640),
     (128,1280)@(1280,1280)), a K8 conv (128^2 320->320) and a tiny-KV
     attention (Sq 4096, Sk 77, h 10) tuned, each tuned plan held against
     the plain version and timed beside the rule's plan (in turns, twice
     each: a plan other than the rule's no slower beyond the two-run spread
     or 0.5%) and cuBLAS's addmm / SDPA,
     by the tuner's own measure (bench_fn over a graph of 10 launches);
  9p. (after 9t) the replayed SDXL-base step under the default, fused-op
     and all-kernel bindings with the packaged table beside the rules
     (table off), fresh graphs each, in turns; a record, not a claim;
  9f. (after 7d) fft_conv2d on the card, (1, 128, 128, 4) with a 9 x 9
     kernel, against F.conv2d in depthwise form (TF32 off);
  9m. (last) the mesh (runtime/mesh.py) over torch.distributed: two
     spawned ranks on the one card over gloo with a TCP store on
     localhost: data=1 model=2, the full-width SDXL-base step on rank-local
     shards (heads and feed-forward split, row-parallel all-reduces)
     against the unsharded step, MSE under the step gate; data=2 model=1,
     a replayed 1024^2 4-step txt2img of batch 2 against the unsharded
     pipeline's, max abs within SOLO_VS_BATCHED_BOUND. An NCCL mesh is not
     run (one card).

Each phase logs its peak device memory.

Prints a JSON line of per-kernel results, then as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Weights are random, made from fixed seeds; it needs no network. Phases 7b
and 7c write their checkpoints (about 9.4 GB in all) under the temporary
directory ($TMPDIR) and delete them.
"""

from __future__ import annotations

import ctypes
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import weakref
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

BF16_REL_TOL = 2e-2   # bf16 outputs: ~2-3 bf16 ulps of the largest value
F32_REL_TOL = 1e-4    # f32: summation order only
STEP_MSE_GATE = 1e-3  # the JAX package's fidelity gate
# the float32 scores the plain attention may hold at once: above it the plain
# version runs one batch row at a time (16 rows of 5 x 9216^2 are ~27 GB)
PLAIN_SCORES_MAX = 8 << 30
# one 1024^2 f32 decode under the default binding against the reference
# binding's (cuDNN, cuBLAS, SDPA; TF32 off), images in [-1, 1]: the kernels
# compute the same f32 function, 3xTF32 keeping ~f32 accuracy
DECODE_MAX_ABS = 5e-5
# the H100 SXM's published peaks (NVIDIA's data sheet, dense): bf16 on the
# tensor cores, f32 outside them, HBM3. The 3xTF32 conv does its f32
# products as three tf32 ones on the tensor cores, so its bound (and share)
# is taken at the TF32 peak over three, TF32X3_FLOPS (3 x flops at 495
# TFLOP/s); its bound at the f32 FMA peak, the rate of the scalar f32
# kernels, is printed beside it ("bound_f32_fma_ms")
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TF32X3_FLOPS = 495e12 / 3
MEMORY_BYTES_PER_S = 3.35e12


def log(*args):
    print(*args, flush=True)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(flops: float, moved: int, dtype, peak: float | None = None) -> tuple[float, str]:
    """The least time (ms) the card could take: the larger of the operations
    over the dtype's peak rate (or ``peak``) and the bytes (each input read
    once, each output written once) over the memory rate, and which of the
    two it is."""
    t_ops = flops / (peak or PEAK_FLOPS[dtype])
    t_mem = moved / MEMORY_BYTES_PER_S
    return max(t_ops, t_mem) * 1e3, ("operations" if t_ops >= t_mem else "bytes")


def timed_ms(fn, iters: int) -> float:
    """Mean device time of fn() over ``iters`` launches, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int) -> tuple[float, float | None, dict | None]:
    """Device time of one fn() call, its kernel launches a call and its
    device time a call by kernel name: the sums of its kernels' durations
    (torch.profiler's CUDA kernel events) over ``iters`` calls after one
    warm-up, so the host's gaps between launches do not count. Where three
    sessions running record no kernel (on the card's machine a profiler
    that did so once kept doing so for the rest of the process), the time
    by CUDA events instead, logged as such, with None for the rest."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(3):  # a session now and then records no kernel at all
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        spans = [(e.name, e.time_range.end - e.time_range.start) for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if spans:
            break
        log(f"  (profiler session {attempt + 1} recorded no kernel; profiling again)")
    if not spans:
        log("  (the profiler recorded no kernel; CUDA events instead, host gaps included)")
        return timed_ms(fn, iters), None, None
    by_name = {}
    for name, us in spans:
        by_name[name] = by_name.get(name, 0.0) + us / iters / 1e3
    return sum(by_name.values()), len(spans) / iters, by_name


def named_ms(by_name: dict | None, part: str) -> float | None:
    """The device ms a call of the kernels whose names hold ``part``, from
    device_ms's by-name times; None where the profiler recorded none."""
    return None if by_name is None else sum(ms for kn, ms in by_name.items() if part in kn)


def ms_text(ms: float | None) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def compare(name, kernel_fn, plain_fn, tol, iters, *, bound_ms, library_fn=None,
            library_label="library call", old_fn=None, old_label="old kernel", op_fn=None,
            op_label="reference-binding op"):
    """Run kernel and plain version on the same inputs; fail past ``tol``
    (max abs error relative to the largest plain output). Timed beside them:
    ``library_fn``, one PyTorch call computing the same function (the
    yardstick, never called by the port); ``old_fn``, the kernel a
    redesigned kernel replaced (``old_label``), at the same shape, where the
    tree still has it; ``op_fn``, another binding's op. ``bound_ms`` is (ms,
    "operations" or "bytes")."""
    out = kernel_fn()
    ref = plain_fn()
    torch.cuda.synchronize()
    if out.shape != ref.shape or out.dtype != ref.dtype:
        raise AssertionError(f"{name}: {out.shape}/{out.dtype} vs {ref.shape}/{ref.dtype}")
    if not torch.isfinite(out).all():
        raise AssertionError(f"{name}: kernel output is not finite")
    err = (out.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    rel = err / max(scale, 1e-30)
    ms = timed_ms(kernel_fn, iters)
    plain_ms = timed_ms(plain_fn, iters)
    r = {"max_abs_err": err, "max_rel_err": rel, "ms": ms, "plain_ms": plain_ms,
         "bound_ms": bound_ms[0], "bound_by": bound_ms[1],
         "library_ms": timed_ms(library_fn, iters) if library_fn is not None else None}
    # the device's own time a call, without the host's gaps between launches
    r["device_ms"], per_call, r["device_by_name"] = device_ms(kernel_fn, iters)
    if per_call is None:
        r["device_ms_source"] = "cuda events (the profiler recorded no kernel)"
    dev_extra = ""
    if library_fn is not None:
        r["library_device_ms"] = device_ms(library_fn, iters)[0]
        dev_extra = f", {library_label} {r['library_device_ms']:.4f} ms"
    extra = ""
    if old_fn is not None:
        r["old_ms"], r["old_kernel"] = timed_ms(old_fn, iters), old_label
        r["old_device_ms"] = device_ms(old_fn, iters)[0]
        extra += f", {old_label} {r['old_ms']:.4f} ms (device {r['old_device_ms']:.4f})"
    if r["library_ms"] is not None:
        extra += f", {library_label} {r['library_ms']:.4f} ms"
    if op_fn is not None:
        extra += f", {op_label} {timed_ms(op_fn, iters):.4f} ms"
    log(f"kernel {name}: max_abs_err={err:.3e} max_rel_err={rel:.3e} (tol {tol:g}) "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms{extra}; bound {bound_ms[0] * 1e3:.4g} us "
        f"({bound_ms[1]}), {bound_ms[0] / ms:.1%} of bound")
    log(f"  device time (profiler, kernels only): {r['device_ms']:.4f} ms in {per_call} "
        f"kernels a call, {bound_ms[0] / r['device_ms']:.1%} of bound{dev_extra}")
    if not rel <= tol:
        raise AssertionError(f"{name}: relative error {rel:.3e} exceeds {tol:g}")
    return r


# K9's shapes, (B, H, W, C), dtype, act and path: every GroupNorm input of
# the SDXL-base 1024^2 UNet step at CFG batch 2 in bf16 (the Transformer2D
# GroupNorms at 64^2 x 640 and 32^2 x 1280, act None; the fused conv's
# prologue, act SiLU, at the resnets' inputs, the skip concats included),
# SD1.5 512^2's Transformer2D GroupNorms at its four levels, and the f32
# VAE decoder's at batch 1 from 128^2 x 512 through 1024^2 x 128. A row's
# launches are its path's (main: phase 5b's fused-op serving, "sdxl", or
# phase 4c's SD1.5 fused-op step, "sd15"): K9 at its shape and the fused
# conv (K8, whose prologue runs K9's stats and fold) at its input shape.
K9_CASES = [
    ((2, 128, 128, 320), torch.bfloat16, "silu", "sdxl"),
    ((2, 128, 128, 640), torch.bfloat16, "silu", "sdxl"),
    ((2, 128, 128, 960), torch.bfloat16, "silu", "sdxl"),
    ((2, 64, 64, 640), torch.bfloat16, None, "sdxl"),
    ((2, 64, 64, 1280), torch.bfloat16, "silu", "sdxl"),
    ((2, 64, 64, 1920), torch.bfloat16, "silu", "sdxl"),
    ((2, 32, 32, 1280), torch.bfloat16, None, "sdxl"),
    ((2, 32, 32, 2560), torch.bfloat16, "silu", "sdxl"),
    ((2, 64, 64, 320), torch.bfloat16, None, "sd15"),
    ((2, 32, 32, 640), torch.bfloat16, None, "sd15"),
    ((2, 16, 16, 1280), torch.bfloat16, None, "sd15"),
    ((2, 8, 8, 1280), torch.bfloat16, None, "sd15"),
    ((1, 128, 128, 512), torch.float32, "silu", "sdxl"),
    ((1, 256, 256, 512), torch.float32, "silu", "sdxl"),
    ((1, 512, 512, 512), torch.float32, "silu", "sdxl"),
    ((1, 512, 512, 256), torch.float32, "silu", "sdxl"),
    ((1, 1024, 1024, 256), torch.float32, "silu", "sdxl"),
    ((1, 1024, 1024, 128), torch.float32, "silu", "sdxl"),
]


def k9_name(shape, dtype, act, path) -> str:
    return (f"group_norm {tuple(shape)} {'bf16' if dtype == torch.bfloat16 else 'f32'} "
            f"act={act}" + (" (SD1.5)" if path == "sd15" else ""))


def k9_launches(by_key: dict, hwc) -> int:
    """Launches of K9 on a path at an image shape (H, W, C): whole
    GroupNorms (K9's counter) and its stats and fold as the prologue of a
    fused conv whose input has that shape (K8's counter)."""
    h, w, c = hwc
    return (sum(n for key, n in by_key["K9"].items() if f" {h}x{w} c={c} " in key)
            + sum(n for key, n in by_key["K8"].items() if f" {h}x{w} {c}->" in key))


def phase_fused_kernels(dev):
    """K8-K11 against their plain versions at the fused-op path's shapes,
    each beside its library call where one PyTorch call computes the same
    function (K9 F.group_norm, K10 F.layer_norm / F.rms_norm; no single call
    computes K11's state * gelu(gate) or K8's GroupNorm-fused conv)."""
    import torch.nn.functional as F

    from stabletriton_tpu_torch.kernels import conv_direct as cd
    from stabletriton_tpu_torch.kernels import geglu as gg
    from stabletriton_tpu_torch.kernels import group_norm as gn
    from stabletriton_tpu_torch.kernels import layer_norm as ln
    from stabletriton_tpu_torch.ops import reference

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(4321)
    bf16, f32 = torch.bfloat16, torch.float32

    def randn(*shape, dtype=bf16, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale + shift).to(dtype)

    results = []

    def record(tpu, name, source, r, kernel=None):
        r.update(name=name, source=f"stabletriton_tpu_torch/csrc/{source}", tpu=tpu,
                 kernel=kernel)
        results.append(r)

    # K9 at every GroupNorm shape of the SDXL-base, SD1.5 and f32 VAE decoder
    # paths (K9_CASES): the whole GroupNorm against its plain version, the
    # same bits in a second run, F.group_norm on an NCHW copy made outside the
    # timed call (GroupNorm alone: the SiLU rows' library time leaves the
    # activation out), and the stats and fold alone (st_group_norm_fold, the
    # launch the fused conv's prologue makes) by device time beside its bound
    for shape, dtype, act, path in K9_CASES:
        x = randn(*shape, dtype=dtype, scale=2.0, shift=0.5)
        g, b = randn(shape[3], dtype=dtype, shift=1.0), randn(shape[3], dtype=dtype)
        kfn = lambda x=x, g=g, b=b, act=act: gn.group_norm(x, g, b, num_groups=32, act=act)
        pfn = lambda x=x, g=g, b=b, act=act: gn.group_norm_plain(x, g, b, num_groups=32,
                                                                 act=act)
        ofn = lambda x=x, g=g, b=b, act=act: (
            reference.group_norm_bf16apply if x.dtype == bf16 else reference.group_norm)(
                x, g, b, num_groups=32, act=act)
        nchw = x.permute(0, 3, 1, 2).contiguous()
        lfn = lambda x=nchw, g=g, b=b: F.group_norm(x, 32, g, b, 1e-5)
        name = k9_name(shape, dtype, act, path)
        iters = 5 if x.numel() > 2**26 else 20
        r = compare(name, kfn, pfn, BF16_REL_TOL if dtype == bf16 else F32_REL_TOL, iters,
                    bound_ms=bound(0, 2 * nbytes(x) + nbytes(g, b), dtype), library_fn=lfn,
                    library_label="F.group_norm", op_fn=ofn, op_label="default-binding op")
        if not torch.equal(kfn(), kfn()):
            raise AssertionError(f"{name}: two runs differ")
        r["fold_device_ms"] = device_ms(
            lambda x=x, g=g, b=b: gn.scale_shift(x, g, b, num_groups=32), iters)[0]
        r["fold_bound_ms"] = bound(0, nbytes(x, g, b) + 8 * shape[0] * shape[3], dtype)[0]
        log(f"  stats and fold alone: device {r['fold_device_ms']:.4f} ms, bound "
            f"{r['fold_bound_ms'] * 1e3:.4g} us ({r['fold_bound_ms'] / r['fold_device_ms']:.1%})")
        r["k9_path"], r["k9_hwc"] = path, (shape[1], shape[2], shape[3])
        record("K9", name, "group_norm.cu", r)
        del x, nchw

    # K10: the transformer LayerNorms, and RMSNorm through the same kernel
    for rows, c, rms in [(8192, 640, False), (2048, 1280, False), (8192, 640, True)]:
        x = randn(rows, c, scale=2.0, shift=0.3)
        g, b = randn(c, shift=1.0), randn(c)
        fn, plain = (ln.rms_norm, reference.rms_norm) if rms else (ln.layer_norm,
                                                                   reference.layer_norm_bf16apply)
        kfn = lambda x=x, g=g, b=b, fn=fn: fn(x, g, b, eps=1e-6)
        pfn = lambda x=x, g=g, b=b, rms=rms: ln.layer_norm_plain(x, g, b, eps=1e-6,
                                                                 rmsnorm=rms)
        ofn = lambda x=x, g=g, b=b, plain=plain: plain(x, g, b, eps=1e-6)
        lfn = ((lambda x=x, g=g, c=c: F.rms_norm(x, (c,), g, 1e-6)) if rms
               else (lambda x=x, g=g, b=b, c=c: F.layer_norm(x, (c,), g, b, 1e-6)))
        name = f"{'rms_norm' if rms else 'layer_norm'} ({rows}, {c}) bf16"
        record("K10", name, "layer_norm.cu",
               compare(name, kfn, pfn, BF16_REL_TOL, 50,
                       bound_ms=bound(0, 2 * nbytes(x) + nbytes(g, b), bf16), library_fn=lfn,
                       library_label="F.rms_norm" if rms else "F.layer_norm", op_fn=ofn,
                       op_label="default-binding op"))

    # K11: the halves of the feed-forward projection, read in place
    for b_, s_, n in [(2, 4096, 2560), (2, 1024, 5120)]:
        proj = randn(b_, s_, 2 * n, scale=2.0)
        state, gate = proj.chunk(2, dim=-1)
        kfn = lambda st=state, ga=gate: gg.geglu(st, ga)
        pfn = lambda st=state, ga=gate: gg.geglu_plain(st, ga)
        ofn = lambda st=state, ga=gate: reference.geglu(st, ga)
        name = f"geglu halves of ({b_}, {s_}, {2 * n}) bf16"
        record("K11", name, "geglu.cu",
               compare(name, kfn, pfn, BF16_REL_TOL, 20,
                       bound_ms=bound(0, nbytes(proj) + nbytes(proj) // 2, bf16), op_fn=ofn,
                       op_label="default-binding op"))
        del proj, state, gate

    # K8: GroupNorm + SiLU fused into the 3x3 conv, on the wgmma kernel
    # (conv_out's Cout = 4 on its 8-column tile); beside it the unfused pair
    # (K9 apply, then K6) on the same scale / shift
    for label, (b_, hh, ww, cin, cout), bias_kind, with_res in [
            ("resnet conv1 128x128 320->320 batch-bias", (2, 128, 128, 320, 320), "bb", False),
            ("resnet conv2 64x64 640->640 bias+residual", (2, 64, 64, 640, 640), "b", True),
            ("up resnet conv1 32x32 2560->1280 batch-bias", (2, 32, 32, 2560, 1280), "bb",
             False),
            ("SD1.5 resnet conv1 8x8 1280->1280 batch-bias", (2, 8, 8, 1280, 1280), "bb",
             False),
            ("conv_out 128x128 320->4", (2, 128, 128, 320, 4), "b", False)]:
        x = randn(b_, hh, ww, cin, scale=2.0, shift=0.5)
        scale, shift = gn.scale_shift(x, randn(cin, dtype=f32, scale=0.2, shift=1.0),
                                      randn(cin, dtype=f32, scale=0.2), num_groups=32, eps=1e-5)
        w = randn(3, 3, cin, cout, scale=1.0 / math.sqrt(9 * cin))
        bias = randn(b_, cout, dtype=f32) if bias_kind == "bb" else randn(cout)
        res = randn(b_, hh, ww, cout) if with_res else None
        args = (x, scale, shift, w, bias)
        kernel = cd.conv_variant(tuple(x.shape), cout, bf16, gn=True)
        kfn = lambda a=args, r=res: cd.gn_conv3x3(*a, residual=r, gn_act="silu")
        pfn = lambda a=args, r=res: cd.gn_conv3x3_plain(*a, residual=r, gn_act="silu")
        name = f"gn_conv3x3 {label}"
        flops = 2 * b_ * hh * ww * cout * 9 * cin
        moved = nbytes(x, w, bias, res, scale, shift) + b_ * hh * ww * cout * 2
        r = compare(name, kfn, pfn, BF16_REL_TOL, 10, bound_ms=bound(flops, moved, bf16))
        unfused = lambda a=args, r=res: cd.conv3x3(gn.apply(a[0], a[1], a[2], "silu"), a[3],
                                                     a[4], residual=r)
        r["unfused_ms"] = timed_ms(unfused, 10)
        log(f"  {kernel}; unfused pair (K9 apply + K6) {r['unfused_ms']:.4f} ms vs fused "
            f"{r['ms']:.4f} ms")
        record("K8", name, "conv3x3.cu", r, kernel)
        del x, w, res, args
    torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = True
    return results


# K8's rows (``--k8``): the parent tree's K8 at the same shapes, timed in a
# subprocess that imports that tree's package (it builds its own kernels
# under its build/); prints one JSON line of device ms by shape
K8_PARENT_TIMER = r"""
import json, sys, torch
from torch.profiler import ProfilerActivity, profile
from stabletriton_tpu_torch.kernels import conv_direct as cd, group_norm as gn
dev = torch.device("cuda", 0)
gen = torch.Generator(device=dev).manual_seed(24)
out = {}
for (b, h, cin, cout, res) in json.loads(sys.argv[1]):
    x = (torch.randn((b, h, h, cin), generator=gen, device=dev) * 2 + 0.5).to(torch.bfloat16)
    scale = torch.rand((b, cin), generator=gen, device=dev) + 0.5
    shift = torch.randn((b, cin), generator=gen, device=dev)
    w = (torch.randn((3, 3, cin, cout), generator=gen, device=dev) / (9 * cin) ** 0.5
         ).to(torch.bfloat16)
    bias = torch.randn((b, cout), generator=gen, device=dev)
    r = (torch.randn((b, h, h, cout), generator=gen, device=dev).to(torch.bfloat16)
         if res else None)
    fn = lambda: cd.gn_conv3x3(x, scale, shift, w, bias, residual=r, gn_act="silu")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    before = dict(cd.GN_LAUNCHES.by_key)
    fn()
    key = [k for k, n in cd.GN_LAUNCHES.by_key.items() if n != before.get(k, 0)]
    out[f"{b} {h} {cin} {cout} {int(res)}"] = [us / 10 / 1e3, key[0] if key else None]
print("K8_PARENT " + json.dumps(out))
"""


def k8_shapes(batch: int) -> list[tuple]:
    """(b, h, cin, cout, residual, per step) of every K8 launch at Cout > 8
    of the SDXL-base 1024^2 UNet step at UNet batch ``batch`` (CFG pairs of
    batch / 2 images), as the fused-op binding dispatches them (the step run
    on the meta device with a probe in gn_conv2d's place)."""
    from stabletriton_tpu_torch.kernels import autotune
    from stabletriton_tpu_torch.models.unet import sdxl_base_unet_config
    from stabletriton_tpu_torch.ops import reference

    per_step: dict = {}

    def probe(x, gamma, beta, w, b=None, *, residual=None, **kw):
        if w.shape[3] > 8:
            key = (int(x.shape[0]), int(x.shape[1]), int(w.shape[2]), int(w.shape[3]),
                   residual is not None)
            per_step[key] = per_step.get(key, 0) + 1
        return reference.gn_conv2d(x, gamma, beta, w, b, residual=residual, **kw)

    autotune._probe_unet(sdxl_base_unet_config(), 128, 128, batch // 2, 2,
                         {"conv2d": "reference", "gn_conv2d": "_shape_probe"},
                         {"gn_conv2d": probe})
    return [(*k, c) for k, c in sorted(per_step.items())]


def phase_k8(dev, parent_dir=None):
    """``--k8``: K8 at every shape it serves in the SDXL-base 1024^2 step at
    UNet batch 2 and 16 (and the refiner's, SD2's 96^2 320 -> 320, SD1.5's
    split 8^2 2560 -> 1280): against its plain version (2e-2), the normalised
    operand equal to K9's apply bit for bit (a centre-tap identity weight,
    Cin = Cout, borders included), and its device time beside its bound
    (operations at 989 TFLOP/s), the unfused pair (K9 apply + K6, on the same
    scale / shift) and, with ``parent_dir``, the parent tree's K8 (timed in a
    subprocess on the same card). Returns the rows."""
    from stabletriton_tpu_torch.kernels import conv_direct as cd
    from stabletriton_tpu_torch.kernels import group_norm as gn

    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(24)
    bf16 = torch.bfloat16
    cases = [(b, h, cin, cout, res, n) for batch in (2, 16)
             for (b, h, cin, cout, res, n) in k8_shapes(batch)]
    # the refiner's convs, SD2's 96^2 and SD1.5's split 8^2
    cases += [(2, 128, 384, 384, False, 0), (2, 128, 1152, 384, False, 0),
              (2, 64, 2304, 768, False, 0), (2, 96, 320, 320, False, 0),
              (2, 8, 2560, 1280, False, 0)]
    parent = {}
    if parent_dir:
        t0 = time.perf_counter()
        run = subprocess.run(
            [sys.executable, "-c", K8_PARENT_TIMER,
             json.dumps([[b, h, cin, cout, res] for b, h, cin, cout, res, _ in cases])],
            cwd=parent_dir, capture_output=True, text=True,
            env={**os.environ, "PYTHONPATH": os.path.abspath(parent_dir)})
        if run.returncode != 0:
            raise AssertionError(f"the parent's K8 timer failed: {run.stderr[-3000:]}")
        line = [ln for ln in run.stdout.splitlines() if ln.startswith("K8_PARENT ")][-1]
        parent = json.loads(line[len("K8_PARENT "):])
        log(f"parent K8 timed in {time.perf_counter() - t0:.1f} s (its build included)")
    rows = []
    for b, h, cin, cout, res, per_step in cases:
        x = randn_gen(gen, dev, (b, h, h, cin), scale=2.0, shift=0.5)
        scale = torch.rand((b, cin), generator=gen, device=dev) + 0.5
        shift = torch.randn((b, cin), generator=gen, device=dev)
        w = randn_gen(gen, dev, (3, 3, cin, cout), scale=1.0 / math.sqrt(9 * cin))
        bias = torch.randn((b, cout), generator=gen, device=dev)
        r = randn_gen(gen, dev, (b, h, h, cout)) if res else None
        fused = lambda: cd.gn_conv3x3(x, scale, shift, w, bias, residual=r, gn_act="silu")
        pair = lambda: cd.conv3x3(gn.apply(x, scale, shift, "silu"), w, bias, residual=r)
        before = dict(cd.GN_LAUNCHES.by_key)
        out = fused()
        (key,) = [k for k, n in cd.GN_LAUNCHES.by_key.items() if n != before.get(k, 0)]
        if not key.startswith("wgmma_gn_bf16 "):
            raise AssertionError(f"K8 {b} {h}^2 {cin}->{cout}: launched {key}")
        if not torch.equal(fused(), out):
            raise AssertionError(f"K8 {key}: two runs differ")
        ref = cd.gn_conv3x3_plain(x, scale, shift, w, bias, residual=r, gn_act="silu")
        rel = ((out.float() - ref.float()).abs().max() / ref.float().abs().max()).item()
        if not rel <= BF16_REL_TOL:
            raise AssertionError(f"K8 {key}: relative error {rel:.3e}")
        del ref
        if not res and cin == cout:
            # the centre-tap identity: the output is the normalised operand
            eye = torch.zeros((3, 3, cin, cout), device=dev, dtype=bf16)
            eye[1, 1] = torch.eye(cin, device=dev, dtype=bf16)
            got = cd.gn_conv3x3(x, scale, shift, eye, gn_act="silu")
            if not torch.equal(got, gn.apply(x, scale, shift, "silu")):
                raise AssertionError(f"K8 {key}: the normalised operand is not K9's apply")
        flops = 2 * b * h * h * cout * 9 * cin
        moved = nbytes(x, w, bias, r, scale, shift) + b * h * h * cout * 2
        bound_ms, bound_by = bound(flops, moved, bf16)
        ms = device_ms(fused, 10)[0]
        pair_ms = device_ms(pair, 10)[0]
        pk = f"{b} {h} {cin} {cout} {int(res)}"
        parent_ms, parent_key = parent.get(pk, (None, None))
        row = {"shape": [b, h, h, cin, cout], "residual": res, "per_step": per_step, "key": key,
               "max_rel_err": rel, "device_ms": ms, "bound_ms": bound_ms, "bound_by": bound_by,
               "unfused_pair_ms": pair_ms, "parent_ms": parent_ms, "parent_key": parent_key}
        rows.append(row)
        log(f"K8 {key}{' +res' if res else ''} ({per_step} a step): device {ms:.4f} ms "
            f"({bound_ms / ms:.1%} of {bound_ms * 1e3:.4g} us {bound_by}); unfused pair "
            f"{pair_ms:.4f} ms ({pair_ms / ms:.2f}x); parent {ms_text(parent_ms)}"
            + (f" ({parent_ms / ms:.2f}x, {parent_key})" if parent_ms else "")
            + f"; rel err {rel:.2e}")
        del x, w, r, out
    torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = True
    for batch in (2, 16):
        sel = [r for r in rows if r["shape"][0] == batch and r["per_step"]]
        step = {k: sum(r[k] * r["per_step"] for r in sel if r[k] is not None)
                for k in ("device_ms", "unfused_pair_ms", "parent_ms", "bound_ms")}
        log(f"K8 a step at UNet batch {batch} ({sum(r['per_step'] for r in sel)} launches): "
            + ", ".join(f"{k} {v:.3f}" for k, v in step.items()))
    return rows


def randn_gen(gen, dev, shape, scale=1.0, shift=0.0, dtype=torch.bfloat16):
    return (torch.randn(shape, generator=gen, device=dev) * scale + shift).to(dtype)


# (label, class, operand form, shape, dtype, timing iterations); shapes are
# (B, S, C, H) for the fused QKV buffer ("qkv") and separate q, k, v
# ("qkv3"), (B, Sq, Sk, C, H) against the fused KV buffer ("kv")
SDXL_ATTENTION_CASES = [
    ("self S=1024 h=20 bf16", "K1", "qkv", (2, 1024, 1280, 20), torch.bfloat16, 20),
    ("cross Sq=4096 Sk=77 h=10 bf16", "K1", "kv", (2, 4096, 77, 640, 10), torch.bfloat16, 20),
    ("cross Sq=1024 Sk=77 h=20 bf16", "K1", "kv", (2, 1024, 77, 1280, 20), torch.bfloat16, 20),
    ("self S=4096 h=10 bf16", "K2", "qkv", (2, 4096, 640, 10), torch.bfloat16, 10),
    ("vae S=16384 h=1 d=512 f32", "K3", "qkv3", (1, 16384, 512, 1), torch.float32, 2),
]

# the SD1.5 512^2 path's attention shapes (8 heads, d = C/8), CFG batch 2
SD15_ATTENTION_CASES = [
    ("self S=4096 h=8 d=40 bf16", "K3", "qkv", (2, 4096, 320, 8), torch.bfloat16, 10),
    ("self S=1024 h=8 d=80 bf16", "K4", "qkv", (2, 1024, 640, 8), torch.bfloat16, 20),
    ("self S=256 h=8 d=160 bf16", "K4", "qkv", (2, 256, 1280, 8), torch.bfloat16, 20),
    ("cross Sq=4096 Sk=77 h=8 d=40 bf16", "K5", "kv", (2, 4096, 77, 320, 8), torch.bfloat16,
     20),
    ("cross Sq=1024 Sk=77 h=8 d=80 bf16", "K5", "kv", (2, 1024, 77, 640, 8), torch.bfloat16,
     20),
    ("cross Sq=256 Sk=77 h=8 d=160 bf16", "K5", "kv", (2, 256, 77, 1280, 8), torch.bfloat16,
     20),
    ("self S=64 h=8 d=160 bf16 (mid)", "K5", "qkv", (2, 64, 1280, 8), torch.bfloat16, 20),
    ("vae S=4096 h=1 d=512 f32", "K3", "qkv3", (1, 4096, 512, 1), torch.float32, 5),
]


def routed_kernel(dtype, b, sq, sk, h, d, kind) -> str:
    """The kernel the attention route launches for a shape and entry point
    ("qkv", "kv", else the split interface): the autotune table's where it
    has the shape, else kernel_name's rule."""
    from stabletriton_tpu_torch.kernels import flash_attention as fa

    entry = kind if kind in ("qkv", "kv") else "attention"
    c = h * d
    offsets = {"qkv": (0, c, 2 * c), "kv": (0, 0, c)}.get(entry, (0, 0, 0))
    return fa._route(dtype, b, sq, sk, h, d, None, None, offsets, entry).kernel


def attention_cases(randn, cases, record=True):
    """Each attention case: the wrapper against attention_plain on the same
    inputs, beside F.scaled_dot_product_attention on (B, h, S, d) copies made
    outside the timed call. The launch must carry the case's class in its
    counter key, and the kernel the path launches at the shape: the
    route's, which reads the autotune table. Where the table sends the
    shape off the fitted rule's kernel (kernel_name), the row is named
    "(tuned table)", and the rule's kernel is held against the plain
    version on the same inputs too and timed (rule_kernel, rule_ms,
    rule_max_abs_err), so each kernel stays held at every shape its rule
    gives it."""
    import torch.nn.functional as F

    from stabletriton_tpu_torch.kernels import flash_attention as fa

    def heads(t, h):
        b, s, c = t.shape
        return t.reshape(b, s, h, c // h).transpose(1, 2).contiguous()

    results = []
    for label, tpu, kind, shape, dtype, iters in cases:
        tol = BF16_REL_TOL if dtype == torch.bfloat16 else F32_REL_TOL
        if kind == "qkv":
            b, s, c, h = shape
            qkv = randn(b, s, 3 * c, dtype=dtype)
            kfn = lambda qkv=qkv, h=h: fa.flash_attention_qkv(qkv, num_heads=h)
            pfn = lambda qkv=qkv, h=h: fa.attention_plain(*qkv.chunk(3, -1), num_heads=h)
            if b * h * s * s * 4 > PLAIN_SCORES_MAX:
                pfn = lambda qkv=qkv, h=h: torch.cat([  # noqa: E731
                    fa.attention_plain(*row.chunk(3, -1), num_heads=h) for row in qkv.split(1)])
            q, k, v = qkv.chunk(3, -1)
            sq, sk, inputs = s, s, (qkv,)
        elif kind == "kv":
            b, sq, sk, c, h = shape
            q, kv = randn(b, sq, c, dtype=dtype), randn(b, sk, 2 * c, dtype=dtype)
            kfn = lambda q=q, kv=kv, h=h: fa.flash_attention_kv(q, kv, num_heads=h)
            pfn = lambda q=q, kv=kv, h=h: fa.attention_plain(q, *kv.chunk(2, -1), num_heads=h)
            k, v = kv.chunk(2, -1)
            inputs = (q, kv)
        else:
            b, s, c, h = shape
            q, k, v = (randn(b, s, c, dtype=dtype) for _ in range(3))
            kfn = lambda q=q, k=k, v=v, h=h: fa.flash_attention(q, k, v, num_heads=h)
            pfn = lambda q=q, k=k, v=v, h=h: fa.attention_plain(q, k, v, num_heads=h)
            sq, sk, inputs = s, s, (q, k, v)
        qh, kh, vh = heads(q, h), heads(k, h), heads(v, h)
        lfn = lambda qh=qh, kh=kh, vh=vh: F.scaled_dot_product_attention(qh, kh, vh)
        flops = 4 * b * h * sq * sk * (c // h)
        moved = nbytes(*inputs) + b * sq * c * qh.element_size()
        before = dict(fa.LAUNCHES.by_key)
        want = routed_kernel(dtype, b, sq, sk, h, c // h, kind)
        rule = fa.kernel_name(dtype, sk)
        name = f"flash_attention {label}" + (" (tuned table)" if want != rule else "")
        f32 = dtype == torch.float32
        r = compare(name, kfn, pfn, tol, iters,
                    bound_ms=bound(flops, moved, dtype, TF32X3_FLOPS if f32 else None),
                    library_fn=lfn, library_label="SDPA")
        if f32:
            # the 3xTF32 GEMM's bound (above) and the f32 FMA one; the operand
            # split (plain torch, inside the kernel's time)
            r["bound_f32_fma_ms"] = bound(flops, moved, dtype)[0]
            r["prep_ms"] = timed_ms(lambda k=k, v=v, h=h: fa.tf32_attention_operands(k, v, h),
                                    iters)
            log(f"  bound in 3xTF32 (above); at the f32 FMA peak {r['bound_f32_fma_ms']:.4f} ms; "
                f"the wrapper's K / V^T split (tf32_attention_operands, inside the kernel's "
                f"time) {r['prep_ms']:.4f} ms; {fa.attention_chunk_rows(b * h, sq, sk)} query "
                f"rows a chunk")
        keys = {k for k, n in fa.LAUNCHES.by_key.items() if n != before.get(k, 0)}
        if {tuple(k.split()[:2]) for k in keys} != {(tpu, want)}:
            raise AssertionError(f"{name}: launched {sorted(keys)}, expected class {tpu} on "
                                 f"{want}")
        key = sorted(keys)[0]
        log(f"  launch key: {key}")
        if want != rule:
            # the rule's kernel at the same inputs, named past the route
            operands = ((qkv, 0, qkv, c, qkv, 2 * c) if kind == "qkv" else (q, 0, kv, 0, kv, c))
            rfn = lambda operands=operands, h=h: fa._launch(  # noqa: E731
                *operands, sq=sq, sk=sk, num_heads=h, d=c // h, scale=None, kernel=rule,
                entry=kind)
            ref = pfn()
            rule_err = (rfn().float() - ref.float()).abs().max().item()
            torch.cuda.synchronize()
            if not rule_err <= tol * ref.float().abs().max().item():
                raise AssertionError(f"{name}: the rule's kernel {rule} is off the plain version "
                                     f"by {rule_err:.3e}")
            r.update(rule_kernel=rule, rule_ms=timed_ms(rfn, iters), rule_max_abs_err=rule_err)
            log(f"  the table's kernel {want}; the rule's {rule} at the same inputs: "
                f"max_abs_err={rule_err:.3e}, {r['rule_ms']:.4f} ms against {r['ms']:.4f}")
        if dtype == torch.bfloat16 and sk <= fa.LANES:
            # every bf16 kernel of the C entry at the same operands (launched
            # past the route, after the key check), device time a call: the
            # measurement behind which kernel the route gives Sk <= 128 (K5,
            # and SDXL's K1 cross-attention)
            operands = ((qkv, 0, qkv, c, qkv, 2 * c) if kind == "qkv" else (q, 0, kv, 0, kv, c))
            r["alt_device_ms"] = {name: device_ms(
                lambda name=name: fa._launch(*operands, sq=sq, sk=sk, num_heads=h, d=c // h,
                                             scale=None, kernel=name), iters)[0]
                for name in fa._KERNEL_CODES}
            log(f"  {tpu} {label}, device ms a call by kernel at the same operands: "
                + ", ".join(f"{n} {ms:.4f}" for n, ms in r["alt_device_ms"].items())
                + f", SDPA {r['library_device_ms']:.4f}; bound {r['bound_ms'] * 1e3:.4g} us")
        r.update(name=name, source="stabletriton_tpu_torch/csrc/flash_attention.cu", tpu=tpu,
                 kernel=" ".join(key.split()[:2]))
        if record:
            results.append(r)
        del qh, kh, vh
    torch.cuda.empty_cache()
    return results


def phase_sd15_attention(dev):
    """Phase 3c: K3 (bf16, d=40), K4 and K5 at the SD1.5 path's shapes, then
    phase 3's d=64 rows again (the same template; their spread between the
    two phases is the timing noise of this run)."""
    gen = torch.Generator(device=dev).manual_seed(4242)

    def randn(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    results = attention_cases(randn, SD15_ATTENTION_CASES)
    log("phase 3's d=64 rows again:")
    attention_cases(randn, SDXL_ATTENTION_CASES[:4], record=False)
    return results


# C4: (form, b, sq, sk, h, d, live keys, class) of division_probe on each
# route of the bf16 kernels: K1 self off the fused QKV buffer and cross off
# the fused KV buffer (the tiny-KV kernel at Sk <= 128, the KV loop above;
# SDXL's 77 keys with 56 live), K2 past 1024 keys, K3 bf16 at d = 40 (h = 1
# on both kernels, unpacked heads past 1024 keys), K4 at d = 80 and 160, K5
# at d = 40, 80, 160 and SD1.5's mid-block self-attention (S = 64 with 56
# live keys: a power-of-two row sum divides exactly either way); the list of
# tests/test_torch_port_gpu.py's C4 test
C4_ROUTES = (
    [("qkv", 2, s, s, 2, 64, s, "K1") for s in (28, 56, 112, 224)]
    + [("kv", 2, 300, s, 2, 64, s, "K1") for s in (28, 56, 112)]
    + [("kv", 2, 1024, 77, 10, 64, 56, "K1"),
       ("qkv", 1, 1792, 1792, 2, 64, 1792, "K2"),
       ("sep", 2, 300, 28, 1, 40, 28, "K3"),
       ("sep", 2, 300, 224, 1, 40, 224, "K3"),
       ("qkv", 1, 1792, 1792, 2, 40, 1792, "K3")]
    + [("qkv", 2, s, s, 2, d, s, "K4") for d in (80, 160) for s in (224, 448)]
    + [("kv", 2, 300, s, 2, d, s, "K5") for d in (40, 80, 160) for s in (28, 56, 112)]
    + [("qkv", 2, 64, 64, 8, 160, 56, "K5")]
)


# the epilogue's out-of-range outputs: (form, b, sq, sk, h, d, live keys a
# half, class) of range_probe on each bf16 kernel and head dim; the list of
# tests/test_torch_port_gpu.py's out-of-range test
RANGE_ROUTES = [
    ("kv", 2, 300, 56, 2, 64, 28, "K1"),
    ("kv", 2, 300, 77, 10, 64, 28, "K1"),
    ("qkv", 2, 224, 224, 2, 64, 112, "K1"),
    ("sep", 2, 300, 224, 1, 40, 112, "K3"),
    ("qkv", 2, 224, 224, 2, 80, 112, "K4"),
    ("kv", 2, 300, 112, 2, 40, 56, "K5"),
    ("kv", 2, 300, 112, 2, 80, 56, "K5"),
    ("kv", 2, 300, 112, 2, 160, 56, "K5"),
    ("qkv", 2, 64, 64, 8, 160, 28, "K5"),
]


def probe_run(fa, dev, form, h, q, k, v):
    """One launch of the bf16 attention on a probe's operands (fa: the
    attention module; q, k, v float32 holding bf16 values)."""
    q, k, v = (t.to(torch.bfloat16).to(dev) for t in (q, k, v))
    if form == "qkv":
        out = fa.flash_attention_qkv(torch.cat([q, k, v], -1), num_heads=h)
    elif form == "kv":
        out = fa.flash_attention_kv(q, torch.cat([k, v], -1), num_heads=h)
    else:
        out = fa.flash_attention(q, k, v, num_heads=h)
    torch.cuda.synchronize()
    return out


def phase_c4(dev):
    """Phase 3e: C4 on every route of the bf16 attention kernels (K1-K5):
    each output of division_probe is the f32 quotient x / l rounded once
    to bf16, on inputs where x * f32(1 / l) rounds to another bf16 for every
    output; and so is each output of range_probe, whose zeros, tiny, huge,
    infinite and NaN outputs (NaN by position) the epilogue stores with the
    division. Fails on any output that differs and on a launch off its
    class or kernel. Each route is the fitted rule's (the autotune table
    off), so each kernel is probed where its class puts it."""
    from stabletriton_tpu_torch.kernels import autotune

    with autotune.disabled():
        _phase_c4(dev)


def _phase_c4(dev):
    from stabletriton_tpu_torch.kernels import flash_attention as fa

    outputs = 0
    cases = ([("C4", r, fa.division_probe(*r[1:7], seed=r[3] + r[5] + r[4])) for r in C4_ROUTES]
             + [("range", r, fa.range_probe(*r[1:7], seed=r[3] + r[5] + r[4]))
                for r in RANGE_ROUTES])
    for probe, (form, b, sq, sk, h, d, live, cls), ops in cases:
        before = dict(fa.LAUNCHES.by_key)
        out = probe_run(fa, dev, form, h, *ops[:3])
        if probe == "C4":
            want = (ops[3] / live).to(torch.bfloat16)[:, None, :].expand(-1, sq, -1)
        else:
            want = (ops[3] / ops[4][..., None]).to(torch.bfloat16)
        want = want.to(dev)
        keys = sorted(k for k, n in fa.LAUNCHES.by_key.items() if n != before.get(k, 0))
        kernel = fa.kernel_name(torch.bfloat16, sk)
        nan = want.isnan()
        differ = int((out.isnan() != nan).sum()) + int(
            (out.view(torch.int16)[~nan] != want.view(torch.int16)[~nan]).sum())
        log(f"{probe} {form} b={b} sq={sq} sk={sk} h={h} d={d} l={live}: {keys}, {differ} of "
            f"{out.numel()} outputs differ from bf16(x / l)")
        if [k.split()[:2] for k in keys] != [[cls, kernel]]:
            raise AssertionError(f"{probe} {form} sk={sk} d={d}: launched {keys}, expected "
                                 f"{cls} on {kernel}")
        if differ:
            raise AssertionError(f"{probe} {form} sk={sk} d={d}: {differ} outputs differ")
        outputs += out.numel()
    log(f"C4: {len(cases)} launches ({len(RANGE_ROUTES)} with outputs out of the Markstein "
        f"step's range), all {outputs} outputs bf16(x / l) bit for bit")


# K13 at the shapes of both paths: (label, M, K, N, bias, act, dtype, timing
# iterations); "+b" marks a bias
LINEAR_CASES = [
    ("SDXL to_qkv (8192,640)@(640,1920)", 8192, 640, 1920, False, None, torch.bfloat16, 20),
    ("SDXL ff proj (2048,1280)@(1280,10240)+b", 2048, 1280, 10240, True, None, torch.bfloat16,
     10),
    ("SDXL ff out (2048,5120)@(5120,1280)+b", 2048, 5120, 1280, True, None, torch.bfloat16, 10),
    ("SDXL cross K/V precompute (154,2048)@(2048,2560)", 154, 2048, 2560, False, None,
     torch.bfloat16, 20),
    ("SDXL time MLP (2,1280)@(1280,1280)+b", 2, 1280, 1280, True, None, torch.bfloat16, 50),
    ("SDXL add embedding (2,2816)@(2816,1280)+b", 2, 2816, 1280, True, None, torch.bfloat16,
     50),
    ("SDXL time_emb_proj (2,1280)@(1280,320)+b", 2, 1280, 320, True, None, torch.bfloat16, 50),
    ("SDXL time_emb_proj (2,1280)@(1280,640)+b", 2, 1280, 640, True, None, torch.bfloat16, 50),
    ("SD1.5 to_qkv (8192,320)@(320,960)", 8192, 320, 960, False, None, torch.bfloat16, 20),
    ("SD1.5 8x8 level (128,1280)@(1280,1280)+b", 128, 1280, 1280, True, None, torch.bfloat16,
     50),
    ("VAE f32 (16384,512)@(512,512)+b", 16384, 512, 512, True, None, torch.float32, 10),
    ("SD1.5 VAE f32 (4096,512)@(512,512)+b", 4096, 512, 512, True, None, torch.float32, 20),
    ("act=silu (2,320)@(320,1280)+b", 2, 320, 1280, True, "silu", torch.bfloat16, 50),
    ("act=gelu (2048,1280)@(1280,5120)+b", 2048, 1280, 5120, True, "gelu", torch.bfloat16, 10),
]


def phase_optional_kernels(dev):
    """Phase 3d: K12 (time_embed), K13 (linear, every variant the paths
    run, beside cuBLAS's addmm of the same GEMM) and K14 (dropout) against
    their plain versions. K14 runs through the op dispatch under a
    ("dropout", "cuda") binding, its path (no model reaches dropout); its
    output must equal the plain version bit for bit, repeat itself, change
    with the seed, and drop a fraction within 4 sigma of the rate."""
    from stabletriton_tpu_torch import ops
    from stabletriton_tpu_torch.compile import CompileConfig, resolve_binding
    from stabletriton_tpu_torch.kernels import build
    from stabletriton_tpu_torch.kernels import dropout as dr
    from stabletriton_tpu_torch.kernels import linear as lin
    from stabletriton_tpu_torch.kernels import time_embed as te

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(4444)
    results = []

    def record(tpu, name, source, r, **extra):
        r.update(name=name, source=f"stabletriton_tpu_torch/csrc/{source}", tpu=tpu, **extra)
        results.append(r)

    # K12: the SDXL timesteps (and SD1.5's, the same shape) and time_ids; no
    # single PyTorch call computes the sinusoidal embedding. Beside each row
    # the launch floor: the device time of an empty kernel (one block of 32
    # threads, st_launch_floor), the least a launch takes
    floor_entry = build.function("st_launch_floor", [ctypes.c_void_p])
    floor_ms = device_ms(lambda: floor_entry(build.current_stream(dev)), 50)[0]
    for t_vals, dim in [([999.0, 999.0], 320), ([1024.0, 1024, 0, 0, 1024, 1024] * 2, 256)]:
        t = torch.tensor(t_vals, device=dev)
        name = f"time_embed ({len(t_vals)},)->({len(t_vals)},{dim}) f32"
        r = compare(name, lambda t=t, dim=dim: te.time_embed(t, dim=dim),
                    lambda t=t, dim=dim: te.time_embed_plain(t, dim=dim), F32_REL_TOL, 50,
                    bound_ms=bound(0, nbytes(t) * (1 + dim), torch.float32))
        if r["max_abs_err"] != 0:
            raise AssertionError(f"{name}: not the plain version's bits")
        r["launch_floor_ms"] = floor_ms
        log(f"  launch floor (an empty kernel, device time) {floor_ms:.4f} ms; K12 "
            f"{r['device_ms']:.4f} ms, {r['device_ms'] / floor_ms:.2f}x the floor")
        record("K12", name, "time_embed.cu", r)

    # K13: each variant at the paths' shapes, cuBLAS's addmm of the same GEMM
    # as the library call; the wgmma rows also time the WMMA kernel (element
    # loads: the route of the shapes TMA cannot take), launched through the
    # wrapper's internal launch
    for label, m, k, n, has_bias, act, dtype, iters in LINEAR_CASES:
        x = torch.randn((m, k), generator=gen, device=dev).to(dtype)
        if "time MLP" in label or "time_emb_proj" in label:
            x = torch.nn.functional.silu(x)  # these read silu of the time embedding
        w = (torch.randn((k, n), generator=gen, device=dev) / math.sqrt(k)).to(dtype)
        b = torch.randn(n, generator=gen, device=dev).to(dtype) if has_bias else None
        before = dict(lin.LAUNCHES.by_key)
        name = f"linear {label}" + (f" act={act}" if act and "act=" not in label else "")
        kernel = lin.variant(m, k, n, dtype)
        f32 = dtype == torch.float32
        flops, moved = 2 * m * n * k, nbytes(x, w, b) + m * n * x.element_size()
        r = compare(name, lambda x=x, w=w, b=b, act=act: lin.linear(x, w, b, act=act),
                    lambda x=x, w=w, b=b, act=act: lin.linear_plain(x, w, b, act=act),
                    F32_REL_TOL if f32 else BF16_REL_TOL, iters,
                    bound_ms=bound(flops, moved, dtype,
                                   TF32X3_FLOPS if kernel == "wgmma_tf32x3" else None),
                    library_fn=(lambda x=x, w=w, b=b: torch.addmm(b, x, w)) if b is not None
                    else (lambda x=x, w=w: x @ w), library_label="cuBLAS addmm",
                    old_fn=(lambda x=x, w=w, b=b, act=act: lin._launch(x, w, b, act,
                                                                      "wmma_bf16")[0])
                    if kernel == "wgmma_bf16" else None, old_label="WMMA kernel")
        if kernel == "wgmma_tf32x3":
            # the 3xTF32 GEMM's bound (above) and the f32 FMA one; on the
            # device, the w^T split kernel (inside the row's time) and the GEMM
            r["bound_f32_fma_ms"] = bound(flops, moved, dtype)[0]
            r["prep_ms"] = named_ms(r["device_by_name"], "tf32_split")
            gemm_ms = named_ms(r["device_by_name"], "gemm_wgmma_tf32x3")
            log(f"  bound in 3xTF32 (above); at the f32 FMA peak {r['bound_f32_fma_ms']:.4f} ms; "
                f"on the device the w^T split kernel {ms_text(r['prep_ms'])}, the GEMM "
                f"{ms_text(gemm_ms)}" + ("" if gemm_ms is None else
                                         f" ({r['bound_ms'] / max(gemm_ms, 1e-9):.1%} of bound)"))
        keys = {key for key, c in lin.LAUNCHES.by_key.items() if c != before.get(key, 0)}
        if len(keys) != 1 or not next(iter(keys)).startswith(kernel + " "):
            raise AssertionError(f"{name}: launched {sorted(keys)}, expected {kernel}")
        log(f"  launch key: {sorted(keys)[0]}")
        record("K13", name, "linear.cu", r, kernel=kernel, shape=(m, k, n))
        del x, w, b

    # K14: through the op dispatch, its path; bit-equal to the plain version
    binding = resolve_binding(CompileConfig(backend="reference",
                                            overrides=(("dropout", "cuda"),)))
    rate, seed = 0.1, 20260417
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    for shape, dtype in [((2, 4096, 640), torch.bfloat16), ((2, 4096, 640), torch.float32),
                         ((1 << 20,), torch.float32)]:
        x = torch.randn(shape, generator=gen, device=dev).to(dtype)
        name = f"dropout {tuple(shape)} {'bf16' if dtype == torch.bfloat16 else 'f32'} rate={rate}"
        dr.LAUNCHES.reset()
        with ops.use_backends(binding):
            out = ops.dispatch("dropout", x, seed, rate=rate)
            again = ops.dispatch("dropout", x, seed, rate=rate)
        torch.cuda.synchronize()
        launches = dr.LAUNCHES.count
        plain = dr.dropout_plain(x, seed, rate=rate)
        other = dr.dropout(x, seed + 1, rate=rate)
        dropped = (out == 0).float().mean().item()
        sigma = math.sqrt(rate * (1 - rate) / x.numel())
        log(f"kernel {name}: {launches} launches through ops.dispatch; equal to plain "
            f"{torch.equal(out, plain)}, repeat {torch.equal(out, again)}, other seed differs "
            f"{not torch.equal(out, other)}; dropped {dropped:.5f} (rate {rate}, "
            f"4 sigma {4 * sigma:.5f})")
        if launches != 2 or not torch.equal(out, again) or torch.equal(out, other):
            raise AssertionError(f"{name}: not deterministic in (x, seed, rate)")
        if not torch.equal(out, plain):
            raise AssertionError(f"{name}: kernel and plain version differ")
        if abs(dropped - rate) > 4 * sigma:
            raise AssertionError(f"{name}: dropped {dropped:.5f}, rate {rate}")
        # no single PyTorch call computes the seeded (Philox, index-keyed) mask;
        # the bound counts the bytes alone
        r = {"max_abs_err": (out.float() - plain.float()).abs().max().item(), "max_rel_err": 0.0,
             "ms": timed_ms(lambda x=x: dr.dropout(x, seed, rate=rate), 20),
             "plain_ms": timed_ms(lambda x=x: dr.dropout_plain(x, seed, rate=rate), 5),
             "library_ms": None,
             "device_ms": device_ms(lambda x=x: dr.dropout(x, seed, rate=rate), 20)[0]}
        r["bound_ms"], r["bound_by"] = bound(0, 2 * nbytes(x), dtype)
        # the kernel alone after 64 MB written over the 50 MB L2 cache: x read
        # from device memory, as the bound counts it (the row above finds x,
        # and the output's reused block, in L2 from the call before)
        by_name = device_ms(lambda x=x: (flush.zero_(), dr.dropout(x, seed, rate=rate)), 20)[2]
        r["cold_device_ms"] = named_ms(by_name, "dropout_kernel")
        log(f"  kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms (bytes); device time (profiler) {r['device_ms']:.4f} ms, "
            f"{r['bound_ms'] / r['device_ms']:.1%} of bound; L2 overwritten first "
            f"{ms_text(r['cold_device_ms'])}")
        record("K14", name, "dropout.cu", r, launches=launches)
        del x, out, again, plain, other
    del flush
    torch.cuda.empty_cache()
    return results


def phase_kernels(dev):
    """K1-K3 at the SDXL path's attention shapes, then K6 at every 3x3 conv
    shape of both paths on the kernel the routing picks: the wgmma kernel
    beside the WMMA kernel it replaced and the reference binding's cuDNN op
    (the library call); the f32 VAE convs beside one F.conv2d call (TF32
    off) on channels-last copies made outside the timed call."""
    import torch.nn.functional as F

    from stabletriton_tpu_torch.kernels import conv_direct as cd
    from stabletriton_tpu_torch.ops import reference

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(1234)

    def randn(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    results = []
    bf16 = torch.bfloat16

    # K1: packed single-KV (self at S=1024, cross against 77 keys); K2: packed
    # online (self at S=4096); K3: head-major online (VAE mid-block, f32)
    results += attention_cases(randn, SDXL_ATTENTION_CASES)

    # K6: every 3x3 stride-1 conv; the epilogue forms the path uses; SD1.5's
    # 16^2 and 8^2 levels, where the K split fills the card
    conv_cases = [
        ("unet 128x128 320->320 batch-bias silu", (2, 128, 128, 320, 320), bf16, "bb", None),
        ("unet 128x128 320->320 bias+residual", (2, 128, 128, 320, 320), bf16, "b", "res"),
        ("unet 64x64 640->640 batch-bias", (2, 64, 64, 640, 640), bf16, "bb", None),
        ("unet 32x32 1280->1280 bias+residual", (2, 32, 32, 1280, 1280), bf16, "b", "res"),
        ("SD1.5 16x16 1280->1280 batch-bias", (2, 16, 16, 1280, 1280), bf16, "bb", None),
        ("SD1.5 8x8 1280->1280 batch-bias", (2, 8, 8, 1280, 1280), bf16, "bb", None),
        ("unet conv_in 128x128 4->320", (2, 128, 128, 4, 320), bf16, "b", None),
        ("unet conv_out 128x128 320->4", (2, 128, 128, 320, 4), bf16, "b", None),
        ("vae conv_in 128x128 4->512 f32", (1, 128, 128, 4, 512), torch.float32, "b", None),
        ("SD1.5 vae conv_in 64x64 4->512 f32", (1, 64, 64, 4, 512), torch.float32, "b", None),
        ("vae 128x128 512->512 f32", (1, 128, 128, 512, 512), torch.float32, "b", "res"),
        ("vae 1024x1024 128->128 f32", (1, 1024, 1024, 128, 128), torch.float32, "b", None),
        ("vae conv_out 1024x1024 128->3 f32", (1, 1024, 1024, 128, 3), torch.float32, "b", None),
    ]
    for label, (b, hh, ww, cin, cout), dtype, bias_kind, res_kind in conv_cases:
        tol = BF16_REL_TOL if dtype == bf16 else F32_REL_TOL
        x = randn(b, hh, ww, cin, dtype=dtype)
        w = randn(3, 3, cin, cout, dtype=dtype, scale=1.0 / math.sqrt(9 * cin))
        bias = (randn(b, cout, dtype=torch.float32) if bias_kind == "bb"
                else randn(cout, dtype=dtype))
        res = randn(b, hh, ww, cout, dtype=dtype) if res_kind else None
        act = "silu" if bias_kind == "bb" else None
        kernel = cd.conv_variant(tuple(x.shape), cout, dtype)
        kfn = lambda x=x, w=w, bias=bias, res=res, act=act: cd.conv3x3(
            x, w, bias, residual=res, act=act)
        pfn = lambda x=x, w=w, bias=bias, res=res, act=act: cd.conv3x3_plain(
            x, w, bias, residual=res, act=act)
        if dtype == bf16:
            lfn = lambda x=x, w=w, bias=bias, res=res, act=act: reference.conv2d(
                x, w, bias, residual=res, act=act)
            label_l = "cuDNN (reference op)"
        else:
            xc = x.permute(0, 3, 1, 2)                                  # NCHW view, channels last
            wc = w.permute(3, 0, 1, 2).contiguous().permute(0, 3, 1, 2)  # OIHW, channels last
            lfn = lambda xc=xc, wc=wc, bias=bias: F.conv2d(xc, wc, bias, padding=1)
            label_l = "F.conv2d f32"
        # the kernel a redesigned route replaced, at the same shape, where
        # the tree still has it
        old = {"wgmma_tf32x3": "scalar", "direct_f32": "scalar"}.get(kernel)
        ofn = ((lambda x=x, w=w, bias=bias, res=res, act=act, old=old: cd._launch(
            x, w, bias, res, act, variant=old)[0]) if old else None)
        iters = 3 if dtype == torch.float32 else 10
        flops = 2 * b * hh * ww * cout * 9 * cin
        moved = nbytes(x, w, bias, res) + b * hh * ww * cout * x.element_size()
        name = f"conv3x3 {label}"
        tf32 = kernel == "wgmma_tf32x3"
        r = compare(name, kfn, pfn, tol, iters,
                    bound_ms=bound(flops, moved, dtype, TF32X3_FLOPS if tf32 else None),
                    library_fn=lfn, library_label=label_l, old_fn=ofn,
                    old_label="scalar f32 kernel")
        if dtype == torch.float32 and cin % 8:
            # the other design for a small Cin: the 3xTF32 conv on x and w
            # padded to 8 channels (the pad made outside the timed call),
            # device time of the conv kernel alone and with its weight split
            pad = -cin % 8
            xp, wp = F.pad(x, (0, pad)), F.pad(w, (0, 0, 0, pad))
            padded_ms, _, by_name = device_ms(
                lambda xp=xp, wp=wp, bias=bias, res=res, act=act: cd._launch(
                    xp, wp, bias, res, act, variant="wgmma_tf32x3")[0], iters)
            r["tf32_padded_device_ms"] = named_ms(by_name, "conv_wgmma_tf32x3")
            log(f"  3xTF32 conv on Cin padded to {cin + pad} (pad outside the timing), device: "
                f"conv kernel {ms_text(r['tf32_padded_device_ms'])}, with its weight split "
                f"{padded_ms:.4f} ms")
            del xp, wp
        if tf32:
            r["bound_f32_fma_ms"] = bound(flops, moved, dtype)[0]
            prep_ms = timed_ms(lambda w=w: cd.tf32_split(w), iters)
            log(f"  bound in 3xTF32 (above); at the f32 FMA peak {r['bound_f32_fma_ms']:.4f} ms; "
                f"the wrapper's weight split (tf32_split, inside the kernel's time) "
                f"{prep_ms:.4f} ms")
        if dtype == bf16 and (cin % 8 or cout <= 8):
            # conv_in's Cin padded to 8, conv_out's K-major 8-row weight
            # (inside the kernel's time)
            r["prep_ms"] = timed_ms(lambda x=x, w=w: (
                cd.n8_weight(w) if cout <= 8 else cd._pad_cin(x, w, None)), iters)
            log(f"  the wrapper's {'8-row weight' if cout <= 8 else 'Cin padding'} (inside "
                f"the kernel's time) {r['prep_ms']:.4f} ms")
        log(f"  {kernel}")
        r.update(name=name, source="stabletriton_tpu_torch/csrc/conv3x3.cu", tpu="K6",
                 kernel=kernel)
        results.append(r)
        del x, w, bias, res
    torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = True
    return results


# the GEMMs and convs whose forced plans ``--plans`` times: the SDXL and
# SD1.5 paths' shapes with the most launches or time a step
PLAN_GEMMS = [(8192, 640, 1920), (8192, 640, 640), (2048, 1280, 10240), (2048, 5120, 1280),
              (2048, 1280, 1280), (154, 2048, 2560), (8192, 320, 960), (128, 1280, 1280)]
# the skinny linear's (K, N) at M = 2 on the SDXL and SD1.5 steps
SKINNY_STEP_SHAPES = [(320, 1280), (1280, 320), (1280, 640), (1280, 1280), (2816, 1280)]
PLAN_CONVS = [(2, 128, 128, 320, 320), (2, 64, 64, 640, 640), (2, 32, 32, 1280, 1280),
              (2, 32, 32, 2560, 1280), (2, 16, 16, 1280, 1280), (2, 8, 8, 1280, 1280)]


def wave_rule(m_tiles: int, n: int, steps: int):
    """A plain wave-filling rule to hold the planner's model against: width
    256 wherever N has a 256-wide tile, then the least K split whose blocks
    fill one wave of the card's SMs."""
    from stabletriton_tpu_torch.kernels import wgmma_plan as wp

    bn = 256 if n >= 256 else 128
    splits = math.ceil(wp.SMS / (m_tiles * math.ceil(n / bn)))
    return wp.Plan(bn, max(1, min(splits, steps, wp.MAX_SPLITS)))


def phase_plans(dev):
    """``--plans``: each wgmma shape above at every width and a range of K
    splits, launched through the C entry points (no wrapper host time),
    beside the plan wgmma_plan picks (the data its model was fitted to) and
    the plan of :func:`wave_rule`; and the skinny linear at each of its
    step shapes at every slice width and a range of K splits, beside the
    plan of linear.skinny_plan."""
    from stabletriton_tpu_torch.kernels import build
    from stabletriton_tpu_torch.kernels import conv_direct as cd
    from stabletriton_tpu_torch.kernels import linear as lin
    from stabletriton_tpu_torch.kernels import wgmma_plan as wp

    gen = torch.Generator(device=dev).manual_seed(99)
    stream = torch.cuda.current_stream(dev).cuda_stream
    gemm = build.function("st_linear_wgmma", lin._WGMMA_ARGTYPES)
    conv = build.function("st_conv3x3_wgmma", cd._WGMMA_ARGTYPES)
    model_vs_rule = []

    def sweep(label, chosen, rule, steps, rows, n, launch):
        times = {}
        plans = {(bn, sp) for bn in wp.WIDTHS for sp in (1, 2, 3, 4, 6, 9, 12) if sp <= steps}
        for bn, splits in sorted(plans | {(chosen.bn, chosen.splits), (rule.bn, rule.splits)}):
            ws = torch.empty((splits, rows, n), device=dev) if splits > 1 else None
            times[(bn, splits)] = timed_ms(lambda: launch(bn, splits, ws), 10)
        best = min(times, key=times.get)
        t_model, t_rule = times[(chosen.bn, chosen.splits)], times[(rule.bn, rule.splits)]
        model_vs_rule.append(t_rule / t_model)
        log(f"plans {label}: chosen bn={chosen.bn} split={chosen.splits} {t_model:.4f} ms, "
            f"wave rule bn={rule.bn} split={rule.splits} {t_rule:.4f} ms "
            f"({t_rule / t_model - 1:+.0%}), fastest bn={best[0]} split={best[1]} "
            f"{times[best]:.4f} ms; " + ", ".join(f"{b}/{sp} {t:.4f}" for (b, sp), t in
                                                 sorted(times.items())))

    for m, k, n in PLAN_GEMMS:
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        w = torch.randn((k, n), generator=gen, device=dev).to(torch.bfloat16)
        out = torch.empty((m, n), device=dev, dtype=torch.bfloat16)
        steps = math.ceil(k / wp.BK)
        sweep(f"gemm ({m},{k})@({k},{n})", wp.gemm_plan(m, k, n),
              wave_rule(math.ceil(m / wp.BM), n, steps), steps, m, n,
              lambda bn, sp, ws: gemm(x.data_ptr(), w.data_ptr(), None, 0, out.data_ptr(),
                                      None if ws is None else ws.data_ptr(), m, n, k, 0, bn, sp,
                                      stream))
    for b, h, wd, cin, cout in PLAN_CONVS:
        x = torch.randn((b, h, wd, cin), generator=gen, device=dev).to(torch.bfloat16)
        w = torch.randn((3, 3, cin, cout), generator=gen, device=dev).to(torch.bfloat16)
        out = torch.empty((b, h, wd, cout), device=dev, dtype=torch.bfloat16)
        tile, plan = wp.conv_plan(b, h, wd, cin, cout)
        steps = 9 * math.ceil(cin / wp.BK)
        sweep(f"conv {b}x{h}x{wd} {cin}->{cout}", plan,
              wave_rule(math.prod(tile.counts(b, h, wd)), cout, steps), steps, b * h * wd, cout,
              lambda bn, sp, ws: conv(x.data_ptr(), w.data_ptr(), None, 0, 0, None,
                                      out.data_ptr(), None if ws is None else ws.data_ptr(),
                                      b, h, wd, cin, cout, 0, None, None, 0, tile.tw, tile.th,
                                      tile.tb, bn, sp, 0, stream))
    # the skinny kernel at each M = 2 shape of the steps: every slice width
    # and a range of K splits, device time a launch (profiler), through the
    # C entry, beside the plan skinny_plan picks
    skinny = build.function("st_linear_skinny", lin._SKINNY_ARGTYPES)
    for k, n in SKINNY_STEP_SHAPES:
        x = torch.randn((2, k), generator=gen, device=dev).to(torch.bfloat16)
        w = torch.randn((k, n), generator=gen, device=dev).to(torch.bfloat16)
        out = torch.empty((2, n), device=dev, dtype=torch.bfloat16)
        chosen = lin.skinny_plan(2, k, n, 2)
        plans = {chosen}
        for cols in (64, 32, 16):
            for want in (1, 2, 4, 6, 7, 8):
                rows = math.ceil(k / want)
                plans.add(lin.SkinnyPlan(cols, math.ceil(k / rows), rows))
        times = {}
        for plan in plans:
            dims = lin.SkinnyDims(2, n, k, 0, 1, 0, *plan)
            times[plan] = device_ms(lambda dims=dims: skinny(
                x.data_ptr(), w.data_ptr(), None, out.data_ptr(), stream,
                ctypes.addressof(dims)), 20)[0]
        best = min(times, key=times.get)
        log(f"plans skinny (2,{k})@({k},{n}): chosen cols={chosen.cols} split={chosen.splits} "
            f"{times[chosen] * 1e3:.2f} us, fastest cols={best.cols} split={best.splits} "
            f"{times[best] * 1e3:.2f} us (device, profiler); " + ", ".join(
                f"{p.cols}/{p.splits} {t * 1e3:.2f}" for p, t in sorted(times.items())))
    slower = sum(r > 1.05 for r in model_vs_rule)
    faster = sum(r < 1 / 1.05 for r in model_vs_rule)
    log(f"plans: the wave rule is more than 5% slower than the model's plan at {slower} of "
        f"{len(model_vs_rule)} shapes and more than 5% faster at {faster} (rule/model "
        f"{min(model_vs_rule):.2f}-{max(model_vs_rule):.2f})")
    torch.cuda.empty_cache()


# the shapes whose host time a launch ``--host-time`` reads: bf16 GEMMs and
# convs the wgmma kernels take, with and without a K split
HOST_GEMMS = [(8192, 640, 1920), (2048, 5120, 1280), (154, 2048, 2560), (128, 1280, 1280)]
HOST_CONVS = [(2, 128, 128, 320, 320), (2, 32, 32, 1280, 1280), (2, 8, 8, 1280, 1280)]
HOST_NORMS = [(2, 128, 128, 320), (2, 32, 32, 1280)]  # GroupNorm, and GN + SiLU + conv
# the skinny linear's (M = 2, bias) and LayerNorm's (bf16, affine) shapes of the
# SDXL step, each beside the one PyTorch call computing the same function
HOST_SKINNY = [(2, 1280, 1280), (2, 2816, 1280)]
HOST_LAYER_NORMS = [(8192, 640), (2048, 1280)]
# the attention wrapper's cross-attention against the fused KV buffer: SDXL's
# K1 (h = 10, d = 64) and SD1.5's K5 (h = 8, d = 40), as (B, Sq, Sk, C, H)
HOST_ATTENTION = [(2, 4096, 77, 640, 10), (2, 4096, 77, 320, 8)]
# the timestep embedding's two launches of a SDXL step, (B,) -> (B, dim), and
# dropout's shape, whose device time a call is printed too
HOST_TIME_EMBED = [(2, 320), (12, 256)]
HOST_DROPOUT = [((2, 4096, 640), torch.bfloat16), ((2, 4096, 640), torch.float32)]
HOST_ROUNDS = 7


def host_us(fn, calls: int = 100) -> float:
    """Mean host time (us) of one fn() call: ``calls`` calls queued back to
    back after a synchronisation, timed on the host clock before the device
    catches up (their launches stay inside CUDA's launch queue)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def skinny_entry(lin, x, w, b, out, stream):
    """The bare C entry of the skinny linear kernel of the package ``lin``
    at its planned launch, as a call: st_linear_skinny where the package
    has it, else st_linear's skinny variant (the trees before it)."""
    from stabletriton_tpu_torch.kernels import build

    (m, k), n = x.shape, w.shape[1]
    if hasattr(lin, "skinny_plan"):
        fn = build.function("st_linear_skinny", lin._SKINNY_ARGTYPES)
        dims = lin.SkinnyDims(m, n, k, 0, 1, 1, *lin.skinny_plan(m, k, n, x.element_size()))
        return lambda: fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), stream,
                          ctypes.addressof(dims))
    fn = build.function("st_linear", lin._LINEAR_ARGTYPES)
    return lambda: fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), 1, out.data_ptr(), m, n, k, 0,
                      1, 2, stream)


def time_embed_entry(te, t, out, dim, stream):
    """The bare C entry of the timestep embedding of the package ``te`` on
    SDXL's arguments, as a call: st_time_embed with its TeDims where the
    package has them, else its seven scalar arguments (the trees before)."""
    from stabletriton_tpu_torch.kernels import build

    b, half = t.shape[0], dim // 2
    coef = float(torch.tensor(-math.log(10000.0) / half, dtype=torch.float32))
    fn = build.function("st_time_embed", te._TIME_EMBED_ARGTYPES)
    if hasattr(te, "TeDims"):
        dims = te.TeDims(b, half, coef, 1, *te.grid(b * dim))
        return lambda: fn(t.data_ptr(), out.data_ptr(), stream, ctypes.addressof(dims))
    return lambda: fn(t.data_ptr(), out.data_ptr(), b, half, coef, 1, stream)


def phase_host_time(dev):
    """``--host-time [DIR]``: the host time a launch of the package in DIR
    (default: this checkout), for each shape above: the public wrapper
    (linear, conv3x3, group_norm, layer_norm), linear's internal launch on
    the wgmma route and on the WMMA route, the kernels' bare C entries (the
    wgmma kernels at the planned plan, the skinny linear, LayerNorm), the
    fused GN conv's whole op (gn_conv2d_fused: the GroupNorm stats and fold,
    then the conv), the attention wrapper against a fused KV buffer, the
    timestep embedding's wrapper and C entry (K12, both SDXL shapes) and
    dropout's wrapper (K14), and for the skinny linear, LayerNorm and
    attention the one PyTorch call computing the same function (torch.addmm,
    F.layer_norm, SDPA). The host is shared, so each is measured in
    HOST_ROUNDS interleaved rounds and printed as its least and its median
    round. The skinny linear, LayerNorm and dropout rows also print the
    device time a call of the wrapper and of the PyTorch call
    (torch.profiler, kernels only). Run it on two trees in one call to
    compare them."""
    import statistics

    import torch.nn.functional as F

    from stabletriton_tpu_torch.kernels import build
    from stabletriton_tpu_torch.kernels import conv_direct as cd
    from stabletriton_tpu_torch.kernels import dropout as dr
    from stabletriton_tpu_torch.kernels import flash_attention as fa
    from stabletriton_tpu_torch.kernels import group_norm as gn
    from stabletriton_tpu_torch.kernels import layer_norm as ln
    from stabletriton_tpu_torch.kernels import linear as lin
    from stabletriton_tpu_torch.kernels import time_embed as te
    from stabletriton_tpu_torch.kernels import wgmma_plan as wp

    gen = torch.Generator(device=dev).manual_seed(77)
    stream = torch.cuda.current_stream(dev).cuda_stream
    gemm = build.function("st_linear_wgmma", lin._WGMMA_ARGTYPES)
    conv = build.function("st_conv3x3_wgmma", cd._WGMMA_ARGTYPES)
    # the persistent grid argument (K8's) where the tree's C entry takes one
    grid_arg = (0,) if len(cd._WGMMA_ARGTYPES) > 23 else ()
    cases = []  # (label, {what: fn})
    for m, k, n in HOST_GEMMS:
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        w = torch.randn((k, n), generator=gen, device=dev).to(torch.bfloat16)
        b = torch.randn(n, generator=gen, device=dev).to(torch.bfloat16)
        out = torch.empty((m, n), device=dev, dtype=torch.bfloat16)
        plan = wp.gemm_plan(m, k, n)
        ws = torch.empty((plan.splits, m, n), device=dev)
        cases.append((f"gemm ({m},{k})@({k},{n})+b bn={plan.bn} split={plan.splits}", {
            "wrapper": lambda x=x, w=w, b=b: lin.linear(x, w, b),
            "wgmma route": lambda x=x, w=w, b=b: lin._launch(x, w, b, None, "wgmma_bf16"),
            "WMMA route": lambda x=x, w=w, b=b: lin._launch(x, w, b, None, "wmma_bf16"),
            "wgmma C entry": lambda x=x, w=w, b=b, out=out, ws=ws, m=m, k=k, n=n, plan=plan:
                gemm(x.data_ptr(), w.data_ptr(), b.data_ptr(), 1, out.data_ptr(), ws.data_ptr(),
                     m, n, k, 0, plan.bn, plan.splits, stream)}))
    for bsz, h, wd, cin, cout in HOST_CONVS:
        x = torch.randn((bsz, h, wd, cin), generator=gen, device=dev).to(torch.bfloat16)
        w = torch.randn((3, 3, cin, cout), generator=gen, device=dev).to(torch.bfloat16)
        bias = torch.randn((bsz, cout), generator=gen, device=dev)
        out = torch.empty((bsz, h, wd, cout), device=dev, dtype=torch.bfloat16)
        tile, plan = wp.conv_plan(bsz, h, wd, cin, cout)
        ws = torch.empty((plan.splits, bsz * h * wd, cout), device=dev)
        cases.append((f"conv {bsz}x{h}x{wd} {cin}->{cout} bn={plan.bn} split={plan.splits}", {
            "wrapper": lambda x=x, w=w, bias=bias: cd.conv3x3(x, w, bias, act="silu"),
            "wgmma C entry": lambda x=x, w=w, bias=bias, out=out, ws=ws, s=(bsz, h, wd, cin, cout),
                tile=tile, plan=plan:
                conv(x.data_ptr(), w.data_ptr(), bias.data_ptr(), 0, s[4], None, out.data_ptr(),
                     ws.data_ptr(), *s, 1, None, None, 0, tile.tw, tile.th, tile.tb, plan.bn,
                     plan.splits, *grid_arg, stream)}))
    for bsz, h, wd, c in HOST_NORMS:
        x = torch.randn((bsz, h, wd, c), generator=gen, device=dev).to(torch.bfloat16)
        g = torch.randn(c, generator=gen, device=dev).to(torch.bfloat16)
        w = torch.randn((3, 3, c, c), generator=gen, device=dev).to(torch.bfloat16)
        cases.append((f"group norm {bsz}x{h}x{wd}x{c} g=32 +silu", {
            "K9 wrapper": lambda x=x, g=g: gn.group_norm(x, g, g, num_groups=32, act="silu"),
            "gn_conv2d_fused op": lambda x=x, g=g, w=w: cd.gn_conv2d_fused(
                x, g, g, w, g, num_groups=32, gn_act="silu")}))
    devices = []  # (label, {what: fn}) whose device time a call is printed too
    for m, k, n in HOST_SKINNY:
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        w = (torch.randn((k, n), generator=gen, device=dev) / math.sqrt(k)).to(torch.bfloat16)
        b = torch.randn(n, generator=gen, device=dev).to(torch.bfloat16)
        out = torch.empty((m, n), device=dev, dtype=torch.bfloat16)
        fns = {"wrapper": lambda x=x, w=w, b=b: lin.linear(x, w, b),
               "C entry": skinny_entry(lin, x, w, b, out, stream),
               "torch.addmm": lambda x=x, w=w, b=b: torch.addmm(b, x, w)}
        cases.append((f"skinny linear ({m},{k})@({k},{n})+b", fns))
        devices.append(cases[-1])
    ln_entry = build.function("st_layer_norm", ln._LN_ARGTYPES)
    for rows, c in HOST_LAYER_NORMS:
        x = torch.randn((rows, c), generator=gen, device=dev).to(torch.bfloat16)
        g, b = (torch.randn(c, generator=gen, device=dev).to(torch.bfloat16) for _ in range(2))
        out = torch.empty_like(x)
        if hasattr(ln, "LnDims"):  # the entry with its integer arguments in one struct
            dims = ln.LnDims(1, 1, rows, c, 0, 1e-6)
            entry = (lambda x=x, g=g, b=b, out=out, dims=dims: ln_entry(
                x.data_ptr(), g.data_ptr(), b.data_ptr(), out.data_ptr(), stream,
                ctypes.addressof(dims)))
        else:
            entry = (lambda x=x, g=g, b=b, out=out, rows=rows, c=c: ln_entry(
                x.data_ptr(), g.data_ptr(), b.data_ptr(), 1, out.data_ptr(), rows, c, 1e-6, 0, 1,
                stream))
        fns = {"wrapper": lambda x=x, g=g, b=b: ln.layer_norm(x, g, b, eps=1e-6),
               "C entry": entry,
               "F.layer_norm": lambda x=x, g=g, b=b, c=c: F.layer_norm(x, (c,), g, b, 1e-6)}
        cases.append((f"layer norm ({rows},{c}) bf16", fns))
        devices.append(cases[-1])
    for bsz, sq, sk, c, h in HOST_ATTENTION:
        q = torch.randn((bsz, sq, c), generator=gen, device=dev).to(torch.bfloat16)
        kv = torch.randn((bsz, sk, 2 * c), generator=gen, device=dev).to(torch.bfloat16)
        qh, kh, vh = (t.reshape(bsz, -1, h, c // h).transpose(1, 2).contiguous()
                      for t in (q, *kv.chunk(2, -1)))
        cases.append((f"attention kv ({bsz},{sq},{c}) x ({bsz},{sk},{2 * c}) h={h}", {
            "wrapper": lambda q=q, kv=kv, h=h: fa.flash_attention_kv(q, kv, num_heads=h),
            "SDPA": lambda qh=qh, kh=kh, vh=vh: F.scaled_dot_product_attention(qh, kh, vh)}))
    for b, dim in HOST_TIME_EMBED:
        t = torch.full((b,), 999.0, device=dev)
        out = torch.empty((b, dim), device=dev)
        cases.append((f"time_embed ({b},)->({b},{dim})", {
            "wrapper": lambda t=t, dim=dim: te.time_embed(t, dim=dim),
            "C entry": time_embed_entry(te, t, out, dim, stream)}))
    for shape, dtype in HOST_DROPOUT:
        x = torch.randn(shape, generator=gen, device=dev).to(dtype)
        cases.append((f"dropout {shape} {dtype}", {
            "wrapper": lambda x=x: dr.dropout(x, 20260417, rate=0.1)}))
        devices.append(cases[-1])
    rounds = {(label, what): [] for label, fns in cases for what in fns}
    for _ in range(HOST_ROUNDS):
        for label, fns in cases:
            for what, fn in fns.items():
                rounds[(label, what)].append(host_us(fn))
    for label, fns in cases:
        log(f"host {label}: " + ", ".join(
            f"{what} {min(rounds[(label, what)]):.1f} "
            f"(median {statistics.median(rounds[(label, what)]):.1f})" for what in fns)
            + " us a launch")
    for label, fns in devices:
        log(f"device {label}: " + ", ".join(
            f"{what} {device_ms(fns[what], 50)[0] * 1e3:.2f}" for what in fns if what != "C entry")
            + " us a call")
    torch.cuda.empty_cache()


# the refiner's and SD2.x's Transformer2D GroupNorm shapes (phases 6k, 7k),
# timed beside K9_CASES by ``--group-norm``
K9_MORE = [((2, 64, 64, 768), torch.bfloat16, None, "refiner"),
           ((2, 96, 96, 320), torch.bfloat16, None, "sd2"),
           ((2, 48, 48, 640), torch.bfloat16, None, "sd2"),
           ((2, 24, 24, 1280), torch.bfloat16, None, "sd2")]


def phase_group_norm(dev):
    """``--group-norm [DIR]``: K9 of the package in DIR (or of this
    checkout), to compare two trees in one call (parent, change, change,
    parent). At every K9_CASES and K9_MORE shape: the device time a call
    (torch.profiler's kernel events, two sessions) of the GroupNorm and of
    its stats and fold alone (scale_shift), F.group_norm's, the bound and
    the error against the plain version. Then the replayed SDXL-base step
    (compile_unet_kv, 128^2 latent, CFG batch 2) under the fused-op and the
    all-kernel binding and a 1024^2 f32 decode under the fused-op binding,
    each by kernel family (profile_step). Prints no result line."""
    import torch.nn.functional as F

    from stabletriton_tpu_torch import ops
    from stabletriton_tpu_torch.compile import (FUSED_OP_OVERRIDES, CompileConfig,
                                                compile_unet_kv, fuse_attention_projections,
                                                resolve_binding)
    from stabletriton_tpu_torch.kernels import group_norm as gn
    from stabletriton_tpu_torch.models import vae as vae_mod
    from stabletriton_tpu_torch.models.unet import sdxl_base_unet_config
    from stabletriton_tpu_torch.runtime.pipeline import _decode_images

    gen = torch.Generator(device=dev).manual_seed(4321)
    rows = {}
    with torch.inference_mode():
        for shape, dtype, act, path in K9_CASES + K9_MORE:
            x = (torch.randn(shape, generator=gen, device=dev) * 2 + 0.5).to(dtype)
            g = (torch.randn(shape[3], generator=gen, device=dev) + 1).to(dtype)
            b = torch.randn(shape[3], generator=gen, device=dev).to(dtype)
            nchw = x.permute(0, 3, 1, 2).contiguous()
            iters = 5 if x.numel() > 2**26 else 20
            err = (gn.group_norm(x, g, b, num_groups=32, act=act).float()
                   - gn.group_norm_plain(x, g, b, num_groups=32, act=act).float()).abs().max()
            full = [device_ms(lambda: gn.group_norm(x, g, b, num_groups=32, act=act), iters)[0]
                    for _ in range(2)]
            fold = [device_ms(lambda: gn.scale_shift(x, g, b, num_groups=32), iters)[0]
                    for _ in range(2)]
            lib = device_ms(lambda: F.group_norm(nchw, 32, g, b, 1e-5), iters)[0]
            bnd = bound(0, 2 * nbytes(x) + nbytes(g, b), dtype)[0]
            fold_bnd = bound(0, nbytes(x, g, b) + 8 * shape[0] * shape[3], dtype)[0]
            name = k9_name(shape, dtype, act, path) + (
                f" ({path})" if path in ("refiner", "sd2") else "")
            rows[name] = {"device_ms": full, "fold_device_ms": fold, "library_device_ms": lib,
                          "bound_ms": bnd, "fold_bound_ms": fold_bnd,
                          "max_abs_err": err.item()}
            log(f"group-norm {name}: device {full[0]:.4f} / {full[1]:.4f} ms "
                f"({bnd / min(full):.1%} of the {bnd * 1e3:.4g} us bound), stats and fold "
                f"{fold[0]:.4f} / {fold[1]:.4f} ms ({fold_bnd / min(fold):.1%} of "
                f"{fold_bnd * 1e3:.4g} us), F.group_norm {lib:.4f} ms, max abs err "
                f"{err.item():.2e}")
            del x, nchw
        torch.cuda.empty_cache()

        ucfg = sdxl_base_unet_config()
        fused = fuse_attention_projections(make_unet_params(dev, ucfg))
        inputs = sdxl_step_inputs(dev)
        sample, ctx, pooled, time_ids = (inputs[k] for k in ("sample", "ctx", "pooled",
                                                             "time_ids"))
        t = torch.full((2,), 500.0, device=dev)
        steps = {}
        for name in ("fused_ops", "all_kernels"):
            pre, _, step = compile_unet_kv(ucfg, replay_configs()[name])
            pre(fused, ctx)
            kv = pre(fused, ctx)
            step(fused, sample, t, kv, pooled, time_ids)  # eager, then the capture
            steps[name] = profile_step(lambda: step(fused, sample, t, kv, pooled, time_ids),
                                       f"group-norm: SDXL-base step replayed, {name}")
            del pre, step, kv
            gc.collect()
            torch.cuda.empty_cache()
        del fused
        vcfg = vae_mod.sdxl_vae_config()
        vae = vae_mod.init_vae_params(vcfg, 3, device=dev)
        lat = torch.randn((1, 128, 128, 4), generator=gen, device=dev)
        with ops.use_backends(resolve_binding(CompileConfig(overrides=FUSED_OP_OVERRIDES))):
            steps["decode_fused_ops"] = profile_step(
                lambda: _decode_images(vcfg, vae, lat),
                "group-norm: 1024^2 f32 decode, fused-op binding", unit="decode", top=12)
    log("group-norm " + json.dumps({"rows": rows, "profiles": steps}))


# phase 3f's rows: the default binding's kernel forms ("cuda_bf16apply") at
# SD1.5's largest shapes at UNet batch 16 (GroupNorm+SiLU at 64^2 x 320 and
# 960, the LayerNorm rows at 64^2 x 320, GEGLU's halves at 64^2) and the f32
# decoder's largest GroupNorm
BF16APPLY_ROWS = [("group_norm", (16, 64, 64, 320), torch.bfloat16, "silu"),
                  ("group_norm", (16, 64, 64, 960), torch.bfloat16, "silu"),
                  ("layer_norm", (65536, 320), torch.bfloat16, None),
                  ("geglu", (16, 4096, 2560), torch.bfloat16, None),
                  ("group_norm", (1, 512, 512, 128), torch.float32, "silu")]
# how far a kernel form may lie from its plain chain (the card tests'
# BF16APPLY_MAX_ULPS, BF16APPLY_MAX_SHARE and F32APPLY_MAX_REL): ulps of the
# largest output and the share of elements off. bf16: 2 ulps, 2e-4 of the
# elements (where the moments' summation order moves a rounding of mean,
# rstd, scale or shift); f32: 8 ulps, any share
BF16APPLY_GATE = {torch.bfloat16: (2, 2e-4), torch.float32: (8, 1.0)}
# the forms' counters (kernel_counters) by op, and the op of each TPU kernel
BF16APPLY_COUNTER = {"group_norm": "K9_bf16apply", "layer_norm": "K10_bf16apply",
                     "geglu": "K11_bf16apply"}
BF16APPLY_TPU = {"group_norm": "K9", "layer_norm": "K10", "geglu": "K11"}
BF16APPLY_SOURCE = {"group_norm": "group_norm.cu", "layer_norm": "layer_norm.cu",
                    "geglu": "geglu.cu"}


def gap_to(out, ref) -> dict:
    """How far a kernel form's output lies from its plain chain's: the
    largest gap in ulps of the largest plain output (8 significant bits for
    bf16, 24 for f32), the share of elements that differ, the largest
    absolute gap."""
    d = (out.float() - ref.float()).abs()
    top = ref.float().abs().max().item()
    ulp = 2.0 ** (math.floor(math.log2(top)) - (7 if out.dtype == torch.bfloat16 else 23))
    return {"max_ulps": (d.max() / ulp).item(), "share_off": (out != ref).float().mean().item(),
            "max_abs": d.max().item(), "max_rel": d.max().item() / top}


def check_gap(name, gap, dtype) -> None:
    """Raise where a kernel form lies past BF16APPLY_GATE from its plain chain."""
    ulps, share = BF16APPLY_GATE[dtype]
    if not (gap["max_ulps"] <= ulps and gap["share_off"] <= share):
        raise AssertionError(f"{name}: {gap['max_ulps']:.2f} ulps of the largest output and "
                             f"{gap['share_off']:.3e} of the elements off the plain chain, "
                             f"past {ulps} and {share:g}")


def bf16apply_match(op, shape, dtype, act) -> list:
    """The launch-key fields of a kernel form's launches at ``shape``."""
    dname = "bf16" if dtype == torch.bfloat16 else "f32"
    if op == "group_norm":
        b, h, w, c = shape
        return [f"{dname} b={b} {h}x{w} c={c} ", f"act={act} "]
    if op == "layer_norm":
        return [f"ln_bf16apply {dname} rows={shape[0]} c={shape[1]} "]
    return [f"{dname} rows={math.prod(shape[:-1])} n={shape[-1] // 2} "]


def phase_bf16apply(dev, rows=BF16APPLY_ROWS, path=None):
    """Phase 3f: the default binding's GroupNorm, LayerNorm and GEGLU kernel
    forms at BF16APPLY_ROWS, each against the plain chain it replaces
    (``ops.reference``'s bf16-apply forms and reference GEGLU) on the same
    inputs, held to BF16APPLY_GATE: CUDA-event and device ms a call (the
    device time profiled twice) and kernels a call of both, the bytes bound
    (x read once, the output written once) and its share, the gap
    (``gap_to``). Then torch.rsqrt against 1 / sqrt on the card (the f32
    rstd the plain forms take). Returns the kernel-table rows. Given a
    ``path``, the same for ``rows`` (phase 7v), each row carrying the
    launch-key fields its launches on that path are counted by."""
    from stabletriton_tpu_torch.kernels import geglu as gg
    from stabletriton_tpu_torch.kernels import group_norm as gn
    from stabletriton_tpu_torch.kernels import layer_norm as ln
    from stabletriton_tpu_torch.ops import reference

    gen = torch.Generator(device=dev).manual_seed(2222 if path is None else 2323)
    cases, rows = rows, []
    with torch.inference_mode():
        for op, shape, dtype, act in cases:
            x = (torch.randn(shape, generator=gen, device=dev) * 2 + 0.5).to(dtype)
            c = shape[-1]
            g = (torch.randn(c, generator=gen, device=dev) * 0.05 + 1).to(dtype)
            b = (torch.randn(c, generator=gen, device=dev) * 0.05).to(dtype)
            dname = "bf16" if dtype == torch.bfloat16 else "f32"
            if op == "group_norm":
                eps = 1e-6 if dtype == torch.float32 else 1e-5
                kernel = lambda: gn.group_norm_bf16apply(x, g, b, num_groups=32, eps=eps, act=act)
                plain = lambda: reference.group_norm_bf16apply(x, g, b, num_groups=32, eps=eps,
                                                               act=act)
                moved = 2 * nbytes(x) + nbytes(g, b)
                name = f"group_norm bf16apply {tuple(shape)} {dname} act={act}"
            elif op == "layer_norm":
                kernel = lambda: ln.layer_norm_bf16apply(x, g, b, eps=1e-6)
                plain = lambda: reference.layer_norm_bf16apply(x, g, b, eps=1e-6)
                moved = 2 * nbytes(x) + nbytes(g, b)
                name = f"layer_norm bf16apply {tuple(shape)} {dname}"
            else:
                state, gate = x.chunk(2, dim=-1)
                kernel = lambda: gg.geglu_bf16apply(state, gate)
                plain = lambda: reference.geglu(state, gate)
                moved = nbytes(x) + nbytes(x) // 2
                name = f"geglu bf16apply halves of {tuple(shape)} {dname}"
            gap = gap_to(kernel(), plain())
            iters = 5 if x.numel() > 2**26 else 20
            dev_ms = [device_ms(kernel, iters) for _ in range(2)]
            # a profile that lost kernels (under one a call: every form is at
            # least one) reads short: the device time is the other run's
            whole = [m for m in dev_ms if m[1] is None or m[1] >= 1] or dev_ms
            plain_ms, plain_n, _ = device_ms(plain, iters)
            bnd = bound(0, moved, dtype)[0]
            r = {"name": name, "source": f"stabletriton_tpu_torch/csrc/{BF16APPLY_SOURCE[op]}",
                 "tpu": BF16APPLY_TPU[op], "counter": BF16APPLY_COUNTER[op],
                 "max_abs_err": gap["max_abs"], "max_rel_err": gap["max_rel"],
                 "max_ulps": gap["max_ulps"], "share_off": gap["share_off"],
                 "ms": timed_ms(kernel, iters), "plain_ms": timed_ms(plain, iters),
                 "bound_ms": bnd, "bound_by": "bytes", "library_ms": None,
                 "device_ms": min(m for m, _, _ in whole),
                 "device_ms_runs": [m for m, _, _ in dev_ms], "kernels": whole[0][1],
                 "plain_device_ms": plain_ms, "plain_kernels": plain_n}
            if path is not None:
                r.update(path=path, match=bf16apply_match(op, shape, dtype, act))
            log(f"bf16apply {name}: device {r['device_ms_runs'][0]:.4f} / "
                f"{r['device_ms_runs'][1]:.4f} ms in {r['kernels']} kernels "
                f"({bnd / r['device_ms']:.1%} of the {bnd * 1e3:.4g} us bytes bound); plain "
                f"chain {plain_ms:.4f} ms in {plain_n} kernels; gap {gap['max_ulps']:.2f} ulps "
                f"of the largest output, {gap['share_off']:.3e} of elements off, max abs "
                f"{gap['max_abs']:.3e}")
            check_gap(name, gap, dtype)
            rows.append(r)
            del x
        torch.cuda.empty_cache()
        if path is not None:
            return rows

        v = torch.exp(torch.empty(1 << 24, device=dev).uniform_(-30, 30, generator=gen))
        rsqrt_off = (torch.rsqrt(v) != torch.sqrt(v).reciprocal()).float().mean().item()
        log(f"bf16apply torch.rsqrt vs 1 / sqrt on the card: {rsqrt_off:.3e} of 2^24 values "
            f"differ")
    return rows


def phase_bf16apply_steps(dev, ucfg, params):
    """Phase 4h: one SD1.5 UNet step (64^2 latent) at UNet batch 2 and 16:
    eager under CompileConfig(), whose kernel forms must launch their
    per-step counts (default_per_step; K8-K11 nothing), then replayed
    (compile_unet_kv) under the default binding, under its plain chains (the
    binding before the kernel forms) and under the fused-op binding,
    CUDA-event ms a replay in turns (default, plain, fused, fused, plain,
    default), the replayed default step by kernel family, and the default
    step's output against the plain chains' (within the step gate)."""
    from stabletriton_tpu_torch import ops
    from stabletriton_tpu_torch.compile import (FUSED_OP_OVERRIDES, CompileConfig,
                                                compile_unet_kv, fuse_attention_projections,
                                                resolve_binding)
    from stabletriton_tpu_torch.models.unet import unet_apply

    gen = torch.Generator(device=dev).manual_seed(2223)
    params = fuse_attention_projections(params)
    plain_binding = {**resolve_binding(CompileConfig()), "group_norm": "bf16apply",
                     "layer_norm": "bf16apply", "geglu": "reference"}
    plain_config = CompileConfig(overrides=tuple(
        (op, plain_binding[op]) for op in ("group_norm", "layer_norm", "geglu")))
    configs = {"default": CompileConfig(), "plain": plain_config,
               "fused_ops": CompileConfig(overrides=FUSED_OP_OVERRIDES)}
    counters = kernel_counters()
    steps = {}
    with torch.inference_mode():
        for batch in (2, 16):
            sample = torch.randn((batch, 64, 64, 4), generator=gen, device=dev).to(torch.bfloat16)
            ctx = torch.randn((batch, 77, 768), generator=gen, device=dev).to(torch.bfloat16)
            none = torch.zeros((batch, 0), device=dev)
            t = torch.full((batch,), 500.0, device=dev)
            reset(counters)
            with ops.use_backends(resolve_binding(CompileConfig())):
                unet_apply(ucfg, params, sample, t, ctx, none, none)
            torch.cuda.synchronize()
            want = {**dict.fromkeys(FUSED_PER_STEP, 0), **default_per_step(SD15_ALL_PER_STEP)}
            launches = {k: counters[k].count for k in want}
            if launches != want:
                raise AssertionError(f"SD1.5 eager default step, UNet batch {batch}: launches "
                                     f"{launches}, expected {want}")
            run, outs = {}, {}
            for label, config in configs.items():
                pre, _, step = compile_unet_kv(ucfg, config)
                kv = pre(params, ctx)
                outs[label] = step(params, sample, t, kv, none, none)  # eager, then captured
                run[label] = lambda step=step, kv=kv: step(params, sample, t, kv, none, none)
            ms = {label: [] for label in configs}
            for label in ("default", "plain", "fused_ops", "fused_ops", "plain", "default"):
                ms[label].append(timed_ms(run[label], 10))
            fam = profile_step(run["default"], f"bf16apply: SD1.5 step replayed, default, "
                                               f"UNet batch {batch}")
            diff = gap_to(outs["default"], outs["plain"])
            mse = (outs["default"].float() - outs["plain"].float()).square().mean().item()
            steps[batch] = {"launches": launches, "replay_ms": ms, "profile": fam,
                            "vs_plain": diff, "mse_vs_plain": mse}
            log(f"bf16apply SD1.5 step, UNet batch {batch}: kernel-form launches {launches}; "
                f"replay ms default {ms['default']}, plain chains {ms['plain']}, fused-op "
                f"{ms['fused_ops']}; default vs plain chains: {diff}, mse {mse:.3e}")
            if not mse < STEP_MSE_GATE:
                raise AssertionError(f"SD1.5 default step, UNet batch {batch}: mse {mse:.3e} "
                                     f"against the plain chains exceeds {STEP_MSE_GATE:g}")
            del run, outs, sample, ctx
            gc.collect()
            torch.cuda.empty_cache()
    del params
    log("bf16apply " + json.dumps({"steps": steps}))


def make_unet_params(dev, cfg):
    from stabletriton_tpu_torch.models.unet import init_unet_params

    return init_unet_params(cfg, 0, device=dev, dtype=torch.bfloat16)


# launches of each opt-in kernel per UNet step under the all-kernel binding
# (the fused-op binding launches K8-K11 alone): resnets x 2 GN+SiLU+conv
# pairs + norm_out/conv_out (K8); one GroupNorm per Transformer2D (K9);
# transformer blocks x 3 LayerNorms (K10) and x 1 GEGLU (K11); the timestep
# embedding, and for SDXL the time_ids' (K12); every projection (K13):
# transformer blocks x 6 (to_qkv, to_q, two to_out, ff proj, ff out) +
# Transformer2D x 2 (proj_in, proj_out) + one time_emb_proj per resnet + the
# time MLP's 2 (+ the add embedding's 2 for SDXL). SDXL-base: 17 resnets, 11
# Transformer2D, 70 blocks. SD1.5: 22 resnets (4 levels x 2 down, 2 mid, 4 x 3
# up), 16 Transformer2D of one block each. The cross K/V precompute adds one
# K13 launch per block, once per generation.
ALL_PER_STEP = {"K8": 35, "K9": 11, "K10": 210, "K11": 70, "K12": 2, "K13": 463}
SD15_ALL_PER_STEP = {"K8": 45, "K9": 16, "K10": 48, "K11": 16, "K12": 1, "K13": 152}
FUSED_PER_STEP = {k: ALL_PER_STEP[k] for k in ("K8", "K9", "K10", "K11")}


def default_per_step(all_per_step: dict) -> dict:
    """Launches of the default binding's kernel forms per UNet step, from
    the all-kernel binding's: every GroupNorm (K8's, before a resnet conv or
    conv_out, and K9's, before a Transformer2D), every LayerNorm (K10's)
    and every GEGLU (K11's)."""
    a = all_per_step
    return {"K9_bf16apply": a["K8"] + a["K9"], "K10_bf16apply": a["K10"],
            "K11_bf16apply": a["K11"]}


PRECOMPUTE_LINEARS = 70
SD15_PRECOMPUTE_LINEARS = 16
VAE_LINEARS = 4  # the f32 VAE decoder's mid-attention q, k, v, out per image
# bf16 attention launches per UNet step by kernel and class, under either
# kernel binding. SDXL-base: self at 64^2 (h=10) 10 x K2 and at 32^2 (h=20)
# 60 x K1 on attn_wgmma_bf16, 70 cross (77 keys) x K1 on the tiny-KV kernel.
# SD1.5: self at 64^2 (d=40) 5 x K3, at 32^2 (d=80) and 16^2 (d=160) 10 x K4
# on attn_wgmma_bf16, mid self at 8^2 (d=160) 1 + 16 cross x K5 on the
# tiny-KV kernel.
ATTN_PER_STEP = {"wgmma_bf16": {"K1": 60, "K2": 10}, "tinykv_wgmma_bf16": {"K1": 70}}
SD15_ATTN_PER_STEP = {"wgmma_bf16": {"K3": 5, "K4": 10}, "tinykv_wgmma_bf16": {"K5": 17}}
# the kernels of one image's f32 VAE decode 3x3 convs (SDXL's and SD1.5's
# decoder alike): conv_in (Cin 4) on the direct kernel, the other 32 (mid
# and up resnets, upsamplers, conv_out) on the 3xTF32 wgmma kernel; its one
# mid-block attention on the 3xTF32 GEMM
DECODE_CONVS = {"wgmma_tf32x3": 32, "direct_f32": 1}
DECODE_ATTENTION = "wgmma_tf32x3"
# the kernels of a step's bf16 3x3 convs (K6 and K8 together): all on wgmma,
# conv_in (Cin 4, padded to 8) and conv_out (Cout 4, the 8-column tile)
# included. SDXL-base: conv_in, 34 resnet convs, 2 upsamplers, conv_out;
# SD1.5: conv_in, 44 + 3, conv_out
CONV_SPLIT = {"wgmma_bf16": 38}
SD15_CONV_SPLIT = {"wgmma_bf16": 49}
# the all-kernel step's K13 launches (precompute included) by kernel: M = 2
# on the skinny kernel (a time projection per resnet, the time MLP's 2, and
# for SDXL the add embedding's 2), every other GEMM on wgmma
LINEAR_SPLIT = {"wgmma_bf16": 512, "skinny_bf16": 21}
SD15_LINEAR_SPLIT = {"wgmma_bf16": 144, "skinny_bf16": 24}


def by_kernel(*counters) -> dict:
    """Launches summed by kernel, the first field of the launch keys."""
    out = {}
    for c in counters:
        for key, n in c.by_key.items():
            out[key.split()[0]] = out.get(key.split()[0], 0) + n
    return out


def bf16apply_counters():
    """Launch counters of the default binding's kernel forms of K9-K11
    ("cuda_bf16apply")."""
    from stabletriton_tpu_torch.kernels import geglu as gg
    from stabletriton_tpu_torch.kernels import group_norm as gn
    from stabletriton_tpu_torch.kernels import layer_norm as ln

    return {"K9_bf16apply": gn.BF16APPLY_LAUNCHES, "K10_bf16apply": ln.BF16APPLY_LAUNCHES,
            "K11_bf16apply": gg.BF16APPLY_LAUNCHES}


def kernel_counters():
    """Launch counters of K8-K13 (and K6, the plain conv kernel, the
    attention kernels K1-K5, and the default binding's forms of K9-K11)."""
    from stabletriton_tpu_torch.kernels import conv_direct as cd
    from stabletriton_tpu_torch.kernels import flash_attention as fa
    from stabletriton_tpu_torch.kernels import geglu as gg
    from stabletriton_tpu_torch.kernels import group_norm as gn
    from stabletriton_tpu_torch.kernels import layer_norm as ln
    from stabletriton_tpu_torch.kernels import linear as lin
    from stabletriton_tpu_torch.kernels import time_embed as te

    return {"K8": cd.GN_LAUNCHES, "K9": gn.LAUNCHES, "K10": ln.LAUNCHES,
            "K11": gg.LAUNCHES, "K12": te.LAUNCHES, "K13": lin.LAUNCHES, "K6": cd.LAUNCHES,
            "attention": fa.LAUNCHES, **bf16apply_counters()}


class LinearDispatches:
    """Counts the ``linear`` op's dispatches by backend while entered, by
    registering counting wrappers around its implementations (restored on
    exit): a linear that reached cuBLAS would show as a "reference" call."""

    def __init__(self):
        from stabletriton_tpu_torch import ops

        self.ops = ops
        self.impls = {}
        for bk in ops.registered_ops()["linear"]:
            with ops.use_backends(linear=bk):
                self.impls[bk] = ops.resolve("linear")
        self.calls = dict.fromkeys(self.impls, 0)

    def __enter__(self):
        for bk, fn in self.impls.items():
            def counting(*a, bk=bk, fn=fn, **kw):
                self.calls[bk] += 1
                return fn(*a, **kw)
            self.ops.register("linear", bk)(counting)
        return self

    def __exit__(self, *exc):
        for bk, fn in self.impls.items():
            self.ops.register("linear", bk)(fn)


def attention_by_class(by_key: dict, kernel: str = "") -> dict:
    """Attention launches summed by class (the key's first field), counting
    only keys of ``kernel`` (e.g. "wgmma_bf16") when it is given."""
    out = dict.fromkeys(("K1", "K2", "K3", "K4", "K5"), 0)
    for key, n in by_key.items():
        cls, name = key.split()[:2]
        if not kernel or name == kernel:
            out[cls] += n
    return out


def expected_attention(per_kernel: dict, steps: int = 1) -> dict:
    """The launches by class of each bf16 attention kernel of ``per_kernel``
    (ATTN_PER_STEP's form), times ``steps``, as attention_by_class gives them."""
    return {kernel: {**dict.fromkeys(("K1", "K2", "K3", "K4", "K5"), 0),
                     **{cls: n * steps for cls, n in by_class.items()}}
            for kernel, by_class in per_kernel.items()}


def check_bf16_attention(by_key: dict, per_kernel: dict, steps: int, label: str) -> None:
    """Every bf16 attention launch of a run under its class as ``per_kernel``
    counts them (ATTN_PER_STEP's per-step counts by kernel and class, times
    the UNet steps run, summed over the kernels) and on the kernel its route
    takes: the autotune table's for the shape where the packaged table has
    it, else the rule's, ``per_kernel``'s split. The UNet's projections are
    fused, so self-attention reads the qkv entry point, cross the kv one."""
    bf16 = {k: n for k, n in by_key.items() if k.split()[1] in per_kernel}
    got = attention_by_class(bf16)
    want = dict.fromkeys(("K1", "K2", "K3", "K4", "K5"), 0)
    for by_class in per_kernel.values():
        for cls, n in by_class.items():
            want[cls] += n * steps
    if got != want:
        raise AssertionError(f"{label}: bf16 attention launches by class {got} in {steps} "
                             f"steps, expected {want}")
    off = []
    for key in bf16:
        f = dict(w.split("=", 1) for w in key.split() if "=" in w)
        b, h, d, sq, sk = (int(f[k]) for k in ("b", "h", "d", "sq", "sk"))
        want_kernel = routed_kernel(torch.bfloat16, b, sq, sk, h, d, "qkv" if sq == sk else "kv")
        if key.split()[1] != want_kernel:
            off.append((key, want_kernel))
    if off:
        raise AssertionError(f"{label}: bf16 attention launches off their routes' kernels: {off}")


def sdxl_step_inputs(dev):
    gen = torch.Generator(device=dev).manual_seed(7)
    return dict(
        sample=torch.randn((2, 128, 128, 4), generator=gen, device=dev).to(torch.bfloat16),
        ctx=torch.randn((2, 77, 2048), generator=gen, device=dev).to(torch.bfloat16),
        pooled=torch.randn((2, 1280), generator=gen, device=dev).to(torch.bfloat16),
        time_ids=torch.tensor([[1024.0, 1024, 0, 0, 1024, 1024]] * 2, device=dev))


def sd15_step_inputs(dev):
    """SD1.5 at 512^2: 64^2 latent, 768-wide context, no added conditioning."""
    gen = torch.Generator(device=dev).manual_seed(8)
    return dict(
        sample=torch.randn((2, 64, 64, 4), generator=gen, device=dev).to(torch.bfloat16),
        ctx=torch.randn((2, 77, 768), generator=gen, device=dev).to(torch.bfloat16),
        pooled=torch.zeros((2, 0), device=dev, dtype=torch.bfloat16),
        time_ids=torch.zeros((2, 0), device=dev))


def profile_step(run, label, *, unit="step", top=0):
    """Device time of two runs of ``run`` by kernel family, and the share of
    the device span in which no kernel ran (torch.profiler's CUDA kernel
    events; ``--profile`` only). Then the attention family by kernel name
    (the K5 launches' total among them), and with ``top`` the longest
    ``top`` kernels by name. Returns the kernel time, device span (ms a
    run), idle share and kernels a run."""
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            run()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        raise AssertionError(f"{label}: the profiler saw no kernel on the device")
    families = {"wgmma conv": ("conv_wgmma", "conv_gn_wgmma"),
                "direct conv": ("conv_direct_f32",), "scalar conv": ("conv_scalar",),
                "wgmma linear": ("linear_wgmma",), "split-K reduce": ("splitk_reduce",),
                "skinny linear": ("linear_skinny",),
                "attention": ("attn_", "gemm_wgmma_tf32x3"),
                "GroupNorm": ("gn_apply", "gn_stats", "gn_fold"),
                "LayerNorm/GEGLU/time_embed": ("ln_rows", "geglu_kernel", "time_embed_kernel"),
                "cuBLAS/cuDNN": ("gemm", "nvjet", "sm90_", "cutlass", "cudnn", "xmma", "conv2d")}
    by, counts, names, busy, end = {}, {}, {}, 0.0, spans[0][0]
    for t0, t1, name in spans:
        fam = next((f for f, keys in families.items() if any(k in name for k in keys)), "glue")
        by[fam] = by.get(fam, 0.0) + (t1 - t0) / 2e3
        counts[fam] = counts.get(fam, 0) + 1
        ms, n = names.get(name, (0.0, 0))
        names[name] = (ms + (t1 - t0) / 2e3, n + 1)
        busy += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
    span = end - spans[0][0]
    total = sum(by.values())
    log(f"profile, {label} (2 {unit}s; ms a {unit} by kernel family, launches a {unit}): "
        + ", ".join(f"{f} {ms:.2f} ({counts[f] // 2})" for f, ms in sorted(
            by.items(), key=lambda kv: -kv[1]))
        + f"; kernel time {total:.1f} ms a {unit}, device span {span / 2e3:.1f} ms a "
          f"{unit}, idle {1 - busy / span:.1%}")

    def short(name):  # the kernel's name and template arguments, no namespace or parameters
        name = name.replace("(anonymous namespace)::", "").replace("void ", "")
        return name.split("(")[0][:90]

    attn = sorted(((n, v) for n, v in names.items() if any(
        k in n for k in families["attention"])), key=lambda kv: -kv[1][0])
    if attn:
        log(f"  attention by kernel, {label} (ms a {unit}, launches a {unit}): " + ", ".join(
            f"{short(n)} {ms:.4f} ({c // 2})" for n, (ms, c) in attn))
    if top:
        log(f"  top {top} kernels, {label} (ms a {unit}, launches a {unit}, share of kernel "
            f"time): " + ", ".join(
                f"{short(n)} {ms:.3f} ({c // 2}, {ms / total:.1%})" for n, (ms, c) in sorted(
                    names.items(), key=lambda kv: -kv[1][0])[:top]))
    return {"kernel_ms": total, "span_ms": span / 2e3, "idle": 1 - busy / span,
            "kernels": len(spans) / 2, "families": by}


def phase_step_deviation(dev, cfg, params, inputs, all_per_step, precompute_linears,
                         attn_per_step, conv_split, linear_split, label, profile=False):
    """One full-width UNet step (cross K/V precompute included) under the
    default, the fused-op and the all-kernel binding, each against the
    reference binding, with the per-step launch counts of the attention
    classes and of K8-K13, and the convs' split over the wgmma and WMMA
    kernels (``conv_split``). Under the all-kernel binding every linear
    dispatch must reach the "cuda" backend and launch K13, its launches
    split over the kernels as ``linear_split``, and the precompute alone
    must launch ``precompute_linears``."""
    from stabletriton_tpu_torch import ops
    from stabletriton_tpu_torch.compile import (
        ALL_KERNEL_OVERRIDES, FUSED_OP_OVERRIDES, CompileConfig, fuse_attention_projections,
        resolve_binding)
    from stabletriton_tpu_torch.kernels import flash_attention as fa
    from stabletriton_tpu_torch.models.unet import precompute_cross_kv, unet_apply

    sample, ctx, pooled, time_ids = (inputs[k] for k in ("sample", "ctx", "pooled", "time_ids"))
    t = torch.full((2,), 500.0, device=dev)
    fused = fuse_attention_projections(params)
    bindings = {"default": resolve_binding(CompileConfig()),
                "fused_ops": resolve_binding(CompileConfig(overrides=FUSED_OP_OVERRIDES)),
                "all_kernels": resolve_binding(CompileConfig(overrides=ALL_KERNEL_OVERRIDES))}
    reference = resolve_binding(CompileConfig(backend="reference"))
    zero = dict.fromkeys([*all_per_step, *BF16APPLY_COUNTER.values()], 0)
    expect = {"default": {**zero, **default_per_step(all_per_step)},
              "fused_ops": {**zero, **{k: all_per_step[k] for k in FUSED_PER_STEP}},
              "all_kernels": {**all_per_step, "K13": all_per_step["K13"] + precompute_linears}}

    def kernel_step(binding):
        def run():
            with ops.use_backends(binding):
                kv = precompute_cross_kv(cfg, fused, ctx)
                return unet_apply(cfg, fused, sample, t, None, pooled, time_ids, cross_kv=kv)
        return run

    def run_reference():
        with ops.use_backends(reference):
            return unet_apply(cfg, params, sample, t, ctx, pooled, time_ids)

    runs = {"reference": run_reference,
            **{name: kernel_step(b) for name, b in bindings.items()}}
    counters = kernel_counters()
    result = {}
    lat = sample.shape[1]
    with torch.inference_mode():
        out_r = run_reference().float()
        for name in bindings:
            for c in counters.values():
                c.reset()
            with LinearDispatches() as linear_calls:
                out_k = runs[name]().float()
                torch.cuda.synchronize()
            counts = {k: c.count for k, c in counters.items() if k != "attention"}
            convs = by_kernel(counters["K6"], counters["K8"])
            linears = by_kernel(counters["K13"])
            attn = attention_by_class(fa.LAUNCHES.by_key)
            if not (torch.isfinite(out_k).all() and torch.isfinite(out_r).all()):
                raise AssertionError(f"{label} UNet step output is not finite ({name} binding)")
            mse = (out_k - out_r).square().mean().item()
            mx = (out_k - out_r).abs().max().item()
            log(f"step deviation, {label}, {name} binding vs reference: UNet {lat}x{lat} "
                f"latent, CFG batch 2, bf16: mse={mse:.3e} max_abs={mx:.3e} (gate "
                f"mse<{STEP_MSE_GATE:g}); output rms {out_r.square().mean().sqrt().item():.4f}; "
                f"launches in one step (precompute included) {json.dumps(counts)}, attention "
                f"{json.dumps(attn)}, linear dispatches {json.dumps(linear_calls.calls)}; "
                f"convs by kernel {json.dumps(convs)}, linears by kernel {json.dumps(linears)}")
            if not mse < STEP_MSE_GATE:
                raise AssertionError(f"{label} {name} step deviation mse {mse:.3e} exceeds "
                                     f"{STEP_MSE_GATE:g}")
            want_attn = {cls: sum(by_kernel[cls] for by_kernel in expected_attention(
                attn_per_step).values()) for cls in attn}
            if attn != want_attn:
                raise AssertionError(f"{label} {name}: attention launches {attn} in one step, "
                                     f"expected {want_attn}")
            check_bf16_attention(fa.LAUNCHES.by_key, attn_per_step, 1, f"{label} {name}")
            got = {k: counts[k] for k in expect[name]}
            if got != expect[name]:
                raise AssertionError(f"{label} {name}: launches {got} in one step, expected "
                                     f"{expect[name]}")
            if name == "all_kernels" and (linear_calls.calls.get("reference", 0)
                                          or linear_calls.calls["cuda"] != counts["K13"]):
                raise AssertionError(f"{label} all-kernel step: linear dispatches "
                                     f"{linear_calls.calls}, K13 launches {counts['K13']}")
            want_convs = gn_conv_split(conv_split, expect[name].get("K8", 0), 1)
            if convs != want_convs:
                raise AssertionError(f"{label} {name}: convs by kernel {convs}, expected "
                                     f"{want_convs}")
            if name == "all_kernels" and linears != linear_split:
                raise AssertionError(f"{label} all-kernel step: K13 by kernel {linears}, "
                                     f"expected {linear_split}")
            result[name] = {"mse": mse, "max_abs": mx, "launches": counts, "attention": attn,
                            "convs": convs, "linears": linears,
                            "by_key": {k: dict(counters[k].by_key) for k in ("K8", "K9")}}
        counters["K13"].reset()
        with ops.use_backends(bindings["all_kernels"]):
            precompute_cross_kv(cfg, fused, ctx)
        if counters["K13"].count != precompute_linears:
            raise AssertionError(f"{label}: the cross K/V precompute launched K13 "
                                 f"{counters['K13'].count} times, expected {precompute_linears}")
        torch.cuda.synchronize()
        times = {}
        for name in ("reference", "default", "fused_ops", "all_kernels", "all_kernels",
                     "fused_ops", "default", "reference"):
            t0 = time.perf_counter()
            runs[name]()
            torch.cuda.synchronize()
            times.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
        if profile:
            for name in ("default", "fused_ops", "all_kernels"):
                profile_step(runs[name], f"{label} {name} binding")
    log(f"step time, {label} (host clock around a synchronised step, cross K/V precompute "
        f"included, ms, two runs each): "
        + ", ".join(f"{k}={v[0]:.1f}/{v[1]:.1f}" for k, v in times.items()))
    del fused
    result["step_ms"] = times
    return result


# phase 4e: the bindings whose UNet step and denoise loop are replayed, the
# reference binding first (the others' replays are held against its eager
# step where they are not bit for bit equal to their own eager runs); the
# timed calls of each in a turn (eager, replay, replay, eager), after one
REPLAY_ITERS = 3
# CUgraphNodeType (cuda.h)
GRAPH_NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 4: "graph", 5: "empty",
                    6: "wait_event", 7: "event_record", 10: "mem_alloc", 11: "mem_free"}


def replay_configs() -> dict:
    from stabletriton_tpu_torch.compile import (ALL_KERNEL_OVERRIDES, FUSED_OP_OVERRIDES,
                                                CompileConfig)

    return {"reference": CompileConfig(backend="reference"), "default": CompileConfig(),
            "fused_ops": CompileConfig(overrides=FUSED_OP_OVERRIDES),
            "all_kernels": CompileConfig(overrides=ALL_KERNEL_OVERRIDES)}


def graph_nodes(graph) -> dict:
    """A captured graph's nodes by type, read through libcuda
    (cuGraphGetNodes, cuGraphNodeGetType) from the cudaGraph_t that
    ``CUDAGraph(keep_graph=True)`` keeps."""
    cuda = ctypes.CDLL("libcuda.so.1")
    raw, n = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t(0)
    if cuda.cuGraphGetNodes(raw, None, ctypes.byref(n)):
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if cuda.cuGraphGetNodes(raw, nodes, ctypes.byref(n)):
        raise RuntimeError("cuGraphGetNodes failed")
    out, kind = {}, ctypes.c_int()
    for node in nodes:
        if cuda.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)):
            raise RuntimeError("cuGraphNodeGetType failed")
        name = GRAPH_NODE_TYPES.get(kind.value, str(kind.value))
        out[name] = out.get(name, 0) + 1
    return out


def capture_record(entry) -> dict:
    """A captured graph's host seconds by piece and its nodes."""
    return {k: getattr(entry, k) for k in ("warmup_s", "enter_s", "capture_s", "end_s",
                                           "instantiate_s")} | {
        "nodes": graph_nodes(entry.graph)}


def eager_vs_replay(eager_fn, replay_fn) -> dict:
    """Host ms of each synchronised call and CUDA-event ms a call over
    REPLAY_ITERS back-to-back calls, of an eager function and its replay, in
    turns (eager, replay, replay, eager), each turn after one call."""
    out = {}
    for name, fn in (("eager", eager_fn), ("replay", replay_fn), ("replay", replay_fn),
                     ("eager", eager_fn)):
        fn()
        torch.cuda.synchronize()
        for _ in range(REPLAY_ITERS):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.setdefault(f"{name}_host_ms", []).append((time.perf_counter() - t0) * 1e3)
        out.setdefault(f"{name}_event_ms", []).append(timed_ms(fn, REPLAY_ITERS))
    return out


def launches_by_key(counters) -> dict:
    return {k: dict(c.by_key) for k, c in counters.items()}


def reset(counters) -> None:
    for c in counters.values():
        c.reset()


def tensors(tree) -> list:
    from stabletriton_tpu_torch.runtime.graphs import flatten

    leaves = []
    flatten(tree, leaves)
    return leaves


def held_to(label, name, got, eager, reference=None) -> dict:
    """A replay's output against its binding's eager run: bit for bit, or,
    except under the all-kernel binding (no cuBLAS call: it must be bit for
    bit), within the step gate (MSE against ``reference``, the reference
    binding's eager step, where given, else against the eager run)."""
    equal = all(torch.equal(a, b) for a, b in zip(tensors(got), tensors(eager)))
    a, b = torch.cat([t.float().flatten() for t in tensors(got)]), torch.cat(
        [t.float().flatten() for t in tensors(eager)])
    rec = {"bit_equal": equal, "max_abs": (a - b).abs().max().item(),
           "mse": (a - b).square().mean().item()}
    if not torch.isfinite(a).all():
        raise AssertionError(f"{label} {name}: the replay's output is not finite")
    if not equal:
        gate = rec["mse"] if reference is None else (
            a - reference.float().flatten()).square().mean().item()
        rec["gate_mse"] = gate
        log(f"  {label} {name}: replay NOT bit for bit equal to eager: max abs "
            f"{rec['max_abs']:.3e}, mse {rec['mse']:.3e}; gate mse {gate:.3e}")
        if name.startswith("all_kernels") or not gate < STEP_MSE_GATE:
            raise AssertionError(f"{label} {name}: replay differs from eager ({rec})")
    return rec


def phase_replay_step(dev, cfg, params, inputs, label, profile=False):
    """Phase 4e, the step: compile_unet_kv's precompute and step under each
    binding, eagerly (``__wrapped__``) and by replay, on the same inputs:
    bit for bit equal (held_to), the launches a replay counts equal to the
    eager step's key by key; the step's host and CUDA-event times, eager
    against replay; its capture and instantiate time; its graph's nodes
    beside the eager step's kernels from the profiler (and the replay's);
    peak memory of an eager step, the pool a capture reserves and peak
    memory of a replay; with ``profile`` the idle share of both."""
    from stabletriton_tpu_torch.compile import compile_unet_kv, fuse_attention_projections

    sample, ctx, pooled, time_ids = (inputs[k] for k in ("sample", "ctx", "pooled", "time_ids"))
    t = torch.full((2,), 500.0, device=dev)
    fused = fuse_attention_projections(params)
    counters = kernel_counters()
    results, ref = {}, None
    with torch.inference_mode():
        for name, config in replay_configs().items():
            p = params if name == "reference" else fused
            pre, _, step = compile_unet_kv(cfg, config)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            kv_eager = pre.__wrapped__(p, ctx)
            reset(counters)
            eager = step.__wrapped__(p, sample, t, kv_eager, pooled, time_ids)
            torch.cuda.synchronize()
            eager_launches = launches_by_key(counters)
            eager_peak = torch.cuda.max_memory_allocated(dev) - base
            if name == "reference":
                ref = eager
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(dev)
            pre(p, ctx)                                 # eager run, then the capture
            kv = pre(p, ctx)                            # a replay
            first = step(p, sample, t, kv, pooled, time_ids)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            pool = torch.cuda.memory_reserved(dev) - reserved
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
            reset(counters)
            out = step(p, sample, t, kv, pooled, time_ids)
            torch.cuda.synchronize()
            replay_peak = torch.cuda.max_memory_allocated(dev) - base
            if launches_by_key(counters) != eager_launches:
                raise AssertionError(f"{label} {name}: a replay counted "
                                     f"{launches_by_key(counters)}, the eager step "
                                     f"{eager_launches}")
            rec = {"precompute": held_to(label, f"{name} precompute", kv, kv_eager),
                   "first_call": held_to(label, name, first, eager, ref),
                   "step": held_to(label, name, out, eager, ref)}
            if len(step.captured) != 1 or len(pre.captured) != 1:
                raise AssertionError(f"{label} {name}: {len(step.captured)} step graphs")
            rec["graph"] = capture_record(next(iter(step.captured.values())))
            rec["precompute_graph"] = capture_record(next(iter(pre.captured.values())))

            def eager_fn():
                return step.__wrapped__(p, sample, t, kv, pooled, time_ids)

            def replay_fn():
                return step(p, sample, t, kv, pooled, time_ids)

            rec["eager_device_ms"], rec["eager_kernels"], _ = device_ms(eager_fn, 2)
            rec["replay_device_ms"], rec["replay_kernels"], _ = device_ms(replay_fn, 2)
            rec.update(eager_vs_replay(eager_fn, replay_fn))
            rec["memory_gib"] = {"eager_step_peak": eager_peak / 2**30, "pool": pool / 2**30,
                                 "replay_peak": replay_peak / 2**30}
            if profile:
                rec["profile"] = {"eager": profile_step(eager_fn, f"{label} {name} eager step"),
                                  "replay": profile_step(replay_fn, f"{label} {name} replay")}
            log(f"replay, {label} step, {name} binding: bit equal {rec['step']['bit_equal']} "
                f"(precompute {rec['precompute']['bit_equal']}); host ms eager "
                + "/".join(f"{v:.1f}" for v in rec["eager_host_ms"]) + ", replay "
                + "/".join(f"{v:.1f}" for v in rec["replay_host_ms"]) + "; event ms eager "
                + "/".join(f"{v:.2f}" for v in rec["eager_event_ms"]) + ", replay "
                + "/".join(f"{v:.2f}" for v in rec["replay_event_ms"])
                + f"; kernel ms eager {rec['eager_device_ms']:.2f} in {rec['eager_kernels']} "
                f"kernels, replay {rec['replay_device_ms']:.2f} in {rec['replay_kernels']}; "
                f"graph {json.dumps(rec['graph'])}; memory GiB "
                f"{json.dumps(rec['memory_gib'])}")
            results[name] = rec
            del pre, step, kv, first, out
            gc.collect()
            torch.cuda.empty_cache()
    log(f"replay {label} step " + json.dumps(results))
    return results


def phase_replay_requests(dev, ucfg, unet_params, other, profile=False):
    """Phase 4e, the loop: under each binding, four SDXL 1024^2 requests
    (SERVE_STEPS Euler steps, return_latents) through SDXLPipeline.txt2img:
    two of one signature (the first captures, the second replays with
    another prompt and seed) and two with a guidance interval holding the
    middle two steps (its own graph). Each result against the eager loop
    of the same make_denoise_loop on the same inputs (held_to); one graph a
    signature; a replay counts the launches of its signature's eager call,
    key by key. With ``profile`` also a 30-step request under the default
    binding, captured then replayed, and a profile of a replayed request.
    Logs walls, the host seconds of each capture by piece, graph nodes and
    peak memory."""
    from stabletriton_tpu_torch import ops
    from stabletriton_tpu_torch.compile import resolve_binding
    from stabletriton_tpu_torch.runtime import scheduler as sched
    from stabletriton_tpu_torch.runtime.denoise import norm_guidance_interval
    from stabletriton_tpu_torch.runtime.pipeline import SDXLPipeline

    (c1, c2, vcfg), params = other
    tok = StubTokenizer(c1.bos_token_id, c1.eos_token_id)
    s = [float(v) for v in sched.make_schedule(sched.SchedulerConfig(), SERVE_STEPS).sigmas]
    gi = ((s[2] + s[3]) / 2, (s[0] + s[1]) / 2)  # steps 1 and 2 of 0-3
    requests = [("a lighthouse at dusk", 11, None), ("a bowl of ramen", 12, None),
                ("a red fox in snow", 21, gi), ("a glass teapot", 22, gi)]
    counters = kernel_counters()
    results = {}
    for name, config in replay_configs().items():
        pipe = SDXLPipeline(unet_config=ucfg, clip_config=c1, clip2_config=c2,
                            vae_config=vcfg, params={"unet": unet_params, **params},
                            compile_config=config, device=dev)
        binding = resolve_binding(config)

        def request(prompt, seed, interval, steps=SERVE_STEPS):
            ids1 = tok.encode_batch([prompt], max_len=c1.max_position_embeddings)
            ids2 = tok.encode_batch([prompt], max_len=c2.max_position_embeddings, pad=0)
            reset(counters)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            lat = pipe.txt2img(ids1, ids2, height=1024, width=1024, steps=steps,
                               guidance_scale=5.0, seed=seed, return_latents=True,
                               guidance_interval=interval)
            torch.cuda.synchronize()
            rec = {"wall_s": time.perf_counter() - t0,
                   "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30}
            prog = pipe._program(1, 1024, 1024, steps, 5.0, "euler", True,
                                 norm_guidance_interval(interval, 5.0))
            return lat, rec, launches_by_key(counters), prog, ids1, ids2

        def eager_loop(prog, ids1, ids2, seed):
            neg1 = c1.empty_prompt_ids(1, ids1.shape[1])
            neg2 = c2.empty_prompt_ids(1, ids2.shape[1])
            ids = [torch.as_tensor(np.asarray(a), dtype=torch.long).to(dev)
                   for a in (ids1, ids2, neg1, neg2)]
            with torch.inference_mode(), ops.use_backends(binding):
                inputs = prog.loop_inputs(pipe.params, *ids, [seed])
                return prog.loop.__wrapped__(pipe.params["unet"], *inputs)

        rows, eager_counts = [], {}
        for i, (prompt, seed, interval) in enumerate(requests):
            lat, rec, counts, prog, ids1, ids2 = request(prompt, seed, interval)
            if lat.shape != (1, 128, 128, ucfg.in_channels):
                raise AssertionError(f"replay {name}: latents {tuple(lat.shape)}")
            rec["vs_eager"] = held_to("SDXL 1024^2 request", name, lat,
                                      eager_loop(prog, ids1, ids2, seed))
            if len(prog.loop.captured) != 1:
                raise AssertionError(f"replay {name}: {len(prog.loop.captured)} graphs for one "
                                     f"signature")
            if i % 2 == 0:
                eager_counts = counts
                rec["graph"] = capture_record(next(iter(prog.loop.captured.values())))
            elif counts != eager_counts:
                raise AssertionError(f"replay {name}: request {i} counted {counts}, its "
                                     f"signature's eager call {eager_counts}")
            rec["guidance_interval"] = interval
            rows.append(rec)
            log(f"replay, SDXL 1024^2 {SERVE_STEPS}-step request {i} ({'captures' if i % 2 == 0 else 'replays'}"
                f", guidance interval {interval}), {name} binding: " + json.dumps(rec))
        results[name] = rows
        del lat, prog
        if profile and name == "default":
            long = []
            for seed in (31, 32):
                lat, rec, _, prog, _, _ = request("a harbour at night", seed, None, steps=30)
                if not torch.isfinite(lat.float()).all():
                    raise AssertionError("the 30-step request's latents are not finite")
                long.append(rec)
            entry = next(iter(prog.loop.captured.values()))
            long[0]["graph"] = capture_record(entry)
            graph_ref = weakref.ref(entry.graph)
            pipe._cache.clear()
            del lat, prog, entry
            gc.collect()
            torch.cuda.empty_cache()
            if graph_ref() is not None:
                raise AssertionError("the 30-step request's graph outlived its pipeline")
            log("replay, SDXL 1024^2 30-step request, default binding (captures, replays): "
                + json.dumps(long))
            results["default_30_steps"] = long
        if profile and name in ("default", "all_kernels"):
            ids1 = tok.encode_batch(["a bowl of ramen"], max_len=c1.max_position_embeddings)
            ids2 = tok.encode_batch(["a bowl of ramen"], max_len=c2.max_position_embeddings, pad=0)
            results[f"{name}_profile"] = profile_step(
                lambda: pipe.txt2img(ids1, ids2, height=1024, width=1024, steps=SERVE_STEPS,
                                     guidance_scale=5.0, seed=12, return_latents=True),
                f"SDXL 1024^2 {SERVE_STEPS}-step request, {name} binding, replayed loop",
                unit="request")
        del pipe  # and so the graphs and the pool of its programs
        gc.collect()
        torch.cuda.empty_cache()
    return results


# phase 4f: the shallow pass's cases (the depths a family runs: SDXL's split
# at 1 runs no attention, at 2 keeps the 640-channel level's K1 / K2 live;
# SD1.5's at 1 runs its outermost CrossAttnUpBlock2D, K3 and K5), the
# bindings they run under, and the request modes, each against plain Euler
DEEP_CACHE_DEPTHS = {"SDXL-base": {1: set(), 2: {"K1", "K2"}}, "SD1.5": {1: {"K3", "K5"}}}
DEEP_CACHE_BINDINGS = ("default", "fused_ops", "all_kernels")
MODE_BINDINGS = ("default", "all_kernels")
# a mode's deviation from the reference binding's request of the same mode,
# prompt and seed may be at most this many times the binding's deviation on
# plain Euler: a wrong cache slice or a misplaced correction is O(1) off
MODE_MSE_RATIO = 10.0


def launch_summary(by_key: dict) -> dict:
    """Launches by counter: attention by launch key (its class and kernel
    lead it), the others summed by kernel (the key's first field)."""
    out = {}
    for name, keys in by_key.items():
        if not keys:
            continue
        out[name] = dict(sorted(keys.items())) if name == "attention" else {
            k: sum(n for key, n in keys.items() if key.split()[0] == k)
            for k in sorted({key.split()[0] for key in keys})}
    return out


def phase_deep_cache_steps(dev, cfg, params, inputs, label):
    """Phase 4f, the step: for each depth of DEEP_CACHE_DEPTHS[label] under
    each binding of DEEP_CACHE_BINDINGS, the full pass (``return_cache``)
    and the shallow pass on its cache, CFG batch 2, bf16, on the cross K/V
    precompute: the shallow eps equals the full eps bit for bit; the
    launches of each by kernel (the shallow pass's attention classes as
    DEEP_CACHE_DEPTHS says); both passes graphed on one pool, replays equal
    to their eager runs bit for bit and timed against them (host clock, CUDA
    events). Then compile_unet_deepcache's pair (depth 1, the context in
    place of the K/V cache) under each binding, eager against replay."""
    from stabletriton_tpu_torch import ops
    from stabletriton_tpu_torch.compile import (compile_unet_deepcache,
                                                fuse_attention_projections, resolve_binding)
    from stabletriton_tpu_torch.models.unet import (precompute_cross_kv, unet_apply,
                                                    unet_apply_shallow)
    from stabletriton_tpu_torch.runtime.graphs import Graphs

    sample, ctx, pooled, time_ids = (inputs[k] for k in ("sample", "ctx", "pooled", "time_ids"))
    t = torch.full((2,), 500.0, device=dev)
    fused = fuse_attention_projections(params)
    counters = kernel_counters()
    configs = replay_configs()
    results = {}
    with torch.inference_mode():
        for name in DEEP_CACHE_BINDINGS:
            binding = resolve_binding(configs[name])
            with ops.use_backends(binding):
                kv = precompute_cross_kv(cfg, fused, ctx)
            for depth, classes in DEEP_CACHE_DEPTHS[label].items():
                def full(p, x, tt, kv, te, tid, depth=depth):
                    with ops.use_backends(binding):
                        return unet_apply(cfg, p, x, tt, None, te, tid, cross_kv=kv,
                                          return_cache=True, cache_depth=depth)

                def shallow(p, x, tt, kv, te, tid, cache, depth=depth):
                    with ops.use_backends(binding):
                        return unet_apply_shallow(cfg, p, x, tt, None, te, tid, cache,
                                                  cross_kv=kv, cache_depth=depth)

                args = (fused, sample, t, kv, pooled, time_ids)
                reset(counters)
                eps, cache = full(*args)
                torch.cuda.synchronize()
                full_launches = launches_by_key(counters)
                reset(counters)
                eps_shallow = shallow(*args, cache)
                torch.cuda.synchronize()
                shallow_launches = launches_by_key(counters)
                case = f"{label} depth {depth}, {name} binding"
                if not torch.equal(eps_shallow, eps):
                    d = (eps_shallow.float() - eps.float()).abs().max().item()
                    raise AssertionError(f"deep cache, {case}: the shallow pass on the full "
                                         f"pass's cache differs from it (max abs {d:.3e})")
                got = {key.split()[0] for key in shallow_launches["attention"]}
                if got != classes:
                    raise AssertionError(f"deep cache, {case}: the shallow pass launched "
                                         f"attention classes {sorted(got)}, expected "
                                         f"{sorted(classes)}")
                graphs = Graphs()
                full_g, shallow_g = graphs.wrap(full), graphs.wrap(shallow)
                full_g(*args)                                # eager run, then the capture
                shallow_g(*args, cache)
                rec = {"shallow_bit_equal_full": True,
                       "replay_full": held_to(case, "all_kernels full" if name == "all_kernels"
                                              else "full", full_g(*args), (eps, cache)),
                       "replay_shallow": held_to(case, "all_kernels shallow"
                                                 if name == "all_kernels" else "shallow",
                                                 shallow_g(*args, cache), eps)}
                for g in (full_g, shallow_g):
                    if len(g.captured) != 1:
                        raise AssertionError(f"deep cache, {case}: {len(g.captured)} graphs")
                rec["full_graph"] = capture_record(next(iter(full_g.captured.values())))
                rec["shallow_graph"] = capture_record(next(iter(shallow_g.captured.values())))
                rec["full"] = eager_vs_replay(lambda: full(*args), lambda: full_g(*args))
                rec["shallow"] = eager_vs_replay(lambda: shallow(*args, cache),
                                                 lambda: shallow_g(*args, cache))
                rec["launches"] = {"full": launch_summary(full_launches),
                                   "shallow": launch_summary(shallow_launches)}
                log(f"deep cache, {case}: shallow == full bit for bit; launches of one step "
                    f"by kernel, shallow {json.dumps(rec['launches']['shallow'])}; full "
                    f"{json.dumps(rec['launches']['full'])}")
                log(f"  event ms eager / replay: full "
                    + "/".join(f"{v:.2f}" for v in rec["full"]["eager_event_ms"]) + " / "
                    + "/".join(f"{v:.2f}" for v in rec["full"]["replay_event_ms"])
                    + ", shallow "
                    + "/".join(f"{v:.2f}" for v in rec["shallow"]["eager_event_ms"]) + " / "
                    + "/".join(f"{v:.2f}" for v in rec["shallow"]["replay_event_ms"])
                    + f"; graph nodes full {rec['full_graph']['nodes']}, shallow "
                    f"{rec['shallow_graph']['nodes']}")
                results[f"depth {depth}, {name}"] = rec
                del full_g, shallow_g, graphs, eps, cache, eps_shallow
                gc.collect()
                torch.cuda.empty_cache()
            del kv
        for name in DEEP_CACHE_BINDINGS:
            full_g, shallow_g = compile_unet_deepcache(cfg, configs[name])
            args = (fused, sample, t, ctx, pooled, time_ids)
            eps, cache = full_g.__wrapped__(*args)
            full_g(*args)
            shallow_g(*args, cache)
            case = f"{label} compile_unet_deepcache, {name} binding"
            rec = {"full": held_to(case, "all_kernels full" if name == "all_kernels" else "full",
                                   full_g(*args), (eps, cache)),
                   "shallow": held_to(case, "all_kernels shallow" if name == "all_kernels"
                                      else "shallow", shallow_g(*args, cache), eps),
                   "full_ms": eager_vs_replay(lambda: full_g.__wrapped__(*args),
                                              lambda: full_g(*args)),
                   "shallow_ms": eager_vs_replay(lambda: shallow_g.__wrapped__(*args, cache),
                                                 lambda: shallow_g(*args, cache))}
            if not torch.equal(shallow_g.__wrapped__(*args, cache), eps):
                raise AssertionError(f"{case}: the shallow pass differs from the full pass")
            log(f"{case}: replays bit equal {rec['full']['bit_equal']} / "
                f"{rec['shallow']['bit_equal']}; event ms eager / replay: full "
                + "/".join(f"{v:.2f}" for v in rec["full_ms"]["eager_event_ms"]) + " / "
                + "/".join(f"{v:.2f}" for v in rec["full_ms"]["replay_event_ms"]) + ", shallow "
                + "/".join(f"{v:.2f}" for v in rec["shallow_ms"]["eager_event_ms"]) + " / "
                + "/".join(f"{v:.2f}" for v in rec["shallow_ms"]["replay_event_ms"]))
            results[f"compile_unet_deepcache, {name}"] = rec
            del full_g, shallow_g, eps, cache
            gc.collect()
            torch.cuda.empty_cache()
    log(f"deep cache {label} steps " + json.dumps(results))
    return results


def request_modes() -> dict:
    """Phase 4f's request modes: txt2img keywords (plain Euler first)."""
    from stabletriton_tpu_torch.runtime import scheduler as sched

    s = [float(v) for v in sched.make_schedule(sched.SchedulerConfig(), SERVE_STEPS).sigmas]
    middle = ((s[2] + s[3]) / 2, (s[0] + s[1]) / 2)  # steps 1 and 2 of 0-3
    return {"euler": {}, "deep_cache=2": {"deep_cache": 2},
            "deep_cache=(2, 2)": {"deep_cache": (2, 2)}, "heun": {"solver": "heun"},
            "dpmpp_2m": {"solver": "dpmpp_2m"}, "euler_a": {"solver": "euler_a"},
            "heun, deep_cache=2, interval": {"solver": "heun", "deep_cache": 2,
                                             "guidance_interval": middle}}


def phase_mode_requests(dev, ucfg, unet_params, other, profile=False, size=1024):
    """Phase 4f, the requests: each mode of request_modes() as SDXL
    ``size``^2 SERVE_STEPS-step requests (batch 1, return_latents) under each binding
    of MODE_BINDINGS, twice (the first captures, the second replays with
    another prompt and seed, its wall timed over REPLAY_ITERS replays):
    both equal to the eager loop on their inputs
    bit for bit, one graph a signature, the replay counting the first
    call's launches key by key. The reference binding's eager loop on the
    second request's inputs is each mode's yardstick: a binding's MSE under
    a mode may be at most MODE_MSE_RATIO times its MSE under plain Euler,
    and every output is finite. Then the ancestral noise of an image alone
    against the same image in slot 1 of a batch of two, bit for bit. With
    ``profile`` also a 30-step Heun request under the default binding,
    captured and replayed, and its graph freed with its pipeline."""
    from stabletriton_tpu_torch import ops
    from stabletriton_tpu_torch.compile import resolve_binding
    from stabletriton_tpu_torch.runtime.denoise import norm_deep_cache, norm_guidance_interval
    from stabletriton_tpu_torch.runtime.pipeline import SDXLPipeline, ancestral_noise

    (c1, c2, vcfg), params = other
    tok = StubTokenizer(c1.bos_token_id, c1.eos_token_id)
    modes = request_modes()
    calls = [("a lighthouse at dusk", 11), ("a bowl of ramen", 12)]
    counters = kernel_counters()

    def tokens(prompt):
        return (tok.encode_batch([prompt], max_len=c1.max_position_embeddings),
                tok.encode_batch([prompt], max_len=c2.max_position_embeddings, pad=0))

    def program(pipe, kw, steps=SERVE_STEPS):
        return pipe._program(1, size, size, steps, 5.0, kw.get("solver", "euler"), True,
                             norm_guidance_interval(kw.get("guidance_interval"), 5.0),
                             norm_deep_cache(kw.get("deep_cache")))

    def eager_loop(pipe, kw, prompt, seed):
        ids1, ids2 = tokens(prompt)
        ids = [torch.as_tensor(np.asarray(a), dtype=torch.long).to(dev) for a in (
            ids1, ids2, c1.empty_prompt_ids(1, ids1.shape[1]),
            c2.empty_prompt_ids(1, ids2.shape[1]))]
        prog = program(pipe, kw)
        with torch.inference_mode(), ops.use_backends(resolve_binding(pipe.compile_config)):
            return prog.loop.__wrapped__(pipe.params["unet"], *prog.loop_inputs(
                pipe.params, *ids, [seed]))

    def make_pipe(name):
        return SDXLPipeline(unet_config=ucfg, clip_config=c1, clip2_config=c2, vae_config=vcfg,
                            params={"unet": unet_params, **params},
                            compile_config=replay_configs()[name], device=dev)

    pipe = make_pipe("reference")
    reference = {mode: eager_loop(pipe, kw, *calls[1]) for mode, kw in modes.items()}
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    results = {}
    for name in MODE_BINDINGS:
        pipe = make_pipe(name)
        rows = {}
        for mode, kw in modes.items():
            rec, outs, counts = {"replay_s": []}, [], []
            for i, (prompt, seed) in enumerate(calls):
                ids1, ids2 = tokens(prompt)
                for n in range(1 if i == 0 else REPLAY_ITERS):  # the replay timed 3 times
                    reset(counters)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    lat = pipe.txt2img(ids1, ids2, height=size, width=size,
                                       steps=SERVE_STEPS, guidance_scale=5.0, seed=seed,
                                       return_latents=True, **kw)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                    if i == 0:
                        rec["first_s"] = wall
                    else:
                        rec["replay_s"].append(wall)
                    if n == 0:
                        counts.append(launches_by_key(counters))
                        outs.append(lat)
                    elif not torch.equal(lat, outs[-1]):
                        raise AssertionError(f"{mode}, {name}: a replay of the same request "
                                             f"gave other latents")
            prog = program(pipe, kw)
            if len(prog.loop.captured) != 1:
                raise AssertionError(f"{mode}, {name}: {len(prog.loop.captured)} graphs for "
                                     f"one signature")
            if counts[1] != counts[0]:
                raise AssertionError(f"{mode}, {name}: the replay counted {counts[1]}, the "
                                     f"first call {counts[0]}")
            for i, (prompt, seed) in enumerate(calls):
                if not torch.equal(outs[i], eager_loop(pipe, kw, prompt, seed)):
                    raise AssertionError(f"{mode}, {name}: call {i} differs from the eager "
                                         f"loop on its inputs")
            if not all(torch.isfinite(o.float()).all() for o in outs):
                raise AssertionError(f"{mode}, {name}: latents not finite")
            diff = outs[1].float() - reference[mode].float()
            rec["vs_reference"] = {"max_abs": diff.abs().max().item(),
                                   "mse": diff.square().mean().item()}
            rec["graph"] = capture_record(next(iter(prog.loop.captured.values())))
            rows[mode] = rec
            log(f"mode {mode}, SDXL {size}^2 {SERVE_STEPS}-step request, {name} binding: "
                f"bit equal to the eager loop (capture and replay); " + json.dumps(rec))
        euler = rows["euler"]
        for mode, rec in rows.items():
            rec["replay_vs_euler"] = min(rec["replay_s"]) / min(euler["replay_s"])
            if rec["vs_reference"]["mse"] > MODE_MSE_RATIO * euler["vs_reference"]["mse"]:
                raise AssertionError(f"{mode}, {name}: MSE against the reference binding "
                                     f"{rec['vs_reference']['mse']:.3e}, over "
                                     f"{MODE_MSE_RATIO:g} x plain Euler's "
                                     f"{euler['vs_reference']['mse']:.3e}")
        log(f"modes, {name} binding (replayed walls s, the least x plain Euler's; MSE "
            f"against the reference binding): " + ", ".join(
                f"{m} " + "/".join(f"{v:.3f}" for v in r["replay_s"])
                + f" ({r['replay_vs_euler']:.2f}x; {r['vs_reference']['mse']:.3e})"
                for m, r in rows.items()))
        results[name] = rows
        if profile and name == "default":
            kw = {"solver": "heun"}
            long = []
            for prompt, seed in calls:
                ids1, ids2 = tokens(prompt)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                lat = pipe.txt2img(ids1, ids2, height=size, width=size, steps=30,
                                   guidance_scale=5.0, seed=seed, return_latents=True, **kw)
                torch.cuda.synchronize()
                long.append({"wall_s": time.perf_counter() - t0})
                if not torch.isfinite(lat.float()).all():
                    raise AssertionError("the 30-step Heun request's latents are not finite")
            entry = next(iter(program(pipe, kw, steps=30).loop.captured.values()))
            long[0]["graph"] = capture_record(entry)
            graph_ref = weakref.ref(entry.graph)
            pipe._cache.clear()
            del lat, entry
            gc.collect()
            torch.cuda.empty_cache()
            if graph_ref() is not None:
                raise AssertionError("the 30-step Heun request's graph outlived its program")
            log(f"mode heun, SDXL {size}^2 30-step request, default binding (captures, replays): "
                + json.dumps(long))
            results["default_heun_30_steps"] = long
        del pipe
        gc.collect()
        torch.cuda.empty_cache()
    lat = size // vcfg.spatial_scale_factor
    shape = (lat, lat, ucfg.in_channels)
    alone = ancestral_noise([12], SERVE_STEPS, shape, dev)
    pair = ancestral_noise([11, 12], SERVE_STEPS, shape, dev)
    if alone.shape != (SERVE_STEPS, 1, *shape) or not torch.equal(pair[:, 1], alone[:, 0]):
        raise AssertionError("the ancestral noise of an image alone differs from its noise "
                             "in slot 1 of a batch of two")
    log("ancestral noise: an image alone and in slot 1 of a batch of two, bit for bit")
    return results


class StubTokenizer:
    """Deterministic ids without vocab files: BOS, one id per character, EOS,
    then padding (CLIP pools at argmax(ids == eos))."""

    def __init__(self, bos: int, eos: int):
        self.bos, self.eos = bos, eos

    def encode_batch(self, texts, *, max_len=77, pad=None, **kw):
        pad = self.eos if pad is None else pad
        out = np.full((len(texts), max_len), pad, np.int32)
        for i, t in enumerate(texts):
            ids = [self.bos] + [(ord(c) % 400) + 300 for c in t[: max_len - 2]] + [self.eos]
            out[i, : len(ids)] = ids
        return out


def make_other_params(dev):
    """SDXL's CLIP and VAE configs and random weights (fixed seeds)."""
    from stabletriton_tpu_torch.models import clip as clip_mod
    from stabletriton_tpu_torch.models import vae as vae_mod

    c1, c2 = clip_mod.sdxl_text_encoder_config(), clip_mod.sdxl_text_encoder_2_config()
    vcfg = vae_mod.sdxl_vae_config()
    params = {
        "text_encoder": clip_mod.init_clip_params(c1, 1, device=dev),
        "text_encoder_2": clip_mod.init_clip_params(c2, 2, device=dev),
        "vae": vae_mod.init_vae_params(vcfg, 3, device=dev),
    }
    return (c1, c2, vcfg), params


def make_sd15_other_params(dev):
    """SD1.5's CLIP-L (in both encoder slots: the pipeline reads one) and
    its VAE, random weights from fixed seeds."""
    from stabletriton_tpu_torch.models import clip as clip_mod
    from stabletriton_tpu_torch.models import vae as vae_mod

    c1, vcfg = clip_mod.sd15_text_encoder_config(), vae_mod.sd15_vae_config()
    params = {"text_encoder": clip_mod.init_clip_params(c1, 21, device=dev),
              "vae": vae_mod.init_vae_params(vcfg, 22, device=dev)}
    return (c1, c1, vcfg), params


def check_images(done, size):
    for i, (img, latency) in enumerate(done):
        ok = (img.shape == (size, size, 3) and np.isfinite(img).all()
              and img.min() >= -1.0 and img.max() <= 1.0)
        log(f"request {i}: latency {latency:.3f} s, image {img.shape} "
            f"range [{img.min():.3f}, {img.max():.3f}] mean {img.mean():.4f}")
        if not ok:
            raise AssertionError(f"request {i}: bad image")


SERVE_STEPS = 4  # Euler steps of every served request


def serve(dev, ucfg, unet_params, other, compile_config, prompts, counters, solo=None, *,
          size=1024, guidance=5.0, scheduler_config=None):
    """A ServingEngine over a full-width pipeline (``scheduler_config``: the
    pipeline's, where not the default): submit ``prompts`` together
    (one signature, so they co-batch), then ``solo`` alone. The same
    requests with other seeds go first: each bucket's first request runs its
    denoise loop eagerly and captures it, so the counted requests replay.
    The counters are set to 0 just before the first requests and again just
    before the counted ones, and read just after each: the replays must
    count the first requests' launches, key by key."""
    from stabletriton_tpu_torch.runtime.pipeline import SDXLPipeline
    from stabletriton_tpu_torch.runtime.serving import Request, ServingEngine

    (c1, c2, vcfg), params = other
    pipe = SDXLPipeline(unet_config=ucfg, clip_config=c1, clip2_config=c2,
                        vae_config=vcfg, params={"unet": unet_params, **params},
                        compile_config=compile_config, device=dev,
                        **({} if scheduler_config is None
                           else {"scheduler_config": scheduler_config}))
    tok = StubTokenizer(c1.bos_token_id, c1.eos_token_id)
    engine = ServingEngine(pipe, tok, tok, max_wait_s=0.5)
    kw = dict(height=size, width=size, steps=SERVE_STEPS, guidance_scale=guidance,
              solver="euler")

    def run(shift):
        """The co-batched requests, then the solo one: (image, latency) each."""
        t0 = time.perf_counter()
        futs = [engine.submit(Request(prompt=p, seed=s + shift, **kw)) for p, s in prompts]
        done = []
        for f in futs:
            done.append((f.result(timeout=900), time.perf_counter() - t0))
        if solo is not None:
            t1 = time.perf_counter()
            fut = engine.submit(Request(prompt=solo[0], seed=solo[1] + shift, **kw))
            done.append((fut.result(timeout=900), time.perf_counter() - t1))
        return done

    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset(counters)
        first = run(1000)
        first_by_key = launches_by_key(counters)
        first_peak = torch.cuda.max_memory_allocated(dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset(counters)
        done = run(0)
        counts = {k: c.count for k, c in counters.items()}
        by_key = launches_by_key(counters)
        peak = torch.cuda.max_memory_allocated(dev)
        captures = [capture_record(e) for prog in pipe._cache.values()
                    for e in prog.loop.captured.values()]
    finally:
        engine.close()
    del pipe, engine
    gc.collect()  # the pipeline's program cache holds closures over the pipeline
    torch.cuda.empty_cache()
    log("first requests (eager loops and their captures): latency "
        + ", ".join(f"{t:.3f}" for _, t in first) + f" s, peak device memory "
        f"{first_peak / 2**30:.2f} GiB; graphs " + json.dumps(captures))
    check_images(done, size)
    log(f"peak device memory during serving (replays): {peak / 2**30:.2f} GiB")
    log(f"kernel launches during serving: {json.dumps(counts)}")
    for name, keys in by_key.items():
        for key, n in sorted(keys.items()):
            log(f"  {name} {key}: {n}")
    if by_key != first_by_key:
        raise AssertionError(f"serving: the replayed requests launched {by_key}, the first "
                             f"(eager) ones {first_by_key}")
    if len(captures) != 1 + (solo is not None):
        raise AssertionError(f"serving: {len(captures)} graphs for the buckets run")
    return done, counts, by_key


def check_decode_convs(conv_by_key: dict, images: int, label: str) -> None:
    """Each image's f32 decode launched its 3x3 convs on the kernels of
    DECODE_CONVS (the UNet's convs are bf16 and named otherwise)."""
    got = {k: sum(n for key, n in conv_by_key.items() if key.split()[0] == k)
           for k in DECODE_CONVS}
    want = {k: n * images for k, n in DECODE_CONVS.items()}
    log(f"{label}: f32 decode convs by kernel {json.dumps(got)} for {images} images")
    if got != want:
        raise AssertionError(f"{label}: f32 decode convs {got}, expected {want}")


def check_decode_attention(attn_by_key: dict, images: int, label: str) -> None:
    """Each image's f32 decode ran its mid-block attention (K3, h=1, d=512)
    once, on the 3xTF32 GEMM."""
    got = attention_by_class(attn_by_key, DECODE_ATTENTION)
    want = {**dict.fromkeys(got, 0), "K3": images}
    log(f"{label}: f32 attention on {DECODE_ATTENTION} {json.dumps(got)} for {images} images")
    if got != want:
        raise AssertionError(f"{label}: f32 attention on {DECODE_ATTENTION} {got}, expected "
                             f"{want}")


def unet_steps(conv_by_key: dict, ucfg, kernel: str) -> int:
    """UNet steps run, from the conv_out launches (one conv with Cout = 4
    per step) of the given conv kernel counter's keys."""
    return sum(n for key, n in conv_by_key.items() if key.startswith(kernel)
               and key.split("->")[1].split()[0] == str(ucfg.out_channels))


# The same seed alone (bucket 1) and co-batched (bucket 2) gives images up to
# ~0.12-0.16 apart (max abs, images in [-1, 1]) under every binding, the
# reference one (cuBLAS, cuDNN, SDPA; no kernel of the port) included: the
# kernels' plans and cuBLAS's algorithms depend on M, and 4 bf16 Euler steps
# through random full-width weights amplify a rounding apart (H100, see
# ROADMAP C2). A binding must stay under SOLO_VS_BATCHED_BOUND, about twice
# the largest measured, and a kernel binding within SOLO_VS_BATCHED_RATIO of
# the reference binding's diff on the same requests: more would be the
# kernels' own doing.
SOLO_VS_BATCHED_BOUND = 0.3
SOLO_VS_BATCHED_RATIO = 2.0


def solo_vs_batched(done, label: str) -> float:
    """Max abs diff of request 0 (co-batched) and request 2 (the same seed
    alone)."""
    diff = float(np.abs(done[0][0] - done[2][0]).max())
    log(f"same seed, batched (bucket 2) vs solo (bucket 1), {label} binding: max abs diff "
        f"{diff:.3e}")
    return diff


def phase_serving_reference(dev, ucfg, unet_params, other):
    """Phase 5e: the reference binding (no kernel of the port: cuBLAS,
    cuDNN, SDPA) serves two co-batched requests and the first one's seed
    alone, to set the kernel bindings' solo-vs-batched diffs beside it."""
    from stabletriton_tpu_torch.compile import CompileConfig

    done, _, _ = serve(dev, ucfg, unet_params, other, CompileConfig(backend="reference"),
                       counters={}, prompts=[("a lighthouse at dusk", 11), ("a bowl of ramen", 12)],
                       solo=("a lighthouse at dusk", 11))
    return solo_vs_batched(done, "reference")


def check_solo_vs_batched(diffs: dict, label: str) -> None:
    """Each binding's solo-vs-batched diff under the bound, and, where the
    reference binding ran the same requests, within the ratio of its diff."""
    log(f"{label} solo vs batched max abs diff by binding: {json.dumps(diffs)} (bound "
        f"{SOLO_VS_BATCHED_BOUND:g}, {SOLO_VS_BATCHED_RATIO:g}x the reference binding's)")
    for name, diff in diffs.items():
        ref = diffs.get("reference")
        if not diff <= SOLO_VS_BATCHED_BOUND or (
                ref is not None and not diff <= SOLO_VS_BATCHED_RATIO * ref):
            raise AssertionError(f"{label} {name} binding: the same seed alone and co-batched "
                                 f"differs by {diff:.3e} (reference binding {ref})")


def phase_decode_deviation(dev, vcfg, vae_params, profile=False):
    """One 1024^2 f32 decode (random latents from a seed) under the default
    binding (the tf32 conv, the f32 attention, linear and GroupNorm paths)
    against the reference binding's (cuDNN and cuBLAS with TF32 off), each
    timed on the host clock around a synchronised decode; with ``profile``
    the default binding's decode by kernel."""
    from stabletriton_tpu_torch import ops
    from stabletriton_tpu_torch.compile import CompileConfig, resolve_binding
    from stabletriton_tpu_torch.runtime.pipeline import _decode_images

    gen = torch.Generator(device=dev).manual_seed(9)
    lat = torch.randn((1, 128, 128, 4), generator=gen, device=dev)
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    images, times = {}, {}
    try:
        with torch.inference_mode():
            for name in ("reference", "default", "default", "reference"):
                with ops.use_backends(resolve_binding(CompileConfig(
                        **({"backend": "reference"} if name == "reference" else {})))):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    images[name] = _decode_images(vcfg, vae_params, lat).float()
                    torch.cuda.synchronize()
                    times.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
            if profile:
                with ops.use_backends(resolve_binding(CompileConfig())):
                    profile_step(lambda: _decode_images(vcfg, vae_params, lat),
                                 "1024^2 f32 decode, default binding", unit="decode", top=12)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    got, ref = images["default"], images["reference"]
    if got.shape != (1, 1024, 1024, 3) or not torch.isfinite(got).all():
        raise AssertionError(f"decode: {tuple(got.shape)}, finite {bool(torch.isfinite(got).all())}")
    max_abs = (got - ref).abs().max().item()
    log(f"decode deviation, 1024^2 f32, default binding vs reference binding (TF32 off): "
        f"max_abs={max_abs:.3e} (limit {DECODE_MAX_ABS:g}) "
        f"mse={(got - ref).square().mean().item():.3e}; image rms "
        f"{ref.square().mean().sqrt().item():.4f}; decode ms (host clock, two runs each): "
        + ", ".join(f"{k}={v[0]:.1f}/{v[1]:.1f}" for k, v in times.items()))
    if not max_abs <= DECODE_MAX_ABS:
        raise AssertionError(f"decode: max abs {max_abs:.3e} against the reference binding "
                             f"exceeds {DECODE_MAX_ABS:g}")


def decoder_norms(other) -> int:
    """The GroupNorms of one image's VAE decode: the decoder's norm scales."""
    return sum(1 for k in other[1]["vae"] if k.endswith(
        ("norm1.weight", "norm2.weight", "group_norm.weight", "conv_norm_out.weight")))


def check_default_forms(by_key, all_per_step, steps, images, norms, label) -> None:
    """The default binding's kernel forms' launches in a serving run (the
    counters set to 0 just before its requests): their per-step counts
    (default_per_step) times the UNet steps run, and the f32 VAE decoder's
    ``norms`` GroupNorms once per image."""
    want = {k: n * steps for k, n in default_per_step(all_per_step).items()}
    want["K9_bf16apply"] += norms * images
    got = {k: sum(by_key[k].values()) for k in want}
    f32 = sum(n for key, n in by_key["K9_bf16apply"].items() if key.startswith("f32"))
    log(f"{label}: kernel-form launches {got} ({f32} GroupNorms in f32) over {steps} UNet "
        f"steps and {images} images")
    if got != want or f32 != norms * images:
        raise AssertionError(f"{label}: kernel-form launches {got}, {f32} in f32; expected "
                             f"{want}, {norms * images} in f32")


def phase_serving(dev, ucfg, unet_params, other):
    """Phase 5: the default binding, two co-batched requests and one alone.
    The bf16 attention, the decode's convs and attention, and the kernel
    forms of GroupNorm, LayerNorm and GEGLU launch their counts per UNet
    step and per image."""
    from stabletriton_tpu_torch.compile import CompileConfig
    from stabletriton_tpu_torch.kernels import conv_direct as cd
    from stabletriton_tpu_torch.kernels import flash_attention as fa

    counters = {"flash_attention": fa.LAUNCHES, "conv3x3": cd.LAUNCHES, **bf16apply_counters()}
    # two requests with one signature co-batch; the third repeats the first
    # one's seed alone
    done, counts, by_key = serve(
        dev, ucfg, unet_params, other, CompileConfig(), counters=counters,
        prompts=[("a lighthouse at dusk", 11), ("a bowl of ramen", 12)],
        solo=("a lighthouse at dusk", 11))
    diff = solo_vs_batched(done, "default")
    for name, n in counts.items():
        if n == 0:
            raise AssertionError(f"{name}: no launch during the serving run")
    attn = attention_by_class(by_key["flash_attention"])
    for k in ("K1", "K2", "K3"):
        if attn[k] == 0:
            raise AssertionError(f"no attention launch of class {k} during serving")
    steps = unet_steps(by_key["conv3x3"], ucfg, "wgmma_bf16")
    check_bf16_attention(by_key["flash_attention"], ATTN_PER_STEP, steps,
                         "default-binding serving")
    check_decode_convs(by_key["conv3x3"], len(done), "default-binding serving")
    check_decode_attention(by_key["flash_attention"], len(done), "default-binding serving")
    check_default_forms(by_key, ALL_PER_STEP, steps, len(done), decoder_norms(other),
                        "default-binding serving")
    return by_key, diff


def phase_serving_fused(dev, ucfg, unet_params, other):
    """Phase 5b: the fused-op binding, two co-batched requests and the first
    one's seed alone. Every K8-K11 launch count must be its per-step count
    times the UNet steps run, which the conv_out launches (one K8 launch with
    Cout = 4 per step) give; K9 also runs each f32 VAE decoder GroupNorm once
    per image."""
    from stabletriton_tpu_torch.compile import FUSED_OP_OVERRIDES, CompileConfig

    counters = kernel_counters()
    done, counts, by_key = serve(
        dev, ucfg, unet_params, other, CompileConfig(overrides=FUSED_OP_OVERRIDES),
        counters=counters, prompts=[("a red fox in snow", 21), ("a glass teapot", 22)],
        solo=("a red fox in snow", 21))
    diff = solo_vs_batched(done, "fused-op")
    steps = unet_steps(by_key["K8"], ucfg, "wgmma_bf16")
    vae_norms = decoder_norms(other)
    k9_f32 = sum(n for key, n in by_key["K9"].items() if key.startswith("f32"))
    log(f"fused-op serving: {steps} UNet steps, {len(done)} images, "
        f"{vae_norms} VAE GroupNorms per image")
    if steps == 0:
        raise AssertionError("no UNet step ran through K8 during the fused-op serving run")
    want = {k: n * steps for k, n in FUSED_PER_STEP.items()}
    want["K9"] += vae_norms * len(done)
    for k, n in want.items():
        if counts[k] != n:
            raise AssertionError(f"{k}: {counts[k]} launches during fused-op serving, "
                                 f"expected {n}")
    if k9_f32 != vae_norms * len(done):
        raise AssertionError(f"K9: {k9_f32} f32 launches, expected {vae_norms * len(done)}")
    # every K8 launch at Cout > 8 (the 34 resnet convs a step) on the
    # warp-specialised kernel, conv_out's on the 8-column form
    routes = {}
    for key, n in by_key["K8"].items():
        routes[key.split()[0]] = routes.get(key.split()[0], 0) + n
    if routes != {"wgmma_gn_bf16": (FUSED_PER_STEP["K8"] - 1) * steps, "wgmma_bf16": steps}:
        raise AssertionError(f"K8 by route during fused-op serving: {routes}, expected "
                             f"{FUSED_PER_STEP['K8'] - 1} a step on wgmma_gn_bf16 and conv_out's "
                             f"one on wgmma_bf16, over {steps} steps")
    check_bf16_attention(by_key["attention"], ATTN_PER_STEP, steps, "fused-op serving")
    check_decode_convs(by_key["K6"], len(done), "fused-op serving")
    check_decode_attention(by_key["attention"], len(done), "fused-op serving")
    return counts, by_key, diff


def phase_serving_all(dev, ucfg, unet_params, other):
    """Phase 5d: the all-kernel binding, two co-batched requests and the
    first one's seed alone. K8-K11 as in phase 5b; K12 must launch its
    per-step count times the UNet steps run; K13 its per-step count times the
    steps, plus the cross K/V precompute once per generation (a generation
    runs SERVE_STEPS steps) and the f32 VAE decoder's mid-attention
    projections once per image."""
    from stabletriton_tpu_torch.compile import ALL_KERNEL_OVERRIDES, CompileConfig

    counters = kernel_counters()
    done, counts, by_key = serve(
        dev, ucfg, unet_params, other, CompileConfig(overrides=ALL_KERNEL_OVERRIDES),
        counters=counters, prompts=[("a paper boat on a pond", 41), ("a clock tower", 42)],
        solo=("a paper boat on a pond", 41))
    diff = solo_vs_batched(done, "all-kernel")
    steps = unet_steps(by_key["K8"], ucfg, "wgmma_bf16")
    gens, images = steps // SERVE_STEPS, len(done)
    vae_norms = decoder_norms(other)
    want = {k: n * steps for k, n in ALL_PER_STEP.items()}
    want["K9"] += vae_norms * images
    want["K13"] += PRECOMPUTE_LINEARS * gens + VAE_LINEARS * images
    # the precompute's GEMMs are the only ones over the 2048-wide context
    precompute = sum(n for key, n in by_key["K13"].items() if " k=2048 " in key)
    vae = sum(n for key, n in by_key["K13"].items() if key.startswith("wgmma_tf32x3 "))
    log(f"all-kernel serving: {steps} UNet steps, {gens} generations, {images} images; "
        f"K13 precompute launches {precompute}, VAE launches {vae}")
    if steps == 0 or steps % SERVE_STEPS:
        raise AssertionError(f"all-kernel serving ran {steps} UNet steps")
    for k, n in want.items():
        if counts[k] != n:
            raise AssertionError(f"{k}: {counts[k]} launches during all-kernel serving, "
                                 f"expected {n}")
    if precompute != PRECOMPUTE_LINEARS * gens or vae != VAE_LINEARS * images:
        raise AssertionError(f"K13: {precompute} precompute and {vae} VAE launches, expected "
                             f"{PRECOMPUTE_LINEARS * gens} and {VAE_LINEARS * images}")
    check_bf16_attention(by_key["attention"], ATTN_PER_STEP, steps, "all-kernel serving")
    check_decode_convs(by_key["K6"], images, "all-kernel serving")
    check_decode_attention(by_key["attention"], images, "all-kernel serving")
    return counts, by_key, diff


def phase_serving_sd15(dev, ucfg, unet_params, other):
    """Phase 5c: SD1.5 at 512^2 under the default binding, two co-batched
    requests and the first one's seed alone (4 Euler steps, guidance 7.5).
    The bf16 attention launches of each class must be its per-step count
    times the UNet steps run (from the conv_out launches); the VAE decode
    adds one f32 K3 launch per image. The kernel forms of GroupNorm,
    LayerNorm and GEGLU launch their counts per step and per image."""
    from stabletriton_tpu_torch.compile import CompileConfig
    from stabletriton_tpu_torch.kernels import conv_direct as cd
    from stabletriton_tpu_torch.kernels import flash_attention as fa

    counters = {"flash_attention": fa.LAUNCHES, "conv3x3": cd.LAUNCHES, **bf16apply_counters()}
    done, counts, by_key = serve(
        dev, ucfg, unet_params, other, CompileConfig(), counters=counters,
        prompts=[("a watercolor of a harbour", 31), ("an owl on a branch", 32)],
        solo=("a watercolor of a harbour", 31), size=512, guidance=7.5)
    check_solo_vs_batched({"default": solo_vs_batched(done, "SD1.5 default")}, "SD1.5")
    steps = unet_steps(by_key["conv3x3"], ucfg, "wgmma_bf16")
    log(f"SD1.5 serving: {steps} UNet steps, {len(done)} images")
    if steps == 0:
        raise AssertionError("SD1.5 serving: no UNet step ran")
    check_bf16_attention(by_key["flash_attention"], SD15_ATTN_PER_STEP, steps, "SD1.5 serving")
    check_decode_convs(by_key["conv3x3"], len(done), "SD1.5 serving")
    check_decode_attention(by_key["flash_attention"], len(done), "SD1.5 serving")
    check_default_forms(by_key, SD15_ALL_PER_STEP, steps, len(done), decoder_norms(other),
                        "SD1.5 serving")
    return by_key


# phase 5v: SD2.1-768 as the benchmark's sd-2.1-768.batch8 cell serves it.
# Its UNet has SD1.5's topology (22 resnets, 16 Transformer2D of one block),
# so the kernel forms launch SD1.5's per-step counts; its bf16 attention per
# UNet step by kernel and class (d=64 everywhere): level 0 (h=5, unpacked)
# self S=9216 5 x K3 and cross 5 x K5, level 1 (h=10, two heads a 128-lane
# block) self S=2304 5 x K2 and cross 5 x K1, level 2 and the mid block
# (h=20) self 5 + 1 x K1 and cross 5 + 1 x K1; self-attention on
# attn_wgmma_bf16, cross (77 keys) on the tiny-KV kernel
SD21_ATTN_PER_STEP = {"wgmma_bf16": {"K1": 6, "K2": 5, "K3": 5},
                      "tinykv_wgmma_bf16": {"K1": 11, "K5": 5}}
SD21_SIZE = 768
SD21_PROMPTS = ["a lighthouse on a cliff at dawn", "a bowl of ramen", "an owl", "a red kite "
                "over a wheat field in late summer light", "a glass teapot", "a city at night",
                "a watercolor of a harbour with fishing boats", "a cat"]


def make_sd21_other_params(dev):
    """SD2.1's text encoder as the benchmark's configuration states it
    (OpenCLIP-H's 23 layers, read after final_layer_norm; pad id 0, the
    tokenizer's "!") in both encoder slots, and SD1.5's VAE; random weights
    from fixed seeds."""
    import dataclasses

    from stabletriton_tpu_torch.models import clip as clip_mod
    from stabletriton_tpu_torch.models import vae as vae_mod

    c1 = dataclasses.replace(clip_mod.sd2_text_encoder_config(), num_layers=23, pad_token_id=0)
    vcfg = vae_mod.sd15_vae_config()
    params = {"text_encoder": clip_mod.init_clip_params(c1, 61, device=dev),
              "vae": vae_mod.init_vae_params(vcfg, 62, device=dev)}
    return (c1, c1, vcfg), params


def phase_serving_sd21(dev):
    """Phase 5v: SD2.1-768 under v-prediction and the default binding, eight
    co-batched 768^2 requests (UNet batch 16; 4 Euler steps, guidance 7.5).
    Every bf16 attention launch is at b=16 and the launches of each kernel
    and class are SD21_ATTN_PER_STEP's times the UNet steps run (from the
    conv_out launches); the kernel forms launch their per-step counts and
    the decoder's GroupNorms once per image; each image's decode as in
    phase 5; every loop span says "v_prediction". Returns the
    replayed group's launches by key."""
    from stabletriton_tpu_torch.compile import CompileConfig
    from stabletriton_tpu_torch.models.unet import sd21_unet_config
    from stabletriton_tpu_torch.runtime import profiling
    from stabletriton_tpu_torch.runtime.scheduler import SchedulerConfig

    ucfg = sd21_unet_config()
    sd21 = {"unet": make_unet_params(dev, ucfg), "other": make_sd21_other_params(dev)}
    counters = kernel_counters()
    profiling.reset()
    done, counts, by_key = serve(
        dev, ucfg, sd21["unet"], sd21["other"], CompileConfig(), counters=counters,
        prompts=[(p, 51 + i) for i, p in enumerate(SD21_PROMPTS)], size=SD21_SIZE,
        guidance=7.5, scheduler_config=SchedulerConfig(prediction_type="v_prediction"))
    predictions = [s.attrs.get("prediction") for s in profiling.spans()
                   if s.name == "pipeline.loop"]
    norms = decoder_norms(sd21["other"])
    free(sd21)
    steps = unet_steps(by_key["K6"], ucfg, "wgmma_bf16")
    images = len(done)
    batches = sorted({int(f.split("=")[1]) for key in by_key["attention"]
                      for f in key.split() if f.startswith("b=")
                      and key.split()[1] in SD21_ATTN_PER_STEP})
    log(f"SD2.1 serving: {steps} UNet steps, {images} images, bf16 attention at batch "
        f"{batches}, loop spans' prediction {predictions}")
    if steps != SERVE_STEPS or images != len(SD21_PROMPTS) or batches != [16]:
        raise AssertionError(f"SD2.1 serving: {steps} UNet steps, {images} images, attention "
                             f"batches {batches}; expected {SERVE_STEPS}, "
                             f"{len(SD21_PROMPTS)}, [16]")
    if not predictions or set(predictions) != {"v_prediction"}:
        raise AssertionError(f"SD2.1 serving: loop spans' prediction {predictions}")
    log(f"SD2.1 serving: K8-K11 launches (the encoder's and the decoder's included) "
        f"{ {k: counts[k] for k in FUSED_PER_STEP} }")
    check_bf16_attention(by_key["attention"], SD21_ATTN_PER_STEP, steps, "SD2.1 serving")
    check_decode_convs(by_key["K6"], images, "SD2.1 serving")
    check_decode_attention(by_key["attention"], images, "SD2.1 serving")
    check_default_forms(by_key, SD15_ALL_PER_STEP, steps, images, norms, "SD2.1 serving")
    return by_key


# phase 6: the image-conditioned paths at 1024^2 (the VAE encoder, img2img
# from pixels, inpainting on the 9-channel SDXL UNet, base + refiner, the
# warm-up), IMAGE_STEPS Euler steps, batch 1 (CFG batch 2), random weights.
# Launches of each piece of a request by kernel: the SDXL refiner's step
# from its config (44 transformer blocks: 2 x 4 down at each of the 768 and
# 1536 levels, 3 x 4 up at each, 4 in the mid block; 22 resnets: 8 down, 2
# mid, 12 up; 11 Transformer2D): self-attention at 64^2 (h=12) 20 x K2 and
# at 32^2 and the mid block's 16^2 (h=24) 24 x K1 on attn_wgmma_bf16, 44
# cross (77 keys) x K1 on the tiny-KV kernel; 49 bf16 3x3 convs (conv_in,
# 44 resnet convs, 3 upsamplers, conv_out); all-kernel K8 45 (resnets x 2 +
# conv_out), K9 11, K10 132, K11 44, K12 2, K13 312 (blocks x 6 + 22
# Transformer2D projections + 22 time projections + the time MLP's 2 + the
# add embedding's 2) + 44 in the precompute. The 9-channel UNet launches
# SDXL-base's. One image's f32 encode: conv_in (Cin 3) on the direct
# kernel, 21 convs (20 resnet convs, conv_out 512 -> 8) on the 3xTF32 wgmma
# kernel (the 3 stride-2 downsamplers and the 1x1 shortcuts on the plain
# conv, as in the JAX package), its mid attention once on the 3xTF32 GEMM;
# all-kernel K9 22 (f32: 10 resnets x 2, the mid attention's, conv_norm_out)
# and K13 4 (f32: q, k, v, out).
IMAGE_STEPS = 4
REFINER_ATTN_PER_STEP = {"wgmma_bf16": {"K1": 24, "K2": 20}, "tinykv_wgmma_bf16": {"K1": 44}}
REFINER_ALL_PER_STEP = {"K8": 45, "K9": 11, "K10": 132, "K11": 44, "K12": 2, "K13": 312}
REFINER_PRECOMPUTE_LINEARS = 44
ENCODE_CONVS = {"wgmma_tf32x3": 21, "direct_f32": 1}
OPT_KERNELS = ("K8", "K9", "K10", "K11", "K12", "K13")


def path_parts(decode_norms: int, encode_norms: int) -> dict:
    """Launches of each piece of an image-path request: attention (bf16
    by kernel and class, f32 in all), 3x3 convs by kernel (K6 and K8
    together) and, under the all-kernel binding, K8-K13."""
    return {
        "sdxl_step": {"attention": ATTN_PER_STEP, "conv": CONV_SPLIT, "all": ALL_PER_STEP},
        "refiner_step": {"attention": REFINER_ATTN_PER_STEP, "conv": {"wgmma_bf16": 49},
                         "all": REFINER_ALL_PER_STEP},
        "sdxl_generation": {"all": {"K13": PRECOMPUTE_LINEARS}},
        "refiner_generation": {"all": {"K13": REFINER_PRECOMPUTE_LINEARS}},
        "encode": {"conv": ENCODE_CONVS, "f32_attention": 1,
                   "all": {"K9": encode_norms, "K13": VAE_LINEARS}},
        "decode": {"conv": DECODE_CONVS, "f32_attention": 1,
                   "all": {"K9": decode_norms, "K13": VAE_LINEARS}},
    }


def launch_summary_of(delta: dict) -> dict:
    """A request's launches (a launches_by_key delta of kernel_counters())
    as path_parts counts them."""
    attn, f32 = {}, 0
    for key, n in delta["attention"].items():
        cls, kernel = key.split()[:2]
        if kernel == DECODE_ATTENTION:
            f32 += n
        else:
            attn[f"{cls} {kernel}"] = attn.get(f"{cls} {kernel}", 0) + n
    conv = {}
    for name in ("K6", "K8"):
        for key, n in delta[name].items():
            conv[key.split()[0]] = conv.get(key.split()[0], 0) + n
    return {"attention": attn, "f32_attention": f32, "conv": conv,
            "opt": {k: sum(delta[k].values()) for k in OPT_KERNELS}}


def expected_summary(parts: dict, pieces, all_kernels: bool) -> dict:
    """launch_summary_of's form of ``pieces`` ((piece, times), ...)."""
    attn, f32, conv = {}, 0, {}
    opt = dict.fromkeys(OPT_KERNELS, 0)
    for piece, times in pieces:
        p = parts[piece]
        for kernel, by_class in p.get("attention", {}).items():
            for cls, n in by_class.items():
                attn[f"{cls} {kernel}"] = attn.get(f"{cls} {kernel}", 0) + n * times
        f32 += p.get("f32_attention", 0) * times
        for kernel, n in p.get("conv", {}).items():
            conv[kernel] = conv.get(kernel, 0) + n * times
        if all_kernels:
            for k, n in p.get("all", {}).items():
                opt[k] += n * times
            conv = gn_conv_split(conv, p.get("all", {}).get("K8", 0) * times, times)
    return {"attention": attn, "f32_attention": f32, "conv": conv, "opt": opt}


def gn_conv_split(conv: dict, k8: int, steps: int) -> dict:
    """The convs by kernel when ``k8`` of them (over ``steps`` steps) are
    K8's: all but conv_out's (one a step, on the 8-column form) move from
    wgmma_bf16 to K8's warp-specialised kernel, wgmma_gn_bf16."""
    if not k8:
        return conv
    moved = k8 - steps
    return {**conv, "wgmma_bf16": conv["wgmma_bf16"] - moved,
            "wgmma_gn_bf16": conv.get("wgmma_gn_bf16", 0) + moved}


def delta_since(counters, before: dict) -> dict:
    now = launches_by_key(counters)
    return {name: {k: n - before[name].get(k, 0) for k, n in by.items()
                   if n != before[name].get(k, 0)} for name, by in now.items()}


class DecodeTap:
    """While entered, records the latents every VAE decode of the pipeline
    module receives: the denoise loop's output of a request that decodes."""

    def __enter__(self):
        from stabletriton_tpu_torch.runtime import pipeline as tp

        self.module, self.real, self.latents = tp, tp._decode_images, []

        def tap(cfg, params, latents):
            self.latents.append(latents.clone())
            return self.real(cfg, params, latents)

        tp._decode_images = tap
        return self

    def __exit__(self, *exc):
        self.module._decode_images = self.real


def eager_graphs():
    """A pipeline's Graphs that graph nothing: every call of its loops runs
    eagerly (the reference binding's requests, which are held against and
    never replayed)."""
    from stabletriton_tpu_torch.runtime.graphs import Graphs

    class Eager(Graphs):
        def wrap(self, fn):
            return fn

    return Eager()


REFINER_ATTENTION_CASES = [
    ("refiner self S=4096 h=12 bf16", "K2", "qkv", (2, 4096, 768, 12), torch.bfloat16, 10),
    ("refiner self S=1024 h=24 bf16", "K1", "qkv", (2, 1024, 1536, 24), torch.bfloat16, 20),
    ("refiner mid self S=256 h=24 bf16", "K1", "qkv", (2, 256, 1536, 24), torch.bfloat16, 20),
    ("refiner cross Sq=4096 Sk=77 h=12 bf16", "K1", "kv", (2, 4096, 77, 768, 12),
     torch.bfloat16, 20),
    ("refiner cross Sq=1024 Sk=77 h=24 bf16", "K1", "kv", (2, 1024, 77, 1536, 24),
     torch.bfloat16, 20),
]


def phase_image_kernels(dev):
    """Phase 6k: the twins at the shapes the image-conditioned paths give
    them and no earlier path did, each against its plain version, beside its
    bound and one PyTorch call where one computes the same function, in
    phase 3's manner: the f32 encoder's convs (conv_in Cin 3 on the direct
    kernel, whose block spans 512 output channels, 384 of them idle at Cout
    128; conv_out's Cout 8), the 9-channel conv_in (Cin padded to 16), the
    refiner's GroupNorm-fused convs at Cin 384 and its skip concats (1152,
    2304), its Transformer2D GroupNorm, LayerNorm, GEGLU, projections,
    5-slot time ids and attention at h=12 / 24. Each row carries its
    counter and the launch-key fields its launches on phase 6's path are
    counted by (``match``: each a substring of the key with a space
    appended)."""
    import torch.nn.functional as F

    from stabletriton_tpu_torch.kernels import conv_direct as cd
    from stabletriton_tpu_torch.kernels import geglu as gg
    from stabletriton_tpu_torch.kernels import group_norm as gn
    from stabletriton_tpu_torch.kernels import layer_norm as ln
    from stabletriton_tpu_torch.kernels import linear as lin
    from stabletriton_tpu_torch.kernels import time_embed as te
    from stabletriton_tpu_torch.ops import reference

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(6006)
    bf16, f32 = torch.bfloat16, torch.float32

    def randn(*shape, dtype=bf16, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale + shift).to(dtype)

    results = []

    def record(tpu, name, source, r, counter, match, kernel=None):
        r.update(name=name, source=f"stabletriton_tpu_torch/csrc/{source}", tpu=tpu,
                 kernel=kernel, counter=counter, match=match)
        results.append(r)

    # K6: the encoder's new f32 shapes and the 9-channel conv_in (bf16)
    for label, (b, hh, ww, cin, cout), dtype in [
            ("vae encoder conv_in 1024x1024 3->128 f32", (1, 1024, 1024, 3, 128), f32),
            ("vae encoder 512x512 128->256 f32", (1, 512, 512, 128, 256), f32),
            ("vae encoder 256x256 256->512 f32", (1, 256, 256, 256, 512), f32),
            ("vae encoder conv_out 128x128 512->8 f32", (1, 128, 128, 512, 8), f32),
            ("inpaint unet conv_in 128x128 9->320", (2, 128, 128, 9, 320), bf16)]:
        x = randn(b, hh, ww, cin, dtype=dtype)
        w = randn(3, 3, cin, cout, dtype=dtype, scale=1.0 / math.sqrt(9 * cin))
        bias = randn(cout, dtype=dtype)
        kernel = cd.conv_variant(tuple(x.shape), cout, dtype)
        if dtype == bf16:
            lfn = lambda x=x, w=w, bias=bias: reference.conv2d(x, w, bias)
            label_l = "cuDNN (reference op)"
        else:
            xc = x.permute(0, 3, 1, 2)
            wc = w.permute(3, 0, 1, 2).contiguous().permute(0, 3, 1, 2)
            lfn = lambda xc=xc, wc=wc, bias=bias: F.conv2d(xc, wc, bias, padding=1)
            label_l = "F.conv2d f32"
        flops = 2 * b * hh * ww * cout * 9 * cin
        moved = nbytes(x, w, bias) + b * hh * ww * cout * x.element_size()
        tf32 = kernel == "wgmma_tf32x3"
        name = f"conv3x3 {label}"
        r = compare(name, lambda x=x, w=w, bias=bias: cd.conv3x3(x, w, bias),
                    lambda x=x, w=w, bias=bias: cd.conv3x3_plain(x, w, bias),
                    BF16_REL_TOL if dtype == bf16 else F32_REL_TOL, 3 if dtype == f32 else 10,
                    bound_ms=bound(flops, moved, dtype, TF32X3_FLOPS if tf32 else None),
                    library_fn=lfn, library_label=label_l)
        if tf32:
            r["bound_f32_fma_ms"] = bound(flops, moved, dtype)[0]
        log(f"  {kernel}")
        record("K6", name, "conv3x3.cu", r, "K6", [f"{kernel} b={b} {hh}x{ww} {cin}->{cout} "],
               kernel)
        del x, w, bias

    # K8: the refiner's GroupNorm-fused convs, Cin 384 (12 channels a group)
    # and the up path's skip concats
    for label, (b, hh, ww, cin, cout) in [
            ("refiner resnet conv1 128x128 384->384 batch-bias", (2, 128, 128, 384, 384)),
            ("refiner up resnet conv1 128x128 1152->384 batch-bias", (2, 128, 128, 1152, 384)),
            ("refiner up resnet conv1 64x64 2304->768 batch-bias", (2, 64, 64, 2304, 768))]:
        x = randn(b, hh, ww, cin, scale=2.0, shift=0.5)
        scale, shift = gn.scale_shift(x, randn(cin, dtype=f32, scale=0.2, shift=1.0),
                                      randn(cin, dtype=f32, scale=0.2), num_groups=32, eps=1e-5)
        w = randn(3, 3, cin, cout, scale=1.0 / math.sqrt(9 * cin))
        bias = randn(b, cout, dtype=f32)
        args = (x, scale, shift, w, bias)
        kernel = cd.conv_variant(tuple(x.shape), cout, bf16, gn=True)
        name = f"gn_conv3x3 {label}"
        flops = 2 * b * hh * ww * cout * 9 * cin
        moved = nbytes(x, w, bias, scale, shift) + b * hh * ww * cout * 2
        r = compare(name, lambda a=args: cd.gn_conv3x3(*a, gn_act="silu"),
                    lambda a=args: cd.gn_conv3x3_plain(*a, gn_act="silu"), BF16_REL_TOL, 10,
                    bound_ms=bound(flops, moved, bf16))
        log(f"  {kernel}")
        record("K8", name, "conv3x3.cu", r, "K8", [f"{kernel} b={b} {hh}x{ww} {cin}->{cout} "],
               kernel)
        del x, w, args

    # K9: the refiner's Transformer2D GroupNorm at 768 channels
    shape = (2, 64, 64, 768)
    x = randn(*shape, scale=2.0, shift=0.5)
    g, bb = randn(768, shift=1.0), randn(768)
    nchw = x.permute(0, 3, 1, 2).contiguous()
    name = "group_norm (2, 64, 64, 768) bf16 act=None (refiner)"
    record("K9", name, "group_norm.cu", compare(
        name, lambda: gn.group_norm(x, g, bb, num_groups=32, eps=1e-6),
        lambda: gn.group_norm_plain(x, g, bb, num_groups=32, eps=1e-6), BF16_REL_TOL, 20,
        bound_ms=bound(0, 2 * nbytes(x) + nbytes(g, bb), bf16),
        library_fn=lambda: F.group_norm(nchw, 32, g, bb, 1e-6), library_label="F.group_norm"),
        "K9", ["bf16 b=2 64x64 c=768 "])
    del x, nchw

    # K10 and K11 at the refiner's widths
    for rows, c in [(8192, 768), (2048, 1536)]:
        x = randn(rows, c, scale=2.0, shift=0.3)
        g, bb = randn(c, shift=1.0), randn(c)
        name = f"layer_norm ({rows}, {c}) bf16 (refiner)"
        record("K10", name, "layer_norm.cu", compare(
            name, lambda x=x, g=g, bb=bb: ln.layer_norm(x, g, bb, eps=1e-6),
            lambda x=x, g=g, bb=bb: ln.layer_norm_plain(x, g, bb, eps=1e-6), BF16_REL_TOL, 50,
            bound_ms=bound(0, 2 * nbytes(x) + nbytes(g, bb), bf16),
            library_fn=lambda x=x, g=g, bb=bb, c=c: F.layer_norm(x, (c,), g, bb, 1e-6),
            library_label="F.layer_norm"), "K10", [f"ln bf16 rows={rows} c={c} "])
    for b_, s_, n in [(2, 4096, 3072), (2, 1024, 6144)]:
        proj = randn(b_, s_, 2 * n, scale=2.0)
        state, gate = proj.chunk(2, dim=-1)
        name = f"geglu halves of ({b_}, {s_}, {2 * n}) bf16 (refiner)"
        record("K11", name, "geglu.cu", compare(
            name, lambda st=state, ga=gate: gg.geglu(st, ga),
            lambda st=state, ga=gate: gg.geglu_plain(st, ga), BF16_REL_TOL, 20,
            bound_ms=bound(0, nbytes(proj) + nbytes(proj) // 2, bf16)),
            "K11", [f"bf16 rows={b_ * s_} n={n} "])
        del proj, state, gate

    # K13: the refiner's projections, beside cuBLAS's addmm
    for label, m, k, n, has_bias in [("refiner to_qkv (8192,768)@(768,2304)", 8192, 768, 2304,
                                      False),
                                     ("refiner ff proj (2048,1536)@(1536,12288)+b", 2048, 1536,
                                      12288, True),
                                     ("refiner add embedding (2,2560)@(2560,1536)+b", 2, 2560,
                                      1536, True)]:
        x = torch.randn((m, k), generator=gen, device=dev).to(bf16)
        w = (torch.randn((k, n), generator=gen, device=dev) / math.sqrt(k)).to(bf16)
        b = torch.randn(n, generator=gen, device=dev).to(bf16) if has_bias else None
        kernel = lin.variant(m, k, n, bf16)
        name = f"linear {label}"
        r = compare(name, lambda x=x, w=w, b=b: lin.linear(x, w, b),
                    lambda x=x, w=w, b=b: lin.linear_plain(x, w, b), BF16_REL_TOL, 20,
                    bound_ms=bound(2 * m * n * k, nbytes(x, w, b) + m * n * 2, bf16),
                    library_fn=(lambda x=x, w=w, b=b: torch.addmm(b, x, w)) if b is not None
                    else (lambda x=x, w=w: x @ w), library_label="cuBLAS addmm")
        record("K13", name, "linear.cu", r, "K13", [f"{kernel} m={m} k={k} n={n} "], kernel)
        del x, w, b

    # K12: the refiner's 5-slot time ids, CFG-doubled
    t = torch.tensor([1024.0, 1024, 0, 0, 2.5] + [1024.0, 1024, 0, 0, 6.0], device=dev)
    name = "time_embed (10,)->(10,256) f32 (refiner time ids)"
    r = compare(name, lambda: te.time_embed(t, dim=256), lambda: te.time_embed_plain(t, dim=256),
                F32_REL_TOL, 50, bound_ms=bound(0, nbytes(t) * (1 + 256), f32))
    if r["max_abs_err"] != 0:
        raise AssertionError(f"{name}: not the plain version's bits")
    record("K12", name, "time_embed.cu", r, "K12", ["b=10 dim=256 "])

    # K1 / K2: the refiner's attention at h=12 and 24
    for r, (_, tpu, kind, shape, _, _) in zip(attention_cases(randn, REFINER_ATTENTION_CASES),
                                             REFINER_ATTENTION_CASES):
        if kind == "qkv":
            b, s, c, h = shape
            sq = sk = s
        else:
            b, sq, sk, c, h = shape
        r.update(counter="attention",
                 match=[f"{r['kernel']} b={b} h={h} d={c // h} sq={sq} sk={sk} "])
        results.append(r)
    torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = True
    return results


def phase_images(dev, ucfg, unet_params, other, size=1024):
    """Phase 6: the image-conditioned paths through SDXLPipeline's and
    TwoStageSDXL's entry points at 1024^2, with the launch counters set to
    0 just before and read just after. (a) vae_encode of one image under the
    default and all-kernel bindings against the reference binding's (TF32
    off): max abs, MSE, CUDA-event ms, peak memory, launches by route; an
    encode -> decode round trip timed. Then, under the default and
    all-kernel bindings, requests of IMAGE_STEPS Euler steps, each kind
    twice (the first call runs the loop eagerly and captures it, the second
    replays with another prompt, image and seed; its wall taken over
    REPLAY_ITERS replays): (e) warmup, after which the same signature's
    first txt2img request captures nothing (plain Euler: each binding's MSE
    yardstick); (b) img2img_image on SDXL-base, strength 0.5; (c) inpaint on
    the 9-channel UNet (SDXL-base's tensors with a new conv_in) with a
    centred square mask, Euler, then Heun with a guidance interval and
    deep_cache=2; (d) TwoStageSDXL with the SDXL refiner, refiner_strength
    0.25. Each: the replayed loop bit for bit its eager loop on the call's
    inputs, the replay counting the first call's launches key by key, the
    plain kinds' launches as path_parts counts them, graph kernel nodes, the
    first call's pieces, and the MSE of the latents against the reference
    binding's same request (run eagerly) at most MODE_MSE_RATIO x the
    binding's plain Euler txt2img MSE; each replayed loop alone (the
    refiner's for (d)) timed by CUDA events. Returns the phase's launches by
    key and its records."""
    import dataclasses

    from stabletriton_tpu_torch import ops
    from stabletriton_tpu_torch.compile import resolve_binding
    from stabletriton_tpu_torch.models import vae as vae_mod
    from stabletriton_tpu_torch.models.unet import init_unet_params, sdxl_refiner_unet_config
    from stabletriton_tpu_torch.runtime import pipeline as tp
    from stabletriton_tpu_torch.runtime import scheduler as sched

    (c1, c2, vcfg), params = other
    lat = size // vcfg.spatial_scale_factor
    gen = torch.Generator(device=dev).manual_seed(66)
    vae_full = {**params["vae"], **vae_mod.init_vae_encoder_params(vcfg, 4, device=dev)}
    norms = ("norm1.weight", "norm2.weight", "group_norm.weight", "conv_norm_out.weight")
    parts = path_parts(
        sum(1 for k in vae_full if k.startswith("decoder.") and k.endswith(norms)),
        sum(1 for k in vae_full if k.startswith("encoder.") and k.endswith(norms)))
    cfg9 = dataclasses.replace(ucfg, in_channels=9)
    unet9 = {**unet_params, "conv_in.weight": (torch.randn(
        (3, 3, 9, ucfg.block_out_channels[0]), generator=gen, device=dev) / 9.0).to(
            torch.bfloat16)}
    rcfg = sdxl_refiner_unet_config()
    refiner_unet = init_unet_params(rcfg, 5, device=dev, dtype=torch.bfloat16)
    tok = StubTokenizer(c1.bos_token_id, c1.eos_token_id)
    s = [float(v) for v in sched.make_schedule(sched.SchedulerConfig(), IMAGE_STEPS).sigmas]
    window = ((s[2] + s[3]) / 2, (s[0] + s[1]) / 2)

    def image(seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        return torch.rand((1, size, size, 3), generator=g, device=dev) * 2 - 1

    mask = torch.zeros((1, size, size, 1), device=dev)
    mask[:, size // 4:3 * size // 4, size // 4:3 * size // 4] = 1.0
    calls = [("a lighthouse at dusk", 11, image(101)), ("a bowl of ramen", 12, image(102))]

    def tokens(prompt):
        ids1 = tok.encode_batch([prompt], max_len=c1.max_position_embeddings)
        ids2 = tok.encode_batch([prompt], max_len=c2.max_position_embeddings, pad=0)
        return ids1, ids2

    def pipeline(kind, config, **kw):
        if kind == "refiner":
            return tp.SDXLPipeline(unet_config=rcfg, clip_config=c2, clip2_config=c2,
                                   vae_config=vcfg,
                                   params={"unet": refiner_unet,
                                           "text_encoder_2": params["text_encoder_2"],
                                           "vae": params["vae"]},
                                   compile_config=config, device=dev, **kw)
        return tp.SDXLPipeline(unet_config=cfg9 if kind == "inpaint" else ucfg, clip_config=c1,
                               clip2_config=c2, vae_config=vcfg,
                               params={"unet": unet9 if kind == "inpaint" else unet_params,
                                       "text_encoder": params["text_encoder"],
                                       "text_encoder_2": params["text_encoder_2"],
                                       "vae": vae_full},
                               compile_config=config, device=dev, **kw)

    inpaint_modes = {"inpaint": {}, "inpaint heun, interval, deep_cache=2": {
        "solver": "heun", "guidance_interval": window, "deep_cache": 2}}

    def request(kind, pipes, call):
        """The latents of a request through its entry point (the loop's
        output, tapped before the decode where it decodes)."""
        prompt, seed, img = call
        ids1, ids2 = tokens(prompt)
        with DecodeTap() as tap:
            if kind == "txt2img":
                pipes[0].txt2img(ids1, ids2, height=size, width=size, steps=IMAGE_STEPS,
                                 seed=seed)
            elif kind == "img2img_image":
                return pipes[0].img2img_image(img, ids1, ids2, steps=IMAGE_STEPS, strength=0.5,
                                              seed=seed, decode=False)
            elif kind.startswith("inpaint"):
                pipes[0].inpaint(img, mask, ids1, ids2, steps=IMAGE_STEPS, seed=seed,
                                 **inpaint_modes[kind])
            else:
                tp.TwoStageSDXL(base=pipes[0], refiner=pipes[1]).txt2img(
                    ids1, ids2, height=size, width=size, steps=IMAGE_STEPS,
                    refiner_strength=0.25, seed=seed)
        (latents,) = tap.latents
        return latents

    def program(pipe):
        """A pipeline's one program (each kind runs its own pipelines)."""
        (prog,) = pipe._cache.values()
        return prog

    def eager(kind, pipes, call):
        """The eager loop of the request's program (``loop.__wrapped__``)
        on the inputs its entry point makes for ``call``."""
        prompt, seed, img = call
        ids1, ids2 = tokens(prompt)
        pipe = pipes[0]
        dev_ids = [torch.as_tensor(np.asarray(a), dtype=torch.long).to(dev) for a in (
            ids1, ids2, c1.empty_prompt_ids(1, ids1.shape[1]),
            c2.empty_prompt_ids(1, ids2.shape[1]))]
        with torch.inference_mode(), ops.use_backends(resolve_binding(pipe.compile_config)):
            prog = program(pipe)
            if kind == "txt2img":
                args = (*dev_ids, [seed])
            elif kind == "img2img_image":
                args = (tp._encode_images(vcfg, pipe.params["vae"], img), *dev_ids, [seed])
            elif kind.startswith("inpaint"):
                args = (img, mask, *dev_ids, [seed])
            else:
                base_lat = prog.loop.__wrapped__(pipe.params["unet"], *prog.loop_inputs(
                    pipe.params, *dev_ids, [seed]))
                pipe = pipes[1]
                prog = program(pipe)
                args = (base_lat, None, dev_ids[1], None, dev_ids[3], [seed + 1])
            inputs = prog.loop_inputs(pipe.params, *args)
            return prog.loop.__wrapped__(pipe.params["unet"], *inputs), prog, (
                pipe.params["unet"], inputs)

    pieces = {
        "txt2img": [("sdxl_step", IMAGE_STEPS), ("sdxl_generation", 1), ("decode", 1)],
        "img2img_image": [("encode", 1), ("sdxl_step", IMAGE_STEPS // 2),
                          ("sdxl_generation", 1)],
        "inpaint": [("encode", 1), ("sdxl_step", IMAGE_STEPS), ("sdxl_generation", 1),
                    ("decode", 1)],
        "two_stage": [("sdxl_step", IMAGE_STEPS), ("sdxl_generation", 1), ("refiner_step", 1),
                      ("refiner_generation", 1), ("decode", 1)],
    }
    pipe_kinds = {"txt2img": ("base",), "img2img_image": ("base",),
                  "inpaint": ("inpaint",), "inpaint heun, interval, deep_cache=2": ("inpaint",),
                  "two_stage": ("base", "refiner")}
    kinds = list(pipe_kinds)

    counters = kernel_counters()
    reset(counters)
    results = {}
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        # (a) the encoder
        enc = {}
        x = calls[0][2]
        for name, config in replay_configs().items():
            if name == "fused_ops":
                continue
            with torch.inference_mode(), ops.use_backends(resolve_binding(config)):
                before = launches_by_key(counters)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats(dev)
                base_mem = torch.cuda.memory_allocated(dev)
                out = tp._encode_images(vcfg, vae_full, x)
                torch.cuda.synchronize()
                rec = {"peak_gib": (torch.cuda.max_memory_allocated(dev) - base_mem) / 2**30}
                rec["launches"] = launch_summary_of(delta_since(counters, before))
                want = expected_summary(parts, [("encode", 1)], name == "all_kernels")
                if name != "reference" and rec["launches"] != want:
                    raise AssertionError(f"encode, {name}: launches {rec['launches']}, "
                                         f"expected {want}")
                rec["ms"] = timed_ms(lambda: tp._encode_images(vcfg, vae_full, x), 2)
                rec["round_trip_ms"] = timed_ms(lambda: tp._decode_images(
                    vcfg, vae_full, tp._encode_images(vcfg, vae_full, x)), 2)
            if out.shape != (1, lat, lat, 4) or not torch.isfinite(out).all():
                raise AssertionError(f"encode, {name}: {tuple(out.shape)}, finite "
                                     f"{bool(torch.isfinite(out).all())}")
            enc[name] = (out, rec)
        ref = enc["reference"][0]
        for name, (out, rec) in enc.items():
            d = (out - ref).float()
            rec.update(max_abs=d.abs().max().item(), mse=d.square().mean().item(),
                       rel=d.abs().max().item() / ref.abs().max().item())
            log(f"encode {size}^2 f32, {name} binding: " + json.dumps(rec))
            if not rec["rel"] <= F32_REL_TOL:
                raise AssertionError(f"encode, {name}: max abs {rec['max_abs']:.3e} is "
                                     f"{rec['rel']:.3e} of the largest latent (limit "
                                     f"{F32_REL_TOL:g})")
        results["encode"] = {k: v[1] for k, v in enc.items()}
        del enc, ref, out

        # the reference binding's requests, eager: each kind's yardstick
        reference = {}
        config = replay_configs()["reference"]
        for kind in kinds:
            pipes = [pipeline(k, config, _graphs=eager_graphs()) for k in pipe_kinds[kind]]
            before = launches_by_key(counters)
            reference[kind] = request(kind, pipes, calls[1])
            if any(delta_since(counters, before)[k] for k in counters):
                raise AssertionError(f"{kind}: the reference binding launched a kernel")
            del pipes
            gc.collect()
            torch.cuda.empty_cache()

        for name in MODE_BINDINGS:
            config = replay_configs()[name]
            rows = {}
            for kind in kinds:
                pipes = [pipeline(k, config) for k in pipe_kinds[kind]]
                rec, outs, counts = {"replay_s": []}, [], []
                if kind == "txt2img":
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    pipes[0].warmup(height=size, width=size, steps=IMAGE_STEPS)
                    torch.cuda.synchronize()
                    rec["warmup_s"] = time.perf_counter() - t0
                    (prog,) = pipes[0]._cache.values()
                    (warm,) = prog.loop.captured.values()
                for i, call in enumerate(calls):
                    for n in range(1 if i == 0 else REPLAY_ITERS):
                        before = launches_by_key(counters)
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        out = request(kind, pipes, call)
                        torch.cuda.synchronize()
                        wall = time.perf_counter() - t0
                        delta = delta_since(counters, before)
                        if i == 0:
                            rec["first_s"] = wall
                        else:
                            rec["replay_s"].append(wall)
                        if n == 0:
                            counts.append(delta)
                            outs.append(out)
                        elif not torch.equal(out, outs[-1]):
                            raise AssertionError(f"{kind}, {name}: a replay of the same "
                                                 f"request gave other latents")
                label = f"{kind}, {name}"
                if counts[1] != counts[0]:
                    raise AssertionError(f"{label}: the replay counted {counts[1]}, the first "
                                         f"call {counts[0]}")
                rec["launches"] = launch_summary_of(counts[1])
                if kind in pieces:
                    want = expected_summary(parts, pieces[kind], name == "all_kernels")
                    if rec["launches"] != want:
                        raise AssertionError(f"{label}: launches {rec['launches']}, expected "
                                             f"{want}")
                for i, call in enumerate(calls):
                    want, prog, (unet, inputs) = eager(kind, pipes, call)
                    if not torch.equal(outs[i], want):
                        raise AssertionError(f"{label}: call {i} differs from the eager loop "
                                             f"on its inputs")
                    if len(prog.loop.captured) != 1:
                        raise AssertionError(f"{label}: {len(prog.loop.captured)} graphs for "
                                             f"one signature")
                if kind == "txt2img":
                    (entry,) = prog.loop.captured.values()
                    if entry is not warm or len(pipes[0]._cache) != 1:
                        raise AssertionError(f"{label}: the request after warmup captured "
                                             f"again")
                if not all(torch.isfinite(o.float()).all() for o in outs):
                    raise AssertionError(f"{label}: latents not finite")
                d = outs[1].float() - reference[kind].float()
                rec["vs_reference"] = {"max_abs": d.abs().max().item(),
                                       "mse": d.square().mean().item()}
                # the replayed loop alone (the refiner's for two_stage), CUDA
                # events: its cross K/V precompute and its steps
                with torch.inference_mode():
                    rec["loop_event_ms"] = timed_ms(lambda: prog.loop(unet, *inputs),
                                                    REPLAY_ITERS)
                rec["graph"] = capture_record(next(iter(prog.loop.captured.values())))
                if kind == "two_stage":
                    rec["base_graph"] = capture_record(next(iter(
                        program(pipes[0]).loop.captured.values())))
                rows[kind] = rec
                log(f"image path {kind}, {size}^2 {IMAGE_STEPS}-step request, {name} binding: "
                    f"bit equal to the eager loop (capture and replay); " + json.dumps(rec))
                del pipes, prog, outs, unet, inputs
                gc.collect()
                torch.cuda.empty_cache()
            euler = rows["txt2img"]["vs_reference"]["mse"]
            for kind, rec in rows.items():
                rec["mse_vs_euler"] = rec["vs_reference"]["mse"] / euler
                if rec["vs_reference"]["mse"] > MODE_MSE_RATIO * euler:
                    raise AssertionError(f"{kind}, {name}: MSE against the reference binding "
                                         f"{rec['vs_reference']['mse']:.3e}, over "
                                         f"{MODE_MSE_RATIO:g} x plain Euler's {euler:.3e}")
            log(f"image paths, {name} binding (first call s, replayed walls s, the replayed "
                f"loop's event ms; MSE against the reference binding, x plain Euler "
                f"txt2img's): " + ", ".join(
                    f"{k} {r['first_s']:.3f}, " + "/".join(f"{v:.3f}" for v in r["replay_s"])
                    + f", loop {r['loop_event_ms']:.2f} ms ({r['vs_reference']['mse']:.3e}, "
                    f"{r['mse_vs_euler']:.2f}x)" for k, r in rows.items()))
            results[name] = rows
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    total = launches_by_key(counters)
    del refiner_unet, unet9, vae_full
    gc.collect()
    torch.cuda.empty_cache()
    return total, results


# phase 7: the front door. SD2.x at 768^2 (96^2 latent, CFG batch 2, bf16
# UNet, f32 decode) from an SGM single file, SDXL-base from a diffusers
# directory, the native library and the frontends. Every checkpoint is
# written here from seeded random weights (nothing is downloaded); each is
# deleted when its phase ends.
SD2_SIZE = 768
FRONT_STEPS = 4
SD2_ATTENTION_CASES = [
    ("SD2 self S=9216 h=5 d=64 bf16", "K3", "qkv", (2, 9216, 320, 5), torch.bfloat16, 5),
    ("SD2 cross Sq=9216 Sk=77 h=5 d=64 bf16", "K5", "kv", (2, 9216, 77, 320, 5),
     torch.bfloat16, 10),
    ("SD2 self S=2304 h=10 bf16", "K2", "qkv", (2, 2304, 640, 10), torch.bfloat16, 10),
    ("SD2 cross Sq=2304 Sk=77 h=10 bf16", "K1", "kv", (2, 2304, 77, 640, 10), torch.bfloat16,
     20),
    ("SD2 self S=576 h=20 bf16", "K1", "qkv", (2, 576, 1280, 20), torch.bfloat16, 20),
    ("SD2 cross Sq=576 Sk=77 h=20 bf16", "K1", "kv", (2, 576, 77, 1280, 20), torch.bfloat16, 20),
    ("SD2 mid self S=144 h=20 bf16", "K1", "qkv", (2, 144, 1280, 20), torch.bfloat16, 20),
    ("SD2 mid cross Sq=144 Sk=77 h=20 bf16", "K1", "kv", (2, 144, 77, 1280, 20),
     torch.bfloat16, 20),
    ("SD2 vae S=9216 h=1 d=512 f32", "K3", "qkv3", (1, 9216, 512, 1), torch.float32, 3),
]


def phase_sd2_kernels(dev):
    """Phase 7k: the twins at the shapes the SD2.x 768^2 path gives them and
    no earlier path did, each against its plain version beside its bound
    and one PyTorch call, in phase 3's manner: attention at h=5 d=64 (self
    S=9216, the first K3-class bf16 launch at d=64; cross against 77 keys,
    K5 on the tiny-KV kernel), h=10 and h=20 at 48^2 / 24^2 / 12^2 and the
    f32 VAE's at S=9216; the UNet's 3x3 convs at 96^2..12^2 (conv_in Cin 4
    padded to 8) and the f32 VAE's at 96^2 and 768^2; the GroupNorm-fused
    conv, GroupNorm, LayerNorm, GEGLU and projections at 320 channels and
    the cross K/V precompute's 1024-wide context. Each row carries the
    launch-key fields its launches on phase 7c's path are counted by."""
    import torch.nn.functional as F

    from stabletriton_tpu_torch.kernels import conv_direct as cd
    from stabletriton_tpu_torch.kernels import geglu as gg
    from stabletriton_tpu_torch.kernels import group_norm as gn
    from stabletriton_tpu_torch.kernels import layer_norm as ln
    from stabletriton_tpu_torch.kernels import linear as lin
    from stabletriton_tpu_torch.ops import reference

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(7007)
    bf16, f32 = torch.bfloat16, torch.float32

    def randn(*shape, dtype=bf16, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale + shift).to(dtype)

    results = []

    def record(tpu, name, source, r, counter, match, kernel=None):
        r.update(name=name, source=f"stabletriton_tpu_torch/csrc/{source}", tpu=tpu,
                 kernel=kernel, counter=counter, match=match, path="sd2")
        results.append(r)

    for r, (_, tpu, kind, shape, _, _) in zip(attention_cases(randn, SD2_ATTENTION_CASES),
                                             SD2_ATTENTION_CASES):
        if kind == "kv":
            b, sq, sk, c, h = shape
        else:
            b, sq, c, h = shape
            sk = sq
        r.update(counter="attention", path="sd2",
                 match=[f"{r['kernel']} b={b} h={h} d={c // h} sq={sq} sk={sk} "])
        results.append(r)

    # K6: the UNet's convs at each level, the f32 VAE's at 96^2 and 768^2
    for label, (b, hh, ww, cin, cout), dtype in [
            ("SD2 unet conv_in 96x96 4->320", (2, 96, 96, 4, 320), bf16),
            ("SD2 unet 96x96 320->320", (2, 96, 96, 320, 320), bf16),
            ("SD2 unet 48x48 640->640", (2, 48, 48, 640, 640), bf16),
            ("SD2 unet 24x24 1280->1280", (2, 24, 24, 1280, 1280), bf16),
            ("SD2 unet 12x12 1280->1280", (2, 12, 12, 1280, 1280), bf16),
            ("SD2 vae conv_in 96x96 4->512 f32", (1, 96, 96, 4, 512), f32),
            ("SD2 vae 96x96 512->512 f32", (1, 96, 96, 512, 512), f32),
            ("SD2 vae 768x768 128->128 f32", (1, 768, 768, 128, 128), f32)]:
        x = randn(b, hh, ww, cin, dtype=dtype)
        w = randn(3, 3, cin, cout, dtype=dtype, scale=1.0 / math.sqrt(9 * cin))
        bias = randn(cout, dtype=dtype)
        kernel = cd.conv_variant(tuple(x.shape), cout, dtype)
        if dtype == bf16:
            lfn = lambda x=x, w=w, bias=bias: reference.conv2d(x, w, bias)
            label_l = "cuDNN (reference op)"
        else:
            xc = x.permute(0, 3, 1, 2)
            wc = w.permute(3, 0, 1, 2).contiguous().permute(0, 3, 1, 2)
            lfn = lambda xc=xc, wc=wc, bias=bias: F.conv2d(xc, wc, bias, padding=1)
            label_l = "F.conv2d f32"
        flops = 2 * b * hh * ww * cout * 9 * cin
        moved = nbytes(x, w, bias) + b * hh * ww * cout * x.element_size()
        tf32 = kernel == "wgmma_tf32x3"
        name = f"conv3x3 {label}"
        r = compare(name, lambda x=x, w=w, bias=bias: cd.conv3x3(x, w, bias),
                    lambda x=x, w=w, bias=bias: cd.conv3x3_plain(x, w, bias),
                    BF16_REL_TOL if dtype == bf16 else F32_REL_TOL, 3 if dtype == f32 else 10,
                    bound_ms=bound(flops, moved, dtype, TF32X3_FLOPS if tf32 else None),
                    library_fn=lfn, library_label=label_l)
        if tf32:
            r["bound_f32_fma_ms"] = bound(flops, moved, dtype)[0]
        log(f"  {kernel}")
        record("K6", name, "conv3x3.cu", r, "K6", [f"{kernel} b={b} {hh}x{ww} {cin}->{cout} "],
               kernel)
        del x, w, bias

    # K8: the resnets' GroupNorm-fused conv at 96^2, 320 channels (10 a group)
    b, hh, ww, cin, cout = 2, 96, 96, 320, 320
    x = randn(b, hh, ww, cin, scale=2.0, shift=0.5)
    scale, shift = gn.scale_shift(x, randn(cin, dtype=f32, scale=0.2, shift=1.0),
                                  randn(cin, dtype=f32, scale=0.2), num_groups=32, eps=1e-5)
    w = randn(3, 3, cin, cout, scale=1.0 / math.sqrt(9 * cin))
    bias = randn(b, cout, dtype=f32)
    args = (x, scale, shift, w, bias)
    kernel = cd.conv_variant(tuple(x.shape), cout, bf16, gn=True)
    name = "gn_conv3x3 SD2 resnet conv1 96x96 320->320 batch-bias"
    r = compare(name, lambda: cd.gn_conv3x3(*args, gn_act="silu"),
                lambda: cd.gn_conv3x3_plain(*args, gn_act="silu"), BF16_REL_TOL, 10,
                bound_ms=bound(2 * b * hh * ww * cout * 9 * cin,
                               nbytes(*args) + b * hh * ww * cout * 2, bf16))
    record("K8", name, "conv3x3.cu", r, "K8", [f"{kernel} b={b} {hh}x{ww} {cin}->{cout} "],
           kernel)
    del x, w, args

    # K9: Transformer2D's GroupNorm at 96^2 x 320, 48^2 x 640 and 24^2 x 1280
    for hh, c in [(96, 320), (48, 640), (24, 1280)]:
        x = randn(2, hh, hh, c, scale=2.0, shift=0.5)
        g, bb = randn(c, shift=1.0), randn(c)
        nchw = x.permute(0, 3, 1, 2).contiguous()
        name = f"group_norm (2, {hh}, {hh}, {c}) bf16 act=None (SD2)"
        record("K9", name, "group_norm.cu", compare(
            name, lambda x=x, g=g, bb=bb: gn.group_norm(x, g, bb, num_groups=32, eps=1e-6),
            lambda x=x, g=g, bb=bb: gn.group_norm_plain(x, g, bb, num_groups=32, eps=1e-6),
            BF16_REL_TOL, 20, bound_ms=bound(0, 2 * nbytes(x) + nbytes(g, bb), bf16),
            library_fn=lambda x=nchw, g=g, bb=bb: F.group_norm(x, 32, g, bb, 1e-6),
            library_label="F.group_norm"), "K9", [f"bf16 b=2 {hh}x{hh} c={c} "])
        del x, nchw

    # K10, K11: LayerNorm and GEGLU over the 18432 rows of level 0
    x = randn(18432, 320, scale=2.0, shift=0.3)
    g, bb = randn(320, shift=1.0), randn(320)
    name = "layer_norm (18432, 320) bf16 (SD2)"
    record("K10", name, "layer_norm.cu", compare(
        name, lambda: ln.layer_norm(x, g, bb, eps=1e-6),
        lambda: ln.layer_norm_plain(x, g, bb, eps=1e-6), BF16_REL_TOL, 50,
        bound_ms=bound(0, 2 * nbytes(x) + nbytes(g, bb), bf16),
        library_fn=lambda: F.layer_norm(x, (320,), g, bb, 1e-6), library_label="F.layer_norm"),
        "K10", ["ln bf16 rows=18432 c=320 "])
    proj = randn(2, 9216, 2560, scale=2.0)
    state, gate = proj.chunk(2, dim=-1)
    name = "geglu halves of (2, 9216, 2560) bf16 (SD2)"
    record("K11", name, "geglu.cu", compare(
        name, lambda: gg.geglu(state, gate), lambda: gg.geglu_plain(state, gate), BF16_REL_TOL,
        20, bound_ms=bound(0, nbytes(proj) + nbytes(proj) // 2, bf16)),
        "K11", ["bf16 rows=18432 n=1280 "])
    del x, proj, state, gate

    # K13: level 0's fused QKV projection, and the cross K/V precompute of
    # OpenCLIP-H's 1024-wide states (CFG batch 2 x 77 rows)
    for label, m, k, n in [("SD2 to_qkv (18432,320)@(320,960)", 18432, 320, 960),
                           ("SD2 cross K/V precompute (154,1024)@(1024,640)", 154, 1024, 640)]:
        x = randn(m, k)
        w = randn(k, n, scale=1.0 / math.sqrt(k))
        kernel = lin.variant(m, k, n, bf16)
        name = f"linear {label}"
        r = compare(name, lambda x=x, w=w: lin.linear(x, w),
                    lambda x=x, w=w: lin.linear_plain(x, w), BF16_REL_TOL, 20,
                    bound_ms=bound(2 * m * n * k, nbytes(x, w) + m * n * 2, bf16),
                    library_fn=lambda x=x, w=w: x @ w, library_label="cuBLAS matmul")
        record("K13", name, "linear.cu", r, "K13", [f"{kernel} m={m} k={k} n={n} "], kernel)
        del x, w
    torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = True
    return results


# phase 7v: the sd-2.1-768.batch8 cell's shapes, a group of 8 at 768^2 (UNet
# batch 16, 96^2 latent): attention at h=5 and 10 ...
SD21_ATTENTION_CASES = [
    ("SD2.1 self S=9216 h=5 d=64 b=16 bf16", "K3", "qkv", (16, 9216, 320, 5), torch.bfloat16,
     3),
    ("SD2.1 cross Sq=9216 Sk=77 h=5 d=64 b=16 bf16", "K5", "kv", (16, 9216, 77, 320, 5),
     torch.bfloat16, 5),
    ("SD2.1 self S=2304 h=10 b=16 bf16", "K2", "qkv", (16, 2304, 640, 10), torch.bfloat16, 5),
]
# ... level 0's 3x3 convs (B, H, W, Cin, Cout): conv_in, the resnets'
# 320->320, the up block's first conv1 on the 640 + 320 skip concat, the
# upsampler from level 1, conv_out ...
SD21_CONVS = [(16, 96, 96, 4, 320), (16, 96, 96, 320, 320), (16, 96, 96, 960, 320),
              (16, 96, 96, 640, 640), (16, 96, 96, 320, 4)]
# ... and the default binding's kernel forms: GroupNorm+SiLU before the
# resnets' convs (320, and the up block's 960 and 640 concats), the
# Transformer2D's GroupNorm, LayerNorm and GEGLU over level 0's 147456 rows,
# and the f32 decoder's GroupNorm+SiLU at 768^2
SD21_BF16APPLY_ROWS = [("group_norm", (16, 96, 96, 320), torch.bfloat16, "silu"),
                       ("group_norm", (16, 96, 96, 640), torch.bfloat16, "silu"),
                       ("group_norm", (16, 96, 96, 960), torch.bfloat16, "silu"),
                       ("group_norm", (16, 96, 96, 320), torch.bfloat16, None),
                       ("layer_norm", (147456, 320), torch.bfloat16, None),
                       ("geglu", (16, 9216, 2560), torch.bfloat16, None),
                       ("group_norm", (1, 768, 768, 128), torch.float32, "silu")]


def phase_sd21_kernels(dev):
    """Phase 7v: the twins at the sd-2.1-768.batch8 cell's shapes, each
    against its plain version beside its bound, in phase 3's manner:
    SD21_ATTENTION_CASES (the plain K3 a batch row at a time), SD21_CONVS on
    the kernel the routing picks beside cuDNN, and SD21_BF16APPLY_ROWS in
    phase 3f's. Each row carries the launch-key fields its launches on
    phase 5v's path are counted by."""
    from stabletriton_tpu_torch.kernels import conv_direct as cd
    from stabletriton_tpu_torch.ops import reference

    gen = torch.Generator(device=dev).manual_seed(2321)
    bf16 = torch.bfloat16

    def randn(*shape, dtype=bf16, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale + shift).to(dtype)

    results = []
    for r, (_, _, kind, shape, _, _) in zip(attention_cases(randn, SD21_ATTENTION_CASES),
                                            SD21_ATTENTION_CASES):
        if kind == "kv":
            b, sq, sk, c, h = shape
        else:
            b, sq, c, h = shape
            sk = sq
        r.update(counter="attention", path="sd21",
                 match=[f"{r['kernel']} b={b} h={h} d={c // h} sq={sq} sk={sk} "])
        results.append(r)

    for b, hh, ww, cin, cout in SD21_CONVS:
        x = randn(b, hh, ww, cin)
        w = randn(3, 3, cin, cout, scale=1.0 / math.sqrt(9 * cin))
        bias = randn(cout)
        kernel = cd.conv_variant(tuple(x.shape), cout, bf16)
        name = f"conv3x3 SD2.1 unet b={b} {hh}x{ww} {cin}->{cout}"
        r = compare(name, lambda x=x, w=w, bias=bias: cd.conv3x3(x, w, bias),
                    lambda x=x, w=w, bias=bias: cd.conv3x3_plain(x, w, bias), BF16_REL_TOL, 10,
                    bound_ms=bound(2 * b * hh * ww * cout * 9 * cin,
                                   nbytes(x, w, bias) + b * hh * ww * cout * 2, bf16),
                    library_fn=lambda x=x, w=w, bias=bias: reference.conv2d(x, w, bias),
                    library_label="cuDNN (reference op)")
        r.update(name=name, source="stabletriton_tpu_torch/csrc/conv3x3.cu", tpu="K6",
                 kernel=kernel, counter="K6", path="sd21",
                 match=[f"{kernel} b={b} {hh}x{ww} {cin}->{cout} "])
        results.append(r)
        del x, w, bias
    torch.cuda.empty_cache()
    return results + phase_bf16apply(dev, SD21_BF16APPLY_ROWS, path="sd21")


def png_pixels(png: bytes) -> np.ndarray:
    """The pixels of an 8-bit RGB PNG whose rows all use filter 0 (as the
    native encoder writes them), decoded with Python's zlib: (H, W, 3)."""
    import struct
    import zlib

    pos, idat, w, h = 8, b"", 0, 0
    while pos < len(png):
        (n,) = struct.unpack(">I", png[pos:pos + 4])
        typ, data = png[pos + 4:pos + 8], png[pos + 8:pos + 8 + n]
        if typ == b"IHDR":
            w, h = struct.unpack(">II", data[:8])
        elif typ == b"IDAT":
            idat += data
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    if png[:8] != b"\x89PNG\r\n\x1a\n" or rows[:, 0].any():
        raise AssertionError("not a filter-0 RGB PNG")
    return rows[:, 1:].reshape(h, w, 3)


def build_native():
    """The native library's build, timed: (seconds, path)."""
    from stabletriton_tpu_torch import native

    t0 = time.perf_counter()
    path = native.build()
    return time.perf_counter() - t0, path


def phase_native(native_build):
    """Phase 7a: the port's native library (built from native/src into
    build/native/ in a thread beside the CUDA build; ``native_build`` is that
    future), every entry against its numpy version on full-size inputs, bit
    for bit, each timed."""
    from stabletriton_tpu_torch import native
    from stabletriton_tpu_torch.io.tokenizer import CLIPTokenizer, PyCLIPTokenizer

    seconds, path = native_build.result()
    if not native.have_native():
        raise AssertionError("the native library did not build")
    log(f"native library: {path}, built in {seconds:.2f} s (beside the CUDA build)")
    rng = np.random.default_rng(77)
    w = rng.standard_normal((1280, 1280)).astype(np.float32)
    conv = rng.standard_normal((1280, 1280, 3, 3)).astype(np.float32)
    img = rng.uniform(-1.1, 1.1, (1024, 1024, 3)).astype(np.float32)
    bf16 = (w.view(np.uint32) >> 16).astype(np.uint16)
    f16 = w.astype(np.float16).view(np.uint16)
    rgb = native.to_rgb8_plain(img)
    cases = [("bf16_to_f32 (1280, 1280)", native.bf16_to_f32, native.bf16_to_f32_plain, bf16),
             ("f16_to_f32 (1280, 1280)", native.f16_to_f32, native.f16_to_f32_plain, f16),
             ("transpose_2d (1280, 1280) f32", native.transpose_2d, native.transpose_2d_plain,
              w),
             ("oihw_to_hwio (1280, 1280, 3, 3) f32", native.oihw_to_hwio,
              native.oihw_to_hwio_plain, conv),
             ("to_rgb8 (1024, 1024, 3)", native.to_rgb8, native.to_rgb8_plain, img),
             ("encode_png (1024, 1024, 3)", native.encode_png, native.encode_png_plain, rgb)]
    rec = {}
    for label, fn, plain, x in cases:
        t0 = time.perf_counter()
        got = fn(x)
        t1 = time.perf_counter()
        want = plain(x)
        t2 = time.perf_counter()
        same = got == want if isinstance(got, bytes) else np.array_equal(got, want)
        if not same:
            raise AssertionError(f"native {label}: differs from its numpy version")
        rec[label] = {"native_ms": (t1 - t0) * 1e3, "plain_ms": (t2 - t1) * 1e3}
    if not np.array_equal(png_pixels(native.encode_png(rgb)), rgb):
        raise AssertionError("native PNG: decoded pixels differ")
    with tempfile.TemporaryDirectory() as d:
        write_vocab(os.path.join(d, "tok"))
        files = (os.path.join(d, "tok", "vocab.json"), os.path.join(d, "tok", "merges.txt"))
        tok, py = CLIPTokenizer(*files), PyCLIPTokenizer(*files)
        prompt = ("a photo of a lighthouse at dusk, 4k, highly detailed, "
                  "it's a cat's dream ") * 6
        t0 = time.perf_counter()
        ids = tok.encode(prompt)
        t1 = time.perf_counter()
        want = py.encode(prompt)
        rec["tokenizer 77 ids"] = {"native_ms": (t1 - t0) * 1e3,
                                   "plain_ms": (time.perf_counter() - t1) * 1e3}
        if not np.array_equal(ids, want):
            raise AssertionError("native tokenizer: ids differ from the plain version's")
    log("native entries, each bit for bit its numpy version (host ms, native / plain): "
        + json.dumps({k: [round(v["native_ms"], 3), round(v["plain_ms"], 3)]
                      for k, v in rec.items()}))
    return rec


# the prompt words the synthetic tokenizer merges whole (the others go
# character by character)
VOCAB_WORDS = ("a", "photo", "of", "lighthouse", "at", "dusk", "bowl", "ramen", "cat",
               "watercolor", "harbour", "highly", "detailed", "dream")


def write_vocab(d) -> None:
    """A synthetic CLIP vocabulary: every byte's symbol with and without
    </w>, the merges that build VOCAB_WORDS, and the start / end tokens at
    CLIP's ids 49406 / 49407."""
    from stabletriton_tpu_torch.io.tokenizer import _byte_encoder

    os.makedirs(d, exist_ok=True)
    enc = _byte_encoder()
    vocab = {}
    for b in range(256):
        vocab[enc[b]] = len(vocab)
    for b in range(256):
        vocab[enc[b] + "</w>"] = len(vocab)
    merges = []
    for word in VOCAB_WORDS:
        syms = list(word[:-1]) + [word[-1] + "</w>"]
        while len(syms) > 1:
            merges.append(f"{syms[0]} {syms[1]}")
            syms = [syms[0] + syms[1]] + syms[2:]
            vocab.setdefault(syms[0], len(vocab))
    vocab["<|startoftext|>"], vocab["<|endoftext|>"] = 49406, 49407
    with open(os.path.join(d, "vocab.json"), "w") as f:
        json.dump(vocab, f)
    with open(os.path.join(d, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n" + "\n".join(merges) + "\n")


def torch_layout(name: str, t: torch.Tensor) -> torch.Tensor:
    """This package's layout -> torch's (a view): the inverse of
    io.safetensors_io.to_framework_layout."""
    if not name.endswith(".weight") or "embedding" in name.rsplit(".", 2)[-2]:
        return t
    if t.dim() == 2:
        return t.t()
    if t.dim() == 4:
        return t.permute(3, 2, 0, 1)
    return t


def need_disk(path, nbytes_needed: int, what: str) -> None:
    free_b = shutil.disk_usage(path).free
    if free_b < nbytes_needed * 1.1:
        raise AssertionError(f"{what} needs {nbytes_needed / 2**30:.1f} GiB of disk under "
                             f"{path}; {free_b / 2**30:.1f} GiB free")


def sdxl_diffusers_config() -> dict:
    """SDXL-base's unet/config.json (stabilityai/stable-diffusion-xl-base-1.0),
    the fields the loader reads."""
    return {"in_channels": 4, "out_channels": 4, "block_out_channels": [320, 640, 1280],
            "down_block_types": ["DownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D"],
            "layers_per_block": 2, "transformer_layers_per_block": [1, 2, 10],
            "attention_head_dim": [5, 10, 20], "cross_attention_dim": 2048,
            "norm_num_groups": 32, "addition_embed_type": "text_time",
            "addition_time_embed_dim": 256, "projection_class_embeddings_input_dim": 2816,
            "flip_sin_to_cos": True, "freq_shift": 0}


def phase_loaded_sdxl(dev, size=1024):
    """Phase 7b: a full-width SDXL-base diffusers directory (f16, seeded
    random weights: UNet, both encoders, the whole VAE, unet/config.json,
    synthetic tokenizer files) written by io.safetensors_io's writer into a
    temporary directory, deleted at the end; ``load_sdxl`` loads it, two
    prompt strings are tokenized and run as two FRONT_STEPS-step 1024^2
    requests under the default binding (the first captures, the second
    replays), and each image must equal bit for bit the same request on a
    pipeline built in memory from the same f16 arrays. The PNG bytes of the
    native encoder decode back to to_rgb8's array."""
    from stabletriton_tpu_torch import native
    from stabletriton_tpu_torch.compile import CompileConfig
    from stabletriton_tpu_torch.io import pretrained
    from stabletriton_tpu_torch.io.safetensors_io import write_safetensors
    from stabletriton_tpu_torch.io.tokenizer import sdxl_tokenize
    from stabletriton_tpu_torch.models import clip as clip_mod
    from stabletriton_tpu_torch.models import vae as vae_mod
    from stabletriton_tpu_torch.models.unet import init_unet_params, sdxl_base_unet_config
    from stabletriton_tpu_torch.runtime import pipeline as tp

    f16 = torch.float16
    ucfg = sdxl_base_unet_config()
    c1, c2 = clip_mod.sdxl_text_encoder_config(), clip_mod.sdxl_text_encoder_2_config()
    vcfg = vae_mod.sdxl_vae_config()
    comps = {"unet": init_unet_params(ucfg, 70, device=dev, dtype=f16),
             "text_encoder": clip_mod.init_clip_params(c1, 71, device=dev, dtype=f16),
             "text_encoder_2": clip_mod.init_clip_params(c2, 72, device=dev, dtype=f16),
             "vae": {**vae_mod.init_vae_params(vcfg, 73, device=dev, dtype=f16),
                     **vae_mod.init_vae_encoder_params(vcfg, 74, device=dev, dtype=f16)}}
    files = {"unet": "diffusion_pytorch_model.safetensors",
             "vae": "diffusion_pytorch_model.safetensors",
             "text_encoder": "model.safetensors", "text_encoder_2": "model.safetensors"}
    total = sum(nbytes(*d.values()) for d in comps.values())
    root = tempfile.mkdtemp(prefix="sdxl_diffusers_")
    rec = {"checkpoint_gib": total / 2**30}
    try:
        need_disk(root, total, "phase 7b's SDXL-base directory")
        t0 = time.perf_counter()
        for comp, params in comps.items():
            os.makedirs(os.path.join(root, comp))
            write_safetensors(os.path.join(root, comp, files[comp]),
                              {k: torch_layout(k, v) for k, v in params.items()})
        with open(os.path.join(root, "unet", "config.json"), "w") as f:
            json.dump(sdxl_diffusers_config(), f)
        for sub in ("tokenizer", "tokenizer_2"):
            write_vocab(os.path.join(root, sub))
        rec["write_s"] = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe, tok1, tok2 = pretrained.load_sdxl(root, device=dev)
        torch.cuda.synchronize()
        rec["load_s"] = time.perf_counter() - t0
        decoder = set(vae_mod.vae_decoder_param_shapes(vcfg))
        memory = tp.SDXLPipeline(
            unet_config=ucfg, clip_config=c1, clip2_config=c2, vae_config=vcfg,
            params={"unet": comps["unet"],
                    **{k: {n: t.float() for n, t in comps[k].items()}
                       for k in ("text_encoder", "text_encoder_2")},
                    "vae": {n: t.float() for n, t in comps["vae"].items() if n in decoder}},
            compile_config=CompileConfig(), device=dev)
        if pipe.unet_config != ucfg or pipe.params["unet"].keys() != memory.params["unet"].keys():
            raise AssertionError("load_sdxl: another UNet config or key set than SDXL-base's")
        prompts = [("a photo of a lighthouse at dusk", 11), ("a bowl of ramen, highly detailed",
                                                              12)]
        images = {}
        for name, p in (("loaded", pipe), ("in memory", memory)):
            for i, (prompt, seed) in enumerate(prompts):
                ids1, ids2 = sdxl_tokenize(tok1, tok2, [prompt])
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                images[name, i] = p.txt2img(ids1, ids2, height=size, width=size,
                                            steps=FRONT_STEPS, seed=seed)
                torch.cuda.synchronize()
                rec[f"{name} request {i} s"] = time.perf_counter() - t0
            (prog,) = p._cache.values()
            if len(prog.loop.captured) != 1:
                raise AssertionError(f"phase 7b, {name}: {len(prog.loop.captured)} graphs")
        for i in range(len(prompts)):
            a, b = images["loaded", i], images["in memory", i]
            if a.shape != (1, size, size, 3) or not torch.isfinite(a).all():
                raise AssertionError(f"phase 7b: request {i} gave {tuple(a.shape)}")
            if not torch.equal(a, b):
                raise AssertionError(f"phase 7b: request {i} of the loaded pipeline differs "
                                     f"from the in-memory pipeline's (max abs "
                                     f"{(a - b).abs().max().item():.3e})")
        if torch.equal(images["loaded", 0], images["loaded", 1]):
            raise AssertionError("phase 7b: two prompts gave one image")
        img = images["loaded", 0][0].float().cpu().numpy()
        t0 = time.perf_counter()
        rgb = native.to_rgb8(img)
        png = native.encode_png(rgb)
        rec["png_ms"] = (time.perf_counter() - t0) * 1e3
        rec["png_bytes"] = len(png)
        if not np.array_equal(png_pixels(png), rgb):
            raise AssertionError("phase 7b: the PNG does not decode to to_rgb8's array")
        rec["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
        log(f"phase 7b, SDXL-base {size}^2 from a diffusers directory ({rec['checkpoint_gib']:.2f}"
            f" GiB f16, written by the port), default binding, {FRONT_STEPS} steps: each "
            f"request bit for bit the in-memory pipeline's (first call captures, second "
            f"replays); " + json.dumps(rec))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return rec


def sgm_unet_names(cfg) -> dict:
    """{diffusers key: SGM key} of a UNet config: io.single_file's tables
    inverted."""
    from stabletriton_tpu_torch.io import single_file as sf
    from stabletriton_tpu_torch.models.unet import unet_param_shapes

    in_map, out_map = sf._unet_block_tables(cfg)
    inv = {v: k for k, v in {**in_map, **out_map, **sf._UNET_FIXED}.items()}
    resnet_inv = {v: k for k, v in sf._RESNET_INNER.items()}
    out = {}
    for name in unet_param_shapes(cfg):
        mod, leaf = name.rsplit(".", 1)
        best = max((d for d in inv if mod == d or mod.startswith(d + ".")), key=len)
        rest = mod[len(best):].lstrip(".")
        for dmod, smod in resnet_inv.items():
            if rest == dmod or rest.startswith(dmod + "."):
                rest = smod + rest[len(dmod):]
                break
        out[name] = f"{inv[best]}.{rest}.{leaf}" if rest else f"{inv[best]}.{leaf}"
    return out


def sgm_vae_decoder(params: dict, levels: int) -> dict:
    """The VAE decoder's params (this package's layout and names) -> SGM
    names in torch layout: up blocks numbered from the bottom, the mid
    attention's projections as 1x1 convs."""
    out = {}
    for name, t in params.items():
        if not name.startswith(("decoder.", "post_quant_conv.")):
            continue
        t = torch_layout(name, t)
        if name.startswith("post_quant_conv."):
            out[name] = t
            continue
        mod, leaf = name[len("decoder."):].rsplit(".", 1)
        parts = mod.split(".")
        if mod in ("conv_in", "conv_out"):
            sgm = f"decoder.{mod}.{leaf}"
        elif mod == "conv_norm_out":
            sgm = f"decoder.norm_out.{leaf}"
        elif mod.startswith("mid_block.resnets."):
            inner = {"conv_shortcut": "nin_shortcut"}.get(parts[3], parts[3])
            sgm = f"decoder.mid.block_{int(parts[2]) + 1}.{inner}.{leaf}"
        elif mod.startswith("mid_block.attentions.0."):
            inner = mod[len("mid_block.attentions.0."):]
            ren = {"to_q": "q", "to_k": "k", "to_v": "v", "to_out.0": "proj_out",
                   "group_norm": "norm"}[inner]
            if inner.startswith("to_") and leaf == "weight":
                t = t[:, :, None, None]
            sgm = f"decoder.mid.attn_1.{ren}.{leaf}"
        elif parts[2] == "resnets":
            inner = {"conv_shortcut": "nin_shortcut"}.get(parts[4], parts[4])
            sgm = f"decoder.up.{levels - 1 - int(parts[1])}.block.{parts[3]}.{inner}.{leaf}"
        else:
            sgm = f"decoder.up.{levels - 1 - int(parts[1])}.upsample.conv.{leaf}"
        out[sgm] = t
    return out


def openclip_text(params: dict, cfg, projection: torch.Tensor) -> dict:
    """A CLIP text tower's params (HF names, this package's layout) ->
    OpenCLIP's names and torch layout: q/k/v fused into in_proj, and a
    (d, proj) text_projection as OpenCLIP stores it."""
    p = params
    out = {"token_embedding.weight": p["text_model.embeddings.token_embedding.weight"],
           "positional_embedding": p["text_model.embeddings.position_embedding.weight"],
           "ln_final.weight": p["text_model.final_layer_norm.weight"],
           "ln_final.bias": p["text_model.final_layer_norm.bias"],
           "text_projection": projection}
    for i in range(cfg.num_layers):
        hf, oc = f"text_model.encoder.layers.{i}", f"transformer.resblocks.{i}"
        att = f"{hf}.self_attn"
        out[f"{oc}.attn.in_proj_weight"] = torch.cat(
            [p[f"{att}.{x}_proj.weight"].t() for x in "qkv"])
        out[f"{oc}.attn.in_proj_bias"] = torch.cat([p[f"{att}.{x}_proj.bias"] for x in "qkv"])
        for ours, theirs in [("self_attn.out_proj", "attn.out_proj"), ("mlp.fc1", "mlp.c_fc"),
                             ("mlp.fc2", "mlp.c_proj"), ("layer_norm1", "ln_1"),
                             ("layer_norm2", "ln_2")]:
            for leaf in ("weight", "bias"):
                t = p[f"{hf}.{ours}.{leaf}"]
                out[f"{oc}.{theirs}.{leaf}"] = t.t() if t.dim() == 2 else t
    return out


def phase_sd2(dev, size=SD2_SIZE):
    """Phase 7c: SD2.x at full width from one SGM file (UNet under
    model.diffusion_model., OpenCLIP-H under cond_stage_model.model., the
    decoder under first_stage_model.; f16, seeded random weights) written
    into a temporary directory; ``load_single_file_auto`` must find "sd2",
    set clip_skip=2 and load every tensor as written. Then FRONT_STEPS-step
    768^2 requests under the default and the all-kernel
    binding, each twice (the first captures, the second replays with another
    prompt and seed), both bit for bit the eager loop on their inputs, with
    the launch counters set to 0 just before and read just after; each
    binding's latents against the reference binding's same request (eager):
    MSE, at most MODE_MSE_RATIO x the default binding's. Every request
    decodes (its loop's latents tapped at the decode): finite (1, 768, 768,
    3) images in [-1, 1]. Returns the requests' launches by key (denoise
    loops and decodes) and its record."""
    from stabletriton_tpu_torch import ops
    from stabletriton_tpu_torch.compile import (CompileConfig, cast_params,
                                                fuse_attention_projections, resolve_binding)
    from stabletriton_tpu_torch.io import pretrained
    from stabletriton_tpu_torch.io.safetensors_io import write_safetensors
    from stabletriton_tpu_torch.io.tokenizer import CLIPTokenizer
    from stabletriton_tpu_torch.models import clip as clip_mod
    from stabletriton_tpu_torch.models import vae as vae_mod
    from stabletriton_tpu_torch.models.unet import init_unet_params, sd21_unet_config
    from stabletriton_tpu_torch.runtime import pipeline as tp

    f16 = torch.float16
    ucfg, ccfg, vcfg = (sd21_unet_config(), clip_mod.sd2_text_encoder_config(),
                        vae_mod.sd15_vae_config())
    unet = init_unet_params(ucfg, 80, device=dev, dtype=f16)
    text = clip_mod.init_clip_params(ccfg, 81, device=dev, dtype=f16)
    vae = vae_mod.init_vae_params(vcfg, 82, device=dev, dtype=f16)
    projection = torch.randn((ccfg.hidden_size, ccfg.hidden_size), device=dev).to(f16)
    names = sgm_unet_names(ucfg)
    sd = {f"model.diffusion_model.{names[k]}": torch_layout(k, v) for k, v in unet.items()}
    sd.update({f"cond_stage_model.model.{k}": v
               for k, v in openclip_text(text, ccfg, projection).items()})
    sd.update({f"first_stage_model.{k}": v
               for k, v in sgm_vae_decoder(vae, len(vcfg.block_out_channels)).items()})
    rec = {"checkpoint_gib": nbytes(*sd.values()) / 2**30}
    root = tempfile.mkdtemp(prefix="sd2_single_")
    path = os.path.join(root, "sd21.safetensors")
    counters = kernel_counters()
    try:
        need_disk(root, nbytes(*sd.values()), "phase 7c's SD2.x single file")
        t0 = time.perf_counter()
        write_safetensors(path, sd)
        write_vocab(os.path.join(root, "tokenizer"))
        rec["write_s"] = time.perf_counter() - t0
        del sd
        tok = CLIPTokenizer(os.path.join(root, "tokenizer", "vocab.json"),
                            os.path.join(root, "tokenizer", "merges.txt"))
        configs = replay_configs()
        pipes = {}
        for name in ("default", "all_kernels", "reference"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pipe, family = pretrained.load_single_file_auto(path, compile_config=configs[name],
                                                            device=dev)
            if name == "reference":  # the yardstick: held against, run eagerly
                pipe = tp.SDXLPipeline(unet_config=pipe.unet_config,
                                       clip_config=pipe.clip_config,
                                       clip2_config=pipe.clip2_config,
                                       vae_config=pipe.vae_config, params=pipe.params,
                                       compile_config=configs[name], clip_skip=pipe.clip_skip,
                                       device=dev, _graphs=eager_graphs())
            torch.cuda.synchronize()
            rec[f"load_s {name}"] = time.perf_counter() - t0
            if (family, pipe.clip_skip, pipe.unet_config) != ("sd2", 2, ucfg):
                raise AssertionError(f"load_single_file_auto: family {family}, clip_skip "
                                     f"{pipe.clip_skip}, {pipe.unet_config}")
            pipes[name] = pipe
        # every tensor as written: the text encoder and decoder in f32, the
        # UNet fused and cast as the pipeline's binding does
        want = {"text_encoder": {k: v.float() for k, v in text.items()},
                "vae": {k: v.float() for k, v in vae.items()},
                "unet": cast_params(fuse_attention_projections(unet), configs["default"])}
        got = pipes["default"].params
        for group, tensors_ in want.items():
            extra = set(got[group]) - set(tensors_) - {"text_projection.weight"}
            if extra or any(not torch.equal(got[group][k], t) for k, t in tensors_.items()):
                raise AssertionError(f"phase 7c: the loaded {group} differs from what was "
                                     f"written ({sorted(extra)[:3]})")
        del want, unet, text, vae

        calls = [("a watercolor of a harbour", 21), ("a photo of a cat at dusk", 22)]

        def ids(prompt):
            return tok.encode_batch([prompt])

        def eager(pipe, prompt, seed):
            (prog,) = pipe._cache.values()
            dev_ids = pipe._ids(ids(prompt), ids(prompt),
                                ccfg.empty_prompt_ids(1), ccfg.empty_prompt_ids(1))
            with torch.inference_mode(), ops.use_backends(resolve_binding(pipe.compile_config)):
                inputs = prog.loop_inputs(pipe.params, *dev_ids, [seed])
                return prog.loop.__wrapped__(pipe.params["unet"], *inputs), prog

        def request(pipe, prompt, seed):
            """The request's images and its loop's latents (tapped at the
            decode)."""
            with DecodeTap() as tap:
                img = pipe.txt2img(ids(prompt), ids(prompt), height=size, width=size,
                                   steps=FRONT_STEPS, seed=seed)
            (latents,) = tap.latents
            if img.shape != (1, size, size, 3) or not torch.isfinite(img).all() or not (
                    -1.0 <= img.min().item() and img.max().item() <= 1.0):
                raise AssertionError(f"phase 7c: image {tuple(img.shape)}")
            return latents

        reference = {seed: request(pipes["reference"], prompt, seed) for prompt, seed in calls}
        reset(counters)
        outs = {}
        for name in ("default", "all_kernels"):
            for i, (prompt, seed) in enumerate(calls):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                outs[name, i] = request(pipes[name], prompt, seed)
                torch.cuda.synchronize()
                rec[f"{name} request {i} s"] = time.perf_counter() - t0
        by_key = launches_by_key(counters)
        for name in ("default", "all_kernels"):
            for i, (prompt, seed) in enumerate(calls):
                want_lat, prog = eager(pipes[name], prompt, seed)
                if not torch.equal(outs[name, i], want_lat):
                    raise AssertionError(f"phase 7c, {name}: call {i} differs from the eager "
                                         f"loop on its inputs")
                if len(prog.loop.captured) != 1:
                    raise AssertionError(f"phase 7c, {name}: {len(prog.loop.captured)} graphs")
            d = [(outs[name, i].float() - reference[seed].float()) for i, (_, seed)
                 in enumerate(calls)]
            rec[f"{name} vs reference"] = {
                "max_abs": max(x.abs().max().item() for x in d),
                "mse": max(x.square().mean().item() for x in d)}
        base = rec["default vs reference"]["mse"]
        if not rec["all_kernels vs reference"]["mse"] <= MODE_MSE_RATIO * max(base, 1e-12):
            raise AssertionError(f"phase 7c: all-kernel MSE {rec['all_kernels vs reference']}")
        if not all(torch.isfinite(o.float()).all() for o in outs.values()):
            raise AssertionError("phase 7c: latents not finite")
        rec["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
        log(f"phase 7c, SD2.x {size}^2 from an SGM single file ({rec['checkpoint_gib']:.2f} GiB "
            f"f16), family sd2, clip_skip 2, {FRONT_STEPS} steps: each call bit for bit the "
            f"eager loop (first captures, second replays), default and all-kernel; "
            + json.dumps(rec))
        del pipes, outs, reference
    finally:
        shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return by_key, rec


class DuckUNet:
    """A diffusers UNet as the frontend reads one: ``.config`` and
    ``.state_dict()`` (torch layout, views of this package's tensors)."""

    def __init__(self, config: dict, params: dict):
        self.config = config
        self._sd = {k: torch_layout(k, v) for k, v in params.items()}

    def state_dict(self):
        return self._sd


def phase_frontends(dev, lat=128):
    """Phase 7d: a full-width SDXL-base UNet module in torch layout (bf16 on
    the card) through frontends.diffusers.compile under the default binding:
    two per-step calls (the first captures, the second replays), each bit
    for bit unet_apply on the params the compiled UNet holds under the same
    binding; one DeepCache step pair (its full step bit for bit the plain
    step, its shallow one unet_apply_shallow on the carried cache); one
    CompVisUNetShim call with a 2816-wide y and zero-width time ids, bit for
    bit unet_apply on that y."""
    from stabletriton_tpu_torch import ops
    from stabletriton_tpu_torch.compile import CompileConfig, resolve_binding
    from stabletriton_tpu_torch.frontends import diffusers as fe
    from stabletriton_tpu_torch.frontends.sgm import CompVisUNetShim
    from stabletriton_tpu_torch.models.unet import (init_unet_params, sdxl_base_unet_config,
                                                    unet_apply, unet_apply_shallow)

    bf16 = torch.bfloat16
    ucfg = sdxl_base_unet_config()
    module = DuckUNet(sdxl_diffusers_config(), init_unet_params(ucfg, 90, device=dev,
                                                                dtype=bf16))
    cc = CompileConfig()
    rec = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    compiled = fe.compile(module, cc, device=dev)
    torch.cuda.synchronize()
    rec["ingest_s"] = time.perf_counter() - t0
    if compiled.unet_config != ucfg:
        raise AssertionError(f"frontend: config {compiled.unet_config}")
    del module
    binding = resolve_binding(cc)
    gen = torch.Generator(device=dev).manual_seed(91)

    def randn(*shape, dtype=bf16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    size = float(lat * 8)
    ctx = randn(2, 77, ucfg.cross_attention_dim)
    pooled = randn(2, ucfg.projection_class_embeddings_input_dim
                   - 6 * ucfg.addition_time_embed_dim)
    time_ids = torch.tensor([[size, size, 0, 0, size, size]] * 2, device=dev)
    kw = {"added_cond_kwargs": {"text_embeds": pooled, "time_ids": time_ids}}

    def nhwc(x):
        return x.permute(0, 2, 3, 1).to(bf16).contiguous()

    def nchw(x):
        return x.float().permute(0, 3, 1, 2).to(bf16)

    def direct(sample_nchw, t, fn=unet_apply, **extra):
        with torch.inference_mode(), ops.use_backends(binding):
            return fn(ucfg, compiled.params, nhwc(sample_nchw),
                      torch.full((2,), float(t), device=dev), ctx, pooled, time_ids, **extra)

    for i, t in enumerate((999.0, 501.0)):
        sample = randn(2, 4, lat, lat)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = compiled(sample, t, ctx, **kw).sample
        torch.cuda.synchronize()
        rec[f"step {i} s"] = time.perf_counter() - t0
        if not torch.equal(out, nchw(direct(sample, t))):
            raise AssertionError(f"frontend step {i}: differs from unet_apply on its params")
    (entry,) = compiled._fn.captured.values()
    rec["graph"] = capture_record(entry)

    dc = fe.CompiledUNet.from_params(ucfg, compiled.params, cc, deep_cache=2, device=dev)
    s0, s1 = randn(2, 4, lat, lat), randn(2, 4, lat, lat)
    full = dc(s0, 900.0, ctx, **kw).sample
    if not torch.equal(full, compiled(s0, 900.0, ctx, **kw).sample):
        raise AssertionError("frontend DeepCache: the full step differs from the plain step")
    shallow = dc(s1, 800.0, ctx, **kw).sample
    _, cache = direct(s0, 900.0, return_cache=True)
    with torch.inference_mode(), ops.use_backends(binding):
        want = unet_apply_shallow(ucfg, compiled.params, nhwc(s1),
                                  torch.full((2,), 800.0, device=dev), ctx, pooled, time_ids,
                                  cache)
    if not torch.equal(shallow, nchw(want)):
        raise AssertionError("frontend DeepCache: the shallow step differs from "
                             "unet_apply_shallow on the carried cache")
    rec["deep_cache_shallow_vs_full_max_abs"] = (
        shallow.float() - compiled(s1, 800.0, ctx, **kw).sample.float()).abs().max().item()

    from stabletriton_tpu_torch.ops import time_embed

    y = torch.cat([pooled, time_embed(time_ids.reshape(-1), dim=ucfg.addition_time_embed_dim
                                      ).to(bf16).reshape(2, -1)], dim=-1)
    if y.shape != (2, ucfg.projection_class_embeddings_input_dim):  # 2816 for SDXL-base
        raise AssertionError(f"y {tuple(y.shape)}")
    shim = CompVisUNetShim(compiled)
    x = randn(2, 4, lat, lat)
    got = shim(x, timesteps=torch.tensor([700.0], device=dev), context=ctx, y=y)
    with torch.inference_mode(), ops.use_backends(binding):
        want = unet_apply(ucfg, compiled.params, nhwc(x),
                          torch.full((2,), 700.0, device=dev), ctx, y,
                          torch.zeros((2, 0), device=dev))
    if not torch.equal(got, nchw(want)):
        raise AssertionError("CompVisUNetShim: differs from unet_apply on the same y")
    rec["y_vs_time_ids_max_abs"] = (got.float() - nchw(direct(x, 700.0)).float()).abs().max(
        ).item()
    rec["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    log("phase 7d, frontends at full SDXL-base width, default binding: diffusers compile's "
        "steps (capture, replay), the DeepCache pair and the 2816-wide y each bit for bit "
        "unet_apply on the compiled params; " + json.dumps(rec))
    del compiled, dc
    gc.collect()
    torch.cuda.empty_cache()
    return rec


REPLACES = {
    "K1": "stabletriton_tpu/kernels/flash_attention.py:228",
    "K2": "stabletriton_tpu/kernels/flash_attention.py:276",
    "K3": "stabletriton_tpu/kernels/flash_attention.py:120",
    "K4": "stabletriton_tpu/kernels/flash_attention.py:209",
    "K5": "stabletriton_tpu/kernels/flash_attention.py:184",
    "K6": "stabletriton_tpu/kernels/conv_direct.py:60",
    "K8": "stabletriton_tpu/kernels/conv_direct.py:60",  # with gs_ref/gsh_ref
    "K9": "stabletriton_tpu/kernels/group_norm.py:36",   # and _apply_kernel :54
    "K10": "stabletriton_tpu/kernels/layer_norm.py:23",
    "K11": "stabletriton_tpu/kernels/geglu.py:21",
    "K12": "stabletriton_tpu/kernels/time_embed.py:23",
    "K13": "stabletriton_tpu/kernels/linear.py:29",
    "K14": "stabletriton_tpu/kernels/dropout.py:25",
}


def front_door(dev, native_build):
    """Phases 7a-7d: the native library, SDXL-base from a diffusers
    directory, SD2.x from a single file, the frontends; their seconds
    logged. Returns phase 7c's launches by key and record."""
    t7 = time.perf_counter()
    seconds = {}
    for label, fn, arg in (("7a", phase_native, native_build), ("7b", phase_loaded_sdxl, dev),
                           ("7c", phase_sd2, dev), ("7d", phase_frontends, dev)):
        t0 = time.perf_counter()
        out = with_peak(f"phase {label}", fn, arg)
        seconds[label] = time.perf_counter() - t0
        if label == "7c":
            sd2_by_key, sd2_rec = out
    log(f"phase 7 seconds: {json.dumps(seconds)}, all {time.perf_counter() - t7:.1f}")
    return sd2_by_key, sd2_rec


# ---------------------------------------------------------------------------
# phase 8: runtime/profiling.py (8p, with the kernel phases, before any
# capture) and the turbo int8 mode, CompileConfig.quantize: its ops at the
# SDXL-base shapes (8k, also before any capture), its replayed step (8a)
# and its 1024^2 requests (8b)
# ---------------------------------------------------------------------------

INT8_PEAK_OPS = 1979e12  # the H100 SXM's dense int8 tensor-core peak (data sheet)
TURBO_MODES = ("int8", "int8_ff", "int8_conv")


def trace_kernel_ms(path: str) -> dict:
    """Device ms by kernel name in a Chrome trace written by profiling.trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    out = {}
    for e in events:
        if e.get("cat") == "kernel":
            out[e["name"]] = out.get(e["name"], 0.0) + e.get("dur", 0.0) / 1e3
    return out


def traced_kernel_ms(fn, calls: int) -> dict:
    """Device ms a call by kernel name of ``calls`` calls of fn, from
    profiling.trace's Chrome trace; a session that records no kernel (on
    the card's machine one now and then does) is traced again, at most
    three times."""
    from stabletriton_tpu_torch.runtime import profiling

    fn()
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        for attempt in range(3):
            with profiling.trace(log_dir=d) as path:
                for _ in range(calls):
                    fn()
            by_name = trace_kernel_ms(path)
            if by_name:
                return {n: ms / calls for n, ms in by_name.items()}
            log(f"  (trace session {attempt + 1} recorded no kernel; tracing again)")
    raise AssertionError("profiling.trace recorded no kernel in three sessions")


def phase_profiling(dev, kernel_results, card):
    """Phase 8p: runtime/profiling.py on the card. bench_fn on phase 3's K2
    shape (self-attention S=4096 h=10 d=64 bf16, the attention kernel's KV
    loop) chained through q, beside CUDA events on the same call in turns
    and phase 3's K2 row: within 10% of the events. Then trace around a
    few of those launches: the Chrome trace must name the kernel."""
    from stabletriton_tpu_torch.kernels import flash_attention as fa
    from stabletriton_tpu_torch.runtime import profiling

    gen = torch.Generator(device=dev).manual_seed(88)
    q = torch.randn((2, 4096, 640), generator=gen, device=dev).to(torch.bfloat16)
    kv = torch.randn((2, 4096, 1280), generator=gen, device=dev).to(torch.bfloat16)

    def call(q):
        return fa.flash_attention_kv(q, kv, num_heads=10)

    before = dict(fa.LAUNCHES.by_key)
    events = [timed_ms(lambda: call(q), 20)]
    bench = [profiling.bench_fn(call, q) * 1e3]
    bench.append(profiling.bench_fn(call, q) * 1e3)
    events.append(timed_ms(lambda: call(q), 20))
    keys = {k for k, n in fa.LAUNCHES.by_key.items() if n != before.get(k, 0)}
    if {tuple(k.split()[:2]) for k in keys} != {("K2", "wgmma_bf16")}:
        raise AssertionError(f"phase 8p: launched {sorted(keys)}, expected K2 on wgmma_bf16")
    (row,) = [r for r in kernel_results if r["name"] == "flash_attention self S=4096 h=10 bf16"]
    mean_events = sum(events) / len(events)
    spread = max(abs(b - mean_events) for b in bench) / mean_events
    by_name = traced_kernel_ms(lambda: call(q), 5)
    named = {n: ms for n, ms in by_name.items() if "attn_wgmma_bf16" in n}
    log(f"phase 8p, profiling.bench_fn, K2 self S=4096 h=10 bf16 chained through q ({card}): "
        f"bench_fn {bench[0]:.4f} / {bench[1]:.4f} ms a call, CUDA events on the same call "
        f"{events[0]:.4f} / {events[1]:.4f} ms (in turns: events, bench_fn, bench_fn, events); "
        f"largest gap {spread:.1%}; phase 3's K2 row (off the fused qkv buffer) "
        f"{row['ms']:.4f} ms, device {row['device_ms']:.4f} ms; profiling.trace: "
        f"{len(by_name)} kernel names, {json.dumps(named)} ms a call")
    if not spread <= 0.10:
        raise AssertionError(f"phase 8p: bench_fn {bench} ms against CUDA events {events} ms")
    if not named:
        raise AssertionError(f"phase 8p: the trace names no attention kernel: {sorted(by_name)}")
    return {"bench_fn_ms": bench, "event_ms": events, "row_ms": row["ms"],
            "trace_kernels": named}


# phase 8k: (label, x shape, N) of the int8 linears and (label, x shape,
# kernel size, Cout, stride, padding, bias) of the int8 convs at SDXL-base's
# 1024^2 shapes, CFG batch 2, bf16
INT8_LINEARS = [
    ("to_qkv (8192,640)->1920", (2, 4096, 640), 1920),
    ("ff up (8192,640)->5120", (2, 4096, 640), 5120),
    ("ff up (2048,1280)->10240", (2, 1024, 1280), 10240),
    ("cross K/V precompute (154,2048)->2560", (2, 77, 2048), 2560),
    ("time_emb_proj (2,1280)->1280, M = 2", (2, 1280), 1280),
]
INT8_CONVS = [
    ("3x3 s1 128x128 320->320 batch-bias", (2, 128, 128, 320), 3, 320, 1, 1, "batch"),
    ("3x3 s2 downsampler 64x64->32x32 640->640", (2, 64, 64, 640), 3, 640, 2, 1, "cout"),
    ("1x1 shortcut 32x32 640->1280", (2, 32, 32, 640), 1, 1280, 1, 0, "cout"),
]


def phase_int8_kernels(dev, card):
    """Phase 8k: the turbo ops (ops/reference.py linear_int8, conv2d_int8)
    at SDXL-base's shapes, bf16. Each: the int8 activations and the int32
    accumulators on the card equal to the CPU's (rows quantize and sum
    independently: exact), the output's max abs difference against the same
    op on the CPU; its time by CUDA events and device time, beside the bare
    product (torch._int_mm on the padded operands, the weight as stored,
    output-channel-major, and row-major), the bf16 kernel at that shape (K13;
    K6 for the 3x3 stride-1 conv) and one cuBLAS addmm / cuDNN call; its
    device time split into product and glue from profiling.trace's Chrome
    trace (the product's kernels named by a trace of the bare product);
    its bound at the int8 peak or the memory rate."""
    from stabletriton_tpu_torch.compile import quantize_linear_weights
    from stabletriton_tpu_torch.kernels import conv_direct as cd
    from stabletriton_tpu_torch.kernels import linear as lin
    from stabletriton_tpu_torch.ops import reference as ref

    gen = torch.Generator(device=dev).manual_seed(4242)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(torch.bfloat16)

    def int_mm_status(m, b):
        try:
            torch._int_mm(torch.ones((m, 64), dtype=torch.int8, device=dev), b)
            torch.cuda.synchronize()
            return "ok"
        except RuntimeError as e:
            return "refused: " + str(e).splitlines()[0][:160]

    # the rules pad_int8_rows and the quantizer's layout follow: cuBLASLt
    # refuses M <= 16, and a row-major weight at some shapes (logged only)
    w64 = torch.ones((64, 64), dtype=torch.int8, device=dev)
    rules = {"M=16, stored": int_mm_status(16, w64.t()),
             "M=17, stored": int_mm_status(17, w64.t()),
             "M=17, row-major": int_mm_status(17, w64)}
    log(f"phase 8k, torch._int_mm at K = N = 64 ({card}): {json.dumps(rules)}")

    cases = [dict(label=f"linear {label}", x=randn(*xs), k=xs[-1], n=n, conv=None)
             for label, xs, n in INT8_LINEARS]
    cases += [dict(label=f"conv {label}", x=randn(*xs), k=ks * ks * xs[-1], n=cout,
                   conv=(ks, stride, pad, bias))
              for label, xs, ks, cout, stride, pad, bias in INT8_CONVS]
    rows = []
    for c in cases:
        x, n, conv = c["x"], c["n"], c["conv"]
        cin = x.shape[-1]
        if conv is None:
            w = randn(cin, n, scale=cin ** -0.5)
            b = randn(n, scale=0.1)
            dims, kw = -1, {}
            op, plain = ref.linear_int8, ref.linear
        else:
            ks, stride, pad, bias = conv
            w = randn(ks, ks, cin, n, scale=(ks * ks * cin) ** -0.5)
            b = randn(*((x.shape[0], n) if bias == "batch" else (n,)), scale=0.1)
            dims, kw = (1, 2, 3), dict(stride=stride, padding=pad)
            op, plain = ref.conv2d_int8, ref.conv2d
        pair = quantize_linear_weights({"w.weight": w}, min_dim=1, conv=conv is not None)[
            "w.weight"]
        cpu_pair = tuple(t.cpu() for t in pair)
        wmat = pair[0].reshape(c["k"], n)

        def operands(x):
            xq, sx = ref._quantize_activations(x.float(), dims)
            a = (xq.reshape(-1, c["k"]) if conv is None
                 else ref._im2col(xq, conv[0], conv[0], conv[1], conv[2])[0])
            return xq, sx, a

        xq, sx, a = operands(x)
        xq_c, sx_c, a_c = operands(x.cpu())
        acc, acc_c = ref.int8_mm(a, wmat), ref.int8_mm(a_c, wmat.cpu())
        torch.cuda.synchronize()
        if not (torch.equal(xq.cpu(), xq_c) and torch.equal(sx.cpu(), sx_c)):
            raise AssertionError(f"phase 8k {c['label']}: the int8 activations differ from "
                                 f"the CPU's")
        if not torch.equal(acc.cpu(), acc_c):
            raise AssertionError(f"phase 8k {c['label']}: the int32 accumulators differ from "
                                 f"the CPU's")
        out = op(x, pair, b, **kw)
        out_c = op(x.cpu(), cpu_pair, b.cpu(), **kw)
        if not torch.isfinite(out.float()).all():
            raise AssertionError(f"phase 8k {c['label']}: output not finite")
        exact = plain(x, w, b, **kw)
        m = a.shape[0]
        r = {"name": f"int8 {c['label']}", "m": m, "k": c["k"], "n": n,
             "max_abs_vs_cpu": (out.cpu().float() - out_c.float()).abs().max().item(),
             "rel_vs_bf16": ((out.float() - exact.float()).abs().max()
                             / exact.float().abs().max()).item()}
        iters = 20
        op_fn = lambda: op(x, pair, b, **kw)  # noqa: E731
        pa, pb = ref.pad_int8_rows(a), wmat
        pb_rows = pb.contiguous()  # the same weight row-major, for the layout's cost
        r["ms"] = timed_ms(op_fn, iters)
        r["device_ms"] = device_ms(op_fn, iters)[0]
        r["product_ms"] = timed_ms(lambda: torch._int_mm(pa, pb), iters)
        r["product_row_major_ms"] = timed_ms(lambda: torch._int_mm(pa, pb_rows), iters)
        r["product_device_ms"] = device_ms(lambda: torch._int_mm(pa, pb), iters)[0]
        product_names = set(traced_kernel_ms(lambda: torch._int_mm(pa, pb), 3))
        for _ in range(3):  # a session that dropped kernels is traced again
            by_name = traced_kernel_ms(op_fn, 3)
            if sum(by_name.values()) >= 0.75 * r["device_ms"]:
                break
            log(f"  (the trace holds {sum(by_name.values()):.4f} of {r['device_ms']:.4f} "
                f"device ms; tracing again)")
        r["trace_product_ms"] = sum(ms for kn, ms in by_name.items() if kn in product_names)
        r["trace_glue_ms"] = sum(ms for kn, ms in by_name.items() if kn not in product_names)
        r["trace_kernels"] = len(by_name)
        if conv is None:
            x2 = x.reshape(-1, cin)
            r["bf16_kernel"] = "K13 " + ("skinny_bf16" if m <= 16 else "wgmma_bf16")
            r["bf16_kernel_ms"] = timed_ms(lambda: lin.linear(x, w, b), iters)
            r["library"] = "cuBLAS addmm"
            r["library_ms"] = timed_ms(lambda: torch.addmm(b, x2, w), iters)
        else:
            if conv[0] == 3 and conv[1] == 1:
                r["bf16_kernel"] = "K6 wgmma_bf16"
                r["bf16_kernel_ms"] = timed_ms(lambda: cd.conv3x3(x, w, b), iters)
            else:
                r["bf16_kernel"], r["bf16_kernel_ms"] = "none (cuDNN on the default binding)", None
            r["library"] = "cuDNN (reference conv2d)"
            r["library_ms"] = timed_ms(lambda: plain(x, w, b, **kw), iters)
        flops = 2.0 * m * c["k"] * n
        moved = nbytes(x, pair[0], pair[1], b, out)
        r["bound_ms"], r["bound_by"] = bound(flops, moved, None, INT8_PEAK_OPS)
        log(f"int8 {c['label']} ({card}): M={m} K={c['k']} N={n}; activations and int32 "
            f"accumulators equal to the CPU's; max abs vs CPU op {r['max_abs_vs_cpu']:.3e}, "
            f"rel vs the bf16 op {r['rel_vs_bf16']:.3e}; op {r['ms']:.4f} ms (device "
            f"{r['device_ms']:.4f}), product alone {r['product_ms']:.4f} ms (device "
            f"{r['product_device_ms']:.4f}; weight row-major {r['product_row_major_ms']:.4f})"
            f"; trace: product {r['trace_product_ms']:.4f} + glue {r['trace_glue_ms']:.4f} ms "
            f"in {r['trace_kernels']} kernel names; {r['bf16_kernel']} "
            f"{ms_text(r['bf16_kernel_ms'])}, {r['library']} {r['library_ms']:.4f} ms; bound "
            f"{r['bound_ms'] * 1e3:.4g} us ({r['bound_by']}), {r['bound_ms'] / r['ms']:.1%} "
            f"of bound")
        rows.append(r)
        del xq, sx, a, acc, out, pa, pb, pb_rows
    torch.cuda.empty_cache()
    log("phase 8k int8 rows " + json.dumps(rows))
    return rows


class Int8Products:
    """Counts the turbo ops' int32 products (ops/reference.py int8_mm)
    while entered, in all and at M <= 16 (the rows padded for cuBLASLt), by
    wrapping the module's int8_mm (restored on exit)."""

    def __enter__(self):
        from stabletriton_tpu_torch.ops import reference

        self.ref, self.fn = reference, reference.int8_mm
        self.calls = self.skinny = 0

        def counting(a, b):
            self.calls += 1
            self.skinny += a.shape[0] <= 16
            return self.fn(a, b)

        reference.int8_mm = counting
        return self

    def __exit__(self, *exc):
        self.ref.int8_mm = self.fn


def weight_bytes(params: dict) -> int:
    return nbytes(*(t for v in params.values() for t in (v if isinstance(v, tuple) else (v,))))


def turbo_configs() -> dict:
    from stabletriton_tpu_torch.compile import FUSED_OP_OVERRIDES, CompileConfig

    return {"bf16 default": CompileConfig(),
            **{mode: CompileConfig(quantize=mode) for mode in TURBO_MODES},
            "int8_conv fused-op": CompileConfig(quantize="int8_conv",
                                                overrides=FUSED_OP_OVERRIDES)}


def quantized_unet(fused: dict, config) -> dict:
    from stabletriton_tpu_torch.compile import quantize_linear_weights

    if config.quantize is None:
        return fused
    return quantize_linear_weights(fused, min_dim=config.quantize_min_dim,
                                   conv=config.quantize == "int8_conv",
                                   ff_only=config.quantize == "int8_ff")


def phase_turbo_steps(dev, cfg, params, inputs, step_4e, card):
    """Phase 8a: compile_unet_kv's SDXL-base step (128^2 latent, CFG batch
    2, bf16, phase 4's weights) under the default binding in bf16 and in
    each turbo mode, and int8_conv under the fused-op binding: the first
    call (eager, then captured) and a replay bit for bit the eager step;
    the replayed step timed by profiling.bench_fn chained through the
    sample, beside the bf16 step timed the same way and phase 4e's event
    ms; its MSE and relative max error against the bf16 step (finite, and
    not equal to it); the UNet's weight bytes; the eager step's int8
    products (some at M <= 16 where time_emb_proj is quantized)."""
    from stabletriton_tpu_torch.compile import compile_unet_kv, fuse_attention_projections
    from stabletriton_tpu_torch.runtime import profiling

    sample, ctx, pooled, time_ids = (inputs[k] for k in ("sample", "ctx", "pooled", "time_ids"))
    t = torch.full((2,), 500.0, device=dev)
    fused = fuse_attention_projections(params)
    results, bf16_out = {}, None
    with torch.inference_mode():
        for name, config in turbo_configs().items():
            p = quantized_unet(fused, config)
            pre, _, step = compile_unet_kv(cfg, config)
            kv = pre.__wrapped__(p, ctx)
            with Int8Products() as products:
                eager = step.__wrapped__(p, sample, t, kv, pooled, time_ids)
            if config.quantize and not products.calls or (
                    config.quantize in ("int8", "int8_conv") and not products.skinny):
                raise AssertionError(f"phase 8a {name}: {products.calls} int8 products, "
                                     f"{products.skinny} at M <= 16")
            first = step(p, sample, t, kv, pooled, time_ids)  # eager, then the capture
            out = step(p, sample, t, kv, pooled, time_ids)    # a replay
            torch.cuda.synchronize()
            if not (torch.equal(first, eager) and torch.equal(out, eager)):
                raise AssertionError(f"phase 8a {name}: the replay differs from the eager step")
            if not torch.isfinite(out.float()).all():
                raise AssertionError(f"phase 8a {name}: the step's output is not finite")
            rec = {"bench_fn_ms": [profiling.bench_fn(step, p, sample, t, kv, pooled, time_ids,
                                                      chain_arg=1, n_long=6, reps=2) * 1e3
                                   for _ in range(2)],
                   "weight_gib": weight_bytes(p) / 2**30,
                   "int8_products": products.calls, "int8_products_m_le_16": products.skinny}
            if bf16_out is None:
                bf16_out = out
            else:
                d = out.float() - bf16_out.float()
                rec["mse_vs_bf16"] = d.square().mean().item()
                rec["rel_max_vs_bf16"] = (d.abs().max() / bf16_out.float().abs().max()).item()
                if torch.equal(out, bf16_out):
                    raise AssertionError(f"phase 8a {name}: equal to the bf16 step")
            log(f"phase 8a, SDXL-base step 128^2 B=2, {name} ({card}): replay bit for bit the "
                f"eager step; {products.calls} int8 products ({products.skinny} at M <= 16, "
                f"rows padded) on torch._int_mm; bench_fn "
                + " / ".join(f"{v:.2f}" for v in rec["bench_fn_ms"])
                + " ms a replayed step (phase 4e's default replay, CUDA events: "
                + " / ".join(f"{v:.2f}" for v in step_4e)
                + f" ms); weights {rec['weight_gib']:.3f} GiB"
                + (f"; vs bf16: MSE {rec['mse_vs_bf16']:.3e}, rel max "
                   f"{rec['rel_max_vs_bf16']:.3e}" if "mse_vs_bf16" in rec else ""))
            results[name] = rec
            del pre, step, kv, eager, first, out, p
            gc.collect()
            torch.cuda.empty_cache()
    log("phase 8a turbo steps " + json.dumps(results))
    return results


def phase_turbo_requests(dev, ucfg, unet_params, other, card):
    """Phase 8b: one SDXL-base 1024^2 4-step Euler txt2img request per
    turbo mode through SDXLPipeline(compile_config=CompileConfig(quantize=
    mode)) on the card, latents returned: the first request (eager loop,
    capture) and a second of the same signature (a replay), each timed with
    its peak memory and bit for bit the eager loop on its inputs; the
    quantized UNet's weight bytes beside the bf16 one's."""
    from stabletriton_tpu_torch import ops
    from stabletriton_tpu_torch.compile import (CompileConfig, fuse_attention_projections,
                                                resolve_binding)
    from stabletriton_tpu_torch.runtime.pipeline import SDXLPipeline

    (c1, c2, vcfg), params = other
    tok = StubTokenizer(c1.bos_token_id, c1.eos_token_id)
    # the default pipeline's bf16 UNet: fused, and already in bf16
    results = {"bf16": {"weight_gib": weight_bytes(fuse_attention_projections(unet_params))
                        / 2**30}}
    for mode in TURBO_MODES:
        config = CompileConfig(quantize=mode)
        pipe = SDXLPipeline(unet_config=ucfg, clip_config=c1, clip2_config=c2,
                            vae_config=vcfg, params={"unet": unet_params, **params},
                            compile_config=config, device=dev)
        rec = results[mode] = {"weight_gib": weight_bytes(pipe.params["unet"]) / 2**30}
        binding = resolve_binding(config)
        rows = []
        for prompt, seed in (("a lighthouse at dusk", 41), ("a bowl of ramen", 42)):
            ids1 = tok.encode_batch([prompt], max_len=c1.max_position_embeddings)
            ids2 = tok.encode_batch([prompt], max_len=c2.max_position_embeddings, pad=0)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            lat = pipe.txt2img(ids1, ids2, height=1024, width=1024, steps=SERVE_STEPS,
                               guidance_scale=5.0, seed=seed, return_latents=True)
            torch.cuda.synchronize()
            row = {"wall_s": time.perf_counter() - t0,
                   "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30}
            prog = pipe._program(1, 1024, 1024, SERVE_STEPS, 5.0, "euler", True)
            ids = [torch.as_tensor(np.asarray(a), dtype=torch.long).to(dev) for a in (
                ids1, ids2, c1.empty_prompt_ids(1, ids1.shape[1]),
                c2.empty_prompt_ids(1, ids2.shape[1]))]
            with torch.inference_mode(), ops.use_backends(binding):
                eager = prog.loop.__wrapped__(pipe.params["unet"],
                                              *prog.loop_inputs(pipe.params, *ids, [seed]))
            if not torch.equal(lat, eager):
                raise AssertionError(f"phase 8b {mode}: request differs from its eager loop")
            if not torch.isfinite(lat.float()).all() or len(prog.loop.captured) != 1:
                raise AssertionError(f"phase 8b {mode}: latents not finite or "
                                     f"{len(prog.loop.captured)} graphs")
            rows.append(row)
        rec["requests"] = rows
        log(f"phase 8b, SDXL-base 1024^2 {SERVE_STEPS}-step Euler request, {mode} ({card}): "
            f"first (eager loop, capture) {rows[0]['wall_s']:.3f} s, replayed "
            f"{rows[1]['wall_s']:.3f} s, each bit for bit its eager loop; peak "
            f"{rows[0]['peak_gib']:.2f} / {rows[1]['peak_gib']:.2f} GiB; UNet weights "
            f"{rec['weight_gib']:.3f} GiB (bf16 {results['bf16']['weight_gib']:.3f})")
        del pipe, prog, lat, eager
        gc.collect()
        torch.cuda.empty_cache()
    log("phase 8b turbo requests " + json.dumps(results))
    return results


# ---------------------------------------------------------------------------
# phases 9t, 9p, 9f, 9m: autotune, the packaged table, fft_conv, the mesh
# ---------------------------------------------------------------------------

# the fitted rule's two recorded misses (wgmma_plan.gemm_plan): SD2.x's cross
# K/V precompute and SD1.5's 8^2-level projection
RECORDED_MISSES = [(154, 1024, 640), (128, 1280, 1280)]


def replay_us(launch, token) -> float:
    """us a launch of ``launch()`` (one kernel launch, or one library call),
    as the tuner measures its candidates: bench_fn over a CUDA graph of
    autotune.REPS launches."""
    from stabletriton_tpu_torch.kernels import autotune
    from stabletriton_tpu_torch.runtime.profiling import bench_fn

    cand = autotune.Candidate(None, launch)
    try:
        return bench_fn(cand, token, chain_arg=0, min_window=0.01) / autotune.REPS * 1e6
    finally:
        cand.release()


class EmptyTable:
    """Within: the autotune table starts empty (no packaged file, a user
    cache in a temporary directory); the table is restored after."""

    def __enter__(self):
        import pathlib

        from stabletriton_tpu_torch.kernels import autotune

        self.saved = autotune.PACKAGED_DIR, os.environ.get("ST_TPU_AUTOTUNE_CACHE")
        self.tmp = tempfile.TemporaryDirectory()
        autotune.PACKAGED_DIR = pathlib.Path(self.tmp.name) / "none"
        self.cache = os.path.join(self.tmp.name, "user.json")
        os.environ["ST_TPU_AUTOTUNE_CACHE"] = self.cache
        autotune.reload()
        return self

    def __exit__(self, *exc):
        from stabletriton_tpu_torch.kernels import autotune

        autotune.PACKAGED_DIR = self.saved[0]
        if self.saved[1] is None:
            os.environ.pop("ST_TPU_AUTOTUNE_CACHE", None)
        else:
            os.environ["ST_TPU_AUTOTUNE_CACHE"] = self.saved[1]
        autotune.reload()
        self.tmp.cleanup()

    def entries(self) -> int:
        return len(json.load(open(self.cache))) if os.path.exists(self.cache) else 0


def plan_text(plan) -> str:
    if isinstance(plan, tuple) and len(plan) == 2 and isinstance(plan[0], str):
        return f"{plan[0]} tiles={plan[1]}"
    if hasattr(plan, "cols"):
        return f"cols={plan.cols} split={plan.splits}"
    return f"bn={plan.bn} split={plan.splits}"


def tuned_plan_mismatches(tally: dict) -> tuple[int, list]:
    """The launch keys of a captured graph (its tally) whose plan is not the
    autotune table's for their shape: a wgmma GEMM's bn and split, a skinny
    GEMM's cols and split, a wgmma conv's bn and split (the table's entries
    at its shape, any residual and act), a bf16 attention's kernel; where
    the entry keeps the rule, the rule's (wgmma_plan's, skinny_plan,
    kernel_name). A key of those kernels whose shape the table lacks counts
    too. Returns (keys checked, mismatches)."""
    from stabletriton_tpu_torch.kernels import autotune
    from stabletriton_tpu_torch.kernels import conv_direct as cd
    from stabletriton_tpu_torch.kernels import flash_attention as fa
    from stabletriton_tpu_torch.kernels import linear as lin
    from stabletriton_tpu_torch.kernels import wgmma_plan as wp

    def plan_of(e, rule, fields=("bn", "splits")):
        """The entry's plan as the launch key writes it; the rule's where it
        keeps the rule."""
        if autotune.keeps_rule(e):
            return tuple(str(getattr(rule, f)) for f in fields)
        return tuple(str(e[f]) for f in fields)

    bf16 = torch.bfloat16
    checked, bad = 0, []
    for (counter, key), _ in tally.items():
        words = key.split()
        f = dict(w.split("=", 1) for w in words if "=" in w)
        if counter is lin.LAUNCHES and words[0] in ("wgmma_bf16", "skinny_bf16"):
            m, k, n = int(f["m"]), int(f["k"]), int(f["n"])
            e = autotune.lookup(autotune.linear_key(m, k, n, bf16))
            if words[0] == "wgmma_bf16":
                want = {plan_of(e, wp.gemm_plan(m, k, n))} if e else set()
            else:
                want = {plan_of(e, lin.skinny_plan(m, k, n, 2), ("cols", "splits"))} if e else set()
            got = (f.get("bn", f.get("cols")), f["split"])
        elif counter in (cd.LAUNCHES, cd.GN_LAUNCHES) and words[0] in ("wgmma_bf16",
                                                                       "wgmma_gn_bf16"):
            n = int(f["b"])
            h, w = (int(v) for v in words[2].split("x"))
            cin, cout = (int(v) for v in words[3].split("->"))
            gn = counter is cd.GN_LAUNCHES
            rule = wp.conv_plan(n, h, w, -(-cin // 8) * 8, cout, gn=gn)[1]
            want = set()
            for res in (False, True):
                for act in (None, "silu"):
                    e = autotune.lookup(autotune.conv_key(n, h, w, cin, cout, bf16, res, act, gn))
                    if e:
                        want.add(plan_of(e, rule))
            got = (f["bn"], f["split"])
        elif counter is fa.LAUNCHES and words[1] in fa._KERNEL_CODES:
            b, h, d, sq, sk = (int(f[k]) for k in ("b", "h", "d", "sq", "sk"))
            want = set()
            for k in (autotune.attention_key(b, sq, sk, h, d, bf16),
                      autotune.fused_attention_key("qkv" if sq == sk else "kv", b, sq, sk, h, d,
                                                   bf16)):
                e = autotune.lookup(k)
                if e:
                    want.add(fa.kernel_name(bf16, sk) if autotune.keeps_rule(e) else e["kernel"])
            got = words[1]
        else:
            continue
        checked += 1
        if got not in want:
            bad.append((key, sorted(want)))
    return checked, bad


def phase_tuning(dev, ucfg, unet_params, other, card):
    """Phase 9t: autotune on the card (kernels/autotune.py), from an empty
    table. (a) ensure_tuned_for the SDXL-base 1024^2 batch-1 signature
    under the all-kernel binding, timed; (b) the same signature through the
    pipeline's hook (ST_TPU_AUTOTUNE=1): it tunes nothing, and every launch
    key of the captured loop names the table's plan; (c) the two recorded
    misses, a K8 conv (128^2 320->320 with the GroupNorm prologue) and a
    tiny-KV attention (Sq 4096, Sk 77, h 10) tuned, each tuned plan held
    against the plain version, and timed beside the rule's plan (twice
    each, in turns) and one library call."""
    import torch.nn.functional as F

    from stabletriton_tpu_torch.compile import ALL_KERNEL_OVERRIDES, CompileConfig, resolve_binding
    from stabletriton_tpu_torch.kernels import autotune
    from stabletriton_tpu_torch.kernels import conv_direct as cd
    from stabletriton_tpu_torch.kernels import flash_attention as fa
    from stabletriton_tpu_torch.kernels import linear as lin
    from stabletriton_tpu_torch.runtime.pipeline import SDXLPipeline

    rec = {"card": card}
    bf16 = torch.bfloat16
    config = CompileConfig(overrides=ALL_KERNEL_OVERRIDES)
    with EmptyTable() as table:
        t0 = time.perf_counter()
        tuned = autotune.ensure_tuned_for(resolve_binding(config), ucfg, 128, 128, 1, bf16, (2,))
        wall = time.perf_counter() - t0
        by_op = {}
        for t in tuned:
            op = t.key.split(":")[0] + (":gn" if t.key.endswith(":gn") else "")
            by_op[op] = by_op.get(op, 0) + 1
        moved = [t for t in tuned if not autotune.keeps_rule(t.entry)]
        rule_sum = sum(t.times_us[t.rule] for t in tuned)
        best_sum = sum(t.entry["t_us"] for t in tuned)
        rec["ensure"] = {"shapes": len(tuned), "by_op": by_op, "wall_s": wall,
                         "moved_off_rule": len(moved), "rule_us_sum": rule_sum,
                         "tuned_us_sum": best_sum}
        log(f"phase 9t, SDXL-base 1024^2 batch 1, all-kernel binding, from an empty table "
            f"({card}): {len(tuned)} shapes tuned {by_op} in {wall:.1f} s; {len(moved)} off the "
            f"rule's plan; one launch of each shape: rule {rule_sum:.1f} us, tuned "
            f"{best_sum:.1f} us")
        for t in sorted(moved, key=lambda t: t.entry["t_us"] - t.times_us[t.rule])[:8]:
            log(f"  {t.key}: rule {plan_text(t.rule)} {t.times_us[t.rule]:.2f} us, tuned "
                f"{ {k: v for k, v in t.entry.items() if k != 't_us'} } {t.entry['t_us']:.2f} us")

        # (b) the pipeline's hook: nothing left to tune; the graph launches the table's plans
        entries = table.entries()
        (c1, c2, vcfg), params = other
        tok = StubTokenizer(c1.bos_token_id, c1.eos_token_id)
        ids1 = tok.encode_batch(["a lighthouse at dusk"], max_len=c1.max_position_embeddings)
        ids2 = tok.encode_batch(["a lighthouse at dusk"], max_len=c2.max_position_embeddings,
                                pad=0)
        os.environ["ST_TPU_AUTOTUNE"] = "1"
        try:
            pipe = SDXLPipeline(unet_config=ucfg, clip_config=c1, clip2_config=c2,
                                vae_config=vcfg, params={"unet": unet_params, **params},
                                compile_config=config, device=dev)
            walls = []
            for seed in (5, 6):
                t0 = time.perf_counter()
                lat = pipe.txt2img(ids1, ids2, height=1024, width=1024, steps=SERVE_STEPS,
                                   seed=seed, return_latents=True)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                if not torch.isfinite(lat).all():
                    raise AssertionError("phase 9t: the tuned request's latents are not finite")
        finally:
            os.environ.pop("ST_TPU_AUTOTUNE", None)
        if table.entries() != entries:
            raise AssertionError(f"phase 9t: the hook tuned {table.entries() - entries} shapes "
                                 f"of a signature already tuned")
        prog = pipe._program(1, 1024, 1024, SERVE_STEPS, 5.0, "euler", True, None, None)
        (entry,) = prog.loop.captured.values()
        checked, bad = tuned_plan_mismatches(entry.tally)
        if bad or not checked:
            raise AssertionError(f"phase 9t: {len(bad)} of {checked} launch keys of the captured "
                                 f"loop off the table's plans: {bad[:5]}")
        rec["hook"] = {"walls_s": walls, "keys_checked": checked}
        log(f"phase 9t, the same signature through the pipeline's hook: nothing tuned; "
            f"{checked} launch keys of the captured loop name the table's plans; request "
            f"{walls[0]:.2f} s (eager loop and capture), {walls[1]:.2f} s replayed")
        del pipe, prog, entry, lat
        gc.collect()
        torch.cuda.empty_cache()

        # (c) the recorded misses, K8 and tiny-KV attention: rule, tuned, library
        gen = torch.Generator(device=dev).manual_seed(71)
        token = torch.empty(1, device=dev)

        def in_turns(rule_fn, tuned_fn):
            times = {"rule": [], "tuned": []}
            for which in ("rule", "tuned", "tuned", "rule"):
                times[which].append(replay_us(rule_fn if which == "rule" else tuned_fn, token))
            return times

        def report(label, t, tuned_plan, times, lib_label, lib_us, err, tol):
            """Log a tuned shape; a tuned plan other than the rule's must be
            no slower than the rule's beyond the two-run spread, or 0.5% of
            the rule's time, the gap two timings of one plan showed (PR 17's
            runs: 0.2%)."""
            spread = max(abs(times["rule"][0] - times["rule"][1]),
                         abs(times["tuned"][0] - times["tuned"][1]))
            same = tuned_plan == t.rule
            row = {"rule": plan_text(t.rule), "tuned": {k: v for k, v in t.entry.items()
                                                        if k != "t_us"},
                   "tuned_is_rule": same, "rule_us": times["rule"], "tuned_us": times["tuned"],
                   "spread_us": spread, lib_label: lib_us, "max_rel_err": err}
            log(f"phase 9t, {label} ({card}): rule {row['rule']} "
                f"{'/'.join(f'{v:.2f}' for v in times['rule'])} us, tuned {row['tuned']}"
                + (" (the rule's own plan) " if same else " ")
                + f"{'/'.join(f'{v:.2f}' for v in times['tuned'])} us (two-run spread "
                f"{spread:.2f} us), {lib_label} "
                + ("not measured" if lib_us is None else f"{lib_us:.2f} us")
                + f"; tuned plan vs plain: rel err {err:.3e} (tol {tol:g})")
            if not err <= tol:
                raise AssertionError(f"phase 9t, {label}: rel err {err:.3e} over {tol:g}")
            margin = max(spread, 0.005 * max(times["rule"]))
            if not same and min(times["tuned"]) > max(times["rule"]) + margin:
                raise AssertionError(f"phase 9t, {label}: the tuned plan is slower than the "
                                     f"rule's beyond the two-run spread: {row}")
            return row

        def rel_err(out, ref):
            torch.cuda.synchronize()
            return ((out.float() - ref.float()).abs().max() / ref.float().abs().max()).item()

        rec["misses"] = []
        for m, k, n in RECORDED_MISSES:
            t = autotune.tune_linear(m, k, n)
            x = torch.randn((m, k), generator=gen, device=dev).to(bf16)
            w = (torch.randn((k, n), generator=gen, device=dev) / k ** 0.5).to(bf16)
            b = torch.randn(n, generator=gen, device=dev).to(bf16)
            plan = lin._route(x.shape, w.shape, b.shape, bf16, bf16, None).plan
            out = lin.linear(x, w, b)
            err = rel_err(out, lin.linear_plain(x, w, b))
            times = in_turns(lambda: lin._launch(x, w, b, None, "wgmma_bf16", plan=t.rule),
                             lambda: lin._launch(x, w, b, None, "wgmma_bf16", plan=plan))
            lib = replay_us(lambda: torch.addmm(b, x, w), token)
            rec["misses"].append({"shape": (m, k, n), **report(
                f"GEMM ({m},{k})@({k},{n})", t, plan, times, "cublas_us", lib, err,
                BF16_REL_TOL)})
        # K8: the first resnet conv of SDXL's 128^2 level (per-batch bias, no residual)
        t = autotune.tune_conv(2, 128, 128, 320, 320, has_res=False, act=None, gn=True)
        x = torch.randn((2, 128, 128, 320), generator=gen, device=dev).to(bf16)
        w = (torch.randn((3, 3, 320, 320), generator=gen, device=dev) / 54).to(bf16)
        bias = torch.randn((2, 320), generator=gen, device=dev)
        scale = torch.rand((2, 320), generator=gen, device=dev) + 0.5
        shift = torch.randn((2, 320), generator=gen, device=dev)
        gn = (scale, shift, "silu")
        plan = cd._wgmma_route(2, 128, 128, 320, 320, True, False, None)[1]
        err = rel_err(cd.gn_conv3x3(x, scale, shift, w, bias),
                      cd.gn_conv3x3_plain(x, scale, shift, w, bias))
        times = in_turns(
            lambda: cd._launch(x, w, bias, None, None, gn, "wgmma_gn_bf16", plan=t.rule),
            lambda: cd._launch(x, w, bias, None, None, gn, "wgmma_gn_bf16", plan=plan))
        rec["k8"] = report("K8 conv 2x128x128 320->320 with the GroupNorm prologue", t, plan,
                           times, "library_us", None, err, BF16_REL_TOL)
        # tiny-KV attention off the fused KV buffer: SDXL's 64^2 cross-attention
        t = autotune.tune_attention_fused(2, 4096, 77, 10, 64)
        q = torch.randn((2, 4096, 640), generator=gen, device=dev).to(bf16)
        kv = torch.randn((2, 77, 1280), generator=gen, device=dev).to(bf16)
        route = fa._route(bf16, 2, 4096, 77, 10, 64, None, None, (0, 0, 640), "kv")
        err = rel_err(fa.flash_attention_kv(q, kv, num_heads=10),
                      fa.attention_plain(q, *kv.chunk(2, -1), num_heads=10))

        def attn(kernel, tiles):
            return fa._launch(q, 0, kv, 0, kv, 640, sq=4096, sk=77, num_heads=10, d=64,
                              scale=None, kernel=kernel, tiles=tiles, entry="kv")

        times = in_turns(lambda: attn(*t.rule), lambda: attn(route.kernel, route.tiles))
        qh = q.reshape(2, 4096, 10, 64).transpose(1, 2).contiguous()
        kh, vh = (u.reshape(2, 77, 10, 64).transpose(1, 2).contiguous() for u in kv.chunk(2, -1))
        lib = replay_us(lambda: F.scaled_dot_product_attention(qh, kh, vh), token)
        rec["tinykv"] = report("tiny-KV attention b=2 Sq=4096 Sk=77 h=10 d=64", t,
                               (route.kernel, route.tiles), times, "sdpa_us", lib, err,
                               BF16_REL_TOL)
    log(f"phase 9t tuning {json.dumps(rec)}")
    return rec


def phase_packaged_table(dev, ucfg, unet_params, card):
    """Phase 9p: the replayed SDXL-base step (compile_unet_kv, 128^2 CFG
    batch 2) under the default, fused-op and all-kernel bindings with the
    packaged table, beside the same step with the table off (the fitted
    rules), each in fresh graphs, in turns (table, rules, rules, table);
    CUDA events over 5 replays, 3 windows each. A record of what the table
    does, not a claim. Without a packaged table for the card's tag the
    rules run and there is nothing to compare."""
    import contextlib

    from stabletriton_tpu_torch.compile import compile_unet_kv, fuse_attention_projections
    from stabletriton_tpu_torch.kernels import autotune

    path = autotune.packaged_path(autotune.platform_tag())
    if not path.exists():
        log(f"phase 9p: no packaged table for {autotune.platform_tag()} ({card}): every route "
            f"takes its rule")
        return None
    inputs = sdxl_step_inputs(dev)
    fused = fuse_attention_projections(unet_params)
    t = torch.full((2,), 500.0, device=dev)
    configs = replay_configs()
    rec = {"card": card, "entries": len(json.loads(path.read_text()))}
    for name in ("default", "fused_ops", "all_kernels"):
        times = {"table": [], "rules": []}
        outs = {}
        for which in ("table", "rules", "rules", "table"):
            ctx = contextlib.nullcontext() if which == "table" else autotune.disabled()
            with ctx, torch.inference_mode():
                pre, _, step = compile_unet_kv(ucfg, configs[name])
                kv = pre(fused, inputs["ctx"])
                args = (fused, inputs["sample"], t, kv, inputs["pooled"], inputs["time_ids"])
                step(*args)  # eager warm-up and capture
                outs[which] = step(*args)  # a replay
                torch.cuda.synchronize()
                for _ in range(3):
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    for _ in range(5):
                        step(*args)
                    end.record()
                    end.synchronize()
                    times[which].append(start.elapsed_time(end) / 5)
            del pre, step, kv
            gc.collect()
            torch.cuda.empty_cache()
        diff = (outs["table"].float() - outs["rules"].float())
        rec[name] = {"table_ms": times["table"], "rules_ms": times["rules"],
                     "table_vs_rules_mse": diff.pow(2).mean().item()}
        log(f"phase 9p, SDXL-base step replayed, {name} binding ({card}): packaged table "
            f"{min(times['table']):.3f}-{max(times['table']):.3f} ms, rules "
            f"{min(times['rules']):.3f}-{max(times['rules']):.3f} ms "
            f"({min(times['table']) / min(times['rules']) - 1:+.1%}); outputs MSE "
            f"{rec[name]['table_vs_rules_mse']:.3e}")
        if not torch.isfinite(outs["table"]).all():
            raise AssertionError(f"phase 9p {name}: the step's output is not finite")
    log(f"phase 9p packaged table {json.dumps(rec)}")
    return rec


def phase_fft_conv(dev):
    """Phase 9f: fft_conv2d (torch.fft, cuFFT) on the card at (1, 128, 128,
    4) with a 9 x 9 kernel, against F.conv2d in depthwise form (TF32 off;
    the kernel flipped, since fft_conv2d convolves and conv2d correlates)."""
    import torch.nn.functional as F

    from stabletriton_tpu_torch.kernels.fft_conv import fft_conv2d

    gen = torch.Generator(device=dev).manual_seed(81)
    x = torch.randn((1, 128, 128, 4), generator=gen, device=dev)
    k = torch.randn((9, 9), generator=gen, device=dev)
    weight = k.flip(0, 1)[None, None].expand(4, 1, 9, 9).contiguous()

    def direct():
        return F.conv2d(x.permute(0, 3, 1, 2), weight, padding=4, groups=4).permute(0, 2, 3, 1)

    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        out, ref = fft_conv2d(x, k), direct()
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        scale = ref.abs().max().item()
        fft_ms, direct_ms = timed_ms(lambda: fft_conv2d(x, k), 20), timed_ms(direct, 20)
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    log(f"phase 9f, fft_conv2d (1,128,128,4) 9x9 vs F.conv2d depthwise: max abs {err:.3e} "
        f"(largest output {scale:.3g}, tol {F32_REL_TOL:g} of it); fft {fft_ms:.4f} ms, conv2d "
        f"{direct_ms:.4f} ms")
    if out.shape != ref.shape or not err <= F32_REL_TOL * scale:
        raise AssertionError(f"phase 9f: fft_conv2d {tuple(out.shape)} max abs {err:.3e}")
    return {"max_abs": err, "fft_ms": fft_ms, "conv2d_ms": direct_ms}


def mesh_rank(rank: int, world: int, init: str, out_path: str) -> None:
    """One rank of phase 9m (two ranks on the one card, gloo; spawned):
    (a) the SDXL-base UNet step at full width, bf16, eager, default binding,
    on its shards of a data=1 model=2 mesh (rank 0 also runs the unsharded
    step on the same inputs); (b) a 1024^2 4-step txt2img of batch 2 on a
    data=2 model=1 mesh, captured then replayed (rank 0 also runs the
    unsharded pipeline's batch 2). Writes its results to ``out_path % rank``."""
    import datetime

    import torch.distributed as dist

    from stabletriton_tpu_torch import ops
    from stabletriton_tpu_torch.compile import (CompileConfig, fuse_attention_projections,
                                                resolve_binding)
    from stabletriton_tpu_torch.models.unet import (precompute_cross_kv, sdxl_base_unet_config,
                                                    unet_apply)
    from stabletriton_tpu_torch.runtime import mesh as mesh_mod
    from stabletriton_tpu_torch.runtime.pipeline import SDXLPipeline

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=600))
    try:
        rec = {"rank": rank}
        ucfg = sdxl_base_unet_config()
        params = make_unet_params(dev, ucfg)
        inputs = sdxl_step_inputs(dev)
        t = torch.full((2,), 500.0, device=dev)
        binding = resolve_binding(CompileConfig())

        def step(p):
            with torch.inference_mode(), ops.use_backends(binding):
                kv = precompute_cross_kv(ucfg, p, inputs["ctx"])
                return unet_apply(ucfg, p, inputs["sample"], t, None, inputs["pooled"],
                                  inputs["time_ids"], cross_kv=kv)

        tp = mesh_mod.make_mesh(data=1, model=2, device_type="cuda")
        local = mesh_mod.shard_params(params, tp)
        rec["local_to_q"] = tuple(local[
            "down_blocks.1.attentions.0.transformer_blocks.0.attn1.to_q.weight"].shape)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with mesh_mod.use_mesh(tp):
            out = step(local)
        torch.cuda.synchronize()
        rec["tp_step_s"] = time.perf_counter() - t0
        if rank == 0:
            ref = step(fuse_attention_projections(params))
            d = out.float() - ref.float()
            rec["tp_max_abs"], rec["tp_mse"] = d.abs().max().item(), d.pow(2).mean().item()
            rec["tp_finite"] = bool(torch.isfinite(out).all())
            del ref, d
        del local, out
        torch.cuda.empty_cache()
        dist.barrier()

        (c1, c2, vcfg), other = make_other_params(dev)
        dp = mesh_mod.make_mesh(data=2, model=1, device_type="cuda")
        tok = StubTokenizer(c1.bos_token_id, c1.eos_token_id)
        prompts = ["a lighthouse at dusk", "a bowl of ramen"]
        ids1 = tok.encode_batch(prompts, max_len=c1.max_position_embeddings)
        ids2 = tok.encode_batch(prompts, max_len=c2.max_position_embeddings, pad=0)

        def pipeline(mesh):
            return SDXLPipeline(unet_config=ucfg, clip_config=c1, clip2_config=c2,
                                vae_config=vcfg, params={"unet": params, **other},
                                compile_config=CompileConfig(), device=dev, mesh=mesh)

        def request(pipe):
            t0 = time.perf_counter()
            img = pipe.txt2img(ids1, ids2, height=1024, width=1024, steps=SERVE_STEPS,
                               seed=41)
            torch.cuda.synchronize()
            return img, time.perf_counter() - t0

        pipe = pipeline(dp)
        first, rec["dp_first_s"] = request(pipe)
        again, rec["dp_replay_s"] = request(pipe)
        rec["dp_graphs"] = sum(len(p.loop.captured) for p in pipe._cache.values())
        rec["dp_shape"] = tuple(again.shape)
        rec["dp_ok"] = bool(torch.isfinite(again).all() and again.abs().max() <= 1.0)
        rec["dp_first_vs_replay"] = (first.float() - again.float()).abs().max().item()
        del pipe
        torch.cuda.empty_cache()
        if rank == 0:
            solo, rec["unsharded_s"] = request(pipeline(None))
            rec["dp_max_abs"] = (again.float() - solo.float()).abs().max().item()
        with open(out_path % rank, "w") as f:
            json.dump(rec, f)
    finally:
        dist.destroy_process_group()


def phase_mesh(dev, card):
    """Phase 9m: the mesh over torch.distributed, two ranks on the one card
    over gloo (NCCL takes one rank a device), a TCP store on localhost at a
    free port (mesh_rank): (a) data=1 model=2, the full-width SDXL-base UNet
    step on rank-local shards against the unsharded step on the same card,
    MSE under the step gate; (b) data=2 model=1, a replayed 1024^2 4-step
    txt2img of batch 2 against the unsharded pipeline's batch 2, held to
    SOLO_VS_BATCHED_BOUND (each rank runs half the rows). An NCCL mesh and
    the capture of its all-reduce are not run: the machine has one card."""
    import socket

    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "rank%d.json")
        ctx = mp.start_processes(mesh_rank, args=(2, f"tcp://127.0.0.1:{port}", out), nprocs=2,
                                 join=False, start_method="spawn")
        deadline = time.monotonic() + 400
        try:
            while not ctx.join(timeout=5):
                if time.monotonic() > deadline:
                    raise AssertionError("phase 9m: the two ranks did not finish in 400 s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
        recs = [json.load(open(out % r)) for r in range(2)]
    a = recs[0]
    log(f"phase 9m (a), SDXL-base UNet step 128^2 B=2 bf16, default binding, data=1 model=2 "
        f"(gloo, 2 ranks on one {card}): rank-local to_q {a['local_to_q']}, against the "
        f"unsharded step: max abs {a['tp_max_abs']:.3e}, MSE {a['tp_mse']:.3e} (gate "
        f"{STEP_MSE_GATE:g}); eager step {a['tp_step_s']:.2f} / {recs[1]['tp_step_s']:.2f} s")
    log(f"phase 9m (b), 1024^2 {SERVE_STEPS}-step txt2img batch 2, data=2 model=1: images "
        f"{a['dp_shape']}, first (eager loop, capture) {a['dp_first_s']:.2f} / "
        f"{recs[1]['dp_first_s']:.2f} s, replayed {a['dp_replay_s']:.2f} / "
        f"{recs[1]['dp_replay_s']:.2f} s, unsharded batch 2 {a['unsharded_s']:.2f} s; against "
        f"the unsharded pipeline: max abs {a['dp_max_abs']:.3e} (bound "
        f"{SOLO_VS_BATCHED_BOUND}); first vs replay {a['dp_first_vs_replay']:.3e}")
    log("phase 9m: an NCCL mesh and the capture of its all-reduce are not run (one card)")
    if not (a["tp_finite"] and a["tp_mse"] <= STEP_MSE_GATE):
        raise AssertionError(f"phase 9m (a): MSE {a['tp_mse']:.3e} over {STEP_MSE_GATE:g}")
    for r in recs:
        if r["local_to_q"] != [640, 320] or r["dp_shape"] != [2, 1024, 1024, 3] or not r["dp_ok"]:
            raise AssertionError(f"phase 9m: rank {r['rank']}: {r}")
        if r["dp_graphs"] != 1:
            raise AssertionError(f"phase 9m: rank {r['rank']} captured {r['dp_graphs']} graphs")
    if not a["dp_max_abs"] <= SOLO_VS_BATCHED_BOUND:
        raise AssertionError(f"phase 9m (b): max abs {a['dp_max_abs']:.3e} over "
                             f"{SOLO_VS_BATCHED_BOUND}")
    log(f"phase 9m mesh {json.dumps(recs)}")
    return recs


def with_peak(label, fn, *args, **kwargs):
    """fn(*args, **kwargs), logging the peak device memory it allocated and
    the seconds it took."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    torch.cuda.synchronize()
    log(f"peak device memory, {label}: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"{time.perf_counter() - t0:.1f} s")
    return out


def free(*objs):
    """Drop the caller's last references (passed in a container) and
    return the device memory they held to the card."""
    for o in objs:
        o.clear()
    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    args = sys.argv[1:]
    profile = "--profile" in args
    host_time = "--host-time" in args
    gn_mode = "--group-norm" in args
    sd21_mode = "--sd21" in args
    k8_mode = "--k8" in args
    for flag in ("--host-time", "--group-norm"):
        at = args.index(flag) + 1 if flag in args else len(args)
        if at < len(args) and not args[at].startswith("--"):
            sys.path.insert(0, os.path.abspath(args[at]))
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; a CUDA GPU is required",
              file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    dev = torch.device("cuda", 0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    from stabletriton_tpu_torch.kernels import build
    if host_time or gn_mode:
        log(f"package: {os.path.dirname(os.path.dirname(os.path.abspath(build.__file__)))}")
    from stabletriton_tpu_torch.models.unet import sd15_unet_config, sdxl_base_unet_config

    pool = ThreadPoolExecutor(1)
    if not (host_time or gn_mode or sd21_mode or k8_mode):
        # the native library (g++, phase 7a) builds beside the CUDA kernels
        native_build = pool.submit(build_native)
    t0 = time.perf_counter()
    build.library()
    log(f"build: {time.perf_counter() - t0:.2f} s ({build.build_info})")
    if "log" in build.build_info:
        # registers and spills of the wgmma kernels, and every warning
        entry = ""
        for line in open(build.build_info["log"]).read().splitlines():
            if "Compiling entry" in line:
                entry = line.split("'")[1] if "'" in line else line
            elif "warning" in line.lower() or ("wgmma" in entry and (
                    "registers" in line or "spill" in line)):
                log(f"  ptxas {entry[:90]}: {line.strip()}")

    if host_time:
        phase_host_time(dev)
        pool.shutdown()
        return 0
    if gn_mode:
        phase_group_norm(dev)
        pool.shutdown()
        return 0
    if k8_mode:
        pool.shutdown()
        at = args.index("--k8") + 1
        parent = args[at] if at < len(args) and not args[at].startswith("--") else None
        rows = with_peak("phase 3k", phase_k8, dev, parent)
        log(json.dumps({"k8": rows}))
        if "--serve" in args:
            ucfg = sdxl_base_unet_config()
            sdxl = {"unet": make_unet_params(dev, ucfg)}
            sdxl["other"] = make_other_params(dev)
            with_peak("phase 5b", phase_serving_fused, dev, ucfg, sdxl["unet"], sdxl["other"])
            free(sdxl)
        log(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if sd21_mode:
        pool.shutdown()
        sd21_results = with_peak("phase 7v", phase_sd21_kernels, dev)
        sd21_by_key = with_peak("phase 5v", phase_serving_sd21, dev)
        return report([table_row(r, path_launches(r, sd21_by_key), {}) for r in sd21_results])
    if "--plans" in args:
        phase_plans(dev)
    kernel_results = (with_peak("phase 3", phase_kernels, dev)
                      + with_peak("phase 3b", phase_fused_kernels, dev)
                      + with_peak("phase 3c", phase_sd15_attention, dev))
    with_peak("phase 3e", phase_c4, dev)
    kernel_results += with_peak("phase 3f", phase_bf16apply, dev)
    kernel_results += with_peak("phase 3d", phase_optional_kernels, dev)
    # the image paths' kernel checks with the others, before any phase
    # captures a graph or serves from a worker thread: after those, the
    # profiler recorded no kernel in three sessions running (PR 14's run)
    image_results = with_peak("phase 6k", phase_image_kernels, dev)
    sd2_results = with_peak("phase 7k", phase_sd2_kernels, dev)
    sd21_results = with_peak("phase 7v", phase_sd21_kernels, dev)
    # runtime/profiling.py and the turbo ops at their shapes, with the
    # kernel phases: the profiler must see their kernels
    with_peak("phase 8p", phase_profiling, dev, kernel_results, card)
    with_peak("phase 8k", phase_int8_kernels, dev, card)

    # SDXL-base at 1024^2: phases 4, 4b, 4d, 4e, 4f, 5, 5b, 5d
    ucfg = sdxl_base_unet_config()
    sdxl = {"unet": make_unet_params(dev, ucfg)}
    with_peak("phases 4, 4b, 4d (weights included)", phase_step_deviation, dev, ucfg,
              sdxl["unet"], sdxl_step_inputs(dev), ALL_PER_STEP, PRECOMPUTE_LINEARS,
              ATTN_PER_STEP, CONV_SPLIT, LINEAR_SPLIT, "SDXL-base", profile)
    sdxl["other"] = make_other_params(dev)
    replay_step = with_peak("phase 4e step", phase_replay_step, dev, ucfg, sdxl["unet"],
                            sdxl_step_inputs(dev), "SDXL-base", profile)
    with_peak("phase 4e requests", phase_replay_requests, dev, ucfg, sdxl["unet"],
              sdxl["other"], profile)
    with_peak("phase 4f steps", phase_deep_cache_steps, dev, ucfg, sdxl["unet"],
              sdxl_step_inputs(dev), "SDXL-base")
    with_peak("phase 4f requests", phase_mode_requests, dev, ucfg, sdxl["unet"],
              sdxl["other"], profile)
    diffs = {}
    by_key, diffs["default"] = with_peak("phase 5", phase_serving, dev, ucfg, sdxl["unet"],
                                         sdxl["other"])
    fused_counts, fused_by_key, diffs["fused-op"] = with_peak(
        "phase 5b", phase_serving_fused, dev, ucfg, sdxl["unet"], sdxl["other"])
    all_counts, all_by_key, diffs["all-kernel"] = with_peak(
        "phase 5d", phase_serving_all, dev, ucfg, sdxl["unet"], sdxl["other"])
    diffs["reference"] = with_peak("phase 5e serving", phase_serving_reference, dev, ucfg,
                                   sdxl["unet"], sdxl["other"])
    check_solo_vs_batched(diffs, "SDXL-base")
    with_peak("phase 5e decode", phase_decode_deviation, dev, sdxl["other"][0][2],
              sdxl["other"][1]["vae"], profile)
    # the image-conditioned paths at 1024^2, the launch counters set to 0
    # just before their requests and read just after
    image_by_key, _ = with_peak("phase 6 (refiner and 9-channel conv_in included)",
                                phase_images, dev, ucfg, sdxl["unet"], sdxl["other"])
    # turbo int8 at 1024^2: the replayed step in each mode, then requests
    with_peak("phase 8a", phase_turbo_steps, dev, ucfg, sdxl["unet"], sdxl_step_inputs(dev),
              replay_step["default"]["replay_event_ms"], card)
    with_peak("phase 8b", phase_turbo_requests, dev, ucfg, sdxl["unet"], sdxl["other"], card)
    # autotune from an empty table, then the packaged table beside the rules
    with_peak("phase 9t", phase_tuning, dev, ucfg, sdxl["unet"], sdxl["other"], card)
    with_peak("phase 9p", phase_packaged_table, dev, ucfg, sdxl["unet"], card)
    free(sdxl)

    # SD1.5 at 512^2: phases 4c (default, fused-op and all-kernel), 4e, 4h, 4f, 5c
    ucfg = sd15_unet_config()
    sd15 = {"unet": make_unet_params(dev, ucfg)}
    sd15_step = with_peak("phase 4c (weights included)", phase_step_deviation, dev, ucfg,
                          sd15["unet"],
              sd15_step_inputs(dev), SD15_ALL_PER_STEP, SD15_PRECOMPUTE_LINEARS,
              SD15_ATTN_PER_STEP, SD15_CONV_SPLIT, SD15_LINEAR_SPLIT, "SD1.5", profile)
    with_peak("phase 4e SD1.5 step", phase_replay_step, dev, ucfg, sd15["unet"],
              sd15_step_inputs(dev), "SD1.5", profile)
    with_peak("phase 4h", phase_bf16apply_steps, dev, ucfg, sd15["unet"])
    with_peak("phase 4f SD1.5 steps", phase_deep_cache_steps, dev, ucfg, sd15["unet"],
              sd15_step_inputs(dev), "SD1.5")
    sd15["other"] = make_sd15_other_params(dev)
    sd15_by_key = with_peak("phase 5c", phase_serving_sd15, dev, ucfg, sd15["unet"],
                            sd15["other"])
    free(sd15)
    sd21_by_key = with_peak("phase 5v", phase_serving_sd21, dev)

    sd2_by_key, sd2_rec = front_door(dev, native_build)
    pool.shutdown()
    log("latent MSE against the reference binding: SD2.x 768^2 4-step request (phase 7c) "
        + ", ".join(f"{b} {sd2_rec[f'{b} vs reference']['mse']:.3e}"
                    for b in ("default", "all_kernels"))
        + "; SD1.5 512^2 UNet step (phase 4c) "
        + ", ".join(f"{b} {sd15_step[b]['mse']:.3e}" for b in ("default", "all_kernels")))
    with_peak("phase 9f", phase_fft_conv, dev)
    with_peak("phase 9m (this process)", phase_mesh, dev, card)

    # launches of each kernel on its path: the serving phases (5, 5b, 5c,
    # 5d), by the first two fields of its launch key ("K3 wgmma_tf32x3") for
    # attention and by the first (the kernel: "wgmma_bf16", "wgmma_tf32x3",
    # "scalar", "skinny_bf16" ...) for the conv (K6, K8) and K13; K14's op
    # dispatch in phase 3d
    attention = [*by_key["flash_attention"].items(), *sd15_by_key["flash_attention"].items()]
    conv = [*by_key["conv3x3"].items(), *sd15_by_key["conv3x3"].items()]

    def launches(r):
        if "counter" in r and r["counter"] in BF16APPLY_COUNTER.values():
            # the default binding's kernel forms: phases 5 and 5c
            return sum(by_key[r["counter"]].values()) + sum(sd15_by_key[r["counter"]].values())
        if r["tpu"] == "K6":
            return sum(n for key, n in conv if key.startswith(r["kernel"] + " "))
        if r["tpu"] == "K8":
            return sum(n for key, n in fused_by_key["K8"].items()
                       if key.startswith(r["kernel"] + " "))
        if r["tpu"] == "K9" and "k9_path" in r:
            return k9_launches(fused_by_key if r["k9_path"] == "sdxl"
                               else sd15_step["fused_ops"]["by_key"], r["k9_hwc"])
        if r["tpu"] == "K12":
            return all_counts["K12"]
        if r["tpu"] == "K13":
            # the skinny kernel's launches by (K, N) (each of the step's
            # skinny GEMMs has its row; M is 2 alone, 4 co-batched); the
            # other kernels' in all
            _, k, n = r["shape"]
            shape = f" k={k} n={n} " if r["kernel"].startswith("skinny") else ""
            return sum(c for key, c in all_by_key["K13"].items()
                       if key.startswith(r["kernel"] + " ") and shape in key)
        if r["tpu"] == "K14":
            return r["launches"]
        if r["tpu"] in FUSED_PER_STEP:
            return fused_counts[r["tpu"]]
        return sum(n for key, n in attention if key.startswith(r["kernel"] + " "))

    def image_launches(r):
        """Launches of the row's kernel on phase 6's path: of its shape (the
        row's ``match``) for phase 6k's rows, else as ``launches`` counts
        them, on phase 6's counters."""
        if "match" in r:
            return sum(n for key, n in image_by_key[r["counter"]].items()
                       if all(m in key + " " for m in r["match"]))
        if "counter" in r:
            return sum(image_by_key[r["counter"]].values())
        if r["tpu"] in ("K6", "K8"):
            return sum(n for key, n in image_by_key[r["tpu"]].items()
                       if key.startswith(r["kernel"] + " "))
        if r["tpu"] == "K13":
            _, k, n = r["shape"]
            shape = f" k={k} n={n} " if r["kernel"].startswith("skinny") else ""
            return sum(c for key, c in image_by_key["K13"].items()
                       if key.startswith(r["kernel"] + " ") and shape in key)
        if r["tpu"] in ("K9", "K10", "K11", "K12"):
            return sum(image_by_key[r["tpu"]].values())
        if r["tpu"] == "K14":
            return 0
        return sum(n for key, n in image_by_key["attention"].items()
                   if key.startswith(r["kernel"] + " "))

    def sd2_launches(r):
        """Launches of a phase 7k row's kernel at its shape on phase 7c's
        path (its requests' counters)."""
        return path_launches(r, sd2_by_key)

    kernels = [table_row(r, sd2_launches(r) if r.get("path") == "sd2"
                         else path_launches(r, sd21_by_key) if r.get("path") == "sd21"
                         else image_launches(r) if "match" in r else launches(r),
                         {"sd2_path_launches": sd2_launches(r)} if r.get("path") == "sd2"
                         else {} if r.get("path") == "sd21"
                         else {"image_path_launches": image_launches(r)})
               for r in kernel_results + image_results + sd2_results + sd21_results]
    return report(kernels)


def path_launches(r, by_key) -> int:
    """Launches of a row's kernel at its shape (the row's ``match``) on a
    path whose counters gave ``by_key``."""
    return sum(n for key, n in by_key[r["counter"]].items()
               if all(m in key + " " for m in r["match"]))


def table_row(r, launches, extra) -> dict:
    """A kernel row of the result line: ``launches`` on its path, ``extra``
    fields beside them."""
    return {
        "name": r["name"] + (f" [{r['kernel']}]" if r.get("kernel") else ""), "route": "cuda",
        "source": r["source"], "replaces": REPLACES[r["tpu"]], "launches": launches,
        "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        **extra,
        **{k: r[k] for k in ("old_ms", "old_kernel", "old_device_ms", "bound_f32_fma_ms",
                             "prep_ms", "device_ms", "library_device_ms", "alt_device_ms",
                             "tf32_padded_device_ms", "launch_floor_ms",
                             "cold_device_ms", "device_ms_source", "rule_kernel", "rule_ms",
                             "rule_max_abs_err", "fold_device_ms", "fold_bound_ms",
                             "plain_device_ms", "max_ulps", "share_off") if k in r},
    }


def report(kernels) -> int:
    """Fail where a row's kernel never launched on its path; else print the
    rows and the result line."""
    for k in kernels:
        if k["launches"] == 0:
            raise AssertionError(f"{k['name']}: no launch of its kernel on its path")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
