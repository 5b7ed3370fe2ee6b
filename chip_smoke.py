#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (vaw_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each reported on its own lines:
  1. device   the card's name and power limit (nvidia-smi); no card, no run.
  2. build    every CUDA kernel of the paths from vaw_torch/ops/csrc (nvcc,
              sm_90a, one process per source, all started together).
  3. kernel   the fused attention forward (the DiT's; flash_fwd.cu's TMA +
              wgmma kernel on the packed row's views in bf16, with the
              consumer warpgroups of flash_attention.flash_fwd_consumers,
              printed; f32 on flash_fwd.cu's 3xTF32 design over
              the packed row's views at or above the crossover,
              flash_attention.TF32X3_MIN_TILES score tiles, which every
              call has) against its plain PyTorch version at
              the sampling shapes and at T in {64, 256, 257, 1024} x D in
              {40, 64, 72, 128}, bf16 and f32, each counted by kernel
              (launches_by_design), with its time beside its bound, the
              plain version's time and one PyTorch library call's time; at
              REPA's teacher shape (256, 257, 12, 64) in f32 also the FMA
              kernel's time and the bytes, 3xTF32 and FMA bounds.
  3b. bwd     the fused backward against its plain version at the training
              shape (B=256, T=256, H=12, D=64) in bf16 and f32, and at T=257
              and D=128, each through the kernels its call selects (bf16
              with D <= 64: flash_bwd.cu's TMA + wgmma pair on the packed
              row's views; D = 128: flash_fused_bwd.cu's mma.sync kernels;
              f32 with D <= 64: the pair's 3xTF32 design at or above the
              crossover; f32 D = 128: its FMA kernels; counted) and
              bit-equal when repeated,
              with the same times and the old mma.sync kernels' time and
              error at the first shape; the library call is
              scaled_dot_product_attention's backward.
  3c. general the general-T forward (flash_fwd.cu; TMA + wgmma in bf16 for
              D <= 128) against its plain version: the U-ViT-L/2 sampling
              shape (B=128, T=258, H=16, D=64, q, k and v as views of one
              packed projection), Tq=77 with Tk=300, D=72, D=256, T=4096,
              LDM's (16, 1024, 8, 32) and (128, 64, 32, 32) and ADM-64's
              (16, T, H, 64) for T, H = 1024, 6; 256, 9; 64, 12, bf16 and
              f32, each through the kernel its call selects (wgmma,
              mma.sync, tf32x3 or FMA, counted), with the four times at the
              first shape and the mma.sync kernel's time and error there;
              the f32 classifier path's shapes ((4, 1024, 6, 64) and
              (4, 64, 12, 64) on packed views, the pool's (4, 65, 12, 64))
              through the kernel the crossover picks (tf32x3 at each), then
              both f32 kernels at each against the
              plain version, timed through the entry (host and device) and
              on the device alone, with SDPA's (TF32 off) and the plain
              version's times and the bounds; then,
              held against the plain version first, the kernel, the
              mma.sync kernel, SDPA and the bound at LDM's and ADM-64's
              T = 1024 shapes (B=128; 8 heads of 32, 6 heads of 64).
  3d. general bwd  the general-T backward (flash_bwd.cu; TMA + wgmma in bf16
              for D <= 80) at the same shapes (one packed gradient at the
              first), each through the kernels its call selects (counted)
              and bit-equal when repeated, with the four times and the
              mma.sync kernels' at the first shape; the same checks, then
              the times, at the two T = 1024 shapes.
  3e. p5      the d-major packed forward (flash_p5_fwd.cu, the UNet's T = 256
              attention; TMA + wgmma in bf16) against its plain version on
              [B, 3, H, D, T] at the LDM sampling shape (B=128, T=256, H=16,
              D=32), (4, 256, 9, 64), (2, 256, 8, 16) and (8, 256, 4, 128),
              bf16 and f32, each through the kernel its call selects (wgmma,
              mma.sync, tf32x3 for f32 with D <= 64 at or above the
              crossover, or FMA, counted), with the four times at the first
              shape (SDPA on q, k and v copied, untimed, to contiguous
              [B, H, T, D]) and the mma.sync kernel's time and error there.
  3f. p5 bwd  the p5 backward (flash_p5_bwd.cu, one packed dqkv; TMA + wgmma
              in bf16 and TMA + TF32 wgmma, 3xTF32, in f32 at or above the
              crossover, both for D <= 64) at the same shapes, the first at
              the LDM training batch B=256, each through the kernels its
              call selects (counted) and bit-equal when repeated, with the
              four times and the old mma.sync kernels' there.
  3g. conv    the 3x3 conv forward (conv3x3_fwd.cu) and its dgrad (the same
              kernels on the rotated filter) against the plain version at
              ADM-64's admitted shapes at the sampling batch 128 (64 px
              192->192, timed; 384->192; 32 px 384->384; 16 px 384->576; the
              3-channel stem; the f32 head 192->3), at 8 px (two images to a
              wgmma box), at (3, 12, 20, 64->128) (a box that does not
              divide the image) and (2, 16, 8, 24->16), bf16 and f32, each
              through the kernel its shape selects (wgmma, mma.sync, tf32x3
              or FMA, counted), with the kernel, plain, cuDNN and bound
              times, and the mma.sync kernel's time at the timed shape.
  3h. wgrad   the conv's filter gradient (conv3x3_wgrad.cu: split-K partials
              and their fixed-order sum; bit-equal when repeated; TMA + wgmma
              for bf16 and TMA + TF32 wgmma, 3xTF32, for f32, both with Cin
              and Cout multiples of 64) at the ADM-64
              training batch 64 (timed) and the shapes of 3g, each through
              the kernel its shape selects (counted), with the mma.sync
              kernel's time and error at the timed shape.
  3i. act     the fused bias + leaky ReLU (fused_act.cu), which no model
              calls, at (128, 64, 64, 192) bf16 and f32: values, first and
              second derivatives against the plain version through its op
              entry (its launches are counted there), and the times.
  3j. f32     the f32 calls where the f32 paths run them: the p5 forward
              and backward (tf32x3) at (4, 256, 9, 64), the forward's both
              designs at it, at LDM's (128, 256, 16, 32) and at 288, 512 and
              768 score tiles, the backward's at it, at LDM's and at 288
              tiles, bit-equal when repeated, host and device times; the
              general backward at
              the classifier's three shapes (tf32x3 at each, the crossover
              being 1 tile; both kernels at each, bit-equal when
              repeated, host and device times); the conv at (4, 64, 64,
              192->192), (64, ...) and (4, 16, 16, 576->576) (tf32x3 beside
              its FMA kernel, host and device times); the wgrad at (16, 64,
              64, 192->192) and (64, ...) (tf32x3, beside its FMA kernel); the
              fused backward at (256, 256, 12, 64) (the general pair's tf32x3
              on its packed row, beside its FMA kernels); each counted and
              against its
              plain version, with the plain, library (SDPA's backward, cuDNN
              with TF32 off) and bytes, 3xTF32 and FMA bound times.
Then, for DiT-B/2 (phases 4-7, the fused kernels), U-ViT-L/2 (phases 8-11,
the general kernels) and LDM (phases 12-15, the p5 kernels at its 16x16
level and the general ones at 32x32 and 8x8), each with seeded random
weights at full width and depth on 32x32x4 latents, and ADM-64 (phases
16-19, pixel space, 64x64x3, under VAW_PALLAS_CONV=1, set for those phases
only: the conv kernels on the 30 convs the JAX gate admits, the general
attention kernels):
  sample      the sampling path through its entry point,
              vaw_torch.cli.sample.main: 128 samples in two batches of 64,
              18 Heun EDM steps at CFG 1.5, bf16.
  model       one forward at B=128 through the kernels against the same
              forward through the plain attention (and, for ADM-64, the
              plain conv), in f32 and in the sampler's bf16 copy.
  train       the training path through its entry point,
              vaw_torch.cli.main.main, on Gaussian data with the flagship
              recipe (cosine schedule, EPSILON target, lambda weight, label
              dropout 0.1, AdamW (0.9, 0.95) with the fused AdamW+EMA, bf16
              over f32 masters), 30 steps at batch 256 (DiT, LDM), 128
              (U-ViT) or 64 (ADM-64), and a step-30 checkpoint that loads back
              with the run's EMA weights (U-ViT's learned pos_embed included).
  grad        one backward in f32 at B=32 (DiT) or 16 (U-ViT, LDM, ADM-64)
              through the kernels against the plain route, per parameter
              group; the general attention, the fused forward and
              backward and the p5 forward and backward on tf32x3 at or
              above the crossover and on FMA below, the convs, dgrads and
              wgrads with Cin and Cout multiples of 64 on tf32x3, every
              other kernel that chooses by the call on its FMA kernel
              (counted; the path ``grad_<family>``).
Then two families trained in f32 (``phase_train_f32``: --amp False through
vaw_torch.cli.main, 10 steps, a falling loss, imgs/s and peak memory):
ADM-64 under VAW_PALLAS_CONV=1 at batch 64, the path ``train_adm64_f32``:
24 tf32x3 and 2 FMA convs, 24 tf32x3 and 1 FMA dgrads, 24 tf32x3 and 2 FMA
wgrads, 22 tf32x3 general backwards a step; DiT-B/2 at
batch 256, the path ``train_dit_f32``: 12 fused forwards and 12 fused
backwards a step, all on tf32x3 (counted).
Then the slice of ViT, MM-DiT, flow matching, the loss-aware resampler
and learned variance (``phase_slice11``), each with seeded random weights at
full width and depth:
  ViT-B/2 (32x32x4 latents, 1000 classes, T = 258, 12 heads of 64, the
              general kernels through the packed entry): sample, model,
              train (30 steps at 256 under the flagship recipe with
              --time_sampler loss-second-moment, printing how many of the
              1000 history rows are warmed up) and grad, as above; 12
              general forwards and 12 backwards a step, all on wgmma.
  MM-DiT-B/2 (505M parameters, 24 joint blocks, 24 heads of 32, T = 257 over
              the one-token context and 256 patches, on 32x32x3 Shapes
              images with 10 classes): one batch of 64 (CFG 1.5) each with
              the flow SDE (Heun, 18 steps: 35 model calls), the ODE (Heun:
              34) and the adaptive dopri5 ODE (1 + 6 calls an attempt; its
              accepted and rejected steps printed), each counted exactly;
              model; 30 rectified-flow steps at 256 (--model_mode flow,
              linear path, VECTOR target, lambda weight), the mean of the
              last five losses below that of the first five; grad. 24
              general forwards and 24 backwards a step, all on wgmma.
  DiT-B/2 learned variance (--learn_sigma True --var_type LEARNED_RANGE):
              sample (the EDM sampler takes the first 4 of 8 channels;
              4-channel PNGs), train (30 steps at 256, finite vb terms) and
              8 steps under --loss_type KL; the fused kernels' counts.
Then the slice of the SD-VAE and REPA (``phase_slice12``), on seeded
weights written to a temporary directory (a diffusers-layout .bin of the
full-size SD-VAE, a timm-layout .pth of DINOv2-B/14 with its 518 px table):
  vae         the SD-VAE through vaw_torch.data.vae: encode and decode at
              64 px against the same weights on the CPU, then encode 256
              images at 256 px in f32 in chunks of 64 and decode 64 32x32x4
              latents in bf16 and f32 (bf16 finite and within 0.1 of f32,
              the bound scaled by the f32 output's magnitude above 1),
              images/s and peak memory.
  sample      DiT-B/2 sampling as in phase 4 with VAW_VAE_PATH set: 128
              decoded 256 px RGB PNGs, 840 fused launches, samples/s beside
              phase 4's without decode.
  repa        DiT-B/2 under REPA (--encoder_depth 8 --gamma 0.5, the f32
              DINOv2-B/14 teacher on 224 px) through Trainer on the VAE
              phase's moments and uint8 images, 30 steps at 256: finite
              loss and align, a falling loss, exactly 24 fused forwards (12
              the teacher's, on tf32x3) and 12 fused backwards a step,
              imgs/s, the teacher's ms a step and its attention's (CUDA
              events around each f32 call) and the peak memory; then the same
              through vaw_torch.cli.main on Shapes, align in its log.
Then the slice of evaluation, DDIM and classifier guidance
(``phase_slice13``), on seeded weights and a synthetic InceptionV3 graph
written to a temporary directory:
  inception   the 2015 graph's full topology (tests/_inception_graph.py's
              nodes, names and legacy ops, seeded weights) written with the
              port's GraphDef writer and read back by its reader: 256 64x64
              images on the card against the CPU (pool, spatial, softmax
              within 1e-4, f32, TF32 off), images/s; the 10000 x 10000 x 2048
              distance block against float64 (1e-5), its ms beside its
              bound; precision and recall from the card's distances equal to
              the CPU's (features on a 1/16 grid, so every distance is exact).
  eval        the flagship recipe through vaw_torch.cli.main with --eval
              True: DiT-B/2 20 steps at 256, then 256 samples (18 Heun EDM
              steps, CFG 1.5) decoded by the seeded SD-VAE and evaluated
              against a seeded 256 px reference npz: one metrics.csv row of
              finite IS, FID, sFID, precision and recall, the samples npz,
              1080 + 240 fused launches, the evaluation's time by stage.
  ddim        DiT-B/2 through vaw_torch.cli.sample --solver ddim over all
              DDIM_STEPS (250) steps, one batch of 64 at CFG 1.5: 3000 fused
              launches, samples/s.
  classifier  ADM-64 under VAW_PALLAS_CONV=1, --solver ddim --use_classifier
              (a seeded f32 EncoderUNet, attention pool), 50 steps, 16
              samples in batches of 4 (where the p5 gate takes nine heads of
              64): the first step's classifier gradient within 1e-3 of the
              plain kernels' (uncounted), launches of the p5, general and conv
              kernels and none of the conv filter gradient, the classifier's
              f32 general forwards and backwards by kernel (200 calls: 600
              at 32 px, 800 at 8 px and 200 in the pool, each way, all on
              tf32x3; its 600 p5 forwards and 600 p5 backwards at 16 px on
              tf32x3; its convs and dgrads mostly on tf32x3, the stem's on
              FMAs), samples/s.
Then the slice of training on more than one GPU (``phase_slice14``):
  launcher    DiT-B/2 at batch 256 with the flagship recipe, 30 steps,
              through ``python -m torch.distributed.run --standalone
              --nproc_per_node 1`` (torchrun) running vaw_torch.cli.main.main
              in this script's child mode (``--torchrun-child``, which counts
              the launches and times the steps as phase 6 does and writes
              them to a JSON file): NCCL at world 1, twice, plain data
              parallelism (the explicit gradient all-reduce) and --fsdp True
              (fully_shard): each run's imgs/s beside phase 6's, its peak
              memory, its fused launches (360 + 360, all on wgmma) and its
              step-30 loss held to phase 6's (relative 1e-3 under data
              parallelism, whose arithmetic at world 1 is phase 6's, and
              1e-2 under FSDP, whose gathered weights live in other
              buffers); the FSDP run's step-30 checkpoint sampled by
              vaw_torch.cli.sample (16 samples, 4 steps).
  tp split    one DiT-B/2 block at full width (768 wide, 12 heads of 64,
              B=32, T=256) split by parallel/partition.py's shard function
              at tp 2 and 4, each rank's shard run on B1/B2 at 6 or 3 heads
              in this process and the row-parallel partials summed, against
              the whole block, forward and gradients (x and every
              parameter), f32 (within 1e-4 of max|ref|, 1e-3 for the
              gradients) and bf16 (2e-2 and 5e-2).
Then the last module slice (``phase_slice15``):
  upfirdn2d   upsample2d, downsample2d, blur and upfirdn2d(up=2, pad=(-1, 2))
              (vaw_torch/ops/upfirdn2d.py: one depthwise cuDNN conv, no
              kernel of the port's) at StyleGAN2's (16, 64, 64, 512), f32 and
              bf16, against the same call on the CPU copy (relative to
              max|result|: 1e-5 and 1e-2), ms a call beside the bytes bound;
              one second derivative card vs CPU (1e-4).
  profiler    vaw_torch/utils/profiling.py around DiT-B/2's train step at
              256 through Trainer: trace() over 3 steps (12 + 12 fused
              launches a step, counted as the path ``train_dit_profiled``)
              and summarize_trace: the fused forward's and the backward's
              categories > 0, busy (the union of device intervals) <= span,
              the busy share beside the old figure (key_averages' CUDA
              self times summed); StepTimer
              over 10 steps within 5 % of CUDA events; compiled_flops of a
              forward at batch 8 on the card within 1 % of the CPU's count
              on the same weights, beside estimate_train_flops.
  preprocess  resize_imagenet (64 seeded JPEGs in 2 classes -> 64 px),
              preprocess_celeba (16 images at 178x218 and a partition file),
              export_lsun where lmdb imports (else one line says so), and
              compute_ref_stats on the card with the seeded InceptionV3
              graph over 4096 32x32 PNGs: the npz's keys and arr_0, its FID
              against itself < 1e-3, the wall time.
Then the attention switches and the reference readers (``phase_slice16``):
  p5 at DiT   the p5 forward (B=128) and backward (B=256) at DiT-B/2's
              T = 256, 12 heads of 64, bf16, against their plain versions
              (wgmma, counted), timed beside the plain version, SDPA (or
              its backward) and the bound.
  DiT routes  DiT-B/2 under each setting (none; VAW_FUSED_TMAJOR=0;
              with VAW_PACKED_QKV=0 too; VAW_DISABLE_FLASH=1): a bf16
              forward at B=128 against the default route's (3e-2 of
              max|out|) with exact launches (12 fused, p5, general or no
              attention kernels), then 5 train steps at 256 through Trainer
              on resident batches after one uncounted step: ms a step,
              peak memory, exact launches a path (``train_dit_<route>``).
  packed off  LDM and U-ViT-L/2 under VAW_PACKED_QKV=0: a bf16 forward at
              B=128 against the default route's, 16 and 21 general
              forwards and no p5 launch (``model_<family>_packed_qkv_0``).
  readers     ADM-64 (VAW_PALLAS_CONV=1) and ViT-B/2 with a qkv bias (its
              k part zeroed) written as a reference-layout .pth, read back
              through reference_to_torch into a model of other weights
              (strict), a bf16 forward at B=128 bit-equal to the
              original's (``reference_<family>``).
Then the XL models' attention at D = 72 (``phase_xl``):
  xl kernels  the general forward and backward pair at D = 72 (80-wide
              tiles: a 64-column and a 16-column slab) against their plain
              versions at (2, 256, 16, 72) and (2, 258, 16, 72), bf16, on a
              packed row's views through the general entries and on the
              packed projection through the fused ones: all on wgmma
              (counted), each repeat bit-equal, the fused forward equal to
              the general one.
  xl time     both at DiT-XL/2's and U-ViT-H/2's sampling shapes (B=128,
              T=256 and 258, 16 heads of 72) beside the mma.sync
              backwards these calls took before their wgmma pair, the
              plain versions, SDPA (or its backward) and the bound.
  ditxl       DiT-XL/2 at full width and depth through vaw_torch.cli.main:
              10 bf16 steps at batch 64 on Gaussian latents with the
              flagship recipe (280 + 280 fused launches, all wgmma, none on
              mma.sync; the mean of the last three losses below that of the
              first three), then 16 samples of its EMA weights from the
              18-step Heun EDM sampler at CFG 1.5 through the CLI's sampler
              (980 fused forwards, all wgmma).
  uvith       U-ViT-H/2 at full width and depth: one bf16 forward and
              backward at batch 4 through the kernels (29 + 29 general
              launches, all wgmma) against the same on VAW_DISABLE_FLASH=1.
Phase 3 also holds B1 at the teacher's shape (256, 257, 12, 64) in f32
and bf16 against its plain version, with its time, SDPA's and the bound.
Phases 3c and 3d time the general kernels at the two new shapes too:
ViT-B/2's (128, 258, 12, 64) on packed views and MM-DiT-B/2's (128, 257, 24,
32) on three tensors, beside SDPA and the bound.
Then, on seeded data written to a temporary directory:
  20. data-cifar  DiT-B/2 (3 channels, 10 classes) trained through the CLI
              on a CIFAR-10-layout archive (5 x 2048 rows and a test batch,
              seeded uint8): batches through the native gather
              (vaw_torch.runtime, at least one call a step) and the
              prefetcher, 30 steps at batch 256 with the flagship recipe,
              asynchronous checkpoints at steps 15 and 30; 360 + 360 fused
              launches, a finite loss, and the step-30 file equal to the
              final params, EMA and moments bit for bit. Then the same run
              with synchronous saves and with none: each run's ms a step
              and the time of step 16, the first after the step-15 save.
  21. async-snapshot  AsyncCheckpointWriter.save, then at once one more
              fused AdamW+EMA step on the same DiT-B/2 state: the file holds
              the state before that step, bit for bit.
  22. data-latent  where h5py imports: a 12288-item latents.h5 (8 x 32 x 32
              f32 moments, uint16 labels; the layout of vaw_tpu/data/
              preprocessing.py), DiT-B/2 trained 40 steps at batch 256
              through the slab loader (a slab boundary crossed with a carry)
              and the prefetcher: 480 + 480 fused launches, imgs/s. Without
              h5py one line says so and the phase is not run.
  23. remat   DiT-B/2's f32 gradient at batch 256 under each policy against
              the one without remat, with cuDNN held to deterministic
              algorithms (the patch conv's filter gradient): bit-equal, as
              is the gradient without remat taken twice; then through the
              CLI, bf16, 10 steps
              each: DiT-B/2 at 256 without remat and under "full" and "dots"
              (a rematted block runs its attention forward again: 240 + 120
              fused launches), U-ViT-L/2 at the recipe's 256 under "full"
              (420 + 210 general launches), and U-ViT-L/2 without remat at 128
              and at 256; the peak memory of every run.
  24. host    cli/profile_train.py's resident and loader-fed (through
              prefetch_to_device) steps of DiT-B/2 on Gaussian latents, on
              the CIFAR-10 archive and, with h5py, on the latent file.
Before each sample and train phase every kernel's launch count is set to
0; it is read just after and must be exactly the expected count for that
path's kernels (840, 360 + 360, 1470, 630 + 630; REPA 720 + 360; LDM 350
p5 + 770 general in sampling, 150 + 150 p5 and 330 + 330 general in
training; ADM-64 2100 conv + 1540 general in sampling, 1770 conv forward/dgrad + 900 wgrad and
660 + 660 general in training) and 0 for the others; the launches by
kernel of the conv forward, the wgrad, the p5 forward and backward, the
general forward and backward and the fused backward must be exact too (a
bf16 ADM-64 forward: 28 wgmma convs, the stem on mma.sync, the f32 head
on FMAs; a backward: 28 wgmma dgrads and the head's on FMAs, 28 wgmma
wgrads, the stem's on mma.sync and the head's on FMAs; every bf16 LDM p5
call on wgmma; every bf16 general forward and backward of U-ViT-L/2,
LDM and ADM-64 on wgmma: 21, 11 and 22 a forward, as many a backward;
DiT-B/2's 12 fused backwards a step on wgmma), and every grad phase's
(f32) by the f32 rules above.

A bound is the larger of two times: the bytes each function must move at
the HBM rate and its tensor-core operations at the bf16 (or f32) peak; the
term that binds is printed. At the T = 1024 shapes phases 3c and 3d also
print, beside the bound, the time of the B*H*Tq*Tk exponentials on the
special-function units alone (16 a clock on each SM at the card's maximum
SM clock, from nvidia-smi): a floor for a kernel that takes every exp2
there, not a bound of the function.

The launches of the two launcher runs are their paths' (``train_dit_ddp``,
``train_dit_fsdp``), read in the child around its run.

Exits non-zero, printing no result, without a CUDA card or if any phase
fails. Otherwise it prints the total time, one {"kernels": [...]} JSON line
(the nine kernels, then the six 3xTF32 designs, flash_fwd_tf32x3,
flash_bwd_tf32x3 (the fused backward's f32 calls counted there too),
conv3x3_wgrad_tf32x3, flash_p5_fwd_tf32x3, conv3x3_fwd_tf32x3 and
flash_p5_bwd_tf32x3, then the D = 72 wgmma kernels flash_fwd_wgmma_d72 and
flash_bwd_wgmma_d72 (the XL paths' launches, the fused entries' included),
each with its launches on the paths and its numbers at its timed shape)
and, last, {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import csv
import functools
import gc
import glob
import io
import json
import math
import os
import pickle
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, NamedTuple
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F
from PIL import Image

import vaw_torch.cli.main as train_cli
import vaw_torch.cli.sample as sample_cli
from vaw_torch.cli import profile_train
from vaw_torch.core.diffusion import GaussianDiffusion as TorchGaussianDiffusion
from vaw_torch.data import preprocessing
from vaw_torch.data.vae import load_vae, load_vae_decoder
from vaw_torch.encoders import initialize_encoders, make_teacher
from vaw_torch.evals import evaluator as eval_module
from vaw_torch.evals import fid as fid_module
from vaw_torch.evals.fid import FIDStatistics, ManifoldEstimator, pairwise_sq_distances
from vaw_torch.evals.graphdef import (
    AttrValue,
    GraphDef,
    ListValue,
    NodeDef,
    TensorShape,
    serialize_graph_def,
    tensor_proto,
)
from vaw_torch.evals.inception import InceptionV3GraphFeatures
from vaw_torch.models import build_model, cast_for_compute
from vaw_torch.models import layers as model_layers
from vaw_torch.models import mmdit as mmdit_module
from vaw_torch.models import unet as unet_module
from vaw_torch.models import uvit as uvit_module
from vaw_torch.models import vit as vit_module
from vaw_torch.models.convert import _legacy_qkv_perm, reference_to_torch
from vaw_torch.models.dit import DiT_B
from vaw_torch.models.mmdit import MMDiT
from vaw_torch.models.layers import REMAT_POLICIES
from vaw_torch.models.unet import ADM_64, LDM
from vaw_torch.models.vae import AutoencoderKL
from vaw_torch.models.uvit import UViT_H, UViT_L
from vaw_torch.models.vit import ViT_B
from vaw_torch.ops import _build
from vaw_torch.ops import conv2d as conv_ops
from vaw_torch.ops import flash_attention as flash_ops
from vaw_torch.ops import upfirdn2d as upfirdn_ops
from vaw_torch.ops.conv2d import (
    CONV_DESIGNS,
    conv3x3_design,
    conv3x3_pallas,
    conv3x3_reference,
    conv3x3_tf32x3_tiling,
    conv3x3_wgrad_design,
    conv3x3_wgrad_pallas,
    conv3x3_wgrad_plan,
    conv3x3_wgrad_reference,
)
from vaw_torch.ops.flash_attention import (
    KERNEL_DESIGNS,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_reference,
    flash_attention_fwd,
    flash_attention_fused,
    flash_attention_fused_bwd,
    flash_attention_fused_bwd_reference,
    flash_attention_fused_reference,
    flash_attention_p5,
    flash_attention_p5_bwd,
    flash_attention_p5_bwd_reference,
    flash_attention_p5_fwd,
    flash_attention_p5_reference,
    flash_attention_reference,
    flash_bwd_design,
    flash_fused_bwd_design,
    flash_fused_fwd_design,
    flash_fwd_design,
    flash_p5_bwd_design,
    flash_p5_fwd_design,
    score_tiles,
)
from vaw_torch.ops.flash_attention import P5_TF32X3_MIN_TILES, TF32X3_MIN_TILES
from vaw_torch.ops.fused_act import fused_leaky_relu, fused_leaky_relu_reference
from vaw_torch.runtime import native
from vaw_torch.samplers import classifier as classifier_module
from vaw_torch.samplers import driver as sampler_driver
from vaw_torch.train import AsyncCheckpointWriter, Trainer, checkpoint_name, load_checkpoint
from vaw_torch.train import trainer as trainer_module
from vaw_torch.utils import profiling

# H100 SXM peaks (NVIDIA data sheet): HBM rate, dense bf16 tensor-core rate
# and the f32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# The dense TF32 tensor-core rate: the 3xTF32 f32 design runs three TF32
# passes of each product at it.
TF32_FLOPS = 495e12

# DiT-B/2's attention on 32x32x4 latents: T = 256 tokens, 12 heads of 64;
# sampling batches of 64 samples (128 rows with CFG), 18 Heun steps.
SAMPLE_SIZE, NUM_SAMPLES, STEPS = 64, 128, 18
B_MAIN, T_MAIN, H_MAIN, D_MAIN = 2 * SAMPLE_SIZE, 256, 12, 64

# REPA's frozen DINOv2-B/14 teacher at 224 px: T = 256 patches + cls, 12
# heads of 64, f32, forward only, at the training batch 256.
TEACHER_SHAPE = (256, 257, 12, 64)

# Further fused-forward checks at B=4, H=4: every T with every D.
FUSED_T = (64, 256, 257, 1024)
FUSED_D = (40, 64, 72, 128)

# Kernel against its plain version on the same inputs: f32 differs only in
# summation order and exp2f; bf16 output is one rounding of |o| < 2.
ATOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}
LSE_ATOL = 1e-4
# bf16 model forward against the f32 plain forward, relative to max|out|.
MODEL_BF16_RTOL = 3e-2
MODEL_F32_RTOL = 1e-4
# Backward kernel against its plain version, relative to max|grad|: f32
# differs in summation order and exp2f; bf16 rounds P and dS to bf16 (one
# term in the general wgmma pair, flash_bwd.cu:kBwdTerms; hi + lo, about
# 16 bits, in the p5 pair and in the mma.sync kernels) and
# each gradient once to bf16.
BWD_RTOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# The wgmma kernels take P and dS as one bf16 term: each output's (o; dq,
# dk, dv over max|grad|) root mean square error against the f32 plain
# version on the same bf16 inputs is at most this many times SDPA's on
# those inputs. Over the models' shapes and eight draws one term read
# 0.991-1.004 times SDPA's, hi + lo's gradients 0.705-0.724; the max
# error's ratio, mostly the outputs' own rounding, reached 1.71 for one
# term and 1.36 for hi + lo (PERF.md, the design gate).
SDPA_ERR_RATIO = 1.5
# Model gradient through the kernels against the plain attention route,
# f32, relative to each parameter group's max|grad|.
GRAD_F32_RTOL = 1e-4

# Training phases: the flagship recipe for 30 steps, the first five warm-up.
TRAIN_STEPS, TRAIN_WARMUP = 30, 5
DIT_TRAIN_BATCH = 256
# General-T kernel checks: (B, Tq, Tk, H, D); the first is the U-ViT-L/2
# sampling shape, timed, with q, k and v read as views of one packed qkv.
# Then LDM's 32x32 level (T = 1024, 8 heads of 32) at a cut batch and its
# 8x8 level (T = 64, 32 heads of 32), and ADM-64's 32, 16 and 8 px levels
# (T = 1024, 256 and 64 with 6, 9 and 12 heads of 64) at a cut batch.
GENERAL_SHAPES = [(2 * SAMPLE_SIZE, 258, 258, 16, 64), (16, 77, 300, 16, 64),
                  (16, 258, 258, 12, 72), (8, 258, 258, 4, 256),
                  (2, 4096, 4096, 2, 64), (16, 1024, 1024, 8, 32),
                  (2 * SAMPLE_SIZE, 64, 64, 32, 32), (16, 1024, 1024, 6, 64),
                  (16, 256, 256, 9, 64), (16, 64, 64, 12, 64)]
# The general kernels' model shapes at T = 1024 at the sampling batch, held
# against the plain version and timed: LDM's 32x32 level and ADM-64's 32 px
# level (6 heads of 64), q, k and v views of one packed qkv.
# Then the two shapes the ViT-B/2 and MM-DiT-B/2 paths add, at the sampling
# batch: ViT-B/2's T = 258 (256 patches, a time and a class token) with 12
# heads of 64 on the packed views, and MM-DiT-B/2's T = 257 (a one-token
# context and 256 patches) with 24 heads of 32 on q, k and v concatenated
# from the two streams (three tensors, not views). Each entry: (B, Tq, Tk,
# H, D, packed).
GENERAL_T1024 = [(2 * SAMPLE_SIZE, 1024, 1024, 8, 32, True),
                 (2 * SAMPLE_SIZE, 1024, 1024, 6, 64, True),
                 (2 * SAMPLE_SIZE, 258, 258, 12, 64, True),
                 (2 * SAMPLE_SIZE, 257, 257, 24, 32, False)]

# p5 kernel checks: (B, T, H, D) on [B, 3, H, D, T]; the first is the LDM
# shape (16x16 level, 16 heads of 32), timed at the sampling batch (128 rows
# with CFG) in the forward and the training batch in the backward.
LDM_TRAIN_BATCH = 256
P5_SHAPES = [(2 * SAMPLE_SIZE, 256, 16, 32), (4, 256, 9, 64), (2, 256, 8, 16),
             (8, 256, 4, 128)]
P5_BWD_SHAPES = [(LDM_TRAIN_BATCH, 256, 16, 32)] + P5_SHAPES[1:]

# Conv kernel checks: (N, H, W, Cin, Cout, dtypes). The first is ADM-64's
# 64x64 level at the sampling batch (128 rows with CFG), timed; then its
# other admitted shapes (the 64 px skip concat, 32 and 16 px, the stem on
# the image and the f32 head) and the shape of tests/test_ops.py:190.
BOTH = (torch.bfloat16, torch.float32)
CONV_SHAPES = [(2 * SAMPLE_SIZE, 64, 64, 192, 192, BOTH),
               (2 * SAMPLE_SIZE, 64, 64, 384, 192, BOTH),
               (2 * SAMPLE_SIZE, 32, 32, 384, 384, BOTH),
               (2 * SAMPLE_SIZE, 16, 16, 384, 576, BOTH),
               (2 * SAMPLE_SIZE, 64, 64, 3, 192, BOTH),
               (2 * SAMPLE_SIZE, 64, 64, 192, 3, (torch.float32,)),
               (2 * SAMPLE_SIZE, 8, 8, 768, 768, BOTH),
               (3, 12, 20, 64, 128, BOTH),
               (2, 16, 8, 24, 16, BOTH)]
# The wgrad at ADM-64's training batch first (timed), then the same shapes.
ADM_TRAIN_BATCH = 64
WGRAD_SHAPES = [(ADM_TRAIN_BATCH, 64, 64, 192, 192, BOTH)] + [
    s for s in CONV_SHAPES[1:] if s[1] != 8]
# Conv kernel against its plain version, relative to max|result|: both sum
# exact products in f32 (bf16 values multiply exactly) in another order;
# bf16 results may then round one step apart. The wgrad sums up to 524288
# products an element.
CONV_RTOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
WGRAD_RTOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# Fused bias + leaky ReLU: ADM-64's widest 64 px activation at the sampling
# batch.
ACT_SHAPE = (2 * SAMPLE_SIZE, 64, 64, 192)

# Each kernel's launch counter, by the kernel's name in the result line.
COUNTERS = {"flash_fused_fwd": flash_attention_fused,
            "flash_fused_bwd": flash_attention_fused_bwd,
            "flash_fwd": flash_attention, "flash_bwd": flash_attention_bwd,
            "flash_p5_fwd": flash_attention_p5, "flash_p5_bwd": flash_attention_p5_bwd,
            "conv3x3_fwd": conv3x3_pallas, "conv3x3_wgrad": conv3x3_wgrad_pallas,
            "fused_act": fused_leaky_relu}
# The kernels whose wrappers choose among several kernels by shape, and
# count their launches by kernel (``launches_by_design``).
DESIGNS = {"conv3x3_fwd": CONV_DESIGNS, "conv3x3_wgrad": CONV_DESIGNS,
           "flash_p5_fwd": KERNEL_DESIGNS, "flash_p5_bwd": KERNEL_DESIGNS,
           "flash_fwd": KERNEL_DESIGNS, "flash_bwd": KERNEL_DESIGNS,
           "flash_fused_fwd": KERNEL_DESIGNS, "flash_fused_bwd": KERNEL_DESIGNS}


def reset_launches():
    for fn in COUNTERS.values():
        fn.launches = 0
    for name, designs in DESIGNS.items():
        COUNTERS[name].launches_by_design = dict.fromkeys(designs, 0)


def read_launches() -> dict:
    return {name: fn.launches for name, fn in COUNTERS.items()}


def read_designs() -> dict:
    """Launches by kernel (wgmma, mma_sync, fma, tf32x3) of the conv
    forward, the wgrad, the p5 forward and backward, the general forward and
    backward and the fused forward and backward."""
    return {name: dict(COUNTERS[name].launches_by_design) for name in DESIGNS}


def check(ok: bool, what: str):
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


@functools.cache
def exp_rate() -> float:
    """Exponentials a second on the special-function units alone: 16 ex2 a
    clock on each SM at the card's maximum SM clock."""
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return 16 * sms * float(mhz) * 1e6


def sfu_exp_ms(b, tq, tk, h) -> float:
    """Time of attention's B*H*Tq*Tk exponentials on the special-function
    units alone: a floor for a kernel that takes every exp2 there, not for
    the function (exp2 also runs as a polynomial on the FMA pipes), so it is
    printed beside the bound and not in it."""
    return b * h * tq * tk / exp_rate() * 1e3


def attention_bound_ms(b, tq, tk, h, d, dtype) -> tuple[float, str]:
    """Least time for one forward: q, k and v read once, o and lse written
    once, or the 4*B*H*Tq*Tk*D score and P.V operations at the dtype's
    peak."""
    elt = torch.finfo(dtype).bits // 8
    nbytes = (2 * b * tq * h * d + 2 * b * tk * h * d) * elt + b * h * tq * 4
    flops = 4 * b * h * tq * tk * d
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops else "operations")


def attention_bwd_bound_ms(b, tq, tk, h, d, dtype) -> tuple[float, str]:
    """Least time for one backward: q, k, v, o, dout and lse read once and
    dq, dk, dv written once, or the 10*B*H*Tq*Tk*D operations of its five
    products at the dtype's peak."""
    elt = torch.finfo(dtype).bits // 8
    nbytes = (4 * b * tq * h * d + 4 * b * tk * h * d) * elt + b * h * tq * 4
    flops = 10 * b * h * tq * tk * d
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops else "operations")


def f32_bounds(nbytes: float, flops: float) -> dict:
    """An f32 function's least times: its bytes (each input read once, each
    output written once) at the HBM rate, its operations as the 3xTF32
    design runs them (three TF32 passes at the tensor cores' peak) and as
    plain f32 FMAs. The bound is the larger of the first two."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    tf32x3 = 3 * flops / TF32_FLOPS * 1e3
    return dict(bound_ms=max(by_bytes, tf32x3),
                bound_by="bytes" if by_bytes >= tf32x3 else "operations",
                bytes_ms=by_bytes, tf32x3_ops_ms=tf32x3,
                fma_ops_ms=flops / PEAK_FLOPS[torch.float32] * 1e3)


def attention_f32_bounds(b, tq, tk, h, d) -> dict:
    """``f32_bounds`` of one f32 attention forward: q, k, v read, o and lse
    written; 4*B*H*Tq*Tk*D operations."""
    nbytes = (2 * b * tq * h * d + 2 * b * tk * h * d) * 4 + b * h * tq * 4
    return f32_bounds(nbytes, 4 * b * h * tq * tk * d)


def _bounds_text(bounds: dict) -> str:
    return (f"bound {bounds['bound_ms']:.4f} ms ({bounds['bound_by']}; bytes "
            f"{bounds['bytes_ms']:.4f}, 3xTF32 operations {bounds['tf32x3_ops_ms']:.4f}, "
            f"FMA operations {bounds['fma_ops_ms']:.4f})")


def device_ms(fn, iters: int = 20) -> float:
    """The device's time a call, without the host's: the card first sleeps
    (about 15 ms at the H100's clock) while the host queues `iters` calls,
    then runs them back to back between two events. cuda_ms times the same
    calls as the host issues them, which for a small call is the host's
    time."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(int(3e7))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fn, iters: int = 50) -> float:
    """The host's µs a call: time.perf_counter over `iters` calls queued
    while the card sleeps (about 50 ms at the H100's clock), so that no
    queue back-pressure is counted. A call whose device time is below this
    runs at this pace as issued (cuda_ms)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(1e8))
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    spent = time.perf_counter() - t0
    torch.cuda.synchronize()
    return spent / iters * 1e6


# The crossover of the f32 designs set far above any call: every f32 call
# goes to the FMA kernels.
FMA_ONLY = 1 << 62


@contextlib.contextmanager
def min_tiles(n: int):
    """The f32 crossovers (flash_attention.TF32X3_MIN_TILES and the p5
    forward's P5_TF32X3_MIN_TILES) set to `n` while a comparison runs: 0
    sends every f32 call the entries admit (D, scale and views permitting)
    to the 3xTF32 designs, FMA_ONLY to the FMA kernels."""
    old = flash_ops.TF32X3_MIN_TILES, flash_ops.P5_TF32X3_MIN_TILES
    flash_ops.TF32X3_MIN_TILES = flash_ops.P5_TF32X3_MIN_TILES = n
    try:
        yield
    finally:
        flash_ops.TF32X3_MIN_TILES, flash_ops.P5_TF32X3_MIN_TILES = old


def f32_rule(b: int, tq: int, tk: int, h: int, least: int = TF32X3_MIN_TILES) -> str:
    """The kernel an f32 general or fused call (or, with `least` the p5
    forward's P5_TF32X3_MIN_TILES, a p5 forward) with D <= 64 and scale > 0
    on mapped views takes: tf32x3 at or above the crossover's score tiles,
    FMA below."""
    return "tf32x3" if score_tiles(b, tq, tk, h) >= least else "fma"


def attention_errors(q, k, v, o, dout=None, grads=None) -> tuple[dict, dict, tuple]:
    """Errors against the f32 plain version on the same bf16 inputs (upcast)
    of the kernel's o and, given dout and the kernel's (dq, dk, dv), of each
    gradient over its max|grad|; and of SDPA's output and gradients on the
    same q, k and v ([B, T, H, D] views throughout). Each output's is its
    max abs error and its root mean square error ("max", "rms"). Returns
    (kernel's, SDPA's, the plain (o, lse) in f32)."""
    def error(x, want, top=1.0) -> dict:
        e = (x.float() - want).div_(top)
        return {"max": e.abs().max().item(), "rms": e.square().mean().sqrt().item()}

    qf, kf, vf = (x.float() for x in (q, k, v))
    ro, rlse = flash_attention_reference(qf, kf, vf)
    kernel = {"o": error(o, ro)}
    leaves = [x.detach().requires_grad_(dout is not None) for x in (q, k, v)]
    qh, kh, vh = (x.transpose(1, 2) for x in leaves)
    so = F.scaled_dot_product_attention(qh, kh, vh)
    sdpa = {"o": error(so.transpose(1, 2), ro)}
    if dout is not None:
        want = flash_attention_bwd_reference(qf, kf, vf, ro, rlse, dout.float())
        sg = torch.autograd.grad(so, (qh, kh, vh), dout.transpose(1, 2))
        for name, x, s, w in zip(("dq", "dk", "dv"), grads, sg, want):
            top = w.abs().max().item()
            kernel[name] = error(x, w, top)
            sdpa[name] = error(s.transpose(1, 2), w, top)
        del want, sg
    del qf, kf, vf, leaves, so
    return kernel, sdpa, (ro, rlse)


def check_gate(tag: str, kernel: dict, sdpa: dict) -> dict:
    """Prints the kernel's errors beside SDPA's and fails on a root mean
    square error above SDPA_ERR_RATIO times SDPA's (the max, printed
    beside, is mostly the output's own bf16 rounding and moves with the
    draw)."""
    print(f"[gate] {tag}: error against the f32 plain version, max (rms): " + ", ".join(
        f"{name} {kernel[name]['max']:.3e} ({kernel[name]['rms']:.3e}), sdpa "
        f"{sdpa[name]['max']:.3e} ({sdpa[name]['rms']:.3e}), "
        f"{kernel[name]['max'] / sdpa[name]['max']:.2f}x "
        f"({kernel[name]['rms'] / sdpa[name]['rms']:.2f}x)" for name in sdpa), flush=True)
    for name in sdpa:
        check(kernel[name]["rms"] <= SDPA_ERR_RATIO * sdpa[name]["rms"],
              f"{tag}: {name} rms error {kernel[name]['rms']:.3e} above "
              f"{SDPA_ERR_RATIO} x SDPA's {sdpa[name]['rms']:.3e}")
    return dict(err=kernel, sdpa_err=sdpa)


def phase_device() -> str:
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card)
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"on {torch.cuda.get_device_name(0)}", flush=True)
    return card


# The template arguments of each 3xTF32 kernel and of the general attention's
# bf16 wgmma kernels, for phase 2's lines.
KERNEL_ARGS = {"flash_fwd_tf32x3": "DP, NWG, KT, NS, q in registers",
               "flash_bwd_dq_tf32x3": "DP, NS", "flash_bwd_dkdv_tf32x3": "DP, NS",
               "conv3x3_wgrad_tf32x3": "BN, NS", "conv3x3_fwd_tf32x3": "BN, NS",
               "flash_p5_bwd_dq_tf32x3": "DP, NS", "flash_p5_bwd_dkdv_tf32x3": "DP, NS",
               "flash_fwd_wgmma": "DP, NWG, KT, NS", "flash_bwd_dq_wgmma": "DP, NS",
               "flash_bwd_dkdv_wgmma": "DP, NS", "flash_p5_bwd_dq_wgmma": "DP, NS",
               "flash_p5_bwd_dkdv_wgmma": "DP, NS"}


def phase_build():
    t0 = time.perf_counter()
    logs = _build.build()
    seconds = time.perf_counter() - t0
    for name in _build.KERNEL_SOURCES:
        log = logs.get(name, "")  # empty when the library was already built
        registers = [int(n) for n in re.findall(r"Used (\d+) registers", log)]
        spills = sum(int(n) for n in re.findall(r"(\d+) bytes spill stores", log))
        print(f"[build] {name}: {_build.library_path(name).name}, "
              f"{len(registers)} kernel instantiations, registers per thread "
              f"{registers}, spill stores {spills} bytes")
        # The 3xTF32 kernels' and the general attention's wgmma kernels'
        # instantiations one by one (the launch count; setmaxnreg moves them
        # between their warpgroups).
        for entry in log.split("Compiling entry function")[1:]:
            kernel = re.search(r"((?:flash_fwd|flash_bwd_dq|flash_bwd_dkdv|conv3x3_wgrad|"
                               r"conv3x3_fwd|flash_p5_bwd_dq|flash_p5_bwd_dkdv)_tf32x3|"
                               r"(?:flash_fwd|flash_bwd_dq|flash_bwd_dkdv|flash_p5_bwd_dq|"
                               r"flash_p5_bwd_dkdv)_wgmma)I(\w+?)EEv",
                               entry)
            if kernel:
                args = ", ".join(re.findall(r"L[ib](\d+)E", kernel.group(2)))
                used = re.search(r"Used (\d+) registers", entry).group(1)
                spilled = re.search(r"(\d+) bytes spill stores", entry).group(1)
                print(f"[build]   {kernel.group(1)}<{args}> ({KERNEL_ARGS[kernel.group(1)]}): "
                      f"{used} registers at launch, {spilled} bytes spill stores")
    print(f"[build] {len(_build.KERNEL_SOURCES)} kernel source(s) in "
          f"{seconds:.1f} s", flush=True)


def phase_kernel(card: str) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    main_record = None
    teacher = {}
    shapes = [(B_MAIN, T_MAIN, H_MAIN, D_MAIN), (16, 257, 12, 64), TEACHER_SHAPE] + [
        (4, t, 4, d) for t in FUSED_T for d in FUSED_D]
    for (b, t, h, d) in shapes:
        for dtype in (torch.bfloat16, torch.float32):
            qkv = torch.randn((b, t, 3 * h * d), generator=gen,
                              device="cuda").to(dtype)
            before = read_designs()
            o, lse = flash_attention_fused(qkv, h)
            torch.cuda.synchronize()
            design = flash_fused_fwd_design(dtype, d, 1.0 / math.sqrt(d),
                                            qkv.view(b, t, 3, h, d).unbind(2))
            tag = f"B={b} T={t} H={h} D={d} {str(dtype)[6:]}"
            used = _used("flash_fused_fwd", before)
            check(used == {design: 1}, f"{tag}: fused forward launches by kernel {used}, "
                  f"expected { {design: 1} }")
            check(design == (f32_rule(b, t, t, h) if dtype == torch.float32 else "wgmma"),
                  f"{tag}: design {design}")
            ro, rlse = flash_attention_fused_reference(qkv, h)
            err = (o.float() - ro.float()).abs().max().item()
            lse_err = (lse - rlse).abs().max().item()
            kernel = design
            if design == "wgmma":
                kernel += f" ({_fused_consumers(qkv, h)} consumer warpgroups)"
            print(f"[kernel] {tag}: kernel {kernel}; max|o - plain| {err:.3e} (tol "
                  f"{ATOL[dtype]:.0e}), max|lse - plain| {lse_err:.3e} (tol "
                  f"{LSE_ATOL:.0e})", flush=True)
            check(torch.isfinite(o.float()).all().item(), f"{tag}: non-finite output")
            check(err <= ATOL[dtype] and lse_err <= LSE_ATOL, f"{tag}: kernel disagrees")
            if (b, t, h, d) == TEACHER_SHAPE:
                teacher[str(dtype)[6:]] = _time_fused(card, tag, qkv, h, err, iters=10)
                continue
            if (b, t, dtype) != (B_MAIN, T_MAIN, torch.bfloat16):
                continue
            gate = check_gate(tag, *attention_errors(
                *qkv.view(b, t, 3, h, d).unbind(2), o.view(b, t, h, d))[:2])
            ms = cuda_ms(lambda: flash_attention_fused(qkv, h), iters=50)
            plain_ms = cuda_ms(lambda: flash_attention_fused_reference(qkv, h), iters=10)
            q, k, v = qkv.view(b, t, 3, h, d).permute(2, 0, 3, 1, 4).unbind(0)
            library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), iters=50)
            bound_ms, bound_by = attention_bound_ms(b, t, t, h, d, dtype)
            print(f"[kernel] {tag}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"sdpa {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); "
                  f"kernel / sdpa {ms / library_ms:.3f} [{card}]", flush=True)
            main_record = dict(
                name="flash_fused_fwd", route="cuda",
                source="vaw_torch/ops/csrc/flash_fwd.cu",
                replaces="vaw_tpu/ops/flash_attention.py:570",
                launches=None, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms, gate=gate)
    main_record["teacher_shape"] = dict(zip(("B", "T", "H", "D"), TEACHER_SHAPE),
                                        **teacher)
    return main_record


def _fused_consumers(qkv, h: int) -> int:
    """The consumer warpgroups of the wgmma forward that a bf16 fused call
    on qkv ran: its plan's (flash_attention._fwd_tail)."""
    b, t, hd3 = qkv.shape
    plan = flash_ops._fused_fwd_plan(qkv, h, 1.0)
    check(plan.design == "wgmma", f"B={b} T={t}: fused plan {plan.design}")
    return plan.tail[0]


def _fma_fused(qkv, h: int):
    """The fused forward's f32 FMA kernel (flash_fused_fwd.cu) on a call the
    router sends to tf32x3: its time and error beside the 3xTF32 design's.
    Not counted (it is no launch of a path)."""
    b, t, hd3 = qkv.shape
    d = hd3 // (3 * h)
    out = torch.empty((b, t, h * d), device=qkv.device)
    lse = torch.empty((b * h, t), device=qkv.device)
    err = flash_ops._fwd_kernel()(qkv.data_ptr(), out.data_ptr(), lse.data_ptr(), b, t, h,
                                  d, 1.0 / math.sqrt(d),
                                  torch.cuda.current_stream().cuda_stream)
    check(err == 0, f"FMA fused forward launch failed: CUDA error {err}")
    return out, lse


def _time_fused(card: str, tag: str, qkv, h: int, err: float, iters: int) -> dict:
    """The fused forward's, its plain version's and SDPA's times on one
    packed projection, beside the bound; in f32 also the FMA kernel's time
    (and error) and the bytes, 3xTF32 and FMA bounds. SDPA runs with TF32
    off (torch.backends as main() sets them). A dict for the result line."""
    b, t, hd3 = qkv.shape
    d = hd3 // (3 * h)
    ms = cuda_ms(lambda: flash_attention_fused(qkv, h), iters=iters)
    plain_ms = cuda_ms(lambda: flash_attention_fused_reference(qkv, h), iters=3)
    q, k, v = qkv.view(b, t, 3, h, d).permute(2, 0, 3, 1, 4).unbind(0)
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on for matmuls")
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), iters=iters)
    bound_ms, bound_by = attention_bound_ms(b, t, t, h, d, qkv.dtype)
    record = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                  bound_ms=bound_ms, bound_by=bound_by)
    text = f"bound {bound_ms:.4f} ms ({bound_by})"
    if qkv.dtype == torch.float32:
        ro, rlse = flash_attention_fused_reference(qkv, h)
        fo, flse = _fma_fused(qkv, h)
        fma_err = (fo - ro).abs().max().item()
        check(fma_err <= ATOL[qkv.dtype] and (flse - rlse).abs().max().item() <= LSE_ATOL,
              f"{tag}: the FMA fused forward disagrees")
        del ro, rlse, fo, flse
        fma_ms = cuda_ms(lambda: _fma_fused(qkv, h), iters=3)
        # The same call at T - 1, whose query rows fill whole work items
        # (T = 257 leaves one row for a last item of each (b, h)).
        short = qkv[:, :t - 1].contiguous()
        short_ms = cuda_ms(lambda: flash_attention_fused(short, h), iters=iters)
        del short
        record.update(attention_f32_bounds(b, t, t, h, d), design="tf32x3", fma_ms=fma_ms,
                      fma_max_abs_err=fma_err, t_minus_1_ms=short_ms)
        text = (f"FMA kernel {fma_ms:.4f} ms (max|o - plain| {fma_err:.3e}), kernel at "
                f"T = {t - 1} {short_ms:.4f} ms, " + _bounds_text(record))
    print(f"[kernel] {tag}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"sdpa {library_ms:.4f} ms, {text}; kernel / sdpa {ms / library_ms:.3f} [{card}]",
          flush=True)
    return record


# Fused backward checks: (B, T, H, D); the first is DiT-B/2's training
# shape, timed.
FUSED_BWD_SHAPES = [(DIT_TRAIN_BATCH, T_MAIN, H_MAIN, D_MAIN), (16, 257, 12, 64),
                    (16, 256, 6, 128)]


def _expected_design(dtype, d: int, f32: str = "fma") -> str:
    """The kernel a fused or p5 backward with the default scale must take:
    wgmma for bf16 (every admitted D, up to 128); in f32 `f32` for D <= 64
    (the fused backward's: the crossover's pick), FMA above."""
    if dtype == torch.float32:
        return f32 if d <= 64 else "fma"
    return "wgmma"


def _fused_kernels_bwd(qkv, o, lse, dout, h):
    """The kernels of flash_fused_bwd.cu (delta, dK/dV, dQ; mma.sync in bf16,
    FMA in f32) on a call the router sends to the general pair (wgmma in
    bf16, tf32x3 in f32): their time and error beside the pair's. Not
    counted (it is no launch of a path)."""
    b, t, hd3 = qkv.shape
    d = hd3 // (3 * h)
    dqkv = torch.empty_like(qkv)
    delta = torch.empty((b * h, t), dtype=torch.float32, device=qkv.device)
    err = flash_ops._bwd_kernel()(
        qkv.data_ptr(), o.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dqkv.data_ptr(), b, t, h, d, 1.0 / math.sqrt(d), int(qkv.dtype == torch.bfloat16),
        torch.cuda.current_stream().cuda_stream)
    check(err == 0, f"fused backward kernels' launch failed: CUDA error {err}")
    return dqkv


def phase_bwd(card: str) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(2)
    main_record = None
    for i, (b, t, h, d) in enumerate(FUSED_BWD_SHAPES):
        for dtype in (torch.bfloat16, torch.float32):
            qkv = torch.randn((b, t, 3 * h * d), generator=gen, device="cuda").to(dtype)
            dout = torch.randn((b, t, h * d), generator=gen, device="cuda").to(dtype)
            o, lse = flash_attention_fused(qkv, h)
            before = read_designs()
            dqkv = flash_attention_fused_bwd(qkv, o, lse, dout, h)
            again = flash_attention_fused_bwd(qkv, o, lse, dout, h)
            torch.cuda.synchronize()
            views = qkv.view(b, t, 3, h, d).unbind(2)
            design = flash_fused_bwd_design(dtype, d, 1.0 / math.sqrt(d), views * 2)
            tag = f"B={b} T={t} H={h} D={d} {str(dtype)[6:]}"
            check(design == _expected_design(dtype, d, f32_rule(b, t, t, h)),
                  f"{tag}: design {design}")
            used = _used("flash_fused_bwd", before)
            check(used == {design: 2}, f"{tag}: fused backward launches by kernel {used}, "
                  f"expected { {design: 2} }")
            check(_used("flash_bwd", before) == {}, f"{tag}: counted under flash_bwd")
            same = torch.equal(dqkv, again)
            check(same, f"{tag}: a repeated fused backward is not bit-equal")
            del again
            want = flash_attention_fused_bwd_reference(qkv, o, lse, dout, h)
            scale = want.float().abs().max().item()
            err = (dqkv.float() - want.float()).abs().max().item()
            print(f"[bwd] {tag}: kernel {design}; max|dqkv - plain| {err:.3e} = "
                  f"{err / scale:.3e} of max|dqkv| {scale:.3f} (tol "
                  f"{BWD_RTOL[dtype]:.0e}); repeat bit-equal {same}", flush=True)
            check(torch.isfinite(dqkv.float()).all().item(), f"{tag}: non-finite dqkv")
            check(err <= BWD_RTOL[dtype] * scale, f"{tag}: backward kernel disagrees")
            if i != 0 or dtype != torch.bfloat16:
                del want
                continue
            gate = check_gate(tag, *attention_errors(
                *qkv.view(b, t, 3, h, d).unbind(2), o.view(b, t, h, d), dout.view(b, t, h, d),
                dqkv.view(b, t, 3, h, d).unbind(2))[:2])
            old = _fused_kernels_bwd(qkv, o, lse, dout, h)
            old_rel = (old.float() - want.float()).abs().max().item() / scale
            del want, old
            check(old_rel <= BWD_RTOL[dtype], f"{tag}: the mma.sync fused backward disagrees")
            ms = cuda_ms(lambda: flash_attention_fused_bwd(qkv, o, lse, dout, h), iters=20)
            mma_sync_ms = cuda_ms(lambda: _fused_kernels_bwd(qkv, o, lse, dout, h),
                                  iters=20)
            plain_ms = cuda_ms(lambda: flash_attention_fused_bwd_reference(
                qkv, o, lse, dout, h), iters=3, warmup=1)
            # SDPA's backward on the same q/k/v views, from a retained graph.
            leaf = qkv.detach().requires_grad_(True)
            q, k, v = leaf.view(b, t, 3, h, d).permute(2, 0, 3, 1, 4).unbind(0)
            sdpa_out = F.scaled_dot_product_attention(q, k, v)
            g4 = dout.view(b, t, h, d).transpose(1, 2)
            library_ms = cuda_ms(lambda: torch.autograd.grad(
                sdpa_out, (q, k, v), g4, retain_graph=True), iters=20)
            del leaf, q, k, v, sdpa_out
            bound_ms, bound_by = attention_bwd_bound_ms(b, t, t, h, d, dtype)
            print(f"[bwd] {tag}: kernel ({design}) {ms:.4f} ms, mma.sync kernels "
                  f"{mma_sync_ms:.4f} ms (max rel err {old_rel:.3e}), plain {plain_ms:.4f} "
                  f"ms, sdpa backward {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
                  f"({bound_by}); kernel / sdpa {ms / library_ms:.3f} [{card}]", flush=True)
            # The DiT's backward runs flash_bwd.cu's wgmma pair.
            main_record = dict(
                name="flash_fused_bwd", route="cuda",
                source="vaw_torch/ops/csrc/flash_bwd.cu",
                replaces="vaw_tpu/ops/flash_attention.py:592",
                launches=None, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
                mma_sync_ms=mma_sync_ms, gate=gate)
    return main_record


def _general_inputs(gen, b, tq, tk, h, d, dtype, packed):
    """q [B, Tq, H, D], k and v [B, Tk, H, D] on the card; with `packed`
    (Tq == Tk) the three views of one [B, T, 3, H, D] projection."""
    if packed:
        qkv = torch.randn((b, tq, 3, h, d), generator=gen, device="cuda").to(dtype)
        return qkv, qkv.unbind(2)
    q = torch.randn((b, tq, h, d), generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn((b, tk, h, d), generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    return None, (q, k, v)


def _mma_sync_general(q, k, v):
    """The kernel of flash_fwd.cu without TMA (mma.sync in bf16, FMAs in
    f32) on a call the router sends to wgmma or tf32x3: its time and error
    beside theirs. Not counted (it is no launch of a path)."""
    b, tq, h, d = q.shape
    out = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, tq), dtype=torch.float32, device=q.device)
    err = flash_ops._general_fwd_kernel()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        flash_ops._strides(q, k, v), b, tq, k.shape[1], h, d, 1.0 / math.sqrt(d),
        int(q.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream)
    check(err == 0, f"general forward (no TMA) launch failed: CUDA error {err}")
    return out, lse


def _mma_sync_general_bwd(q, k, v, o, lse, dout, grads):
    """The bf16 mma.sync kernels of flash_bwd.cu (delta, dK/dV, dQ) into
    `grads` on a call the router sends to wgmma. Not counted."""
    b, tq, h, d = q.shape
    delta = torch.empty((b * h, tq), dtype=torch.float32, device=q.device)
    err = flash_ops._general_bwd_kernel()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), *(g.data_ptr() for g in grads),
        flash_ops._strides(q, k, v, *grads), b, tq, k.shape[1], h, d, 1.0 / math.sqrt(d),
        1, torch.cuda.current_stream().cuda_stream)
    check(err == 0, f"mma.sync general backward launch failed: CUDA error {err}")
    return grads


def _sdpa_bwd_ms(qkv, dout, iters):
    """SDPA's backward on the q/k/v views of qkv, from a retained graph."""
    leaf = qkv.detach().requires_grad_(True)
    qh, kh, vh = (x.transpose(1, 2) for x in leaf.unbind(2))
    sdpa_out = F.scaled_dot_product_attention(qh, kh, vh)
    return cuda_ms(lambda: torch.autograd.grad(
        sdpa_out, (qh, kh, vh), dout.transpose(1, 2), retain_graph=True), iters=iters)


def phase_general(card: str) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(4)
    main_record = None
    for i, (b, tq, tk, h, d) in enumerate(GENERAL_SHAPES):
        for dtype in (torch.bfloat16, torch.float32):
            _, (q, k, v) = _general_inputs(gen, b, tq, tk, h, d, dtype, packed=i == 0)
            before = read_designs()
            o, lse = flash_attention_fwd(q, k, v)
            torch.cuda.synchronize()
            design = flash_fwd_design(dtype, d, 1.0 / math.sqrt(d), (q, k, v))
            tag = f"B={b} Tq={tq} Tk={tk} H={h} D={d} {str(dtype)[6:]}"
            used = _used("flash_fwd", before)
            check(used == {design: 1}, f"{tag}: general forward launches by kernel {used}, "
                  f"expected { {design: 1} }")
            ro, rlse = flash_attention_reference(q, k, v)
            err = (o.float() - ro.float()).abs().max().item()
            lse_err = (lse - rlse).abs().max().item()
            print(f"[general] {tag}: kernel {design}; max|o - plain| {err:.3e} (tol "
                  f"{ATOL[dtype]:.0e}), max|lse - plain| {lse_err:.3e} (tol "
                  f"{LSE_ATOL:.0e})", flush=True)
            check(torch.isfinite(o.float()).all().item(), f"{tag}: non-finite output")
            check(err <= ATOL[dtype] and lse_err <= LSE_ATOL,
                  f"{tag}: general forward kernel disagrees")
            if i != 0 or dtype != torch.bfloat16:
                del ro, rlse
                continue
            gate = check_gate(tag, *attention_errors(q, k, v, o)[:2])
            old_o, old_lse = _mma_sync_general(q, k, v)
            old_err = (old_o.float() - ro.float()).abs().max().item()
            old_lse_err = (old_lse - rlse).abs().max().item()
            del ro, rlse
            check(old_err <= ATOL[dtype] and old_lse_err <= LSE_ATOL,
                  f"{tag}: the mma.sync general forward disagrees")
            ms = cuda_ms(lambda: flash_attention_fwd(q, k, v), iters=50)
            mma_sync_ms = cuda_ms(lambda: _mma_sync_general(q, k, v), iters=50)
            plain_ms = cuda_ms(lambda: flash_attention_reference(q, k, v), iters=5,
                               warmup=1)
            qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
            library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh),
                                 iters=50)
            bound_ms, bound_by = attention_bound_ms(b, tq, tk, h, d, dtype)
            print(f"[general] {tag} (packed views): kernel ({design}) {ms:.4f} ms, "
                  f"mma.sync kernel {mma_sync_ms:.4f} ms (max|o - plain| {old_err:.3e}), "
                  f"plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound "
                  f"{bound_ms:.4f} ms ({bound_by}); kernel / sdpa {ms / library_ms:.3f} "
                  f"[{card}]", flush=True)
            main_record = dict(
                name="flash_fwd", route="cuda", source="vaw_torch/ops/csrc/flash_fwd.cu",
                replaces="vaw_tpu/ops/flash_attention.py:88",
                launches=None, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
                mma_sync_ms=mma_sync_ms, model_shapes={}, gate=gate)
    for (b, tq, tk, h, d, packed) in GENERAL_T1024:
        qkv, (q, k, v) = _general_inputs(gen, b, tq, tk, h, d, torch.bfloat16, packed)
        design = flash_fwd_design(torch.bfloat16, d, 1.0 / math.sqrt(d), (q, k, v))
        tag = f"B={b} Tq={tq} Tk={tk} H={h} D={d} bfloat16"
        before = read_designs()
        o, lse = flash_attention_fwd(q, k, v)
        torch.cuda.synchronize()
        used = _used("flash_fwd", before)
        check(used == {design: 1}, f"{tag}: general forward launches by kernel {used}")
        # The plain version's bf16 o is its f32 o rounded once.
        kernel_err, sdpa_err, (ro, rlse) = attention_errors(q, k, v, o)
        err = (o.float() - ro.to(torch.bfloat16).float()).abs().max().item()
        lse_err = (lse - rlse).abs().max().item()
        del ro, rlse, o, lse
        check(err <= ATOL[torch.bfloat16] and lse_err <= LSE_ATOL,
              f"{tag}: general forward kernel disagrees ({err:.3e}, {lse_err:.3e})")
        gate = check_gate(tag, kernel_err, sdpa_err)
        ms = cuda_ms(lambda: flash_attention_fwd(q, k, v), iters=20)
        mma_sync_ms = cuda_ms(lambda: _mma_sync_general(q, k, v), iters=20)
        qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh), iters=20)
        bound_ms, bound_by = attention_bound_ms(b, tq, tk, h, d, torch.bfloat16)
        sfu_ms = sfu_exp_ms(b, tq, tk, h)
        print(f"[general] {tag} ({'packed views' if packed else 'q, k, v'}): kernel "
              f"{design}; max|o - plain| {err:.3e} "
              f"(tol {ATOL[torch.bfloat16]:.0e}), max|lse - plain| {lse_err:.3e} (tol "
              f"{LSE_ATOL:.0e}); kernel {ms:.4f} ms, mma.sync kernel {mma_sync_ms:.4f} ms, "
              f"sdpa {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), exp2 on "
              f"the special-function units alone {sfu_ms:.4f} ms; kernel / sdpa "
              f"{ms / library_ms:.3f} [{card}]", flush=True)
        main_record["model_shapes"][tag] = dict(
            ms=ms, mma_sync_ms=mma_sync_ms, library_ms=library_ms, bound_ms=bound_ms,
            bound_by=bound_by, sfu_exp_ms=sfu_ms, max_abs_err=err, gate=gate)
        del qkv, q, k, v, qh, kh, vh
    main_record["f32_shapes"] = phase_general_f32(card, gen)
    return main_record


def phase_general_f32(card: str, gen) -> dict:
    """B5 in f32 at the classifier path's shapes (CLF_GENERAL_F32) and on
    either side of the crossover (CROSSOVER_F32): through the kernel the
    crossover selects (counted) against the plain version;
    then both f32 kernels, tf32x3 and FMA (each chosen by setting the
    crossover, ``min_tiles``), against the plain version and timed through
    the entry, back to back as the host issues them (cuda_ms) and on the
    device alone (device_ms), beside SDPA (TF32 off), the plain version and
    the bounds."""
    records = {}
    for (b, tq, tk, h, d, packed) in CLF_GENERAL_F32 + CROSSOVER_F32:
        qkv, (q, k, v) = _general_inputs(gen, b, tq, tk, h, d, torch.float32, packed)
        tag = f"B={b} Tq={tq} Tk={tk} H={h} D={d} float32"
        design = flash_fwd_design(torch.float32, d, 1.0 / math.sqrt(d), (q, k, v))
        check(design == f32_rule(b, tq, tk, h), f"{tag}: design {design}")
        before = read_designs()
        flash_attention_fwd(q, k, v)
        torch.cuda.synchronize()
        used = _used("flash_fwd", before)
        check(used == {design: 1}, f"{tag}: general forward launches by kernel {used}")
        ro, rlse = flash_attention_reference(q, k, v)
        errs, times = {}, {}
        for name, n in (("tf32x3", 0), ("fma", FMA_ONLY)):
            with min_tiles(n):
                o, lse = flash_attention_fwd(q, k, v)
                errs[name] = ((o - ro).abs().max().item(), (lse - rlse).abs().max().item())
                check(errs[name][0] <= ATOL[torch.float32] and errs[name][1] <= LSE_ATOL,
                      f"{tag}: {name} forward disagrees {errs[name]}")
                run = lambda: flash_attention_fwd(q, k, v)  # noqa: E731
                times[name] = (cuda_ms(run, iters=20), device_ms(run), host_us(run))
        del ro, rlse, o, lse
        plain_ms = cuda_ms(lambda: flash_attention_reference(q, k, v), iters=5, warmup=1)
        qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh), iters=20)
        bounds = attention_f32_bounds(b, tq, tk, h, d)
        ms = times[design][0]
        print(f"[general f32] {tag} ({'packed views' if packed else 'q, k, v'}), "
              f"{score_tiles(b, tq, tk, h)} score tiles: kernel {design}; tf32x3 "
              f"{times['tf32x3'][0]:.4f} ms a call as issued ({times['tf32x3'][1]:.4f} on the "
              f"device; host {times['tf32x3'][2]:.1f} µs), max|o - plain| "
              f"{errs['tf32x3'][0]:.3e}; FMA kernel {times['fma'][0]:.4f} ms "
              f"({times['fma'][1]:.4f}; host {times['fma'][2]:.1f} µs), max|o - plain| "
              f"{errs['fma'][0]:.3e} (tol "
              f"{ATOL[torch.float32]:.0e}); plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, "
              f"{_bounds_text(bounds)}; kernel / sdpa {ms / library_ms:.3f} [{card}]",
              flush=True)
        records[tag] = dict(design=design, ms=ms, tf32x3_ms=times["tf32x3"][0],
                            tf32x3_device_ms=times["tf32x3"][1],
                            tf32x3_host_us=times["tf32x3"][2], fma_ms=times["fma"][0],
                            fma_device_ms=times["fma"][1], fma_host_us=times["fma"][2],
                            plain_ms=plain_ms,
                            library_ms=library_ms, max_abs_err=errs[design][0],
                            tf32x3_max_abs_err=errs["tf32x3"][0],
                            fma_max_abs_err=errs["fma"][0], **bounds)
        del qkv, q, k, v, qh, kh, vh
    return records


def phase_general_bwd(card: str) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(5)
    main_record = None
    for i, (b, tq, tk, h, d) in enumerate(GENERAL_SHAPES):
        for dtype in (torch.bfloat16, torch.float32):
            qkv, (q, k, v) = _general_inputs(gen, b, tq, tk, h, d, dtype, packed=i == 0)
            dout = torch.randn((b, tq, h, d), generator=gen, device="cuda").to(dtype)
            o, lse = flash_attention_fwd(q, k, v)
            dqkv = torch.empty_like(qkv) if qkv is not None else None
            grads = dqkv.unbind(2) if dqkv is not None else None
            before = read_designs()
            got = [x.clone() for x in flash_attention_bwd(q, k, v, o, lse, dout, grads=grads)]
            again = flash_attention_bwd(q, k, v, o, lse, dout, grads=grads)
            torch.cuda.synchronize()
            design = flash_bwd_design(dtype, d, 1.0 / math.sqrt(d),
                                      (q, k, v, *(grads or ())))
            tag = f"B={b} Tq={tq} Tk={tk} H={h} D={d} {str(dtype)[6:]}"
            used = _used("flash_bwd", before)
            check(used == {design: 2}, f"{tag}: general backward launches by kernel "
                  f"{used}, expected { {design: 2} }")
            same = all(torch.equal(x, y) for x, y in zip(got, again))
            check(same, f"{tag}: a repeated general backward is not bit-equal")
            want = flash_attention_bwd_reference(q, k, v, o, lse, dout)
            worst = 0.0
            for name, x, w in zip(("dq", "dk", "dv"), got, want):
                scale = w.float().abs().max().item()
                err = (x.float() - w.float()).abs().max().item()
                worst = max(worst, err / scale)
                check(torch.isfinite(x.float()).all().item(), f"{tag}: non-finite {name}")
                check(err <= BWD_RTOL[dtype] * scale,
                      f"{tag}: general backward kernel disagrees in {name}")
            print(f"[general bwd] {tag}: kernel {design}; max|grad - plain| / max|grad| "
                  f"over dq, dk, dv {worst:.3e} (tol {BWD_RTOL[dtype]:.0e}); repeat "
                  f"bit-equal {same}", flush=True)
            if i == 0 and dtype == torch.bfloat16:
                gate = check_gate(tag, *attention_errors(q, k, v, o, dout, got)[:2])
            del got, again
            if i != 0 or dtype != torch.bfloat16:
                del want
                continue
            old = _mma_sync_general_bwd(q, k, v, o, lse, dout,
                                        [torch.empty_like(x) for x in (q, k, v)])
            old_worst = max((x.float() - w.float()).abs().max().item()
                            / w.float().abs().max().item() for x, w in zip(old, want))
            del want, old
            check(old_worst <= BWD_RTOL[dtype], f"{tag}: the mma.sync general backward "
                  f"disagrees")
            ms = cuda_ms(lambda: flash_attention_bwd(q, k, v, o, lse, dout, grads=grads),
                         iters=20)
            mma_sync_ms = cuda_ms(lambda: _mma_sync_general_bwd(q, k, v, o, lse, dout, grads),
                                  iters=20)
            plain_ms = cuda_ms(lambda: flash_attention_bwd_reference(
                q, k, v, o, lse, dout), iters=3, warmup=1)
            library_ms = _sdpa_bwd_ms(qkv, dout, iters=20)
            bound_ms, bound_by = attention_bwd_bound_ms(b, tq, tk, h, d, dtype)
            print(f"[general bwd] {tag} (packed views, one packed gradient): kernel "
                  f"({design}) {ms:.4f} ms, mma.sync kernels {mma_sync_ms:.4f} ms (max "
                  f"rel err {old_worst:.3e}), plain {plain_ms:.4f} ms, sdpa backward "
                  f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); kernel / "
                  f"sdpa {ms / library_ms:.3f} [{card}]", flush=True)
            main_record = dict(
                name="flash_bwd", route="cuda", source="vaw_torch/ops/csrc/flash_bwd.cu",
                replaces="vaw_tpu/ops/flash_attention.py:130",
                launches=None, max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
                mma_sync_ms=mma_sync_ms, model_shapes={}, gate=gate)
    for (b, tq, tk, h, d, packed) in GENERAL_T1024:
        qkv, (q, k, v) = _general_inputs(gen, b, tq, tk, h, d, torch.bfloat16, packed)
        dout = torch.randn((b, tq, h, d), generator=gen, device="cuda").bfloat16()
        o, lse = flash_attention_fwd(q, k, v)
        grads = (torch.empty_like(qkv).unbind(2) if packed
                 else tuple(torch.empty_like(x) for x in (q, k, v)))
        design = flash_bwd_design(torch.bfloat16, d, 1.0 / math.sqrt(d), (q, k, v, *grads))
        tag = f"B={b} Tq={tq} Tk={tk} H={h} D={d} bfloat16"
        before = read_designs()
        got = [x.clone() for x in flash_attention_bwd(q, k, v, o, lse, dout, grads=grads)]
        again = flash_attention_bwd(q, k, v, o, lse, dout, grads=grads)
        torch.cuda.synchronize()
        used = _used("flash_bwd", before)
        check(used == {design: 2}, f"{tag}: general backward launches by kernel {used}")
        same = all(torch.equal(x, y) for x, y in zip(got, again))
        check(same, f"{tag}: a repeated general backward is not bit-equal")
        worst = 0.0
        for name, x, w in zip(("dq", "dk", "dv"), got,
                              flash_attention_bwd_reference(q, k, v, o, lse, dout)):
            err = (x.float() - w.float()).abs().max().item()
            worst = max(worst, err / w.float().abs().max().item())
            check(torch.isfinite(x.float()).all().item(), f"{tag}: non-finite {name}")
        del x, w
        gate = check_gate(tag, *attention_errors(q, k, v, o, dout, got)[:2])
        del got, again
        check(worst <= BWD_RTOL[torch.bfloat16],
              f"{tag}: general backward kernel disagrees ({worst:.3e})")
        ms = cuda_ms(lambda: flash_attention_bwd(q, k, v, o, lse, dout, grads=grads),
                     iters=10)
        mma_sync_ms = cuda_ms(lambda: _mma_sync_general_bwd(q, k, v, o, lse, dout, grads),
                              iters=10)
        library_ms = _sdpa_bwd_ms(qkv if packed else torch.stack((q, k, v), 2), dout,
                                  iters=10)
        bound_ms, bound_by = attention_bwd_bound_ms(b, tq, tk, h, d, torch.bfloat16)
        sfu_ms = sfu_exp_ms(b, tq, tk, h)
        print(f"[general bwd] {tag} ("
              f"{'packed views, one packed gradient' if packed else 'q, k, v'}): kernel "
              f"{design}; "
              f"max|grad - plain| / max|grad| over dq, dk, dv {worst:.3e} (tol "
              f"{BWD_RTOL[torch.bfloat16]:.0e}); repeat bit-equal {same}; kernel {ms:.4f} "
              f"ms, mma.sync kernels {mma_sync_ms:.4f} ms, sdpa backward {library_ms:.4f} "
              f"ms, bound {bound_ms:.4f} ms ({bound_by}), exp2 on the special-function "
              f"units alone {sfu_ms:.4f} ms; kernel / sdpa {ms / library_ms:.3f} [{card}]",
              flush=True)
        main_record["model_shapes"][tag] = dict(
            ms=ms, mma_sync_ms=mma_sync_ms, library_ms=library_ms, bound_ms=bound_ms,
            bound_by=bound_by, sfu_exp_ms=sfu_ms, max_abs_err=worst, gate=gate)
        del qkv, q, k, v, dout, o, lse, grads
    return main_record


def _p5_inputs(gen, b, t, h, d, dtype):
    """f5 [B, 3, H, D, T] on the card, q and k at 0.5, v at 1."""
    f5 = torch.randn((b, 3, h, d, t), generator=gen, device="cuda")
    f5[:, :2] *= 0.5
    return f5.to(dtype)


def _bhtd(f5):
    """q, k and v of f5 copied to contiguous [B, H, T, D], SDPA's layout."""
    return [f5[:, i].transpose(-1, -2).contiguous() for i in range(3)]


def _used(name: str, before: dict) -> dict:
    """Launches by kernel of `name` since `before` (a read_designs())."""
    return {k: v - before[name][k] for k, v in read_designs()[name].items()
            if v > before[name][k]}


def _mma_sync_p5(f5):
    """The bf16 mma.sync kernel of flash_p5_fwd.cu on a call the router
    sends to wgmma: its time beside the wgmma kernel's. Not counted (it is
    no launch of a path)."""
    b, _, h, d, t = f5.shape
    out = torch.empty((b * h, d, t), dtype=f5.dtype, device=f5.device)
    lse = torch.empty((b * h, t), dtype=torch.float32, device=f5.device)
    err = flash_ops._p5_fwd_kernel()(f5.data_ptr(), out.data_ptr(), lse.data_ptr(), b, h,
                                     d, t, 1.0 / math.sqrt(d), 1,
                                     torch.cuda.current_stream().cuda_stream)
    check(err == 0, f"mma.sync p5 forward launch failed: CUDA error {err}")
    return out, lse


def phase_p5(card: str) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(6)
    main_record = None
    for i, (b, t, h, d) in enumerate(P5_SHAPES):
        for dtype in (torch.bfloat16, torch.float32):
            f5 = _p5_inputs(gen, b, t, h, d, dtype)
            before = read_designs()
            o, lse = flash_attention_p5_fwd(f5)
            torch.cuda.synchronize()
            design = flash_p5_fwd_design(dtype, 1.0 / math.sqrt(d), f5.shape)
            tag = f"B={b} T={t} H={h} D={d} {str(dtype)[6:]}"
            used = _used("flash_p5_fwd", before)
            check(used == {design: 1}, f"{tag}: p5 launches by kernel {used}, expected "
                  f"{ {design: 1} }")
            ro, rlse = flash_attention_p5_reference(f5)
            err = (o.float() - ro.float()).abs().max().item()
            lse_err = (lse - rlse).abs().max().item()
            print(f"[p5] {tag}: kernel {design}; max|o - plain| {err:.3e} (tol "
                  f"{ATOL[dtype]:.0e}), max|lse - plain| {lse_err:.3e} (tol "
                  f"{LSE_ATOL:.0e})", flush=True)
            check(torch.isfinite(o.float()).all().item(), f"{tag}: non-finite output")
            check(err <= ATOL[dtype] and lse_err <= LSE_ATOL,
                  f"{tag}: p5 forward kernel disagrees")
            if i != 0 or dtype != torch.bfloat16:
                del ro, rlse
                continue
            old_o, old_lse = _mma_sync_p5(f5)
            old_err = (old_o.float() - ro.float()).abs().max().item()
            old_lse_err = (old_lse - rlse).abs().max().item()
            del ro, rlse
            check(old_err <= ATOL[dtype] and old_lse_err <= LSE_ATOL,
                  f"{tag}: the mma.sync p5 kernel disagrees")
            ms = cuda_ms(lambda: flash_attention_p5_fwd(f5), iters=50)
            mma_sync_ms = cuda_ms(lambda: _mma_sync_p5(f5), iters=50)
            plain_ms = cuda_ms(lambda: flash_attention_p5_reference(f5), iters=10)
            q, k, v = _bhtd(f5)
            library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), iters=50)
            del q, k, v
            bound_ms, bound_by = attention_bound_ms(b, t, t, h, d, dtype)
            print(f"[p5] {tag}: kernel ({design}) {ms:.4f} ms, mma.sync kernel "
                  f"{mma_sync_ms:.4f} ms (max|o - plain| {old_err:.3e}), plain "
                  f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
                  f"({bound_by}); kernel / sdpa {ms / library_ms:.3f} [{card}]", flush=True)
            main_record = dict(
                name="flash_p5_fwd", route="cuda", source="vaw_torch/ops/csrc/flash_p5_fwd.cu",
                replaces="vaw_tpu/ops/flash_attention.py:414",
                launches=None, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
                mma_sync_ms=mma_sync_ms)
    return main_record


def _mma_sync_p5_bwd(f5, o, lse, dout):
    """The bf16 mma.sync kernels of flash_p5_bwd.cu (delta, dK/dV, dQ) on a
    call the router sends to wgmma: their time and error beside the wgmma
    pair's. Not counted."""
    b, _, h, d, t = f5.shape
    dqkv = torch.empty_like(f5)
    delta = torch.empty((b * h, t), dtype=torch.float32, device=f5.device)
    err = flash_ops._p5_bwd_kernel()(
        f5.data_ptr(), o.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dqkv.data_ptr(), b, h, d, t, 1.0 / math.sqrt(d), 1,
        torch.cuda.current_stream().cuda_stream)
    check(err == 0, f"mma.sync p5 backward launch failed: CUDA error {err}")
    return dqkv


def _p5_rel_err(got, want) -> float:
    """max|got - want| / max|want| over dq, dk and dv, the worst of three."""
    return max((got[:, j].float() - want[:, j].float()).abs().max().item()
               / want[:, j].float().abs().max().item() for j in range(3))


def phase_p5_bwd(card: str) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(7)
    main_record = None
    for i, (b, t, h, d) in enumerate(P5_BWD_SHAPES):
        for dtype in (torch.bfloat16, torch.float32):
            f5 = _p5_inputs(gen, b, t, h, d, dtype)
            dout = torch.randn((b * h, d, t), generator=gen, device="cuda").to(dtype)
            o, lse = flash_attention_p5_fwd(f5)
            before = read_designs()
            dqkv = flash_attention_p5_bwd(f5, o, lse, dout)
            again = flash_attention_p5_bwd(f5, o, lse, dout)
            torch.cuda.synchronize()
            design = flash_p5_bwd_design(dtype, d, 1.0 / math.sqrt(d))
            tag = f"B={b} T={t} H={h} D={d} {str(dtype)[6:]}"
            check(design == _expected_design(dtype, d, "tf32x3"),
                  f"{tag}: design {design}")
            used = _used("flash_p5_bwd", before)
            check(used == {design: 2}, f"{tag}: p5 backward launches by kernel {used}, "
                  f"expected { {design: 2} }")
            same = torch.equal(dqkv, again)
            check(same, f"{tag}: a repeated p5 backward is not bit-equal")
            del again
            want = flash_attention_p5_bwd_reference(f5, o, lse, dout)
            for j, name in enumerate(("dq", "dk", "dv")):
                check(torch.isfinite(dqkv[:, j].float()).all().item(),
                      f"{tag}: non-finite {name}")
            worst = _p5_rel_err(dqkv, want)
            print(f"[p5 bwd] {tag}: kernel {design}; max|grad - plain| / max|grad| over "
                  f"dq, dk, dv {worst:.3e} (tol {BWD_RTOL[dtype]:.0e}); repeat bit-equal "
                  f"{same}", flush=True)
            check(worst <= BWD_RTOL[dtype], f"{tag}: p5 backward kernel disagrees")
            if i != 0 or dtype != torch.bfloat16:
                del want
                continue
            old_worst = _p5_rel_err(_mma_sync_p5_bwd(f5, o, lse, dout), want)
            del want
            check(old_worst <= BWD_RTOL[dtype], f"{tag}: the mma.sync p5 backward disagrees")
            ms = cuda_ms(lambda: flash_attention_p5_bwd(f5, o, lse, dout), iters=20)
            mma_sync_ms = cuda_ms(lambda: _mma_sync_p5_bwd(f5, o, lse, dout), iters=20)
            plain_ms = cuda_ms(lambda: flash_attention_p5_bwd_reference(
                f5, o, lse, dout), iters=3, warmup=1)
            # SDPA's backward on contiguous [B, H, T, D] copies, from a
            # retained graph.
            q, k, v = (x.requires_grad_(True) for x in _bhtd(f5))
            sdpa_out = F.scaled_dot_product_attention(q, k, v)
            g4 = dout.view(b, h, d, t).transpose(-1, -2)
            library_ms = cuda_ms(lambda: torch.autograd.grad(
                sdpa_out, (q, k, v), g4, retain_graph=True), iters=20)
            del q, k, v, sdpa_out
            bound_ms, bound_by = attention_bwd_bound_ms(b, t, t, h, d, dtype)
            print(f"[p5 bwd] {tag}: kernel ({design}) {ms:.4f} ms, mma.sync kernels "
                  f"{mma_sync_ms:.4f} ms (max rel err {old_worst:.3e}), plain "
                  f"{plain_ms:.4f} ms, sdpa backward {library_ms:.4f} ms, bound "
                  f"{bound_ms:.4f} ms ({bound_by}); kernel / sdpa {ms / library_ms:.3f} "
                  f"[{card}]", flush=True)
            main_record = dict(
                name="flash_p5_bwd", route="cuda", source="vaw_torch/ops/csrc/flash_p5_bwd.cu",
                replaces="vaw_tpu/ops/flash_attention.py:443",
                launches=None, max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
                mma_sync_ms=mma_sync_ms)
    return main_record


def conv_bound_ms(n, h, w, cin, cout, dtype) -> tuple[float, str]:
    """Least time for one conv or wgrad: the two image operands (x and y,
    or x and g) and the filter read or written once, or the
    2*9*Cin*Cout*N*H*W operations at the dtype's peak."""
    elt = torch.finfo(dtype).bits // 8
    nbytes = n * h * w * (cin + cout) * elt + 9 * cin * cout * elt
    flops = 2 * 9 * cin * cout * n * h * w
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops else "operations")


def _conv_inputs(gen, n, h, w, cin, cout, dtype):
    x = torch.randn((n, h, w, cin), generator=gen, device="cuda").to(dtype)
    wt = (torch.randn((3, 3, cin, cout), generator=gen, device="cuda")
          / math.sqrt(9 * cin)).to(dtype)
    g = torch.randn((n, h, w, cout), generator=gen, device="cuda").to(dtype)
    return x, wt, g


def _rel_err(got, want) -> tuple[float, float]:
    scale = want.float().abs().max().item()
    return (got.float() - want.float()).abs().max().item() / scale, scale


def _mma_sync_conv(x, wt):
    """The bf16 mma.sync kernel of conv3x3_fwd.cu on any shape, also one the
    router sends to wgmma: its time beside the wgmma kernel's. Not counted
    (it is no launch of a path)."""
    n, h, w, cin = x.shape
    cout = wt.shape[-1]
    wk = wt.permute(3, 0, 1, 2).reshape(cout, 9 * cin).contiguous()
    y = torch.empty((n, h, w, cout), dtype=x.dtype, device=x.device)
    err = conv_ops._fwd_kernel()(x.data_ptr(), wk.data_ptr(), y.data_ptr(), n, h, w,
                                 cin, cout, 9 * cin, 1,
                                 torch.cuda.current_stream().cuda_stream)
    check(err == 0, f"mma.sync conv launch failed: CUDA error {err}")
    return y


def phase_conv(card: str) -> dict:
    """3g: the conv forward and its dgrad (the same kernels on the rotated,
    in/out-swapped filter) against the plain version, each shape through
    the kernel conv3x3_design picks for it."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    main_record = None
    for i, (n, h, w, cin, cout, dtypes) in enumerate(CONV_SHAPES):
        for dtype in dtypes:
            x, wt, g = _conv_inputs(gen, n, h, w, cin, cout, dtype)
            w_rot = wt.flip(0, 1).transpose(2, 3)
            before = read_designs()
            y = conv3x3_pallas(x, wt)
            dx = conv3x3_pallas(g, w_rot)
            torch.cuda.synchronize()
            used = _used("conv3x3_fwd", before)
            designs = (conv3x3_design(x.shape, cout, dtype),
                       conv3x3_design(g.shape, cin, dtype))
            tag = f"N={n} {h}x{w} {cin}->{cout} {str(dtype)[6:]}"
            want_used = {d: designs.count(d) for d in designs}
            check(used == want_used, f"{tag}: conv launches by kernel {used}, "
                  f"expected {want_used}")
            errs, abs_errs = [], []
            for name, got, want in (("y", y, conv3x3_reference(x, wt)),
                                    ("dx", dx, conv3x3_reference(g, w_rot))):
                check(torch.isfinite(got.float()).all().item(), f"{tag}: non-finite {name}")
                err, scale = _rel_err(got, want)
                errs.append(err)
                abs_errs.append(err * scale)
                check(err <= CONV_RTOL[dtype], f"{tag}: conv kernel disagrees in {name}")
                del want
            print(f"[conv] {tag}: kernels y {designs[0]}, dgrad {designs[1]}; max|y - "
                  f"plain| / max|y| {errs[0]:.3e}, dgrad {errs[1]:.3e} (tol "
                  f"{CONV_RTOL[dtype]:.0e})", flush=True)
            if i != 0 or dtype != torch.bfloat16:
                continue
            old = _mma_sync_conv(x, wt)
            old_err, _ = _rel_err(old, conv3x3_reference(x, wt))
            check(old_err <= CONV_RTOL[dtype], f"{tag}: the mma.sync kernel disagrees")
            ms = cuda_ms(lambda: conv3x3_pallas(x, wt), iters=20)
            mma_sync_ms = cuda_ms(lambda: _mma_sync_conv(x, wt), iters=20)
            plain_ms = cuda_ms(lambda: conv3x3_reference(x, wt), iters=3, warmup=1)
            # cuDNN on the channels-last view of the same tensors (no TF32).
            xc, wc = x.permute(0, 3, 1, 2), wt.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            library_ms = cuda_ms(lambda: F.conv2d(xc, wc, padding=1), iters=20)
            bound_ms, bound_by = conv_bound_ms(n, h, w, cin, cout, dtype)
            print(f"[conv] {tag}: kernel ({designs[0]}) {ms:.4f} ms, mma.sync kernel "
                  f"{mma_sync_ms:.4f} ms (max rel err {old_err:.3e}), plain "
                  f"{plain_ms:.4f} ms, cuDNN {library_ms:.4f} ms, bound {bound_ms:.4f} "
                  f"ms ({bound_by}); kernel / cuDNN {ms / library_ms:.3f} [{card}]",
                  flush=True)
            main_record = dict(
                name="conv3x3_fwd", route="cuda", source="vaw_torch/ops/csrc/conv3x3_fwd.cu",
                replaces="vaw_tpu/ops/conv2d.py:41",
                launches=None, max_abs_err=abs_errs[0], ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
                mma_sync_ms=mma_sync_ms)
    return main_record


def _mma_sync_wgrad(x, g):
    """The bf16 mma.sync wgrad of conv3x3_wgrad.cu (its own split and sum)
    on any shape, also one the router sends to wgmma: its time beside the
    wgmma kernel's. Not counted (it is no launch of a path)."""
    n, h, w, cin = x.shape
    cout = g.shape[-1]
    lib = conv_ops._wgrad_lib()
    splits = lib.vaw_conv3x3_wgrad_splits(n, h, w, cin, cout, 1)
    work = torch.empty((splits, 9 * cin, cout), dtype=torch.float32, device=x.device)
    dw = torch.empty((3, 3, cin, cout), dtype=x.dtype, device=x.device)
    err = lib.vaw_conv3x3_wgrad(x.data_ptr(), g.data_ptr(), work.data_ptr(), dw.data_ptr(),
                                n, h, w, cin, cout, splits, 1,
                                torch.cuda.current_stream().cuda_stream)
    check(err == 0, f"mma.sync wgrad launch failed: CUDA error {err}")
    return dw


def phase_wgrad(card: str) -> dict:
    """3h: the wgrad (split-K partials and their fixed-order sum) against
    the plain version, each shape through the kernel conv3x3_wgrad_design
    picks for it."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    main_record = None
    for i, (n, h, w, cin, cout, dtypes) in enumerate(WGRAD_SHAPES):
        for dtype in dtypes:
            x, _, g = _conv_inputs(gen, n, h, w, cin, cout, dtype)
            before = read_designs()
            dw = conv3x3_wgrad_pallas(x, g)
            again = conv3x3_wgrad_pallas(x, g)
            torch.cuda.synchronize()
            design = conv3x3_wgrad_design(x.shape, cout, dtype)
            tag = f"N={n} {h}x{w} {cin}->{cout} {str(dtype)[6:]}"
            used = _used("conv3x3_wgrad", before)
            check(used == {design: 2}, f"{tag}: wgrad launches by kernel {used}, "
                  f"expected { {design: 2} }")
            want = conv3x3_wgrad_reference(x, g)
            err, scale = _rel_err(dw, want)
            print(f"[wgrad] {tag}: kernel {design}; max|dw - plain| / max|dw| {err:.3e} "
                  f"of {scale:.3f} (tol {WGRAD_RTOL[dtype]:.0e}), repeat bit-equal "
                  f"{torch.equal(dw, again)}", flush=True)
            check(torch.isfinite(dw.float()).all().item(), f"{tag}: non-finite dw")
            check(err <= WGRAD_RTOL[dtype], f"{tag}: wgrad kernel disagrees")
            check(torch.equal(dw, again), f"{tag}: wgrad differs from run to run")
            if i != 0 or dtype != torch.bfloat16:
                continue
            old_err, _ = _rel_err(_mma_sync_wgrad(x, g), want)
            check(old_err <= WGRAD_RTOL[dtype], f"{tag}: the mma.sync wgrad disagrees")
            ms = cuda_ms(lambda: conv3x3_wgrad_pallas(x, g), iters=20)
            mma_sync_ms = cuda_ms(lambda: _mma_sync_wgrad(x, g), iters=20)
            plain_ms = cuda_ms(lambda: conv3x3_wgrad_reference(x, g), iters=3, warmup=1)
            xc, gc = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
            library_ms = cuda_ms(lambda: torch.nn.grad.conv2d_weight(
                xc, (cout, cin, 3, 3), gc, padding=1), iters=20)
            bound_ms, bound_by = conv_bound_ms(n, h, w, cin, cout, dtype)
            print(f"[wgrad] {tag}: kernel ({design}, plan {conv3x3_wgrad_plan(n, h, w, cin, cout)}) "
                  f"{ms:.4f} ms, mma.sync kernel {mma_sync_ms:.4f} ms (max rel err "
                  f"{old_err:.3e}), plain {plain_ms:.4f} ms, cuDNN conv2d_weight "
                  f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); kernel / "
                  f"cuDNN {ms / library_ms:.3f} [{card}]", flush=True)
            main_record = dict(
                name="conv3x3_wgrad", route="cuda",
                source="vaw_torch/ops/csrc/conv3x3_wgrad.cu",
                replaces="vaw_tpu/ops/conv2d.py:141",
                launches=None, max_abs_err=err * scale, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
                mma_sync_ms=mma_sync_ms)
    return main_record


def phase_act(card: str) -> tuple[dict, int]:
    """3i: the fused bias + leaky ReLU, which no model calls: its own run
    through the op entry (values, first and second derivatives, counted),
    against the plain version, then the times. Returns the record and the
    launches of that run."""
    gen = torch.Generator(device="cuda").manual_seed(10)
    main_record, own = None, 0
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.randn(ACT_SHAPE, generator=gen, device="cuda").to(dtype)
        b = (0.5 * torch.randn(ACT_SHAPE[-1:], generator=gen, device="cuda")).to(dtype)
        g = torch.randn(ACT_SHAPE, generator=gen, device="cuda").to(dtype)

        def derivatives(fn):
            """The op's value, its gradients against g, and the second
            derivative d/dx sum(d/dx sum(out^2))."""
            xg, bg = x.clone().requires_grad_(True), b.clone().requires_grad_(True)
            out = fn(xg, bg)
            dx, db = torch.autograd.grad((out.float() * g.float()).sum(), (xg, bg),
                                         retain_graph=True)
            (gx,) = torch.autograd.grad((out.float() ** 2).sum(), xg, create_graph=True)
            (h,) = torch.autograd.grad(gx.float().sum(), xg)
            return out.detach(), dx, db, h

        before = fused_leaky_relu.launches
        got = derivatives(fused_leaky_relu)
        own += fused_leaky_relu.launches - before
        torch.cuda.synchronize()
        want = derivatives(fused_leaky_relu_reference)
        tag = f"{tuple(ACT_SHAPE)} {str(dtype)[6:]}"
        err = (got[0].float() - want[0].float()).abs().max().item()
        gerr = max(_rel_err(a, b_)[0] for a, b_ in zip(got[1:], want[1:]))
        print(f"[act] {tag}: max|out - plain| {err:.3e} (tol 0), first and second "
              f"derivatives max rel err {gerr:.3e} (tol {WGRAD_RTOL[dtype]:.0e})",
              flush=True)
        check(all(torch.isfinite(a.float()).all().item() for a in got),
              f"{tag}: non-finite fused_act output or gradient")
        check(err == 0.0, f"{tag}: fused_act kernel disagrees")
        check(gerr <= WGRAD_RTOL[dtype], f"{tag}: fused_act derivatives disagree")
        del got, want
        if dtype != torch.bfloat16:
            continue
        slope, scale = 0.2, 2 ** 0.5
        ms = cuda_ms(lambda: fused_leaky_relu(x, b), iters=50)
        plain_ms = cuda_ms(lambda: fused_leaky_relu_reference(x, b), iters=20)
        eager_ms = cuda_ms(lambda: F.leaky_relu(x + b, slope) * scale, iters=50)
        nbytes = 2 * x.numel() * x.element_size() + b.numel() * b.element_size()
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        print(f"[act] {tag}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, eager "
              f"F.leaky_relu(x + b) * scale {eager_ms:.4f} ms (three PyTorch calls; no "
              f"single call computes it), bound {bound_ms:.4f} ms (bytes) [{card}]",
              flush=True)
        main_record = dict(
            name="fused_act", route="cuda", source="vaw_torch/ops/csrc/fused_act.cu",
            replaces="vaw_tpu/ops/fused_act.py:34",
            launches=None, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by="bytes", library_ms=None, eager_ms=eager_ms)
    return main_record, own


def _fma_wgrad(x, g):
    """The f32 FMA wgrad of conv3x3_wgrad.cu (its own split and sum) on a
    call the router sends to tf32x3: its time and error beside the 3xTF32
    kernel's. Not counted (it is no launch of a path)."""
    n, h, w, cin = x.shape
    cout = g.shape[-1]
    lib = conv_ops._wgrad_lib()
    splits = lib.vaw_conv3x3_wgrad_splits(n, h, w, cin, cout, 0)
    work = torch.empty((splits, 9 * cin, cout), dtype=torch.float32, device=x.device)
    dw = torch.empty((3, 3, cin, cout), dtype=torch.float32, device=x.device)
    err = lib.vaw_conv3x3_wgrad(x.data_ptr(), g.data_ptr(), work.data_ptr(), dw.data_ptr(),
                                n, h, w, cin, cout, splits, 0,
                                torch.cuda.current_stream().cuda_stream)
    check(err == 0, f"FMA wgrad launch failed: CUDA error {err}")
    return dw


def _f32_general_bwd_row(card: str, gen, shape) -> dict:
    """B6 in f32 at one (B, Tq, Tk, H, D, packed) shape: through the kernels
    the crossover selects (counted); both f32 designs, tf32x3 and FMA (each
    chosen by setting the crossover), against the plain version and
    bit-equal when repeated, timed through the entry (cuda_ms) and on the
    device alone (device_ms), beside the plain version, SDPA's backward
    (TF32 off) and the bounds."""
    b, tq, tk, h, d, packed = shape
    dtype = torch.float32
    tag = f"B={b} Tq={tq} Tk={tk} H={h} D={d} float32"
    qkv, (q, k, v) = _general_inputs(gen, b, tq, tk, h, d, dtype, packed)
    dout = torch.randn((b, tq, h, d), generator=gen, device="cuda")
    o, lse = flash_attention_fwd(q, k, v)
    grads = (torch.empty_like(qkv).unbind(2) if packed
             else tuple(torch.empty_like(x) for x in (q, k, v)))
    design = flash_bwd_design(dtype, d, 1.0 / math.sqrt(d), (q, k, v, *grads))
    check(design == f32_rule(b, tq, tk, h), f"{tag}: design {design}")
    run = lambda: flash_attention_bwd(q, k, v, o, lse, dout, grads=grads)  # noqa: E731
    before = read_designs()
    run()
    torch.cuda.synchronize()
    used = _used("flash_bwd", before)
    check(used == {design: 1}, f"f32 general backward {tag} by kernel {used}")
    want = flash_attention_bwd_reference(q, k, v, o, lse, dout)
    errs, abs_errs, times = {}, {}, {}
    for name, n in (("tf32x3", 0), ("fma", FMA_ONLY)):
        with min_tiles(n):
            got = [x.clone() for x in run()]
            again = run()
            same = all(torch.equal(x, y) for x, y in zip(got, again))
            errs[name] = max(_rel_err(x, w)[0] for x, w in zip(got, want))
            abs_errs[name] = max((x - w).abs().max().item() for x, w in zip(got, want))
            check(same, f"{tag}: a repeated {name} backward is not bit-equal")
            check(errs[name] <= BWD_RTOL[dtype], f"{tag}: {name} backward error {errs[name]}")
            times[name] = (cuda_ms(run, iters=10), device_ms(run), host_us(run))
    del got, again, want
    plain_ms = cuda_ms(lambda: flash_attention_bwd_reference(q, k, v, o, lse, dout),
                       iters=3, warmup=1)
    library_ms = _sdpa_bwd_ms(qkv if packed else torch.stack((q, k, v), 2), dout, iters=10)
    bounds = attention_bwd_f32_bounds(b, tq, tk, h, d)
    ms = times[design][0]
    print(f"[f32] flash_bwd {tag} ({'packed views' if packed else 'q, k, v'}), "
          f"{score_tiles(b, tq, tk, h)} score tiles: kernel {design}; tf32x3 "
          f"{times['tf32x3'][0]:.4f} ms a call as issued ({times['tf32x3'][1]:.4f} on the "
          f"device; host {times['tf32x3'][2]:.1f} µs), max rel err {errs['tf32x3']:.3e}; FMA "
          f"kernels {times['fma'][0]:.4f} ms ({times['fma'][1]:.4f}; host "
          f"{times['fma'][2]:.1f} µs), max rel err {errs['fma']:.3e} (tol "
          f"{BWD_RTOL[dtype]:.0e}); both bit-equal when repeated; plain {plain_ms:.4f} ms, "
          f"sdpa backward {library_ms:.4f} ms, {_bounds_text(bounds)}; kernel / sdpa "
          f"{ms / library_ms:.3f} [{card}]", flush=True)
    del qkv, q, k, v, dout, o, lse, grads
    return dict(bounds, design=design, ms=ms, tf32x3_ms=times["tf32x3"][0],
                tf32x3_device_ms=times["tf32x3"][1], tf32x3_host_us=times["tf32x3"][2],
                fma_ms=times["fma"][0], fma_device_ms=times["fma"][1],
                fma_host_us=times["fma"][2], plain_ms=plain_ms, library_ms=library_ms,
                max_rel_err=errs[design], max_abs_err=abs_errs[design],
                tf32x3_max_rel_err=errs["tf32x3"], fma_max_rel_err=errs["fma"])


def _f32_wgrad_row(card: str, gen, shape) -> dict:
    """B8 in f32 at one (N, H, W, Cin, Cout) shape: through the 3xTF32 kernel
    (counted, bit-equal when repeated) and the FMA kernel, each against the
    plain version, timed beside the plain version, cuDNN's conv2d_weight
    (TF32 off) and the bounds."""
    n, hh, w, cin, cout = shape
    dtype = torch.float32
    x, _, g = _conv_inputs(gen, n, hh, w, cin, cout, dtype)
    design = conv3x3_wgrad_design(x.shape, cout, dtype)
    check(design == "tf32x3", f"f32 wgrad {shape}: design {design}")
    before = read_designs()
    dw = conv3x3_wgrad_pallas(x, g)
    again = conv3x3_wgrad_pallas(x, g)
    torch.cuda.synchronize()
    used = _used("conv3x3_wgrad", before)
    check(used == {design: 2}, f"f32 wgrad {shape} by kernel {used}")
    check(torch.equal(dw, again), f"f32 wgrad {shape} differs from run to run")
    want = conv3x3_wgrad_reference(x, g)
    err, scale = _rel_err(dw, want)
    fma_err, _ = _rel_err(_fma_wgrad(x, g), want)
    check(err <= WGRAD_RTOL[dtype], f"f32 wgrad {shape}: error {err}")
    check(fma_err <= WGRAD_RTOL[dtype], f"f32 FMA wgrad {shape}: error {fma_err}")
    del dw, again, want
    ms = cuda_ms(lambda: conv3x3_wgrad_pallas(x, g), iters=10)
    fma_ms = cuda_ms(lambda: _fma_wgrad(x, g), iters=3)
    plain_ms = cuda_ms(lambda: conv3x3_wgrad_reference(x, g), iters=3, warmup=1)
    xc, gc = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
    library_ms = cuda_ms(lambda: torch.nn.grad.conv2d_weight(
        xc, (cout, cin, 3, 3), gc, padding=1), iters=10)
    nbytes = n * hh * w * (cin + cout) * 4 + 9 * cin * cout * 4
    bounds = f32_bounds(nbytes, 2 * 9 * cin * cout * n * hh * w)
    print(f"[f32] conv3x3_wgrad {shape}: kernel tf32x3 (plan "
          f"{conv3x3_wgrad_plan(n, hh, w, cin, cout, 'tf32x3')}) {ms:.4f} ms, max rel err "
          f"{err:.3e} of {scale:.3f}, bit-equal when repeated; FMA kernel {fma_ms:.4f} ms "
          f"(max rel err {fma_err:.3e}; tol {WGRAD_RTOL[dtype]:.0e}); plain {plain_ms:.4f} "
          f"ms, cuDNN conv2d_weight {library_ms:.4f} ms, {_bounds_text(bounds)}; kernel / "
          f"cuDNN {ms / library_ms:.3f} [{card}]", flush=True)
    del x, g, xc, gc
    return dict(bounds, design=design, ms=ms, fma_ms=fma_ms, plain_ms=plain_ms,
                library_ms=library_ms, max_rel_err=err, max_abs_err=err * scale,
                fma_max_rel_err=fma_err)


def _f32_fused_bwd_row(card: str, gen) -> dict:
    """B2 in f32 at DiT-B/2's training shape (F32_FUSED_BWD_SHAPE): through
    the fused entry, whose f32 calls at or above the crossover run the
    general pair's 3xTF32 design on the packed row's views (counted under
    the fused backward, bit-equal when repeated), and the fused FMA kernels
    called directly; each against the plain version, timed beside SDPA's
    backward (TF32 off) and the bounds."""
    b, t, h, d = F32_FUSED_BWD_SHAPE
    tag = f"B={b} T={t} H={h} D={d} float32"
    qkv = torch.randn((b, t, 3 * h * d), generator=gen, device="cuda")
    dout = torch.randn((b, t, h * d), generator=gen, device="cuda")
    o, lse = flash_attention_fused(qkv, h)
    views = qkv.view(b, t, 3, h, d).unbind(2)
    design = flash_fused_bwd_design(torch.float32, d, 1.0 / math.sqrt(d), views * 2)
    check(design == "tf32x3", f"f32 fused backward {tag}: design {design}")
    before = read_designs()
    dqkv = flash_attention_fused_bwd(qkv, o, lse, dout, h)
    again = flash_attention_fused_bwd(qkv, o, lse, dout, h)
    torch.cuda.synchronize()
    used = _used("flash_fused_bwd", before)
    check(used == {design: 2}, f"f32 fused backward {tag} by kernel {used}")
    check(_used("flash_bwd", before) == {}, f"f32 fused backward {tag}: counted under flash_bwd")
    check(torch.equal(dqkv, again), f"f32 fused backward {tag}: not bit-equal when repeated")
    want = flash_attention_fused_bwd_reference(qkv, o, lse, dout, h)
    err, scale = _rel_err(dqkv, want)
    fma_err, _ = _rel_err(_fused_kernels_bwd(qkv, o, lse, dout, h), want)
    check(err <= BWD_RTOL[torch.float32], f"f32 fused backward {tag}: error {err}")
    check(fma_err <= BWD_RTOL[torch.float32], f"f32 FMA fused backward {tag}: error {fma_err}")
    del want, dqkv, again
    ms = cuda_ms(lambda: flash_attention_fused_bwd(qkv, o, lse, dout, h), iters=10)
    fma_ms = cuda_ms(lambda: _fused_kernels_bwd(qkv, o, lse, dout, h), iters=5)
    plain_ms = cuda_ms(lambda: flash_attention_fused_bwd_reference(qkv, o, lse, dout, h),
                       iters=3, warmup=1)
    library_ms = _sdpa_bwd_ms(qkv.view(b, t, 3, h, d), dout.view(b, t, h, d), iters=10)
    bounds = attention_bwd_f32_bounds(b, t, t, h, d)
    print(f"[f32] flash_fused_bwd {tag}: kernel {design} (the general pair on the packed "
          f"row's views) {ms:.4f} ms, max rel err {err:.3e}, bit-equal when repeated; the "
          f"fused FMA kernels {fma_ms:.4f} ms (max rel err {fma_err:.3e}; tol "
          f"{BWD_RTOL[torch.float32]:.0e}); plain {plain_ms:.4f} ms, sdpa backward "
          f"{library_ms:.4f} ms, {_bounds_text(bounds)}; kernel / sdpa "
          f"{ms / library_ms:.3f} [{card}]", flush=True)
    del qkv, dout, o, lse, views
    return dict(bounds, design=design, ms=ms, fma_ms=fma_ms, plain_ms=plain_ms,
                library_ms=library_ms, max_rel_err=err, max_abs_err=err * scale,
                fma_max_rel_err=fma_err)


def _f32_p5_fwd_row(card: str, gen, shape) -> dict:
    """B3 in f32 at one (B, T, H, D) shape: through the kernel the crossover
    selects (counted); both f32 designs, tf32x3 and FMA (each chosen by
    setting the crossover), against the plain version (ATOL, LSE_ATOL) and
    bit-equal when repeated, timed through the entry (cuda_ms) and on the
    device alone (device_ms), beside the plain version, SDPA (TF32 off) and
    the bounds."""
    b, t, h, d = shape
    tag = f"B={b} T={t} H={h} D={d} float32"
    f5 = _p5_inputs(gen, b, t, h, d, torch.float32)
    design = flash_p5_fwd_design(torch.float32, 1.0 / math.sqrt(d), f5.shape)
    check(design == f32_rule(b, t, t, h, P5_TF32X3_MIN_TILES),
          f"f32 p5 forward {tag}: design {design}")
    run = lambda: flash_attention_p5_fwd(f5)  # noqa: E731
    before = read_designs()
    run()
    torch.cuda.synchronize()
    used = _used("flash_p5_fwd", before)
    check(used == {design: 1}, f"f32 p5 forward {tag} by kernel {used}")
    want, want_lse = flash_attention_p5_reference(f5)
    errs, times = {}, {}
    for name, n in (("tf32x3", 0), ("fma", FMA_ONLY)):
        with min_tiles(n):
            o, lse = run()
            again = run()
            same = torch.equal(o, again[0]) and torch.equal(lse, again[1])
            errs[name] = ((o - want).abs().max().item(), (lse - want_lse).abs().max().item())
            check(same, f"{tag}: a repeated {name} p5 forward is not bit-equal")
            check(errs[name][0] <= ATOL[torch.float32] and errs[name][1] <= LSE_ATOL,
                  f"{tag}: {name} p5 forward error {errs[name]}")
            times[name] = (cuda_ms(run, iters=50), device_ms(run), host_us(run))
    del o, lse, again, want, want_lse
    plain_ms = cuda_ms(lambda: flash_attention_p5_reference(f5), iters=10)
    q, k, v = _bhtd(f5)
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), iters=50)
    bounds = attention_f32_bounds(b, t, t, h, d)
    ms = times[design][0]
    print(f"[f32] flash_p5_fwd {tag}, {score_tiles(b, t, t, h)} score tiles: kernel "
          f"{design}; tf32x3 {times['tf32x3'][0]:.4f} ms a call as issued "
          f"({times['tf32x3'][1]:.4f} on the device; host {times['tf32x3'][2]:.1f} µs), "
          f"max|o - plain| {errs['tf32x3'][0]:.3e}, max|lse - plain| "
          f"{errs['tf32x3'][1]:.3e}; FMA kernel {times['fma'][0]:.4f} ms "
          f"({times['fma'][1]:.4f}; host {times['fma'][2]:.1f} µs), {errs['fma'][0]:.3e}, "
          f"{errs['fma'][1]:.3e} (tol "
          f"{ATOL[torch.float32]:.0e}, {LSE_ATOL:.0e}); both bit-equal when repeated; plain "
          f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, {_bounds_text(bounds)}; kernel / "
          f"sdpa {ms / library_ms:.3f} [{card}]", flush=True)
    del f5, q, k, v
    return dict(bounds, design=design, ms=ms, tf32x3_ms=times["tf32x3"][0],
                tf32x3_device_ms=times["tf32x3"][1], tf32x3_host_us=times["tf32x3"][2],
                fma_ms=times["fma"][0], fma_device_ms=times["fma"][1],
                fma_host_us=times["fma"][2], plain_ms=plain_ms, library_ms=library_ms,
                max_abs_err=errs[design][0], lse_err=errs[design][1],
                tf32x3_max_abs_err=errs["tf32x3"][0], fma_max_abs_err=errs["fma"][0])


def _fma_conv(x, wt):
    """The f32 FMA kernel of conv3x3_fwd.cu on a call the router sends to
    tf32x3: its time and error beside the 3xTF32 kernel's. Not counted (it
    is no launch of a path)."""
    n, h, w, cin = x.shape
    cout = wt.shape[-1]
    wk = wt.permute(3, 0, 1, 2).reshape(cout, 9 * cin).contiguous()
    y = torch.empty((n, h, w, cout), dtype=x.dtype, device=x.device)
    err = conv_ops._fwd_kernel()(x.data_ptr(), wk.data_ptr(), y.data_ptr(), n, h, w,
                                 cin, cout, 9 * cin, 0,
                                 torch.cuda.current_stream().cuda_stream)
    check(err == 0, f"FMA conv launch failed: CUDA error {err}")
    return y


def _top_kernel(fn) -> str:
    """The device kernel that holds most of one call of `fn` (torch.profiler),
    with its ms: which algorithm a library call ran."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    top = max((e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA),
              key=lambda e: e.self_device_time_total, default=None)
    if top is None:
        return "no kernel traced"
    return f"{top.key[:72]} {top.self_device_time_total / 1e3:.4f} ms"


def _f32_conv_row(card: str, gen, shape) -> dict:
    """B7 in f32 at one (N, H, W, Cin, Cout) shape: through the 3xTF32 kernel
    (counted, bit-equal when repeated) and the FMA kernel, each against the
    plain version (CONV_RTOL), timed through the entry (cuda_ms) and on the
    device alone (device_ms), beside the plain version, cuDNN's F.conv2d
    (TF32 off; with the algorithm cuDNN's heuristic picks and with the one
    its benchmark mode measures fastest, library_ms the faster, each with
    the kernel it ran; also on NCHW copies of x and w, the copy not timed)
    and the bounds."""
    n, hh, w, cin, cout = shape
    dtype = torch.float32
    x, wt, _ = _conv_inputs(gen, n, hh, w, cin, cout, dtype)
    design = conv3x3_design(x.shape, cout, dtype)
    check(design == "tf32x3", f"f32 conv {shape}: design {design}")
    before = read_designs()
    y = conv3x3_pallas(x, wt)
    again = conv3x3_pallas(x, wt)
    torch.cuda.synchronize()
    used = _used("conv3x3_fwd", before)
    check(used == {design: 2}, f"f32 conv {shape} by kernel {used}")
    check(torch.equal(y, again), f"f32 conv {shape} differs from run to run")
    want = conv3x3_reference(x, wt)
    err, scale = _rel_err(y, want)
    fma_err, _ = _rel_err(_fma_conv(x, wt), want)
    check(err <= CONV_RTOL[dtype], f"f32 conv {shape}: error {err}")
    check(fma_err <= CONV_RTOL[dtype], f"f32 FMA conv {shape}: error {fma_err}")
    del y, again, want
    iters = 10
    ms = cuda_ms(lambda: conv3x3_pallas(x, wt), iters=iters)
    dev_ms = device_ms(lambda: conv3x3_pallas(x, wt), iters=iters)
    fma_ms = cuda_ms(lambda: _fma_conv(x, wt), iters=iters)
    fma_dev_ms = device_ms(lambda: _fma_conv(x, wt), iters=iters)
    plain_ms = cuda_ms(lambda: conv3x3_reference(x, wt), iters=3, warmup=1)
    xc, wc = x.permute(0, 3, 1, 2), wt.permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    cudnn_ms, cudnn_kernel = {}, {}
    xn, wn = xc.contiguous(), wc.contiguous()
    benchmark = torch.backends.cudnn.benchmark
    try:
        for mode in (False, True):
            torch.backends.cudnn.benchmark = mode
            cudnn_ms[mode] = cuda_ms(lambda: F.conv2d(xc, wc, padding=1), iters=iters)
            cudnn_kernel[mode] = _top_kernel(lambda: F.conv2d(xc, wc, padding=1))
        nchw_ms = cuda_ms(lambda: F.conv2d(xn, wn, padding=1), iters=iters)
        nchw_kernel = _top_kernel(lambda: F.conv2d(xn, wn, padding=1))
    finally:
        torch.backends.cudnn.benchmark = benchmark
    library_ms = min(cudnn_ms.values())
    nbytes = n * hh * w * (cin + cout) * 4 + 9 * cin * cout * 4
    bounds = f32_bounds(nbytes, 2 * 9 * cin * cout * n * hh * w)
    print(f"[f32] conv3x3_fwd {shape}: kernel tf32x3 (tiling "
          f"{conv3x3_tf32x3_tiling(hh, w, cout)}) {ms:.4f} ms a call ({dev_ms:.4f} on the "
          f"device), max rel err {err:.3e} of {scale:.3f}, bit-equal when repeated; FMA "
          f"kernel {fma_ms:.4f} ms ({fma_dev_ms:.4f}), max rel err {fma_err:.3e} (tol "
          f"{CONV_RTOL[dtype]:.0e}); plain {plain_ms:.4f} ms, cuDNN {cudnn_ms[False]:.4f} "
          f"ms (heuristic: {cudnn_kernel[False]}), {cudnn_ms[True]:.4f} ms (benchmark "
          f"mode: {cudnn_kernel[True]}), on NCHW copies {nchw_ms:.4f} ms ({nchw_kernel}), "
          f"{_bounds_text(bounds)}; kernel / cuDNN {ms / library_ms:.3f}, kernel / bound "
          f"{ms / bounds['bound_ms']:.2f} [{card}]", flush=True)
    del x, wt, xc, wc, xn, wn
    return dict(bounds, design=design, ms=ms, device_ms=dev_ms, fma_ms=fma_ms,
                fma_device_ms=fma_dev_ms, plain_ms=plain_ms, library_ms=library_ms,
                cudnn_heuristic_ms=cudnn_ms[False], cudnn_benchmark_ms=cudnn_ms[True],
                cudnn_nchw_ms=nchw_ms,
                max_rel_err=err, max_abs_err=err * scale, fma_max_rel_err=fma_err)


def _fma_p5_bwd(f5, out, lse, dout):
    """The f32 FMA kernels of flash_p5_bwd.cu on a call the router sends to
    tf32x3: their time and error beside the 3xTF32 pair's. Not counted
    (they are no launch of a path)."""
    b, _, h, d, t = f5.shape
    delta = torch.empty((b * h, t), dtype=torch.float32, device=f5.device)
    dqkv = torch.empty_like(f5)
    err = flash_ops._p5_bwd_kernel()(f5.data_ptr(), out.data_ptr(), dout.data_ptr(),
                                     lse.data_ptr(), delta.data_ptr(), dqkv.data_ptr(),
                                     b, h, d, t, 1.0 / math.sqrt(d), 0,
                                     torch.cuda.current_stream().cuda_stream)
    check(err == 0, f"FMA p5 backward launch failed: CUDA error {err}")
    return dqkv


def _f32_p5_bwd_row(card: str, gen, shape) -> dict:
    """B4 in f32 at one (B, T, H, D) shape: through the 3xTF32 pair
    (counted) and the FMA kernels (called directly), each against the plain
    version (BWD_RTOL of max|dqkv|) and bit-equal when repeated, timed
    through the entry (cuda_ms) and on the device alone (device_ms), beside
    the plain version, SDPA's backward (TF32 off) and the bounds."""
    b, t, h, d = shape
    dtype = torch.float32
    tag = f"B={b} T={t} H={h} D={d} float32"
    f5 = _p5_inputs(gen, b, t, h, d, dtype)
    dout = torch.randn((b * h, d, t), generator=gen, device="cuda")
    o, lse = flash_attention_p5_fwd(f5)
    design = flash_p5_bwd_design(dtype, d, 1.0 / math.sqrt(d))
    check(design == "tf32x3", f"f32 p5 backward {tag}: design {design}")
    run = lambda: flash_attention_p5_bwd(f5, o, lse, dout)  # noqa: E731
    before = read_designs()
    run()
    torch.cuda.synchronize()
    used = _used("flash_p5_bwd", before)
    check(used == {design: 1}, f"f32 p5 backward {tag} by kernel {used}")
    want = flash_attention_p5_bwd_reference(f5, o, lse, dout)
    errs, abs_errs, times = {}, {}, {}
    for name, fn in (("tf32x3", run), ("fma", lambda: _fma_p5_bwd(f5, o, lse, dout))):
        got = fn()
        again = fn()
        same = torch.equal(got, again)
        errs[name] = _p5_rel_err(got, want)
        abs_errs[name] = (got - want).abs().max().item()
        check(same, f"{tag}: a repeated {name} p5 backward is not bit-equal")
        check(errs[name] <= BWD_RTOL[dtype], f"{tag}: {name} p5 backward error "
              f"{errs[name]}")
        times[name] = (cuda_ms(fn, iters=10), device_ms(fn, iters=10))
    del got, again, want
    plain_ms = cuda_ms(lambda: flash_attention_p5_bwd_reference(f5, o, lse, dout),
                       iters=3, warmup=1)
    q, k, v = (x.requires_grad_(True) for x in _bhtd(f5))
    sdpa_out = F.scaled_dot_product_attention(q, k, v)
    g4 = dout.view(b, h, d, t).transpose(-1, -2)
    library_ms = cuda_ms(lambda: torch.autograd.grad(sdpa_out, (q, k, v), g4,
                                                     retain_graph=True), iters=10)
    bounds = attention_bwd_f32_bounds(b, t, t, h, d)
    ms = times[design][0]
    print(f"[f32] flash_p5_bwd {tag}, {score_tiles(b, t, t, h)} score tiles: kernel "
          f"{design} {ms:.4f} ms a call ({times[design][1]:.4f} on the device), max rel "
          f"err {errs[design]:.3e}; FMA kernels {times['fma'][0]:.4f} ms "
          f"({times['fma'][1]:.4f}), max rel err {errs['fma']:.3e} (tol "
          f"{BWD_RTOL[dtype]:.0e}); both bit-equal when repeated; plain {plain_ms:.4f} ms, "
          f"sdpa backward {library_ms:.4f} ms, {_bounds_text(bounds)}; kernel / sdpa "
          f"{ms / library_ms:.3f}, kernel / bound {ms / bounds['bound_ms']:.2f} [{card}]",
          flush=True)
    del f5, dout, o, lse, q, k, v, sdpa_out, g4
    return dict(bounds, design=design, ms=ms, tf32x3_ms=times["tf32x3"][0],
                tf32x3_device_ms=times["tf32x3"][1], fma_ms=times["fma"][0],
                fma_device_ms=times["fma"][1], plain_ms=plain_ms, library_ms=library_ms,
                max_rel_err=errs[design], max_abs_err=abs_errs[design],
                tf32x3_max_rel_err=errs["tf32x3"], fma_max_rel_err=errs["fma"])


def phase_f32_rows(card: str) -> dict:
    """3j: the f32 calls of the kernels that choose by the call, where the
    f32 paths run them, for the order of the next redesigns: B3 and B4 at
    the classifier's 16 px blocks (F32_P5_SHAPE), B3 also at LDM's
    sampling batch and on either side of the crossover (F32_P5_FWD_SHAPES),
    B4 also at LDM's (128, 256, 16, 32) and at 288 tiles
    (F32_P5_BWD_SHAPES), both designs timed at each; B6 at the
    classifier's three shapes (CLF_GENERAL_F32: tf32x3 at its 32 px blocks,
    FMA below the crossover) and on either side of the crossover
    (CROSSOVER_F32), both designs timed at each; B7 at the classifier's
    64 px 192 -> 192 and 16 px 576 -> 576 convs and ADM-64's f32 training
    batch (F32_CONV_SHAPES, tf32x3 beside its FMA kernel); B8 at ADM-64's
    f32 gradient
    check and training batch (F32_WGRAD_SHAPES, tf32x3) beside its FMA
    kernel; B2 at DiT-B/2's training shape (F32_FUSED_BWD_SHAPE, the
    general pair's tf32x3 on its packed row) beside its FMA kernels. Each
    counted, against its
    plain version, beside the plain version, the library call (SDPA's
    backward; cuDNN's F.conv2d and conv2d_weight; TF32 off) and the bytes,
    3xTF32 and FMA bounds. Returns {kernel name: record}, each with its
    shapes' records."""
    check(not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32,
          "TF32 is on")
    dtype = torch.float32
    rows = _p5_pair(card, "f32", F32_P5_SHAPE, F32_P5_SHAPE[0], dtype)
    gen = torch.Generator(device="cuda").manual_seed(12)
    shapes = {f"B={b} T={t} H={h} D={d}": _f32_p5_fwd_row(card, gen, (b, t, h, d))
              for (b, t, h, d) in F32_P5_FWD_SHAPES}
    rows["flash_p5_fwd"] = dict(next(iter(shapes.values())), shapes=shapes)
    shapes = {f"B={b} Tq={tq} Tk={tk} H={h} D={d}": _f32_general_bwd_row(
        card, gen, (b, tq, tk, h, d, packed))
        for (b, tq, tk, h, d, packed) in CLF_GENERAL_F32 + CROSSOVER_F32}
    rows["flash_bwd"] = dict(next(iter(shapes.values())), shapes=shapes)
    shapes = {f"B={b} T={t} H={h} D={d}": _f32_p5_bwd_row(card, gen, (b, t, h, d))
              for (b, t, h, d) in F32_P5_BWD_SHAPES}
    rows["flash_p5_bwd"] = dict(next(iter(shapes.values())), shapes=shapes)
    shapes = {str(shape): _f32_wgrad_row(card, gen, shape) for shape in F32_WGRAD_SHAPES}
    rows["conv3x3_wgrad"] = dict(next(iter(shapes.values())), shapes=shapes)
    shapes = {str(shape): _f32_conv_row(card, gen, shape) for shape in F32_CONV_SHAPES}
    rows["conv3x3_fwd"] = dict(next(iter(shapes.values())), shapes=shapes)
    torch.cuda.empty_cache()
    rows["flash_fused_bwd"] = _f32_fused_bwd_row(card, gen)
    torch.cuda.empty_cache()
    return rows


def seeded_dit_b(learn_sigma: bool = False) -> torch.nn.Module:
    """DiT-B/2 with f32 master weights from a seed; the zero-initialised
    adaLN modulation and head get small seeded noise so that samples are
    not just the scaled input noise."""
    torch.manual_seed(0)
    model = DiT_B(image_size=32, patch_size=2, in_channels=4,
                  class_dropout_prob=0.1, num_classes=1000,
                  learn_sigma=learn_sigma).cuda()
    heads = [blk.adaLN_modulation[1] for blk in model.blocks] + [
        model.final_layer.adaLN_modulation[1], model.final_layer.linear]
    with torch.no_grad():
        for lin in heads:
            lin.weight.normal_(0.0, 0.02)
            lin.bias.normal_(0.0, 0.02)
    return model.eval()


def seeded_uvit_l() -> torch.nn.Module:
    """U-ViT-L/2 with f32 weights from a seed (the JAX model's initialisers)."""
    torch.manual_seed(0)
    return UViT_L(image_size=32, patch_size=2, in_channels=4, num_classes=1000,
                  class_dropout_prob=0.1).cuda().eval()


def _vit_b():
    return ViT_B(image_size=32, patch_size=2, in_channels=4, num_classes=1000,
                 learn_sigma=False, drop_label_prob=0.1)


def seeded_vit_b() -> torch.nn.Module:
    """ViT-B/2 with f32 weights from a seed (the JAX model's initialisers;
    its head is damped by init_scale 0.001, as in training)."""
    torch.manual_seed(0)
    return _vit_b().cuda().eval()


def _mmdit_b():
    """MM-DiT-B/2 as the registry builds it: depth 24, hidden 32 * 24 = 768,
    24 heads of 32; on 32x32x3 images with 10 classes (the Shapes data)."""
    return MMDiT(image_size=32, patch_size=2, in_channels=3, hidden_size=768,
                 depth=24, num_heads=24, num_classes=10, class_dropout_prob=0.1)


def seeded_mmdit_b() -> torch.nn.Module:
    """MM-DiT-B/2 with f32 weights from a seed; the zero-initialised adaLN
    modulations and head get small seeded noise, so that no block is the
    identity and the output is not zero."""
    torch.manual_seed(0)
    model = _mmdit_b().cuda()
    heads = [stream.adaLN_modulation[1] for blk in model.joint_blocks
             for stream in (blk.context_block, blk.x_block)] + [
        model.final_layer.adaLN_modulation[1], model.final_layer.linear]
    with torch.no_grad():
        for lin in heads:
            lin.weight.normal_(0.0, 0.02)
            lin.bias.normal_(0.0, 0.02)
    return model.eval()


def seeded_unet(ctor) -> torch.nn.Module:
    """A UNet with f32 weights from a seed (the JAX model's initialisers);
    the zero-initialised ResBlock output convs, attention projections and
    final conv get small seeded noise so that no block is the identity and
    the output is not zero."""
    torch.manual_seed(0)
    model = ctor().cuda()
    zero = [model.out[2]] + [m.proj_out for m in model.modules()
                             if isinstance(m, unet_module.AttentionBlock)] + [
        m.out_layers[3] for m in model.modules() if isinstance(m, unet_module.ResBlock)]
    with torch.no_grad():
        for layer in zero:
            layer.weight.normal_(0.0, 0.02)
            layer.bias.normal_(0.0, 0.02)
    return model.eval()


def _plain_fused(qkv2d, num_heads, scale=None):
    return flash_attention_fused_reference(qkv2d, num_heads, scale)[0]


def _plain_packed(qkv, scale=None):
    return flash_attention_reference(*qkv.unbind(2), scale)[0]


def _plain_general(q, k, v, scale=None):
    return flash_attention_reference(q, k, v, scale)[0]


def _out(o):
    """A model's prediction: MM-DiT returns (out, zs)."""
    return o[0] if isinstance(o, tuple) else o


class Family(NamedTuple):
    """One model's path through the phases: its CLI model flags, the
    launches of each kernel in one forward and in one backward of the model,
    its batches, how to build it, the entries to replace with their plain
    versions for the plain route (each a mock.patch.object triple), its
    input image shape and the environment its phases run under."""
    tag: str
    model_args: list
    fwd: dict
    bwd: dict
    train_batch: int
    grad_batch: int
    seeded: Callable[[], torch.nn.Module]
    ctor: Callable[..., torch.nn.Module]
    plain: tuple
    image: tuple = (32, 32, 4)
    env: dict = {}
    # Launches of an f32 forward and backward where they differ (the conv
    # gate's budget depends on the dtype's size).
    fwd_f32: dict = None
    bwd_f32: dict = None
    # Launches by kernel in one bf16 forward and backward, {kernel name:
    # {design: launches}}, for the kernels of DESIGNS on the path.
    fwd_design: dict = {}
    bwd_design: dict = {}
    # The train phase's flags after the model's: the flagship recipe unless
    # given, then `train_extra`.
    recipe: list = None
    train_extra: list = []
    # Labels drawn in the model and grad phases; the train phase's losses
    # must fall: the mean of the last `fall_window` below that of the first.
    classes: int = 1000
    fall_window: int = 1
    # Channels of the sampled PNGs where they differ from the image's (3
    # after an SD-VAE decode of 4-channel latents).
    png_channels: int = 0
    # In f32: each attention call of a forward, (forward kernel, backward
    # kernel, T, H, calls), whose kernels the crossover picks by batch
    # (f32_rule), and every other f32 launch by kernel of one forward and
    # one backward, {kernel name: {design: launches}}.
    f32_attention: tuple = ()
    f32_design: tuple = ({}, {})

    @property
    def f32(self) -> tuple:
        return self.fwd_f32 or self.fwd, self.bwd_f32 or self.bwd


@contextlib.contextmanager
def plain_route(fam: Family):
    with contextlib.ExitStack() as stack:
        for target in fam.plain:
            stack.enter_context(mock.patch.object(*target))
        yield


@contextlib.contextmanager
def environment(env: dict):
    """os.environ with `env` set, restored on exit."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


MODEL_ARGS = ["--image_size", "32", "--patch_size", "2", "--in_chans", "4",
              "--num_classes", "1000", "--class_cond", "True",
              "--drop_label_prob", "0.1", "--amp", "True"]
RECIPE_ARGS = ["--dataset", "Gaussian", "--weight_type", "lambda", "--mean_type",
               "EPSILON", "--path_type", "cosine", "--betas", "0.9", "0.95",
               "--total_steps", str(TRAIN_STEPS), "--eval", "False",
               "--sample_freq", "0", "--save_step", str(TRAIN_STEPS)]
# DiT-B/2: T = 256, 12 heads of 64, 12 blocks, through the fused p6 kernels.
DIT = Family("DiT-B/2", ["--model", "DiT-B"] + MODEL_ARGS, {"flash_fused_fwd": 12},
             {"flash_fused_bwd": 12}, DIT_TRAIN_BATCH, 32, seeded_dit_b,
             lambda: DiT_B(image_size=32, patch_size=2, in_channels=4,
                           class_dropout_prob=0.1, num_classes=1000, learn_sigma=False),
             ((model_layers, "self_attention_qkv2d", _plain_fused),),
             # bf16: every fused forward on its TMA + wgmma kernel, every
             # fused backward on the general TMA + wgmma pair.
             fwd_design={"flash_fused_fwd": {"wgmma": 12}},
             bwd_design={"flash_fused_bwd": {"wgmma": 12}},
             # f32: the fused forward and backward by the crossover.
             f32_attention=(("flash_fused_fwd", "flash_fused_bwd", T_MAIN, H_MAIN, 12),))
# U-ViT-L/2: T = 1 label + 1 time + 256 patch tokens = 258, 16 heads of 64,
# 21 blocks (10 in, 1 mid, 10 out), through the general-T kernels; batch
# 128 in the train phase (phase 23 trains the recipe's 256 rematted).
UVIT = Family("U-ViT-L/2", ["--model", "U-ViT-L"] + MODEL_ARGS, {"flash_fwd": 21},
              {"flash_bwd": 21}, 128, 16, seeded_uvit_l,
              lambda: UViT_L(image_size=32, patch_size=2, in_channels=4,
                             num_classes=1000, class_dropout_prob=0.1),
              ((uvit_module, "multi_head_attention_packed", _plain_packed),),
              # bf16: every general forward and backward on TMA + wgmma.
              fwd_design={"flash_fwd": {"wgmma": 21}},
              bwd_design={"flash_bwd": {"wgmma": 21}},
              f32_attention=(("flash_fwd", "flash_bwd", 258, 16, 21),))
# LDM: 16 attention blocks a forward, heads of 32 channels: 5 at 16x16
# (T = 256, 16 heads) through the p5 kernels, 5 at 32x32 (T = 1024, 8 heads)
# and 6 at 8x8 (T = 64, 32 heads) through the general ones; batch 256 in
# training.
def _ldm():
    return LDM(num_classes=1000, in_channels=4, drop_label_prob=0.1)


LDM_FAMILY = Family("LDM", ["--model", "LDM"] + MODEL_ARGS,
                    {"flash_p5_fwd": 5, "flash_fwd": 11},
                    {"flash_p5_bwd": 5, "flash_bwd": 11}, LDM_TRAIN_BATCH, 16,
                    lambda: seeded_unet(_ldm), _ldm,
                    ((unet_module, "multi_head_attention_packed", _plain_packed),),
                    # bf16: every p5 and every general forward and backward
                    # on the TMA + wgmma kernels.
                    fwd_design={"flash_p5_fwd": {"wgmma": 5}, "flash_fwd": {"wgmma": 11}},
                    bwd_design={"flash_p5_bwd": {"wgmma": 5}, "flash_bwd": {"wgmma": 11}},
                    # f32: the p5 and the general kernels, both
                    # directions, by the crossover (the p5 backward on
                    # tf32x3 at every size).
                    f32_attention=(("flash_fwd", "flash_bwd", 1024, 8, 5),
                                   ("flash_fwd", "flash_bwd", 64, 32, 6),
                                   ("flash_p5_fwd", "flash_p5_bwd", 256, 16, 5)))


# ADM-64: pixel space, 64x64x3, 192 channels, mult (1, 2, 3, 4), 3 res
# blocks a level, attention at 32, 16 and 8 px with heads of 64, 295.9M
# parameters, under VAW_PALLAS_CONV=1. A forward sends 30 of its 71
# stride-1 3x3 convs through the conv kernel (the JAX gate's choice; the
# rest, all at 8 px or past the gate's budget, go to cuDNN) and its 22
# attention blocks (T = 1024, 256, 64) through the general kernels: at
# T = 256 with nine heads of 64 the p5 gate admits only B in {1, 2, 4}. A
# backward runs 29 dgrads (none for the image at the stem) and 30 wgrads.
# In f32 the gate's budget admits 26 (not the 64 px 384 -> 192 convs and the
# 16 px 384 -> 576 one).
def _adm64():
    return ADM_64(num_classes=1000, in_channels=3, drop_label_prob=0.1)


ADM64 = Family("ADM-64", ["--model", "ADM-64", "--image_size", "64", "--in_chans", "3",
                          "--num_classes", "1000", "--class_cond", "True",
                          "--drop_label_prob", "0.1", "--amp", "True"],
               {"conv3x3_fwd": 30, "flash_fwd": 22},
               {"conv3x3_fwd": 29, "conv3x3_wgrad": 30, "flash_bwd": 22},
               ADM_TRAIN_BATCH, 16, lambda: seeded_unet(_adm64), _adm64,
               ((unet_module, "multi_head_attention_packed", _plain_packed),
                (unet_module, "conv3x3", conv3x3_reference)),
               image=(64, 64, 3), env={"VAW_PALLAS_CONV": "1"},
               fwd_f32={"conv3x3_fwd": 26, "flash_fwd": 22},
               bwd_f32={"conv3x3_fwd": 25, "conv3x3_wgrad": 26, "flash_bwd": 22},
               # bf16: Cin and Cout multiples of 64 on wgmma, the 3-channel
               # stem on mma.sync, the f32 head (its dgrad and wgrad) on FMAs;
               # every general forward and backward on wgmma.
               fwd_design={"conv3x3_fwd": {"wgmma": 28, "mma_sync": 1, "fma": 1},
                           "flash_fwd": {"wgmma": 22}},
               bwd_design={"conv3x3_fwd": {"wgmma": 28, "fma": 1},
                           "conv3x3_wgrad": {"wgmma": 28, "mma_sync": 1, "fma": 1},
                           "flash_bwd": {"wgmma": 22}},
               # f32: 7 general calls at 32 px (6 heads), 7 at 16 px (9) and
               # 8 at 8 px (12) by the crossover; the convs, dgrads and
               # wgrads with Cin and Cout multiples of 64 on tf32x3, the
               # stem's and the head's on FMAs.
               f32_attention=(("flash_fwd", "flash_bwd", 1024, 6, 7),
                              ("flash_fwd", "flash_bwd", 256, 9, 7),
                              ("flash_fwd", "flash_bwd", 64, 12, 8)),
               f32_design=({"conv3x3_fwd": {"tf32x3": 24, "fma": 2}},
                           {"conv3x3_fwd": {"tf32x3": 24, "fma": 1},
                            "conv3x3_wgrad": {"tf32x3": 24, "fma": 2}}))


# ViT-B/2: T = 256 patches + a time and a class token = 258, 12 heads of 64,
# 12 blocks, through the packed entry and the general-T kernels; trained
# under the flagship recipe with the loss-aware timestep resampler.
VIT = Family("ViT-B/2", ["--model", "ViT-B"] + MODEL_ARGS, {"flash_fwd": 12},
             {"flash_bwd": 12}, 256, 16, seeded_vit_b, _vit_b,
             ((vit_module, "multi_head_attention_packed", _plain_packed),),
             fwd_design={"flash_fwd": {"wgmma": 12}},
             bwd_design={"flash_bwd": {"wgmma": 12}},
             train_extra=["--time_sampler", "loss-second-moment"],
             f32_attention=(("flash_fwd", "flash_bwd", 258, 12, 12),))
# MM-DiT-B/2: 24 joint blocks of width 768, 24 heads of 32, joint attention
# over a one-token context and 256 patches (T = 257) through the general-T
# kernels on q, k and v concatenated from the two streams; trained with
# rectified flow (SD3's recipe: linear path, VECTOR target) and the lambda
# weight, sampled with the flow SDE and ODE. It runs on the Shapes data,
# 32x32x3 with 10 classes (the same T): on the Gaussian stand-in the data
# is the noise law itself, so the flow target n - x0 has no part that a
# head blind to t can learn first, and the loss stays at 2 for far more
# than 30 steps.
MMDIT_TRAIN_BATCH = 256
FLOW_ARGS = ["--model_mode", "flow", "--path_type", "linear", "--mean_type", "VECTOR"]
MMDIT = Family("MM-DiT-B/2", ["--model", "MM-DiT-B", "--image_size", "32", "--patch_size",
                              "2", "--in_chans", "3", "--num_classes", "10",
                              "--class_cond", "True", "--drop_label_prob", "0.1",
                              "--amp", "True"],
               {"flash_fwd": 24}, {"flash_bwd": 24}, MMDIT_TRAIN_BATCH, 16,
               seeded_mmdit_b, _mmdit_b,
               ((mmdit_module, "multi_head_attention", _plain_general),),
               image=(32, 32, 3),
               fwd_design={"flash_fwd": {"wgmma": 24}},
               bwd_design={"flash_bwd": {"wgmma": 24}},
               f32_attention=(("flash_fwd", "flash_bwd", 257, 24, 24),),
               recipe=[("Shapes" if a == "Gaussian" else a) for a in RECIPE_ARGS
                       if a not in ("--mean_type", "EPSILON", "--path_type", "cosine")]
               + FLOW_ARGS,
               classes=10, fall_window=5)
# DiT-B/2 with learned variance: a 2C-channel head, LEARNED_RANGE, the vb
# term beside the MSE; the same 12 fused kernels a forward and a backward.
LV_ARGS = ["--learn_sigma", "True", "--var_type", "LEARNED_RANGE"]
DIT_LV = DIT._replace(
    tag="DiT-B/2 learned variance", model_args=DIT.model_args + LV_ARGS,
    seeded=lambda: seeded_dit_b(learn_sigma=True),
    ctor=lambda: DiT_B(image_size=32, patch_size=2, in_channels=4,
                       class_dropout_prob=0.1, num_classes=1000, learn_sigma=True))
KL_STEPS = 8


def expect(*per_call: tuple) -> dict:
    """Every kernel's expected launches, from (launches per model call,
    calls) pairs: the sums for the kernels named, 0 for the others."""
    want = dict.fromkeys(COUNTERS, 0)
    for counts, calls in per_call:
        for name, n in counts.items():
            want[name] += n * calls
    return want


def expect_designs(*per_call: tuple) -> dict:
    """Every kernel's expected launches by design, from ({kernel: {design:
    launches}} per model call, calls) pairs; 0 for the others."""
    want = {name: dict.fromkeys(designs, 0) for name, designs in DESIGNS.items()}
    for counts, calls in per_call:
        for name, by_design in counts.items():
            for design, n in by_design.items():
                want[name][design] += n * calls
    return want


# Samples/s of each batch by family tag, from phase_sample.
SAMPLE_RATES: dict = {}


def phase_sample(card: str, fam: Family, model: torch.nn.Module) -> dict:
    finite, batch_s = [], []
    inverse_normalize = sampler_driver._inverse_normalize
    edm_batch = sampler_driver.Sampler._edm_batch

    def checked_inverse_normalize(x):
        finite.append(bool(torch.isfinite(x).all().item()))
        return inverse_normalize(x)

    def timed_edm_batch(self, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = edm_batch(self, *args, **kwargs)
        torch.cuda.synchronize()
        batch_s.append(time.perf_counter() - t0)
        return out

    # Heun: 2 * 18 - 1 model calls per batch.
    calls = (2 * STEPS - 1) * (NUM_SAMPLES // SAMPLE_SIZE)
    want = expect((fam.fwd, calls))
    want_designs = expect_designs((fam.fwd_design, calls))
    with tempfile.TemporaryDirectory(prefix="vaw_chip_smoke_") as tmp:
        ckpt = Path(tmp) / "ema.pt"
        state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
        torch.save({"ema": state, "step": 0}, ckpt)
        out_dir = Path(tmp) / "samples"
        argv = fam.model_args + [
            "--solver", "heun", "--discretization", "edm", "--sample_steps", str(STEPS),
            "--guidance_scale", "1.5", "--sample_size", str(SAMPLE_SIZE),
            "--num_samples", str(NUM_SAMPLES), "--resume", str(ckpt),
            "--save_path", str(out_dir)]
        with mock.patch.object(sampler_driver, "_inverse_normalize",
                               checked_inverse_normalize), \
                mock.patch.object(sampler_driver.Sampler, "_edm_batch", timed_edm_batch):
            reset_launches()
            t0 = time.perf_counter()
            sample_cli.main(argv)
            wall = time.perf_counter() - t0
            counts = read_launches()
            designs = read_designs()
        pngs = list(out_dir.rglob("*.png"))
        channels = _png_channels(pngs)
    print(f"[sample] {fam.tag}: {len(pngs)} PNGs of {channels} channels, finite before "
          f"uint8 per batch "
          f"{finite}, launches {counts} (expected {want})")
    check(len(pngs) == NUM_SAMPLES, f"{len(pngs)} PNGs, expected {NUM_SAMPLES}")
    png_channels = fam.png_channels or fam.image[-1]
    check(channels == {png_channels}, f"{fam.tag}: PNGs of {channels} channels, "
          f"expected {png_channels}")
    check(len(finite) == NUM_SAMPLES // SAMPLE_SIZE and all(finite),
          f"{fam.tag}: non-finite samples before the uint8 cast")
    check(counts == want, f"{fam.tag} sampling launches {counts}, expected {want}")
    print(f"[sample] {fam.tag}: launches by kernel {designs} (expected "
          f"{want_designs})")
    check(designs == want_designs, f"{fam.tag} sampling launches by kernel "
          f"{designs}, expected {want_designs}")
    SAMPLE_RATES[fam.tag] = [SAMPLE_SIZE / s for s in batch_s]
    per_batch = ", ".join(f"{SAMPLE_SIZE / s:.2f}" for s in batch_s)
    print(f"[sample] {fam.tag} EDM Heun {STEPS} steps CFG 1.5 bf16, batches of "
          f"{SAMPLE_SIZE}: samples/s per batch [{per_batch}] (first includes "
          f"warm-up), CLI wall {wall:.2f} s for {NUM_SAMPLES} [{card}]", flush=True)
    return counts, designs


def _png_channels(pngs) -> set:
    """The channel counts of the first PNGs (1 for a grey image)."""
    arrays = [np.asarray(Image.open(p)) for p in pngs[:4]]
    return {a.shape[2] if a.ndim == 3 else 1 for a in arrays}


FLOW_SAMPLERS = (("sde", "heun"), ("ode", "heun"), ("ode", "dopri5"))


def phase_sample_flow(card: str, fam: Family, model: torch.nn.Module) -> dict:
    """The flow sampling path through vaw_torch.cli.sample.main: one batch of
    64 (128 rows with CFG 1.5) with the SDE (Heun, STEPS steps: 2 * STEPS - 1
    model calls), the ODE (Heun: 2 * (STEPS - 1) calls) and the adaptive
    dopri5 ODE (rtol 1e-3, atol 1e-6: 1 + 6 calls an attempt), each with
    its launches counted exactly and its samples finite."""
    paths = {}
    flow_batch = sampler_driver.Sampler._flow_batch
    inverse_normalize = sampler_driver._inverse_normalize
    with tempfile.TemporaryDirectory(prefix="vaw_chip_flow_") as tmp:
        ckpt = Path(tmp) / "ema.pt"
        torch.save({"ema": {k: v.detach().cpu() for k, v in model.state_dict().items()},
                    "step": 0}, ckpt)
        for sampler_type, solver in FLOW_SAMPLERS:
            finite, batch_s, samplers = [], [], []

            def checked_inverse_normalize(x):
                finite.append(bool(torch.isfinite(x).all().item()))
                return inverse_normalize(x)

            def timed_flow_batch(self, *args, **kwargs):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = flow_batch(self, *args, **kwargs)
                torch.cuda.synchronize()
                batch_s.append(time.perf_counter() - t0)
                samplers.append(self)
                return out

            out_dir = Path(tmp) / f"{sampler_type}_{solver}"
            argv = fam.model_args + FLOW_ARGS + [
                "--sampler_type", sampler_type, "--solver", solver,
                "--sample_steps", str(STEPS), "--guidance_scale", "1.5",
                "--sample_size", str(SAMPLE_SIZE), "--num_samples", str(SAMPLE_SIZE),
                "--resume", str(ckpt), "--save_path", str(out_dir)]
            with mock.patch.object(sampler_driver, "_inverse_normalize",
                                   checked_inverse_normalize), \
                    mock.patch.object(sampler_driver.Sampler, "_flow_batch",
                                      timed_flow_batch):
                reset_launches()
                sample_cli.main(argv)
                counts, designs = read_launches(), read_designs()
            pngs = list(out_dir.rglob("*.png"))
            steps = samplers[0].last_dopri5
            if solver == "dopri5":
                calls = 1 + 6 * (steps["accepted"] + steps["rejected"])
            else:
                calls = 2 * (STEPS - 1) + int(sampler_type == "sde")
            want = expect((fam.fwd, calls))
            want_designs = expect_designs((fam.fwd_design, calls))
            tag = f"{fam.tag} flow {sampler_type.upper()} {solver}"
            extra = (f", dopri5 {steps['accepted']} accepted and {steps['rejected']} "
                     f"rejected steps (t = {steps['t']:.3g} at the end)"
                     if solver == "dopri5" else "")
            print(f"[sample-flow] {tag}: {len(pngs)} PNGs, finite {finite}, {calls} model "
                  f"calls{extra}; launches {counts} (expected {want}); by kernel {designs}; "
                  f"{SAMPLE_SIZE / batch_s[0]:.2f} samples/s (one batch of {SAMPLE_SIZE}, "
                  f"CFG 1.5, bf16, {batch_s[0]:.3f} s, first call includes warm-up) "
                  f"[{card}]", flush=True)
            check(len(pngs) == SAMPLE_SIZE and finite == [True],
                  f"{tag}: {len(pngs)} PNGs, finite {finite}")
            check(counts == want, f"{tag} launches {counts}, expected {want}")
            check(designs == want_designs, f"{tag} launches by kernel {designs}, "
                  f"expected {want_designs}")
            if solver == "dopri5":
                check(steps["t"] <= 1e-6, f"{tag}: dopri5 did not reach t = 0")
            paths[f"sample_mmdit_{sampler_type}_{solver}"] = (counts, designs)
    return paths


def phase_kl(card: str) -> tuple:
    """A few DiT-B/2 steps with learned variance under --loss_type KL (the
    variational bound alone) through the CLI: finite losses and the fused
    kernels' exact launches."""
    argv = DIT_LV.model_args + RECIPE_ARGS + ["--loss_type", "KL"]
    for flag, value in (("--total_steps", KL_STEPS), ("--save_step", 0)):
        argv[argv.index(flag) + 1] = str(value)
    with tempfile.TemporaryDirectory(prefix="vaw_chip_kl_") as tmp:
        run = run_train_cli(argv + ["--batch_size", str(DIT_TRAIN_BATCH), "--logdir", tmp])
        free(run)
    check_run("train DiT-B/2 KL", run, KL_STEPS, DIT.fwd, DIT.bwd, DIT.fwd_design,
              DIT.bwd_design)
    print(f"[train] DiT-B/2 learned variance, loss KL, batch {DIT_TRAIN_BATCH}: losses "
          f"{[round(v, 5) for v in run['losses']]}, {run['imgs_per_s']:.2f} imgs/s over "
          f"steps {TRAIN_WARMUP + 1}-{KL_STEPS} [{card}]", flush=True)
    return run["launches"], run["designs"]


def phase_model(fam: Family, model: torch.nn.Module):
    """One forward at B=128 through the kernel, in f32 and in the sampler's
    bf16 copy, against the f32 forward through the plain attention."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    b = 2 * SAMPLE_SIZE
    x = torch.randn((b, *fam.image), generator=gen, device="cuda")
    t = torch.rand((b,), generator=gen, device="cuda") * 999
    y = torch.randint(0, fam.classes, (b,), generator=gen, device="cuda")
    with torch.inference_mode():
        with plain_route(fam):
            want = _out(model(x, t, y))
        before = read_launches()
        got_f32 = _out(model(x, t, y))
        launched = {k: n - before[k] for k, n in read_launches().items()}
        fwd_f32 = fam.f32[0]
        check(launched == expect((fwd_f32, 1)),
              f"{fam.tag}: the kernel route launched {launched}, expected {fwd_f32}")
        got_bf16 = _out(cast_for_compute(model, torch.bfloat16)(x, t, y))
    scale = want.abs().max().item()
    for name, got, tol in (("f32", got_f32, MODEL_F32_RTOL),
                           ("bf16", got_bf16, MODEL_BF16_RTOL)):
        rel = (got - want).abs().max().item() / scale
        print(f"[model] {fam.tag} B={b} {name} kernels vs f32 plain route: max rel "
              f"err {rel:.3e} (tol {tol:.0e}), max|out| {scale:.3f}", flush=True)
        check(math.isfinite(rel) and rel <= tol, f"{fam.tag}: {name} forward disagrees")


# The data, remat and host-path phases (20-24): DiT-B/2 on a seeded
# CIFAR-10-layout archive and a seeded latent HDF5 file, both written to a
# temporary directory; remat of DiT-B/2 and U-ViT-L/2.
CIFAR_ROWS, CIFAR_STEPS, CIFAR_SAVE = 2048, 30, 15
LATENT_ITEMS, LATENT_STEPS = 12288, 40
REMAT_STEPS, UVIT_REMAT_BATCH = 10, 256
CIFAR_ARGS = ["--model", "DiT-B", "--image_size", "32", "--patch_size", "2",
              "--in_chans", "3", "--num_classes", "10", "--class_cond", "True",
              "--drop_label_prob", "0.1", "--amp", "True"]


def run_train_cli(argv: list) -> dict:
    """vaw_torch.cli.main.main(argv) with every launch count, the native
    gather's count and the peak memory reset just before; returns the
    launches (total and by kernel), the per-step losses (and vb terms, with
    a learned variance), the steady imgs/s
    (CUDA events after the first five steps), each step's time from the
    event of the step before (step_ms[i] for step i + 1; None for the
    first), the wall time, the peak memory and the run's context."""
    losses, vbs, events = [], [], []
    step = Trainer.step

    def recorded_step(self, state, batch):
        state, metrics = step(self, state, batch)
        losses.append(metrics["loss"])
        if "vb" in metrics:
            vbs.append(metrics["vb"])
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()
        return state, metrics

    with mock.patch.object(Trainer, "step", recorded_step):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        native.gather_normalize.calls = 0
        t0 = time.perf_counter()
        ctx = train_cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, designs = read_launches(), read_designs()
    values = [float(x) for x in losses]
    batch = ctx["trainer"].cfg.batch_size
    seconds = events[TRAIN_WARMUP - 1].elapsed_time(events[-1]) / 1e3
    step_ms = [None] + [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    return {"ctx": ctx, "launches": launches, "designs": designs, "losses": values,
            "vb": [float(x) for x in vbs],
            "step_ms": step_ms,
            "gathers": native.gather_normalize.calls, "wall_s": wall,
            "imgs_per_s": (len(values) - TRAIN_WARMUP) * batch / seconds,
            "ms_per_step": 1e3 * seconds / (len(values) - TRAIN_WARMUP),
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def check_run(tag: str, run: dict, steps: int, fwd: dict, bwd: dict,
              fwd_design: dict = None, bwd_design: dict = None):
    """A train run's losses finite and its launches exactly `steps` x the
    per-step counts, in all and by kernel."""
    want = expect((fwd, steps), (bwd, steps))
    want_designs = expect_designs((fwd_design or {}, steps), (bwd_design or {}, steps))
    values = run["losses"]
    print(f"[{tag}] {len(values)} steps, loss first {values[0]:.5f} last "
          f"{values[-1]:.5f}; launches {run['launches']} (expected {want}); by "
          f"kernel {run['designs']} (expected {want_designs})", flush=True)
    check(len(values) == steps and all(map(math.isfinite, values)),
          f"{tag}: {len(values)} losses, expected {steps} finite")
    check(run["launches"] == want, f"{tag}: launches {run['launches']}, expected {want}")
    check(run["designs"] == want_designs,
          f"{tag}: launches by kernel {run['designs']}, expected {want_designs}")


def free(run: dict):
    run.pop("ctx", None)
    gc.collect()
    torch.cuda.empty_cache()


# Losses, imgs/s and peak memory of each family's train phase, by tag.
TRAIN_RUNS: dict = {}


def phase_train(card: str, fam: Family) -> dict:
    """The training path through vaw_torch.cli.main.main (``run_train_cli``:
    each step's loss is kept as a device tensor, read after the run, with a
    CUDA event after it, so the run is timed without extra syncs). The
    step-30 checkpoint must load back into the model with every EMA
    tensor the run ended with (U-ViT's learned pos_embed included)."""
    argv = fam.model_args + (fam.recipe or RECIPE_ARGS) + fam.train_extra
    name = checkpoint_name(train_cli.parse_args(argv), TRAIN_STEPS)
    with tempfile.TemporaryDirectory(prefix="vaw_chip_train_") as tmp:
        run = run_train_cli(argv + ["--batch_size", str(fam.train_batch), "--logdir", tmp])
        trained = {k: v.detach().cpu() for k, v in run["ctx"]["state"].ema.items()}
        resampler = run["ctx"]["state"].resampler
        if resampler is not None:
            counts = resampler.loss_counts
            print(f"[train] {fam.tag}: loss-aware resampler history, "
                  f"{int((counts == 10).sum())} of {counts.numel()} rows warmed up "
                  f"(10 losses each), {int(counts.sum())} losses held", flush=True)
        free(run)
        ckpts = glob.glob(f"{tmp}/*/checkpoint/{name}.pt")
        check(len(ckpts) == 1, f"checkpoint of step {TRAIN_STEPS}: found {ckpts}")
        with torch.device("meta"):  # shapes only; every parameter comes from the file
            model = fam.ctor()
        model = model.to_empty(device="cpu")
        ckpt_step = load_checkpoint(ckpts[0], model)
        loaded = all(torch.equal(p.detach(), trained[k])
                     for k, p in model.named_parameters())
        del model, trained
    check_run(f"train {fam.tag}", run, TRAIN_STEPS, fam.fwd, fam.bwd,
              fam.fwd_design, fam.bwd_design)
    values = run["losses"]
    TRAIN_RUNS[fam.tag] = {k: run[k] for k in ("losses", "imgs_per_s", "peak_gib")}
    if run["vb"]:
        print(f"[train] {fam.tag} vb terms {[round(v, 5) for v in run['vb']]}", flush=True)
        check(all(map(math.isfinite, run["vb"])), f"{fam.tag}: non-finite vb")
    print(f"[train] {fam.tag}: checkpoint {Path(ckpts[0]).name} (step {ckpt_step}) "
          f"loads back with the run's EMA weights: {loaded}")
    print(f"[train] {fam.tag} losses {[round(v, 5) for v in values]}")
    print(f"[train] {fam.tag} batch {fam.train_batch} bf16 over f32 masters, fused "
          f"AdamW+EMA: {run['imgs_per_s']:.2f} imgs/s over steps {TRAIN_WARMUP + 1}-"
          f"{TRAIN_STEPS} ({run['ms_per_step']:.2f} ms/step, CUDA events), CLI wall "
          f"{run['wall_s']:.2f} s, peak memory {run['peak_gib']:.2f} GiB [{card}]",
          flush=True)
    w = fam.fall_window
    first, last = sum(values[:w]) / w, sum(values[-w:]) / w
    check(last < first, f"{fam.tag}: loss did not fall: mean of the first {w} "
          f"{first} -> of the last {w} {last}")
    check(ckpt_step == TRAIN_STEPS and loaded,
          f"{fam.tag}: checkpoint step {ckpt_step}, EMA weights loaded back {loaded}")
    return run["launches"], run["designs"]


F32_TRAIN_STEPS = 10


def _flag(argv: list, flag: str, value) -> list:
    """argv with `flag`'s value replaced."""
    out = list(argv)
    out[out.index(flag) + 1] = str(value)
    return out


def phase_train_f32(card: str, fam: Family, batch: int) -> tuple:
    """`fam` trained in f32 (`--amp False`, the f32 compute policy) under its
    environment through vaw_torch.cli.main.main at `batch`,
    F32_TRAIN_STEPS steps on the flagship recipe: the path of the 3xTF32
    designs. Finite losses that fall (the mean of the last three below that
    of the first three) and exactly each step's f32 launches by kernel
    (f32_designs at the batch: every attention call at or above the
    crossover on tf32x3, ADM-64's 24 routed wgrads with Cin and Cout
    multiples of 64 too); imgs/s and peak memory."""
    argv = _flag(fam.model_args, "--amp", "False") + _flag(_flag(
        RECIPE_ARGS, "--total_steps", F32_TRAIN_STEPS), "--save_step", 0)
    fwd, bwd = fam.f32
    fwd_design, bwd_design = f32_designs(fam, batch)
    with tempfile.TemporaryDirectory(prefix="vaw_chip_f32_") as tmp, \
            environment(fam.env):
        run = run_train_cli(argv + ["--batch_size", str(batch), "--logdir", tmp])
        free(run)
    check_run(f"train {fam.tag} f32", run, F32_TRAIN_STEPS, fwd, bwd, fwd_design, bwd_design)
    env = "".join(f", {k}={v}" for k, v in fam.env.items())
    print(f"[train f32] {fam.tag} batch {batch} f32 (--amp False){env}: "
          f"{run['imgs_per_s']:.2f} imgs/s over steps {TRAIN_WARMUP + 1}-{F32_TRAIN_STEPS} "
          f"({run['ms_per_step']:.2f} ms/step, CUDA events), losses "
          f"{[round(v, 5) for v in run['losses']]}, peak memory {run['peak_gib']:.2f} GiB "
          f"[{card}]", flush=True)
    first, last = sum(run["losses"][:3]) / 3, sum(run["losses"][-3:]) / 3
    check(last < first, f"{fam.tag} f32: loss did not fall: mean of the first 3 {first} "
          f"-> of the last 3 {last}")
    return run["launches"], run["designs"]


def _grad_group(name: str) -> str:
    """blocks.3.attn.qkv.weight -> blocks.attn.qkv; mid_block.norm1.bias ->
    mid_block.norm1; x_embedder.proj.bias -> x_embedder."""
    parts = name.split(".")
    if parts[0] in ("blocks", "in_blocks", "out_blocks", "mid_block", "input_blocks",
                    "middle_block", "output_blocks"):
        return ".".join([parts[0]] + [p for p in parts[1:-1] if not p.isdigit()])
    return parts[0]


# The kernel each kernel that chooses by the call runs for an f32 model call,
# where it is not the FMA kernel.
def f32_designs(fam: Family, b: int) -> tuple:
    """Launches by kernel of one f32 forward and one f32 backward of `fam`
    at batch b: its attention calls on the kernel the crossover picks at
    that batch (f32_rule: every call here has D <= 64, scale > 0 and mapped
    views), the p5 backward on tf32x3 at every size (it has no crossover),
    the rest as the family lists them."""
    fwd = {k: dict(v) for k, v in fam.f32_design[0].items()}
    bwd = {k: dict(v) for k, v in fam.f32_design[1].items()}
    for fname, bname, t, h, calls in fam.f32_attention:
        for counts, name in ((fwd, fname), (bwd, bname)):
            if name:
                design = ("tf32x3" if name == "flash_p5_bwd" else
                          f32_rule(b, t, t, h, P5_TF32X3_MIN_TILES) if name == "flash_p5_fwd"
                          else f32_rule(b, t, t, h))
                counts.setdefault(name, {})
                counts[name][design] = counts[name].get(design, 0) + calls
    return fwd, bwd


def phase_grad(fam: Family) -> tuple:
    """One backward in f32 through the kernels against the same backward
    through the plain attention, per parameter group. Returns its launches
    (the path ``grad_<family>``), in all and by kernel."""
    model = fam.seeded().float().train()
    gen = torch.Generator(device="cuda").manual_seed(3)
    b = fam.grad_batch
    x = torch.randn((b, *fam.image), generator=gen, device="cuda")
    t = torch.rand((b,), generator=gen, device="cuda") * 999
    y = torch.randint(0, fam.classes, (b,), generator=gen, device="cuda")
    g = torch.randn((b, *fam.image), generator=gen, device="cuda")

    def grads():
        model.zero_grad(set_to_none=True)
        (_out(model(x, t, y)) * g).sum().backward()
        return {k: p.grad.clone() for k, p in model.named_parameters()}

    with plain_route(fam):
        want = grads()
    before = read_launches()
    before_designs = read_designs()
    got = grads()
    launched = {k: n - before[k] for k, n in read_launches().items()}
    path = (dict(launched), {k: {dsg: n - before_designs[k][dsg] for dsg, n in v.items()}
                             for k, v in read_designs().items()})
    fwd, bwd = fam.f32
    check(launched == expect((fwd, 1), (bwd, 1)), f"{fam.tag}: the kernel "
          f"route launched {launched}, expected {fwd} and {bwd}")
    # In f32 the general attention and the fused forward run their 3xTF32
    # designs at or above the crossover and the FMA kernels below it, the
    # wgrad its 3xTF32 design where Cin and Cout are multiples of 64, every
    # other kernel that chooses by the call its FMA kernel.
    by_design = {k: _used(k, before_designs) for k in DESIGNS}
    want_designs = {k: {d: n for d, n in v.items() if n} for k, v in expect_designs(
        (f32_designs(fam, b)[0], 1), (f32_designs(fam, b)[1], 1)).items()}
    check(by_design == want_designs, f"{fam.tag}: f32 launches by kernel {by_design}, "
          f"expected {want_designs}")
    launched = {k: n - fwd.get(k, 0) for k, n in launched.items() if k in bwd}
    worst = {}
    for name in want:
        group = _grad_group(name)
        scale = want[name].abs().max().item()
        err = (got[name] - want[name]).abs().max().item()
        prev = worst.get(group, (0.0, 0.0))
        worst[group] = (max(prev[0], err), max(prev[1], scale))
    rel = {k: e / s if s > 0 else e for k, (e, s) in worst.items()}
    print(f"[grad] {fam.tag} B={b} f32 kernels vs plain route (backward "
          f"launches {launched}), max rel grad error per group: "
          + ", ".join(f"{k} {v:.3e}" for k, v in sorted(rel.items()))
          + f" (tol {GRAD_F32_RTOL:.0e})", flush=True)
    check(all(math.isfinite(v) and v <= GRAD_F32_RTOL for v in rel.values()),
          f"{fam.tag}: f32 model gradient disagrees")
    return path


def write_cifar(root: Path) -> Path:
    """A CIFAR-10-layout archive of seeded uint8 rows: data_batch_1..5 of
    CIFAR_ROWS rows each and a test_batch, each a pickle of {b"data":
    [n, 3072] uint8, b"labels": [n] ints below 10}."""
    rng = np.random.default_rng(20)
    base = root / "cifar-10-batches-py"
    base.mkdir(parents=True)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        data = {b"data": rng.integers(0, 256, (CIFAR_ROWS, 3072), dtype=np.uint8),
                b"labels": rng.integers(0, 10, CIFAR_ROWS).tolist()}
        with open(base / name, "wb") as f:
            pickle.dump(data, f)
    return root


def write_latents(root: Path) -> Path:
    """latents.h5 in the layout of vaw_tpu/data/preprocessing.py:70-80:
    train_latents [n, 8, 32, 32] f32 (4 channels of means, then 4 of
    positive standard deviations) and train_labels [n] uint16 below 1000,
    seeded; 384 MiB for LATENT_ITEMS items."""
    import h5py

    rng = np.random.default_rng(21)
    path = root / "latents.h5"
    with h5py.File(path, "w") as f:
        lat = f.create_dataset("train_latents", (LATENT_ITEMS, 8, 32, 32), dtype="float32")
        lab = f.create_dataset("train_labels", (LATENT_ITEMS,), dtype="uint16")
        for start in range(0, LATENT_ITEMS, 2048):
            n = min(2048, LATENT_ITEMS - start)
            chunk = np.empty((n, 8, 32, 32), np.float32)
            chunk[:, :4] = rng.standard_normal((n, 4, 32, 32), dtype=np.float32)
            chunk[:, 4:] = rng.uniform(0.05, 0.5, (n, 4, 32, 32)).astype(np.float32)
            lat[start:start + n] = chunk
            lab[start:start + n] = rng.integers(0, 1000, n)
    return path


def phase_data_cifar(card: str, data_dir: Path):
    """DiT-B/2 (3 channels, 10 classes) trained through the CLI on the
    CIFAR-10 archive: batches through the native gather and the
    prefetcher, asynchronous checkpoints at steps 15 and 30; the step-30
    file holds the final in-memory state bit for bit. Then the same run
    with synchronous saves and with no saves, for the cost of a save in
    the timed window (steps 6-30)."""
    def argv(tmp, save_step, asynchronous):
        return CIFAR_ARGS + RECIPE_ARGS + [
            "--dataset", "CIFAR-10", "--data_dir", str(data_dir), "--num_workers", "8",
            "--batch_size", str(DIT_TRAIN_BATCH), "--total_steps", str(CIFAR_STEPS),
            "--save_step", str(save_step), "--async_checkpoint", str(asynchronous),
            "--logdir", tmp]

    with tempfile.TemporaryDirectory(prefix="vaw_chip_cifar_") as tmp:
        run = run_train_cli(argv(tmp, CIFAR_SAVE, True))
        check_run("data-cifar", run, CIFAR_STEPS, DIT.fwd, DIT.bwd, DIT.fwd_design,
                  DIT.bwd_design)
        state = run["ctx"]["state"]
        ckpts = sorted(glob.glob(f"{tmp}/*/checkpoint/DiT-B_EPSILON_cosine_*.pt"))
        names = [Path(c).name for c in ckpts]
        check(len(ckpts) == 2, f"data-cifar: checkpoints {names}, expected steps "
              f"{CIFAR_SAVE} and {CIFAR_STEPS}")
        saved = torch.load(next(c for c in ckpts if c.endswith(f"_{CIFAR_STEPS}.pt")),
                           map_location="cpu", weights_only=True)
        trees = (("params", state.params, saved["params"]), ("ema", state.ema, saved["ema"]),
                 ("mu", state.mu, saved["opt"]["mu"]), ("nu", state.nu, saved["opt"]["nu"]))
        equal = {name: set(live) == set(disk) and all(
            torch.equal(t.detach().cpu(), disk[k]) for k, t in live.items())
            for name, live, disk in trees}
    print(f"[data-cifar] native gathers {run['gathers']}, checkpoints {names}; the "
          f"step-{CIFAR_STEPS} file equals the final state bit for bit: {equal}, step "
          f"{saved['step']}, count {saved['opt']['count']} (state {state.count})")
    check(run["gathers"] >= CIFAR_STEPS, f"data-cifar: {run['gathers']} native "
          f"gathers, expected at least {CIFAR_STEPS}")
    check(all(equal.values()) and saved["step"] == CIFAR_STEPS
          and saved["opt"]["count"] == state.count,
          f"data-cifar: the step-{CIFAR_STEPS} checkpoint differs from the final state")
    del state, saved, trees
    free(run)
    timed = [("asynchronous", run)]
    for saves, save_step, asynchronous in (("synchronous", CIFAR_SAVE, False),
                                           ("no", 0, False)):
        with tempfile.TemporaryDirectory(prefix="vaw_chip_cifar_") as tmp:
            other = run_train_cli(argv(tmp, save_step, asynchronous))
        check_run(f"data-cifar, {saves} saves", other, CIFAR_STEPS, DIT.fwd, DIT.bwd,
                  DIT.fwd_design, DIT.bwd_design)
        free(other)
        timed.append((saves, other))
    for saves, timed_run in timed:
        at = f" at steps {CIFAR_SAVE} and {CIFAR_STEPS}" if saves != "no" else ""
        print(f"[data-cifar] DiT-B/2 batch {DIT_TRAIN_BATCH} on CIFAR-10 through the "
              f"prefetcher, {saves} saves{at}: {timed_run['imgs_per_s']:.2f} imgs/s "
              f"({timed_run['ms_per_step']:.2f} ms/step, CUDA events over steps "
              f"{TRAIN_WARMUP + 1}-{CIFAR_STEPS}), step {CIFAR_SAVE + 1} "
              f"{timed_run['step_ms'][CIFAR_SAVE]:.2f} ms, peak memory "
              f"{timed_run['peak_gib']:.2f} GiB [{card}]", flush=True)
    return run["launches"], run["designs"]


def phase_async_snapshot():
    """AsyncCheckpointWriter.save, then at once one more fused AdamW+EMA
    step on the same state: the file holds the state before that step."""
    cfg = train_cli.parse_args(DIT.model_args + RECIPE_ARGS + [
        "--batch_size", "32"])
    torch.manual_seed(0)
    trainer = Trainer(cfg, build_model(cfg, device="cuda"),
                      train_cli.build_diffusion(cfg))
    state = trainer.init_state()
    gen = torch.Generator(device="cuda").manual_seed(4)
    batch = {"image": torch.randn((32, 32, 32, 4), generator=gen, device="cuda"),
             "label": torch.randint(0, 1000, (32,), generator=gen, device="cuda")}
    state, _ = trainer.step(state, batch)  # moments and EMA away from their init
    trees = ("params", "ema", "mu", "nu")
    before = {n: {k: t.detach().cpu().clone() for k, t in getattr(state, n).items()}
              for n in trees}
    with tempfile.TemporaryDirectory(prefix="vaw_chip_async_") as tmp:
        with AsyncCheckpointWriter(state) as writer:  # its buffers made here
            path = writer.save(cfg, 1, state, logdir=tmp)
            state, _ = trainer.step(state, batch)  # in place, right after the snapshot
            writer.wait()
        saved = torch.load(path, map_location="cpu", weights_only=True)
    disk = {"params": saved["params"], "ema": saved["ema"], "mu": saved["opt"]["mu"],
            "nu": saved["opt"]["nu"]}
    equal = {n: all(torch.equal(disk[n][k], before[n][k]) for k in before[n])
             for n in trees}
    moved = {n: any(not torch.equal(t.detach().cpu(), before[n][k])
                    for k, t in getattr(state, n).items()) for n in trees}
    print(f"[async-snapshot] the file equals the state before the next step: "
          f"{equal}; that step changed the live state: {moved}", flush=True)
    check(all(equal.values()), "async-snapshot: the file is not the snapshot's state")
    check(all(moved.values()), "async-snapshot: the step after the save changed nothing")
    del trainer, state, before, saved, disk
    gc.collect()
    torch.cuda.empty_cache()


def phase_data_latent(card: str, path: Path):
    """DiT-B/2 through the CLI on the latent file: slab reads (8192 items,
    the second slab carried), the prefetcher, 40 steps at batch 256."""
    with tempfile.TemporaryDirectory(prefix="vaw_chip_latent_") as tmp:
        argv = DIT.model_args + RECIPE_ARGS + [
            "--dataset", "Latent", "--data_dir", str(path),
            "--batch_size", str(DIT_TRAIN_BATCH), "--total_steps", str(LATENT_STEPS),
            "--save_step", "0", "--logdir", tmp]
        run = run_train_cli(argv)
    check_run("data-latent", run, LATENT_STEPS, DIT.fwd, DIT.bwd, DIT.fwd_design,
              DIT.bwd_design)
    print(f"[data-latent] DiT-B/2 batch {DIT_TRAIN_BATCH} on {LATENT_ITEMS} latents "
          f"through the slab loader and the prefetcher: {run['imgs_per_s']:.2f} imgs/s "
          f"({run['ms_per_step']:.2f} ms/step, CUDA events over steps "
          f"{TRAIN_WARMUP + 1}-{LATENT_STEPS}), peak memory {run['peak_gib']:.2f} GiB "
          f"[{card}]", flush=True)
    free(run)
    return run["launches"], run["designs"]


def phase_remat_grad():
    """DiT-B/2's f32 gradient at batch 256 without remat and under each
    policy, bit-equal, with cuDNN held to deterministic algorithms: the
    patch conv's filter gradient (x_embedder) is otherwise summed in no
    fixed order, so that even the gradient without remat, taken twice,
    differs there."""
    model = DIT.seeded().float().train()
    gen = torch.Generator(device="cuda").manual_seed(5)
    b = DIT_TRAIN_BATCH
    x = torch.randn((b, 32, 32, 4), generator=gen, device="cuda")
    t = torch.rand((b,), generator=gen, device="cuda") * 999
    y = torch.randint(0, 1000, (b,), generator=gen, device="cuda")
    g = torch.randn((b, 32, 32, 4), generator=gen, device="cuda")

    def grads(use_checkpoint, policy="full"):
        model.use_checkpoint, model.remat_policy = use_checkpoint, policy
        model.zero_grad(set_to_none=True)
        torch.cuda.reset_peak_memory_stats()
        (_out(model(x, t, y)) * g).sum().backward()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        return {k: p.grad.clone() for k, p in model.named_parameters()}, peak

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        want, peak = grads(False)
        peaks = {"none": peak}
        for policy in (None, *REMAT_POLICIES):
            got, peak = grads(policy is not None, policy or "full")
            if policy is not None:
                peaks[policy] = peak
            differ = sorted({_grad_group(k) for k in want
                             if not torch.equal(got[k], want[k])})
            what = "without remat, taken again" if policy is None else f"under {policy!r}"
            print(f"[remat] DiT-B/2 B={b} f32 gradient {what}, cuDNN deterministic: "
                  f"bit-equal to the gradient without remat {not differ}; groups "
                  f"that differ {differ}", flush=True)
            check(not differ, f"remat {policy or 'none'}: the gradient differs in {differ}")
            del got
    finally:
        torch.backends.cudnn.deterministic = deterministic
    print(f"[remat] DiT-B/2 B={b} f32 forward + backward peak memory (GiB): "
          + ", ".join(f"{k} {v:.2f}" for k, v in peaks.items()), flush=True)
    del model, want
    gc.collect()
    torch.cuda.empty_cache()


def phase_remat_train(card: str) -> tuple:
    """Through the CLI, bf16: DiT-B/2 at batch 256 without remat and under
    each policy (an attention forward runs again in each rematted block's
    backward: 24 fused forwards a step), and U-ViT-L/2 at the recipe's
    batch 256 under "full" (42 general forwards a step), beside U-ViT-L/2
    without remat at 128 and at 256 (which fits in 80 GB). Prints each
    run's peak memory."""
    by_path, designs_by_path, peaks = {}, {}, {}
    remat_fwd = {"flash_fused_fwd": 2 * DIT.fwd["flash_fused_fwd"]}
    remat_fwd_design = {"flash_fused_fwd": {"wgmma": remat_fwd["flash_fused_fwd"]}}
    for policy in (None, *REMAT_POLICIES):
        flags = [] if policy is None else ["--use_checkpoint", "True",
                                           "--remat_policy", policy]
        with tempfile.TemporaryDirectory(prefix="vaw_chip_remat_") as tmp:
            run = run_train_cli(DIT.model_args + RECIPE_ARGS + flags + [
                "--batch_size", str(DIT_TRAIN_BATCH), "--total_steps",
                str(REMAT_STEPS), "--save_step", "0", "--logdir", tmp])
        tag = f"remat DiT-B/2 {policy or 'none'}"
        check_run(tag, run, REMAT_STEPS, DIT.fwd if policy is None else remat_fwd,
                  DIT.bwd, DIT.fwd_design if policy is None else remat_fwd_design,
                  DIT.bwd_design)
        peaks[f"DiT-B/2 {DIT_TRAIN_BATCH} {policy or 'none'}"] = run["peak_gib"]
        print(f"[{tag}] {run['imgs_per_s']:.2f} imgs/s ({run['ms_per_step']:.2f} "
              f"ms/step), peak memory {run['peak_gib']:.2f} GiB [{card}]", flush=True)
        if policy is not None:
            by_path[f"remat_dit_{policy}"] = run["launches"]
            designs_by_path[f"remat_dit_{policy}"] = run["designs"]
        free(run)
    uvit_fwd = {"flash_fwd": 2 * UVIT.fwd["flash_fwd"]}
    uvit_fwd_design = {"flash_fwd": {"wgmma": 2 * UVIT.fwd["flash_fwd"]}}
    for batch, policy in ((UVIT_REMAT_BATCH, "full"), (UVIT.train_batch, None),
                          (UVIT_REMAT_BATCH, None)):
        flags = [] if policy is None else ["--use_checkpoint", "True",
                                           "--remat_policy", policy]
        tag = f"remat U-ViT-L/2 {batch} {policy or 'none'}"
        with tempfile.TemporaryDirectory(prefix="vaw_chip_remat_") as tmp:
            run = run_train_cli(UVIT.model_args + RECIPE_ARGS + flags + [
                "--batch_size", str(batch), "--total_steps", str(REMAT_STEPS),
                "--save_step", "0", "--logdir", tmp])
        check_run(tag, run, REMAT_STEPS, UVIT.fwd if policy is None else uvit_fwd,
                  UVIT.bwd, fwd_design=UVIT.fwd_design if policy is None else uvit_fwd_design,
                  bwd_design=UVIT.bwd_design)
        peaks[f"U-ViT-L/2 {batch} {policy or 'none'}"] = run["peak_gib"]
        print(f"[{tag}] {run['imgs_per_s']:.2f} imgs/s ({run['ms_per_step']:.2f} "
              f"ms/step), peak memory {run['peak_gib']:.2f} GiB [{card}]", flush=True)
        if policy is not None:
            by_path["remat_uvit_full"] = run["launches"]
            designs_by_path["remat_uvit_full"] = run["designs"]
        free(run)
    print("[remat] peak memory of the train runs (GiB, torch.cuda.max_memory_allocated): "
          + ", ".join(f"{k} {v:.2f}" for k, v in peaks.items()) + f" [{card}]", flush=True)
    return by_path, designs_by_path


def phase_host_path(card: str, cifar_dir: Path, latent_path):
    """profile_train's resident and loader-fed steps (the loader through
    prefetch_to_device) for DiT-B/2 on Gaussian latents, on CIFAR-10 and on
    the latent file."""
    runs = [("Gaussian", [])]
    runs.append(("CIFAR-10", ["--dataset", "CIFAR-10", "--data_dir", str(cifar_dir),
                              "--in_chans", "3", "--num_classes", "10",
                              "--num_workers", "8"]))
    if latent_path is not None:
        runs.append(("Latent", ["--dataset", "Latent", "--data_dir", str(latent_path)]))
    for name, argv in runs:
        print(f"[host] DiT-B/2 batch {DIT_TRAIN_BATCH} on {name} [{card}]", flush=True)
        rc = profile_train.main(argv)
        check(rc == 0, f"host path on {name}: profile_train exited {rc}")
        gc.collect()
        torch.cuda.empty_cache()


def phase_slice11(card: str, by_path: dict, designs_by_path: dict):
    """ViT-B/2 (sample, model, train with the loss-aware resampler, grad),
    MM-DiT-B/2 (flow SDE and ODE samples, model, rectified-flow train,
    grad) and DiT-B/2 with learned variance (sample, train with the vb
    term, then under the KL loss)."""
    model = VIT.seeded()
    by_path["sample_vit"], designs_by_path["sample_vit"] = phase_sample(card, VIT, model)
    phase_model(VIT, model)
    del model
    torch.cuda.empty_cache()
    by_path["train_vit"], designs_by_path["train_vit"] = phase_train(card, VIT)
    phase_grad(VIT)
    torch.cuda.empty_cache()
    model = MMDIT.seeded()
    for path, (counts, designs) in phase_sample_flow(card, MMDIT, model).items():
        by_path[path], designs_by_path[path] = counts, designs
    phase_model(MMDIT, model)
    del model
    torch.cuda.empty_cache()
    by_path["train_mmdit"], designs_by_path["train_mmdit"] = phase_train(card, MMDIT)
    phase_grad(MMDIT)
    torch.cuda.empty_cache()
    model = DIT_LV.seeded()
    by_path["sample_dit_lv"], designs_by_path["sample_dit_lv"] = phase_sample(
        card, DIT_LV, model)
    del model
    torch.cuda.empty_cache()
    by_path["train_dit_lv"], designs_by_path["train_dit_lv"] = phase_train(card, DIT_LV)
    by_path["train_dit_kl"], designs_by_path["train_dit_kl"] = phase_kl(card)
    torch.cuda.empty_cache()


# The slice of the SD-VAE and REPA (phase_slice12). The full-size SD-VAE
# (ch 128, mults (1, 2, 4, 4), 2 res blocks; 83.65M parameters) encodes
# 256 seeded 256 px images in f32, in chunks of 64, and decodes 64 32x32x4
# latents in bf16 and f32; DINOv2-B/14 (86M) is REPA's teacher at 224 px.
VAE_IMAGES, VAE_CHUNK, VAE_DECODE, VAE_PIXELS = 256, 64, 64, 256
# The bf16 decode against the f32 decode: JAX's bound, 0.1 on its test's
# roughly unit-scale output (tests/test_vae.py:174-177), here times the f32
# decode's largest magnitude where that exceeds 1. At full depth both
# packages' bf16 decodes reach that bound's unscaled 0.1 over many pixels
# (tests/test_torch_vae.py::test_full_width_bf16_decode_error_is_jaxs:
# the port's difference is at most 1.25x JAX's on the same weights). The
# card's f32 VAE against the same weights on the CPU at 64 px: both sum f32
# products in another order.
VAE_BF16_BOUND = 0.1
VAE_CPU_RTOL = 1e-4
REPA_ARGS = ["--learn_align", "True", "--enc_type", "dinov2-vit-b",
             "--encoder_depth", "8", "--gamma", "0.5"]
# Under REPA each DiT-B/2 step runs the teacher's 12 attention layers
# forward only, through the fused forward (f32), beside the student's 12
# forwards and 12 backwards.
REPA_FWD = {"flash_fused_fwd": 24}
# By kernel: the bf16 DiT's 12 on the general wgmma forward, the f32
# teacher's 12 on the general 3xTF32 forward (both on the packed row's
# views).
REPA_FWD_DESIGN = {"flash_fused_fwd": {"wgmma": 12, "tf32x3": 12}}
DIT_VAE = DIT._replace(tag="DiT-B/2 + SD-VAE decode", png_channels=3)
REPA_CLI_ARGS = ["--model", "DiT-B", "--patch_size", "2", "--dataset", "Shapes",
                 "--in_chans", "3", "--image_size", "32", "--num_classes", "10",
                 "--class_cond", "True", "--drop_label_prob", "0.1", "--amp", "True",
                 "--weight_type", "lambda", "--mean_type", "EPSILON", "--path_type",
                 "cosine", "--betas", "0.9", "0.95", "--total_steps", str(TRAIN_STEPS),
                 "--eval", "False", "--sample_freq", "0", "--save_step", "0",
                 "--batch_size", str(DIT_TRAIN_BATCH)] + REPA_ARGS


def write_seeded_vae(root: Path) -> Path:
    """The full-size SD-VAE's state dict, seeded, in diffusers' layout (the
    port's names are diffusers'), as diffusion_pytorch_model.bin."""
    torch.manual_seed(0)
    path = root / "sd-vae-ft-ema" / "diffusion_pytorch_model.bin"
    path.parent.mkdir(parents=True)
    torch.save(AutoencoderKL().state_dict(), path)
    return path


def write_seeded_dinov2(root: Path) -> Path:
    """DINOv2-B/14, seeded, in timm's layout (layer scales as ``ls1.gamma``)
    with its 518 px position table (a 37-grid), as dinov2-vit-b.pth."""
    torch.manual_seed(1)
    sd = make_teacher("dinov2", "b", 518).state_dict()
    root.mkdir(parents=True)
    torch.save({f"{k}.gamma" if k.endswith((".ls1", ".ls2")) else k: v
                for k, v in sd.items()}, root / "dinov2-vit-b.pth")
    return root


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_vae(card: str, vae_path: Path):
    """The SD-VAE through vaw_torch.data.vae on the seeded .bin: encode and
    decode at 64 px held against the same model on the CPU, then encode 256
    images at 256 px in f32 and decode 64 latents in bf16 and f32, timed
    (the second of two runs) with the peak memory. Returns the [mean | std]
    moments and the uint8 images, for the REPA phase."""
    with environment({"VAW_VAE_PATH": str(vae_path)}):
        torch.cuda.reset_peak_memory_stats()
        vae = load_vae(dtype=torch.float32, device="cuda")
        decode_bf16 = load_vae_decoder(dtype=torch.bfloat16, device="cuda")
    params = sum(p.numel() for p in vae.parameters())
    cpu = AutoencoderKL()
    cpu.load_state_dict({k: v.cpu() for k, v in vae.state_dict().items()})
    gen = torch.Generator(device="cuda").manual_seed(4)
    pixels = torch.randint(0, 256, (VAE_IMAGES, VAE_PIXELS, VAE_PIXELS, 3), generator=gen,
                           device="cuda", dtype=torch.uint8)
    x = pixels.float() / 127.5 - 1.0
    with torch.no_grad():
        small = x[:2, :64, :64]
        for name, card_fn, cpu_fn, arg in (
                ("encode", vae.encode, cpu.encode, small),
                ("decode", vae.decode, cpu.decode, torch.randn(
                    (1, 8, 8, 4), generator=gen, device="cuda"))):
            got, want = card_fn(arg), cpu_fn(arg.cpu())
            rel = (got.cpu() - want).abs().max().item() / want.abs().max().item()
            print(f"[vae] {name} at 64 px, card vs CPU f32: max rel err {rel:.3e} "
                  f"(tol {VAE_CPU_RTOL:.0e})", flush=True)
            check(math.isfinite(rel) and rel <= VAE_CPU_RTOL, f"VAE {name} disagrees "
                  "with the CPU")
        del cpu

        def encode_all():
            return torch.cat([vae.moments_to_mean_std(vae.encode(x[i:i + VAE_CHUNK]))
                              for i in range(0, VAE_IMAGES, VAE_CHUNK)])

        encode_all()
        moments, enc_s = _timed(encode_all)
        latents = moments[:VAE_DECODE, ..., :4]
        outs, dec_s = {}, {}
        for dtype, decode in ((torch.bfloat16, decode_bf16), (torch.float32, vae.decode)):
            decode(latents)
            outs[dtype], dec_s[dtype] = _timed(lambda: decode(latents))
    lat = VAE_PIXELS // 8
    check(moments.shape == (VAE_IMAGES, lat, lat, 8) and torch.isfinite(moments).all().item()
          and (moments[..., 4:] > 0).all().item(), "VAE moments: shape, finite, std > 0")
    diff = (outs[torch.bfloat16] - outs[torch.float32]).abs()
    err, mean_err = diff.max().item(), diff.mean().item()
    scale = outs[torch.float32].abs().max().item()
    bound = VAE_BF16_BOUND * max(1.0, scale)
    finite = all(torch.isfinite(o).all().item() for o in outs.values())
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[vae] SD-VAE ({params / 1e6:.2f}M): encode {VAE_IMAGES} x {VAE_PIXELS} px f32 "
          f"in chunks of {VAE_CHUNK}: {VAE_IMAGES / enc_s:.2f} images/s; decode "
          f"{VAE_DECODE} x {lat}x{lat}x4: bf16 {VAE_DECODE / dec_s[torch.bfloat16]:.2f}, f32 "
          f"{VAE_DECODE / dec_s[torch.float32]:.2f} images/s; bf16 vs f32 max abs "
          f"diff {err:.4f} (bound {bound:.4f}), mean {mean_err:.5f}, max|f32| "
          f"{scale:.3f}; peak memory {peak:.2f} GiB [{card}]", flush=True)
    check(finite and err < bound, f"VAE bf16 decode: finite {finite}, {err} from "
          "the f32 decode")
    del vae, decode_bf16, outs, x
    torch.cuda.empty_cache()
    return moments, pixels


# The REPA Trainer phase's step, teacher and teacher-attention ms, for the
# result line.
REPA_TEACHER: dict = {}


def phase_repa_trainer(card: str, moments, pixels, enc_dir: Path, by_path: dict):
    """REPA on latents, the paper's recipe, through Trainer: DiT-B/2 at 256
    under the flagship recipe with the DINOv2-B/14 teacher on the stored
    pixels, 30 steps on the VAE phase's moments and images; the teacher's
    exact launches (12 fused forwards a step, no backward), its ms a step
    (CUDA events around get_feature), imgs/s and the peak memory."""
    argv = DIT.model_args + RECIPE_ARGS + REPA_ARGS + ["--batch_size", str(DIT_TRAIN_BATCH)]
    cfg = train_cli.parse_args(argv)
    with environment({"VAW_ENCODER_DIR": str(enc_dir)}):
        torch.manual_seed(0)
        model = build_model(cfg, device="cuda")
        teacher, _ = initialize_encoders(cfg.enc_type, cfg.image_size, device="cuda")
    trainer = Trainer(cfg, model, train_cli.build_diffusion(cfg), encoder_fn=teacher)
    state = trainer.init_state()
    gen = torch.Generator(device="cuda").manual_seed(5)
    n = DIT_TRAIN_BATCH
    batch = {"image": moments[:n], "pixels": pixels[:n].float(),
             "label": torch.randint(0, 1000, (n,), generator=gen, device="cuda")}
    teacher_events, attn_events, events, losses, aligns = [], [], [], [], []
    get_feature = trainer_module.get_feature
    fused_forward = flash_ops._fused_forward

    def timed_get_feature(*args):
        pair = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        pair[0].record()
        out = get_feature(*args)
        pair[1].record()
        teacher_events.append(pair)
        return out

    def timed_fused_forward(qkv2d, *args):
        # The teacher's attention: the f32 fused forwards (the DiT's are bf16).
        if qkv2d.dtype != torch.float32:
            return fused_forward(qkv2d, *args)
        pair = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        pair[0].record()
        out = fused_forward(qkv2d, *args)
        pair[1].record()
        attn_events.append(pair)
        return out

    with mock.patch.object(trainer_module, "get_feature", timed_get_feature), \
            mock.patch.object(flash_ops, "_fused_forward", timed_fused_forward):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        for _ in range(TRAIN_STEPS):
            state, metrics = trainer.step(state, batch)
            losses.append(metrics["loss"])
            aligns.append(metrics["align"])
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
        torch.cuda.synchronize()
        launches, designs = read_launches(), read_designs()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses, aligns = [float(v) for v in losses], [float(v) for v in aligns]
    steady = TRAIN_STEPS - TRAIN_WARMUP
    seconds = events[TRAIN_WARMUP - 1].elapsed_time(events[-1]) / 1e3
    teacher_ms = sum(a.elapsed_time(b) for a, b in teacher_events[TRAIN_WARMUP:]) / steady
    per_step = len(attn_events) // TRAIN_STEPS
    attn_ms = sum(a.elapsed_time(b)
                  for a, b in attn_events[TRAIN_WARMUP * per_step:]) / steady
    want = expect((REPA_FWD, TRAIN_STEPS), (DIT.bwd, TRAIN_STEPS))
    want_designs = expect_designs((REPA_FWD_DESIGN, TRAIN_STEPS),
                                  (DIT.bwd_design, TRAIN_STEPS))
    dit = by_path.get("train_dit", {})
    print(f"[repa] DiT-B/2 + DINOv2-B/14 teacher (f32), batch {n}, Trainer on the VAE "
          f"moments and pixels: fused forward launches {launches['flash_fused_fwd']} "
          f"({launches['flash_fused_fwd'] // TRAIN_STEPS} a step; DiT-B/2 alone "
          f"{dit.get('flash_fused_fwd', 0) // TRAIN_STEPS}), fused backward "
          f"{launches['flash_fused_bwd']} ({launches['flash_fused_bwd'] // TRAIN_STEPS} a "
          f"step; alone {dit.get('flash_fused_bwd', 0) // TRAIN_STEPS}); launches "
          f"{launches} (expected {want})", flush=True)
    check(launches == want, f"REPA Trainer launches {launches}, expected {want}")
    check(designs == want_designs, f"REPA Trainer launches by kernel {designs}, "
          f"expected {want_designs}")
    print(f"[repa] losses {[round(v, 5) for v in losses]}, align "
          f"{[round(v, 5) for v in aligns]}", flush=True)
    print(f"[repa] {steady * n / seconds:.2f} imgs/s over steps {TRAIN_WARMUP + 1}-"
          f"{TRAIN_STEPS} ({1e3 * seconds / steady:.2f} ms/step, CUDA events), the "
          f"teacher {teacher_ms:.2f} ms a step ({100 * teacher_ms * steady / seconds / 1e3:.1f}"
          f" % of the step), peak memory {peak:.2f} GiB [{card}]", flush=True)
    print(f"[repa] the teacher's attention: {per_step} f32 fused forwards a step "
          f"({designs['flash_fused_fwd']['tf32x3']} on tf32x3 in all), {attn_ms:.3f} ms a "
          f"step (CUDA events around each call, steps {TRAIN_WARMUP + 1}-{TRAIN_STEPS}) "
          f"[{card}]", flush=True)
    REPA_TEACHER["attention_ms_per_step"] = attn_ms
    REPA_TEACHER["teacher_ms_per_step"] = teacher_ms
    REPA_TEACHER["ms_per_step"] = 1e3 * seconds / steady
    check(all(map(math.isfinite, losses + aligns)), "REPA: non-finite loss or align")
    check(sum(losses[-5:]) < sum(losses[:5]), "REPA: the loss did not fall")
    del trainer, state, model, teacher, batch
    gc.collect()
    torch.cuda.empty_cache()
    return launches, designs


def phase_repa_cli(card: str, enc_dir: Path):
    """REPA through vaw_torch.cli.main on Shapes (32x32x3; the teacher reads
    the images mapped to [0, 255], resized to 224): 30 steps at 256, align
    in the log, the exact launches, imgs/s and the peak memory."""
    with tempfile.TemporaryDirectory(prefix="vaw_chip_repa_") as tmp, \
            environment({"VAW_ENCODER_DIR": str(enc_dir)}):
        run = run_train_cli(REPA_CLI_ARGS + ["--logdir", tmp])
        (progress,) = glob.glob(f"{tmp}/*/progress.json")
        with open(progress) as f:
            record = json.loads(f.read().splitlines()[-1])
        free(run)
    check_run("train REPA CLI", run, TRAIN_STEPS, REPA_FWD, DIT.bwd, REPA_FWD_DESIGN,
              DIT.bwd_design)
    print(f"[repa-cli] DiT-B/2 + DINOv2-B/14 on Shapes, batch {DIT_TRAIN_BATCH}: logged "
          f"step {record['step']} loss {record['loss']:.5f} align {record['align']:.5f}; "
          f"{run['imgs_per_s']:.2f} imgs/s over steps {TRAIN_WARMUP + 1}-{TRAIN_STEPS}, "
          f"CLI wall {run['wall_s']:.2f} s, peak memory {run['peak_gib']:.2f} GiB "
          f"[{card}]", flush=True)
    check(math.isfinite(record["align"]), "REPA CLI: align not logged finite")
    return run["launches"], run["designs"]


def phase_slice12(card: str, by_path: dict, designs_by_path: dict):
    """The SD-VAE (encode, decode), DiT-B/2 sampling with the VAE decode,
    and REPA through Trainer on the VAE's latents and pixels and through
    the CLI on Shapes, all on seeded weights written to a temporary
    directory."""
    with tempfile.TemporaryDirectory(prefix="vaw_chip_slice12_") as tmp:
        root = Path(tmp)
        vae_path = write_seeded_vae(root)
        enc_dir = write_seeded_dinov2(root / "encoders")
        moments, pixels = phase_vae(card, vae_path)
        with environment({"VAW_VAE_PATH": str(vae_path)}):
            model = DIT.seeded()
            by_path["sample_dit_vae"], designs_by_path["sample_dit_vae"] = phase_sample(
                card, DIT_VAE, model)
            del model
        plain, decoded = SAMPLE_RATES[DIT.tag][-1], SAMPLE_RATES[DIT_VAE.tag][-1]
        print(f"[sample] DiT-B/2 EDM Heun {STEPS} steps CFG 1.5 bf16, second batch of "
              f"{SAMPLE_SIZE}: {decoded:.2f} samples/s with the bf16 SD-VAE decode to "
              f"256 px, {plain:.2f} without (phase 4) [{card}]", flush=True)
        torch.cuda.empty_cache()
        by_path["train_repa"], designs_by_path["train_repa"] = phase_repa_trainer(
            card, moments, pixels, enc_dir, by_path)
        del moments, pixels
        torch.cuda.empty_cache()
        by_path["train_repa_cli"], designs_by_path["train_repa_cli"] = phase_repa_cli(
            card, enc_dir)
        torch.cuda.empty_cache()


# ------------------------------------------------------------------ #
# Slice 13: evaluation (the frozen InceptionV3 graph, FID, sFID, IS,
# precision and recall, --eval True), DDIM and classifier guidance.
# ------------------------------------------------------------------ #

INCEPTION_IMAGES = 256  # 64x64 images through the graph, card against CPU
INCEPTION_RTOL = 1e-4   # f32 both sides, TF32 off; relative to max|out|
DIST_ROWS, DIST_DIM = 10000, 2048  # one distance block at the pool width
DIST_RTOL = 1e-5        # f32 with TF32 off against float64, of max|d|
EVAL_STEPS, EVAL_SAMPLES, EVAL_SAMPLE_SIZE = 20, 256, 128
# The DDIM phases' depths: DiT-B/2 over a 250-step process, the classifier
# over a 50-step one (cut from 1000 and 100 for the script's time limit).
DDIM_STEPS = 250
CLF_STEPS, CLF_SAMPLES, CLF_BATCH = 50, 16, 4
# The classifier's f32 attention at that batch (ADM-64's EncoderUNet, f32,
# 8 general forwards a call): three 32 px blocks and four 8 px ones on
# packed views, the attention pool on three tensors; its three 16 px blocks
# (nine heads) take the p5 kernels. And the f32 shapes timed in phase 3j:
# the p5 pair at 16 px, the 64 px 192 -> 192 conv, and the wgrad at
# ADM-64's f32 gradient batch.
CLF_GENERAL_F32 = [(CLF_BATCH, 1024, 1024, 6, 64, True), (CLF_BATCH, 64, 64, 12, 64, True),
                   (CLF_BATCH, 65, 65, 12, 64, False)]
CLF_GENERAL_F32_CALLS = (3, 4, 1)  # each shape's calls in one classifier forward
CLF_P5_F32_CALLS = 3  # its 16 px blocks' p5 calls in one forward
# Its f32 convs in one call (a forward and its input gradient): the convs and
# dgrads with Cin and Cout multiples of 64 on tf32x3, the 3-channel stem and
# its dgrad on FMAs.
CLF_CONV_F32 = {"tf32x3": 32, "fma": 2}
# f32 general calls on either side of the crossover (TF32X3_MIN_TILES score
# tiles), packed views, each timed on both f32 designs in 3c and 3j: one
# head and twelve at T = 64 (1 and 12 tiles), LDM's 8 px blocks at the
# gradient batch (512 tiles), ADM-64's 16 px ones at the classifier's batch
# (576), 12 heads there (768), and T = 512 (1536).
CROSSOVER_F32 = [(1, 64, 64, 1, 64, True), (1, 64, 64, 12, 64, True),
                 (16, 64, 64, 32, 32, True), (CLF_BATCH, 256, 256, 9, 64, True),
                 (CLF_BATCH, 256, 256, 12, 64, True), (CLF_BATCH, 512, 512, 6, 64, True)]
F32_P5_SHAPE = (CLF_BATCH, 256, 9, 64)
# The f32 p5 forward at the classifier's 16 px blocks (576 score tiles) and
# at LDM's sampling batch (B3's row of 3e in f32), then on either side of
# its crossover (P5_TF32X3_MIN_TILES): LDM's 16 heads of 32 at 512 and 768
# tiles, the classifier's 9 heads of 64 at 288.
F32_P5_FWD_SHAPES = [F32_P5_SHAPE, (2 * SAMPLE_SIZE, 256, 16, 32), (2, 256, 16, 32),
                     (3, 256, 16, 32), (2, 256, 9, 64)]
LDM_F32_P5_KEY = f"B={2 * SAMPLE_SIZE} T=256 H=16 D=32"
# The f32 p5 backward (tf32x3 at every size) at the classifier's 16 px
# blocks (576 score tiles), at LDM's (128, 256, 16, 32) and at 288 tiles,
# beside its FMA kernels.
F32_P5_BWD_SHAPES = [F32_P5_SHAPE, (2 * SAMPLE_SIZE, 256, 16, 32), (2, 256, 9, 64)]
F32_CONV_SHAPE = (CLF_BATCH, 64, 64, 192, 192)
# The f32 conv at the classifier's 64 px 192 -> 192 (its largest calls), at
# ADM-64's f32 training batch (`--amp False`) and at the classifier's 16 px
# 576 -> 576 (1024 pixels a call), both designs timed at each.
F32_CONV_SHAPES = [F32_CONV_SHAPE, (ADM_TRAIN_BATCH, 64, 64, 192, 192),
                   (CLF_BATCH, 16, 16, 576, 576)]
# The f32 wgrad at ADM-64's f32 gradient check (batch 16) and at its
# training batch (64, as `--amp False` trains it); the fused backward at
# DiT-B/2's training shape in f32 (`--amp False`).
F32_WGRAD_SHAPES = [(16, 64, 64, 192, 192), (ADM_TRAIN_BATCH, 64, 64, 192, 192)]
F32_FUSED_BWD_SHAPE = (DIT_TRAIN_BATCH, T_MAIN, H_MAIN, D_MAIN)
CLF_GRAD_RTOL = 1e-3    # the classifier's input gradient, kernels vs plain


def inception_graph_def(seed: int = 0) -> GraphDef:
    """The 2015 InceptionV3 frozen graph's full topology with seeded random
    weights, written with the port's GraphDef writer (no TensorFlow): the
    nodes of tests/_inception_graph.py's TF-built graph, name for name, with
    the same inputs, attrs and weights (the same RandomState draws in the
    same order) and its legacy ops: ExpandDims -> ResizeBilinear to 299 ->
    Sub/Mul -> 94 conv units (Conv2D, BatchNormWithGlobalNormalization,
    CheckNumerics, Relu) in the stem and the mixed..mixed_10 towers, joined
    by old-style Concat -> pool_3 -> the softmax head, whose weights are
    read through an Identity."""
    rs = np.random.RandomState(seed)
    nodes, batchnorms = [], []
    f32 = AttrValue(type=1)
    nhwc = AttrValue(s=b"NHWC")

    def add(name, op, inputs=(), **attr):
        nodes.append(NodeDef(name=name, op=op, input=list(inputs), attr=attr))
        return name

    def const(name, value):
        t = tensor_proto(np.asarray(value))
        return add(name, "Const", dtype=AttrValue(type=t.dtype), value=AttrValue(tensor=t))

    def ints(*v):
        return AttrValue(list=ListValue(i=list(v)))

    def conv(x, cout, kh, kw, name, stride=1, padding="SAME"):
        node, cin = x
        w = const(f"{name}/conv2d_params", (rs.randn(kh, kw, cin, cout)
                                            * (1.2 / np.sqrt(kh * kw * cin))).astype(np.float32))
        add(name, "Conv2D", [node, w], T=f32, strides=ints(1, stride, stride, 1),
            padding=AttrValue(s=padding.encode()), data_format=nhwc,
            dilations=ints(1, 1, 1, 1), use_cudnn_on_gpu=AttrValue(b=True),
            explicit_paddings=ints())
        stats = [
            const(f"{name}/batchnorm/moving_mean", rs.randn(cout).astype(np.float32) * 0.1),
            const(f"{name}/batchnorm/moving_variance",
                  (rs.rand(cout) * 0.5 + 0.5).astype(np.float32)),
            const(f"{name}/batchnorm/beta", rs.randn(cout).astype(np.float32) * 0.1),
            const(f"{name}/batchnorm/gamma", (rs.randn(cout) * 0.1 + 1.0).astype(np.float32))]
        batchnorms.append(NodeDef(
            name=f"{name}/batchnorm", op="BatchNormWithGlobalNormalization",
            input=[name] + stats,
            attr={"T": f32, "variance_epsilon": AttrValue(f=0.001),
                  "scale_after_normalization": AttrValue(b=True)}))
        add(f"{name}/CheckNumerics", "CheckNumerics", [f"{name}/batchnorm"], T=f32,
            message=AttrValue(s=b"bn"))
        return add(f"{name}/relu", "Relu", [f"{name}/CheckNumerics"], T=f32), cout

    def pool(x, k, s, pad, name, op):
        attr = dict(T=f32, ksize=ints(1, k, k, 1), strides=ints(1, s, s, 1),
                    padding=AttrValue(s=pad.encode()), data_format=nhwc)
        if op == "MaxPool":
            attr["explicit_paddings"] = ints()
        return add(name, op, [x[0]], **attr), x[1]

    def cat(xs, name):
        axis = const(f"{name}/axis", np.int32(3))
        return (add(name, "Concat", [axis] + [n for n, _ in xs], T=f32,
                    N=AttrValue(i=len(xs))), sum(c for _, c in xs))

    def mixed_35(x, n, pool_proj):
        b0 = conv(x, 64, 1, 1, f"{n}/conv")
        t = conv(x, 48, 1, 1, f"{n}/tower/conv")
        b1 = conv(t, 64, 5, 5, f"{n}/tower/conv_1")
        t = conv(x, 64, 1, 1, f"{n}/tower_1/conv")
        t = conv(t, 96, 3, 3, f"{n}/tower_1/conv_1")
        b2 = conv(t, 96, 3, 3, f"{n}/tower_1/conv_2")
        p = pool(x, 3, 1, "SAME", f"{n}/tower_2/pool", "AvgPool")
        b3 = conv(p, pool_proj, 1, 1, f"{n}/tower_2/conv")
        return cat([b0, b1, b2, b3], f"{n}/join")

    def mixed_17(x, n, mid):
        b0 = conv(x, 192, 1, 1, f"{n}/conv")
        t = conv(x, mid, 1, 1, f"{n}/tower/conv")
        t = conv(t, mid, 1, 7, f"{n}/tower/conv_1")
        b1 = conv(t, 192, 7, 1, f"{n}/tower/conv_2")
        t = conv(x, mid, 1, 1, f"{n}/tower_1/conv")
        t = conv(t, mid, 7, 1, f"{n}/tower_1/conv_1")
        t = conv(t, mid, 1, 7, f"{n}/tower_1/conv_2")
        t = conv(t, mid, 7, 1, f"{n}/tower_1/conv_3")
        b2 = conv(t, 192, 1, 7, f"{n}/tower_1/conv_4")
        p = pool(x, 3, 1, "SAME", f"{n}/tower_2/pool", "AvgPool")
        b3 = conv(p, 192, 1, 1, f"{n}/tower_2/conv")
        return cat([b0, b1, b2, b3], f"{n}/join")

    def mixed_8x8(x, n, pool_op):
        b0 = conv(x, 320, 1, 1, f"{n}/conv")
        t = conv(x, 384, 1, 1, f"{n}/tower/conv")
        s0 = conv(t, 384, 1, 3, f"{n}/tower/mixed/conv")
        s1 = conv(t, 384, 3, 1, f"{n}/tower/mixed/conv_1")
        b1 = cat([s0, s1], f"{n}/tower/mixed")
        t = conv(x, 448, 1, 1, f"{n}/tower_1/conv")
        t = conv(t, 384, 3, 3, f"{n}/tower_1/conv_1")
        s0 = conv(t, 384, 1, 3, f"{n}/tower_1/mixed/conv")
        s1 = conv(t, 384, 3, 1, f"{n}/tower_1/mixed/conv_1")
        b2 = cat([s0, s1], f"{n}/tower_1/mixed")
        p = pool(x, 3, 1, "SAME", f"{n}/tower_2/pool", pool_op)
        b3 = conv(p, 192, 1, 1, f"{n}/tower_2/conv")
        return cat([b0, b1, b2, b3], f"{n}/join")

    add("img", "Placeholder", dtype=f32, shape=AttrValue(shape=TensorShape([299, 299, 3])))
    dim = const("ExpandDims/dim", np.int32(0))
    add("ExpandDims", "ExpandDims", ["img", dim], T=f32, Tdim=AttrValue(type=3))
    size = const("ResizeBilinear/size", np.array([299, 299], np.int32))
    add("ResizeBilinear", "ResizeBilinear", ["ExpandDims", size], T=f32,
        align_corners=AttrValue(b=False), half_pixel_centers=AttrValue(b=False))
    add("Sub", "Sub", ["ResizeBilinear", const("Sub/y", np.float32(128.0))], T=f32)
    x = add("Mul", "Mul", ["Sub", const("Mul/y", np.float32(1.0 / 128.0))], T=f32), 3
    # stem: 299 -> 149 -> 147 -> 73 -> 71 -> 35
    x = conv(x, 32, 3, 3, "conv", stride=2, padding="VALID")
    x = conv(x, 32, 3, 3, "conv_1", padding="VALID")
    x = conv(x, 64, 3, 3, "conv_2")
    x = pool(x, 3, 2, "VALID", "pool", "MaxPool")
    x = conv(x, 80, 1, 1, "conv_3", padding="VALID")
    x = conv(x, 192, 3, 3, "conv_4", padding="VALID")
    x = pool(x, 3, 2, "VALID", "pool_1", "MaxPool")
    x = mixed_35(x, "mixed", 32)
    x = mixed_35(x, "mixed_1", 64)
    x = mixed_35(x, "mixed_2", 64)
    b0 = conv(x, 384, 3, 3, "mixed_3/conv", stride=2, padding="VALID")
    t = conv(x, 64, 1, 1, "mixed_3/tower/conv")
    t = conv(t, 96, 3, 3, "mixed_3/tower/conv_1")
    b1 = conv(t, 96, 3, 3, "mixed_3/tower/conv_2", stride=2, padding="VALID")
    p = pool(x, 3, 2, "VALID", "mixed_3/pool", "MaxPool")
    x = cat([b0, b1, p], "mixed_3/join")
    for name, mid in (("mixed_4", 128), ("mixed_5", 160), ("mixed_6", 160),
                      ("mixed_7", 192)):
        x = mixed_17(x, name, mid)
    t = conv(x, 192, 1, 1, "mixed_8/tower/conv")
    b0 = conv(t, 320, 3, 3, "mixed_8/tower/conv_1", stride=2, padding="VALID")
    t = conv(x, 192, 1, 1, "mixed_8/tower_1/conv")
    t = conv(t, 192, 1, 7, "mixed_8/tower_1/conv_1")
    t = conv(t, 192, 7, 1, "mixed_8/tower_1/conv_2")
    b1 = conv(t, 192, 3, 3, "mixed_8/tower_1/conv_3", stride=2, padding="VALID")
    p = pool(x, 3, 2, "VALID", "mixed_8/pool", "MaxPool")
    x = cat([b0, b1, p], "mixed_8/join")
    x = mixed_8x8(x, "mixed_9", "AvgPool")
    x = mixed_8x8(x, "mixed_10", "MaxPool")
    pooled, _ = pool(x, 8, 1, "VALID", "pool_3", "AvgPool")
    shape = const("pool_3/_reshape/shape", np.array([1, 2048], np.int32))
    flat = add("pool_3/_reshape", "Reshape", [pooled, shape], T=f32, Tshape=AttrValue(type=3))
    w = const("softmax/weights", (rs.randn(2048, 1008) * 0.02).astype(np.float32))
    read = add("softmax/weights/read", "Identity", [w], T=f32)
    no = AttrValue(b=False)
    mm = add("softmax/logits/MatMul", "MatMul", [flat, read], T=f32, transpose_a=no,
             transpose_b=no, grad_a=no, grad_b=no)
    bias = const("softmax/biases", rs.randn(1008).astype(np.float32) * 0.05)
    logits = add("softmax/logits", "BiasAdd", [mm, bias], T=f32, data_format=nhwc)
    add("softmax", "Softmax", [logits], T=f32)
    return GraphDef(node=nodes + batchnorms, producer=8)


def write_inception_pb(path: Path, seed: int = 0) -> Path:
    path.write_bytes(serialize_graph_def(inception_graph_def(seed)))
    return path


@contextlib.contextmanager
def uncounted():
    """Launches inside are not the path's: every counter is put back to
    what it read on entry."""
    launches = read_launches()
    designs = read_designs()
    try:
        yield
    finally:
        for name, fn in COUNTERS.items():
            fn.launches = launches[name]
        for name, by_design in designs.items():
            COUNTERS[name].launches_by_design = dict(by_design)


def _rel(got, want) -> float:
    got, want = (torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor) else a)
                 .double().cpu() for a in (got, want))
    return float((got - want).abs().max() / want.abs().max())


def distance_bound_ms(rows, cols, dim) -> tuple[float, str]:
    """Least time for one distance block: u and v read once, the f32 block
    written once, or the 2*R*C*F operations of u @ v.T at the f32 peak
    (the norms are R*F + C*F more)."""
    nbytes = (rows + cols) * dim * 4 + rows * cols * 4
    flops = 2 * rows * cols * dim + 2 * (rows + cols) * dim
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FLOPS[torch.float32] * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops else "operations")


def phase_inception(card: str, pb: Path):
    """The synthetic graph through the port's reader and GraphDefFunction:
    256 64x64 images on the card against the same compiler on the CPU
    (pool, spatial and softmax, f32 with TF32 off), images/s; one distance
    block of 10000 x 10000 rows at the pool width against float64, timed
    beside its bound; precision and recall from the card's distances equal
    to those from the CPU's."""
    gen = np.random.default_rng(13)
    images = gen.integers(0, 256, (INCEPTION_IMAGES, 64, 64, 3), dtype=np.uint8)
    t0 = time.perf_counter()
    card_be = InceptionV3GraphFeatures(str(pb), batch_size=INCEPTION_IMAGES, device="cuda")
    load_s = time.perf_counter() - t0
    cpu_be = InceptionV3GraphFeatures(str(pb), batch_size=64, device="cpu")
    x = torch.from_numpy(images).cuda()
    card_be.features_tensor(x)  # warm-up: cuDNN's algorithm choice
    (pool, spatial), seconds = _timed(lambda: card_be.features_tensor(x))
    probs = card_be.softmax_probs(pool.cpu().numpy())
    c_pool, c_spatial = cpu_be.features(images)
    c_probs = cpu_be.softmax_probs(c_pool)
    errs = [_rel(pool, c_pool), _rel(spatial, c_spatial), _rel(probs, c_probs)]
    print(f"[inception] synthetic InceptionV3 graph ({pb.stat().st_size / 2 ** 20:.1f} MiB, "
          f"{len(card_be.graph.nodes)} nodes) read and placed in {load_s:.2f} s; "
          f"{INCEPTION_IMAGES} images 64x64 -> pool {tuple(pool.shape)}, spatial "
          f"{tuple(spatial.shape)}; card vs CPU relative error pool {errs[0]:.2e}, "
          f"spatial {errs[1]:.2e}, softmax {errs[2]:.2e} (tolerance {INCEPTION_RTOL})",
          flush=True)
    check(max(errs) <= INCEPTION_RTOL, f"inception card vs CPU: {errs}")
    check(bool(torch.isfinite(pool).all()), "inception: non-finite pool features")
    print(f"[inception] {INCEPTION_IMAGES / seconds:.2f} images/s at batch "
          f"{INCEPTION_IMAGES} (64 px resized to 299, f32, TF32 off), "
          f"{1e3 * seconds:.2f} ms [{card}]", flush=True)

    u = torch.randn(DIST_ROWS, DIST_DIM, generator=torch.Generator().manual_seed(14))
    v = torch.randn(DIST_ROWS, DIST_DIM, generator=torch.Generator().manual_seed(15)) + 0.1
    uc, vc = u.cuda(), v.cuda()
    d = pairwise_sq_distances(uc, vc)
    u64, v64 = u.double().numpy(), v.double().numpy()
    exact = ((u64 * u64).sum(1)[:, None] - 2.0 * (u64 @ v64.T) + (v64 * v64).sum(1)[None])
    err = float(np.abs(d.cpu().double().numpy() - exact).max() / np.abs(exact).max())
    ms = cuda_ms(lambda: pairwise_sq_distances(uc, vc), iters=10)
    bound, bound_by = distance_bound_ms(DIST_ROWS, DIST_ROWS, DIST_DIM)
    print(f"[inception] distance block {DIST_ROWS} x {DIST_ROWS} x {DIST_DIM} f32 (TF32 "
          f"off): max error {err:.2e} of max|d| against float64 (tolerance {DIST_RTOL}); "
          f"{ms:.3f} ms, bound {bound:.3f} ms ({bound_by}) [{card}]", flush=True)
    check(err <= DIST_RTOL, f"distance block error {err}")
    del d, uc, vc

    # Precision and recall of two halves of the images' pool features,
    # snapped to a 1/16 grid: every product and sum of a distance is then
    # exact in f32 in any order, so the two devices must agree exactly.
    feats = torch.round(pool.cpu() * 16) / 16
    ref, other = feats[: INCEPTION_IMAGES // 2].numpy(), feats[INCEPTION_IMAGES // 2:].numpy()
    pr = []
    for device in ("cuda", "cpu"):
        est = ManifoldEstimator(device=device)
        radii_1, radii_2 = est.manifold_radii(ref), est.manifold_radii(other)
        p, r = est.evaluate_pr(ref, radii_1, other, radii_2)
        pr.append((float(p[0]), float(r[0])))
    print(f"[inception] precision/recall from the card's distances {pr[0]}, from the "
          f"CPU's {pr[1]}", flush=True)
    check(pr[0] == pr[1], f"precision/recall card {pr[0]} vs CPU {pr[1]}")
    del card_be, cpu_be, x, pool, spatial
    torch.cuda.empty_cache()
    return {"images_per_s": INCEPTION_IMAGES / seconds, "dist_ms": ms, "dist_bound_ms": bound}


# The flagship recipe (run.sh) with --eval True, cut to 20 steps and 256
# samples; Gaussian latents, as the card's machine has no h5py.
EVAL_ARGS = ["--model", "DiT-B"] + MODEL_ARGS + [
    "--dataset", "Gaussian", "--weight_type", "lambda", "--mean_type", "EPSILON",
    "--path_type", "cosine", "--betas", "0.9", "0.95", "--total_steps", str(EVAL_STEPS),
    "--sample_freq", "0", "--save_step", "0", "--eval", "True",
    "--eval_step", str(EVAL_STEPS), "--num_samples", str(EVAL_SAMPLES),
    "--sample_size", str(EVAL_SAMPLE_SIZE), "--sample_steps", str(STEPS),
    "--solver", "heun", "--discretization", "edm", "--guidance_scale", "1.5"]


def write_ref_batch(root: Path) -> Path:
    """256 seeded 256 px uint8 images, smoothed so they are not white
    noise, as an npz reference batch."""
    gen = torch.Generator().manual_seed(16)
    low = torch.rand(EVAL_SAMPLES, 3, 16, 16, generator=gen)
    img = F.interpolate(low, size=(256, 256), mode="bilinear", align_corners=False)
    arr = (img.permute(0, 2, 3, 1) * 255).round().clamp(0, 255).to(torch.uint8).numpy()
    path = root / "ref_batch.npz"
    np.savez(path, arr)
    return path


def phase_eval(card: str, vae_path: Path, pb: Path, ref: Path):
    """The flagship recipe through vaw_torch.cli.main with --eval True:
    DiT-B/2 on 32x32x4 Gaussian latents, 20 bf16 steps at 256, then 256
    samples (18 Heun EDM steps, CFG 1.5, batches of 128) decoded by the
    seeded SD-VAE, their Inception features on the card and the metrics:
    one metrics.csv row of finite IS, FID, sFID, precision and recall and
    the samples npz. The launches are exact (20 x (12 + 12) + 2 x 35 x 12
    fused), and the evaluation's time is split by stage (the reference
    batch's features, read before training, apart)."""
    split: dict = {}

    def timed(name, fn):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            key = name(split) if callable(name) else name
            split[key] = split.get(key, 0.0) + time.perf_counter() - t0
            return out
        return wrapper

    def inception_stage(seen):
        return "inception" if "reference_inception" in seen else "reference_inception"

    Ev, Drv = eval_module.Evaluator, sampler_driver.Sampler
    patches = [mock.patch.object(Drv, "_edm_batch", timed("sampling", Drv._edm_batch)),
               mock.patch.object(Drv, "_decode", timed("decode", Drv._decode)),
               mock.patch.object(Ev, "compute_activations",
                                 timed(inception_stage, Ev.compute_activations)),
               mock.patch.object(Ev, "compute_inception_score",
                                 timed("inception_score", Ev.compute_inception_score)),
               mock.patch.object(Ev, "compute_statistics",
                                 timed("statistics", Ev.compute_statistics)),
               mock.patch.object(fid_module.FIDStatistics, "frechet_distance",
                                 timed("statistics", fid_module.FIDStatistics.frechet_distance)),
               mock.patch.object(Ev, "compute_prec_recall",
                                 timed("precision_recall", Ev.compute_prec_recall))]
    calls = (2 * STEPS - 1) * (EVAL_SAMPLES // EVAL_SAMPLE_SIZE)
    with tempfile.TemporaryDirectory(prefix="vaw_chip_eval_") as tmp, \
            environment({"VAW_VAE_PATH": str(vae_path), "VAW_INCEPTION_PB": str(pb)}), \
            contextlib.ExitStack() as stack:
        for patch in patches:
            stack.enter_context(patch)
        run = run_train_cli(EVAL_ARGS + ["--batch_size", str(DIT_TRAIN_BATCH),
                                         "--ref_batch", str(ref), "--logdir", tmp])
        free(run)
        with open(glob.glob(f"{tmp}/*/metrics.csv")[0]) as f:
            rows = list(csv.DictReader(f))
        npz = glob.glob(f"{tmp}/*/generate_sample/*_samples.npz")
        with np.load(npz[0]) as saved:
            shape = saved["arr_0"].shape
    # the decode runs inside each EDM batch: sampling is the rest
    split["sampling"] -= split.get("decode", 0.0)
    want = expect((DIT.fwd, EVAL_STEPS), (DIT.bwd, EVAL_STEPS), (DIT.fwd, calls))
    print(f"[eval] DiT-B/2 {EVAL_STEPS} steps at {DIT_TRAIN_BATCH} + eval of {EVAL_SAMPLES} "
          f"samples: metrics {rows}; samples npz {shape}; launches {run['launches']} "
          f"(expected {want})", flush=True)
    check(run["launches"] == want, f"eval launches {run['launches']}, expected {want}")
    check(len(rows) == 1 and int(rows[0]["Step"]) == EVAL_STEPS,
          f"metrics.csv rows {rows}")
    values = {k: float(v) for k, v in rows[0].items() if k != "Step"}
    check(set(values) == {"IS (EMA)", "FID (EMA)", "sFID (EMA)", "Pre. (EMA)", "Rec. (EMA)"}
          and all(map(math.isfinite, values.values())), f"metrics {values}")
    check(shape == (EVAL_SAMPLES, 256, 256, 3), f"samples npz of shape {shape}")
    total = sum(split.values())
    print("[eval] time split of the evaluation (host clock, synchronised): " + ", ".join(
        f"{k} {v:.2f} s" for k, v in split.items()) + f"; {total:.2f} s in all, CLI "
          f"wall {run['wall_s']:.2f} s (training and the reference batch included) "
          f"[{card}]", flush=True)
    return run["launches"], run["designs"], split


def phase_ddim(card: str):
    """DiT-B/2 through vaw_torch.cli.sample with --solver ddim over all 1000
    steps of the recipe's process: one batch of 64 at CFG 1.5 (128 rows),
    finite samples, exactly 1000 x 12 fused launches, samples/s."""
    finite, batch_s = [], []
    ddim_batch = sampler_driver.Sampler._ddim_batch
    inverse_normalize = sampler_driver._inverse_normalize

    def checked(x):
        finite.append(bool(torch.isfinite(x).all().item()))
        return inverse_normalize(x)

    def timed(self, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = ddim_batch(self, *args, **kwargs)
        torch.cuda.synchronize()
        batch_s.append(time.perf_counter() - t0)
        return out

    model = DIT.seeded()
    want = expect((DIT.fwd, DDIM_STEPS))
    with tempfile.TemporaryDirectory(prefix="vaw_chip_ddim_") as tmp:
        ckpt = Path(tmp) / "ema.pt"
        torch.save({"ema": {k: v.detach().cpu() for k, v in model.state_dict().items()},
                    "step": 0}, ckpt)
        del model
        argv = DIT.model_args + [
            "--solver", "ddim", "--diffusion_steps", str(DDIM_STEPS), "--sample_steps",
            str(DDIM_STEPS), "--path_type", "cosine", "--guidance_scale", "1.5",
            "--sample_size", str(SAMPLE_SIZE), "--num_samples", str(SAMPLE_SIZE),
            "--resume", str(ckpt), "--save_path", str(Path(tmp) / "samples")]
        with mock.patch.object(sampler_driver, "_inverse_normalize", checked), \
                mock.patch.object(sampler_driver.Sampler, "_ddim_batch", timed):
            reset_launches()
            sample_cli.main(argv)
            counts, designs = read_launches(), read_designs()
        pngs = list((Path(tmp) / "samples").rglob("*.png"))
    print(f"[ddim] DiT-B/2 DDIM {DDIM_STEPS} steps CFG 1.5 bf16, one batch of "
          f"{SAMPLE_SIZE}: {len(pngs)} PNGs, finite {finite}, launches {counts} (expected "
          f"{want}); {SAMPLE_SIZE / batch_s[0]:.2f} samples/s ({batch_s[0]:.2f} s, the "
          f"first batch, warm-up included) [{card}]", flush=True)
    check(len(pngs) == SAMPLE_SIZE and finite == [True], "DDIM samples")
    check(counts == want, f"DDIM launches {counts}, expected {want}")
    torch.cuda.empty_cache()
    return counts, designs, SAMPLE_SIZE / batch_s[0]


def phase_classifier(card: str, root: Path):
    """ADM-64 under VAW_PALLAS_CONV=1 through vaw_torch.cli.sample with
    --solver ddim --use_classifier (a seeded EncoderUNet .pt, attention
    pool, f32, frozen): 16 samples in batches of 4 over CLF_STEPS (at batch
    4 the p5 gate takes ADM-64's nine heads of 64 at 16 px). On the first
    step cond_fn's gradient is held against the same gradient through the
    plain versions of the kernels (uncounted). The p5, general and conv
    kernels launch, the conv filter gradient never (the weights are
    frozen)."""
    cfg = train_cli.parse_args(ADM64.model_args + ["--use_classifier", "x.pt"])
    with environment(ADM64.env):
        torch.manual_seed(17)
        clf = classifier_module.make_classifier_model(cfg, device="cuda")
        with torch.no_grad():  # no zero head: the gradient must not vanish
            for p in clf.parameters():
                p.add_(0.02 * torch.randn_like(p))
        clf_path = root / "classifier.pt"
        classifier_module.save_classifier_checkpoint(str(clf_path), clf)
        del clf
        model = ADM64.seeded()
    grads, batch_s = [], []
    condition_score = TorchGaussianDiffusion.condition_score
    ddim_batch = sampler_driver.Sampler._ddim_batch

    def checked_score(self, cond_fn, p_mean_var, x, t, model_kwargs=None):
        if not grads:
            with uncounted():
                t_model = self._model_t(t)
                got = cond_fn(x, t_model, **model_kwargs)
                with contextlib.ExitStack() as stack:
                    for target in ((unet_module, "multi_head_attention_packed", _plain_packed),
                                   (unet_module, "multi_head_attention", _plain_general),
                                   (unet_module, "conv3x3", conv3x3_reference)):
                        stack.enter_context(mock.patch.object(*target))
                    plain = cond_fn(x, t_model, **model_kwargs)
            grads.append(_rel(got, plain))
        return condition_score(self, cond_fn, p_mean_var, x, t, model_kwargs)

    def timed(self, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = ddim_batch(self, *args, **kwargs)
        torch.cuda.synchronize()
        batch_s.append(time.perf_counter() - t0)
        return out

    with tempfile.TemporaryDirectory(prefix="vaw_chip_clf_") as tmp, \
            environment(ADM64.env):
        ckpt = Path(tmp) / "ema.pt"
        torch.save({"ema": {k: v.detach().cpu() for k, v in model.state_dict().items()},
                    "step": 0}, ckpt)
        del model
        argv = ADM64.model_args + [
            "--solver", "ddim", "--diffusion_steps", str(CLF_STEPS), "--sample_steps",
            str(CLF_STEPS), "--path_type", "cosine", "--use_classifier", str(clf_path),
            "--guidance_scale", "1.0", "--sample_size", str(CLF_BATCH),
            "--num_samples", str(CLF_SAMPLES), "--resume", str(ckpt),
            "--save_path", str(Path(tmp) / "samples")]
        with mock.patch.object(TorchGaussianDiffusion, "condition_score", checked_score), \
                mock.patch.object(sampler_driver.Sampler, "_ddim_batch", timed):
            reset_launches()
            sample_cli.main(argv)
            counts, designs = read_launches(), read_designs()
        pngs = list((Path(tmp) / "samples").rglob("*.png"))
    rate = CLF_BATCH * (len(batch_s) - 1) / sum(batch_s[1:])
    print(f"[classifier] ADM-64 DDIM {CLF_STEPS} steps with classifier guidance (f32 "
          f"EncoderUNet, attention pool), {CLF_SAMPLES} samples in batches of {CLF_BATCH}: "
          f"{len(pngs)} PNGs; first-step gradient vs plain kernels relative error "
          f"{grads[0]:.2e} (tolerance {CLF_GRAD_RTOL}); launches {counts}; by kernel "
          f"{designs}", flush=True)
    print(f"[classifier] {rate:.2f} samples/s over batches 2-{len(batch_s)} (per batch "
          f"{[round(s, 2) for s in batch_s]} s) [{card}]", flush=True)
    check(len(pngs) == CLF_SAMPLES, f"classifier: {len(pngs)} PNGs")
    check(grads[0] <= CLF_GRAD_RTOL, f"classifier gradient error {grads[0]}")
    for name in ("flash_p5_fwd", "flash_p5_bwd", "flash_fwd", "flash_bwd", "conv3x3_fwd"):
        check(counts[name] > 0, f"classifier path: no {name} launch")
    for name in ("conv3x3_wgrad", "flash_fused_fwd", "flash_fused_bwd", "fused_act"):
        check(counts[name] == 0, f"classifier path: {counts[name]} {name} launches")
    # Each classifier call (a forward and its input gradient) runs its three
    # 32 px blocks, four 8 px blocks and its pool on the general kernels in
    # f32, each on the kernel the crossover picks (f32_rule: tf32x3 at
    # each).
    calls = CLF_SAMPLES // CLF_BATCH * CLF_STEPS
    want_f32 = dict.fromkeys(KERNEL_DESIGNS, 0)
    for (b, tq, tk, h, _, _), n in zip(CLF_GENERAL_F32, CLF_GENERAL_F32_CALLS):
        want_f32[f32_rule(b, tq, tk, h)] += n * calls
    check(designs["flash_bwd"] == want_f32,
          f"classifier path: backwards by kernel {designs['flash_bwd']}, expected {want_f32}")
    check({k: designs["flash_fwd"][k] for k in ("tf32x3", "fma")} ==
          {k: want_f32[k] for k in ("tf32x3", "fma")},
          f"classifier path: f32 forwards by kernel {designs['flash_fwd']}, expected "
          f"{want_f32}")
    # Its 16 px blocks' p5 forwards in f32 on the kernel the p5 forward's
    # crossover picks (576 score tiles: tf32x3).
    b, t, h, _ = F32_P5_SHAPE
    want_p5 = {"tf32x3": 0, "fma": 0}
    want_p5[f32_rule(b, t, t, h, P5_TF32X3_MIN_TILES)] = CLF_P5_F32_CALLS * calls
    check({k: designs["flash_p5_fwd"][k] for k in want_p5} == want_p5,
          f"classifier path: f32 p5 forwards by kernel {designs['flash_p5_fwd']}, "
          f"expected {want_p5}")
    # Their backwards (the input gradient) on tf32x3 at every size.
    want_p5_bwd = {"wgmma": 0, "mma_sync": 0, "fma": 0,
                   "tf32x3": CLF_P5_F32_CALLS * calls}
    check(designs["flash_p5_bwd"] == want_p5_bwd,
          f"classifier path: p5 backwards by kernel {designs['flash_p5_bwd']}, "
          f"expected {want_p5_bwd}")
    # The convs: the ADM-64 model's bf16 forward a step (ADM64.fwd_design),
    # each classifier call's f32 convs and dgrads (CLF_CONV_F32).
    want_conv = dict.fromkeys(CONV_DESIGNS, 0)
    for per_call in (ADM64.fwd_design["conv3x3_fwd"], CLF_CONV_F32):
        for k, n in per_call.items():
            want_conv[k] += n * calls
    check(designs["conv3x3_fwd"] == want_conv,
          f"classifier path: convs by kernel {designs['conv3x3_fwd']}, expected {want_conv}")
    torch.cuda.empty_cache()
    return counts, designs, rate


def phase_slice13(card: str, by_path: dict, designs_by_path: dict):
    """Evaluation and the DDIM/classifier samplers, on seeded weights and a
    synthetic InceptionV3 graph written to a temporary directory."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="vaw_chip_slice13_") as tmp:
        root = Path(tmp)
        pb = write_inception_pb(root / "classify_image_graph_def.pb")
        phase_inception(card, pb)
        vae_path = write_seeded_vae(root)
        ref = write_ref_batch(root)
        by_path["eval_dit"], designs_by_path["eval_dit"], _ = phase_eval(card, vae_path, pb, ref)
        by_path["sample_dit_ddim"], designs_by_path["sample_dit_ddim"], _ = phase_ddim(card)
        (by_path["sample_adm64_classifier"], designs_by_path["sample_adm64_classifier"],
         _) = phase_classifier(card, root)
    print(f"[slice13] inception, eval, ddim and classifier phases in "
          f"{time.perf_counter() - t0:.1f} s [{card}]", flush=True)


DDP_LOSS_RTOL, FSDP_LOSS_RTOL = 1e-3, 1e-2
TP_TOL = {torch.float32: (1e-4, 1e-3), torch.bfloat16: (2e-2, 5e-2)}  # forward, grads
TP_BATCH = 32


def torchrun_child(out_path: str, argv: list) -> int:
    """Child mode under the launcher: run_train_cli(argv) in this process
    (one rank of the group the CLI joins) and write its numbers to
    `out_path` from rank 0."""
    import torch.distributed as dist

    from vaw_torch.parallel.partition import sharding_census

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seen = {}
    train = train_cli.train

    def recorded_train(cfg, ctx):
        # The group the CLI joined, read while it is up.
        seen.update(backend=dist.get_backend(), world=dist.get_world_size(),
                    sharded=len(sharding_census(ctx["trainer"].model)["sharded"]))
        return train(cfg, ctx)

    with mock.patch.object(train_cli, "train", recorded_train):
        run = run_train_cli(argv)
    record = {k: run[k] for k in ("launches", "designs", "losses", "imgs_per_s",
                                  "ms_per_step", "peak_gib", "wall_s")}
    record.update(seen, logdir=run["ctx"]["trainer"].cfg.logdir)
    if int(os.environ["RANK"]) == 0:
        Path(out_path).write_text(json.dumps(record))
    return 0


def _launcher_run(card: str, tag: str, argv: list, tmp: str) -> dict:
    """DiT-B/2's train phase through torchrun at world 1 (NCCL)."""
    out = os.path.join(tmp, f"{tag}.json")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "1", os.path.abspath(__file__), "--torchrun-child",
           out] + argv
    env = {k: v for k, v in os.environ.items() if k != "VAW_PLATFORM"}
    t0 = time.perf_counter()
    res = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    check(res.returncode == 0 and os.path.exists(out),
          f"torchrun {tag}: exit {res.returncode}\n{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
    run = json.loads(Path(out).read_text())
    run["launcher_wall_s"] = wall
    return run


def phase_launcher(card: str, by_path: dict, designs_by_path: dict):
    """DDP and FSDP over NCCL at world 1 through torchrun, against phase 6."""
    plain = TRAIN_RUNS[DIT.tag]
    argv = DIT.model_args + RECIPE_ARGS + ["--batch_size", str(DIT.train_batch)]
    with tempfile.TemporaryDirectory(prefix="vaw_chip_slice14_") as tmp:
        for tag, extra, rtol in (("ddp", [], DDP_LOSS_RTOL),
                                 ("fsdp", ["--fsdp", "True"], FSDP_LOSS_RTOL)):
            gc.collect()
            torch.cuda.empty_cache()
            run = _launcher_run(card, tag, argv + extra + ["--logdir", f"{tmp}/{tag}"], tmp)
            check(run["world"] == 1 and run["backend"] == "nccl",
                  f"{tag}: world {run['world']}, backend {run['backend']}")
            check_run(f"train {DIT.tag} torchrun {tag}", run, TRAIN_STEPS, DIT.fwd,
                      DIT.bwd, DIT.fwd_design, DIT.bwd_design)
            last, want = run["losses"][-1], plain["losses"][-1]
            print(f"[slice14] {tag}: NCCL world 1 through torchrun, {run['sharded']} "
                  f"parameters sharded; {run['imgs_per_s']:.2f} imgs/s over steps "
                  f"{TRAIN_WARMUP + 1}-{TRAIN_STEPS} (phase 6, no process group: "
                  f"{plain['imgs_per_s']:.2f}), {run['ms_per_step']:.2f} ms/step, peak "
                  f"memory {run['peak_gib']:.2f} GiB (phase 6: {plain['peak_gib']:.2f}), "
                  f"step-30 loss {last:.6f} against phase 6's {want:.6f} (relative "
                  f"difference {abs(last - want) / abs(want):.2e}, tolerance {rtol:.0e}); "
                  f"launcher wall {run['launcher_wall_s']:.1f} s [{card}]", flush=True)
            check(abs(last - want) <= rtol * abs(want),
                  f"{tag}: step-30 loss {last} against phase 6's {want}")
            by_path[f"train_dit_{tag}"] = run["launches"]
            designs_by_path[f"train_dit_{tag}"] = run["designs"]
            if tag == "fsdp":
                name = checkpoint_name(train_cli.parse_args(argv), TRAIN_STEPS)
                ckpts = glob.glob(f"{run['logdir']}/checkpoint/{name}.pt")
                check(len(ckpts) == 1, f"fsdp checkpoint of step {TRAIN_STEPS}: {ckpts}")
                save = f"{tmp}/samples"
                with uncounted():
                    sample_cli.main(DIT.model_args + [
                        "--resume", ckpts[0], "--num_samples", "16", "--sample_size", "16",
                        "--sample_steps", "4", "--save_path", save])
                pngs = glob.glob(f"{save}/**/*.png", recursive=True)
                check(len(pngs) == 16, f"fsdp checkpoint sampled: {len(pngs)} PNGs")
                print(f"[slice14] the FSDP run's {Path(ckpts[0]).name} (full tensors, "
                      f"reference names) loads into the plain sampler: {len(pngs)} PNGs",
                      flush=True)


def phase_tp_split(card: str):
    """One DiT-B/2 block split at tp 2 and 4 through the TP shard function,
    each shard on the fused kernels at its heads, against the whole block."""
    from vaw_torch.models.dit import DiTBlock
    from vaw_torch.parallel.partition import (
        tp_local_shard,
        tp_split_dit_block,
        tp_split_dit_block_forward,
    )

    torch.manual_seed(0)
    block = DiTBlock(768, 12).cuda()
    with torch.no_grad():
        for p in block.parameters():
            p.normal_(0.0, 0.02)
    for dtype in (torch.float32, torch.bfloat16):
        gen = torch.Generator(device="cuda").manual_seed(1)
        x0 = torch.randn(TP_BATCH, T_MAIN, 768, device="cuda", generator=gen).to(dtype)
        c = torch.randn(TP_BATCH, 768, device="cuda", generator=gen).to(dtype)
        g = torch.randn(TP_BATCH, T_MAIN, 768, device="cuda", generator=gen).to(dtype)
        block.zero_grad()
        x = x0.clone().requires_grad_()
        with uncounted():
            ref = block(x, c)
            (ref.float() * g.float()).sum().backward()
        ref_grads = {k: p.grad.detach().clone() for k, p in block.named_parameters()}
        fwd_tol, grad_tol = TP_TOL[dtype]
        for tp in (2, 4):
            shards = tp_split_dit_block(block, tp)
            xs = x0.clone().requires_grad_()
            before = read_launches()
            with uncounted():
                out = tp_split_dit_block_forward(shards, xs, c)
                (out.float() * g.float()).sum().backward()
                launches = {k: v - before[k] for k, v in read_launches().items() if v != before[k]}
            errs = {"out": _rel(out.detach(), ref.detach()),
                    "dx": _rel(xs.grad, x.grad)}
            for name, p in block.named_parameters():
                qkv = name.startswith("attn.qkv.")
                pieces = [dict(s.named_parameters())[name].grad for s in shards]
                want = [tp_local_shard(f"blocks.0.{name}", ref_grads[name], r, tp,
                                       12 if qkv else None) for r in range(tp)]
                if pieces[0].shape == ref_grads[name].shape:  # replicated: one rank's
                    errs[name] = _rel(pieces[0], ref_grads[name])
                else:
                    errs[name] = max(_rel(a, b) for a, b in zip(pieces, want))
            worst = max((k for k in errs if k != "out"), key=errs.get)
            print(f"[slice14] tp {tp} {str(dtype)[6:]}: {12 // tp} heads a shard, "
                  f"fused launches {launches}, out rel err {errs['out']:.2e} (tol "
                  f"{fwd_tol:.0e}), worst gradient {worst} {errs[worst]:.2e} (tol "
                  f"{grad_tol:.0e}) [{card}]", flush=True)
            check(launches.get("flash_fused_fwd") == tp and launches.get("flash_fused_bwd") == tp,
                  f"tp {tp}: launches {launches}, expected {tp} fused forwards and backwards")
            check(errs["out"] <= fwd_tol, f"tp {tp} {dtype}: out rel err {errs['out']}")
            check(errs[worst] <= grad_tol, f"tp {tp} {dtype}: {worst} rel err {errs[worst]}")
    del block
    torch.cuda.empty_cache()


def phase_slice14(card: str, by_path: dict, designs_by_path: dict):
    """Training on more than one GPU, as far as one card shows it."""
    t0 = time.perf_counter()
    phase_launcher(card, by_path, designs_by_path)
    phase_tp_split(card)
    print(f"[slice14] launcher and tp phases in {time.perf_counter() - t0:.1f} s "
          f"[{card}]", flush=True)


# The last module slice (phase_slice15): upfirdn2d at StyleGAN2's 64 px
# level with 512 channels; the profiler around DiT-B/2's train step at 256;
# the preprocessing tools on seeded inputs.
UPFIRDN_SHAPE = (16, 64, 64, 512)
UPFIRDN_RTOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}  # of max|CPU result|
UPFIRDN_GRAD2_RTOL = 1e-4  # second derivative, f32, TF32 off
PROFILE_STEPS, TIMER_STEPS, TIMER_RTOL = 3, 10, 0.05
FLOPS_BATCH, FLOPS_RTOL = 8, 0.01
IMAGENET_JPEGS, CELEBA_IMAGES, LSUN_IMAGES = 64, 16, 16
REF_STATS_IMAGES, REF_STATS_SIZE, REF_STATS_FID = 4096, 32, 1e-3


def phase_upfirdn(card: str):
    """upsample2d, downsample2d, blur and a negative-pad upfirdn2d on the
    card (one depthwise cuDNN conv each) against the same call on the CPU
    copy, f32 and bf16, with the ms a call beside the bytes bound (input
    read once, output written once); one second derivative card vs CPU."""
    gen = torch.Generator().manual_seed(21)
    x32 = torch.randn(UPFIRDN_SHAPE, generator=gen)
    k = upfirdn_ops.make_kernel([1, 3, 3, 1])
    calls = {"upsample2d": upfirdn_ops.upsample2d,
             "downsample2d": upfirdn_ops.downsample2d,
             "blur": upfirdn_ops.blur,
             "upfirdn2d(up=2, pad=(-1, 2))":
                 lambda x: upfirdn_ops.upfirdn2d(x, k, up=2, pad=(-1, 2))}
    with torch.no_grad():
        for dtype in (torch.float32, torch.bfloat16):
            x = x32.to(dtype)
            xc = x.cuda()
            for name, fn in calls.items():
                want = fn(x).cuda().float()
                got = fn(xc)
                err = float((got.float() - want).abs().max() / want.abs().max())
                ms = cuda_ms(lambda: fn(xc), iters=20)
                nbytes = (x.numel() + got.numel()) * x.element_size()
                print(f"[upfirdn2d] {name} {tuple(x.shape)} -> {tuple(got.shape)} "
                      f"{str(dtype)[6:]}: card vs CPU max rel err {err:.2e} (tol "
                      f"{UPFIRDN_RTOL[dtype]:.0e}); {ms:.4f} ms a call, bytes bound "
                      f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms [{card}]", flush=True)
                check(got.dtype == dtype and got.shape == want.shape,
                      f"upfirdn2d {name}: {got.dtype} {tuple(got.shape)}")
                check(err <= UPFIRDN_RTOL[dtype], f"upfirdn2d {name} {dtype}: rel err {err}")
                del want, got
            del x, xc
    hessians = []
    for device in ("cuda", "cpu"):
        xs = torch.randn(2, 16, 16, 8, generator=torch.Generator().manual_seed(22))
        xs = xs.to(device).requires_grad_()
        loss = (upfirdn_ops.upfirdn2d(xs, k, up=2, down=2, pad=(1, 1)) ** 2).sum()
        (g,) = torch.autograd.grad(loss, xs, create_graph=True)
        (h,) = torch.autograd.grad((g ** 2).sum(), xs)
        hessians.append(h.cpu())
    err = _rel(*hessians)
    print(f"[upfirdn2d] second derivative card vs CPU, f32: max rel err {err:.2e} (tol "
          f"{UPFIRDN_GRAD2_RTOL:.0e})", flush=True)
    check(err <= UPFIRDN_GRAD2_RTOL, f"upfirdn2d second derivative rel err {err}")
    torch.cuda.empty_cache()


def phase_profiler(card: str, by_path: dict, designs_by_path: dict):
    """utils/profiling.py around DiT-B/2's train step at 256 through
    Trainer: trace() over PROFILE_STEPS steps and summarize_trace (busy as
    the union of device intervals, beside the summed event times), the
    step's launches counted; StepTimer over TIMER_STEPS steps against CUDA
    events; compiled_flops of a forward at FLOPS_BATCH on the card against
    the same weights on the CPU, beside estimate_train_flops."""
    argv = DIT.model_args + RECIPE_ARGS + ["--batch_size", str(DIT_TRAIN_BATCH)]
    cfg = train_cli.parse_args(argv)
    torch.manual_seed(0)
    model = build_model(cfg, device="cuda")
    trainer = Trainer(cfg, model, train_cli.build_diffusion(cfg))
    state = trainer.init_state()
    gen = torch.Generator(device="cuda").manual_seed(6)
    n = DIT_TRAIN_BATCH
    batch = {"image": torch.randn(n, 32, 32, 4, generator=gen, device="cuda"),
             "label": torch.randint(0, 1000, (n,), generator=gen, device="cuda")}
    for _ in range(3):  # warm-up: cuBLAS and cuDNN choices, the allocator
        state, metrics = trainer.step(state, batch)
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory(prefix="vaw_chip_trace_") as logdir:
        reset_launches()
        with profiling.trace(logdir) as prof:
            t0 = time.perf_counter()
            for _ in range(PROFILE_STEPS):
                state, metrics = trainer.step(state, batch)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        launches, designs = read_launches(), read_designs()
        old_sum = sum(e.self_device_time_total for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
        mib = os.path.getsize(prof.trace_path) / 2 ** 20
        t0 = time.perf_counter()
        summary = profiling.summarize_trace(prof.trace_path)
        read_s = time.perf_counter() - t0
    want = expect((DIT.fwd, PROFILE_STEPS), (DIT.bwd, PROFILE_STEPS))
    check(launches == want, f"profiled steps launched {launches}, expected {want}")
    want_designs = expect_designs((DIT.fwd_design, PROFILE_STEPS),
                                  (DIT.bwd_design, PROFILE_STEPS))
    check(designs == want_designs, f"profiled steps by kernel {designs}, expected "
          f"{want_designs}")
    by_path["train_dit_profiled"], designs_by_path["train_dit_profiled"] = launches, designs
    cats = summary["categories"]
    summed = sum(cats.values())
    busy, span = summary["busy_ms"], summary["span_ms"]
    # B1's and B2's bf16 calls run flash_fwd.cu's wgmma kernel and
    # flash_bwd.cu's wgmma pair, named flash_fwd_* and flash_bwd_*.
    attn = {c: cats.get(c, 0.0) for c in ("general attention fwd kernel",
                                          "general attention bwd kernel")}
    print(f"[profiler] trace() over {PROFILE_STEPS} DiT-B/2 steps at {n}: "
          f"{wall_ms / PROFILE_STEPS:.2f} ms a step (traced wall), Chrome trace "
          f"{mib:.1f} MiB read in {read_s:.2f} s; device busy (union) "
          f"{busy / PROFILE_STEPS:.2f} ms a step = {busy / wall_ms:.1%} of the wall, "
          f"span {span / PROFILE_STEPS:.2f}; the trace's event times summed "
          f"{summed / PROFILE_STEPS:.2f}; the old figure (key_averages' CUDA self "
          f"times summed) {old_sum / PROFILE_STEPS:.2f} ms a step = "
          f"{old_sum / wall_ms:.1%}; "
          f"attention {({c: round(v / PROFILE_STEPS, 3) for c, v in attn.items()})} "
          f"ms a step; launches {launches} [{card}]", flush=True)
    for cat, ms in cats.items():
        print(f"[profiler]   {cat:28s} {ms / PROFILE_STEPS:9.3f} ms a step", flush=True)
    check(all(v > 0 for v in attn.values()), f"profiler: attention categories {attn}")
    # busy and summed add the same microseconds in other orders and forms
    # (ends less starts, durations): equal where nothing overlaps.
    check(0 < busy <= span and busy <= summed * (1 + 1e-6),
          f"profiler: busy {busy} ms, span {span} ms, summed {summed} ms")

    timer = profiling.StepTimer(n, window=TIMER_STEPS)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    timer.lap()
    start.record()
    for i in range(TIMER_STEPS):
        state, metrics = trainer.step(state, batch)
        if i == TIMER_STEPS - 1:
            end.record()
        rates = timer.lap(metrics["loss"])
    torch.cuda.synchronize()
    events_ms = start.elapsed_time(end) / TIMER_STEPS
    rel = abs(rates["step_ms"] - events_ms) / events_ms
    print(f"[profiler] StepTimer over {TIMER_STEPS} steps: {rates['step_ms']:.2f} ms a "
          f"step, {rates['imgs_per_sec']:.2f} imgs/s ({rates['imgs_per_sec_chip']:.2f} "
          f"a card); CUDA events {events_ms:.2f} ms a step; relative difference "
          f"{rel:.2%} (tolerance {TIMER_RTOL:.0%}) [{card}]", flush=True)
    check(rel <= TIMER_RTOL, f"StepTimer {rates['step_ms']} ms vs CUDA events {events_ms}")
    del trainer, state, model, batch, metrics
    gc.collect()
    torch.cuda.empty_cache()

    model = seeded_dit_b()
    cpu_model = seeded_dit_b().cpu()
    gen = torch.Generator().manual_seed(7)
    x = torch.randn(FLOPS_BATCH, 32, 32, 4, generator=gen)
    t = torch.rand(FLOPS_BATCH, generator=gen) * 999
    y = torch.randint(0, 1000, (FLOPS_BATCH,), generator=gen)
    with torch.no_grad(), uncounted():
        card_flops = profiling.compiled_flops(model, x.cuda(), t.cuda(), y.cuda())
    with torch.no_grad():
        cpu_flops = profiling.compiled_flops(cpu_model, x, t, y)
    check(card_flops is not None and cpu_flops, f"compiled_flops {card_flops}, {cpu_flops}")
    rel = abs(card_flops - cpu_flops) / cpu_flops
    n_params = sum(p.numel() for p in model.parameters())
    est = profiling.estimate_train_flops(n_params, 256)
    print(f"[profiler] compiled_flops of a DiT-B/2 forward at batch {FLOPS_BATCH}: "
          f"card {card_flops:.6e} (the kernels' records included), CPU {cpu_flops:.6e}, "
          f"relative difference {rel:.2e} (tolerance {FLOPS_RTOL:.0e}); "
          f"{card_flops / FLOPS_BATCH:.4e} an image against estimate_train_flops' "
          f"forward 2PT = {est / 3:.4e} ({n_params} parameters, T = 256; train 6PT = "
          f"{est:.4e}) [{card}]", flush=True)
    check(rel <= FLOPS_RTOL, f"compiled_flops card {card_flops} vs CPU {cpu_flops}")
    del model, cpu_model
    torch.cuda.empty_cache()


def _image_size(path: Path) -> tuple:
    with Image.open(path) as im:
        return im.size


def _seeded_jpegs(root: Path, n: int, rng) -> Path:
    for i in range(n):
        d = root / ("n01440764", "n01443537")[i % 2]
        d.mkdir(parents=True, exist_ok=True)
        w, h = (int(v) for v in rng.integers(80, 400, 2))
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
            d / f"img_{i:04d}.JPEG", quality=90)
    return root


def phase_preprocess(card: str):
    """The preprocessing tools on seeded inputs: resize_imagenet (64 JPEGs
    in two classes), preprocess_celeba (16 images at CelebA's 178x218 with
    a partition file), export_lsun where lmdb imports, and compute_ref_stats
    on the card with the seeded InceptionV3 graph (4096 32x32 PNGs): its npz
    keys and arr_0, the FID of the npz against itself, the wall time."""
    rng = np.random.default_rng(23)
    with tempfile.TemporaryDirectory(prefix="vaw_chip_slice15_") as tmp:
        root = Path(tmp)
        src = _seeded_jpegs(root / "imagenet", IMAGENET_JPEGS, rng)
        count, seconds = _timed(lambda: preprocessing.resize_imagenet(
            str(src), str(root / "imagenet64"), 64, workers=8))
        outs = sorted((root / "imagenet64").rglob("*.JPEG"))
        sizes = {_image_size(p) for p in outs}
        print(f"[preprocess] resize_imagenet: {count} JPEGs in 2 classes -> "
              f"{len(outs)} files of {sizes} in {seconds:.2f} s", flush=True)
        check(count == len(outs) == IMAGENET_JPEGS and sizes == {(64, 64)},
              f"resize_imagenet: {count}, {len(outs)} files, sizes {sizes}")

        celeba = root / "celeba"
        (celeba / "img_align_celeba").mkdir(parents=True)
        rows = []
        for i in range(CELEBA_IMAGES):
            name = f"{i + 1:06d}.jpg"
            Image.fromarray(rng.integers(0, 256, (218, 178, 3), dtype=np.uint8)).save(
                celeba / "img_align_celeba" / name, quality=95)
            rows.append(f"{name} {(0, 0, 0, 0, 0, 0, 1, 2)[i % 8]}")
        (celeba / "list_eval_partition.txt").write_text("\n".join(rows) + "\n")
        preprocessing.preprocess_celeba(str(celeba), str(root / "celeba64"))
        split = {s: sorted((root / "celeba64" / s / "celeba").glob("*.jpg"))
                 for s in ("train", "val", "test")}
        sizes = {_image_size(p) for ps in split.values() for p in ps}
        print(f"[preprocess] preprocess_celeba: {CELEBA_IMAGES} images 178x218 -> "
              f"{ {s: len(ps) for s, ps in split.items()} } of {sizes}", flush=True)
        check([len(split[s]) for s in ("train", "val", "test")] == [12, 2, 2]
              and sizes == {(64, 64)}, f"preprocess_celeba: {split}, {sizes}")

        try:
            import lmdb
        except ImportError as e:
            print(f"[preprocess] lmdb does not import here ({e}): export_lsun is not "
                  "run", flush=True)
        else:
            db = root / "bedroom_lmdb"
            env = lmdb.open(str(db), map_size=1 << 30)
            with env.begin(write=True) as txn:
                for i in range(LSUN_IMAGES):
                    buf = io.BytesIO()
                    Image.fromarray(rng.integers(0, 256, (300, 400, 3), dtype=np.uint8)
                                    ).save(buf, format="JPEG")
                    txn.put(f"{i:040x}".encode(), buf.getvalue())
            env.close()
            count = preprocessing.export_lsun(str(db), str(root / "lsun"), 64)
            pngs = sorted((root / "lsun").glob("*.png"))
            print(f"[preprocess] export_lsun: {count} PNGs", flush=True)
            check(count == len(pngs) == LSUN_IMAGES, f"export_lsun: {count}, {len(pngs)}")

        pb = write_inception_pb(root / "classify_image_graph_def.pb")
        pngs = root / "pngs"
        for i in range(REF_STATS_IMAGES):
            d = pngs / f"class{i % 10}"
            d.mkdir(parents=True, exist_ok=True)
            Image.fromarray(rng.integers(0, 256, (REF_STATS_SIZE, REF_STATS_SIZE, 3),
                                         dtype=np.uint8)).save(d / f"{i:05d}.png")
        with environment({"VAW_INCEPTION_PB": str(pb)}):
            path, seconds = _timed(lambda: preprocessing.compute_ref_stats(
                str(pngs), "seeded", REF_STATS_SIZE, batch_size=256,
                output_path=str(root / "VIRTUAL_seeded32.npz"), device="cuda"))
        with np.load(path) as npz:
            keys = sorted(npz.files)
            stats = FIDStatistics(npz["mu"], npz["sigma"])
            arr_shape, arr_dtype = npz["arr_0"].shape, npz["arr_0"].dtype
        t0 = time.perf_counter()
        fid = stats.frechet_distance(stats)
        fid_s = time.perf_counter() - t0
        print(f"[preprocess] compute_ref_stats on the card: {REF_STATS_IMAGES} PNGs "
              f"{REF_STATS_SIZE}x{REF_STATS_SIZE} -> {Path(path).name} {keys}, arr_0 "
              f"{arr_shape} {arr_dtype}, in {seconds:.2f} s wall; the npz's FID "
              f"against itself {fid:.3e} (limit {REF_STATS_FID:.0e}; {fid_s:.2f} s on the "
              f"host) [{card}]", flush=True)
        check(keys == ["arr_0", "mu", "mu_s", "sigma", "sigma_s"], f"npz keys {keys}")
        check(arr_shape == (REF_STATS_IMAGES, REF_STATS_SIZE, REF_STATS_SIZE, 3)
              and arr_dtype == np.uint8, f"arr_0 {arr_shape} {arr_dtype}")
        check(math.isfinite(fid) and abs(fid) < REF_STATS_FID, f"self FID {fid}")


def phase_slice15(card: str, by_path: dict, designs_by_path: dict):
    """upfirdn2d, the profiling utilities and the preprocessing tools."""
    t0 = time.perf_counter()
    phase_upfirdn(card)
    phase_profiler(card, by_path, designs_by_path)
    phase_preprocess(card)
    print(f"[slice15] upfirdn2d, profiler and preprocessing phases in "
          f"{time.perf_counter() - t0:.1f} s [{card}]", flush=True)


# The attention switches and the reference readers (phase_slice16).
# DiT-B/2's attention under each setting: the environment, then the
# kernels of one forward and of one backward and their launches by kernel
# (every DiT-B/2 call is bf16 with D = 64: each on its wgmma kernels). At
# T = 256 with 12 heads of 64 the p5 gate takes B = 128 and 256
# (vaw_torch/ops/flash_attention.py:_packed5_supported).
DIT_ROUTES = {
    "default": ({}, {"flash_fused_fwd": 12}, {"flash_fused_bwd": 12},
                {"flash_fused_fwd": {"wgmma": 12}}, {"flash_fused_bwd": {"wgmma": 12}}),
    "tmajor0": ({"VAW_FUSED_TMAJOR": "0"}, {"flash_p5_fwd": 12}, {"flash_p5_bwd": 12},
                {"flash_p5_fwd": {"wgmma": 12}}, {"flash_p5_bwd": {"wgmma": 12}}),
    "split": ({"VAW_FUSED_TMAJOR": "0", "VAW_PACKED_QKV": "0"}, {"flash_fwd": 12},
              {"flash_bwd": 12}, {"flash_fwd": {"wgmma": 12}}, {"flash_bwd": {"wgmma": 12}}),
    "noflash": ({"VAW_DISABLE_FLASH": "1"}, {}, {}, {}, {}),
}
SWITCH_STEPS = 5
# The p5 kernels at DiT-B/2's shape: the forward at the sampling batch, the
# backward at the training batch.
DIT_P5_SHAPES = ((2 * SAMPLE_SIZE, 256, 12, 64), (DIT_TRAIN_BATCH, 256, 12, 64))


def _bf16_forward(model, fam_image, classes, env):
    """One bf16 forward at B = 128 under `env` (read at each call): the
    output and the launches it made, by kernel and by design."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    b = 2 * SAMPLE_SIZE
    x = torch.randn((b, *fam_image), generator=gen, device="cuda")
    t = torch.rand((b,), generator=gen, device="cuda") * 999
    y = torch.randint(0, classes, (b,), generator=gen, device="cuda")
    with environment(env), torch.inference_mode():
        reset_launches()
        out = _out(model(x, t, y)).float()
        torch.cuda.synchronize()
        return out, read_launches(), read_designs()


def _route_check(tag: str, got, want, launches, designs, fwd: dict, fwd_design: dict):
    rel = (got - want).abs().max().item() / want.abs().max().item()
    want_launches, want_designs = expect((fwd, 1)), expect_designs((fwd_design, 1))
    print(f"[slice16] {tag} bf16 B={got.shape[0]}: max|out - default route| / max|out| "
          f"{rel:.3e} (tol {MODEL_BF16_RTOL:.0e}); launches "
          f"{ {k: n for k, n in launches.items() if n} } (expected "
          f"{ {k: n for k, n in want_launches.items() if n} })", flush=True)
    check(torch.isfinite(got).all().item(), f"{tag}: non-finite output")
    check(rel <= MODEL_BF16_RTOL, f"{tag}: forward differs from the default route by {rel}")
    check(launches == want_launches, f"{tag}: launches {launches}, expected {want_launches}")
    check(designs == want_designs, f"{tag}: by kernel {designs}, expected {want_designs}")


def phase_dit_routes(card: str, by_path: dict, designs_by_path: dict):
    """DiT-B/2 under each DIT_ROUTES setting: one bf16 forward at B = 128
    against the default route's, then SWITCH_STEPS train steps at 256
    through Trainer on resident batches (after one uncounted step), with
    ms a step (CUDA events), peak memory and exact launches."""
    model = cast_for_compute(seeded_dit_b(), torch.bfloat16)
    want = None
    for name, (env, fwd, _, fwd_design, _) in DIT_ROUTES.items():
        got, launches, designs = _bf16_forward(model, DIT.image, DIT.classes, env)
        want = got if want is None else want
        _route_check(f"DiT-B/2 {name}", got, want, launches, designs, fwd, fwd_design)
    del model, got, want
    torch.cuda.empty_cache()
    argv = DIT.model_args + RECIPE_ARGS + ["--batch_size", str(DIT_TRAIN_BATCH)]
    cfg = train_cli.parse_args(argv)
    gen = torch.Generator(device="cuda").manual_seed(9)
    n = DIT_TRAIN_BATCH
    batch = {"image": torch.randn(n, 32, 32, 4, generator=gen, device="cuda"),
             "label": torch.randint(0, 1000, (n,), generator=gen, device="cuda")}
    for name, (env, fwd, bwd, fwd_design, bwd_design) in DIT_ROUTES.items():
        with environment(env):
            torch.manual_seed(0)
            trainer = Trainer(cfg, build_model(cfg, device="cuda"),
                              train_cli.build_diffusion(cfg))
            state = trainer.init_state()
            state, metrics = trainer.step(state, batch)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            losses = []
            for _ in range(SWITCH_STEPS):
                state, metrics = trainer.step(state, batch)
                losses.append(metrics["loss"])
            end.record()
            torch.cuda.synchronize()
            launches, designs = read_launches(), read_designs()
            ms = start.elapsed_time(end) / SWITCH_STEPS
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
        values = [float(v) for v in losses]
        path = f"train_dit_{name}"
        by_path[path], designs_by_path[path] = launches, designs
        print(f"[slice16] train DiT-B/2 {name} ({env or 'no switch set'}): "
              f"{SWITCH_STEPS} steps at {n}, {ms:.2f} ms a step (CUDA events), peak "
              f"memory {peak:.2f} GiB, losses {[round(v, 5) for v in values]} [{card}]",
              flush=True)
        check_run(path, {"losses": values, "launches": launches, "designs": designs},
                  SWITCH_STEPS, fwd, bwd, fwd_design, bwd_design)
        del trainer, state, metrics, losses
        gc.collect()
        torch.cuda.empty_cache()


def phase_packed_off(card: str, by_path: dict, designs_by_path: dict):
    """LDM and U-ViT-L/2 under VAW_PACKED_QKV=0: their attention on q, k
    and v split from the projection, all on the general kernels (LDM's
    five T = 256 blocks leave the p5 kernels), one bf16 forward each
    against the default route's."""
    off = {"VAW_PACKED_QKV": "0"}
    for key, fam, split in (("ldm", LDM_FAMILY, {"flash_fwd": 16}),
                            ("uvit", UVIT, {"flash_fwd": 21})):
        model = cast_for_compute(fam.seeded(), torch.bfloat16)
        want, launches, designs = _bf16_forward(model, fam.image, fam.classes, {})
        _route_check(f"{fam.tag} default", want, want, launches, designs, fam.fwd,
                     fam.fwd_design)
        got, launches, designs = _bf16_forward(model, fam.image, fam.classes, off)
        _route_check(f"{fam.tag} VAW_PACKED_QKV=0", got, want, launches, designs, split,
                     {"flash_fwd": {"wgmma": split["flash_fwd"]}})
        path = f"model_{key}_packed_qkv_0"
        by_path[path], designs_by_path[path] = launches, designs
        del model, want, got
        torch.cuda.empty_cache()


def _unet_reference_layout(sd: dict, model) -> dict:
    """A port UNet state dict in the reference's layout: qkv rows in the
    legacy per-head interleave (each block's heads) and qkv and proj_out
    as [out, in, 1] conv1d weights (the inverse of reference_unet_to_torch)."""
    out = {}
    for name, v in sd.items():
        if name.endswith(("qkv.weight", "qkv.bias")):
            heads = model.get_submodule(name.rsplit(".", 2)[0]).num_heads
            legacy = torch.empty_like(v)
            legacy[torch.from_numpy(_legacy_qkv_perm(v.shape[0] // 3, heads))] = v
            v = legacy
        if name.endswith(("qkv.weight", "proj_out.weight")):
            v = v[..., None]
        out[name] = v.detach().cpu().clone()
    return out


def _vit_reference_layout(sd: dict) -> dict:
    """A port ViT state dict in the reference's layout: each qkv bias as
    q_bias and v_bias (its k part must be zero: the reference has none)."""
    out = {}
    for name, v in sd.items():
        v = v.detach().cpu().clone()
        if name.endswith("attn.qkv.bias"):
            q, k, vb = v.chunk(3)
            check(not k.any(), f"{name}: a k bias the reference cannot hold")
            out[name.replace("qkv.bias", "q_bias")] = q
            out[name.replace("qkv.bias", "v_bias")] = vb
        else:
            out[name] = v
    return out


def _zero_k_bias(model):
    with torch.no_grad():
        for blk in model.blocks:
            blk.attn.qkv.bias.chunk(3)[1].zero_()
    return model


def _vit_b_qkv_bias():
    return ViT_B(image_size=32, patch_size=2, in_channels=4, num_classes=1000,
                 learn_sigma=False, drop_label_prob=0.1, qkv_bias=True)


def phase_reference_readers(card: str, by_path: dict, designs_by_path: dict):
    """ADM-64 (VAW_PALLAS_CONV=1) and ViT-B/2 with a qkv bias (its k part
    zeroed first): the seeded state dict written in the reference's layout
    to a .pth, read back through reference_to_torch into a second model of
    other seeded weights (strict), and one bf16 sampling forward of each
    pair at B = 128, which must be bit-equal (same weights, kernels and
    order)."""
    pairs = (("adm64", ADM64, lambda: seeded_unet(_adm64), _adm64,
              lambda sd, m: _unet_reference_layout(sd, m)),
             ("vit", VIT, lambda: _zero_k_bias(_vit_b_qkv_bias().cuda().eval()),
              _vit_b_qkv_bias, lambda sd, m: _vit_reference_layout(sd)))
    with tempfile.TemporaryDirectory(prefix="vaw_chip_reference_") as tmp:
        for key, fam, seeded, ctor, layout in pairs:
            with environment(fam.env):
                torch.manual_seed(0)
                original = seeded()
                path = Path(tmp) / f"{key}.pth"
                torch.save(layout(original.state_dict(), original), path)
                sd = torch.load(path, map_location="cpu", weights_only=True)
                torch.manual_seed(1)  # other weights, all replaced by the load
                loaded = ctor().cuda()
                loaded.load_state_dict(reference_to_torch(sd, loaded), strict=True)
                loaded.eval()
                same_weights = all(torch.equal(a, b) for a, b in zip(
                    original.state_dict().values(), loaded.state_dict().values()))
                want, _, _ = _bf16_forward(cast_for_compute(original, torch.bfloat16),
                                           fam.image, fam.classes, {})
                got, launches, designs = _bf16_forward(
                    cast_for_compute(loaded, torch.bfloat16), fam.image, fam.classes, {})
                bit_equal = torch.equal(got, want)
                print(f"[slice16] {fam.tag} through the reference layout ({len(sd)} "
                      f"tensors, {path.stat().st_size / 2 ** 20:.1f} MiB): weights equal "
                      f"{same_weights}; bf16 forward at B={got.shape[0]} bit-equal "
                      f"{bit_equal}, max|out| {want.abs().max().item():.4f}; launches "
                      f"{ {k: n for k, n in launches.items() if n} } [{card}]", flush=True)
                check(same_weights and bit_equal and want.abs().max().item() > 0,
                      f"{fam.tag}: the reference layout did not read back exactly")
                check(launches == expect((fam.fwd, 1)),
                      f"{fam.tag}: launches {launches}, expected {fam.fwd}")
                by_path[f"reference_{key}"], designs_by_path[f"reference_{key}"] = (
                    launches, designs)
                del original, loaded, want, got, sd
                torch.cuda.empty_cache()


def attention_bwd_f32_bounds(b, tq, tk, h, d) -> dict:
    """``f32_bounds`` of one f32 attention backward: q, k, v, o, dout and
    lse read, dq, dk, dv written; 10*B*H*Tq*Tk*D operations."""
    nbytes = (4 * b * tq * h * d + 4 * b * tk * h * d) * 4 + b * h * tq * 4
    return f32_bounds(nbytes, 10 * b * h * tq * tk * d)


def _p5_pair(card: str, label: str, fwd_shape: tuple, bwd_batch: int, dtype) -> dict:
    """B3 at fwd_shape (B, T, H, D) and B4 at the same with B = bwd_batch,
    each through the kernel its call selects (counted) against its plain
    version, then timed beside the plain version, SDPA (or its backward)
    and the bound (in f32 the bytes, 3xTF32 and FMA bounds)."""
    gen = torch.Generator(device="cuda").manual_seed(10)
    bf, t, h, d = fwd_shape
    bb = bwd_batch
    name = str(dtype)[6:]
    f5 = _p5_inputs(gen, bf, t, h, d, dtype)
    before = read_designs()
    o, lse = flash_attention_p5_fwd(f5)
    ro, rlse = flash_attention_p5_reference(f5)
    err = (o.float() - ro.float()).abs().max().item()
    lse_err = (lse - rlse).abs().max().item()
    used = _used("flash_p5_fwd", before)
    design = flash_p5_fwd_design(dtype, 1.0 / math.sqrt(d), f5.shape)
    del ro, rlse
    check(used == {design: 1}, f"{label} p5 forward by kernel {used}")
    check(err <= ATOL[dtype] and lse_err <= LSE_ATOL,
          f"{label} p5 forward: error {err}, lse {lse_err}")
    ms = cuda_ms(lambda: flash_attention_p5_fwd(f5), iters=50)
    plain_ms = cuda_ms(lambda: flash_attention_p5_reference(f5), iters=10)
    q, k, v = _bhtd(f5)
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), iters=50)
    del q, k, v
    if dtype == torch.float32:
        fwd = attention_f32_bounds(bf, t, t, h, d)
    else:
        fwd = dict(zip(("bound_ms", "bound_by"), attention_bound_ms(bf, t, t, h, d, dtype)))
    fwd.update(design=design, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
               max_abs_err=err)
    print(f"[{label}] p5 forward B={bf} T={t} H={h} D={d} {name} ({design}): max|o - "
          f"plain| {err:.3e}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa "
          f"{library_ms:.4f} ms, "
          + (_bounds_text(fwd) if dtype == torch.float32
             else f"bound {fwd['bound_ms']:.4f} ms ({fwd['bound_by']})")
          + f"; kernel / sdpa {ms / library_ms:.3f} [{card}]", flush=True)
    f5 = _p5_inputs(gen, bb, t, h, d, dtype)
    dout = torch.randn((bb * h, d, t), generator=gen, device="cuda").to(dtype)
    o, lse = flash_attention_p5_fwd(f5)
    before = read_designs()
    dqkv = flash_attention_p5_bwd(f5, o, lse, dout)
    worst = _p5_rel_err(dqkv, flash_attention_p5_bwd_reference(f5, o, lse, dout))
    used = _used("flash_p5_bwd", before)
    design = flash_p5_bwd_design(dtype, d, 1.0 / math.sqrt(d))
    check(used == {design: 1}, f"{label} p5 backward by kernel {used}")
    check(worst <= BWD_RTOL[dtype], f"{label} p5 backward: error {worst}")
    ms_b = cuda_ms(lambda: flash_attention_p5_bwd(f5, o, lse, dout), iters=20)
    plain_b = cuda_ms(lambda: flash_attention_p5_bwd_reference(f5, o, lse, dout),
                      iters=3, warmup=1)
    q, k, v = (x.requires_grad_(True) for x in _bhtd(f5))
    sdpa_out = F.scaled_dot_product_attention(q, k, v)
    g4 = dout.view(bb, h, d, t).transpose(-1, -2)
    library_b = cuda_ms(lambda: torch.autograd.grad(sdpa_out, (q, k, v), g4,
                                                    retain_graph=True), iters=20)
    del q, k, v, sdpa_out, f5, o, lse, dout, dqkv
    if dtype == torch.float32:
        bwd = attention_bwd_f32_bounds(bb, t, t, h, d)
    else:
        bwd = dict(zip(("bound_ms", "bound_by"),
                       attention_bwd_bound_ms(bb, t, t, h, d, dtype)))
    bwd.update(design=design, ms=ms_b, plain_ms=plain_b, library_ms=library_b,
               max_rel_err=worst)
    print(f"[{label}] p5 backward B={bb} T={t} H={h} D={d} {name} ({design}): max rel err "
          f"{worst:.3e}, kernel {ms_b:.4f} ms, plain {plain_b:.4f} ms, sdpa backward "
          f"{library_b:.4f} ms, "
          + (_bounds_text(bwd) if dtype == torch.float32
             else f"bound {bwd['bound_ms']:.4f} ms ({bwd['bound_by']})")
          + f"; kernel / sdpa {ms_b / library_b:.3f} [{card}]", flush=True)
    torch.cuda.empty_cache()
    return {"flash_p5_fwd": fwd, "flash_p5_bwd": bwd}


def phase_p5_dit_shape(card: str):
    """B3 and B4 at DiT-B/2's shape (12 heads of 64, T = 256), the route
    VAW_FUSED_TMAJOR=0 sends it to: the forward at B = 128 and the backward
    at B = 256 in bf16, each on wgmma against its plain version, then timed
    beside the plain version, SDPA (or its backward) and the bound."""
    (bf, t, h, d), (bb, _, _, _) = DIT_P5_SHAPES
    rows = _p5_pair(card, "slice16", (bf, t, h, d), bb, torch.bfloat16)
    check(rows["flash_p5_fwd"]["design"] == rows["flash_p5_bwd"]["design"] == "wgmma",
          f"p5 at DiT-B/2's shape: {rows}")


def phase_slice16(card: str, by_path: dict, designs_by_path: dict):
    """The attention switches on DiT-B/2, LDM and U-ViT-L/2, B3/B4 at
    DiT-B/2's shape, and the reference readers of the UNet and the ViT."""
    t0 = time.perf_counter()
    phase_p5_dit_shape(card)
    phase_dit_routes(card, by_path, designs_by_path)
    phase_packed_off(card, by_path, designs_by_path)
    phase_reference_readers(card, by_path, designs_by_path)
    print(f"[slice16] switch, p5 and reader phases in {time.perf_counter() - t0:.1f} s "
          f"[{card}]", flush=True)



# The XL models' attention at D = 72: DiT-XL/2 (28 blocks, 1152 wide,
# 16 heads of 72, T = 256, the fused entries) and U-ViT-H/2 (29 blocks, the
# same heads, T = 258, the packed entry), on the general TMA + wgmma
# forward at an 80-wide pad and the TMA + wgmma backward pair.
XL_CHECK_SHAPES = [(2, 256, 16, 72), (2, 258, 16, 72)]
DITXL_SHAPE = (2 * SAMPLE_SIZE, 256, 16, 72)   # DiT-XL/2 sampling (CFG 1.5)
UVITH_SHAPE = (2 * SAMPLE_SIZE, 258, 16, 72)   # U-ViT-H/2 sampling
DITXL_STEPS, DITXL_BATCH, DITXL_SAMPLES, DITXL_FALL = 10, 64, 16, 3
UVITH_BATCH = 4
# U-ViT-H/2's bf16 gradient through the kernels against the same model on
# VAW_DISABLE_FLASH=1, relative to each parameter group's max|grad|: both
# routes round each block's attention output and its gradients to bf16,
# in other places, through 29 blocks (the bf16 TP check's gradient bound).
UVITH_GRAD_RTOL = 5e-2
DITXL_ARGS = ["--model", "DiT-XL"] + MODEL_ARGS
DITXL_SAMPLER = ["--solver", "heun", "--discretization", "edm", "--sample_steps", str(STEPS),
                 "--guidance_scale", "1.5", "--sample_size", str(DITXL_SAMPLES),
                 "--num_samples", str(DITXL_SAMPLES)]


def phase_xl_kernels():
    """Both D = 72 kernels against their plain versions at (2, 256, 16, 72)
    and (2, 258, 16, 72), bf16, on a packed row's views through the general
    entries and on the packed projection through the fused ones: every
    launch on wgmma, each repeated call bit-equal, the fused forward equal to
    the general one (the same kernel on the same views)."""
    gen = torch.Generator(device="cuda").manual_seed(21)
    names = ("flash_fwd", "flash_bwd", "flash_fused_fwd", "flash_fused_bwd")
    for (b, t, h, d) in XL_CHECK_SHAPES:
        tag = f"B={b} T={t} H={h} D={d} bfloat16"
        qkv = torch.randn((b, t, 3, h, d), generator=gen, device="cuda").to(torch.bfloat16)
        dout = torch.randn((b, t, h, d), generator=gen, device="cuda").to(torch.bfloat16)
        q, k, v = qkv.unbind(2)
        f, d2 = qkv.view(b, t, 3 * h * d), dout.view(b, t, h * d)
        before = read_designs()
        o, lse = flash_attention_fwd(q, k, v)
        o2, lse2 = flash_attention_fwd(q, k, v)
        grads = [torch.empty_like(qkv) for _ in range(2)]
        for g in grads:
            flash_attention_bwd(q, k, v, o, lse, dout, grads=g.unbind(2))
        fo, flse = flash_attention_fused(f, h)
        fused = [flash_attention_fused_bwd(f, fo, flse, d2, h) for _ in range(2)]
        torch.cuda.synchronize()
        used = {n: _used(n, before) for n in names}
        want_used = {"flash_fwd": {"wgmma": 2}, "flash_bwd": {"wgmma": 2},
                     "flash_fused_fwd": {"wgmma": 1}, "flash_fused_bwd": {"wgmma": 2}}
        check(used == want_used, f"{tag}: launches by kernel {used}, expected {want_used}")
        same = (torch.equal(o, o2) and torch.equal(lse, lse2)
                and torch.equal(grads[0], grads[1]) and torch.equal(fused[0], fused[1]))
        fused_is_general = torch.equal(fo.view(b, t, h, d), o) and torch.equal(flse, lse)
        ro, rlse = flash_attention_reference(q, k, v)
        err = (o.float() - ro.float()).abs().max().item()
        lse_err = (lse - rlse).abs().max().item()
        want = torch.stack(flash_attention_bwd_reference(q, k, v, o, lse, dout), dim=2)
        rel = ((grads[0].float() - want.float()).abs().max() / want.float().abs().max()).item()
        fwant = flash_attention_fused_bwd_reference(f, fo, flse, d2, h)
        frel = ((fused[0].float() - fwant.float()).abs().max()
                / fwant.float().abs().max()).item()
        print(f"[xl kernels] {tag}: launches {used}; max|o - plain| {err:.3e} (tol "
              f"{ATOL[torch.bfloat16]:.0e}), max|lse - plain| {lse_err:.3e} (tol "
              f"{LSE_ATOL:.0e}); max|dqkv - plain| / max|dqkv| general {rel:.3e}, fused "
              f"{frel:.3e} (tol {BWD_RTOL[torch.bfloat16]:.0e}); repeats bit-equal {same}; "
              f"fused forward equal to the general one {fused_is_general}", flush=True)
        check(err <= ATOL[torch.bfloat16] and lse_err <= LSE_ATOL, f"{tag}: forward disagrees")
        check(max(rel, frel) <= BWD_RTOL[torch.bfloat16], f"{tag}: backward disagrees")
        check(same and fused_is_general, f"{tag}: repeats differ")


def _xl_row(card: str, tag: str, err: float, fn, alt, plain_fn, library: str,
            library_ms: float, bound: tuple, iters: int, label: str = "xl time") -> dict:
    """One timing row: the kernel's time for the call as the host issues it
    and on the device alone (device_ms), the plain version's, the library
    call's and the bound; and where `alt` is (name, fn), another kernel's
    times for the same call."""
    ms, dev_ms = cuda_ms(fn, iters=iters), device_ms(fn, iters=iters)
    host = host_us(fn, iters=iters)
    row = dict(max_abs_err=err, ms=ms, device_ms=dev_ms, host_us=host)
    text = ""
    if alt is not None:
        alt_ms, alt_dev_ms = cuda_ms(alt[1], iters=iters), device_ms(alt[1], iters=iters)
        alt_host = host_us(alt[1], iters=iters)
        row.update(alt=alt[0], alt_ms=alt_ms, alt_device_ms=alt_dev_ms, alt_host_us=alt_host)
        text = f"{alt[0]} {alt_ms:.4f} ms ({alt_dev_ms:.4f}; host {alt_host:.1f} µs), "
    plain_ms = cuda_ms(plain_fn, iters=3, warmup=1)
    print(f"[{label}] {tag}: kernel {ms:.4f} ms as issued ({dev_ms:.4f} on the device "
          f"alone; host {host:.1f} µs a call), "
          f"{text}plain {plain_ms:.4f} ms, {library} {library_ms:.4f} ms, bound "
          f"{bound[0]:.4f} ms ({bound[1]}); kernel / library {ms / library_ms:.3f}, "
          f"kernel / bound {ms / bound[0]:.2f} [{card}]", flush=True)
    row.update(plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound[0],
               bound_by=bound[1])
    return row


def phase_xl_timing(card: str) -> dict:
    """The two kernels at the XL models' sampling shapes (B = 128, so every
    persistent block walks several work items and both q buffers): held
    against their plain versions and repeated bit-equal, then timed beside
    the mma.sync backwards these calls took before (the forwards' earlier
    128-wide pads are gone from this build: probes/_torch_attention_ab.py
    times the parent's through its own entry points), the plain versions,
    SDPA (or its backward) and the bound. Returns {"fwd": {...}, "bwd":
    {...}} by model."""
    gen = torch.Generator(device="cuda").manual_seed(22)
    rows = {"fwd": {}, "bwd": {}}
    for model, (b, t, h, d) in (("DiT-XL/2", DITXL_SHAPE), ("U-ViT-H/2", UVITH_SHAPE)):
        tag = f"{model} B={b} T={t} H={h} D={d} bfloat16"
        qkv = torch.randn((b, t, 3, h, d), generator=gen, device="cuda").to(torch.bfloat16)
        dout = torch.randn((b, t, h, d), generator=gen, device="cuda").to(torch.bfloat16)
        q, k, v = qkv.unbind(2)
        f, d2 = qkv.view(b, t, 3 * h * d), dout.view(b, t, h * d)
        qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
        sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh), iters=20)
        sdpa_bwd_ms = _sdpa_bwd_ms(qkv, dout, iters=10)
        if model == "DiT-XL/2":
            o, lse = flash_attention_fused(f, h)
            o2, lse2 = flash_attention_fused(f, h)
            ro, rlse = flash_attention_fused_reference(f, h)
            fwd = lambda: flash_attention_fused(f, h)
            plain_fwd = lambda: flash_attention_fused_reference(f, h)
            dqkv = flash_attention_fused_bwd(f, o, lse, d2, h)
            same_bwd = torch.equal(dqkv, flash_attention_fused_bwd(f, o, lse, d2, h))
            want = flash_attention_fused_bwd_reference(f, o, lse, d2, h)
            bwd = lambda: flash_attention_fused_bwd(f, o, lse, d2, h)
            alt_bwd = ("fused mma.sync kernels", lambda: _fused_kernels_bwd(f, o, lse, d2, h))
            plain_bwd = lambda: flash_attention_fused_bwd_reference(f, o, lse, d2, h)
        else:
            o, lse = flash_attention_fwd(q, k, v)
            o2, lse2 = flash_attention_fwd(q, k, v)
            ro, rlse = flash_attention_reference(q, k, v)
            fwd = lambda: flash_attention_fwd(q, k, v)
            plain_fwd = lambda: flash_attention_reference(q, k, v)
            packed, again = torch.empty_like(qkv), torch.empty_like(qkv)
            flash_attention_bwd(q, k, v, o, lse, dout, grads=packed.unbind(2))
            flash_attention_bwd(q, k, v, o, lse, dout, grads=again.unbind(2))
            same_bwd = torch.equal(packed, again)
            del again
            dqkv = packed
            want = torch.stack(flash_attention_bwd_reference(q, k, v, o, lse, dout), dim=2)
            bwd = lambda: flash_attention_bwd(q, k, v, o, lse, dout, grads=packed.unbind(2))
            alt_bwd = ("general mma.sync kernels", lambda: _mma_sync_general_bwd(
                q, k, v, o, lse, dout, packed.unbind(2)))
            plain_bwd = lambda: flash_attention_bwd_reference(q, k, v, o, lse, dout)
        err = (o.float().reshape(ro.shape) - ro.float()).abs().max().item()
        lse_err = (lse - rlse).abs().max().item()
        bwd_err = (dqkv.float().reshape(want.shape) - want.float()).abs().max().item()
        bwd_rel = bwd_err / want.float().abs().max().item()
        same = torch.equal(o, o2) and torch.equal(lse, lse2) and same_bwd
        del ro, rlse, want, o2, lse2
        print(f"[xl kernels] {tag}: max|o - plain| {err:.3e} (tol {ATOL[torch.bfloat16]:.0e}), "
              f"max|lse - plain| {lse_err:.3e} (tol {LSE_ATOL:.0e}), max|dqkv - plain| / "
              f"max|dqkv| {bwd_rel:.3e} (tol {BWD_RTOL[torch.bfloat16]:.0e}); repeats "
              f"bit-equal {same}", flush=True)
        check(err <= ATOL[torch.bfloat16] and lse_err <= LSE_ATOL, f"{tag}: forward disagrees")
        check(bwd_rel <= BWD_RTOL[torch.bfloat16], f"{tag}: backward disagrees")
        check(same, f"{tag}: repeats differ")
        rows["fwd"][model] = _xl_row(
            card, f"{tag} forward", err, fwd, None, plain_fwd, "sdpa", sdpa_ms,
            attention_bound_ms(b, t, t, h, d, torch.bfloat16), iters=50)
        rows["bwd"][model] = _xl_row(
            card, f"{tag} backward", bwd_err, bwd, alt_bwd, plain_bwd, "sdpa backward",
            sdpa_bwd_ms, attention_bwd_bound_ms(b, t, t, h, d, torch.bfloat16), iters=20)
        del qkv, dout, q, k, v, f, d2, qh, kh, vh, o, lse, dqkv
        torch.cuda.empty_cache()
    return rows


def phase_ditxl(card: str, by_path: dict, designs_by_path: dict):
    """DiT-XL/2 at full width and depth on Gaussian 32x32x4 latents through
    vaw_torch.cli.main with the flagship recipe, bf16 over f32 masters:
    DITXL_STEPS steps at batch DITXL_BATCH (28 fused forwards and 28 fused
    backwards a step, all on wgmma, nothing on mma.sync), a finite and
    falling loss; then DITXL_SAMPLES samples of the run's EMA weights from
    the 18-step Heun EDM sampler at CFG 1.5 through the CLI's own sampler
    (generate_samples: 35 model calls of 28 fused forwards, all wgmma)."""
    fwd, bwd = {"flash_fused_fwd": 28}, {"flash_fused_bwd": 28}
    fwd_design = {"flash_fused_fwd": {"wgmma": 28}}
    argv = DITXL_ARGS + _flag(_flag(_flag(RECIPE_ARGS, "--total_steps", DITXL_STEPS),
                                    "--save_step", 0),
                              "--sample_freq", 100 * DITXL_STEPS) + DITXL_SAMPLER
    with tempfile.TemporaryDirectory(prefix="vaw_chip_ditxl_") as tmp:
        argv += ["--batch_size", str(DITXL_BATCH), "--logdir", tmp]
        run = run_train_cli(argv)
        check_run("train DiT-XL/2", run, DITXL_STEPS, fwd, bwd, fwd_design,
                  {"flash_fused_bwd": {"wgmma": 28}})
        values = run["losses"]
        w = DITXL_FALL
        first, last = sum(values[:w]) / w, sum(values[-w:]) / w
        params = sum(p.numel() for p in run["ctx"]["sample_model"].parameters()) / 1e6
        print(f"[ditxl] DiT-XL/2 {params:.2f}M parameters, batch {DITXL_BATCH} bf16 over f32 "
              f"masters: losses "
              f"{[round(x, 5) for x in values]} (mean of the first {w} {first:.5f}, of the "
              f"last {w} {last:.5f}); {run['ms_per_step']:.2f} ms/step over steps "
              f"{TRAIN_WARMUP + 1}-{DITXL_STEPS} (CUDA events), CLI wall {run['wall_s']:.2f} "
              f"s, peak memory {run['peak_gib']:.2f} GiB [{card}]", flush=True)
        check(last < first, f"DiT-XL/2: loss did not fall: {first} -> {last}")
        by_path["train_ditxl"], designs_by_path["train_ditxl"] = run["launches"], run["designs"]
        finite = []
        inverse_normalize = sampler_driver._inverse_normalize

        def checked_inverse_normalize(x):
            finite.append(bool(torch.isfinite(x).all().item()))
            return inverse_normalize(x)

        cfg = train_cli.parse_args(argv)
        with mock.patch.object(sampler_driver, "_inverse_normalize",
                               checked_inverse_normalize):
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            samples = train_cli.generate_samples(cfg, DITXL_STEPS, run["ctx"], save_grid=False)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts, designs = read_launches(), read_designs()
        free(run)
    calls = 2 * STEPS - 1
    want, want_designs = expect((fwd, calls)), expect_designs((fwd_design, calls))
    print(f"[ditxl] {len(samples)} samples {samples.shape[1:]} {samples.dtype} from the EMA "
          f"weights, EDM Heun {STEPS} steps CFG 1.5 ({calls} model calls), finite before "
          f"uint8 {finite}, {wall:.2f} s; launches {counts}, by kernel {designs} [{card}]",
          flush=True)
    check(samples.shape == (DITXL_SAMPLES, 32, 32, 4) and finite == [True],
          "DiT-XL/2 samples")
    check(counts == want and designs == want_designs,
          f"DiT-XL/2 sampling launches {counts} by kernel {designs}, expected {want} "
          f"{want_designs}")
    by_path["sample_ditxl"], designs_by_path["sample_ditxl"] = counts, designs


def _bf16_grad_check(card: str, tag: str, model, x, t, y, g, per: tuple, per_design: tuple,
                     what: str) -> tuple:
    """One bf16 forward and backward of sum(out * g) of `model` at x, t, y
    through the kernels against the same on VAW_DISABLE_FLASH=1 (no
    kernel): launches
    as `per` and `per_design` (one forward, one backward) and none on the
    plain route, the output within MODEL_BF16_RTOL of its max and each
    parameter group's gradient within UVITH_GRAD_RTOL of that group's max.
    Returns the kernel route's (launches, launches by kernel)."""

    def run(env):
        model.zero_grad(set_to_none=True)
        with environment(env):
            reset_launches()
            out = _out(model(x, t, y))
            (out.float() * g).sum().backward()
            torch.cuda.synchronize()
            launched = (read_launches(), read_designs())
        grads = {k: p.grad.float() for k, p in model.named_parameters()}
        return out.detach().float(), grads, launched

    out, got, launched = run({})
    ref, want, plain_launched = run({"VAW_DISABLE_FLASH": "1"})
    check(launched == (expect(*per), expect_designs(*per_design)),
          f"{tag} launches {launched}")
    check(plain_launched == (expect(), expect_designs()),
          f"{tag} on VAW_DISABLE_FLASH=1 launched {plain_launched}")
    out_rel = ((out - ref).abs().max() / ref.abs().max()).item()
    worst = {}
    for name in want:
        group = _grad_group(name)
        err = (got[name] - want[name]).abs().max().item()
        scale = want[name].abs().max().item()
        prev = worst.get(group, (0.0, 0.0))
        worst[group] = (max(prev[0], err), max(prev[1], scale))
    rel = {k: e / s if s > 0 else e for k, (e, s) in worst.items()}
    print(f"[{tag}] {sum(p.numel() for p in model.parameters()) / 1e6:.2f}M parameters, "
          f"B={x.shape[0]} bf16, kernels ({what}) vs VAW_DISABLE_FLASH=1: output max rel "
          f"err {out_rel:.3e} (tol {MODEL_BF16_RTOL:.0e}), gradient max rel err per "
          f"group " + ", ".join(f"{k} {v:.3e}" for k, v in sorted(rel.items()))
          + f" (tol {UVITH_GRAD_RTOL:.0e}) [{card}]", flush=True)
    check(math.isfinite(out_rel) and out_rel <= MODEL_BF16_RTOL, f"{tag} output disagrees")
    check(all(math.isfinite(v) and v <= UVITH_GRAD_RTOL for v in rel.values()),
          f"{tag} gradient disagrees")
    return launched


def phase_uvith(card: str, by_path: dict, designs_by_path: dict):
    """U-ViT-H/2 at full width and depth (1152 wide, 29 blocks, 16 heads of
    72, T = 258) with seeded weights, bf16 over f32 weights: one forward and
    backward at batch UVITH_BATCH through the kernels (29 general forwards
    and 29 backwards, all wgmma: the path ``grad_uvith``) against the same
    on VAW_DISABLE_FLASH=1 (no kernel), output and gradient per group."""
    torch.manual_seed(0)
    with torch.device("cuda"):
        model = UViT_H(image_size=32, patch_size=2, in_channels=4, num_classes=1000,
                       class_dropout_prob=0.1, compute_dtype=torch.bfloat16).eval()
    gen = torch.Generator(device="cuda").manual_seed(3)
    b = UVITH_BATCH
    x = torch.randn((b, 32, 32, 4), generator=gen, device="cuda")
    t = torch.rand((b,), generator=gen, device="cuda") * 999
    y = torch.randint(0, 1000, (b,), generator=gen, device="cuda")
    g = torch.randn((b, 32, 32, 4), generator=gen, device="cuda")
    per = ({"flash_fwd": 29}, 1), ({"flash_bwd": 29}, 1)
    per_design = ({"flash_fwd": {"wgmma": 29}}, 1), ({"flash_bwd": {"wgmma": 29}}, 1)
    by_path["grad_uvith"], designs_by_path["grad_uvith"] = _bf16_grad_check(
        card, "uvith", model, x, t, y, g, per, per_design,
        "29 + 29 general launches on wgmma")
    del model
    torch.cuda.empty_cache()


# Head dims 96 and 128 on the wgmma backwards: ViT-S (13 blocks, 512 wide,
# 4 heads of 128, T = 258, the packed entry and the general kernels) and
# UNet-64 (64x64x3, 192 channels, mult 1,2,2,2, 4 heads at 384 channels: 7
# attention blocks at 16x16, T = 256, on the p5 kernels and 8 at 8x8, T =
# 64, the middle one among them, on the general ones, all 96 wide); and
# DiT-XL/2's D = 72 on the p5 pair under VAW_FUSED_TMAJOR=0.
WIDE_CHECK_SHAPES = [("general", 2, 258, 4, 128), ("general", 2, 64, 4, 96),
                     ("p5", 2, 256, 4, 96), ("p5", 2, 256, 16, 72)]
WIDE_TIME_SHAPES = [("ViT-S", "general", 128, 258, 4, 128),
                    ("UNet-64 16x16", "p5", 128, 256, 4, 96),
                    ("UNet-64 8x8", "general", 128, 64, 4, 96)]
WIDE_GRAD_BATCH = 4
VITS_STEPS, VITS_BATCH, VITS_FALL = 12, 128, 3
VITS_ARGS = ["--model", "ViT-S"] + MODEL_ARGS


def _wide_call(entry: str, qkv, dout):
    """The backward of one wide-head call through its entry, on the packed
    row's views (general) or the d-major f5 (p5): (the call, returning its
    gradient; the plain version's; the mma.sync kernels'). A general call
    writes one packed gradient, the same tensor each time."""
    b, t, _, h, d = qkv.shape
    if entry == "p5":
        f5 = qkv.permute(0, 2, 3, 4, 1).contiguous()
        d5 = dout.permute(0, 2, 3, 1).reshape(b * h, d, t).contiguous()
        o, lse = flash_attention_p5_fwd(f5)
        return (lambda: flash_attention_p5_bwd(f5, o, lse, d5),
                lambda: flash_attention_p5_bwd_reference(f5, o, lse, d5),
                lambda: _mma_sync_p5_bwd(f5, o, lse, d5))
    q, k, v = qkv.unbind(2)
    o, lse = flash_attention_fwd(q, k, v)
    grad, old_grad = torch.empty_like(qkv), torch.empty_like(qkv)

    def run():
        flash_attention_bwd(q, k, v, o, lse, dout, grads=grad.unbind(2))
        return grad

    def old():
        _mma_sync_general_bwd(q, k, v, o, lse, dout, old_grad.unbind(2))
        return old_grad
    return (run,
            lambda: torch.stack(flash_attention_bwd_reference(q, k, v, o, lse, dout), dim=2),
            old)


def _grad_rel(got, want, entry: str) -> tuple:
    """(max|got - want|, max|got - want| / max|want|) over dq, dk and dv,
    the worst of three."""
    axis = 1 if entry == "p5" else 2
    errs = [((g.float() - w.float()).abs().max().item(), w.float().abs().max().item())
            for g, w in zip(got.unbind(axis), want.unbind(axis))]
    return max(e for e, _ in errs), max(e / s for e, s in errs)


def phase_wide_kernels():
    """Both backwards at D = 96 and 128 (and the p5 pair at D = 72) against
    their plain versions at B = 2, bf16: every launch on wgmma, counted by
    kernel, a repeated call bit-equal."""
    gen = torch.Generator(device="cuda").manual_seed(23)
    for entry, b, t, h, d in WIDE_CHECK_SHAPES:
        tag = f"{entry} B={b} T={t} H={h} D={d} bfloat16"
        name = "flash_p5_bwd" if entry == "p5" else "flash_bwd"
        qkv = torch.randn((b, t, 3, h, d), generator=gen, device="cuda").to(torch.bfloat16)
        dout = torch.randn((b, t, h, d), generator=gen, device="cuda").to(torch.bfloat16)
        run, plain, _ = _wide_call(entry, qkv, dout)
        before = read_designs()
        got = run().clone()
        again = run()
        torch.cuda.synchronize()
        used = _used(name, before)
        _, rel = _grad_rel(got, plain(), entry)
        same = torch.equal(got, again)
        print(f"[wide kernels] {tag}: launches {used}; max|dqkv - plain| / max|dqkv| "
              f"{rel:.3e} (tol {BWD_RTOL[torch.bfloat16]:.0e}); repeat bit-equal {same}",
              flush=True)
        check(used == {"wgmma": 2}, f"{tag}: launches by kernel {used}")
        check(rel <= BWD_RTOL[torch.bfloat16], f"{tag}: backward disagrees")
        check(same, f"{tag}: a repeated backward is not bit-equal")


def phase_wide_timing(card: str) -> dict:
    """The wide-head backwards at the models' shapes at batch 128, held
    against their plain versions, then timed beside the mma.sync kernels
    these calls took before, the plain versions, SDPA's backward and the
    bound. Returns the timing rows by model shape."""
    gen = torch.Generator(device="cuda").manual_seed(24)
    rows = {}
    for model, entry, b, t, h, d in WIDE_TIME_SHAPES:
        tag = f"{model} {entry} B={b} T={t} H={h} D={d} bfloat16 backward"
        qkv = torch.randn((b, t, 3, h, d), generator=gen, device="cuda").to(torch.bfloat16)
        dout = torch.randn((b, t, h, d), generator=gen, device="cuda").to(torch.bfloat16)
        run, plain, old = _wide_call(entry, qkv, dout)
        want = plain()
        err, rel = _grad_rel(run(), want, entry)
        _, old_rel = _grad_rel(old(), want, entry)
        del want
        print(f"[wide kernels] {tag}: max|dqkv - plain| / max|dqkv| {rel:.3e}, mma.sync "
              f"kernels {old_rel:.3e} (tol {BWD_RTOL[torch.bfloat16]:.0e})", flush=True)
        check(rel <= BWD_RTOL[torch.bfloat16] and old_rel <= BWD_RTOL[torch.bfloat16],
              f"{tag}: disagrees")
        rows[model] = _xl_row(
            card, tag, err, run, ("mma.sync kernels", old), plain, "sdpa backward",
            _sdpa_bwd_ms(qkv, dout, iters=10),
            attention_bwd_bound_ms(b, t, t, h, d, torch.bfloat16), iters=20,
            label="wide time")
        rows[model].update(max_rel_err=rel, shape=[b, t, h, d])
        del qkv, dout, run, plain, old
        torch.cuda.empty_cache()
    return rows


def phase_wide_grads(card: str, by_path: dict, designs_by_path: dict):
    """ViT-S/2 and UNet-64 at full width and depth with seeded weights, bf16
    over f32 weights, one forward and backward at batch WIDE_GRAD_BATCH
    through the kernels against VAW_DISABLE_FLASH=1: ViT-S 13 general
    forwards and 13 backwards (the path ``grad_vits``), UNet-64 7 p5 and 8
    general forwards and as many backwards (``grad_unet64``), every backward
    on wgmma."""
    gen = torch.Generator(device="cuda").manual_seed(25)
    b = WIDE_GRAD_BATCH
    torch.manual_seed(0)
    vits = vit_module.ViT_S(image_size=32, patch_size=2, num_classes=1000, in_channels=4,
                            learn_sigma=False, drop_label_prob=0.1,
                            compute_dtype=torch.bfloat16).cuda().eval()
    unet = seeded_unet(lambda: unet_module.UNet_64(num_classes=1000, in_channels=3,
                                                   drop_label_prob=0.1))
    unet.compute_dtype = torch.bfloat16
    for tag, model, image, per, per_design, what in (
            ("vits", vits, (32, 32, 4),
             (({"flash_fwd": 13}, 1), ({"flash_bwd": 13}, 1)),
             (({"flash_fwd": {"wgmma": 13}}, 1), ({"flash_bwd": {"wgmma": 13}}, 1)),
             "13 + 13 general launches, D = 128, on wgmma"),
            ("unet64", unet, (64, 64, 3),
             (({"flash_p5_fwd": 7, "flash_fwd": 8}, 1),
              ({"flash_p5_bwd": 7, "flash_bwd": 8}, 1)),
             (({"flash_p5_fwd": {"wgmma": 7}, "flash_fwd": {"wgmma": 8}}, 1),
              ({"flash_p5_bwd": {"wgmma": 7}, "flash_bwd": {"wgmma": 8}}, 1)),
             "7 p5 + 8 general launches each way, D = 96, on wgmma")):
        x = torch.randn((b, *image), generator=gen, device="cuda")
        t = torch.rand((b,), generator=gen, device="cuda") * 999
        y = torch.randint(0, 1000, (b,), generator=gen, device="cuda")
        g = torch.randn((b, *image), generator=gen, device="cuda")
        by_path[f"grad_{tag}"], designs_by_path[f"grad_{tag}"] = _bf16_grad_check(
            card, tag, model, x, t, y, g, per, per_design, what)
    del vits, unet
    torch.cuda.empty_cache()


def phase_vits_train(card: str, by_path: dict, designs_by_path: dict):
    """ViT-S/2 through vaw_torch.cli.main with the flagship recipe on
    Gaussian 32x32x4 latents, bf16 over f32 masters: VITS_STEPS steps at
    batch VITS_BATCH (13 general forwards and 13 backwards a step, all
    wgmma), a finite and falling loss."""
    argv = VITS_ARGS + _flag(_flag(_flag(RECIPE_ARGS, "--total_steps", VITS_STEPS),
                                   "--save_step", 0), "--sample_freq", 100 * VITS_STEPS)
    with tempfile.TemporaryDirectory(prefix="vaw_chip_vits_") as tmp:
        run = run_train_cli(argv + ["--batch_size", str(VITS_BATCH), "--logdir", tmp])
        check_run("train ViT-S/2", run, VITS_STEPS, {"flash_fwd": 13}, {"flash_bwd": 13},
                  {"flash_fwd": {"wgmma": 13}}, {"flash_bwd": {"wgmma": 13}})
        values, w = run["losses"], VITS_FALL
        first, last = sum(values[:w]) / w, sum(values[-w:]) / w
        print(f"[vits] ViT-S/2 batch {VITS_BATCH}: losses {[round(x, 5) for x in values]} "
              f"(mean of the first {w} {first:.5f}, of the last {w} {last:.5f}); "
              f"{run['ms_per_step']:.2f} ms/step over steps {TRAIN_WARMUP + 1}-{VITS_STEPS} "
              f"(CUDA events), peak memory {run['peak_gib']:.2f} GiB [{card}]", flush=True)
        check(last < first, f"ViT-S/2: loss did not fall: {first} -> {last}")
        by_path["train_vits"], designs_by_path["train_vits"] = run["launches"], run["designs"]
        free(run)


def phase_wide_heads(card: str, by_path: dict, designs_by_path: dict) -> dict:
    """Head dims 96 and 128 on the wgmma backwards: the kernel checks, their
    times, ViT-S's and UNet-64's gradients and ViT-S's training. Returns the
    timing rows."""
    t0 = time.perf_counter()
    phase_wide_kernels()
    rows = phase_wide_timing(card)
    phase_wide_grads(card, by_path, designs_by_path)
    phase_vits_train(card, by_path, designs_by_path)
    print(f"[wide] wide-head kernel, timing, gradient and ViT-S/2 training phases in "
          f"{time.perf_counter() - t0:.1f} s [{card}]", flush=True)
    return rows


def phase_xl(card: str, by_path: dict, designs_by_path: dict) -> dict:
    """The XL models' attention at D = 72 on the wgmma kernels: the kernel
    checks, their times, DiT-XL/2's training and sampling and U-ViT-H/2's
    gradient. Returns the timing rows."""
    t0 = time.perf_counter()
    phase_xl_kernels()
    rows = phase_xl_timing(card)
    phase_ditxl(card, by_path, designs_by_path)
    phase_uvith(card, by_path, designs_by_path)
    print(f"[xl] XL kernel, timing, DiT-XL/2 and U-ViT-H/2 phases in "
          f"{time.perf_counter() - t0:.1f} s [{card}]", flush=True)
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    start = time.perf_counter()
    card = phase_device()
    phase_build()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    records = [phase_kernel(card), phase_bwd(card), phase_general(card),
               phase_general_bwd(card), phase_p5(card), phase_p5_bwd(card),
               phase_conv(card), phase_wgrad(card)]
    act_record, act_launches = phase_act(card)
    records.append(act_record)
    f32_rows = phase_f32_rows(card)
    for record in records:
        if record["name"] in f32_rows:
            record["f32"] = f32_rows[record["name"]]
    records[0]["repa_teacher"] = REPA_TEACHER
    by_path, designs_by_path = {}, {}
    for key, fam in (("dit", DIT), ("uvit", UVIT), ("ldm", LDM_FAMILY), ("adm64", ADM64)):
        with environment(fam.env):
            model = fam.seeded()
            by_path[f"sample_{key}"], designs_by_path[f"sample_{key}"] = phase_sample(
                card, fam, model)
            phase_model(fam, model)
            del model
            torch.cuda.empty_cache()
            by_path[f"train_{key}"], designs_by_path[f"train_{key}"] = phase_train(
                card, fam)
            by_path[f"grad_{key}"], designs_by_path[f"grad_{key}"] = phase_grad(fam)
            torch.cuda.empty_cache()
    by_path["train_adm64_f32"], designs_by_path["train_adm64_f32"] = phase_train_f32(
        card, ADM64, ADM_TRAIN_BATCH)
    by_path["train_dit_f32"], designs_by_path["train_dit_f32"] = phase_train_f32(
        card, DIT, DIT_TRAIN_BATCH)
    phase_slice11(card, by_path, designs_by_path)
    phase_slice12(card, by_path, designs_by_path)
    phase_slice13(card, by_path, designs_by_path)
    phase_slice14(card, by_path, designs_by_path)
    phase_slice15(card, by_path, designs_by_path)
    phase_slice16(card, by_path, designs_by_path)
    xl_rows = phase_xl(card, by_path, designs_by_path)
    wide_rows = phase_wide_heads(card, by_path, designs_by_path)
    with tempfile.TemporaryDirectory(prefix="vaw_chip_data_") as data:
        cifar_dir = write_cifar(Path(data))
        by_path["train_cifar"], designs_by_path["train_cifar"] = phase_data_cifar(
            card, cifar_dir)
        phase_async_snapshot()
        latent_path = None
        try:
            import h5py  # noqa: F401 - the latent phase needs it
        except ImportError as e:
            print(f"[data-latent] h5py does not import here ({e}): the latent phase "
                  "is not run", flush=True)
        else:
            latent_path = write_latents(Path(data))
            by_path["train_latent"], designs_by_path["train_latent"] = phase_data_latent(
                card, latent_path)
        phase_remat_grad()
        paths, designs = phase_remat_train(card)
        by_path.update(paths)
        designs_by_path.update(designs)
        phase_host_path(card, cifar_dir, latent_path)
    for record in records:
        record["launches_by_path"] = {p: n[record["name"]] for p, n in by_path.items()}
    # No model calls the fused bias + leaky ReLU: its launches are those of
    # its own run through the op entry in phase 3i.
    act_record["launches_by_path"]["op_entry_3i"] = act_launches
    for record in records:
        record["launches"] = sum(record["launches_by_path"].values())
    # Launches by kernel (wgmma, mma.sync, FMA, tf32x3) and path of every
    # kernel that chooses among several.
    for record in records:
        if record["name"] in DESIGNS:
            record["launches_by_design_by_path"] = {
                design: {p: d[record["name"]][design] for p, d in designs_by_path.items()}
                for design in DESIGNS[record["name"]]}
    # The 3xTF32 designs, each a kernel of its own in the line: its launches
    # on the paths (the fused forward's f32 calls run the general forward's,
    # the fused backward's the general pair) and its numbers at its timed
    # shape (the REPA teacher's, the classifier's T = 1024 blocks, ADM-64's
    # f32 gradient check, LDM's p5 blocks at the sampling batch, the
    # classifier's 64 px convs, LDM's p5 blocks again for the backward).
    for name, source, replaces, counters, row in (
            ("flash_fwd_tf32x3", "vaw_torch/ops/csrc/flash_fwd.cu",
             "vaw_tpu/ops/flash_attention.py:88", ("flash_fwd", "flash_fused_fwd"),
             records[0]["teacher_shape"]["float32"]),
            ("flash_bwd_tf32x3", "vaw_torch/ops/csrc/flash_bwd.cu",
             "vaw_tpu/ops/flash_attention.py:130", ("flash_bwd", "flash_fused_bwd"),
             f32_rows["flash_bwd"]),
            ("conv3x3_wgrad_tf32x3", "vaw_torch/ops/csrc/conv3x3_wgrad.cu",
             "vaw_tpu/ops/conv2d.py:141", ("conv3x3_wgrad",), f32_rows["conv3x3_wgrad"]),
            ("flash_p5_fwd_tf32x3", "vaw_torch/ops/csrc/flash_p5_fwd.cu",
             "vaw_tpu/ops/flash_attention.py:414", ("flash_p5_fwd",),
             f32_rows["flash_p5_fwd"]["shapes"][LDM_F32_P5_KEY]),
            ("conv3x3_fwd_tf32x3", "vaw_torch/ops/csrc/conv3x3_fwd.cu",
             "vaw_tpu/ops/conv2d.py:41", ("conv3x3_fwd",), f32_rows["conv3x3_fwd"]),
            ("flash_p5_bwd_tf32x3", "vaw_torch/ops/csrc/flash_p5_bwd.cu",
             "vaw_tpu/ops/flash_attention.py:443", ("flash_p5_bwd",),
             f32_rows["flash_p5_bwd"]["shapes"][LDM_F32_P5_KEY])):
        paths = {p: sum(d[c]["tf32x3"] for c in counters) for p, d in designs_by_path.items()}
        records.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=sum(paths.values()), launches_by_path=paths,
            max_abs_err=row["max_abs_err"], ms=row["ms"], plain_ms=row["plain_ms"],
            bound_ms=row["bound_ms"], bound_by=row["bound_by"], library_ms=row["library_ms"],
            fma_ms=row["fma_ms"]))
        check(records[-1]["launches"] > 0, f"{name}: no launch on any path")
    # The general forward's and backward pair's TMA + wgmma kernels at D = 72
    # (80-wide tiles), each a kernel of its own in the line: its launches on
    # the XL paths (the fused entries' bf16 calls at D = 72 run them too) and
    # its numbers at DiT-XL/2's sampling shape, U-ViT-H/2's beside them.
    xl_paths = ("train_ditxl", "sample_ditxl", "grad_uvith")
    for name, kind, counters, replaces, also in (
            ("flash_fwd_wgmma_d72", "fwd", ("flash_fwd", "flash_fused_fwd"),
             "vaw_tpu/ops/flash_attention.py:570", "vaw_tpu/ops/flash_attention.py:88"),
            ("flash_bwd_wgmma_d72", "bwd", ("flash_bwd", "flash_fused_bwd"),
             "vaw_tpu/ops/flash_attention.py:592", "vaw_tpu/ops/flash_attention.py:130")):
        paths = {p: sum(designs_by_path[p][c]["wgmma"] for c in counters) for p in xl_paths}
        row = xl_rows[kind]["DiT-XL/2"]
        records.append(dict(
            name=name, route="cuda", source=f"vaw_torch/ops/csrc/flash_{kind}.cu",
            replaces=replaces, also_replaces=also, launches=sum(paths.values()),
            launches_by_path=paths, max_abs_err=row["max_abs_err"], ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"], bound_by=row["bound_by"],
            library_ms=row["library_ms"], uvit_h_shape=xl_rows[kind]["U-ViT-H/2"],
            **{key: row[key] for key in ("alt", "alt_ms") if key in row}))
        check(records[-1]["launches"] > 0, f"{name}: no launch on any path")
    # The backward pairs' TMA + wgmma kernels at head dims 96 and 128 (the
    # general pair's 96- and 128-wide tiles, the p5 pair's 80-128 rows of d,
    # both giving dV and dK a warpgroup each), each a kernel of its own in
    # the line: its launches on the wide-head paths and its numbers at
    # ViT-S's shape (the general pair; UNet-64's T = 64 beside it) and
    # UNet-64's 16x16 level (the p5 pair).
    wide_paths = ("grad_vits", "grad_unet64", "train_vits")
    for name, counter, source, replaces, row, also in (
            ("flash_bwd_wgmma_wide", "flash_bwd", "vaw_torch/ops/csrc/flash_bwd.cu",
             "vaw_tpu/ops/flash_attention.py:130", wide_rows["ViT-S"],
             {"unet64_t64_shape": wide_rows["UNet-64 8x8"]}),
            ("flash_p5_bwd_wgmma_wide", "flash_p5_bwd", "vaw_torch/ops/csrc/flash_p5_bwd.cu",
             "vaw_tpu/ops/flash_attention.py:443", wide_rows["UNet-64 16x16"], {})):
        paths = {p: designs_by_path[p][counter]["wgmma"] for p in wide_paths}
        records.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=sum(paths.values()), launches_by_path=paths,
            max_abs_err=row["max_abs_err"], ms=row["ms"], plain_ms=row["plain_ms"],
            bound_ms=row["bound_ms"], bound_by=row["bound_by"],
            library_ms=row["library_ms"], alt=row["alt"], alt_ms=row["alt_ms"], **also))
        check(records[-1]["launches"] > 0, f"{name}: no launch on any path")
    print(f"chip_smoke: every phase passed in {time.perf_counter() - start:.1f} s "
          f"[{card}]", flush=True)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--torchrun-child"]:
        sys.exit(torchrun_child(sys.argv[2], sys.argv[3:]))
    sys.exit(main())
